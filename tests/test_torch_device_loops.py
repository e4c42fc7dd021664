"""The device loops (utils/graphs.py's LoopRunner over the masked steps of
models/nw_device.py, models/kiops_device.py and models/integrators.py)
against the JAX package's device drivers, float64 on the CPU, where the
runner calls the same steps eagerly with the read cadence of the CUDA
graphs (the flags read one step behind).

Each case holds the stats equal to JAX's (the last substep to 1e-12 of
the end time) and the result to 1e-12 relative (norm-scaled; NaN where
JAX has NaN). The cases: config #4's operator (advection_diffusion_1d,
Pe = 10) at n = 200 with snapshots 1e-9 apart (inside one substep) and a
bucket change; the same call with no trial unrolled into ``sub``, so that
every rejection runs the ``pending`` path of ``trial``; a NaN operator
that ends in info = 2; and the integrators' scans and adaptive loops.
Every solve's blocking reads are held to (bucket changes + 2)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.models import nw_device
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import t2n

torch.set_num_threads(2)

RTOL = 1e-12
N4, T4 = 200, 1e-3
TS4 = [2e-4, 2e-4 + 1e-9, T4]        # two snapshots inside one substep


def _rel(got, want):
    got, want = t2n(got), np.asarray(want)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    if nan.all():
        return 0.0
    return (np.linalg.norm(got[~nan] - want[~nan])
            / np.linalg.norm(want[~nan]))


def _same_stats(got, want, tend, tau_key=None):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    if tau_key is not None:
        tg, tw = g.pop(tau_key), w.pop(tau_key)
        assert abs(tg - tw) <= RTOL * tend, (tg, tw)
    assert g == w


def _reads(bucket_changes):
    """The runner's reads of one solve: one blocking read at the start (if
    the driver has a scale to read) and one as each bucket's loop ends;
    the other flag reads lag one step behind."""
    c = graphs.counts
    assert c["loops"] == bucket_changes + 1, dict(c)
    assert c["blocking_reads"] <= bucket_changes + 2, dict(c)
    assert c["captures"] == c["replays"] == 0       # the CPU runs eagerly


def _config4():
    b = np.random.default_rng(0).standard_normal(N4)
    return (et.advection_diffusion_1d(N4, peclet=10.0, device="cpu"),
            ej.advection_diffusion_1d(N4, peclet=10.0, dtype=jnp.float64),
            np.stack([b, 0.1 * b], axis=1))


@pytest.fixture(scope="module")
def nw4():
    top, jop, B = _config4()
    kw = dict(m=29, tau=T4, tol=1e-7, return_stats=True)
    jU, js = ej.phiv_timestep_device(TS4, jop, jnp.asarray(B), **kw)
    return top, B, kw, np.asarray(jU), js


@pytest.mark.parametrize("unroll", [nw_device._UNROLL, 0])
def test_nw_config4_vs_jax(nw4, unroll, monkeypatch):
    """Config #4 at n = 200: snapshots inside one substep and bucket
    changes; with no trial unrolled, every rejection runs ``trial``."""
    top, B, kw, jU, js = nw4
    monkeypatch.setattr(nw_device, "_UNROLL", unroll)
    graphs.reset_counts()
    tU, ts_ = et.phiv_timestep_device(TS4, top, torch.as_tensor(B), **kw)
    _same_stats(ts_, js, T4, "final_tau")
    assert ts_.info == 0 and ts_.rejections >= 1 and ts_.final_m > 29
    assert _rel(tU, jU) <= RTOL
    visited = {k[1] for k in graphs.executions}
    _reads(len(visited) - 1)
    trials = sum(v for k, v in graphs.executions.items() if k[2] == "trial")
    assert (trials > 0) == (unroll == 0)


def test_nw_info2_vs_jax():
    """A NaN matvec: nine non-finite trials in the first substep (the
    ``pending`` path), info = 2 and NaN outputs, as JAX."""
    A = -2.0 * np.eye(16) + np.eye(16, k=1) + np.eye(16, k=-1)
    A[5, 5] = np.nan
    B = np.random.default_rng(1).standard_normal((16, 1))
    kw = dict(opnorm=4.0, return_stats=True)
    jU, js = ej.phiv_timestep_device([1.0], jnp.asarray(A), jnp.asarray(B),
                                     **kw)
    graphs.reset_counts()
    tU, ts_ = et.phiv_timestep_device([1.0], torch.as_tensor(A),
                                      torch.as_tensor(B), **kw)
    _same_stats(ts_, js, 1.0, "final_tau")
    assert ts_.info == 2
    assert _rel(tU, np.asarray(jU)) == 0.0
    _reads(0)
    assert graphs.executions[("phiv_timestep_device", 10, "trial")] > 0


def test_kiops_config4_vs_jax():
    """Config #4 at n = 200 through kiops_device: phantom snapshots inside
    one substep, bucket changes."""
    top, jop, B = _config4()
    jw, js = ej.kiops_device(TS4, jop, jnp.asarray(B), m=38, tol=1e-7)
    graphs.reset_counts()
    tw, ts_ = et.kiops_device(TS4, top, torch.as_tensor(B), m=38, tol=1e-7)
    _same_stats(ts_, js, T4)
    assert ts_.info == 0 and ts_.last_m > 38
    assert _rel(tw, jw) <= RTOL
    _reads(len({k[1] for k in graphs.executions}) - 1)


def test_kiops_info2_vs_jax():
    A = -2.0 * np.eye(16) + np.eye(16, k=1) + np.eye(16, k=-1)
    A[5, 5] = np.inf
    B = np.random.default_rng(2).standard_normal((16, 2))
    jw, js = ej.kiops_device([0.5, 1.0], jnp.asarray(A), jnp.asarray(B))
    graphs.reset_counts()
    tw, ts_ = et.kiops_device([0.5, 1.0], torch.as_tensor(A),
                              torch.as_tensor(B))
    _same_stats(ts_, js, 1.0)
    assert ts_.info == 2
    assert _rel(tw, np.asarray(jw)) == 0.0
    _reads(0)


def _allen_cahn(nx, nu=0.01):
    dx = 1.0 / (nx + 1)
    D = (np.diag(-2.0 * np.ones(nx)) + np.diag(np.ones(nx - 1), 1)
         + np.diag(np.ones(nx - 1), -1)) / dx ** 2 * nu
    Dj, Dt = jnp.asarray(D), torch.as_tensor(D)
    u0 = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1)) * 0.5
    return (lambda u: Dj @ u + u - u ** 3), (lambda u: Dt @ u + u - u ** 3), u0


def test_etdrk4_device_vs_jax():
    nx = 48
    dx = 1.0 / (nx + 1)
    cs = np.asarray([1.0, -2.0, 1.0]) / dx ** 2 * 0.01
    offs = ((-1,), (0,), (1,))
    opj = ej.StencilOperator((nx,), offs, jnp.asarray(cs), is_hermitian=True)
    opt = et.StencilOperator((nx,), offs, cs, is_hermitian=True)
    u0 = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1)) * 0.5

    def N(u):
        return u - u ** 3

    uj = ej.etdrk4_device(opj, N, u0, (0.0, 0.45), 0.15, m=20)
    graphs.reset_counts()
    ut = et.etdrk4_device(opt, N, u0, (0.0, 0.45), 0.15, m=20)
    assert _rel(ut, uj) <= RTOL
    assert graphs.counts["eager_steps"] == 3
    assert graphs.counts["blocking_reads"] == 1      # the finiteness check


def test_exprb43_device_fixed_vs_jax():
    fj, ft, u0 = _allen_cahn(48)
    uj, sj = ej.exprb43_device(fj, u0, (0.0, 0.5), 0.25, m=20,
                               return_stats=True)
    graphs.reset_counts()
    ut, st = et.exprb43_device(ft, u0, (0.0, 0.5), 0.25, m=20,
                               return_stats=True)
    _same_stats(st, sj, 0.5)
    assert _rel(ut, uj) <= RTOL
    assert graphs.counts["eager_steps"] == 2
    assert graphs.counts["blocking_reads"] == 1


def test_exprb43_device_bucket_growth_vs_jax():
    """A stiff diffusion: the phi estimate at m = 8 breaches phi_tol and
    the loop re-enters at larger buckets, as JAX's."""
    fj, ft, u0 = _allen_cahn(60, nu=1.0)
    kw = dict(rtol=1e-8, atol=1e-10, phi_tol=1e-12, m=8,
              return_stats=True)
    uj, sj = ej.exprb43_device(fj, u0, (0.0, 0.01), **kw)
    graphs.reset_counts()
    ut, st = et.exprb43_device(ft, u0, (0.0, 0.01), **kw)
    _same_stats(st, sj, 0.01)
    assert st.final_m > 8
    assert _rel(ut, uj) <= RTOL
    _reads(len({k[1] for k in graphs.executions}) - 1)


def test_exprb32_device_snapshots_vs_jax():
    """Adaptive exprb32 with snapshots: each snapshot a segment that
    reruns the same loop (the segment end is loop state)."""
    fj, ft, u0 = _allen_cahn(48)
    snaps = (0.1, 0.25)
    kw = dict(rtol=1e-7, atol=1e-9, m=20, snapshots=snaps, controller="i",
              return_stats=True)
    Uj, sj = ej.exprb32_device(fj, u0, (0.0, 0.25), **kw)
    graphs.reset_counts()
    Ut, st = et.exprb32_device(ft, u0, (0.0, 0.25), **kw)
    _same_stats(st, sj, 0.25)
    assert Ut.shape == (48, 2)
    assert _rel(Ut, Uj) <= RTOL
    assert graphs.counts["loops"] == len(snaps)       # one bucket
    assert graphs.counts["blocking_reads"] == len(snaps)


@pytest.mark.parametrize("lag", [0, 1])
def test_runner_cadence(lag):
    """A toy loop (a counter to 5): the lagged cadence runs one masked
    step past the end and the same state results; lag 0 (a sharded
    operator's) reads after every step, each read a blocking one."""
    state = torch.zeros(2)          # [count, active]

    def step():
        live = state[0] < 5
        state[0] = torch.where(live, state[0] + 1, state[0])
        state[1] = (state[0] < 5).to(state.dtype)

    graphs.reset_counts()
    with graphs.LoopRunner("toy", "cpu", sharded=(lag == 0)) as runner:
        assert runner.lag == lag
        flags = runner.loop(0, {"s": step}, state[1:],
                            lambda f: "s" if f is None or f[0] else None,
                            "s")
    assert flags == [0.0] and state[0] == 5
    assert graphs.executions[("toy", 0, "s")] == 5 + lag
    assert graphs.counts["blocking_reads"] == (5 if lag == 0 else 1)
    assert graphs.counts["flag_reads"] == (0 if lag == 0 else 4)


def test_kernel_executions_from_counts():
    """Host launch counters plus the runner's capture and replay tallies
    give executions (a captured launch runs only when replayed)."""
    graphs.reset_counts()
    graphs._captured.update({"banded_spmv": 23})
    graphs._replayed.update({"banded_spmv": 23 * 7})
    assert graphs.kernel_executions({"banded_spmv": 23 + 46,
                                     "sell_spmv": 0}) == \
        {"banded_spmv": 46 + 161, "sell_spmv": 0}
    adj = graphs.launch_adjustment()
    graphs._replayed.update({"banded_spmv": 23})
    assert graphs.kernel_executions({"banded_spmv": 5}, since=adj) == \
        {"banded_spmv": 28}
    graphs.reset_counts()

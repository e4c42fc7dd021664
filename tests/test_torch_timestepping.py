"""PyTorch port vs JAX package: the Niesen-Wright drivers
(models/timestepping.py, models/nw_device.py), float64 on CPU with the
same seeded numpy inputs through both packages.

Both packages make the same adaptive decisions on the same arithmetic up
to summation order, so the stats (steps, rejections, matvecs, final m)
are held equal, the final tau to 1e-12 of the end time (it is a
difference of sums), and the results to 1e-10 relative (norm-scaled). The
fixed-step steppers use another reduced exponential than JAX's (the
masked Taylor engine, which makes no host read): their results are held
to 1e-10, their step counts equal. Independent oracles (scipy's dense
exponentials of the augmented matrix) hold the drivers at the JAX tests'
limits; the failure protocol and signed times follow the documented
contract."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from torch_parity import assert_close, t2n

torch.set_num_threads(2)

RTOL = 1e-10          # port vs JAX, and config #4 vs its dense oracle


def laplacian_1d(n):
    return (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
            + np.diag(np.ones(n - 1), -1))


def adv_diff(n):
    """Stiff non-Hermitian advection-diffusion (the JAX tests' class)."""
    return 40.0 * laplacian_1d(n) + 10.0 * (np.diag(np.ones(n - 1), 1)
                                            - np.diag(np.ones(n - 1), -1))


def phi_combination_oracle(ts, A, B):
    """u(t) = sum_j t^j phi_j(tA) b_j from the block-matrix exponential."""
    n, ppo = B.shape
    p = ppo - 1
    out = np.zeros((n, len(ts)))
    for i, t in enumerate(ts):
        k = max(p, 1)
        E = np.zeros((n, k * n))
        E[:, :n] = np.eye(n)
        J = (np.kron(np.diag(np.ones(k - 1), 1), np.eye(n)) if k > 1
             else np.zeros((n, n)))
        P = sla.expm(np.block([[t * A, E], [np.zeros((k * n, n)), J]]))
        u = sla.expm(t * A) @ B[:, 0]
        for j in range(1, p + 1):
            u = u + (t ** j) * (P[:n, j * n:(j + 1) * n] @ B[:, j])
        out[:, i] = u
    return out


def _same_stats(got, want, tend=1.0):
    """The counters equal; the last substep (tend - t, a difference of
    sums) to a few ulps of the end time."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    tau_g, tau_w = g.pop("final_tau", 0.0), w.pop("final_tau", 0.0)
    assert g == w
    assert abs(tau_g - tau_w) <= 1e-12 * abs(tend), (tau_g, tau_w)


# (A, B, ts, kwargs) of tests/test_timestepping.py's fixtures
def _case(name):
    rng = np.random.default_rng(12345)
    if name == "laplacian adaptive snapshots":
        return (laplacian_1d(100), rng.standard_normal((100, 3)),
                [2.5, 5.0], dict(adaptive=True, tol=1e-7, m=10))
    if name == "advection-diffusion adaptive iop":
        return (adv_diff(120), rng.standard_normal((120, 3)), [0.05, 0.1],
                dict(adaptive=True, tol=1e-7, iop=4, hermitian=False))
    if name == "dense fixed step":
        return (rng.standard_normal((50, 50)) / 10,
                rng.standard_normal((50, 3)), 0.8,
                dict(tau=0.2, m=25, adaptive=False))
    if name == "unsorted ts":
        return (laplacian_1d(40), rng.standard_normal((40, 2)),
                [3.0, 1.0, 2.0], dict(adaptive=True, tol=1e-6))
    if name == "correct":
        return (laplacian_1d(60) * 0.5, rng.standard_normal((60, 3)),
                [1.0], dict(adaptive=True, tol=1e-8, correct=True))
    if name == "two_pass lanczos":
        return (laplacian_1d(100), rng.standard_normal((100, 4)),
                [2.5, 5.0], dict(adaptive=True, hermitian=True,
                                 two_pass=True))
    if name == "two_pass iop":
        A = laplacian_1d(80) + 0.5 * (np.diag(np.ones(79), 1)
                                      - np.diag(np.ones(79), -1))
        return (A, rng.standard_normal((80, 3)), [1.0],
                dict(adaptive=True, hermitian=False, iop=4, two_pass=True))
    if name == "opnorm seeding":
        return (laplacian_1d(50), rng.standard_normal((50, 1)), 2.0,
                dict(adaptive=True, tol=1e-7, opnorm=4.0))
    if name == "negative times":
        return (laplacian_1d(40), rng.standard_normal((40, 3)),
                [-1.0, -0.4], dict(adaptive=True, tol=1e-8, m=20))
    if name == "mixed signs":
        return (laplacian_1d(40), rng.standard_normal((40, 2)),
                [-0.8, 0.0, 0.6], dict(adaptive=True, tol=1e-8, m=20))
    raise KeyError(name)


NW_CASES = ["laplacian adaptive snapshots", "advection-diffusion adaptive iop",
            "dense fixed step", "unsorted ts", "correct", "two_pass lanczos",
            "two_pass iop", "opnorm seeding", "negative times", "mixed signs"]


@pytest.mark.parametrize("name", NW_CASES)
def test_phiv_timestep_vs_jax(name):
    A, B, ts, kw = _case(name)
    jU, js = ej.phiv_timestep(ts, jnp.asarray(A), jnp.asarray(B),
                              return_stats=True, **kw)
    tU, ts_ = et.phiv_timestep(ts, torch.as_tensor(A), torch.as_tensor(B),
                               return_stats=True, **kw)
    _same_stats(ts_, js, np.max(np.abs(ts)))
    assert_close(t2n(tU), np.asarray(jU), RTOL, name)
    want = phi_combination_oracle(np.atleast_1d(ts), A, B)
    got = t2n(tU).reshape(want.shape)
    assert_close(got, want, 1e-6, f"{name} vs the dense oracle")


DEVICE_CASES = {
    "laplacian": (laplacian_1d(100), 3, [2.5, 5.0], dict(hermitian=True)),
    "advection-diffusion iop": (adv_diff(200), 2, [0.05, 0.1],
                                dict(tol=1e-7, iop=4, hermitian=False)),
    "negative and zero": (laplacian_1d(40), 1, [-0.7, 0.0],
                          dict(tol=1e-8, m=20)),
    "expv taylor engine": (laplacian_1d(64), 0, 1.0,
                           dict(hermitian=True, expm_method="taylor")),
}


@pytest.mark.parametrize("name", list(DEVICE_CASES))
def test_phiv_timestep_device_vs_jax(name):
    A, p, ts, kw = DEVICE_CASES[name]
    B = np.random.default_rng(12345).standard_normal((A.shape[0], p + 1))
    jU, js = ej.phiv_timestep_device(ts, A, B, return_stats=True, **kw)
    tU, ts_ = et.phiv_timestep_device(ts, torch.as_tensor(A),
                                      torch.as_tensor(B), return_stats=True,
                                      **kw)
    _same_stats(ts_, js, np.max(np.abs(ts)))
    assert ts_.info == 0
    assert_close(t2n(tU), np.asarray(jU), RTOL, name)
    want = phi_combination_oracle(np.atleast_1d(ts), A, B)
    assert_close(t2n(tU).reshape(want.shape), want, 1e-6, "dense oracle")


def test_device_taylor_vs_higham2005():
    A = laplacian_1d(80)
    B = torch.as_tensor(np.random.default_rng(1).standard_normal((80, 3)))
    op = torch.as_tensor(A)
    U1 = et.phiv_timestep_device(1.0, op, B, hermitian=True,
                                 expm_method="higham2005")
    U2 = et.phiv_timestep_device(1.0, op, B, hermitian=True,
                                 expm_method="taylor")
    assert_close(t2n(U2), t2n(U1), 1e-12, "taylor vs higham2005")


def test_expv_timestep_entry_points():
    A = laplacian_1d(64)
    b = np.random.default_rng(2).standard_normal(64)
    want = sla.expm(A) @ b
    for fn in (et.expv_timestep, et.expv_timestep_device):
        kw = dict(adaptive=True) if fn is et.expv_timestep else {}
        w = fn(1.0, torch.as_tensor(A), b, hermitian=True, **kw)
        assert w.shape == (64,)
        assert_close(t2n(w), want, 1e-6, fn.__name__)


@pytest.mark.parametrize("herm", [False, True])
def test_fused_steppers_vs_jax(herm):
    rng = np.random.default_rng(3)
    if herm:
        A, p = laplacian_1d(64), 0
    else:
        A, p = rng.standard_normal((50, 50)) / 10, 2
    B = rng.standard_normal((A.shape[0], p + 1))
    ju, jeps = ej.phiv_timestep_fused(0.8, jnp.asarray(A), jnp.asarray(B),
                                      nsteps=4, m=25)
    tu, teps = et.phiv_timestep_fused(0.8, torch.as_tensor(A),
                                      torch.as_tensor(B), nsteps=4, m=25)
    assert teps.shape == (4,)
    assert_close(t2n(tu), np.asarray(ju), RTOL, "fused u")
    # the estimates are round-off here (~1e-40): both far below any tol
    assert float(teps.max()) < 1e-20 and float(jnp.max(jeps)) < 1e-20
    # the fixed-step host driver at the same (tau, m)
    tU = et.phiv_timestep(0.8, torch.as_tensor(A), torch.as_tensor(B),
                          tau=0.2, m=25, adaptive=False)
    assert_close(t2n(tu), t2n(tU), RTOL, "fused vs fixed-step driver")
    if herm:
        w, _ = et.expv_timestep_fused(-1.0, torch.as_tensor(A), B[:, 0],
                                      nsteps=20, m=20)
        assert_close(t2n(w), sla.expm(-A) @ B[:, 0], 1e-6, "negative t_end")


def test_make_phiv_timestep_vs_jax():
    rng = np.random.default_rng(12345)
    A = rng.standard_normal((60, 60)) / 8
    B = rng.standard_normal((60, 2))
    jfn = ej.make_phiv_timestep(1.0, jnp.asarray(A), jnp.asarray(B),
                                tol=1e-8, m=15)
    tfn = et.make_phiv_timestep(1.0, torch.as_tensor(A), torch.as_tensor(B),
                                tol=1e-8, m=15)
    assert (tfn.nsteps, tfn.m) == (jfn.nsteps, jfn.m)
    ju, _ = jfn(jnp.asarray(B))
    tu, teps = tfn(torch.as_tensor(B))
    assert teps.shape == (tfn.nsteps,)
    assert_close(t2n(tu), np.asarray(ju), RTOL, "calibrated stepper")


def _poisoned_op(n):
    """matvec = M v + NaN at row 0 once component n/2 is nonzero: with
    b[n/2] = 0 the first matvec is clean and the NaN appears mid-build."""
    M = torch.as_tensor(laplacian_1d(n))
    j0 = n // 2

    def mv(v):
        bad = torch.where(v[j0].abs() > 0, torch.nan, 0.0)
        out = M @ v
        return torch.cat([out[:1] + bad, out[1:]])

    return et.MatrixFreeOperator(mv, (n, n), dtype=torch.float64,
                                 opnorm=4.0, device="cpu")


@pytest.mark.parametrize("driver", ["adaptive", "fixed step", "device"])
def test_failure_protocol(driver):
    """A NaN matvec mid-solve ends the solve with info = 2 and NaN
    outputs, with no raise (and a warning when the stats are not asked
    for)."""
    b = np.zeros((16, 1))
    b[0, 0] = 1.0
    op = _poisoned_op(16)
    if driver == "device":
        fn = lambda **kw: et.phiv_timestep_device(1.0, op, b, opnorm=4.0,
                                                  **kw)
    else:
        extra = (dict(adaptive=True) if driver == "adaptive"
                 else dict(adaptive=False, tau=0.5))
        fn = lambda **kw: et.phiv_timestep(1.0, op, b, opnorm=4.0, **extra,
                                           **kw)
    U, stats = fn(return_stats=True)
    assert stats.info == 2
    assert not torch.isfinite(U).all()
    with pytest.warns(RuntimeWarning, match="info="):
        fn()


def test_clean_solve_does_not_warn():
    A = laplacian_1d(16)
    b = np.random.default_rng(4).standard_normal((16, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _, s = et.phiv_timestep(1.0, torch.as_tensor(A), b, adaptive=True,
                                return_stats=True)
    assert s.info == 0


def test_all_zero_times_and_not_ported():
    A = torch.as_tensor(laplacian_1d(40))
    B = torch.as_tensor(np.random.default_rng(5).standard_normal((40, 2)))
    U = et.phiv_timestep(np.array([0.0, 0.0]), A, B, adaptive=True)
    assert torch.equal(U, B[:, :1].expand(40, 2))
    assert torch.equal(et.phiv_timestep_device(0.0, A, B), B[:, 0])
    with pytest.raises(NotImplementedError):
        et.phiv_timestep(1.0, A, B, two_pass=True, correct=True)
    # reduced="host" is ported: the trials' reduced phi columns on host
    # scipy, the device form's steps and result
    Uh, sh = et.phiv_timestep(1.0, A, B, adaptive=True, reduced="host",
                              return_stats=True)
    Ud, sd = et.phiv_timestep(1.0, A, B, adaptive=True, return_stats=True)
    _same_stats(sh, sd)
    assert_close(t2n(Uh), t2n(Ud), 1e-12, "reduced=host vs device")


def test_config4_phiv_timestep_vs_jax_and_oracle():
    """BASELINE config #4 at its size (advection_diffusion_1d(2000, Pe=10),
    t = 1e-4, B = [b, 0.1 b]), run_baseline.py's call: the port's stats
    are JAX's, its result within 1e-10 of the augmented-matrix oracle."""
    n, t = 2000, 1e-4
    top = et.advection_diffusion_1d(n, peclet=10.0, device="cpu")
    jop = ej.advection_diffusion_1d(n, peclet=10.0, dtype=jnp.float64)
    b = np.random.default_rng(0).standard_normal(n)
    B = np.stack([b, 0.1 * b], axis=1)
    jU, js = ej.phiv_timestep([t], jop, jnp.asarray(B), adaptive=True,
                              tol=1e-7, m=20, return_stats=True)
    tU, ts_ = et.phiv_timestep([t], top, torch.as_tensor(B), adaptive=True,
                               tol=1e-7, m=20, return_stats=True)
    _same_stats(ts_, js)
    assert (ts_.steps, ts_.rejections, ts_.matvecs, ts_.final_m) == \
        (47, 1, 1855, 38)
    Ad = t2n(top.to_dense())
    aug = np.zeros((n + 1, n + 1))
    aug[:n, :n] = t * Ad
    aug[:n, n] = t * 0.1 * b
    F = sla.expm(aug)
    oracle = F[:n, :n] @ b + F[:n, n]
    err = np.linalg.norm(t2n(tU[:, 0]) - oracle) / np.linalg.norm(oracle)
    assert err < RTOL, err


@pytest.mark.parametrize("name", ["laplacian adaptive snapshots",
                                  "advection-diffusion adaptive iop",
                                  "two_pass lanczos", "two_pass iop"])
def test_phiv_timestep_reduced_host_vs_jax(name):
    """reduced="host" against JAX's reduced="host": the same steps, the
    results to 1e-12 (the JAX package takes this path on its TPU)."""
    A, B, ts, kw = _case(name)
    jU, js = ej.phiv_timestep(ts, jnp.asarray(A), jnp.asarray(B),
                              return_stats=True, reduced="host", **kw)
    tU, ts_ = et.phiv_timestep(ts, torch.as_tensor(A), torch.as_tensor(B),
                               return_stats=True, reduced="host", **kw)
    _same_stats(ts_, js, max(np.abs(ts)))
    assert_close(t2n(tU), np.asarray(jU), 1e-12, name)


@pytest.mark.parametrize("herm", [True, False])
def test_two_pass_complex_b_vs_oracle(herm):
    """Two-pass phiv_timestep with complex columns b_j (the JAX package
    lands 0.49-0.64 away): scipy's augmented exponential is the oracle."""
    n = 60
    rng = np.random.default_rng(21)
    A = laplacian_1d(n) if herm else adv_diff(n) / 40.0
    B = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    kw = dict(hermitian=True) if herm else dict(hermitian=False, iop=4)
    U = et.phiv_timestep([0.5, 1.0], torch.as_tensor(A), torch.as_tensor(B),
                         adaptive=True, two_pass=True, tol=1e-10, **kw)
    assert U.dtype == torch.complex128
    want = (phi_combination_oracle([0.5, 1.0], A, B.real)
            + 1j * phi_combination_oracle([0.5, 1.0], A, B.imag))
    assert_close(t2n(U), want, 1e-8, "complex B")

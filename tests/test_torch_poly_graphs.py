"""PyTorch port vs JAX package: the polynomial actions' and the Taylor
action's loops as one masked step each (models/chebyshev.py, leja.py,
faber.py, expv_taylor.py) and the generic recurrence of B3 / B3-var in
its device-index form (ops/kernels/lanczos_fused.recurrence_apply_fused),
float64 on the CPU with the same seeded numpy inputs through both
packages.

* Parity: each public action against JAX at the tolerances of
  tests/test_torch_{leja,faber,expv_taylor}.py and the Chebyshev parity
  tests (1e-12 relative, max-norm), on stencils (constant 2-D/3-D, a 3-D
  27-point box through B3's twin, variable), banded and dense operators;
  the complex-coefficient steps (complex t, complex b) held to scipy.
* One step a loop: a loop's step runs count times, step 0 before the
  runner (``ops/krylov._run``: rebinding, for the grad rule) and the rest
  through one ``utils/graphs.LoopRunner`` (a B3 pass: all m + 1 through
  it), read from ``graphs.executions``.
* No Python state in a step: every runner execution keeps the step's
  non-tensor closure cells as they were (a per-iteration host number
  would be frozen into a graph and repeated by every replay).
* B3's recurrence: the device-index twin (the ring, the state's counter,
  the stage's recurrence mode) gives the bits of the host-index loop it
  replaced, kept here as a helper.
* B2's pass 1 on b in an invariant subspace of dimension exactly m (the
  breakdown that only the last step's |y_m| shows): ``broke`` and
  ``m_used`` as the plain ``lanczos_coeffs`` and JAX's set them."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_torch.models import chebyshev as tc
from exponentialutilities_jl_torch.models import faber as tfb
from exponentialutilities_jl_torch.models import leja as tl
from exponentialutilities_jl_torch.ops import krylov as tk
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)


def _box27(pkg, shape, dtype=torch.float64):
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
    cs = [-26.0 if o == (0, 0, 0) else 1.0 for o in offs]
    if pkg is ej:
        return ej.StencilOperator(shape, offs, jnp.asarray(cs),
                                  is_hermitian=True)
    return et.StencilOperator(shape, offs, np.asarray(cs), is_hermitian=True,
                              dtype=dtype)


def _sym_dense(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n)) / 4
    return (M + M.T) / 2 - 2 * np.eye(n)


def _hermitian_ops(kind):
    """(jax operator, port operator, dense matrix or None) of a Hermitian
    class."""
    if kind == "2d":
        return (ej.laplacian_nd_stencil(9, 11), et.laplacian_nd_stencil(9, 11),
                None)
    if kind == "var":
        a = np.random.default_rng(0).uniform(0.5, 2.0, (4, 5, 7))
        return (ej.variable_diffusion_nd_stencil(a),
                et.variable_diffusion_nd_stencil(a), None)
    if kind == "banded":
        return ej.poisson_2d(12, 10), et.poisson_2d(12, 10), None
    M = _sym_dense(40, 1)
    return (jnp.asarray(M), et.DenseOperator(torch.as_tensor(M),
                                             is_hermitian=True), M)


def _nonsym_ops(kind):
    if kind == "banded":
        return (ej.advection_diffusion_1d(150, peclet=10.0),
                et.advection_diffusion_1d(150, peclet=10.0))
    M = np.random.default_rng(3).standard_normal((40, 40)) / 5
    M -= 2 * np.eye(40)
    return jnp.asarray(M), torch.as_tensor(M)


def _vec(n, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if cols is None else (n, cols))


# ------------------------------------------------------------ parity --

@pytest.mark.parametrize("kind", ["2d", "var", "banded", "dense"])
def test_expv_chebyshev_vs_jax(kind):
    jop, top, _ = _hermitian_ops(kind)
    n = top.shape[0]
    b = _vec(n, 1)
    wj = ej.expv_chebyshev(0.05, jop, jnp.asarray(b), tol=1e-12)
    wt = et.expv_chebyshev(0.05, top, torch.as_tensor(b), tol=1e-12)
    assert_close(t2n(wt), np.asarray(wj), RTOL64, kind)


@pytest.mark.parametrize("kind", ["2d", "banded"])
def test_phiv_chebyshev_vs_jax(kind):
    jop, top, _ = _hermitian_ops(kind)
    b = _vec(top.shape[0], 2)
    Wj = ej.phiv_chebyshev(0.05, jop, jnp.asarray(b), 2, tol=1e-12)
    Wt = et.phiv_chebyshev(0.05, top, torch.as_tensor(b), 2, tol=1e-12)
    assert_close(t2n(Wt), np.asarray(Wj), RTOL64, kind)


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_phiv_timestep_chebyshev_vs_jax(kind):
    """The combination scan: p + 1 = 3 columns, two snapshots."""
    jop, top, _ = _hermitian_ops(kind)
    B = _vec(top.shape[0], 3, cols=3)
    Uj = ej.phiv_timestep_chebyshev([0.02, 0.05], jop, jnp.asarray(B),
                                    tol=1e-12)
    Ut = et.phiv_timestep_chebyshev([0.02, 0.05], top, torch.as_tensor(B),
                                    tol=1e-12)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64, kind)


def test_box_stencil_through_the_fused_twin_vs_jax():
    """The 27-point box through B3's device-index twin (the engine the card
    takes for a large grid) against JAX's expv_chebyshev."""
    jop, top = _box27(ej, (5, 6, 7)), _box27(et, (5, 6, 7))
    b = _vec(top.shape[0], 4)
    lo, hi = top.spectral_bounds_hint()
    full, c, h = tc._full_exp_coeffs(0.02, lo, hi, 1e-12, None)
    rows = td.chebyshev_rows(torch.as_tensor(full), c, h, torch.float64)
    wt = tf.recurrence_apply_fused(top, torch.as_tensor(b), rows)
    wj = ej.expv_chebyshev(0.02, jop, jnp.asarray(b), tol=1e-12)
    assert_close(t2n(wt), np.asarray(wj), RTOL64)


def test_complex_t_chebyshev_vs_scipy():
    """Complex coefficients over the real recurrence (the plain step in a
    complex dtype)."""
    _, top, M = _hermitian_ops("dense")
    b = _vec(40, 5)
    w = et.expv_chebyshev(0.3 + 0.4j, top, torch.as_tensor(b), tol=1e-13)
    want = sla.expm((0.3 + 0.4j) * M) @ b
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-11


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_expv_leja_substeps_vs_jax(kind):
    """z = 60 at max_z = 40: two substeps, the masked substep boundary."""
    jop, top = _nonsym_ops(kind)
    s = tl._interval_map(top, None)[1]
    t = 60.0 / s
    b = _vec(top.shape[0], 6)
    assert tl._leja_expv_setup(top, t, None, 1e-10, None, 40.0)[4] == 2
    wj = ej.expv_leja(t, jop, jnp.asarray(b), tol=1e-10)
    wt = et.expv_leja(t, top, torch.as_tensor(b), tol=1e-10)
    assert_close(t2n(wt), np.asarray(wj), RTOL64, kind)


def test_phiv_leja_vs_jax():
    jop, top = _nonsym_ops("banded")
    t = 15.0 / tl._interval_map(top, None)[1]
    b = _vec(top.shape[0], 7)
    Wj = ej.phiv_leja(t, jop, jnp.asarray(b), 2, tol=1e-10)
    Wt = et.phiv_leja(t, top, torch.as_tensor(b), 2, tol=1e-10)
    assert_close(t2n(Wt), np.asarray(Wj), RTOL64)


def test_phiv_timestep_leja_vs_jax():
    """Two snapshot intervals of two substeps each: the NW scan's device
    time advanced by its step."""
    jop, top = _nonsym_ops("banded")
    s = tl._interval_map(top, None)[1]
    ts = [50.0 / s, 100.0 / s]
    B = _vec(top.shape[0], 8, cols=3)
    Uj = ej.phiv_timestep_leja(ts, jop, jnp.asarray(B), tol=1e-10)
    Ut = et.phiv_timestep_leja(ts, top, torch.as_tensor(B), tol=1e-10)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64)


def test_complex_b_leja_vs_scipy():
    """A complex b through the plain Newton step, three substeps."""
    _, top = _nonsym_ops("banded")
    M = np.stack([t2n(top.matvec(torch.as_tensor(e)))
                  for e in np.eye(150)], axis=1)
    t = 30.0 / tl._interval_map(top, None)[1]
    b = _vec(150, 9) + 1j * _vec(150, 10)
    assert tl._leja_expv_setup(top, t, None, 1e-12, None, 10.0)[4] == 3
    w = et.expv_leja(t, top, torch.as_tensor(b), tol=1e-12, max_z=10.0)
    want = sla.expm(t * M) @ b
    assert w.is_complex()
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-10


@pytest.mark.parametrize("kind", ["banded", "dense"])
def test_expv_faber_substeps_vs_jax(kind):
    """max_z = 20 makes three substeps: the masked substep boundary."""
    jop, top = _nonsym_ops(kind)
    _, _, _, g, _ = tfb._resolve_ellipse(top, None)
    t = 50.0 / g
    b = _vec(top.shape[0], 11)
    assert tfb._faber_expv_setup(top, t, None, 1e-10, None, 20.0)[4] == 3
    wj = ej.expv_faber(t, jop, jnp.asarray(b), tol=1e-10, max_z=20.0)
    wt = et.expv_faber(t, top, torch.as_tensor(b), tol=1e-10, max_z=20.0)
    assert_close(t2n(wt), np.asarray(wj), RTOL64, kind)


def test_phiv_timestep_faber_vs_jax():
    jop, top = _nonsym_ops("banded")
    _, _, _, g, _ = tfb._resolve_ellipse(top, None)
    ts = [30.0 / g, 60.0 / g]
    B = _vec(top.shape[0], 12, cols=3)
    Uj = ej.phiv_timestep_faber(ts, jop, jnp.asarray(B), tol=1e-10,
                                max_z=20.0)
    Ut = et.phiv_timestep_faber(ts, top, torch.as_tensor(B), tol=1e-10,
                                max_z=20.0)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64)


def test_complex_faber_coefficients_vs_scipy():
    """A complex b keeps complex Faber coefficients: the plain step (no
    engine takes them) in complex dtypes, over three substeps."""
    _, top = _nonsym_ops("banded")
    M = np.stack([t2n(top.matvec(torch.as_tensor(e)))
                  for e in np.eye(top.shape[0])], axis=1)
    _, _, _, g, _ = tfb._resolve_ellipse(top, None)
    t = 50.0 / g
    b = _vec(150, 13) + 1j * _vec(150, 14)
    w = et.expv_faber(t, top, torch.as_tensor(b), tol=1e-12, max_z=20.0)
    want = sla.expm(t * M) @ b
    assert w.is_complex()
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-10


def test_expv_taylor_vs_jax_and_scipy():
    rng = np.random.default_rng(15)
    A = rng.standard_normal((20, 20))
    b = rng.standard_normal(20)
    tw = et.expv_taylor(0.9, torch.as_tensor(A), torch.as_tensor(b))
    assert_close(t2n(tw), np.asarray(ej.expv_taylor(0.9, A, b)), 1e-12)
    # the operator path: s stages of m* matvecs, each stage one step
    op = et.advection_diffusion_1d(150, peclet=10.0)
    bo = _vec(150, 16)
    Md = np.stack([t2n(op.matvec(torch.as_tensor(e)))
                   for e in np.eye(150)], axis=1)
    t = 3.0 / float(op.opnorm_hint())
    w = et.expv_taylor(t, op, bo)
    want = sla.expm(t * Md) @ bo
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-10


def test_expv_taylor_batched_vs_jax():
    rng = np.random.default_rng(17)
    As = rng.standard_normal((5, 10, 10))
    As[2] *= 30.0                       # one system takes the power probes
    bs = rng.standard_normal((5, 10))
    ts = rng.uniform(0.1, 1.5, 5)
    tw = et.expv_taylor_batched(torch.as_tensor(ts), torch.as_tensor(As),
                                torch.as_tensor(bs))
    jw = ej.expv_taylor_batched(ts, As, bs)
    assert_close(t2n(tw), np.asarray(jw), 1e-12)


# ------------------------------------------------- one step a loop --

def _cheb_inputs(m=9):
    op = et.laplacian_nd_stencil(9, 11)
    b = torch.as_tensor(_vec(op.shape[0], 20))
    coeffs = torch.as_tensor(_vec(m, 21))
    return op, b, coeffs


def _newton(op, t, m):
    c, s = tl._interval_map(op, None)
    xi, _ = tl._leja_points_sup(m)
    d = tl._divided_differences(t, c, s, xi)
    return d, xi, c, s


def _loops():
    """name -> (call, label, runner key, runner executions): each loop on
    CPU tensors."""
    op2, b2, cf = _cheb_inputs()
    opB = et.advection_diffusion_1d(150, peclet=10.0)
    bB = torch.as_tensor(_vec(150, 22))
    BB = torch.as_tensor(_vec(150, 23, cols=3))
    op1 = et.StencilOperator((150,), ((-1,), (0,), (1,)),
                             np.asarray([1.2e3, -2.2e3, 1e3]),
                             is_hermitian=False)
    box = _box27(et, (5, 6, 7))
    bx = torch.as_tensor(_vec(box.shape[0], 24))
    rows_x = torch.as_tensor(_vec(24, 25).reshape(6, 4) * 0.05)
    d, xi, c, s = _newton(opB, 0.3 / tl._interval_map(opB, None)[1], 12)
    dt, xt = torch.as_tensor(d), torch.as_tensor(xi)
    D3 = torch.as_tensor(_vec(36, 26).reshape(12, 3) * 0.1)
    d1, xi1, c1, s1 = _newton(op1, 0.3 / tl._interval_map(op1, None)[1], 10)
    rows1 = torch.as_tensor(tl._newton_rows(d1, xi1, c1, 1.0 / s1))
    rows3 = torch.stack([rows1] * 3)
    C = torch.as_tensor(_vec(30, 27).reshape(5, 2, 3))
    a = torch.as_tensor(_vec(10, 28) * 0.1)
    label = lambda what, op: f"{what} ({type(op).__name__})"
    return {
        "B3 recurrence": (
            lambda: tf.recurrence_apply_fused(box, bx, rows_x),
            label("recurrence_apply_fused", box), 6, 7),
        "chebyshev scan": (
            lambda: tc._chebyshev_apply_scan(op2, b2, cf, -4.0, 0.2),
            label("chebyshev_apply", op2), 9, 8),
        "chebyshev combination": (
            lambda: tc._chebyshev_combination_scan(op2, torch.stack(
                [b2, 0.5 * b2, 0.1 * b2]), C, -4.0, 0.2),
            label("chebyshev_combination", op2), 5, 4),
        "leja apply q=3": (
            lambda: tl._leja_apply(opB, bB, dt, xt, c, 1.0 / s, 3),
            label("leja_apply", opB), 36, 35),
        "leja engine substeps q=4": (
            lambda: tl._engine_substeps(op1, bB, rows1, 4,
                                        tr.recurrence_apply_resident,
                                        "leja substeps"),
            label("leja substeps", op1), 4, 3),
        "nw leja q=2": (
            lambda: tl._nw_leja_scan(opB, bB, BB, D3, xt, c, 1.0 / s, 0.1,
                                     0.01, 2, 2),
            label("nw_leja", opB), 24, 23),
        "nw engine substeps q=3": (
            lambda: tl._nw_engine_substeps(op1, BB[:, 0], BB, rows3, 0.1,
                                           0.01, 3,
                                           tr.recurrence_apply_resident, 2,
                                           "nw_leja substeps"),
            label("nw_leja substeps", op1), 3, 2),
        "faber apply q=2": (
            lambda: tfb._faber_apply(opB, bB, a, c, 1.0 / s, 0.3, 2),
            label("faber_apply", opB), 20, 19),
        "nw faber q=2": (
            lambda: tfb._nw_faber_scan(opB, bB, BB, D3, c, 1.0 / s, 0.3,
                                       0.1, 0.01, 2, 2),
            label("nw_faber", opB), 24, 23),
        "taylor operator": (
            lambda: et.expv_taylor(100.0 / float(opB.opnorm_hint()), opB,
                                   bB),
            label("taylor", opB), None, None),
        "taylor dense batched": (
            lambda: et.expv_taylor_batched(
                0.5, torch.as_tensor(np.random.default_rng(29)
                                     .standard_normal((3, 8, 8)) * 3),
                torch.as_tensor(_vec(24, 30).reshape(3, 8))),
            "taylor (dense)", None, None),
    }


@pytest.mark.parametrize("name", list(_loops()))
def test_each_loop_is_one_step_run_count_times(name):
    """A loop's step is executed by one runner, at one key, under one
    name: count - 1 times after step 0 (a B3 pass: all m + 1 times), each
    eagerly on the CPU; no capture, no read. The Taylor loops' count is
    their s, read from the runner."""
    call, label, key, count = _loops()[name]
    graphs.reset_counts()
    call()
    exe = dict(graphs.executions)
    if key is None:             # s stages: one key, s - 1 executions
        assert len(exe) == 1, exe
        (what, k, step), n = next(iter(exe.items()))
        assert what == label and step == "step" and n == k - 1, exe
        count = n
    else:
        step = "sweep" if name.startswith("B3") else "step"
        assert exe == {(label, key, step): count}, exe
    assert graphs.counts["eager_steps"] == count
    assert not graphs.counts["captures"] and not graphs.counts[
        "blocking_reads"]


def test_a_loop_inside_a_runner_step_runs_inline():
    """Nested: inside a runner's step the loop runs with no runner of its
    own (its executions are the enclosing step's), with the same bits."""
    op, b, cf = _cheb_inputs()
    want = tc._chebyshev_apply_scan(op, b, cf, -4.0, 0.2)
    graphs.reset_counts()
    out = []
    with graphs.LoopRunner("outer", "cpu") as runner:
        runner.repeat(0, "outer", lambda: out.append(
            tc._chebyshev_apply_scan(op, b, cf, -4.0, 0.2)), 1)
    assert graphs.executions == {("outer", 0, "outer"): 1}
    assert torch.equal(out[0], want)


def test_grad_rule_runs_every_step_rebinding():
    """A b that requires grad: every step rebinds, with no runner, and the
    gradient flows (the chip's requires-grad expv_chebyshev)."""
    op, b, cf = _cheb_inputs()
    bg = b.clone().requires_grad_()
    graphs.reset_counts()
    w = tc._chebyshev_apply_scan(op, bg, cf, -4.0, 0.2)
    assert not graphs.executions
    w.sum().backward()
    bn = bg.detach()
    eps = 1e-6
    e0 = torch.zeros_like(bn)
    e0[3] = eps
    fd = (tc._chebyshev_apply_scan(op, bn + e0, cf, -4.0, 0.2).sum()
          - tc._chebyshev_apply_scan(op, bn - e0, cf, -4.0, 0.2).sum()) / (
              2 * eps)
    assert abs(float(bg.grad[3]) - float(fd)) < 1e-6 * max(1.0, abs(float(fd)))


# ---------------------------------------------- no Python state in a step --

def _snapshot(fn):
    """The step's non-tensor closure cells: numbers and strings by value,
    a loop state by its non-tensor attributes, other objects by
    identity."""
    out = []
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if isinstance(v, torch.Tensor):
            continue
        if isinstance(v, tk._State):
            out.append(("state", id(v), {k: x for k, x in vars(v).items()
                                         if not isinstance(x, torch.Tensor)}))
        elif isinstance(v, (bool, int, float, complex, str, type(None))):
            out.append(("value", v))
        elif isinstance(v, (list, dict, set)):
            out.append(("container", id(v), repr(v)))
        else:
            out.append(("object", id(v)))
    return out


@pytest.fixture
def closure_watch(monkeypatch):
    """Patches ``LoopRunner._execute``: every execution's step closure
    cells before and after, and the names of the steps that changed."""
    changed, seen = [], []
    real = graphs.LoopRunner._execute

    def execute(self, key, name, fn, capture=True):
        before = _snapshot(fn)
        real(self, key, name, fn, capture)
        seen.append((self.what, name))
        if _snapshot(fn) != before:
            changed.append((self.what, name))

    monkeypatch.setattr(graphs.LoopRunner, "_execute", execute)
    return changed, seen


def test_the_closure_watch_sees_a_host_counter(closure_watch):
    """The check itself: a step that advances a Python counter is seen."""
    changed, _ = closure_watch
    k = 0

    def step():
        nonlocal k
        k += 1

    with graphs.LoopRunner("counter", "cpu") as runner:
        runner.repeat(0, "step", step, 3)
    assert changed == [("counter", "step")] * 3


@pytest.mark.parametrize("name", list(_loops()))
def test_no_step_changes_its_closure(name, closure_watch):
    changed, seen = closure_watch
    _loops()[name][0]()
    assert seen and not changed, (seen, changed)


# -------------------------------------------------- B3 recurrence bits --

def _host_index_recurrence(op, b, rows):
    """The host-index loop that the device-index form replaced (as it
    was): sweep 0 on (b, b, 0) with the unit row, sweep s + 1 on row s,
    the vectors rotated on the host."""
    zeros = torch.zeros_like(b)
    W = torch.zeros_like(b)
    cvals = tf._cvals(op, b.dtype)
    unit = tf._const((1.0, 0.0, 0.0, 0.0), b)
    Z, Vc, Vp = b, b, zeros
    for s in range(rows.shape[0] + 1):
        co = unit if s == 0 else rows[s - 1]
        Y, Zn, _ = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                      op.offsets, cvals, W)
        Z, Vc, Vp = Zn, Y, (zeros if s == 0 else Vc)
    return W


def _b3_op(kind, dtype):
    if kind == "7pt":
        return et.laplacian_nd_stencil(4, 5, 7, dtype=dtype)
    if kind == "2d":
        return et.laplacian_nd_stencil(9, 11, dtype=dtype)
    if kind == "box":
        return _box27(et, (4, 5, 6), dtype)
    a = np.random.default_rng(31).uniform(0.5, 2.0, (4, 5, 7))
    return et.variable_diffusion_nd_stencil(a, dtype=dtype)


@pytest.mark.parametrize("tdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [0, 1, 2, 5])
@pytest.mark.parametrize("kind", ["7pt", "2d", "box", "var"])
def test_device_index_recurrence_equals_host_index_bits(kind, m, tdt):
    op = _b3_op(kind, tdt)
    gen = np.random.default_rng(40 + m)
    b = torch.as_tensor(gen.standard_normal(op.shape[0]), dtype=tdt)
    rows = torch.as_tensor(gen.standard_normal((m, 4)) * 0.1, dtype=tdt)
    got = tf.recurrence_apply_fused(op, b, rows)
    want = _host_index_recurrence(op, b, rows)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_stage_rows_twin_masks_by_the_counter():
    """Recurrence mode: row s into the coefficient slots while s < m, past
    m only the counter, the other slots untouched."""
    st = tf._const(tf._STATE0, torch.zeros(1, dtype=torch.float64))
    st[5].fill_(3.0)
    rows = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    for s in range(3):
        tf.sweep_rows_ref(st, rows, 3)
        assert torch.equal(st[:4], rows[s]) and float(st[8]) == s + 1
    before = st.clone()
    tf.sweep_rows_ref(st, rows, 3)
    assert torch.equal(st[:8], before[:8]) and float(st[8]) == 4.0
    st0 = tf._const(tf._STATE0, st)
    tf.sweep_rows_ref(st0, rows[:0], 0)
    assert torch.equal(st0[:8], tf._const(tf._STATE0, st)[:8])


# ------------------------------------------------------- B2 breakdown --

@pytest.mark.parametrize("m", [3, 5, 8])
def test_b2_breakdown_at_the_last_step(m):
    """b a sum of m eigenvectors of the 1-D Laplacian (an invariant
    subspace of dimension exactly m): the breakdown shows only at the last
    step's |y_m|. B2's twin sets broke and m_used as the plain
    lanczos_coeffs and JAX's do; alphas agree, and the betas before the
    last (B2 records 0 for a beta below tol, the plain pass its value)."""
    n = 64
    i = np.arange(1, n + 1)
    rng = np.random.default_rng(m)
    modes = (1, 4, 9, 13, 20, 31, 40, 50)[:m]
    b = sum(rng.uniform(0.5, 2.0) * np.sin(k * np.pi * i / (n + 1))
            for k in modes)
    op = et.laplacian_nd_stencil(n)
    bt = torch.as_tensor(b)
    res = tr.lanczos_coeffs_resident(op, bt, m)
    pln = tk.lanczos_coeffs(op, bt, m)
    jax = jk.lanczos_coeffs(ej.laplacian_nd_stencil(n), jnp.asarray(b), m)
    for got in (res, pln):
        assert bool(got[4]) and bool(jax[4])
        assert int(got[3]) == int(jax[3]) == m
    assert_close(t2n(res[0]), np.asarray(jax[0]), RTOL64, "alphas")
    assert_close(t2n(res[1][:m - 1]), np.asarray(jax[1][:m - 1]), RTOL64,
                 "betas")
    assert float(res[1][m - 1]) == 0.0 and float(pln[1][m - 1]) < 1e-7

"""The Krylov builders of ops/krylov.py as masked steps over device-index
state, against the JAX package's jitted builders (float64 and complex128
on the CPU, the same seeded numpy inputs through both), and the runner's
counts on the CPU: each builder call runs its step 0 (which rebinds its
state) and then steps 1 .. m - 1 eagerly through a
``utils/graphs.LoopRunner`` of its own, and captures nothing; a builder
inside a runner's step runs inline; a call that autograd must see (an
operand that requires grad, or a parameter that a matrix-free
operator's function closes over) rebinds its state at every step instead
of writing it in place, with the same bits.

The cases are those that tests/test_torch_krylov.py and
tests/test_torch_arnoldi.py (which run the same builders against JAX on a
Laplacian, a dense real and complex operator, an invariant-subspace
breakdown and b = 0) leave out: m = 1 and 2, a happy breakdown from three
distinct eigenvalues, a complex b on a real operator, an extension of a
broken basis. Their tolerances: the recurrence records (H, alphas,
betas, beta0) to RTOL64 where one three-term recurrence produces them,
the bases, the Gram-Schmidt Hessenbergs and the replays to RTOL_BASIS =
1e2 x RTOL64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)

RTOL_BASIS = 1e2 * RTOL64
M = 10


def _case(kind):
    """(jax operator, b) of each kind:

    herm      the 5 x 6 Laplacian stencil (Hermitian), a random b;
    three     a diagonal operator with three distinct eigenvalues and a
              b that excites all three: a happy breakdown at step 3;
    nonsym    advection_diffusion_1d(40, Pe = 5) (non-Hermitian);
    complex_b the real Laplacian (Hermitian) with a complex b."""
    rng = np.random.default_rng(31)
    if kind in ("herm", "complex_b"):
        b = rng.standard_normal(30)
        if kind == "complex_b":
            b = b + 1j * rng.standard_normal(30)
        return ej.laplacian_nd_stencil(5, 6), b
    if kind == "three":
        d = np.repeat([-3.0, -1.5, -0.2], 8)
        return ej.DiagonalOperator(jnp.asarray(d)), rng.standard_normal(24)
    return (ej.advection_diffusion_1d(40, peclet=5.0),
            rng.standard_normal(40))


def _both(kind):
    jop, b = _case(kind)
    return jop, et.to_torch_operator(jop), jnp.asarray(b), torch.as_tensor(b)


def _same_basis(Kt, Kj, rtol_h):
    assert Kt.hermitian == Kj.hermitian and Kt.m == Kj.m
    assert_close(t2n(Kt.V), np.asarray(Kj.V), RTOL_BASIS, "V")
    assert_close(t2n(Kt.H), np.asarray(Kj.H), rtol_h, "H")
    assert float(Kt.beta) == pytest.approx(float(Kj.beta), rel=RTOL64)
    assert Kt.m_used.dtype == torch.int32
    assert int(Kt.m_used) == int(Kj.m_used)
    assert bool(Kt.breakdown) == bool(Kj.breakdown)


def _coeffs(m, ncols, jmu, dtype, seed):
    """Replay coefficients, zero past the recorded m_used: past a
    breakdown both replays divide by the recorded sub-tol norm and
    regenerate rounding noise, which the reduced problem weights by ~0."""
    shape = (m,) if ncols is None else (m, ncols)
    c = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    c[int(jmu):] = 0.0
    return c


@pytest.mark.parametrize("kind,full_reorth,m", [
    ("three", True, M), ("complex_b", False, M), ("complex_b", True, M),
    ("herm", True, 1), ("herm", False, 2)])
def test_lanczos(kind, full_reorth, m):
    jop, top, jb, tb = _both(kind)
    Kj = jk.lanczos(jop, jb, m, full_reorth=full_reorth)
    Kt = et.lanczos(top, tb, m, full_reorth=full_reorth)
    _same_basis(Kt, Kj, RTOL64)
    if kind == "three" and m == M:
        # beta_3 (below tol) stays recorded, as in JAX
        assert int(Kt.m_used) == 3 and bool(Kt.breakdown)
        assert not t2n(Kt.V[4:]).any() and not t2n(Kt.H[3:, 3:]).any()


@pytest.mark.parametrize("kind,m,ncols", [
    ("three", M, 3), ("complex_b", M, None), ("herm", 1, 3),
    ("herm", 2, None)])
def test_lanczos_coeffs_and_replay(kind, m, ncols):
    jop, top, jb, tb = _both(kind)
    ja, jbt, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jb, m)
    ta, tbt, tb0, tmu, tbr = et.lanczos_coeffs(top, tb, m)
    assert ta.shape == tbt.shape == (m,)
    assert_close(t2n(ta), np.asarray(ja), RTOL64, "alphas")
    assert_close(t2n(tbt), np.asarray(jbt), RTOL64, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL64)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
    # coefficients in b's type: JAX's replay accumulates in theirs
    c = _coeffs(m, ncols, jmu, np.asarray(jb).dtype, 8)
    jw = jk.lanczos_replay(jop, jb, jnp.asarray(c), ja, jbt, m)
    tw = et.lanczos_replay(top, tb, torch.as_tensor(c), ta, tbt, m)
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "replay")
    # the replay regenerates the basis of the stored recurrence
    V = t2n(et.lanczos(top, tb, m).V)[:m]
    want = c @ V if ncols is None else V.T @ c
    assert_close(t2n(tw), want, RTOL_BASIS, "replay vs basis")


@pytest.mark.parametrize("kind,iop,reorth", [
    ("three", 0, True), ("three", 2, False), ("complex_b", 0, True),
    ("complex_b", 2, False)])
def test_arnoldi(kind, iop, reorth):
    jop, top, jb, tb = _both(kind)
    Kj = jk.arnoldi(jop, jb, M, iop=iop, reorth=reorth)
    Kt = et.arnoldi(top, tb, M, iop=iop, reorth=reorth)
    _same_basis(Kt, Kj, RTOL_BASIS)
    if kind == "three":
        assert int(Kt.m_used) == 3 and bool(Kt.breakdown)
        assert not t2n(Kt.V[4:]).any() and not t2n(Kt.H[:, 3:]).any()


@pytest.mark.parametrize("iop,m", [(0, 1), (2, 2)])
def test_arnoldi_small_m(iop, m):
    jop, top, jb, tb = _both("nonsym")
    _same_basis(et.arnoldi(top, tb, m, iop=iop),
                jk.arnoldi(jop, jb, m, iop=iop), RTOL_BASIS)


@pytest.mark.parametrize("kind,iop", [("nonsym", 2), ("three", 0)])
def test_arnoldi_extend(kind, iop):
    """From a basis of 2 steps (a broken one for ``three`` after its
    third step) to 4 and then M: equal to JAX's extension and to M steps
    at once."""
    jop, top, jb, tb = _both(kind)
    m0 = 3 if kind == "three" else 2
    Kj = jk.arnoldi_extend(jop, jk.arnoldi(jop, jb, m0, iop=iop), M, iop=iop)
    K0 = et.arnoldi(top, tb, m0, iop=iop)
    broke0 = (bool(K0.breakdown), int(K0.m_used))
    Kt = et.arnoldi_extend(top, K0, M, iop=iop)
    _same_basis(Kt, Kj, RTOL_BASIS)
    _same_basis(Kt, jk.arnoldi(jop, jb, M, iop=iop), RTOL_BASIS)
    # the basis it extends is left as it was
    assert (bool(K0.breakdown), int(K0.m_used)) == broke0
    assert K0.V.shape == (m0 + 1, tb.shape[0])
    if kind == "three":
        assert broke0 == (True, 3) and int(Kt.m_used) == 3


@pytest.mark.parametrize("kind,win,ncols", [
    ("three", 2, 3), ("complex_b", 3, None)])
def test_arnoldi_coeffs_and_replay(kind, win, ncols):
    jop, top, jb, tb = _both(kind)
    Hj, bj, muj, brj = jk.arnoldi_coeffs(jop, jb, M, win)
    Ht, bt, mut, brt = et.arnoldi_coeffs(top, tb, M, win)
    assert_close(t2n(Ht), np.asarray(Hj), RTOL_BASIS, "compact H")
    assert float(bt) == pytest.approx(float(bj), rel=RTOL64)
    assert (int(mut), bool(brt)) == (int(muj), bool(brj))
    c = _coeffs(M, ncols, muj, np.asarray(jb).dtype, 12)
    # (m, p) coefficients with KIOPS' final vector, (m,) without
    final = np.full(ncols, 0.7) if ncols else None
    jw = jk.arnoldi_replay(jop, jb, jnp.asarray(c), Hj, M, win,
                           final_coeff=final, with_final=bool(ncols))
    tw = et.arnoldi_replay(top, tb, torch.as_tensor(c), Ht, M, win,
                           final_coeff=final, with_final=bool(ncols))
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "replay")
    # pass 1 is the IOP Arnoldi recurrence without reorth
    Kt = et.arnoldi(top, tb, M, iop=win, reorth=False)
    assert_close(t2n(et.expand_compact_hessenberg(Ht, win)), t2n(Kt.H),
                 RTOL_BASIS, "vs arnoldi(iop=win)")


def _seven(top, tb, m):
    """Each builder once on (top, tb) at m steps: name -> (call, steps)."""
    c = torch.linspace(1.0, 0.1, m, dtype=torch.float64)
    rec = et.lanczos_coeffs(top, tb, m)
    Hc = et.arnoldi_coeffs(top, tb, m, 2)[0]
    K2 = et.arnoldi(top, tb, 2)
    return {
        "arnoldi": (lambda: et.arnoldi(top, tb, m), m),
        "arnoldi_extend": (lambda: et.arnoldi_extend(top, K2, m), m - 2),
        "lanczos": (lambda: et.lanczos(top, tb, m, full_reorth=True), m),
        "lanczos_coeffs": (lambda: et.lanczos_coeffs(top, tb, m), m),
        "lanczos_replay": (lambda: et.lanczos_replay(top, tb, c, rec[0],
                                                     rec[1], m), m),
        "arnoldi_coeffs": (lambda: et.arnoldi_coeffs(top, tb, m, 2), m),
        "arnoldi_replay": (lambda: et.arnoldi_replay(
            top, tb, c, Hc, m, 2, final_coeff=0.5, with_final=True), m),
    }


def test_runner_counts_on_the_cpu():
    """Each builder call: step 0 on the caller's stream, then the other
    steps eagerly through a runner of its own (one execution entry per
    call, keyed by the step count), no capture, no replay, no read; m = 1
    opens no runner."""
    _, top, _, tb = _both("nonsym")
    m = 6
    for name, (call, steps) in _seven(top, tb, m).items():
        graphs.reset_counts()
        call()
        assert dict(graphs.counts) == {"eager_steps": steps - 1}, name
        assert dict(graphs.executions) == {
            (f"{name} ({type(top).__name__})", steps, "step"): steps - 1}, \
            name
    for name, (call, steps) in _seven(top, tb, 1).items():
        if name != "arnoldi_extend":
            graphs.reset_counts()
            call()
            assert not graphs.counts and not graphs.executions, name


def test_builder_inside_a_runner_step_runs_inline():
    """A builder called by a runner's step runs in that step (no runner,
    no counts of its own): the enclosing loop counts only its own steps,
    and the result equals the builder called alone."""
    _, top, _, tb = _both("nonsym")
    out = {}

    def step():
        out["K"] = et.arnoldi(top, tb, 5, iop=2)

    graphs.reset_counts()
    with graphs.LoopRunner("outer", "cpu") as runner:
        assert not graphs.inline("cpu")
        runner.repeat(0, "step", step, 2)
    assert dict(graphs.counts) == {"eager_steps": 2}
    assert dict(graphs.executions) == {("outer", 0, "step"): 2}
    K = et.arnoldi(top, tb, 5, iop=2)
    assert torch.equal(out["K"].V, K.V) and torch.equal(out["K"].H, K.H)


def test_autograd_rebinds_with_the_same_bits():
    """A b that requires grad: step 0's state requires grad, so every step
    rebinds its state (no in-place write that autograd saved) and no
    runner opens; the steps give the bits of the in-place form, and
    backward runs through them."""
    _, top, _, tb = _both("nonsym")
    for fn in (lambda b: et.arnoldi(top, b, M, iop=2).V,
               lambda b: et.arnoldi(top, b, M).H,
               lambda b: et.lanczos_replay(top, b, torch.ones(M),
                                           *et.lanczos_coeffs(top, b, M)[:2],
                                           M),
               lambda b: et.arnoldi_replay(top, b, torch.ones(M),
                                           et.arnoldi_coeffs(top, b, M, 2)[0],
                                           M, 2)):
        want = fn(tb)
        bg = tb.clone().requires_grad_()
        graphs.reset_counts()
        got = fn(bg)
        assert not graphs.counts
        assert got.requires_grad and torch.equal(got.detach(), want)
        (g,) = torch.autograd.grad(got.abs().sum(), bg)
        assert torch.isfinite(g).all() and g.abs().sum() > 0


@pytest.mark.parametrize("two_pass", [False, True])
def test_grad_through_a_parameter_in_a_closure(two_pass):
    """A matrix-free operator whose function closes over a parameter p
    (x -> p A x): no tensor the builders are given requires grad, but
    step 0's state does, so every step rebinds and backward reaches p.
    expv (Arnoldi) and the two-pass expv (lanczos_coeffs, lanczos_replay)
    against scipy: exp(t p A) b, and its derivative in p, sum(t A exp(t p
    A) b), at the autograd files' RTOL_GRAD = 1e-10."""
    rng = np.random.default_rng(43)
    n, t, p0 = 40, 0.7, 0.9
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    if two_pass:
        A = 0.5 * (A + A.T)
    b = rng.standard_normal(n)
    At = torch.as_tensor(A)
    p = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    op = et.MatrixFreeOperator(lambda x: p * (At @ x), (n, n),
                               is_hermitian=two_pass, device="cpu")
    graphs.reset_counts()
    w = et.expv(t, op, torch.as_tensor(b), m=30, two_pass=two_pass)
    assert not graphs.counts            # every step rebinds, no runner
    (g,) = torch.autograd.grad(w.sum(), p)
    E = sla.expm(t * p0 * A) @ b
    assert_close(t2n(w.detach()), E, 1e-10, "exp(t p A) b")
    want = float((t * A @ E).sum())
    assert abs(float(g) - want) <= 1e-10 * abs(want), (float(g), want)

"""PyTorch port vs JAX package and scipy: the serving closures
(``make_expv``, ``make_phiv``: one ``utils/graphs.Program`` each), the
error-estimate Lanczos loop (one masked step through a ``LoopRunner``)
and R1's twin (``ops/kernels/tridiag.tridiag_exp_e1_ref``), float64 and
complex128 on the CPU, with the same seeded numpy inputs through both
packages. On the CPU every program call and loop step runs eagerly; the
CUDA graphs are held by tests/test_torch_cuda.py on the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import expv as jx
from exponentialutilities_jl_torch.ops.kernels import tridiag as tt
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)

# the closures against JAX's compiled ones, and the error-estimate loop's
# w against JAX's loop: the same arithmetic up to summation order, over at
# most 30 Krylov steps on these small operators (checked on the CPU)
RTOL = RTOL64
# the BASELINE accuracy target for float64 against scipy
RTOL_SCIPY = 1e-10


def _operators():
    """(jax, torch, dense) of a Hermitian 1-D stencil at n = 64 and the
    advection-diffusion operator at n = 200."""
    out = {}
    for name, jop in (("stencil", ej.laplacian_nd_stencil(64)),
                      ("advection", ej.advection_diffusion_1d(200))):
        out[name] = (jop, et.to_torch_operator(jop),
                     np.asarray(jop.to_banded().to_dense()
                                if name == "stencil" else jop.to_dense()))
    return out


OPS = _operators()
CELLS = {"stencil": (0.5, {}), "advection iop=0": (2e-4, {}),
         "advection iop=2": (2e-4, {"iop": 2})}


def _cell(name):
    t, kw = CELLS[name]
    jop, top, A = OPS[name.split()[0]]
    return jop, top, A, t, kw


@pytest.mark.parametrize("name", list(CELLS))
def test_make_expv_matches_jax(name):
    """Four calls of one closure (fresh b each) against JAX's make_expv;
    on the CPU each is one eager program call."""
    jop, top, A, t, kw = _cell(name)
    jfn = ej.make_expv(jop, m=30, **kw)
    tfn = et.make_expv(top, m=30, **kw)
    assert top.is_hermitian == (name == "stencil")
    rng = np.random.default_rng(60)
    graphs.reset_counts()
    outs = []
    for i in range(4):
        b = rng.standard_normal(A.shape[0])
        w = tfn(t, torch.as_tensor(b))
        assert_close(t2n(w), np.asarray(jfn(t, jnp.asarray(b))), RTOL,
                     f"{name} call {i}")
        outs.append(w)
    assert dict(graphs.counts) == {"eager_steps": 4}
    assert len({w.data_ptr() for w in outs}) == 4
    assert_close(t2n(outs[-1]), sla.expm(t * A) @ b, RTOL_SCIPY, "vs scipy")


@pytest.mark.parametrize("name", list(CELLS))
def test_make_phiv_matches_jax(name):
    jop, top, A, t, kw = _cell(name)
    jfn = ej.make_phiv(jop, 2, m=30, **kw)
    tfn = et.make_phiv(top, 2, m=30, **kw)
    b = np.random.default_rng(61).standard_normal(A.shape[0])
    for _ in range(2):
        w, err = tfn(t, b)
        jw, je = jfn(t, jnp.asarray(b))
        assert w.shape == (A.shape[0], 3)
        assert_close(t2n(w), np.asarray(jw), RTOL, name)
        assert float(err) == pytest.approx(float(je), rel=1e-6, abs=1e-13)


def test_one_closure_two_keys():
    """A real and a complex t are two keys of one closure (t's dtype);
    each matches JAX and the keys' results are their own."""
    jop, top, A, _, _ = _cell("stencil")
    jfn = ej.make_expv(jop, m=30)
    tfn = et.make_expv(top, m=30)
    b = np.random.default_rng(62).standard_normal(64)
    graphs.reset_counts()
    for t in (0.4, 0.4 + 0.3j, 0.4, 0.4 + 0.3j):
        w = tfn(t, b)
        assert w.dtype == (torch.complex128 if isinstance(t, complex)
                           else torch.float64)
        assert_close(t2n(w), np.asarray(jfn(t, jnp.asarray(b))), RTOL,
                     f"t={t}")
        assert_close(t2n(w), sla.expm(t * A) @ b, RTOL_SCIPY, "vs scipy")
    assert set(tfn.program.touched) == {((64,), torch.float64, torch.float64,
                                 torch.device("cpu"), True),
                                ((64,), torch.float64, torch.complex128,
                                 torch.device("cpu"), True)}
    assert graphs.counts["eager_steps"] == 4
    assert not graphs.counts["captures"] and not graphs.counts["replays"]
    tfn.close()


def test_make_expv_gradient_through_a_parameter():
    """A closure whose MatrixFreeOperator closes over a Parameter: the
    result requires grad, so its key stays eager, and the gradient in the
    parameter meets scipy's d/dp sum exp(t p A0) b = sum t A0 exp(t p A0) b."""
    rng = np.random.default_rng(63)
    n, t = 30, 0.4
    M = rng.standard_normal((n, n))
    A0 = -(M @ M.T) / n
    b = rng.standard_normal(n)
    A0t = torch.as_tensor(A0)
    p = torch.nn.Parameter(torch.tensor(0.7, dtype=torch.float64))
    op = et.MatrixFreeOperator(lambda x: p * (A0t @ x), (n, n),
                               is_hermitian=True, device="cpu")
    fn = et.make_expv(op, m=n)
    for _ in range(2):
        w = fn(t, torch.as_tensor(b))
        assert w.requires_grad
        (g,) = torch.autograd.grad(w.sum(), p)
        E = sla.expm(t * 0.7 * A0)
        assert_close(t2n(w), E @ b, RTOL_SCIPY, "w vs scipy")
        want = np.sum(t * A0 @ E @ b)
        assert abs(float(g) - want) <= 1e-10 * abs(want)
    assert fn.program.eager_keys == set(fn.program.touched)
    # the warm-up recorded the parameter among what the call reads from
    # outside it (the grad rule of a later call holds it)
    (refs,) = fn.program.touched.values()
    assert any(r() is p for r in refs)


def test_program_grad_rule_sees_a_tensor_turned_on_after_warm_up():
    """The warm-up of a key records what the call reads from outside it:
    the operator's tensor, not the call's inputs or its intermediates.
    The grad rule of a later call holds those tensors, so a tensor that
    starts to require grad after the warm-up (or a transform) sends the
    call to the eager path; on the CPU every call runs there, and the
    gradient meets scipy's."""
    rng = np.random.default_rng(64)
    n, t = 30, 0.4
    M = rng.standard_normal((n, n))
    A0 = -(M @ M.T) / n
    A0t = torch.as_tensor(A0)
    p = torch.tensor(0.7, dtype=torch.float64)
    op = et.MatrixFreeOperator(lambda x: p * (A0t @ x), (n, n),
                               is_hermitian=True, device="cpu")
    fn = et.make_expv(op, m=n)
    b = torch.as_tensor(rng.standard_normal(n))
    assert not fn(t, b).requires_grad
    (refs,) = fn.program.touched.values()
    seen = [r() for r in refs]
    assert any(x is p for x in seen) and any(x is A0t for x in seen)
    assert not any(x is b for x in seen) and len(seen) <= 4
    assert not graphs._sees_grad_now(seen)
    with torch.no_grad():
        p.requires_grad_(True)
        assert not graphs._sees_grad_now(seen)
    assert graphs._sees_grad_now(seen)
    assert torch.func.grad(
        lambda x: graphs._sees_grad_now([]) * x.sum())(b).sum() == n
    w = fn(t, b)
    (g,) = torch.autograd.grad(w.sum(), p)
    E = sla.expm(t * 0.7 * A0)
    want = np.sum(t * A0 @ E @ t2n(b))
    assert abs(float(g) - want) <= RTOL_SCIPY * abs(want)
    # the warm-up's result needed no grad: the key may capture later
    assert not fn.program.eager_keys


def _errest_pair(jop, top, b, t, **kw):
    jw, jit = ej.expv(t, jop, jnp.asarray(b), mode="error_estimate",
                      return_info=True, **kw)
    tw, tit = et.expv(t, top, torch.as_tensor(b), mode="error_estimate",
                      return_info=True, **kw)
    assert isinstance(tit, int) and tit == int(jit)
    return tw, jw, tit


@pytest.mark.parametrize("case", ["stencil", "zero b", "breakdown"])
def test_error_estimate_loop_matches_jax(case):
    """The masked-step loop stops at JAX's step with JAX's w: a stencil
    that stops early, beta0 = 0 (no step), and an operator with three
    eigenvalues (breakdown after three steps)."""
    if case == "breakdown":
        d = np.tile([-1.0, -0.25, -2.0], 10)
        jop = ej.DenseOperator(jnp.asarray(np.diag(d)), is_hermitian=True)
        b = np.random.default_rng(64).standard_normal(30)
    else:
        jop = ej.laplacian_nd_stencil(64)
        b = (np.zeros(64) if case == "zero b"
             else np.random.default_rng(65).standard_normal(64))
    top = et.to_torch_operator(jop)
    tw, jw, it = _errest_pair(jop, top, b, 0.5, m=30, atol=1e-12, rtol=1e-12)
    assert it == {"stencil": it, "zero b": 0, "breakdown": 3}[case]
    assert 0 < it < 30 or case == "zero b"
    assert_close(t2n(tw), np.asarray(jw), RTOL, case)
    if case == "zero b":
        assert not tw.abs().max()


def test_error_estimate_complex_b_on_complex_hermitian():
    """A complex b on a complex Hermitian operator: JAX's loop stops at
    the same step (its combination casts the basis to the real type of
    ev, so its w is not the oracle); the port's w meets scipy."""
    rng = np.random.default_rng(35)
    H = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    H = (H + H.conj().T) / 10
    b = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    jop = ej.DenseOperator(jnp.asarray(H), is_hermitian=True)
    top = et.DenseOperator(torch.as_tensor(H), is_hermitian=True)
    tw, _, it = _errest_pair(jop, top, b, 0.8, m=40, atol=1e-14, rtol=1e-14)
    assert tw.dtype == torch.complex128 and it <= 40
    assert_close(t2n(tw), sla.expm(0.8 * H) @ b, RTOL_SCIPY, "vs scipy")


def _tridiagonal(m, seed, tail=0):
    """alphas, betas (m - 1) of a random symmetric tridiagonal whose last
    ``tail`` diagonal and coupling entries are masked to zero."""
    rng = np.random.default_rng(seed)
    a = -np.abs(rng.standard_normal(m)) * 2
    bb = np.abs(rng.standard_normal(max(m - 1, 0)))
    if tail:
        a[m - tail:] = 0.0
        bb[m - tail - 1:] = 0.0
    return a, bb


@pytest.mark.parametrize("m,tail,t", [(1, 0, 0.7), (2, 0, 0.7), (20, 0, 0.7),
                                      (20, 7, 0.7), (12, 0, 0.5 + 0.9j),
                                      (12, 4, 0.5 + 0.9j)])
def test_tridiag_twin_vs_jax_and_scipy(m, tail, t):
    """R1's twin against JAX's eigh formula (``_lanczos_reduced_coeffs``
    with beta0) and scipy's expm of the tridiagonal, with and without s."""
    a, bb = _tridiagonal(m, 66 + m, tail)
    T = np.diag(a) + np.diag(bb, 1) + np.diag(bb, -1)
    e = sla.expm(t * T)[:, 0]
    s = 1.7
    got = tt.tridiag_exp_e1_ref(torch.as_tensor(a), torch.as_tensor(bb), t)
    gots = tt.tridiag_exp_e1_ref(torch.as_tensor(a), torch.as_tensor(bb), t,
                                 torch.tensor(s, dtype=torch.float64))
    jbetas = np.concatenate([bb, [0.0]])
    want_j = jx._lanczos_reduced_coeffs(jnp.asarray(a), jnp.asarray(jbetas),
                                        jnp.asarray(s), t)
    assert got.dtype == (torch.complex128 if isinstance(t, complex)
                         else torch.float64)
    assert_close(t2n(got), e, RTOL_SCIPY, "vs scipy")
    assert_close(t2n(gots), s * e, RTOL_SCIPY, "s vs scipy")
    assert_close(t2n(gots), np.asarray(want_j), RTOL, "s vs JAX")
    if tail:
        assert not got[m - tail:].abs().max()


def test_tridiag_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the wrapper is the twin, and scalar_operand makes t
    a 0-d tensor of the promoted type without changing its value."""
    a, bb = _tridiagonal(9, 70)
    at, bt = torch.as_tensor(a), torch.as_tensor(bb)
    for t in (0.3, 0.3 - 0.2j, torch.tensor(0.3, dtype=torch.float64)):
        tq = tt.scalar_operand(t, at)
        assert tq.dim() == 0 and tq.device == at.device
        assert tq.dtype == (torch.complex128 if isinstance(t, complex)
                            else torch.float64)
        assert complex(tq) == complex(t)
        assert torch.equal(tt.tridiag_exp_e1(at, bt, tq),
                           tt.tridiag_exp_e1_ref(at, bt, tq))
    f32 = tt.scalar_operand(0.3, at.float())
    assert f32.dtype == torch.float32
    # 512 threads in groups of lanes, one group a secular root or row (a
    # power of two up to 32: m groups or more); the divide and conquer's
    # workspace (8 vectors of m doubles, and for each of the ceil(log2 m)
    # tree levels 7 arrays of m doubles and 6 of m int16) in shared memory
    # where it fits, else in a global scratch, whatever the data's type
    # (the work is in double)
    def ws(m, lv):
        return 8 * (8 * m + 7 * lv * m) + 2 * 6 * lv * m

    assert tt.launch_shape(250) == (512, 2, ws(250, 8), True)
    assert tt.launch_shape(40) == (512, 8, ws(40, 6), True)
    assert tt.launch_shape(150) == (512, 2, ws(150, 8), True)
    assert tt.launch_shape(1) == (512, 32, ws(1, 1), True)
    assert tt.launch_shape(30) == (512, 16, ws(30, 5), True)
    assert tt.launch_shape(302) == (512, 1, ws(302, 9), True)
    assert tt.launch_shape(303) == (512, 1, ws(303, 9),
                                                   False)
    assert tt.launch_shape(4266) == (512, 1, ws(4266, 13),
                                                    False)
    with pytest.raises(ValueError, match="int16"):
        tt.launch_shape(40000)


# --- stale operator storage (graphs.Program's record; models/expv.py) ---

def _stale_operator(kind):
    """(torch operator, its dense matrix A): config #3's 2-D Poisson
    stencil at 12 x 10 as a BandedOperator, as a SELL operator, or as a
    float32 BandedOperator that float64 vectors drive (the ``_promoted``
    route)."""
    op = et.poisson_2d(12, 10, device="cpu")
    A = np.asarray(op.to_dense())
    if kind == "sell":
        import scipy.sparse as sp

        op = et.SellOperator.from_scipy(sp.coo_matrix(A), dtype=np.float64,
                                        is_hermitian=True, device="cpu")
    elif kind == "banded f32":
        op = et.poisson_2d(12, 10, dtype=torch.float32, device="cpu")
    op.is_hermitian = True
    return op, A


def _change(op, kind, how):
    """Scale op's storage by 1.5: reassign it (a new tensor) or change it
    in place."""
    if kind == "sell":
        if how == "reassign":
            op.data.vals = op.data.vals * 1.5
        else:
            op.data.vals.mul_(1.5)
    elif how == "reassign":
        op.diags = op.diags * 1.5
    else:
        op.diags.mul_(1.5)


def _jax_twin(kind, A):
    """The JAX package's operator on the same (new) arrays."""
    import scipy.sparse as sp

    if kind == "sell":
        C = sp.coo_matrix(A)
        return ej.SellOperator.from_coo(C.row, C.col, C.data, A.shape[0],
                                        dtype=np.float64, is_hermitian=True)
    return ej.banded_from_scipy(sp.csr_matrix(A), is_hermitian=True)


@pytest.mark.parametrize("how", ["reassign", "in place"])
@pytest.mark.parametrize("kind", ["banded", "sell", "banded f32"])
def test_program_record_goes_stale(kind, how):
    """The bookkeeping of a serving program's stale-storage check on the
    CPU, where every call runs eagerly: after a call (the key's warm-up)
    the key's record holds; reassigning the operator's storage or changing
    it in place makes it stale. The next calls of make_expv and make_phiv
    (eager here) then equal JAX's make_expv / make_phiv on the new arrays
    and scipy on the new matrix."""
    op, A = _stale_operator(kind)
    fe, fp = et.make_expv(op, m=30), et.make_phiv(op, 2, m=30)
    b = np.random.default_rng(63).standard_normal(A.shape[0])
    t = 0.1
    fe(t, b)
    fp(t, b)
    for fn in (fe, fp):
        (key,) = fn.program.records
        assert not fn.program.stale(key)
    _change(op, kind, how)
    A2 = 1.5 * A
    for fn in (fe, fp):
        (key,) = fn.program.records
        assert fn.program.stale(key)
    jop = _jax_twin(kind, A2)
    w = fe(t, b)
    assert_close(t2n(w), np.asarray(ej.make_expv(jop, m=30)(
        t, jnp.asarray(b))), RTOL, f"{kind} {how} vs JAX")
    assert_close(t2n(w), sla.expm(t * A2) @ b, RTOL_SCIPY, "vs scipy")
    wp, _ = fp(t, b)
    jw, _ = ej.make_phiv(jop, 2, m=30)(t, jnp.asarray(b))
    assert_close(t2n(wp), np.asarray(jw), RTOL, f"{kind} {how} phiv vs JAX")
    assert_close(t2n(wp[:, 0]), sla.expm(t * A2) @ b, RTOL_SCIPY,
                 "phiv vs scipy")


def test_program_record_holds_touched_tensors():
    """A tensor that a MatrixFreeOperator's function closes over is in the
    record: changing it in place makes the key stale, and held_tensors
    walks an operator's public storage in a fixed order."""
    ban = et.laplacian_nd_stencil(40, device="cpu")
    p = torch.tensor(0.8, dtype=torch.float64)
    op = et.MatrixFreeOperator(lambda x: p * ban.matvec(x), (40, 40),
                               is_hermitian=True, device="cpu")
    fn = et.make_expv(op, m=20)
    fn(0.2, np.ones(40))
    (key,) = fn.program.records
    assert not fn.program.stale(key)
    p.mul_(2)
    assert fn.program.stale(key)
    sop, _ = _stale_operator("sell")
    d = sop.data
    assert graphs.held_tensors(sop) == [d.vals, d.cols, d.slice_ptr,
                                        d.row_of, d.spans]


@pytest.mark.parametrize("kind", ["banded", "sell"])
def test_promoted_cast_follows_storage(kind):
    """``sparse._promoted`` keeps one cast copy of a float32 operator's
    storage for float64 vectors, and makes it anew when the storage is
    reassigned or changed in place (its version)."""
    from exponentialutilities_jl_torch.ops import sparse as tsp

    op, A = _stale_operator("banded f32")
    attr = "diags"
    if kind == "sell":
        import scipy.sparse as sp

        op = et.SellOperator.from_scipy(sp.coo_matrix(A), dtype=np.float32,
                                        device="cpu")
        attr = "data"

    def values(x):
        return x if kind == "banded" else x.vals

    c1 = tsp._promoted(op, attr, torch.float64)
    assert tsp._promoted(op, attr, torch.float64) is c1
    for how in ("in place", "reassign"):
        _change(op, kind, how)
        c2 = tsp._promoted(op, attr, torch.float64)
        assert c2 is not c1
        assert torch.equal(values(c2), values(getattr(op, attr)).double())
        assert tsp._promoted(op, attr, torch.float64) is c2
        c1 = c2

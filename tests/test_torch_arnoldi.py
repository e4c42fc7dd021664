"""PyTorch port vs JAX package and scipy: the non-Hermitian Krylov path
(ops/krylov.py Arnoldi, its storage-free IOP pair, and the Arnoldi
branches of models/expv.py and models/phiv.py) in float64 and complex128
on CPU, with the same seeded numpy inputs through both packages. Both
sides run plain tensor code here (the JAX package its XLA paths)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_torch.ops.kernels import _build
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)

# Gram-Schmidt amplifies last-ulp differences of its projections a little
# each step; over m <= 40 steps on these small, well-conditioned problems
# the bases and Hessenbergs agree to 1e2 x RTOL64 (checked on CPU against
# the JAX XLA recurrence)
RTOL_BASIS = 1e2 * RTOL64
# the BASELINE accuracy target for float64 against scipy
RTOL_SCIPY = 1e-10


def _config1():
    """BASELINE config #1 (benchmarks/run_baseline.py:72-74): a dense
    100 x 100 matrix and its start vector."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((100, 100)) / 10
    return A, rng.standard_normal(100)


def _case(kind):
    """(jax operator, b): a random non-symmetric dense matrix (real or
    complex), and a block-triangular one with b in a 3-dimensional
    invariant subspace (breakdown after step 3)."""
    rng = np.random.default_rng(11)
    n = 40
    A = rng.standard_normal((n, n)) / 6
    b = rng.standard_normal(n)
    if kind == "complex":
        A = A + 1j * rng.standard_normal((n, n)) / 6
        b = b + 1j * rng.standard_normal(n)
    if kind == "breakdown":
        A[3:, :3] = 0.0
        b[3:] = 0.0
    return ej.DenseOperator(jnp.asarray(A)), b


def _same_basis(Kt, Kj, rtol=RTOL_BASIS):
    assert Kt.hermitian is False and Kj.hermitian is False
    assert_close(t2n(Kt.V), np.asarray(Kj.V), rtol, "V")
    assert_close(t2n(Kt.H), np.asarray(Kj.H), rtol, "H")
    assert float(Kt.beta) == pytest.approx(float(Kj.beta), rel=RTOL64)
    assert int(Kt.m_used) == int(Kj.m_used)
    assert bool(Kt.breakdown) == bool(Kj.breakdown)


@pytest.mark.parametrize("reorth", [True, False])
@pytest.mark.parametrize("iop", [0, 3])
@pytest.mark.parametrize("kind", ["real", "complex", "breakdown"])
def test_arnoldi_vs_jax(kind, iop, reorth):
    jop, b = _case(kind)
    top = et.to_torch_operator(jop)
    m = 12
    Kj = jk.arnoldi(jop, jnp.asarray(b), m, iop=iop, reorth=reorth)
    Kt = et.arnoldi(top, torch.as_tensor(b), m, iop=iop, reorth=reorth)
    _same_basis(Kt, Kj)
    if kind == "breakdown":
        assert int(Kt.m_used) == 3 and bool(Kt.breakdown)
        assert not t2n(Kt.V[4:]).any() and not t2n(Kt.H[:, 3:]).any()
    if iop == 0 and reorth and kind != "breakdown":
        V = t2n(Kt.V)
        np.testing.assert_allclose(V.conj() @ V.T, np.eye(m + 1), atol=1e-12)


def test_arnoldi_zero_start():
    jop, _ = _case("real")
    top = et.to_torch_operator(jop)
    Kt = et.arnoldi(top, torch.zeros(40, dtype=torch.float64), 6)
    assert int(Kt.m_used) == 0 and bool(Kt.breakdown)
    assert not t2n(Kt.V).any() and not t2n(Kt.H).any()


@pytest.mark.parametrize("iop", [0, 3])
def test_arnoldi_extend_vs_jax(iop):
    jop, b = _case("real")
    top = et.to_torch_operator(jop)
    Kj = jk.arnoldi_extend(jop, jk.arnoldi(jop, jnp.asarray(b), 6, iop=iop),
                           10, iop=iop)
    Kt = et.arnoldi_extend(top, et.arnoldi(top, torch.as_tensor(b), 6,
                                           iop=iop), 10, iop=iop)
    _same_basis(Kt, Kj)
    # extending repeats nothing: the same basis as ten steps at once
    _same_basis(Kt, jk.arnoldi(jop, jnp.asarray(b), 10, iop=iop))
    with pytest.raises(ValueError):
        et.arnoldi_extend(top, Kt, 10)
    with pytest.raises(ValueError):
        et.arnoldi_extend(top, et.lanczos(et.laplacian_nd_stencil(40),
                                          torch.as_tensor(b), 4), 6)


@pytest.mark.parametrize("ncols", [0, 3])
@pytest.mark.parametrize("win", [2, 3])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_arnoldi_coeffs_replay_vs_jax(kind, win, ncols):
    jop, b = _case(kind)
    top = et.to_torch_operator(jop)
    m = 10
    Hj, bj, muj, brj = jk.arnoldi_coeffs(jop, jnp.asarray(b), m, win)
    Ht, bt, mut, brt = et.arnoldi_coeffs(top, torch.as_tensor(b), m, win)
    assert_close(t2n(Ht), np.asarray(Hj), RTOL_BASIS, "compact H")
    assert float(bt) == pytest.approx(float(bj), rel=RTOL64)
    assert (int(mut), bool(brt)) == (int(muj), bool(brj))
    assert_close(t2n(et.expand_compact_hessenberg(Ht, win)),
                 np.asarray(jk.expand_compact_hessenberg(Hj, win)),
                 RTOL_BASIS, "expanded H")
    # the compact record is the IOP Arnoldi Hessenberg without reorth
    Kt = et.arnoldi(top, torch.as_tensor(b), m, iop=win, reorth=False)
    assert_close(t2n(et.expand_compact_hessenberg(Ht, win)), t2n(Kt.H),
                 RTOL_BASIS, "vs arnoldi(iop=win)")
    rng = np.random.default_rng(12)
    c = rng.standard_normal((m, ncols) if ncols else (m,)).astype(
        np.asarray(b).dtype)
    final = np.full(ncols, 0.7) if ncols else 0.7
    for with_final in (False, True):
        wj = jk.arnoldi_replay(jop, jnp.asarray(b), jnp.asarray(c), Hj, m,
                               win, final_coeff=final, with_final=with_final)
        wt = et.arnoldi_replay(top, torch.as_tensor(b), torch.as_tensor(c),
                               Ht, m, win, final_coeff=final,
                               with_final=with_final)
        assert_close(t2n(wt), np.asarray(wj), RTOL_BASIS, "replay")
        # the replay regenerates the basis of pass 1
        V = t2n(Kt.V)
        want = (V[:m].T @ c) + (np.multiply.outer(V[m], final) if ncols
                                else final * V[m]) * with_final
        assert_close(t2n(wt), want, RTOL_BASIS, "replay vs basis")


# ---- expv ----------------------------------------------------------------

def test_expv_config1_vs_jax_and_scipy():
    A, b = _config1()
    want = sla.expm(A) @ b
    jw = ej.expv(1.0, jnp.asarray(A), jnp.asarray(b), m=40)
    tw = et.expv(1.0, torch.as_tensor(A), torch.as_tensor(b), m=40)
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "vs JAX")
    assert_close(t2n(tw), want, RTOL_SCIPY, "vs scipy")
    assert_close(t2n(et.expm(torch.as_tensor(A))), sla.expm(A), RTOL_SCIPY,
                 "expm vs scipy")
    # numpy data goes to the default device (the CPU in these tests)
    nw = et.expv(1.0, A, b, m=40)
    assert nw.device.type == "cpu"
    assert_close(t2n(nw), t2n(tw), 0.0, "numpy inputs")


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_expv_complex_t_and_data(kind):
    jop, b = _case(kind)
    top = et.to_torch_operator(jop)
    A = np.asarray(jop.A)
    for t in (0.6, 0.3 + 0.4j):
        want = sla.expm(t * A) @ b
        jw = ej.expv(t, jop, jnp.asarray(b), m=30)
        tw = et.expv(t, top, torch.as_tensor(b), m=30)
        assert tw.is_complex() == np.iscomplexobj(want)
        assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, f"t={t} vs JAX")
        assert_close(t2n(tw), want, RTOL_SCIPY, f"t={t} vs scipy")


def test_expv_breakdown_exact():
    jop, b = _case("breakdown")
    top = et.to_torch_operator(jop)
    want = sla.expm(0.8 * np.asarray(jop.A)) @ b
    tw = et.expv(0.8, top, torch.as_tensor(b), m=12)
    assert_close(t2n(tw), want, RTOL_SCIPY, "breakdown")
    assert not t2n(et.expv(0.8, top, torch.zeros(40, dtype=torch.float64))
                   ).any()


@pytest.mark.parametrize("win", [2, 4])
def test_expv_two_pass_iop(win):
    """The storage-free IOP path is the same recurrence as the basis-kept
    iop=win, reorth=False path, and agrees with the JAX two-pass."""
    op = ej.advection_diffusion_1d(300, peclet=10.0)
    top = et.to_torch_operator(op)
    b = np.random.default_rng(13).standard_normal(300)
    t = 1e-4
    jw = ej.expv(t, op, jnp.asarray(b), m=30, iop=win, two_pass=True)
    tw = et.expv(t, top, torch.as_tensor(b), m=30, iop=win, two_pass=True)
    kw = et.expv(t, top, torch.as_tensor(b), m=30, iop=win, reorth=False)
    assert_close(t2n(tw), t2n(kw), 1e-12, "two-pass vs basis-kept")
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "vs JAX")
    want = sla.expm(t * np.asarray(op.to_dense())) @ b
    assert_close(t2n(tw), want, 1e-8, "IOP vs scipy")


@pytest.mark.parametrize("m", [40, 8])
def test_expv_error_estimate(m):
    """Saad's estimate stops the Lanczos loop at the same step as JAX."""
    jop = ej.laplacian_nd_stencil(400)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(14).standard_normal(400)
    t = 0.5
    jw, jit = ej.expv(t, jop, jnp.asarray(b), m=m, mode="error_estimate",
                      return_info=True)
    tw, tit = et.expv(t, top, torch.as_tensor(b), m=m, mode="error_estimate",
                      return_info=True)
    assert isinstance(tit, int) and tit == int(jit)
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "vs JAX")
    if m == 40:
        # stopped early, by an estimate below atol + rtol |b| with the
        # default rtol = sqrt(tol) = 3.2e-4
        A = np.asarray(jop.to_banded().to_dense())
        assert tit < m
        assert_close(t2n(tw), sla.expm(t * A) @ b, 1e-3, "vs scipy")
    w_only = et.expv(t, top, torch.as_tensor(b), m=m, mode="error_estimate")
    assert_close(t2n(w_only), t2n(tw), 0.0, "without return_info")


@pytest.mark.parametrize("kind", ["dense", "stencil"])
def test_make_expv(kind):
    if kind == "dense":
        A, b = _config1()
        jop, t = ej.DenseOperator(jnp.asarray(A)), 1.0
    else:
        jop, t = ej.laplacian_nd_stencil(5, 6), 0.3
        b = np.random.default_rng(15).standard_normal(30)
    top = et.to_torch_operator(jop)
    jfn = ej.make_expv(jop, m=20)
    tfn = et.make_expv(top, m=20)
    for tt in (t, 0.5 * t):
        assert_close(t2n(tfn(tt, b)), np.asarray(jfn(tt, jnp.asarray(b))),
                     RTOL_BASIS, f"make_expv t={tt}")
        assert_close(t2n(tfn(tt, torch.as_tensor(b))),
                     t2n(et.expv(tt, top, torch.as_tensor(b), m=20)), 0.0,
                     "vs expv")


# ---- phiv on config #4's operator ----------------------------------------

def phi_block_oracle(A, v, k):
    """[phi_0(A)v ... phi_k(A)v] from exp([[A, v e_1^T], [0, J]]) with J
    the k x k shift (the block-matrix oracle of tests/test_phi.py)."""
    n = A.shape[0]
    Big = np.zeros((n + k, n + k), dtype=np.result_type(A, v))
    Big[:n, :n] = A
    Big[:n, n] = v
    Big[n:, n:] = np.diag(np.ones(k - 1), 1)
    E = sla.expm(Big)
    cols = [E[:n, :n] @ v] + [E[:n, n + j] for j in range(k)]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("correct", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_phiv_advection_vs_jax_and_oracle(k, correct):
    # t |A| = 64 here: m = 80 converges (the JAX package on CPU reaches
    # ~1e-14 against the oracle)
    n, t, m = 400, 1e-4, 80
    jop = ej.advection_diffusion_1d(n, peclet=10.0)
    top = et.to_torch_operator(jop)
    assert not top.is_hermitian
    b = np.random.default_rng(16).standard_normal(n)
    jw, je = ej.phiv(t, jop, jnp.asarray(b), k, m=m, correct=correct,
                     errest=True)
    tw, te = et.phiv(t, top, torch.as_tensor(b), k, m=m, correct=correct,
                     errest=True)
    assert_close(t2n(tw), np.asarray(jw), RTOL_BASIS, "vs JAX")
    # the estimate is a product of recurrence values far below |w| here:
    # held relatively, and absolutely at the scale of the roundoff of w
    assert abs(float(te) - float(je)) <= 1e-6 * float(je) + 1e-13
    want = phi_block_oracle(t * np.asarray(jop.to_dense()), b, k)
    # phi_j(tA) b: the oracle's column j is phi_j(tA)(b) for j >= 1 with
    # the t-scaling of the block matrix, phi_0 is exp(tA) b
    assert_close(t2n(tw), want, RTOL_SCIPY, "vs block-matrix oracle")
    # the Arnoldi basis: phiv_from_basis and make_phiv give the same
    Ks = et.build_subspace(top, torch.as_tensor(b), m)
    assert Ks.hermitian is False
    fw, fe = et.phiv_from_basis(t, Ks, k, correct=correct)
    assert_close(t2n(fw), t2n(tw), 0.0, "phiv_from_basis")
    gw, ge = et.make_phiv(top, k, m=m, correct=correct)(t, b)
    assert_close(t2n(gw), t2n(tw), 0.0, "make_phiv")


def test_advection_matvecs_count_on_cpu():
    """A BandedOperator's Arnoldi matvecs on CPU tensors take B7's twin:
    no kernel launch is counted."""
    top = et.advection_diffusion_1d(200)
    _build.reset_launch_counts()
    et.expv(1e-4, top, torch.ones(200, dtype=torch.float64), m=10)
    et.phiv(1e-4, top, torch.ones(200, dtype=torch.float64), 1, m=10)
    assert sum(_build.launches.values()) == 0

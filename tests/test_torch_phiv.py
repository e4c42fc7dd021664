"""PyTorch port vs JAX package: the phi-function actions (models/phiv.py,
the phi part of models/chebyshev.py, ops/kernels/resident
.phiv_two_pass_resident) and the B4 gate, on CPU with the same seeded
numpy inputs through both packages. float64 runs the XLA paths on the JAX
side and the plain torch paths (or the kernels' twins) on the port's;
float32 holds the twins to the JAX Pallas kernels in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import phiv as jpv
from exponentialutilities_jl_tpu.ops.kernels import resident as jr
from exponentialutilities_jl_torch.models import phiv as tpv
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)

K = 3
# the error estimate |beta h t C2[last, k]| is a product of recurrence
# values, each agreeing to a few ulps: hold it relatively
RTOL_ERR = 1e-8


def _problem(name, seed=0):
    """(JAX op, port op, b, t) at a small size."""
    rng = np.random.default_rng(seed)
    if name == "1d":
        jop, t = ej.laplacian_nd_stencil(400), 0.5
    elif name == "poisson":                       # BandedOperator storage
        jop, t = ej.poisson_2d(20, 30), 0.05
    else:                                         # dense symmetric
        A = rng.standard_normal((60, 60))
        jop, t = ej.DenseOperator(jnp.asarray((A + A.T) / 8),
                                  is_hermitian=True), 0.7
    b = rng.standard_normal(jop.shape[0])
    return jop, et.to_torch_operator(jop), b, t


def _phi_identity_err(op, w, b, t):
    """max_j |t A phi_{j+1} b - (phi_j b - b/j!)| / |phi_j b| over j < k."""
    fact, errs = 1.0, []
    for j in range(w.shape[1] - 1):
        if j:
            fact *= j
        lhs = t * op.matvec(w[:, j + 1])
        rhs = w[:, j] - b / fact
        errs.append(float((lhs - rhs).norm() / w[:, j].norm()))
    return max(errs)


@pytest.mark.parametrize("correct", [False, True])
@pytest.mark.parametrize("name", ["1d", "poisson", "dense"])
def test_phiv_vs_jax(name, correct):
    jop, top, b, t = _problem(name)
    m = 10                                        # a visible error estimate
    jw, je = ej.phiv(t, jop, jnp.asarray(b), K, m=m, correct=correct,
                     errest=True)
    tw, te = et.phiv(t, top, torch.as_tensor(b), K, m=m, correct=correct,
                     errest=True)
    assert tw.shape == (b.shape[0], K + 1)
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "w vs JAX")
    assert float(te) == pytest.approx(float(je), rel=RTOL_ERR)
    assert float(te) > 0


@pytest.mark.parametrize("name", ["1d", "poisson"])
def test_phiv_converged_identities_and_scipy(name):
    jop, top, b, t = _problem(name, seed=1)
    tw = et.phiv(t, top, torch.as_tensor(b), K, m=30)
    A = np.asarray(jop.to_dense() if hasattr(jop, "to_dense")
                   else jop.to_banded().to_dense())
    assert_close(t2n(tw[:, 0]), spla.expm_multiply(t * A, b), 1e-10,
                 "phi_0 vs scipy")
    assert _phi_identity_err(top, tw, torch.as_tensor(b), t) < 1e-12


@pytest.mark.parametrize("name", ["1d", "poisson"])
def test_phiv_two_pass_vs_jax(name):
    jop, top, b, t = _problem(name, seed=2)
    m = 12
    jw, je = jpv._phiv_two_pass(jop, jnp.asarray(b), jnp.asarray(t), m, K)
    tw, te = tpv._phiv_two_pass(top, torch.as_tensor(b), t, m, K)
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "w vs JAX")
    assert float(te) == pytest.approx(float(je), rel=RTOL_ERR)
    # on CPU the public two_pass takes the plain passes
    pw, pe = et.phiv(t, top, torch.as_tensor(b), K, m=m, two_pass=True,
                     errest=True)
    assert torch.equal(pw, tw) and torch.equal(pe, te)


def test_phiv_two_pass_resident_f32_vs_interpret():
    n, m, k, t = 300, 8, 2, 0.3
    jop = ej.StencilOperator((n,), ((-1,), (0,), (1,)),
                             jnp.asarray([1.0, -2.0, 1.0], jnp.float32),
                             is_hermitian=True)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    jw, je = jr.phiv_two_pass_resident(jop, jnp.asarray(b), t, m, k,
                                       interpret=True)
    tw, te = tr.phiv_two_pass_resident(top, torch.as_tensor(b), t, m, k)
    assert tw.dtype == torch.float32
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "w")
    assert float(te) == pytest.approx(float(je), rel=1e-4)


@pytest.mark.parametrize("start", ["random", "zero"])
def test_phiv_two_pass_resident_f64(start):
    """float64 twins vs the JAX XLA two-pass phiv (the JAX resident
    kernels are float32-only)."""
    jop, top, b, t = _problem("1d", seed=4)
    if start == "zero":
        b = np.zeros_like(b)
    m = 12
    jw, je = jpv._phiv_two_pass(jop, jnp.asarray(b), jnp.asarray(t), m, K)
    tw, te = tr.phiv_two_pass_resident(top, torch.as_tensor(b), t, m, K)
    if start == "zero":
        assert not t2n(tw).any() and float(te) == 0.0
        return
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "w vs JAX")
    assert float(te) == pytest.approx(float(je), rel=RTOL_ERR)


def test_phiv_from_basis_and_make_phiv():
    jop, top, b, t = _problem("1d", seed=5)
    Ks = et.build_subspace(top, torch.as_tensor(b), 10)
    w1, e1 = et.phiv_from_basis(t, Ks, K, correct=True)
    w2, e2 = et.make_phiv(top, K, m=10, correct=True)(t, torch.as_tensor(b))
    jw, je = ej.phiv(t, jop, jnp.asarray(b), K, m=10, correct=True,
                     errest=True)
    for w, e in ((w1, e1), (w2, e2)):
        assert_close(t2n(w), np.asarray(jw), 1e2 * RTOL64, "w vs JAX")
        assert float(e) == pytest.approx(float(je), rel=RTOL_ERR)


def test_phiv_zero_start_and_rejects():
    _, top, b, t = _problem("1d")
    z = torch.zeros(len(b), dtype=torch.float64)
    for two_pass in (False, True):
        w, e = et.phiv(t, top, z, K, two_pass=two_pass, errest=True)
        assert not t2n(w).any() and float(e) == 0.0
    bt = torch.as_tensor(b)
    nonherm = et.StencilOperator((len(b),), [(0,), (1,)], np.asarray([1.0, 0.5]))
    with pytest.raises(NotImplementedError, match="Hermitian"):
        et.phiv(t, nonherm, bt, K, two_pass=True)
    # reduced="host" is ported (ops/host_reduced.py): the device form's
    # result; refused with differentiable=True
    assert_close(t2n(et.phiv(t, top, bt, K, reduced="host")),
                 t2n(et.phiv(t, top, bt, K)), RTOL64, "reduced=host")
    with pytest.raises(ValueError, match="differentiable"):
        et.phiv(t, top, bt, K, reduced="host", differentiable=True)
    # differentiable=True is ported: the reduced exponential's form with
    # no host read, the same result
    assert_close(t2n(et.phiv(t, top, bt, K, differentiable=True)),
                 t2n(et.phiv(t, top, bt, K)), RTOL64, "differentiable")
    # CPU data never reaches a kernel: demanding one is a ValueError
    with pytest.raises(ValueError):
        et.phiv_chebyshev(t, top, bt, K, fused=True)


@pytest.mark.parametrize("name", ["1d", "poisson"])
def test_phiv_chebyshev_vs_jax(name):
    jop, top, b, t = _problem(name, seed=6)
    jw = ej.phiv_chebyshev(t, jop, jnp.asarray(b), K, tol=1e-12)
    tw = et.phiv_chebyshev(t, top, torch.as_tensor(b), K, tol=1e-12)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "vs JAX")
    kw = et.phiv(t, top, torch.as_tensor(b), K, m=30)
    assert_close(t2n(tw), t2n(kw), 1e-10, "vs Krylov phiv")


@pytest.mark.parametrize("f", ["cos", "stack"])
def test_funm_chebyshev_vs_jax(f):
    jop, top, b, _ = _problem("1d", seed=7)
    fn = np.cos if f == "cos" else (lambda x: np.stack([np.cos(x),
                                                         np.exp(0.3 * x)]))
    jw = ej.funm_chebyshev(fn, jop, jnp.asarray(b), tol=1e-12)
    tw = et.funm_chebyshev(fn, top, torch.as_tensor(b), tol=1e-12)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "vs JAX")


@pytest.mark.parametrize("ts", [0.4, [0.1, 0.25, 0.4]])
def test_phiv_timestep_chebyshev_vs_jax(ts):
    jop, top, _, _ = _problem("1d", seed=8)
    B = np.random.default_rng(8).standard_normal((jop.shape[0], 3))
    jw = ej.phiv_timestep_chebyshev(ts, jop, jnp.asarray(B), tol=1e-12)
    tw = et.phiv_timestep_chebyshev(ts, top, torch.as_tensor(B), tol=1e-12)
    assert tw.shape == np.asarray(jw).shape
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "vs JAX")


def test_resident_multi_ok_gate():
    """B4's gate, decided from types and sizes alone (no card needed):
    CUDA float32/float64 only, p <= 8, (p + 3) vectors within the L2
    budget, 1-D stencils only."""
    op = et.laplacian_nd_stencil(100_000)
    f64, f32 = torch.float64, torch.float32
    assert td.resident_multi_ok(op, f64, "cuda", 4)
    assert not td.resident_multi_ok(op, f64, "cpu", 4)
    assert not td.resident_multi_ok(op, torch.complex128, "cuda", 4)
    assert not td.resident_multi_ok(op, f64, "cuda", 9)
    assert not td.resident_multi_ok(op, f64, "cuda", 0)
    big = et.laplacian_nd_stencil(800_000)         # 7 x 6.4 MB > 40 MiB
    assert not td.resident_multi_ok(big, f64, "cuda", 4)
    assert td.resident_multi_ok(big, f32, "cuda", 4)
    assert not td.resident_multi_ok(et.laplacian_1d(1000), f64, "cuda", 2)
    assert not td.resident_multi_ok(et.laplacian_nd_stencil(30, 30), f64,
                                    "cuda", 2)


# Queue C repairs (scipy oracles): a real DenseOperator takes a complex b,
# and a real b of a complex Hermitian DenseOperator is promoted
@pytest.mark.parametrize("kind", ["real A, complex b", "complex A, real b"])
def test_phiv_dense_mixed_types(kind):
    import scipy.linalg as sla

    rng = np.random.default_rng(9)
    A = rng.standard_normal((40, 40)) / 5
    b = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    herm = None
    if kind == "complex A, real b":
        A = A + 1j * rng.standard_normal((40, 40)) / 5
        A, b, herm = (A + A.conj().T) / 2, b.real.copy(), True
    op = et.DenseOperator(torch.as_tensor(A), is_hermitian=herm)
    tw = et.phiv(0.8, op, torch.as_tensor(b), K, m=40)
    assert tw.is_complex()
    assert_close(t2n(tw[:, 0]), sla.expm(0.8 * A) @ b, 1e-10,
                 "phi_0 vs scipy")
    assert _phi_identity_err(op, tw, torch.as_tensor(b).to(tw.dtype),
                             0.8) < 1e-10


# reduced="host" (ops/host_reduced.py): the reduced augmented exponential
# on host scipy, against JAX's reduced="host"

@pytest.mark.parametrize("form", ["basis", "two_pass", "from_basis",
                                  "arnoldi"])
def test_phiv_reduced_host_vs_jax(form):
    jop, top, b, t = _problem("dense", seed=3)
    if form == "arnoldi":
        A = np.random.default_rng(4).standard_normal((60, 60)) / 8
        jop = ej.DenseOperator(jnp.asarray(A), is_hermitian=False)
        top = et.to_torch_operator(jop)
    kw = dict(two_pass=True) if form == "two_pass" else {}
    if form == "from_basis":
        Kt = tpv.build_subspace(top, torch.as_tensor(b), 30)
        Kj = jpv.build_subspace(jop, jnp.asarray(b), 30)
        tw, te = et.phiv_from_basis(t, Kt, K, reduced="host")
        jw, je = ej.phiv_from_basis(t, Kj, K, reduced="host")
    else:
        tw, te = et.phiv(t, top, torch.as_tensor(b), K, m=30, errest=True,
                         reduced="host", **kw)
        jw, je = ej.phiv(t, jop, jnp.asarray(b), K, m=30, errest=True,
                         reduced="host", **kw)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, form)
    np.testing.assert_allclose(float(te), float(je), rtol=RTOL_ERR)
    dw = et.phiv(t, top, torch.as_tensor(b), K, m=30, **kw) \
        if form != "from_basis" else et.phiv_from_basis(t, Kt, K)[0]
    assert_close(t2n(tw), t2n(dw), RTOL64, f"{form} vs device")
    with pytest.raises(ValueError, match="differentiable"):
        et.phiv(t, top, torch.as_tensor(b), K, reduced="host",
                differentiable=True)


def test_host_reduced_helpers_vs_jax():
    from exponentialutilities_jl_tpu.ops import host_reduced as jh
    from exponentialutilities_jl_torch.ops import host_reduced as th

    rng = np.random.default_rng(9)
    H = rng.standard_normal((12, 12)) / 3
    A = rng.standard_normal((10, 10)) / 2
    Ht = torch.as_tensor(H)
    assert th.reduced_default() == jh.reduced_default() == "device"
    for t in (0.7, 0.3 + 0.2j):
        e1 = th.host_expm_e1(Ht, t)
        assert e1.dtype == (torch.float64 if isinstance(t, float)
                            else torch.complex128)
        assert_close(t2n(e1), np.asarray(jh.host_expm_e1(H, t)), 1e-14,
                     f"expm_e1 t={t}")
        for k in (0, 2):
            assert_close(t2n(th.host_phiv_e1(Ht, t, k)),
                         np.asarray(jh.host_phiv_e1(H, t, k)), 1e-14,
                         f"phiv_e1 k={k} t={t}")
    assert_close(t2n(th.host_expm(Ht)), np.asarray(jh.host_expm(H)), 1e-14,
                 "expm")
    P = th.host_phi(torch.as_tensor(A), 3)
    assert tuple(P.shape) == (4, 10, 10) and P.dtype == torch.float64
    assert_close(t2n(P), np.asarray(jh.host_phi(A, 3)), 1e-14, "phi")

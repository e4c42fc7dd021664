"""PyTorch port vs JAX package and scipy: the Hermitian stencil exp(tA)b
slice as a whole (models/chebyshev.py, models/expv.py, the dispatch
gates), float64 on CPU. JAX on CPU takes its XLA paths, and so does the
port (its kernels need a CUDA device)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse.linalg as spla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import chebyshev as jc
from exponentialutilities_jl_torch.models import chebyshev as tc
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)

# the BASELINE accuracy target for float64 against scipy's expm_multiply
RTOL_SCIPY = 1e-10

CASES = {"1d": ((400,), 0.5), "3d": ((6, 7, 5), 0.05)}


def _problem(name, seed=0):
    shape, t = CASES[name]
    jop = ej.laplacian_nd_stencil(*shape)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(seed).standard_normal(jop.shape[0])
    A = np.asarray(jop.to_banded().to_dense())
    return jop, top, b, t, spla.expm_multiply(t * A, b)


@pytest.mark.parametrize("name", list(CASES))
def test_expv_chebyshev(name):
    jop, top, b, t, want = _problem(name)
    jw = ej.expv_chebyshev(t, jop, jnp.asarray(b), tol=1e-12)
    tw = et.expv_chebyshev(t, top, torch.as_tensor(b), tol=1e-12)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "vs JAX")
    assert_close(t2n(tw), want, RTOL_SCIPY, "vs scipy")


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_expv(name, two_pass):
    jop, top, b, t, want = _problem(name, seed=1)
    m = 30 if name == "1d" else 20
    jw = ej.expv(t, jop, jnp.asarray(b), m=m, two_pass=two_pass)
    tw = et.expv(t, top, torch.as_tensor(b), m=m, two_pass=two_pass)
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "vs JAX")
    assert_close(t2n(tw), want, RTOL_SCIPY, "vs scipy")


@pytest.mark.parametrize("entry", ["chebyshev", "two_pass"])
def test_complex_t(entry):
    jop, top, b, _, _ = _problem("1d", seed=2)
    t = 0.3 + 0.4j
    if entry == "chebyshev":
        jw = ej.expv_chebyshev(t, jop, jnp.asarray(b), tol=1e-12)
        tw = et.expv_chebyshev(t, top, torch.as_tensor(b), tol=1e-12)
    else:
        jw = ej.expv(t, jop, jnp.asarray(b), m=30, two_pass=True)
        tw = et.expv(t, top, torch.as_tensor(b), m=30, two_pass=True)
    assert tw.is_complex()
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "complex t")


def test_expv_zero_and_breakdown():
    jop, top, _, t, _ = _problem("1d")
    zero = np.zeros(jop.shape[0])
    for two_pass in (False, True):
        tw = et.expv(t, top, torch.as_tensor(zero), two_pass=two_pass)
        assert not t2n(tw).any()
    # b in the span of two grid eigenvectors: breakdown after two steps
    n = jop.shape[0]
    i = np.arange(1, n + 1)
    b = np.sin(3 * np.pi * i / (n + 1)) + np.sin(40 * np.pi * i / (n + 1))
    A = np.asarray(jop.to_banded().to_dense())
    want = spla.expm_multiply(t * A, b)
    for two_pass in (False, True):
        tw = et.expv(t, top, torch.as_tensor(b), m=10, two_pass=two_pass)
        assert_close(t2n(tw), want, RTOL_SCIPY, f"breakdown {two_pass}")


def test_spectral_bounds_with_probe():
    jop, top, b, _, _ = _problem("3d")
    jb = jc.spectral_bounds(jop, probe=jnp.asarray(b), k=12)
    tb = tc.spectral_bounds(top, probe=torch.as_tensor(b), k=12)
    assert tb == pytest.approx(jb, rel=1e-10)
    lo, hi = tc.spectral_bounds(top, k=12)        # torch.Generator probes
    ev = np.linalg.eigvalsh(np.asarray(jop.to_banded().to_dense()))
    assert lo <= ev[0] + 1e-8 and hi >= ev[-1] - 1e-8


def test_expv_chebyshev_estimated_bounds():
    """Dense operator without a hint: bounds from spectral_bounds."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    A = Q @ np.diag(np.linspace(-5.0, -0.1, 40)) @ Q.T
    b = rng.standard_normal(40)
    tw = et.expv_chebyshev(0.7, torch.as_tensor(A), torch.as_tensor(b),
                           tol=1e-12)
    want = spla.expm_multiply(0.7 * A, b)
    assert_close(t2n(tw), want, RTOL_SCIPY, "estimated bounds")


def test_exp_coefficients_match():
    for z, tol in ((1.0, 1e-12), (30.0, 1e-7), (2.0 + 1.0j, 1e-10)):
        jcf, js = jc._exp_ucoeffs(z, tol)
        tcf, ts = tc._exp_ucoeffs(z, tol)
        assert js == ts
        np.testing.assert_array_equal(tcf, jcf)
    jf = jc._full_exp_coeffs(0.5, -4.0, 0.0, 1e-12, None)
    tf = tc._full_exp_coeffs(0.5, -4.0, 0.0, 1e-12, None)
    np.testing.assert_array_equal(tf[0], jf[0])
    assert tf[1:] == jf[1:]


def test_gates_on_cpu_take_plain_path():
    """CPU tensors never reach a kernel; fused=True on CPU is a
    ValueError (the documented contract; the JAX gate at
    ops/kernels/dispatch.py:54 skips this check)."""
    top = et.laplacian_nd_stencil(64)
    top3 = et.laplacian_nd_stencil(4, 5, 6)
    for op in (top, top3):
        assert td.recurrence_engine(op, torch.float64, device="cpu") is None
        with pytest.raises(ValueError):
            td.recurrence_engine(op, torch.float64, fused=True, device="cpu")
        assert td.recurrence_engine(op, torch.float64, fused=False,
                                    device="cuda") is None
    from exponentialutilities_jl_torch.ops.kernels import (lanczos_fused,
                                                           resident)
    assert (td.recurrence_engine(top, torch.float32, device="cuda")
            is resident.recurrence_apply_resident)
    # a grid this small takes the one-launch B6, a banded matrix B5, a
    # grid past the L2 budget the B3 sweeps
    assert (td.recurrence_engine(top3, torch.float64, device="cuda")
            is resident.recurrence_apply_resident_grid)
    assert (td.recurrence_engine(et.laplacian_1d(64), torch.float64,
                                 fused=True, device="cuda")
            is resident.recurrence_apply_resident_banded)
    assert (td.recurrence_engine(et.laplacian_nd_stencil(216, 216, 216),
                                 torch.float64, device="cuda")
            is lanczos_fused.recurrence_apply_fused)
    assert td.recurrence_engine(top3, torch.complex128, device="cuda") is None
    with pytest.raises(ValueError):
        td.recurrence_engine(top3, torch.complex128, fused=True,
                             device="cuda")
    with pytest.raises(ValueError):
        td.recurrence_engine(et.DiagonalOperator(torch.ones(64)),
                             torch.float64, fused=True, device="cuda")
    _build.reset_launch_counts()
    b = torch.ones(64, dtype=torch.float64)
    et.expv_chebyshev(0.5, top, b)
    et.expv(0.5, top, b, two_pass=True)
    with pytest.raises(ValueError):
        et.expv_chebyshev(0.5, top, b, fused=True)
    assert sum(_build.launches.values()) == 0


def test_not_ported_paths_raise():
    top = et.laplacian_nd_stencil(16)
    b = torch.ones(16, dtype=torch.float64)
    nonherm = et.StencilOperator((16,), [(0,), (1,)], np.asarray([-1.0, 0.5]))
    # non-Hermitian two-pass needs an IOP window; error_estimate is
    # Lanczos-only, as in the JAX package
    with pytest.raises(ValueError, match="iop"):
        et.expv(0.5, nonherm, b, two_pass=True)
    with pytest.raises(NotImplementedError, match="Hermitian"):
        et.expv(0.5, nonherm, b, mode="error_estimate")
    # differentiable=True is ported (the reduced exponential's form with
    # no host read): the same result
    assert_close(t2n(et.expv(0.5, nonherm, b, differentiable=True)),
                 t2n(et.expv(0.5, nonherm, b)), RTOL64, "differentiable")
    # reduced="host" is ported (ops/host_reduced.py): JAX's result, and
    # the refusals the JAX package documents
    jtop = ej.laplacian_nd_stencil(16)
    assert_close(t2n(et.expv(0.5, top, b, reduced="host")),
                 np.asarray(ej.expv(0.5, jtop, jnp.ones(16), reduced="host")),
                 RTOL64, "reduced=host")
    with pytest.raises(ValueError, match="differentiable"):
        et.expv(0.5, top, b, reduced="host", differentiable=True)
    with pytest.raises(ValueError, match="error_estimate"):
        et.expv(0.5, top, b, reduced="host", mode="error_estimate")
    with pytest.raises(ValueError, match="reduced"):
        et.expv(0.5, top, b, reduced="cpu")
    with pytest.raises(ValueError):
        et.expv(0.5, top, b, mode="nope")
    with pytest.raises(ValueError):
        et.expv_chebyshev(0.5, nonherm, b)


def test_full_precision_restores_settings():
    from exponentialutilities_jl_torch.utils.precision import full_precision

    seen = {}

    @full_precision
    def probe():
        seen["prec"] = torch.get_float32_matmul_precision()
        seen["tf32"] = torch.backends.cuda.matmul.allow_tf32

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        probe()
        assert seen == {"prec": "highest", "tf32": False}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


# Queue C repairs: a complex b keeps its imaginary part on a real
# Hermitian operator (the JAX package casts it away, so scipy is the
# oracle); a real DenseOperator takes a complex b; a real b of a complex
# Hermitian DenseOperator is promoted to the operator's type
def _complex_b(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("kind", ["happy_breakdown", "breakdown",
                                  "two_pass", "error_estimate"])
def test_complex_b_on_real_hermitian(kind):
    jop, top, _, _, _ = _problem("1d")
    n, t = jop.shape[0], 0.3
    A = np.asarray(jop.to_banded().to_dense())
    b = _complex_b(n, 4)
    kw = {"happy_breakdown": dict(m=30), "two_pass": dict(m=30,
                                                         two_pass=True),
          "error_estimate": dict(m=60, mode="error_estimate", atol=1e-14,
                                 rtol=1e-14)}.get(kind)
    if kind == "breakdown":
        # b in the span of two grid eigenvectors: breakdown after two steps
        i = np.arange(1, n + 1)
        b = (np.sin(3 * np.pi * i / (n + 1))
             + 1j * np.sin(40 * np.pi * i / (n + 1)))
        kw = dict(m=10)
    tw = et.expv(t, top, torch.as_tensor(b), **kw)
    assert tw.dtype == torch.complex128
    assert_close(t2n(tw), spla.expm_multiply(t * A, b), RTOL_SCIPY, kind)


@pytest.mark.parametrize("kw", [dict(m=50), dict(m=50, iop=4),
                                dict(m=50, iop=4, two_pass=True)],
                         ids=["full", "iop", "two_pass"])
def test_complex_b_on_real_dense(kw):
    import scipy.linalg as sla

    rng = np.random.default_rng(5)
    M = rng.standard_normal((50, 50)) / 5
    b = _complex_b(50, 6)
    tw = et.expv(1.0, et.DenseOperator(torch.as_tensor(M)),
                 torch.as_tensor(b), **kw)
    assert_close(t2n(tw), sla.expm(M) @ b, RTOL_SCIPY, "real dense")


@pytest.mark.parametrize("two_pass", [False, True])
def test_real_b_on_complex_hermitian_dense(two_pass):
    import scipy.linalg as sla

    rng = np.random.default_rng(7)
    H = rng.standard_normal((50, 50)) + 1j * rng.standard_normal((50, 50))
    H = (H + H.conj().T) / 10
    b = rng.standard_normal(50)
    tw = et.expv(1.0, et.DenseOperator(torch.as_tensor(H), is_hermitian=True),
                 b, m=50, two_pass=two_pass)
    assert tw.dtype == torch.complex128
    assert_close(t2n(tw), sla.expm(H) @ b, RTOL_SCIPY, "complex Hermitian")


# reduced="host": the m-sized reduced problem on host scipy
# (ops/host_reduced.py), against the JAX package's reduced="host" on every
# path that has one, and against the port's device form

HOST_PATHS = {"lanczos": dict(m=30), "arnoldi": dict(m=40, hermitian=False),
              "two_pass": dict(m=30, two_pass=True),
              "iop_two_pass": dict(m=40, iop=3, two_pass=True,
                                   hermitian=False)}


@pytest.mark.parametrize("path", list(HOST_PATHS))
def test_reduced_host_vs_jax(path):
    rng = np.random.default_rng(31)
    n = 60
    A = rng.standard_normal((n, n)) / 8
    if path in ("lanczos", "two_pass"):
        A = (A + A.T) / 2
    b = rng.standard_normal(n)
    kw = HOST_PATHS[path]
    jw = ej.expv(0.7, jnp.asarray(A), jnp.asarray(b), reduced="host", **kw)
    th = et.expv(0.7, torch.as_tensor(A), torch.as_tensor(b), reduced="host",
                 **kw)
    td_ = et.expv(0.7, torch.as_tensor(A), torch.as_tensor(b), **kw)
    assert th.dtype == torch.float64
    assert_close(t2n(th), np.asarray(jw), RTOL64, "vs JAX reduced=host")
    assert_close(t2n(th), t2n(td_), RTOL64, "vs reduced=device")


def test_expv_from_basis_reduced_host_vs_jax():
    from exponentialutilities_jl_tpu.models.expv import \
        build_subspace as jbuild
    from exponentialutilities_jl_torch.models.expv import build_subspace

    rng = np.random.default_rng(32)
    A = rng.standard_normal((50, 50)) / 6
    b = rng.standard_normal(50)
    Kt = build_subspace(et.DenseOperator(torch.as_tensor(A)),
                        torch.as_tensor(b), 30)
    Kj = jbuild(ej.DenseOperator(jnp.asarray(A)), jnp.asarray(b), 30)
    for t in (0.9, 0.4 - 0.3j):
        w = et.expv_from_basis(t, Kt, reduced="host")
        assert_close(t2n(w), np.asarray(ej.expv_from_basis(
            t, Kj, reduced="host")), RTOL64, f"t={t}")
        assert_close(t2n(w), t2n(et.expv_from_basis(t, Kt)), RTOL64,
                     f"t={t} vs device")


# A DiagonalOperator is Hermitian exactly when its d is real, unless
# the caller says otherwise; a complex d runs Arnoldi (scipy is the oracle:
# the JAX package's default flag is True for a complex d)

def _complex_d(n=40, seed=33):
    rng = np.random.default_rng(seed)
    return -rng.uniform(0, 4, n) + 1j * rng.uniform(-3, 3, n), \
        rng.standard_normal(n)


@pytest.mark.parametrize("entry", ["expv", "phiv", "expv_batched", "kiops"])
def test_complex_diagonal_operator(entry):
    d, b = _complex_d()
    op = et.DiagonalOperator(torch.as_tensor(d))
    assert op.is_hermitian is False
    t = 0.5
    if entry == "expv":
        got = et.expv(t, op, b, m=30)
        want = np.exp(t * d) * b
    elif entry == "phiv":
        got = et.phiv(t, op, b, 1, m=30)[:, 1]
        z = t * d
        want = (np.exp(z) - 1) / z * b
    elif entry == "expv_batched":
        got = et.expv_batched(t, op, np.stack([b, 2 * b]), m=30)[1]
        want = 2 * np.exp(t * d) * b
    else:
        got = et.kiops([t], op, b[:, None], tol=1e-12)[0].reshape(-1)
        want = np.exp(t * d) * b
    assert_close(t2n(got), want, 1e-13 if entry != "kiops" else 1e-10,
                 entry)


def test_diagonal_operator_flag_and_convert():
    from exponentialutilities_jl_torch.utils.convert import (
        from_operator_data, operator_data)

    d, b = _complex_d()
    dr = d.real.copy()
    assert et.DiagonalOperator(torch.as_tensor(dr)).is_hermitian is True
    assert et.DiagonalOperator(dr, is_hermitian=False).is_hermitian is False
    herm = et.DiagonalOperator(dr + 0j, is_hermitian=True)
    assert herm.is_hermitian is True
    # an explicit flag is honoured: the real-valued complex diagonal runs
    # Lanczos, a real one Arnoldi, both exact
    assert_close(t2n(et.expv(0.5, herm, b, m=30)), np.exp(0.5 * dr) * b,
                 1e-13, "explicit True")
    assert_close(t2n(et.expv(0.5, et.DiagonalOperator(dr, is_hermitian=False),
                             b, m=30)), np.exp(0.5 * dr) * b, 1e-13,
                 "explicit False")
    # JAX's flag is True even for a complex d: the carried operator is
    # Hermitian only when d is real, and gives the exact action
    jc = ej.DiagonalOperator(jnp.asarray(d))
    assert jc.is_hermitian is True
    tc_ = et.to_torch_operator(jc, device="cpu")
    assert tc_.is_hermitian is False
    assert_close(t2n(et.expv(0.5, tc_, b, m=30)), np.exp(0.5 * d) * b, 1e-13,
                 "carried complex")
    assert et.to_torch_operator(ej.DiagonalOperator(jnp.asarray(dr)),
                                device="cpu").is_hermitian is True
    assert et.to_torch_operator(ej.DiagonalOperator(
        jnp.asarray(dr), is_hermitian=False), device="cpu").is_hermitian \
        is False
    # the port's own round trip keeps the flag
    for op in (et.DiagonalOperator(dr), et.DiagonalOperator(d),
               et.DiagonalOperator(dr, is_hermitian=False)):
        back = from_operator_data(operator_data(op), device="cpu")
        assert back.is_hermitian is op.is_hermitian
        assert torch.equal(back.d, op.d)


# The JAX signatures' keywords

def test_make_expv_bake_operator():
    top = et.laplacian_nd_stencil(64)
    b = torch.as_tensor(np.random.default_rng(34).standard_normal(64))
    w = et.make_expv(top, m=30)(0.5, b)
    assert torch.equal(et.make_expv(top, m=30, bake_operator=True)(0.5, b), w)
    assert torch.equal(et.make_expv(top, m=30, bake_operator=False)(0.5, b),
                       w)
    jw = ej.make_expv(ej.laplacian_nd_stencil(64), m=30,
                      bake_operator=True)(0.5, jnp.asarray(t2n(b)))
    assert_close(t2n(w), np.asarray(jw), RTOL64, "vs JAX baked")


# complex paths where the port meets scipy and the JAX package does not:
# pinned with scipy as the oracle

def _complex_hermitian(n=40, seed=35):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (H + H.conj().T) / 10


def test_error_estimate_complex_b_on_complex_hermitian():
    import scipy.linalg as sla

    H = _complex_hermitian()
    b = _complex_b(40, 36)
    op = et.DenseOperator(torch.as_tensor(H), is_hermitian=True)
    w, it = et.expv(0.8, op, b, m=40, mode="error_estimate", atol=1e-14,
                    rtol=1e-14, return_info=True)
    assert w.dtype == torch.complex128 and it <= 40
    assert_close(t2n(w), sla.expm(0.8 * H) @ b, RTOL_SCIPY, "error estimate")


@pytest.mark.parametrize("driver", ["error_estimate", "phiv", "phiv_two_pass",
                                    "expv_timestep", "kiops"])
def test_real_b_on_complex_hermitian(driver):
    import scipy.linalg as sla

    H = _complex_hermitian()
    b = np.random.default_rng(37).standard_normal(40)
    op = et.DenseOperator(torch.as_tensor(H), is_hermitian=True)
    E = sla.expm(0.8 * H)
    if driver == "error_estimate":
        got = et.expv(0.8, op, b, m=40, mode="error_estimate", atol=1e-14,
                      rtol=1e-14)
        want, tol = E @ b, RTOL_SCIPY
    elif driver.startswith("phiv"):
        got = et.phiv(0.8, op, b, 1, m=40,
                      two_pass=driver.endswith("two_pass"))[:, 0]
        want, tol = E @ b, RTOL_SCIPY
    elif driver == "expv_timestep":
        got = et.expv_timestep(0.8, op, b, adaptive=True, tol=1e-10)
        want, tol = E @ b, 1e-7
    else:
        got = et.kiops([0.8], op, b[:, None], tol=1e-10)[0].reshape(-1)
        want, tol = E @ b, 1e-7
    assert got.dtype == torch.complex128
    assert_close(t2n(got), want, tol, driver)

"""PyTorch port vs JAX package: the Faber-series actions on the
field-of-values ellipse (models/faber.py), float64 on CPU with the same
seeded numpy inputs through both packages.

Single actions and the NW driver are held to JAX's results at 1e-12
relative (max-norm), with the ellipse, the degree and the substep count q
equal; the engine rows (the Faber rows of the CUDA recurrence kernels,
cc_0 = 0 and cc_1 = -2 rho) are held to the plain loop through the
kernels' CPU twins, and the failure protocol raises in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import faber as jfb
from exponentialutilities_jl_torch.models import faber as tfb
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)


def _ops(kind):
    """(jax operator, port operator) of one operator class."""
    if kind == "stencil":
        cs = [1e3 + 2e2, -2e3 - 2e2, 1e3]       # bench_leja.py, 1-D
        return (ej.StencilOperator((200,), ((-1,), (0,), (1,)),
                                   jnp.asarray(cs), is_hermitian=False),
                et.StencilOperator((200,), ((-1,), (0,), (1,)),
                                   np.asarray(cs), is_hermitian=False))
    if kind == "banded":
        return ej.advection_diffusion_1d(150, peclet=10.0), \
            et.advection_diffusion_1d(150, peclet=10.0)
    if kind == "dense":
        M = np.random.default_rng(3).standard_normal((40, 40)) / 5
        M -= 2 * np.eye(40)
        return jnp.asarray(M), torch.as_tensor(M)
    if kind == "3d":
        return ej.advection_diffusion_3d_stencil(5, 6, 7, peclet=5.0), \
            et.advection_diffusion_3d_stencil(5, 6, 7, peclet=5.0)
    if kind == "advection":         # fat ellipse: advection-dominated
        return ej.advection_diffusion_1d(120, peclet=3000.0), \
            et.advection_diffusion_1d(120, peclet=3000.0)
    raise ValueError(kind)


KINDS = ["stencil", "banded", "dense", "3d", "advection"]


def _gamma(top):
    return tfb._resolve_ellipse(top, None)[3]


def _t_expv(top, kind=None):
    """Two substeps of z = |t| gamma = 350; one of z = 10 for the 3-D
    stencil, whose result decays to 1e-34 of b at z = 700 and 5e-5 at
    z = 30 (relative differences of roundoff size grow as it decays)."""
    return (10.0 if kind == "3d" else 700.0) / _gamma(top)


def _vec(n, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if cols is None else (n, cols))


@pytest.mark.parametrize("kind", KINDS)
def test_fov_ellipse(kind):
    jop, top = _ops(kind)
    assert_close(et.fov_ellipse(top), ej.fov_ellipse(jop), 1e-14, kind)


def test_fov_ellipse_hermitian_and_no_rule():
    a = np.random.default_rng(2).uniform(0.5, 2.0, (6, 7))
    jc = ej.fov_ellipse(ej.variable_diffusion_nd_stencil(jnp.asarray(a)))
    tc = et.fov_ellipse(et.variable_diffusion_nd_stencil(a, device="cpu"))
    assert tc[2] == jc[2] == 0.0
    assert_close(tc, jc, 1e-14)
    op = et.MatrixFreeOperator(lambda x: x, (4, 4), device="cpu")
    with pytest.raises(TypeError, match="fov_ellipse"):
        et.fov_ellipse(op)


def test_faber_coeffs_equal():
    f = np.exp(tfb._psi_samples(0.7, -1.0, 2.0, 0.3, 256))
    aj, sj = ej.faber_coeffs(f, 0.3, 64)
    at, st = et.faber_coeffs(f, 0.3, 64)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(st, sj)
    with pytest.raises(ValueError, match="samples"):
        et.faber_coeffs(f[:100], 0.3, 64)


@pytest.mark.parametrize("kind", KINDS)
def test_setup_equal(kind):
    """Ellipse map, degree, substep count, coefficients."""
    jop, top = _ops(kind)
    t = _t_expv(top, kind)
    sj = jfb._faber_expv_setup(jop, t, None, 1e-10, None, 512.0)
    st = tfb._faber_expv_setup(top, t, None, 1e-10, None, 512.0)
    (aj, cj, gj, rj, qj, mj, lj), (at, ct, gt, rt, qt, mt, lt) = sj, st
    assert (qt, mt) == (qj, mj) and qt == (1 if kind == "3d" else 2)
    assert np.iscomplexobj(at) == np.iscomplexobj(aj)
    assert_close([ct, gt, rt, lt], [cj, gj, rj, lj], 1e-14, kind)
    assert_close(at[:mt], aj[:mj], 1e-13, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_expv_faber_vs_jax(kind):
    jop, top = _ops(kind)
    b = _vec(top.shape[0])
    t = _t_expv(top, kind)
    wj = ej.expv_faber(t, jop, jnp.asarray(b), tol=1e-10)
    wt = et.expv_faber(t, top, torch.as_tensor(b), tol=1e-10)
    assert_close(t2n(wt), np.asarray(wj), RTOL64, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_phiv_faber_vs_jax(kind):
    jop, top = _ops(kind)
    b = _vec(top.shape[0], 1)
    t = 60.0 / _gamma(top)
    Wj = ej.phiv_faber(t, jop, jnp.asarray(b), 3, tol=1e-10)
    Wt = et.phiv_faber(t, top, torch.as_tensor(b), 3, tol=1e-10)
    assert_close(t2n(Wt), np.asarray(Wj), RTOL64, kind)


def test_expv_faber_complex_b_fixed_m_and_disk():
    """A complex b keeps complex coefficients (the plain path); a skew
    operator has beta > alpha, enclosed by its disk (rho = 0)."""
    jop, top = _ops("banded")
    b = _vec(150) + 1j * _vec(150, 2)
    wj = ej.expv_faber(1e-5, jop, jnp.asarray(b), m=40)
    wt = et.expv_faber(1e-5, top, torch.as_tensor(b), m=40)
    assert_close(t2n(wt), np.asarray(wj), RTOL64)
    S = np.random.default_rng(5).standard_normal((30, 30))
    M = (S - S.T) / 2 - 0.5 * np.eye(30)
    b = _vec(30, 3)
    # the disk's monomial basis cancels e^{t gamma}-sized terms: a short t
    wj = ej.expv_faber(0.5, jnp.asarray(M), jnp.asarray(b), tol=1e-10)
    wt = et.expv_faber(0.5, torch.as_tensor(M), torch.as_tensor(b), tol=1e-10)
    assert_close(t2n(wt), np.asarray(wj), RTOL64)


@pytest.mark.parametrize("kind,zs", [
    ("stencil", [900.0, 300.0]),       # unsorted snapshots, q > 1 for one
    ("banded", 400.0),                 # scalar ts
    ("3d", [0.0, 30.0]),               # a zero and a forward
    ("advection", [50.0, 100.0]),
])
def test_phiv_timestep_faber_vs_jax(kind, zs):
    jop, top = _ops(kind)
    g = _gamma(top)
    ts = [z / g for z in zs] if isinstance(zs, list) else zs / g
    B = _vec(top.shape[0], 4, cols=3)
    Uj = ej.phiv_timestep_faber(ts, jop, jnp.asarray(B), tol=1e-10)
    Ut = et.phiv_timestep_faber(ts, top, torch.as_tensor(B), tol=1e-10)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64, kind)


def test_constant_operator_shortcut():
    A = np.diag(np.full(10, -0.4))
    b = _vec(10)
    args = dict(ellipse=(-0.4, 0.0, 0.0))
    assert_close(t2n(et.expv_faber(0.3, torch.as_tensor(A),
                                   torch.as_tensor(b), **args)),
                 np.asarray(ej.expv_faber(0.3, jnp.asarray(A), jnp.asarray(b),
                                          **args)), RTOL64)
    B = _vec(10, 1, cols=2)
    assert_close(t2n(et.phiv_timestep_faber([0.3, 0.6], torch.as_tensor(A),
                                            torch.as_tensor(B), **args)),
                 np.asarray(ej.phiv_timestep_faber(
                     [0.3, 0.6], jnp.asarray(A), jnp.asarray(B), **args)),
                 RTOL64)


# --- the engine rows: each CUDA recurrence engine's CPU twin against the
# plain Faber loop

ENGINES = {"stencil": tr.recurrence_apply_resident,          # B1
           "banded": tr.recurrence_apply_resident_banded,    # B5
           "3d": tf.recurrence_apply_fused}                  # B3


def test_faber_rows_equal():
    a = _vec(9, 6)
    rt = tfb._faber_rows(a, -3.0, 0.25, 0.4)
    np.testing.assert_array_equal(rt, jfb._faber_rows(a, -3.0, 0.25, 0.4))
    assert rt[0, 2] == 0.0 and rt[1, 2] == -0.8 and (rt[2:, 2] == -0.4).all()
    np.testing.assert_array_equal(tfb._faber_rows(a[:1], -3.0, 0.25, 0.4),
                                  jfb._faber_rows(a[:1], -3.0, 0.25, 0.4))


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_rows_vs_plain_loop(kind):
    jop, top = _ops(kind)
    b = torch.as_tensor(_vec(top.shape[0], 7))
    t = _t_expv(top, kind)
    a, c, g, rho, q, m, _ = tfb._faber_expv_setup(top, t, None, 1e-10, None,
                                                  512.0)
    a = np.real(a[:m])
    w_eng = tfb._apply_fused_faber(top, b, a, c, 1.0 / g, rho, q,
                                   ENGINES[kind])
    w_plain = tfb._faber_apply(top, b, torch.as_tensor(a), c, 1.0 / g, rho, q)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64, kind)


def test_engine_rows_2d_grid_twin():
    """B6's twin on a 2-D non-symmetric stencil against the plain loop."""
    op = et.StencilOperator((9, 11), [(0, 0), (0, 1), (0, -1), (1, 0),
                                      (-1, 0)],
                            np.asarray([-4.5, 1.0, 1.5, 1.0, 1.0]))
    b = torch.as_tensor(_vec(99, 8))
    a, c, g, rho, q, m, _ = tfb._faber_expv_setup(op, 30.0 / _gamma(op),
                                                  None, 1e-10, None, 512.0)
    a = np.real(a[:m])
    w_eng = tfb._apply_fused_faber(op, b, a, c, 1.0 / g, rho, q,
                                   tr.recurrence_apply_resident_grid)
    w_plain = tfb._faber_apply(op, b, torch.as_tensor(a), c, 1.0 / g, rho, q)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64)


@pytest.mark.parametrize("multi", [False, True])
def test_engine_columns_vs_plain_loop(monkeypatch, multi):
    """(m, p) coefficients: one pass a column, or one B4 launch where its
    gate admits it; both equal the plain multi-column loop."""
    from exponentialutilities_jl_torch.models import leja as tl

    _, top = _ops("stencil")
    b = torch.as_tensor(_vec(200, 9))
    monkeypatch.setattr(tl, "resident_multi_ok", lambda *a: multi)
    c, alpha, beta, g, rho = tfb._resolve_ellipse(top, None)
    samples = tfb._psi_samples(1.0, c, g, rho, 512)
    V = tfb._phi_scalar_np((40.0 / g) * samples, 2)
    D = np.real(np.stack([tfb.faber_coeffs(V[j], rho, 100)[0]
                          for j in range(3)], axis=1))
    W_eng = tfb._apply_fused_faber(top, b, D, c, 1.0 / g, rho, 1,
                                   tr.recurrence_apply_resident)
    W_plain = tfb._faber_apply(top, b, torch.as_tensor(D), c, 1.0 / g, rho, 1)
    assert_close(t2n(W_eng), t2n(W_plain), RTOL64)


def test_nw_fused_substep_vs_scan():
    _, top = _ops("stencil")
    B = torch.as_tensor(_vec(200, 10, cols=3))
    c, alpha, beta, g, rho = tfb._resolve_ellipse(top, None)
    tau = 200.0 / g
    samples = tfb._psi_samples(1.0, c, g, rho, 2048)
    V = tfb._phi_scalar_np(tau * samples, 2)
    D = np.real(np.stack([tfb.faber_coeffs(V[j], rho, 400)[0]
                          for j in range(3)], axis=1))
    D = D * (tau ** np.arange(3))[None, :]
    rows = torch.as_tensor(np.stack([tfb._faber_rows(D[:, j], c, 1 / g, rho)
                                     for j in range(3)]))
    u = B[:, 0]
    w_eng = tfb._nw_fused_substep_faber(top, u, B, 0.01, rows,
                                        tr.recurrence_apply_resident, 2)
    w_plain = tfb._nw_faber_scan(top, u, B, torch.as_tensor(D), c, 1 / g,
                                 rho, 0.01, tau, 2, 1)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64)


def test_fused_true_without_engine_raises():
    _, top = _ops("stencil")
    b = torch.as_tensor(_vec(200))
    with pytest.raises(ValueError, match="fused=True"):
        et.expv_faber(1e-3, top, b, fused=True)          # CPU tensor
    with pytest.raises(ValueError, match="fused=True"):
        et.expv_faber(1e-3, top, b.to(torch.complex128), fused=True)


# --- the failure protocol, in both packages

def test_shrunk_ellipse_raises():
    """An ellipse 50x too small: the Crouzeix guard catches the finite
    but wrong answer in both packages."""
    jop, top = _ops("advection")
    c, a, bet = et.fov_ellipse(top)
    b = _vec(120)
    t = 200.0 / (0.5 * (a + bet))
    kw = dict(ellipse=(c, a / 50, bet / 50), tol=1e-8)
    with pytest.raises((FloatingPointError, ValueError)):
        ej.expv_faber(t, jop, jnp.asarray(b), **kw)
    with pytest.raises((FloatingPointError, ValueError)):
        et.expv_faber(t, top, torch.as_tensor(b), **kw)


def test_overflow_and_max_z_raise():
    b = _vec(50)
    kw = dict(ellipse=(-2.0, 2.0, 0.0), tol=1e-8, max_z=2000.0)
    for pkg, op in ((ej, ej.laplacian_1d(50)),
                    (et, et.laplacian_1d(50, device="cpu"))):
        arr = jnp.asarray if pkg is ej else torch.as_tensor
        with pytest.raises(FloatingPointError, match="overflow"):
            pkg.expv_faber(-400.0, op, arr(b), **kw)
        with pytest.raises(ValueError, match="max_z"):
            pkg.phiv_faber(1e3, op, arr(b), 1, ellipse=(-2.0, 2.0, 0.0))


def test_nonconvergence_raises():
    S = np.random.default_rng(12).standard_normal((30, 30))
    M = (S - S.T) / 2
    b = _vec(30)
    c, a, bet = et.fov_ellipse(torch.as_tensor(M))
    t = 5000.0 / (0.5 * (a + bet))
    with pytest.raises((ValueError, FloatingPointError)):
        ej.expv_faber(t, jnp.asarray(M), jnp.asarray(b), tol=1e-10, max_z=1e9)
    with pytest.raises((ValueError, FloatingPointError)):
        et.expv_faber(t, torch.as_tensor(M), torch.as_tensor(b), tol=1e-10,
                      max_z=1e9)

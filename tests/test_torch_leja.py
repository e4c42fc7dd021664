"""PyTorch port vs JAX package: the real-Leja Newton actions
(models/leja.py), float64 on CPU with the same seeded numpy inputs through
both packages.

Single actions and the NW driver are held to JAX's results at 1e-12
relative (max-norm), with the interval, the degree and the substep count
q equal; the engine rows (the (m, 4) Newton rows of the CUDA recurrence
kernels) are held to the plain loop through the kernels' CPU twins, and
the failure protocol raises in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import leja as jl
from exponentialutilities_jl_torch.models import leja as tl
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from torch_parity import RTOL64, assert_close, t2n

torch.set_num_threads(2)


def _stencil1(n, d_c, a_c, pkg):
    """1-D advection-diffusion stencil (benchmarks/bench_leja.py's
    coefficients, scaled): diffusion d_c, upwind advection a_c."""
    cs = [d_c + a_c, -2 * d_c - a_c, d_c]
    if pkg is ej:
        return ej.StencilOperator((n,), ((-1,), (0,), (1,)), jnp.asarray(cs),
                                  is_hermitian=False)
    return et.StencilOperator((n,), ((-1,), (0,), (1,)), np.asarray(cs),
                              is_hermitian=False)


def _ops(kind):
    """(jax operator, port operator) of one operator class."""
    if kind == "stencil":
        return _stencil1(200, 1e3, 2e2, ej), _stencil1(200, 1e3, 2e2, et)
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
    raise ValueError(kind)


KINDS = ["stencil", "banded", "dense", "3d"]


def _times(top, kind=None):
    """(t for expv, t for phiv): z = |t| s of 60 (two substeps at max_z =
    40) and 15 (within phiv's one-substep budget). The 3-D stencil takes
    z = 10 for both: its Newton sums cancel more, so the two packages'
    different roundoff (XLA contracts the stencil sums to FMAs) grows with
    z, to 9e-13 of the result at z = 15 and 1e-10 at one substep of z = 35
    (measured on the CPU)."""
    s = tl._interval_map(top, None)[1]
    if kind == "3d":
        return 10.0 / s, 10.0 / s
    return 60.0 / s, 15.0 / s


def _vec(n, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if cols is None else (n, cols))


def test_leja_points_equal():
    for m in (1, 7, 60):
        pj, sj = jl._leja_points_sup(m)
        pt, st = tl._leja_points_sup(m)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(et.leja_points(9, -1.0, 3.0),
                                  ej.leja_points(9, -1.0, 3.0))


@pytest.mark.parametrize("kind", KINDS)
def test_real_interval(kind):
    jop, top = _ops(kind)
    lj, hj = ej.real_interval(jop)
    lt, ht = et.real_interval(top)
    assert_close([lt, ht], [lj, hj], 1e-14, kind)


def test_real_interval_needs_a_rule():
    op = et.MatrixFreeOperator(lambda x: x, (4, 4), device="cpu")
    with pytest.raises(TypeError, match="real_interval"):
        et.real_interval(op)


@pytest.mark.parametrize("kind", KINDS)
def test_setup_equal(kind):
    """Interval map, degree, substep count and divided differences."""
    jop, top = _ops(kind)
    t = _times(top, kind)[0]
    dj, xj, cj, sj, qj = jl._leja_expv_setup(jop, t, None, 1e-10, None, 40.0)
    dt_, xt, ct, st, qt = tl._leja_expv_setup(top, t, None, 1e-10, None, 40.0)
    assert (qt, len(dt_)) == (qj, len(dj)) and (qt >= 2 or kind == "3d")
    assert_close([ct, st], [cj, sj], 1e-14, kind)
    assert_close(dt_, dj, 1e-13, kind)
    np.testing.assert_array_equal(xt, xj)


@pytest.mark.parametrize("kind", KINDS)
def test_expv_leja_vs_jax(kind):
    jop, top = _ops(kind)
    n = top.shape[0]
    b = _vec(n)
    t = _times(top, kind)[0]
    wj = ej.expv_leja(t, jop, jnp.asarray(b), tol=1e-10)
    wt = et.expv_leja(t, top, torch.as_tensor(b), tol=1e-10)
    assert_close(t2n(wt), np.asarray(wj), RTOL64, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_phiv_leja_vs_jax(kind):
    jop, top = _ops(kind)
    n = top.shape[0]
    b = _vec(n, 1)
    t = _times(top, kind)[1]
    Wj = ej.phiv_leja(t, jop, jnp.asarray(b), 3, tol=1e-10)
    Wt = et.phiv_leja(t, top, torch.as_tensor(b), 3, tol=1e-10)
    assert_close(t2n(Wt), np.asarray(Wj), RTOL64, kind)


def test_expv_leja_complex_b_and_fixed_m():
    jop, top = _ops("banded")
    b = _vec(150) + 1j * _vec(150, 2)
    wj = ej.expv_leja(1e-5, jop, jnp.asarray(b), m=30)
    wt = et.expv_leja(1e-5, top, torch.as_tensor(b), m=30)
    assert_close(t2n(wt), np.asarray(wj), RTOL64)


def test_constant_operator_shortcut():
    A = 0.7 * np.eye(12)
    b = _vec(12)
    for fj, ft in ((ej.expv_leja, et.expv_leja),):
        assert_close(t2n(ft(0.3, torch.as_tensor(A), torch.as_tensor(b),
                            interval=(0.7, 0.7))),
                     np.asarray(fj(0.3, jnp.asarray(A), jnp.asarray(b),
                                   interval=(0.7, 0.7))), RTOL64)
    assert_close(t2n(et.phiv_leja(0.3, torch.as_tensor(A),
                                  torch.as_tensor(b), 2, interval=(0.7, 0.7))),
                 np.asarray(ej.phiv_leja(0.3, jnp.asarray(A), jnp.asarray(b),
                                         2, interval=(0.7, 0.7))), RTOL64)


@pytest.mark.parametrize("kind,ts", [
    ("stencil", [0.1, 0.04]),          # unsorted snapshots, q > 1 each
    ("banded", 3e-5),                  # scalar ts
    ("3d", [-1e-3, 0.0, 3e-3]),        # a backward, a zero and a forward
])
def test_phiv_timestep_leja_vs_jax(kind, ts):
    jop, top = _ops(kind)
    B = _vec(top.shape[0], 4, cols=3)
    Uj = ej.phiv_timestep_leja(ts, jop, jnp.asarray(B), tol=1e-10)
    Ut = et.phiv_timestep_leja(ts, top, torch.as_tensor(B), tol=1e-10)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64, kind)


def test_phiv_timestep_leja_p0_and_max_degree():
    jop, top = _ops("stencil")
    b = _vec(200, 5)
    kw = dict(tol=1e-10, max_z=60.0, max_degree=90)
    Uj = ej.phiv_timestep_leja([0.05], jop, jnp.asarray(b), **kw)
    Ut = et.phiv_timestep_leja([0.05], top, torch.as_tensor(b), **kw)
    assert_close(t2n(Ut), np.asarray(Uj), RTOL64)


# --- the engine rows: each CUDA recurrence engine's CPU twin against the
# plain Newton loop

ENGINES = {"stencil": tr.recurrence_apply_resident,          # B1
           "banded": tr.recurrence_apply_resident_banded,    # B5
           "3d": tf.recurrence_apply_fused}                  # B3


def test_newton_rows_equal():
    xi = tl.leja_points(17)
    d = _vec(17, 6)
    np.testing.assert_array_equal(tl._newton_rows(d, xi, -3.0, 0.25),
                                  jl._newton_rows(d, xi, -3.0, 0.25))
    rows = tl._newton_rows(d, xi, -3.0, 0.25)
    assert not rows[:, 2].any()                           # cc = 0


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_rows_vs_plain_loop(kind):
    jop, top = _ops(kind)
    b = torch.as_tensor(_vec(top.shape[0], 7))
    t = _times(top, kind)[0]
    d, xi, c, s, q = tl._leja_expv_setup(top, t, None, 1e-10, None, 40.0)
    w_eng = tl._apply_fused_newton(top, b, d, xi, c, 1.0 / s, q,
                                   ENGINES[kind])
    w_plain = tl._leja_apply(top, b, torch.as_tensor(d), torch.as_tensor(xi),
                             c, 1.0 / s, q)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64, kind)


def test_engine_rows_2d_grid_twin():
    """B6's twin (a 2-D non-symmetric stencil) against the plain loop."""
    op = et.StencilOperator((9, 11), [(0, 0), (0, 1), (0, -1), (1, 0),
                                      (-1, 0)],
                            np.asarray([-4.5, 1.0, 1.5, 1.0, 1.0]))
    b = torch.as_tensor(_vec(99, 8))
    d, xi, c, s, q = tl._leja_expv_setup(op, 3.0, None, 1e-10, None, 40.0)
    w_eng = tl._apply_fused_newton(op, b, d, xi, c, 1.0 / s, q,
                                   tr.recurrence_apply_resident_grid)
    w_plain = tl._leja_apply(op, b, torch.as_tensor(d), torch.as_tensor(xi),
                             c, 1.0 / s, q)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64)


@pytest.mark.parametrize("multi", [False, True])
def test_engine_columns_vs_plain_loop(monkeypatch, multi):
    """(m, p) coefficients: one pass a column, or (where B4's gate admits
    it) one B4 launch; both equal the plain multi-column loop."""
    jop, top = _ops("stencil")
    b = torch.as_tensor(_vec(200, 9))
    monkeypatch.setattr(tl, "resident_multi_ok", lambda *a: multi)
    t = _times(top)[1]
    c, s = tl._interval_map(top, None)
    xi, _ = tl._leja_points_sup(40)
    D = tl._phi_divided_differences(t, c, s, xi, 2)
    W_eng = tl._apply_fused_newton(top, b, D, xi, c, 1.0 / s, 1,
                                   tr.recurrence_apply_resident)
    W_plain = tl._leja_apply(top, b, torch.as_tensor(D), torch.as_tensor(xi),
                             c, 1.0 / s, 1)
    assert_close(t2n(W_eng), t2n(W_plain), RTOL64)


def test_nw_fused_substep_vs_scan():
    """The driver's engine substep (p + 1 passes from the combination
    columns) against the plain substep."""
    jop, top = _ops("stencil")
    B = torch.as_tensor(_vec(200, 10, cols=3))
    c, s = tl._interval_map(top, None)
    tau = 0.02
    xi, _ = tl._leja_points_sup(60)
    D = tl._phi_divided_differences(tau, c, s, xi, 2)
    D = D * (tau ** np.arange(3))[None, :]
    rows = torch.as_tensor(np.stack([tl._newton_rows(D[:, j], xi, c, 1 / s)
                                     for j in range(3)]))
    u = B[:, 0]
    w_eng = tl._nw_fused_substep(top, u, B, 0.01, rows,
                                 tr.recurrence_apply_resident, 2)
    w_plain = tl._nw_leja_scan(top, u, B, torch.as_tensor(D),
                               torch.as_tensor(xi), c, 1 / s, 0.01, tau, 2, 1)
    assert_close(t2n(w_eng), t2n(w_plain), RTOL64)


def test_fused_true_without_engine_raises():
    _, top = _ops("stencil")
    b = torch.as_tensor(_vec(200))
    with pytest.raises(ValueError, match="fused=True"):
        et.expv_leja(0.01, top, b, fused=True)          # CPU tensor
    dense = torch.as_tensor(np.diag([-1.0, -2.0, -3.0]))
    with pytest.raises(ValueError, match="fused=True"):
        et.phiv_leja(0.1, dense, torch.ones(3, dtype=torch.float64), 1,
                     fused=True)


# --- the failure protocol, in both packages

def test_phiv_leja_past_max_z_raises():
    jop, top = _ops("stencil")
    b = _vec(200)
    with pytest.raises(ValueError, match="max_z"):
        ej.phiv_leja(0.1, jop, jnp.asarray(b), 1)
    with pytest.raises(ValueError, match="max_z"):
        et.phiv_leja(0.1, top, torch.as_tensor(b), 1)


def test_advection_dominated_raises_not_nan():
    """A fat field of values (advection-dominated, float32 as in the JAX
    test): both drivers raise instead of returning inf/NaN."""
    n = 2000
    B = _vec(n, 11, cols=2).astype(np.float32)
    cs = np.asarray([41.0, -42.0, 1.0], np.float32)
    jop = ej.StencilOperator((n,), ((-1,), (0,), (1,)), jnp.asarray(cs),
                             is_hermitian=False)
    top = et.StencilOperator((n,), ((-1,), (0,), (1,)), cs,
                             is_hermitian=False)
    with pytest.raises(FloatingPointError, match="diverged"):
        ej.phiv_timestep_leja(50.0, jop, jnp.asarray(B), tol=1e-7)
    with pytest.raises(FloatingPointError, match="diverged"):
        et.phiv_timestep_leja(50.0, top, torch.as_tensor(B), tol=1e-7)


def test_overflowed_table_raises():
    A = np.diag(np.linspace(1.0, 1999.0, 20))
    b = _vec(20)
    for pkg, arr in ((ej, jnp.asarray), (et, torch.as_tensor)):
        with pytest.raises(FloatingPointError, match="non-finite"):
            pkg.expv_leja(1.0, arr(A), arr(b), interval=(0.0, 2000.0),
                          max_z=2000.0)
        with pytest.raises(FloatingPointError):
            pkg.phiv_timestep_leja(1.0, arr(A), arr(b[:, None]),
                                   interval=(0.0, 2000.0), max_z=2000.0,
                                   max_degree=64)


def test_truncate_dd_contract():
    for mag in (np.array([1.0, 0.5, np.nan]), np.array([1.0, np.inf])):
        with pytest.raises(FloatingPointError, match="non-finite"):
            tl._truncate_dd(mag, 1e-7, 10, None, "test")
    slow = np.ones(10)
    with pytest.raises(ValueError, match="did not converge"):
        jl._truncate_dd(slow, 1e-7, 10, None, "test")
    with pytest.raises(ValueError, match="did not converge"):
        tl._truncate_dd(slow, 1e-7, 10, None, "test")
    assert tl._truncate_dd(slow, 1e-7, 10, 4, "t") == \
        jl._truncate_dd(slow, 1e-7, 10, 4, "t") == 4

"""PyTorch port vs JAX package: the resident recurrences
(ops/kernels/resident.py) and their engine selection. On CPU the port's
wrappers run the plain twins of kernels B1, B2, B4, B5 and B6; the JAX side
runs its Pallas kernels in interpret mode (float32, RTOL32) or its XLA
paths (float64, RTOL64)."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import chebyshev as jc
from exponentialutilities_jl_tpu.models import expv as jex
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_tpu.ops.kernels import resident as jr
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)

STENCILS_1D = [
    ((-1, 0, 1), (1.0, -2.0, 1.0)),
    ((-2, -1, 0, 1, 2), (-0.1, 1.2, -2.5, 1.2, -0.1)),     # |o| = 2
    ((0, 1, 3), (-1.0, 0.8, 0.1)),                         # asymmetric
]


def _ops(offsets, coeffs, n, dtype, herm=False):
    jop = ej.StencilOperator((n,), tuple((o,) for o in offsets),
                             jnp.asarray(coeffs, dtype), is_hermitian=herm)
    return jop, et.to_torch_operator(jop)


@pytest.mark.parametrize("offsets,coeffs", STENCILS_1D)
def test_recurrence_twin_vs_interpret(offsets, coeffs):
    n, m, scale = 300, 9, 0.7
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    rows = (rng.standard_normal((m, 4)) * 0.5).astype(np.float32)
    jop, top = _ops(offsets, coeffs, n, np.float32)
    R, mask = jr._layout_1d(n)
    Xp = jnp.pad(jnp.asarray(x), (0, R * 128 - n)).reshape(R, 128)
    jW, jnrm = jr._resident_call(Xp, jnp.asarray(mask), jnp.asarray(rows),
                                 jop.coeffs, scale, offsets=offsets,
                                 interpret=True)
    tw, tnrm = tr.resident_recurrence(top, torch.as_tensor(x),
                                      torch.as_tensor(rows), scale)
    assert_close(t2n(tw), np.asarray(jW).reshape(-1)[:n], RTOL32, "w")
    assert float(tnrm) == pytest.approx(float(jnrm), rel=RTOL32)


def test_recurrence_apply_resident_f64():
    """float64 twin vs the JAX Pallas kernel in interpret mode (the same
    arithmetic; only the sum order of the stencil differs)."""
    n, m = 257, 14
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    rows = rng.standard_normal((m, 4)) * 0.5
    jop, top = _ops(*STENCILS_1D[1], n, np.float64)
    jw = jr.recurrence_apply_resident(jop, jnp.asarray(x), jnp.asarray(rows),
                                      scale=1.3, interpret=True)
    tw = tr.recurrence_apply_resident(top, torch.as_tensor(x),
                                      torch.as_tensor(rows), scale=1.3)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "w")


def _invariant_start(n, modes):
    """A start vector in the span of a few Dirichlet-Laplacian eigenvectors:
    Lanczos breaks down after len(modes) steps."""
    i = np.arange(1, n + 1)
    return sum(np.sin(k * np.pi * i / (n + 1)) for k in modes)


@pytest.mark.parametrize("start", ["random", "invariant"])
def test_lanczos_twin_vs_interpret(start):
    n, m = 200, 10
    b = (np.random.default_rng(2).standard_normal(n) if start == "random"
         else _invariant_start(n, (30, 120))).astype(np.float32)
    jop, top = _ops(*STENCILS_1D[0], n, np.float32, herm=True)
    # float32 rounding leaves beta ~1e-7 at an exact breakdown: a tol of
    # 1e-4 makes both sides detect it
    tol = 1e-4
    ja, jb, jb0, jmu, jbr = jr.lanczos_coeffs_resident(
        jop, jnp.asarray(b), m, tol=tol, interpret=True)
    ta, tb, tb0, tmu, tbr = tr.lanczos_coeffs_resident(
        top, torch.as_tensor(b), m, tol=tol)
    assert_close(t2n(ta), np.asarray(ja), RTOL32, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL32, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL32)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
    if start == "invariant":
        assert int(tmu) == 2 and bool(tbr)


@pytest.mark.parametrize("start", ["random", "invariant", "zero"])
def test_lanczos_coeffs_resident_f64(start):
    """float64 twin vs the JAX XLA pass 1 (ops/krylov.lanczos_coeffs)."""
    n, m = 120, 12
    b = {"random": np.random.default_rng(3).standard_normal(n),
         "invariant": _invariant_start(n, (2, 5, 7)),
         "zero": np.zeros(n)}[start]
    jop, top = _ops(*STENCILS_1D[0], n, np.float64, herm=True)
    ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    ta, tb, tb0, tmu, tbr = tr.lanczos_coeffs_resident(top, torch.as_tensor(b),
                                                       m)
    assert_close(t2n(ta), np.asarray(ja), RTOL64, "alphas")
    # after a breakdown the XLA pass records the sub-tol beta, the resident
    # pass records 0 (resident.py masked-tail convention); both mark it
    mask = np.asarray(jb) >= 1e-7
    assert_close(t2n(tb) * mask, np.asarray(jb) * mask, RTOL64, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL64, abs=0)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))


@pytest.mark.parametrize("t", [0.5, 2.0])
def test_expv_two_pass_resident(t):
    n, m = 256, 24
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    jop, top = _ops(*STENCILS_1D[0], n, np.float32, herm=True)
    jw = jr.expv_two_pass_resident(jop, jnp.asarray(b), t, m, interpret=True)
    tw = tr.expv_two_pass_resident(top, torch.as_tensor(b), t, m)
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "expv")


def test_expv_two_pass_resident_f64_vs_scipy():
    import scipy.sparse.linalg as spla

    n, m, t = 300, 30, 0.5
    b = np.random.default_rng(5).standard_normal(n)
    jop, top = _ops(*STENCILS_1D[0], n, np.float64, herm=True)
    A = np.asarray(jop.to_banded().to_dense())
    want = spla.expm_multiply(t * A, b)
    tw = tr.expv_two_pass_resident(top, torch.as_tensor(b), t, m)
    # the JAX resident kernels are float32-only: hold the float64 twin to
    # the JAX XLA two-pass expv instead
    jw = jex._expv_two_pass(jop, jnp.asarray(b), t, m)
    assert_close(t2n(tw), want, 1e-12, "vs scipy")
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "vs JAX")
    zero = tr.expv_two_pass_resident(top, torch.zeros(n, dtype=torch.float64),
                                     t, m)
    assert not t2n(zero).any()


def test_cpu_runs_twin_not_kernel():
    _build.reset_launch_counts()
    top = et.laplacian_nd_stencil(64)
    ones = torch.ones(64, dtype=torch.float64)
    rows = torch.ones((3, 4), dtype=torch.float64)
    tr.recurrence_apply_resident(top, ones, rows)
    tr.lanczos_coeffs_resident(top, ones, 3)
    tr.recurrence_apply_resident_multi(top, ones, rows, rows[:, :2])
    tr.recurrence_apply_resident_banded(et.laplacian_1d(64), ones, rows)
    tr.recurrence_apply_resident_grid(et.laplacian_nd_stencil(8, 8), ones,
                                      rows)
    assert _build.launches == {"resident_recurrence": 0,
                               "resident_lanczos": 0, "resident_multi": 0,
                               "resident_banded": 0, "resident_grid": 0,
                               "fused_sweep": 0, "fused_sweep_var": 0,
                               "sweep_stage": 0, "banded_spmv": 0,
                               "blockell_spmv": 0, "sell_spmv": 0,
                               "seg_compact": 0}


def test_resident_supported_and_rejects():
    assert tr.resident_supported(et.laplacian_nd_stencil(64))
    assert not tr.resident_supported(et.laplacian_nd_stencil(8, 8))
    assert not tr.resident_supported(et.laplacian_1d(64))
    cplx = et.StencilOperator((16,), [(0,)], np.asarray([1.0 + 1j]))
    assert not tr.resident_supported(cplx)
    assert not tr.resident_supported(
        et.StencilOperator((4,), [(-4,), (0,)], np.asarray([1.0, 1.0])))
    for op in (et.laplacian_1d(16), cplx):
        with pytest.raises(ValueError):
            tr.recurrence_apply_resident(op, torch.ones(16), torch.ones((2, 4)))
    with pytest.raises(ValueError):
        tr.resident_recurrence(et.laplacian_nd_stencil(16), torch.ones(16),
                               torch.ones((2, 3)))


# ------------------------------------------------ B4, B5, B6 and dispatch --

def _rows32(m, seed, ncols=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, ncols)) * 0.4).astype(np.float32)


def _cheb(jop, t, tol=1e-12):
    """Chebyshev exp(tA) coefficients and interval of a Hermitian op."""
    lo, hi = (float(v) for v in jop.spectral_bounds_hint())
    full, c, h = jc._full_exp_coeffs(t, lo, hi, tol, None)
    return full, c, h


@pytest.mark.parametrize("offsets,coeffs", STENCILS_1D[:2])
def test_multi_twin_vs_interpret(offsets, coeffs):
    n, m, p = 300, 9, 3
    x = np.random.default_rng(10).standard_normal(n).astype(np.float32)
    rows, cw = _rows32(m, 11), _rows32(m, 12, p)
    jop, top = _ops(offsets, coeffs, n, np.float32)
    jW = jr.recurrence_apply_resident_multi(jop, jnp.asarray(x),
                                            jnp.asarray(rows),
                                            jnp.asarray(cw), interpret=True)
    tW = tr.recurrence_apply_resident_multi(top, torch.as_tensor(x),
                                            torch.as_tensor(rows),
                                            torch.as_tensor(cw))
    assert tW.shape == (n, p)
    assert_close(t2n(tW), np.asarray(jW), RTOL32, "W")


def test_multi_twin_f64_vs_jax_scan():
    """float64: a (m, p) stack of phi Chebyshev coefficients through the
    twin vs the JAX plain multi-column apply (_chebyshev_apply_scan)."""
    n, t, k = 257, 0.3, 2
    jop, top = _ops(*STENCILS_1D[0], n, np.float64, herm=True)
    lo, hi = -4.0, 0.0
    c, h = 0.5 * (hi + lo), 0.5 * (hi - lo)
    C = jc._fun_ucoeffs(lambda x: jc._phi_scalar_np(t * (c + h * x), k),
                        1e-12, 512)
    x = np.random.default_rng(13).standard_normal(n)
    jW = jc._chebyshev_apply_scan(jop, jnp.asarray(x), jnp.asarray(C), c,
                                  1.0 / h)
    rows = td.chebyshev_rows(torch.zeros(len(C), dtype=torch.float64), c, h,
                             torch.float64)
    tW = tr.recurrence_apply_resident_multi(top, torch.as_tensor(x), rows,
                                            torch.as_tensor(C))
    assert_close(t2n(tW), np.asarray(jW), RTOL64, "W")


def _banded_ops(kind, dtype):
    if kind == "poisson":
        jop = ej.poisson_2d(12, 16)
        jop = type(jop)(jop.diags.astype(dtype), jop.offsets,
                        is_hermitian=True)
    else:                                   # random wide band
        rng = np.random.default_rng(14)
        diags = (rng.standard_normal((5, 500)) * 0.4).astype(dtype)
        jop = ej.BandedOperator(jnp.asarray(diags), (-30, -1, 0, 1, 30))
    return jop, et.to_torch_operator(jop)


@pytest.mark.parametrize("kind", ["poisson", "band"])
def test_banded_twin_vs_interpret(kind):
    jop, top = _banded_ops(kind, np.float32)
    n = jop.shape[0]
    x = np.random.default_rng(15).standard_normal(n).astype(np.float32)
    rows = _rows32(7, 16)
    jw = jr.recurrence_apply_resident_banded(jop, jnp.asarray(x),
                                             jnp.asarray(rows), interpret=True)
    tw = tr.recurrence_apply_resident_banded(top, torch.as_tensor(x),
                                             torch.as_tensor(rows))
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "w")


def _cheb_vs_scan(jop, top, t, seed):
    """float64 twin with Chebyshev rows vs the JAX plain apply."""
    full, c, h = _cheb(jop, t)
    x = np.random.default_rng(seed).standard_normal(jop.shape[0])
    jw = jc._chebyshev_apply_scan(jop, jnp.asarray(x), jnp.asarray(full), c,
                                  1.0 / h)
    rows = td.chebyshev_rows(torch.as_tensor(full), c, h, torch.float64)
    return jw, x, rows


def test_banded_twin_f64_vs_jax_scan():
    jop = ej.poisson_2d(20, 30)
    top = et.to_torch_operator(jop)
    jw, x, rows = _cheb_vs_scan(jop, top, 0.05, 17)
    tw = tr.recurrence_apply_resident_banded(top, torch.as_tensor(x), rows)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "w")


def _box(shape, radius, seed, dtype):
    offs = list(itertools.product(range(-radius, radius + 1),
                                  repeat=len(shape)))
    cs = np.random.default_rng(seed).standard_normal(len(offs)) * 0.15
    return ej.StencilOperator(shape, tuple(offs), jnp.asarray(cs, dtype))


GRIDS = {
    "3d 7-point": lambda dt: ej.laplacian_nd_stencil(8, 10, 12, dtype=dt),
    "2d 9-point": lambda dt: _box((40, 130), 1, 18, dt),
    "3d 27-point": lambda dt: _box((6, 9, 14), 1, 19, dt),
    "3d wide dz": lambda dt: ej.StencilOperator(
        (7, 10, 20), ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (2, 0, 0), (-2, 0, 0),
                      (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)),
        jnp.asarray([-4.0, 1.0, 1.0, 0.25, 0.25, 0.8, 0.8, 0.6, 0.6], dt)),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_twin_vs_interpret(grid):
    jop = GRIDS[grid](jnp.float32)
    top = et.to_torch_operator(jop)
    x = np.random.default_rng(20).standard_normal(jop.shape[0]).astype(
        np.float32)
    rows = _rows32(6, 21)
    jw = jr.recurrence_apply_resident_grid(jop, jnp.asarray(x),
                                           jnp.asarray(rows), interpret=True)
    tw = tr.recurrence_apply_resident_grid(top, torch.as_tensor(x),
                                           torch.as_tensor(rows))
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "w")


@pytest.mark.parametrize("shape", [(6, 7, 8), (9, 33)])
def test_grid_twin_f64_vs_jax_scan(shape):
    jop = ej.laplacian_nd_stencil(*shape)
    top = et.to_torch_operator(jop)
    jw, x, rows = _cheb_vs_scan(jop, top, 0.05, 22)
    tw = tr.recurrence_apply_resident_grid(top, torch.as_tensor(x), rows)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "w")


def test_engine_selection_follows_jax_order():
    """resident, banded, grid, fused: decided from types and sizes alone,
    so a CUDA device type can be asked without a card."""
    f64, f32 = torch.float64, torch.float32

    def engine(op, dt=f64, device="cuda"):
        return td.recurrence_engine(op, dt, device=device, hermitian=True)

    assert engine(et.laplacian_nd_stencil(2000)) is tr.recurrence_apply_resident
    for op in (et.poisson_2d(1000, 1000), et.laplacian_1d(100_000)):
        assert engine(op) is tr.recurrence_apply_resident_banded
    for shape in ((6, 7, 8), (512, 512), (64, 64, 64)):
        assert engine(et.laplacian_nd_stencil(*shape)) is \
            tr.recurrence_apply_resident_grid
    # 216^3 stays on the B3 sweeps; 128 x 128 x 100 is past the L2 budget
    # in float64 but not in float32
    assert engine(et.laplacian_nd_stencil(216, 216, 216)) is \
        tf.recurrence_apply_fused
    mid = et.laplacian_nd_stencil(128, 128, 100)
    assert engine(mid) is tf.recurrence_apply_fused
    assert engine(mid, f32) is tr.recurrence_apply_resident_grid
    assert engine(et.poisson_2d(10, 12), device="cpu") is None
    with pytest.raises(ValueError):
        td.recurrence_engine(et.poisson_2d(10, 12), f64, fused=True,
                             device="cpu")


def test_banded_and_grid_gates():
    assert tr.resident_banded_supported(et.poisson_2d(16, 12))
    assert not tr.resident_banded_supported(et.laplacian_nd_stencil(64))
    cplx = et.BandedOperator(torch.ones((1, 8), dtype=torch.complex128), (0,))
    assert not tr.resident_banded_supported(cplx)
    assert not tr.resident_banded_supported(
        et.BandedOperator(torch.ones((2, 8)), (0, 8)))
    assert not tr.resident_banded_supported(
        et.BandedOperator(torch.ones((65, 100)), range(-32, 33)))
    assert not tr.resident_grid_supported(et.laplacian_nd_stencil(64))
    assert not tr.resident_grid_supported(et.poisson_2d(8, 8))
    assert not tr.resident_grid_supported(et.StencilOperator(
        (4, 4), [(0, 0)], np.asarray([1.0 + 1j])))
    for op in (et.laplacian_nd_stencil(64), cplx):
        with pytest.raises(ValueError):
            tr.recurrence_apply_resident_banded(op, torch.ones(8),
                                                torch.ones((2, 4)))
    with pytest.raises(ValueError):
        tr.recurrence_apply_resident_grid(et.laplacian_nd_stencil(64),
                                          torch.ones(64), torch.ones((2, 4)))
    with pytest.raises(ValueError):
        tr.recurrence_apply_resident_multi(et.laplacian_nd_stencil(16),
                                           torch.ones(16), torch.ones((2, 4)),
                                           torch.ones((3, 2)))

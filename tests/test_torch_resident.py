"""PyTorch port vs JAX package: the resident recurrences
(ops/kernels/resident.py) and their engine selection. On CPU the port's
wrappers run the plain twins of kernels B1, B2, B4, B5 and B6; the JAX side
runs its Pallas kernels in interpret mode (float32, RTOL32) or its XLA
paths (float64, RTOL64)."""

import ctypes
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
                               "seg_compact": 0, "tridiag_exp": 0,
                               "banded_spmm": 0, "tridiag_exp_batched": 0,
                               "resident_lanczos_batched": 0,
                               "resident_recurrence_batched": 0,
                               "banded_spmm_alpha": 0, "lanczos_update": 0}


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


# ------------------------------------------- B2 and B4 launch plans (host) --
# The plans' host logic with the kernel library replaced by a fake that
# answers the card's queries like an H100: 132 SMs, 232,448 bytes of shared
# memory a block can opt in to, clusters of 16 schedulable (or only 8).

OPTIN = 232_448
# the kernels' static shared memory (float32, float64)
CLUSTER_STATIC = {torch.float32: 1_280, torch.float64: 2_304}
NBR_STATIC = 960


# rows a block of B2's cluster form owns at most (the measured crossover
# with the grid form)
CLUSTER_MAX_ROWS = {torch.float32: 23_000, torch.float64: 8_192}


def _cluster_fits(rows, halo, dtype):
    """A cluster block fits: at most 8 (float64) or 32 (float32) rows a
    thread of 1024, and its shared memory (two y spans of L + 2h, the
    published edges 2 x 2 x 3 x h, and the static part) within the opt-in
    limit."""
    itemsize = 8 if dtype == torch.float64 else 4
    per_thread = 8 if dtype == torch.float64 else 32
    return (rows <= per_thread * 1024 and (2 * rows + 16 * halo) * itemsize
            + CLUSTER_STATIC[dtype] <= OPTIN)


def _card(max_cluster=16, sms=132, blocks=1024):
    """The fake library's answers: clusters of at most ``max_cluster``
    blocks fit where a block's shared memory does; neighbour blocks fit one
    per SM where their state does."""
    def fits(addr):
        L = tr._LanczosLaunch.from_address(addr)
        halo = max(abs(o) for o in L.o[:L.k])
        return int(L.cluster <= max_cluster
                   and _cluster_fits(L.rows, halo, fits.dtype))

    def capacity(kind, smem):
        return sms if smem + NBR_STATIC <= OPTIN else 0

    fits.dtype = torch.float64
    returns = {"eu_device_sms": sms, "eu_resident_max_blocks": blocks,
               "eu_nbr_capacity_f32": capacity,
               "eu_nbr_capacity_f64": capacity}
    return fits, returns


def _fake(monkeypatch, dtype, **card):
    from torch_parity import use_fake_kernel_library

    fits, returns = _card(**card)
    fits.dtype = dtype
    returns[f"eu_lanczos_cluster_fits_{_build.suffix(dtype)}"] = fits
    return use_fake_kernel_library(monkeypatch, returns)


def _stencil(n, offsets, dtype=torch.float64):
    return et.StencilOperator((n,), [(o,) for o in offsets],
                              np.linspace(0.5, 1.5, len(offsets)),
                              is_hermitian=True, dtype=dtype)


def _brute_cluster(n, halo, dtype, max_cluster):
    """B2's cluster gate by enumeration: the first C of (16, 8) whose
    smallest block rows L (C L >= n) hold the halo, are within the
    dtype's cap, and whose shared memory fits a block on a card holding
    clusters of ``max_cluster``."""
    for c in (16, 8):
        rows = next(L for L in itertools.count(1) if c * L >= n)
        if (halo <= rows <= CLUSTER_MAX_ROWS[dtype] and c <= max_cluster
                and _cluster_fits(rows, halo, dtype)):
            return c, rows
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_cluster", [16, 8, 4])
def test_cluster_gate_vs_brute_force(dtype, max_cluster):
    fits, _ = _card(max_cluster=max_cluster)
    fits.dtype = dtype
    probe_halo = [1]

    def probe(c, rows):
        L = tr._LanczosLaunch(0, 0, rows, c, 1)
        L.o[0] = probe_halo[0]
        return fits(ctypes.addressof(L))

    cap = tr.CLUSTER_MAX_ROWS[dtype]
    assert cap == CLUSTER_MAX_ROWS[dtype]
    for n in (1, 2, 15, 16, 17, 1000, 16 * 1024, 16 * 1024 + 1, 65_536,
              65_537, 100_000, 131_072, 131_073, 184_000, 184_001, 229_999,
              230_000, 232_000, 240_000, 300_000, 368_000, 368_001, 460_000,
              470_000, 523_000, 530_000, 1_000_000):
        for halo in (1, 2, 7, 1000, 20_000):
            if halo >= n:
                continue
            probe_halo[0] = halo
            assert tr.cluster_shape(n, halo, cap, probe) == _brute_cluster(
                n, halo, dtype, max_cluster), (n, halo)
    if max_cluster >= 16:   # config #2: 16 blocks of 6250 rows
        probe_halo[0] = 1
        assert tr.cluster_shape(100_000, 1, cap, probe) == (16, 6250)


@pytest.mark.parametrize("max_cluster,n,form,cluster", [
    (16, 100_000, "cluster", 16), (8, 60_000, "cluster", 8),
    (8, 100_000, "grid", 0),                # 12,500 rows a block: too many
    (0, 100_000, "grid", 0), (16, 300_000, "grid", 0),
    (16, 150_000, "grid", 0),
    (16, 10, "cluster", 16)])
def test_lanczos_plan_form_and_launch(monkeypatch, max_cluster, n, form,
                                      cluster):
    lib = _fake(monkeypatch, torch.float64, max_cluster=max_cluster)
    op = _stencil(n, (-1, 0, 1))
    plan = tr.lanczos_plan(op, torch.float64, torch.device("cpu"))
    assert (plan.form, plan.cluster) == (form, cluster)
    _build.reset_launch_counts()
    lib.calls.clear()
    v0 = torch.ones(n, dtype=torch.float64)
    ab = plan(v0, 7, 1e-7)
    assert ab.shape == (7, 2)
    assert _build.launches["resident_lanczos"] == 1
    (name, args), = lib.calls
    if form == "cluster":
        assert name == "eu_resident_lanczos_cluster_f64"
        L = tr._LanczosLaunch.from_address(args[0])
        assert (L.cluster, L.rows, L.k, list(L.o[:3])) == (
            cluster, -(-n // cluster), 3, [-1, 0, 1])
        assert args[2:4] == (7, 1e-7)
    else:
        assert name == "eu_resident_lanczos_f64"
        (buf, partials), = plan.scratch.values()
        assert plan.cap == 2 * 1024 and partials.numel() == 2048
        assert buf.numel() == 3 * n and args[3:7] == (3, n, 7, 1e-7)
    with pytest.raises(ValueError):
        plan(torch.ones(n, dtype=torch.float32), 7, 1e-7)
    with pytest.raises(ValueError):
        plan(torch.ones(n + 1, dtype=torch.float64), 7, 1e-7)


def test_lanczos_plan_halo_wider_than_block_rows(monkeypatch):
    """max|o| above L = ceil(n / 16) but within ceil(n / 8): the 8-block
    cluster; above both: the grid form."""
    _fake(monkeypatch, torch.float64)
    assert tr.lanczos_plan(_stencil(64, (-5, 0, 5)), torch.float64,
                           torch.device("cpu")).cluster == 8
    assert tr.lanczos_plan(_stencil(64, (-9, 0, 9)), torch.float64,
                           torch.device("cpu")).form == "grid"


@pytest.mark.parametrize("n,sms", [(1, 132), (255, 132), (257, 132),
                                   (100_000, 132), (100_001, 132),
                                   (33_000, 132), (33_793, 132),
                                   (1_000_000, 114), (5, 1)])
def test_nbr_geometry_vs_brute_force(n, sms):
    grid, chunk = tr.nbr_geometry(n, sms)
    g0 = max(1, min(sms, -(-n // 256)))
    # the smallest chunk that covers n in g0 blocks, and then as few blocks
    # of it as cover n: every block owns at least one row
    want_chunk = next(c for c in itertools.count(1) if g0 * c >= n)
    want_grid = next(g for g in itertools.count(1) if g * want_chunk >= n)
    assert (grid, chunk) == (want_grid, want_chunk)
    assert grid <= sms and (grid - 1) * chunk < n <= grid * chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_multi_plan_forms_vs_brute_force(monkeypatch, dtype):
    lib = _fake(monkeypatch, dtype)
    itemsize = 4 if dtype == torch.float32 else 8
    for n, offsets in ((100_000, (-1, 0, 1)), (100_000, (-2, -1, 0, 1, 2)),
                       (300_000, (-1, 0, 1)), (500_000, (-1, 0, 1)),
                       (300, (-150, 0, 150)), (300, (-151, 0, 151)),
                       (5, (-1, 0, 1))):
        plan = tr.multi_plan(_stencil(n, offsets, dtype), dtype,
                             torch.device("cpu"))
        h = max(abs(o) for o in offsets)
        for p in range(1, 10):      # p = 9: past the kernel's 8 columns
            state = (3 * (plan.chunk + 2 * h) + p * plan.chunk) * itemsize
            want = ("neighbour" if h <= plan.chunk and p <= 8
                    and state + NBR_STATIC <= OPTIN else "family")
            assert plan.form(p) == want, (n, offsets, p)
    # config #2: p = 4 on 132 blocks of 758 rows
    plan = tr.multi_plan(_stencil(100_000, (-1, 0, 1), dtype), dtype,
                         torch.device("cpu"))
    assert (plan.grid, plan.chunk, plan.form(4)) == (132, 758, "neighbour")
    lib.calls.clear()
    x = torch.ones(100_000, dtype=dtype)
    rows, cw = torch.ones((12, 4), dtype=dtype), torch.ones((12, 4),
                                                            dtype=dtype)
    launched = plan.nbr_launches
    W = plan(x, rows, cw)
    plan(x, rows, cw)
    assert W.shape == (100_000, 4) and plan.nbr_launches == launched + 2
    names = [c[0] for c in lib.calls]
    assert names == [f"eu_resident_multi_nbr_{_build.suffix(dtype)}"] * 2
    L = tr._NbrLaunch.from_address(lib.calls[0][1][0])
    assert (L.grid, L.chunk, L.h, L.k, L.n) == (132, 758, 1, 3, 100_000)
    (addr, _, flags, halo), = plan.nbr.values()
    assert lib.calls[1][1][0] == addr
    assert L.flags == flags.data_ptr() and flags.numel() == 132 * 16
    assert not flags.any() and halo.numel() == 4 * 132 * 1
    assert lib.calls[1][1][4:6] == (4, 12)


def test_multi_plan_family_launch(monkeypatch):
    lib = _fake(monkeypatch, torch.float64)
    op = _stencil(300, (-151, 0, 151))
    plan = tr.multi_plan(op, torch.float64, torch.device("cpu"))
    lib.calls.clear()
    _build.reset_launch_counts()
    x = torch.ones(300, dtype=torch.float64)
    W = plan(x, torch.ones((5, 4), dtype=torch.float64),
             torch.ones((5, 2), dtype=torch.float64))
    (name, args), = lib.calls
    assert name == "eu_resident_multi_f64" and W.shape == (300, 2)
    assert args[3] == 2 and args[6:9] == (3, 300, 5)
    (buf,) = plan.bufs.values()
    assert buf.numel() == 900 and args[10] == buf.data_ptr()
    assert _build.launches["resident_multi"] == 1 and plan.nbr_launches == 0
    with pytest.raises(ValueError):     # cw of another m
        plan(x, torch.ones((5, 4), dtype=torch.float64),
             torch.ones((4, 2), dtype=torch.float64))


def test_resident_plans_cached_and_rebuilt(monkeypatch):
    _fake(monkeypatch, torch.float64)
    op = _stencil(1000, (-1, 0, 1))
    cpu = torch.device("cpu")
    for make in (tr.lanczos_plan, tr.multi_plan):
        a = make(op, torch.float64, cpu)
        assert make(op, torch.float64, cpu) is a
        assert make(op, torch.float32, cpu) is not a
        op.coeffs = op.coeffs.clone()        # reassigned: a new plan
        b = make(op, torch.float64, cpu)
        assert b is not a and make(op, torch.float64, cpu) is b
    assert tr.lanczos_plan(op, torch.float64, cpu) is not tr.multi_plan(
        op, torch.float64, cpu)


def test_resident_plans_refuse_cpu():
    """With the real library, a plan for the CPU raises before any query."""
    op = _stencil(100, (-1, 0, 1))
    for cls in (tr.LanczosPlan, tr.MultiPlan):
        with pytest.raises(ValueError, match="launch plan"):
            cls(op, torch.float64, torch.device("cpu"))


def test_resident_plans_refuse_bad_operands(monkeypatch):
    _fake(monkeypatch, torch.float64)
    cpu = torch.device("cpu")
    for cls in (tr.LanczosPlan, tr.MultiPlan):
        with pytest.raises(ValueError):
            cls(_stencil(100, (-1, 0, 1)), torch.float16, cpu)
        with pytest.raises(ValueError):
            cls(et.laplacian_nd_stencil(8, 8), torch.float64, cpu)


def test_launch_descriptor_layouts():
    """The ctypes mirrors of eu::LanczosLaunch and eu::NbrLaunch (their
    static_asserts in csrc/resident_cluster.cu, csrc/resident_family.cu)."""
    L = tr._LanczosLaunch
    assert ctypes.sizeof(L) == 288
    assert (L.n.offset, L.rows.offset, L.cluster.offset, L.k.offset,
            L.o.offset) == (8, 16, 24, 28, 32)
    N = tr._NbrLaunch       # one descriptor for B1's, B4's and B5's form
    assert ctypes.sizeof(N) == 328
    assert (N.partials.offset, N.ticket.offset, N.n.offset, N.grid.offset,
            N.k.offset, N.kd.offset, N.o.offset) == (24, 32, 40, 48, 60, 64,
                                                     68)


def test_plans_take_a_forced_form(monkeypatch):
    """``MultiPlan(form="family")``: the family kernel whatever the size
    (the neighbour form is held bit for bit against it); any other form
    raises. B2's plan takes its form from the size alone."""
    _fake(monkeypatch, torch.float64)
    op = _stencil(100_000, (-1, 0, 1))
    cpu = torch.device("cpu")
    fam = tr.MultiPlan(op, torch.float64, cpu, form="family")
    assert [fam.form(p) for p in (1, 4, 8)] == ["family"] * 3
    with pytest.raises(ValueError):
        tr.MultiPlan(op, torch.float64, cpu, form="grid")
    with pytest.raises(TypeError):
        tr.LanczosPlan(op, torch.float64, cpu, form="grid")


@pytest.mark.parametrize("n,cls", [(100_000, tr.MultiPlan),
                                   (300_000, tr.LanczosPlan),
                                   (300, tr.MultiPlan)])
def test_resident_plans_keep_buffers_per_stream(monkeypatch, n, cls):
    """Flags, halos and scratch are kept per stream (launches on two
    streams may overlap), made once for each and reused by every later
    call on it. n = 3e5: B2's grid form; n = 300 with max|o| = 151: B4's
    family kernel."""
    lib = _fake(monkeypatch, torch.float64)
    streams = iter([11, 22, 11, 22, 11])
    monkeypatch.setattr(_build, "raw_stream", lambda device: next(streams))
    offsets = (-151, 0, 151) if n == 300 else (-1, 0, 1)
    plan = cls(_stencil(n, offsets), torch.float64, torch.device("cpu"))
    x = torch.ones(n, dtype=torch.float64)
    rows = torch.ones((6, 4), dtype=torch.float64)
    lib.calls.clear()
    for _ in range(5):
        plan(x, 6, 1e-7) if cls is tr.LanczosPlan else plan(x, rows, rows)
    held = {tr.LanczosPlan: "scratch", tr.MultiPlan: "nbr" if n > 300
            else "bufs"}[cls]
    assert sorted(getattr(plan, held)) == [11, 22]
    # the pointer an entry point gets: a descriptor (its flags) or a buffer
    where = {"scratch": 8, "nbr": 0, "bufs": 10}[held]
    launches = [args for name, args in lib.calls
                if name.startswith("eu_resident_")]
    ptrs = [args[where] for args in launches]
    assert [args[-1] for args in launches] == [11, 22, 11, 22, 11]
    assert ptrs[0] == ptrs[2] == ptrs[4] != ptrs[1] == ptrs[3]


# ------------------------------------------ B1 and B5 launch plans (host) --

def _banded_op(n, offsets, dtype=torch.float64):
    D = torch.linspace(0.5, 1.5, len(offsets) * n,
                       dtype=torch.float64).reshape(len(offsets), n)
    return et.BandedOperator(D.to(dtype), offsets, is_hermitian=True)


def test_nbr_smem_byte_counts():
    """The neighbour forms' layout: two omega spans of chunk + 2h (B1, B5:
    omega_{k+1} in place over omega_{k-1}; B4's kernel three), p accumulator
    rows, kd diagonal rows. At
    config #3 (n = 1e6 on 132 blocks of 7576 rows, h = 1000) float64 fits
    the state and no diagonal; float32 the state and four of the five."""
    assert tr.nbr_smem(7576, 1000, 1, 0, 8) == (2 * 9576 + 7576) * 8 == 213_824
    assert tr.nbr_smem(7576, 1000, 1, 0, 4) == 106_912
    assert tr.nbr_smem(7576, 1000, 1, 4, 4) == 228_128 <= OPTIN - NBR_STATIC
    assert tr.nbr_smem(7576, 1000, 1, 5, 4) > OPTIN - NBR_STATIC
    assert tr.nbr_smem(758, 1, 1, 0, 8) == (2 * 760 + 758) * 8     # config #2
    assert tr.nbr_smem(758, 1, 4, 0, 8, 3) == (3 * 760 + 4 * 758) * 8  # B4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recurrence_plan_forms_vs_brute_force(monkeypatch, dtype):
    """B1's form against the brute force: the neighbour form where max|o|
    is within a block's rows and two spans plus one accumulator row fit the
    opt-in shared memory, else the grid kernel; also when the card answers
    that fewer blocks fit than the grid needs."""
    lib = _fake(monkeypatch, dtype)
    itemsize = 4 if dtype == torch.float32 else 8
    cpu = torch.device("cpu")
    for n in (5, 1000, 100_000, 900_000, 1_200_000, 1_300_000, 2_500_000,
              2_600_000, 3_000_000):
        for offsets in ((-1, 0, 1), (-2, -1, 0, 1, 2)):
            if n < 1000 and len(offsets) == 5:
                continue
            plan = tr.RecurrencePlan(_stencil(n, offsets, dtype), dtype, cpu)
            h = max(abs(o) for o in offsets)
            state = (2 * (plan.chunk + 2 * h) + plan.chunk) * itemsize
            want = ("neighbour" if h <= plan.chunk
                    and state + NBR_STATIC <= OPTIN else "grid")
            assert plan.form == want, (n, offsets)
            assert plan.smem() == state
    for offsets in ((-150, 0, 150), (-151, 0, 151)):   # 2 blocks of 150
        plan = tr.RecurrencePlan(_stencil(300, offsets, dtype), dtype, cpu)
        assert plan.form == ("neighbour" if offsets[-1] == 150 else "grid")
    lib.returns[f"eu_nbr_capacity_{_build.suffix(dtype)}"] = (
        lambda kind, smem: 131)             # one block short of the grid
    assert tr.RecurrencePlan(_stencil(100_000, (-1, 0, 1), dtype), dtype,
                             cpu).form == "grid"
    assert tr.RecurrencePlan(_stencil(1000, (-1, 0, 1), dtype), dtype,
                             cpu).form == "neighbour"      # 4 blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_plan_forms_vs_brute_force(monkeypatch, dtype):
    """B5's form and kept diagonals against the brute force: the neighbour
    form where max|o| is within a block's rows and the state fits, with kd
    the most diagonals whose rows fit beside it, else the family kernel."""
    lib = _fake(monkeypatch, dtype)
    itemsize = 4 if dtype == torch.float32 else 8
    cpu = torch.device("cpu")
    for n, offsets in ((1200, (-30, -1, 0, 1, 30)), (90_000, (-300, -1, 0, 1,
                                                              300)),
                       (100_000, (-1, 0, 1)), (1_000_000, (-1000, -1, 0, 1,
                                                           1000)),
                       (1_300_000, (-1, 0, 1)), (3_000_000, (-1, 0, 1)),
                       (1000, (-300, 0, 300)), (1000, (-250, 0, 250)),
                       (7, (0,))):
        plan = tr.BandedRecurrencePlan(_banded_op(n, offsets, dtype), dtype,
                                       cpu)
        h, k = max(abs(o) for o in offsets), len(offsets)
        fit = [kd for kd in range(k + 1)
               if (2 * (plan.chunk + 2 * h) + (1 + kd) * plan.chunk)
               * itemsize + NBR_STATIC <= OPTIN]
        want = ("neighbour", max(fit)) if fit and h <= plan.chunk else (
            "family", 0)
        assert (plan.form, plan.kd) == want, (n, offsets)
    config3 = tr.BandedRecurrencePlan(
        _banded_op(1_000_000, (-1000, -1, 0, 1, 1000), dtype), dtype, cpu)
    assert (config3.grid, config3.chunk, config3.form, config3.kd) == (
        132, 7576, "neighbour", 4 if dtype == torch.float32 else 0)
    lib.returns[f"eu_nbr_capacity_{_build.suffix(dtype)}"] = (
        lambda kind, smem: 0 if kind == 2 else 132)     # B5's kernel
    assert tr.BandedRecurrencePlan(_banded_op(100_000, (-1, 0, 1), dtype),
                                   dtype, cpu).form == "family"


def test_recurrence_plan_launches(monkeypatch):
    """One ctypes call a launch: the neighbour form's descriptor (partials,
    and the ticket after the flags), the scale as a null pointer for 1 and
    a device pointer otherwise, w and the sum from torch.empty; the grid
    form's scratch and partials."""
    lib = _fake(monkeypatch, torch.float64)
    cpu = torch.device("cpu")
    op = _stencil(100_000, (-1, 0, 1))
    plan = tr.recurrence_plan(op, torch.float64, cpu)
    assert (plan.form, plan.grid, plan.chunk) == ("neighbour", 132, 758)
    x = torch.ones(100_000, dtype=torch.float64)
    rows = torch.ones((12, 4), dtype=torch.float64)
    _build.reset_launch_counts()
    lib.calls.clear()
    w, nrm = plan(x, rows)
    s = torch.tensor(0.5, dtype=torch.float64)
    plan(x, rows, s)
    assert w.shape == (100_000,) and nrm.shape == ()
    assert _build.launches["resident_recurrence"] == 2
    assert plan.nbr_launches == 2
    (n1, a1), (n2, a2) = lib.calls
    assert n1 == n2 == "eu_resident_recurrence_nbr_f64"
    assert a1[2] is None and a2[2] == s.data_ptr() and a1[4] == 12
    (addr, L, flags, halo, partials), = plan.nbr.values()
    assert a1[0] == a2[0] == addr
    assert flags.numel() == 132 * 16 + 1 and not flags.any()
    assert halo.numel() == 4 * 132
    assert L.ticket == flags.data_ptr() + 8 * 132 * 16     # own line
    assert L.partials == partials.data_ptr() and partials.numel() == 132
    assert (L.coef, L.k, L.kd, L.h) == (plan.cvals.data_ptr(), 3, 0, 1)
    grid = tr.RecurrencePlan(op, torch.float64, cpu, form="grid")
    lib.calls.clear()
    grid(x, rows, 2.0)
    (name, args), = lib.calls
    (buf, part), = grid.scratch.values()
    assert name == "eu_resident_recurrence_f64" and grid.nbr_launches == 0
    assert args[9] == buf.data_ptr() and buf.numel() == 300_000
    assert args[10] == part.data_ptr() and args[11] == grid.cap == 2048
    assert args[3] is not None and args[5:8] == (3, 100_000, 12)
    with pytest.raises(ValueError):
        tr.RecurrencePlan(op, torch.float64, cpu, form="family")
    with pytest.raises(ValueError):
        plan(x, rows, torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        plan(x.float(), rows)
    with pytest.raises(ValueError):
        plan(x, torch.ones((12, 3), dtype=torch.float64))


def test_banded_plan_launches(monkeypatch):
    lib = _fake(monkeypatch, torch.float32)
    cpu = torch.device("cpu")
    op = _banded_op(1_000_000, (-1000, -1, 0, 1, 1000), torch.float64)
    plan = tr.banded_plan(op, torch.float32, cpu)
    assert (plan.form, plan.kd) == ("neighbour", 4)
    assert plan.diags.dtype == torch.float32 and plan.diags.is_contiguous()
    x = torch.ones(1_000_000, dtype=torch.float32)
    rows = torch.ones((4, 4), dtype=torch.float32)
    lib.calls.clear()
    _build.reset_launch_counts()
    w = plan(x, rows)
    (name, args), = lib.calls
    assert name == "eu_resident_banded_nbr_f32" and w.shape == (1_000_000,)
    assert args[3] == 4 and plan.nbr_launches == 1
    L = tr._NbrLaunch.from_address(args[0])
    assert (L.coef, L.kd, L.h, L.k, L.grid, L.chunk) == (
        plan.diags.data_ptr(), 4, 1000, 5, 132, 7576)
    assert not L.partials and not L.ticket
    assert list(L.o[:5]) == [-1000, -1, 0, 1, 1000]
    fam = tr.BandedRecurrencePlan(op, torch.float32, cpu, form="family")
    lib.calls.clear()
    fam(x, rows)
    (name, args), = lib.calls
    (buf,), = [tuple(fam.bufs.values())]
    assert name == "eu_resident_banded_f32" and args[4:7] == (5, 1_000_000, 4)
    assert args[8] == buf.data_ptr() and buf.numel() == 3_000_000
    assert _build.launches["resident_banded"] == 2


def test_b1_b5_plans_cached_rebuilt_and_refuse_cpu(monkeypatch):
    """Kept per (dtype, device) on the operator, rebuilt when its
    coefficients or diagonals are reassigned; with the real library a plan
    for the CPU raises before any query."""
    cpu = torch.device("cpu")
    st, bd = _stencil(1000, (-1, 0, 1)), _banded_op(1000, (-1, 0, 1))
    for cls, op in ((tr.RecurrencePlan, st), (tr.BandedRecurrencePlan, bd)):
        with pytest.raises(ValueError, match="launch plan"):
            cls(op, torch.float64, cpu)
    _fake(monkeypatch, torch.float64)
    for make, op, attr in ((tr.recurrence_plan, st, "coeffs"),
                           (tr.banded_plan, bd, "diags")):
        a = make(op, torch.float64, cpu)
        assert make(op, torch.float64, cpu) is a
        assert make(op, torch.float32, cpu) is not a
        setattr(op, attr, getattr(op, attr).clone())    # reassigned
        b = make(op, torch.float64, cpu)
        assert b is not a and make(op, torch.float64, cpu) is b
    assert tr.recurrence_plan(st, torch.float64, cpu) is not tr.multi_plan(
        st, torch.float64, cpu)
    for cls, op in ((tr.RecurrencePlan, bd), (tr.BandedRecurrencePlan, st)):
        with pytest.raises(ValueError):
            cls(op, torch.float64, cpu)
    with pytest.raises(ValueError):
        tr.BandedRecurrencePlan(bd, torch.float16, cpu)


@pytest.mark.parametrize("case", ["B1 neighbour", "B1 grid", "B5 neighbour",
                                  "B5 family"])
def test_b1_b5_plans_keep_buffers_per_stream(monkeypatch, case):
    """Flags, halos, partials, tickets and scratch are kept per stream,
    made once for each and reused by every later call on it."""
    lib = _fake(monkeypatch, torch.float64)
    streams = iter([11, 22, 11, 22, 11])
    monkeypatch.setattr(_build, "raw_stream", lambda device: next(streams))
    cpu = torch.device("cpu")
    forced = case.endswith(("grid", "family")) or None
    if case.startswith("B1"):
        plan = tr.RecurrencePlan(_stencil(100_000, (-1, 0, 1)), torch.float64,
                                 cpu, form=forced and "grid")
        held, where = ("nbr", 0) if plan.form == "neighbour" else (
            "scratch", 9)
    else:
        plan = tr.BandedRecurrencePlan(_banded_op(100_000, (-1, 0, 1)),
                                       torch.float64, cpu,
                                       form=forced and "family")
        held, where = ("nbr", 0) if plan.form == "neighbour" else ("bufs", 8)
    assert plan.form == case.split()[1]
    x = torch.ones(100_000, dtype=torch.float64)
    rows = torch.ones((6, 4), dtype=torch.float64)
    lib.calls.clear()
    for _ in range(5):
        plan(x, rows)
    assert sorted(getattr(plan, held)) == [11, 22]
    ptrs = [args[where] for _, args in lib.calls]
    assert [args[-1] for _, args in lib.calls] == [11, 22, 11, 22, 11]
    assert ptrs[0] == ptrs[2] == ptrs[4] != ptrs[1] == ptrs[3]


# --------------------------------------------- B6's launch plan (host) --

def _grid_stencil(kind, shape, dtype=torch.float64):
    """The 5-point (2-D) / 7-point (3-D) Laplacian, the 9-point / 27-point
    box, or a 3-D stencil with |dz| = 2, on ``shape``."""
    d = len(shape)
    if kind == "star":
        offs = [(0,) * d] + [tuple(s if i == a else 0 for i in range(d))
                             for a in range(d) for s in (-1, 1)]
    elif kind == "box":
        offs = list(itertools.product((-1, 0, 1), repeat=d))
    else:           # "wide dz"
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (2, 0, 0), (-2, 0, 0),
                (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    return et.StencilOperator(shape, offs, np.linspace(-1.0, 1.0, len(offs)),
                              dtype=dtype)


GRID_SHAPES = [(512, 512), (1000, 1000), (7, 300), (64, 64, 64),
               (100, 100, 100), (5, 7, 9), (3, 4)]
# the 5-/7-point and box stencils on every shape, |dz| = 2 on the 3-D ones
GRID_CASES = [(shape, kind) for shape in GRID_SHAPES
              for kind in ("star", "box", "wide dz")
              if kind != "wide dz" or len(shape) == 3]


@pytest.mark.parametrize("shape,kind", GRID_CASES)
def test_grid_tiles_own_every_row_once_and_reach_every_point(shape, kind):
    """B6's tiles (132 SMs): at most one a SM, every grid line (so every
    row) owned by exactly one tile, and every point a tile's rows reach
    inside the grid lies in the tile or in a neighbour whose direction the
    tile waits for, within the spans' halo; no tile copies more halo lines
    than ``grid_halo_lines`` counts (the C side's table room)."""
    op = _grid_stencil(kind, shape)
    shape3, offs3 = tf._geometry(op)
    nz, ny, nx = shape3
    t = tr.grid_tiles(shape3, offs3, 132)
    dirs = tr.grid_dirs(offs3)
    assert 1 <= t.grid <= 132
    assert (t.hz, t.hy, t.hx) == tuple(max(abs(o[a]) for o in offs3)
                                       for a in range(3))
    assert t.tiles_z == -(-nz // t.tz) and t.tiles_y == -(-ny // t.ty)
    z, y = np.meshgrid(np.arange(nz), np.arange(ny), indexing="ij")
    owner = (z // t.tz) * t.tiles_y + y // t.ty     # block of each line
    assert np.bincount(owner.ravel(), minlength=t.grid).min() >= 1
    assert owner.max() == t.grid - 1                # each line once, all tiles
    halo = np.zeros(t.grid, dtype=int)
    for b in range(t.grid):
        mine = owner == b
        lines = set()
        for dz, dy, dx in offs3:
            assert abs(dx) <= t.hx
            qz, qy = z[mine] + dz, y[mine] + dy
            ok = (qz >= 0) & (qz < nz) & (qy >= 0) & (qy < ny)
            qz, qy = qz[ok], qy[ok]
            src = owner[qz, qy]
            a = src // t.tiles_y - b // t.tiles_y
            c = src % t.tiles_y - b % t.tiles_y
            assert (np.abs(a) <= 1).all() and (np.abs(c) <= 1).all()
            far = src != b
            assert all(dirs >> int(3 * (aa + 1) + cc + 1) & 1
                       for aa, cc in zip(a[far], c[far]))
            assert abs(dz) <= t.hz and abs(dy) <= t.hy
            lines |= set(zip(qz[far].tolist(), qy[far].tolist()))
        halo[b] = len(lines)
    assert halo.max() <= tr.grid_halo_lines(t, dirs)


def test_grid_geometry_and_shared_memory_bytes():
    """The tiles and bytes of the timed shapes (float64): the C side's
    grid_nbr_smem is 16 bytes a halo line plus two spans of (tz + 2 hz)
    (ty + 2 hy) lines of nx + 2 hx values and tz ty nx accumulator rows."""
    def plan_numbers(kind, shape):
        op = _grid_stencil(kind, shape)
        shape3, offs3 = tf._geometry(op)
        t = tr.grid_tiles(shape3, offs3, 132)
        lines = tr.grid_halo_lines(t, tr.grid_dirs(offs3))
        return t, lines, tr.grid_smem(t, shape3[2], 8, lines)

    t, lines, smem = plan_numbers("star", (512, 512))
    assert (t.tz, t.ty, t.grid, lines) == (1, 4, 128, 2)
    assert smem == 16 * 2 + (2 * 1 * 6 * 514 + 4 * 512) * 8 == 65_760
    t, lines, smem = plan_numbers("star", (1000, 1000))
    assert (t.tz, t.ty, t.grid, lines) == (1, 8, 125, 2)
    assert smem == 16 * 2 + (2 * 10 * 1002 + 8000) * 8 == 224_352
    t, lines, smem = plan_numbers("star", (64, 64, 64))
    assert (t.tz, t.ty, t.grid, lines) == (4, 8, 128, 24)
    assert smem == 16 * 24 + (2 * 6 * 10 * 66 + 2048) * 8 == 80_128
    t, lines, smem = plan_numbers("box", (64, 64, 64))
    assert lines == 28 and smem == 16 * 28 + (2 * 6 * 10 * 66 + 2048) * 8
    t, lines, smem = plan_numbers("star", (100, 100, 100))
    assert (t.tz, t.ty, t.grid, lines) == (8, 10, 130, 36)
    assert smem == 16 * 36 + (2 * 10 * 12 * 102 + 8000) * 8 == 260_416
    assert smem > OPTIN                 # float64 100^3: the family form


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_plan_forms_vs_brute_force(monkeypatch, dtype):
    """B6's form against the brute force: the neighbour form where a tile
    has at most 8192 rows and 4096 halo rows and its shared memory fits
    the opt-in, else the family kernel; also when the card answers that
    fewer blocks fit than there are tiles, and under form="family"."""
    lib = _fake(monkeypatch, dtype)
    itemsize = 4 if dtype == torch.float32 else 8
    cpu = torch.device("cpu")
    for kind, shape in (("star", (512, 512)), ("star", (1000, 1000)),
                        ("box", (64, 64, 64)), ("star", (100, 100, 100)),
                        ("box", (100, 100, 100)), ("wide dz", (7, 10, 20)),
                        ("star", (1146, 1146)), ("star", (1600, 1600)),
                        ("star", (3, 4))):
        op = _grid_stencil(kind, shape, dtype)
        plan = tr.GridRecurrencePlan(op, dtype, cpu)
        t = plan.tiles
        shape3, offs3 = tf._geometry(op)
        nx = shape3[2]
        lines = tr.grid_halo_lines(t, tr.grid_dirs(offs3))
        smem = (16 * lines + (2 * (t.tz + 2 * t.hz) * (t.ty + 2 * t.hy)
                              * (nx + 2 * t.hx) + t.tz * t.ty * nx) * itemsize)
        assert plan.smem == smem and plan.halo_lines == lines
        want = ("neighbour" if t.tz * t.ty * nx <= 8192
                and lines * nx <= 4096 and smem + NBR_STATIC <= OPTIN
                else "family")
        assert plan.form == want, (kind, shape)
        assert tr.GridRecurrencePlan(op, dtype, cpu,
                                     form="family").form == "family"
    op = _grid_stencil("star", (512, 512), dtype)
    assert tr.GridRecurrencePlan(op, dtype, cpu).form == "neighbour"
    lib.returns[f"eu_nbr_capacity_{_build.suffix(dtype)}"] = (
        lambda kind, smem: 127 if kind == 3 else 132)  # one short of 128 tiles
    assert tr.GridRecurrencePlan(op, dtype, cpu).form == "family"
    with pytest.raises(ValueError):
        tr.GridRecurrencePlan(op, dtype, cpu, form="grid")


def test_grid_launch_descriptor_layout():
    """The ctypes mirror of eu::GridLaunch (its static_assert in
    csrc/resident_family.cu)."""
    G = tr._GridLaunch
    assert ctypes.sizeof(G) == 856
    assert (G.n.offset, G.nz.offset, G.tiles_z.offset, G.tz.offset,
            G.hz.offset, G.hx.offset, G.dirs.offset, G.halo_lines.offset,
            G.k.offset, G.dz.offset, G.dy.offset, G.dx.offset) == (
        24, 32, 44, 52, 60, 68, 72, 76, 80, 84, 340, 596)


def test_grid_plan_refuses_cpu_and_bad_operands(monkeypatch):
    """With the real library a plan for the CPU raises before any query;
    a 1-D or complex stencil, a half-precision dtype and an unknown form
    raise too."""
    cpu = torch.device("cpu")
    op = _grid_stencil("star", (16, 12))
    with pytest.raises(ValueError, match="launch plan"):
        tr.GridRecurrencePlan(op, torch.float64, cpu)
    _fake(monkeypatch, torch.float64)
    for bad in (_stencil(100, (-1, 0, 1)), et.StencilOperator(
            (4, 4), [(0, 0)], np.asarray([1.0 + 1j]))):
        with pytest.raises(ValueError):
            tr.GridRecurrencePlan(bad, torch.float64, cpu)
    with pytest.raises(ValueError):
        tr.GridRecurrencePlan(op, torch.float16, cpu)


@pytest.mark.parametrize("form", ["neighbour", "family"])
def test_grid_plan_launches(monkeypatch, form):
    """One ctypes call a launch, through the descriptor of the stream: the
    neighbour form's flags (zeroed, one per 128-byte line) and publication
    buffer (a slot of tz ty nx rows a tile, two parities), or the family
    form's 3n scratch; w from torch.empty_like; kept per stream."""
    lib = _fake(monkeypatch, torch.float64)
    streams = iter([11, 22, 11])
    monkeypatch.setattr(_build, "raw_stream", lambda device: next(streams))
    cpu = torch.device("cpu")
    op = _grid_stencil("box", (64, 64, 64))
    plan = (tr.grid_plan(op, torch.float64, cpu) if form == "neighbour"
            else tr.GridRecurrencePlan(op, torch.float64, cpu, form="family"))
    assert plan.form == form
    assert tr.grid_plan(op, torch.float64, cpu) is tr.grid_plan(
        op, torch.float64, cpu)
    x = torch.ones(64 ** 3, dtype=torch.float64)
    rows = torch.ones((15, 4), dtype=torch.float64)
    _build.reset_launch_counts()
    lib.calls.clear()
    ws = [plan(x, rows) for _ in range(3)]
    assert all(w.shape == (64 ** 3,) for w in ws)
    assert _build.launches["resident_grid"] == 3
    assert plan.nbr_launches == (3 if form == "neighbour" else 0)
    names = {name for name, _ in lib.calls}
    assert names == {"eu_resident_grid_nbr_f64" if form == "neighbour"
                     else "eu_resident_grid_f64"}
    (a1, a2, a3) = (args for _, args in lib.calls)
    assert a1[0] == a3[0] != a2[0] and a1[3] == 15 and a1[-1] == 11
    assert sorted(plan.bufs) == [11, 22]
    addr, L, flags, buf = plan.bufs[11]
    assert (L.n, L.nz, L.ny, L.nx, L.k, L.coef) == (
        64 ** 3, 64, 64, 64, 27, plan.cvals.data_ptr())
    assert (L.tz, L.ty, L.tiles_z, L.tiles_y, L.hz, L.hy, L.hx) == tuple(
        plan.tiles)
    assert L.dirs == 0b111101111 and L.halo_lines == plan.halo_lines == 28
    assert list(L.dz[:3]) == [-1, -1, -1] and list(L.dx[:3]) == [-1, 0, 1]
    if form == "neighbour":
        assert flags.numel() == 128 * 16 and not flags.any()
        assert buf.numel() == 2 * 128 * 4 * 8 * 64
        assert (L.flags, L.pub) == (flags.data_ptr(), buf.data_ptr())
    else:
        assert flags is None and not L.flags and not L.pub
        assert buf.numel() == 3 * 64 ** 3 and a1[5] == buf.data_ptr()
    with pytest.raises(ValueError):
        plan(x.float(), rows)
    with pytest.raises(ValueError):
        plan(x, torch.ones((15, 3), dtype=torch.float64))


def test_grid_plan_rebuilt_when_coefficients_change(monkeypatch):
    _fake(monkeypatch, torch.float64)
    cpu = torch.device("cpu")
    op = _grid_stencil("star", (40, 50))
    a = tr.grid_plan(op, torch.float64, cpu)
    assert tr.grid_plan(op, torch.float32, cpu) is not a
    op.coeffs = op.coeffs.clone()
    b = tr.grid_plan(op, torch.float64, cpu)
    assert b is not a and tr.grid_plan(op, torch.float64, cpu) is b

"""The port's hand-written CUDA kernels against their plain twins on the
card, at small shapes. Marked ``cuda``: they skip without an NVIDIA GPU
and run on one with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
conftest imports JAX, which a GPU machine need not have).

Tolerances, relative to the output's max-norm: 1e-5 in float32 (sum order
and FMA contraction differ from the twin) and 1e-12 in float64."""

import contextlib
import ctypes
import itertools

import numpy as np
import pytest
import torch

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from exponentialutilities_jl_torch.utils.linop import LinearOperator
from tridiag_cases import case_tol, hard_cases

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, dt):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= RTOL[dt] * max(scale, 1e-300), (err, scale)


def _reset_counts():
    from exponentialutilities_jl_torch.utils import graphs
    _build.reset_launch_counts()
    graphs.reset_counts()


def _executions():
    """Kernel executions since ``_reset_counts``: the Krylov builders run
    from CUDA graphs, so host launches less the captured ones plus the
    captured ones times their replays (``utils/graphs.py``)."""
    from exponentialutilities_jl_torch.utils import graphs
    return graphs.kernel_executions(dict(_build.launches))


def _vec(n, dt, dev, seed):
    g = np.random.default_rng(seed).standard_normal(n)
    return torch.as_tensor(g, dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
def test_b1_b2_vs_twin(dev, dt):
    op = et.StencilOperator((1000,), [(-2,), (-1,), (0,), (1,), (2,)],
                            np.asarray([0.1, 1.0, -2.2, 1.0, 0.1]),
                            is_hermitian=True, dtype=dt, device=dev)
    x = _vec(1000, dt, dev, 0)
    rows = _vec(40, dt, dev, 1).reshape(10, 4) * 0.5
    offs = tr._flat_offsets(op)
    w, nrm = tr.resident_recurrence(op, x, rows, 0.7)
    wr, nrr = tr.resident_recurrence_ref(x, rows, op.coeffs, offs,
                                         torch.tensor(0.7, dtype=dt, device=dev))
    _close(w, wr, dt)
    _close(nrm.reshape(1), nrr.reshape(1), dt)
    v0 = x / torch.linalg.vector_norm(x)
    ab = tr.resident_lanczos(op, v0, 12, 1e-7)
    _close(ab, tr.resident_lanczos_ref(v0, op.coeffs, offs, 12, 1e-7), dt)
    assert torch.equal(ab, tr.resident_lanczos(op, v0, 12, 1e-7))


def _const_op(kind, dt, dev):
    """Constant operators of B3, ragged against its 16 x 32 column tiles
    and its z chunks: the 7-point Laplacian on 5 x 7 x 130, on 3 planes of
    700 x 900 (more column tiles than the card holds blocks, so all three
    planes form one chunk), on one plane as a 3-D grid, and 2-D; the
    halo-2 13-point star; the 27-point box (corners in every axis)."""
    if kind == "13pt":
        offs = [(0, 0, 0)] + [tuple(s if i == a else 0 for i in range(3))
                              for a in range(3) for s in (-2, -1, 1, 2)]
        cs = [-7.5] + [-1 / 12, 4 / 3, 4 / 3, -1 / 12] * 3
        return et.StencilOperator((7, 19, 45), offs, np.asarray(cs),
                                  is_hermitian=True, dtype=dt, device=dev)
    if kind == "27pt":
        offs = list(itertools.product((-1, 0, 1), repeat=3))
        cs = np.random.default_rng(12).standard_normal(27) * 0.15
        return et.StencilOperator((6, 21, 37), offs, cs, dtype=dt,
                                  device=dev)
    shape = {"7pt": (5, 7, 130), "nz3": (3, 700, 900), "nz1": (1, 33, 45),
             "2d": (9, 33)}[kind]
    return et.laplacian_nd_stencil(*shape, dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["7pt", "nz3", "nz1", "2d", "13pt", "27pt"])
def test_b3_vs_twin(dev, dt, kind):
    op = _const_op(kind, dt, dev)
    n = op.shape[0]
    Z, Vc, Vp, W = (_vec(n, dt, dev, s) for s in range(4))
    co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
    W1, W2 = W.clone(), W.clone()
    _build.reset_launch_counts()
    Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W1)
    assert (_build.launches["fused_sweep"], _build.launches["sweep_stage"]) \
        == (1, 1)
    mom = torch.stack([ypy, yzy])
    Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                       op.offsets, op.coeffs, W2)
    for a, b in ((Y, Yr), (Zn, Znr), (mom, momr), (W1, W2)):
        _close(a, b, dt)
    plain = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
    _close(plain[1], Znr, dt)
    assert torch.equal(mom, torch.stack(plain[2:]))
    _close(tf.stencil_matvec_fused(op, Z), op.matvec(Z), dt)
    if kind == "nz3":
        assert tf._plan(op, dt, Z.device).cz == 3


def _var_op(kind, dt, dev):
    """Variable-coefficient operators of B3-var: div(a grad u) in 3-D and
    2-D (Hermitian, boundary fields facing outside), and a wide (|o| = 2)
    non-symmetric 13-point one with random fields."""
    rng = np.random.default_rng(20)
    if kind == "diff3d":
        return et.variable_diffusion_nd_stencil(
            rng.uniform(0.5, 2.0, (5, 7, 130)), dtype=dt, device=dev)
    if kind == "diff2d":
        return et.variable_diffusion_nd_stencil(
            rng.uniform(0.5, 2.0, (9, 33)), dtype=dt, device=dev)
    offs = [(0, 0, 0)] + [tuple(s if i == a else 0 for i in range(3))
                          for a in range(3) for s in (-2, -1, 1, 2)]
    shape = (6, 9, 40)
    C = rng.uniform(0.2, 1.0, (len(offs), int(np.prod(shape))))
    return et.VariableStencilOperator(shape, offs, C, dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["diff3d", "diff2d", "wide3d"])
def test_b3_var_vs_twin(dev, dt, kind):
    op = _var_op(kind, dt, dev)
    n = op.shape[0]
    Z, Vc, Vp, W = (_vec(n, dt, dev, s) for s in range(4))
    co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
    W1, W2 = W.clone(), W.clone()
    _build.reset_launch_counts()
    Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W1)
    mom = torch.stack([ypy, yzy])
    Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                       op.offsets, op.coeff_fields, W2)
    for a, b in ((Y, Yr), (Zn, Znr), (mom, momr), (W1, W2)):
        _close(a, b, dt)
    plain = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
    _close(plain[1], Znr, dt)
    again = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
    assert torch.equal(mom, torch.stack(plain[2:]))
    assert torch.equal(torch.stack(again[2:]), torch.stack(plain[2:]))
    assert _build.launches["fused_sweep_var"] == 3
    assert _build.launches["fused_sweep"] == 0


LANCZOS_TOL = {torch.float32: 1e-4, torch.float64: 1e-7}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["7pt", "2d", "13pt", "diff3d", "diff2d"])
def test_b3_lanczos_two_launches_per_sweep(dev, dt, kind):
    """Pass 1 and the replay on the card: one sweep and one second stage
    per step (the stage computes the next sweep's scalars; executions,
    since a pass replays its step from a CUDA graph), the replay's alphas
    and betas bitwise equal to pass 1's, both against the drivers' CPU
    path on the same operator (float32 within 1e-4: the Krylov recurrence
    amplifies the sums' other order)."""
    if kind.startswith("diff"):
        op, cpu = _var_op(kind, dt, dev), _var_op(kind, dt, "cpu")
        name = "fused_sweep_var"
    else:
        op, cpu = _const_op(kind, dt, dev), _const_op(kind, dt, "cpu")
        name = "fused_sweep"
    n, m = op.shape[0], 12
    b = _vec(n, dt, dev, 31)
    c = _vec(m, dt, dev, 32) * 0.1
    _reset_counts()
    a, bt, b0, mu, br, _ = tf._lanczos_sweeps(op, b, m, LANCZOS_TOL[dt],
                                              what="pass 1")
    assert (_executions()[name], _executions()["sweep_stage"]) == \
        (m + 1, m + 1)
    ra, rb, _, rmu, _, w = tf._lanczos_sweeps(op, b, m, LANCZOS_TOL[dt], c,
                                              what="replay")
    assert (_executions()[name], _executions()["sweep_stage"]) == \
        (2 * m + 2, 2 * m + 2)
    assert torch.equal(ra, a) and torch.equal(rb, bt)
    assert int(rmu) == int(mu) == m and not bool(br)
    ca, cbt, _, cmu, _, cw = tf._lanczos_sweeps(
        cpu, b.cpu(), m, LANCZOS_TOL[dt], c.cpu(), what="cpu")
    tol = 1e-4 if dt == torch.float32 else 1e-10
    for got, want in ((a, ca), (bt, cbt), (w, cw)):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol * scale
    assert int(cmu) == m


def test_b3_var_fields_cast_once(dev):
    """float32 fields driven by float64 vectors: B3-var runs in float64 on
    a copy of the fields made once."""
    op = _var_op("diff3d", torch.float32, dev)
    n = op.shape[0]
    x = _vec(n, torch.float64, dev, 21)
    y = tf.stencil_matvec_fused(op, x)
    (copy,) = [c for _, c in op._casts.values()]
    tf.stencil_matvec_fused(op, x)
    (again,) = [c for _, c in op._casts.values()]
    assert again is copy and copy.dtype == torch.float64
    _close(y, op.matvec(x), torch.float64)


def test_var_and_arnoldi_paths_dispatch_to_kernels(dev):
    a = np.random.default_rng(22).uniform(0.5, 2.0, (12, 14, 16))
    op = et.variable_diffusion_nd_stencil(a, device=dev)
    assert td.recurrence_engine(op, torch.float64, device=dev,
                                hermitian=True) is tf.recurrence_apply_fused
    b = _vec(op.shape[0], torch.float64, dev, 23)
    _reset_counts()
    w1 = et.expv(0.05, op, b, m=20, two_pass=True)
    assert _executions()["fused_sweep_var"] == 42
    w2 = et.expv_chebyshev(0.05, op, b, tol=1e-12)
    assert float((w1 - w2).norm() / w1.norm()) < 1e-10
    adv = et.advection_diffusion_1d(500, device=dev)
    x = _vec(500, torch.float64, dev, 24)
    _reset_counts()
    w3 = et.expv(1e-5, adv, x, m=30)
    w4 = et.expv(1e-5, adv, x, m=30, iop=2, two_pass=True)
    assert _executions()["banded_spmv"] == 90
    assert bool(torch.isfinite(w3).all()) and bool(torch.isfinite(w4).all())


def _rows(m, op, dt, dev, seed):
    """Random recurrence rows with ca scaled by 1/|A| (bounded growth)."""
    rows = _vec(4 * m, dt, dev, seed).reshape(m, 4) * 0.5
    rows[:, 0] *= 2.0 / float(op.opnorm_hint())
    return rows


@pytest.mark.parametrize("dt", DTYPES)
def test_b4_vs_twin(dev, dt):
    op = et.StencilOperator((1000,), [(-2,), (-1,), (0,), (1,), (2,)],
                            np.asarray([0.1, 1.0, -2.2, 1.0, 0.1]),
                            is_hermitian=True, dtype=dt, device=dev)
    x = _vec(1000, dt, dev, 7)
    rows = _rows(10, op, dt, dev, 8)
    cw = _vec(40, dt, dev, 9).reshape(10, 4)
    W = tr.recurrence_apply_resident_multi(op, x, rows, cw)
    _close(W, tr.resident_multi_ref(x, rows, cw, op.coeffs,
                                    tr._flat_offsets(op)), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["poisson", "laplacian"])
def test_b5_vs_twin(dev, dt, kind):
    op = (et.poisson_2d(30, 40, dtype=dt, device=dev) if kind == "poisson"
          else et.laplacian_1d(1000, dtype=dt, device=dev))
    x = _vec(op.shape[0], dt, dev, 10)
    rows = _rows(10, op, dt, dev, 11)
    w = tr.recurrence_apply_resident_banded(op, x, rows)
    _close(w, tr.resident_banded_ref(x, rows, op.diags, op.offsets), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape,radius", [((33, 40), 1), ((5, 7, 13), 1),
                                          ((6, 9, 14), 0)])
def test_b6_vs_twin(dev, dt, shape, radius):
    if radius:      # box stencil: 9 points in 2-D, 27 in 3-D
        offs = list(itertools.product((-1, 0, 1), repeat=len(shape)))
        cs = np.random.default_rng(12).standard_normal(len(offs)) * 0.15
        op = et.StencilOperator(shape, offs, cs, dtype=dt, device=dev)
    else:
        op = et.laplacian_nd_stencil(*shape, dtype=dt, device=dev)
    x = _vec(op.shape[0], dt, dev, 13)
    rows = _rows(10, op, dt, dev, 14)
    w = tr.recurrence_apply_resident_grid(op, x, rows)
    _close(w, tr.resident_grid_ref(x, rows, op.grid_shape, op.offsets,
                                   op.coeffs), dt)


def test_main_path_dispatches_to_kernels(dev):
    op1 = et.laplacian_nd_stencil(2000, device=dev)
    op3 = et.laplacian_nd_stencil(6, 7, 8, device=dev)
    assert td.recurrence_engine(op1, torch.float64, device=dev) is \
        tr.recurrence_apply_resident
    # a grid this small keeps its state in L2: the one-launch B6
    assert td.recurrence_engine(op3, torch.float64, device=dev) is \
        tr.recurrence_apply_resident_grid
    _reset_counts()
    b1 = _vec(2000, torch.float64, dev, 5)
    b3 = _vec(op3.shape[0], torch.float64, dev, 6)
    w1 = et.expv_chebyshev(0.5, op1, b1, tol=1e-12)
    w2 = et.expv(0.5, op1, b1, m=30, two_pass=True)
    w3 = et.expv_chebyshev(0.05, op3, b3, tol=1e-12)
    w4 = et.expv(0.05, op3, b3, m=20, two_pass=True)
    counts = _executions()      # the fused passes replay their step
    assert counts["resident_recurrence"] == 2
    assert counts["resident_lanczos"] == 1
    assert counts["resident_grid"] == 1
    assert counts["fused_sweep"] == 2 * 21
    assert float((w1 - w2).norm() / w2.norm()) < 1e-10
    assert float((w3 - w4).norm() / w4.norm()) < 1e-10


def test_phi_path_dispatches_to_kernels(dev):
    op = et.laplacian_nd_stencil(2000, device=dev)
    b = _vec(2000, torch.float64, dev, 15)
    _build.reset_launch_counts()
    w1 = et.phiv(0.5, op, b, 3, m=40, two_pass=True)
    w2 = et.phiv_chebyshev(0.5, op, b, 3, tol=1e-12)
    w3 = et.phiv(0.5, op, b, 3, m=30)
    assert dict(_build.launches) == {
        "resident_recurrence": 0, "resident_lanczos": 1, "resident_multi": 2,
        "resident_banded": 0, "resident_grid": 0, "fused_sweep": 0,
        "fused_sweep_var": 0, "sweep_stage": 0, "banded_spmv": 0, "blockell_spmv": 0, "sell_spmv": 0,
        "seg_compact": 0, "tridiag_exp": 0, "banded_spmm": 0,
        "tridiag_exp_batched": 0, "resident_lanczos_batched": 0,
        "resident_recurrence_batched": 0, "banded_spmm_alpha": 0,
        "lanczos_update": 0}
    for w in (w1, w2):
        assert float((w - w3).norm() / w3.norm()) < 1e-10


def test_fused_true_wrong_dtype_raises(dev):
    op = et.laplacian_nd_stencil(6, 7, 8, device=dev)
    with pytest.raises(ValueError):
        td.recurrence_engine(op, torch.float16, fused=True, device=dev)


# ---- the sparse containers' SpMV kernels (B7-B10) -------------------------

def _banded_random(n, d, band, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), d)
    cols = np.clip(rows + rng.integers(-band // 2, band // 2, n * d), 0, n - 1)
    return rows, cols, rng.standard_normal(n * d) / d


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["poisson", "laplacian", "advection",
                                  "wide"])
def test_b7_vs_twin(dev, dt, kind):
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    if kind == "wide":           # offsets as wide as the vector
        rng = np.random.default_rng(20)
        op = et.BandedOperator(torch.as_tensor(rng.standard_normal((4, 50)),
                                               dtype=dt, device=dev),
                               (-49, -3, 0, 60))
    else:
        op = {"poisson": et.poisson_2d(30, 40, dtype=dt, device=dev),
              "laplacian": et.laplacian_1d(1000, dtype=dt, device=dev),
              "advection": et.advection_diffusion_1d(2000, dtype=dt,
                                                     device=dev)}[kind]
    x = _vec(op.shape[0], dt, dev, 21)
    _build.reset_launch_counts()
    y = op.matvec(x)
    assert _build.launches["banded_spmv"] == 1
    _close(y, tsp.banded_spmv_ref(op.diags, op.offsets, x), dt)
    assert torch.equal(y, op.matvec(x))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("br,bc", [(4, 4), (8, 8), (2, 3)])
def test_b8_vs_twin(dev, dt, br, bc):
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    n = 24 * br * bc
    A = sp.random(n, n, density=0.01, random_state=22, format="csr")
    op = et.blockell_from_scipy(A, br, bc, dtype=np.float64, device=dev)
    op.blocks = op.blocks.to(dt)
    x = _vec(n, dt, dev, 23)
    _build.reset_launch_counts()
    y = op.matvec(x)
    assert _build.launches["blockell_spmv"] == 1
    _close(y, tsp.blockell_spmv_ref(op.blocks, op.bcols, x), dt)
    want = torch.as_tensor(A @ x.double().cpu().numpy(), dtype=dt, device=dev)
    _close(y, want, dt)
    assert torch.equal(y, op.matvec(x))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode,band", [(None, 300), ("bucketed", 300),
                                       (None, 20000), ("seg", 300)])
def test_b9_b10_vs_twin(dev, dt, mode, band):
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts

    n = 30000 if band > 1000 else 3000
    rows, cols, vals = _banded_random(n, 8, band, 24)
    keep = ~np.isin(rows, [0, 5, n - 1])             # empty rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if mode == "seg":                                 # a few long rows
        long_rows = np.arange(0, n, 97)
        extra = np.repeat(long_rows, 40)
        ecols = extra + np.tile(np.arange(-20, 20), long_rows.size)
        rows = np.concatenate([rows, extra, extra[:3]])           # + dups
        cols = np.concatenate([cols, np.clip(ecols, 0, n - 1),
                               np.clip(ecols[:3], 0, n - 1)])
        vals = np.concatenate([vals, np.ones(extra.size + 3)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    op = et.SellOperator.from_coo(rows, cols, vals, n, dtype=np.float64,
                                  mode=mode, device=dev)
    op.data = op.data.to(dtype=dt)
    x = _vec(n, dt, dev, 25)
    _build.reset_launch_counts()
    y = op.matvec(x)
    seg = mode == "seg"
    assert _build.launches["sell_spmv"] == 1
    assert _build.launches["seg_compact"] == int(seg)
    ref = (ts.sell_spmv_seg_ref if seg else ts.sell_spmv_ref)(op.data, x)
    _close(y, ref, dt)
    want = torch.as_tensor(A @ x.double().cpu().numpy(), dtype=dt, device=dev)
    _close(y, want, dt)
    assert torch.equal(y, op.matvec(x))


def _sell_kinds(kind, deg, rng):
    """COO of the B9 staging cases, ``deg`` entries a row: every block's x
    window fits the budget ("narrow"), none does ("wide"), or both kinds of
    block ("mixed": a narrow band plus a few rows with one far column)."""
    if kind == "wide":
        return 30000, *_banded_random(30000, deg, 20000, 40)
    n = 20000
    rows, cols, vals = _banded_random(n, deg, 300, 41)
    if kind == "mixed":
        far = rng.choice(n, 6, replace=False)
        rows = np.concatenate([rows, far])
        cols = np.concatenate([cols, (far + n // 2) % n])
        vals = np.concatenate([vals, np.ones(far.size)])
    return n, rows, cols, vals


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["narrow", "wide", "mixed"])
@pytest.mark.parametrize("deg", [8, 20])
def test_b9_staging_branches(dev, dt, kind, deg):
    """B9 stages x per 256-row block where the block's spans fit the budget
    and gathers from global memory elsewhere; rows of 8 take 4 slots of
    loads in flight, rows of 20 take 16. The same pack with a staging
    budget of 0 gathers every block from global memory and gives the same
    bits."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts

    rng = np.random.default_rng(42)
    n, rows, cols, vals = _sell_kinds(kind, deg, rng)
    d = ts.sell_pack((rows, cols, vals), n, np.float64, device=dev).to(
        dtype=dt)
    wide = d.nslots >= ts.WIDE_ROWS * ts.SLICE * d.nslices
    assert wide == (deg > ts.WIDE_ROWS)
    staged = ts.stage_blocks(d)
    if kind == "narrow":
        assert bool(staged.all())
    elif kind == "wide":
        assert not bool(staged.any()) and d.stage_cap == 0
    else:
        assert 0 < int(staged.sum()) < staged.numel()
    x = _vec(n, dt, dev, 43)
    _build.reset_launch_counts()
    y = ts.sell_spmv(d, x)
    assert _build.launches["sell_spmv"] == 1
    _close(y, ts.sell_spmv_ref(d, x), dt)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _close(y, torch.as_tensor(A @ x.double().cpu().numpy(), dtype=dt,
                              device=dev), dt)
    assert torch.equal(y, ts.sell_spmv(d, x))
    g = ts.SellData(d.vals, d.cols, d.slice_ptr, d.row_of, d.n, d.nnz,
                    ncols=d.ncols, sigma=d.sigma,
                    derived=(d.nslots, d.spans, 0))
    assert not bool(ts.stage_blocks(g).any())
    assert torch.equal(y, ts.sell_spmv(g, x))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", [None, "bucketed", "seg"])
def test_b9_ragged_packs(dev, dt, mode):
    """Empty rows (a whole empty slice among them), n not a multiple of
    256, the bucketed and segmented packs, and a pack loaded from a file
    (spans derived on the card)."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts

    n = 3001
    rows, cols, vals = _banded_random(n, 6, 400, 44)
    keep = ~np.isin(rows, np.r_[64:96, 700, n - 1])
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    op = et.SellOperator.from_coo(rows, cols, vals, n, dtype=np.float64,
                                  mode=mode, device=dev)
    op.data = op.data.to(dtype=dt)
    x = _vec(n, dt, dev, 45)
    y = op.matvec(x)
    seg = mode == "seg"
    ref = (ts.sell_spmv_seg_ref if seg else ts.sell_spmv_ref)(op.data, x)
    _close(y, ref, dt)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _close(y, torch.as_tensor(A @ x.double().cpu().numpy(), dtype=dt,
                              device=dev), dt)
    assert torch.equal(y, op.matvec(x))
    base = op.data.base if seg else op.data
    f = base._fields()
    again = type(base)(*(f[k] for k in ("vals", "cols", "slice_ptr",
                                        "row_of")), base.n, base.nnz,
                       ncols=base.ncols, sigma=base.sigma)
    assert torch.equal(again.spans, base.spans)
    assert again.stage_cap == base.stage_cap
    assert torch.equal(ts.sell_spmv(again, x), ts.sell_spmv(base, x))


def _blockell_random(nbr, w, b, dt, dev, seed):
    """A random square (nbr, w, b, b) block-ELL operator, the w block
    columns of a block row distinct."""
    rng = np.random.default_rng(seed)
    bcols = np.stack([rng.choice(nbr, w, replace=False) for _ in range(nbr)])
    blocks = rng.standard_normal((nbr, w, b, b))
    return et.BlockELLOperator(torch.as_tensor(blocks, dtype=dt, device=dev),
                               torch.as_tensor(bcols, dtype=torch.int32,
                                               device=dev))


def _blockell_scipy(op):
    """The operator as a scipy BSR matrix (its block columns are distinct
    per block row)."""
    import scipy.sparse as sp

    nbr, w, br, bc = op.blocks.shape
    return sp.bsr_matrix((op.blocks.double().cpu().numpy().reshape(-1, br, bc),
                          op.bcols.cpu().numpy().ravel(),
                          np.arange(0, nbr * w + 1, w)),
                         shape=(nbr * br, nbr * br))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b", [8, 4])
@pytest.mark.parametrize("w", [1, 7, 40])
def test_b8_block_shapes(dev, dt, b, w):
    """B8's 8 x 8 and 4 x 4 kernels at w = 1, 7 and 40 (past the unrolled
    steps and one bcols load of 32), nbr not a multiple of the warps per
    block; an x or blocks that are not 16-byte aligned give the same bits
    (scalar loads, the same summation order)."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    op = _blockell_random(45, w, b, dt, dev, 46 + w)
    n = op.shape[0]
    x = _vec(n, dt, dev, 47)
    _build.reset_launch_counts()
    y = op.matvec(x)
    assert _build.launches["blockell_spmv"] == 1
    _close(y, tsp.blockell_spmv_ref(op.blocks, op.bcols, x), dt)
    want = _blockell_scipy(op) @ x.double().cpu().numpy()
    _close(y, torch.as_tensor(want, dtype=dt, device=dev), dt)
    assert torch.equal(y, op.matvec(x))
    # offset views (not 16-byte aligned) give the aligned copies' bits
    xo = torch.empty(n + 1, dtype=dt, device=dev)[1:].copy_(x)
    assert torch.equal(tsp.blockell_spmv(op.blocks, op.bcols, xo), y)
    bo = torch.empty(op.blocks.numel() + 1, dtype=dt, device=dev)[1:]
    bo = bo.view(op.blocks.shape).copy_(op.blocks)
    assert torch.equal(tsp.blockell_spmv(bo, op.bcols, xo), y)


def test_sparse_matvec_dtype_gate(dev):
    """Complex data on the card takes the plain path through the dtype
    gate; real float32/float64 data launches the kernel."""
    rows, cols, vals = _banded_random(500, 4, 40, 26)
    op = et.SellOperator.from_coo(rows, cols, vals, 500, dtype=np.complex128,
                                  device=dev)
    x = _vec(500, torch.float64, dev, 27).to(torch.complex128)
    _build.reset_launch_counts()
    op.matvec(x)
    et.poisson_2d(10, 10, device=dev).matvec(x[:100])
    assert _build.launches["sell_spmv"] == 0
    assert _build.launches["banded_spmv"] == 0
    et.poisson_2d(10, 10, device=dev).matvec(x[:100].real.float())
    assert _build.launches["banded_spmv"] == 1


def test_sell_path_dispatches_to_kernels(dev):
    """expv / phiv / expv_chebyshev on the SELL containers: one B9 launch
    per matvec (plus one B10 for the segmented pack), the sorted
    conjugation hoisted."""
    import scipy.sparse as sp

    n = 4000
    rows, cols, vals = _banded_random(n, 6, 200, 28)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A = (0.5 * (A + A.T)).tocoo()
    b = _vec(n, torch.float64, dev, 29)
    ws = {}
    for mode in (None, "seg", "sorted"):
        op = et.SellOperator.from_scipy(A, dtype=np.float64, mode=mode,
                                        is_hermitian=True, device=dev)
        _reset_counts()
        ws[mode] = et.expv(0.5, op, b, m=30)
        ex = _executions()
        assert ex["sell_spmv"] == 30
        assert ex["seg_compact"] == (30 if mode == "seg" else 0)
    for mode in ("seg", "sorted"):
        assert float((ws[mode] - ws[None]).norm() / ws[None].norm()) < 1e-12


def test_spmv_wrappers_refuse_mixed_dtypes(dev):
    """A launch never casts the matrix: a wrapper given storage in another
    dtype than the vector raises, and so does a pack whose arrays do not
    hold its slots."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    x = _vec(64, torch.float64, dev, 30)
    opP = et.poisson_2d(8, 8, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        tsp.banded_spmv(opP.diags, opP.offsets, x)
    A = sp.random(64, 64, density=0.1, random_state=31, format="csr")
    opB = et.blockell_from_scipy(A, 4, dtype=np.float32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        tsp.blockell_spmv(opB.blocks, opB.bcols, x)
    d = ts.sell_pack(_banded_random(64, 4, 10, 32), 64, np.float32,
                     device=dev)
    with pytest.raises(ValueError, match="float64"):
        ts.sell_spmv(d, x)
    with pytest.raises(ValueError, match="slots"):
        ts.sell_spmv(d.with_vals(d.vals[:-32]), x.float())


def test_promoted_storage_cast_once(dev):
    """float32 containers driven by float64 vectors launch their kernels
    in float64 on a copy of their storage made once, on the first matvec;
    ``use_pallas=False`` does not keep B8 from running on the card."""
    import scipy.sparse as sp

    n = 256
    A = sp.random(n, n, density=0.05, random_state=33, format="csr")
    x = _vec(n, torch.float64, dev, 34)
    B = et.blockell_from_scipy(A, 4, dtype=np.float32, device=dev)
    ops = {"banded_spmv": et.BandedOperator.from_dense(
               np.diag(np.arange(n, dtype=np.float32))
               + np.diag(np.ones(n - 1, np.float32), 1), device=dev),
           "blockell_spmv": et.BlockELLOperator(B.blocks, B.bcols,
                                                use_pallas=False),
           "sell_spmv": et.SellOperator.from_scipy(A, dtype=np.float32,
                                                   device=dev)}
    for name, op in ops.items():
        _build.reset_launch_counts()
        y = op.matvec(x)
        (copy,) = [c for _, c in op._casts.values()]
        op.matvec(x)
        assert _build.launches[name] == 2, name
        assert y.dtype == torch.float64, name
        (again,) = [c for _, c in op._casts.values()]
        assert again is copy, name


def _banded_case(kind, dt, dev):
    """(diags, offsets) of B7's ragged cases: n odd (the diagonals' rows
    not 16-byte aligned), n smaller than one block, offsets at least n
    wide, one diagonal, MAX_POINTS diagonals."""
    rng = np.random.default_rng(50)
    n, offs = {"odd": (5001, (-33, -1, 0, 1, 33)),
               "small": (100, (-7, 0, 2)),
               "wide": (777, (-900, -776, 0, 776, 1000)),
               "k1": (4096, (3,)),
               "kmax": (3000, tuple(range(-32, 32)))}[kind]
    D = torch.as_tensor(rng.standard_normal((len(offs), n)), dtype=dt,
                        device=dev)
    return D, offs


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["odd", "small", "wide", "k1", "kmax"])
def test_b7_ragged(dev, dt, kind):
    """B7 against its twin on ragged shapes; offset views of x and of the
    diagonals (scalar loads) give the aligned copies' bits, and so does an
    operator whose every block is an edge block (one zero diagonal of
    offset n appended: it adds exact zeros after the sum)."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    D, offs = _banded_case(kind, dt, dev)
    n = D.shape[1]
    op = et.BandedOperator(D, offs)
    x = _vec(n, dt, dev, 51)
    _build.reset_launch_counts()
    y = op.matvec(x)
    assert _build.launches["banded_spmv"] == 1
    _close(y, tsp.banded_spmv_ref(D, offs, x), dt)
    assert torch.equal(y, op.matvec(x))
    assert torch.equal(y, tsp.banded_spmv(D, offs, x))
    xo = torch.empty(n + 1, dtype=dt, device=dev)[1:].copy_(x)
    Do = torch.empty(D.numel() + 1, dtype=dt, device=dev)[1:]
    Do = Do.view(D.shape).copy_(D)
    assert torch.equal(tsp.banded_spmv(D, offs, xo), y)
    assert torch.equal(tsp.banded_spmv(Do, offs, xo), y)
    if len(offs) < _build.MAX_POINTS:
        Dz = torch.cat([D, torch.zeros_like(D[:1])])
        assert tsp.banded_interior(offs + (n,), n, 512) == (0, 0)
        assert torch.equal(tsp.banded_spmv(Dz, offs + (n,), x), y)


@pytest.mark.parametrize("dt", DTYPES)
def test_b10_ragged(dev, dt):
    """B10 on a pack with a row of 5000 one-entry segments, empty rows and
    n = 3001 (not a multiple of 256), against its twin and scipy; the
    pack's plan and the public entries give the same bits, and so does a
    repeat."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts

    n = 3001
    rows, cols, vals = _banded_random(n, 6, 400, 52)
    keep = ~np.isin(rows, np.r_[256:300, 1000, n - 1])
    rows = np.concatenate([rows[keep], np.full(5000, 700)])
    cols = np.concatenate([cols[keep], np.arange(5000) % n])
    vals = np.concatenate([vals[keep], np.ones(5000)])
    s = ts.sell_pack_seg((rows, cols, vals), n, np.float64, seg_len=1,
                         device=dev).to(dtype=dt)
    x = _vec(n, dt, dev, 53)
    _build.reset_launch_counts()
    y = ts.sell_spmv_seg(s, x)
    assert (_build.launches["sell_spmv"], _build.launches["seg_compact"]) \
        == (1, 1)
    _close(y, ts.sell_spmv_seg_ref(s, x), dt)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _close(y, torch.as_tensor(A @ x.double().cpu().numpy(), dtype=dt,
                              device=dev), dt)
    assert torch.equal(ts.sell_spmv_seg(s, x), y)
    assert torch.equal(ts.launch_plan(s)(x), y)
    assert torch.equal(ts.seg_compact(ts.sell_spmv(s.base, x), s.seg_ptr), y)


# ---- B2's cluster form and B4's neighbour form ----------------------------

def _stencil1(n, offsets, dt, dev):
    cs = np.random.default_rng(len(offsets)).uniform(0.5, 1.5, len(offsets))
    return et.StencilOperator((n,), [(o,) for o in offsets], cs,
                              is_hermitian=True, dtype=dt, device=dev)


THREE, FIVE = (-1, 0, 1), (-2, -1, 0, 1, 2)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,offsets", [
    (100_000, THREE), (100_000, FIVE),      # config #2, 16 x 6250 rows
    (1023, THREE), (16 * 1024 + 1, FIVE),   # n not a multiple of C x 1024
    (10, THREE), (3, THREE),                # n < C: blocks with no rows
    (32, (-2, 0, 2))])                      # max|o| = L = 2
@pytest.mark.parametrize("m", [0, 1, 40])
def test_b2_cluster_vs_twin(dev, dt, n, offsets, m):
    op = _stencil1(n, offsets, dt, dev)
    plan = tr.lanczos_plan(op, dt, dev)
    assert plan.form == "cluster"
    b = _vec(n, dt, dev, 21)
    v0 = b / torch.linalg.vector_norm(b)
    tol = 1e-7 if dt == torch.float64 else 1e-4
    ab = tr.resident_lanczos(op, v0, m, tol)
    want = tr.resident_lanczos_ref(v0, op.coeffs, list(offsets), m, tol)
    assert ab.shape == (m, 2)
    if m:
        # the twin sums in another order; float32 Lanczos drifts with m
        _close(ab, want, dt) if dt == torch.float64 else _close(
            ab[:12], want[:12], dt)
    assert torch.equal(ab, tr.resident_lanczos(op, v0, m, tol))


@pytest.mark.parametrize("dt", DTYPES)
def test_b2_cluster_breakdown_record(dev, dt):
    """An invariant start (two eigenvectors) breaks down after two steps:
    one live beta, zeros from the third row on."""
    n = 100_000
    i = np.arange(1, n + 1)
    b = torch.as_tensor(sum(np.sin(k * np.pi * i / (n + 1))
                            for k in (300, 4000)), dtype=dt, device=dev)
    op = et.laplacian_nd_stencil(n, dtype=dt, device=dev)
    assert tr.lanczos_plan(op, dt, dev).form == "cluster"
    tol = 1e-7 if dt == torch.float64 else 1e-4
    v0 = b / torch.linalg.vector_norm(b)
    ab = tr.resident_lanczos(op, v0, 40, tol)
    assert int((ab[:, 1] > 0).sum()) == 1 and not bool(ab[2:].any())
    _close(ab, tr.resident_lanczos_ref(v0, op.coeffs, tr._flat_offsets(op),
                                       40, tol), dt)


def test_b2_above_the_gate_runs_the_grid_form(dev):
    n = 300_000
    op = et.laplacian_nd_stencil(n, device=dev)
    assert tr.lanczos_plan(op, torch.float64, dev).form == "grid"
    b = _vec(n, torch.float64, dev, 22)
    v0 = b / torch.linalg.vector_norm(b)
    _build.reset_launch_counts()
    ab = tr.resident_lanczos(op, v0, 30, 1e-7)
    assert _build.launches["resident_lanczos"] == 1
    _close(ab, tr.resident_lanczos_ref(v0, op.coeffs, tr._flat_offsets(op),
                                       30, 1e-7), torch.float64)
    assert torch.equal(ab, tr.resident_lanczos(op, v0, 30, 1e-7))


@pytest.mark.parametrize("dt,n,form", [
    (torch.float64, 131_072, "cluster"), (torch.float64, 131_073, "grid"),
    (torch.float32, 368_000, "cluster"), (torch.float32, 368_001, "grid")])
def test_b2_at_the_gate(dev, dt, n, form):
    """Each side of the cluster form's row cap (8192 rows a block float64,
    8 a thread; 23,000 float32, 32 a thread) against the twin."""
    op = et.laplacian_nd_stencil(n, dtype=dt, device=dev)
    assert tr.lanczos_plan(op, dt, dev).form == form
    b = _vec(n, dt, dev, 33)
    v0 = b / torch.linalg.vector_norm(b)
    tol = 1e-7 if dt == torch.float64 else 1e-4
    ab = tr.resident_lanczos(op, v0, 40, tol)
    want = tr.resident_lanczos_ref(v0, op.coeffs, tr._flat_offsets(op), 40,
                                   tol)
    _close(ab, want, dt) if dt == torch.float64 else _close(ab[:12],
                                                           want[:12], dt)
    assert torch.equal(ab, tr.resident_lanczos(op, v0, 40, tol))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,offsets", [
    (100_000, THREE), (100_000, FIVE), (777, THREE), (777, FIVE),
    (300, (-150, 0, 150)),                 # max|o| = chunk (2 blocks of 150)
    (5, THREE)])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_b4_neighbour_equals_family(dev, dt, n, offsets, p):
    """The neighbour form gives the family kernel's bits (both call the
    same row functions), and agrees with the twin."""
    op = _stencil1(n, offsets, dt, dev)
    plan = tr.multi_plan(op, dt, dev)
    assert plan.form(p) == "neighbour"
    x = _vec(n, dt, dev, 23)
    rows = _rows(12, op, dt, dev, 24)
    cw = _vec(12 * p, dt, dev, 25).reshape(12, p)
    W = tr.recurrence_apply_resident_multi(op, x, rows, cw)
    again = tr.recurrence_apply_resident_multi(op, x, rows, cw)
    Wf = tr.MultiPlan(op, dt, dev, form="family")(x, rows, cw)
    assert torch.equal(W, Wf) and torch.equal(W, again)
    _close(W, tr.resident_multi_ref(x, rows, cw, op.coeffs, list(offsets)),
           dt)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_b4_neighbour_short_chains(dev, m):
    op = _stencil1(1000, THREE, torch.float64, dev)
    x = _vec(1000, torch.float64, dev, 26)
    rows = _rows(m, op, torch.float64, dev, 27)
    cw = _vec(3 * m, torch.float64, dev, 28).reshape(m, 3)
    W = tr.recurrence_apply_resident_multi(op, x, rows, cw)
    want = tr.resident_multi_ref(x, rows, cw, op.coeffs, list(THREE))
    assert torch.equal(W, torch.zeros_like(W)) if m == 0 else bool(
        (W - want).abs().max() <= 1e-12 * want.abs().max())


def test_config2_plans_take_the_new_forms(dev):
    op = et.laplacian_nd_stencil(100_000, device=dev)
    lp = tr.lanczos_plan(op, torch.float64, dev)
    mp = tr.multi_plan(op, torch.float64, dev)
    assert (lp.form, lp.cluster) in (("cluster", 16), ("cluster", 8))
    assert mp.form(4) == "neighbour"
    b = _vec(100_000, torch.float64, dev, 29)
    _build.reset_launch_counts()
    w = et.phiv(0.5, op, b, 3, m=40, two_pass=True)
    w2 = et.phiv(0.5, op, b, 3, m=30)
    assert _build.launches["resident_lanczos"] == 1
    assert _build.launches["resident_multi"] == 1
    assert float((w - w2).norm() / w2.norm()) < 1e-10


def test_b4_past_eight_columns_runs_the_family_kernel(dev):
    op = _stencil1(1000, THREE, torch.float64, dev)
    assert tr.multi_plan(op, torch.float64, dev).form(9) == "family"
    x = _vec(1000, torch.float64, dev, 30)
    rows = _rows(10, op, torch.float64, dev, 31)
    cw = _vec(90, torch.float64, dev, 32).reshape(10, 9)
    _close(tr.recurrence_apply_resident_multi(op, x, rows, cw),
           tr.resident_multi_ref(x, rows, cw, op.coeffs, list(THREE)),
           torch.float64)


def _b4_operands(n, p, m, dt, dev, seed):
    op = _stencil1(n, THREE, dt, dev)
    return (op, _vec(n, dt, dev, seed), _rows(m, op, dt, dev, seed + 1),
            _vec(m * p, dt, dev, seed + 2).reshape(m, p))


@pytest.mark.parametrize("n", [100_000, 300_000])
def test_b4_neighbour_on_two_streams(dev, n):
    """Launches of one plan on two streams, back to back and free to
    overlap, each with flags and halos of its own, give the bits of
    launches on one stream; so do later launches on the default stream."""
    op, x, rows, cw = _b4_operands(n, 4, 12, torch.float64, dev, 40)
    x2 = _vec(n, torch.float64, dev, 43)
    plan = tr.multi_plan(op, torch.float64, dev)
    assert plan.form(4) == "neighbour"
    want = [plan(x, rows, cw), plan(x2, rows, cw)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s, v in ((s1, x), (s2, x2)):
            with torch.cuda.stream(s):
                got.append(plan(v, rows, cw))
    torch.cuda.synchronize()
    for i, W in enumerate(got):
        assert torch.equal(W, want[i % 2]), i
    assert len(plan.nbr) == 3
    assert torch.equal(plan(x, rows, cw), want[0])


def test_resident_plans_replay_from_a_cuda_graph(dev):
    """A captured launch replays with the bits of an eager one: B4's
    neighbour form reads its flags' base on the card, so a replay, which
    passes the same arguments, waits for the right steps."""
    op, x, rows, cw = _b4_operands(100_000, 4, 12, torch.float64, dev, 44)
    v0 = x / torch.linalg.vector_norm(x)
    plan = tr.multi_plan(op, torch.float64, dev)
    assert plan.form(4) == "neighbour"
    want_w = plan(x, rows, cw)
    want_ab = tr.resident_lanczos(op, v0, 40, 1e-7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's buffers, made
        plan(x, rows, cw)           # outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        W = plan(x, rows, cw)
        ab = tr.resident_lanczos(op, v0, 40, 1e-7)
    for _ in range(3):
        W.zero_()
        ab.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(W, want_w) and torch.equal(ab, want_ab)


# ---- B1's and B5's neighbour forms ----------------------------------------

# one size past B1's neighbour gate per dtype: a block's state (two omega
# spans and one accumulator row of ~n/132 rows) exceeds its shared memory
B1_PAST_GATE = {torch.float32: 3_000_000, torch.float64: 1_500_000}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("size", ["1000", "1e5", "past the gate"])
def test_b1_neighbour_vs_twin_and_grid(dev, dt, size):
    """B1 with a scale other than 1 against its twin, and its neighbour
    form's w against the grid form's bit for bit (both call the same row
    functions; the sums of w^2 add in other orders)."""
    n = {"1000": 1000, "1e5": 100_000}.get(size, B1_PAST_GATE[dt])
    op = _stencil1(n, FIVE, dt, dev)
    plan = tr.recurrence_plan(op, dt, dev)
    assert plan.form == ("grid" if size == "past the gate" else "neighbour")
    x = _vec(n, dt, dev, 50)
    rows = _rows(12, op, dt, dev, 51)
    scale = torch.tensor(0.7, dtype=dt, device=dev)
    w, nrm = tr.resident_recurrence(op, x, rows, scale)
    wr, nrr = tr.resident_recurrence_ref(x, rows, op.coeffs, list(FIVE),
                                         scale)
    _close(w, wr, dt)
    _close(nrm.reshape(1), nrr.reshape(1), dt)
    wg, nrg = tr.RecurrencePlan(op, dt, dev, form="grid")(x, rows, scale)
    assert torch.equal(w, wg)
    _close(nrg.reshape(1), nrr.reshape(1), dt)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_b1_b5_short_chains(dev, m):
    """m = 0 gives zeros (and sum w^2 = 0), m = 1 and 2 the twins' w, on
    both kernels' neighbour forms."""
    op = _stencil1(1000, THREE, torch.float64, dev)
    x = _vec(1000, torch.float64, dev, 52)
    rows = _rows(m, op, torch.float64, dev, 53)
    w, nrm = tr.resident_recurrence(op, x, rows, 0.5)
    wr, nrr = tr.resident_recurrence_ref(x, rows, op.coeffs, list(THREE),
                                         torch.tensor(0.5, device=dev,
                                                      dtype=torch.float64))
    opb = et.poisson_2d(30, 40, device=dev)
    xb = _vec(1200, torch.float64, dev, 54)
    rb = _rows(m, opb, torch.float64, dev, 55)
    wb = tr.recurrence_apply_resident_banded(opb, xb, rb)
    wbr = tr.resident_banded_ref(xb, rb, opb.diags, opb.offsets)
    assert tr.recurrence_plan(op, torch.float64, dev).form == "neighbour"
    assert tr.banded_plan(opb, torch.float64, dev).form == "neighbour"
    if m == 0:
        assert not w.any() and float(nrm) == 0.0 and not wb.any()
    else:
        _close(w, wr, torch.float64)
        _close(nrm.reshape(1), nrr.reshape(1), torch.float64)
        _close(wb, wbr, torch.float64)


def test_b1_sum_bitwise_over_launches_and_graph_replays(dev):
    """Sum w^2 is summed by the last block in block order: five launches,
    and replays of a captured launch (whose ticket keeps counting), give
    the same bits."""
    op = _stencil1(100_000, THREE, torch.float64, dev)
    x = _vec(100_000, torch.float64, dev, 56)
    rows = _rows(12, op, torch.float64, dev, 57)
    plan = tr.recurrence_plan(op, torch.float64, dev)
    assert plan.form == "neighbour"
    outs = [plan(x, rows) for _ in range(5)]
    for w, nrm in outs[1:]:
        assert torch.equal(w, outs[0][0]) and torch.equal(nrm, outs[0][1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's buffers, made
        plan(x, rows)               # outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        w, nrm = plan(x, rows)
    for _ in range(3):
        w.zero_()
        nrm.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(w, outs[0][0]) and torch.equal(nrm, outs[0][1])


def test_b1_on_two_streams(dev):
    """Launches of one B1 plan on two streams, free to overlap, each with
    flags, halos, partials and a ticket of its own, give the bits of
    launches on one stream."""
    op = _stencil1(100_000, THREE, torch.float64, dev)
    x, x2 = (_vec(100_000, torch.float64, dev, s) for s in (58, 59))
    rows = _rows(12, op, torch.float64, dev, 60)
    plan = tr.recurrence_plan(op, torch.float64, dev)
    want = [plan(x, rows), plan(x2, rows)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s, v in ((s1, x), (s2, x2)):
            with torch.cuda.stream(s):
                got.append(plan(v, rows))
    torch.cuda.synchronize()
    for i, (w, nrm) in enumerate(got):
        assert torch.equal(w, want[i % 2][0]), i
        assert torch.equal(nrm, want[i % 2][1]), i
    assert len(plan.nbr) == 3


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["poisson 30x40", "poisson 300x300",
                                  "laplacian 1e5"])
def test_b5_neighbour_vs_twin_and_family(dev, dt, kind):
    """B5's neighbour form (poisson 300 x 300: 132 blocks of 682 rows with
    h = 300) against its twin, and bit for bit against the family kernel;
    five launches give the same bits."""
    op = {"poisson 30x40": lambda: et.poisson_2d(30, 40, dtype=dt,
                                                 device=dev),
          "poisson 300x300": lambda: et.poisson_2d(300, 300, dtype=dt,
                                                   device=dev),
          "laplacian 1e5": lambda: et.laplacian_1d(100_000, dtype=dt,
                                                   device=dev)}[kind]()
    plan = tr.banded_plan(op, dt, dev)
    assert plan.form == "neighbour"
    x = _vec(op.shape[0], dt, dev, 61)
    rows = _rows(12, op, dt, dev, 62)
    w = tr.recurrence_apply_resident_banded(op, x, rows)
    _close(w, tr.resident_banded_ref(x, rows, op.diags, op.offsets), dt)
    family = tr.BandedRecurrencePlan(op, dt, dev, form="family")
    assert family.form == "family" and torch.equal(w, family(x, rows))
    for _ in range(4):
        assert torch.equal(w, plan(x, rows))


def test_b5_offsets_wider_than_a_block_take_the_family_form(dev):
    """n = 1000 on 4 blocks of 250 rows, offsets +-300: the family kernel."""
    n = 1000
    D = np.random.default_rng(63).uniform(-1, 1, (3, n))
    D[0, :300] = D[2, n - 300:] = 0.0
    op = et.BandedOperator(torch.as_tensor(D, device=dev), (-300, 0, 300))
    plan = tr.banded_plan(op, torch.float64, dev)
    assert (plan.grid, plan.chunk, plan.form) == (4, 250, "family")
    x = _vec(n, torch.float64, dev, 64)
    rows = _rows(10, op, torch.float64, dev, 65)
    _build.reset_launch_counts()
    w = tr.recurrence_apply_resident_banded(op, x, rows)
    assert _build.launches["resident_banded"] == 1 and plan.nbr_launches == 0
    _close(w, tr.resident_banded_ref(x, rows, op.diags, op.offsets),
           torch.float64)


# ---- B6's neighbour form --------------------------------------------------

def _grid_op(kind, dt, dev):
    """B6's stencils on square and non-square grids: the 5-point and
    7-point Laplacians, the 9-point and 27-point boxes (random symmetric
    coefficients, c(o) = c(-o): a real spectrum, so Chebyshev rows stay
    bounded), and a 3-D stencil with |dz| = 2."""
    if kind.startswith(("2d 9pt", "3d 27pt")):
        shape = tuple(int(s) for s in kind.split()[-1].split("x"))
        offs = list(itertools.product((-1, 0, 1), repeat=len(shape)))
        half = np.random.default_rng(71).standard_normal(len(offs)) * 0.15
        cs = [half[min(j, len(offs) - 1 - j)] for j in range(len(offs))]
        return et.StencilOperator(shape, offs, np.asarray(cs), dtype=dt,
                                  device=dev)
    if kind.startswith("3d wide dz"):
        return et.StencilOperator(
            (7, 10, 20), ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (2, 0, 0),
                          (-2, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                          (0, 0, -1)),
            np.asarray([-4.0, 1.0, 1.0, 0.25, 0.25, 0.8, 0.8, 0.6, 0.6]),
            dtype=dt, device=dev)
    shape = tuple(int(s) for s in kind.split()[-1].split("x"))
    return et.laplacian_nd_stencil(*shape, dtype=dt, device=dev)


# 1000 x 1000: tiles of 8000 rows, the kernels with 8 rows a thread
GRID_KINDS = ["2d 5pt 64x64", "2d 5pt 300x200", "2d 5pt 1000x1000",
              "2d 9pt 50x71", "3d 7pt 16x16x16", "3d 7pt 9x20x33",
              "3d 27pt 12x13x14", "3d wide dz 7x10x20"]


def _cheb_rows(m, op, dt, dev, seed):
    """Chebyshev-U rows on [-|A|, |A|] (bounded chain) with weights
    decaying as 0.98^k, as a Chebyshev expansion's do: at m = 200 float32
    rounding then stays near 1e-6 of max|w| (undamped weights reach 7e-6
    on the CPU twin itself)."""
    hw = float(op.opnorm_hint())
    cw = np.random.default_rng(seed).standard_normal(m) * 0.98 ** np.arange(m)
    r = np.stack([np.full(m, 2.0 / hw), np.zeros(m), np.full(m, -1.0), cw], 1)
    if m:
        r[0, 2] = 0.0
    return torch.as_tensor(r.reshape(m, 4), dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", GRID_KINDS)
@pytest.mark.parametrize("m", [0, 1, 15, 200])
def test_b6_neighbour_vs_twin_and_family(dev, dt, kind, m):
    """B6's neighbour form against its twin, and bit for bit against the
    family kernel (both call the same row functions)."""
    op = _grid_op(kind, dt, dev)
    plan = tr.grid_plan(op, dt, dev)
    assert plan.form == "neighbour"
    x = _vec(op.shape[0], dt, dev, 72)
    rows = _cheb_rows(m, op, dt, dev, 73)
    launched = plan.nbr_launches
    w = tr.recurrence_apply_resident_grid(op, x, rows)
    assert plan.nbr_launches == launched + 1
    if m == 0:
        assert not w.any()
    else:
        _close(w, tr.resident_grid_ref(x, rows, op.grid_shape, op.offsets,
                                       op.coeffs), dt)
    family = tr.GridRecurrencePlan(op, dt, dev, form="family")
    assert family.form == "family" and torch.equal(w, family(x, rows))


def test_b6_neighbour_repeats_on_two_streams_and_graph_replays(dev):
    """Five launches give the same bits; launches on two streams, free to
    overlap, each with flags and a publication buffer of their own, give
    the bits of launches on one stream; three launches captured in one
    CUDA graph give them at every replay (the flags' base is read on the
    card)."""
    op = _grid_op("3d 27pt 12x13x14", torch.float64, dev)
    plan = tr.grid_plan(op, torch.float64, dev)
    x, x2 = (_vec(op.shape[0], torch.float64, dev, s) for s in (74, 75))
    rows = _cheb_rows(15, op, torch.float64, dev, 76)
    want = [plan(x, rows), plan(x2, rows)]
    for _ in range(4):
        assert torch.equal(plan(x, rows), want[0])
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s, v in ((s1, x), (s2, x2)):
            with torch.cuda.stream(s):
                got.append(plan(v, rows))
    torch.cuda.synchronize()
    for i, w in enumerate(got):
        assert torch.equal(w, want[i % 2]), i
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the capture stream's buffers, made
        plan(x, rows)               # outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        outs = [plan(v, rows) for v in (x, x2, x)]
    for _ in range(3):
        for w in outs:
            w.zero_()
        g.replay()
        torch.cuda.synchronize()
        for w, v in zip(outs, (want[0], want[1], want[0])):
            assert torch.equal(w, v)


@pytest.mark.parametrize("dt", DTYPES)
def test_b6_offset_view_of_x(dev, dt):
    """x an offset view into a larger buffer (not 16-byte aligned) gives
    the bits of an aligned copy."""
    op = _grid_op("2d 5pt 300x200", dt, dev)
    n = op.shape[0]
    big = _vec(n + 1, dt, dev, 77)
    view = big[1:]
    rows = _cheb_rows(15, op, dt, dev, 78)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(tr.recurrence_apply_resident_grid(op, view, rows),
                       tr.recurrence_apply_resident_grid(op, view.clone(),
                                                         rows))


@pytest.mark.parametrize("dt", DTYPES)
def test_b6_tiles_past_shared_memory_take_the_family_form(dev, dt):
    """100^3 in float64: a tile of 8 x 10 lines needs 256,000 bytes, more
    than a block's shared memory, so the plan takes the family kernel;
    float32 fits. Both agree with the twin."""
    op = et.laplacian_nd_stencil(100, 100, 100, dtype=dt, device=dev)
    plan = tr.grid_plan(op, dt, dev)
    assert (plan.tiles.tz, plan.tiles.ty, plan.tiles.grid) == (8, 10, 130)
    assert plan.form == ("family" if dt == torch.float64 else "neighbour")
    x = _vec(op.shape[0], dt, dev, 79)
    rows = _cheb_rows(12, op, dt, dev, 80)
    _build.reset_launch_counts()
    w = tr.recurrence_apply_resident_grid(op, x, rows)
    assert _build.launches["resident_grid"] == 1
    _close(w, tr.resident_grid_ref(x, rows, op.grid_shape, op.offsets,
                                   op.coeffs), dt)


def test_complex_b_on_a_cuda_stencil_takes_the_plain_path(dev):
    """A complex b on a real Hermitian stencil: the dtype gates send it to
    the plain passes (the recurrence kernels are real-only), nothing
    raises, and the result is the CPU run's (which scipy holds in
    tests/test_torch_expv.py). The reduced problem, a real tridiagonal,
    is R1's in each call (once a Lanczos step for the error estimate)."""
    n = 2000
    op = et.laplacian_nd_stencil(n, device=dev)
    op_cpu = et.laplacian_nd_stencil(n, device="cpu")
    g = np.random.default_rng(41)
    b = torch.as_tensor(g.standard_normal(n) + 1j * g.standard_normal(n))
    assert td.recurrence_engine(op, torch.complex128, device=dev) is None
    _build.reset_launch_counts()
    for kw in (dict(m=30), dict(m=30, two_pass=True),
               dict(m=40, mode="error_estimate")):
        w = et.expv(0.3, op, b.to(dev), **kw)
        assert w.dtype == torch.complex128
        want = et.expv(0.3, op_cpu, b, **kw)
        _close(w.cpu(), want, torch.float64)
    assert not any(v for k, v in _build.launches.items()
                   if k != "tridiag_exp")
    assert _build.launches["tridiag_exp"] >= 3


@pytest.mark.parametrize("driver", ["phiv_timestep", "kiops"])
def test_drivers_on_the_card_match_the_cpu(dev, driver):
    """The adaptive drivers on a small BandedOperator on the card take the
    CPU run's steps, with one B7 launch per matvec of the operator."""
    n, t = 400, 2e-3
    g = np.random.default_rng(42)
    b = g.standard_normal(n)
    B = np.stack([b, 0.1 * b], axis=1)
    runs = {}
    for where in (dev, "cpu"):
        op = et.advection_diffusion_1d(n, peclet=10.0, device=where)
        Bt = torch.as_tensor(B, device=where)
        _reset_counts()
        if driver == "kiops":
            runs[str(where)] = et.kiops([t / 2, t], op, Bt, tol=1e-7)
        else:
            runs[str(where)] = et.phiv_timestep([t / 2, t], op, Bt,
                                                adaptive=True, tol=1e-7,
                                                m=20, return_stats=True)
        if where == dev:
            launches = _executions()["banded_spmv"]
    (wg, sg), (wc, sc) = runs[str(dev)], runs["cpu"]
    assert (sg.steps, sg.rejections) == (sc.steps, sc.rejections)
    if driver == "kiops":
        assert (sg.krylov_steps, sg.exps, sg.last_m) == \
            (sc.krylov_steps, sc.exps, sc.last_m)
    else:
        assert (sg.matvecs, sg.final_m) == (sc.matvecs, sc.final_m)
        assert launches == sg.matvecs
    _close(wg.cpu(), wc, torch.float64)


# ---- non-symmetric stencils and the Leja/Faber/integrator paths ----------

def _nonsym_op(kind, dt, dev):
    """Non-symmetric constant operators: the 1-D advection-diffusion of
    benchmarks/bench_leja.py (scaled), a 5-point |o| = 2 variant, config
    #4's banded operator, a 2-D advection stencil (B6) and the 3-D
    advection-diffusion stencil on a grid ragged against B3's tiles."""
    if kind == "1d":
        return et.StencilOperator((3001,), ((-1,), (0,), (1,)),
                                  np.asarray([1.2, -2.2, 1.0]), dtype=dt,
                                  device=dev)
    if kind == "1d5":
        return et.StencilOperator((3001,), [(-2,), (-1,), (0,), (1,), (2,)],
                                  np.asarray([0.1, 1.3, -2.7, 1.0, 0.05]),
                                  dtype=dt, device=dev)
    if kind == "banded":
        return et.advection_diffusion_1d(2000, peclet=10.0, dtype=dt,
                                         device=dev)
    if kind == "2d":
        return et.StencilOperator((70, 90), [(0, 0), (0, 1), (0, -1), (1, 0),
                                             (-1, 0)],
                                  np.asarray([-4.6, 1.0, 1.6, 0.8, 1.2]),
                                  dtype=dt, device=dev)
    return et.advection_diffusion_3d_stencil(9, 21, 37, peclet=10.0,
                                             dtype=dt, device=dev)


_NONSYM_KINDS = ["1d", "1d5", "banded", "2d", "3d"]
# the launch counter of each engine
_COUNTER = {"recurrence_apply_resident": "resident_recurrence",
            "recurrence_apply_resident_banded": "resident_banded",
            "recurrence_apply_resident_grid": "resident_grid",
            "recurrence_apply_fused": "fused_sweep"}


def _poly_rows(kind_rows, op, m, dt, dev):
    """Newton rows (cc = 0) or Faber rows (cc_0 = 0, cc_1 = -2 rho) on the
    operator's Gershgorin interval / ellipse, random accumulation
    coefficients."""
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl

    cw = np.random.default_rng(81).standard_normal(m)
    if kind_rows == "newton":
        c, s = tl._interval_map(op, None)
        rows = tl._newton_rows(cw, tl.leja_points(m), c, 1.0 / s)
    else:
        c, _, _, g, rho = tfb._resolve_ellipse(op, None)
        rows = tfb._faber_rows(cw, c, 1.0 / g, rho)
    return torch.as_tensor(rows, dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("rows_kind", ["newton", "faber"])
@pytest.mark.parametrize("kind", _NONSYM_KINDS)
def test_nonsymmetric_engines_vs_twin(dev, dt, rows_kind, kind):
    """The engine of each non-symmetric operator (B6 for the small 3-D
    grid, whose state fits L2) and, on the 3-D grid, the B3 sweeps too."""
    op = _nonsym_op(kind, dt, dev)
    engines = [td.recurrence_engine(op, dt, device=dev, hermitian=False)]
    if kind == "3d":
        engines.append(tf.recurrence_apply_fused)
    x = _vec(op.shape[0], dt, dev, 82)
    rows = _poly_rows(rows_kind, op, 24, dt, dev)
    op_cpu = _nonsym_op(kind, dt, "cpu")
    for engine in engines:
        _reset_counts()
        w = engine(op, x, rows)
        key = _COUNTER[engine.__name__]
        ex = _executions()
        if key == "fused_sweep":    # 25 (sweep, stage) steps, replayed
            assert (ex[key], ex["sweep_stage"]) == (25, 25)
        else:
            assert ex[key] == 1
        _close(w.cpu(), engine(op_cpu, x.cpu(), rows.cpu()), dt)


def test_leja_faber_take_the_engines(dev):
    """expv_leja, expv_faber and phiv_leja on the card: the engine of each
    operator, one launch a pass, the CPU run's result."""
    g = np.random.default_rng(83)
    for kind in ("1d", "banded", "2d", "3d"):
        op = _nonsym_op(kind, torch.float64, dev)
        op_cpu = _nonsym_op(kind, torch.float64, "cpu")
        b = torch.as_tensor(g.standard_normal(op.shape[0]))
        c, s = et.models.leja._interval_map(op_cpu, None)
        t = 30.0 / s
        key = _COUNTER[td.recurrence_engine(
            op, torch.float64, device=dev, hermitian=False).__name__]
        for fn, kw in ((et.expv_leja, dict(tol=1e-10)),
                       (et.expv_faber, dict(tol=1e-10))):
            _reset_counts()
            w = fn(t, op, b.to(dev), fused=True, **kw)
            assert _executions()[key] >= 1
            _close(w.cpu(), fn(t, op_cpu, b, **kw), torch.float64)
        _reset_counts()
        W = et.phiv_leja(t / 2, op, b.to(dev), 1, tol=1e-10)
        if kind == "1d":        # one start vector, two columns: one B4
            assert _executions()["resident_multi"] == 1
        else:
            assert _executions()[key] == 2
        _close(W.cpu(), et.phiv_leja(t / 2, op_cpu, b, 1, tol=1e-10),
               torch.float64)


def test_nw_polynomial_drivers_launch_p1_passes_a_substep(dev):
    op = _nonsym_op("1d", torch.float64, dev)
    op_cpu = _nonsym_op("1d", torch.float64, "cpu")
    B = torch.as_tensor(np.random.default_rng(84).standard_normal((3001, 3)))
    c, s = et.models.leja._interval_map(op_cpu, None)
    t = 100.0 / s                                   # q = 3 at max_z = 40
    _reset_counts()
    U = et.phiv_timestep_leja(t, op, B.to(dev), tol=1e-8)
    assert _executions()["resident_recurrence"] == 3 * 3
    _close(U.cpu(), et.phiv_timestep_leja(t, op_cpu, B, tol=1e-8),
           torch.float64)
    _build.reset_launch_counts()
    U = et.phiv_timestep_faber(t, op, B.to(dev), tol=1e-8)
    assert _build.launches["resident_recurrence"] == 3       # q = 1
    _close(U.cpu(), et.phiv_timestep_faber(t, op_cpu, B, tol=1e-8),
           torch.float64)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["banded", "blockell", "sell", "seg"])
def test_jvp_through_spmv_kernels(dev, dt, kind):
    """torch.func.jvp through a container's kernel matvec: the kernel on
    the primal and on the tangent, equal to the twin's jvp."""
    import scipy.sparse as sp

    g = np.random.default_rng(85)
    n = 4096
    npdt = np.float64 if dt == torch.float64 else np.float32
    if kind == "banded":
        op = et.advection_diffusion_1d(n, dtype=dt, device=dev)
        cpu = et.advection_diffusion_1d(n, dtype=dt, device="cpu")
        key = "banded_spmv"
    else:
        A = (sp.random(n, n, density=4 / n, random_state=3)
             + sp.identity(n)).tocsr()
        if kind == "blockell":
            A = sp.kron(sp.random(n // 4, n // 4, density=2 / n,
                                  random_state=4) + sp.identity(n // 4),
                        np.ones((4, 4)), format="csr")
            make = lambda d: et.blockell_from_scipy(A, 4, dtype=npdt,
                                                    device=d)
            key = "blockell_spmv"
        else:
            mode = "seg" if kind == "seg" else None
            make = lambda d: et.SellOperator.from_scipy(
                A, mode=mode, dtype=npdt, device=d)
            key = "sell_spmv"
        op, cpu = make(dev), make("cpu")
    u = torch.as_tensor(g.standard_normal(n), dtype=dt)
    v = torch.as_tensor(g.standard_normal(n), dtype=dt)
    f = lambda x: op.matvec(x) + x ** 2
    f_cpu = lambda x: cpu.matvec(x) + x ** 2
    _build.reset_launch_counts()
    y, jv = torch.func.jvp(f, (u.to(dev),), (v.to(dev),))
    assert _build.launches[key] == 2
    y_cpu, jv_cpu = torch.func.jvp(f_cpu, (u,), (v,))
    _close(y.cpu(), y_cpu, dt)
    _close(jv.cpu(), jv_cpu, dt)
    J = et.JacobianOperator(op.matvec, u.to(dev))
    _close(J.matvec(v.to(dev)).cpu(), cpu.matvec(v), dt)


def test_fixed_step_integrators_are_sync_free(dev):
    """etdrk4_device and exprb43_device(adaptive=False) make no host read
    inside a step: their loops under sync debug mode "error" (the final
    finiteness check is outside)."""
    from exponentialutilities_jl_torch.models import integrators as ti

    n = 64
    lap = et.laplacian_nd_stencil(n, n, device="cpu")
    op, op_cpu = (et.StencilOperator(lap.grid_shape, lap.offsets,
                                     lap.host_coeffs * 1e-2,
                                     is_hermitian=True, device=d)
                  for d in (dev, "cpu"))
    u0 = torch.as_tensor(np.random.default_rng(86).standard_normal(n * n),
                         device=dev) * 0.1
    N = lambda u: u - u ** 3
    f = lambda u: op.matvec(u) + u - u ** 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ue = ti._etdrk4_scan(op, u0, 0.01, N=N, nsteps=2, m=12, iop=2,
                             expm_method="taylor")
        ur = ti._exprb43_scan(u0, 0.01, f=f, nsteps=2, m=12, iop=2,
                              expm_method="taylor")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    f_cpu = lambda u: op_cpu.matvec(u) + u - u ** 3
    _close(ue.cpu(), et.etdrk4_device(op_cpu, N, u0.cpu(), (0.0, 0.02), 0.01,
                                      m=12), torch.float64)
    _close(ur.cpu(), et.exprb43_device(f_cpu, u0.cpu(), (0.0, 0.02), 0.01,
                                       m=12), torch.float64)


# --- reverse mode through the kernel matvecs, the grad rule, DD bits

def test_b7_reverse_rule_vs_twin(dev):
    """B7's reverse rule (one B7 launch on the adjoint storage for the
    x-gradient, plain torch for the diagonals'): gradients of an expv
    through the kernel equal the plain twin's autograd at 1e-12."""
    n = 2000
    op0 = et.advection_diffusion_1d(n, peclet=10.0, device=dev)
    b0 = _vec(n, torch.float64, dev, 40)

    def grads(kernel_dev):
        D = op0.diags.to(kernel_dev).clone().requires_grad_()
        b = b0.to(kernel_dev).clone().requires_grad_()
        op = et.BandedOperator(D, op0.offsets)
        w = et.expv(1e-6, op, b, m=40, hermitian=False)
        return torch.autograd.grad((w ** 2).sum(), (D, b))

    _build.reset_launch_counts()
    gk = grads(dev)
    assert _build.launches["banded_spmv"] == 2 * 40
    gp = grads("cpu")
    for a, b in zip(gk, gp):
        _close(a.cpu(), b, torch.float64)


def test_sell_hermitian_x_gradient_through_b9(dev):
    import scipy.sparse as sp
    n = 3000
    R = sp.random(n, n, density=0.002, random_state=5)
    S = (R + R.T + sp.identity(n) * 4).tocsr()
    op = et.SellOperator.from_scipy(S, dtype=np.float64, device=dev,
                                    is_hermitian=True)
    x = _vec(n, torch.float64, dev, 41).requires_grad_()
    g = _vec(n, torch.float64, dev, 42)
    _build.reset_launch_counts()
    (gx,) = torch.autograd.grad(op.matvec(x), x, g)
    assert _build.launches["sell_spmv"] == 2
    want = torch.as_tensor(S.T @ g.cpu().numpy())
    _close(gx.cpu(), want, torch.float64)


def test_grad_rule_skips_recurrence_kernels(dev):
    op = et.laplacian_nd_stencil(4096, dtype=torch.float64, device=dev)
    b = _vec(4096, torch.float64, dev, 43).requires_grad_()
    _build.reset_launch_counts()
    w = et.expv_chebyshev(0.5, op, b)
    (g,) = torch.autograd.grad((w ** 2).sum(), b)
    assert sum(_build.launches.values()) == 0
    opc = et.laplacian_nd_stencil(4096, dtype=torch.float64, device="cpu")
    bc = b.detach().cpu().requires_grad_()
    (gc,) = torch.autograd.grad((et.expv_chebyshev(0.5, opc, bc) ** 2).sum(),
                                bc)
    _close(g.cpu(), gc, torch.float64)


def test_dd_bits_card_equal_cpu(dev):
    A = np.random.default_rng(44).standard_normal((24, 24)) / 4
    Xc = et.expm_dd(torch.as_tensor(A, device="cpu"))
    Xd = et.expm_dd(torch.as_tensor(A, device=dev))
    assert torch.equal(Xd.hi.cpu(), Xc.hi) and torch.equal(Xd.lo.cpu(), Xc.lo)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["7pt", "nz3", "13pt", "2d", "diff3d"])
def test_b3_plane_range_vs_twin(dev, dt, kind):
    """The moment plane range of B3 / B3-var (the sharded sweeps' interior
    planes): the moments over [z0, z1) against the twin's, Y and Zn bit for
    bit those of the default call, and the default range bit for bit the
    explicit whole range."""
    op = _var_op(kind, dt, dev) if kind == "diff3d" else \
        _const_op(kind, dt, dev)
    nz = tf._geometry(op)[0][0]
    zr = (1, nz - 1) if nz > 2 else (0, nz)
    n = op.shape[0]
    Z, Vc, Vp, W = (_vec(n, dt, dev, s) for s in range(4))
    co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
    cv = op.coeff_fields if kind == "diff3d" else op.coeffs
    W1, W2, W3 = W.clone(), W.clone(), W.clone()
    Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, op,
                                               w_accum=W1, z_range=zr)
    shape3, offs3 = tf._geometry(op)
    Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, shape3, offs3, cv, W2,
                                       z_range=zr)
    _close(torch.stack([ypy, yzy]), momr, dt)
    Yd, Znd, ypd, yzd, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, op,
                                                 w_accum=W3)
    assert torch.equal(Y, Yd) and torch.equal(Zn, Znd)
    assert torch.equal(W1, W3)
    full = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op,
                                 z_range=(0, nz))
    dflt = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
    assert torch.equal(torch.stack(full[2:]), torch.stack(dflt[2:]))
    with pytest.raises(RuntimeError):
        tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op,
                              z_range=(0, nz + 1))


class _SlabAxis:
    """A mesh axis of ``size`` ranks with no process group: what a rank's
    shard plan reads to lay out its extended slab."""

    def __init__(self, size, device):
        self.size, self.device = size, device

    def axis_size(self):
        return self.size


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("kind", ["7pt", "13pt", "advection", "2d",
                                  "diff3d"])
def test_b3_shard_slab_vs_twin(dev, dt, P, kind):
    """B3 / B3-var on a rank's extended slab as the sharded sweeps launch
    it (the plan classes' geometry: sz + 2 h0 planes, a 2-D grid as (sy +
    2 h0, 1, nx) with offsets (dy, 0, dx)), moments over the interior
    planes: Y, Zn, W and the moments against the twin, accumulating and
    plain."""
    from exponentialutilities_jl_torch.parallel import stencil_fused as sf

    ax = _SlabAxis(P, dev)
    if kind == "diff3d":
        gop = et.variable_diffusion_nd_stencil(
            np.random.default_rng(21).uniform(0.5, 2.0, (12, 7, 130)),
            dtype=dt, device=dev)
        plan = sf.FusedShardPlanVar(gop, ax)
        ext = et.VariableStencilOperator(
            plan.ext_shape, plan.ext_offsets,
            gop.coeff_fields[:, :plan.sze * plan.plane], gop.is_hermitian)
    else:
        if kind == "2d":
            gop = et.laplacian_nd_stencil(24, 77, dtype=dt, device=dev)
            plan = sf.FusedShardPlan2D(gop, ax)
        else:
            gop = (et.advection_diffusion_3d_stencil(12, 19, 45, dtype=dt,
                                                     device=dev)
                   if kind == "advection" else
                   _const_op("13pt", dt, dev) if kind == "13pt" else
                   et.laplacian_nd_stencil(12, 7, 130, dtype=dt, device=dev))
            if kind == "13pt":      # 7 planes do not split: 8 of them do
                gop = et.StencilOperator((8,) + gop.grid_shape[1:],
                                         gop.offsets, gop.coeffs,
                                         is_hermitian=True, device=dev)
            plan = sf.FusedShardPlan(gop, ax)
        ext = plan.ext
    zr = plan.z_range
    n = ext.shape[0]
    Z, Vc, Vp, W = (_vec(n, dt, dev, s) for s in range(4))
    co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
    W1, W2 = W.clone(), W.clone()
    Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, ext,
                                               w_accum=W1, z_range=zr)
    Yp, Znp, ypp, yzp = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(),
                                              ext, z_range=zr)
    Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, plan.ext_shape,
                                       plan.ext_offsets, tf._cvals(ext, dt),
                                       W2, z_range=zr)
    for got, want in ((Y, Yr), (Zn, Znr), (W1, W2), (Yp, Yr), (Znp, Znr),
                      (torch.stack([ypy, yzy]), momr),
                      (torch.stack([ypp, yzp]), momr)):
        _close(got, want, dt)


def test_sharded_two_pass_one_nccl_rank(dev, tmp_path):
    """A NCCL group of one rank: the sharded fused two-pass (B3 on the
    extended slab, the moments' all_reduce on the card) against the
    single-device two-pass, its passes free of host synchronization, and
    its launches and collectives held to the counts m implies."""
    import torch.distributed as dist

    from exponentialutilities_jl_torch import parallel as par
    from exponentialutilities_jl_torch.models.expv import (
        _expv_two_pass_fused, _lanczos_reduced_coeffs)
    from exponentialutilities_jl_torch.parallel import stencil_fused as sf

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = par.make_mesh(device="cuda:0")
        op = et.laplacian_nd_stencil(24, 20, 30, dtype=torch.float64,
                                     device=dev)
        b = _vec(op.shape[0], torch.float64, dev, 7)
        m = 20
        want = _expv_two_pass_fused(op, b, 0.05, m)
        w = par.expv_sharded(0.05, op, b, mesh, m=m, two_pass=True)
        _close(w, want, torch.float64)
        plan = sf.fused_shard_plan(op, mesh, hermitian=True)
        mesh.reset_census()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a, bb, b0, mu, _ = sf.lanczos_coeffs_fused_sharded(plan, b, m)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the reduced stage between the passes (R1) is not held here
        co = _lanczos_reduced_coeffs(a, bb, b0, 0.05)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a2, b2, _, _, _, out = sf._lanczos_sharded(plan, b, 0, 1e-7,
                                                       co)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(a, a2) and torch.equal(bb, b2)
        assert _build.launches["fused_sweep"] == 2 * (m + 1)
        assert _build.launches["sweep_stage"] == 4 * (m + 1)
        assert dict(mesh.census["shard"]) == {"psum": 2 * (m + 2),
                                              "ppermute": 2 * (m + 2)}
    finally:
        dist.destroy_process_group()


class _HaloAxis:
    """A mesh axis of ``size`` ranks with no process group: rank
    ``index``'s halos cut from the global vector ``x`` (zeros past the
    ends), what ``MeshAxis.ppermute_halo`` delivers."""

    def __init__(self, size, index, x):
        self.size, self.index, self.x = size, index, x
        self.device = x.device

    def axis_size(self):
        return self.size

    def axis_index(self):
        return self.index

    def ppermute_halo(self, lo, hi):
        h, nl = lo.shape[0], self.x.shape[0] // self.size
        a, b = self.index * nl, (self.index + 1) * nl
        below = self.x[a - h:a] if self.index > 0 else hi.new_zeros(h)
        above = (self.x[b:b + h] if self.index + 1 < self.size
                 else lo.new_zeros(h))
        return below.clone(), above.clone()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["poisson", "advection", "wide"])
def test_b7_halo_slab_vs_local_plain(dev, dt, kind):
    """The GSPMD route's banded product (``parallel.gspmd``): one B7 launch
    on each rank's halo-extended slab, against ``LocalBandedOperator``'s
    plain matvec on the same rows and the global operator's rows, for
    every rank of P = 4 (the two boundary slabs and the interior ones)."""
    from exponentialutilities_jl_torch.parallel import gspmd
    from exponentialutilities_jl_torch.parallel.ops import LocalBandedOperator

    if kind == "poisson":
        gop = et.poisson_2d(40, 24, dtype=dt, device=dev)
    elif kind == "advection":
        gop = et.advection_diffusion_1d(2000, peclet=10.0, dtype=dt,
                                        device=dev)
    else:                                   # offsets up to a whole slab
        n = 1024
        offs = (-256, -3, 0, 5, 256)
        D = _vec(len(offs) * n, dt, dev, 11).reshape(len(offs), n)
        gop = et.BandedOperator(D, offs)
    n = gop.shape[0]
    x = _vec(n, dt, dev, 12)
    yg = gop.matvec(x)
    P, nl = 4, n // 4
    for i in range(P):
        ax = _HaloAxis(P, i, x)
        sop = gspmd.ShardedBandedOperator(gop, ax)
        xl = x[i * nl:(i + 1) * nl]
        _build.reset_launch_counts()
        y = sop._local_matvec(xl)
        torch.cuda.synchronize()
        assert _build.launches["banded_spmv"] == 1
        lop = LocalBandedOperator(gop.diags[:, i * nl:(i + 1) * nl],
                                  gop.offsets, n, ax)
        _close(y, lop.matvec(xl), dt)
        _close(y, yg[i * nl:(i + 1) * nl], dt)


class _HopAxis(_HaloAxis):
    """``_HaloAxis`` whose exchanges come in rounds, each the next rows
    outward (a halo wider than a shard takes several): make one per
    slab."""

    def __init__(self, size, index, x):
        super().__init__(size, index, x)
        self.calls = self.depth = 0

    def _cut(self, i, j, like):
        out = like.new_zeros(j - i)
        a, b = max(i, 0), min(j, self.x.shape[0])
        if b > a:
            out[a - i:b - i] = self.x[a:b]
        return out

    def ppermute_halo(self, lo, hi):
        r, nl = lo.shape[0], self.x.shape[0] // self.size
        a, b = self.index * nl, (self.index + 1) * nl
        d = self.depth
        self.calls += 1
        self.depth += r
        return self._cut(a - d - r, a - d, hi), self._cut(b + d, b + d + r, lo)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["multi-hop", "adjoint"])
def test_b7_multi_hop_and_adjoint_slabs(dev, dt, kind):
    """One B7 launch on each rank's slab of a halo wider than a shard
    (poisson_2d(64, 2) at P = 4: h = 64 over 32 rows a rank, 2 exchanges)
    and on the adjoint slab of a non-Hermitian operator (the sharded
    reverse rule), against B7's twin on the same slab and the global
    rows."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    from exponentialutilities_jl_torch.parallel import gspmd

    if kind == "multi-hop":
        gop = et.poisson_2d(64, 2, dtype=dt, device=dev)
    else:
        gop = et.advection_diffusion_1d(256, peclet=10.0, dtype=dt,
                                        device=dev)
    n = gop.shape[0]
    x = _vec(n, dt, dev, 13)
    ref = gop.adjoint() if kind == "adjoint" else gop
    yg = tsp.banded_spmv_ref(ref.diags, ref.offsets, x)
    P, nl = 4, n // 4
    for i in range(P):
        sop = gspmd.ShardedBandedOperator(gop, _HopAxis(P, i, x))
        if kind == "adjoint":
            sop = sop._adjoint()
            sop.comm = _HopAxis(P, i, x)
        xl = x[i * nl:(i + 1) * nl]
        _build.reset_launch_counts()
        y = sop._local_matvec(xl)
        torch.cuda.synchronize()
        assert _build.launches["banded_spmv"] == 1
        assert sop.comm.calls == (2 if kind == "multi-hop" else 1)
        sop.comm = _HopAxis(P, i, x)
        h = sop.halo
        yt = tsp.banded_spmv_ref(sop.ext.diags, sop.offsets,
                                 sop._slab(xl))[h:h + nl]
        _close(y, yt, dt)
        _close(y, yg[i * nl:(i + 1) * nl], dt)


def test_shard_operator_one_rank_reverse(dev, tmp_path):
    """Reverse mode through a non-Hermitian sharded banded operator on a
    gloo group of one rank: B7 on the slab forward and on the adjoint slab
    backward (2m launches), the single-device gradient."""
    import torch.distributed as dist

    from exponentialutilities_jl_torch import parallel as par

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.make_mesh(device="cuda:0")
        f64 = torch.float64
        op = et.advection_diffusion_1d(512, peclet=10.0, dtype=f64,
                                       device=dev)
        b0 = _vec(512, f64, dev, 51)

        def grad(o, v):
            b = v.clone().requires_grad_()
            w = et.expv(1e-5, o, b, m=30, differentiable=True)
            (w ** 2).sum().backward()
            return b.grad

        want = grad(op, b0)
        sop = par.shard_operator(op, mesh)
        _build.reset_launch_counts()
        got = grad(sop, par.shard_vector(b0, mesh))
        torch.cuda.synchronize()
        assert _build.launches["banded_spmv"] == 2 * 30
        _close(got, want, f64)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dt", DTYPES)
def test_b8_rectangular_vs_twin(dev, dt):
    """B8 on a rank's block rows against the whole x (the GSPMD route's
    block-ELL product, a rectangular matrix), against its twin; bits
    independent of the operands' alignment."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    op = _blockell_random(48, 5, 8, dt, dev, 47)
    x = _vec(op.shape[0], dt, dev, 48)
    for lo, hi in ((0, 12), (12, 36), (36, 48)):
        B = op.blocks[lo:hi].contiguous()
        C = op.bcols[lo:hi].contiguous()
        _build.reset_launch_counts()
        y = tsp.blockell_spmv(B, C, x)
        assert _build.launches["blockell_spmv"] == 1
        assert y.shape == ((hi - lo) * 8,)
        _close(y, tsp.blockell_spmv_ref(B, C, x), dt)
        xo = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
        assert torch.equal(tsp.blockell_spmv(B, C, xo.copy_(x)), y)


def test_shard_operator_one_rank(dev, tmp_path):
    """A gloo group of one rank on the card: ``shard_operator``'s banded
    and block-ELL views run the ordinary ``expv`` with one B7 (B8) launch
    a Lanczos step, against the single-device call."""
    import torch.distributed as dist

    from exponentialutilities_jl_torch import parallel as par

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = par.make_mesh(device="cuda:0")
        f64 = torch.float64
        opP = et.poisson_2d(64, 48, dtype=f64, device=dev)
        opB = _blockell_random(64, 5, 8, f64, dev, 49)
        opB = et.BlockELLOperator(opB.blocks, opB.bcols, is_hermitian=False)
        for op, key, m in ((opP, "banded_spmv", 30),
                           (opB, "blockell_spmv", 20)):
            b = _vec(op.shape[0], f64, dev, 50)
            want = et.expv(1e-3, op, b, m=m)
            sop = par.shard_operator(op, mesh)
            _build.reset_launch_counts()
            w = et.expv(1e-3, sop, par.shard_vector(b, mesh), m=m)
            torch.cuda.synchronize()
            assert _build.launches[key] == m
            _close(w, want, f64)
    finally:
        dist.destroy_process_group()


# --- the device loops from CUDA graphs (utils/graphs.py) -------------------

def _graph_cells(dev):
    """The five device-resident programs on config #4's operator at n =
    400 (every matvec one B7) and on a 2-D stencil: {name: call}."""
    n, t = 400, 2e-3
    op = et.advection_diffusion_1d(n, peclet=10.0, device=dev)
    b = torch.as_tensor(np.random.default_rng(43).standard_normal(n),
                        device=dev)
    B = torch.stack([b, 0.1 * b], dim=1)
    lap = et.laplacian_nd_stencil(32, 32, device="cpu")
    op2 = et.StencilOperator(lap.grid_shape, lap.offsets,
                             lap.host_coeffs * 1e-2, is_hermitian=True,
                             device=dev)
    u2 = torch.as_tensor(np.random.default_rng(44).standard_normal(32 * 32),
                         device=dev) * 0.1

    def f(u):
        return op.matvec(u) - u ** 3

    return {
        "phiv_timestep_device": lambda: et.phiv_timestep_device(
            [t / 2, t], op, B, tol=1e-7, m=20, return_stats=True),
        "kiops_device": lambda: et.kiops_device([t / 2, t], op, B, tol=1e-7),
        "exprb43_device": lambda: et.exprb43_device(
            f, b * 0.1, (0.0, t), adaptive=True, m=12, rtol=1e-6,
            atol=1e-9, return_stats=True),
        "exprb32_device fixed": lambda: et.exprb32_device(
            f, b * 0.1, (0.0, t), t / 4, adaptive=False, m=12,
            return_stats=True),
        "etdrk4_device": lambda: (et.etdrk4_device(
            op2, lambda u: u - u ** 3, u2, (0.0, 0.04), 0.01, m=12), None),
    }


@pytest.mark.parametrize("name", ["phiv_timestep_device", "kiops_device",
                                  "exprb43_device", "exprb32_device fixed",
                                  "etdrk4_device"])
def test_graph_replays_equal_the_eager_steps(dev, name):
    """Each device loop from its CUDA graphs equals the same steps run
    eagerly to 1e-14, with identical stats; the graph run captured and
    replayed, the eager one did neither."""
    from exponentialutilities_jl_torch.utils import graphs

    call = _graph_cells(dev)[name]
    graphs.reset_counts()
    wg, sg = call()
    torch.cuda.synchronize()
    cg = dict(graphs.counts)
    graphs.reset_counts()
    with graphs.eager():
        we, se = call()
    ce = dict(graphs.counts)
    assert cg.get("captures", 0) >= 1 and cg.get("replays", 0) >= 1, cg
    assert not ce.get("captures") and not ce.get("replays"), ce
    assert sg == se
    err = float((wg - we).abs().max())
    assert err <= 1e-14 * float(we.abs().max()), err


def test_capture_of_a_reading_step_raises(dev):
    """A nonlinearity that reads the device (.item()) cannot be captured:
    the capture raises naming it, and the card works on after."""
    lap = et.laplacian_nd_stencil(16, 16, device="cpu")
    op = et.StencilOperator(lap.grid_shape, lap.offsets,
                            lap.host_coeffs * 1e-2, is_hermitian=True,
                            device=dev)
    u0 = torch.full((256,), 0.1, dtype=torch.float64, device=dev)

    def reads_the_device(u):
        return u * float(u.abs().max().item())

    with pytest.raises(RuntimeError, match="reads_the_device"):
        et.etdrk4_device(op, reads_the_device, u0, (0.0, 0.03), 0.01, m=8)
    torch.cuda.synchronize()
    assert float((u0 + 1).sum()) == pytest.approx(256 * 1.1)


@pytest.mark.parametrize("dt", DTYPES)
def test_b7_in_a_graph_vs_twin(dev, dt):
    """B7 captured into a CUDA graph: each replay reads the static x it
    was captured with (refilled between replays) and equals the twin."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    from exponentialutilities_jl_torch.utils import graphs

    op = et.advection_diffusion_1d(3001, peclet=10.0, dtype=dt, device=dev)
    x = _vec(3001, dt, dev, 7)
    y = torch.empty_like(x)

    def step():
        y.copy_(op.matvec(x))

    graphs.reset_counts()
    with graphs.LoopRunner("b7 graph", dev) as runner:
        for seed in range(4):
            x.copy_(_vec(3001, dt, dev, 100 + seed))
            runner.repeat(0, "matvec", step, 1)
            _close(y, tsp.banded_spmv_ref(op.diags, op.offsets, x), dt)
    assert graphs.counts["captures"] == 1 and graphs.counts["replays"] == 3
    assert graphs.kernel_executions({"banded_spmv": 2}) == \
        {"banded_spmv": 4}


# ---- the Krylov builders from CUDA graphs (ops/krylov.py) ----------------

def _builder_calls(op, b, m, win=2):
    """Each of the seven builders on (op, b) at m steps: name -> call."""
    from exponentialutilities_jl_torch.utils import graphs

    c = torch.linspace(1.0, 0.1, m, dtype=b.dtype, device=b.device)
    C = torch.stack([c, c.flip(0)], 1)
    with graphs.eager():
        rec = et.lanczos_coeffs(op, b, m)
        Hc = et.arnoldi_coeffs(op, b, m, win)[0]
        K2 = et.arnoldi(op, b, 2)
    return {
        "arnoldi": lambda: et.arnoldi(op, b, m),
        "arnoldi_extend": lambda: et.arnoldi_extend(op, K2, m + 2),
        "lanczos": lambda: et.lanczos(op, b, m, full_reorth=True),
        "lanczos_coeffs": lambda: et.lanczos_coeffs(op, b, m),
        "lanczos_replay": lambda: et.lanczos_replay(op, b, C, rec[0], rec[1],
                                                    m),
        "arnoldi_coeffs": lambda: et.arnoldi_coeffs(op, b, m, win),
        "arnoldi_replay": lambda: et.arnoldi_replay(
            op, b, c, Hc, m, win, final_coeff=0.5, with_final=True),
    }


def _flat(res):
    """The tensors of a builder's result, flattened to one float64 vector
    (m_used and breakdown kept apart)."""
    if isinstance(res, et.KrylovBasis):
        return (torch.cat([res.V.reshape(-1), res.H.reshape(-1),
                           res.beta.reshape(-1)]),
                (int(res.m_used), bool(res.breakdown)))
    if isinstance(res, tuple):
        fl = [t for t in res if t.is_floating_point()]
        rest = tuple(int(t) if t.dtype == torch.int32 else bool(t)
                     for t in res if not t.is_floating_point())
        return torch.cat([t.reshape(-1) for t in fl]), rest
    return res.reshape(-1), ()


@pytest.mark.parametrize("name", ["arnoldi", "arnoldi_extend", "lanczos",
                                  "lanczos_coeffs", "lanczos_replay",
                                  "arnoldi_coeffs", "arnoldi_replay"])
def test_builder_graph_vs_eager(dev, name, monkeypatch):
    """Each builder from its CUDA graph equals its steps run eagerly
    (graphs.eager()) to 1e-14 with equal m_used and breakdown: step 0
    before the runner, then one eager step, one capture and m - 2 graph
    launches (the captured execution is the first of them), B7 executed
    once a step, and the runner's graph freed when the call returns."""
    from exponentialutilities_jl_torch.utils import graphs

    m = 30
    op = et.advection_diffusion_1d(3001, peclet=10.0, device=dev)
    b = _vec(3001, torch.float64, dev, 60)
    call = _builder_calls(op, b, m)[name]
    steps = m                   # arnoldi_extend: from 2 to m + 2
    runners = []
    init = graphs.LoopRunner.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        runners.append(self)

    monkeypatch.setattr(graphs.LoopRunner, "__init__", record)
    _reset_counts()
    got = call()
    torch.cuda.synchronize()
    cg, ex = dict(graphs.counts), _executions()
    assert cg == {"eager_steps": 1, "captures": 1, "replays": steps - 2}, cg
    assert ex["banded_spmv"] == steps, ex
    assert len(runners) == 1 and runners[0].graphed
    assert not runners[0].graphs            # freed by the call's return
    _reset_counts()
    with graphs.eager():
        want = call()
    assert dict(graphs.counts) == {"eager_steps": steps - 1}
    gv, gr = _flat(got)
    wv, wr = _flat(want)
    assert gr == wr
    err = float((gv - wv).norm() / wv.norm())
    assert err <= 1e-14, err


def test_builder_small_m_runs_eagerly(dev):
    """m <= 3: the runner gets m - 1 <= 2 steps (step 0 runs before it), so
    no graph would run after the captured execution, and none is
    captured."""
    from exponentialutilities_jl_torch.utils import graphs

    op = et.advection_diffusion_1d(501, device=dev)
    b = _vec(501, torch.float64, dev, 61)
    for m in (1, 2, 3):
        _reset_counts()
        et.arnoldi(op, b, m)
        et.lanczos_coeffs(op, b, m)
        assert dict(graphs.counts) == ({"eager_steps": 2 * (m - 1)}
                                       if m > 1 else {}), m
    _reset_counts()
    et.arnoldi(op, b, 4)
    assert dict(graphs.counts) == {"eager_steps": 1, "captures": 1,
                                   "replays": 2}


@pytest.mark.parametrize("kind", ["blockell", "sell", "seg"])
def test_b8_b9_b10_in_builder_replays_vs_twin(dev, kind):
    """B8, B9 and B9 + B10 inside the replays of lanczos_coeffs and
    lanczos_replay: the two-pass record and result equal the same calls on
    the CPU (the plain twins) to 1e-12, and the eager form on the card
    to 1e-14; each kernel executed m times a pass."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.utils import graphs

    n, m = 4096, 16
    if kind == "blockell":
        A = sp.kron(sp.random(n // 8, n // 8, density=4 / n, random_state=62)
                    + sp.identity(n // 8), np.ones((8, 8)), format="csr")
        A = 0.5 * (A + A.T)
        make = lambda d: et.blockell_from_scipy(A, 8, dtype=np.float64,
                                                is_hermitian=True, device=d)
        keys = {"blockell_spmv": 2 * m}
    else:
        rows, cols, vals = _banded_random(n, 6, 300, 63)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        A = (0.5 * (A + A.T)).tocoo()
        mode = "seg" if kind == "seg" else None
        make = lambda d: et.SellOperator.from_scipy(
            A, dtype=np.float64, mode=mode, is_hermitian=True, device=d)
        keys = {"sell_spmv": 2 * m}
        if kind == "seg":
            keys["seg_compact"] = 2 * m
    op, cpu = make(dev), make("cpu")
    bnp = np.random.default_rng(64).standard_normal(n)
    b = torch.as_tensor(bnp, device=dev)

    def two_pass(o, v):
        a, bt, b0, mu, br = et.lanczos_coeffs(o, v, m)
        c = torch.linspace(1.0, 0.2, m, dtype=v.dtype, device=v.device)
        return a, bt, et.lanczos_replay(o, v, c, a, bt, m)

    _reset_counts()
    got = two_pass(op, b)
    torch.cuda.synchronize()
    ex = {k: v for k, v in _executions().items() if v}
    assert ex == keys, ex
    assert graphs.counts["captures"] == 2
    want = two_pass(cpu, torch.as_tensor(bnp))
    for g, w in zip(got, want):
        _close(g.cpu(), w, torch.float64)
    with graphs.eager():
        eag = two_pass(op, b)
    for g, w in zip(got, eag):
        assert float((g - w).norm() / w.norm()) <= 1e-14


class _ReadingOperator(et.LinearOperator):
    """A matvec that reads the device: it cannot be captured."""

    def __init__(self, op):
        self.op = op
        self.is_hermitian = True

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def matvec(self, x):
        return self.op.matvec(x) * float(x.abs().max().item() > -1.0)


def test_builder_capture_of_a_reading_matvec_raises(dev):
    """The capture fails and raises, naming the builder and the operator
    class; nothing falls back to the eager loop, and the card works on."""
    from exponentialutilities_jl_torch.utils import graphs

    op = _ReadingOperator(et.laplacian_nd_stencil(300, device=dev))
    b = _vec(300, torch.float64, dev, 65)
    _reset_counts()
    with pytest.raises(RuntimeError,
                       match=r"lanczos_coeffs \(_ReadingOperator\)"):
        et.lanczos_coeffs(op, b, 8)
    assert graphs.counts["eager_steps"] == 1        # the warm-up only
    torch.cuda.synchronize()
    with graphs.eager():
        a = et.lanczos_coeffs(op, b, 8)[0]
    assert bool(torch.isfinite(a).all())


def test_etdrk4_device_bitwise_with_the_builder_inline(dev):
    """Inside etdrk4_device's step the builder runs inline (no runner, no
    executions of its own), and the graph run equals the eager steps bit
    for bit."""
    from exponentialutilities_jl_torch.utils import graphs

    call = _graph_cells(dev)["etdrk4_device"]
    graphs.reset_counts()
    wg, _ = call()
    torch.cuda.synchronize()
    drivers = {w for (w, _, _) in graphs.executions}
    assert len(drivers) == 1 and drivers.pop().startswith("etdrk4_device")
    with graphs.eager():
        we, _ = call()
    assert torch.equal(wg, we)


def test_builder_requires_grad_makes_no_capture(dev):
    """A start vector that requires grad: step 0's state shows it, so the
    steps run eagerly on the caller's stream (no runner, no capture) and
    backward runs through B7's rule."""
    from exponentialutilities_jl_torch.utils import graphs

    op = et.advection_diffusion_1d(1001, peclet=10.0, device=dev)
    b = _vec(1001, torch.float64, dev, 66).requires_grad_()
    _reset_counts()
    K = et.arnoldi(op, b, 12, iop=2)
    assert not graphs.counts
    (g,) = torch.autograd.grad(K.V.sum(), b)
    assert bool(torch.isfinite(g).all())
    with torch.no_grad():
        K2 = et.arnoldi(op, b.detach(), 12, iop=2)
    assert float((K.V.detach() - K2.V).norm() / K2.V.norm()) <= 1e-14


def test_builder_graphs_reuse_one_memory_pool(dev):
    """Every runner captures into one memory pool on one side stream: a
    hundred builder calls after the first few reserve no more device
    memory (a pool of its own per call stayed reserved until an
    allocation failed, and inside a capture none can be freed)."""
    op = et.advection_diffusion_1d(100_000, peclet=10.0, device=dev)
    b = _vec(100_000, torch.float64, dev, 67)
    for _ in range(3):
        et.lanczos_coeffs(op, b, 8)
        et.arnoldi(op, b, 6, iop=2)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved()
    for _ in range(100):
        et.lanczos_coeffs(op, b, 8)
        et.arnoldi(op, b, 6, iop=2)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == held


@pytest.mark.parametrize("two_pass", [False, True])
def test_builder_grad_through_a_parameter_in_a_closure(dev, two_pass):
    """A matrix-free operator whose function closes over a parameter p
    (x -> p B7(x)): no tensor the builders are given requires grad, but
    step 0's state does, so no runner opens and backward reaches p. expv
    and the two-pass expv, value and d/dp, against the same calls on the
    CPU to 1e-12, and d/dp against sum(t A exp(t p A) b) from the value."""
    from exponentialutilities_jl_torch.utils import graphs

    n, t, p0 = 501, 1e-5, 0.9
    ws, gs = {}, {}
    for where in (dev, "cpu"):
        ban = et.advection_diffusion_1d(n, peclet=0.0 if two_pass else 10.0,
                                        device=where)
        p = torch.tensor(p0, dtype=torch.float64, device=where,
                         requires_grad=True)
        op = et.MatrixFreeOperator(lambda x, ban=ban, p=p: p * ban.matvec(x),
                                   (n, n), is_hermitian=two_pass,
                                   device=where)
        b = _vec(n, torch.float64, where, 68)
        _reset_counts()
        w = et.expv(t, op, b, m=30, two_pass=two_pass)
        if where == dev:
            assert not graphs.counts
            assert _executions()["banded_spmv"] == (60 if two_pass else 30)
        (g,) = torch.autograd.grad(w.sum(), p)
        ws[str(where)], gs[str(where)] = w.detach().cpu(), float(g)
        want = float(t * ban.matvec(w.detach()).sum())
        assert abs(float(g) - want) <= 1e-8 * abs(want), (float(g), want)
    _close(ws[str(dev)], ws["cpu"], torch.float64)
    assert abs(gs[str(dev)] - gs["cpu"]) <= 1e-12 * abs(gs["cpu"])


def test_live_runner_graphs_interleave_with_another_capture(dev):
    """Two runners alive at once share one memory pool: runner a's graph,
    replayed after runner b captured into the pool (and between b's
    replays), still computes a's step, and b's computes b's; both equal
    the same steps run eagerly, bit for bit. Each step makes temporaries
    that a later capture may reuse."""
    from exponentialutilities_jl_torch.utils import graphs

    def make(n, seed):
        x = _vec(n, torch.float64, dev, seed)

        def step_a():
            x.copy_(torch.sin(x + 1.0) * 2.0 + x.roll(1) * 0.5)

        def step_b():
            x.copy_(torch.cos(x) + x.sum() * 1e-3 + x.flip(0) * 0.25)

        return x, step_a, step_b

    def run(eager_form):
        xa, step_a, _ = make(4096, 69)
        xb, _, step_b = make(1000, 70)
        ctx = graphs.eager() if eager_form else contextlib.nullcontext()
        with ctx, graphs.LoopRunner("a", dev) as ra:
            ra.repeat(0, "a", step_a, 3)            # warm-up, capture
            with graphs.LoopRunner("b", dev) as rb:
                rb.repeat(0, "b", step_b, 3)
                for _ in range(5):
                    ra.repeat(0, "a", step_a, 1)
                    rb.repeat(0, "b", step_b, 2)
            ra.repeat(0, "a", step_a, 2)
        torch.cuda.synchronize()
        return xa.clone(), xb.clone()

    graphs.reset_counts()
    ga, gb = run(False)
    assert graphs.counts["captures"] == 2
    assert graphs.counts["replays"] == 2 + 5 + 2 + 2 + 10
    ea, eb = run(True)
    assert torch.equal(ga, ea) and torch.equal(gb, eb)


# --- R1 and the serving programs (ops/kernels/tridiag.py, graphs.Program) --

def _tridiag(m, dt, dev, seed, tail=0):
    """A random real symmetric tridiagonal (alphas, betas (m - 1)) of
    norm ~4 with its last ``tail`` rows masked to zero (a breakdown)."""
    g = np.random.default_rng(seed)
    a = -np.abs(g.standard_normal(m)) * 2
    b = np.abs(g.standard_normal(max(m - 1, 0)))
    if tail:
        a[m - tail:] = 0.0
        b[m - tail - 1:] = 0.0
    return (torch.as_tensor(a, dtype=dt, device=dev),
            torch.as_tensor(b, dtype=dt, device=dev))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m,tail", [(1, 0), (2, 0), (20, 0), (40, 0),
                                    (60, 0), (250, 0), (400, 0), (40, 37)])
def test_r1_vs_twin(dev, dt, m, tail):
    """R1 against its eigh twin: real and complex t, with and without s,
    its workspace in shared memory (m <= 250) and in the global scratch
    (m = 400); a breakdown at j = 3 (the masked zero tail) leaves the tail
    exactly 0."""
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    a, b = _tridiag(m, dt, dev, 71 + m, tail)
    s = torch.tensor(1.7, dtype=dt, device=dev)
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128
    for t in (torch.tensor(0.6, dtype=dt, device=dev),
              torch.tensor(0.6 - 0.8j, dtype=cdt, device=dev)):
        for sc in (None, s):
            _build.reset_launch_counts()
            got = tt.tridiag_exp_e1(a, b, t, sc)
            assert _build.launches["tridiag_exp"] == 1
            want = tt.tridiag_exp_e1_ref(a, b, t, sc)
            assert got.dtype == want.dtype
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= {torch.float32: 1e-5,
                           torch.float64: 1e-13}[dt] * scale, (err, scale)
            if tail:
                assert not got[m - tail:].abs().max()
            assert torch.equal(got, tt.tridiag_exp_e1(a, b, t, sc))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in hard_cases()])
def test_r1_hard_inputs_vs_twin(dev, dt, case):
    """R1 against its eigh twin on the inputs a divide and conquer gets
    wrong first (``tests/tridiag_cases.py``: Wilkinson W+ 21 and 201,
    glued Wilkinson blocks, a graded diagonal 1e-12 .. 1e2, a constant
    tridiagonal, the Lanczos tridiagonal of a 1-D Laplacian with ghost
    eigenvalues at m = 250, t |T| up to 1e3, negative and complex t, the
    error-estimate loop's zero tails), with and without s, at R1_TOL x
    max(1, |t| ||T||_1) of the largest entry; one launch, bitwise
    repeatable, a masked tail exactly 0."""
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    name, a, b, t = next(c for c in hard_cases() if c[0] == case)
    dn = "float32" if dt == torch.float32 else "float64"
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128
    at = torch.as_tensor(a, dtype=dt, device=dev)
    bt = torch.as_tensor(b, dtype=dt, device=dev)
    tq = torch.tensor(t, dtype=cdt if isinstance(t, complex) else dt,
                      device=dev)
    s = torch.tensor(1.7, dtype=dt, device=dev)
    tol = case_tol(a, b, t, dn)
    for sc in (None, s):
        _build.reset_launch_counts()
        got = tt.tridiag_exp_e1(at, bt, tq, sc)
        assert _build.launches["tridiag_exp"] == 1
        want = tt.tridiag_exp_e1_ref(at, bt, tq, sc)
        assert got.dtype == want.dtype
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= tol * scale, (name, err, scale)
        assert torch.equal(got, tt.tridiag_exp_e1(at, bt, tq, sc))
        nz = np.flatnonzero(np.abs(b) == 0)
        if nz.size:
            assert not got[nz[0] + 1:].abs().max(), name


@pytest.mark.parametrize("m", [1, 30, 250])
def test_r1_phase_clocks(dev, m):
    """R1's phase stamps (``tridiag._launch(clocks=...)``, the timing
    scripts' view of where its time goes): thread 0 stamps the start and
    3 + 8 ceil(log2 m) phase ends, in order, and a stamped launch returns
    the unstamped one's result bit for bit."""
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    a, b = _tridiag(m, torch.float64, dev, 80 + m)
    t = torch.tensor(0.6, dtype=torch.float64, device=dev)
    clk = torch.zeros(tt.CLOCK_SLOTS, dtype=torch.int64, device=dev)
    got = tt._launch(a, b, t, None, clocks=clk)
    n = 3 + 8 * (m - 1).bit_length()
    c = clk.tolist()
    assert all(c[i] <= c[i + 1] for i in range(n)) and c[n] > c[0]
    assert not any(c[n + 1:])
    assert torch.equal(got, tt.tridiag_exp_e1(a, b, t))


@pytest.mark.parametrize("which", ["expv", "phiv"])
@pytest.mark.parametrize("how", ["reassign", "in place"])
@pytest.mark.parametrize("kind", ["banded", "sell", "banded f32"])
def test_serving_follows_operator_storage(dev, kind, how, which):
    """A serving closure whose operator's storage changes after its graph
    was captured: config #3's 2-D Poisson stencil at 12 x 10 as a
    BandedOperator (B7), as a SELL operator (B9) and as a float32
    BandedOperator that float64 vectors drive (the ``_promoted`` cast).
    Calls 1-3 (eager, capture, replay), then the diagonals or the SELL
    values are reassigned or changed in place: call 4 drops the graph and
    runs as a warm-up (one recapture), call 5 is captured anew, call 6
    replays with no host read. Calls 4-6 equal the eager closure under
    ``graphs.eager()`` bit for bit and scipy's ``expm_multiply`` on the
    new matrix at 1e-10 (phiv: its phi_0 column). The JAX package's
    closures on the new arrays are held to the same results on the CPU
    (``tests/test_torch_serving.py``: this machine need not have JAX)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import expm_multiply

    from exponentialutilities_jl_torch.utils import graphs

    op = et.poisson_2d(12, 10, device=dev)
    A = op.to_dense().cpu().numpy()
    if kind == "sell":
        op = et.SellOperator.from_scipy(sp.coo_matrix(A), dtype=np.float64,
                                        is_hermitian=True, device=dev)
    elif kind == "banded f32":
        op = et.poisson_2d(12, 10, dtype=torch.float32, device=dev)
    op.is_hermitian = True
    fn = (et.make_expv(op, m=30) if which == "expv"
          else et.make_phiv(op, 2, m=30))
    t = 0.1
    bs = [_vec(120, torch.float64, dev, 200 + i) for i in range(6)]
    graphs.reset_counts()
    for b in bs[:3]:
        fn(t, b)
    assert {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                          "replays", "recaptures")} == \
        {"eager_steps": 1, "captures": 1, "replays": 1, "recaptures": 0}
    if kind == "sell":
        if how == "reassign":
            op.data.vals = op.data.vals * 1.5
        else:
            op.data.vals.mul_(1.5)
    elif how == "reassign":
        op.diags = op.diags * 1.5
    else:
        op.diags.mul_(1.5)
    A2 = sp.csr_matrix(1.5 * A)
    outs = []
    for i, b in enumerate(bs[3:]):
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(fn(t, b))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                          "replays", "recaptures")} == \
        {"eager_steps": 2, "captures": 2, "replays": 2, "recaptures": 1}
    with graphs.eager():
        want = [fn(t, b) for b in bs[3:]]
    for b, o, e in zip(bs[3:], outs, want):
        w = o if which == "expv" else o[0]
        we = e if which == "expv" else e[0]
        assert torch.equal(w, we), (kind, how)
        ref = expm_multiply(t * A2, b.cpu().numpy())
        w0 = (w if which == "expv" else w[:, 0]).cpu().numpy()
        assert np.abs(w0 - ref).max() <= 1e-10 * np.abs(ref).max(), \
            (kind, how, np.abs(w0 - ref).max())
    fn.close()


def _serving_cells(dev):
    """Hermitian (a 1-D stencil) and Arnoldi (config #4's operator at n =
    400) closures: {name: (closure, t, n)}."""
    st = et.laplacian_nd_stencil(500, device=dev)
    adv = et.advection_diffusion_1d(400, peclet=10.0, device=dev)
    return {"expv stencil": (et.make_expv(st, m=30), 0.5, 500),
            "expv advection": (et.make_expv(adv, m=40), 2e-4, 400),
            "phiv stencil": (et.make_phiv(st, 2, m=30), 0.5, 500),
            "phiv advection": (et.make_phiv(adv, 1, m=40), 2e-4, 400)}


@pytest.mark.parametrize("name", ["expv stencil", "expv advection",
                                  "phiv stencil", "phiv advection"])
def test_program_counts_and_bits(dev, name):
    """Calls 1-6 of a closure: 1 eager call, 1 capture, 4 replays, no sync
    in a replayed call, each result bit-equal to the same call under
    graphs.eager(), and no two results alias."""
    from exponentialutilities_jl_torch.utils import graphs

    fn, t, n = _serving_cells(dev)[name]
    bs = [_vec(n, torch.float64, dev, 80 + i) for i in range(6)]
    graphs.reset_counts()
    outs = []
    for i, b in enumerate(bs):
        if i >= 2:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(fn(t, b))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                          "replays")} == \
        {"eager_steps": 1, "captures": 1, "replays": 4}
    assert not graphs.counts["blocking_reads"]
    first = [o[0] if isinstance(o, tuple) else o for o in outs]
    assert len({w.data_ptr() for w in first}) == 6
    with graphs.eager():
        for b, o in zip(bs, outs):
            e = fn(t, b)
            for x, y in zip(o if isinstance(o, tuple) else (o,),
                            e if isinstance(e, tuple) else (e,)):
                assert torch.equal(x, y), name
    fn.close()
    assert not fn.program.graphs


def test_two_live_programs_interleave(dev):
    """Two closures alive at once, their replays interleaved: each replay
    equals its eager call bit for bit."""
    from exponentialutilities_jl_torch.utils import graphs

    cells = _serving_cells(dev)
    (fa, ta, na), (fb, tb, nb) = cells["expv stencil"], cells["phiv advection"]
    calls = [(fa, ta, _vec(na, torch.float64, dev, 90 + i)) if i % 2 == 0
             else (fb, tb, _vec(nb, torch.float64, dev, 90 + i))
             for i in range(10)]
    got = [fn(t, b) for fn, t, b in calls]
    with graphs.eager():
        want = [fn(t, b) for fn, t, b in calls]
    for g, w in zip(got, want):
        g, w = (g[0], w[0]) if isinstance(g, tuple) else (g, w)
        assert torch.equal(g, w)
    assert len(fa.program.graphs) == 1 and len(fb.program.graphs) == 1


def test_program_key_that_needs_grad_stays_eager(dev):
    """A closure whose MatrixFreeOperator closes over a requires-grad
    tensor: its result requires grad, so the key makes no capture, and the
    gradient equals the CPU's."""
    from exponentialutilities_jl_torch.utils import graphs

    gs = {}
    for where in (dev, "cpu"):
        ban = et.laplacian_nd_stencil(300, device=where)
        p = torch.tensor(0.8, dtype=torch.float64, device=where,
                         requires_grad=True)
        op = et.MatrixFreeOperator(lambda x, ban=ban, p=p: p * ban.matvec(x),
                                   (300, 300), is_hermitian=True,
                                   device=where)
        fn = et.make_expv(op, m=30)
        graphs.reset_counts()
        for _ in range(3):
            w = fn(0.3, _vec(300, torch.float64, where, 95))
            (g,) = torch.autograd.grad(w.sum(), p)
        assert not graphs.counts["captures"] and not fn.program.graphs
        assert graphs.counts["eager_steps"] == 3
        gs[str(where)] = float(g)
    assert abs(gs[str(dev)] - gs["cpu"]) <= 1e-12 * abs(gs["cpu"])


@pytest.mark.parametrize("how", ["b requires grad", "vjp in b",
                                 "parameter turned on"])
def test_program_call_that_needs_grad_after_a_capture_runs_eager(dev, how):
    """Plain calls of a closure (1 eager, 1 capture, 1 replay), then a call
    that autograd or torch.func must see: b requires grad, a vjp in b, or
    a tensor the operator closes over set to require grad after the
    capture. That call runs eagerly, its gradient equals the CPU's, and a
    plain call after it replays the graph again."""
    from exponentialutilities_jl_torch.utils import graphs

    n, t = 300, 0.3
    gs = {}
    for where in (dev, "cpu"):
        ban = et.laplacian_nd_stencil(n, device=where)
        p = torch.tensor(0.8, dtype=torch.float64, device=where)
        op = et.MatrixFreeOperator(lambda x, ban=ban, p=p: p * ban.matvec(x),
                                   (n, n), is_hermitian=True, device=where)
        fn = et.make_expv(op, m=30)
        graphs.reset_counts()
        for i in range(3):
            assert not fn(t, _vec(n, torch.float64, where, 98 + i)).requires_grad
        b = _vec(n, torch.float64, where, 101)
        if how == "b requires grad":
            b.requires_grad_(True)
            (g,) = torch.autograd.grad(fn(t, b).square().sum(), b)
        elif how == "vjp in b":
            w, pull = torch.func.vjp(lambda x: fn(t, x), b)
            (g,) = pull(torch.ones_like(w))
        else:
            p.requires_grad_(True)
            (g,) = torch.autograd.grad(fn(t, b).square().sum(), p)
            g = g.reshape(1)
        gs[str(where)] = g.detach().cpu()
        if where != "cpu":
            assert {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                                  "replays")} == \
                {"eager_steps": 2, "captures": 1, "replays": 1}
            if how == "parameter turned on":
                p.requires_grad_(False)
            fn(t, _vec(n, torch.float64, where, 102))
            assert graphs.counts["replays"] == 2
        fn.close()
    _close(gs[str(dev)], gs["cpu"], torch.float64)


@pytest.mark.parametrize("kind", ["stencil", "sell"])
def test_error_estimate_loop_on_the_card(dev, kind):
    """The error-estimate loop from a CUDA graph: the CPU's iteration
    count and w, at most one masked step past the end, no blocking read
    but the one that ends the loop."""
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.utils import graphs

    if kind == "stencil":
        ops = {w: et.laplacian_nd_stencil(40, 50, device=w)
               for w in (dev, "cpu")}
        t = 0.05
    else:
        rows, cols, vals = _banded_random(3000, 6, 100, 96)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(3000, 3000))
        A = (0.5 * (A + A.T)).tocoo()
        ops = {w: et.SellOperator.from_scipy(A, dtype=np.float64,
                                             is_hermitian=True, device=w)
               for w in (dev, "cpu")}
        t = 0.5
    n = ops["cpu"].shape[0]
    b = _vec(n, torch.float64, "cpu", 97)
    want, it_cpu = et.expv(t, ops["cpu"], b, m=60, mode="error_estimate",
                           atol=1e-12, rtol=1e-12, return_info=True)
    graphs.reset_counts()
    w, it = et.expv(t, ops[dev], b.to(dev), m=60, mode="error_estimate",
                    atol=1e-12, rtol=1e-12, return_info=True)
    assert it == it_cpu and 3 < it < 60
    assert graphs.counts["captures"] == 1
    assert graphs.counts["blocking_reads"] == 1
    # step 0 before the runner, then it - 1 live steps and one masked one
    assert graphs.counts["eager_steps"] + graphs.counts["replays"] == it
    _close(w.cpu(), want, torch.float64)


# ---- the fused passes and the fixed stepper as replayed masked steps ----

def _ring_case(op, dt, dev, s, seed):
    """A ring (v0, zero, y0, y1, y2, z0, z1) of random vectors (zero kept
    zero), W, and a Lanczos state whose coefficients are random and whose
    counter is s; alphas, betas and the replay's weights."""
    n = op.shape[0]
    ring = [_vec(n, dt, dev, seed + i) for i in range(7)]
    ring[1].zero_()
    st = torch.zeros(tf._ST_LEN, dtype=dt, device=dev)
    st[:4].copy_(torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt))
    st[tf._ST["beta_prev"]].fill_(1.3)
    st[tf._ST["live"]].fill_(1.0)
    st[tf._ST["step"]].fill_(float(s))
    m = 6
    return (ring, _vec(n, dt, dev, seed + 9), st,
            torch.zeros(m, dtype=dt, device=dev),
            torch.zeros(m, dtype=dt, device=dev),
            _vec(m, dt, dev, seed + 10), m)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("kind", ["7pt", "2d", "13pt", "diff3d"])
@pytest.mark.parametrize("s", [0, 1, 2, 3, 4, 5, 6, 7])
def test_b3_device_index_form_vs_twin(dev, dt, kind, s):
    """Sweep s and its stage in the device-index form (the step from the
    state's counter, the vectors from the ring) against their twins
    (fused_sweep_ring_ref, sweep_stage_ref) on copies of the same inputs,
    and bit for bit against the host-index form (the same kernels told
    s and its pointers); the counter ends at s + 1 (s = 6 is the last
    stage of m = 6: only betas[5] and broke move; s = 7 is past the end:
    only the counter moves)."""
    op = (_var_op(kind, dt, dev) if kind.startswith("diff")
          else _const_op(kind, dt, dev))
    dev = op.device             # the plan's key: the vectors' device
    plan = tf._plan(op, dt, dev)
    cvals = tf._cvals(op, dt)
    runs = []
    for form in ("device", "host", "twin"):
        ring, W, st, al, be, cf, m = _ring_case(op, dt, dev, s, 40)
        stream = _build.raw_stream(dev)
        if form == "device":
            ptrs = (ctypes.c_void_p * 7)(*(v.data_ptr() for v in ring))
            plan.sweep_ring(ptrs, st, cvals, W, stream)
            plan.stage(stream, state=st, alphas=al, betas=be, coeffs=cf,
                       j=None, m=m, tol=LANCZOS_TOL[dt])
        elif form == "host":
            Z, Vc, Vp, Y, Zn = tf.ring_slots(ring, s)
            plan.sweep(Z, Vc, Vp, st.data_ptr(), cvals, Y, Zn, W, stream)
            plan.stage(stream, state=st, alphas=al, betas=be, coeffs=cf,
                       j=s, m=m, tol=LANCZOS_TOL[dt])
            st[tf._ST["step"]].add_(1)
        else:
            mom = tf.fused_sweep_ring_ref(ring, st, op.grid_shape, op.offsets,
                                          cvals, W)
            tf.sweep_stage_ref(mom, st, al, be, cf, m, LANCZOS_TOL[dt])
        runs.append((ring, W, st, al, be))
    torch.cuda.synchronize()
    (dring, dW, dst, dal, dbe), host, twin = runs
    assert float(dst[tf._ST["step"]]) == s + 1
    for a, b in zip((*dring, dW, dst, dal, dbe), (*host[0], *host[1:])):
        assert torch.equal(a, b)
    for a, b in zip((*dring, dW, dst, dal, dbe), (*twin[0], *twin[1:])):
        _close(a, b, dt)


@pytest.mark.parametrize("m", [1, 2, 3, 12])
@pytest.mark.parametrize("kind", ["7pt", "2d", "diff3d"])
def test_fused_passes_graph_vs_eager(dev, kind, m):
    """A two-pass expv on the fused sweeps: each pass one step captured at
    its second execution and replayed (m >= 2; m = 1 runs its 2 steps
    eagerly), no sync anywhere in the call, the kernels' executions 2(m + 1)
    a call, and every output bit-equal to the same call under
    graphs.eager()."""
    from exponentialutilities_jl_torch.utils import graphs

    dt = torch.float64
    op = (_var_op(kind, dt, dev) if kind.startswith("diff")
          else _const_op(kind, dt, dev))
    name = "fused_sweep_var" if kind.startswith("diff") else "fused_sweep"
    b = _vec(op.shape[0], dt, dev, 61)
    et.expv(0.05, op, b, m=m, two_pass=True)        # plans, library, pool
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = et.expv(0.05, op, b, m=m, two_pass=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                         "replays", "blocking_reads")}
    want = ({"eager_steps": 4, "captures": 0, "replays": 0,
             "blocking_reads": 0} if m == 1 else
            {"eager_steps": 2, "captures": 2, "replays": 2 * m,
             "blocking_reads": 0})
    assert got == want
    ex = _executions()
    assert (ex[name], ex["sweep_stage"]) == (2 * (m + 1), 2 * (m + 1))
    with graphs.eager():
        we = et.expv(0.05, op, b, m=m, two_pass=True)
    assert torch.equal(w, we)
    cpu = (_var_op(kind, dt, "cpu") if kind.startswith("diff")
           else _const_op(kind, dt, "cpu"))
    _close(w.cpu(), et.expv(0.05, cpu, b.cpu(), m=m, two_pass=True), dt)


def _stepper_case(dev, p=1, n=400):
    adv = et.advection_diffusion_1d(n, peclet=10.0, device=dev)
    B = torch.stack([_vec(n, torch.float64, dev, 70 + j) * 0.1 ** j
                     for j in range(p + 1)], 1)
    return adv, B


@pytest.mark.parametrize("nsteps", [1, 2, 3, 6])
def test_fixed_stepper_graph_vs_eager(dev, nsteps):
    """phiv_timestep_fused on config #4's operator at n = 400: one substep
    run nsteps times by one runner (1 eager, then 1 capture and nsteps - 1
    replays for nsteps >= 3; all eager below), no sync, B7 executions
    nsteps (p + m), u and the eps history bit-equal to graphs.eager() and
    within 1e-12 of the CPU's."""
    from exponentialutilities_jl_torch.utils import graphs

    op, B = _stepper_case(dev)
    kw = dict(nsteps=nsteps, m=20)
    et.phiv_timestep_fused(2e-4, op, B, **kw)
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, eps = et.phiv_timestep_fused(2e-4, op, B, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                         "replays", "blocking_reads")}
    want = ({"eager_steps": 1, "captures": 1, "replays": nsteps - 1,
             "blocking_reads": 0} if nsteps >= 3 else
            {"eager_steps": nsteps, "captures": 0, "replays": 0,
             "blocking_reads": 0})
    assert got == want
    assert _executions()["banded_spmv"] == nsteps * (1 + 20)
    with graphs.eager():
        ue, epse = et.phiv_timestep_fused(2e-4, op, B, **kw)
    assert torch.equal(u, ue) and torch.equal(eps, epse)
    cu, ceps = et.phiv_timestep_fused(2e-4, _stepper_case("cpu")[0], B.cpu(),
                                      **kw)
    _close(u.cpu(), cu, torch.float64)


def test_make_phiv_timestep_scan_counts_and_bits(dev):
    """fn(B) calls 1-5 with a fresh B each: call 1 runs its first substep
    eagerly and captures the second (1 eager step, 1 capture, nsteps - 1
    replays), calls 2-5 replay the substep nsteps times each with no
    capture and no sync, each result bit-equal to the same call under
    graphs.eager(), no two results alias; B7 executions nsteps (p + m) a
    call; close() frees the graph."""
    from exponentialutilities_jl_torch.utils import graphs

    op, B = _stepper_case(dev)
    fn = et.make_phiv_timestep(2e-4, op, B, tol=1e-7)
    Bs = [torch.stack([_vec(400, torch.float64, dev, 80 + i),
                       0.1 * _vec(400, torch.float64, dev, 90 + i)], 1)
          for i in range(5)]
    _reset_counts()
    outs = []
    for i, Bi in enumerate(Bs):
        if i >= 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(fn(Bi))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fn.nsteps >= 2
    assert {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                          "replays", "blocking_reads")} == \
        {"eager_steps": 1, "captures": 1, "replays": 5 * fn.nsteps - 1,
         "blocking_reads": 0}
    assert _executions()["banded_spmv"] == 5 * fn.nsteps * (1 + fn.m)
    assert len({u.data_ptr() for u, _ in outs}) == 5
    with graphs.eager():
        for Bi, (u, eps) in zip(Bs, outs):
            ue, epse = fn(Bi)
            assert torch.equal(u, ue) and torch.equal(eps, epse)
    fn.close()
    assert not fn.program.graphs


def test_make_phiv_timestep_b_requires_grad_after_capture(dev):
    """Calls 1-3 (the warm-up that captures the substep, then replays),
    then a B that requires grad: that call runs eagerly (one eager call,
    no runner) and its gradient equals the CPU's."""
    from exponentialutilities_jl_torch.utils import graphs

    gs = {}
    for where in (dev, "cpu"):
        op, B = _stepper_case(where, n=200)
        fn = et.make_phiv_timestep(2e-4, op, B, tol=1e-7)
        graphs.reset_counts()
        for _ in range(3):
            assert not fn(B)[0].requires_grad
        Bg = B.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(Bg)[0].square().sum(), Bg)
        gs[str(where)] = g.detach().cpu()
        if where != "cpu":
            assert {k: graphs.counts[k] for k in (
                "eager_steps", "captures", "replays")} == \
                {"eager_steps": 2, "captures": 1,
                 "replays": 3 * fn.nsteps - 1}
        fn.close()
    _close(gs[str(dev)], gs["cpu"], torch.float64)


# ---- the polynomial and Taylor loops as replayed steps ----------------------

def _loop_counts(c):
    """Runner counts of a loop of c steps whose step 0 runs before the
    runner (ops/krylov._run): c - 1 executions, captured at the second
    where at least one more follows."""
    if c >= 4:
        return {"eager_steps": 1, "captures": 1, "replays": c - 2}
    return {"eager_steps": max(c - 1, 0), "captures": 0, "replays": 0}


def _poly_loop_case(name, dev):
    """(call, loop steps, {kernel: executions}) of one loop on the card."""
    from exponentialutilities_jl_torch.models import expv_taylor as tt
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl

    g = np.random.default_rng(90)
    if name == "chebyshev scan (B7)":
        op = et.poisson_2d(40, 30, device=dev)
        b = _vec(1200, torch.float64, dev, 91)
        cf = torch.as_tensor(g.standard_normal(9) * 0.1, device=dev)
        return (lambda: et.models.chebyshev._chebyshev_apply_scan(
            op, b, cf, -4.0, 0.2), 9, {"banded_spmv": 9})
    if name == "leja substeps (B1)":
        op = _nonsym_op("1d", torch.float64, dev)
        c, s = tl._interval_map(op, None)
        d, xi, c, s, q = tl._leja_expv_setup(op, 200.0 / s, None, 1e-10,
                                             None, 40.0)
        rows = torch.as_tensor(tl._newton_rows(d, xi, c, 1.0 / s),
                               device=dev)
        b = _vec(op.shape[0], torch.float64, dev, 92)
        return (lambda: tl._engine_substeps(
            op, b, rows, q, tr.recurrence_apply_resident, "leja substeps"),
            q, {"resident_recurrence": q})
    if name == "faber substeps (B5)":
        op = _nonsym_op("banded", torch.float64, dev)
        c, _, _, gm, rho = tfb._resolve_ellipse(op, None)
        a = g.standard_normal(12) * 0.1
        rows = torch.as_tensor(tfb._faber_rows(a, c, 1.0 / gm, rho),
                               device=dev)
        b = _vec(op.shape[0], torch.float64, dev, 93)
        return (lambda: tl._engine_substeps(
            op, b, rows, 5, tr.recurrence_apply_resident_banded,
            "faber substeps"), 5, {"resident_banded": 5})
    if name == "nw substeps (B1)":
        op = _nonsym_op("1d", torch.float64, dev)
        c, s = tl._interval_map(op, None)
        xi, _ = tl._leja_points_sup(30)
        D = tl._phi_divided_differences(0.02, c, s, xi, 2)
        rows = torch.as_tensor(np.stack([tl._newton_rows(D[:, j], xi, c,
                                                         1.0 / s)
                                         for j in range(3)]), device=dev)
        B = torch.stack([_vec(op.shape[0], torch.float64, dev, 94 + j)
                         for j in range(3)], 1)
        return (lambda: tl._nw_engine_substeps(
            op, B[:, 0], B, rows, 0.1, 0.02, 4, tr.recurrence_apply_resident,
            2, "nw_leja substeps"), 4, {"resident_recurrence": 12})
    if name == "B3 recurrence":
        op = _nonsym_op("3d", torch.float64, dev)
        rows = _poly_rows("faber", op, 24, torch.float64, dev)
        x = _vec(op.shape[0], torch.float64, dev, 97)
        return (lambda: tf.recurrence_apply_fused(op, x, rows), None,
                {"fused_sweep": 25, "sweep_stage": 25})
    op = et.advection_diffusion_1d(500, peclet=10.0, device=dev)
    b = _vec(500, torch.float64, dev, 98)
    t = 100.0 / float(op.opnorm_hint())
    hint = float(op.opnorm_hint())      # a device norm: read it before
    m_star, s = tt.operator_parameters(t * hint,
                                       tt.taylor_theta(torch.float64))
    return (lambda: et.expv_taylor(t, op, b, opnorm=hint), s,
            {"banded_spmv": m_star * s})


@pytest.mark.parametrize("name", [
    "chebyshev scan (B7)", "leja substeps (B1)", "faber substeps (B5)",
    "nw substeps (B1)", "B3 recurrence", "taylor (B7)"])
def test_poly_loops_graph_vs_eager(dev, name):
    """Each loop one step replayed from a CUDA graph (B1 and B5 are
    cooperative launches: their captures replay with the eager bits), no
    sync anywhere in the call, its kernel executions exact, bit-equal to
    graphs.eager()."""
    from exponentialutilities_jl_torch.utils import graphs

    call, c, want_exe = _poly_loop_case(name, dev)
    call()                                  # plans, library, pool
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {k: graphs.counts[k] for k in ("eager_steps", "captures",
                                         "replays")}
    want = ({"eager_steps": 1, "captures": 1, "replays": 24} if c is None
            else _loop_counts(c))
    assert got == want
    assert {k: v for k, v in _executions().items() if v} == want_exe
    with graphs.eager():
        we = call()
    assert torch.equal(w, we)


# --- expv_batched's batched kernels K1-K4 and its one batched build ------

def _banded_block(n, k, dt, dev, seed, batch):
    """A random k-diagonal BandedOperator (offsets spread over +-3k) and a
    (batch, n) block on the card."""
    g = np.random.default_rng(seed)
    offs = sorted(g.choice(np.arange(-3 * k, 3 * k + 1), k, replace=False))
    D = torch.as_tensor(g.standard_normal((k, n)), dtype=dt, device=dev)
    X = torch.as_tensor(g.standard_normal((batch, n)), dtype=dt, device=dev)
    return et.BandedOperator(D, [int(o) for o in offs]), X


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,k,batch", [(4096, 5, 1), (4096, 5, 16),
                                       (10007, 5, 3), (1000, 17, 17),
                                       (3, 1, 2)])
def test_k1_banded_spmm_bits(dev, dt, n, k, batch):
    """K1 on each row is bit for bit B7 on that row (aligned and ragged n,
    one block of rows and more than one, every block an edge block at n =
    3), and within RTOL of the twin; one launch a product."""
    from exponentialutilities_jl_torch.ops.kernels import spmv as ts

    op, X = _banded_block(n, k, dt, dev, 900 + n + k, batch)
    _build.reset_launch_counts()
    Y = op.matmat(X)
    assert _build.launches["banded_spmm"] == 1
    assert _build.launches["banded_spmv"] == 0
    for i in range(batch):
        assert torch.equal(Y[i], op.matvec(X[i])), i
    _close(Y, ts.banded_spmm_ref(op.diags, op.offsets, X), dt)
    assert torch.equal(Y, ts.banded_spmm(op.diags, op.offsets, X))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m", [1, 30, 250, 400])
def test_k2_tridiag_batched_bits(dev, dt, m):
    """K2 on each row is bit for bit R1 on that row (real and complex t,
    with and without s, one row broken down early, one all zero), with
    its workspace in shared memory and (m = 400) in the global scratch;
    within the R1 tolerance of the batched twin; one launch."""
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    rows = [_tridiag(m, dt, dev, 300 + m + i, tail=(m - 3 if i == 1 and m > 4
                                                    else 0))
            for i in range(4)]
    A = torch.stack([a for a, _ in rows])
    Bt = torch.stack([b for _, b in rows])
    A[3].zero_()
    Bt[3].zero_()
    s = torch.as_tensor([1.7, 0.5, 2.0, 0.0], dtype=dt, device=dev)
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128
    for t in (torch.tensor(0.6, dtype=dt, device=dev),
              torch.tensor(0.6 - 0.8j, dtype=cdt, device=dev)):
        for sc in (None, s):
            _build.reset_launch_counts()
            got = tt.tridiag_exp_e1_batched(A, Bt, t, sc)
            assert _build.launches["tridiag_exp_batched"] == 1
            for i in range(4):
                one = tt.tridiag_exp_e1(A[i], Bt[i], t,
                                        None if sc is None else sc[i])
                assert torch.equal(got[i], one), i
            want = tt.tridiag_exp_e1_batched_ref(A, Bt, t, sc)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= {torch.float32: 1e-5,
                           torch.float64: 1e-13}[dt] * scale, (err, scale)


def _laplacian_rows(n, dt, dev, batch, seed):
    """(batch, n) rows: random, one of zeros and one eigenvector of the
    1-D Laplacian (an invariant subspace of dimension 1)."""
    g = np.random.default_rng(seed)
    X = g.standard_normal((batch, n))
    X[1] = 0.0
    X[2] = np.sin(np.pi * 3 * np.arange(1, n + 1) / (n + 1))
    return torch.as_tensor(X, dtype=dt, device=dev)


def _breakdown_rows(n, dt, dev, batch, seed):
    """(batch, n) rows breaking down at different steps: row i with i % 5
    == 1 zeros, i % 5 = j in (2, 3, 4) the sum of j - 1 eigenvectors of the
    1-D Laplacian with eigenvalues spread over its spectrum (Lanczos breaks
    down after j - 1 steps, its last beta ~1e-15), else random."""
    g = np.random.default_rng(seed)
    X = g.standard_normal((batch, n))
    i = np.arange(1, n + 1)
    for r in range(batch):
        j = r % 5
        if j == 1:
            X[r] = 0.0
        elif j >= 2:
            X[r] = sum(np.sin(np.pi * ((q + 1) * n // 4 + r) * i / (n + 1))
                       for q in range(j - 1))
    return torch.as_tensor(X, dtype=dt, device=dev)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [20000, 100000])
@pytest.mark.parametrize("batch", [1, 5, 8, 9, 16])
def test_k3_lanczos_batched_bits(dev, dt, n, batch):
    """K3 (clusters of B2's shape carrying P rows each, one launch for the
    batch) on each row is bit for bit B2 on that row, rows breaking down at
    different steps (a threshold of 1e-4 in float32, whose rounding
    leaves a breakdown's beta near 1e-7); config #2's 8 rows of 1e5 in
    float64 in one wave."""
    op = et.laplacian_nd_stencil(n, dtype=dt, device=dev)
    X = _breakdown_rows(n, dt, dev, batch, 40 + n + batch)
    nrm = torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    V0 = torch.where(nrm > 0, X / torch.where(nrm > 0, nrm, 1.0), 0.0)
    plan = tr.lanczos_plan(op, dt, dev)
    assert plan.form == "cluster"
    geom = plan.batch_geometry(batch)
    assert geom.clusters == -(-batch // geom.per)
    if batch <= geom.per * geom.active:
        assert geom.waves == 1
    if (n, batch, dt) == (100000, 8, torch.float64):
        assert geom.waves == 1, geom
    tol = {torch.float32: 1e-4, torch.float64: 1e-7}[dt]
    _build.reset_launch_counts()
    ab = tr.resident_lanczos(op, V0, 40, tol)
    assert _build.launches["resident_lanczos_batched"] == 1
    assert _build.launches["resident_lanczos"] == 0
    for i in range(batch):
        assert torch.equal(ab[i], tr.resident_lanczos(op, V0[i], 40, tol)), i
    used = [int((ab[i, :, 1] > 0).sum()) for i in range(batch)]
    assert used == [(40, 0, 0, 1, 2)[i % 5] for i in range(batch)], used
    _close(ab, tr.resident_lanczos_batched_ref(
        V0, op.coeffs, tr._flat_offsets(op), 40, tol), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 20])
@pytest.mark.parametrize("m", [12, 41])
@pytest.mark.parametrize("stencil", ["laplacian", "wide"])
def test_k4_recurrence_batched(dev, dt, batch, m, stencil):
    """K4 (the rows in registers, s steps a halo exchange; m = 41 is no
    multiple of s) on each row: w bit for bit B1's on that row; sum w^2
    within 1e-14 (float64) or 1e-6 (float32) relative, the blocks'
    partials added in another grouping; launches = the plan's groups. The
    wide stencil reaches two rows, asymmetrically."""
    n = 100000
    op = (et.laplacian_nd_stencil(n, dtype=dt, device=dev)
          if stencil == "laplacian" else et.StencilOperator(
              (n,), [(1,), (-2,), (0,), (2,)], [0.4, 0.3, -1.2, 0.5],
              dtype=dt, device=dev))
    X = _laplacian_rows(n, dt, dev, max(batch, 3), 7)[:batch]
    g = np.random.default_rng(8)
    rows = torch.as_tensor(g.standard_normal((batch, m, 4)) * 0.3, dtype=dt,
                           device=dev)
    rows[..., 0] *= 0.25
    scale = torch.as_tensor(g.uniform(0.5, 2.0, batch), dtype=dt, device=dev)
    plan = tr.recurrence_batch_plan(op, dt, dev, batch)
    assert plan.form == "neighbour"
    assert m % plan.geometry.s != 0 or m == 12
    _build.reset_launch_counts()
    W, s2 = tr.resident_recurrence(op, X, rows, scale)
    assert _build.launches["resident_recurrence_batched"] == \
        plan.launches_per_call == -(-batch // plan.rows_per_launch)
    assert _build.launches["resident_recurrence"] == 0
    for i in range(batch):
        w1, n1 = tr.resident_recurrence(op, X[i], rows[i], scale[i])
        assert torch.equal(W[i], w1), i
        tol = {torch.float32: 1e-6, torch.float64: 1e-14}[dt]
        assert abs(float(s2[i] - n1)) <= tol * float(n1), i
    Wr, sr = tr.resident_recurrence_batched_ref(
        X, rows, op.coeffs, tr._flat_offsets(op), scale)
    _close(W, Wr, dt)
    _close(s2, sr, dt)


def test_b1_b2_scalar_launches_keep_their_kernels(dev):
    """A vector's B1 and B2 launch their own kernels (their counters, not
    K3's or K4's), bit for bit the batched forms' rows."""
    n = 100000
    op = et.laplacian_nd_stencil(n, dtype=torch.float64, device=dev)
    X = _laplacian_rows(n, torch.float64, dev, 8, 11)
    V0 = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True).clamp_min(1)
    rows = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (8, 40, 4)) * 0.1, dtype=torch.float64, device=dev)
    scale = torch.ones(8, dtype=torch.float64, device=dev)
    _build.reset_launch_counts()
    ab1 = tr.resident_lanczos(op, V0[0], 40, 1e-7)
    w1, _ = tr.resident_recurrence(op, X[0], rows[0], scale[0])
    assert {k: v for k, v in _build.launches.items() if v} == {
        "resident_lanczos": 1, "resident_recurrence": 1}
    assert tr.recurrence_plan(op, torch.float64, dev).form == "neighbour"
    assert tr.lanczos_plan(op, torch.float64, dev).form == "cluster"
    _build.reset_launch_counts()
    ab = tr.resident_lanczos(op, V0, 40, 1e-7)
    W, _ = tr.resident_recurrence(op, X, rows, scale)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "resident_lanczos_batched": 1, "resident_recurrence_batched": 1}
    assert torch.equal(ab[0], ab1) and torch.equal(W[0], w1)


# --- the fused batched Lanczos step: K1's Lanczos form and K5 -------------

class _Unfused(LinearOperator):
    """A ``BandedOperator`` behind a wrapper that is no ``BandedOperator``:
    the batched builders take their unfused step (K1 and torch ops)."""

    def __init__(self, op):
        self.op, self.is_hermitian = op, True
        self.shape, self.dtype, self.device = op.shape, op.dtype, op.device

    def matvec(self, x):
        return self.op.matvec(x)

    def matmat(self, X):
        return self.op.matmat(X)

    def opnorm_hint(self):
        return self.op.opnorm_hint()


def _pair_case(case, dt, dev):
    """(operator, batch) of a pair test: the zero offset present or not,
    aligned and odd n, more diagonals than the kernels hold in registers,
    one row and more than 16, every segment an edge segment."""
    g = np.random.default_rng(700)
    if case == "poisson":
        return et.poisson_2d(64, 64, dtype=dt, device=dev), 5
    if case == "batch 1":
        return et.poisson_2d(64, 64, dtype=dt, device=dev), 1
    if case == "batch 17":
        return et.poisson_2d(40, 40, dtype=dt, device=dev), 17
    n, offs = {"no zero offset": (4096, (-3, -1, 1, 3)),
               "odd n": (4099, (-70, -1, 0, 1, 70)),
               "k17": (5000, tuple(range(-40, 45, 5))),
               "tiny": (3, (-1, 0, 1))}[case]
    D = torch.as_tensor(g.standard_normal((len(offs), n)) * 0.3, dtype=dt,
                        device=dev)
    return et.BandedOperator(D, offs, is_hermitian=True), 3


def _pair_state(op, batch, m, j, nslots, dt, dev, seed):
    """A fused step's state at step j on the card: random u, scale, slots
    and bprev (0 at j = 0), row 1 broken down, m_used = j."""
    n = op.shape[0]
    g = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    broke = torch.zeros(batch, dtype=torch.bool, device=dev)
    broke[1:2] = True
    return dict(
        u=t(g.standard_normal((batch, n))), scale=t(g.uniform(0.5, 2, batch)),
        slots=t(g.standard_normal((batch, m + 1 if nslots == 0 else 2, n))),
        nslots=nslots, alphas=t(np.zeros((batch, m))),
        betas=t(np.zeros((batch, m))),
        bprev=t(g.uniform(0.5, 1.0, batch) if j else np.zeros(batch)),
        broke=broke, m_used=torch.full((batch,), j, dtype=torch.int64,
                                       device=dev),
        jj=torch.tensor([j, j + 1], device=dev))


def _pair(op, st):
    from exponentialutilities_jl_torch.ops.kernels import lanczos_step as tl
    c = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
         for k, v in st.items()}
    return tl.LanczosPair(op, c["u"], c["scale"], c["slots"], c["nslots"],
                          c["alphas"], c["betas"], c["bprev"], c["broke"],
                          c["m_used"], c["jj"], 1e-7)


PAIR_FIELDS = ("slots", "u", "alphas", "betas", "bprev", "scale")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["poisson", "no zero offset", "odd n", "k17",
                                  "batch 1", "batch 17", "tiny"])
@pytest.mark.parametrize("j,nslots", [(0, 0), (3, 0), (0, 2), (3, 2)])
def test_k1_lanczos_form_and_k5_vs_twin(dev, dt, case, j, nslots):
    """One fused step (K1's Lanczos form, then K5) against the pair's twin
    on the same state: v_j in its slot (a basis row or the ring), u, the
    records, scale within RTOL, broke and m_used equal; one launch of each
    kernel; the bits repeat from the same state (fixed-order sums)."""
    op, batch = _pair_case(case, dt, dev)
    st = _pair_state(op, batch, 6, j, nslots, dt, dev, 800 + j)
    kern, twin = _pair(op, st), _pair(op, st)
    _build.reset_launch_counts()
    kern()
    assert (_build.launches["banded_spmm_alpha"],
            _build.launches["lanczos_update"]) == (1, 1)
    twin.plain_step()
    for name in PAIR_FIELDS:
        _close(getattr(kern, name), getattr(twin, name), dt)
    assert torch.equal(kern.broke, twin.broke)
    assert torch.equal(kern.m_used, twin.m_used)
    again = _pair(op, st)
    again()
    for name in PAIR_FIELDS:
        assert torch.equal(getattr(again, name), getattr(kern, name)), name


def _fused_rows(op, dt, dev):
    """(5, n) rows on a poisson_2d(64, 64): random, zero (row 1) and the
    lowest eigenvector (row 2, a breakdown at step 1)."""
    g = np.random.default_rng(810)
    X = g.standard_normal((5, op.shape[0]))
    X[1] = 0.0
    s = np.sin(np.pi * np.arange(1, 65) / 65)
    X[2] = np.outer(s, s).ravel() / np.sum(s * s)
    return torch.as_tensor(X, dtype=dt, device=dev)


@pytest.mark.parametrize("builder", ["lanczos", "lanczos_coeffs"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_fused_builder_short_runs_eagerly(dev, builder, m):
    """At m <= 3 the batched builder makes no capture (``krylov._run`` runs
    its steps eagerly): the pair still runs every step, one of each kernel
    a step, and a row in an invariant subspace of dimension m breaks down
    at the last step, ``broke`` and ``m_used`` as the unfused step's, the
    records within 1e-12."""
    from exponentialutilities_jl_torch.ops import krylov as tk
    from exponentialutilities_jl_torch.utils import graphs

    dt = torch.float64
    op = et.poisson_2d(64, 64, dtype=dt, device=dev)
    X = np.random.default_rng(820 + m).standard_normal((3, op.shape[0]))
    i = np.arange(1, 65)
    sines = lambda p: np.sin(np.pi * p * i / 65)
    # eigenvectors of distinct eigenvalues: (1, 1), (1, 2), (3, 3)
    X[1] = sum(np.outer(sines(p), sines(q)).ravel()
               for p, q in ((1, 1), (1, 2), (3, 3))[:m])
    X[2] = 0.0
    B = torch.as_tensor(X, dtype=dt, device=dev)
    fn = getattr(tk, builder)
    graphs.reset_counts()
    _reset_counts()
    got = fn(op, B, m, tol=1e-7)
    torch.cuda.synchronize()
    assert graphs.counts["captures"] == 0
    assert {k: v for k, v in _executions().items() if v} == {
        "banded_spmm_alpha": m, "lanczos_update": m}
    ref = fn(_Unfused(op), B, m, tol=1e-7)
    if builder == "lanczos":
        flags = [(got.m_used, ref.m_used), (got.breakdown, ref.breakdown)]
        pairs = [(got.H, ref.H)]
    else:
        flags = [(got[3], ref[3]), (got[4], ref[4])]
        pairs = [(got[i], ref[i]) for i in (0, 1, 2)]
    for a, b in flags:
        assert torch.equal(a, b)
    assert flags[0][0].tolist() == [m, m, 0]
    assert flags[1][0].tolist() == [False, True, True]
    for a, b in pairs:
        a, b = (torch.where(t.abs() < 1e-7, 0.0, t) for t in (a, b))
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-300)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("builder", ["lanczos", "lanczos_coeffs"])
def test_fused_builder_vs_unfused(dev, dt, builder):
    """The batched builder on a BandedOperator runs the pair (executions:
    one of each kernel a step, no K1 and no B7) against the unfused step
    (K1 a step): records and basis within the recurrence's tolerance,
    broke and m_used equal, the zero row zero, the eigenvector row broken
    down at step 1; bit-equal to its call under graphs.eager()."""
    from exponentialutilities_jl_torch.ops import krylov as tk
    from exponentialutilities_jl_torch.utils import graphs

    op = et.poisson_2d(64, 64, dtype=dt, device=dev)
    B = _fused_rows(op, dt, dev)
    m, tol = 16, {torch.float32: 1e-4, torch.float64: 1e-7}[dt]
    rtol = {torch.float32: 1e-4, torch.float64: 1e-12}[dt]
    fn = getattr(tk, builder)
    call = (lambda o: fn(o, B, m, tol=tol))
    call(op)
    torch.cuda.synchronize()
    _reset_counts()
    got = call(op)
    torch.cuda.synchronize()
    exe = {k: v for k, v in _executions().items() if v}
    assert exe == {"banded_spmm_alpha": m, "lanczos_update": m}, exe
    _reset_counts()
    ref = call(_Unfused(op))
    torch.cuda.synchronize()
    assert {k: v for k, v in _executions().items() if v} == \
        {"banded_spmm": m}
    with graphs.eager():
        eager = call(op)
    if builder == "lanczos":
        pairs = [(got.H, ref.H, eager.H), (got.V, ref.V, eager.V)]
        flags = [(got.m_used, ref.m_used), (got.breakdown, ref.breakdown)]
        assert not got.V[1].any() and not got.V[2, 2:].any()
        mu = got.m_used
    else:
        pairs = [(got[i], ref[i], eager[i]) for i in (0, 1, 2)]
        flags = [(got[3], ref[3]), (got[4], ref[4])]
        mu = got[3]
    for a, b, c in pairs:
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rtol * max(scale, 1e-300)
        assert torch.equal(a, c)
    for a, b in flags:
        assert torch.equal(a, b)
    assert mu.tolist()[1:3] == [0, 1]


def _outputs(out):
    """The tensors of a builder's or ``expv_batched``'s result."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return list(out)
    return [out.V, out.H, out.beta, out.m_used, out.breakdown]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("entry", ["lanczos", "lanczos_coeffs",
                                   "expv_batched"])
def test_fused_builder_transposed_block(dev, dt, entry):
    """A block passed as the transpose of an (n, batch) array (rows with a
    stride of 1 between elements' rows) runs the pair: the same result as
    the unfused step on that block and as the fused step on its contiguous
    copy (the start vector's norm may round apart between the layouts)."""
    from exponentialutilities_jl_torch.ops import krylov as tk

    op = et.poisson_2d(64, 64, dtype=dt, device=dev)
    B = _fused_rows(op, dt, dev)
    Bt = B.T.contiguous().T
    assert torch.equal(Bt, B) and not Bt.is_contiguous()
    m, tol = 16, {torch.float32: 1e-4, torch.float64: 1e-7}[dt]
    rtol = {torch.float32: 1e-4, torch.float64: 1e-12}[dt]
    if entry == "expv_batched":
        def call(o, X):
            return et.expv_batched(1e-3, o, X, m=m, tol=tol)
    else:
        fn = getattr(tk, entry)

        def call(o, X):
            return fn(o, X, m, tol=tol)
    _reset_counts()
    got = _outputs(call(op, Bt))
    torch.cuda.synchronize()
    exe = _executions()
    assert (exe["banded_spmm_alpha"], exe["lanczos_update"]) == (m, m), exe
    ref = _outputs(call(_Unfused(op), Bt))
    same = _outputs(call(op, B))
    for a, b in [*zip(got, ref), *zip(got, same)]:
        if a.is_floating_point():
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= rtol * max(scale, 1e-300)
        else:
            assert torch.equal(a, b)


def _batched_cells(dev):
    """expv_batched cells: {name: (call of B, B, per-row call, exact
    executions)}."""
    P = et.poisson_2d(200, 200, device=dev)
    g = np.random.default_rng(31)
    BP = torch.as_tensor(g.standard_normal((6, P.shape[0])), device=dev)
    BP[4] = 0.0
    S = et.laplacian_nd_stencil(100000, device=dev)
    BS = _laplacian_rows(100000, torch.float64, dev, 8, 32)
    A = et.advection_diffusion_1d(500, peclet=10.0, device=dev)
    BA = torch.as_tensor(g.standard_normal((5, 500)), device=dev)
    k4 = tr.recurrence_batch_plan(S, torch.float64, S.device, 8)
    return {
        "lanczos": (lambda B: et.expv_batched(1e-4, P, B, m=30), BP,
                    lambda b: et.expv(1e-4, P, b, m=30),
                    {"banded_spmm_alpha": 30, "lanczos_update": 30,
                     "tridiag_exp_batched": 1}),
        "two-pass": (lambda B: et.expv_batched(0.5, S, B, m=40,
                                               two_pass=True), BS,
                     lambda b: et.expv(0.5, S, b, m=40, two_pass=True),
                     {"resident_lanczos_batched": 1,
                      "tridiag_exp_batched": 1,
                      "resident_recurrence_batched": k4.launches_per_call}),
        "arnoldi": (lambda B: et.expv_batched(1e-4, A, B, m=60), BA,
                    lambda b: et.expv(1e-4, A, b, m=60),
                    {"banded_spmm": 60}),
        "iop two-pass": (lambda B: et.expv_batched(1e-4, A, B, m=60,
                                                   two_pass=True, iop=2), BA,
                         lambda b: et.expv(1e-4, A, b, m=60, two_pass=True,
                                           iop=2),
                         {"banded_spmm": 120}),
    }


@pytest.mark.parametrize("name", ["lanczos", "two-pass", "arnoldi",
                                  "iop two-pass"])
def test_expv_batched_one_build(dev, name):
    """One expv_batched call is one batched build: its kernels' executions
    exact (the fused Lanczos pair or K1 once a step for the whole batch,
    one K2 launch, one K3 and the K4 groups), one capture a builder call,
    the result bit-equal to the call under graphs.eager() and within 1e-13 of the rows' expv (the
    batched norms and dots sum in another order than a row's)."""
    from exponentialutilities_jl_torch.utils import graphs

    call, B, row, want = _batched_cells(dev)[name]
    call(B)                          # the plans and the pool, made once
    torch.cuda.synchronize()
    _reset_counts()
    W = call(B)
    torch.cuda.synchronize()
    exe = {k: v for k, v in _executions().items() if v}
    assert exe == want, exe
    assert graphs.counts["captures"] == {"lanczos": 1, "two-pass": 0,
                                         "arnoldi": 1,
                                         "iop two-pass": 2}[name]
    with graphs.eager():
        assert torch.equal(W, call(B))
    rows = torch.stack([row(b) for b in B.unbind(0)])
    scale = float(rows.abs().max())
    assert float((W - rows).abs().max()) <= 1e-13 * scale

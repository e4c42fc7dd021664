"""The port's hand-written CUDA kernels against their plain twins on the
card, at small shapes. Marked ``cuda``: they skip without an NVIDIA GPU
and run on one with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
conftest imports JAX, which a GPU machine need not have).

Tolerances, relative to the output's max-norm: 1e-5 in float32 (sum order
and FMA contraction differ from the twin) and 1e-12 in float64."""

import itertools

import numpy as np
import pytest
import torch

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr

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


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", [(5, 7, 130), (9, 33)])
def test_b3_vs_twin(dev, dt, shape):
    op = et.laplacian_nd_stencil(*shape, dtype=dt, device=dev)
    n = op.shape[0]
    Z, Vc, Vp, W = (_vec(n, dt, dev, s) for s in range(4))
    co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
    W1, W2 = W.clone(), W.clone()
    Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W1)
    mom = torch.stack([ypy, yzy])
    Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                       op.offsets, op.coeffs, W2)
    for a, b in ((Y, Yr), (Zn, Znr), (mom, momr), (W1, W2)):
        _close(a, b, dt)
    plain = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
    assert torch.equal(mom, torch.stack(plain[2:]))


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
    _build.reset_launch_counts()
    b1 = _vec(2000, torch.float64, dev, 5)
    b3 = _vec(op3.shape[0], torch.float64, dev, 6)
    w1 = et.expv_chebyshev(0.5, op1, b1, tol=1e-12)
    w2 = et.expv(0.5, op1, b1, m=30, two_pass=True)
    w3 = et.expv_chebyshev(0.05, op3, b3, tol=1e-12)
    w4 = et.expv(0.05, op3, b3, m=20, two_pass=True)
    counts = dict(_build.launches)
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
        "resident_banded": 0, "resident_grid": 0, "fused_sweep": 0}
    for w in (w1, w2):
        assert float((w - w3).norm() / w3.norm()) < 1e-10


def test_fused_true_wrong_dtype_raises(dev):
    op = et.laplacian_nd_stencil(6, 7, 8, device=dev)
    with pytest.raises(ValueError):
        td.recurrence_engine(op, torch.float16, fused=True, device=dev)

"""SpMV of the structured containers (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/spmv.py``).

* B7 ``banded_spmv(diags, offsets, x)``: diagonal storage,
  y_i = sum_k D[k, i] x[i + o_k] with x read as zero outside the vector
  (``BandedOperator``).
* B8 ``blockell_spmv(blocks, bcols, x)``: blocked ELL,
  y[r br + i] = sum_k sum_j blocks[r, k, i, j] x[bcols[r, k] bc + j]
  (``BlockELLOperator``).

Both are hand-written CUDA kernels (``csrc/spmv.cu``), one launch per
product. Their plain twins ``banded_spmv_ref`` (shifted slices of a
zero-padded x) and ``blockell_spmv_ref`` (an einsum of gathered blocks,
the JAX package's off-TPU path) compute the same contract. A wrapper runs
the twin for CPU tensors; for CUDA tensors it launches the kernel or
raises. The TPU knobs of the JAX kernels (``rows_per_tile``,
``dma_gather``, ``tile``, the 128-lane window layout) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.precision import full_precision
from . import _build

__all__ = ["banded_spmv", "banded_spmv_ref", "blockell_spmv",
           "blockell_spmv_ref"]


def banded_spmv_ref(diags, offsets, x):
    """Plain twin of B7: shifted slices of x zero-padded by the widest
    offset (out-of-range reads see the pad zeros)."""
    n = x.shape[0]
    h = max((abs(o) for o in offsets), default=0)
    rt = torch.promote_types(diags.dtype, x.dtype)
    xe = F.pad(x.to(rt), (h, h))
    D = diags.to(rt)
    y = torch.zeros(n, dtype=rt, device=x.device)
    for k, o in enumerate(offsets):
        y = y + D[k] * xe[h + o:h + o + n]
    return y


@full_precision
def blockell_spmv_ref(blocks, bcols, x):
    """Plain twin of B8: gather x as (nbc, bc) block slices, contract each
    (br x bc) block."""
    rt = torch.promote_types(blocks.dtype, x.dtype)
    bc = blocks.shape[3]
    xb = x.to(rt).reshape(-1, bc)[bcols]                # (nbr, w, bc)
    return torch.einsum("nwij,nwj->ni", blocks.to(rt), xb).reshape(-1)


def _operand(what, t, dt):
    """``t`` as the kernel reads it: dtype ``dt`` (no cast here, so no
    launch hides a copy of the matrix) and contiguous."""
    if t.dtype != dt:
        raise ValueError(f"{what}: operand dtype {t.dtype}, the kernel "
                         f"takes {dt}; cast the operand once, not per "
                         "product")
    return t.contiguous()


def banded_spmv(diags, offsets, x):
    """y = A x for diagonal storage (module doc): kernel B7 on CUDA, its
    twin on CPU. ``diags`` (k, n) in x's dtype on CUDA, ``offsets`` k ints
    (at most ``_build.MAX_POINTS`` on CUDA), ``x`` (n,)."""
    offsets = tuple(int(o) for o in offsets)
    if x.device.type == "cpu":
        return banded_spmv_ref(diags, offsets, x)
    _build.check_operands("banded_spmv", x, diags)
    k, n = diags.shape
    if x.shape != (n,) or len(offsets) != k:
        raise ValueError(f"banded_spmv: diags {tuple(diags.shape)}, "
                         f"{len(offsets)} offsets, x {tuple(x.shape)}")
    if k > _build.MAX_POINTS:
        raise ValueError(f"banded_spmv: {k} diagonals, the kernel takes at "
                         f"most {_build.MAX_POINTS}")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return y.zero_()
    D = _operand("banded_spmv", diags, x.dtype)
    x = x.contiguous()
    fn = getattr(_build.library(), f"eu_banded_spmv_{_build.suffix(x.dtype)}")
    code = fn(_build.ptr(D), (ctypes.c_int * k)(*offsets), k, _build.ptr(x),
              n, _build.ptr(y), _build.stream_of(x))
    _build.check(code, "banded SpMV kernel (B7)")
    _build.launches["banded_spmv"] += 1
    return y


def blockell_spmv(blocks, bcols, x):
    """y = A x for blocked ELL (module doc): kernel B8 on CUDA, its twin on
    CPU. ``blocks`` (nbr, w, br, bc) in x's dtype on CUDA, ``bcols``
    (nbr, w) int32 in [0, nbc), ``x`` (n,) with n = nbr br = nbc bc. The
    kernel gathers x by ``bcols`` unchecked (a check here would sync every
    product): ``BlockELLOperator`` checks them once when built."""
    if x.device.type == "cpu":
        return blockell_spmv_ref(blocks, bcols, x)
    _build.check_operands("blockell_spmv", x, blocks, bcols)
    nbr, w, br, bc = blocks.shape
    if x.shape != (nbr * br,) or bcols.shape != (nbr, w) or x.shape[0] % bc:
        raise ValueError(f"blockell_spmv: blocks {tuple(blocks.shape)}, "
                         f"bcols {tuple(bcols.shape)}, x {tuple(x.shape)}")
    y = torch.empty(nbr * br, dtype=x.dtype, device=x.device)
    if nbr == 0 or w == 0:
        return y.zero_()
    B = _operand("blockell_spmv", blocks, x.dtype)
    cols = _operand("blockell_spmv", bcols, torch.int32)
    x = x.contiguous()
    fn = getattr(_build.library(),
                 f"eu_blockell_spmv_{_build.suffix(x.dtype)}")
    code = fn(_build.ptr(B), _build.ptr(cols), _build.ptr(x), nbr, w, br, bc,
              _build.ptr(y), _build.stream_of(x))
    _build.check(code, "block-ELL SpMV kernel (B8)")
    _build.launches["blockell_spmv"] += 1
    return y

"""SpMV of the structured containers (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/spmv.py``).

* B7 ``banded_spmv(diags, offsets, x)``: diagonal storage,
  y_i = sum_k D[k, i] x[i + o_k] with x read as zero outside the vector
  (``BandedOperator``); its batched form K1 ``banded_spmm(diags,
  offsets, X)`` takes each row of X (batch, n) in one launch that reads
  the diagonals once for every row (``BandedOperator.matmat``, the
  batched Krylov builders' product).
* B8 ``blockell_spmv(blocks, bcols, x)``: blocked ELL,
  y[r br + i] = sum_k sum_j blocks[r, k, i, j] x[bcols[r, k] bc + j]
  (``BlockELLOperator``).

Both are hand-written CUDA kernels (``csrc/spmv.cu``), one launch per
product. B7's launches go through a ``BandedPlan``: the checks, casts,
launch descriptor (offsets, interior block range) and entry point that
every product of one matrix shares, made once (``BandedOperator`` keeps
one per compute dtype and CUDA device), so a product costs the host a few
attribute comparisons, ``torch.empty_like`` and one ctypes call of four
arguments. Their plain twins ``banded_spmv_ref`` (shifted slices of a
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

__all__ = ["banded_spmv", "banded_spmv_ref", "banded_spmm", "banded_spmm_ref",
           "BandedPlan", "banded_interior", "SPMM_ROWS",
           "blockell_spmv", "blockell_spmv_ref", "ROW_THREADS"]

ROW_THREADS = 256       # threads of a B7 block: eu::kThreads in csrc/common.cuh
SPMM_ROWS = 16          # K1: batch rows a block carries (eu::kSpmmRows)


def banded_spmv_ref(diags, offsets, x):
    """Plain twin of B7: shifted slices of x zero-padded by the widest
    offset (out-of-range reads see the pad zeros). x may carry leading
    batch axes (each row of a (batch, n) x, ``banded_spmm_ref``)."""
    n = x.shape[-1]
    h = max((abs(o) for o in offsets), default=0)
    rt = torch.promote_types(diags.dtype, x.dtype)
    xe = F.pad(x.to(rt), (h, h))
    D = diags.to(rt)
    y = torch.zeros(x.shape, dtype=rt, device=x.device)
    for k, o in enumerate(offsets):
        y = y + D[k] * xe[..., h + o:h + o + n]
    return y


def banded_spmm_ref(diags, offsets, X):
    """Plain twin of K1 (``banded_spmm``): B7's twin on each row of X
    (batch, n), Y[b, i] = sum_k D[k, i] X[b, i + o_k], the same per-element
    arithmetic as a row's ``banded_spmv_ref``."""
    if X.dim() != 2:
        raise ValueError(f"banded_spmm: X must be (batch, n), got "
                         f"{tuple(X.shape)}")
    return banded_spmv_ref(diags, offsets, X)


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


class _BandedLaunch(ctypes.Structure):
    """``eu::BandedLaunch`` (csrc/spmv.cu): what a B7 launch reads on the
    host, built once per plan."""
    _fields_ = [("diags", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("blo", ctypes.c_longlong), ("bhi", ctypes.c_longlong),
                ("k", ctypes.c_int), ("o", ctypes.c_int * _build.MAX_POINTS)]


def banded_interior(offsets, n: int, rows: int) -> tuple:
    """[blo, bhi): the B7 blocks (block b owns rows [b rows, b rows +
    rows)) whose rows all exist and whose x reads i + o, for every row i
    and offset o, lie in [0, n). The kernel runs them without bounds
    checks; (0, 0) when there are none."""
    if not offsets:
        return (0, 0)
    blo = -(-max(-min(offsets), 0) // rows)
    bhi = max((n - max(max(offsets), 0)) // rows, 0)
    return (blo, bhi) if blo < bhi else (0, 0)


class BandedPlan:
    """What every B7 launch on one matrix, for vectors of one dtype on one
    CUDA device, shares: the checks of the diagonals and offsets, made once;
    the diagonals as the kernel reads them (contiguous, in ``dtype``); the
    launch descriptor (``_BandedLaunch``: their pointer, the offsets and
    the interior block range, ``banded_interior`` with V = 16 / itemsize
    rows a thread); the C entry point. A call compares x's dtype, device
    and shape with the plan's, allocates y and launches on the current
    stream, taken as a raw handle. A device that is not CUDA raises."""

    def __init__(self, diags, offsets, dtype, device):
        self.device = torch.device(device)
        _build.require_cuda("banded_spmv", self.device)
        if dtype not in _build.KERNEL_DTYPES:
            raise ValueError(f"banded_spmv takes float32/float64, got {dtype}")
        if diags.device != self.device:
            raise ValueError(f"banded_spmv: operand on {diags.device}, vector "
                             f"on {self.device}")
        self.offsets, self.dtype = tuple(int(o) for o in offsets), dtype
        self.k = len(self.offsets)
        if diags.dim() != 2 or diags.shape[0] != self.k:
            raise ValueError(f"banded_spmv: diags {tuple(diags.shape)}, "
                             f"{self.k} offsets")
        if self.k > _build.MAX_POINTS:
            raise ValueError(f"banded_spmv: {self.k} diagonals, the kernel "
                             f"takes at most {_build.MAX_POINTS}")
        self.diags = _operand("banded_spmv", diags, dtype)
        self.n = diags.shape[1]
        self.shape, self.fn, self.mm = (self.n,), None, None
        if self.n == 0 or self.k == 0:
            return
        blo, bhi = banded_interior(
            self.offsets, self.n,
            ROW_THREADS * (16 // self.diags.element_size()))
        self.launch = _BandedLaunch(self.diags.data_ptr(), self.n, blo, bhi,
                                    self.k, (ctypes.c_int * _build.MAX_POINTS)(
                                        *self.offsets))
        self.addr = ctypes.addressof(self.launch)
        lib, suf = _build.library(), _build.suffix(dtype)
        self.fn = getattr(lib, f"eu_banded_spmv_{suf}")
        self.mm = getattr(lib, f"eu_banded_spmm_{suf}")

    def __call__(self, x):
        if (x.dtype != self.dtype or x.device != self.device
                or x.shape != self.shape):
            raise ValueError(f"banded_spmv: expected a {self.shape} "
                             f"{self.dtype} vector on {self.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        if not x.is_contiguous():
            x = x.contiguous()
        y = torch.empty_like(x)     # cheaper on the host than torch.empty
        if self.fn is None:
            return y.zero_()
        code = self.fn(self.addr, x.data_ptr(), y.data_ptr(),
                       _build.raw_stream(self.device))
        if code:
            _build.check(code, "banded SpMV kernel (B7)")
        _build.launches["banded_spmv"] += 1
        return y

    def spmm(self, X):
        """Y = X A^T for X (batch, n): one launch of K1, B7's batched form
        (``csrc/spmv.cu`` ``banded_spmm_kernel``), every row's bits those
        of a B7 launch on that row."""
        if (X.dtype != self.dtype or X.device != self.device or X.dim() != 2
                or X.shape[1:] != self.shape):
            raise ValueError(f"banded_spmm: expected a (batch,) + "
                             f"{self.shape} {self.dtype} block on "
                             f"{self.device}, got {tuple(X.shape)} {X.dtype} "
                             f"on {X.device}")
        if not X.is_contiguous():
            X = X.contiguous()
        Y = torch.empty_like(X)
        if self.fn is None or X.shape[0] == 0:
            return Y.zero_()
        code = self.mm(self.addr, X.data_ptr(), Y.data_ptr(), X.shape[0],
                       _build.raw_stream(self.device))
        if code:
            _build.check(code, "batched banded SpMV kernel (K1)")
        _build.launches["banded_spmm"] += 1
        return Y


def banded_spmv(diags, offsets, x):
    """y = A x for diagonal storage (module doc): kernel B7 on CUDA, its
    twin on CPU. ``diags`` (k, n) in x's dtype on CUDA, ``offsets`` k ints
    (at most ``_build.MAX_POINTS`` on CUDA), ``x`` (n,). Each call builds
    a ``BandedPlan``; ``BandedOperator`` keeps its plans."""
    if x.device.type == "cpu":
        return banded_spmv_ref(diags, tuple(int(o) for o in offsets), x)
    return BandedPlan(diags, offsets, x.dtype, x.device)(x)


def banded_spmm(diags, offsets, X):
    """Y[b] = A X[b] for each row of X (batch, n) in diagonal storage:
    kernel K1 on CUDA (one launch for the block), its twin on CPU. Each
    call builds a ``BandedPlan``; ``BandedOperator.matmat`` keeps its
    plans."""
    if X.device.type == "cpu":
        return banded_spmm_ref(diags, tuple(int(o) for o in offsets), X)
    return BandedPlan(diags, offsets, X.dtype, X.device).spmm(X)


def blockell_spmv(blocks, bcols, x):
    """y = A x for blocked ELL (module doc): kernel B8 on CUDA, its twin on
    CPU. ``blocks`` (nbr, w, br, bc) in x's dtype on CUDA, ``bcols``
    (nbr, w) int32 in [0, nbc), ``x`` (nbc bc,): A may be rectangular
    (nbr br rows; a sharded operator's block rows against the whole x).
    The kernel gathers x by ``bcols`` unchecked (a check here would sync
    every product): ``BlockELLOperator`` checks them once when built, and
    the sharded one keeps the global operator's checked columns."""
    if x.device.type == "cpu":
        return blockell_spmv_ref(blocks, bcols, x)
    _build.check_operands("blockell_spmv", x, blocks, bcols)
    nbr, w, br, bc = blocks.shape
    if x.dim() != 1 or bcols.shape != (nbr, w) or x.shape[0] % bc:
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
              _build.ptr(y), _build.raw_stream(x.device))
    _build.check(code, "block-ELL SpMV kernel (B8)")
    _build.launches["blockell_spmv"] += 1
    return y

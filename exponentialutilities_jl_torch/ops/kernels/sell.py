"""SELL-C-sigma SpMV for unstructured sparse matrices (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/sell.py``).

The port keeps the contract of the JAX module (y = A x for a matrix packed
from COO, duplicates summed) and its public names, not its TPU layout. The
JAX packs exist for the TPU's 1024-column vector-gather window: window-local
indices and per-block window starts, the roll/residue/subroll/chunked/
rowsel gather modes, pair-packed indices, uniform-k schedules, and the
errors raised when a matrix's band does not fit the window. A GPU gathers
x natively, so one layout serves every mode here:

* **SELL-C-sigma.** Rows are cut into slices of C = ``SLICE`` = 32 rows
  (one warp). Inside windows of ``sigma`` rows (a multiple of C) the rows
  are sorted by degree, longest first, so that a slice's rows have similar
  lengths; each slice is as wide as its longest row. Values and int32
  global column indices are stored slot-major inside a slice (slot j of
  slice row r at ``slice_ptr[s] + C j + r``). ``slice_ptr`` (int64) gives
  each slice's first slot and ``row_of`` (int32) the original row of each
  packed row, so y is written in the original order.
* **Spans.** ``spans`` (nslices, 2) int32 holds each slice's column span
  [lo_s, hi_s] over its real entries ([0, -1] for a slice with none), and
  padded slots hold value 0 and column lo_s, so every slot's column lies
  in its slice's span. B9 stages x[lo..hi] of a block of
  ``ROWS_PER_BLOCK`` = 256 rows (8 slices; the union of their spans) in
  shared memory when that window fits ``STAGE_ELEMS`` values, and gathers
  from global memory otherwise (``csrc/sell.cu``). The spans depend only on
  ``cols`` and ``slice_ptr``: the packers compute them, a pack loaded or
  built by hand computes them on its device while it is checked (over all
  slots, padding included, after pointing every value-0 slot at its
  slice's lowest column: a pack saved by an earlier version holds column 0
  there), and they are not saved.
* **Bucketed** (``sell_pack_bucketed``): the same layout sorted over a
  wider sigma (``BUCKET_SIGMA``). Degree bucketing is what the sigma sort
  does.
* **Segmented** (``sell_pack_seg``): every row longer than L = ``seg_len``
  slots is split into ceil(d / L) segments of at most L entries, each
  packed as a row of its own, so no slice is wider than L whatever the
  degree mix. ``sell_spmv_seg`` is B9 over the segments (partials p_s in
  segment order) followed by B10, the fixed-order per-row sum
  y_i = sum_{s = seg_ptr[i]}^{seg_ptr[i+1]-1} p_s (what the JAX
  ``_seg_compact_kernel`` computes in its direct mode).

Kernels (``csrc/sell.cu``): B9 ``sell_spmv`` (one thread per row of a
slice, x staged per 256-row block where the spans allow) and B10
``seg_compact``; their plain twins are ``sell_spmv_ref`` and
``seg_compact_ref``. A wrapper runs the twin for CPU tensors and, for CUDA
tensors, launches the kernel or raises. A pack's launches go through its
``launch_plan`` (``SellPlan``, ``SegPlan``), built at its first launch and
kept in the pack: the checks of its arrays, B9's launch descriptor (their
pointers, sizes, ``stage_cap`` and unroll) and the C entry points, so a
product costs the host a comparison of x's dtype, device and shape, an
empty output and one ctypes call per kernel.

The JAX pack arguments ``window``, ``residue``, ``mode``, ``max_chunks``,
``uniform_k`` and ``kmax`` are accepted and have no effect on this
layout. A matrix whose band the TPU window refused (any band wider than
about 900 after RCM) packs like any other: that is a constraint removed,
not a feature added. ``save``/``load`` write and read this layout (npz),
not the JAX package's.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ...utils.device import host_tensor, resolve_device
from . import _build

__all__ = ["SellData", "sell_pack", "sell_spmv", "sell_spmv_ref",
           "SellBucketed", "sell_pack_bucketed", "sell_spmv_bucketed",
           "sell_spmv_bucketed_ref", "SellSeg", "sell_pack_seg",
           "sell_spmv_seg", "sell_spmv_seg_ref", "seg_compact",
           "seg_compact_ref", "stage_blocks", "SLICE", "SIGMA",
           "BUCKET_SIGMA", "SEG_LEN", "ROWS_PER_BLOCK", "STAGE_ELEMS",
           "WIDE_ROWS", "SellPlan", "SegPlan", "launch_plan"]

SLICE = 32              # rows per slice: eu::kSlice in csrc/sell.cu
SIGMA = 256             # sort window of the default pack (8 slices)
BUCKET_SIGMA = 8192     # sort window of the bucketed pack
SEG_LEN = 16            # segment length of the segmented pack
ROWS_PER_BLOCK = 256    # rows of one B9 block: eu::kSlicesPerBlock slices
STAGE_ELEMS = 4096      # B9's x window budget: eu::kStageElems
# mean slots a row from which B9 keeps 16 in flight, not 4: 16 won on rows
# of 16.9 and lost on rows of 8.0 (the two packs timed, PERF.md); 12 lies
# between them and was not timed itself
WIDE_ROWS = 12
_VEC = 4                # staged windows start 16-byte aligned (float32)
_MAX_SLICE_SLOTS = 2 ** 31   # B9 offsets inside a slice are int32


class SellData:
    """A SELL-C-sigma pack (module doc) of an (n, ncols) matrix.

    vals:      (S,) values, slot-major per slice, 0 in padded slots.
    cols:      (S,) int32 global column indices, lo_s in padded slots.
    slice_ptr: (nslices + 1,) int64 first slot of each slice.
    row_of:    (n,) int32 original row of each packed row.
    n, ncols:  rows and columns; nnz: stored entries (duplicates summed).
    sigma:     the sort window the pack was built with.
    spans:     (nslices, 2) int32 column span [lo_s, hi_s] of each slice
               ([0, -1] for a slice without entries), on the pack's device.
    nslots:    S = slice_ptr[-1], on the host, so a launch can check the
               arrays' sizes without a sync.
    stage_cap: the largest x window of a 256-row block (union of its spans,
               16-byte aligned) within ``STAGE_ELEMS``, 0 if none fits: the
               values of shared memory a B9 launch takes, on the host.
    derived:   (nslots, spans, stage_cap) as the packers compute
               them; when None (a pack loaded or built by hand) the pack is
               checked here and they are derived on its device, with one
               sync: slice_ptr runs from 0 to S in whole slices, every
               column and row index is in range, since B9 gathers x and
               scatters y by them unchecked, and the spans cover every
               slot, since B9 stages x by them.
    """

    def __init__(self, vals, cols, slice_ptr, row_of, n, nnz, *, ncols=None,
                 sigma=SIGMA, derived=None):
        self.vals = vals
        self.cols = cols
        self.slice_ptr = slice_ptr
        self.row_of = row_of
        self.n = int(n)
        self.ncols = self.n if ncols is None else int(ncols)
        self.nnz = int(nnz)
        self.sigma = int(sigma)
        nslots, self.spans, stage_cap = (
            self._validate() if derived is None else derived)
        self.nslots, self.stage_cap = int(nslots), int(stage_cap)

    def _validate(self):
        v, c, sp, ro = self.vals, self.cols, self.slice_ptr, self.row_of
        if (v.dim() != 1 or c.shape != v.shape or sp.dim() != 1
                or sp.numel() < 1 or ro.shape != (self.n,)
                or self.n > (sp.numel() - 1) * SLICE):
            raise ValueError(
                f"SELL pack: vals {tuple(v.shape)}, cols {tuple(c.shape)}, "
                f"slice_ptr {tuple(sp.shape)}, row_of {tuple(ro.shape)} for "
                f"{self.n} rows")
        sp = sp.long()
        w = torch.diff(sp)

        def span(t):
            return (torch.aminmax(t.long()) if t.numel()
                    else (sp.new_tensor(0), sp.new_tensor(-1)))

        self.cols = c = _repoint_padding(v, c, sp)
        spans = _slice_spans(c, sp)
        first, last, bad, cmin, cmax, rmin, rmax, stage = torch.stack([
            sp[0], sp[-1],
            ((w < 0) | (w % SLICE != 0) | (w >= _MAX_SLICE_SLOTS)).sum(),
            *span(c), *span(ro), _stage_cap(_block_windows(spans))]).tolist()
        if first != 0 or last != v.numel() or bad:
            raise ValueError(f"SELL pack: slice_ptr must rise from 0 to "
                             f"{v.numel()} in multiples of {SLICE}, fewer "
                             f"than {_MAX_SLICE_SLOTS} slots a slice")
        if cmin < 0 or cmax >= self.ncols or rmin < 0 or rmax >= self.n:
            raise ValueError(f"SELL pack: columns in [{cmin}, {cmax}] of "
                             f"{self.ncols}, rows in [{rmin}, {rmax}] of "
                             f"{self.n}")
        return int(v.numel()), spans, stage

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nslices(self) -> int:
        return self.slice_ptr.shape[0] - 1

    def _fields(self):
        return {"vals": self.vals, "cols": self.cols,
                "slice_ptr": self.slice_ptr, "row_of": self.row_of}

    def _rebuild(self, spans, **fields):
        return type(self)(fields["vals"], fields["cols"],
                          fields["slice_ptr"], fields["row_of"], self.n,
                          self.nnz, ncols=self.ncols, sigma=self.sigma,
                          derived=(self.nslots, spans, self.stage_cap))

    def to(self, device=None, dtype=None):
        """A copy with the tensors on ``device`` and the values in
        ``dtype`` (each default: unchanged)."""
        f = {k: v.to(device) for k, v in self._fields().items()}
        if dtype is not None:
            f["vals"] = f["vals"].to(dtype)
        return self._rebuild(self.spans.to(device), **f)

    def with_vals(self, vals):
        """The same pattern with other slot values (e.g. |vals|)."""
        f = self._fields()
        f["vals"] = vals
        return self._rebuild(self.spans, **f)

    def save(self, path: str) -> None:
        """Persist the pack (npz): pack once, ``load`` on every restart."""
        np.savez(path, **{k: v.cpu().numpy() for k, v in self._fields().items()},
                 meta=np.asarray([self.n, self.ncols, self.nnz, self.sigma],
                                 np.int64))

    @classmethod
    def load(cls, path: str, device=None):
        with np.load(_npz(path), allow_pickle=False) as z:
            n, ncols, nnz, sigma = (int(v) for v in z["meta"])
            return cls(*(host_tensor(z[k], device)
                         for k in ("vals", "cols", "slice_ptr", "row_of")),
                       n, nnz, ncols=ncols, sigma=sigma)


class SellBucketed(SellData):
    """The bucketed pack: a ``SellData`` sorted over ``BUCKET_SIGMA`` rows
    (module doc)."""


class SellSeg:
    """The segmented pack (module doc).

    base:    ``SellData`` whose rows are the segments (base.n segments,
             base.ncols = n columns).
    seg_ptr: (n + 1,) int64 first segment of each row.
    n, nnz:  rows (= columns) and stored entries; seg_len: L.
    validate: check, with one sync, that seg_ptr rises from 0 to base.n
             (B10 reads the partials by it unchecked); the packer, which
             builds it so, passes False.
    """

    def __init__(self, base: SellData, seg_ptr, n, nnz, seg_len=SEG_LEN, *,
                 validate: bool = True):
        self.base = base
        self.seg_ptr = seg_ptr
        self.n = int(n)
        self.nnz = int(nnz)
        self.seg_len = int(seg_len)
        if validate:
            s = seg_ptr.long()
            ok = seg_ptr.shape == (self.n + 1,) and base.ncols == self.n
            if ok:
                first, last, bad = torch.stack(
                    [s[0], s[-1], (torch.diff(s) < 0).sum()]).tolist()
                ok = first == 0 and last == base.n and not bad
            if not ok:
                raise ValueError(f"segmented pack: seg_ptr must rise from 0 "
                                 f"to {base.n} segments over {self.n} rows")

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def to(self, device=None, dtype=None):
        return SellSeg(self.base.to(device, dtype), self.seg_ptr.to(device),
                       self.n, self.nnz, self.seg_len, validate=False)

    def with_vals(self, vals):
        return SellSeg(self.base.with_vals(vals), self.seg_ptr, self.n,
                       self.nnz, self.seg_len, validate=False)

    def save(self, path: str) -> None:
        b = self.base
        np.savez(path, **{k: v.cpu().numpy() for k, v in b._fields().items()},
                 seg_ptr=self.seg_ptr.cpu().numpy(),
                 meta=np.asarray([b.n, b.ncols, b.nnz, b.sigma], np.int64),
                 seg_meta=np.asarray([self.n, self.nnz, self.seg_len],
                                     np.int64))

    @classmethod
    def load(cls, path: str, device=None):
        base = SellData.load(path, device=device)
        with np.load(_npz(path), allow_pickle=False) as z:
            n, nnz, seg_len = (int(v) for v in z["seg_meta"])
            seg_ptr = host_tensor(z["seg_ptr"], device)
        return cls(base, seg_ptr, n, nnz, seg_len)


def _npz(path: str) -> str:
    # np.savez appends .npz to a bare name
    return path if os.path.exists(path) or path.endswith(".npz") \
        else path + ".npz"


# ---------------------------------------------------------------- spans --

def _slot_owner(nslots, slice_ptr):
    """The slice of each of ``nslots`` slots (clamped into range)."""
    slot = torch.arange(nslots, device=slice_ptr.device)
    return (torch.searchsorted(slice_ptr, slot, right=True) - 1).clamp_(
        0, slice_ptr.numel() - 2)


def _repoint_padding(vals, cols, slice_ptr):
    """``cols`` with every value-0 slot pointed at its slice's lowest
    column among the nonzero slots (slices without one keep theirs): the
    packers' padding. A pack saved by an earlier version holds column 0
    there, which would stretch its spans to 0; a stored zero multiplies
    any x to 0, so products do not change."""
    ns = slice_ptr.numel() - 1
    if ns < 1 or cols.numel() == 0 or cols.shape != vals.shape:
        return cols
    owner = _slot_owner(cols.numel(), slice_ptr)
    big = 2 ** 62
    nz = vals != 0
    lo = torch.full((ns,), big, dtype=torch.int64, device=cols.device)
    lo.scatter_reduce_(0, owner, torch.where(nz, cols.long(), big), "amin")
    target = lo[owner]
    return torch.where(~nz & (target < big), target, cols.long()).to(
        cols.dtype)


def _slice_spans(cols, slice_ptr):
    """(nslices, 2) int32 [min, max] column over each slice's slots ([0, -1]
    for a slice without slots), on the pack's device and without a sync; a
    broken ``slice_ptr`` gives spans that the caller's check discards."""
    ns = slice_ptr.numel() - 1
    if ns < 1 or cols.numel() == 0:
        return torch.tensor([[0, -1]] * max(ns, 0), dtype=torch.int32,
                            device=cols.device).reshape(-1, 2)
    owner = _slot_owner(cols.numel(), slice_ptr)
    c = cols.long()
    lo = torch.full((ns,), 2 ** 31, dtype=torch.int64, device=cols.device)
    hi = torch.full((ns,), -1, dtype=torch.int64, device=cols.device)
    lo.scatter_reduce_(0, owner, c, "amin")
    hi.scatter_reduce_(0, owner, c, "amax")
    empty = hi < lo
    return torch.stack([lo.masked_fill(empty, 0), hi.masked_fill(empty, -1)],
                       dim=1).to(torch.int32)


def _block_windows(spans, vec: int = _VEC):
    """Per B9 block (8 slices, 256 rows), the values its staged x window
    holds: the union of the slices' spans from a ``vec``-aligned start,
    rounded up to whole 16-byte pieces of ``vec`` values (float32's 4, the
    default, bounds float64's 2); 0 for a block without entries."""
    ns = spans.shape[0]
    per = ROWS_PER_BLOCK // SLICE
    pad = -ns % per
    lo, hi = spans[:, 0].long(), spans[:, 1].long()
    empty = hi < lo
    big = torch.full((pad,), 2 ** 62, dtype=torch.int64, device=spans.device)
    lo = torch.cat([lo.masked_fill(empty, 2 ** 62), big]).view(-1, per)
    hi = torch.cat([hi.masked_fill(empty, -1), torch.full_like(big, -1)])
    lo, hi = lo.amin(1), hi.view(-1, per).amax(1)
    start = lo - lo % vec
    return torch.where(hi >= lo, (hi + 1 - start + vec - 1) // vec * vec, 0)


def _stage_cap(windows):
    """The largest block window within ``STAGE_ELEMS`` (0 if none): the
    shared memory of a B9 launch, so a pack whose windows are small (or
    none fits) takes no more than it stages."""
    fit = torch.where(windows <= STAGE_ELEMS, windows, 0)
    return fit.max() if fit.numel() else fit.new_tensor(0)


def stage_blocks(data: SellData):
    """Per B9 block of ``data`` (bool tensor): whether its x window is
    staged in shared memory (the rest gather from global memory)."""
    w = _block_windows(data.spans, 16 // data.vals.element_size())
    return (w > 0) & (w <= data.stage_cap)


# ------------------------------------------------------------- packing --

def _csr(rows_cols_vals, n: int, dtype):
    """Sorted CSR (indptr, indices, data) with duplicates summed."""
    import scipy.sparse as sp

    rows, cols, vals = rows_cols_vals
    A = sp.coo_matrix((np.asarray(vals, dtype=dtype),
                       (np.asarray(rows), np.asarray(cols))),
                      shape=(n, n)).tocsr()
    A.sort_indices()
    return A.indptr.astype(np.int64), A.indices, A.data


def _pack_csr(indptr, indices, data, nrows: int, ncols: int, sigma: int,
              device, cls=SellData) -> SellData:
    """SELL-C-sigma pack (module doc) of the CSR rows, with its spans."""
    if nrows >= 2 ** 31 or ncols >= 2 ** 31:
        raise ValueError("SELL packs take fewer than 2^31 rows and columns")
    sigma = max(SLICE, sigma // SLICE * SLICE)
    deg = np.diff(indptr)
    top = int(deg.max(initial=0)) + 1
    if (top - 1) * SLICE >= _MAX_SLICE_SLOTS:
        raise ValueError(f"SELL packs take rows of fewer than "
                         f"{_MAX_SLICE_SLOTS // SLICE} entries; the "
                         f"segmented pack splits longer ones")
    # stable: longest first inside each sigma window, row order on ties
    key = (np.arange(nrows, dtype=np.int64) // sigma) * top + (top - 1 - deg)
    row_of = np.argsort(key, kind="stable")
    ns = -(-nrows // SLICE)
    pdeg = np.zeros(ns * SLICE, np.int64)
    pdeg[:nrows] = deg[row_of]
    width = pdeg.reshape(ns, SLICE).max(axis=1)
    slice_ptr = np.zeros(ns + 1, np.int64)
    np.cumsum(width * SLICE, out=slice_ptr[1:])
    # each slice's column span over its entries; padded slots take lo_s
    rlo = np.full(ns * SLICE, 2 ** 62, np.int64)
    rhi = np.full(ns * SLICE, -1, np.int64)
    live = deg > 0
    if live.any():
        first = indptr[:-1][live]
        lo_r = np.full(nrows, 2 ** 62, np.int64)
        hi_r = np.full(nrows, -1, np.int64)
        lo_r[live] = np.minimum.reduceat(indices[:indptr[-1]], first)
        hi_r[live] = np.maximum.reduceat(indices[:indptr[-1]], first)
        rlo[:nrows], rhi[:nrows] = lo_r[row_of], hi_r[row_of]
    lo = rlo.reshape(ns, SLICE).min(axis=1)
    hi = rhi.reshape(ns, SLICE).max(axis=1)
    lo[hi < 0] = 0
    spans = np.stack([lo, hi], axis=1).astype(np.int32)
    inv = np.empty(nrows, np.int64)
    inv[row_of] = np.arange(nrows)
    p = np.repeat(inv, deg)                          # packed row per entry
    j = np.arange(indptr[-1], dtype=np.int64) - np.repeat(indptr[:-1], deg)
    slot = slice_ptr[p // SLICE] + j * SLICE + p % SLICE
    vals = np.zeros(int(slice_ptr[-1]), data.dtype)
    cols = np.repeat(spans[:, 0], width * SLICE)
    vals[slot] = data
    cols[slot] = indices[:indptr[-1]]
    spans_t = torch.as_tensor(spans)
    stage = int(_stage_cap(_block_windows(spans_t)))
    return cls(host_tensor(vals, device), host_tensor(cols, device),
               host_tensor(slice_ptr, device),
               host_tensor(row_of.astype(np.int32), device),
               nrows, int(indptr[-1]), ncols=ncols, sigma=sigma,
               derived=(int(slice_ptr[-1]), host_tensor(spans_t, device),
                        stage))


def sell_pack(rows_cols_vals, n: int, dtype=np.float32, window: int = 2048,
              residue: bool = False, mode: str | None = None,
              max_chunks: int = 4, uniform_k: bool | None = None, *,
              sigma: int = SIGMA, device=None) -> SellData:
    """Pack COO (rows, cols, vals) of an n x n matrix into SELL-C-sigma
    (module doc); duplicate (row, col) entries are summed. ``window``,
    ``residue``, ``mode``, ``max_chunks`` and ``uniform_k`` are the JAX
    pack's TPU options and have no effect."""
    indptr, indices, data = _csr(rows_cols_vals, n, dtype)
    return _pack_csr(indptr, indices, data, n, n, sigma, device)


def sell_pack_bucketed(rows_cols_vals, n: int, dtype=np.float32,
                       window: int = 2048, kmax: int = 8, *,
                       sigma: int = BUCKET_SIGMA, device=None) -> SellBucketed:
    """The bucketed pack: ``sell_pack`` sorted over ``sigma`` rows.
    ``window`` and ``kmax`` have no effect."""
    indptr, indices, data = _csr(rows_cols_vals, n, dtype)
    return _pack_csr(indptr, indices, data, n, n, sigma, device,
                     cls=SellBucketed)


def sell_pack_seg(rows_cols_vals, n: int, dtype=np.float32, *,
                  seg_len: int = SEG_LEN, sigma: int = SIGMA,
                  device=None) -> SellSeg:
    """The segmented pack (module doc): rows split into segments of at
    most ``seg_len`` entries, each packed as a row of its own."""
    if seg_len < 1:
        raise ValueError(f"seg_len must be >= 1, got {seg_len}")
    device = resolve_device(device)
    indptr, indices, data = _csr(rows_cols_vals, n, dtype)
    deg = np.diff(indptr)
    k = -(-deg // seg_len)                   # segments per row (0 if empty)
    seg_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(k, out=seg_ptr[1:])
    nseg = int(seg_ptr[-1])
    seg_row = np.repeat(np.arange(n, dtype=np.int64), k)
    first = np.arange(nseg, dtype=np.int64) - seg_ptr[seg_row]
    seg_indptr = np.empty(nseg + 1, np.int64)
    seg_indptr[:-1] = indptr[seg_row] + seg_len * first
    seg_indptr[-1] = indptr[-1]
    base = _pack_csr(seg_indptr, indices, data, nseg, n, sigma, device)
    return SellSeg(base, host_tensor(seg_ptr, device), n,
                   int(indptr[-1]), seg_len, validate=False)


# --------------------------------------------------------------- twins --

def sell_spmv_ref(data: SellData, x):
    """Plain twin of B9: slot products summed per packed row, scattered to
    the original rows."""
    prod = data.vals * x[data.cols]
    slot_row = (torch.repeat_interleave(
        torch.arange(data.nslices, device=prod.device),
        torch.diff(data.slice_ptr)) * SLICE
        + torch.arange(prod.shape[0], device=prod.device) % SLICE)
    acc = torch.zeros(data.nslices * SLICE, dtype=prod.dtype,
                      device=prod.device).index_add_(0, slot_row, prod)
    y = torch.empty(data.n, dtype=prod.dtype, device=prod.device)
    y[data.row_of.long()] = acc[:data.n]
    return y


def seg_compact_ref(partials, seg_ptr):
    """Plain twin of B10: y_i = sum of partials[seg_ptr[i]:seg_ptr[i+1]]."""
    n = seg_ptr.shape[0] - 1
    seg_row = torch.repeat_interleave(torch.arange(n, device=partials.device),
                                      torch.diff(seg_ptr))
    return torch.zeros(n, dtype=partials.dtype,
                       device=partials.device).index_add_(0, seg_row, partials)


def sell_spmv_bucketed_ref(data: SellBucketed, x):
    """Plain twin for the bucketed pack (the same layout)."""
    return sell_spmv_ref(data, x)


def sell_spmv_seg_ref(data: SellSeg, x):
    """Plain twin of the segmented product: B9's twin, then B10's."""
    return seg_compact_ref(sell_spmv_ref(data.base, x), data.seg_ptr)


# ------------------------------------------------------------ wrappers --

def _check_array(what, t, dtype):
    if t.dtype != dtype or not t.is_contiguous() or t.dim() != 1:
        raise ValueError(f"{what}: arrays must be contiguous 1-D {dtype}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_devices(what, device, *arrays):
    for t in arrays:
        if t.device != device:
            raise ValueError(f"{what}: arrays on {t.device} and {device}")


class _SellLaunch(ctypes.Structure):
    """``eu::SellLaunch`` (csrc/sell.cu): what a B9 launch reads on the
    host, built once per plan."""
    _fields_ = [("vals", ctypes.c_void_p), ("cols", ctypes.c_void_p),
                ("slice_ptr", ctypes.c_void_p), ("spans", ctypes.c_void_p),
                ("row_of", ctypes.c_void_p), ("nrows", ctypes.c_longlong),
                ("ncols", ctypes.c_longlong), ("nslices", ctypes.c_longlong),
                ("stage_cap", ctypes.c_int), ("unroll", ctypes.c_int)]


class SellPlan:
    """What every B9 launch on one pack shares: the checks of the pack's
    arrays (dtypes, contiguity, sizes, one device), made once; the launch
    descriptor (``_SellLaunch``: their pointers, sizes, ``stage_cap`` and
    the unroll, 16 slots of loads in flight when the pack's rows average
    ``WIDE_ROWS`` slots or more, 4 otherwise); the C entry point.
    A call compares x's dtype, device and shape with the pack's, allocates
    y and launches on the current stream, taken as a raw handle. A pack
    that is not on a CUDA device raises."""

    def __init__(self, data: SellData):
        self.device, dt = data.vals.device, data.vals.dtype
        _build.require_cuda("sell_spmv", self.device)
        if dt not in _build.KERNEL_DTYPES:
            raise ValueError(f"sell_spmv takes float32/float64, got {dt}")
        self.dtype = dt
        _check_devices("sell_spmv", self.device, data.cols, data.slice_ptr,
                       data.spans, data.row_of)
        for t, want in ((data.vals, dt), (data.cols, torch.int32),
                        (data.slice_ptr, torch.int64),
                        (data.row_of, torch.int32)):
            _check_array("sell_spmv", t, want)
        if (data.vals.numel() != data.nslots
                or data.cols.numel() != data.nslots
                or data.row_of.numel() != data.n
                or data.spans.shape != (data.nslices, 2)
                or data.spans.dtype != torch.int32
                or not data.spans.is_contiguous()):
            raise ValueError(f"sell_spmv: vals {data.vals.numel()}, cols "
                             f"{data.cols.numel()} slots, row_of "
                             f"{data.row_of.numel()} rows and spans "
                             f"{tuple(data.spans.shape)}, the pack has "
                             f"{data.nslots} slots, {data.n} rows and "
                             f"{data.nslices} slices")
        self.n, self.shape = data.n, (data.ncols,)
        self.square = data.n == data.ncols
        wide = data.nslots >= WIDE_ROWS * SLICE * data.nslices
        # the descriptor holds raw pointers: keep the arrays alive with it
        self.arrays = (data.vals, data.cols, data.slice_ptr, data.spans,
                       data.row_of)
        self.launch = _SellLaunch(
            data.vals.data_ptr(), data.cols.data_ptr(),
            data.slice_ptr.data_ptr(), data.spans.data_ptr(),
            data.row_of.data_ptr(), data.n, data.ncols, data.nslices,
            data.stage_cap, 16 if wide else 4)
        self.addr = ctypes.addressof(self.launch)
        self.fn = getattr(_build.library(),
                          f"eu_sell_spmv_{_build.suffix(dt)}")

    def __call__(self, x):
        if x.dtype != self.dtype:
            raise ValueError(f"sell_spmv: pack in {self.dtype}, vector in "
                             f"{x.dtype}; cast the pack once with "
                             "data.to(dtype=...)")
        if x.device != self.device or x.shape != self.shape:
            raise ValueError(f"sell_spmv: expected a {self.shape} vector on "
                             f"{self.device}, got {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous():
            x = x.contiguous()
        # empty_like parses no device: cheaper on the host than torch.empty
        y = torch.empty_like(x) if self.square else x.new_empty(self.n)
        if self.n == 0:
            return y
        code = self.fn(self.addr, x.data_ptr(), y.data_ptr(),
                       _build.raw_stream(self.device))
        if code:
            _build.check(code, "SELL SpMV kernel (B9)")
        _build.launches["sell_spmv"] += 1
        return y


class SegPlan:
    """``SellPlan`` for the segmented pack: B9 over the segments (``base``),
    then B10 on its partials, with the checks of ``seg_ptr`` made once."""

    def __init__(self, data: SellSeg):
        self.seg_ptr = data.seg_ptr
        self.base = launch_plan(data.base)
        _check_devices("seg_compact", self.base.device, data.seg_ptr)
        _check_array("seg_compact", data.seg_ptr, torch.int64)
        if data.seg_ptr.shape != (data.n + 1,):
            raise ValueError(f"seg_compact: seg_ptr {tuple(data.seg_ptr.shape)}"
                             f" for {data.n} rows")
        self.n = data.n
        self.fn = getattr(_build.library(),
                          f"eu_seg_compact_{_build.suffix(self.base.dtype)}")

    def __call__(self, x):
        # B9's partials: contiguous, (nseg,), in the pack's dtype and device
        return _launch_seg_compact(self.fn, self.base(x), self.seg_ptr,
                                   self.n)


def launch_plan(data):
    """The pack's ``SellPlan`` (``SegPlan`` for a ``SellSeg``), built at its
    first launch, which raises if the pack does not suit the kernels, and
    kept in the pack; rebuilt when the pack's values are reassigned (its
    index arrays are fixed when it is built)."""
    plan = data.__dict__.get("_plan")
    if plan is None or plan.vals_src is not _vals(data):
        plan = SegPlan(data) if isinstance(data, SellSeg) else SellPlan(data)
        plan.vals_src = _vals(data)
        data._plan = plan
    return plan


def _vals(data):
    return data.base.vals if isinstance(data, SellSeg) else data.vals


def sell_spmv(data: SellData, x):
    """y = A x for a SELL-C-sigma pack: kernel B9 on CUDA, its twin on CPU.
    On CUDA the pack's values must be in x's dtype (cast the pack once with
    ``data.to(dtype=...)``; a launch makes no copy of it). The launch takes
    the pack's ``stage_cap`` values of shared memory for the x windows and
    keeps 16 slots of loads in flight per row when the pack's rows average
    ``WIDE_ROWS`` slots or more, 4 otherwise; the pack's ``SellPlan`` holds
    both."""
    if x.device.type == "cpu":
        return sell_spmv_ref(data, x)
    return launch_plan(data)(x)


def _launch_seg_compact(fn, partials, seg_ptr, n):
    y = partials.new_empty(n)
    if n == 0:
        return y
    code = fn(partials.data_ptr(), seg_ptr.data_ptr(), n, y.data_ptr(),
              _build.raw_stream(partials.device))
    if code:
        _build.check(code, "segment compaction kernel (B10)")
    _build.launches["seg_compact"] += 1
    return y


def seg_compact(partials, seg_ptr):
    """y_i = sum of the partials of row i's segments, in segment order:
    kernel B10 on CUDA, its twin on CPU. ``seg_ptr`` must rise from 0 to
    ``partials.numel()``: the kernel reads the partials by it unchecked (a
    check here would sync every product), and ``SellSeg`` checks it once
    when built. A pack's ``launch_plan`` makes the host checks below once."""
    if partials.device.type == "cpu":
        return seg_compact_ref(partials, seg_ptr)
    _build.check_operands("seg_compact", partials, seg_ptr)
    _check_array("seg_compact", partials, partials.dtype)
    _check_array("seg_compact", seg_ptr, torch.int64)
    fn = getattr(_build.library(),
                 f"eu_seg_compact_{_build.suffix(partials.dtype)}")
    return _launch_seg_compact(fn, partials, seg_ptr, seg_ptr.shape[0] - 1)


def sell_spmv_bucketed(data: SellBucketed, x):
    """y = A x for the bucketed pack: one launch of B9."""
    return sell_spmv(data, x)


def sell_spmv_seg(data: SellSeg, x):
    """y = A x for the segmented pack: B9 over the segments, then B10 (on
    CPU their twins)."""
    if x.device.type == "cpu":
        return sell_spmv_seg_ref(data, x)
    return launch_plan(data)(x)

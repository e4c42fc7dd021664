"""One-launch polynomial recurrences (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/resident.py``).

    omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
    w          += cw_k omega_k,      k = 0..m-1,  omega_0 = s x,  omega_{-1} = 0

with ``rows`` the (m, 4) per-step scalars (ca, cb, cc, cw) and the scale
``s`` as device data (s = 1 for B4-B6). The recurrence serves every
polynomial action (Chebyshev rows, the Lanczos replay rows of the
two-pass expv and phiv).

Five hand-written CUDA kernels carry it, each in one launch (persistent
and cooperative, except B2's cluster form):

* B1 ``recurrence_apply_resident``: A a 1-D constant stencil with
  Dirichlet ends; also returns sum w^2. Two forms, chosen once per
  operator by its ``RecurrencePlan``: the neighbour form
  (``resident_nbr_kernel`` of ``csrc/resident_family.cu``, shared with
  B5), its sum of w^2 taken by the last block of the launch, where a
  block's state fits on chip; the grid-barrier kernel of
  ``csrc/resident.cu`` otherwise.
* K3 and K4, the batched forms of B2 and B1 (``expv_batched``'s 1-D
  two-pass, ``expv_two_pass_resident`` on a (batch, n) b). K3
  (``LanczosPlan.batched``, one launch for the batch): clusters of B2's
  shape carrying P rows each (``cluster_batch_geometry``: P = 1 is B2's
  kernel, one cluster a row; P = 2, 4 ``csrc/resident_cluster_batched.cu``,
  the rows' y in shared memory), the smallest P whose clusters the card
  holds in one wave; above the cluster gate each row takes B2's grid
  form, counted as B2 launches, as a scalar call would. K4
  (``RecurrenceBatchPlan``, ``csrc/resident_nbr_batched.cu``): the SMs
  split among the rows of a launch, which must all be resident, each
  block's rows in registers with s steps a halo exchange
  (``nbr_rows_geometry``), the batch in groups of the rows a launch
  holds, each group one launch. Their twins are
  ``resident_lanczos_batched_ref`` and ``resident_recurrence_batched_ref``.
* B2 ``lanczos_coeffs_resident``: Lanczos pass 1 with alpha and beta
  reduced inside the kernel each step (deterministic fixed-order
  reductions), breakdown masking the remaining steps. Two forms, chosen
  once per operator by its ``LanczosPlan``: one thread-block cluster with
  the state in shared memory (``csrc/resident_cluster.cu``) up to the
  size where it is faster (``CLUSTER_MAX_ROWS``), a persistent
  cooperative grid (``csrc/resident.cu``) above that.
* B4 ``recurrence_apply_resident_multi`` (``csrc/resident_family.cu``):
  B1's operator with p accumulators over one shared omega chain,
  W[:, j] += cw[k, j] omega_k (all phi orders in one pass). Two forms,
  chosen by its ``MultiPlan``: blocks that keep their rows on chip and
  wait for their two neighbours only (the neighbour form), where a
  block's state fits on chip; the family kernel with one grid barrier a
  step otherwise.
* B5 ``recurrence_apply_resident_banded``: A a ``BandedOperator``,
  z = sum_j D_j * shift(omega, o_j), zero outside the vector. Two forms,
  chosen by its ``BandedRecurrencePlan``: the neighbour form, with as many
  diagonals' rows kept in shared memory as fit beside the state, where
  max|o| is within a block's rows and the state fits; the family kernel
  otherwise.
* B6 ``recurrence_apply_resident_grid``: A a 2-D/3-D constant stencil on
  the natural row-major grid with Dirichlet ends, for the grids of
  ``resident_grid_supported``. Two forms, chosen by its
  ``GridRecurrencePlan``: blocks that own (z, y)-tiles of whole x-lines,
  keep them on chip and wait for the tiles around them only (the
  neighbour form, ``resident_grid_nbr_kernel``), where a tile's state fits
  on chip; the family kernel with one grid barrier a step otherwise.

All five launch through plans (``recurrence_plan``, ``lanczos_plan``,
``multi_plan``, ``banded_plan``, ``grid_plan``, kept on the operator per
dtype and CUDA device): the cast coefficients or diagonals, the form,
the launch geometry queried once, the buffers (one set per stream, so
launches on two streams may overlap) and a C launch descriptor, so a
call compares x, allocates its outputs and makes one ctypes call. A
refused or failed launch raises; no form retries another.

Each has a plain-torch twin (``resident_recurrence_ref``,
``resident_lanczos_ref``, ``resident_multi_ref``, ``resident_banded_ref``,
``resident_grid_ref``) computing the same contract. A wrapper runs the
twin only for CPU tensors; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..sparse import BandedOperator
from ..stencil import StencilOperator, stencil_apply
from ..krylov import _col
from . import _build
from .dispatch import refuse_grad
from .spmv import banded_spmv_ref

__all__ = ["recurrence_apply_resident", "resident_recurrence",
           "resident_recurrence_ref", "lanczos_coeffs_resident",
           "resident_lanczos", "resident_lanczos_ref",
           "expv_two_pass_resident", "resident_supported",
           "recurrence_apply_resident_multi", "resident_multi_ref",
           "recurrence_apply_resident_banded", "resident_banded_ref",
           "resident_banded_supported", "recurrence_apply_resident_grid",
           "resident_grid_ref", "resident_grid_supported",
           "phiv_two_pass_resident", "L2_STATE_BUDGET", "LanczosPlan",
           "lanczos_plan", "cluster_shape", "MultiPlan", "multi_plan",
           "RecurrencePlan", "recurrence_plan", "BandedRecurrencePlan",
           "banded_plan", "nbr_geometry", "nbr_smem", "CLUSTER_SIZES",
           "CLUSTER_MAX_ROWS", "GridRecurrencePlan", "grid_plan", "GridTiles",
           "grid_tiles", "grid_smem", "grid_dirs", "grid_halo_lines",
           "GRID_MAX_ROWS", "GRID_MAX_HALO", "resident_lanczos_batched_ref",
           "resident_recurrence_batched_ref", "RecurrenceBatchPlan",
           "recurrence_batch_plan", "ClusterBatch", "cluster_batch_geometry",
           "CLUSTER_BATCH_ROWS", "RowsGeometry", "nbr_rows_geometry",
           "NBR_ROWS_THREADS", "NBR_ROWS_PER_THREAD", "NBR_ROWS_MAX_HALO",
           "NBR_ROWS_STEPS"]

# The gates of B4 (dispatch.resident_multi_ok) and B6
# (resident_grid_supported): their state (3 recurrence vectors plus the
# accumulators) within 40 MiB, the H100's 50 MB L2 less room for the other
# traffic. B6 against B3's sweeps, one call each on the H100 (chip_smoke.py
# phase 5, PERF.md): B6 faster at every grid measured within the budget;
# above it, float32 even at 128^3 and slower from 160^3, float64 faster up
# to 216^3 on the family kernel (a budget of its own for float64 would move
# config #5's Chebyshev calls off the sweeps, where the main path keeps them).
L2_STATE_BUDGET = 40 * 2 ** 20

# B2's cluster form (csrc/resident_cluster.cu): a cluster of 16 blocks
# where the card schedules one (16 needs a GPC with 16 free SMs), else 8
CLUSTER_SIZES = (16, 8)
# Rows a block of the cluster form owns at most, past which the grid
# form is faster on the H100 (resident_times.py, both forms at m = 40):
# float64 lost at 9375 rows (16 a thread, which spill), won at 6250;
# float32 won at 18750 and lost at 28750, and 23,000 is where the two
# lines of those four times cross
CLUSTER_MAX_ROWS = {torch.float32: 23_000, torch.float64: 8_192}
# K3: rows a cluster carries, fastest first (1: B2's kernel, u and y in
# registers; 2 and 4: the rows kernel, y in shared memory), and the u
# values a thread of the rows kernel keeps over its rows (eu::kRowRegs)
CLUSTER_BATCH_ROWS = (1, 2, 4)
CLUSTER_ROW_REGS = {torch.float32: 32, torch.float64: 14}
# K4 (csrc/resident_nbr_batched.cu): threads a block at most
# (eu::kRowsThreads), the rows a thread its instantiations keep (J), the
# widest stencil reach they take (H), and the steps a halo exchange tried,
# the most first
NBR_ROWS_THREADS = 512
NBR_ROWS_PER_THREAD = (4, 8, 13)
NBR_ROWS_MAX_HALO = 2
NBR_ROWS_STEPS = (8, 4, 2, 1)
NBR_MIN_ROWS = 256              # rows a block of the neighbour form owns at least
NBR_MAX_COLS = 8                # eu::kMaxCols: accumulators of the neighbour form
NBR_FLAG_STRIDE = 16            # eu::kFlagStride: one flag per 128-byte line
# B6's neighbour form: a thread owns at most 8 tile rows and copies at most
# 4 halo rows (eu::kGridRows, eu::kGridHalo, times 1024 threads)
GRID_MAX_ROWS, GRID_MAX_HALO = 8 * 1024, 4 * 1024

def resident_supported(op) -> bool:
    """True when ``op`` is a 1-D real constant-coefficient StencilOperator
    the resident kernels take."""
    if not isinstance(op, StencilOperator) or len(op.grid_shape) != 1:
        return False
    if op.coeffs.is_complex():
        return False            # real kernels would drop imaginary parts
    n = op.grid_shape[0]
    return (0 < n and len(op.offsets) <= _build.MAX_POINTS
            and all(abs(off[0]) < n for off in op.offsets))


def resident_banded_supported(op) -> bool:
    """True for a real ``BandedOperator`` with at most MAX_POINTS
    diagonals, every offset inside the vector. No size cap: B5 streams its
    diagonals and state through HBM when they exceed L2."""
    if not isinstance(op, BandedOperator) or op.diags.is_complex():
        return False
    k, n = op.diags.shape
    return (0 < n and 0 < k <= _build.MAX_POINTS
            and all(abs(o) < n for o in op.offsets))


def _grid_operator(op) -> bool:
    """A real 2-D/3-D constant ``StencilOperator`` with at most MAX_POINTS
    points: what B6's kernels take at any size."""
    return (isinstance(op, StencilOperator) and len(op.grid_shape) in (2, 3)
            and not op.coeffs.is_complex()
            and 0 < len(op.offsets) <= _build.MAX_POINTS)


def resident_grid_supported(op, dtype=None) -> bool:
    """True for a real 2-D/3-D constant ``StencilOperator`` whose four
    state vectors (previous, current, next, w) in ``dtype`` (default: the
    operator's) fit ``L2_STATE_BUDGET``."""
    if not _grid_operator(op):
        return False
    return 4 * op.shape[0] * (dtype or op.dtype).itemsize <= L2_STATE_BUDGET


def _flat_offsets(op):
    return [off[0] for off in op.offsets]


def _stencil(x, offsets, cvals):
    return stencil_apply(x, [(o,) for o in offsets], cvals)


# --------------------------------------------------------------- twins --

def resident_recurrence_ref(x, rows, cvals, offsets, scale):
    """Plain twin of B1: (w, sum w^2) for the module-doc recurrence."""
    wc = scale * x
    wp = torch.zeros_like(x)
    w = torch.zeros_like(x)
    for k in range(rows.shape[0]):
        ca, cb, cc, cw = rows[k]
        w = w + cw * wc
        z = _stencil(wc, offsets, cvals)
        wp, wc = wc, ca * z + cb * wc + cc * wp
    return w, (w * w).sum()


def resident_lanczos_ref(v0, cvals, offsets, m: int, tol: float):
    """Plain twin of B2: the (m, 2) record of (alpha, beta) from the
    normalized start vector v0, zero after the first beta below tol."""
    vp = torch.zeros_like(v0)
    vc = v0
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alive = torch.ones((), dtype=torch.bool, device=v0.device)
    ab = torch.zeros((m, 2), dtype=v0.dtype, device=v0.device)
    for k in range(m):
        z = _stencil(vc, offsets, cvals)
        alpha = (vc * z).sum()
        y = (z - alpha * vc) - beta_prev * vp
        beta = torch.sqrt(torch.clamp_min((y * y).sum(), 0.0))
        ok = alive & (beta >= tol)
        ab[k, 0] = torch.where(alive, alpha, 0.0)
        ab[k, 1] = torch.where(ok, beta, 0.0)
        inv = torch.where(ok, 1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        vp, vc = vc, y * inv
        beta_prev = torch.where(ok, beta, 0.0)
        alive = ok
    return ab


def resident_recurrence_batched_ref(X, rows, cvals, offsets, scale):
    """Plain twin of K4: (W, sum w^2 per row) for each row of X (batch, n)
    with its own rows (batch, m, 4) and scale (batch,), the arithmetic of
    ``resident_recurrence_ref`` on that row."""
    wc = _col(scale) * X
    wp = torch.zeros_like(X)
    w = torch.zeros_like(X)
    for k in range(rows.shape[1]):
        ca, cb, cc, cw = (_col(c) for c in rows[:, k].unbind(-1))
        w = w + cw * wc
        z = _stencil(wc, offsets, cvals)
        wp, wc = wc, ca * z + cb * wc + cc * wp
    return w, (w * w).sum(-1)


def resident_lanczos_batched_ref(V0, cvals, offsets, m: int, tol: float):
    """Plain twin of K3: each row's (m, 2) record from the normalized rows
    of V0 (batch, n), (batch, m, 2), as ``resident_lanczos_ref`` on it."""
    nb = V0.shape[0]
    vp = torch.zeros_like(V0)
    vc = V0
    beta_prev = torch.zeros(nb, dtype=V0.dtype, device=V0.device)
    alive = torch.ones(nb, dtype=torch.bool, device=V0.device)
    ab = torch.zeros((nb, m, 2), dtype=V0.dtype, device=V0.device)
    for k in range(m):
        z = _stencil(vc, offsets, cvals)
        alpha = (vc * z).sum(-1)
        y = (z - _col(alpha) * vc) - _col(beta_prev) * vp
        beta = torch.sqrt(torch.clamp_min((y * y).sum(-1), 0.0))
        ok = alive & (beta >= tol)
        ab[:, k, 0] = torch.where(alive, alpha, 0.0)
        ab[:, k, 1] = torch.where(ok, beta, 0.0)
        inv = torch.where(ok, 1.0 / torch.where(beta > 0, beta, 1.0), 0.0)
        vp, vc = vc, y * _col(inv)
        beta_prev = torch.where(ok, beta, 0.0)
        alive = ok
    return ab


def _chain_ref(x, rows, cw, apply):
    """(n, p) accumulators W[:, j] = sum_k cw[k, j] omega_k of the
    module-doc recurrence with omega_0 = x and A omega = apply(omega)."""
    wc = x
    wp = torch.zeros_like(x)
    W = torch.zeros(x.shape + cw.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(rows.shape[0]):
        W = W + wc[:, None] * cw[k][None, :]
        z = apply(wc)
        wp, wc = wc, rows[k, 0] * z + rows[k, 1] * wc + rows[k, 2] * wp
    return W


def resident_multi_ref(x, rows, cw, cvals, offsets):
    """Plain twin of B4: W (n, p) with W[:, j] = sum_k cw[k, j] omega_k for
    a 1-D constant stencil (rows' cw column unused)."""
    return _chain_ref(x, rows, cw, lambda v: _stencil(v, offsets, cvals))


def resident_banded_ref(x, rows, diags, offsets):
    """Plain twin of B5: w for A omega = sum_j D_j * shift(omega, o_j),
    zero outside the vector (B7's twin as the operator)."""
    return _chain_ref(x, rows, rows[:, 3:],
                      lambda v: banded_spmv_ref(diags, offsets, v))[:, 0]


def resident_grid_ref(x, rows, grid_shape, offsets, cvals):
    """Plain twin of B6: w for a constant stencil on the natural
    row-major ``grid_shape`` layout with Dirichlet ends."""
    def apply(v):
        return stencil_apply(v.reshape(grid_shape), offsets, cvals).reshape(-1)

    return _chain_ref(x, rows, rows[:, 3:], apply)[:, 0]


# --------------------------------------------------------------- plans --

def _on(device):
    """``device`` made current for a query (-1: the current device)."""
    return torch.cuda.device(-1 if device.index is None else device.index)


def _checked(code: int, what: str) -> int:
    """A count returned by a C query, negative for a CUDA error."""
    if code < 0:
        _build.check(-code, what)
    return code


def _plan_device(device):
    """``device`` with its index: "cuda" is the current CUDA device, as
    the tensors made on it report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _plan_checks(what, op, dtype, device):
    _build.require_cuda(what, device)
    if dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"{what} takes float32/float64, got {dtype}")
    if not resident_supported(op):
        raise ValueError(f"{what} requires a 1-D real constant "
                         f"StencilOperator (got {type(op).__name__})")
    if op.device != device:
        raise ValueError(f"{what}: operator on {op.device}, vector on "
                         f"{device}")


def _offsets_field(offsets):
    return (ctypes.c_int * _build.MAX_POINTS)(*offsets)


class _LanczosLaunch(ctypes.Structure):
    """``eu::LanczosLaunch`` (csrc/resident_cluster.cu), built once per
    plan."""
    _fields_ = [("cvals", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("rows", ctypes.c_longlong), ("cluster", ctypes.c_int),
                ("k", ctypes.c_int), ("o", ctypes.c_int * _build.MAX_POINTS)]


class _GridLaunch(ctypes.Structure):
    """``eu::GridLaunch`` (csrc/resident_family.cu), built once per plan
    and stream."""
    _fields_ = [("coef", ctypes.c_void_p), ("flags", ctypes.c_void_p),
                ("pub", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("nz", ctypes.c_int), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
                ("tiles_z", ctypes.c_int), ("tiles_y", ctypes.c_int),
                ("tz", ctypes.c_int), ("ty", ctypes.c_int),
                ("hz", ctypes.c_int), ("hy", ctypes.c_int),
                ("hx", ctypes.c_int), ("dirs", ctypes.c_int),
                ("halo_lines", ctypes.c_int), ("k", ctypes.c_int),
                ("dz", ctypes.c_int * _build.MAX_POINTS),
                ("dy", ctypes.c_int * _build.MAX_POINTS),
                ("dx", ctypes.c_int * _build.MAX_POINTS)]


class _NbrLaunch(ctypes.Structure):
    """``eu::NbrLaunch`` (csrc/resident_family.cu), built once per plan
    and stream."""
    _fields_ = [("coef", ctypes.c_void_p), ("flags", ctypes.c_void_p),
                ("halo", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("grid", ctypes.c_int), ("chunk", ctypes.c_int),
                ("h", ctypes.c_int), ("k", ctypes.c_int), ("kd", ctypes.c_int),
                ("o", ctypes.c_int * _build.MAX_POINTS)]


class _RowsLaunch(ctypes.Structure):
    """``eu::RowsLaunch`` (csrc/resident_nbr_batched.cu), built once per
    plan and stream."""
    _fields_ = [("coef", ctypes.c_void_p), ("flags", ctypes.c_void_p),
                ("halo", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("grid", ctypes.c_int), ("chunk", ctypes.c_int),
                ("h", ctypes.c_int), ("k", ctypes.c_int), ("s", ctypes.c_int),
                ("threads", ctypes.c_int), ("per_thread", ctypes.c_int),
                ("o", ctypes.c_int * _build.MAX_POINTS)]


def cluster_shape(n: int, halo: int, max_rows: int, fits):
    """(C, L) of B2's cluster form for n rows and max|o| = ``halo``, or
    None for the grid form: the first C of ``CLUSTER_SIZES`` whose block
    rows L = ceil(n / C) hold the halo, are at most ``max_rows``
    (``CLUSTER_MAX_ROWS``) and for which ``fits(C, L)``, the card's count
    of such clusters it can hold at once, is at least 1 (0 when a block's
    2 L + 16 halo values of shared memory do not fit, or L needs more than
    32 rows a thread)."""
    for c in CLUSTER_SIZES:
        rows = -(-n // c)
        if halo <= rows <= max_rows and fits(c, rows) >= 1:
            return c, rows
    return None


class ClusterBatch(NamedTuple):
    """K3's geometry for a batch (``cluster_batch_geometry``): clusters of
    ``cluster`` blocks owning ``rows`` rows of each of their ``per`` batch
    rows (B2's slab split), ``per_thread`` rows of a batch row a thread,
    ``clusters`` clusters of which the card holds ``active`` at once, so
    ``waves`` waves; ``counts`` the card's answer for every candidate P, in
    ``CLUSTER_BATCH_ROWS`` order."""
    cluster: int
    rows: int
    per: int
    per_thread: int
    clusters: int
    active: int
    waves: int
    counts: tuple


def cluster_batch_geometry(n: int, halo: int, batch: int, max_rows: int,
                           row_regs: int, probe):
    """K3's geometry for ``batch`` rows of n, or None where B2 takes its
    grid form. B2's (C, L) come from ``cluster_shape`` (with ``probe(c,
    rows, 1)``, B2's own kernel); every candidate P of
    ``CLUSTER_BATCH_ROWS`` keeps them, and ``probe(C, L, P)`` is the number
    of such clusters carrying P rows the card holds at once (0 where they
    do not fit). The first P, the fastest, whose ceil(batch / P) clusters
    are all resident at once is taken; where none is, the batch runs in
    waves of P = 1. A thread keeps B2's rows (the least power of two R with
    1024 R >= L) for P = 1 and ``row_regs`` / P rows of each batch row
    otherwise."""
    shape = cluster_shape(n, halo, max_rows, lambda c, rows: probe(c, rows, 1))
    if shape is None:
        return None
    c, rows = shape
    counts = tuple(probe(c, rows, p) for p in CLUSTER_BATCH_ROWS)
    per = next((p for p, a in zip(CLUSTER_BATCH_ROWS, counts)
                if a >= 1 and -(-batch // p) <= a), 1)
    active = counts[CLUSTER_BATCH_ROWS.index(per)]
    clusters = -(-batch // per)
    per_thread = (1 << max(0, (-(-rows // 1024) - 1).bit_length()) if per == 1
                  else row_regs // per)
    return ClusterBatch(c, rows, per, per_thread, clusters, active,
                        -(-clusters // active), counts)


class LanczosPlan:
    """What every B2 launch on one 1-D constant stencil, for vectors of one
    dtype on one CUDA device, shares: the checks, the coefficients in that
    dtype, the form, chosen once by size (``form``: "cluster", one
    thread-block cluster of ``cluster`` blocks with the state in shared
    memory, where ``cluster_shape`` finds one within the dtype's
    ``CLUSTER_MAX_ROWS``; else "grid", the persistent
    cooperative kernel of ``csrc/resident.cu``, with its scratch and
    partials, one set per stream), the launch descriptor and the C entry
    point. A call compares v0, makes the (m, 2) record with
    ``torch.empty`` (the kernel writes every row) and makes one ctypes
    call on the current stream."""

    def __init__(self, op, dtype, device):
        self.device = _plan_device(device)
        _plan_checks("resident_lanczos", op, dtype, self.device)
        self.dtype, self.n = dtype, op.shape[0]
        self.shape = (self.n,)
        offsets = _flat_offsets(op)
        self.k = len(offsets)
        self.cvals = op.coeffs.to(dtype).contiguous()
        lib = _build.library()
        suf = _build.suffix(dtype)
        self.launch = _LanczosLaunch(self.cvals.data_ptr(), self.n, 0, 0,
                                     self.k, _offsets_field(offsets))
        self.addr = ctypes.addressof(self.launch)

        self._b2_fits = getattr(lib, f"eu_lanczos_cluster_fits_{suf}")

        def fits(c, rows):
            self.launch.cluster, self.launch.rows = c, rows
            with _on(self.device):
                return _checked(self._b2_fits(self.addr),
                                "B2 cluster occupancy query")

        shape = cluster_shape(self.n, max(abs(o) for o in offsets),
                              CLUSTER_MAX_ROWS[dtype], fits)
        if shape is not None:
            self.form = "cluster"
            self.cluster, rows = shape
            self.launch.cluster, self.launch.rows = shape
            self.halo = max(abs(o) for o in offsets)
            self.fn = getattr(lib, f"eu_resident_lanczos_cluster_{suf}")
            self.bfn = getattr(lib,
                               f"eu_resident_lanczos_cluster_batched_{suf}")
            self.rfn = getattr(lib, f"eu_resident_lanczos_cluster_rows_{suf}")
            self._rows_fits = getattr(lib,
                                      f"eu_lanczos_cluster_rows_fits_{suf}")
            self._geometries = {}
            return
        self.form, self.cluster = "grid", 0
        with _on(self.device):
            blocks = _checked(lib.eu_resident_max_blocks(
                int(dtype == torch.float64)), "resident kernel occupancy query")
        self.cap = 2 * blocks
        self.scratch = {}       # stream -> (buf, partials) of the grid form
        self.offs = (ctypes.c_int * self.k)(*offsets)
        self.fn = getattr(lib, f"eu_resident_lanczos_{suf}")

    def _scratch(self, stream):
        hit = self.scratch.get(stream)
        if hit is None:
            hit = self.scratch[stream] = (
                torch.empty(3 * self.n, dtype=self.dtype, device=self.device),
                torch.empty(self.cap, dtype=self.dtype, device=self.device))
        return hit

    def __call__(self, v0, m: int, tol: float):
        if (v0.dtype != self.dtype or v0.device != self.device
                or v0.shape != self.shape):
            raise ValueError(f"resident_lanczos: expected a {self.shape} "
                             f"{self.dtype} vector on {self.device}, got "
                             f"{tuple(v0.shape)} {v0.dtype} on {v0.device}")
        if not v0.is_contiguous():
            v0 = v0.contiguous()
        m = int(m)
        ab = torch.empty((m, 2), dtype=self.dtype, device=self.device)
        stream = _build.raw_stream(self.device)
        if self.form == "cluster":
            code = self.fn(self.addr, v0.data_ptr(), m, float(tol),
                           ab.data_ptr(), stream)
        else:
            buf, partials = self._scratch(stream)
            code = self.fn(v0.data_ptr(), self.cvals.data_ptr(), self.offs,
                           self.k, self.n, m, float(tol), ab.data_ptr(),
                           buf.data_ptr(), partials.data_ptr(), self.cap,
                           stream)
        if code:
            _build.check(code, f"resident Lanczos kernel (B2, {self.form} "
                         "form)")
        _build.launches["resident_lanczos"] += 1
        return ab

    def batch_geometry(self, batch: int) -> ClusterBatch:
        """K3's geometry for ``batch`` rows (``cluster_batch_geometry`` on
        the card's answers for B2's (C, L)), chosen once per batch size."""
        hit = self._geometries.get(batch)
        if hit is None:
            probe_launch = _LanczosLaunch.from_buffer_copy(self.launch)
            addr = ctypes.addressof(probe_launch)

            def probe(c, rows, per):
                probe_launch.cluster, probe_launch.rows = c, rows
                with _on(self.device):
                    if per == 1:
                        return _checked(self._b2_fits(addr),
                                        "B2 cluster occupancy query")
                    return _checked(self._rows_fits(addr, per),
                                    "K3 cluster occupancy query")

            hit = self._geometries[batch] = cluster_batch_geometry(
                self.n, self.halo, batch, CLUSTER_MAX_ROWS[self.dtype],
                CLUSTER_ROW_REGS[self.dtype], probe)
        return hit

    def batched(self, V0, m: int, tol: float):
        """The (batch, m, 2) records of the normalized rows of V0 (batch,
        n): the cluster form as K3, one launch of clusters of P rows
        (``batch_geometry``); the grid form one B2 launch a row (module
        doc)."""
        if (V0.dtype != self.dtype or V0.device != self.device
                or V0.dim() != 2 or V0.shape[1:] != self.shape):
            raise ValueError(f"resident_lanczos: expected a (batch,) + "
                             f"{self.shape} {self.dtype} block on "
                             f"{self.device}, got {tuple(V0.shape)} "
                             f"{V0.dtype} on {V0.device}")
        if self.form != "cluster":
            return torch.stack([self(v, m, tol) for v in V0.unbind(0)])
        V0 = V0.contiguous()
        m, nb = int(m), V0.shape[0]
        ab = torch.empty((nb, m, 2), dtype=self.dtype, device=self.device)
        if nb == 0:
            return ab
        geom = self.batch_geometry(nb)
        stream = _build.raw_stream(self.device)
        if geom.per == 1:
            code = self.bfn(self.addr, V0.data_ptr(), m, float(tol),
                            ab.data_ptr(), nb, stream)
        else:
            code = self.rfn(self.addr, V0.data_ptr(), m, float(tol),
                            ab.data_ptr(), nb, geom.per, stream)
        if code:
            _build.check(code, "batched resident Lanczos kernel (K3, "
                         f"{geom.per} rows a cluster)")
        _build.launches["resident_lanczos_batched"] += 1
        return ab


def nbr_geometry(n: int, sms: int):
    """(grid, chunk) of the neighbour form: at most one block per SM and
    per ``NBR_MIN_ROWS`` rows, each owning ``chunk`` consecutive rows, every
    block at least one."""
    g = max(1, min(sms, -(-n // NBR_MIN_ROWS)))
    chunk = -(-n // g)
    return -(-n // chunk), chunk


def nbr_smem(chunk: int, h: int, p: int, kd: int, itemsize: int,
             spans: int = 2) -> int:
    """Bytes of dynamic shared memory a neighbour-form block needs:
    ``spans`` omega spans of chunk + 2h values (B4's kernel keeps three;
    B1's and B5's two, omega_{k+1} overwriting omega_{k-1} in place), p
    accumulator rows and kd diagonal rows of chunk values."""
    return (spans * (chunk + 2 * h) + (p + kd) * chunk) * itemsize


class _NbrForm:
    """What the plans of B1, B4 and B5 share for their neighbour forms
    (B4's ``resident_multi_nbr_kernel``, B1's and B5's
    ``resident_nbr_kernel``): the geometry (``nbr_geometry`` from the
    card's SM count, queried once), the card's occupancy answer for the
    plan's kernel (``kind``, as ``eu::nbr_capacity`` numbers them), and per
    stream the flags (zeroed once; the kernel takes each launch's base from
    them), halo buffers, B1's partials and ticket, and the launch
    descriptor. ``nbr_launches`` counts the launches that took the
    neighbour form."""

    kind = 1                # B1's kernel
    spans = 2               # omega spans a block of the kernel keeps
    banded = False

    def _nbr_init(self, n, offsets, coef):
        self.lib = _build.library()
        self.suf = _build.suffix(self.dtype)
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.k, self.h = len(offsets), max(abs(o) for o in offsets)
        self.coef = coef
        with _on(self.device):
            sms = _checked(self.lib.eu_device_sms(), "SM count query")
        self.sms = sms
        self.grid, self.chunk = nbr_geometry(n, sms)
        self.o = _offsets_field(offsets)
        self.kd = 0
        self.nbr = {}           # stream -> (address, descriptor, flags, halo[, partials])
        self.nbr_launches = 0

    def smem(self, p: int = 1, kd: int = 0) -> int:
        """Bytes of shared memory a neighbour-form block needs."""
        return nbr_smem(self.chunk, self.h, p, kd, self.itemsize, self.spans)

    def _fits(self, p: int = 1, kd: int = 0, copies: int = 1) -> bool:
        """The neighbour form takes p columns and kd kept diagonals: max|o|
        within a block's rows, and the card holds the whole grid (``copies``
        grids, K4's rows of a launch) with that much shared memory a block
        (its answer)."""
        if self.h > self.chunk:
            return False
        with _on(self.device):
            cap = _checked(getattr(self.lib, f"eu_nbr_capacity_{self.suf}")(
                self.kind, self.smem(p, kd)), "neighbour-form occupancy query")
        return cap >= self.grid * copies

    def _nbr_launch(self, stream, reduce: bool = False) -> int:
        """The address of the neighbour form's descriptor for ``stream``,
        with flags and halos of its own (launches on two streams may
        overlap; block b's flag is ``flags[b NBR_FLAG_STRIDE]``); ``reduce``
        adds B1's partials and its ticket (one more count after the
        flags)."""
        hit = self.nbr.get(stream)
        if hit is None:
            flags = torch.zeros(self.grid * NBR_FLAG_STRIDE + reduce,
                                dtype=torch.int64, device=self.device)
            halo = torch.empty(max(1, 4 * self.grid * self.h),
                               dtype=self.dtype, device=self.device)
            partials = (torch.empty(self.grid, dtype=self.dtype,
                                    device=self.device) if reduce else None)
            launch = _NbrLaunch(
                self.coef.data_ptr(), flags.data_ptr(), halo.data_ptr(),
                partials.data_ptr() if reduce else None,
                flags[-1:].data_ptr() if reduce else None, self.n,
                self.grid, self.chunk, self.h, self.k, self.kd, self.o)
            hit = (ctypes.addressof(launch), launch, flags, halo)
            if reduce:
                hit += (partials,)
            self.nbr[stream] = hit
        return hit[0]

    def _operands(self, what, pairs):
        for name, t, shape in pairs:
            if (t.dtype != self.dtype or t.device != self.device
                    or t.shape != shape):
                raise ValueError(
                    f"{what}: expected {name} {shape} {self.dtype} on "
                    f"{self.device}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")


class MultiPlan(_NbrForm):
    """What every B4 launch on one 1-D constant stencil, for vectors of one
    dtype on one CUDA device, shares: the checks, the coefficients in that
    dtype, the neighbour form's geometry and buffers (``_NbrForm``), and
    per stream the family form's scratch. ``form(p)`` picks, once per p,
    "neighbour" when max|o| <= chunk, p <= ``NBR_MAX_COLS`` and a block's
    state (three omega spans of chunk + 2h and p accumulator rows) fits on
    chip with the whole grid co-resident (the card's answer), else
    "family". A call compares its operands, makes W with ``torch.empty``
    and makes one ctypes call; ``nbr_launches`` counts the neighbour
    form's. ``form="family"`` takes the family kernel for every p (the main
    path never asks; the neighbour form is held bit for bit against it)."""

    kind, spans = 0, 3      # B4's own kernel: previous, current, next

    def __init__(self, op, dtype, device, form=None):
        self.device = _plan_device(device)
        _plan_checks("recurrence_apply_resident_multi", op, dtype,
                     self.device)
        if form not in (None, "family"):
            raise ValueError(f"recurrence_apply_resident_multi: form {form!r}")
        self.only_family = form == "family"
        self.dtype, self.n = dtype, op.shape[0]
        self.shape = (self.n,)
        offsets = _flat_offsets(op)
        self.cvals = op.coeffs.to(dtype).contiguous()
        self._nbr_init(self.n, offsets, self.cvals)
        self.offs = (ctypes.c_int * self.k)(*offsets)
        self.bufs = {}          # stream -> the family form's scratch
        self._forms = {}
        self.nbr_fn = getattr(self.lib, f"eu_resident_multi_nbr_{self.suf}")
        self.family_fn = getattr(self.lib, f"eu_resident_multi_{self.suf}")

    def form(self, p: int) -> str:
        f = self._forms.get(p)
        if f is None:
            f = ("neighbour" if p <= NBR_MAX_COLS and not self.only_family
                 and self._fits(p) else "family")
            self._forms[p] = f
        return f

    def __call__(self, x, rows, cw):
        m, p = rows.shape[0], cw.shape[1]
        self._operands("recurrence_apply_resident_multi",
                       (("vector", x, self.shape), ("rows", rows, (m, 4)),
                        ("cw", cw, (m, p))))
        x, rows, cw = x.contiguous(), rows.contiguous(), cw.contiguous()
        W = torch.empty((p, self.n), dtype=self.dtype, device=self.device)
        stream = _build.raw_stream(self.device)
        form = self.form(p)
        if form == "neighbour":
            code = self.nbr_fn(self._nbr_launch(stream), x.data_ptr(),
                               rows.data_ptr(), cw.data_ptr(), p, m,
                               W.data_ptr(), stream)
        else:
            buf = self.bufs.get(stream)
            if buf is None:
                buf = self.bufs[stream] = torch.empty(
                    3 * self.n, dtype=self.dtype, device=self.device)
            code = self.family_fn(x.data_ptr(), rows.data_ptr(),
                                  cw.data_ptr(), p, self.cvals.data_ptr(),
                                  self.offs, self.k, self.n, m, W.data_ptr(),
                                  buf.data_ptr(), stream)
        if code:
            _build.check(code, f"resident multi-column kernel (B4, {form} "
                         "form)")
        _build.launches["resident_multi"] += 1
        self.nbr_launches += form == "neighbour"
        return W.T


def _scale_ptr(scale, x):
    """B1's scale as the kernels read it: a null pointer for the number 1
    (omega_0 = x, bit for bit s x), else the address of a one-element
    tensor on x's device (a number other than 1 costs one fill launch) and
    the tensor, kept alive through the launch."""
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=x.device, dtype=x.dtype)
        if s.numel() != 1:
            raise ValueError(f"resident_recurrence: scale of shape "
                             f"{tuple(scale.shape)}, one value expected")
        return s.data_ptr(), s
    if float(scale) == 1.0:
        return None, None
    s = torch.full((1,), float(scale), dtype=x.dtype, device=x.device)
    return s.data_ptr(), s


class RecurrencePlan(_NbrForm):
    """What every B1 launch on one 1-D constant stencil, for vectors of one
    dtype on one CUDA device, shares: the checks, the coefficients in that
    dtype, the form, chosen once (``form``: "neighbour", the blocks of
    ``_NbrForm`` with one accumulator row and the sum of w^2 taken by the
    last block of a launch, where max|o| <= chunk and a block's state fits
    on chip with the whole grid co-resident, the card's answer; else
    "grid", the persistent cooperative kernel of ``csrc/resident.cu``,
    with its scratch and partials, one set per stream), the launch
    descriptors and the C entry point. A call compares x and the rows,
    makes w and the sum with ``torch.empty``, passes the scale as a
    pointer (null for 1) and makes one ctypes call. ``form="grid"`` takes
    the grid kernel at any size (the main path never asks; the neighbour
    form's w is held bit for bit against it)."""

    def __init__(self, op, dtype, device, form=None):
        self.device = _plan_device(device)
        _plan_checks("resident_recurrence", op, dtype, self.device)
        if form not in (None, "grid"):
            raise ValueError(f"resident_recurrence: form {form!r}")
        self.dtype, self.n = dtype, op.shape[0]
        self.shape = (self.n,)
        offsets = _flat_offsets(op)
        self.cvals = op.coeffs.to(dtype).contiguous()
        self._nbr_init(self.n, offsets, self.cvals)
        if form is None and self._fits():
            self.form = "neighbour"
            self.fn = getattr(self.lib, f"eu_resident_recurrence_nbr_{self.suf}")
            return
        self.form = "grid"
        with _on(self.device):
            blocks = _checked(self.lib.eu_resident_max_blocks(
                int(dtype == torch.float64)), "resident kernel occupancy query")
        self.cap = 2 * blocks
        self.offs = (ctypes.c_int * self.k)(*offsets)
        self.scratch = {}       # stream -> (buf, partials) of the grid form
        self.fn = getattr(self.lib, f"eu_resident_recurrence_{self.suf}")

    def __call__(self, x, rows, scale=1.0):
        m = rows.shape[0]
        self._operands("resident_recurrence", (("vector", x, self.shape),
                                               ("rows", rows, (m, 4))))
        x, rows = x.contiguous(), rows.contiguous()
        sp, s = _scale_ptr(scale, x)
        w = torch.empty_like(x)
        nrm2 = torch.empty((), dtype=self.dtype, device=self.device)
        stream = _build.raw_stream(self.device)
        if self.form == "neighbour":
            code = self.fn(self._nbr_launch(stream, reduce=True), x.data_ptr(),
                           sp, rows.data_ptr(), m, w.data_ptr(),
                           nrm2.data_ptr(), stream)
        else:
            hit = self.scratch.get(stream)
            if hit is None:
                hit = self.scratch[stream] = (
                    torch.empty(3 * self.n, dtype=self.dtype,
                                device=self.device),
                    torch.empty(self.cap, dtype=self.dtype,
                                device=self.device))
            code = self.fn(x.data_ptr(), rows.data_ptr(),
                           self.cvals.data_ptr(), sp, self.offs, self.k,
                           self.n, m, w.data_ptr(), hit[0].data_ptr(),
                           hit[1].data_ptr(), self.cap, nrm2.data_ptr(),
                           stream)
        if code:
            _build.check(code, f"resident recurrence kernel (B1, {self.form} "
                         "form)")
        _build.launches["resident_recurrence"] += 1
        self.nbr_launches += self.form == "neighbour"
        return w, nrm2


class RowsGeometry(NamedTuple):
    """K4's blocks for one row (``nbr_rows_geometry``): ``grid`` blocks of
    ``chunk`` rows, ``s`` steps a halo exchange, ``per_thread`` rows a
    thread (the instantiation) and ``threads`` threads a block."""
    grid: int
    chunk: int
    s: int
    per_thread: int
    threads: int


def nbr_rows_geometry(n: int, h: int, blocks: int):
    """K4's geometry for one row of n with max|o| = h on ``blocks`` SMs, or
    None: ``nbr_geometry``'s grid and chunk; the most steps s of
    ``NBR_ROWS_STEPS`` with s h <= chunk whose span, the chunk and s h halo
    rows each side, a block of at most ``NBR_ROWS_THREADS`` threads holds
    at the fewest rows a thread J of ``NBR_ROWS_PER_THREAD``; threads the
    warps that span needs at J. None where h exceeds
    ``NBR_ROWS_MAX_HALO`` or no s fits."""
    if h > NBR_ROWS_MAX_HALO:
        return None
    grid, chunk = nbr_geometry(n, blocks)
    for s in NBR_ROWS_STEPS:
        span = chunk + 2 * s * h
        if s * h > chunk:
            continue
        per = next((j for j in NBR_ROWS_PER_THREAD
                    if j * NBR_ROWS_THREADS >= span), None)
        if per is not None:
            return RowsGeometry(grid, chunk, s, per,
                                32 * -(-span // (32 * per)))
    return None


class RecurrenceBatchPlan:
    """What every K4 launch on one 1-D constant stencil, for blocks of
    ``batch`` rows of one dtype on one CUDA device, shares: B1's checks
    and coefficients, and K4's geometry, chosen once: the most rows a
    launch R (at most ``batch``) for which ``nbr_rows_geometry`` over the
    SMs / R gives blocks whose R x grid the card holds at once (its answer
    for that instantiation and block size), the batch then in ceil(batch /
    R) launches (``launches_per_call``). Where no R fits (max|o| above
    ``NBR_ROWS_MAX_HALO``, or a block's span past what its registers
    hold), ``form`` is "rows": each row takes the operator's B1 plan
    (``recurrence_plan``), as a scalar call would. Per stream: flags for R
    x grid blocks and R tickets, the halo slots, R x grid partials. A call
    compares its operands, makes W and the sums with ``torch.empty`` and
    makes one ctypes call a group."""

    _operands = _NbrForm._operands

    def __init__(self, op, dtype, device, batch: int):
        self.device = _plan_device(device)
        _plan_checks("resident_recurrence (batched)", op, dtype, self.device)
        self.dtype, self.n, self.batch = dtype, op.shape[0], int(batch)
        self.shape = (self.batch, self.n)
        offsets = _flat_offsets(op)
        self.cvals = op.coeffs.to(dtype).contiguous()
        self.k, self.h = len(offsets), max(abs(o) for o in offsets)
        self.o = _offsets_field(offsets)
        lib = _build.library()
        suf = _build.suffix(dtype)
        with _on(self.device):
            self.sms = _checked(lib.eu_device_sms(), "SM count query")
        capacity = getattr(lib, f"eu_nbr_rows_capacity_{suf}")
        self.rows_per_launch, self.nbr_launches = 0, 0
        for r in range(min(self.batch, self.sms), 0, -1):
            g = nbr_rows_geometry(self.n, self.h, self.sms // r)
            if g is None:
                continue
            with _on(self.device):
                cap = _checked(capacity(g.per_thread, self.h, g.threads),
                               "K4 occupancy query")
            if cap >= r * g.grid:
                self.rows_per_launch, self.geometry = r, g
                break
        if not self.rows_per_launch:
            self.form, self.launches_per_call = "rows", self.batch
            self.row_plan = recurrence_plan(op, dtype, self.device)
            return
        self.form = "neighbour"
        self.grid, self.chunk = self.geometry.grid, self.geometry.chunk
        self.launches_per_call = -(-self.batch // self.rows_per_launch)
        self.nbr = {}           # stream -> (address, descriptor, buffers...)
        self.fn = getattr(lib, f"eu_resident_recurrence_nbr_batched_{suf}")

    def _batch_launch(self, stream) -> int:
        """The descriptor's address for ``stream``, with buffers for the R
        rows of a launch: block q's flag at ``flags[q NBR_FLAG_STRIDE]``,
        then one ticket a row; two parities of q slots of 4 s h halo
        values; q partials."""
        hit = self.nbr.get(stream)
        if hit is None:
            g = self.geometry
            q = self.rows_per_launch * g.grid
            flags = torch.zeros(q * NBR_FLAG_STRIDE + self.rows_per_launch,
                                dtype=torch.int64, device=self.device)
            halo = torch.empty(max(1, 8 * q * g.s * self.h), dtype=self.dtype,
                               device=self.device)
            partials = torch.empty(q, dtype=self.dtype, device=self.device)
            launch = _RowsLaunch(
                self.cvals.data_ptr(), flags.data_ptr(), halo.data_ptr(),
                partials.data_ptr(), flags[q * NBR_FLAG_STRIDE:].data_ptr(),
                self.n, g.grid, g.chunk, self.h, self.k, g.s, g.threads,
                g.per_thread, self.o)
            hit = self.nbr[stream] = (ctypes.addressof(launch), launch, flags,
                                      halo, partials)
        return hit[0]

    def __call__(self, X, rows, scale):
        m = rows.shape[1]
        self._operands("resident_recurrence (batched)",
                       (("block", X, self.shape),
                        ("rows", rows, (self.batch, m, 4)),
                        ("scale", scale, (self.batch,))))
        if self.form == "rows":
            out = [self.row_plan(x, r, s) for x, r, s in
                   zip(X.unbind(0), rows.unbind(0), scale.unbind(0))]
            return (torch.stack([w for w, _ in out]),
                    torch.stack([s for _, s in out]))
        X, rows, scale = X.contiguous(), rows.contiguous(), scale.contiguous()
        W = torch.empty_like(X)
        nrm2 = torch.empty(self.batch, dtype=self.dtype, device=self.device)
        stream = _build.raw_stream(self.device)
        addr = self._batch_launch(stream)
        for r0 in range(0, self.batch, self.rows_per_launch):
            nr = min(self.rows_per_launch, self.batch - r0)
            code = self.fn(addr, X[r0].data_ptr(), scale[r0:].data_ptr(),
                           rows[r0].data_ptr(), m, W[r0].data_ptr(),
                           nrm2[r0:].data_ptr(), nr, stream)
            if code:
                _build.check(code, "batched resident recurrence kernel (K4, "
                             "rows in registers)")
            _build.launches["resident_recurrence_batched"] += 1
            self.nbr_launches += 1
        return W, nrm2


class BandedRecurrencePlan(_NbrForm):
    """What every B5 launch on one ``BandedOperator``, for vectors of one
    dtype on one CUDA device, shares: the checks, the diagonals in that
    dtype (the operator's cast, shared with B7), the form, chosen once
    (``form``: "neighbour", the blocks of ``_NbrForm`` with one accumulator
    row and the first ``kd`` diagonals' rows kept in shared memory, kd the
    most that fit, where max|o| <= chunk and a block's state fits on chip
    with the whole grid co-resident, the card's answer; else "family", the
    grid-barrier kernel, with its scratch, one set per stream), the launch
    descriptors and the C entry point. A call compares x and the rows,
    makes w with ``torch.empty_like`` and makes one ctypes call.
    ``form="family"`` takes the family kernel at any size (the main path
    never asks; the neighbour form is held bit for bit against it)."""

    kind, banded = 2, True  # B5's kernel
    source = "diags"

    def __init__(self, op, dtype, device, form=None):
        self.device = _plan_device(device)
        _build.require_cuda("recurrence_apply_resident_banded", self.device)
        if form not in (None, "family"):
            raise ValueError(f"recurrence_apply_resident_banded: form "
                             f"{form!r}")
        if dtype not in _build.KERNEL_DTYPES:
            raise ValueError("recurrence_apply_resident_banded takes "
                             f"float32/float64, got {dtype}")
        if not resident_banded_supported(op):
            raise ValueError("recurrence_apply_resident_banded requires a "
                             f"real BandedOperator with <= "
                             f"{_build.MAX_POINTS} diagonals (got "
                             f"{type(op).__name__})")
        if op.device != self.device:
            raise ValueError(f"recurrence_apply_resident_banded: operator on "
                             f"{op.device}, vector on {self.device}")
        from ..sparse import _promoted

        self.dtype, self.n = dtype, op.shape[0]
        self.shape = (self.n,)
        self.diags = _promoted(op, "diags", dtype).contiguous()
        self._nbr_init(self.n, op.offsets, self.diags)
        kd = None if form else next(
            (kd for kd in range(self.k, -1, -1) if self._fits(1, kd)), None)
        if kd is not None:
            self.form, self.kd = "neighbour", kd
            self.fn = getattr(self.lib, f"eu_resident_banded_nbr_{self.suf}")
            return
        self.form = "family"
        self.offs = (ctypes.c_int * self.k)(*op.offsets)
        self.bufs = {}          # stream -> the family form's scratch
        self.fn = getattr(self.lib, f"eu_resident_banded_{self.suf}")

    def __call__(self, x, rows):
        m = rows.shape[0]
        self._operands("recurrence_apply_resident_banded",
                       (("vector", x, self.shape), ("rows", rows, (m, 4))))
        x, rows = x.contiguous(), rows.contiguous()
        w = torch.empty_like(x)
        stream = _build.raw_stream(self.device)
        if self.form == "neighbour":
            code = self.fn(self._nbr_launch(stream), x.data_ptr(),
                           rows.data_ptr(), m, w.data_ptr(), stream)
        else:
            buf = self.bufs.get(stream)
            if buf is None:
                buf = self.bufs[stream] = torch.empty(
                    3 * self.n, dtype=self.dtype, device=self.device)
            code = self.fn(x.data_ptr(), rows.data_ptr(),
                           self.diags.data_ptr(), self.offs, self.k, self.n,
                           m, w.data_ptr(), buf.data_ptr(), stream)
        if code:
            _build.check(code, f"resident banded kernel (B5, {self.form} "
                         "form)")
        _build.launches["resident_banded"] += 1
        self.nbr_launches += self.form == "neighbour"
        return w


class GridTiles(NamedTuple):
    """B6's neighbour-form geometry: tiles of ``tz`` planes by ``ty``
    whole x-lines, ``tiles_z`` x ``tiles_y`` of them (block b owns tile
    (b // tiles_y, b % tiles_y); the last along an axis may hold fewer),
    spans with the stencil's reach as halo: ``hz`` planes and ``hy`` lines
    each side, ``hx`` zero columns at each end of a line."""
    tz: int
    ty: int
    tiles_z: int
    tiles_y: int
    hz: int
    hy: int
    hx: int

    @property
    def grid(self) -> int:
        return self.tiles_z * self.tiles_y


def grid_halo_lines(tiles: GridTiles, dirs: int) -> int:
    """The most halo lines a B6 tile copies (``eu::grid_halo_lines``): for
    each direction of ``dirs`` (``grid_dirs``) along which the grid has
    more than one tile, a face or corner of the tile's extent and the
    halo."""
    t, lines = tiles, 0
    for d in range(9):
        a, c = d // 3 - 1, d % 3 - 1
        if (d == 4 or not dirs >> d & 1 or (a and t.tiles_z < 2)
                or (c and t.tiles_y < 2)):
            continue
        lines += (t.hz if a else t.tz) * (t.hy if c else t.ty)
    return lines


def grid_smem(tiles: GridTiles, nx: int, itemsize: int,
              halo_lines: int) -> int:
    """Bytes of dynamic shared memory a block of B6's neighbour form needs
    (``eu::grid_nbr_smem``): the halo-line table (16 bytes a line), two
    omega spans of (tz + 2 hz)(ty + 2 hy) lines of nx + 2 hx values, and
    the tile's tz ty nx accumulator rows."""
    t = tiles
    return 16 * halo_lines + (
        2 * (t.tz + 2 * t.hz) * (t.ty + 2 * t.hy) * (nx + 2 * t.hx)
        + t.tz * t.ty * nx) * itemsize


def grid_tiles(shape3, offs3, sms: int) -> GridTiles:
    """The tiles of B6's neighbour form for the (nz, ny, nx) grid and its
    (dz, dy, dx) offsets: at most ``sms`` tiles (one block per SM), each
    at least max|dz| planes (max|dy| lines) where the grid has more than
    one tile along z (y), so a halo lies in the next tile; among those, the
    fewest span and accumulator values a block (``grid_smem``), then the
    fewest planes a tile. For each tz the fewest lines that keep within
    ``sms`` tiles win (the footprint grows with ty), or one tile of all ny
    lines."""
    nz, ny, nx = shape3
    hz, hy, hx = (max(abs(o[a]) for o in offs3) for a in range(3))
    best = None
    for tz in range(1, nz + 1):
        tiles_z = -(-nz // tz)
        if tiles_z > sms or (tiles_z > 1 and tz < hz):
            continue
        most = sms // tiles_z
        for ty in {min(max(-(-ny // most), hy), ny), ny}:
            t = GridTiles(tz, ty, tiles_z, -(-ny // ty), hz, hy, hx)
            key = (grid_smem(t, nx, 1, 0), tz)
            if best is None or key < best[0]:
                best = key, t
    return best[1]


def grid_dirs(offs3) -> int:
    """The neighbour directions a B6 tile waits for (``eu::grid_dirs``):
    bit 3 (a + 1) + (b + 1) for the tile at (+a, +b) along (z, y), for the
    faces and the corner each point reaches and their opposites (a tile
    waits for every tile that reads it)."""
    dirs = 0
    for dz, dy, _ in offs3:
        a, e = (dz > 0) - (dz < 0), (dy > 0) - (dy < 0)
        for sgn in (-1, 1):
            for u in (0, 1):
                for v in (0, 1):
                    aa, ee = sgn * u * a, sgn * v * e
                    if aa or ee:
                        dirs |= 1 << (3 * (aa + 1) + ee + 1)
    return dirs


class GridRecurrencePlan:
    """What every B6 launch on one 2-D/3-D constant stencil, for vectors of
    one dtype on one CUDA device, shares: the checks, the coefficients in
    that dtype, the offsets, the tiles (``grid_tiles`` from the card's SM
    count, queried once), the form, chosen once (``form``: "neighbour",
    ``resident_grid_nbr_kernel``, where a tile has at most
    ``GRID_MAX_ROWS`` rows and ``GRID_MAX_HALO`` halo rows and the card
    holds the whole grid of tiles with ``smem`` bytes of shared memory a
    block, its answer; else "family", the grid-barrier kernel), and per
    stream the launch descriptor with the neighbour form's flags (zeroed
    once; the kernel takes each launch's base from them) and publication
    buffer (a slot of tz ty nx rows a tile, two parities), or the family
    form's scratch. A call compares x and the rows, makes w with
    ``torch.empty_like`` and makes one ctypes call; ``nbr_launches`` counts
    the neighbour form's. ``form="family"`` takes the family kernel at any
    size (the main path never asks; the neighbour form is held bit for bit
    against it)."""

    kind = 3                # B6's neighbour kernel, as eu::nbr_capacity numbers it

    def __init__(self, op, dtype, device, form=None):
        from .lanczos_fused import _geometry

        self.device = _plan_device(device)
        what = "recurrence_apply_resident_grid"
        _build.require_cuda(what, self.device)
        if form not in (None, "family"):
            raise ValueError(f"{what}: form {form!r}")
        if dtype not in _build.KERNEL_DTYPES:
            raise ValueError(f"{what} takes float32/float64, got {dtype}")
        if not _grid_operator(op):
            raise ValueError(f"{what} requires a real 2-D/3-D constant "
                             f"StencilOperator (got {type(op).__name__})")
        if op.device != self.device:
            raise ValueError(f"{what}: operator on {op.device}, vector on "
                             f"{self.device}")
        self.dtype, self.n = dtype, op.shape[0]
        self.shape = (self.n,)
        self.cvals = op.coeffs.to(dtype).contiguous()
        self.shape3, offs3 = _geometry(op)
        self.lib = _build.library()
        suf = _build.suffix(dtype)
        with _on(self.device):
            sms = _checked(self.lib.eu_device_sms(), "SM count query")
        t = self.tiles = grid_tiles(self.shape3, offs3, sms)
        nx, dirs = self.shape3[2], grid_dirs(offs3)
        self.halo_lines = grid_halo_lines(t, dirs)
        self.smem = grid_smem(t, nx, dtype.itemsize, self.halo_lines)
        self.slot = t.tz * t.ty * nx    # a tile's rows in the publication buffer
        self.form = "family"
        if (form is None and self.slot <= GRID_MAX_ROWS
                and self.halo_lines * nx <= GRID_MAX_HALO):
            with _on(self.device):
                cap = _checked(getattr(self.lib, f"eu_nbr_capacity_{suf}")(
                    self.kind, self.smem), "neighbour-form occupancy query")
            if cap >= t.grid:
                self.form = "neighbour"
        self.fn = getattr(self.lib, f"eu_resident_grid_nbr_{suf}"
                          if self.form == "neighbour" else
                          f"eu_resident_grid_{suf}")
        self._fields = (self.n, *self.shape3, t.tiles_z, t.tiles_y, t.tz,
                        t.ty, t.hz, t.hy, t.hx, dirs, self.halo_lines,
                        len(offs3), *(_offsets_field([o[a] for o in offs3])
                                      for a in range(3)))
        self.bufs = {}          # stream -> (address, descriptor, flags, buffer)
        self.nbr_launches = 0

    def _launch(self, stream):
        """The descriptor's address and the buffers for ``stream``: the
        neighbour form's flags (``NBR_FLAG_STRIDE`` apart) and its
        publication buffer, or the family form's 3n scratch."""
        hit = self.bufs.get(stream)
        if hit is None:
            flags = None
            if self.form == "neighbour":
                flags = torch.zeros(self.tiles.grid * NBR_FLAG_STRIDE,
                                    dtype=torch.int64, device=self.device)
                buf = torch.empty(2 * self.tiles.grid * self.slot,
                                  dtype=self.dtype, device=self.device)
                ptrs = (flags.data_ptr(), buf.data_ptr())
            else:
                buf = torch.empty(3 * self.n, dtype=self.dtype,
                                  device=self.device)
                ptrs = (None, None)
            launch = _GridLaunch(self.cvals.data_ptr(), *ptrs, *self._fields)
            hit = self.bufs[stream] = (ctypes.addressof(launch), launch, flags,
                                       buf)
        return hit

    _operands = _NbrForm._operands

    def __call__(self, x, rows):
        m = rows.shape[0]
        self._operands("recurrence_apply_resident_grid",
                       (("vector", x, self.shape), ("rows", rows, (m, 4))))
        x, rows = x.contiguous(), rows.contiguous()
        w = torch.empty_like(x)
        stream = _build.raw_stream(self.device)
        addr, _, _, buf = self._launch(stream)
        if self.form == "neighbour":
            code = self.fn(addr, x.data_ptr(), rows.data_ptr(), m,
                           w.data_ptr(), stream)
        else:
            code = self.fn(addr, x.data_ptr(), rows.data_ptr(), m,
                           w.data_ptr(), buf.data_ptr(), stream)
        if code:
            _build.check(code, f"resident grid kernel (B6, {self.form} form)")
        _build.launches["resident_grid"] += 1
        self.nbr_launches += self.form == "neighbour"
        return w


def _op_plan(op, cls, dtype, device, *extra):
    """``cls``'s plan for ``op``, kept per (dtype, device, ``extra``) with
    the coefficients (a ``BandedOperator``'s diagonals, in their
    ``_promoted`` form) and offsets it was built from, rebuilt when either
    is reassigned or the cast copy is made anew."""
    from ..sparse import _promoted

    device = _plan_device(device)
    plans = op.__dict__.setdefault("_resident_plans", {})
    key = (cls, dtype, device) + extra
    hit = plans.get(key)
    source = getattr(cls, "source", "coeffs")
    src = (_promoted(op, source, dtype) if source == "diags"
           else getattr(op, source))
    if hit is None or hit[0] is not src or hit[1] != op.offsets:
        hit = plans[key] = (src, op.offsets, cls(op, dtype, device, *extra))
    return hit[2]


def lanczos_plan(op, dtype, device) -> LanczosPlan:
    """B2's plan for ``op`` and vectors of ``dtype`` on CUDA ``device``."""
    return _op_plan(op, LanczosPlan, dtype, device)


def multi_plan(op, dtype, device) -> MultiPlan:
    """B4's plan for ``op`` and vectors of ``dtype`` on CUDA ``device``."""
    return _op_plan(op, MultiPlan, dtype, device)


def recurrence_plan(op, dtype, device) -> RecurrencePlan:
    """B1's plan for ``op`` and vectors of ``dtype`` on CUDA ``device``."""
    return _op_plan(op, RecurrencePlan, dtype, device)


def recurrence_batch_plan(op, dtype, device, batch: int
                          ) -> RecurrenceBatchPlan:
    """K4's plan for ``op`` and blocks of ``batch`` rows of ``dtype`` on
    CUDA ``device``."""
    return _op_plan(op, RecurrenceBatchPlan, dtype, device, int(batch))


def banded_plan(op, dtype, device) -> BandedRecurrencePlan:
    """B5's plan for the ``BandedOperator`` ``op`` and vectors of ``dtype``
    on CUDA ``device``."""
    return _op_plan(op, BandedRecurrencePlan, dtype, device)


def grid_plan(op, dtype, device) -> GridRecurrencePlan:
    """B6's plan for the 2-D/3-D ``op`` and vectors of ``dtype`` on CUDA
    ``device``."""
    return _op_plan(op, GridRecurrencePlan, dtype, device)


# ------------------------------------------------------------ wrappers --

def _as_rows(rows, x):
    """(m, 4) rows for a vector x, (batch, m, 4) for a (batch, n) x."""
    rows = torch.as_tensor(rows, dtype=x.dtype, device=x.device)
    if rows.ndim != x.ndim + 1 or rows.shape[-1] != 4 or (
            x.ndim == 2 and rows.shape[0] != x.shape[0]):
        raise ValueError(f"rows must be (m, 4) (a (batch, m, 4) stack for "
                         f"a (batch, n) x), got {tuple(rows.shape)}")
    return rows


def _require_device(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel or twin for device {x.device}")


def resident_recurrence(op, x, rows, scale=1.0):
    """(w, sum w^2) of the module-doc recurrence for a 1-D constant
    ``StencilOperator``: kernel B1 on CUDA (through the operator's
    ``recurrence_plan``), its twin on CPU. ``rows`` is (m, 4) and
    ``scale`` a number or a one-element tensor, both on x's device. A
    (batch, n) x takes K4 (``recurrence_batch_plan``) with rows (batch,
    m, 4) and scale a (batch,) tensor, and returns (W, sums (batch,))."""
    if not resident_supported(op):
        raise ValueError("resident_recurrence requires a 1-D real constant "
                         f"StencilOperator (got {type(op).__name__})")
    _require_device(x, "resident_recurrence")
    rows = _as_rows(rows, x)
    if x.ndim == 2:
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
        if x.device.type == "cuda":
            refuse_grad("resident_recurrence (K4)", op, x, rows, scale)
            return recurrence_batch_plan(op, x.dtype, x.device, x.shape[0])(
                x, rows, scale.expand(x.shape[0]))
        return resident_recurrence_batched_ref(
            x, rows, op.coeffs.to(x.dtype), _flat_offsets(op),
            scale.expand(x.shape[0]))
    if x.device.type == "cuda":
        refuse_grad("resident_recurrence (B1)", op, x, rows, scale)
        return recurrence_plan(op, x.dtype, x.device)(x, rows, scale)
    s = (scale.to(device=x.device, dtype=x.dtype).reshape(())
         if isinstance(scale, torch.Tensor)
         else torch.tensor(float(scale), dtype=x.dtype))
    return resident_recurrence_ref(x, rows, op.coeffs.to(x.dtype),
                                   _flat_offsets(op), s)


def recurrence_apply_resident(op, b, rows, *, scale=1.0):
    """w = sum_k cw_k omega_k (module doc) for a 1-D constant
    ``StencilOperator``: one launch of kernel B1 on CUDA. Returns (n,)."""
    return resident_recurrence(op, b, rows, scale)[0]


def recurrence_apply_resident_multi(op, b, rows, cw):
    """W[:, j] = sum_k cw[k, j] omega_k over the shared omega chain of the
    module-doc recurrence (omega_0 = b; rows' cw column is unused) for a
    1-D constant ``StencilOperator``: one launch of kernel B4 on CUDA
    whatever p (through the operator's ``multi_plan``), its twin on CPU.
    Returns (n, p)."""
    if not resident_supported(op):
        raise ValueError("recurrence_apply_resident_multi requires a 1-D real "
                         f"constant StencilOperator (got {type(op).__name__})")
    _require_device(b, "recurrence_apply_resident_multi")
    rows = _as_rows(rows, b)
    cw = torch.as_tensor(cw, dtype=b.dtype, device=b.device)
    if cw.ndim != 2 or cw.shape[0] != rows.shape[0] or cw.shape[1] < 1:
        raise ValueError(f"cw must be (m, p >= 1) with m = {rows.shape[0]}, "
                         f"got {tuple(cw.shape)}")
    if b.device.type == "cpu":
        return resident_multi_ref(b, rows, cw, op.coeffs.to(b.dtype),
                                  _flat_offsets(op))
    refuse_grad("recurrence_apply_resident_multi (B4)", op, b, rows, cw)
    return multi_plan(op, b.dtype, b.device)(b, rows, cw)


def recurrence_apply_resident_banded(op, b, rows):
    """w = sum_k cw_k omega_k (module doc, omega_0 = b) for a
    ``BandedOperator``: one launch of kernel B5 on CUDA (through the
    operator's ``banded_plan``), its twin on CPU. Returns (n,)."""
    if not resident_banded_supported(op):
        raise ValueError("recurrence_apply_resident_banded requires a real "
                         f"BandedOperator with <= {_build.MAX_POINTS} "
                         f"diagonals (got {type(op).__name__})")
    _require_device(b, "recurrence_apply_resident_banded")
    rows = _as_rows(rows, b)
    if b.device.type == "cpu":
        return resident_banded_ref(b, rows, op.diags.to(b.dtype), op.offsets)
    refuse_grad("recurrence_apply_resident_banded (B5)", op, b, rows)
    return banded_plan(op, b.dtype, b.device)(b, rows)


def recurrence_apply_resident_grid(op, b, rows):
    """w = sum_k cw_k omega_k (module doc, omega_0 = b) for a 2-D/3-D
    constant ``StencilOperator`` on its natural row-major layout: one
    launch of kernel B6 on CUDA (through the operator's ``grid_plan``), its
    twin on CPU. Returns (n,)."""
    if not resident_grid_supported(op, b.dtype):
        raise ValueError("recurrence_apply_resident_grid requires a real "
                         "2-D/3-D constant StencilOperator whose state fits "
                         f"{L2_STATE_BUDGET >> 20} MB (got {type(op).__name__}"
                         f" {getattr(op, 'grid_shape', '')})")
    _require_device(b, "recurrence_apply_resident_grid")
    rows = _as_rows(rows, b)
    if b.device.type == "cpu":
        return resident_grid_ref(b, rows, op.grid_shape, op.offsets,
                                 op.coeffs.to(b.dtype))
    refuse_grad("recurrence_apply_resident_grid (B6)", op, b, rows)
    return grid_plan(op, b.dtype, b.device)(b, rows)


def resident_lanczos(op, v0, m: int, tol: float):
    """The (m, 2) (alpha, beta) record of Lanczos pass 1 from the
    normalized v0: kernel B2 on CUDA (through the operator's
    ``lanczos_plan``), its twin on CPU. A (batch, n) v0: each row's,
    (batch, m, 2), by K3 (``LanczosPlan.batched``)."""
    if not resident_supported(op):
        raise ValueError("resident_lanczos requires a 1-D real constant "
                         f"StencilOperator (got {type(op).__name__})")
    _require_device(v0, "resident_lanczos")
    if v0.device.type == "cpu":
        ref = (resident_lanczos_ref if v0.ndim == 1
               else resident_lanczos_batched_ref)
        return ref(v0, op.coeffs.to(v0.dtype), _flat_offsets(op), int(m),
                   float(tol))
    refuse_grad("resident_lanczos (B2)", op, v0)
    plan = lanczos_plan(op, v0.dtype, v0.device)
    return plan(v0, m, tol) if v0.ndim == 1 else plan.batched(v0, m, tol)


def lanczos_coeffs_resident(op, b, m: int, *, tol: float = 1e-7):
    """(alphas, betas, beta0, m_used, broke): drop-in twin of
    ``ops.krylov.lanczos_coeffs`` for 1-D constant stencils, the whole
    pass in one launch of kernel B2 on CUDA (K3 for a (batch, n) b, each
    row's)."""
    beta0 = torch.linalg.vector_norm(b, dim=-1 if b.ndim > 1 else None)
    v0 = torch.where(_col(beta0) > 0,
                     b / _col(torch.where(beta0 > 0, beta0, 1.0)), 0.0)
    ab = resident_lanczos(op, v0, m, tol)
    alphas, betas = ab[..., 0], ab[..., 1]
    # alpha_k is recorded through the first sub-tol beta (inclusive):
    # m_used = index of the first zero beta + 1, or m when none broke
    zero = betas == 0
    any0 = zero.any(-1)
    first0 = torch.argmax(zero.to(torch.int32), -1).to(torch.int32)
    m_used = torch.where(any0, first0 + 1, m)
    m_used = torch.where(beta0 > 0, m_used, 0).to(torch.int32)
    broke = any0 | (beta0 == 0)
    return alphas, betas, beta0, m_used, broke


def _replay_rows(alphas, betas, cw):
    """(m, 4) rows regenerating the Lanczos basis from its record,
    v_{k+1} = (A v_k - alpha_k v_k - beta_{k-1} v_{k-1}) / beta_k, with
    accumulation weights ``cw`` (cc_0 multiplies omega_{-1} = 0)."""
    live = betas > 0
    safe = torch.where(live, betas, 1.0)
    bprev = torch.cat([torch.zeros_like(betas[..., :1]), betas[..., :-1]],
                      -1)
    ca = torch.where(live, 1.0 / safe, 0.0)
    cb = -alphas * ca
    cc = torch.where(live, -bprev / safe, 0.0)
    return torch.stack([ca, cb, cc, cw], dim=-1)


def _inv_or_zero(beta0):
    return torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0),
                       0.0)


def expv_two_pass_resident(op, b, t, m: int, *, tol: float = 1e-7,
                           reduced: str = "device"):
    """Storage-free 1-D Hermitian expv with both passes one launch each:
    pass 1 = ``lanczos_coeffs_resident`` (B2), the m x m reduced
    tridiagonal exponential (kernel R1, ``ops/kernels/tridiag.py``, with
    no host read; host scipy with ``reduced="host"``), pass 2 = the B1
    recurrence with the replay rows of the record. A (batch, n) b: each
    row's, by K3, K2 (one R1 launch for the batch) and K4."""
    from ...models.expv import _lanczos_reduced_coeffs

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_resident(
        op, b, m, tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced)
    rows = _replay_rows(alphas, betas, coeffs.to(b.dtype))
    w = recurrence_apply_resident(op, b, rows, scale=_inv_or_zero(beta0))
    return torch.where(_col(beta0) > 0, w, 0.0)


def phiv_two_pass_resident(op, b, t, m: int, k: int, *, tol: float = 1e-7,
                           reduced: str = "device"):
    """Storage-free 1-D Hermitian phi-actions (w (n, k+1), err): pass 1 =
    ``lanczos_coeffs_resident`` (B2), the reduced augmented exponential
    (``phiv_dense``, or host scipy with ``reduced="host"``), pass 2 = ONE
    launch of B4 accumulating every phi order from the shared regenerated
    basis chain. ``err`` is the a-posteriori estimate |beta0 h t
    C2[last, k]| of ``models.phiv``."""
    from ...models.phiv import _two_pass_reduced

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_resident(
        op, b, m, tol=tol)
    C2, err = _two_pass_reduced(alphas, betas, beta0, m_used, t, k, b.dtype,
                                reduced=reduced)
    rows = _replay_rows(alphas, betas, torch.zeros_like(alphas))
    w = recurrence_apply_resident_multi(op, _inv_or_zero(beta0) * b, rows,
                                        C2 * beta0)
    live = beta0 > 0
    return torch.where(live, w, 0.0), torch.where(live, err, 0.0)

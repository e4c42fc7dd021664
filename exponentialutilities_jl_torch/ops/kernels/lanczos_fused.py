"""Fused recurrence sweeps for 2-D/3-D box stencils, constant
(``StencilOperator``) or variable-coefficient (``VariableStencilOperator``)
(PyTorch port of ``exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py``).

One sweep (``csrc/fused_sweep.cu``: kernel B3 for constant coefficients,
B3-var for per-cell fields) computes

    y  = ca Z + cb Vc + cc Vp,   Zn = A y,   moments (sum y^2, sum y.Zn)

and, in its accumulating form, W += cw Vc in place. Its second stage sums
the per-block moments in a fixed order and, in Lanczos mode, computes the
next sweep's scalars on the device. The drivers below run one sweep per
step and serve both operator kinds:

* ``lanczos_coeffs_fused``: Lanczos pass 1. No normalization pass ever
  runs: the sweep stores the UNNORMALIZED y_j = beta_{j+1} v_{j+1} and its
  image A y_j, and the next sweep's scalars absorb the normalizations,
  ca = 1/beta_j, cb = -alpha_j/beta_j, cc = -beta_j/beta_{j-1}, with
  alpha_j = (y.Ay)/|y|^2 and beta_j = |y| read off the previous moments.
* ``lanczos_replay_fused``: pass 2, the same sweeps recomputing the same
  scalars from their own moments (bitwise-repeatable reductions make them
  equal to pass 1's) while accumulating w = sum_j c_j v_j.
* ``recurrence_apply_fused``: the generic (m, 4)-rows recurrence (the
  Chebyshev, Leja and Faber passes), no moment feedback: its second stage
  runs in recurrence mode, which copies the next sweep's row into the
  state (``sweep_rows_ref``).

The Lanczos scalars live in a small state buffer on the device (``_ST``):
the second stage after sweep j writes the next sweep's (ca, cb, cc, cw),
alpha_j and beta_{j-1} there and into the outputs, and sweep j + 1 reads
its coefficients from it. So a Lanczos or replay step is two launches and
never synchronizes with the host.

The two passes take their step from the device (the device-index form,
``csrc/fused_sweep.cu``): the state also holds the step counter s, the
sweep picks its five vectors from the pass's ring (v0, a zero vector,
three y and two A y buffers: ``ring_slots``) by s, and the stage reads
j = s and advances it. A pass is then one step, (sweep, stage), with the
same arguments every time, run m + 1 times by a ``utils/graphs.LoopRunner``
(``_lanczos_sweeps``): on a CUDA device step 0 runs eagerly, step 1 is
captured into a CUDA graph and the rest replay it; inside a step that a
runner executes or a capture records (a serving program, a device
driver's step) the pass runs inline. On CPU tensors the same step runs
the twins, ``fused_sweep_ring_ref`` and ``sweep_stage_ref``
(``_lanczos_scalars``), whose writes are masked by the counter, not
branched on it on the host; on CUDA tensors it launches B3 (or B3-var)
and the stage, or raises. ``fused_lanczos_step`` and the sharded slab
sweeps (``parallel/stencil_fused.py``, whose collectives run on gloo,
which a graph cannot capture) keep the host-index form: a pointer per
vector and j from the host. The generic recurrence takes the
device-index form too: sweep s reads its
coefficients, row s - 1 of the (m, 4) rows (sweep 0 the unit row of the
initial state), from the state, where the second stage's recurrence mode
(``_SweepPlan.stage_rows``) copied them after sweep s - 1 without reading
any moment; the recurrence is then one (sweep, stage) step too, run m + 1
times like a pass.

What does not change between sweeps is planned once per (operator, dtype,
device) and kept on the operator (``_SweepPlan``): the support check, the
offsets, the tile and chunk plan, the bound C entry points and the
partials and state buffers. A plan's buffers serve one call at a time on
one stream. Vectors are flat (n,) tensors in the natural row-major grid
layout; 2-D grids run as nz = 1. A variable operator's fields in another
dtype than the vectors are cast once and kept on the operator
(``VariableStencilOperator.fields``), as are a constant operator's
coefficients.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils import graphs
from ..sparse import _promoted
from ..stencil import StencilOperator, VariableStencilOperator, stencil_apply
from . import _build
from .dispatch import refuse_grad

__all__ = ["fused_supported", "fused_lanczos_step", "fused_sweep_ref",
           "fused_sweep_ring_ref", "ring_slots", "sweep_stage_ref",
           "sweep_rows_ref",
           "lanczos_coeffs_fused", "lanczos_replay_fused",
           "recurrence_apply_fused", "stencil_matvec_fused", "MAX_HALO"]

MAX_HALO = 3            # largest |offset| per axis: eu::kMaxHalo
# (ty, tx) column tile of a B3 block (2 cells a thread) by itemsize, and of
# a B3-var block (1 cell a thread: its fields): the fastest of the tiles
# timed at 216^3 on the H100 (PERF.md, the kernel table)
TILE = {4: (16, 32), 8: (8, 32)}
VAR_TILE = (8, 32)

# the Lanczos state buffer: eu::kCa .. eu::kStep in csrc/fused_sweep.cu
_ST = dict(ca=0, cb=1, cc=2, cw=3, beta_prev=4, broke=5, m_used=6, live=7,
           step=8)
_ST_LEN = 9
# its values before sweep 0: (1, 0, 0) emits y = v0, beta_prev divides as 1
_STATE0 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)


def fused_supported(op, hermitian: bool = True) -> bool:
    """True for a real 2-D/3-D box ``StencilOperator`` (symmetric when
    ``hermitian``) or ``VariableStencilOperator`` (``is_hermitian`` when
    ``hermitian``, as the JAX dispatch requires) with |offset| <=
    MAX_HALO per axis and at most ``_build.MAX_POINTS`` points."""
    variable = isinstance(op, VariableStencilOperator)
    if not (variable or isinstance(op, StencilOperator)) \
            or len(op.grid_shape) not in (2, 3):
        return False
    if op.dtype.is_complex or len(op.offsets) > _build.MAX_POINTS:
        return False
    if any(abs(o) > MAX_HALO for off in op.offsets for o in off):
        return False
    if variable:
        return op.is_hermitian or not hermitian
    if hermitian:
        cmap = {off: float(c) for off, c in zip(op.offsets, op.host_coeffs)}
        if any(cmap.get(off, 0.0) != cmap.get(tuple(-o for o in off), 0.0)
               for off in cmap):
            return False
    return True


def _geometry(op):
    """((nz, ny, nx), (dz, dy, dx) offsets) with 2-D grids as nz = 1."""
    gs = op.grid_shape
    if len(gs) == 2:
        return (1,) + gs, tuple((0,) + off for off in op.offsets)
    return gs, op.offsets


def _chunk(shape3, tile, hz: int, capacity: int) -> int:
    """z-planes per block: as few chunks as keep every block of the grid
    resident at once (``capacity`` blocks on the device), at least 2 hz
    planes so a chunk's z-halo is no larger than the chunk itself."""
    nz, ny, nx = shape3
    cols = math.ceil(ny / tile[0]) * math.ceil(nx / tile[1])
    cz = math.ceil(nz / max(1, capacity // cols))
    return max(cz, min(nz, 2 * hz))


def _cvals(op, dtype):
    """The sweep's coefficients in ``dtype``: (k,) constants, or the
    (k, n) fields of a variable operator (cast once, kept on it)."""
    if isinstance(op, VariableStencilOperator):
        return op.fields(dtype)
    return _promoted(op, "coeffs", dtype)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------- twins --

def fused_sweep_ref(Z, Vc, Vp, coefs, grid_shape, offsets, cvals,
                    w_accum=None, z_range=None):
    """Plain twin of B3 and B3-var: (Y, Zn, moments (2,)), with W += cw Vc
    done in place on ``w_accum`` when given. ``cvals`` is (k,) for a
    constant stencil or the (k, n) fields of a variable one. ``z_range``
    (z0, z1): the moments sum over the planes [z0, z1) of grid axis 0
    only (default: all)."""
    if cvals.ndim == 2:
        cvals = cvals.reshape((-1,) + tuple(grid_shape))
    y = coefs[0] * Z + coefs[1] * Vc + coefs[2] * Vp
    zn = stencil_apply(y.reshape(grid_shape), offsets, cvals).reshape(-1)
    ym, zm = y, zn
    if z_range is not None:
        plane = y.shape[0] // grid_shape[0]
        ym = y[z_range[0] * plane:z_range[1] * plane]
        zm = zn[z_range[0] * plane:z_range[1] * plane]
    moments = torch.stack([(ym * ym).sum(), (ym * zm).sum()])
    if w_accum is not None:
        w_accum.add_(coefs[3] * Vc)
    return y, zn, moments


def _lanczos_scalars(ypy, yzy, beta_prev, broke, tol):
    """(ca, cb, cc, alpha, beta, now_broke, live, safe_beta) of the next
    sweep from the previous sweep's moments.

    beta = |y_j| is the off-diagonal recorded one step earlier, so
    ``live`` (no breakdown so far, this one included) is the step's
    activity in the sense of ``ops.krylov.lanczos_coeffs``: masking alpha,
    m_used and the replay weights with it gives the same masked tail as
    the plain pass 1 after a happy breakdown."""
    beta = torch.sqrt(torch.clamp_min(ypy, 0.0))
    alpha = torch.where(ypy > 0, yzy / torch.clamp_min(
        ypy, torch.finfo(ypy.dtype).tiny), 0.0)
    now_broke = beta < tol
    active = ~broke
    go = active & ~now_broke
    safe_beta = torch.where(beta > 0, beta, 1.0)
    safe_bp = torch.where(beta_prev > 0, beta_prev, 1.0)
    ca = torch.where(go, 1.0 / safe_beta, 0.0)
    cb = -alpha * ca
    cc = torch.where(go, -beta / safe_bp, 0.0)
    return ca, cb, cc, alpha, beta, now_broke, go, safe_beta


def sweep_stage_ref(moments, state, alphas, betas, coeffs, m: int,
                    tol: float):
    """Plain twin of the Lanczos-mode second stage after sweep j, in its
    device-index form (``sweep_stage_kernel`` with j read from the state):
    j is the state's counter (``_ST["step"]``), which it advances; it
    updates ``state`` (``_ST``), ``alphas`` and ``betas`` in place from the
    sweep's moments, every write masked by j (betas[j - 1] where 0 < j <=
    m, step j's scalars where j < m, at j = m a breakdown that |y_m| < tol
    shows, as the plain pass 1 records at its last step; past m nothing
    but the counter) with no host branch on it; ``coeffs`` (the replay's
    weights) or None."""
    ypy, yzy = moments[0], moments[1]
    step = state[_ST["step"]:_ST["step"] + 1]
    if m > 0:
        j = step.to(torch.int64)
        jb = torch.clamp(j - 1, 0, m - 1)
        beta_j = torch.where(state[_ST["live"]] != 0,
                             torch.sqrt(torch.clamp_min(ypy, 0.0)), 0.0)
        betas.index_copy_(0, jb, torch.where((j > 0) & (j <= m), beta_j,
                                             betas.index_select(0, jb)))
        act = j < m
        jc = torch.clamp(j, max=m - 1)
        broke = state[_ST["broke"]] != 0
        ca, cb, cc, alpha, beta, now_broke, live, safe_beta = \
            _lanczos_scalars(ypy, yzy, state[_ST["beta_prev"]], broke, tol)
        cw = (torch.where(live, coeffs.index_select(0, jc)[0] / safe_beta,
                          0.0) if coeffs is not None
              else torch.zeros_like(ca))
        alphas.index_copy_(0, jc, torch.where(
            act, torch.where(live, alpha, 0.0), alphas.index_select(0, jc)))
        new = torch.stack([
            ca, cb, cc, cw, beta, (broke | now_broke).to(state.dtype),
            torch.where(live, step[0] + 1, state[_ST["m_used"]]),
            live.to(state.dtype)])
        # at the last step only broke, by the breakdown |y_m| < tol
        slot = torch.arange(_ST["step"], device=state.device)
        keep = state[:_ST["step"]]
        state[:_ST["step"]] = torch.where(
            act | ((slot == _ST["broke"]) & (j == m)), new, keep)
    step.add_(1)


def sweep_rows_ref(state, rows, m: int):
    """Plain twin of the second stage's recurrence mode: after sweep s (the
    state's counter, which it advances) row s of the (m, 4) ``rows`` into
    the state's coefficient slots where s < m, masked by the counter, not
    branched on it on the host."""
    step = state[_ST["step"]:_ST["step"] + 1]
    if m > 0:
        s = step.to(torch.int64)
        row = rows.index_select(0, torch.clamp(s, max=m - 1))[0]
        state[:4] = torch.where(s < m, row, state[:4])
    step.add_(1)


def ring_slots(ring, s: int):
    """(Z, Vc, Vp, Y, Zn) of sweep s from a pass's ring (v0, zero, y0, y1,
    y2, z0, z1): Z = A y_{s-1} (v0 at s = 0), Vc = y_{s-1}, Vp = y_{s-2}
    (the zero vector before the start), y_s into slot s mod 3 and A y_s
    into slot s mod 2 (``SweepRing`` in ``csrc/fused_sweep.cu``)."""
    v0, zero, ys, zs = ring[0], ring[1], ring[2:5], ring[5:7]
    return (v0 if s == 0 else zs[(s - 1) % 2],
            zero if s == 0 else ys[(s - 1) % 3],
            zero if s <= 1 else ys[(s - 2) % 3],
            ys[s % 3], zs[s % 2])


def fused_sweep_ring_ref(ring, state, grid_shape, offsets, cvals,
                         w_accum=None):
    """Plain twin of B3 and B3-var in their device-index form: sweep s =
    ``state[_ST["step"]]`` (read here: the twin's vectors are Python
    objects) on the ring's slots of step s (``ring_slots``), its
    coefficients from ``state``; writes y_s and A y_s into their slots and
    returns the moments (2,)."""
    Z, Vc, Vp, Y, Zn = ring_slots(ring, int(state[_ST["step"]]))
    y, zn, moments = fused_sweep_ref(Z, Vc, Vp, state, grid_shape, offsets,
                                     cvals, w_accum)
    Y.copy_(y)
    Zn.copy_(zn)
    return moments


# ---------------------------------------------------------------- plan --

class _SweepPlan:
    """What every sweep of one operator in one dtype on one device shares
    (module doc). On CPU only the support checks; on CUDA also the tile
    (ty, tx) = ``TILE`` (``VAR_TILE``) cut to the grid, the chunk of z-planes per block,
    the block count, the C entry points, the partials and state buffers
    and ``unit`` = (1, 0, 0, 0), the coefficients of a sweep that emits
    y = Z."""

    def __init__(self, op, dtype, device):
        if not fused_supported(op, hermitian=False):
            raise ValueError("fused sweep requires a real 2-D/3-D Stencil or "
                             "VariableStencil operator with |offset| <= "
                             f"{MAX_HALO} (got {type(op).__name__})")
        self.hermitian = fused_supported(op, hermitian=True)
        self.variable = isinstance(op, VariableStencilOperator)
        self.grid_shape, self.offsets = op.grid_shape, op.offsets
        self.n = op.shape[0]
        self.kernel = device.type == "cuda"
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"fused sweep: no kernel or twin for {device}")
        if not self.kernel:
            return
        if dtype not in _build.KERNEL_DTYPES:
            raise ValueError(f"fused sweep takes float32/float64, got {dtype}")
        if op.device != device:
            raise ValueError("operator and vectors must share one device")
        self.shape3, offs3 = _geometry(op)
        nz, ny, nx = self.shape3
        itemsize = torch.empty((), dtype=dtype).element_size()
        ty, tx = VAR_TILE if self.variable else TILE[itemsize]
        self.tile = (min(ty, ny), min(tx, nx))
        self.name = "fused_sweep_var" if self.variable else "fused_sweep"
        self.what = ("fused sweep kernel (B3-var)" if self.variable
                     else "fused sweep kernel (B3)")
        lib = _build.library()
        suf = _build.suffix(dtype)
        self.sweep_fn = getattr(lib, f"eu_{self.name}_{suf}")
        self.ring_fn = getattr(lib, f"eu_{self.name}_ring_{suf}")
        self.stage_fn = getattr(lib, f"eu_sweep_stage_{suf}")
        self.rows_fn = getattr(lib, f"eu_sweep_stage_rows_{suf}")
        flat = [int(v) for off in offs3 for v in off]
        self.offs = (ctypes.c_int * len(flat))(*flat)
        self.k = len(offs3)
        with torch.cuda.device(device):
            cap = getattr(lib, f"eu_fused_sweep_capacity_{suf}")(
                self.offs, self.k, *self.tile, int(self.variable))
        if cap <= 0:
            _build.check(-cap if cap < 0 else 9,    # 9: cudaErrorInvalidConfiguration
                         f"{self.what}: no block fits on the device")
        hz = max(abs(off[0]) for off in offs3)
        self.cz = _chunk(self.shape3, self.tile, hz, cap)
        self.nblocks = (math.ceil(nx / self.tile[1])
                        * math.ceil(ny / self.tile[0]) * math.ceil(nz / self.cz))
        self.partials = torch.empty(2 * self.nblocks, dtype=dtype,
                                    device=device)
        self.state = torch.empty(_ST_LEN, dtype=dtype, device=device)
        self.state0 = _const(_STATE0, self.state)
        self.unit = self.state0[:4]

    def sweep(self, Z, Vc, Vp, coefs_ptr: int, cvals, Y, Zn, W, stream,
              z_range=None):
        """Launch B3 (or B3-var) with its coefficients at ``coefs_ptr``,
        its moments over the planes ``z_range`` = (z0, z1) of the 3-D
        grid (default: all of them)."""
        nz, ny, nx = self.shape3
        z0, z1 = (0, nz) if z_range is None else z_range
        code = self.sweep_fn(Z.data_ptr(), Vc.data_ptr(), Vp.data_ptr(),
                             coefs_ptr, cvals.data_ptr(), self.offs, self.k,
                             nz, ny, nx, self.cz, *self.tile, Y.data_ptr(),
                             Zn.data_ptr(), _ptr(W), self.partials.data_ptr(),
                             2 * self.nblocks, z0, z1, stream)
        _build.check(code, self.what)
        _build.launches[self.name] += 1

    def sweep_ring(self, ring, state, cvals, W, stream):
        """Launch B3 (or B3-var) in its device-index form: the step s from
        ``state``'s counter, its vectors the slots of step s of ``ring``
        (a ctypes array of the seven pointers v0, zero, y0, y1, y2, z0, z1:
        ``ring_slots``), its coefficients from ``state``."""
        nz, ny, nx = self.shape3
        code = self.ring_fn(ring, state.data_ptr(), cvals.data_ptr(),
                            self.offs, self.k, nz, ny, nx, self.cz,
                            *self.tile, _ptr(W), self.partials.data_ptr(),
                            2 * self.nblocks, 0, nz, stream)
        _build.check(code, self.what)
        _build.launches[self.name] += 1

    def stage(self, stream, moments=None, state=None, alphas=None,
              betas=None, coeffs=None, j=0, m=0, tol=0.0, partials=None):
        """Launch the second stage of the last sweep: its moments into
        ``moments``, or in Lanczos mode (``state``) the scalars of step
        ``j`` into ``state``, ``alphas`` and ``betas``; ``j`` None: the
        device-index form, j read from the state's counter and advanced
        (``sweep_stage_ref``). ``partials``: a 2-vector of moments to read
        instead of the last sweep's per-block partials (the sharded
        sweeps' reduced moments)."""
        src, nb = ((self.partials, self.nblocks) if partials is None
                   else (partials, 1))
        code = self.stage_fn(src.data_ptr(), nb,
                             _ptr(moments), _ptr(state), _ptr(alphas),
                             _ptr(betas), _ptr(coeffs),
                             -1 if j is None else j, m, tol, stream)
        _build.check(code, "second stage of the fused sweep")
        _build.launches["sweep_stage"] += 1

    def stage_rows(self, stream, state, rows, m: int):
        """Launch the second stage in recurrence mode: row s of the (m, 4)
        ``rows`` into ``state``'s coefficient slots (s the state's
        counter, which it advances; ``sweep_rows_ref``)."""
        code = self.rows_fn(state.data_ptr(), _ptr(rows), m, stream)
        _build.check(code, "second stage of the fused sweep (recurrence "
                     "mode)")
        _build.launches["sweep_stage"] += 1


def _plan(op, dtype, device) -> _SweepPlan:
    plans = op.__dict__.setdefault("_sweep_plans", {})
    plan = plans.get((dtype, device))
    if plan is None:
        plan = plans[(dtype, device)] = _SweepPlan(op, dtype, device)
    return plan


def _vector(plan, v, what):
    """``v`` as the drivers' contiguous (n,) start vector."""
    if v.shape != (plan.n,):
        raise ValueError(f"{what}: vector of shape {tuple(v.shape)} for an "
                         f"operator of {plan.n} rows")
    return v.contiguous()


# ------------------------------------------------------------- wrapper --

def fused_lanczos_step(Z, Vc, Vp, coefs, op, *, w_accum=None, z_range=None):
    """One fused sweep (module doc): kernel B3 (constant stencil) or B3-var
    (variable) and its second stage on CUDA, their twins on CPU. ``coefs``
    = (ca, cb, cc[, cw]) as a tensor on the vectors' device. Returns (Y,
    Zn, ypy, yzy), plus W when ``w_accum`` is given (updated in place:
    W = w_accum + cw Vc). ``z_range`` (z0, z1): the moments cover the
    planes [z0, z1) of the grid's axis 0 only (a 2-D grid's is its one
    plane); the default, all planes, is the sweep of the drivers here."""
    dev, dt = Z.device, Z.dtype
    plan = _plan(op, dt, dev)
    vecs = (Z, Vc, Vp) if w_accum is None else (Z, Vc, Vp, w_accum)
    shape = (plan.n,)
    for v in vecs:
        if v.shape != shape or v.dtype != dt or v.device != dev:
            raise ValueError("sweep vectors must be (n,) tensors of one "
                             "dtype on one device")
    ncoef = 4 if w_accum is not None else 3
    if coefs.shape[0] < ncoef:
        raise ValueError(f"sweep needs {ncoef} coefficients")
    cvals = _cvals(op, dt)
    if not plan.kernel:
        shape3, offs3 = _geometry(op)
        Y, Zn, moments = fused_sweep_ref(Z, Vc, Vp, coefs, shape3, offs3,
                                         cvals, w_accum, z_range)
        return _step_result(Y, Zn, moments, w_accum)
    refuse_grad("fused_lanczos_step (B3)", op, coefs, *vecs)
    if coefs.device != dev:
        raise ValueError("coefficients and vectors must share one device")
    if not all(v.is_contiguous() for v in vecs):
        raise ValueError("fused sweep takes contiguous tensors")
    if coefs.dtype != dt or not coefs.is_contiguous():
        coefs = coefs.to(dt).contiguous()
    Y, Zn = torch.empty_like(Z), torch.empty_like(Z)
    stream = _build.raw_stream(Z.device)
    plan.sweep(Z, Vc, Vp, coefs.data_ptr(), cvals, Y, Zn, w_accum, stream,
               z_range)
    # made while the sweep runs: the stage's launch costs no device time
    moments = torch.empty(2, dtype=dt, device=dev)
    plan.stage(stream, moments=moments)
    return _step_result(Y, Zn, moments, w_accum)


def _step_result(Y, Zn, moments, w_accum):
    ypy, yzy = moments.unbind()
    if w_accum is not None:
        return Y, Zn, ypy, yzy, w_accum
    return Y, Zn, ypy, yzy


def _const(values, like):
    """A small coefficient vector on like's device, filled without a
    host-to-device copy."""
    out = torch.zeros(len(values), dtype=like.dtype, device=like.device)
    for i, v in enumerate(values):
        if v:
            out[i].fill_(v)     # a fill kernel; ``out[i] = v`` copies via host
    return out


def _start(b):
    beta0 = torch.linalg.vector_norm(b)
    v0 = torch.where(beta0 > 0, b / torch.where(beta0 > 0, beta0, 1.0), 0.0)
    return beta0, v0


def _run_pass(label: str, dev, step, m: int):
    """Run a pass's (sweep, stage) step m + 1 times (module doc): inline
    where ``graphs.inline`` says so, else through a runner of the call's
    own (key m, step ``"sweep"``)."""
    if graphs.inline(dev):
        for _ in range(m + 1):
            step()
        return
    with graphs.LoopRunner(label, dev) as runner:
        runner.repeat(m, "sweep", step, m + 1, last=True)


def _lanczos_sweeps(op, b, m: int, tol: float, coeffs=None, *, what):
    """Lanczos pass 1 (``coeffs`` None) or its replay with weights
    ``coeffs`` ((m,)): m + 1 sweeps from v0 = b / |b|, each followed by
    the Lanczos-mode second stage, as one step in the device-index form
    (module doc) run m + 1 times. Sweep 0's (1, 0, 0) emits y = v0, Z =
    A v0 and the first moments; sweep s + 1 accumulates c_s v_s from its
    Vc input (Vc = y_s with |y_s| = beta, so Vc / beta = v_s) while
    producing y_{s+1}. Returns (alphas, betas, beta0, m_used, broke, W),
    W None in pass 1; both passes fill alphas and betas."""
    plan = _plan(op, b.dtype, b.device)
    if not plan.hermitian:
        raise ValueError(f"{what} requires a symmetric 2-D/3-D Stencil or "
                         "Hermitian VariableStencil operator")
    beta0, v0 = _start(_vector(plan, b, what))
    dt, dev = v0.dtype, v0.device
    if coeffs is not None:
        coeffs = coeffs.to(dtype=dt, device=dev).contiguous()
        m = coeffs.shape[0]
    ring = (v0, torch.zeros_like(v0),
            *(torch.empty_like(v0) for _ in range(5)))
    W = None if coeffs is None else torch.zeros_like(v0)
    alphas = torch.empty(m, dtype=dt, device=dev)
    betas = torch.empty(m, dtype=dt, device=dev)
    cvals = _cvals(op, dt)
    if plan.kernel:
        refuse_grad(f"{what} (B3)", op, b, coeffs)
        state = plan.state
        state.copy_(plan.state0)
        ptrs = (ctypes.c_void_p * len(ring))(*(v.data_ptr() for v in ring))

        def step():
            stream = _build.raw_stream(dev)
            plan.sweep_ring(ptrs, state, cvals, W, stream)
            plan.stage(stream, state=state, alphas=alphas, betas=betas,
                       coeffs=coeffs, j=None, m=m, tol=tol)
    else:
        state = _const(_STATE0, v0)

        def step():
            moments = fused_sweep_ring_ref(ring, state, op.grid_shape,
                                           op.offsets, cvals, W)
            sweep_stage_ref(moments, state, alphas, betas, coeffs, m, tol)
    state[_ST["broke"]].copy_(beta0 == 0)
    _run_pass(f"{what} ({type(op).__name__})", dev, step, m)
    m_used = state[_ST["m_used"]].to(torch.int32)
    return alphas, betas, beta0, m_used, state[_ST["broke"]] != 0, W


def lanczos_coeffs_fused(op, b, m: int, *, tol: float = 1e-7):
    """Drop-in twin of ``ops.krylov.lanczos_coeffs`` for symmetric 2-D/3-D
    box ``StencilOperator``s and Hermitian ``VariableStencilOperator``s:
    m + 1 fused sweeps, each with its second stage."""
    return _lanczos_sweeps(op, b, m, tol, what="lanczos_coeffs_fused")[:5]


def lanczos_replay_fused(op, b, coeffs, *, tol: float = 1e-7):
    """Replay twin: w = sum_j coeffs[j] v_j regenerating the basis with the
    same sweeps as ``lanczos_coeffs_fused`` (m + 1 accumulating sweeps)."""
    return _lanczos_sweeps(op, b, 0, tol, coeffs,
                           what="lanczos_replay_fused")[5]


def _unit(plan, like):
    """(1, 0, 0, 0): the coefficients of a sweep that emits y = Z."""
    return plan.unit if plan.kernel else _const((1.0, 0.0, 0.0, 0.0), like)


def stencil_matvec_fused(op, x):
    """``A @ x`` through one (1, 0, 0) fused sweep (Zn = A x); on CUDA
    without the second stage (nothing reads the moments)."""
    plan = _plan(op, x.dtype, x.device)
    x = _vector(plan, x, "stencil_matvec_fused")
    zeros = torch.zeros_like(x)
    cvals = _cvals(op, x.dtype)
    if not plan.kernel:
        return fused_sweep_ref(x, zeros, zeros, _unit(plan, x), op.grid_shape,
                               op.offsets, cvals)[1]
    refuse_grad("stencil_matvec_fused (B3)", op, x)
    Y, Zn = torch.empty_like(x), torch.empty_like(x)
    plan.sweep(x, zeros, zeros, plan.unit.data_ptr(), cvals, Y, Zn, None,
               _build.raw_stream(x.device))
    return Zn


def recurrence_apply_fused(op, b, rows):
    """The generic (m, 4)-rows recurrence, one accumulating sweep per step:

        omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
        w          += cw_k omega_k,          k = 0..m-1,  omega_0 = b.

    ``rows`` is a (m, 4) tensor on b's device (the Chebyshev rows of
    ``ops.kernels.dispatch.chebyshev_rows``, the Newton and Faber rows of
    ``models/leja.py`` and ``models/faber.py``). In the device-index form
    (module doc): the ring of a pass with v0 = b, sweep s's coefficients
    row s - 1 from the state (sweep 0: the unit row), each sweep followed
    by the second stage in recurrence mode; m + 1 (sweep, stage) steps.
    Sweep 0 emits omega_0 = b and Z = A omega_0 (accumulating cw = 0);
    sweep s + 1 accumulates cw_s omega_s from its Vc input while emitting
    omega_{s+1}."""
    plan = _plan(op, b.dtype, b.device)
    b = _vector(plan, b, "recurrence_apply_fused")
    dev = b.device
    rows = torch.as_tensor(rows, dtype=b.dtype, device=dev).contiguous()
    m = rows.shape[0]
    ring = (b, torch.zeros_like(b), *(torch.empty_like(b) for _ in range(5)))
    W = torch.zeros_like(b)
    cvals = _cvals(op, b.dtype)
    if plan.kernel:
        refuse_grad("recurrence_apply_fused (B3)", op, b, rows)
        state = plan.state
        state.copy_(plan.state0)
        ptrs = (ctypes.c_void_p * len(ring))(*(v.data_ptr() for v in ring))

        def step():
            stream = _build.raw_stream(dev)
            plan.sweep_ring(ptrs, state, cvals, W, stream)
            plan.stage_rows(stream, state, rows, m)
    else:
        state = _const(_STATE0, b)

        def step():
            fused_sweep_ring_ref(ring, state, op.grid_shape, op.offsets,
                                 cvals, W)
            sweep_rows_ref(state, rows, m)
    _run_pass(f"recurrence_apply_fused ({type(op).__name__})", dev, step, m)
    return W

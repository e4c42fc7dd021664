"""Shard-local fused sweeps: kernel B3 (B3-var) on each rank's slab
(PyTorch port of ``exponentialutilities_jl_tpu/parallel/stencil_fused.py``).

Each rank runs the single-device fused sweep (``ops/kernels/
lanczos_fused.py``) on its EXTENDED slab: its sz planes of grid axis 0
plus h0 = max|offset along axis 0| halo planes at each end, in the natural
row-major layout. A 2-D grid (ny, nx) sharded on y runs as the 3-D grid
(sy + 2 h0, 1, nx) with offsets (dy, 0, dx), so one plane range serves
both. Per sweep:

* The sweep reads Z, Vc, Vp on the whole extended slab. Y = ca Z + cb Vc
  + cc Vp is elementwise, so its halo planes are right when the inputs'
  are; Zn = A Y is right on the interior planes, and its halo planes,
  which read past the extended slab, are overwritten by the ring
  neighbours' boundary planes (``refresh``: one ``ppermute_halo``, zeros
  at the global ends, the Dirichlet truncation).
* Lanczos moments: the sweep sums y.y and y.Zn over the interior planes
  [h0, h0 + sz) only (the kernel's moment plane range; the JAX package
  subtracts the halo planes' moments afterwards instead), its second
  stage writes the 2-vector, ``psum`` reduces it over the ranks, and the
  stage runs again in Lanczos mode on the reduced 2-vector. So the
  Lanczos scalars stay on the device (the state buffer of
  ``lanczos_fused``) and, with NCCL, a step reads nothing on the host: one
  sweep, two stage launches, one all_reduce of two values and one halo
  exchange per step.
* Pass 1 and the replay run the same launches on the same inputs, so the
  replay regenerates pass 1's alpha and beta bit for bit where the
  all_reduce is deterministic for a fixed rank count (both gloo and NCCL
  are, as the tests and chip_smoke.py check).

On CPU tensors every sweep runs the plain twin ``fused_sweep_ref`` (with
the same plane range) and every stage its twin ``sweep_stage_ref``; on
CUDA tensors B3 (or B3-var) and the stage, or it raises. Left out, as TPU
workarounds: the 128-lane ghost layout, the VMEM plane budgets and the
float32-only gate (B3 and B3-var run float64 on the card).
"""

from __future__ import annotations

import copy
import math

import torch

from ..ops.kernels import _build
from ..ops.kernels.dispatch import chebyshev_rows, refuse_grad
from ..ops.kernels.lanczos_fused import (_ST, _STATE0, _const, _cvals,
                                         _plan, fused_supported,
                                         fused_sweep_ref, sweep_stage_ref)
from ..ops.stencil import StencilOperator, VariableStencilOperator

__all__ = ["fused_shard_plan", "FusedShardPlan", "FusedShardPlan2D",
           "FusedShardPlanVar", "recurrence_apply_fused_sharded",
           "recurrence_apply_fused_sharded_var",
           "lanczos_coeffs_fused_sharded", "lanczos_replay_fused_sharded",
           "chebyshev_rows"]


class FusedShardPlan:
    """Per-rank plan of the shard-local sweep for a 3-D constant
    ``StencilOperator`` sharded on grid axis 0 over ``comm`` (a
    ``parallel.MeshAxis``): the extended slab's geometry and the extended
    slab's own ``StencilOperator`` (``ext``), which keeps the sweep's
    launch plan per dtype and device."""

    dims = 3

    def __init__(self, op, comm, *, hermitian: bool = False):
        gs = op.grid_shape
        if not isinstance(op, self._op_class()) or len(gs) != self.dims:
            raise ValueError(f"{type(self).__name__} takes a {self.dims}-D "
                             f"{self._op_class().__name__}, got "
                             f"{type(op).__name__} on grid {gs}")
        if not fused_supported(op, hermitian=hermitian):
            raise ValueError("fused sharded sweep: the operator is not a "
                             "real box stencil within the kernel's reach"
                             + (" (symmetric)" if hermitian else ""))
        self.comm = comm
        self.hermitian = hermitian
        nshards = comm.axis_size()
        s0 = gs[0]
        if s0 % nshards:
            raise ValueError(f"grid axis 0 ({s0}) must divide evenly over "
                             f"{nshards} shards")
        self.sz = s0 // nshards
        self.h0 = max((abs(o[0]) for o in op.offsets), default=0)
        if self.h0 > self.sz:
            raise ValueError(f"axis-0 halo {self.h0} exceeds local slab "
                             f"depth {self.sz}")
        self.sze = self.sz + 2 * self.h0
        self.plane = math.prod(gs[1:])
        self.n_local = self.sz * self.plane
        self.ext_shape, self.ext_offsets = self._ext_geometry(gs, op.offsets)
        self.z_range = (self.h0, self.h0 + self.sz)
        self.ext_hermitian = op.is_hermitian
        self.ext = self._ext_operator(op)

    def _op_class(self):
        return StencilOperator

    def _ext_geometry(self, gs, offsets):
        return (self.sze,) + tuple(gs[1:]), tuple(offsets)

    def _ext_operator(self, op):
        return StencilOperator(self.ext_shape, self.ext_offsets,
                               op.coeffs.to(self.comm.device),
                               is_hermitian=self.ext_hermitian)

    # -- layout ----------------------------------------------------------

    def to_ext(self, v_local):
        """(..., sz plane) rows -> the extended slab with zero halo planes
        (callers refresh them)."""
        if v_local.shape[-1] != self.n_local:
            raise ValueError(f"vector of {v_local.shape[-1]} rows for a "
                             f"shard of {self.n_local}")
        out = v_local.new_zeros(v_local.shape[:-1] + (self.sze * self.plane,))
        out[..., self.h0 * self.plane:(self.h0 + self.sz) * self.plane] = \
            v_local
        return out

    def interior(self, X):
        """The extended slab's interior planes: this rank's rows."""
        return X[..., self.h0 * self.plane:
                 (self.h0 + self.sz) * self.plane].clone()

    def refresh(self, X):
        """Overwrite the halo planes of X (in place, along its last axis)
        with the ring neighbours' boundary interior planes, zeros at the
        global ends: one ``ppermute_halo``."""
        h0, sz, pl = self.h0, self.sz, self.plane
        if h0 == 0:
            return X
        below, above = self.comm.ppermute_halo(
            X[..., h0 * pl:2 * h0 * pl], X[..., sz * pl:(sz + h0) * pl])
        X[..., :h0 * pl] = below
        X[..., (sz + h0) * pl:] = above
        return X


class FusedShardPlan2D(FusedShardPlan):
    """2-D twin of ``FusedShardPlan``: the grid (ny, nx) is sharded on y,
    and the extended (sy + 2 h0, nx) slab runs as the 3-D grid (sy + 2 h0,
    1, nx) with offsets (dy, 0, dx), so the halo layers are whole planes
    of that grid and the 3-D code serves both."""

    dims = 2

    def _ext_geometry(self, gs, offsets):
        return ((self.sze, 1, gs[1]),
                tuple((o[0], 0, o[1]) for o in offsets))


class FusedShardPlanVar(FusedShardPlan):
    """Variable-coefficient twin of ``FusedShardPlan`` (3-D): B3-var on the
    extended slab, whose (k, sze plane) coefficient fields get their halo
    planes once per solve (``local_operator``: one ``ppermute_halo`` for
    all k fields; the fields never change between sweeps)."""

    def _op_class(self):
        return VariableStencilOperator

    def _ext_operator(self, op):
        return None         # made per solve from the fields (local_operator)

    def local_fields(self, op):
        """This rank's (k, sz plane) columns of the global operator's
        fields, on the mesh's device."""
        i = self.comm.axis_index()
        return op.coeff_fields[:, i * self.n_local:(i + 1) * self.n_local] \
            .to(self.comm.device)

    def local_operator(self, cf_local):
        """The extended slab's ``VariableStencilOperator`` from this rank's
        (k, sz plane) fields, their halo planes exchanged (once per
        solve)."""
        F = self.refresh(self.to_ext(cf_local))
        return VariableStencilOperator(self.ext_shape, self.ext_offsets, F,
                                       is_hermitian=self.ext_hermitian)


def fused_shard_plan(op, mesh, axis_name: str | None = None,
                     hermitian: bool = False) -> FusedShardPlan:
    """The shard-local fused plan of a 2-D/3-D constant ``StencilOperator``
    row-partitioned on grid axis 0 over ``mesh`` (kept on the operator per
    rank set, backend, device and ``hermitian``). Raises ValueError when
    unsupported (callers take the plain sharded path or raise)."""
    comm = mesh.axis(axis_name)
    if isinstance(op, VariableStencilOperator):
        cls = FusedShardPlanVar
        if len(op.grid_shape) != 3:
            raise ValueError(
                "variable fused sharding supports 3-D grids only")
    elif isinstance(op, StencilOperator) and len(op.grid_shape) == 2:
        cls = FusedShardPlan2D
    elif isinstance(op, StencilOperator) and len(op.grid_shape) == 3:
        cls = FusedShardPlan
    else:
        raise ValueError("fused sharded sweep requires a 2-D/3-D constant "
                         "StencilOperator or a 3-D VariableStencilOperator")
    # keyed by the axis's ranks, not by the MeshAxis: a new mesh over the
    # same ranks (one per call, per test) reuses the plan and its device
    # buffers under its own axis, so the cache holds one plan per rank set
    plans = op.__dict__.setdefault("_shard_plans", {})
    key = (comm.ranks, comm.backend, comm.device, bool(hermitian))
    plan = plans.get(key)
    if plan is None:
        plan = plans[key] = cls(op, comm, hermitian=hermitian)
    elif plan.comm is not comm:
        plan = plans[key] = copy.copy(plan)
        plan.comm = comm
    return plan


# ---------------------------------------------------------------- sweeps --

class _Sweeps:
    """The sweeps of one sharded call on the extended operator ``ext``:
    B3/B3-var and the stage on CUDA, their twins on CPU."""

    def __init__(self, plan, ext, like, what, *operands):
        self.plan, self.ext = plan, ext
        self.sp = _plan(ext, like.dtype, like.device)
        self.kernel = self.sp.kernel
        self.cvals = _cvals(ext, like.dtype)
        if self.kernel:
            refuse_grad(f"{what} (B3)", ext, like, *operands)
            self.stream = _build.raw_stream(like.device)
            self.Ys = [torch.empty_like(like) for _ in range(3)]
            self.Zs = [torch.empty_like(like) for _ in range(2)]

    def unit(self, like):
        return self.sp.unit if self.kernel else _const((1.0, 0.0, 0.0, 0.0),
                                                       like)

    def __call__(self, s, Z, Vc, Vp, coefs, W=None):
        """Sweep s: (Y, Zn, local moments over the interior planes); the
        moments are None on CUDA, where the stage reads the partials."""
        if self.kernel:
            Y, Zn = self.Ys[s % 3], self.Zs[s % 2]
            self.sp.sweep(Z, Vc, Vp, coefs.data_ptr(), self.cvals, Y, Zn, W,
                          self.stream, self.plan.z_range)
            return Y, Zn, None
        return fused_sweep_ref(Z, Vc, Vp, coefs, self.plan.ext_shape,
                               self.plan.ext_offsets, self.cvals, W,
                               self.plan.z_range)


def _recurrence(plan, ext, b_local, rows, what):
    rows = torch.as_tensor(rows, dtype=b_local.dtype,
                           device=b_local.device).contiguous()
    B = plan.refresh(plan.to_ext(b_local.contiguous()))
    sw = _Sweeps(plan, ext, B, what, rows)
    zeros = torch.zeros_like(B)
    W = torch.zeros_like(B)
    # sweep 0 emits omega_0 = B (halos right) and Z = A omega_0; sweep k+1
    # accumulates cw_k omega_k from its Vc input while emitting omega_{k+1}
    Z, Vc, Vp = B, B, zeros
    for s in range(rows.shape[0] + 1):
        co = sw.unit(B) if s == 0 else rows[s - 1]
        Y, Zn, _ = sw(s, Z, Vc, Vp, co, W)
        Zn = plan.refresh(Zn)
        Z, Vc, Vp = Zn, Y, (zeros if s == 0 else Vc)
    return plan.interior(W)


def recurrence_apply_fused_sharded(plan: FusedShardPlan, b_local, rows):
    """The (m, 4)-rows recurrence (``recurrence_apply_fused``) on this
    rank's rows: m + 1 accumulating sweeps, each followed by one halo
    exchange of A omega, no moments read and no all_reduce. Returns this
    rank's rows of w."""
    return _recurrence(plan, plan.ext, b_local, rows,
                       "recurrence_apply_fused_sharded")


def recurrence_apply_fused_sharded_var(plan: FusedShardPlanVar, cf_local,
                                       b_local, rows):
    """The same recurrence on B3-var: ``cf_local`` is this rank's (k,
    sz plane) block of the coefficient fields (``plan.local_fields``),
    whose halo planes are exchanged once here."""
    ext = plan.local_operator(torch.as_tensor(cf_local).to(b_local.dtype))
    return _recurrence(plan, ext, b_local, rows,
                       "recurrence_apply_fused_sharded_var")


def _lanczos_sharded(plan, b_local, m: int, tol: float, coeffs=None):
    """Sharded Lanczos pass 1 (``coeffs`` None) or its replay: m + 1 sweeps
    from v0 = b / |b|, each followed by the stage (moments), the psum of
    the moments, the stage in Lanczos mode on the reduced moments and the
    halo exchange of A y (module doc). Returns (alphas, betas, beta0,
    m_used, broke, W-interior or None)."""
    comm = plan.comm
    if not plan.hermitian:
        raise ValueError("the sharded fused Lanczos needs a plan made with "
                         "hermitian=True")
    b_local = b_local.contiguous()
    dt, dev = b_local.dtype, b_local.device
    beta0 = torch.sqrt(comm.psum((b_local * b_local).sum()))
    v0 = torch.where(beta0 > 0, b_local / torch.where(beta0 > 0, beta0, 1.0),
                     0.0)
    V0 = plan.refresh(plan.to_ext(v0))
    if coeffs is not None:
        coeffs = coeffs.to(dtype=dt, device=dev).contiguous()
        m = coeffs.shape[0]
    sw = _Sweeps(plan, plan.ext, V0, "sharded fused Lanczos", b_local,
                 coeffs)
    zeros = torch.zeros_like(V0)
    W = None if coeffs is None else torch.zeros_like(V0)
    alphas = torch.empty(m, dtype=dt, device=dev)
    betas = torch.empty(m, dtype=dt, device=dev)
    if sw.kernel:
        state = sw.sp.state
        state.copy_(sw.sp.state0)
    else:
        state = _const(_STATE0, v0)
    state[_ST["broke"]].copy_(beta0 == 0)
    Z, Vc, Vp = V0, zeros, zeros
    for s in range(m + 1):
        Y, Zn, mom = sw(s, Z, Vc, Vp, state, W)
        if sw.kernel:
            mom = torch.empty(2, dtype=dt, device=dev)
            sw.sp.stage(sw.stream, moments=mom)
            mom = comm.psum(mom)
            sw.sp.stage(sw.stream, state=state, alphas=alphas, betas=betas,
                        coeffs=coeffs, j=s, m=m, tol=tol, partials=mom)
        else:
            # the twin takes j = s from the state's counter
            sweep_stage_ref(comm.psum(mom), state, alphas, betas, coeffs, m,
                            tol)
        Zn = plan.refresh(Zn)
        Z, Vc, Vp = Zn, Y, Vc
    m_used = state[_ST["m_used"]].to(torch.int32)
    return (alphas, betas, beta0, m_used, state[_ST["broke"]] != 0,
            None if W is None else plan.interior(W))


def lanczos_coeffs_fused_sharded(plan: FusedShardPlan, b_local, m: int, *,
                                 tol: float = 1e-7):
    """Sharded fused Lanczos pass 1, the distributed twin of
    ``lanczos_coeffs_fused``: (alphas, betas, beta0, m_used, broke), the
    same values on every rank. Per step one sweep, two stage launches, one
    psum of the two moments and one halo exchange."""
    return _lanczos_sharded(plan, b_local, m, tol)[:5]


def lanczos_replay_fused_sharded(plan: FusedShardPlan, b_local, coeffs, *,
                                 tol: float = 1e-7):
    """Sharded fused replay (pass 2): this rank's rows of w = sum_j
    coeffs[j] v_j, the basis regenerated by the same sweeps as pass 1
    (whose alphas and betas it recomputes bit for bit: module doc)."""
    return _lanczos_sharded(plan, b_local, 0, tol, coeffs)[5]

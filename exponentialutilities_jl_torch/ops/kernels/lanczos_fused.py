"""Fused recurrence sweeps for 2-D/3-D box stencils, constant
(``StencilOperator``) or variable-coefficient (``VariableStencilOperator``)
(PyTorch port of ``exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py``).

One sweep (``csrc/fused_sweep.cu``: kernel B3 for constant coefficients,
B3-var for per-cell fields) computes

    y  = ca Z + cb Vc + cc Vp,   Zn = A y,   moments (sum y^2, sum y.Zn)

and, in its accumulating form, W += cw Vc in place. The drivers below run
one sweep per step and serve both operator kinds:

* ``lanczos_coeffs_fused``: Lanczos pass 1. No normalization pass ever
  runs: the sweep stores the UNNORMALIZED y_j = beta_{j+1} v_{j+1} and its
  image A y_j, and the next sweep's scalars absorb the normalizations,
  ca = 1/beta_j, cb = -alpha_j/beta_j, cc = -beta_j/beta_{j-1}, with
  alpha_j = (y.Ay)/|y|^2 and beta_j = |y| read off the previous moments.
* ``lanczos_replay_fused``: pass 2, the same sweeps recomputing the same
  scalars from their own moments (bitwise-repeatable reductions make them
  equal to pass 1's) while accumulating w = sum_j c_j v_j.
* ``recurrence_apply_fused``: the generic (m, 4)-rows recurrence (the
  Chebyshev apply), no moment feedback.

The scalars are computed on the device from the previous sweep's moments,
so the m-step Python loops never synchronize with the host. Vectors are
flat (n,) tensors in the natural row-major grid layout; 2-D grids run as
nz = 1. On CPU tensors every sweep runs the plain twin
``fused_sweep_ref``; on CUDA tensors it launches B3 (or B3-var) or raises.
A variable operator's fields in another dtype than the vectors are cast
once and kept on the operator (``VariableStencilOperator.fields``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..stencil import StencilOperator, VariableStencilOperator, stencil_apply
from . import _build

__all__ = ["fused_supported", "fused_lanczos_step", "fused_sweep_ref",
           "lanczos_coeffs_fused", "lanczos_replay_fused",
           "recurrence_apply_fused", "stencil_matvec_fused", "MAX_HALO"]

MAX_HALO = 3            # largest |offset| per axis (shared-memory brick)


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


def _tiles(shape3):
    """(tz, ty, tx) block tile: 32 x 8 x 4 in 3-D, 32 x 32 for 2-D."""
    return (1, 32, 32) if shape3[0] == 1 else (4, 8, 32)


# ---------------------------------------------------------------- twin --

def fused_sweep_ref(Z, Vc, Vp, coefs, grid_shape, offsets, cvals,
                    w_accum=None):
    """Plain twin of B3 and B3-var: (Y, Zn, moments (2,)), with W += cw Vc
    done in place on ``w_accum`` when given. ``cvals`` is (k,) for a
    constant stencil or the (k, n) fields of a variable one."""
    if cvals.ndim == 2:
        cvals = cvals.reshape((-1,) + tuple(grid_shape))
    y = coefs[0] * Z + coefs[1] * Vc + coefs[2] * Vp
    zn = stencil_apply(y.reshape(grid_shape), offsets, cvals).reshape(-1)
    moments = torch.stack([(y * y).sum(), (y * zn).sum()])
    if w_accum is not None:
        w_accum.add_(coefs[3] * Vc)
    return y, zn, moments


# ------------------------------------------------------------- wrapper --

def _cvals(op, dtype):
    """The sweep's coefficients in ``dtype``: (k,) constants, or the
    (k, n) fields of a variable operator (cast once, kept on it)."""
    if isinstance(op, VariableStencilOperator):
        return op.fields(dtype)
    return op.coeffs.to(dtype).contiguous()


def fused_lanczos_step(Z, Vc, Vp, coefs, op, *, w_accum=None):
    """One fused sweep (module doc): kernel B3 (constant stencil) or B3-var
    (variable) on CUDA, their twin on CPU. ``coefs`` = (ca, cb, cc[, cw])
    as a tensor on the vectors' device. Returns (Y, Zn, ypy, yzy), plus W
    when ``w_accum`` is given (updated in place: W = w_accum + cw Vc)."""
    if not fused_supported(op, hermitian=False):
        raise ValueError("fused sweep requires a real 2-D/3-D Stencil or "
                         "VariableStencil operator with |offset| <= "
                         f"{MAX_HALO} (got {type(op).__name__})")
    n = op.shape[0]
    for v in (Z, Vc, Vp) + ((w_accum,) if w_accum is not None else ()):
        if v.shape != (n,) or v.dtype != Z.dtype or v.device != Z.device:
            raise ValueError("sweep vectors must be (n,) tensors of one "
                             "dtype on one device")
    ncoef = 4 if w_accum is not None else 3
    if coefs.shape[0] < ncoef:
        raise ValueError(f"sweep needs {ncoef} coefficients")
    dev = Z.device
    if dev.type == "cpu":
        Y, Zn, moments = fused_sweep_ref(Z, Vc, Vp, coefs, op.grid_shape,
                                         op.offsets, _cvals(op, Z.dtype),
                                         w_accum)
        return _step_result(Y, Zn, moments, w_accum)
    if dev.type != "cuda":
        raise ValueError(f"fused sweep: no kernel or twin for device {dev}")
    if Z.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"fused sweep takes float32/float64, got {Z.dtype}")
    if op.device != dev or coefs.device != dev:
        raise ValueError("operator, coefficients and vectors must share "
                         "one device")
    if not all(v.is_contiguous() for v in (Z, Vc, Vp, coefs)) or (
            w_accum is not None and not w_accum.is_contiguous()):
        raise ValueError("fused sweep takes contiguous tensors")
    shape3, offs3 = _geometry(op)
    tz, ty, tx = _tiles(shape3)
    nblocks = (math.ceil(shape3[2] / tx) * math.ceil(shape3[1] / ty)
               * math.ceil(shape3[0] / tz))
    coefs = coefs.to(Z.dtype)
    cvals = _cvals(op, Z.dtype)
    var = cvals.ndim == 2
    flat = np.asarray(offs3, dtype=np.int32).reshape(-1)
    offs_arg = (ctypes.c_int * len(flat))(*flat.tolist())
    Y = torch.empty_like(Z)
    Zn = torch.empty_like(Z)
    partials = torch.empty(2 * nblocks, dtype=Z.dtype, device=dev)
    moments = torch.empty(2, dtype=Z.dtype, device=dev)
    lib = _build.library()
    name = "fused_sweep_var" if var else "fused_sweep"
    fn = getattr(lib, f"eu_{name}_{_build.suffix(Z.dtype)}")
    code = fn(_build.ptr(Z), _build.ptr(Vc), _build.ptr(Vp),
              _build.ptr(coefs), _build.ptr(cvals), offs_arg, len(offs3),
              shape3[0], shape3[1], shape3[2], tz, ty, tx, _build.ptr(Y),
              _build.ptr(Zn), _build.ptr(w_accum), _build.ptr(partials),
              2 * nblocks, _build.ptr(moments), _build.stream_of(Z))
    _build.check(code, "fused sweep kernel (B3-var)" if var
                 else "fused sweep kernel (B3)")
    _build.launches[name] += 1
    return _step_result(Y, Zn, moments, w_accum)


def _step_result(Y, Zn, moments, w_accum):
    if w_accum is not None:
        return Y, Zn, moments[0], moments[1], w_accum
    return Y, Zn, moments[0], moments[1]


def _const(values, like):
    """A small coefficient vector on like's device, filled without a
    host-to-device copy."""
    out = torch.zeros(len(values), dtype=like.dtype, device=like.device)
    for i, v in enumerate(values):
        if v:
            out[i].fill_(v)     # a fill kernel; ``out[i] = v`` copies via host
    return out


def _lanczos_scalars(ypy, yzy, beta_prev, broke, tol):
    """(ca, cb, cc, alpha, beta, now_broke, live, safe_beta) of the next
    sweep from the previous sweep's moments, all on the device.

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


def _start(b):
    beta0 = torch.linalg.vector_norm(b)
    v0 = torch.where(beta0 > 0, b / torch.where(beta0 > 0, beta0, 1.0), 0.0)
    return beta0, v0


def lanczos_coeffs_fused(op, b, m: int, *, tol: float = 1e-7):
    """Drop-in twin of ``ops.krylov.lanczos_coeffs`` for symmetric 2-D/3-D
    box ``StencilOperator``s and Hermitian ``VariableStencilOperator``s:
    m + 1 fused sweeps."""
    if not fused_supported(op, hermitian=True):
        raise ValueError("lanczos_coeffs_fused requires a symmetric 2-D/3-D "
                         "Stencil or Hermitian VariableStencil operator")
    beta0, v0 = _start(b)
    zeros = torch.zeros_like(v0)
    # sweep 0: (1, 0, 0) emits y = v0, Z = A v0 and the first moments
    Y, Z, ypy, yzy = fused_lanczos_step(v0, zeros, zeros,
                                        _const((1.0, 0.0, 0.0), v0), op)
    Yprev = zeros
    beta_prev = torch.ones((), dtype=v0.dtype, device=v0.device)
    broke = beta0 == 0
    m_used = torch.zeros((), dtype=torch.int32, device=v0.device)
    alphas, betas = [], []
    for j in range(m):
        ca, cb, cc, alpha, beta, now_broke, live, _ = _lanczos_scalars(
            ypy, yzy, beta_prev, broke, tol)
        Yn, Zn, ypy_n, yzy_n = fused_lanczos_step(
            Z, Y, Yprev, torch.stack([ca, cb, cc]), op)
        m_used = torch.where(live, j + 1, m_used).to(torch.int32)
        alphas.append(torch.where(live, alpha, 0.0))
        # the beta reported at position j is the NEXT off-diagonal |y_{j+1}|
        beta_next = torch.sqrt(torch.clamp_min(ypy_n, 0.0))
        betas.append(torch.where(live, beta_next, 0.0))
        Yprev, Y, Z, ypy, yzy = Y, Yn, Zn, ypy_n, yzy_n
        beta_prev, broke = beta, broke | now_broke
    m_used = torch.where(beta0 == 0, 0, m_used).to(torch.int32)
    empty = torch.zeros(0, dtype=v0.dtype, device=v0.device)
    return (torch.stack(alphas) if m else empty,
            torch.stack(betas) if m else empty, beta0, m_used, broke)


def lanczos_replay_fused(op, b, coeffs, *, tol: float = 1e-7):
    """Replay twin: w = sum_j coeffs[j] v_j regenerating the basis with the
    same sweeps as ``lanczos_coeffs_fused`` (m + 1 accumulating sweeps)."""
    if not fused_supported(op, hermitian=True):
        raise ValueError("lanczos_replay_fused requires a symmetric 2-D/3-D "
                         "Stencil or Hermitian VariableStencil operator")
    beta0, v0 = _start(b)
    coeffs = coeffs.to(v0.dtype)
    W = torch.zeros_like(v0)
    # sweep 0: y = v0 (ca = 1 on Z = v0); nothing to accumulate yet
    Y, Z, ypy, yzy, W = fused_lanczos_step(
        v0, v0, torch.zeros_like(v0), _const((1.0, 0.0, 0.0, 0.0), v0), op,
        w_accum=W)
    Yprev = torch.zeros_like(v0)
    beta_prev = torch.ones((), dtype=v0.dtype, device=v0.device)
    broke = beta0 == 0
    for j in range(coeffs.shape[0]):
        # sweep j+1 accumulates c_j v_j from its Vc input (Vc = y_j with
        # |y_j| = beta, so Vc / beta = v_j) while producing y_{j+1}
        ca, cb, cc, alpha, beta, now_broke, live, safe_beta = \
            _lanczos_scalars(ypy, yzy, beta_prev, broke, tol)
        cw = torch.where(live, coeffs[j] / safe_beta, 0.0)
        Yn, Zn, ypy, yzy, W = fused_lanczos_step(
            Z, Y, Yprev, torch.stack([ca, cb, cc, cw]), op, w_accum=W)
        Yprev, Y, Z = Y, Yn, Zn
        beta_prev, broke = beta, broke | now_broke
    return W


def stencil_matvec_fused(op, x):
    """``A @ x`` through one (1, 0, 0) fused sweep (Zn = A x)."""
    zeros = torch.zeros_like(x)
    return fused_lanczos_step(x, zeros, zeros, _const((1.0, 0.0, 0.0), x),
                              op)[1]


def recurrence_apply_fused(op, b, rows):
    """The generic (m, 4)-rows recurrence, one accumulating sweep per step:

        omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
        w          += cw_k omega_k,          k = 0..m-1,  omega_0 = b.

    ``rows`` is a (m, 4) tensor on b's device (the Chebyshev rows of
    ``ops.kernels.dispatch.chebyshev_rows``)."""
    rows = torch.as_tensor(rows, dtype=b.dtype, device=b.device).contiguous()
    zeros = torch.zeros_like(b)
    W = torch.zeros_like(b)
    # sweep 0 emits omega_0 = b and Z = A omega_0 (no accumulation yet)
    Y, Z, _, _, W = fused_lanczos_step(b, b, zeros,
                                       _const((1.0, 0.0, 0.0, 0.0), b), op,
                                       w_accum=W)
    Yprev = zeros
    for k in range(rows.shape[0]):
        # sweep k+1 accumulates cw_k omega_k from its Vc input while
        # emitting omega_{k+1}
        Yn, Zn, _, _, W = fused_lanczos_step(Z, Y, Yprev, rows[k], op,
                                             w_accum=W)
        Yprev, Y, Z = Y, Yn, Zn
    return W

"""Row-partitioned Krylov and Chebyshev actions over a mesh (PyTorch port of
``exponentialutilities_jl_tpu/parallel/krylov.py``).

Every rank runs the same program on its rows (``parallel/mesh.py``): the
basis lives row-sharded ((m+1, n_local) per rank), the stencil or banded
matvec exchanges halos with the ring neighbours (``parallel/ops.py``,
``parallel/stencil.py``), each orthogonalization pass costs one ``psum``
(the ``comm`` path of ``ops/krylov.py``), and the m x m reduced problem is
computed on every rank from the reduced scalars. Results are this rank's
rows; ``parallel.gather_vector`` assembles the whole vector.

The two-pass Lanczos, the Chebyshev action and (``parallel/poly.py``) the
Leja and Faber actions on a real 2-D/3-D box ``StencilOperator`` run
shard-local fused sweeps (``parallel/stencil_fused.py``: B3, B3-var) by
default on CUDA tensors; on CPU tensors only with ``fused=True`` (the
plain twins then run the real sharded code path); ``fused=False`` forces
the plain torch recurrence on the local operator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.expv import (_expv_two_pass, _lanczos_reduced_coeffs,
                           build_subspace, expv_from_basis)
from ..models.phiv import phiv_from_basis
from ..ops.kernels.dispatch import chebyshev_rows, grad_requested
from ..ops.kernels.lanczos_fused import fused_supported
from ..ops.sparse import BandedOperator
from ..ops.stencil import StencilOperator, VariableStencilOperator
from .mesh import Mesh
from .ops import local_rows, shard_banded
from .stencil import shard_stencil

__all__ = ["expv_sharded", "phiv_sharded", "make_expv_step",
           "expv_chebyshev_sharded"]


def _shard_op(op, mesh: Mesh, axis_name):
    """(params, make_local) of a shardable operator."""
    if isinstance(op, BandedOperator):
        return shard_banded(op, mesh, axis_name)
    if isinstance(op, StencilOperator):
        return shard_stencil(op, mesh, axis_name)
    raise TypeError(
        f"no sharding rule for operator type {type(op).__name__}; use a "
        "BandedOperator or StencilOperator (or the GSPMD route, "
        "parallel.shard_operator, and the ordinary drivers)")


def _local(op, mesh, axis_name, b):
    """(local operator, this rank's rows of b)."""
    params, make_local = _shard_op(op, mesh, axis_name)
    return make_local(params), local_rows(b, mesh.axis(axis_name),
                                          op.shape[0])


def _fused_shard_ok(op, mesh, axis_name, b, *, hermitian: bool,
                    fused=None):
    """The shard-local fused plan when it applies, else None: a real
    2-D/3-D constant box stencil within the kernel's reach, real
    float32/float64 data, axis 0 divisible over the ranks with the halo
    within a slab. AUTO (``fused=None``) engages on CUDA tensors only;
    ``fused=True`` also on the CPU, where the plain twin sweeps run the
    real sharded code path (as JAX's interpret mode does)."""
    from .stencil_fused import fused_shard_plan

    dev = mesh.axis(axis_name).device
    bt = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
    if bt.dtype not in (torch.float32, torch.float64):
        return None
    if fused is None and (dev.type != "cuda" or grad_requested(op, bt)):
        return None
    if not (isinstance(op, StencilOperator)
            and fused_supported(op, hermitian=hermitian)):
        return None
    try:
        return fused_shard_plan(op, mesh, axis_name, hermitian=hermitian)
    except ValueError:
        return None


def expv_sharded(t, op, b, mesh: Mesh, *, m: int = 30, tol: float = 1e-7,
                 iop: int = 0, reorth: bool = True,
                 hermitian: bool | None = None,
                 axis_name: str | None = None, two_pass: bool = False,
                 fused: bool | None = None):
    """exp(tA) b with A row-partitioned over ``mesh``: this rank's rows.

    ``b`` is the global vector or this rank's rows. ``two_pass=True``: the
    storage-free Lanczos (Hermitian only), O(n_local) memory per rank; on
    a 2-D/3-D box stencil both passes run the shard-local fused sweeps
    (module doc; complex t keeps the plain two-pass, whose replay
    coefficients are complex)."""
    axis = mesh.axis(axis_name)
    herm = op.is_hermitian if hermitian is None else hermitian
    if two_pass and not herm:
        raise NotImplementedError("two_pass requires a Hermitian operator")
    if fused and not two_pass:
        raise ValueError(
            "fused=True applies to the two-pass Lanczos body "
            "(two_pass=True): the basis-building expv has no fused form; "
            "for single-pass fused actions use expv_chebyshev_sharded")
    plan = None
    if two_pass and fused is not False:
        complex_t = bool(torch.as_tensor(t).is_complex())
        if not complex_t:
            plan = _fused_shard_ok(op, mesh, axis_name, b, hermitian=True,
                                   fused=fused)
        if plan is None and fused:
            reason = ("complex t (the sweep replay is real)" if complex_t
                      else f"operator {type(op).__name__}")
            raise ValueError("fused=True: no shard-local fused sweep for "
                             f"{reason}")
    if plan is not None:
        return _expv_two_pass_fused_sharded(
            plan, local_rows(b, axis, op.shape[0]), t, m, tol=tol)
    lop, b_local = _local(op, mesh, axis_name, b)
    if two_pass:
        return _expv_two_pass(lop, b_local, t, m)
    Ks = build_subspace(lop, b_local, m, tol=tol, iop=iop, reorth=reorth,
                        hermitian=herm)
    return expv_from_basis(t, Ks)


def _expv_two_pass_fused_sharded(plan, b_local, t, m: int,
                                 tol: float = 1e-7):
    """Storage-free sharded Hermitian expv with both passes as shard-local
    fused sweeps; the reduced tridiagonal exponential on every rank from
    the psum'd (alpha, beta)."""
    from .stencil_fused import (lanczos_coeffs_fused_sharded,
                                lanczos_replay_fused_sharded)

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_fused_sharded(
        plan, b_local, m, tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t)
    out = lanczos_replay_fused_sharded(plan, b_local, coeffs, tol=tol)
    return torch.where(beta0 > 0, out, 0.0)


def phiv_sharded(t, op, b, k: int, mesh: Mesh, *, m: int = 30,
                 tol: float = 1e-7, iop: int = 0, correct: bool = False,
                 reorth: bool = True, hermitian: bool | None = None,
                 axis_name: str | None = None):
    """Row-partitioned [phi_0(tA)b ... phi_k(tA)b]: (this rank's (n_local,
    k+1) rows, the error estimate, the same on every rank)."""
    herm = op.is_hermitian if hermitian is None else hermitian
    lop, b_local = _local(op, mesh, axis_name, b)
    Ks = build_subspace(lop, b_local, m, tol=tol, iop=iop, reorth=reorth,
                        hermitian=herm)
    return phiv_from_basis(t, Ks, k, correct=correct)


def expv_chebyshev_sharded(t, op, b, mesh: Mesh, *, bounds=None,
                           tol: float = 1e-7, m: int | None = None,
                           axis_name: str | None = None,
                           fused: bool | None = None):
    """Row-partitioned Chebyshev exp(tA) b (``models/chebyshev.py``): the
    recurrence has no inner products, so its only collective is the
    operator's halo exchange, one per matvec (per sweep on the fused
    path), and no all_reduce.

    ``bounds`` defaults to the global operator's Gershgorin hint.
    Hermitian only; ``b`` global or this rank's rows. A
    ``VariableStencilOperator`` shards through the fused sweep only
    (B3-var, float32 or float64: the JAX package's float32 gate was a TPU
    workaround)."""
    from ..models.chebyshev import _chebyshev_apply_scan, _full_exp_coeffs

    if not op.is_hermitian:
        raise ValueError("expv_chebyshev_sharded requires a Hermitian "
                         "operator")
    axis = mesh.axis(axis_name)
    if bounds is None:
        hint = getattr(op, "spectral_bounds_hint", None)
        bounds = hint() if callable(hint) else None
        if bounds is None:
            raise ValueError(
                "no spectral_bounds_hint on this operator: pass bounds=(lo, "
                "hi) explicitly (e.g. from models.chebyshev.spectral_bounds "
                "on the global operator)")
    lo, hi = float(bounds[0]), float(bounds[1])
    if hi - lo <= 0:
        raise ValueError(f"empty spectral interval {bounds}")
    full, c, h = _full_exp_coeffs(t, lo, hi, tol, m)
    b_local = local_rows(b, axis, op.shape[0])
    cdt = (torch.promote_types(b_local.dtype, torch.complex64)
           if np.iscomplexobj(full) else b_local.dtype)
    coeffs = torch.as_tensor(full).to(dtype=cdt, device=b_local.device)

    if isinstance(op, VariableStencilOperator):
        from .stencil_fused import (fused_shard_plan,
                                    recurrence_apply_fused_sharded_var)
        if (fused is False or np.iscomplexobj(full)
                or b_local.dtype not in (torch.float32, torch.float64)):
            raise TypeError(
                "expv_chebyshev_sharded: a VariableStencilOperator shards "
                "through the fused sweep only (fused must not be False, "
                "real coefficients, float32/float64 data)")
        if b_local.device.type != "cuda" and not fused:
            raise TypeError(
                "expv_chebyshev_sharded: variable fused sharding runs B3-var "
                "on CUDA tensors (pass fused=True to run its plain twin on "
                "the CPU, e.g. in tests)")
        plan = fused_shard_plan(op, mesh, axis_name, hermitian=True)
        rows = chebyshev_rows(coeffs, c, h, b_local.dtype)
        return recurrence_apply_fused_sharded_var(
            plan, plan.local_fields(op), b_local, rows)

    plan = None
    if fused is not False and not np.iscomplexobj(full):
        plan = _fused_shard_ok(op, mesh, axis_name, b_local, hermitian=True,
                               fused=fused)
    if plan is None and fused:
        raise ValueError("fused=True: no shard-local fused sweep for this "
                         f"operator ({type(op).__name__})")
    if plan is not None:
        from .stencil_fused import recurrence_apply_fused_sharded
        return recurrence_apply_fused_sharded(
            plan, b_local, chebyshev_rows(coeffs, c, h, b_local.dtype))
    params, make_local = _shard_op(op, mesh, axis_name)
    return _chebyshev_apply_scan(make_local(params), b_local, coeffs, c,
                                 1.0 / h)


def make_expv_step(op, mesh: Mesh, *, m: int = 30, tol: float = 1e-7,
                   hermitian: bool | None = None,
                   axis_name: str | None = None):
    """Serving factory: ``(step, params)`` with ``step(t, params, b_local)``
    the sharded expv (this rank's rows) and ``params`` this rank's operator
    data (diagonal columns or stencil coefficients), split once."""
    herm = op.is_hermitian if hermitian is None else hermitian
    params, make_local = _shard_op(op, mesh, axis_name)
    axis = mesh.axis(axis_name)
    n = op.shape[0]

    def step(t, params_, b):
        lop = make_local(params_)
        Ks = build_subspace(lop, local_rows(b, axis, n), m, tol=tol,
                            hermitian=herm)
        return expv_from_basis(t, Ks)

    return step, params

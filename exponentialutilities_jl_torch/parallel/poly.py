"""Sharded non-Hermitian polynomial actions: Leja and Faber over a mesh
(PyTorch port of ``exponentialutilities_jl_tpu/parallel/poly.py``).

A Leja or Faber step is one matvec plus axpys with host scalars, so the
only collective inside the loop is the operator's halo exchange: zero
all_reduces, the census of ``expv_chebyshev_sharded`` without its
Hermitian restriction. The host setup (interval or field-of-values
ellipse, divided differences or Faber coefficients, substep counts) is
the single-device drivers' own (``models/leja._leja_expv_setup``,
``models/faber._faber_expv_setup``) on the global operator: the same
numbers, the same truncation raises. Faber's failure protocol reads the
global norms of b and of the result after the loop, with one ``psum``.

On a real 2-D/3-D box ``StencilOperator`` the Newton and Faber rows run
the shard-local fused sweeps (``parallel/stencil_fused.py``) under the
rule of ``parallel/krylov.py``: by default on CUDA tensors, on the CPU
with ``fused=True``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.faber import (_CROUZEIX, _check_finite_faber, _faber_apply,
                            _faber_expv_setup, _faber_rows)
from ..models.leja import _host_to, _leja_apply, _leja_expv_setup, _newton_rows
from ..utils.linop import LinearOperator, aslinearoperator
from .krylov import _fused_shard_ok, _local
from .mesh import Mesh
from .ops import local_rows

__all__ = ["expv_leja_sharded", "expv_faber_sharded"]


def _fused_plan(op, mesh, axis_name, b, fused):
    plan = _fused_shard_ok(op, mesh, axis_name, b, hermitian=False,
                           fused=fused)
    if plan is None and fused:
        raise ValueError("fused=True: no shard-local fused sweep for this "
                         f"operator ({type(op).__name__}) and data")
    return plan


def _substeps(plan, b_local, rows, q: int):
    from .stencil_fused import recurrence_apply_fused_sharded

    w = b_local
    for _ in range(q):
        w = recurrence_apply_fused_sharded(plan, w, rows)
    return w


def expv_leja_sharded(t, op, b, mesh: Mesh, *, interval=None,
                      tol: float = 1e-7, m: int | None = None,
                      max_z: float = 40.0, axis_name: str | None = None,
                      fused: bool | None = None):
    """Row-partitioned Leja-Newton exp(tA) b (``models/leja.py``) for
    non-Hermitian operators: coefficients on the host from the global
    operator, the apply loop on this rank's rows with one halo exchange
    per matvec and no all_reduce. ``b`` global or this rank's rows; the
    result is this rank's rows."""
    if not isinstance(op, LinearOperator):
        op = aslinearoperator(op)
    axis = mesh.axis(axis_name)
    b_local = local_rows(b, axis, op.shape[0])
    d, xi, c, s, q = _leja_expv_setup(op, t, interval, tol, m, max_z)
    if d is None:                       # A ~ cI
        return math.exp(float(t) * c) * b_local
    if not np.iscomplexobj(d):
        plan = _fused_plan(op, mesh, axis_name, b_local, fused)
        if plan is not None:
            rows = _host_to(_newton_rows(d, xi, c, 1.0 / s), b_local)
            return _substeps(plan, b_local, rows, q)
    elif fused:
        raise ValueError("fused=True: complex Leja coefficients take no "
                         "sweep")
    lop, b_local = _local(op, mesh, axis_name, b_local)
    return _leja_apply(lop, b_local, _host_to(d, b_local, real=False),
                       _host_to(xi, b_local), c, 1.0 / s, q)


def expv_faber_sharded(t, op, b, mesh: Mesh, *, ellipse=None,
                       tol: float = 1e-7, m: int | None = None,
                       max_z: float = 512.0, axis_name: str | None = None,
                       fused: bool | None = None):
    """Row-partitioned Faber-series exp(tA) b (``models/faber.py``) with
    halo-only communication in the loop and the single-device failure
    protocol: the truncation raises on non-convergence, and the result is
    held finite and within the Crouzeix numerical-range bound of the
    ellipse (global norms: one psum after the loop)."""
    if not isinstance(op, LinearOperator):
        op = aslinearoperator(op)
    axis = mesh.axis(axis_name)
    b_local = local_rows(b, axis, op.shape[0])
    a, c, gamma, rho, q, m_used, log_sup = _faber_expv_setup(
        op, t, ellipse, tol, m, max_z, complex_b=b_local.is_complex())
    if a is None:                       # A ~ cI
        return math.exp(float(t) * c) * b_local
    a = a[:m_used]
    plan = None
    if not np.iscomplexobj(a):
        plan = _fused_plan(op, mesh, axis_name, b_local, fused)
    elif fused:
        raise ValueError("fused=True: complex Faber coefficients take no "
                         "sweep")
    if plan is not None:
        out = _substeps(plan, b_local,
                        _host_to(_faber_rows(a, c, 1.0 / gamma, rho),
                                 b_local), q)
    else:
        lop, b_local = _local(op, mesh, axis_name, b_local)
        out = _faber_apply(lop, b_local, _host_to(a, b_local, real=False),
                           c, 1.0 / gamma, rho, q)
        if not b_local.is_complex() and out.is_complex():
            out = out.real
    rdt = out.real.dtype
    sums = axis.psum(torch.stack([
        (~torch.isfinite(out)).sum().to(rdt),
        (out.conj() * out).real.sum().to(rdt),
        (b_local.conj() * b_local).real.sum().to(rdt)])).tolist()
    read = (sums[0] == 0, math.sqrt(sums[1]), [math.sqrt(sums[2])])
    return _check_finite_faber(out, "expv_faber_sharded",
                               q * (np.log(_CROUZEIX) + log_sup),
                               read[2][0], read=read)

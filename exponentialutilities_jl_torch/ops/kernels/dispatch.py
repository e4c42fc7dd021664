"""Engine selection for the generic three-term recurrence

    omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
    w          += cw_k omega_k

shared by the polynomial actions (PyTorch port of
``exponentialutilities_jl_tpu/ops/kernels/dispatch.py``). Four
hand-written CUDA engines implement the same (m, 4)-rows contract, tried
in the JAX package's order:

  * ``resident`` - 1-D constant stencils, the whole recurrence in one
                   persistent launch (ops/kernels/resident.py, B1)
  * ``banded``   - ``BandedOperator``s, one persistent launch (B5)
  * ``grid``     - 2-D/3-D constant stencils whose state fits the L2
                   budget, one persistent launch (B6: tiles of the grid
                   kept on chip where they fit, else the family kernel)
  * ``fused``    - 2-D/3-D box stencils, one sweep per step
                   (ops/kernels/lanczos_fused.recurrence_apply_fused): B3
                   for constant, B3-var for variable coefficients

``recurrence_engine`` picks the first that applies to a real float32 or
float64 recurrence on a CUDA device, or returns None for the caller's
plain torch path (which is what CPU tensors take). A
``VariableStencilOperator`` is turned away by B1, B5 and B6 (they have no
fields) and taken by the fused sweeps. ``resident_multi_ok`` is the gate
of B4, the multi-column (m, p) form of the 1-D recurrence.

The grad rule. The recurrence engines write their results through raw
pointers and have no reverse (or forward) rule. So every gate, these two
and the two-pass choices of ``models/expv.py`` and ``models/phiv.py``,
returns the plain torch path when ``grad_requested``: grad mode is on and
t, b, the rows or the operator's own tensors require grad, or one of them
is wrapped by a ``torch.func`` transform or carries a forward-mode
tangent. This is a dispatch rule that the
caller's request triggers, like the complex-t rule, not a fallback on
failure: the plain path computes the same function, and autograd
differentiates it. ``grad_gated`` counts the calls it sent there (calls
that would otherwise have taken a kernel); ``fused=True`` under it raises.
The engines' own entry points refuse such inputs (``refuse_grad``), so no
kernel path returns a result without a graph.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from ._build import KERNEL_DTYPES

__all__ = ["recurrence_engine", "chebyshev_rows", "kernel_device_ok",
           "resident_multi_ok", "grad_requested", "grad_gate",
           "refuse_grad", "grad_gated", "MAX_COLS"]

MAX_COLS = 8            # B4 accumulator columns, as the JAX gate allows

# calls that the grad rule sent to the plain path instead of a kernel
grad_gated = {"calls": 0}


def _operator_tensors(op):
    return [v for v in getattr(op, "__dict__", {}).values()
            if isinstance(v, torch.Tensor)]


def grad_requested(op, *operands) -> bool:
    """The grad rule (module doc): grad mode is on and one of ``operands``
    (t, b, rows; non-tensors skipped) or of the operator's own tensors
    requires grad, or one is wrapped by a ``torch.func`` transform or
    carries a forward-mode tangent."""
    ts = [t for t in operands if isinstance(t, torch.Tensor)]
    ts += _operator_tensors(op)
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t)
           or fwAD.unpack_dual(t).tangent is not None for t in ts):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def refuse_grad(what: str, op, *operands):
    """Raise when a recurrence kernel's entry point gets inputs that
    ``grad_requested``: its raw-pointer result would drop the graph."""
    if grad_requested(op, *operands):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has no autograd rule; with inputs "
            "that require grad call the action (expv, phiv, "
            "chebyshev_apply, ...), whose gate takes the plain torch path")


def grad_gate(op, operands) -> bool:
    """The grad rule for a call that would take a kernel: True, and counted
    in ``grad_gated``, when ``grad_requested``."""
    if grad_requested(op, *operands):
        grad_gated["calls"] += 1
        return True
    return False


def chebyshev_rows(coeffs, center, halfwidth, dt):
    """(m, 4) recurrence rows of the Chebyshev-U recurrence on the interval
    center +- halfwidth with accumulation coefficients ``coeffs`` (a
    tensor; the rows are built on its device)."""
    m = coeffs.shape[0]
    kw = dict(dtype=dt, device=coeffs.device)
    ca = torch.full((m,), 2.0 / halfwidth, **kw)
    cb = torch.full((m,), -2.0 * center / halfwidth, **kw)
    cc = torch.full((m,), -1.0, **kw)
    return torch.stack([ca, cb, cc, coeffs.to(dt)], dim=1)


def kernel_device_ok(dtype, device) -> bool:
    """The kernels run real float32/float64 data on a CUDA device."""
    return torch.device(device).type == "cuda" and dtype in KERNEL_DTYPES


def resident_multi_ok(op, dtype, device, p: int, operands=()) -> bool:
    """Gate of B4 (``recurrence_apply_resident_multi``): a 1-D real
    constant stencil, real float32/float64 data on a CUDA device,
    1 <= p <= MAX_COLS accumulators, and the (p + 3) state vectors within
    ``resident.L2_STATE_BUDGET`` (the multi-column memory budget that the
    JAX package's two-pass phiv gate leaves out). Which of B4's two forms
    a launch takes (blocks that sync with their neighbours only, where a
    block's state fits on chip and max|o| is within its rows; else the
    family kernel) is the operator's ``resident.MultiPlan``'s choice.
    ``operands`` (b, t, the coefficients): the grad rule (module doc)."""
    from .resident import L2_STATE_BUDGET, resident_supported

    if not (kernel_device_ok(dtype, device) and resident_supported(op)):
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    ok = (1 <= p <= MAX_COLS
          and (p + 3) * op.shape[0] * itemsize <= L2_STATE_BUDGET)
    return ok and not grad_gate(op, operands)


def recurrence_engine(op, dtype, fused=None, *, device,
                      hermitian: bool = False, operands=()):
    """An ``apply(op, b, rows) -> w`` callable for the CUDA recurrence
    engine that applies, or None for the plain torch path.

    ``fused=False`` forces None. ``fused=None`` picks an engine only for
    real float32/float64 data on a CUDA device and a call that the grad
    rule (module doc; ``operands`` are the call's b, t and rows) lets
    through. ``fused=True`` demands an engine and raises ValueError when
    the operator, dtype or device has none, or the grad rule applies
    (instead of failing later inside a launch)."""
    if fused is False:
        return None
    from .lanczos_fused import fused_supported, recurrence_apply_fused
    from .resident import (recurrence_apply_resident,
                           recurrence_apply_resident_banded,
                           recurrence_apply_resident_grid,
                           resident_banded_supported, resident_grid_supported,
                           resident_supported)

    if resident_supported(op):
        engine = recurrence_apply_resident
    elif resident_banded_supported(op):
        engine = recurrence_apply_resident_banded
    elif resident_grid_supported(op, dtype):
        engine = recurrence_apply_resident_grid
    elif fused_supported(op, hermitian=hermitian):
        engine = recurrence_apply_fused
    else:
        engine = None
    device_ok = kernel_device_ok(dtype, device)
    if fused:
        if engine is None:
            raise ValueError(
                "fused=True: no CUDA recurrence engine for this operator "
                "(needs a real BandedOperator, a real 1-D or 2-D/3-D box "
                "constant StencilOperator, or a real 2-D/3-D "
                "VariableStencilOperator)")
        if not device_ok:
            raise ValueError(
                f"fused=True: the CUDA engines take float32/float64 data on "
                f"a CUDA device, got {dtype} on {torch.device(device)}")
        if grad_requested(op, *operands):
            raise ValueError(
                "fused=True: the CUDA engines have no autograd rule, and "
                "this call requires grad (or runs under a torch.func "
                "transform)")
    if engine is None or not device_ok or grad_gate(op, operands):
        return None
    return engine

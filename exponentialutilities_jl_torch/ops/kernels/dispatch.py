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
"""

from __future__ import annotations

import torch

from ._build import KERNEL_DTYPES

__all__ = ["recurrence_engine", "chebyshev_rows", "kernel_device_ok",
           "resident_multi_ok", "MAX_COLS"]

MAX_COLS = 8            # B4 accumulator columns, as the JAX gate allows


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


def resident_multi_ok(op, dtype, device, p: int) -> bool:
    """Gate of B4 (``recurrence_apply_resident_multi``): a 1-D real
    constant stencil, real float32/float64 data on a CUDA device,
    1 <= p <= MAX_COLS accumulators, and the (p + 3) state vectors within
    ``resident.L2_STATE_BUDGET`` (the multi-column memory budget that the
    JAX package's two-pass phiv gate leaves out). Which of B4's two forms
    a launch takes (blocks that sync with their neighbours only, where a
    block's state fits on chip and max|o| is within its rows; else the
    family kernel) is the operator's ``resident.MultiPlan``'s choice."""
    from .resident import L2_STATE_BUDGET, resident_supported

    if not (kernel_device_ok(dtype, device) and resident_supported(op)):
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (1 <= p <= MAX_COLS
            and (p + 3) * op.shape[0] * itemsize <= L2_STATE_BUDGET)


def recurrence_engine(op, dtype, fused=None, *, device,
                      hermitian: bool = False):
    """An ``apply(op, b, rows) -> w`` callable for the CUDA recurrence
    engine that applies, or None for the plain torch path.

    ``fused=False`` forces None. ``fused=None`` picks an engine only for
    real float32/float64 data on a CUDA device. ``fused=True`` demands an
    engine and raises ValueError when the operator, dtype or device has
    none (instead of failing later inside a launch)."""
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
    return engine if device_ok else None

"""Diagonal-storage operator (PyTorch port of ``BandedOperator`` in
``exponentialutilities_jl_tpu/ops/sparse.py``).

Only ``BandedOperator`` is ported so far: the stencil operators convert to
it (``StencilOperator.to_banded``) and the standard test matrices
(``utils/testmatrices.py``) are built in it. Its matvec is plain torch;
the hand-written banded SpMV kernel (B7 in ROADMAP.md) comes later.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.linop import LinearOperator

__all__ = ["BandedOperator"]


class BandedOperator(LinearOperator):
    """A[i, i+o] = diags[k][i] for each offset o = offsets[k].

    diags: (len(offsets), n); diags[k, i] is zero where i+offsets[k] falls
    outside [0, n).
    """

    def __init__(self, diags, offsets, is_hermitian: bool = False):
        self.diags = (diags if isinstance(diags, torch.Tensor)
                      else torch.as_tensor(np.asarray(diags)))
        self.offsets = tuple(int(o) for o in offsets)
        self.is_hermitian = bool(is_hermitian)
        if self.diags.shape[0] != len(self.offsets):
            raise ValueError("diags rows must match number of offsets")

    @property
    def shape(self):
        n = self.diags.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def nnz(self) -> int:
        return int(self.diags.numel())

    def matvec(self, x):
        n = x.shape[0]
        h = max((abs(o) for o in self.offsets), default=0)
        rt = torch.promote_types(self.dtype, x.dtype)
        # zero padding makes every shifted read a slice and handles the
        # boundary rows exactly (out-of-range reads see the pad zeros)
        xe = F.pad(x.to(rt), (h, h))
        D = self.diags.to(rt)
        y = torch.zeros(n, dtype=rt, device=x.device)
        for k, o in enumerate(self.offsets):
            y = y + D[k] * xe[h + o:h + o + n]
        return y

    def opnorm_hint(self):
        return self.diags.abs().sum(dim=0).max()

    def _gershgorin_real(self):
        """Per-row Gershgorin enclosure of the spectrum's real parts,
        computed where the diagonals live; returns host floats (one sync,
        two numbers copied)."""
        D = self.diags.detach()
        n = self.shape[0]
        i = torch.arange(n, device=D.device)
        d = torch.zeros(n, dtype=D.dtype, device=D.device)
        r = torch.zeros(n, dtype=torch.float64, device=D.device)
        for k, o in enumerate(self.offsets):
            row = torch.where((i + o >= 0) & (i + o < n), D[k], 0)
            if o == 0:
                d = d + row
            else:
                r = r + row.abs()
        lo, hi = torch.stack([(d.real - r).min(), (d.real + r).max()]).tolist()
        return lo, hi

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure for the Chebyshev actions;
        Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_dense(self):
        n = self.shape[0]
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for k, o in enumerate(self.offsets):
            i = torch.arange(max(0, -o), min(n, n - o), device=self.device)
            A[i, i + o] = self.diags[k, i]
        return A

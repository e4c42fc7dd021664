"""Grid stencil operators (PyTorch port of
``exponentialutilities_jl_tpu/ops/stencil.py``).

``StencilOperator`` stores only the k scalar coefficients of a constant
stencil, and its matvec applies shifts on the d-D grid:

    y = sum_k c_k * shift(x, offset_k)      (Dirichlet: outside reads 0)

``VariableStencilOperator`` keeps the same fixed stencil pattern with a
per-cell coefficient field per point (the div(a grad u) class), (k, n)
storage organized on the grid, and the same matvec with each c_k a field.

The flat vector interface is kept (matvec takes and returns (n,)), so the
operators drop into every Krylov API. The hand-written CUDA kernels of
``ops/kernels/`` run the same stencils inside the whole recurrence (1-D
constant: ``resident.py``; 2-D/3-D, constant and variable:
``lanczos_fused.py``); the plain torch matvec here is what every other
caller uses. Host data given to a constructor goes to the default device
(``utils/device.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import host_tensor, resolve_device
from ..utils.linop import LinearOperator
from .sparse import BandedOperator, _promoted

__all__ = ["StencilOperator", "VariableStencilOperator",
           "laplacian_nd_stencil", "variable_diffusion_nd_stencil",
           "advection_diffusion_3d_stencil", "advection_diffusion_1d_stencil",
           "stencil_apply"]


def stencil_apply(X, offsets, cvals):
    """sum_k cvals[k] * shift(X, offsets[k]) on the grid tensor X, with
    zero (Dirichlet) values outside the grid: each shift is a slice of the
    zero-padded grid. X is a grid or a stack of grids (its last d axes the
    grid, d the offsets' length). ``cvals[k]`` is a scalar, or a field of
    the grid's shape read at the output cell. The plain form of every
    stencil kernel's matvec."""
    d = len(offsets[0])
    shape = X.shape[X.ndim - d:]
    h = [max(abs(off[a]) for off in offsets) for a in range(d)]
    pad = []
    for a in reversed(range(d)):
        pad += [h[a], h[a]]
    Xp = F.pad(X, pad)
    y = None
    for k, off in enumerate(offsets):
        sl = (...,) + tuple(slice(h[a] + off[a], h[a] + off[a] + shape[a])
                            for a in range(d))
        term = cvals[k] * Xp[sl]
        y = term if y is None else y + term
    return y


class StencilOperator(LinearOperator):
    """Constant-coefficient stencil on a d-dimensional grid.

    grid_shape: (s_0, ..., s_{d-1}); the flat index is row-major (last
      axis fastest, matching ``utils.testmatrices`` with x fastest).
    offsets: one d-tuple per stencil point.
    coeffs: (k,) coefficients in offset order (tensor, array or list).
    Boundary: Dirichlet truncation (out-of-grid neighbours read zero).

    A host copy of the coefficients is kept so that the Gershgorin hint
    and the kernels' static checks never read the device.
    """

    def __init__(self, grid_shape, offsets, coeffs, is_hermitian=False, *,
                 dtype=None, device=None):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        host = not isinstance(coeffs, torch.Tensor)
        c = torch.as_tensor(np.array(coeffs)) if host else coeffs
        c = c.to(dtype=dtype or c.dtype)
        self.host_coeffs = c.detach().cpu().numpy()
        self.coeffs = c.to(device=resolve_device(device) if host else device)
        self.is_hermitian = bool(is_hermitian)
        d = len(self.grid_shape)
        if any(len(off) != d for off in self.offsets):
            raise ValueError("each offset must have one entry per grid axis")
        if len(self.host_coeffs) != len(self.offsets):
            raise ValueError("one coefficient per offset is required")

    @property
    def shape(self):
        n = math.prod(self.grid_shape)
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @property
    def nnz(self) -> int:
        return len(self.offsets) * math.prod(self.grid_shape)

    def matvec(self, x):
        rt = torch.promote_types(self.dtype, x.dtype)
        X = x.reshape(self.grid_shape).to(rt)
        return stencil_apply(X, self.offsets, self.coeffs.to(rt)).reshape(-1)

    def matmat(self, X):
        """Each row of X (batch, n): the plain stencil on the stack of
        grids, one pass for the whole block."""
        rt = torch.promote_types(self.dtype, X.dtype)
        G = X.reshape(X.shape[:1] + self.grid_shape).to(rt)
        return stencil_apply(G, self.offsets,
                             self.coeffs.to(rt)).reshape(X.shape[0], -1)

    def opnorm_hint(self):
        return self.coeffs.abs().sum()

    def _gershgorin_real(self):
        """[c0 - r, c0 + r]: the diagonal is the zero-offset coefficient in
        every row and every row's off-diagonal 1-norm is <= sum |c_k|."""
        diag = 0.0
        r = 0.0
        for c, off in zip(self.host_coeffs, self.offsets):
            if all(o == 0 for o in off):
                diag += float(np.real(c))
            else:
                r += float(abs(c))
        return (diag - r, diag + r)

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure for the Chebyshev actions;
        Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_banded(self) -> BandedOperator:
        """Equivalent diagonal-storage operator (for oracles/conversion)."""
        return _to_banded(self.grid_shape, self.offsets, self.host_coeffs,
                          self.is_hermitian, self.device)


def _to_banded(shape, offsets, cvals, is_hermitian, device) -> BandedOperator:
    """Diagonal storage of a stencil; ``cvals[k]`` a scalar or an (n,)
    field (numpy)."""
    n = math.prod(shape)
    strides = np.cumprod((1,) + shape[:0:-1])[::-1]   # row-major
    idx = np.arange(n)
    coords = [(idx // strides[a]) % shape[a] for a in range(len(shape))]
    lin_offsets = []
    diags = []
    for c, off in zip(cvals, offsets):
        o = int(sum(off[a] * strides[a] for a in range(len(shape))))
        valid = np.ones(n, dtype=bool)
        for a in range(len(shape)):
            ca = coords[a] + off[a]
            valid &= (ca >= 0) & (ca < shape[a])
        lin_offsets.append(o)
        diags.append(np.where(valid, c, 0).astype(cvals.dtype))
    order = np.argsort(lin_offsets)
    D = torch.as_tensor(np.stack([diags[i] for i in order]))
    return BandedOperator(D.to(device), [lin_offsets[i] for i in order],
                          is_hermitian=is_hermitian)


class VariableStencilOperator(LinearOperator):
    """Variable-coefficient stencil on a d-dimensional grid.

    A fixed stencil pattern (one offset set per row) whose points carry a
    per-cell coefficient field each: ``coeff_fields[k][cell]`` multiplies
    the neighbour at ``cell + offsets[k]`` when forming row ``cell``
    (out-of-grid neighbours read zero). Storage is (k, n), as in diagonal
    storage, organized on the grid so the matvec is k shifted elementwise
    products. Hermitian iff ``coeff_fields[k][i] ==
    coeff_fields[k'][i + offsets[k]]`` for the paired offset k' = -k; the
    builders guarantee it and set ``is_hermitian``.

    Deliberately not a ``StencilOperator``: the constant-coefficient
    kernels (B1, B6) admit every instance of that class and have no
    fields. On CUDA the 2-D/3-D form runs in B3-var
    (``ops/kernels/lanczos_fused.py``).
    """

    def __init__(self, grid_shape, offsets, coeff_fields, is_hermitian=False,
                 *, dtype=None, device=None):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        n = math.prod(self.grid_shape)
        C = host_tensor(coeff_fields, device, dtype)
        self.coeff_fields = C.reshape(len(self.offsets), n).contiguous()
        self.is_hermitian = bool(is_hermitian)
        d = len(self.grid_shape)
        if any(len(off) != d for off in self.offsets):
            raise ValueError("each offset must have one entry per grid axis")

    @property
    def shape(self):
        n = math.prod(self.grid_shape)
        return (n, n)

    @property
    def dtype(self):
        return self.coeff_fields.dtype

    @property
    def device(self):
        return self.coeff_fields.device

    @property
    def nnz(self) -> int:
        return len(self.offsets) * math.prod(self.grid_shape)

    def fields(self, dtype) -> torch.Tensor:
        """The (k, n) fields in ``dtype``: the own storage, or a copy made
        once and kept (``sparse._promoted``), never one per matvec."""
        return _promoted(self, "coeff_fields", dtype)

    def matvec(self, x):
        rt = torch.promote_types(self.dtype, x.dtype)
        X = x.reshape(self.grid_shape).to(rt)
        Fk = self.fields(rt).reshape((-1,) + self.grid_shape)
        return stencil_apply(X, self.offsets, Fk).reshape(-1)

    def matmat(self, X):
        """Each row of X (batch, n): the plain stencil on the stack of
        grids, the fields broadcast over the rows."""
        rt = torch.promote_types(self.dtype, X.dtype)
        G = X.reshape(X.shape[:1] + self.grid_shape).to(rt)
        Fk = self.fields(rt).reshape((-1,) + self.grid_shape)
        return stencil_apply(G, self.offsets, Fk).reshape(X.shape[0], -1)

    def opnorm_hint(self):
        return self.coeff_fields.abs().sum(dim=0).max()

    def _gershgorin_real(self):
        """Per-row Gershgorin enclosure (min_i (d_i - r_i), max_i (d_i +
        r_i)) of the spectrum's real parts over the per-cell fields, as
        host floats. The off-diagonal sums include the fields of boundary
        cells that face outside, as the JAX hint does. Computed where the
        fields live, once per operator (one sync), and kept: a reassigned
        ``coeff_fields`` computes it anew."""
        C = self.coeff_fields
        hit = self.__dict__.get("_gersh")
        if hit is not None and hit[0] is C:
            return hit[1]
        diag_k = [k for k, off in enumerate(self.offsets)
                  if all(o == 0 for o in off)]
        off_k = [k for k in range(len(self.offsets)) if k not in diag_k]
        # row sums in offset order, one field after the other: the order of
        # the JAX reduction, so the hint (and the Chebyshev degree) match
        d = torch.zeros(C.shape[1], dtype=C.real.dtype, device=C.device)
        for i, k in enumerate(diag_k):
            d = C[k].real if i == 0 else d + C[k].real
        r = torch.zeros_like(d)
        for i, k in enumerate(off_k):
            r = C[k].abs() if i == 0 else r + C[k].abs()
        bounds = tuple(torch.stack([(d - r).min(), (d + r).max()]).tolist())
        self._gersh = (C, bounds)
        return bounds

    def spectral_bounds_hint(self):
        """Gershgorin spectrum enclosure for the Chebyshev actions;
        Hermitian only."""
        return self._gershgorin_real() if self.is_hermitian else None

    def to_banded(self) -> BandedOperator:
        """Equivalent diagonal-storage operator (for oracles/conversion)."""
        return _to_banded(self.grid_shape, self.offsets,
                          self.coeff_fields.detach().cpu().numpy(),
                          self.is_hermitian, self.device)


def variable_diffusion_nd_stencil(a, dtype=None,
                                  device=None) -> VariableStencilOperator:
    """Cell-centered finite-volume div(a grad u) on a d-D grid (Dirichlet).

    ``a`` is the (s_0, ..., s_{d-1}) per-cell diffusivity field (numpy or
    a tensor). Face coefficients are arithmetic means of the adjacent
    cells, so the off-diagonal field at cell i toward +e_a equals the
    field at cell i+e_a toward -e_a: the operator is symmetric by
    construction (``is_hermitian=True``). Boundary faces use the cell's
    own value (a Dirichlet ghost with matching diffusivity). The fields
    are built on the host in numpy, as the JAX builder does, and placed on
    ``device`` (default: a tensor ``a``'s device, else
    ``utils.device.default_device()``)."""
    if isinstance(a, torch.Tensor):
        device = a.device if device is None else device
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(torch.empty((), dtype=dtype).numpy().dtype
                     if isinstance(dtype, torch.dtype) else dtype)
    shape = a.shape
    d = a.ndim
    offsets = [tuple([0] * d)]
    fields = [np.zeros_like(a)]
    diag = np.zeros_like(a)
    for ax in range(d):
        pad = [(0, 0)] * d
        pad[ax] = (1, 1)
        ap = np.pad(a, pad, mode="edge")
        lo = tuple(slice(0, shape[x]) for x in range(d))
        hi = tuple(slice(0, shape[x]) if x != ax else slice(2, shape[ax] + 2)
                   for x in range(d))
        w_minus = 0.5 * (a + ap[lo])     # face toward -e_ax
        w_plus = 0.5 * (a + ap[hi])      # face toward +e_ax
        diag -= w_minus + w_plus
        for s, w in ((-1, w_minus), (1, w_plus)):
            off = [0] * d
            off[ax] = s
            offsets.append(tuple(off))
            fields.append(w)
    fields[0] = diag
    C = np.stack([f.reshape(-1) for f in fields])
    return VariableStencilOperator(shape, offsets, C, is_hermitian=True,
                                   device=device)


def laplacian_nd_stencil(*shape, dtype=torch.float64, scale: float = 1.0,
                         device=None) -> StencilOperator:
    """d-dimensional (2d+1)-point Laplacian stencil on ``shape``
    (Dirichlet). ``laplacian_nd_stencil(nz, ny, nx)`` matches
    ``utils.testmatrices.laplacian_3d(nx, ny, nz)`` (x fastest)."""
    d = len(shape)
    offsets = [tuple([0] * d)]
    coeffs = [-2.0 * d * scale]
    for a in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[a] = s
            offsets.append(tuple(off))
            coeffs.append(scale)
    return StencilOperator(shape, offsets, np.asarray(coeffs), is_hermitian=True,
                           dtype=dtype, device=device)


def advection_diffusion_3d_stencil(nz: int, ny: int, nx: int,
                                   peclet: float = 10.0, dtype=torch.float64,
                                   device=None) -> StencilOperator:
    """3-D diffusion + upwind x-advection, lap(u) + Pe u_x, Dirichlet: the
    non-symmetric constant 7-point operator of the fused polynomial
    recurrences. h = 1/(nx+1) along every axis."""
    h = 1.0 / (nx + 1)
    dcoef = 1.0 / h ** 2
    acoef = peclet / h
    offsets = [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
               (1, 0, 0), (-1, 0, 0)]
    coeffs = [-6.0 * dcoef - acoef, dcoef, dcoef + acoef,
              dcoef, dcoef, dcoef, dcoef]
    return StencilOperator((nz, ny, nx), offsets, np.asarray(coeffs),
                           is_hermitian=False, dtype=dtype, device=device)


def advection_diffusion_1d_stencil(n: int, peclet: float = 10.0,
                                   dtype=torch.float64,
                                   device=None) -> StencilOperator:
    """Constant-coefficient variant of
    ``utils.testmatrices.advection_diffusion_1d``."""
    h = 1.0 / (n + 1)
    dcoef = 1.0 / h ** 2
    acoef = peclet / h
    return StencilOperator(
        (n,), ((-1,), (0,), (1,)),
        np.asarray([dcoef + acoef, -2.0 * dcoef - acoef, dcoef]),
        is_hermitian=False, dtype=dtype, device=device)

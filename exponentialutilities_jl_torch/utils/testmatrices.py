"""Standard test operators of BASELINE.json (PyTorch port of
``exponentialutilities_jl_tpu/utils/testmatrices.py``), in diagonal
storage (``BandedOperator``)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import BandedOperator
from .device import host_tensor

__all__ = ["laplacian_1d", "poisson_2d", "laplacian_3d",
           "advection_diffusion_1d"]


def _banded(diags, offsets, dtype, device):
    D = host_tensor(np.stack(diags), device, dtype)
    return BandedOperator(D, offsets, is_hermitian=True)


def laplacian_1d(n: int, dtype=torch.float64, scale: float = 1.0,
                 device=None) -> BandedOperator:
    """Second-difference stencil (1, -2, 1) * scale, Dirichlet."""
    main = np.full(n, -2.0 * scale)
    lower = np.full(n, 1.0 * scale)
    lower[0] = 0.0                       # A[i, i-1] undefined at i = 0
    upper = np.full(n, 1.0 * scale)
    upper[-1] = 0.0                      # A[i, i+1] undefined at i = n-1
    return _banded([lower, main, upper], (-1, 0, 1), dtype, device)


def poisson_2d(nx: int, ny: int, dtype=torch.float64, scale: float = 1.0,
               device=None) -> BandedOperator:
    """5-point 2-D Poisson stencil on an nx x ny grid (row-major), Dirichlet."""
    n = nx * ny
    i = np.arange(n)
    ix = i % nx
    main = np.full(n, -4.0 * scale)
    west = np.where(ix > 0, scale, 0.0)
    east = np.where(ix < nx - 1, scale, 0.0)
    south = np.where(i >= nx, scale, 0.0)
    north = np.where(i < n - nx, scale, 0.0)
    return _banded([south, west, main, east, north], (-nx, -1, 0, 1, nx),
                   dtype, device)


def laplacian_3d(nx: int, ny: int, nz: int, dtype=torch.float64,
                 scale: float = 1.0, device=None) -> BandedOperator:
    """7-point 3-D Laplacian stencil (row-major, x fastest), Dirichlet."""
    n = nx * ny * nz
    i = np.arange(n)
    ix = i % nx
    iy = (i // nx) % ny
    main = np.full(n, -6.0 * scale)
    west = np.where(ix > 0, scale, 0.0)
    east = np.where(ix < nx - 1, scale, 0.0)
    south = np.where(iy > 0, scale, 0.0)
    north = np.where(iy < ny - 1, scale, 0.0)
    down = np.where(i >= nx * ny, scale, 0.0)
    up = np.where(i < n - nx * ny, scale, 0.0)
    return _banded([down, south, west, main, east, north, up],
                   (-nx * ny, -nx, -1, 0, 1, nx, nx * ny), dtype, device)


def advection_diffusion_1d(n: int, peclet: float = 10.0, dtype=torch.float64,
                           device=None) -> BandedOperator:
    """Stiff 1-D advection-diffusion u_xx + Pe u_x with upwind advection,
    Dirichlet: the non-Hermitian operator of BASELINE config #4."""
    h = 1.0 / (n + 1)
    dcoef = 1.0 / h ** 2
    acoef = peclet / h
    main = np.full(n, -2.0 * dcoef - acoef)
    lower = np.full(n, dcoef + acoef)
    lower[0] = 0.0
    upper = np.full(n, dcoef)
    upper[-1] = 0.0
    D = host_tensor(np.stack([lower, main, upper]), device, dtype)
    return BandedOperator(D, (-1, 0, 1), is_hermitian=False)

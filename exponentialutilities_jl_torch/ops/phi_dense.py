"""Dense phi functions (PyTorch port of the part of
``exponentialutilities_jl_tpu/ops/phi_dense.py`` that the Krylov
phi-function actions need).

The phi functions are phi_0(z) = e^z, phi_{k+1}(z) = (phi_k(z) - phi_k(0))/z.

* ``phi_scalar(z, k)``: phi_0..phi_k of a scalar (or of each entry of an
  array) from the (k+1)^2 companion-like augmented matrix (Sidje, Thm 1).
* ``phiv_dense(A, v, k)``: [phi_0(A)v ... phi_k(A)v] from the (m+k)^2
  augmented matrix, all the dense phi machinery the Krylov path needs.

Not ported yet (ROADMAP A4): ``phi``, ``phi_taylor``,
``phi_taylor_batched`` and ``phi_with_info``.
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils.device import host_tensor
from ..utils.precision import full_precision
from .expm import expm_higham2005, expm_taylor, expm_taylor_masked

__all__ = ["phi_scalar", "phiv_dense"]


_ENGINES = {"higham2005": expm_higham2005, "taylor": expm_taylor,
            "taylor_masked": expm_taylor_masked}


def _inv_factorial(n: int) -> float:
    """1/n! in float64, exact to the last ulp for n <= 170 and 0.0 beyond
    (where it underflows anyway)."""
    return 1.0 / float(math.factorial(n)) if n <= 170 else 0.0


def _taylor_order(dtype) -> tuple[float, int]:
    """(theta, M): scaled-norm threshold and Taylor truncation order with
    the series tail at ||X|| <= theta below the dtype's unit roundoff
    (tail <= theta^{M+1} e^theta / (M+1)!)."""
    bits = torch.finfo(dtype).bits
    if bits >= 64:
        return 1.0, 20
    if bits >= 32:
        return 1.0, 12
    return 1.0, 8


def _ps_phi_taylor(X, p: int, order: int):
    """phi_p(X) ~ sum_{i=0}^{order} X^i/(i+p)! by Paterson-Stockmeyer:
    about 2 sqrt(order) matrix products instead of ``order``."""
    I = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    coeffs = [_inv_factorial(i + p) for i in range(order + 1)]
    tau = max(2, math.isqrt(order) + 1)
    nblocks = (order + 1 + tau - 1) // tau

    pows = [I, X]                       # X^0..X^tau (X^tau: the Horner step)
    for _ in range(2, tau + 1):
        pows.append(pows[-1] @ X)

    def block(b):
        acc = None
        for r in range(tau):
            i = b * tau + r
            if i > order:
                break
            term = coeffs[i] * pows[r]
            acc = term if acc is None else acc + term
        return acc if acc is not None else torch.zeros_like(I)

    acc = block(nblocks - 1)
    for b in range(nblocks - 2, -1, -1):
        acc = acc @ pows[tau] + block(b)
    return acc


@full_precision
def phi_scalar(z, k: int):
    """phi_0..phi_k of a scalar, (k+1,), or of each entry of an array,
    z.shape + (k+1,), from the (k+1)^2 augmented-matrix exponential."""
    z = host_tensor(z)

    def one(zs):
        M = torch.diag(torch.ones(k, dtype=z.dtype, device=z.device), 1)
        M[0, 0] = zs
        return expm_higham2005(M)[0, :]

    if z.ndim == 0:
        return one(z)
    flat = torch.stack([one(zs) for zs in z.reshape(-1)])
    return flat.reshape(z.shape + (k + 1,))


@full_precision
def phiv_dense(A, v, k: int, *, expm_method: str = "higham2005",
               onenorm: float | None = None):
    """[phi_0(A)v phi_1(A)v ... phi_k(A)v] for a small dense A via the
    augmented matrix

        A~ = [A  v  e_1 ... e_{k-1}; 0  J]   (J the k x k nilpotent shift)

    (Sidje, Thm 1). Returns an (m, k+1) matrix. ``expm_method``:
    "higham2005", the solver-free "taylor", or "taylor_masked" (no host
    read). ``onenorm``: the 1-norm of A~ (of A when k = 0) when the caller
    knows it on the host; it saves the exponential's host read."""
    engine = _ENGINES[expm_method]
    if onenorm is not None:
        engine = functools.partial(engine, onenorm=onenorm)
    A = host_tensor(A)
    v = host_tensor(v, A.device)
    m = A.shape[0]
    dt = torch.promote_types(A.dtype, v.dtype)
    A, v = A.to(dt), v.to(dt)
    if k == 0:
        return (engine(A) @ v)[:, None]
    Aug = torch.zeros((m + k, m + k), dtype=dt, device=A.device)
    Aug[:m, :m] = A
    Aug[:m, m] = v
    if k >= 2:
        # the shift J as an identity block (a scalar written through an
        # index tensor would be a host-to-device copy, i.e. a sync)
        Aug[m:m + k - 1, m + 1:] = torch.eye(k - 1, dtype=dt, device=A.device)
    P = engine(Aug)
    return torch.cat([(P[:m, :m] @ v)[:, None], P[:m, m:m + k]], dim=1)

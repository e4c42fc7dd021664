"""Dense phi functions (PyTorch port of
``exponentialutilities_jl_tpu/ops/phi_dense.py``).

The phi functions are phi_0(z) = e^z, phi_{k+1}(z) = (phi_k(z) - phi_k(0))/z.

* ``phi_scalar(z, k)``: phi_0..phi_k of a scalar (or of each entry of an
  array) from the (k+1)^2 companion-like augmented matrix (Sidje, Thm 1).
* ``phiv_dense(A, v, k)``: [phi_0(A)v ... phi_k(A)v] from the (m+k)^2
  augmented matrix, all the dense phi machinery the Krylov path needs.
* ``phi(A, k)``: the stack [phi_0(A), ..., phi_k(A)]. ``method="taylor"``
  (``phi_taylor``) scales A -> A/2^s, evaluates phi_k by a
  Paterson-Stockmeyer Taylor series, recovers phi_{k-1}..phi_0 by
  phi_j(X) = X phi_{j+1}(X) + I/j! and undoes the scaling with the
  double-argument identity

      phi_l(2X) = 2^-l (phi_0(X) phi_l(X) + sum_{k=1}^{l} phi_k(X)/(l-k)!)

  for every l at once (one (k+1)-batched product and one small
  coefficient contraction a stage). ``method="pade"`` is the Al-Mohy-Liu
  Pade form (``ops/phi_almohy.py``); "auto" takes it for k >= 1 in 64-bit
  precision, Taylor otherwise, and a stack (..., n, n) goes to
  ``phi_taylor_batched`` (one scaling count from the batch's largest
  norm).
* ``phi_with_info``: ``phi`` plus the no-throw info code (0 = finite,
  1 = non-finite), a 0-d int32 tensor (no host read).

By default the 1-norm is read to the host once and exactly s stages run;
``differentiable=True`` is the form with no host read (s on the device,
``max_squarings`` masked stages), as in ``ops/expm.py``.
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils.device import host_tensor
from ..utils.precision import full_precision
from .expm import (_onenorm, _real_dtype, _scaled, _scaling,
                   _scaling_device, _square, expm_higham2005, expm_taylor,
                   expm_taylor_masked)

__all__ = ["phi_scalar", "phiv_dense", "phi", "phi_taylor",
           "phi_taylor_batched", "phi_with_info"]


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
    I = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
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
        return acc if acc is not None else torch.zeros_like(X)

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
               onenorm: float | None = None, differentiable: bool = False):
    """[phi_0(A)v phi_1(A)v ... phi_k(A)v] for a small dense A via the
    augmented matrix

        A~ = [A  v  e_1 ... e_{k-1}; 0  J]   (J the k x k nilpotent shift)

    (Sidje, Thm 1). Returns an (m, k+1) matrix. ``expm_method``:
    "higham2005", the solver-free "taylor", or "taylor_masked" (no host
    read). ``onenorm``: the 1-norm of A~ (of A when k = 0) when the caller
    knows it on the host; it saves the exponential's host read.
    ``differentiable=True``: the exponential's form with no host read
    (``ops/expm.py``)."""
    engine = _ENGINES[expm_method]
    if differentiable:
        engine = functools.partial(
            expm_taylor if expm_method != "higham2005" else engine,
            differentiable=True)
    elif onenorm is not None:
        engine = functools.partial(engine, onenorm=onenorm)
    A = host_tensor(A)
    v = host_tensor(v, A.device)
    m = A.shape[0]
    dt = torch.promote_types(A.dtype, v.dtype)
    A, v = A.to(dt), v.to(dt)
    if k == 0:
        return (engine(A) @ v)[:, None]
    kw = dict(dtype=dt, device=A.device)
    # assembled out of place (vmap-safe); the shift J from an identity
    # block (a scalar written through an index tensor would be a
    # host-to-device copy, i.e. a sync)
    J = torch.zeros((k, k), **kw)
    if k >= 2:
        J = torch.cat([torch.zeros((k, 1), **kw),
                       torch.cat([torch.eye(k - 1, **kw),
                                  torch.zeros((1, k - 1), **kw)])], dim=1)
    Aug = torch.cat([
        torch.cat([A, v[:, None], torch.zeros((m, k - 1), **kw)], dim=1),
        torch.cat([torch.zeros((k, m), **kw), J], dim=1)])
    P = engine(Aug)
    return torch.cat([(P[:m, :m] @ v)[:, None], P[:m, m:m + k]], dim=1)


def _phi_all_of_scaled(X, p: int, order: int):
    """The stack [phi_0(X), ..., phi_p(X)], (..., p+1, n, n), from one
    Taylor evaluation of phi_p and the recovery phi_j = X phi_{j+1} + I/j!."""
    I = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    Fs = [None] * (p + 1)
    Fs[p] = _ps_phi_taylor(X, p, order)
    for j in range(p - 1, -1, -1):
        Fs[j] = X @ Fs[j + 1] + _inv_factorial(j) * I
    return torch.stack(torch.broadcast_tensors(*Fs), dim=-3)


def _double_argument_stage(F, p: int):
    """One squaring stage: every phi_l(2X) from the stack F = [phi_l(X)]
    (..., p+1, n, n): phi_0(2X) = phi_0^2, phi_l(2X) = 2^-l (phi_0 phi_l +
    sum_{k=1}^{l} phi_k / (l-k)!). One (p+1)-batched product and one small
    coefficient contraction."""
    G = F[..., :1, :, :] @ F                  # phi_0 phi_l for every l
    # stage l: 2^-l (G_l + sum_{k=1}^{l} F_k / (l-k)!), with the weights
    # as Python floats (no host-to-device copy)
    out = [G[..., 0, :, :]]
    for ell in range(1, p + 1):
        acc = G[..., ell, :, :]
        for kk in range(1, ell + 1):
            acc = acc + _inv_factorial(ell - kk) * F[..., kk, :, :]
        out.append(0.5 ** ell * acc)
    return torch.stack(out, dim=-3)


def _phi_scaled_stages(A, p: int, nA, max_squarings: int,
                       differentiable: bool):
    """Scaling, Taylor + recovery and the double-argument stages, for a
    matrix or a stack whose largest 1-norm is nA (a host float, or None
    for the device form)."""
    theta, order = _taylor_order(A.dtype)
    if differentiable:
        s = _scaling_device(_onenorm(A).to(_real_dtype(A.dtype)), theta,
                            max_squarings)
        F = _phi_all_of_scaled(_scaled(A, s), p, order)
        live = torch.arange(max_squarings, device=A.device) < s
        for i in range(max_squarings):
            F = torch.where(live[i], _double_argument_stage(F, p), F)
        return F
    s = _scaling(nA, theta, max_squarings)
    F = _phi_all_of_scaled(_scaled(A, s), p, order)
    for _ in range(s):
        F = _double_argument_stage(F, p)
    return F


@full_precision
def phi_taylor(A, k: int, *, max_squarings: int = 48,
               differentiable: bool = False):
    """[phi_0(A), ..., phi_k(A)] stacked as (k+1, n, n) by Taylor scaling
    and recovering (module doc): exactly s double-argument stages after one
    host read of the norm, or ``max_squarings`` masked ones with
    ``differentiable=True``."""
    A = _square(A, "phi_taylor", stacked=False)
    nA = None if differentiable else float(_onenorm(A.detach()))
    return _phi_scaled_stages(A, int(k), nA, max_squarings, differentiable)


@full_precision
def phi_taylor_batched(A, k: int, *, max_squarings: int = 48,
                       differentiable: bool = False):
    """Batch-uniform [phi_0 ... phi_k] of a (..., n, n) stack, returned as
    (..., k+1, n, n): one scaling count from the batch's largest 1-norm
    (read once), then the Taylor stage, the recovery and every
    double-argument stage as batched products with no loop over the
    batch. A single matrix goes to ``phi_taylor``."""
    A = _square(A, "phi_taylor_batched")
    if A.ndim < 3:
        return phi_taylor(A, k, max_squarings=max_squarings,
                          differentiable=differentiable)
    nA = None if differentiable else float(_onenorm(A.detach()))
    return _phi_scaled_stages(A, int(k), nA, max_squarings, differentiable)


def phi(A, k: int, *, method: str = "auto", max_squarings: int | None = None,
        differentiable: bool = False):
    """[phi_0(A), ..., phi_k(A)]: the dense-phi front door (module doc).
    ``method``: "pade" (Al-Mohy-Liu, k >= 1), "taylor", or "auto" (pade
    for k >= 1 in 64-bit precision, taylor otherwise); a stack goes to
    ``phi_taylor_batched`` under "auto" and "taylor"."""
    A = host_tensor(A)
    kw = {} if max_squarings is None else {"max_squarings": max_squarings}
    if A.ndim > 2 and method in ("auto", "taylor"):
        return phi_taylor_batched(A, k, differentiable=differentiable, **kw)
    if method == "auto":
        use_pade = k >= 1 and torch.finfo(A.dtype).bits >= 64
        method = "pade" if use_pade else "taylor"
    if method == "pade":
        from .phi_almohy import phi_pade
        return phi_pade(A, k, differentiable=differentiable, **kw)
    if method == "taylor":
        return phi_taylor(A, k, differentiable=differentiable, **kw)
    raise ValueError(f"unknown phi method {method!r}; "
                     "expected 'auto', 'pade' or 'taylor'")


def _info(out):
    """The no-throw info code: 0 when every entry is finite, else 1 (a 0-d
    int32 tensor; no host read)."""
    return torch.where(torch.isfinite(out).all(), 0, 1).to(torch.int32)


def phi_with_info(A, k: int, **kwargs):
    """``phi`` plus the no-throw info code: 0 = success, 1 = non-finite
    result."""
    out = phi(A, k, **kwargs)
    return out, _info(out)

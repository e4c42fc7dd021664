"""Krylov exponential action ``expv(t, A, b) ~ exp(tA) b`` for Hermitian
operators (PyTorch port of the Hermitian paths of
``exponentialutilities_jl_tpu/models/expv.py``).

* ``mode="happy_breakdown"``: a Lanczos basis, then the reduced
  tridiagonal exponential by ``torch.linalg.eigh`` and the (m, n)
  combination w = beta V^T exp(tH) e1.
* ``two_pass=True``: storage-free two-pass Lanczos. Pass 1 records
  (alpha, beta), the reduced eigh gives the combination coefficients,
  pass 2 regenerates the basis and accumulates w, in O(n) memory. On a
  CUDA device with real float32/float64 data and real t, a 1-D constant
  stencil runs both passes in the resident kernels (B2 then B1, one
  launch each) and a 2-D/3-D box stencil in fused sweeps (B3); everything
  else, and complex t on any device, takes the plain torch passes.

A ``SortedSellOperator`` is unwrapped on entry (``hoist_conjugation``):
the solve runs on its inner operator in the sorted basis, with one
permutation of b in and one of the result out.

Breakdown is masked, not truncated: trailing alpha/beta are zero, which
makes the reduced matrix block-diagonal so exp(tT) e1 is exact for the
effective dimension.

Not ported yet, and raising NotImplementedError: non-Hermitian operators
(Arnoldi, ROADMAP A5), ``mode="error_estimate"`` and ``reduced="host"``
(ROADMAP A6).
"""

from __future__ import annotations

import torch

from ..ops.kernels.dispatch import kernel_device_ok
from ..ops.krylov import KrylovBasis, lanczos
from ..ops.sparse import hoist_conjugation
from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import full_precision

__all__ = ["expv", "expv_from_basis", "build_subspace"]


def build_subspace(op: LinearOperator, b, m: int, *, tol: float = 1e-7,
                   hermitian: bool | None = None) -> KrylovBasis:
    """Lanczos factorization of a Hermitian operator."""
    herm = op.is_hermitian if hermitian is None else hermitian
    if not herm:
        raise NotImplementedError(
            "non-Hermitian operators need Arnoldi, not ported yet "
            "(ROADMAP A5)")
    return lanczos(op, b, m, tol=tol)


def _exp_reduced_e1(Ks: KrylovBasis, t):
    """First column of exp(t H_m) for the masked reduced tridiagonal, (m,):
    eigh of H_m. The masked trailing zero block is block-diagonal; its
    eigenvectors have zero first component, so e1 excites only the
    effective leading block."""
    m = Ks.m
    w, Q = torch.linalg.eigh(Ks.H[:m, :m])
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    return Q.to(cdt) @ (torch.exp(t * w) * Q[0, :].to(cdt))


@full_precision
def _combine_expv(Ks: KrylovBasis, expHe):
    """w = beta V^T expHe with the zero-start guard."""
    m = Ks.m
    w = expHe @ Ks.V[:m].to(expHe.dtype)
    out = Ks.beta.to(w.dtype) * w
    return torch.where(Ks.beta > 0, out, 0.0)


def expv_from_basis(t, Ks: KrylovBasis, *, reduced: str = "device"):
    """w = beta V^T exp(tH) e1 from a prebuilt basis."""
    if reduced != "device":
        raise NotImplementedError(
            f'reduced="{reduced}": only the device reduced exponential is '
            "ported (ROADMAP A6)")
    if not Ks.hermitian:
        raise NotImplementedError(
            "Arnoldi bases are not ported yet (ROADMAP A5)")
    return _combine_expv(Ks, _exp_reduced_e1(Ks, t))


def _lanczos_reduced_coeffs(alphas, betas, beta0, t):
    """Reduced stage of every two-pass Hermitian expv: masked tridiagonal
    T -> eigh -> the replay combination coefficients beta0 Q e^{t Lambda}
    Q^T e1."""
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w_eig, Q = torch.linalg.eigh(T)
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    return (Q.to(cdt) @ (torch.exp(t * w_eig) * Q[0, :].to(cdt))
            * beta0.to(cdt))


@full_precision
def _expv_two_pass(op, b, t, m: int):
    """Storage-free Hermitian expv on the plain torch passes
    (``ops.krylov.lanczos_coeffs`` / ``lanczos_replay``): 2m matvecs,
    O(n) memory."""
    from ..ops.krylov import lanczos_coeffs, lanczos_replay

    alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, b, m)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t)
    out = lanczos_replay(op, b, coeffs, alphas, betas, m)
    return torch.where(beta0 > 0, out, 0.0)


def _expv_two_pass_fused(op, b, t, m: int, tol: float = 1e-7):
    """Two-pass Hermitian expv with both passes as fused sweeps (B3)."""
    from ..ops.kernels.lanczos_fused import (lanczos_coeffs_fused,
                                             lanczos_replay_fused)

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_fused(op, b, m,
                                                               tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t)
    out = lanczos_replay_fused(op, b, coeffs, tol=tol)
    return torch.where(beta0 > 0, out, 0.0)


def expv(t, A, b, *, m: int = 30, tol: float = 1e-7,
         mode: str = "happy_breakdown", hermitian: bool | None = None,
         reduced: str = "device", two_pass: bool = False):
    """exp(tA) b by a Krylov approximation of a Hermitian operator.

    t: real or complex scalar. A: operator or square matrix. b: (n,).
    m: Krylov dimension (capped at n). tol: happy-breakdown threshold.
    two_pass: the storage-free two-pass Lanczos (module doc), which picks
      the CUDA kernels for real float32/float64 data and real t on a CUDA
      device when the operator is a supported stencil.
    """
    op = aslinearoperator(A)
    b = torch.as_tensor(b)
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # degree-sorted conjugated container: the whole solve runs in the
        # sorted basis (exp commutes with the conjugation)
        return post(expv(t, op, b, m=m, tol=tol, mode=mode,
                         hermitian=hermitian, reduced=reduced,
                         two_pass=two_pass))
    m = min(m, op.shape[0])
    if reduced != "device":
        raise NotImplementedError(
            f'reduced="{reduced}": only the device reduced exponential is '
            "ported (ROADMAP A6)")
    if mode == "error_estimate":
        raise NotImplementedError(
            'mode="error_estimate" is not ported yet (ROADMAP A6)')
    if mode != "happy_breakdown":
        raise ValueError(f"unknown expv mode {mode!r}")
    herm = op.is_hermitian if hermitian is None else hermitian
    if not herm:
        raise NotImplementedError(
            "non-Hermitian expv needs Arnoldi, not ported yet (ROADMAP A5)")
    if not two_pass:
        return expv_from_basis(t, build_subspace(op, b, m, tol=tol,
                                                 hermitian=True))
    from ..ops.kernels.lanczos_fused import fused_supported
    from ..ops.kernels.resident import (expv_two_pass_resident,
                                        resident_supported)

    # the kernels replay with real coefficients: complex t keeps the
    # plain path, whose coefficients promote to complex
    kernels = (kernel_device_ok(b.dtype, b.device)
               and not torch.as_tensor(t).is_complex())
    if kernels and resident_supported(op):
        return expv_two_pass_resident(op, b, t, m, tol=tol)
    if kernels and fused_supported(op, hermitian=True):
        return _expv_two_pass_fused(op, b, t, m, tol=tol)
    return _expv_two_pass(op, b, t, m)

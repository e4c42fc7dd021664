"""Krylov exponential action ``expv(t, A, b) ~ exp(tA) b`` (PyTorch port
of ``exponentialutilities_jl_tpu/models/expv.py``).

* ``mode="happy_breakdown"``: a Lanczos basis for Hermitian operators, an
  Arnoldi basis (full or IOP window, CGS2 with ``reorth``) otherwise, then
  the reduced exponential: ``torch.linalg.eigh`` of the masked tridiagonal,
  or the degree-13 Pade ``expm_higham2005`` of t H_m, and the (m, n)
  combination w = beta V^T exp(tH) e1.
* ``two_pass=True``: storage-free two passes in O(n) memory. Hermitian:
  pass 1 records (alpha, beta), the reduced eigh gives the combination
  coefficients, pass 2 regenerates the basis and accumulates w. On a CUDA
  device with real float32/float64 data and real t, a 1-D constant
  stencil runs both passes in the resident kernels (B2 then B1, one launch
  each) and a 2-D/3-D box stencil, constant or variable-coefficient, in
  fused sweeps (B3, B3-var); everything else, and complex t on any device,
  takes the plain torch passes. Non-Hermitian: IOP Arnoldi over a rolling
  window (``iop > 0`` required), the same recurrence as
  ``expv(iop=win, reorth=False)``.
* ``mode="error_estimate"``: Hermitian Lanczos stopped by Saad's Er2
  estimate (``_expv_error_estimate``).

A ``SortedSellOperator`` is unwrapped on entry (``hoist_conjugation``):
the solve runs on its inner operator in the sorted basis, with one
permutation of b in and one of the result out. A numpy ``b`` goes to the
operator's device.

Breakdown is masked, not truncated: trailing basis rows and H entries are
zero, which makes the reduced matrix block-triangular, so exp(tH) e1 is
exact for the effective dimension.

``expv_batched(t, A, B)`` runs ``expv`` on each row of B ((batch, n) ->
(batch, n)): each column takes the path, kernels included, that its
scalar call takes (``torch.func.vmap`` cannot enter a raw-pointer kernel).

``differentiable=True`` makes the non-Hermitian reduced exponential the
form with no host read (``expm_higham2005(differentiable=True)``: masked
squarings), for ``torch.func`` transforms; the Hermitian path (eigh) has
no host read anyway. Plain ``torch.autograd`` differentiates every path:
B7's matvec has a reverse rule (``ops/sparse.py``), and the grad rule of
``ops/kernels/dispatch.py`` sends a two-pass call that requires grad to
the plain torch passes.

A row-sharded operator (``parallel.shard_operator``) runs every path but
the kernels' on this rank's rows of b: the operator's ``comm``
(``utils/comm.py``) reduces the dots and norms, and the result is this
rank's rows.

``reduced="host"`` evaluates the m-sized reduced problem with scipy on
the host in float64/complex128 (``ops/host_reduced.py``), in every path
that has one: the basis path (``expm`` of t H_m), the two-pass Hermitian
forms (``eigh_tridiagonal`` between the passes; the kernels still run
both passes), the two-pass IOP form and ``expv_batched``. It costs one
device-to-host read and one host-to-device write per reduced problem.
The default ``reduced=None`` is ``reduced_default()``, "device": the
H100 has native float64, where the JAX package stages on the host only
for the TPU. ``differentiable=True`` and ``mode="error_estimate"`` refuse
"host", as the JAX package documents.
"""

from __future__ import annotations

import torch

from ..ops.expm import expm_higham2005
from ..ops.host_reduced import (host_expm_e1, host_lanczos_coeffs,
                                reduced_default)
from ..ops.kernels.dispatch import grad_gate, kernel_device_ok
from ..ops.krylov import (KrylovBasis, arnoldi, arnoldi_coeffs, arnoldi_replay,
                          expand_compact_hessenberg, lanczos, lanczos_coeffs,
                          lanczos_replay)
from ..ops.sparse import hoist_conjugation
from ..utils.comm import operator_comm, vdot, vector_norm
from ..utils.device import action_vector
from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import full_precision

__all__ = ["expv", "expv_from_basis", "build_subspace", "make_expv",
           "expv_batched"]


def build_subspace(op: LinearOperator, b, m: int, *, tol: float = 1e-7,
                   iop: int = 0, reorth: bool = True,
                   hermitian: bool | None = None) -> KrylovBasis:
    """Lanczos factorization of a Hermitian operator, Arnoldi of any
    other (the reference's auto-switch on ``ishermitian``). A row-sharded
    ``op`` takes this rank's rows of b (``ops/krylov.arnoldi``)."""
    herm = op.is_hermitian if hermitian is None else hermitian
    if herm:
        return lanczos(op, b, m, tol=tol)
    return arnoldi(op, b, m, iop=iop, tol=tol, reorth=reorth)


def _t_dtype(t):
    return torch.as_tensor(t).dtype


def _exp_reduced_e1(Ks: KrylovBasis, t, differentiable: bool = False):
    """First column of exp(t H_m) for the masked reduced matrix, (m,).
    Hermitian (real tridiagonal): eigh of H_m; the masked trailing zero
    block is block-diagonal, its eigenvectors have zero first component,
    so e1 excites only the effective leading block. Otherwise
    ``expm_higham2005(t H_m)[:, 0]`` (its form with no host read when
    ``differentiable``)."""
    m = Ks.m
    Hm = Ks.H[:m, :m]
    if Ks.hermitian and not Hm.is_complex():
        w, Q = torch.linalg.eigh(Hm)
        cdt = torch.promote_types(Q.dtype, _t_dtype(t))
        return Q.to(cdt) @ (torch.exp(t * w) * Q[0, :].to(cdt))
    return expm_higham2005(
        t * Hm.to(torch.promote_types(Hm.dtype, _t_dtype(t))),
        differentiable=differentiable)[:, 0]


@full_precision
def _combine_expv(Ks: KrylovBasis, expHe):
    """w = beta V^T expHe with the zero-start guard, in the common type of
    the basis and the coefficients (a complex b on a real Hermitian
    operator keeps its imaginary part)."""
    m = Ks.m
    dt = torch.promote_types(expHe.dtype, Ks.V.dtype)
    w = expHe.to(dt) @ Ks.V[:m].to(dt)
    out = Ks.beta.to(w.dtype) * w
    return torch.where(Ks.beta > 0, out, 0.0)


def _reduced_where(reduced, differentiable: bool = False,
                   mode: str = "happy_breakdown") -> str:
    """"device" or "host" for a caller's ``reduced`` (None: the default),
    refusing "host" with ``differentiable`` (a host read breaks the
    ``torch.func`` transforms) and with the error-estimate loop."""
    reduced = reduced_default() if reduced is None else reduced
    if reduced not in ("device", "host"):
        raise ValueError(f'reduced must be "device", "host" or None, got '
                         f"{reduced!r}")
    if reduced == "host" and differentiable:
        raise ValueError('reduced="host" is not differentiable (the reduced '
                         "problem goes through host scipy); use "
                         'reduced="device"')
    if reduced == "host" and mode == "error_estimate":
        raise ValueError('mode="error_estimate" evaluates its reduced '
                         'problems on the device; use reduced="device"')
    return reduced


def expv_from_basis(t, Ks: KrylovBasis, *, reduced: str = "device",
                    differentiable: bool = False):
    """w = beta V^T exp(tH) e1 from a prebuilt Lanczos or Arnoldi basis
    (``reduced``, ``differentiable``: module doc)."""
    if _reduced_where(reduced, differentiable) == "host":
        m = Ks.m
        return _combine_expv(Ks, host_expm_e1(Ks.H[:m, :m], t))
    return _combine_expv(Ks, _exp_reduced_e1(Ks, t, differentiable))


def _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced="device"):
    """Reduced stage of every two-pass Hermitian expv: masked tridiagonal
    T -> eigh -> the replay combination coefficients beta0 Q e^{t Lambda}
    Q^T e1 (on the host with ``reduced="host"``)."""
    if reduced == "host":
        return host_lanczos_coeffs(alphas, betas, beta0, t)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w_eig, Q = torch.linalg.eigh(T)
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    return (Q.to(cdt) @ (torch.exp(t * w_eig) * Q[0, :].to(cdt))
            * beta0.to(cdt))


@full_precision
def _expv_two_pass(op, b, t, m: int, reduced: str = "device"):
    """Storage-free Hermitian expv on the plain torch passes
    (``ops.krylov.lanczos_coeffs`` / ``lanczos_replay``): 2m matvecs,
    O(n) memory."""
    alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, b, m)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced)
    out = lanczos_replay(op, b, coeffs, alphas, betas, m)
    return torch.where(beta0 > 0, out, 0.0)


def _expv_two_pass_fused(op, b, t, m: int, tol: float = 1e-7,
                         reduced: str = "device"):
    """Two-pass Hermitian expv with both passes as fused sweeps (B3)."""
    from ..ops.kernels.lanczos_fused import (lanczos_coeffs_fused,
                                             lanczos_replay_fused)

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_fused(op, b, m,
                                                               tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced)
    out = lanczos_replay_fused(op, b, coeffs, tol=tol)
    return torch.where(beta0 > 0, out, 0.0)


@full_precision
def _expv_two_pass_arnoldi(op, b, t, m: int, win: int,
                           differentiable: bool = False,
                           reduced: str = "device"):
    """Storage-free non-Hermitian expv: two IOP-Arnoldi passes over a
    (win, n) rolling window (``ops.krylov.arnoldi_coeffs`` /
    ``arnoldi_replay``); the same recurrence as ``expv(iop=win,
    reorth=False)`` without the basis."""
    Hc, beta0, m_used, broke = arnoldi_coeffs(op, b, m, win)
    H = expand_compact_hessenberg(Hc, win)
    dt = torch.promote_types(H.dtype, _t_dtype(t))
    if reduced == "host":
        expHe = host_expm_e1(H[:m, :m], t, dt)
    else:
        expHe = expm_higham2005(t * H[:m, :m].to(dt),
                                differentiable=differentiable)[:, 0]
    w = arnoldi_replay(op, b, expHe * beta0.to(dt), Hc, m, win)
    return torch.where(beta0 > 0, w, 0.0)


@full_precision
def _expv_error_estimate(op, b, t, m: int, atol: float, rtol: float,
                         comm=None):
    """Hermitian Lanczos expv stopped by Saad's Er2 a-posteriori estimate
    sigma = beta_j beta0 |e_j^T exp(t T_j) e1| < atol + rtol beta0.

    A host loop: each Lanczos step reads its stop flag to the host (one
    sync per step), where the JAX package keeps the loop on the device.
    ``comm``: b's rows are sharded (the flag comes from reduced scalars,
    the same on every rank). Returns (w, iterations)."""
    n = b.shape[0]
    dt = b.dtype
    rdt = torch.empty((), dtype=dt).real.dtype
    beta0 = vector_norm(b, comm).to(rdt)
    eps = atol + rtol * beta0
    v0 = torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0),
                     0.0).to(rdt) * b
    V = torch.zeros((m + 1, n), dtype=dt, device=b.device)
    V[0] = v0
    alphas = torch.zeros(m, dtype=rdt, device=b.device)
    betas = torch.zeros(m, dtype=rdt, device=b.device)
    ev = torch.zeros(m, dtype=torch.promote_types(rdt, _t_dtype(t)),
                     device=b.device)
    idx = torch.arange(m, device=b.device)
    j = 0
    done = bool(beta0 == 0)
    while j < m and not done:
        x = V[j]
        y = op.matvec(x).to(dt)
        alpha = vdot(x, y, comm).real.to(rdt)
        y = y - alpha * x
        if j >= 1:
            y = y - betas[j - 1] * V[j - 1]
        nrm = vector_norm(y, comm).to(rdt)
        alphas[j] = alpha
        betas[j] = nrm
        V[j + 1] = torch.where(nrm > 0, y / torch.where(nrm > 0, nrm, 1.0), 0)
        # exp(t T_j) e1 of the leading (j+1)-block; the zero tail of the
        # masked tridiagonal is block-diagonal and not excited by e1
        a = torch.where(idx <= j, alphas, 0.0)
        bb = torch.where(idx < j, betas, 0.0)
        T = torch.diag(a) + torch.diag(bb[:-1], 1) + torch.diag(bb[:-1], -1)
        w_eig, Q = torch.linalg.eigh(T)
        ev = Q.to(ev.dtype) @ (torch.exp(t * w_eig) * Q[0, :])
        sigma = nrm * beta0 * ev[j].abs()
        j += 1
        done = bool(sigma < eps)
    wdt = torch.promote_types(ev.dtype, dt)
    w = ev.to(wdt) @ V[:m].to(wdt)
    out = beta0.to(w.dtype) * w
    return torch.where(beta0 > 0, out, 0.0), j


def expv(t, A, b, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
         mode: str = "happy_breakdown", reorth: bool = True,
         hermitian: bool | None = None, atol: float = 1e-8,
         rtol: float | None = None, reduced: str | None = None,
         two_pass: bool = False, return_info: bool = False,
         differentiable: bool = False):
    """exp(tA) b by a Krylov approximation (module doc).

    t: real or complex scalar. A: operator or square matrix. b: (n,).
    m: Krylov dimension (capped at n). tol: happy-breakdown threshold.
    iop: incomplete-orthogonalization window of the Arnoldi path (0 =
      full); reorth: CGS2 there.
    mode: "happy_breakdown" or "error_estimate" (Hermitian only; stops
      when Saad's estimate is below atol + rtol |b|, rtol default
      sqrt(tol); ``return_info=True`` also returns the iterations taken).
    two_pass: the storage-free two-pass forms (module doc), which pick the
      CUDA kernels for real float32/float64 data and real t on a CUDA
      device when the operator is a supported stencil and the grad rule
      lets the call through; non-Hermitian operators need ``iop > 0``
      there.
    reduced: "device", "host" or None (the default, "device"): where the
      m-sized reduced problem is evaluated (module doc).
    differentiable: the reduced exponential's form with no host read
      (module doc).
    """
    reduced = _reduced_where(reduced, differentiable, mode)
    op = aslinearoperator(A)
    b = action_vector(b, op)
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # degree-sorted conjugated container: the whole solve runs in the
        # sorted basis (exp commutes with the conjugation)
        out = expv(t, op, b, m=m, tol=tol, iop=iop, mode=mode, reorth=reorth,
                   hermitian=hermitian, atol=atol, rtol=rtol, reduced=reduced,
                   two_pass=two_pass, return_info=return_info,
                   differentiable=differentiable)
        if return_info and isinstance(out, tuple):
            return (post(out[0]),) + out[1:]
        return post(out)
    m = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian
    if mode == "error_estimate":
        if not herm:
            raise NotImplementedError(
                "error_estimate mode requires a Hermitian operator")
        rtol = tol ** 0.5 if rtol is None else rtol
        w, iters = _expv_error_estimate(op, b, t, m, atol, rtol,
                                        operator_comm(op))
        return (w, iters) if return_info else w
    if mode != "happy_breakdown":
        raise ValueError(f"unknown expv mode {mode!r}")
    if not two_pass:
        return expv_from_basis(t, build_subspace(op, b, m, tol=tol, iop=iop,
                                                 reorth=reorth,
                                                 hermitian=herm),
                               reduced=reduced,
                               differentiable=differentiable)
    if not herm:
        if iop <= 0:
            raise ValueError(
                "non-Hermitian two_pass expv requires an IOP window "
                "(iop > 0): the rolling-window recurrence is what makes the "
                "replay storage-free")
        return _expv_two_pass_arnoldi(op, b, t, m, iop, differentiable,
                                      reduced)
    from ..ops.kernels.lanczos_fused import fused_supported
    from ..ops.kernels.resident import (expv_two_pass_resident,
                                        resident_supported)

    # the kernels replay with real coefficients: complex t keeps the
    # plain path, whose coefficients promote to complex; the grad rule
    # (ops/kernels/dispatch.py) sends a call that autograd must see there
    kernels = (kernel_device_ok(b.dtype, b.device)
               and not torch.as_tensor(t).is_complex()
               and (resident_supported(op)
                    or fused_supported(op, hermitian=True))
               and not grad_gate(op, (b, t)))
    if kernels and resident_supported(op):
        return expv_two_pass_resident(op, b, t, m, tol=tol, reduced=reduced)
    if kernels and fused_supported(op, hermitian=True):
        return _expv_two_pass_fused(op, b, t, m, tol=tol, reduced=reduced)
    return _expv_two_pass(op, b, t, m, reduced)


def make_expv(op, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
              reorth: bool = True, hermitian: bool | None = None,
              bake_operator: bool = False):
    """Serving factory: ``fn(t, b)`` with the operator and the Krylov
    settings bound once (a plain closure over ``build_subspace`` and the
    reduced exponential).

    bake_operator: accepted for the JAX package's signature and changes
      nothing. There it embeds the operator's arrays in the compiled
      program as constants; nothing is compiled here, and the closure
      over ``op`` already holds its tensors, as baking does."""
    op = aslinearoperator(op)
    m_ = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian

    def fn(t, b):
        Ks = build_subspace(op, action_vector(b, op), m_, tol=tol, iop=iop,
                            reorth=reorth, hermitian=herm)
        return _combine_expv(Ks, _exp_reduced_e1(Ks, t))

    return fn


def expv_batched(t, A, B, *, m: int = 30, tol: float = 1e-7,
                 hermitian: bool | None = None, reduced: str | None = None,
                 two_pass: bool = False, iop: int = 0, reorth: bool = True):
    """exp(tA) b_i for each row b_i of B (batch, n): one Krylov subspace per
    row, each through ``expv`` (module doc), so each column takes its scalar
    call's path and kernels. With a row-sharded operator B holds this
    rank's columns of each row (and, on a data x shard mesh, only its
    data slice of the rows): the reductions run over the operator's axis
    alone. Returns (batch, n). ``reduced``: as in ``expv`` (each row's
    reduced problem on the host with "host")."""
    reduced = _reduced_where(reduced)
    op = aslinearoperator(A)
    B = action_vector(B, op)
    if B.ndim != 2:
        raise ValueError(f"expv_batched takes B as (batch, n), got "
                         f"{tuple(B.shape)}")
    return torch.stack([
        expv(t, op, b, m=m, tol=tol, hermitian=hermitian, iop=iop,
             reorth=reorth, reduced=reduced, two_pass=two_pass)
        for b in B.unbind(0)])

"""Krylov phi-function actions ``phiv(t, A, b, k) ~ [phi_0(tA)b ... phi_k(tA)b]``
(PyTorch port of ``exponentialutilities_jl_tpu/models/phiv.py``).

The Lanczos (Hermitian) or Arnoldi (general) basis reduces the problem to
``phiv_dense`` on the masked t H_m (the (m+k)^2 augmented-matrix
exponential); the basis combination
is one matrix product, optionally with the Niesen-Wright correction by
the last basis vector (formula (10) of arXiv:0907.4631), and the
a-posteriori error estimate |beta h_{m+1,m} t C2[last, k]| comes with it.

``two_pass=True`` is the storage-free form: pass 1 records (alpha, beta),
the reduced augmented exponential gives one combination column per
order, pass 2 regenerates the basis and accumulates all k+1 columns. On a
CUDA device with real float32/float64 data and real t, a 1-D constant
stencil whose k+1 columns pass ``resident_multi_ok`` runs pass 1 in B2
and pass 2 in one launch of B4 (``phiv_two_pass_resident``); everything
else takes the plain torch passes.

``differentiable=True`` makes the reduced augmented exponential the form
with no host read (``phiv_dense(differentiable=True)``), for ``torch.func``
transforms; plain ``torch.autograd`` differentiates every path, the
two-pass one through the grad rule of ``ops/kernels/dispatch.py``.
``reduced="host"`` evaluates the reduced augmented exponential with scipy
on the host in float64/complex128 (``ops/host_reduced.py``, as in
``models/expv.py``: one read and one write per reduced problem, refused
with ``differentiable``); ``two_pass=True`` is Hermitian only, as in the
JAX package. A ``SortedSellOperator`` is unwrapped on entry
(``hoist_conjugation``), as in the JAX ``phiv``: the solve runs in the
sorted basis and only the result is permuted back. A numpy ``b`` goes to
the operator's device. A row-sharded operator (``parallel.shard_operator``)
runs the plain paths on this rank's rows, as in ``models/expv.py``.
"""

from __future__ import annotations

import torch

from ..ops.expm import _onenorm
from ..ops.host_reduced import host_phiv_e1
from ..ops.kernels.tridiag import scalar_operand
from ..ops.krylov import KrylovBasis
from ..ops.phi_dense import phiv_dense
from ..ops.sparse import hoist_conjugation
from ..utils import graphs
from ..utils.device import action_vector
from ..utils.linop import aslinearoperator
from ..utils.precision import full_precision
from .expv import _reduced_where, _serving_closure, build_subspace

__all__ = ["phiv", "phiv_from_basis", "make_phiv"]


def _row(x, i):
    """x[i] for a 0-d index tensor ``i`` on x's device, without the host
    read that indexing by a 0-d tensor makes."""
    return x.index_select(0, i.reshape(1).long())[0]


@full_precision
def _phiv_combine(t, Ks: KrylovBasis, C2, k: int, correct: bool):
    """(w (n, k+1), err) from the (m, k+1) reduced phi columns C2: basis
    combination, optional correction and the error estimate. No host
    read."""
    m = Ks.m
    dt = torch.promote_types(C2.dtype, Ks.V.dtype)
    C2 = C2.to(dt)
    beta = Ks.beta.to(dt)
    w = (Ks.V[:m].to(dt).T @ C2) * beta
    # the last effective row: the residual beta is H[m_used, m_used - 1]
    # and C2's row is m_used - 1
    last = torch.clamp_min(Ks.m_used - 1, 0)
    c_last = _row(C2, last)                             # (k+1,)
    betah = beta * _row(_row(Ks.H, last + 1), last).to(dt) * t
    if correct and k >= 1:
        # w[:, i] += beta h C2[last, i+1] v_last for i < k (Niesen-Wright)
        vlast = _row(Ks.V, Ks.m_used).to(dt)
        coeffs = torch.cat([c_last[1:], torch.zeros_like(c_last[:1])]) * betah
        w = w + vlast[:, None] * coeffs[None, :]
    err = torch.abs(betah * c_last[k])
    live = Ks.beta > 0
    return torch.where(live, w, 0.0), torch.where(live, err, 0.0)


def phiv_from_basis(t, Ks: KrylovBasis, k: int, *, correct: bool = False,
                    reduced: str = "device", differentiable: bool = False):
    """(w, err) from a prebuilt Lanczos or Arnoldi basis: w the (n, k+1)
    matrix of phi_j(tA)b columns, err the error estimate of phi_k
    (``reduced``, ``differentiable``: module doc)."""
    reduced = _reduced_where(reduced, differentiable)
    m = Ks.m
    hnorm = None
    if (reduced == "device" and not differentiable
            and graphs.inline(Ks.H.device)):
        # a step that may be captured (a serving program's call): the
        # norm on the device, so the exponential reads nothing
        t = scalar_operand(t, Ks.H.real)
        hnorm = _onenorm(Ks.H[:m, :m])
    return _phiv_combine(t, Ks, _reduced_phi(
        t, Ks.H, k, hnorm=hnorm, differentiable=differentiable,
        reduced=reduced), k, correct)


def _reduced_phi(t, H, k: int, *, expm_method: str = "higham2005",
                hnorm: float | None = None, differentiable: bool = False,
                reduced: str = "device"):
    """The (m, k+1) reduced phi columns phi_j(t H_m) e1 of an (m+1, m)
    Hessenberg H (``phiv_dense`` on the augmented matrix, or host scipy
    with ``reduced="host"``). ``hnorm``: the 1-norm of H_m on the host,
    which spares the exponential its read (the augmented matrix's 1-norm
    is max(|t| hnorm, 1)). A 0-d tensor ``t`` with a 0-d tensor ``hnorm``
    makes no host read at all (the exponential's device form: the loop
    steps of ``models/nw_device.py``, a serving program's call); a real t
    then scales H in H's real dtype, a complex one in the promoted
    type."""
    m = H.shape[1]
    if reduced == "host":
        return host_phiv_e1(H[:m, :m], t, k)
    if isinstance(hnorm, torch.Tensor):
        t_h = t.to(torch.promote_types(H.dtype, t.dtype) if t.is_complex()
                   else H.real.dtype)
        Hm = t_h * H[:m, :m]
        e1 = torch.eye(m, dtype=Hm.dtype, device=Hm.device)[0]
        nrm = t.abs().to(torch.float64) * hnorm.to(torch.float64)
        return phiv_dense(Hm, e1, k, expm_method=expm_method,
                          onenorm=torch.clamp_min(nrm, 1.0) if k else nrm)
    dt = torch.promote_types(H.dtype, torch.as_tensor(t).dtype)
    Hm = t * H[:m, :m].to(dt)
    e1 = torch.eye(m, dtype=dt, device=Hm.device)[0]
    onenorm = (None if hnorm is None
               else max(abs(t) * hnorm, 1.0) if k else abs(t) * hnorm)
    return phiv_dense(Hm, e1, k, expm_method=expm_method, onenorm=onenorm,
                      differentiable=differentiable)


def make_phiv(op, k: int, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
              reorth: bool = True, hermitian: bool | None = None,
              correct: bool = False):
    """Serving factory: ``fn(t, b) -> (w, err)`` with the operator, order
    and Krylov settings bound once, each call one program
    (``utils/graphs.Program``, as ``models/expv.make_expv``; the JAX
    package's jitted ``_phiv_fused``), its reduced augmented exponential
    with no host read. Like ``make_expv``'s, the closure follows the
    operator's current storage: a call after it is reassigned or changed
    in place runs eagerly and the next one is captured anew.
    ``fn.close()`` frees the graphs."""
    op = aslinearoperator(op)
    m_ = min(m, op.shape[0])

    def call(t, b):
        Ks = build_subspace(op, b, m_, tol=tol, iop=iop, reorth=reorth,
                            hermitian=hermitian)
        return phiv_from_basis(t, Ks, k, correct=correct)

    return _serving_closure("make_phiv", op, call)


def phiv(t, A, b, k: int, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
         correct: bool = False, errest: bool = False, reorth: bool = True,
         hermitian: bool | None = None, reduced: str | None = None,
         two_pass: bool = False, differentiable: bool = False):
    """[phi_0(tA)b ... phi_k(tA)b] by a Krylov approximation: the (n, k+1)
    matrix, or (w, err) when ``errest=True``.

    correct: the Niesen-Wright correction of the first k columns.
    iop, reorth: the Arnoldi window and CGS2 of a non-Hermitian operator.
    two_pass: the storage-free two-pass Lanczos (module doc; Hermitian
      only), which picks the CUDA kernels B2 and B4 for a 1-D constant
      stencil when the grad rule lets the call through.
    reduced: "device", "host" or None (the default, "device"): where the
      reduced augmented exponential is evaluated (module doc).
    differentiable: the reduced exponential's form with no host read
      (module doc).
    """
    reduced = _reduced_where(reduced, differentiable)
    op = aslinearoperator(A)
    b = action_vector(b, op)
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # sorted-conjugated container: solve in the sorted basis (every
        # phi_k commutes with the conjugation)
        out = phiv(t, op, b, k, m=m, tol=tol, iop=iop, correct=correct,
                   errest=errest, reorth=reorth, hermitian=hermitian,
                   reduced=reduced, two_pass=two_pass,
                   differentiable=differentiable)
        return (post(out[0]), out[1]) if errest else post(out)
    m = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian
    if not two_pass:
        Ks = build_subspace(op, b, m, tol=tol, iop=iop, reorth=reorth,
                            hermitian=herm)
        w, err = phiv_from_basis(t, Ks, k, correct=correct, reduced=reduced,
                                 differentiable=differentiable)
    elif not herm:
        raise NotImplementedError(
            "two_pass phiv requires a Hermitian operator (Lanczos)")
    else:
        from ..ops.kernels.dispatch import resident_multi_ok
        from ..ops.kernels.resident import phiv_two_pass_resident

        # the kernels replay with real coefficients: complex t keeps the
        # plain passes
        if (not torch.as_tensor(t).is_complex()
                and resident_multi_ok(op, b.dtype, b.device, k + 1,
                                      (b, t))):
            w, err = phiv_two_pass_resident(op, b, t, m, k, tol=tol,
                                            reduced=reduced)
        else:
            w, err = _phiv_two_pass(op, b, t, m, k, differentiable, reduced)
    return (w, err) if errest else w


def _two_pass_reduced(alphas, betas, beta0, m_used, t, k: int, dt,
                      differentiable: bool = False, reduced: str = "device"):
    """Reduced stage of every two-pass phiv: (C2, err) with C2 (m, k+1)
    the phi columns of the recorded tridiagonal t T (``phiv_dense``, or
    host scipy with ``reduced="host"``) and err the error estimate
    |beta0 h t C2[last, k]|."""
    m = alphas.shape[0]
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1)).to(dt)
    if reduced == "host":
        C2 = host_phiv_e1(T, t, k, dt)
    else:
        e1 = torch.eye(m, dtype=dt, device=T.device)[0]
        C2 = phiv_dense(t * T, e1, k, differentiable=differentiable)
    last = torch.clamp_min(m_used - 1, 0)
    h_res = torch.where(m_used < m, betas[torch.clamp_max(m_used, m - 1)],
                        betas[m - 1]).to(dt)
    return C2, torch.abs(beta0.to(dt) * h_res * t * C2[last, k])


@full_precision
def _phiv_two_pass(op, b, t, m: int, k: int, differentiable: bool = False,
                   reduced: str = "device"):
    """Storage-free Hermitian phi-actions on the plain torch passes
    (``ops.krylov.lanczos_coeffs`` / ``lanczos_replay``): (w (n, k+1),
    err) without the (m+1, n) basis."""
    from ..ops.krylov import lanczos_coeffs, lanczos_replay

    alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, b, m)
    dt = torch.promote_types(b.dtype, torch.as_tensor(t).dtype)
    C2, err = _two_pass_reduced(alphas, betas, beta0, m_used, t, k, dt,
                                differentiable, reduced)
    w = lanczos_replay(op, b, C2 * beta0.to(dt), alphas, betas, m)
    live = beta0 > 0
    return torch.where(live, w, 0.0), torch.where(live, err, 0.0)

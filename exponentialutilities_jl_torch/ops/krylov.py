"""Krylov subspaces with breakdown kept as data: Lanczos for Hermitian
operators, Arnoldi for general ones (PyTorch port of
``exponentialutilities_jl_tpu/ops/krylov.py``).

V and H keep their full (m+1, .) shapes after a happy breakdown; the
trailing basis rows and coefficients are zero and ``m_used`` /
``breakdown`` record the effective dimension, so the downstream reduced
problem is exact without any data-dependent shapes (and without a host
sync inside the loop).

Arnoldi orthogonalizes by classical Gram-Schmidt with batched dots (one
GEMV for the projections, CGS2 with ``reorth``), over the last ``iop``
basis vectors (incomplete orthogonalization) or all of them (iop = 0).
The step index is a Python int here, so each step reads only the rows of
its window that already exist (the JAX loop masks a fixed-shape window);
the basis and Hessenberg buffers are filled in place.

``lanczos_coeffs`` / ``lanczos_replay`` and ``arnoldi_coeffs`` /
``arnoldi_replay`` are the storage-free pairs: pass 1 records the
recurrence (alpha, beta; or the compact Hessenberg of an IOP window)
without keeping the basis, pass 2 regenerates each basis vector from the
record and accumulates w = sum_j coeffs[j] v_j.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.comm import dots, operator_comm, vdot, vector_norm
from ..utils.precision import full_precision

__all__ = ["KrylovBasis", "arnoldi", "arnoldi_extend", "lanczos",
           "lanczos_coeffs", "lanczos_replay", "arnoldi_coeffs",
           "arnoldi_replay", "expand_compact_hessenberg"]


@dataclasses.dataclass
class KrylovBasis:
    """Result of an Arnoldi or Lanczos factorization.

    V: (m+1, n) orthonormal basis, basis vectors as rows (zero past
       m_used after a happy breakdown).
    H: (m+1, m) Hessenberg (Arnoldi, in b's dtype) or real
       symmetric-tridiagonal-extended (Lanczos) matrix.
    beta: |b|_2 of the starting vector (0-d tensor).
    m_used: effective dimension (0-d int32 tensor).
    breakdown: whether a happy breakdown occurred (0-d bool tensor).
    hermitian: H is tridiagonal from a Lanczos recurrence.
    """

    V: torch.Tensor
    H: torch.Tensor
    beta: torch.Tensor
    m_used: torch.Tensor
    breakdown: torch.Tensor
    hermitian: bool = False

    @property
    def m(self) -> int:
        return self.H.shape[1]

    @property
    def n(self) -> int:
        return self.V.shape[1]


def _real_dtype(dt):
    return torch.empty((), dtype=dt).real.dtype


def _start(b, comm=None):
    """(beta0, v0): |b| and b/|b| (zero vector when b = 0)."""
    rdt = _real_dtype(b.dtype)
    beta0 = vector_norm(b, comm).to(rdt)
    inv = torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0), 0.0)
    return beta0, (inv * b).to(b.dtype)


def _safe_normalize(y, nrm):
    return y / torch.where(nrm > 0, nrm, 1.0)


def _arnoldi_step(op, V, H, j: int, win: int, tol: float, reorth: bool,
                  broke, m_used, comm=None):
    """Arnoldi step j on the basis rows ``V`` and Hessenberg ``H`` (both
    written in place): CGS (CGS2 with ``reorth``) against the window rows
    max(0, j - win + 1) .. j. Returns (broke, m_used). With ``comm`` (a
    ``parallel.MeshAxis``) V holds this rank's rows, and each CGS pass and
    the norm cost one psum."""
    rdt = _real_dtype(V.dtype)
    lo = max(0, j - win + 1)
    Vw, vj = V[lo:j + 1], V[j]
    if V.requires_grad:
        # the later steps write V in place: autograd must save copies
        Vw, vj = Vw.clone(), vj.clone()
    y = op.matvec(vj).to(V.dtype)
    h = dots(Vw, y, comm)
    y = y - h @ Vw
    if reorth:
        h2 = dots(Vw, y, comm)
        y = y - h2 @ Vw
        h = h + h2
    nrm = vector_norm(y, comm).to(rdt)
    now_broke = nrm < tol
    active = ~broke
    H[lo:j + 1, j] = torch.where(active, h, 0)
    H[j + 1, j] = torch.where(active, nrm, 0).to(H.dtype)
    V[j + 1] = torch.where(active & ~now_broke, _safe_normalize(y, nrm), 0.0)
    m_used = torch.where(active, j + 1, m_used).to(torch.int32)
    return broke | now_broke, m_used


@full_precision
def arnoldi(op, b, m: int, *, iop: int = 0, tol: float = 1e-7,
            reorth: bool = True) -> KrylovBasis:
    """Arnoldi factorization A V[j] ~ sum_i H[i, j] V[i] with (incomplete)
    classical Gram-Schmidt (module doc).

    iop: incomplete-orthogonalization window; 0 = full.
    tol: happy-breakdown threshold on the residual norm.
    reorth: a second CGS pass (CGS2); False for the cheapest (IOP-style)
      iteration.

    A row-sharded ``op`` (one that carries ``comm``, the
    ``parallel.MeshAxis`` of its rows: ``utils.comm.operator_comm``) takes
    this rank's rows of b, and the basis holds this rank's rows; each CGS
    pass and each norm then costs one psum. Every builder below reads the
    axis from its operator the same way."""
    comm = operator_comm(op)
    n = b.shape[0]
    beta, v0 = _start(b, comm)
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    V[0] = v0
    H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
    win = m if iop == 0 else iop
    broke = beta == 0
    m_used = torch.zeros((), dtype=torch.int32, device=b.device)
    for j in range(m):
        broke, m_used = _arnoldi_step(op, V, H, j, win, tol, reorth, broke,
                                      m_used, comm)
    m_used = torch.where(beta == 0, 0, m_used).to(torch.int32)
    return KrylovBasis(V=V, H=H, beta=beta, m_used=m_used, breakdown=broke,
                       hermitian=False)


@full_precision
def arnoldi_extend(op, Ks: KrylovBasis, m_new: int, *, iop: int = 0,
                   tol: float = 1e-7, reorth: bool = True) -> KrylovBasis:
    """Extend an Arnoldi factorization from m to ``m_new`` without
    repeating the first m matvecs: the kept rows and entries are copied
    into the larger buffers and the iteration continues from step m."""
    comm = operator_comm(op)
    m_old = Ks.m
    if m_new <= m_old:
        raise ValueError(f"m_new={m_new} must exceed current m={m_old}")
    if Ks.hermitian:
        raise ValueError("arnoldi_extend requires an Arnoldi (non-Lanczos) "
                         "basis")
    V = torch.zeros((m_new + 1, Ks.n), dtype=Ks.V.dtype, device=Ks.V.device)
    V[:m_old + 1] = Ks.V
    H = torch.zeros((m_new + 1, m_new), dtype=Ks.H.dtype, device=Ks.H.device)
    H[:m_old + 1, :m_old] = Ks.H
    win = m_new if iop == 0 else iop
    broke, m_used = Ks.breakdown, Ks.m_used
    for j in range(m_old, m_new):
        broke, m_used = _arnoldi_step(op, V, H, j, win, tol, reorth, broke,
                                      m_used, comm)
    return KrylovBasis(V=V, H=H, beta=Ks.beta, m_used=m_used, breakdown=broke,
                       hermitian=False)


@full_precision
def lanczos(op, b, m: int, *, tol: float = 1e-7,
            full_reorth: bool = False) -> KrylovBasis:
    """Hermitian Lanczos three-term recurrence. H is real (alpha on the
    diagonal, beta on the sub- and superdiagonal). ``full_reorth=True``
    re-orthogonalizes each step against the whole basis (one GEMV).
    A sharded ``op`` (``arnoldi``): a psum for alpha and one for the norm
    per step, one more with ``full_reorth``."""
    comm = operator_comm(op)
    n = b.shape[0]
    dt = b.dtype
    rdt = _real_dtype(dt)
    beta0, v0 = _start(b, comm)
    V = torch.zeros((m + 1, n), dtype=dt, device=b.device)
    V[0] = v0
    alphas = torch.zeros(m, dtype=rdt, device=b.device)
    betas = torch.zeros(m, dtype=rdt, device=b.device)
    rows = torch.arange(m + 1, device=b.device)
    vp, vc = torch.zeros_like(v0), v0
    bprev = torch.zeros((), dtype=rdt, device=b.device)
    broke = beta0 == 0
    m_used = torch.zeros((), dtype=torch.int32, device=b.device)
    for j in range(m):
        y = op.matvec(vc)
        alpha = vdot(vc, y, comm).real.to(rdt)
        y = y - alpha * vc
        y = y - bprev * vp
        if full_reorth:
            h2 = torch.where(rows <= j, dots(V, y, comm), 0)
            y = y - h2 @ V
        nrm = vector_norm(y, comm).to(rdt)
        now_broke = nrm < tol
        active = ~broke
        beta = torch.where(active, nrm, 0.0)
        alphas[j] = torch.where(active, alpha, 0.0)
        betas[j] = beta
        vnext = torch.where(active & ~now_broke, _safe_normalize(y, nrm), 0.0)
        V[j + 1] = vnext
        m_used = torch.where(active, j + 1, m_used).to(torch.int32)
        # beta, not the view betas[j]: the next step writes betas in place,
        # which would void the view that autograd saved
        vp, vc, bprev, broke = vc, vnext, beta, broke | now_broke
    m_used = torch.where(beta0 == 0, 0, m_used).to(torch.int32)

    H = torch.zeros((m + 1, m), dtype=rdt, device=b.device)
    di = torch.arange(m, device=b.device)
    H[di, di] = alphas
    H[di + 1, di] = betas
    if m >= 2:
        H[di[:-1], di[:-1] + 1] = betas[:-1]
    return KrylovBasis(V=V, H=H, beta=beta0, m_used=m_used, breakdown=broke,
                       hermitian=True)


@full_precision
def lanczos_coeffs(op, b, m: int, *, tol: float = 1e-7):
    """Pass 1 of storage-free Lanczos: (alphas, betas, beta0, m_used,
    breakdown) without keeping the basis. A sharded ``op``: as in
    ``lanczos``."""
    comm = operator_comm(op)
    dt = b.dtype
    rdt = _real_dtype(dt)
    beta0, v0 = _start(b, comm)
    vp, vc = torch.zeros_like(v0), v0
    bprev = torch.zeros((), dtype=rdt, device=b.device)
    broke = beta0 == 0
    m_used = torch.zeros((), dtype=torch.int32, device=b.device)
    alphas, betas = [], []
    for j in range(m):
        y = op.matvec(vc)
        alpha = vdot(vc, y, comm).real.to(rdt)
        y = y - alpha * vc - bprev * vp
        nrm = vector_norm(y, comm).to(rdt)
        now_broke = nrm < tol
        active = ~broke
        vnext = torch.where(active & ~now_broke, _safe_normalize(y, nrm), 0.0)
        m_used = torch.where(active, j + 1, m_used).to(torch.int32)
        alphas.append(torch.where(active, alpha, 0.0))
        betas.append(torch.where(active, nrm, 0.0))
        vp, vc, bprev, broke = vc, vnext, betas[-1], broke | now_broke
    m_used = torch.where(beta0 == 0, 0, m_used).to(torch.int32)
    empty = torch.zeros(0, dtype=rdt, device=b.device)
    return (torch.stack(alphas) if m else empty,
            torch.stack(betas) if m else empty, beta0, m_used, broke)


@full_precision
def lanczos_replay(op, b, coeffs, alphas, betas, m: int):
    """Pass 2 of storage-free Lanczos: w = sum_j coeffs[j] v_j, each v_j
    regenerated from the recorded (alpha, beta) by the same recurrence as
    pass 1. ``coeffs`` (m,) gives w (n,); (m, p) gives w (n, p).
    A sharded ``op``: one psum, the norm of b."""
    comm = operator_comm(op)
    dt = b.dtype
    rdt = _real_dtype(dt)
    _, v0 = _start(b, comm)
    # the common type of the basis and the coefficients: a complex b
    # with real coefficients keeps its imaginary part
    cdt = torch.promote_types(coeffs.dtype, dt)
    coeffs = coeffs.to(cdt)
    vp, vc = torch.zeros_like(v0), v0
    if coeffs.ndim == 1:
        w = torch.zeros(v0.shape, dtype=cdt, device=b.device)
    else:
        w = torch.zeros(v0.shape + coeffs.shape[1:], dtype=cdt,
                        device=b.device)
    for j in range(m):
        if coeffs.ndim == 1:
            w = w + coeffs[j] * vc.to(cdt)
        else:
            w = w + vc.to(cdt)[:, None] * coeffs[j][None, :]
        y = op.matvec(vc)
        y = y - alphas[j].to(rdt) * vc
        if j >= 1:
            y = y - betas[j - 1].to(rdt) * vp
        vnext = torch.where(betas[j] > 0, _safe_normalize(y, betas[j]), 0.0)
        vp, vc = vc, vnext
    return w


def _window_rows(W, j: int):
    """The rows of the rolling window that hold basis vectors at step j
    (the oldest win - j - 1 rows are still the zero start rows)."""
    win = W.shape[0]
    return W[win - min(j + 1, win):]


@full_precision
def arnoldi_coeffs(op, b, m: int, win: int, *, tol: float = 1e-7):
    """Pass 1 of storage-free IOP Arnoldi: the compact Hessenberg without
    the basis. The IOP recurrence only reads the last ``win`` basis
    vectors, so the loop keeps a (win, n) rolling window.

    Returns (Hc, beta0, m_used, breakdown) with Hc (m, win+1) compact
    columns: Hc[j, :win] the projections onto the window rows (oldest to
    newest) and Hc[j, win] = h_{j+1, j}. A sharded ``op``: as in
    ``arnoldi``."""
    comm = operator_comm(op)
    n = b.shape[0]
    dt = b.dtype
    rdt = _real_dtype(dt)
    beta0, v0 = _start(b, comm)
    W = torch.zeros((win, n), dtype=dt, device=b.device)
    W[-1] = v0
    Hc = torch.zeros((m, win + 1), dtype=dt, device=b.device)
    broke = beta0 == 0
    m_used = torch.zeros((), dtype=torch.int32, device=b.device)
    for j in range(m):
        Wv = _window_rows(W, j)
        y = op.matvec(W[-1]).to(dt)
        h = dots(Wv, y, comm)
        y = y - h @ Wv
        nrm = vector_norm(y, comm).to(rdt)
        now_broke = nrm < tol
        active = ~broke
        vnext = torch.where(active & ~now_broke, _safe_normalize(y, nrm), 0.0)
        Hc[j, win - Wv.shape[0]:win] = torch.where(active, h, 0)
        Hc[j, win] = torch.where(active, nrm, 0).to(dt)
        W = torch.cat([W[1:], vnext[None]])
        m_used = torch.where(active, j + 1, m_used).to(torch.int32)
        broke = broke | now_broke
    m_used = torch.where(beta0 == 0, 0, m_used).to(torch.int32)
    return Hc, beta0, m_used, broke


def expand_compact_hessenberg(Hc, win: int):
    """(m, win+1) compact columns to the full (m+1, m) banded Hessenberg."""
    m = Hc.shape[0]
    H = torch.zeros((m + 1, m), dtype=Hc.dtype, device=Hc.device)
    for j in range(m):
        lo = max(0, j - win + 1)
        H[lo:j + 1, j] = Hc[j, win - (j + 1 - lo):win]
        H[j + 1, j] = Hc[j, win]
    return H


@full_precision
def arnoldi_replay(op, b, coeffs, Hc, m: int, win: int, *, final_coeff=None,
                   with_final: bool = False):
    """Pass 2: w = sum_j coeffs[j] v_j, regenerating the IOP basis from the
    recorded compact Hessenberg by the same recurrence as pass 1. coeffs
    (m,) or (m, p). With ``with_final=True``, ``final_coeff`` also weights
    the (m+1)-th vector v_m. A sharded ``op``: one psum, the norm of b."""
    comm = operator_comm(op)
    n = b.shape[0]
    dt = b.dtype
    rdt = _real_dtype(dt)
    _, v0 = _start(b, comm)
    W = torch.zeros((win, n), dtype=dt, device=b.device)
    W[-1] = v0
    cdt = torch.promote_types(coeffs.dtype, dt)
    coeffs = coeffs.to(cdt)

    def accum(w, vc, cj):
        if coeffs.ndim == 1:
            return w + cj * vc.to(cdt)
        return w + vc.to(cdt)[:, None] * cj[None, :]

    w = torch.zeros((n,) + tuple(coeffs.shape[1:]), dtype=cdt,
                    device=b.device)
    for j in range(m):
        w = accum(w, W[-1], coeffs[j])
        Wv = _window_rows(W, j)
        y = op.matvec(W[-1]).to(dt)
        y = y - Hc[j, win - Wv.shape[0]:win] @ Wv
        nrm = Hc[j, win].real.to(rdt)
        vnext = torch.where(nrm > 0, _safe_normalize(y, nrm), 0.0)
        W = torch.cat([W[1:], vnext[None]])
    if with_final:
        w = accum(w, W[-1], torch.as_tensor(final_coeff, dtype=cdt,
                                             device=b.device))
    return w

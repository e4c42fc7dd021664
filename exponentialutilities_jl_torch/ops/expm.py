"""Dense matrix exponential (PyTorch port of
``exponentialutilities_jl_tpu/ops/expm.py``).

* ``expm_higham2005``: Higham (2005) degree-{3,5,7,9,13} Pade with the
  degree chosen from the 1-norm (degree 7 at most in single precision),
  one LU solve and s squarings; ``balance=True`` wraps it in
  power-of-two Osborne balancing (``balance_matrix``).
* ``expm_higham2005_batched``: a (..., n, n) stack with one degree and one
  squaring count from the batch's largest 1-norm: one Pade branch of
  batched products and s unmasked batched squarings.
* ``expm_taylor``: a solver-free Paterson-Stockmeyer Taylor kernel with
  the order chosen so the series tail is below the dtype's unit roundoff
  at a scaled 1-norm of at most 1.
* ``expm_generic``: diagonal Pade of the order the dtype's precision
  needs (``pade_order_for_eps``), at a scaled 1-norm of at most 1/2.
* ``expm_diagonalization``: ``torch.linalg.eigh`` for Hermitian input,
  ``torch.linalg.eig`` otherwise, on the input's device.
* ``expm_native``: ``torch.linalg.matrix_exp``.
* ``gebal`` / ``expm_gebal``: LAPACK ``?gebal``'s permutation (on the
  host, from the nonzero pattern) and the windowed balancing, then the
  Pade exponential and the exact undo; ``expm(A, method="schur")`` is
  ``funm(A, "exp")`` (ops/funm.py). Both are host-staged: under a
  ``torch.func`` transform they raise.

The JAX package picks the Pade degree and the squaring count on the
device (``lax.switch``, a dynamic loop). Here torch runs eagerly, and by
default the 1-norm is read to the host once per call (one device sync;
none when the caller passes it as ``onenorm``): the degree and the
squaring count become Python values, so exactly one Pade branch and s
matrix products run. ``differentiable=True`` is the form with no host
read, for ``torch.func`` transforms (grad, jacrev, vmap) and sync-free
callers: the degree is picked on the device (every branch's U and V are
formed, one is selected, one solve runs) and the squarings are masked up
to ``max_squarings``, as the JAX package's ``_masked_squaring`` is. The
solves are ``torch.linalg.solve_ex`` (no singularity check, so no sync; a
singular denominator gives non-finite values), in the differentiable
form a product with ``inv_ex`` (whose backward makes no sync under
``torch.func.grad``). Plain
``torch.autograd`` differentiates either form. Powers of two (the scaling
2^-s, the balancing factors) are built from exponent bits (``_pow2``), so
every similarity and scaling is exact on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import host_tensor
from ..utils.precision import full_precision

__all__ = ["expm", "expm_higham2005", "expm_higham2005_batched",
           "expm_generic", "expm_diagonalization", "expm_native",
           "expm_taylor", "expm_taylor_masked", "pade_order_for_eps",
           "balance_matrix", "gebal", "expm_gebal"]

# Higham 2005 Pade coefficient tables (Table 2.3 of "The Scaling and
# Squaring Method for the Matrix Exponential Revisited") and 1-norm
# thresholds theta_m.
_B3 = (120.0, 60.0, 12.0, 1.0)
_B5 = (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0)
_B7 = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0)
_B9 = (17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0,
       2162160.0, 110880.0, 3960.0, 90.0, 1.0)
_B13 = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
        1187353796428800.0, 129060195264000.0, 10559470521600.0,
        670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
        960960.0, 16380.0, 182.0, 1.0)

_THETA3 = 1.495585217958292e-2
_THETA5 = 2.539398330063230e-1
_THETA7 = 9.504178996162932e-1
_THETA9 = 2.097847961257068e0
_THETA13 = 5.371920351148152e0

# Single-precision thresholds (Higham & Al-Mohy); degree 7 is the f32 cap.
_THETA3_F32 = 4.258730016922831e-1
_THETA5_F32 = 1.880152677804762e0
_THETA7_F32 = 3.925724783138660e0


def _onenorm(A):
    """The 1-norm of A, or the largest of a stack's (..., n, n)."""
    return A.abs().sum(dim=-2).max()


def _eye(A):
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _pade_uv_3(A, A2, A4, A6):
    b = _B3
    U = A @ (b[3] * A2 + b[1] * _eye(A))
    V = b[2] * A2 + b[0] * _eye(A)
    return U, V


def _pade_uv_5(A, A2, A4, A6):
    b = _B5
    I = _eye(A)
    U = A @ (b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_7(A, A2, A4, A6):
    b = _B7
    I = _eye(A)
    U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_9(A, A2, A4, A6):
    b = _B9
    I = _eye(A)
    A8 = A4 @ A4
    U = A @ (b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    return U, V


def _pade_uv_13(A, A2, A4, A6):
    b = _B13
    I = _eye(A)
    # Higham's economical degree-13 evaluation: two nested polynomials
    # sharing A2/A4/A6, so only 6 matrix products in all
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    Z2 = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I
    U = A @ (A6 @ W1 + W2)
    V = A6 @ Z1 + Z2
    return U, V


def _solve(D, N, differentiable: bool = False):
    """D^-1 N by one LU factorization with no host read: ``solve_ex``
    skips the singularity check (which syncs), and a singular D gives
    non-finite values, the no-throw protocol. The ``differentiable`` form
    multiplies by ``inv_ex(D)``: under ``torch.func.grad`` the backward of
    ``solve_ex`` syncs on CUDA, that of ``inv_ex`` is products only."""
    if differentiable:
        return torch.linalg.inv_ex(D)[0] @ N
    return torch.linalg.solve_ex(D, N)[0]


def _pq_solve(U, V, differentiable: bool = False):
    # exp(A) ~ (V - U)^{-1} (V + U): one LU factorization
    return _solve(V - U, V + U, differentiable)


def _real_dtype(dt):
    return torch.empty((), dtype=dt).real.dtype


def _pow2(e, rdt):
    """2^e for an integer-valued float tensor e, exactly (built from the
    exponent bits; e clamped to the normal range)."""
    if rdt == torch.float64:
        bits = (e.clamp(-1022, 1023).to(torch.int64) + 1023) << 52
        return bits.view(torch.float64)
    bits = (e.clamp(-126, 127).to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def _squarings(X, s: int):
    """X^(2^s) by s squarings."""
    for _ in range(s):
        X = X @ X
    return X


def _masked_squarings(X, s, max_squarings: int):
    """X^(2^s) for a device count s: ``max_squarings`` products, those past
    s masked (no host read)."""
    live = torch.arange(max_squarings, device=X.device) < s
    for i in range(max_squarings):
        X = torch.where(live[i], X @ X, X)
    return X


def _scaling(nA: float, theta: float, max_squarings: int) -> int:
    """s = ceil(log2(nA / theta)) when nA exceeds theta, else 0, capped."""
    if not nA > theta:
        return 0
    if math.isinf(nA):
        return max_squarings
    return min(max(0, math.ceil(math.log2(nA / theta))), max_squarings)


def _scaling_device(nA, theta: float, max_squarings: int):
    """``_scaling`` on the device: s as an integer-valued float tensor."""
    return torch.where(nA > theta, torch.ceil(torch.log2(nA / theta)),
                       0.0).clamp(0, max_squarings)


def _scaled(A, s):
    """A 2^-s, exactly; s a Python int or a device tensor."""
    if isinstance(s, torch.Tensor):
        return A * _pow2(-s, _real_dtype(A.dtype)).to(A.dtype)
    return A * 2.0 ** -s


def _norm_host(A, onenorm):
    """The 1-norm on the host: the caller's, else one read."""
    return float(_onenorm(A.detach())) if onenorm is None else float(onenorm)


def _square(A, what, stacked: bool = True):
    A = host_tensor(A)
    if (A.ndim < 2 or A.shape[-1] != A.shape[-2]
            or (A.ndim > 2 and not stacked)):
        raise ValueError(f"{what} takes a square matrix"
                         f"{' or a stack of them' if stacked else ''}, got "
                         f"shape {tuple(A.shape)}")
    return A


def refuse_host_staged(A, what, grad: bool = False):
    """Host-staged entry points read the matrix to the host, so they
    refuse one that a ``torch.func`` transform wraps (with ``grad``, also
    one that autograd tracks: their result would carry no graph)."""
    if isinstance(A, torch.Tensor) and (
            torch._C._functorch.is_functorch_wrapped_tensor(A)
            or (grad and torch.is_grad_enabled() and A.requires_grad)):
        raise NotImplementedError(
            f"{what} is host-staged (it reads the matrix to the host): "
            "call it outside the transform and pass the result in as data; "
            "inside a transform use balance_matrix (scaling only) or "
            "expm(..., method=\"higham2005\", differentiable=True)")


def _pade_tables(dtype):
    if torch.finfo(dtype).bits <= 32:
        # f32/c64: degree-7 cap with single-precision thresholds
        return ((_THETA3_F32, _THETA5_F32, _THETA7_F32),
                (_pade_uv_3, _pade_uv_5, _pade_uv_7))
    return ((_THETA3, _THETA5, _THETA7, _THETA9, _THETA13),
            (_pade_uv_3, _pade_uv_5, _pade_uv_7, _pade_uv_9, _pade_uv_13))


def _higham(A, nA, max_squarings: int):
    """Higham 2005 at the host norm nA (a stack takes its largest): one
    Pade branch, one solve, s squarings."""
    thetas, branches = _pade_tables(A.dtype)
    s = _scaling(nA, thetas[-1], max_squarings)
    As = _scaled(A, s)
    # degree: the number of thresholds below nA (the top one past the last)
    idx = sum(nA > t for t in thetas[:-1])
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U, V = branches[idx](As, A2, A4, A6)
    return _squarings(_pq_solve(U, V), s)


def _higham_device(A, max_squarings: int, nA=None,
                   differentiable: bool = True):
    """Higham 2005 with no host read: degree and s from the norm on the
    device (``nA``, a 0-d tensor, or A's own), every branch's (U, V)
    formed and one selected, one solve (``_solve``), masked squarings.
    The selected branch, the solve of the non-differentiable form and the
    live squarings are the host form's operations on the same values."""
    thetas, branches = _pade_tables(A.dtype)
    if nA is None:
        nA = _onenorm(A).to(_real_dtype(A.dtype))
    s = _scaling_device(nA, thetas[-1], max_squarings)
    As = _scaled(A, s)
    idx = sum((nA > t).to(torch.int64) for t in thetas[:-1])
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    UV = [torch.stack(br(As, A2, A4, A6)) for br in branches]
    U, V = torch.stack(UV).index_select(0, idx.reshape(1))[0]
    return _masked_squarings(_pq_solve(U, V, differentiable), s,
                             max_squarings)


def _unbalance(E, d):
    """D E D^-1 for the balancing factors d (..., n)."""
    return (d[..., :, None] * E) * (1.0 / d)[..., None, :]


@full_precision
def expm_higham2005(A, *, max_squarings: int = 32, balance: bool = False,
                    onenorm: float | None = None,
                    differentiable: bool = False):
    """Higham-2005 scaling-and-squaring Pade ``exp(A)`` (module doc).
    ``onenorm``: the 1-norm of A when the caller knows it on the host,
    which saves the call's one host read; a 0-d tensor (the norm on the
    device) selects the form with no host read, with the host form's
    solve (a loop step of ``utils/graphs.py``). ``balance=True``: exp(A) =
    D exp(D^-1 A D) D^-1 with ``balance_matrix``'s exact factors. A stack
    (..., n, n) goes to ``expm_higham2005_batched``, or with a 0-d tensor
    ``onenorm`` (the stack's largest 1-norm on the device) to the stack's
    form with no host read, one degree and s for the stack
    (``expv_batched``'s non-Hermitian reduced problems). ``differentiable``:
    the form with no host read (module doc)."""
    A = _square(A, "expm_higham2005")
    if (A.ndim > 2 and isinstance(onenorm, torch.Tensor) and not balance
            and not differentiable):
        return _higham_device(A, max_squarings, onenorm, False)
    if A.ndim > 2:
        return expm_higham2005_batched(A, max_squarings=max_squarings,
                                       balance=balance,
                                       differentiable=differentiable)
    if balance:
        Ab, d = balance_matrix(A)
        return _unbalance(expm_higham2005(
            Ab, max_squarings=max_squarings,
            differentiable=differentiable), d)
    if differentiable:
        return _higham_device(A, max_squarings)
    if isinstance(onenorm, torch.Tensor):
        return _higham_device(A, max_squarings, onenorm, False)
    return _higham(A, _norm_host(A, onenorm), max_squarings)


@full_precision
def expm_higham2005_batched(A, *, max_squarings: int = 32,
                            balance: bool = False,
                            differentiable: bool = False):
    """Batch-uniform Higham-2005 ``exp(A)`` for a (..., n, n) stack: one
    Pade degree and one squaring count from the batch's largest 1-norm,
    read to the host once, so one branch of batched products runs and the
    s squarings are unmasked batched products (no loop over the batch).
    Elements of smaller norm are scaled deeper than they need, which only
    lowers their error. ``balance=True`` balances each element
    (``balance_matrix`` on the stack) first. ``differentiable``: the form
    with no host read (module doc). A single matrix goes to
    ``expm_higham2005``."""
    A = _square(A, "expm_higham2005_batched")
    if A.ndim < 3:
        return expm_higham2005(A, max_squarings=max_squarings,
                               balance=balance, differentiable=differentiable)
    if balance:
        Ab, d = balance_matrix(A)
        return _unbalance(expm_higham2005_batched(
            Ab, max_squarings=max_squarings,
            differentiable=differentiable), d)
    if differentiable:
        return _higham_device(A, max_squarings)
    return _higham(A, float(_onenorm(A.detach())), max_squarings)


def _balance_window(A, ilo: int, ihi: int, sweeps: int = 5):
    """Osborne power-of-two scaling of A (or of each matrix of a stack)
    restricted to the diagonal window [ilo, ihi): rows and columns outside
    it (gebal-isolated eigenvalues) keep d = 1. Returns (Ab, d)."""
    n = A.shape[-1]
    rdt = _real_dtype(A.dtype)
    idx = torch.arange(n, device=A.device)
    active = (idx >= ilo) & (idx < ihi)
    offdiag = (active[:, None] & active[None, :]
               & ~torch.eye(n, dtype=torch.bool, device=A.device))
    d = torch.ones(A.shape[:-1], dtype=rdt, device=A.device)
    Ab = A
    for _ in range(sweeps):
        absA = torch.where(offdiag, Ab.abs().to(rdt), 0.0)
        c = absA.sum(dim=-2)              # column norms (off-diagonal)
        r = absA.sum(dim=-1)              # row norms
        ok = (c > 0) & (r > 0) & active
        ratio = torch.where(ok, r / torch.where(ok, c, 1.0), 1.0)
        # f = 2^round(log2 sqrt(r/c)): exact powers of two keep the
        # similarity error-free (LAPACK's radix trick)
        f = _pow2(torch.round(0.5 * torch.log2(ratio)).clamp(-48, 48), rdt)
        Ab = Ab * (f[..., None, :] / f[..., :, None]).to(Ab.dtype)
        d = d * f
    return Ab, d


def balance_matrix(A, *, sweeps: int = 5):
    """Power-of-two Osborne balancing: ``(Ab, d)`` with Ab = D^-1 A D,
    D = diag(d), d exact powers of two (no rounding in the similarity);
    a (..., n, n) stack is balanced matrix by matrix. The scaling phase of
    LAPACK ``?gebal`` as a fixed number of vectorized sweeps; for the
    permutation as well see ``gebal``."""
    A = _square(A, "balance_matrix")
    return _balance_window(A, 0, A.shape[-1], sweeps=sweeps)


def _gebal_permutation(pattern):
    """The permutation phase of LAPACK ``?gebal`` on a nonzero pattern
    (host numpy): symmetric row/column swaps isolating eigenvalues, so
    that B = A[p][:, p] is block upper triangular with 1 x 1 diagonal
    blocks outside the irreducible window [ilo, ihi). Returns
    (p, ilo, ihi)."""
    M = np.asarray(pattern, bool).copy()
    n = M.shape[0]
    p = list(range(n))
    ilo, ihi = 0, n

    def swap(k, l):
        if k == l:
            return
        M[[k, l], :] = M[[l, k], :]
        M[:, [k, l]] = M[:, [l, k]]
        p[k], p[l] = p[l], p[k]

    # rows with no off-diagonal entry in the active columns -> bottom
    changed = True
    while changed and ihi > ilo:
        changed = False
        for i in range(ihi - 1, ilo - 1, -1):
            row = M[i, ilo:ihi].copy()
            row[i - ilo] = False
            if not row.any():
                swap(i, ihi - 1)
                ihi -= 1
                changed = True
                break
    # columns with no off-diagonal entry in the active rows -> top
    changed = True
    while changed and ihi > ilo:
        changed = False
        for j in range(ilo, ihi):
            col = M[ilo:ihi, j].copy()
            col[j - ilo] = False
            if not col.any():
                swap(j, ilo)
                ilo += 1
                changed = True
                break
    return np.asarray(p), ilo, ihi


def gebal(A, *, sweeps: int = 5):
    """LAPACK ``?gebal``: permutation and windowed scaling. Returns
    ``(B, d, p)`` with B = D^-1 (A[p][:, p]) D, D = diag(d) powers of two,
    d = 1 on the isolated rows and columns; f(A) = (D f(B) D^-1)[q][:, q]
    with q = argsort(p). The permutation search runs on the host on the
    nonzero pattern (one read of it); the gather and the sweeps on A's
    device, where B and d are returned (numpy input: the default
    device). Host-staged: raises under a ``torch.func`` transform."""
    refuse_host_staged(A, "gebal")
    A = _square(A, "gebal", stacked=False)
    p, ilo, ihi = _gebal_permutation((A != 0).cpu().numpy())
    pj = torch.as_tensor(p, device=A.device)
    Ap = A.index_select(0, pj).index_select(1, pj)
    B, d = _balance_window(Ap, ilo, ihi, sweeps=sweeps)
    return B, d, p


def expm_gebal(A, *, sweeps: int = 5, **kwargs):
    """``exp(A)``: Higham-2005 Pade preconditioned by the full ``gebal``
    (permutation and windowed scaling), undone exactly. Host-staged, as
    ``gebal``."""
    B, d, p = gebal(A, sweeps=sweeps)
    E = _unbalance(expm_higham2005(B, balance=False, **kwargs), d)
    q = torch.as_tensor(np.argsort(p), device=E.device)
    return E.index_select(0, q).index_select(1, q)


def pade_order_for_eps(eps: float) -> int:
    """Smallest diagonal Pade order k with backward error below ``eps`` at
    scaled norm 1/2: (1/2)^(2k+1) / (2k+1)! < eps."""
    k = 1
    while (0.5 ** (2 * k + 1)) / math.factorial(2 * k + 1) >= eps and k < 30:
        k += 1
    return k


def _generic_pade_coeffs(k: int):
    # diagonal (k, k) Pade numerator coefficients of exp:
    # c_j = (2k - j)! k! / ((2k)! j! (k - j)!)
    return tuple(
        math.factorial(2 * k - j) * math.factorial(k)
        / (math.factorial(2 * k) * math.factorial(j) * math.factorial(k - j))
        for j in range(k + 1))


@full_precision
def expm_generic(A, *, order: int | None = None, max_squarings: int = 48,
                 differentiable: bool = True):
    """Scaling and squaring with the diagonal Pade of the order the dtype's
    precision needs (``pade_order_for_eps(eps / 2)``), at a scaled 1-norm
    of at most 1/2. The autodiff-first method, so ``differentiable``
    defaults to True (no host read, masked squarings); False reads the
    norm once and runs exactly s squarings. A stack takes its largest
    norm."""
    A = _square(A, "expm_generic")
    if order is None:
        order = pade_order_for_eps(float(torch.finfo(A.dtype).eps) / 2)
    coeffs = _generic_pade_coeffs(order)
    if differentiable:
        s = _scaling_device(_onenorm(A).to(_real_dtype(A.dtype)), 0.5,
                            max_squarings)
    else:
        s = _scaling(float(_onenorm(A.detach())), 0.5, max_squarings)
    X = _scaled(A, s)
    I = _eye(A)
    # Horner evaluation of N(X) and N(-X) = D(X)
    N = coeffs[order] * I
    D = coeffs[order] * I
    for j in range(order - 1, -1, -1):
        N = N @ X + coeffs[j] * I
        D = D @ (-X) + coeffs[j] * I
    P = _solve(D, N, differentiable)
    if differentiable:
        return _masked_squarings(P, s, max_squarings)
    return _squarings(P, s)


@full_precision
def expm_diagonalization(A, *, is_hermitian: bool = False):
    """exp(A) by eigendecomposition on A's device: ``torch.linalg.eigh``
    for Hermitian input, ``torch.linalg.eig`` otherwise (diagonalizable
    input only; ``expm(A, method="schur")`` covers every matrix)."""
    A = _square(A, "expm_diagonalization")
    if is_hermitian:
        w, Q = torch.linalg.eigh(A)
        return (Q * torch.exp(w).to(Q.dtype)[..., None, :]) @ Q.mH
    w, R = torch.linalg.eig(A)
    X = (R * torch.exp(w)[..., None, :]) @ torch.linalg.inv(R)
    return X if A.is_complex() else X.real.to(A.dtype)


@full_precision
def expm_native(A):
    """``torch.linalg.matrix_exp`` (the JAX package defers to
    ``jax.scipy.linalg.expm``)."""
    return torch.linalg.matrix_exp(_square(A, "expm_native"))


@full_precision
def expm_taylor(A, *, order: int | None = None, max_squarings: int = 48,
                onenorm: float | None = None, differentiable: bool = False):
    """Scaling and squaring with a Paterson-Stockmeyer Taylor kernel: a
    solver-free ``exp(A)`` (module doc). ``onenorm`` as in
    ``expm_higham2005``; ``differentiable`` or a 0-d tensor ``onenorm``:
    the form with no host read (``max_squarings`` masked squarings). A
    stack takes its largest norm."""
    from .phi_dense import _ps_phi_taylor, _taylor_order

    A = _square(A, "expm_taylor")
    theta, order_auto = _taylor_order(A.dtype)
    if order is None:
        order = order_auto
    if differentiable or isinstance(onenorm, torch.Tensor):
        nA = (onenorm if isinstance(onenorm, torch.Tensor)
              else _onenorm(A).to(_real_dtype(A.dtype)))
        s = _scaling_device(nA, theta, max_squarings)
        return _masked_squarings(_ps_phi_taylor(_scaled(A, s), 0, order), s,
                                 max_squarings)
    s = _scaling(_norm_host(A, onenorm), theta, max_squarings)
    return _squarings(_ps_phi_taylor(_scaled(A, s), 0, order), s)


def expm_taylor_masked(A, *, max_squarings: int = 48):
    """``expm_taylor(A, differentiable=True)``: the squaring count chosen
    on the device and the ``max_squarings`` squarings masked past it, as
    the JAX package's traced loop is. Costs ``max_squarings`` products of
    A's size; for callers that must not sync (a fixed-step driver)."""
    return expm_taylor(A, max_squarings=max_squarings, differentiable=True)


def _expm_schur(A, **kwargs):
    """exp(A) by blocked Schur-Parlett (``ops/funm.py``): every square
    matrix, defective ones included. Host-staged."""
    from .funm import funm
    return funm(A, "exp", **kwargs)


_METHODS = {
    "higham2005": expm_higham2005,
    "generic": expm_generic,
    "diagonalization": expm_diagonalization,
    "native": expm_native,
    "taylor": expm_taylor,
    "schur": _expm_schur,
    "gebal": expm_gebal,
}


def expm(A, method: str = "higham2005", **kwargs):
    """Front door of the dense matrix exponential: ``method`` is one of
    "higham2005" (a stack goes to ``expm_higham2005_batched``), "generic",
    "diagonalization", "native", "taylor", "schur", "gebal". Sparse and
    matrix-free operators are rejected (their exponential is dense: use
    expv/phiv for the action)."""
    from ..utils.linop import LinearOperator

    if isinstance(A, LinearOperator):
        raise TypeError(
            "expm of a sparse/matrix-free operator produces a dense matrix; "
            "use expv/phiv for its action, or pass `op.to_dense()` "
            "explicitly")
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(f"unknown expm method {method!r}; expected one of "
                         f"{sorted(_METHODS)}") from None
    if method == "higham2005" and host_tensor(A).ndim > 2:
        return expm_higham2005_batched(A, **kwargs)
    return fn(A, **kwargs)

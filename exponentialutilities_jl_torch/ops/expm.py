"""Dense matrix exponential by scaling and squaring (PyTorch port of the
part of ``exponentialutilities_jl_tpu/ops/expm.py`` that the phi-function
actions need).

* ``expm_higham2005``: Higham (2005) degree-{3,5,7,9,13} Pade with the
  degree chosen from the 1-norm (degree 7 at most in single precision),
  one ``torch.linalg.solve`` and s squarings.
* ``expm_taylor``: a solver-free Paterson-Stockmeyer Taylor kernel with
  the order chosen so the series tail is below the dtype's unit roundoff
  at a scaled 1-norm of at most 1; ``expm_taylor_masked`` is the same
  kernel with the squaring count kept on the device (no host read).

The JAX package picks the Pade degree and the squaring count on the
device (``lax.switch``, a dynamic loop). Here torch runs eagerly: the
1-norm is read to the host once per call (one device sync; none when the
caller passes it as ``onenorm``) and the degree and squaring count become
Python values, so exactly one Pade branch and s matrix products run.

Not ported yet, and raising NotImplementedError (ROADMAP A3): balancing
(``balance_matrix``, ``gebal``), ``method="generic"``,
``"diagonalization"``, ``"native"``, ``"schur"`` and ``"gebal"``, and
batched (stacked) input.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import host_tensor
from ..utils.precision import full_precision

__all__ = ["expm", "expm_higham2005", "expm_taylor", "expm_taylor_masked"]

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
    return A.abs().sum(dim=0).max()


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


def _pq_solve(U, V):
    # exp(A) ~ (V - U)^{-1} (V + U): one LU solve
    return torch.linalg.solve(V - U, V + U)


def _masked_squaring(X, s: int):
    """X^(2^s) by s squarings."""
    for _ in range(s):
        X = X @ X
    return X


def _scaling(nA: float, theta: float, max_squarings: int) -> int:
    """s = ceil(log2(nA / theta)) when nA exceeds theta, else 0, capped."""
    if not nA > theta:
        return 0
    if math.isinf(nA):
        return max_squarings
    return min(max(0, math.ceil(math.log2(nA / theta))), max_squarings)


def _square_2d(A, what):
    A = host_tensor(A)
    if A.ndim > 2:
        raise NotImplementedError(
            f"{what}: batched (stacked) input is not ported yet (ROADMAP A3)")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"{what} takes a square matrix, got shape "
                         f"{tuple(A.shape)}")
    return A


@full_precision
def expm_higham2005(A, *, max_squarings: int = 32, balance: bool = False,
                    onenorm: float | None = None):
    """Higham-2005 scaling-and-squaring Pade ``exp(A)`` (module doc).
    ``onenorm``: the 1-norm of A when the caller knows it on the host,
    which saves the call's one host read."""
    if balance:
        raise NotImplementedError("balance=True: Osborne balancing is not "
                                  "ported yet (ROADMAP A3)")
    A = _square_2d(A, "expm_higham2005")
    # the one host sync of the call, unless the caller knows the norm
    nA = float(_onenorm(A)) if onenorm is None else float(onenorm)
    if torch.finfo(A.dtype).bits <= 32:
        # f32/c64: degree-7 cap with single-precision thresholds
        thetas = (_THETA3_F32, _THETA5_F32, _THETA7_F32)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7)
    else:
        thetas = (_THETA3, _THETA5, _THETA7, _THETA9, _THETA13)
        branches = (_pade_uv_3, _pade_uv_5, _pade_uv_7, _pade_uv_9,
                    _pade_uv_13)
    s = _scaling(nA, thetas[-1], max_squarings)
    As = A * 2.0 ** -s
    # degree: the number of thresholds below nA (the top one past the last)
    idx = sum(nA > t for t in thetas[:-1])
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U, V = branches[idx](As, A2, A4, A6)
    return _masked_squaring(_pq_solve(U, V), s)


@full_precision
def expm_taylor(A, *, order: int | None = None, max_squarings: int = 48,
                onenorm: float | None = None):
    """Scaling and squaring with a Paterson-Stockmeyer Taylor kernel: a
    solver-free ``exp(A)`` (module doc). ``onenorm`` as in
    ``expm_higham2005``."""
    from .phi_dense import _ps_phi_taylor, _taylor_order

    A = _square_2d(A, "expm_taylor")
    theta, order_auto = _taylor_order(A.dtype)
    if order is None:
        order = order_auto
    nA = float(_onenorm(A)) if onenorm is None else float(onenorm)
    s = _scaling(nA, theta, max_squarings)
    return _masked_squaring(_ps_phi_taylor(A * 2.0 ** -s, 0, order), s)


@full_precision
def expm_taylor_masked(A, *, max_squarings: int = 48):
    """``expm_taylor`` with no host read: the squaring count s is chosen
    on the device and the ``max_squarings`` squarings are masked past it,
    as the JAX package's traced loop is. Costs ``max_squarings`` products
    of A's size; for callers that must not sync (a fixed-step driver)."""
    from .phi_dense import _ps_phi_taylor, _taylor_order

    A = _square_2d(A, "expm_taylor_masked")
    theta, order = _taylor_order(A.dtype)
    rdt = A.real.dtype if A.is_complex() else A.dtype
    nA = _onenorm(A).to(rdt)
    s = torch.where(nA > theta, torch.ceil(torch.log2(nA / theta)),
                    0.0).clamp(0, max_squarings)
    X = _ps_phi_taylor(A * torch.exp2(-s).to(A.dtype), 0, order)
    live = torch.arange(max_squarings, device=A.device) < s
    for i in range(max_squarings):
        X = torch.where(live[i], X @ X, X)
    return X


_METHODS = {"higham2005": expm_higham2005, "taylor": expm_taylor}
_NOT_PORTED = ("generic", "diagonalization", "native", "schur", "gebal")


def expm(A, method: str = "higham2005", **kwargs):
    """Front door of the dense matrix exponential: ``method`` is
    "higham2005" or "taylor". Sparse and matrix-free operators are
    rejected (their exponential is dense: use expv/phiv for the action)."""
    from ..utils.linop import LinearOperator

    if isinstance(A, LinearOperator):
        raise TypeError(
            "expm of a sparse/matrix-free operator produces a dense matrix; "
            "use expv/phiv for its action, or pass `op.to_dense()` "
            "explicitly")
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"expm method {method!r} is not ported yet (ROADMAP A3)")
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(f"unknown expm method {method!r}; expected one of "
                         f"{sorted(_METHODS) + list(_NOT_PORTED)}") from None
    return fn(A, **kwargs)

"""Double-double (~106-bit) phi functions (PyTorch port of
``exponentialutilities_jl_tpu/ops/phi_dd.py``).

* ``phiv_dense_dd(A, v, k)``: [phi_0(A)v ... phi_k(A)v] through the Sidje
  augmented matrix exponentiated by ``expm_dd`` (the augmented entries are
  exactly representable, so the embedding adds no rounding).
* ``phi_dd(A, k)``: [phi_0(A) ... phi_k(A)] by DD scaling, Taylor for
  phi_k, the recovery phi_j = X phi_{j+1} + I/j! and the double-argument
  stages, every product compensated.
* ``expv_dd(t, A, b)``: exp(tA) b in DD (DD exponential, DD product).

The coefficients 1/(i+p)! are exact DD constants from
``fractions.Fraction`` (hi the nearest float64, lo the nearest float64 of
the remainder), so the only rounding is the compensated arithmetic's own.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from .expm_dd import (DD, _squarings_for, _taylor_order, dd_add,
                      dd_from_f64, dd_matmul, dd_mul, dd_scale, expm_dd)

__all__ = ["phi_dd", "phiv_dense_dd", "expv_dd"]


def _dd_const(x: Fraction) -> tuple[float, float]:
    """Exact double-double split of a rational."""
    hi = float(x)
    return hi, float(x - Fraction(hi))


def _dd_eye(n, c: Fraction, like):
    hi, lo = _dd_const(c)
    eye = torch.eye(n, dtype=torch.float64, device=like.device)
    return DD(eye * hi, eye * lo)


def _dd_add_scaled_identity(X: DD, c: Fraction) -> DD:
    """X + c I with c an exact DD constant."""
    return dd_add(X, _dd_eye(X.hi.shape[-1], c, X.hi))


def _dd_mul_scalar(X: DD, c: Fraction) -> DD:
    hi, lo = _dd_const(c)
    return dd_mul(X, DD(torch.full_like(X.hi, hi), torch.full_like(X.lo, lo)))


def _phi_taylor_dd(X: DD, p: int, order: int) -> DD:
    """phi_p(X) ~ sum_{i<=order} X^i/(i+p)! by Horner in DD, every fold one
    DD product."""
    P = _dd_eye(X.hi.shape[-1], Fraction(1, math.factorial(order + p)), X.hi)
    for i in range(order - 1, -1, -1):
        P = _dd_add_scaled_identity(dd_matmul(X, P),
                                    Fraction(1, math.factorial(i + p)))
    return P


def _double_argument_dd(F: list, p: int) -> list:
    """One squaring stage in DD: phi_l(2X) = 2^-l (phi_0 phi_l +
    sum_{k=1}^{l} phi_k/(l-k)!) for every l."""
    out = []
    for ell in range(p + 1):
        acc = dd_matmul(F[0], F[ell])
        for kk in range(1, ell + 1):
            acc = dd_add(acc, _dd_mul_scalar(
                F[kk], Fraction(1, math.factorial(ell - kk))))
        out.append(dd_scale(acc, 2.0 ** (-ell)))
    return out


def phi_dd(A, k: int, *, squarings: int | None = None) -> list:
    """[phi_0(A), ..., phi_k(A)] in double-double precision: a list of k+1
    ``DD`` matrices on A's device (module doc). ``squarings`` overrides
    the automatic s (one host read of the norm otherwise)."""
    X = A if isinstance(A, DD) else dd_from_f64(A)
    s = _squarings_for(X, squarings)
    order = _taylor_order()
    Xs = dd_scale(X, 2.0 ** -s)
    F = [None] * (k + 1)
    F[k] = _phi_taylor_dd(Xs, k, order)
    for j in range(k - 1, -1, -1):
        F[j] = _dd_add_scaled_identity(dd_matmul(Xs, F[j + 1]),
                                       Fraction(1, math.factorial(j)))
    for _ in range(s):
        F = _double_argument_dd(F, k)
    return F


def _column(v: DD) -> DD:
    return DD(v.hi[:, None], v.lo[:, None])


def phiv_dense_dd(A, v, k: int, *, squarings: int | None = None) -> DD:
    """[phi_0(A)v ... phi_k(A)v] (m, k+1) in double-double precision via
    the augmented matrix [A v e_1 ... e_{k-1}; 0 J] and ``expm_dd``."""
    Ad = A if isinstance(A, DD) else dd_from_f64(A)
    vd = v if isinstance(v, DD) else dd_from_f64(v, Ad.device)
    m = Ad.hi.shape[0]
    if k == 0:
        return dd_matmul(expm_dd(Ad, squarings=squarings), _column(vd))
    kw = dict(dtype=torch.float64, device=Ad.device)
    hi = torch.zeros((m + k, m + k), **kw)
    lo = torch.zeros((m + k, m + k), **kw)
    hi[:m, :m] = Ad.hi
    lo[:m, :m] = Ad.lo
    hi[:m, m] = vd.hi
    lo[:m, m] = vd.lo
    if k >= 2:
        hi[m:m + k - 1, m + 1:] = torch.eye(k - 1, **kw)
    P = expm_dd(DD(hi, lo), squarings=squarings)
    w0 = dd_matmul(DD(P.hi[:m, :m], P.lo[:m, :m]), _column(vd))
    return DD(torch.cat([w0.hi, P.hi[:m, m:m + k]], dim=1),
              torch.cat([w0.lo, P.lo[:m, m:m + k]], dim=1))


def expv_dd(t, A, b, *, squarings: int | None = None) -> DD:
    """exp(tA) b in double-double precision: t A formed compensated,
    ``expm_dd``, a DD product."""
    Ad = A if isinstance(A, DD) else dd_from_f64(A)
    bd = b if isinstance(b, DD) else dd_from_f64(b, Ad.device)
    td = DD(torch.full_like(Ad.hi, float(t)), torch.zeros_like(Ad.lo))
    E = expm_dd(dd_mul(Ad, td), squarings=squarings)
    w = dd_matmul(E, _column(bd))
    return DD(w.hi[:, 0], w.lo[:, 0])

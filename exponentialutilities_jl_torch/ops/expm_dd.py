"""Double-double (~106-bit) dense matrix exponential (PyTorch port of
``exponentialutilities_jl_tpu/ops/expm_dd.py``).

Each number is an unevaluated sum hi + lo of two float64s, built from
error-free transformations: ``_two_sum`` (Knuth, exact a + b = s + err)
and ``_two_prod`` (Dekker/Veltkamp splitting, exact a b = p + err without
FMA). Every step of a transformation is its own elementwise torch op, so
each is correctly rounded on the CPU and on CUDA alike and the card's bits
equal the CPU's. The EFT code uses no fused op (no ``addcmul``,
``add(..., alpha=)``, ``lerp``, ``addmm``, ``baddbmm``, no
``torch.compile``), which could contract a product and a sum into one
rounding.

``dd_matmul`` forms the two-product blocks of a chunk of the inner
dimension by broadcasting ((..., i, j, k_c) at once) and reduces them with
a pairwise DD sum: O(log k_c) rounds of elementwise launches per chunk,
instead of the JAX package's scan of n rank-1 steps. The accumulation is
double-double throughout, the same error class.

The exponential is scaling + Taylor + squaring: scale so that
|A|_inf / 2^s <= 1/2, sum the Taylor series to the order where
(1/2)^{m+1}/(m+1)! falls below 2^-106, then s compensated squarings. The
norm is read to the host once (``squarings`` overrides it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.device import host_tensor

__all__ = ["DD", "dd_from_f64", "dd_add", "dd_neg", "dd_mul", "dd_scale",
           "dd_div_int", "dd_matmul", "expm_dd"]

_SPLITTER = 134217729.0          # 2^27 + 1 (Veltkamp)
# elements of one chunk's (..., i, j, k_c) block in dd_matmul
_CHUNK_ELEMS = 1 << 21


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


@dataclasses.dataclass
class DD:
    """A double-double tensor: value = hi + lo, |lo| <= ulp(hi)/2; both
    float64 tensors of one shape on one device."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape

    @property
    def device(self):
        return self.hi.device

    def to_float64(self):
        return self.hi + self.lo

    def __add__(self, other):
        return dd_add(self, other)

    def __sub__(self, other):
        return dd_add(self, dd_neg(other))

    def __matmul__(self, other):
        return dd_matmul(self, other)


def dd_from_f64(x, device=None) -> DD:
    """A float64 tensor (host data: the default device) as a DD."""
    x = host_tensor(x, device, dtype=torch.float64)
    return DD(x, torch.zeros_like(x))


def dd_add(x: DD, y: DD) -> DD:
    """Accurate (IEEE-style) DD addition, the QD library's two-two_sum
    form (the one-two_sum form loses the low word under cancellation)."""
    s1, s2 = _two_sum(x.hi, y.hi)
    t1, t2 = _two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(s1, s2)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_mul(x: DD, y: DD) -> DD:
    p, e = _two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = _quick_two_sum(p, e)
    return DD(hi, lo)


def dd_scale(x: DD, a: float) -> DD:
    """Multiply by an exactly representable scalar (e.g. 2^-s)."""
    return DD(x.hi * a, x.lo * a)


def dd_div_int(x: DD, k: int) -> DD:
    """x / k for a positive integer k <= 2^53: quotient plus a compensated
    remainder correction. The divisor is a tensor: CUDA divides by a host
    scalar as a product with its reciprocal, which is not correctly
    rounded."""
    kt = torch.full_like(x.hi, float(k))
    q1 = x.hi / kt
    p, e = _two_prod(q1, kt)
    r = ((x.hi - p) - e) + x.lo
    q2 = r / kt
    hi, lo = _quick_two_sum(q1, q2)
    return DD(hi, lo)


def _dd_sum_last(X: DD) -> DD:
    """Sum over the last axis by a pairwise DD reduction: halve the axis
    each round (an odd one keeps its last element for the next round)."""
    hi, lo = X.hi, X.lo
    while hi.shape[-1] > 1:
        L = hi.shape[-1]
        h = L // 2
        s = dd_add(DD(hi[..., :h], lo[..., :h]),
                   DD(hi[..., h:2 * h], lo[..., h:2 * h]))
        if L % 2:
            hi = torch.cat([s.hi, hi[..., 2 * h:]], dim=-1)
            lo = torch.cat([s.lo, lo[..., 2 * h:]], dim=-1)
        else:
            hi, lo = s.hi, s.lo
    return DD(hi[..., 0], lo[..., 0])


def dd_matmul(A: DD, B: DD) -> DD:
    """Compensated matrix product: C[i, j] = sum_k A[i, k] B[k, j] with
    every product's error term kept and the sum double-double. The
    products of a chunk of k are formed by broadcasting as one
    (..., i, j, k_c) block and reduced pairwise (module doc); the chunks'
    sums are added in order."""
    ni, nk = A.hi.shape[-2:]
    nj = B.hi.shape[-1]
    lead = max(1, math.prod(torch.broadcast_shapes(A.hi.shape[:-2],
                                                   B.hi.shape[:-2])))
    kc = max(1, min(nk, _CHUNK_ELEMS // max(1, lead * ni * nj)))
    Bt_hi, Bt_lo = B.hi.transpose(-1, -2), B.lo.transpose(-1, -2)
    acc = None
    for k0 in range(0, nk, kc):
        k1 = min(nk, k0 + kc)
        a = DD(A.hi[..., :, None, k0:k1], A.lo[..., :, None, k0:k1])
        b = DD(Bt_hi[..., None, :, k0:k1], Bt_lo[..., None, :, k0:k1])
        s = _dd_sum_last(dd_mul(a, b))
        acc = s if acc is None else dd_add(acc, s)
    return acc


def _dd_add_identity(X: DD) -> DD:
    eye = torch.eye(X.hi.shape[-1], dtype=torch.float64, device=X.hi.device)
    return dd_add(X, DD(eye.expand_as(X.hi), torch.zeros_like(X.lo)))


def _taylor_order(prec_bits: int = 106) -> int:
    """Smallest m with (1/2)^{m+1}/(m+1)! < 2^-prec_bits (the
    precision-driven order selection)."""
    m = 1
    while -((m + 1) * math.log2(0.5) - math.log2(math.factorial(m + 1))) \
            < prec_bits + 2:
        m += 1
        if m > 80:
            break
    return m


def _squarings_for(X: DD, squarings):
    """s with |X|_inf / 2^s <= 1/2: one host read of the norm, unless the
    caller gives ``squarings``."""
    if squarings is not None:
        return int(squarings)
    norm = float(X.hi.abs().sum(dim=-1).max())
    return max(0, math.ceil(math.log2(max(norm, 1e-300))) + 1)


def expm_dd(A, *, squarings: int | None = None) -> DD:
    """exp(A) in double-double precision (~1e-31 class componentwise).

    A: (n, n) float64 tensor (host data: the default device) or a ``DD``.
    Returns a ``DD`` on A's device; ``result.hi`` is exp(A) correctly
    rounded to float64 for well-scaled input. ``squarings`` overrides the
    automatic s = max(0, ceil(log2 |A|_inf) + 1)."""
    X = A if isinstance(A, DD) else dd_from_f64(A)
    s = _squarings_for(X, squarings)
    m = _taylor_order()
    As = dd_scale(X, 2.0 ** -s)
    # Horner: P = I + As (I + As/2 (I + ... As/m)), innermost first
    eye = torch.eye(X.hi.shape[-1], dtype=torch.float64, device=X.hi.device)
    P = DD(eye, torch.zeros_like(eye))
    for k in range(m, 0, -1):
        P = _dd_add_identity(dd_div_int(dd_matmul(As, P), k))
    for _ in range(s):
        P = dd_matmul(P, P)
    return P

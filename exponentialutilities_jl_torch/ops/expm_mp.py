"""Arbitrary-precision matrix exponential on the host (mpmath): the
port's own copy of ``exponentialutilities_jl_tpu/ops/expm_mp.py``.

The same precision-driven scaling-and-squaring diagonal Pade as
``expm_generic``, executed in ``mpmath`` at any requested precision: for
reduced problems, oracles and coefficient generation, not device
compute. Plain Python (no torch arithmetic); a tensor argument is read to
the host, and one under a ``torch.func`` transform is refused.
"""

from __future__ import annotations

import math

__all__ = ["expm_mp", "pade_order_for_eps_mp"]


def pade_order_for_eps_mp(eps) -> int:
    """Smallest diagonal Pade order k with backward error below ``eps`` at
    scaled norm 1/2 ((1/2)^(2k+1)/(2k+1)! < eps): the uncapped twin of
    ``ops.expm.pade_order_for_eps`` (300 bits need k ~ 26; the float64
    helper caps at 30)."""
    from mpmath import mp

    k = 1
    while (mp.mpf(0.5) ** (2 * k + 1)) / math.factorial(2 * k + 1) >= eps \
            and k < 200:
        k += 1
    return k


def expm_mp(A, *, prec_bits: int = 300):
    """``exp(A)`` at ``prec_bits`` binary digits (an mpmath matrix).

    Scale A by 2^-s to a 1-norm of at most 1/2, evaluate the diagonal
    (k, k) Pade with k from ``pade_order_for_eps_mp(eps)``, undo by s
    squarings, all in mpmath with 10 guard digits. ``A``: a square tensor,
    anything numpy can coerce to a square (n, n) array of numbers or
    strings, or an mpmath matrix. Convert the result with
    ``numpy.array(X.tolist(), dtype=float)`` when a float view is
    enough."""
    import numpy as np
    import torch
    from mpmath import matrix, mp, workprec

    from .expm import refuse_host_staged

    refuse_host_staged(A, "expm_mp")
    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().numpy()
    with workprec(prec_bits + 10):
        if hasattr(A, "rows") and hasattr(A, "cols"):
            M = matrix(A)
        else:
            An = np.asarray(A, dtype=object)
            if An.ndim != 2 or An.shape[0] != An.shape[1]:
                raise ValueError(f"expected a square matrix, got "
                                 f"{getattr(An, 'shape', None)}")
            M = matrix([[mp.mpf(x) if not isinstance(x, complex)
                         else mp.mpc(x) for x in row]
                        for row in An.tolist()])
        n = M.rows
        one = mp.mpf(1)

        # 1-norm and scaling to <= 1/2
        nA = max((sum(abs(M[i, j]) for i in range(n))
                  for j in range(n)), default=mp.mpf(0))
        s = max(0, int(mp.ceil(mp.log(nA / mp.mpf(0.5), 2)))) \
            if nA > mp.mpf(0.5) else 0
        As = M / (mp.mpf(2) ** s)

        # diagonal (k, k) Pade: N = sum c_j X^j, D = sum (-1)^j c_j X^j
        k = pade_order_for_eps_mp(mp.eps)
        c = [mp.mpf(math.factorial(2 * k - j)) * math.factorial(k)
             / (math.factorial(2 * k) * math.factorial(j)
                * math.factorial(k - j))
             for j in range(k + 1)]
        eye = matrix([[one if i == j else mp.mpf(0) for j in range(n)]
                      for i in range(n)])
        # Horner in X (k is ~26 at 300 bits; n is host-sized)
        N = eye * c[k]
        D = eye * (c[k] if k % 2 == 0 else -c[k])
        for j in range(k - 1, -1, -1):
            N = As * N + eye * c[j]
            D = As * D + eye * (c[j] if j % 2 == 0 else -c[j])
        X = D ** -1 * N
        for _ in range(s):
            X = X * X
    return X

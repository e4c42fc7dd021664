"""Al-Mohy-Liu Pade-form simultaneous phi functions (PyTorch port of
``exponentialutilities_jl_tpu/ops/phi_almohy.py``).

Algorithm 5.1 of Al-Mohy & Liu, "A scaling and recovering algorithm for
the matrix phi-functions" (arXiv:2506.01193): scale A -> A/2^s, evaluate
the [m/m] diagonal Pade approximant of phi_p at the scaled matrix by
Paterson-Stockmeyer, recover phi_{p-1}..phi_0 by R_j = As R_{j+1} + I/j!,
and undo the scaling with the double-argument formula, with the paper's
theta_{m,p} table, the eta/alpha 1-norm-of-powers probes and the joint
(degree m, scaling s, block tau) cost-model selection.

* The Pade coefficients are solved from the Pade conditions in exact
  rational arithmetic (``fractions.Fraction``, m <= 12) and cached per
  (m, p).
* ``_select_parameters`` runs on the device: the norms of A's powers and
  the eight scaling-floor probes (each K products of |A| with a vector)
  are device tensors, and the choice (i, s) is made there with the JAX
  package's arithmetic and tie-break, so both packages choose the same
  (m, s). By default (i, s) is read to the host once and one Pade branch
  and s double-argument stages run; ``differentiable=True`` makes no host
  read: every branch's N and D are formed and one pair is selected, one
  solve, ``max_squarings`` masked stages.
* N(As) and D(As) are evaluated together as a (2, n, n) stack, each
  Horner fold one 2-batched product; the denominator solve is
  ``torch.linalg.solve`` (``solve="device"``, which "auto" means on every
  device; ``solve_ex``, no host read) or the solver-free Newton-Schulz
  inverse (``solve="newton"``).
* No-throw failure protocol: non-finite input propagates NaN, and
  ``phi_pade_with_info`` returns info != 0.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

from ..utils.precision import full_precision
from .expm import _eye, _onenorm, _real_dtype, _scaled, _solve, _square
from .phi_dense import _double_argument_stage, _info, _inv_factorial

__all__ = ["phi_pade", "phi_pade_with_info"]


# theta_{m,p}: largest 1-norm of the scaled matrix for which the [m/m] Pade
# approximant of phi_p is backward stable to double-precision unit
# roundoff. Table 3.1 of Al-Mohy & Liu, arXiv:2506.01193 (rows m = 1..12,
# columns p = 1..10; for p > 7 the paper prescribes the p = 7 column).
_PHI_THETA_MP = np.array([
    [1.999463452408407e-5, 3.7631213142601604e-5, 7.366006416045163e-5,
     1.4973317297025854e-4, 3.152443333771182e-4, 6.855209983764435e-4,
     1.5357294906993542e-3, 3.5357368946407606e-3, 8.345789028062234e-3,
     2.013882808928226e-2],
    [3.8062018282832713e-3, 6.090206286125726e-3, 9.869682746779615e-3,
     1.6211831146383013e-2, 2.6984240563843326e-2, 4.54757968381803e-2,
     7.749273259855331e-2, 1.3324895779231027e-1, 2.304625604362521e-1,
     3.988991104549146e-1],
    [3.971636005661334e-2, 5.806968886880692e-2, 8.534220076759817e-2,
     1.2612151517169362e-1, 1.8736524835661617e-1, 2.7955116495245524e-1,
     4.1822735418681667e-1, 6.258702800351991e-1, 9.335970443986562e-1,
     1.1616793320890249e0],
    [1.5442675548312682e-1, 2.1278117034577634e-1, 2.9371996708854947e-1,
     4.0617647304246707e-1, 5.623843002320996e-1, 7.787883505754265e-1,
     1.0464245027100287e0, 1.2572921799132364e0, 1.480350861451984e0,
     1.713871003185325e0],
    [3.7980898016147974e-1, 5.014624976587007e-1, 6.621033824456818e-1,
     8.739858777744354e-1, 1.110828442901451e0, 1.3375805277521873e0,
     1.5770955744229305e0, 1.8273848586096524e0, 2.08673114576671e0,
     2.3536689190936406e0],
    [7.26177195703321e-1, 9.281910159646274e-1, 1.1591052927815408e0,
     1.4012982671152012e0, 1.6570386251184455e0, 1.924026602416338e0,
     2.20029216725632e0, 2.4841706972729956e0, 2.7742685942850143e0,
     3.069426294589578e0],
    [1.1898666361923196e0, 1.4469917284172122e0, 1.7187282676344413e0,
     2.0024009817133357e0, 2.295729523138923e0, 2.5968019781751672e0,
     2.9040336511997444e0, 3.216121483847106e0, 3.531999855119243e0,
     3.8508005672569903e0],
    [1.7605812331512907e0, 2.060907194742016e0, 2.371480030315257e0,
     2.690078917436836e0, 3.014877598333601e0, 3.3443898815994957e0,
     3.677415494646134e0, 4.01299056190377e0, 4.350344448873932e0,
     4.688863279363638e0],
    [2.425818958547233e0, 2.7623053687512256e0, 3.105174730511504e0,
     3.4527057639100476e0, 3.8035234182863555e0, 4.156538184296475e0,
     4.510892686686127e0, 4.865916398054041e0, 5.2210881567935115e0,
     5.57600564043454e0],
    [3.173113456793749e0, 3.5393251225873685e0, 3.9086764034913664e0,
     4.279911937822335e0, 4.652058062541427e0, 5.024366624424222e0,
     5.396268333440519e0, 5.767334816025469e0, 6.1372481669904e0,
     6.505776744744432e0],
    [3.991025201329815e0, 4.3813599805888455e0, 4.772204432206606e0,
     5.162703837030561e0, 5.552220615863406e0, 5.940286915538899e0,
     6.326566605567779e0, 6.710825187972159e0, 7.092906173082131e0,
     7.4727126397309815e0],
    [4.869485489784578e0, 5.279199870248916e0, 5.687344501175957e0,
     6.09339280009268e0, 6.496977936247796e0, 6.8978550856394785e0,
     7.295871912058635e0, 7.690945666690415e0, 8.083045525424248e0,
     8.472179024890941e0],
], dtype=np.float64)
# Only rows m ≤ _PHI_M_MAX = 12 are ever consulted (the cost model caps the
# degree there to bound cond(D_m), paper §4), so rows 13..20 are omitted.

_PHI_M_MAX = 12
# Admissible degrees and their Paterson–Stockmeyer cost index i:
# m_i = (i+3)²÷8 (Fasi's optimal-degree sequence).
_PHI_IMAX = math.ceil(math.sqrt(8 * (_PHI_M_MAX + 1)) - 3) - 1   # = 7
_PHI_DEGREES = tuple((i + 3) ** 2 // 8 for i in range(_PHI_IMAX + 1))


_PHI_M_MAX = 12
# admissible degrees and their Paterson-Stockmeyer cost index i:
# m_i = (i+3)^2 // 8 (Fasi's optimal-degree sequence)
_PHI_IMAX = math.ceil(math.sqrt(8 * (_PHI_M_MAX + 1)) - 3) - 1   # = 7
_PHI_DEGREES = tuple((i + 3) ** 2 // 8 for i in range(_PHI_IMAX + 1))


def _phi_theta(m: int, p: int) -> float:
    """theta_{m,p} with the paper's p > 7 rule (p = 7 column reused)."""
    return float(_PHI_THETA_MP[m - 1, min(p, 7) - 1])


def _ps_tau(m: int, i: int) -> int:
    """Paterson-Stockmeyer block size tau for degree m at cost index i:
    the tau in {floor(sqrt 2m), ceil(sqrt 2m)} whose product count
    tau - 1 + 2 floor(m/tau) - 2 [tau | m] equals i."""
    tau = int(math.floor(math.sqrt(2 * m)))
    pi = tau - 1 + 2 * (m // tau) - 2 * (m % tau == 0)
    if pi != i:
        tau = int(math.ceil(math.sqrt(2 * m)))
    return tau


@functools.lru_cache(maxsize=None)
def _pade_coeffs(m: int, p: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Exact [m/m] diagonal Pade coefficients of phi_p, D(0) = 1: the
    conditions N(z) - phi_p(z) D(z) = O(z^{2m+1}) on the Taylor series
    c_i = 1/(i+p)! give an m x m system for d_1..d_m, solved in exact
    rationals; then n_j = sum_{k<=j} d_k c_{j-k}."""
    c = [Fraction(1, math.factorial(i + p)) for i in range(2 * m + 1)]
    M = [[c[j - k] for k in range(1, m + 1)] for j in range(m + 1, 2 * m + 1)]
    rhs = [-c[j] for j in range(m + 1, 2 * m + 1)]
    d = [Fraction(1)] + _fraction_solve(M, rhs)
    n = [sum(d[k] * c[j - k] for k in range(0, min(j, m) + 1))
         for j in range(m + 1)]
    return tuple(float(x) for x in n), tuple(float(x) for x in d)


def _fraction_solve(M, rhs):
    """Gaussian elimination in exact rationals (m <= 12, on the host,
    once per (m, p))."""
    m = len(rhs)
    A = [row[:] + [rhs[i]] for i, row in enumerate(M)]
    for col in range(m):
        piv = next(r for r in range(col, m) if A[r][col] != 0)
        A[col], A[piv] = A[piv], A[col]
        pv = A[col][col]
        A[col] = [x / pv for x in A[col]]
        for r in range(m):
            if r != col and A[r][col] != 0:
                f = A[r][col]
                A[r] = [x - f * y for x, y in zip(A[r], A[col])]
    return [A[r][m] for r in range(m)]


def _log_be_coeff(m: int, p: int) -> float:
    """log of the leading backward-error coefficient
    (m+p)! m! / ((2m+p)! (2m+p+1)!), summed in log space (paper Eq. 3.4)."""
    r = 0.0
    for j in range(1, m + 1):
        r -= math.log(m + p + j)
    for j in range(1, m + p + 2):
        r -= math.log(m + j)
    return r


def _normpow_nonneg(B, K: int):
    """||B^K||_1 of an entrywise-nonnegative B by K products with a
    vector: ||B^K||_1 = ||(B^T)^K 1||_inf."""
    v = torch.ones(B.shape[0], dtype=B.dtype, device=B.device)
    Bt = B.T
    for _ in range(K):
        v = Bt @ v
    return v.max()


def _scaling_floor(A, normT, m: int, p: int, phat: int):
    """The scaling floor t(m) from the first backward-error term (paper
    Eq. 3.12) as a non-negative integer-valued device tensor (0 on
    non-finite input: the NaN reaches the output instead)."""
    rdt = normT.dtype
    K = 2 * m + p + 1
    delta = (p - 1) * (p - phat) / p + 1 if p > 0 else 1.0
    t0 = torch.where(normT > 1, torch.log2(normT.clamp_min(1e-300)), 0.0)
    scalefac = torch.exp2(t0)
    normTs = normT / scalefac
    c = torch.exp((_log_be_coeff(m, p)
                   - delta * torch.log(normTs.clamp_min(1e-300))) / K)
    absA = (c * A.abs() / scalefac).to(rdt)
    alpha = _normpow_nonneg(absA, K)
    eps64 = float(np.finfo(np.float64).eps)
    t = torch.log2((2 * alpha / eps64).clamp_min(1e-300)) / (K - delta) + t0
    ok = torch.isfinite(t) & (normT > 0)
    return torch.where(ok, torch.clamp_min(torch.ceil(t), 0.0), 0.0)


def _select_parameters(A, p: int, max_squarings: int):
    """Joint (branch index i, scaling s) by the equivalent-product cost
    model (paper section 4), on the device with the JAX package's
    arithmetic: (i_star, s) as 0-d int64 tensors."""
    rdt = _real_dtype(torch.promote_types(A.dtype, torch.float32))
    phat_top = p if _phi_theta(_PHI_M_MAX, p) >= 1 else 0
    r_max = int(math.floor(
        (1 + math.sqrt(1 + 4 * (2 * _PHI_M_MAX + phat_top + 1))) / 2))

    # eta_j = ||A^{j+1}||_1^{1/(j+1)}, j = 1..r_max; alpha_r = max(eta_r,
    # eta_{r+1})
    etas = []
    P = A @ A
    etas.append(_onenorm(P).to(rdt) ** (1.0 / 2.0))
    for j in range(2, r_max + 1):
        P = P @ A
        etas.append(_onenorm(P).to(rdt) ** (1.0 / (j + 1)))
    eta = torch.stack(etas)
    alpha = torch.maximum(eta[:-1], eta[1:])           # (r_max - 1,)

    normT = _onenorm(A).to(rdt)
    zero = torch.zeros((), dtype=rdt, device=A.device)
    rows = []
    for i, m_i in enumerate(_PHI_DEGREES):
        theta = _phi_theta(m_i, p)
        phat_i = p if theta >= 1 else 0
        t = _scaling_floor(A, normT, m_i, p, phat_i)
        row = []
        for r in range(2, r_max + 1):
            if 2 * m_i + phat_i + 1 >= r * (r - 1):
                a = alpha[r - 2]
                ok = (a > 0) & torch.isfinite(a)
                s0 = torch.where(ok, torch.maximum(torch.ceil(torch.log2(
                    torch.clamp_min(a, 1e-300) / theta)), t), t)
                row.append(i + p + s0 * (p + 1))
            else:
                row.append(zero)
        rows.append(torch.stack(row))
    C = torch.stack(rows)                               # (8, r_max - 1)

    pos = C > 0
    big = float(np.finfo(np.float64).max / 4)
    if rdt != torch.float64:
        big = math.inf
    minval = torch.where(pos, C, big).min()
    # the reference's tie-break: the last match in column-major order
    flat = C.T.reshape(-1)
    match = (flat == minval) & (flat > 0)
    L = flat.shape[0]
    last = (L - 1) - torch.argmax(match.flip(0).to(torch.int32))
    any_match = match.any()
    i_star = torch.where(any_match, last % C.shape[0], 0)
    s_f = torch.round((minval - i_star.to(rdt) - p) / (p + 1))
    s_ok = torch.isfinite(s_f) & any_match
    s = torch.where(s_ok, s_f, 0.0).clamp(0, max_squarings)
    return i_star.to(torch.int64), s.to(torch.int64)


def _ps_eval_nd(As, m: int, tau: int, p: int):
    """N(As) and D(As) by Paterson-Stockmeyer in Horner form as one
    (2, n, n) stack: tau - 1 + 2 floor(m/tau) - 2 [tau | m] product
    stages, each Horner fold one 2-batched product."""
    dt = As.dtype
    Nc, Dc = _pade_coeffs(m, p)
    pows = [_eye(As), As]
    for _ in range(2, tau + 1):
        pows.append(pows[-1] @ As)
    Atau = pows[tau]

    def block(i):
        # sum_l coef[i tau + l] As^l for both polynomials over the shared
        # powers (the coefficients are Python floats: no host-to-device
        # copy)
        lo, hi = i * tau, min((i + 1) * tau, m + 1)
        N = D = None
        for l in range(hi - lo):
            N = Nc[lo + l] * pows[l] if N is None else N + Nc[lo + l] * pows[l]
            D = Dc[lo + l] * pows[l] if D is None else D + Dc[lo + l] * pows[l]
        return torch.stack([N, D])

    nu = m // tau
    if m % tau == 0:
        ND = torch.stack([Nc[m] * Atau, Dc[m] * Atau]) + block(nu - 1)
        inext = nu - 2
    else:
        ND = block(nu)
        inext = nu - 1
    for i in range(inext, -1, -1):
        ND = ND @ Atau + block(i)
    return ND[0], ND[1]


def _recover_all(X, As, p: int):
    """[phi_0..phi_p] of the scaled matrix from phi_p = X by the downward
    recurrence phi_j = As phi_{j+1} + I/j!."""
    I = _eye(As)
    Fs = [None] * (p + 1)
    Fs[p] = X
    for j in range(p - 1, -1, -1):
        Fs[j] = As @ Fs[j + 1] + _inv_factorial(j) * I
    return torch.stack(Fs)


def _ns_solve(D, N, max_iters: int = 64, differentiable: bool = False):
    """X = D^-1 N without an LU solve: the Newton-Schulz inverse
    Y <- Y (2I - D Y) until the residual |I - D Y|_1 <= 4 eps, then one
    refinement step on X. Seeded by I when |I - D|_1 < 0.9 (D_m(As) is
    close to I by design), else by D^H / (|D|_1 |D|_inf). Each iteration
    reads its stop test to the host; ``differentiable=True`` runs
    ``max_iters`` masked iterations instead (no host read). Non-finite D
    stops at once and propagates NaN."""
    rdt = _real_dtype(D.dtype)
    I = _eye(D)
    n1 = _onenorm(D).to(rdt)
    ninf = D.abs().sum(dim=1).max().to(rdt)
    denom = torch.clamp_min(n1 * ninf, torch.finfo(rdt).tiny)
    Yt = D.mH / denom.to(D.dtype)
    r_eye = _onenorm(I - D).to(rdt)
    Y = torch.where(torch.isfinite(r_eye) & (r_eye < 0.9), I, Yt)
    E = D @ Y
    eps = torch.finfo(rdt).eps
    for _ in range(max_iters):
        r = _onenorm(I - E).to(rdt)
        go = (r > 4 * eps) & torch.isfinite(r)
        if not differentiable:
            if not bool(go):
                break
            Y = Y @ (2.0 * I - E)
        else:
            Y = torch.where(go, Y @ (2.0 * I - E), Y)
        E = D @ Y
    X = Y @ N
    # one residual-correction step washes the last O(eps kappa) of the
    # approximate inverse out of the solution
    return X + Y @ (N - D @ X)


def _denominator_solve(D, N, solve: str, differentiable: bool):
    if solve == "newton":
        return _ns_solve(D, N, differentiable=differentiable)
    return _solve(D, N, differentiable)


@full_precision
def _phi_pade_impl(A, p: int, max_squarings: int, differentiable: bool,
                   solve: str):
    i_dev, s_dev = _select_parameters(A, p, max_squarings)
    if differentiable:
        As = _scaled(A, s_dev.to(_real_dtype(A.dtype)))
        ND = torch.stack([
            torch.stack(_ps_eval_nd(As, m_i, _ps_tau(m_i, i), p))
            for i, m_i in enumerate(_PHI_DEGREES)])
        N, D = ND.index_select(0, i_dev.reshape(1))[0]
        F = _recover_all(_denominator_solve(D, N, solve, True), As, p)
        live = torch.arange(max_squarings, device=A.device) < s_dev
        for j in range(max_squarings):
            F = torch.where(live[j], _double_argument_stage(F, p), F)
        return F
    i, s = torch.stack([i_dev, s_dev]).tolist()     # the one host read
    As = _scaled(A, s)
    m_i = _PHI_DEGREES[i]
    N, D = _ps_eval_nd(As, m_i, _ps_tau(m_i, i), p)
    F = _recover_all(_denominator_solve(D, N, solve, False), As, p)
    for _ in range(s):
        F = _double_argument_stage(F, p)
    return F


def phi_pade(A, k: int, *, max_squarings: int = 64,
             differentiable: bool = False, solve: str = "auto"):
    """[phi_0(A), ..., phi_k(A)] stacked as (k+1, n, n) by the Al-Mohy-Liu
    Pade scaling-and-recovering algorithm (module doc). ``solve``: "device"
    (``torch.linalg.solve``), "newton" (Newton-Schulz, no LU) or "auto"
    (= "device" on every device). Requires k >= 1; use ``expm`` or ``phi``
    for k = 0."""
    if k < 1:
        raise ValueError("phi_pade requires k >= 1; use expm/phi for k = 0")
    if solve == "auto":
        solve = "device"
    if solve not in ("device", "newton"):
        raise ValueError(f"unknown phi_pade solve {solve!r}; "
                         "expected 'auto', 'device' or 'newton'")
    A = _square(A, "phi_pade", stacked=False)
    return _phi_pade_impl(A, int(k), max_squarings, differentiable, solve)


def phi_pade_with_info(A, k: int, **kwargs):
    """``phi_pade`` plus the no-throw info code: 0 = success, 1 = non-finite
    result (a singular Pade denominator or NaN/Inf input)."""
    out = phi_pade(A, k, **kwargs)
    return out, _info(out)

"""A numpy model of R1's algorithm (``ops/kernels/csrc/tridiag.cu``), step
by step, against scipy's ``expm(t T) @ e1`` on R1's hard inputs
(``tridiag_cases.py``): the leading unreduced block, Cuppen's tear down to
leaves of one row, each merge's sort, deflation (``dlaed2``'s small-z and
near-equal-pole Givens rotations), secular roots kept as a pole index plus
an offset, Gu and Eisenstat's recomputed z, the first and last rows carried
up, and s e^{t lambda} (Q^T e1) carried down through every level, with no
eigenvector matrix formed. The model is test code: it settles the
kernel's arithmetic and deflation logic on the CPU. As in the kernel, the
eigenvalues and the carried rows live in vectors indexed by position (a
node [lo, hi) at lo .. hi - 1), and each loop over roots or rows is one
the kernel spreads over its lanes; the deflation is the serial scan,
whose output the kernel's warp writes in parallel up to the first pair
that rotates."""

import math

import numpy as np
import pytest
import scipy.linalg as sla

from tridiag_cases import case_tol, dense, hard_cases, random_tridiagonal

EPS = np.finfo(np.float64).eps
MAX_ITER = 64


def leading_block(d, e):
    """The order of the leading unreduced block: one past the first i whose
    coupling is negligible, |e_i| + |d_i| + |d_{i+1}| == |d_i| + |d_{i+1}|
    (the kernel: every thread tests its i, a block-wide minimum)."""
    m = len(d)
    for i in range(m - 1):
        dd = abs(d[i]) + abs(d[i + 1])
        if abs(e[i]) + dd == dd:
            return i + 1
    return m


def levels(n):
    """The merges of the tear tree over [0, n), by depth from the root: a
    node [lo, hi) of two rows or more splits at lo + (hi - lo) // 2."""
    out, todo = [], [(0, n)]
    while todo:
        level, nxt = [], []
        for lo, hi in todo:
            if hi - lo >= 2:
                mid = lo + (hi - lo) // 2
                level.append((lo, mid, hi))
                nxt += [(lo, mid), (mid, hi)]
        if level:
            out.append(level)
        todo = nxt
    return out


def _quad_root(A, B, C, lo, hi):
    """The root of A x^2 + B x + C in (lo, hi), by the stable formulas;
    the bracket's midpoint when neither root lies in it."""
    disc = math.sqrt(max(B * B - 4 * A * C, 0.0))
    q = -0.5 * (B + math.copysign(disc, B))
    for x in (q / A if A != 0 else math.nan, C / q if q != 0 else math.nan):
        if lo < x < hi:
            return x
    return (lo + hi) / 2


def secular_root(dk, zk, rho, k, stats):
    """Root k of 1/rho + sum_i z_i^2 / (d_i - lambda) (kept poles dk
    ascending, rho > 0) as (origin, tau), lambda = dk[origin] + tau: the
    origin is the pole nearer the root, so every d_i - lambda is formed as
    (d_i - d_origin) - tau without cancellation (dlaed4's representation).
    The first guess solves the model with the root's two poles exact and
    the other terms frozen at the interval's midpoint; each step solves a
    two-pole rational model of the middle way (psi and phi each by their
    pole next to the root, fitted to value and slope) or of the fixed
    weight (the origin's own term exact), switching from one to the other
    when |f| fails to fall tenfold (dlaed4's switch), kept inside a
    bracket by bisection."""
    K = len(dk)
    zz = zk * zk
    last = k == K - 1
    if last:
        o = k
        lo, hi = 0.0, rho * zz.sum()
        # the other poles frozen at the midpoint, the last two exact
        dd = 1.0 if K == 1 else dk[k] - dk[k - 1]
        z2 = 0.0 if K == 1 else zz[k - 1]
        c = 1 / rho + np.sum(zz[:max(k - 1, 0)]
                             / ((dk[:max(k - 1, 0)] - dk[k]) - hi / 2))
        tau = _quad_root(c, c * dd - z2 - zz[k], -zz[k] * dd, lo, hi * 1.0000001)
        tau = min(tau, hi)
    else:
        dd = dk[k + 1] - dk[k]
        h = dd / 2
        others = np.arange(K)
        others = (others != k) & (others != k + 1)
        c = 1 / rho + np.sum(zz[others] / ((dk[others] - dk[k]) - h))
        # its sign at the midpoint says which pole is nearer
        if c + zz[k] / -h + zz[k + 1] / h >= 0:
            o, lo, hi = k, 0.0, h
            tau = _quad_root(c, -(c * dd + zz[k] + zz[k + 1]), zz[k] * dd,
                             lo, hi)
        else:
            o, lo, hi = k + 1, -h, 0.0
            tau = _quad_root(c, c * dd - zz[k] - zz[k + 1], -zz[k + 1] * dd,
                             lo, hi)
    base = dk - dk[o]
    fw, fprev = True, math.inf
    for it in range(MAX_ITER):
        delta = base - tau
        q = zz / delta
        psi, dpsi = q[:k + 1].sum(), (q[:k + 1] / delta[:k + 1]).sum()
        phi, dphi = q[k + 1:].sum(), (q[k + 1:] / delta[k + 1:]).sum()
        f = 1 / rho + psi + phi
        err = EPS * (8 * (phi - psi) + 2 / rho + abs(tau) * (dpsi + dphi))
        if abs(f) <= err:
            break
        if f < 0:
            lo = tau
        else:
            hi = tau
        if it == 1:
            # after the first (fixed weight) step: the middle way when f
            # fell less than tenfold on the origin's side (dlaed4)
            fw = not (-f if o == k else f) > 0.1 * abs(fprev)
        elif it > 1 and f * fprev > 0 and abs(f) > 0.1 * abs(fprev):
            fw = not fw
        fprev = f
        da = delta[k]
        if last:
            # the last term exact, the others by the pole next to it,
            # fitted to their value and slope: both poles lie left of the
            # root, the larger root of the model's quadratic
            s = 0.0
            db = da
            if k > 0:
                da = delta[k - 1]
                s = (dpsi - zz[k] / (db * db)) * da * da
            c = f - s / da - zz[k] / db if k > 0 else f - zz[k] / db
            a1 = c * (da + db) + s + zz[k] if k > 0 else c * db + zz[k]
            a0 = da * db * f if k > 0 else 0.0
            if k == 0:
                eta = db + zz[k] / c if c > 0 else math.nan
            else:
                disc = math.sqrt(max(a1 * a1 - 4 * c * a0, 0.0))
                eta = ((a1 + disc) / (2 * c) if a1 >= 0
                       else 2 * a0 / (a1 - disc))
        else:
            db = delta[k + 1]
            if not fw:
                s, S = dpsi * da * da, dphi * db * db
            elif o == k:
                s = zz[k]
                S = (dpsi - zz[k] / (da * da) + dphi) * db * db
            else:
                S = zz[k + 1]
                s = (dphi - zz[k + 1] / (db * db) + dpsi) * da * da
            c = f - s / da - S / db
            a1 = c * (da + db) + s + S
            a0 = da * db * f
            disc = math.sqrt(max(a1 * a1 - 4 * c * a0, 0.0))
            eta = ((a1 - disc) / (2 * c) if a1 <= 0
                   else 2 * a0 / (a1 + disc))
        tn = tau + eta
        if not (lo < tn < hi):
            tn = (lo + hi) / 2
        if tn == tau or (hi - lo) <= 2 * EPS * max(abs(lo), abs(hi)):
            tau = tn
            break
        tau = tn
    else:
        stats["unconverged"] += 1
    stats["secular_iters"] = max(stats["secular_iters"], it + 1)
    return o, tau


def merge(lo, mid, hi, beta, lam, frow, lrow, rec, stats):
    """One merge of the up pass (module doc): node [lo, hi) from its
    children [lo, mid) and [mid, hi), torn at coupling ``beta``. Reads
    the children's eigenvalues and rows at lo .. hi - 1, writes the node's;
    returns what the down pass needs."""
    n, n1 = hi - lo, mid - lo
    rho = 2 * abs(beta)
    sgn = 1.0 if beta >= 0 else -1.0
    j = np.arange(n)
    # the rank-one update D + rho z z^T in the children's eigenbases
    poles = lam[lo:hi].copy()
    z = np.where(j < n1, lrow[lo:hi], sgn * frow[lo:hi]) / math.sqrt(2.0)
    gf = np.where(j < n1, frow[lo:hi], 0.0)
    gl = np.where(j < n1, 0.0, lrow[lo:hi])
    # stable rank sort: sorted position s holds child coordinate sidx[s]
    rank = np.array([np.sum((poles < poles[i])
                            | ((poles == poles[i]) & (j < i)))
                     for i in range(n)])
    sidx = np.empty(n, np.int64)
    sidx[rank] = j
    ds, zs, gf, gl = poles[sidx], z[sidx], gf[sidx], gl[sidx]
    # deflation, one thread a node (dlaed2)
    tol = 8 * EPS * max(np.abs(ds).max(), np.abs(zs).max())
    col = np.empty(n, np.int64)
    K, ndef, rots, pj = 0, 0, [], -1
    for s in range(n):
        if rho * abs(zs[s]) <= tol:
            ndef += 1
            col[n - ndef] = s
            stats["deflated_z"] += 1
            continue
        if pj < 0:
            pj = s
            continue
        # |t c s| <= tol, as |t z_s z_pj| <= tol (z_s^2 + z_pj^2): no root
        # or division unless the pair rotates
        if (abs((ds[s] - ds[pj]) * zs[s] * zs[pj])
                <= tol * (zs[s] * zs[s] + zs[pj] * zs[pj])):
            tau = math.hypot(zs[s], zs[pj])
            c, sn = zs[s] / tau, -zs[pj] / tau
            zs[s], zs[pj] = tau, 0.0
            for g in (gf, gl):
                g[pj], g[s] = c * g[pj] + sn * g[s], c * g[s] - sn * g[pj]
            ds[pj], ds[s] = (ds[pj] * c * c + ds[s] * sn * sn,
                             ds[pj] * sn * sn + ds[s] * c * c)
            rots.append((pj, s, c, sn))
            ndef += 1
            col[n - ndef] = pj
            stats["deflated_pair"] += 1
            pj = s
        else:
            col[K] = pj
            K += 1
            pj = s
    if pj >= 0:
        col[K] = pj
        K += 1
    assert K + ndef == n
    dk, zk = ds[col[:K]], zs[col[:K]]
    assert np.all(np.diff(dk) > 0)
    # one thread a root
    org, tau = np.empty(K, np.int64), np.empty(K)
    for k in range(K):
        org[k], tau[k] = secular_root(dk, zk, rho, k, stats)
    # Gu and Eisenstat: z from the roots, one thread a pole
    zh = np.empty(K)
    for i in range(K):
        p = (tau[i] + (dk[org[i]] - dk[i])) / rho
        for jj in range(K):
            if jj != i:
                p *= (tau[jj] + (dk[org[jj]] - dk[i])) / (dk[jj] - dk[i])
        zh[i] = math.copysign(math.sqrt(p), zk[i])
    # delta[i, q] = d_i - lambda_q, the column norms, eigenvalues and rows
    delta = (dk[:, None] - dk[org][None, :]) - tau[None, :]
    u = zh[:, None] / delta
    inrm = 1 / np.sqrt((u * u).sum(0))
    lam[lo:lo + K] = dk[org] + tau
    lam[lo + K:hi] = ds[col[K:]]
    frow[lo:lo + K] = (gf[col[:K]] @ u) * inrm
    frow[lo + K:hi] = gf[col[K:]]
    lrow[lo:lo + K] = (gl[col[:K]] @ u) * inrm
    lrow[lo + K:hi] = gl[col[K:]]
    return sidx, col, K, rots, u * inrm[None, :]


def down(lo, hi, rec, w):
    """One node of the down pass: w (the node's eigen-coordinates, at
    lo .. hi - 1) becomes the children's, in place."""
    sidx, col, K, rots, U = rec
    n = hi - lo
    v = np.empty((n,) + w.shape[1:])
    v[col[:K]] = U @ w[lo:lo + K]
    v[col[K:]] = w[lo + K:hi]
    for pj, nj, c, sn in reversed(rots):
        v[pj], v[nj] = c * v[pj] - sn * v[nj], sn * v[pj] + c * v[nj]
    w[lo + sidx] = v


def dc_exp_e1(a, b, t, s=None, stats=None):
    """The model: s Q exp(t Lambda) Q^T e1 of the tridiagonal (a, b)."""
    stats = {} if stats is None else stats
    for k in ("deflated_z", "deflated_pair", "unconverged", "secular_iters"):
        stats.setdefault(k, 0)
    m = len(a)
    cplx = isinstance(t, complex)
    out = np.zeros(m, complex if cplx else float)
    if m == 0:
        return out
    n = leading_block(a, b)
    stats["m_eff"] = n
    mx = max(np.abs(a[:n]).max(), np.abs(b[:n - 1]).max() if n > 1 else 0)
    scale = 2.0 ** math.frexp(mx)[1] if mx > 0 else 1.0
    d, e = a[:n] / scale, b[:n - 1] / scale
    # the tear: every coupling inside the block is cut once
    ae = np.abs(e)
    lam = d.copy()
    lam[:-1] -= ae
    lam[1:] -= ae
    frow, lrow = np.ones(n), np.ones(n)
    lv = levels(n)
    recs = []
    for level in reversed(lv):
        recs.append([(lo, hi, merge(lo, mid, hi, e[mid - 1], lam, frow,
                                    lrow, None, stats))
                     for lo, mid, hi in level])
    stats["levels"] = len(lv)
    # the root: w = s e^{t lambda} (Q^T e1), real and imaginary parts
    tl = t * lam * scale
    w = np.stack([np.exp(tl).real * frow, np.exp(tl).imag * frow], axis=1)
    if s is not None:
        w *= s
    for level in reversed(recs):
        for lo, hi, rec in level:
            down(lo, hi, rec, w)
    out[:n] = w[:, 0] + 1j * w[:, 1] if cplx else w[:, 0]
    if stats["unconverged"]:
        out[:] = np.nan
    return out


def _oracle(a, b, t, s=None):
    e = sla.expm(t * dense(a, b))[:, 0]
    return e if s is None else s * e


CASES = hard_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_model_vs_scipy_hard_inputs(case):
    """The model against scipy on every hard input, at R1_TOL x max(1,
    |t| ||T||_1) of the largest entry, with and without s."""
    name, a, b, t = case
    st = {}
    got = dc_exp_e1(a, b, t, stats=st)
    want = _oracle(a, b, t)
    tol = case_tol(a, b, t)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, name
    assert not st["unconverged"] and st["secular_iters"] <= 32
    gots = dc_exp_e1(a, b, t, 1.7)
    assert np.abs(gots - 1.7 * want).max() <= tol * 1.7 * scale
    if st["m_eff"] < len(a):
        assert not np.any(got[st["m_eff"]:])


@pytest.mark.parametrize("m,tail", [(1, 0), (2, 0), (3, 0), (20, 0),
                                    (40, 0), (60, 0), (250, 0), (40, 37)])
@pytest.mark.parametrize("t", [0.6, 0.6 - 0.8j])
def test_model_vs_scipy_random(m, tail, t):
    """The R1 tests' random tridiagonals (norm ~4) at R1_TOL; a masked
    tail is the leading block's and comes out exactly zero."""
    a, b = random_tridiagonal(m, 71 + m, tail)
    st = {}
    got = dc_exp_e1(a, b, t, stats=st)
    want = _oracle(a, b, t)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert st["m_eff"] == m - tail
    if tail:
        assert not np.any(got[m - tail:])


def test_model_takes_every_deflation_path():
    """The hard inputs reach both deflations: W+ pairs rotate near-equal
    poles, the glued blocks' tiny couplings deflate small z."""
    st = {}
    dc_exp_e1(*hard_cases()[1][1:3], -0.05, stats=st)
    assert st["deflated_pair"] > 0
    st = {}
    dc_exp_e1(*hard_cases()[2][1:3], 0.3, stats=st)
    assert st["deflated_z"] > 0
    st = {}
    dc_exp_e1(*random_tridiagonal(250, 321), 0.6, stats=st)
    assert st["levels"] == 8 and st["m_eff"] == 250


def test_levels_cover_every_coupling_once():
    """The tear tree cuts each coupling of the block exactly once (the
    tear subtracts |e_i| from both of its rows)."""
    for n in (2, 3, 7, 40, 250):
        cuts = sorted(mid - 1 for lv in levels(n) for _, mid, _ in lv)
        assert cuts == list(range(n - 1))
        assert len(levels(n)) == math.ceil(math.log2(n))

"""Faber-series actions on a field-of-values ellipse (PyTorch port of
``exponentialutilities_jl_tpu/models/faber.py``): the non-Hermitian
polynomial path without the Newton basis' conditioning cap.

For an ellipse E = {c + alpha cos(theta) + i beta sin(theta)} (c real,
alpha >= beta >= 0) enclosing the numerical range, with gamma =
(alpha + beta)/2 and rho = (alpha - beta)/(alpha + beta), the Faber
polynomials of E obey the three-term recurrence

    g_1 = A^ b,  g_{k+1} = A^ g_k - rho g_{k-1},  A^ = (A - cI)/gamma,

with g_0 = 2b inside the recurrence and a_0 b in the sum. Their norms on
E stay below 1 + rho^k <= 2, and by Crouzeix's theorem |F_k(A)| <=
2(1 + sqrt 2) when W(A) lies in E, so the iterates never grow and one
substep can carry |t| gamma in the hundreds (``max_z`` = 512). The
coefficients a_k are one FFT of f(psi(w)) sampled on the unit circle
(psi(w) = c + gamma (w + rho/w)); the uniform tail bound
sum_{k>m} |a_k| (1 + rho^k) truncates them as the Leja module truncates
its divided differences, with the same raise on non-convergence.

``fov_ellipse`` takes the Hermitian/skew split A = H + S: the real extent
from H and the imaginary half-extent from S, exactly (eigvalsh) for a
dense operator, by Gershgorin for the diagonal-storage and constant
stencil containers.

On a CUDA device with real coefficients, real float32/float64 data and an
operator that ``ops.kernels.dispatch.recurrence_engine`` supports, every
Faber pass is one launch of a hand-written kernel (B1, B5, B6, or one B3
sweep a step) with the (m, 4) rows (1/gamma, -c/gamma, cc_k, a_k),
cc_0 = 0, cc_1 = -2 rho (the g_0 = 2b weight), cc_k = -rho after; the rows
are copied to the device once per call (once per snapshot interval in
``phiv_timestep_faber``). A phi action's (m, p) stack on a 1-D stencil
that passes ``resident_multi_ok`` is one B4 launch. Complex coefficients,
every other operator and CPU tensors take the plain torch loops
``_faber_apply`` and ``_nw_faber_scan``. Each loop is one masked step run
its count of times, as in ``models/leja.py`` (its module doc): a plain
loop's step one Faber term, k = i mod m, with cc_k read from a device
table; an engine loop's step one substep.

Failure protocol (``_check_finite_faber``, one host read): a non-finite
result raises, and so does a result whose norm exceeds the bound
(1 + sqrt 2) sup_E |f| |b| that the claimed ellipse implies (times a
slack of 64), which catches a finite but wrong answer from an ellipse
that does not enclose W(A).

A row-sharded operator (``parallel.shard_operator``) runs the plain loops
on this rank's rows with the global operator's ellipse (its
``fov_ellipse_hint``); the guard's norms and finiteness are reduced over
the operator's ``comm``, so every rank raises together.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.krylov import _run, _State
from ..ops.sparse import BandedOperator
from ..ops.stencil import StencilOperator
from ..utils.comm import all_finite, operator_comm, vector_norm
from ..utils.device import action_vector
from ..utils.linop import DenseOperator, aslinearoperator
from ..utils.precision import full_precision
from .chebyshev import _phi_scalar_np
from .leja import (_apply_columns, _combo_cols, _constant_combination,
                   _device_time, _engine, _engine_substeps, _host_to, _march,
                   _nw_engine_substeps, _nw_fused_substep,
                   _signed_marches, _truncate_dd,
                   real_interval)

__all__ = ["expv_faber", "phiv_faber", "phiv_timestep_faber",
           "fov_ellipse", "faber_coeffs"]

_MAX_DEGREE = 4096      # per substep: a size cap, not a stability cap
_CROUZEIX = 1.0 + np.sqrt(2.0)     # |f(A)| <= (1 + sqrt 2) sup_W(A) |f|
_GUARD_SLACK = 64.0                # truncation and roundoff headroom


def _banded_hs_gershgorin(op):
    """(real interval of H, imaginary half-extent of S) for a
    ``BandedOperator`` by Gershgorin on the Hermitian/skew split, computed
    where the diagonals live; returns host floats (one transfer)."""
    D = op.diags.detach()
    n = D.shape[1]
    by_off = {o: D[i] for i, o in enumerate(op.offsets)}
    d0 = by_off.get(0, torch.zeros(n, dtype=D.dtype, device=D.device))
    rdt = d0.real.dtype
    radH = torch.zeros(n, dtype=rdt, device=D.device)
    radS = torch.zeros(n, dtype=rdt, device=D.device)
    for o in op.offsets:
        if o == 0:
            continue
        u = by_off[o]                       # A[i, i+o]
        v = by_off.get(-o)                  # A[i+o, i] = v[i+o]
        vt = torch.zeros_like(u)
        if v is not None:
            if o > 0:
                vt[:n - o] = v[o:]
            else:
                vt[-o:] = v[:n + o]
        # H[i, i+o] = (A[i, i+o] + conj(A[i+o, i]))/2, S with the minus
        radH = radH + 0.5 * (u + vt.conj()).abs()
        radS = radS + 0.5 * (u - vt.conj()).abs()
    lo, hi, beta = torch.stack([
        (d0.real - radH).min(), (d0.real + radH).max(),
        (radS + d0.imag.abs() if d0.is_complex() else radS).max()]).tolist()
    return (lo, hi), beta


def fov_ellipse(A) -> tuple[float, float, float]:
    """(c, alpha, beta): an axis-aligned ellipse enclosing the numerical
    range W(A), from A = H + i S' (H, S' Hermitian): Re W(A) =
    [min eig H, max eig H], Im W(A) within +-max|eig S'|. Exact on a dense
    operator (host eigvalsh), Gershgorin on ``BandedOperator`` and
    constant ``StencilOperator``; a Hermitian operator of another kind
    gets its ``real_interval`` and beta = 0. An operator with a
    ``fov_ellipse_hint`` (a sharded one: its global operator's ellipse)
    answers for itself."""
    op = aslinearoperator(A)
    hint = getattr(op, "fov_ellipse_hint", None)
    if callable(hint):
        return hint()
    if isinstance(op, DenseOperator):
        M = op.A.detach().cpu().numpy()
        wh = np.linalg.eigvalsh((M + M.conj().T) / 2)
        ws = np.linalg.eigvalsh((M - M.conj().T) / (2j))
        pad = 1e-3 * max(wh[-1] - wh[0], 1e-300)
        c = 0.5 * float(wh[0] + wh[-1])
        alpha = 0.5 * float(wh[-1] - wh[0]) + pad
        beta = float(max(abs(ws[0]), abs(ws[-1]))) * (1 + 1e-3)
        return c, alpha, beta
    if isinstance(op, BandedOperator):
        (lo, hi), beta = _banded_hs_gershgorin(op)
        return 0.5 * (lo + hi), 0.5 * (hi - lo), beta
    if isinstance(op, StencilOperator):
        # H[i, i+o] = (c_o + conj(c_{-o}))/2, S with the minus; the
        # Gershgorin radii are sums over offsets (boundary rows smaller)
        cmap = {off: complex(v) for off, v in zip(op.offsets, op.host_coeffs)}
        d0 = cmap.get(tuple([0] * len(op.grid_shape)), 0.0)
        radH = radS = 0.0
        for off, v in cmap.items():
            if all(o == 0 for o in off):
                continue
            w = np.conj(cmap.get(tuple(-o for o in off), 0.0))
            radH += abs((v + w) / 2)
            radS += abs((v - w) / 2)
        lo, hi = d0.real - radH, d0.real + radH
        return 0.5 * (lo + hi), 0.5 * (hi - lo), radS + abs(d0.imag)
    if op.is_hermitian:
        lo, hi = real_interval(op)
        return 0.5 * (lo + hi), 0.5 * (hi - lo), 0.0
    raise TypeError(
        f"no fov_ellipse rule for {type(op).__name__}; pass "
        "ellipse=(c, alpha, beta) explicitly")


def _psi_samples(t, c, gamma, rho, nsamp: int):
    """t psi(e^{i theta}) on an nsamp-point uniform circle (numpy
    complex)."""
    th = 2.0 * np.pi * np.arange(nsamp) / nsamp
    w = np.exp(1j * th)
    return t * (c + gamma * (w + rho / w))


def faber_coeffs(fvals, rho, m: int):
    """The first ``m`` Faber coefficients a_k from samples of f(psi(.)) on
    the circle (FFT), and the sup-norm weights 1 + rho^k of |F_k|_E. Use
    at least 4m samples so the rho^k-damped w^{-k} tail cannot alias into
    the kept range."""
    nsamp = len(fvals)
    if nsamp < 2 * m:
        raise ValueError(f"need >= {2 * m} samples for degree {m}")
    a = np.fft.fft(np.asarray(fvals)) / nsamp
    return a[:m], 1.0 + rho ** np.arange(m)


def _faber_cc(m: int, rho: float):
    """The recurrence's cc_k, host numpy: 0, -2 rho (the g_0 = 2b weight),
    then -rho."""
    cc = np.full(m, -rho)
    cc[0] = 0.0
    if m > 1:
        cc[1] = -2.0 * rho
    return cc


@full_precision
def _faber_apply(op, b, a, center: float, inv_gamma: float, rho: float,
                 q: int):
    """q substeps of the degree-(m-1) Faber form, plain torch: ``a`` (m,)
    gives (n,), ``a`` (m, p) gives (n, p) (q must be 1). ``a`` is a tensor
    on b's device, complex where its coefficients are. One term a step,
    g_{k+1} = A^ g_k + cc_k g_{k-1} (``_faber_cc``; the same bits as
    -rho g_{k-1} and -rho (2 b)), q m steps; with q > 1 a substep's last
    term starts the next from its result (module doc)."""
    m = a.shape[0]
    reset = a.ndim == 1 and q > 1
    cc = _host_to(_faber_cc(m, rho), b)

    def accum(w, g, ak):
        if a.ndim == 1:
            return w + ak * g
        return w + g[:, None] * ak[None, :]

    def real_of(w):
        return w.real if w.is_complex() and not b.is_complex() else w

    S = _State(b.device, gp=torch.zeros_like(b), g=b.clone(),
               w=torch.zeros(b.shape + a.shape[1:], dtype=a.dtype,
                             device=b.device))

    def step():
        k = torch.remainder(S.jj[:1], m)
        g = S.g
        w = accum(S.w, g, a.index_select(0, k)[0])
        gn = (inv_gamma * (op.matvec(g) - center * g)
              + cc.index_select(0, k)[0] * S.gp)
        if reset:           # a substep's last term: its w starts the next
            last = k[0] == m - 1
            gn = torch.where(last, real_of(w), gn)
            w = torch.where(last, 0, w)
        S.set("w", w)
        S.set("gp", g)
        S.set("g", gn)
        S.step_on()

    _run("faber_apply", op, S, step, q * m if a.ndim == 1 else m, b.device)
    if a.ndim == 2:
        return S.w
    return S.g if reset else real_of(S.w)


def _faber_rows(a_col, c, inv_gamma, rho):
    """(m, 4) rows of the Faber form, host numpy: g_{k+1} = inv_gamma
    (A - c) g_k - rho g_{k-1}, w += a_k g_k, the k = 1 step's cc = -2 rho
    carrying the g_0 = 2b weight."""
    m = len(a_col)
    return np.stack([np.full(m, inv_gamma), np.full(m, -inv_gamma * c),
                     _faber_cc(m, rho), np.asarray(a_col)], axis=1)


def _apply_fused_faber(op, b, A_coeffs, c, inv_gamma, rho, q: int, apply,
                       fused=None):
    """Engine twin of ``_faber_apply`` (real coefficients): (m,) gives q
    exact substeps, one launch each with rows copied once; (m, p) the p
    columns (one B4 launch or one pass a column)."""
    A_coeffs = np.asarray(A_coeffs)
    if A_coeffs.ndim == 1:
        rows = _host_to(_faber_rows(A_coeffs, c, inv_gamma, rho), b)
        return _engine_substeps(op, b, rows, q, apply, "faber substeps")
    rows = np.stack([_faber_rows(A_coeffs[:, j], c, inv_gamma, rho)
                     for j in range(A_coeffs.shape[1])])
    return _apply_columns(op, b, rows, A_coeffs, apply, fused)


def _resolve_ellipse(op, ellipse):
    if ellipse is not None:
        c, alpha, beta = (float(ellipse[0]), float(ellipse[1]),
                          float(ellipse[2]))
    else:
        c, alpha, beta = fov_ellipse(op)
    if beta > alpha:
        # foci on the real axis need alpha >= beta: a taller-than-wide
        # range is enclosed by the containing disk (rho = 0)
        alpha = beta
    gamma = 0.5 * (alpha + beta)
    rho = (alpha - beta) / (alpha + beta) if alpha + beta > 0 else 0.0
    return c, alpha, beta, gamma, rho


def _probe_degree_faber(z: float, tol: float) -> int:
    """Generous probe degree for the per-substep z = |t| gamma."""
    return min(_MAX_DEGREE, int(np.ceil(
        3.0 * z + 2.5 * np.sqrt(max(z, 1.0) * np.log(1.0 / tol)) + 16)))


def _nsamp(m_probe: int) -> int:
    return 1 << int(np.ceil(np.log2(4 * m_probe)))


def _faber_expv_setup(op, t, ellipse, tol, m, max_z, *,
                      complex_b: bool = False):
    """Host coefficient setup of ``expv_faber``: (a, c, gamma, rho, q,
    m_used, log_sup), the coefficients made real where their imaginary
    part is roundoff and b is real, log_sup the log of sup |exp| on the
    ellipse's boundary (the Crouzeix guard). a is None when A ~ cI."""
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    tf = float(t)
    if gamma <= 0:
        return None, c, gamma, rho, 0, 0, 0.0
    q = max(1, int(np.ceil(abs(tf) * gamma / max_z)))
    tau = tf / q
    z = abs(tau) * gamma
    m_probe = _probe_degree_faber(z, tol)
    with np.errstate(over="ignore"):
        vals = np.exp(_psi_samples(tau, c, gamma, rho, _nsamp(m_probe)))
    if not np.isfinite(vals).all():
        raise FloatingPointError(
            f"expv_faber: exp overflows on the ellipse boundary "
            f"(max Re tau z ~ {tau * (c + alpha):.3g}) - shrink max_z")
    a, sup = faber_coeffs(vals, rho, m_probe)
    m_used = _truncate_dd(np.abs(a) * sup, tol, m_probe, m,
                          f"expv_faber (z = {z:.1f} per substep)")
    if not complex_b and abs(np.imag(a[:m_used])).max() <= \
            1e-12 * max(np.abs(a[:m_used]).max(), 1e-300):
        a = np.real(a)
    log_sup = np.log(max(float(np.abs(vals).max()), 1e-300))
    return a, c, gamma, rho, q, m_used, log_sup


def _norms_read(U, extra=(), comm=None):
    """The one host read of a result: (finite, max column norm, *extra
    norms); over every rank's rows with ``comm``."""
    U2 = U if U.ndim == 2 else U[:, None]
    rdt = U2.real.dtype if U2.is_complex() else U2.dtype
    vals = torch.stack([all_finite(U2, comm).to(rdt),
                        vector_norm(U2, comm, dim=0).max().to(rdt),
                        *[e.to(rdt) for e in extra]]).tolist()
    return bool(vals[0]), vals[1], vals[2:]


def _check_finite_faber(U, what: str, log_bound=None, bnorm=None, *,
                        read=None):
    """No-silent-failure protocol: raise on a non-finite result and on a
    result whose norm exceeds the numerical-range bound of the claimed
    ellipse (``log_bound`` is log of (1 + sqrt 2) sup_E |f| without the
    |b| factor, ``bnorm`` the start vector's norm). ``read`` is
    ``_norms_read``'s answer when the caller made it."""
    finite, nrm, _ = read if read is not None else _norms_read(U)
    if not finite:
        raise FloatingPointError(
            f"{what} diverged (non-finite result): check the ellipse "
            "encloses the numerical range (pass ellipse=(c, alpha, beta) "
            "from a trusted source, or widen it), or use the Krylov path")
    if log_bound is not None:
        bound = log_bound + np.log(max(bnorm, 1e-300))
        if nrm > 0 and np.log(nrm) > bound + np.log(_GUARD_SLACK):
            raise FloatingPointError(
                f"{what}: result norm {nrm:.3e} exceeds the "
                f"numerical-range bound e^{bound:.3g} implied by the "
                "ellipse - the ellipse does not enclose the numerical "
                "range; widen it or use the Krylov path")
    return U


def _no_engine_for_complex(fused, what):
    if fused:
        raise ValueError(f"fused=True: {what} has complex Faber "
                         "coefficients, which no CUDA engine takes")


def expv_faber(t, A, b, *, ellipse=None, tol: float = 1e-7,
               m: int | None = None, max_z: float = 512.0,
               fused: bool | None = None):
    """exp(tA) b by a Faber series on the field-of-values ellipse: one pass
    a substep, no inner products, non-Hermitian A allowed, and (unlike
    ``expv_leja``) no basis-conditioning cap on the per-substep
    z = |t| gamma.

    ellipse: (c, alpha, beta) enclosing the numerical range; None takes
      ``fov_ellipse``.
    tol: coefficient tail cutoff (relative, sup-norm weighted).
    m: fixed degree (bypasses the convergence raise).
    max_z: per-substep |t| gamma budget; a longer t substeps exactly.
    fused: demand (True) or forbid (False) the CUDA engines; None = auto.
    """
    op = aslinearoperator(A)
    b = action_vector(b, op)
    a, c, gamma, rho, q, m_used, log_sup = _faber_expv_setup(
        op, t, ellipse, tol, m, max_z, complex_b=b.is_complex())
    if a is None:                       # A ~ cI
        return math.exp(float(t) * c) * b
    a = a[:m_used]
    eng = None
    if np.iscomplexobj(a):
        _no_engine_for_complex(fused, "expv_faber")
    else:
        eng = _engine(op, b, fused)
    if eng is not None:
        out = _apply_fused_faber(op, b, a, c, 1.0 / gamma, rho, q, eng)
    else:
        out = _faber_apply(op, b, _host_to(a, b, real=False), c,
                           1.0 / gamma, rho, q)
    if not b.is_complex() and out.is_complex():
        out = out.real
    comm = operator_comm(op)
    read = _norms_read(out, (vector_norm(b, comm),), comm)
    return _check_finite_faber(out, "expv_faber",
                               q * (np.log(_CROUZEIX) + log_sup),
                               read[2][0], read=read)


def phiv_faber(t, A, b, k: int, *, ellipse=None, tol: float = 1e-7,
               m: int | None = None, max_z: float = 512.0,
               fused: bool | None = None):
    """[phi_0(tA)b ... phi_k(tA)b] (n, k+1) by Faber series, every order
    from one recurrence. phi actions do not substep exactly: |t| gamma
    beyond ``max_z`` raises (use ``phiv_timestep_faber``)."""
    op = aslinearoperator(A)
    b = action_vector(b, op)
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    tf = float(t)
    if gamma <= 0:
        vals = _phi_scalar_np(np.asarray([tf * c]), k)[:, 0]
        return torch.stack([float(v) * b for v in vals], dim=-1)
    z = abs(tf) * gamma
    if z > max_z:
        raise ValueError(
            f"|t|*gamma = {z:.1f} exceeds max_z = {max_z}: phi actions "
            "have no exact substepping - use phiv_timestep_faber for "
            "stiff horizons")
    m_probe = _probe_degree_faber(z, tol)
    samples = _psi_samples(1.0, c, gamma, rho, _nsamp(m_probe))
    V = _phi_scalar_np(tf * samples, k)          # (k+1, nsamp)
    if not np.isfinite(V).all():
        raise FloatingPointError(
            "phiv_faber: phi overflows on the ellipse boundary - shrink t "
            "or use the Krylov path")
    D = np.stack([faber_coeffs(V[j], rho, m_probe)[0]
                  for j in range(k + 1)], axis=1)      # (m, k+1)
    sup = 1.0 + rho ** np.arange(m_probe)
    m_used = _truncate_dd(np.abs(D).max(axis=1) * sup, tol, m_probe, m,
                          f"phiv_faber (z = {z:.1f})")
    D = D[:m_used]
    if not b.is_complex() and abs(np.imag(D)).max() <= \
            1e-12 * max(np.abs(D).max(), 1e-300):
        D = np.real(D)
    eng = None
    if np.iscomplexobj(D):
        _no_engine_for_complex(fused, "phiv_faber")
    else:
        eng = _engine(op, b, fused)
    if eng is not None:
        W = _apply_fused_faber(op, b, D, c, 1.0 / gamma, rho, 1, eng, fused)
    else:
        W = _faber_apply(op, b, _host_to(D, b, real=False), c, 1.0 / gamma,
                         rho, 1)
    if not b.is_complex() and W.is_complex():
        W = W.real
    comm = operator_comm(op)
    read = _norms_read(W, (vector_norm(b, comm),), comm)
    log_bound = (np.log(_CROUZEIX)
                 + np.log(max(float(np.abs(V).max()), 1e-300)))
    return _check_finite_faber(W, "phiv_faber", log_bound, read[2][0],
                               read=read)


@full_precision
def _nw_faber_scan(op, u, B, D, center: float, inv_gamma: float, rho: float,
                   t0: float, tau: float, p: int, q: int):
    """q substeps of the direct phi combination of
    ``leja._nw_leja_scan`` with the Faber recurrence, plain torch. ``D``
    (m, p+1), tau^j folded in. One term a step, q m steps (module doc)."""
    m = D.shape[0]
    cdt = D.dtype
    cc = _host_to(_faber_cc(m, rho), u)

    def real_of(w):
        return w.real if w.is_complex() and not u.is_complex() else w

    tcur = _device_time(t0, u)
    G = _combo_cols(u, B, tcur, p)
    S = _State(u.device, G=G, Gp=torch.zeros_like(G),
               w=torch.zeros(u.shape, dtype=cdt, device=u.device), tcur=tcur)

    def step():
        k = torch.remainder(S.jj[:1], m)
        G = S.G
        w = S.w + D.index_select(0, k)[0] @ G.to(cdt)
        Gn = G
        if m > 1:
            AG = torch.stack([op.matvec(r) for r in G])
            Gn = (inv_gamma * (AG - center * G)
                  + cc.index_select(0, k)[0] * S.Gp)
        if q > 1:
            last = k[0] == m - 1
            tn = S.tcur + tau
            Gn = torch.where(last, _combo_cols(real_of(w), B, tn, p), Gn)
            w = torch.where(last, 0, w)
            S.apply("tcur", torch.where, last, tn, S.tcur)
        S.set("w", w)
        if m > 1:
            S.set("Gp", G)
        S.set("G", Gn)
        S.step_on()

    _run("nw_faber", op, S, step, q * m, u.device)
    return S.G[0] if q > 1 else real_of(S.w)


# One NW substep through an engine: the Leja driver's, with Faber rows.
_nw_fused_substep_faber = _nw_fused_substep


def phiv_timestep_faber(ts, A, B, *, ellipse=None, tol: float = 1e-7,
                        max_z: float = 512.0,
                        max_degree: int | None = None,
                        fused: bool | None = None):
    """u(t) = sum_j t^j phi_j(tA) b_j at the snapshot times ``ts`` for
    non-Hermitian A: the substepped direct phi combination of
    ``phiv_timestep_leja`` in the Faber ellipse basis, which lifts that
    driver's z ~ 150 conditioning envelope (substeps of z <= 512) and
    covers fat ellipses (advection-dominated operators) that a real
    interval cannot.

    Returns U (n, len(ts)), or (n,) for a scalar ts. Raises on a
    non-finite snapshot and on a snapshot whose norm exceeds the Crouzeix
    cap tracked on the host (one host read per call)."""
    op = aslinearoperator(A)
    B = action_vector(B, op)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_in = np.atleast_1d(np.asarray(ts, np.float64))
    c, alpha, beta, gamma, rho = _resolve_ellipse(op, ellipse)
    if gamma <= 0:
        U = _constant_combination(ts_in, c, B, p)
        return U[:, 0] if scalar_ts else U

    comm = operator_comm(op)
    Bnorms = vector_norm(B, comm, dim=0).tolist()
    eng = _engine(op, B, fused)

    def march(snaps):
        memo = {}

        def step_interval(state, t_prev, dt_int):
            u, cap = state
            q = max(1, int(np.ceil(abs(dt_int) * gamma / max_z)))
            tau = dt_int / q
            z = abs(tau) * gamma
            m_probe = _probe_degree_faber(z, tol)
            key = (float(tau).hex(), m_probe)
            if key not in memo:
                samples = _psi_samples(1.0, c, gamma, rho, _nsamp(m_probe))
                V = _phi_scalar_np(tau * samples, p)     # (p+1, nsamp)
                if not np.isfinite(V).all():
                    raise FloatingPointError(
                        "phiv_timestep_faber: phi overflows on the "
                        "ellipse boundary - shrink max_z")
                D = np.stack([faber_coeffs(V[j], rho, m_probe)[0]
                              for j in range(p + 1)], axis=1)
                memo[key] = (D * (tau ** np.arange(p + 1))[None, :],
                             1.0 + rho ** np.arange(m_probe),
                             np.abs(V).max(axis=1))      # sup_E |phi_j|
            D, sup, smax = memo[key]
            try:
                m_used = _truncate_dd(
                    np.abs(D).max(axis=1) * sup, tol, m_probe, None,
                    f"phiv_timestep_faber (z = {z:.1f} per substep)")
            except ValueError:
                if max_degree is None:
                    raise
                m_used = m_probe
            if max_degree is not None:
                m_used = min(m_used, max_degree)
            Dk = D[:m_used]
            if abs(np.imag(Dk)).max() <= 1e-12 * max(np.abs(Dk).max(),
                                                     1e-300):
                Dk = np.real(Dk)
            if eng is not None and not np.iscomplexobj(Dk):
                rows = _host_to(np.stack([
                    _faber_rows(Dk[:, j], c, 1.0 / gamma, rho)
                    for j in range(p + 1)]), u)
                u = _nw_engine_substeps(op, u, B, rows, t_prev, tau, q, eng,
                                        p, "nw_faber substeps")
            else:
                if np.iscomplexobj(Dk):
                    _no_engine_for_complex(fused, "phiv_timestep_faber")
                u = _nw_faber_scan(op, u, B, _host_to(Dk, u, real=False), c,
                                   1.0 / gamma, rho, t_prev, tau, p, q)
            # the Crouzeix cap: |u(t+tau)| <= C sup|phi_0| |u| +
            # sum_j C sup|phi_j| |tau|^j |v_j(t)|
            tcur = t_prev
            for _ in range(q):
                vb = [sum(abs(tcur) ** l / math.factorial(l) * Bnorms[j + l]
                          for l in range(0, p - j + 1))
                      for j in range(1, p + 1)]
                cap = _CROUZEIX * (smax[0] * cap + sum(
                    smax[j] * abs(tau) ** j * vb[j - 1]
                    for j in range(1, p + 1)))
                tcur += tau
            return u, cap

        return _march(snaps, (B[:, 0], Bnorms[0]), step_interval)

    states = _signed_marches(ts_in, march)
    U = torch.stack([u for u, _ in states], dim=-1)
    finite, _, nrms = _norms_read(
        U, tuple(vector_norm(U, comm, dim=0)), comm)
    _check_finite_faber(U, "phiv_timestep_faber", read=(finite, 0.0, nrms))
    for i, (_, cp) in enumerate(states):
        if np.isfinite(cp) and nrms[i] > _GUARD_SLACK * max(cp, 1e-300):
            raise FloatingPointError(
                f"phiv_timestep_faber: snapshot {i} norm {nrms[i]:.3e} "
                f"exceeds the numerical-range bound {cp:.3e} implied by "
                "the ellipse - the ellipse does not enclose the "
                "numerical range; widen it or use the Krylov path")
    return U[:, 0] if scalar_ts else U

"""Real-Leja-point Newton interpolation for non-Hermitian exp and phi
actions (PyTorch port of ``exponentialutilities_jl_tpu/models/leja.py``).

For operators whose field of values lies in a thin horizontal ellipse
around a real interval [a, b] (advection-diffusion and its kin):

    p_m(A) b = sum_k d_k omega_k,  omega_0 = b,  omega_{k+1} = (A^ - xi_k) omega_k,

with A^ = (A - cI)/s the interval mapped to [-2, 2] (capacity 1, so the
omega_k stay O(|b|)), xi_k the Leja points of [-2, 2] (greedy
maximal-product order, which keeps Newton interpolation stable) and d_k
the divided differences of x -> exp(t(c + s x)) at the xi_k. They come
from Opitz's identity d_k = [exp(Z)]_{k,0}, Z bidiagonal with Z_ii =
t(c + s xi_i) and Z_{i+1,i} = t s, evaluated with scipy's float64 expm on
the host. A long horizon substeps exactly, exp(tA) = exp(tA/q)^q, all q
substeps sharing one table. No inner products anywhere.

On a CUDA device with real float32/float64 data and an operator that
``ops.kernels.dispatch.recurrence_engine`` supports, every Newton pass is
one launch of a hand-written kernel (1-D stencil: B1; banded: B5; 2-D/3-D
stencil within the L2 budget: B6; larger grids: one B3 sweep a step),
driven by (m, 4) rows (ca, cb, cc, cw) = (1/s, -c/s - xi_k, 0, d_k) built
on the host and copied to the device once per call (once per snapshot
interval in ``phiv_timestep_leja``). A phi action's (m, p) coefficient
stack on a 1-D stencil that passes ``resident_multi_ok`` is one launch of
B4; elsewhere each column is one pass. Everything else, and every CPU
tensor, runs the plain torch loops ``_leja_apply`` and ``_nw_leja_scan``.
``fused=True`` demands an engine and raises where none applies.

Each loop is one masked step over state made before it, run its count of
times by ``ops/krylov._run`` (step 0 eagerly, then, on a CUDA device,
through a ``utils/graphs.LoopRunner``: captured at its second execution
and replayed; eagerly on the CPU, under ``graphs.eager()``, for a
sharded operator and where autograd must see the call): a plain loop's
step is one Newton term (the term's index k = i mod m and its
coefficients read at the step counter i; with q > 1 substeps the step
that ends a substep starts the next from its result, by masks), an
engine loop's step one substep (``_engine_substeps``, and for the NW
drivers ``_nw_engine_substeps``, whose time t_0 + i tau is a device
scalar that the step advances). No step reads the device or copies
host data: the tables reach the device before the loop.

Failure protocol: a divided-difference table that does not converge
within its probe degree raises ValueError, one that overflows raises
FloatingPointError, and ``phiv_timestep_leja`` raises on a non-finite
result (one host read per call); nothing returns NaN silently.

A row-sharded operator (``parallel.shard_operator``) runs the plain loops
on this rank's rows: the interval is the global operator's
(``real_interval`` reads its ``_gershgorin_real`` hook), the loops have no
reductions, and the finiteness check covers every rank.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.kernels.dispatch import recurrence_engine, resident_multi_ok
from ..ops.krylov import _run, _State
from ..utils.comm import all_finite, operator_comm
from ..utils.device import action_vector
from ..utils.linop import DenseOperator, aslinearoperator
from ..utils.precision import full_precision
from .chebyshev import _phi_scalar_np

__all__ = ["expv_leja", "phiv_leja", "phiv_timestep_leja", "leja_points",
           "real_interval"]

_MAX_DEGREE = 256          # per substep; z = |t| s per substep kept <~ 40


@functools.lru_cache(maxsize=8)
def _leja_points_sup(m: int, lo: float = -2.0, hi: float = 2.0,
                     grid: int = 20001):
    """First ``m`` Leja points of [lo, hi] and the sup-norms
    S_k = max_x prod_{i<k} |x - xi_i| of the Newton factor polynomials
    (the uniform remainder is sum_{k>=m} |d_k| S_k). xi_0 = hi, then
    greedily the argmax of prod |x - xi_i| over a fine grid, in log-sum
    form. Host numpy, cached."""
    x = np.linspace(lo, hi, grid)
    pts = np.empty(m)
    logsup = np.empty(m)
    pts[0] = hi
    logsup[0] = 0.0
    logprod = np.log(np.abs(x - hi) + 1e-300)
    for k in range(1, m):
        j = int(np.argmax(logprod))
        pts[k] = x[j]
        logsup[k] = logprod[j]
        logprod += np.log(np.abs(x - x[j]) + 1e-300)
    return pts, np.exp(logsup)


def leja_points(m: int, lo: float = -2.0, hi: float = 2.0,
                grid: int = 20001):
    """First ``m`` Leja points of [lo, hi] (see ``_leja_points_sup``)."""
    return _leja_points_sup(m, lo, hi, grid)[0]


def real_interval(A) -> tuple[float, float]:
    """Enclosure of the real parts of A's spectrum: the containers' per-row
    Gershgorin sums (``_gershgorin_real``), or for a dense operator the
    field of values' real extent (eigvalsh of the Hermitian part, on the
    host, padded by 1e-3 of its width)."""
    op = aslinearoperator(A)
    if isinstance(op, DenseOperator):
        M = op.A.detach().cpu().numpy()
        w = np.linalg.eigvalsh((M + M.conj().T) / 2)
        pad = 1e-3 * max(w[-1] - w[0], 1e-300)
        return float(w[0] - pad), float(w[-1] + pad)
    gersh = getattr(op, "_gershgorin_real", None)
    if callable(gersh):
        return gersh()
    raise TypeError(
        f"no real_interval rule for {type(op).__name__}; pass "
        "interval=(a, b) explicitly")


def _probe_degree(z: float, tol: float) -> int:
    """Generous probe degree of the divided-difference table for the
    per-substep parameter z."""
    return min(_MAX_DEGREE, int(np.ceil(
        3.2 * z + 2.5 * np.sqrt(max(z, 1.0) * np.log(1.0 / tol)) + 12)))


def _truncate_dd(mag, tol: float, m_probe: int, m_override, what: str):
    """The smallest m whose dropped sup-norm-weighted tail stays below
    ``tol`` of the largest term. Raises FloatingPointError on a
    non-finite table (overflow is divergence, which no degree cap may
    swallow) and ValueError when the tail never falls below tol within
    the probe degree, unless the caller fixed the degree."""
    if not np.isfinite(mag).all():
        raise FloatingPointError(
            f"{what}: divided-difference table is non-finite "
            "(overflow in the host expm of the shift matrix) - shrink "
            "max_z so each substep's |tau|*s is smaller, or use the "
            "Krylov path")
    thresh = tol * max(float(mag.max()), 1e-300)
    keep = np.nonzero(np.maximum.accumulate(mag[::-1])[::-1] > thresh)[0]
    m_used = int(keep[-1]) + 1 if keep.size else 1
    if m_override is not None:
        return min(int(m_override), m_probe)
    if m_used >= m_probe:
        raise ValueError(
            f"{what}: Leja degree did not converge within the probe "
            f"degree {m_probe} - widen substepping (smaller max_z), "
            "check the interval encloses the spectrum, or use the "
            "Krylov path")
    return m_used


def _divided_differences(t, c, s, xi):
    """Divided differences of x -> exp(t(c + s x)) at xi (Opitz), host
    float64."""
    import scipy.linalg as sla

    m = len(xi)
    Z = np.diag(t * (c + s * xi))
    Z += np.diag(np.full(m - 1, t * s), -1)
    return sla.expm(Z)[:, 0]


def _phi_divided_differences(t, c, s, xi, k: int):
    """(m, k+1) divided differences of x -> phi_j(t(c + s x)), j = 0..k:
    the first column of phi_j of the bidiagonal shift matrix, all j from
    one augmented exponential (Sidje), host float64."""
    import scipy.linalg as sla

    mm = len(xi)
    M = np.diag(t * (c + s * xi)) + np.diag(np.full(mm - 1, t * s), -1)
    if k == 0:
        return sla.expm(M)[:, :1]
    Aug = np.zeros((mm + k, mm + k))
    Aug[:mm, :mm] = M
    Aug[0, mm] = 1.0
    for j in range(k - 1):
        Aug[mm + j, mm + j + 1] = 1.0
    P = sla.expm(Aug)
    cols = [P[:mm, :mm][:, 0]] + [P[:mm, mm + j] for j in range(k)]
    return np.stack(cols, axis=1)


@full_precision
def _leja_apply(op, b, d, xi, center: float, inv_s: float, q: int):
    """q substeps of the degree-(m-1) Newton form, plain torch: ``d``
    (m,) gives (n,), ``d`` (m, p) gives (n, p) (every column from one
    pass; q must be 1). ``d`` and ``xi`` are tensors on b's device. One
    Newton term a step (module doc), q m steps."""
    m = d.shape[0]
    reset = d.ndim == 1 and q > 1

    def accum(w, om, dk):
        if d.ndim == 1:
            return w + dk * om
        return w + om[:, None] * dk[None, :]

    S = _State(b.device, om=b, w=torch.zeros(
        b.shape + d.shape[1:], dtype=d.dtype, device=b.device))

    def step():
        k = torch.remainder(S.jj[:1], m)
        om = S.om
        w = accum(S.w, om, d.index_select(0, k)[0])
        om = (inv_s * (op.matvec(om) - center * om)
              - xi.index_select(0, k)[0] * om)
        if reset:           # a substep's last term: its w starts the next
            last = k[0] == m - 1
            om = torch.where(last, w, om)
            w = torch.where(last, 0, w)
        S.set("w", w)
        S.set("om", om)
        S.step_on()

    _run("leja_apply", op, S, step, q * m if d.ndim == 1 else m, b.device)
    return S.om if reset else S.w


def _engine(op, b, fused):
    """The recurrence engine for a real non-Hermitian recurrence on b, or
    None for the plain path (``dispatch.recurrence_engine``)."""
    return recurrence_engine(op, b.dtype, fused, device=b.device,
                             hermitian=False, operands=(b,))


def _newton_rows(d, xi, c, inv_s):
    """(m, 4) rows of the Newton form, host numpy:
    omega_{k+1} = inv_s (A - c) omega_k - xi_k omega_k, w += d_k omega_k."""
    m = len(xi)
    return np.stack([np.full(m, inv_s), -inv_s * c - np.asarray(xi),
                     np.zeros(m), np.asarray(d)], axis=1)


def _apply_columns(op, b, rows, cw, apply, fused):
    """sum over one omega chain with p coefficient columns: ``rows`` the
    (p, m, 4) rows of each column (their chain scalars equal), ``cw`` the
    (m, p) host coefficients. One launch of B4 on a 1-D stencil that
    passes ``resident_multi_ok``, else one engine pass a column."""
    p = rows.shape[0]
    if fused is not False and resident_multi_ok(op, b.dtype, b.device, p,
                                                (b,)):
        from ..ops.kernels.resident import recurrence_apply_resident_multi

        dev = _host_to(np.concatenate([rows[0], cw], axis=1), b)
        return recurrence_apply_resident_multi(op, b, dev[:, :4], dev[:, 4:])
    dev = _host_to(rows, b)
    return torch.stack([apply(op, b, dev[j]) for j in range(p)], dim=-1)


def _engine_substeps(op, b, rows, q: int, apply, what: str):
    """q exact substeps w <- apply(op, w, rows) from w = b, one engine pass
    each: one step run q times (module doc). ``rows`` (m, 4) on the
    device."""
    S = _State(b.device, w=b)

    def step():
        S.set("w", apply(op, S.w, rows))

    _run(what, op, S, step, q, b.device)
    return S.w


def _apply_fused_newton(op, b, D, xi, c, inv_s, q: int, apply, fused=None):
    """Engine twin of ``_leja_apply``: (m,) D gives q exact substeps, one
    launch each with rows copied once (``_engine_substeps``); (m, p) D
    gives the p columns (``_apply_columns``)."""
    D = np.asarray(D)
    if D.ndim == 1:
        rows = _host_to(_newton_rows(D, xi, c, inv_s), b)
        return _engine_substeps(op, b, rows, q, apply, "leja substeps")
    rows = np.stack([_newton_rows(D[:, j], xi, c, inv_s)
                     for j in range(D.shape[1])])
    return _apply_columns(op, b, rows, D, apply, fused)


def _interval_map(op, interval):
    if interval is None:
        interval = real_interval(op)
    a_lo, b_hi = float(interval[0]), float(interval[1])
    return 0.5 * (b_hi + a_lo), 0.25 * (b_hi - a_lo)


def _leja_expv_setup(op, t, interval, tol, m, max_z):
    """Host coefficient setup of ``expv_leja``: (d, xi, c, s, q), d the
    truncated divided differences; d is None when A ~ cI."""
    c, s = _interval_map(op, interval)
    tf = float(t)
    if s <= 0:
        return None, None, c, s, 0
    q = max(1, int(np.ceil(abs(tf) * s / max_z)))
    tau = tf / q
    z = abs(tau) * s
    m_probe = _probe_degree(z, tol)
    xi, sup = _leja_points_sup(m_probe)
    d = _divided_differences(tau, c, s, xi)
    m_used = _truncate_dd(np.abs(d) * sup, tol, m_probe, m,
                          f"expv_leja (z = {z:.1f} per substep)")
    return d[:m_used], xi[:m_used], c, s, q


def _host_to(a, b, real=True):
    """Host numbers to b's device: in b's real dtype (``real``) or in b's
    dtype, complex when ``a`` is (b's complex type)."""
    a = np.asarray(a)
    dt = b.real.dtype if real and b.is_complex() else b.dtype
    if np.iscomplexobj(a):
        dt = torch.promote_types(b.dtype, torch.complex64)
    return torch.as_tensor(a).to(dt).to(b.device, non_blocking=True)


def expv_leja(t, A, b, *, interval=None, tol: float = 1e-7,
              m: int | None = None, max_z: float = 40.0,
              fused: bool | None = None):
    """exp(tA) b by Newton interpolation at real Leja points: one pass a
    substep, no inner products, non-Hermitian A allowed (module doc; for
    Hermitian A prefer ``expv_chebyshev``).

    interval: (a, b) enclosing the spectrum's real parts; None takes
      ``real_interval``.
    tol: divided-difference tail cutoff (per substep).
    m: fixed degree.
    max_z: per-substep |t| s budget; a longer t substeps exactly.
    fused: demand (True) or forbid (False) the CUDA engines; None = auto.
    """
    op = aslinearoperator(A)
    b = action_vector(b, op)
    d, xi, c, s, q = _leja_expv_setup(op, t, interval, tol, m, max_z)
    if d is None:                       # A ~ cI
        return math.exp(float(t) * c) * b
    eng = _engine(op, b, fused)
    if eng is not None:
        return _apply_fused_newton(op, b, d, xi, c, 1.0 / s, q, eng)
    return _leja_apply(op, b, _host_to(d, b, real=False), _host_to(xi, b),
                       c, 1.0 / s, q)


def phiv_leja(t, A, b, k: int, *, interval=None, tol: float = 1e-7,
              m: int | None = None, max_z: float = 40.0,
              fused: bool | None = None):
    """[phi_0(tA)b ... phi_k(tA)b] (n, k+1) by Newton interpolation at real
    Leja points, every order from one omega chain. phi actions do not
    substep exactly: |t| s beyond ``max_z`` raises (use
    ``phiv_timestep_leja`` or the Krylov drivers)."""
    op = aslinearoperator(A)
    b = action_vector(b, op)
    c, s = _interval_map(op, interval)
    tf = float(t)
    if s <= 0:
        vals = _phi_scalar_np(np.asarray([tf * c]), k)[:, 0]
        return torch.stack([float(v) * b for v in vals], dim=-1)
    z = abs(tf) * s
    if z > max_z:
        raise ValueError(
            f"|t|*s = {z:.1f} exceeds max_z = {max_z}: phi actions have "
            "no exact substepping - use phiv_timestep/kiops for stiff "
            "horizons")
    m_probe = _probe_degree(z, tol)
    xi, sup = _leja_points_sup(m_probe)
    D = _phi_divided_differences(tf, c, s, xi, k)
    m_used = _truncate_dd(np.abs(D).max(axis=1) * sup, tol, m_probe, m,
                          f"phiv_leja (z = {z:.1f})")
    D, xi = D[:m_used], xi[:m_used]
    eng = _engine(op, b, fused)
    if eng is not None:
        return _apply_fused_newton(op, b, D, xi, c, 1.0 / s, 1, eng, fused)
    return _leja_apply(op, b, _host_to(D, b, real=False), _host_to(xi, b),
                       c, 1.0 / s, 1)


def _combo_cols(u, B, tcur, p: int):
    """(p+1, n) columns [u, v_1(t) ... v_p(t)] of the NW substep,
    v_j(t) = sum_l t^l / l! b_{j+l}; ``tcur`` a 0-d float64 tensor (the
    loops' device time) or a host float."""
    cols = [u]
    for j in range(1, p + 1):
        vj = torch.zeros_like(u)
        for l in range(0, p - j + 1):
            vj = vj + ((tcur ** l) / math.factorial(l)) * B[:, j + l]
        cols.append(vj)
    return torch.stack(cols, dim=0)


def _device_time(t0: float, like):
    """t0 as the NW loops' 0-d float64 device time (a fill, no copy)."""
    return torch.full((), t0, dtype=torch.float64, device=like.device)


@full_precision
def _nw_leja_scan(op, u, B, D, xi, center: float, inv_s: float, t0: float,
                  tau: float, p: int, q: int):
    """q substeps of u(t + tau) = phi_0(tau A) u + sum_{j>=1} tau^j
    phi_j(tau A) v_j(t), plain torch. The direct phi combination keeps
    every column O(|B|) (the Krylov driver's W recurrence cancels
    (tau |A|)^j / j! terms); ``D`` (m, p+1) holds column j's divided
    differences scaled by tau^j. One Newton term a step (module doc), q m
    steps; a substep's last term makes the next substep's columns at the
    device time t + tau."""
    m = D.shape[0]
    tcur = _device_time(t0, u)
    S = _State(u.device, Om=_combo_cols(u, B, tcur, p),
               w=torch.zeros_like(u), tcur=tcur)

    def step():
        k = torch.remainder(S.jj[:1], m)
        Om = S.Om
        w = S.w + D.index_select(0, k)[0] @ Om
        AOm = torch.stack([op.matvec(r) for r in Om])
        Om = inv_s * (AOm - center * Om) - xi.index_select(0, k)[0] * Om
        if q > 1:
            last = k[0] == m - 1
            tn = S.tcur + tau
            Om = torch.where(last, _combo_cols(w, B, tn, p), Om)
            w = torch.where(last, 0, w)
            S.apply("tcur", torch.where, last, tn, S.tcur)
        S.set("w", w)
        S.set("Om", Om)
        S.step_on()

    _run("nw_leja", op, S, step, q * m, u.device)
    return S.Om[0] if q > 1 else S.w


def _nw_fused_substep(op, u, B, tcur, rows, apply, p: int):
    """One NW substep through an engine: each of the p+1 combination
    columns runs its own pass (the same chain scalars, the coefficient
    column D[:, j]) from its own start vector, and the passes sum.
    ``rows`` (p+1, m, 4) on the device: Newton rows here, Faber rows in
    ``faber.phiv_timestep_faber``."""
    cols = _combo_cols(u, B, tcur, p)
    out = None
    for j in range(p + 1):
        wj = apply(op, cols[j], rows[j])
        out = wj if out is None else out + wj
    return out


def _nw_engine_substeps(op, u, B, rows, t0: float, tau: float, q: int,
                        apply, p: int, what: str):
    """q NW substeps through an engine from u at time t0 (module doc): one
    substep (``_nw_fused_substep``) a step, its time a device scalar that
    the step advances by tau."""
    S = _State(u.device, u=u, tcur=_device_time(t0, u))

    def step():
        S.set("u", _nw_fused_substep(op, S.u, B, S.tcur, rows, apply, p))
        S.apply("tcur", torch.add, S.tcur, tau)

    _run(what, op, S, step, q, u.device)
    return S.u


def _march(snaps, state, step_interval):
    """Evolve a state from t = 0 through a snapshot list monotone away
    from 0; ``step_interval(state, t_prev, dt)`` advances one interval.
    Returns the state at each snapshot."""
    outs, t_prev = [], 0.0
    for t_snap in snaps:
        dt_int = float(t_snap) - t_prev
        if dt_int != 0.0:
            state = step_interval(state, t_prev, dt_int)
        outs.append(state)
        t_prev = float(t_snap)
    return outs


def _signed_marches(ts_in, march):
    """Positive snapshots marched forward and negative ones backward, both
    from t = 0 (``march(snaps)`` gives the states); the states in the
    caller's order of ``ts_in``."""
    order = np.argsort(ts_in, kind="stable")
    ts_sorted = ts_in[order]
    out = [None] * len(ts_in)
    for idx in (order[ts_sorted >= 0], order[ts_sorted < 0][::-1]):
        if len(idx):
            for i, st in zip(idx, march(ts_in[idx])):
                out[int(i)] = st
    return out


def _constant_combination(ts_in, c, B, p):
    """A = cI: u(t) = sum_j t^j phi_j(tc) b_j."""
    cols = []
    for t in ts_in:
        vals = _phi_scalar_np(np.asarray([t * c]), p)[:, 0]
        cols.append(sum((t ** j) * float(vals[j]) * B[:, j]
                        for j in range(p + 1)))
    return torch.stack(cols, dim=-1)


def phiv_timestep_leja(ts, A, B, *, interval=None, tol: float = 1e-7,
                       max_z: float = 40.0, max_degree: int | None = None,
                       fused: bool | None = None):
    """u(t) = sum_j t^j phi_j(tA) b_j at the snapshot times ``ts`` for
    non-Hermitian A (the real-interval field-of-values class): the
    Niesen-Wright substepped combination with every phi action a Leja
    Newton pass. Uniform substeps with tau s <= ``max_z`` per snapshot
    interval, a-priori divided-difference error control, no inner
    products and no rejections.

    ``max_degree`` caps the degree (accepting truncation); without it a
    non-converged table raises. On an engine every substep is p+1
    launches, one per combination column. Returns U (n, len(ts)), or
    (n,) for a scalar ts; raises FloatingPointError on a non-finite
    result (real-Leja interpolation diverges when the field of values'
    imaginary extent is comparable to the interval)."""
    op = aslinearoperator(A)
    B = action_vector(B, op)
    if B.ndim == 1:
        B = B[:, None]
    p = B.shape[1] - 1
    scalar_ts = np.ndim(ts) == 0
    ts_in = np.atleast_1d(np.asarray(ts, np.float64))
    c, s = _interval_map(op, interval)
    if s <= 0:
        U = _constant_combination(ts_in, c, B, p)
        return U[:, 0] if scalar_ts else U

    eng = _engine(op, B, fused)

    def march(snaps):
        dd_memo = {}

        def step_interval(u, t_prev, dt_int):
            q = max(1, int(np.ceil(abs(dt_int) * s / max_z)))
            tau = dt_int / q
            z = abs(tau) * s
            m_probe = _probe_degree(z, tol)
            # equally spaced snapshots share one table (exact-float key)
            key = (float(tau).hex(), m_probe)
            if key not in dd_memo:
                xi, sup = _leja_points_sup(m_probe)
                D = (_divided_differences(tau, c, s, xi)[:, None] if p == 0
                     else _phi_divided_differences(tau, c, s, xi, p))
                dd_memo[key] = (xi, sup, D * (tau ** np.arange(p + 1))[None, :])
            xi, sup, D = dd_memo[key]
            try:
                m_used = _truncate_dd(
                    np.abs(D).max(axis=1) * sup, tol, m_probe, None,
                    f"phiv_timestep_leja (z = {z:.1f} per substep)")
            except ValueError:
                if max_degree is None:
                    raise
                m_used = m_probe
            if max_degree is not None:
                m_used = min(m_used, max_degree)
            D, xi = D[:m_used], xi[:m_used]
            if eng is not None:
                rows = _host_to(np.stack([_newton_rows(D[:, j], xi, c, 1.0 / s)
                                          for j in range(p + 1)]), u)
                return _nw_engine_substeps(op, u, B, rows, t_prev, tau, q,
                                           eng, p, "nw_leja substeps")
            return _nw_leja_scan(op, u, B, _host_to(D, u, real=False),
                                 _host_to(xi, u), c, 1.0 / s, t_prev, tau,
                                 p, q)

        return _march(snaps, B[:, 0], step_interval)

    U = torch.stack(_signed_marches(ts_in, march), dim=-1)
    # the one host read of the call: divergence must surface, never NaN
    if not bool(all_finite(U, operator_comm(op))):
        raise FloatingPointError(
            "phiv_timestep_leja diverged (non-finite result): the "
            "operator's field of values likely has imaginary extent "
            "comparable to its real interval (advection-dominated). "
            "Use phiv_timestep / phiv_timestep_device (Krylov) for "
            "this operator class.")
    return U[:, 0] if scalar_ts else U

"""Niesen-Wright internal time stepping: ``expv_timestep`` /
``phiv_timestep`` (PyTorch port of
``exponentialutilities_jl_tpu/models/timestepping.py``).

Computes u(t) = phi_0(tA)b_0 + t phi_1(tA)b_1 + ... + t^p phi_p(tA)b_p by
internal substeps with joint (m, tau) adaptivity (Niesen & Wright,
Algorithm 919, arXiv:0907.4631). The adaptation is scalar control flow on
the host; the W recurrence (p matvecs), the Krylov basis and the reduced
phi evaluation run where the operator lives. A tau-only rejection reuses
the basis (it does not depend on tau), and adapted m values are rounded up
to the JAX package's bucket ladder ``_M_BUCKETS``, which keeps the step
sequence, and so the result and the stats, those of the reference.

Host reads per substep: one for the new basis (its breakdown flag,
effective dimension, residual, beta and Hessenberg norms, in one
transfer), and one per tau trial (the trial's error estimate; the reduced
exponential is told its 1-norm, so it makes none of its own). U and u stay
on the operator's device; nothing goes through the host.

``two_pass=True`` is the storage-free form (``_TwoPassSubstep``): pass 1
keeps only the Lanczos (alpha, beta) or the windowed-IOP compact
Hessenberg, every tau trial is reduced work only, and one replay per
accepted substep forms the phi_p column at the accepted tau and at every
snapshot. The fixed-(tau, m) steppers ``phiv_timestep_fused``,
``expv_timestep_fused`` and ``make_phiv_timestep`` make no host read at
all: their reduced exponential keeps its squaring count on the device
(``expm_taylor_masked``). As the JAX package's ``lax.scan``, they run one
substep over state made before the loop (u, t, a step counter and the
error history), ``nsteps`` times through a ``utils/graphs.LoopRunner``:
on a CUDA device the first substep runs eagerly, the second is captured
into one CUDA graph with the Krylov builder's steps inline, and the rest
replay it. ``make_phiv_timestep``'s ``fn(B)`` is one ``graphs.Scan`` call:
the first call of a key captures the substep, and every later call
replays it ``nsteps`` times.

A row-sharded operator (``parallel.shard_operator``) steps this rank's
rows of B: the Krylov builders reduce over the operator's ``comm``, |b_0|
is a pmax, and every adaptation decision reads replicated scalars, so the
ranks take the single-device call's steps together. The global n decides
the m buckets and the cost model.

``reduced="host"`` evaluates each trial's reduced phi columns with scipy
on the host (``ops/host_reduced.py``): one device-to-host read and one
host-to-device write per reduced problem. The fixed-step forms keep their
device exponential (they take no ``reduced``, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..ops.sparse import hoist_conjugation
from ..utils import graphs
from ..utils.comm import operator_comm, pmax
from ..utils.device import action_vector
from ..utils.linop import NegatedOperator, aslinearoperator
from .expv import _reduced_where, build_subspace
from .phiv import _phiv_combine, _reduced_phi, _row

__all__ = ["expv_timestep", "phiv_timestep", "TimestepStats",
           "phiv_timestep_fused", "expv_timestep_fused",
           "make_phiv_timestep"]

# m bucket ladder (ratio ~4/3, NW's m_new in [3m/4, 4m/3] move cap); the
# JAX package's ladder, kept because it decides the step sequence
_M_BUCKETS = (4, 6, 8, 10, 13, 17, 22, 29, 38, 49, 64, 83, 108, 128, 160,
              192, 256)

# Consecutive non-finite error estimates tolerated before the driver gives
# up (each one shrinks tau 5x, so 8 tries span a 390k x tau range).
_MAX_NONFINITE_REJECTS = 8


def _bucket_m(m: int, n: int, m_max: int) -> int:
    m = max(1, min(m, m_max, n))
    for b in _M_BUCKETS:
        if b >= m:
            return min(b, n, m_max)
    return min(m_max, n)


@dataclasses.dataclass
class TimestepStats:
    """Per-solve counters. ``info``: 0 = success; 2 = persistent
    non-finite error estimate (NaN/Inf operator or irrecoverable
    overflow), the unfilled outputs NaN and the solve ended."""
    steps: int = 0
    rejections: int = 0
    matvecs: int = 0
    final_m: int = 0
    final_tau: float = 0.0
    info: int = 0


def _as_columns(B, op):
    B = action_vector(B, op)
    return B[:, None] if B.ndim == 1 else B


def _compute_W(op, u, B, t, p: int):
    """W recurrence (16) of Niesen-Wright: w_0 = u,
    w_j = A w_{j-1} + sum_{l=0}^{p-j} (t^l / l!) b_{j+l}; (n, p+1). t is a
    float or a 0-d float64 tensor (a loop step's)."""
    cols = [u]
    for j in range(1, p + 1):
        w = op.matvec(cols[-1])
        for l in range(0, p - j + 1):
            w = w + (t ** l / math.factorial(l)) * B[:, j + l]
        cols.append(w)
    return torch.stack(cols, dim=1)


def _update_u(W, pcol, tau, p: int):
    """u <- tau^p phi_p(tau A) w_p + sum_{j<p} (tau^j / j!) w_j (NW (15));
    ``pcol`` is the phi_p(tau A) w_p column; tau a float or a 0-d
    tensor."""
    u = (tau ** p) * pcol
    for j in range(p):
        u = u + (tau ** j / math.factorial(j)) * W[:, j]
    return u


def _estimate_flops(m, tau, n, p, nnz, iop, Hnorm, maxtau):
    """Cost model (23) of Niesen-Wright for choosing between adapting m
    and tau."""
    flops_W = 2 * (p - 1) * (nnz + n)
    flops_u = (2 * p + 1) * n
    if iop == 0:
        iop = m
    flops_matvec = 2 * m * nnz
    flops_vecvec = sum(3 * min(i, iop) for i in range(1, m + 1))
    MH = 44 / 3 + 2 * math.ceil(max(0.0, math.log2(max(Hnorm, 1e-300) / 5.37)))
    flops_phiv = round(MH * (m + p) ** 3)
    one = flops_W + flops_u + flops_matvec + flops_vecvec + flops_phiv
    return one * int(math.ceil(maxtau / max(tau, 1e-300)))


def _adapt(m, tau, eps, m_old, tau_old, eps_old, q, kappa, gamma, omega,
           maxtau, n, p, nnz, iop, Hnorm):
    """Joint (m, tau) adaptation, Algorithm 4 of Niesen-Wright."""
    if tau_old > tau and eps != eps_old and eps_old > 0 and eps > 0:
        q = math.log(tau / tau_old) / math.log(eps / eps_old) - 1
    tau_new = tau * (gamma / omega) ** (1 / (q + 1))
    tau_new = min(max(tau_new, tau / 5), 2 * tau, maxtau)
    if m_old < m and eps != eps_old and eps_old > 0 and eps > 0:
        kappa = (eps / eps_old) ** (1 / (m_old - m))
    kappa = max(kappa, 1.0 + 1e-9)
    m_new = m + int(math.ceil(math.log(omega / gamma) / math.log(kappa)))
    m_new = min(max(m_new, (3 * m) // 4, 1), int(math.ceil(4 * m / 3)))
    cost_tau = _estimate_flops(m, tau_new, n, p, nnz, iop, Hnorm, maxtau)
    cost_m = _estimate_flops(m_new, tau, n, p, nnz, iop, Hnorm, maxtau)
    if cost_tau < cost_m:
        m_new = m
    else:
        tau_new = tau
    return m_new, tau_new, q, kappa


def _initial_tau(abstol, opn, m, b0norm, tend):
    """Niesen-Wright (17) initial substep."""
    if b0norm == 0 or opn == 0:
        return tend
    val = abstol * ((m + 1) / math.e) ** (m + 1) * math.sqrt(2 * math.pi * (m + 1)) \
        / (4 * opn * b0norm)
    return 10.0 / opn * val ** (1.0 / m)


def _onenorms(H, m: int):
    """(1-norm of the whole (m+1, m) H, of its square part H_m), as 0-d
    tensors in H's real dtype."""
    cols = H.abs().sum(dim=0)
    return cols.max(), H[:m, :m].abs().sum(dim=0).max()


def _basis_summary_device(H, beta, m_used, broke):
    """What the driver needs of a new basis, as 0-d tensors in H's real
    dtype: (broke, m_used, beta, the residual h_{m_used, m_used-1}, |H|_1,
    |H_m|_1)."""
    m = H.shape[1]
    last = torch.clamp_min(m_used - 1, 0)
    h_res = _row(_row(H, last + 1), last).abs()
    hn, hm = _onenorms(H, m)
    rdt = hn.dtype
    return (broke.to(rdt), m_used.to(rdt), beta.to(rdt), h_res.to(rdt), hn,
            hm)


def _basis_summary(H, beta, m_used, broke):
    """``_basis_summary_device`` in one host read: (broke, m_used, beta,
    h_res, |H|_1, |H_m|_1) as host numbers."""
    vals = torch.stack(_basis_summary_device(H, beta, m_used, broke)).tolist()
    return (bool(vals[0]), int(vals[1]), vals[2], vals[3], vals[4], vals[5])


def _signed_ts_dispatch(driver, ts, op, B, return_stats: bool, kwargs: dict):
    """Zero and negative output times, shared by ``phiv_timestep`` and
    ``phiv_timestep_device``. None when every time is >= 0 with at least
    one positive (the drivers' forward march); else all times zero give
    b_0 in every column, all times <= 0 march u(-s; A, b_j) =
    u(s; -A, (-1)^j b_j), and mixed signs march both sides from t = 0
    and merge the columns (stats summed, info the max)."""
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    tmin, tmax = float(ts_arr.min()), float(ts_arr.max())
    if tmax > 0 and tmin >= 0:
        return None
    n, ppo = B.shape
    p = ppo - 1
    if tmin == 0 and tmax == 0:
        U = B[:, :1].expand(n, len(ts_arr)).clone()
        out = U[:, 0] if scalar_ts else U
        return (out, TimestepStats()) if return_stats else out
    signs = torch.tensor([(-1.0) ** j for j in range(p + 1)],
                         dtype=B.dtype, device=B.device)
    B_neg = B * signs[None, :]
    if tmax <= 0:
        return driver(np.negative(ts), NegatedOperator(op), B_neg,
                      return_stats=return_stats, **kwargs)
    neg = ts_arr < 0
    res_n = driver(-ts_arr[neg], NegatedOperator(op), B_neg,
                   return_stats=return_stats, **kwargs)
    res_p = driver(ts_arr[~neg], op, B, return_stats=return_stats, **kwargs)
    if return_stats:
        (Un, sn), (Up, sp_) = res_n, res_p
        stats = TimestepStats(
            steps=sn.steps + sp_.steps,
            rejections=sn.rejections + sp_.rejections,
            matvecs=sn.matvecs + sp_.matvecs,
            final_m=sp_.final_m, final_tau=sp_.final_tau,
            info=max(sn.info, sp_.info))
    else:
        Un, Up = res_n, res_p
    U = torch.zeros((n, len(ts_arr)), dtype=Up.dtype, device=Up.device)
    U[:, torch.as_tensor(np.flatnonzero(neg), device=U.device)] = Un
    U[:, torch.as_tensor(np.flatnonzero(~neg), device=U.device)] = Up
    return (U, stats) if return_stats else U


def _unsort(U, ts_arr):
    """Columns of U (in sorted-time order) back in the caller's order."""
    inv = np.empty(len(ts_arr), dtype=np.int64)
    inv[np.argsort(ts_arr, kind="stable")] = np.arange(len(ts_arr))
    return U[:, torch.as_tensor(inv, device=U.device)]


class _TwoPassSubstep:
    """Storage-free substep engine of ``phiv_timestep(two_pass=True)``:
    ``build`` records the Lanczos (alpha, beta) (Hermitian) or the
    (m, win+1) windowed-IOP compact Hessenberg (general) in O(n) memory,
    ``err_estimate`` evaluates a (tau, m) trial on the reduced Hessenberg
    only, and ``replay_pcols`` regenerates the basis once per accepted
    substep for the phi_p columns at the accepted tau and every snapshot
    tau."""

    def __init__(self, op, tol, iop, hermitian, p, reduced="device"):
        self.op = op
        self.tol = tol
        self.win = iop if iop > 0 else 2
        self.hermitian = bool(hermitian)
        self.p = p
        self.kk = p + 1
        self.reduced = reduced

    def build(self, v, m: int):
        from ..ops.krylov import (arnoldi_coeffs, expand_compact_hessenberg,
                                  lanczos_coeffs)
        if self.hermitian:
            alphas, betas, beta0, m_used, broke = lanczos_coeffs(
                self.op, v, m, tol=self.tol)
            H = torch.zeros((m + 1, m), dtype=alphas.dtype,
                            device=alphas.device)
            d = torch.arange(m, device=alphas.device)
            H[d, d] = alphas
            H[d + 1, d] = betas
            if m > 1:
                H[d[:-1], d[:-1] + 1] = betas[:-1]
            rec = (alphas, betas)
        else:
            Hc, beta0, m_used, broke = arnoldi_coeffs(self.op, v, m,
                                                      self.win, tol=self.tol)
            H = expand_compact_hessenberg(Hc, self.win)
            rec = (Hc,)
        broke, m_used, beta, h_res, hn, hm = _basis_summary(H, beta0, m_used,
                                                            broke)
        return {"H": H, "beta0": beta, "m_used": m_used,
                "h_res": h_res, "Hnorm": hn, "hm": hm, "breakdown": broke,
                "m": m, "rec": rec, "v": v}

    def _c2(self, S, tau_val):
        return _reduced_phi(tau_val, S["H"], self.kk, hnorm=S["hm"],
                            reduced=self.reduced)

    def err_estimate(self, S, tau_val) -> float:
        """|beta_0 h_{m+1,m} tau C2[last, p+1]| on the reduced problem
        (one host read)."""
        last = max(S["m_used"] - 1, 0)
        c = self._c2(S, tau_val)[last, self.kk].item()
        return abs(S["beta0"] * S["h_res"] * tau_val * c)

    def replay_pcols(self, S, taus):
        """(n, len(taus)) phi_p(tau_i A) w_p columns by one replay."""
        from ..ops.krylov import arnoldi_replay, lanczos_replay
        C = torch.stack([self._c2(S, tv)[:, self.p] * S["beta0"]
                         for tv in taus], dim=1)
        if self.hermitian:
            alphas, betas = S["rec"]
            return lanczos_replay(self.op, S["v"], C, alphas, betas, S["m"])
        (Hc,) = S["rec"]
        return arnoldi_replay(self.op, S["v"], C, Hc, S["m"], self.win)


class _BasisSubstep:
    """The basis-storing substep engine (``build_subspace``) with the
    interface of ``_TwoPassSubstep``; the reduced phi columns of the last
    trial are kept for the accepted substep."""

    def __init__(self, op, tol, iop, hermitian, p, correct,
                 reduced="device"):
        self.op, self.tol, self.iop = op, tol, iop
        self.hermitian, self.p, self.kk = hermitian, p, p + 1
        self.correct, self.reduced = correct, reduced

    def build(self, v, m: int):
        Ks = build_subspace(self.op, v, m, tol=self.tol, iop=self.iop,
                            hermitian=self.hermitian)
        broke, m_used, beta, h_res, hn, hm = _basis_summary(
            Ks.H, Ks.beta, Ks.m_used, Ks.breakdown)
        return {"Ks": Ks, "H": Ks.H, "beta0": beta, "m_used": m_used,
                "h_res": h_res, "Hnorm": hn, "hm": hm, "breakdown": broke,
                "m": m, "C2": None}

    def err_estimate(self, S, tau_val) -> float:
        C2 = _reduced_phi(tau_val, S["H"], self.kk, hnorm=S["hm"],
                          reduced=self.reduced)
        S["C2"] = (tau_val, C2)
        last = max(S["m_used"] - 1, 0)
        return abs(S["beta0"] * S["h_res"] * tau_val
                   * C2[last, self.kk].item())

    def pcol(self, S, tau_val):
        """The phi_p(tau A) w_p column (with the correction if asked)."""
        hit = S["C2"]
        C2 = (hit[1] if hit is not None and hit[0] == tau_val else
              _reduced_phi(tau_val, S["H"], self.kk, hnorm=S["hm"],
                           reduced=self.reduced))
        P, _ = _phiv_combine(tau_val, S["Ks"], C2, self.kk, self.correct)
        return P[:, self.p]


def phiv_timestep(ts, A, B, *, tau: float = 0.0, m: int = 10,
                  tol: float = 1e-7, opnorm=None, iop: int = 0,
                  correct: bool = False, adaptive: bool = False,
                  delta: float = 1.2, gamma: float = 0.8, nnz: int = 0,
                  m_max: int = 256, hermitian: bool | None = None,
                  verbose: bool = False, return_stats: bool = False,
                  reduced: str | None = None, two_pass: bool = False):
    """u = sum_j t^j phi_j(tA) b_j at the snapshot times ``ts`` by
    Niesen-Wright internal substeps (module doc).

    ts: scalar or 1-D array of output times (any order, any sign).
    A: operator (n, n). B: (n, p+1) columns b_0..b_p (or (n,) for p = 0).
    tau: initial substep; 0 selects the NW (17) estimate.
    m: (initial) Krylov dimension. tol: relative tolerance.
    opnorm: scalar operator-norm bound; None takes the 1-norm of the first
      substep's Hessenberg.
    adaptive: joint (m, tau) adaptation (NW Algorithms 3/4).
    nnz: matvec cost for the flop model (0: the operator's ``nnz``, else
      n^2).
    two_pass: the storage-free substeps (module doc); needs
      ``correct=False``.
    reduced: "device", "host" or None ("device"): where each trial's
      reduced phi columns are evaluated (module doc).

    Returns U (n, len(ts)) (or (n,) for a scalar ts) on the operator's
    device, plus ``TimestepStats`` with ``return_stats=True``.
    """
    reduced = _reduced_where(reduced)
    op = aslinearoperator(A)
    op, B, post = hoist_conjugation(op, _as_columns(B, op))
    kwargs = dict(tau=tau, m=m, tol=tol, opnorm=opnorm, iop=iop,
                  correct=correct, adaptive=adaptive, delta=delta,
                  gamma=gamma, nnz=nnz, m_max=m_max, hermitian=hermitian,
                  verbose=verbose, reduced=reduced, two_pass=two_pass)
    if post is not None:
        # sorted-conjugated container: solve in the sorted basis (every
        # phi_j commutes with the conjugation)
        out = phiv_timestep(ts, op, B, return_stats=return_stats, **kwargs)
        if isinstance(out, tuple):
            return (post(out[0]),) + out[1:]
        return post(out)
    handled = _signed_ts_dispatch(phiv_timestep, ts, op, B, return_stats,
                                  kwargs)
    if handled is not None:
        return handled
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    ts_sorted = np.sort(ts_arr)
    tend = float(ts_sorted[-1])
    n_rows, ppo = B.shape
    n = op.shape[0]             # global: the buckets and the cost model
    p = ppo - 1
    m = _bucket_m(m, n, m_max)
    stats = TimestepStats()

    u = B[:, 0]
    b0norm = float(pmax(B[:, 0].abs().max(), operator_comm(op)))

    abstol = None
    if opnorm is not None:
        opn = float(opnorm)
        abstol = tol * opn
        if tau == 0.0:
            tau = _initial_tau(abstol, opn, m, b0norm, tend)
            if verbose:
                print(f"Initial time step unspecified, chosen to be {tau}")
    seed_arnoldi_tau = abstol is None and tau == 0.0
    if seed_arnoldi_tau:
        tau = tend
    if nnz == 0 and hasattr(op, "nnz"):
        nnz = int(op.nnz)          # sparse containers know their cost
    nnz_eff = nnz if nnz > 0 else n * n
    if hermitian is None:
        hermitian = op.is_hermitian
    # the flop model's iop for Lanczos is 2
    iop_cost = 2 if adaptive and hermitian else iop

    if two_pass and correct:
        raise NotImplementedError(
            "two_pass phiv_timestep does not support correct=True "
            "(the correction needs the (m+1)-th basis vector)")
    engine = (_TwoPassSubstep(op, tol, iop, hermitian, p, reduced)
              if two_pass
              else _BasisSubstep(op, tol, iop, hermitian, p, correct,
                                 reduced))

    U = torch.zeros((n_rows, len(ts_sorted)), dtype=B.dtype, device=B.device)
    t = 0.0
    snapshot = 0

    while t < tend:
        if t + tau > tend:
            tau = tend - t
        W = _compute_W(op, u, B, t, p)
        stats.matvecs += p
        S = engine.build(W[:, p], m)
        stats.matvecs += m
        if abstol is None:
            # matrix-free scale from the first substep's Hessenberg 1-norm
            opn = S["Hnorm"]
            abstol = tol * max(opn, 1e-300)
            if seed_arnoldi_tau:
                tau = min(tend - t,
                          gamma * _initial_tau(abstol, opn, m, b0norm, tend))
            if verbose:
                print(f"Absolute tolerance (Arnoldi estimate): {abstol}")
        if S["breakdown"]:
            tau = tend - t
        eps = engine.err_estimate(S, tau)
        if verbose:
            print(f"t = {t}, m = {m}, tau = {tau}, error estimate = {eps}")
        if not adaptive and not math.isfinite(eps):
            # fixed (tau, m) cannot recover: flag and NaN-fill
            stats.info = 2
            U[:, snapshot:] = math.nan
            break
        if adaptive:
            # a non-finite estimate must reject, never accept
            omega = (tend / tau) * (eps / abstol)
            if not math.isfinite(omega):
                omega = math.inf
            eps_old, m_old, tau_old = eps, m, tau
            q, kappa = m / 4, 2.0
            maxtau = tend - t
            nonfinite = 0
            while omega > delta:
                if not math.isfinite(eps):
                    # shrink tau hard on the tau-independent basis, a
                    # bounded number of times
                    nonfinite += 1
                    stats.rejections += 1
                    if nonfinite > _MAX_NONFINITE_REJECTS:
                        stats.info = 2
                        U[:, snapshot:] = math.nan
                        break
                    tau, tau_old = tau / 5, tau
                else:
                    nonfinite = 0
                    m_new, tau_new, q, kappa = _adapt(
                        m, tau, eps, m_old, tau_old, eps_old, q, kappa,
                        gamma, omega, maxtau, n, p, nnz_eff, iop_cost,
                        S["Hnorm"])
                    m_new = _bucket_m(m_new, n, m_max)
                    m, m_old = m_new, m
                    tau, tau_old = tau_new, tau
                    stats.rejections += 1
                    if m != S["m"]:
                        S = engine.build(W[:, p], m)
                        stats.matvecs += m
                    # else: a tau-only change reuses the basis
                eps, eps_old = engine.err_estimate(S, tau), eps
                omega = (tend / tau) * (eps / abstol)
                if not math.isfinite(omega):
                    omega = math.inf
                if verbose:
                    print(f"  * m = {m}, tau = {tau}, error estimate = {eps}")
            if stats.info:
                break
        # snapshot times inside (t, t + tau]
        snap_taus = []
        while (snapshot < len(ts_sorted)
               and t + tau >= ts_sorted[snapshot] - 1e-14 * tend):
            snap_taus.append(float(ts_sorted[snapshot]) - t)
            snapshot += 1
        first = snapshot - len(snap_taus)
        if two_pass:
            # one replay gives the phi_p column at the accepted tau and at
            # every snapshot tau
            cols = engine.replay_pcols(S, snap_taus + [tau])
            stats.matvecs += m
            for i, tau_s in enumerate(snap_taus):
                U[:, first + i] = _update_u(W, cols[:, i], tau_s, p)
            u = _update_u(W, cols[:, -1], tau, p)
        else:
            u = _update_u(W, engine.pcol(S, tau), tau, p)
            for i, tau_s in enumerate(snap_taus):
                U[:, first + i] = _update_u(W, engine.pcol(S, tau_s), tau_s,
                                            p)
        t += tau
        stats.steps += 1

    stats.final_m, stats.final_tau = m, tau
    if verbose:
        print(f"Completed after {stats.steps} time step(s)")
    U = _unsort(U, ts_arr)
    out = U[:, 0] if scalar_ts else U
    if return_stats:
        return out, stats
    _warn_discarded_info(stats, "phiv_timestep")
    return out


def _warn_discarded_info(stats, what: str):
    """A caller who did not ask for the stats still hears of a failure
    (stats.info != 0: the returned U is partly NaN)."""
    if stats.info:
        warnings.warn(
            f"{what}: solve terminated with info={stats.info} "
            "(persistent non-finite error estimate); unfilled snapshot "
            "columns are NaN. Pass return_stats=True to consume the "
            "failure code programmatically.",
            RuntimeWarning, stacklevel=3)


def expv_timestep(ts, A, b, **kwargs):
    """exp(tA) b by NW time stepping: the p = 0 case of ``phiv_timestep``."""
    op = aslinearoperator(A)
    return phiv_timestep(ts, op, action_vector(b, op)[:, None], **kwargs)


class _FusedState:
    """The fixed stepper's loop state (the JAX scan's carry and its ys),
    made before the loop: u, t (0-d, in B's real dtype), the step counter
    k (0-d int64) and the error history eps ((nsteps,)). ``write`` stores
    a substep's results in place (what a CUDA graph replays), or with
    ``rebind`` binds the names to them (the first substep, whose results
    set u's and eps's dtypes, and every substep that autograd or a
    ``torch.func`` transform must see)."""

    def __init__(self, B, nsteps: int):
        rdt = B.real.dtype if B.is_complex() else B.dtype
        self.u = B[:, 0]
        self.t = torch.zeros((), dtype=rdt, device=B.device)
        self.k = torch.zeros((), dtype=torch.int64, device=B.device)
        self.eps = torch.zeros(nsteps, dtype=rdt, device=B.device)
        self.rebind = True

    def write(self, live, u, t, eps):
        at = torch.clamp(self.k, max=self.eps.shape[0] - 1).reshape(1)
        eps = torch.where(live, eps, self.eps.index_select(0, at)[0])
        if self.rebind:
            self.u = torch.where(live, u, self.u)
            self.t = torch.where(live, t, self.t)
            self.eps = self.eps.to(eps.dtype).index_copy(0, at,
                                                         eps.reshape(1))
            self.k = self.k + live.to(self.k.dtype)
        else:
            graphs.masked_copy(self.u, live, u)
            graphs.masked_copy(self.t, live, t)
            self.eps.index_copy_(0, at, eps.reshape(1))
            self.k.add_(live.to(self.k.dtype))


def _fused_scan(op, B, tend: float, p: int, m: int, nsteps: int, iop: int,
                correct: bool, hermitian: bool) -> graphs.ScanParts:
    """The fixed stepper as a scan (``utils/graphs.ScanParts``): one
    substep over ``_FusedState`` (JAX's scan body: W, the basis, the
    reduced phi with a 0-d tau, the combination and the update), masked by
    k < nsteps, ``nsteps`` times; the result (u(tend), the (nsteps,) error
    estimates); the restart puts u = B[:, 0] and t = k = 0 back."""
    S = _FusedState(B, nsteps)
    tau = torch.full((), tend / nsteps, dtype=S.t.dtype, device=B.device)

    def step():
        live = S.k < nsteps
        W = _compute_W(op, S.u, B, S.t, p)
        Ks = build_subspace(op, W[:, p], m, iop=iop, hermitian=hermitian)
        C2 = _reduced_phi(tau, Ks.H, p + 1, expm_method="taylor_masked")
        P, eps = _phiv_combine(tau, Ks, C2, p + 1, correct)
        S.write(live, _update_u(W, P[:, p], tau, p), S.t + tau, eps)

    def restart():
        S.u.copy_(B[:, 0])
        S.t.zero_()
        S.k.zero_()

    return graphs.ScanParts(S, step, nsteps, lambda: (S.u, S.eps), restart)


def _phiv_timestep_fused(op, B, tend: float, p: int, m: int, nsteps: int,
                         iop: int, correct: bool, hermitian: bool):
    """nsteps substeps of tau = tend / nsteps at a fixed m, with no host
    read: (u(tend), the (nsteps,) error estimates). The scan
    (``_fused_scan``) runs its first substep rebinding the state; then,
    unless autograd or a transform must see it, the rest in place (module
    doc): inline inside a step that a runner executes or a capture
    records, else through a ``graphs.LoopRunner`` of the call's own."""
    scan = _fused_scan(op, B, tend, p, m, nsteps, iop, correct, hermitian)
    if graphs.inline(B.device):
        graphs.run_scan(scan, None, m)
    else:
        with graphs.LoopRunner(
                f"phiv_timestep_fused ({type(op).__name__})", B.device,
                sharded=operator_comm(op) is not None) as runner:
            graphs.run_scan(scan, runner, m)
    return scan.result()


def phiv_timestep_fused(t_end, A, B, *, nsteps: int, m: int = 10,
                        iop: int = 0, correct: bool = False,
                        hermitian: bool | None = None):
    """Fixed-(tau, m) Niesen-Wright stepping with no host read: the
    production form once tau and m are known (from the adaptive driver's
    ``TimestepStats.final_tau / final_m``). Returns (u(t_end), the
    per-substep error estimates)."""
    op = aslinearoperator(A)
    B = _as_columns(B, op)
    p = B.shape[1] - 1
    herm = op.is_hermitian if hermitian is None else hermitian
    m = min(m, op.shape[0])
    return _phiv_timestep_fused(op, B, float(t_end), p, m, nsteps, iop,
                                correct, herm)


def expv_timestep_fused(t_end, A, b, *, nsteps: int, m: int = 10,
                        iop: int = 0, hermitian: bool | None = None):
    """exp(t_end A) b by fixed-tau substeps (the p = 0 case of
    ``phiv_timestep_fused``)."""
    op = aslinearoperator(A)
    return phiv_timestep_fused(t_end, op, action_vector(b, op)[:, None],
                               nsteps=nsteps, m=m, iop=iop,
                               hermitian=hermitian)


def make_phiv_timestep(t_end, A, B, *, tol: float = 1e-7, m: int = 10,
                       iop: int = 0, correct: bool = False,
                       hermitian: bool | None = None, safety: float = 0.8):
    """Calibrate, then fix: run the adaptive driver once for a working
    (tau, m), and return ``fn(B) -> (u(t_end), eps_history)``, a
    fixed-(tau, m) stepper with no host read, each call one scan (the JAX
    package's jitted ``_phiv_timestep_fused``, a ``lax.scan``):
    ``utils/graphs.Scan`` keeps per key (B's shape, dtype and device, grad
    mode) the substep's state and its CUDA graph, captured at the second
    substep of the first call; every later call replays that graph
    ``nsteps`` times, with no capture and no read, the results fresh
    tensors each call (the graph is one substep, so it does not grow with
    ``nsteps``); a call that autograd or a ``torch.func`` transform must
    see runs eagerly. Like ``make_expv``'s, the closure follows the operator's
    current storage ("Stale storage" there). ``safety`` shrinks the
    calibrated tau so the fixed grid stays inside the accepted-error
    region for nearby inputs. ``fn.nsteps`` and ``fn.m`` are the
    calibrated grid, ``fn.close()`` frees the graphs."""
    op = aslinearoperator(A)
    B = _as_columns(B, op)
    _, stats = phiv_timestep(float(t_end), op, B, tol=tol, m=m, iop=iop,
                             correct=correct, adaptive=True,
                             hermitian=hermitian, return_stats=True)
    tau = max(stats.final_tau * safety, 1e-300)
    nsteps = max(1, int(math.ceil(float(t_end) / tau)))
    m_cal = max(stats.final_m, 2)
    herm = op.is_hermitian if hermitian is None else hermitian
    m_op = min(m_cal, op.shape[0])
    prog = graphs.Scan(f"make_phiv_timestep ({type(op).__name__})",
                       sharded=operator_comm(op) is not None, holds=op)

    def make(B_new):
        return _fused_scan(op, B_new, float(t_end), B_new.shape[1] - 1,
                           m_op, nsteps, iop, correct, herm)

    def fn(B_new):
        B_new = _as_columns(B_new, op)
        return prog((tuple(B_new.shape), B_new.dtype, B_new.device,
                     torch.is_grad_enabled()), make, (B_new,))

    fn.nsteps = nsteps
    fn.m = m_cal
    fn.program = prog
    fn.close = prog.close
    return fn

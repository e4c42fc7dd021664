"""KIOPS with the control flow of the JAX package's device loop (PyTorch
port of ``exponentialutilities_jl_tpu/models/kiops_device.py``).

The JAX package runs the substep and rejection loop of ``kiops`` as one
``lax.while_loop`` program per Krylov size m: every substep builds the
augmented basis (a rejected substep builds it again from the same start),
takes one trial, estimates the order, and accepts or rejects; an m change
ends the program with ``want_m`` set and the host re-enters at the new
bucket of ``_M_LADDER``, where the basis is rebuilt (no ``arnoldi_extend``
resume). Here that program is a host loop with the same control flow and
arithmetic, so the stats are those of the JAX device driver, which differ
from ``kiops``'s.

Host reads per substep: two, the new basis's scalars (effective
dimension, breakdown flag, residual, beta and the augmented Hessenberg's
1-norm, in one transfer) and then the trial's error estimate (the reduced
exponential is told its 1-norm). A snapshot inside a substep adds the read
of its exponential's 1-norm. W stays on the operator's device.

``expm_method="auto"`` is ``"higham2005"`` (the H100 has float64 LU);
``"taylor"`` selects the solver-free engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.expm import expm_higham2005, expm_taylor
from ..utils.linop import aslinearoperator
from ..utils.precision import full_precision
from .expv import build_subspace
from .kiops import (KiopsStats, _augmented_columns, _Basis, _kiops_err,
                    _kiops_x0, _phantom_hessenberg)
from .timestepping import _MAX_NONFINITE_REJECTS

__all__ = ["kiops_device"]

_M_LADDER = (10, 13, 17, 22, 29, 38, 49, 64, 83, 108, 128)


def _bucket(m, mmin, mmax):
    m = max(mmin, min(m, mmax))
    for b in _M_LADDER:
        if b >= m:
            return max(mmin, min(b, mmax))
    return mmax


def _fpow(a: float, b: float) -> float:
    """a ** b, with inf on overflow (the device arithmetic's answer)."""
    try:
        return a ** b
    except OverflowError:
        return math.inf


def _ratio_log(num: float, den: float) -> float:
    """log(num) / log(den), inf when log(den) is 0."""
    d = math.log(den)
    return math.log(num) / d if d != 0 else math.inf


@full_precision
def _phantom(Kb: _Basis, tau_sgn: float, n: int, expm_method: str):
    """A snapshot inside an accepted substep (no phi_1 coupling)."""
    engine = expm_taylor if expm_method == "taylor" else expm_higham2005
    F2 = engine(tau_sgn * _phantom_hessenberg(Kb.H, Kb.m_used))
    rows = torch.arange(Kb.m + 1, device=F2.device)
    col = Kb.beta.to(F2.dtype) * torch.where(rows < Kb.m_used, F2[:, 0], 0)
    dt = torch.promote_types(col.dtype, Kb.V.dtype)
    return col.to(dt) @ Kb.V[:, :n].to(dt)


def _substeps(aug, ts, st, tau_end, tol, sgn, mu, p, m, iop, expm_method,
              max_steps, mmax_is_m):
    """Substeps at one Krylov size m (the JAX ``_kiops_device`` program);
    updates the state dict ``st`` in place."""
    n = aug.n_main
    gamma, gamma_mmax = (0.2, 0.1) if tau_end > 1 else (0.9, 0.6)
    delta = 1.4
    nt = len(ts)
    while (st["t"] < tau_end * (1 - 1e-14) and st["steps"] < max_steps
           and st["want_m"] == 0 and st["info"] == 0):
        t = st["t"]
        tau = min(st["tau"], tau_end - t)
        x0 = _kiops_x0(st["w"], t, mu, p)
        Ks = build_subspace(aug, x0, m, iop=iop, hermitian=False)
        Kb = _Basis(H=Ks.H, beta=Ks.beta, m_used=Ks.m_used,
                    breakdown=Ks.breakdown, V=Ks.V, Ks=Ks).summarize()
        j, happy = Kb.j, Kb.happy
        coeffs, err = _kiops_err(Kb, sgn * tau, expm_method)
        bad = not math.isfinite(err)
        omega_raw = tau_end * err / (tau * tol)
        omega = (0.0 if happy else
                 omega_raw if math.isfinite(omega_raw) else math.inf)

        # order and kappa estimates
        prev_ok = (math.isfinite(st["oldomega"]) and st["oldomega"] > 0
                   and st["ireject"] >= 1)
        use_obs = False
        if prev_ok and st["oldtau"] != tau:
            order_obs = _ratio_log(max(omega / st["oldomega"], 1e-300),
                                   max(tau / st["oldtau"], 1e-300))
            use_obs = math.isfinite(order_obs)
        order = (max(1.0, order_obs) if use_obs else
                 j / 4 if st["orderold"] else st["order"])
        orderold = not use_obs
        kest = 2.0 if st["kestold"] else st["kest"]

        remaining = (tau_end - t if omega > delta else tau_end - (t + tau))
        order_eff = max(order, 1e-2)
        tau_opt = tau * _fpow(gamma / max(omega, 1e-16), 1.0 / order_eff)
        tau_opt = min(remaining, max(tau / 5, min(5 * tau, tau_opt)))
        x = j + math.log(max(omega / gamma, 1e-16)) / math.log(kest)
        lo, hi = (3 * m) // 4, (4 * m + 2) // 3
        m_opt = min(max(math.ceil(x), lo), hi) if math.isfinite(x) else hi

        at_mmax = mmax_is_m and j == m
        tau_mmax = tau * _fpow(gamma_mmax / max(omega, 1e-16),
                               1.0 / order_eff)
        tau_mmax = min(tau_end - t, max(tau / 5, tau_mmax))
        if happy:
            tau_new = min(tau_end - (t + tau), tau)
        elif at_mmax:
            tau_new = tau_mmax if omega > delta else tau_opt
        else:
            tau_new = tau
        want_m = (0 if happy or at_mmax or omega <= delta or m_opt == m
                  or bad else m_opt)
        # a tau shrink replaces the m request on a non-finite estimate
        if bad:
            tau_new = tau / 5
        elif want_m == 0 and not happy and not at_mmax:
            tau_new = tau_opt if omega > delta else min(remaining, tau)
        nonfin = st["nonfin"] + 1 if bad else 0
        failed = nonfin > _MAX_NONFINITE_REJECTS
        accepted = omega <= delta and want_m == 0 and not failed and not bad

        if accepted:
            next_t = t + tau
            dt = torch.promote_types(coeffs.dtype, Ks.V.dtype)
            w_new = coeffs.to(dt) @ Ks.V[:, :n].to(dt)
            for i in range(nt):
                # snapshots strictly inside (t, next_t); the one at next_t
                # is w_new itself
                if (not st["done"][i] and ts[i] > t
                        and ts[i] < next_t - 1e-14 * tau_end):
                    st["W"][:, i] = _phantom(Kb, sgn * (ts[i] - t), n,
                                             expm_method)
                    st["done"][i] = True
            for i in range(nt):
                if (not st["done"][i]
                        and abs(ts[i] - next_t) <= 1e-14 * tau_end):
                    st["W"][:, i] = w_new
                    st["done"][i] = True
            st["w"], st["t"] = w_new, next_t
        st.update(tau=max(tau_new, 1e-300), oldtau=tau, oldomega=omega,
                  order=order, kest=kest, orderold=orderold, nonfin=nonfin,
                  ireject=0 if accepted else st["ireject"] + 1,
                  want_m=want_m)
        st["steps"] += accepted
        st["rejections"] += not accepted
        st["krylov"] += j
        st["exps"] += 1
        if failed:
            st["info"] = 2


def kiops_device(ts, A, u, *, m: int = 10, tol: float = 1e-7, iop: int = 2,
                 mmin: int = 10, mmax: int = 128, expm_method: str = "auto",
                 task1: bool = False, max_steps: int = 10_000,
                 return_stats: bool = True):
    """KIOPS with the control flow of the JAX device loop (module doc).
    Same contract as ``kiops``: u (n, p+1) columns [b_0 ... b_p]; returns
    the phi combination at the requested times on the operator's device
    (plus ``KiopsStats``)."""
    op = aslinearoperator(A)
    scalar_t = np.ndim(ts) == 0
    tau_out = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    u, p, mu, aug = _augmented_columns(op, u)
    n = u.shape[0]
    sgn = float(np.sign(tau_out[-1])) or 1.0
    tau_end = float(abs(tau_out[-1]))
    nt = len(tau_out)
    if expm_method == "auto":
        expm_method = "higham2005"

    m = _bucket(m, mmin, mmax)
    st = {"w": u[:, 0], "t": 0.0, "tau": tau_end, "oldtau": math.nan,
          "oldomega": math.nan, "order": 1.0, "kest": 2.0,
          "orderold": True, "kestold": True, "ireject": 0, "nonfin": 0,
          "W": torch.zeros((n, nt), dtype=u.dtype, device=u.device),
          "done": [False] * nt, "steps": 0, "rejections": 0, "krylov": 0,
          "exps": 0, "want_m": 0, "info": 0}
    ts_abs = [abs(float(x)) for x in tau_out]
    for _ in range(32):
        _substeps(aug, ts_abs, st, tau_end, tol, sgn, mu, p, m, iop,
                  expm_method, max_steps, m >= mmax)
        if st["want_m"] == 0:
            break
        m = _bucket(st["want_m"], mmin, mmax)
        st["want_m"] = 0

    stats = KiopsStats(steps=st["steps"], rejections=st["rejections"],
                       krylov_steps=st["krylov"], exps=st["exps"],
                       last_m=m, info=st["info"])
    W = st["W"]
    if stats.info:
        W[:, [i for i, d in enumerate(st["done"]) if not d]] = math.nan
    if task1:
        for i in range(nt):
            if tau_out[i] != 0:
                W[:, i] = W[:, i] * (1.0 / tau_out[i]) ** p
    out = W[:, 0] if scalar_t else W
    return (out, stats) if return_stats else out

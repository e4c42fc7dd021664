"""The Niesen-Wright adaptive driver with the control flow of the JAX
package's device loop (PyTorch port of
``exponentialutilities_jl_tpu/models/nw_device.py``).

The JAX package runs this driver as one ``lax.while_loop`` program per
Krylov size m: each substep builds the basis, runs a bounded inner loop of
tau-only rejections (at most ``max_rejects`` trials, each one reduced
(m+p+1)^2 exponential), fills the snapshots inside the accepted substep
and accumulates the solution; when the cost model prefers another m
bucket, the program ends with ``want_m`` set and the host re-enters at
the new bucket. Here that program is a host loop with the same control
flow and the same arithmetic, so the steps, rejections and matvecs are
those of the JAX device driver (which differ from the host driver
``phiv_timestep``'s: its inner loop never changes m, and it keeps kappa
at 2).

Host reads per substep: one for the new basis (in one transfer) and one
per tau trial (the trial's error estimate; every reduced exponential is
told its 1-norm, snapshots included). No CUDA graph is captured: the
loop's branches follow the values it reads.

A row-sharded operator (``parallel.shard_operator``) runs as in
``phiv_timestep``: this rank's rows of B, global n in the cost model.

``expm_method="auto"`` is ``"higham2005"`` (the H100 has float64 LU);
``"taylor"`` selects the solver-free engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.comm import operator_comm, pmax
from ..utils.linop import aslinearoperator
from ..utils.device import action_vector
from .expv import build_subspace
from .phiv import _reduced_phi
from .timestepping import (_MAX_NONFINITE_REJECTS, _M_BUCKETS, TimestepStats,
                           _as_columns, _basis_summary, _bucket_m,
                           _compute_W, _initial_tau, _signed_ts_dispatch,
                           _unsort, _update_u, _warn_discarded_info)

__all__ = ["phiv_timestep_device", "expv_timestep_device"]


def _flops_model(m, tau, n, p, nnz, iop, Hnorm, maxtau):
    """NW cost model (23) as the JAX device driver evaluates it (float
    arithmetic; the host twin is ``timestepping._estimate_flops``)."""
    m = float(m)
    flops_W = 2 * (p - 1) * (nnz + n)
    flops_u = (2 * p + 1) * n
    flops_matvec = 2 * m * nnz
    if iop > 0:
        flops_vecvec = 3.0 * iop * m
    else:
        flops_vecvec = 3 * m * (m + 1) / 2
    MH = 44 / 3 + 2 * math.ceil(max(0.0, math.log2(max(Hnorm, 1e-300) / 5.37)))
    flops_phiv = MH * (m + p) ** 3
    one = flops_W + flops_u + flops_matvec + flops_vecvec + flops_phiv
    nsub = math.ceil(maxtau / max(tau, 1e-300))
    return one * max(nsub, 1.0)


def _m_bucket_request(m: int, omega: float, gamma: float, n: int) -> int:
    """The bucket the device loop would ask for (kappa = 2)."""
    lo, hi = (3 * m) // 4, (4 * m + 2) // 3
    x = math.log(max(omega / gamma, 1e-16)) / math.log(2.0)
    m_est = min(max(m + math.ceil(x), lo), hi) if math.isfinite(x) else hi
    for b in _M_BUCKETS:
        if b >= m_est:
            break
    return min(b, n)


def _substeps(op, B, ts, st, tend, abstol, delta, gamma, p, m, iop,
              hermitian, expm_method, max_steps, max_rejects, nnz_eff):
    """Substeps at one Krylov size m until the end, ``max_steps``, a
    bucket request or a failure (the JAX ``_nw_device`` program); updates
    the state dict ``st`` in place."""
    n = op.shape[0]             # global (sharded B: this rank's rows)
    kk = p + 1
    nt = len(ts)
    while (st["t"] < tend * (1 - 1e-14) and st["steps"] < max_steps
           and st["want_m"] == 0 and st["info"] == 0):
        t = st["t"]
        maxtau = tend - t
        tau = min(st["tau"], maxtau)
        W = _compute_W(op, st["u"], B, t, p)
        Ks = build_subspace(op, W[:, p], m, iop=iop, hermitian=hermitian)
        broke, m_used, beta, h_res, Hnorm, hm = _basis_summary(
            Ks.H, Ks.beta, Ks.m_used, Ks.breakdown)
        if broke:
            tau = maxtau
        last = max(m_used - 1, 0)

        def c2_of(tau_):
            return _reduced_phi(tau_, Ks.H, kk, expm_method=expm_method,
                                hnorm=hm)

        def eps_of(tau_):
            C2 = c2_of(tau_)
            return beta * h_res * tau_ * abs(C2[last, kk].item()), C2

        def omega_of(eps_, tau_):
            w = (tend / tau_) * (eps_ / abstol)
            return w if math.isfinite(w) else math.inf

        eps, C2 = eps_of(tau)
        omega = omega_of(eps, tau)
        # the bounded rejection loop: tau-only adaptation, reduced cost
        eps_old, tau_old, q = eps, tau, m / 4
        trials = nonfin = want_m = rej = 0
        while (omega > delta and trials < max_rejects and want_m == 0
               and nonfin <= _MAX_NONFINITE_REJECTS):
            bad = not math.isfinite(eps)
            ratio_ok = (tau_old > tau and eps != eps_old and eps_old > 0
                        and eps > 0 and not bad
                        and math.isfinite(eps_old))
            q_new = (math.log(tau / tau_old)
                     / math.log(max(eps / eps_old, 1e-300)) - 1
                     if ratio_ok else q)
            q_new = min(max(q_new, 0.25), 4.0 * m)
            if bad:
                # a non-finite estimate: hard tau shrink
                want_new, tau_new = 0, tau / 5
            else:
                tau_opt = tau * (gamma / omega) ** (1.0 / (q_new + 1.0))
                tau_opt = min(min(max(tau_opt, tau / 5), 2 * tau), maxtau)
                m_req = _m_bucket_request(m, omega, gamma, n)
                cost_tau = _flops_model(m, tau_opt, n, p, nnz_eff, iop,
                                        Hnorm, maxtau)
                cost_m = _flops_model(m_req, tau, n, p, nnz_eff, iop,
                                      Hnorm, maxtau)
                prefer_m = cost_m < cost_tau and m_req != m
                want_new = m_req if prefer_m else 0
                tau_new = tau if prefer_m else tau_opt
            eps_new, C2 = eps_of(tau_new)
            eps_old, eps = eps, eps_new
            tau_old, tau = tau, tau_new
            q, omega = q_new, omega_of(eps_new, tau_new)
            trials += 1
            nonfin += bad
            want_m = want_new
            rej += 1

        failed = nonfin > _MAX_NONFINITE_REJECTS
        accepted = omega <= delta and want_m == 0 and not failed
        if accepted:
            # the accepted substep's work: the only n-sized operations
            # (C2 is the last trial's, at this tau)
            V = Ks.V[:m]
            dt = torch.promote_types(C2.dtype, V.dtype)
            bt = Ks.beta.to(dt)

            def pcol(C):
                return (C[:, p].to(dt) @ V.to(dt)) * bt

            u_new = _update_u(W, pcol(C2), tau, p)
            for i in range(nt):
                if not st["done"][i] and ts[i] <= t + tau + 1e-14 * tend:
                    tau_s = max(ts[i] - t, 0.0)
                    st["U"][:, i] = _update_u(W, pcol(c2_of(tau_s)), tau_s, p)
                    st["done"][i] = True
            st["u"] = u_new
            st["t"] = t + tau
            st["steps"] += 1
        st["tau"] = tau
        st["rejections"] += rej
        st["matvecs"] += p + m
        st["want_m"] = want_m
        if failed:
            st["info"] = 2


def phiv_timestep_device(ts, A, B, *, m: int = 10, tol: float = 1e-7,
                         opnorm=None, tau: float = 0.0, iop: int = 0,
                         delta: float = 1.2, gamma: float = 0.8,
                         nnz: int = 0, m_max: int = 256,
                         hermitian: bool | None = None,
                         expm_method: str = "auto",
                         max_steps: int = 10_000, max_rejects: int = 24,
                         return_stats: bool = False):
    """Niesen-Wright adaptive phi combination with the JAX device loop's
    control flow (module doc). Same contract as
    ``phiv_timestep(adaptive=True)``: U (n, nt) (or (n,) for a scalar ts)
    = sum_j t^j phi_j(tA) b_j at the requested times, on the operator's
    device, plus ``TimestepStats`` with ``return_stats=True``."""
    op = aslinearoperator(A)
    if nnz == 0 and hasattr(op, "nnz"):
        nnz = int(op.nnz)
    B = _as_columns(B, op)
    handled = _signed_ts_dispatch(
        phiv_timestep_device, ts, op, B, return_stats,
        dict(m=m, tol=tol, opnorm=opnorm, tau=tau, iop=iop, delta=delta,
             gamma=gamma, nnz=nnz, m_max=m_max, hermitian=hermitian,
             expm_method=expm_method, max_steps=max_steps,
             max_rejects=max_rejects))
    if handled is not None:
        return handled
    scalar_ts = np.ndim(ts) == 0
    ts_arr = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    ts_sorted = np.sort(ts_arr, kind="stable")
    tend = float(ts_sorted[-1])
    n_rows, ppo = B.shape
    n = op.shape[0]
    p = ppo - 1
    if hermitian is None:
        hermitian = op.is_hermitian
    m = _bucket_m(m, n, m_max)
    if expm_method == "auto":
        expm_method = "higham2005"
    nnz_eff = float(nnz) if nnz > 0 else float(n) * float(n)

    b0norm = float(pmax(B[:, 0].abs().max(), operator_comm(op)))
    if opnorm is None:
        # matrix-free scale from a first Hessenberg's 1-norm
        W0 = _compute_W(op, B[:, 0], B, 0.0, p)
        Ks0 = build_subspace(op, W0[:, p], m, iop=iop, hermitian=hermitian)
        opn = float(Ks0.H.abs().sum(dim=0).max())
    else:
        opn = float(opnorm)
    abstol = tol * max(opn, 1e-300)
    if tau == 0.0:
        tau = min(tend, max(gamma * _initial_tau(abstol, opn, m, b0norm,
                                                 tend), 1e-300))

    st = {"u": B[:, 0], "t": 0.0, "tau": float(tau),
          "U": torch.zeros((n_rows, len(ts_sorted)), dtype=B.dtype,
                           device=B.device),
          "done": [False] * len(ts_sorted), "steps": 0, "rejections": 0,
          "matvecs": 0, "want_m": 0, "info": 0}
    for _ in range(32):                     # bucket-change bound
        _substeps(op, B, [float(x) for x in ts_sorted], st, tend, abstol,
                  delta, gamma, p, m, iop, bool(hermitian), expm_method,
                  max_steps, max_rejects, nnz_eff)
        if st["want_m"] == 0:
            break
        m = _bucket_m(st["want_m"], n, m_max)
        st["want_m"] = 0

    stats = TimestepStats(steps=st["steps"], rejections=st["rejections"],
                          matvecs=st["matvecs"], final_m=m,
                          final_tau=st["tau"], info=st["info"])
    U = st["U"]
    if stats.info:
        undone = [i for i, d in enumerate(st["done"]) if not d]
        U[:, undone] = math.nan
    U = _unsort(U, ts_arr)
    out = U[:, 0] if scalar_ts else U
    if return_stats:
        return out, stats
    _warn_discarded_info(stats, "phiv_timestep_device")
    return out


def expv_timestep_device(ts, A, b, **kwargs):
    """exp(tA) b with the device-loop adaptive driver (p = 0)."""
    op = aslinearoperator(A)
    return phiv_timestep_device(ts, op, action_vector(b, op)[:, None],
                                **kwargs)

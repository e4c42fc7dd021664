"""KIOPS as the JAX package's device loop (PyTorch port of
``exponentialutilities_jl_tpu/models/kiops_device.py``).

The JAX package runs the substep and rejection loop of ``kiops`` as one
``lax.while_loop`` program per Krylov size m: every substep builds the
augmented basis (a rejected substep builds it again from the same start),
takes one trial, estimates the order, and accepts or rejects; an m change
ends the program with ``want_m`` set and the host re-enters at the new
bucket of ``_M_LADDER``, where the basis is rebuilt (no ``arnoldi_extend``
resume). Here one substep is one masked step over device tensors
(``_Bucket.step``), run by ``utils/graphs.LoopRunner``: on a CUDA device
from one CUDA graph per bucket, on the CPU eagerly. Arithmetic and control
flow are the JAX device driver's, so the stats are its own, which differ
from ``kiops``'s. Each snapshot's phantom is a masked write (each step
evaluates one reduced exponential and one n-sized combination per
requested time).

Host reads per solve: one at the start (sum |u_1..u_p|, the augmented
columns' scale) and one when each bucket's loop ends (its flags carry the
want_m request and the stats); the flags read within a bucket lag one
step behind the device (``utils/graphs``). W stays on the operator's
device. A row-sharded operator's steps run eagerly (its collectives
cannot be captured).

``expm_method="auto"`` is ``"higham2005"`` (the H100 has float64 LU);
``"taylor"`` selects the solver-free engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.expm import _onenorm, expm_higham2005, expm_taylor
from ..utils.comm import operator_comm
from ..utils.device import action_vector
from ..utils.graphs import LoopRunner, masked_copy
from ..utils.linop import aslinearoperator
from ..utils.precision import full_precision
from .expv import build_subspace
from .kiops import (KiopsStats, _aug_hessenberg, _augmented_columns,
                    _kiops_x0, _phantom_hessenberg)
from .nw_device import _F64, _I64
from .phiv import _row
from .timestepping import _MAX_NONFINITE_REJECTS

__all__ = ["kiops_device"]

_M_LADDER = (10, 13, 17, 22, 29, 38, 49, 64, 83, 108, 128)


def _bucket(m, mmin, mmax):
    m = max(mmin, min(m, mmax))
    for b in _M_LADDER:
        if b >= m:
            return max(mmin, min(b, mmax))
    return mmax


class _State:
    """The loop state that all buckets share (0-d tensors unless noted)."""

    def __init__(self, u, nt, tau_end, tol, sgn, mu, ts):
        dev = u.device

        def f64(v):
            return torch.full((), v, dtype=_F64, device=dev)

        def i64(v=0):
            return torch.full((), v, dtype=_I64, device=dev)

        self.w = u[:, 0].clone()
        self.t, self.tau = f64(0.0), f64(tau_end)
        self.oldtau, self.oldomega = f64(math.nan), f64(math.nan)
        self.order, self.kest = f64(1.0), f64(2.0)
        self.orderold = torch.ones((), dtype=torch.bool, device=dev)
        self.kestold = torch.ones((), dtype=torch.bool, device=dev)
        self.ireject, self.nonfin = i64(), i64()
        self.W = torch.zeros((u.shape[0], nt), dtype=u.dtype, device=dev)
        self.done = torch.zeros(nt, dtype=torch.bool, device=dev)
        self.steps, self.rejections, self.krylov, self.exps = (i64(), i64(),
                                                               i64(), i64())
        self.want_m, self.info = i64(), i64()
        # [active, want_m, info, steps, rejections, krylov, exps]
        self.flags = torch.zeros(7, dtype=_F64, device=dev)
        self.tau_end, self.tol, self.five = f64(tau_end), f64(tol), f64(5.0)
        g, gm = (0.2, 0.1) if tau_end > 1 else (0.9, 0.6)
        self.gamma, self.gamma_mmax = f64(g), f64(gm)
        self.sgn, self.mu = sgn, mu
        self.ts = torch.as_tensor(ts, dtype=_F64).to(dev)


class _Bucket:
    """The substep at one Krylov size m."""

    def __init__(self, S: _State, aug, m, *, p, iop, expm_method, max_steps,
                 mmax_is_m):
        self.S, self.aug, self.m, self.p, self.iop = S, aug, m, p, iop
        self.engine = (expm_taylor if expm_method == "taylor"
                       else expm_higham2005)
        self.max_steps, self.mmax_is_m = max_steps, mmax_is_m

    def _active(self):
        S = self.S
        return ((S.t < S.tau_end * (1 - 1e-14)) & (S.steps < self.max_steps)
                & (S.want_m == 0) & (S.info == 0))

    def _phantom(self, Ks, tau_sgn, n):
        """A snapshot inside an accepted substep (no phi_1 coupling)."""
        Hj = _phantom_hessenberg(Ks.H, Ks.m_used)
        A = tau_sgn.to(Hj.real.dtype) * Hj
        F2 = self.engine(A, onenorm=_onenorm(A))
        rows = torch.arange(self.m + 1, device=F2.device)
        col = Ks.beta.to(F2.dtype) * torch.where(rows < Ks.m_used, F2[:, 0],
                                                 0)
        dt = torch.promote_types(col.dtype, Ks.V.dtype)
        return col.to(dt) @ Ks.V[:, :n].to(dt)

    @full_precision
    def step(self):
        """One substep: the augmented basis, one trial, the order and kappa
        estimates, and acceptance (every write masked)."""
        S, m, p = self.S, self.m, self.p
        n = self.aug.n_main
        delta = 1.4
        go = self._active()
        t = S.t
        tau = torch.minimum(S.tau, S.tau_end - t)
        Ks = build_subspace(self.aug, _kiops_x0(S.w, t, S.mu, p), m,
                            iop=self.iop, hermitian=False)
        Haug, nrm = _aug_hessenberg(Ks.H, Ks.m_used)
        j = Ks.m_used.to(_I64)
        jf = j.to(_F64)
        happy = Ks.breakdown
        rdt = Haug.real.dtype
        tau_sgn = S.sgn * tau
        F = self.engine(tau_sgn.to(rdt) * Haug,
                        onenorm=tau_sgn.abs() * Haug.abs().sum(dim=0).max()
                        .to(_F64))
        coeffs = Ks.beta.to(F.dtype) * F[:, 0]
        f_err = _row(_row(F, torch.clamp_min(j - 1, 0)), j)
        err = (Ks.beta.to(_F64) * nrm.abs().to(_F64)
               * f_err.to(torch.promote_types(f_err.dtype, _F64))).abs()
        bad = ~torch.isfinite(err)
        omega_raw = S.tau_end * err / (tau * S.tol)
        omega = torch.where(happy, 0.0,
                            torch.where(torch.isfinite(omega_raw), omega_raw,
                                        math.inf))

        # order and kappa estimates
        prev_ok = (torch.isfinite(S.oldomega) & (S.oldomega > 0)
                   & (S.ireject >= 1))
        num = torch.clamp_min(omega / S.oldomega, 1e-300)
        den = torch.log(torch.clamp_min(tau / S.oldtau, 1e-300))
        order_obs = torch.where(den != 0, torch.log(num) / den, math.inf)
        use_obs = prev_ok & (S.oldtau != tau) & torch.isfinite(order_obs)
        order = torch.where(use_obs, torch.clamp_min(order_obs, 1.0),
                            torch.where(S.orderold, jf / 4, S.order))
        kest = torch.where(S.kestold, 2.0, S.kest)

        remaining = torch.where(omega > delta, S.tau_end - t,
                                S.tau_end - (t + tau))
        order_eff = torch.clamp_min(order, 1e-2)
        tau_opt = tau * (S.gamma / torch.clamp_min(omega, 1e-16)) ** (
            1.0 / order_eff)
        tau_opt = torch.minimum(remaining, torch.maximum(
            tau / S.five, torch.minimum(5 * tau, tau_opt)))
        x = jf + torch.log(torch.clamp_min(omega / S.gamma, 1e-16)) \
            / torch.log(kest)
        lo, hi = (3 * m) // 4, (4 * m + 2) // 3
        m_opt = torch.where(torch.isfinite(x),
                            torch.clamp(torch.ceil(x), lo, hi), float(hi))

        at_mmax = (j == m) if self.mmax_is_m else torch.zeros_like(happy)
        tau_mmax = tau * (S.gamma_mmax / torch.clamp_min(omega, 1e-16)) ** (
            1.0 / order_eff)
        tau_mmax = torch.minimum(S.tau_end - t,
                                 torch.maximum(tau / S.five, tau_mmax))
        tau_new = torch.where(
            happy, torch.minimum(S.tau_end - (t + tau), tau),
            torch.where(at_mmax, torch.where(omega > delta, tau_mmax,
                                             tau_opt), tau))
        want = torch.where(happy | at_mmax | (omega <= delta) | (m_opt == m)
                           | bad, 0, m_opt.to(_I64))
        # a tau shrink replaces the m request on a non-finite estimate
        tau_new = torch.where(
            bad, tau / S.five,
            torch.where((want == 0) & ~happy & ~at_mmax,
                        torch.where(omega > delta, tau_opt,
                                    torch.minimum(remaining, tau)),
                        tau_new))
        nonfin = torch.where(bad, S.nonfin + 1, 0)
        failed = nonfin > _MAX_NONFINITE_REJECTS
        acc = go & (omega <= delta) & (want == 0) & ~failed & ~bad

        next_t = t + tau
        dt = torch.promote_types(coeffs.dtype, Ks.V.dtype)
        w_new = coeffs.to(dt) @ Ks.V[:, :n].to(dt)
        for i in range(S.ts.shape[0]):
            # snapshots strictly inside (t, next_t); the one at next_t is
            # w_new itself
            hit = (acc & ~S.done[i] & (S.ts[i] > t)
                   & (S.ts[i] < next_t - 1e-14 * S.tau_end))
            masked_copy(S.W[:, i], hit,
                 self._phantom(Ks, S.sgn * (S.ts[i] - t), n))
            masked_copy(S.done[i], hit, True)
        for i in range(S.ts.shape[0]):
            hit = (acc & ~S.done[i]
                   & ((S.ts[i] - next_t).abs() <= 1e-14 * S.tau_end))
            masked_copy(S.W[:, i], hit, w_new)
            masked_copy(S.done[i], hit, True)
        masked_copy(S.w, acc, w_new)
        masked_copy(S.t, acc, next_t)
        for dst, val in ((S.tau, torch.clamp_min(tau_new, 1e-300)),
                         (S.oldtau, tau), (S.oldomega, omega),
                         (S.order, order), (S.kest, kest),
                         (S.orderold, ~use_obs), (S.nonfin, nonfin),
                         (S.ireject, torch.where(acc, 0, S.ireject + 1)),
                         (S.want_m, want)):
            masked_copy(dst, go, val)
        S.steps.add_(acc.to(_I64))
        S.rejections.add_((go & ~acc).to(_I64))
        S.krylov.add_(torch.where(go, j, 0))
        S.exps.add_(go.to(_I64))
        masked_copy(S.info, go & failed, 2)
        S.flags.copy_(torch.stack([
            self._active().to(_F64), S.want_m.to(_F64), S.info.to(_F64),
            S.steps.to(_F64), S.rejections.to(_F64), S.krylov.to(_F64),
            S.exps.to(_F64)]))


def _choose(flags):
    """The next step (``graphs.LoopRunner.loop``): one kind of step, until
    the flags show the bucket's loop ended."""
    return "step" if flags is None or flags[0] else None


def kiops_device(ts, A, u, *, m: int = 10, tol: float = 1e-7, iop: int = 2,
                 mmin: int = 10, mmax: int = 128, expm_method: str = "auto",
                 task1: bool = False, max_steps: int = 10_000,
                 return_stats: bool = True):
    """KIOPS as the JAX device loop (module doc). Same contract as
    ``kiops``: u (n, p+1) columns [b_0 ... b_p]; returns the phi
    combination at the requested times on the operator's device (plus
    ``KiopsStats``). On a CUDA device each bucket's substep runs from a
    CUDA graph; on the CPU and for a sharded operator, eagerly."""
    op = aslinearoperator(A)
    scalar_t = np.ndim(ts) == 0
    tau_out = np.atleast_1d(np.asarray(ts, dtype=np.float64))
    comm = operator_comm(op)
    u = action_vector(u, op)
    with LoopRunner("kiops_device", u.device,
                    sharded=comm is not None) as runner:
        u, p, mu, aug = _augmented_columns(
            op, u, read=lambda x: runner.read(x)[0])
        sgn = float(np.sign(tau_out[-1])) or 1.0
        tau_end = float(abs(tau_out[-1]))
        nt = len(tau_out)
        if expm_method == "auto":
            expm_method = "higham2005"
        m = _bucket(m, mmin, mmax)
        S = _State(u, nt, tau_end, tol, sgn, mu, np.abs(tau_out))
        buckets = {}
        for _ in range(32):
            bk = buckets.get(m)
            if bk is None:
                bk = buckets[m] = _Bucket(
                    S, aug, m, p=p, iop=iop, expm_method=expm_method,
                    max_steps=max_steps, mmax_is_m=m >= mmax)
            flags = runner.loop(m, {"step": bk.step}, S.flags, _choose,
                                "step")
            if flags[1] == 0:
                break
            m = _bucket(int(flags[1]), mmin, mmax)
            S.want_m.zero_()

    stats = KiopsStats(steps=int(flags[3]), rejections=int(flags[4]),
                       krylov_steps=int(flags[5]), exps=int(flags[6]),
                       last_m=m, info=int(flags[2]))
    W = S.W
    if stats.info:
        W = torch.where(S.done[None, :], W, math.nan)
    if task1:
        for i in range(nt):
            if tau_out[i] != 0:
                W[:, i] = W[:, i] * (1.0 / tau_out[i]) ** p
    out = W[:, 0] if scalar_t else W
    return (out, stats) if return_stats else out

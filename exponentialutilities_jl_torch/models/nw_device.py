"""The Niesen-Wright adaptive driver as the JAX package's device loop
(PyTorch port of ``exponentialutilities_jl_tpu/models/nw_device.py``).

The JAX package runs this driver as one ``lax.while_loop`` program per
Krylov size m: each substep builds the basis, runs a bounded inner loop of
tau-only rejections (at most ``max_rejects`` trials, each one reduced
(m+p+1)^2 exponential), fills the snapshots inside the accepted substep
and accumulates the solution; when the cost model prefers another m
bucket, the program ends with ``want_m`` set and the host re-enters at
the new bucket. Here the program is two masked steps over device tensors
(``_Bucket.sub``, ``_Bucket.trial``), run by ``utils/graphs.LoopRunner``:
on a CUDA device from one CUDA graph per step and bucket, on the CPU
eagerly. The arithmetic and the control flow are those of the JAX device
driver, so the steps, rejections and matvecs are its own (which differ
from the host driver ``phiv_timestep``'s: its inner loop never changes m,
and it keeps kappa at 2).

A graph has no data-dependent loop, so the rejection loop is unrolled:
``sub`` builds W and the basis, takes the first trial and ``_UNROLL``
further masked trials, and accepts and advances when the trials have
ended; when they have not, it leaves ``pending`` set and ``trial`` runs
``_UNROLL`` more on the stored basis until they do. Every snapshot's fill
is a masked write (each step evaluates one reduced exponential and one
n-sized combination per requested time). Each step's writes are masked
by the loop's own state, so a step after the end, after a bucket request
or after a failure changes nothing.

Host reads per solve: one at the start (|b_0| and the operator norm
scale, as JAX's ``float(...)`` calls), and one when each bucket's loop
ends (its flags carry the want_m request and the stats); the flags read
within a bucket lag one step behind the device (``utils/graphs``).

A row-sharded operator (``parallel.shard_operator``) runs as in
``phiv_timestep`` (this rank's rows of B, global n in the cost model),
with its steps run eagerly: its collectives cannot be captured.

``expm_method="auto"`` is ``"higham2005"`` (the H100 has float64 LU);
``"taylor"`` selects the solver-free engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.comm import operator_comm, pmax
from ..utils.device import action_vector
from ..utils.graphs import LoopRunner, masked_copy
from ..utils.linop import aslinearoperator
from .expv import build_subspace
from .phiv import _reduced_phi, _row
from .timestepping import (_MAX_NONFINITE_REJECTS, _M_BUCKETS, TimestepStats,
                           _as_columns, _basis_summary_device, _bucket_m,
                           _compute_W, _initial_tau, _signed_ts_dispatch,
                           _unsort, _update_u, _warn_discarded_info)

__all__ = ["phiv_timestep_device", "expv_timestep_device"]

# masked rejection trials a step takes after its first (see module doc)
_UNROLL = 2

_F64 = torch.float64
_I64 = torch.int64


def _flops_model(m, tau, n, p, nnz, iop, Hnorm, maxtau):
    """NW cost model (23) as the JAX device driver evaluates it, on 0-d
    float64 tensors (m a host int or a tensor; the host twin is
    ``timestepping._estimate_flops``)."""
    flops_W = 2 * (p - 1) * (nnz + n)
    flops_u = (2 * p + 1) * n
    flops_matvec = 2 * m * nnz
    if iop > 0:
        flops_vecvec = 3.0 * iop * m
    else:
        flops_vecvec = 3 * m * (m + 1) / 2
    MH = 44 / 3 + 2 * torch.ceil(torch.clamp_min(
        torch.log2(torch.clamp_min(Hnorm, 1e-300) / 5.37), 0.0))
    flops_phiv = MH * (m + p) ** 3
    one = flops_W + flops_u + flops_matvec + flops_vecvec + flops_phiv
    nsub = torch.ceil(maxtau / torch.clamp_min(tau, 1e-300))
    return one * torch.clamp_min(nsub, 1.0)


class _State:
    """The loop state that all buckets share (0-d tensors unless noted)."""

    def __init__(self, B, nt, tau, tend, abstol, delta, gamma, ts):
        dev = B.device

        def f64(v):
            return torch.full((), v, dtype=_F64, device=dev)

        def i64(v=0):
            return torch.full((), v, dtype=_I64, device=dev)

        self.u = B[:, 0].clone()
        self.t, self.tau = f64(0.0), f64(tau)
        self.U = torch.zeros((B.shape[0], nt), dtype=B.dtype, device=dev)
        self.done = torch.zeros(nt, dtype=torch.bool, device=dev)
        self.steps, self.rejections, self.matvecs = i64(), i64(), i64()
        self.want_m, self.info = i64(), i64()
        self.pending = torch.zeros((), dtype=torch.bool, device=dev)
        # [active, pending, want_m, info, steps, rejections, matvecs, tau]
        self.flags = torch.zeros(8, dtype=_F64, device=dev)
        self.tend, self.abstol = f64(tend), f64(abstol)
        self.delta, self.gamma, self.five = f64(delta), f64(gamma), f64(5.0)
        self.ts = torch.as_tensor(ts, dtype=_F64).to(dev)
        self.buckets = torch.as_tensor(_M_BUCKETS, dtype=_F64).to(dev)


class _Bucket:
    """The steps at one Krylov size m, with the basis and the trial loop's
    carry kept between them."""

    def __init__(self, S: _State, op, B, m, *, p, iop, hermitian,
                 expm_method, max_steps, max_rejects, nnz_eff):
        self.S, self.op, self.B, self.m, self.p = S, op, B, m, p
        self.iop, self.hermitian = iop, hermitian
        self.expm_method = expm_method
        self.max_steps, self.max_rejects = max_steps, max_rejects
        self.n = op.shape[0]            # global (sharded B: this rank's rows)
        self.nnz_eff = nnz_eff
        dev, dt = B.device, B.dtype
        n_rows = B.shape[0]
        z64 = lambda: torch.zeros((), dtype=_F64, device=dev)  # noqa: E731
        zi = lambda: torch.zeros((), dtype=_I64, device=dev)   # noqa: E731
        # the substep's basis (written by ``sub``, read by ``trial``)
        self.W = torch.zeros((n_rows, p + 1), dtype=dt, device=dev)
        self.V = None
        self.H = None
        self.beta = None
        self.last = zi()
        self.beta_r, self.h_res, self.Hnorm, self.hm = (z64(), z64(), z64(),
                                                        z64())
        self.maxtau = z64()
        # the rejection loop's carry
        self.eps, self.eps_old, self.tau, self.tau_old = (z64(), z64(),
                                                          z64(), z64())
        self.q, self.omega = z64(), z64()
        self.trials, self.nonfin, self.want, self.rej = zi(), zi(), zi(), zi()
        self.C2 = None

    # -- pieces -----------------------------------------------------------

    def _active(self):
        S = self.S
        return ((S.t < S.tend * (1 - 1e-14)) & (S.steps < self.max_steps)
                & (S.want_m == 0) & (S.info == 0))

    def _c2_of(self, tau):
        return _reduced_phi(tau, self.H, self.p + 1,
                            expm_method=self.expm_method, hnorm=self.hm)

    def _eps_of(self, tau):
        C2 = self._c2_of(tau)
        c = _row(C2, self.last)[self.p + 1].abs().to(_F64)
        return self.beta_r * self.h_res * tau * c, C2

    def _omega_of(self, eps, tau):
        S = self.S
        w = (S.tend / tau) * (eps / S.abstol)
        return torch.where(torch.isfinite(w), w, math.inf)

    def _m_request(self, omega):
        """The bucket the device loop would ask for (kappa = 2)."""
        S, m = self.S, self.m
        lo, hi = (3 * m) // 4, (4 * m + 2) // 3
        x = torch.log(torch.clamp_min(omega / S.gamma, 1e-16)) / math.log(2.0)
        m_est = torch.where(torch.isfinite(x),
                            torch.clamp(m + torch.ceil(x), lo, hi), float(hi))
        idx = torch.clamp_max((S.buckets < m_est).sum(),
                              len(_M_BUCKETS) - 1)
        return torch.clamp_max(_row(S.buckets, idx), float(self.n))

    def _flops(self, m, tau):
        return _flops_model(m, tau, self.n, self.p, self.nnz_eff, self.iop,
                            self.Hnorm, self.maxtau)

    def _trial(self, go):
        """One iteration of the bounded rejection loop, masked."""
        S, m = self.S, self.m
        eps, eps_old, tau, tau_old = self.eps, self.eps_old, self.tau, \
            self.tau_old
        omega = self.omega
        live = (go & (omega > S.delta) & (self.trials < self.max_rejects)
                & (self.want == 0) & (self.nonfin <= _MAX_NONFINITE_REJECTS))
        bad = ~torch.isfinite(eps)
        ratio_ok = ((tau_old > tau) & (eps != eps_old) & (eps_old > 0)
                    & (eps > 0) & ~bad & torch.isfinite(eps_old))
        q_new = torch.where(
            ratio_ok, torch.log(tau / tau_old)
            / torch.log(torch.clamp_min(eps / eps_old, 1e-300)) - 1, self.q)
        q_new = torch.clamp(q_new, 0.25, 4.0 * m)
        tau_opt = tau * (S.gamma / omega) ** (1.0 / (q_new + 1.0))
        tau_opt = torch.minimum(torch.minimum(
            torch.maximum(tau_opt, tau / S.five), 2 * tau), self.maxtau)
        m_req = self._m_request(omega)
        cost_tau = self._flops(m, tau_opt)
        cost_m = self._flops(m_req, tau)
        prefer_m = (cost_m < cost_tau) & (m_req != m)
        want_new = torch.where(bad | ~prefer_m, 0, m_req.to(_I64))
        tau_new = torch.where(bad, tau / S.five,
                              torch.where(prefer_m, tau, tau_opt))
        eps_new, C2 = self._eps_of(tau_new)
        omega_new = self._omega_of(eps_new, tau_new)
        masked_copy(self.eps_old, live, eps)
        masked_copy(self.tau_old, live, tau)
        masked_copy(self.eps, live, eps_new)
        masked_copy(self.tau, live, tau_new)
        masked_copy(self.q, live, q_new)
        masked_copy(self.omega, live, omega_new)
        masked_copy(self.trials, live, self.trials + 1)
        masked_copy(self.nonfin, live, self.nonfin + bad.to(_I64))
        masked_copy(self.want, live, want_new)
        masked_copy(self.rej, live, self.rej + 1)
        masked_copy(self.C2, live, C2)

    def _finish(self, go):
        """End of the trial loop: accept and advance (the accepted
        substep's n-sized work, the snapshots inside it), or leave
        ``pending`` set while the trials go on."""
        S, p, m = self.S, self.p, self.m
        live = ((self.omega > S.delta) & (self.trials < self.max_rejects)
                & (self.want == 0)
                & (self.nonfin <= _MAX_NONFINITE_REJECTS))
        fin = go & ~live
        masked_copy(S.pending, go, live)
        failed = self.nonfin > _MAX_NONFINITE_REJECTS
        acc = fin & (self.omega <= S.delta) & (self.want == 0) & ~failed
        t, tau = S.t, self.tau
        V = self.V[:m]
        dt = torch.promote_types(self.C2.dtype, V.dtype)
        bt = self.beta.to(dt)

        def pcol(C):
            return (C[:, p].to(dt) @ V.to(dt)) * bt

        u_new = _update_u(self.W, pcol(self.C2), tau, p)
        reach = t + tau + 1e-14 * S.tend
        for i in range(S.ts.shape[0]):
            hit = acc & ~S.done[i] & (S.ts[i] <= reach)
            tau_s = torch.clamp_min(S.ts[i] - t, 0.0)
            masked_copy(S.U[:, i], hit,
                 _update_u(self.W, pcol(self._c2_of(tau_s)), tau_s, p))
            masked_copy(S.done[i], hit, True)
        masked_copy(S.u, acc, u_new)
        masked_copy(S.t, acc, t + tau)
        S.steps.add_(acc.to(_I64))
        masked_copy(S.tau, fin, tau)
        S.rejections.add_(torch.where(fin, self.rej, 0))
        S.matvecs.add_(fin.to(_I64) * (p + m))
        masked_copy(S.want_m, fin, self.want)
        masked_copy(S.info, fin & failed, 2)

    def _flags(self):
        S = self.S
        S.flags.copy_(torch.stack([
            self._active().to(_F64), S.pending.to(_F64), S.want_m.to(_F64),
            S.info.to(_F64), S.steps.to(_F64), S.rejections.to(_F64),
            S.matvecs.to(_F64), S.tau]))

    # -- the two steps ----------------------------------------------------

    def sub(self):
        """A new substep: W, the basis, the first trial and ``_UNROLL``
        more, then ``_finish``."""
        S, p, m = self.S, self.p, self.m
        go = self._active() & ~S.pending
        maxtau = S.tend - S.t
        W = _compute_W(self.op, S.u, self.B, S.t, p)
        Ks = build_subspace(self.op, W[:, p], m, iop=self.iop,
                            hermitian=self.hermitian)
        broke, m_used, beta_r, h_res, Hnorm, hm = _basis_summary_device(
            Ks.H, Ks.beta, Ks.m_used, Ks.breakdown)
        if self.V is None:              # first call: the buffers' shapes
            self.V, self.H = torch.zeros_like(Ks.V), torch.zeros_like(Ks.H)
            self.beta = torch.zeros_like(Ks.beta)
        masked_copy(self.W, go, W)
        masked_copy(self.V, go, Ks.V)
        masked_copy(self.H, go, Ks.H)
        masked_copy(self.beta, go, Ks.beta)
        masked_copy(self.last, go, torch.clamp_min(Ks.m_used.to(_I64) - 1, 0))
        for dst, val in ((self.beta_r, beta_r), (self.h_res, h_res),
                         (self.Hnorm, Hnorm), (self.hm, hm)):
            masked_copy(dst, go, val.to(_F64))
        masked_copy(self.maxtau, go, maxtau)
        tau = torch.where(broke > 0, maxtau, torch.minimum(S.tau, maxtau))
        eps, C2 = self._eps_of(tau)
        if self.C2 is None:
            self.C2 = torch.zeros_like(C2)
        masked_copy(self.C2, go, C2)
        for dst, val in ((self.eps, eps), (self.eps_old, eps),
                         (self.tau, tau), (self.tau_old, tau),
                         (self.omega, self._omega_of(eps, tau))):
            masked_copy(dst, go, val)
        masked_copy(self.q, go, torch.full_like(self.q, m / 4))
        for dst in (self.trials, self.nonfin, self.want, self.rej):
            masked_copy(dst, go, 0)
        for _ in range(_UNROLL):
            self._trial(go)
        self._finish(go)
        self._flags()

    def trial(self):
        """``_UNROLL`` (at least one) more trials of a pending substep,
        then ``_finish``."""
        go = self._active() & self.S.pending
        for _ in range(max(_UNROLL, 1)):
            self._trial(go)
        self._finish(go)
        self._flags()


def _choose(flags):
    """The next step from the flags of the step before last (None: a
    guess before any read; returns None when the bucket's loop ended)."""
    if flags is None:
        return "sub"
    if not flags[0]:
        return None
    return "trial" if flags[1] else "sub"


def phiv_timestep_device(ts, A, B, *, m: int = 10, tol: float = 1e-7,
                         opnorm=None, tau: float = 0.0, iop: int = 0,
                         delta: float = 1.2, gamma: float = 0.8,
                         nnz: int = 0, m_max: int = 256,
                         hermitian: bool | None = None,
                         expm_method: str = "auto",
                         max_steps: int = 10_000, max_rejects: int = 24,
                         return_stats: bool = False):
    """Niesen-Wright adaptive phi combination as the JAX device loop
    (module doc). Same contract as ``phiv_timestep(adaptive=True)``: U
    (n, nt) (or (n,) for a scalar ts) = sum_j t^j phi_j(tA) b_j at the
    requested times, on the operator's device, plus ``TimestepStats`` with
    ``return_stats=True``. On a CUDA device each bucket's steps run from
    CUDA graphs; on the CPU and for a sharded operator, eagerly."""
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
    n = op.shape[0]
    p = B.shape[1] - 1
    if hermitian is None:
        hermitian = op.is_hermitian
    m = _bucket_m(m, n, m_max)
    if expm_method == "auto":
        expm_method = "higham2005"
    nnz_eff = float(nnz) if nnz > 0 else float(n) * float(n)
    comm = operator_comm(op)

    with LoopRunner("phiv_timestep_device", B.device,
                    sharded=comm is not None) as runner:
        b0norm = pmax(B[:, 0].abs().max(), comm)
        if opnorm is None:
            # matrix-free scale from a first Hessenberg's 1-norm
            W0 = _compute_W(op, B[:, 0], B, 0.0, p)
            Ks0 = build_subspace(op, W0[:, p], m, iop=iop,
                                 hermitian=hermitian)
            b0norm, opn = runner.read(b0norm, Ks0.H.abs().sum(dim=0).max())
        else:
            (b0norm,), opn = runner.read(b0norm), float(opnorm)
        abstol = tol * max(opn, 1e-300)
        if tau == 0.0:
            tau = min(tend, max(gamma * _initial_tau(abstol, opn, m, b0norm,
                                                     tend), 1e-300))
        S = _State(B, len(ts_sorted), float(tau), tend, abstol, delta, gamma,
                   ts_sorted)
        buckets = {}
        for _ in range(32):                     # bucket-change bound
            bk = buckets.get(m)
            if bk is None:
                bk = buckets[m] = _Bucket(
                    S, op, B, m, p=p, iop=iop, hermitian=bool(hermitian),
                    expm_method=expm_method, max_steps=max_steps,
                    max_rejects=max_rejects, nnz_eff=nnz_eff)
            flags = runner.loop(m, {"sub": bk.sub, "trial": bk.trial},
                                S.flags, _choose, "sub")
            if flags[2] == 0:
                break
            m = _bucket_m(int(flags[2]), n, m_max)
            S.want_m.zero_()

    stats = TimestepStats(steps=int(flags[4]), rejections=int(flags[5]),
                          matvecs=int(flags[6]), final_m=m,
                          final_tau=flags[7], info=int(flags[3]))
    U = S.U
    if stats.info:
        U = torch.where(S.done[None, :], U, math.nan)
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

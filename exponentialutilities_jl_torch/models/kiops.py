"""KIOPS, the Krylov solver with incomplete orthogonalization (PyTorch
port of ``exponentialutilities_jl_tpu/models/kiops.py``).

Gaudreault, Rainwater & Tokman (2018): the phi combination

    w(t_i) = phi_0(t_i A)u_0 + t_i phi_1(t_i A)u_1 + ... + t_i^p phi_p(t_i A)u_p

from one (n+p)-augmented Krylov subspace per substep, with joint (tau, m)
adaptation between substeps. The augmented operator

    A~ = [[A, B~], [0, K]]   (B~ = nu [u_p ... u_1], K the p x p up-shift)

is an ``AugmentedOperator``: one matvec of A (a ``BandedOperator`` runs
kernel B7 on ``x[:n]``, a view), one skinny (n, p)(p,) product and a shift
of the tail. The basis is IOP Arnoldi (window 2 by default); the (j+1)^2
augmented Hessenberg with the phi_1 coupling H[0, j] = 1 is exponentiated
on the device per tau trial. A tau-only rejection reuses the basis; a
rejection that grows m extends it (``arnoldi_extend``) instead of
rebuilding it.

The powers of two nu and mu that scale the augmented columns come from
``math.ldexp``, so nu mu = 1 exactly.

Host reads per substep: one for each new or extended basis (its effective
dimension, breakdown flag, residual and the augmented Hessenberg's 1-norm,
in one transfer) and one per tau trial (the error estimate; the reduced
exponential is told its 1-norm). A snapshot inside a substep ("phantom")
adds the read of its exponential's 1-norm. W stays on the operator's
device.

Over a row-sharded operator (``parallel.shard_operator``) the augmented
vectors are [this rank's rows; the p-entry tail], the tail replicated on
every rank: the augmented operator's ``comm`` (``utils.comm.AugmentedAxis``)
adds the tail to the Arnoldi dots and norms from axis index 0 only, and
sum |u| is a psum, so every rank reads the single-device call's scalars.

``reduced="host"`` evaluates each trial's augmented exponential and each
phantom's exponential with scipy on the host (``ops/host_reduced.py``):
one device-to-host read and one host-to-device write per reduced problem.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.expm import expm_higham2005, expm_taylor
from ..ops.host_reduced import host_expm
from ..ops.krylov import (arnoldi, arnoldi_coeffs, arnoldi_extend,
                          arnoldi_replay, expand_compact_hessenberg)
from ..ops.sparse import hoist_conjugation
from ..utils.comm import AugmentedAxis, operator_comm, psum
from ..utils.device import action_vector
from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import full_precision
from .expv import _reduced_where
from .phiv import _row
from .timestepping import _MAX_NONFINITE_REJECTS

__all__ = ["kiops", "KiopsStats", "AugmentedOperator"]


class AugmentedOperator(LinearOperator):
    """The KIOPS augmented operator on vectors [x; x_aug] of length n+p:
    y = [A x + B x_aug; shift(x_aug)]. Over a sharded ``op``, x is this
    rank's rows (``n_main`` of them) and ``comm`` the augmented axis
    (module doc)."""

    def __init__(self, op: LinearOperator, B, is_hermitian: bool = False):
        self.op = op
        self.B = B              # (n, p): the nu-scaled flipped u columns
        self.is_hermitian = bool(is_hermitian)
        axis = operator_comm(op)
        self.comm = None if axis is None else AugmentedAxis(axis, B.shape[0])

    @property
    def n_main(self) -> int:
        return self.B.shape[0]

    @property
    def p_aug(self) -> int:
        return self.B.shape[1]

    @property
    def shape(self):
        n = self.op.shape[0] + self.p_aug
        return (n, n)

    @property
    def dtype(self):
        return self.B.dtype

    @property
    def device(self):
        return self.B.device

    def matvec(self, x):
        n = self.n_main
        xa = x[n:]
        ym = self.op.matvec(x[:n]) + self.B @ xa
        ya = torch.cat([xa[1:], xa.new_zeros(1)])
        return torch.cat([ym, ya.to(ym.dtype)])


@dataclasses.dataclass
class KiopsStats:
    """(steps, rejections, Krylov steps, exponentials, last m). ``info``:
    0 = success; 2 = persistently non-finite error estimate, the remaining
    outputs NaN and the solve ended."""
    steps: int = 0
    rejections: int = 0
    krylov_steps: int = 0
    exps: int = 0
    last_m: int = 0
    info: int = 0


def _kiops_x0(w_col, t_now, mu: float, p: int):
    """Augmented starting vector: w plus the Taylor-weight tail
    t^i / i! mu (t_now a float, or a 0-d float64 tensor: a loop step's)."""
    tail = [(t_now ** (p - 1 - i)) / math.factorial(p - 1 - i) * mu
            for i in range(p - 1)]
    if isinstance(t_now, torch.Tensor):
        tail = torch.stack(tail + [torch.full_like(t_now, mu)])
        return torch.cat([w_col, tail.to(w_col.dtype)])
    tail = tail + [mu]
    # filled on the device: a tensor made from host values would be a
    # host-to-device copy, which waits for the stream
    return torch.cat([w_col] + [torch.full((1,), v, dtype=w_col.dtype,
                                           device=w_col.device)
                                for v in tail])


def _augmented_columns(op, u, read=float):
    """(u (n, p+1), p, mu, AugmentedOperator): the p = 0 case padded with a
    zero column, and the augmented columns scaled by nu = 2^-e with
    2^e >= sum |u[:, 1:]| (mu = 1 / nu exactly). ``read`` takes sum |u|
    to the host (a loop runner's counted read)."""
    u = action_vector(u, op)
    if u.ndim == 1:
        u = u[:, None]
    ppo = u.shape[1]
    p = ppo - 1
    if p == 0:
        p = 1
        u = torch.cat([u, torch.zeros_like(u)], dim=1)
    norm_u = read(psum(u[:, 1:].abs().sum(), operator_comm(op)))
    if ppo > 1 and norm_u > 0:
        ex = math.ceil(math.log2(norm_u))
        nu, mu = math.ldexp(1.0, -ex), math.ldexp(1.0, ex)
    else:
        nu, mu = 1.0, 1.0
    return u, p, mu, AugmentedOperator(op, u[:, 1:].flip(1) * nu)


def _aug_hessenberg(H, j):
    """The (m+1)^2 augmented Hessenberg of a (m+1, m) H with effective
    dimension j (a 0-d tensor): H[j, j-1] taken out as the residual, the
    phi_1 coupling H[0, j] = 1, everything past row and column j zero.
    Returns (Haug, residual)."""
    m = H.shape[1]
    r = torch.arange(m + 1, device=H.device)
    R, C = r[:, None], r[None, :]
    jm = torch.clamp_min(j - 1, 0)
    Haug = torch.zeros((m + 1, m + 1), dtype=H.dtype, device=H.device)
    Haug[:, :m] = H
    nrm = _row(_row(Haug, j), jm)
    Haug = torch.where((R == j) & (C == jm), 0, Haug)
    Haug = torch.where((R == 0) & (C == j), 1, Haug)
    return torch.where((R <= j) & (C <= j), Haug, 0), nrm


def _phantom_hessenberg(H, j):
    """H in an (m+1)^2 frame, masked to its leading j x j block (no
    coupling)."""
    m = H.shape[1]
    rows = torch.arange(m + 1, device=H.device)
    Hj = torch.zeros((m + 1, m + 1), dtype=H.dtype, device=H.device)
    Hj[:, :m] = H
    block = (rows[:, None] < j) & (rows[None, :] < j)
    return torch.where(block, Hj, 0)


@dataclasses.dataclass
class _Basis:
    """One substep's basis: the full basis ``V`` (basis-storing form) or
    the compact Hessenberg ``Hc`` and start vector ``x0`` (two-pass form),
    with the expanded Hessenberg and the one host read of its scalars."""
    H: torch.Tensor
    beta: torch.Tensor
    m_used: torch.Tensor
    breakdown: torch.Tensor
    Haug: torch.Tensor = None
    j: int = 0
    happy: bool = False
    haug_norm: float = 0.0
    nrm: float = 0.0
    beta_host: float = 0.0
    V: torch.Tensor = None
    Ks: object = None
    Hc: torch.Tensor = None
    x0: torch.Tensor = None
    win: int = 2

    @property
    def m(self) -> int:
        return self.H.shape[1]

    def summarize(self):
        """Haug and the one host read: (j, happy, |Haug|_1, residual,
        beta)."""
        self.Haug, nrm = _aug_hessenberg(self.H, self.m_used)
        rdt = self.Haug.abs().dtype
        vals = torch.stack([
            self.m_used.to(rdt), self.breakdown.to(rdt),
            self.Haug.abs().sum(dim=0).max(), nrm.abs().to(rdt),
            self.beta.to(rdt)]).tolist()
        self.j, self.happy = int(vals[0]), bool(vals[1])
        self.haug_norm, self.nrm, self.beta_host = vals[2:]
        return self


@full_precision
def _kiops_build(aug_op, w_col, t_now, mu, m: int, iop: int, p: int,
                 tol: float, two_pass: bool):
    """The augmented Krylov basis of a substep: the full IOP Arnoldi
    basis, or (two-pass) only its compact Hessenberg."""
    x0 = _kiops_x0(w_col, t_now, mu, p)
    if two_pass:
        win = m if iop == 0 else iop
        Hc, beta0, m_used, broke = arnoldi_coeffs(aug_op, x0, m, win, tol=tol)
        return _Basis(H=expand_compact_hessenberg(Hc, win), beta=beta0,
                      m_used=m_used, breakdown=broke, Hc=Hc, x0=x0,
                      win=win).summarize()
    Ks = arnoldi(aug_op, x0, m, iop=iop, tol=tol, reorth=False)
    return _Basis(H=Ks.H, beta=Ks.beta, m_used=Ks.m_used,
                  breakdown=Ks.breakdown, V=Ks.V, Ks=Ks).summarize()


@full_precision
def _kiops_err(Kb: _Basis, tau_sgn: float, expm_method: str = "higham2005",
               reduced: str = "device"):
    """Reduced-only trial: (coeffs (m+1,), err as a host float); no n-sized
    work."""
    if reduced == "host":
        F = host_expm(tau_sgn * Kb.Haug)
    else:
        engine = expm_taylor if expm_method == "taylor" else expm_higham2005
        F = engine(tau_sgn * Kb.Haug, onenorm=abs(tau_sgn) * Kb.haug_norm)
    err = abs(Kb.beta_host * Kb.nrm * F[max(Kb.j - 1, 0), Kb.j].item())
    return Kb.beta.to(F.dtype) * F[:, 0], err


@full_precision
def _kiops_combine(aug_op, Kb: _Basis, coeffs, n: int):
    """w = sum_i coeffs[i] v_i (n first rows): the stored basis, or one
    replay of the two-pass basis."""
    m = Kb.m
    if Kb.V is not None:
        dt = torch.promote_types(coeffs.dtype, Kb.V.dtype)
        return coeffs.to(dt) @ Kb.V[:, :n].to(dt)
    w_full = arnoldi_replay(aug_op, Kb.x0, coeffs[:m], Kb.Hc, m, Kb.win,
                            final_coeff=coeffs[m], with_final=True)
    return w_full[:n]


@full_precision
def _kiops_phantom(aug_op, Kb: _Basis, tau_sgn: float, n: int,
                   reduced: str = "device"):
    """A snapshot inside an accepted substep: exp of the j^2 block without
    the phi_1 coupling, combined with the basis."""
    Hj = _phantom_hessenberg(Kb.H, Kb.m_used)
    F2 = (host_expm(tau_sgn * Hj) if reduced == "host"
          else expm_higham2005(tau_sgn * Hj))
    rows = torch.arange(Kb.m + 1, device=F2.device)
    col = torch.where(rows < Kb.m_used, F2[:, 0], 0)
    beta = Kb.beta.to(F2.dtype)
    if Kb.V is not None:
        return beta * _kiops_combine(aug_op, Kb, col, n)
    return _kiops_combine(aug_op, Kb, col * beta, n)


def kiops(tstops, A, u, *, tol: float = 1e-7, mmin: int = 10,
          mmax: int = 128, m: int | None = None, iop: int = 2,
          task1: bool = False, return_stats: bool = True,
          reduced: str | None = None, two_pass: bool = False):
    """KIOPS: the phi combination at the output times ``tstops``.

    tstops: scalar or 1-D increasing array of output times.
    A: operator (n, n). u: (n, p+1); column j multiplies phi_j.
    tol: tolerance. mmin/mmax: Krylov size bounds. m: initial size
      (default mmin). iop: incomplete-orthogonalization window (2).
    task1: divide w(t_i) by t_i^p.
    two_pass: keep only the compact Hessenberg per substep (O(n) memory)
      and replay the basis once per accepted substep.

    Returns (W, stats) with W (n, len(tstops)) (or (n,) for a scalar
    tstop) on the operator's device and stats a ``KiopsStats`` (only W
    with ``return_stats=False``).
    """
    reduced = _reduced_where(reduced)
    op = aslinearoperator(A)
    op, u, post = hoist_conjugation(op, action_vector(u, op))
    if post is not None:
        # sorted-conjugated container: the whole solve runs in the sorted
        # basis (every phi_k commutes with the conjugation)
        out = kiops(tstops, op, u, tol=tol, mmin=mmin, mmax=mmax, m=m,
                    iop=iop, task1=task1, return_stats=return_stats,
                    reduced=reduced, two_pass=two_pass)
        if return_stats:
            return post(out[0]), out[1]
        return post(out)
    scalar_t = np.ndim(tstops) == 0
    tau_out = np.atleast_1d(np.asarray(tstops, dtype=np.float64))
    u, p, mu, aug = _augmented_columns(op, u)
    n = u.shape[0]

    m = mmin if m is None else max(mmin, min(m, mmax))
    stats = KiopsStats()

    sgn = float(np.sign(tau_out[-1])) or 1.0
    tau_now = 0.0
    tau_end = float(abs(tau_out[-1]))
    num_steps = len(tau_out)

    W = torch.zeros((n, num_steps), dtype=u.dtype, device=u.device)
    W[:, 0] = u[:, 0]
    w_cur = u[:, 0]

    tau = tau_end
    if tau_end > 1:
        gamma, gamma_mmax = 0.2, 0.1
    else:
        gamma, gamma_mmax = 0.9, 0.6
    delta = 1.4

    oldm, oldtau, omega = -1, math.nan, math.nan
    orderold, kestold = True, True
    order, kest = 0.0, 2.0
    ireject = 0
    nonfinite = 0
    l = 0                     # current snapshot index
    Kb = None

    while tau_now < tau_end:
        if Kb is None:
            # tau_now is unsigned here; the sign enters only through the
            # exponentials
            Kb = _kiops_build(aug, w_cur, tau_now, mu, m, iop, p, tol,
                              two_pass)
            stats.krylov_steps += Kb.j
        j, happy = Kb.j, Kb.happy

        # trials are reduced work only: the n-sized combination or replay
        # runs once per accepted substep
        coeffs, err = _kiops_err(Kb, sgn * tau, reduced=reduced)
        stats.exps += 1

        if happy:
            omega = 0.0
            tau_new = min(tau_end - (tau_now + tau), tau)
            m_new = m
        elif not math.isfinite(err):
            # a non-finite estimate rejects: shrink tau hard, a bounded
            # number of times
            nonfinite += 1
            if nonfinite > _MAX_NONFINITE_REJECTS:
                stats.info = 2
                stats.rejections += ireject + 1
                W[:, l:] = math.nan
                break
            oldomega = omega
            omega = math.inf
            tau_new = min(tau_end - tau_now, tau / 5)
            m_new = m
        else:
            nonfinite = 0
            oldomega = omega
            omega = tau_end * err / (tau * tol) if tau > 0 else math.inf

            # order and kappa estimates, guarded against a non-finite
            # previous omega
            if (m == oldm and tau != oldtau and ireject >= 1
                    and math.isfinite(oldomega) and oldomega > 0):
                order = max(1.0, math.log(omega / oldomega)
                            / math.log(tau / oldtau))
                orderold = False
            elif orderold or ireject == 0:
                orderold = True
                order = j / 4
            else:
                orderold = True
            if (m != oldm and tau == oldtau and ireject >= 1
                    and math.isfinite(oldomega) and oldomega > 0):
                kest = max(1.1, (omega / oldomega) ** (1 / (oldm - m)))
                kestold = False
            elif kestold or ireject == 0:
                kestold = True
                kest = 2.0
            else:
                kestold = True

            remaining = (tau_end - tau_now if omega > delta
                         else tau_end - (tau_now + tau))
            same_tau = min(remaining, tau)
            order_eff = max(order, 1e-2)
            tau_opt = (tau * (gamma / omega) ** (1 / order_eff) if omega > 0
                       else remaining)
            tau_opt = min(remaining, max(tau / 5, min(5 * tau, tau_opt)))
            m_opt = int(math.ceil(j + math.log(max(omega / gamma, 1e-16))
                                  / math.log(kest)))
            m_opt = max(mmin, min(mmax, max((3 * m) // 4,
                                            min(m_opt,
                                                int(math.ceil(4 * m / 3))))))

            if j == mmax:
                if omega > delta:
                    m_new = j
                    tau_new = tau * (gamma_mmax / omega) ** (1 / order_eff)
                    tau_new = min(tau_end - tau_now, max(tau / 5, tau_new))
                else:
                    tau_new = tau_opt
                    m_new = m
            else:
                m_new = m_opt
                tau_new = same_tau

        if omega <= delta:
            # accept
            stats.rejections += ireject
            stats.steps += 1
            next_t = tau_now + tau
            # snapshots strictly inside (tau_now, next_t)
            while l < num_steps - 1 and abs(tau_out[l]) < abs(next_t):
                tau_phantom = abs(tau_out[l]) - tau_now
                W[:, l] = _kiops_phantom(aug, Kb, sgn * tau_phantom, n,
                                         reduced)
                l += 1
            W[:, l] = _kiops_combine(aug, Kb, coeffs, n)
            w_cur = W[:, l]
            tau_now += tau
            ireject = 0
            nonfinite = 0
            Kb = None                  # a new starting vector next substep
        else:
            ireject += 1

        oldtau, tau = tau, tau_new
        oldm = m
        m = m_new
        if m != oldm and Kb is not None:
            if m > oldm and not two_pass and not Kb.happy:
                # resume: keep the built columns and extend to the larger m
                Ks = arnoldi_extend(aug, Kb.Ks, m, iop=iop, tol=tol,
                                    reorth=False)
                Kb = _Basis(H=Ks.H, beta=Ks.beta, m_used=Ks.m_used,
                            breakdown=Ks.breakdown, V=Ks.V,
                            Ks=Ks).summarize()
                stats.krylov_steps += m - oldm
            else:
                Kb = None              # shrink or breakdown: rebuild

    if task1:
        for i in range(num_steps):
            if tau_out[i] != 0:
                W[:, i] = W[:, i] * (1.0 / tau_out[i]) ** p

    stats.last_m = m
    out = W[:, 0] if scalar_t else W
    return (out, stats) if return_stats else out

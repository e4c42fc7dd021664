"""Exponential time integrators on the port's phi machinery (PyTorch port
of ``exponentialutilities_jl_tpu/models/integrators.py``).

Adaptive exponential Rosenbrock methods ``exprb32`` and ``exprb43``
(Hochbruck & Ostermann, Acta Numerica 2010) for stiff u' = f(u), and the
fixed-step ``etdrk4`` (Cox & Matthews 2002, phi form) for semilinear
u' = L u + N(u). Every phi action is one ``kiops`` call, one augmented
Krylov subspace per combination sum_k h^k phi_k(hJ) b_k. The Jacobian
defaults to the matrix-free ``JacobianOperator`` (one ``torch.func.jvp``
per Krylov matvec).

With J = f'(u_n) and g(v) = f(v) - J v, the stages combine phi actions of
the stage differences D_i = g(U_i) - g(u_n):

  exprb32 (order 3, embedded 2):
    U_2 = u + h phi_1(hJ) F_1
    u+  = U_2 + 2h phi_3(hJ) D_2,     err = |2h phi_3(hJ) D_2|
  exprb43 (order 4, embedded 3):
    U_2 = u + (h/2) phi_1(hJ/2) F_1,  U_3 = u + h phi_1(hJ) F_1
    u+  = u + h[phi_1 F_1 + phi_3 (16 D_2 - 2 D_3) + phi_4 (-48 D_2 + 12 D_3)]
    err = h |phi_4 (-48 D_2 + 12 D_3)|

The host drivers read the state once per attempt (finiteness and the
WRMS error norm in one transfer) besides kiops' own reads.

The ``*_device`` forms are the JAX package's whole-integration programs
(one ``lax.scan`` for the fixed-step forms, one ``lax.while_loop`` per
Krylov bucket for the adaptive controller) with the same control flow
and arithmetic: a fixed Krylov size m, each phi combination one fixed-m
augmented Arnoldi basis (``_phi_comb_device``) and a solver-free reduced
exponential (``expm_taylor_masked``). A step of the scan, or an attempt
of the adaptive loop with the controller's decision (every write
masked), runs through ``utils/graphs.LoopRunner``: on a CUDA device from
one CUDA graph (per m bucket), on the CPU and with ``comm`` eagerly. The
fixed-step forms (``etdrk4_device``, ``exprb43_device(adaptive=False)``)
make one host read, at the end (the finiteness check); the adaptive loop
one as each bucket's (or snapshot segment's) loop ends, its flags read
one attempt behind the device in between. It moves to the next bucket of
``_EXPRB_M_LADDER`` when a phi combination breaches its tolerance, so its
steps and rejections are those of the JAX device loop. A user ``f`` or
``N`` is called inside the captured step and must not read the device.

Sharded state. An integrator that takes only ``f`` and ``u0`` takes
``comm=`` (a ``parallel.MeshAxis``; the counterpart of the JAX package's
row-sharded ``u0``): u0 is then this rank's rows, f maps this rank's rows
to this rank's rows (through an operator of ``parallel.shard_operator``),
the Jacobians carry ``comm``, and the WRMS norm, sum |b| of the augmented
scaling and the finiteness checks reduce over the axis, so every rank
takes the single-device call's steps and rejections. ``etdrk4`` and
``etdrk4_device`` read ``comm`` from L.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.expm import _onenorm, _pow2, expm_higham2005, expm_taylor_masked
from ..utils.comm import all_finite, operator_comm, psum
from ..utils.device import action_vector, host_tensor
from ..utils.graphs import LoopRunner, masked_copy
from ..utils.linop import JacobianOperator, LinearOperator, aslinearoperator
from ..utils.precision import full_precision
from .expv import build_subspace
from .kiops import AugmentedOperator, _aug_hessenberg, kiops
from .phiv import _row

__all__ = ["exprb32", "exprb43", "etdrk4", "ExpIntStats",
           "etdrk4_device", "exprb43_device", "exprb32_device"]


@dataclasses.dataclass
class ExpIntStats:
    """Accepted/rejected step counts and phi-action tallies."""

    steps: int = 0
    rejected: int = 0
    n_f_evals: int = 0
    n_kiops: int = 0
    info: int = 0          # 0 ok; 1 dt underflow; 2 max_steps hit;
                           # 3 non-finite state in fixed-step mode
    final_m: int = 0       # device drivers: Krylov bucket at exit


def _real_dtype(u):
    return u.real.dtype if u.is_complex() else u.dtype


def _phi_comb(J, bs, h, *, tol, kw):
    """w = sum_k h^k phi_k(hJ) b_k by one kiops call (b_0 included)."""
    w, _ = kiops(float(h), J, torch.stack(bs, dim=1), tol=tol, **kw)
    return w


def _wrms_tensor(err_vec, u, u_new, rtol, atol, comm=None):
    """Per-component weighted RMS error norm (OrdinaryDiffEq /
    Hairer-Wanner), a 0-d tensor: sqrt(mean((err_i / (atol_i + rtol
    max(|u_i|, |u_new_i|)))^2)); a zero scale (atol = 0 and a component
    zero in both states) gives 0 for a zero error and inf otherwise,
    never 0/0. With ``comm`` the mean is over every rank's rows (a psum
    of the local sums over the global n)."""
    sc = atol + rtol * torch.maximum(u.abs(), u_new.abs())
    ratio = err_vec / torch.clamp_min(sc, torch.finfo(sc.dtype).tiny)
    if comm is None:
        return torch.sqrt(torch.mean(ratio.abs() ** 2))
    # the layer splits rows evenly: n = n_local P
    return torch.sqrt(comm.psum((ratio.abs() ** 2).sum())
                      / (ratio.shape[0] * comm.axis_size()))


def _atol(atol, u):
    """atol as a tensor on u's device in u's real dtype: a scalar or one
    value per component."""
    rdt = _real_dtype(u)
    a = (atol.to(device=u.device, dtype=rdt) if isinstance(atol, torch.Tensor)
         else torch.as_tensor(np.asarray(atol), dtype=rdt).to(u.device))
    if a.ndim not in (0, 1) or (a.ndim == 1 and a.shape != u.shape):
        raise ValueError("atol must be a scalar or match u0's shape")
    return a


def _controller(dt, enorm, order, *, enorm_prev=None, safety=0.9,
                fmin=0.2, fmax=5.0):
    """Step-size factor: PI (Gustafsson) control when the previous
    accepted step's error is known,
        dt safety enorm^(-0.7/k) enorm_prev^(0.4/k),
    else (first step, after a rejection) I control, dt safety enorm^(-1/k)."""
    if enorm <= 0:
        return dt * fmax
    if enorm_prev is not None and enorm_prev > 0:
        fac = safety * enorm ** (-0.7 / order) * enorm_prev ** (0.4 / order)
    else:
        fac = safety * enorm ** (-1.0 / order)
    return dt * min(fmax, max(fmin, fac))


def _run_rosenbrock(step_fn, order, f, u0, t_span, *, jac, dt0, rtol, atol,
                    max_steps, return_trajectory, phi_tol, kiops_kwargs,
                    adaptive=True, controller="pi", device=None, comm=None):
    t0, tf = float(t_span[0]), float(t_span[1])
    if tf <= t0:
        raise ValueError("t_span must satisfy tf > t0")
    if not adaptive and not dt0:
        raise ValueError("adaptive=False requires dt0")
    if controller not in ("pi", "i"):
        raise ValueError(f"controller must be 'pi' or 'i', got {controller!r}")
    u = host_tensor(u0, device)
    atol_t = _atol(atol, u)
    stats = ExpIntStats()
    make_jac = (jac if jac is not None
                else (lambda uu: JacobianOperator(f, uu, comm=comm)))
    dt = float(dt0) if dt0 else (tf - t0) / 100
    t = t0
    ts, us = [t0], [u]
    dt_floor = 1e-12 * (tf - t0)
    enorm_prev = None                    # the last accepted step's norm
    while t < tf - 1e-14 * (tf - t0):
        if stats.steps + stats.rejected >= max_steps:
            stats.info = 2
            break
        dt = min(dt, tf - t)
        J = make_jac(u)
        if not isinstance(J, LinearOperator):
            J = aslinearoperator(J)
        u_new, err_vec, nf, nk = step_fn(f, J, u, dt, phi_tol, kiops_kwargs)
        stats.n_f_evals += nf
        stats.n_kiops += nk
        finite, enorm = torch.stack([
            all_finite(u_new, comm).to(atol_t.dtype),
            _wrms_tensor(err_vec, u, u_new, rtol, atol_t, comm)]).tolist()
        if not finite:
            enorm = math.inf
        if not adaptive:
            if not math.isfinite(enorm):
                # no controller ran: fixed-step divergence (info 3)
                stats.info = 3
                break
            t += dt
            u = u_new
            stats.steps += 1
            if return_trajectory:
                ts.append(t)
                us.append(u)
            continue
        if enorm <= 1.0:
            t += dt
            u = u_new
            stats.steps += 1
            if return_trajectory:
                ts.append(t)
                us.append(u)
            dt = _controller(dt, enorm, order,
                             enorm_prev=(enorm_prev if controller == "pi"
                                         else None))
            enorm_prev = enorm if enorm > 0 else None
        else:
            stats.rejected += 1
            # a rejection: I control, and the PI memory resets
            dt = _controller(dt, enorm if math.isfinite(enorm) else 100.0,
                             order)
            enorm_prev = None
        if dt < dt_floor:
            stats.info = 1
            break
    if stats.info:
        # no-silent-failure protocol: a truncated integration never
        # passes as a solution
        reason = {1: "step size underflow",
                  2: f"max_steps={max_steps} exceeded",
                  3: "non-finite state at fixed dt - reduce dt0"
                  }[stats.info]
        raise FloatingPointError(
            f"exponential integrator stopped at t={t:.6g} < tf={tf:.6g}: "
            f"{reason} (u finite: {bool(all_finite(u, comm))}; "
            "loosen tolerances, raise max_steps, or check f/Jacobian)")
    if return_trajectory:
        return np.asarray(ts), torch.stack(us, dim=0), stats
    return u, stats


def _step_exprb32(f, J, u, h, tol, kw):
    # kiops applies phi_0 = e^{hJ} to column 0: the state rides b_0 and
    # g_n = f(u) - J u rides b_1 (e^{hJ} u + h phi_1(hJ) g_n = u + h
    # phi_1(hJ) f(u) exactly)
    F1 = f(u)
    gn = F1 - J.matvec(u)
    zero = torch.zeros_like(u)
    U2 = _phi_comb(J, [u, gn], h, tol=tol, kw=kw)
    D2 = f(U2) - J.matvec(U2) - gn            # g(U_2) - g(u_n)
    b3 = (2.0 / h ** 2) * D2
    u_new = _phi_comb(J, [u, gn, zero, b3], h, tol=tol, kw=kw)
    return u_new, u_new - U2, 2, 2


def _step_exprb43(f, J, u, h, tol, kw):
    F1 = f(u)
    gn = F1 - J.matvec(u)
    zero = torch.zeros_like(u)
    # U_2 (at h/2) and U_3 (at h) from one augmented subspace
    W, _ = kiops([h / 2, float(h)], J, torch.stack([u, gn], dim=1), tol=tol,
                 **kw)
    U2, U3 = W[:, 0], W[:, 1]
    D2 = f(U2) - J.matvec(U2) - gn
    D3 = f(U3) - J.matvec(U3) - gn
    b3 = (16.0 * D2 - 2.0 * D3) / h ** 2
    b4 = (-48.0 * D2 + 12.0 * D3) / h ** 3
    u_new = _phi_comb(J, [u, gn, zero, b3, b4], h, tol=tol, kw=kw)
    u_emb = _phi_comb(J, [u, gn, zero, b3], h, tol=tol, kw=kw)
    return u_new, u_new - u_emb, 3, 3


@full_precision
def exprb32(f, u0, t_span, *, jac=None, dt0=None, rtol=1e-6, atol=1e-9,
            max_steps=100_000, return_trajectory=False, phi_tol=None,
            adaptive=True, controller="pi", device=None, comm=None,
            **kiops_kwargs):
    """Adaptive 3(2) exponential Rosenbrock for stiff u' = f(u).

    f: u -> f(u) in torch operations (forward-mode differentiable when
      ``jac`` is None).
    u0: initial state (n,); host data goes to ``device`` (default the
      default device).
    t_span: (t0, tf).
    jac: u -> LinearOperator or matrix; default the matrix-free
      ``JacobianOperator(f, u)``.
    dt0: initial step (default (tf - t0)/100).
    rtol/atol: per-component WRMS control; atol a scalar or (n,).
    phi_tol: tolerance of the inner kiops calls (default
      min(rtol, 1e-7)/10).
    adaptive: False runs fixed steps of dt0.
    controller: "pi" (default) or "i".
    comm: the ``parallel.MeshAxis`` that u's rows are sharded over (module
      doc), or None.
    kiops_kwargs: forwarded to kiops (mmin, mmax, iop, two_pass, ...).

    Returns (u_final, ExpIntStats), or (ts, us, stats) with
    ``return_trajectory=True``; raises FloatingPointError on step-size
    underflow or an exhausted step budget.
    """
    phi_tol = phi_tol if phi_tol is not None else min(rtol, 1e-7) / 10
    kiops_kwargs["return_stats"] = True       # the steps unpack (W, stats)
    return _run_rosenbrock(_step_exprb32, 3, f, u0, t_span, jac=jac,
                           dt0=dt0, rtol=rtol, atol=atol,
                           max_steps=max_steps, adaptive=adaptive,
                           return_trajectory=return_trajectory,
                           phi_tol=phi_tol, kiops_kwargs=kiops_kwargs,
                           controller=controller, device=device, comm=comm)


@full_precision
def exprb43(f, u0, t_span, *, jac=None, dt0=None, rtol=1e-8, atol=1e-11,
            max_steps=100_000, return_trajectory=False, phi_tol=None,
            adaptive=True, controller="pi", device=None, comm=None,
            **kiops_kwargs):
    """Adaptive 4(3) exponential Rosenbrock (see ``exprb32``)."""
    phi_tol = phi_tol if phi_tol is not None else min(rtol, 1e-7) / 10
    kiops_kwargs["return_stats"] = True
    return _run_rosenbrock(_step_exprb43, 4, f, u0, t_span, jac=jac,
                           dt0=dt0, rtol=rtol, atol=atol,
                           max_steps=max_steps, adaptive=adaptive,
                           return_trajectory=return_trajectory,
                           phi_tol=phi_tol, kiops_kwargs=kiops_kwargs,
                           controller=controller, device=device, comm=comm)


def _fixed_steps(t_span, dt) -> int:
    t0, tf = float(t_span[0]), float(t_span[1])
    h = float(dt)
    if h <= 0 or tf <= t0:
        raise ValueError("need dt > 0 and tf > t0")
    nsteps = int(round((tf - t0) / h))
    if abs(nsteps * h - (tf - t0)) > 1e-9 * (tf - t0):
        raise ValueError("dt must divide tf - t0 (fixed-step method)")
    return nsteps


@full_precision
def etdrk4(L, N, u0, t_span, dt, *, phi_tol=1e-9, return_trajectory=False,
           **kiops_kwargs):
    """Fixed-step ETDRK4 (Cox-Matthews 2002) for u' = L u + N(u): L a fixed
    linear operator (any container), N a torch nonlinearity. Stages in
    phi form, each one kiops call:

      a = u + (h/2) phi_1(hL/2)[L u + N(u)]
      b = u + (h/2) phi_1(hL/2)[L u + N(a)]
      c = a + (h/2) phi_1(hL/2)[L a + 2N(b) - N(u)]
      u+ = u + h[phi_1(hL)(Lu + N_1) + phi_2(hL)(-3N_1 + 2N_a + 2N_b - N_c)
                 + phi_3(hL)(4N_1 - 4N_a - 4N_b + 4N_c)]

    u0's host data goes to L's device; over a sharded L (module doc) u0 is
    this rank's rows. Returns (u_final, ExpIntStats) (or the trajectory);
    a non-finite state raises."""
    t0 = float(t_span[0])
    h = float(dt)
    nsteps = _fixed_steps(t_span, dt)
    op = aslinearoperator(L)
    comm = operator_comm(op)
    kiops_kwargs["return_stats"] = True
    u = action_vector(u0, op)
    stats = ExpIntStats()
    ts, us = [t0], [u]

    def phi1_half(v0, v1):
        W, _ = kiops(h / 2, op, torch.stack([v0, v1], dim=1), tol=phi_tol,
                     **kiops_kwargs)
        return W

    for k in range(nsteps):
        # kiops applies phi_0 = e^{tau L} to column 0: the stage states
        # ride b_0, the nonlinear terms b_1..b_3
        try:
            N1 = N(u)
            a = phi1_half(u, N1)
            Na = N(a)
            b = phi1_half(u, Na)
            Nb = N(b)
            c = phi1_half(a, 2.0 * Nb - N1)
            Nc = N(c)
            b2 = (-3.0 * N1 + 2.0 * Na + 2.0 * Nb - Nc) / h
            b3 = (4.0 * N1 - 4.0 * Na - 4.0 * Nb + 4.0 * Nc) / h ** 2
            W, _ = kiops(h, op, torch.stack([u, N1, b2, b3], dim=1),
                         tol=phi_tol, **kiops_kwargs)
        except (OverflowError, FloatingPointError) as e:
            raise FloatingPointError(
                f"etdrk4: stage overflow at step {k + 1} "
                f"(t={t0 + k * h:.6g}) - reduce dt or check L/N") from e
        u = W
        stats.steps += 1
        stats.n_f_evals += 4
        stats.n_kiops += 4
        if not bool(all_finite(u, comm)):
            raise FloatingPointError(
                f"etdrk4: non-finite state at step {k + 1} "
                f"(t={t0 + (k + 1) * h:.6g}) - reduce dt or check L/N")
        if return_trajectory:
            ts.append(t0 + (k + 1) * h)
            us.append(u)
    if return_trajectory:
        return np.asarray(ts), torch.stack(us, dim=0), stats
    return u, stats


# ---------------------------------------------------------------------------
# The device forms: fixed Krylov size m, solver-free reduced exponentials.
# ---------------------------------------------------------------------------


def _phi_comb_device(op, B, taus, m: int, iop: int, expm_method: str,
                     with_err: bool = False):
    """[sum_k tau^k phi_k(tau op) b_k for tau in taus] from one fixed-m
    augmented Arnoldi basis, with no host read (kiops' single-substep
    core without its adaptivity). B is (n, p+1) with p >= 1. With
    ``with_err`` also each action's kiops error estimate
    |beta h_{j+1,j} F[j-1, j]| (0-d tensors)."""
    n, ppo = B.shape
    p = ppo - 1
    dt = B.dtype
    rdt = _real_dtype(torch.empty((), dtype=torch.promote_types(
        dt, torch.float32)))
    # nu = 2^-e, mu = 2^e with 2^e >= sum |b_1..b_p|, exact inverses
    norm_u = psum(B[:, 1:].abs().sum(), operator_comm(op)).to(rdt)
    pos = norm_u > 0
    ex = torch.ceil(torch.log2(torch.clamp_min(norm_u,
                                               torch.finfo(rdt).tiny)))
    nu = torch.where(pos, _pow2(-ex, rdt), 1.0).to(dt)
    mu = torch.where(pos, _pow2(ex, rdt), 1.0)
    aug = AugmentedOperator(op, B[:, 1:].flip(1) * nu)
    # the augmented start at t = 0: [b_0; 0 ... 0; mu]
    x0 = torch.cat([B[:, 0], torch.zeros(p - 1, dtype=dt, device=B.device),
                    mu.to(dt).reshape(1)])
    Ks = build_subspace(aug, x0, m, iop=iop, hermitian=False)
    Haug, nrm = _aug_hessenberg(Ks.H, Ks.m_used)
    jm = torch.clamp_min(Ks.m_used - 1, 0)
    outs, errs = [], []
    for tau in taus:
        A = tau * Haug
        if expm_method == "taylor":
            F = expm_taylor_masked(A)
        else:
            F = expm_higham2005(A, onenorm=_onenorm(A))
        coeffs = Ks.beta.to(F.dtype) * F[:, 0]
        outs.append((coeffs.to(Ks.V.dtype) @ Ks.V[:, :n]).to(dt))
        if with_err:
            errs.append((Ks.beta * nrm * _row(_row(F, jm), Ks.m_used)).abs()
                        .to(rdt))
    return (outs, errs) if with_err else outs


def _fname(fn) -> str:
    return getattr(fn, "__qualname__", None) or repr(fn)


def _check_final(u, what: str, comm, runner: LoopRunner):
    """The fixed-step forms' one host read: the final state's
    finiteness."""
    if not runner.read(all_finite(u, comm))[0]:
        raise FloatingPointError(
            f"{what}: non-finite final state - raise m, reduce dt, or "
            "validate against the adaptive etdrk4/exprb drivers")
    return u


def _repeat(step, u, nsteps: int, m: int, what: str, runner):
    """Run ``step`` nsteps times through ``runner`` (a runner of its own
    when None)."""
    if runner is not None:
        runner.repeat(m, "step", step, nsteps)
        return
    with LoopRunner(what, u.device) as own:
        own.repeat(m, "step", step, nsteps)


def _etdrk4_scan(L, u, h: float, *, N, nsteps: int, m: int, iop: int,
                 expm_method: str, runner: LoopRunner | None = None):
    """nsteps ETDRK4 steps at a fixed m: one step over the state tensor,
    run ``nsteps`` times by the runner (a CUDA graph's replays), no host
    read."""
    u = u.clone()

    @full_precision
    def step():
        N1 = N(u)
        (a,) = _phi_comb_device(L, torch.stack([u, N1], 1), [h / 2], m, iop,
                                expm_method)
        Na = N(a)
        (b,) = _phi_comb_device(L, torch.stack([u, Na], 1), [h / 2], m, iop,
                                expm_method)
        Nb = N(b)
        (c,) = _phi_comb_device(L, torch.stack([a, 2.0 * Nb - N1], 1),
                                [h / 2], m, iop, expm_method)
        Nc = N(c)
        b2 = (-3.0 * N1 + 2.0 * Na + 2.0 * Nb - Nc) / h
        b3 = (4.0 * N1 - 4.0 * Na - 4.0 * Nb + 4.0 * Nc) / h ** 2
        (u_new,) = _phi_comb_device(L, torch.stack([u, N1, b2, b3], 1), [h],
                                    m, iop, expm_method)
        u.copy_(u_new)

    _repeat(step, u, nsteps, m, f"etdrk4_device (N={_fname(N)})", runner)
    return u


def etdrk4_device(L, N, u0, t_span, dt, *, m: int = 20, iop: int = 2,
                  expm_method: str = "taylor"):
    """ETDRK4 at a fixed step and a fixed Krylov size m (the JAX package's
    one-program form): each stage one fixed-m augmented phi combination,
    reduced exponentials by the solver-free masked Taylor engine. On a
    CUDA device one step is captured into a CUDA graph and replayed, so
    ``N`` must not read the device (no ``.item()``, ``float()``,
    ``bool()`` of a tensor, no data-dependent shapes): the capture raises
    naming it otherwise. On the CPU and over a sharded L the step runs
    eagerly. Validate m once against ``etdrk4``, then serve. Raises
    FloatingPointError on a non-finite final state (the one host read)."""
    nsteps = _fixed_steps(t_span, dt)
    op = aslinearoperator(L)
    comm = operator_comm(op)
    u0 = action_vector(u0, op)
    with LoopRunner(f"etdrk4_device (N={_fname(N)})", u0.device,
                    sharded=comm is not None) as runner:
        u = _etdrk4_scan(op, u0, float(dt), N=N, nsteps=nsteps, m=m,
                         iop=iop, expm_method=expm_method, runner=runner)
        return _check_final(u, "etdrk4_device", comm, runner)


def _exprb43_scan(u, h: float, *, f, nsteps: int, m: int, iop: int,
                  expm_method: str, runner: LoopRunner | None = None,
                  comm=None):
    """nsteps fixed exprb43 steps at a fixed m: one step over the state
    tensor, run ``nsteps`` times by the runner, no host read."""
    u = u.clone()
    zero = torch.zeros_like(u)

    @full_precision
    def step():
        J = JacobianOperator(f, u, comm=comm)
        F1 = f(u)
        gn = F1 - J.matvec(u)
        U2, U3 = _phi_comb_device(J, torch.stack([u, gn, zero], 1),
                                  [h / 2, h], m, iop, expm_method)
        D2 = f(U2) - J.matvec(U2) - gn
        D3 = f(U3) - J.matvec(U3) - gn
        b3 = (16.0 * D2 - 2.0 * D3) / h ** 2
        b4 = (-48.0 * D2 + 12.0 * D3) / h ** 3
        (u_new,) = _phi_comb_device(J, torch.stack([u, gn, zero, b3, b4], 1),
                                    [h], m, iop, expm_method)
        u.copy_(u_new)

    _repeat(step, u, nsteps, m, f"exprb43_device (f={_fname(f)})", runner)
    return u


def exprb43_device(f, u0, t_span, dt=None, *, adaptive=None, m: int = 20,
                   iop: int = 2, expm_method: str = "taylor",
                   m_max: int = 128, rtol=1e-8, atol=1e-11, phi_tol=None,
                   controller: str = "pi", max_steps: int = 100_000,
                   return_stats: bool = False, snapshots=None, device=None,
                   comm=None):
    """exprb43 in the JAX package's device form (module doc).

    adaptive=False (the default when ``dt`` is given): fixed steps of dt
      at a fixed m, no host read inside a step; dt must divide the span.
    adaptive=True (the default when ``dt`` is None): the WRMS / PI
      controller with the Jacobian re-linearized per attempt, each phi
      combination checked against kiops' error estimate; a breach moves
      to the next m bucket with the state kept. ``dt`` seeds the first
      step.
    snapshots (adaptive only): strictly increasing times in (t0, tf]
      ending at tf, each a forced step endpoint; returns the (n, nt)
      states at those times.

    On a CUDA device a step (fixed) or an attempt (adaptive, one graph per
    m bucket) is captured into a CUDA graph and replayed, so ``f`` must
    not read the device (no ``.item()``, ``float()``, ``bool()`` of a
    tensor, no data-dependent shapes): the capture raises naming it
    otherwise. On the CPU and with ``comm`` the steps run eagerly.

    comm: u's rows are sharded over this ``parallel.MeshAxis`` (module
      doc).

    Returns u, or (u, ExpIntStats) with ``return_stats``. u0's host data
    goes to ``device``."""
    if adaptive is None:
        adaptive = dt is None
    if adaptive:
        return _run_exprb_device(
            "exprb43", f, u0, t_span, dt, m=m, m_max=m_max, iop=iop,
            expm_method=expm_method, rtol=rtol, atol=atol,
            phi_tol=phi_tol, controller=controller, max_steps=max_steps,
            return_stats=return_stats, adaptive=True, snapshots=snapshots,
            device=device, comm=comm)
    if snapshots is not None:
        raise ValueError(
            "snapshots requires adaptive=True in exprb43_device (the "
            "fixed-step mode runs as one scan; use exprb32_device for "
            "fixed-step snapshots, or slice the span)")
    if dt is None:
        raise ValueError("adaptive=False requires dt")
    nsteps = _fixed_steps(t_span, dt)
    u0 = host_tensor(u0, device)
    with LoopRunner(f"exprb43_device (f={_fname(f)})", u0.device,
                    sharded=comm is not None) as runner:
        u = _exprb43_scan(u0, float(dt), f=f, nsteps=nsteps, m=m, iop=iop,
                          expm_method=expm_method, runner=runner, comm=comm)
        _check_final(u, "exprb43_device", comm, runner)
    if return_stats:
        return u, ExpIntStats(steps=nsteps, n_f_evals=3 * nsteps,
                              n_kiops=3 * nsteps, final_m=m)
    return u


_EXPRB_M_LADDER = (6, 8, 10, 13, 17, 22, 29, 38, 49, 64, 83, 108, 128)


def _next_bucket(m, m_max):
    for b in _EXPRB_M_LADDER:
        if b > m:
            return min(b, m_max)
    return m_max


_F64 = torch.float64
_I64 = torch.int64


class _LoopState:
    """The device loop's carry: the state, the controller's memory, the
    counters and the segment's end, as device tensors (0-d but u)."""

    def __init__(self, u, t0: float, dt: float):
        dev = u.device

        def f64(v):
            return torch.full((), v, dtype=_F64, device=dev)

        def i64():
            return torch.zeros((), dtype=_I64, device=dev)

        self.u = u.clone()
        self.t, self.dt, self.eprev, self.tf = f64(t0), f64(dt), f64(-1.0), \
            f64(t0)
        self.steps, self.rejected, self.nk = i64(), i64(), i64()
        self.want_m, self.info = i64(), i64()
        self.five = f64(5.0)
        # [active, want_m, info, t, steps, rejected, nk]
        self.flags = torch.zeros(7, dtype=_F64, device=dev)


def _exprb_attempt(st: _LoopState, f, scheme: str, m: int, iop: int,
                   expm_method: str, rtol, atol, comm=None):
    """One attempt's arithmetic: (u_new, dt, finite, enorm, eps_phi,
    nk_step), the scalars 0-d tensors (with ``comm`` the finiteness and
    the WRMS norm are reduced over the axis; the phi errors come from
    replicated reduced scalars)."""
    u = st.u
    dt = torch.minimum(st.dt, st.tf - st.t)
    zero = torch.zeros_like(u)
    J = JacobianOperator(f, u, comm=comm)
    F1 = f(u)
    gn = F1 - J.matvec(u)
    if scheme == "exprb43":
        (U2, U3), (e1, e2) = _phi_comb_device(
            J, torch.stack([u, gn, zero], 1), [dt / 2, dt], m, iop,
            expm_method, with_err=True)
        D2 = f(U2) - J.matvec(U2) - gn
        D3 = f(U3) - J.matvec(U3) - gn
        b3 = (16.0 * D2 - 2.0 * D3) / dt ** 2
        b4 = (-48.0 * D2 + 12.0 * D3) / dt ** 3
        (u_new,), (e3,) = _phi_comb_device(
            J, torch.stack([u, gn, zero, b3, b4], 1), [dt], m, iop,
            expm_method, with_err=True)
        (u_emb,), (e4,) = _phi_comb_device(
            J, torch.stack([u, gn, zero, b3], 1), [dt], m, iop, expm_method,
            with_err=True)
        err_vec = u_new - u_emb
        errs, nk_step = (e1, e2, e3, e4), 3
    else:
        (U2,), (e1,) = _phi_comb_device(
            J, torch.stack([u, gn], 1), [dt], m, iop, expm_method,
            with_err=True)
        D2 = f(U2) - J.matvec(U2) - gn
        b3 = (torch.full_like(dt, 2.0) / dt ** 2) * D2
        (u_new,), (e2,) = _phi_comb_device(
            J, torch.stack([u, gn, zero, b3], 1), [dt], m, iop, expm_method,
            with_err=True)
        err_vec = u_new - U2
        errs, nk_step = (e1, e2), 2
    finite = all_finite(u_new, comm, err_vec)
    rdt = atol.dtype
    enorm = _wrms_tensor(torch.where(finite, err_vec, 0), u, u_new, rtol,
                         atol, comm)
    enorm = torch.where(finite, enorm.to(rdt).to(_F64), math.inf)
    eps_phi = torch.stack(errs).max().to(rdt).to(_F64)
    return u_new, dt, finite, enorm, eps_phi, nk_step


def _exprb_step(st: _LoopState, t_eps, dt_floor, rtol, atol, phi_tol, *,
                f, scheme: str, m: int, iop: int, expm_method: str,
                max_steps: int, use_pi: bool, at_mmax: bool, adaptive: bool,
                comm=None):
    """The JAX ``lax.while_loop`` body at one Krylov size m: one attempt
    and the controller's decision, every write masked (the loop is
    ``graphs.LoopRunner.loop`` over it)."""
    order = 4 if scheme == "exprb43" else 3
    safety, fmin, fmax = 0.9, 0.2, 5.0

    def active():
        return ((st.t < st.tf - t_eps)
                & (st.steps + st.rejected < max_steps)
                & (st.want_m == 0) & (st.info == 0))

    @full_precision
    def step():
        go = active()
        u_new, dt, finite, enorm, eps_phi, nk_step = _exprb_attempt(
            st, f, scheme, m, iop, expm_method, rtol, atol, comm)
        # kiops' own acceptance bound (omega = err/tol <= delta = 1.4 at
        # tau_end == tau) polices the fixed-m approximation
        phi_ok = torch.isfinite(eps_phi) & (eps_phi <= 1.4 * phi_tol)
        phi_fail = finite & ~phi_ok
        if not adaptive:
            # fixed steps: accept anything finite, keep dt, report
            # divergence through info 3
            accept = finite
            want_new = torch.zeros_like(st.want_m)
            dt_new = st.dt
            info_new = torch.where(finite, st.info, 3)
        else:
            # a phi breach on finite data asks for the next m bucket
            want_new = (torch.zeros_like(st.want_m) if at_mmax
                        else (phi_fail & (enorm <= 1.0)).to(_I64))
            accept = finite & (enorm <= 1.0) & phi_ok
            pi_ok = (st.eprev > 0) & use_pi
            en = torch.clamp_min(enorm, 1e-300)
            fac_pi = (safety * en ** (-0.7 / order)
                      * torch.clamp_min(st.eprev, 1e-300) ** (0.4 / order))
            fac_i = safety * en ** (-1.0 / order)
            fac_acc = torch.where(enorm <= 0, fmax, torch.clamp(
                torch.where(pi_ok, fac_pi, fac_i), fmin, fmax))
            fac_rej = torch.clamp(safety * torch.where(
                finite, en, 100.0) ** (-1.0 / order), fmin, fmax)
            # non-finite: hard shrink; enorm > 1: controller shrink; a
            # phi-only breach: next bucket (dt kept) or dt/2 at m_max
            dt_new = torch.where(
                accept, dt * fac_acc,
                torch.where(~finite, dt / st.five,
                            torch.where(enorm > 1.0, dt * fac_rej,
                                        dt / 2 if at_mmax else st.dt)))
            underflow = ~accept & (want_new == 0) & (dt_new < dt_floor)
            info_new = torch.where(underflow, 1, st.info)
        real = want_new == 0
        acc = go & accept
        masked_copy(st.u, acc, u_new)
        masked_copy(st.t, acc, st.t + dt)
        masked_copy(st.dt, go, dt_new)
        masked_copy(st.eprev, go,
                    torch.where(accept & (enorm > 0), enorm, -1.0))
        st.steps.add_(acc.to(_I64))
        st.rejected.add_((go & ~accept & real).to(_I64))
        st.nk.add_((go & real).to(_I64) * nk_step)
        masked_copy(st.want_m, go, want_new)
        masked_copy(st.info, go, info_new)
        st.flags.copy_(torch.stack([
            active().to(_F64), st.want_m.to(_F64), st.info.to(_F64), st.t,
            st.steps.to(_F64), st.rejected.to(_F64), st.nk.to(_F64)]))

    return step


def _choose(flags):
    """The next attempt (``graphs.LoopRunner.loop``), until the flags show
    the bucket's loop ended."""
    return "attempt" if flags is None or flags[0] else None


def _run_exprb_device(scheme, f, u0, t_span, dt0, *, m, m_max, iop,
                      expm_method, rtol, atol, phi_tol, controller,
                      max_steps, return_stats, adaptive, snapshots=None,
                      device=None, comm=None):
    t0, tf = float(t_span[0]), float(t_span[1])
    if tf <= t0:
        raise ValueError("t_span must satisfy tf > t0")
    if controller not in ("pi", "i"):
        raise ValueError(f"controller must be 'pi' or 'i', got {controller!r}")
    if snapshots is not None:
        snaps = [float(s) for s in np.asarray(snapshots).ravel()]
        if not snaps or any(b <= a for a, b in zip(snaps, snaps[1:])):
            raise ValueError("snapshots must be strictly increasing")
        if snaps[0] <= t0 or snaps[-1] > tf + 1e-14 * (tf - t0):
            raise ValueError("snapshots must lie in (t0, tf]")
        if abs(snaps[-1] - tf) > 1e-14 * (tf - t0):
            raise ValueError(
                "snapshots[-1] must equal t_span[1] (the driver "
                "integrates to tf; include it as the last snapshot)")
        snaps[-1] = tf
        seg_ends = snaps
    else:
        seg_ends = [tf]
    u = host_tensor(u0, device)
    atol_t = _atol(atol, u)
    phi_tol = phi_tol if phi_tol is not None else min(rtol, 1e-7) / 10
    m = max(3, min(m, m_max))
    st = _LoopState(u, t0, float(dt0) if dt0 else (tf - t0) / 100)
    steps = {}
    cols = []
    with LoopRunner(f"{scheme}_device (f={_fname(f)})", u.device,
                    sharded=comm is not None) as runner:
        for tf_seg in seg_ends:
            # each snapshot is a forced step endpoint (the clamp dt =
            # min(dt, tf_seg - t) lands an accepted step on it);
            # controller memory, dt and the m bucket carry across
            # segments, which rerun the same graphs
            st.tf.fill_(tf_seg)
            for _ in range(len(_EXPRB_M_LADDER) + 2):  # bucket changes
                if m not in steps:
                    steps[m] = _exprb_step(
                        st, 1e-14 * (tf - t0), 1e-12 * (tf - t0), rtol,
                        atol_t, phi_tol, f=f, scheme=scheme, m=m, iop=iop,
                        expm_method=expm_method, max_steps=max_steps,
                        use_pi=(controller == "pi"), at_mmax=(m >= m_max),
                        adaptive=adaptive, comm=comm)
                flags = runner.loop(m, {"attempt": steps[m]}, st.flags,
                                    _choose, "attempt")
                if flags[1] == 0:
                    break
                m = _next_bucket(m, m_max)
                st.want_m.zero_()
            if flags[2] != 0 or flags[3] < tf_seg - 1e-14 * (tf - t0):
                break                       # a failure, raised below
            if snapshots is not None:
                cols.append(st.u.clone())
    stats = ExpIntStats(
        steps=int(flags[4]), rejected=int(flags[5]), n_kiops=int(flags[6]),
        n_f_evals=(3 if scheme == "exprb43" else 2) * int(flags[4]
                                                          + flags[5]),
        final_m=m, info=int(flags[2]))
    if stats.info == 0 and flags[3] < tf - 1e-14 * (tf - t0):
        stats.info = 2
    if stats.info:
        # no-silent-failure protocol
        reason = {1: "step size underflow",
                  2: f"attempt budget max_steps={max_steps} exceeded",
                  3: "non-finite state at fixed dt - reduce dt"
                  }[stats.info]
        raise FloatingPointError(
            f"{scheme}_device stopped at t={flags[3]:.6g} < tf={tf:.6g}: "
            f"{reason} (final m={m}; loosen tolerances, raise max_steps/"
            "m_max, or check f)")
    out = st.u if snapshots is None else torch.stack(cols, dim=1)
    return (out, stats) if return_stats else out


def exprb32_device(f, u0, t_span, dt=None, *, adaptive=None, m: int = 20,
                   iop: int = 2, expm_method: str = "taylor",
                   m_max: int = 128, rtol=1e-6, atol=1e-9, phi_tol=None,
                   controller: str = "pi", max_steps: int = 100_000,
                   return_stats: bool = False, snapshots=None, device=None,
                   comm=None):
    """exprb32 in the JAX package's device form (see ``exprb43_device``):
    the adaptive 3(2) controller when ``adaptive`` (the default with
    dt=None), finite-checked fixed steps of dt otherwise (in the same
    loop: the step that lands on tf or a snapshot is clamped, so
    ``snapshots`` work in both modes)."""
    if adaptive is None:
        adaptive = dt is None
    if not adaptive and dt is None:
        raise ValueError("adaptive=False requires dt")
    if not adaptive and float(dt) <= 0:
        raise ValueError("need dt > 0")
    return _run_exprb_device(
        "exprb32", f, u0, t_span, dt, m=m, m_max=m_max, iop=iop,
        expm_method=expm_method, rtol=rtol, atol=atol, phi_tol=phi_tol,
        controller=controller, max_steps=max_steps,
        return_stats=return_stats, adaptive=adaptive, snapshots=snapshots,
        device=device, comm=comm)

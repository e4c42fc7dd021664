"""Truncated-Taylor exp(tA) b, Al-Mohy & Higham (2011) ``expmv`` (PyTorch
port of ``exponentialutilities_jl_tpu/models/expv_taylor.py``).

No Krylov basis: s stages of m* matvecs each, with no orthogonalization,
no reduced problem and no basis storage.

* The theta table: the largest scaled norm per Taylor degree m whose
  backward error is below the working tolerance, from an exact-rational
  evaluation of h~_{m+1} and bisection (the JAX package's table, its own
  copy here).
* (m*, s): cost minimization over the degrees; dense matrices add the
  alpha_p 1-norm-of-powers probes, operators use a norm bound (``opnorm``
  or the operator's ``opnorm_hint``).
* The loop: trace shift mu (tr(A)/n for dense A), s stages of m* Taylor
  steps. m* and s are host ints here (the JAX package traces them, so it
  masks a loop of the static bound 55); the two-term early-termination
  test and the finiteness stop stay device masks, so the loop makes no
  host read. A stage is one step over state made before the loop, replayed
  from a CUDA graph on the card (``_taylor_loop``). With ``opnorm`` given, an operator call makes none at all;
  a dense call reads its norms once to choose (m*, s).

A row-sharded operator (``parallel.shard_operator``) runs the operator
path on this rank's rows with the global operator's ``opnorm_hint``; the
early-termination test and the finiteness stop take their maxima over
every rank (one pmax a step), so every rank stops at the same term.
"""

from __future__ import annotations

import cmath
import functools
import math
from fractions import Fraction

import numpy as np
import torch

from ..ops.krylov import _State, run_steps
from ..utils.comm import operator_comm
from ..utils.device import action_vector, host_tensor
from ..utils.linop import LinearOperator
from ..utils.precision import full_precision

__all__ = ["expv_taylor", "expv_taylor_batched", "taylor_theta"]

_M_MAX = 55
_P_MAX = 8


@functools.lru_cache(maxsize=None)
def _theta_table(log2_tol: int) -> tuple:
    """theta_m for m = 1.._M_MAX at tol = 2^log2_tol: the largest x with
    |h~_{m+1}(x)| / x <= tol, where T_{m+1}(-x), the Taylor partial sum of
    exp, is evaluated in exact rational arithmetic (no cancellation) and
    bisected."""
    tol = 2.0 ** log2_tol

    def backward_err(m: int, x: float) -> float:
        xf = Fraction(x).limit_denominator(10 ** 12)
        T = sum((-xf) ** k / math.factorial(k) for k in range(m + 2))
        if T <= 0:
            return float("inf")
        return abs(math.log(float(T)) + x) / x

    thetas = []
    lo_prev = 1e-16
    for m in range(1, _M_MAX + 1):
        lo, hi = lo_prev, 60.0
        if backward_err(m, hi) <= tol:
            thetas.append(hi)
            lo_prev = hi
            continue
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if backward_err(m, mid) <= tol:
                lo = mid
            else:
                hi = mid
        thetas.append(lo)
        lo_prev = max(lo, 1e-16)
    return tuple(thetas)


def taylor_theta(dtype):
    """theta table for the dtype's unit roundoff (64-bit -> 2^-53, else
    2^-24)."""
    return _theta_table(-53 if torch.finfo(dtype).bits >= 64 else -24)


def _real(dt):
    return torch.empty((), dtype=dt).real.dtype


def _select_parameters(nA: float, etas, thetas):
    """(m*, s) by cost minimization (host floats): over the plain 1-norm
    ``nA`` when it is small enough, else over the alpha_p of the power
    norms ``etas`` (eta_k = |At^k|_1^(1/k), k = 2.._P_MAX+1); (0, 1) for a
    zero matrix."""
    th = np.asarray(thetas)
    ms = np.arange(1, _M_MAX + 1, dtype=np.float64)
    if nA == 0:
        return 0, 1
    bound = 4 * thetas[_M_MAX - 1] * _P_MAX * (_P_MAX + 3) / _M_MAX
    if nA <= bound:
        c = ms * np.ceil(max(nA, 1e-300) / th)
        mo = int(np.argmin(c)) + 1
        return mo, max(1, int(math.ceil(nA / th[mo - 1])))
    eta = np.asarray(etas)
    alphas = np.maximum(eta[:-1], eta[1:])          # p = 2.._P_MAX
    rows = []
    for ip, pp in enumerate(range(2, _P_MAX + 1)):
        c = ms * np.ceil(max(alphas[ip], 1e-300) / th)
        lo_m = max(1, pp * (pp - 1) - 1)
        rows.append(np.where(np.arange(1, _M_MAX + 1) >= lo_m, c, np.inf))
    C = np.stack(rows).reshape(-1)
    idx = int(np.argmin(C))
    mo = idx % _M_MAX + 1
    return mo, max(1, int(C[idx] // mo))


def _taylor_loop(matvec, b, scale, eta, m_star, s, eps, m_max: int,
                 s_max: int, comm=None, what: str = "taylor"):
    """s stages of the degree-m* Taylor recurrence with the two-term
    early-termination test. b is one system (n,) or a stack (B, n); m*
    and s are ints, or (B,) tensors of a stack with each system masked
    past its own, and the loops run to the host bounds ``m_max`` and
    ``s_max``. The early stop and the finiteness stop are device masks:
    no host read. ``comm``: b's rows are sharded, and the maxima and the
    finiteness are the global ones.

    One stage is one step (the JAX package's ``lax.while_loop`` body):
    its m_max masked terms unrolled, each with its constant scale / j,
    over the state (F, ok) and the stage index read from the step counter
    for ``k < s``; the step runs s_max times (``ops/krylov.run_steps``
    under the label ``what``: a replayed graph on a CUDA device)."""
    rdt = _real(b.dtype)

    def amax(*xs):
        vals = [x.abs().amax(dim=-1).to(rdt) for x in xs]
        if comm is None:
            return vals
        return list(comm.pmax(torch.stack(vals)).unbind(0))

    def finite(x):
        ok_ = torch.isfinite(x).all(dim=-1)
        if comm is None:
            return ok_
        return comm.pmax((~ok_).to(rdt)) == 0

    def col(mask):
        return mask[..., None]

    S = _State(b.device, F=b, ok=finite(b))

    def step():
        F = S.F
        v, F2 = F, F
        (c1,) = amax(v)
        done = torch.zeros_like(S.ok)
        for j in range(1, m_max + 1):
            vn = matvec(v) * (scale / j)
            Fn = F2 + vn
            c2, cF = amax(vn, Fn)
            stop = (c1 + c2) <= eps * cF
            live = ~done & (j <= m_star)
            v = torch.where(col(live), vn, v)
            F2 = torch.where(col(live), Fn, F2)
            c1 = torch.where(live, c2, c1)
            done = done | (live & stop)
        F = torch.where(col(S.ok & (S.jj[0] < s)), F2 * eta, F)
        S.set("F", F)
        S.apply("ok", torch.logical_and, S.ok, finite(F))
        S.step_on()

    run_steps(what, S, step, s_max, b.device, sharded=comm is not None)
    return S.F


def _onenorm(X):
    """1-norms of a (B, n, n) stack, (B,)."""
    return X.abs().sum(dim=1).amax(dim=1)


def _taylor_dense_parts(A, b, t, mu, use_trace_shift: bool, eps):
    """The arguments of ``_taylor_loop`` for a (B, n, n) stack with (B, n)
    vectors and (B,) times: trace shift, (m*, s) per system (a host read
    of the 1-norms, and a second of the power probes' where a norm is past
    the simple bound). The loop itself makes no read."""
    n = A.shape[1]
    dt = A.dtype
    rdt = _real(dt)
    thetas = taylor_theta(dt)
    if use_trace_shift:
        mu = A.diagonal(dim1=1, dim2=2).sum(dim=1) / n
    Ash = A - mu[:, None, None] * torch.eye(n, dtype=dt, device=A.device)
    At = Ash * t[:, None, None]
    nA = _onenorm(At).to(rdt).tolist()
    bound = 4 * thetas[_M_MAX - 1] * _P_MAX * (_P_MAX + 3) / _M_MAX
    etas = [None] * len(nA)
    if max(nA) > bound:
        P = At @ At
        probes = [_onenorm(P).to(rdt) ** (1.0 / 2.0)]
        for pp in range(2, _P_MAX + 1):
            P = P @ At
            probes.append(_onenorm(P).to(rdt) ** (1.0 / (pp + 1)))
        etas = torch.stack(probes, dim=1).tolist()
    params = [_select_parameters(a, e, thetas) for a, e in zip(nA, etas)]
    m_star = torch.tensor([q[0] for q in params], device=A.device)
    s = torch.tensor([q[1] for q in params], device=A.device)
    sd = s.to(dt)
    scale, eta = (t / sd)[:, None], torch.exp(mu * t / sd)[:, None]
    return (lambda x: (Ash @ x[..., None])[..., 0], b, scale, eta, m_star,
            s, eps, max(q[0] for q in params), max(q[1] for q in params))


@full_precision
def _taylor_dense(A, b, t, mu, use_trace_shift: bool, eps):
    """Dense expv_taylor of a (B, n, n) stack with (B, n) vectors and (B,)
    times: the parameters (``_taylor_dense_parts``), then the Taylor
    loop."""
    return _taylor_loop(*_taylor_dense_parts(A, b, t, mu, use_trace_shift,
                                             eps), what="taylor (dense)")


def expv_taylor(t, A, b, *, tol: float | None = None, opnorm=None,
                mu: float | complex | None = None):
    """exp(tA) b by the scaled truncated Taylor series, with no Krylov
    basis (module doc).

    t: scalar time. A: dense matrix (the full parameter search with the
    power probes) or a LinearOperator (needs ``opnorm``, a bound on
    |A - mu I|_1, or the operator's ``opnorm_hint``). b: vector.
    tol: series tolerance (default: the dtype's unit roundoff / 2).
    mu: trace shift; default tr(A)/n for dense A, 0 for operators.
    """
    if isinstance(A, LinearOperator):
        return _expv_taylor_op(t, A, b, tol, opnorm, mu)
    A = host_tensor(A)
    b = host_tensor(b, A.device)
    dt = torch.promote_types(torch.promote_types(b.dtype, A.dtype),
                             torch.as_tensor(t).dtype)
    if tol is None:
        tol = float(torch.finfo(dt).eps) / 2
    use_trace_shift = mu is None
    muv = torch.full((1,), 0 if use_trace_shift else mu, dtype=dt,
                     device=A.device)
    tv = torch.full((1,), t, dtype=dt, device=A.device)
    return _taylor_dense(A.to(dt)[None], b.to(dt)[None], tv, muv,
                         use_trace_shift, tol)[0]


def operator_parameters(nrm: float, thetas):
    """(m*, s) of the operator path for the norm bound ``nrm`` = |t|
    opnorm: the call runs s stages of m* matvecs."""
    costs = [m * math.ceil(nrm / thetas[m - 1]) for m in range(1, _M_MAX + 1)]
    m_star = int(np.argmin(costs)) + 1
    return m_star, max(1, int(math.ceil(nrm / thetas[m_star - 1])))


@full_precision
def _expv_taylor_op(t, op, b, tol, opnorm, mu):
    """The operator path: (m*, s) from |t| opnorm on the host, then s
    stages of m* matvecs of A - mu I."""
    b = action_vector(b, op)
    dt = torch.promote_types(torch.promote_types(b.dtype, op.dtype),
                             torch.as_tensor(t).dtype)
    thetas = taylor_theta(dt)
    if tol is None:
        tol = float(torch.finfo(dt).eps) / 2
    if mu is None:
        mu = 0.0
    if opnorm is None:
        hint = op.opnorm_hint()
        if hint is None:
            raise ValueError(
                "expv_taylor with a matrix-free operator requires an "
                "`opnorm` bound (or an operator opnorm_hint)")
        opnorm = float(hint)
    m_star, s = operator_parameters(abs(t) * float(opnorm), thetas)
    # host scalars: a tensor made from one would be a host-to-device copy
    scale = t / s
    eta = cmath.exp(mu * t / s)
    if not dt.is_complex:
        eta = eta.real

    def mv(x):
        return op.matvec(x) - mu * x

    return _taylor_loop(mv, b.to(dt), scale, eta, m_star, s, tol, m_star, s,
                        operator_comm(op), what=f"taylor ({type(op).__name__})")


def expv_taylor_batched(t, As, bs, *, tol: float | None = None):
    """Batched small dense systems exp(t_i A_i) b_i: As (B, n, n), bs
    (B, n), t a scalar or (B,). Each system takes its own trace shift and
    (m*, s); the stack runs as batched products to the largest of them,
    each system masked past its own."""
    As = host_tensor(As)
    bs = host_tensor(bs, As.device)
    if As.ndim != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"As must be (B, n, n), got {tuple(As.shape)}")
    t = torch.as_tensor(t).to(As.device)
    dt = torch.promote_types(torch.promote_types(As.dtype, bs.dtype),
                             t.dtype)
    if tol is None:
        tol = float(torch.finfo(dt).eps) / 2
    nb = As.shape[0]
    tv = t.to(dt).expand(nb) if t.ndim == 0 else t.to(dt)
    mu0 = torch.zeros(nb, dtype=dt, device=As.device)
    return _taylor_dense(As.to(dt), bs.to(dt), tv, mu0, True, tol)

"""Krylov exponential action ``expv(t, A, b) ~ exp(tA) b`` (PyTorch port
of ``exponentialutilities_jl_tpu/models/expv.py``).

* ``mode="happy_breakdown"``: a Lanczos basis for Hermitian operators, an
  Arnoldi basis (full or IOP window, CGS2 with ``reorth``) otherwise, then
  the reduced exponential: Q exp(t Lambda) Q^T e1 of the masked
  tridiagonal (``ops/kernels/tridiag.tridiag_exp_e1``: kernel R1 on a
  CUDA device, the eigh twin on the CPU), or the degree-13 Pade ``expm_higham2005`` of t H_m, and the
  (m, n) combination w = beta V^T exp(tH) e1.
* ``two_pass=True``: storage-free two passes in O(n) memory. Hermitian:
  pass 1 records (alpha, beta), the reduced exponential (R1 or its twin)
  gives the combination coefficients, pass 2 regenerates the basis and
  accumulates w. On a CUDA device with real float32/float64 data and real
  t, a 1-D constant stencil runs both passes in the resident kernels (B2
  then B1, one launch each) and a 2-D/3-D box stencil, constant or
  variable-coefficient, in fused sweeps (B3, B3-var); everything else, and
  complex t on any device, takes the plain torch passes. Non-Hermitian:
  IOP Arnoldi over a rolling window (``iop > 0`` required), the same
  recurrence as ``expv(iop=win, reorth=False)``.
* ``mode="error_estimate"``: Hermitian Lanczos stopped by Saad's Er2
  estimate (``_expv_error_estimate``): one masked step over state made
  before the loop, run by a ``utils/graphs.LoopRunner`` (on a CUDA device
  from a CUDA graph, with no read inside the loop).

A ``SortedSellOperator`` is unwrapped on entry (``hoist_conjugation``):
the solve runs on its inner operator in the sorted basis, with one
permutation of b in and one of the result out. A numpy ``b`` goes to the
operator's device.

Breakdown is masked, not truncated: trailing basis rows and H entries are
zero, which makes the reduced matrix block-triangular, so exp(tH) e1 is
exact for the effective dimension.

``expv_batched(t, A, B)`` is exp(tA) b for each row b of B ((batch, n)
-> (batch, n)), as JAX's vmapped ``expv``: one batched build per call
(``ops/krylov.py``'s builders on the (batch, n) block: one masked step
with a batch axis, replayed from one CUDA graph a builder call, the
matvec the operator's ``matmat``, each row with its own breakdown and
``m_used``), then the batched reduced problem (the Hermitian one in one
launch of K2, R1's batched form; the non-Hermitian one Higham 2005 on the
stack with the 1-norm taken on the device) and the batched combination.
Routed as JAX routes it: the basis path, the two-pass forms (Hermitian:
on a 1-D constant stencil K3 -> K2 -> K4 on the card; on a 2-D/3-D box
stencil each row's fused sweeps, B3/B3-var, whose batched form is
queued; else the plain batched passes; non-Hermitian: the batched IOP
pair) and ``reduced="host"`` (one read of the whole batch's record).

The Hermitian reduced exponential. On a CUDA device it is kernel R1
(``ops/kernels/tridiag.py``), which reads t, beta0 and the diagonals from
device memory and makes no host read; ``torch.linalg.eigh`` (its twin)
reads its info to the host, a sync, and runs only on the CPU and for
calls that autograd or a ``torch.func`` transform must see, which the
grad rule of ``ops/kernels/dispatch.py`` sends there (it has eigh's
gradient). ``differentiable=True`` makes the non-Hermitian reduced
exponential the form with no host read (``expm_higham2005(
differentiable=True)``: masked squarings), for ``torch.func`` transforms.
Plain ``torch.autograd`` differentiates every path: B7's matvec has a
reverse rule (``ops/sparse.py``), and the grad rule sends a two-pass call
that requires grad to the plain torch passes.

A row-sharded operator (``parallel.shard_operator``) runs every path but
the kernels' on this rank's rows of b: the operator's ``comm``
(``utils/comm.py``) reduces the dots and norms, and the result is this
rank's rows.

``reduced="host"`` evaluates the m-sized reduced problem with scipy on
the host in float64/complex128 (``ops/host_reduced.py``), in every path
that has one: the basis path (``expm`` of t H_m), the two-pass Hermitian
forms (``eigh_tridiagonal`` between the passes; the kernels still run
both passes), the two-pass IOP form and ``expv_batched``. It costs one
device-to-host read and one host-to-device write per reduced problem.
The default ``reduced=None`` is ``reduced_default()``, "device": the
H100 has native float64, where the JAX package stages on the host only
for the TPU. ``differentiable=True`` and ``mode="error_estimate"`` refuse
"host", as the JAX package documents.
"""

from __future__ import annotations

import torch

from ..ops.expm import _onenorm, expm_higham2005
from ..ops.host_reduced import (host_expm_e1, host_lanczos_coeffs,
                                reduced_default)
from ..ops.kernels.dispatch import grad_gate, kernel_device_ok
from ..ops.kernels.tridiag import (scalar_operand, tridiag_exp_e1,
                                   tridiag_exp_e1_batched)
from ..ops.krylov import (KrylovBasis, _col, _comb, _sees_grad, _State,
                          arnoldi, arnoldi_coeffs, arnoldi_replay,
                          expand_compact_hessenberg, lanczos, lanczos_coeffs,
                          lanczos_replay)
from ..ops.sparse import SortedSellOperator, hoist_conjugation
from ..utils import graphs
from ..utils.comm import operator_comm, vdot, vector_norm
from ..utils.device import action_vector
from ..utils.linop import LinearOperator, aslinearoperator
from ..utils.precision import full_precision

__all__ = ["expv", "expv_from_basis", "build_subspace", "make_expv",
           "expv_batched"]


def build_subspace(op: LinearOperator, b, m: int, *, tol: float = 1e-7,
                   iop: int = 0, reorth: bool = True,
                   hermitian: bool | None = None) -> KrylovBasis:
    """Lanczos factorization of a Hermitian operator, Arnoldi of any
    other (the reference's auto-switch on ``ishermitian``). A row-sharded
    ``op`` takes this rank's rows of b (``ops/krylov.arnoldi``); a (batch,
    n) b builds each row's subspace (``ops/krylov.py``)."""
    herm = op.is_hermitian if hermitian is None else hermitian
    if herm:
        return lanczos(op, b, m, tol=tol)
    return arnoldi(op, b, m, iop=iop, tol=tol, reorth=reorth)


def _t_dtype(t):
    return torch.as_tensor(t).dtype


def _exp_reduced_e1(Ks: KrylovBasis, t, differentiable: bool = False):
    """First column of exp(t H_m) for the masked reduced matrix, (m,).
    Hermitian (real tridiagonal): ``tridiag_exp_e1`` (R1); the masked
    trailing zero block is block-diagonal, its eigenvectors have zero
    first component, so e1 excites only the effective leading block.
    Otherwise ``expm_higham2005(t H_m)[:, 0]``: its form with no host read
    when ``differentiable``, or with the 1-norm taken on the device when
    the call runs inside a step that may be captured (``graphs.inline``: a
    serving program's call, a loop step), else the host form. A batched
    basis: (batch, m), R1's batched form K2 (one launch) for the
    Hermitian rows, the stack's Higham 2005 with its 1-norm on the device
    (no host read) otherwise."""
    m = Ks.m
    Hm = Ks.H[..., :m, :m]
    batched = Hm.ndim > 2
    if Ks.hermitian and not Hm.is_complex():
        a, b = torch.diagonal(Hm, 0, -2, -1), torch.diagonal(Hm, -1, -2, -1)
        return (tridiag_exp_e1_batched if batched else tridiag_exp_e1)(a, b, t)
    Ht = t * Hm.to(torch.promote_types(Hm.dtype, _t_dtype(t)))
    if not differentiable and (batched or graphs.inline(Ht.device)):
        return expm_higham2005(Ht, onenorm=_onenorm(Ht))[..., :, 0]
    return expm_higham2005(Ht, differentiable=differentiable)[..., :, 0]


@full_precision
def _combine_expv(Ks: KrylovBasis, expHe):
    """w = beta V^T expHe with the zero-start guard, in the common type of
    the basis and the coefficients (a complex b on a real Hermitian
    operator keeps its imaginary part); each row's of a batched basis
    (one batched product)."""
    m = Ks.m
    dt = torch.promote_types(expHe.dtype, Ks.V.dtype)
    w = _comb(expHe.to(dt), Ks.V[..., :m, :].to(dt))
    beta = _col(Ks.beta)
    return torch.where(beta > 0, beta.to(w.dtype) * w, 0.0)


def _reduced_where(reduced, differentiable: bool = False,
                   mode: str = "happy_breakdown") -> str:
    """"device" or "host" for a caller's ``reduced`` (None: the default),
    refusing "host" with ``differentiable`` (a host read breaks the
    ``torch.func`` transforms) and with the error-estimate loop."""
    reduced = reduced_default() if reduced is None else reduced
    if reduced not in ("device", "host"):
        raise ValueError(f'reduced must be "device", "host" or None, got '
                         f"{reduced!r}")
    if reduced == "host" and differentiable:
        raise ValueError('reduced="host" is not differentiable (the reduced '
                         "problem goes through host scipy); use "
                         'reduced="device"')
    if reduced == "host" and mode == "error_estimate":
        raise ValueError('mode="error_estimate" evaluates its reduced '
                         'problems on the device; use reduced="device"')
    return reduced


def expv_from_basis(t, Ks: KrylovBasis, *, reduced: str = "device",
                    differentiable: bool = False):
    """w = beta V^T exp(tH) e1 from a prebuilt Lanczos or Arnoldi basis
    (``reduced``, ``differentiable``: module doc)."""
    if _reduced_where(reduced, differentiable) == "host":
        m = Ks.m
        return _combine_expv(Ks, host_expm_e1(Ks.H[..., :m, :m], t))
    return _combine_expv(Ks, _exp_reduced_e1(Ks, t, differentiable))


def _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced="device"):
    """Reduced stage of every two-pass Hermitian expv: the masked
    tridiagonal T of the record -> the replay combination coefficients
    beta0 Q e^{t Lambda} Q^T e1 (``tridiag_exp_e1`` with s = beta0; on
    the host with ``reduced="host"``); each row's of (batch, m) records,
    K2 in one launch."""
    if reduced == "host":
        return host_lanczos_coeffs(alphas, betas, beta0, t)
    if alphas.ndim > 1:
        return tridiag_exp_e1_batched(alphas, betas[..., :-1], t, beta0)
    return tridiag_exp_e1(alphas, betas[:-1], t, beta0)


@full_precision
def _expv_two_pass(op, b, t, m: int, reduced: str = "device"):
    """Storage-free Hermitian expv on the plain torch passes
    (``ops.krylov.lanczos_coeffs`` / ``lanczos_replay``): 2m matvecs,
    O(n) memory."""
    alphas, betas, beta0, m_used, broke = lanczos_coeffs(op, b, m)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced)
    out = lanczos_replay(op, b, coeffs, alphas, betas, m)
    return torch.where(_col(beta0) > 0, out, 0.0)


def _expv_two_pass_fused(op, b, t, m: int, tol: float = 1e-7,
                         reduced: str = "device"):
    """Two-pass Hermitian expv with both passes as fused sweeps (B3)."""
    from ..ops.kernels.lanczos_fused import (lanczos_coeffs_fused,
                                             lanczos_replay_fused)

    alphas, betas, beta0, m_used, broke = lanczos_coeffs_fused(op, b, m,
                                                               tol=tol)
    coeffs = _lanczos_reduced_coeffs(alphas, betas, beta0, t, reduced)
    out = lanczos_replay_fused(op, b, coeffs, tol=tol)
    return torch.where(beta0 > 0, out, 0.0)


@full_precision
def _expv_two_pass_arnoldi(op, b, t, m: int, win: int,
                           differentiable: bool = False,
                           reduced: str = "device"):
    """Storage-free non-Hermitian expv: two IOP-Arnoldi passes over a
    (win, n) rolling window (``ops.krylov.arnoldi_coeffs`` /
    ``arnoldi_replay``); the same recurrence as ``expv(iop=win,
    reorth=False)`` without the basis. A (batch, n) b: each row's, the
    reduced problems as one stack (Higham 2005 with the 1-norm on the
    device, or one host read)."""
    Hc, beta0, m_used, broke = arnoldi_coeffs(op, b, m, win)
    H = expand_compact_hessenberg(Hc, win)
    dt = torch.promote_types(H.dtype, _t_dtype(t))
    if reduced == "host":
        expHe = host_expm_e1(H[..., :m, :m], t, dt)
    elif b.ndim > 1 and not differentiable:
        Ht = t * H[..., :m, :m].to(dt)
        expHe = expm_higham2005(Ht, onenorm=_onenorm(Ht))[..., :, 0]
    else:
        expHe = expm_higham2005(t * H[..., :m, :m].to(dt),
                                differentiable=differentiable)[..., :, 0]
    w = arnoldi_replay(op, b, expHe * _col(beta0).to(dt), Hc, m, win)
    return torch.where(_col(beta0) > 0, w, 0.0)


def _errest_step(op, S, t, m: int, eps, beta0, comm):
    """The error-estimate loop's step (JAX's ``body``) on the state S (V,
    alphas, betas, ev, done, flags and the counter jj): a Lanczos step,
    exp(t T_j) e1 of the (j + 1)-masked tridiagonal, Saad's sigma and the
    stop flag, every write masked by ``done | (j >= m)`` (indices clamped,
    so a step past the end reads and writes in bounds and changes
    nothing). ``flags`` = (j, done) for the host."""
    dt = S.V.dtype
    rdt = S.alphas.dtype
    idx = torch.arange(m, device=S.V.device)

    def step():
        jv = S.jj[:1]
        j = jv[0]
        live = torch.logical_and(~S.done, j < m)
        jc = torch.clamp(jv, max=m - 1)
        jp = torch.clamp(jv - 1, min=0)
        x = S.V.index_select(0, jc)[0]
        y = op.matvec(x).to(dt)
        alpha = vdot(x, y, comm).real.to(rdt)
        y = y - alpha * x
        bprev = torch.where(j >= 1, S.betas.index_select(0, jp)[0], 0.0)
        y = y - bprev * S.V.index_select(0, jp)[0]
        nrm = vector_norm(y, comm).to(rdt)
        S.put("alphas", 0, jc, torch.where(
            live, alpha, S.alphas.index_select(0, jc)[0]).reshape(1))
        S.put("betas", 0, jc, torch.where(
            live, nrm, S.betas.index_select(0, jc)[0]).reshape(1))
        vnew = torch.where(nrm > 0, y / torch.where(nrm > 0, nrm, 1.0), 0)
        S.put("V", 0, jc + 1, torch.where(
            live, vnew, S.V.index_select(0, jc + 1)[0])[None])
        # exp(t T_j) e1 of the leading (j+1)-block; the zero tail of the
        # masked tridiagonal is block-diagonal and not excited by e1
        a = torch.where(idx <= j, S.alphas, 0.0)
        bb = torch.where(idx < j, S.betas, 0.0)
        ev = tridiag_exp_e1(a, bb[:-1], t).to(S.ev.dtype)
        S.apply("ev", torch.where, live, ev, S.ev)
        sigma = nrm * beta0 * ev.index_select(0, jc)[0].abs()
        S.apply("done", torch.where, live, sigma < eps, S.done)
        S.apply("jj", torch.add, S.jj, live.to(S.jj.dtype))
        S.apply("flags", torch.stack, [S.jj[0].to(S.flags.dtype),
                                       S.done.to(S.flags.dtype)])

    return step


@full_precision
def _expv_error_estimate(op, b, t, m: int, atol: float, rtol: float,
                         comm=None):
    """Hermitian Lanczos expv stopped by Saad's Er2 a-posteriori estimate
    sigma = beta_j beta0 |e_j^T exp(t T_j) e1| < atol + rtol beta0.

    One masked step (``_errest_step``) over state made before the loop,
    as in the JAX package's ``lax.while_loop``. Step 0 runs first, on the
    caller's stream, rebinding the state; if a state tensor then requires
    grad or is wrapped by a ``torch.func`` transform, every step rebinds,
    with one read of the flags after each. Otherwise a
    ``utils/graphs.LoopRunner`` runs the rest with flags (j, done): on a
    CUDA device from a CUDA graph, the flags read one execution behind, so
    the loop makes no read inside it and costs one masked execution past
    its end; on the CPU the same step eagerly. ``comm``: b's rows are
    sharded (the flag comes from reduced scalars, the same on every rank);
    every step then runs eagerly after a read of the flags, as the host
    loop did, so the collectives are those of the steps taken. Returns
    (w, iterations)."""
    n = b.shape[0]
    dt = b.dtype
    dev = b.device
    rdt = torch.empty((), dtype=dt).real.dtype
    beta0 = vector_norm(b, comm).to(rdt)
    eps = atol + rtol * beta0
    v0 = torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0),
                     0.0).to(rdt) * b
    V = torch.zeros((m + 1, n), dtype=dt, device=dev)
    V[0] = v0
    tq = scalar_operand(t, beta0)
    S = _State(dev, V=V,
               alphas=torch.zeros(m, dtype=rdt, device=dev),
               betas=torch.zeros(m, dtype=rdt, device=dev),
               ev=torch.zeros(m, dtype=tq.dtype, device=dev),
               done=beta0 == 0,
               flags=torch.zeros(2, dtype=torch.float64, device=dev))
    S.apply("flags", torch.stack, [S.jj[0].to(S.flags.dtype),
                                   S.done.to(S.flags.dtype)])
    step = _errest_step(op, S, tq, m, eps, beta0, comm)

    def ended(host):
        return bool(host[1]) or host[0] >= m

    if comm is None:
        step()                          # step 0, rebinding (module doc)
        S.rebind = _sees_grad(S)
    if S.rebind:
        while True:
            graphs.counts["blocking_reads"] += 1
            host = S.flags.tolist()
            if ended(host):
                break
            step()
    else:
        with graphs.LoopRunner(f"expv error_estimate ({type(op).__name__})",
                               dev) as runner:
            host = runner.loop(m, {"step": step}, S.flags,
                               lambda h: (None if h is not None and ended(h)
                                          else "step"), "step")
    wdt = torch.promote_types(S.ev.dtype, dt)
    w = S.ev.to(wdt) @ S.V[:m].to(wdt)
    out = beta0.to(w.dtype) * w
    return torch.where(beta0 > 0, out, 0.0), int(host[0])


def expv(t, A, b, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
         mode: str = "happy_breakdown", reorth: bool = True,
         hermitian: bool | None = None, atol: float = 1e-8,
         rtol: float | None = None, reduced: str | None = None,
         two_pass: bool = False, return_info: bool = False,
         differentiable: bool = False):
    """exp(tA) b by a Krylov approximation (module doc).

    t: real or complex scalar. A: operator or square matrix. b: (n,).
    m: Krylov dimension (capped at n). tol: happy-breakdown threshold.
    iop: incomplete-orthogonalization window of the Arnoldi path (0 =
      full); reorth: CGS2 there.
    mode: "happy_breakdown" or "error_estimate" (Hermitian only; stops
      when Saad's estimate is below atol + rtol |b|, rtol default
      sqrt(tol); ``return_info=True`` also returns the iterations taken).
    two_pass: the storage-free two-pass forms (module doc), which pick the
      CUDA kernels for real float32/float64 data and real t on a CUDA
      device when the operator is a supported stencil and the grad rule
      lets the call through; non-Hermitian operators need ``iop > 0``
      there.
    reduced: "device", "host" or None (the default, "device"): where the
      m-sized reduced problem is evaluated (module doc).
    differentiable: the reduced exponential's form with no host read
      (module doc).
    """
    reduced = _reduced_where(reduced, differentiable, mode)
    op = aslinearoperator(A)
    b = action_vector(b, op)
    op, b, post = hoist_conjugation(op, b)
    if post is not None:
        # degree-sorted conjugated container: the whole solve runs in the
        # sorted basis (exp commutes with the conjugation)
        out = expv(t, op, b, m=m, tol=tol, iop=iop, mode=mode, reorth=reorth,
                   hermitian=hermitian, atol=atol, rtol=rtol, reduced=reduced,
                   two_pass=two_pass, return_info=return_info,
                   differentiable=differentiable)
        if return_info and isinstance(out, tuple):
            return (post(out[0]),) + out[1:]
        return post(out)
    m = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian
    if mode == "error_estimate":
        if not herm:
            raise NotImplementedError(
                "error_estimate mode requires a Hermitian operator")
        rtol = tol ** 0.5 if rtol is None else rtol
        w, iters = _expv_error_estimate(op, b, t, m, atol, rtol,
                                        operator_comm(op))
        return (w, iters) if return_info else w
    if mode != "happy_breakdown":
        raise ValueError(f"unknown expv mode {mode!r}")
    if not two_pass:
        return expv_from_basis(t, build_subspace(op, b, m, tol=tol, iop=iop,
                                                 reorth=reorth,
                                                 hermitian=herm),
                               reduced=reduced,
                               differentiable=differentiable)
    if not herm:
        if iop <= 0:
            raise ValueError(
                "non-Hermitian two_pass expv requires an IOP window "
                "(iop > 0): the rolling-window recurrence is what makes the "
                "replay storage-free")
        return _expv_two_pass_arnoldi(op, b, t, m, iop, differentiable,
                                      reduced)
    from ..ops.kernels.lanczos_fused import fused_supported
    from ..ops.kernels.resident import (expv_two_pass_resident,
                                        resident_supported)

    # the kernels replay with real coefficients: complex t keeps the
    # plain path, whose coefficients promote to complex; the grad rule
    # (ops/kernels/dispatch.py) sends a call that autograd must see there
    kernels = (kernel_device_ok(b.dtype, b.device)
               and not torch.as_tensor(t).is_complex()
               and (resident_supported(op)
                    or fused_supported(op, hermitian=True))
               and not grad_gate(op, (b, t)))
    if kernels and resident_supported(op):
        return expv_two_pass_resident(op, b, t, m, tol=tol, reduced=reduced)
    if kernels and fused_supported(op, hermitian=True):
        return _expv_two_pass_fused(op, b, t, m, tol=tol, reduced=reduced)
    return _expv_two_pass(op, b, t, m, reduced)


def _serving_closure(what: str, op, call):
    """``fn(t, b)``: ``call(t, b)`` as one ``utils/graphs.Program`` call
    (``make_expv``, ``models/phiv.make_phiv``) at the key b's shape and
    dtype, t's dtype, the device and grad mode. b is moved to the
    operator's device and t made a 0-d tensor there (in b's real
    precision) before the program, outside any capture. ``fn.program`` is
    the program and ``fn.close()`` frees its graphs."""
    prog = graphs.Program(f"{what} ({type(op).__name__})",
                          sharded=operator_comm(op) is not None, holds=op)

    def fn(t, b):
        b = action_vector(b, op)
        t = scalar_operand(t, b.real if b.is_complex() else b)
        return prog((tuple(b.shape), b.dtype, t.dtype, b.device,
                     torch.is_grad_enabled()), call, (t, b))

    fn.program = prog
    fn.close = prog.close
    return fn


def make_expv(op, *, m: int = 30, tol: float = 1e-7, iop: int = 0,
              reorth: bool = True, hermitian: bool | None = None,
              bake_operator: bool = False):
    """Serving factory: ``fn(t, b)`` with the operator and the Krylov
    settings bound once, each call one program (the JAX package's jitted
    ``_expv_fused``): ``utils/graphs.Program`` runs the first call of a
    key (b's shape and dtype, t's dtype, the device, grad mode) eagerly,
    captures the second into a CUDA graph and replays it from then on, the
    result a fresh tensor each call; a call that autograd or a
    ``torch.func`` transform must see runs eagerly (``_serving_closure``).
    Inside, the reduced problem reads nothing to the host: R1 for a
    Hermitian operator, Higham 2005 with the 1-norm taken on the device
    otherwise. ``fn.close()`` frees the graphs before the closure goes.

    The closure follows the operator's current storage, as the JAX
    package's default closure (``bake_operator=False``, the operator passed
    on every call) does: a call after ``op``'s storage is reassigned or
    changed in place drops the captured graph and runs as a warm-up, so it
    sees the new values and the next call is captured anew
    (``utils/graphs.Program``, "Stale storage").

    bake_operator: accepted for the JAX package's signature and changes
      nothing. There it embeds the operator's arrays in the compiled
      program as constants, so a later change of them is not seen; here
      every call reads the operator's storage as it is then."""
    op = aslinearoperator(op)
    m_ = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian

    def call(t, b):
        Ks = build_subspace(op, b, m_, tol=tol, iop=iop, reorth=reorth,
                            hermitian=herm)
        return _combine_expv(Ks, _exp_reduced_e1(Ks, t))

    return _serving_closure("make_expv", op, call)


def expv_batched(t, A, B, *, m: int = 30, tol: float = 1e-7,
                 hermitian: bool | None = None, reduced: str | None = None,
                 two_pass: bool = False, iop: int = 0, reorth: bool = True):
    """exp(tA) b_i for each row b_i of B (batch, n): one Krylov subspace per
    row, all built at once (module doc: one batched build a call, each row
    with its own breakdown). With a row-sharded operator B holds this
    rank's columns of each row (and, on a data x shard mesh, only its
    data slice of the rows): the reductions run over the operator's axis
    alone, one collective a reduction for the whole batch. Returns (batch,
    n). ``reduced``: as in ``expv`` (with "host" the whole batch's reduced
    problems in one read and one write). ``two_pass``, ``iop``: as in
    ``expv``; a row of zeros gives zeros."""
    reduced = _reduced_where(reduced)
    op = aslinearoperator(A)
    B = action_vector(B, op)
    if B.ndim != 2:
        raise ValueError(f"expv_batched takes B as (batch, n), got "
                         f"{tuple(B.shape)}")
    if isinstance(op, SortedSellOperator):
        # the solve in the sorted basis (hoist_conjugation): B's columns
        # permuted once in, the result's once out
        W = expv_batched(t, op.inner, B.index_select(1, op.order), m=m,
                         tol=tol, hermitian=hermitian, reduced=reduced,
                         two_pass=two_pass, iop=iop, reorth=reorth)
        return W.index_select(1, op._inv)
    m = min(m, op.shape[0])
    herm = op.is_hermitian if hermitian is None else hermitian
    if not two_pass:
        return expv_from_basis(t, build_subspace(op, B, m, tol=tol, iop=iop,
                                                 reorth=reorth,
                                                 hermitian=herm),
                               reduced=reduced)
    if not herm:
        if iop <= 0:
            raise ValueError(
                "non-Hermitian two_pass expv requires an IOP window "
                "(iop > 0): the rolling-window recurrence is what makes the "
                "replay storage-free")
        return _expv_two_pass_arnoldi(op, B, t, m, iop, reduced=reduced)
    from ..ops.kernels.lanczos_fused import fused_supported
    from ..ops.kernels.resident import (expv_two_pass_resident,
                                        resident_supported)

    kernels = (kernel_device_ok(B.dtype, B.device)
               and not torch.as_tensor(t).is_complex()
               and (resident_supported(op)
                    or fused_supported(op, hermitian=True))
               and not grad_gate(op, (B, t)))
    if kernels and resident_supported(op):
        return expv_two_pass_resident(op, B, t, m, tol=tol, reduced=reduced)
    if kernels:
        # B3/B3-var have no batched form yet: each row's fused passes
        return torch.stack([_expv_two_pass_fused(op, b, t, m, tol=tol,
                                                 reduced=reduced)
                            for b in B.unbind(0)])
    return _expv_two_pass(op, B, t, m, reduced)

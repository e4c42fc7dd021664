"""Krylov subspaces with breakdown kept as data: Lanczos for Hermitian
operators, Arnoldi for general ones (PyTorch port of
``exponentialutilities_jl_tpu/ops/krylov.py``).

V and H keep their full (m+1, .) shapes after a happy breakdown; the
trailing basis rows and coefficients are zero and ``m_used`` /
``breakdown`` record the effective dimension, so the downstream reduced
problem is exact without any data-dependent shapes (and without a host
sync inside the loop).

Each builder is one step over state made before its loop (the JAX
package's ``lax.fori_loop`` / ``lax.scan`` body). The step index j is an
int64 device tensor (the index type of ``index_copy_``); the step reads
and writes V, H, the recurrence records, the rolling window, ``broke``
and ``m_used`` through device indices (``index_select``,
``index_copy_``), every write masked by ``broke``. Arnoldi orthogonalizes
by classical Gram-Schmidt with batched dots (one GEMV for the
projections, CGS2 with ``reorth``) over a fixed-shape masked window, as
JAX's step does: with iop = 0 against all m + 1 basis rows under the mask
rows <= j, with iop > 0 against the ``win`` rows that end at j (a
gather).

``lanczos_coeffs`` / ``lanczos_replay`` and ``arnoldi_coeffs`` /
``arnoldi_replay`` are the storage-free pairs: pass 1 records the
recurrence (alpha, beta; or the compact Hessenberg of an IOP window)
without keeping the basis, pass 2 regenerates each basis vector from the
record and accumulates w = sum_j coeffs[j] v_j. The IOP pair keeps its
(win, n) window as a ring, v_j in slot j mod win; the compact Hessenberg
keeps JAX's column order (oldest to newest, then h_{j+1, j}), and both
passes subtract the projections in the ring's order, so pass 2 repeats
pass 1's arithmetic.

How the m steps run (``_run``). Step 0 runs first, on the caller's
stream, with its writes rebinding the state to new tensors (no tensor
that autograd saved is overwritten). The state it leaves decides the
rest, from the data: where a state tensor requires grad, is wrapped by
a ``torch.func`` transform or carries a forward-mode tangent (an
operand, the operator's own tensors, a parameter that a matrix-free
operator's function closes over), autograd must see every step, and
steps 1 .. m - 1 rebind too, eagerly, on the caller's stream. Otherwise
they write in place:

* on a CUDA device, through a ``utils/graphs.LoopRunner`` of the call's
  own: step 1 runs eagerly on the runner's side stream (the warm-up),
  step 2 is captured into a CUDA graph and every later step replays it
  (one capture and m - 2 graph launches for m >= 4, the captured
  execution being the first of them; m <= 3 runs eagerly). The graph is
  freed when the builder returns, its memory back in the pool that every
  runner shares (``utils/graphs.py``). A capture that fails raises a
  RuntimeError naming the builder and the operator class: a matvec must
  not read the device (no ``.item()``, ``float()``, ``bool()`` of a CUDA
  tensor, no tensor built from host data);
* inline, with no runner, where ``graphs.inline`` says so: inside a
  device driver's step (whose warm-up and capture then run the same
  kernels) and on a capturing stream;
* eagerly through a runner on the CPU, under ``graphs.eager()`` and for
  a row-sharded operator (its collectives cannot be captured).

The arithmetic is the same in every form. The step's bookkeeping (the
step counter and j + 1 as one (2,) tensor, ``broke``, ``m_used``, the
recurrence's last beta and vector) is written through the ops' ``out=``,
one kernel a value.

Batches (``expv_batched``; JAX vmaps these builders). Every builder but
``arnoldi_extend`` takes b as (n,) or as a (batch, n) block, whose rows
are independent subspaces built by one masked step over state with a
leading batch axis: V (batch, m + 1, n), H (batch, m + 1, m), the
records (batch, m), ``broke`` and ``m_used`` (batch,), every write masked
per row, so each row breaks down and stops counting at its own step, as
JAX's vmap gives it. The step index stays one shared device scalar. The
matvec is the operator's ``matmat`` on the whole block (``utils/linop``:
one K1 launch for a ``BandedOperator``), the dots and norms batched
reductions, one collective each over a row-sharded operator's axis. The
same step serves both: the scalar builder is the step with no batch axis
and keeps its operations (gemv, dot), the batched one takes batched
products (bmm), which sum in another order, so a batch of one agrees
with the scalar builder to rounding (tests/test_torch_batched_build.py
holds 1e-14), not bit for bit. A batched call runs through the same
``_run``: step 0 eagerly, one capture, then m - 2 replays a builder call,
whatever the batch.

The fused batched Lanczos step. Where ``_fused_ok`` holds (a
``BandedOperator``, a (batch, n) real float32/float64 block, no ``comm``,
no ``full_reorth``, nothing autograd must see), ``lanczos`` and
``lanczos_coeffs`` take ``_fused_lanczos_step`` instead: two kernels a
step on the card (K1's Lanczos form and K5, ``ops/kernels/
lanczos_step.py``), their plain twin on the CPU, and no torch op over the
(batch, n) block. Its state keeps the next vector before its
normalization (``vc`` as ``u``, with a per-row ``scale``) and v_j in
slots (V's rows, or a ring of two in place of ``vp``), so the
normalization and vp <- vc cost no pass; ``lanczos`` writes V's last row
after the loop. Every other batched or scalar case keeps the step above.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import graphs
from ..utils.comm import dots, operator_comm, vdot, vector_norm
from ..utils.linop import apply_rows
from ..utils.precision import full_precision

__all__ = ["KrylovBasis", "arnoldi", "arnoldi_extend", "lanczos",
           "lanczos_coeffs", "lanczos_replay", "arnoldi_coeffs",
           "arnoldi_replay", "expand_compact_hessenberg"]


@dataclasses.dataclass
class KrylovBasis:
    """Result of an Arnoldi or Lanczos factorization.

    V: (m+1, n) orthonormal basis, basis vectors as rows (zero past
       m_used after a happy breakdown).
    H: (m+1, m) Hessenberg (Arnoldi, in b's dtype) or real
       symmetric-tridiagonal-extended (Lanczos) matrix.
    beta: |b|_2 of the starting vector (0-d tensor).
    m_used: effective dimension (0-d int32 tensor).
    breakdown: whether a happy breakdown occurred (0-d bool tensor).
    hermitian: H is tridiagonal from a Lanczos recurrence.

    A batched build (module doc) carries a leading batch axis on each:
    V (batch, m+1, n), H (batch, m+1, m), beta, m_used and breakdown
    (batch,).
    """

    V: torch.Tensor
    H: torch.Tensor
    beta: torch.Tensor
    m_used: torch.Tensor
    breakdown: torch.Tensor
    hermitian: bool = False

    @property
    def m(self) -> int:
        return self.H.shape[-1]

    @property
    def n(self) -> int:
        return self.V.shape[-1]


def _real_dtype(dt):
    return torch.empty((), dtype=dt).real.dtype


def _col(x):
    """A per-row scalar as a column against the rows' vectors: x itself
    (0-d) in a scalar build, x[:, None] in a batched one."""
    return x[..., None] if x.ndim else x


def _norm(y, comm):
    """|y| (0-d), or each row's (batch,) of a (batch, n) block."""
    return vector_norm(y, comm, dim=-1 if y.ndim > 1 else None)


def _apply(op, x):
    """A x: ``matvec`` of a vector, ``matmat`` of a (batch, n) block."""
    return op.matvec(x) if x.ndim == 1 else apply_rows(op, x)


def _comb(h, V):
    """sum_i h[i] V[i] ((k,) against (k, n)), each row's in a batch."""
    return h @ V if h.ndim == 1 else (h.unsqueeze(-2) @ V).squeeze(-2)


def _at(x, jv, dim: int):
    """x's entry j along ``dim`` (the m axis), j the device index jv."""
    return x.index_select(dim, jv).select(dim, 0)


def _start(b, comm=None):
    """(beta0, v0): |b| and b/|b| (zero vector when b = 0), of each row of
    a (batch, n) b."""
    rdt = _real_dtype(b.dtype)
    beta0 = _norm(b, comm).to(rdt)
    inv = torch.where(beta0 > 0, 1.0 / torch.where(beta0 > 0, beta0, 1.0), 0.0)
    return beta0, (_col(inv) * b).to(b.dtype)


def _safe_normalize(y, nrm):
    return y / torch.where(nrm > 0, nrm, 1.0)


def _sees_grad(S) -> bool:
    """Whether autograd or a ``torch.func`` transform must see the loop
    (module doc): a state tensor requires grad, is wrapped by a transform
    or carries a forward-mode tangent."""
    return graphs.sees_grad(vars(S).values())


class _State:
    """A builder's loop state: tensors made before the loop, read by the
    step as attributes, and ``jj`` = (j, j + 1), the step counter. ``set``,
    ``put`` (an ``index_copy`` along ``dim``), ``put_at`` (an
    ``index_put``) and ``apply`` (the result of an op with ``out=``) write
    in place (what a CUDA graph replays), or with ``rebind`` (module doc)
    rebind the name to the new tensor. ``lead``: 1 for a batched build,
    whose tensors carry a leading batch axis (``put_at``'s indices then
    address the axes after it, for every row)."""

    def __init__(self, device, start: int = 0, lead: int = 0, **tensors):
        self.__dict__.update(tensors)
        self.jj = torch.arange(start, start + 2, device=device)
        self.zero = torch.zeros((), device=device)     # where's 0 for out=
        self.rebind = True
        self.lead = lead

    def set(self, name, value):
        old = getattr(self, name)
        if self.rebind:
            setattr(self, name, value.to(old.dtype))
        else:
            old.copy_(value)

    def put(self, name, dim: int, index, value):
        old = getattr(self, name)
        value = value.to(old.dtype)
        if self.rebind:
            setattr(self, name, old.index_copy(dim, index, value))
        else:
            old.index_copy_(dim, index, value)

    def put_at(self, name, indices, value):
        old = getattr(self, name)
        value = value.to(old.dtype)
        if self.lead:       # the batch axis last, so indices address the rest
            old, value = old.movedim(0, -1), value.movedim(0, -1)
        if self.rebind:
            new = old.index_put(indices, value)
            setattr(self, name, new.movedim(-1, 0) if self.lead else new)
        else:
            old.index_put_(indices, value)

    def apply(self, name, fn, *args):
        """name <- fn(*args), an elementwise op of name's shape."""
        old = getattr(self, name)
        if self.rebind:
            setattr(self, name, fn(*args).to(old.dtype))
        else:
            fn(*args, out=old)

    def step_on(self):
        """j <- j + 1 (the step's last write)."""
        self.apply("jj", torch.add, self.jj, 1)


def _run(what: str, op, S: _State, step, m: int, device):
    """Run ``step`` m times (module doc): step 0 rebinding, then the rest
    as its state says, inline, or through a runner of the call's own that
    captures and replays it where it can."""
    run_steps(f"{what} ({type(op).__name__})", S, step, m, device,
              sharded=operator_comm(op) is not None)


def run_steps(label: str, S: _State, step, m: int, device, *,
              sharded: bool = False):
    """``_run`` for a loop named ``label`` whose steps may make collectives
    (``sharded``): the polynomial actions' and the Taylor action's loops
    (``models/``) run this way too. The runner's key is m, its step
    ``"step"``."""
    if m <= 0:
        return
    S.rebind = True
    step()
    S.rebind = _sees_grad(S)
    if S.rebind or graphs.inline(device):
        for _ in range(m - 1):
            step()
        return
    if m == 1:
        return
    with graphs.LoopRunner(label, device, sharded=sharded) as runner:
        runner.repeat(m, "step", step, m - 1, last=True)


def _window_rows(m: int, win: int, device):
    """(m, win): the basis rows of step j's IOP window, clip(j - win + 1,
    0, m + 1 - win) + arange(win) (unused when win >= m)."""
    j = torch.arange(m, device=device)[:, None]
    return (torch.clamp(j - win + 1, 0, max(m + 1 - win, 0))
            + torch.arange(min(win, m + 1), device=device))


def _arnoldi_step(op, S: _State, m: int, win: int, tol: float,
                  reorth: bool, comm=None):
    """The Arnoldi step (JAX's ``_arnoldi_step_fn``) on the state S (V,
    H, broke, m_used, rows, wins: ``_window_rows``): CGS (CGS2 with
    ``reorth``) against the masked window, then column j of H and row
    j + 1 of V. With
    ``comm`` (a ``parallel.MeshAxis``) V holds this rank's rows, and each
    CGS pass and the norm cost one psum."""

    L = S.lead

    def step():
        V = S.V
        jv, j1v = S.jj[:1], S.jj[1:]
        j, j1 = jv[0], j1v[0]
        dt = V.dtype
        rdt = _real_dtype(dt)
        y = _apply(op, _at(V, jv, L)).to(dt)
        if win < m:
            # true IOP: the win rows ending at j (JAX's dynamic slice at
            # clip(j - win + 1, 0, m + 1 - win)), a gather (O(win n))
            idx = S.wins.index_select(0, jv)[0]
            Vw = V.index_select(L, idx)
            wmask = idx <= j
            hw = torch.where(wmask, dots(Vw, y, comm), 0)
            y = y - _comb(hw, Vw)
            if reorth:
                hw2 = torch.where(wmask, dots(Vw, y, comm), 0)
                y = y - _comb(hw2, Vw)
                hw = hw + hw2
        else:
            # JAX's mask also asks rows > j - win, which every row meets
            # when win >= m
            mask = S.rows <= j
            h = torch.where(mask, dots(V, y, comm), 0)
            y = y - _comb(h, V)
            if reorth:
                h2 = torch.where(mask, dots(V, y, comm), 0)
                y = y - _comb(h2, V)
                h = h + h2
        nrm = _norm(y, comm).to(rdt)
        active = ~S.broke
        if win < m:
            # column j is zero but for the window and row j + 1, which is
            # written last (JAX writes the whole column from such an h)
            S.put_at("H", (idx, j.expand(win)),
                     torch.where(_col(active), hw, 0))
            S.put_at("H", (j1v, jv),
                     torch.where(active, nrm, 0).unsqueeze(-1))
        else:
            h = torch.where(S.rows == j1, _col(nrm).to(dt), h)
            S.put("H", L + 1, jv, torch.where(_col(active), h, 0)[..., None])
        S.apply("broke", torch.logical_or, S.broke, nrm < tol)
        S.put("V", L, j1v, torch.where(
            _col(S.broke), 0.0, _safe_normalize(y, _col(nrm))).unsqueeze(L))
        S.apply("m_used", torch.where, active, j1, S.m_used)
        S.step_on()

    return step


@full_precision
def arnoldi(op, b, m: int, *, iop: int = 0, tol: float = 1e-7,
            reorth: bool = True) -> KrylovBasis:
    """Arnoldi factorization A V[j] ~ sum_i H[i, j] V[i] with (incomplete)
    classical Gram-Schmidt (module doc).

    iop: incomplete-orthogonalization window; 0 = full.
    tol: happy-breakdown threshold on the residual norm.
    reorth: a second CGS pass (CGS2); False for the cheapest (IOP-style)
      iteration.

    A row-sharded ``op`` (one that carries ``comm``, the
    ``parallel.MeshAxis`` of its rows: ``utils.comm.operator_comm``) takes
    this rank's rows of b, and the basis holds this rank's rows; each CGS
    pass and each norm then costs one psum. Every builder below reads the
    axis from its operator the same way. A (batch, n) b builds each row's
    subspace (module doc)."""
    comm = operator_comm(op)
    n, dev, lead = b.shape[-1], b.device, b.shape[:-1]
    beta, v0 = _start(b, comm)
    V = torch.zeros(lead + (m + 1, n), dtype=b.dtype, device=dev)
    V[..., 0, :] = v0
    win = m if iop == 0 else iop
    S = _State(dev, lead=len(lead), V=V,
               H=torch.zeros(lead + (m + 1, m), dtype=b.dtype, device=dev),
               broke=beta == 0,
               m_used=torch.zeros(lead, dtype=torch.int64, device=dev),
               rows=torch.arange(m + 1, device=dev),
               wins=_window_rows(m, win, dev))
    _run("arnoldi", op, S, _arnoldi_step(op, S, m, win, tol, reorth, comm),
         m, dev)
    m_used = torch.where(beta == 0, 0, S.m_used).to(torch.int32)
    return KrylovBasis(V=S.V, H=S.H, beta=beta, m_used=m_used,
                       breakdown=S.broke, hermitian=False)


@full_precision
def arnoldi_extend(op, Ks: KrylovBasis, m_new: int, *, iop: int = 0,
                   tol: float = 1e-7, reorth: bool = True) -> KrylovBasis:
    """Extend an Arnoldi factorization from m to ``m_new`` without
    repeating the first m matvecs: the kept rows and entries are copied
    into the larger buffers and the iteration continues from step m (the
    step counter starts at m)."""
    comm = operator_comm(op)
    m_old = Ks.m
    if m_new <= m_old:
        raise ValueError(f"m_new={m_new} must exceed current m={m_old}")
    if Ks.hermitian:
        raise ValueError("arnoldi_extend requires an Arnoldi (non-Lanczos) "
                         "basis")
    dev = Ks.V.device
    V = torch.zeros((m_new + 1, Ks.n), dtype=Ks.V.dtype, device=dev)
    V[:m_old + 1] = Ks.V
    H = torch.zeros((m_new + 1, m_new), dtype=Ks.H.dtype, device=dev)
    H[:m_old + 1, :m_old] = Ks.H
    win = m_new if iop == 0 else iop
    S = _State(dev, m_old, V=V, H=H,
               broke=Ks.breakdown.clone(),
               m_used=Ks.m_used.to(torch.int64, copy=True),
               rows=torch.arange(m_new + 1, device=dev),
               wins=_window_rows(m_new, win, dev))
    _run("arnoldi_extend", op, S,
         _arnoldi_step(op, S, m_new, win, tol, reorth, comm),
         m_new - m_old, dev)
    return KrylovBasis(V=S.V, H=S.H, beta=Ks.beta,
                       m_used=S.m_used.to(torch.int32), breakdown=S.broke,
                       hermitian=False)


def _lanczos_state(b, comm, **tensors):
    """(beta0, the state of a Lanczos recurrence: vp, vc, bprev, broke,
    m_used and ``tensors``), per row of a (batch, n) b."""
    rdt = _real_dtype(b.dtype)
    lead = b.shape[:-1]
    beta0, v0 = _start(b, comm)
    S = _State(b.device, lead=len(lead), vp=torch.zeros_like(v0), vc=v0,
               bprev=torch.zeros(lead, dtype=rdt, device=b.device),
               broke=beta0 == 0,
               m_used=torch.zeros(lead, dtype=torch.int64, device=b.device),
               **tensors)
    return beta0, S


@full_precision
def lanczos(op, b, m: int, *, tol: float = 1e-7,
            full_reorth: bool = False) -> KrylovBasis:
    """Hermitian Lanczos three-term recurrence. H is real (alpha on the
    diagonal, beta on the sub- and superdiagonal). ``full_reorth=True``
    re-orthogonalizes each step against the whole basis (one GEMV under
    the mask rows <= j). A sharded ``op`` (``arnoldi``): a psum for alpha
    and one for the norm per step, one more with ``full_reorth``. A
    (batch, n) b: each row's (module doc)."""
    comm = operator_comm(op)
    n, dt, dev, lead = b.shape[-1], b.dtype, b.device, b.shape[:-1]
    rdt = _real_dtype(dt)
    V = torch.zeros(lead + (m + 1, n), dtype=dt, device=dev)
    beta0, S = _lanczos_state(
        b, comm, V=V,
        alphas=torch.zeros(lead + (m,), dtype=rdt, device=dev),
        betas=torch.zeros(lead + (m,), dtype=rdt, device=dev),
        rows=torch.arange(m + 1, device=dev))
    V[..., 0, :] = S.vc
    step = _lanczos_step(op, S, tol, comm, full_reorth)
    _run("lanczos", op, S, step, m, dev)
    if hasattr(step, "finish"):
        step.finish()
    m_used = torch.where(beta0 == 0, 0, S.m_used).to(torch.int32)

    H = torch.zeros(lead + (m + 1, m), dtype=rdt, device=dev)
    di = torch.arange(m, device=dev)
    H[..., di, di] = S.alphas
    H[..., di + 1, di] = S.betas
    if m >= 2:
        H[..., di[:-1], di[:-1] + 1] = S.betas[..., :-1]
    return KrylovBasis(V=S.V, H=H, beta=beta0, m_used=m_used,
                       breakdown=S.broke, hermitian=True)


def _fused_ok(op, S: _State, comm, full_reorth) -> bool:
    """The gate of the fused batched Lanczos step (module doc): a
    ``BandedOperator`` (whose ``matmat`` is K1 on CUDA), a (batch, n)
    block, no ``comm``, no ``full_reorth``, a real float32/float64 block
    within ``lanczos_step.pair_ok``'s shapes, and nothing that autograd or
    a ``torch.func`` transform must see (the grad rule of
    ``utils/graphs``, on the block and the diagonals)."""
    from .kernels.lanczos_step import pair_ok
    from .sparse import BandedOperator

    return (comm is None and not full_reorth and S.lead == 1
            and isinstance(op, BandedOperator) and pair_ok(op, S.vc)
            and not graphs._sees_grad_now([S.vc, op.diags]))


def _fused_lanczos_step(op, S: _State, tol: float, basis: bool):
    """The fused step (``ops/kernels/lanczos_step.py``) on S: ``vc`` (v_0,
    made contiguous: a transposed b gives a strided one) becomes the
    pair's ``u``, ``scale`` 1; the slots are V (``basis``) or
    a (batch, 2, n) ring in place of ``vp``. The counter advances in place
    (the pair's descriptor holds it). With ``basis`` the step carries
    ``finish``, which writes V's last row after the loop."""
    from .kernels.lanczos_step import LanczosPair

    u = S.vc = S.vc.contiguous()
    S.scale = torch.ones(u.shape[0], dtype=u.dtype, device=u.device)
    if basis:
        slots, nslots = S.V, 0
    else:
        slots, nslots = torch.zeros((u.shape[0], 2, u.shape[1]),
                                    dtype=u.dtype, device=u.device), 2
    S.vp = slots
    pair = LanczosPair(op, u, S.scale, slots, nslots, S.alphas, S.betas,
                       S.bprev, S.broke, S.m_used, S.jj, tol)

    def step():
        pair()
        S.jj.add_(1)

    if basis:
        def finish():
            S.V.select(1, -1).copy_(pair.last_row())
        step.finish = finish
    return step


def _lanczos_step(op, S: _State, tol: float, comm, full_reorth=None):
    """The Lanczos step on S (``_lanczos_state``): alpha_j and beta_j
    recorded, v_{j+1} into ``vc`` (and row j + 1 of V where S keeps the
    basis: ``full_reorth`` not None). Where ``_fused_ok`` holds, the fused
    step (``_fused_lanczos_step``) instead; the builder then calls its
    ``finish``, where it has one, after the loop."""

    if _fused_ok(op, S, comm, full_reorth):
        return _fused_lanczos_step(op, S, tol, full_reorth is not None)
    L = S.lead

    def step():
        vp, vc = S.vp, S.vc
        jv, j1v = S.jj[:1], S.jj[1:]
        rdt = S.bprev.dtype
        y = _apply(op, vc)
        alpha = vdot(vc, y, comm).real.to(rdt)
        y = y - _col(alpha) * vc
        y = y - _col(S.bprev) * vp
        if full_reorth:
            h2 = torch.where(S.rows <= jv[0], dots(S.V, y, comm), 0)
            y = y - _comb(h2, S.V)
        nrm = _norm(y, comm).to(rdt)
        active = ~S.broke
        S.put("alphas", L, jv, torch.where(active, alpha, 0.0).unsqueeze(-1))
        S.apply("bprev", torch.where, active, nrm, S.zero)
        S.put("betas", L, jv, S.bprev.unsqueeze(-1))
        S.apply("broke", torch.logical_or, S.broke, nrm < tol)
        S.set("vp", vc)
        S.apply("vc", torch.where, _col(S.broke), S.zero,
                _safe_normalize(y, _col(nrm)))
        if full_reorth is not None:
            S.put("V", L, j1v, S.vc.unsqueeze(L))
        S.apply("m_used", torch.where, active, j1v[0], S.m_used)
        S.step_on()

    return step


@full_precision
def lanczos_coeffs(op, b, m: int, *, tol: float = 1e-7):
    """Pass 1 of storage-free Lanczos: (alphas, betas, beta0, m_used,
    breakdown) without keeping the basis. A sharded ``op``: as in
    ``lanczos``. A (batch, n) b: each row's, (batch, m) records."""
    comm = operator_comm(op)
    dev, lead = b.device, b.shape[:-1]
    rdt = _real_dtype(b.dtype)
    beta0, S = _lanczos_state(
        b, comm, alphas=torch.zeros(lead + (m,), dtype=rdt, device=dev),
        betas=torch.zeros(lead + (m,), dtype=rdt, device=dev))
    _run("lanczos_coeffs", op, S, _lanczos_step(op, S, tol, comm), m, dev)
    m_used = torch.where(beta0 == 0, 0, S.m_used).to(torch.int32)
    return S.alphas, S.betas, beta0, m_used, S.broke


def _term(v, cj, cdt):
    """cj v: (n,) with a scalar cj, (n, p) with a (p,) row; each row's of
    a (batch, n) v, with cj (batch,) or (batch, p)."""
    if cj.ndim == v.ndim - 1:
        return _col(cj) * v.to(cdt)
    return v.to(cdt)[..., :, None] * cj[..., None, :]


@full_precision
def lanczos_replay(op, b, coeffs, alphas, betas, m: int):
    """Pass 2 of storage-free Lanczos: w = sum_j coeffs[j] v_j, each v_j
    regenerated from the recorded (alpha, beta) by the same recurrence as
    pass 1, with coeffs[j], alphas[j] and betas[j - 1] read through the
    step counter. ``coeffs`` (m,) gives w (n,); (m, p) gives w (n, p).
    A sharded ``op``: one psum, the norm of b. A (batch, n) b: each row's
    with its own record and coefficients (batch, m) or (batch, m, p)."""
    comm = operator_comm(op)
    dt, dev = b.dtype, b.device
    rdt = _real_dtype(dt)
    L = b.ndim - 1
    _, v0 = _start(b, comm)
    # the common type of the basis and the coefficients: a complex b
    # with real coefficients keeps its imaginary part
    cdt = torch.promote_types(coeffs.dtype, dt)
    coeffs = coeffs.to(cdt)
    # beta_{j-1}, 0 at j = 0
    bprevs = torch.cat([torch.zeros_like(betas[..., :1]), betas[..., :-1]],
                       -1)
    S = _State(dev, lead=L, vp=torch.zeros_like(v0), vc=v0,
               w=torch.zeros(v0.shape + coeffs.shape[L + 1:], dtype=cdt,
                             device=dev))

    def step():
        vp, vc = S.vp, S.vc
        jv = S.jj[:1]
        S.apply("w", torch.add, S.w, _term(vc, _at(coeffs, jv, L), cdt))
        y = _apply(op, vc)
        y = y - _col(_at(alphas, jv, L).to(rdt)) * vc
        y = y - _col(_at(bprevs, jv, L).to(rdt)) * vp
        bj = _col(_at(betas, jv, L))
        S.set("vp", vc)
        S.apply("vc", torch.where, bj > 0, _safe_normalize(y, bj), S.zero)
        S.step_on()

    _run("lanczos_replay", op, S, step, m, dev)
    return S.w


def _ring_tables(m: int, win: int, device):
    """The IOP ring's index tables (module doc): ``ring`` (m + 2,), the slot
    j mod win of v_j; per step j (m, win): ``valid`` whether slot s holds a
    basis vector (j - ((j - s) mod win) >= 0), ``oldest`` the slots from the
    oldest window vector to the newest ((j + 1 + k) mod win), and
    ``cols`` the compact column of each slot (win - 1 - ((j - s) mod
    win))."""
    j = torch.arange(m, device=device)[:, None]
    s = torch.arange(win, device=device)
    back = torch.remainder(j - s, win)
    return dict(ring=torch.remainder(torch.arange(m + 2, device=device), win),
                valid=back <= j, oldest=torch.remainder(j + 1 + s, win),
                cols=(win - 1) - back)


@full_precision
def arnoldi_coeffs(op, b, m: int, win: int, *, tol: float = 1e-7):
    """Pass 1 of storage-free IOP Arnoldi: the compact Hessenberg without
    the basis. The IOP recurrence only reads the last ``win`` basis
    vectors, so the loop keeps a (win, n) ring (module doc).

    Returns (Hc, beta0, m_used, breakdown) with Hc (m, win+1) compact
    columns: Hc[j, :win] the projections onto the window rows (oldest to
    newest) and Hc[j, win] = h_{j+1, j}. A sharded ``op``: as in
    ``arnoldi``. A (batch, n) b: each row's, Hc (batch, m, win+1)."""
    comm = operator_comm(op)
    n, dt, dev, lead = b.shape[-1], b.dtype, b.device, b.shape[:-1]
    rdt = _real_dtype(dt)
    L = len(lead)
    beta0, v0 = _start(b, comm)
    W = torch.zeros(lead + (win, n), dtype=dt, device=dev)
    W[..., 0, :] = v0
    S = _State(dev, lead=L, W=W,
               Hc=torch.zeros(lead + (m, win + 1), dtype=dt, device=dev),
               broke=beta0 == 0,
               m_used=torch.zeros(lead, dtype=torch.int64, device=dev),
               **_ring_tables(m, win, dev))

    def step():
        W = S.W
        jv, j1 = S.jj[:1], S.jj[1]
        slot = S.ring.index_select(0, S.jj)     # the slots of v_j, v_{j+1}
        y = _apply(op, _at(W, slot[:1], L)).to(dt)
        h = torch.where(S.valid.index_select(0, jv)[0], dots(W, y, comm), 0)
        y = y - _comb(h, W)
        nrm = _norm(y, comm).to(rdt)
        active = ~S.broke
        hc = torch.cat([h.index_select(-1, S.oldest.index_select(0, jv)[0]),
                        nrm.to(dt).unsqueeze(-1)], -1)
        S.put("Hc", L, jv, torch.where(_col(active), hc, 0).unsqueeze(L))
        S.apply("broke", torch.logical_or, S.broke, nrm < tol)
        S.put("W", L, slot[1:], torch.where(
            _col(S.broke), 0.0, _safe_normalize(y, _col(nrm))).unsqueeze(L))
        S.apply("m_used", torch.where, active, j1, S.m_used)
        S.step_on()

    _run("arnoldi_coeffs", op, S, step, m, dev)
    m_used = torch.where(beta0 == 0, 0, S.m_used).to(torch.int32)
    return S.Hc, beta0, m_used, S.broke


def expand_compact_hessenberg(Hc, win: int):
    """(m, win+1) compact columns to the full (m+1, m) banded Hessenberg
    (each row's of a (batch, m, win+1) Hc)."""
    m = Hc.shape[-2]
    H = torch.zeros(Hc.shape[:-2] + (m + 1, m), dtype=Hc.dtype,
                    device=Hc.device)
    for j in range(m):
        lo = max(0, j - win + 1)
        H[..., lo:j + 1, j] = Hc[..., j, win - (j + 1 - lo):win]
        H[..., j + 1, j] = Hc[..., j, win]
    return H


@full_precision
def arnoldi_replay(op, b, coeffs, Hc, m: int, win: int, *, final_coeff=None,
                   with_final: bool = False):
    """Pass 2: w = sum_j coeffs[j] v_j, regenerating the IOP basis from the
    recorded compact Hessenberg by the same recurrence as pass 1 (coeffs[j]
    and Hc[j] read through the step counter). coeffs (m,) or (m, p). With
    ``with_final=True``, ``final_coeff`` also weights the (m+1)-th vector
    v_m. A sharded ``op``: one psum, the norm of b. A (batch, n) b: each
    row's, with Hc (batch, m, win+1) and coeffs (batch, m) or (batch, m,
    p)."""
    comm = operator_comm(op)
    n, dt, dev, lead = b.shape[-1], b.dtype, b.device, b.shape[:-1]
    rdt = _real_dtype(dt)
    L = len(lead)
    _, v0 = _start(b, comm)
    W = torch.zeros(lead + (win, n), dtype=dt, device=dev)
    W[..., 0, :] = v0
    cdt = torch.promote_types(coeffs.dtype, dt)
    coeffs = coeffs.to(cdt)
    S = _State(dev, lead=L, W=W,
               w=torch.zeros(lead + (n,) + tuple(coeffs.shape[L + 1:]),
                             dtype=cdt, device=dev),
               **_ring_tables(m, win, dev))

    def step():
        W = S.W
        jv = S.jj[:1]
        slot = S.ring.index_select(0, S.jj)
        vc = _at(W, slot[:1], L)
        S.apply("w", torch.add, S.w, _term(vc, _at(coeffs, jv, L), cdt))
        y = _apply(op, vc).to(dt)
        hrow = _at(Hc, jv, L)
        # the projections in the ring's order
        h = hrow.index_select(-1, S.cols.index_select(0, jv)[0])
        y = y - _comb(h.to(dt), W)
        nrm = _col(hrow[..., win].real.to(rdt))
        S.put("W", L, slot[1:], torch.where(
            nrm > 0, _safe_normalize(y, nrm), 0.0).unsqueeze(L))
        S.step_on()

    _run("arnoldi_replay", op, S, step, m, dev)
    w = S.w
    if with_final:
        w = w + _term(S.W.select(L, m % win), torch.as_tensor(
            final_coeff, dtype=cdt, device=dev), cdt)
    return w

"""The fused batched Lanczos step on a banded operator: K1's Lanczos form
(pass A, ``csrc/spmv.cu``) and K5 (pass B, ``csrc/lanczos_step.cu``), the
step of ``ops/krylov.py``'s batched ``lanczos`` and ``lanczos_coeffs``
where ``krylov._fused_ok`` lets it run.

The JAX package vmaps its Lanczos step (``models/expv._batched_build``),
and XLA fuses the step's elementwise tail into a few loops. The port's
plain step runs it as torch ops, about eleven passes over the (batch, n)
block a step. The pair makes two, with the state laid out for them:

* ``u`` (batch, n) holds the next vector before its normalization and
  ``scale`` (batch,) the reciprocal of its norm (1 where the norm is 0),
  so v_j = u scale where the row has not broken down, else 0: pass A
  reads u times scale, and the normalization costs no pass of its own;
* pass A writes v_j to its slot (row j of the basis V (batch, m + 1, n)
  in ``lanczos``, slot j mod 2 of a (batch, 2, n) ring in
  ``lanczos_coeffs``: v_{j-1} is the other slot, so vp <- vc is no copy)
  and alpha_j = v_j . A v_j (batch,);
* K5 recomputes A v_j, writes u = A v_j - alpha_j v_j - beta_{j-1}
  v_{j-1} and the step's (batch,) records: ``alphas[:, j]``,
  ``betas[:, j]``, ``bprev``, ``broke``, ``m_used``, ``scale``, as the
  plain step writes them. The builder then advances its counter (j, j + 1)
  in place, and ``lanczos`` writes the last basis row v_m = u scale after
  its loop (``finish``).

Both kernels read j from the counter on the device, allocate nothing
(the partials, alpha and the ticket of their last-block sums are made
with the state, before the loop) and read nothing to the host, so the
step is captured once and replayed. Their per-row sums are fixed-order
(no float atomics): the bits repeat from run to run.

``lanczos_pair_ref`` is the pair's plain twin, one step as torch ops on
the same state: ``spmm_alpha_ref`` (K1's Lanczos form) then
``lanczos_update_ref`` (K5). ``LanczosPair`` runs the twin for CPU tensors (the CPU
tests reach the fused step's control flow through it) and launches the
pair for CUDA tensors, or raises: there is no fallback from a CUDA tensor
to the twin.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .spmv import banded_spmv_ref

__all__ = ["LanczosPair", "lanczos_pair_ref", "spmm_alpha_ref",
           "lanczos_update_ref", "pair_ok", "MAX_BATCH"]

# rows of a fused step: the kernels keep 8 warps x batch partials in the
# default 48 KB of shared memory
MAX_BATCH = 512


def pair_ok(op, vc) -> bool:
    """The operands the pair takes (``krylov._fused_ok`` adds the rest of
    the gate): a (batch, n) real float32/float64 block on the CPU or a
    CUDA device, the operator's diagonals on the same device and of a dtype
    that promotes to the block's, 1 <= batch <= ``MAX_BATCH`` and 1 <= k
    <= ``_build.MAX_POINTS`` diagonals."""
    return (vc.dim() == 2 and vc.dtype in _build.KERNEL_DTYPES
            and vc.device.type in ("cpu", "cuda")
            and op.diags.device == vc.device
            and torch.promote_types(op.dtype, vc.dtype) == vc.dtype
            and 1 <= vc.shape[0] <= MAX_BATCH and vc.shape[1] >= 1
            and 1 <= len(op.offsets) <= _build.MAX_POINTS)


def spmm_alpha_ref(diags, offsets, u, scale, broke):
    """Plain twin of K1's Lanczos form: (v_j, alpha_j) with v_j = u scale
    (0 where ``broke``) and alpha_j = v_j . A v_j (batch,)."""
    vc = torch.where(broke[:, None], 0.0, u * scale[:, None])
    return vc, torch.linalg.vecdot(vc, banded_spmv_ref(diags, offsets, vc))


def lanczos_update_ref(diags, offsets, vc, vp, alpha, bprev, broke, m_used,
                       j1, tol: float):
    """Plain twin of K5: (u', alpha_j, beta_j (= bprev'), broke', m_used',
    scale') from v_j ``vc``, v_{j-1} ``vp`` (any finite rows at j = 0,
    where ``bprev`` is 0) and pass A's ``alpha``; ``j1`` is j + 1 (a 0-d
    int64 tensor). A row broken down before the step keeps u' = 0, its
    records at 0 and scale' = 1."""
    y = banded_spmv_ref(diags, offsets, vc)
    y = y - alpha[:, None] * vc
    y = y - bprev[:, None] * vp
    active = ~broke
    nrm = torch.where(active, torch.linalg.vector_norm(y, dim=-1), 0.0)
    return (torch.where(active[:, None], y, 0.0),
            torch.where(active, alpha, 0.0), nrm, broke | (nrm < tol),
            torch.where(active, j1, m_used),
            1.0 / torch.where(nrm > 0, nrm, 1.0))


def lanczos_pair_ref(diags, offsets, u, scale, vp, bprev, broke, m_used,
                     j1, tol: float):
    """Plain twin of the pair: one batched Lanczos step on the pair's
    state (module doc), ``spmm_alpha_ref`` then ``lanczos_update_ref``.
    Returns (v_j, u', alpha_j, beta_j (= bprev'), broke', m_used',
    scale')."""
    vc, alpha = spmm_alpha_ref(diags, offsets, u, scale, broke)
    return (vc,) + lanczos_update_ref(diags, offsets, vc, vp, alpha, bprev,
                                      broke, m_used, j1, tol)


class _LanczosLaunch(ctypes.Structure):
    """``eu::LanczosLaunch`` (csrc/banded_rows.cuh): what both kernels of
    the pair read on the host, built once a builder call."""
    _fields_ = [("diags", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("blo", ctypes.c_longlong), ("bhi", ctypes.c_longlong),
                ("k", ctypes.c_int), ("o", ctypes.c_int * _build.MAX_POINTS),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("urow", ctypes.c_longlong), ("vrow", ctypes.c_longlong),
                ("vslot", ctypes.c_longlong), ("nslots", ctypes.c_int),
                ("batch", ctypes.c_int), ("m", ctypes.c_int),
                ("zc", ctypes.c_int), ("alpha", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("bprev", ctypes.c_void_p),
                ("broke", ctypes.c_void_p), ("m_used", ctypes.c_void_p),
                ("alphas", ctypes.c_void_p), ("betas", ctypes.c_void_p),
                ("partial", ctypes.c_void_p), ("ticket", ctypes.c_void_p),
                ("jj", ctypes.c_void_p), ("tol", ctypes.c_double),
                ("grid_alpha", ctypes.c_int), ("grid_update", ctypes.c_int)]


class LanczosPair:
    """One builder call's fused step (module doc) over the state tensors it
    is given, written in place: ``u``, ``scale`` (batch,), ``slots``
    (batch, s, n) with ``nslots`` 0 (a basis: v_j in slot j) or 2 (a
    ring), ``alphas``, ``betas`` (batch, m), ``bprev``, ``broke`` (bool),
    ``m_used`` (int64) (batch,), and the counter ``jj`` (2,) int64 = (j,
    j + 1), which the caller advances. On CUDA the pair's scratch and
    launch descriptor are made here; ``plain_step`` runs the twin on the
    same state on any device."""

    def __init__(self, op, u, scale, slots, nslots: int, alphas, betas,
                 bprev, broke, m_used, jj, tol: float):
        self.op, self.offsets = op, tuple(op.offsets)
        self.u, self.scale, self.slots, self.nslots = u, scale, slots, nslots
        self.alphas, self.betas, self.bprev = alphas, betas, bprev
        self.broke, self.m_used, self.jj, self.tol = broke, m_used, jj, tol
        self.kernel = u.device.type == "cuda"
        if self.kernel:
            self._build_launch()

    def _build_launch(self):
        """The pair's scratch, descriptor and entry points (CUDA only: the
        plan refuses another device)."""
        u, slots, alphas = self.u, self.slots, self.alphas
        scale, betas, bprev, broke = self.scale, self.betas, self.bprev, self.broke
        m_used, jj, nslots = self.m_used, self.jj, self.nslots
        for t in (u, scale, slots, alphas, betas, bprev, broke, m_used, jj):
            if t.device != u.device or not t.is_contiguous():
                raise ValueError("LanczosPair: every state tensor must be "
                                 "contiguous on the block's device")
        batch, n = u.shape
        m = alphas.shape[-1]
        want = ((scale, (batch,), u.dtype), (bprev, (batch,), u.dtype),
                (alphas, (batch, m), u.dtype), (betas, (batch, m), u.dtype),
                (broke, (batch,), torch.bool),
                (m_used, (batch,), torch.int64), (jj, (2,), torch.int64))
        if (not pair_ok(self.op, u) or slots.dtype != u.dtype
                or slots.dim() != 3 or slots.shape[::2] != (batch, n)
                or nslots not in (0, 2) or slots.shape[1] < (nslots or m + 1)
                or any(t.shape != sh or t.dtype != dt for t, sh, dt in want)):
            raise ValueError("LanczosPair: the state's shapes or dtypes do "
                             "not match a (batch, n) block (module doc)")
        plan = self.op.plan(u.dtype, u.device)     # B7's checks and diagonals
        self.plan = plan
        dt = u.dtype
        self.alpha = torch.zeros(batch, dtype=dt, device=u.device)
        self.ticket = torch.zeros(2, dtype=torch.int32, device=u.device)
        zc = self.offsets.index(0) if 0 in self.offsets else -1
        L = plan.launch
        d = _LanczosLaunch(
            L.diags, n, L.blo, L.bhi, L.k, L.o, u.data_ptr(),
            slots.data_ptr(), u.stride(0), slots.stride(0), slots.stride(1),
            nslots, batch, m, zc, self.alpha.data_ptr(),
            scale.data_ptr(), bprev.data_ptr(), broke.data_ptr(),
            m_used.data_ptr(), alphas.data_ptr(), betas.data_ptr(), None,
            self.ticket.data_ptr(), jj.data_ptr(), float(self.tol), 0, 0)
        lib, suf = _build.library(), _build.suffix(dt)
        for query in (f"eu_banded_spmm_alpha_grid_{suf}",
                      f"eu_lanczos_update_grid_{suf}"):
            code = getattr(lib, query)(ctypes.addressof(d))
            if code:
                _build.check(code, f"fused Lanczos step ({query})")
        grid = max(d.grid_alpha, d.grid_update, 1)
        self.partial = torch.zeros((grid, batch), dtype=dt, device=u.device)
        d.partial = self.partial.data_ptr()
        self.launch, self.addr = d, ctypes.addressof(d)
        self.fa = getattr(lib, f"eu_banded_spmm_alpha_{suf}")
        self.fu = getattr(lib, f"eu_lanczos_update_{suf}")

    def _slot(self, jv):
        return jv if self.nslots == 0 else torch.remainder(jv, self.nslots)

    def __call__(self):
        """One step: the pair's two launches on the current stream (CUDA),
        or the twin (CPU)."""
        if not self.kernel:
            return self.plain_step()
        stream = _build.raw_stream(self.u.device)
        code = self.fa(self.addr, stream)
        if code:
            _build.check(code, "K1's Lanczos form (fused Lanczos step)")
        _build.launches["banded_spmm_alpha"] += 1
        code = self.fu(self.addr, stream)
        if code:
            _build.check(code, "K5 (fused Lanczos step)")
        _build.launches["lanczos_update"] += 1

    def plain_step(self):
        """The twin's step on the state (module doc), written in place."""
        jv = self.jj[:1]
        prev = (torch.clamp(jv - 1, min=0) if self.nslots == 0
                else torch.remainder(jv + 1, self.nslots))
        vp = self.slots.index_select(1, prev).squeeze(1)
        vc, u, a, b, br, mu, sc = lanczos_pair_ref(
            self.op.diags, self.offsets, self.u, self.scale, vp, self.bprev,
            self.broke, self.m_used, self.jj[1], self.tol)
        self.slots.index_copy_(1, self._slot(jv), vc.unsqueeze(1))
        self.u.copy_(u)
        self.alphas.index_copy_(1, jv, a.unsqueeze(1).to(self.alphas.dtype))
        self.betas.index_copy_(1, jv, b.unsqueeze(1).to(self.betas.dtype))
        self.bprev.copy_(b)
        self.broke.copy_(br)
        self.m_used.copy_(mu)
        self.scale.copy_(sc)

    def last_row(self):
        """v = u scale (0 where broken down): the basis row after the last
        step."""
        return torch.where(self.broke[:, None], 0.0,
                           self.u * self.scale[:, None])

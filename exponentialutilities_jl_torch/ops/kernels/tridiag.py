"""R1: the Hermitian reduced exponential ``s Q exp(t Lambda) Q^T e1`` of a
real symmetric tridiagonal T = Q Lambda Q^T (diagonal ``alphas`` (m,),
off-diagonal ``betas`` (m - 1,)), a kernel of the port only.

Every Hermitian Krylov path of ``models/expv.py`` ends in this m-sized
problem: the basis path (``_exp_reduced_e1``, s = 1), the two-pass
coefficients (``_lanczos_reduced_coeffs``, s = beta0) and each step of
the error-estimate loop. The JAX package evaluates it with XLA's eigh
inside its compiled programs; on the card ``torch.linalg.eigh`` reads its
info to the host, so a call through it cannot be captured into a CUDA
graph. ``tridiag_exp_e1`` is R1's one dispatcher: it launches the
hand-written kernel for CUDA tensors and raises if the build or the launch
fails. The kernel (``csrc/tridiag.cu``, one block) is Cuppen's divide and
conquer on the leading unreduced block only (out[n:] = 0 past the first
negligible coupling, so the error-estimate loop's masked step j costs
order j + 1): a tear down to leaves of one row, then one merge level at a
time (a rank sort, ``dlaed2``'s deflation, one secular root a thread kept
as a pole and an offset, Gu and Eisenstat's recomputed z), the first and
last rows carried up, and s e^{t lambda} (Q^T e1) carried down through the
levels, with no eigenvector matrix formed. ``tests/test_torch_tridiag_dc.py``
holds a numpy model of these steps against scipy on the hard inputs of
``tests/tridiag_cases.py``. On CPU tensors, and for calls that autograd or
a ``torch.func`` transform must see (the grad rule of
``ops/kernels/dispatch.py``, counted in its ``grad_gated``), the wrapper
runs the plain twin ``tridiag_exp_e1_ref``, the eigh formula, which has
eigh's gradient. t (a number or a 0-d tensor) becomes a 0-d tensor on the
diagonals' device without a host-to-device copy (``scalar_operand``), and
s is a 0-d tensor there: the kernel reads both from device memory, so a
captured launch reads each replay's values.

``tridiag_exp_e1_batched`` is K2, the batched form (``expv_batched``'s
reduced exponentials): one launch, one block a row running R1's body on
its own row, so each row's result is R1's on that row; its twin
``tridiag_exp_e1_batched_ref`` is the batched eigh formula.
"""

from __future__ import annotations

import math

import torch

from ...utils.graphs import sees_grad
from . import _build
from .dispatch import grad_gate

__all__ = ["tridiag_exp_e1", "tridiag_exp_e1_ref", "tridiag_exp_e1_batched",
           "tridiag_exp_e1_batched_ref", "scalar_operand",
           "launch_shape", "work_bytes", "SMEM_BUDGET", "MAX_THREADS",
           "MAX_ITER", "MAX_ORDER"]

SMEM_BUDGET = 200 * 1024   # bytes of dynamic shared memory (227 KB opt-in)
MAX_THREADS = 512          # groups of lanes, one a root or row
MAX_ITER = 64              # secular evaluations per root before NaN
MAX_ORDER = 32767          # positions are int16 in the kernel
CLOCK_SLOTS = 128          # 3 + 8 x the tree's depth, at most


def work_bytes(m: int) -> int:
    """Bytes of the kernel's workspace at order m (``csrc/tridiag.cu``'s
    ``work_bytes``): 8 working vectors of m doubles, and for each of the
    tree's ceil(log2 m) levels (at least one) 7 arrays of m doubles and 6
    of m int16. All arithmetic is in double, whatever the data's type."""
    lv = max(1, (m - 1).bit_length()) * m
    return 8 * (8 * m + 7 * lv) + 2 * 6 * lv


def launch_shape(m: int) -> tuple[int, int, int, bool]:
    """(threads, lanes, bytes of workspace, whether it is shared memory)
    of a launch at order m, in either data type (the work is in double):
    ``MAX_THREADS`` threads in groups of ``lanes`` (a power of two up to
    32, as many as keep a group for each of the m roots or rows a level
    has), the workspace in dynamic shared memory where it fits
    ``SMEM_BUDGET`` (m <= 302), else in a global scratch buffer that the
    wrapper allocates."""
    if m > MAX_ORDER:
        raise ValueError(f"R1 tridiag_exp_e1: m = {m} is above {MAX_ORDER}, "
                         "the kernel's int16 positions")
    lanes = min(32, 1 << max(0, (MAX_THREADS // max(m, 1)).bit_length() - 1))
    nbytes = work_bytes(m)
    return MAX_THREADS, lanes, nbytes, nbytes <= SMEM_BUDGET


def tridiag_exp_e1_ref(alphas, betas, t, s=None):
    """Plain twin of R1: eigh of the tridiagonal, then s Q e^{t Lambda}
    Q^T e1, in the promoted type of the diagonals and t."""
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    w, Q = torch.linalg.eigh(T)
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    out = Q.to(cdt) @ (torch.exp(t * w) * Q[0, :].to(cdt))
    return out if s is None else out * s.to(cdt)


def tridiag_exp_e1_batched_ref(alphas, betas, t, s=None):
    """Plain twin of K2: the eigh formula on each row of alphas (batch, m),
    betas (batch, m - 1), with s (batch,) or None; (batch, m)."""
    T = (torch.diag_embed(alphas) + torch.diag_embed(betas, 1)
         + torch.diag_embed(betas, -1))
    w, Q = torch.linalg.eigh(T)
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    out = (Q.to(cdt) @ (torch.exp(t * w) * Q[..., 0, :].to(cdt))[..., None]
           )[..., 0]
    return out if s is None else out * s.to(cdt)[..., None]


def scalar_operand(t, like):
    """t as R1 reads it: a 0-d tensor on ``like``'s device in the promoted
    type of ``like`` and t (a Python t in like's precision), made by a
    fill, never a host-to-device copy. A tensor t on that device, or one
    that autograd or a transform must see, is only cast and moved."""
    if isinstance(t, torch.Tensor):
        dt = torch.promote_types(like.dtype, t.dtype)
        if t.device == like.device or sees_grad((t,)):
            return t.reshape(()).to(device=like.device, dtype=dt)
        t = t.item()
    else:
        dt = torch.promote_types(like.dtype, torch.as_tensor(t).dtype)
    return torch.full((), t, dtype=dt, device=like.device)


def _check(what, x, ndim, device):
    if not isinstance(x, torch.Tensor) or x.dim() != ndim \
            or x.device != device:
        raise ValueError(f"R1 tridiag_exp_e1: {what} must be a {ndim}-d "
                         f"tensor on {device}, got "
                         f"{type(x).__name__} {getattr(x, 'shape', '')} on "
                         f"{getattr(x, 'device', None)}")


def tridiag_exp_e1(alphas, betas, t, s=None):
    """s Q exp(t Lambda) Q^T e1 (module doc): kernel R1 for CUDA
    tensors, its twin on the CPU and under the grad rule. s: optional,
    a real 0-d tensor on the diagonals' device. Returns (m,) in the
    promoted type of the diagonals and t."""
    if (alphas.device.type == "cpu"
            or grad_gate(None, (alphas, betas, t, s))):
        return tridiag_exp_e1_ref(alphas, betas, t, s)
    return _launch(alphas, betas, scalar_operand(t, alphas), s)


def tridiag_exp_e1_batched(alphas, betas, t, s=None):
    """K2, R1 on each row (one launch for the batch, one block a row, each
    row's bits R1's on that row): alphas (batch, m), betas (batch, m - 1),
    a shared t, s (batch,) or None. Kernel K2 for CUDA tensors, the twin
    ``tridiag_exp_e1_batched_ref`` on the CPU and under the grad rule.
    Returns (batch, m) in the promoted type of the diagonals and t."""
    if (alphas.device.type == "cpu"
            or grad_gate(None, (alphas, betas, t, s))):
        return tridiag_exp_e1_batched_ref(alphas, betas, t, s)
    return _launch_batched(alphas, betas, scalar_operand(t, alphas), s)


def _launch_batched(alphas, betas, t, s):
    dev = alphas.device
    _check("alphas", alphas, 2, dev)
    _check("betas", betas, 2, dev)
    _check("t", t, 0, dev)
    nb, m = alphas.shape
    if s is not None:
        _check("s", s, 1, dev)
        if s.shape[0] != nb:
            raise ValueError(f"K2 tridiag_exp_e1_batched: s must hold "
                             f"{nb} values, got {s.shape[0]}")
    if betas.shape != (nb, max(m - 1, 0)):
        raise ValueError(f"K2 tridiag_exp_e1_batched: betas must be "
                         f"({nb}, {max(m - 1, 0)}), got "
                         f"{tuple(betas.shape)}")
    odt = torch.promote_types(alphas.dtype, t.dtype)
    rdt = odt.to_real() if odt.is_complex else odt
    if rdt not in _build.KERNEL_DTYPES:
        raise ValueError(f"K2 tridiag_exp_e1_batched takes float32/float64 "
                         f"diagonals, got {alphas.dtype} with t {t.dtype}")
    a = alphas.to(rdt).contiguous()
    b = betas.to(rdt).contiguous()
    tt = t.to(odt).reshape(1)
    ss = None if s is None else s.to(rdt).contiguous()
    out = torch.empty((nb, m), dtype=odt, device=dev)
    if m == 0 or nb == 0:
        return out
    nt, lanes, nbytes, shared = launch_shape(m)
    scratch = (None if shared else torch.empty(
        nb * -(-nbytes // 8), dtype=torch.float64, device=dev))
    fn = getattr(_build.library(),
                 f"eu_tridiag_exp_batched_{_build.suffix(rdt)}")
    _build.check(fn(_build.ptr(a), _build.ptr(b), _build.ptr(tt),
                    int(odt.is_complex), _build.ptr(ss), _build.ptr(out),
                    _build.ptr(scratch), m, nt, nbytes, MAX_ITER, lanes, nb,
                    _build.raw_stream(dev)),
                 "K2 tridiag_exp_e1_batched")
    _build.launches["tridiag_exp_batched"] += 1
    return out


def _launch(alphas, betas, t, s, clocks=None):
    """One launch of R1; ``clocks``: an int64 CUDA tensor of ``CLOCK_SLOTS``
    values that thread 0 fills with the SM's cycle counter at the start
    and after every phase's barrier (a timing script's view of where the
    time goes), else None."""
    dev = alphas.device
    _check("alphas", alphas, 1, dev)
    _check("betas", betas, 1, dev)
    _check("t", t, 0, dev)
    if s is not None:
        _check("s", s, 0, dev)
    m = alphas.shape[0]
    if betas.shape[0] != max(m - 1, 0):
        raise ValueError(f"R1 tridiag_exp_e1: betas must hold m - 1 = "
                         f"{m - 1} values, got {betas.shape[0]}")
    odt = torch.promote_types(alphas.dtype, t.dtype)
    rdt = odt.to_real() if odt.is_complex else odt
    if rdt not in _build.KERNEL_DTYPES:
        raise ValueError(f"R1 tridiag_exp_e1 takes float32/float64 "
                         f"diagonals, got {alphas.dtype} with t {t.dtype}")
    a = alphas.to(rdt).contiguous()
    b = betas.to(rdt).contiguous()
    tt = t.to(odt).reshape(1)
    ss = None if s is None else s.to(rdt).reshape(1)
    out = torch.empty(m, dtype=odt, device=dev)
    if m == 0:
        return out
    nt, lanes, nbytes, shared = launch_shape(m)
    scratch = (None if shared else
               torch.empty(-(-nbytes // 8), dtype=torch.float64, device=dev))
    if clocks is not None:
        _check("clocks", clocks, 1, dev)
        if clocks.dtype != torch.int64 or clocks.numel() < CLOCK_SLOTS:
            raise ValueError(f"R1 tridiag_exp_e1: clocks must hold "
                             f"{CLOCK_SLOTS} int64 values")
    fn = getattr(_build.library(), f"eu_tridiag_exp_{_build.suffix(rdt)}")
    _build.check(fn(_build.ptr(a), _build.ptr(b), _build.ptr(tt),
                    int(odt.is_complex), _build.ptr(ss), _build.ptr(out),
                    _build.ptr(scratch), m, nt, nbytes, MAX_ITER, lanes,
                    _build.ptr(clocks), _build.raw_stream(dev)),
                 "R1 tridiag_exp_e1")
    _build.launches["tridiag_exp"] += 1
    return out

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
hand-written kernel (``csrc/tridiag.cu``: one block, one thread running
the implicit QL sweeps with Wilkinson shifts on the one copy of d and e
in shared memory, the other warps rotating their rows of Q by the sweep
before) for CUDA tensors and raises if the build or the launch fails; on CPU
tensors, and for calls that autograd or a ``torch.func`` transform must
see (the grad rule of ``ops/kernels/dispatch.py``, counted in its
``grad_gated``), it runs the plain twin ``tridiag_exp_e1_ref``, the
eigh formula, which has eigh's gradient. t (a number or a 0-d tensor)
becomes a 0-d tensor on the diagonals' device without a host-to-device
copy (``scalar_operand``), and s is a 0-d tensor there: the kernel reads
both from device memory, so a captured launch reads each replay's
values.
"""

from __future__ import annotations

import math

import torch

from ...utils.graphs import sees_grad
from . import _build
from .dispatch import grad_gate

__all__ = ["tridiag_exp_e1", "tridiag_exp_e1_ref", "scalar_operand",
           "launch_shape", "SMEM_BUDGET", "MAX_THREADS", "MAX_ITER"]

SMEM_BUDGET = 200 * 1024   # bytes of dynamic shared memory (227 KB opt-in)
MAX_THREADS = 32 + 256     # warp 0 (thread 0: the QL sweeps) + appliers
MAX_ITER = 64              # QL iterations per eigenvalue before NaN


def launch_shape(m: int, dtype) -> tuple[int, int, bool]:
    """(threads, bytes of dynamic shared memory, whether Q is among them)
    of a launch at order m in real dtype: d, e and two rotation buffers
    (6 m values) always, Q (m^2) where the whole fits ``SMEM_BUDGET``,
    else Q in a global scratch buffer."""
    nt = min(MAX_THREADS, 32 + 32 * max(1, math.ceil(m / 32)))
    es = torch.empty((), dtype=dtype).element_size()
    with_q = (m * m + 6 * m) * es
    if with_q <= SMEM_BUDGET:
        return nt, with_q, True
    if 6 * m * es > SMEM_BUDGET:
        raise ValueError(f"R1 tridiag_exp_e1: m = {m} is too large for one "
                         "block's shared memory")
    return nt, 6 * m * es, False


def tridiag_exp_e1_ref(alphas, betas, t, s=None):
    """Plain twin of R1: eigh of the tridiagonal, then s Q e^{t Lambda}
    Q^T e1, in the promoted type of the diagonals and t."""
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    w, Q = torch.linalg.eigh(T)
    cdt = torch.promote_types(Q.dtype, torch.as_tensor(t).dtype)
    out = Q.to(cdt) @ (torch.exp(t * w) * Q[0, :].to(cdt))
    return out if s is None else out * s.to(cdt)


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


def _launch(alphas, betas, t, s):
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
    nt, nbytes, q_shared = launch_shape(m, rdt)
    scratch = (None if q_shared else
               torch.empty(m * m, dtype=rdt, device=dev))
    fn = getattr(_build.library(), f"eu_tridiag_exp_{_build.suffix(rdt)}")
    _build.check(fn(_build.ptr(a), _build.ptr(b), _build.ptr(tt),
                    int(odt.is_complex), _build.ptr(ss), _build.ptr(out),
                    _build.ptr(scratch), m, nt, nbytes, MAX_ITER,
                    _build.raw_stream(dev)), "R1 tridiag_exp_e1")
    _build.launches["tridiag_exp"] += 1
    return out

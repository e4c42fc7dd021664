"""Reduced problems evaluated on the host in float64/complex128 (PyTorch
port of ``exponentialutilities_jl_tpu/ops/host_reduced.py``).

The Krylov drivers keep the O(n) basis on the operator's device and reduce
the problem to an m x m Hessenberg or tridiagonal. ``reduced="host"``
evaluates that small problem with scipy (host LAPACK, float64 or
complex128) instead of on the device, the reference's device/host split.
It costs one device-to-host read of the m-sized record and one
host-to-device write of the m-sized result per reduced problem; the
results come back as tensors on the record's device, in the dtype the
device form would give. A batch (``expv_batched``; JAX's
``_expv_batched_host`` and ``_expv_batched_two_pass_host``) is staged
whole: ``host_expm_e1`` of a (batch, m, m) stack and
``host_lanczos_coeffs`` of (batch, m) records make one read of the whole
batch's record, scipy on each row, and one write back.

The JAX package needs this split on the TPU (no float64 LU there). The
H100 has native float64, so ``reduced_default()`` is "device", as the JAX
one is on every backend but the TPU; "host" is the option a caller picks
for LAPACK's reduced exponential. Over a row-sharded operator the reduced
problem is replicated: each rank evaluates the same m x m problem on its
own host, with no collective.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["reduced_default", "host_expm", "host_expm_e1", "host_phiv_e1",
           "host_phi", "host_lanczos_coeffs"]


def reduced_default() -> str:
    """Where a reduced problem is evaluated when the caller does not say:
    "device"."""
    return "device"


def _scalar(t):
    """t (Python number, numpy scalar or 0-d tensor) as a Python float or
    complex, and its torch dtype as the device forms promote it."""
    tt = torch.as_tensor(t)
    # a Python float would pass through float32 in torch.as_tensor
    v = t.item() if isinstance(t, torch.Tensor) else np.asarray(t).item()
    return (complex(v) if tt.is_complex() else float(v)), tt.dtype


def _host(x) -> np.ndarray:
    """A tensor's values as float64 or complex128 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().resolve_conj().numpy()
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _back(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                       dtype=dtype)


def host_expm(M, out_dtype=None):
    """exp(M) for a small matrix, on the host in float64/complex128,
    returned on M's device in ``out_dtype`` (default M's dtype)."""
    import scipy.linalg as sla

    M = torch.as_tensor(M)
    return _back(sla.expm(_host(M)), out_dtype or M.dtype, M.device)


def host_expm_e1(H, t, out_dtype=None):
    """First column of exp(t H), on the host; a tensor on H's device. A
    (batch, m, m) stack: each row's, (batch, m), in one read and one
    write."""
    import scipy.linalg as sla

    th, tdt = _scalar(t)
    dt = out_dtype or torch.promote_types(H.dtype, tdt)
    Hh = _host(H)
    if Hh.ndim == 2:
        return _back(sla.expm(th * Hh)[:, 0], dt, H.device)
    return _back(np.stack([sla.expm(th * Hi)[:, 0] for Hi in Hh]), dt,
                 H.device)


def _phiv_e1_np(M: np.ndarray, k: int) -> np.ndarray:
    """[phi_0(M) e1 ... phi_k(M) e1] (m, k+1) by the augmented matrix
    [[M, e1 0], [0, K]] (the construction of ``ops/phi_dense.phiv_dense``)."""
    import scipy.linalg as sla

    m = M.shape[0]
    if k == 0:
        return sla.expm(M)[:, :1]
    Aug = np.zeros((m + k, m + k), dtype=M.dtype)
    Aug[:m, :m] = M
    Aug[0, m] = 1.0
    for i in range(k - 1):
        Aug[m + i, m + i + 1] = 1.0
    P = sla.expm(Aug)
    return np.concatenate([P[:m, :1], P[:m, m:m + k]], axis=1)


def host_phiv_e1(H, t, k: int, out_dtype=None):
    """[phi_0(tH)e1 ... phi_k(tH)e1] (m, k+1), on the host; a tensor on
    H's device."""
    th, tdt = _scalar(t)
    dt = out_dtype or torch.promote_types(H.dtype, tdt)
    return _back(_phiv_e1_np(th * _host(H), k), dt, H.device)


def host_phi_np(A, k: int) -> np.ndarray:
    """[phi_0(A), ..., phi_k(A)] (k+1, n, n) as float64/complex128 numpy,
    by the block identity exp([[A, E], [0, K]])[:n, n + (j-1) n : n + j n]
    = phi_j(A), E = [I 0 ... 0], K the k n-sized block-nilpotent shift."""
    import scipy.linalg as sla

    A = _host(A)
    n = A.shape[0]
    if k == 0:
        return sla.expm(A)[None]
    E = np.zeros((n, k * n), A.dtype)
    E[:, :n] = np.eye(n)
    K = np.zeros((k * n, k * n), A.dtype)
    for j in range(k - 1):
        K[j * n:(j + 1) * n, (j + 1) * n:(j + 2) * n] = np.eye(n)
    P = sla.expm(np.block([[A, E], [np.zeros((k * n, n), A.dtype), K]]))
    return np.stack([P[:n, :n]] + [P[:n, n + (j - 1) * n:n + j * n]
                                   for j in range(1, k + 1)])


def host_phi(A, k: int, out_dtype=None):
    """The dense phi stack [phi_0(A), ..., phi_k(A)] (k+1, n, n) on the
    host (``host_phi_np``); a tensor on A's device (numpy input: the CPU)
    in ``out_dtype`` (default A's dtype)."""
    A = torch.as_tensor(A)
    return _back(host_phi_np(A, k), out_dtype or A.dtype, A.device)


def host_lanczos_coeffs(alphas, betas, beta0, t):
    """The two-pass Hermitian replay coefficients beta0 Q e^{t Lambda}
    Q^T e1 of the recorded tridiagonal (scipy ``eigh_tridiagonal``), on
    the recording's device. (batch, m) records and a (batch,) beta0:
    each row's, (batch, m), in one read and one write."""
    import scipy.linalg as sla

    th, tdt = _scalar(t)
    m = alphas.shape[-1]
    rec = _host(torch.cat([alphas, betas, beta0[..., None].to(alphas.dtype)],
                          -1))          # one read
    a, b, b0 = rec[..., :m], rec[..., m:2 * m], rec[..., 2 * m]

    def row(ai, bi, b0i):
        w, Q = sla.eigh_tridiagonal(ai, bi[:-1])
        return (Q @ (np.exp(th * w) * Q[0, :])) * float(b0i)

    coeffs = (row(a, b, b0) if a.ndim == 1 else
              np.stack([row(*r) for r in zip(a, b, b0)]))
    return _back(coeffs, torch.promote_types(alphas.dtype, tdt),
                 alphas.device)

"""General matrix functions by the blocked Schur-Parlett algorithm
(PyTorch port of ``exponentialutilities_jl_tpu/ops/funm.py``).

``funm(A, f)`` computes f(A) for any square matrix (non-normal,
repeated-eigenvalue, defective) by the Davies-Higham algorithm:

  1. complex Schur form A = Z T Z^H (host LAPACK, complex128),
  2. eigenvalue clustering: connected components of |lam_i - lam_j| <=
     delta, reordered into contiguous diagonal blocks by LAPACK
     ``ztrexc`` swaps,
  3. f on each diagonal block (scipy ``expm``, ``logm``, ... or the
     scalar f on a 1 x 1 block),
  4. the Parlett recurrence for the off-diagonal blocks,
  5. f(A) = Z F Z^H.

Steps 1-3 run on the host (scipy), as in the JAX package. Step 4 with
``parlett="auto"`` or ``"device"`` runs on A's device as torch complex128
products (``_parlett_device``): the nilpotent fixed point of the
commutation identity (lam_a - lam_b) F_ab = (F N - N F)_ab, N = T -
diag(T), then Z F Z^H; its commutation residual |T F - F T|_F certifies
it. "auto" takes the host ``ztrsyl`` block recurrence when the residual
did not close; "device" raises FloatingPointError then (it never returns
an unconverged F); "host" runs the host recurrence only. The result lies
on A's device (numpy input: the default device).

Host-staged: under a ``torch.func`` transform, or with a matrix that
requires grad while grad mode is on, ``funm`` raises NotImplementedError.
``expm(A, method="schur")`` is ``funm(A, "exp")``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import host_tensor
from ..utils.precision import full_precision
from .expm import refuse_host_staged
from .host_reduced import host_phi_np

__all__ = ["funm", "funm_schur_parlett"]


def _cluster_eigs(lam: np.ndarray, delta: float) -> np.ndarray:
    """Connected components of the graph |lam_i - lam_j| <= delta: the
    cluster id of each eigenvalue (Davies-Higham blocking)."""
    n = lam.shape[0]
    cid = -np.ones(n, dtype=np.int64)
    nclusters = 0
    for i in range(n):
        if cid[i] >= 0:
            continue
        # BFS over the closeness graph
        stack, cid[i] = [i], nclusters
        while stack:
            k = stack.pop()
            close = np.abs(lam - lam[k]) <= delta
            for j in np.nonzero(close & (cid < 0))[0]:
                cid[j] = nclusters
                stack.append(int(j))
        nclusters += 1
    return cid


def _reorder_schur(T: np.ndarray, Z: np.ndarray, cid: np.ndarray):
    """Swap the Schur form so clusters occupy contiguous diagonal blocks,
    ordered by each cluster's mean original position (the fewest swaps,
    MATLAB ``funm``'s strategy). Returns (T, Z, block boundaries)."""
    from scipy.linalg import lapack

    n = T.shape[0]
    order = list(cid)
    # cluster ranks by average position along the diagonal
    ranks = {}
    for c in set(order):
        pos = [i for i, x in enumerate(order) if x == c]
        ranks[c] = sum(pos) / len(pos)
    cluster_seq = sorted(ranks, key=lambda c: ranks[c])
    T = np.asarray(T, np.complex128, order="F").copy()
    Z = np.asarray(Z, np.complex128, order="F").copy()
    p = 0
    sizes = []
    for c in cluster_seq:
        size = 0
        for _ in range(order.count(c)):
            j = order.index(c, p)           # next member at/after p
            if j != p:
                T, Z, info = lapack.ztrexc(T, Z, j + 1, p + 1)  # 1-based
                if info != 0:
                    raise np.linalg.LinAlgError(
                        f"ztrexc failed with info={info}")
                order.insert(p, order.pop(j))
            p += 1
            size += 1
        sizes.append(size)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return T, Z, bounds


def _atomic_exp(T):
    import scipy.linalg as sla
    return sla.expm(T)


def _atomic_phi(k):
    def fm(T):
        return host_phi_np(T, k)[k]
    return fm


def _atomic_log(T):
    import scipy.linalg as sla
    return sla.logm(T)


def _atomic_sqrt(T):
    import scipy.linalg as sla
    return sla.sqrtm(T)


def _sincos(T):
    """sin and cos of a matrix from exp(iT) (T is complex here anyway)."""
    import scipy.linalg as sla
    E = sla.expm(1j * T)
    Em = sla.expm(-1j * T)
    return (E - Em) / 2j, (E + Em) / 2


_NAMED = {
    "exp": (_atomic_exp, np.exp),
    "log": (_atomic_log, np.log),
    "sqrt": (_atomic_sqrt, np.sqrt),
    "sin": (lambda T: _sincos(T)[0], np.sin),
    "cos": (lambda T: _sincos(T)[1], np.cos),
}


@full_precision
def _parlett_device(T, Fd, cross, denom, Z, iters: int, device):
    """The Parlett stage on ``device`` (module doc): the cross-cluster
    entries of F from the fixed point F = Fd + cross (F N - N F) / denom.
    The map is nilpotent (each contribution strictly lowers the weight
    (n - a) + b), so it reaches the exact Parlett solution after the
    longest cross-cluster chain; the loop stops at a fixed point (a change
    below 1e-28 of |F|^2, read to the host each iteration) or after
    ``iters`` iterations. Returns (Z F Z^H, the commutation residual
    |T F - F T|_F as a host float)."""
    c128 = dict(dtype=torch.complex128, device=device)
    T = torch.as_tensor(T, **c128)
    Fd = torch.as_tensor(Fd, **c128)
    Z = torch.as_tensor(Z, **c128)
    cross = torch.as_tensor(cross, dtype=torch.float64, device=device)
    den = torch.where(cross > 0, torch.as_tensor(denom, **c128), 1.0)
    N = T - torch.diag_embed(torch.diagonal(T))
    F = Fd
    for _ in range(iters):
        F2 = Fd + cross * ((F @ N - N @ F) / den)
        delta, nrm = torch.stack([(F2 - F).abs().square().sum(),
                                  F2.abs().square().sum()]).tolist()
        F = F2
        # exact stationarity = the nilpotent chain has closed; the
        # relative floor catches roundoff-level cycling
        if not delta > 1e-28 * max(nrm, 1.0):
            break
    res = float(torch.linalg.matrix_norm(T @ F - F @ T))
    return Z @ F @ Z.mH, res


def _user_callable(g: Callable) -> Callable:
    """A user's f or matfunc as a numpy block evaluator: it is called on a
    complex128 CPU tensor (0-d for a 1 x 1 block's eigenvalue, 2-D for a
    block), so torch functions work; numpy ufuncs, ``cmath`` and scipy
    read the tensor through ``__array__`` / ``__complex__``. Whatever it
    returns (a tensor, a numpy value, a Python complex) comes back as
    complex128 numpy."""
    def call(block: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.array(block, np.complex128))
        with warnings.catch_warnings():
            # a numpy ufunc on a tensor wraps its result through the
            # tensor's older __array_wrap__ signature (numpy >= 2 warns)
            warnings.filterwarnings("ignore", "__array_wrap__",
                                    DeprecationWarning)
            y = g(x)
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().resolve_conj()
        return np.asarray(y, np.complex128)
    return call


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def funm_schur_parlett(A, f, *, delta: float = 0.2,
                       matfunc: Optional[Callable] = None,
                       out_dtype=None, parlett: str = "auto",
                       iters: int | None = None):
    """f(A) by blocked Schur-Parlett (module doc).

    A: (n, n) matrix (tensor or host data). f: "exp", "log", "sqrt",
      "sin", "cos", "phi<k>" (e.g. "phi1"), or a scalar callable applied on
      1 x 1 blocks; a larger block (eigenvalues within ``delta``) then needs
      ``matfunc``, a block evaluator ``Tblock -> f(Tblock)`` (it also
      overrides a named f's). Both get complex128 CPU tensors (0-d and
      2-D), so ``torch.exp`` works as well as ``np.exp``, a ``cmath``
      lambda or a scipy function; a tensor, numpy value or Python complex
      may come back.
    delta: clustering threshold (0.2: wider than Davies-Higham's 0.1, for
      accuracy).
    parlett: "auto", "device" or "host" (module doc).
    iters: the device fixed point's iteration cap (default
      min(2n + 4, 256)).

    Returns f(A) on A's device in A's dtype (or ``out_dtype``); a real A
    whose f(A) has an imaginary part above roundoff gives complex128."""
    import scipy.linalg as sla

    device = A.device if isinstance(A, torch.Tensor) else None
    A = host_tensor(A, device)
    device = A.device
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(A.shape)}")
    if parlett not in ("auto", "host", "device"):
        raise ValueError(f"parlett must be auto|host|device, got {parlett!r}")
    n = A.shape[0]
    in_dtype = _torch_dtype(out_dtype) if out_dtype is not None else A.dtype
    was_real = not A.is_complex()
    scalar_f: Optional[Callable]
    if isinstance(f, str):
        if f in _NAMED:
            block_f, scalar_f = _NAMED[f]
        elif f.startswith("phi") and f[3:].isdigit():
            block_f, scalar_f = _atomic_phi(int(f[3:])), None
        else:
            raise ValueError(
                f"unknown named matrix function {f!r}; expected one of "
                f"{sorted(_NAMED) + ['phi<k>']} or a scalar callable")
    else:
        scalar_f = None if f is None else _user_callable(f)
        block_f = None
    if matfunc is not None:
        block_f = _user_callable(matfunc)

    Ah = A.detach().cpu().numpy().astype(np.complex128)
    T, Z = sla.schur(Ah, output="complex")
    cid = _cluster_eigs(np.diag(T), float(delta))
    T, Z, bounds = _reorder_schur(T, Z, cid)
    nb = len(bounds) - 1
    blk = [slice(int(bounds[i]), int(bounds[i + 1])) for i in range(nb)]

    F = np.zeros_like(T)
    for i in range(nb):
        Ti = T[blk[i], blk[i]]
        if Ti.shape[0] == 1 and scalar_f is not None:
            F[blk[i], blk[i]] = scalar_f(Ti[:1, :1].reshape(()))
        elif block_f is not None:
            F[blk[i], blk[i]] = np.asarray(block_f(Ti), np.complex128)
        else:
            raise ValueError(
                "funm: eigenvalue clustering produced a "
                f"{Ti.shape[0]}x{Ti.shape[0]} atomic block (eigenvalues "
                f"within delta={delta} of each other), but f is a scalar "
                "callable with no `matfunc` block evaluator; pass "
                "matfunc=... or use a named f")

    out = None
    if parlett in ("auto", "device") and nb > 1:
        cidb = np.concatenate([np.full(int(bounds[i + 1] - bounds[i]), i)
                               for i in range(nb)])
        cross = np.triu((cidb[:, None] != cidb[None, :]).astype(np.float64))
        lam = np.diag(T)
        it = iters if iters is not None else min(2 * n + 4, 256)
        out_dev, res = _parlett_device(T, F, cross, lam[:, None] - lam[None, :],
                                       Z, it, device)
        bound = 1e-10 * max(np.linalg.norm(T), 1e-300) \
            * max(np.linalg.norm(F), 1.0)
        if res <= bound:
            out = out_dev
        elif parlett == "device":
            raise FloatingPointError(
                f"funm(parlett='device'): the device Parlett fixed point did "
                f"not close (commutation residual {res:.3e} > {bound:.3e} "
                f"after at most {it} iterations); use parlett='auto' (host "
                "recurrence when it does not close) or 'host', or a larger "
                "`iters`")
        # else (auto): the fixed point did not close; the host recurrence
        # below takes over

    if out is None:
        from scipy.linalg import lapack
        for d in range(1, nb):              # superdiagonals outward
            for i in range(nb - d):
                j = i + d
                Tij = T[blk[i], blk[j]]
                C = F[blk[i], blk[i]] @ Tij - Tij @ F[blk[j], blk[j]]
                for k in range(i + 1, j):
                    C += (F[blk[i], blk[k]] @ T[blk[k], blk[j]]
                          - T[blk[i], blk[k]] @ F[blk[k], blk[j]])
                # T_ii X - X T_jj = C; the blocks' spectra are more than
                # delta apart (the clustering invariant)
                X, scale, info = lapack.ztrsyl(T[blk[i], blk[i]],
                                               T[blk[j], blk[j]], C, isgn=-1)
                if info < 0:
                    raise np.linalg.LinAlgError(
                        f"ztrsyl failed with info={info}")
                F[blk[i], blk[j]] = X / scale
        out = torch.as_tensor(Z @ F @ Z.conj().T, device=device)
    if was_real and not in_dtype.is_complex:
        if isinstance(f, str) and f in ("exp", "sin", "cos"):
            # real for real input: the imaginary part is Schur/Parlett
            # roundoff
            out = out.real
        elif float(out.imag.abs().max()) <= 1e-10 * max(
                float(out.abs().max()), 1.0):
            out = out.real
        else:
            return out                      # a genuinely complex result
    return out.to(in_dtype)


def funm(A, f, **kwargs):
    """General matrix function f(A) (module doc). Host-staged: raises
    under a ``torch.func`` transform or on a matrix that requires grad;
    ``expm(A, method="schur")`` is the f="exp" spelling."""
    refuse_host_staged(A, "funm", grad=True)
    return funm_schur_parlett(A, f, **kwargs)

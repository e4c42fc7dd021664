"""Warm-up of the serving entry points (PyTorch port of
``exponentialutilities_jl_tpu/utils/aot.py``; the reference precompiles
``exponential!``, ``expv`` and ``phiv``, src/precompile.jl).

The JAX package pays XLA compilation once per signature; the port's
first-call costs are the kernel library's build (``ops/kernels/_build``:
nvcc, once per source hash, then cached on disk) and each operator's
launch plans. ``warmup`` calls the hot entry points once on the target
device, so that a server's first request pays neither.
"""

from __future__ import annotations

import torch

__all__ = ["warmup"]


def warmup(n: int = 64, m: int = 30, k: int = 2, dtype=torch.float32,
           hermitian: bool = True, dense: bool = True, mesh=None,
           device=None) -> dict:
    """Run expm/expv/phiv, the device-loop drivers and (Hermitian) the
    Chebyshev actions once for one signature (size ``n``, Krylov dimension
    ``m``, phi order ``k``, ``dtype``) on ``device`` (default: the mesh's,
    else the port's default device). With ``mesh``, also the sharded step
    of ``parallel.make_expv_step`` (every rank of the mesh must call it).
    Returns the (small) outputs by name, after a device synchronization."""
    from .. import (expm, expv, kiops_device, phiv, phiv_timestep_device)
    from ..utils.linop import DenseOperator
    from .device import resolve_device
    from .testmatrices import laplacian_1d

    dev = (torch.device(device) if device is not None
           else mesh.device if mesh is not None else resolve_device(None))
    out = {}
    b = torch.ones(n, dtype=dtype, device=dev)
    if dense:
        out["expm"] = expm(torch.eye(min(n, 128), dtype=dtype, device=dev))
    if hermitian:
        op = laplacian_1d(n, dtype=dtype, device=dev)
    else:
        op = DenseOperator(torch.eye(n, dtype=dtype, device=dev),
                           is_hermitian=False)
    mm = min(m, n)
    out["expv"] = expv(0.1, op, b, m=mm)
    out["phiv"] = phiv(0.1, op, b, k, m=mm)
    out["nw_device"] = phiv_timestep_device(0.1, op, b[:, None], m=mm,
                                            hermitian=hermitian)
    out["kiops_device"], _ = kiops_device([0.1], op, b[:, None],
                                          m=min(max(10, m // 2), n))
    if hermitian:
        from .. import expv_chebyshev, phiv_timestep_chebyshev
        out["expv_chebyshev"] = expv_chebyshev(0.1, op, b, tol=1e-6)
        out["phiv_timestep_chebyshev"] = phiv_timestep_chebyshev(
            0.1, op, torch.ones((n, k + 1), dtype=dtype, device=dev),
            tol=1e-6)
    if mesh is not None:
        from ..parallel import make_expv_step
        step, params = make_expv_step(op, mesh, m=mm)
        out["expv_sharded"] = step(0.1, params, b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out

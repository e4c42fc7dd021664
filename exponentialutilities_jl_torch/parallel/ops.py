"""Row-sharded vectors and the halo-exchange banded operator (PyTorch port
of ``exponentialutilities_jl_tpu/parallel/ops.py``).

State vectors and the Krylov basis are partitioned by rows over a 1-D
mesh axis (``parallel/mesh.py``: one rank per shard); the small reduced
problem is computed on every rank from the reduced scalars. Collectives:

* Gram-Schmidt dots and norms: one ``psum`` per CGS pass per step (the
  ``comm`` path of ``ops/krylov.py``).
* The banded matvec: a nearest-neighbour halo exchange
  (``MeshAxis.ppermute_halo``), never an all-gather.

``LocalBandedOperator`` is deliberately not a ``BandedOperator``: a
shard's rows must never reach the single-device kernels (B5, B7), which
would apply the global operator's Dirichlet truncation to the shard
without its halo. ``recurrence_engine`` and the containers' gates take
only their own classes, so a local operator always runs the plain torch
matvec below.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import BandedOperator
from ..utils.linop import LinearOperator
from .mesh import Mesh, gather_vector, make_mesh

__all__ = ["make_mesh", "shard_vector", "gather_vector",
           "LocalBandedOperator", "shard_banded", "local_rows"]


def local_rows(x, axis, n_global: int, device=None):
    """This rank's rows of ``x``: a global (n_global, ...) vector or block
    (tensor or host data) is cut to the rank's contiguous rows; a tensor of
    the local row count is taken as already sharded. On ``device``
    (default: the mesh's)."""
    size = axis.axis_size()
    if n_global % size:
        raise ValueError(f"n={n_global} must divide evenly over {size} "
                         "shards")
    nl = n_global // size
    device = axis.device if device is None else device
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.shape[0] == n_global:
        i = axis.axis_index()
        x = x[i * nl:(i + 1) * nl]
    elif x.shape[0] != nl:
        raise ValueError(f"vector of {x.shape[0]} rows is neither the "
                         f"global {n_global} nor this rank's {nl}")
    return x.to(device).contiguous()


def shard_vector(x, mesh: Mesh, axis_name: str | None = None):
    """This rank's rows of the global vector ``x`` (a row-sharded
    placement; the result lives on the mesh's device)."""
    return local_rows(x, mesh.axis(axis_name), x.shape[0])


class LocalBandedOperator(LinearOperator):
    """The per-rank view of a row-partitioned ``BandedOperator``.

    ``matvec`` takes this rank's rows of x, exchanges a halo of width h =
    max|offset| with the two ring neighbours (missing neighbours give
    zeros: the Dirichlet truncation of the global operator), then applies
    each diagonal as a static slice of the extended vector. Diagonal
    entries whose global column falls outside [0, n) are zeroed once here,
    the global-row validity mask of the JAX matvec.

    diags_local: (k, n_local) columns of the global diagonal storage.
    comm: the ``MeshAxis`` the rows are sharded over.
    """

    def __init__(self, diags_local, offsets, n_global: int, comm,
                 is_hermitian: bool = False):
        self.offsets = tuple(int(o) for o in offsets)
        self.n_global = int(n_global)
        self.comm = comm
        self.is_hermitian = bool(is_hermitian)
        self.halo = max((abs(o) for o in self.offsets), default=0)
        D = torch.as_tensor(diags_local)
        nl = D.shape[1]
        ig = comm.axis_index() * nl + torch.arange(nl, device=D.device)
        valid = torch.stack([(ig + o >= 0) & (ig + o < self.n_global)
                             for o in self.offsets]) if self.offsets else \
            torch.zeros((0, nl), dtype=torch.bool, device=D.device)
        self.diags = torch.where(valid, D, torch.zeros((), dtype=D.dtype,
                                                       device=D.device))

    @property
    def shape(self):
        # the global size: callers (``min(m, n)`` clamps) reason about
        # the global problem
        return (self.n_global, self.n_global)

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.n_global

    def matvec(self, x):
        n_local = x.shape[0]
        h = self.halo
        if h > n_local:
            raise ValueError(
                f"halo width {h} exceeds local shard size {n_local}; "
                "use fewer shards or a wider shard")
        if h > 0:
            below, above = self.comm.ppermute_halo(x[:h], x[-h:])
            xe = torch.cat([below, x, above])
        else:
            xe = x
        rt = torch.promote_types(self.dtype, x.dtype)
        y = torch.zeros(n_local, dtype=rt, device=x.device)
        for k, o in enumerate(self.offsets):
            y = y + self.diags[k] * xe[h + o:h + o + n_local]
        return y

    def opnorm_hint(self):
        local = self.diags.abs().sum(dim=0).max()
        return self.comm.pmax(local)


def shard_banded(op: BandedOperator, mesh: Mesh,
                 axis_name: str | None = None):
    """Split a global ``BandedOperator`` over ``mesh``: returns
    ``(diags_local, make_local)``, this rank's (k, n_local) columns of the
    diagonal storage on the mesh's device and ``make_local(diags_local)``,
    which builds the per-rank operator."""
    axis = mesh.axis(axis_name)
    n = op.shape[0]
    nshards = axis.axis_size()
    if n % nshards:
        raise ValueError(f"n={n} must divide evenly over {nshards} shards")
    nl = n // nshards
    i = axis.axis_index()
    diags_local = op.diags[:, i * nl:(i + 1) * nl].to(axis.device)
    offsets, herm = op.offsets, op.is_hermitian

    def make_local(d) -> LocalBandedOperator:
        return LocalBandedOperator(d, offsets, n, axis, is_hermitian=herm)

    return diags_local, make_local

"""Row-partitioned stencil operators: a plane-halo exchange over the mesh
(PyTorch port of ``exponentialutilities_jl_tpu/parallel/stencil.py``).

The d-D grid is sharded along its outermost axis (axis 0); each rank owns
a contiguous slab of planes. A stencil offset with axis-0 component q
needs up to h0 = max|q| halo planes from each ring neighbour, exchanged by
``MeshAxis.ppermute_halo`` (missing neighbours at the global boundary give
zeros: the Dirichlet truncation). Offsets along the other axes read the
zero-padded slab, as the single-device ``StencilOperator`` does.

``LocalStencilOperator`` is deliberately not a ``StencilOperator``: the
single-device kernels (B1, B3, B6) would apply the global Dirichlet
stencil to a shard's slab without its halo. The fused sharded sweeps of
``parallel/stencil_fused.py`` run B3 on each rank's slab extended by its
halo planes instead.
"""

from __future__ import annotations

import math

import torch

from ..ops.stencil import StencilOperator, stencil_apply
from ..utils.linop import LinearOperator
from .mesh import Mesh

__all__ = ["LocalStencilOperator", "shard_stencil"]


class LocalStencilOperator(LinearOperator):
    """Per-rank view of a ``StencilOperator`` sharded on grid axis 0: the
    local grid is (s0_local, s1, ...); ``matvec`` exchanges h0 halo planes
    each way, applies the stencil to the extended slab and keeps its
    interior planes."""

    def __init__(self, coeffs, local_shape, offsets, s0_global: int, comm,
                 is_hermitian: bool = False):
        self.coeffs = torch.as_tensor(coeffs)
        self.local_shape = tuple(int(s) for s in local_shape)
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.s0_global = int(s0_global)
        self.comm = comm
        self.is_hermitian = bool(is_hermitian)
        self.h0 = max((abs(off[0]) for off in self.offsets), default=0)

    @property
    def shape(self):
        n = self.s0_global * math.prod(self.local_shape[1:])
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @property
    def nnz(self) -> int:
        return len(self.offsets) * self.shape[0]

    def matvec(self, x):
        shape = self.local_shape
        h0 = self.h0
        if h0 > shape[0]:
            raise ValueError(
                f"axis-0 halo {h0} exceeds local slab depth {shape[0]}")
        rt = torch.promote_types(self.dtype, x.dtype)
        X = x.reshape(shape).to(rt)
        if h0 > 0:
            below, above = self.comm.ppermute_halo(X[:h0], X[-h0:])
            X = torch.cat([below, X, above])
        Y = stencil_apply(X, self.offsets, self.coeffs.to(rt))
        return Y[h0:h0 + shape[0]].reshape(-1)

    def opnorm_hint(self):
        return self.coeffs.abs().sum()


def shard_stencil(op: StencilOperator, mesh: Mesh,
                  axis_name: str | None = None):
    """Split a ``StencilOperator`` over ``mesh`` along grid axis 0: returns
    ``(coeffs, make_local)``, the (k,) coefficients on the mesh's device
    and ``make_local(coeffs)``, which builds the per-rank operator. A
    rank's vector is its s0/P contiguous planes, i.e. its rows of the flat
    vector."""
    axis = mesh.axis(axis_name)
    nshards = axis.axis_size()
    s0 = op.grid_shape[0]
    if s0 % nshards:
        raise ValueError(
            f"grid axis 0 ({s0}) must divide evenly over {nshards} shards")
    local_shape = (s0 // nshards,) + op.grid_shape[1:]
    coeffs = op.coeffs.to(axis.device)
    offsets, herm = op.offsets, op.is_hermitian

    def make_local(c) -> LocalStencilOperator:
        return LocalStencilOperator(c, local_shape, offsets, s0, axis,
                                    is_hermitian=herm)

    return coeffs, make_local

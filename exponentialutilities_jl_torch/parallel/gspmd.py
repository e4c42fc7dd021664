"""The GSPMD route: row-sharded operators that the single-device drivers
take as they are (PyTorch port of
``exponentialutilities_jl_tpu/parallel/gspmd.py``).

The JAX package places an operator's arrays and the state vector with row
shardings and calls the ordinary APIs; XLA partitions every program and
inserts the collectives. PyTorch has no such partitioner, so the port
makes the sharding explicit in one place: ``shard_operator`` returns this
rank's view of an operator, which carries its ``MeshAxis`` as ``comm``
(``utils/comm.py``). Every driver of the port reads it at entry, runs on
this rank's rows of its vectors, and reduces its dots, norms, maxima and
finiteness checks over the axis, so ``expv``, ``phiv``, the Chebyshev
actions, the Niesen-Wright drivers, KIOPS, Leja, Faber, ``expv_taylor``
and the integrators run distributed with no sharded twin of their own.

A sharded operator has the global ``shape`` and ``nnz``, ``n_local`` rows
on this rank, its storage on the mesh's device, and the global operator's
spectral information (``opnorm_hint``, ``spectral_bounds_hint``, the real
interval that ``models/leja.real_interval`` reads through
``_gershgorin_real`` and the field-of-values ellipse that
``models/faber.fov_ellipse`` reads through ``fov_ellipse_hint``): the
same numbers on every rank, so the drivers pick the degrees and substeps
of the single-device call. The norm and the bounds are computed when the
operator is sharded; the interval and the ellipse (two eigvalsh for a
dense operator) at their first read, from the global operator, which the
view keeps until then.

Products, one per kind:

* ``BandedOperator``: the h = max|offset| halo rows from the ring
  neighbours (``MeshAxis.ppermute_halo``), then ONE launch of kernel B7 on
  the halo-extended slab: diagonals of length n_local + 2h, zero on the h
  halo rows at each end and where the global column leaves [0, n). Every
  kept row's columns lie inside the extended vector, so B7's own boundary
  truncation never cuts a row of the global operator. A halo wider than a
  shard takes k = ceil(h / n_local) exchanges: the first passes this
  rank's edge rows, each later one passes on what the last one brought
  (whole shards, the outermost trimmed to the rows still missing), so the
  slab gathers the k neighbours on each side with halo traffic only. The
  axis ends receive zeros, and the diagonals are zero wherever a column
  leaves [0, n), so h is capped at (P - 1) n_local, where the slab
  already spans every column (k <= P - 1). The class is no
  ``BandedOperator`` (``parallel/ops.py`` says why): the recurrence
  engines never see it. CPU tensors run the same slab arithmetic on B7's
  twin.
* constant ``StencilOperator``: ``LocalStencilOperator``'s plane halo
  (the JAX route refuses a stencil; a rank-local B needs the stencil's
  rank-local view here).
* ``SparseELLOperator``: this rank's rows (global column indices) against
  the all-gathered x.
* ``BlockELLOperator``: this rank's block rows against the all-gathered x,
  on kernel B8 (a rectangular product: the rank's block rows by every
  block column).
* ``DenseOperator``: this rank's rows of A times the all-gathered x.

A product that autograd or a ``torch.func`` transform must see (the
integrators' ``JacobianOperator``) runs through ``ops/sparse._KernelMatvec``:
the collectives and kernels see plain tensors, the tangent takes the same
product, and the reverse rule gives this rank's rows of A^H g. For a
Hermitian operator that is the product itself. Otherwise a banded view
shards the global operator's adjoint (``BandedOperator.adjoint``) at the
first reverse sweep and runs the same halo exchange and one B7 launch on
the adjoint slab, the single-device rule on each rank's rows; an ELL,
block-ELL or dense view forms A_rows^H g_rows, an n-vector, in plain torch
(the JAX route runs these kinds without its kernels), sums it over the
axis (one psum) and keeps this rank's rows. The storage gradient is None
in every view. Other operators (``VariableStencilOperator``, the SELL, sorted
and hybrid containers, matrix-free operators) raise TypeError, as the
JAX route does.
"""

from __future__ import annotations

import torch

from ..ops.kernels.spmv import blockell_spmv, blockell_spmv_ref
from ..ops.sparse import (BandedOperator, BlockELLOperator,
                          SparseELLOperator, _graph_wanted, _kernel,
                          _KernelMatvec, _promoted)
from ..ops.stencil import StencilOperator
from ..utils.linop import DenseOperator, LinearOperator
from .mesh import Mesh
from .stencil import LocalStencilOperator

__all__ = ["shard_operator", "ShardedBandedOperator",
           "ShardedStencilOperator", "ShardedELLOperator",
           "ShardedBlockELLOperator", "ShardedDenseOperator"]


def _row_range(n: int, axis, unit: int = 1) -> tuple[int, int]:
    """[lo, hi): this rank's rows of an n-row operator split evenly into
    contiguous runs of whole ``unit``-row blocks."""
    size = axis.axis_size()
    if n % (size * unit):
        raise ValueError(f"n={n} must divide evenly over {size} shards"
                         + (f" in blocks of {unit} rows" if unit > 1 else ""))
    nl = n // size
    i = axis.axis_index()
    return i * nl, (i + 1) * nl


class _Sharded(LinearOperator):
    """This rank's view of a row-partitioned operator (module doc). A
    subclass provides ``_local_matvec(x)``: this rank's rows of A x from
    this rank's rows of x (the collectives included), and for a
    non-Hermitian operator ``_adjoint_matvec(g)``: this rank's rows of
    A^H g (the reverse rule's product)."""

    def _init_sharded(self, op, axis, n_local: int):
        self.comm = axis
        self.n_global = int(op.shape[0])
        self.n_local = int(n_local)
        self.row_lo = axis.axis_index() * self.n_local
        self.is_hermitian = bool(op.is_hermitian)
        self._nnz = int(op.nnz) if hasattr(op, "nnz") else None
        opn = op.opnorm_hint()
        self._opnorm = (None if opn is None
                        else torch.as_tensor(opn).detach().to(axis.device))
        sb = getattr(op, "spectral_bounds_hint", None)
        self._bounds = sb() if callable(sb) else None
        self._kind = type(op).__name__
        self._global = op           # for the lazy hints, dropped after both
        self._lazy = {}

    def _lazy_hint(self, fn, what: str):
        """``fn`` (``real_interval`` or ``fov_ellipse``) of the global
        operator, computed at the first read (module doc); TypeError where
        the global operator has no rule."""
        key = fn.__name__
        if key not in self._lazy:
            try:
                self._lazy[key] = fn(self._global)
            except TypeError:
                self._lazy[key] = None
            if len(self._lazy) == 2:
                self._global = None
        if self._lazy[key] is None:
            raise TypeError(f"no {key} rule for a sharded {self._kind}; "
                            f"pass {what} explicitly")
        return self._lazy[key]

    @property
    def shape(self):
        return (self.n_global, self.n_global)

    @property
    def nnz(self) -> int:
        if self._nnz is None:
            raise AttributeError("nnz")         # as the global operator
        return self._nnz

    def opnorm_hint(self):
        return self._opnorm

    def spectral_bounds_hint(self):
        return self._bounds

    def _gershgorin_real(self):
        from ..models.leja import real_interval

        return self._lazy_hint(real_interval, "interval=(a, b)")

    def fov_ellipse_hint(self):
        from ..models.faber import fov_ellipse

        return self._lazy_hint(fov_ellipse, "ellipse=(c, alpha, beta)")

    def _check_rows(self, x):
        if x.shape[0] != self.n_local:
            raise ValueError(
                f"a sharded operator takes this rank's {self.n_local} rows "
                f"(parallel.shard_vector), got {x.shape[0]}")

    def matvec(self, x):
        self._check_rows(x)
        if _graph_wanted(x):
            return _KernelMatvec.apply(x, self, None)
        return self._local_matvec(x)

    # the forward (and tangent) of ``_KernelMatvec``, on plain tensors
    def _kernel_matvec(self, x, _):
        return self.matvec(x)

    def _kernel_vjp(self, x, _, g, need_x, need_storage):
        gx = self.matvec(g) if self.is_hermitian else self._adjoint_matvec(g)
        return gx.to(x.dtype), None

    def _adjoint_matvec(self, g):
        raise NotImplementedError(
            f"reverse mode through a non-Hermitian sharded {self._kind} has "
            "no rule (the JAX route does not shard it)")

    def _scatter_rows(self, v):
        """This rank's rows of the axis sum of the n-vectors ``v`` (each
        rank's A_rows^H g_rows)."""
        return self.comm.psum(v)[self.row_lo:self.row_lo + self.n_local]


class ShardedBandedOperator(_Sharded):
    """This rank's rows of a ``BandedOperator``: the halo exchange, then one
    B7 launch on the halo-extended slab (module doc). ``ext`` is the
    slab's ``BandedOperator`` ((k, n_local + 2 halo) diagonals)."""

    def __init__(self, op: BandedOperator, axis):
        lo, hi = _row_range(op.shape[0], axis)
        self._init_sharded(op, axis, hi - lo)
        self.offsets = tuple(op.offsets)
        nl = hi - lo
        h = max((abs(o) for o in self.offsets), default=0)
        if h > nl:
            # multi-hop halo: the slab never needs more than every column
            h = min(h, (axis.axis_size() - 1) * nl)
        self.halo = h
        # the global operator, kept until the first reverse sweep shards
        # its adjoint
        self._source = None if self.is_hermitian else op
        D = op.diags.detach()[:, lo:hi].to(axis.device)
        ig = lo + torch.arange(nl, device=D.device)
        De = torch.zeros((len(self.offsets), nl + 2 * h), dtype=D.dtype,
                         device=D.device)
        for k, o in enumerate(self.offsets):
            valid = (ig + o >= 0) & (ig + o < self.n_global)
            De[k, h:h + nl] = torch.where(valid, D[k], 0)
        self.ext = BandedOperator(De, self.offsets,
                                  is_hermitian=self.is_hermitian)

    @property
    def dtype(self):
        return self.ext.dtype

    @property
    def device(self):
        return self.ext.device

    def _local_matvec(self, x):
        h = self.halo
        if h == 0:
            return self.ext.matvec(x)
        return self.ext.matvec(self._slab(x))[h:h + x.shape[0]]

    def _slab(self, x):
        """[h rows below; x; h rows above] from ceil(h / n_local) halo
        exchanges (module doc)."""
        lows, highs = [], []
        send_lo, send_hi, left = x, x, self.halo
        while left > 0:
            r = min(left, self.n_local)
            below, above = self.comm.ppermute_halo(send_lo[:r], send_hi[-r:])
            lows.append(below)
            highs.append(above)
            send_lo, send_hi, left = above, below, left - r
        return torch.cat(lows[::-1] + [x] + highs)

    def _adjoint(self):
        """This rank's view of the global operator's adjoint, sharded at
        the first call; its own adjoint is this view."""
        if getattr(self, "_adj", None) is None:
            self._adj = ShardedBandedOperator(self._source.adjoint(),
                                              self.comm)
            self._adj._adj, self._adj._source = self, None
            self._source = None
        return self._adj

    def _adjoint_matvec(self, g):
        return self._adjoint().matvec(g)


class ShardedStencilOperator(_Sharded, LocalStencilOperator):
    """This rank's slab of a constant ``StencilOperator`` sharded along
    grid axis 0: ``LocalStencilOperator``'s plane-halo product, with the
    global operator's hints."""

    def __init__(self, op: StencilOperator, axis):
        s0 = op.grid_shape[0]
        lo, hi = _row_range(s0, axis)
        plane = op.shape[0] // s0
        LocalStencilOperator.__init__(
            self, op.coeffs.to(axis.device), (hi - lo,) + op.grid_shape[1:],
            op.offsets, s0, axis, is_hermitian=op.is_hermitian)
        self._init_sharded(op, axis, (hi - lo) * plane)

    _local_matvec = LocalStencilOperator.matvec


class ShardedELLOperator(_Sharded):
    """This rank's rows of a ``SparseELLOperator`` (global column indices)
    against the all-gathered x."""

    def __init__(self, op: SparseELLOperator, axis):
        lo, hi = _row_range(op.shape[0], axis)
        self._init_sharded(op, axis, hi - lo)
        self.data = op.data.detach()[lo:hi].to(axis.device)
        self.cols = op.cols[lo:hi].to(axis.device)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def _local_matvec(self, x):
        return (self.data * self.comm.all_gather(x)[self.cols]).sum(dim=1)

    def _adjoint_matvec(self, g):
        rt = torch.promote_types(self.dtype, g.dtype)
        v = torch.zeros(self.n_global, dtype=rt, device=g.device)
        v.index_add_(0, self.cols.reshape(-1).long(),
                     (self.data.conj().to(rt) * g.to(rt)[:, None]).reshape(-1))
        return self._scatter_rows(v)


class ShardedBlockELLOperator(_Sharded):
    """This rank's block rows of a ``BlockELLOperator`` against the
    all-gathered x: kernel B8 on CUDA (nbr_local block rows by every block
    column), its twin on CPU. ``bcols`` are the global block columns, in
    range by the global operator's check."""

    def __init__(self, op: BlockELLOperator, axis):
        br = op.block_shape[0]
        lo, hi = _row_range(op.shape[0], axis, unit=br)
        self._init_sharded(op, axis, hi - lo)
        self.blocks = op.blocks.detach()[lo // br:hi // br].to(axis.device)
        self.bcols = op.bcols[lo // br:hi // br].to(axis.device)

    @property
    def block_shape(self):
        return (self.blocks.shape[2], self.blocks.shape[3])

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    def _local_matvec(self, x):
        xg = self.comm.all_gather(x)
        kern, rt = _kernel(self.dtype, xg)
        if not kern:
            return blockell_spmv_ref(self.blocks, self.bcols, xg)
        return blockell_spmv(_promoted(self, "blocks", rt), self.bcols,
                             xg.to(rt))

    def _adjoint_matvec(self, g):
        nbr, w, br, bc = self.blocks.shape
        rt = torch.promote_types(self.dtype, g.dtype)
        part = torch.einsum("iwrc,ir->iwc", self.blocks.conj().to(rt),
                            g.to(rt).reshape(nbr, br))
        v = torch.zeros((self.n_global // bc, bc), dtype=rt, device=g.device)
        v.index_add_(0, self.bcols.reshape(-1).long(), part.reshape(-1, bc))
        return self._scatter_rows(v.reshape(-1))


class ShardedDenseOperator(_Sharded):
    """This rank's rows of a ``DenseOperator`` (n_local, n) times the
    all-gathered x."""

    def __init__(self, op: DenseOperator, axis):
        lo, hi = _row_range(op.shape[0], axis)
        self._init_sharded(op, axis, hi - lo)
        self.A = op.A.detach()[lo:hi].to(axis.device)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def _local_matvec(self, x):
        xg = self.comm.all_gather(x)
        rt = torch.promote_types(self.A.dtype, xg.dtype)
        return self.A.to(rt) @ xg.to(rt)

    def _adjoint_matvec(self, g):
        rt = torch.promote_types(self.A.dtype, g.dtype)
        return self._scatter_rows(self.A.to(rt).mH @ g.to(rt))


def shard_operator(op: LinearOperator, mesh: Mesh,
                   axis_name: str | None = None) -> LinearOperator:
    """This rank's view of ``op`` row-partitioned over
    ``mesh.axis(axis_name)`` (module doc). Every rank of the axis calls it
    with the same global operator; pass the result, with this rank's rows
    of a vector (``parallel.shard_vector``), to any driver of the package.
    Results are this rank's rows (``parallel.gather_vector`` assembles
    them)."""
    axis = mesh.axis(axis_name)
    if isinstance(op, BandedOperator):
        return ShardedBandedOperator(op, axis)
    if isinstance(op, StencilOperator):
        return ShardedStencilOperator(op, axis)
    if isinstance(op, SparseELLOperator):
        return ShardedELLOperator(op, axis)
    if isinstance(op, BlockELLOperator):
        return ShardedBlockELLOperator(op, axis)
    if isinstance(op, DenseOperator):
        return ShardedDenseOperator(op, axis)
    raise TypeError(f"cannot shard operator of type {type(op).__name__}")

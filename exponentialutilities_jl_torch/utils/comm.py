"""How a driver learns that its operator's rows are sharded (the port's
counterpart of JAX's sharding annotations).

A row-sharded operator (``parallel.shard_operator``, and the explicit
layer's local operators) carries ``comm``, the ``parallel.MeshAxis`` its
rows are partitioned over; the vectors it is applied to are this rank's
rows. The Krylov builders (``ops/krylov.py``) read it from the operator
they are given; every driver reads ``operator_comm(op)`` once at entry for
its own reductions, the helpers below, which turn a rank's partial value
into the global one. Every host decision of a driver is taken from such
reduced values, which are the same on every rank, so the ranks branch
together and meet in the same collectives. With ``comm`` None every helper returns the single-device
value with no collective.

A ``MeshAxis`` has no tag that survives a tensor op, so it rides on the
operator (and on ``JacobianOperator``, for the integrators that take only
``f`` and ``u0``), never on a tensor.
"""

from __future__ import annotations

import torch

__all__ = ["operator_comm", "owned", "psum", "pmax", "vector_norm", "vdot",
           "dots", "all_finite", "AugmentedAxis"]


def operator_comm(op):
    """The ``MeshAxis`` that ``op``'s rows are sharded over, or None."""
    return getattr(op, "comm", None)


def owned(x, comm, dim: int = -1):
    """The part of x (along ``dim``, its rows) whose entries this rank adds
    to a global sum: all of it, except the replicated tail of an augmented
    vector (``AugmentedAxis``) off axis index 0."""
    own = getattr(comm, "owned", None)
    return x if own is None else own(x, dim)


def psum(x, comm):
    """The global sum of per-rank partial sums ``x``."""
    return x if comm is None else comm.psum(x)


def pmax(x, comm):
    """The global maximum of per-rank maxima ``x``."""
    return x if comm is None else comm.pmax(x)


def vector_norm(x, comm, dim=None):
    """2-norm of x over every rank's rows: of the whole vector x, or of
    each column along ``dim`` (the rows' axis; -1 for the rows of a
    (batch, n) block). One psum of the local squared sums, each entry of
    an augmented tail taken once."""
    if comm is None:
        return torch.linalg.vector_norm(x, dim=dim)
    x = owned(x, comm, 0 if dim is None else dim)
    return torch.sqrt(comm.psum((x.conj() * x).real.sum(dim=dim)))


def _vdot(x, y):
    return torch.vdot(x, y) if x.ndim == 1 else torch.linalg.vecdot(x, y)


def _dots(W, y):
    return W.conj() @ y if y.ndim == 1 else (W.conj() @ y[..., None])[..., 0]


def vdot(x, y, comm):
    """x^H y over every rank's rows (one psum); (batch, n) rows give the
    (batch,) dots, reduced in one psum."""
    if comm is None:
        return _vdot(x, y)
    return comm.psum(_vdot(owned(x, comm), owned(y, comm)))


def dots(W, y, comm):
    """W^H y: each row of W (k, n) against y (n,), over every rank's rows
    (one psum); W (batch, k, n) against y (batch, n) gives (batch, k), in
    one psum."""
    if comm is None:
        return _dots(W, y)
    return comm.psum(_dots(owned(W, comm), owned(y, comm)))


def all_finite(x, comm, *more):
    """0-d bool tensor: every entry of x (and of ``more``) on every rank is
    finite (one pmax of the local count of non-finite entries)."""
    bad = (~torch.isfinite(x)).sum()
    for y in more:
        bad = bad + (~torch.isfinite(y)).sum()
    if comm is not None:
        bad = comm.pmax(bad.to(torch.float64))
    return bad == 0


class AugmentedAxis:
    """The axis of KIOPS' augmented vectors [x_local; x_aug] (``models/
    kiops.AugmentedOperator`` over a sharded operator): x_aug's p entries
    are replicated on every rank, so a global sum takes them from axis
    index 0 only (``owned``); every rank keeps and updates them. The
    collectives are the wrapped axis's."""

    def __init__(self, axis, n_local: int):
        self.axis = axis
        self.n_local = int(n_local)

    def __getattr__(self, name):
        # name, index, size, device, census, ranks, psum, pmax, ... of the
        # wrapped axis
        return getattr(self.axis, name)

    def owned(self, x, dim: int = -1):
        if self.axis.axis_index() == 0:
            return x
        return x.narrow(dim, 0, self.n_local)

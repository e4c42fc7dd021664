"""Matrix-free linear-operator protocol (PyTorch port of
``exponentialutilities_jl_tpu/utils/linop.py``).

Any object exposing ``shape``, ``dtype``, ``device``, a ``matvec`` and
``is_hermitian`` (plus an optional ``opnorm_hint``) works with every
Krylov-level API of the port. Operators hold tensors; the device of those
tensors is the device of the computation.

``matmat(X)`` applies the operator to each row of a (batch, n) block (the
batched Krylov builders' product, ``ops/krylov.py``). Its default is the
operator's own ``matvec`` on each row, stacked: each row then launches
that operator's own kernel where it has one (SELL: B9, block-ELL: B8),
the explicit dispatch for operators whose kernel has no batched form.
``DenseOperator`` takes one GEMM, ``DiagonalOperator`` one broadcast
product, ``NegatedOperator`` its inner operator's ``matmat``; the stencils
and ``BandedOperator`` (kernel K1, B7's batched form) override it too.
``apply_rows`` is the same for any object of the protocol, with or
without a ``matmat``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .device import host_tensor, resolve_device

__all__ = ["LinearOperator", "DenseOperator", "MatrixFreeOperator",
           "DiagonalOperator", "NegatedOperator", "aslinearoperator",
           "JacobianOperator", "apply_rows"]


class LinearOperator:
    """Base class: a square linear operator.

    Subclasses provide ``shape`` ((n, n) ints), ``dtype``, ``device``,
    ``matvec(x)`` (``A @ x`` for an (n,) tensor), ``is_hermitian`` and
    optionally ``opnorm_hint()``.
    """

    shape: tuple
    is_hermitian: bool = False

    def matvec(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def matmat(self, X):
        """A applied to each row of X (batch, n): ``matvec`` row by row,
        stacked (module doc)."""
        return torch.stack([self.matvec(x) for x in X.unbind(0)])

    def opnorm_hint(self) -> Optional[torch.Tensor]:
        return None

    def __call__(self, x):
        return self.matvec(x)


def apply_rows(op, X):
    """``op.matmat(X)`` for X (batch, n), or the rows' ``matvec``s
    stacked for an operator of the protocol without one."""
    mm = getattr(op, "matmat", None)
    if mm is not None:
        return mm(X)
    return torch.stack([op.matvec(x) for x in X.unbind(0)])


class DenseOperator(LinearOperator):
    """Dense matrix as an operator. ``is_hermitian=None`` detects symmetry
    lazily on first read of the property (one reduction and host sync),
    never at construction."""

    def __init__(self, A, is_hermitian: Optional[bool] = None):
        self.A = host_tensor(A)
        self._is_hermitian = is_hermitian

    @property
    def is_hermitian(self):
        if self._is_hermitian is None:
            self._is_hermitian = bool(torch.allclose(self.A, self.A.mH))
        return self._is_hermitian

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def matvec(self, x):
        # torch does not promote real @ complex: a real matrix meets a
        # complex vector in their common type
        rt = torch.promote_types(self.A.dtype, x.dtype)
        return self.A.to(rt) @ x.to(rt)

    def matmat(self, X):
        """X A^T: one GEMM for the whole block."""
        rt = torch.promote_types(self.A.dtype, X.dtype)
        return X.to(rt) @ self.A.to(rt).mT

    def opnorm_hint(self):
        return self.A.abs().sum(dim=1).max()


class DiagonalOperator(LinearOperator):
    """Diagonal operator ``diag(d)``.

    ``is_hermitian=None`` means Hermitian exactly when ``d`` has a real
    dtype (a complex diagonal is Hermitian only if it is real, which a
    dtype cannot tell); an explicit bool is honoured as given.
    """

    def __init__(self, d, is_hermitian: Optional[bool] = None):
        self.d = host_tensor(d)
        self.is_hermitian = (not self.d.is_complex() if is_hermitian is None
                             else bool(is_hermitian))

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    def matvec(self, x):
        return self.d * x

    def matmat(self, X):
        return self.d * X

    def opnorm_hint(self):
        return self.d.abs().max()


class MatrixFreeOperator(LinearOperator):
    """Wrap a callable ``x -> A @ x`` as an operator."""

    def __init__(self, matvec: Callable, shape, dtype=torch.float64,
                 is_hermitian: bool = False, opnorm: Optional[float] = None,
                 device=None):
        self._matvec = matvec
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.is_hermitian = bool(is_hermitian)
        self._opnorm = opnorm

    def matvec(self, x):
        return self._matvec(x)

    def opnorm_hint(self):
        if self._opnorm is None:
            return None
        return torch.as_tensor(self._opnorm)


class NegatedOperator(LinearOperator):
    """``-A`` for any operator; Hermitian-ness, norm hints and ``nnz``
    forward to the wrapped operator."""

    def __init__(self, inner: LinearOperator):
        self.inner = inner

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def is_hermitian(self):
        return self.inner.is_hermitian

    @property
    def nnz(self):
        return self.inner.nnz

    @property
    def comm(self):
        return getattr(self.inner, "comm", None)

    def matvec(self, x):
        return -self.inner.matvec(x)

    def matmat(self, X):
        return -apply_rows(self.inner, X)

    def opnorm_hint(self):
        return self.inner.opnorm_hint()


def aslinearoperator(A, is_hermitian: Optional[bool] = None) -> LinearOperator:
    """Coerce ``A`` (operator, tensor or numpy array) to a LinearOperator."""
    if isinstance(A, LinearOperator):
        return A
    A = host_tensor(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"expected a square matrix, got shape {tuple(A.shape)}")
    return DenseOperator(A, is_hermitian=is_hermitian)


class JacobianOperator(LinearOperator):
    """The Jacobian J_f(u) of ``f`` as a matrix-free operator:
    ``matvec(v) = torch.func.jvp(f, (u,), (v,))[1]``, one forward-mode
    pass that never forms the matrix. ``f`` must be written in torch
    operations that forward-mode AD can follow; the sparse containers'
    kernel matvecs are (``ops/sparse.py``). Each matvec evaluates f(u) as
    well as its derivative. The linearization point ``u`` is a tensor
    (host data goes to ``device``, default the default device).

    What the exponential integrators use when ``jac`` is None. ``comm``:
    the ``parallel.MeshAxis`` that u's rows are sharded over (f then maps
    this rank's rows to this rank's rows, e.g. through an operator of
    ``parallel.shard_operator``); the Krylov steps on J reduce over it,
    and ``shape`` is the global one."""

    def __init__(self, f: Callable, u, is_hermitian: bool = False, *,
                 device=None, comm=None):
        self.f = f
        self.u = host_tensor(u, device)
        self.is_hermitian = bool(is_hermitian)
        self.comm = comm

    @property
    def shape(self):
        n = self.u.shape[0]
        if self.comm is not None:
            n *= self.comm.axis_size()
        return (n, n)

    @property
    def dtype(self):
        return self.u.dtype

    @property
    def device(self):
        return self.u.device

    def matvec(self, v):
        return torch.func.jvp(self.f, (self.u,), (v.to(self.u.dtype),))[1]

"""Carry an operator's data across from the JAX package to the port.

An operator is described by plain data: numpy arrays plus static fields,

    {"type": "StencilOperator", "grid_shape", "offsets", "coeffs",
     "is_hermitian"}
    {"type": "VariableStencilOperator", "grid_shape", "offsets",
     "coeff_fields" (k, n), "is_hermitian"}
    {"type": "BandedOperator", "diags", "offsets", "is_hermitian"}
    {"type": "SparseELLOperator", "data", "cols", "is_hermitian"}
    {"type": "BlockELLOperator", "blocks", "bcols", "is_hermitian"}
    {"type": "DenseOperator", "A", "is_hermitian"}
    {"type": "DiagonalOperator", "d", "is_hermitian"}

``operator_data`` reads that description off any operator object with the
JAX package's field names (it converts arrays with ``numpy.asarray`` and
imports nothing of JAX); ``from_operator_data`` builds the port's operator
from it. Together they let both packages apply the same operator.

A ``DiagonalOperator`` carries ``is_hermitian`` as True only when the
source says so **and** its ``d`` is real: the JAX package's flag defaults
to True even for a complex ``d``, where it would send the port's drivers
to Lanczos on a non-Hermitian matrix.
"""

from __future__ import annotations

import numpy as np

from ..ops.sparse import BandedOperator, BlockELLOperator, SparseELLOperator
from ..ops.stencil import StencilOperator, VariableStencilOperator
from .device import host_tensor
from .linop import DenseOperator, DiagonalOperator, LinearOperator

__all__ = ["operator_data", "from_operator_data", "to_torch_operator"]


def operator_data(op) -> dict:
    """The plain-data description (module doc) of a supported operator."""
    kind = type(op).__name__
    if kind == "StencilOperator":
        return {"type": kind, "grid_shape": tuple(op.grid_shape),
                "offsets": tuple(tuple(o) for o in op.offsets),
                "coeffs": np.asarray(op.coeffs),
                "is_hermitian": bool(op.is_hermitian)}
    if kind == "VariableStencilOperator":
        return {"type": kind, "grid_shape": tuple(op.grid_shape),
                "offsets": tuple(tuple(o) for o in op.offsets),
                "coeff_fields": np.asarray(op.coeff_fields),
                "is_hermitian": bool(op.is_hermitian)}
    if kind == "BandedOperator":
        return {"type": kind, "diags": np.asarray(op.diags),
                "offsets": tuple(op.offsets),
                "is_hermitian": bool(op.is_hermitian)}
    if kind == "SparseELLOperator":
        return {"type": kind, "data": np.asarray(op.data),
                "cols": np.asarray(op.cols),
                "is_hermitian": bool(op.is_hermitian)}
    if kind == "BlockELLOperator":
        return {"type": kind, "blocks": np.asarray(op.blocks),
                "bcols": np.asarray(op.bcols),
                "is_hermitian": bool(op.is_hermitian)}
    if kind == "DenseOperator":
        herm = getattr(op, "_is_hermitian", None)
        return {"type": kind, "A": np.asarray(op.A),
                "is_hermitian": None if herm is None else bool(herm)}
    if kind == "DiagonalOperator":
        d = np.asarray(op.d)
        return {"type": kind, "d": d,
                "is_hermitian": bool(op.is_hermitian)
                and not np.iscomplexobj(d)}
    raise TypeError(f"no plain-data description for {kind}")


def from_operator_data(data: dict, *, device=None,
                       dtype=None) -> LinearOperator:
    """Build the port's operator from ``operator_data`` output, placing its
    tensors on ``device`` (default: ``utils.device.default_device()``)
    with ``dtype`` (default: the data's)."""
    kind = data["type"]

    def tensor(a):
        return host_tensor(np.array(a), device, dtype)

    if kind == "StencilOperator":
        return StencilOperator(data["grid_shape"], data["offsets"],
                               np.array(data["coeffs"]),
                               is_hermitian=data["is_hermitian"],
                               dtype=dtype, device=device)
    if kind == "VariableStencilOperator":
        return VariableStencilOperator(data["grid_shape"], data["offsets"],
                                       tensor(data["coeff_fields"]),
                                       is_hermitian=data["is_hermitian"])
    if kind == "BandedOperator":
        return BandedOperator(tensor(data["diags"]), data["offsets"],
                              is_hermitian=data["is_hermitian"])
    if kind == "SparseELLOperator":
        return SparseELLOperator(tensor(data["data"]),
                                 host_tensor(np.array(data["cols"]), device),
                                 is_hermitian=data["is_hermitian"])
    if kind == "BlockELLOperator":
        return BlockELLOperator(tensor(data["blocks"]),
                                host_tensor(np.array(data["bcols"]), device),
                                is_hermitian=data["is_hermitian"])
    if kind == "DenseOperator":
        return DenseOperator(tensor(data["A"]),
                             is_hermitian=data["is_hermitian"])
    if kind == "DiagonalOperator":
        return DiagonalOperator(tensor(data["d"]),
                                is_hermitian=data["is_hermitian"])
    raise TypeError(f"unknown operator type {kind!r}")


def to_torch_operator(op, *, device=None, dtype=None) -> LinearOperator:
    """``from_operator_data(operator_data(op))``."""
    return from_operator_data(operator_data(op), device=device, dtype=dtype)

"""The distributed layer on ``torch.distributed`` (PyTorch port of
``exponentialutilities_jl_tpu/parallel/``): one rank per shard
(``parallel/mesh.py``), halo-exchange local operators (``ops.py``,
``stencil.py``), the row-sharded Krylov, Chebyshev, Leja and Faber actions
(``krylov.py``, ``poly.py``), their shard-local fused sweeps on kernels B3
and B3-var (``stencil_fused.py``) and the multi-node meshes
(``multihost.py``); and the GSPMD route (``gspmd.py``): ``shard_operator``
gives this rank's view of a Banded, constant Stencil, ELL, block-ELL or
dense operator, which every driver of the package takes as it takes the
global one, on this rank's rows (``utils/comm.py``)."""

from .gspmd import shard_operator
from .krylov import (expv_chebyshev_sharded, expv_sharded, make_expv_step,
                     phiv_sharded)
from .mesh import Mesh, MeshAxis, gather_vector, make_mesh
from .multihost import (initialize_distributed, make_global_mesh,
                        make_host_data_mesh)
from .ops import LocalBandedOperator, shard_banded, shard_vector
from .poly import expv_faber_sharded, expv_leja_sharded
from .stencil import LocalStencilOperator, shard_stencil

__all__ = [
    "make_mesh", "shard_vector", "shard_banded", "LocalBandedOperator",
    "expv_sharded", "phiv_sharded", "make_expv_step",
    "expv_chebyshev_sharded", "expv_leja_sharded", "expv_faber_sharded",
    "shard_stencil", "LocalStencilOperator",
    "initialize_distributed", "make_global_mesh", "make_host_data_mesh",
    "Mesh", "MeshAxis", "gather_vector", "shard_operator",
]

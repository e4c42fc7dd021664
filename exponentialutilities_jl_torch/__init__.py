"""exponentialutilities_jl_torch: the PyTorch/CUDA port of
``exponentialutilities_jl_tpu``.

The port runs the exp(tA)b and phi-function actions: the operator
containers (constant and variable-coefficient stencils, diagonal storage,
ELL, block-ELL, and the SELL-C-sigma containers for unstructured matrices
from scipy), Lanczos and Arnoldi (full or IOP window, storage-free
two-pass forms), the dense exponential and phi functions that the Krylov
path reduces to, the Chebyshev and Krylov (happy-breakdown, error-estimate
and storage-free two-pass) actions, the adaptive drivers (Niesen-Wright
time stepping and KIOPS, each also with the JAX device loop's control
flow) and the truncated-Taylor expv, the non-Hermitian polynomial actions
(Leja, Faber) and the exponential integrators (exprb32, exprb43, etdrk4
and their device forms, with a matrix-free JacobianOperator), the dense
layer (every expm method, balancing and gebal, batched stacks, phi and
the Al-Mohy-Liu phi_pade, Schur-Parlett funm, double-double and mpmath),
and eleven hand-written CUDA kernels
for NVIDIA Hopper (``ops/kernels/csrc/``): seven that carry the
recurrences (B3-var the variable-coefficient sweep) and four SpMV kernels
behind the sparse containers' matvecs. The JAX package is the reference;
each public name here mirrors its counterpart there.

Host data (numpy, lists, scipy matrices) given to a constructor or an
action goes to the default device, ``cuda`` unless changed with
``set_default_device``; without a GPU that raises until the caller asks for
the CPU (``device="cpu"`` or ``set_default_device("cpu")``).

Public API

Devices          set_default_device, default_device
Operators        LinearOperator, DenseOperator, DiagonalOperator,
                 MatrixFreeOperator, NegatedOperator, JacobianOperator,
                 aslinearoperator,
                 BandedOperator, StencilOperator, VariableStencilOperator,
                 laplacian_nd_stencil, variable_diffusion_nd_stencil,
                 advection_diffusion_3d_stencil,
                 advection_diffusion_1d_stencil
Sparse           SparseELLOperator, BlockELLOperator, SellOperator,
                 SortedSellOperator, HybridOperator, ell_from_scipy,
                 blockell_from_scipy, banded_from_scipy, hybrid_from_scipy,
                 hoist_conjugation
Test matrices    laplacian_1d, poisson_2d, laplacian_3d,
                 advection_diffusion_1d
Transfer         operator_data, from_operator_data, to_torch_operator
Dense            expm, expm_higham2005, expm_higham2005_batched,
                 expm_generic, expm_diagonalization, expm_native,
                 expm_taylor, balance_matrix, gebal, expm_gebal, phi,
                 phi_scalar, phi_taylor, phi_taylor_batched, phi_with_info,
                 phi_pade, phi_pade_with_info, phiv_dense, funm,
                 funm_schur_parlett
Extended         expm_mp, expm_dd, DD, phi_dd, phiv_dense_dd, expv_dd
Krylov           KrylovBasis, lanczos, lanczos_coeffs, lanczos_replay,
                 arnoldi, arnoldi_extend, arnoldi_coeffs, arnoldi_replay,
                 expand_compact_hessenberg
Actions          expv, expv_from_basis, build_subspace, make_expv,
                 expv_batched, phiv,
                 phiv_from_basis, make_phiv, expv_chebyshev,
                 phiv_chebyshev, funm_chebyshev, phiv_timestep_chebyshev,
                 chebyshev_apply, spectral_bounds
Time stepping    phiv_timestep, expv_timestep, TimestepStats,
                 phiv_timestep_fused, expv_timestep_fused,
                 make_phiv_timestep, phiv_timestep_device,
                 expv_timestep_device
KIOPS            kiops, KiopsStats, AugmentedOperator, kiops_device
Taylor           expv_taylor, expv_taylor_batched, taylor_theta
Leja, Faber      expv_leja, phiv_leja, phiv_timestep_leja, leja_points,
                 real_interval, expv_faber, phiv_faber,
                 phiv_timestep_faber, fov_ellipse, faber_coeffs
Integrators      exprb32, exprb43, etdrk4, ExpIntStats, etdrk4_device,
                 exprb43_device, exprb32_device
"""

from .models.chebyshev import (chebyshev_apply, expv_chebyshev, funm_chebyshev,
                               phiv_chebyshev, phiv_timestep_chebyshev,
                               spectral_bounds)
from .models.expv import (build_subspace, expv, expv_batched, expv_from_basis,
                          make_expv)
from .models.faber import (expv_faber, faber_coeffs, fov_ellipse,
                           phiv_faber, phiv_timestep_faber)
from .models.integrators import (ExpIntStats, etdrk4, etdrk4_device, exprb32,
                                 exprb32_device, exprb43, exprb43_device)
from .models.leja import (expv_leja, leja_points, phiv_leja,
                          phiv_timestep_leja, real_interval)
from .models.expv_taylor import (expv_taylor, expv_taylor_batched,
                                 taylor_theta)
from .models.kiops import AugmentedOperator, KiopsStats, kiops
from .models.kiops_device import kiops_device
from .models.nw_device import expv_timestep_device, phiv_timestep_device
from .models.phiv import make_phiv, phiv, phiv_from_basis
from .models.timestepping import (TimestepStats, expv_timestep,
                                  expv_timestep_fused, make_phiv_timestep,
                                  phiv_timestep, phiv_timestep_fused)
from .ops.expm import (balance_matrix, expm, expm_diagonalization, expm_gebal,
                       expm_generic, expm_higham2005, expm_higham2005_batched,
                       expm_native, expm_taylor, gebal)
from .ops.expm_dd import DD, expm_dd
from .ops.expm_mp import expm_mp
from .ops.funm import funm, funm_schur_parlett
from .ops.phi_dd import expv_dd, phi_dd, phiv_dense_dd
from .ops.krylov import (KrylovBasis, arnoldi, arnoldi_coeffs, arnoldi_extend,
                         arnoldi_replay, expand_compact_hessenberg, lanczos,
                         lanczos_coeffs, lanczos_replay)
from .ops.phi_almohy import phi_pade, phi_pade_with_info
from .ops.phi_dense import (phi, phi_scalar, phi_taylor, phi_taylor_batched,
                            phi_with_info, phiv_dense)
from .ops.sparse import (BandedOperator, BlockELLOperator, HybridOperator,
                         SellOperator, SortedSellOperator, SparseELLOperator,
                         banded_from_scipy, blockell_from_scipy,
                         ell_from_scipy, hoist_conjugation, hybrid_from_scipy)
from .ops.stencil import (StencilOperator, VariableStencilOperator,
                          advection_diffusion_1d_stencil,
                          advection_diffusion_3d_stencil,
                          laplacian_nd_stencil, variable_diffusion_nd_stencil)
from .utils.convert import from_operator_data, operator_data, to_torch_operator
from .utils.device import default_device, set_default_device
from .utils.linop import (DenseOperator, DiagonalOperator, JacobianOperator,
                          LinearOperator, MatrixFreeOperator, NegatedOperator,
                          aslinearoperator)
from .utils.testmatrices import (advection_diffusion_1d, laplacian_1d,
                                 laplacian_3d, poisson_2d)

__all__ = [
    "set_default_device", "default_device",
    "LinearOperator", "DenseOperator", "DiagonalOperator",
    "MatrixFreeOperator", "NegatedOperator", "aslinearoperator",
    "BandedOperator", "StencilOperator", "VariableStencilOperator",
    "laplacian_nd_stencil", "variable_diffusion_nd_stencil",
    "advection_diffusion_3d_stencil", "advection_diffusion_1d_stencil",
    "SparseELLOperator", "BlockELLOperator", "SellOperator",
    "SortedSellOperator", "HybridOperator", "ell_from_scipy",
    "blockell_from_scipy", "banded_from_scipy", "hybrid_from_scipy",
    "hoist_conjugation",
    "laplacian_1d", "poisson_2d", "laplacian_3d", "advection_diffusion_1d",
    "operator_data", "from_operator_data", "to_torch_operator",
    "expm", "expm_higham2005", "expm_higham2005_batched", "expm_generic",
    "expm_diagonalization", "expm_native", "expm_taylor", "balance_matrix",
    "gebal", "expm_gebal", "funm", "funm_schur_parlett",
    "expm_mp", "expm_dd", "DD", "phi_dd", "phiv_dense_dd", "expv_dd",
    "phi", "phi_scalar", "phi_taylor", "phi_taylor_batched",
    "phi_with_info", "phi_pade", "phi_pade_with_info", "phiv_dense",
    "KrylovBasis", "lanczos", "lanczos_coeffs", "lanczos_replay",
    "arnoldi", "arnoldi_extend", "arnoldi_coeffs", "arnoldi_replay",
    "expand_compact_hessenberg",
    "expv", "expv_from_basis", "build_subspace", "make_expv", "expv_batched",
    "phiv", "phiv_from_basis", "make_phiv",
    "expv_chebyshev", "phiv_chebyshev", "funm_chebyshev",
    "phiv_timestep_chebyshev", "chebyshev_apply", "spectral_bounds",
    "phiv_timestep", "expv_timestep", "TimestepStats",
    "phiv_timestep_fused", "expv_timestep_fused", "make_phiv_timestep",
    "phiv_timestep_device", "expv_timestep_device",
    "kiops", "KiopsStats", "AugmentedOperator", "kiops_device",
    "expv_taylor", "expv_taylor_batched", "taylor_theta",
    "JacobianOperator",
    "expv_leja", "phiv_leja", "phiv_timestep_leja", "leja_points",
    "real_interval",
    "expv_faber", "phiv_faber", "phiv_timestep_faber", "fov_ellipse",
    "faber_coeffs",
    "exprb32", "exprb43", "etdrk4", "ExpIntStats",
    "etdrk4_device", "exprb43_device", "exprb32_device",
]

"""Host-side sparse packers shared with the JAX package.

``exponentialutilities_jl_tpu/native/__init__.py`` is framework-free: it
imports ``ctypes``, ``numpy`` and ``subprocess`` (and ``scipy`` inside its
functions), builds ``native/src/sparse_pack.cpp`` with g++ at first use,
and keeps a numpy fallback for every entry point. Importing it as
``exponentialutilities_jl_tpu.native`` would run that package's
``__init__``, which imports jax, so this module loads the file by its path
instead. Both packages then run the same packers and the same reverse
Cuthill-McKee permutation.

    csr_to_ell_arrays(A, dtype=None)          -> (vals (n, w), cols (n, w))
    bsr_to_blockell_arrays(A, br, bc, dtype)  -> (blocks (nbr, w, br, bc),
                                                  bcols (nbr, w))
    csr_to_banded_arrays(A, offsets, dtype)   -> (diags (k, n), dropped)
    csr_band_offsets(A, max_out=64)           -> sorted offsets, or None
    rcm_ordering(A)                           -> perm, perm[new] = old

``rcm_ordering`` checks the native result: the C++ search
(``native/src/sparse_pack.cpp:198-205``) starts each component at the
lowest-degree unvisited vertex at or after the first unvisited one and
never returns to that first vertex when the two differ and lie in
different components (an isolated row after a connected one, for
instance), so it returns fewer than n distinct vertices. Where the result
is not a permutation, the port takes scipy's ``reverse_cuthill_mckee`` of
the same symmetrized pattern (the JAX module's own fallback).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

__all__ = ["csr_to_ell_arrays", "bsr_to_blockell_arrays",
           "csr_to_banded_arrays", "csr_band_offsets", "rcm_ordering"]

_SOURCE = (Path(__file__).resolve().parents[2] / "exponentialutilities_jl_tpu"
           / "native" / "__init__.py")
_NAME = "_eu_native_host"


def _load():
    mod = sys.modules.get(_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[_NAME] = mod
    return mod


_native = _load()
csr_to_ell_arrays = _native.csr_to_ell_arrays
bsr_to_blockell_arrays = _native.bsr_to_blockell_arrays
csr_to_banded_arrays = _native.csr_to_banded_arrays
csr_band_offsets = _native.csr_band_offsets


def rcm_ordering(A):
    """Reverse Cuthill-McKee permutation (perm[new] = old) of the pattern of
    A + A^T: the native ordering when it is a permutation, else scipy's
    (module doc)."""
    perm = _native.rcm_ordering(A)
    n = A.shape[0]
    if np.array_equal(np.sort(perm), np.arange(n)):
        return perm
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = (A.tocsr() + A.tocsr().T).tocsr()
    return reverse_cuthill_mckee(S).astype(np.int32)

"""Host-side sparse packers of the port (``exponentialutilities_jl_torch/
native/``): the JAX package's C++ packers, copied into the port and built
into ``exponentialutilities_jl_torch/_build/``, so the port loads no file
of the JAX package.

    csr_to_ell_arrays(A, dtype=None)          -> (vals (n, w), cols (n, w))
    bsr_to_blockell_arrays(A, br, bc, dtype)  -> (blocks (nbr, w, br, bc),
                                                  bcols (nbr, w))
    csr_to_banded_arrays(A, offsets, dtype)   -> (diags (k, n), dropped)
    csr_band_offsets(A, max_out=64)           -> sorted offsets, or None
    rcm_ordering(A)                           -> perm, perm[new] = old

The copy repairs the RCM start-vertex search, which lost the first
unvisited vertex of a component when the lowest-degree start lay in
another component (isolated rows after connected ones); orderings that
were permutations before are unchanged, and ``rcm_ordering`` raises if a
result is not a permutation.
"""

from __future__ import annotations

from ..native import (bsr_to_blockell_arrays, csr_band_offsets,
                      csr_to_banded_arrays, csr_to_ell_arrays, rcm_ordering)

__all__ = ["csr_to_ell_arrays", "bsr_to_blockell_arrays",
           "csr_to_banded_arrays", "csr_band_offsets", "rcm_ordering"]

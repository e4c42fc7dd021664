"""ctypes bindings for the port's host-side sparse packers
(``src/sparse_pack.cpp``; the port's own copy of the JAX package's
packers, with the RCM start-vertex search repaired).

The library is built with g++ on first use into
``exponentialutilities_jl_torch/_build/`` (gitignored), named by a hash of
the source and flags, so an edited source rebuilds and concurrent
processes never read a half-written file. Every entry point has a
numpy-vectorized fallback for a machine without g++, which gives the same
arrays (for ``rcm_ordering``: scipy's reverse Cuthill-McKee).

  csr_to_ell_arrays(A, dtype=None)          -> (vals (n, w), cols (n, w))
  bsr_to_blockell_arrays(A, br, bc, dtype)  -> (blocks (nbr, w, br, bc),
                                                bcols (nbr, w))
  csr_to_banded_arrays(A, offsets, dtype)   -> (diags (k, n), dropped)
  csr_band_offsets(A, max_out=64)           -> sorted offsets, or None
  rcm_ordering(A)                           -> perm, perm[new] = old
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["load_native", "csr_to_ell_arrays", "bsr_to_blockell_arrays",
           "csr_to_banded_arrays", "csr_band_offsets", "rcm_ordering"]

_SRC = Path(__file__).resolve().parent / "src" / "sparse_pack.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no -march=native: the build directory may travel with a copy of the tree
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


def _build() -> Path | None:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    lib = _BUILD_DIR / f"libeujl_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


@functools.cache
def load_native():
    """The loaded ctypes library, or None when g++ is unavailable."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    for suf, fp in (("f64", _f64p), ("f32", _f32p)):
        fn = getattr(lib, f"csr_to_ell_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, fp, fp,
                       _i32p]
        fn = getattr(lib, f"bsr_to_blockell_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64p,
                       _i32p, fp, fp, _i32p]
        fn = getattr(lib, f"csr_to_banded_{suf}")
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i32p,
                       fp, fp, _i64p]
    lib.csr_band_offsets.restype = ctypes.c_int64
    lib.csr_band_offsets.argtypes = [ctypes.c_int64, _i64p, _i32p, _i64p,
                                     ctypes.c_int64]
    lib.rcm_ordering.restype = None
    lib.rcm_ordering.argtypes = [ctypes.c_int64, _i64p, _i32p, _i32p]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctype)


def _csr_parts(A):
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    return indptr, indices


def csr_to_ell_arrays(A, dtype=None):
    """(vals (n,w), cols (n,w)) padded-ELL arrays from scipy CSR."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    dt = np.dtype(dtype) if dtype is not None else A.data.dtype
    data = np.ascontiguousarray(A.data, dtype=dt)
    counts = np.diff(indptr)
    w = max(1, int(counts.max())) if n else 1
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        vals = np.empty((n, w), dtype=dt)
        cols = np.empty((n, w), dtype=np.int32)
        fp = _f64p if dt == np.float64 else _f32p
        fn = lib.csr_to_ell_f64 if dt == np.float64 else lib.csr_to_ell_f32
        fn(n, w, _ptr(indptr, _i64p), _ptr(indices, _i32p), _ptr(data, fp),
           _ptr(vals, fp), _ptr(cols, _i32p))
        return vals, cols
    vals = np.zeros((n, w), dtype=dt)
    cols = np.zeros((n, w), dtype=np.int32)
    row = np.repeat(np.arange(n), counts)
    pos = np.arange(len(data)) - np.repeat(indptr[:-1], counts)
    vals[row, pos] = data
    cols[row, pos] = indices
    return vals, cols


def bsr_to_blockell_arrays(A, br: int, bc: int | None = None, dtype=None):
    """(blocks (nbr,w,br,bc), bcols (nbr,w)) blocked-ELL from scipy sparse."""
    import scipy.sparse as sp

    bc = bc if bc is not None else br
    B = sp.bsr_matrix(A.tocsr(), blocksize=(br, bc))
    B.sort_indices()
    nbr = B.shape[0] // br
    indptr = np.ascontiguousarray(B.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(B.indices, dtype=np.int32)
    dt = np.dtype(dtype) if dtype is not None else B.data.dtype
    data = np.ascontiguousarray(B.data, dtype=dt)
    counts = np.diff(indptr)
    w = max(1, int(counts.max())) if nbr else 1
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        blocks = np.empty((nbr, w, br, bc), dtype=dt)
        bcols = np.empty((nbr, w), dtype=np.int32)
        fp = _f64p if dt == np.float64 else _f32p
        fn = (lib.bsr_to_blockell_f64 if dt == np.float64
              else lib.bsr_to_blockell_f32)
        fn(nbr, w, br * bc, _ptr(indptr, _i64p), _ptr(indices, _i32p),
           _ptr(data, fp), _ptr(blocks, fp), _ptr(bcols, _i32p))
        return blocks, bcols
    blocks = np.zeros((nbr, w, br, bc), dtype=dt)
    bcols = np.zeros((nbr, w), dtype=np.int32)
    row = np.repeat(np.arange(nbr), counts)
    pos = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    blocks[row, pos] = data
    bcols[row, pos] = indices
    return blocks, bcols


def csr_to_banded_arrays(A, offsets, dtype=None):
    """(diags (k,n), dropped) diagonal storage; ``dropped`` counts entries
    outside the given offsets (the caller decides whether that is an
    error)."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    dt = np.dtype(dtype) if dtype is not None else A.data.dtype
    data = np.ascontiguousarray(A.data, dtype=dt)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lib = load_native()
    if lib is not None and dt in (np.float32, np.float64):
        diags = np.empty((len(offs), n), dtype=dt)
        dropped = np.zeros((1,), dtype=np.int64)
        fp = _f64p if dt == np.float64 else _f32p
        fn = (lib.csr_to_banded_f64 if dt == np.float64
              else lib.csr_to_banded_f32)
        fn(n, len(offs), _ptr(offs, _i64p), _ptr(indptr, _i64p),
           _ptr(indices, _i32p), _ptr(data, fp), _ptr(diags, fp),
           _ptr(dropped, _i64p))
        return diags, int(dropped[0])
    diags = np.zeros((len(offs), n), dtype=dt)
    counts = np.diff(indptr)
    row = np.repeat(np.arange(n), counts)
    o = indices.astype(np.int64) - row
    for k, off in enumerate(offs):
        sel = o == off
        diags[k, row[sel]] = data[sel]
    dropped = int((~np.isin(o, offs)).sum())
    return diags, dropped


def csr_band_offsets(A, max_out: int = 64):
    """Sorted distinct diagonals of A, or None if more than ``max_out``."""
    A = A.tocsr()
    n = A.shape[0]
    indptr, indices = _csr_parts(A)
    lib = load_native()
    if lib is not None:
        out = np.empty((max_out,), dtype=np.int64)
        cnt = lib.csr_band_offsets(n, _ptr(indptr, _i64p),
                                   _ptr(indices, _i32p), _ptr(out, _i64p),
                                   max_out)
        return None if cnt < 0 else out[:cnt].copy()
    row = np.repeat(np.arange(n), np.diff(indptr))
    offs = np.unique(indices.astype(np.int64) - row)
    return None if len(offs) > max_out else offs


def rcm_ordering(A):
    """Reverse Cuthill-McKee permutation (perm[new] = old) of A's pattern
    (symmetrized). Raises RuntimeError if the result is not a
    permutation."""
    A = A.tocsr()
    n = A.shape[0]
    S = (A + A.T).tocsr()
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int32)
    lib = load_native()
    if lib is not None:
        perm = np.empty((n,), dtype=np.int32)
        lib.rcm_ordering(n, _ptr(indptr, _i64p), _ptr(indices, _i32p),
                         _ptr(perm, _i32p))
    else:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = reverse_cuthill_mckee(S).astype(np.int32)
    if not np.array_equal(np.sort(perm), np.arange(n)):
        raise RuntimeError(f"RCM ordering of {n} rows is not a permutation")
    return perm

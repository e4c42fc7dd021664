"""Build, load and bind the hand-written CUDA kernels (``csrc/``).

The kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``: one nvcc
process per source, all started together, then one link. The build runs
at the first kernel launch of a process, never at import, and caches the
library under ``exponentialutilities_jl_torch/_build/`` keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads in milliseconds. A failed build raises with nvcc's stderr.

Every C launcher returns a CUDA error code (0 = success); ``check`` turns a
non-zero code into an exception, so a refused launch never passes silently.

``launches`` counts kernel launches per kernel. A wrapper adds one exactly
where it launches its kernel, so a run can show that it went through the
kernels rather than their plain twins. ``sweep_stage`` counts the second
stage of B3 and B3-var (the moments and the Lanczos scalars), ``tridiag_exp``
R1, the Hermitian reduced exponential (``ops/kernels/tridiag.py``). The
batched forms of ``expv_batched`` count apart: ``banded_spmm`` (K1, B7
batched), ``tridiag_exp_batched`` (K2, R1 batched),
``resident_lanczos_batched`` (K3, B2's cluster form batched) and
``resident_recurrence_batched`` (K4, B1's neighbour form batched). The
fused batched Lanczos step (``ops/kernels/lanczos_step.py``) counts its
two kernels: ``banded_spmm_alpha`` (K1's Lanczos form) and
``lanczos_update`` (K5).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["library", "check", "check_operands", "require_cuda",
           "launches", "reset_launch_counts", "ptr", "raw_stream", "suffix",
           "KERNEL_DTYPES", "MAX_POINTS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("common.cuh", "banded_rows.cuh", "resident.cu",
           "resident_cluster.cu", "resident_family.cu", "fused_sweep.cu",
           "spmv.cu", "sell.cu", "tridiag.cu", "lanczos_step.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC")

KERNEL_DTYPES = (torch.float32, torch.float64)
MAX_POINTS = 64                 # stencil points: eu::kMaxPoints in csrc/common.cuh

launches = {"resident_recurrence": 0, "resident_lanczos": 0,
            "resident_multi": 0, "resident_banded": 0, "resident_grid": 0,
            "fused_sweep": 0, "fused_sweep_var": 0, "sweep_stage": 0,
            "banded_spmv": 0, "blockell_spmv": 0, "sell_spmv": 0,
            "seg_compact": 0, "tridiag_exp": 0, "banded_spmm": 0,
            "tridiag_exp_batched": 0, "resident_lanczos_batched": 0,
            "resident_recurrence_batched": 0, "banded_spmm_alpha": 0,
            "lanczos_update": 0}


def reset_launch_counts():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib):
    for suf, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        f = getattr(lib, f"eu_resident_recurrence_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _LL, _I, _VP, _VP, _VP,
                      _I, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_lanczos_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _LL, _I, real, _VP, _VP, _VP, _I,
                      _VP]
        f.restype = _I
        f = getattr(lib, f"eu_lanczos_cluster_fits_{suf}")
        f.argtypes = [_VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_lanczos_cluster_{suf}")
        f.argtypes = [_VP, _VP, _I, real, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_lanczos_cluster_batched_{suf}")
        f.argtypes = [_VP, _VP, _I, real, _VP, _I, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_multi_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP, _I, _LL, _I, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_nbr_capacity_{suf}")
        f.argtypes = [_I, _LL]
        f.restype = _I
        f = getattr(lib, f"eu_resident_multi_nbr_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_recurrence_nbr_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_recurrence_nbr_batched_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_banded_nbr_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_banded_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP, _I, _LL, _I, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_grid_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_resident_grid_nbr_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP]
        f.restype = _I
        for name in (f"eu_fused_sweep_{suf}", f"eu_fused_sweep_var_{suf}"):
            f = getattr(lib, name)
            f.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                          _I, _I, _VP, _VP, _VP, _VP, _LL, _I, _I, _VP]
            f.restype = _I
        for name in (f"eu_fused_sweep_ring_{suf}",
                     f"eu_fused_sweep_var_ring_{suf}"):
            f = getattr(lib, name)
            f.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                          _VP, _VP, _LL, _I, _I, _VP]
            f.restype = _I
        f = getattr(lib, f"eu_fused_sweep_capacity_{suf}")
        f.argtypes = [_VP, _I, _I, _I, _I]
        f.restype = _I
        f = getattr(lib, f"eu_sweep_stage_{suf}")
        f.argtypes = [_VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                      ctypes.c_double, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_sweep_stage_rows_{suf}")
        f.argtypes = [_VP, _VP, _I, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_banded_spmv_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_banded_spmm_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP]
        f.restype = _I
        for name in (f"eu_banded_spmm_alpha_{suf}", f"eu_lanczos_update_{suf}"):
            f = getattr(lib, name)
            f.argtypes = [_VP, _VP]
            f.restype = _I
        for name in (f"eu_banded_spmm_alpha_grid_{suf}",
                     f"eu_lanczos_update_grid_{suf}"):
            f = getattr(lib, name)
            f.argtypes = [_VP]
            f.restype = _I
        f = getattr(lib, f"eu_blockell_spmv_{suf}")
        f.argtypes = [_VP, _VP, _VP, _LL, _I, _I, _I, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_sell_spmv_{suf}")
        f.argtypes = [_VP, _VP, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_seg_compact_{suf}")
        f.argtypes = [_VP, _VP, _LL, _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_tridiag_exp_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _LL, _I, _I,
                      _VP, _VP]
        f.restype = _I
        f = getattr(lib, f"eu_tridiag_exp_batched_{suf}")
        f.argtypes = [_VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _LL, _I, _I,
                      _I, _VP]
        f.restype = _I
    lib.eu_device_sms.argtypes = []
    lib.eu_device_sms.restype = _I
    lib.eu_resident_max_blocks.argtypes = [_I]
    lib.eu_resident_max_blocks.restype = _I
    lib.eu_error_string.argtypes = [_I]
    lib.eu_error_string.restype = ctypes.c_char_p


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use (module doc)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libeu_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs, procs = [], []
        try:
            for name in SOURCES:
                if name.endswith(".cu"):
                    obj = tmp.with_name(f"{tmp.name}.{name}.o")
                    objs.append(obj)
                    cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                           str(CSRC / name)]
                    procs.append((cmd, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)))
            for cmd, proc in procs:
                _run(cmd, proc)
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            _run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True))
            os.replace(tmp, so)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return lib


def _run(cmd, proc):
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{err}")


def check(code: int, what: str):
    if code != 0:
        msg = library().eu_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_operands(what: str, x: torch.Tensor, *operands: torch.Tensor):
    """Validate a launch on ``x``: a kernel dtype, every operand on x's
    device."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what} takes float32/float64, got {x.dtype}")
    for t in operands:
        if t.device != x.device:
            raise ValueError(f"{what}: operand on {t.device}, vector on "
                             f"{x.device}")


def require_cuda(what: str, device: torch.device):
    """Refuse a launch plan for a device that is not a CUDA device: a plan
    hands its tensors' pointers to a kernel, and a host pointer there is an
    illegal address that breaks every later CUDA call of the process."""
    if device.type != "cuda":
        raise ValueError(f"{what}: a launch plan for {device}; the kernel "
                         "takes CUDA tensors (CPU tensors go to its twin)")


def ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a raw handle (the public
    ``torch.cuda.current_stream`` builds a Stream object: several
    microseconds of host time before every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def suffix(dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.float64: "f64"}[dtype]

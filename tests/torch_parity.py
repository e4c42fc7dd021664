"""Helpers of the parity tests (tests/test_torch_*.py) that hold the PyTorch
port against the JAX package: same seeded numpy inputs through both, the
operator carried across by ``utils/convert.py``, results compared as numpy
arrays with a stated tolerance."""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from exponentialutilities_jl_torch import set_default_device

# the port's constructors put host data on the card by default; the CPU
# parity tests ask for the CPU
set_default_device("cpu")

# f64 against the JAX XLA paths: both sides run the same arithmetic up to
# summation order, so agreement is a few ulps of the result's scale
RTOL64 = 1e-12
# f32 against the JAX Pallas kernels in interpret mode: reductions and
# FMA contraction differ in order; a few f32 ulps times the recurrence's
# growth over a handful of steps
RTOL32 = 1e-5


# the reverse-mode cases of the "gspmd" worker suite (each non-Hermitian
# sharded kind): operator key -> (t, vector key, m)
GRAD_CASES = {"adv": (5e-4, "b128", 40), "adv_ell": (5e-4, "b128", 40),
              "adv_bell": (5e-4, "b128", 40), "dense": (0.3, "b64", 30),
              "band3": (0.05, "b32", 20)}


def t2n(x):
    return x.detach().cpu().numpy()


def assert_close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want| (norm-scaled, so entries near
    zero are held to the scale of the whole result)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: error {err:.3e} > {rtol:g} x {scale:.3e}"


class FakeKernelLibrary:
    """Stands in for the CUDA kernel library on a machine without nvcc:
    records each launch's C entry point and arguments and reports success,
    so the CPU tests reach the launch plans' host logic. ``returns`` maps
    an entry point to what it reports instead of 0 (a number, or a
    function of its arguments): the card's answers to the plans' queries."""

    def __init__(self, returns=None):
        self.calls = []
        self.returns = dict(returns or {})

    def __getattr__(self, name):
        if not name.startswith("eu_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            r = self.returns.get(name, 0)
            return r(*args) if callable(r) else r
        return fn


def use_fake_kernel_library(monkeypatch, returns=None):
    """Route ``_build.library`` and ``_build.raw_stream`` to a
    ``FakeKernelLibrary`` (returned) for one test, and let the launch plans
    be built for CPU tensors (``_build.require_cuda`` refuses them
    otherwise): nothing reaches a real kernel there."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    lib = FakeKernelLibrary(returns)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "raw_stream", lambda device: 0)
    monkeypatch.setattr(_build, "require_cuda", lambda what, device: None)
    return lib


WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"


def jax_mesh_size(mesh) -> int:
    """The rank count of the port's mesh that matches a JAX mesh: one rank
    per device along its (first) axis."""
    return int(mesh.shape[mesh.axis_names[0]])


def run_ranks(suite: str, worlds, inputs: dict, tmp: Path,
              timeout: float = 300.0) -> dict:
    """Run ``suite`` of tests/torch_dist_worker.py on gloo ranks of each
    world size in ``worlds`` (all started at once, one process per rank,
    a file rendezvous per world under ``tmp``), the seeded ``inputs``
    written to ``tmp/inputs.npz``. Returns {world: [rank 0 results, ...]}.
    A rank that fails, or any rank still running after ``timeout``
    seconds (then every rank is killed), fails the caller."""
    tmp = Path(tmp)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(WORKER.parents[1])]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    procs = {}
    for world in worlds:
        d = tmp / f"world{world}"
        d.mkdir(exist_ok=True)
        for r in range(world):
            procs[(world, r)] = subprocess.Popen(
                [sys.executable, str(WORKER), str(d / "store"), str(r),
                 str(world), str(tmp / "inputs.npz"), str(d), suite],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for key, p in procs.items():
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append((key, "timed out"))
                break
            if p.returncode != 0:
                failed.append((key, err.decode(errors="replace")[-4000:]))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, f"ranks of {suite} failed: {failed}"
    out = {}
    for world in worlds:
        out[world] = []
        for r in range(world):
            with open(tmp / f"world{world}" / f"{suite}_rank{r}.pkl",
                      "rb") as f:
                out[world].append(pickle.load(f))
    return out


def gathered(results, case, key="w"):
    """The whole vector of a case: every rank's rows in rank order."""
    return np.concatenate([r[case][key] for r in results])

"""Helpers of the parity tests (tests/test_torch_*.py) that hold the PyTorch
port against the JAX package: same seeded numpy inputs through both, the
operator carried across by ``utils/convert.py``, results compared as numpy
arrays with a stated tolerance."""

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

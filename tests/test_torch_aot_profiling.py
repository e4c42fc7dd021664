"""The port's utils/aot.py (warm-up of the serving entry points) and
utils/profiling.py (torch.profiler hooks) against the JAX package's
utils/aot.py and utils/profiling.py contracts: warmup returns the same
named outputs, each equal to the JAX output for the same signature; trace
writes a trace into its directory; a profiler that cannot start leaves
the block running."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exponentialutilities_jl_tpu.utils.aot import warmup as jax_warmup
from torch_parity import RTOL64, assert_close, t2n

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.utils import profiling
from exponentialutilities_jl_torch.utils.aot import warmup


@pytest.fixture(scope="module")
def outputs():
    return (warmup(n=32, m=10, k=2, dtype=torch.float64, device="cpu"),
            jax_warmup(n=32, m=10, k=2, dtype=jnp.float64))


@pytest.mark.parametrize("name", ["expm", "expv", "phiv", "expv_chebyshev"])
def test_warmup_outputs_match_jax(outputs, name):
    got, want = outputs
    assert sorted(got) == sorted(want)
    assert_close(t2n(got[name]), np.asarray(want[name]),
                 1e-6 if name == "expv_chebyshev" else RTOL64, name)


def test_warmup_non_hermitian_names():
    got = warmup(n=16, m=8, k=1, dtype=torch.float64, hermitian=False,
                 dense=False, device="cpu")
    assert sorted(got) == ["expv", "kiops_device", "nw_device", "phiv"]
    assert got["expv"].dtype == torch.float64


def test_trace_writes_a_trace(tmp_path):
    op = et.laplacian_1d(32, device="cpu")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("expv-production"):
            w = et.expv(0.1, op, torch.ones(32, dtype=torch.float64))
    assert w.shape == (32,)
    files = os.listdir(tmp_path)
    assert any(f.endswith(".json") for f in files), files
    text = open(tmp_path / next(f for f in files if f.endswith(".json"))
                ).read()
    assert "expv-production" in text


def test_trace_that_cannot_start_still_runs_the_block(monkeypatch,
                                                      tmp_path):
    def broken(*a, **k):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with profiling.trace(str(tmp_path)) as prof:
        ran.append(1)
    assert ran == [1] and prof is None

"""The port's multi-node entry points (exponentialutilities_jl_torch/
parallel/multihost.py) against the JAX package's parallel/multihost.py
tests: ``initialize_distributed`` (a no-op in one unconfigured process, a
raise when a requested start fails), ``make_global_mesh`` (one row axis,
rank-major) and ``make_host_data_mesh`` (``data`` across hosts,
``shard`` within one, no collective over ``data`` in the Krylov body).

Several hosts are emulated by gloo ranks of this machine split into
consecutive blocks (tests/torch_dist_worker.py, suite "multihost", P in
{2, 4} as two hosts), as the JAX tests split the virtual devices."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch.distributed as dist

from torch_parity import assert_close, gathered, run_ranks, t2n

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch import parallel as par

WORLDS = (2, 4)


def _inputs():
    rng = np.random.default_rng(64)
    return dict(b64=rng.standard_normal(64), B=rng.standard_normal((2, 32)))


INP = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("multihost", WORLDS, INP,
                     tmp_path_factory.mktemp("multihost"))


def test_initialize_distributed_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert par.initialize_distributed() is False
    assert not dist.is_initialized()


def test_requested_init_that_fails_raises():
    with pytest.raises((RuntimeError, ValueError)):
        par.initialize_distributed("bogus://nowhere", 2, 0, backend="gloo")
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        par.make_mesh(2, device="cpu")


@pytest.mark.parametrize("P", WORLDS)
def test_global_mesh_expv_matches_dense(ranks, P):
    want = sla.expm(0.1 * t2n(et.laplacian_1d(64).to_dense())) @ INP["b64"]
    assert_close(gathered(ranks[P], "global_mesh"), want, 1e-10,
                 "global mesh")
    for r in ranks[P]:
        assert r["global_mesh"]["size"] == P
        assert r["global_mesh"]["census"]["shard"]["psum"] == 1 + 2 * 20


@pytest.mark.parametrize("P", WORLDS)
def test_host_data_mesh_batched(ranks, P):
    """Each data row (host) solves its own right-hand side with the rows
    sharded within the host: the layout's Krylov body never reduces over
    ``data``."""
    per = P // 2
    E = sla.expm(0.1 * t2n(et.laplacian_1d(32).to_dense()))
    res = [r["host_data_mesh"] for r in ranks[P]]
    for h in range(2):
        rows = [x for x in res if x["data"] == h]
        assert [x["shard"] for x in rows] == list(range(per))
        w = np.concatenate([x["w"] for x in rows])
        assert_close(w, E @ INP["B"][h], 1e-10, f"host {h}")
    for rank, x in enumerate(res):
        assert x["shape"] == {"data": 2, "shard": per}
        assert x["shard_ranks"] == tuple(range((rank // per) * per,
                                               (rank // per + 1) * per))
        assert x["data_ranks"] == (rank % per, rank % per + per)
        assert not any(x["census"]["data"].values()), x["census"]
        assert x["census"]["shard"]["psum"] == 1 + 2 * 16


@pytest.mark.parametrize("P", WORLDS)
def test_subgroup_mesh(ranks, P):
    """make_mesh(2) on P ranks: the first two ranks form the mesh, the
    others are outside it."""
    E = sla.expm(0.1 * t2n(et.laplacian_1d(32).to_dense()))
    w = np.concatenate([ranks[P][r]["subgroup_mesh"]["w"] for r in (0, 1)])
    assert_close(w, E @ INP["B"][0], 1e-10, "subgroup")
    assert [r["subgroup_mesh"]["member"] for r in ranks[P]] == \
        [True, True] + [False] * (P - 2)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case,kind,text", [
    ("raise_too_many", "RuntimeError", "rank(s) are attached"),
    ("raise_nccl_cpu", "ValueError", "CUDA devices")])
def test_raises(ranks, P, case, kind, text):
    for r in ranks[P]:
        got = r[case]["raised"]
        assert got[0] == kind and text in got[1], got


@pytest.mark.parametrize("P", WORLDS)
def test_warmup_with_a_mesh(ranks, P):
    """utils/aot.warmup(mesh=...) on every rank also runs the sharded step
    (make_expv_step), as the JAX warmup compiles it."""
    import jax.numpy as jnp
    from exponentialutilities_jl_tpu import expv, laplacian_1d
    want = expv(0.1, laplacian_1d(32), jnp.ones(32), m=10)
    assert_close(gathered(ranks[P], "warmup_mesh"), np.asarray(want),
                 1e-12, "warmup expv_sharded")
    assert "expv_sharded" in ranks[P][0]["warmup_mesh"]["names"]


@pytest.mark.parametrize("P", WORLDS)
def test_gather_vector_and_reinit(ranks, P):
    want = np.concatenate([np.arange(4.0) + 10 * r for r in range(P)])
    for r in ranks[P]:
        assert np.array_equal(r["gather"]["g"], want)
        assert r["reinit_is_noop"]["again"] is False

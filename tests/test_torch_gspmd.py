"""Parity of the port's GSPMD route (exponentialutilities_jl_torch/parallel/
gspmd.py: ``shard_operator`` and the ordinary drivers on this rank's rows)
with the JAX package's GSPMD path, in float64.

The port's ranks run on the CPU over gloo, from tests/torch_dist_worker.py
(suite "gspmd"), started once per world size P in {2, 4} for the module;
the JAX side runs in this process on a P-device mesh of the conftest's
virtual devices (``torch_parity.jax_mesh_size``), its operator arrays and
vectors placed with row shardings (``jpar.shard_operator``,
``shard_vector``), as in tests/test_parallel.py's ``TestGspmdAutoSharding``.
Both take the same seeded numpy inputs; the port's operators are rebuilt
from the JAX ones' plain data (``utils/convert.operator_data``). Every
case's gathered rows are held three ways: to JAX's GSPMD result at RTOL64
(the adaptive drivers, whose accepted steps may land a few ulps apart, at
their JAX test's 1e-10), to the single-device port (the adaptive drivers'
steps and rejections equal), and to scipy at the JAX test's tolerance."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu import parallel as jpar
from torch_parity import (GRAD_CASES, RTOL64, assert_close, gathered,
                          jax_mesh_size, run_ranks, t2n)

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.models.expv_taylor import expv_taylor
from exponentialutilities_jl_torch.models.integrators import exprb43_device
from exponentialutilities_jl_torch.models.kiops_device import kiops_device
from exponentialutilities_jl_torch.models.nw_device import \
    phiv_timestep_device
from exponentialutilities_jl_torch.utils.convert import (from_operator_data,
                                                         operator_data)

WORLDS = (2, 4)
MTOL_ADAPTIVE = 1e-10      # the JAX test's exprb43_device bound


def _band3():
    """A non-Hermitian band of n = 32 whose widest offset (20) spans three
    shards of 8 rows at P = 4 (k = 3 exchanges a matvec) and is capped at
    P = 2 to the other shard's 16 rows (k = 1)."""
    rng = np.random.default_rng(8)
    offs = (-20, -3, 0, 1, 19)
    n = 32
    D = rng.standard_normal((len(offs), n)) * 0.5
    i = np.arange(n)
    for k, o in enumerate(offs):
        D[k, (i + o < 0) | (i + o >= n)] = 0.0
    return eu.BandedOperator(jnp.asarray(D), offs, is_hermitian=False)


def _jax_ops():
    """The JAX operators whose plain data the ranks rebuild."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((64, 64)) / 8
    lap3 = eu.laplacian_3d(8, 8, 8)
    import scipy.sparse as sp
    L3 = sp.csr_matrix(np.asarray(lap3.to_dense()))
    adv = eu.advection_diffusion_1d(128, peclet=3.0)
    return {"lap": eu.laplacian_1d(256),
            "ell": eu.laplacian_1d(256).to_ell(),
            "bell": eu.blockell_from_scipy(L3, 8, is_hermitian=True),
            "dense": eu.DenseOperator(jnp.asarray(A), is_hermitian=False),
            "ad3": eu.advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0),
            "lap128": eu.laplacian_1d(128),
            "adv": adv,
            # offsets +-6 over 3 rows a rank at P = 4: k = 2
            "p2d6": eu.poisson_2d(6, 2),
            "band3": _band3(),
            # the non-Hermitian kinds of the reverse rule
            "adv_ell": adv.to_ell(),
            "adv_bell": eu.blockell_from_scipy(
                sp.csr_matrix(np.asarray(adv.to_dense())), 8,
                is_hermitian=False)}


JOPS = _jax_ops()


def _pack(key, data):
    out = {}
    for field, v in data.items():
        if field == "is_hermitian":
            v = -1 if v is None else int(bool(v))
        out[f"{key}__{field}"] = np.asarray(v)
    return out


def _inputs():
    rng = np.random.default_rng(20261018)
    b = rng.standard_normal(1024)
    inp = dict(b256=rng.standard_normal(256), b128=rng.standard_normal(128),
               b512=rng.standard_normal(512), b64=rng.standard_normal(64),
               u0=rng.standard_normal(256) * 0.1, b_ad3=b,
               B_ad3=np.stack([b, 0.1 * b], axis=1),
               B4=rng.standard_normal((4, 128)),
               U4=rng.standard_normal((256, 4)),
               tail=np.asarray([0.5, -0.25, 2.0]),
               b12=rng.standard_normal(12), b32=rng.standard_normal(32))
    for key, op in JOPS.items():
        inp.update(_pack(key, operator_data(op)))
    return inp


INP = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("gspmd", WORLDS, INP, tmp_path_factory.mktemp("gspmd"))


def _tops():
    """The port's single-device operators from the same plain data."""
    return {k: from_operator_data(operator_data(op), device="cpu")
            for k, op in JOPS.items()}


TOPS = _tops()


def _t(key):
    return torch.as_tensor(INP[key])


def _f_ac(A):
    return lambda u: A.matvec(u) - u ** 3


# ---- the single-device port, one call per case --------------------------

def _stats(s):
    return dataclasses.asdict(s)


@functools.cache
def single(case):
    """{key: numpy} of the single-device port's call of ``case``."""
    o = TOPS
    b = _t("b256")
    if case == "expv_banded":
        return {"w": et.expv(0.5, o["lap"], b, m=40)}
    if case == "expv_host":
        return {"w": et.expv(0.5, o["lap"], b, m=40, reduced="host")}
    if case == "expv_ell":
        return {"w": et.expv(0.5, o["ell"], b, m=40, hermitian=True)}
    if case == "expv_blockell":
        return {"w": et.expv(0.2, o["bell"], _t("b512"), m=20)}
    if case == "expv_dense":
        return {"w": et.expv(0.5, o["dense"], _t("b64"), m=40)}
    if case == "expv_arnoldi":
        return {"w": et.expv(5e-4, o["adv"], _t("b128"), m=40)}
    if case == "expv_p2d":
        return {"w": et.expv(0.1, o["p2d6"], _t("b12"), m=10)}
    if case == "expv_band3":
        return {"w": et.expv(0.05, o["band3"], _t("b32"), m=20)}
    if case.startswith("grad_"):
        key = case[5:]
        t, vec, m = GRAD_CASES[key]
        b = _t(vec).clone().requires_grad_()
        et.expv(t, o[key], b, m=m, differentiable=True).sum().backward()
        return {"w": b.grad}
    if case == "expv_timestep":
        U, st = et.expv_timestep([0.5], o["lap"], b, adaptive=True,
                                 return_stats=True)
        return {"w": U[:, 0], "stats": _stats(st)}
    if case == "kiops":
        w, st = et.kiops([0.5], o["lap"], b[:, None])
        return {"w": w.reshape(-1), "stats": _stats(st)}
    if case == "nw_device":
        U, st = phiv_timestep_device([0.5], o["lap"], b[:, None], m=20,
                                     return_stats=True)
        return {"w": U[:, 0], "stats": _stats(st)}
    if case == "kiops_device":
        w, st = kiops_device([0.5], o["lap"], b[:, None])
        return {"w": w.reshape(-1), "stats": _stats(st)}
    if case == "exprb43_device":
        u, st = exprb43_device(_f_ac(o["lap"]), _t("u0"), (0.0, 0.05),
                               adaptive=True, m=12, rtol=1e-6, atol=1e-9,
                               return_stats=True)
        return {"w": u, "stats": _stats(st)}
    if case == "expv_chebyshev":
        return {"w": et.expv_chebyshev(
            0.5, o["lap"], b, tol=1e-12,
            bounds=o["lap"].spectral_bounds_hint())}
    if case == "leja_faber":
        B = _t("B_ad3")
        return {"leja": et.phiv_timestep_leja([0.003], o["ad3"], B),
                "faber": et.phiv_timestep_faber([0.003], o["ad3"], B)}
    if case == "kiops_tail":
        w, st = et.kiops([0.1, 0.3], o["lap"], _t("U4"))
        return {"w": w, "stats": _stats(st)}
    if case == "phiv":
        w, err = et.phiv(0.2, o["lap"], b, 2, m=40, errest=True)
        return {"w": w, "err": err}
    if case == "expv_two_pass":
        return {"w": et.expv(0.5, o["lap"], b, m=40, two_pass=True)}
    if case == "expv_iop_two_pass":
        return {"w": et.expv(5e-4, o["adv"], _t("b128"), m=30, iop=2,
                             two_pass=True)}
    if case == "expv_error_estimate":
        w, it = et.expv(0.5, o["lap"], b, m=40, mode="error_estimate",
                        return_info=True)
        return {"w": w, "iters": it}
    if case == "make_expv":
        return {"w": et.make_expv(o["lap"], m=40)(0.5, b)}
    if case == "phiv_chebyshev":
        return {"w": et.phiv_chebyshev(0.5, o["lap"], b, 2, tol=1e-12)}
    if case == "phiv_timestep_chebyshev":
        return {"w": et.phiv_timestep_chebyshev(
            [0.25, 0.5], o["lap"], _t("U4")[:, :3], tol=1e-12)}
    if case == "cheb_ell_bounds":
        return {"w": et.expv_chebyshev(0.5, o["ell"], b, tol=1e-10)}
    if case == "phiv_timestep_two_pass":
        U, st = et.phiv_timestep([0.2, 0.5], o["lap"], _t("U4")[:, :3],
                                 adaptive=True, two_pass=True,
                                 return_stats=True)
        return {"w": U, "stats": _stats(st)}
    if case == "phiv_timestep_negative":
        U, st = et.phiv_timestep([-0.2, 0.3], o["lap"], _t("U4")[:, :2],
                                 adaptive=True, return_stats=True)
        return {"w": U, "stats": _stats(st)}
    if case == "phiv_timestep_fused":
        u, eps = et.phiv_timestep_fused(0.5, o["lap"], _t("U4")[:, :2],
                                        nsteps=4, m=12)
        return {"w": u, "eps": eps}
    if case == "expv_taylor":
        return {"w": expv_taylor(0.5, o["lap"], b)}
    if case == "expv_leja":
        return {"w": et.expv_leja(0.004, o["ad3"], _t("b_ad3"))}
    if case == "expv_faber":
        return {"w": et.expv_faber(0.004, o["ad3"], _t("b_ad3"))}
    if case == "phiv_faber":
        return {"w": et.phiv_faber(0.004, o["ad3"], _t("b_ad3"), 2)}
    if case == "exprb43":
        u, st = et.exprb43(_f_ac(o["lap"]), _t("u0"), (0.0, 0.05),
                           rtol=1e-6, atol=1e-9)
        return {"w": u, "stats": _stats(st)}
    if case == "phiv_leja":
        return {"w": et.phiv_leja(0.004, o["ad3"], _t("b_ad3"), 1)}
    if case == "etdrk4":
        u, st = et.etdrk4(o["lap"], lambda u: -u ** 3, _t("u0"), (0.0, 0.05),
                          0.025)
        return {"w": u, "stats": _stats(st)}
    if case == "exprb32_device":
        u, st = et.exprb32_device(_f_ac(o["lap"]), _t("u0"), (0.0, 0.05),
                                  0.0125, m=16, return_stats=True)
        return {"w": u, "stats": _stats(st)}
    if case == "etdrk4_device":
        return {"w": et.etdrk4_device(o["lap"], lambda u: -u ** 3, _t("u0"),
                                      (0.0, 0.05), 0.0125, m=20)}
    raise KeyError(case)


def _np(v):
    return t2n(v) if isinstance(v, torch.Tensor) else v


# ---- JAX's GSPMD path on a P-device mesh --------------------------------

@functools.cache
def jmesh(P):
    mesh = jpar.make_mesh(P)
    assert jax_mesh_size(mesh) == P
    return mesh


@functools.cache
def jax_gspmd(case, P):
    """JAX's result of ``case`` with the operator arrays and vectors
    row-sharded over a P-device mesh (JAX's ``TestGspmdAutoSharding``)."""
    from exponentialutilities_jl_tpu.models.integrators import \
        exprb43_device as jexprb
    from exponentialutilities_jl_tpu.models.kiops_device import \
        kiops_device as jkiops_dev
    from exponentialutilities_jl_tpu.models.nw_device import \
        phiv_timestep_device as jnw

    mesh = jmesh(P)
    j = {k: jnp.asarray(v) for k, v in INP.items()
         if "__" not in k}

    def sv(x):
        return jpar.shard_vector(x, mesh)

    def so(key):
        return jpar.shard_operator(JOPS[key], mesh)

    if case == "expv_banded":
        return eu.expv(0.5, so("lap"), sv(j["b256"]), m=40)
    if case == "expv_host":
        return eu.expv(0.5, so("lap"), sv(j["b256"]), m=40, reduced="host")
    if case == "expv_ell":
        return eu.expv(0.5, so("ell"), sv(j["b256"]), m=40, hermitian=True)
    if case == "expv_blockell":
        return eu.expv(0.2, so("bell"), sv(j["b512"]), m=20)
    if case == "expv_dense":
        return eu.expv(0.5, so("dense"), sv(j["b64"]), m=40)
    if case == "expv_p2d":
        return eu.expv(0.1, so("p2d6"), sv(j["b12"]), m=10)
    if case == "expv_band3":
        return eu.expv(0.05, so("band3"), sv(j["b32"]), m=20)
    if case.startswith("grad_"):
        key = case[5:]
        t, vec, m = GRAD_CASES[key]
        op_s = so(key)
        return jax.grad(lambda b: jnp.sum(eu.expv(
            t, op_s, b, m=m, differentiable=True)))(sv(j[vec]))
    if case == "expv_timestep":
        return eu.expv_timestep([0.5], so("lap"), sv(j["b256"]),
                                adaptive=True)[:, 0]
    if case == "kiops":
        w, _ = eu.kiops([0.5], so("lap"), sv(j["b256"])[:, None])
        return jnp.ravel(w)
    if case == "nw_device":
        return jnw([0.5], so("lap"), sv(j["b256"])[:, None], m=20)[:, 0]
    if case == "kiops_device":
        w, _ = jkiops_dev([0.5], so("lap"), sv(j["b256"])[:, None])
        return jnp.ravel(w)
    if case == "exprb43_device":
        op_s = so("lap")
        return jexprb(lambda u: op_s.matvec(u) - u ** 3, sv(j["u0"]),
                      (0.0, 0.05), adaptive=True, m=12, rtol=1e-6,
                      atol=1e-9, return_stats=True)
    if case == "expv_chebyshev":
        b_s = jax.device_put(j["b256"], NamedSharding(mesh, JP("shard")))
        return eu.expv_chebyshev(0.5, so("lap"), b_s, tol=1e-12,
                                 bounds=JOPS["lap"].spectral_bounds_hint())
    if case in ("leja", "faber"):
        Bs = jax.device_put(j["B_ad3"], NamedSharding(mesh,
                                                      JP("shard", None)))
        drv = (eu.phiv_timestep_leja if case == "leja"
               else eu.phiv_timestep_faber)
        return drv([0.003], JOPS["ad3"], Bs)
    raise KeyError(case)


def _dense(key):
    """The dense matrix of a test operator (the port's single-device
    one, from the same plain data)."""
    op = TOPS[key]
    if hasattr(op, "to_banded"):
        op = op.to_banded()
    return t2n(op.A) if hasattr(op, "A") else t2n(op.to_dense())


# ---- the cases ----------------------------------------------------------

# case: (key of the gathered rows, JAX parity tolerance or None)
JAX_CASES = {
    "expv_banded": RTOL64, "expv_ell": RTOL64, "expv_blockell": RTOL64,
    "expv_dense": RTOL64, "expv_timestep": MTOL_ADAPTIVE,
    "kiops": MTOL_ADAPTIVE, "nw_device": MTOL_ADAPTIVE,
    "kiops_device": MTOL_ADAPTIVE, "exprb43_device": MTOL_ADAPTIVE,
    "expv_chebyshev": RTOL64,
    # a halo wider than a shard; the reverse rule of each non-Hermitian
    # kind (grad_band3, the multi-hop adjoint slab, is held to the
    # single-device port and scipy)
    "expv_p2d": 1e-14, "expv_band3": RTOL64, "expv_host": RTOL64,
    **{f"grad_{key}": RTOL64 for key in GRAD_CASES if key != "band3"},
}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_matches_jax_gspmd(ranks, case, P):
    got = gathered(ranks[P], case)
    want = jax_gspmd(case, P)
    if case == "exprb43_device":
        want, jstats = want
        assert ranks[P][0][case]["stats"]["steps"] == int(jstats.steps)
        assert ranks[P][0][case]["stats"]["info"] == int(jstats.info) == 0
    assert_close(got, np.asarray(want), JAX_CASES[case], f"{case} P={P}")


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("drv", ["leja", "faber"])
def test_leja_faber_matches_jax_gspmd(ranks, drv, P):
    """The JAX test's < 1e-13 (relative 2-norm) against JAX's driver on
    a row-sharded B, and against the single-device port."""
    got = np.concatenate([r["leja_faber"][drv] for r in ranks[P]])
    for want in (np.asarray(jax_gspmd(drv, P)),
                 t2n(single("leja_faber")[drv])):
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


SINGLE_CASES = sorted(set(JAX_CASES) | {
    "kiops_tail", "phiv", "expv_two_pass", "expv_iop_two_pass",
    "expv_error_estimate", "make_expv", "phiv_chebyshev",
    "phiv_timestep_chebyshev", "cheb_ell_bounds", "phiv_timestep_two_pass",
    "phiv_timestep_negative", "phiv_timestep_fused", "expv_taylor",
    "expv_leja", "expv_faber", "phiv_faber", "exprb43", "etdrk4_device",
    "expv_arnoldi", "phiv_leja", "etdrk4", "exprb32_device",
    "grad_band3"})


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", SINGLE_CASES)
def test_matches_single_device_port(ranks, case, P):
    """Every driver on the sharded operator against its single-device call:
    the same steps, rejections and Krylov steps (the adaptive drivers), the
    same iterations, and the rows within RTOL64 (1e-10 where the adaptive
    steps accumulate the reductions' roundoff)."""
    want = single(case)
    res = ranks[P][0][case]
    assert "raised" not in res, res.get("trace")
    if "stats" in want:
        s = dict(want["stats"])
        got = dict(res["stats"])
        for k in ("final_tau",):
            s.pop(k, None)
            got.pop(k, None)
        assert got == s, (case, got, s)
    if "iters" in want:
        assert res["iters"] == want["iters"]
    tol = MTOL_ADAPTIVE if "stats" in want else RTOL64
    assert_close(gathered(ranks[P], case), t2n(want["w"]), tol,
                 f"{case} P={P}")
    for key in ("err", "eps"):
        if key in want:
            np.testing.assert_allclose(res[key], t2n(want[key]),
                                       rtol=1e-8, atol=1e-16)


ORACLES = {
    # case: (operator key, t, vector key, tolerance of the JAX test)
    "expv_banded": ("lap", 0.5, "b256", 1e-9),
    "expv_ell": ("lap", 0.5, "b256", 1e-9),
    "expv_blockell": ("bell", 0.2, "b512", 1e-9),
    "expv_dense": ("dense", 0.5, "b64", 1e-9),
    "expv_timestep": ("lap", 0.5, "b256", 1e-6),
    "kiops": ("lap", 0.5, "b256", 1e-6),
    "nw_device": ("lap", 0.5, "b256", 1e-6),
    "kiops_device": ("lap", 0.5, "b256", 1e-6),
    "expv_chebyshev": ("lap", 0.5, "b256", 1e-9),
    "expv_two_pass": ("lap", 0.5, "b256", 1e-9),
    "expv_taylor": ("lap", 0.5, "b256", 1e-9),
    "expv_arnoldi": ("adv", 5e-4, "b128", 1e-8),
    "expv_p2d": ("p2d6", 0.1, "b12", 1e-14),
    "expv_band3": ("band3", 0.05, "b32", 1e-12),
}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(ORACLES))
def test_vs_scipy(ranks, case, P):
    key, t, vec, tol = ORACLES[case]
    want = sla.expm(t * _dense(key)) @ INP[vec]
    got = gathered(ranks[P], case)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("P", WORLDS)
def test_data_by_shard_expv_batched(ranks, P):
    """The data x shard mesh (2 x 2 at P = 4): each rank holds its data
    slice of the rows of B and its shard's columns; expv_batched reduces
    over the shard axis only (no collective on "data"), and the assembled
    result matches JAX's data x shard GSPMD call and scipy."""
    if P != 4:
        assert all(r["batched_data_shard"].get("skip") for r in ranks[P])
        return
    W = np.zeros((4, 128))
    for r in ranks[P]:
        c = r["batched_data_shard"]
        assert "raised" not in c, c.get("trace")
        d, s = int(c["data"]), int(c["shard"])
        W[2 * d:2 * d + 2, 64 * s:64 * (s + 1)] = c["W"]
        assert not any(c["census"]["data"].values()), c["census"]
        assert c["census"]["shard"]["psum"] > 0
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh2 = Mesh(devs, ("data", "shard"))
    op = JOPS["lap128"]
    diags_s = jax.device_put(op.diags, NamedSharding(mesh2,
                                                     JP(None, "shard")))
    op_s = eu.BandedOperator(diags_s, op.offsets, is_hermitian=True)
    B_s = jax.device_put(jnp.asarray(INP["B4"]),
                         NamedSharding(mesh2, JP("data", "shard")))
    Wj = np.asarray(eu.expv_batched(0.3, op_s, B_s, m=30))
    assert_close(W, Wj, RTOL64, "data x shard vs JAX")
    single_w = t2n(et.expv_batched(0.3, TOPS["lap128"], _t("B4"), m=30))
    assert_close(W, single_w, RTOL64, "data x shard vs single device")
    E = sla.expm(0.3 * _dense("lap128"))
    np.testing.assert_allclose(W, (E @ INP["B4"].T).T, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("P", WORLDS)
def test_kiops_tail_counted_once(ranks, P):
    """KIOPS's augmented tail is replicated on every rank: a norm that
    psums the whole local vector counts it P times; the augmented axis
    counts it once (the single-device norm), and kiops with p = 3 takes the
    single-device steps."""
    x0 = np.concatenate([INP["U4"][:, 0], INP["tail"]])
    want = np.linalg.norm(x0)
    r0 = ranks[P][0]["kiops_tail"]
    assert float(r0["norm_once"]) == pytest.approx(want, rel=1e-14)
    wrong = np.sqrt(want ** 2 + (P - 1) * np.sum(INP["tail"] ** 2))
    assert float(r0["norm_every_rank"]) == pytest.approx(wrong, rel=1e-14)
    assert abs(float(r0["norm_every_rank"]) - want) > 1e-3


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", ["raise_cheb_diverges", "raise_sell",
                                  "raise_variable"])
def test_raises_on_every_rank(ranks, case, P):
    """A divergence raises FloatingPointError on every rank (inside the
    ranks' timeout, so no rank waits in a collective); the operators the
    JAX route refuses raise TypeError."""
    want = ("FloatingPointError", "diverged") if case.endswith("diverges") \
        else ("TypeError", "cannot shard operator")
    for r in ranks[P]:
        typ, msg = r[case]["raised"]
        assert typ == want[0] and want[1] in msg, (typ, msg)
    if case.endswith("diverges"):
        with pytest.raises(FloatingPointError, match="diverged"):
            et.expv_chebyshev(0.5, TOPS["lap"], _t("b256"),
                              bounds=(-1.0, 0.0), m=400)


def test_jax_raises_for_sell():
    import scipy.sparse as sp
    A = sp.random(64, 64, density=0.1, random_state=3, format="csr")
    with pytest.raises(TypeError, match="cannot shard operator"):
        jpar.shard_operator(eu.SellOperator.from_scipy(A), jmesh(2))


@pytest.mark.parametrize("P", WORLDS)
def test_replicated_scalars_bit_identical(ranks, P):
    """The adaptive drivers' stats, the error estimates and the hints are
    the same on every rank (each rank branches on them)."""
    for case in ("expv_timestep", "kiops", "nw_device", "kiops_device",
                 "exprb43_device", "kiops_tail", "phiv_timestep_two_pass",
                 "exprb43"):
        vals = [r[case]["stats"] for r in ranks[P]]
        assert all(v == vals[0] for v in vals), case
    errs = [float(r["phiv"]["err"]).hex() for r in ranks[P]]
    assert len(set(errs)) == 1
    eps = [np.asarray(r["phiv_timestep_fused"]["eps"]).tobytes()
           for r in ranks[P]]
    assert len(set(eps)) == 1


@pytest.mark.parametrize("P", WORLDS)
def test_hints_are_the_global_operators(ranks, P):
    """shape, nnz and the spectral hints of a sharded operator are the
    global operator's; n_local is this rank's rows."""
    lap, ad3 = TOPS["lap"], TOPS["ad3"]
    for r in ranks[P]:
        h = r["hints"]
        assert tuple(h["bounds"]) == tuple(lap.spectral_bounds_hint())
        assert tuple(h["interval"]) == tuple(et.real_interval(lap))
        assert tuple(h["ellipse"]) == tuple(et.fov_ellipse(ad3))
        assert float(h["opnorm"]) == float(lap.opnorm_hint())
        assert tuple(h["shape"]) == (256, 256) and h["nnz"] == lap.nnz
        assert h["n_local"] == 256 // P and h["halo"] == 1
        assert h["dense_nnz"] is False


@pytest.mark.parametrize("P", WORLDS)
def test_collectives(ranks, P):
    """Per-rank census: the banded product exchanges halos and never
    gathers; the ELL, block-ELL and dense products all-gather x once per
    matvec; Chebyshev makes no psum but its one finiteness pmax."""
    c = {k: ranks[P][0][k]["census_case"]["shard"] for k in (
        "expv_banded", "expv_ell", "expv_blockell", "expv_dense",
        "expv_chebyshev", "expv_host")}
    assert c["expv_banded"]["ppermute"] == 40
    # reduced="host" evaluates the replicated reduced problem on each
    # rank's host: the same collectives as the device form
    assert c["expv_host"] == c["expv_banded"]
    assert c["expv_banded"].get("all_gather", 0) == 0
    assert c["expv_ell"]["all_gather"] == 40
    assert c["expv_ell"].get("ppermute", 0) == 0
    assert c["expv_blockell"]["all_gather"] == 20
    assert c["expv_dense"]["all_gather"] == 40
    assert c["expv_chebyshev"].get("psum", 0) == 0
    assert c["expv_chebyshev"]["pmax"] == 1
    assert c["expv_chebyshev"]["ppermute"] > 0


@pytest.mark.parametrize("P", WORLDS)
def test_multi_hop_halo_exchanges(ranks, P):
    """A halo wider than a shard gathers the slab from k = ceil(h /
    n_local) neighbours on each side, k <= P - 1: k halo exchanges a
    matvec and no all-gather. poisson_2d(6, 2) (h = 6): k = 2 at P = 4
    (3 rows a rank), 1 at P = 2; the n = 32 band (h = 20): k = 3 at P = 4,
    and 1 at P = 2 (h capped to the other shard's 16 rows)."""
    k = {"expv_p2d": {2: 1, 4: 2}, "expv_band3": {2: 1, 4: 3}}
    m = {"expv_p2d": 10, "expv_band3": 20}
    for case in k:
        for r in ranks[P]:
            c = r[case]["census_case"]["shard"]
            assert c["ppermute"] == k[case][P] * m[case], (case, c)
            assert c.get("all_gather", 0) == 0, (case, c)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("key", sorted(GRAD_CASES))
def test_grad_vs_scipy(ranks, key, P):
    """d/db sum(exp(tA) b) = exp(tA)^T 1 for each non-Hermitian kind, the
    banded ones through B7's rule on the adjoint slab, the others through
    A_rows^H g summed over the axis (at the forward's own scipy bound)."""
    t, vec, m = GRAD_CASES[key]
    n = INP[vec].shape[0]
    want = sla.expm(t * _dense(key)).T @ np.ones(n)
    got = gathered(ranks[P], f"grad_{key}")
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


class _RankAxis:
    """Rank ``index`` of ``size`` with no process group: ``psum`` returns
    this rank's partial sum, so the global value is the sum over ranks."""

    device = torch.device("cpu")

    def __init__(self, index=0, size=1):
        self.index, self.size = index, size

    def axis_size(self):
        return self.size

    def axis_index(self):
        return self.index

    def psum(self, x):
        return x


def test_shard_operator_takes_the_plain_gates():
    """A sharded operator is none of the kernel gates' classes: the
    recurrence engines and B4's gate turn it away, and its products are
    its own (B7 on the slab, B8 on the block rows)."""
    from exponentialutilities_jl_torch.ops.kernels import dispatch
    from exponentialutilities_jl_torch.parallel import gspmd

    for cls in (gspmd.ShardedBandedOperator, gspmd.ShardedStencilOperator,
                gspmd.ShardedELLOperator, gspmd.ShardedBlockELLOperator,
                gspmd.ShardedDenseOperator):
        assert not issubclass(cls, (et.BandedOperator, et.StencilOperator,
                                    et.BlockELLOperator))

    op = gspmd.ShardedBandedOperator(TOPS["lap"], _RankAxis())
    assert dispatch.recurrence_engine(op, torch.float64, device="cuda",
                                      hermitian=True) is None
    assert not dispatch.resident_multi_ok(op, torch.float64, "cuda", 2)
    # one rank: the slab is the whole vector with zero halo columns
    assert tuple(op.ext.diags.shape) == (3, 258)
    x = _t("b256")
    y = op.ext.matvec(torch.cat([x.new_zeros(1), x, x.new_zeros(1)]))[1:-1]
    assert torch.equal(y, TOPS["lap"].matvec(x))


@pytest.mark.parametrize("form", ["norm", "column_norms", "vdot", "dots"])
def test_augmented_tail_counted_once_in_every_reduction(form):
    """Over ``utils.comm.AugmentedAxis`` every reduction form of
    ``utils/comm.py`` (the norm of a vector, per-column norms, vdot, the
    rows of W against y) takes the replicated tail from axis index 0 only:
    the ranks' partial sums add up to the unsharded value."""
    from exponentialutilities_jl_torch.utils import comm as uc

    rng = np.random.default_rng(7)
    P, nl, p, k = 3, 5, 2, 4
    X = torch.as_tensor(rng.standard_normal((P * nl + p, k)))
    Y = torch.as_tensor(rng.standard_normal((P * nl + p, k)))

    def local(M, r):        # rank r's rows and the replicated tail
        return torch.cat([M[r * nl:(r + 1) * nl], M[P * nl:]])

    fns = {"norm": (lambda x, y, c: uc.vector_norm(x[:, 0], c) ** 2,
                    lambda x, y: torch.linalg.vector_norm(x[:, 0]) ** 2),
           "column_norms": (
               lambda x, y, c: uc.vector_norm(x, c, dim=0) ** 2,
               lambda x, y: torch.linalg.vector_norm(x, dim=0) ** 2),
           "vdot": (lambda x, y, c: uc.vdot(x[:, 0], y[:, 0], c),
                    lambda x, y: torch.vdot(x[:, 0], y[:, 0])),
           "dots": (lambda x, y, c: uc.dots(x.T, y[:, 0], c),
                    lambda x, y: x.T @ y[:, 0])}
    part, whole = fns[form]
    total = sum(part(local(X, r), local(Y, r),
                     uc.AugmentedAxis(_RankAxis(r, P), nl))
                for r in range(P))
    torch.testing.assert_close(total, whole(X, Y), rtol=1e-14, atol=0)


def test_dense_hints_computed_at_first_read(monkeypatch):
    """Sharding a DenseOperator runs no eigvalsh: the real interval and
    the field-of-values ellipse come from the global operator at their
    first read (equal to the global operator's), once each, and the view
    drops the global operator when both are in."""
    from exponentialutilities_jl_torch.parallel import gspmd

    calls = []
    eigvalsh = np.linalg.eigvalsh
    monkeypatch.setattr(np.linalg, "eigvalsh",
                        lambda M: calls.append(1) or eigvalsh(M))
    A = from_operator_data(operator_data(JOPS["dense"]), device="cpu")
    sh = gspmd.ShardedDenseOperator(A, _RankAxis())
    assert calls == [] and sh._global is A
    assert et.real_interval(sh) == et.real_interval(A)
    assert len(calls) == 2 and sh._global is A
    assert et.fov_ellipse(sh) == et.fov_ellipse(A)
    n = len(calls)
    assert sh._global is None
    et.real_interval(sh), et.fov_ellipse(sh)
    assert len(calls) == n


@functools.cache
def _ode_reference():
    """u' = A u - u^3 on (0, 0.05), A = laplacian_1d(256), by scipy's
    DOP853 at rtol 1e-12 (the integrator cases' ODE)."""
    from scipy.integrate import solve_ivp

    A = _dense("lap")
    sol = solve_ivp(lambda t, u: A @ u - u ** 3, (0.0, 0.05), INP["u0"],
                    method="DOP853", rtol=1e-12, atol=1e-14)
    return sol.y[:, -1]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", ["exprb43_device", "exprb43",
                                  "exprb32_device", "etdrk4",
                                  "etdrk4_device"])
def test_integrators_vs_scipy(ranks, case, P):
    """The sharded integrators against scipy's DOP853 on the same ODE, at
    ten times the adaptive drivers' rtol 1e-6."""
    want = _ode_reference()
    got = gathered(ranks[P], case)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("drv", ["leja", "faber"])
def test_leja_faber_vs_scipy(ranks, drv, P):
    """u(t) = e^{tA} b + t phi_1(tA) (0.1 b) from the augmented matrix
    [[A, 0.1 b], [0, 0]], against the sharded drivers at ten times their
    tol 1e-7."""
    A = _dense("ad3")
    n = A.shape[0]
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = A
    M[:n, n] = INP["B_ad3"][:, 1]
    want = (sla.expm(0.003 * M) @ np.append(INP["B_ad3"][:, 0], 1.0))[:n]
    got = np.concatenate([r["leja_faber"][drv] for r in ranks[P]]).ravel()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6

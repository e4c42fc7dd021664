"""Parity of the port's distributed layer (exponentialutilities_jl_torch/
parallel/: mesh, halo-exchange operators, sharded Krylov, Chebyshev, Leja
and Faber) with the JAX package's shard_map layer, in float64 on the
plain (XLA) paths.

The port's ranks run on the CPU over gloo, from tests/torch_dist_worker.py
(suite "parallel"), started once per world size P in {2, 4} for the module;
the JAX side runs in this process on the conftest's virtual devices, on a
P-device mesh (``torch_parity.jax_mesh_size`` maps one to the other). Both
take the same seeded numpy inputs; the port's rows of every rank are
concatenated and held to JAX's sharded result at RTOL64, to the
single-device port and, where a dense oracle exists, to scipy."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu import parallel as jpar
from torch_parity import (RTOL64, assert_close, gathered, jax_mesh_size,
                          run_ranks, t2n)

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.models.chebyshev import _full_exp_coeffs
from exponentialutilities_jl_torch.models.faber import _faber_expv_setup
from exponentialutilities_jl_torch.models.leja import _leja_expv_setup

WORLDS = (2, 4)


def _carried_ops():
    """JAX operators whose plain data (utils/convert.operator_data) the
    ranks rebuild as the port's and shard."""
    a = np.random.default_rng(7).uniform(0.5, 2.0, (16, 6, 10))
    return {"cb": eu.poisson_2d(16, 8),
            "cs": eu.laplacian_nd_stencil(16, 4, 4),
            "cv": eu.variable_diffusion_nd_stencil(jnp.asarray(a))}


def _inputs():
    rng = np.random.default_rng(20261017)
    inp = dict(b256=rng.standard_normal(256), b128=rng.standard_normal(128),
               b_st=rng.standard_normal(256), x_wide=rng.standard_normal(480),
               co_wide=rng.standard_normal(19) / 6,
               b_ad3=rng.standard_normal(1024),
               b_v=rng.standard_normal(960))
    from exponentialutilities_jl_torch.utils.convert import operator_data
    for key, op in _carried_ops().items():
        data = operator_data(op)
        inp[f"{key}_offsets"] = np.asarray(data["offsets"])
        for field in ("diags", "coeffs", "coeff_fields"):
            if field in data:
                inp[f"{key}_{field}" if field != "coeff_fields"
                    else f"{key}_fields"] = data[field]
    return inp


INP = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("parallel", WORLDS, INP,
                     tmp_path_factory.mktemp("parallel"))


@functools.cache
def jmesh(P):
    mesh = jpar.make_mesh(P)
    assert jax_mesh_size(mesh) == P
    return mesh


def _wide_offsets():
    offs = [(0, 0, 0)]
    for ax in range(3):
        for o in (1, -1, 2, -2, 3, -3):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
    return offs


def _sym_wide_star(mod):
    offs, co = [(0, 0, 0)], [-3.0 * 49 / 18]
    for ax in range(3):
        for o, c in ((1, 1.5), (-1, 1.5), (2, -0.15), (-2, -0.15),
                     (3, 1 / 90), (-3, 1 / 90)):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
            co.append(c)
    co = np.asarray(co) / 4
    if mod is eu:
        return eu.StencilOperator((32, 3, 5), offs, jnp.asarray(co),
                                  is_hermitian=True)
    return et.StencilOperator((32, 3, 5), offs, co, is_hermitian=True)


def _jax_sharded(P, case):
    """JAX's sharded result of ``case`` on a P-device mesh (matvec cases:
    the global operator's matvec, as the JAX package's own tests hold its
    sharded matvec to)."""
    mesh = jmesh(P)
    j = {k: jnp.asarray(v) for k, v in INP.items()}
    lap256, lap128 = eu.laplacian_1d(256), eu.laplacian_1d(128)
    st = eu.laplacian_nd_stencil(16, 4, 4)
    ad3 = eu.advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0)
    if case == "banded_matvec":
        return eu.poisson_2d(16, 8).matvec(j["b128"])
    if case == "expv_lanczos":
        return jpar.expv_sharded(0.5, lap256, j["b256"], mesh, m=40)
    if case == "expv_arnoldi":
        return jpar.expv_sharded(5e-4, eu.advection_diffusion_1d(
            128, peclet=3.0), j["b128"], mesh, m=40)
    if case in ("expv_step_w1", "expv_step_w2"):
        step, diags = jpar.make_expv_step(lap128, mesh, m=30)
        t = 0.1 if case.endswith("1") else 0.2
        return step(t, diags, jpar.shard_vector(j["b128"], mesh))
    if case in ("phiv_w", "phiv_err"):
        w, err = jpar.phiv_sharded(0.2, lap128, j["b128"], 3, mesh, m=40)
        return w if case == "phiv_w" else err
    if case == "stencil_matvec":
        return st.matvec(j["b_st"])
    if case == "stencil_expv":
        return jpar.expv_sharded(0.1, st, j["b_st"], mesh, m=40)
    if case in ("stencil_phiv_w", "stencil_phiv_err"):
        w, err = jpar.phiv_sharded(0.2, st, j["b_st"], 2, mesh, m=30)
        return w if case.endswith("_w") else err
    if case == "stencil_wide_matvec":
        op = eu.StencilOperator((32, 3, 5), _wide_offsets(), j["co_wide"])
        return op.matvec(j["x_wide"])
    if case == "stencil_wide_expv":
        return jpar.expv_sharded(0.3, _sym_wide_star(eu), j["x_wide"],
                                 mesh, m=40)
    if case == "two_pass":
        return jpar.expv_sharded(0.5, lap256, j["b256"], mesh, m=40,
                                 two_pass=True)
    if case == "cheb_banded":
        return jpar.expv_chebyshev_sharded(0.5, lap256, j["b256"], mesh,
                                           tol=1e-12)
    if case == "cheb_stencil1d":
        return jpar.expv_chebyshev_sharded(
            0.4, eu.laplacian_nd_stencil(256, dtype=jnp.float64),
            j["b256"], mesh, tol=1e-12)
    if case == "leja":
        return jpar.expv_leja_sharded(0.004, ad3, j["b_ad3"], mesh)
    if case == "faber":
        return jpar.expv_faber_sharded(0.004, ad3, j["b_ad3"], mesh)
    if case == "zero_b":
        return jpar.expv_sharded(0.5, lap256, jnp.zeros(256), mesh, m=20)
    if case == "complex_t":
        return jpar.expv_sharded(0.1j, lap256, j["b256"], mesh, m=30,
                                 two_pass=True)
    raise KeyError(case)


def _port(results, case):
    """(case in the worker, key) of a parity case name."""
    for key in ("w1", "w2", "w", "err"):
        if case.endswith("_" + key):
            base = case[:-len(key) - 1]
            if base in results[0]:
                return base, key
    return case, "w"


def _port_value(results, case):
    base, key = _port(results, case)
    if key == "err":
        return np.asarray(results[0][base][key])
    return gathered(results, base, key)


PARITY = ["banded_matvec", "expv_lanczos", "expv_arnoldi", "expv_step_w1",
          "expv_step_w2", "phiv_w", "phiv_err", "stencil_matvec",
          "stencil_expv", "stencil_phiv_w", "stencil_phiv_err",
          "stencil_wide_matvec", "stencil_wide_expv", "two_pass",
          "cheb_banded", "cheb_stencil1d", "leja", "faber", "zero_b",
          "complex_t"]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", PARITY)
def test_matches_jax_sharded(ranks, case, P):
    got = _port_value(ranks[P], case)
    want = np.asarray(_jax_sharded(P, case))
    if case.endswith("_err"):
        # the error estimate: a product of reduced scalars, one per rank
        assert got == pytest.approx(float(want), rel=1e-10, abs=1e-14)
        return
    assert_close(got, want, RTOL64, f"{case} P={P}")


def _dense(op):
    return t2n(op.to_banded().to_dense()) if hasattr(op, "to_banded") \
        else t2n(op.to_dense())


ORACLES = {
    "expv_lanczos": (lambda: et.laplacian_1d(256), 0.5, "b256"),
    "expv_arnoldi": (lambda: et.advection_diffusion_1d(128, peclet=3.0),
                     5e-4, "b128"),
    "expv_step_w1": (lambda: et.laplacian_1d(128), 0.1, "b128"),
    "expv_step_w2": (lambda: et.laplacian_1d(128), 0.2, "b128"),
    "stencil_expv": (lambda: et.laplacian_nd_stencil(16, 4, 4), 0.1,
                     "b_st"),
    "two_pass": (lambda: et.laplacian_1d(256), 0.5, "b256"),
    "cheb_banded": (lambda: et.laplacian_1d(256), 0.5, "b256"),
    "cheb_stencil1d": (lambda: et.laplacian_nd_stencil(256), 0.4, "b256"),
    "complex_t": (lambda: et.laplacian_1d(256), 0.1j, "b256"),
}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(ORACLES))
def test_vs_scipy(ranks, case, P):
    make, t, key = ORACLES[case]
    want = sla.expm(t * _dense(make())) @ INP[key]
    assert_close(_port_value(ranks[P], case), want, 1e-10, case)


def _single(case):
    """The single-device port on the same inputs."""
    b = {k: torch.as_tensor(v) for k, v in INP.items()}
    lap256, lap128 = et.laplacian_1d(256), et.laplacian_1d(128)
    st = et.laplacian_nd_stencil(16, 4, 4)
    ad3 = et.advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0)
    return {
        "expv_lanczos": lambda: et.expv(0.5, lap256, b["b256"], m=40),
        "stencil_expv": lambda: et.expv(0.1, st, b["b_st"], m=40),
        "stencil_wide_expv": lambda: et.expv(0.3, _sym_wide_star(et),
                                             b["x_wide"], m=40),
        "phiv_w": lambda: et.phiv(0.2, lap128, b["b128"], 3, m=40),
        "two_pass": lambda: et.expv(0.5, lap256, b["b256"], m=40,
                                    two_pass=True),
        "cheb_banded": lambda: et.expv_chebyshev(
            0.5, lap256, b["b256"], tol=1e-12,
            bounds=lap256.spectral_bounds_hint()),
        "leja": lambda: et.expv_leja(0.004, ad3, b["b_ad3"]),
        "faber": lambda: et.expv_faber(0.004, ad3, b["b_ad3"]),
    }[case]()


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", ["expv_lanczos", "stencil_expv",
                                  "stencil_wide_expv", "phiv_w", "two_pass",
                                  "cheb_banded", "leja", "faber"])
def test_matches_single_device_port(ranks, case, P):
    assert_close(_port_value(ranks[P], case), t2n(_single(case)), RTOL64,
                 case)


RAISES = {
    "banded_halo_too_wide": ("ValueError", "halo"),
    "stencil_halo_deeper": ("ValueError", "halo"),
    "raise_two_pass_nonherm": ("NotImplementedError", "Hermitian"),
    "raise_fused_no_two_pass": ("ValueError", "two_pass"),
    "raise_cheb_nonherm": ("ValueError", "Hermitian"),
    "raise_no_rule": ("TypeError", "no sharding rule"),
    "raise_not_divisible": ("ValueError", "divide evenly"),
}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(RAISES))
def test_raises(ranks, case, P):
    kind, text = RAISES[case]
    for r in ranks[P]:
        assert "raised" in r[case], (case, r[case])
        assert r[case]["raised"][0] == kind and text in r[case]["raised"][1]


def _expected_census(case):
    """Collectives per rank that the algorithm implies: Lanczos one psum
    for |b| and two a step (alpha, norm), Arnoldi three a step (two CGS
    passes, the norm), one halo exchange per matvec; the polynomial
    actions no psum in their loops."""
    if case in ("banded_matvec", "stencil_matvec", "stencil_wide_matvec"):
        return {"ppermute": 1}
    if case in ("expv_lanczos", "phiv", "stencil_expv",
                "stencil_wide_expv", "lanczos_scalars"):
        extra = {"all_gather": 1} if case == "expv_lanczos" else {}
        return {"psum": 81, "ppermute": 40, **extra}
    if case == "stencil_phiv":
        return {"psum": 61, "ppermute": 30}
    if case == "expv_arnoldi":
        return {"psum": 121, "ppermute": 40}
    if case == "expv_step":
        return {"psum": 2 * 61, "ppermute": 60}
    if case == "two_pass":                  # pass 1 and the replay's |b|
        return {"psum": 82, "ppermute": 80}
    if case == "cheb_banded":
        return {"ppermute": len(_full_exp_coeffs(0.5, -4.0, 0.0, 1e-12,
                                                 None)[0])}
    if case == "cheb_stencil1d":
        return {"ppermute": len(_full_exp_coeffs(0.4, -4.0, 0.0, 1e-12,
                                                 None)[0])}
    ad3 = et.advection_diffusion_3d_stencil(16, 8, 8, peclet=4.0)
    if case == "leja":
        d, xi, c, s, q = _leja_expv_setup(ad3, 0.004, None, 1e-7, None, 40.0)
        return {"ppermute": q * len(d)}
    if case == "faber":
        a, c, g, rho, q, m_used, _ = _faber_expv_setup(
            ad3, 0.004, None, 1e-7, None, 512.0)
        return {"ppermute": q * m_used, "psum": 1}
    raise KeyError(case)


CENSUS = ["banded_matvec", "stencil_matvec", "stencil_wide_matvec",
          "expv_lanczos", "phiv", "stencil_expv", "stencil_wide_expv",
          "lanczos_scalars", "stencil_phiv", "expv_arnoldi", "expv_step",
          "two_pass", "cheb_banded", "cheb_stencil1d", "leja", "faber"]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", CENSUS)
def test_census(ranks, case, P):
    want = _expected_census(case)
    for r in ranks[P]:
        got = {k: v for k, v in r[case]["census_case"]["shard"].items() if v}
        assert got == want, (case, P, got, want)


@pytest.mark.parametrize("P", WORLDS)
def test_reduced_scalars_bit_identical_across_ranks(ranks, P):
    r0 = ranks[P][0]["lanczos_scalars"]
    for r in ranks[P][1:]:
        for key in ("alphas", "betas", "beta0", "m_used"):
            assert np.array_equal(r["lanczos_scalars"][key], r0[key]), key
        assert np.array_equal(r["phiv"]["err"], ranks[P][0]["phiv"]["err"])
    from exponentialutilities_jl_tpu.ops.krylov import lanczos_coeffs
    a, b, b0, mu, _ = lanczos_coeffs(eu.laplacian_1d(256),
                                     jnp.asarray(INP["b256"]), 40)
    assert_close(r0["alphas"], np.asarray(a), RTOL64, "alphas")
    assert_close(r0["betas"], np.asarray(b), RTOL64, "betas")


@pytest.mark.parametrize("P", WORLDS)
def test_gather_vector(ranks, P):
    want = gathered(ranks[P], "expv_lanczos")
    for r in ranks[P]:
        assert np.array_equal(r["expv_lanczos"]["gathered"], want)


@pytest.mark.parametrize("P", WORLDS)
def test_local_operator_takes_the_plain_path(ranks, P):
    """A shard's local operator is no Stencil/BandedOperator: B1, B3, B5,
    B6 and B7 never see a shard's rows (they would apply the global
    Dirichlet stencil without the halo); recurrence_engine returns the
    plain path even for a CUDA device, and fused=True raises."""
    res = ranks[P][0]["local_plain_path"]
    flags = {k: v for k, v in res.items() if k != "census_case"}
    assert len(flags) == 12 and all(flags.values()), flags


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("kind", ["banded", "stencil", "variable"])
def test_carried_operators_shard(ranks, kind, P):
    """shard_banded, shard_stencil and the variable fields take an
    operator carried across from the JAX package (utils/convert.py): the
    halo matvecs equal JAX's global matvec, the variable fused Chebyshev
    JAX's single-device one."""
    ops = _carried_ops()
    got = gathered(ranks[P], "carried", kind)
    if kind == "banded":
        want = ops["cb"].matvec(jnp.asarray(INP["b128"]))
    elif kind == "stencil":
        want = ops["cs"].matvec(jnp.asarray(INP["b_st"]))
    else:
        from exponentialutilities_jl_tpu import expv_chebyshev
        want = expv_chebyshev(0.05, ops["cv"], jnp.asarray(INP["b_v"]),
                              tol=1e-6, fused=False)
    assert_close(got, np.asarray(want), RTOL64, kind)


def test_jax_mesh_size_maps_to_ranks():
    for P in WORLDS:
        assert jax_mesh_size(jmesh(P)) == P
    assert math.prod(jpar.make_mesh(8).devices.shape) == 8

"""Parity of the port's shard-local fused sweeps (exponentialutilities_jl_
torch/parallel/stencil_fused.py: B3 and B3-var on each rank's extended
slab, halo planes exchanged per sweep) with the JAX package's
parallel/stencil_fused.py.

The port's ranks (gloo, CPU, P in {2, 4}; tests/torch_dist_worker.py,
suite "fused") run the sweeps' plain twins with ``fused=True``, the real
sharded code path (moment plane range, psum of the moments, halo
refresh). Against JAX's ``fused=True`` in interpret mode in float32 at
RTOL32; in float64 against the single-device port's fused twins at
RTOL64 (JAX's sharded fused path is float32-only, a TPU workaround the
port drops); the census, the cross-rank bit equality of the reduced
scalars and the replay's equality with pass 1 on every rank."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as eu
from exponentialutilities_jl_tpu import parallel as jpar
from torch_parity import (RTOL32, RTOL64, assert_close, gathered, run_ranks,
                          t2n)

import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.models.chebyshev import _full_exp_coeffs
from exponentialutilities_jl_torch.models.expv import _expv_two_pass_fused
from exponentialutilities_jl_torch.models.faber import _faber_expv_setup
from exponentialutilities_jl_torch.models.leja import _leja_expv_setup
from exponentialutilities_jl_torch.ops.kernels.dispatch import chebyshev_rows
from exponentialutilities_jl_torch.ops.kernels.lanczos_fused import (
    lanczos_coeffs_fused, recurrence_apply_fused)

WORLDS = (2, 4)


def _co9(rng):
    offs = list(itertools.product((-1, 0, 1), repeat=2))
    cmap = {}
    for off in offs:
        key = tuple(sorted((off, tuple(-o for o in off))))
        cmap.setdefault(key, rng.standard_normal() * 0.3)
    return np.asarray([cmap[tuple(sorted((off, tuple(-o for o in off))))]
                       for off in offs])


def _inputs():
    rng = np.random.default_rng(1017)
    return dict(b3=rng.standard_normal(16 * 12 * 10),
                b2=rng.standard_normal(24 * 16),
                bv=rng.standard_normal(16 * 6 * 10), co9=_co9(rng),
                a_var=rng.uniform(0.5, 2.0, (16, 6, 10)))


INP = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("fused", WORLDS, INP, tmp_path_factory.mktemp("fused"))


# ------------------------------------------------------------- operators --

def _h0_2_star(mod, dt):
    offs, cs = [], []
    for ax in range(3):
        for o in (-2, -1, 1, 2):
            off = [0, 0, 0]
            off[ax] = o
            offs.append(tuple(off))
            cs.append(-1.0 / 12 if abs(o) == 2 else 4.0 / 3)
    offs.append((0, 0, 0))
    cs.append(-3 * 5.0 / 2)
    if mod is eu:
        return eu.StencilOperator((16, 6, 10), tuple(offs),
                                  jnp.asarray(cs, dt), is_hermitian=True)
    return et.StencilOperator((16, 6, 10), offs, np.asarray(cs),
                              is_hermitian=True, dtype=dt)


def _ops(mod, dn):
    """The operators of the suite's float32 (``dn`` "f32") or float64
    cases, in ``mod``'s package."""
    if mod is eu:
        dt = jnp.float32 if dn == "f32" else jnp.float64
        nine = eu.StencilOperator(
            (24, 16), tuple(itertools.product((-1, 0, 1), repeat=2)),
            jnp.asarray(INP["co9"], dt), is_hermitian=True)
        var = eu.variable_diffusion_nd_stencil(jnp.asarray(INP["a_var"], dt))
    else:
        dt = torch.float32 if dn == "f32" else torch.float64
        nine = et.StencilOperator(
            (24, 16), list(itertools.product((-1, 0, 1), repeat=2)),
            INP["co9"], is_hermitian=True, dtype=dt)
        var = et.variable_diffusion_nd_stencil(INP["a_var"], dtype=dt)
    return dict(lap3=mod.laplacian_nd_stencil(16, 12, 10, dtype=dt),
                lap2=mod.laplacian_nd_stencil(24, 16, dtype=dt),
                h02=_h0_2_star(mod, dt), nine=nine,
                ad=mod.advection_diffusion_3d_stencil(16, 6, 10, peclet=1.5,
                                                      dtype=dt),
                var=var, dt=dt)


# (operator, input, call) of each case; call(api, op, b, mesh) runs the
# sharded entry point of either package with fused=True
CASES = {
    "cheb3d": ("lap3", "b3", lambda a, op, b, mesh: a.expv_chebyshev_sharded(
        0.2, op, b, mesh, fused=True)),
    "twopass3d": ("lap3", "b3", lambda a, op, b, mesh: a.expv_sharded(
        0.3, op, b, mesh, m=25, two_pass=True, fused=True)),
    "cheb2d": ("lap2", "b2", lambda a, op, b, mesh: a.expv_chebyshev_sharded(
        0.1, op, b, mesh, fused=True)),
    "twopass2d": ("lap2", "b2", lambda a, op, b, mesh: a.expv_sharded(
        0.2, op, b, mesh, m=25, two_pass=True, fused=True)),
    "cheb_h0_2": ("h02", "bv", lambda a, op, b, mesh:
                  a.expv_chebyshev_sharded(0.05, op, b, mesh, fused=True)),
    "cheb2d_9pt": ("nine", "b2", lambda a, op, b, mesh:
                   a.expv_chebyshev_sharded(0.05, op, b, mesh, fused=True,
                                            bounds=(-4.0, 4.0), tol=1e-6)),
    "leja": ("ad", "bv", lambda a, op, b, mesh: a.expv_leja_sharded(
        0.002, op, b, mesh, tol=1e-6, fused=True)),
    "faber": ("ad", "bv", lambda a, op, b, mesh: a.expv_faber_sharded(
        0.002, op, b, mesh, tol=1e-6, fused=True)),
    "var_cheb": ("var", "bv", lambda a, op, b, mesh:
                 a.expv_chebyshev_sharded(0.05, op, b, mesh, fused=True,
                                          tol=1e-6)),
}

# JAX's interpret-mode sweeps cost seconds a call: the main cases at both
# rank counts, the others at one
JAX_CASES = [("cheb3d", 2), ("cheb3d", 4), ("twopass3d", 2),
             ("twopass3d", 4), ("cheb2d", 4), ("twopass2d", 2),
             ("cheb_h0_2", 2), ("cheb2d_9pt", 4), ("leja", 4), ("faber", 2),
             ("var_cheb", 2)]


@functools.cache
def _jax_ops(dn):
    return _ops(eu, dn)


@pytest.mark.parametrize("case,P", JAX_CASES)
def test_f32_matches_jax_fused_interpret(ranks, case, P):
    opname, key, call = CASES[case]
    ops = _jax_ops("f32")
    want = call(jpar, ops[opname], jnp.asarray(INP[key], jnp.float32),
                jpar.make_mesh(P))
    got = gathered(ranks[P], f"{case}_f32")
    assert got.dtype == np.float32
    assert_close(got, np.asarray(want), RTOL32, f"{case} P={P}")


@functools.cache
def _port_ops(dn):
    return _ops(et, dn)


def _single_f64(case):
    """The single-device port's fused twins (or, for the polynomial
    actions and the variable operator, its entry points) on the same
    float64 inputs."""
    ops = _port_ops("f64")
    opname, key, _ = CASES[case]
    op, b = ops[opname], torch.as_tensor(INP[key])
    if case in ("cheb3d", "cheb2d", "cheb_h0_2", "cheb2d_9pt"):
        t, tol, bounds = {"cheb3d": (0.2, 1e-7, None),
                          "cheb2d": (0.1, 1e-7, None),
                          "cheb_h0_2": (0.05, 1e-7, None),
                          "cheb2d_9pt": (0.05, 1e-6, (-4.0, 4.0))}[case]
        lo, hi = bounds or op.spectral_bounds_hint()
        full, c, h = _full_exp_coeffs(t, lo, hi, tol, None)
        rows = chebyshev_rows(torch.as_tensor(full), c, h, torch.float64)
        return recurrence_apply_fused(op, b, rows)
    if case in ("twopass3d", "twopass2d"):
        t = 0.3 if case == "twopass3d" else 0.2
        return _expv_two_pass_fused(op, b, t, 25)
    if case == "leja":
        return et.expv_leja(0.002, op, b, tol=1e-6)
    if case == "faber":
        return et.expv_faber(0.002, op, b, tol=1e-6)
    return et.expv_chebyshev(0.05, op, b, tol=1e-6)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_f64_matches_single_device_port(ranks, case, P):
    got = gathered(ranks[P], f"{case}_f64")
    assert got.dtype == np.float64
    assert_close(got, t2n(_single_f64(case)), RTOL64, f"{case} P={P}")


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", ["cheb3d", "twopass3d", "cheb2d",
                                  "twopass2d", "cheb_h0_2", "var_cheb"])
def test_f64_vs_scipy(ranks, case, P):
    opname, key, _ = CASES[case]
    op = _port_ops("f64")[opname]
    t = {"cheb3d": 0.2, "twopass3d": 0.3, "cheb2d": 0.1, "twopass2d": 0.2,
         "cheb_h0_2": 0.05, "var_cheb": 0.05}[case]
    A = t2n(op.to_banded().to_dense())
    want = sla.expm(t * A) @ INP[key]
    # the Chebyshev truncation (tol 1e-7) and the two-pass m = 25
    assert_close(gathered(ranks[P], f"{case}_f64"), want, 1e-6, case)


def test_variable_f64_is_sharded_where_jax_raises():
    """JAX's variable fused sharding is float32-only (a TPU workaround):
    it raises for float64, where the port shards B3-var's twin (held to
    the single-device port above)."""
    ops = _jax_ops("f64")
    with pytest.raises(TypeError, match="GSPMD"):
        jpar.expv_chebyshev_sharded(0.05, ops["var"], jnp.asarray(INP["bv"]),
                                    jpar.make_mesh(2), fused=True)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("dn", ["f32", "f64"])
def test_reduced_scalars_bit_identical_across_ranks(ranks, P, dn):
    r0 = ranks[P][0][f"coeffs_replay_{dn}"]
    for r in ranks[P][1:]:
        for key in ("alphas", "betas", "beta0", "m_used", "broke",
                    "alphas2", "betas2"):
            assert np.array_equal(r[f"coeffs_replay_{dn}"][key], r0[key]), key


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("dn", ["f32", "f64"])
def test_replay_regenerates_pass1_scalars(ranks, P, dn):
    for r in ranks[P]:
        res = r[f"coeffs_replay_{dn}"]
        assert np.array_equal(res["alphas2"], res["alphas"])
        assert np.array_equal(res["betas2"], res["betas"])


@pytest.mark.parametrize("P", WORLDS)
def test_lanczos_coeffs_match_single_device(ranks, P):
    """float64: the psum'd moments over the interior planes give the
    single-device fused record; float32: JAX's sharded record (interpret
    mode), as its own test holds it to its single-device one."""
    res = ranks[P][0]["coeffs_replay_f64"]
    a, b, b0, mu, _ = lanczos_coeffs_fused(_port_ops("f64")["lap3"],
                                           torch.as_tensor(INP["b3"]), 12)
    assert_close(res["alphas"], t2n(a), RTOL64, "alphas")
    assert_close(res["betas"], t2n(b), RTOL64, "betas")
    assert int(res["m_used"]) == int(mu)
    if P != 2:
        return
    from jax.sharding import PartitionSpec as Ps
    import jax
    from exponentialutilities_jl_tpu.parallel.stencil_fused import (
        fused_shard_plan, lanczos_coeffs_fused_sharded)
    mesh = jpar.make_mesh(P)
    plan = fused_shard_plan(_jax_ops("f32")["lap3"], mesh, "shard",
                            hermitian=True)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(Ps("shard"),),
                       out_specs=(Ps(), Ps(), Ps(), Ps(), Ps()))
    def run(b_local):
        return lanczos_coeffs_fused_sharded(plan, b_local, 12,
                                            interpret=True)

    ja, jb, _, jmu, _ = run(jpar.shard_vector(
        jnp.asarray(INP["b3"], jnp.float32), mesh))
    r32 = ranks[P][0]["coeffs_replay_f32"]
    assert_close(r32["alphas"], np.asarray(ja), RTOL32, "alphas f32")
    assert_close(r32["betas"], np.asarray(jb), RTOL32, "betas f32")
    assert int(r32["m_used"]) == int(jmu)


def _degree(op, t, tol=1e-7, bounds=None):
    lo, hi = bounds or op.spectral_bounds_hint()
    return len(_full_exp_coeffs(t, lo, hi, tol, None)[0])


def _expected_census(case):
    """Per rank: a recurrence of M rows is M + 1 sweeps, each followed by
    one halo exchange, plus one for b (and one for a variable operator's
    fields), no psum; the two-pass Lanczos m steps per pass: m + 1 sweeps
    with a psum of the moments and a halo exchange each, plus one psum
    (|b|) and one exchange (v0)."""
    ops = _port_ops("f64")
    if case in ("twopass3d", "twopass2d"):
        return {"psum": 2 * (25 + 2), "ppermute": 2 * (25 + 2)}
    if case == "coeffs_replay":
        return {"psum": 2 * (12 + 2), "ppermute": 2 * (12 + 2)}
    if case == "census_rows":
        return {"ppermute": 9 + 2}
    M = {"cheb3d": lambda: _degree(ops["lap3"], 0.2),
         "cheb2d": lambda: _degree(ops["lap2"], 0.1),
         "cheb_h0_2": lambda: _degree(ops["h02"], 0.05),
         "cheb2d_9pt": lambda: _degree(ops["nine"], 0.05, 1e-6,
                                       (-4.0, 4.0)),
         "var_cheb": lambda: _degree(ops["var"], 0.05, 1e-6)}
    if case in M:
        return {"ppermute": M[case]() + 2 + (case == "var_cheb")}
    if case == "leja":
        d, xi, c, s, q = _leja_expv_setup(ops["ad"], 0.002, None, 1e-6,
                                          None, 40.0)
        return {"ppermute": q * (len(d) + 2)}
    a, c, g, rho, q, m_used, _ = _faber_expv_setup(ops["ad"], 0.002, None,
                                                   1e-6, None, 512.0)
    return {"ppermute": q * (m_used + 2), "psum": 1}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES) + ["coeffs_replay",
                                                  "census_rows"])
def test_census(ranks, case, P):
    want = _expected_census(case)
    for dn in (("f32", "f64") if case != "census_rows" else ("",)):
        name = f"{case}_{dn}" if dn else case
        for r in ranks[P]:
            got = {k: v for k, v in r[name]["census_case"]["shard"].items()
                   if v}
            assert got == want, (name, P, got, want)


@pytest.mark.parametrize("P", WORLDS)
def test_zero_b_returns_zero(ranks, P):
    assert not gathered(ranks[P], "zero_b").any()


@pytest.mark.parametrize("P", WORLDS)
def test_complex_t_keeps_the_plain_two_pass(ranks, P):
    got = gathered(ranks[P], "complex_t_default")
    assert np.iscomplexobj(got)
    op = _port_ops("f64")["lap3"]
    want = sla.expm(0.1j * t2n(op.to_banded().to_dense())) @ INP["b3"]
    assert_close(got, want, 1e-5, "complex t")
    assert ranks[P][0]["complex_t_default"]["census_case"]["shard"][
        "psum"] == 2 * 30 + 2
    kind, msg = ranks[P][0]["raise_complex_t_fused"]["raised"]
    assert kind == "ValueError" and "complex t" in msg


@pytest.mark.parametrize("P", WORLDS)
def test_halo_deeper_than_shard_rejected(ranks, P):
    res = ranks[P][0]["halo_deeper"]
    assert res["plan_none"]
    assert res["auto_raised"] is not None and "halo" in res["auto_raised"]


@pytest.mark.parametrize("P", WORLDS)
def test_plan_cache_one_entry_per_rank_set(ranks, P):
    """The plan is kept per rank set, not per mesh object: a second mesh
    over the same ranks reuses it (its extended operator and buffers)
    under its own axis, and gives the same bits."""
    for r in ranks[P]:
        res = r["plan_cache"]
        assert res["same"] and res["entries"] == 1
        assert res["comm1"] and res["comm2"] and res["ext_shared"]
    assert np.array_equal(gathered(ranks[P], "plan_cache"),
                          gathered(ranks[P], "cheb3d_f32"))


@pytest.mark.parametrize("P", WORLDS)
def test_dispatch_policy(ranks, P):
    """AUTO engages on CUDA tensors only; ``fused=True`` plans on the CPU
    in float32 and, unlike JAX's float32-only gate, float64."""
    res = ranks[P][0]["dispatch_policy"]
    assert res["auto_none"] and res["forced"] and res["forced_f64"]

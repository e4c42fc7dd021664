"""PyTorch port vs JAX package: the variable-coefficient stencil slice
(ops/stencil.VariableStencilOperator, variable_diffusion_nd_stencil, the
advection stencils) and the plain twin of kernel B3-var
(ops/kernels/lanczos_fused.py) on CPU, with the same seeded numpy inputs
through both packages. The JAX side runs its Pallas sweep in interpret
mode (float32, RTOL32) or its XLA paths (float64, RTOL64); the port runs
the twin, since its kernels need a CUDA device."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_tpu.ops.kernels import dispatch as jd
from exponentialutilities_jl_tpu.ops.kernels import lanczos_fused as jf
from exponentialutilities_jl_torch.models import expv as tx
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)

# float64 Krylov records against the JAX XLA recurrence: a few ulps per
# step, amplified over m <= 12 steps (as tests/test_torch_fused.py)
RTOL_REC = 1e2 * RTOL64
# the BASELINE accuracy target for float64 against scipy
RTOL_SCIPY = 1e-10


def _star13_offsets():
    offsets = [(0, 0, 0)]
    for a in range(3):
        for s in (-2, -1, 1, 2):
            off = [0, 0, 0]
            off[a] = s
            offsets.append(tuple(off))
    return offsets


def _jax_op(kind, dtype=np.float64, seed=0):
    """A JAX VariableStencilOperator: div(a grad u) in 2-D/3-D (Hermitian),
    a non-symmetric 7-point one with random fields, and a wide (|o| = 2)
    13-point one with random fields."""
    rng = np.random.default_rng(seed)
    if kind in ("diff3d", "diff2d"):
        shape = (4, 5, 7) if kind == "diff3d" else (9, 11)
        a = rng.uniform(0.5, 2.0, shape)
        return ej.variable_diffusion_nd_stencil(a, dtype=dtype)
    if kind == "asym3d":
        shape = (4, 5, 6)
        offsets = [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
                   (1, 0, 0), (-1, 0, 0)]
    else:
        shape = (5, 6, 7)
        offsets = _star13_offsets()
    C = rng.uniform(0.2, 1.0, (len(offsets), int(np.prod(shape))))
    C[0] = -C[1:].sum(axis=0) - 0.5
    return ej.VariableStencilOperator(shape, offsets, jnp.asarray(C, dtype),
                                      is_hermitian=False)


KINDS = ["diff3d", "diff2d", "asym3d", "wide3d"]
HERM = ["diff3d", "diff2d"]


def _vecs(n, k, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(k)]


# ---- the operator --------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_variable_matvec_hint_banded(kind):
    jop = _jax_op(kind)
    top = et.to_torch_operator(jop)
    assert isinstance(top, et.VariableStencilOperator)
    assert not isinstance(top, et.StencilOperator)
    (x,) = _vecs(jop.shape[0], 1, np.float64, 1)
    assert_close(t2n(top.matvec(torch.as_tensor(x))),
                 np.asarray(jop.matvec(jnp.asarray(x))), RTOL64, "matvec")
    assert float(top.opnorm_hint()) == pytest.approx(float(jop.opnorm_hint()),
                                                     rel=RTOL64)
    # the Gershgorin hint is the JAX number exactly: the Chebyshev degree
    # follows from it
    assert top._gershgorin_real() == jop._gershgorin_real()
    assert top.spectral_bounds_hint() == jop.spectral_bounds_hint()
    assert (top.spectral_bounds_hint() is None) == (kind not in HERM)
    tb, jb = top.to_banded(), jop.to_banded()
    assert tuple(tb.offsets) == tuple(jb.offsets)
    np.testing.assert_array_equal(t2n(tb.diags), np.asarray(jb.diags))
    assert tb.is_hermitian == jb.is_hermitian


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(4, 5, 7), (9, 11), (13,)])
def test_variable_diffusion_fields_bitwise(shape, dtype):
    a = np.random.default_rng(2).uniform(0.5, 2.0, shape)
    jop = ej.variable_diffusion_nd_stencil(a, dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    for top in (et.variable_diffusion_nd_stencil(a, dtype=dtype),
                et.variable_diffusion_nd_stencil(a, dtype=tdt),
                et.variable_diffusion_nd_stencil(torch.as_tensor(a),
                                                 dtype=tdt)):
        assert top.offsets == jop.offsets and top.is_hermitian
        assert top.coeff_fields.dtype == tdt
        np.testing.assert_array_equal(t2n(top.coeff_fields),
                                      np.asarray(jop.coeff_fields))


def test_boundary_fields_face_outside():
    """The builder keeps nonzero fields on boundary faces that point out of
    the grid; the matvec multiplies them by the zero outside (Dirichlet),
    and the Gershgorin hint counts them, as the JAX operator does."""
    a = np.random.default_rng(3).uniform(0.5, 2.0, (4, 5))
    top = et.variable_diffusion_nd_stencil(a)
    C = t2n(top.coeff_fields).reshape(5, 4, 5)
    k_minus_x = top.offsets.index((0, -1))
    assert np.all(C[k_minus_x][:, 0] > 0)
    A = t2n(top.to_banded().to_dense())
    x = np.random.default_rng(4).standard_normal(20)
    assert_close(t2n(top.matvec(torch.as_tensor(x))), A @ x, RTOL64, "dense")
    lo, hi = top.spectral_bounds_hint()
    ev = np.linalg.eigvalsh(A)
    assert lo <= ev[0] and ev[-1] <= hi


@pytest.mark.parametrize("name", ["3d", "1d"])
def test_advection_stencils_vs_jax(name):
    if name == "3d":
        jop = ej.advection_diffusion_3d_stencil(4, 5, 6, peclet=10.0)
        top = et.advection_diffusion_3d_stencil(4, 5, 6, peclet=10.0)
    else:
        jop = ej.advection_diffusion_1d_stencil(50, peclet=10.0)
        top = et.advection_diffusion_1d_stencil(50, peclet=10.0)
    assert top.offsets == jop.offsets and not top.is_hermitian
    np.testing.assert_array_equal(t2n(top.coeffs), np.asarray(jop.coeffs))
    (x,) = _vecs(jop.shape[0], 1, np.float64, 5)
    assert_close(t2n(top.matvec(torch.as_tensor(x))),
                 np.asarray(jop.matvec(jnp.asarray(x))), RTOL64, "matvec")
    if name == "1d":        # the stencil form of the banded test matrix
        dense = np.asarray(ej.advection_diffusion_1d(50).to_dense())
        np.testing.assert_array_equal(t2n(top.to_banded().to_dense()), dense)


def test_variable_operator_transfer_and_caches():
    jop = _jax_op("diff3d", np.float32)
    data = et.operator_data(jop)
    assert data["type"] == "VariableStencilOperator"
    top = et.from_operator_data(data)
    back = et.operator_data(top)
    np.testing.assert_array_equal(back["coeff_fields"], data["coeff_fields"])
    assert back["offsets"] == data["offsets"]
    # fields in another dtype than the vectors: cast once and kept
    f64 = top.fields(torch.float64)
    assert f64.dtype == torch.float64 and top.fields(torch.float64) is f64
    assert top.fields(torch.float32) is top.coeff_fields
    # the hint is computed once and kept; new fields compute it anew
    h = top._gershgorin_real()
    assert top._gershgorin_real() is h
    top.coeff_fields = top.coeff_fields * 2
    assert top._gershgorin_real() == pytest.approx(tuple(2 * v for v in h))
    assert top.fields(torch.float64) is not f64


# ---- B3-var's plain twin against the JAX sweep -------------------------

def _jax_sweep(jop, Z, Vc, Vp, coefs, W, interpret=True):
    gg = jf.ghost_grid_for(jop)
    cs, builder = jf._fused_dispatch(jop, hermitian=False)
    g = gg.to_ghost
    out = jf.fused_lanczos_step(
        g(jnp.asarray(Z)), g(jnp.asarray(Vc)), g(jnp.asarray(Vp)),
        jnp.asarray(coefs), jnp.asarray(gg.xmask()), grid_desc=gg,
        coeffs_static=cs, cfields=builder(gg, jnp.float32),
        w_accum=None if W is None else g(jnp.asarray(W)),
        interpret=interpret)
    return gg, out


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_var_sweep_twin_vs_interpret(kind, accum):
    jop = _jax_op(kind, np.float32)
    top = et.to_torch_operator(jop)
    Z, Vc, Vp, W = _vecs(jop.shape[0], 4, np.float32, 0)
    coefs = np.asarray([0.3, -0.7, 0.2, 0.45], np.float32)
    gg, out = _jax_sweep(jop, Z, Vc, Vp, coefs if accum else coefs[:3],
                         W if accum else None)
    Wt = torch.as_tensor(W.copy())
    tout = tf.fused_lanczos_step(
        *(torch.as_tensor(v) for v in (Z, Vc, Vp)),
        torch.as_tensor(coefs if accum else coefs[:3]), top,
        w_accum=Wt if accum else None)
    assert_close(t2n(tout[0]), np.asarray(gg.from_ghost(out[0])), RTOL32, "Y")
    assert_close(t2n(tout[1]), np.asarray(gg.from_ghost(out[1])), RTOL32,
                 "Zn")
    for k in (2, 3):
        assert float(tout[k]) == pytest.approx(float(out[k]), rel=RTOL32)
    if accum:
        assert tout[4] is Wt                      # updated in place
        assert_close(t2n(Wt), np.asarray(gg.from_ghost(out[4])), RTOL32, "W")


@pytest.mark.parametrize("kind", KINDS)
def test_var_stencil_matvec_fused(kind):
    jop = _jax_op(kind, np.float32)
    top = et.to_torch_operator(jop)
    (x,) = _vecs(jop.shape[0], 1, np.float32, 7)
    jy = jf.stencil_matvec_fused(jop, jnp.asarray(x), interpret=True)
    ty = tf.stencil_matvec_fused(top, torch.as_tensor(x))
    assert_close(t2n(ty), np.asarray(jy), RTOL32, "matvec")


@pytest.mark.parametrize("kind", HERM)
def test_var_lanczos_coeffs_fused(kind):
    jop = _jax_op(kind, np.float32)
    top = et.to_torch_operator(jop)
    (b,) = _vecs(jop.shape[0], 1, np.float32, 1)
    m = 6
    ja, jb, jb0, jmu, jbr = jf.lanczos_coeffs_fused(jop, jnp.asarray(b), m,
                                                    interpret=True)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert_close(t2n(ta), np.asarray(ja), RTOL32, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL32, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL32)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))


@pytest.mark.parametrize("kind", HERM)
def test_var_lanczos_coeffs_fused_f64_vs_xla(kind):
    jop = _jax_op(kind)
    top = et.to_torch_operator(jop)
    (b,) = _vecs(jop.shape[0], 1, np.float64, 2)
    m = 12
    ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert_close(t2n(ta), np.asarray(ja), RTOL_REC, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL_REC, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL64)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))


def _reduced(alphas, betas, beta0, t):
    a, bb = np.asarray(alphas, np.float64), np.asarray(betas, np.float64)
    T = np.diag(a) + np.diag(bb[:-1], 1) + np.diag(bb[:-1], -1)
    return float(beta0) * sla.expm(t * T)[:, 0]


@pytest.mark.parametrize("kind", HERM)
def test_var_lanczos_replay_fused(kind):
    jop = _jax_op(kind, np.float32)
    top = et.to_torch_operator(jop)
    (b,) = _vecs(jop.shape[0], 1, np.float32, 3)
    ja, jb, jb0, _, _ = jf.lanczos_coeffs_fused(jop, jnp.asarray(b), 8,
                                                interpret=True)
    c = _reduced(ja, jb, jb0, 0.05).astype(np.float32)
    jw = jf.lanczos_replay_fused(jop, jnp.asarray(b), jnp.asarray(c),
                                 interpret=True)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "replay")


def test_var_lanczos_replay_fused_f64_vs_xla():
    jop = _jax_op("diff3d")
    top = et.to_torch_operator(jop)
    (b,) = _vecs(jop.shape[0], 1, np.float64, 4)
    m = 12
    ja, jb, jb0, _, _ = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    c = _reduced(ja, jb, jb0, 0.1)
    jw = jk.lanczos_replay(jop, jnp.asarray(b), jnp.asarray(c), ja, jb, m)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    assert_close(t2n(tw), np.asarray(jw), RTOL_REC, "replay")


@pytest.mark.parametrize("kind", KINDS)
def test_var_recurrence_apply_fused(kind):
    jop = _jax_op(kind, np.float32)
    top = et.to_torch_operator(jop)
    (b,) = _vecs(jop.shape[0], 1, np.float32, 5)
    lo, hi = jop._gershgorin_real()
    c, h = 0.5 * (hi + lo), 0.5 * (hi - lo)
    coeffs = np.random.default_rng(6).standard_normal(7).astype(np.float32)
    jrows = jd.chebyshev_rows(jnp.asarray(coeffs), c, h, jnp.float32)
    trows = td.chebyshev_rows(torch.as_tensor(coeffs), c, h, torch.float32)
    jw = jf.recurrence_apply_fused(jop, jnp.asarray(b), jrows, interpret=True)
    tw = tf.recurrence_apply_fused(top, torch.as_tensor(b), trows)
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "recurrence")


# ---- gates and dispatch ------------------------------------------------

def test_var_gates_and_dispatch():
    herm3 = et.to_torch_operator(_jax_op("diff3d"))
    herm2 = et.to_torch_operator(_jax_op("diff2d"))
    asym = et.to_torch_operator(_jax_op("asym3d"))
    wide = et.to_torch_operator(_jax_op("wide3d"))
    one_d = et.variable_diffusion_nd_stencil(np.ones(40))
    for op in (herm3, herm2):
        assert tf.fused_supported(op) and tf.fused_supported(op, False)
    for op in (asym, wide):
        assert tf.fused_supported(op, hermitian=False)
        assert not tf.fused_supported(op, hermitian=True)
    too_wide = et.VariableStencilOperator(
        (4, 5, 9), [(0, 0, 0), (0, 0, 4)], np.ones((2, 180)))
    assert not tf.fused_supported(too_wide, hermitian=False)
    assert not tf.fused_supported(one_d, hermitian=False)
    # the constant-stencil engines have no fields: B1, B4, B5 and B6 turn
    # every variable operator away, whatever its size
    for op in (herm3, herm2, asym, one_d):
        assert not tr.resident_supported(op)
        assert not tr.resident_grid_supported(op)
        assert not tr.resident_banded_supported(op)
        assert not td.resident_multi_ok(op, torch.float64, "cuda", 2)
    # the JAX order on a CUDA device (the device is only read here): B3-var
    for op in (herm3, herm2):
        assert (td.recurrence_engine(op, torch.float64, device="cuda",
                                     hermitian=True)
                is tf.recurrence_apply_fused)
    assert (td.recurrence_engine(asym, torch.float32, device="cuda")
            is tf.recurrence_apply_fused)
    assert td.recurrence_engine(one_d, torch.float64, device="cuda") is None
    with pytest.raises(ValueError, match="VariableStencilOperator"):
        td.recurrence_engine(one_d, torch.float64, fused=True, device="cuda")
    assert td.recurrence_engine(herm3, torch.float64, device="cpu") is None
    with pytest.raises(ValueError):
        tf.lanczos_coeffs_fused(asym, torch.ones(asym.shape[0],
                                                 dtype=torch.float64), 3)


# ---- the slice as a whole ----------------------------------------------

def _slice_problem(seed=8):
    a = np.random.default_rng(seed).uniform(0.5, 2.0, (6, 7, 5))
    jop = ej.variable_diffusion_nd_stencil(a)
    top = et.variable_diffusion_nd_stencil(a)
    b = np.random.default_rng(seed + 1).standard_normal(jop.shape[0])
    A = t2n(top.to_banded().to_dense())
    return jop, top, b, A


def test_var_expv_two_pass_vs_jax_and_scipy():
    jop, top, b, A = _slice_problem()
    t, m = 0.05, 20
    want = sla.expm(t * A) @ b
    jw = ej.expv(t, jop, jnp.asarray(b), m=m, two_pass=True)
    tw = et.expv(t, top, torch.as_tensor(b), m=m, two_pass=True)
    assert_close(t2n(tw), np.asarray(jw), RTOL_REC, "two-pass vs JAX")
    assert_close(t2n(tw), want, RTOL_SCIPY, "two-pass vs scipy")
    # the same through the fused drivers (B3-var's twin on CPU): what the
    # CUDA dispatch of expv(two_pass=True) runs
    _build.reset_launch_counts()
    fw = tx._expv_two_pass_fused(top, torch.as_tensor(b), t, m)
    assert_close(t2n(fw), want, RTOL_SCIPY, "fused two-pass vs scipy")
    assert sum(_build.launches.values()) == 0


def test_var_expv_chebyshev_vs_jax_and_scipy():
    jop, top, b, A = _slice_problem(seed=10)
    t = 0.05
    want = sla.expm(t * A) @ b
    jw = ej.expv_chebyshev(t, jop, jnp.asarray(b), tol=1e-12)
    tw = et.expv_chebyshev(t, top, torch.as_tensor(b), tol=1e-12)
    assert_close(t2n(tw), np.asarray(jw), RTOL64, "Chebyshev vs JAX")
    assert_close(t2n(tw), want, RTOL_SCIPY, "Chebyshev vs scipy")
    # the fused recurrence (B3-var's twin) with the same rows
    from exponentialutilities_jl_torch.models import chebyshev as tc

    lo, hi = top.spectral_bounds_hint()
    full, c, h = tc._full_exp_coeffs(t, lo, hi, 1e-12, None)
    rows = td.chebyshev_rows(torch.as_tensor(full), c, h, torch.float64)
    fw = tf.recurrence_apply_fused(top, torch.as_tensor(b), rows)
    assert_close(t2n(fw), want, RTOL_SCIPY, "fused Chebyshev vs scipy")
    assert len(full) == len(ej.models.chebyshev._full_exp_coeffs(
        t, *jop.spectral_bounds_hint(), 1e-12, None)[0])

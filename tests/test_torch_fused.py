"""PyTorch port vs JAX package: the fused sweeps of 2-D/3-D constant
stencils (ops/kernels/lanczos_fused.py). On CPU the port runs the plain
twin of kernel B3; the JAX side runs its Pallas sweep in interpret mode
(float32, RTOL32; its ghost layout is converted on the JAX side only) or
its XLA Lanczos (float64, RTOL64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_tpu.ops.kernels import dispatch as jd
from exponentialutilities_jl_tpu.ops.kernels import lanczos_fused as jf
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)


def _star13():
    offsets, coeffs = [(0, 0, 0)], [-7.5]
    for a in range(3):
        for s, c in ((-2, -1 / 12), (-1, 4 / 3), (1, 4 / 3), (2, -1 / 12)):
            off = [0, 0, 0]
            off[a] = s
            offsets.append(tuple(off))
            coeffs.append(c)
    return offsets, coeffs


def _jax_op(kind, dtype):
    if kind == "7pt":
        return ej.laplacian_nd_stencil(4, 5, 7, dtype=dtype)
    if kind == "5pt-2d":
        return ej.laplacian_nd_stencil(9, 11, dtype=dtype)
    offsets, coeffs = _star13()
    return ej.StencilOperator((5, 6, 7), offsets, jnp.asarray(coeffs, dtype),
                              is_hermitian=True)


KINDS = ["7pt", "5pt-2d", "13pt"]


@pytest.mark.parametrize("accum", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_twin_vs_interpret(kind, accum):
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    n = jop.shape[0]
    rng = np.random.default_rng(0)
    Z, Vc, Vp, W = (rng.standard_normal(n).astype(np.float32)
                    for _ in range(4))
    coefs = np.asarray([0.3, -0.7, 0.2, 0.45], np.float32)
    gg = jf.ghost_grid_for(jop)
    cs, _ = jf._fused_dispatch(jop, hermitian=False)
    g = gg.to_ghost
    out = jf.fused_lanczos_step(
        g(jnp.asarray(Z)), g(jnp.asarray(Vc)), g(jnp.asarray(Vp)),
        jnp.asarray(coefs if accum else coefs[:3]),
        jnp.asarray(gg.xmask()), grid_desc=gg, coeffs_static=cs,
        w_accum=g(jnp.asarray(W)) if accum else None, interpret=True)
    Wt = torch.as_tensor(W.copy())
    tout = tf.fused_lanczos_step(
        *(torch.as_tensor(v) for v in (Z, Vc, Vp)),
        torch.as_tensor(coefs if accum else coefs[:3]), top,
        w_accum=Wt if accum else None)
    assert_close(t2n(tout[0]), np.asarray(gg.from_ghost(out[0])), RTOL32, "Y")
    assert_close(t2n(tout[1]), np.asarray(gg.from_ghost(out[1])), RTOL32, "Zn")
    for k in (2, 3):
        assert float(tout[k]) == pytest.approx(float(out[k]), rel=RTOL32)
    if accum:
        assert tout[4] is Wt                      # updated in place
        assert_close(t2n(Wt), np.asarray(gg.from_ghost(out[4])), RTOL32, "W")


@pytest.mark.parametrize("kind", KINDS)
def test_lanczos_coeffs_fused(kind):
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(1).standard_normal(jop.shape[0]).astype(
        np.float32)
    m = 6
    ja, jb, jb0, jmu, jbr = jf.lanczos_coeffs_fused(jop, jnp.asarray(b), m,
                                                    interpret=True)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert_close(t2n(ta), np.asarray(ja), RTOL32, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL32, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL32)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))


@pytest.mark.parametrize("kind", ["7pt", "5pt-2d"])
def test_lanczos_coeffs_fused_f64_vs_xla(kind):
    """The normalization algebra (unnormalized y, ca = 1/beta,
    cb = -alpha/beta, cc = -beta/beta_prev, beta reported one step ahead)
    held to the plain XLA pass 1 in float64."""
    jop = _jax_op(kind, jnp.float64)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(2).standard_normal(jop.shape[0])
    m = 12
    ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert_close(t2n(ta), np.asarray(ja), 1e2 * RTOL64, "alphas")
    assert_close(t2n(tb), np.asarray(jb), 1e2 * RTOL64, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL64)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))


def test_lanczos_coeffs_fused_breakdown_and_zero():
    """b in a 2-dimensional invariant subspace (two grid eigenvectors) and
    b = 0, against the XLA pass 1 in float64."""
    shape = (4, 5, 6)
    jop = ej.laplacian_nd_stencil(*shape)
    top = et.to_torch_operator(jop)
    z, y, x = np.meshgrid(*(np.arange(1, s + 1) for s in shape), indexing="ij")

    def mode(kz, ky, kx):
        return (np.sin(kz * np.pi * z / (shape[0] + 1))
                * np.sin(ky * np.pi * y / (shape[1] + 1))
                * np.sin(kx * np.pi * x / (shape[2] + 1))).reshape(-1)

    for b in (mode(1, 1, 1) + mode(2, 3, 4), np.zeros(jop.shape[0])):
        ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), 6)
        ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top,
                                                        torch.as_tensor(b), 6)
        assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
        assert_close(t2n(ta), np.asarray(ja), 1e2 * RTOL64, "alphas")
        live = np.asarray(jb) >= 1e-7
        assert_close(t2n(tb) * live, np.asarray(jb) * live, 1e2 * RTOL64,
                     "betas")
    assert int(tmu) == 0


def _reduced(alphas, betas, beta0, t):
    import scipy.linalg as sla

    a, bb = np.asarray(alphas, np.float64), np.asarray(betas, np.float64)
    T = np.diag(a) + np.diag(bb[:-1], 1) + np.diag(bb[:-1], -1)
    return float(beta0) * sla.expm(t * T)[:, 0]


@pytest.mark.parametrize("kind", KINDS)
def test_lanczos_replay_fused(kind):
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(3).standard_normal(jop.shape[0]).astype(
        np.float32)
    m = 8
    ja, jb, jb0, _, _ = jf.lanczos_coeffs_fused(jop, jnp.asarray(b), m,
                                                interpret=True)
    c = _reduced(ja, jb, jb0, 0.05).astype(np.float32)
    jw = jf.lanczos_replay_fused(jop, jnp.asarray(b), jnp.asarray(c),
                                 interpret=True)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "replay")


def test_lanczos_replay_fused_f64_vs_xla():
    jop = _jax_op("7pt", jnp.float64)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(4).standard_normal(jop.shape[0])
    m = 12
    ja, jb, jb0, _, _ = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    c = _reduced(ja, jb, jb0, 0.1)
    jw = jk.lanczos_replay(jop, jnp.asarray(b), jnp.asarray(c), ja, jb, m)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "replay")


def _grid_modes(shape, modes):
    """A sum of Dirichlet grid eigenvectors: b in an invariant subspace of
    the Laplacian of dimension len(modes)."""
    g = np.meshgrid(*(np.arange(1, s + 1) for s in shape), indexing="ij")
    return sum(np.prod([np.sin(k * np.pi * x / (s + 1))
                        for k, x, s in zip(ks, g, shape)], axis=0)
               for ks in modes).reshape(-1)


@pytest.mark.parametrize("start", ["invariant", "zero", "random"])
@pytest.mark.parametrize("kind", ["7pt", "5pt-2d"])
def test_lanczos_sweeps_breakdown_and_replay(kind, start):
    """The drivers' CPU path (twin sweep + twin stage, ``sweep_stage_ref``)
    against the XLA pass 1 and replay in float64: a happy breakdown after
    two steps, beta0 = 0 and a random start; m_used and broke exactly, the
    live betas and the replay within 1e2 RTOL64; the replay's own alphas
    and betas equal pass 1's bit for bit (the same stages on the same
    moments)."""
    jop = _jax_op(kind, jnp.float64)
    top = et.to_torch_operator(jop)
    shape = jop.grid_shape
    b = {"invariant": _grid_modes(shape, [(1,) * len(shape),
                                          (2, 3, 4)[-len(shape):]]),
         "zero": np.zeros(jop.shape[0]),
         "random": np.random.default_rng(8).standard_normal(jop.shape[0])
         }[start]
    m = 6
    ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    ta, tb, tb0, tmu, tbr, _ = tf._lanczos_sweeps(
        top, torch.as_tensor(b), m, 1e-7, what="test")
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
    assert int(tmu) == {"invariant": 2, "zero": 0, "random": m}[start]
    assert_close(t2n(ta), np.asarray(ja), 1e2 * RTOL64, "alphas")
    live = np.asarray(jb) >= 1e-7
    assert_close(t2n(tb) * live, np.asarray(jb) * live, 1e2 * RTOL64,
                 "betas")
    c = _reduced(ja, jb, jb0, 0.1)
    jw = jk.lanczos_replay(jop, jnp.asarray(b), jnp.asarray(c), ja, jb, m)
    ra, rb, _, rmu, _, tw = tf._lanczos_sweeps(
        top, torch.as_tensor(b), m, 1e-7, torch.as_tensor(c), what="test")
    assert torch.equal(ra, ta) and torch.equal(rb, tb)
    assert int(rmu) == int(tmu)
    assert torch.equal(tw, tf.lanczos_replay_fused(top, torch.as_tensor(b),
                                                   torch.as_tensor(c)))
    if start == "zero":
        assert not bool(tw.any())
    else:
        assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "replay")


@pytest.mark.parametrize("kind", KINDS)
def test_recurrence_apply_fused(kind):
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(5).standard_normal(jop.shape[0]).astype(
        np.float32)
    lo, hi = jop.spectral_bounds_hint()
    c, h = 0.5 * (hi + lo), 0.5 * (hi - lo)
    coeffs = np.random.default_rng(6).standard_normal(7).astype(np.float32)
    jrows = jd.chebyshev_rows(jnp.asarray(coeffs), c, h, jnp.float32)
    trows = td.chebyshev_rows(torch.as_tensor(coeffs), c, h, torch.float32)
    assert_close(t2n(trows), np.asarray(jrows), 0.0, "rows")
    jw = jf.recurrence_apply_fused(jop, jnp.asarray(b), jrows, interpret=True)
    tw = tf.recurrence_apply_fused(top, torch.as_tensor(b), trows)
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "recurrence")


@pytest.mark.parametrize("kind", KINDS)
def test_stencil_matvec_fused(kind):
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    x = np.random.default_rng(7).standard_normal(jop.shape[0]).astype(
        np.float32)
    jy = jf.stencil_matvec_fused(jop, jnp.asarray(x), interpret=True)
    ty = tf.stencil_matvec_fused(top, torch.as_tensor(x))
    assert_close(t2n(ty), np.asarray(jy), RTOL32, "matvec")


def test_fused_supported_and_rejects():
    assert tf.fused_supported(et.laplacian_nd_stencil(4, 5, 6))
    assert tf.fused_supported(et.laplacian_nd_stencil(4, 5))
    assert not tf.fused_supported(et.laplacian_nd_stencil(40))
    asym = et.StencilOperator((3, 4, 5), [(0, 0, 0), (0, 0, 1)],
                              np.asarray([1.0, 0.5]))
    assert tf.fused_supported(asym, hermitian=False)
    assert not tf.fused_supported(asym, hermitian=True)
    wide = et.StencilOperator((3, 4, 9), [(0, 0, 0), (0, 0, 4)],
                              np.asarray([1.0, 0.5]))
    assert not tf.fused_supported(wide, hermitian=False)
    with pytest.raises(ValueError):
        tf.lanczos_coeffs_fused(et.laplacian_nd_stencil(64), torch.ones(64), 3)
    with pytest.raises(ValueError):
        tf.lanczos_coeffs_fused(asym, torch.ones(60, dtype=torch.float64), 3)

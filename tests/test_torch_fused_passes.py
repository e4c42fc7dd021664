"""PyTorch port vs JAX package: the fused-sweep Lanczos passes in their
device-index form (ops/kernels/lanczos_fused.py). A pass is one step, a
sweep and its second stage, whose vectors come from the pass's ring by the
state's step counter and whose stage reads j from that counter: the step
that a CUDA graph captures once and replays. On the CPU the same step runs
the twins (``fused_sweep_ring_ref``, ``sweep_stage_ref``) through a
``utils/graphs.LoopRunner``.

Held to JAX's fused passes in interpret mode (float32, RTOL32), to its XLA
pass 1 and replay (float64, 1e2 RTOL64, as tests/test_torch_fused.py), and
bit for bit to the host-index driver the step replaced: its loop (vectors
rotated on the host) and its stage twin (a host branch on j) are kept here
as they were, but for one repair: a breakdown that the last sweep's |y_m|
shows is recorded in broke, as the plain pass 1 records it
(``test_breakdown_at_the_last_step_sets_broke``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import krylov as jk
from exponentialutilities_jl_tpu.ops.kernels import lanczos_fused as jf
from exponentialutilities_jl_torch.ops import krylov as tk
from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)

TOL = 1e-7          # the drivers' breakdown threshold


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
    if kind == "var":
        a = np.random.default_rng(0).uniform(0.5, 2.0, (4, 5, 7))
        return ej.variable_diffusion_nd_stencil(a, dtype=dtype)
    offsets, coeffs = _star13()
    return ej.StencilOperator((5, 6, 7), offsets, jnp.asarray(coeffs, dtype),
                              is_hermitian=True)


def _grid_modes(shape, modes):
    """A sum of Dirichlet grid eigenvectors: b in an invariant subspace of
    the Laplacian of dimension len(modes)."""
    g = np.meshgrid(*(np.arange(1, s + 1) for s in shape), indexing="ij")
    return sum(np.prod([np.sin(k * np.pi * x / (s + 1))
                        for k, x, s in zip(ks, g, shape)], axis=0)
               for ks in modes).reshape(-1)


def _start_vector(start, shape, n, dtype):
    b = {"invariant": lambda: _grid_modes(shape, [
            (1,) * len(shape), (2, 3, 4)[-len(shape):]]),
         "zero": lambda: np.zeros(n),
         "random": lambda: np.random.default_rng(8).standard_normal(n)
         }[start]()
    return b.astype(dtype)


def _reduced(alphas, betas, beta0, t):
    import scipy.linalg as sla

    a, bb = np.asarray(alphas, np.float64), np.asarray(betas, np.float64)
    T = np.diag(a) + np.diag(bb[:-1], 1) + np.diag(bb[:-1], -1)
    return float(beta0) * sla.expm(t * T)[:, 0]


# ---- the host-index driver the device-index step replaced, as it was ----

def _stage_host_index(moments, state, alphas, betas, coeffs, j: int, m: int,
                      tol: float):
    """The stage twin with j from the host (a host branch on j)."""
    _ST = tf._ST
    ypy, yzy = moments[0], moments[1]
    if j > 0:
        betas[j - 1] = torch.where(state[_ST["live"]] != 0,
                                   torch.sqrt(torch.clamp_min(ypy, 0.0)), 0.0)
    if j >= m:
        # the repair: the breakdown at |y_m| (no step follows)
        state[_ST["broke"]] = torch.where(
            torch.sqrt(torch.clamp_min(ypy, 0.0)) < tol, 1.0,
            state[_ST["broke"]])
        return
    broke = state[_ST["broke"]] != 0
    ca, cb, cc, alpha, beta, now_broke, live, safe_beta = tf._lanczos_scalars(
        ypy, yzy, state[_ST["beta_prev"]], broke, tol)
    cw = (torch.where(live, coeffs[j] / safe_beta, 0.0) if coeffs is not None
          else torch.zeros_like(ca))
    alphas[j] = torch.where(live, alpha, 0.0)
    state[_ST["m_used"]] = torch.where(live, float(j + 1),
                                       state[_ST["m_used"]])
    state[:4] = torch.stack([ca, cb, cc, cw])
    state[_ST["live"]] = live.to(state.dtype)
    state[_ST["beta_prev"]] = beta
    state[_ST["broke"]] = (broke | now_broke).to(state.dtype)


def _host_index_pass(op, b, m: int, tol: float, coeffs=None):
    """The host-index CPU loop: m + 1 sweeps, the vectors rotated on the
    host, each stage told its j."""
    _ST = tf._ST
    beta0, v0 = tf._start(b.contiguous())
    dt = v0.dtype
    if coeffs is not None:
        coeffs = coeffs.to(dt).contiguous()
        m = coeffs.shape[0]
    zeros = torch.zeros_like(v0)
    W = None if coeffs is None else torch.zeros_like(v0)
    alphas = torch.empty(m, dtype=dt)
    betas = torch.empty(m, dtype=dt)
    cvals = tf._cvals(op, dt)
    state = tf._const(tf._STATE0, v0)
    state[_ST["broke"]].copy_(beta0 == 0)
    Z, Vc, Vp = v0, zeros, zeros
    for s in range(m + 1):
        Y, Zn, moments = tf.fused_sweep_ref(Z, Vc, Vp, state, op.grid_shape,
                                            op.offsets, cvals, W)
        _stage_host_index(moments, state, alphas, betas, coeffs, s, m, tol)
        Z, Vc, Vp = Zn, Y, Vc
    m_used = state[_ST["m_used"]].to(torch.int32)
    return alphas, betas, beta0, m_used, state[_ST["broke"]] != 0, W


def _same_bits(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), (g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("start", ["random", "invariant", "zero"])
@pytest.mark.parametrize("kind", ["7pt", "5pt-2d", "13pt", "var"])
def test_device_index_pass_equals_host_index_bits(kind, start, m, dtype):
    """Both passes in the device-index form against the host-index driver
    they replaced, bit for bit: alphas, betas, beta0, m_used, broke and the
    replay's w; the counter ends at m + 1."""
    top = et.to_torch_operator(_jax_op(kind, dtype))
    b = torch.as_tensor(_start_vector(start, top.grid_shape, top.shape[0],
                                      dtype))
    got = tf._lanczos_sweeps(top, b, m, TOL, what="test")
    _same_bits(got, _host_index_pass(top, b, m, TOL))
    c = torch.as_tensor(_reduced(t2n(got[0]), t2n(got[1]), float(got[2]),
                                 0.1).astype(dtype))
    rep = tf._lanczos_sweeps(top, b, m, TOL, c, what="test")
    _same_bits(rep, _host_index_pass(top, b, m, TOL, c))
    _same_bits(rep[:2], got[:2])        # the replay's scalars are pass 1's


def test_device_index_pass_runs_one_step_m_plus_1_times():
    """A pass is one step executed m + 1 times by a runner (eagerly on the
    CPU: no capture, no read), and inside a runner's step it runs inline,
    with no runner of its own."""
    top = et.to_torch_operator(_jax_op("7pt", jnp.float64))
    b = torch.as_tensor(_start_vector("random", top.grid_shape, top.shape[0],
                                      np.float64))
    graphs.reset_counts()
    tf.lanczos_coeffs_fused(top, b, 5)
    assert graphs.executions == {
        ("lanczos_coeffs_fused (StencilOperator)", 5, "sweep"): 6}
    assert graphs.counts["eager_steps"] == 6
    assert not graphs.counts["captures"] and not graphs.counts[
        "blocking_reads"]
    graphs.reset_counts()
    out = []
    with graphs.LoopRunner("outer", "cpu") as runner:
        runner.repeat(0, "outer", lambda: out.append(
            tf.lanczos_coeffs_fused(top, b, 5)), 1)
    assert graphs.executions == {("outer", 0, "outer"): 1}
    _same_bits(out[0], tf.lanczos_coeffs_fused(top, b, 5))


@pytest.mark.parametrize("s", [0, 1, 2, 3, 4, 5, 6, 7])
def test_ring_slots_follow_the_host_rotation(s):
    """Sweep s's slots are the vectors the host loop's rotation gave it:
    Z = A y_{s-1}, Vc = y_{s-1}, Vp = y_{s-2}, with y_s in s mod 3 and
    A y_s in s mod 2."""
    ring = tuple(object() for _ in range(7))
    Z, Vc, Vp = ring[0], ring[1], ring[1]
    for r in range(s + 1):
        Y, Zn = ring[2 + r % 3], ring[5 + r % 2]
        if r == s:
            assert tf.ring_slots(ring, s) == (Z, Vc, Vp, Y, Zn)
        Z, Vc, Vp = Zn, Y, Vc


def test_stage_twin_masks_by_the_counter():
    """The stage twin's writes are masked by the counter, not branched on:
    at j = m it writes betas[m - 1] (and broke, had |y_m| shown a
    breakdown) and leaves the rest; past m and with m = 0 it only
    counts."""
    st = tf._const(tf._STATE0, torch.zeros(1, dtype=torch.float64))
    st[tf._ST["live"]].fill_(1.0)
    st[tf._ST["step"]].fill_(3.0)
    alphas = torch.full((3,), 7.0, dtype=torch.float64)
    betas = torch.full((3,), 7.0, dtype=torch.float64)
    before = st.clone()
    tf.sweep_stage_ref(torch.tensor([4.0, 1.0], dtype=torch.float64), st,
                       alphas, betas, None, 3, TOL)
    assert torch.equal(betas, torch.tensor([7.0, 7.0, 2.0],
                                           dtype=torch.float64))
    assert torch.equal(alphas, torch.full((3,), 7.0, dtype=torch.float64))
    assert torch.equal(st[:tf._ST["step"]], before[:tf._ST["step"]])
    assert float(st[tf._ST["step"]]) == 4.0
    # past the end (j = 4 > m): nothing but the counter, even at a
    # breakdown
    st2, b2 = st.clone(), betas.clone()
    tf.sweep_stage_ref(torch.tensor([0.0, 0.0], dtype=torch.float64), st,
                       alphas, betas, None, 3, TOL)
    assert torch.equal(betas, b2) and torch.equal(st[:tf._ST["step"]],
                                                  st2[:tf._ST["step"]])
    assert float(st[tf._ST["step"]]) == 5.0
    empty = torch.empty(0, dtype=torch.float64)
    tf.sweep_stage_ref(torch.tensor([4.0, 1.0], dtype=torch.float64), st,
                       empty, empty, None, 0, TOL)
    assert float(st[tf._ST["step"]]) == 6.0


@pytest.mark.parametrize("kind", ["7pt", "5pt-2d"])
def test_breakdown_at_the_last_step_sets_broke(kind):
    """b in a 2-dimensional invariant subspace and m = 2: the last sweep's
    |y_2| is round-off, and pass 1 reports the breakdown as the plain pass
    1 of both packages does (m_used 2, broke True; JAX's fused pass, which
    sees a breakdown one sweep late, reports broke False). The parent's
    fused pass reported broke False."""
    jop = _jax_op(kind, jnp.float64)
    top = et.to_torch_operator(jop)
    b = _start_vector("invariant", jop.grid_shape, jop.shape[0], np.float64)
    _, jb, _, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), 2)
    assert (int(jmu), bool(jbr)) == (2, True) and float(jb[1]) < TOL
    _, _, _, pmu, pbr = tk.lanczos_coeffs(top, torch.as_tensor(b), 2)
    _, tb, _, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), 2)
    assert (int(tmu), bool(tbr)) == (int(pmu), bool(pbr)) == (2, True)
    assert float(tb[1]) < TOL


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("kind", ["7pt", "5pt-2d", "13pt", "var"])
def test_device_index_passes_vs_interpret(kind, m):
    """Pass 1 and the replay against JAX's fused passes in interpret mode,
    float32."""
    jop = _jax_op(kind, jnp.float32)
    top = et.to_torch_operator(jop)
    b = np.random.default_rng(1).standard_normal(jop.shape[0]).astype(
        np.float32)
    ja, jb, jb0, jmu, jbr = jf.lanczos_coeffs_fused(jop, jnp.asarray(b), m,
                                                    interpret=True)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert_close(t2n(ta), np.asarray(ja), RTOL32, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL32, "betas")
    assert float(tb0) == pytest.approx(float(jb0), rel=RTOL32)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
    c = _reduced(ja, jb, jb0, 0.05).astype(np.float32)
    jw = jf.lanczos_replay_fused(jop, jnp.asarray(b), jnp.asarray(c),
                                 interpret=True)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    assert_close(t2n(tw), np.asarray(jw), RTOL32, "replay")


@pytest.mark.parametrize("m", [1, 2, 3, 6])
@pytest.mark.parametrize("start", ["random", "invariant", "zero"])
@pytest.mark.parametrize("kind", ["7pt", "5pt-2d", "var"])
def test_device_index_passes_vs_xla(kind, start, m):
    """Pass 1 and the replay against the XLA pass 1 and replay in float64:
    a happy breakdown after two steps, b = 0 and a random start; m_used and
    broke exactly, the live betas and the replay within 1e2 RTOL64."""
    jop = _jax_op(kind, jnp.float64)
    top = et.to_torch_operator(jop)
    b = _start_vector(start, jop.grid_shape, jop.shape[0], np.float64)
    ja, jb, jb0, jmu, jbr = jk.lanczos_coeffs(jop, jnp.asarray(b), m)
    ta, tb, tb0, tmu, tbr = tf.lanczos_coeffs_fused(top, torch.as_tensor(b), m)
    assert (int(tmu), bool(tbr)) == (int(jmu), bool(jbr))
    if kind != "var":
        assert int(tmu) == {"invariant": min(2, m), "zero": 0,
                            "random": m}[start]
    assert_close(t2n(ta), np.asarray(ja), 1e2 * RTOL64, "alphas")
    live = np.asarray(jb) >= TOL
    assert_close(t2n(tb) * live, np.asarray(jb) * live, 1e2 * RTOL64,
                 "betas")
    c = _reduced(ja, jb, jb0, 0.1)
    jw = jk.lanczos_replay(jop, jnp.asarray(b), jnp.asarray(c), ja, jb, m)
    tw = tf.lanczos_replay_fused(top, torch.as_tensor(b), torch.as_tensor(c))
    if start == "zero":
        assert not bool(tw.any())
    else:
        assert_close(t2n(tw), np.asarray(jw), 1e2 * RTOL64, "replay")

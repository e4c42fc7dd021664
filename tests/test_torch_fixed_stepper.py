"""PyTorch port vs JAX package: the fixed-(tau, m) Niesen-Wright stepper as
one masked substep (models/timestepping.py): ``phiv_timestep_fused`` /
``expv_timestep_fused`` run the substep over state made before the loop
``nsteps`` times through a ``utils/graphs.LoopRunner`` (the JAX package's
``lax.scan``), and ``make_phiv_timestep``'s ``fn(B)`` is one
``graphs.Scan`` call. On the CPU every step and call runs eagerly;
float64, the same seeded numpy inputs through both packages.

The port's reduced exponential is the masked Taylor engine (no host read),
JAX's another device engine: u is held to JAX's at 1e-10 (norm-scaled, as
tests/test_torch_timestepping.py) and the error history, where it is above
round-off, at 1e-8 of its largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.utils import graphs
from torch_parity import assert_close, t2n

torch.set_num_threads(2)

RTOL = 1e-10          # u against JAX
RTOL_EPS = 1e-8       # the error history against JAX's
T_END = 0.5


def laplacian_1d(n):
    return (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
            + np.diag(np.ones(n - 1), -1))


def _operator(herm: bool, cplx: bool = False):
    """A 1-D Laplacian (Hermitian) or a random dense matrix, n = 40; both
    scaled so that tau |A| is ~1-4 and m = 8 leaves error estimates well
    above round-off."""
    rng = np.random.default_rng(7)
    n = 40
    if herm:
        A = 4.0 * laplacian_1d(n)
    else:
        A = rng.standard_normal((n, n)) / 2
        if cplx:
            A = A + 1j * rng.standard_normal((n, n)) / 2
    return A


def phi_combination_oracle(t, A, B):
    """u(t) = sum_j t^j phi_j(tA) b_j from one block-matrix exponential."""
    n, ppo = B.shape
    p = ppo - 1
    k = max(p, 1)
    E = np.zeros((n, k * n), dtype=A.dtype)
    E[:, :n] = np.eye(n)
    J = (np.kron(np.diag(np.ones(k - 1), 1), np.eye(n)) if k > 1
         else np.zeros((n, n)))
    P = sla.expm(np.block([[t * A, E], [np.zeros((k * n, n)), J]]))
    u = sla.expm(t * A) @ B[:, 0]
    for j in range(1, p + 1):
        u = u + (t ** j) * (P[:n, j * n:(j + 1) * n] @ B[:, j])
    return u


def _close_eps(got, want):
    """The error histories: the same length, each entry within RTOL_EPS of
    the largest, or both at round-off (below 1e-14, the scale of u being
    1)."""
    got, want = t2n(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= RTOL_EPS * float(np.max(np.abs(want))) + 1e-14, (got, want)


@pytest.mark.parametrize("nsteps", [1, 2, 3])
@pytest.mark.parametrize("correct", [False, True])
@pytest.mark.parametrize("herm", [False, True])
@pytest.mark.parametrize("p", [0, 1, 2])
def test_masked_substep_vs_jax_scan(p, herm, correct, nsteps):
    """u(t_end) and the eps history against JAX's scan, and the substeps'
    executions: one step executed nsteps times by one runner (eagerly on
    the CPU), the builder's steps inline (no runner of their own)."""
    A = _operator(herm)
    B = np.random.default_rng(11 + p).standard_normal((A.shape[0], p + 1))
    ju, jeps = ej.phiv_timestep_fused(T_END, jnp.asarray(A), jnp.asarray(B),
                                      nsteps=nsteps, m=8, correct=correct)
    graphs.reset_counts()
    tu, teps = et.phiv_timestep_fused(T_END, torch.as_tensor(A),
                                      torch.as_tensor(B), nsteps=nsteps, m=8,
                                      correct=correct)
    assert graphs.executions == {
        ("phiv_timestep_fused (DenseOperator)", 8, "step"): nsteps}
    assert graphs.counts["eager_steps"] == nsteps
    assert not graphs.counts["captures"]
    assert not graphs.counts["blocking_reads"]
    assert tu.dtype == torch.float64 and teps.shape == (nsteps,)
    assert_close(t2n(tu), np.asarray(ju), RTOL, "u")
    assert float(teps.max()) > 1e-12        # above round-off
    _close_eps(teps, jeps)
    assert_close(t2n(tu), phi_combination_oracle(T_END, A, B), 1e-3,
                 "u vs the block oracle")


@pytest.mark.parametrize("nsteps", [1, 2, 3])
def test_complex_b_on_complex_operator(nsteps):
    """A complex B (p = 1) on a complex non-Hermitian operator, against
    JAX's scan and the block oracle."""
    A = _operator(False, cplx=True)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((40, 2)) + 1j * rng.standard_normal((40, 2))
    ju, jeps = ej.phiv_timestep_fused(T_END, jnp.asarray(A), jnp.asarray(B),
                                      nsteps=nsteps, m=8)
    tu, teps = et.phiv_timestep_fused(T_END, torch.as_tensor(A),
                                      torch.as_tensor(B), nsteps=nsteps, m=8)
    assert tu.dtype == torch.complex128 and teps.dtype == torch.float64
    assert_close(t2n(tu), np.asarray(ju), RTOL, "u")
    _close_eps(teps, jeps)
    assert_close(t2n(tu), phi_combination_oracle(T_END, A, B), 1e-3,
                 "u vs the block oracle")


@pytest.mark.parametrize("nsteps", [1, 2, 3])
def test_expv_timestep_fused_vs_jax(nsteps):
    A = _operator(True)
    b = np.random.default_rng(3).standard_normal(40)
    ju, jeps = ej.expv_timestep_fused(T_END, jnp.asarray(A), jnp.asarray(b),
                                      nsteps=nsteps, m=8)
    tu, teps = et.expv_timestep_fused(T_END, torch.as_tensor(A),
                                      torch.as_tensor(b), nsteps=nsteps, m=8)
    assert_close(t2n(tu), np.asarray(ju), RTOL, "u")
    _close_eps(teps, jeps)


def _calibrated(herm=False):
    rng = np.random.default_rng(12345)
    A = rng.standard_normal((60, 60)) / 8
    if herm:
        A = A + A.T
    B = rng.standard_normal((60, 2))
    return A, B


def test_make_phiv_timestep_four_calls_vs_jax():
    """fn(B) called four times, each with a fresh B, against JAX's fn; the
    program's calls all eager on the CPU, and fn.close() is there."""
    A, B = _calibrated()
    jfn = ej.make_phiv_timestep(1.0, jnp.asarray(A), jnp.asarray(B),
                                tol=1e-8, m=15)
    tfn = et.make_phiv_timestep(1.0, torch.as_tensor(A), torch.as_tensor(B),
                                tol=1e-8, m=15)
    assert (tfn.nsteps, tfn.m) == (jfn.nsteps, jfn.m)
    rng = np.random.default_rng(99)
    graphs.reset_counts()
    for _ in range(4):
        Bi = rng.standard_normal((60, 2))
        ju, jeps = jfn(jnp.asarray(Bi))
        tu, teps = tfn(torch.as_tensor(Bi))
        assert teps.shape == (tfn.nsteps,)
        assert_close(t2n(tu), np.asarray(ju), RTOL, "calibrated stepper")
        _close_eps(teps, jeps)
    assert graphs.counts["eager_steps"] == 4          # one a call, inline
    assert not graphs.counts["captures"] and not graphs.counts["replays"]
    tfn.close()


@pytest.mark.parametrize("how", ["in place", "reassign"])
def test_make_phiv_timestep_follows_operator_storage(how):
    """fn(B) after the operator's storage changes (scaled by 0.5 in place,
    or its matrix reassigned) gives the new operator's u, against scipy's
    block oracle."""
    A, B = _calibrated(herm=True)
    op = et.DenseOperator(torch.tensor(A), is_hermitian=True)
    fn = et.make_phiv_timestep(1.0, op, torch.as_tensor(B), tol=1e-9, m=15)
    for _ in range(2):
        fn(torch.as_tensor(B))
    if how == "in place":
        op.A.mul_(0.5)
    else:
        op.A = op.A * 0.5
    u, _ = fn(torch.as_tensor(B))
    assert_close(t2n(u), phi_combination_oracle(1.0, 0.5 * A, B), 1e-7,
                 "after the change")


def test_make_phiv_timestep_b_requires_grad():
    """A B that requires grad: the call runs eagerly and B gets its
    gradient: <w, u(B)> against a central difference along a random
    direction, and against the gradient of the exact map (u is linear in
    B: d<w, u>/db_j = t^j phi_j(tA)^T w)."""
    A, B = _calibrated()
    fn = et.make_phiv_timestep(1.0, torch.as_tensor(A), torch.as_tensor(B),
                               tol=1e-10, m=20)
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.standard_normal(60))
    Bt = torch.as_tensor(B).clone().requires_grad_(True)
    u, _ = fn(Bt)
    assert u.requires_grad
    (u @ w).backward()
    g = Bt.grad
    d = torch.as_tensor(rng.standard_normal((60, 2)))
    h = 1e-5
    with torch.no_grad():
        fd = ((fn(torch.as_tensor(B) + h * d)[0] @ w)
              - (fn(torch.as_tensor(B) - h * d)[0] @ w)) / (2 * h)
    assert abs(float((g * d).sum()) - float(fd)) <= 1e-7 * abs(float(fd))
    # the exact map's gradient, column by column from the block oracle
    exact = np.stack([
        phi_combination_oracle(1.0, A.T, np.stack(
            [w.numpy() if i == j else np.zeros(60) for i in range(2)], 1))
        for j in range(2)], 1)
    assert_close(t2n(g), exact, 1e-6, "gradient vs the exact map")

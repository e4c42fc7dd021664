"""PyTorch port vs JAX package and scipy: blocked Schur-Parlett f(A)
(ops/funm.py) on the CPU, with the JAX tests' fixtures and tolerances
(tests/test_funm.py), and the repair of the JAX package's silent return
of an unconverged device Parlett result (parlett="device" now raises)."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from test_funm import _grcar
from torch_parity import t2n

torch.set_num_threads(2)


def _rel(X, Y):
    X, Y = np.asarray(X), np.asarray(Y)
    return np.linalg.norm(X - Y) / np.linalg.norm(Y)


@pytest.mark.parametrize("parlett", ["auto", "device", "host"])
def test_grcar_vs_scipy_and_jax(parlett):
    G = _grcar(60)
    F = t2n(et.funm(torch.as_tensor(G), "exp", parlett=parlett))
    assert _rel(F, sla.expm(G)) < 1e-10
    assert _rel(F, np.asarray(ej.funm(G, "exp", parlett=parlett))) < 1e-11


def test_defective_and_clustered():
    rng = np.random.default_rng(1)
    J = 0.5 * np.eye(12) + np.diag(np.ones(11), 1)
    Q = sla.qr(rng.standard_normal((12, 12)))[0]
    A = Q @ J @ Q.T
    assert _rel(t2n(et.funm(A, "exp")), sla.expm(A)) < 1e-12
    lam = np.concatenate([np.full(10, 1.0) + 1e-9 * rng.standard_normal(10),
                          rng.standard_normal(20)])
    R = rng.standard_normal((30, 30))
    B = sla.solve(R, (R * lam).T).T
    assert _rel(t2n(et.funm(torch.as_tensor(B), "exp")), sla.expm(B)) < 1e-12


@pytest.mark.parametrize("name", ["log", "sqrt", "sin", "cos", "phi2"])
def test_named_functions_vs_jax(name):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((20, 20)) / 4 + 2 * np.eye(20)
    F = t2n(et.funm(torch.as_tensor(A), name))
    want = np.asarray(ej.funm(A, name))
    assert F.dtype == want.dtype
    assert _rel(F, want) < 1e-12


def test_complex_input_and_scalar_callable():
    rng = np.random.default_rng(3)
    C = (rng.standard_normal((10, 10)) + 1j * rng.standard_normal((10, 10))) / 3
    assert _rel(t2n(et.funm(torch.as_tensor(C), "exp")), sla.expm(C)) < 1e-13
    A = np.triu(rng.standard_normal((8, 8))) / 4 + np.diag(np.arange(8.0))
    F = t2n(et.funm(A, lambda z: 1.0 / (1.0 + z)))
    assert _rel(F, np.linalg.inv(np.eye(8) + A)) < 1e-12
    with pytest.raises(ValueError, match="matfunc"):
        et.funm(np.eye(3) + np.diag([1.0, 1.0], 1), lambda z: z)
    with pytest.raises(ValueError):
        et.funm(np.ones((2, 3)), "exp")
    with pytest.raises(ValueError):
        et.funm(np.eye(3), "nope")
    assert torch.allclose(et.expm(torch.as_tensor(A), method="schur"),
                          torch.as_tensor(sla.expm(A)), rtol=1e-12,
                          atol=1e-12 * np.abs(sla.expm(A)).max())


def _long_chain(n=130, c=20.0):
    """Upper bidiagonal, eigenvalues 0.3 apart (every one its own
    cluster), superdiagonal c: the device fixed point's entries overflow
    before its chains close."""
    return np.diag(-0.3 * np.arange(n)) + c * np.diag(np.ones(n - 1), 1)


def test_device_parlett_never_returns_unconverged():
    """At n = 130 (> 126, where the default cap min(2n + 4, 256) binds),
    the device fixed point does not close: the JAX package's
    parlett="device" returns its result silently (91 % away from the host
    recurrence's); the port raises, and "auto" takes the host
    recurrence."""
    T = _long_chain()
    Fh = t2n(et.funm(torch.as_tensor(T), "exp", parlett="host"))
    assert np.isfinite(Fh).all()
    assert _rel(np.asarray(ej.funm(T, "exp", parlett="host")), Fh) < 1e-12
    assert _rel(np.asarray(ej.funm(T, "exp", parlett="device")), Fh) > 0.5
    with pytest.raises(FloatingPointError, match="did not close"):
        et.funm(torch.as_tensor(T), "exp", parlett="device")
    Fa = t2n(et.funm(torch.as_tensor(T), "exp", parlett="auto"))
    np.testing.assert_array_equal(Fa, Fh)


def test_iteration_cap_falls_back():
    """tests/test_funm.py::test_iteration_cap_falls_back: iters=1 cannot
    close a 3-cluster fixed point; "auto" falls back, "device" raises."""
    rng = np.random.default_rng(4)
    lam = np.repeat([-1.0, 0.5, 2.0], 4) + 1e-3 * rng.standard_normal(12)
    R = rng.standard_normal((12, 12))
    A = sla.solve(R, (R * lam).T).T
    F = t2n(et.funm(torch.as_tensor(A), "exp", parlett="auto", iters=1))
    assert _rel(F, sla.expm(A)) < 1e-10
    with pytest.raises(FloatingPointError):
        et.funm(torch.as_tensor(A), "exp", parlett="device", iters=1)


# A user's f and matfunc get complex128 CPU tensors, so torch callables
# work beside numpy ufuncs, cmath lambdas and scipy functions

def _separated(n=12, seed=5):
    """Eigenvalues 1 apart (every one its own 1 x 1 block), non-normal."""
    rng = np.random.default_rng(seed)
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    T = np.triu(rng.standard_normal((n, n)), 1) / 4 + np.diag(
        np.arange(n) / 2.0 - 3.0)
    return Q @ T @ Q.T


def _clustered(seed=6):
    """Two clusters of four within delta and four isolated eigenvalues."""
    rng = np.random.default_rng(seed)
    lam = np.concatenate([np.full(4, -1.0), np.full(4, 0.7),
                          [-3.0, -2.0, 1.8, 2.9]])
    lam[:8] += 1e-3 * rng.standard_normal(8)
    R = rng.standard_normal((12, 12))
    return sla.solve(R, (R * lam).T).T


SCALAR_FS = {"torch.exp": (torch.exp, sla.expm),
             "torch.sin": (torch.sin, sla.sinm),
             "np.exp": (np.exp, sla.expm),
             "cmath.exp": (lambda z: __import__("cmath").exp(z), sla.expm)}


@pytest.mark.parametrize("name", list(SCALAR_FS))
def test_user_scalar_callables(name):
    f, oracle = SCALAR_FS[name]
    A = _separated()
    F = t2n(et.funm(torch.as_tensor(A), f))
    assert F.dtype == np.float64
    assert _rel(F, oracle(A)) < 1e-12


def test_torch_exp_matches_jax_jnp_exp():
    import jax.numpy as jnp

    A = _separated()
    F = t2n(et.funm(torch.as_tensor(A), torch.exp))
    assert _rel(F, np.asarray(ej.funm(A, jnp.exp))) < 1e-12


@pytest.mark.parametrize("matfunc", ["torch", "scipy"])
def test_user_matfunc_on_clusters(matfunc):
    A = _clustered()
    mf = torch.linalg.matrix_exp if matfunc == "torch" else sla.expm
    F = t2n(et.funm(torch.as_tensor(A), torch.exp, matfunc=mf))
    assert _rel(F, sla.expm(A)) < 1e-12
    # a block evaluator alone serves the 1 x 1 blocks too
    G = t2n(et.funm(torch.as_tensor(A), None, matfunc=mf))
    assert _rel(G, sla.expm(A)) < 1e-12

"""PyTorch port vs JAX package and scipy: the truncated-Taylor expv
(models/expv_taylor.py), on CPU with the same seeded numpy inputs.

The theta table is the JAX package's exactly (the same exact-rational
bisection); results agree with JAX's to 1e-12 relative and with scipy's
dense ``expm`` at the JAX tests' limits (1e-12 dense, 1e-9 at norm 30,
1e-10 through an operator, 1e-5 in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.models import expv_taylor as jt
from exponentialutilities_jl_torch.models import expv_taylor as tt
from torch_parity import assert_close, t2n

torch.set_num_threads(2)


def test_theta_table_is_the_reference():
    assert tt.taylor_theta(torch.float64) == jt.taylor_theta(jnp.float64)
    assert tt.taylor_theta(torch.float32) == jt.taylor_theta(jnp.float32)


@pytest.mark.parametrize("n,scale,t,tol", [(4, 1.0, 0.9, 1e-12),
                                           (8, 1.0, 0.9, 1e-12),
                                           (20, 1.0, 0.9, 1e-12),
                                           (12, 30.0, 1.0, 1e-9)])
def test_dense_vs_jax_and_scipy(n, scale, t, tol):
    rng = np.random.default_rng(12345 + n)
    A = rng.standard_normal((n, n)) * scale
    b = rng.standard_normal(n)
    tw = et.expv_taylor(t, torch.as_tensor(A), torch.as_tensor(b))
    jw = ej.expv_taylor(t, A, b)
    assert_close(t2n(tw), np.asarray(jw), 1e-12, "vs JAX")
    want = sla.expm(t * A) @ b
    assert np.linalg.norm(t2n(tw) - want) / np.linalg.norm(want) < tol


def test_operator_path_vs_scipy():
    n = 200
    A = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1))
    b = np.random.default_rng(1).standard_normal(n)
    want = sla.expm(A) @ b
    for op in (et.DenseOperator(torch.as_tensor(A), is_hermitian=True),
               et.laplacian_1d(n, device="cpu")):
        w = et.expv_taylor(1.0, op, b)          # the operator's opnorm_hint
        assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-10
    w = et.expv_taylor(1.0, et.laplacian_1d(n, device="cpu"), b, opnorm=4.0)
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-10


def test_matrix_free_requires_norm_and_zero_matrix():
    op = et.MatrixFreeOperator(lambda x: x, (5, 5), device="cpu")
    with pytest.raises(ValueError):
        et.expv_taylor(1.0, op, np.ones(5))
    w = et.expv_taylor(1.0, np.zeros((6, 6)), np.ones(6))
    assert torch.equal(w, torch.ones(6, dtype=w.dtype))


def test_float32():
    rng = np.random.default_rng(16)
    A = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    w = et.expv_taylor(np.float32(0.5), torch.as_tensor(A), torch.as_tensor(b))
    assert w.dtype == torch.float32
    want = sla.expm(0.5 * A.astype(np.float64)) @ b
    assert np.linalg.norm(t2n(w) - want) / np.linalg.norm(want) < 1e-5


def test_batched_vs_jax_and_scipy():
    rng = np.random.default_rng(17)
    As = rng.standard_normal((6, 10, 10))
    As[2] *= 30.0                       # one system takes the power probes
    bs = rng.standard_normal((6, 10))
    ts = rng.uniform(0.1, 1.5, 6)
    tw = et.expv_taylor_batched(torch.as_tensor(ts), torch.as_tensor(As),
                                torch.as_tensor(bs))
    jw = ej.expv_taylor_batched(ts, As, bs)
    for i in range(6):
        want = sla.expm(ts[i] * As[i]) @ bs[i]
        assert_close(t2n(tw[i]), np.asarray(jw[i]), 1e-12, f"system {i}")
        assert np.linalg.norm(t2n(tw[i]) - want) / np.linalg.norm(want) < 1e-9
    with pytest.raises(ValueError):
        et.expv_taylor_batched(0.5, torch.ones(3, 4), torch.ones(3, 4))

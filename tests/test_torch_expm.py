"""PyTorch port vs JAX package and scipy: the dense exponential
(ops/expm.py) and the dense phi functions (ops/phi_dense.py), on CPU with
the same seeded numpy matrices through both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from test_phi import phi_block_oracle
from torch_parity import RTOL32, RTOL64, assert_close, t2n

torch.set_num_threads(2)

# 1-norms that select each float64 Pade degree (3, 5, 7, 9, 13), and one
# past the top threshold (5.37) that needs squarings
NORMS = [1e-3, 0.2, 0.8, 2.0, 5.0, 60.0]
# against scipy's expm (Al-Mohy & Higham 2009, another degree choice and
# scaling): both are backward stable, so agreement is a few ulps times the
# condition of the squarings
RTOL_SCIPY = 1e-11
# float32 against scipy in float64: float32 unit roundoff times the
# squarings' growth
RTOL_SCIPY32 = 1e-5


def _mat(norm, n=12, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((n, n))
    return A * (norm / np.abs(A).sum(axis=0).max())


@pytest.mark.parametrize("method", ["higham2005", "taylor"])
@pytest.mark.parametrize("norm", NORMS)
def test_expm_vs_jax_and_scipy(method, norm):
    A = _mat(norm)
    tw = t2n(et.expm(torch.as_tensor(A), method=method))
    jw = np.asarray(ej.expm(jnp.asarray(A), method=method))
    assert_close(tw, jw, RTOL64, "vs JAX")
    assert_close(tw, sla.expm(A), RTOL_SCIPY, "vs scipy")


@pytest.mark.parametrize("fn", ["expm_higham2005", "expm_taylor"])
@pytest.mark.parametrize("norm", [0.3, 3.0, 60.0])
def test_expm_float32_and_complex(fn, norm):
    A = _mat(norm, seed=1)
    t32 = t2n(getattr(et, fn)(torch.as_tensor(A, dtype=torch.float32)))
    j32 = np.asarray(getattr(ej, fn)(jnp.asarray(A, jnp.float32)))
    assert t32.dtype == np.float32
    assert_close(t32, j32, RTOL32, "f32 vs JAX")
    assert_close(t32, sla.expm(A), RTOL_SCIPY32, "f32 vs scipy")
    C = _mat(norm, seed=2, cplx=True)
    tc = t2n(getattr(et, fn)(torch.as_tensor(C)))
    assert_close(tc, np.asarray(getattr(ej, fn)(jnp.asarray(C))), RTOL64,
                 "c128 vs JAX")
    assert_close(tc, sla.expm(C), RTOL_SCIPY, "c128 vs scipy")


def test_expm_front_door_rejects():
    """What the front door still rejects; every method, stacked input and
    balance=True run (ported in the dense-layer slice; their parity tests
    are in tests/test_torch_dense.py)."""
    A = torch.as_tensor(_mat(1.0))
    for method in ("generic", "diagonalization", "native", "schur", "gebal"):
        assert_close(t2n(et.expm(A, method=method)), sla.expm(t2n(A)),
                     RTOL_SCIPY, method)
    with pytest.raises(ValueError):
        et.expm(A, method="nope")
    with pytest.raises(TypeError):
        et.expm(et.laplacian_1d(8))
    S = t2n(et.expm(torch.stack([A, A])))
    assert_close(S[1], sla.expm(t2n(A)), RTOL_SCIPY, "stacked")
    with pytest.raises(ValueError):
        et.expm(A[:, :5])
    assert_close(t2n(et.expm_higham2005(A, balance=True)), sla.expm(t2n(A)),
                 RTOL_SCIPY, "balance=True")


def test_phi_scalar_vs_jax():
    z = np.linspace(-3.0, 2.0, 7)          # includes small |z|
    tw = t2n(et.phi_scalar(torch.as_tensor(z), 4))
    assert tw.shape == (7, 5)
    assert_close(tw, np.asarray(ej.phi_scalar(jnp.asarray(z), 4)), RTOL64,
                 "vs JAX")
    ts = t2n(et.phi_scalar(torch.tensor(0.7, dtype=torch.float64), 2))
    assert_close(ts, np.asarray(ej.phi_scalar(jnp.asarray(0.7), 2)), RTOL64,
                 "scalar")


@pytest.mark.parametrize("method", ["higham2005", "taylor"])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_phiv_dense_vs_jax_and_oracle(k, method):
    rng = np.random.default_rng(3)
    n = 15
    A = rng.standard_normal((n, n))
    v = rng.standard_normal(n)
    tw = t2n(et.phiv_dense(torch.as_tensor(A), torch.as_tensor(v), k,
                           expm_method=method))
    jw = np.asarray(ej.phiv_dense(jnp.asarray(A), jnp.asarray(v), k,
                                  expm_method=method))
    assert tw.shape == (n, k + 1)
    assert_close(tw, jw, RTOL64, "vs JAX")
    # the block-matrix oracle exp([A E; 0 J]) of tests/test_phi.py
    want = phi_block_oracle(A, max(k, 1))
    for j in range(k + 1):
        assert_close(tw[:, j], want[j] @ v, 1e-10, f"phi_{j} vs oracle")

"""PyTorch port vs JAX package and scipy: the rest of the dense
exponential (ops/expm.py: every method, balancing, gebal, the batched
form) and of the dense phi functions (ops/phi_dense.py: phi, phi_taylor,
phi_taylor_batched, phi_with_info), on the CPU in float64 (float32 where
stated) with the same seeded numpy matrices through both packages.

Tolerances are those of the matching JAX tests (tests/test_expm.py,
tests/test_phi.py) against scipy and the block oracle, and RTOL64-class
(1e-12, norm-scaled) between the two packages where both run the same
arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops import expm as texpm
from test_expm import TestGebal
from test_phi import phi_block_oracle
from torch_parity import RTOL32, assert_close, t2n

torch.set_num_threads(2)

METHODS = ["higham2005", "generic", "diagonalization", "native", "taylor",
           "schur", "gebal"]
# the port against the JAX package: the same algorithm, another summation
# order (and for "diagonalization"/"native" another LAPACK/implementation)
RTOL_PAIR = {"generic": 1e-12, "diagonalization": 1e-12, "native": 1e-12}


def _rand(n, seed, scale=0.1):
    return np.random.default_rng(seed).standard_normal((n, n)) * scale


@pytest.mark.parametrize("method", METHODS)
def test_methods_vs_jax_and_scipy(method):
    """tests/test_expm.py::test_methods_vs_scipy_random at n = 60 (1e-12
    against scipy), and each method against its JAX twin."""
    A = _rand(60, 0)
    tw = t2n(et.expm(torch.as_tensor(A), method=method))
    jw = np.asarray(ej.expm(jnp.asarray(A), method=method))
    assert_close(tw, sla.expm(A), 1e-12, "vs scipy")
    assert_close(tw, jw, RTOL_PAIR.get(method, 1e-13), "vs JAX")


@pytest.mark.parametrize("method", ["higham2005", "generic", "taylor",
                                    "native", "diagonalization"])
def test_complex_methods(method):
    rng = np.random.default_rng(1)
    A = (rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12)))
    tw = t2n(et.expm(torch.as_tensor(A), method=method))
    assert tw.dtype == np.complex128
    assert_close(tw, sla.expm(A), 1e-11, "vs scipy")


def test_diagonalization_hermitian():
    M = _rand(20, 2, 1.0)
    A = M + M.T
    tw = t2n(et.expm_diagonalization(torch.as_tensor(A), is_hermitian=True))
    assert_close(tw, sla.expm(A), 1e-12, "eigh")


@pytest.mark.parametrize("scale", [1e-3, 0.5, 5.0, 80.0])
def test_differentiable_forms_equal_default(scale):
    """The forms with no host read pick the same degree and squaring count
    on the device: the same bits as the default forms where the arithmetic
    is the same (Taylor), else (the denominator by inv_ex, not solve_ex)
    a few ulps times the squarings' growth."""
    A = torch.as_tensor(_rand(10, 3, scale))
    assert torch.equal(et.expm_taylor(A, differentiable=True),
                       et.expm_taylor(A))
    assert torch.equal(et.phi_taylor(A, 3, differentiable=True),
                       et.phi_taylor(A, 3))
    assert_close(t2n(et.expm_higham2005(A, differentiable=True)),
                 t2n(et.expm_higham2005(A)), 1e-12, "higham2005")
    assert_close(t2n(et.expm_generic(A)),
                 t2n(et.expm_generic(A, differentiable=False)), 1e-12,
                 "generic")


def test_pow2_exact():
    """The scaling and balancing factors come from exponent bits: exact
    powers of two (frexp mantissa 0.5) in both dtypes."""
    for dt in (torch.float64, torch.float32):
        e = torch.arange(-60, 61, dtype=dt)
        f = texpm._pow2(e, dt)
        m, ex = torch.frexp(f)
        assert torch.all(m == 0.5) and torch.equal(ex.to(dt), e + 1)


def test_balance_matches_jax_bit_for_bit():
    """tests/test_expm.py TestBalancing: the similarity is exact, d are
    powers of two, the norm drops, and (Ab, d) equal JAX's."""
    rng = np.random.default_rng(4)
    n = 16
    D = np.exp2(rng.integers(-20, 20, size=n)).astype(float)
    A = (1 / D)[:, None] * rng.standard_normal((n, n)) * D[None, :]
    Ab, d = (t2n(x) for x in et.balance_matrix(torch.as_tensor(A)))
    np.testing.assert_array_equal(Ab, A * (d[None, :] / d[:, None]))
    assert np.all(np.frexp(d)[0] == 0.5)
    assert np.abs(Ab).sum(axis=0).max() < 0.01 * np.abs(A).sum(axis=0).max()
    Abj, dj = ej.balance_matrix(jnp.asarray(A))
    np.testing.assert_array_equal(Ab, np.asarray(Abj))
    np.testing.assert_array_equal(d, np.asarray(dj))


def test_expm_balanced_accuracy():
    rng = np.random.default_rng(5)
    n = 12
    D = np.exp2(rng.integers(-12, 12, size=n)).astype(float)
    M = rng.standard_normal((n, n)) * 0.5
    A = (1 / D)[:, None] * M * D[None, :]
    oracle = (1 / D)[:, None] * sla.expm(M) * D[None, :]
    E = t2n(et.expm(torch.as_tensor(A), balance=True))
    assert (np.abs(E - oracle) / np.abs(oracle)).max() < 1e-8


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_gebal_window_and_similarity(seed):
    """tests/test_expm.py TestGebal: the window equals LAPACK dgebal's, the
    similarity is exact, (B, d, p) equal JAX's."""
    from scipy.linalg import lapack
    A = TestGebal()._bordered(seed)
    p, ilo, ihi = texpm._gebal_permutation(A != 0)
    _, lo, hi, _, info = lapack.dgebal(A, scale=0, permute=1)
    assert info == 0 and (ilo, ihi) == (lo, hi + 1)
    B, d, p = et.gebal(torch.as_tensor(A))
    B, d = t2n(B), t2n(d)
    np.testing.assert_array_equal(B, A[np.ix_(p, p)] / d[:, None]
                                  * d[None, :])
    assert np.all(d[:ilo] == 1) and np.all(d[ihi:] == 1)
    Bj, dj, pj = ej.gebal(A)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(B, np.asarray(Bj))


def test_expm_gebal_bordered_vs_dd_oracle():
    """The bordered class reaches 1e-11 against the double-double
    exponential (the JAX test's oracle) and beats the unbalanced Pade by
    100x."""
    for seed in (3, 7):
        A = TestGebal()._bordered(seed)
        want = t2n(et.expm_dd(torch.as_tensor(A)).hi)
        nrm = np.linalg.norm(want)
        e_plain = np.linalg.norm(t2n(et.expm_higham2005(
            torch.as_tensor(A))) - want) / nrm
        e_gebal = np.linalg.norm(t2n(et.expm_gebal(
            torch.as_tensor(A))) - want) / nrm
        assert e_gebal < 1e-11 and e_gebal < e_plain / 100


def test_expm_gebal_triangular():
    A = np.triu(_rand(20, 6, 1.0)) / 3
    want = sla.expm(A)
    for got in (et.expm_gebal(A), et.expm(torch.as_tensor(A),
                                          method="gebal")):
        assert np.linalg.norm(t2n(got) - want) / np.linalg.norm(want) < 1e-13


class TestBatched:
    """tests/test_expm.py TestBatchedExpm against the port."""

    def _stack(self, dtype=np.float64):
        rng = np.random.default_rng(7)
        scales = np.array([0.01, 0.3, 2.0, 9.0, 40.0])
        return (rng.standard_normal((5, 10, 10)) * scales[:, None, None]
                / 10).astype(dtype) * 10

    def test_mixed_norms_vs_scipy_and_jax(self):
        A = self._stack()
        E = t2n(et.expm(torch.as_tensor(A)))
        for i in range(5):
            assert_close(E[i], sla.expm(A[i]), 1e-12, f"element {i}")
        assert_close(E, np.asarray(ej.expm_higham2005_batched(
            jnp.asarray(A))), 1e-13, "vs JAX")

    def test_uniform_norms_match_unbatched(self):
        rng = np.random.default_rng(8)
        A = rng.standard_normal((4, 8, 8))
        A = A / np.abs(A).sum(axis=1).max(axis=1)[:, None, None] * 3.0
        E = t2n(et.expm_higham2005_batched(torch.as_tensor(A)))
        for i in range(4):
            assert_close(E[i], t2n(et.expm_higham2005(torch.as_tensor(A[i]))),
                         1e-15, f"element {i}")

    def test_float32_and_complex(self):
        # tests/test_expm.py::TestBatchedHigham::test_f32_dtype_and_accuracy
        rng = np.random.default_rng(10)
        A = rng.standard_normal((6, 32, 32)).astype(np.float32)
        A *= 5.0 / np.linalg.norm(A, 1, axis=(1, 2))[:, None, None]
        E = t2n(et.expm(torch.as_tensor(A)))
        assert E.dtype == np.float32
        for i in range(6):
            assert_close(E[i], sla.expm(A[i].astype(np.float64)), 2e-5,
                         f"f32 element {i}")
        assert_close(E, np.asarray(ej.expm_higham2005_batched(
            jnp.asarray(A))), RTOL32, "f32 vs JAX")
        rng = np.random.default_rng(9)
        C = rng.standard_normal((3, 6, 6)) + 1j * rng.standard_normal(
            (3, 6, 6))
        Ec = t2n(et.expm(torch.as_tensor(C)))
        for i in range(3):
            assert_close(Ec[i], sla.expm(C[i]), 1e-12, f"c128 element {i}")

    def test_balance_kwarg(self):
        A = self._stack()
        E0 = t2n(et.expm_higham2005_batched(torch.as_tensor(A)))
        E1 = t2n(et.expm_higham2005_batched(torch.as_tensor(A),
                                            balance=True))
        J1 = np.asarray(ej.expm_higham2005_batched(jnp.asarray(A),
                                                   balance=True))
        for i in range(5):
            assert_close(E1[i], sla.expm(A[i]), 1e-12, f"balanced {i}")
            assert_close(E0[i], sla.expm(A[i]), 1e-12, f"plain {i}")
        assert_close(E1, J1, 1e-13, "balanced vs JAX")


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("scale", [0.3, 4.0, 50.0])
def test_phi_taylor_vs_jax_and_oracle(k, scale):
    A = _rand(12, 10, scale / 3)
    tw = t2n(et.phi_taylor(torch.as_tensor(A), k))
    jw = np.asarray(ej.phi_taylor(jnp.asarray(A), k))
    assert tw.shape == (k + 1, 12, 12)
    assert_close(tw, jw, 1e-13, "vs JAX")
    want = phi_block_oracle(A, max(k, 1))
    for j in range(k + 1):
        assert_close(tw[j], want[j], 1e-11, f"phi_{j} vs oracle")


@pytest.mark.parametrize("method", ["auto", "pade", "taylor"])
def test_phi_front_door(method):
    A = _rand(14, 11, 1.0)
    tw = t2n(et.phi(torch.as_tensor(A), 3, method=method))
    jw = np.asarray(ej.phi(jnp.asarray(A), 3, method=method))
    assert_close(tw, jw, 1e-13, "vs JAX")
    want = phi_block_oracle(A, 3)
    for j in range(4):
        assert_close(tw[j], want[j], 1e-12, f"phi_{j} vs oracle")
    with pytest.raises(ValueError):
        et.phi(torch.as_tensor(A), 3, method="nope")


def test_phi_taylor_batched_vs_jax_and_per_element():
    rng = np.random.default_rng(12)
    A = rng.standard_normal((4, 9, 9)) * np.array(
        [0.1, 1.0, 5.0, 20.0])[:, None, None] / 3
    tw = t2n(et.phi(torch.as_tensor(A), 2))          # stacked route
    assert tw.shape == (4, 3, 9, 9)
    assert_close(tw, np.asarray(ej.phi_taylor_batched(jnp.asarray(A), 2)),
                 1e-13, "vs JAX")
    for i in range(4):
        want = phi_block_oracle(A[i], 2)
        for j in range(3):
            assert_close(tw[i, j], want[j], 1e-11, f"element {i} phi_{j}")


def test_phi_with_info():
    A = torch.as_tensor(_rand(6, 13, 1.0))
    out, info = et.phi_with_info(A, 2)
    assert info.dtype == torch.int32 and int(info) == 0
    bad = A.clone()
    bad[0, 0] = float("nan")
    _, info = et.phi_with_info(bad, 2)
    assert int(info) == 1
    _, info = et.phi_with_info(bad, 2, method="taylor")
    assert int(info) == 1


def test_phiv_dense_differentiable():
    rng = np.random.default_rng(14)
    A, v = rng.standard_normal((10, 10)), rng.standard_normal(10)
    for method in ("higham2005", "taylor"):
        a = et.phiv_dense(torch.as_tensor(A), torch.as_tensor(v), 3,
                          expm_method=method)
        b = et.phiv_dense(torch.as_tensor(A), torch.as_tensor(v), 3,
                          expm_method=method, differentiable=True)
        jb = np.asarray(ej.phiv_dense(jnp.asarray(A), jnp.asarray(v), 3,
                                      expm_method=method,
                                      differentiable=True))
        assert_close(t2n(b), t2n(a), 1e-14, method)
        assert_close(t2n(b), jb, 1e-13, method)

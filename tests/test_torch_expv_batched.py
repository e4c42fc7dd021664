"""PyTorch port vs JAX package and scipy: ``expv_batched`` (models/expv.py)
on the CPU in float64. The port runs each row through ``expv`` with the
device reduced exponential; the JAX batched tests (tests/test_krylov.py)
use reduced="host", so the port is held to the JAX reduced="host" result
and to scipy's expm_multiply, at the JAX tests' tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from torch_parity import assert_close, t2n

torch.set_num_threads(2)


def _batch(n, nb, seed):
    return np.random.default_rng(seed).standard_normal((nb, n))


@pytest.mark.parametrize("two_pass", [False, True])
def test_hermitian_batch_vs_jax_host_and_scipy(two_pass):
    n = 64
    A = ej.laplacian_1d(n)
    At = et.laplacian_1d(n)
    B = _batch(n, 3, 1)
    t = 0.4
    W = t2n(et.expv_batched(t, At, torch.as_tensor(B), m=30,
                            two_pass=two_pass))
    Wj = np.asarray(ej.expv_batched(t, A, jnp.asarray(B), m=30,
                                    reduced="host", two_pass=two_pass))
    assert W.shape == (3, n)
    S = sp.csr_matrix(np.asarray(A.to_dense()))
    for i in range(3):
        assert_close(W[i], spla.expm_multiply(t * S, B[i]), 1e-10,
                     f"row {i} vs scipy")
    assert_close(W, Wj, 1e-12, "vs JAX reduced=host")


def test_nonhermitian_batch_and_rejects():
    n = 40
    A = np.asarray(ej.advection_diffusion_1d(n, peclet=5.0).to_dense())
    B = _batch(n, 2, 2)
    W = t2n(et.expv_batched(0.01, torch.as_tensor(A), torch.as_tensor(B),
                            m=n, hermitian=False))
    Wj = np.asarray(ej.expv_batched(0.01, jnp.asarray(A), jnp.asarray(B),
                                    m=n, hermitian=False, reduced="host"))
    assert_close(W, Wj, 1e-11, "vs JAX reduced=host")
    for i in range(2):
        assert_close(W[i], spla.expm_multiply(0.01 * A, B[i]), 1e-10,
                     f"row {i} vs scipy")
    # reduced="host" is ported: each row's reduced exponential on host
    # scipy, as JAX's batched host path
    Wh = t2n(et.expv_batched(0.01, torch.as_tensor(A), torch.as_tensor(B),
                             m=n, hermitian=False, reduced="host"))
    assert_close(Wh, Wj, 1e-12, "reduced=host vs JAX reduced=host")
    with pytest.raises(ValueError):
        et.expv_batched(0.01, torch.as_tensor(A), torch.as_tensor(B[0]))


@pytest.mark.parametrize("two_pass", [False, True])
def test_hermitian_batch_reduced_host_vs_jax(two_pass):
    n = 64
    B = _batch(n, 3, 3)
    W = t2n(et.expv_batched(0.4, et.laplacian_1d(n), torch.as_tensor(B),
                            m=30, two_pass=two_pass, reduced="host"))
    Wj = np.asarray(ej.expv_batched(0.4, ej.laplacian_1d(n), jnp.asarray(B),
                                    m=30, reduced="host", two_pass=two_pass))
    assert_close(W, Wj, 1e-12, "vs JAX reduced=host")


# complex rows, and real rows of a complex operator: the JAX package lands
# 0.64-0.97 away here, so scipy is the oracle

def _complex_hermitian(n, seed):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (H + H.conj().T) / 10


@pytest.mark.parametrize("case", ["complex rows", "complex rows two_pass",
                                  "real rows complex op",
                                  "real rows complex nonherm"])
def test_complex_batches_vs_scipy(case):
    import scipy.linalg as sla

    n = 40
    rng = np.random.default_rng(4)
    if case.startswith("complex rows"):
        A = np.asarray(ej.laplacian_1d(n).to_dense())
        B = _batch(n, 2, 5) + 1j * _batch(n, 2, 6)
        op = et.laplacian_1d(n)
        kw = dict(two_pass=case.endswith("two_pass"))
    elif case == "real rows complex op":
        A = _complex_hermitian(n, 7)
        B = _batch(n, 2, 8)
        op = et.DenseOperator(torch.as_tensor(A), is_hermitian=True)
        kw = {}
    else:
        A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) / 8
        B = _batch(n, 2, 9)
        op = et.DenseOperator(torch.as_tensor(A), is_hermitian=False)
        kw = {}
    W = t2n(et.expv_batched(0.4, op, torch.as_tensor(B), m=n, **kw))
    assert W.dtype == np.complex128
    E = sla.expm(0.4 * A)
    for i in range(2):
        assert_close(W[i], E @ B[i], 1e-10, f"{case} row {i}")


# one batched build: rows that break down at different steps, a zero row

def _breakdown_batch(n, seed):
    """(4, n) rows of the diagonal operator's problem: random, in
    invariant subspaces of dimension 3 and 6, and zeros."""
    B = _batch(n, 4, seed)
    B[1, 3:] = 0.0
    B[2, 6:] = 0.0
    B[3] = 0.0
    return B


@pytest.mark.parametrize("two_pass", [False, True])
def test_breakdown_rows_vs_jax_and_scipy(two_pass):
    """Rows whose Lanczos breaks down at steps 3 and 6 and a zero row,
    in one batched build: each row against scipy (1e-10) and the batch
    against JAX's batched call (reduced="host", 1e-12); the zero row is
    zero."""
    n = 48
    d = np.linspace(-4.0, 0.0, n)
    B = _breakdown_batch(n, 10)
    W = t2n(et.expv_batched(0.6, et.DiagonalOperator(torch.as_tensor(d)),
                            torch.as_tensor(B), m=20, two_pass=two_pass))
    Wj = np.asarray(ej.expv_batched(0.6, ej.DiagonalOperator(jnp.asarray(d)),
                                    jnp.asarray(B), m=20, reduced="host",
                                    two_pass=two_pass))
    assert_close(W, Wj, 1e-12, "vs JAX reduced=host")
    for i in range(4):
        assert_close(W[i], np.exp(0.6 * d) * B[i], 1e-10, f"row {i}")
    assert not W[3].any()


def test_iop_two_pass_batch_vs_jax_rows():
    """The batched IOP two-pass (window 2) on config #4's operator at n =
    200 against JAX's scalar IOP two-pass on each row (1e-12; JAX's
    batched call vmaps the same) and the batched Arnoldi basis path with
    iop=2, reorth=False, the same recurrence."""
    n = 200
    A = ej.advection_diffusion_1d(n, peclet=10.0)
    At = et.advection_diffusion_1d(n, peclet=10.0)
    B = _batch(n, 3, 11)
    B[1] = 0.0
    W = t2n(et.expv_batched(1e-4, At, torch.as_tensor(B), m=40,
                            two_pass=True, iop=2))
    for i in range(3):
        wj = np.asarray(ej.expv(1e-4, A, jnp.asarray(B[i]), m=40,
                                two_pass=True, iop=2, reduced="device"))
        assert_close(W[i], wj, 1e-12, f"row {i} vs JAX")
    Wb = t2n(et.expv_batched(1e-4, At, torch.as_tensor(B), m=40, iop=2,
                             reorth=False))
    assert_close(W, Wb, 1e-12, "vs the basis path")

"""PyTorch port vs JAX package: the Al-Mohy-Liu Pade phi functions
(ops/phi_almohy.py) on the CPU in float64. The parameter selection runs on
the device in both packages with the same arithmetic and tie-break: on
every fixture the port chooses the same (branch, s) as JAX, as the adaptive
drivers' stats are held equal to JAX's. Results: 1e-13 against JAX, 1e-12 against
the block oracle of tests/test_phi.py (the JAX tests' tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops import phi_almohy as ja
from exponentialutilities_jl_torch.ops import phi_almohy as ta
from test_phi import phi_block_oracle
from torch_parity import assert_close, t2n

torch.set_num_threads(2)

FIXTURES = [(8, 1, 0.1), (12, 3, 1.0), (20, 2, 10.0), (16, 4, 100.0),
            (10, 7, 3.0), (6, 9, 0.5), (24, 1, 1e-4)]


def _A(n, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, n)) * scale
            / np.sqrt(n))


def test_coefficients_and_tables_equal_jax():
    for m in ta._PHI_DEGREES:
        for p in (1, 3, 8):
            assert ta._pade_coeffs(m, p) == ja._pade_coeffs(m, p)
    assert ta._PHI_DEGREES == ja._PHI_DEGREES
    np.testing.assert_array_equal(ta._PHI_THETA_MP, ja._PHI_THETA_MP)


@pytest.mark.parametrize("n,k,scale", FIXTURES)
def test_same_parameters_and_result_as_jax(n, k, scale):
    A = _A(n, scale)
    ij, sj, _ = ja._select_parameters(jnp.asarray(A), k, 64)
    it, st = ta._select_parameters(torch.as_tensor(A), k, 64)
    assert (int(it), int(st)) == (int(ij), int(sj))
    tw = t2n(et.phi_pade(torch.as_tensor(A), k))
    jw = np.asarray(ej.phi_pade(jnp.asarray(A), k))
    assert_close(tw, jw, 1e-13, "vs JAX")
    if n <= 12:
        want = phi_block_oracle(A, k)
        for j in range(k + 1):
            assert_close(tw[j], want[j], 1e-12, f"phi_{j} vs oracle")


@pytest.mark.parametrize("solve", ["device", "newton"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_solve_engines_and_differentiable(solve, differentiable):
    """tests/test_phi.py parametrizes solve="newton"; both engines and the
    no-host-read form agree with JAX."""
    A = _A(14, 20.0, seed=1)
    tw = t2n(et.phi_pade(torch.as_tensor(A), 3, solve=solve,
                         differentiable=differentiable))
    jw = np.asarray(ej.phi_pade(jnp.asarray(A), 3, solve=solve))
    assert_close(tw, jw, 1e-12, f"{solve} vs JAX")


def test_with_info_and_contract():
    A = torch.as_tensor(_A(6, 1.0))
    out, info = et.phi_pade_with_info(A, 2)
    assert int(info) == 0 and out.shape == (3, 6, 6)
    bad = A.clone()
    bad[1, 2] = float("inf")
    _, info = et.phi_pade_with_info(bad, 2)
    assert int(info) == 1
    with pytest.raises(ValueError):
        et.phi_pade(A, 0)
    with pytest.raises(ValueError):
        et.phi_pade(A, 2, solve="lu")

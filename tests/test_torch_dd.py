"""PyTorch port vs exact oracles: the double-double tier (ops/expm_dd.py,
ops/phi_dd.py) against the exact rational oracles of tests/test_expm_dd.py
and tests/test_phi_dd.py, and the host mpmath exponential (ops/expm_mp.py)
against the JAX package's copy and mpmath, at the sizes
tests/test_expm_mp.py uses."""

import math
from fractions import Fraction

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops import expm_dd as tdd
from test_expm_dd import _exact_expm
from torch_parity import t2n

torch.set_num_threads(2)
mpmath = pytest.importorskip("mpmath")


def _value(hi, lo):
    return Fraction(float(hi)) + Fraction(float(lo))


def _exact_err(X, exact, n):
    """max |DD - exact| / max |exact| over an n x n result."""
    got = [[_value(X.hi[i, j], X.lo[i, j]) for j in range(n)]
           for i in range(n)]
    scale = max(abs(float(e)) for row in exact for e in row)
    return max(abs(float(got[i][j] - exact[i][j]))
               for i in range(n) for j in range(n)) / scale


def test_primitives_exact():
    a, b = tdd.dd_from_f64(1.0), tdd.dd_from_f64(1e-20)
    s = tdd.dd_add(a, b)
    assert float(s.hi) == 1.0 and float(s.lo) == 1e-20
    x = tdd.dd_from_f64(1.0 + 2.0 ** -30)
    y = tdd.dd_from_f64(1.0 - 2.0 ** -30)
    p = tdd.dd_mul(x, y)
    assert _value(p.hi, p.lo) == (1 + Fraction(2) ** -30) * (
        1 - Fraction(2) ** -30)
    q = tdd.dd_div_int(tdd.dd_from_f64(1.0), 3)
    assert abs(_value(q.hi, q.lo) - Fraction(1, 3)) < Fraction(1, 2 ** 104)


@pytest.mark.parametrize("n,chunk", [(8, None), (13, 40)])
def test_matmul_compensated(monkeypatch, n, chunk):
    """Broadcast chunks and the pairwise sum: 2^-100 of the scale against
    the exact product (several chunks, an odd axis, when ``chunk`` cuts
    the inner dimension)."""
    if chunk:
        monkeypatch.setattr(tdd, "_CHUNK_ELEMS", n * n * 5)
    rng = np.random.default_rng(5)
    A, B = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    C = tdd.dd_matmul(tdd.dd_from_f64(A), tdd.dd_from_f64(B))
    Af = [[Fraction(float(a)) for a in row] for row in A]
    Bf = [[Fraction(float(b)) for b in row] for row in B]
    exact = [[sum(Af[i][k] * Bf[k][j] for k in range(n)) for j in range(n)]
             for i in range(n)]
    got = [[_value(C.hi[i, j], C.lo[i, j]) for j in range(n)]
           for i in range(n)]
    scale = max(abs(e) for row in exact for e in row)
    assert max(abs(got[i][j] - exact[i][j]) for i in range(n)
               for j in range(n)) < Fraction(1, 2 ** 100) * scale


def test_expm_dd_vs_exact_rational():
    """tests/test_expm_dd.py's oracle: below 1e-29 of the scale, and the
    high word agrees with JAX's to float64 rounding."""
    rng = np.random.default_rng(7)
    n = 6
    K = rng.integers(-64, 65, size=(n, n))
    A = K / 64.0
    Af = [[Fraction(int(K[i, j]), 64) for j in range(n)] for i in range(n)]
    X = et.expm_dd(torch.as_tensor(A))
    assert _exact_err(X, _exact_expm(Af, s=6, terms=45), n) < 1e-29
    Xj = ej.expm_dd(A)
    np.testing.assert_allclose(t2n(X.hi), np.asarray(Xj.hi), rtol=0,
                               atol=2e-16 * np.abs(t2n(X.hi)).max())


def test_expm_dd_large_norm_vs_jax_dd():
    """|A| ~ 40 (the automatic squaring count): the DD values of both
    packages agree below 1e-26 of the scale, the bound the JAX test holds
    its own result to against the exact oracle."""
    rng = np.random.default_rng(11)
    n = 4
    A = rng.integers(-64, 65, size=(n, n)) / 2.0
    X = et.expm_dd(torch.as_tensor(A))
    Xj = ej.expm_dd(A)
    exact = [[_value(Xj.hi[i, j], Xj.lo[i, j]) for j in range(n)]
             for i in range(n)]
    assert _exact_err(X, exact, n) < 1e-26


def _exact_phi(Af, k):
    """[phi_0..phi_k] of a small Fraction matrix from the exact block
    exponential of the augmented matrix (tests/test_phi_dd.py's oracle)."""
    n = len(Af)
    N = n * (k + 1)
    Big = [[Fraction(0)] * N for _ in range(N)]
    for i in range(n):
        for j in range(n):
            Big[i][j] = Af[i][j]
        Big[i][n + i] = Fraction(1)
    for b in range(1, k):
        for i in range(n):
            Big[b * n + i][(b + 1) * n + i] = Fraction(1)
    P = _exact_expm(Big, s=6, terms=50)
    return [[row[:n] for row in P[:n]]] + [
        [row[j * n:(j + 1) * n] for row in P[:n]] for j in range(1, k + 1)]


def test_phi_dd_phiv_dense_dd_expv_dd():
    rng = np.random.default_rng(3)
    n, k = 4, 2
    K = rng.integers(-32, 33, size=(n, n))
    A = K / 32.0
    Af = [[Fraction(int(K[i, j]), 32) for j in range(n)] for i in range(n)]
    exact = _exact_phi(Af, k)
    F = et.phi_dd(torch.as_tensor(A), k)
    for j in range(k + 1):
        assert _exact_err(F[j], exact[j], n) < 1e-25
    v = np.array([1.0, -0.5, 0.25, 2.0])
    W = et.phiv_dense_dd(torch.as_tensor(A), torch.as_tensor(v), k)
    for j in range(k + 1):
        want = [sum(exact[j][i][c] * Fraction(float(v[c])) for c in range(n))
                for i in range(n)]
        err = max(abs(float(_value(W.hi[i, j], W.lo[i, j]) - want[i]))
                  for i in range(n))
        assert err / max(abs(float(w)) for w in want) < 1e-25
    w = et.expv_dd(0.5, torch.as_tensor(A), torch.as_tensor(v))
    want = sla.expm(0.5 * A) @ v
    np.testing.assert_allclose(t2n(w.hi), want, rtol=1e-14)


def test_expm_mp_vs_jax_copy_and_mpmath():
    from mpmath import matrix, mp, workprec
    rng = np.random.default_rng(12345)
    A = rng.standard_normal((6, 6)) / 3
    X = et.expm_mp(torch.as_tensor(A), prec_bits=300)
    Xj = ej.expm_mp(A, prec_bits=300)
    with workprec(320):
        ref = mpmath.expm(matrix([[mp.mpf(v) for v in row]
                                  for row in A.tolist()]))
        assert all(X[i, j] == Xj[i, j] for i in range(6) for j in range(6))
        num = max(abs(X[i, j] - ref[i, j]) for i in range(6)
                  for j in range(6))
        den = max(abs(ref[i, j]) for i in range(6) for j in range(6))
        assert num / den < 100 * mp.mpf(2) ** (-300)
    with pytest.raises(ValueError):
        et.expm_mp(np.ones((2, 3)))
    with workprec(60):
        k60 = et.ops.expm_mp.pade_order_for_eps_mp(mp.eps)
    with workprec(300):
        k300 = et.ops.expm_mp.pade_order_for_eps_mp(mp.eps)
    assert k60 < k300 and math.isfinite(k300)


def test_dd_result_lies_on_input_device():
    X = et.expm_dd(torch.eye(3, dtype=torch.float64))
    assert X.hi.device == X.lo.device == torch.device("cpu")
    assert isinstance(X, et.DD)
    np.testing.assert_allclose(t2n(X.hi), np.e * np.eye(3), rtol=1e-16)

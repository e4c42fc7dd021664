"""Hard inputs for R1, the Hermitian reduced exponential s Q exp(t Lambda)
Q^T e1 of a real symmetric tridiagonal (``ops/kernels/tridiag.py``): the
tridiagonals that a divide-and-conquer eigensolver gets wrong first. numpy
only, so that the CPU model test (``test_torch_tridiag_dc.py``), the card's
tests (``test_torch_cuda.py``) and ``chip_smoke.py`` share them.

Each case is (name, alphas (m,), betas (m - 1,), t). Its tolerance is
R1_TOL x max(1, |t| ||T||_1) of the largest entry (``case_tol``): the
conditioning of exp(tT) e1."""

import numpy as np

R1_TOL = {"float32": 1e-5, "float64": 1e-13}


def wilkinson(m):
    """W+_m: d_i = |i - (m - 1) / 2|, e_i = 1 (its largest eigenvalues come
    in pairs that agree to many digits)."""
    return np.abs(np.arange(m) - (m - 1) / 2.0), np.ones(m - 1)


def glued_wilkinson(blocks, m, glue):
    """``blocks`` copies of W+_m joined by off-diagonal ``glue``."""
    d0, e0 = wilkinson(m)
    d = np.tile(d0, blocks)
    e = np.concatenate([np.concatenate([e0, [glue]])] * blocks)[:-1]
    return d, e


def graded(m, lo=-12.0, hi=2.0):
    """Diagonal 10^lo .. 10^hi, couplings half the geometric mean of their
    neighbours."""
    d = np.logspace(lo, hi, m)
    return d, 0.5 * np.sqrt(d[:-1] * d[1:])


def constant(m, a=-2.0, b=1.0):
    """Toeplitz tridiagonal: eigenvalues a + 2 b cos(k pi / (m + 1))."""
    return np.full(m, a), np.full(m - 1, b)


def lanczos_laplacian(m, n, seed):
    """The Lanczos tridiagonal of the 1-D Laplacian of order n after m > n
    steps with no reorthogonalisation (copies of converged Ritz values:
    ghost eigenvalues), from a seeded start vector."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    vp = np.zeros(n)
    beta = 0.0
    a, b = np.empty(m), np.empty(m - 1)
    for j in range(m):
        w = 2.0 * v
        w[1:] -= v[:-1]
        w[:-1] -= v[1:]
        w -= beta * vp
        a[j] = v @ w
        w -= a[j] * v
        if j == m - 1:
            break
        beta = np.linalg.norm(w)
        b[j] = beta
        vp, v = v, w / beta
    return a, b


def random_tridiagonal(m, seed, tail=0):
    """The random tridiagonal of the R1 tests (norm ~4), its last ``tail``
    rows masked to zero."""
    g = np.random.default_rng(seed)
    a = -np.abs(g.standard_normal(m)) * 2
    b = np.abs(g.standard_normal(max(m - 1, 0)))
    if tail:
        a[m - tail:] = 0.0
        b[m - tail - 1:] = 0.0
    return a, b


def masked(a, b, j):
    """The error-estimate loop's masked tridiagonal at step j: entries of
    the leading (j + 1) block kept, the rest zero."""
    idx = np.arange(len(a))
    return np.where(idx <= j, a, 0.0), np.where(idx[:-1] < j, b, 0.0)


def hard_cases():
    """The hard inputs, float64 numpy: [(name, alphas, betas, t)]."""
    cases = [("wilkinson21", *wilkinson(21), 0.7),
             ("wilkinson201", *wilkinson(201), -0.05),
             ("glued wilkinson 5x21 1e-8", *glued_wilkinson(5, 21, 1e-8), 0.3),
             ("glued wilkinson 3x21 1e-14",
              *glued_wilkinson(3, 21, 1e-14), -0.2 + 0.5j),
             ("graded 1e-12..1e2", *graded(60), -0.3),
             ("constant 100", *constant(100), 1.1),
             ("lanczos laplacian ghosts 250",
              *lanczos_laplacian(250, 120, 5), -2.0)]
    lap = constant(100, 2.0, -1.0)
    cases.append(("laplacian t|T| = 1e3", *lap, -250.0))
    cases.append(("graded t|T| = 1e3", *graded(40, -12.0, 1.0), -100.0))
    cases.append(("random t|T| = 1e3 complex",
                  *random_tridiagonal(80, 3), 0.1 - 120.0j))
    a, b = random_tridiagonal(60, 9)
    for j in (0, 1, 5, 30, 58):
        cases.append((f"masked tail j = {j}", *masked(a, b, j), 0.8))
    return cases


def dense(a, b):
    return np.diag(a) + np.diag(b, 1) + np.diag(b, -1)


def case_tol(a, b, t, dtype="float64"):
    """R1_TOL x max(1, |t| ||T||_1): the tolerance of a hard case, relative
    to the largest entry of the result."""
    return R1_TOL[dtype] * max(1.0, abs(t) * np.abs(dense(a, b)).sum(0).max())

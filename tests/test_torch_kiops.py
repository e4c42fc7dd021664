"""PyTorch port vs JAX package: KIOPS (models/kiops.py) and its device-loop
twin (models/kiops_device.py), float64 on CPU with the same seeded numpy
inputs through both packages.

The stats (steps, rejections, Krylov steps, exponentials, last m) are
held equal to JAX's and the results to 1e-10 relative (norm-scaled);
scipy's block-matrix exponential is the independent oracle at the JAX
tests' limits. The augmented operator is held to its dense matrix, and
the failure protocol to its documented contract."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from torch_parity import assert_close, t2n

torch.set_num_threads(2)

RTOL = 1e-10


def laplacian_1d(n):
    return (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
            + np.diag(np.ones(n - 1), -1))


def oracle(ts, A, U):
    """sum_j t^j phi_j(tA) u_j, each t^j phi_j(tA) u_j from the augmented
    exponential [[tA, t^j u_j, 0], [0, 0, I_{j-1}], [0, 0, 0]] (Sidje)."""
    n, ppo = U.shape
    out = []
    for t in ts:
        w = sla.expm(t * A) @ U[:, 0]
        for j in range(1, ppo):
            M = np.zeros((n + j, n + j), dtype=np.result_type(A, U))
            M[:n, :n] = t * A
            M[:n, n] = t ** j * U[:, j]
            M[n:n + j - 1, n + 1:n + j] = np.eye(j - 1)
            w = w + sla.expm(M)[:n, n + j - 1]
        out.append(w)
    return np.stack(out, axis=1)


def _same_stats(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _stiff(n):
    return laplacian_1d(n) * (n / 10.0) ** 2 + np.diag(np.ones(n - 1), 1) * n / 20.0


CASES = {
    "laplacian p=3": (laplacian_1d(60), 3, [1.0], dict(tol=1e-10)),
    "snapshots": (laplacian_1d(40) * 0.5, 1, [0.3, 0.5, 1.0],
                  dict(tol=1e-9)),
    "expv p=0 scalar": (laplacian_1d(50), 0, 2.0, dict(tol=1e-10)),
    "stiff (basis resumed)": (_stiff(64), 0, [0.1], dict(tol=1e-8)),
    "task1": (np.random.default_rng(7).standard_normal((40, 40)) / 10, 1,
              [2.0], dict(task1=True)),
    "two_pass snapshots": (_stiff(64), 2, [0.05, 0.1],
                           dict(tol=1e-8, two_pass=True)),
    "negative time": (laplacian_1d(40), 2, [-0.3, -0.8], dict(tol=1e-9)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kiops_vs_jax(name):
    A, p, ts, kw = CASES[name]
    U = np.random.default_rng(12345).standard_normal((A.shape[0], p + 1))
    u = U[:, 0] if p == 0 else U
    jw, js = ej.kiops(ts, jnp.asarray(A), jnp.asarray(u), **kw)
    tw, ts_ = et.kiops(ts, torch.as_tensor(A), torch.as_tensor(u), **kw)
    _same_stats(ts_, js)
    assert_close(t2n(tw), np.asarray(jw), RTOL, name)
    if not kw.get("task1"):
        want = oracle(np.atleast_1d(ts), A, U)
        assert_close(t2n(tw).reshape(want.shape), want, 1e-6, "oracle")


DEVICE_CASES = {
    "laplacian": (laplacian_1d(100), 2, [1.0], dict(tol=1e-8)),
    "snapshots and task1": (laplacian_1d(80) + 0.5 * (
        np.diag(np.ones(79), 1) - np.diag(np.ones(79), -1)), 2, [0.4, 1.0],
        dict(tol=1e-8, task1=True)),
    "taylor engine": (_stiff(64), 1, [0.05, 0.1],
                      dict(tol=1e-8, expm_method="taylor")),
}


@pytest.mark.parametrize("name", list(DEVICE_CASES))
def test_kiops_device_vs_jax(name):
    A, p, ts, kw = DEVICE_CASES[name]
    U = np.random.default_rng(12345).standard_normal((A.shape[0], p + 1))
    jw, js = ej.kiops_device(ts, A, U, **kw)
    tw, ts_ = et.kiops_device(ts, torch.as_tensor(A), torch.as_tensor(U),
                              **kw)
    _same_stats(ts_, js)
    assert ts_.info == 0
    assert_close(t2n(tw), np.asarray(jw), RTOL, name)


def test_kiops_device_taylor_vs_higham2005():
    A = _stiff(64)
    U = torch.as_tensor(np.random.default_rng(3).standard_normal((64, 2)))
    w1, _ = et.kiops_device([0.05, 0.1], torch.as_tensor(A), U, tol=1e-8)
    w2, _ = et.kiops_device([0.05, 0.1], torch.as_tensor(A), U, tol=1e-8,
                            expm_method="taylor")
    assert_close(t2n(w2), t2n(w1), 1e-12, "taylor vs higham2005")


def test_augmented_operator_vs_dense():
    rng = np.random.default_rng(4)
    n, p = 30, 3
    A = rng.standard_normal((n, n))
    Bm = rng.standard_normal((n, p))
    aug = et.AugmentedOperator(et.DenseOperator(torch.as_tensor(A)),
                               torch.as_tensor(Bm))
    M = np.zeros((n + p, n + p))
    M[:n, :n], M[:n, n:] = A, Bm
    M[n:n + p - 1, n + 1:] = np.eye(p - 1)
    x = rng.standard_normal(n + p)
    assert aug.shape == (n + p, n + p)
    assert_close(t2n(aug.matvec(torch.as_tensor(x))), M @ x, 1e-14, "matvec")
    # a complex vector on the real banded container takes the plain path
    band = et.advection_diffusion_1d(n, device="cpu")
    augb = et.AugmentedOperator(band, torch.as_tensor(Bm + 0j))
    xc = x + 1j * rng.standard_normal(n + p)
    M[:n, :n] = t2n(band.to_dense())
    assert_close(t2n(augb.matvec(torch.as_tensor(xc))), M @ xc, 1e-14,
                 "complex")


def test_kiops_complex_u_on_real_banded():
    n, t = 60, 1e-3
    op = et.advection_diffusion_1d(n, device="cpu")
    rng = np.random.default_rng(5)
    U = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    w, s = et.kiops([t], op, torch.as_tensor(U), tol=1e-10)
    assert w.dtype == torch.complex128 and s.info == 0
    want = oracle([t], t2n(op.to_dense()), U)
    assert_close(t2n(w), want, 1e-8, "complex u vs oracle")


def _poisoned(n, j0):
    M = torch.as_tensor(laplacian_1d(n))

    def mv(v):
        bad = torch.where(v[j0].abs() > 0, torch.nan, 0.0)
        out = M @ v
        return torch.cat([out[:1] + bad, out[1:]])

    return et.MatrixFreeOperator(mv, (n, n), dtype=torch.float64,
                                 opnorm=4.0, device="cpu")


@pytest.mark.parametrize("driver", ["kiops", "kiops_device"])
def test_failure_protocol(driver):
    """A NaN matvec mid-build ends with info = 2 and NaN outputs, no
    raise, no endless loop."""
    n = 16 if driver == "kiops" else 100
    op = _poisoned(n, n // 2 if driver == "kiops" else 3)
    b = np.zeros((n, 1))
    b[0, 0] = 1.0
    fn = et.kiops if driver == "kiops" else et.kiops_device
    w, stats = fn([1.0], op, b, tol=1e-8)
    assert stats.info == 2
    assert not torch.isfinite(w).all()


def test_kiops_not_ported():
    """reduced="host" is ported: the trials' augmented exponentials and
    the phantoms' on host scipy, against JAX's reduced="host" (the same
    steps) and the port's device form."""
    A = laplacian_1d(40)
    u = np.random.default_rng(11).standard_normal((40, 3))
    for two_pass in (False, True):
        w, st = et.kiops([0.3, 1.0], torch.as_tensor(A), torch.as_tensor(u),
                         reduced="host", two_pass=two_pass)
        wd, sd = et.kiops([0.3, 1.0], torch.as_tensor(A), torch.as_tensor(u),
                          two_pass=two_pass)
        assert (st.steps, st.krylov_steps) == (sd.steps, sd.krylov_steps)
        assert_close(t2n(w), t2n(wd), 1e-12, f"two_pass={two_pass} device")
    wj, sj = ej.kiops([0.3, 1.0], jnp.asarray(A), jnp.asarray(u),
                      reduced="host")
    w, st = et.kiops([0.3, 1.0], torch.as_tensor(A), torch.as_tensor(u),
                     reduced="host")
    assert (st.steps, st.rejections) == (int(sj.steps), int(sj.rejections))
    assert_close(t2n(w), np.asarray(wj), 1e-12, "vs JAX reduced=host")


def test_config4_kiops_device_vs_jax_and_oracle():
    """BASELINE config #4 at its size through kiops_device, as
    run_baseline.py calls it: JAX's stats, and within 1e-10 of the
    augmented-matrix oracle."""
    n, t = 2000, 1e-4
    top = et.advection_diffusion_1d(n, peclet=10.0, device="cpu")
    jop = ej.advection_diffusion_1d(n, peclet=10.0, dtype=jnp.float64)
    b = np.random.default_rng(0).standard_normal(n)
    B = np.stack([b, 0.1 * b], axis=1)
    jw, js = ej.kiops_device([t], jop, jnp.asarray(B), tol=1e-7)
    tw, ts_ = et.kiops_device([t], top, torch.as_tensor(B), tol=1e-7)
    _same_stats(ts_, js)
    assert (ts_.steps, ts_.rejections, ts_.krylov_steps, ts_.exps,
            ts_.last_m) == (2, 8, 808, 10, 128)
    Ad = t2n(top.to_dense())
    aug = np.zeros((n + 1, n + 1))
    aug[:n, :n] = t * Ad
    aug[:n, n] = t * 0.1 * b
    F = sla.expm(aug)
    want = F[:n, :n] @ b + F[:n, n]
    err = np.linalg.norm(t2n(tw[:, 0]) - want) / np.linalg.norm(want)
    assert err < RTOL, err


def test_augmented_operator_is_hermitian_keyword():
    """The JAX dataclass field ``is_hermitian`` (False by default) is a
    keyword of the port's constructor too."""
    A = et.DenseOperator(torch.as_tensor(laplacian_1d(8)))
    B = torch.ones((8, 2), dtype=torch.float64)
    assert et.AugmentedOperator(A, B).is_hermitian is False
    aug = et.AugmentedOperator(A, B, is_hermitian=False)
    assert aug.is_hermitian is False and aug.shape == (10, 10)
    assert et.AugmentedOperator(A, B, is_hermitian=True).is_hermitian is True
    assert ej.AugmentedOperator(ej.DenseOperator(jnp.asarray(t2n(A.A))),
                                jnp.asarray(t2n(B)),
                                is_hermitian=False).is_hermitian is False


# kiops_device with a complex U: the JAX package lands 2.9e-4 to 2.4e-2
# away on these dense kinds, so the oracle is scipy

@pytest.mark.parametrize("kind", ["real", "complex", "complex hermitian"])
def test_kiops_device_complex_u_vs_oracle(kind):
    n = 40
    rng = np.random.default_rng(13)
    A = rng.standard_normal((n, n)) / 8
    if kind != "real":
        A = A + 1j * rng.standard_normal((n, n)) / 8
    if kind == "complex hermitian":
        A = (A + A.conj().T) / 2
    U = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    op = et.DenseOperator(torch.as_tensor(A),
                          is_hermitian=kind == "complex hermitian")
    w, s = et.kiops_device([0.5, 1.0], op, torch.as_tensor(U), tol=1e-12)
    assert w.dtype == torch.complex128 and s.info == 0
    assert_close(t2n(w), oracle([0.5, 1.0], A, U), 1e-10, kind)

"""PyTorch port vs JAX package: the exponential integrators
(models/integrators.py) and ``JacobianOperator``, float64 on CPU with the
same seeded numpy inputs through both packages.

On the Allen-Cahn problem of tests/test_integrators.py (nx = 96) each
integrator takes JAX's steps and rejections (its ``ExpIntStats`` equal),
ends within 1e-10 of JAX's final state (relative 2-norm), and is no
further from the scipy Radau reference than JAX is (within 1e-12 of
JAX's error). ``JacobianOperator`` is held to J v = A v for a linear f
over every sparse container's matvec (their CPU twins, and the kernel
path's forward-mode rule through a stand-in kernel), and the failure
protocol raises in both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.models import integrators as ti
from exponentialutilities_jl_torch.ops import sparse as tsparse
from torch_parity import t2n

torch.set_num_threads(2)

RTOL = 1e-10
NX = 96


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _lap(nx, nu):
    dx = 1.0 / (nx + 1)
    return (np.diag(-2.0 * np.ones(nx)) + np.diag(np.ones(nx - 1), 1)
            + np.diag(np.ones(nx - 1), -1)) / dx ** 2 * nu


def _problem(nx=NX, nu=0.01):
    """u' = nu Lap u + u - u^3 (tests/test_integrators.py's Allen-Cahn),
    as a JAX f, a torch f and u0."""
    D = _lap(nx, nu)
    Dj, Dt = jnp.asarray(D), torch.as_tensor(D)
    u0 = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1)) * 0.5
    return (lambda u: Dj @ u + u - u ** 3), (lambda u: Dt @ u + u - u ** 3), u0


def _stencils(nx=NX):
    dx = 1.0 / (nx + 1)
    cs = np.asarray([1.0, -2.0, 1.0]) / dx ** 2 * 0.01
    offs = ((-1,), (0,), (1,))
    return (ej.StencilOperator((nx,), offs, jnp.asarray(cs), is_hermitian=True),
            et.StencilOperator((nx,), offs, cs, is_hermitian=True))


def _nonlin(u):
    return u - u ** 3


@pytest.fixture(scope="module")
def radau():
    """scipy Radau reference of the nx = 96 problem at t = 1.5."""
    from scipy.integrate import solve_ivp

    D = _lap(NX, 0.01)
    _, _, u0 = _problem()
    sol = solve_ivp(lambda t, u: D @ u + u - u ** 3, (0.0, 1.5), u0,
                    method="Radau", rtol=1e-11, atol=1e-13,
                    jac=lambda t, u: D + np.diag(1.0 - 3.0 * u ** 2))
    return sol.y[:, -1]


def _same_stats(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _hold(ut, uj, ref=None):
    """1e-10 of JAX's state; no further from the reference than JAX."""
    ut = t2n(ut)
    assert _rel(ut, uj) <= RTOL
    if ref is not None:
        assert _rel(ut, ref) <= _rel(uj, ref) + 1e-12


@pytest.mark.parametrize("name,kw", [
    ("exprb32", dict(rtol=1e-7, atol=1e-9)),
    ("exprb43", dict(rtol=1e-9, atol=1e-11)),
])
def test_rosenbrock_vs_jax(radau, name, kw):
    fj, ft, u0 = _problem()
    uj, sj = getattr(ej, name)(fj, u0, (0.0, 1.5), **kw)
    ut, st = getattr(et, name)(ft, u0, (0.0, 1.5), device="cpu", **kw)
    _same_stats(st, sj)
    assert st.steps > 10 and st.rejected >= 1
    _hold(ut, np.asarray(uj), radau)


def test_fixed_steps_controller_i_and_dense_jacobian():
    fj, ft, u0 = _problem()
    uj, sj = ej.exprb43(fj, u0, (0.0, 1.5), dt0=0.25, adaptive=False)
    ut, st = et.exprb43(ft, u0, (0.0, 1.5), dt0=0.25, adaptive=False)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj))
    fj, ft, u0 = _problem(nx=48)
    D = _lap(48, 0.01)
    jj = lambda u: jnp.asarray(D) + jnp.diag(1.0 - 3.0 * u ** 2)
    jt = lambda u: torch.as_tensor(D) + torch.diag(1.0 - 3.0 * u ** 2)
    kw = dict(rtol=1e-6, atol=1e-8, controller="i")
    uj, sj = ej.exprb32(fj, u0, (0.0, 0.2), jac=jj, **kw)
    ut, st = et.exprb32(ft, u0, (0.0, 0.2), jac=jt, **kw)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj))


def test_trajectory_and_vector_atol():
    fj, ft, u0 = _problem(nx=32)
    atol = np.linspace(1e-9, 1e-8, 32)
    tj, Uj, sj = ej.exprb32(fj, u0, (0.0, 0.3), rtol=1e-6,
                            atol=jnp.asarray(atol), return_trajectory=True)
    tt, Ut, st = et.exprb32(ft, u0, (0.0, 0.3), rtol=1e-6, atol=atol,
                            return_trajectory=True)
    _same_stats(st, sj)
    # step sizes follow the error norms, which agree to ~1e-10
    np.testing.assert_allclose(tt, tj, rtol=1e-9)
    assert Ut.shape == Uj.shape and np.array_equal(t2n(Ut[0]), u0)
    _hold(Ut, np.asarray(Uj))


def test_etdrk4_vs_jax(radau):
    opj, opt = _stencils()
    _, _, u0 = _problem()
    uj, sj = ej.etdrk4(opj, _nonlin, u0, (0.0, 1.5), 0.15)
    ut, st = et.etdrk4(opt, _nonlin, u0, (0.0, 1.5), 0.15)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj), radau)


def test_etdrk4_device_vs_jax(radau):
    opj, opt = _stencils()
    _, _, u0 = _problem()
    uj = ej.etdrk4_device(opj, _nonlin, u0, (0.0, 1.5), 0.15, m=24)
    ut = et.etdrk4_device(opt, _nonlin, u0, (0.0, 1.5), 0.15, m=24)
    _hold(ut, np.asarray(uj), radau)


def test_exprb43_device_fixed_vs_jax(radau):
    fj, ft, u0 = _problem()
    uj, sj = ej.exprb43_device(fj, u0, (0.0, 1.5), 0.25, m=30,
                               return_stats=True)
    ut, st = et.exprb43_device(ft, u0, (0.0, 1.5), 0.25, m=30,
                               return_stats=True)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj), radau)


def test_exprb_device_adaptive_vs_jax():
    fj, ft, u0 = _problem()
    kw = dict(rtol=1e-7, atol=1e-9, return_stats=True)
    uj, sj = ej.exprb43_device(fj, u0, (0.0, 0.5), m=30, **kw)
    ut, st = et.exprb43_device(ft, u0, (0.0, 0.5), m=30, **kw)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj))
    snaps = (0.1, 0.25, 0.5)
    Uj, sj = ej.exprb32_device(fj, u0, (0.0, 0.5), m=25, snapshots=snaps,
                               controller="i", **kw)
    Ut, st = et.exprb32_device(ft, u0, (0.0, 0.5), m=25, snapshots=snaps,
                               controller="i", **kw)
    _same_stats(st, sj)
    assert Ut.shape == (NX, 3)
    _hold(Ut, np.asarray(Uj))


def test_exprb32_device_fixed_snapshots_vs_jax():
    fj, ft, u0 = _problem(nx=48)
    snaps = (0.35, 0.7)
    Uj = ej.exprb32_device(fj, u0, (0.0, 0.7), 0.15, adaptive=False, m=20,
                           snapshots=snaps)
    Ut = et.exprb32_device(ft, u0, (0.0, 0.7), 0.15, adaptive=False, m=20,
                           snapshots=snaps)
    _hold(Ut, np.asarray(Uj))


def test_m_bucket_growth_vs_jax():
    """A stiff diffusion (|J| ~ 5.9e4): the phi estimate at m = 6 breaches
    phi_tol, the loop leaves with want_m and re-enters at larger
    buckets; the same buckets and steps as JAX's."""
    nx = 120
    D = _lap(nx, 1.0)
    Dj, Dt = jnp.asarray(D), torch.as_tensor(D)
    u0 = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1)) * 0.5
    kw = dict(rtol=1e-8, atol=1e-10, m=6, return_stats=True)
    uj, sj = ej.exprb43_device(lambda u: Dj @ u + u - u ** 3, u0, (0.0, 0.02),
                               **kw)
    ut, st = et.exprb43_device(lambda u: Dt @ u + u - u ** 3, u0, (0.0, 0.02),
                               **kw)
    _same_stats(st, sj)
    assert st.final_m > 6
    _hold(ut, np.asarray(uj))


def test_next_bucket_equal():
    from exponentialutilities_jl_tpu.models import integrators as ji

    assert ti._EXPRB_M_LADDER == ji._EXPRB_M_LADDER
    for m in (3, 6, 7, 50, 127, 128, 200):
        for m_max in (30, 128):
            assert ti._next_bucket(m, m_max) == ji._next_bucket(m, m_max)


def test_pow2_exact():
    for rdt in (torch.float32, torch.float64):
        e = torch.tensor([-30.0, -1.0, 0.0, 1.0, 7.0, 60.0], dtype=rdt)
        want = torch.tensor([2.0 ** v for v in e.tolist()], dtype=rdt)
        assert torch.equal(ti._pow2(e, rdt), want)


def test_wrms_atol_zero_with_zero_component():
    f = lambda u: -u
    u0 = np.array([1.0, 0.0, 2.0])
    uj, sj = ej.exprb32(f, u0, (0.0, 1.0), rtol=1e-6, atol=0.0)
    ut, st = et.exprb32(f, u0, (0.0, 1.0), rtol=1e-6, atol=0.0)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj))
    uj = ej.exprb32_device(f, u0, (0.0, 1.0), rtol=1e-6, atol=0.0, m=3)
    ut = et.exprb32_device(f, u0, (0.0, 1.0), rtol=1e-6, atol=0.0, m=3)
    _hold(ut, np.asarray(uj))


# --- JacobianOperator

def test_jacobian_operator_vs_jax():
    rng = np.random.default_rng(12345)
    n = 30
    A = rng.standard_normal((n, n))
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Jj = ej.JacobianOperator(lambda x: Aj @ x + x ** 2, jnp.asarray(u))
    Jt = et.JacobianOperator(lambda x: At @ x + x ** 2, u)
    assert Jt.shape == (n, n) and Jt.dtype == torch.float64
    got = t2n(Jt.matvec(torch.as_tensor(v)))
    np.testing.assert_allclose(got, A @ v + 2.0 * u * v, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(Jj.matvec(jnp.asarray(v))),
                               rtol=0, atol=1e-12)


def _containers():
    """(name, port operator, scipy matrix) of each sparse container whose
    matvec has a CUDA kernel (B7, B8, B9, B9 + B10)."""
    rng = np.random.default_rng(4)
    n = 64
    band = sp.diags([rng.standard_normal(n - 2), rng.standard_normal(n),
                     rng.standard_normal(n - 1)], [-2, 0, 1], format="csr")
    blocks = sp.kron(sp.random(16, 16, density=0.2, random_state=1),
                     np.ones((4, 4)), format="csr")
    blocks.data = rng.standard_normal(blocks.nnz)
    blocks = (blocks + sp.identity(n)).tocsr()
    rnd = (sp.random(n, n, density=0.1, random_state=2)
           + sp.identity(n)).tocsr()
    return [
        ("banded", et.banded_from_scipy(band, dtype=np.float64,
                                        device="cpu"), band),
        ("blockell", et.blockell_from_scipy(blocks, 4, dtype=np.float64,
                                            device="cpu"), blocks),
        ("sell", et.SellOperator.from_scipy(rnd, dtype=np.float64,
                                            device="cpu"), rnd),
        ("sell seg", et.SellOperator.from_scipy(rnd, mode="seg",
                                                dtype=np.float64,
                                                device="cpu"), rnd),
    ]


@pytest.mark.parametrize("i", range(4))
def test_jacobian_over_container_twins(i):
    """A linear f over a container: J v = A v, from a forward-mode pass
    through the container's CPU matvec."""
    name, op, A = _containers()[i]
    rng = np.random.default_rng(5)
    u, v = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    J = et.JacobianOperator(op.matvec, u)
    np.testing.assert_allclose(t2n(J.matvec(torch.as_tensor(v))), A @ v,
                               rtol=0, atol=1e-12 * np.abs(A @ v).max())


@pytest.mark.parametrize("i", range(4))
def test_jvp_through_kernel_path(monkeypatch, i):
    """The kernel path under torch.func.jvp: the container's kernel (a
    stand-in recording what reaches it) runs on the primal and on the
    tangent, each an unwrapped tensor, and J v = A v."""
    name, op, A = _containers()[i]
    seen = []

    def stand_in(x):
        seen.append(torch._C._functorch.is_functorch_wrapped_tensor(x))
        return torch.as_tensor(A @ x.numpy())

    monkeypatch.setattr(tsparse, "kernel_device_ok", lambda dt, dev: True)
    if name == "banded":
        monkeypatch.setattr(type(op), "plan",
                            lambda self, dt, dev: stand_in)
    elif name == "blockell":
        monkeypatch.setattr(tsparse, "blockell_spmv",
                            lambda blocks, bcols, x: stand_in(x))
    else:
        monkeypatch.setattr(tsparse, "launch_plan", lambda data: stand_in)
    rng = np.random.default_rng(6)
    u, v = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    J = et.JacobianOperator(lambda x: op.matvec(x) + x ** 2, u)
    got = t2n(J.matvec(torch.as_tensor(v)))
    np.testing.assert_allclose(got, A @ v + 2.0 * u * v, rtol=0,
                               atol=1e-12 * np.abs(got).max())
    assert seen == [False, False]           # primal, tangent: unwrapped
    # outside a transform the matvec calls the kernel directly
    op.matvec(torch.as_tensor(v))
    assert seen == [False, False, False]


def test_exprb32_jacobian_default_on_banded_container():
    """exprb32 with jac=None on a BandedOperator f (the chip's
    JacobianOperator cell at a small size) against JAX's."""
    nx = 48
    D = _lap(nx, 0.01)
    opj = ej.banded_from_scipy(sp.csr_matrix(D))
    opt = et.banded_from_scipy(sp.csr_matrix(D), dtype=np.float64,
                               device="cpu")
    u0 = np.sin(np.pi * np.arange(1, nx + 1) / (nx + 1)) * 0.5
    kw = dict(rtol=1e-7, atol=1e-9)
    uj, sj = ej.exprb32(lambda u: opj.matvec(u) + u - u ** 3, u0, (0.0, 0.2),
                        **kw)
    ut, st = et.exprb32(lambda u: opt.matvec(u) + u - u ** 3, u0, (0.0, 0.2),
                        **kw)
    _same_stats(st, sj)
    _hold(ut, np.asarray(uj))


# --- the failure protocol, in both packages

def test_blowup_raises():
    f = lambda u: u ** 2
    u0 = np.full(4, 3.0)
    for pkg in (ej, et):
        with pytest.raises(FloatingPointError, match="stopped at"):
            pkg.exprb32(f, u0, (0.0, 5.0), rtol=1e-6, atol=1e-9,
                        max_steps=60)
        with pytest.raises(FloatingPointError, match="stopped at"):
            pkg.exprb32_device(f, u0, (0.0, 5.0), rtol=1e-6, atol=1e-9,
                               max_steps=60, m=8)


def test_nonfinite_raises():
    nx = 32
    opj = ej.StencilOperator((nx,), ((0,),), jnp.asarray([1.0]),
                             is_hermitian=True)
    opt = et.StencilOperator((nx,), ((0,),), np.asarray([1.0]),
                             is_hermitian=True)
    with pytest.raises((FloatingPointError, ValueError)):
        ej.etdrk4(opj, lambda u: jnp.exp(u) * 1e4, np.full(nx, 10.0),
                  (0.0, 10.0), 2.0)
    with pytest.raises((FloatingPointError, ValueError)):
        et.etdrk4(opt, lambda u: torch.exp(u) * 1e4, np.full(nx, 10.0),
                  (0.0, 10.0), 2.0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        ej.etdrk4_device(opj, lambda u: jnp.exp(u) * 1e4, np.full(nx, 50.0),
                         (0.0, 10.0), 2.0, m=12)
    with pytest.raises(FloatingPointError, match="non-finite"):
        et.etdrk4_device(opt, lambda u: torch.exp(u) * 1e4, np.full(nx, 50.0),
                         (0.0, 10.0), 2.0, m=12)


def test_bad_arguments_raise():
    f = lambda u: -u
    for pkg in (ej, et):
        with pytest.raises(ValueError):
            pkg.exprb32(f, np.ones(4), (1.0, 0.5))
        with pytest.raises(ValueError):
            pkg.etdrk4(pkg.DiagonalOperator(np.ones(4) if pkg is ej
                                            else torch.ones(4)),
                       f, np.ones(4), (0.0, 1.0), 0.3)
        with pytest.raises(ValueError, match="controller"):
            pkg.exprb43_device(f, np.ones(4), (0.0, 1.0), controller="x")
        with pytest.raises(ValueError, match="requires dt"):
            pkg.exprb43_device(f, np.ones(4), (0.0, 1.0), adaptive=False)
        with pytest.raises(ValueError, match="atol"):
            pkg.exprb43(f, np.ones(4), (0.0, 1.0), atol=np.ones(3))
        with pytest.raises(ValueError, match="strictly increasing"):
            pkg.exprb43_device(f, np.ones(4), (0.0, 1.5),
                               snapshots=[0.8, 0.5, 1.5])
        with pytest.raises(ValueError, match="include it"):
            pkg.exprb43_device(f, np.ones(4), (0.0, 1.5), snapshots=[0.5])
        with pytest.raises(ValueError, match="adaptive=True"):
            pkg.exprb43_device(f, np.ones(4), (0.0, 1.5), 0.1,
                               adaptive=False, snapshots=[0.5, 1.5])

"""PyTorch port vs JAX package: gradients through the dense and Krylov
layers (the cases of tests/test_ad.py, torch.autograd.grad against
jax.grad on the same seeded inputs, at 1e-10 of the gradient's scale),
the ``differentiable=True`` forms under ``torch.func`` transforms, and the
reverse-mode rules of the kernel paths on the CPU: B7's rule through a
fake kernel library that computes the product from the launch
descriptor, the Hermitian x-gradient of the SELL container, and the grad
rule of ``ops/kernels/dispatch.py`` (a call that requires grad launches
no recurrence kernel)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops import sparse as tsparse
from exponentialutilities_jl_torch.ops.kernels import _build
from exponentialutilities_jl_torch.ops.kernels import dispatch as td
from exponentialutilities_jl_torch.ops.kernels import spmv as tspmv
from torch_parity import assert_close, t2n, use_fake_kernel_library

torch.set_num_threads(2)

# gradients of the same function in both packages: the same arithmetic up
# to summation order, amplified by the reverse sweep's condition
RTOL_GRAD = 1e-10


def _spd(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return -(M @ M.T) / n - np.eye(n)


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _both_grads(fj, ft, x):
    """(port gradient, JAX gradient) of f at the numpy array x."""
    gj = np.asarray(jax.grad(fj)(jnp.asarray(x)))
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(ft(xt), xt)
    return t2n(gt), gj


# --- the cases of tests/test_ad.py

def _case_expv_t():
    A, b = _spd(24, 0), _vec(24, 1)
    fj = lambda t: jnp.sum(ej.expv(t, jnp.asarray(A), jnp.asarray(b), m=24,
                                   reduced="device") ** 2)
    ft = lambda t: (et.expv(t, torch.as_tensor(A), torch.as_tensor(b),
                            m=24) ** 2).sum()
    return fj, ft, np.asarray(0.7)


def _case_expv_dense_operator(m=12):
    # m < n: at m = n (test_ad.py's size) the reverse sweep runs through
    # the near-breakdown normalization of the last Lanczos vector, which
    # both packages differentiate only to ~3e-7 (test below)
    A, b = _spd(16, 2), _vec(16, 3)
    fj = lambda A_: jnp.sum(ej.expv(0.5, A_, jnp.asarray(b), m=m,
                                    hermitian=True, reduced="device") ** 2)
    ft = lambda A_: (et.expv(0.5, A_, torch.as_tensor(b), m=m,
                             hermitian=True) ** 2).sum()
    return fj, ft, A


def _case_expv_stencil_coefficients():
    n = 48
    opj = ej.laplacian_1d(n)
    b = _vec(n, 4)
    from exponentialutilities_jl_tpu.ops.sparse import BandedOperator as JB

    def fj(d):
        op = JB(d, opj.offsets, is_hermitian=True)
        return jnp.sum(ej.expv(0.3, op, jnp.asarray(b), m=20,
                               reduced="device") ** 2)

    def ft(d):
        op = et.BandedOperator(d, opj.offsets, is_hermitian=True)
        return (et.expv(0.3, op, torch.as_tensor(b), m=20) ** 2).sum()
    return fj, ft, np.asarray(opj.diags)


def _case_expv_nonhermitian_iop():
    n = 32
    A = np.asarray(ej.advection_diffusion_1d(n, peclet=5.0).to_dense())
    b = _vec(n, 5)
    fj = lambda t: jnp.sum(ej.expv(t, jnp.asarray(A), jnp.asarray(b), m=24,
                                   iop=4, hermitian=False, reduced="device",
                                   differentiable=True) ** 2)
    ft = lambda t: (et.expv(t, torch.as_tensor(A), torch.as_tensor(b), m=24,
                            iop=4, hermitian=False,
                            differentiable=True) ** 2).sum()
    return fj, ft, np.asarray(0.02)


def _case_phiv_t():
    A, b = _spd(20, 6), _vec(20, 7)
    fj = lambda t: jnp.sum(ej.phiv(t, jnp.asarray(A), jnp.asarray(b), 2,
                                   m=20, reduced="device",
                                   differentiable=True) ** 2)
    ft = lambda t: (et.phiv(t, torch.as_tensor(A), torch.as_tensor(b), 2,
                            m=20, differentiable=True) ** 2).sum()
    return fj, ft, np.asarray(0.6)


def _case_expm_generic():
    A = np.random.default_rng(8).standard_normal((6, 6)) * 0.8
    fj = lambda A_: jnp.sum(ej.expm_generic(A_) ** 2)
    ft = lambda A_: (et.expm_generic(A_) ** 2).sum()
    return fj, ft, A


def _case_expm_higham_masked():
    A = np.random.default_rng(9).standard_normal((6, 6)) * 3.0
    fj = lambda A_: jnp.sum(ej.expm_higham2005(A_, differentiable=True) ** 2)
    ft = lambda A_: (et.expm_higham2005(A_, differentiable=True) ** 2).sum()
    return fj, ft, A


def _case_batched_higham():
    A = np.random.default_rng(10).standard_normal((3, 5, 5))
    fj = lambda A_: jnp.sum(ej.expm_higham2005_batched(
        A_, differentiable=True) ** 2)
    ft = lambda A_: (et.expm_higham2005_batched(A_) ** 2).sum()
    return fj, ft, A


def _case_phi_pade():
    A = np.random.default_rng(11).standard_normal((6, 6))
    fj = lambda A_: jnp.sum(ej.phi_pade(A_, 2, differentiable=True) ** 2)
    ft = lambda A_: (et.phi_pade(A_, 2) ** 2).sum()
    return fj, ft, A


CASES = [_case_expv_t, _case_expv_dense_operator,
         _case_expv_stencil_coefficients, _case_expv_nonhermitian_iop,
         _case_phiv_t, _case_expm_generic, _case_expm_higham_masked,
         _case_batched_higham, _case_phi_pade]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[6:])
def test_grad_vs_jax(case):
    fj, ft, x = case()
    gt, gj = _both_grads(fj, ft, x)
    assert_close(gt, gj, RTOL_GRAD, "autograd vs jax.grad")


def test_grad_wrt_dense_operator_full_dimension():
    """test_ad.py's size (m = n = 16): the Krylov result is exp(tA)b, and
    both packages' gradients lie within 1e-6 of the exact one (autograd of
    torch.linalg.matrix_exp), the conditioning of the last Lanczos
    normalization."""
    fj, ft, A = _case_expv_dense_operator(m=16)
    gt, gj = _both_grads(fj, ft, A)
    At = torch.tensor(A, requires_grad=True)
    w = torch.linalg.matrix_exp(0.5 * At) @ torch.as_tensor(_vec(16, 3))
    (ge,) = torch.autograd.grad((w ** 2).sum(), At)
    assert_close(gt, t2n(ge), 1e-6, "port vs exact")
    assert_close(gj, t2n(ge), 1e-6, "JAX vs exact")


@pytest.mark.parametrize("fn", [
    lambda A: et.expm_higham2005(A, differentiable=True),
    lambda A: et.expm_higham2005_batched(A[None], differentiable=True)[0],
    lambda A: et.expm_taylor(A, differentiable=True),
    lambda A: et.expm_generic(A),
    lambda A: et.phi_taylor(A, 2, differentiable=True),
    lambda A: et.phi_pade(A, 2, differentiable=True),
    lambda A: et.phiv_dense(A, A[:, 0], 2, differentiable=True),
], ids=["higham", "batched", "taylor", "generic", "phi_taylor", "phi_pade",
        "phiv_dense"])
def test_func_transforms_through_differentiable_forms(fn):
    """torch.func.grad, jacrev and vmap pass through the forms with no
    host read, and agree with autograd of the default forms."""
    A = torch.as_tensor(np.random.default_rng(12).standard_normal((5, 5))
                        * 2.5)
    f = lambda X: (fn(X) ** 2).sum()
    g = torch.func.grad(f)(A)
    Ar = A.clone().requires_grad_()
    (gr,) = torch.autograd.grad(f(Ar), Ar)
    assert_close(t2n(g), t2n(gr), 1e-12, "func.grad vs autograd")
    J = torch.func.jacrev(fn)(A)
    assert J.shape == fn(A).shape + A.shape
    S = torch.stack([A, 0.5 * A, -A])
    V = torch.func.vmap(fn)(S)
    for i in range(3):
        assert_close(t2n(V[i]), t2n(fn(S[i])), 1e-13, f"vmap element {i}")


def test_host_staged_entries_refuse_transforms():
    A = torch.eye(4, dtype=torch.float64)
    for fn in (et.gebal, lambda X: et.funm(X, "exp"), et.expm_mp,
               lambda X: et.expm(X, method="gebal")):
        with pytest.raises(NotImplementedError, match="host-staged"):
            torch.func.grad(lambda X: fn(X)[0].sum() if isinstance(
                fn(X), tuple) else fn(X).sum())(A)
    with pytest.raises(NotImplementedError, match="host-staged"):
        et.funm(A.clone().requires_grad_(), "exp")


# --- B7's reverse rule through a fake kernel library

def _fake_b7(addr, xp, yp, stream):
    """y = A x from a B7 launch descriptor (float64), as the kernel does."""
    L = tspmv._BandedLaunch.from_address(addr)
    n, k = L.n, L.k
    D = np.ctypeslib.as_array((ctypes.c_double * (k * n)).from_address(
        L.diags)).reshape(k, n)
    x = np.ctypeslib.as_array((ctypes.c_double * n).from_address(xp))
    y = np.ctypeslib.as_array((ctypes.c_double * n).from_address(yp))
    y[:] = 0.0
    for j in range(k):
        o = L.o[j]
        i = np.arange(max(0, -o), min(n, n - o))
        y[i] += D[j, i] * x[i + o]
    return 0


def _b7_path(monkeypatch):
    lib = use_fake_kernel_library(monkeypatch,
                                  returns={"eu_banded_spmv_f64": _fake_b7})
    monkeypatch.setattr(tsparse, "kernel_device_ok", lambda dt, dev: True)
    return lib


def test_b7_reverse_rule(monkeypatch):
    """A B7-path matvec of a requires-grad x has a graph; its backward is
    one B7 launch on the negated offsets (the adjoint storage) plus the
    plain diagonals gradient, equal to the twin's autograd."""
    lib = _b7_path(monkeypatch)
    n = 40
    op0 = et.advection_diffusion_1d(n, peclet=5.0)
    D = op0.diags.clone().requires_grad_()
    op = et.BandedOperator(D, op0.offsets)
    x = torch.as_tensor(_vec(n, 13)).requires_grad_()
    y = op.matvec(x)
    assert y.grad_fn is not None
    assert [c[0] for c in lib.calls] == ["eu_banded_spmv_f64"]
    g = torch.as_tensor(_vec(n, 14))
    _build.reset_launch_counts()
    lib.calls.clear()
    gx, gD = torch.autograd.grad(y, (x, D), g)
    assert _build.launches["banded_spmv"] == 1
    (name, args), = lib.calls
    L = tspmv._BandedLaunch.from_address(args[0])
    assert list(L.o[:L.k]) == [-o for o in op0.offsets]
    D2 = op0.diags.clone().requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    y2 = tspmv.banded_spmv_ref(D2, op0.offsets, x2)
    assert_close(t2n(y), t2n(y2), 1e-15, "forward")
    rx, rD = torch.autograd.grad(y2, (x2, D2), g)
    assert_close(t2n(gx), t2n(rx), 1e-14, "x-gradient")
    assert_close(t2n(gD), t2n(rD), 1e-15, "diagonals gradient")
    # the adjoint is built once per operator and dtype (anew, on D's
    # graph, only while autograd must see D)
    with torch.no_grad():
        assert op.adjoint() is op.adjoint()
    lib.calls.clear()
    torch.autograd.grad(op.matvec(x), x, g)
    assert len(lib.calls) == 2


def test_b7_forward_mode_in_the_diagonals(monkeypatch):
    """torch.func.jvp in the diagonals through B7: the kernel on the
    unwrapped diagonals (a plan of their own) plus the twin's product of
    the tangent, equal to the twin's forward mode."""
    _b7_path(monkeypatch)
    n = 30
    op0 = et.advection_diffusion_1d(n, peclet=5.0)
    x = torch.as_tensor(_vec(n, 20))
    Dt = torch.as_tensor(np.random.default_rng(21).standard_normal(
        tuple(op0.diags.shape)))
    f = lambda D: et.BandedOperator(D, op0.offsets).matvec(x)
    y, yt = torch.func.jvp(f, (op0.diags,), (Dt,))
    ref = lambda D: tspmv.banded_spmv_ref(D, op0.offsets, x)
    yr, ytr = torch.func.jvp(ref, (op0.diags,), (Dt,))
    assert_close(t2n(y), t2n(yr), 1e-15, "primal")
    assert_close(t2n(yt), t2n(ytr), 1e-15, "tangent")


def test_b7_path_expv_gradient(monkeypatch):
    """expv through B7 with requires-grad diagonals and b: the gradients
    equal the plain twin's (the test_ad stencil case on the kernel
    path)."""
    _b7_path(monkeypatch)
    n = 48
    op0 = et.laplacian_1d(n)
    b0 = _vec(n, 15)

    def grads(kernel):
        monkeypatch.setattr(tsparse, "kernel_device_ok",
                            lambda dt, dev: kernel)
        D = op0.diags.clone().requires_grad_()
        b = torch.as_tensor(b0).requires_grad_()
        op = et.BandedOperator(D, op0.offsets, is_hermitian=True)
        w = et.expv(0.3, op, b, m=20)
        return torch.autograd.grad((w ** 2).sum(), (D, b))

    _build.reset_launch_counts()
    gk = grads(True)
    assert _build.launches["banded_spmv"] == 2 * 20
    gp = grads(False)
    for a, b_, what in zip(gk, gp, ("diags", "b")):
        assert_close(t2n(a), t2n(b_), 1e-12, what)


def _sell_path(monkeypatch, A):
    seen = []

    def stand_in(x):
        seen.append(torch.is_grad_enabled())
        return torch.as_tensor(A @ x.detach().numpy())

    monkeypatch.setattr(tsparse, "kernel_device_ok", lambda dt, dev: True)
    monkeypatch.setattr(tsparse, "launch_plan", lambda data: stand_in)
    return seen


def test_sell_hermitian_x_gradient(monkeypatch):
    """A Hermitian SELL container's x-gradient is the same kernel on g; a
    non-Hermitian one raises in the backward pass, and requires-grad
    storage raises at the product."""
    n = 64
    R = sp.random(n, n, density=0.1, random_state=3)
    S = (R + R.T + sp.identity(n)).tocsr()
    seen = _sell_path(monkeypatch, S.toarray())
    op = et.SellOperator.from_scipy(S, dtype=np.float64, device="cpu",
                                    is_hermitian=True)
    x = torch.as_tensor(_vec(n, 16)).requires_grad_()
    g = torch.as_tensor(_vec(n, 17))
    (gx,) = torch.autograd.grad(op.matvec(x), x, g)
    assert seen == [False, False]          # forward, backward: plain tensors
    assert_close(t2n(gx), S.toarray().T @ t2n(g), 1e-14, "A^T g")
    nonherm = et.SellOperator.from_scipy(S, dtype=np.float64, device="cpu")
    y = nonherm.matvec(x)
    with pytest.raises(NotImplementedError, match="SellOperator"):
        torch.autograd.grad(y, x, g)
    op.data.vals.requires_grad_()
    with pytest.raises(NotImplementedError, match="SellOperator"):
        op.matvec(x)


# --- the grad rule of the recurrence engines

def test_grad_gate_sends_calls_to_plain_path(monkeypatch):
    """With grad requested, the gates return the plain path (counted in
    grad_gated) and no recurrence kernel launches; the gradient equals the
    CPU plain path's."""
    monkeypatch.setattr(td, "kernel_device_ok", lambda dt, dev: True)
    op = et.laplacian_nd_stencil(64)
    b0 = _vec(64, 18)
    b = torch.as_tensor(b0)
    assert td.recurrence_engine(op, torch.float64, device="cpu") is not None
    bg = torch.as_tensor(b0).requires_grad_()
    td.grad_gated["calls"] = 0
    assert td.recurrence_engine(op, torch.float64, device="cpu",
                                operands=(bg,)) is None
    assert not td.resident_multi_ok(op, torch.float64, "cpu", 2, (bg,))
    assert td.grad_gated["calls"] == 2
    with pytest.raises(ValueError, match="autograd"):
        td.recurrence_engine(op, torch.float64, True, device="cpu",
                             operands=(bg,))
    with torch.no_grad():
        assert td.recurrence_engine(op, torch.float64, device="cpu",
                                    operands=(bg,)) is not None
    with pytest.raises(NotImplementedError, match="autograd rule"):
        td.refuse_grad("B1", op, bg)
    _build.reset_launch_counts()
    td.grad_gated["calls"] = 0
    w = et.expv_chebyshev(0.5, op, bg)
    (g,) = torch.autograd.grad((w ** 2).sum(), bg)
    assert sum(_build.launches.values()) == 0
    assert td.grad_gated["calls"] == 1
    monkeypatch.setattr(td, "kernel_device_ok", lambda dt, dev: False)
    bp = torch.as_tensor(b0).requires_grad_()
    (gp,) = torch.autograd.grad((et.expv_chebyshev(0.5, op, bp) ** 2).sum(),
                                bp)
    assert_close(t2n(g), t2n(gp), 1e-14, "gated vs plain")
    assert td.grad_gated["calls"] == 1


def test_grad_gate_two_pass(monkeypatch):
    """The two-pass expv and phiv choices: a requires-grad b or t takes
    the plain passes (no launch) and differentiates."""
    monkeypatch.setattr(td, "kernel_device_ok", lambda dt, dev: True)
    from exponentialutilities_jl_torch.models import expv as texpv
    monkeypatch.setattr(texpv, "kernel_device_ok", lambda dt, dev: True)
    op = et.laplacian_nd_stencil(64)
    b = torch.as_tensor(_vec(64, 19)).requires_grad_()
    t = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    _build.reset_launch_counts()
    td.grad_gated["calls"] = 0
    w = et.expv(t, op, b, m=20, two_pass=True)
    W = et.phiv(t, op, b, 2, m=20, two_pass=True)
    gb, gt = torch.autograd.grad((w ** 2).sum() + (W ** 2).sum(), (b, t))
    assert sum(_build.launches.values()) == 0
    assert td.grad_gated["calls"] == 2
    assert torch.isfinite(gb).all() and torch.isfinite(gt)

"""PyTorch port vs JAX package: the structured sparse containers
(ops/sparse.py: BandedOperator, SparseELLOperator, BlockELLOperator), the
plain twins of their SpMV kernels (B7 ``banded_spmv``, B8
``blockell_spmv``) and the port's copy of the JAX package's host packers
(exponentialutilities_jl_torch/native/, through utils/native.py). Same
seeded numpy inputs through both packages, float64 unless stated.

Tolerances (norm-scaled, tests/torch_parity.py): RTOL64 where both sides
run the same products in another summation order; RTOL32 against the JAX
Pallas block-ELL kernel in interpret mode (float32); 1e2 RTOL64 for the
Krylov actions, as in tests/test_torch_expv.py (the JAX Lanczos
reorthogonalizes, the port's does not). JAX never runs its banded kernel
(``banded_spmv`` has no interpret mode), so B7's twin is held to the JAX
``BandedOperator.matvec`` and to the dense matrix."""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu import native as jnative
from exponentialutilities_jl_tpu.ops.kernels import spmv as jspmv
from exponentialutilities_jl_torch.ops.kernels import spmv as tspmv
from exponentialutilities_jl_torch.utils import native as tnative
from torch_parity import (RTOL32, RTOL64, assert_close, t2n,
                          use_fake_kernel_library)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _random_sparse(n, density=0.1, seed=7):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(seed),
                  format="csr")
    A.setdiag(np.random.default_rng(seed).standard_normal(n))
    return A.tocsr()


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def test_native_loads_without_jax():
    """utils/native.py uses the port's own copy of the packers: a fresh
    interpreter that uses it never imports jax or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from exponentialutilities_jl_torch.utils import native\n"
        "import scipy.sparse as sp\n"
        "A = sp.random(50, 50, density=0.1, random_state=1, format='csr')\n"
        "native.csr_to_ell_arrays(A); native.rcm_ordering(A)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'exponentialutilities_jl_tpu')]\n"
        "assert not bad, bad\n" % str(REPO))
    r = subprocess.run([sys.executable, "-I", "-c", code],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_native_is_the_jax_packer():
    A = _random_sparse(60, seed=3)
    for t, j in ((tnative.csr_to_ell_arrays(A), jnative.csr_to_ell_arrays(A)),
                 (tnative.bsr_to_blockell_arrays(A, 4, 3),
                  jnative.bsr_to_blockell_arrays(A, 4, 3))):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnative.rcm_ordering(A),
                                  jnative.rcm_ordering(A))
    P = sp.csr_matrix(np.asarray(ej.poisson_2d(6, 5).to_dense()))
    offs = tnative.csr_band_offsets(P)
    np.testing.assert_array_equal(offs, jnative.csr_band_offsets(P))
    for a, b in zip(tnative.csr_to_banded_arrays(P, offs),
                    jnative.csr_to_banded_arrays(P, offs)):
        np.testing.assert_array_equal(a, b)


def test_rcm_ordering_with_isolated_rows():
    """A graph with isolated rows after connected ones: the JAX package's
    native search loses vertices there (ROADMAP Queue C); the port's copy
    orders every vertex, and the RCM-permuted SELL operator applies A."""
    n = 3000
    A = sp.random(n, n, density=1e-4, random_state=np.random.RandomState(1),
                  format="csr")
    A = (A + A.T).tocsr()
    perm = tnative.rcm_ordering(A)
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))
    op = et.SellOperator.from_scipy(A, rcm=True, dtype=np.float64)
    np.testing.assert_array_equal(op.perm, perm)
    x = _x(n, 9)
    back = np.empty(n)
    back[perm] = t2n(op.matvec(torch.as_tensor(x[perm])))
    assert_close(back, A @ x, RTOL64, "rcm matvec")


@pytest.mark.parametrize("case", ["random", "isolated", "components"])
def test_rcm_repair_keeps_native_permutations(case):
    """The repaired start-vertex search changes nothing where the JAX
    package's native search already ordered every vertex, and completes
    the ordering where it did not."""
    rng = np.random.RandomState(5)
    if case == "random":
        A = _random_sparse(300, density=0.02, seed=9)
    elif case == "isolated":
        A = sp.random(2000, 2000, density=2e-4, random_state=rng, format="csr")
    else:
        A = sp.block_diag([_random_sparse(50, density=0.1, seed=s)
                           for s in range(4)] + [sp.csr_matrix((7, 7))],
                          format="csr")
    A = (A + A.T).tocsr()
    n = A.shape[0]
    S = (A + A.T).tocsr()
    indptr = np.ascontiguousarray(S.indptr, np.int64)
    indices = np.ascontiguousarray(S.indices, np.int32)
    old = np.empty(n, np.int32)
    jnative.load_native().rcm_ordering(
        n, indptr.ctypes.data_as(jnative._i64p),
        indices.ctypes.data_as(jnative._i32p), old.ctypes.data_as(jnative._i32p))
    new = tnative.rcm_ordering(A)
    np.testing.assert_array_equal(np.sort(new), np.arange(n))
    if np.array_equal(np.sort(old), np.arange(n)):
        np.testing.assert_array_equal(new, old)
    else:
        assert case != "random"


BANDED = {
    "poisson_2d": lambda: ej.poisson_2d(9, 7),
    "advection": lambda: ej.advection_diffusion_1d(40),
    "wide": lambda: ej.BandedOperator(                 # |offset| >= n too
        np.random.default_rng(4).standard_normal((4, 30)), (-29, -2, 5, 31)),
}


@pytest.mark.parametrize("name", list(BANDED))
def test_banded_matvec_vs_jax(name):
    jop = BANDED[name]()
    top = et.to_torch_operator(jop)
    x = _x(jop.shape[0], 1)
    want = np.asarray(jop.matvec(jnp.asarray(x)))
    dense = np.asarray(jop.to_dense())
    assert_close(t2n(top.matvec(torch.as_tensor(x))), want, RTOL64, "matvec")
    assert_close(t2n(tspmv.banded_spmv(top.diags, top.offsets,
                                       torch.as_tensor(x))),
                 dense @ x, RTOL64, "B7 twin vs dense")
    np.testing.assert_array_equal(t2n(top.to_dense()), dense)


def test_banded_constructors_vs_jax():
    jop = ej.advection_diffusion_1d(40)
    top = et.advection_diffusion_1d(40)
    np.testing.assert_array_equal(t2n(top.diags), np.asarray(jop.diags))
    A = np.asarray(jop.to_dense())
    for j, t in ((ej.BandedOperator.from_dense(A),
                  et.BandedOperator.from_dense(A)),
                 (ej.banded_from_scipy(sp.csr_matrix(A)),
                  et.banded_from_scipy(sp.csr_matrix(A)))):
        assert t.offsets == j.offsets
        np.testing.assert_array_equal(t2n(t.diags), np.asarray(j.diags))
    je, te = jop.to_ell(), top.to_ell()
    np.testing.assert_array_equal(t2n(te.data), np.asarray(je.data))
    np.testing.assert_array_equal(t2n(te.cols), np.asarray(je.cols))
    with pytest.raises(ValueError, match="outside"):
        et.banded_from_scipy(sp.csr_matrix(A), offsets=[0, 1])


def test_ell_vs_jax():
    A = _random_sparse(50)
    jop, top = ej.ell_from_scipy(A), et.ell_from_scipy(A)
    x = _x(50, 2)
    assert_close(t2n(top.matvec(torch.as_tensor(x))),
                 np.asarray(jop.matvec(jnp.asarray(x))), RTOL64, "matvec")
    np.testing.assert_array_equal(t2n(top.to_dense()), A.toarray())
    assert float(top.opnorm_hint()) == pytest.approx(float(jop.opnorm_hint()))
    Ad = np.zeros((12, 12))
    Ad[2, 3], Ad[5, 5], Ad[11, 0] = 1.5, -2.0, 0.25
    np.testing.assert_array_equal(
        t2n(et.SparseELLOperator.from_dense(Ad).to_dense()),
        np.asarray(ej.SparseELLOperator.from_dense(Ad).to_dense()))


@pytest.mark.parametrize("br,bc", [(4, 4), (8, 8), (2, 4)])
def test_blockell_vs_jax(br, bc):
    A = _random_sparse(64, density=0.05, seed=br * bc)
    jop = ej.blockell_from_scipy(A, br, bc)
    top = et.blockell_from_scipy(A, br, bc)
    np.testing.assert_array_equal(t2n(top.blocks), np.asarray(jop.blocks))
    np.testing.assert_array_equal(t2n(top.bcols), np.asarray(jop.bcols))
    x = _x(64, 3)
    y = t2n(top.matvec(torch.as_tensor(x)))
    assert_close(y, np.asarray(jop.matvec(jnp.asarray(x))), RTOL64, "matvec")
    assert_close(y, A @ x, RTOL64, "vs scipy")
    np.testing.assert_array_equal(t2n(top.to_dense()), A.toarray())
    assert float(top.opnorm_hint()) == pytest.approx(float(jop.opnorm_hint()))
    Ad = A.toarray()
    jd = ej.BlockELLOperator.from_dense(Ad, br, bc)
    td = et.BlockELLOperator.from_dense(Ad, br, bc)
    np.testing.assert_array_equal(t2n(td.blocks), np.asarray(jd.blocks))
    np.testing.assert_array_equal(t2n(td.bcols), np.asarray(jd.bcols))


def test_blockell_twin_vs_jax_interpret():
    """B8's twin against the JAX Pallas kernel in interpret mode (float32,
    the smallest shape of the JAX package's own test)."""
    A = _random_sparse(64).toarray()
    jop = ej.BlockELLOperator.from_dense(A, 8)
    x = _x(64, 4).astype(np.float32)
    jy = jspmv.blockell_spmv(jop.blocks.astype(jnp.float32), jop.bcols,
                             jnp.asarray(x), interpret=True)
    ty = tspmv.blockell_spmv(torch.tensor(np.asarray(jop.blocks),
                                          dtype=torch.float32),
                             torch.tensor(np.asarray(jop.bcols)),
                             torch.as_tensor(x))
    assert ty.dtype == torch.float32
    assert_close(t2n(ty), np.asarray(jy), RTOL32, "B8 twin vs interpret")


def test_mixed_dtype_promotes():
    """A float32 operator applied to a float64 vector computes in float64,
    as the JAX containers do."""
    A = _random_sparse(32)
    x = _x(32, 5)
    for top in (et.blockell_from_scipy(A, 4, dtype=np.float32),
                et.BandedOperator.from_dense(A.toarray().astype(np.float32))):
        y = top.matvec(torch.as_tensor(x))
        assert y.dtype == torch.float64


ACTION_OPS = {
    "banded": lambda A: (ej.banded_from_scipy(A, is_hermitian=True),
                         et.banded_from_scipy(A, is_hermitian=True)),
    "ell": lambda A: (ej.ell_from_scipy(A, is_hermitian=True),
                      et.ell_from_scipy(A, is_hermitian=True)),
    "blockell": lambda A: (ej.blockell_from_scipy(A, 4, is_hermitian=True),
                           et.blockell_from_scipy(A, 4, is_hermitian=True)),
}


@pytest.mark.parametrize("kind", list(ACTION_OPS))
def test_structured_containers_in_actions(kind):
    """expv (happy breakdown and two-pass), phiv and expv_chebyshev on each
    structured container, port vs JAX."""
    jp = ej.poisson_2d(12, 10)
    A = sp.csr_matrix(np.asarray(jp.to_dense()))
    jop, top = ACTION_OPS[kind](A)
    b = _x(A.shape[0], 6)
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    bounds = jp._gershgorin_real()
    rtol = 1e2 * RTOL64
    for two_pass in (False, True):
        assert_close(t2n(et.expv(0.1, top, tb, m=25, two_pass=two_pass)),
                     np.asarray(ej.expv(0.1, jop, jb, m=25,
                                        two_pass=two_pass)), rtol, "expv")
    assert_close(t2n(et.phiv(0.1, top, tb, 2, m=25)),
                 np.asarray(ej.phiv(0.1, jop, jb, 2, m=25)), rtol, "phiv")
    assert_close(t2n(et.expv_chebyshev(0.1, top, tb, bounds=bounds,
                                       tol=1e-12)),
                 np.asarray(ej.expv_chebyshev(0.1, jop, jb, bounds=bounds,
                                              tol=1e-12)),
                 RTOL64, "expv_chebyshev")


def test_hoist_conjugation_identity_for_other_operators():
    op = et.poisson_2d(4, 4)
    b = torch.ones(16, dtype=torch.float64)
    assert et.hoist_conjugation(op, b) == (op, b, None)


def test_cpu_runs_twins_not_kernels():
    """On CPU tensors every SpMV wrapper runs its plain twin: no launch."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    A = _random_sparse(64)
    x = torch.as_tensor(_x(64, 7))
    _build.reset_launch_counts()
    et.banded_from_scipy(sp.csr_matrix(np.asarray(
        ej.poisson_2d(8, 8).to_dense()))).matvec(x)
    et.blockell_from_scipy(A, 4).matvec(x)
    for mode in (None, "seg"):
        et.SellOperator.from_scipy(A, dtype=np.float64, mode=mode).matvec(x)
    assert not any(_build.launches.values()), _build.launches


def test_blockell_checks_bcols_once():
    """B8 gathers x by bcols unchecked, so the container refuses block
    columns out of range, and bcols that do not match the blocks, when it
    is built."""
    A = _random_sparse(64, density=0.05, seed=8)
    top = et.blockell_from_scipy(A, 4)
    bad = top.bcols.clone()
    bad[0, 0] = 16                              # n / bc = 16 block columns
    with pytest.raises(ValueError, match="bcols"):
        et.BlockELLOperator(top.blocks, bad)
    with pytest.raises(ValueError, match="bcols"):
        et.BlockELLOperator(top.blocks, top.bcols[:, :1])
    with pytest.raises(ValueError, match="bcols"):
        et.BlockELLOperator(top.blocks, -top.bcols - 1)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_blockell_use_pallas_has_no_effect(use_pallas):
    """``use_pallas`` keeps the JAX signature only: the product is the same
    whatever its value (B8 on CUDA, its twin on CPU)."""
    A = _random_sparse(64, density=0.05, seed=9)
    top = et.blockell_from_scipy(A, 4)
    x = _x(64, 10)
    y = et.BlockELLOperator(top.blocks, top.bcols,
                            use_pallas=use_pallas).matvec(torch.as_tensor(x))
    assert_close(t2n(y), A @ x, RTOL64, "vs scipy")


# ---- B7's launch plan (ops/kernels/spmv.BandedPlan), host logic ----------

def _interior_brute(offsets, n, rows):
    """The blocks whose rows all exist and read x only inside [0, n),
    checked row by row."""
    o = np.asarray(offsets)
    out = []
    for b in range(-(-n // rows)):
        i = np.arange(b * rows, b * rows + rows)
        q = i[:, None] + o[None, :]
        if i[-1] < n and (q >= 0).all() and (q < n).all():
            out.append(b)
    return out


@pytest.mark.parametrize("V", [2, 4])
def test_banded_interior_vs_brute_force(V):
    """The interior block range the plan hands B7 (no bounds checks there)
    is exactly the set of blocks that need none, over random offsets (some
    wider than the vector), n (smaller than a block, not a multiple of V)
    and both row widths of a thread."""
    rows = tspmv.ROW_THREADS * V
    rng = np.random.default_rng(40 + V)
    for _ in range(60):
        n = int(rng.integers(1, 6 * rows))
        k = int(rng.integers(1, 8))
        reach = int(rng.choice([3, rows, n + 5]))
        offsets = tuple(int(o) for o in rng.integers(-reach, reach + 1, k))
        blo, bhi = tspmv.banded_interior(offsets, n, rows)
        assert list(range(blo, bhi)) == _interior_brute(offsets, n, rows), \
            (offsets, n, rows)
    assert tspmv.banded_interior((-1000, -1, 0, 1, 1000), 10 ** 6, 512) == \
        (2, 1951)


@pytest.fixture
def fake_lib(monkeypatch):
    return use_fake_kernel_library(monkeypatch)


def test_banded_plans_cached_per_dtype_and_device(fake_lib):
    """BandedOperator keeps one plan per compute dtype and device, reuses
    it, and builds a new one when its diagonals or offsets are reassigned;
    a float32 plan holds the diagonals cast once. A CPU matvec runs the
    twin and builds no plan."""
    op = et.poisson_2d(9, 7)
    x = torch.as_tensor(_x(63, 11))
    dense = t2n(op.to_dense())
    y64, y32 = op.matvec(x), op.matvec(x.float())
    assert y64.dtype == torch.float64 and y32.dtype == torch.float64
    assert "_plans" not in op.__dict__ and not fake_lib.calls
    assert_close(t2n(y64), dense @ t2n(x), RTOL64, "CPU matvec")
    cpu = torch.device("cpu")
    p64, p32 = op.plan(torch.float64, cpu), op.plan(torch.float32, "cpu")
    assert set(op._plans) == {(torch.float64, cpu), (torch.float32, cpu)}
    assert op.plan(torch.float64, "cpu") is p64 and p64.diags is op.diags
    assert p32.diags.dtype == torch.float32
    assert op.plan(torch.float32, cpu).diags is p32.diags
    op.diags = 2 * op.diags
    p64b = op.plan(torch.float64, cpu)
    assert p64b is not p64 and p64b.diags is op.diags
    assert_close(t2n(op.matvec(x)), 2 * dense @ t2n(x), RTOL64, "new diags")
    op.offsets = (0,) + op.offsets[1:]
    plan = op.plan(torch.float64, cpu)
    assert plan is not p64b and plan.offsets == op.offsets
    assert not fake_lib.calls


def test_banded_plan_checks_once_and_per_call(fake_lib):
    """A kernel plan checks the diagonals once (dtype, device, shape, at
    most MAX_POINTS offsets) and each vector's dtype, device and shape; a
    launch passes its descriptor (the diagonals' pointer, n, the offsets,
    the interior block range), x and y, and counts one launch. The
    descriptor's layout is the one csrc/spmv.cu asserts."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    cpu = torch.device("cpu")
    D = torch.as_tensor(np.random.default_rng(12).standard_normal((3, 2001)))
    offs = (-400, 0, 7)
    with pytest.raises(ValueError, match="dtype"):
        tspmv.BandedPlan(D.float(), offs, torch.float64, cpu)
    with pytest.raises(ValueError, match="operand on meta"):
        tspmv.BandedPlan(D.to("meta"), offs, torch.float64, cpu)
    with pytest.raises(ValueError, match="offsets"):
        tspmv.BandedPlan(D, offs[:2], torch.float64, cpu)
    with pytest.raises(ValueError, match="at most"):
        tspmv.BandedPlan(torch.zeros(_build.MAX_POINTS + 1, 8),
                         range(_build.MAX_POINTS + 1), torch.float64, cpu)
    with pytest.raises(ValueError, match="float32/float64"):
        tspmv.BandedPlan(D.to(torch.complex128), offs, torch.complex128, cpu)
    plan = tspmv.BandedPlan(D[:, ::1], offs, torch.float64, cpu)
    x = torch.as_tensor(_x(2001, 13))
    for bad in (x.float(), x[:-1], x.to("meta")):
        with pytest.raises(ValueError, match="vector"):
            plan(bad)
    assert not fake_lib.calls
    _build.reset_launch_counts()
    plan(x)
    plan(torch.as_tensor(_x(4002, 14))[::2])              # made contiguous
    assert _build.launches["banded_spmv"] == 2
    (name, args), _ = fake_lib.calls
    assert name == "eu_banded_spmv_f64"
    assert args == (plan.addr, x.data_ptr(), args[2], 0)
    d = plan.launch
    assert (d.diags, d.n, d.k, list(d.o[:3])) == (plan.diags.data_ptr(), 2001,
                                                   3, list(offs))
    assert (d.blo, d.bhi) == tspmv.banded_interior(offs, 2001, 512) == (1, 3)
    L = tspmv._BandedLaunch
    assert (ctypes.sizeof(L), L.k.offset, L.o.offset) == (296, 32, 36)
    f32 = tspmv.BandedPlan(D.float(), offs, torch.float32, cpu)
    with pytest.raises(ValueError, match="vector"):
        f32(x)                          # no cast of x inside a plan
    f32(x.float())
    assert fake_lib.calls[-1][0] == "eu_banded_spmv_f32"
    assert (f32.launch.blo, f32.launch.bhi) == \
        tspmv.banded_interior(offs, 2001, 1024)


def test_banded_plan_refuses_cpu():
    """With the real kernel library, a plan for CPU tensors raises before
    any pointer could reach a kernel; banded_spmv and BandedOperator send
    CPU tensors to the twin instead."""
    D = torch.as_tensor(np.random.default_rng(15).standard_normal((3, 64)))
    offs = (-1, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tspmv.BandedPlan(D, offs, torch.float64, "cpu")
    op = et.BandedOperator(D, offs)
    with pytest.raises(ValueError, match="CUDA"):
        op.plan(torch.float64, "cpu")
    x = torch.as_tensor(_x(64, 16))
    want = tspmv.banded_spmv_ref(D, offs, x)
    assert torch.equal(tspmv.banded_spmv(D, offs, x), want)
    assert torch.equal(op.matvec(x), want)

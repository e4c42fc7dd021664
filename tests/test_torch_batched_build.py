"""PyTorch port vs JAX package: ``expv_batched``'s one batched build
(ops/krylov.py with a (batch, n) b, models/expv.py) on the CPU in float64.

The batched builders are held against JAX's vmapped ones, called as the
JAX package calls them (``models/expv._batched_build``,
``_batched_lanczos_coeffs``, ``_batched_lanczos_replay``): Hermitian and
non-Hermitian operators, real and complex, full and IOP Arnoldi, rows
that break down at different steps and a row of zeros. A batch of one
agrees with the scalar builder to 1e-14 (the batched reductions sum in
another order than the scalar gemv and dot, so not bit for bit);
``expv_batched`` agrees with each row's ``expv`` to 1e-13; each twin of
K1-K4 equals its scalar twin row by row; the gradient in B equals the
rows' gradients to 1e-12. The launch plans of K1-K4 are reached through
``torch_parity.use_fake_kernel_library``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops import krylov as tk
from exponentialutilities_jl_torch.ops.kernels import resident as tr
from exponentialutilities_jl_torch.ops.kernels import spmv as ts
from exponentialutilities_jl_torch.ops.kernels import tridiag as tt
from exponentialutilities_jl_tpu.models import expv as jx
from exponentialutilities_jl_tpu.ops import krylov as jk
from torch_parity import RTOL64, assert_close, t2n, use_fake_kernel_library

torch.set_num_threads(2)

# the records to RTOL64 and the bases to 1e2 x RTOL64, as the scalar
# parity tests (tests/test_torch_krylov.py) hold them
RTOL_BASIS = 1e2 * RTOL64
ROWS_TOL = 1e-13        # expv_batched against each row's expv
ONE_TOL = 1e-14         # a batch of one against the scalar builder


def _rows(n, kind, seed, cplx=False):
    """(4, n) rows: random, one in a 3-dimensional invariant subspace of
    the diagonal and block operators (coordinates 0-2), one in a
    5-dimensional one (coordinates 0-4), and one of zeros."""
    g = np.random.default_rng(seed)
    B = g.standard_normal((4, n))
    if cplx:
        B = B + 1j * g.standard_normal((4, n))
    if kind in ("diag", "block", "block complex"):
        B[1, 3:] = 0.0
        B[2, 5:] = 0.0
    B[3] = 0.0
    return B


def _case(kind):
    """(JAX operator, hermitian, (4, n) rows)."""
    g = np.random.default_rng(11)
    if kind == "diag":
        return (ej.DiagonalOperator(jnp.asarray(np.linspace(-3.0, 0.0, 24))),
                True, _rows(24, kind, 1))
    if kind == "stencil":
        return ej.laplacian_nd_stencil(5, 6), True, _rows(30, kind, 2)
    if kind == "stencil complex rows":
        return ej.laplacian_nd_stencil(5, 6), True, _rows(30, kind, 3, True)
    n = 24
    A = g.standard_normal((n, n)) / 5
    cplx = kind == "block complex"
    if cplx:
        A = A + 1j * g.standard_normal((n, n)) / 5
    # invariant subspaces span(e0..e2) and span(e0..e4): rows 1 and 2
    # break down at steps 3 and 5
    A[3:, :3] = 0.0
    A[5:, 3:5] = 0.0
    return (ej.DenseOperator(jnp.asarray(A), is_hermitian=False), False,
            _rows(n, kind, 4, cplx))


HERM = ["diag", "stencil", "stencil complex rows"]
NONHERM = ["block", "block complex"]


@pytest.mark.parametrize("iop,reorth", [(0, True), (3, False), (0, False)])
@pytest.mark.parametrize("kind", HERM + NONHERM)
def test_batched_build_vs_jax(kind, iop, reorth):
    """The batched Lanczos / Arnoldi basis against JAX's ``_batched_build``
    (vmapped ``build_subspace``): H, V, beta, m_used and breakdown row by
    row, the rows breaking down at different steps."""
    jop, herm, B = _case(kind)
    top = et.to_torch_operator(jop)
    m = 10
    jK = jx._batched_build(jop, jnp.asarray(B), m, 1e-7, iop, reorth, herm)
    tK = et.build_subspace(top, torch.as_tensor(B), m, iop=iop,
                           reorth=reorth, hermitian=herm)
    assert tK.V.shape == (4, m + 1, B.shape[1]) and tK.H.shape == (4, m + 1, m)
    assert t2n(tK.m_used).tolist() == np.asarray(jK.m_used).tolist()
    assert t2n(tK.breakdown).tolist() == np.asarray(jK.breakdown).tolist()
    assert_close(t2n(tK.beta), np.asarray(jK.beta), RTOL64, "beta")
    assert_close(t2n(tK.H), np.asarray(jK.H), RTOL64, "H")
    assert_close(t2n(tK.V), np.asarray(jK.V), RTOL_BASIS, "V")
    assert int(tK.m_used[3]) == 0 and not t2n(tK.V[3]).any()
    if kind in ("diag", "block", "block complex") and (herm or iop == 0):
        assert t2n(tK.m_used[1:3]).tolist() == [3, 5]


def _coeffs(m, m_used, seed):
    """(4, m) replay weights, zero past each row's m_used: past a
    breakdown both packages' replays regenerate rounding noise, which the
    reduced problem weights ~0 (tests/test_torch_krylov.py)."""
    c = np.random.default_rng(seed).standard_normal((4, m))
    c[np.arange(m)[None, :] >= np.asarray(m_used)[:, None]] = 0.0
    return c


@pytest.mark.parametrize("kind", HERM)
def test_batched_lanczos_pair_vs_jax(kind):
    """The batched two-pass Lanczos pair against JAX's
    ``_batched_lanczos_coeffs`` / ``_batched_lanczos_replay``, with each
    row's own coefficients. JAX's replay is off for complex rows (ROADMAP
    Queue C), so there the replay is held to the combination of the
    batched basis, whose rows are held to JAX above."""
    jop, _, B = _case(kind)
    top = et.to_torch_operator(jop)
    m = 12
    ja, jb, jb0, jmu, jbr = jx._batched_lanczos_coeffs(jop, jnp.asarray(B), m)
    ta, tb, tb0, tmu, tbr = tk.lanczos_coeffs(top, torch.as_tensor(B), m)
    assert_close(t2n(ta), np.asarray(ja), RTOL64, "alphas")
    assert_close(t2n(tb), np.asarray(jb), RTOL64, "betas")
    assert_close(t2n(tb0), np.asarray(jb0), RTOL64, "beta0")
    assert t2n(tmu).tolist() == np.asarray(jmu).tolist()
    assert t2n(tbr).tolist() == np.asarray(jbr).tolist()
    c = _coeffs(m, t2n(tmu), 5)
    tw = tk.lanczos_replay(top, torch.as_tensor(B), torch.as_tensor(c),
                           ta, tb, m)
    if np.iscomplexobj(B):
        V = t2n(tk.lanczos(top, torch.as_tensor(B), m).V)
        want = np.einsum("bj,bjn->bn", c, V[:, :m])
    else:
        want = np.asarray(jx._batched_lanczos_replay(
            jop, jnp.asarray(B), jnp.asarray(c), ja, jb, m))
    assert_close(t2n(tw), want, RTOL_BASIS, "replay")


@pytest.mark.parametrize("kind", NONHERM)
def test_batched_arnoldi_pair_vs_jax(kind):
    """The batched IOP pair against JAX's scalar pair on each row (JAX
    vmaps it inside ``expv``): the compact Hessenberg, m_used and the
    replay with a final vector (for complex data, where JAX's replay is
    off, ROADMAP Queue C: against the combination of the batched IOP
    basis ``arnoldi(iop=win, reorth=False)``, the same recurrence)."""
    jop, _, B = _case(kind)
    top = et.to_torch_operator(jop)
    m, win = 10, 2
    Hc, b0, mu, br = tk.arnoldi_coeffs(top, torch.as_tensor(B), m, win)
    c = _coeffs(m, t2n(mu), 6)
    f = np.random.default_rng(7).standard_normal(4) * (t2n(mu) == m)
    w = tk.arnoldi_replay(top, torch.as_tensor(B), torch.as_tensor(c), Hc, m,
                          win, final_coeff=torch.as_tensor(f),
                          with_final=True)
    V = t2n(tk.arnoldi(top, torch.as_tensor(B), m, iop=win,
                       reorth=False).V)
    for i in range(4):
        jHc, jb0, jmu, jbr = jk.arnoldi_coeffs(jop, jnp.asarray(B[i]), m, win)
        assert_close(t2n(Hc[i]), np.asarray(jHc), RTOL64, f"Hc row {i}")
        assert (int(mu[i]), bool(br[i])) == (int(jmu), bool(jbr))
        if np.iscomplexobj(B):
            want = c[i] @ V[i, :m] + f[i] * V[i, m]
        else:
            want = np.asarray(jk.arnoldi_replay(
                jop, jnp.asarray(B[i]), jnp.asarray(c[i]), jHc, m, win,
                final_coeff=f[i], with_final=True))
        assert_close(t2n(w[i]), want, RTOL_BASIS, f"w row {i}")


def _one(kind, builder):
    jop, herm, B = _case(kind)
    top = et.to_torch_operator(jop)
    b = torch.as_tensor(B[:1])
    m, win = 9, 3
    c = torch.as_tensor(np.random.default_rng(8).standard_normal((1, m)))
    if builder == "basis":
        K1 = et.build_subspace(top, b, m, hermitian=herm)
        K0 = et.build_subspace(top, b[0], m, hermitian=herm)
        return [(K1.V[0], K0.V), (K1.H[0], K0.H)]
    if builder == "iop basis":
        K1 = et.arnoldi(top, b, m, iop=win, reorth=False)
        K0 = et.arnoldi(top, b[0], m, iop=win, reorth=False)
        return [(K1.V[0], K0.V), (K1.H[0], K0.H)]
    if builder == "lanczos pair":
        a1, b1, *_ = tk.lanczos_coeffs(top, b, m)
        a0, b0, *_ = tk.lanczos_coeffs(top, b[0], m)
        return [(a1[0], a0), (b1[0], b0),
                (tk.lanczos_replay(top, b, c, a1, b1, m)[0],
                 tk.lanczos_replay(top, b[0], c[0], a0, b0, m))]
    Hc1, *_ = tk.arnoldi_coeffs(top, b, m, win)
    Hc0, *_ = tk.arnoldi_coeffs(top, b[0], m, win)
    return [(Hc1[0], Hc0), (tk.arnoldi_replay(top, b, c, Hc1, m, win)[0],
                            tk.arnoldi_replay(top, b[0], c[0], Hc0, m, win))]


@pytest.mark.parametrize("kind,builder", [
    ("stencil", "basis"), ("stencil complex rows", "lanczos pair"),
    ("block", "basis"), ("block complex", "iop basis"),
    ("block", "arnoldi pair"), ("diag", "lanczos pair")])
def test_batch_of_one_vs_scalar(kind, builder):
    """A batch of one against the scalar builder on the same row (module
    doc: 1e-14, the batched reductions' order)."""
    for got, want in _one(kind, builder):
        assert got.shape == want.shape
        assert_close(t2n(got), t2n(want), ONE_TOL, builder)


def _ops_cpu():
    g = np.random.default_rng(12)
    n = 64
    A = g.standard_normal((n, n)) / 8
    return {
        "banded": (et.laplacian_1d(n), True, 0.4),
        "stencil 2d": (et.laplacian_nd_stencil(8, 8), True, 0.1),
        "variable": (et.variable_diffusion_nd_stencil(
            g.uniform(0.5, 2.0, (8, 8))), True, 0.05),
        "advection": (et.advection_diffusion_1d(n, peclet=5.0), False, 2e-3),
        "dense": (et.DenseOperator(torch.as_tensor(A), is_hermitian=False),
                  False, 0.5),
        "complex diag": (et.DiagonalOperator(torch.as_tensor(
            -g.uniform(0, 2, n) + 1j * g.uniform(-1, 1, n)),
            is_hermitian=False), False, 0.5),
    }


@pytest.mark.parametrize("path", [
    "banded basis", "banded two_pass", "banded host", "banded host two_pass",
    "stencil 2d two_pass", "variable basis", "advection basis",
    "advection iop two_pass", "advection host iop two_pass", "dense basis",
    "dense host", "complex diag basis", "banded complex t"])
def test_expv_batched_vs_rows(path):
    """``expv_batched`` against each row's ``expv`` (module doc, 1e-13),
    with a zero row (zeros out) and a row in a small invariant subspace."""
    name = " ".join(path.split()[:2]) if path.startswith(
        ("stencil 2d", "complex diag")) else path.split()[0]
    op, herm, t = _ops_cpu()[name]
    n = op.shape[0]
    g = np.random.default_rng(13)
    B = g.standard_normal((3, n))
    B[1] = 0.0
    B[2] = 0.0
    B[2, :2] = 1.0 if name != "complex diag" else g.standard_normal(2)
    kw = {}
    if "two_pass" in path:
        kw["two_pass"] = True
    if "iop" in path:
        kw["iop"] = 2
    if "host" in path:
        kw["reduced"] = "host"
    if "complex t" in path:
        t = 0.3 - 0.2j
    Bt = torch.as_tensor(B)
    W = et.expv_batched(t, op, Bt, m=20, **kw)
    want = torch.stack([et.expv(t, op, b, m=20, **kw) for b in Bt.unbind(0)])
    assert W.shape == want.shape and W.dtype == want.dtype
    assert_close(t2n(W), t2n(want), ROWS_TOL, path)
    assert not t2n(W[1]).any()


def test_sorted_sell_hoist_batched():
    """A sorted SELL operator: B's columns permuted once into the sorted
    basis and the result's once out; each row as its ``expv``, which
    hoists the conjugation the same way."""
    import scipy.sparse as sp

    n = 200
    g = np.random.default_rng(14)
    A = sp.random(n, n, density=0.03, random_state=3, format="csr")
    A = -(A @ A.T) - sp.eye(n)
    op = et.SellOperator.from_scipy(A.tocoo(), mode="sorted",
                                    dtype=np.float64, is_hermitian=True)
    B = torch.as_tensor(g.standard_normal((3, n)))
    W = et.expv_batched(0.2, op, B, m=20)
    want = torch.stack([et.expv(0.2, op, b, m=20) for b in B.unbind(0)])
    assert_close(t2n(W), t2n(want), ROWS_TOL, "sorted")
    E = sla.expm(0.2 * A.toarray())
    assert_close(t2n(W), (E @ t2n(B).T).T, 1e-10, "sorted vs scipy")


@pytest.mark.parametrize("name", ["banded", "advection", "dense",
                                  "stencil 2d"])
def test_gradient_vs_rows(name):
    """The gradient of sum(expv_batched(t, op, B)) in B equals the rows'
    gradients of sum(expv(t, op, b)) (1e-12)."""
    op, herm, t = _ops_cpu()[name]
    n = op.shape[0]
    B0 = np.random.default_rng(15).standard_normal((3, n))
    B = torch.as_tensor(B0).requires_grad_()
    gB = torch.autograd.grad(et.expv_batched(t, op, B, m=12).sum(), B)[0]
    for i in range(3):
        b = torch.as_tensor(B0[i]).requires_grad_()
        gb = torch.autograd.grad(et.expv(t, op, b, m=12).sum(), b)[0]
        assert_close(t2n(gB[i]), t2n(gb), 1e-12, f"row {i}")


def test_matmat_forms_vs_matvec():
    """``matmat`` of every operator form against its ``matvec`` row by
    row: bit for bit for the elementwise forms (banded twin, stencils,
    diagonal, negated, the per-row default), 1e-15 for the dense GEMM."""
    g = np.random.default_rng(16)
    ops = _ops_cpu()
    cases = [ops[k][0] for k in ("banded", "stencil 2d", "variable",
                                 "advection", "complex diag")]
    cases.append(et.NegatedOperator(ops["banded"][0]))
    cases.append(et.MatrixFreeOperator(lambda x: 2.0 * x, (64, 64)))
    for op in cases:
        X = torch.as_tensor(g.standard_normal((3, op.shape[0])))
        Y = op.matmat(X)
        assert torch.equal(Y, torch.stack([op.matvec(x) for x in X])), op
    op = ops["dense"][0]
    X = torch.as_tensor(g.standard_normal((3, 64)))
    assert_close(t2n(op.matmat(X)),
                 t2n(torch.stack([op.matvec(x) for x in X])), 1e-15, "GEMM")


def test_twins_row_by_row():
    """Each batched twin against its scalar twin on every row: K1's
    (``banded_spmm_ref``) bit for bit, K2's (the batched eigh formula),
    K3's and K4's (the batched resident twins) to 1e-14."""
    g = np.random.default_rng(17)
    n = 500
    D = torch.as_tensor(g.standard_normal((5, n)))
    offs = (-40, -1, 0, 1, 40)
    X = torch.as_tensor(g.standard_normal((4, n)))
    Y = ts.banded_spmm_ref(D, offs, X)
    for i in range(4):
        assert torch.equal(Y[i], ts.banded_spmv_ref(D, offs, X[i]))
    m = 30
    A = torch.as_tensor(-np.abs(g.standard_normal((4, m))))
    Bt = torch.as_tensor(np.abs(g.standard_normal((4, m - 1))))
    Bt[1, 4:] = 0.0
    s = torch.as_tensor(g.uniform(0.5, 2.0, 4))
    for t in (0.7, torch.tensor(0.7 - 0.2j)):
        out = tt.tridiag_exp_e1_batched_ref(A, Bt, t, s)
        for i in range(4):
            assert_close(t2n(out[i]),
                         t2n(tt.tridiag_exp_e1_ref(A[i], Bt[i], t, s[i])),
                         ONE_TOL, f"K2 twin row {i}")
    op = et.laplacian_nd_stencil(n)
    cv, of = op.coeffs, tr._flat_offsets(op)
    V0 = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    ab = tr.resident_lanczos_batched_ref(V0, cv, of, 20, 1e-7)
    rows = torch.as_tensor(g.standard_normal((4, 12, 4)) * 0.3)
    W, s2 = tr.resident_recurrence_batched_ref(X, rows, cv, of, s)
    for i in range(4):
        assert_close(t2n(ab[i]), t2n(tr.resident_lanczos_ref(
            V0[i], cv, of, 20, 1e-7)), ONE_TOL, f"K3 twin row {i}")
        w1, n1 = tr.resident_recurrence_ref(X[i], rows[i], cv, of, s[i])
        assert_close(t2n(W[i]), t2n(w1), ONE_TOL, f"K4 twin row {i}")
        assert_close(t2n(s2[i]), t2n(n1), ONE_TOL, f"K4 sum row {i}")


# ---- the launch plans' host logic on a stand-in library -------------------

def test_k1_plan_launch(monkeypatch):
    """``BandedOperator.matmat`` on the kernel path: one ``eu_banded_spmm``
    call with the plan's descriptor, X and Y, and the batch."""
    lib = use_fake_kernel_library(monkeypatch)
    from exponentialutilities_jl_torch.ops.kernels import _build

    op = et.laplacian_1d(300)
    X = torch.as_tensor(np.random.default_rng(18).standard_normal((5, 300)))
    plan = ts.BandedPlan(op.diags, op.offsets, torch.float64, X.device)
    _build.reset_launch_counts()
    Y = plan.spmm(X)
    (name, args), = lib.calls
    assert name == "eu_banded_spmm_f64"
    assert args == (plan.addr, X.data_ptr(), Y.data_ptr(), 5, 0)
    assert _build.launches["banded_spmm"] == 1
    with pytest.raises(ValueError):
        plan.spmm(X[:, :299])


@pytest.mark.parametrize("m,shared", [(30, True), (400, False)])
def test_k2_launch_args(monkeypatch, m, shared):
    """K2's one launch: R1's geometry at order m, the batch, and a global
    scratch of one workspace a row where the workspace leaves shared
    memory."""
    lib = use_fake_kernel_library(monkeypatch)
    a = torch.zeros((3, m), dtype=torch.float64)
    b = torch.zeros((3, m - 1), dtype=torch.float64)
    s = torch.ones(3, dtype=torch.float64)
    tt._launch_batched(a, b, torch.tensor(0.5, dtype=torch.float64), s)
    (name, args), = lib.calls
    assert name == "eu_tridiag_exp_batched_f64"
    nt, lanes, nbytes, sh = tt.launch_shape(m)
    assert sh == shared
    assert args[7:13] == (m, nt, nbytes, tt.MAX_ITER, lanes, 3)
    assert (args[6].value is None) == shared
    with pytest.raises(ValueError):
        tt._launch_batched(a, b[:2], torch.tensor(0.5, dtype=torch.float64),
                           s)


def test_k3_plan_batched(monkeypatch):
    """B2's plan in its cluster form takes a block as K3: one call with
    the batch, B2's kernel where its clusters of one row hold the batch
    (or nothing does), else the rows kernel with the smallest P that holds
    it; its grid form takes each row as a B2 launch."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    lib = use_fake_kernel_library(monkeypatch, {
        "eu_lanczos_cluster_fits_f64": 2, "eu_resident_max_blocks": 4})
    op = et.laplacian_nd_stencil(20000)
    V0 = torch.zeros((3, 20000), dtype=torch.float64)
    plan = tr.LanczosPlan(op, torch.float64, V0.device)
    assert plan.form == "cluster"
    _build.reset_launch_counts()
    ab = plan.batched(V0, 40, 1e-7)
    assert ab.shape == (3, 40, 2)
    name, args = lib.calls[-1]
    assert name == "eu_resident_lanczos_cluster_batched_f64"
    assert args[1:] == (V0.data_ptr(), 40, 1e-7, ab.data_ptr(), 3, 0)
    assert _build.launches["resident_lanczos_batched"] == 1
    # clusters of two rows fit where three clusters of one do not: one
    # launch of the rows kernel
    lib.returns["eu_lanczos_cluster_rows_fits_f64"] = 7
    rows2 = tr.LanczosPlan(op, torch.float64, V0.device)
    assert rows2.batch_geometry(3)[2:] == (2, 7, 2, 7, 1, (2, 7, 7))
    ab = rows2.batched(V0, 40, 1e-7)
    name, args = lib.calls[-1]
    assert name == "eu_resident_lanczos_cluster_rows_f64"
    assert args[1:] == (V0.data_ptr(), 40, 1e-7, ab.data_ptr(), 3, 2, 0)
    assert _build.launches["resident_lanczos_batched"] == 2
    lib.returns["eu_lanczos_cluster_fits_f64"] = 0
    grid = tr.LanczosPlan(op, torch.float64, V0.device)
    assert grid.form == "grid"
    grid.batched(V0, 40, 1e-7)
    assert [c[0] for c in lib.calls[-3:]] == ["eu_resident_lanczos_f64"] * 3
    assert _build.launches["resident_lanczos"] == 3


@pytest.mark.parametrize("batch,rows,grid,launches", [
    (1, 1, 132, 1), (8, 8, 16, 1), (16, 8, 16, 2), (40, 8, 16, 5)])
def test_k4_plan_geometry(monkeypatch, batch, rows, grid, launches):
    """K4's plan at config #2's n = 1e5 float64 on a card of 132 SMs that
    holds one block of the rows kernel an SM: the most rows a launch whose
    blocks' spans (chunk + 2 s h rows) a block's registers hold (at most
    13 rows a thread of 512), each group one launch with its rows'
    pointers, flags for R x grid blocks and R tickets, the descriptor with
    the geometry's s, J and threads."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    lib = use_fake_kernel_library(monkeypatch, {
        "eu_device_sms": 132,
        "eu_nbr_rows_capacity_f64": lambda per, h, threads: 132})
    n = 100000
    op = et.laplacian_nd_stencil(n)
    plan = tr.RecurrenceBatchPlan(op, torch.float64, torch.device("cpu"),
                                  batch)
    assert (plan.form, plan.rows_per_launch, plan.grid) == \
        ("neighbour", rows, grid)
    assert plan.launches_per_call == launches
    X = torch.zeros((batch, n), dtype=torch.float64)
    R = torch.zeros((batch, 10, 4), dtype=torch.float64)
    s = torch.ones(batch, dtype=torch.float64)
    _build.reset_launch_counts()
    W, s2 = plan(X, R, s)
    calls = [c for c in lib.calls
             if c[0] == "eu_resident_recurrence_nbr_batched_f64"]
    assert len(calls) == launches == _build.launches[
        "resident_recurrence_batched"]
    for j, (_, args) in enumerate(calls):
        r0 = j * rows
        assert args[1] == X[r0].data_ptr() and args[5] == W[r0].data_ptr()
        assert args[7] == min(rows, batch - r0)
    flags = plan.nbr[0][2]
    assert flags.numel() == rows * grid * tr.NBR_FLAG_STRIDE + rows
    g = tr.nbr_rows_geometry(n, 1, 132 // rows)
    L = tr._RowsLaunch.from_address(calls[0][1][0])
    assert (L.grid, L.chunk, L.h, L.k, L.s, L.per_thread, L.threads) == (
        grid, g.chunk, 1, 3, g.s, g.per_thread, g.threads)
    assert g.s * L.h <= L.chunk <= L.threads * L.per_thread - 2 * g.s


def test_k4_plan_rows_form(monkeypatch):
    """Where no group of rows fits the batched neighbour form (here the
    card holds no block), each row takes the operator's B1 plan, as a
    scalar call would: one B1 launch a row, counted as B1's."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    lib = use_fake_kernel_library(monkeypatch, {"eu_device_sms": 132})
    op = et.laplacian_nd_stencil(5000)
    plan = tr.RecurrenceBatchPlan(op, torch.float64, torch.device("cpu"), 3)
    assert plan.form == "rows" and plan.launches_per_call == 3
    X = torch.zeros((3, 5000), dtype=torch.float64)
    _build.reset_launch_counts()
    plan(X, torch.zeros((3, 6, 4), dtype=torch.float64),
         torch.ones(3, dtype=torch.float64))
    assert [c[0] for c in lib.calls[-3:]] == ["eu_resident_recurrence_f64"] * 3
    assert _build.launches["resident_recurrence"] == 3
    assert _build.launches["resident_recurrence_batched"] == 0

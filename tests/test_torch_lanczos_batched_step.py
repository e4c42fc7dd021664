"""PyTorch port vs JAX package: the fused batched Lanczos step
(``ops/kernels/lanczos_step.py``, the step of ``ops/krylov.py``'s batched
``lanczos`` and ``lanczos_coeffs`` on a ``BandedOperator``) on the CPU,
where the step runs the pair's plain twin.

The batched builders are held against three references on the same
seeded rows: JAX's builders under ``jax.vmap`` (as
``models/expv._batched_build`` calls them), the unfused batched step (the
same operator behind a wrapper that is no ``BandedOperator``) and each
row's scalar builder. Rows: random, zero, and an eigenvector (a
breakdown at step 1), ``broke`` and ``m_used`` equal row for row. Records
to 1e-13 of their scale in float64 and 1e-5 in float32; the basis to
1e-12 / 1e-4 (it absorbs the recurrence's loss of orthogonality, as in
``tests/test_torch_krylov.py``). The gate and the pair's launch
descriptor are checked on a stand-in library
(``torch_parity.use_fake_kernel_library``)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_torch.ops import krylov as tk
from exponentialutilities_jl_torch.ops.kernels import lanczos_step as tl
from exponentialutilities_jl_torch.utils.linop import LinearOperator
from exponentialutilities_jl_tpu.ops import krylov as jk
from torch_parity import assert_close, t2n, use_fake_kernel_library

torch.set_num_threads(2)

M = 12
TOL = {torch.float64: 1e-7, torch.float32: 1e-4}   # breakdown threshold
REC = {torch.float64: 1e-13, torch.float32: 1e-5}  # the records
BASIS = {torch.float64: 1e-12, torch.float32: 1e-4}
NP_DT = {torch.float64: np.float64, torch.float32: np.float32}


class Unfused(LinearOperator):
    """The operator behind a wrapper that is no ``BandedOperator``: the
    builders take their unfused step (the same matmat)."""

    def __init__(self, op):
        self.op = op
        self.is_hermitian = True

    shape = property(lambda self: self.op.shape)
    dtype = property(lambda self: self.op.dtype)

    def matvec(self, x):
        return self.op.matvec(x)

    def matmat(self, X):
        return self.op.matmat(X)


def _no_zero_offset(n):
    """A symmetric band with offsets (-3, -1, 1, 3) and no diagonal."""
    g = np.random.default_rng(3)
    A = sp.diags([g.uniform(0.5, 1.5, n - 1), g.uniform(0.2, 0.8, n - 3)],
                 [1, 3], shape=(n, n))
    return (A + A.T).tocsr()


def _operators(kind, dt):
    """(JAX operator, torch BandedOperator, dense numpy matrix)."""
    if kind == "poisson":
        top = et.poisson_2d(24, 24, dtype=dt)
        jop = ej.poisson_2d(24, 24, dtype=jnp.dtype(NP_DT[dt]))
        return jop, top, t2n(top.to_dense())
    A = _no_zero_offset(300)
    offs = (-3, -1, 1, 3)
    top = et.banded_from_scipy(A, offsets=offs, is_hermitian=True,
                               dtype=NP_DT[dt])
    jop = ej.banded_from_scipy(A, offsets=offs, is_hermitian=True,
                               dtype=jnp.dtype(NP_DT[dt]))
    return jop, top, A.toarray()


def _rows(A, batch, dt, seed):
    """(batch, n) rows: random, then (batch >= 2) a zero row, (batch >= 3)
    a unit eigenvector of A (a breakdown at step 1)."""
    g = np.random.default_rng(seed)
    B = g.standard_normal((batch, A.shape[0]))
    if batch >= 2:
        B[1] = 0.0
    if batch >= 3:
        B[2] = np.linalg.eigh(A)[1][:, A.shape[0] // 3]
    return B.astype(NP_DT[dt])


def _jax_build(jop, B, builder, tol):
    f = {"lanczos": lambda b: jk.lanczos(jop, b, M, tol=tol),
         "lanczos_coeffs": lambda b: jk.lanczos_coeffs(jop, b, M, tol=tol)}
    return jax.vmap(f[builder])(jnp.asarray(B))


def _fields(out, builder):
    """{name: numpy array} of a builder's result."""
    if builder == "lanczos":
        names = ("H", "V", "beta", "m_used", "breakdown")
        return {k: np.asarray(t2n(getattr(out, k)) if isinstance(
            getattr(out, k), torch.Tensor) else getattr(out, k))
            for k in names}
    names = ("alphas", "betas", "beta0", "m_used", "breakdown")
    return {k: np.asarray(t2n(v) if isinstance(v, torch.Tensor) else v)
            for k, v in zip(names, out)}


def _compare(got, want, dt, what):
    for k, w in want.items():
        g = got[k]
        if k in ("m_used", "breakdown"):
            assert g.astype(np.int64).tolist() == np.asarray(w).astype(
                np.int64).tolist(), (what, k)
        else:
            assert_close(g, np.asarray(w), BASIS[dt] if k == "V" else REC[dt],
                         f"{what} {k}")


def _stack_rows(outs, builder):
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("builder", ["lanczos", "lanczos_coeffs"])
@pytest.mark.parametrize("batch", [1, 3, 17])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["poisson", "no zero offset"])
def test_fused_builders_vs_references(kind, dt, batch, builder):
    """The fused batched builder against JAX's vmapped builder, the
    unfused batched step and each row's scalar builder; the zero row stays
    zero and the eigenvector row breaks down at step 1."""
    jop, top, A = _operators(kind, dt)
    B = _rows(A, batch, dt, 40 + batch)
    tol = TOL[dt]
    Bt = torch.as_tensor(B)
    fn = getattr(tk, builder)
    got = _fields(fn(top, Bt, M, tol=tol), builder)
    jax_out = _jax_build(jop, B, builder, tol)
    want = (_fields(jax_out, builder) if builder == "lanczos_coeffs" else
            {k: np.asarray(getattr(jax_out, k)) for k in
             ("H", "V", "beta", "m_used", "breakdown")})
    _compare(got, want, dt, "vs JAX")
    _compare(got, _fields(fn(Unfused(top), Bt, M, tol=tol), builder), dt,
             "vs the unfused step")
    rows = _stack_rows([_fields(fn(top, Bt[i], M, tol=tol), builder)
                        for i in range(batch)], builder)
    _compare(got, rows, dt, "vs each row's scalar builder")
    if batch >= 3:
        assert got["m_used"].tolist()[1:3] == [0, 1]
        assert got["breakdown"].tolist()[1:3] == [True, True]
        if builder == "lanczos":
            assert not got["V"][1].any()
            assert not got["V"][2, 2:].any()


@pytest.mark.parametrize("nslots", [0, 2])
@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("kind", ["poisson", "no zero offset"])
def test_pair_twin_vs_unfused_step(kind, j, nslots):
    """One step of the pair's twin against the unfused step on the same
    state at step j (basis slots or the ring): v_j, the records, ``broke``
    and ``m_used``; a row broken down before the step keeps its records
    at zero."""
    dt = torch.float64
    _, top, A = _operators(kind, dt)
    g = np.random.default_rng(5 + j)
    batch, n, m = 4, A.shape[0], 6
    u = torch.as_tensor(g.standard_normal((batch, n)))
    scale = torch.as_tensor(g.uniform(0.5, 2.0, batch))
    broke = torch.tensor([False, True, False, False])
    vc_want = torch.where(broke[:, None], 0.0, u * scale[:, None])
    vp = torch.as_tensor(g.standard_normal((batch, n))) if j else \
        torch.zeros((batch, n), dtype=dt)
    bprev = torch.as_tensor(g.uniform(0.5, 1.0, batch)) if j else \
        torch.zeros(batch, dtype=dt)
    slots = torch.zeros((batch, m + 1 if nslots == 0 else 2, n), dtype=dt)
    if j:
        slots[:, j - 1 if nslots == 0 else (j - 1) % 2] = vp
    S = tk._State(torch.device("cpu"), start=j, lead=1, vp=vp.clone(),
                  vc=vc_want.clone(), bprev=bprev.clone(),
                  broke=broke.clone(),
                  m_used=torch.full((batch,), j, dtype=torch.int64),
                  alphas=torch.zeros((batch, m), dtype=dt),
                  betas=torch.zeros((batch, m), dtype=dt))
    S.rebind = False
    tk._lanczos_step(Unfused(top), S, 1e-7, None)()
    pair = tl.LanczosPair(top, u.clone(), scale.clone(), slots, nslots,
                          torch.zeros((batch, m), dtype=dt),
                          torch.zeros((batch, m), dtype=dt), bprev.clone(),
                          broke.clone(),
                          torch.full((batch,), j, dtype=torch.int64),
                          torch.tensor([j, j + 1]), 1e-7)
    pair()
    slot = j if nslots == 0 else j % 2
    assert torch.equal(pair.slots[:, slot], vc_want)
    assert_close(t2n(pair.alphas), t2n(S.alphas), 1e-13, "alphas")
    assert_close(t2n(pair.betas), t2n(S.betas), 1e-13, "betas")
    assert_close(t2n(pair.bprev), t2n(S.bprev), 1e-13, "bprev")
    assert torch.equal(pair.broke, S.broke)
    assert torch.equal(pair.m_used, S.m_used)
    assert pair.m_used.tolist() == [j + 1, j, j + 1, j + 1]
    assert float(pair.alphas[1].abs().max()) == 0.0
    # the next vector: u scale is the unfused step's normalized v_{j+1}
    assert_close(t2n(pair.last_row()), t2n(S.vc), 1e-13, "v_{j+1}")


def _invariant_rows(A, m, seed):
    """(3, n) rows: random, then the sums of m and of m + 1 eigenvectors
    of A with distinct, well-separated eigenvalues (Lanczos breaks down at
    its last step m, and not within m steps)."""
    w, Q = np.linalg.eigh(A)
    pick = [0]
    for i in range(1, len(w)):
        if len(pick) == m + 1:
            break
        if w[i] - w[pick[-1]] > (w[-1] - w[0]) / (4 * m):
            pick.append(i)
    assert len(pick) == m + 1
    B = np.random.default_rng(seed).standard_normal((3, A.shape[0]))
    B[1] = Q[:, pick[:m]].sum(1)
    B[2] = Q[:, pick].sum(1)
    return B


@pytest.mark.parametrize("builder", ["lanczos", "lanczos_coeffs"])
@pytest.mark.parametrize("m", [3, 5, 8])
@pytest.mark.parametrize("kind", ["poisson", "no zero offset"])
def test_breakdown_at_the_last_step(kind, m, builder):
    """The fused step's twin on a row that breaks down at the last step m
    (an invariant subspace of dimension exactly m) and one that does not
    (m + 1): ``broke`` and ``m_used`` as the unfused step and each row's
    scalar builder, the records within their tolerance. The breakdown's
    beta is rounding noise (1e-11 at m = 5, up to 3e-7 at m = 8, the
    other betas above 0.2), so the threshold is 1e-5 and the betas below
    it are compared as zero. Near an invariant subspace the basis loses
    orthogonality: its rounding grows ~10x a step in every form (at m = 8
    4e-10 between the unfused and fused steps, 5e-9 against the scalar
    builder), so the basis is compared on the random row only."""
    dt, tol = torch.float64, 1e-5
    _, top, A = _operators(kind, dt)
    Bt = torch.as_tensor(_invariant_rows(A, m, 60 + m))
    fn = getattr(tk, builder)

    def run(op, b):
        f = _fields(fn(op, b, m, tol=tol), builder)
        for k in ("H", "beta", "betas"):
            if k in f:
                f[k] = np.where(np.abs(f[k]) < tol, 0.0, f[k])
        return f

    got = run(top, Bt)
    refs = {"vs the unfused step": run(Unfused(top), Bt),
            "vs each row's scalar builder": _stack_rows(
                [run(top, Bt[i]) for i in range(3)], builder)}
    for what, want in refs.items():
        if "V" in want:
            assert_close(got["V"][0], want.pop("V")[0], BASIS[dt],
                         f"{what} V")
        _compare(got, want, dt, what)
    assert got["m_used"].tolist() == [m, m, m]
    assert got["breakdown"].tolist() == [False, True, False]


def _gate_builds(monkeypatch):
    """The ``u`` of each fused step the builders make."""
    made = []
    real = tl.LanczosPair

    def counting(*args, **kw):
        made.append(args[1])
        return real(*args, **kw)

    monkeypatch.setattr(tl, "LanczosPair", counting)
    return made


@pytest.mark.parametrize("case,fused", [
    ("float64 block", True), ("float32 operator, float64 block", True),
    ("float32 block", True), ("complex rows", False),
    ("transposed block", True), ("scalar b", False), ("full_reorth", False),
    ("full_reorth=1", False), ("b requires grad", False),
    ("diagonals require grad", False), ("stencil operator", False),
    ("batch above MAX_BATCH", False)])
def test_gate_routes(monkeypatch, case, fused):
    """``_fused_ok``: the fused step only for a real (batch, n) block on a
    ``BandedOperator`` with nothing autograd must see and no
    ``full_reorth`` (by truth value, as the unfused step reads it); every
    other case keeps the unfused step and its result. The pair's ``u`` is
    contiguous also for a transposed block."""
    made = _gate_builds(monkeypatch)
    top = et.poisson_2d(8, 8)
    g = np.random.default_rng(9)
    B = torch.as_tensor(g.standard_normal((3, 64)))
    kw = {}
    if case == "float32 operator, float64 block":
        top = et.poisson_2d(8, 8, dtype=torch.float32)
    elif case == "float32 block":
        top, B = et.poisson_2d(8, 8, dtype=torch.float32), B.float()
    elif case == "complex rows":
        B = B + 1j * B
    elif case == "transposed block":
        B = torch.as_tensor(g.standard_normal((64, 3))).T
    elif case == "scalar b":
        B = B[0]
    elif case == "full_reorth":
        kw = {"full_reorth": True}
    elif case == "full_reorth=1":
        kw = {"full_reorth": 1}
    elif case == "b requires grad":
        B.requires_grad_()
    elif case == "diagonals require grad":
        top.diags.requires_grad_()
    elif case == "stencil operator":
        top = et.laplacian_nd_stencil(8, 8)
    elif case == "batch above MAX_BATCH":
        B = torch.as_tensor(g.standard_normal((tl.MAX_BATCH + 1, 64)))
    K = tk.lanczos(top, B, 5, **kw)
    assert len(made) == int(fused)
    assert all(u.is_contiguous() for u in made)
    ref = tk.lanczos(Unfused(top), B, 5, **kw)
    assert_close(t2n(K.H.detach()), t2n(ref.H.detach()), 1e-5, case)


def test_gate_comm():
    """A row-sharded operator's axis keeps the unfused step."""
    top = et.poisson_2d(8, 8)
    B = torch.ones((2, 64), dtype=torch.float64)
    _, S = tk._lanczos_state(B, None)
    assert tk._fused_ok(top, S, None, False)
    assert not tk._fused_ok(top, S, object(), False)


def test_pair_launch_descriptor(monkeypatch):
    """The pair's host logic on a stand-in library: the descriptor carries
    the plan's diagonals, offsets and interior range, the state's pointers
    and strides, the zero offset's index and the grid the queries chose
    (the partials sized for it); a step is two launches, one count each;
    a state of the wrong dtype is refused before any pointer is passed."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    def grid(field, value):
        def query(addr):
            setattr(tl._LanczosLaunch.from_address(addr), field, value)
            return 0
        return query

    lib = use_fake_kernel_library(monkeypatch, returns={
        "eu_banded_spmm_alpha_grid_f64": grid("grid_alpha", 7),
        "eu_lanczos_update_grid_f64": grid("grid_update", 5)})
    top = et.poisson_2d(16, 16)
    batch, n, m = 3, 256, 4
    dt = torch.float64
    u = torch.zeros((batch, n), dtype=dt)
    V = torch.zeros((batch, m + 1, n), dtype=dt)
    st = dict(scale=torch.ones(batch, dtype=dt),
              alphas=torch.zeros((batch, m), dtype=dt),
              betas=torch.zeros((batch, m), dtype=dt),
              bprev=torch.zeros(batch, dtype=dt),
              broke=torch.zeros(batch, dtype=torch.bool),
              m_used=torch.zeros(batch, dtype=torch.int64),
              jj=torch.tensor([0, 1]))
    pair = tl.LanczosPair(top, u, st["scale"], V, 0, st["alphas"],
                          st["betas"], st["bprev"], st["broke"],
                          st["m_used"], st["jj"], 1e-7)
    pair._build_launch()
    d = pair.launch
    plan = top.plan(dt, u.device)
    assert (d.diags, d.n, d.blo, d.bhi, d.k) == (
        plan.launch.diags, n, plan.launch.blo, plan.launch.bhi, 5)
    assert list(d.o[:5]) == [-16, -1, 0, 1, 16]
    assert (d.u, d.v, d.urow, d.vrow, d.vslot) == (
        u.data_ptr(), V.data_ptr(), n, (m + 1) * n, n)
    assert (d.nslots, d.batch, d.m, d.zc, d.tol) == (0, batch, m, 2, 1e-7)
    assert (d.scale, d.broke, d.m_used, d.jj) == (
        st["scale"].data_ptr(), st["broke"].data_ptr(),
        st["m_used"].data_ptr(), st["jj"].data_ptr())
    assert (d.grid_alpha, d.grid_update) == (7, 5)
    assert pair.partial.shape == (7, batch) and d.partial == \
        pair.partial.data_ptr()
    assert ctypes.sizeof(tl._LanczosLaunch) == 448
    assert tl._LanczosLaunch.u.offset == 296
    assert tl._LanczosLaunch.tol.offset == 432
    pair.kernel = True
    lib.calls.clear()
    _build.reset_launch_counts()
    pair()
    assert [c[0] for c in lib.calls] == ["eu_banded_spmm_alpha_f64",
                                          "eu_lanczos_update_f64"]
    assert all(c[1] == (pair.addr, 0) for c in lib.calls)
    assert (_build.launches["banded_spmm_alpha"],
            _build.launches["lanczos_update"]) == (1, 1)
    bad = tl.LanczosPair(top, u, st["scale"], V, 0, st["alphas"],
                         st["betas"], st["bprev"], st["broke"],
                         st["m_used"].int(), st["jj"], 1e-7)
    with pytest.raises(ValueError):
        bad._build_launch()

"""PyTorch port vs JAX package and scipy: the unstructured sparse
containers (ops/sparse.py: SellOperator in every mode, SortedSellOperator,
HybridOperator) and the plain twins of their kernels (B9 ``sell_spmv``,
B10 ``seg_compact``; ops/kernels/sell.py). Same seeded numpy inputs
through both packages, float64 unless stated; results compared in the
original basis.

The port packs SELL-C-sigma, the JAX package its TPU window layouts, so
the two agree on y = A x and not on the arrays. Tolerances (norm-scaled,
tests/torch_parity.py): RTOL64 for products and Chebyshev actions (same
products, another summation order); RTOL32 against the JAX Pallas
kernels in interpret mode (float32, at the smallest shape); 1e2 RTOL64
for the Krylov actions, as in tests/test_torch_expv.py; 1e-10 against
scipy's expm_multiply (the BASELINE target)."""

import ctypes

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import exponentialutilities_jl_tpu as ej
import exponentialutilities_jl_torch as et
from exponentialutilities_jl_tpu.ops.kernels import sell as jsell
from exponentialutilities_jl_torch.ops.kernels import sell as tsell
from torch_parity import (RTOL32, RTOL64, assert_close, t2n,
                          use_fake_kernel_library)

torch.set_num_threads(2)

MODES = [None, "bucketed", "seg", "sorted"]


def _scattered(n, seed, band=120):
    """The scattered-degree class of benchmarks/bench_sorted.py (degrees
    6/20/40 shuffled), with three empty rows and duplicate entries."""
    rng = np.random.default_rng(seed)
    deg = np.full(n, 6, np.int64)
    deg[int(0.85 * n):int(0.95 * n)] = 20
    deg[int(0.95 * n):] = 40
    rng.shuffle(deg)
    deg[[1, n // 2, n - 1]] = 0
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rng.integers(-band, band, rows.size), 0, n - 1)
    vals = rng.standard_normal(rows.size) / deg[rows]
    dup = rng.integers(0, rows.size, 50)
    return (np.concatenate([rows, rows[dup]]), np.concatenate([cols, cols[dup]]),
            np.concatenate([vals, vals[dup]]))


def _sym(rows, cols, vals, n):
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return (0.5 * (A + A.T)).tocoo()


def _both(A, **kw):
    kw.setdefault("dtype", np.float64)
    return (ej.SellOperator.from_coo(A.row, A.col, A.data, A.shape[0], **kw),
            et.SellOperator.from_coo(A.row, A.col, A.data, A.shape[0], **kw))


@pytest.mark.parametrize("mode", MODES)
def test_sell_matvec_vs_jax(mode):
    n = 2048
    r, c, v = _scattered(n, 0)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n))
    jop, top = _both(A, mode=mode)
    assert type(top).__name__ == type(jop).__name__
    x = np.random.default_rng(1).standard_normal(n)
    y = t2n(top.matvec(torch.as_tensor(x)))
    assert_close(y, np.asarray(jop.matvec(jnp.asarray(x))), RTOL64, "vs JAX")
    assert_close(y, A.tocsr() @ x, RTOL64, "vs scipy")
    assert top.nnz == jop.nnz
    assert float(top.opnorm_hint()) == pytest.approx(
        np.abs(A.tocsr()).sum(axis=1).max())


def test_sell_rcm_matches_jax_permutation():
    n = 2048
    A = _sym(*_scattered(n, 2, band=400), n)
    p = np.random.default_rng(3).permutation(n)           # scramble
    A = A.tocsr()[p][:, p].tocoo()
    jop, top = _both(A, rcm=True)
    np.testing.assert_array_equal(top.perm, jop.perm)
    x = np.random.default_rng(4).standard_normal(n)
    xp = x[top.perm]
    y = t2n(top.matvec(torch.as_tensor(xp)))
    assert_close(y, np.asarray(jop.matvec(jnp.asarray(xp))), RTOL64, "vs JAX")
    back = np.empty(n)
    back[top.perm] = y
    assert_close(back, A.tocsr() @ x, RTOL64, "original basis")


def test_sell_twin_vs_jax_interpret():
    """B9's twin against the JAX Pallas kernel in interpret mode (float32,
    the smallest shape of the JAX package's own test)."""
    n = 1024
    r, c, v = _scattered(n, 5)
    v = v.astype(np.float32)
    x = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    jy = jsell.sell_spmv(jsell.sell_pack((r, c, v), n), jnp.asarray(x),
                         interpret=True)
    ty = tsell.sell_spmv(tsell.sell_pack((r, c, v), n), torch.as_tensor(x))
    assert ty.dtype == torch.float32
    assert_close(t2n(ty), np.asarray(jy), RTOL32, "B9 twin vs interpret")


def test_seg_twin_vs_jax_interpret():
    """B9 then B10 (twins) against the JAX segmented product in interpret
    mode, its compaction kernel included (float32)."""
    n = 1024
    r, c, v = _scattered(n, 7)
    v = v.astype(np.float32)
    x = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    jy = jsell.sell_spmv_seg(jsell.sell_pack_seg((r, c, v), n),
                             jnp.asarray(x), interpret=True)
    pk = tsell.sell_pack_seg((r, c, v), n, seg_len=16)
    ty = tsell.sell_spmv_seg(pk, torch.as_tensor(x))
    assert_close(t2n(ty), np.asarray(jy), RTOL32, "seg vs interpret")


@pytest.mark.parametrize("mode", [None, "seg"])
def test_wide_band_vs_scipy(mode):
    """A band of 20,000 columns: the JAX packs refuse it (the TPU gather
    window); the SELL-C-sigma pack takes it and matches scipy."""
    n = 20000
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(n), 8)
    cols = np.clip(rows + rng.integers(-10000, 10000, rows.size), 0, n - 1)
    vals = rng.standard_normal(rows.size)
    jpack = jsell.sell_pack_seg if mode == "seg" else jsell.sell_pack
    with pytest.raises(ValueError):
        jpack((rows, cols, vals), n)
    op = et.SellOperator.from_coo(rows, cols, vals, n, dtype=np.float64,
                                  mode=mode)
    x = rng.standard_normal(n)
    want = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr() @ x
    assert_close(t2n(op.matvec(torch.as_tensor(x))), want, RTOL64, "vs scipy")


def test_pack_layout():
    """SELL-C-sigma invariants: every row packed once, slices as wide as
    their longest row, rows sorted by degree inside each sigma window,
    segments at most seg_len long."""
    n = 1000
    r, c, v = _scattered(n, 10)
    d = tsell.sell_pack((r, c, v), n, dtype=np.float64, sigma=64)
    row_of = t2n(d.row_of)
    np.testing.assert_array_equal(np.sort(row_of), np.arange(n))
    deg = np.diff(sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr().indptr)
    pdeg = deg[row_of]
    assert (np.diff(row_of // 64) >= 0).all()              # windows kept
    for w0 in range(0, n, 64):
        assert (np.diff(pdeg[w0:w0 + 64]) <= 0).all()       # longest first
    width = np.diff(t2n(d.slice_ptr)) // tsell.SLICE
    padded = np.zeros(d.nslices * tsell.SLICE, np.int64)
    padded[:n] = pdeg
    np.testing.assert_array_equal(width, padded.reshape(-1, 32).max(axis=1))
    s = tsell.sell_pack_seg((r, c, v), n, dtype=np.float64, seg_len=8)
    seg_deg = np.diff(t2n(s.seg_ptr))
    np.testing.assert_array_equal(seg_deg, -(-deg // 8))
    assert s.base.n == seg_deg.sum()
    assert int(np.diff(t2n(s.base.slice_ptr)).max()) <= 8 * tsell.SLICE
    with pytest.raises(ValueError, match="mode"):
        et.SellOperator.from_coo(r, c, v, n, mode="subrol")


@pytest.mark.parametrize("mode", [None, "seg", "sorted"])
def test_sell_actions_vs_jax(mode):
    """expv (happy breakdown, two-pass), phiv and expv_chebyshev on each
    SELL container, port vs JAX; the sorted container's conjugation is
    hoisted in both packages and the results are in the original basis."""
    n = 1024
    A = _sym(*_scattered(n, 11), n)
    jop, top = _both(A, mode=mode, is_hermitian=True)
    b = np.random.default_rng(12).standard_normal(n)
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    rtol = 1e2 * RTOL64
    w = t2n(et.expv(0.5, top, tb, m=30))
    assert_close(w, np.asarray(ej.expv(0.5, jop, jb, m=30)), rtol, "expv")
    assert_close(w, spla.expm_multiply(0.5 * A.tocsr(), b), 1e-10, "scipy")
    assert_close(t2n(et.expv(0.5, top, tb, m=30, two_pass=True)), w, rtol,
                 "two-pass")
    assert_close(t2n(et.phiv(0.5, top, tb, 2, m=30)),
                 np.asarray(ej.phiv(0.5, jop, jb, 2, m=30)), rtol, "phiv")
    bounds = (-2.0, 2.0)
    assert_close(t2n(et.expv_chebyshev(0.5, top, tb, bounds=bounds,
                                       tol=1e-12)),
                 np.asarray(ej.expv_chebyshev(0.5, jop, jb, bounds=bounds,
                                              tol=1e-12)), RTOL64, "cheb")


def test_sorted_conjugation():
    n = 1024
    A = _sym(*_scattered(n, 13), n)
    jop, top = _both(A, mode="sorted", rcm=True, is_hermitian=True)
    np.testing.assert_array_equal(t2n(top.order), np.asarray(jop.order))
    x = np.random.default_rng(14).standard_normal((n, 2))
    tx = torch.as_tensor(x)
    np.testing.assert_array_equal(t2n(top.permute(tx)), x[t2n(top.order)])
    np.testing.assert_array_equal(t2n(top.unpermute(top.permute(tx))), x)
    inner, pb, post = et.hoist_conjugation(top, tx[:, 0])
    assert inner is top.inner and post == top.unpermute
    assert_close(t2n(post(inner.matvec(pb))), t2n(top.matvec(tx[:, 0])),
                 RTOL64, "hoisted matvec")
    # rcm composed in: the operator maps original-basis vectors
    assert_close(t2n(top.matvec(tx[:, 0])), A.tocsr() @ x[:, 0], RTOL64,
                 "vs scipy")


def test_hybrid_vs_jax():
    """Poisson diagonals plus a random residual: the dense diagonals go to
    B7, the rest to B9, as in the JAX split."""
    P = sp.csr_matrix(np.asarray(ej.poisson_2d(32, 32).to_dense()))
    rng = np.random.default_rng(15)
    n = P.shape[0]
    R = sp.coo_matrix((rng.standard_normal(2 * n) * 0.1,
                       (rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n))),
                      shape=(n, n))
    A = (P + R + R.T).tocoo()
    kw = dict(min_fill=0.4, dtype=np.float64, is_hermitian=True)
    jh, th = ej.hybrid_from_scipy(A, **kw), et.hybrid_from_scipy(A, **kw)
    assert th.banded.offsets == jh.banded.offsets == (-32, -1, 0, 1, 32)
    np.testing.assert_array_equal(t2n(th.banded.diags),
                                  np.asarray(jh.banded.diags))
    assert th.nnz == jh.nnz
    b = rng.standard_normal(n)
    assert_close(t2n(th.matvec(torch.as_tensor(b))), A.tocsr() @ b, RTOL64,
                 "matvec")
    assert_close(t2n(et.expv(0.05, th, torch.as_tensor(b), m=30)),
                 np.asarray(ej.expv(0.05, jh, jnp.asarray(b), m=30)),
                 1e2 * RTOL64, "expv")


def test_save_load_roundtrip(tmp_path):
    n = 700
    r, c, v = _scattered(n, 16)
    x = torch.as_tensor(np.random.default_rng(17).standard_normal(n))
    for cls, pack in ((tsell.SellData, tsell.sell_pack),
                      (tsell.SellBucketed, tsell.sell_pack_bucketed),
                      (tsell.SellSeg, tsell.sell_pack_seg)):
        d = pack((r, c, v), n, dtype=np.float64)
        path = str(tmp_path / cls.__name__)
        d.save(path)
        d2 = cls.load(path)
        assert type(d2) is cls
        ref = (tsell.sell_spmv_seg_ref if cls is tsell.SellSeg
               else tsell.sell_spmv_ref)
        assert torch.equal(ref(d, x), ref(d2, x))
    op = et.SellOperator.from_coo(r, c, v, n, dtype=np.float64, mode="sorted")
    op.save(str(tmp_path / "sorted"))
    op2 = et.SortedSellOperator.load(str(tmp_path / "sorted"))
    assert torch.equal(op.matvec(x), op2.matvec(x))


@pytest.mark.parametrize("fault", ["column", "row", "slice_ptr", "slots"])
def test_load_rejects_a_broken_pack(tmp_path, fault):
    """A loaded pack is checked once: B9 gathers x and scatters y by its
    indices unchecked, so an index out of range or a slice_ptr that does
    not match the arrays is refused before any launch."""
    n = 300
    d = tsell.sell_pack(_scattered(n, 18), n, dtype=np.float64)
    f = {k: v.clone() for k, v in d._fields().items()}
    if fault == "column":
        f["cols"][5] = n
    elif fault == "row":
        f["row_of"][0] = -1
    elif fault == "slice_ptr":
        f["slice_ptr"][1] += 1
    else:
        f["vals"], f["cols"] = f["vals"][:-32], f["cols"][:-32]
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{k: v.numpy() for k, v in f.items()},
             meta=np.asarray([d.n, d.ncols, d.nnz, d.sigma], np.int64))
    with pytest.raises(ValueError, match="SELL pack"):
        tsell.SellData.load(path)


def test_seg_pack_checks_seg_ptr():
    n = 300
    s = tsell.sell_pack_seg(_scattered(n, 19), n, dtype=np.float64)
    assert tsell.SellSeg(s.base, s.seg_ptr, n, s.nnz).n == n     # valid
    bad = s.seg_ptr.clone()
    bad[-1] += 1                        # one partial past the segments
    with pytest.raises(ValueError, match="seg_ptr"):
        tsell.SellSeg(s.base, bad, n, s.nnz)
    with pytest.raises(ValueError, match="seg_ptr"):
        tsell.SellSeg(s.base, s.seg_ptr[:-1], n, s.nnz)


PACKS = {"default": tsell.sell_pack, "bucketed": tsell.sell_pack_bucketed,
         "seg": lambda coo, n, **kw: tsell.sell_pack_seg(coo, n, seg_len=8,
                                                         **kw)}


def _with_empty_slice(n=1000, seed=21):
    """The scattered class with rows 0..39 empty: the degree sort puts them
    last in the first 256-row window, so packed rows 224..255 form a slice
    without entries; n = 1000 leaves a last slice of 8 rows."""
    r, c, v = _scattered(n, seed)
    keep = r >= 40
    return r[keep], c[keep], v[keep]


def _packed_columns(kind, pk, coo, n):
    """(base pack, the columns of each of its packed rows) from scipy's CSR
    of the same COO (duplicates summed), independent of the packer."""
    A = sp.coo_matrix((coo[2], coo[:2]), shape=(n, n)).tocsr()
    A.sum_duplicates()
    rows = [A.indices[A.indptr[i]:A.indptr[i + 1]] for i in range(n)]
    if kind == "seg":
        seg_ptr = t2n(pk.seg_ptr)
        segs = []
        for i in range(n):
            for k in range(seg_ptr[i + 1] - seg_ptr[i]):
                segs.append(rows[i][8 * k:8 * (k + 1)])
        rows, pk = segs, pk.base
    return pk, [rows[i] for i in t2n(pk.row_of)]


@pytest.mark.parametrize("kind", list(PACKS))
def test_spans_cover_each_slice(kind):
    """spans[s] is the min and max column over slice s's entries ([0, -1]
    for a slice without any), and every padded slot holds value 0 and the
    column lo_s; the twin's product is scipy's on every pack."""
    n = 1000
    coo = _with_empty_slice(n)
    pk = PACKS[kind](coo, n, dtype=np.float64)
    x = np.random.default_rng(22).standard_normal(n)
    ref = tsell.sell_spmv_seg_ref if kind == "seg" else tsell.sell_spmv_ref
    assert_close(t2n(ref(pk, torch.as_tensor(x))),
                 sp.coo_matrix((coo[2], coo[:2]), shape=(n, n)).tocsr() @ x,
                 RTOL64, "twin vs scipy")
    base, cols_of = _packed_columns(kind, pk, coo, n)
    spans, sptr = t2n(base.spans), t2n(base.slice_ptr)
    vals, cols = t2n(base.vals), t2n(base.cols)
    assert spans.dtype == np.int32 and spans.shape == (base.nslices, 2)
    empty = 0
    for s in range(base.nslices):
        real = [c for r in range(32 * s, min(32 * s + 32, base.n))
                for c in cols_of[r]]
        want = (min(real), max(real)) if real else (0, -1)
        assert tuple(spans[s]) == want, s
        empty += not real
        width = (sptr[s + 1] - sptr[s]) // 32
        for r in range(32):
            p = 32 * s + r
            deg = len(cols_of[p]) if p < base.n else 0
            pad = sptr[s] + 32 * np.arange(deg, width) + r
            assert not vals[pad].any()
            assert (cols[pad] == spans[s, 0]).all()
    assert empty >= (kind == "default")     # the slice of rows 0..39


def _windows_ref(spans, vec=4):
    """Per 8-slice block: the union of the non-empty spans from a
    vec-aligned start, rounded up to whole vec pieces (0 if none)."""
    out = []
    for b in range(0, len(spans), 8):
        live = [(lo, hi) for lo, hi in spans[b:b + 8] if hi >= lo]
        if not live:
            out.append(0)
            continue
        lo = min(l for l, _ in live)
        hi = max(h for _, h in live)
        start = lo - lo % vec
        out.append(-(-(hi + 1 - start) // vec) * vec)
    return np.asarray(out)


@pytest.mark.parametrize("band,far", [(300, 0), (20000, 0), (300, 6)])
def test_stage_windows_and_cap(band, far):
    """The B9 blocks' x windows, the launch's stage_cap (the largest window
    within STAGE_ELEMS) and which blocks stage: all for a narrow band, none
    for a band wider than the budget, some when a few rows reach far."""
    n = 30000 if band > 1000 else 20000
    rng = np.random.default_rng(23)
    rows = np.repeat(np.arange(n), 8)
    cols = np.clip(rows + rng.integers(-band // 2, band // 2, rows.size), 0,
                   n - 1)
    vals = rng.standard_normal(rows.size)
    if far:
        hit = rng.choice(n, far, replace=False)
        rows = np.concatenate([rows, hit])
        cols = np.concatenate([cols, (hit + n // 2) % n])
        vals = np.concatenate([vals, np.ones(far)])
    d = tsell.sell_pack((rows, cols, vals), n, dtype=np.float64)
    spans = [tuple(s) for s in t2n(d.spans)]
    win = _windows_ref(spans)
    np.testing.assert_array_equal(t2n(tsell._block_windows(d.spans)), win)
    fit = win[win <= tsell.STAGE_ELEMS]
    assert d.stage_cap == (fit.max() if fit.size else 0)
    staged = t2n(tsell.stage_blocks(d))
    np.testing.assert_array_equal(
        staged, (_windows_ref(spans, vec=2) > 0)
        & (_windows_ref(spans, vec=2) <= d.stage_cap))
    if band > 1000:
        assert d.stage_cap == 0 and not staged.any()
    elif far:
        assert 0 < staged.sum() < staged.size
    else:
        assert staged.all()
    d32 = d.to(dtype=torch.float32)
    np.testing.assert_array_equal(t2n(tsell.stage_blocks(d32)),
                                  (win > 0) & (win <= d.stage_cap))


@pytest.mark.parametrize("kind", list(PACKS))
def test_spans_derived_when_checked(tmp_path, kind):
    """A pack loaded from a file, or built by hand from its arrays, derives
    its spans and stage_cap on its device when it is checked: the packer's
    values. ``to`` and ``with_vals`` keep them."""
    n = 1000
    pk = PACKS[kind]((_with_empty_slice(n, 24)), n, dtype=np.float64)
    base = pk.base if kind == "seg" else pk
    f = base._fields()
    hand = tsell.SellData(*(f[k] for k in ("vals", "cols", "slice_ptr",
                                           "row_of")), base.n, base.nnz,
                          ncols=base.ncols, sigma=base.sigma)
    path = str(tmp_path / kind)
    pk.save(path)
    loaded = type(pk).load(path)
    loaded = loaded.base if kind == "seg" else loaded
    for other in (hand, loaded, base.to(dtype=torch.float32),
                  base.with_vals(base.vals.abs())):
        assert torch.equal(other.spans, base.spans)
        assert other.stage_cap == base.stage_cap
        assert other.nslots == base.nslots
    with np.load(path + ".npz") as z:
        assert "spans" not in z.files          # the file format is unchanged


@pytest.mark.parametrize("kind", list(PACKS))
def test_pack_with_padding_at_column_0_loads_like_a_fresh_one(tmp_path,
                                                               kind):
    """A pack whose padded slots hold column 0 (what earlier versions
    saved) loads with the fresh pack's spans and stage_cap: every value-0
    slot is pointed at its slice's lowest column before the spans are
    derived. The product does not change."""
    n = 1000
    pk = PACKS[kind](_with_empty_slice(n, 26), n, dtype=np.float64)
    base = pk.base if kind == "seg" else pk
    f = {k: v.clone() for k, v in base._fields().items()}
    f["cols"][f["vals"] == 0] = 0
    assert not torch.equal(tsell._slice_spans(f["cols"], f["slice_ptr"]),
                           base.spans)           # the naive spans differ
    path = str(tmp_path / "old.npz")
    np.savez(path, **{k: v.numpy() for k, v in f.items()},
             meta=np.asarray([base.n, base.ncols, base.nnz, base.sigma],
                             np.int64))
    old = tsell.SellData.load(path)
    assert torch.equal(old.spans, base.spans)
    assert old.stage_cap == base.stage_cap
    assert torch.equal(old.cols, base.cols)
    x = torch.as_tensor(np.random.default_rng(27).standard_normal(base.ncols))
    assert torch.equal(tsell.sell_spmv_ref(old, x),
                       tsell.sell_spmv_ref(base, x))


def test_pack_refuses_rows_past_the_slice_offsets(monkeypatch):
    """B9 addresses a slice's slots with 32-bit offsets: the default pack
    refuses a row that would need more (the segmented pack splits it)."""
    monkeypatch.setattr(tsell, "_MAX_SLICE_SLOTS", 32 * 20)
    n = 200
    r, c, v = _scattered(n, 25)
    with pytest.raises(ValueError, match="segmented"):
        tsell.sell_pack((r, c, v), n, dtype=np.float64)
    s = tsell.sell_pack_seg((r, c, v), n, dtype=np.float64, seg_len=16)
    assert s.base.nslots > 0


def test_promoted_pack_is_cast_once():
    """A float32 pack driven by float64 vectors is cast once and the copy
    kept (the CUDA matvec reads it; no launch casts the slots)."""
    from exponentialutilities_jl_torch.ops.sparse import _promoted

    n = 200
    op = et.SellOperator.from_coo(*_scattered(n, 20), n, dtype=np.float32)
    d64 = _promoted(op, "data", torch.float64)
    assert d64.dtype == torch.float64 and d64.nslots == op.data.nslots
    assert _promoted(op, "data", torch.float64) is d64
    assert _promoted(op, "data", torch.float32) is op.data
    op.data = op.data.to(dtype=torch.float32)          # reassigned: recast
    assert _promoted(op, "data", torch.float64) is not d64


# ---- B9/B10 launch plans, host logic --------------------------------------

@pytest.mark.parametrize("case", ["scattered", "long_row", "empty_block"])
def test_seg_plan_checks_seg_ptr_once(monkeypatch, case):
    """The segmented pack on ragged inputs (a row of 5000 one-entry
    segments, 256 empty rows, n = 3001 not a multiple of 256): its twin
    equals scipy; SellSeg(validate=True) takes the packer's seg_ptr and
    refuses one that falls or does not start at 0; the
    pack's plan checks seg_ptr once and its B10 launch passes B9's
    partials, seg_ptr and n; a vector of another size raises."""
    import scipy.sparse as sp

    from exponentialutilities_jl_torch.ops.kernels import _build

    n = 3001
    r, c, v = _scattered(n, 30)
    seg_len = 8
    if case == "long_row":
        seg_len = 1
        r = np.concatenate([r, np.full(5000, 700)])
        c = np.concatenate([c, np.arange(5000) % n])
        v = np.concatenate([v, np.ones(5000)])
    elif case == "empty_block":
        keep = (r < 256) | (r >= 512)
        r, c, v = r[keep], c[keep], v[keep]
    s = tsell.sell_pack_seg((r, c, v), n, dtype=np.float64, seg_len=seg_len)
    x = np.random.default_rng(34).standard_normal(n)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    assert_close(t2n(tsell.sell_spmv_seg(s, torch.as_tensor(x))), A @ x,
                 RTOL64, "seg twin vs scipy")
    assert tsell.SellSeg(s.base, s.seg_ptr, n, s.nnz, seg_len).n == n
    falls = s.seg_ptr.clone()
    falls[n // 2] = falls[-1] + 1
    for ptr in (falls, s.seg_ptr + 1):
        with pytest.raises(ValueError, match="seg_ptr"):
            tsell.SellSeg(s.base, ptr, n, s.nnz, seg_len)
    lib = use_fake_kernel_library(monkeypatch)
    plan = tsell.launch_plan(s)
    _build.reset_launch_counts()
    plan(torch.as_tensor(x))
    (b9, b9_args), (name, args) = lib.calls
    assert (b9, name) == ("eu_sell_spmv_f64", "eu_seg_compact_f64")
    assert args[:3] == (b9_args[2], s.seg_ptr.data_ptr(), n)
    assert (_build.launches["sell_spmv"], _build.launches["seg_compact"]) \
        == (1, 1)
    with pytest.raises(ValueError, match="vector"):
        plan(torch.zeros(n + 1, dtype=torch.float64))


def test_sell_launch_plans(monkeypatch):
    """A pack's launch plan checks its arrays once, at its first launch,
    and is kept; a launch passes the pack's pointers, sizes, stage_cap and
    unroll, and a segmented pack's plan launches B9 and then B10; each
    vector's dtype, device and shape are still checked, and a broken pack
    still raises."""
    from exponentialutilities_jl_torch.ops.kernels import _build

    lib = use_fake_kernel_library(monkeypatch)
    n = 3001
    d = tsell.sell_pack(_scattered(n, 31), n, dtype=np.float64)
    x = torch.as_tensor(np.random.default_rng(32).standard_normal(n))
    plan = tsell.launch_plan(d)
    assert tsell.launch_plan(d) is plan and not lib.calls
    _build.reset_launch_counts()
    plan(x)
    (name, args), = lib.calls
    assert name == "eu_sell_spmv_f64"
    assert args[:2] == (plan.addr, x.data_ptr()) and args[3] == 0
    L = plan.launch
    assert (L.vals, L.cols, L.slice_ptr, L.spans, L.row_of) == (
        d.vals.data_ptr(), d.cols.data_ptr(), d.slice_ptr.data_ptr(),
        d.spans.data_ptr(), d.row_of.data_ptr())
    wide = d.nslots >= tsell.WIDE_ROWS * tsell.SLICE * d.nslices
    assert (L.nrows, L.ncols, L.nslices, L.stage_cap, L.unroll) == (
        n, n, d.nslices, d.stage_cap, 16 if wide else 4)
    S = tsell._SellLaunch                  # the layout csrc/sell.cu asserts
    assert (ctypes.sizeof(S), S.nrows.offset, S.stage_cap.offset) == \
        (72, 40, 64)
    assert _build.launches["sell_spmv"] == 1
    for bad, what in ((x.float(), "float64"), (x[:-1], "vector"),
                      (x.to("meta"), "vector")):
        with pytest.raises(ValueError, match=what):
            plan(bad)
    assert tsell.launch_plan(d.to(dtype=torch.float32))(x.float()) is not None
    assert lib.calls[-1][0] == "eu_sell_spmv_f32"
    with pytest.raises(ValueError, match="slots"):
        tsell.launch_plan(d.with_vals(d.vals[:-32]))
    f = d._fields()
    hand = tsell.SellData(f["vals"], f["cols"].long(), f["slice_ptr"],
                          f["row_of"], d.n, d.nnz, ncols=d.ncols)
    with pytest.raises(ValueError, match="int32"):
        tsell.launch_plan(hand)
    d.vals = d.vals.clone()                       # reassigned: a new plan
    assert tsell.launch_plan(d) is not plan
    s = tsell.sell_pack_seg(_scattered(n, 33), n, dtype=np.float64,
                            seg_len=8)
    sp = tsell.launch_plan(s)
    assert isinstance(sp, tsell.SegPlan) and tsell.launch_plan(s) is sp
    _build.reset_launch_counts()
    lib.calls.clear()
    sp(x)
    assert [c[0] for c in lib.calls] == ["eu_sell_spmv_f64",
                                         "eu_seg_compact_f64"]
    args = lib.calls[1][1]
    assert args[1:3] == (s.seg_ptr.data_ptr(), n)
    assert (_build.launches["sell_spmv"], _build.launches["seg_compact"]) \
        == (1, 1)
    with pytest.raises(ValueError, match="float64"):
        sp(x.float())


def test_sell_plans_refuse_cpu():
    """With the real kernel library, a launch plan for a CPU pack (plain or
    segmented) raises before any pointer could reach a kernel; the public
    entries send CPU tensors to the twins instead."""
    n = 500
    d = tsell.sell_pack(_scattered(n, 35), n, dtype=np.float64)
    s = tsell.sell_pack_seg(_scattered(n, 36), n, dtype=np.float64,
                            seg_len=4)
    for pack in (d, s):
        with pytest.raises(ValueError, match="CUDA"):
            tsell.launch_plan(pack)
        assert "_plan" not in pack.__dict__
    x = torch.as_tensor(np.random.default_rng(37).standard_normal(n))
    assert torch.equal(tsell.sell_spmv(d, x), tsell.sell_spmv_ref(d, x))
    assert torch.equal(tsell.sell_spmv_seg(s, x),
                       tsell.sell_spmv_seg_ref(s, x))

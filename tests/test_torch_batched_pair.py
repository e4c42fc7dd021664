"""The batched 1-D two-pass pair, K3 and K4 (``ops/kernels/resident.py``),
on the CPU: what of their designs a CPU run can check.

K4 runs the recurrence of B1 on blocks of ``chunk`` rows, each holding
s h halo rows a side that it computes redundantly, with a halo exchange
every s steps (``csrc/resident_nbr_batched.cu``). ``blocked_model`` is
that schedule in plain torch: each block's span, the neighbours' published
edges copied in at an exchange, and the rows whose inputs have gone stale
since the last exchange poisoned with NaN, so that an owned row reading
one shows. It is held bit for bit to the twin
``resident_recurrence_batched_ref`` (the same torch arithmetic on every
element) and, row by row, to the JAX package's resident kernel
(``ops/kernels/resident.py:89``) in interpret mode within
``test_torch_resident.py``'s float32 tolerance. A span of s h halo rows
wider than a block's rows is refused, as the plan refuses it
(``nbr_rows_geometry``).

K3's geometry chooser ``cluster_batch_geometry`` is held to a brute force
over a fake occupancy probe, as ``test_torch_resident.py`` holds
``cluster_shape``: batches that fit one wave at some P, and batches
larger than one wave at every P."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exponentialutilities_jl_torch.ops.kernels import resident as tr
from exponentialutilities_jl_torch.ops.stencil import stencil_apply
from exponentialutilities_jl_tpu.ops.kernels import resident as jr
from torch_parity import RTOL32, assert_close, t2n

torch.set_num_threads(2)

# (offsets, coefficients): the 1-D Laplacian in its operator's order, and a
# stencil reaching two rows, asymmetric and out of order
STENCILS = {"laplacian": ((0, -1, 1), (-2.0, 1.0, 1.0)),
            "wide": ((1, -2, 0, 2), (0.4, 0.3, -1.2, 0.5))}
N = 2003


def blocked_model(X, rows, cvals, offsets, scale, grid, chunk, s):
    """K4's schedule in plain torch: (W, sum w^2 per row) for X (batch, n)
    on ``grid`` blocks of ``chunk`` rows (the last may own fewer), s steps
    a halo exchange. Block b keeps omega_k and omega_{k-1} on its span,
    rows [b chunk - s h, b chunk + len + s h), rows outside [0, n) zero;
    a step is the twin's arithmetic on the span (``stencil_apply`` reads
    zero past the span's ends). j steps after an exchange the rows within
    j h of a span end that faces a neighbour are stale: they are set to
    NaN. At an exchange every block publishes its first and last s h
    owned rows of both vectors, then every block copies its neighbours'
    into its halo rows. Raises ValueError where s h exceeds ``chunk``."""
    nb, n = X.shape
    h = max(abs(o) for o in offsets)
    sh = s * h
    if sh > chunk or (grid - 1) * chunk >= n or grid * chunk < n:
        raise ValueError(f"no K4 schedule for s h = {sh} on blocks of "
                         f"{chunk} rows ({grid} blocks of n = {n})")
    m = rows.shape[1]
    col = lambda v: v[:, None]
    lo = [b * chunk for b in range(grid)]
    ln = [min(chunk, n - lo[b]) for b in range(grid)]
    span = [ln[b] + 2 * sh for b in range(grid)]
    # rows of each span inside [0, n)
    inside = [((torch.arange(span[b]) + lo[b] - sh >= 0)
               & (torch.arange(span[b]) + lo[b] - sh < n)) for b in range(grid)]
    Xs = col(scale) * X
    wc, wp, acc = [], [], []
    for b in range(grid):
        v = torch.zeros((nb, span[b]), dtype=X.dtype)
        v[:, inside[b]] = Xs[:, max(0, lo[b] - sh):lo[b] + ln[b] + sh]
        wc.append(v)
        wp.append(torch.zeros_like(v))
        acc.append(torch.zeros((nb, ln[b]), dtype=X.dtype))
    since = 0       # steps since the last exchange (or the start)
    for k in range(m):
        ca, cb, cc, cw = (col(c) for c in rows[:, k].unbind(-1))
        for b in range(grid):
            acc[b] = acc[b] + cw * wc[b][:, sh:sh + ln[b]]
        if k == m - 1:
            break
        for b in range(grid):
            z = stencil_apply(wc[b], [(o,) for o in offsets], cvals)
            new = ca * z + cb * wc[b] + cc * wp[b]
            new[:, ~inside[b]] = 0.0
            wp[b], wc[b] = wc[b], new
        since += 1
        for b in range(grid):   # rows that read past the last exchange's halo
            for v, d in ((wc[b], since * h), (wp[b], (since - 1) * h)):
                if d <= 0:
                    continue
                stale = torch.zeros(span[b], dtype=torch.bool)
                if b > 0:
                    stale[:d] = True
                if b + 1 < grid:
                    stale[span[b] - d:] = True
                v[:, stale & inside[b]] = float("nan")
        done = k + 1
        if done % s or done + 1 >= m or sh == 0:
            continue
        # exchange: publish the owned edges, then read the neighbours'
        pub = [(wc[b][:, sh:2 * sh].clone(), wp[b][:, sh:2 * sh].clone(),
                wc[b][:, ln[b]:ln[b] + sh].clone(),
                wp[b][:, ln[b]:ln[b] + sh].clone()) for b in range(grid)]
        for b in range(grid):
            if b > 0:
                wc[b][:, :sh], wp[b][:, :sh] = pub[b - 1][2], pub[b - 1][3]
            if b + 1 < grid:
                e = sh + ln[b]
                wc[b][:, e:e + sh], wp[b][:, e:e + sh] = pub[b + 1][:2]
        since = 0
    W = torch.cat(acc, dim=1)
    return W, (W * W).sum(-1)


def _inputs(stencil, batch, m, dtype, seed):
    offsets, coeffs = STENCILS[stencil]
    g = np.random.default_rng(seed)
    X = g.standard_normal((batch, N)).astype(dtype)
    if batch > 1:
        X[1] = 0.0
    rows = (g.standard_normal((batch, m, 4)) * 0.3).astype(dtype)
    rows[..., 0] *= 0.25
    scale = g.uniform(0.5, 2.0, batch).astype(dtype)
    return offsets, coeffs, X, rows, scale


@pytest.mark.parametrize("stencil", sorted(STENCILS))
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [12, 13, 41])
def test_blocked_model_bits_vs_twin(stencil, s, m):
    """The schedule gives the twin's bits on every row, float64, for m a
    multiple of s and not, the last block shorter than the others; no
    stale (NaN) row reaches an owned row."""
    offsets, coeffs, X, rows, scale = _inputs(stencil, 3, m, np.float64,
                                              100 + m + s)
    cv = torch.as_tensor(coeffs, dtype=torch.float64)
    Xt, Rt, St = (torch.as_tensor(a) for a in (X, rows, scale))
    grid, chunk = tr.nbr_geometry(N, 8)
    assert N - (grid - 1) * chunk < chunk
    W, s2 = blocked_model(Xt, Rt, cv, offsets, St, grid, chunk, s)
    Wr, s2r = tr.resident_recurrence_batched_ref(Xt, Rt, cv, offsets, St)
    assert not W.isnan().any()
    assert torch.equal(W, Wr)
    assert torch.allclose(s2, s2r, rtol=1e-14, atol=0)


@pytest.mark.parametrize("stencil", sorted(STENCILS))
def test_blocked_model_vs_jax_interpret(stencil):
    """The schedule (s = 4, m = 41) in float32 against the JAX package's
    resident kernel in interpret mode, row by row, within RTOL32."""
    m = 41
    offsets, coeffs, X, rows, scale = _inputs(stencil, 2, m, np.float32, 7)
    grid, chunk = tr.nbr_geometry(N, 8)
    W, s2 = blocked_model(torch.as_tensor(X), torch.as_tensor(rows),
                          torch.as_tensor(coeffs, dtype=torch.float32),
                          offsets, torch.as_tensor(scale), grid, chunk, 4)
    R, mask = jr._layout_1d(N)
    for i in range(2):
        Xp = jnp.pad(jnp.asarray(X[i]), (0, R * 128 - N)).reshape(R, 128)
        jW, jnrm = jr._resident_call(Xp, jnp.asarray(mask), jnp.asarray(rows[i]),
                                     jnp.asarray(coeffs, jnp.float32),
                                     float(scale[i]), offsets=offsets,
                                     interpret=True)
        assert_close(t2n(W[i]), np.asarray(jW).reshape(-1)[:N], RTOL32,
                     f"{stencil} row {i}")
        assert float(s2[i]) == pytest.approx(float(jnrm), rel=RTOL32)


@pytest.mark.parametrize("s,chunk", [(4, 7), (2, 3), (1, 1)])
def test_blocked_model_refuses_a_short_block(s, chunk):
    """A span of s h halo rows wider than a block's rows (h = 2) is
    refused; the plan's geometry never asks for one."""
    offsets, coeffs, X, rows, scale = _inputs("wide", 1, 12, np.float64, 3)
    grid = -(-N // chunk)
    with pytest.raises(ValueError):
        blocked_model(torch.as_tensor(X), torch.as_tensor(rows),
                      torch.as_tensor(coeffs), offsets,
                      torch.as_tensor(scale), grid, chunk, s)
    for n, blocks, h in itertools.product((1, 5, 40, 300, N, 100_000),
                                          (1, 16, 132), (0, 1, 2)):
        g = tr.nbr_rows_geometry(n, h, blocks)
        if g is None:
            continue
        assert g.s * h <= g.chunk and g.s in tr.NBR_ROWS_STEPS
        assert g.per_thread * g.threads >= g.chunk + 2 * g.s * h
        assert g.threads % 32 == 0 and g.threads <= tr.NBR_ROWS_THREADS


# ----------------------------------------- K3's geometry (brute force) --
OPTIN = 232_448
STATIC = {torch.float32: 1_280, torch.float64: 2_304}


def _card(dtype, active):
    """A fake occupancy probe: clusters of C blocks carrying P rows fit
    ``active[C][P]`` at once where a block's rows and shared memory fit,
    else 0 (P = 1: B2's kernel, two y spans and 16 h edge values; P > 1:
    the rows kernel, P times two spans and 12 h)."""
    item = dtype.itemsize
    regs = tr.CLUSTER_ROW_REGS[dtype]

    def probe(c, rows, p, halo):
        if p == 1:
            ok = (rows <= (8 if item == 8 else 32) * 1024
                  and (2 * rows + 16 * halo) * item + STATIC[dtype] <= OPTIN)
        else:
            ok = (rows <= regs // p * 1024 and p * (2 * (rows + 2 * halo)
                                                     + 12 * halo) * item
                  + STATIC[dtype] <= OPTIN)
        return active.get(c, {}).get(p, 0) if ok else 0
    return probe


def _brute(n, halo, batch, dtype, probe):
    """Every (C, L, P) enumerated: B2's (C, L) is the first C of (16, 8)
    whose least L holds the halo, is within the dtype's cap and fits with
    P = 1; then among the P whose clusters all fit one wave the smallest;
    with none, P = 1 in waves."""
    shape = None
    for c in (16, 8):
        rows = next(L for L in itertools.count(1) if c * L >= n)
        if (halo <= rows <= tr.CLUSTER_MAX_ROWS[dtype]
                and probe(c, rows, 1, halo) >= 1):
            shape = (c, rows)
            break
    if shape is None:
        return None
    c, rows = shape
    table = {p: probe(c, rows, p, halo) for p in (1, 2, 4)}
    one = sorted(p for p, a in table.items() if a >= 1 and a * p >= batch)
    per = one[0] if one else 1
    clusters = -(-batch // per)
    return c, rows, per, clusters, -(-clusters // table[per])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("card", ["16 fits 7", "8 only", "roomy"])
def test_cluster_batch_geometry_vs_brute_force(dtype, card):
    active = {"16 fits 7": {16: {1: 7, 2: 7, 4: 6}, 8: {1: 16, 2: 16, 4: 15}},
              "8 only": {8: {1: 16, 2: 15, 4: 14}},
              "roomy": {16: {1: 8, 2: 8, 4: 8}, 8: {1: 16, 2: 16, 4: 16}}}[card]
    probe = _card(dtype, active)
    for n, halo, batch in itertools.product(
            (10, 1000, 20_000, 65_536, 100_000, 131_072, 200_000, 368_000),
            (1, 2, 700), (1, 2, 5, 8, 9, 16, 17, 33, 100)):
        if halo >= n:
            continue
        got = tr.cluster_batch_geometry(
            n, halo, batch, tr.CLUSTER_MAX_ROWS[dtype],
            tr.CLUSTER_ROW_REGS[dtype],
            lambda c, rows, p: probe(c, rows, p, halo))
        want = _brute(n, halo, batch, dtype, probe)
        if want is None:
            assert got is None, (n, halo, batch)
            continue
        assert (got.cluster, got.rows, got.per, got.clusters,
                got.waves) == want, (n, halo, batch)
        assert got.counts == tuple(probe(got.cluster, got.rows, p, halo)
                                   for p in tr.CLUSTER_BATCH_ROWS)
        assert got.per_thread * 1024 >= got.rows
    if card == "16 fits 7" and dtype == torch.float64:
        # config #2's 8 rows: two 16-block waves of one row, one wave of two
        g = tr.cluster_batch_geometry(100_000, 1, 8, 8_192, 14,
                                      lambda c, r, p: probe(c, r, p, 1))
        assert (g.cluster, g.rows, g.per, g.clusters, g.waves) == (
            16, 6250, 2, 4, 1)
        g = tr.cluster_batch_geometry(100_000, 1, 100, 8_192, 14,
                                      lambda c, r, p: probe(c, r, p, 1))
        assert (g.per, g.waves) == (1, 15)   # no P holds 100 rows at once

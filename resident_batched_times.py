"""Times the batched 1-D two-pass pair, K3 and K4, of the package in the
current directory on one CUDA card, each at the geometries its plan
chooses between, on config #2's 1-D Laplacian at n = 1e5 with 8 rows
(float64, m = 40 unless stated):

* K3 (Lanczos pass 1): the 8 rows as clusters of B2's shape carrying
  P = 1 row (B2's kernel, u and y in registers, in as many waves as the
  card needs) and P = 2 rows (the rows kernel, y in shared memory); B2
  alone on one row beside them;
* K4 (the recurrence with sum w^2): the rows in registers at each s of
  ``NBR_ROWS_STEPS`` steps a halo exchange (s = 1 exchanges every step),
  m = 12 and 41, and the slope over m, the time of a step.

Every launch takes the plan's descriptor; only P or s differs from what
the plan would choose. Each time is the per-launch time of 20 launches
back to back between two CUDA events, the median of 5 such runs taken in
turns across the variants; every row's records or w are checked bit for
bit against the plan's own launch. Every line carries the card's name and
power limit (nvidia-smi). Run from the root of a tree:
``python3 resident_batched_times.py``."""

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import exponentialutilities_jl_torch as et  # noqa: E402
from exponentialutilities_jl_torch.ops.kernels import _build  # noqa: E402
from exponentialutilities_jl_torch.ops.kernels import resident as tr  # noqa: E402

N, NB, M = 100_000, 8, 40


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return f"[{out.splitlines()[0]}]"


def burst_ms(fn, k=20):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(k):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / k


def in_turns(fns, reps=5):
    """{name: median ms} of the launches in ``fns``, timed in turns."""
    got = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            got[k].append(burst_ms(fn))
    return {k: statistics.median(v) for k, v in got.items()}


def check(code, what):
    if code:
        _build.check(code, what)


def k3_times(op, stream, tag):
    plan = tr.lanczos_plan(op, torch.float64, op.device)
    g = np.random.default_rng(3)
    X = torch.as_tensor(g.standard_normal((NB, N)), device=op.device)
    V0 = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    ref = plan.batched(V0, M, 1e-7)
    ab = torch.empty_like(ref)
    ab1 = torch.empty((M, 2), dtype=torch.float64, device=op.device)
    geom = plan.batch_geometry(NB)
    fns = {
        "B2, 1 row": lambda: check(plan.fn(plan.addr, V0.data_ptr(), M, 1e-7,
                                           ab1.data_ptr(), stream), "B2"),
        f"P = 1, {NB} rows": lambda: check(plan.bfn(
            plan.addr, V0.data_ptr(), M, 1e-7, ab.data_ptr(), NB, stream),
            "K3, P = 1"),
        f"P = 2, {NB} rows": lambda: check(plan.rfn(
            plan.addr, V0.data_ptr(), M, 1e-7, ab.data_ptr(), NB, 2, stream),
            "K3, P = 2"),
    }
    for name in (f"P = 1, {NB} rows", f"P = 2, {NB} rows"):
        fns[name]()
        torch.cuda.synchronize()
        assert torch.equal(ab, ref), name
    ms = in_turns(fns)
    counts = dict(zip(tr.CLUSTER_BATCH_ROWS, geom.counts))
    for name, t in ms.items():
        print(f"K3 float64 config #2 m={M} {name}: {t:.4f} ms a launch "
              f"(20 back to back, median of 5 in turns); the plan takes "
              f"P = {geom.per}, active clusters for P = {counts} {tag}",
              flush=True)


def k4_times(op, stream, tag):
    plan = tr.recurrence_batch_plan(op, torch.float64, op.device, NB)
    base = plan.geometry
    g = np.random.default_rng(4)
    X = torch.as_tensor(g.standard_normal((NB, N)), device=op.device)
    sc = torch.as_tensor(g.uniform(0.5, 2.0, NB), device=op.device)
    plan._batch_launch(stream)
    _, _, flags, halo, partials = plan.nbr[stream]
    W = torch.empty_like(X)
    nrm2 = torch.empty(NB, dtype=torch.float64, device=op.device)
    q = plan.rows_per_launch * base.grid
    fns, refs, keep = {}, {}, []
    for m in (12, 41):
        rows = torch.as_tensor(g.standard_normal((NB, m, 4)) * 0.3,
                               device=op.device)
        rows[..., 0] *= 0.25
        refs[m] = plan(X, rows, sc)[0]
        for s in tr.NBR_ROWS_STEPS:
            span = base.chunk + 2 * s * plan.h
            per = next(j for j in tr.NBR_ROWS_PER_THREAD
                       if j * tr.NBR_ROWS_THREADS >= span)
            # the plan's buffers: its halo holds the largest s's slots
            L = tr._RowsLaunch(
                plan.cvals.data_ptr(), flags.data_ptr(), halo.data_ptr(),
                partials.data_ptr(),
                flags[q * tr.NBR_FLAG_STRIDE:].data_ptr(), N, base.grid,
                base.chunk, plan.h, plan.k, s, 32 * -(-span // (32 * per)),
                per, plan.o)
            keep.append(L)
            addr = ctypes.addressof(L)
            fns[(s, m)] = (lambda addr=addr, rows=rows, m=m: check(plan.fn(
                addr, X.data_ptr(), sc.data_ptr(), rows.data_ptr(), m,
                W.data_ptr(), nrm2.data_ptr(), NB, stream), "K4"))
    assert 8 * q * base.s * plan.h <= halo.numel()
    for (s, m), fn in fns.items():
        fn()
        torch.cuda.synchronize()
        assert torch.equal(W, refs[m]), (s, m)
    ms = in_turns(fns)
    for s in sorted(tr.NBR_ROWS_STEPS):
        step = (ms[(s, 41)] - ms[(s, 12)]) / 29 * 1e3
        print(f"K4 float64 config #2 {NB} rows s={s}: m=12 "
              f"{ms[(s, 12)]:.4f} ms, m=41 {ms[(s, 41)]:.4f} ms a launch (20 "
              f"back to back, medians of 5 in turns): {step:.3f} us a step "
              f"(slope); the plan takes s = {base.s} {tag}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    tag = card()
    et.set_default_device("cuda")
    op = et.laplacian_nd_stencil(N, dtype=torch.float64, device="cuda")
    stream = _build.raw_stream(op.device)
    k3_times(op, stream, tag)
    k4_times(op, stream, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())

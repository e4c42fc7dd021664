"""Times the Hermitian Krylov calls whose reduced problem is the
tridiagonal exponential s Q exp(t Lambda) Q^T e1 (kernel R1 in a tree
that has ``ops/kernels/tridiag.py``, ``torch.linalg.eigh`` in an earlier
one), float64, on one CUDA card, for the package in the current
directory:

    cd <tree> && python3 /path/to/hermitian_times.py

Cells: config #3's poisson_2d(1000, 1000) at t = 1e-4, ``expv`` on the
basis path at m = 30 and m = 250 and ``expv(mode="error_estimate",
m=60, atol=rtol=1e-12)`` (also under ``utils.graphs.eager()``, where the
tree's loop runs from CUDA graphs; its iteration count is printed); config
#2's 1-D Laplacian at n = 1e5, t = 0.5, ``expv(m=40, two_pass=True)`` (B2,
the reduced stage, then B1). Each line gives three CUDA-event medians of
10 calls and the card's name and power limit. Then R1 itself
(``tridiag_exp_e1``) at m = 30, 40 and 250 on a random tridiagonal (t =
0.6, s = 1.7): one call (host included), its device time per launch (20
launches captured into one CUDA graph, replayed; the graph's time over
20) and ``torch.linalg.eigh`` + the combination, one call; and the host
time of a replayed ``make_expv(m=30)`` call on config #3 (the Python
call alone, no synchronisation: median of 200, in µs). The script calls
only entry points that earlier versions of the port share, so it
compares two trees of this repository in one run on one card (run them
as parent, change, change, parent).
"""

import contextlib
import inspect
import os
import statistics
import subprocess
import sys

import numpy as np
import torch


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        ts.append(a.elapsed_time(z))
    return statistics.median(ts)


def main() -> int:
    if not torch.cuda.is_available():
        print("hermitian_times.py needs a CUDA device", file=sys.stderr)
        return 2
    # the package of the tree the script is run from, not of the tree that
    # holds the script
    sys.path.insert(0, os.getcwd())
    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch.utils import graphs

    card = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] + "]"
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    opP = et.poisson_2d(1000, 1000, device=dev)
    bP = torch.as_tensor(rng.standard_normal(1000 * 1000), device=dev)
    op2 = et.laplacian_nd_stencil(100_000, device=dev)
    b2 = torch.as_tensor(rng.standard_normal(100_000), device=dev)
    kw = dict(m=60, mode="error_estimate", atol=1e-12, rtol=1e-12,
              return_info=True)
    _, iters = et.expv(1e-4, opP, bP, **kw)
    cells = (
        ("config #3 expv(m=30)", lambda: et.expv(1e-4, opP, bP, m=30),
         contextlib.nullcontext),
        ("config #3 expv(m=250)", lambda: et.expv(1e-4, opP, bP, m=250),
         contextlib.nullcontext),
        (f"config #3 expv(mode=error_estimate, m=60), {iters} iterations",
         lambda: et.expv(1e-4, opP, bP, **kw), contextlib.nullcontext),
        (f"config #3 expv(mode=error_estimate, m=60), {iters} iterations, "
         "under graphs.eager()", lambda: et.expv(1e-4, opP, bP, **kw),
         graphs.eager),
        ("config #2 expv(m=40, two_pass=True)",
         lambda: et.expv(0.5, op2, b2, m=40, two_pass=True),
         contextlib.nullcontext),
    )
    for label, fn, ctx in cells:
        with ctx():
            one = [median_ms(fn) for _ in range(3)]
        print(f"hermitian {label} float64: "
              f"{' / '.join(f'{t:.4f}' for t in one)} ms (three CUDA-event "
              f"medians of 10) {card}", flush=True)
    r1_times(dev, card)
    replay_host_us(et, opP, bP, card)
    return 0


def r1_times(dev, card):
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    for m in (30, 40, 250):
        g = np.random.default_rng(50 + m)
        a = torch.as_tensor(-np.abs(g.standard_normal(m)) * 2, device=dev)
        b = torch.as_tensor(np.abs(g.standard_normal(m - 1)), device=dev)
        t = torch.tensor(0.6, dtype=torch.float64, device=dev)
        s = torch.tensor(1.7, dtype=torch.float64, device=dev)
        T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)

        def kfn():
            return tt.tridiag_exp_e1(a, b, t, s)

        def lfn():
            w, Q = torch.linalg.eigh(T)
            return Q @ (torch.exp(t * w) * Q[0]) * s

        one = [median_ms(kfn) for _ in range(3)]
        lib = [median_ms(lfn) for _ in range(3)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kfn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                kfn()
        dev_ms = [median_ms(graph.replay) / 20 for _ in range(3)]
        print(f"R1 tridiag_exp_e1 float64 m={m}: one call "
              f"{' / '.join(f'{x:.4f}' for x in one)} ms; device per launch "
              f"{' / '.join(f'{x:.4f}' for x in dev_ms)} ms (a graph of 20); "
              f"torch.linalg.eigh + combination "
              f"{' / '.join(f'{x:.4f}' for x in lib)} ms {card}", flush=True)
        if "clocks" in inspect.signature(tt._launch).parameters:
            r1_phases(tt, a, b, t, s, m, card)


def r1_phases(tt, a, b, t, s, m, card):
    """Where R1's time goes (a tree whose kernel stamps its phases): the
    SM's cycles in each kind of phase, summed over the tree's levels."""
    clk = torch.zeros(tt.CLOCK_SLOTS, dtype=torch.int64, device=a.device)
    tt._launch(a, b, t, s, clocks=clk)
    c = clk.tolist()
    depth = (m - 1).bit_length()
    up = "sort deflate secular z rows".split()
    down = "U-product rotations unsort".split()
    names = ["block+tear"] + [up[i % 5] for i in range(5 * depth)] + \
        ["root"] + [down[i % 3] for i in range(3 * depth)] + ["output"]
    tot = {}
    for i, nm in enumerate(names):
        tot[nm] = tot.get(nm, 0) + c[i + 1] - c[i]
    whole = c[len(names)] - c[0]
    print(f"R1 phases m={m}: {whole} cycles; " + ", ".join(
        f"{k} {v} ({100 * v / whole:.1f} %)" for k, v in tot.items())
        + f" {card}", flush=True)


def replay_host_us(et, op, b, card):
    import time

    fn = et.make_expv(op, m=30)
    for _ in range(3):
        fn(1e-4, b)                 # warm-up, capture, a replay
    torch.cuda.synchronize()
    ts = []
    for _ in range(200):
        t0 = time.perf_counter()
        fn(1e-4, b)
        ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    ts.sort()
    print(f"replayed make_expv(m=30) config #3: host time of the call "
          f"{ts[100] * 1e6:.1f} us (median of 200; 10th / 90th percentile "
          f"{ts[20] * 1e6:.1f} / {ts[180] * 1e6:.1f} us) {card}", flush=True)
    prog = fn.program
    if hasattr(prog, "stale"):
        (key,) = prog.records
        t0 = time.perf_counter()
        for _ in range(1000):
            prog.stale(key)
        print(f"replayed make_expv(m=30) config #3: the record's check "
              f"{(time.perf_counter() - t0) * 1e3:.2f} us a call (mean of "
              f"1000) {card}", flush=True)
    fn.close()


if __name__ == "__main__":
    sys.exit(main())

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
10 calls and the card's name and power limit. The script calls only entry
points that earlier versions of the port share, so it compares two trees
of this repository in one run on one card (run them as parent, change,
change, parent).
"""

import contextlib
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

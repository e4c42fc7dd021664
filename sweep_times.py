"""Times the fused stencil sweeps B3 and B3-var of the package in the
current directory on one CUDA card.

One accumulating sweep (``fused_lanczos_step`` with ``w_accum``) at 216^3,
the 7-point Laplacian (B3) and div(a grad u) (B3-var), in float32 and
float64: the CUDA-event median of one call (the host's part included), the
time per call of 20 calls back to back (the device's), and the bound (7n
and 14n values over 3.35 TB/s), beside the card's name and power limit.
It calls only ``fused_lanczos_step`` and two operator builders, which
earlier versions of the port share, so it compares two trees of this
repository in one run on one card:

    cd <tree> && python3 /path/to/sweep_times.py

chip_smoke.py times the same calls in its phase 5; this script is the
version that also runs against an earlier commit.
"""

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

N = 216
HBM_BYTES_PER_S = 3.35e12


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def burst_ms(fn, k=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(k):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / k


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_times.py needs a CUDA device", file=sys.stderr)
        return 2
    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    a = np.random.default_rng(0).uniform(0.5, 2.0, (N, N, N))
    n = N ** 3
    gen = torch.Generator(device=dev).manual_seed(1)
    for dt in (torch.float32, torch.float64):
        ops = {"B3": et.laplacian_nd_stencil(N, N, N, dtype=dt, device=dev),
               "B3-var": et.variable_diffusion_nd_stencil(
                   a, dtype=np.float32 if dt == torch.float32 else np.float64,
                   device=dev)}
        Z, Vc, Vp = (torch.randn(n, dtype=dt, device=dev, generator=gen)
                     for _ in range(3))
        W = torch.zeros(n, dtype=dt, device=dev)
        co = torch.tensor([0.3, -0.7, 0.2, 0.0], dtype=dt, device=dev)
        isz = Z.element_size()
        for name, op in ops.items():
            def fn():
                return tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W)
            one = median_ms(fn)
            b2b = burst_ms(fn)
            values = 7 + (len(op.offsets) if name == "B3-var" else 0)
            bound = values * n * isz / HBM_BYTES_PER_S * 1e3
            print(f"sweep {name} {str(dt).split('.')[-1]} {N}^3 accumulating: "
                  f"one call {one:.4f} ms, back-to-back {b2b:.4f} ms, bound "
                  f"{bound:.4f} ms by bytes [{card}]", flush=True)
        del ops, Z, Vc, Vp, W
    return 0


if __name__ == "__main__":
    sys.exit(main())

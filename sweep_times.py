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

With ``--dump FILE`` it also writes the bits of the default calls on fixed
inputs (the moments in hex, SHA-256 digests of Y, Zn and W, plain and
accumulating, at 216^3 in 3-D and 512^2 in 2-D, and of the two-pass
``expv(m=20)`` on the 3-D operators) as JSON; ``--against FILE`` compares
this tree's bits with such a file (another tree's) and exits 1 on any
difference:

    cd <parent> && python3 /path/to/sweep_times.py --dump parent.json
    cd <change> && python3 /path/to/sweep_times.py --against parent.json

chip_smoke.py times the same calls in its phase 5; this script is the
version that also runs against an earlier commit.
"""

import argparse
import hashlib
import json
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


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def default_bits(et, tf, ops, dt, dev):
    """{call: bits} of the default (whole-grid) sweeps and the two-pass
    expv on seeded inputs: what must not change between two trees."""
    out = {}
    dn = str(dt).split(".")[-1]
    ops = dict(ops, **{"B3 2-D 512^2": et.laplacian_nd_stencil(
        512, 512, dtype=dt, device=dev)})
    for name, op in ops.items():
        n = op.shape[0]
        gen = torch.Generator(device=dev).manual_seed(2)
        Z, Vc, Vp, W = (torch.randn(n, dtype=dt, device=dev, generator=gen)
                        for _ in range(4))
        co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
        plain = tf.fused_lanczos_step(Z, Vc, Vp, co[:3].contiguous(), op)
        accum = tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W)
        bits = {"moments": [float(x).hex() for x in plain[2:] + accum[2:4]]}
        for label, t in (("Y", plain[0]), ("Zn", plain[1]),
                         ("Y accum", accum[0]), ("Zn accum", accum[1]),
                         ("W", accum[4])):
            bits[label] = digest(t)
        if not name.startswith("B3 2-D"):
            bits["expv two-pass m=20"] = digest(
                et.expv(0.05, op, Z, m=20, two_pass=True))
        out[f"{name} {dn}"] = bits
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", help="write the default calls' bits here")
    ap.add_argument("--against", help="compare the default calls' bits "
                    "with this file (from --dump)")
    args = ap.parse_args()
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
    bits = {}
    for dt in (torch.float32, torch.float64):
        ops = {"B3": et.laplacian_nd_stencil(N, N, N, dtype=dt, device=dev),
               "B3-var": et.variable_diffusion_nd_stencil(
                   a, dtype=np.float32 if dt == torch.float32 else np.float64,
                   device=dev)}
        Z, Vc, Vp = (torch.randn(n, dtype=dt, device=dev, generator=gen)
                     for _ in range(3))
        if args.dump or args.against:
            bits.update(default_bits(et, tf, ops, dt, dev))
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
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(bits, f, indent=1)
    if args.against:
        with open(args.against) as f:
            want = json.load(f)
        bad = sorted(k for k in want if bits.get(k) != want[k])
        for k in sorted(want):
            print(f"default call {k}: "
                  + ("DIFFERS" if k in bad else "bit for bit equal")
                  + f" to {args.against} [{card}]", flush=True)
        if bad or set(bits) != set(want):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

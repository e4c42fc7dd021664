"""Times the SpMV kernels B7 (banded), B9 (SELL) and B10 (segment
compaction) of the package in the current directory on one CUDA card.

For each, in float32 and float64: the CUDA-event median of one call (the
wrapper's host time included), the time per call of 20 calls back to back,
the kernel's own device time per launch (the mean of its kernel events
under torch.profiler over 20 calls, taken after every other measurement:
once the profiler has run, each launch costs the host more for the rest
of the process), the bound (bytes over 3.35 TB/s), and
the one PyTorch call of the same function (CSR ``A @ x``,
``torch.segment_reduce``), beside the card's name and power limit. A
lone call pays the host's part; back to back pays it too wherever the host
is slower than the device, so only the profiler's figure is the device
time.

Shapes: B7 on config #3's poisson_2d(1000, 1000) through
``BandedOperator.matvec`` and through ``banded_spmv(diags, offsets, x)``,
and on config #4's advection_diffusion_1d(2000); B9 on bench_sell's
banded-random matrix at n = 1e6 (d = 8, band 700); B10 on the partials of
the symmetrized scattered-degree matrix at n = 1e6 in the segmented pack
(L = 16) through ``seg_compact(partials, seg_ptr)``, and B9 + B10 as
``sell_spmv_seg``. It calls only entry points that earlier versions of the
port share, so it compares two trees of this repository in one run on one
card:

    cd <tree> && python3 /path/to/spmv_times.py

chip_smoke.py times the same kernels in its phase 5; this script is the
version that also runs against an earlier commit.
"""

import functools
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

NP = 1000                 # config #3: poisson_2d(1000, 1000)
NA = 2000                 # config #4: advection_diffusion_1d(2000)
NS = 1_000_000            # the SELL matrices of chip_smoke.py
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


def device_ms(fn, kname, k=20):
    """The mean device time of the kernel events whose name holds
    ``kname`` over k calls of fn, or None unless there are exactly k."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and kname in e.name]
    if len(evs) != k:
        return None
    return sum(e.time_range.elapsed_us() for e in evs) / k / 1e3


def host_us(fn, k=2000):
    """Host time per call in microseconds: k calls on the host clock (the
    launches are enqueued, not waited for), then one synchronize."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / k * 1e6


def csr_tensor(A, dt, dev):
    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(A.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(A.data, dtype=dt, device=dev), A.shape)


def main() -> int:
    if not torch.cuda.is_available():
        print("spmv_times.py needs a CUDA device", file=sys.stderr)
        return 2
    import scipy.sparse as sp

    import exponentialutilities_jl_torch as et
    from chip_smoke import (banded_csr, bench_sell_coo, scattered_coo,
                            symmetrized)
    from exponentialutilities_jl_torch.ops.kernels import sell as ts
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    r, c, v = bench_sell_coo(NS, 8, 700, rng)
    sell64 = ts.sell_pack((r, c, v), NS, np.float64, device=dev)
    A_sell = sp.coo_matrix((v, (r, c)), shape=(NS, NS)).tocsr()
    seg64 = et.SellOperator.from_scipy(
        symmetrized(scattered_coo(NS, rng), NS), mode="seg",
        is_hermitian=True, dtype=np.float64, device=dev).data

    # the floor of a one-call median on this host: two events alone, and
    # one small PyTorch kernel; host microseconds per call of its pieces
    x0 = torch.zeros(NA, dtype=torch.float64, device=dev)
    y0 = torch.empty_like(x0)
    print(f"floor: one call of two events {median_ms(lambda: None):.4f} ms; "
          f"torch.neg(x, out=y) at n={NA}: one call "
          f"{median_ms(lambda: torch.neg(x0, out=y0)):.4f} ms, back-to-back "
          f"{burst_ms(lambda: torch.neg(x0, out=y0)):.4f} ms; host per call: "
          f"torch.neg {host_us(lambda: torch.neg(x0, out=y0)):.2f} us, "
          f"torch.empty({NA}) "
          f"{host_us(lambda: torch.empty(NA, dtype=x0.dtype, device=dev)):.2f}"
          f" us [{card}]", flush=True)

    device_jobs = []        # (label, fn, kernel name), profiled at the end

    def line(name, dn, shape, fn, kname, nbytes, lib=None):
        one, b2b = median_ms(fn), burst_ms(fn)
        device_jobs.append((f"{name} {dn} ({shape})", fn, kname))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        text = (f"spmv {name} {dn} ({shape}): one call {one:.4f} ms, "
                f"back-to-back {b2b:.4f} ms, bound {bound:.4f} ms by bytes")
        if lib is not None:
            what, lfn = lib
            text += (f"; {what} one call {median_ms(lfn):.4f} ms, "
                     f"back-to-back {burst_ms(lfn):.4f} ms")
        print(f"{text} [{card}]", flush=True)

    for dt in (torch.float32, torch.float64):
        dn = str(dt).split(".")[-1]
        isz = torch.empty((), dtype=dt).element_size()
        gen = torch.Generator(device=dev).manual_seed(1)
        for label, op in ((f"poisson_2d({NP}, {NP})",
                           et.poisson_2d(NP, NP, dtype=dt, device=dev)),
                          (f"advection_diffusion_1d({NA})",
                           et.advection_diffusion_1d(NA, peclet=10.0,
                                                     dtype=dt, device=dev))):
            n = op.shape[0]
            x = torch.randn(n, dtype=dt, device=dev, generator=gen)
            nbytes = (op.diags.numel() + 2 * n) * isz
            A = csr_tensor(banded_csr(op), dt, dev)
            line("B7 BandedOperator.matvec", dn, label,
                 functools.partial(op.matvec, x), "banded_spmv_kernel",
                 nbytes, ("CSR A @ x", lambda: A @ x))
            line("B7 banded_spmv(diags, offsets, x)", dn, label,
                 functools.partial(tsp.banded_spmv, op.diags, op.offsets, x),
                 "banded_spmv_kernel", nbytes)
            del A
            if n != NA:
                continue
            per_call = host_us(
                lambda: tsp.banded_spmv(op.diags, op.offsets, x))
            text = (f"host B7 {dn} n={n}, us per call: BandedOperator.matvec "
                    f"{host_us(lambda: op.matvec(x)):.2f}, banded_spmv "
                    f"{per_call:.2f}")
            plan = op.plan(dt, x.device) if hasattr(op, "plan") else None
            if plan is not None and plan.fn is not None:   # its pieces
                y = torch.empty_like(x)
                args = (plan.addr, x.data_ptr(), y.data_ptr(), 0)
                stream = host_us(
                    lambda: torch._C._cuda_getCurrentRawStream(0))
                text += (f", plan(x) {host_us(lambda: plan(x)):.2f}, its "
                         f"ctypes launch {host_us(lambda: plan.fn(*args)):.2f}"
                         f", the raw stream {stream:.2f}")
            print(f"{text} [{card}]", flush=True)
        d = sell64.to(dtype=dt)
        x = torch.randn(NS, dtype=dt, device=dev, generator=gen)
        A = csr_tensor(A_sell, dt, dev)
        line("B9 sell_spmv", dn, f"bench_sell n={NS}, {d.nnz} nnz",
             functools.partial(ts.sell_spmv, d, x), "sell_spmv_kernel",
             d.nnz * (isz + 4) + 2 * NS * isz, ("CSR A @ x", lambda: A @ x))
        del A
        s = seg64.to(dtype=dt)
        p = ts.sell_spmv(s.base, x)
        off = s.seg_ptr.to(torch.int64)
        line("B10 seg_compact", dn,
             f"symmetrized scattered n={NS}, L=16, {s.base.n} segments",
             functools.partial(ts.seg_compact, p, s.seg_ptr),
             "seg_compact_kernel",
             (p.numel() + NS) * isz + s.seg_ptr.numel() * 8,
             ("torch.segment_reduce(sum)", lambda: torch.segment_reduce(
                 p, "sum", offsets=off, initial=0)))
        print(f"spmv B9+B10 sell_spmv_seg {dn}: one call "
              f"{median_ms(lambda: ts.sell_spmv_seg(s, x)):.4f} ms, "
              f"back-to-back {burst_ms(lambda: ts.sell_spmv_seg(s, x)):.4f}"
              f" ms [{card}]", flush=True)
        del d, s, p, x
    for label, fn, kname in device_jobs:
        dms = device_ms(fn, kname)
        print(f"device {label}: "
              + (f"{dms:.4f} ms per launch" if dms is not None else
                 "not measured (the profiler missed launches)")
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

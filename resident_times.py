"""Times the resident kernels B1 (the recurrence with sum w^2), B2
(Lanczos pass 1), B4 (multi-column recurrence), B5 (banded recurrence)
and B6 (whole-grid recurrence) of the package in the current directory on
one CUDA card.

Shapes: config #2's 1-D Laplacian at n = 1e5; B2 at m = 20 and 40, B4 at
p = 4 and B1 with m = 12 and 40 (random rows scaled by 1/|A|); B5 on
config #3's poisson_2d(1000, 1000) at m = 4, 8 and 16; B6 on the 2-D
512^2 and 1000^2 Laplacians and on 64^3 with the 7-point Laplacian and
the 27-point box at m = 8, 15 and 30; float32 and float64. For each: the
CUDA-event median of one call (the wrapper's host time included), the
time per call of 20 calls back to back, the host microseconds per call
(200 calls enqueued, then one synchronize), the kernel's device time per
launch (the mean of its kernel events under torch.profiler over 20
calls, taken after every other measurement: once the profiler has run,
each launch costs the host more for the rest of the process), and the
per-step cost: the slope of the back-to-back and device times over m,
the figure a kernel bound by synchronisation shows and its byte bound
cannot. Every line carries the card's name and power limit.

Where the tree has B4's launch plan (``resident.MultiPlan``), the family
kernel is timed beside the neighbour form through a plan built with
``form="family"``; likewise B1's grid kernel (``RecurrencePlan(...,
form="grid")``), B5's family kernel (``BandedRecurrencePlan(...,
form="family")``) and B6's (``GridRecurrencePlan(..., form="family")``)
where the tree has those plans; a tree without B6's plan runs the family
kernel alone. B2 has no such
option: its grid form is timed from a tree that runs it at every size
(one from before the plans). The sizes
around B2's gate (``resident.CLUSTER_MAX_ROWS``: float64 n = 131k, the
last size of the cluster form, 150k and 230k above it; float32 n = 200k,
300k and 360k on it, 460k above) and B4 at n = 3e5 (chunks of 2273 rows)
are timed at m = 40 and m = 12 after the main-path shapes. The script
calls only entry points that earlier versions of the port share
otherwise, so it compares two trees of this repository in one run on one
card:

    cd <tree> && python3 /path/to/resident_times.py [PART ...]

PART is any of b1, b2, b4, b5, b6 and e2e (default: all): the kernels to
time, and the end-to-end calls. The costs of the synchronisation alone (cluster barriers, DSMEM partials,
neighbour flags, grid barriers) come from ``sync_bench.cu``, built and
run by hand (its header says how).

chip_smoke.py times the main-path shapes in its phase 5; this script is
the version that also runs against an earlier commit. It also times end
to end (float64) config #2's ``expv_chebyshev`` (B1), two-pass
``expv(m=40)`` and ``phiv(k=3, m=40)`` (B2 and then B1 or B4), config
#3's ``expv_chebyshev`` (B5) and the 2-D 512^2 ``expv_chebyshev`` (B6,
chip_smoke.py's "2d cheb" cell).
"""

import os
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

N = 100_000                  # BASELINE config #2
NP = 1000                    # BASELINE config #3: poisson_2d(1000, 1000)
NG = 512                     # the 2-D grid under B6's gate
PARTS = ("b1", "b2", "b4", "b5", "b6", "e2e")


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


def host_us(fn, k=200):
    """Host time per call: k calls on the host clock (enqueued, not waited
    for; few enough that the launch queue does not fill), then one
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / k * 1e6


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


def main() -> int:
    if not torch.cuda.is_available():
        print("resident_times.py needs a CUDA device", file=sys.stderr)
        return 2
    parts = set(sys.argv[1:]) or set(PARTS)
    if parts - set(PARTS):
        print(f"resident_times.py: parts are {', '.join(PARTS)}",
              file=sys.stderr)
        return 2
    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch.ops.kernels import resident as tr

    card = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] + "]"
    dev = torch.device("cuda", 0)
    planned = hasattr(tr, "LanczosPlan")
    rng = np.random.default_rng(8)
    device_jobs = []       # (label, fn, kernel name), profiled at the end
    b2b = {}               # (kernel, form, dtype name, n, m) -> ms

    def line(key, label, fn, kname):
        one, burst, host = median_ms(fn), burst_ms(fn), host_us(fn)
        b2b[key] = burst
        device_jobs.append((key, label, fn, kname))
        print(f"resident {label}: one call {one:.4f} ms, back-to-back "
              f"{burst:.4f} ms, host {host:.2f} us per call {card}",
              flush=True)

    def b2_form(op, dt):
        if not planned:
            return "grid"
        plan = tr.lanczos_plan(op, dt, dev)
        return (f"cluster form, {plan.cluster} blocks" if plan.form ==
                "cluster" else "grid form")

    def b2(n, dt, ms):
        dn = str(dt).split(".")[-1]
        op = et.laplacian_nd_stencil(n, dtype=dt, device=dev)
        b = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
        v0 = b / torch.linalg.vector_norm(b)
        tol = 1e-7 if dt == torch.float64 else 1e-4
        form = b2_form(op, dt)
        for m in ms:   # partials, not closures: profiled after the loop
            line(("B2", form, dn, n, m), f"B2 {dn} n={n} m={m} ({form})",
                 partial(tr.resident_lanczos, op, v0, m, tol), "lanczos")
        return op, b

    def b4(op, b, dt, ms):
        dn, n = str(dt).split(".")[-1], op.shape[0]
        rows = {m: torch.as_tensor(rng.standard_normal((m, 4)) * 0.5,
                                   dtype=dt, device=dev) for m in ms}
        for r in rows.values():
            r[:, 0] *= 2.0 / float(op.opnorm_hint())
        cw = {m: torch.as_tensor(rng.standard_normal((m, 4)), dtype=dt,
                                 device=dev) for m in ms}
        forms = {"family": partial(tr.recurrence_apply_resident_multi, op)}
        if hasattr(tr, "MultiPlan"):   # the main path's form, and the family
            forms = {tr.multi_plan(op, dt, dev).form(4): forms["family"]}
            forms.setdefault("family", tr.MultiPlan(op, dt, dev,
                                                    form="family"))
        for form, fn in forms.items():
            kname = "nbr" if form == "neighbour" else "family"
            for m in ms:
                line(("B4", f"{form} form", dn, n, m), f"B4 {dn} n={n} p=4 "
                     f"m={m} ({form} form)", partial(fn, b, rows[m], cw[m]),
                     kname)
        return rows

    def scaled_rows(op, dt, m):
        r = torch.as_tensor(rng.standard_normal((m, 4)) * 0.5, dtype=dt,
                            device=dev)
        r[:, 0] *= 2.0 / float(op.opnorm_hint())
        return r

    def b1(op, b, dt, rows):
        dn, n = str(dt).split(".")[-1], op.shape[0]
        forms = {"grid": partial(tr.resident_recurrence, op)}
        if hasattr(tr, "RecurrencePlan"):   # the main path's form, and the grid
            forms = {tr.recurrence_plan(op, dt, dev).form: forms["grid"]}
            forms.setdefault("grid", tr.RecurrencePlan(op, dt, dev,
                                                       form="grid"))
        for form, fn in forms.items():
            for m, r in rows.items():
                line(("B1", f"{form} form", dn, n, m), f"B1 {dn} n={n} m={m} "
                     f"({form} form)", partial(fn, b, r), "resident_")

    def b5(dt, ms):
        dn = str(dt).split(".")[-1]
        op = et.poisson_2d(NP, NP, dtype=dt, device=dev)
        b = torch.as_tensor(rng.standard_normal(NP * NP), dtype=dt,
                            device=dev)
        forms = {"family": partial(tr.recurrence_apply_resident_banded, op)}
        if hasattr(tr, "BandedRecurrencePlan"):
            plan = tr.banded_plan(op, dt, dev)
            forms = {plan.form: forms["family"]}
            forms.setdefault("family", tr.BandedRecurrencePlan(
                op, dt, dev, form="family"))
            print(f"B5 {dn} config #3: {plan.form} form, {plan.grid} blocks "
                  f"of {plan.chunk} rows, {plan.kd} of {plan.k} diagonals in "
                  f"shared memory {card}", flush=True)
        for form, fn in forms.items():
            for m in ms:
                line(("B5", f"{form} form", dn, NP * NP, m), f"B5 {dn} "
                     f"poisson_2d({NP}, {NP}) m={m} ({form} form)",
                     partial(fn, b, scaled_rows(op, dt, m)), "Banded")

    def box27(shape, dt):
        offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)]
        return et.StencilOperator(
            shape, offs, np.asarray([-26.0 if o == (0, 0, 0) else 1.0
                                     for o in offs]),
            is_hermitian=True, dtype=dt, device=dev)

    def b6(dt, ms):
        dn = str(dt).split(".")[-1]
        for label, op in (
                (f"{NG}^2 5-point", et.laplacian_nd_stencil(
                    NG, NG, dtype=dt, device=dev)),
                ("1000^2 5-point", et.laplacian_nd_stencil(
                    1000, 1000, dtype=dt, device=dev)),
                ("64^3 7-point", et.laplacian_nd_stencil(
                    64, 64, 64, dtype=dt, device=dev)),
                ("64^3 27-point box", box27((64, 64, 64), dt))):
            b = torch.as_tensor(rng.standard_normal(op.shape[0]), dtype=dt,
                                device=dev)
            forms = {"family": partial(tr.recurrence_apply_resident_grid,
                                       op)}
            if hasattr(tr, "GridRecurrencePlan"):   # the main path's form,
                plan = tr.grid_plan(op, dt, dev)   # and the family kernel
                forms = {plan.form: forms["family"]}
                forms.setdefault("family", tr.GridRecurrencePlan(
                    op, dt, dev, form="family"))
                t = plan.tiles
                print(f"B6 {dn} {label}: {plan.form} form, {t.grid} tiles "
                      f"of {t.tz} x {t.ty} lines, {plan.smem} bytes of "
                      f"shared memory a block {card}", flush=True)
            for form, fn in forms.items():
                kname = "resident_grid_nbr" if form == "neighbour" else "Grid3D"
                for m in ms:
                    line(("B6", f"{form} form", dn, label, m), f"B6 {dn} "
                         f"{label} m={m} ({form} form)",
                         partial(fn, b, scaled_rows(op, dt, m)), kname)

    for dt in (torch.float32, torch.float64):
        if parts & {"b2", "b4", "b1"}:
            op, b = b2(N, dt, (20, 40) if "b2" in parts else ())
            rows = b4(op, b, dt, (12, 40) if "b4" in parts else ())
            if "b1" in parts:
                b1(op, b, dt, rows or {m: scaled_rows(op, dt, m)
                                       for m in (12, 40)})
        if "b5" in parts:
            b5(dt, (4, 8, 16))
        if "b6" in parts:
            b6(dt, (8, 15, 30))
    # the sizes around B2's gate and B4 with chunks three times config #2's
    for dt, sizes in ((torch.float64, (131_000, 150_000, 230_000)),
                      (torch.float32, (200_000, 300_000, 360_000, 460_000))):
        if "b2" in parts:
            for n in sizes:
                b2(n, dt, (40,))
        if "b4" in parts:
            op, b = b2(300_000, dt, ())
            b4(op, b, dt, (12,))
    # end to end (float64): config #2 (t = 0.5), expv_chebyshev (B1) and
    # the two-pass calls that run B2 then B1 (expv) or B2 then B4 (phiv,
    # k = 3); config #3 (t = 1e-4), expv_chebyshev (B5); the 2-D 512^2
    # Laplacian (t = 0.5), expv_chebyshev (B6)
    op = et.laplacian_nd_stencil(N, device=dev)
    b = torch.as_tensor(rng.standard_normal(N), device=dev)
    opP = et.poisson_2d(NP, NP, device=dev)
    bP = torch.as_tensor(rng.standard_normal(NP * NP), device=dev)
    opG = et.laplacian_nd_stencil(NG, NG, device=dev)
    bG = torch.as_tensor(rng.standard_normal(NG * NG), device=dev)
    e2e = (("config #2 expv_chebyshev(tol=1e-12)", partial(
        et.expv_chebyshev, 0.5, op, b, tol=1e-12)),
           ("config #2 expv(m=40, two_pass=True)", partial(
               et.expv, 0.5, op, b, m=40, two_pass=True)),
           ("config #2 phiv(k=3, m=40, two_pass=True)", partial(
               et.phiv, 0.5, op, b, 3, m=40, two_pass=True)),
           ("config #3 expv_chebyshev(tol=1e-12)", partial(
               et.expv_chebyshev, 1e-4, opP, bP, tol=1e-12)),
           (f"2-D {NG}^2 expv_chebyshev(tol=1e-12)", partial(
               et.expv_chebyshev, 0.5, opG, bG, tol=1e-12)))
    for label, fn in e2e if "e2e" in parts else ():
        one = [median_ms(fn) for _ in range(3)]
        print(f"end-to-end {label} float64: one call "
              f"{' / '.join(f'{t:.4f}' for t in one)} ms (three medians of "
              f"10), back-to-back {burst_ms(fn):.4f} ms {card}", flush=True)

    def slopes(times, how):
        """The per-step slope of each kernel and form timed at several m:
        between the smallest and the largest m."""
        groups = {}
        for (kernel, form, dn, n, m), ms in times.items():
            if ms is not None:
                groups.setdefault((kernel, form, dn, n), {})[m] = ms
        for (kernel, form, dn, n), by_m in groups.items():
            if len(by_m) < 2:
                continue
            lo, hi = min(by_m), max(by_m)
            where = f"n={n}" if isinstance(n, int) else n
            print(f"per-step {kernel} {dn} {where} ({form}), {how} slope over "
                  f"m = {lo}..{hi}: "
                  f"{(by_m[hi] - by_m[lo]) / (hi - lo) * 1e3:.3f} us {card}",
                  flush=True)

    slopes(b2b, "back-to-back")
    dev_ms = {}
    for key, label, fn, kname in device_jobs:
        dms = device_ms(fn, kname)
        dev_ms[key] = dms
        print(f"device {label}: "
              + (f"{dms:.4f} ms per launch" if dms is not None else
                 "not measured (the profiler missed launches)")
              + f" {card}", flush=True)
    slopes(dev_ms, "device")
    return 0


if __name__ == "__main__":
    sys.exit(main())

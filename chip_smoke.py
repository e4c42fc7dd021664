#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root; one card)
    python3 chip_smoke.py --profile  (phases 1-4, then device profiles)
    python3 chip_smoke.py --graphs-only [--profile]
                                     (phases 1-2 and the sixth path)
    python3 chip_smoke.py --krylov-graphs-only [--profile]
                                     (phases 1-2 and the seventh path)
    python3 chip_smoke.py --serving-only [--profile]
                                     (phases 1-2, R1's checks, the eighth
                                     path and R1's times)
    python3 chip_smoke.py --fixed-fused-only [--profile]
                                     (phases 1-2 and the ninth path)
    python3 chip_smoke.py --poly-graphs-only [--profile]
                                     (phases 1-2 and the tenth path)
    python3 chip_smoke.py --batched-only [--profile]
                                     (phases 1-2 and the eleventh path)

The main paths are exp(tA)b and the phi-function actions
[phi_0(tA)b ... phi_3(tA)b] at BASELINE.json's sizes: for Hermitian
operators the 1-D Laplacian at n = 100,000 (config #2), the 2-D 5-point
Poisson matrix on 1000 x 1000 in diagonal storage (config #3, phiv p=0..3
at t = 1e-4), the 3-D 7-point Laplacian on 216^3 = 10,077,696 rows
(config #5 on one card), and a 2-D 512^2 stencil small enough for the
one-launch grid kernel; and the sparse containers at n = 1e6: the
banded-random matrix of benchmarks/bench_sell.py and the scattered-degree
matrix of benchmarks/bench_sorted.py (both symmetrized) in SELL-C-sigma
form (default, segmented and sorted packs), config #3's Poisson matrix
plus a random residual as a hybrid (banded + SELL), and the 3-D Laplacian
on 128^3 in 8 x 8 block-ELL; the variable-coefficient div(a grad u) on
216^3 with a ~ U(0.5, 2) (benchmarks/bench_var.py's operator, kernel
B3-var); and the non-Hermitian Arnoldi path: config #1's dense 100 x 100
matrix (expm and expv, m = 40) and config #4's advection_diffusion_1d(2000,
Pe = 10) at t = 1e-4 (expv, phiv k = 1 and the storage-free IOP two-pass,
each matvec on kernel B7). Phases, each printing one line per check and
its seconds:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the kernels of ops/kernels/csrc/ (seconds)
  3. kernels  B1-B10 and B3-var against their plain twins, float32 and
              float64, at the main paths' shapes and at shapes ragged
              against B3's tiles and z chunks, plus bitwise-repeatable
              results (B3's plain and accumulating moments, B8 on offset
              views of its operands); B7 on ragged shapes (n odd, n under
              one block, offsets wider than n, one and 64 diagonals), on
              offset views of x and the diagonals and with every block an
              edge block, bit for bit; B10 with a row of 5000 segments
              and empty rows at n = 3001; B2's cluster form on ragged
              shapes (n not a multiple of C x 1024, n < C, max|o| = L,
              5 points, m = 0 and 1; the grid form above its gate), B4's
              neighbour form bit for bit against the family kernel (p =
              1, 4, 8; 3 and 5 points; ragged chunks, max|o| = chunk),
              and config #2's plans on the cluster and neighbour forms;
              B1's and B5's plans on their neighbour forms (B1 also past
              its gate, n = 1.5M float64 / 3M float32, on the grid form;
              B5 bit for bit against its family kernel); B6's plan on its
              neighbour form (tiles of whole x-lines) at 512^2 5-point,
              64^3 7-point and 64^3 27-point box, bit for bit against
              its family kernel;
              B1 (bench_leja.py's 1-D advection-diffusion at n = 1e6, and
              a 5-point |o| = 2 variant), B5 (config #4's operator), B6
              (a 512^2 2-D advection stencil) and B3 (the 216^3
              advection-diffusion stencil) on these non-symmetric
              operators with Leja Newton rows (cc = 0) and Faber rows
              (cc_0 = 0, cc_1 = -2 rho), B5 and B6 also bit for bit against
              their family kernels;
              per SELL pack, the share of B9's 256-row blocks
              that stage x in shared memory (none of the band-20000
              pack's; phase 4 adds the RCM'd n = 1e6 pack, held to more
              than half, and the scattered packs); B3/B3-var on the
              fourth path's extended slabs; B7 on the GSPMD route's
              halo-extended slabs (configs #3 and #4, every rank of P =
              4) against LocalBandedOperator's plain matvec, and B8 on a
              rank's block rows with the whole x (a rectangular product);
              R1 (the port's own kernel, the Hermitian reduced
              exponential) against its eigh twin in float32 and float64
              (tridiag_checks: m = 1 to 250, a breakdown, complex t, s,
              and the hard inputs of tests/tridiag_cases.py)
  4. main     the public entry points (expv_chebyshev, expv with and
              without two_pass, phiv with and without two_pass,
              phiv_chebyshev, phiv_timestep_chebyshev) with launch counts
              reset just before and read just after, each call's launches
              held to the exact expected count; results checked against
              scipy (1-D, config #1, the dense config #4 oracle, and
              expm_multiply on the n = 1e6 SELL matrix and a 48^3
              variable operator), by the semigroup identity (3-D,
              constant and variable), the phi identities
              t A phi_{j+1} = phi_j - b/j!, and cross-method or cross-pack
              agreement; a two-pass call is one sweep and one second
              stage (``sweep_stage``) per step, and the replay's alpha and
              beta equal pass 1's bit for bit; every B4 launch of config
              #2 on the neighbour form, and every B1 launch of config #2's
              expv_chebyshev and two-pass expv and every B5 launch of
              config #3's expv_chebyshev on the neighbour form (counted
              by their plans), and the 2-D 512^2 expv_chebyshev's B6
              launch on the neighbour form; the adaptive drivers on config
              #4 (run_baseline.py's phiv_timestep, kiops,
              phiv_timestep_device and kiops_device, the default-m NW and
              its two-pass, make_phiv_timestep and its fn(B), expv_taylor;
              each within 1e-10 of the dense oracle, stats printed beside
              the JAX package's) and on config #3's operator at n = 1e6
              with p = 3 (kiops, two-pass NW; 1e-6 against the phiv
              columns and each other), each call's B7 launches held to
              the count its own stats imply; the kernel-driving passes and
              make_phiv_timestep's fn(B) rerun under
              torch.cuda.set_sync_debug_mode("error"); then a second path,
              its counts set to 0 before it and read after: Leja and Faber
              (phiv_timestep_leja/_faber on bench_leja.py's n = 1e6
              operator with B = (n, 3), held to each other and to the
              Krylov phiv_timestep_device at 1e-6; expv_faber m = 64 on the
              216^3 advection stencil, held to the semigroup identity and
              to Arnoldi expv(m=64); expv_leja, expv_faber and phiv_leja
              on config #4's operator against the dense oracle; both on a
              512^2 2-D advection stencil), each call's B1, B3, B5 or B6
              launches held to the count its substeps and columns imply;
              the integrators on bench_integrators.py's Allen-Cahn
              (etdrk4 and etdrk4_device at 2048^2, three steps; exprb43
              and exprb43_device at 1024^2 with equal steps and
              rejections; exprb32 with JacobianOperator over a
              BandedOperator f, its B7 launches = f's plain calls + 2 x
              its calls under torch.func.jvp, against the analytic
              Jacobian); a step of etdrk4_device and of exprb43_device's
              fixed mode and a JacobianOperator matvec over B7 also run
              under sync debug mode "error"; then a third path, its
              counts set to 0 before it and read after: the dense layer
              (config #1's expm by all seven methods and with
              balance=True, phi (Pade) and phi_taylor, funm with the
              device Parlett, against scipy and the block oracle;
              phi_pade at n = 256, k = 3 (accuracy_f64.py) with JAX's
              (branch, s) and one host read under sync debug mode;
              bench_dense_mfu.py's stacks of 1-norm 20 in float32 and
              float64 through expm and phi(X, 4), against the per-matrix
              call and scipy; expm_dd at n = 32 against expm_mp at 300
              bits, the card's bits equal to the CPU's), expv_batched on
              config #2 (8 columns, two-pass: one K3, one K2, K4's groups)
              and config #3 (4 columns, m = 30: 30 fused Lanczos
              steps, each K1's Lanczos form and K5, one K2), and the
              gradients: config #4's
              ||expv(t, op, b, m=40)||^2 in b and op.diags (40 B7 forward
              + 40 backward, held to the plain twin's autograd on the
              card), the x-gradient of the n = 1e6 SELL matrix (2 B9),
              expv_chebyshev on config #2's stencil with a requires-grad
              b (no B1: the grad rule, counted), and
              expm_higham2005(differentiable=True) under torch.func.grad
              and sync debug mode "error"; then a fourth path, the
              distributed layer (parallel/) on ranks of this script
              sharing the card (sharded_path); then a fifth, the GSPMD
              route (gspmd_path): parallel.shard_operator's views of
              config #3's, config #4's, an ELL, the 128^3 block-ELL and
              config #1's dense operator and the n = 1e6 Leja stencil
              under the ordinary drivers (expv, kiops, the two-pass NW,
              expv_chebyshev, phiv_timestep_device, kiops_device,
              exprb43_device, Leja, Faber) on P = 2 gloo ranks, the data x
              shard expv_batched on P = 4, config #3's expv and kiops on
              one NCCL rank; each against the single-device port (equal
              stats for the adaptive drivers) and scipy, every rank's B7
              and B8 launches held to its driver's matvec count; then a
              sixth, the device loops from CUDA graphs (graph_path):
              config #4's phiv_timestep_device, kiops_device and
              exprb43_device, etdrk4_device at 2048^2 and
              exprb43_device at 1024^2, each with its route, captures
              (one per step and bucket run twice or more), replays,
              blocking reads (at most bucket changes + 2) and B7
              executions (captured launches times replays, held to
              their steps' executions) printed and held, against the
              same steps run eagerly (1e-14, equal stats) and its dense
              oracle or host driver; then a seventh, the Krylov builders
              from CUDA graphs (krylov_graph_path: B7, B8, B9 and B9 +
              B10 replayed from a graph against their twins; config #4's
              expv, phiv k = 1 and IOP two-pass at m = 250, kiops and
              phiv_timestep m = 20; config #3's phiv k = 3 m = 30 and
              expv_batched; config #1's expv m = 40; SELL n = 1e6 expv
              m = 40, default and seg packs; the 128^3 block-ELL two-pass
              m = 20), each against its oracle and the same call under
              graphs.eager() (1e-14, equal stats), its captures and
              replays (after step 0, one capture and m - 2 graph
              launches a builder call of m >= 4) and kernel executions
              held, both forms'
              CUDA-event medians of 5 printed; then an eighth, the
              serving closures and the error-estimate loop
              (serving_path: make_expv / make_phiv on configs #1, #3,
              #4 and SELL n = 1e6, calls 1-12 each with 1 capture and 10
              replays, no sync in a replayed call, bit-equal to the
              eager closure and held to the cell's oracle; the
              error-estimate loop with the CPU's iteration count); then a
              ninth, the fixed NW stepper and the fused passes from CUDA
              graphs (fixed_fused_path: config #4's make_phiv_timestep
              fn(B) at calls 1, 2 and 3 with 1 eager call, 1 capture and
              1 replay, and phiv_timestep_fused with 1 eager substep, 1
              capture and nsteps - 1 replays, B7 executions nsteps (1 +
              m) a call, against the dense oracle; two-pass expv m = 20
              on 512^2 and on 216^3, constant and variable, one capture
              a pass, 2 (m + 1) sweeps and stages a call, against
              expv_chebyshev; each call bit-equal to graphs.eager(), its
              graph form under sync debug mode "error"; B3 and B3-var in
              their device-index form against their twins and bit-equal
              to the host-index form, both forms timed back to back);
              then a tenth, the Chebyshev, Leja, Faber and Taylor loops
              from CUDA graphs (poly_graph_path: 216^3 expv_chebyshev,
              constant and variable, tol 1e-12, one B3 / B3-var pass in
              the device-index form with the second stage in recurrence
              mode, that form bit-equal to the host-index form and within
              KTOL of the twin; the 216^3 advection expv_faber(m=64); SELL
              n = 1e6 expv_chebyshev, the plain degree scan on B9; config
              #3 phiv_timestep_chebyshev, the combination scan on B7;
              config #4 expv_leja, expv_faber, phiv_leja on B5; the n =
              1e6 phiv_timestep_leja / _faber with B (n, 3), one B1
              substep a step; config #4 expv_taylor on B7 and a dense
              expv_taylor_batched), each cell's captures, replays and
              kernel executions held exact, its result bit-equal to
              graphs.eager() and within its oracle's limit, its loop rerun
              under sync debug mode "error", both forms' CUDA-event
              medians of 5 and the card's peak memory printed; phase 3
              also holds B2 on b in an invariant subspace of dimension
              exactly m (broke and m_used as the plain lanczos_coeffs);
              the whole script profiles its cells at the end of phase 5;
              then an eleventh, expv_batched as one batched build
              (batched_path: config #3 with B (16, n), Lanczos by the
              fused step, K1's Lanczos form and K5 a step, no torch op
              over (16, n) in the step, and one K2; config #2 two-pass
              with B (8, n), K3, K2 and K4, a zero row and an
              eigenvector row; config #4 with B (16, n), Arnoldi m = 250
              on K1; each cell's kernel executions and captures exact,
              each row within 1e-13 of its scalar expv, the cell within
              1e-10 of its oracle, batched against per-row timed in
              turns; K1-K4 against their twins and bit for bit against
              B7, R1, B2 and B1 on each row, K4's sums within 1e-14; K1's
              Lanczos form and K5 each against its twin at the cell's
              shape, bits repeating; a replayed step, fused and unfused;
              the kernels' times, bounds and library calls).
              The builders run from
              graphs on every path but the sharded ones, so a kernel's
              count is its executions (captured launches times replays),
              not its host launches
  5. times    CUDA-event medians of 10 runs after warm-up for the
              kernels, of 5 for the main-path calls (of 3 after one for
              the adaptive drivers), each kernel
              beside its plain twin, B6 (its main-path form and its
              family kernel) beside the B3 sweeps on the same grid at
              512^2, 1000^2, 64^3, 100^3, 128^3, 160^3 and 216^3 (the
              gate's table), B9 at bench_sell.py's timing shape (n = 1e7)
              with its GB/s and Gnnz/s, the sharded and GSPMD cells (rank
              0's medians) beside the single-device call, each main-path
              call beside the
              plain path, and for each kernel its bound (the larger of its bytes
              over 3.35 TB/s and its operations over the vector peak) and
              the time of the one PyTorch call that computes the same
              function, where there is one (CSR or BSR products,
              segment_reduce). A median of one call also counts the host's
              part of it (two events alone read 9-25 us on the H100's
              host), so every kernel and the library calls are also timed
              20 calls back to back (the device's time per call where the
              host enqueues faster than the device runs; B3's with its
              second stage), every kernel also by its kernel events
              under torch.profiler (the device time per launch, taken
              last: after the profiler has run, every launch costs the
              host more), beside a 3-stream torch.add at 216^3 (the
              card's reachable streaming rate); B7 also at
              config #4's n = 2000 and through banded_spmv (a plan built
              per call), B9 also on a copy of its pack with no staging
              budget (x gathered from global memory in every block); B1,
              B5, B6 and B3 at the second path's non-symmetric shapes; each
              cell of the second path (a median of 3 where its phase-4
              call took under 2 s, else that call); each cell of the third
              path, each stack beside torch.linalg.matrix_exp on it and
              with the TFLOP/s its degree (or Taylor order) and squaring
              count imply

It prints a JSON line of the kernels, then the card's name and power
limit, then {"ok": true, "device": {...}} as the last line. Any failed
check raises, so the exit code is non-zero and no result line is printed;
without a CUDA device it exits with code 2 at once.

With --profile, phase 5 is replaced by torch.profiler over one warm call
of each sparse, variable and non-Hermitian main-path cell (config #3
phiv, the SELL expv, two-pass, expv_chebyshev and its spectral_bounds,
the block-ELL two-pass; the 216^3 variable Chebyshev and two-pass, the
216^3, 2-D 512^2 and 1-D (config #2) constant two-pass, the 1-D
two-pass phiv; config #1 expm and expv; config #4 expv, phiv and the IOP
two-pass, and config #4's phiv_timestep, kiops, phiv_timestep_device and
kiops_device; the n = 1e6 Leja and Faber drivers, 216^3 expv_faber,
config #4's expv_leja and expv_faber, 2048^2 etdrk4_device, config
#4's exprb43_device and the 1024^2 exprb43_device; config #1's
diagonalization and schur expm, the float64 stacks' expm (512 x 128 and
32 x 512, and torch.linalg.matrix_exp on the first) and phi, the config
#4 gradient): the
CUDA-event wall time, the device busy time (union of the device
intervals), the number of device ops, the largest kernels and the host
ops of most self time. It prints no result lines then.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
N1 = 100_000            # BASELINE config #2
N3 = 216                # BASELINE config #5 on one card: 216^3 rows
T1, T3 = 0.5, 0.05      # run_baseline.py's times for the two configs
NP = 1000               # BASELINE config #3: poisson_2d(1000, 1000)
TP = 1e-4               # run_baseline.py's time for config #3
K = 3                   # phi orders 0..K, as config #3 runs them
NG, TG = 512, 0.5       # 2-D grid under the B6 gate
THREE, FIVE = (-1, 0, 1), (-2, -1, 0, 1, 2)     # 1-D stencil offsets
B2_ABOVE_GATE = {"float32": 600_000, "float64": 300_000}   # B2's grid form
B1_PAST_GATE = {"float32": 3_000_000, "float64": 1_500_000}   # B1's grid form

# Kernel against twin, max-norm relative: float32 sums in another order
# and contracts to FMA; float64 agrees to a few ulps of the output.
KTOL = {"float32": 1e-5, "float64": 1e-12}
# Main path against scipy / the semigroup identity / the other method.
# Calibrated on CPU from the JAX package at the same settings:
#   1-D n = 1e5, t = 0.5 vs scipy expm_multiply: float64 Chebyshev
#   (tol 1e-12) 1.25e-12, two-pass m = 40 2.2e-15, happy breakdown
#   m = 30 1.1e-15; float32 Chebyshev 2.1e-7, two-pass 8.8e-7.
#   3-D 48^3 (216^3 is too large for that CPU), t = 0.05, m = 20: float64
#   semigroup 9.5e-14 (Chebyshev) and 8.8e-16 (two-pass), cross-method
#   8.8e-14; float32 semigroup 1.1e-7 and 5.5e-8, cross-method 4.3e-7.
MTOL_SCIPY64 = 1e-10    # BASELINE's target
MTOL_SCIPY32 = 1e-5
MTOL3 = {"float64": 1e-10, "float32": 1e-5}
# phi paths, float64, calibrated the same way (JAX package on CPU):
#   1-D n = 1e5, t = 0.5, k = 3: phi identities 3.9e-16 (phiv m = 30),
#   4.4e-16 (two-pass m = 40), 1.4e-12 (phiv_chebyshev, tol 1e-12);
#   phi_0 vs scipy 3.3e-16 / 3.5e-16 / 1.3e-12; two-pass vs phiv 2.3e-16,
#   Chebyshev vs phiv 7.1e-13; phiv_timestep_chebyshev at t = 0.5 vs
#   phi_0 b + t phi_1 b 8.1e-13. Config #3 at t = 1e-4: phi identities
#   1.7e-16, expv_chebyshev vs phiv column 0 2.6e-16. 2-D 512^2 at
#   t = 0.5: Chebyshev vs two-pass m = 20 4.6e-13.
MTOL_PHI = 1e-10
# The sparse containers, float64, calibrated the same way (JAX package on
# CPU at n = 1e5, the same matrix classes and settings, t = 0.5): SELL
# (RCM) expv m = 40 vs scipy expm_multiply 1.0e-15 (two-pass 1.1e-15,
# Chebyshev tol 1e-12 7.2e-13); scattered default pack vs scipy 1.1e-15,
# seg and sorted expv vs the default pack 1.4e-15 / 1.5e-15; sorted phiv
# (k = 3, m = 30) phi identities 4.4e-16, phi_0 vs the default expv
# 1.0e-15; hybrid (poisson_2d(300, 300) + residual) vs the default pack
# 9.4e-16; block-ELL two-pass vs the stencil two-pass (32^3, t = 0.05,
# m = 20) 1.2e-15.
MTOL_SPARSE = 1e-10

# The variable-coefficient path (216^3 div(a grad u), t = 0.05), calibrated
# the same way on a 48^3 field (216^3 is too large for that CPU): float64
# semigroup 7.4e-13 (Chebyshev, tol 1e-12) and 7.9e-16 (two-pass m = 20),
# Chebyshev vs two-pass 8.0e-13, vs scipy expm_multiply 8.0e-13 / 7.7e-16;
# float32 semigroup 1.4e-7 and 6.5e-8, cross-method 5.2e-7.
MTOL_VAR = {"float64": 1e-10, "float32": 1e-5}
NV = 48                 # the variable operator held to scipy
# The non-Hermitian path, float64, calibrated the same way: config #1
# expm vs scipy 4.0e-16, expv m = 40 7.4e-16; config #4 (t |A| = 1606) with
# m = 250: expv and phiv (phi_0 b + t phi_1 (0.1 b), run_baseline.py's
# oracle) vs the dense oracle 2.0e-13 (m = 200 reaches 6.8e-12, m = 150
# 3.6e-7), the IOP two-pass (iop = 2) vs expv(iop=2, reorth=False) 6.3e-14.
MTOL_NONHERM = 1e-10
MTOL_IOP = 1e-12
# reduced="host" (host scipy) against the device form, calibrated the same
# way (the JAX package's host against its device form): config #2's
# two-pass expv m = 40 2.9e-16, config #4's expv m = 250 2.5e-14 and phiv
# k = 1 m = 250 2.5e-14
MTOL_HOST2 = 1e-13
JAX_HOST = {"config2 expv": 2.9e-16, "config4 expv": 2.5e-14,
            "config4 phiv": 2.5e-14}
# The adaptive drivers at tol = 1e-7 on config #3's n = 1e6 operator (p = 3,
# t = 1e-4): against the phiv columns' combination and each other, at
# 10 x their tolerance. On config #4 they are held to MTOL_NONHERM: the JAX
# package on the CPU reaches 1.3e-13 (phiv_timestep), 3.0e-11 (kiops and
# kiops_device) and 4.3e-13 (phiv_timestep_device) against the oracle.
MTOL_DRIVER = 1e-6
NA, TA, MA = 2000, 1e-4, 250     # config #4's operator, time and m here

# The non-Hermitian polynomial actions and the integrators (phase 4's second
# path), float64, calibrated on the CPU from the JAX package:
#   config #4's operator at t = 1e-4, tol = 1e-12, vs the dense oracle:
#   expv_leja 2.9e-12 (q = 11 substeps of degree 64), expv_faber 3.4e-13
#   (q = 1, degree 212); phiv_leja (k = 1) at z = |t| s = 20 vs its own
#   augmented oracle 3.7e-13;
#   expv_faber on advection_diffusion_3d_stencil at 48^3, t = 30/gamma,
#   m = 64: semigroup 1.3e-13, vs Arnoldi expv(m=64) 1.2e-13 (m = 40:
#   9.5e-6);
#   bench_integrators.py's Allen-Cahn (nu = 1e-4, h = 0.02, m = 16, three
#   steps): etdrk4_device vs etdrk4 5.2e-17 at 256^2, 4.8e-16 at 512^2;
#   exprb43 vs exprb43_device (rtol 1e-5, atol 1e-7, m = 24, t = 0.5) at
#   256^2: 12 steps, no rejection each, 9.6e-14.
NL, DL, AL = 1_000_000, 1e3, 2e2     # bench_leja.py: n, diffusion, advection
TL = 1.0                             # its horizon: t s = 1100
NF, MF, ZF = 216, 64, 30.0           # bench_faber_fused.py: grid, m, t gamma
NU_AC, H_AC, M_AC = 1e-4, 0.02, 16   # bench_integrators.py's Allen-Cahn
NE, E_STEPS = 2048, 3                # etdrk4 at 2048^2, three steps
NR, TR, M_R = 1024, 0.5, 24          # exprb43 at 1024^2 (bench: tf = 0.5)
TJ = 0.05                            # exprb32 on the banded Allen-Cahn
MTOL_POLY = 1e-10       # config #4 oracle, Faber 216^3 semigroup and Arnoldi
MTOL_ETD = 1e-10        # etdrk4_device vs etdrk4
MTOL_EXPRB = 1e-8       # exprb43_device vs exprb43 (rtol 1e-5)

# The dense layer and the gradients (phase 4's third path), float64 unless
# stated, calibrated on the CPU from the JAX package at the same settings
# (printed beside each check as "JAX on the CPU"):
#   config #1 (run_baseline.py:72-74, 100 x 100) vs scipy expm: higham2005
#   4.0e-16, generic 1.0e-14, diagonalization 8.3e-15, native 6.0e-16,
#   taylor 3.0e-15, schur (parlett="device") 6.9e-15, gebal 4.0e-16,
#   higham2005 balance=True 4.0e-16; phi(A, 3) (Pade) 4.7e-16 and
#   phi_taylor 2.7e-15 against the block oracle; funm(A, "exp") 6.9e-15;
#   phi_pade at n = 256, k = 3 (benchmarks/accuracy_f64.py:106-124)
#   1.2e-15 against the host block oracle, with (i, s) = (6, 3);
#   bench_dense_mfu.py's stacks (1-norm 20; the first 8 elements, which
#   take the whole stack's degree and s): expm vs scipy float32 1.2e-6,
#   1.5e-6, 2.1e-6 and float64 6.7e-16, 7.6e-16, 1.2e-15 at (512, 128),
#   (128, 256), (32, 512); phi(X, 4) vs the block oracle float32 3.0e-6,
#   4.6e-6, 7.1e-6 and float64 5.4e-15, 8.5e-15, 9.3e-15; the batched call
#   equals the per-matrix one bit for bit;
#   expm_dd at n = 32 against expm_mp (300 bits) 2.6e-31 (expm_mp 4.6 s);
#   expv_batched on config #2 (m = 40, two-pass; JAX's reduced="host") vs
#   scipy expm_multiply 1.0e-15, 1.5e-15.
MTOL_DENSE = {"float64": 1e-10, "float32": 2e-5}   # PERF.md 2; the JAX f32 test
MTOL_DD = 1e-29          # expm_dd vs expm_mp, max-norm relative
MTOL_GRAD = 1e-12        # kernel gradients vs the plain twin's autograd
MTOL_GRAD_CPU = 1e-10    # the gated call's gradient vs the CPU's
DENSE_JAX = {
    "config1 expm higham2005": 4.0e-16, "config1 expm generic": 1.0e-14,
    "config1 expm diagonalization": 8.3e-15, "config1 expm native": 6.0e-16,
    "config1 expm taylor": 3.0e-15, "config1 expm schur": 6.9e-15,
    "config1 expm gebal": 4.0e-16, "config1 expm_higham2005 balance": 4.0e-16,
    "config1 phi pade": 4.7e-16, "config1 phi_taylor": 2.7e-15,
    "config1 funm exp": 6.9e-15, "phi_pade 256": 1.2e-15,
    "config1 funm jnp.exp": 6.9e-15,
    "expm_dd 32": 2.6e-31, "expv_batched config2": 1.5e-15,
    **{f"stack {b}x{n} {dn} {what}": e
       for (b, n), e32, e64, p32, p64 in (
           ((512, 128), 1.2e-6, 6.7e-16, 3.0e-6, 5.4e-15),
           ((128, 256), 1.5e-6, 7.6e-16, 4.6e-6, 8.5e-15),
           ((32, 512), 2.1e-6, 1.2e-15, 7.1e-6, 9.3e-15))
       for dn, what, e in (("float32", "expm", e32), ("float64", "expm", e64),
                           ("float32", "phi", p32), ("float64", "phi", p64))},
}
PADE_JAX = (6, 3)        # JAX's (branch, s) for the phi_pade 256 fixture
STACKS = ((512, 128), (128, 256), (32, 512))   # bench_dense_mfu.py's (B, n)
KS = 4                   # phi(X, 4) on the stacks
ND = 32                  # expm_dd: expm_mp at 300 bits takes ~5 s here
NBATCH2, NBATCH3 = 8, 4  # expv_batched columns on configs #2 and #3
TG4 = 1e-6               # the gradient's t on config #4: t |A| = 16
# expv(0.5, DiagonalOperator(d), b, m = 30) with a complex d (n = NDC, Re d
# in [-4, 0], Im d in [-3, 3]) against exp(0.5 d) b; funm(config #1 A,
# torch.exp, matfunc=torch.linalg.matrix_exp) against scipy expm
NDC = 1_000_000
MTOL_CDIAG = 1e-12
# calibrated on the CPU from the JAX package at the same settings:
# funm(A, jnp.exp, matfunc=jax.scipy.linalg.expm) 6.9e-15 vs scipy; its
# DiagonalOperator keeps is_hermitian=True for a complex d
JAX_CDIAG = ("TypeError with its default flag and a real b, 2.2e+07 with a "
          "complex b; is_hermitian=False 8.2e-01 (a real b), 5.5e-16 (a "
          "complex b)")

NS = 1_000_000          # the SELL matrices of bench_sell.py / bench_sorted.py
NS_TIME = 10_000_000    # bench_sell.py's timing shape
NB = 128                # 3-D Laplacian 128^3 as 8 x 8 block-ELL (B8)
TS = 0.5                # SELL and hybrid time (examples/unstructured_sparse_expv.py)

REPLACES = {
    "resident_recurrence": "exponentialutilities_jl_tpu/ops/kernels/resident.py:89",
    "resident_lanczos": "exponentialutilities_jl_tpu/ops/kernels/resident.py:461",
    "resident_multi": "exponentialutilities_jl_tpu/ops/kernels/resident.py:394",
    "resident_banded": "exponentialutilities_jl_tpu/ops/kernels/resident.py:186",
    "resident_grid": "exponentialutilities_jl_tpu/ops/kernels/resident.py:331",
    "fused_sweep": "exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py:380",
    "fused_sweep_var": "exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py:621",
    "banded_spmv": "exponentialutilities_jl_tpu/ops/kernels/spmv.py:134",
    "blockell_spmv": "exponentialutilities_jl_tpu/ops/kernels/spmv.py:42",
    "sell_spmv": "exponentialutilities_jl_tpu/ops/kernels/sell.py:645",
    "seg_compact": "exponentialutilities_jl_tpu/ops/kernels/sell.py:1391",
    # R1 replaces no Pallas kernel: it is the port's own kernel for the
    # eigh formula that XLA compiles there (the Hermitian reduced
    # exponential, _exp_reduced_e1)
    "tridiag_exp": "exponentialutilities_jl_tpu/models/expv.py:72",
    # the batched forms of expv_batched (JAX vmaps B7's, R1's, B2's and
    # B1's callers): K1 for B7, K2 for R1, K3 for B2, K4 for B1
    "banded_spmm": "exponentialutilities_jl_tpu/ops/kernels/spmv.py:134",
    "tridiag_exp_batched": "exponentialutilities_jl_tpu/models/expv.py:72",
    "resident_lanczos_batched":
        "exponentialutilities_jl_tpu/ops/kernels/resident.py:461",
    "resident_recurrence_batched":
        "exponentialutilities_jl_tpu/ops/kernels/resident.py:89",
    # the fused batched Lanczos step: K1's Lanczos form (B7 under the
    # vmapped step) and K5, which replaces no Pallas kernel but the
    # vmapped step's elementwise tail that XLA fuses there
    "banded_spmm_alpha": "exponentialutilities_jl_tpu/ops/kernels/spmv.py:134",
    "lanczos_update": "exponentialutilities_jl_tpu/ops/krylov.py:290",
}
BATCHED_KERNELS = ("banded_spmm", "tridiag_exp_batched",
                   "resident_lanczos_batched", "resident_recurrence_batched",
                   "banded_spmm_alpha", "lanczos_update")
SOURCES = {
    "resident_recurrence": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_family.cu",
    "resident_lanczos": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_cluster.cu",
    "resident_multi": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_family.cu",
    "resident_banded": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_family.cu",
    "resident_grid": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_family.cu",
    "fused_sweep": "exponentialutilities_jl_torch/ops/kernels/csrc/fused_sweep.cu",
    "fused_sweep_var": "exponentialutilities_jl_torch/ops/kernels/csrc/fused_sweep.cu",
    "banded_spmv": "exponentialutilities_jl_torch/ops/kernels/csrc/spmv.cu",
    "blockell_spmv": "exponentialutilities_jl_torch/ops/kernels/csrc/spmv.cu",
    "sell_spmv": "exponentialutilities_jl_torch/ops/kernels/csrc/sell.cu",
    "seg_compact": "exponentialutilities_jl_torch/ops/kernels/csrc/sell.cu",
    "tridiag_exp": "exponentialutilities_jl_torch/ops/kernels/csrc/tridiag.cu",
    "banded_spmm": "exponentialutilities_jl_torch/ops/kernels/csrc/spmv.cu",
    "tridiag_exp_batched": "exponentialutilities_jl_torch/ops/kernels/csrc/tridiag.cu",
    "resident_lanczos_batched": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_cluster.cu",
    "resident_recurrence_batched": "exponentialutilities_jl_torch/ops/kernels/csrc/resident_family.cu",
    "banded_spmm_alpha": "exponentialutilities_jl_torch/ops/kernels/csrc/spmv.cu",
    "lanczos_update": "exponentialutilities_jl_torch/ops/kernels/csrc/lanczos_step.cu",
}


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): 3.35 TB/s of HBM, and outside the tensor cores 67 TFLOP/s
# in float32 and 34 TFLOP/s in float64. Every kernel here runs plain FMA
# code, so those vector peaks bound its operations.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def bound(nbytes: float, flops: float, dn: str):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and
    do ``flops`` operations in dtype ``dn``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[dn] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_max(got, want) -> float:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-300)


def rel_norm(got, want) -> float:
    import torch

    dt = torch.promote_types(got.dtype, torch.float64)
    got = got.to(dt)
    want = want.to(dt)
    return float((got - want).norm() / want.norm())


def bench_sell_coo(n, d, band, rng):
    """The banded-random matrix of benchmarks/bench_sell.py:30-34 (what an
    RCM-permuted mesh or local graph looks like), float64 values / d."""
    rows = np.repeat(np.arange(n, dtype=np.int64), d)
    cols = np.clip(rows + rng.integers(-band // 2, band // 2, n * d), 0, n - 1)
    return rows, cols, rng.standard_normal(n * d) / d


def scattered_coo(n, rng, band=120):
    """The scattered-degree matrix of benchmarks/bench_sorted.py:36-44:
    degrees 6/20/40 shuffled over the rows, the narrow band."""
    deg = np.full(n, 6, np.int64)
    deg[int(0.85 * n):int(0.95 * n)] = 20
    deg[int(0.95 * n):] = 40
    rng.shuffle(deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rng.integers(-band, band, rows.size), 0, n - 1)
    return rows, cols, rng.standard_normal(rows.size) / deg[rows]


def symmetrized(coo, n, rng=None):
    """0.5 (A + A^T) as CSR, scrambled by a random permutation when ``rng``
    is given (examples/unstructured_sparse_expv.py:22-34)."""
    import scipy.sparse as sp

    rows, cols, vals = coo
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    if rng is not None:
        p = rng.permutation(n)
        A = A[p][:, p].tocsr()
    return A


def banded_csr(op):
    """A BandedOperator (diags[k, i] = A[i, i + o_k]) as scipy CSR."""
    import scipy.sparse as sp

    D = op.diags.cpu().numpy()
    n = D.shape[1]
    return sp.diags([D[k][max(0, -o):n - max(0, o)]
                     for k, o in enumerate(op.offsets)], list(op.offsets),
                    shape=(n, n), format="csr")


def laplacian_3d_csr(n):
    """7-point Dirichlet Laplacian on n^3 (x fastest) as scipy CSR."""
    import scipy.sparse as sp

    L = sp.diags([np.ones(n - 1), -2.0 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1])
    eye = sp.identity(n)
    return (sp.kron(sp.kron(L, eye), eye) + sp.kron(sp.kron(eye, L), eye)
            + sp.kron(sp.kron(eye, eye), L)).tocsr()


def bench_leja_stencil(et, n, dt, dev, five_point=False):
    """benchmarks/bench_leja.py's 1-D advection-diffusion (diffusion DL,
    upwind advection AL, not scaled with n), or its 5-point |o| = 2
    variant (4th-order diffusion, 2nd-order upwind advection)."""
    if five_point:
        offs = [(-2,), (-1,), (0,), (1,), (2,)]
        cs = [-DL / 12 - AL / 2, 4 * DL / 3 + 2 * AL, -2.5 * DL - 1.5 * AL,
              4 * DL / 3, -DL / 12]
    else:
        offs = [(-1,), (0,), (1,)]
        cs = [DL + AL, -2 * DL - AL, DL]
    return et.StencilOperator((n,), offs, np.asarray(cs), is_hermitian=False,
                              dtype=dt, device=dev)


def advection_2d(et, n, dt, dev, peclet=10.0):
    """2-D diffusion + upwind x-advection on n^2, h = 1/(n+1): the 2-D
    counterpart of advection_diffusion_3d_stencil."""
    h = 1.0 / (n + 1)
    d, a = 1.0 / h ** 2, peclet / h
    return et.StencilOperator(
        (n, n), [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)],
        np.asarray([-4.0 * d - a, d, d + a, d, d]), is_hermitian=False,
        dtype=dt, device=dev)


def poly_rows(kind, op, m, dt, dev, gen):
    """(m, 4) rows of the Leja Newton form (cc = 0) or the Faber form
    (cc_0 = 0, cc_1 = -2 rho) on the operator's interval / ellipse, with
    random accumulation coefficients."""
    import torch
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl

    cw = gen.standard_normal(m)
    if kind == "Newton":
        c, s = tl._interval_map(op, None)
        rows = tl._newton_rows(cw, tl.leja_points(m), c, 1.0 / s)
    else:
        c, _, _, g, rho = tfb._resolve_ellipse(op, None)
        rows = tfb._faber_rows(cw, c, 1.0 / g, rho)
    return torch.as_tensor(rows, dtype=dt, device=dev)


def nonsym_kernel_checks(et, dev, dt, tol, vec, gen):
    """Phase 3 on non-symmetric constant operators: B1, B5, B6 and B3 (as
    ``recurrence_engine`` picks them) against their plain twins with
    Newton and Faber rows; B5 and B6 also bit for bit against their family
    kernels. Returns the max relative error."""
    import torch
    from exponentialutilities_jl_torch.ops.kernels import dispatch as td
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
    from exponentialutilities_jl_torch.ops.kernels import resident as tr

    dn = str(dt).split(".")[-1]
    cases = (
        (f"1-D n={NL} bench_leja", bench_leja_stencil(et, NL, dt, dev),
         tr.recurrence_apply_resident, 24),
        (f"1-D n={NL} 5-point |o|=2", bench_leja_stencil(et, NL, dt, dev,
                                                         True),
         tr.recurrence_apply_resident, 24),
        (f"config #4 advection_diffusion_1d({NA})",
         et.advection_diffusion_1d(NA, peclet=10.0, dtype=dt, device=dev),
         tr.recurrence_apply_resident_banded, 24),
        (f"{NG}^2 2-D advection", advection_2d(et, NG, dt, dev),
         tr.recurrence_apply_resident_grid, 24),
        (f"{NF}^3 advection_diffusion_3d_stencil",
         et.advection_diffusion_3d_stencil(NF, NF, NF, peclet=10.0, dtype=dt,
                                           device=dev),
         tf.recurrence_apply_fused, 8))
    worst = 0.0
    for label, op, engine, m in cases:
        check(td.recurrence_engine(op, dt, device=dev, hermitian=False)
              is engine, f"{label}: engine {engine.__name__}")
        x = vec(op.shape[0], dt, gen)
        for kind in ("Newton", "Faber"):
            rows = poly_rows(kind, op, m, dt, dev, gen)
            w = engine(op, x, rows)
            if engine is tr.recurrence_apply_resident:
                wr = tr.resident_recurrence_ref(
                    x, rows, op.coeffs, tr._flat_offsets(op),
                    torch.tensor(1.0, dtype=dt, device=dev))[0]
                form = tr.recurrence_plan(op, dt, dev).form
            elif engine is tr.recurrence_apply_resident_banded:
                wr = tr.resident_banded_ref(x, rows, op.diags, op.offsets)
                form = tr.banded_plan(op, dt, dev).form
                check(torch.equal(w, tr.BandedRecurrencePlan(
                    op, dt, dev, form="family")(x, rows)),
                    f"B5 {label}: neighbour and family forms differ")
            else:
                # B6 and the B3 sweeps: the same constant-stencil twin
                wr = tr.resident_grid_ref(x, rows, op.grid_shape, op.offsets,
                                          op.coeffs)
                form = "sweeps"
                if engine is tr.recurrence_apply_resident_grid:
                    form = tr.grid_plan(op, dt, dev).form
                    check(torch.equal(w, tr.GridRecurrencePlan(
                        op, dt, dev, form="family")(x, rows)),
                        f"B6 {label}: neighbour and family forms differ")
            e = rel_max(w, wr)
            check(e <= tol and form in ("neighbour", "sweeps"),
                  f"{engine.__name__} {dn} {label} {kind}: {e:.2e}, {form}")
            worst = max(worst, e)
            print(f"kernel {engine.__name__} {dn} {label}, {kind} rows "
                  f"m={m}: rel err {e:.2e} (tol {tol:g}); {form} form",
                  flush=True)
    return worst


def allen_cahn(et, n, dev):
    """bench_integrators.py's 2-D Allen-Cahn, u' = nu Lap u + u - u^3 on
    n^2, Dirichlet (make_problem): the Laplacian stencil and u0, float64."""
    import torch

    dx = 1.0 / (n + 1)
    op = et.StencilOperator(
        (n, n), [(0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)],
        np.asarray([-4.0, 1.0, 1.0, 1.0, 1.0]) / dx ** 2 * NU_AC,
        is_hermitian=True, device=dev)
    yy, xx = np.meshgrid(np.arange(1, n + 1) / (n + 1),
                         np.arange(1, n + 1) / (n + 1), indexing="ij")
    u0 = (np.sin(np.pi * xx) * np.sin(np.pi * yy)
          * (1 + 0.3 * np.cos(4 * np.pi * xx))).reshape(-1) * 0.5
    return op, torch.as_tensor(u0, device=dev)


def event_ms(fn):
    """(result, ms): one call between two CUDA events."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    res = fn()
    e.record()
    e.synchronize()
    return res, s.elapsed_time(e)


def poly_integrator_path(et, dev, card, ref_e, bA):
    """Phase 4's second path: the Leja and Faber actions and the
    exponential integrators through their public entry points (module
    doc), launch counts set to 0 just before and read just after. Each
    call's kernel launches are held to the count its parameters imply.
    Returns (the counts, {cell: callable} for phase 5, the sync-free
    callables, the non-symmetric kernel cases for phase 5, the host
    integrators' results that the sixth path holds its graphs to). A
    device loop run from CUDA graphs counts its kernel executions (captured
    launches times replays)."""
    import math

    import scipy.linalg as sla
    import torch
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.utils import graphs

    gen = np.random.default_rng(SEED + 11)
    f64 = torch.float64
    opL = bench_leja_stencil(et, NL, f64, dev)
    BL = torch.as_tensor(gen.standard_normal((NL, 3)), device=dev)
    opF = et.advection_diffusion_3d_stencil(NF, NF, NF, peclet=10.0,
                                            device=dev)
    bF = torch.as_tensor(gen.standard_normal(NF ** 3), device=dev)
    _, _, _, gF, _ = tfb._resolve_ellipse(opF, None)
    tF = ZF / gF
    opA = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    _, sA = tl._interval_map(opA, None)
    tP = 20.0 / sA                          # phiv_leja at z = 20
    opE, uE = allen_cahn(et, NE, dev)
    opR, uR = allen_cahn(et, NR, dev)
    # the same Allen-Cahn Laplacian in diagonal storage: its matvec is B7
    lapR = et.poisson_2d(NR, NR, device=dev)
    opRB = et.BandedOperator(lapR.diags * (NU_AC * (NR + 1) ** 2),
                             lapR.offsets)
    opG = advection_2d(et, NG, f64, dev)
    bG = torch.as_tensor(gen.standard_normal(NG * NG), device=dev)
    _, sG = tl._interval_map(opG, None)
    tG = 20.0 / sG

    def fR(u):
        return opR.matvec(u) + u - u ** 3

    f_calls = {"plain": 0, "jvp": 0, "plain captured": 0, "jvp captured": 0}

    def fRB(u):
        # every call is one B7 matvec, two under torch.func.jvp (the
        # primal and the tangent); a call made while a Krylov builder's
        # step is captured runs again at each replay of its graph
        traced = torch._C._functorch.is_functorch_wrapped_tensor(u)
        key = "jvp" if traced else "plain"
        f_calls[key] += 1
        if torch.cuda.is_current_stream_capturing():
            f_calls[key + " captured"] += 1
        return opRB.matvec(u) + u - u ** 3

    def jac_RB(u):
        return et.MatrixFreeOperator(
            lambda v: opRB.matvec(v) + (1.0 - 3.0 * u * u) * v, opRB.shape,
            dtype=f64, device=dev)

    # the engine launches each call makes, from its parameters
    _, sL = tl._interval_map(opL, None)
    qL = math.ceil(TL * sL / 40.0)
    _, _, _, gL, _ = tfb._resolve_ellipse(opL, None)
    qLF = math.ceil(TL * gL / 512.0)
    qA = tl._leja_expv_setup(opA, TA, None, 1e-12, None, 40.0)[4]
    qAF = tfb._faber_expv_setup(opA, TA, None, 1e-12, None, 512.0)[4]
    N = lambda u: u - u ** 3
    cells = {
        "leja 1-D n=1e6 phiv_timestep_leja": (
            lambda: et.phiv_timestep_leja([TL], opL, BL, tol=1e-7,
                                          max_z=40.0),
            {"resident_recurrence": 3 * qL}),
        "faber 1-D n=1e6 phiv_timestep_faber": (
            lambda: et.phiv_timestep_faber([TL], opL, BL, tol=1e-7),
            {"resident_recurrence": 3 * qLF}),
        "krylov 1-D n=1e6 phiv_timestep_device m=30 iop=2": (
            lambda: et.phiv_timestep_device([TL], opL, BL, tol=1e-7, m=30,
                                            iop=2), {}),
        f"faber {NF}^3 expv_faber m={MF}": (
            lambda: et.expv_faber(tF, opF, bF, m=MF),
            {"fused_sweep": MF + 1, "sweep_stage": MF + 1}),
        f"arnoldi {NF}^3 expv m={MF}": (
            lambda: et.expv(tF, opF, bF, m=MF), {}),
        f"{NG}^2 2-D advection expv_leja tol=1e-12": (
            lambda: et.expv_leja(tG, opG, bG, tol=1e-12),
            {"resident_grid": 1}),
        f"{NG}^2 2-D advection expv_faber tol=1e-12": (
            lambda: et.expv_faber(tG, opG, bG, tol=1e-12),
            {"resident_grid": 1}),
        "config4 expv_leja tol=1e-12": (
            lambda: et.expv_leja(TA, opA, bA, tol=1e-12),
            {"resident_banded": qA}),
        "config4 expv_faber tol=1e-12": (
            lambda: et.expv_faber(TA, opA, bA, tol=1e-12),
            {"resident_banded": qAF}),
        "config4 phiv_leja k=1 z=20": (
            lambda: et.phiv_leja(tP, opA, bA, 1, tol=1e-12),
            {"resident_banded": 2}),
        f"etdrk4 {NE}^2 m={M_AC}": (
            lambda: et.etdrk4(opE, N, uE, (0.0, E_STEPS * H_AC), H_AC,
                              m=M_AC), {}),
        f"etdrk4_device {NE}^2 m={M_AC}": (
            lambda: et.etdrk4_device(opE, N, uE, (0.0, E_STEPS * H_AC), H_AC,
                                     m=M_AC), {}),
        f"exprb43 {NR}^2 adaptive": (
            lambda: et.exprb43(fR, uR, (0.0, TR), rtol=1e-5, atol=1e-7),
            {}),
        f"exprb43_device {NR}^2 adaptive m={M_R}": (
            lambda: et.exprb43_device(fR, uR, (0.0, TR), rtol=1e-5,
                                      atol=1e-7, m=M_R, return_stats=True),
            {}),
        f"exprb32 {NR}^2 banded jac=None": (
            lambda: et.exprb32(fRB, uR, (0.0, TJ), rtol=1e-5, atol=1e-7),
            None),              # B7: counted from f's calls below
        f"exprb32 {NR}^2 banded analytic jac": (
            lambda: et.exprb32(fRB, uR, (0.0, TJ), rtol=1e-5, atol=1e-7,
                               jac=jac_RB), None),
    }
    _build.reset_launch_counts()
    graphs.reset_counts()
    out, ms = {}, {}
    for name, (fn, want) in cells.items():
        before = dict(_build.launches)
        adj = graphs.launch_adjustment()
        calls_before = dict(f_calls)
        graphs_before = dict(graphs.counts)
        out[name], ms[name] = event_ms(fn)
        # executions: a graph replay runs the launches it captured
        delta = {k: v for k, v in graphs.kernel_executions(
            {k: _build.launches[k] - before[k] for k in before},
            since=adj).items() if v}
        if want is None:
            calls = {k: v - calls_before[k] for k, v in f_calls.items()}
            plain, jvp = calls["plain"], calls["jvp"]
            caps, reps = (graphs.counts[k] - graphs_before.get(k, 0)
                          for k in ("captures", "replays"))
            print(f"main {name}: f called {plain} times plainly and {jvp} "
                  f"times under torch.func.jvp, {calls['jvp captured']} of "
                  f"them into {caps} Krylov builder graphs replayed {reps} "
                  "times", flush=True)
            if name.endswith("jac=None"):
                # each builder graph holds one Jacobian matvec (one jvp):
                # its executions are the graph's replays
                check(jvp > 0 and calls["plain captured"] == 0
                      and calls["jvp captured"] == caps,
                      f"{name}: f calls {calls}, {caps} captures")
                want = {"banded_spmv": plain + 2 * (
                    jvp - calls["jvp captured"] + reps)}
            else:
                # the analytic Jacobian: one more B7 a Krylov matvec
                check(jvp == 0 and delta.get("banded_spmv", 0) > plain,
                      f"{name}: {jvp} jvp calls, {delta}")
                want = delta
        check(delta == want, f"{name} launches {delta}, expected {want}")
        res = out[name]
        stats = f"; {res[1]}" if isinstance(res, tuple) else ""
        print(f"main {name}: kernel launches {delta}; one call "
              f"{ms[name]:.3f} ms (CUDA events){stats} {card}", flush=True)
    counts = graphs.kernel_executions(dict(_build.launches))

    def held(name, got, want, tol, what):
        got, want = got.reshape(-1), want.reshape(-1)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} shape/finite")
        e = rel_norm(got, want)
        check(e <= tol, f"{name} {what} {e:.2e}")
        print(f"check {name}: {what} {e:.2e} (tol {tol:g})", flush=True)

    uLj = out["leja 1-D n=1e6 phiv_timestep_leja"]
    uLf = out["faber 1-D n=1e6 phiv_timestep_faber"]
    uLk = out["krylov 1-D n=1e6 phiv_timestep_device m=30 iop=2"]
    uLk = uLk[0] if isinstance(uLk, tuple) else uLk
    held("leja 1-D n=1e6", uLj, uLk, MTOL_DRIVER, "vs Krylov phiv_timestep")
    held("faber 1-D n=1e6", uLf, uLk, MTOL_DRIVER, "vs Krylov phiv_timestep")
    held("leja 1-D n=1e6", uLj, uLf, MTOL_DRIVER, "vs faber")
    wF = out[f"faber {NF}^3 expv_faber m={MF}"]
    wF2 = et.expv_faber(tF / 2, opF, et.expv_faber(tF / 2, opF, bF, m=MF),
                        m=MF)
    held(f"faber {NF}^3", wF2, wF, MTOL_POLY,
         "semigroup exp(tA)b vs exp(t/2 A)^2 b")
    held(f"faber {NF}^3", wF, out[f"arnoldi {NF}^3 expv m={MF}"], MTOL_POLY,
         f"vs Arnoldi expv(m={MF})")
    del wF2
    held(f"{NG}^2 2-D advection expv_leja",
         out[f"{NG}^2 2-D advection expv_leja tol=1e-12"],
         out[f"{NG}^2 2-D advection expv_faber tol=1e-12"], MTOL_POLY,
         "vs expv_faber")
    for name in ("config4 expv_leja tol=1e-12",
                 "config4 expv_faber tol=1e-12"):
        held(name, out[name].cpu(), torch.as_tensor(ref_e), MTOL_POLY,
             "vs the dense oracle")
    Ad = banded_csr(opA).toarray()
    aug = np.zeros((NA + 1, NA + 1))
    aug[:NA, :NA] = tP * Ad
    aug[:NA, NA] = tP * 0.1 * bA.cpu().numpy()
    F2 = sla.expm(aug)
    refP = F2[:NA, :NA] @ bA.cpu().numpy() + F2[:NA, NA]
    W = out["config4 phiv_leja k=1 z=20"]
    held("config4 phiv_leja k=1 z=20", (W[:, 0] + tP * 0.1 * W[:, 1]).cpu(),
         torch.as_tensor(refP), MTOL_POLY,
         "phi_0 b + t phi_1 (0.1 b) vs the dense oracle")
    uh, sh = out[f"etdrk4 {NE}^2 m={M_AC}"]
    held(f"etdrk4_device {NE}^2", out[f"etdrk4_device {NE}^2 m={M_AC}"], uh,
         MTOL_ETD, "vs etdrk4")
    (uh, sh), (ud, sd) = (out[f"exprb43 {NR}^2 adaptive"],
                          out[f"exprb43_device {NR}^2 adaptive m={M_R}"])
    check((sd.steps, sd.rejected) == (sh.steps, sh.rejected),
          f"exprb43 {NR}^2: steps/rejections host {sh} device {sd}")
    print(f"check exprb43 {NR}^2: {sh.steps} steps, {sh.rejected} "
          f"rejections on the host and device drivers", flush=True)
    held(f"exprb43_device {NR}^2", ud, uh, MTOL_EXPRB, "vs exprb43")
    (uj, sj), (ua, sa) = (out[f"exprb32 {NR}^2 banded jac=None"],
                          out[f"exprb32 {NR}^2 banded analytic jac"])
    check((sj.steps, sj.rejected) == (sa.steps, sa.rejected),
          f"exprb32 banded: steps jvp {sj} analytic {sa}")
    held(f"exprb32 {NR}^2 banded", uj, ua, MTOL_EXPRB,
         "JacobianOperator (B7 under jvp) vs the analytic Jacobian")
    J = et.JacobianOperator(fRB, uR)
    v = torch.as_tensor(gen.standard_normal(NR * NR), device=dev)
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    held("JacobianOperator over B7", J.matvec(v),
         tsp.banded_spmv_ref(opRB.diags, opRB.offsets, v)
         + (1.0 - 3.0 * uR * uR) * v, 1e-12, "J v vs the twin's A v + "
         "(1 - 3u^2) v")
    from exponentialutilities_jl_torch.models import integrators as ti

    sync_free = {
        "etdrk4_device step": lambda: ti._etdrk4_scan(
            opE, uE, H_AC, N=N, nsteps=1, m=M_AC, iop=2,
            expm_method="taylor"),
        "exprb43_device fixed step": lambda: ti._exprb43_scan(
            uR, 0.01, f=fR, nsteps=1, m=M_R, iop=2, expm_method="taylor"),
        "JacobianOperator matvec over B7": lambda: J.matvec(v),
    }
    timed = {k: fn for k, (fn, _) in cells.items()}
    host_refs = {"etdrk4": out[f"etdrk4 {NE}^2 m={M_AC}"][0],
                 "exprb43": out[f"exprb43 {NR}^2 adaptive"][0]}
    return (counts, timed, sync_free, ms, (opL, BL[:, 0], opF, bF, opA),
            host_refs)


def phi_oracle(A, k):
    """[phi_0(A) .. phi_k(A)] from one scipy expm of the block matrix
    [[A, E], [0, K]] (tests/test_phi.py's oracle)."""
    import scipy.linalg as sla

    n = A.shape[0]
    E = np.zeros((n, k * n))
    E[:, :n] = np.eye(n)
    J = (np.kron(np.diag(np.ones(k - 1), 1), np.eye(n)) if k > 1
         else np.zeros((n, n)))
    P = sla.expm(np.block([[A, E], [np.zeros((k * n, n)), J]]))
    return [sla.expm(A)] + [P[:n, j * n:(j + 1) * n] for j in range(1, k + 1)]


def stack_flops(et, X, k=None):
    """The operations one call on the stack X does, counted from the degree
    and squaring count it chooses: expm (k None) = Higham 2005 (3 shared
    products, the branch's, one LU solve with n right-hand sides, s
    squarings); phi (k) = the Paterson-Stockmeyer Taylor stage, k recovery
    products and s double-argument stages of k+1 products each."""
    import math

    from exponentialutilities_jl_torch.ops import expm as tex
    from exponentialutilities_jl_torch.ops import phi_dense as tpd

    B, n = X.shape[0], X.shape[-1]
    nA = float(tex._onenorm(X))
    prod = 2.0 * n ** 3
    if k is None:
        thetas, _ = tex._pade_tables(X.dtype)
        s = tex._scaling(nA, thetas[-1], 32)
        idx = sum(nA > t for t in thetas[:-1])
        deg = (3, 5, 7, 9, 13)[idx]
        branch = {3: 1, 5: 1, 7: 1, 9: 2, 13: 3}[deg]
        return B * ((3 + branch + s) * prod + 8.0 / 3.0 * n ** 3), \
            f"degree {deg}, s = {s}"
    theta, order = tpd._taylor_order(X.dtype)
    s = tex._scaling(nA, theta, 48)
    tau = max(2, math.isqrt(order) + 1)
    nblocks = (order + 1 + tau - 1) // tau
    ps = (tau - 1) + (nblocks - 1)
    return B * ((ps + k + s * (k + 1)) * prod), \
        f"Taylor order {order}, s = {s}"


def dense_grad_path(et, dev, card, A1np, op1, opP, opS):
    """Phase 4's third path: the dense layer (every expm method, phi,
    phi_pade, funm, the batched stacks, expm_dd), expv_batched on configs
    #2 and #3, and the gradients (B7's reverse rule on config #4's
    operator, B9's Hermitian x-gradient, the grad rule on config #2's
    stencil, expm_higham2005(differentiable=True) under torch.func.grad),
    launch counts set to 0 just before and read just after, each call's
    launches held to its expected count. Returns (the counts, {cell:
    callable} for phase 5, the stacks)."""
    import linecache
    import warnings

    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from mpmath import mp, workprec
    from exponentialutilities_jl_torch.ops import phi_almohy as tpa
    from exponentialutilities_jl_torch.ops import sparse as tsparse
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import dispatch as td
    from exponentialutilities_jl_torch.ops.kernels import sell as ts
    from exponentialutilities_jl_torch.utils import graphs

    f32, f64 = torch.float32, torch.float64
    dname = {f32: "float32", f64: "float64"}
    gen = np.random.default_rng(SEED + 21)

    def held(name, got, want, tol, what, jax_err=None):
        got = torch.as_tensor(got).detach().double().cpu().reshape(-1)
        want = torch.as_tensor(want).detach().double().cpu().reshape(-1)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} shape/finite")
        e = rel_norm(got, want)
        check(e <= tol, f"{name} {what} {e:.2e}")
        beside = "" if jax_err is None else f"; JAX on the CPU {jax_err:.1e}"
        print(f"check {name}: {what} {e:.2e} (tol {tol:g}{beside})",
              flush=True)

    # ---- inputs and host oracles (before the counts are reset)
    t0 = time.perf_counter()
    A1c = torch.as_tensor(A1np, device=dev)
    E1 = sla.expm(A1np)
    P1 = phi_oracle(A1np, 3)
    A3np = np.random.default_rng(3).standard_normal((256, 256)) / 8
    A3 = torch.as_tensor(A3np, device=dev)
    P3 = phi_oracle(A3np, 3)
    stacks = {}
    for b_, n_ in STACKS:
        for dt, npdt in ((f32, np.float32), (f64, np.float64)):
            X = np.random.default_rng(5).standard_normal(
                (b_, n_, n_)).astype(npdt)
            X *= (20.0 / np.linalg.norm(X, 1, axis=(1, 2)))[:, None, None]
            stacks[(b_, n_, dname[dt])] = (torch.as_tensor(X, device=dev), X)
    Add = np.random.default_rng(21).standard_normal((ND, ND)) / 4
    tm = time.perf_counter()
    Mmp = et.expm_mp(Add, prec_bits=300)
    mp_s = time.perf_counter() - tm
    B2np = np.random.default_rng(22).standard_normal((NBATCH2, N1))
    B2 = torch.as_tensor(B2np, device=dev)
    A1s = sp.diags([np.ones(N1 - 1), -2 * np.ones(N1), np.ones(N1 - 1)],
                   [-1, 0, 1], format="csr")
    ref2 = [spla.expm_multiply(T1 * A1s, B2np[i]) for i in range(NBATCH2)]
    B3 = torch.as_tensor(gen.standard_normal((NBATCH3, NP * NP)), device=dev)
    opA4 = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    bg4 = torch.as_tensor(gen.standard_normal(NA), device=dev)
    xS = torch.as_tensor(gen.standard_normal(opS.shape[0]), device=dev)
    gS = torch.as_tensor(gen.standard_normal(opS.shape[0]), device=dev)
    # a complex diagonal (non-Hermitian: Arnoldi), n = NDC
    dCnp = -gen.uniform(0, 4, NDC) + 1j * gen.uniform(-3, 3, NDC)
    bCnp = gen.standard_normal(NDC)
    opDC = et.DiagonalOperator(torch.as_tensor(dCnp, device=dev))
    bDC = torch.as_tensor(bCnp, device=dev)
    refDC = np.exp(0.5 * dCnp) * bCnp
    print(f"dense path inputs and host oracles: "
          f"{time.perf_counter() - t0:.1f} s (expm_mp {ND} x {ND} at 300 "
          f"bits: {mp_s:.1f} s)", flush=True)

    def grads_config4():
        D = opA4.diags.clone().requires_grad_()
        b = bg4.clone().requires_grad_()
        op = et.BandedOperator(D, opA4.offsets)
        w = et.expv(TG4, op, b, m=40, hermitian=False)
        return torch.autograd.grad((w ** 2).sum(), (D, b))

    def grad_sell():
        x = xS.clone().requires_grad_()
        return torch.autograd.grad(opS.matvec(x), x, gS)[0]

    def grad_gated():
        b = b1dev.clone().requires_grad_()
        w = et.expv_chebyshev(T1, op1, b, tol=1e-12)
        return torch.autograd.grad((w ** 2).sum(), b)[0]

    b1dev = torch.as_tensor(np.random.default_rng(23).standard_normal(N1),
                            device=dev)
    cells = {f"config1 expm {m}": (lambda m=m: et.expm(
        A1c, method=m, **({"parlett": "device"} if m == "schur" else {})))
        for m in ("higham2005", "generic", "diagonalization", "native",
                  "taylor", "schur", "gebal")}
    cells.update({
        "config1 expm_higham2005 balance": lambda: et.expm_higham2005(
            A1c, balance=True),
        "config1 phi pade": lambda: et.phi(A1c, 3),
        "config1 phi_taylor": lambda: et.phi_taylor(A1c, 3),
        "config1 funm exp": lambda: et.funm(A1c, "exp", parlett="device"),
        "phi_pade 256": lambda: et.phi_pade(A3, 3),
        **{f"stack {b_}x{n_} {dn} expm": (lambda X=X: et.expm(X))
           for (b_, n_, dn), (X, _) in stacks.items()},
        **{f"stack {b_}x{n_} {dn} phi": (lambda X=X: et.phi(X, KS))
           for (b_, n_, dn), (X, _) in stacks.items()},
        f"expm_dd {ND}": lambda: et.expm_dd(torch.as_tensor(Add, device=dev)),
        "expv_batched config2": lambda: et.expv_batched(
            T1, op1, B2, m=40, two_pass=True),
        "expv_batched config3": lambda: et.expv_batched(TP, opP, B3, m=30),
        "grad config4 expv m=40": grads_config4,
        "grad sell x": grad_sell,
        "grad gated expv_chebyshev": grad_gated,
        f"complex diagonal n={NDC} expv m=30": lambda: et.expv(
            0.5, opDC, bDC, m=30),
        # config #1's eigenvalues cluster: the blocks take the torch
        # matfunc, the 1 x 1 blocks torch.exp
        "config1 funm torch.exp": lambda: et.funm(
            A1c, torch.exp, matfunc=torch.linalg.matrix_exp),
    })
    from exponentialutilities_jl_torch.ops.kernels import resident as tr

    # one batched build a call: K3, one K2 and K4's groups (config #2);
    # 30 fused Lanczos steps (K1's Lanczos form and K5) for the 4 rows and
    # one K2 (config #3)
    k4 = tr.recurrence_batch_plan(op1, torch.float64, op1.device, NBATCH2)
    expect = {
        "expv_batched config2": {
            "resident_lanczos_batched": 1, "tridiag_exp_batched": 1,
            "resident_recurrence_batched": k4.launches_per_call},
        "expv_batched config3": {"banded_spmm_alpha": 30,
                                 "lanczos_update": 30,
                                 "tridiag_exp_batched": 1},
        "grad config4 expv m=40": {"banded_spmv": 40 + 40},
        "grad sell x": {"sell_spmv": 2},
    }
    _build.reset_launch_counts()
    graphs.reset_counts()
    td.grad_gated["calls"] = 0
    out, ms = {}, {}
    for name, fn in cells.items():
        before = dict(_build.launches)
        adj = graphs.launch_adjustment()
        out[name], ms[name] = event_ms(fn)
        # executions: the Krylov builders replay their CUDA graphs
        delta = {k: v for k, v in graphs.kernel_executions(
            {k: _build.launches[k] - before[k] for k in before},
            since=adj).items() if v}
        want = expect.get(name, {})
        check(delta == want, f"{name}: launches {delta}, expected {want}")
        print(f"main {name}: {ms[name]:.1f} ms, launches {delta or 'none'}",
              flush=True)
    counts = graphs.kernel_executions(dict(_build.launches))
    gated = td.grad_gated["calls"]
    check(gated == 1, f"grad rule: {gated} gated calls, expected 1")
    print(f"main grad rule: {gated} call sent to the plain path "
          "(expv_chebyshev with a requires-grad b on config #2's stencil)",
          flush=True)

    # ---- checks
    for m in ("higham2005", "generic", "diagonalization", "native", "taylor",
              "schur", "gebal"):
        held(f"config1 expm {m}", out[f"config1 expm {m}"], E1,
             MTOL_DENSE["float64"], "vs scipy expm",
             DENSE_JAX[f"config1 expm {m}"])
    held("config1 expm_higham2005 balance",
         out["config1 expm_higham2005 balance"], E1, MTOL_DENSE["float64"],
         "vs scipy expm", DENSE_JAX["config1 expm_higham2005 balance"])
    for name in ("config1 phi pade", "config1 phi_taylor"):
        F = out[name]
        check(tuple(F.shape) == (4, 100, 100), f"{name} shape")
        e = max(rel_norm(F[j].cpu(), torch.as_tensor(P1[j]))
                for j in range(4))
        check(e <= MTOL_DENSE["float64"], f"{name} {e:.2e}")
        print(f"check {name}: phi_0..phi_3 vs the block oracle {e:.2e} (tol "
              f"{MTOL_DENSE['float64']:g}; JAX on the CPU "
              f"{DENSE_JAX[name]:.1e})", flush=True)
    held("config1 funm exp", out["config1 funm exp"], E1,
         MTOL_DENSE["float64"], "parlett='device' vs scipy expm",
         DENSE_JAX["config1 funm exp"])
    held("config1 funm torch.exp", out["config1 funm torch.exp"], E1,
         MTOL_DENSE["float64"], "torch callables vs scipy expm",
         DENSE_JAX["config1 funm jnp.exp"])
    w = out[f"complex diagonal n={NDC} expv m=30"]
    e = rel_norm(w.cpu(), torch.as_tensor(refDC))
    check(w.dtype == torch.complex128 and bool(torch.isfinite(w).all())
          and not opDC.is_hermitian and e <= MTOL_CDIAG,
          f"complex diagonal expv {e:.2e}")
    print(f"check complex diagonal n={NDC} expv m=30: DiagonalOperator of a "
          f"complex d is not Hermitian (Arnoldi); vs exp(0.5 d) b {e:.2e} "
          f"(tol {MTOL_CDIAG:g}; JAX on the CPU: {JAX_CDIAG})", flush=True)
    F3 = out["phi_pade 256"]
    e = max(rel_norm(F3[j].cpu(), torch.as_tensor(P3[j])) for j in range(4))
    check(e <= MTOL_DENSE["float64"], f"phi_pade 256 {e:.2e}")
    i_dev, s_dev = tpa._select_parameters(A3, 3, 64)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            et.phi_pade(A3, 3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the syncs of the call, by the source line that made them: the one
    # read of (i, s), and any the LU library makes inside solve_ex
    sites = [linecache.getline(w.filename, w.lineno).strip()
             for w in caught
             if "called a synchronizing" in str(w.message)]
    reads = sum(".tolist()" in line for line in sites)
    lu = sum("solve_ex" in line for line in sites)
    got = (int(i_dev), int(s_dev))
    check(got == PADE_JAX, f"phi_pade 256 (i, s) {got}, JAX {PADE_JAX}")
    check(reads == 1 and reads + lu == len(sites),
          f"phi_pade 256: syncs at {sites}, expected one read of (i, s)")
    print(f"check phi_pade 256: phi_0..phi_3 vs the host block oracle "
          f"{e:.2e} (tol {MTOL_DENSE['float64']:g}; JAX on the CPU "
          f"{DENSE_JAX['phi_pade 256']:.1e}); (i, s) = {got} as JAX's; "
          f"{reads} host read of them, {lu} sync inside the LU solve (sync "
          "debug mode)", flush=True)
    for (b_, n_, dn), (X, Xnp) in stacks.items():
        tol = MTOL_DENSE[dn]
        E = out[f"stack {b_}x{n_} {dn} expm"]
        F = out[f"stack {b_}x{n_} {dn} phi"]
        check(E.shape == X.shape and F.shape == (b_, KS + 1, n_, n_),
              f"stack {b_}x{n_} {dn} shapes")
        ep = max(rel_norm(E[i], et.expm_higham2005(X[i]))
                 for i in range(min(4, b_)))
        fp = max(rel_norm(F[i], et.phi_taylor(X[i], KS))
                 for i in range(min(4, b_)))
        es = max(rel_norm(E[i].cpu(), torch.as_tensor(
            sla.expm(Xnp[i].astype(np.float64)))) for i in range(2))
        fs = max(rel_norm(F[i, j].cpu(), torch.as_tensor(o)) for i in range(2)
                 for j, o in enumerate(phi_oracle(Xnp[i].astype(np.float64),
                                                  KS)))
        for what, e_ in (("expm vs per-matrix (4)", ep),
                         ("phi vs per-matrix (4)", fp),
                         ("expm vs scipy (2)", es),
                         ("phi vs the block oracle (2)", fs)):
            check(e_ <= tol, f"stack {b_}x{n_} {dn} {what} {e_:.2e}")
        print(f"check stack {b_}x{n_} {dn}: expm vs per-matrix {ep:.2e}, "
              f"phi vs per-matrix {fp:.2e}, expm vs scipy {es:.2e} (JAX on "
              f"the CPU {DENSE_JAX[f'stack {b_}x{n_} {dn} expm']:.1e}), phi "
              f"vs the block oracle {fs:.2e} (JAX on the CPU "
              f"{DENSE_JAX[f'stack {b_}x{n_} {dn} phi']:.1e}) (tol {tol:g})",
              flush=True)
    X = out[f"expm_dd {ND}"]
    with workprec(330):
        err = max(abs(mp.mpf(float(X.hi[i, j])) + mp.mpf(float(X.lo[i, j]))
                      - Mmp[i, j]) for i in range(ND) for j in range(ND))
        sc = max(abs(Mmp[i, j]) for i in range(ND) for j in range(ND))
        e = float(err / sc)
    check(e <= MTOL_DD, f"expm_dd {ND} vs expm_mp {e:.2e}")
    Xc = et.expm_dd(torch.as_tensor(Add))
    same = torch.equal(X.hi.cpu(), Xc.hi) and torch.equal(X.lo.cpu(), Xc.lo)
    check(same, f"expm_dd {ND}: the card's bits differ from the CPU's")
    print(f"check expm_dd {ND}: vs expm_mp (300 bits) {e:.2e} (tol "
          f"{MTOL_DD:g}; JAX on the CPU {DENSE_JAX['expm_dd 32']:.1e}); "
          "the card's hi and lo equal the CPU's bit for bit", flush=True)
    W2 = out["expv_batched config2"]
    check(W2.shape == (NBATCH2, N1), "expv_batched config2 shape")
    e = max(rel_norm(W2[i].cpu(), torch.as_tensor(ref2[i]))
            for i in range(NBATCH2))
    check(e <= MTOL_DENSE["float64"], f"expv_batched config2 {e:.2e}")
    print(f"check expv_batched config2: {NBATCH2} columns vs scipy "
          f"expm_multiply, worst {e:.2e} (tol {MTOL_DENSE['float64']:g}; "
          f"JAX on the CPU {DENSE_JAX['expv_batched config2']:.1e})",
          flush=True)
    W3 = out["expv_batched config3"]
    e = max(rel_max(W3[i], et.expv(TP, opP, B3[i], m=30))
            for i in range(NBATCH3))
    check(e <= MTOL_ROWS, f"expv_batched config3: a column {e:.2e} from its "
          "expv")
    print(f"check expv_batched config3: each of {NBATCH3} columns within "
          f"{e:.2e} of its scalar expv (tol {MTOL_ROWS:g}: the batched "
          "build's dots and norms sum in another order)", flush=True)
    gD, gb = out["grad config4 expv m=40"]
    saved = tsparse.kernel_device_ok
    tsparse.kernel_device_ok = lambda dt, device: False
    try:
        pD, pb = grads_config4()          # the plain twin on the card
    finally:
        tsparse.kernel_device_ok = saved
    held("grad config4 diags", gD, pD, MTOL_GRAD, "B7 rule vs the plain "
         "twin's autograd")
    held("grad config4 b", gb, pb, MTOL_GRAD, "B7 rule vs the plain twin's "
         "autograd")
    held("grad sell x", out["grad sell x"], ts.sell_spmv_ref(opS.data, gS),
         MTOL_GRAD, "B9 x-gradient vs the twin's A g (A = A^T)")
    opc = et.laplacian_nd_stencil(N1, device="cpu")
    bc = b1dev.cpu().requires_grad_()
    (gc,) = torch.autograd.grad((et.expv_chebyshev(T1, opc, bc, tol=1e-12)
                                 ** 2).sum(), bc)
    held("grad gated expv_chebyshev", out["grad gated expv_chebyshev"], gc,
         MTOL_GRAD_CPU, "vs the same call's gradient on the CPU")
    # the differentiable form makes no host read under torch.func.grad
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = torch.func.grad(lambda A: (et.expm_higham2005(
            A, differentiable=True) ** 2).sum())(A1c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gr = A1c.clone().requires_grad_()
    (ge,) = torch.autograd.grad((et.expm_higham2005(gr) ** 2).sum(), gr)
    held("expm_higham2005 differentiable under torch.func.grad", g, ge,
         MTOL_GRAD, "vs autograd of the default form (sync debug mode "
         "'error')")
    return counts, cells, ms, stacks


# ---- the fourth path: the distributed layer on this one card ----
# parallel/ on torch.distributed: P = 2 and 4 ranks sharing cuda:0 over
# gloo (each a subprocess of this script that loads the kernels the parent
# built), then one NCCL rank, then two NCCL ranks on one card (refused).
# These are no scaling numbers: the ranks time-share one card, and gloo
# stages every halo and psum through the host.
SHARD_WORLDS = (2, 4)
SHARD_DEVICE = "cuda:0"  # every rank's tensors: the one card
SHARD_TIMEOUT = 420      # seconds a rank may take before the run fails
SHARD_REPS = 5           # CUDA-event median of each sharded call (rank 0)
GSPMD_REPS = 3           # ... of each GSPMD gloo cell (its depth cut)
# sharded vs the single-device port on the same card: the summation order
# of the reductions only (CPU parity: tests/test_torch_parallel.py and
# test_torch_stencil_fused_sharded.py hold them to 1e-12 as well)
MTOL_SHARD = 1e-12


class SlabAxis:
    """A mesh axis of ``size`` ranks with no process group: all that a
    rank's ``FusedShardPlan`` reads to lay out its extended slab (phase 3
    builds the fourth path's slabs with it; no collective runs)."""

    def __init__(self, size, device):
        self.size, self.device = size, device

    def axis_size(self):
        return self.size


def slab_plans(et, dt, dev, opV):
    """Every extended slab that the fourth path sweeps, as (label, plan,
    the slab's operator), from the port's own plan classes: for P in
    SHARD_WORLDS, config #5's 7-point Laplacian and the variable operator
    on N3/P + 2 planes, the Faber advection stencil on NF/P + 2, and the
    2-D NG^2 Laplacian as the (NG/P + 2, 1, NG) grid with offsets (dy, 0,
    dx). The variable slab takes the fields of the global operator's first
    N3/P + 2 planes (rank 0's rows and its upper halo)."""
    from exponentialutilities_jl_torch.parallel import stencil_fused as sf

    lap3 = et.laplacian_nd_stencil(N3, N3, N3, dtype=dt, device=dev)
    adv = et.advection_diffusion_3d_stencil(NF, NF, NF, peclet=10.0,
                                            dtype=dt, device=dev)
    lap2 = et.laplacian_nd_stencil(NG, NG, dtype=dt, device=dev)
    out = []
    for P in SHARD_WORLDS:
        ax = SlabAxis(P, dev)
        for label, plan in ((f"{N3}^3 7-point", sf.FusedShardPlan(lap3, ax)),
                            (f"{NF}^3 advection (Faber)",
                             sf.FusedShardPlan(adv, ax)),
                            (f"{NG}^2 5-point as 3-D",
                             sf.FusedShardPlan2D(lap2, ax))):
            out.append((f"P={P} {label}", plan, plan.ext))
        pv = sf.FusedShardPlanVar(opV, ax)
        F = opV.coeff_fields[:, :pv.sze * pv.plane]
        out.append((f"P={P} {N3}^3 div(a grad u)", pv,
                    et.VariableStencilOperator(pv.ext_shape, pv.ext_offsets,
                                               F, opV.is_hermitian)))
    return out


def slab_checks(et, dev, dt, tol, opV, gen):
    """Phase 3: B3 and B3-var on every slab of ``slab_plans`` with its
    interior plane range [h0, h0 + sz), accumulating and plain, against the
    plain twin on the same inputs: Y, Zn, W and the moments within ``tol``,
    the plain and accumulating moments bit for bit equal; Y, Zn and W bit
    for bit those of the call without a range, and the explicit whole
    range bit for bit the default. One line per slab."""
    import torch

    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf

    dn = str(dt).split(".")[-1]
    for label, plan, ext in slab_plans(et, dt, dev, opV):
        kname = "B3-var" if isinstance(ext, et.VariableStencilOperator) \
            else "B3"
        n, zr = ext.shape[0], plan.z_range
        Z, Vc, Vp, W = (torch.as_tensor(gen.standard_normal(n), dtype=dt,
                                        device=dev) for _ in range(4))
        co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
        co3 = co[:3].contiguous()
        W1, W2, W3 = W.clone(), W.clone(), W.clone()
        Y, Zn, ypy, yzy, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, ext,
                                                   w_accum=W1, z_range=zr)
        Yp, Znp, ypp, yzp = tf.fused_lanczos_step(Z, Vc, Vp, co3, ext,
                                                  z_range=zr)
        Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, plan.ext_shape,
                                           plan.ext_offsets,
                                           tf._cvals(ext, dt), W2,
                                           z_range=zr)
        mom, momp = torch.stack([ypy, yzy]), torch.stack([ypp, yzp])
        errs = [rel_max(a, b) for a, b in ((Y, Yr), (Zn, Znr), (W1, W2),
                                           (mom, momr), (Yp, Yr), (Znp, Znr),
                                           (momp, momr))]
        check(max(errs) <= tol, f"{kname} {dn} slab {label} with planes "
              f"{zr}: {errs}")
        check(torch.equal(mom, momp), f"{kname} {dn} slab {label}: plain "
              "and accumulating moments differ")
        Yd, Znd, _, _, _ = tf.fused_lanczos_step(Z, Vc, Vp, co, ext,
                                                 w_accum=W3)
        check(torch.equal(Y, Yd) and torch.equal(Zn, Znd)
              and torch.equal(W1, W3), f"{kname} {dn} slab {label}: the "
              "plane range changed Y, Zn or W")
        full = tf.fused_lanczos_step(Z, Vc, Vp, co3, ext,
                                     z_range=(0, plan.sze))
        dflt = tf.fused_lanczos_step(Z, Vc, Vp, co3, ext)
        check(torch.equal(torch.stack(full[2:]), torch.stack(dflt[2:])),
              f"{kname} {dn} slab {label}: the whole range differs from "
              "the default")
        print(f"kernel {kname} {dn} slab {label} {plan.ext_shape}, moments "
              f"over planes {zr}: max rel err {max(errs):.2e} vs the twin "
              f"(tol {tol:g}; Y, Zn, W, moments, accumulating and plain); "
              "plain and accumulating moments bitwise equal; Y, Zn, W bit "
              "for bit the call without a range; the whole range bit for "
              "bit the default", flush=True)
        del Z, Vc, Vp, W, W1, W2, W3, Y, Zn, Yp, Znp, Yr, Znr, Yd, Znd


def shard_inputs(et, dev, var_device):
    """The fourth path's operators and vectors, the same in the parent and
    in every rank: from SEED + 14 in one fixed order. The variable
    operator's fields live on ``var_device`` (a rank keeps them on the
    host; its plan moves its rows to the card)."""
    import torch

    gen = np.random.default_rng(SEED + 14)

    def v(n):
        return torch.as_tensor(gen.standard_normal(n), device=dev)

    aV = np.random.default_rng(SEED).uniform(0.5, 2.0, (N3, N3, N3))
    ins = {"op3": et.laplacian_nd_stencil(N3, N3, N3, device=dev),
           "opV": et.variable_diffusion_nd_stencil(aV, device=var_device),
           "opF": et.advection_diffusion_3d_stencil(NF, NF, NF, peclet=10.0,
                                                    device=dev),
           "opG": et.laplacian_nd_stencil(NG, NG, device=dev),
           "op1": et.laplacian_nd_stencil(N1, device=dev),
           "opP": et.poisson_2d(NP, NP, device=dev),
           "opL": bench_leja_stencil(et, NL, torch.float64, dev)}
    for name, n in (("b3", N3 ** 3), ("bV", N3 ** 3), ("bF", NF ** 3),
                    ("bG", NG * NG), ("b1", N1), ("bP", NP * NP),
                    ("bL", NL)):
        ins[name] = v(n)
    return ins


def shard_cells(et, ins, boundsV):
    """{cell: (single-device call, sharded call(mesh, b_local) -> this
    rank's rows (or (rows, err)), input name, expected launches per rank,
    expected collectives per rank)}. Counts from the parameters: a
    two-pass m = 20 is 2(m + 1) sweeps, 4(m + 1) stages, 2(m + 2) psums and
    halo exchanges; a recurrence of M rows M + 1 sweeps and M + 2
    exchanges (+1 for B3-var's fields); the plain Lanczos 1 + 2m psums and
    m exchanges; Leja q m exchanges, no psum."""
    from exponentialutilities_jl_torch import parallel as par
    from exponentialutilities_jl_torch.models import chebyshev as tc
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl

    op3, opV, opF, opG = ins["op3"], ins["opV"], ins["opF"], ins["opG"]
    op1, opP, opL = ins["op1"], ins["opP"], ins["opL"]
    M3 = len(tc._full_exp_coeffs(T3, *op3.spectral_bounds_hint(), 1e-12,
                                 None)[0])
    MV = len(tc._full_exp_coeffs(T3, *boundsV, 1e-12, None)[0])
    _, _, _, gF, _ = tfb._resolve_ellipse(opF, None)
    tF = ZF / gF
    qF, mF = (lambda s: (s[4], s[5]))(tfb._faber_expv_setup(
        opF, tF, None, 1e-7, MF, 512.0))
    dL, _, _, _, qL = tl._leja_expv_setup(opL, TL, None, 1e-7, None, 40.0)
    # R1: the reduced exponential between the passes, on every rank
    tp = {"fused_sweep": 42, "sweep_stage": 84, "tridiag_exp": 1}
    cp = {"psum": 44, "ppermute": 44}

    def step_call(mesh, b):
        step, params = par.make_expv_step(opP, mesh, m=30)
        return step(TP, params, b)

    return {
        f"{N3}^3 two-pass m=20": (
            lambda: et.expv(T3, op3, ins["b3"], m=20, two_pass=True),
            lambda mesh, b: par.expv_sharded(T3, op3, b, mesh, m=20,
                                             two_pass=True),
            "b3", tp, cp),
        f"{N3}^3 cheb": (
            lambda: et.expv_chebyshev(T3, op3, ins["b3"], tol=1e-12),
            lambda mesh, b: par.expv_chebyshev_sharded(T3, op3, b, mesh,
                                                       tol=1e-12),
            "b3", {"fused_sweep": M3 + 1}, {"ppermute": M3 + 2}),
        f"{N3}^3 variable cheb": (
            lambda: et.expv_chebyshev(T3, opV, ins["bV"], tol=1e-12),
            lambda mesh, b: par.expv_chebyshev_sharded(
                T3, opV, b, mesh, bounds=boundsV, tol=1e-12),
            "bV", {"fused_sweep_var": MV + 1}, {"ppermute": MV + 3}),
        f"{NF}^3 faber m={MF}": (
            lambda: et.expv_faber(tF, opF, ins["bF"], m=MF),
            lambda mesh, b: par.expv_faber_sharded(tF, opF, b, mesh, m=MF),
            "bF", {"fused_sweep": qF * (mF + 1)},
            {"ppermute": qF * (mF + 2), "psum": 1}),
        f"{NG}^2 two-pass m=20": (
            lambda: et.expv(TG, opG, ins["bG"], m=20, two_pass=True),
            lambda mesh, b: par.expv_sharded(TG, opG, b, mesh, m=20,
                                             two_pass=True),
            "bG", tp, cp),
        "config2 expv m=40": (
            lambda: et.expv(T1, op1, ins["b1"], m=40),
            lambda mesh, b: par.expv_sharded(T1, op1, b, mesh, m=40),
            "b1", {"tridiag_exp": 1}, {"psum": 81, "ppermute": 40}),
        f"config3 phiv k={K} m=30": (
            lambda: et.phiv(TP, opP, ins["bP"], K, m=30, errest=True),
            lambda mesh, b: par.phiv_sharded(TP, opP, b, K, mesh, m=30),
            "bP", {}, {"psum": 61, "ppermute": 30}),
        "config3 make_expv_step m=30": (
            lambda: et.expv(TP, opP, ins["bP"], m=30), step_call,
            "bP", {"tridiag_exp": 1}, {"psum": 61, "ppermute": 30}),
        f"leja n={NL}": (
            lambda: et.expv_leja(TL, opL, ins["bL"], fused=False),
            lambda mesh, b: par.expv_leja_sharded(TL, opL, b, mesh),
            "bL", {}, {"ppermute": qL * len(dL)}),
    }


def shard_rank_main(args) -> int:
    """One rank of the fourth path (``--shard-rank``): join the group
    (file store in ``--shard-dir``), run every cell on this rank's rows
    and write ``rank<R>.json``: errors against the parent's references,
    launches and collectives per cell, the replicated scalars in hex,
    rank 0's CUDA-event medians."""
    import os

    import torch
    import torch.distributed as dist

    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch import parallel as par
    from exponentialutilities_jl_torch.models import expv as tx
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
    from exponentialutilities_jl_torch.parallel import stencil_fused as sf

    d, r, P, mode = args.shard_dir, args.shard_rank, args.shard_world, \
        args.shard_mode
    dev = torch.device(SHARD_DEVICE)
    torch.cuda.set_device(dev)
    out = {"rank": r}
    par.initialize_distributed(f"file://{d}/store-{mode}-{P}", P, r, 0,
                               backend="gloo" if mode == "gloo" else "nccl")
    if mode == "nccl-dup":
        # two NCCL ranks on one card: the mesh refuses, and so does NCCL
        try:
            par.make_mesh(device=dev)
            out["mesh"] = None
        except ValueError as e:
            out["mesh"] = str(e)
        try:
            t = torch.ones(1, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out["nccl"] = None
        except Exception as e:
            out["nccl"] = f"{type(e).__name__}: {e}"
        with open(os.path.join(d, f"dup_rank{r}.json"), "w") as f:
            json.dump(out, f)
        os._exit(0)
    mesh = par.make_mesh(device=dev)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    ins = shard_inputs(et, dev, "cpu")
    cells = shard_cells(et, ins, tuple(meta["boundsV"]))
    if mode == "nccl":
        cells = {k: v for k, v in cells.items() if k.endswith("two-pass m=20")
                 and k.startswith(f"{N3}^3")}
    res = out["cells"] = {}
    for i, (name, (_, sharded, bname, _, _)) in enumerate(cells.items()):
        b = ins[bname]
        nl = b.shape[0] // P
        bl = b[r * nl:(r + 1) * nl].contiguous()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        mesh.reset_census()
        w = sharded(mesh, bl)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.launches.items() if v}
        census = {k: v for k, v in mesh.census["shard"].items() if v}
        err = None
        if isinstance(w, tuple):
            w, err = w
            err = float(err).hex()
        ref = torch.load(os.path.join(d, f"ref{i}.pt"), mmap=True)
        ref = ref[r * nl:(r + 1) * nl].to(dev)
        c = {"launches": launches, "census": census, "err": err,
             "finite": bool(torch.isfinite(w).all()),
             "diff": float((w - ref).abs().max()),
             "scale": float(ref.abs().max())}
        if os.path.exists(os.path.join(d, f"oracle{i}.pt")):
            orc = torch.load(os.path.join(d, f"oracle{i}.pt"), mmap=True)
            orc = orc[r * nl:(r + 1) * nl].to(dev)
            col = w[:, 0] if w.ndim == 2 else w
            c["oracle_sq"] = float(((col - orc) ** 2).sum())
            c["oracle_norm_sq"] = float((orc ** 2).sum())
        res[name] = c
    # the replicated scalars and the replay (216^3 two-pass), and the
    # sync-free check on the NCCL rank
    op3 = ins["op3"]
    nl = op3.shape[0] // P
    b3l = ins["b3"][r * nl:(r + 1) * nl].contiguous()
    plan = sf.fused_shard_plan(op3, mesh, hermitian=True)
    sync = mode == "nccl"
    torch.cuda.synchronize()
    if sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        a, bt, b0, mu, _ = sf.lanczos_coeffs_fused_sharded(plan, b3l, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    co = tx._lanczos_reduced_coeffs(a, bt, b0, T3)     # R1, no read
    torch.cuda.synchronize()
    if sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        a2, bt2 = sf._lanczos_sharded(plan, b3l, 0, 1e-7, co)[:2]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["scalars"] = [float(x).hex() for x in torch.cat([a, bt, b0[None]])]
    out["replay_equal"] = bool(torch.equal(a, a2) and torch.equal(bt, bt2))
    out["sync_free"] = sync
    # rank 0's CUDA-event medians (every rank runs every call: the
    # collectives keep them in step), and the share of a sharded pass 1
    # that is not the sweeps: the same sweeps and stages on the rank's
    # extended slab with no collective, all ranks at once
    times = out["ms"] = {}

    def med(fn, reps):
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

    for name, (_, sharded, bname, _, _) in cells.items():
        b = ins[bname]
        nl = b.shape[0] // P
        bl = b[r * nl:(r + 1) * nl].contiguous()
        reps = 3 if name.startswith("leja") else SHARD_REPS
        times[name] = med(lambda: sharded(mesh, bl), reps)
    v_ext = plan.to_ext(b3l / 1.0)
    times["pass1 sharded"] = med(
        lambda: sf.lanczos_coeffs_fused_sharded(plan, b3l, 20), SHARD_REPS)
    times["pass1 slab alone"] = med(
        lambda: tf.lanczos_coeffs_fused(plan.ext, v_ext, 20), SHARD_REPS)
    with open(os.path.join(d, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(d, mode, world):
    """Start ``world`` ranks of this script (``--shard-rank``) and wait;
    any rank's failure or timeout fails the run (every rank is killed)."""
    import os

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
         "--shard-world", str(world), "--shard-dir", d, "--shard-mode",
         mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=SHARD_TIMEOUT)
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r} of {world} ({mode}) timed out")
                break
            if p.returncode != 0:
                errs.append(f"rank {r} of {world} ({mode}) exited "
                            f"{p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not errs, "; ".join(errs))


def sharded_path(et, dev, card):
    """The fourth path (module doc): references from the single-device
    port on this card, then the ranks; every check printed on its own
    line. Returns (launches summed over every rank of every run,
    {(world, cell): rank 0's ms}, {cell: single-device call})."""
    import os
    import shutil
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from exponentialutilities_jl_torch.ops.kernels import _build

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="eu_shard_")
    try:
        ins = shard_inputs(et, dev, dev)
        boundsV = ins["opV"].spectral_bounds_hint()
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"boundsV": list(boundsV)}, f)
        cells = shard_cells(et, ins, boundsV)
        A1 = sp.diags([np.ones(N1 - 1), -2 * np.ones(N1), np.ones(N1 - 1)],
                      [-1, 0, 1], format="csr")
        AP = banded_csr(ins["opP"])
        oracles = {"config2 expv m=40": spla.expm_multiply(
            T1 * A1, ins["b1"].cpu().numpy())}
        oracles[f"config3 phiv k={K} m=30"] = spla.expm_multiply(
            TP * AP, ins["bP"].cpu().numpy())
        oracles["config3 make_expv_step m=30"] = \
            oracles[f"config3 phiv k={K} m=30"]
        singles = {}
        for i, (name, (single, _, _, _, _)) in enumerate(cells.items()):
            w = single()
            singles[name] = single
            if isinstance(w, tuple):
                w = w[0]
            if name.startswith("leja"):
                wPl = w
            torch.save(w.cpu(), os.path.join(d, f"ref{i}.pt"))
            if name in oracles:
                torch.save(torch.as_tensor(oracles[name]),
                           os.path.join(d, f"oracle{i}.pt"))
        wB1 = et.expv_leja(TL, ins["opL"], ins["bL"])       # B1's path
        print(f"sharded path inputs and references: "
              f"{time.perf_counter() - t0:.1f} s; leja n={NL}: the plain "
              f"path vs B1's {rel_max(wPl, wB1):.2e}", flush=True)
        del wB1, wPl
        torch.cuda.empty_cache()
        counts = {k: 0 for k in _build.launches}
        ms = {}
        for mode, world in [("gloo", P) for P in SHARD_WORLDS] + [("nccl",
                                                                   1)]:
            t1 = time.perf_counter()
            run_ranks(d, mode, world)
            ranks = []
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            tag = f"P={world} {mode}"
            for name, c0 in ranks[0]["cells"].items():
                _, _, _, want_l, want_c = cells[name]
                for rk in ranks:
                    c = rk["cells"][name]
                    check(c["finite"], f"{tag} {name}: non-finite rows")
                    check(c["launches"] == want_l,
                          f"{tag} {name} rank {rk['rank']}: launches "
                          f"{c['launches']} != {want_l}")
                    check(c["census"] == want_c,
                          f"{tag} {name} rank {rk['rank']}: collectives "
                          f"{c['census']} != {want_c}")
                    for k, v in c["launches"].items():
                        counts[k] += v
                e = (max(rk["cells"][name]["diff"] for rk in ranks)
                     / max(rk["cells"][name]["scale"] for rk in ranks))
                check(e <= MTOL_SHARD, f"{tag} {name} vs single-device "
                      f"{e:.2e}")
                line = (f"check sharded {tag} {name}: vs the single-device "
                        f"port {e:.2e} (tol {MTOL_SHARD:g}); launches "
                        f"{c0['launches']} and collectives {c0['census']} "
                        "on every rank")
                if "oracle_sq" in c0:
                    eo = math.sqrt(sum(rk["cells"][name]["oracle_sq"]
                                       for rk in ranks)
                                   / sum(rk["cells"][name]["oracle_norm_sq"]
                                         for rk in ranks))
                    check(eo <= MTOL_SCIPY64, f"{tag} {name} vs scipy "
                          f"{eo:.2e}")
                    line += (f"; vs scipy expm_multiply {eo:.2e} "
                             f"(tol {MTOL_SCIPY64:g})")
                if c0["err"] is not None:
                    check(all(rk["cells"][name]["err"] == c0["err"]
                              for rk in ranks), f"{tag} {name}: err differs "
                          "between ranks")
                    line += "; err bit-identical across ranks"
                print(line, flush=True)
            check(all(rk["scalars"] == ranks[0]["scalars"] for rk in ranks),
                  f"{tag}: alpha, beta, beta0 differ between ranks")
            check(all(rk["replay_equal"] for rk in ranks),
                  f"{tag}: the replay's alpha, beta differ from pass 1's")
            print(f"check sharded {tag} {N3}^3 two-pass: alpha, beta, beta0 "
                  "bit-identical across ranks; the replay's alpha and beta "
                  "equal pass 1's on every rank"
                  + ("; pass 1 and the replay ran under sync debug mode "
                     "'error'" if mode == "nccl" else ""), flush=True)
            for name, t in ranks[0]["ms"].items():
                ms[(tag, name)] = t
            sh = 1.0 - (ranks[0]["ms"]["pass1 slab alone"]
                        / ranks[0]["ms"]["pass1 sharded"])
            ms[(tag, "staging share")] = sh
            print(f"sharded {tag}: {time.perf_counter() - t1:.1f} s (ranks "
                  "started, run and checked)", flush=True)
        # two NCCL ranks on this one card: the mesh raises, NCCL refuses
        run_ranks(d, "nccl-dup", 2)
        for r in range(2):
            with open(os.path.join(d, f"dup_rank{r}.json")) as f:
                dup = json.load(f)
            check(dup["mesh"] is not None and "share one device"
                  in dup["mesh"], f"NCCL mesh of two ranks on one card did "
                  f"not raise: {dup}")
            print(f"check NCCL two ranks on one card, rank {r}: make_mesh "
                  f"raised ({dup['mesh']}); NCCL itself: "
                  f"{(dup['nccl'] or 'no error').splitlines()[-1]}",
                  flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return counts, ms, singles


# ---- the fifth path: the GSPMD route on this one card ----
# parallel.shard_operator and the ordinary drivers on each rank's rows: P =
# 2 gloo ranks sharing cuda:0 for most cells, P = 4 for the data x shard
# mesh, one NCCL rank. The same launcher as the fourth path (``--shard-rank``
# with modes "gspmd", "gspmd-ds", "gspmd-nccl"). No scaling numbers: the
# ranks time-share one card and gloo stages through the host.
GSPMD_WORLD = 2
GSPMD_DS_WORLD = 4       # the data x shard mesh: 2 x 2
# sharded vs the single-device port on the same card: MTOL_SHARD for the
# fixed-m Krylov and Chebyshev cells; Leja/Faber (no reductions in the
# recurrence) at the JAX test's 1e-13, relative 2-norm; the adaptive
# drivers with equal steps, rejections and Krylov steps, at the JAX
# exprb43_device test's 1e-10
MTOL_GSPMD_POLY = 1e-13
MTOL_GSPMD_ADAPT = 1e-10
# config #4's drivers at TGA and the n = 1e6 Leja/Faber at TL: seconds a
# call at P = 2 (gloo), so each is timed by its checked call alone (and the
# single-device call by one run); every other cell by a median of 5. Depth
# cut: the drivers run a quarter of config #4's time (TA / 4), which keeps
# the whole script within its time limit as paths are added (at TA the
# three took 52 s of rank time a call on a slow host)
TGA = TA / 4
GSPMD_LONG = ("config4 phiv_timestep_device m=20", "config4 kiops_device",
              "config4 exprb43_device", "leja n=1e6", "faber n=1e6")
# A halo wider than a shard: poisson_2d(NH, 2) (n = 2 NH, offsets +-1 and
# +-NH) on the P = 4 ranks of the data x shard run, 5e4 rows a rank, so k =
# 2 exchanges a matvec and B7 on a 2.5e5-row slab; held to the
# single-device port at MTOL_HOP (max-norm relative). The reverse rule of a
# non-Hermitian sharded operator: config #4's gradient (expv m = 40,
# differentiable=True, t = TG4, loss sum w^2) and config #1's at P = 2,
# held to the single-device port at MTOL_SHARD. Calibrated on the CPU from
# the JAX package's GSPMD route at the same settings (virtual devices, the
# single-device JAX call as the reference): poisson_2d(NH, 2) expv m = 30 at
# P = 4 (t = TP) JAX_HOP; jax.grad of config #4's and config #1's cells at
# P = 2 JAX_GRAD.
NH = 100_000
GSPMD_HOP_WORLD = GSPMD_DS_WORLD
MTOL_HOP = 1e-14
JAX_HOP = 1.5e-15
JAX_GRAD = {"config4 grad expv m=40": 1.6e-15,
            "config1 dense grad expv m=40": 3.3e-16}
HOP_CELL = f"poisson_2d({NH}, 2) expv m=30"


class HaloAxis:
    """A mesh axis with no process group for the phase-3 checks of the
    GSPMD slabs: rank ``index`` of ``size``, its halos cut from the global
    vector ``x`` (zeros past the ends), as ``MeshAxis.ppermute_halo`` would
    deliver them. The exchanges of one slab come in rounds, each the next
    rows outward (a halo wider than a shard takes several); ``calls``
    counts them. Make one per slab."""

    def __init__(self, size, index, x, device):
        self.size, self.index, self.x = size, index, x
        self.device = device
        self.calls = 0
        self.depth = 0

    def axis_size(self):
        return self.size

    def axis_index(self):
        return self.index

    def _cut(self, i, j, like):
        out = like.new_zeros(j - i)
        a, b = max(i, 0), min(j, self.x.shape[0])
        if b > a:
            out[a - i:b - i] = self.x[a:b]
        return out

    def ppermute_halo(self, lo, hi):
        r, nl = lo.shape[0], self.x.shape[0] // self.size
        a, b = self.index * nl, (self.index + 1) * nl
        d = self.depth
        self.calls += 1
        self.depth += r
        return self._cut(a - d - r, a - d, hi), self._cut(b + d, b + d + r, lo)


def gspmd_kernel_checks(et, dev, dt, tol, opB, gen):
    """Phase 3: B7 on the halo-extended slab of every rank of P = 4 for
    config #3's and config #4's operators (``ShardedBandedOperator``'s
    product, one launch) against ``LocalBandedOperator``'s plain matvec on
    the same rows and against the global operator's rows; B8 on each
    rank's block rows of the 128^3 block-ELL (P = 2) with the whole x, a
    rectangular product, against ``blockell_spmv_ref``; B7 on the
    multi-hop slabs of poisson_2d(NH, 2) at P = 4 (h = NH, two exchanges)
    and on the adjoint slabs of config #4's operator at P = 2 and 4 (the
    reverse rule), each against B7's twin on the same slab and the global
    rows. Returns the largest error of each kernel."""
    import torch

    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    from exponentialutilities_jl_torch.parallel import gspmd, ops as pops

    dn = str(dt).split(".")[-1]
    errs = {"banded_spmv": 0.0, "blockell_spmv": 0.0}
    for label, gop in ((f"config3 poisson_2d({NP}, {NP})",
                        et.poisson_2d(NP, NP, dtype=dt, device=dev)),
                       (f"config4 advection_diffusion_1d({NA})",
                        et.advection_diffusion_1d(NA, peclet=10.0, dtype=dt,
                                                  device=dev))):
        n = gop.shape[0]
        x = torch.as_tensor(gen.standard_normal(n), dtype=dt, device=dev)
        yg = gop.matvec(x)
        P = 4
        for i in range(P):
            ax = HaloAxis(P, i, x, dev)
            sop = gspmd.ShardedBandedOperator(gop, ax)
            nl = n // P
            xl = x[i * nl:(i + 1) * nl]
            before = _build.launches["banded_spmv"]
            y = sop._local_matvec(xl)
            torch.cuda.synchronize()
            check(_build.launches["banded_spmv"] - before == 1,
                  f"B7 slab {label} rank {i}: not one launch")
            lop = pops.LocalBandedOperator(gop.diags[:, i * nl:(i + 1) * nl],
                                           gop.offsets, n,
                                           HaloAxis(P, i, x, dev))
            e1 = rel_max(y, lop.matvec(xl))
            e2 = rel_max(y, yg[i * nl:(i + 1) * nl])
            check(max(e1, e2) <= tol, f"B7 {dn} halo slab {label} rank {i} "
                  f"of {P}: {e1:.2e} vs the local plain matvec, {e2:.2e} "
                  "vs the global rows")
            errs["banded_spmv"] = max(errs["banded_spmv"], e1, e2)
        print(f"kernel B7 {dn} halo-extended slabs {label}, P = 4 (every "
              f"rank, diagonals (k, n/4 + 2h)): max rel err "
              f"{errs['banded_spmv']:.2e} vs LocalBandedOperator's plain "
              f"matvec and the global rows (tol {tol:g}); one launch each",
              flush=True)
    blocks = opB.blocks.to(dt)
    x = torch.as_tensor(gen.standard_normal(opB.shape[0]), dtype=dt,
                        device=dev)
    nbr = blocks.shape[0]
    for i in range(2):
        rows = slice(i * nbr // 2, (i + 1) * nbr // 2)
        B, C = blocks[rows].contiguous(), opB.bcols[rows].contiguous()
        y = tsp.blockell_spmv(B, C, x)
        e = rel_max(y, tsp.blockell_spmv_ref(B, C, x))
        check(e <= tol and y.shape[0] == x.shape[0] // 2,
              f"B8 {dn} rectangular rank {i}: {e:.2e}")
        errs["blockell_spmv"] = max(errs["blockell_spmv"], e)
    print(f"kernel B8 {dn} rectangular ({nbr // 2} of {nbr} block rows by "
          f"the whole x, {NB}^3 8 x 8, P = 2 halves): max rel err "
          f"{errs['blockell_spmv']:.2e} vs blockell_spmv_ref (tol {tol:g})",
          flush=True)
    def slab_vs_twin(sop, xl, i, P, rows_ref, what):
        """B7 on rank i's slab (one launch, ``sop.comm`` a fresh HaloAxis)
        against B7's twin on the same slab and the global rows."""
        before = _build.launches["banded_spmv"]
        y = sop._local_matvec(xl)
        torch.cuda.synchronize()
        hops = sop.comm.calls
        check(_build.launches["banded_spmv"] - before == 1,
              f"B7 {what} rank {i}: not one launch")
        sop.comm = HaloAxis(P, i, sop.comm.x, dev)
        slab = sop._slab(xl)
        h = sop.halo
        yt = tsp.banded_spmv_ref(sop.ext.diags, sop.offsets,
                                 slab)[h:h + xl.shape[0]]
        e1, e2 = rel_max(y, yt), rel_max(y, rows_ref)
        check(max(e1, e2) <= tol, f"B7 {dn} {what} rank {i} of {P}: "
              f"{e1:.2e} vs the twin on the slab, {e2:.2e} vs the global "
              "rows")
        return max(e1, e2), hops, slab.shape[0]

    # a halo wider than a shard, poisson_2d(NH, 2) at P = 4: h = NH,
    # k = 2 exchanges, one launch on the (n/4 + 2h)-row slab
    gop = et.poisson_2d(NH, 2, dtype=dt, device=dev)
    n = gop.shape[0]
    x = torch.as_tensor(gen.standard_normal(n), dtype=dt, device=dev)
    yg = tsp.banded_spmv_ref(gop.diags, gop.offsets, x)
    P, nl, e_hop = GSPMD_HOP_WORLD, n // GSPMD_HOP_WORLD, 0.0
    for i in range(P):
        sop = gspmd.ShardedBandedOperator(gop, HaloAxis(P, i, x, dev))
        e, hops, rows = slab_vs_twin(sop, x[i * nl:(i + 1) * nl], i, P,
                                     yg[i * nl:(i + 1) * nl],
                                     "multi-hop slab")
        check(hops == 2 and rows == nl + 2 * NH,
              f"multi-hop slab rank {i}: {hops} exchanges, {rows} rows")
        e_hop = max(e_hop, e)
    errs["banded_spmv"] = max(errs["banded_spmv"], e_hop)
    print(f"kernel B7 {dn} multi-hop slabs poisson_2d({NH}, 2), P = {P} "
          f"(h = {NH} > {nl} rows a rank: 2 exchanges, a {nl + 2 * NH}-row "
          f"slab): max rel err {e_hop:.2e} vs B7's twin on the same slab "
          f"and the global rows (tol {tol:g}); one launch each", flush=True)

    # the adjoint slab of config #4's operator (the reverse rule of a
    # non-Hermitian sharded banded operator), P = 2 and 4
    gop = et.advection_diffusion_1d(NA, peclet=10.0, dtype=dt, device=dev)
    g = torch.as_tensor(gen.standard_normal(NA), dtype=dt, device=dev)
    want = torch.as_tensor(banded_csr(gop).T @ g.cpu().numpy(), device=dev)
    e_adj = 0.0
    for P in (2, 4):
        nl = NA // P
        for i in range(P):
            sop = gspmd.ShardedBandedOperator(gop, HaloAxis(P, i, g, dev))
            adj = sop._adjoint()
            adj.comm = HaloAxis(P, i, g, dev)
            e, _, _ = slab_vs_twin(adj, g[i * nl:(i + 1) * nl], i, P,
                                   want[i * nl:(i + 1) * nl], "adjoint slab")
            e_adj = max(e_adj, e)
    errs["banded_spmv"] = max(errs["banded_spmv"], e_adj)
    print(f"kernel B7 {dn} adjoint slabs of config4 advection_diffusion_1d"
          f"({NA}), P = 2 and 4 (every rank): max rel err {e_adj:.2e} vs "
          f"B7's twin on the same slab and the rows of A^T g (tol {tol:g}); "
          "one launch each", flush=True)
    return errs


def gspmd_inputs(et, dev, blk):
    """The fifth path's global operators and vectors, the same in the
    parent and in every rank (SEED + 16; config #1's dense matrix and the
    config #4 vector from phase 4's seeds). ``blk``: the 128^3 block-ELL's
    (blocks, bcols), built once by the parent."""
    import torch

    gen = np.random.default_rng(SEED + 16)

    def v(n):
        return torch.as_tensor(gen.standard_normal(n), device=dev)

    rngc = np.random.default_rng(SEED)
    A1np = rngc.standard_normal((100, 100)) / 10
    b1c = rngc.standard_normal(100)
    ops = {"P": et.poisson_2d(NP, NP, device=dev),
           "H": et.poisson_2d(NH, 2, device=dev),
           "A": et.advection_diffusion_1d(NA, peclet=10.0, device=dev),
           "E": et.laplacian_1d(N1, device=dev).to_ell(),
           "B": et.BlockELLOperator(blk[0].to(dev), blk[1].to(dev),
                                    is_hermitian=True),
           "D": et.DenseOperator(torch.as_tensor(A1np, device=dev)),
           "L": bench_leja_stencil(et, NL, torch.float64, dev)}
    bP, b1, bB, bL = v(NP * NP), v(N1), v(NB ** 3), v(NL)
    bA = torch.as_tensor(np.random.default_rng(SEED).standard_normal(NA),
                         device=dev)
    vecs = {"bP": bP,
            "BP": torch.stack([bP, 0.1 * bP, 0.01 * bP, 0.001 * bP], dim=1),
            "bA": bA, "BA": torch.stack([bA, 0.1 * bA], dim=1),
            "uA": 0.1 * v(NA), "b1": b1, "bB": bB,
            "bD": torch.as_tensor(b1c, device=dev),
            "BL": torch.stack([bL, 0.1 * bL], dim=1),
            "BB": v(4 * NP * NP).reshape(4, NP * NP),
            "bH": v(2 * NH)}
    return ops, vecs


def gspmd_cells(et):
    """{cell: (call(ops, vecs, comm, counter) -> result dict, the
    launches per rank its result implies (a function of it), its
    tolerance kind)}. The same call runs on the global operators and
    vectors (the single-device reference) and on a rank's sharded
    operators and rows. ``counter`` counts f's calls, plain and under
    ``torch.func.jvp`` (exprb43_device's Jacobian matvecs)."""
    import dataclasses

    import torch

    from exponentialutilities_jl_torch.models import chebyshev as tc
    from exponentialutilities_jl_torch.models.timestepping import _bucket_m

    def st(s):
        return dataclasses.asdict(s)

    def expv_P(o, v, comm, cnt):
        return {"w": et.expv(TP, o["P"], v["bP"], m=30)}

    def kiops_P(o, v, comm, cnt):
        w, s = et.kiops([TP], o["P"], v["BP"], tol=1e-7)
        return {"w": w, "stats": st(s)}

    def nw_P(o, v, comm, cnt):
        U, s = et.phiv_timestep([TP], o["P"], v["BP"], adaptive=True,
                                two_pass=True, tol=1e-7, return_stats=True)
        return {"w": U, "stats": st(s)}

    def cheb_P(o, v, comm, cnt):
        return {"w": et.expv_chebyshev(TP, o["P"], v["bP"], tol=1e-12)}

    def nwdev_A(o, v, comm, cnt):
        U, s = et.phiv_timestep_device([TGA], o["A"], v["BA"], tol=1e-7,
                                       m=20, return_stats=True)
        return {"w": U, "stats": st(s)}

    def kiopsdev_A(o, v, comm, cnt):
        w, s = et.kiops_device([TGA], o["A"], v["BA"], tol=1e-7)
        return {"w": w, "stats": st(s)}

    def exprb_A(o, v, comm, cnt):
        A = o["A"]

        def f(u):
            traced = torch._C._functorch.is_functorch_wrapped_tensor(u)
            cnt["jvp" if traced else "plain"] += 1
            return A.matvec(u) - u ** 3

        u, s = et.exprb43_device(f, v["uA"], (0.0, TGA), adaptive=True,
                                 m=12, rtol=1e-6, atol=1e-9,
                                 return_stats=True, comm=comm)
        return {"w": u, "stats": st(s), "f": dict(cnt)}

    def ell(o, v, comm, cnt):
        return {"w": et.expv(T1, o["E"], v["b1"], m=40, hermitian=True)}

    def blockell(o, v, comm, cnt):
        return {"w": et.expv(T3, o["B"], v["bB"], m=20)}

    def dense(o, v, comm, cnt):
        return {"w": et.expv(1.0, o["D"], v["bD"], m=40)}

    def grad(key, vec, t):
        # d/db sum w^2 over every rank's rows: each rank's backward on its
        # own part, the psums' reverse rules joining them
        def call(o, v, comm, cnt):
            b = v[vec].clone().requires_grad_()
            w = et.expv(t, o[key], b, m=40, differentiable=True)
            (w ** 2).sum().backward()
            return {"w": b.grad}
        return call

    def leja(o, v, comm, cnt):
        return {"w": et.phiv_timestep_leja([TL], o["L"], v["BL"],
                                           tol=1e-7)}

    def faber(o, v, comm, cnt):
        return {"w": et.phiv_timestep_faber([TL], o["L"], v["BL"],
                                            tol=1e-7)}

    def degree(op, t, tol):
        return len(tc._full_exp_coeffs(t, *op.spectral_bounds_hint(), tol,
                                       None)[0])

    b7, r1 = "banded_spmv", "tridiag_exp"
    return {
        # Hermitian Krylov cells: one R1 (tridiag_exp) for the reduced
        # exponential on every rank
        "config3 expv m=30": (expv_P, lambda r, o: {b7: 30, r1: 1},
                              "fixed"),
        "config3 kiops p=3": (
            kiops_P, lambda r, o: {b7: r["stats"]["krylov_steps"]},
            "adaptive"),
        "config3 phiv_timestep two-pass p=3": (
            nw_P, lambda r, o: {b7: r["stats"]["matvecs"]}, "adaptive"),
        "config3 expv_chebyshev": (
            cheb_P, lambda r, o: {b7: degree(o["P"], TP, 1e-12)}, "fixed"),
        "config4 phiv_timestep_device m=20": (
            nwdev_A, lambda r, o: {b7: r["stats"]["matvecs"] + 1
                                   + _bucket_m(20, NA, 256)}, "adaptive"),
        "config4 kiops_device": (
            kiopsdev_A, lambda r, o: {b7: r["stats"]["krylov_steps"]},
            "adaptive"),
        "config4 exprb43_device": (
            exprb_A, lambda r, o: {b7: r["f"]["plain"] + 2 * r["f"]["jvp"]},
            "adaptive"),
        f"ell laplacian_1d({N1}) expv m=40": (ell, lambda r, o: {r1: 1},
                                               "fixed"),
        f"blockell {NB}^3 expv m=20": (
            blockell, lambda r, o: {"blockell_spmv": 20, r1: 1}, "fixed"),
        "config1 dense expv m=40": (dense, lambda r, o: {}, "fixed"),
        # forward B7 on the slab, reverse B7 on the adjoint slab
        "config4 grad expv m=40": (grad("A", "bA", TG4),
                                   lambda r, o: {b7: 80}, "fixed"),
        "config1 dense grad expv m=40": (grad("D", "bD", 1.0),
                                         lambda r, o: {}, "fixed"),
        "leja n=1e6": (leja, lambda r, o: {}, "poly"),
        "faber n=1e6": (faber, lambda r, o: {}, "poly"),
    }


# collectives per rank a cell's parameters imply (printed for the others):
# Lanczos m: 1 + 2m psums, m halo exchanges (or all_gathers); Arnoldi with
# CGS2: 1 + 3m psums; Chebyshev M: M exchanges, the finiteness pmax. A
# gradient adds its reverse sweep: one psum for each psum of the forward
# (the psum's reverse rule) and, per matvec, one halo exchange (the banded
# view, B7 on the adjoint slab) or one psum (the dense view's A_rows^H g)
def gspmd_census(et, ops):
    from exponentialutilities_jl_torch.models import chebyshev as tc

    M = len(tc._full_exp_coeffs(TP, *ops["P"].spectral_bounds_hint(),
                                1e-12, None)[0])
    return {"config3 expv m=30": {"psum": 61, "ppermute": 30},
            "config3 expv_chebyshev": {"ppermute": M, "pmax": 1},
            f"ell laplacian_1d({N1}) expv m=40": {"psum": 81,
                                                  "all_gather": 40},
            f"blockell {NB}^3 expv m=20": {"psum": 41, "all_gather": 20},
            "config1 dense expv m=40": {"psum": 121, "all_gather": 40},
            "config4 grad expv m=40": {"psum": 2 * 121, "ppermute": 2 * 40},
            "config1 dense grad expv m=40": {"psum": 2 * 121 + 40,
                                             "all_gather": 40}}


def gspmd_rank_main(args) -> int:
    """One rank of the fifth path: shard every cell's operator with
    ``parallel.shard_operator``, run the cell's ordinary driver on this
    rank's rows and write ``gspmd_<mode>_rank<R>.json``: errors against the
    parent's single-device references, launches and collectives per cell,
    the replicated scalars (stats, in hex where floats), rank 0's CUDA-event
    medians."""
    import collections
    import os

    import torch
    import torch.distributed as dist

    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch import parallel as par
    from exponentialutilities_jl_torch.ops.kernels import _build

    d, r, P, mode = (args.shard_dir, args.shard_rank, args.shard_world,
                     args.shard_mode)
    dev = torch.device(SHARD_DEVICE)
    torch.cuda.set_device(dev)
    par.initialize_distributed(f"file://{d}/store-{mode}-{P}", P, r, 0,
                               backend="nccl" if mode == "gspmd-nccl"
                               else "gloo")
    blk = torch.load(os.path.join(d, "gspmd_blockell.pt"), mmap=True)
    ops, vecs = gspmd_inputs(et, dev, blk)
    out = {"rank": r, "cells": {}, "ms": {}}

    def hexs(x):
        if isinstance(x, float):
            return x.hex()
        if isinstance(x, dict):
            return {k: hexs(v) for k, v in x.items()}
        return x

    def timed(fn, reps):
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

    if mode == "gspmd-ds":
        # the data x shard mesh: this rank's data slice of B's rows and its
        # shard's columns; expv_batched reduces over "shard" only
        hd = par.make_host_data_mesh(n_hosts=2, device=dev)
        di, si = hd.axis("data").axis_index(), hd.axis("shard").axis_index()
        op_s = par.shard_operator(ops["P"], hd, "shard")
        nl = NP * NP // 2
        Bl = vecs["BB"][2 * di:2 * di + 2, si * nl:(si + 1) * nl]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        hd.reset_census()
        W = et.expv_batched(TP, op_s, Bl, m=30)
        torch.cuda.synchronize()
        ref = torch.load(os.path.join(d, "gspmd_ref_batched.pt"),
                         mmap=True)[2 * di:2 * di + 2, si * nl:(si + 1) * nl]
        out["cells"]["config3 expv_batched 4 columns m=30"] = {
            "launches": {k: v for k, v in _build.launches.items() if v},
            "census": {k: dict(v) for k, v in hd.census.items()},
            "diff": float((W - ref.to(dev)).abs().max()),
            "scale": float(ref.abs().max()), "data": di, "shard": si}
        out["ms"]["config3 expv_batched 4 columns m=30"] = timed(
            lambda: et.expv_batched(TP, op_s, Bl, m=30), GSPMD_REPS)
        # a halo wider than a shard on the same ranks' 1-D mesh
        mesh = par.make_mesh(device=dev)
        op_h = par.shard_operator(ops["H"], mesh)
        b_h = par.shard_vector(vecs["bH"], mesh)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        mesh.reset_census()
        w = et.expv(TP, op_h, b_h, m=30)
        torch.cuda.synchronize()
        nl = 2 * NH // P
        ref = torch.load(os.path.join(d, "gspmd_ref_hop.pt"),
                         mmap=True)[r * nl:(r + 1) * nl].to(dev)
        out["cells"][HOP_CELL] = {
            "launches": {k: v for k, v in _build.launches.items() if v},
            "census": {k: v for k, v in mesh.census["shard"].items() if v},
            "halo": op_h.halo, "slab": int(op_h.ext.diags.shape[1]),
            "finite": bool(torch.isfinite(w).all()),
            "diff": float((w - ref).abs().max()),
            "scale": float(ref.abs().max())}
        out["ms"][HOP_CELL] = timed(lambda: et.expv(TP, op_h, b_h, m=30),
                                    GSPMD_REPS)
    else:
        mesh = par.make_mesh(device=dev)
        ax = mesh.axis()
        cells = gspmd_cells(et)
        if mode == "gspmd-nccl":
            cells = {k: cells[k] for k in ("config3 expv m=30",
                                           "config3 kiops p=3")}
        sh = {k: par.shard_operator(op, mesh) for k, op in ops.items()}
        loc = {k: par.shard_vector(v, mesh) for k, v in vecs.items()
               if k != "BB"}
        for i, (name, (call, want_l, kind)) in enumerate(cells.items()):
            cnt = collections.Counter()
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            mesh.reset_census()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = call(sh, loc, ax, cnt)
            e.record()
            e.synchronize()
            first_ms = s.elapsed_time(e)
            launches = {k: v for k, v in _build.launches.items() if v}
            census = {k: v for k, v in mesh.census["shard"].items() if v}
            w = res["w"]
            ref = torch.load(os.path.join(d, f"gspmd_ref{i}.pt"), mmap=True)
            nl = ref.shape[0] // P
            ref = ref[r * nl:(r + 1) * nl].to(dev)
            c = {"launches": launches, "census": census,
                 "want_launches": want_l(res, ops),
                 "finite": bool(torch.isfinite(w).all()),
                 "diff": float((w - ref).abs().max()),
                 "scale": float(ref.abs().max()),
                 "diff_sq": float(((w - ref) ** 2).sum()),
                 "ref_sq": float((ref ** 2).sum()),
                 "stats": hexs(res.get("stats")), "f": res.get("f")}
            orc = os.path.join(d, f"gspmd_oracle{i}.pt")
            if os.path.exists(orc):
                o = torch.load(orc, mmap=True)[r * nl:(r + 1) * nl].to(dev)
                col = w[:, 0] if w.ndim == 2 else w
                c["oracle_sq"] = float(((col - o) ** 2).sum())
                c["oracle_norm_sq"] = float((o ** 2).sum())
            out["cells"][name] = c
            # every rank runs every timed call (the collectives keep them
            # in step); a long cell's time is its checked call's
            if name in GSPMD_LONG:
                out["ms"][name] = first_ms
            else:
                out["ms"][name] = timed(
                    lambda: call(sh, loc, ax, collections.Counter()),
                    GSPMD_REPS)
    with open(os.path.join(d, f"gspmd_{mode}_rank{r}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def gspmd_path(et, dev, card, opB3):
    """The fifth path (module doc): single-device references on this card,
    then the ranks; every check printed on its own line. Returns (launches
    summed over every rank of every run, {(run, cell): rank 0's ms},
    {cell: single-device call})."""
    import collections
    import os
    import shutil
    import tempfile

    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from exponentialutilities_jl_torch.ops.kernels import _build

    def hop_checks(tag, ranks):
        """The multi-hop cell: B7 and k = 2 exchanges a matvec on every
        rank, config #3's psums, the (n/P + 2h)-row slab, the single-device
        port at MTOL_HOP."""
        want_l = {"banded_spmv": 30, "tridiag_exp": 1}
        want_c = {"psum": 61, "ppermute": 2 * 30}
        nl = 2 * NH // GSPMD_HOP_WORLD
        for rk in ranks:
            c = rk["cells"][HOP_CELL]
            check(c["finite"], f"{tag} {HOP_CELL}: non-finite rows")
            check(c["launches"] == want_l and c["census"] == want_c,
                  f"{tag} {HOP_CELL} rank {rk['rank']}: launches "
                  f"{c['launches']}, collectives {c['census']}")
            check(c["halo"] == NH and c["slab"] == nl + 2 * NH,
                  f"{tag} {HOP_CELL}: halo {c['halo']}, slab {c['slab']}")
        e = (max(rk["cells"][HOP_CELL]["diff"] for rk in ranks)
             / max(rk["cells"][HOP_CELL]["scale"] for rk in ranks))
        check(e <= MTOL_HOP, f"{tag} {HOP_CELL} vs single-device {e:.2e}")
        c0 = ranks[0]["cells"][HOP_CELL]
        print(f"check GSPMD {tag} {HOP_CELL}: halo {NH} over {nl} rows a "
              f"rank, B7 on a {c0['slab']}-row slab; vs the single-device "
              f"port {e:.2e} (tol {MTOL_HOP:g}; JAX on the CPU {JAX_HOP:.1e})"
              f"; launches {c0['launches']} on every rank; collectives "
              f"{c0['census']} (2 exchanges a matvec)", flush=True)

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="eu_gspmd_")
    try:
        blk = (opB3.blocks.cpu(), opB3.bcols.cpu())
        torch.save(blk, os.path.join(d, "gspmd_blockell.pt"))
        ops, vecs = gspmd_inputs(et, dev, blk)
        cells = gspmd_cells(et)
        census_want = gspmd_census(et, ops)
        A1 = sp.diags([np.ones(N1 - 1), -2 * np.ones(N1), np.ones(N1 - 1)],
                      [-1, 0, 1], format="csr")
        oracles = {
            "config3 expv m=30": spla.expm_multiply(
                TP * banded_csr(ops["P"]), vecs["bP"].cpu().numpy()),
            f"ell laplacian_1d({N1}) expv m=40": spla.expm_multiply(
                T1 * A1, vecs["b1"].cpu().numpy()),
            "config1 dense expv m=40": sla.expm(
                ops["D"].A.cpu().numpy()) @ vecs["bD"].cpu().numpy()}
        singles, sstats = {}, {}
        for i, (name, (call, _, _)) in enumerate(cells.items()):
            res = call(ops, vecs, None, collections.Counter())
            singles[name] = (lambda call=call: call(
                ops, vecs, None, collections.Counter()))
            sstats[name] = res.get("stats")
            torch.save(res["w"].cpu(), os.path.join(d, f"gspmd_ref{i}.pt"))
            if name in oracles:
                torch.save(torch.as_tensor(oracles[name]),
                           os.path.join(d, f"gspmd_oracle{i}.pt"))
        Wb = et.expv_batched(TP, ops["P"], vecs["BB"], m=30)
        torch.save(Wb.cpu(), os.path.join(d, "gspmd_ref_batched.pt"))
        singles["config3 expv_batched 4 columns m=30"] = (
            lambda: et.expv_batched(TP, ops["P"], vecs["BB"], m=30))
        wh = et.expv(TP, ops["H"], vecs["bH"], m=30)
        torch.save(wh.cpu(), os.path.join(d, "gspmd_ref_hop.pt"))
        singles[HOP_CELL] = lambda: et.expv(TP, ops["H"], vecs["bH"], m=30)
        # the gradient cell's single-device reference against the third
        # path's form of the same gradient (no differentiable=True)
        b = vecs["bA"].clone().requires_grad_()
        w = et.expv(TG4, ops["A"], b, m=40, hermitian=False)
        g13 = torch.autograd.grad((w ** 2).sum(), b)[0]
        g1 = torch.load(os.path.join(
            d, f"gspmd_ref{list(cells).index('config4 grad expv m=40')}.pt"))
        e = rel_max(g1, g13.cpu())
        check(e <= MTOL_GRAD, f"config4 grad expv m=40: differentiable=True "
              f"vs the third path's form {e:.2e}")
        print(f"check GSPMD config4 grad expv m=40 single-device reference: "
              f"differentiable=True vs the third path's gradient form "
              f"{e:.2e} (tol {MTOL_GRAD:g})", flush=True)
        del wh, w, b, g13, g1
        print(f"GSPMD path inputs and references: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del Wb
        torch.cuda.empty_cache()
        counts = {k: 0 for k in _build.launches}
        ms = {}
        for mode, world in (("gspmd", GSPMD_WORLD),
                            ("gspmd-ds", GSPMD_DS_WORLD),
                            ("gspmd-nccl", 1)):
            t1 = time.perf_counter()
            run_ranks(d, mode, world)
            ranks = []
            for r in range(world):
                with open(os.path.join(d, f"gspmd_{mode}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            tag = f"P={world} {mode}"
            for name, c0 in ranks[0]["cells"].items():
                for rk in ranks:
                    c = rk["cells"][name]
                    for k, v in c["launches"].items():
                        counts[k] += v
                if name == HOP_CELL:
                    hop_checks(tag, ranks)
                    continue
                if mode == "gspmd-ds":
                    # one batched build of the rank's 2 rows: B7 on each
                    # row's slab (the sharded view's matvec, one halo
                    # exchange a row a step), one K2; the reductions one
                    # (2,) psum each: 1 + 2 m
                    want_l = {"banded_spmv": 2 * 30, "tridiag_exp_batched": 1}
                    want_c = {"psum": 1 + 2 * 30, "ppermute": 2 * 30}
                    for rk in ranks:
                        c = rk["cells"][name]
                        check(c["launches"] == want_l,
                              f"{tag} {name} rank {rk['rank']}: launches "
                              f"{c['launches']} != {want_l}")
                        check(not any(c["census"]["data"].values()),
                              f"{tag} {name}: a collective on 'data': "
                              f"{c['census']}")
                        got_c = {k: v for k, v in c["census"]["shard"].items()
                                 if v}
                        check(got_c == want_c,
                              f"{tag} {name} rank {rk['rank']}: collectives "
                              f"on 'shard' {got_c} != {want_c}")
                    e = (max(rk["cells"][name]["diff"] for rk in ranks)
                         / max(rk["cells"][name]["scale"] for rk in ranks))
                    check(e <= MTOL_SHARD, f"{tag} {name} vs single-device "
                          f"{e:.2e}")
                    print(f"check GSPMD {tag} {name}: 2 x 2 data x shard "
                          f"mesh, vs the single-device port {e:.2e} (tol "
                          f"{MTOL_SHARD:g}); launches {c0['launches']} on "
                          f"every rank; collectives {c0['census']} (none "
                          "on 'data')", flush=True)
                    continue
                kind = cells[name][2]
                for rk in ranks:
                    c = rk["cells"][name]
                    check(c["finite"], f"{tag} {name}: non-finite rows")
                    check(c["launches"] == c["want_launches"],
                          f"{tag} {name} rank {rk['rank']}: launches "
                          f"{c['launches']} != {c['want_launches']}")
                    if name in census_want:
                        check(c["census"] == census_want[name],
                              f"{tag} {name} rank {rk['rank']}: collectives "
                              f"{c['census']} != {census_want[name]}")
                    check(c["stats"] == c0["stats"] and c["f"] == c0["f"],
                          f"{tag} {name}: replicated stats differ between "
                          "ranks")
                line = f"check GSPMD {tag} {name}: "
                if kind == "poly":
                    e = math.sqrt(sum(rk["cells"][name]["diff_sq"]
                                      for rk in ranks)
                                  / sum(rk["cells"][name]["ref_sq"]
                                        for rk in ranks))
                    tol = MTOL_GSPMD_POLY
                else:
                    e = (max(rk["cells"][name]["diff"] for rk in ranks)
                         / max(rk["cells"][name]["scale"] for rk in ranks))
                    tol = MTOL_GSPMD_ADAPT if kind == "adaptive" \
                        else MTOL_SHARD
                check(e <= tol, f"{tag} {name} vs single-device {e:.2e}")
                line += f"vs the single-device port {e:.2e} (tol {tol:g}"
                line += (f"; JAX on the CPU {JAX_GRAD[name]:.1e})"
                         if name in JAX_GRAD else ")")
                if kind == "adaptive":
                    want_s = {k: v for k, v in sstats[name].items()
                              if k not in ("final_tau",)}
                    got_s = {k: v for k, v in c0["stats"].items()
                             if k not in ("final_tau",)}
                    check(got_s == want_s, f"{tag} {name}: stats {got_s} "
                          f"!= the single-device {want_s}")
                    line += f"; stats equal the single-device call's {got_s}"
                line += (f"; launches {c0['launches']} on every rank (its "
                         f"counters imply {c0['want_launches']}); "
                         f"collectives {c0['census']}")
                if name in census_want:
                    line += " as its parameters imply"
                line += "; replicated stats bit-identical across ranks"
                if "oracle_sq" in c0:
                    eo = math.sqrt(sum(rk["cells"][name]["oracle_sq"]
                                       for rk in ranks)
                                   / sum(rk["cells"][name]["oracle_norm_sq"]
                                         for rk in ranks))
                    check(eo <= MTOL_SCIPY64, f"{tag} {name} vs scipy "
                          f"{eo:.2e}")
                    line += f"; vs scipy {eo:.2e} (tol {MTOL_SCIPY64:g})"
                print(line, flush=True)
            for name, t in ranks[0]["ms"].items():
                ms[(tag, name)] = t
            print(f"GSPMD {tag}: {time.perf_counter() - t1:.1f} s (ranks "
                  "started, run and checked)", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return counts, ms, singles


# The device-resident programs from CUDA graphs (phase 4's sixth path,
# utils/graphs.py): the JAX package's five one-program loops (NW and KIOPS
# device drivers, exprb43_device's adaptive loop, the etdrk4_device and
# exprb43_device scans) on config #4's operator and bench_integrators.py's
# Allen-Cahn. Each cell runs from its graphs, then as the same steps
# eagerly (graphs.eager()); the two agree to GRAPH_TOL with equal stats.
GRAPH_TOL = 1e-14       # relative 2-norm, graph replays vs the eager steps
GRAPH_M0 = 20           # config #4's NW m (bucketed to 22)


def graph_path(et, dev, card, bA, ref_p, host_refs):
    """The sixth path (the comment above): counts set to 0 just before it
    and read just after. A step's B7 executions are its graph's captured
    launches times its replays plus its eager runs' launches; each cell's
    route, captures, replays, blocking reads and B7 executions are printed
    and held to their predictions. Returns (kernel executions of the path,
    {cell: callable} for phase 5)."""
    import collections
    import dataclasses

    import torch
    from exponentialutilities_jl_torch.models.timestepping import _bucket_m
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.utils import graphs

    opA = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    B4 = torch.stack([bA, 0.1 * bA], dim=1)
    opE, uE = allen_cahn(et, NE, dev)
    opR, uR = allen_cahn(et, NR, dev)

    def f4(u):              # the fifth path's config #4 exprb43_device f
        return opA.matvec(u) - u ** 3

    def fR(u):
        return opR.matvec(u) + u - u ** 3

    def N(u):
        return u - u ** 3

    c4 = "config4 "
    cells = {
        c4 + f"phiv_timestep_device m={GRAPH_M0}": (
            lambda: et.phiv_timestep_device([TA], opA, B4, tol=1e-7,
                                            m=GRAPH_M0, return_stats=True),
            "nw"),
        c4 + "kiops_device": (
            lambda: et.kiops_device([TA], opA, B4, tol=1e-7), "kiops"),
        c4 + "exprb43_device": (
            lambda: et.exprb43_device(f4, 0.1 * bA, (0.0, TA),
                                      adaptive=True, m=12, rtol=1e-6,
                                      atol=1e-9, return_stats=True),
            "loop"),
        f"etdrk4_device {NE}^2 m={M_AC}": (
            lambda: (et.etdrk4_device(opE, N, uE, (0.0, E_STEPS * H_AC),
                                      H_AC, m=M_AC), None), "scan"),
        f"exprb43_device {NR}^2 adaptive m={M_R}": (
            lambda: et.exprb43_device(fR, uR, (0.0, TR), rtol=1e-5,
                                      atol=1e-7, m=M_R, return_stats=True),
            "loop"),
    }
    total = collections.Counter()
    out = {}
    for name, (fn, kind) in cells.items():
        _build.reset_launch_counts()
        graphs.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wg, sg = fn()
        torch.cuda.synchronize()
        ms_g = (time.perf_counter() - t0) * 1e3
        cnt = dict(graphs.counts)
        ex = dict(graphs.executions)
        steps = dict(graphs.step_launches)
        exe = graphs.kernel_executions(dict(_build.launches))
        total.update(exe)
        graphs.reset_counts()
        t0 = time.perf_counter()
        with graphs.eager():
            we, se = fn()
        torch.cuda.synchronize()
        ms_e = (time.perf_counter() - t0) * 1e3
        check(not graphs.counts["captures"] and not graphs.counts["replays"],
              f"{name}: the eager run captured {dict(graphs.counts)}")
        out[name] = wg
        # route and captures: a step is captured at its second execution
        route = "graph" if cnt.get("replays", 0) else "eager"
        want_cap = sum(1 for v in ex.values() if v >= 2)
        loops = cnt.get("loops", 0)
        reads = cnt.get("blocking_reads", 0)
        check(route == "graph", f"{name}: route {route} {cnt}")
        check(cnt.get("captures", 0) == want_cap,
              f"{name}: {cnt.get('captures', 0)} captures, predicted "
              f"{want_cap} (one per step and bucket run twice or more)")
        check(reads <= max(loops - 1, 0) + 2,
              f"{name}: {reads} blocking reads, {loops} loops")
        # every graph holds exactly its eager step's kernel launches
        for (w, key, step, form), ln in steps.items():
            if form == "graph":
                check(ln == steps.get((w, key, step, "eager"), {}),
                      f"{name}: graph {key}/{step} launches {ln}, eager "
                      f"{steps.get((w, key, step, 'eager'))}")
        b7 = exe.get("banded_spmv", 0)
        if kind == "nw":
            p, m0 = 1, _bucket_m(GRAPH_M0, NA, 256)
            want_b7 = p + m0 + sum(v * (p + key) for (_, key, step), v
                                   in ex.items() if step == "sub")
            real = sg.matvecs + p + m0
        elif kind == "kiops":
            want_b7 = sum(v * key for (_, key, _), v in ex.items())
            real = sg.krylov_steps
        else:
            want_b7 = sum(v * steps.get((w, key, step, "eager"), {}).get(
                "banded_spmv", 0) for (w, key, step), v in ex.items())
            real = None
        check(b7 == want_b7, f"{name}: {b7} B7 executions, predicted "
              f"{want_b7} from the steps' executions")
        caps = {f"{key}/{step}": ln.get("banded_spmv", 0)
                for (_, key, step, form), ln in steps.items()
                if form == "graph"}
        e = rel_norm(wg.reshape(-1).cpu(), we.reshape(-1).cpu())
        check(bool(torch.isfinite(wg).all()) and e <= GRAPH_TOL,
              f"{name}: graph vs eager {e:.2e}")
        check(sg == se, f"{name}: graph stats {sg}, eager {se}")
        print(f"graph {name}: route {route}; {cnt.get('captures', 0)} "
              f"captures (predicted {want_cap}), {cnt.get('replays', 0)} "
              f"replays, {cnt.get('eager_steps', 0)} eager steps, {loops} "
              f"loops, {reads} blocking reads (at most {max(loops - 1, 0)} "
              f"bucket changes + 2), {cnt.get('flag_reads', 0)} flag reads "
              f"behind the device; steps {ex}", flush=True)
        print(f"graph {name}: B7 executions {b7} (= B7 captured per graph "
              f"{caps} x its replays + the eager steps' launches; predicted "
              f"{want_b7})" + ("" if real is None else
                               f", of which the stats imply {real} and "
                               f"{b7 - real} ran in masked steps")
              + f"; host launch counter {dict((k, v) for k, v in _build.launches.items() if v)}",
              flush=True)
        print(f"graph {name}: graph vs eager {e:.2e} (tol {GRAPH_TOL:g}), "
              f"stats {sg} equal; one call {ms_g:.1f} ms from graphs "
              f"(captures included), {ms_e:.1f} ms eager {card}",
              flush=True)
    # the errors against the oracles, at today's tolerances
    for name in (c4 + f"phiv_timestep_device m={GRAPH_M0}",
                 c4 + "kiops_device"):
        e = rel_norm(out[name].reshape(-1).cpu(), torch.as_tensor(ref_p))
        check(e <= MTOL_NONHERM, f"{name} vs the dense oracle {e:.2e}")
        print(f"check graph {name}: vs the dense oracle {e:.2e} (tol "
              f"{MTOL_NONHERM:g})", flush=True)
    for name, want, tol in (
            (f"etdrk4_device {NE}^2 m={M_AC}", host_refs["etdrk4"],
             MTOL_ETD),
            (f"exprb43_device {NR}^2 adaptive m={M_R}",
             host_refs["exprb43"], MTOL_EXPRB)):
        e = rel_norm(out[name].reshape(-1), want.reshape(-1))
        check(e <= tol, f"{name} vs its host driver {e:.2e}")
        print(f"check graph {name}: vs its host driver {e:.2e} (tol "
              f"{tol:g})", flush=True)
    del out
    timed = {name: fn for name, (fn, _) in cells.items()}
    return dict(total), timed


# The Krylov builders from CUDA graphs (phase 4's seventh path,
# ops/krylov.py): each builder call runs its m steps as one masked step,
# run once, captured at its second execution and replayed from then on,
# in a graph that lives for the call. Each cell runs from its graphs, then
# with the same steps eagerly (graphs.eager()); the two agree to GRAPH_TOL
# with equal m_used and stats, the graph form meets the cell's oracle at
# its limit (PERF.md 2), its kernel executions are held to the count its
# matvecs imply, and its captures and replays to one capture and m - 2
# graph launches a builder call of m >= 4 steps (step 0 runs before the
# runner, on the caller's stream: it decides whether autograd must see
# the call).
KG_REPS = 5             # CUDA-event median of each form, taken in turns


def krylov_graph_inputs(et, dev):
    """The seventh path's operators, vectors and references, made here for
    ``--krylov-graphs-only`` as main makes them (config #3's b and the
    batched columns from generators of their own)."""
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla
    import torch

    t0 = time.perf_counter()
    g = {"opA": et.advection_diffusion_1d(NA, peclet=10.0, device=dev)}
    bAnp = np.random.default_rng(SEED).standard_normal(NA)
    g["bA"] = torch.as_tensor(bAnp, device=dev)
    aug = np.zeros((NA + 1, NA + 1))
    aug[:NA, :NA] = TA * banded_csr(g["opA"]).toarray()
    aug[:NA, NA] = TA * 0.1 * bAnp
    F2 = sla.expm(aug)
    g["ref_e"] = F2[:NA, :NA] @ bAnp
    g["ref_p"] = g["ref_e"] + F2[:NA, NA]
    rngc = np.random.default_rng(SEED)
    A1np = rngc.standard_normal((100, 100)) / 10
    b1np = rngc.standard_normal(100)
    g["A1c"] = torch.as_tensor(A1np, device=dev)
    g["b1c"] = torch.as_tensor(b1np, device=dev)
    g["ref_1"] = sla.expm(A1np) @ b1np
    g["opP"] = et.poisson_2d(NP, NP, device=dev)
    g["bP"] = torch.as_tensor(np.random.default_rng(SEED + 19)
                              .standard_normal(NP * NP), device=dev)
    rng4 = np.random.default_rng(SEED + 3)
    A_sell = symmetrized(bench_sell_coo(NS, 8, 700, rng4), NS, rng4)
    g["opS"] = et.SellOperator.from_scipy(A_sell, rcm=True, is_hermitian=True,
                                          dtype=np.float64, device=dev)
    g["perm"] = torch.as_tensor(g["opS"].perm, device=dev).long()
    bSnp = rng4.standard_normal(NS)
    g["bS"] = torch.as_tensor(bSnp, device=dev)[g["perm"]]
    A_scat = symmetrized(scattered_coo(NS, rng4), NS)
    g["opSeg"] = et.SellOperator.from_scipy(A_scat, mode="seg",
                                            is_hermitian=True,
                                            dtype=np.float64, device=dev)
    g["bC"] = torch.as_tensor(rng4.standard_normal(NS), device=dev)
    symmetrized(bench_sell_coo(NP * NP, 2, 700, rng4), NP * NP)
    rng4.standard_normal(NP * NP)           # main's hybrid b: same bB below
    g["opB3"] = et.blockell_from_scipy(laplacian_3d_csr(NB), 8,
                                       is_hermitian=True, dtype=np.float64,
                                       device=dev)
    g["bB"] = torch.as_tensor(rng4.standard_normal(NB ** 3), device=dev)
    g["ref_s"] = torch.as_tensor(spla.expm_multiply(TS * A_sell, bSnp),
                                 device=dev)
    g["ref_c"] = torch.as_tensor(spla.expm_multiply(
        TS * A_scat, g["bC"].cpu().numpy()), device=dev)
    g["w_stencil"] = et.expv(T3, et.laplacian_nd_stencil(NB, NB, NB,
                                                         device=dev),
                             g["bB"], m=20, two_pass=True)
    torch.cuda.synchronize()
    print(f"krylov-graphs-only inputs and references: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return g


def replay_twin_checks(et, dev, g):
    """B7, B8, B9 and B9 + B10 captured into a CUDA graph at the seventh
    path's shapes: each of 4 replays reads the x it was captured with
    (refilled between replays) and is held to the plain twin (KTOL)."""
    import torch
    from exponentialutilities_jl_torch.ops.kernels import sell as ts
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    from exponentialutilities_jl_torch.utils import graphs

    opA, opP, opB3, opS, opSeg = (g[k] for k in ("opA", "opP", "opB3", "opS",
                                                 "opSeg"))
    twins = {
        "config4 banded_spmv": (opA, lambda x: tsp.banded_spmv_ref(
            opA.diags, opA.offsets, x)),
        "config3 banded_spmv": (opP, lambda x: tsp.banded_spmv_ref(
            opP.diags, opP.offsets, x)),
        f"blockell {NB}^3 blockell_spmv": (
            opB3, lambda x: tsp.blockell_spmv_ref(opB3.blocks, opB3.bcols,
                                                  x)),
        "sell n=1e6 sell_spmv": (opS, lambda x: ts.sell_spmv_ref(opS.data,
                                                                 x)),
        "seg n=1e6 sell_spmv + seg_compact": (
            opSeg, lambda x: ts.sell_spmv_seg_ref(opSeg.data, x)),
    }
    gen = np.random.default_rng(SEED + 20)
    for label, (op, twin) in twins.items():
        n = op.shape[0]
        x = torch.empty(n, dtype=torch.float64, device=dev)
        y = torch.empty_like(x)

        def step():
            y.copy_(op.matvec(x))

        worst = 0.0
        with graphs.LoopRunner(f"replay twin {label}", dev) as runner:
            for _ in range(4):
                x.copy_(torch.as_tensor(gen.standard_normal(n), device=dev))
                runner.repeat(0, "matvec", step, 1)
                want = twin(x)
                e = float((y - want).abs().max())
                worst = max(worst, e)
                check(e <= KTOL["float64"] * float(want.abs().max()),
                      f"{label} in a graph replay vs its twin {e:.2e}")
            check(len(runner.graphs) == 1, f"{label}: no graph captured")
        print(f"check replay {label}: 3 graph replays and the warm-up vs "
              f"the plain twin, max abs err {worst:.2e} (tol "
              f"{KTOL['float64']:g} of the max)", flush=True)


def krylov_graph_path(et, dev, card, g):
    """The seventh path (the comment above): counts set to 0 just before
    each cell and read just after. Returns (kernel executions of the path,
    {cell: callable})."""
    import collections
    import math

    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.utils import graphs

    replay_twin_checks(et, dev, g)
    opA, bA, opP, bP = g["opA"], g["bA"], g["opP"], g["bP"]
    B4 = torch.stack([bA, 0.1 * bA], dim=1)
    BB = torch.as_tensor(np.random.default_rng(SEED + 22).standard_normal(
        (NBATCH3, NP * NP)), device=dev)
    perm = g["perm"]

    def rcm_back(wp):
        w = torch.empty_like(wp)
        w[perm] = wp
        return w

    def phi_identity(op, W, b, t):
        return max(float((t * op.matvec(W[:, j + 1])
                          - (W[:, j] - b / math.factorial(j))).norm()
                         / W[:, j].norm()) for j in range(W.shape[1] - 1))

    ref_e, ref_p = (torch.as_tensor(g[k], device=dev)
                    for k in ("ref_e", "ref_p"))
    ref_1 = torch.as_tensor(g["ref_1"], device=dev)
    M4 = MA
    # name: (call, the result compared graph vs eager, oracle checks
    #        [(what, err, tol)], kernel executions implied, builder calls
    #        with their step counts (None: from the stats))
    cells = {
        f"config4 expv m={M4}": (
            lambda: et.expv(TA, opA, bA, m=M4), lambda r: r,
            lambda r: [("vs the dense oracle", rel_norm(r, ref_e),
                        MTOL_NONHERM)],
            lambda r: {"banded_spmv": M4}, [M4]),
        f"config4 phiv k=1 m={M4}": (
            lambda: et.phiv(TA, opA, bA, 1, m=M4, errest=True),
            lambda r: r[0],
            lambda r: [("phi_0 b + t phi_1 (0.1 b) vs the dense oracle",
                        rel_norm(r[0][:, 0] + TA * 0.1 * r[0][:, 1], ref_p),
                        MTOL_NONHERM)],
            lambda r: {"banded_spmv": M4}, [M4]),
        f"config4 two-pass iop=2 m={M4}": (
            lambda: et.expv(TA, opA, bA, m=M4, iop=2, two_pass=True),
            lambda r: r,
            lambda r: [("vs the dense oracle", rel_norm(r, ref_e),
                        MTOL_NONHERM)],
            lambda r: {"banded_spmv": 2 * M4}, [M4, M4]),
        "config4 kiops": (
            lambda: et.kiops([TA], opA, B4, tol=1e-7), lambda r: r[0],
            lambda r: [("vs the dense oracle", rel_norm(r[0].reshape(-1),
                                                        ref_p),
                        MTOL_NONHERM)],
            lambda r: {"banded_spmv": r[1].krylov_steps}, None),
        "config4 phiv_timestep m=20": (
            lambda: et.phiv_timestep([TA], opA, B4, adaptive=True, tol=1e-7,
                                     m=20, return_stats=True),
            lambda r: r[0],
            lambda r: [("vs the dense oracle", rel_norm(r[0].reshape(-1),
                                                        ref_p),
                        MTOL_NONHERM)],
            lambda r: {"banded_spmv": r[1].matvecs}, None),
        "config3 phiv k=3 m=30": (
            lambda: et.phiv(TP, opP, bP, K, m=30), lambda r: r,
            lambda r: [("phi identities", phi_identity(opP, r, bP, TP),
                        MTOL_PHI)],
            lambda r: {"banded_spmv": 30}, [30]),
        # one batched build: one builder call of 30 steps for the rows
        f"config3 expv_batched {NBATCH3} columns m=30": (
            lambda: et.expv_batched(TP, opP, BB, m=30), lambda r: r,
            lambda r: [("each column vs its scalar expv",
                        max(rel_norm(r[i], et.expv(TP, opP, BB[i], m=30))
                            for i in range(NBATCH3)), MTOL_ROWS)],
            lambda r: {"banded_spmm_alpha": 30, "lanczos_update": 30,
                       "tridiag_exp_batched": 1}, [30]),
        "config1 expv m=40": (
            lambda: et.expv(1.0, g["A1c"], g["b1c"], m=40), lambda r: r,
            lambda r: [("vs scipy expm(A) b", rel_norm(r, ref_1),
                        MTOL_NONHERM)],
            lambda r: {}, [40]),
        "sell expv m=40": (
            lambda: et.expv(TS, g["opS"], g["bS"], m=40), lambda r: r,
            lambda r: [("vs scipy expm_multiply", rel_norm(rcm_back(r),
                                                           g["ref_s"]),
                        MTOL_SPARSE)],
            lambda r: {"sell_spmv": 40, "tridiag_exp": 1}, [40]),
        "scattered seg expv m=40": (
            lambda: et.expv(TS, g["opSeg"], g["bC"], m=40), lambda r: r,
            lambda r: [("vs scipy expm_multiply", rel_norm(r, g["ref_c"]),
                        MTOL_SPARSE)],
            lambda r: {"sell_spmv": 40, "seg_compact": 40,
                       "tridiag_exp": 1}, [40]),
        f"blockell {NB}^3 two-pass m=20": (
            lambda: et.expv(T3, g["opB3"], g["bB"], m=20, two_pass=True),
            lambda r: r,
            lambda r: [("(B8) vs the stencil two-pass (B3)",
                        rel_norm(r, g["w_stencil"]), MTOL_SPARSE)],
            lambda r: {"blockell_spmv": 40, "tridiag_exp": 1}, [20, 20]),
    }
    total = collections.Counter()

    def timed(fn, eager_form):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        if eager_form:
            with graphs.eager():
                fn()
        else:
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    for name, (fn, arr, oracle, implied, steps) in cells.items():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        rg = fn()
        torch.cuda.synchronize()
        cnt = dict(graphs.counts)
        host = {k: v for k, v in _build.launches.items() if v}
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        ex = dict(graphs.executions)
        total.update(exe)
        graphs.reset_counts()
        with graphs.eager():
            re_ = fn()
        torch.cuda.synchronize()
        ce = dict(graphs.counts)
        check(not ce.get("captures") and not ce.get("replays"),
              f"{name}: the eager run captured {ce}")
        # the graph form's oracle, at the path's limit
        for what, e, tol in oracle(rg):
            check(e <= tol, f"{name} {what} {e:.2e}")
            print(f"check krylov-graph {name}: {what} {e:.2e} (tol {tol:g})",
                  flush=True)
        # graph vs eager, and the same m_used / stats
        wg, we = arr(rg), arr(re_)
        e = rel_norm(wg.reshape(-1), we.reshape(-1))
        check(bool(torch.isfinite(wg).all()) and e <= GRAPH_TOL,
              f"{name}: graph vs eager {e:.2e}")
        sg = rg[1] if isinstance(rg, tuple) else None
        se = re_[1] if isinstance(re_, tuple) else None
        if sg is not None and not torch.is_tensor(sg):
            check(sg == se, f"{name}: graph stats {sg}, eager {se}")
        # kernel executions from the matvecs; captures and replays from the
        # builder calls: step 0 before the runner, then m >= 4 steps one
        # eager step, one capture and m - 2 graph launches, m <= 3 eager
        want = implied(rg)
        check(exe == want, f"{name}: kernel executions {exe}, implied {want}")
        nsteps = sum(ex.values())
        if steps is None:
            check(cnt.get("replays", 0) + cnt.get("eager_steps", 0) == nsteps
                  and cnt.get("captures", 0) >= 1,
                  f"{name}: {cnt}, {nsteps} builder steps")
        else:
            want_c = {"captures": sum(m_ >= 4 for m_ in steps),
                      "replays": sum(m_ - 2 for m_ in steps if m_ >= 4),
                      "eager_steps": sum(1 if m_ >= 4 else m_ - 1
                                         for m_ in steps)}
            check({k: cnt.get(k, 0) for k in want_c} == want_c,
                  f"{name}: {cnt}, predicted {want_c}")
        check(not cnt.get("blocking_reads") and not cnt.get("loops"),
              f"{name}: a builder read the device {cnt}")
        # wall ms of both forms in turns, after one warm-up each
        timed(fn, False)
        timed(fn, True)
        tg, te = [], []
        for _ in range(KG_REPS):
            tg.append(timed(fn, False))
            te.append(timed(fn, True))
        ms_g, ms_e = statistics.median(tg), statistics.median(te)
        print(f"krylov-graph {name}: {cnt.get('captures', 0)} captures, "
              f"{cnt.get('replays', 0)} replays, {cnt.get('eager_steps', 0)} "
              f"eager steps over {nsteps} builder steps in "
              f"{len(ex)} (builder, m) keys; kernel executions {exe} "
              f"(host launches {host}); graph vs eager {e:.2e} (tol "
              f"{GRAPH_TOL:g})" + (f", stats {sg} equal" if sg is not None
                                   and not torch.is_tensor(sg) else ""),
              flush=True)
        print(f"time krylov-graph {name}: graph {ms_g:.3f} ms, "
              f"eager {ms_e:.3f} ms (CUDA events, median of "
              f"{KG_REPS} in turns; the graph form's captures included) "
              f"{card}", flush=True)
    return dict(total), {name: c[0] for name, c in cells.items()}


def krylov_graph_profile(calls, card, label="krylov-graph",
                         forms=("graph", "eager")):
    """torch.profiler over one warm call of each seventh-path cell in each
    of ``forms``: wall (host clock, profiled), device busy (the union of
    the device intervals), device ops, and the host's launch calls (runtime
    and driver API events named *Launch*: kernel launches and graph
    launches)."""
    import collections
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_
    from exponentialutilities_jl_torch.utils import graphs

    for name, fn in calls.items():
        for form in forms:
            ctx = (graphs.eager() if form == "eager"
                   else contextlib.nullcontext())
            with ctx:
                fn()
                torch.cuda.synchronize()
                with prof_(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
                    s = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - s) * 1e3
            evs = prof.events()
            dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA]
            busy, end = 0.0, -math.inf
            for a, b in sorted((e.time_range.start, e.time_range.end)
                               for e in dev_evs):
                if b > end:
                    busy += b - max(a, end)
                    end = b
            host = [e for e in evs if e.device_type == DeviceType.CPU]
            launches = collections.Counter(e.name for e in host
                                           if "Launch" in e.name)
            mallocs = [e for e in host if e.name == "cudaMalloc"]
            print(f"profile {label} {name} {form}: wall {wall:.3f} ms "
                  f"(host clock, profiled); device busy {busy / 1e3:.3f} ms "
                  f"in {len(dev_evs)} device ops; host launch calls "
                  f"{sum(launches.values())} {dict(launches)}; {len(mallocs)} "
                  f"cudaMalloc calls, "
                  f"{sum(e.cpu_time_total for e in mallocs) / 1e3:.3f} ms "
                  f"{card}", flush=True)


def krylov_graphs_only(et, dev, card, profile: bool) -> int:
    """``--krylov-graphs-only``: the seventh path with its inputs and
    references made here, then, with ``--profile``, torch.profiler over
    its cells."""
    g = krylov_graph_inputs(et, dev)
    counts, calls = krylov_graph_path(et, dev, card, g)
    print(f"kernel executions of the krylov graph path: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if profile:
        krylov_graph_profile(calls, card)
    return 0


def graphs_only(et, dev, card, profile: bool) -> int:
    """``--graphs-only``: the sixth path with its references made here
    (config #4's dense oracle, the host etdrk4 and exprb43), then, with
    ``--profile``, torch.profiler over its cells."""
    import scipy.linalg as sla
    import torch

    t0 = time.perf_counter()
    opA = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    bAnp = np.random.default_rng(SEED).standard_normal(NA)
    bA = torch.as_tensor(bAnp, device=dev)
    aug = np.zeros((NA + 1, NA + 1))
    aug[:NA, :NA] = TA * banded_csr(opA).toarray()
    aug[:NA, NA] = TA * 0.1 * bAnp
    F2 = sla.expm(aug)
    ref_p = F2[:NA, :NA] @ bAnp + F2[:NA, NA]
    opE, uE = allen_cahn(et, NE, dev)
    opR, uR = allen_cahn(et, NR, dev)
    host_refs = {
        "etdrk4": et.etdrk4(opE, lambda u: u - u ** 3, uE,
                            (0.0, E_STEPS * H_AC), H_AC, m=M_AC)[0],
        "exprb43": et.exprb43(lambda u: opR.matvec(u) + u - u ** 3, uR,
                              (0.0, TR), rtol=1e-5, atol=1e-7)[0]}
    print(f"graphs-only references: {time.perf_counter() - t0:.1f} s",
          flush=True)
    counts, calls = graph_path(et, dev, card, bA, ref_p, host_refs)
    print(f"kernel executions of the graph path: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_

        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                s = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - s) * 1e3
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            busy, end = 0.0, -math.inf
            for a, b in sorted((e.time_range.start, e.time_range.end)
                               for e in evs):
                if b > end:
                    busy += b - max(a, end)
                    end = b
            print(f"profile graph {name}: wall {wall:.3f} ms (host clock, "
                  f"profiled); device busy {busy / 1e3:.3f} ms in "
                  f"{len(evs)} device ops {card}", flush=True)
    return 0


# R1 (ops/kernels/tridiag.py) against its eigh twin, phase 3: random
# real symmetric tridiagonals of norm ~4 (t |T| ~ 4), real and complex t,
# with and without s, float32 and float64; the orders the Krylov paths use
# (m = 1 and 2 at the edges, 20-60 the main paths', 250 config #4's m;
# 400 takes the kernel's global-scratch form), and a breakdown at j = 3
# (the masked zero tail of a Lanczos record),
# whose tail must come out exactly 0, at R1_TOL of the largest entry.
# Then the inputs a divide and conquer gets wrong first
# (tests/tridiag_cases.py: Wilkinson W+ 21 and 201, glued Wilkinson
# blocks, a graded diagonal 1e-12 .. 1e2, a constant tridiagonal, the
# Lanczos tridiagonal of a 1-D Laplacian with ghost eigenvalues at m =
# 250, t |T| up to 1e3 with negative and complex t, the error-estimate
# loop's zero tails), each at R1_TOL x max(1, |t| ||T||_1), the
# conditioning of exp(tT) e1
R1_ORDERS = (1, 2, 20, 40, 60, 250, 400)
R1_TOL = {"float32": 1e-5, "float64": 1e-13}
R1_TIMED = (30, 40, 250)      # R1's times at these orders (40: the line)


def r1_inputs(m, dt, dev, seed, tail=0):
    import torch

    g = np.random.default_rng(seed)
    a = -np.abs(g.standard_normal(m)) * 2
    b = np.abs(g.standard_normal(max(m - 1, 0)))
    if tail:
        a[m - tail:] = 0.0
        b[m - tail - 1:] = 0.0
    return (torch.as_tensor(a, dtype=dt, device=dev),
            torch.as_tensor(b, dtype=dt, device=dev))


def tridiag_checks(et, dev):
    """R1 against its twin (the comment above); returns the largest
    absolute float64 error."""
    import torch
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    worst = {}
    for dt, cdt, dn in ((torch.float32, torch.complex64, "float32"),
                        (torch.float64, torch.complex128, "float64")):
        cases = [(m, 0) for m in R1_ORDERS] + [(40, 37)]
        for m, tail in cases:
            a, b = r1_inputs(m, dt, dev, SEED + 30 + m, tail)
            s = torch.tensor(1.7, dtype=dt, device=dev)
            for t in (torch.tensor(0.6, dtype=dt, device=dev),
                      torch.tensor(0.6 - 0.8j, dtype=cdt, device=dev)):
                for sc in (None, s):
                    got = tt.tridiag_exp_e1(a, b, t, sc)
                    want = tt.tridiag_exp_e1_ref(a, b, t, sc)
                    torch.cuda.synchronize()
                    e = float((got - want).abs().max())
                    scale = float(want.abs().max())
                    check(got.dtype == want.dtype and e <= R1_TOL[dn] * scale,
                          f"R1 {dn} m={m} tail={tail} t={complex(t)} "
                          f"s={sc is not None}: {e:.2e} of {scale:.2e}")
                    if tail:
                        check(not bool(got[m - tail:].abs().max()),
                              f"R1 {dn} m={m}: the masked tail is not 0")
                    check(torch.equal(got, tt.tridiag_exp_e1(a, b, t, sc)),
                          f"R1 {dn} m={m}: not bitwise repeatable")
                    worst[dn] = max(worst.get(dn, 0.0), e)
        print(f"check R1 tridiag_exp {dn}: m = {R1_ORDERS} and a breakdown "
              f"at j = 3 (m = 40), real and complex t, with and without s: "
              f"max abs err {worst[dn]:.2e} (tol {R1_TOL[dn]:g} of the max; "
              "bitwise repeatable; the masked tail exactly 0)", flush=True)
        hard = r1_hard_checks(dt, cdt, dn, dev)
        print(f"check R1 tridiag_exp {dn} hard inputs: {len(hard)} cases, "
              f"with and without s, largest error / tolerance "
              f"{max(hard.values()):.2e} ({max(hard, key=hard.get)}; "
              "bitwise repeatable; masked tails exactly 0)", flush=True)
    return worst["float64"]


def r1_hard_checks(dt, cdt, dn, dev):
    """R1 against its twin on tests/tridiag_cases.py's hard inputs (the
    comment above R1_ORDERS); returns {case: error / its tolerance}."""
    import os

    import torch
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from tridiag_cases import case_tol, hard_cases

    out = {}
    s = torch.tensor(1.7, dtype=dt, device=dev)
    for name, a, b, t in hard_cases():
        at = torch.as_tensor(a, dtype=dt, device=dev)
        bt = torch.as_tensor(b, dtype=dt, device=dev)
        tq = torch.tensor(t, dtype=cdt if isinstance(t, complex) else dt,
                          device=dev)
        tol = case_tol(a, b, t, dn)
        zero = np.flatnonzero(np.asarray(b) == 0)
        for sc in (None, s):
            got = tt.tridiag_exp_e1(at, bt, tq, sc)
            want = tt.tridiag_exp_e1_ref(at, bt, tq, sc)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(got.dtype == want.dtype and e <= tol * scale,
                  f"R1 {dn} {name} s={sc is not None}: {e:.2e} of "
                  f"{scale:.2e} (tol {tol:.1e})")
            check(torch.equal(got, tt.tridiag_exp_e1(at, bt, tq, sc)),
                  f"R1 {dn} {name}: not bitwise repeatable")
            if zero.size:
                check(not bool(got[zero[0] + 1:].abs().max()),
                      f"R1 {dn} {name}: the masked tail is not 0")
            out[name] = max(out.get(name, 0.0), e / (tol * scale))
    return out


def r1_work(m):
    """(bytes, operations) of R1 at order m in float64: the diagonals, t
    and s in, m values out; the divide and conquer's merges on an input
    that deflates nothing (the random inputs timed here), with one
    evaluation of each secular function: ~25 operations for each pair of
    a node's k rows (the secular terms 6, the Loewner factors 5, the
    column norms and the two rows carried up 9, the way down 5), the
    least this design does there."""
    ops, todo = 0, [(0, m)]
    while todo:
        lo, hi = todo.pop()
        if hi - lo >= 2:
            ops += 25 * (hi - lo) ** 2
            mid = lo + (hi - lo) // 2
            todo += [(lo, mid), (mid, hi)]
    return ((3 * m + 1) * 8, ops)


# The serving closures and the error-estimate loop (phase 4's eighth path,
# utils/graphs.Program): make_expv and make_phiv on config #3 (phiv k = 3,
# m = 30, B7, Hermitian), config #4 (expv and phiv k = 1 at m = 250, B7,
# Arnoldi), config #1 (expv m = 40, dense) and the n = 1e6 SELL matrix
# (expv m = 40, B9, Hermitian: R1); calls 1-12 of each with a fresh b:
# call 1 eager, call 2 captured, calls 3-12 replayed under sync debug mode
# "error" (no blocking read), every result bit-equal to the same call of
# the closure under graphs.eager() and held to the cell's oracle, its
# kernel executions to the count its matvecs imply. Then
# expv(mode="error_estimate", m = 60, atol = rtol = 1e-12) on config #3
# and the SELL matrix: one capture, one blocking read (the one that ends
# the loop), the CPU's iteration count and w.
SERVE_CALLS = 12
SERVE_REPS = 10


def serving_inputs(et, dev):
    """The eighth path's operators and references, made here for
    ``--serving-only`` as main makes them."""
    import scipy.sparse.linalg as spla
    import torch

    t0 = time.perf_counter()
    s = {"opA": et.advection_diffusion_1d(NA, peclet=10.0, device=dev)}
    rngc = np.random.default_rng(SEED)
    s["A1np"] = rngc.standard_normal((100, 100)) / 10
    s["A1c"] = torch.as_tensor(s["A1np"], device=dev)
    s["opP"] = et.poisson_2d(NP, NP, device=dev)
    rng4 = np.random.default_rng(SEED + 3)
    s["A_sell"] = symmetrized(bench_sell_coo(NS, 8, 700, rng4), NS, rng4)
    s["opS"] = et.SellOperator.from_scipy(s["A_sell"], rcm=True,
                                          is_hermitian=True,
                                          dtype=np.float64, device=dev)
    s["perm"] = torch.as_tensor(s["opS"].perm, device=dev).long()
    bSnp = rng4.standard_normal(NS)
    s["bS"] = torch.as_tensor(bSnp, device=dev)[s["perm"]]
    s["ref_s"] = torch.as_tensor(spla.expm_multiply(TS * s["A_sell"], bSnp),
                                 device=dev)
    torch.cuda.synchronize()
    print(f"serving-only inputs and references: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return s


def serving_stale_check(et, dev, s):
    """A serving closure follows its operator's storage (utils/graphs.py,
    "Stale storage"): make_expv(m=30) on a copy of config #3's operator,
    calls 1-3 (eager, capture, replay), then its diagonals scaled by 1.5
    in place or reassigned: call 4 drops the graph and runs eagerly (one
    recapture), call 5 is captured anew, call 6 replays with no blocking
    read. exp(t 1.5 A) b = exp(1.5 t A) b, so calls 4-6 equal, bit for bit
    among themselves, an eager closure's call at 1.5 t made before the
    change (to the Krylov rounding, 1e-12)."""
    import torch
    from exponentialutilities_jl_torch.utils import graphs

    gen = np.random.default_rng(SEED + 41)
    b = torch.as_tensor(gen.standard_normal(NP * NP), device=dev)
    for how in ("in place", "reassign"):
        op = et.BandedOperator(s["opP"].diags.clone(), s["opP"].offsets,
                               is_hermitian=True)
        with graphs.eager():          # another closure: fn's call 1 below
            want = et.make_expv(op, m=30)(1.5 * TP, b)   # is its warm-up
        fn = et.make_expv(op, m=30)
        graphs.reset_counts()
        for _ in range(3):
            fn(TP, b)
        if how == "in place":
            op.diags.mul_(1.5)
        else:
            op.diags = op.diags * 1.5
        got = [fn(TP, b), fn(TP, b)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got.append(fn(TP, b))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cnt = {k: graphs.counts.get(k, 0) for k in
               ("eager_steps", "captures", "replays", "recaptures")}
        want_c = {"eager_steps": 2, "captures": 2, "replays": 2,
                  "recaptures": 1}
        check(cnt == want_c, f"stale {how}: counts {cnt}, expected {want_c}")
        check(torch.equal(got[0], got[1]) and torch.equal(got[0], got[2]),
              f"stale {how}: calls 4-6 differ")
        e = rel_norm(got[0], want)
        check(e <= 1e-12, f"stale {how}: {e:.2e} from exp(1.5 t A) b")
        fn.close()
        print(f"check serving stale storage ({how}, config3 make_expv "
              f"m=30): counts {cnt}; calls 4-6 bit-equal; {e:.2e} from "
              f"the eager exp(1.5 t A) b of before the change (tol 1e-12)",
              flush=True)


def serving_path(et, dev, card, s):
    """The eighth path (the comment above). Returns (kernel executions of
    the path, {cell: (closure, t, b)} for the profile)."""
    import collections
    import math

    import scipy.linalg as sla
    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.utils import graphs

    t0 = time.perf_counter()
    opA, opP, opS, A1c, perm = (s[k] for k in ("opA", "opP", "opS", "A1c",
                                               "perm"))
    # config #4's exp(tA) and phi_1(tA) from one block exponential
    # expm([[tA, I], [0, 0]]) = [[e^{tA}, phi_1(tA)], [0, I]]
    big = np.zeros((2 * NA, 2 * NA))
    big[:NA, :NA] = TA * banded_csr(opA).toarray()
    big[:NA, NA:] = np.eye(NA)
    F = torch.as_tensor(sla.expm(big), device=dev)
    E4, P4 = F[:NA, :NA].contiguous(), F[:NA, NA:].contiguous()
    del big, F
    E1 = torch.as_tensor(sla.expm(s["A1np"]), device=dev)
    print(f"serving path references: {time.perf_counter() - t0:.1f} s",
          flush=True)

    def phi_identity(op, W, b, t):
        return max(float((t * op.matvec(W[:, j + 1])
                          - (W[:, j] - b / math.factorial(j))).norm()
                         / W[:, j].norm()) for j in range(W.shape[1] - 1))

    gen = np.random.default_rng(SEED + 40)

    def fresh(n, first=None):
        bs = [first] if first is not None else []
        while len(bs) < SERVE_CALLS:
            bs.append(torch.as_tensor(gen.standard_normal(n), device=dev))
        return bs

    # name: (closure, t, the b of calls 1-12, the same call through the
    #        entry point, oracle(i, b, result) -> [(what, err, tol)],
    #        kernel executions of the 12 calls)
    cells = {
        f"config3 make_phiv k={K} m=30": (
            et.make_phiv(opP, K, m=30), TP, fresh(NP * NP),
            lambda b: et.phiv(TP, opP, b, K, m=30, errest=True),
            lambda i, b, r: [("phi identities", phi_identity(opP, r[0], b,
                                                             TP), MTOL_PHI)],
            {"banded_spmv": 30 * SERVE_CALLS}),
        f"config4 make_expv m={MA}": (
            et.make_expv(opA, m=MA), TA, fresh(NA),
            lambda b: et.expv(TA, opA, b, m=MA),
            lambda i, b, r: [("vs the dense oracle", rel_norm(r, E4 @ b),
                              MTOL_NONHERM)],
            {"banded_spmv": MA * SERVE_CALLS}),
        f"config4 make_phiv k=1 m={MA}": (
            et.make_phiv(opA, 1, m=MA), TA, fresh(NA),
            lambda b: et.phiv(TA, opA, b, 1, m=MA, errest=True),
            lambda i, b, r: [
                ("phi_0 vs the dense oracle", rel_norm(r[0][:, 0], E4 @ b),
                 MTOL_NONHERM),
                ("phi_1 vs the dense oracle", rel_norm(r[0][:, 1], P4 @ b),
                 MTOL_NONHERM)],
            {"banded_spmv": MA * SERVE_CALLS}),
        "config1 make_expv m=40": (
            et.make_expv(A1c, m=40), 1.0, fresh(100),
            lambda b: et.expv(1.0, A1c, b, m=40),
            lambda i, b, r: [("vs scipy expm(A) b", rel_norm(r, E1 @ b),
                              MTOL_NONHERM)],
            {}),
        "sell n=1e6 make_expv m=40": (
            et.make_expv(opS, m=40), TS, fresh(NS, s["bS"]),
            lambda b: et.expv(TS, opS, b, m=40),
            lambda i, b, r: ([("vs scipy expm_multiply", rel_norm(
                r.index_select(0, torch.argsort(perm)), s["ref_s"]),
                MTOL_SPARSE)] if i == 0 else []),
            {"sell_spmv": 40 * SERVE_CALLS, "tridiag_exp": SERVE_CALLS}),
    }
    total = collections.Counter()

    def events(fn, eager_form=False):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        if eager_form:
            with graphs.eager():
                out = fn()
        else:
            out = fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z), out

    for name, (fn, t, bs, entry, oracle, want) in cells.items():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        outs, call_ms = [], []
        for i, b in enumerate(bs):
            if i >= 2:          # a replayed call: no blocking read
                torch.cuda.set_sync_debug_mode("error")
            try:
                ms, r = events(lambda b=b: fn(t, b))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            outs.append(r)
            call_ms.append(ms)
        cnt = dict(graphs.counts)
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        total.update(exe)
        want_c = {"eager_steps": 1, "captures": 1,
                  "replays": SERVE_CALLS - 2}
        check({k: cnt.get(k, 0) for k in want_c} == want_c
              and not cnt.get("blocking_reads") and not cnt.get("loops"),
              f"{name}: counts {cnt}, expected {want_c}")
        check(exe == want, f"{name}: kernel executions {exe}, implied {want}")
        first = [r[0] if isinstance(r, tuple) else r for r in outs]
        check(len({w.data_ptr() for w in first}) == SERVE_CALLS,
              f"{name}: two results alias")
        worst = {}
        bits = True
        for i, (b, r) in enumerate(zip(bs, outs)):
            w = first[i]
            check(bool(torch.isfinite(w).all()), f"{name} call {i + 1}: "
                  "non-finite")
            for what, e, tol in oracle(i, b, r):
                check(e <= tol, f"{name} call {i + 1} {what} {e:.2e}")
                worst[what] = (max(worst.get(what, (0.0, tol))[0], e), tol)
            with graphs.eager():
                re_ = fn(t, b)
            for x, y in zip(r if isinstance(r, tuple) else (r,),
                            re_ if isinstance(re_, tuple) else (re_,)):
                bits = bits and torch.equal(x, y)
            ent = entry(b)
            ent = ent[0] if isinstance(ent, tuple) else ent
            e = rel_norm(w.reshape(-1), ent.reshape(-1))
            check(e <= MTOL_IOP, f"{name} call {i + 1} vs the entry point "
                  f"{e:.2e}")
            worst["vs the entry point"] = (max(worst.get(
                "vs the entry point", (0.0, MTOL_IOP))[0], e), MTOL_IOP)
        check(bits, f"{name}: a replay differs from the eager closure")
        print(f"check serving {name}: calls 1-{SERVE_CALLS} with a fresh b "
              f"each: counts {want_c} (replayed calls under sync debug mode "
              f"'error', no blocking read); every result bit-equal to the "
              f"eager closure (graphs.eager()); no two results alias; "
              f"kernel executions {exe} (host launches "
              f"{ {k: v for k, v in _build.launches.items() if v} }); "
              + "; ".join(f"{w} max {e:.2e} (tol {tol:g})"
                          for w, (e, tol) in worst.items()), flush=True)
        # times: replayed calls, the entry point, the eager closure
        b = bs[-1]
        rep, ent, eag = [], [], []
        events(lambda: entry(b))
        events(lambda: fn(t, b), True)
        for _ in range(SERVE_REPS):
            rep.append(events(lambda: fn(t, b))[0])
            ent.append(events(lambda: entry(b))[0])
            eag.append(events(lambda: fn(t, b), True)[0])
        print(f"time serving {name}: replayed call "
              f"{statistics.median(rep):.3f} ms, through expv/phiv "
              f"{statistics.median(ent):.3f} ms, eager closure "
              f"{statistics.median(eag):.3f} ms (CUDA events, medians of "
              f"{SERVE_REPS} in turns); call 1 (eager warm-up) "
              f"{call_ms[0]:.3f} ms, call 2 (capture) {call_ms[1]:.3f} ms "
              f"{card}", flush=True)

    serving_stale_check(et, dev, s)

    # the error-estimate loop from a CUDA graph against the CPU's
    perm_c = s["perm"].cpu().numpy()
    Ap = s["A_sell"].tocsr()[perm_c][:, perm_c].tocsr()
    cpu_ops = {
        "config3": et.poisson_2d(NP, NP, device="cpu"),
        "sell n=1e6": et.MatrixFreeOperator(
            lambda x: torch.from_numpy(Ap @ x.numpy()), (NS, NS),
            is_hermitian=True, device="cpu")}
    xs = torch.as_tensor(gen.standard_normal(NS), device=dev)
    e = rel_norm(opS.matvec(xs).cpu(), cpu_ops["sell n=1e6"].matvec(xs.cpu()))
    check(e <= 1e-14, f"SELL pack vs the permuted CSR on the CPU {e:.2e}")
    for label, op, t in (("config3", opP, TP), ("sell n=1e6", opS, TS)):
        name = f"{label} expv error_estimate m=60"
        b = torch.as_tensor(gen.standard_normal(op.shape[0]), device=dev)
        kw = dict(m=60, mode="error_estimate", atol=1e-12, rtol=1e-12,
                  return_info=True)
        t1 = time.perf_counter()
        w_cpu, it_cpu = et.expv(t, cpu_ops[label], b.cpu(), **kw)
        cpu_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        ms, (w, it) = events(lambda: et.expv(t, op, b, **kw))
        cnt = dict(graphs.counts)
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        total.update(exe)
        key = "banded_spmv" if label == "config3" else "sell_spmv"
        # step 0 before the runner, it - 1 live steps, one masked step
        want = {key: it + 1, "tridiag_exp": it + 1}
        check(it == it_cpu and 1 < it < 60,
              f"{name}: {it} iterations, the CPU's {it_cpu}")
        check(cnt.get("captures") == 1 and cnt.get("blocking_reads") == 1
              and cnt.get("eager_steps", 0) + cnt.get("replays", 0) == it,
              f"{name}: counts {cnt}")
        check(exe == want, f"{name}: kernel executions {exe}, implied {want}")
        e = rel_norm(w.cpu(), w_cpu)
        check(e <= MTOL_SPARSE, f"{name} vs the CPU {e:.2e}")
        # the loop from its graphs against the same steps run eagerly
        # (graphs.eager(): a read of the flags one step behind, no capture),
        # in turns
        ems, eag = [], []
        for _ in range(SERVE_REPS):
            ems.append(events(lambda: et.expv(t, op, b, **kw))[0])
            eag.append(events(lambda: et.expv(t, op, b, **kw), True)[0])
        print(f"check serving {name}: {it} iterations, the CPU's {it_cpu} "
              f"({cpu_s:.1f} s there); counts {cnt} (the loop's one read "
              f"ends it); kernel executions {exe}; vs the CPU {e:.2e} (tol "
              f"{MTOL_SPARSE:g})", flush=True)
        print(f"time serving {name}: first call {ms:.3f} ms, then "
              f"{statistics.median(ems):.3f} ms (each call captures its "
              f"loop anew), under graphs.eager() "
              f"{statistics.median(eag):.3f} ms (CUDA events, medians of "
              f"{SERVE_REPS} in turns) {card}", flush=True)
    calls = {name: (c[0], c[1], c[2][-1]) for name, c in cells.items()}
    return dict(total), calls


def serving_profile(calls, card):
    """torch.profiler over one replayed call of each closure: device busy
    (the union of the device intervals), device ops and the host's launch
    calls (runtime and driver API events named *Launch*)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_

    for name, (fn, t, b) in calls.items():
        fn(t, b)
        torch.cuda.synchronize()
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            s = time.perf_counter()
            fn(t, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - s) * 1e3
        evs = prof.events()
        dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA]
        busy, end = 0.0, -math.inf
        for a, z in sorted((e.time_range.start, e.time_range.end)
                           for e in dev_evs):
            if z > end:
                busy += z - max(a, end)
                end = z
        launches = collections.Counter(
            e.name for e in evs
            if e.device_type == DeviceType.CPU and "Launch" in e.name)
        print(f"profile serving {name} replayed call: wall {wall:.3f} ms "
              f"(host clock, profiled); device busy {busy / 1e3:.3f} ms in "
              f"{len(dev_evs)} device ops; host launch calls "
              f"{sum(launches.values())} {dict(launches)} {card}",
              flush=True)


def r1_times(dev, card, median_ms, burst_ms):
    """R1 at the orders of R1_TIMED, float64, t real and s = beta0 as in
    the two-pass coefficients: one call and back to back, its twin, the
    library call (torch.linalg.eigh of the built tridiagonal and the
    combination) and the bound. Returns {m: (kernel ms, twin ms, library
    ms)}."""
    import torch
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt

    out = {}
    for m in R1_TIMED:
        a, b = r1_inputs(m, torch.float64, dev, SEED + 50 + m)
        t = torch.tensor(0.6, dtype=torch.float64, device=dev)
        s = torch.tensor(1.7, dtype=torch.float64, device=dev)
        T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)

        def kfn():
            return tt.tridiag_exp_e1(a, b, t, s)

        def pfn():
            return tt.tridiag_exp_e1_ref(a, b, t, s)

        def lfn():
            w, Q = torch.linalg.eigh(T)
            return Q @ (torch.exp(t * w) * Q[0]) * s

        p1, k1, k2, p2, l1 = (median_ms(f) for f in (pfn, kfn, kfn, pfn,
                                                     lfn))
        kb, lb = burst_ms(kfn), burst_ms(lfn)
        bms, bby = bound(*r1_work(m), "float64")
        out[m] = (statistics.median([k1, k2]), statistics.median([p1, p2]),
                  l1)
        print(f"time R1 tridiag_exp float64 m={m}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain (eigh twin) {p1:.4f} / {p2:.4f} ms, "
              f"torch.linalg.eigh + combination {l1:.4f} ms; back-to-back: "
              f"kernel {kb:.4f} ms, eigh + combination {lb:.4f} ms; bound "
              f"{bms:.6f} ms by {bby} {card}", flush=True)
    return out


def serving_only(et, dev, card, profile: bool) -> int:
    """``--serving-only``: R1 against its twin, the eighth path with its
    inputs made here, R1's times, then, with ``--profile``, one replayed
    call of each closure under torch.profiler."""
    import torch

    tridiag_checks(et, dev)
    s = serving_inputs(et, dev)
    counts, calls = serving_path(et, dev, card, s)
    print(f"kernel executions of the serving path: {counts}", flush=True)
    check(counts.get("tridiag_exp", 0) > 0, "R1 never ran on the serving "
          "path")

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

    def burst_ms(fn, k=20):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z) / k

    r1_times(dev, card, median_ms, burst_ms)
    if profile:
        serving_profile(calls, card)
    return 0


# ---- the ninth path: the fixed NW stepper and the fused passes from CUDA
# graphs ----
# make_phiv_timestep's fn(B) on config #4 (a graphs.Scan: call 1 runs its
# first substep eagerly, captures the second and replays it nsteps - 2
# times, calls 2+ replay it nsteps times), the same stepper through
# phiv_timestep_fused (a runner of its own: 1 eager, 1 capture, nsteps - 1
# replays a call), and the two-pass expv(m=20) on the fused
# sweeps (each pass one (sweep, stage) step in the device-index form, run
# m + 1 times: 1 eager, 1 capture, m replays) on the 2-D 512^2 Laplacian
# and on 216^3 with constant and variable coefficients. Each call's counts
# and kernel executions held exactly, its results bit-equal to the same
# call under graphs.eager() and held to an oracle, the replayed calls
# under sync debug mode "error"; B3 and B3-var in the device-index form
# against their twins and bit-equal to the host-index form; CUDA-event
# medians of FIXED_REPS beside the eager form.
FIXED_REPS = 5
FIXED_M = 20
FIXED_CUT = 40          # config #4's time over this: the cut fn(B) cell


def fixed_fused_inputs(et, dev):
    """The ninth path's operators, made here for ``--fixed-fused-only`` as
    main makes them."""
    t0 = time.perf_counter()
    aV = np.random.default_rng(SEED).uniform(0.5, 2.0, (N3, N3, N3))
    s = {"opA": et.advection_diffusion_1d(NA, peclet=10.0, device=dev),
         "opG": et.laplacian_nd_stencil(NG, NG, device=dev),
         "op3": et.laplacian_nd_stencil(N3, N3, N3, device=dev),
         "opV": et.variable_diffusion_nd_stencil(aV, device=dev)}
    print(f"fixed-fused-only inputs: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return s


def ring_form_checks(et, dev, op, label, gen):
    """B3 (or B3-var) in the device-index form at steps s = 0, 1, 2, 6, 7
    of a random ring and state (m = 6: s = 6 the last stage, s = 7 past
    the end), against the twins (KTOL) and bit for bit
    against the host-index form (the same kernels told s and its
    pointers); then a whole pass 1 from its graph against the twins' pass
    on the same card. Returns the largest absolute error against the
    twins (the kernels line's max_abs_err)."""
    import ctypes

    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf

    f64 = torch.float64
    n = op.shape[0]
    dev = op.device             # the plan's key: the vectors' device
    plan = tf._plan(op, f64, dev)
    cvals = tf._cvals(op, f64)
    base = [torch.as_tensor(gen.standard_normal(n), device=dev)
            for _ in range(7)]
    base[1].zero_()
    Wb = torch.as_tensor(gen.standard_normal(n), device=dev)
    cf = torch.as_tensor(gen.standard_normal(6), device=dev)
    worst, worst_abs = 0.0, 0.0
    for s in (0, 1, 2, 6, 7):
        runs = []
        for form in ("device", "host", "twin"):
            ring = [v.clone() for v in base]
            W = Wb.clone()
            st = torch.zeros(tf._ST_LEN, dtype=f64, device=dev)
            for k, v in ((0, 0.3), (1, -0.7), (2, 0.2), (3, 0.45), (4, 1.3),
                         (7, 1.0), (8, float(s))):
                st[k].fill_(v)
            al = torch.zeros(6, dtype=f64, device=dev)
            be = torch.zeros(6, dtype=f64, device=dev)
            stream = _build.raw_stream(dev)
            if form == "device":
                ptrs = (ctypes.c_void_p * 7)(*(v.data_ptr() for v in ring))
                plan.sweep_ring(ptrs, st, cvals, W, stream)
                plan.stage(stream, state=st, alphas=al, betas=be, coeffs=cf,
                           j=None, m=6, tol=1e-7)
            elif form == "host":
                Z, Vc, Vp, Y, Zn = tf.ring_slots(ring, s)
                plan.sweep(Z, Vc, Vp, st.data_ptr(), cvals, Y, Zn, W, stream)
                plan.stage(stream, state=st, alphas=al, betas=be, coeffs=cf,
                           j=s, m=6, tol=1e-7)
                st[8].add_(1)
            else:
                mom = tf.fused_sweep_ring_ref(ring, st, op.grid_shape,
                                              op.offsets, cvals, W)
                tf.sweep_stage_ref(mom, st, al, be, cf, 6, 1e-7)
            runs.append((*ring, W, st, al, be))
        dev_, host, twin = runs
        check(all(torch.equal(a, b) for a, b in zip(dev_, host)),
              f"{label} s={s}: device-index form differs from the "
              "host-index form")
        e = max(rel_max(a, b) for a, b in zip(dev_, twin)
                if float(b.abs().max()) > 0)
        check(e <= KTOL["float64"], f"{label} s={s}: device-index form vs "
              f"twin {e:.2e}")
        worst = max(worst, e)
        worst_abs = max(worst_abs, max(float((a - b).abs().max())
                                       for a, b in zip(dev_, twin)))
    # a whole pass 1: its graph against the twins' pass on the card
    b = base[0]
    a1, bt1, beta1, mu1, br1, _ = tf._lanczos_sweeps(op, b, FIXED_M, 1e-7,
                                                     what="pass 1")
    beta0, v0 = tf._start(b)
    ring = (v0, torch.zeros_like(v0),
            *(torch.empty_like(v0) for _ in range(5)))
    st = tf._const(tf._STATE0, v0)
    st[tf._ST["broke"]].copy_(beta0 == 0)
    al = torch.empty(FIXED_M, dtype=f64, device=dev)
    be = torch.empty(FIXED_M, dtype=f64, device=dev)
    for _ in range(FIXED_M + 1):
        mom = tf.fused_sweep_ring_ref(ring, st, op.grid_shape, op.offsets,
                                      cvals)
        tf.sweep_stage_ref(mom, st, al, be, None, FIXED_M, 1e-7)
    e = max(rel_max(a1, al), rel_max(bt1, be))
    check(e <= 1e2 * KTOL["float64"] and int(mu1) == int(
        st[tf._ST["m_used"]]) and bool(br1) == bool(st[tf._ST["broke"]]),
          f"{label} pass 1 from its graph vs the twins' pass {e:.2e}")
    print(f"check B3 device-index form {label}: steps 0, 1, 2, 6, 7 "
          f"(m = 6) bit-equal "
          f"to the host-index form, {worst:.2e} from the twins (tol "
          f"{KTOL['float64']:g}); pass 1 m={FIXED_M} from its graph "
          f"{e:.2e} from the twins' pass (tol {1e2 * KTOL['float64']:g}), "
          f"m_used and broke equal", flush=True)
    return worst_abs


def fixed_fused_path(et, dev, card, s):
    """The ninth path (the comment above). Returns (kernel executions of
    the path, {cell: call} for the profile, the largest device-index
    error of B3 and of B3-var against their twins)."""
    import collections
    import ctypes

    import scipy.linalg as sla
    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
    from exponentialutilities_jl_torch.utils import graphs

    t_path = time.perf_counter()
    gen = np.random.default_rng(SEED + 60)
    opA = s["opA"]
    A_t = TA * banded_csr(opA).toarray()
    total = collections.Counter()
    keys = ("eager_steps", "captures", "replays", "blocking_reads")

    def events(fn, eager_form=False):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        if eager_form:
            with graphs.eager():
                out = fn()
        else:
            out = fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z), out

    def run_counted(fn, sync_free):
        """fn() with the counts set to 0 just before and read just after,
        under sync debug mode "error" when ``sync_free``."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        if sync_free:
            torch.cuda.set_sync_debug_mode("error")
        try:
            ms, out = events(fn)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cnt = {k: graphs.counts.get(k, 0) for k in keys}
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        total.update(exe)
        return ms, out, cnt, exe

    def in_turns(fn):
        """Medians of FIXED_REPS: the graph form and graphs.eager(), in
        turns."""
        gr, eg = [], []
        events(fn, True)
        for _ in range(FIXED_REPS):
            gr.append(events(fn)[0])
            eg.append(events(fn, True)[0])
        return statistics.median(gr), statistics.median(eg)

    def fresh_B():
        return np.stack([gen.standard_normal(NA),
                         0.1 * gen.standard_normal(NA)], 1)

    def oracle(Bn, t_end):
        # u = e^{tA} b0 + t phi_1(tA) b1 from one augmented exponential
        aug = np.zeros((NA + 1, NA + 1))
        aug[:NA, :NA] = A_t * (t_end / TA)
        aug[:NA, NA] = t_end * Bn[:, 1]
        F = sla.expm(aug)
        return torch.as_tensor(F[:NA, :NA] @ Bn[:, 0] + F[:NA, NA],
                               device=dev)

    # make_phiv_timestep's fn(B), calls 1, 2, 3 with a fresh B each, and
    # phiv_timestep_fused at its grid: at config #4's time (full depth:
    # the graph form alone, the eager form costing tens of seconds a call;
    # calls 1 and 2 only, the capture and a replay, ~5 s each: depth cut
    # for the script's time limit) and at FIXED_CUT of it (depth cut:
    # beside graphs.eager())
    calls = {}
    for depth, t_end in (("full", TA), ("cut", TA / FIXED_CUT)):
        fn = et.make_phiv_timestep(t_end, opA, torch.as_tensor(
            fresh_B(), device=dev), tol=1e-7)
        label = f"config4 t={t_end:g} (nsteps {fn.nsteps}, m {fn.m})"
        check(fn.nsteps >= 3, f"{label}: fn(B) nsteps {fn.nsteps}")
        want_exe = {"banded_spmv": fn.nsteps * (1 + fn.m)}
        want_cnt = ({"eager_steps": 1, "captures": 1,
                     "replays": fn.nsteps - 1, "blocking_reads": 0},
                    {"eager_steps": 0, "captures": 0, "replays": fn.nsteps,
                     "blocking_reads": 0})
        call_ms = []
        for i in range(2 if depth == "full" else 3):
            Bn = fresh_B()
            Bt = torch.as_tensor(Bn, device=dev)
            ms, (u, eps), cnt, exe = run_counted(lambda: fn(Bt), i >= 1)
            call_ms.append(ms)
            check(cnt == want_cnt[min(i, 1)], f"{label} fn(B) call {i + 1}: "
                  f"counts {cnt}, expected {want_cnt[min(i, 1)]}")
            check(exe == want_exe, f"{label} fn(B) call {i + 1}: kernel "
                  f"executions {exe}, implied {want_exe}")
            e = rel_norm(u, oracle(Bn, t_end))
            check(bool(torch.isfinite(u).all()) and eps.shape == (
                fn.nsteps,) and e <= MTOL_NONHERM, f"{label} fn(B) call "
                  f"{i + 1}: {e:.2e} from the dense oracle")
            if depth == "cut":
                with graphs.eager():
                    ue, epse = fn(Bt)
                check(torch.equal(u, ue) and torch.equal(eps, epse),
                      f"{label} fn(B) call {i + 1} differs from "
                      "graphs.eager()")
            print(f"check fixed {label} fn(B) call {i + 1}: counts {cnt}; "
                  f"kernel executions {exe} = nsteps x (1 + m); {e:.2e} "
                  f"from the dense oracle (tol {MTOL_NONHERM:g})"
                  + ("; bit-equal to graphs.eager()" if depth == "cut"
                     else "")
                  + (" under sync debug mode 'error'" if i >= 1 else ""),
                  flush=True)

        if depth == "full":
            # phiv_timestep_fused is held to fn(B) at the cut depth below
            print(f"time fixed {label}: fn(B) call 1 (a substep eager, one "
                  f"captured, the rest replayed) {call_ms[0]:.3f} ms, call "
                  f"2 (a replay) {call_ms[1]:.3f} ms (CUDA events) {card}",
                  flush=True)
            fn.close()
            continue

        # the same stepper through phiv_timestep_fused: a runner a call
        def direct(fn=fn, Bt=Bt, t_end=t_end):
            return et.phiv_timestep_fused(t_end, opA, Bt, nsteps=fn.nsteps,
                                          m=fn.m)

        dms, (ud, epsd), cnt, exe = run_counted(direct, True)
        want = {"eager_steps": 1, "captures": 1, "replays": fn.nsteps - 1,
                "blocking_reads": 0}
        check(cnt == want and exe == want_exe,
              f"{label} phiv_timestep_fused: counts {cnt}, expected {want}; "
              f"kernel executions {exe}, implied {want_exe}")
        check(torch.equal(ud, u) and torch.equal(epsd, eps),
              f"{label} phiv_timestep_fused differs from fn(B)")
        print(f"check fixed {label} phiv_timestep_fused: counts {cnt} "
              f"(under sync debug mode 'error'); kernel executions {exe}; "
              f"bit-equal to fn(B)'s replay", flush=True)
        rep, eag = in_turns(lambda fn=fn, Bt=Bt: fn(Bt))
        gms, ems = in_turns(direct)
        print(f"time fixed {label}: fn(B) call 1 {call_ms[0]:.3f} ms, calls "
              f"2 and 3 {call_ms[1]:.3f} / {call_ms[2]:.3f} ms; replayed "
              f"{rep:.3f} ms, graphs.eager() {eag:.3f} ms; "
              f"phiv_timestep_fused {gms:.3f} ms (its own capture), "
              f"graphs.eager() {ems:.3f} ms (CUDA events, medians of "
              f"{FIXED_REPS} in turns) {card}", flush=True)
        calls[f"{label} fn(B)"] = lambda fn=fn, Bt=Bt: fn(Bt)
        calls[f"{label} phiv_timestep_fused"] = direct

    # the two-pass expv on the fused sweeps
    cells = {"2d 512^2": (s["opG"], TG, "fused_sweep"),
             "3d 216^3": (s["op3"], T3, "fused_sweep"),
             "var 216^3": (s["opV"], T3, "fused_sweep_var")}
    m = FIXED_M
    worst = {}
    for name, (op, t, kname) in cells.items():
        b = torch.as_tensor(gen.standard_normal(op.shape[0]), device=dev)

        def call(op=op, t=t, b=b):
            return et.expv(t, op, b, m=m, two_pass=True)

        call()
        ms, w, cnt, exe = run_counted(call, True)
        want = {"eager_steps": 2, "captures": 2, "replays": 2 * m,
                "blocking_reads": 0}
        want_e = {kname: 2 * (m + 1), "sweep_stage": 2 * (m + 1),
                  "tridiag_exp": 1}
        check(cnt == want, f"{name} two-pass: counts {cnt}, expected {want}")
        check(exe == want_e, f"{name} two-pass: kernel executions {exe}, "
              f"implied {want_e}")
        with graphs.eager():
            we = call()
        check(torch.equal(w, we), f"{name} two-pass differs from "
              "graphs.eager()")
        e = rel_norm(w, et.expv_chebyshev(t, op, b, tol=1e-12))
        check(e <= MTOL3["float64"], f"{name} two-pass vs expv_chebyshev "
              f"{e:.2e}")
        worst[kname] = max(worst.get(kname, 0.0),
                           ring_form_checks(et, dev, op, name, gen))
        gms, ems = in_turns(call)
        print(f"check fixed {name} two-pass m={m}: counts {cnt} (one "
              f"capture a pass; under sync debug mode 'error'); kernel "
              f"executions {exe}; bit-equal to graphs.eager(); {e:.2e} from "
              f"expv_chebyshev (tol {MTOL3['float64']:g})", flush=True)
        print(f"time fixed {name} two-pass m={m}: {gms:.3f} ms, "
              f"graphs.eager() {ems:.3f} ms (medians of {FIXED_REPS} in "
              f"turns) {card}", flush=True)
        calls[f"{name} two-pass m={m}"] = call

    # one accumulating sweep and its stage at 216^3, the device-index form
    # beside the host-index form, 20 back to back in turns
    op = s["op3"]
    n = op.shape[0]
    plan = tf._plan(op, torch.float64, op.device)
    cvals = tf._cvals(op, torch.float64)
    ring = [torch.as_tensor(gen.standard_normal(n), device=dev)
            for _ in range(7)]
    ring[1].zero_()
    W = torch.zeros(n, dtype=torch.float64, device=dev)
    st = plan.state0.clone()
    al = torch.zeros(m, dtype=torch.float64, device=dev)
    be = torch.zeros(m, dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * 7)(*(v.data_ptr() for v in ring))
    Z, Vc, Vp, Y, Zn = tf.ring_slots(ring, 5)

    def dev_form():
        st[8].fill_(5.0)
        stream = _build.raw_stream(op.device)
        plan.sweep_ring(ptrs, st, cvals, W, stream)
        plan.stage(stream, state=st, alphas=al, betas=be, j=None, m=m,
                   tol=1e-7)

    def host_form():
        st[8].fill_(5.0)
        stream = _build.raw_stream(op.device)
        plan.sweep(Z, Vc, Vp, st.data_ptr(), cvals, Y, Zn, W, stream)
        plan.stage(stream, state=st, alphas=al, betas=be, j=5, m=m,
                   tol=1e-7)

    def burst(f, k=20):
        f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            f()
        z.record()
        z.synchronize()
        return a.elapsed_time(z) / k

    ts = {"device": [], "host": []}
    for _ in range(3):
        ts["device"].append(burst(dev_form))
        ts["host"].append(burst(host_form))
    print(f"time B3 216^3 accumulating sweep + stage (each with a fill of "
          f"the counter) back to back: device-index form "
          f"{statistics.median(ts['device']):.4f} ms, host-index form "
          f"{statistics.median(ts['host']):.4f} ms (medians of 3 bursts of "
          f"20 in turns) {card}", flush=True)
    print(f"fixed path: {time.perf_counter() - t_path:.1f} s", flush=True)
    return dict(total), calls, worst


def fixed_fused_only(et, dev, card, profile: bool) -> int:
    """``--fixed-fused-only``: the ninth path with its inputs made here,
    then, with ``--profile``, torch.profiler over its cells."""
    s = fixed_fused_inputs(et, dev)
    counts, calls, _ = fixed_fused_path(et, dev, card, s)
    print(f"kernel executions of the fixed path: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if profile:
        krylov_graph_profile(calls, card, label="fixed")
    return 0


POLY_REPS = 5           # CUDA-event median of each form, taken in turns


def poly_graph_inputs(et, dev):
    """The tenth path's operators, vectors and references, made here for
    ``--poly-graphs-only`` as main makes them (SELL's pack and b as the
    seventh path's)."""
    import scipy.linalg as sla
    import torch

    t0 = time.perf_counter()
    aV = np.random.default_rng(SEED).uniform(0.5, 2.0, (N3, N3, N3))
    s = {"op3": et.laplacian_nd_stencil(N3, N3, N3, device=dev),
         "opV": et.variable_diffusion_nd_stencil(aV, device=dev)}
    del aV
    s["opF"] = et.advection_diffusion_3d_stencil(NF, NF, NF, peclet=10.0,
                                                 device=dev)
    s["bF"] = torch.as_tensor(np.random.default_rng(SEED + 11)
                              .standard_normal(NF ** 3), device=dev)
    rng4 = np.random.default_rng(SEED + 3)
    A_sell = symmetrized(bench_sell_coo(NS, 8, 700, rng4), NS, rng4)
    s["opS"] = et.SellOperator.from_scipy(A_sell, rcm=True, is_hermitian=True,
                                          dtype=np.float64, device=dev)
    perm = torch.as_tensor(s["opS"].perm, device=dev).long()
    s["bS"] = torch.as_tensor(rng4.standard_normal(NS), device=dev)[perm]
    s["opP"] = et.poisson_2d(NP, NP, device=dev)
    s["bP"] = torch.as_tensor(np.random.default_rng(SEED + 19)
                              .standard_normal(NP * NP), device=dev)
    s["opA"] = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    bAnp = np.random.default_rng(SEED).standard_normal(NA)
    s["bA"] = torch.as_tensor(bAnp, device=dev)
    s["ref_e"] = sla.expm(TA * banded_csr(s["opA"]).toarray()) @ bAnp
    s["opL"] = bench_leja_stencil(et, NL, torch.float64, dev)
    torch.cuda.synchronize()
    print(f"poly-graphs-only inputs and references: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return s


def loop_counts(c: int) -> dict:
    """Runner counts of a loop of c steps whose step 0 runs before its
    runner (ops/krylov._run): c - 1 executions through it, captured at the
    second where at least one more follows."""
    if c >= 4:
        return {"eager_steps": 1, "captures": 1, "replays": c - 2,
                "blocking_reads": 0}
    return {"eager_steps": max(c - 1, 0), "captures": 0, "replays": 0,
            "blocking_reads": 0}


def pass_counts(c: int) -> dict:
    """Runner counts of a B3 pass of c (sweep, stage) steps, all through
    its runner (lanczos_fused._run_pass)."""
    if c >= 3:
        return {"eager_steps": 1, "captures": 1, "replays": c - 1,
                "blocking_reads": 0}
    return {"eager_steps": c, "captures": 0, "replays": 0,
            "blocking_reads": 0}


def add_counts(*cs) -> dict:
    out = collections.Counter()
    for c in cs:
        out.update(c)
    return {k: out.get(k, 0) for k in ("eager_steps", "captures", "replays",
                                       "blocking_reads")}


def nw_rows(tl, tfb, op, kind, t_end, p, q, dev):
    """The (p + 1, m, 4) device rows of one snapshot interval's substeps
    of phiv_timestep_leja (tol 1e-7, max_z 40) or phiv_timestep_faber
    (max_z 512): the drivers' host tables, made here as they make them."""
    import torch

    from exponentialutilities_jl_torch.models.chebyshev import _phi_scalar_np

    tau = t_end / q
    if kind == "leja":
        c, s = tl._interval_map(op, None)
        m_probe = tl._probe_degree(abs(tau) * s, 1e-7)
        xi, sup = tl._leja_points_sup(m_probe)
        D = (tl._phi_divided_differences(tau, c, s, xi, p)
             * (tau ** np.arange(p + 1))[None, :])
        m = tl._truncate_dd(np.abs(D).max(axis=1) * sup, 1e-7, m_probe, None,
                            "nw rows")
        rows = [tl._newton_rows(D[:m, j], xi[:m], c, 1.0 / s)
                for j in range(p + 1)]
    else:
        c, _, _, g, rho = tfb._resolve_ellipse(op, None)
        m_probe = tfb._probe_degree_faber(abs(tau) * g, 1e-7)
        V = _phi_scalar_np(tau * tfb._psi_samples(1.0, c, g, rho,
                                                  tfb._nsamp(m_probe)), p)
        D = np.stack([tfb.faber_coeffs(V[j], rho, m_probe)[0]
                      for j in range(p + 1)], axis=1)
        D = D * (tau ** np.arange(p + 1))[None, :]
        m = tl._truncate_dd(np.abs(D).max(axis=1)
                            * (1.0 + rho ** np.arange(m_probe)), 1e-7,
                            m_probe, None, "nw rows")
        rows = [tfb._faber_rows(np.real(D[:m, j]), c, 1.0 / g, rho)
                for j in range(p + 1)]
    return torch.as_tensor(np.stack(rows), device=dev), tau


def recurrence_forms(tf, _build, op, b, rows):
    """The generic recurrence on the card in the host-index form (a pointer
    per vector and per row, the vectors rotated on the host, as
    recurrence_apply_fused ran before its device-index form) and through
    the plain twin of the sweep (fused_sweep_ref on the card's tensors):
    (W host-index, W twin)."""
    import torch

    plan = tf._plan(op, b.dtype, b.device)
    cvals = tf._cvals(op, b.dtype)
    zeros = torch.zeros_like(b)
    W, Wt = torch.zeros_like(b), torch.zeros_like(b)
    stream = _build.raw_stream(b.device)
    Ys = [torch.empty_like(b) for _ in range(3)]
    Zs = [torch.empty_like(b) for _ in range(2)]
    Z, Vc, Vp = b, b, zeros
    Zt, Vct, Vpt = b, b, zeros
    for s_ in range(rows.shape[0] + 1):
        co = plan.unit if s_ == 0 else rows[s_ - 1]
        Y, Zn = Ys[s_ % 3], Zs[s_ % 2]
        plan.sweep(Z, Vc, Vp, co.data_ptr(), cvals, Y, Zn, W, stream)
        Z, Vc, Vp = Zn, Y, (zeros if s_ == 0 else Vc)
        Yt, Znt, _ = tf.fused_sweep_ref(Zt, Vct, Vpt, co, op.grid_shape,
                                        op.offsets, cvals, Wt)
        Zt, Vct, Vpt = Znt, Yt, (zeros if s_ == 0 else Vct)
    return W, Wt


def poly_graph_path(et, dev, card, s):
    """The tenth path (module doc): the Chebyshev, Leja, Faber and Taylor
    loops from CUDA graphs, each a step replayed from one runner a loop
    call. Each cell's runner counts and kernel executions exact, its result
    bit-equal to graphs.eager() and within its oracle's limit, its loop
    (the device part, its inputs on the card) rerun under sync debug mode
    "error", both forms' CUDA-event medians of POLY_REPS printed. Returns
    (kernel executions of the path, {cell: call} for the profile, the
    largest device-index recurrence error of B3 and of B3-var against
    their twins)."""
    import scipy.linalg as sla
    import torch
    from exponentialutilities_jl_torch.models import chebyshev as tc
    from exponentialutilities_jl_torch.models import expv_taylor as tt
    from exponentialutilities_jl_torch.models import faber as tfb
    from exponentialutilities_jl_torch.models import leja as tl
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import dispatch as td
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
    from exponentialutilities_jl_torch.ops.kernels import resident as tr
    from exponentialutilities_jl_torch.utils import graphs

    t_path = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = np.random.default_rng(SEED + 80)
    f64 = torch.float64
    total = collections.Counter()
    keys = ("eager_steps", "captures", "replays", "blocking_reads")

    def events(fn, eager_form=False):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        if eager_form:
            with graphs.eager():
                out = fn()
        else:
            out = fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z), out

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        ms, out = events(fn)
        cnt = {k: graphs.counts.get(k, 0) for k in keys}
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        total.update(exe)
        return ms, out, cnt, exe

    def in_turns(fn):
        gr, eg = [], []
        events(fn, True)
        for _ in range(POLY_REPS):
            gr.append(events(fn)[0])
            eg.append(events(fn, True)[0])
        return statistics.median(gr), statistics.median(eg)

    def sync_free(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out

    cells = {}

    def cell(name, call, loop, cnt, exe, oracle):
        cells[name] = (call, loop, cnt, exe, oracle)

    # 216^3 expv_chebyshev, constant (B3) and variable (B3-var), tol 1e-12:
    # one B3 pass of degree + 1 (sweep, stage) steps in the device-index
    # form, the stage in recurrence mode; that form bit-equal to the
    # host-index form on the card and within KTOL of the twin
    worst = {}
    for label, op, kname in (("216^3 expv_chebyshev (B3)", s["op3"],
                              "fused_sweep"),
                             ("var 216^3 expv_chebyshev (B3-var)", s["opV"],
                              "fused_sweep_var")):
        b = torch.as_tensor(gen.standard_normal(op.shape[0]), device=dev)
        lo, hi = op.spectral_bounds_hint()
        full, c, h = tc._full_exp_coeffs(T3, lo, hi, 1e-12, None)
        rows = td.chebyshev_rows(torch.as_tensor(full, device=dev), c, h, f64)
        d = len(full)
        for rname, rr in (("Chebyshev", rows), ("random", torch.as_tensor(
                gen.standard_normal((7, 4)) * 0.1, device=dev))):
            wd = tf.recurrence_apply_fused(op, b, rr)
            wh, wt = recurrence_forms(tf, _build, op, b, rr)
            e = rel_max(wd, wt)
            check(torch.equal(wd, wh), f"{label} {rname} rows: the "
                  "device-index recurrence differs from the host-index form")
            check(e <= KTOL["float64"], f"{label} {rname} rows: device-index "
                  f"recurrence vs twin {e:.2e}")
            worst[kname] = max(worst.get(kname, 0.0),
                               float((wd - wt).abs().max()))
            print(f"check poly {label} {rname} rows (m={rr.shape[0]}): the "
                  f"device-index recurrence bit-equal to the host-index "
                  f"form, {e:.2e} from the twin (tol {KTOL['float64']:g})",
                  flush=True)
        cell(f"{label} degree {d}",
             lambda op=op, b=b: et.expv_chebyshev(T3, op, b, tol=1e-12),
             lambda op=op, b=b, rows=rows: tf.recurrence_apply_fused(
                 op, b, rows),
             pass_counts(d + 1), {kname: d + 1, "sweep_stage": d + 1},
             lambda out, op=op, b=b: (out, et.expv(T3, op, b, m=20,
                                                   two_pass=True),
                                      MTOL3["float64"], "two-pass expv m=20"))

    # 216^3 advection expv_faber(m=64): one substep, one B3 pass of Faber
    # rows
    opF, bF = s["opF"], s["bF"]
    _, _, _, gF, _ = tfb._resolve_ellipse(opF, None)
    tF = ZF / gF
    aF, cF, gamF, rhoF, qF, mF, _ = tfb._faber_expv_setup(opF, tF, None, 1e-7,
                                                          MF, 512.0)
    check(qF == 1 and mF == MF, f"216^3 expv_faber: q {qF}, m {mF}")
    rowsF = torch.as_tensor(tfb._faber_rows(np.real(aF[:mF]), cF, 1.0 / gamF,
                                            rhoF), device=dev)
    cell(f"216^3 advection expv_faber m={MF} (B3)",
         lambda: et.expv_faber(tF, opF, bF, m=MF),
         lambda: tl._engine_substeps(opF, bF, rowsF, qF,
                                     tf.recurrence_apply_fused,
                                     "faber substeps"),
         pass_counts(MF + 1), {"fused_sweep": MF + 1, "sweep_stage": MF + 1},
         lambda out: (out, et.expv(tF, opF, bF, m=MF), MTOL_POLY,
                      f"Arnoldi expv(m={MF})"))

    # SELL n = 1e6 expv_chebyshev tol 1e-12: spectral_bounds' two probes
    # (30 Lanczos steps each), then the plain degree scan on B9
    opS, bS = s["opS"], s["bS"]
    loS, hiS = tc.spectral_bounds(opS)
    fullS, cS, hS = tc._full_exp_coeffs(TS, loS, hiS, 1e-12, None)
    coefS = torch.as_tensor(fullS, device=dev)
    dS = len(fullS)
    cell(f"SELL n=1e6 expv_chebyshev degree {dS} (B9)",
         lambda: et.expv_chebyshev(TS, opS, bS, tol=1e-12),
         lambda: tc._chebyshev_apply_scan(opS, bS, coefS, cS, 1.0 / hS),
         add_counts(loop_counts(30), loop_counts(30), loop_counts(dS)),
         {"sell_spmv": 60 + dS},
         lambda out: (out, et.expv(TS, opS, bS, m=40), MTOL_SPARSE,
                      "Krylov expv(m=40)"))

    # config #3 phiv_timestep_chebyshev, B = [b, 0.1 b], two snapshots:
    # the combination scan on B7
    opP, bP = s["opP"], s["bP"]
    BP = torch.stack([bP, 0.1 * bP], dim=1)
    tsP = np.asarray([TP / 2, TP])
    loP, hiP = opP.spectral_bounds_hint()
    cP, hP = 0.5 * (hiP + loP), 0.5 * (hiP - loP)
    CP = tc._fun_ucoeffs(lambda x: np.concatenate(
        [tc._phi_scalar_np(t * (cP + hP * x), 1)
         * (t ** np.arange(2))[:, None] for t in tsP], axis=0),
        1e-12, 1024)
    mP = len(CP)
    CPj = torch.as_tensor(CP.reshape(mP, 2, 2), device=dev)

    def oracle_P(out):
        cols = []
        for t in tsP:
            W = et.phiv(float(t), opP, bP, 1, m=30)
            cols.append(W[:, 0] + float(t) * 0.1 * W[:, 1])
        return (out, torch.stack(cols, dim=1), MTOL_PHI,
                "phiv(k=1, m=30) columns")

    cell(f"config3 phiv_timestep_chebyshev degree {mP} (B7)",
         lambda: et.phiv_timestep_chebyshev(list(tsP), opP, BP, tol=1e-12),
         lambda: tc._chebyshev_combination_scan(opP, BP.T, CPj, cP,
                                                1.0 / hP),
         loop_counts(mP), {"banded_spmv": 2 * mP}, oracle_P)

    # config #4's operator: expv_leja, expv_faber, phiv_leja on B5
    opA, bA, ref_e = s["opA"], s["bA"], torch.as_tensor(s["ref_e"],
                                                         device=dev)
    dA, xiA, cA, sA, qA = tl._leja_expv_setup(opA, TA, None, 1e-12, None,
                                              40.0)
    rowsA = torch.as_tensor(tl._newton_rows(dA, xiA, cA, 1.0 / sA),
                            device=dev)
    cell(f"config4 expv_leja tol=1e-12 q={qA} (B5)",
         lambda: et.expv_leja(TA, opA, bA, tol=1e-12),
         lambda: tl._engine_substeps(opA, bA, rowsA, qA,
                                     tr.recurrence_apply_resident_banded,
                                     "leja substeps"),
         loop_counts(qA), {"resident_banded": qA},
         lambda out: (out, ref_e, MTOL_POLY, "the dense oracle"))
    aAF, cAF, gAF, rhoAF, qAF, mAF, _ = tfb._faber_expv_setup(
        opA, TA, None, 1e-12, None, 512.0)
    rowsAF = torch.as_tensor(tfb._faber_rows(np.real(aAF[:mAF]), cAF,
                                             1.0 / gAF, rhoAF), device=dev)
    cell(f"config4 expv_faber tol=1e-12 q={qAF} (B5)",
         lambda: et.expv_faber(TA, opA, bA, tol=1e-12),
         lambda: tl._engine_substeps(opA, bA, rowsAF, qAF,
                                     tr.recurrence_apply_resident_banded,
                                     "faber substeps"),
         loop_counts(qAF), {"resident_banded": qAF},
         lambda out: (out, ref_e, MTOL_POLY, "the dense oracle"))
    tPL = 20.0 / sA
    mpr = tl._probe_degree(20.0, 1e-12)
    xiP, supP = tl._leja_points_sup(mpr)
    DP = tl._phi_divided_differences(tPL, cA, sA, xiP, 1)
    mDP = tl._truncate_dd(np.abs(DP).max(axis=1) * supP, 1e-12, mpr, None,
                          "phiv_leja")
    rowsPL = torch.as_tensor(np.stack([tl._newton_rows(
        DP[:mDP, j], xiP[:mDP], cA, 1.0 / sA) for j in range(2)]), device=dev)

    def oracle_PL(out):
        Ad = banded_csr(opA).toarray()
        bn = bA.cpu().numpy()
        aug = np.zeros((NA + 1, NA + 1))
        aug[:NA, :NA] = tPL * Ad
        aug[:NA, NA] = tPL * 0.1 * bn
        F2 = sla.expm(aug)
        ref = torch.as_tensor(F2[:NA, :NA] @ bn + F2[:NA, NA], device=dev)
        return (out[:, 0] + tPL * 0.1 * out[:, 1], ref, MTOL_POLY,
                "phi_0 b + t phi_1 (0.1 b) vs the dense oracle")

    cell("config4 phiv_leja k=1 z=20 (B5, no loop)",
         lambda: et.phiv_leja(tPL, opA, bA, 1, tol=1e-12),
         lambda: torch.stack([tr.recurrence_apply_resident_banded(
             opA, bA, rowsPL[j]) for j in range(2)], dim=-1),
         loop_counts(0), {"resident_banded": 2}, oracle_PL)

    # bench_leja.py's n = 1e6 operator, B (n, 3): the NW drivers' substeps
    # on B1, one step a substep (three B1 passes)
    opL = s["opL"]
    BL = torch.as_tensor(gen.standard_normal((NL, 3)), device=dev)
    _, sL = tl._interval_map(opL, None)
    qL = math.ceil(TL * sL / 40.0)
    _, _, _, gL, _ = tfb._resolve_ellipse(opL, None)
    qLF = math.ceil(TL * gL / 512.0)
    rowsL, tauL = nw_rows(tl, tfb, opL, "leja", TL, 2, qL, dev)
    rowsLF, tauLF = nw_rows(tl, tfb, opL, "faber", TL, 2, qLF, dev)
    krylov_L = {}

    def oracle_L(out):
        if "u" not in krylov_L:
            u = et.phiv_timestep_device([TL], opL, BL, tol=1e-7, m=30, iop=2)
            krylov_L["u"] = u[0] if isinstance(u, tuple) else u
        return (out, krylov_L["u"], MTOL_DRIVER,
                "Krylov phiv_timestep_device")

    cell(f"n=1e6 phiv_timestep_leja q={qL} (B1)",
         lambda: et.phiv_timestep_leja([TL], opL, BL, tol=1e-7, max_z=40.0),
         lambda: tl._nw_engine_substeps(opL, BL[:, 0], BL, rowsL, 0.0, tauL,
                                        qL, tr.recurrence_apply_resident, 2,
                                        "nw_leja substeps"),
         loop_counts(qL), {"resident_recurrence": 3 * qL}, oracle_L)
    cell(f"n=1e6 phiv_timestep_faber q={qLF} (B1)",
         lambda: et.phiv_timestep_faber([TL], opL, BL, tol=1e-7),
         lambda: tl._nw_engine_substeps(opL, BL[:, 0], BL, rowsLF, 0.0,
                                        tauLF, qLF,
                                        tr.recurrence_apply_resident, 2,
                                        "nw_faber substeps"),
         loop_counts(qLF), {"resident_recurrence": 3 * qLF}, oracle_L)

    # expv_taylor: config #4 (s stages of m* B7 matvecs, one step a stage)
    # and a small dense stack (cuBLAS products, no kernel of ours)
    hint = float(opA.opnorm_hint())
    mT, sT = tt.operator_parameters(TA * hint,
                                    tt.taylor_theta(torch.float64))
    cell(f"config4 expv_taylor m*={mT} s={sT} (B7)",
         lambda: et.expv_taylor(TA, opA, bA),
         lambda: et.expv_taylor(TA, opA, bA, opnorm=hint),
         loop_counts(sT), {"banded_spmv": mT * sT},
         lambda out: (out, ref_e, MTOL_NONHERM, "the dense oracle"))
    As = gen.standard_normal((8, 64, 64)) * 3.0   # 1-norms ~150: s >= 4
    bs = gen.standard_normal((8, 64))
    As_d, bs_d = torch.as_tensor(As, device=dev), torch.as_tensor(bs,
                                                                  device=dev)
    partsT = tt._taylor_dense_parts(
        As_d, bs_d, torch.full((8,), 1.0, dtype=f64, device=dev),
        torch.zeros(8, dtype=f64, device=dev), True,
        float(torch.finfo(f64).eps) / 2)
    sB = partsT[-1]
    refB = torch.as_tensor(np.stack([sla.expm(As[i]) @ bs[i]
                                     for i in range(8)]), device=dev)
    cell(f"dense expv_taylor_batched 8 x 64 s={sB}",
         lambda: et.expv_taylor_batched(1.0, As_d, bs_d),
         lambda: tt._taylor_loop(*partsT, what="taylor (dense)"),
         loop_counts(sB), {},
         lambda out: (out, refB, MTOL_DENSE["float64"],
                      "scipy expm per system"))

    calls, outs = {}, {}
    for name, (call, loop, want_cnt, want_exe, oracle) in cells.items():
        call()                                  # plans, library, pool
        ms, out, cnt, exe = counted(call)
        check(cnt == want_cnt, f"{name}: counts {cnt}, expected {want_cnt}")
        check(exe == want_exe, f"{name}: kernel executions {exe}, implied "
              f"{want_exe}")
        with graphs.eager():
            oute = call()
        check(torch.equal(out, oute), f"{name} differs from graphs.eager()")
        got, ref, tol, what = oracle(out)
        e = rel_norm(got, ref.reshape(got.shape))
        check(bool(torch.isfinite(out).all()) and e <= tol,
              f"{name}: {e:.2e} from {what}")
        lo_ = sync_free(loop)
        check(bool(torch.isfinite(lo_).all()), f"{name}: the loop under sync "
              "debug mode")
        gms, ems = in_turns(call)
        print(f"check poly {name}: counts {cnt}; kernel executions {exe}; "
              f"bit-equal to graphs.eager(); {e:.2e} from {what} (tol "
              f"{tol:g}); its loop under sync debug mode 'error'", flush=True)
        print(f"time poly {name}: graph form {gms:.3f} ms, graphs.eager() "
              f"{ems:.3f} ms (CUDA events, medians of {POLY_REPS} in turns; "
              f"first counted call {ms:.3f} ms) {card}", flush=True)
        calls[name] = call
        if name.startswith("n=1e6"):
            outs[name.split()[1]] = out
    e = rel_norm(outs["phiv_timestep_leja"], outs["phiv_timestep_faber"])
    check(e <= MTOL_DRIVER, f"n=1e6 Leja vs Faber {e:.2e}")
    print(f"check poly n=1e6 phiv_timestep_leja vs phiv_timestep_faber: "
          f"{e:.2e} (tol {MTOL_DRIVER:g})", flush=True)
    # one accumulating B3 sweep of the recurrence at 216^3: the
    # device-index form (its row copied by the stage's recurrence mode)
    # beside the host-index form (the row's pointer), 20 back to back
    import ctypes

    op = s["op3"]
    n = op.shape[0]
    plan = tf._plan(op, f64, op.device)
    cvals = tf._cvals(op, f64)
    ring = [torch.as_tensor(gen.standard_normal(n), device=dev)
            for _ in range(7)]
    ring[1].zero_()
    W = torch.zeros(n, dtype=f64, device=dev)
    st = plan.state0.clone()
    rows = torch.as_tensor(gen.standard_normal((8, 4)) * 0.1, device=dev)
    ptrs = (ctypes.c_void_p * 7)(*(v.data_ptr() for v in ring))
    Z, Vc, Vp, Y, Zn = tf.ring_slots(ring, 5)

    def dev_form():
        st[8].fill_(5.0)
        stream = _build.raw_stream(op.device)
        plan.sweep_ring(ptrs, st, cvals, W, stream)
        plan.stage_rows(stream, st, rows, 8)

    def host_form():
        stream = _build.raw_stream(op.device)
        plan.sweep(Z, Vc, Vp, rows[4].data_ptr(), cvals, Y, Zn, W, stream)

    def burst(f, k=20):
        f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            f()
        z.record()
        z.synchronize()
        return a.elapsed_time(z) / k

    ts = {"device": [], "host": []}
    for _ in range(3):
        ts["device"].append(burst(dev_form))
        ts["host"].append(burst(host_form))
    print(f"time B3 216^3 accumulating recurrence sweep back to back: "
          f"device-index form with its stage in recurrence mode (and a fill "
          f"of the counter) {statistics.median(ts['device']):.4f} ms, "
          f"host-index form (no stage) {statistics.median(ts['host']):.4f} "
          f"ms (medians of 3 bursts of 20 in turns) {card}", flush=True)
    print(f"poly path: {time.perf_counter() - t_path:.1f} s; peak device "
          f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB "
          f"{card}", flush=True)
    return dict(total), calls, worst


def poly_graphs_only(et, dev, card, profile: bool) -> int:
    """``--poly-graphs-only``: the tenth path with its inputs and references
    made here, then, with ``--profile``, torch.profiler over its cells."""
    s = poly_graph_inputs(et, dev)
    counts, calls, _ = poly_graph_path(et, dev, card, s)
    print(f"kernel executions of the poly graph path: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if profile:
        krylov_graph_profile(calls, card, label="poly")
    return 0


# ---- the eleventh path: expv_batched as one batched build ----
# expv_batched at full width in float64, each call one batched build (a
# masked step with a batch axis replayed from one graph a builder call):
#   config #3, poisson_2d(1000, 1000), t = 1e-4, m = 30, B (NB3, n): Lanczos
#     by the fused batched step (K1's Lanczos form and K5, two launches a
#     step, no torch op over (NB3, n) in the step: the ops over blocks of
#     that size per call are counted at m = 4 and m = 6 under a dispatch
#     mode and must not differ) and one K2 (R1 batched); row
#     NB3 - 1 zeros;
#   config #2, the 1-D Laplacian at n = 1e5, t = 0.5, m = 40, two-pass, B
#     (NB2, n): K3 (B2 batched) -> K2 -> K4 (B1 batched); rows 6 and 7 zeros
#     and an eigenvector of the Laplacian (a breakdown at step 1);
#   config #4, advection_diffusion_1d(2000, Pe = 10), t = 1e-4, m = 250, B
#     (NB4, n): Arnoldi (CGS2) on K1, the stack's Higham 2005 with its
#     1-norm on the device.
# Each cell: its kernel executions and captures exact, each row against
# the row's scalar expv (MTOL_ROWS: the batched dots and norms sum in
# another order) and the cell's oracle (MTOL_DENSE: scipy expm_multiply,
# the semigroup identity at n = 1e6, the dense expm), batched against
# per-row in turns (CUDA-event medians of BATCH_REPS); K1-K4 against their
# twins at these shapes, K1-K3 bit for bit against B7, R1 and B2 on each
# row and K4's w against B1's (its sums of w^2 within K4_SUM_TOL); K1's
# Lanczos form and K5 each against its twin on a state at step PAIR_J of
# the cell's shape (K5 on pass A's own output), alpha against B7 on each
# row, the bits repeating from the same state; a replayed step of the
# cell's builder (the slope of lanczos between m = 10 and 30), fused and
# unfused.
PAIR_J = 3
NB3, NB2, NB4 = 16, 8, 16
MTOL_ROWS = 1e-13
K4_SUM_TOL = 1e-14       # float64: the blocks' partials grouped otherwise
BATCH_REPS = 5


def unfused_operator(op):
    """``op`` (a ``BandedOperator``) behind a wrapper that is no
    ``BandedOperator``: the batched builders take the unfused step on it (K1
    and torch ops), the step the fused pair replaced."""
    from exponentialutilities_jl_torch.utils.linop import LinearOperator

    class Unfused(LinearOperator):
        shape, dtype, device = op.shape, op.dtype, op.device
        is_hermitian = op.is_hermitian

        def matvec(self, x):
            return op.matvec(x)

        def matmat(self, X):
            return op.matmat(X)

        def opnorm_hint(self):
            return op.opnorm_hint()

    return Unfused()


def big_ops(fn, numel):
    """{aten op: calls} of the ops that read or write a tensor of at least
    ``numel`` elements in one call of fn under ``graphs.eager()`` (every
    step dispatched, none replayed), seen by a dispatch mode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from exponentialutilities_jl_torch.utils import graphs

    seen = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.numel() >= numel
                   for t in tree_leaves((args, kwargs, out))):
                seen[str(func)] += 1
            return out

    with graphs.eager(), Count():
        fn()
    torch.cuda.synchronize()
    return seen


def pair_checks(et, dev, opP, X3, dt, gen):
    """K1's Lanczos form and K5 of the fused batched Lanczos step, each on
    its own, against its twin on a state at step PAIR_J of config #3's
    (NB3, n) shape in ``dt`` (the ring layout, the last row broken down
    before the step): pass A's v_j and alpha (alpha also against B7 on
    each row), then K5 on pass A's output (u, the records, broke, m_used,
    scale); then both again from the same state, bit for bit. Returns
    (pass A's max abs error, K5's, {"pair": the pair on its state,
    "plain_a", "plain_u": the twins on it}) for the times."""
    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import lanczos_step as tls

    dn = str(dt)[6:]
    op = et.BandedOperator(opP.diags.to(dt), opP.offsets, is_hermitian=True)
    nb, n = X3.shape
    j = PAIR_J

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    st = dict(u=X3.to(dt).clone(), scale=t(gen.uniform(0.5, 2.0, nb)),
              slots=t(gen.standard_normal((nb, 2, n))),
              alphas=t(np.zeros((nb, 30))), betas=t(np.zeros((nb, 30))),
              bprev=t(gen.uniform(0.5, 1.0, nb)),
              broke=torch.zeros(nb, dtype=torch.bool, device=dev),
              m_used=torch.full((nb,), j, dtype=torch.int64, device=dev),
              jj=torch.tensor([j, j + 1], device=dev))
    st["broke"][nb - 1] = True
    pair = tls.LanczosPair(op, st["u"], st["scale"], st["slots"], 2,
                           st["alphas"], st["betas"], st["bprev"],
                           st["broke"], st["m_used"], st["jj"], 1e-7)
    init = {k: v.clone() for k, v in st.items()}
    stream = _build.raw_stream(st["u"].device)
    _build.check(pair.fa(pair.addr, stream), "K1's Lanczos form")
    torch.cuda.synchronize()
    vc_ref, a_ref = tls.spmm_alpha_ref(op.diags, op.offsets, init["u"],
                                       init["scale"], init["broke"])
    vc, vp = st["slots"][:, j % 2], st["slots"][:, (j - 1) % 2]
    ea = max(rel_max(vc, vc_ref), rel_max(pair.alpha, a_ref))
    yb = torch.stack([op.matvec(vc[i]) for i in range(nb)])
    eb = rel_max(pair.alpha, torch.linalg.vecdot(vc, yb))
    check(ea <= KTOL[dn], f"K1's Lanczos form {dn}: {ea:.2e} from its twin")
    check(eb <= KTOL[dn], f"K1's Lanczos form {dn}: alpha {eb:.2e} from B7")
    u2, a2, b2, br2, mu2, sc2 = tls.lanczos_update_ref(
        op.diags, op.offsets, vc, vp, pair.alpha, init["bprev"],
        init["broke"], init["m_used"], init["jj"][1], 1e-7)
    want = (u2, a2, b2, b2, br2, mu2, sc2)      # in got's order
    _build.check(pair.fu(pair.addr, stream), "K5")
    torch.cuda.synchronize()
    got = (st["u"], st["alphas"][:, j], st["betas"][:, j], st["bprev"],
           st["broke"], st["m_used"], st["scale"])
    eu = max(rel_max(got[i], want[i]) for i in (0, 1, 2, 3, 6))
    check(eu <= KTOL[dn], f"K5 {dn}: {eu:.2e} from its twin")
    check(torch.equal(got[4], want[4]) and torch.equal(got[5], want[5]),
          f"K5 {dn}: broke or m_used differ from its twin")
    abs_a = float(max((vc - vc_ref).abs().max(),
                      (pair.alpha - a_ref).abs().max()))
    abs_u = float(max((got[i] - want[i]).abs().max() for i in (0, 1, 2, 3, 6)))
    keep = {k: v.clone() for k, v in st.items()}
    for k, v in st.items():
        v.copy_(init[k])
    _build.check(pair.fa(pair.addr, stream), "K1's Lanczos form")
    _build.check(pair.fu(pair.addr, stream), "K5")
    torch.cuda.synchronize()
    same = all(torch.equal(st[k], keep[k]) for k in st)
    check(same, f"K1's Lanczos form and K5 {dn}: bits differ between two "
          "runs from one state")
    print(f"kernel K1 Lanczos form and K5 {dn} config #3 ({nb}, {n}), step "
          f"{j}, row {nb - 1} broken down: pass A {ea:.2e} from its twin, "
          f"alpha {eb:.2e} from B7 on each row; K5 {eu:.2e} from its twin "
          f"on pass A's output (tol {KTOL[dn]:g}), broke and m_used equal; "
          "bits repeat from one state", flush=True)
    return abs_a, abs_u, dict(
        pair=pair,
        plain_a=lambda: tls.spmm_alpha_ref(op.diags, op.offsets, st["u"],
                                           st["scale"], st["broke"]),
        plain_u=lambda: tls.lanczos_update_ref(
            op.diags, op.offsets, vc, vp, pair.alpha, st["bprev"],
            st["broke"], st["m_used"], st["jj"][1], 1e-7))


def batched_path(et, dev, card):
    """The eleventh path (the comment above). Returns (kernel executions of
    the cells' counted calls, {cell: call} for the profile, {kernel:
    (ms, plain ms, library ms or None, (bytes, operations), max abs err)},
    the profiler jobs [(kernel, dtype name, call, kernel name)])."""
    import scipy.linalg as sla
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import resident as tr
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt
    from exponentialutilities_jl_torch.utils import graphs

    t_path = time.perf_counter()
    f64 = torch.float64
    gen = np.random.default_rng(SEED + 110)
    total = collections.Counter()
    opP = et.poisson_2d(NP, NP, device=dev)
    op1 = et.laplacian_nd_stencil(N1, device=dev)
    opA = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    nP = NP * NP
    B3 = torch.as_tensor(gen.standard_normal((NB3, nP)), device=dev)
    B3[NB3 - 1] = 0.0
    B2n = gen.standard_normal((NB2, N1))
    B2n[6] = 0.0
    B2n[7] = np.sin(np.pi * 5 * np.arange(1, N1 + 1) / (N1 + 1))
    B2 = torch.as_tensor(B2n, device=dev)
    B4 = torch.as_tensor(gen.standard_normal((NB4, NA)), device=dev)

    def median_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            ts.append(event_ms(fn)[1])
        return statistics.median(ts)

    def burst_ms(fn, k=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn()
        z.record()
        z.synchronize()
        return a.elapsed_time(z) / k

    # ---- K1-K4 against their twins at the cells' shapes ----
    kinfo, jobs, errs = {}, [], {}
    X3 = torch.as_tensor(gen.standard_normal((NB3, nP)), device=dev)
    k5 = len(opP.offsets)
    for dt in (torch.float32, f64):
        Xd = X3.to(dt)
        opd = et.BandedOperator(opP.diags.to(dt), opP.offsets,
                                is_hermitian=True)
        _build.reset_launch_counts()
        Y = opd.matmat(Xd)
        check(_build.launches["banded_spmm"] == 1, "K1: one launch a block")
        e = rel_max(Y, tsp.banded_spmm_ref(opd.diags, opd.offsets, Xd))
        check(e <= KTOL[str(dt)[6:]], f"K1 {dt}: {e:.2e} from its twin")
        same = all(torch.equal(Y[i], opd.matvec(Xd[i])) for i in range(NB3))
        check(same, f"K1 {dt}: a row differs from B7 on that row")
        print(f"kernel K1 banded_spmm {str(dt)[6:]} config #3 ({NB3}, {nP}): "
              f"max rel err {e:.2e} vs banded_spmm_ref (tol "
              f"{KTOL[str(dt)[6:]]:g}); every row bit for bit B7 on that row",
              flush=True)
        if dt == f64:
            errs["banded_spmm"] = float((Y - tsp.banded_spmm_ref(
                opd.diags, opd.offsets, Xd)).abs().max())
    pair_in = {}
    for dt in (torch.float32, f64):
        e1, e2, pin = pair_checks(et, dev, opP, X3, dt, gen)
        if dt == f64:
            errs["banded_spmm_alpha"], errs["lanczos_update"] = e1, e2
            pair_in = pin
    for m in (30, 250):
        ins = [r1_inputs(m, f64, dev, SEED + 120 + i,
                         tail=(m - 4 if i == 1 else 0)) for i in range(NB3)]
        A = torch.stack([a for a, _ in ins])
        Bt = torch.stack([b for _, b in ins])
        t = torch.tensor(0.6, dtype=f64, device=dev)
        s = torch.as_tensor(gen.uniform(0.5, 2.0, NB3), device=dev)
        _build.reset_launch_counts()
        out = tt.tridiag_exp_e1_batched(A, Bt, t, s)
        check(_build.launches["tridiag_exp_batched"] == 1, "K2: one launch")
        ref = tt.tridiag_exp_e1_batched_ref(A, Bt, t, s)
        e = rel_max(out, ref)
        check(e <= 1e-13, f"K2 m={m}: {e:.2e} from its twin")
        same = all(torch.equal(out[i], tt.tridiag_exp_e1(A[i], Bt[i], t,
                                                         s[i]))
                   for i in range(NB3))
        check(same, f"K2 m={m}: a row differs from R1 on that row")
        print(f"kernel K2 tridiag_exp_e1_batched float64 m={m} batch {NB3} "
              f"(row 1 broken down at step 4): max rel err {e:.2e} vs the "
              "batched eigh twin (tol 1e-13); every row bit for bit R1 on "
              "that row", flush=True)
        errs.setdefault("tridiag_exp_batched", 0.0)
        errs["tridiag_exp_batched"] = max(errs["tridiag_exp_batched"],
                                          float((out - ref).abs().max()))
        if m == 30:
            k2_in = (A, Bt, t, s)
    nrm = torch.linalg.vector_norm(B2, dim=-1, keepdim=True)
    V0 = torch.where(nrm > 0, B2 / torch.where(nrm > 0, nrm, 1.0), 0.0)
    offs1 = tr._flat_offsets(op1)
    _build.reset_launch_counts()
    ab = tr.resident_lanczos(op1, V0, 40, 1e-7)
    check(_build.launches["resident_lanczos_batched"] == 1, "K3: one launch")
    abr = tr.resident_lanczos_batched_ref(V0, op1.coeffs, offs1, 40, 1e-7)
    e = rel_max(ab, abr)
    check(e <= KTOL["float64"], f"K3: {e:.2e} from its twin")
    same = all(torch.equal(ab[i], tr.resident_lanczos(op1, V0[i], 40, 1e-7))
               for i in range(NB2))
    check(same, "K3: a row differs from B2 on that row")
    used = [int((ab[i, :, 1] > 0).sum()) for i in range(NB2)]
    print(f"kernel K3 resident_lanczos batched float64 config #2 ({NB2}, "
          f"{N1}), m=40: max rel err {e:.2e} vs the batched twin (tol "
          f"{KTOL['float64']:g}); every row bit for bit B2 on that row; "
          f"nonzero betas a row {used}", flush=True)
    errs["resident_lanczos_batched"] = float((ab - abr).abs().max())
    rows = torch.as_tensor(gen.standard_normal((NB2, 40, 4)) * 0.3,
                           device=dev)
    rows[..., 0] *= 0.25
    sc = torch.as_tensor(gen.uniform(0.5, 2.0, NB2), device=dev)
    plan4 = tr.recurrence_batch_plan(op1, f64, op1.device, NB2)
    _build.reset_launch_counts()
    W, s2 = tr.resident_recurrence(op1, B2, rows, sc)
    check(_build.launches["resident_recurrence_batched"]
          == plan4.launches_per_call, "K4: launches")
    Wr, s2r = tr.resident_recurrence_batched_ref(B2, rows, op1.coeffs, offs1,
                                                  sc)
    e = max(rel_max(W, Wr), rel_max(s2, s2r))
    check(e <= KTOL["float64"], f"K4: {e:.2e} from its twin")
    es = 0.0
    for i in range(NB2):
        w1, n1 = tr.resident_recurrence(op1, B2[i], rows[i], sc[i])
        check(torch.equal(W[i], w1), f"K4: row {i}'s w differs from B1's")
        es = max(es, abs(float(s2[i] - n1)) / max(float(n1), 1e-300))
    check(es <= K4_SUM_TOL, f"K4: sum w^2 {es:.2e} from B1's")
    print(f"kernel K4 resident_recurrence batched float64 config #2 ({NB2}, "
          f"{N1}), m=40: {plan4.rows_per_launch} rows a launch of "
          f"{plan4.rows_per_launch} x {plan4.grid} blocks of {plan4.chunk} "
          f"rows ({plan4.launches_per_call} launch(es) a call; B1 alone: "
          f"{tr.recurrence_plan(op1, f64, op1.device).grid} blocks); max rel "
          f"err {e:.2e} vs the batched twin (tol {KTOL['float64']:g}); every "
          f"row's w bit for bit B1's, its sum of w^2 within {es:.2e} (tol "
          f"{K4_SUM_TOL:g})", flush=True)
    errs["resident_recurrence_batched"] = float(max((W - Wr).abs().max(),
                                                    (s2 - s2r).abs().max()))

    # ---- the cells ----
    A4 = banded_csr(opA).toarray()
    E4 = sla.expm(TA * A4)
    A1s = banded_csr(op1.to_banded())
    cells = {
        f"config3 expv_batched {NB3} x m=30": (
            lambda: et.expv_batched(TP, opP, B3, m=30), B3,
            lambda b: et.expv(TP, opP, b, m=30),
            {"banded_spmm_alpha": 30, "lanczos_update": 30,
             "tridiag_exp_batched": 1}, 1),
        f"config2 expv_batched {NB2} x two-pass m=40": (
            lambda: et.expv_batched(T1, op1, B2, m=40, two_pass=True), B2,
            lambda b: et.expv(T1, op1, b, m=40, two_pass=True),
            {"resident_lanczos_batched": 1, "tridiag_exp_batched": 1,
             "resident_recurrence_batched": plan4.launches_per_call}, 0),
        f"config4 expv_batched {NB4} x m={MA}": (
            lambda: et.expv_batched(TA, opA, B4, m=MA), B4,
            lambda b: et.expv(TA, opA, b, m=MA),
            {"banded_spmm": MA}, 1),
    }
    calls = {}
    for name, (fn, Bm, row, want, caps) in cells.items():
        fn()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        graphs.reset_counts()
        W, ms = event_ms(fn)
        torch.cuda.synchronize()
        exe = {k: v for k, v in graphs.kernel_executions(
            dict(_build.launches)).items() if v}
        total.update(exe)
        check(exe == want, f"batched {name}: kernel executions {exe}, "
              f"expected {want}")
        ncap = graphs.counts["captures"]
        check(ncap == caps, f"batched {name}: {ncap} captures, expected "
              f"{caps}")
        with graphs.eager():
            check(torch.equal(W, fn()), f"batched {name}: differs from "
                  "graphs.eager()")
        Wr = torch.stack([row(b) for b in Bm.unbind(0)])
        er = rel_max(W, Wr)
        check(er <= MTOL_ROWS, f"batched {name}: {er:.2e} from the rows' "
              "expv")
        check(not W[Bm.abs().amax(1) == 0].any(),
              f"batched {name}: a zero row is not zero")
        if name.startswith("config3"):
            half = et.expv_batched(TP / 2, opP, et.expv_batched(
                TP / 2, opP, B3, m=30), m=30)
            eo = rel_max(W, half)
            oracle = "the semigroup identity exp(t/2 A)^2 B"
        elif name.startswith("config2"):
            ref = spla.expm_multiply(T1 * A1s, B2n.T).T
            eo = max(rel_norm(W[i].cpu(), torch.as_tensor(ref[i]))
                     for i in range(NB2) if i != 6)
            oracle = "scipy expm_multiply (each row)"
        else:
            ref = torch.as_tensor((E4 @ B4.cpu().numpy().T).T, device=dev)
            eo = rel_max(W, ref)
            oracle = "the dense expm"
        check(eo <= MTOL_DENSE["float64"], f"batched {name}: {eo:.2e} from "
              f"{oracle}")
        print(f"check batched {name}: kernel executions {exe}, captures "
              f"{ncap} (one a builder call), "
              f"bit-equal to graphs.eager(); each row vs its scalar expv "
              f"{er:.2e} (tol {MTOL_ROWS:g}), vs {oracle} {eo:.2e} (tol "
              f"{MTOL_DENSE['float64']:g}); the zero row zero; one call "
              f"{ms:.3f} ms {card}", flush=True)
        bt, rt = [], []
        for _ in range(BATCH_REPS):
            bt.append(event_ms(fn)[1])
            rt.append(event_ms(lambda: [row(b) for b in Bm.unbind(0)])[1])
        print(f"time batched {name}: batched {statistics.median(bt):.3f} ms, "
              f"per-row expv {statistics.median(rt):.3f} ms (CUDA events, "
              f"medians of {BATCH_REPS} in turns) {card}", flush=True)
        calls[f"{name} batched"] = fn
        calls[f"{name} per-row"] = (lambda row=row, Bm=Bm: [
            row(b) for b in Bm.unbind(0)])

    # ---- no torch pass over (NB3, n) in the fused step; a replayed step ----
    big = {m: big_ops(lambda m=m: et.expv_batched(TP, opP, B3, m=m), NB3 * nP)
           for m in (4, 6)}
    unf = unfused_operator(opP)
    ubig = {m: big_ops(lambda m=m: et.expv_batched(TP, unf, B3, m=m), NB3 * nP)
            for m in (4, 6)}
    per_step = {k: (big[6][k] - big[4][k]) / 2
                for k in set(big[6]) | set(big[4])}
    uper_step = {k: (ubig[6][k] - ubig[4][k]) / 2
                 for k in set(ubig[6]) | set(ubig[4])}
    check(not any(per_step.values()), f"batched config3: torch ops over "
          f"({NB3}, {nP}) inside the fused step: {per_step}")
    check(sum(uper_step.values()) > 0, f"batched config3: the dispatch mode "
          f"saw no torch op over ({NB3}, {nP}) in the unfused step")
    print(f"check batched config3 fused step: torch ops over ({NB3}, {nP}) "
          f"a step {sum(per_step.values()):g} (ops a call at m = 4 / 6: "
          f"{sum(big[4].values())} / {sum(big[6].values())}); the unfused "
          f"step's {sum(uper_step.values()):g} a step "
          f"{ {k: v for k, v in sorted(uper_step.items()) if v} }",
          flush=True)
    from exponentialutilities_jl_torch.ops import krylov as tk
    steps = {}
    for form, o in (("fused", opP), ("unfused", unf)):
        t = {m: statistics.median([event_ms(lambda m=m: tk.lanczos(
            o, B3, m))[1] for _ in range(3)]) for m in (10, 30)}
        steps[form] = (t[30] - t[10]) / 20
    sb = (k5 + 4 * NB3) * nP * 8 / HBM_BYTES_PER_S * 1e3
    print(f"time batched config3 replayed step (lanczos, ({NB3}, {nP}), the "
          f"slope between m = 10 and 30, medians of 3): fused "
          f"{steps['fused']:.4f} ms, unfused {steps['unfused']:.4f} ms; "
          f"bound {sb:.4f} ms by bytes ((k + 3 batch) n 8 + the basis row) "
          f"{card}", flush=True)

    # ---- K1-K4 times: plain, kernel, kernel, plain; library call ----
    Pd = opP
    csr = banded_csr(Pd).tocsr()
    csrP = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(csr.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(csr.data, dtype=f64, device=dev), csr.shape)
    A30, B30, t30, s30 = k2_in
    T30 = (torch.diag_embed(A30) + torch.diag_embed(B30, 1)
           + torch.diag_embed(B30, -1))

    def k2_lib():
        w, Q = torch.linalg.eigh(T30)
        return (Q @ (torch.exp(t30 * w) * Q[..., 0, :])[..., None])[..., 0] \
            * s30[:, None]

    cases = {
        "banded_spmm": (lambda: Pd.matmat(X3),
                        lambda: tsp.banded_spmm_ref(Pd.diags, Pd.offsets, X3),
                        lambda: torch.sparse.mm(csrP, X3.T),
                        ((k5 + 2 * NB3) * nP * 8, 2 * k5 * nP * NB3),
                        "banded_spmm_kernel",
                        f"config #3 ({NB3}, {nP}), torch.sparse.mm(CSR, X^T)"),
        "tridiag_exp_batched": (
            lambda: tt.tridiag_exp_e1_batched(A30, B30, t30, s30),
            lambda: tt.tridiag_exp_e1_batched_ref(A30, B30, t30, s30),
            k2_lib, tuple(NB3 * v for v in r1_work(30)),
            "tridiag_exp_kernel",
            f"m=30 batch {NB3}, batched torch.linalg.eigh + combination"),
        "resident_lanczos_batched": (
            lambda: tr.resident_lanczos(op1, V0, 40, 1e-7),
            lambda: tr.resident_lanczos_batched_ref(V0, op1.coeffs, offs1,
                                                    40, 1e-7),
            None, (NB2 * (N1 + 2 * 40) * 8, NB2 * 40 * N1 * (2 * 3 + 8)),
            "resident_lanczos_cluster_kernel", f"config #2 ({NB2}, {N1}) m=40"),
        "resident_recurrence_batched": (
            lambda: tr.resident_recurrence(op1, B2, rows, sc),
            lambda: tr.resident_recurrence_batched_ref(B2, rows, op1.coeffs,
                                                       offs1, sc),
            None, (NB2 * (2 * N1 + 4 * 40 + 1) * 8,
                   NB2 * (40 * N1 * (2 * 3 + 6) + 2 * N1)),
            "resident_nbr_kernel", f"config #2 ({NB2}, {N1}) m=40"),
    }
    pa = pair_in["pair"]
    stream = _build.raw_stream(pa.u.device)
    cases["banded_spmm_alpha"] = (
        lambda: pa.fa(pa.addr, stream), pair_in["plain_a"], None,
        ((k5 + 2 * NB3) * nP * 8, 2 * k5 * nP * NB3 + 3 * nP * NB3),
        "banded_spmm_kernel", f"config #3 ({NB3}, {nP}), step {PAIR_J}")
    cases["lanczos_update"] = (
        lambda: pa.fu(pa.addr, stream), pair_in["plain_u"], None,
        ((k5 + 3 * NB3) * nP * 8, 2 * k5 * nP * NB3 + 6 * nP * NB3),
        "lanczos_update_kernel", f"config #3 ({NB3}, {nP}), step {PAIR_J}")
    for name, (kfn, pfn, lfn, wk, kname, what) in cases.items():
        p1, k1, k2, p2 = (median_ms(f) for f in (pfn, kfn, kfn, pfn))
        kb = burst_ms(kfn)
        l1 = median_ms(lfn) if lfn is not None else None
        bms, bby = bound(*wk, "float64")
        km = statistics.median([k1, k2])
        kinfo[name] = (km, statistics.median([p1, p2]), l1, wk, errs[name])
        jobs.append((name, "float64", kfn, kname))
        print(f"time {name} float64 {what}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms, back-to-back {kb:.4f} ms"
              + (f", library {l1:.4f} ms" if l1 is not None else
                 ", no library call")
              + f"; bound {bms:.4f} ms by {bby} ({km / bms:.1f}x) {card}",
              flush=True)
    print(f"batched path: {time.perf_counter() - t_path:.1f} s; peak device "
          f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB {card}", flush=True)
    return dict(total), calls, kinfo, jobs


def batched_only(et, dev, card, profile: bool) -> int:
    """``--batched-only``: the eleventh path with its inputs made here,
    then its kernels' device times under torch.profiler and, with
    ``--profile``, one call of each cell in its graph form."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_

    counts, calls, _, jobs = batched_path(et, dev, card)
    print(f"kernel executions of the batched path: {counts}", flush=True)
    for name, dn, kfn, kname in jobs:
        kfn()
        torch.cuda.synchronize()
        with prof_(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kfn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and kname in e.name]
        print(f"device {name} {dn}: " + (
            f"{sum(e.time_range.elapsed_us() for e in evs) / 20e3:.4f} ms "
            f"a call (profiler, {len(evs)} launches in 20 calls)" if evs
            else "not measured (the profiler saw no launch)") + f" {card}",
            flush=True)
    if profile:
        krylov_graph_profile(calls, card, label="batched", forms=("graph",))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port's main path "
                                 "on one NVIDIA GPU (module doc).")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 4, profile the sparse, variable and "
                    "non-Hermitian main-path cells instead of timing "
                    "(phase 5)")
    ap.add_argument("--graphs-only", action="store_true",
                    help="run phases 1-2 and the sixth path alone (the "
                    "device loops from CUDA graphs, their references "
                    "computed on the spot); prints no result lines")
    ap.add_argument("--krylov-graphs-only", action="store_true",
                    help="run phases 1-2 and the seventh path alone (the "
                    "Krylov builders from CUDA graphs, their references "
                    "computed on the spot); prints no result lines")
    ap.add_argument("--serving-only", action="store_true",
                    help="run phases 1-2, R1 against its twin, the eighth "
                    "path (the serving closures and the error-estimate "
                    "loop, references computed on the spot) and R1's "
                    "times; prints no result lines")
    ap.add_argument("--poly-graphs-only", action="store_true",
                    help="run phases 1-2 and the tenth path alone (the "
                    "Chebyshev, Leja, Faber and Taylor loops from CUDA "
                    "graphs, inputs and references made on the spot); "
                    "prints no result lines")
    ap.add_argument("--batched-only", action="store_true",
                    help="run phases 1-2 and the eleventh path alone "
                    "(expv_batched as one batched build, inputs and "
                    "references made on the spot, its kernels' device "
                    "times last); prints no result lines")
    ap.add_argument("--fixed-fused-only", action="store_true",
                    help="run phases 1-2 and the ninth path alone (the "
                    "fixed NW stepper and the fused passes from CUDA "
                    "graphs, inputs made on the spot); prints no result "
                    "lines")
    # one rank of the fourth path, started by this script itself
    ap.add_argument("--shard-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--shard-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--shard-dir", help=argparse.SUPPRESS)
    ap.add_argument("--shard-mode", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.shard_rank is not None:
        if args.shard_mode.startswith("gspmd"):
            return gspmd_rank_main(args)
        return shard_rank_main(args)

    import exponentialutilities_jl_torch as et
    from exponentialutilities_jl_torch.models import chebyshev as tc
    from exponentialutilities_jl_torch.models import expv as tx
    from exponentialutilities_jl_torch.models import expv_taylor as tt
    from exponentialutilities_jl_torch.models.timestepping import _bucket_m
    from exponentialutilities_jl_torch.models import phiv as tpv
    from exponentialutilities_jl_torch.ops.kernels import _build
    from exponentialutilities_jl_torch.ops.kernels import dispatch as td
    from exponentialutilities_jl_torch.ops.kernels import lanczos_fused as tf
    from exponentialutilities_jl_torch.ops.kernels import resident as tr
    from exponentialutilities_jl_torch.utils import graphs

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    dname = {f32: "float32", f64: "float64"}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    phase_done("1 device")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, or loading an "
          f"earlier build) into {_build.BUILD_DIR}", flush=True)
    phase_done("2 build")
    if args.graphs_only:
        return graphs_only(et, dev, card, args.profile)
    if args.krylov_graphs_only:
        return krylov_graphs_only(et, dev, card, args.profile)
    if args.serving_only:
        return serving_only(et, dev, card, args.profile)
    if args.fixed_fused_only:
        return fixed_fused_only(et, dev, card, args.profile)
    if args.poly_graphs_only:
        return poly_graphs_only(et, dev, card, args.profile)
    if args.batched_only:
        return batched_only(et, dev, card, args.profile)

    rng = np.random.default_rng(SEED)
    rng2 = np.random.default_rng(SEED + 1)     # the inputs of B4-B6
    rng8 = np.random.default_rng(SEED + 8)     # B2's and B4's ragged shapes
    rng9 = np.random.default_rng(SEED + 9)     # B1 past its neighbour gate

    def vec(n, dt, gen=rng):
        return torch.as_tensor(gen.standard_normal(n), dtype=dt, device=dev)

    def scaled_rows(m, op, dt):
        """Random recurrence rows, ca scaled by 1/|A| (bounded growth)."""
        rows = vec(4 * m, dt, rng2).reshape(m, 4) * 0.5
        rows[:, 0] *= 2.0 / float(op.opnorm_hint())
        return rows

    def box27(shape, dt):
        offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                for c in (-1, 0, 1)]
        coeffs = [-26.0 if o == (0, 0, 0) else 1.0 for o in offs]
        return et.StencilOperator(shape, offs, np.asarray(coeffs),
                                  is_hermitian=True, dtype=dt, device=dev)

    def ops1(dt, five_point=False, n=N1):
        """The 1-D Laplacian, or the 4th-order 5-point one (|o| = 2)."""
        if five_point:
            return et.StencilOperator(
                (n,), [(-2,), (-1,), (0,), (1,), (2,)],
                np.asarray([-1 / 12, 4 / 3, -2.5, 4 / 3, -1 / 12]),
                is_hermitian=True, dtype=dt, device=dev)
        return et.laplacian_nd_stencil(n, dtype=dt, device=dev)

    def stencil1(n, offs, dt):
        """A 1-D stencil with the 2nd- (3 points) or 4th-order (5 points)
        Laplacian's coefficients on the offsets ``offs``."""
        cs = ([1.0, -2.0, 1.0] if len(offs) == 3 else
              [-1 / 12, 4 / 3, -2.5, 4 / 3, -1 / 12])
        return et.StencilOperator((n,), [(o,) for o in offs], np.asarray(cs),
                                  is_hermitian=True, dtype=dt, device=dev)

    def star13(shape, dt):
        offsets, coeffs = [(0, 0, 0)], [-7.5]
        for a in range(3):
            for s, c in ((-2, -1 / 12), (-1, 4 / 3), (1, 4 / 3), (2, -1 / 12)):
                off = [0, 0, 0]
                off[a] = s
                offsets.append(tuple(off))
                coeffs.append(c)
        return et.StencilOperator(shape, offsets, np.asarray(coeffs),
                                  is_hermitian=True, dtype=dt, device=dev)

    def sweep(op, Z, Vc, Vp, co, W=None):
        """One B3 sweep: (Y, Zn, moments (2,))."""
        out = tf.fused_lanczos_step(Z, Vc, Vp, co, op, w_accum=W)
        return out[0], out[1], torch.stack([out[2], out[3]])

    def var13(shape, dt, gen):
        """A wide (|o| = 2) non-symmetric 13-point variable operator with
        random positive fields."""
        offs = [(0, 0, 0)] + [tuple(s if i == a else 0 for i in range(3))
                              for a in range(3) for s in (-2, -1, 1, 2)]
        C = gen.uniform(0.2, 1.0, (len(offs), math.prod(shape)))
        C[0] = -C[1:].sum(axis=0)
        return et.VariableStencilOperator(shape, offs, C, dtype=dt,
                                          device=dev)

    def invariant_start(n, modes, dt):
        i = np.arange(1, n + 1)
        b = sum(np.sin(k * np.pi * i / (n + 1)) for k in modes)
        return torch.as_tensor(b, dtype=dt, device=dev)

    # The variable-coefficient operator of benchmarks/bench_var.py:61-63:
    # div(a grad u) on 216^3 with a ~ U(0.5, 2), fields built on the host
    t0 = time.perf_counter()
    aV = np.random.default_rng(SEED).uniform(0.5, 2.0, (N3, N3, N3))
    opV = {f64: et.variable_diffusion_nd_stencil(aV, device=dev),
           f32: et.variable_diffusion_nd_stencil(aV, dtype=np.float32,
                                                 device=dev)}
    del aV
    print(f"variable operator 216^3: {time.perf_counter() - t0:.1f} s (host "
          f"fields, {len(opV[f64].offsets)} per cell, copies to the card)",
          flush=True)

    # ---- 3. kernels against their twins ---------------------------------
    kerr = {}          # float64 max abs error at the main path's shapes
    for dt in (f32, f64):
        tol = KTOL[dname[dt]]
        for n in (1000, N1):
            for five in (False, True):
                op = ops1(dt, five, n)
                x = vec(n, dt)
                rows = vec(48, dt).reshape(12, 4) * 0.5
                w, nrm = tr.resident_recurrence(op, x, rows, 0.7)
                wr, nrr = tr.resident_recurrence_ref(
                    x, rows, op.coeffs, tr._flat_offsets(op),
                    torch.tensor(0.7, dtype=dt, device=dev))
                e = rel_max(w, wr)
                en = abs(float(nrm) - float(nrr)) / float(nrr)
                check(e <= tol and en <= tol, f"B1 {dname[dt]} n={n}")
                if dt == f64 and n == N1 and not five:
                    kerr["resident_recurrence"] = float((w - wr).abs().max())
                plan = tr.recurrence_plan(op, dt, dev)
                check(plan.form == "neighbour", f"B1 {dname[dt]} n={n}: "
                      f"{plan.form} form")
                print(f"kernel B1 {dname[dt]} n={n} points={len(op.offsets)}:"
                      f" rel err w {e:.2e}, sum w^2 {en:.2e} (tol {tol:g}); "
                      f"{plan.form} form, {plan.grid} blocks of {plan.chunk} "
                      f"rows", flush=True)
        # B1 past its neighbour gate (a block's state exceeds its shared
        # memory): the grid form, held to the twin
        n = B1_PAST_GATE[dname[dt]]
        op = ops1(dt, n=n)
        x = vec(n, dt, rng9)
        rows = vec(48, dt, rng9).reshape(12, 4) * 0.5
        rows[:, 0] *= 2.0 / float(op.opnorm_hint())
        plan = tr.recurrence_plan(op, dt, dev)
        w, nrm = tr.resident_recurrence(op, x, rows, 0.7)
        wr, nrr = tr.resident_recurrence_ref(
            x, rows, op.coeffs, tr._flat_offsets(op),
            torch.tensor(0.7, dtype=dt, device=dev))
        e = rel_max(w, wr)
        en = abs(float(nrm) - float(nrr)) / float(nrr)
        check(plan.form == "grid" and e <= tol and en <= tol,
              f"B1 {dname[dt]} n={n}: {plan.form} form, {e:.2e}, {en:.2e}")
        print(f"kernel B1 {dname[dt]} n={n} (past the neighbour gate): grid "
              f"form, rel err w {e:.2e}, sum w^2 {en:.2e} (tol {tol:g})",
              flush=True)
        op = ops1(dt)
        m = 40 if dt == f64 else 20     # float32 Lanczos drifts past ~20
        for start in ("random", "invariant"):
            b = vec(N1, dt) if start == "random" else invariant_start(
                N1, (300, 4000), dt)
            v0 = b / torch.linalg.vector_norm(b)
            btol = 1e-7 if dt == f64 else 1e-4
            ab = tr.resident_lanczos(op, v0, m, btol)
            ab2 = tr.resident_lanczos(op, v0, m, btol)
            abr = tr.resident_lanczos_ref(v0, op.coeffs, tr._flat_offsets(op),
                                          m, btol)
            e = rel_max(ab, abr)
            check(e <= tol, f"B2 {dname[dt]} {start}")
            check(torch.equal(ab, ab2), f"B2 {dname[dt]} bitwise repeat")
            if start == "invariant":
                live = int((ab[:, 1] > 0).sum())
                check(live == 1 and not bool(ab[2:].any()),
                      f"B2 {dname[dt]} breakdown after 2 steps ({live})")
            if dt == f64 and start == "random":
                kerr["resident_lanczos"] = float((ab - abr).abs().max())
            print(f"kernel B2 {dname[dt]} n={N1} m={m} {start}: rel err "
                  f"{e:.2e} (tol {tol:g}), bitwise repeat ok", flush=True)
        # B2 on ragged shapes: the cluster form with n not a multiple of
        # C x 1024, n < C (blocks without rows), max|o| = L = 2, 5 points,
        # m = 0 and 1; above its gate (float64 n = 3e5, float32 n = 6e5:
        # more rows a block than resident.CLUSTER_MAX_ROWS) the grid form
        btol = 1e-7 if dt == f64 else 1e-4
        for n, offs in ((N1, FIVE), (1023, THREE), (16 * 1024 + 1, FIVE),
                        (10, THREE), (3, THREE), (32, (-2, 0, 2)),
                        (B2_ABOVE_GATE[dname[dt]], THREE)):
            op = stencil1(n, offs, dt)
            form = tr.lanczos_plan(op, dt, dev).form
            want = "grid" if n == B2_ABOVE_GATE[dname[dt]] else "cluster"
            check(form == want, f"B2 {dname[dt]} n={n}: {form} form, not "
                  f"{want}")
            b = vec(n, dt, rng8)
            v0 = b / torch.linalg.vector_norm(b)
            errs = []
            for m in (0, 1, 12):
                ab = tr.resident_lanczos(op, v0, m, btol)
                ab2 = tr.resident_lanczos(op, v0, m, btol)
                abr = tr.resident_lanczos_ref(v0, op.coeffs, list(offs), m,
                                              btol)
                errs.append(rel_max(ab, abr) if m else 0.0)
                check(ab.shape == (m, 2) and errs[-1] <= tol
                      and torch.equal(ab, ab2),
                      f"B2 {dname[dt]} n={n} {offs} m={m}: {errs[-1]:.2e}")
            print(f"kernel B2 {dname[dt]} n={n} offsets={offs} m=0,1,12 "
                  f"({form} form): max rel err {max(errs):.2e} (tol {tol:g}),"
                  f" bitwise repeat ok", flush=True)
        # b in an invariant subspace of dimension exactly m: the breakdown
        # shows only at the last step's |y_m|; B2's pass 1 sets broke and
        # m_used as the plain lanczos_coeffs (on the card) and its twin do
        if dt == f64:
            from exponentialutilities_jl_torch.ops import krylov as tk

            op = ops1(dt)
            # modes across the spectrum: well-separated eigenvalues, so the
            # betas stay O(1) and the last |y_m| is roundoff, far below tol
            for modes in ((25000, 50000, 75000),
                          (10000, 25000, 40000, 55000, 70000, 85000)):
                m = len(modes)
                b = invariant_start(N1, modes, dt)
                res = tr.lanczos_coeffs_resident(op, b, m)
                pln = tk.lanczos_coeffs(op, b, m)
                twin = tr.lanczos_coeffs_resident(et.laplacian_nd_stencil(
                    N1, dtype=dt, device="cpu"), b.cpu(), m)
                got = [(bool(r[4]), int(r[3])) for r in (res, pln, twin)]
                check(got == [(True, m)] * 3, f"B2 invariant subspace m={m}: "
                      f"(broke, m_used) kernel, plain, twin {got}")
                e = rel_max(res[0], pln[0])
                check(e <= 1e2 * tol, f"B2 invariant m={m}: alphas {e:.2e}")
                print(f"kernel B2 float64 n={N1} b in an invariant subspace "
                      f"of dimension m={m}: broke and m_used = (True, {m}) "
                      f"for the kernel, the plain lanczos_coeffs and the "
                      f"twin; alphas {e:.2e} from the plain pass", flush=True)
        # the ragged shapes: 3 planes of 700 x 900 (more column tiles than
        # the card holds blocks: one z chunk), one plane as a 3-D grid, a
        # 2-D grid, the 27-point box
        for label, op in (("216^3 7-point",
                           et.laplacian_nd_stencil(N3, N3, N3, dtype=dt,
                                                   device=dev)),
                          ("5x7x130 7-point",
                           et.laplacian_nd_stencil(5, 7, 130, dtype=dt,
                                                   device=dev)),
                          ("48x40x64 13-point", star13((48, 40, 64), dt)),
                          ("3x700x900 7-point (one z chunk)",
                           et.laplacian_nd_stencil(3, 700, 900, dtype=dt,
                                                   device=dev)),
                          ("1x513x517 7-point",
                           et.laplacian_nd_stencil(1, 513, 517, dtype=dt,
                                                   device=dev)),
                          (f"{NG + 1}x{NG - 3} 2-D 5-point",
                           et.laplacian_nd_stencil(NG + 1, NG - 3, dtype=dt,
                                                   device=dev)),
                          ("23x45x71 27-point box", box27((23, 45, 71), dt))):
            n = op.shape[0]
            Z, Vc, Vp, W = (vec(n, dt) for _ in range(4))
            co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
            W1, W2 = W.clone(), W.clone()
            _build.reset_launch_counts()
            Y, Zn, mom = sweep(op, Z, Vc, Vp, co, W1)
            check(_build.launches["fused_sweep"] == 1
                  and _build.launches["sweep_stage"] == 1,
                  f"B3 {label}: one sweep and one stage")
            _, _, mom_again = sweep(op, Z, Vc, Vp, co, W.clone())
            Yp, Znp, momp = sweep(op, Z, Vc, Vp, co[:3].contiguous())
            Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                               op.offsets, op.coeffs, W2)
            errs = [rel_max(a, b) for a, b in ((Y, Yr), (Zn, Znr),
                                               (mom, momr), (W1, W2),
                                               (Yp, Yr), (Znp, Znr))]
            check(max(errs) <= tol, f"B3 {dname[dt]} {label}: {errs}")
            check(torch.equal(mom, mom_again) and torch.equal(mom, momp),
                  f"B3 {dname[dt]} {label} bitwise moments")
            if dt == f64 and label.startswith("216"):
                kerr["fused_sweep"] = max(float((a - b).abs().max()) for a, b in
                                          ((Y, Yr), (Zn, Znr), (W1, W2)))
            print(f"kernel B3 {dname[dt]} {label} plain+accum: max rel err "
                  f"{max(errs):.2e} (tol {tol:g}), bitwise moments ok",
                  flush=True)
        # B3-var: the 216^3 field operator, a 2-D one at config #3's size
        # and a wide 13-point one; the fields read at the output cell
        rngV = np.random.default_rng(SEED + 6)
        for label, op in (("216^3 div(a grad u)", opV[dt]),
                          (f"{NP}x{NP} 2-D div(a grad u)",
                           et.variable_diffusion_nd_stencil(
                               rngV.uniform(0.5, 2.0, (NP, NP)), dtype=dt,
                               device=dev)),
                          ("48x40x64 13-point random fields",
                           var13((48, 40, 64), dt, rngV))):
            n = op.shape[0]
            Z, Vc, Vp, W = (vec(n, dt, rngV) for _ in range(4))
            co = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=dt, device=dev)
            W1, W2 = W.clone(), W.clone()
            _build.reset_launch_counts()
            Y, Zn, mom = sweep(op, Z, Vc, Vp, co, W1)
            check(_build.launches["fused_sweep_var"] == 1
                  and _build.launches["sweep_stage"] == 1,
                  f"B3-var {label}: one sweep and one stage")
            _, _, mom_again = sweep(op, Z, Vc, Vp, co, W.clone())
            Yp, Znp, momp = sweep(op, Z, Vc, Vp, co[:3].contiguous())
            Yr, Znr, momr = tf.fused_sweep_ref(Z, Vc, Vp, co, op.grid_shape,
                                               op.offsets, op.coeff_fields,
                                               W2)
            errs = [rel_max(a, b) for a, b in ((Y, Yr), (Zn, Znr),
                                               (mom, momr), (W1, W2),
                                               (Yp, Yr), (Znp, Znr))]
            check(max(errs) <= tol, f"B3-var {dname[dt]} {label}: {errs}")
            check(torch.equal(mom, mom_again) and torch.equal(mom, momp),
                  f"B3-var {dname[dt]} {label} bitwise moments")
            if dt == f64 and label.startswith("216"):
                kerr["fused_sweep_var"] = max(
                    float((a - b).abs().max())
                    for a, b in ((Y, Yr), (Zn, Znr), (W1, W2)))
            print(f"kernel B3-var {dname[dt]} {label} plain+accum: max rel "
                  f"err {max(errs):.2e} (tol {tol:g}), bitwise moments ok",
                  flush=True)
        # B3 and B3-var on every extended slab of the fourth path, with
        # the interior plane range, against the twin (slab_checks)
        slab_checks(et, dev, dt, tol, opV[dt],
                    np.random.default_rng(SEED + 15))
        del op
        # B4: p = 4 accumulators over one omega chain, 1-D n = 1e5
        op = ops1(dt)
        x = vec(N1, dt, rng2)
        rows = scaled_rows(12, op, dt)
        cw = vec(48, dt, rng2).reshape(12, 4)
        W = tr.recurrence_apply_resident_multi(op, x, rows, cw)
        Wr = tr.resident_multi_ref(x, rows, cw, op.coeffs,
                                   tr._flat_offsets(op))
        e = rel_max(W, Wr)
        check(e <= tol, f"B4 {dname[dt]}: {e:.2e}")
        if dt == f64:
            kerr["resident_multi"] = float((W - Wr).abs().max())
        print(f"kernel B4 {dname[dt]} n={N1} p=4 m=12: rel err {e:.2e} "
              f"(tol {tol:g})", flush=True)
        # B4's neighbour form against the family kernel, bit for bit (both
        # compute a row with the same functions), and against the twin: p =
        # 1, 4, 8; 3 and 5 points; ragged chunks (n = 777 on 4 blocks of
        # 195 rows, n = 300 with max|o| = chunk = 150, n = 5 on one block)
        for n, offs in ((N1, THREE), (N1, FIVE), (777, THREE),
                        (300, (-150, 0, 150)), (5, THREE)):
            op = stencil1(n, offs, dt)
            plan = tr.multi_plan(op, dt, dev)
            family = tr.MultiPlan(op, dt, dev, form="family")
            x = vec(n, dt, rng8)
            for p in (1, 4, 8):
                rows = vec(48, dt, rng8).reshape(12, 4) * 0.5
                rows[:, 0] *= 2.0 / float(op.opnorm_hint())
                cw = vec(12 * p, dt, rng8).reshape(12, p)
                check(plan.form(p) == "neighbour",
                      f"B4 {dname[dt]} n={n} p={p}: {plan.form(p)} form")
                W = tr.recurrence_apply_resident_multi(op, x, rows, cw)
                Wf = family(x, rows, cw)
                Wr = tr.resident_multi_ref(x, rows, cw, op.coeffs, list(offs))
                e = rel_max(W, Wr)
                check(torch.equal(W, Wf) and e <= tol,
                      f"B4 {dname[dt]} n={n} {offs} p={p}: neighbour vs "
                      f"family bitwise {torch.equal(W, Wf)}, {e:.2e}")
            print(f"kernel B4 {dname[dt]} n={n} offsets={offs} p=1,4,8 m=12 "
                  f"(neighbour form, {plan.grid} blocks of {plan.chunk} "
                  f"rows): equals the family kernel bit for bit, rel err "
                  f"{e:.2e} (tol {tol:g})", flush=True)
        # config #2's plans: B2 on one cluster, B4 (p = K + 1) on neighbours
        op = ops1(dt)
        lp = tr.lanczos_plan(op, dt, dev)
        check(lp.form == "cluster" and tr.multi_plan(op, dt, dev).form(K + 1)
              == "neighbour", f"config #2 {dname[dt]}: B2 {lp.form} form, "
              f"B4 {tr.multi_plan(op, dt, dev).form(K + 1)} form")
        print(f"config #2 {dname[dt]} plans: B2 cluster form, {lp.cluster} "
              f"blocks; B4 neighbour form", flush=True)
        # B5: config #3's operator, and the 1-D Laplacian in banded storage
        for label, op in ((f"poisson_2d({NP}, {NP})",
                           et.poisson_2d(NP, NP, dtype=dt, device=dev)),
                          (f"laplacian_1d({N1})",
                           et.laplacian_1d(N1, dtype=dt, device=dev))):
            x = vec(op.shape[0], dt, rng2)
            rows = scaled_rows(12, op, dt)
            w = tr.recurrence_apply_resident_banded(op, x, rows)
            wr = tr.resident_banded_ref(x, rows, op.diags, op.offsets)
            e = rel_max(w, wr)
            check(e <= tol, f"B5 {dname[dt]} {label}: {e:.2e}")
            if dt == f64 and label.startswith("poisson"):
                kerr["resident_banded"] = float((w - wr).abs().max())
            # the neighbour form, bit for bit against the family kernel
            plan = tr.banded_plan(op, dt, dev)
            wf = tr.BandedRecurrencePlan(op, dt, dev, form="family")(x, rows)
            check(plan.form == "neighbour" and torch.equal(w, wf),
                  f"B5 {dname[dt]} {label}: {plan.form} form, bitwise "
                  f"{torch.equal(w, wf)}")
            print(f"kernel B5 {dname[dt]} {label} m=12: rel err {e:.2e} "
                  f"(tol {tol:g}); {plan.form} form, {plan.grid} blocks of "
                  f"{plan.chunk} rows, {plan.kd} of {plan.k} diagonals in "
                  f"shared memory, equals the family kernel bit for bit",
                  flush=True)
        # B6: 2-D 512^2 5-point, 3-D 64^3 7-point and 27-point box, on the
        # main path's form (the neighbour form: tiles of whole x-lines),
        # against the twin and bit for bit against the family kernel
        for label, op in ((f"{NG}^2 5-point",
                           et.laplacian_nd_stencil(NG, NG, dtype=dt,
                                                   device=dev)),
                          ("64^3 7-point",
                           et.laplacian_nd_stencil(64, 64, 64, dtype=dt,
                                                   device=dev)),
                          ("64^3 27-point box", box27((64, 64, 64), dt))):
            x = vec(op.shape[0], dt, rng2)
            rows = scaled_rows(12, op, dt)
            plan = tr.grid_plan(op, dt, dev)
            w = tr.recurrence_apply_resident_grid(op, x, rows)
            wr = tr.resident_grid_ref(x, rows, op.grid_shape, op.offsets,
                                      op.coeffs)
            wf = tr.GridRecurrencePlan(op, dt, dev, form="family")(x, rows)
            e = rel_max(w, wr)
            check(plan.form == "neighbour" and e <= tol
                  and torch.equal(w, wf),
                  f"B6 {dname[dt]} {label}: {plan.form} form, {e:.2e}, "
                  f"bitwise vs family {torch.equal(w, wf)}")
            if dt == f64 and label.startswith(f"{NG}"):
                kerr["resident_grid"] = float((w - wr).abs().max())
            t = plan.tiles
            print(f"kernel B6 {dname[dt]} {label} m=12: rel err {e:.2e} "
                  f"(tol {tol:g}); {plan.form} form, {t.grid} tiles of "
                  f"{t.tz} x {t.ty} lines ({t.tiles_z} x {t.tiles_y}; halo "
                  f"{t.hz} planes, {t.hy} lines), {plan.smem} bytes of "
                  f"shared memory a block, equals the family kernel bit for "
                  f"bit", flush=True)
        # the non-symmetric stencils: B1, B5, B6 and B3 with the rows of
        # the Leja and Faber actions
        nonsym_kernel_checks(et, dev, dt, tol, vec,
                             np.random.default_rng(SEED + 10))
    del Z, Vc, Vp, W, W1, W2, Y, Zn, Yp, Znp, Yr, Znr

    # B7-B10, the sparse containers' SpMV kernels: packed once in float64
    # on the host (the JAX package's own packers), cast on the card
    import scipy.sparse as sp
    from exponentialutilities_jl_torch.ops.kernels import sell as ts
    from exponentialutilities_jl_torch.ops.kernels import spmv as tsp

    rng3 = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    sell_coo = bench_sell_coo(NS, 8, 700, rng3)
    r, c, v = bench_sell_coo(100_000, 8, 700, rng3)
    keep = r % 997 != 0                              # empty rows
    dup = rng3.integers(0, int(keep.sum()), 20_000)  # duplicate entries
    r, c, v = r[keep], c[keep], v[keep]
    dup_coo = (np.concatenate([r, r[dup]]), np.concatenate([c, c[dup]]),
               np.concatenate([v, v[dup]]))
    wide_coo = bench_sell_coo(NS, 8, 20_000, rng3)
    packs = {"bench_sell n=1e6 default": ts.sell_pack(sell_coo, NS,
                                                      np.float64, device=dev),
             "bench_sell n=1e6 bucketed": ts.sell_pack_bucketed(
                 sell_coo, NS, np.float64, device=dev),
             "empty rows + duplicates n=1e5": ts.sell_pack(
                 dup_coo, 100_000, np.float64, device=dev),
             "band 20000 n=1e6": ts.sell_pack(wide_coo, NS, np.float64,
                                              device=dev)}
    A_wide = sp.coo_matrix((wide_coo[2], wide_coo[:2]), shape=(NS, NS)).tocsr()
    seg = ts.sell_pack_seg(scattered_coo(NS, rng3), NS, np.float64,
                           seg_len=16, device=dev)
    r, c, v = bench_sell_coo(3001, 6, 400, rng3)
    keep = ~np.isin(r, np.r_[256:300, 1000, 3000])     # empty rows
    seg_ragged = ts.sell_pack_seg(
        (np.concatenate([r[keep], np.full(5000, 700)]),
         np.concatenate([c[keep], np.arange(5000) % 3001]),
         np.concatenate([v[keep], np.ones(5000)])), 3001, np.float64,
        seg_len=1, device=dev)
    opB3 = et.blockell_from_scipy(laplacian_3d_csr(NB), 8, is_hermitian=True,
                                  dtype=np.float64, device=dev)
    nbr4 = 16_384                          # random 4 x 4 block-sparse matrix
    pat = sp.random(nbr4, nbr4, density=8 / nbr4, random_state=SEED,
                    format="csr")
    A4 = sp.kron(pat, np.ones((4, 4)), format="csr")
    A4.data = rng3.standard_normal(A4.nnz)
    opB4 = et.blockell_from_scipy(A4, 4, dtype=np.float64, device=dev)
    print(f"sparse packs: {time.perf_counter() - t0:.1f} s (host: COO, "
          f"SELL-C-sigma and block-ELL packs, copies to the card)", flush=True)

    def spmv_check(label, dt, kern, ref, key=None):
        """kernel vs twin within KTOL and a bitwise repeat; returns y."""
        tol = KTOL[dname[dt]]
        y, y2, yr = kern(), kern(), ref()
        e = rel_max(y, yr)
        check(e <= tol, f"{label} {dname[dt]}: {e:.2e}")
        check(torch.equal(y, y2), f"{label} {dname[dt]} bitwise repeat")
        if key and dt == f64:
            kerr[key] = float((y - yr).abs().max())
        print(f"kernel {label} {dname[dt]}: rel err {e:.2e} (tol {tol:g}), "
              f"bitwise repeat ok", flush=True)
        return y

    def stage_share(label, d, want=None):
        """Print (and with ``want`` check) the share of B9's 256-row blocks
        that stage their x window in shared memory."""
        share = float(ts.stage_blocks(d).double().mean())
        print(f"stage {label}: {share:.1%} of "
              f"{-(-d.nslices * ts.SLICE // ts.ROWS_PER_BLOCK)} blocks stage x "
              f"(launch budget {d.stage_cap} values)", flush=True)
        if want is not None:
            check(share == want, f"{label} staged share {share}")
        return share

    def banded_bits(label, dt, D, offs, x, y):
        """B7 through the public entry on offset views of x and of the
        diagonals (scalar loads), and with every block an edge block (a
        zero diagonal of offset n appended: exact zeros after the sum),
        bit for bit against y."""
        n = D.shape[1]
        xo = torch.empty(n + 1, dtype=dt, device=dev)[1:].copy_(x)
        Do = torch.empty(D.numel() + 1, dtype=dt, device=dev)[1:]
        Do = Do.view(D.shape).copy_(D)
        check(torch.equal(tsp.banded_spmv(D, offs, xo), y)
              and torch.equal(tsp.banded_spmv(Do, offs, xo), y),
              f"B7 {label} {dname[dt]}: unaligned operands change bits")
        if len(offs) < _build.MAX_POINTS:
            Dz = torch.cat([D, torch.zeros_like(D[:1])])
            check(torch.equal(tsp.banded_spmv(Dz, offs + (n,), x), y),
                  f"B7 {label} {dname[dt]}: edge and interior blocks differ")
        print(f"kernel B7 {label} {dname[dt]}: offset views of x and diags "
              "and all-edge blocks give the same bits", flush=True)

    for dt in (f32, f64):
        for label, op in ((f"poisson_2d({NP}, {NP})",
                           et.poisson_2d(NP, NP, dtype=dt, device=dev)),
                          (f"laplacian_1d({N1})",
                           et.laplacian_1d(N1, dtype=dt, device=dev)),
                          ("advection_diffusion_1d(2000)",
                           et.advection_diffusion_1d(2000, dtype=dt,
                                                     device=dev))):
            x = vec(op.shape[0], dt, rng2)
            y = spmv_check(f"B7 {label}", dt, lambda: op.matvec(x),
                           lambda: tsp.banded_spmv_ref(op.diags, op.offsets,
                                                       x),
                           "banded_spmv" if label.startswith("poisson")
                           else None)
            banded_bits(label, dt, op.diags, op.offsets, x, y)
        # ragged: n odd (diagonal rows not 16-byte aligned), n under one
        # block, offsets at least n wide, one and MAX_POINTS diagonals
        for label, n, offs in (
                ("n=100001 odd", 100_001, (-317, -1, 0, 1, 317)),
                ("n=100", 100, (-7, 0, 2)),
                ("n=777 |o|>=n", 777, (-900, -776, 0, 776, 1000)),
                ("k=1", 4096, (3,)),
                (f"k={_build.MAX_POINTS}", 30_000, tuple(range(-32, 32)))):
            D = vec(len(offs) * n, dt, rng2).reshape(len(offs), n)
            x = vec(n, dt, rng2)
            y = spmv_check(f"B7 ragged {label}", dt,
                           lambda: tsp.banded_spmv(D, offs, x),
                           lambda: tsp.banded_spmv_ref(D, offs, x))
            banded_bits(f"ragged {label}", dt, D, offs, x, y)
        for label, op in ((f"{NB}^3 7-point 8x8 blocks", opB3),
                          (f"random {4 * nbr4} 4x4 blocks", opB4)):
            blocks = op.blocks.to(dt)
            x = vec(op.shape[0], dt, rng2)
            y = spmv_check(f"B8 {label} w={blocks.shape[1]}", dt,
                           lambda: tsp.blockell_spmv(blocks, op.bcols, x),
                           lambda: tsp.blockell_spmv_ref(blocks, op.bcols, x),
                           "blockell_spmv" if label.startswith(f"{NB}")
                           else None)
            # offset views (not 16-byte aligned): the aligned copies' bits
            xo = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
            bo = torch.empty(blocks.numel() + 1, dtype=dt, device=dev)[1:]
            bo = bo.view(blocks.shape).copy_(blocks)
            check(torch.equal(tsp.blockell_spmv(blocks, op.bcols,
                                                xo.copy_(x)), y)
                  and torch.equal(tsp.blockell_spmv(bo, op.bcols, xo), y),
                  f"B8 {label} {dname[dt]}: unaligned operands change bits")
            print(f"kernel B8 {label} {dname[dt]}: offset views of x and "
                  "blocks give the aligned result bit for bit", flush=True)
            del xo, bo
        del blocks
        # B7 on the GSPMD route's halo-extended slabs, B8 on a rank's block
        # rows against the whole x (the fifth path's products)
        gspmd_kernel_checks(et, dev, dt, KTOL[dname[dt]], opB3,
                            np.random.default_rng(SEED + 17))
        for label, d64 in packs.items():
            d = d64.to(dtype=dt)
            x = vec(d.n, dt, rng2)
            y = spmv_check(f"B9 {label}", dt, lambda: ts.sell_spmv(d, x),
                           lambda: ts.sell_spmv_ref(d, x),
                           "sell_spmv" if label.endswith("default") else None)
            stage_share(f"B9 {label} {dname[dt]}", d,
                        0.0 if label.startswith("band") else None)
            if label.startswith("band") and dt == f64:
                e = rel_max(y.cpu(), torch.as_tensor(A_wide @ x.cpu().numpy()))
                check(e <= KTOL["float64"], f"B9 {label} vs scipy {e:.2e}")
                print(f"check B9 {label}: vs scipy {e:.2e} (the TPU window "
                      "refused this band)", flush=True)
        d = seg.to(dtype=dt)
        stage_share(f"B9 scattered n=1e6 seg L=16 {dname[dt]}", d.base)
        x = vec(NS, dt, rng2)
        p = ts.sell_spmv(d.base, x)
        y = spmv_check(f"B10 scattered n=1e6 seg L=16 ({d.base.n} segments)",
                       dt, lambda: ts.seg_compact(p, d.seg_ptr),
                       lambda: ts.seg_compact_ref(p, d.seg_ptr), "seg_compact")
        spmv_check("B9+B10 sell_spmv_seg scattered n=1e6", dt,
                   lambda: ts.sell_spmv_seg(d, x),
                   lambda: ts.sell_spmv_seg_ref(d, x))
        check(torch.equal(ts.launch_plan(d)(x), y),
              "B10: the pack's plan and seg_compact differ")
        # ragged: a row of 5000 one-entry segments, empty rows, n = 3001
        d = seg_ragged.to(dtype=dt)
        x = vec(d.n, dt, rng2)
        p = ts.sell_spmv(d.base, x)
        y = spmv_check(f"B10 ragged n={d.n} L=1 ({d.base.n} segments)", dt,
                       lambda: ts.seg_compact(p, d.seg_ptr),
                       lambda: ts.seg_compact_ref(p, d.seg_ptr))
        check(torch.equal(ts.launch_plan(d)(x), y),
              "B10 ragged: the pack's plan and seg_compact differ")
    del packs, seg, seg_ragged, opB4, d, x, p, y
    kerr["tridiag_exp"] = tridiag_checks(et, dev)
    phase_done("3 kernels")

    # ---- 4. the main path through the public entry points ---------------
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    op1 = {dt: ops1(dt) for dt in (f32, f64)}
    op3 = {dt: et.laplacian_nd_stencil(N3, N3, N3, dtype=dt, device=dev)
           for dt in (f32, f64)}
    b1np = rng.standard_normal(N1)
    b3np = rng.standard_normal(N3 ** 3)
    b1 = {dt: torch.as_tensor(b1np, dtype=dt, device=dev) for dt in (f32, f64)}
    b3 = {dt: torch.as_tensor(b3np, dtype=dt, device=dev) for dt in (f32, f64)}

    opP = et.poisson_2d(NP, NP, device=dev)          # config #3, float64
    bP = torch.as_tensor(rng2.standard_normal(NP * NP), device=dev)
    opG = et.laplacian_nd_stencil(NG, NG, device=dev)
    bG = torch.as_tensor(rng2.standard_normal(NG * NG), device=dev)
    B1 = torch.stack([b1[f64], b1[f64]], dim=1)     # phi_0 b + t phi_1 b

    for dt in (f32, f64):
        check(td.recurrence_engine(op1[dt], dt, device=dev)
              is tr.recurrence_apply_resident, "1-D engine is B1")
        check(td.recurrence_engine(op3[dt], dt, device=dev, hermitian=True)
              is tf.recurrence_apply_fused, "3-D engine is B3")
    check(td.recurrence_engine(opP, f64, device=dev, hermitian=True)
          is tr.recurrence_apply_resident_banded, "config #3 engine is B5")
    check(td.recurrence_engine(opG, f64, device=dev, hermitian=True)
          is tr.recurrence_apply_resident_grid, "512^2 engine is B6")

    calls = {
        "1d cheb f32": lambda: et.expv_chebyshev(T1, op1[f32], b1[f32]),
        "1d cheb f64": lambda: et.expv_chebyshev(T1, op1[f64], b1[f64],
                                                 tol=1e-12),
        "1d two-pass m=40 f64": lambda: et.expv(T1, op1[f64], b1[f64], m=40,
                                                two_pass=True),
        "1d happy-breakdown m=30 f64": lambda: et.expv(T1, op1[f64], b1[f64],
                                                       m=30),
        # the reduced tridiagonal on host scipy between the kernels' passes
        "1d two-pass m=40 f64 reduced=host": lambda: et.expv(
            T1, op1[f64], b1[f64], m=40, two_pass=True, reduced="host"),
    }
    for dt in (f32, f64):
        tol = 1e-12 if dt == f64 else 1e-7
        calls[f"3d cheb {dname[dt][-2:]}"] = (
            lambda dt=dt, tol=tol: et.expv_chebyshev(T3, op3[dt], b3[dt],
                                                     tol=tol))
        calls[f"3d two-pass m=20 {dname[dt][-2:]}"] = (
            lambda dt=dt: et.expv(T3, op3[dt], b3[dt], m=20, two_pass=True))
    expect = {   # kernel launches each call must make
        "1d cheb f32": {"resident_recurrence": 1},
        "1d cheb f64": {"resident_recurrence": 1},
        # R1 (tridiag_exp): the Hermitian reduced exponential, once a call
        "1d two-pass m=40 f64": {"resident_lanczos": 1,
                                 "resident_recurrence": 1, "tridiag_exp": 1},
        "1d two-pass m=40 f64 reduced=host": {"resident_lanczos": 1,
                                              "resident_recurrence": 1},
        "1d happy-breakdown m=30 f64": {"tridiag_exp": 1},
        # two-pass m = 20: 21 sweeps a pass, each with its second stage
        "3d two-pass m=20 32": {"fused_sweep": 42, "sweep_stage": 42,
                                "tridiag_exp": 1},
        "3d two-pass m=20 64": {"fused_sweep": 42, "sweep_stage": 42,
                                "tridiag_exp": 1},
    }
    phi_calls = {     # float64
        "1d phiv two-pass m=40": lambda: et.phiv(T1, op1[f64], b1[f64], K,
                                                 m=40, two_pass=True),
        "1d phiv_chebyshev": lambda: et.phiv_chebyshev(
            T1, op1[f64], b1[f64], K, tol=1e-12),
        "1d phiv m=30": lambda: et.phiv(T1, op1[f64], b1[f64], K, m=30),
        "1d phiv_timestep_chebyshev": lambda: et.phiv_timestep_chebyshev(
            [0.25, 0.5], op1[f64], B1, tol=1e-12),
        "config3 phiv m=30": lambda: et.phiv(TP, opP, bP, K, m=30),
        "config3 expv_chebyshev": lambda: et.expv_chebyshev(TP, opP, bP,
                                                            tol=1e-12),
        "2d cheb": lambda: et.expv_chebyshev(TG, opG, bG, tol=1e-12),
        "2d two-pass m=20": lambda: et.expv(TG, opG, bG, m=20,
                                            two_pass=True),
    }
    expect.update({
        "1d phiv two-pass m=40": {"resident_lanczos": 1, "resident_multi": 1},
        "1d phiv_chebyshev": {"resident_multi": 1},
        "1d phiv m=30": {},
        "1d phiv_timestep_chebyshev": {"resident_multi": 2},
        "config3 phiv m=30": {"banded_spmv": 30},     # one B7 per matvec
        "config3 expv_chebyshev": {"resident_banded": 1},
        "2d cheb": {"resident_grid": 1},
        "2d two-pass m=20": {"fused_sweep": 42, "sweep_stage": 42,
                             "tridiag_exp": 1},
    })

    # the sparse containers at n = 1e6, float64 (module doc)
    t0 = time.perf_counter()
    rng4 = np.random.default_rng(SEED + 3)
    A_sell = symmetrized(bench_sell_coo(NS, 8, 700, rng4), NS, rng4)
    opS = et.SellOperator.from_scipy(A_sell, rcm=True, is_hermitian=True,
                                     dtype=np.float64, device=dev)
    perm = torch.as_tensor(opS.perm, device=dev).long()
    bSnp = rng4.standard_normal(NS)
    bS = torch.as_tensor(bSnp, device=dev)[perm]     # into the RCM basis
    A_scat = symmetrized(scattered_coo(NS, rng4), NS)
    sc_ops = {mode: et.SellOperator.from_scipy(A_scat, mode=mode,
                                               is_hermitian=True,
                                               dtype=np.float64, device=dev)
              for mode in (None, "seg", "sorted")}
    bC = torch.as_tensor(rng4.standard_normal(NS), device=dev)
    A_res = symmetrized(bench_sell_coo(NP * NP, 2, 700, rng4), NP * NP)
    A_hyb = (banded_csr(et.poisson_2d(NP, NP, device=dev)) + A_res).tocsr()
    opH = et.hybrid_from_scipy(A_hyb, min_fill=0.4, dtype=np.float64,
                               is_hermitian=True, device=dev)
    check(opH.banded.offsets == (-NP, -1, 0, 1, NP),
          f"hybrid dense diagonals {opH.banded.offsets}")
    opHs = et.SellOperator.from_scipy(A_hyb, is_hermitian=True,
                                      dtype=np.float64, device=dev)
    bH = torch.as_tensor(rng4.standard_normal(NP * NP), device=dev)
    op3b = et.laplacian_nd_stencil(NB, NB, NB, device=dev)
    bB = torch.as_tensor(rng4.standard_normal(NB ** 3), device=dev)
    check(stage_share("B9 symmetrized bench_sell n=1e6 after RCM", opS.data)
          > 0.5, "the RCM'd pack stages x in most blocks")
    for mode, op in sc_ops.items():
        stage_share(f"B9 scattered n=1e6 {mode or 'default'}",
                    op.data.base if mode == "seg" else
                    op.inner.data if mode == "sorted" else op.data)
    print(f"sparse main-path operators: {time.perf_counter() - t0:.1f} s "
          f"(host packs; SELL nnz {opS.nnz}, scattered nnz "
          f"{sc_ops[None].nnz}, hybrid residual nnz {opH.sell.nnz})",
          flush=True)
    sparse_calls = {
        "sell expv m=40": lambda: et.expv(TS, opS, bS, m=40),
        "sell expv two-pass m=40": lambda: et.expv(TS, opS, bS, m=40,
                                                   two_pass=True),
        "sell expv_chebyshev": lambda: et.expv_chebyshev(TS, opS, bS,
                                                         tol=1e-12),
        "scattered default expv m=40": lambda: et.expv(TS, sc_ops[None], bC,
                                                       m=40),
        "scattered seg expv m=40": lambda: et.expv(TS, sc_ops["seg"], bC,
                                                   m=40),
        "scattered sorted expv m=40": lambda: et.expv(TS, sc_ops["sorted"],
                                                      bC, m=40),
        "scattered sorted phiv m=30": lambda: et.phiv(TS, sc_ops["sorted"],
                                                      bC, K, m=30),
        "hybrid expv m=40": lambda: et.expv(TS, opH, bH, m=40),
        "hybrid matrix default pack expv m=40": lambda: et.expv(TS, opHs, bH,
                                                                m=40),
        f"blockell {NB}^3 two-pass m=20": lambda: et.expv(
            T3, opB3, bB, m=20, two_pass=True),
        f"stencil {NB}^3 two-pass m=20": lambda: et.expv(
            T3, op3b, bB, m=20, two_pass=True),
    }
    expect.update({     # one SpMV launch per matvec (B10 beside B9 for seg)
        "sell expv m=40": {"sell_spmv": 40, "tridiag_exp": 1},
        "sell expv two-pass m=40": {"sell_spmv": 80, "tridiag_exp": 1},
        # spectral_bounds: 2 seeded probes x 30 Lanczos steps, then the
        # degree 12 of tol 1e-12 on those bounds
        "sell expv_chebyshev": {"sell_spmv": 72},
        "scattered default expv m=40": {"sell_spmv": 40, "tridiag_exp": 1},
        "scattered seg expv m=40": {"sell_spmv": 40, "seg_compact": 40,
                                    "tridiag_exp": 1},
        "scattered sorted expv m=40": {"sell_spmv": 40, "tridiag_exp": 1},
        "scattered sorted phiv m=30": {"sell_spmv": 30},
        "hybrid expv m=40": {"banded_spmv": 40, "sell_spmv": 40,
                             "tridiag_exp": 1},
        "hybrid matrix default pack expv m=40": {"sell_spmv": 40,
                                                 "tridiag_exp": 1},
        f"blockell {NB}^3 two-pass m=20": {"blockell_spmv": 40,
                                           "tridiag_exp": 1},
        f"stencil {NB}^3 two-pass m=20": {"fused_sweep": 42,
                                          "sweep_stage": 42,
                                          "tridiag_exp": 1},
    })

    # the variable-coefficient path (B3-var): 216^3 in both dtypes, and a
    # 48^3 field small enough for scipy
    rng5 = np.random.default_rng(SEED + 5)
    bVnp = rng5.standard_normal(N3 ** 3)
    bV = {dt: torch.as_tensor(bVnp, dtype=dt, device=dev) for dt in (f32, f64)}
    del bVnp
    opV48 = et.variable_diffusion_nd_stencil(
        rng5.uniform(0.5, 2.0, (NV, NV, NV)), device=dev)
    bV48np = rng5.standard_normal(NV ** 3)
    bV48 = torch.as_tensor(bV48np, device=dev)
    for dt in (f32, f64):
        check(td.recurrence_engine(opV[dt], dt, device=dev, hermitian=True)
              is tf.recurrence_apply_fused, "216^3 variable engine is B3-var")
    var_calls = {}
    cheb_tol = {f32: 1e-7, f64: 1e-12}
    for dt in (f32, f64):
        sfx = dname[dt][-2:]
        var_calls[f"var cheb {sfx}"] = (
            lambda dt=dt: et.expv_chebyshev(T3, opV[dt], bV[dt],
                                            tol=cheb_tol[dt]))
        var_calls[f"var two-pass m=20 {sfx}"] = (
            lambda dt=dt: et.expv(T3, opV[dt], bV[dt], m=20, two_pass=True))
        expect[f"var two-pass m=20 {sfx}"] = {"fused_sweep_var": 42,
                                               "sweep_stage": 42,
                                               "tridiag_exp": 1}
    var_calls[f"var{NV} cheb"] = lambda: et.expv_chebyshev(T3, opV48, bV48,
                                                          tol=1e-12)
    var_calls[f"var{NV} two-pass m=20"] = lambda: et.expv(T3, opV48, bV48,
                                                         m=20, two_pass=True)
    expect[f"var{NV} two-pass m=20"] = {"fused_sweep_var": 42,
                                        "sweep_stage": 42, "tridiag_exp": 1}

    def cheb_degree(op, tol):
        lo_, hi_ = op.spectral_bounds_hint()
        return len(tc._full_exp_coeffs(T3, lo_, hi_, tol, None)[0])

    # Chebyshev: one sweep per degree plus sweep 0. The degree follows
    # from the Gershgorin hint, which is the JAX package's number exactly;
    # these degrees were measured on the card (NVIDIA H100 80GB HBM3,
    # 700.00 W) and are held here
    for name, op, tol, deg in (("var cheb 32", opV[f32], 1e-7, 7),
                               ("var cheb 64", opV[f64], 1e-12, 10),
                               (f"var{NV} cheb", opV48, 1e-12, 10)):
        got = cheb_degree(op, tol)
        print(f"main {name}: Gershgorin hint {op.spectral_bounds_hint()}, "
              f"degree {got}", flush=True)
        check(got == deg, f"{name} Chebyshev degree {got}, expected {deg}")
        expect[name] = {"fused_sweep_var": deg + 1, "sweep_stage": deg + 1}

    # the non-Hermitian path: config #1 (run_baseline.py:72-74) and config
    # #4's operator (run_baseline.py:210-215), float64
    rngc = np.random.default_rng(SEED)
    A1np = rngc.standard_normal((100, 100)) / 10
    b1cnp = rngc.standard_normal(100)
    A1c = torch.as_tensor(A1np, device=dev)
    b1c = torch.as_tensor(b1cnp, device=dev)
    opA = et.advection_diffusion_1d(NA, peclet=10.0, device=dev)
    bAnp = np.random.default_rng(SEED).standard_normal(NA)
    bA = torch.as_tensor(bAnp, device=dev)
    nh_calls = {
        "config1 expm": lambda: et.expm(A1c),
        "config1 expv m=40": lambda: et.expv(1.0, A1c, b1c, m=40),
        f"config4 expv m={MA}": lambda: et.expv(TA, opA, bA, m=MA),
        f"config4 phiv k=1 m={MA}": lambda: et.phiv(TA, opA, bA, 1, m=MA,
                                                    errest=True),
        f"config4 two-pass iop=2 m={MA}": lambda: et.expv(
            TA, opA, bA, m=MA, iop=2, two_pass=True),
        f"config4 iop=2 reorth=False m={MA}": lambda: et.expv(
            TA, opA, bA, m=MA, iop=2, reorth=False),
        f"config4 expv m={MA} reduced=host": lambda: et.expv(
            TA, opA, bA, m=MA, reduced="host"),
        f"config4 phiv k=1 m={MA} reduced=host": lambda: et.phiv(
            TA, opA, bA, 1, m=MA, errest=True, reduced="host"),
    }
    expect.update({
        "config1 expm": {},                 # dense: torch matmuls, no kernel
        "config1 expv m=40": {},
        f"config4 expv m={MA}": {"banded_spmv": MA},     # one B7 per matvec
        f"config4 phiv k=1 m={MA}": {"banded_spmv": MA},
        f"config4 two-pass iop=2 m={MA}": {"banded_spmv": 2 * MA},
        f"config4 iop=2 reorth=False m={MA}": {"banded_spmv": MA},
        f"config4 expv m={MA} reduced=host": {"banded_spmv": MA},
        f"config4 phiv k=1 m={MA} reduced=host": {"banded_spmv": MA},
    })

    # the calls whose B1, B5 or B6 launches must take the neighbour form:
    # the plans (kept on the operators) count those launches
    nbr_plans = {"1d cheb f32": tr.recurrence_plan(op1[f32], f32, dev),
                 "1d cheb f64": tr.recurrence_plan(op1[f64], f64, dev),
                 "1d two-pass m=40 f64": tr.recurrence_plan(op1[f64], f64,
                                                            dev),
                 "config3 expv_chebyshev": tr.banded_plan(opP, f64, dev),
                 "2d cheb": tr.grid_plan(opG, f64, dev)}
    _build.reset_launch_counts()
    graphs.reset_counts()
    out = {}
    for name, fn in {**calls, **phi_calls, **sparse_calls, **var_calls,
                     **nh_calls}.items():
        before = dict(_build.launches)
        adj = graphs.launch_adjustment()
        plan = nbr_plans.get(name)
        nbr_before = plan.nbr_launches if plan is not None else 0
        out[name] = fn()
        torch.cuda.synchronize()
        # executions: the Krylov builders replay their CUDA graphs
        delta = {k: v for k, v in graphs.kernel_executions(
            {k: _build.launches[k] - before[k] for k in before},
            since=adj).items() if v}
        if plan is not None:
            if isinstance(plan, tr.GridRecurrencePlan):
                key = "resident_grid"
                where = (f"{plan.tiles.grid} tiles of {plan.tiles.tz} x "
                         f"{plan.tiles.ty} lines")
            else:
                key = ("resident_banded" if plan.banded
                       else "resident_recurrence")
                where = f"{plan.grid} blocks of {plan.chunk} rows"
            got = plan.nbr_launches - nbr_before
            check(plan.form == "neighbour" and got == delta.get(key, 0) >= 1,
                  f"{name}: {got} of {delta.get(key, 0)} {key} launches on "
                  f"the neighbour form ({plan.form})")
            print(f"main {name}: all {got} {key} launches on the neighbour "
                  f"form ({where})", flush=True)
        if name in expect:
            check(delta == expect[name], f"{name} launches {delta}")
        else:       # Chebyshev 3-D: one sweep per degree plus sweep 0,
            # each with its second stage in recurrence mode
            check(set(delta) == {"fused_sweep", "sweep_stage"}
                  and delta["fused_sweep"] == delta["sweep_stage"] >= 2,
                  f"{name} launches {delta}")
        print(f"main {name}: kernel launches {delta}", flush=True)
    # the adaptive drivers (run_baseline.py:217-237 and more) on config
    # #4's operator, and on config #3's at n = 1e6 with p = 3. Each call's
    # B7 launches are held to the count its own stats imply: every
    # matvec of these calls is one BandedOperator.matvec, i.e. one B7
    #   NW (phiv_timestep, also two_pass): stats.matvecs (p a substep for
    #     W, m a basis or rebuild, m a two-pass replay);
    #   phiv_timestep_device: stats.matvecs + p + m0 (its first basis,
    #     which seeds the norm, is not counted; m0 the bucketed m);
    #   kiops, kiops_device: stats.krylov_steps, one augmented matvec
    #     (one B7) a Krylov step, since no basis here breaks down (a
    #     breakdown would stop the count at m_used while the masked steps
    #     still run); the stored basis makes the accepted and phantom
    #     combinations without matvecs;
    #   make_phiv_timestep: its calibration call, the NW count; fn(B):
    #     nsteps (p + fn.m);
    #   expv_taylor: s m* (s stages of m* matvecs).
    B4 = torch.stack([bA, 0.1 * bA], dim=1)
    BP = torch.stack([bP, 0.1 * bP, 0.01 * bP, 0.001 * bP], dim=1)
    drv_calls = {
        "config4 phiv_timestep adaptive m=20": lambda: et.phiv_timestep(
            [TA], opA, B4, adaptive=True, tol=1e-7, m=20, return_stats=True),
        "config4 kiops": lambda: et.kiops([TA], opA, B4, tol=1e-7),
        "config4 phiv_timestep_device m=20": lambda: et.phiv_timestep_device(
            [TA], opA, B4, tol=1e-7, m=20, return_stats=True),
        "config4 kiops_device": lambda: et.kiops_device([TA], opA, B4,
                                                        tol=1e-7),
        "config4 phiv_timestep adaptive": lambda: et.phiv_timestep(
            TA, opA, B4, adaptive=True, tol=1e-7, return_stats=True),
        "config4 phiv_timestep two_pass": lambda: et.phiv_timestep(
            [TA], opA, B4, adaptive=True, two_pass=True, tol=1e-7,
            return_stats=True),
        "config4 make_phiv_timestep": lambda: et.make_phiv_timestep(
            TA, opA, B4, tol=1e-7),
        "config4 expv_taylor": lambda: et.expv_taylor(TA, opA, bA),
        "config3 n=1e6 kiops p=3": lambda: et.kiops([TP], opP, BP,
                                                    tol=1e-7),
        "config3 n=1e6 phiv_timestep two_pass p=3": lambda: et.phiv_timestep(
            [TP], opP, BP, adaptive=True, two_pass=True, tol=1e-7,
            return_stats=True),
    }
    JAX_C4 = {   # the JAX package's drivers on config #4, float64, CPU
        "config4 phiv_timestep adaptive m=20":
            "steps 47, rejections 1, matvecs 1855, final_m 38",
        "config4 kiops": "steps 2, rejections 11, krylov_steps 256, exps "
                         "13, last_m 128",
        "config4 phiv_timestep_device m=20":
            "steps 103, rejections 1, matvecs 2369, final_m 22",
        "config4 kiops_device": "steps 2, rejections 8, krylov_steps 808, "
                                "exps 10, last_m 128",
    }
    s_star = tt.operator_parameters(TA * float(opA.opnorm_hint()),
                                    tt.taylor_theta(f64))

    def drv_expected(name, res, ex):
        """B7 executions from the stats, and for a device loop (run from
        CUDA graphs, every step's matvecs also in its masked executions)
        from the executions ``ex`` of its steps: NW p + m a substep plus
        the norm's p + m0, KIOPS m a substep."""
        if name.endswith("make_phiv_timestep"):
            # its calibration is the default-m adaptive call
            return out["config4 phiv_timestep adaptive"][1].matvecs
        if name.endswith("expv_taylor"):
            return s_star[0] * s_star[1]
        st = res[1]
        if name.endswith("kiops_device"):
            return sum(v * key for (_, key, _), v in ex.items())
        if "kiops" in name:
            return st.krylov_steps
        if "device" in name:
            return 1 + _bucket_m(20, NA, 256) + sum(
                v * (1 + key) for (_, key, step), v in ex.items()
                if step == "sub")
        return st.matvecs

    for name, fn in drv_calls.items():
        before = dict(_build.launches)
        adj = graphs.launch_adjustment()
        ex0 = dict(graphs.executions)
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        delta = {k: v for k, v in graphs.kernel_executions(
            {k: _build.launches[k] - before[k] for k in before},
            since=adj).items() if v}
        ex = {k: v - ex0.get(k, 0) for k, v in graphs.executions.items()
              if v > ex0.get(k, 0)}
        want = drv_expected(name, out[name], ex)
        check(delta == {"banded_spmv": want},
              f"{name} launches {delta}, expected {want} B7")
        res = out[name]
        stats = res[1] if isinstance(res, tuple) else None
        print(f"main {name}: {want} B7 launches as its counters imply "
              f"({sec:.2f} s); stats {stats}" + (
                  f"; from CUDA graphs: B7 executions = captured launches x "
                  f"replays + eager steps' launches, steps {ex}" if ex
                  else ""), flush=True)
        if name in JAX_C4:
            print(f"  the JAX package on the CPU: {JAX_C4[name]}",
                  flush=True)
    fn4 = out["config4 make_phiv_timestep"]
    before = dict(_build.launches)
    adj = graphs.launch_adjustment()
    out["config4 make_phiv_timestep fn(B)"] = fn4(B4)
    torch.cuda.synchronize()
    delta = {k: v for k, v in graphs.kernel_executions(
        {k: _build.launches[k] - before[k] for k in before},
        since=adj).items() if v}
    want = fn4.nsteps * (1 + fn4.m)
    check(delta == {"banded_spmv": want},
          f"make_phiv_timestep fn(B) launches {delta}, expected {want}")
    print(f"main config4 make_phiv_timestep fn(B): {fn4.nsteps} steps at m = "
          f"{fn4.m}, {want} B7 launches", flush=True)

    # semigroup halves, also through the public entry points
    half = {}
    for dt in (f32, f64):
        tol = 1e-12 if dt == f64 else 1e-7
        h = et.expv_chebyshev(T3 / 2, op3[dt], b3[dt], tol=tol)
        half[f"3d cheb {dname[dt][-2:]}"] = et.expv_chebyshev(
            T3 / 2, op3[dt], h, tol=tol)
        h = et.expv(T3 / 2, op3[dt], b3[dt], m=20, two_pass=True)
        half[f"3d two-pass m=20 {dname[dt][-2:]}"] = et.expv(
            T3 / 2, op3[dt], h, m=20, two_pass=True)
        h = et.expv_chebyshev(T3 / 2, opV[dt], bV[dt], tol=cheb_tol[dt])
        half[f"var cheb {dname[dt][-2:]}"] = et.expv_chebyshev(
            T3 / 2, opV[dt], h, tol=cheb_tol[dt])
        h = et.expv(T3 / 2, opV[dt], bV[dt], m=20, two_pass=True)
        half[f"var two-pass m=20 {dname[dt][-2:]}"] = et.expv(
            T3 / 2, opV[dt], h, m=20, two_pass=True)
        del h
    torch.cuda.synchronize()
    main_counts = graphs.kernel_executions(dict(_build.launches))
    for k, v in main_counts.items():
        # the batched kernels run on the third and eleventh paths
        check(v > 0 or k in BATCHED_KERNELS,
              f"kernel {k} never launched on the main path")
    print(f"main launches: {main_counts}", flush=True)
    # the plans config #2's B2 and B4 launches went through (kept on its
    # operator): B2's cluster form, and every B4 launch on the neighbour
    # form (the plan counts those)
    lp, mp = tr.lanczos_plan(op1[f64], f64, dev), tr.multi_plan(op1[f64], f64,
                                                                 dev)
    check(lp.form == "cluster"
          and mp.nbr_launches == main_counts["resident_multi"],
          f"config #2 main path: B2 {lp.form} form, {mp.nbr_launches} of "
          f"{main_counts['resident_multi']} B4 launches on the neighbour form")
    print(f"main config #2: B2 on the cluster form ({lp.cluster} blocks), "
          f"all {mp.nbr_launches} B4 launches on the neighbour form ({mp.grid} "
          f"blocks of {mp.chunk} rows)", flush=True)

    A1 = sp.diags([np.ones(N1 - 1), -2 * np.ones(N1), np.ones(N1 - 1)],
                  [-1, 0, 1], format="csr")
    ref1 = torch.as_tensor(spla.expm_multiply(T1 * A1, b1np))
    for name in calls:
        w = out[name]
        check(w.shape == (N1,) or w.shape == (N3 ** 3,), f"{name} shape")
        check(bool(torch.isfinite(w).all()), f"{name} finite")
        if name.startswith("1d"):
            e = rel_norm(w.cpu(), ref1)
            tol = MTOL_SCIPY32 if name.endswith("f32") else MTOL_SCIPY64
            check(e <= tol, f"{name} vs scipy {e:.2e}")
            print(f"check {name}: rel err vs scipy expm_multiply {e:.2e} "
                  f"(tol {tol:g})", flush=True)
        else:
            dn = "float64" if name.endswith("64") else "float32"
            e = rel_norm(half[name], w)
            check(e <= MTOL3[dn], f"{name} semigroup {e:.2e}")
            print(f"check {name}: semigroup exp(tA)b vs exp(t/2 A)^2 b "
                  f"{e:.2e} (tol {MTOL3[dn]:g})", flush=True)
    for sfx, dn in (("32", "float32"), ("64", "float64")):
        e = rel_norm(out[f"3d cheb {sfx}"], out[f"3d two-pass m=20 {sfx}"])
        check(e <= MTOL3[dn], f"3d cross-method {dn} {e:.2e}")
        print(f"check 3d {dn}: Chebyshev vs two-pass {e:.2e} "
              f"(tol {MTOL3[dn]:g})", flush=True)
    e = rel_norm(out["1d cheb f64"], out["1d two-pass m=40 f64"])
    print(f"check 1d float64: Chebyshev vs two-pass {e:.2e}", flush=True)
    e = rel_norm(out["1d two-pass m=40 f64 reduced=host"],
                 out["1d two-pass m=40 f64"])
    check(e <= MTOL_HOST2, f"1d two-pass reduced=host vs device {e:.2e}")
    print(f"check 1d two-pass m=40 f64 reduced=host: vs reduced=device "
          f"{e:.2e} (tol {MTOL_HOST2:g}; JAX on the CPU "
          f"{JAX_HOST['config2 expv']:.1e}); B2 and B1 one launch each, the "
          "reduced tridiagonal on host scipy between them", flush=True)

    def phi_identity(op, W, b, t):
        """max_j |t A phi_{j+1} b - (phi_j b - b/j!)| / |phi_j b|, j < K."""
        errs = []
        for j in range(W.shape[1] - 1):
            resid = t * op.matvec(W[:, j + 1]) - (W[:, j] - b / math.factorial(j))
            errs.append(float(resid.norm() / W[:, j].norm()))
        return max(errs)

    def check_phi(name, got, want, what):
        e = rel_norm(got, want)
        check(e <= MTOL_PHI, f"{name} {what} {e:.2e}")
        print(f"check {name}: {what} {e:.2e} (tol {MTOL_PHI:g})", flush=True)

    for name in ("1d phiv two-pass m=40", "1d phiv_chebyshev", "1d phiv m=30",
                 "config3 phiv m=30"):
        W = out[name]
        n, op, b, t = ((N1, op1[f64], b1[f64], T1) if name.startswith("1d")
                       else (NP * NP, opP, bP, TP))
        check(W.shape == (n, K + 1) and bool(torch.isfinite(W).all()),
              f"{name} shape/finite")
        e = phi_identity(op, W, b, t)
        check(e <= MTOL_PHI, f"{name} phi identity {e:.2e}")
        print(f"check {name}: phi identities {e:.2e} (tol {MTOL_PHI:g})",
              flush=True)
        if name.startswith("1d"):
            check_phi(name, W[:, 0].cpu(), ref1, "phi_0 vs scipy")
    W30 = out["1d phiv m=30"]
    check_phi("1d phiv two-pass m=40", out["1d phiv two-pass m=40"], W30,
              "vs phiv m=30")
    check_phi("1d phiv_chebyshev", out["1d phiv_chebyshev"], W30,
              "vs phiv m=30")
    U = out["1d phiv_timestep_chebyshev"]
    check(U.shape == (N1, 2) and bool(torch.isfinite(U).all()),
          "phiv_timestep_chebyshev shape/finite")
    check_phi("1d phiv_timestep_chebyshev", U[:, 1],
              W30[:, 0] + T1 * W30[:, 1], "t = 0.5 vs phi_0 b + t phi_1 b")
    check_phi("config3 expv_chebyshev", out["config3 expv_chebyshev"],
              out["config3 phiv m=30"][:, 0], "(B5) vs phiv column 0")
    check(bool(torch.isfinite(out["2d cheb"]).all()), "2d cheb finite")
    check_phi("2d cheb", out["2d cheb"], out["2d two-pass m=20"],
              "(B6) vs two-pass m=20 (B3)")

    # the sparse containers: scipy on the same CSR matrices (RCM results
    # mapped back), the default pack, the stencil path, the phi identities
    def rcm_back(wp):
        w = torch.empty_like(wp)
        w[perm] = wp
        return w

    def check_sparse(name, got, want, what):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} shape/finite")
        e = rel_norm(got, want)
        check(e <= MTOL_SPARSE, f"{name} {what} {e:.2e}")
        print(f"check {name}: {what} {e:.2e} (tol {MTOL_SPARSE:g})",
              flush=True)

    t0 = time.perf_counter()
    ref_s = torch.as_tensor(spla.expm_multiply(TS * A_sell, bSnp), device=dev)
    ref_c = torch.as_tensor(spla.expm_multiply(TS * A_scat, bC.cpu().numpy()),
                            device=dev)
    print(f"scipy expm_multiply at n = 1e6 (two matrices): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("sell expv m=40", "sell expv two-pass m=40",
                 "sell expv_chebyshev"):
        check_sparse(name, rcm_back(out[name]), ref_s,
                     "vs scipy expm_multiply")
    base = out["scattered default expv m=40"]
    check_sparse("scattered default expv m=40", base, ref_c,
                 "vs scipy expm_multiply")
    for name in ("scattered seg expv m=40", "scattered sorted expv m=40"):
        check_sparse(name, out[name], base, "vs the default pack")
    W = out["scattered sorted phiv m=30"]
    check(W.shape == (NS, K + 1) and bool(torch.isfinite(W).all()),
          "sorted phiv shape/finite")
    e = phi_identity(sc_ops["sorted"], W, bC, TS)
    check(e <= MTOL_SPARSE, f"sorted phiv phi identity {e:.2e}")
    print(f"check scattered sorted phiv m=30: phi identities {e:.2e} "
          f"(tol {MTOL_SPARSE:g})", flush=True)
    check_sparse("scattered sorted phiv m=30", W[:, 0], base,
                 "phi_0 vs the default pack's expv")
    check_sparse("hybrid expv m=40", out["hybrid expv m=40"],
                 out["hybrid matrix default pack expv m=40"],
                 "(B7 + B9) vs the default SELL pack (B9)")
    check_sparse(f"blockell {NB}^3 two-pass m=20",
                 out[f"blockell {NB}^3 two-pass m=20"],
                 out[f"stencil {NB}^3 two-pass m=20"],
                 "(B8) vs the stencil two-pass (B3)")

    # the variable path: semigroup, cross-method, and scipy at 48^3
    for name in var_calls:
        w = out[name]
        check(w.shape == (w.shape[0],) and bool(torch.isfinite(w).all()),
              f"{name} shape/finite")
        if name in half:
            dn = "float64" if name.endswith("64") else "float32"
            e = rel_norm(half[name], w)
            check(e <= MTOL_VAR[dn], f"{name} semigroup {e:.2e}")
            print(f"check {name}: semigroup exp(tA)b vs exp(t/2 A)^2 b "
                  f"{e:.2e} (tol {MTOL_VAR[dn]:g})", flush=True)
    for sfx, dn in (("32", "float32"), ("64", "float64")):
        e = rel_norm(out[f"var cheb {sfx}"], out[f"var two-pass m=20 {sfx}"])
        check(e <= MTOL_VAR[dn], f"var cross-method {dn} {e:.2e}")
        print(f"check var {dn}: Chebyshev vs two-pass {e:.2e} "
              f"(tol {MTOL_VAR[dn]:g})", flush=True)
    t0 = time.perf_counter()
    ref_v = torch.as_tensor(spla.expm_multiply(
        T3 * banded_csr(opV48.to_banded()), bV48np), device=dev)
    print(f"scipy expm_multiply at {NV}^3: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in (f"var{NV} cheb", f"var{NV} two-pass m=20"):
        e = rel_norm(out[name], ref_v)
        check(e <= MTOL_VAR["float64"], f"{name} vs scipy {e:.2e}")
        print(f"check {name}: vs scipy expm_multiply {e:.2e} "
              f"(tol {MTOL_VAR['float64']:g})", flush=True)

    # the non-Hermitian path against scipy's dense exponentials
    import scipy.linalg as sla

    t0 = time.perf_counter()
    E1 = sla.expm(A1np)
    Ad = banded_csr(opA).toarray()
    aug = np.zeros((NA + 1, NA + 1))        # run_baseline.py:239-243
    aug[:NA, :NA] = TA * Ad
    aug[:NA, NA] = TA * 0.1 * bAnp
    F2 = sla.expm(aug)
    ref_e = F2[:NA, :NA] @ bAnp             # exp(tA) b
    ref_p = ref_e + F2[:NA, NA]             # exp(tA) b + t phi_1(tA) 0.1 b
    print(f"scipy dense expm (100 and {NA + 1}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def check_nh(name, got, want, tol=MTOL_NONHERM):
        got = got.cpu()
        want = torch.as_tensor(want)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} shape/finite")
        e = rel_norm(got, want)
        check(e <= tol, f"{name} {e:.2e}")
        print(f"check {name}: {e:.2e} (tol {tol:g})", flush=True)

    check_nh("config1 expm vs scipy expm", out["config1 expm"], E1)
    check_nh("config1 expv m=40 vs scipy expm(A) b", out["config1 expv m=40"],
             E1 @ b1cnp)
    check_nh(f"config4 expv m={MA} vs the dense oracle",
             out[f"config4 expv m={MA}"], ref_e)
    W4, err4 = out[f"config4 phiv k=1 m={MA}"]
    check_nh(f"config4 phiv k=1 m={MA}: phi_0 b + t phi_1 (0.1 b) vs the "
             "dense oracle", W4[:, 0] + TA * 0.1 * W4[:, 1], ref_p)
    check(bool(torch.isfinite(err4)) and float(err4) < 1e-8,
          f"config4 phiv error estimate {float(err4):.2e}")
    print(f"check config4 phiv error estimate: {float(err4):.2e}", flush=True)
    check_nh(f"config4 two-pass iop=2 m={MA} vs expv(iop=2, reorth=False)",
             out[f"config4 two-pass iop=2 m={MA}"],
             out[f"config4 iop=2 reorth=False m={MA}"].cpu(), MTOL_IOP)
    check_nh(f"config4 two-pass iop=2 m={MA} vs the dense oracle",
             out[f"config4 two-pass iop=2 m={MA}"], ref_e)
    # reduced="host" (ops/host_reduced.py) against the device form
    Wh4, errh4 = out[f"config4 phiv k=1 m={MA} reduced=host"]
    for name, got, want_, jax_e in (
            (f"config4 expv m={MA}", out[f"config4 expv m={MA} reduced=host"],
             out[f"config4 expv m={MA}"], JAX_HOST["config4 expv"]),
            (f"config4 phiv k=1 m={MA}", Wh4, W4, JAX_HOST["config4 phiv"])):
        e = rel_norm(got, want_)
        check(bool(torch.isfinite(got).all()) and e <= MTOL_NONHERM,
              f"{name} reduced=host vs device {e:.2e}")
        print(f"check {name} reduced=host: vs reduced=device {e:.2e} (tol "
              f"{MTOL_NONHERM:g}; JAX on the CPU {jax_e:.1e})", flush=True)
    check_nh(f"config4 expv m={MA} reduced=host vs the dense oracle",
             out[f"config4 expv m={MA} reduced=host"], ref_e)
    check(bool(torch.isfinite(errh4)) and float(errh4) < 1e-8,
          f"config4 phiv reduced=host error estimate {float(errh4):.2e}")
    print(f"check config4 phiv reduced=host error estimate: "
          f"{float(errh4):.2e} (device {float(err4):.2e})", flush=True)
    # the adaptive drivers against the same dense oracles
    for name in ("config4 phiv_timestep adaptive m=20", "config4 kiops",
                 "config4 phiv_timestep_device m=20", "config4 kiops_device",
                 "config4 phiv_timestep two_pass",
                 "config4 make_phiv_timestep fn(B)"):
        check_nh(f"{name} vs the dense oracle", out[name][0].reshape(-1),
                 ref_p)
    check_nh("config4 expv_taylor vs the dense oracle",
             out["config4 expv_taylor"], ref_e)
    WP = out["config3 phiv m=30"]
    refP = sum(TP ** j * 0.1 ** j * WP[:, j] for j in range(K + 1))
    uk = out["config3 n=1e6 kiops p=3"][0].reshape(-1)
    un = out["config3 n=1e6 phiv_timestep two_pass p=3"][0].reshape(-1)
    for name, got, want_ in (
            ("config3 n=1e6 kiops vs sum_j t^j c_j phiv columns", uk, refP),
            ("config3 n=1e6 phiv_timestep two_pass vs the phiv columns", un,
             refP),
            ("config3 n=1e6 kiops vs phiv_timestep two_pass", uk, un)):
        check(bool(torch.isfinite(got).all()), f"{name} finite")
        e = rel_norm(got, want_)
        check(e <= MTOL_DRIVER, f"{name} {e:.2e}")
        print(f"check {name}: {e:.2e} (tol {MTOL_DRIVER:g})", flush=True)
    w_stencil = out[f"stencil {NB}^3 two-pass m=20"]
    del out, W, W30, U, base, half, W4, F2, aug, Ad, WP, refP, uk, un

    # pass 1 and the replay run the same second stage on the same moments:
    # the replay's alphas and betas are pass 1's, bit for bit
    for label, op, b in (("216^3", op3[f64], b3[f64]),
                         ("216^3 variable", opV[f64], bV[f64])):
        a1, bt1, beta1, _, _, _ = tf._lanczos_sweeps(op, b, 20, 1e-7,
                                                     what="pass 1")
        cf = tx._lanczos_reduced_coeffs(a1, bt1, beta1, T3)
        a2, bt2, _, _, _, _ = tf._lanczos_sweeps(op, b, 20, 1e-7, cf,
                                                 what="replay")
        check(torch.equal(a1, a2) and torch.equal(bt1, bt2),
              f"{label}: replay scalars differ from pass 1's")
        print(f"check {label} two-pass: the replay's alpha and beta equal "
              "pass 1's bit for bit", flush=True)

    # the second path: the Leja and Faber actions and the exponential
    # integrators, each call's launches held to its expected count
    (poly_counts, poly_calls, poly_sync_free, poly_ms, poly_ops,
     host_refs) = poly_integrator_path(et, dev, card, ref_e, bA)
    print(f"main launches of the polynomial and integrator path: "
          f"{poly_counts}", flush=True)
    for k in ("resident_recurrence", "resident_banded", "resident_grid",
              "fused_sweep", "banded_spmv"):
        check(poly_counts[k] > 0, f"kernel {k} never launched on the "
              "polynomial and integrator path")

    # the third path: the dense layer, expv_batched and the gradients
    dense_counts, dense_calls, dense_ms, dense_stacks = dense_grad_path(
        et, dev, card, A1np, op1[f64], opP, opS)
    print(f"main launches of the dense and gradient path: {dense_counts}",
          flush=True)
    for k in ("resident_lanczos_batched", "resident_recurrence_batched",
              "banded_spmm_alpha", "lanczos_update", "tridiag_exp_batched",
              "banded_spmv", "sell_spmv"):
        check(dense_counts[k] > 0, f"kernel {k} never launched on the "
              "dense and gradient path")

    # the fourth path: the distributed layer, ranks sharing this card. The
    # builders' freed graph pools stay reserved by this process until an
    # allocation fails: hand the cached blocks back before the ranks start
    held_gib = torch.cuda.memory_reserved() / 2**30
    torch.cuda.empty_cache()
    print(f"device memory reserved by this process before the ranks: "
          f"{held_gib:.2f} GiB, {torch.cuda.memory_reserved() / 2**30:.2f} "
          "GiB after empty_cache", flush=True)
    shard_counts, shard_ms, shard_singles = sharded_path(et, dev, card)
    print(f"launches of the sharded path (every rank of every run): "
          f"{ {k: v for k, v in shard_counts.items() if v} }", flush=True)
    for k in ("fused_sweep", "fused_sweep_var", "sweep_stage"):
        check(shard_counts[k] > 0, f"kernel {k} never launched on the "
              "sharded path")

    # the fifth path: the GSPMD route (parallel.shard_operator and the
    # ordinary drivers), ranks sharing this card
    gspmd_counts, gspmd_ms, gspmd_singles = gspmd_path(et, dev, card, opB3)
    print(f"launches of the GSPMD path (every rank of every run): "
          f"{ {k: v for k, v in gspmd_counts.items() if v} }", flush=True)
    for k in ("banded_spmv", "blockell_spmv"):
        check(gspmd_counts[k] > 0, f"kernel {k} never launched on the "
              "GSPMD path")

    # the sixth path: the device-resident programs from CUDA graphs
    t0 = time.perf_counter()
    graph_counts, graph_calls = graph_path(et, dev, card, bA, ref_p,
                                           host_refs)
    print(f"graph path: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"kernel executions of the graph path: "
          f"{ {k: v for k, v in graph_counts.items() if v} }", flush=True)
    check(graph_counts.get("banded_spmv", 0) > 0,
          "kernel banded_spmv never ran on the graph path")

    # the seventh path: the Krylov builders from CUDA graphs
    kg = {"opA": opA, "bA": bA, "ref_e": ref_e, "ref_p": ref_p,
          "A1c": A1c, "b1c": b1c, "ref_1": E1 @ b1cnp, "opP": opP, "bP": bP,
          "opS": opS, "perm": perm, "bS": bS, "opSeg": sc_ops["seg"],
          "bC": bC, "opB3": opB3, "bB": bB, "ref_s": ref_s, "ref_c": ref_c,
          "w_stencil": w_stencil}
    t0 = time.perf_counter()
    krylov_counts, krylov_calls = krylov_graph_path(et, dev, card, kg)
    print(f"krylov graph path: {time.perf_counter() - t0:.1f} s", flush=True)
    del kg, w_stencil
    print(f"kernel executions of the krylov graph path: "
          f"{ {k: v for k, v in krylov_counts.items() if v} }", flush=True)
    for k in ("banded_spmv", "blockell_spmv", "sell_spmv", "seg_compact"):
        check(krylov_counts.get(k, 0) > 0, f"kernel {k} never ran on the "
              "krylov graph path")

    # the eighth path: the serving closures and the error-estimate loop
    t0 = time.perf_counter()
    serving_counts, serving_calls = serving_path(et, dev, card, {
        "opA": opA, "A1np": A1np, "A1c": A1c, "opP": opP, "A_sell": A_sell,
        "opS": opS, "perm": perm, "bS": bS, "ref_s": ref_s})
    print(f"serving path: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"kernel executions of the serving path: "
          f"{ {k: v for k, v in serving_counts.items() if v} }", flush=True)
    for k in ("banded_spmv", "sell_spmv", "tridiag_exp"):
        check(serving_counts.get(k, 0) > 0, f"kernel {k} never ran on the "
              "serving path")

    # the ninth path: the fixed NW stepper and the fused passes from graphs
    fixed_counts, fixed_calls, ring_err = fixed_fused_path(et, dev, card, {
        "opA": opA, "opG": opG, "op3": op3[f64], "opV": opV[f64]})
    for k, e in ring_err.items():       # B3's device-index form vs twins
        kerr[k] = max(kerr[k], e)
    print(f"kernel executions of the fixed path: "
          f"{ {k: v for k, v in fixed_counts.items() if v} }", flush=True)
    for k in ("banded_spmv", "fused_sweep", "fused_sweep_var", "sweep_stage",
              "tridiag_exp"):
        check(fixed_counts.get(k, 0) > 0, f"kernel {k} never ran on the "
              "fixed path")

    # the tenth path: the Chebyshev, Leja, Faber and Taylor loops from graphs
    poly_counts10, _, rec_err = poly_graph_path(et, dev, card, {
        "op3": op3[f64], "opV": opV[f64], "opF": poly_ops[2],
        "bF": poly_ops[3], "opS": opS, "bS": bS, "opP": opP, "bP": bP,
        "opA": opA, "bA": bA, "ref_e": ref_e, "opL": poly_ops[0]})
    for k, e in rec_err.items():        # the recurrence's device-index form
        kerr[k] = max(kerr[k], e)
    print(f"kernel executions of the poly graph path: "
          f"{ {k: v for k, v in poly_counts10.items() if v} }", flush=True)
    for k in ("fused_sweep", "fused_sweep_var", "sweep_stage",
              "resident_recurrence", "resident_banded", "banded_spmv",
              "sell_spmv"):
        check(poly_counts10.get(k, 0) > 0, f"kernel {k} never ran on the "
              "poly graph path")

    # the eleventh path: expv_batched as one batched build
    batched_counts, batched_calls, batched_kinfo, batched_jobs = \
        batched_path(et, dev, card)
    print(f"kernel executions of the batched path: "
          f"{ {k: v for k, v in batched_counts.items() if v} }", flush=True)
    for k in BATCHED_KERNELS:
        check(batched_counts.get(k, 0) > 0, f"kernel {k} never ran on the "
              "batched path")

    # the kernel-driving passes make no host syncs
    lo, hi = op3[f64].spectral_bounds_hint()
    full3, _, _ = tc._full_exp_coeffs(T3, lo, hi, 1e-12, None)
    c3 = torch.as_tensor(full3, dtype=f64, device=dev)
    lo1, hi1 = op1[f64].spectral_bounds_hint()
    full1, _, _ = tc._full_exp_coeffs(T1, lo1, hi1, 1e-12, None)
    c1 = torch.as_tensor(full1, dtype=f64, device=dev)
    a3, bt3, beta3, _, _ = tf.lanczos_coeffs_fused(op3[f64], b3[f64], 20)
    coef3 = tx._lanczos_reduced_coeffs(a3, bt3, beta3, T3)
    loV, hiV = opV[f64].spectral_bounds_hint()
    cV = torch.as_tensor(tc._full_exp_coeffs(T3, loV, hiV, 1e-12, None)[0],
                         dtype=f64, device=dev)

    def cheb_rows(op, t, dt=f64):
        lo_, hi_ = op.spectral_bounds_hint()
        full, c, h = tc._full_exp_coeffs(t, lo_, hi_, 1e-12, None)
        return td.chebyshev_rows(torch.as_tensor(full, device=dev), c, h, dt)

    rows1 = cheb_rows(op1[f64], T1)
    cw1 = vec(4 * rows1.shape[0], f64, rng2).reshape(-1, 4)
    rowsP, rowsG = cheb_rows(opP, TP), cheb_rows(opG, TG)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        et.chebyshev_apply(op1[f64], b1[f64], c1, (lo1, hi1))
        et.chebyshev_apply(op3[f64], b3[f64], c3, (lo, hi))
        tr.lanczos_coeffs_resident(op1[f64], b1[f64], 40)
        tr.recurrence_apply_resident(op1[f64], b1[f64],
                                     td.chebyshev_rows(c1, 0.5 * (hi1 + lo1),
                                                       0.5 * (hi1 - lo1), f64))
        tf.lanczos_coeffs_fused(op3[f64], b3[f64], 20)
        tf.lanczos_replay_fused(op3[f64], b3[f64], coef3)
        et.chebyshev_apply(opV[f64], bV[f64], cV, (loV, hiV))   # B3-var
        tf.lanczos_coeffs_fused(opV[f64], bV[f64], 20)
        tr.recurrence_apply_resident_multi(op1[f64], b1[f64], rows1, cw1)
        tr.recurrence_apply_resident_banded(opP, bP, rowsP)
        tr.recurrence_apply_resident_grid(opG, bG, rowsG)
        opP.matvec(bP)                      # B7
        opB3.matvec(bB)                     # B8
        opS.matvec(bS)                      # B9
        sc_ops["seg"].matvec(bC)            # B9 + B10
        sc_ops["sorted"].matvec(bC)         # gathers around B9
        opH.matvec(bH)                      # B7 + B9
        fn4(B4)                             # fixed-step NW, config #4
        for fn in poly_sync_free.values():  # fixed-step integrators, jvp
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("sync-free: Chebyshev applies (1-D, 3-D, 3-D variable), "
          "resident pass 1 and recurrence, fused pass 1 (constant and "
          "variable) and replay, the B4, B5 and B6 "
          "applies, the B7-B10 matvecs of the sparse containers and "
          "config #4's make_phiv_timestep fn(B), a step of etdrk4_device "
          f"({NE}^2) and of exprb43_device's fixed mode ({NR}^2) and a "
          "JacobianOperator matvec over B7 ran under sync debug mode "
          "'error'", flush=True)
    phase_done("4 main")

    # ---- 5. times -------------------------------------------------------
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

    def device_profile(name, fn, top=6):
        """One warm call under torch.profiler: device busy time (the union
        of the device intervals), device ops, the largest kernels and the
        host ops of most self time, beside the CUDA-event wall time of the
        same call."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        wall = median_ms(fn, reps=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy, end = 0.0, -math.inf
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in evs):
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in evs:
            us, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
        print(f"profile {name}: wall (events, median of 5) {wall:.3f} ms; "
              f"device busy {busy / 1e3:.3f} ms in {len(evs)} device ops "
              f"{card}", flush=True)
        for kname, (us, cnt) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
            print(f"  {us / 1e3:9.3f} ms x {cnt:4d}  {kname[:64]}",
                  flush=True)
        host = sorted((a for a in prof.key_averages()
                       if a.device_type == DeviceType.CPU),
                      key=lambda a: -a.self_cpu_time_total)[:3]
        for a in host:
            print(f"  host {a.self_cpu_time_total / 1e3:9.3f} ms self x "
                  f"{a.count:4d}  {a.key[:58]}", flush=True)

    if args.profile:
        for name, fn in {
                "config3 phiv m=30": phi_calls["config3 phiv m=30"],
                "sell expv m=40": sparse_calls["sell expv m=40"],
                "sell expv two-pass m=40":
                    sparse_calls["sell expv two-pass m=40"],
                "sell expv_chebyshev": sparse_calls["sell expv_chebyshev"],
                "sell spectral_bounds": lambda: tc.spectral_bounds(opS),
                f"blockell {NB}^3 two-pass m=20":
                    sparse_calls[f"blockell {NB}^3 two-pass m=20"],
                **{k: var_calls[k] for k in ("var cheb 64",
                                             "var two-pass m=20 64")},
                "3d two-pass m=20 64": calls["3d two-pass m=20 64"],
                "2d two-pass m=20": phi_calls["2d two-pass m=20"],
                "1d two-pass m=40 f64": calls["1d two-pass m=40 f64"],
                "1d phiv two-pass m=40": phi_calls["1d phiv two-pass m=40"],
                **nh_calls,
                **{k: drv_calls[k] for k in (
                    "config4 phiv_timestep adaptive m=20", "config4 kiops",
                    "config4 phiv_timestep_device m=20",
                    "config4 kiops_device")},
                **{k: graph_calls[k] for k in (
                    "config4 exprb43_device",
                    f"exprb43_device {NR}^2 adaptive m={M_R}")},
                **{k: poly_calls[k] for k in (
                    "leja 1-D n=1e6 phiv_timestep_leja",
                    "faber 1-D n=1e6 phiv_timestep_faber",
                    f"faber {NF}^3 expv_faber m={MF}",
                    "config4 expv_leja tol=1e-12",
                    "config4 expv_faber tol=1e-12",
                    f"etdrk4_device {NE}^2 m={M_AC}")},
                **{k: dense_calls[k] for k in (
                    "config1 expm diagonalization", "config1 expm schur",
                    "stack 512x128 float64 expm", "stack 512x128 float64 phi",
                    "stack 32x512 float64 expm")},
                "matrix_exp stack 512x128 float64":
                    lambda: torch.linalg.matrix_exp(
                        dense_stacks[(512, 128, "float64")][0]),
                "grad config4 expv m=40": dense_calls[
                    "grad config4 expv m=40"]}.items():
            device_profile(name, fn)
        krylov_graph_profile(krylov_calls, card)
        serving_profile(serving_calls, card)
        krylov_graph_profile(fixed_calls, card, label="fixed")
        krylov_graph_profile(batched_calls, card, label="batched",
                             forms=("graph",))
        phase_done("5 profile")
        return 0

    bursts = {}         # back-to-back kernel ms
    device_jobs = []    # (name, dtype name, kernel fn, kernel name)
    # the kernel events each timed call makes one of, for the profiler
    knames = {"resident_recurrence": "resident_nbr_kernel",
              "resident_lanczos": "resident_lanczos",
              "fused_sweep": "fused_sweep_kernel",
              "fused_sweep_var": "fused_sweep_kernel",
              "resident_multi": "resident_multi_nbr_kernel",
              "resident_banded": "Banded",
              "resident_grid": "resident_grid_nbr"}

    def burst_ms(fn, k=20):
        """Per-call time of k calls back to back between two events: the
        device time when the device is slower than the host's enqueue
        (median_ms also counts the host's part of one call)."""
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

    times = {}
    work = {}           # (bytes, operations) each timed call needs
    lib_ms = {}         # the one PyTorch call of the same function
    for dt in (f32, f64):
        dn = dname[dt]
        def kernel_cases(dt):
            """The B1-B6, B3 and B3-var calls at their main-path shapes, in
            a scope of their own: the profiler runs them after the loop."""
            rows = td.chebyshev_rows(
                torch.as_tensor(tc._full_exp_coeffs(T1, lo1, hi1, 1e-12, None)[0],
                                dtype=dt, device=dev), 0.5 * (hi1 + lo1),
                0.5 * (hi1 - lo1), dt)
            x = b1[dt]
            offs = tr._flat_offsets(op1[dt])
            sc = torch.tensor(1.0, dtype=dt, device=dev)
            v0 = x / torch.linalg.vector_norm(x)
            n3 = N3 ** 3
            Z, Vc, Vp = b3[dt], vec(n3, dt), vec(n3, dt)
            W = torch.zeros(n3, dtype=dt, device=dev)
            co = torch.tensor([0.3, -0.7, 0.2, 0.0], dtype=dt, device=dev)
            isz = torch.empty((), dtype=dt).element_size()
            k1, kV = len(op1[dt].offsets), len(opV[dt].offsets)
            cases = {
                "resident_recurrence": (
                    lambda: tr.resident_recurrence(op1[dt], x, rows, 1.0),
                    lambda: tr.resident_recurrence_ref(x, rows, op1[dt].coeffs,
                                                       offs, sc),
                    f"n={N1}, m={rows.shape[0]} Chebyshev rows",
                    # x and the rows in, w and sum w^2 out; per step and cell a
                    # k-point stencil, the 3-term update and the accumulation
                    ((2 * N1 + 4 * rows.shape[0] + 1) * isz,
                     rows.shape[0] * N1 * (2 * k1 + 6) + 2 * N1)),
                "resident_lanczos": (
                    lambda: tr.resident_lanczos(op1[dt], v0, 40, 1e-7),
                    lambda: tr.resident_lanczos_ref(v0, op1[dt].coeffs, offs, 40,
                                                    1e-7),
                    f"n={N1}, m=40",
                    # v0 in, (alpha, beta) out; per step and cell the stencil,
                    # two dots, the update and the normalization
                    ((N1 + 2 * 40) * isz, 40 * N1 * (2 * k1 + 8))),
                "fused_sweep": (
                    lambda: tf.fused_lanczos_step(Z, Vc, Vp, co, op3[dt],
                                                  w_accum=W),
                    lambda: tf.fused_sweep_ref(Z, Vc, Vp, co, op3[dt].grid_shape,
                                               op3[dt].offsets, op3[dt].coeffs, W),
                    "216^3, accumulating sweep",
                    # Z, Vc, Vp, W in, Y, Zn, W out; y, the stencil, the two
                    # moments and W += cw Vc per cell
                    (7 * n3 * isz, n3 * (2 * 7 + 10))),
                "fused_sweep_var": (
                    lambda: tf.fused_lanczos_step(Z, Vc, Vp, co, opV[dt],
                                                  w_accum=W),
                    lambda: tf.fused_sweep_ref(Z, Vc, Vp, co, opV[dt].grid_shape,
                                               opV[dt].offsets,
                                               opV[dt].coeff_fields, W),
                    "216^3 div(a grad u), accumulating sweep",
                    # the 7 fields on top of B3's streams
                    ((7 + kV) * n3 * isz, n3 * (2 * kV + 10))),
            }
            # the new kernels at their main-path shapes and rows
            rm = cheb_rows(op1[dt], T1, dt)
            cwm = vec(4 * rm.shape[0], dt, rng2).reshape(-1, 4)
            opPd = et.poisson_2d(NP, NP, dtype=dt, device=dev)
            bPd = bP.to(dt)
            rP = cheb_rows(opPd, TP, dt)
            opGd = et.laplacian_nd_stencil(NG, NG, dtype=dt, device=dev)
            bGd = bG.to(dt)
            rG = cheb_rows(opGd, TG, dt)
            cases.update({
                "resident_multi": (
                    lambda: tr.recurrence_apply_resident_multi(op1[dt], x, rm,
                                                               cwm),
                    lambda: tr.resident_multi_ref(x, rm, cwm, op1[dt].coeffs,
                                                  offs),
                    f"n={N1}, p=4, m={rm.shape[0]} Chebyshev rows",
                    ((N1 + 8 * rm.shape[0] + 4 * N1) * isz,
                     rm.shape[0] * N1 * (2 * k1 + 4 + 2 * 4))),
                "resident_banded": (
                    lambda: tr.recurrence_apply_resident_banded(opPd, bPd, rP),
                    lambda: tr.resident_banded_ref(bPd, rP, opPd.diags,
                                                   opPd.offsets),
                    f"poisson_2d({NP}, {NP}), m={rP.shape[0]} Chebyshev rows",
                    # the diagonals count once, though the kernel streams them
                    # every step once they exceed L2
                    ((opPd.diags.numel() + 2 * NP * NP + 4 * rP.shape[0]) * isz,
                     rP.shape[0] * NP * NP * (2 * len(opPd.offsets) + 6))),
                "resident_grid": (
                    lambda: tr.recurrence_apply_resident_grid(opGd, bGd, rG),
                    lambda: tr.resident_grid_ref(bGd, rG, opGd.grid_shape,
                                                 opGd.offsets, opGd.coeffs),
                    f"{NG}^2 5-point, m={rG.shape[0]} Chebyshev rows",
                    ((2 * NG * NG + 4 * rG.shape[0]) * isz,
                     rG.shape[0] * NG * NG * (2 * len(opGd.offsets) + 6))),
            })
            return cases, opGd, isz

        cases, opGd, isz = kernel_cases(dt)
        for name, (kfn, pfn, shape, wk) in cases.items():
            work[(name, dn)] = wk
            # plain, kernel, kernel, plain: compare within one call
            p1 = median_ms(pfn)
            k1 = median_ms(kfn)
            k2 = median_ms(kfn)
            p2 = median_ms(pfn)
            times[(name, dn)] = (statistics.median([k1, k2]),
                                 statistics.median([p1, p2]))
            bursts[(name, dn)] = burst_ms(kfn)
            device_jobs.append((name, dn, kfn, knames[name]))
            bms, bby = bound(*wk, dn)
            print(f"time {name} {dn} ({shape}): kernel {k1:.4f} / {k2:.4f} ms,"
                  f" plain {p1:.4f} / {p2:.4f} ms; back-to-back: kernel "
                  f"{bursts[(name, dn)]:.4f} ms, bound {bms:.4f} ms by {bby} "
                  f"{card}", flush=True)
        # the card's reachable streaming rate at the sweeps' size: one
        # PyTorch add, 3 streams (context for the shares, not a kernel)
        a3, b3s, c3 = (torch.empty(N3 ** 3, dtype=dt, device=dev).normal_()
                       for _ in range(3))
        ta = burst_ms(lambda: torch.add(a3, b3s, out=c3))
        print(f"rate torch.add(a, b, out=c) {dn} at 216^3, back-to-back: "
              f"{ta:.4f} ms, {3 * c3.numel() * isz / ta / 1e6:.1f} GB/s "
              f"{card}", flush=True)
        del a3, b3s, c3
        # B6 (its plan's form, and the family kernel) against the B3
        # sweeps on the same grid and rows, one call each: the table the
        # gate of B6 (resident_grid_supported) follows; B6 runs through its
        # plans, which take grids above the gate's budget too
        for label, op in ((f"{NG}^2 5-point", opGd),
                          ("1000^2 5-point", et.laplacian_nd_stencil(
                              1000, 1000, dtype=dt, device=dev)),
                          ("64^3 7-point", et.laplacian_nd_stencil(
                              64, 64, 64, dtype=dt, device=dev)),
                          ("100^3 7-point, near the L2 budget",
                           et.laplacian_nd_stencil(100, 100, 100, dtype=dt,
                                                   device=dev)),
                          ("128^3 7-point, above the float64 budget",
                           et.laplacian_nd_stencil(128, 128, 128, dtype=dt,
                                                   device=dev)),
                          ("160^3 7-point", et.laplacian_nd_stencil(
                              160, 160, 160, dtype=dt, device=dev)),
                          (f"{N3}^3 7-point", op3[dt])):
            xg = vec(op.shape[0], dt, rng2)
            rg = cheb_rows(op, TG, dt)
            main = tr.grid_plan(op, dt, dev)
            fam = tr.GridRecurrencePlan(op, dt, dev, form="family")
            f1, g1, h1, h2, g2, f2 = (median_ms(fn) for fn in (
                lambda: tf.recurrence_apply_fused(op, xg, rg),
                lambda: main(xg, rg), lambda: fam(xg, rg),
                lambda: fam(xg, rg), lambda: main(xg, rg),
                lambda: tf.recurrence_apply_fused(op, xg, rg)))
            gate = tr.resident_grid_supported(op, dt)
            print(f"time B6 vs B3 {dn} ({label}, m={rg.shape[0]}; gate "
                  f"{'B6' if gate else 'B3'}): B6 ({main.form} form) "
                  f"{g1:.4f} / {g2:.4f} ms, B6 family form {h1:.4f} / "
                  f"{h2:.4f} ms, B3 sweeps {f1:.4f} / {f2:.4f} ms {card}",
                  flush=True)
            del fam, main

    def device_ms(fn, kname, k=20):
        """(ms, launches): the device time per launch of the kernel whose
        name holds ``kname``, the mean of its kernel events under
        torch.profiler over k calls of fn; (None, count) when the profiler
        does not see exactly k of them."""
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
            return None, len(evs)
        return sum(e.time_range.elapsed_us() for e in evs) / k / 1e3, k

    # B7-B10 at the main paths' shapes, plain, kernel, kernel, plain; then
    # kernel and library call back to back. One call counts the wrapper's
    # host time, back to back counts it too where the host is slower than
    # the device, so kernels given a ``kname`` also get their device time
    # per launch from the profiler, at the end of the phase: once
    # torch.profiler has run, every launch costs the host more for the
    # rest of the process, which would slow the later one-call and
    # main-path times (PERF.md, section 6)
    def pair_times(name, dn, kfn, pfn, shape, wk=None, lib=None, kname=None):
        p1, k1, k2, p2 = (median_ms(f) for f in (pfn, kfn, kfn, pfn))
        times[(name, dn)] = (statistics.median([k1, k2]),
                             statistics.median([p1, p2]))
        if wk is not None:
            work[(name, dn)] = wk
        line = (f"time {name} {dn} ({shape}): kernel {k1:.4f} / {k2:.4f} ms,"
                f" plain {p1:.4f} / {p2:.4f} ms")
        bursts[(name, dn)] = burst_ms(kfn)
        burst = f"back-to-back: kernel {bursts[(name, dn)]:.4f} ms"
        if kname is not None:
            device_jobs.append((name, dn, kfn, kname))
        if lib is not None:
            what, make = lib
            try:
                fn = make()
                lib_ms[(name, dn)] = median_ms(fn)
                line += f", {what} {lib_ms[(name, dn)]:.4f} ms"
                burst += f", {what} {burst_ms(fn):.4f} ms"
            except (RuntimeError, NotImplementedError) as exc:
                line += f", {what} does not run here ({exc.__class__.__name__}"
                line += f": {str(exc).splitlines()[0][:80]})"
        print(f"{line}; {burst} {card}", flush=True)
        return times[(name, dn)]

    def staged_vs_global(label, d, x):
        """B9 on one pack as packed (x staged where a block's window fits)
        and on a copy whose staging budget is 0 (every block gathers x from
        global memory), back to back, in turns; both give the same bits."""
        g = ts.SellData(d.vals, d.cols, d.slice_ptr, d.row_of, d.n, d.nnz,
                        ncols=d.ncols, sigma=d.sigma,
                        derived=(d.nslots, d.spans, 0))
        check(torch.equal(ts.sell_spmv(d, x), ts.sell_spmv(g, x)),
              f"B9 {label}: staged and global gathers differ")
        s1, g1, g2, s2 = (burst_ms(lambda p=p: ts.sell_spmv(p, x))
                          for p in (d, g, g, d))
        print(f"time B9 staging {label}, back-to-back: staged {s1:.4f} / "
              f"{s2:.4f} ms, global gathers {g1:.4f} / {g2:.4f} ms {card}",
              flush=True)

    def csr_tensor(A, dt):
        """A scipy matrix as a torch CSR tensor on the card."""
        A = A.tocsr()
        return torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(A.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(A.data, dtype=dt, device=dev), A.shape)

    A_sell_rcm = A_sell[opS.perm][:, opS.perm].tocsr()
    bsr = laplacian_3d_csr(NB).tobsr(blocksize=(8, 8))

    for dt in (f32, f64):
        dn = dname[dt]
        opPd = et.poisson_2d(NP, NP, dtype=dt, device=dev)
        xP = bP.to(dt)
        isz = torch.empty((), dtype=dt).element_size()
        nP = NP * NP
        # B7 as the main path calls it: BandedOperator.matvec on its plan
        pair_times("banded_spmv", dn, functools.partial(opPd.matvec, xP),
                   lambda: tsp.banded_spmv_ref(opPd.diags, opPd.offsets, xP),
                   f"poisson_2d({NP}, {NP}), BandedOperator.matvec",
                   ((opPd.diags.numel() + 2 * nP) * isz,
                    2 * opPd.diags.numel()),
                   ("CSR A @ x", lambda: (lambda A: lambda: A @ xP)(
                       csr_tensor(banded_csr(opPd), dt))),
                   kname="banded_spmv_kernel")
        per_call = median_ms(
            lambda: tsp.banded_spmv(opPd.diags, opPd.offsets, xP))
        print(f"time banded_spmv(diags, offsets, x) {dn} (poisson_2d({NP}, "
              f"{NP}), a plan built per call): {per_call:.4f} ms {card}",
              flush=True)
        opAd = et.advection_diffusion_1d(NA, peclet=10.0, dtype=dt,
                                         device=dev)
        xA = bA.to(dt)
        pair_times(f"banded_spmv n={NA}", dn,
                   functools.partial(opAd.matvec, xA),
                   lambda: tsp.banded_spmv_ref(opAd.diags, opAd.offsets, xA),
                   f"config #4 advection_diffusion_1d({NA}), "
                   "BandedOperator.matvec",
                   ((opAd.diags.numel() + 2 * NA) * isz,
                    2 * opAd.diags.numel()),
                   ("CSR A @ x", lambda: (lambda A: lambda: A @ xA)(
                       csr_tensor(banded_csr(opAd), dt))),
                   kname="banded_spmv_kernel")
        blocks, xB = opB3.blocks.to(dt), bB.to(dt)
        pair_times("blockell_spmv", dn,
                   functools.partial(tsp.blockell_spmv, blocks, opB3.bcols,
                                     xB),
                   lambda: tsp.blockell_spmv_ref(blocks, opB3.bcols, xB),
                   f"{NB}^3 7-point, 8x8 blocks, w={blocks.shape[1]}",
                   (blocks.numel() * isz
                    + opB3.bcols.numel() * opB3.bcols.element_size()
                    + 2 * NB ** 3 * isz, 2 * blocks.numel()),
                   ("torch.sparse_bsr_tensor @ x", lambda: (
                       lambda A: lambda: A @ xB[:, None])(
                           torch.sparse_bsr_tensor(
                               torch.as_tensor(bsr.indptr, dtype=torch.int64,
                                               device=dev),
                               torch.as_tensor(bsr.indices,
                                               dtype=torch.int64, device=dev),
                               torch.as_tensor(bsr.data, dtype=dt,
                                               device=dev), bsr.shape))),
                   kname="blockell_spmv")
        del blocks
        dS, xS = opS.data.to(dtype=dt), bS.to(dt)
        # the nonzeros with their column indices and x, y: what any
        # layout of this matrix must move (the SELL padding is not data)
        pair_times("sell_spmv", dn, functools.partial(ts.sell_spmv, dS, xS),
                   lambda: ts.sell_spmv_ref(dS, xS),
                   f"symmetrized bench_sell n=1e6 after RCM, {dS.nnz} nnz, "
                   f"{dS.vals.numel()} slots",
                   (dS.nnz * (isz + 4) + 2 * NS * isz, 2 * dS.nnz),
                   ("CSR A @ x", lambda: (lambda A: lambda: A @ xS)(
                       csr_tensor(A_sell_rcm, dt))),
                   kname="sell_spmv_kernel")
        staged_vs_global(f"RCM'd n=1e6 {dn}", dS, xS)
        dC, xC = sc_ops["seg"].data.to(dtype=dt), bC.to(dt)
        pC = ts.sell_spmv(dC.base, xC)
        pair_times("seg_compact", dn,
                   functools.partial(ts.seg_compact, pC, dC.seg_ptr),
                   lambda: ts.seg_compact_ref(pC, dC.seg_ptr),
                   f"symmetrized scattered n=1e6, L=16, {dC.base.n} segments",
                   (pC.numel() * isz
                    + dC.seg_ptr.numel() * dC.seg_ptr.element_size()
                    + NS * isz, pC.numel()),
                   ("torch.segment_reduce(sum)", lambda: (
                       lambda off: lambda: torch.segment_reduce(
                           pC, "sum", offsets=off, initial=0))(
                               dC.seg_ptr.to(torch.int64))),
                   kname="seg_compact_kernel")
        del dS, dC, pC

    # B9 at benchmarks/bench_sell.py's timing shape, with its rates
    # (bench_sell.py:84-87; itemsize 4 there, the float64 line uses 8)
    t0 = time.perf_counter()
    d7 = ts.sell_pack(bench_sell_coo(NS_TIME, 8, 700,
                                     np.random.default_rng(SEED + 4)),
                      NS_TIME, np.float32, device=dev)
    print(f"B9 timing pack n={NS_TIME}: {time.perf_counter() - t0:.1f} s on "
          f"the host, {d7.nnz} nnz, {d7.vals.numel()} slots", flush=True)
    for dt in (f32, f64):
        d = d7 if dt == f32 else d7.to(dtype=f64)
        x = vec(NS_TIME, dt, rng2)
        ms, plain = pair_times("sell_spmv n=1e7", dname[dt],
                               functools.partial(ts.sell_spmv, d, x),
                               lambda: ts.sell_spmv_ref(d, x),
                               "bench_sell n=1e7, d=8, band 700",
                               kname="sell_spmv_kernel")
        staged_vs_global(f"n=1e7 {dname[dt]}", d, x)
        isz = x.element_size()
        slots = d.vals.numel()
        for how, t in (("", ms * 1e-3),
                       (" back-to-back", bursts[("sell_spmv n=1e7",
                                                 dname[dt])] * 1e-3)):
            raw = (slots * isz + slots * 4 + 2 * NS_TIME * isz) / t / 1e9
            eff = ((isz + 4) * d.nnz + 2 * isz * NS_TIME) / t / 1e9
            print(f"rate B9 n=1e7 {dname[dt]}{how}: {t * 1e3:.4f} ms per "
                  f"matvec | raw-stream {raw:.1f} GB/s | effective-CSR "
                  f"{eff:.1f} GB/s | {d.nnz / t / 1e9:.2f} Gnnz/s {card}",
                  flush=True)
    del d7, d, x

    # B1, B5, B6 and B3 at the non-symmetric shapes of the polynomial path,
    # float64: the Newton rows of its Leja calls (B3: one accumulating
    # sweep on the 216^3 advection-diffusion stencil)
    from exponentialutilities_jl_torch.models import leja as tl

    opL, xL, opF, bF, opA = poly_ops
    opG2 = advection_2d(et, NG, f64, dev)
    xG2 = vec(NG * NG, f64, rng2)

    def newton_rows(op, t, tol):
        d, xi, c, s, _ = tl._leja_expv_setup(op, t, None, tol, None, 40.0)
        return torch.as_tensor(tl._newton_rows(d, xi, c, 1.0 / s),
                               device=dev)

    rL = newton_rows(opL, TL / math.ceil(TL * tl._interval_map(opL, None)[1]
                                         / 40.0), 1e-7)
    rA = newton_rows(opA, TA, 1e-12)
    rG = newton_rows(opG2, 20.0 / tl._interval_map(opG2, None)[1], 1e-12)
    n3 = NF ** 3
    ZF3, VcF, VpF = bF, vec(n3, f64, rng2), vec(n3, f64, rng2)
    WF = torch.zeros(n3, dtype=f64, device=dev)
    coF = torch.tensor([0.3, -0.7, 0.2, 0.45], dtype=f64, device=dev)
    for name, kfn, pfn, shape, wk, kname in (
            ("resident_recurrence nonsym",
             lambda: tr.recurrence_apply_resident(opL, xL, rL),
             lambda: tr.resident_recurrence_ref(
                 xL, rL, opL.coeffs, tr._flat_offsets(opL),
                 torch.tensor(1.0, dtype=f64, device=dev))[0],
             f"bench_leja n={NL}, Newton rows m={rL.shape[0]}",
             ((2 * NL + 4 * rL.shape[0] + 1) * 8,
              rL.shape[0] * NL * (2 * 3 + 6) + 2 * NL),
             "resident_nbr_kernel"),
            ("resident_banded nonsym",
             lambda: tr.recurrence_apply_resident_banded(opA, bA, rA),
             lambda: tr.resident_banded_ref(bA, rA, opA.diags, opA.offsets),
             f"config #4 n={NA}, Newton rows m={rA.shape[0]}",
             ((opA.diags.numel() + 2 * NA + 4 * rA.shape[0]) * 8,
              rA.shape[0] * NA * (2 * len(opA.offsets) + 6)), "Banded"),
            ("resident_grid nonsym",
             lambda: tr.recurrence_apply_resident_grid(opG2, xG2, rG),
             lambda: tr.resident_grid_ref(xG2, rG, opG2.grid_shape,
                                          opG2.offsets, opG2.coeffs),
             f"{NG}^2 2-D advection, Newton rows m={rG.shape[0]}",
             ((2 * NG * NG + 4 * rG.shape[0]) * 8,
              rG.shape[0] * NG * NG * (2 * 5 + 6)), "resident_grid_nbr"),
            ("fused_sweep nonsym",
             lambda: tf.fused_lanczos_step(ZF3, VcF, VpF, coF, opF,
                                           w_accum=WF),
             lambda: tf.fused_sweep_ref(ZF3, VcF, VpF, coF, opF.grid_shape,
                                        opF.offsets, opF.coeffs, WF),
             f"{NF}^3 advection_diffusion_3d_stencil, accumulating sweep",
             (7 * n3 * 8, n3 * (2 * 7 + 10)), "fused_sweep_kernel")):
        pair_times(name, "float64", kfn, pfn, shape, wk, kname=kname)
        bms, bby = bound(*wk, "float64")
        print(f"bound {name} float64: {bms:.6f} ms by {bby}; launches on "
              f"the polynomial path {poly_counts[name.split()[0]]} {card}",
              flush=True)
    # the polynomial and integrator path's cells: one-call medians (of 3
    # after a warm-up where phase 4's call took under 2 s, else that call)
    for name, fn in poly_calls.items():
        if poly_ms[name] < 2000:
            t, how = median_ms(fn, reps=3, warmup=1), "median of 3"
        else:
            t, how = poly_ms[name], "one call, phase 4"
        print(f"time main {name}: {t:.3f} ms ({how}) {card}", flush=True)

    # the dense and gradient path's cells: one-call medians (of 10 after
    # two warm-ups where phase 4's call took under 1 s, of 3 under 5 s,
    # else that call); each stack beside torch.linalg.matrix_exp on it and
    # at the TFLOP/s its degree and squaring count imply
    for name, fn in dense_calls.items():
        if dense_ms[name] < 1000:
            t, how = median_ms(fn), "median of 10"
        elif dense_ms[name] < 5000:
            t, how = median_ms(fn, reps=3, warmup=1), "median of 3"
        else:
            t, how = dense_ms[name], "one call, phase 4"
        line = f"time main {name}: {t:.3f} ms ({how})"
        if name.startswith("stack"):
            _, shape, dn, what = name.split()
            b_, n_ = (int(v) for v in shape.split("x"))
            X = dense_stacks[(b_, n_, dn)][0]
            fl, how_ = stack_flops(et, X, None if what == "expm" else KS)
            line += f", {fl / t / 1e9:.2f} TFLOP/s ({how_})"
            if what == "expm":
                lib = median_ms(lambda X=X: torch.linalg.matrix_exp(X))
                line += f"; torch.linalg.matrix_exp {lib:.3f} ms"
        print(f"{line} {card}", flush=True)

    def plain_op(op, fn, is_hermitian=True):
        return et.MatrixFreeOperator(fn, op.shape, dtype=f64,
                                     is_hermitian=is_hermitian, device=dev)

    plain_calls = {
        "1d cheb f32": lambda: et.expv_chebyshev(T1, op1[f32], b1[f32],
                                                 fused=False),
        "1d cheb f64": lambda: et.expv_chebyshev(T1, op1[f64], b1[f64],
                                                 tol=1e-12, fused=False),
        "1d two-pass m=40 f64": lambda: tx._expv_two_pass(op1[f64], b1[f64],
                                                          T1, 40),
        "3d cheb 32": lambda: et.expv_chebyshev(T3, op3[f32], b3[f32],
                                                tol=1e-7, fused=False),
        "3d cheb 64": lambda: et.expv_chebyshev(T3, op3[f64], b3[f64],
                                                tol=1e-12, fused=False),
        "3d two-pass m=20 32": lambda: tx._expv_two_pass(op3[f32], b3[f32],
                                                         T3, 20),
        "3d two-pass m=20 64": lambda: tx._expv_two_pass(op3[f64], b3[f64],
                                                         T3, 20),
    }
    plain_calls.update({
        "1d phiv two-pass m=40": lambda: tpv._phiv_two_pass(
            op1[f64], b1[f64], T1, 40, K),
        "1d phiv_chebyshev": lambda: et.phiv_chebyshev(
            T1, op1[f64], b1[f64], K, tol=1e-12, fused=False),
        "1d phiv_timestep_chebyshev": lambda: et.phiv_timestep_chebyshev(
            [0.25, 0.5], op1[f64], B1, tol=1e-12, fused=False),
        "config3 expv_chebyshev": lambda: et.expv_chebyshev(
            TP, opP, bP, tol=1e-12, fused=False),
        "2d cheb": lambda: et.expv_chebyshev(TG, opG, bG, tol=1e-12,
                                             fused=False),
        "2d two-pass m=20": lambda: tx._expv_two_pass(opG, bG, TG, 20),
    })
    # the same calls with each matvec on the SpMV kernels' plain twins
    pP = plain_op(opP, lambda v: tsp.banded_spmv_ref(opP.diags, opP.offsets,
                                                     v))
    pS = plain_op(opS, lambda v: ts.sell_spmv_ref(opS.data, v))
    pSeg = plain_op(opS, lambda v: ts.sell_spmv_seg_ref(sc_ops["seg"].data,
                                                         v))
    pH = plain_op(opH, lambda v: (tsp.banded_spmv_ref(
        opH.banded.diags, opH.banded.offsets, v)
        + ts.sell_spmv_ref(opH.sell.data, v)))
    pB = plain_op(opB3, lambda v: tsp.blockell_spmv_ref(opB3.blocks,
                                                        opB3.bcols, v))
    plain_calls.update({
        "config3 phiv m=30": lambda: et.phiv(TP, pP, bP, K, m=30),
        "sell expv m=40": lambda: et.expv(TS, pS, bS, m=40),
        "sell expv two-pass m=40": lambda: et.expv(TS, pS, bS, m=40,
                                                   two_pass=True),
        "scattered seg expv m=40": lambda: et.expv(TS, pSeg, bC, m=40),
        "hybrid expv m=40": lambda: et.expv(TS, pH, bH, m=40),
        f"blockell {NB}^3 two-pass m=20": lambda: et.expv(
            T3, pB, bB, m=20, two_pass=True),
    })
    # the variable path on the plain passes, config #4 on B7's twin
    for dt in (f32, f64):
        sfx = dname[dt][-2:]
        plain_calls[f"var cheb {sfx}"] = (
            lambda dt=dt: et.expv_chebyshev(T3, opV[dt], bV[dt],
                                            tol=cheb_tol[dt], fused=False))
        plain_calls[f"var two-pass m=20 {sfx}"] = (
            lambda dt=dt: tx._expv_two_pass(opV[dt], bV[dt], T3, 20))
    pA = plain_op(opA, lambda v: tsp.banded_spmv_ref(opA.diags, opA.offsets,
                                                     v), is_hermitian=False)
    plain_calls.update({
        f"var{NV} cheb": lambda: et.expv_chebyshev(T3, opV48, bV48, tol=1e-12,
                                                   fused=False),
        f"var{NV} two-pass m=20": lambda: tx._expv_two_pass(opV48, bV48, T3,
                                                           20),
        f"config4 expv m={MA}": lambda: et.expv(TA, pA, bA, m=MA),
        f"config4 phiv k=1 m={MA}": lambda: et.phiv(TA, pA, bA, 1, m=MA,
                                                    errest=True),
        f"config4 two-pass iop=2 m={MA}": lambda: et.expv(
            TA, pA, bA, m=MA, iop=2, two_pass=True),
        f"config4 iop=2 reorth=False m={MA}": lambda: et.expv(
            TA, pA, bA, m=MA, iop=2, reorth=False),
    })
    tmain = {}
    for name, fn in {**calls, **phi_calls, **sparse_calls, **var_calls,
                     **nh_calls}.items():
        # medians of 5: most of these cells are host-bound launch chains
        # (depth cut, for the script's time limit)
        k = tmain[name] = median_ms(fn, reps=5)
        line = f"time main {name}: {k:.3f} ms (median of 5)"
        if name in plain_calls:
            # kernel against plain twin with both loops eager (the SELL
            # twin reads the device, so it cannot run from graphs): the
            # ratio then counts kernel speed, not graph launch savings
            with graphs.eager():
                ke = median_ms(fn, reps=5, warmup=1)
                p = median_ms(plain_calls[name], reps=5, warmup=1)
            line += (f", under graphs.eager() {ke:.3f} ms, plain path "
                     f"{p:.3f} ms (eager; medians of 5)")
        if name.endswith(" reduced=host"):
            line += (f", reduced=device {tmain[name[:-len(' reduced=host')]]:.3f}"
                     " ms")
        print(f"{line} {card}", flush=True)
    # the fourth path: rank 0's CUDA-event medians (measured while the
    # ranks ran, P processes time-sharing this card, gloo staging through
    # the host: no scaling numbers) beside the single-device call
    for name, single in shard_singles.items():
        t1 = median_ms(single, reps=5, warmup=1)
        for tag in sorted({tg for tg, _ in shard_ms}):
            if (tag, name) in shard_ms:
                reps = 3 if name.startswith("leja") else SHARD_REPS
                print(f"time sharded {tag} {name}: {shard_ms[(tag, name)]:.3f}"
                      f" ms (rank 0, median of {reps}); single-device "
                      f"{t1:.3f} ms {card}", flush=True)
    # the fifth path: rank 0's CUDA-event medians beside the single-device
    # call on this card (the same caveats)
    for name, single in gspmd_singles.items():
        long = name in GSPMD_LONG
        t1 = median_ms(single, reps=1, warmup=0) if long else \
            median_ms(single, reps=5, warmup=1)
        how = "one call" if long else "median of 5"
        for tag in sorted({tg for tg, _ in gspmd_ms}):
            if (tag, name) in gspmd_ms:
                print(f"time GSPMD {tag} {name}: {gspmd_ms[(tag, name)]:.3f}"
                      f" ms (rank 0, {how}); single-device {t1:.3f} ms "
                      f"({how}) {card}", flush=True)
    for tag in sorted({tg for tg, _ in shard_ms}):
        print(f"time sharded {tag} {N3}^3 pass 1 m=20: "
              f"{shard_ms[(tag, 'pass1 sharded')]:.3f} ms, the same sweeps "
              "on the rank's slab alone "
              f"{shard_ms[(tag, 'pass1 slab alone')]:.3f} ms: the halo "
              "exchanges and psums take "
              f"{shard_ms[(tag, 'staging share')]:.1%} of a step {card}",
              flush=True)
    # the adaptive drivers: up to seconds a call, so a median of 3 after
    # one warm-up (depth cut from 5, for the script's time limit)
    for name, fn in {**drv_calls,
                     "config4 make_phiv_timestep fn(B)": lambda: fn4(B4)
                     }.items():
        print(f"time main {name}: {median_ms(fn, reps=3, warmup=1):.3f} ms "
              f"(median of 3) {card}", flush=True)
    # the sixth path's cells from their CUDA graphs (each call captures
    # anew: the graphs live for one call)
    for name, fn in graph_calls.items():
        print(f"time graph {name}: {median_ms(fn, reps=3, warmup=1):.3f} "
              f"ms (median of 3) {card}", flush=True)
    # R1 at the serving and two-pass orders (m = 40 is the kernels
    # line's), before the profiler runs
    from exponentialutilities_jl_torch.ops.kernels import tridiag as tt
    r1 = r1_times(dev, card, median_ms, burst_ms)
    times[("tridiag_exp", "float64")] = r1[40][:2]
    lib_ms[("tridiag_exp", "float64")] = r1[40][2]
    # a Hermitian Krylov call at m = 250 (config #3's operator, the basis
    # path): R1 at its largest order on the main path, beside R1's own
    # time and eigh's there (hermitian_times.py runs it against an earlier
    # tree)
    e250 = median_ms(lambda: et.expv(TP, opP, bP, m=250), reps=5, warmup=1)
    print(f"time main config3 expv m=250 (Hermitian, basis path): "
          f"{e250:.3f} ms (median of 5); its reduced stage R1 at m=250 "
          f"{r1[250][0]:.4f} ms, torch.linalg.eigh + combination "
          f"{r1[250][2]:.4f} ms {card}", flush=True)
    work[("tridiag_exp", "float64")] = r1_work(40)
    a40, b40 = r1_inputs(40, f64, dev, SEED + 90)
    t40 = torch.tensor(0.6, dtype=f64, device=dev)
    device_jobs.append(("tridiag_exp", "float64",
                        lambda: tt.tridiag_exp_e1(a40, b40, t40),
                        "tridiag_exp_kernel"))
    # K1-K4, timed on the eleventh path
    for name, (km, pm, lm, wk, err) in batched_kinfo.items():
        times[(name, "float64")] = (km, pm)
        work[(name, "float64")] = wk
        if lm is not None:
            lib_ms[(name, "float64")] = lm
        kerr[name] = err
    device_jobs.extend(batched_jobs)
    for name, dn, kfn, kname in device_jobs:
        ms, cnt = device_ms(kfn, kname)
        print(f"device {name} {dn}: " + (
            f"{ms:.4f} ms per launch (profiler, {cnt} launches)"
            if ms is not None else
            f"not measured (profiler saw {cnt} {kname} launches of 20)")
            + f" {card}", flush=True)

    # the seventh and eighth paths' device busy and host launch calls,
    # profiled last
    krylov_graph_profile(krylov_calls, card)
    serving_profile(serving_calls, card)
    krylov_graph_profile(fixed_calls, card, label="fixed")
    krylov_graph_profile(batched_calls, card, label="batched",
                         forms=("graph",))

    phase_done("5 times")
    kernels = []
    for name in REPLACES:
        ms, plain_ms = times[(name, "float64")]
        bound_ms, bound_by = bound(*work[(name, "float64")], "float64")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name],
                        "launches": (main_counts[name] + poly_counts[name]
                                     + dense_counts[name]
                                     + shard_counts[name]
                                     + gspmd_counts[name]
                                     + graph_counts.get(name, 0)
                                     + krylov_counts.get(name, 0)
                                     + serving_counts.get(name, 0)
                                     + fixed_counts.get(name, 0)
                                     + poly_counts10.get(name, 0)
                                     + batched_counts.get(name, 0)),
                        "max_abs_err": kerr[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": lib_ms.get((name, "float64"))})
        print(f"bound {name} float64: {bound_ms:.4f} ms by {bound_by} "
              f"({work[(name, 'float64')][0] / 1e6:.1f} MB, "
              f"{work[(name, 'float64')][1] / 1e6:.1f} Mflop); kernel "
              f"{ms:.4f} ms = {bound_ms / ms:.1%} of the bound {card}",
              flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

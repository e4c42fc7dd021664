// R1: the Hermitian reduced exponential of the Krylov paths,
//   out = s Q exp(t Lambda) Q^T e1,   T = Q Lambda Q^T,
// T the real symmetric tridiagonal with diagonal alpha (m values) and
// off-diagonal beta (m - 1 values), t real or complex, s an optional real
// scale (beta0 in the two-pass coefficients).
//
// R1 replaces no TPU kernel. The JAX package evaluates this formula with
// XLA's eigh inside one compiled program
// (exponentialutilities_jl_tpu/models/expv.py: _exp_reduced_e1,
// _lanczos_reduced_coeffs and the error-estimate loop's body). On the
// H100 torch.linalg.eigh reads its info to the host (a sync), so it cannot
// run inside a CUDA graph; R1 gives the port the same result with no host
// read.
//
// Design: Cuppen's divide and conquer over one block, on the leading
// unreduced block only, with no eigenvector matrix formed.
// 1. The leading block. Every thread tests its couplings with the QL
//    deflation test |e_i| + |d_i| + |d_{i+1}| == |d_i| + |d_{i+1}|; a
//    block-wide minimum gives the order n of the block that e1 excites
//    (the error-estimate loop's masked tridiagonal at step j: n = j + 1).
//    out[n:] = 0 and everything below works at order n, scaled by the power
//    of two at or above its largest entry (exact).
// 2. The tear. The tree over [0, n) splits a node [lo, hi) at
//    lo + (hi - lo) / 2 down to leaves of one row, so every coupling e_i is
//    torn once: both of its rows lose |e_i| and the leaves' eigenvalues are
//    the torn diagonal. (Leaves of several rows solved by QL would pay its
//    chain of dependent rotations, ~0.25 us each on the H100; a leaf of one
//    row needs none.) The depth is ceil(log2 n): 8 levels at n = 250.
// 3. The merges, one level at a time, every node of a level at once. A
//    node's matrix is diag(Q_L, Q_R) (D + rho z z^T) diag(Q_L, Q_R)^T with
//    rho = 2 |beta|, z = (last row of Q_L, sign(beta) first row of Q_R) /
//    sqrt 2. Phases, each ended by a barrier:
//    A. a stable rank sort of the poles (one group of lanes a pole);
//    B. deflation, one warp a node, as LAPACK's dlaed2: a small rho |z_j|
//       drops out, a pair of near-equal poles is rotated (Givens, the
//       rotations kept in order) so that one of them drops out; the warp
//       writes the result in parallel up to the first pair that rotates,
//       one lane scans serially from there;
//    C. the secular roots, one group a root, each kept as its origin pole
//       and an offset tau, so that d_i - lambda = (d_i - d_origin) - tau
//       has no cancellation (dlaed4's representation): a first guess from
//       the root's two poles exact and the others frozen at the midpoint,
//       then two-pole rational steps (the fixed weight and the middle way,
//       switched as dlaed4 does), inside a bracket kept by bisection; the
//       groups of a warp step in lockstep until all have converged;
//    D. z recomputed from the roots (Gu and Eisenstat's Loewner formula,
//       dlaed3), so that the implicit eigenvectors U(i, k) = zh_i /
//       (d_i - lambda_k) / ||.||_k are orthogonal to working precision;
//    E. the node's eigenvalues, its column norms and its first and last
//       rows, (first row of the children) . G . U, O(K) work a column.
//    No node forms Q: it keeps only O(n) values (poles, zh, origins,
//    offsets, norms, the sort and the rotations) per level.
// 4. The root's first row is Q^T e1, so w = s e^{t lambda} (Q^T e1) (a real
//    and an imaginary part for complex t), and out = Q w is formed level by
//    level down the tree: at each node y = U w (one group a row), the
//    rotations in reverse order (one thread a node), then the sort undone,
//    which hands each child its part of y; the leaves' y is out.
// Threads: 512, in groups of G lanes (the host's ``lanes``: a power of two
// up to 32, so that a level's n roots or rows each have a group); a group
// shares a root's or a row's K terms and sums them by a butterfly of
// full-warp shuffles, every loop over items stepping a warp's groups
// together. All arithmetic is in double, for float32 data too. Every sum
// runs in a fixed order and the atomics are a minimum and maxima, so
// results are bitwise repeatable. An input that is not finite, or a
// secular root that has not converged in max_iter steps, poisons every
// row with NaN.
// Storage: 8 working vectors of n doubles, and per level 7 arrays of
// doubles and 6 of shorts, O(m log m), in dynamic shared memory when they
// fit the budget the host picks (ops/kernels/tridiag.py: m <= 302; the
// kernel is then compiled for shared-memory addresses), else in a global
// scratch buffer that the wrapper allocates. t, s and the diagonals are
// read from device memory, so a launch captured into a CUDA graph reads
// the values of each replay.
// K2, the batched form (tridiag_exp_e1_batched, expv_batched's reduced
// exponentials): a grid of one block per row, each running the body above
// unchanged on its own row (its own leading unreduced block, its own
// workspace: shared memory up to m = 302, else its slice of a global
// scratch of batch x work_bytes(m)), so each row's bits are R1's on that
// row; the rows share t. It replaces XLA's batched eigh under JAX's vmap
// of _exp_reduced_e1 and _lanczos_reduced_coeffs.
// Bound: about 25 K^2 operations a node for one evaluation of each
// secular function, the recomputed z, the rows and the way down, O(n^2)
// work spread over ceil(log2 n) levels, against the ~n^2 dependent
// rotations of implicit QL. What bounds it on the H100 is latency: the
// secular roots' evaluations, ~1-2k cycles each (reciprocals, butterflies,
// the update's divisions and root), times the slowest root's count in
// each level (up to ~9), then the barriers between the phases.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr double kEps = 2.220446049250313e-16;   // 2^-52
constexpr double kRsqrt2 = 0.70710678118654752440;
constexpr int kMaxThreads = 512;

// merge levels of the tree over n rows: ceil(log2 n)
__host__ __device__ inline int tree_depth(int n) {
  int d = 0;
  while ((1 << d) < n) ++d;
  return d;
}

// The workspace (module comment): working vectors, then per level (index
// level * m + position) the arrays the way down reads.
struct Work {
  double *lam, *frow, *lrow, *ev, *t0, *t1, *t2, *t3;
  double *dk, *zh, *tau, *dorg, *inrm, *rc, *rs;
  short *sidx, *col, *rp, *rn, *nk, *nr;
};

__host__ __device__ inline size_t level_len(int m) {
  return (size_t)(tree_depth(m) > 0 ? tree_depth(m) : 1) * m;
}

__host__ __device__ inline size_t work_bytes(int m) {
  return 8 * (8 * (size_t)m + 7 * level_len(m)) + 2 * 6 * level_len(m);
}

__device__ __forceinline__ Work layout(double* p, int m) {
  const size_t lv = level_len(m);
  Work w;
  w.lam = p;
  w.frow = p + m;
  w.lrow = p + 2 * (size_t)m;
  w.ev = p + 3 * (size_t)m;
  w.t0 = p + 4 * (size_t)m;
  w.t1 = p + 5 * (size_t)m;
  w.t2 = p + 6 * (size_t)m;
  w.t3 = p + 7 * (size_t)m;
  double* q = p + 8 * (size_t)m;
  w.dk = q;
  w.zh = q + lv;
  w.tau = q + 2 * lv;
  w.dorg = q + 3 * lv;
  w.inrm = q + 4 * lv;
  w.rc = q + 5 * lv;
  w.rs = q + 6 * lv;
  short* s = reinterpret_cast<short*>(q + 7 * lv);
  w.sidx = s;
  w.col = s + lv;
  w.rp = s + 2 * lv;
  w.rn = s + 3 * lv;
  w.nk = s + 4 * lv;
  w.nr = s + 5 * lv;
  return w;
}

// The internal node [lo, hi) at depth level that holds position p, split
// at mid; false when p lies in a leaf by then.
__device__ __forceinline__ bool node_at(int p, int level, int n, int& lo, int& mid,
                               int& hi) {
  lo = 0;
  hi = n;
  for (int l = 0; l < level; ++l) {
    if (hi - lo < 2) return false;
    const int md = lo + ((hi - lo) >> 1);
    if (p < md)
      hi = md;
    else
      lo = md;
  }
  if (hi - lo < 2) return false;
  mid = lo + ((hi - lo) >> 1);
  return true;
}

// A group: G consecutive lanes of a warp (G a power of two up to 32) that
// share one root or row; each lane takes the terms i = lane, lane + G, ...
// and a butterfly gives every lane the same total, bit for bit (each step
// adds the same two values, in either order). Every lane of the warp
// takes part in every butterfly (a full-warp mask, known when compiled):
// the phases' loops over items are uniform across a warp (``Items``), and
// a group with no item adds zeros. A runtime mask of the group's lanes
// measured ~300 cycles a shuffle on the H100 once the warp's groups had
// diverged.
struct Group {
  int G, lane;
  // N sums at once: each round's N shuffles are independent, so their
  // latencies overlap (one butterfly after another cost ~70 cycles a
  // round each)
  template <int N>
  __device__ __forceinline__ void sums(double (&v)[N]) const {
    for (int off = G >> 1; off > 0; off >>= 1) {
      double t[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        t[k] = __shfl_xor_sync(0xffffffffu, v[k], off, G);
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] += t[k];
    }
  }
  __device__ __forceinline__ double sum(double v) const {
    double a[1] = {v};
    sums(a);
    return a[0];
  }
  __device__ __forceinline__ double prod(double v) const {
    for (int off = G >> 1; off > 0; off >>= 1)
      v *= __shfl_xor_sync(0xffffffffu, v, off, G);
    return v;
  }
  __device__ __forceinline__ int isum(int v) const {
    for (int off = G >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off, G);
    return v;
  }
};

// The root of A x^2 + B x + C in (lo, hi) by the stable formulas, the
// bracket's midpoint when neither root lies in it.
__device__ __forceinline__ double quad_root(double A, double B, double C, double lo,
                                   double hi) {
  const double disc = sqrt(fmax(B * B - 4.0 * A * C, 0.0));
  const double q = -0.5 * (B + copysign(disc, B));
  const double x1 = A != 0.0 ? q / A : NAN;
  const double x2 = q != 0.0 ? C / q : NAN;
  if (lo < x1 && x1 < hi) return x1;
  if (lo < x2 && x2 < hi) return x2;
  return 0.5 * (lo + hi);
}

// Root k of 1/rho + sum_i z_i^2 / (d_i - lambda) over the K kept poles d
// (ascending) as lambda = d[org] + tau (module comment, phase C), by one
// group; false when it has not converged in max_iter evaluations. A group
// without a root (act false) only takes part in the warp's butterflies:
// the groups of a warp evaluate in lockstep, each one frozen once it has
// converged, until every one has.
__device__ __forceinline__ bool secular_root(const Group& gr, bool act,
                                             const double* d,
                                             const double* z, int K,
                                             double rho, int k, int max_iter,
                                             double& dorg_out,
                                             double& tau_out) {
  const bool last = act && k == K - 1;
  const double rinv = 1.0 / rho;
  // the first guess: the root's two poles exact, the others frozen at the
  // interval's midpoint (the last root: the last two, at the midpoint of
  // (0, rho z^T z])
  double zt = 0.0;
  if (last)
    for (int i = gr.lane; i < K; i += gr.G) zt += z[i] * z[i];
  zt = gr.sum(zt);
  const double h = last ? 0.5 * rho * zt : act ? 0.5 * (d[k + 1] - d[k]) : 0;
  double c = 0.0;
  if (act)
    for (int i = gr.lane; i < K; i += gr.G)
      if (last ? i < k - 1 : i != k && i != k + 1)
        c += z[i] * z[i] / ((d[i] - d[k]) - h);
  c = rinv + gr.sum(c);
  int o = k;
  double lo = 0.0, hi = 0.0, tau = 0.0;
  if (last) {
    const double dd = K == 1 ? 1.0 : d[k] - d[k - 1];
    const double z2 = K == 1 ? 0.0 : z[k - 1] * z[k - 1];
    const double zk2 = z[k] * z[k];
    hi = 2.0 * h;
    tau = fmin(quad_root(c, c * dd - z2 - zk2, -zk2 * dd, lo,
                         hi * 1.0000001),
               hi);
  } else if (act) {
    const double dd = 2.0 * h;
    const double zk2 = z[k] * z[k], zk12 = z[k + 1] * z[k + 1];
    // its sign at the midpoint says which pole is nearer
    if (c + zk2 / (-h) + zk12 / h >= 0.0) {
      hi = h;
      tau = quad_root(c, -(c * dd + zk2 + zk12), zk2 * dd, lo, hi);
    } else {
      o = k + 1;
      lo = -h;
      tau = quad_root(c, c * dd - zk2 - zk12, -zk12 * dd, lo, hi);
    }
  }
  const double dorg = act ? d[o] : 0.0;
  bool fw = true, done = !act, ok = !act;
  double fprev = INFINITY;
  for (int it = 0; it < max_iter && __any_sync(0xffffffffu, !done); ++it) {
    double psi = 0.0, dpsi = 0.0, phi = 0.0, dphi = 0.0;
    if (!done) {
#pragma unroll 4
      for (int i = gr.lane; i < K; i += gr.G) {
        const double r = 1.0 / ((d[i] - dorg) - tau);
        const double q = z[i] * z[i] * r;
        if (i <= k) {
          psi += q;
          dpsi += q * r;
        } else {
          phi += q;
          dphi += q * r;
        }
      }
    }
    double tot[4] = {psi, dpsi, phi, dphi};
    gr.sums(tot);
    psi = tot[0];
    dpsi = tot[1];
    phi = tot[2];
    dphi = tot[3];
    if (done) continue;
    const double f = rinv + psi + phi;
    const double err =
        kEps * (8.0 * (phi - psi) + 2.0 * rinv + fabs(tau) * (dpsi + dphi));
    if (fabs(f) <= err) {
      done = ok = true;
      continue;
    }
    if (f < 0.0)
      lo = tau;
    else
      hi = tau;
    if (it == 1)
      fw = !((o == k ? -f : f) > 0.1 * fabs(fprev));
    else if (it > 1 && f * fprev > 0.0 && fabs(f) > 0.1 * fabs(fprev))
      fw = !fw;
    fprev = f;
    double da = (d[k] - dorg) - tau, eta;
    if (last) {
      // the last term exact, the others by the pole next to it fitted to
      // their value and slope: the larger root of the model's quadratic
      const double db = da, zk2 = z[k] * z[k], idb = 1.0 / db;
      if (k == 0) {
        const double cc = f - zk2 * idb;
        eta = cc > 0.0 ? db + zk2 / cc : NAN;
      } else {
        da = (d[k - 1] - dorg) - tau;
        const double ida = 1.0 / da;
        const double s = (dpsi - zk2 * idb * idb) * da * da;
        const double cc = f - s * ida - zk2 * idb;
        const double a1 = cc * (da + db) + s + zk2, a0 = da * db * f;
        const double disc = sqrt(fmax(a1 * a1 - 4.0 * cc * a0, 0.0));
        eta = a1 >= 0.0 ? (a1 + disc) / (2.0 * cc) : 2.0 * a0 / (a1 - disc);
      }
    } else {
      const double db = (d[k + 1] - dorg) - tau;
      const double ida = 1.0 / da, idb = 1.0 / db;
      double s, S;
      if (!fw) {                         // the middle way
        s = dpsi * da * da;
        S = dphi * db * db;
      } else if (o == k) {               // the fixed weight
        s = z[k] * z[k];
        S = (dpsi - s * ida * ida + dphi) * db * db;
      } else {
        S = z[k + 1] * z[k + 1];
        s = (dphi - S * idb * idb + dpsi) * da * da;
      }
      const double cc = f - s * ida - S * idb;
      const double a1 = cc * (da + db) + s + S, a0 = da * db * f;
      const double disc = sqrt(fmax(a1 * a1 - 4.0 * cc * a0, 0.0));
      eta = a1 <= 0.0 ? (a1 - disc) / (2.0 * cc) : 2.0 * a0 / (a1 + disc);
    }
    double tn = tau + eta;
    if (!(lo < tn && tn < hi)) tn = 0.5 * (lo + hi);   // NaN too
    if (tn == tau || hi - lo <= 2.0 * kEps * fmax(fabs(lo), fabs(hi)))
      done = ok = true;
    tau = tn;
  }
  dorg_out = dorg;
  tau_out = tau;
  return ok;
}

// Phase B's serial scan of the node [lo, hi) at level lv (module
// comment), from position s0 with the state the scan had there: K kept,
// ndef deflated, the candidate pj (-1: none) with its z and d. The sorted
// poles, z and rows are in t0..t3 at lo ..; it writes the node's
// eigen-coordinates (col: kept first, ascending, then deflated), the kept
// poles and z (dk, zh), the rotations, the counts, the rotated rows and
// the deflated poles. The pair test |t c s| <= tol is taken as
// |t z_j z_p| <= tol (z_j^2 + z_p^2), with no root or division unless the
// pair rotates; each step's loads are issued a step ahead.
__device__ __forceinline__ void deflate_scan(const Work& w, int m, int lv,
                                             int lo, int hi, double rho,
                                             double tol, int s0, int K,
                                             int ndef, int pj, double zp,
                                             double dp) {
  const int nn = hi - lo;
  double* ds = w.t0 + lo;
  const double* zs = w.t1 + lo;
  double* gf = w.t2 + lo;
  double* gl = w.t3 + lo;
  const size_t at = (size_t)lv * m + lo;
  short* col = w.col + at;
  double* dk = w.dk + at;
  double* zk = w.zh + at;
  int nrot = 0;
  double zc = zs[s0], dc = ds[s0];
  for (int s = s0; s < nn; ++s) {
    const double zn = s + 1 < nn ? zs[s + 1] : 0.0;
    const double dn = s + 1 < nn ? ds[s + 1] : 0.0;
    if (rho * fabs(zc) <= tol) {
      col[nn - ++ndef] = (short)s;
    } else if (pj < 0) {
      pj = s;
      zp = zc;
      dp = dc;
    } else if (fabs((dc - dp) * zc * zp) <= tol * (zc * zc + zp * zp)) {
      const double tau = hypot(zc, zp);
      const double c = zc / tau, sn = -zp / tau;
      double x = gf[pj], y = gf[s];
      gf[pj] = c * x + sn * y;
      gf[s] = c * y - sn * x;
      x = gl[pj];
      y = gl[s];
      gl[pj] = c * x + sn * y;
      gl[s] = c * y - sn * x;
      ds[pj] = dp * c * c + dc * sn * sn;
      w.rp[at + nrot] = (short)pj;
      w.rn[at + nrot] = (short)s;
      w.rc[at + nrot] = c;
      w.rs[at + nrot] = sn;
      ++nrot;
      col[nn - ++ndef] = (short)pj;
      pj = s;
      zp = tau;
      dp = dp * sn * sn + dc * c * c;
    } else {
      dk[K] = dp;
      zk[K] = zp;
      col[K++] = (short)pj;
      pj = s;
      zp = zc;
      dp = dc;
    }
    zc = zn;
    dc = dn;
  }
  if (pj >= 0) {
    dk[K] = dp;
    zk[K] = zp;
    col[K++] = (short)pj;
  }
  w.nk[at] = (short)K;
  w.nr[at] = (short)nrot;
}

// Phase B for one node by one warp of W lanes (W = 32; fewer only where
// the block has fewer threads): the tolerance (dlaed2's 8 eps max(|d|,
// |z|)) by a warp maximum, then the positions in chunks of W, each lane
// one: a small rho |z| deflates; every other position is tested with the
// one before it that is not small, with the values as sorted. Up to the
// first position that passes that test nothing rotates, so the serial
// scan's output there (kept positions ascending, the small ones from the
// end) is written in parallel; from that position on the lane that found
// it runs the serial scan (deflate_scan), from the state it had there.
__device__ __forceinline__ void deflate_warp(const Work& w, int m, int lv,
                                             int lo, int hi, double rho,
                                             int lane, int W) {
  const unsigned full = W == 32 ? 0xffffffffu : (1u << W) - 1u;
  const int nn = hi - lo;
  const double* ds = w.t0 + lo;
  const double* zs = w.t1 + lo;
  const size_t at = (size_t)lv * m + lo;
  short* col = w.col + at;
  double* dk = w.dk + at;
  double* zk = w.zh + at;
  double dmx = 0.0, zmx = 0.0;
  for (int s = lane; s < nn; s += W) {
    dmx = fmax(dmx, fabs(ds[s]));
    zmx = fmax(zmx, fabs(zs[s]));
  }
  for (int off = W >> 1; off > 0; off >>= 1) {   // maxima: exact
    dmx = fmax(dmx, __shfl_xor_sync(full, dmx, off));
    zmx = fmax(zmx, __shfl_xor_sync(full, zmx, off));
  }
  const double tol = 8.0 * kEps * fmax(dmx, zmx);
  const unsigned below = (1u << lane) - 1u;
  int K = 0, nsmall = 0, prevpos = -1;
  double zprev = 0.0, dprev = 0.0;
  for (int c0 = 0; c0 < nn; c0 += W) {
    const int s = c0 + lane;
    const bool inr = s < nn;
    const double zc = inr ? zs[s] : 0.0, dc = inr ? ds[s] : 0.0;
    const bool small = inr && rho * fabs(zc) <= tol, keep = inr && !small;
    const unsigned kb = __ballot_sync(full, keep);
    const unsigned sb = __ballot_sync(full, small);
    const unsigned kbl = kb & below;
    const int src = kbl ? 31 - __clz(kbl) : lane;
    const double zpl = __shfl_sync(full, zc, src);
    const double dpl = __shfl_sync(full, dc, src);
    const double zp = kbl ? zpl : zprev, dp = kbl ? dpl : dprev;
    const bool pair = keep && (kbl || prevpos >= 0) &&
                      fabs((dc - dp) * zc * zp) <= tol * (zc * zc + zp * zp);
    const unsigned pb = __ballot_sync(full, pair);
    const int first = pb ? __ffs(pb) - 1 : W;
    if (keep && lane < first) {
      const int r = K + __popc(kbl);
      col[r] = (short)s;
      dk[r] = dc;
      zk[r] = zc;
    }
    if (small && lane < first)
      col[nn - 1 - (nsmall + __popc(sb & below))] = (short)s;
    if (pb) {
      __syncwarp(full);
      if (lane == first)
        deflate_scan(w, m, lv, lo, hi, rho, tol, s, K + __popc(kbl) - 1,
                     nsmall + __popc(sb & below),
                     kbl ? c0 + src : prevpos, zp, dp);
      return;
    }
    K += __popc(kb);
    nsmall += __popc(sb);
    if (kb) {
      const int last = 31 - __clz(kb);
      zprev = __shfl_sync(full, zc, last);
      dprev = __shfl_sync(full, dc, last);
      prevpos = c0 + last;
    }
  }
  if (lane == 0) {
    w.nk[at] = (short)K;
    w.nr[at] = 0;
  }
}

// thread 0 stamps the clock after a barrier when the caller asks for the
// phases' times (``clocks``, a timing script's; null in every other call)
struct Stamps {
  long long* clk;
  int i;
  __device__ inline void operator()() {
    if (clk && threadIdx.x == 0) clk[++i] = clock64();
  }
};

template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
    tridiag_exp_kernel(const T* __restrict__ alpha,
                       const T* __restrict__ beta, const T* __restrict__ tp,
                       int t_complex, const T* __restrict__ sp,
                       T* __restrict__ out, double* scratch, int m,
                       int max_iter, int G, long long* clocks,
                       long long scratch_stride) {
  extern __shared__ double smem[];
  // K2 (the batched form): block r runs R1 on row r of (alpha, beta, s,
  // out) and of the global scratch; a launch of one block is R1
  {
    const long long r = blockIdx.x;
    alpha += r * m;
    beta += r * (m > 0 ? m - 1 : 0);
    if (sp) sp += r;
    out += r * m * (t_complex ? 2 : 1);
    if (scratch) scratch += r * scratch_stride;
  }
  __shared__ int s_n, s_bad;
  __shared__ unsigned long long s_max;
  const int nt = blockDim.x, tid = threadIdx.x;
  // kShared: the workspace is this block's shared memory, so every
  // access compiles to a shared-memory instruction (a generic one takes
  // ~75 cycles on the H100, a shared one ~45)
  const Work w = layout(kShared ? smem : scratch, m);
  // one group of G lanes a root or row (Group), NG groups in all; the
  // loops over items step a warp's groups together: item p0 + gsub of a
  // warp whose first group is p0, while p0 < n (uniform across the warp)
  const int NG = nt / G, gid = tid / G, gsub = gid % (32 / G);
  const int gbase = gid - gsub;
  const int W = nt < 32 ? nt : 32;       // a warp's lanes
  Group gr;
  gr.G = G;
  gr.lane = tid % G;
  Stamps stamp{clocks, 0};
  if (clocks && tid == 0) clocks[0] = clock64();

  // 1. the leading block and the scale
  if (tid == 0) {
    s_n = m;
    s_bad = 0;
    s_max = 0ull;
  }
  __syncthreads();
  for (int i = tid; i < m - 1; i += nt) {
    const T dd = fabs(alpha[i]) + fabs(alpha[i + 1]);
    if (fabs(beta[i]) + dd == dd) atomicMin(&s_n, i + 1);
  }
  __syncthreads();
  const int n = s_n;
  for (int i = tid; i < n; i += nt) {
    // |x| as bits: ordered as the values, NaN above infinity
    atomicMax(&s_max, (unsigned long long)__double_as_longlong(
                          fabs((double)alpha[i])));
    if (i < n - 1)
      atomicMax(&s_max, (unsigned long long)__double_as_longlong(
                            fabs((double)beta[i])));
  }
  __syncthreads();
  const double mx = __longlong_as_double((long long)s_max);
  const bool finite = isfinite(mx);
  int ex = 0;
  if (finite && mx > 0.0) frexp(mx, &ex);
  const double scale = ldexp(1.0, ex);
  const int depth = tree_depth(n);

  if (finite) {
    // 2. the tear: the leaves' eigenvalues and rows
    for (int i = tid; i < n; i += nt) {
      double v = (double)alpha[i] / scale;
      if (i < n - 1) {
        const double e = (double)beta[i] / scale;
        w.ev[i] = e;
        v -= fabs(e);
      }
      if (i > 0) v -= fabs((double)beta[i - 1] / scale);
      w.lam[i] = v;
      w.frow[i] = 1.0;
      w.lrow[i] = 1.0;
    }
    __syncthreads();
    stamp();
    // 3. the merges, deepest level first
    for (int lv = depth - 1; lv >= 0; --lv) {
      int lo, mid, hi;
      const size_t L = (size_t)lv * m;
      // A. sort the poles with z and the rows carried up
      for (int p0 = gbase; p0 < n; p0 += NG) {
        const int p = p0 + gsub;
        const bool in = p < n && node_at(p, lv, n, lo, mid, hi);
        const double v = in ? w.lam[p] : 0.0;
        int r = 0;
        if (in)
          for (int q = lo + gr.lane; q < hi; q += G) {
            const double u = w.lam[q];
            r += (u < v) || (u == v && q < p);
          }
        r = gr.isum(r);
        if (!in || gr.lane) continue;
        const int j = p - lo, n1 = mid - lo;
        const double sg = w.ev[mid - 1] >= 0.0 ? 1.0 : -1.0;
        w.t0[lo + r] = v;
        w.t1[lo + r] = (j < n1 ? w.lrow[p] : sg * w.frow[p]) * kRsqrt2;
        w.t2[lo + r] = j < n1 ? w.frow[p] : 0.0;
        w.t3[lo + r] = j < n1 ? 0.0 : w.lrow[p];
        w.sidx[L + lo + r] = (short)j;
      }
      __syncthreads();
      stamp();
      // B. deflation, one warp a node: node j of the level is found by
      // the bits of j, highest first (1: the right child)
      for (int j = tid / W; j < (1 << lv); j += nt / W) {
        lo = 0;
        hi = n;
        bool internal = true;
        for (int bit = lv - 1; bit >= 0 && internal; --bit) {
          internal = hi - lo >= 2;
          const int md = lo + ((hi - lo) >> 1);
          if ((j >> bit) & 1)
            lo = md;
          else
            hi = md;
        }
        if (!internal || hi - lo < 2) continue;
        mid = lo + ((hi - lo) >> 1);
        deflate_warp(w, m, lv, lo, hi, 2.0 * fabs(w.ev[mid - 1]), tid % W, W);
      }
      __syncthreads();
      stamp();
      // C. the secular roots, one group a root
      for (int p0 = gbase; p0 < n; p0 += NG) {
        const int p = p0 + gsub;
        lo = 0;
        const bool in = p < n && node_at(p, lv, n, lo, mid, hi);
        const int K = in ? w.nk[L + lo] : 0, q = p - lo;
        const bool act = in && q < K;
        double dorg, tau;
        const bool ok = secular_root(
            gr, act, w.dk + L + lo, w.zh + L + lo, K,
            act ? 2.0 * fabs(w.ev[mid - 1]) : 1.0, q, max_iter, dorg, tau);
        if (!act || gr.lane) continue;
        if (!ok) {
          atomicOr(&s_bad, 1);
          dorg = w.dk[L + p];
          tau = 0.0;
        }
        w.dorg[L + p] = dorg;
        w.tau[L + p] = tau;
      }
      __syncthreads();
      stamp();
      // D. z from the roots (Loewner), one group a pole
      for (int p0 = gbase; p0 < n; p0 += NG) {
        const int p = p0 + gsub;
        lo = 0;
        const bool in = p < n && node_at(p, lv, n, lo, mid, hi);
        const int K = in ? w.nk[L + lo] : 0, q = p - lo;
        const bool act = in && q < K;
        const double* d = w.dk + L + lo;
        const double* dor = w.dorg + L + lo;
        const double* ta = w.tau + L + lo;
        const double dq = act ? d[q] : 0.0;
        // the ratios' numerators and denominators multiplied apart, one
        // division each 8 factors (each factor lies in [1e-32, 4] in the
        // scaled problem, so 8 of them neither overflow nor underflow)
        double pr = 1.0, num = 1.0, den = 1.0;
        int cnt = 0;
        if (act)
          for (int j = gr.lane; j < K; j += G) {
            if (j == q) continue;
            num *= ta[j] + (dor[j] - dq);
            den *= d[j] - dq;
            if (++cnt == 8) {
              pr *= num / den;
              num = den = 1.0;
              cnt = 0;
            }
          }
        pr = gr.prod(pr * (num / den));
        if (!act || gr.lane) continue;
        pr *= (ta[q] + (dor[q] - dq)) / (2.0 * fabs(w.ev[mid - 1]));
        w.zh[L + p] = copysign(sqrt(pr), w.zh[L + p]);
      }
      __syncthreads();
      stamp();
      // E. eigenvalues, column norms and the rows carried up
      for (int p0 = gbase; p0 < n; p0 += NG) {
        const int p = p0 + gsub;
        lo = 0;
        const bool in = p < n && node_at(p, lv, n, lo, mid, hi);
        const int K = in ? w.nk[L + lo] : 0, q = p - lo;
        const bool act = in && q < K;
        const short* col = w.col + L + lo;
        const double* d = w.dk + L + lo;
        const double* zh = w.zh + L + lo;
        const double dq = act ? w.dorg[L + p] : 0.0;
        const double tq = act ? w.tau[L + p] : 0.0;
        double s2 = 0.0, sf = 0.0, sl = 0.0;
        if (act) {
#pragma unroll 4
          for (int i = gr.lane; i < K; i += G) {
            const double u = zh[i] / ((d[i] - dq) - tq);
            const int c = col[i];
            s2 += u * u;
            sf += w.t2[lo + c] * u;
            sl += w.t3[lo + c] * u;
          }
        }
        double tot[3] = {s2, sf, sl};
        gr.sums(tot);
        s2 = tot[0];
        sf = tot[1];
        sl = tot[2];
        if (!in || gr.lane) continue;
        if (q >= K) {
          const int c = col[q];
          w.lam[p] = w.t0[lo + c];
          w.frow[p] = w.t2[lo + c];
          w.lrow[p] = w.t3[lo + c];
          continue;
        }
        const double inv = 1.0 / sqrt(s2);
        w.inrm[L + p] = inv;
        w.lam[p] = dq + tq;
        w.frow[p] = sf * inv;
        w.lrow[p] = sl * inv;
      }
      __syncthreads();
      stamp();
    }
  }
  const bool ok = finite && !s_bad;

  // 4. w = s e^{t lambda} (Q^T e1) at the root, then down the tree
  const double tr = (double)tp[0], ti = t_complex ? (double)tp[1] : 0.0;
  const double sc = sp ? (double)sp[0] : 1.0;
  double* wr = w.t0;
  double* wi = w.t1;
  if (ok) {
    for (int p = tid; p < n; p += nt) {
      const double lam = w.lam[p] * scale;
      const double a = sc * exp(tr * lam) * w.frow[p];
      if (t_complex) {
        double sn, cs;
        sincos(ti * lam, &sn, &cs);
        wr[p] = a * cs;
        wi[p] = a * sn;
      } else {
        wr[p] = a;
      }
    }
    __syncthreads();
    stamp();
    for (int lv = 0; lv < depth; ++lv) {
      int lo, mid, hi;
      const size_t L = (size_t)lv * m;
      // y = U w in the node's sorted positions, one group a row
      for (int p0 = gbase; p0 < n; p0 += NG) {
        const int p = p0 + gsub;
        lo = 0;
        const bool in = p < n && node_at(p, lv, n, lo, mid, hi);
        const int K = in ? w.nk[L + lo] : 0, q = p - lo;
        const bool act = in && q < K;
        const double* dor = w.dorg + L + lo;
        const double* ta = w.tau + L + lo;
        const double* in_ = w.inrm + L + lo;
        const double dq = act ? w.dk[L + p] : 0.0;
        double yr = 0.0, yi = 0.0;
        if (act) {
#pragma unroll 4
          for (int k = gr.lane; k < K; k += G) {
            const double g = in_[k] / ((dq - dor[k]) - ta[k]);
            yr += wr[lo + k] * g;
            if (t_complex) yi += wi[lo + k] * g;
          }
        }
        double tot[2] = {yr, yi};
        gr.sums(tot);
        yr = tot[0];
        yi = tot[1];
        if (!in || gr.lane) continue;
        const int c = w.col[L + p];
        if (q >= K) {
          w.t2[lo + c] = wr[p];
          if (t_complex) w.t3[lo + c] = wi[p];
          continue;
        }
        const double z = w.zh[L + p];
        w.t2[lo + c] = z * yr;
        if (t_complex) w.t3[lo + c] = z * yi;
      }
      __syncthreads();
      stamp();
      // the rotations in reverse order, one thread a node
      for (int p = tid; p < n; p += nt) {
        if (!node_at(p, lv, n, lo, mid, hi) || p != lo) continue;
        const size_t at = L + lo;
        for (int r = w.nr[at] - 1; r >= 0; --r) {
          const int a = lo + w.rp[at + r], b = lo + w.rn[at + r];
          const double c = w.rc[at + r], s = w.rs[at + r];
          double x = w.t2[a], y = w.t2[b];
          w.t2[a] = c * x - s * y;
          w.t2[b] = s * x + c * y;
          if (t_complex) {
            x = w.t3[a];
            y = w.t3[b];
            w.t3[a] = c * x - s * y;
            w.t3[b] = s * x + c * y;
          }
        }
      }
      __syncthreads();
      stamp();
      // the sort undone: each child gets its part of y
      for (int p = tid; p < n; p += nt) {
        if (!node_at(p, lv, n, lo, mid, hi)) continue;
        const int j = lo + w.sidx[L + p];
        wr[j] = w.t2[p];
        if (t_complex) wi[j] = w.t3[p];
      }
      __syncthreads();
      stamp();
    }
  }
  for (int r = tid; r < m; r += nt) {
    double re = 0.0, im = 0.0;
    if (!ok) {
      re = im = NAN;                      // poison, never guess
    } else if (r < n) {
      re = wr[r];
      if (t_complex) im = wi[r];
    }
    if (t_complex) {
      out[2 * r] = (T)re;
      out[2 * r + 1] = (T)im;
    } else {
      out[r] = (T)re;
    }
  }
  __syncthreads();
  stamp();
}

template <typename T>
cudaError_t launch(const T* alpha, const T* beta, const T* t, int t_complex,
                   const T* s, T* out, double* scratch, int m, int threads,
                   long long bytes, int max_iter, int group,
                   long long* clocks, int batch, cudaStream_t stream) {
  static long long allowed = 48 * 1024;  // one flag per instantiation
  if (m <= 0 || batch == 0) return cudaSuccess;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || group < 1 ||
      group > 32 || (group & (group - 1)) || bytes < (long long)work_bytes(m) ||
      batch < 0 || (batch > 1 && clocks))
    return cudaErrorInvalidValue;
  // a row's slice of the global scratch, in doubles
  const long long stride = (bytes + 7) / 8;
  // the workspace: ``bytes`` of the global scratch, else of shared memory
  const long long smem = scratch ? 0 : bytes;
  if (!scratch) {
    if (smem > allowed) {
      cudaError_t e = cudaFuncSetAttribute(
          tridiag_exp_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      allowed = smem;
    }
    tridiag_exp_kernel<T, true><<<batch, threads, (size_t)smem, stream>>>(
        alpha, beta, t, t_complex, s, out, scratch, m, max_iter, group,
        clocks, stride);
  } else {
    tridiag_exp_kernel<T, false><<<batch, threads, 0, stream>>>(
        alpha, beta, t, t_complex, s, out, scratch, m, max_iter, group,
        clocks, stride);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int eu_tridiag_exp_f32(const float* alpha, const float* beta,
                                  const float* t, int t_complex,
                                  const float* s, float* out, double* scratch,
                                  int m, int threads, long long bytes,
                                  int max_iter, int group, long long* clocks,
                                  void* stream) {
  return (int)launch<float>(alpha, beta, t, t_complex, s, out, scratch, m,
                            threads, bytes, max_iter, group, clocks, 1,
                            (cudaStream_t)stream);
}

extern "C" int eu_tridiag_exp_f64(const double* alpha, const double* beta,
                                  const double* t, int t_complex,
                                  const double* s, double* out,
                                  double* scratch, int m, int threads,
                                  long long bytes, int max_iter, int group,
                                  long long* clocks, void* stream) {
  return (int)launch<double>(alpha, beta, t, t_complex, s, out, scratch, m,
                             threads, bytes, max_iter, group, clocks, 1,
                             (cudaStream_t)stream);
}

// K2: R1 on each of ``batch`` rows, one block a row: alpha (batch, m),
// beta (batch, m - 1), s (batch,) or null, out (batch, m) (complex:
// (batch, m) pairs), t shared; the global scratch (when given) holds
// ``batch`` slices of ``bytes``, rounded up to doubles.
extern "C" int eu_tridiag_exp_batched_f32(const float* alpha, const float* beta,
                                          const float* t, int t_complex,
                                          const float* s, float* out,
                                          double* scratch, int m, int threads,
                                          long long bytes, int max_iter,
                                          int group, int batch, void* stream) {
  return (int)launch<float>(alpha, beta, t, t_complex, s, out, scratch, m,
                            threads, bytes, max_iter, group, nullptr, batch,
                            (cudaStream_t)stream);
}

extern "C" int eu_tridiag_exp_batched_f64(const double* alpha, const double* beta,
                                          const double* t, int t_complex,
                                          const double* s, double* out,
                                          double* scratch, int m, int threads,
                                          long long bytes, int max_iter,
                                          int group, int batch, void* stream) {
  return (int)launch<double>(alpha, beta, t, t_complex, s, out, scratch, m,
                             threads, bytes, max_iter, group, nullptr, batch,
                             (cudaStream_t)stream);
}

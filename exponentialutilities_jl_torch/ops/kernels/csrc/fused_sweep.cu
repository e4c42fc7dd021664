// B3 and B3-var: one fused sweep of the three-term recurrence over a
// 2-D/3-D grid with a box stencil, constant (B3) or with a per-cell
// coefficient field per stencil point (B3-var), and its second stage.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py
//   _fused_kernel via its constant entries _kernel_plain and _kernel_accum
//   (lanczos_fused.py:380, :607, :614) and its variable-coefficient entries
//   _kernel_var and _kernel_var_accum (:621, :628); all called by
//   fused_lanczos_step (:783). The second stage also computes what the JAX
//   drivers compute inside their lax.scan bodies (:939, :1002).
//
//   y  = ca Z + cb Vc + cc Vp           (written to Y)
//   Zn = A y                            (written to Zn; Dirichlet bounds)
//        B3:     Zn_i = sum_j c_j       y_{i + o_j}
//        B3-var: Zn_i = sum_j C[j, i]   y_{i + o_j}   (field read at the
//                                                       OUTPUT cell i)
//   moments = (sum y*y, sum y*Zn)   over the output planes [z0, z1)
//   accum:  W += cw Vc  (in place)
//
// The moment plane range [z0, z1) defaults to the whole grid, where every
// cell adds its terms in the same order as before the range existed, so a
// single-device sweep's moments are unchanged bit for bit. The sharded
// sweeps (parallel/stencil_fused.py) run the sweep on a rank's slab
// extended by h0 halo planes at each end and sum the moments over the
// interior planes [h0, h0 + sz) only: the halo planes belong to the
// neighbouring ranks, whose moments count them.
//
// Bound on the H100: device-memory bytes. B3 reads Z, Vc, Vp (and W) once
// and writes Y, Zn (and W) once: 5n values (7n with accum); B3-var adds its
// k fields, read once. At 216^3 in float64 that is 564 MB (accum), 0.1685
// ms at 3.35 TB/s; the 7-point B3-var 1.13 GB, 0.337 ms.
//
// The design keeps every input read once from device memory:
// * A block owns a (ty x tx) column tile of the natural (nz, ny, nx) layout
//   and a chunk of cz z-planes, and marches through it plane by plane, as
//   the TPU kernel streams its planes through a VMEM ring. Shared memory
//   holds a ring of R = 2 hz + 1 y-planes of the tile plus its x-y halo
//   (cells outside the grid are 0), so each z-plane of Z, Vc, Vp is read
//   once per column tile; only the thin x-y halo and the 2 hz planes at a
//   chunk's ends are read again, by the neighbouring blocks, and those
//   reads mostly hit L2.
// * The inputs of a step (the Z, Vc, Vp halo plane, the W tile and, in
//   float32, B3-var's first eight fields) come in by cp.async into one of
//   kStages = 3 shared-memory stages, two steps ahead, zero-filled outside
//   the grid: a plane's arithmetic never waits for its own loads. In
//   float64 B3-var holds those fields in registers instead, issued at the
//   start of the step (staging them would cost a resident block per SM).
// * The accumulating form keeps Vc in a second ring and updates W from it,
//   so Vc is not read twice.
// * Each thread locates its cells once (one division per cell per sweep);
//   per plane it adds a plane stride. The ring slots of the stencil points
//   are computed once per step, for the block, in shared memory.
// * What bounds a block is the latency of its steps (two barriers each),
//   so the sweep runs as many blocks as fit: three per SM (launch bounds),
//   and the host picks cz so that the whole grid is resident at once (one
//   wave; blocks per SM from the occupancy API, the min over the plain and
//   accumulating forms, so both use one block plan). Tiles (host side):
//   16 x 32 for float32 B3 (two cells a thread), 8 x 32 otherwise.
// * A 2-D grid (nz = 1) has hz = 0: the ring is one plane and the block
//   one tile. Marching a 2-D grid along y was weighed: a 16 x 32 tile reads
//   1.2 halo cells per cell, an x-strip marching 16 rows 1.14, but at
//   512^2 the strip gives 64 blocks for 132 SMs.
// Global loads are 8-byte (float64) or 4-byte scalars, coalesced along x;
// 16-byte loads would not line up with the halo's offset start.
//
// The moments are per-block partials plus a one-block fixed-order second
// stage (sweep_stage_kernel), so a sweep's moments are bitwise repeatable.
// In Lanczos mode the same stage also computes the next sweep's scalars
// (module doc of lanczos_fused.py) into a small state buffer that the next
// sweep reads its coefficients from, and writes alpha_j, beta_j: pass 1 and
// the replay run the same code on the same inputs, so the replay's scalars
// equal pass 1's bit for bit, and no scalar op runs between the sweeps.
//
// The device-index form (the Lanczos passes, lanczos_fused._lanczos_sweeps)
// takes its step from the device, so that one (sweep, stage) pair is a step
// that a CUDA graph captures once and replays m - 1 times with the same
// arguments. The state buffer carries the step counter s (kStep): the sweep
// reads s and picks its five vectors from the pass's ring, passed by value
// in the launch's parameter block (the kernel's parameter space in constant
// memory, fixed for a capture): v0, a zero vector, three y buffers and two
// A y buffers (SweepRing below). The stage reads j = s from the state
// instead of a host argument and advances the counter. Nothing is copied:
// sweep s writes y_s and A y_s into their ring slots and sweep s + 1 reads
// them there. The host-index form (a pointer per vector, j from the host)
// stays for the callers whose loops the host drives: the sharded slab
// sweeps and the one-sweep wrapper. The generic (m, 4)-rows recurrence
// (the Chebyshev, Leja and Faber passes, lanczos_fused.recurrence_apply_fused)
// takes the device-index form too: sweep s reads row s - 1 from the state's
// coefficient slots (sweep 0 the unit row of the initial state), where the
// second stage's recurrence mode copied it after sweep s - 1.
#include <algorithm>
#include <cstdlib>
#include <limits>

#include "common.cuh"

namespace eu {

constexpr int kMaxHalo = 3;          // largest |offset| per axis
constexpr int kHaloPer = 4;          // halo-plane cells per thread
constexpr int kTilePer = 2;          // tile cells per thread (B3; B3-var 1)
constexpr int kFieldStage = 8;       // B3-var fields staged or held per cell
constexpr int kStages = 3;           // cp.async stages: kStages - 1 steps ahead
constexpr int kSweepSmemMax = 200 * 1024;

// The Lanczos state buffer (T values): the next sweep's coefficients, the
// recurrence's carried scalars, then the step counter of the device-index
// form (an integer held exactly in T).
constexpr int kCa = 0, kCb = 1, kCc = 2, kCw = 3, kBetaPrev = 4, kBroke = 5,
              kMUsed = 6, kLive = 7, kStep = 8;

// The ring of a device-index pass (module doc): sweep s reads Z = A y_{s-1}
// (v0 at s = 0), Vc = y_{s-1} and Vp = y_{s-2} (the zero vector before the
// start) and writes y_s and A y_s, y_s in slot s mod 3 and A y_s in slot
// s mod 2.
template <typename T>
struct SweepRing {
  const T* v0;
  const T* zero;
  T* y0;
  T* y1;
  T* y2;
  T* z0;
  T* z1;
};

template <typename T>
__device__ __forceinline__ T* ring_y(const SweepRing<T>& r, int i) {
  return i == 0 ? r.y0 : (i == 1 ? r.y1 : r.y2);
}

struct SweepGeom {
  int nz, ny, nx, cz, ty, tx, hz, hy, hx;
  int mz0, mz1;                      // moment plane range [mz0, mz1)
};

// Shared memory of one block, in values: the y ring and (accum) the Vc
// ring, R halo planes each; kStages stages of a step's inputs: the Z, Vc,
// Vp halo planes, (accum) the W tile and (B3-var) its first kf fields.
__host__ __device__ inline size_t sweep_smem_values(const SweepGeom& G, bool accum, int kf) {
  const size_t R = 2 * G.hz + 1;
  const size_t pl = (size_t)(G.tx + 2 * G.hx) * (G.ty + 2 * G.hy);
  const size_t nt = (size_t)G.tx * G.ty;
  return R * pl * (accum ? 2 : 1) + kStages * (3 * pl + (accum ? nt : 0) + kf * nt);
}

// cp.async of one value (4 or 8 bytes), zero-filled when !valid
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest kStages - 2 groups of this thread have landed
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

template <typename T, bool ACCUM, bool VAR, bool RING>
__global__ void __launch_bounds__(kThreads, 3)
fused_sweep_kernel(const T* __restrict__ Z, const T* __restrict__ Vc,
                   const T* __restrict__ Vp, const T* __restrict__ coefs,
                   const T* __restrict__ cvals, const T* __restrict__ fields,
                   Offsets3D offs, SweepGeom G, T* __restrict__ Y,
                   T* __restrict__ Zn, T* __restrict__ W,
                   T* __restrict__ partials, SweepRing<T> vecs) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];     // in-plane offset of each point
  __shared__ int z_sh[kMaxPoints];     // its dz
  __shared__ int jo_sh[kMaxPoints];    // this step's ring offset of each point
  __shared__ T red[kThreads];

  constexpr int TP = VAR ? 1 : kTilePer;        // tile cells per thread
  const int tid = threadIdx.x;
  const int R = 2 * G.hz + 1;
  const int bx = G.tx + 2 * G.hx, by = G.ty + 2 * G.hy;
  const int pl = bx * by;                       // cells of a halo plane
  const int nt = G.tx * G.ty;                   // cells of the tile
  const int k = offs.k;
  // B3-var's first fields: staged in float32, in registers in float64
  // (staging them would cost float64 a resident block per SM)
  const int kf = VAR && sizeof(T) == 4 ? min(k, kFieldStage) : 0;
  const int kr = VAR && sizeof(T) == 8 ? min(k, kFieldStage) : 0;
  T* ring = reinterpret_cast<T*>(smem_raw);     // R y-planes
  T* vring = ring + (size_t)R * pl;             // R Vc planes (accum)
  T* stage0 = vring + (ACCUM ? (size_t)R * pl : 0);
  const size_t stage_len = 3 * (size_t)pl + (ACCUM ? nt : 0) + (size_t)kf * nt;
  if (tid < k) {
    if (!VAR) c_sh[tid] = cvals[tid];
    o_sh[tid] = offs.dy[tid] * bx + offs.dx[tid];
    z_sh[tid] = offs.dz[tid];
  }
  const int x0 = blockIdx.x * G.tx, y0 = blockIdx.y * G.ty;
  const int zs = blockIdx.z * G.cz;
  const int ze = min(zs + G.cz, G.nz);
  const long long plane = (long long)G.ny * G.nx;
  const size_t n = (size_t)plane * G.nz;
  const T ca = coefs[kCa], cb = coefs[kCb], cc = coefs[kCc];
  const T cw = ACCUM ? coefs[kCw] : T(0);
  if (RING) {                   // the device-index form: step s's vectors
    const int s = (int)coefs[kStep];
    Z = s == 0 ? vecs.v0 : ((s & 1) ? vecs.z0 : vecs.z1);
    Vc = s == 0 ? vecs.zero : ring_y(vecs, (s + 2) % 3);
    Vp = s <= 1 ? vecs.zero : ring_y(vecs, (s + 1) % 3);
    Y = ring_y(vecs, s % 3);
    Zn = (s & 1) ? vecs.z1 : vecs.z0;
  }

  // this thread's halo-plane cells and tile cells, located once
  int hoff[kHaloPer];
  unsigned hin = 0;
#pragma unroll
  for (int i = 0; i < kHaloPer; ++i) {
    const int l = tid + i * kThreads;
    hoff[i] = 0;
    if (l < pl) {
      const int ly = l / bx, lx = l - ly * bx;
      const int x = x0 + lx - G.hx, y = y0 + ly - G.hy;
      if (x >= 0 && x < G.nx && y >= 0 && y < G.ny) {
        hin |= 1u << i;
        hoff[i] = y * G.nx + x;
      }
    }
  }
  int toff[TP], tsh[TP];
  unsigned tin = 0;
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int l = tid + i * kThreads;
    toff[i] = 0;
    tsh[i] = 0;
    if (l < nt) {
      const int ly = l / G.tx, lx = l - ly * G.tx;
      const int x = x0 + lx, y = y0 + ly;
      if (x < G.nx && y < G.ny) {
        tin |= 1u << i;
        toff[i] = y * G.nx + x;
        tsh[i] = (ly + G.hy) * bx + lx + G.hx;
      }
    }
  }

  // step q's inputs into stage `st`: the Z, Vc, Vp halo plane q (0 outside
  // the grid) and W and the first fields of the output plane q - hz; one
  // commit group per step, empty past the end
  const int pend = ze + G.hz;                   // steps run zs - hz .. pend - 1
  auto issue = [&](int q, int st) {
    if (q < pend) {
      T* sZ = stage0 + (size_t)st * stage_len;
      const bool inz = q >= 0 && q < G.nz;
#pragma unroll
      for (int i = 0; i < kHaloPer; ++i) {
        const int l = tid + i * kThreads;
        if (l < pl) {
          const bool v = inz && (hin >> i & 1u);
          const size_t g = v ? (size_t)q * plane + hoff[i] : 0;
          cp_async(sZ + l, Z + g, v);
          cp_async(sZ + pl + l, Vc + g, v);
          cp_async(sZ + 2 * pl + l, Vp + g, v);
        }
      }
      const int zo = q - G.hz;
      if ((ACCUM || VAR) && zo >= zs) {
        T* sW = sZ + 3 * pl;
        T* sF = sW + (ACCUM ? nt : 0);
#pragma unroll
        for (int i = 0; i < TP; ++i) {
          if (!(tin >> i & 1u)) continue;
          const int l = tid + i * kThreads;
          const size_t g = (size_t)zo * plane + toff[i];
          if (ACCUM) cp_async(sW + l, W + g, true);
          for (int u = 0; u < kf; ++u) cp_async(sF + (size_t)u * nt + l, fields + (size_t)u * n + g, true);
        }
      }
    }
    cp_async_commit();
  };

  T s_yy = T(0), s_yz = T(0);
  for (int q = 0; q < kStages - 1; ++q) issue(zs - G.hz + q, q);
  int slot = 0, st = 0;                // ring slot and stage of step p
  for (int p = zs - G.hz; p < pend; ++p) {
    cp_async_wait_step();              // this thread's copies of step p landed
    __syncthreads();                   // everyone's; step p - 1 is done
    issue(p + kStages - 1, st == 0 ? kStages - 1 : st - 1);   // into p - 1's stage
    // the ring slot of each stencil point for the output plane p - hz
    int cs = slot - G.hz + R;
    if (cs >= R) cs -= R;
    if (tid < k) {
      int s = slot - G.hz + z_sh[tid] + R;
      if (s >= R) s -= R;
      jo_sh[tid] = s * pl + o_sh[tid];
    }
    // (B3-var, fields in registers) the output plane's first fields,
    // issued before y is formed
    const int zo = p - G.hz;
    T fr[kFieldStage];
#pragma unroll
    for (int u = 0; u < kFieldStage; ++u) {
      fr[u] = T(0);
      if (u < kr && zo >= zs && (tin & 1u))
        fr[u] = __ldcs(fields + (size_t)u * n + (size_t)zo * plane + toff[0]);
    }
    // y of plane p into its slot
    const T* sZ = stage0 + (size_t)st * stage_len;
    T* yp = ring + (size_t)slot * pl;
#pragma unroll
    for (int i = 0; i < kHaloPer; ++i) {
      const int l = tid + i * kThreads;
      if (l < pl) {
        const T vc = sZ[pl + l];
        yp[l] = fma(cc, sZ[2 * pl + l], fma(cb, vc, ca * sZ[l]));
        if (ACCUM) vring[(size_t)slot * pl + l] = vc;
      }
    }
    __syncthreads();

    if (zo >= zs) {
      const T* yc = ring + (size_t)cs * pl;
      const T* sW = sZ + 3 * pl;
      const T* sF = sW + (ACCUM ? nt : 0);
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        if (!(tin >> i & 1u)) continue;
        const int l = tid + i * kThreads;
        const size_t g = (size_t)zo * plane + toff[i];
        const int t = tsh[i];
        T zn = T(0);
        if (VAR) {
          for (int u = 0; u < kf; ++u) zn = fma(sF[(size_t)u * nt + l], ring[jo_sh[u] + t], zn);
#pragma unroll
          for (int u = 0; u < kFieldStage; ++u)
            if (u < kr) zn = fma(fr[u], ring[jo_sh[u] + t], zn);
          for (int j = kf + kr; j < k; ++j)
            zn = fma(__ldcs(fields + (size_t)j * n + g), ring[jo_sh[j] + t], zn);
        } else {
          for (int j = 0; j < k; ++j) zn = fma(c_sh[j], ring[jo_sh[j] + t], zn);
        }
        const T yv = yc[t];
        Y[g] = yv;
        Zn[g] = zn;
        if (zo >= G.mz0 && zo < G.mz1) {
          s_yy = fma(yv, yv, s_yy);
          s_yz = fma(yv, zn, s_yz);
        }
        if (ACCUM) W[g] = fma(cw, vring[(size_t)cs * pl + t], sW[l]);
      }
    }
    slot = slot + 1 == R ? 0 : slot + 1;
    st = st + 1 == kStages ? 0 : st + 1;
  }
  const size_t bid = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  s_yy = block_sum(s_yy, red);
  s_yz = block_sum(s_yz, red);
  if (tid == 0) {
    partials[2 * bid + 0] = s_yy;
    partials[2 * bid + 1] = s_yz;
  }
}

// Second stage: the fixed-order totals of the per-block partials, written
// to moments[0:2] when given. With a state buffer (Lanczos mode), after the
// moments of sweep j (j < 0: the device-index form, j read from the state's
// counter, which the stage then advances to j + 1), one thread
//   * sets betas[j - 1] = |y_j| where step j - 1 was live (pass 1's beta
//     reported one step ahead), 0 otherwise; at j = m, where no step
//     follows, it also records a breakdown that |y_m| < tol shows, as the
//     plain pass 1 does at its last step; past j = m (a step after the
//     pass's end) it writes nothing but the counter;
//   * for j < m, computes step j's scalars from the moments and the state,
//     the formulas of lanczos_fused._lanczos_scalars (its plain twin):
//     beta = sqrt(max(ypy, 0)), alpha = ypy > 0 ? yzy / max(ypy, tiny) : 0,
//     live = !broke && beta >= tol, ca = live / beta, cb = -alpha ca,
//     cc = live ? -beta / beta_prev : 0 (a zero beta divides as 1), and in
//     the replay cw = live ? coeffs[j] / beta : 0; it writes them to the
//     state, alphas[j] = live ? alpha : 0 and m_used = j + 1 where live.
// In recurrence mode (`rows`, the (m, 4) rows of the generic recurrence in
// the device-index form: lanczos_fused.recurrence_apply_fused) no moment
// is read: after sweep s (s = the state's counter) one thread copies row s
// into the state's coefficient slots, the coefficients of sweep s + 1,
// where s < m, and advances the counter.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_stage_kernel(const T* __restrict__ partials, int nblocks, T* __restrict__ moments,
                   T* __restrict__ st, T* __restrict__ alphas, T* __restrict__ betas,
                   const T* __restrict__ coeffs, int j, int m, T tol, T tiny,
                   const T* __restrict__ rows) {
  __shared__ T red[kThreads];
  if (rows != nullptr) {                // uniform: the whole block returns
    if (threadIdx.x == 0) {
      const int s = (int)st[kStep];
      if (s < m)
        for (int c = 0; c < 4; ++c) st[kCa + c] = rows[4 * (size_t)s + c];
      st[kStep] = T(s + 1);
    }
    return;
  }
  const T ypy = fixed_order_total(partials, nblocks, 2, red);
  const T yzy = fixed_order_total(partials + 1, nblocks, 2, red);
  if (threadIdx.x != 0) return;
  if (moments != nullptr) {
    moments[0] = ypy;
    moments[1] = yzy;
  }
  if (st == nullptr) return;
  const bool from_state = j < 0;
  if (from_state) j = (int)st[kStep];
  const T beta = sqrt(ypy > T(0) ? ypy : T(0));
  if (betas != nullptr && j > 0 && j <= m) betas[j - 1] = st[kLive] != T(0) ? beta : T(0);
  if (j < m) {
    const T alpha = ypy > T(0) ? yzy / (ypy > tiny ? ypy : tiny) : T(0);
    const bool broke = st[kBroke] != T(0);
    const bool now_broke = beta < tol;
    const bool go = !broke && !now_broke;
    const T safe_beta = beta > T(0) ? beta : T(1);
    const T bp = st[kBetaPrev];
    const T safe_bp = bp > T(0) ? bp : T(1);
    const T ca = go ? T(1) / safe_beta : T(0);
    st[kCa] = ca;
    st[kCb] = -alpha * ca;
    st[kCc] = go ? -beta / safe_bp : T(0);
    st[kCw] = (coeffs != nullptr && go) ? coeffs[j] / safe_beta : T(0);
    if (alphas != nullptr) alphas[j] = go ? alpha : T(0);
    if (go) st[kMUsed] = T(j + 1);
    st[kLive] = go ? T(1) : T(0);
    st[kBetaPrev] = beta;
    st[kBroke] = (broke || now_broke) ? T(1) : T(0);
  } else if (j == m && beta < tol) {
    st[kBroke] = T(1);
  }
  if (from_state) st[kStep] = T(j + 1);
}

// The sweep's geometry from the host's arguments, checked; returns 0 or a
// CUDA error code, and the dynamic shared memory of the plain and the
// accumulating form (smem[0], smem[1]).
inline int sweep_geom(const int* offs, int k, int nz, int ny, int nx, int cz, int ty,
                      int tx, bool var, size_t elem, Offsets3D* o, SweepGeom* G,
                      size_t smem[2]) {
  if (k < 1 || k > kMaxPoints || nz < 1 || ny < 1 || nx < 1 || cz < 1 || ty < 1 || tx < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)ny * nx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *o = Offsets3D{};
  o->k = k;
  int hz = 0, hy = 0, hx = 0;
  for (int j = 0; j < k; ++j) {
    o->dz[j] = offs[3 * j + 0];
    o->dy[j] = offs[3 * j + 1];
    o->dx[j] = offs[3 * j + 2];
    hz = std::max(hz, std::abs(o->dz[j]));
    hy = std::max(hy, std::abs(o->dy[j]));
    hx = std::max(hx, std::abs(o->dx[j]));
  }
  if (hz > kMaxHalo || hy > kMaxHalo || hx > kMaxHalo) return (int)cudaErrorInvalidValue;
  if (ty * tx > (var ? 1 : kTilePer) * kThreads ||
      (ty + 2 * hy) * (tx + 2 * hx) > kHaloPer * kThreads)
    return (int)cudaErrorInvalidValue;
  *G = SweepGeom{nz, ny, nx, cz, ty, tx, hz, hy, hx, 0, nz};
  const int kf = var && elem == 4 ? std::min(k, kFieldStage) : 0;
  smem[0] = sweep_smem_values(*G, false, kf) * elem;
  smem[1] = sweep_smem_values(*G, true, kf) * elem;
  return smem[1] > (size_t)kSweepSmemMax ? (int)cudaErrorInvalidValue : 0;
}

// Opt the kernel in to `bytes` of dynamic shared memory (past 48 KB with
// the static shared memory it must be asked for); raised only as far as a
// launch needs, since the limit also bounds how many blocks the occupancy
// calculation admits.
template <typename T, bool ACCUM, bool VAR, bool RING = false>
static cudaError_t allow_smem(size_t bytes) {     // static: one flag per library
  static size_t allowed = 0;
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(fused_sweep_kernel<T, ACCUM, VAR, RING>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  return cudaSuccess;
}

template <typename T, bool VAR>
int resident_blocks(const size_t smem[2]) {
  cudaError_t e = allow_smem<T, false, VAR>(smem[0]);
  if (e == cudaSuccess) e = allow_smem<T, true, VAR>(smem[1]);
  int dev = 0, sms = 0, plain = 0, acc = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &plain, fused_sweep_kernel<T, false, VAR, false>, kThreads, smem[0]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &acc, fused_sweep_kernel<T, true, VAR, false>, kThreads, smem[1]);
  if (e != cudaSuccess) return -(int)e;
  return std::min(plain, acc) * sms;
}

// Blocks of one sweep that the device holds at once (min over the plain
// and accumulating forms), for the host's choice of cz; negative: an error.
template <typename T>
int sweep_capacity(const int* offs, int k, int ty, int tx, int var) {
  Offsets3D o;
  SweepGeom G;
  size_t smem[2];
  const int c = sweep_geom(offs, k, 1, 1, 1, 1, ty, tx, var != 0, sizeof(T), &o, &G, smem);
  if (c != 0) return -c;
  return var ? resident_blocks<T, true>(smem) : resident_blocks<T, false>(smem);
}

template <typename T, bool ACCUM, bool VAR, bool RING>
int launch_form(dim3 grid, size_t smem, cudaStream_t stream, const T* Z, const T* Vc,
                const T* Vp, const T* coefs, const T* cvals, const T* fields,
                const Offsets3D& o, const SweepGeom& G, T* Y, T* Zn, T* W, T* partials,
                const SweepRing<T>& ring) {
  const cudaError_t e = allow_smem<T, ACCUM, VAR, RING>(smem);
  if (e != cudaSuccess) return (int)e;
  fused_sweep_kernel<T, ACCUM, VAR, RING><<<grid, kThreads, smem, stream>>>(
      Z, Vc, Vp, coefs, cvals, fields, o, G, Y, Zn, W, partials, ring);
  return (int)cudaGetLastError();
}

template <typename T, bool VAR>
int launch_body(dim3 grid, const size_t smem[2], cudaStream_t stream, const T* Z,
                const T* Vc, const T* Vp, const T* coefs, const T* cvals, const T* fields,
                const Offsets3D& o, const SweepGeom& G, T* Y, T* Zn, T* W, T* partials,
                const SweepRing<T>* ring) {
  const SweepRing<T> r = ring != nullptr ? *ring : SweepRing<T>{};
  if (W != nullptr)
    return ring != nullptr
               ? launch_form<T, true, VAR, true>(grid, smem[1], stream, Z, Vc, Vp, coefs,
                                                 cvals, fields, o, G, Y, Zn, W, partials, r)
               : launch_form<T, true, VAR, false>(grid, smem[1], stream, Z, Vc, Vp, coefs,
                                                  cvals, fields, o, G, Y, Zn, W, partials, r);
  return ring != nullptr
             ? launch_form<T, false, VAR, true>(grid, smem[0], stream, Z, Vc, Vp, coefs,
                                                cvals, fields, o, G, Y, Zn, W, partials, r)
             : launch_form<T, false, VAR, false>(grid, smem[0], stream, Z, Vc, Vp, coefs,
                                                 cvals, fields, o, G, Y, Zn, W, partials, r);
}

template <typename T>
int launch_stage(const T* partials, int nblocks, T* moments, T* state, T* alphas, T* betas,
                 const T* coeffs, int j, int m, double tol, cudaStream_t stream) {
  if (nblocks < 1 || (moments == nullptr && state == nullptr) || (j < 0 && state == nullptr))
    return (int)cudaErrorInvalidValue;
  sweep_stage_kernel<T><<<1, kThreads, 0, stream>>>(
      partials, nblocks, moments, state, alphas, betas, coeffs, j, m, (T)tol,
      std::numeric_limits<T>::min(), nullptr);
  return (int)cudaGetLastError();
}

// The stage's recurrence mode (sweep_stage_kernel): one warp.
template <typename T>
int launch_stage_rows(T* state, const T* rows, int m, cudaStream_t stream) {
  if (state == nullptr || m < 0 || (m > 0 && rows == nullptr))
    return (int)cudaErrorInvalidValue;
  // m = 0: a non-null pointer that the kernel never reads (s < 0 is false)
  sweep_stage_kernel<T><<<1, 32, 0, stream>>>(nullptr, 0, nullptr, state, nullptr, nullptr,
                                              nullptr, -1, m, T(0), T(0),
                                              rows != nullptr ? rows : state);
  return (int)cudaGetLastError();
}

// One sweep: the constant form when `fields` is null (reads cvals), the
// variable form otherwise (reads the (k, n) fields, row-major), with the
// moments summed over the output planes [z0, z1) (0 <= z0 <= z1 <= nz). The
// coefficients (ca, cb, cc[, cw]) are read from `coefs` on the device. The
// second stage is its own host call (launch_stage), so the host prepares it
// while the sweep runs. With `ring` (the device-index form) `coefs` is the
// Lanczos state and the vectors are the ring's slots of its step (Z, Vc, Vp,
// Y and Zn are ignored).
template <typename T>
int launch_sweep(const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* cvals,
                 const T* fields, const int* offs, int k, int nz, int ny, int nx, int cz,
                 int ty, int tx, T* Y, T* Zn, T* W, T* partials, long long partials_cap,
                 int z0, int z1, cudaStream_t stream, const SweepRing<T>* ring = nullptr) {
  if ((fields == nullptr) == (cvals == nullptr)) return (int)cudaErrorInvalidValue;
  if (ring != nullptr && (ring->v0 == nullptr || ring->zero == nullptr || ring->y0 == nullptr ||
                          ring->y1 == nullptr || ring->y2 == nullptr || ring->z0 == nullptr ||
                          ring->z1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (z0 < 0 || z0 > z1 || z1 > nz) return (int)cudaErrorInvalidValue;
  Offsets3D o;
  SweepGeom G;
  size_t smem[2];
  const int c = sweep_geom(offs, k, nz, ny, nx, cz, ty, tx, fields != nullptr, sizeof(T),
                           &o, &G, smem);
  if (c != 0) return c;
  G.mz0 = z0;
  G.mz1 = z1;
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, (nz + cz - 1) / cz);
  const long long nblocks = (long long)grid.x * grid.y * grid.z;
  if (grid.y > 65535 || grid.z > 65535 || 2 * nblocks > partials_cap || nblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return fields != nullptr
             ? launch_body<T, true>(grid, smem, stream, Z, Vc, Vp, coefs, cvals, fields, o,
                                    G, Y, Zn, W, partials, ring)
             : launch_body<T, false>(grid, smem, stream, Z, Vc, Vp, coefs, cvals, fields, o,
                                     G, Y, Zn, W, partials, ring);
}

// The device-index form (module doc): `ring` is a host array of the seven
// device pointers v0, zero, y0, y1, y2, z0, z1, copied into the launch.
template <typename T>
int launch_sweep_ring(const void* const* ring, const T* state, const T* cvals,
                      const T* fields, const int* offs, int k, int nz, int ny, int nx,
                      int cz, int ty, int tx, T* W, T* partials, long long partials_cap,
                      int z0, int z1, cudaStream_t stream) {
  if (ring == nullptr || state == nullptr) return (int)cudaErrorInvalidValue;
  const SweepRing<T> r{static_cast<const T*>(ring[0]), static_cast<const T*>(ring[1]),
                       static_cast<T*>(const_cast<void*>(ring[2])),
                       static_cast<T*>(const_cast<void*>(ring[3])),
                       static_cast<T*>(const_cast<void*>(ring[4])),
                       static_cast<T*>(const_cast<void*>(ring[5])),
                       static_cast<T*>(const_cast<void*>(ring[6]))};
  return launch_sweep<T>(r.v0, r.zero, r.zero, state, cvals, fields, offs, k, nz, ny, nx, cz,
                         ty, tx, r.y0, r.z0, W, partials, partials_cap, z0, z1, stream, &r);
}

}  // namespace eu

#define EU_SWEEP_API(T, SUF)                                                          \
  extern "C" int eu_fused_sweep_##SUF(                                                \
      const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* cvals,          \
      const int* offs, int k, int nz, int ny, int nx, int cz, int ty, int tx, T* Y,  \
      T* Zn, T* W, T* partials, long long partials_cap, int z0, int z1,             \
      void* stream) {                                                                 \
    return eu::launch_sweep<T>(Z, Vc, Vp, coefs, cvals, nullptr, offs, k, nz, ny,    \
                               nx, cz, ty, tx, Y, Zn, W, partials, partials_cap, z0, \
                               z1, (cudaStream_t)stream);                            \
  }                                                                                   \
  extern "C" int eu_fused_sweep_var_##SUF(                                            \
      const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* fields,         \
      const int* offs, int k, int nz, int ny, int nx, int cz, int ty, int tx, T* Y,  \
      T* Zn, T* W, T* partials, long long partials_cap, int z0, int z1,             \
      void* stream) {                                                                 \
    return eu::launch_sweep<T>(Z, Vc, Vp, coefs, nullptr, fields, offs, k, nz, ny,   \
                               nx, cz, ty, tx, Y, Zn, W, partials, partials_cap, z0, \
                               z1, (cudaStream_t)stream);                            \
  }                                                                                   \
  extern "C" int eu_fused_sweep_ring_##SUF(                                           \
      const void* const* ring, const T* state, const T* cvals, const int* offs, int k, \
      int nz, int ny, int nx, int cz, int ty, int tx, T* W, T* partials,             \
      long long partials_cap, int z0, int z1, void* stream) {                        \
    return eu::launch_sweep_ring<T>(ring, state, cvals, nullptr, offs, k, nz, ny, nx, \
                                    cz, ty, tx, W, partials, partials_cap, z0, z1,    \
                                    (cudaStream_t)stream);                            \
  }                                                                                   \
  extern "C" int eu_fused_sweep_var_ring_##SUF(                                       \
      const void* const* ring, const T* state, const T* fields, const int* offs, int k, \
      int nz, int ny, int nx, int cz, int ty, int tx, T* W, T* partials,             \
      long long partials_cap, int z0, int z1, void* stream) {                        \
    return eu::launch_sweep_ring<T>(ring, state, nullptr, fields, offs, k, nz, ny, nx, \
                                    cz, ty, tx, W, partials, partials_cap, z0, z1,    \
                                    (cudaStream_t)stream);                            \
  }                                                                                   \
  extern "C" int eu_fused_sweep_capacity_##SUF(const int* offs, int k, int ty, int tx, \
                                               int var) {                             \
    return eu::sweep_capacity<T>(offs, k, ty, tx, var);                               \
  }                                                                                   \
  extern "C" int eu_sweep_stage_##SUF(const T* partials, int nblocks, T* moments,     \
                                      T* state, T* alphas, T* betas, const T* coeffs, \
                                      int j, int m, double tol, void* stream) {       \
    return eu::launch_stage<T>(partials, nblocks, moments, state, alphas, betas,      \
                               coeffs, j, m, tol, (cudaStream_t)stream);              \
  }                                                                                   \
  extern "C" int eu_sweep_stage_rows_##SUF(T* state, const T* rows, int m,           \
                                           void* stream) {                            \
    return eu::launch_stage_rows<T>(state, rows, m, (cudaStream_t)stream);            \
  }

EU_SWEEP_API(float, f32)
EU_SWEEP_API(double, f64)

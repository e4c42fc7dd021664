// B4, B5 and B6: the (m, 4)-row recurrence of B1 with other per-row
// operators and p accumulators, each in ONE persistent cooperative launch;
// and the neighbour form that B1, B4 and B5 take where it fits.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_kernel         (B1, resident.py:89; its grid form: resident.cu)
//   _resident_kernel_multi   (B4, resident.py:394)
//   _resident_banded_kernel  (B5, resident.py:186)
//   _resident_grid_kernel    (B6, resident.py:331)
//
//   omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
//   W[j] += cw[k, j] omega_k   (j < p),   omega_0 = x,  omega_{-1} = 0
//
// The three TPU kernels differ only in how A acts on one row: a 1-D
// constant stencil (B4), per-row diagonal values (B5), or a 2-D/3-D
// constant stencil on the natural row-major (nz, ny, nx) layout (B6); B4
// also keeps p accumulators where B5 and B6 keep one. Here they are one
// kernel template over the per-row operator (the structs below), built as
// B1 is (csrc/resident.cu): a co-resident grid sized by the occupancy API
// walks the vectors with grid-stride loops, and one cg::this_grid().sync()
// per step orders every write of omega_{k+1} before any read of it.
//
// What bounds them on the H100:
//   B4 at n = 1e5 (p = 4, float64: 3 state and 4 accumulator vectors,
//   5.6 MB) and B6 under its gate (4 vectors within 40 MB) keep their data
//   in the 50 MB L2, so a step is a few microseconds of L2 traffic and the
//   grid barrier's latency bounds it; the one-launch design pays that
//   barrier once per step instead of a kernel launch and the host's
//   launch gaps.
//   B5 at N = 1e6 in float64 streams the k = 5 diagonals plus the state
//   every step in this kernel (~72 MB, more than L2): it is bound by HBM
//   bandwidth, about 20-30 us per step at 3.35 TB/s.
// The family kernel has no reductions, and B1's sum of w^2 in the neighbour
// form is summed in a fixed order, so every result is bitwise repeatable.
//
// The neighbour form (resident_nbr_kernel, below) takes the launches of B1
// (with its sum of w^2), B4 and B5 whose per-block state fits on chip: it
// drops the grid barrier, which a step of the recurrence does not need
// (row i of omega_{k+1} reads omega_k only within max|o| rows of i), for
// flags between neighbouring blocks, and keeps the state in shared memory,
// so only B5's diagonals still cross L2 every step (40 MB at config #3,
// within L2). This family kernel stays for what the neighbour form cannot
// take: B4 past 8 columns, max|o| wider than a block's rows, or a block
// state that does not fit. Both forms compute a row with the row
// functions of common.cuh (accumulate, stencil_term, next_row), so they
// give the same bits at any shape both take.
#include <cooperative_groups.h>

#include <cstddef>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace eu {

// Per-row operators. points() coefficient values are staged in shared
// memory by the kernel and passed back to row() as `c`.

template <typename T>
struct Stencil1D {             // B4: y_i = sum_j c_j x_{i + o_j}, Dirichlet
  Offsets1D offs;
  const T* cvals;
  long long n;
  __device__ int points() const { return offs.k; }
  __device__ T coeff(int j) const { return cvals[j]; }
  __device__ T row(const T* x, long long i, const T* c) const {
    T z = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const long long q = i + offs.o[j];
      if (q >= 0 && q < n) z = stencil_term(z, c[j], x[q]);
    }
    return z;
  }
};

template <typename T>
struct Banded {                // B5: y_i = sum_j D[j, i] x_{i + o_j}
  Offsets1D offs;
  const T* diags;              // (k, n), row-major
  long long n;
  __device__ int points() const { return 0; }
  __device__ T coeff(int) const { return T(0); }
  __device__ T row(const T* x, long long i, const T*) const {
    T z = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const long long q = i + offs.o[j];
      if (q >= 0 && q < n) z = stencil_term(z, __ldg(diags + (long long)j * n + i), x[q]);
    }
    return z;
  }
};

template <typename T>
struct Grid3D {                // B6: constant stencil on (nz, ny, nx), Dirichlet
  Offsets3D offs;
  long long flat[kMaxPoints];  // (dz ny + dy) nx + dx per point
  const T* cvals;
  int nz, ny, nx;
  __device__ int points() const { return offs.k; }
  __device__ T coeff(int j) const { return cvals[j]; }
  __device__ T row(const T* x, long long i, const T* c) const {
    const long long plane = (long long)ny * nx;
    const int z = (int)(i / plane);
    const long long r = i - (long long)z * plane;
    const int y = (int)(r / nx);
    const int xx = (int)(r - (long long)y * nx);
    T acc = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const int qz = z + offs.dz[j], qy = y + offs.dy[j], qx = xx + offs.dx[j];
      if (qz >= 0 && qz < nz && qy >= 0 && qy < ny && qx >= 0 && qx < nx)
        acc += c[j] * x[i + flat[j]];
    }
    return acc;
  }
};

// W (p, n) = sum_k cw[k * cw_stride + j] omega_k; buf holds 3n scratch
// values (previous, current, next), rotated per step.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
resident_family_kernel(const T* __restrict__ x, const T* __restrict__ rows,
                       const T* __restrict__ cw, int cw_stride, int p, Op op,
                       long long n, int m, T* __restrict__ W, T* buf) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T c_sh[kMaxPoints];
  for (int j = threadIdx.x; j < op.points(); j += kThreads) c_sh[j] = op.coeff(j);
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  T* bp = buf;
  T* bc = buf + n;
  T* bn = buf + 2 * n;
  for (long long i = i0; i < n; i += stride) {
    bc[i] = x[i];
    bp[i] = T(0);
    for (int j = 0; j < p; ++j) W[(long long)j * n + i] = T(0);
  }
  grid.sync();

  for (int step = 0; step < m; ++step) {
    const T ca = rows[4 * step + 0];
    const T cb = rows[4 * step + 1];
    const T cc = rows[4 * step + 2];
    const T* cwk = cw + (long long)step * cw_stride;
    for (long long i = i0; i < n; i += stride) {
      const T wc = bc[i];
      for (int j = 0; j < p; ++j)
        W[(long long)j * n + i] = accumulate(W[(long long)j * n + i], cwk[j], wc);
      const T z = op.row(bc, i, c_sh);
      bn[i] = next_row(ca, cb, cc, z, wc, bp[i]);
    }
    grid.sync();   // every omega_{k+1} row is written before any is read
    T* t = bp;
    bp = bc;
    bc = bn;
    bn = t;
  }
}

template <typename T, typename Op>
int launch_family(const T* x, const T* rows, const T* cw, int cw_stride, int p,
                  Op op, long long n, int m, T* W, T* buf, cudaStream_t stream) {
  if (n < 1 || m < 0 || p < 1) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)resident_family_kernel<T, Op>;
  int grid = 0;
  const int e = grid_for(fn, n, &grid);
  if (e) return e;
  void* args[] = {(void*)&x, (void*)&rows, (void*)&cw, (void*)&cw_stride, (void*)&p,
                  (void*)&op, (void*)&n, (void*)&m, (void*)&W, (void*)&buf};
  cudaError_t le = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// B4: p accumulators, W (p, n), cw (m, p).
template <typename T>
int launch_multi(const T* x, const T* rows, const T* cw, int p, const T* cvals,
                 const int* offs, int k, long long n, int m, T* W, T* buf,
                 cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints) return (int)cudaErrorInvalidValue;
  Stencil1D<T> op{make_offsets(offs, k), cvals, n};
  return launch_family<T>(x, rows, cw, p, p, op, n, m, W, buf, stream);
}

// The neighbour forms of B1, B4 and B5: persistent cooperative grids with no
// grid barrier (one block of 1024 threads per SM at most: the cooperative
// launch guarantees co-residency, which the spinning needs). Block b owns
// the rows [b chunk, (b + 1) chunk) and keeps on chip, for all m steps, its
// omega spans of chunk + 2h values (its rows plus h = max|o| halo rows each
// side) and its p accumulator rows. W is written once, at the end, and x
// read once, so the HBM traffic is the byte bound (B5: plus the diagonals,
// which L2 serves from the second step on where they fit it). Two kernels:
// B4's resident_multi_nbr_kernel<T> (three spans: previous, current, next),
// and resident_nbr_kernel<T, Op>, one template over the per-row operator
// for B1 (NbrStencil, one accumulator and sum w^2) and B5 (NbrBanded). B4
// keeps a kernel of its own: run through the template, B4 took the same
// time at config #2 on the H100, but the template's p columns made B1's
// step 7 % slower (PERF.md). Step k:
//   1. W += cw[k] omega_k and omega_{k+1} (row functions of common.cuh) for
//      the h edge rows at each end first, each also written to the global
//      halo buffer of parity (k + 1) & 1,
//   2. after a block barrier, thread 0 releases the block's flag =
//      base + k + 1 at device scope (st.release.gpu: the barrier
//      and the release's cumulativity order every thread's edge stores
//      before it; a __threadfence before it cost 0.6 us a step on the
//      H100, sync_bench.cu),
//   3. warps 2-31 do the same for the interior rows while the flag
//      travels; meanwhile lane 0 of warp 0 waits (acquire loads,
//      __nanosleep back-off) for the left neighbour's flag and warp 0 reads
//      its edge into the halo rows, warp 1 the right one's, with
//      ld.global.cg (L1 is not coherent across SMs); one more block
//      barrier, and the next step starts. The next step's scalars are
//      fetched by the last warp at the start of a step and stored to
//      shared memory before that barrier.
// Parity buffers suffice: a neighbour sets its flag for omega_{k+1} only
// after it has read this block's omega_k edges, so this block, which
// waits for that flag before it publishes omega_{k+2} into omega_k's
// parity, never overwrites edges still being read.
// The flags only grow, and nothing resets them: a launch publishes m - 1
// steps in every block, so every flag holds the same count when a launch
// starts, and each block reads that base from its own flag (which only it
// writes). A launch's waits are for base + k + 1, which no flag of an
// earlier launch holds; the base lives on the card, so a launch replayed
// from a CUDA graph reads the count its predecessors left. Two launches
// that may overlap (two streams) need flags and halos of their own: the
// plan keeps a set per stream.
struct NbrLaunch {      // mirrored by resident._NbrLaunch; one per plan and stream
  const void* coef;     // B1, B4: the k stencil coefficients; B5: the (k, n)
                        // diagonals; in the launch's dtype
  void* flags;          // grid unsigned 64-bit step counts kFlagStride apart,
                        // zero when made
  void* halo;           // [2][grid][2][h] edge values
  void* partials;       // grid values: the blocks' sums of w^2 (B1), or null
  void* ticket;         // one unsigned 64-bit count of blocks done, zero when
                        // made (B1), or null
  long long n;
  int grid;
  int chunk;            // rows a block owns; every block owns at least one
  int h;                // max |o| <= chunk
  int k;
  int kd;               // NbrBanded: diagonals 0..kd-1 kept in shared memory
  int o[kMaxPoints];
};
static_assert(offsetof(NbrLaunch, partials) == 24 && offsetof(NbrLaunch, ticket) == 32 &&
                  offsetof(NbrLaunch, n) == 40 && offsetof(NbrLaunch, grid) == 48 &&
                  offsetof(NbrLaunch, k) == 60 && offsetof(NbrLaunch, kd) == 64 &&
                  offsetof(NbrLaunch, o) == 68 && sizeof(NbrLaunch) == 328,
              "NbrLaunch layout is mirrored by resident._NbrLaunch");

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A neighbour is at most one step behind a co-resident block, so a wait of
// seconds means a broken launch: trap (a launch error the wrapper raises)
// rather than hang the card.
__device__ __forceinline__ void wait_flag(const unsigned long long* p, unsigned long long want) {
  int tries = 0;
  while (load_acquire(p) < want) {
    if (++tries > 16) __nanosleep(tries < 64 ? 32 : 128);
    if (tries > (1 << 25)) __trap();
  }
}

constexpr int kNbrThreads = 1024;   // a block of the neighbour form
constexpr int kMaxCols = 8;         // p <= dispatch.MAX_COLS
// Block b's flag is flags[b kFlagStride]: one flag per 128-byte line. With
// the flags packed, sixteen blocks' releases and their neighbours' polls
// shared a line, and a step cost 0.1-0.2 us more on the H100, depending on
// where the buffer landed (PERF.md).
constexpr int kFlagStride = 16;

// B4 (p accumulators).
// Dynamic shared memory of one block: 3 spans of omega, p accumulator rows.
inline size_t multi_nbr_smem(const NbrLaunch& L, int p, size_t itemsize) {
  return (3 * (size_t)(L.chunk + 2 * L.h) + (size_t)p * L.chunk) * itemsize;
}

template <typename T>
__global__ void __launch_bounds__(kNbrThreads, 1)
resident_multi_nbr_kernel(const T* __restrict__ x, const T* __restrict__ rows,
                          const T* __restrict__ cw, int p, const __grid_constant__ NbrLaunch L,
                          int m, T* __restrict__ W) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T coef[2][4 + kMaxCols];   // a step's ca, cb, cc, -, cw[0..p), by parity
  __shared__ unsigned long long base_sh;   // the flags' count when the launch started
  const int t = threadIdx.x, b = blockIdx.x, warp = t >> 5, lane = t & 31;
  const int h = L.h, k = L.k, chunk = L.chunk, span = chunk + 2 * h;
  const long long n = L.n, lo = (long long)b * chunk;
  const int len = (int)(n - lo < chunk ? n - lo : chunk);
  T* wp = reinterpret_cast<T*>(smem_raw);   // omega_{k-1}; span index h + i is row lo + i
  T* wc = wp + span;                         // omega_k
  T* wn = wc + span;                         // omega_{k+1}
  T* acc = wn + span;                        // acc[j chunk + i]: W[j] of row lo + i
  T* halo = static_cast<T*>(L.halo);
  unsigned long long* flags = static_cast<unsigned long long*>(L.flags);
  // lane l of the last warp fetches coefficient l of the next step
  auto fetch = [&](int s) -> T {
    const int l = t - (kNbrThreads - 32);
    if (s >= m || l < 0) return T(0);
    if (l < 3) return rows[4 * s + l];
    if (l >= 4 && l < 4 + p) return cw[(long long)s * p + l - 4];
    return T(0);
  };
  for (int j = t; j < k; j += kNbrThreads) {
    c_sh[j] = static_cast<const T*>(L.coef)[j];
    o_sh[j] = L.o[j];
  }
  for (int i = t; i < span; i += kNbrThreads) {   // omega_0 = x with its halo rows
    const long long q = lo - h + i;
    wc[i] = q >= 0 && q < n ? x[q] : T(0);
    wp[i] = T(0);
  }
  for (int i = t; i < p * chunk; i += kNbrThreads) acc[i] = T(0);
  if (warp == kNbrThreads / 32 - 1 && lane < 4 + kMaxCols) coef[0][lane] = fetch(0);
  unsigned long long* own = flags + (size_t)b * kFlagStride;
  if (t == 0) base_sh = load_acquire(own);
  __syncthreads();
  const unsigned long long base = base_sh;

  for (int step = 0; step < m; ++step) {
    const T* cf = coef[step & 1];
    const T next = fetch(step + 1);   // lands while the step runs
    const T ca = cf[0], cb = cf[1], cc = cf[2];
    // one row: W += cw[k] omega_k, then omega_{k+1}; rows within h of an
    // edge skip the stencil points outside [0, n), interior rows have none
    auto accumulate_row = [&](int i) {
      const T v = wc[h + i];
      for (int j = 0; j < p; ++j) acc[j * chunk + i] = accumulate(acc[j * chunk + i], cf[4 + j], v);
      return v;
    };
    auto row = [&](int i, bool edge) {
      const T v = accumulate_row(i);
      T z = T(0);
      for (int j = 0; j < k; ++j) {
        if (edge) {
          const long long q = lo + i + o_sh[j];
          if (q < 0 || q >= n) continue;
        }
        z = stencil_term(z, c_sh[j], wc[h + i + o_sh[j]]);
      }
      const T w = next_row(ca, cb, cc, z, v, wp[h + i]);
      wn[h + i] = w;
      return w;
    };
    if (step + 1 == m) {   // omega_m is never accumulated: W only
      for (int i = t; i < len; i += kNbrThreads) accumulate_row(i);
      break;
    }
    const int par = (step + 1) & 1;
    T* mine = halo + ((size_t)par * L.grid + b) * 2 * h;
    // the edge rows first, published as they are computed: [0, h) of the
    // halo slot holds the first h rows, [h, 2h) the last h
    for (int e = t; e < 2 * h; e += kNbrThreads) {
      const int i = e < h ? e : len - 2 * h + e;
      if (i < 0 || i >= len || (e >= h && i < h)) continue;   // counted once
      const T w = row(i, true);
      if (i < h) mine[i] = w;
      if (i >= len - h) mine[2 * h - len + i] = w;
    }
    __syncthreads();   // the edges are written
    // the release orders the block's edge stores (before the barrier)
    // ahead of the flag for any thread that acquires it
    const unsigned long long want = base + (unsigned long long)(step + 1);
    if (t == 0) store_release(own, want);
    if (warp >= 2) {   // the interior rows while the flag travels
      for (int i = h + t - 64; i < len - h; i += kNbrThreads - 64) row(i, false);
    } else if (warp == 0 && b > 0) {   // the left block's last h rows
      if (lane == 0) wait_flag(own - kFlagStride, want);
      __syncwarp();
      const T* src = halo + ((size_t)par * L.grid + b - 1) * 2 * h + h;
      for (int i = lane; i < h; i += 32) wn[i] = __ldcg(src + i);   // rows lo - h + i
    } else if (warp == 1 && b + 1 < L.grid) {   // the right block's first h rows
      if (lane == 0) wait_flag(own + kFlagStride, want);
      __syncwarp();
      const T* src = halo + ((size_t)par * L.grid + b + 1) * 2 * h;
      for (int i = lane; i < h && lo + len + i < n; i += 32)
        wn[h + len + i] = __ldcg(src + i);                          // rows lo + len + i
    }
    if (warp == kNbrThreads / 32 - 1 && lane < 4 + kMaxCols) coef[par][lane] = next;
    __syncthreads();
    T* tmp = wp;
    wp = wc;
    wc = wn;
    wn = tmp;
  }
  for (int i = t; i < len; i += kNbrThreads)
    for (int j = 0; j < p; ++j) W[(long long)j * n + lo + i] = acc[j * chunk + i];
}

// B1 and B5: the template over the per-row operator. A block keeps two
// omega spans (omega_{k+1} is written in place over omega_{k-1}: row i of
// omega_{k-1} is read only by the thread that overwrites it, and only
// omega_k's rows are read across rows), one accumulator row and, for B5,
// the first kd diagonals' values of its rows (kd as many as fit beside the
// state; the others are read from global memory every step, each row's
// loads issued before its FMAs). A halo wider than kNbrWarpHalo rows is
// copied by every thread after the interior rows (one warp's serial L2
// round trips would dominate the step), a narrower one by warps 0 and 1
// while the interior is computed, as in B4's kernel.
// B1's sum of w^2 needs no grid barrier either: each block writes its
// partial (a fixed-order block sum), fences, and takes a ticket with one
// atomicAdd; the ticket grows by `grid` a launch (it starts at 0), so the
// block that draws a multiple of `grid` is the last of its launch, also
// under CUDA-graph replays, and it sums the partials in block order: the
// same bits at every launch.
struct NbrStencil {              // B1: k constants, staged in shared memory
  static constexpr bool kBanded = false;
};
struct NbrBanded {               // B5: row i's value of each diagonal
  static constexpr bool kBanded = true;
};

constexpr int kNbrLoads = 8;        // B5: diagonal loads issued before their FMAs
constexpr int kNbrWarpHalo = 64;    // halo rows a side one warp copies (wider: all)

// Dynamic shared memory of one block: 2 spans of omega, the accumulator
// row, kd diagonal rows.
inline size_t nbr_smem(const NbrLaunch& L, size_t itemsize) {
  return (2 * (size_t)(L.chunk + 2 * L.h) + (size_t)(1 + L.kd) * L.chunk) * itemsize;
}

// Sum over the block's kNbrThreads threads in a fixed order (warp shuffles,
// then the warps' sums in warp order): the total, in thread 0. Every
// thread of the block calls; `red` holds kNbrThreads / 32 values.
template <typename T>
__device__ __forceinline__ T nbr_block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();   // the previous call's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = red[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// w = sum_k cw_k omega_k (cw_k = rows[k][3]), omega_0 = s x (x where scale
// is null); with nrm2 also *nrm2 = sum w^2.
template <typename T, typename Op>
__global__ void __launch_bounds__(kNbrThreads, 1)
resident_nbr_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    const T* __restrict__ rows, const __grid_constant__ NbrLaunch L, int m,
                    T* __restrict__ w, T* __restrict__ nrm2) {
  extern __shared__ __align__(16) unsigned char smem_nbr[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T coef[2][4];   // a step's ca, cb, cc, cw, by parity
  __shared__ T red[kNbrThreads / 32];
  __shared__ unsigned long long base_sh;   // the flags' count when the launch started
  __shared__ int last_sh;
  const int t = threadIdx.x, b = blockIdx.x, warp = t >> 5, lane = t & 31;
  const int h = L.h, k = L.k, kd = L.kd, chunk = L.chunk, span = chunk + 2 * h;
  const long long n = L.n, lo = (long long)b * chunk;
  const int len = (int)(n - lo < chunk ? n - lo : chunk);
  T* wc = reinterpret_cast<T*>(smem_nbr);   // omega_k; span index h + i is row lo + i
  T* wp = wc + span;                         // omega_{k-1}, then omega_{k+1} in place
  T* acc = wp + span;                        // acc[i]: w of row lo + i
  T* dsh = acc + chunk;                      // dsh[j chunk + i]: diagonal j at row lo + i
  const T* coefs = static_cast<const T*>(L.coef);
  T* halo = static_cast<T*>(L.halo);
  unsigned long long* flags = static_cast<unsigned long long*>(L.flags);
  // lane l < 4 of the last warp fetches scalar l of a step
  const int fetcher = t - (kNbrThreads - 32);
  for (int j = t; j < k; j += kNbrThreads) {
    if (!Op::kBanded) c_sh[j] = coefs[j];
    o_sh[j] = L.o[j];
  }
  for (int i = t; i < span; i += kNbrThreads) {   // omega_0 with its halo rows
    const long long q = lo - h + i;
    T v = T(0);
    if (q >= 0 && q < n) v = scale ? scale[0] * x[q] : x[q];
    wc[i] = v;
    wp[i] = T(0);
  }
  for (int i = t; i < chunk; i += kNbrThreads) acc[i] = T(0);
  if (Op::kBanded)
    for (int j = 0; j < kd; ++j)
      for (int i = t; i < len; i += kNbrThreads)
        dsh[(size_t)j * chunk + i] = coefs[(size_t)j * n + lo + i];
  if (fetcher >= 0 && fetcher < 4) coef[0][fetcher] = m > 0 ? rows[fetcher] : T(0);
  unsigned long long* own = flags + (size_t)b * kFlagStride;
  if (t == 0) base_sh = load_acquire(own);
  __syncthreads();
  const unsigned long long base = base_sh;

  for (int step = 0; step < m; ++step) {
    const T* cf = coef[step & 1];
    // the next step's scalars land while this step runs
    const T next = fetcher >= 0 && fetcher < 4 && step + 1 < m ? rows[4 * (step + 1) + fetcher]
                                                               : T(0);
    const T ca = cf[0], cb = cf[1], cc = cf[2], cw = cf[3];
    // one row: w += cw omega_k, then omega_{k+1}; rows within h of an edge
    // skip the points outside [0, n), interior rows have none
    auto row = [&](int i, bool edge) {
      const T v = wc[h + i];
      acc[i] = accumulate(acc[i], cw, v);
      T z = T(0);
      if (Op::kBanded) {
        const long long g = lo + i;
        for (int j0 = 0; j0 < k; j0 += kNbrLoads) {
          T a[kNbrLoads];
#pragma unroll
          for (int u = 0; u < kNbrLoads; ++u) {
            const int j = j0 + u;
            a[u] = j >= k   ? T(0)
                   : j < kd ? dsh[j * chunk + i]
                            : __ldg(coefs + (size_t)j * n + g);
          }
#pragma unroll
          for (int u = 0; u < kNbrLoads; ++u) {
            const int j = j0 + u;
            if (j >= k) break;
            if (edge) {
              const long long q = g + o_sh[j];
              if (q < 0 || q >= n) continue;
            }
            z = stencil_term(z, a[u], wc[h + i + o_sh[j]]);
          }
        }
      } else {
        for (int j = 0; j < k; ++j) {
          if (edge) {
            const long long q = lo + i + o_sh[j];
            if (q < 0 || q >= n) continue;
          }
          z = stencil_term(z, c_sh[j], wc[h + i + o_sh[j]]);
        }
      }
      const T wn = next_row(ca, cb, cc, z, v, wp[h + i]);
      wp[h + i] = wn;
      return wn;
    };
    if (step + 1 == m) {   // omega_m is never accumulated: w only
      for (int i = t; i < len; i += kNbrThreads) acc[i] = accumulate(acc[i], cw, wc[h + i]);
      break;
    }
    const int par = (step + 1) & 1;
    T* mine = halo + ((size_t)par * L.grid + b) * 2 * h;
    // the edge rows first, published as they are computed: [0, h) of the
    // halo slot holds the first h rows, [h, 2h) the last h
    for (int e = t; e < 2 * h; e += kNbrThreads) {
      const int i = e < h ? e : len - 2 * h + e;
      if (i < 0 || i >= len || (e >= h && i < h)) continue;   // counted once
      const T v = row(i, true);
      if (i < h) mine[i] = v;
      if (i >= len - h) mine[2 * h - len + i] = v;
    }
    __syncthreads();   // the edges are written
    // the release orders the block's edge stores (before the barrier)
    // ahead of the flag for any thread that acquires it
    const unsigned long long want = base + (unsigned long long)(step + 1);
    if (t == 0) store_release(own, want);
    // the neighbours' edges: the left block's last h rows (the second half
    // of its slot) become rows lo - h + i, the right block's first h rows
    // lo + len + i
    const bool wide = h > kNbrWarpHalo;
    if (warp >= 2) {   // the interior rows while the flag travels
      for (int i = h + t - 64; i < len - h; i += kNbrThreads - 64) row(i, false);
    } else if (warp == 0 && b > 0) {
      if (lane == 0) wait_flag(own - kFlagStride, want);
      __syncwarp();
      const T* left = mine - h;
      if (!wide)
        for (int i = lane; i < h; i += 32) wp[i] = __ldcg(left + i);
    } else if (warp == 1 && b + 1 < L.grid) {
      if (lane == 0) wait_flag(own + kFlagStride, want);
      __syncwarp();
      const T* right = mine + 2 * h;
      if (!wide)
        for (int i = lane; i < h && lo + len + i < n; i += 32) wp[h + len + i] = __ldcg(right + i);
    }
    if (fetcher >= 0 && fetcher < 4) coef[par][fetcher] = next;
    __syncthreads();   // the flags were acquired before this barrier
    if (wide) {
      for (int e = t; e < 2 * h; e += kNbrThreads) {
        if (e < h) {
          if (b > 0) wp[e] = __ldcg(mine - h + e);
        } else if (b + 1 < L.grid && lo + len + e - h < n) {
          wp[len + e] = __ldcg(mine + h + e);
        }
      }
      __syncthreads();
    }
    T* tmp = wp;
    wp = wc;
    wc = tmp;
  }
  for (int i = t; i < len; i += kNbrThreads) w[lo + i] = acc[i];
  if (nrm2 == nullptr) return;
  // sum w^2: this block's rows, then the last block of the launch sums the
  // grid's partials in block order
  T sq = T(0);
  for (int i = t; i < len; i += kNbrThreads) sq = fma_rn(acc[i], acc[i], sq);
  sq = nbr_block_sum(sq, red);
  T* partials = static_cast<T*>(L.partials);
  if (t == 0) {
    partials[b] = sq;
    __threadfence();   // the partial is visible before the ticket is
    const unsigned long long done =
        atomicAdd(static_cast<unsigned long long*>(L.ticket), 1ull) + 1;
    last_sh = done % (unsigned long long)L.grid == 0;
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  T a = T(0);
  for (int q = t; q < L.grid; q += kNbrThreads) a += __ldcg(partials + q);
  a = nbr_block_sum(a, red);
  if (t == 0) nrm2[0] = a;
}

// Opt `fn` in to `bytes` of dynamic shared memory as far as a launch needs;
// `allowed` is the caller's static (one per kernel and library).
inline cudaError_t allow_smem(const void* fn, size_t bytes, size_t* allowed) {
  if (bytes > *allowed) {
    cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    *allowed = bytes;
  }
  return cudaSuccess;
}

template <typename T>
static cudaError_t allow_multi_nbr_smem(size_t bytes) {   // static: one flag per library
  static size_t allowed = 0;
  return allow_smem((const void*)resident_multi_nbr_kernel<T>, bytes, &allowed);
}

template <typename T, typename Op>
static cudaError_t allow_nbr_smem(size_t bytes) {
  static size_t allowed = 0;
  return allow_smem((const void*)resident_nbr_kernel<T, Op>, bytes, &allowed);
}

// Blocks of a neighbour kernel co-resident on the current device with
// `smem` bytes of dynamic shared memory each (0: a block does not fit);
// negative: a CUDA error.
inline int nbr_capacity(const void* fn, cudaError_t (*allow)(size_t), size_t smem) {
  int dev = 0, optin = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  if (smem + fa.sharedSizeBytes > (size_t)optin) return 0;
  e = allow(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kNbrThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// kind 0: B4's kernel; 1: B1's (NbrStencil); 2: B5's (NbrBanded)
template <typename T>
int nbr_capacity(int kind, size_t smem) {
  switch (kind) {
    case 0:
      return nbr_capacity((const void*)resident_multi_nbr_kernel<T>, allow_multi_nbr_smem<T>,
                          smem);
    case 1:
      return nbr_capacity((const void*)resident_nbr_kernel<T, NbrStencil>,
                          allow_nbr_smem<T, NbrStencil>, smem);
    case 2:
      return nbr_capacity((const void*)resident_nbr_kernel<T, NbrBanded>,
                          allow_nbr_smem<T, NbrBanded>, smem);
  }
  return -(int)cudaErrorInvalidValue;
}

inline bool nbr_valid(const NbrLaunch& L) {
  if (L.k < 1 || L.k > kMaxPoints || L.n < 1 || L.grid < 1 || L.chunk < 1 || L.h < 0 ||
      L.h > L.chunk || L.kd < 0 || L.kd > L.k || (long long)(L.grid - 1) * L.chunk >= L.n ||
      (long long)L.grid * L.chunk < L.n)
    return false;
  for (int j = 0; j < L.k; ++j)
    if (L.o[j] > L.h || -L.o[j] > L.h) return false;
  return true;
}

template <typename T>
int launch_multi_nbr(const NbrLaunch& L, const T* x, const T* rows, const T* cw, int p, int m,
                     T* W, cudaStream_t stream) {
  if (!nbr_valid(L) || L.kd != 0 || p < 1 || p > kMaxCols || m < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = multi_nbr_smem(L, p, sizeof(T));
  cudaError_t e = allow_multi_nbr_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&x, (void*)&rows, (void*)&cw, (void*)&p, (void*)&L,
                  (void*)&m, (void*)&W};
  e = cudaLaunchCooperativeKernel((const void*)resident_multi_nbr_kernel<T>, dim3(L.grid),
                                  dim3(kNbrThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename Op>
int launch_nbr(const NbrLaunch& L, const T* x, const T* scale, const T* rows, int m, T* w,
               T* nrm2, cudaStream_t stream) {
  if (!nbr_valid(L) || m < 0 || (!Op::kBanded && L.kd != 0) ||
      (nrm2 != nullptr && (L.partials == nullptr || L.ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nbr_smem(L, sizeof(T));
  cudaError_t e = allow_nbr_smem<T, Op>(smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&x, (void*)&scale, (void*)&rows, (void*)&L,
                  (void*)&m, (void*)&w, (void*)&nrm2};
  e = cudaLaunchCooperativeKernel((const void*)resident_nbr_kernel<T, Op>, dim3(L.grid),
                                  dim3(kNbrThreads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// B5: one accumulator with cw the fourth column of rows.
template <typename T>
int launch_banded(const T* x, const T* rows, const T* diags, const int* offs, int k,
                  long long n, int m, T* w, T* buf, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints) return (int)cudaErrorInvalidValue;
  Banded<T> op{make_offsets(offs, k), diags, n};
  return launch_family<T>(x, rows, rows + 3, 4, 1, op, n, m, w, buf, stream);
}

// B6: one accumulator; offs holds k (dz, dy, dx) triples; 2-D grids as nz = 1.
template <typename T>
int launch_grid(const T* x, const T* rows, const T* cvals, const int* offs, int k,
                int nz, int ny, int nx, int m, T* w, T* buf, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints || nz < 1 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  Grid3D<T> op{};
  op.offs.k = k;
  for (int j = 0; j < k; ++j) {
    op.offs.dz[j] = offs[3 * j + 0];
    op.offs.dy[j] = offs[3 * j + 1];
    op.offs.dx[j] = offs[3 * j + 2];
    op.flat[j] = ((long long)op.offs.dz[j] * ny + op.offs.dy[j]) * nx + op.offs.dx[j];
  }
  op.cvals = cvals;
  op.nz = nz;
  op.ny = ny;
  op.nx = nx;
  const long long n = (long long)nz * ny * nx;
  return launch_family<T>(x, rows, rows + 3, 4, 1, op, n, m, w, buf, stream);
}

}  // namespace eu

#define EU_FAMILY_API(T, SUF)                                                        \
  extern "C" int eu_resident_multi_##SUF(                                            \
      const T* x, const T* rows, const T* cw, int p, const T* cvals, const int* offs,\
      int k, long long n, int m, T* W, T* buf, void* stream) {                      \
    return eu::launch_multi<T>(x, rows, cw, p, cvals, offs, k, n, m, W, buf,        \
                               (cudaStream_t)stream);                               \
  }                                                                                 \
  extern "C" int eu_resident_banded_##SUF(                                           \
      const T* x, const T* rows, const T* diags, const int* offs, int k,            \
      long long n, int m, T* w, T* buf, void* stream) {                             \
    return eu::launch_banded<T>(x, rows, diags, offs, k, n, m, w, buf,              \
                                (cudaStream_t)stream);                              \
  }                                                                                 \
  extern "C" int eu_resident_grid_##SUF(                                             \
      const T* x, const T* rows, const T* cvals, const int* offs, int k, int nz,    \
      int ny, int nx, int m, T* w, T* buf, void* stream) {                          \
    return eu::launch_grid<T>(x, rows, cvals, offs, k, nz, ny, nx, m, w, buf,       \
                              (cudaStream_t)stream);                                \
  }                                                                                 \
  extern "C" int eu_nbr_capacity_##SUF(int kind, long long smem) {                 \
    return eu::nbr_capacity<T>(kind, (size_t)smem);                                 \
  }                                                                                 \
  extern "C" int eu_resident_multi_nbr_##SUF(                                        \
      const eu::NbrLaunch* L, const T* x, const T* rows, const T* cw, int p, int m, \
      T* W, void* stream) {                                                         \
    return eu::launch_multi_nbr<T>(*L, x, rows, cw, p, m, W, (cudaStream_t)stream); \
  }                                                                                 \
  extern "C" int eu_resident_recurrence_nbr_##SUF(                                   \
      const eu::NbrLaunch* L, const T* x, const T* scale, const T* rows, int m,     \
      T* w, T* nrm2, void* stream) {                                                \
    return eu::launch_nbr<T, eu::NbrStencil>(*L, x, scale, rows, m, w, nrm2,        \
                                             (cudaStream_t)stream);                 \
  }                                                                                 \
  extern "C" int eu_resident_banded_nbr_##SUF(                                       \
      const eu::NbrLaunch* L, const T* x, const T* rows, int m, T* w,               \
      void* stream) {                                                               \
    return eu::launch_nbr<T, eu::NbrBanded>(*L, x, nullptr, rows, m, w, nullptr,    \
                                            (cudaStream_t)stream);                  \
  }

EU_FAMILY_API(float, f32)
EU_FAMILY_API(double, f64)

// Streaming multiprocessors of the current device (negative: a CUDA error).
extern "C" int eu_device_sms() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? sms : -(int)e;
}

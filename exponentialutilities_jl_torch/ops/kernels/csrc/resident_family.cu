// B4, B5 and B6: the (m, 4)-row recurrence of B1 with other per-row
// operators and p accumulators, each in ONE persistent cooperative launch;
// the neighbour form that B1, B4 and B5 take where it fits; and B6's own
// neighbour form over (z, y)-tiles of the grid.
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
// also keeps p accumulators where B5 and B6 keep one. The family kernel is
// one template over the per-row operator (the structs below), built as B1's
// grid form is (csrc/resident.cu): a co-resident grid sized by the
// occupancy API walks the vectors in L2 with grid-stride loops, and one
// cg::this_grid().sync() per step orders every write of omega_{k+1} before
// any read of it. A step costs that barrier (~1 us on the H100,
// sync_bench.cu) plus three vectors of L2 traffic.
//
// The neighbour forms drop the grid barrier, which a step does not need
// (a row of omega_{k+1} reads omega_k only within the stencil's reach), for
// flags between neighbouring blocks, and keep each block's state in shared
// memory for all m steps, so x is read once and w written once and only the
// halo rows (and B5's diagonals) cross L2 every step:
//   resident_nbr_kernel<T, Op> (B1, B5) and resident_multi_nbr_kernel<T>
//     (B4): blocks own runs of rows and wait for the blocks left and right;
//   resident_grid_nbr_kernel<T, K, R> (B6): blocks own tiles of whole
//     x-lines of the grid and wait for the tiles around them (a 3-D stencil
//     reaches a plane, nx ny rows, away: more than a block's share of rows
//     in row order, but one plane of a tile's neighbour).
// K4, B1's batched form, keeps its rows in registers and exchanges halos
// every few steps: csrc/resident_nbr_batched.cu.
// What bounds them on the H100: synchronisation (a neighbour's flag is
// ~0.9 us, sync_bench.cu) for B1, B4 and B6, HBM bandwidth for B5 in
// float64 at config #3 (its 40 MB of diagonals every step). The family
// kernel stays for what they cannot take: B4 past 8 columns, an offset
// wider than a block's rows (or tile), or a block state that does not fit.
// Both forms compute a row with the row functions of common.cuh
// (accumulate, stencil_term, next_row), so they give the same bits at any
// shape both take, and every result is bitwise repeatable (B1's sum of w^2
// in the neighbour form is summed in a fixed order).
#include <cooperative_groups.h>

#include <climits>
#include <cstddef>

#include "common.cuh"
#include "flags.cuh"

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
        acc = stencil_term(acc, c[j], x[i + flat[j]]);
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

constexpr int kNbrThreads = 1024;   // a block of the neighbour form
constexpr int kMaxCols = 8;         // p <= dispatch.MAX_COLS

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

// B6's neighbour form: resident_grid_nbr_kernel<T, K, R>. The grid's nz ny
// x-lines (a 2-D grid is one plane) are cut into tiles of tz planes by ty
// lines, whole lines each, and block b owns tile (b / tiles_y, b %
// tiles_y); the last tile along an axis may hold fewer. A block keeps on
// chip, for all m steps, two omega spans over its tile (omega_{k+1}
// written in place over omega_{k-1}, as in resident_nbr_kernel) and its
// accumulator rows. A span holds hz = max|dz| planes and hy = max|dy|
// lines of halo each side and hx = max|dx| zero columns at each end of a
// line; halo lines outside the grid stay zero, so a row sums its k points
// with no Dirichlet masks, and a point outside the grid adds c 0 (the
// family kernel skips it: the same value). Each thread owns the tile rows
// t + kNbrThreads i (i < R), their span indices fixed in registers at
// launch, and copies the halo rows t + kNbrThreads j (j < H) of a table of
// halo lines each step; R and H are 2 for tiles of up to 2048 rows and
// halo rows (fewer registers: no spills), else 8 and 4. Step k:
//   1. the edge rows (those a waiting neighbour reads: within hz planes of
//      a z face and hy lines of a y face toward it) first, each also
//      stored to the publication buffer of parity (k + 1) & 1, at its row
//      of its tile's slot;
//   2. after a block barrier thread 0 releases the block's flag = base +
//      k + 1 (st.release.gpu), and every thread computes its interior rows
//      while the flag travels; then lane 0 of warp d waits for the flag of
//      the neighbour in direction d (the tile at (+a, +b), d = 3 (a + 1) +
//      (b + 1)), for each direction of `dirs` whose tile exists;
//   3. after a block barrier every thread copies its halo rows from the
//      neighbours' slots (ld.global.cg, all loads in flight before the
//      stores) into the omega_{k+1} span; one more barrier, and the spans
//      swap.
// What bounds it on the H100: synchronisation. A step waits for a flag and
// then for the halo rows, two L2 round trips in a row, plus three block
// barriers: 1.7-1.9 us a step at 512^2 (128 tiles of 4 lines, 2 rows a
// thread), against 6.0 for the family kernel (PERF.md). With 8 rows a
// thread (1000^2) the rows' shared-memory traffic adds to it.
// `dirs` holds every direction a point reaches (the faces of a point's dz
// and dy, and the corner where both are nonzero) and its opposite, so a
// tile waits for every tile that reads it: no tile gets two steps ahead of
// a reader, and the parity buffers suffice as in the 1-D kernels (a tile
// publishes omega_{k+3} over omega_{k+1} only after each reader has set its
// flag for omega_{k+2}, which it does after it copied omega_{k+1}). Flags
// only grow, and the base is read on the card, as in resident_nbr_kernel.
struct GridLaunch {      // mirrored by resident._GridLaunch; one per plan and stream
  const void* coef;      // the k stencil coefficients, in the launch's dtype
  void* flags;           // grid unsigned 64-bit step counts kFlagStride apart, zero
                         // when made (neighbour form; the family form: null)
  void* pub;             // [2][grid][tz ty nx] rows the tiles publish, by parity
                         // (neighbour form)
  long long n;           // nz ny nx
  int nz, ny, nx;        // 2-D grids as nz = 1
  int tiles_z, tiles_y;  // the neighbour form's grid: tiles_z tiles_y blocks
  int tz, ty;            // planes and lines of a tile
  int hz, hy, hx;        // max |dz|, |dy|, |dx|: the spans' halo
  int dirs;              // bit 3 (a + 1) + (b + 1): wait for the tile at (+a, +b)
  int halo_lines;        // the most halo lines a tile copies (grid_halo_lines)
  int k;
  int dz[kMaxPoints], dy[kMaxPoints], dx[kMaxPoints];
};
static_assert(offsetof(GridLaunch, n) == 24 && offsetof(GridLaunch, nz) == 32 &&
                  offsetof(GridLaunch, tiles_z) == 44 && offsetof(GridLaunch, tz) == 52 &&
                  offsetof(GridLaunch, hz) == 60 && offsetof(GridLaunch, hx) == 68 &&
                  offsetof(GridLaunch, dirs) == 72 && offsetof(GridLaunch, halo_lines) == 76 &&
                  offsetof(GridLaunch, k) == 80 && offsetof(GridLaunch, dz) == 84 &&
                  offsetof(GridLaunch, dy) == 340 && offsetof(GridLaunch, dx) == 596 &&
                  sizeof(GridLaunch) == 856,
              "GridLaunch layout is mirrored by resident._GridLaunch");

constexpr int kGridRows = 8;   // tile rows a thread owns at most (tz ty nx <= 8192)
constexpr int kGridHalo = 4;   // halo rows a thread copies at most (4096 a tile)
constexpr int kGridSmall = 2;  // both, in the kernels for tiles of up to 2048

// Dynamic shared memory of one block: the halo-line table (an int4 a
// line), two omega spans of (tz + 2 hz) (ty + 2 hy) lines of nx + 2 hx
// values, and the tile's tz ty nx accumulator rows.
inline size_t grid_nbr_smem(const GridLaunch& L, size_t itemsize) {
  return 16 * (size_t)L.halo_lines +
         (2 * (size_t)(L.tz + 2 * L.hz) * (L.ty + 2 * L.hy) * (L.nx + 2 * L.hx) +
          (size_t)L.tz * L.ty * L.nx) *
             itemsize;
}

// One thread's walk over the rows of a box of `lines` lines a plane and
// `cols` columns, kNbrThreads rows a stride, in row-major order: the start
// costs three divisions, each stride adds constants.
struct LineWalk {
  int z, y, x;        // the row's plane, line and column in the box
  int sz, sy, sx;     // a stride: sz planes, sy lines, sx columns
  int lines, cols;
  __device__ LineWalk(int t, int lines_, int cols_) : lines(lines_), cols(cols_) {
    const int l = t / cols, sl = kNbrThreads / cols;
    x = t - l * cols;
    z = l / lines;
    y = l - z * lines;
    sx = kNbrThreads - sl * cols;
    sz = sl / lines;
    sy = sl - sz * lines;
  }
  __device__ __forceinline__ void next() {
    x += sx;
    y += sy;
    z += sz;
    if (x >= cols) {
      x -= cols;
      ++y;
    }
    if (y >= lines) {
      y -= lines;
      ++z;
    }
  }
};

// K > 0: a stencil of exactly K points (the loop over them unrolled); 0:
// any k. R: tile rows a thread owns at most (kGridRows or kGridSmall).
template <typename T, int K, int R>
__global__ void __launch_bounds__(kNbrThreads, 1)
resident_grid_nbr_kernel(const T* __restrict__ x, const T* __restrict__ rows,
                         const __grid_constant__ GridLaunch L, int m, T* __restrict__ w) {
  constexpr int H = R == kGridSmall ? kGridSmall : kGridHalo;   // halo rows a thread
  extern __shared__ __align__(16) unsigned char smem_grid[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int so_sh[kMaxPoints];        // point j's offset in a span
  __shared__ T coef[2][4];                 // a step's ca, cb, cc, cw, by parity
  __shared__ unsigned long long base_sh;   // the flags' count when the launch started
  __shared__ int count_sh[kNbrThreads / 32];
  __shared__ unsigned edge_sh;             // bit c: a row with faces c is an edge row
  const int t = threadIdx.x, b = blockIdx.x, warp = t >> 5, lane = t & 31;
  const int k = K > 0 ? K : L.k;
  const int nz = L.nz, ny = L.ny, nx = L.nx, hz = L.hz, hy = L.hy, hx = L.hx;
  const int nxp = nx + 2 * hx;                  // a span line
  const int sy = L.ty + 2 * hy;                 // lines of a span plane
  const int span = (L.tz + 2 * hz) * sy * nxp;
  const int stride = L.tz * L.ty * nx;          // a tile's slot in the publication buffer
  const int bz = b / L.tiles_y, by = b - bz * L.tiles_y;
  const int z0 = bz * L.tz, y0 = by * L.ty;
  const int tzl = min(L.tz, nz - z0), tyl = min(L.ty, ny - y0);   // this tile's planes, lines
  const int rows_here = tzl * tyl * nx;
  const int row0 = (z0 * ny + y0) * nx;         // the tile's first grid row
  int4* table = reinterpret_cast<int4*>(smem_grid);   // halo line: span index of its
                                                      // column 0, its row in the source
                                                      // tile's slot, its grid row
  T* wc = reinterpret_cast<T*>(table + L.halo_lines);   // omega_k; tile row (z, y, c) at
                                                         // ((z + hz) sy + y + hy) nxp + hx + c
  T* wp = wc + span;                                     // omega_{k-1}, then omega_{k+1}
  T* acc = wp + span;                                    // acc[r]: w of the tile's row r
  T* pub = static_cast<T*>(L.pub);
  const size_t slots = (size_t)L.tiles_z * L.tiles_y * stride;   // one parity's buffer
  unsigned long long* flags = static_cast<unsigned long long*>(L.flags);
  const int fetcher = t - (kNbrThreads - 32);   // lane l < 4 of the last warp fetches scalar l

  for (int j = t; j < k; j += kNbrThreads) {
    c_sh[j] = static_cast<const T*>(L.coef)[j];
    so_sh[j] = (L.dz[j] * sy + L.dy[j]) * nxp + L.dx[j];
  }
  for (int i = t; i < 2 * span; i += kNbrThreads) wc[i] = T(0);   // and wp: zero halos
  for (int i = t; i < rows_here; i += kNbrThreads) acc[i] = T(0);
  if (fetcher >= 0 && fetcher < 4) coef[0][fetcher] = m > 0 ? rows[fetcher] : T(0);
  unsigned long long* own = flags + (size_t)b * kFlagStride;
  if (t == 0) base_sh = load_acquire(own);
  // the neighbours this tile waits for, by direction bit
  int nb = 0;
  for (int d = 0; d < 9; ++d) {
    const int qz = bz + d / 3 - 1, qy = by + d % 3 - 1;
    if (d != 4 && (L.dirs >> d & 1) && qz >= 0 && qz < L.tiles_z && qy >= 0 && qy < L.tiles_y)
      nb |= 1 << d;
  }
  // bit c of edge_sh: a row whose faces c = [z < hz] | [z >= tzl - hz] << 1
  // | [y < hy] << 2 | [y >= tyl - hy] << 3 lies within the reach of a
  // waiting neighbour (lane c of warp 0 decides it)
  if (warp == 0) {
    bool ed = false;
    for (int d = 0; d < 9 && lane < 16; ++d) {
      const int a = d / 3 - 1, c = d % 3 - 1;
      ed |= (nb >> d & 1) && (a == 0 || (lane & (a < 0 ? 1 : 2))) &&
            (c == 0 || (lane & (c < 0 ? 4 : 8)));
    }
    const unsigned lut = __ballot_sync(0xffffffffu, ed);
    if (lane == 0) edge_sh = lut;
  }

  // the halo-line table: the span's lines outside the tile, in the grid,
  // toward a neighbour of nb, in span order (a block-wide compaction)
  const int box_lines = tyl + 2 * hy, span_lines = (tzl + 2 * hz) * box_lines;
  int nlines = 0;
  for (int l0 = 0; l0 < span_lines; l0 += kNbrThreads) {
    const int l = l0 + t;
    bool pick = false;
    int4 e{};
    if (l < span_lines) {
      const int pz = l / box_lines, lz = pz - hz, ly = l - pz * box_lines - hy;
      const int a = lz < 0 ? 0 : lz < tzl ? 1 : 2, c = ly < 0 ? 0 : ly < tyl ? 1 : 2;
      const int gz = z0 + lz, gy = y0 + ly;
      pick = (nb >> (3 * a + c) & 1) && gz >= 0 && gz < nz && gy >= 0 && gy < ny;
      if (pick) {   // the source tile, and the line's row in its slot
        const int sz0 = (bz + a - 1) * L.tz, sy0 = (by + c - 1) * L.ty;
        const int styl = min(L.ty, ny - sy0);
        e.x = ((lz + hz) * sy + ly + hy) * nxp + hx;
        e.y = (b + (a - 1) * L.tiles_y + c - 1) * stride + ((gz - sz0) * styl + gy - sy0) * nx;
        e.z = (gz * ny + gy) * nx;
      }
    }
    const unsigned ball = __ballot_sync(0xffffffffu, pick);
    if (lane == 0) count_sh[warp] = __popc(ball);
    __syncthreads();
    int at = nlines + __popc(ball & ((1u << lane) - 1)), total = 0;
    for (int v = 0; v < kNbrThreads / 32; ++v) {
      at += v < warp ? count_sh[v] : 0;
      total += count_sh[v];
    }
    if (pick && at < L.halo_lines) table[at] = e;
    nlines += total;
    __syncthreads();
  }
  if (nlines > L.halo_lines) __trap();   // the host's count is the table's room

  // this thread's tile rows r = t + kNbrThreads i (span index, and which
  // are edge rows) and halo rows t + kNbrThreads j (span index, source);
  // omega_0 = x on both
  int srow[R], hdst[H], hsrc[H];
  unsigned edge = 0;
  const unsigned lut = edge_sh;   // written before the table's barriers
  const int nrows = t < rows_here ? (rows_here - t + kNbrThreads - 1) / kNbrThreads : 0;
  const int nhalo = t < nlines * nx ? (nlines * nx - t + kNbrThreads - 1) / kNbrThreads : 0;
  {
    LineWalk q(t, tyl, nx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      srow[i] = ((q.z + hz) * sy + q.y + hy) * nxp + hx + q.x;
      if (i < nrows) {
        const int c = (q.z < hz) | (q.z >= tzl - hz) << 1 | (q.y < hy) << 2 |
                      (q.y >= tyl - hy) << 3;
        edge |= (lut >> c & 1) << i;
        wc[srow[i]] = __ldg(x + row0 + (q.z * ny + q.y) * nx + q.x);
      }
      q.next();
    }
  }
#pragma unroll
  for (int j = 0; j < H; ++j) {
    hdst[j] = hsrc[j] = 0;
    if (j < nhalo) {
      const int f = t + j * kNbrThreads, line = f / nx, c = f - line * nx;
      const int4 e = table[line];
      hdst[j] = e.x + c;
      hsrc[j] = e.y + c;
      wc[hdst[j]] = __ldg(x + e.z + c);
    }
  }
  __syncthreads();
  const unsigned long long base = base_sh;

  for (int step = 0; step < m; ++step) {
    const T* cf = coef[step & 1];
    // the next step's scalars land while this step runs
    const T next = fetcher >= 0 && fetcher < 4 && step + 1 < m ? rows[4 * (step + 1) + fetcher]
                                                               : T(0);
    const T ca = cf[0], cb = cf[1], cc = cf[2], cw = cf[3];
    if (step + 1 == m) {   // omega_m is never accumulated: w only
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < nrows) {
          const int r = t + i * kNbrThreads;
          acc[r] = accumulate(acc[r], cw, wc[srow[i]]);
        }
      break;
    }
    // one row: w += cw omega_k, then omega_{k+1} (no masks: zero halos)
    auto row = [&](int s, int r) {
      const T v = wc[s];
      acc[r] = accumulate(acc[r], cw, v);
      T z = T(0);
      if (K > 0) {
#pragma unroll
        for (int j = 0; j < (K > 0 ? K : 1); ++j) z = stencil_term(z, c_sh[j], wc[s + so_sh[j]]);
      } else {
        for (int j = 0; j < k; ++j) z = stencil_term(z, c_sh[j], wc[s + so_sh[j]]);
      }
      const T wn = next_row(ca, cb, cc, z, v, wp[s]);
      wp[s] = wn;
      return wn;
    };
    const int par = (step + 1) & 1;
    T* out = pub + par * slots;
    T* mine = out + (size_t)b * stride;
#pragma unroll
    for (int i = 0; i < R; ++i)   // the edge rows first, published
      if (edge >> i & 1) mine[t + i * kNbrThreads] = row(srow[i], t + i * kNbrThreads);
    __syncthreads();   // the edges are written
    // the release orders the block's edge stores (before the barrier)
    // ahead of the flag for any thread that acquires it
    const unsigned long long want = base + (unsigned long long)(step + 1);
    if (t == 0) store_release(own, want);
#pragma unroll
    for (int i = 0; i < R; ++i)   // the interior rows while the flag travels
      if (i < nrows && !(edge >> i & 1)) row(srow[i], t + i * kNbrThreads);
    if (lane == 0 && warp < 9 && (nb >> warp & 1))
      wait_flag(flags + (size_t)(b + (warp / 3 - 1) * L.tiles_y + warp % 3 - 1) * kFlagStride,
                want);
    if (fetcher >= 0 && fetcher < 4) coef[par][fetcher] = next;
    __syncthreads();   // the flags were acquired before this barrier
    T hv[H];   // the halo rows of omega_{k+1}: every load, then every store
#pragma unroll
    for (int j = 0; j < H; ++j)
      if (j < nhalo) hv[j] = __ldcg(out + hsrc[j]);
#pragma unroll
    for (int j = 0; j < H; ++j)
      if (j < nhalo) wp[hdst[j]] = hv[j];
    __syncthreads();
    T* tmp = wp;
    wp = wc;
    wc = tmp;
  }
  LineWalk q(t, tyl, nx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < nrows) w[row0 + (q.z * ny + q.y) * nx + q.x] = acc[t + i * kNbrThreads];
    q.next();
  }
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

template <typename T, int K, int R>
static cudaError_t allow_grid_nbr_smem(size_t bytes) {
  static size_t allowed = 0;
  return allow_smem((const void*)resident_grid_nbr_kernel<T, K, R>, bytes, &allowed);
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

// kind 0: B4's kernel; 1: B1's (NbrStencil); 2: B5's (NbrBanded); 3: B6's
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
    case 3:
      return nbr_capacity((const void*)resident_grid_nbr_kernel<T, 0, kGridRows>,
                          allow_grid_nbr_smem<T, 0, kGridRows>, smem);
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

// B6's directions to wait for: each point's faces and corner (bit 3 (a +
// 1) + (b + 1) for the tile at (+a, +b)) and their opposites.
inline int grid_dirs(const GridLaunch& L) {
  int dirs = 0;
  for (int j = 0; j < L.k; ++j) {
    const int a = (L.dz[j] > 0) - (L.dz[j] < 0), e = (L.dy[j] > 0) - (L.dy[j] < 0);
    for (int sgn = -1; sgn <= 1; sgn += 2)
      for (int u = 0; u <= 1; ++u)
        for (int v = 0; v <= 1; ++v) {
          const int aa = sgn * u * a, ee = sgn * v * e;
          if (aa != 0 || ee != 0) dirs |= 1 << (3 * (aa + 1) + ee + 1);
        }
  }
  return dirs;
}

inline bool grid_valid(const GridLaunch& L) {
  return L.k >= 1 && L.k <= kMaxPoints && L.nz >= 1 && L.ny >= 1 && L.nx >= 1 &&
         L.n == (long long)L.nz * L.ny * L.nx && L.coef != nullptr;
}

// The most halo lines a tile copies: for each direction of dirs along
// which the grid has more than one tile, the tile's face (or corner) of
// halo lines; a ragged tile or neighbour copies fewer.
inline int grid_halo_lines(const GridLaunch& L) {
  int lines = 0;
  for (int d = 0; d < 9; ++d) {
    const int a = d / 3 - 1, c = d % 3 - 1;
    if (d == 4 || !(L.dirs >> d & 1) || (a != 0 && L.tiles_z < 2) || (c != 0 && L.tiles_y < 2))
      continue;
    lines += (a == 0 ? L.tz : L.hz) * (c == 0 ? L.ty : L.hy);
  }
  return lines;
}

// The neighbour form's tiles cover the grid; the spans' halo is the
// stencil's reach, and along an axis cut into several tiles no more than a
// tile's extent (so a halo lies in the next tile); a thread's rows and halo
// rows fit its registers; indices fit an int.
inline bool grid_nbr_valid(const GridLaunch& L) {
  if (!grid_valid(L) || L.tz < 1 || L.ty < 1 ||
      L.tiles_z != (L.nz + L.tz - 1) / L.tz || L.tiles_y != (L.ny + L.ty - 1) / L.ty ||
      L.dirs != grid_dirs(L) || L.halo_lines != grid_halo_lines(L) ||
      (L.tiles_z > 1 && L.hz > L.tz) || (L.tiles_y > 1 && L.hy > L.ty) ||
      (long long)L.tz * L.ty * L.nx > kGridRows * kNbrThreads ||
      (long long)L.halo_lines * L.nx > kGridHalo * kNbrThreads ||
      (long long)L.tiles_z * L.tiles_y * L.tz * L.ty * L.nx > INT_MAX || L.n > INT_MAX ||
      L.flags == nullptr || L.pub == nullptr)
    return false;
  int rz = 0, ry = 0, rx = 0;
  for (int j = 0; j < L.k; ++j) {
    const int az = L.dz[j] < 0 ? -L.dz[j] : L.dz[j], ay = L.dy[j] < 0 ? -L.dy[j] : L.dy[j],
              ax = L.dx[j] < 0 ? -L.dx[j] : L.dx[j];
    rz = az > rz ? az : rz;
    ry = ay > ry ? ay : ry;
    rx = ax > rx ? ax : rx;
  }
  return L.hz == rz && L.hy == ry && L.hx == rx;
}

template <typename T, int K, int R>
int launch_grid_nbr_kr(const GridLaunch& L, const T* x, const T* rows, int m, T* w,
                       cudaStream_t stream) {
  const size_t smem = grid_nbr_smem(L, sizeof(T));
  cudaError_t e = allow_grid_nbr_smem<T, K, R>(smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&x, (void*)&rows, (void*)&L, (void*)&m, (void*)&w};
  e = cudaLaunchCooperativeKernel((const void*)resident_grid_nbr_kernel<T, K, R>,
                                  dim3(L.tiles_z * L.tiles_y), dim3(kNbrThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_grid_nbr_k(const GridLaunch& L, const T* x, const T* rows, int m, T* w,
                      cudaStream_t stream) {
  const int small = kGridSmall * kNbrThreads;
  if (L.tz * L.ty * L.nx <= small && L.halo_lines * L.nx <= small)
    return launch_grid_nbr_kr<T, K, kGridSmall>(L, x, rows, m, w, stream);
  return launch_grid_nbr_kr<T, K, kGridRows>(L, x, rows, m, w, stream);
}

// B6's neighbour form: one block per tile. The 5-, 7- and 27-point
// stencils take kernels with their point loop unrolled (on the H100 0.1-
// 1.4 us a step faster than the kernel for any k at 512^2, 1000^2 and 64^3,
// PERF.md), and tiles of up to 2048 rows and halo rows one whose threads
// keep 2 of each (at 512^2 and 64^3 0.3-1.3 us a step faster than with 8
// and 4, which spill registers).
template <typename T>
int launch_grid_nbr(const GridLaunch& L, const T* x, const T* rows, int m, T* w,
                    cudaStream_t stream) {
  if (!grid_nbr_valid(L) || m < 0) return (int)cudaErrorInvalidValue;
  switch (L.k) {
    case 5:
      return launch_grid_nbr_k<T, 5>(L, x, rows, m, w, stream);
    case 7:
      return launch_grid_nbr_k<T, 7>(L, x, rows, m, w, stream);
    case 27:
      return launch_grid_nbr_k<T, 27>(L, x, rows, m, w, stream);
  }
  return launch_grid_nbr_k<T, 0>(L, x, rows, m, w, stream);
}

// B6's family form: one accumulator, the coefficients and offsets of the
// descriptor, buf 3n scratch values.
template <typename T>
int launch_grid(const GridLaunch& L, const T* x, const T* rows, int m, T* w, T* buf,
                cudaStream_t stream) {
  if (!grid_valid(L)) return (int)cudaErrorInvalidValue;
  Grid3D<T> op{};
  op.offs.k = L.k;
  for (int j = 0; j < L.k; ++j) {
    op.offs.dz[j] = L.dz[j];
    op.offs.dy[j] = L.dy[j];
    op.offs.dx[j] = L.dx[j];
    op.flat[j] = ((long long)L.dz[j] * L.ny + L.dy[j]) * L.nx + L.dx[j];
  }
  op.cvals = static_cast<const T*>(L.coef);
  op.nz = L.nz;
  op.ny = L.ny;
  op.nx = L.nx;
  return launch_family<T>(x, rows, rows + 3, 4, 1, op, L.n, m, w, buf, stream);
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
      const eu::GridLaunch* L, const T* x, const T* rows, int m, T* w, T* buf,      \
      void* stream) {                                                               \
    return eu::launch_grid<T>(*L, x, rows, m, w, buf, (cudaStream_t)stream);        \
  }                                                                                 \
  extern "C" int eu_resident_grid_nbr_##SUF(                                         \
      const eu::GridLaunch* L, const T* x, const T* rows, int m, T* w,              \
      void* stream) {                                                               \
    return eu::launch_grid_nbr<T>(*L, x, rows, m, w, (cudaStream_t)stream);         \
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

// K4, B1's batched form (pass 2 of expv_batched's 1-D two-pass, each row
// with its own replay rows, scale and sum w^2): the (m, 4)-row recurrence
//   omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
//   w += cw_k omega_k,   omega_0 = s x,   omega_{-1} = 0
// of a 1-D constant stencil with Dirichlet ends, for R rows of the batch in
// ONE cooperative launch of R x grid blocks (block q is block q % grid of
// row q / grid).
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_kernel  (B1, resident.py:89) under JAX's vmap
//
// B1's neighbour form (csrc/resident_family.cu) keeps a block's rows in
// shared memory and pays two block barriers and a neighbour flag every
// step. Batched over 8 rows a block owns ~6250 rows (the SMs split among
// the rows), and a step read and wrote the block's whole state in shared
// memory (~56 bytes a row, ~350 KB a step an SM): 3.07 us a step against
// B1's 1.76. Here:
//  * the rows live in registers: thread t keeps J consecutive rows of
//    omega_k, omega_{k-1} and w (J = 13 at 512 threads in float64: three
//    vectors and the stencil's sums take the 128 registers a thread has at
//    one 512-thread block an SM, a few values spilled; 1024 threads would
//    leave 64, too few for the sums). A row's stencil reads its own
//    thread's registers; the h rows past each end come from the
//    neighbouring lanes by shuffles and from the neighbouring warps
//    through a small shared edge array, so a step moves ~4h values a
//    thread through shared memory and pays ONE block barrier;
//  * temporal blocking: a block holds its rows plus s h halo rows each
//    side and advances s steps per neighbour exchange, computing the halo
//    rows redundantly (after step j of an exchange, rows within (s - j) h
//    of the span's ends are stale and never read by an owned row). At an
//    exchange it publishes omega_T and omega_{T-1} of its first and last
//    s h rows, releases its flag and reads its neighbours' into its halo
//    rows: the flag and its barrier are paid once every s steps.
// The stencil's offsets are runtime data: each point's offset selects, by
// a switch that every thread takes alike, an unrolled pass over the
// thread's rows with compile-time register indices. Every element goes
// through common.cuh's accumulate, stencil_term and next_row in B1's
// order, halo rows included, so w is bit for bit B1's on each row; sum w^2
// sums the blocks' partials in another grouping than B1 (PERF.md states the
// tolerance).
//
// What bounds it on the H100: the float64 arithmetic of a step (~7
// operations a row for a 3-point stencil, ~6250 rows an SM at 8 rows of
// 1e5), then the block barrier a step and a flag every s steps.
#include <cstddef>
#include <utility>

#include "common.cuh"
#include "flags.cuh"

namespace eu {

constexpr int kRowsThreads = 512;   // a block of K4 at most
constexpr unsigned kAllLanes = 0xffffffffu;

struct RowsLaunch {     // mirrored by resident._RowsLaunch; one per plan and stream
  const void* coef;     // the k stencil coefficients, in the launch's dtype
  void* flags;          // rows x grid unsigned 64-bit counts kFlagStride apart,
                        // zero when made
  void* halo;           // [2][rows x grid][2 sides][2: omega_T, omega_{T-1}][s h]
  void* partials;       // rows x grid values: the blocks' sums of w^2
  void* ticket;         // one unsigned 64-bit count a row, zero when made
  long long n;
  int grid;             // blocks a row
  int chunk;            // rows a block owns (the last block may own fewer)
  int h;                // max |o|
  int k;
  int s;                // steps a halo exchange; s h <= chunk
  int threads;          // a multiple of 32; threads x J >= chunk + 2 s h
  int per_thread;       // J, rows a thread: picks the instantiation
  int o[kMaxPoints];
};
static_assert(offsetof(RowsLaunch, n) == 40 && offsetof(RowsLaunch, grid) == 48 &&
                  offsetof(RowsLaunch, s) == 64 && offsetof(RowsLaunch, per_thread) == 72 &&
                  offsetof(RowsLaunch, o) == 76 && sizeof(RowsLaunch) == 336,
              "RowsLaunch layout is mirrored by resident._RowsLaunch");

// z[R] += c omega_k(row R + D) for the thread's row R: its own register,
// or a neighbouring thread's edge row (lf: the H rows before the thread's
// first, rt: the H rows after its last). Masked rows skip the points
// outside [0, n), as B1's edge rows do.
template <typename T, int J, int H, bool kMask, int D, int R>
__device__ __forceinline__ void add_point(T (&z)[J], const T (&cur)[J], const T (&lf)[H],
                                          const T (&rt)[H], T c, long long g0, long long n) {
  constexpr int e = R + D;
  T x;
  if constexpr (e < 0) {
    x = lf[H + e];
  } else if constexpr (e >= J) {
    x = rt[e - J];
  } else {
    x = cur[e];
  }
  if (kMask && (g0 + e < 0 || g0 + e >= n)) return;
  z[R] = stencil_term(z[R], c, x);
}

// omega_{k+1} of the thread's row R from its stencil sum z[R], into nxt[R]
// (which held omega_{k-1}); a row outside [0, n) stays zero.
template <typename T, int J, bool kMask, int R>
__device__ __forceinline__ void next_point(T (&nxt)[J], const T (&cur)[J], const T (&z)[J],
                                           T ca, T cb, T cc, long long g0, long long n) {
  if (kMask && (g0 + R < 0 || g0 + R >= n)) return;
  nxt[R] = next_row(ca, cb, cc, z[R], cur[R], nxt[R]);
}

// omega_{k+1} of the thread's J rows (I... = 0 .. J - 1) into nxt, one
// offset switch a point and step for all of them (two groups of rows, a
// switch each, spilled less but took longer on the H100).
template <typename T, int J, int H, bool kMask, int... I>
__device__ __forceinline__ void rows_next(std::integer_sequence<int, I...>, T (&nxt)[J],
                                          const T (&cur)[J], const T (&lf)[H], const T (&rt)[H],
                                          const T* c_sh, const int* o_sh, int k, T ca, T cb,
                                          T cc, long long g0, long long n) {
  T z[J];
#pragma unroll
  for (int i = 0; i < J; ++i) z[i] = T(0);
  for (int j = 0; j < k; ++j) {
    const T c = c_sh[j];
    switch (o_sh[j]) {   // the same offset in every thread: no divergence
      case -2:
        if constexpr (H >= 2) (add_point<T, J, H, kMask, -2, I>(z, cur, lf, rt, c, g0, n), ...);
        break;
      case -1:
        (add_point<T, J, H, kMask, -1, I>(z, cur, lf, rt, c, g0, n), ...);
        break;
      case 0:
        (add_point<T, J, H, kMask, 0, I>(z, cur, lf, rt, c, g0, n), ...);
        break;
      case 1:
        (add_point<T, J, H, kMask, 1, I>(z, cur, lf, rt, c, g0, n), ...);
        break;
      case 2:
        if constexpr (H >= 2) (add_point<T, J, H, kMask, 2, I>(z, cur, lf, rt, c, g0, n), ...);
        break;
      default:
        break;
    }
  }
  (next_point<T, J, kMask, I>(nxt, cur, z, ca, cb, cc, g0, n), ...);
}

// What a block of the kernel shares between its steps.
template <typename T, int H>
struct RowsBlock {
  const T* c_sh;
  const int* o_sh;
  T (*coef)[4];                         // [parity][ca, cb, cc, cw]
  T (*edge)[kRowsThreads / 32][2][H];   // [parity][warp][first, last][H]
  const T* rows;                        // the row's (m, 4) scalars
  T* halo;
  unsigned long long* own;              // this block's flag
  unsigned long long base;              // its count when the launch started
  unsigned long long exchanges;         // done in this launch
  T pend;                               // threads 0-3: scalar t of the next step
  long long n, g0;                      // g0: row of the thread's first register
  int m, k, s, sh, len, e0, q, nq, b, grid, t, lane, warp, nw;
  bool inner;                           // no row of the thread near [0, n)'s ends
};

// Step k on (cur = omega_k, nxt = omega_{k-1}): w += cw omega_k, then
// omega_{k+1} into nxt, and a halo exchange where one is due. False after
// the last step (omega_m is never accumulated).
template <typename T, int J, int H>
__device__ __forceinline__ bool rows_step(RowsBlock<T, H>& B, T (&cur)[J], T (&nxt)[J],
                                          T (&a)[J], int step) {
  const T* cf = B.coef[step & 1];
  const T ca = cf[0], cb = cf[1], cc = cf[2], cw = cf[3];
#pragma unroll
  for (int i = 0; i < J; ++i) a[i] = accumulate(a[i], cw, cur[i]);
  if (step + 1 == B.m) return false;
  const int par = step & 1;
  if (B.lane == 0)
#pragma unroll
    for (int i = 0; i < H; ++i) B.edge[par][B.warp][0][i] = cur[i];
  if (B.lane == 31)
#pragma unroll
    for (int i = 0; i < H; ++i) B.edge[par][B.warp][1][i] = cur[J - H + i];
  T lf[H], rt[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    lf[i] = __shfl_up_sync(kAllLanes, cur[J - H + i], 1);
    rt[i] = __shfl_down_sync(kAllLanes, cur[i], 1);
  }
  if (B.t < 4) {   // the next step's scalars, fetched a step ago; fetch the one after
    B.coef[par ^ 1][B.t] = B.pend;
    B.pend = step + 2 < B.m ? B.rows[4 * (step + 2) + B.t] : T(0);
  }
  __syncthreads();   // the warps' edges and the next scalars are written
  if (B.lane == 0)
#pragma unroll
    for (int i = 0; i < H; ++i) lf[i] = B.warp > 0 ? B.edge[par][B.warp - 1][1][i] : T(0);
  if (B.lane == 31)
#pragma unroll
    for (int i = 0; i < H; ++i) rt[i] = B.warp + 1 < B.nw ? B.edge[par][B.warp + 1][0][i] : T(0);
  constexpr auto rows = std::make_integer_sequence<int, J>{};
  if (B.inner)
    rows_next<T, J, H, false>(rows, nxt, cur, lf, rt, B.c_sh, B.o_sh, B.k, ca, cb, cc, B.g0, B.n);
  else
    rows_next<T, J, H, true>(rows, nxt, cur, lf, rt, B.c_sh, B.o_sh, B.k, ca, cb, cc, B.g0, B.n);
  const int done = step + 1;   // omega_done is in nxt, omega_{done - 1} in cur
  if (B.sh == 0 || done % B.s != 0 || done + 1 >= B.m) return true;
  // the exchange: the first and last s h owned rows (span [sh, 2 sh) and
  // [len, len + sh)) of omega_done and omega_{done - 1} into the slot of
  // parity exchanges & 1, then the flag; the halo rows (span [0, sh) and
  // [sh + len, 2 sh + len)) from the neighbours' slots
  const int sh = B.sh;
  const size_t epar = (size_t)(B.exchanges & 1);
  T* slot = B.halo + (epar * B.nq + B.q) * 4 * sh;   // [side][omega_T, omega_{T-1}][sh]
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int e = B.e0 + i;
    if (e >= sh && e < 2 * sh) {
      slot[e - sh] = nxt[i];
      slot[sh + e - sh] = cur[i];
    }
    if (e >= B.len && e < B.len + sh) {
      slot[2 * sh + e - B.len] = nxt[i];
      slot[3 * sh + e - B.len] = cur[i];
    }
  }
  __syncthreads();   // the edges are written
  // the release orders the block's edge stores (before the barrier) ahead
  // of the flag for any thread that acquires it
  const unsigned long long want = B.base + ++B.exchanges;
  if (B.t == 0) store_release(B.own, want);
  if (B.b > 0 && B.e0 < sh) {   // left halo rows: the left block's last s h
    wait_flag(B.own - kFlagStride, want);
    const T* src = B.halo + (epar * B.nq + B.q - 1) * 4 * sh + 2 * sh;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int e = B.e0 + i;
      if (e < sh) {
        nxt[i] = __ldcg(src + e);
        cur[i] = __ldcg(src + sh + e);
      }
    }
  }
  if (B.b + 1 < B.grid && B.e0 + J > sh + B.len && B.e0 < 2 * sh + B.len) {   // right halo rows
    wait_flag(B.own + kFlagStride, want);
    const T* src = B.halo + (epar * B.nq + B.q + 1) * 4 * sh;
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int j = B.e0 + i - sh - B.len;
      if (j >= 0 && j < sh) {
        nxt[i] = __ldcg(src + j);
        cur[i] = __ldcg(src + sh + j);
      }
    }
  }
  return true;
}

template <typename T, int J, int H>
__global__ void __launch_bounds__(kRowsThreads, 1)
resident_nbr_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                         const T* __restrict__ rows, const __grid_constant__ RowsLaunch L, int m,
                         T* __restrict__ w, T* __restrict__ nrm2) {
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T coef[2][4];
  __shared__ T edge[2][kRowsThreads / 32][2][H];
  __shared__ T red[kRowsThreads / 32];
  __shared__ unsigned long long base_sh;
  __shared__ int last_sh;
  RowsBlock<T, H> B;
  B.q = blockIdx.x;
  B.nq = gridDim.x;
  const int r = B.q / L.grid;
  B.b = B.q - r * L.grid;
  B.grid = L.grid;
  B.t = threadIdx.x;
  B.lane = B.t & 31;
  B.warp = B.t >> 5;
  B.nw = blockDim.x >> 5;
  B.m = m;
  B.k = L.k;
  B.s = L.s;
  B.sh = L.s * L.h;
  B.n = L.n;
  const long long lo = (long long)B.b * L.chunk;
  B.len = (int)(B.n - lo < L.chunk ? B.n - lo : L.chunk);
  B.e0 = B.t * J;
  B.g0 = lo - B.sh + B.e0;
  B.inner = B.g0 >= H && B.g0 + J + H <= B.n;
  B.c_sh = c_sh;
  B.o_sh = o_sh;
  B.coef = coef;
  B.edge = edge;
  B.halo = static_cast<T*>(L.halo);
  B.exchanges = 0;
  x += r * B.n;
  w += r * B.n;
  rows += (long long)r * 4 * m;
  B.rows = rows;
  const T* coefs = static_cast<const T*>(L.coef);
  for (int j = B.t; j < L.k; j += blockDim.x) {
    c_sh[j] = coefs[j];
    o_sh[j] = L.o[j];
  }
  if (B.t < 4) coef[0][B.t] = m > 0 ? rows[B.t] : T(0);
  B.pend = B.t < 4 && m > 1 ? rows[4 + B.t] : T(0);
  const T s0 = scale[r];
  T va[J], vb[J], a[J];   // omega_k and omega_{k-1} by turns, w
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const long long g = B.g0 + i;
    va[i] = g >= 0 && g < B.n ? s0 * x[g] : T(0);
    vb[i] = T(0);
    a[i] = T(0);
  }
  B.own = static_cast<unsigned long long*>(L.flags) + (size_t)B.q * kFlagStride;
  if (B.t == 0) base_sh = load_acquire(B.own);
  __syncthreads();
  B.base = base_sh;
  for (int step = 0; step < m; step += 2) {
    if (!rows_step<T, J, H>(B, va, vb, a, step)) break;
    if (step + 1 < m && !rows_step<T, J, H>(B, vb, va, a, step + 1)) break;
  }
  // w of the owned rows (span [sh, sh + len)) and their sum of w^2; the
  // last block of the row sums the row's partials in block order
  T sq = T(0);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int e = B.e0 + i;
    if (e >= B.sh && e < B.sh + B.len) {
      w[lo + e - B.sh] = a[i];
      sq = fma_rn(a[i], a[i], sq);
    }
  }
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(kAllLanes, sq, off);
  if (B.lane == 0) red[B.warp] = sq;
  __syncthreads();
  if (B.warp == 0) {
    sq = B.lane < B.nw ? red[B.lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(kAllLanes, sq, off);
  }
  T* partials = static_cast<T*>(L.partials) + (size_t)r * L.grid;
  if (B.t == 0) {
    partials[B.b] = sq;
    __threadfence();   // the partial is visible before the ticket is
    const unsigned long long done =
        atomicAdd(static_cast<unsigned long long*>(L.ticket) + r, 1ull) + 1;
    last_sh = done % (unsigned long long)L.grid == 0;
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  if (B.warp != 0) return;
  T tot = T(0);
  for (int p = B.lane; p < L.grid; p += 32) tot += __ldcg(partials + p);
  for (int off = 16; off > 0; off >>= 1) tot += __shfl_down_sync(kAllLanes, tot, off);
  if (B.t == 0) nrm2[r] = tot;
}

inline bool rows_valid(const RowsLaunch& L) {
  if (L.k < 1 || L.k > kMaxPoints || L.n < 1 || L.grid < 1 || L.chunk < 1 || L.h < 0 ||
      L.h > 2 || L.s < 1 || (long long)L.s * L.h > L.chunk || L.threads < 32 ||
      L.threads > kRowsThreads || L.threads % 32 != 0 ||
      (L.per_thread != 4 && L.per_thread != 8 && L.per_thread != 13) ||
      (long long)L.threads * L.per_thread < (long long)L.chunk + 2LL * L.s * L.h ||
      (long long)(L.grid - 1) * L.chunk >= L.n || (long long)L.grid * L.chunk < L.n)
    return false;
  for (int j = 0; j < L.k; ++j)
    if (L.o[j] > L.h || -L.o[j] > L.h) return false;
  return true;
}

template <typename T, int J, int H>
const void* rows_kernel() {
  return (const void*)resident_nbr_rows_kernel<T, J, H>;
}

// The instantiation for (J, H): H = 1 takes h <= 1, H = 2 takes h = 2.
template <typename T>
const void* rows_kernel_for(int per_thread, int h) {
  const bool two = h > 1;
  switch (per_thread) {
    case 4: return two ? rows_kernel<T, 4, 2>() : rows_kernel<T, 4, 1>();
    case 8: return two ? rows_kernel<T, 8, 2>() : rows_kernel<T, 8, 1>();
    case 13: return two ? rows_kernel<T, 13, 2>() : rows_kernel<T, 13, 1>();
  }
  return nullptr;
}

// Blocks of K4's instantiation for (J, h) co-resident on the current
// device at `threads` a block (0: none); negative: a CUDA error.
template <typename T>
int rows_capacity(int per_thread, int h, int threads) {
  const void* fn = rows_kernel_for<T>(per_thread, h);
  if (fn == nullptr || h < 0 || h > 2 || threads < 32 || threads > kRowsThreads)
    return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  return per_sm * sms;
}

// `batch` rows in one launch of batch x L.grid blocks; co-residency of the
// whole launch is the host's choice of the geometry
// (resident.RecurrenceBatchPlan), and a launch the card cannot hold at once
// is refused by the cooperative launch.
template <typename T>
int launch_rows(const RowsLaunch& L, const T* x, const T* scale, const T* rows, int m, T* w,
                T* nrm2, int batch, cudaStream_t stream) {
  if (!rows_valid(L) || m < 0 || batch < 1 || (long long)batch * L.grid > 0x7fffffffLL ||
      L.partials == nullptr || L.ticket == nullptr || scale == nullptr || nrm2 == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* fn = rows_kernel_for<T>(L.per_thread, L.h);
  void* args[] = {(void*)&x, (void*)&scale, (void*)&rows, (void*)&L,
                  (void*)&m, (void*)&w, (void*)&nrm2};
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(L.grid * batch), dim3(L.threads), args, 0,
                                              stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace eu

// eu_nbr_rows_capacity_*: blocks of K4's (J, h) instantiation the card
// holds at once at `threads` a block. eu_resident_recurrence_nbr_batched_*:
// K4 over `batch` rows of x (batch, n), each with its scale, (m, 4) rows,
// w and sum of w^2; a CUDA error code, 0 on success.
#define EU_NBR_ROWS_API(T, SUF)                                                         \
  extern "C" int eu_nbr_rows_capacity_##SUF(int per_thread, int h, int threads) {      \
    return eu::rows_capacity<T>(per_thread, h, threads);                               \
  }                                                                                    \
  extern "C" int eu_resident_recurrence_nbr_batched_##SUF(                             \
      const eu::RowsLaunch* L, const T* x, const T* scale, const T* rows, int m,       \
      T* w, T* nrm2, int batch, void* stream) {                                        \
    return eu::launch_rows<T>(*L, x, scale, rows, m, w, nrm2, batch,                   \
                              (cudaStream_t)stream);                                   \
  }

EU_NBR_ROWS_API(float, f32)
EU_NBR_ROWS_API(double, f64)

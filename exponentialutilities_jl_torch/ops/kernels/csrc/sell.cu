// B9 and B10: SpMV of an unstructured matrix in SELL-C-sigma form, and the
// per-row sum of row-segment partials that the segmented pack adds.
//
// B9 replaces exponentialutilities_jl_tpu/ops/kernels/sell.py
//   _sell_kernel  (via _sell_call; sell_spmv, sell_spmv_bucketed and the
//                  first pass of sell_spmv_seg)
// The TPU kernel DMAs an x window per 128-row group into VMEM and gathers
// from it, with window-local indices, roll/residue/subroll gather modes and
// uniform-k schedules to fit Mosaic's vector gather. One GPU layout
// replaces them (ops/kernels/sell.py): slices of C = 32 rows (one warp),
// rows degree-sorted inside windows of sigma rows, each slice as wide as
// its longest row, values and int32 global column indices stored slot-major
// inside the slice (slot j of lane r at slice_ptr[s] + 32 j + r), padded
// slots holding value 0 and the slice's lowest column, and per slice the
// span [lo_s, hi_s] of its columns.
//
// Bound on the H100: HBM bandwidth, (sizeof(T) + 4) bytes per slot
// (padding included) plus x, y and row_of. What held the first design (one
// thread per row, a plain slot loop, x gathered through L1/L2) to 1.3-1.5
// TB/s on an RCM'd matrix of ~17 entries a row: a thread kept ~4 slots of
// loads in flight, so a row took ~5 dependent round trips to memory, and
// the degree sort spreads a warp's 32 rows over the 256-row sort window, so
// each slot instruction gathered x from up to 32 sectors. This design:
//  * Issues the loads of U slots of a row at once (evict-first __ldcs for
//    vals and cols, 32-bit offsets inside a slice) before their FMAs: U =
//    16 when the pack's mean width is 12 slots or more, 4 otherwise (the
//    wrapper picks it from the host-side slot count; U = 16 costs registers
//    and lost on rows of 8 while it won on rows of ~17; the cut-over at 12
//    lies between those two widths and was not timed itself).
//  * Keeps the TPU kernel's x window on chip: a block of 8 slices (256
//    rows: SIGMA, one sort window of the default pack) takes the union of
//    its slices' spans; when that window fits the launch's shared memory
//    (stage_cap values, at most kStageElems), the block copies x[lo..hi]
//    into shared memory once with 16-byte loads (the first load group in
//    flight meanwhile) and gathers from there, otherwise it gathers from
//    global memory through the read-only path. The choice is per block,
//    from the spans, inside the kernel.
//  * Sums each row in slot order, one thread per row, and writes y through
//    row_of: bitwise repeatable, no atomics.
// PERF.md (section 6, the B9 redesign) gives the measurements behind
// these choices: staging against the global gathers (chip_smoke.py phase
// 5 times both on the same matrices, the second through a copy of the pack
// whose staging budget is 0), and the designs that lost (load groups
// pipelined one ahead, vals and cols streamed into shared memory with
// cp.async, 128-row blocks, y staged in shared memory and written
// coalesced). The widest block window of the matrices timed there is 1244
// values, so kStageElems = 4096 (32 KB in float64) leaves room for windows
// three times wider.
//
// B10 replaces exponentialutilities_jl_tpu/ops/kernels/sell.py
//   _seg_compact_kernel  (via _seg_compact_call; direct mode)
//   y_i = sum_{s = seg_ptr[i]}^{seg_ptr[i+1]-1} p_s
// One thread per output row sums its segments' partials in a fixed order
// (the TPU's lane windows and packed index tiles are gone). Bound: the
// partials and seg_ptr, read once (~(sizeof(T) + 8) bytes per segment).
// A warp's rows sit ~1.4 segments apart, so its partial loads span a few
// 128-byte lines and hit L1 after the first. A block-staged variant (256
// rows reading seg_ptr and their run of partials into shared memory with
// 16-byte loads, then summing there) took longer on the device at the
// main path's shape (its barriers; PERF.md, section 6), so this one stays.
//
// No float atomics: every result is bitwise repeatable.
#include <cstddef>

#include "common.cuh"

namespace eu {

constexpr int kSlice = 32;                          // ops/kernels/sell.py SLICE
constexpr int kSlicesPerBlock = kThreads / kSlice;  // 8 slices = 256 rows
constexpr int kStageElems = 4096;                   // ops/kernels/sell.py STAGE_ELEMS
static_assert(kStageElems * sizeof(double) <= 48 * 1024,
              "a larger budget needs cudaFuncSetAttribute before the launch");

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// slots j..j+U-1 of this lane's row (those below width), evict-first
template <typename T, int U>
__device__ __forceinline__ void load_slots(const T* v, const int* c, int j,
                                           int width, T (&cv)[U], int (&cc)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (j + u < width) {
      cv[u] = __ldcs(v + (j + u) * kSlice);
      cc[u] = __ldcs(c + (j + u) * kSlice);
    }
  }
}

// One row's sum over its slice's slots, in slot order, U slots per load
// group; (cv, cc) hold the first group on entry. STAGED: x[c] is xs[c - a].
template <typename T, int U, bool STAGED>
__device__ __forceinline__ T row_sum(const T* v, const int* c, int width,
                                     const T* __restrict__ x, const T* xs,
                                     int a, T (&cv)[U], int (&cc)[U]) {
  T acc = T(0);
  for (int j = 0; j < width; j += U) {
    if (j) load_slots<T, U>(v, c, j, width, cv, cc);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u < width)
        acc += cv[u] * (STAGED ? xs[cc[u] - a] : __ldg(x + cc[u]));
  }
  return acc;
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                 const long long* __restrict__ slice_ptr,
                 const int* __restrict__ spans, const int* __restrict__ row_of,
                 const T* __restrict__ x, long long nrows, long long ncols,
                 long long nslices, int stage_cap, T* __restrict__ y) {
  using VT = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x & 31;
  const long long s0 = (long long)blockIdx.x * kSlicesPerBlock;
  const long long s = s0 + (threadIdx.x >> 5);
  const bool live = s < nslices;
  long long base = 0;
  int width = 0;
  if (live) {
    base = __ldg(slice_ptr + s);
    width = (int)((__ldg(slice_ptr + s + 1) - base) / kSlice);
  }
  const T* v = vals + base + lane;
  const int* c = cols + base + lane;
  T cv[U];
  int cc[U];
  load_slots<T, U>(v, c, 0, width, cv, cc);   // in flight across the staging

  // the union of the block's spans; lanes 0..7 of every warp hold one each
  int lo = 0x7fffffff, hi = -1;
  if (lane < kSlicesPerBlock && s0 + lane < nslices) {
    const int l = __ldg(spans + 2 * (s0 + lane));
    const int h = __ldg(spans + 2 * (s0 + lane) + 1);
    if (h >= l) { lo = l; hi = h; }
  }
#pragma unroll
  for (int o = kSlicesPerBlock / 2; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  lo = __shfl_sync(0xffffffffu, lo, 0);
  hi = __shfl_sync(0xffffffffu, hi, 0);
  const int a = lo & ~(V - 1);          // 16-byte aligned start
  const long long len =
      hi >= lo ? ((long long)hi + 1 - a + V - 1) / V * V : 0;
  const bool staged = len > 0 && len <= stage_cap;   // uniform in the block
  if (staged) {
    const bool vec = (reinterpret_cast<size_t>(x) & 15) == 0;
    for (int e = threadIdx.x * V; e < len; e += kThreads * V) {
      const long long g = (long long)a + e;
      if (vec && g + V <= ncols) {
        *reinterpret_cast<VT*>(xs + e) = __ldg(reinterpret_cast<const VT*>(x + g));
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) xs[e + q] = g + q < ncols ? __ldg(x + g + q) : T(0);
      }
    }
    __syncthreads();
  }
  const T acc = staged ? row_sum<T, U, true>(v, c, width, x, xs, a, cv, cc)
                       : row_sum<T, U, false>(v, c, width, x, xs, a, cv, cc);
  const long long p = s * kSlice + lane;
  if (live && p < nrows) y[__ldcs(row_of + p)] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_compact_kernel(const T* __restrict__ partials,
                   const long long* __restrict__ seg_ptr, long long n,
                   T* __restrict__ y) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long end = seg_ptr[i + 1];
  T acc = T(0);
  for (long long s = seg_ptr[i]; s < end; ++s) acc += partials[s];
  y[i] = acc;
}

inline int grid_of(long long items, long long per_block, unsigned* grid) {
  const long long g = (items + per_block - 1) / per_block;
  if (g < 1 || g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = (unsigned)g;
  return 0;
}

// What every B9 launch on one pack shares, built once on the host by its
// plan (ops/kernels/sell.py SellPlan, whose ctypes mirror is _SellLaunch),
// so a launch passes 4 arguments (ctypes converts every argument of every
// call).
struct SellLaunch {
  const void* vals;
  const int* cols;
  const long long* slice_ptr;
  const int* spans;
  const int* row_of;
  long long nrows, ncols, nslices;
  int stage_cap, unroll;
};
static_assert(sizeof(SellLaunch) == 72 && offsetof(SellLaunch, nrows) == 40 &&
                  offsetof(SellLaunch, stage_cap) == 64,
              "the ctypes mirror in ops/kernels/sell.py assumes this layout");

template <typename T>
int launch_sell_spmv(const SellLaunch* p, const T* x, T* y, cudaStream_t stream) {
  const T* vals = static_cast<const T*>(p->vals);
  const int *cols = p->cols, *spans = p->spans, *row_of = p->row_of;
  const long long* slice_ptr = p->slice_ptr;
  const long long nrows = p->nrows, ncols = p->ncols, nslices = p->nslices;
  const int stage_cap = p->stage_cap, unroll = p->unroll;
  if (nrows < 1 || ncols < 0 || nslices < 1 || nrows > nslices * kSlice ||
      stage_cap < 0 || stage_cap > kStageElems || (unroll != 4 && unroll != 16))
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const int e = grid_of(nslices, kSlicesPerBlock, &grid);
  if (e) return e;
  const size_t smem = (size_t)stage_cap * sizeof(T);
  if (unroll == 16)
    sell_spmv_kernel<T, 16><<<grid, kThreads, smem, stream>>>(
        vals, cols, slice_ptr, spans, row_of, x, nrows, ncols, nslices,
        stage_cap, y);
  else
    sell_spmv_kernel<T, 4><<<grid, kThreads, smem, stream>>>(
        vals, cols, slice_ptr, spans, row_of, x, nrows, ncols, nslices,
        stage_cap, y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seg_compact(const T* partials, const long long* seg_ptr, long long n,
                       T* y, cudaStream_t stream) {
  unsigned grid = 0;
  const int e = grid_of(n, kThreads, &grid);
  if (e) return e;
  seg_compact_kernel<T><<<grid, kThreads, 0, stream>>>(partials, seg_ptr, n, y);
  return (int)cudaGetLastError();
}

}  // namespace eu

#define EU_SELL_API(T, SUF)                                                          \
  extern "C" int eu_sell_spmv_##SUF(const eu::SellLaunch* p, const T* x, T* y,      \
                                    void* stream) {                                  \
    return eu::launch_sell_spmv<T>(p, x, y, (cudaStream_t)stream);                   \
  }                                                                                  \
  extern "C" int eu_seg_compact_##SUF(const T* partials, const long long* seg_ptr,   \
                                      long long n, T* y, void* stream) {             \
    return eu::launch_seg_compact<T>(partials, seg_ptr, n, y, (cudaStream_t)stream); \
  }

EU_SELL_API(float, f32)
EU_SELL_API(double, f64)

// B9 and B10: SpMV of an unstructured matrix in SELL-C-sigma form, and the
// per-row sum of row-segment partials that the segmented pack adds.
//
// B9 replaces exponentialutilities_jl_tpu/ops/kernels/sell.py
//   _sell_kernel  (via _sell_call; sell_spmv, sell_spmv_bucketed and the
//                  first pass of sell_spmv_seg)
// The TPU kernel gathers x through a 1024-column VMEM window per 128-row
// group, with window-local indices, roll/residue/subroll gather modes and
// uniform-k schedules, all to fit Mosaic's vector gather. A GPU gathers
// natively, so one layout replaces them (ops/kernels/sell.py): slices of
// C = 32 rows (one warp), rows degree-sorted inside windows of sigma rows,
// each slice as wide as its longest row, values and int32 global column
// indices stored slot-major inside the slice (slot j of lane r at
// slice_ptr[s] + 32 j + r). One thread computes one row: it walks its
// slice's width, and the warp's value and index loads are one contiguous
// 32-element read per slot, x gathered through the read-only path. The
// row permutation row_of writes y in the original order. Bound on the
// H100: HBM bandwidth, (sizeof(T) + 4) bytes per slot (padding included)
// plus the x gathers (served mostly from L2 for a banded-random matrix).
//
// B10 replaces exponentialutilities_jl_tpu/ops/kernels/sell.py
//   _seg_compact_kernel  (via _seg_compact_call; direct mode)
//   y_i = sum_{s = seg_ptr[i]}^{seg_ptr[i+1]-1} p_s
// One thread per output row sums its segments' partials in a fixed order
// (the TPU's lane windows and packed index tiles are gone). Bound: the
// partials and seg_ptr, read once (~(sizeof(T) + 8) bytes per segment).
//
// No float atomics: every result is bitwise repeatable.
#include "common.cuh"

namespace eu {

constexpr int kSlice = 32;     // rows per slice: ops/kernels/sell.py SLICE

template <typename T>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                 const long long* __restrict__ slice_ptr,
                 const int* __restrict__ row_of, const T* __restrict__ x,
                 long long nrows, long long nslices, T* __restrict__ y) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = p / kSlice;
  if (s >= nslices) return;
  const long long base = slice_ptr[s];
  const long long width = (slice_ptr[s + 1] - base) / kSlice;
  const int lane = threadIdx.x % kSlice;
  const T* v = vals + base + lane;
  const int* c = cols + base + lane;
  T acc = T(0);
  for (long long j = 0; j < width; ++j)
    acc += v[j * kSlice] * __ldg(x + c[j * kSlice]);
  if (p < nrows) y[row_of[p]] = acc;
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

inline int grid_of(long long threads, unsigned* grid) {
  const long long g = (threads + kThreads - 1) / kThreads;
  if (g < 1 || g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = (unsigned)g;
  return 0;
}

template <typename T>
int launch_sell_spmv(const T* vals, const int* cols, const long long* slice_ptr,
                     const int* row_of, const T* x, long long nrows,
                     long long nslices, T* y, cudaStream_t stream) {
  if (nrows < 1 || nslices < 1 || nrows > nslices * kSlice)
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const int e = grid_of(nslices * kSlice, &grid);
  if (e) return e;
  sell_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(vals, cols, slice_ptr, row_of,
                                                     x, nrows, nslices, y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seg_compact(const T* partials, const long long* seg_ptr, long long n,
                       T* y, cudaStream_t stream) {
  unsigned grid = 0;
  const int e = grid_of(n, &grid);
  if (e) return e;
  seg_compact_kernel<T><<<grid, kThreads, 0, stream>>>(partials, seg_ptr, n, y);
  return (int)cudaGetLastError();
}

}  // namespace eu

#define EU_SELL_API(T, SUF)                                                          \
  extern "C" int eu_sell_spmv_##SUF(const T* vals, const int* cols,                  \
                                    const long long* slice_ptr, const int* row_of,   \
                                    const T* x, long long nrows, long long nslices,  \
                                    T* y, void* stream) {                            \
    return eu::launch_sell_spmv<T>(vals, cols, slice_ptr, row_of, x, nrows, nslices, \
                                   y, (cudaStream_t)stream);                         \
  }                                                                                  \
  extern "C" int eu_seg_compact_##SUF(const T* partials, const long long* seg_ptr,   \
                                      long long n, T* y, void* stream) {             \
    return eu::launch_seg_compact<T>(partials, seg_ptr, n, y, (cudaStream_t)stream); \
  }

EU_SELL_API(float, f32)
EU_SELL_API(double, f64)

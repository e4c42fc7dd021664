// Shared pieces of the hand-written Hopper kernels: stencil descriptors,
// the fixed-order block reduction, the grid sizing of the persistent
// cooperative kernels (cached per kernel and device), and the error-code
// convention of the plain C launchers (each returns a cudaError_t as int;
// 0 is success).
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace eu {

constexpr int kThreads = 256;   // every kernel runs 1-D blocks of this size
constexpr int kMaxPoints = 64;  // stencil points a descriptor can hold

// 1-D flat offsets (B1/B2). Passed by value; copied to shared memory.
struct Offsets1D {
  int k;
  int o[kMaxPoints];
};

// 3-D box-stencil offsets (B3), one (dz, dy, dx) triple per point.
struct Offsets3D {
  int k;
  int dz[kMaxPoints];
  int dy[kMaxPoints];
  int dx[kMaxPoints];
};

// a * b + c rounded once: an explicit fused multiply-add, so that the
// compiler's contraction cannot make two kernels' arithmetic differ
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// The arithmetic of one row of the (m, 4)-row recurrence, written once with
// explicit fused multiply-adds so that contraction cannot differ between the
// kernels that call it (B1's two forms, B4's two, B5's two give the same
// bits as their other form):
//   W[j] += cw[k, j] omega_k                          (accumulate)
//   z     = sum_j c_j omega[i + o_j], in j order      (stencil_term)
//   omega_{k+1} = ca z + cb omega_k + cc omega_{k-1}  (next_row)
template <typename T>
__device__ __forceinline__ T accumulate(T w, T cw, T wc) { return fma_rn(cw, wc, w); }

template <typename T>
__device__ __forceinline__ T stencil_term(T z, T c, T x) { return fma_rn(c, x, z); }

template <typename T>
__device__ __forceinline__ T next_row(T ca, T cb, T cc, T z, T wc, T wp) {
  return fma_rn(ca, z, fma_rn(cb, wc, cc * wp));
}

// Block-wide sum in a FIXED order: every call with the same per-thread
// inputs returns bitwise the same value (no atomics). `scratch` holds
// kThreads values; every thread of the block must call.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  const int t = threadIdx.x;
  __syncthreads();               // the previous call's readers are done
  scratch[t] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) scratch[t] += scratch[t + s];
    __syncthreads();
  }
  return scratch[0];
}

// Sum of n per-block partials (stride `stride` apart) in a fixed order.
// Reads bypass L1 (__ldcg): the partials were written by other blocks.
template <typename T>
__device__ __forceinline__ T fixed_order_total(const T* p, int n, int stride,
                                               T* scratch) {
  T a = T(0);
  for (int b = threadIdx.x; b < n; b += kThreads) a += __ldcg(p + (size_t)b * stride);
  return block_sum(a, scratch);
}

// Largest grid of `fn` (kThreads per block) that is co-resident on the
// current device, as a cooperative launch needs; negative: a CUDA error.
// The answer is fixed per (kernel, device), so it is queried once and kept:
// the device, attribute and occupancy queries cost host time at every
// launch of B1, B2's grid form and B4-B6 otherwise.
inline int max_coresident_blocks(const void* fn) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> known;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find({fn, dev});
    if (it != known.end()) return it->second;
  }
  int sms = 0, per_sm = 0, coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  std::lock_guard<std::mutex> lock(mu);
  known[{fn, dev}] = per_sm * sms;
  return per_sm * sms;
}

// Grid of a persistent kernel over n rows: one block per kThreads rows, at
// most the co-resident maximum (grid-stride loops cover the rest).
inline int grid_for(const void* fn, long long n, int* grid) {
  const int cap = max_coresident_blocks(fn);
  if (cap <= 0) return cap == 0 ? (int)cudaErrorCooperativeLaunchTooLarge : -cap;
  const long long need = (n + kThreads - 1) / kThreads;
  *grid = (int)(need < cap ? (need > 0 ? need : 1) : cap);
  return 0;
}

inline Offsets1D make_offsets(const int* offs, int k) {
  Offsets1D o{};
  o.k = k;
  for (int j = 0; j < k; ++j) o.o[j] = offs[j];
  return o;
}

}  // namespace eu

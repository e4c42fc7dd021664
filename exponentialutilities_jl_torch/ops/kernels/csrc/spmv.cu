// B7 and B8: one sparse matrix-vector product per launch for the two
// structured containers, each thread or warp owning whole output rows.
//
// B7 replaces exponentialutilities_jl_tpu/ops/kernels/spmv.py
//   _banded_kernel  (banded_spmv, spmv.py:134)
//   y_i = sum_k D[k, i] x[i + o_k], x read as zero outside [0, n)
// The TPU kernel lays x out as (rows, 128) lane tiles, DMAs a halo window
// per grid step and builds each shift from two lane slices. Here one
// thread computes one row: the k <= kMaxPoints offsets travel as a kernel
// argument (copied to shared memory), diagonal j of row i is read at
// D[j n + i] (coalesced across the warp) and every x read is bounds-checked,
// so no padding or halo exists. Bound on the H100: HBM bandwidth, with
// (k + 2) n sizeof(T) bytes per product (the k diagonals, x once through L2
// and the read-only path, y): ~56 MB for poisson_2d(1000, 1000) in float64,
// ~17 us at 3.35 TB/s.
//
// B8 replaces exponentialutilities_jl_tpu/ops/kernels/spmv.py
//   _spmv_kernel  (blockell_spmv, spmv.py:42)
//   y[r br + i] = sum_k sum_j blocks[r, k, i, j] x[bcols[r, k] bc + j]
// The TPU kernel prefetches the block columns into SMEM, copies the needed
// x rows into VMEM and reduces one (rows, w, br, bc) tile. Here one warp
// owns one block-row: for each of its br output rows the lanes stride over
// the w bc products (consecutive lanes on consecutive j, so a block row is
// read contiguously), x is gathered through the read-only path, and the
// row is reduced with warp shuffles in a fixed order. Bound: the block
// stream, nbr w br bc sizeof(T) bytes, read once.
//
// No float atomics: every result is bitwise repeatable.
#include "common.cuh"

namespace eu {

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_spmv_kernel(const T* __restrict__ diags, Offsets1D offs,
                   const T* __restrict__ x, long long n, T* __restrict__ y) {
  __shared__ int o_sh[kMaxPoints];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) o_sh[j] = offs.o[j];
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    const long long q = i + o_sh[j];
    if (q >= 0 && q < n) acc += diags[(long long)j * n + i] * __ldg(x + q);
  }
  y[i] = acc;
}

constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
blockell_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ bcols,
                     const T* __restrict__ x, long long nbr, int w, int br, int bc,
                     T* __restrict__ y) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= nbr) return;                     // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int wb = w * bc;
  const T* rb = blocks + r * w * (long long)br * bc;
  const int* rc = bcols + r * w;
  for (int i = 0; i < br; ++i) {
    T acc = T(0);
    for (int t = lane; t < wb; t += 32) {
      const int kb = t / bc;
      const int j = t - kb * bc;
      acc += rb[((long long)kb * br + i) * bc + j] *
             __ldg(x + (long long)__ldg(rc + kb) * bc + j);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, s);
    if (lane == 0) y[r * br + i] = acc;
  }
}

template <typename T>
int launch_banded_spmv(const T* diags, const int* offs, int k, const T* x,
                       long long n, T* y, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kMaxPoints) return (int)cudaErrorInvalidValue;
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  banded_spmv_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      diags, make_offsets(offs, k), x, n, y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blockell_spmv(const T* blocks, const int* bcols, const T* x,
                         long long nbr, int w, int br, int bc, T* y,
                         cudaStream_t stream) {
  if (nbr < 1 || w < 1 || br < 1 || bc < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (nbr + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  blockell_spmv_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      blocks, bcols, x, nbr, w, br, bc, y);
  return (int)cudaGetLastError();
}

}  // namespace eu

#define EU_SPMV_API(T, SUF)                                                          \
  extern "C" int eu_banded_spmv_##SUF(const T* diags, const int* offs, int k,        \
                                      const T* x, long long n, T* y, void* stream) { \
    return eu::launch_banded_spmv<T>(diags, offs, k, x, n, y, (cudaStream_t)stream); \
  }                                                                                  \
  extern "C" int eu_blockell_spmv_##SUF(const T* blocks, const int* bcols,           \
                                        const T* x, long long nbr, int w, int br,    \
                                        int bc, T* y, void* stream) {                \
    return eu::launch_blockell_spmv<T>(blocks, bcols, x, nbr, w, br, bc, y,          \
                                       (cudaStream_t)stream);                        \
  }

EU_SPMV_API(float, f32)
EU_SPMV_API(double, f64)

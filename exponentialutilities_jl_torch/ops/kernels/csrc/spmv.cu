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
// owns one block row, which is one contiguous run of w br bc values.
// Bound on the H100: the block stream, nbr w br bc sizeof(T) bytes read
// once (x, 2 MB to 16 MB here, stays in L2). The first design walked the
// block row once per output row with 8-byte loads, a runtime division and
// a bcols reload per element and one shuffle reduction per row: few loads
// in flight, 1.5 TB/s. For the block shapes the port builds (8 x 8, 4 x 4;
// template on (br, bc)) each lane now owns one 16-byte piece of a block: a
// row i and V = 16 / sizeof(T) columns j..j+V-1 (8 x 8 float64: lane l has
// i = l / 4, j = 2 (l % 4), and the warp's 32 loads are one 512-byte
// block; smaller blocks put 32 / (br bc / V) blocks in one warp step). The
// lane reads the matching x[bcols[k] bc + j ..] as one 16-byte load, the
// warp's bcols come in once (lane k holds bcols[k], broadcast with
// __shfl_sync), kStepsB steps of block and x loads are issued before their
// FMAs (evict-first loads for the block stream), partial sums stay in
// registers, and one fixed-order xor-shuffle reduction per block row ends
// it. An operand that is not 16-byte aligned (an offset view of x, say)
// takes the same kernel with each piece read as V scalar loads (ALIGNED
// false): the same lanes, pieces and summation order, so B8's bits do not
// depend on the operands' alignment. Any other (br, bc) takes the general
// kernel: the lanes stride over the w bc products of each of the br rows.
//
// No float atomics: every other result is bitwise repeatable.
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

template <typename T> struct Piece16;
template <> struct Piece16<float> {
  using type = float4;
  static __device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};
template <> struct Piece16<double> {
  using type = double2;
  static __device__ __forceinline__ double dot(double2 a, double2 b, double acc) {
    acc = fma(a.x, b.x, acc);
    return fma(a.y, b.y, acc);
  }
};

constexpr int kStepsB = 8;      // warp steps of loads issued before their FMAs

// The 16-byte piece at a p that may not be 16-byte aligned, as V scalar
// loads (the values of one vector load). EVICT: the block stream.
template <typename T, bool EVICT>
__device__ __forceinline__ typename Piece16<T>::type load_scalars(const T* p) {
  typename Piece16<T>::type v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int u = 0; u < (int)(16 / sizeof(T)); ++u) e[u] = EVICT ? __ldcs(p + u) : __ldg(p + u);
  return v;
}

// B8 for (BR, BC) blocks whose rows hold whole 16-byte pieces (module note)
template <typename T, int BR, int BC, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
blockell_spmv_tiled(const T* __restrict__ blocks, const int* __restrict__ bcols,
                    const T* __restrict__ x, long long nbr, int w,
                    T* __restrict__ y) {
  using VT = typename Piece16<T>::type;
  constexpr int V = 16 / sizeof(T);
  constexpr int kPieces = BR * BC / V;          // lanes per block
  constexpr int kPerStep = 32 / kPieces;        // blocks per warp step
  constexpr int kRowLanes = BC / V;             // lanes per block row
  constexpr int kSteps = kStepsB < 32 / kPerStep ? kStepsB : 32 / kPerStep;
  static_assert(BC % V == 0 && kPieces <= 32 && 32 % kPieces == 0,
                "a block row must be whole 16-byte pieces");
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= nbr) return;                     // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int q = lane / kPieces;             // this lane's block in a step
  const int e = lane % kPieces;             // its piece of that block
  const int i = e / kRowLanes;              // the piece's row
  const int j = (e % kRowLanes) * V;        // and first column
  const T* rbase = blocks + r * w * (long long)(BR * BC);
  const VT* rb = reinterpret_cast<const VT*>(rbase) + e;   // ALIGNED
  const T* rs = rbase + e * V;                              // !ALIGNED
  const int* rc = bcols + r * w;
  T acc = T(0);
  for (int k0 = 0; k0 < w; k0 += 32) {      // 32 block columns per bcols load
    const int nk = min(32, w - k0);
    const int col = lane < nk ? __ldcs(rc + k0 + lane) : 0;
    for (int t0 = 0; t0 < nk; t0 += kSteps * kPerStep) {
      VT a[kSteps], xv[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int kb = t0 + u * kPerStep + q;
        const int cb = __shfl_sync(0xffffffffu, col, kb & 31);
        if (kb < nk) {
          if constexpr (ALIGNED) {
            a[u] = __ldcs(rb + (long long)(k0 + kb) * kPieces);
            xv[u] = __ldg(reinterpret_cast<const VT*>(x + (long long)cb * BC + j));
          } else {
            a[u] = load_scalars<T, true>(rs + (long long)(k0 + kb) * (BR * BC));
            xv[u] = load_scalars<T, false>(x + (long long)cb * BC + j);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
        if (t0 + u * kPerStep + q < nk) acc = Piece16<T>::dot(a[u], xv[u], acc);
    }
  }
  // the lanes of row i: the pieces of one block row, then the blocks of a
  // step, in a fixed order
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
#pragma unroll
  for (int o = kPieces; o < 32; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (q == 0 && e % kRowLanes == 0) y[r * BR + i] = acc;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
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
  const bool vec = aligned16(blocks) && aligned16(x);
  if (br == 8 && bc == 8 && vec)
    blockell_spmv_tiled<T, 8, 8, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        blocks, bcols, x, nbr, w, y);
  else if (br == 8 && bc == 8)
    blockell_spmv_tiled<T, 8, 8, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        blocks, bcols, x, nbr, w, y);
  else if (br == 4 && bc == 4 && vec)
    blockell_spmv_tiled<T, 4, 4, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        blocks, bcols, x, nbr, w, y);
  else if (br == 4 && bc == 4)
    blockell_spmv_tiled<T, 4, 4, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        blocks, bcols, x, nbr, w, y);
  else
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

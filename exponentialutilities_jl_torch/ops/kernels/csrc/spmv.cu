// B7 and B8: one sparse matrix-vector product per launch for the two
// structured containers, each thread or warp owning whole output rows.
//
// B7 replaces exponentialutilities_jl_tpu/ops/kernels/spmv.py
//   _banded_kernel  (banded_spmv, spmv.py:134)
//   y_i = sum_k D[k, i] x[i + o_k], x read as zero outside [0, n)
// The TPU kernel lays x out as (rows, 128) lane tiles, DMAs a halo window
// per grid step and builds each shift from two lane slices. Bound on the
// H100: HBM bandwidth, with (k + 2) n sizeof(T) bytes per product (the k
// diagonals, x once through L2 and the read-only path, y): ~56 MB for
// poisson_2d(1000, 1000) in float64, ~17 us at 3.35 TB/s. The first design
// (one thread a row, 8-byte loads, a bounds check on every x read) reached
// ~73 % of that on the device. This one:
//  * Gives each thread V = 16 / sizeof(T) consecutive rows (2 in float64,
//    4 in float32), so a block of kThreads threads owns R = kThreads V rows
//    and reads each diagonal's piece of a thread with one 16-byte
//    evict-first load (__ldcs; the diagonals are read once).
//  * Issues the loads of a group of up to kGroup diagonals (their pieces
//    and the matching x values, through the read-only path: x is re-read
//    by neighbouring rows and blocks) before their FMAs, so a thread keeps
//    many loads in flight.
//  * Runs the blocks whose x window [r0 + min o, r0 + R + max o) lies in
//    [0, n) (and whose R rows all exist) without bounds checks; the host
//    computes that block range from the offsets once per operator
//    (ops/kernels/spmv.banded_interior). Edge blocks check each read and
//    row, reading x as zero outside [0, n).
//  * Sums each row in offset order, one FMA per term, on every path: the
//    interior and edge paths, and the ALIGNED = false path that reads the
//    same pieces with scalar loads when the diagonals are not 16-byte
//    aligned (an offset view, or n not a multiple of V, where row j of the
//    diagonals starts at j n). So y's bits do not depend on the path.
// x is not staged in shared memory: a block's window holds about as many
// values as its x loads (poisson_2d(1000, 1000), float64: 2512 against
// 5 x 512), so staging would save no L2 traffic; the re-reads of the
// near offsets hit L1.
//
// K1, B7's batched form (banded_spmm, the batched Krylov builders' product
// of expv_batched): Y[b, i] = sum_k D[k, i] X[b, i + o_k] for each row of
// X (batch, n). It replaces the same TPU kernel (JAX vmaps B7's callers,
// models/expv.py _batched_build). Bound: HBM, with (k + 2 batch) n
// sizeof(T) bytes for the block, against batch (k + 2) n for a B7 launch
// a row: the point is that the diagonals cross HBM once for every row of
// a block (up to kSpmmRows rows; more rows take more blocks along y). A
// block keeps B7's geometry and interior/edge split (the same blo, bhi)
// and holds kSpmmRows x V accumulators; each group of kSpmmGroup
// diagonals' pieces is loaded once and applied to every row, so each
// row's terms are B7's, in offset order, one FMA each: a row's bits are
// a B7 launch's on that row.
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
#include <cstddef>

#include "common.cuh"

namespace eu {

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
  static __device__ __forceinline__ float fma1(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ void split(float4 a, float (&e)[4]) {
    e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
  }
  static __device__ __forceinline__ float4 join(const float (&e)[4]) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
};
template <> struct Piece16<double> {
  using type = double2;
  static __device__ __forceinline__ double dot(double2 a, double2 b, double acc) {
    acc = fma(a.x, b.x, acc);
    return fma(a.y, b.y, acc);
  }
  static __device__ __forceinline__ double fma1(double a, double b, double c) {
    return fma(a, b, c);
  }
  static __device__ __forceinline__ void split(double2 a, double (&e)[2]) {
    e[0] = a.x; e[1] = a.y;
  }
  static __device__ __forceinline__ double2 join(const double (&e)[2]) {
    return make_double2(e[0], e[1]);
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

constexpr int kGroup = 8;       // B7: diagonals whose loads precede their FMAs
constexpr int kSpmmRows = 16;   // K1: batch rows of a block (spmv.SPMM_ROWS)
constexpr int kSpmmGroup = 4;   // K1: diagonals of a group (registers: 16 rows)

// B7 (module note): block b owns rows [b R, b R + R), R = kThreads V, and
// thread t of it rows i0 .. i0 + V - 1; the blocks in [blo, bhi) are
// interior (no bounds checks).
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
banded_spmv_kernel(const T* __restrict__ diags, Offsets1D offs,
                   const T* __restrict__ x, long long n, long long blo,
                   long long bhi, T* __restrict__ y) {
  using P = Piece16<T>;
  using VT = typename P::type;
  constexpr int V = 16 / sizeof(T);
  __shared__ int o_sh[kMaxPoints];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) o_sh[j] = offs.o[j];
  __syncthreads();
  const long long b = blockIdx.x;
  const long long i0 = (b * kThreads + threadIdx.x) * V;
  if (i0 >= n) return;
  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = T(0);
  if (b >= blo && b < bhi) {                 // uniform in the block
    for (int j0 = 0; j0 < k; j0 += kGroup) {
      T d[kGroup][V], xv[kGroup][V];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (j0 + g < k) {
          const T* dp = diags + (long long)(j0 + g) * n + i0;
          if constexpr (ALIGNED) P::split(__ldcs(reinterpret_cast<const VT*>(dp)), d[g]);
          else P::split(load_scalars<T, true>(dp), d[g]);
          const T* xp = x + i0 + o_sh[j0 + g];
#pragma unroll
          for (int v = 0; v < V; ++v) xv[g][v] = __ldg(xp + v);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (j0 + g < k) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = P::fma1(d[g][v], xv[g][v], acc[v]);
        }
      }
    }
    if constexpr (ALIGNED) {
      *reinterpret_cast<VT*>(y + i0) = P::join(acc);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) y[i0 + v] = acc[v];
    }
    return;
  }
  // an edge block: rows past n and x outside [0, n) read as zero
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    T d[kGroup][V], xv[kGroup][V];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g < k) {
        const T* dp = diags + (long long)(j0 + g) * n;
        const long long o = o_sh[j0 + g];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const long long i = i0 + v, q = i + o;
          d[g][v] = i < n ? __ldcs(dp + i) : T(0);
          xv[g][v] = (i < n && q >= 0 && q < n) ? __ldg(x + q) : T(0);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g < k) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = P::fma1(d[g][v], xv[g][v], acc[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (i0 + v < n) y[i0 + v] = acc[v];
}

// K1, B7's batched form (module note): block (b, c) owns rows [b R, b R +
// R) of the batch rows [c kSpmmRows, c kSpmmRows + kSpmmRows), thread t
// rows i0 .. i0 + V - 1 of each. A group of diagonals' pieces is loaded
// once and serves every batch row of the block, so the diagonals cross
// HBM once for up to kSpmmRows rows; each row's sum is B7's, term for
// term (the same loads, zeros and FMAs in offset order), so its bits are
// a B7 launch's on that row.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
banded_spmm_kernel(const T* __restrict__ diags, Offsets1D offs,
                   const T* __restrict__ X, long long n, long long blo,
                   long long bhi, int batch, T* __restrict__ Y) {
  using P = Piece16<T>;
  using VT = typename P::type;
  constexpr int V = 16 / sizeof(T);
  __shared__ int o_sh[kMaxPoints];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) o_sh[j] = offs.o[j];
  __syncthreads();
  const long long b = blockIdx.x;
  const int r0 = blockIdx.y * kSpmmRows;
  const int nr = batch - r0 < kSpmmRows ? batch - r0 : kSpmmRows;
  const long long i0 = (b * kThreads + threadIdx.x) * V;
  if (i0 >= n) return;
  X += (long long)r0 * n;
  Y += (long long)r0 * n;
  const bool interior = b >= blo && b < bhi;   // uniform in the block
  T acc[kSpmmRows][V];
#pragma unroll
  for (int r = 0; r < kSpmmRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = T(0);
  for (int j0 = 0; j0 < k; j0 += kSpmmGroup) {
    T d[kSpmmGroup][V];
#pragma unroll
    for (int g = 0; g < kSpmmGroup; ++g) {
      if (j0 + g < k) {
        const T* dp = diags + (long long)(j0 + g) * n;
        if (interior) {
          if constexpr (ALIGNED) P::split(__ldcs(reinterpret_cast<const VT*>(dp + i0)), d[g]);
          else P::split(load_scalars<T, true>(dp + i0), d[g]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) d[g][v] = i0 + v < n ? __ldcs(dp + i0 + v) : T(0);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSpmmRows; ++r) {
      if (r < nr) {
        const T* xr = X + (long long)r * n;
        T xv[kSpmmGroup][V];
#pragma unroll
        for (int g = 0; g < kSpmmGroup; ++g) {
          if (j0 + g < k) {
            const long long o = o_sh[j0 + g];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const long long i = i0 + v, q = i + o;
              xv[g][v] = interior ? __ldg(xr + q)
                                  : ((i < n && q >= 0 && q < n) ? __ldg(xr + q) : T(0));
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kSpmmGroup; ++g) {
          if (j0 + g < k) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[r][v] = P::fma1(d[g][v], xv[g][v], acc[r][v]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSpmmRows; ++r) {
    if (r < nr) {
      T* yr = Y + (long long)r * n;
      if (ALIGNED && interior) {
        *reinterpret_cast<VT*>(yr + i0) = P::join(acc[r]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (i0 + v < n) yr[i0 + v] = acc[r][v];
      }
    }
  }
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

// What every B7 launch on one matrix shares, built once on the host by
// its plan (ops/kernels/spmv.py BandedPlan, whose ctypes mirror is
// _BandedLaunch), so a launch passes 4 arguments (ctypes converts every
// argument of every call). [blo, bhi): the interior blocks.
struct BandedLaunch {
  const void* diags;
  long long n, blo, bhi;
  Offsets1D offs;
};
static_assert(sizeof(BandedLaunch) == 296 && offsetof(BandedLaunch, offs) == 32,
              "the ctypes mirror in ops/kernels/spmv.py assumes this layout");

// Refused unless every x read of the interior blocks lies in [0, n) (the
// kernel does not check there).
template <typename T>
int launch_banded_spmv(const BandedLaunch* p, const T* x, T* y,
                       cudaStream_t stream) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const long long n = p->n, blo = p->blo, bhi = p->bhi;
  const Offsets1D& o = p->offs;
  if (n < 1 || o.k < 1 || o.k > kMaxPoints || blo < 0 || bhi < blo)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + R - 1) / R;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bhi > blo) {
    int lo = o.o[0], hi = o.o[0];
    for (int j = 1; j < o.k; ++j) {
      lo = lo < o.o[j] ? lo : o.o[j];
      hi = hi > o.o[j] ? hi : o.o[j];
    }
    if (blo * R + lo < 0 || bhi * R + (hi > 0 ? hi : 0) > n)
      return (int)cudaErrorInvalidValue;
  }
  const T* diags = static_cast<const T*>(p->diags);
  if (aligned16(diags) && n % (16 / sizeof(T)) == 0)
    banded_spmv_kernel<T, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        diags, o, x, n, blo, bhi, y);
  else
    banded_spmv_kernel<T, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        diags, o, x, n, blo, bhi, y);
  return (int)cudaGetLastError();
}

// K1: B7's checks, then a (row blocks, batch / kSpmmRows) grid.
template <typename T>
int launch_banded_spmm(const BandedLaunch* p, const T* X, T* Y, int batch,
                       cudaStream_t stream) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const long long n = p->n, blo = p->blo, bhi = p->bhi;
  const Offsets1D& o = p->offs;
  if (n < 1 || o.k < 1 || o.k > kMaxPoints || blo < 0 || bhi < blo || batch < 1)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + R - 1) / R;
  const long long chunks = (batch + kSpmmRows - 1) / kSpmmRows;
  if (grid > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  if (bhi > blo) {
    int lo = o.o[0], hi = o.o[0];
    for (int j = 1; j < o.k; ++j) {
      lo = lo < o.o[j] ? lo : o.o[j];
      hi = hi > o.o[j] ? hi : o.o[j];
    }
    if (blo * R + lo < 0 || bhi * R + (hi > 0 ? hi : 0) > n)
      return (int)cudaErrorInvalidValue;
  }
  const T* diags = static_cast<const T*>(p->diags);
  const dim3 g((unsigned)grid, (unsigned)chunks);
  if (aligned16(diags) && aligned16(Y) && n % (16 / sizeof(T)) == 0)
    banded_spmm_kernel<T, true><<<g, kThreads, 0, stream>>>(diags, o, X, n, blo, bhi,
                                                            batch, Y);
  else
    banded_spmm_kernel<T, false><<<g, kThreads, 0, stream>>>(diags, o, X, n, blo, bhi,
                                                             batch, Y);
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
  extern "C" int eu_banded_spmv_##SUF(const eu::BandedLaunch* p, const T* x, T* y,  \
                                      void* stream) {                                \
    return eu::launch_banded_spmv<T>(p, x, y, (cudaStream_t)stream);                 \
  }                                                                                  \
  extern "C" int eu_banded_spmm_##SUF(const eu::BandedLaunch* p, const T* X, T* Y,  \
                                      int batch, void* stream) {                     \
    return eu::launch_banded_spmm<T>(p, X, Y, batch, (cudaStream_t)stream);          \
  }                                                                                  \
  extern "C" int eu_blockell_spmv_##SUF(const T* blocks, const int* bcols,           \
                                        const T* x, long long nbr, int w, int br,    \
                                        int bc, T* y, void* stream) {                \
    return eu::launch_blockell_spmv<T>(blocks, bcols, x, nbr, w, br, bc, y,          \
                                       (cudaStream_t)stream);                        \
  }

EU_SPMV_API(float, f32)
EU_SPMV_API(double, f64)

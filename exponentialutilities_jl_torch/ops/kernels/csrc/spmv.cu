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
// a row: the diagonals cross HBM once for every row. The first design
// held 16 rows x V accumulators and a group's x values a thread:
// over 100 registers, one block of 256 threads an SM, few loads in flight,
// 47-52 % of the bound. This one (banded_rows.cuh) keeps B7's segments
// and interior/edge split but:
//  * holds the pieces of the k diagonals in registers (instantiated for
//    k = 3 and 5, banded_dispatch) and streams the batch rows past them,
//    one row's x loads then its FMAs: ~V (2k + 2) live values, built for
//    kMinBlocksR = 3 blocks an SM;
//  * sizes the grid to the blocks the card holds at once
//    (max_coresident_blocks), each block striding over the segments, so
//    no batch limit and no second wave of a few blocks;
//  * takes the interior path as a template argument, and reads an x piece
//    whose offset keeps the 16-byte alignment as one vector load.
// Each row's sum stays B7's, in offset order, one FMA a term (any other
// k: kGroupR diagonals at a time, the pieces re-read through L1 for each
// row), so a row's bits are a B7 launch's on that row.
//
// K1's Lanczos form (pass A of the fused batched Lanczos step; K5 in
// csrc/lanczos_step.cu is pass B): the same kernel under the mode
// SpmmLanczos. It reads x = u_r scale_r (the previous step's
// normalization folded into this read), writes v_j = x's own rows to the
// step's slot (a basis row or a ring slot, picked by j read on the
// device), and adds v_j . A v_j per row into the block's partials; the
// launch's last block (a ticket the kernel resets itself) sums them in
// block order into alpha (batch,): no float atomics. A broken-down row is
// skipped (its slot written zero). Bound: (k + 2 batch) n sizeof(T) bytes.
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
// No float atomics: every result is bitwise repeatable.
#include <cstddef>

#include "banded_rows.cuh"

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

constexpr int kStepsB = 8;      // warp steps of loads issued before their FMAs

constexpr int kGroup = 8;       // B7: diagonals whose loads precede their FMAs

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

// K1's modes (module note; the row body is banded_rows.cuh's). Plain:
// Y[r] = A X[r]. Lanczos (pass A of the fused batched Lanczos step,
// csrc/lanczos_step.cu): X[r] = u_r scale_r is v_j, written to its slot,
// and each block's partials of alpha_r = v_j . A v_j; the launch's last
// block sums them in block order into alpha.
template <typename T>
struct SpmmPlain {
  static constexpr bool kScaled = false;
  static constexpr int V = 16 / sizeof(T);
  const T* X;
  T* Y;
  long long n;
  int batch;
  __device__ void begin(unsigned char*) {}
  __device__ void end() {}
  __device__ bool skip(int) const { return false; }
  template <bool A, bool I>
  __device__ void skipped(int, long long) {}
  __device__ const T* x(int r) const { return X + (long long)r * n; }
  __device__ T scale(int) const { return T(1); }
  template <bool A, bool I>
  __device__ void out(int r, long long i0, const T (&acc)[V], const T (&)[V]) {
    store_own<T, A, I>(Y + (long long)r * n, i0, n, acc);
  }
};

template <typename T>
struct SpmmLanczos {
  static constexpr bool kScaled = true;
  static constexpr int V = 16 / sizeof(T);
  const T* u;
  T* v;
  long long n, urow, vrow, vslot;
  int nslots, batch;
  const T* sc;
  const unsigned char* broke;
  T* alpha;
  T* partial;
  int* ticket;
  const long long* jj;
  bool have_xc;
  T* vc;          // slot j of row 0 (begin)
  T* red;         // the warps' partials in shared memory (begin)
  static SpmmLanczos make(const LanczosLaunch& p) {
    return SpmmLanczos{static_cast<const T*>(p.u), static_cast<T*>(p.v), p.n, p.urow,
                       p.vrow, p.vslot, p.nslots, p.batch,
                       static_cast<const T*>(p.scale), p.broke,
                       static_cast<T*>(p.alpha), static_cast<T*>(p.partial), p.ticket,
                       p.jj, p.zc >= 0, nullptr, nullptr};
  }
  __device__ void begin(unsigned char* smem) {
    const long long j = *jj;
    vc = v + (nslots ? j % nslots : j) * vslot;
    red = reinterpret_cast<T*>(smem);
    clear_partials(red, batch);
  }
  __device__ bool skip(int r) const { return broke[r] != 0; }
  template <bool A, bool I>
  __device__ void skipped(int r, long long i0) {
    T z[V];
#pragma unroll
    for (int e = 0; e < V; ++e) z[e] = T(0);
    store_own<T, A, I>(vc + r * vrow, i0, n, z);
  }
  __device__ const T* x(int r) const { return u + r * urow; }
  __device__ T scale(int r) const { return sc[r]; }
  template <bool A, bool I>
  __device__ void out(int r, long long i0, const T (&acc)[V], const T (&xc)[V]) {
    T w[V];
    if (have_xc) {
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = xc[e];
    } else {                      // no zero offset: v_j's own rows again
      load_own<T, A, I, false>(u + r * urow, i0, n, w);
      const T s = sc[r];
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = w[e] * s;
    }
    store_own<T, A, I>(vc + r * vrow, i0, n, w);
    T part = T(0);
#pragma unroll
    for (int e = 0; e < V; ++e) part = fma_rn(w[e], acc[e], part);
    warp_partial(red, batch, r, part);
  }
  __device__ void end() {
    if (!publish_partials(red, batch, partial, ticket)) return;
    T* a = alpha;
    reduce_partials(partial, batch, ticket, [a](int r, T t) { a[r] = t; });
  }
};

// K1 (module note): every mode's rows through banded_segments; the mode's
// begin and end frame it (K1's Lanczos form: the partials and the last
// block's sums). Dynamic shared memory: the mode's (kWarpsR x batch
// partials in the Lanczos form).
template <typename T, int KH, bool ALIGNED, typename Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocksR)
banded_spmm_kernel(const T* __restrict__ diags, Offsets1D offs, long long n,
                   long long blo, long long bhi, int zc, Mode md) {
  extern __shared__ __align__(16) unsigned char spmm_smem[];
  __shared__ int o_sh[kMaxPoints];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) o_sh[j] = offs.o[j];
  md.begin(spmm_smem);
  __syncthreads();
  banded_segments<T, KH, ALIGNED>(diags, o_sh, k, zc, n, blo, bhi, md);
  md.end();
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
// kernel does not check there: check_banded).
template <typename T>
int launch_banded_spmv(const BandedLaunch* p, const T* x, T* y,
                       cudaStream_t stream) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const long long n = p->n, blo = p->blo, bhi = p->bhi;
  const Offsets1D& o = p->offs;
  const int e = check_banded(n, blo, bhi, o, R);
  if (e) return e;
  const long long grid = (n + R - 1) / R;
  const T* diags = static_cast<const T*>(p->diags);
  if (aligned16(diags) && n % (16 / sizeof(T)) == 0)
    banded_spmv_kernel<T, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        diags, o, x, n, blo, bhi, y);
  else
    banded_spmv_kernel<T, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        diags, o, x, n, blo, bhi, y);
  return (int)cudaGetLastError();
}

// K1: B7's checks, then the segments' grid.
template <typename T>
int launch_banded_spmm(const BandedLaunch* p, const T* X, T* Y, int batch,
                       cudaStream_t stream) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const long long n = p->n;
  const int e = check_banded(n, p->blo, p->bhi, p->offs, R);
  if (e) return e;
  if (batch < 1) return (int)cudaErrorInvalidValue;
  const T* diags = static_cast<const T*>(p->diags);
  const SpmmPlain<T> md{X, Y, n, batch};
  const bool al = aligned16(diags) && aligned16(X) && aligned16(Y) &&
                  n % (16 / sizeof(T)) == 0;
  return banded_dispatch(p->offs.k, [&](auto kh) -> int {
    constexpr int KH = decltype(kh)::value;
    const void* fn = al ? (const void*)banded_spmm_kernel<T, KH, true, SpmmPlain<T>>
                        : (const void*)banded_spmm_kernel<T, KH, false, SpmmPlain<T>>;
    int grid = 0;
    const int g = segment_grid(fn, n, R, &grid);
    if (g) return g;
    if (al)
      banded_spmm_kernel<T, KH, true><<<grid, kThreads, 0, stream>>>(
          diags, p->offs, n, p->blo, p->bhi, -1, md);
    else
      banded_spmm_kernel<T, KH, false><<<grid, kThreads, 0, stream>>>(
          diags, p->offs, n, p->blo, p->bhi, -1, md);
    return (int)cudaGetLastError();
  });
}

// K1's Lanczos form: the grid the descriptor's query chose (the partials
// were sized for it).
template <typename T>
int launch_banded_spmm_alpha(const LanczosLaunch* p, cudaStream_t stream) {
  const int e = check_lanczos<T>(*p);
  if (e) return e;
  if (p->grid_alpha < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kWarpsR * p->batch * sizeof(T);
  const T* diags = static_cast<const T*>(p->diags);
  const SpmmLanczos<T> md = SpmmLanczos<T>::make(*p);
  const bool al = lanczos_aligned<T>(*p);
  return banded_dispatch(p->offs.k, [&](auto kh) -> int {
    constexpr int KH = decltype(kh)::value;
    if (al)
      banded_spmm_kernel<T, KH, true><<<p->grid_alpha, kThreads, smem, stream>>>(
          diags, p->offs, p->n, p->blo, p->bhi, p->zc, md);
    else
      banded_spmm_kernel<T, KH, false><<<p->grid_alpha, kThreads, smem, stream>>>(
          diags, p->offs, p->n, p->blo, p->bhi, p->zc, md);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int spmm_alpha_grid(LanczosLaunch* p) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const bool al = lanczos_aligned<T>(*p);
  return banded_dispatch(p->offs.k, [&](auto kh) -> int {
    constexpr int KH = decltype(kh)::value;
    const void* fn = al ? (const void*)banded_spmm_kernel<T, KH, true, SpmmLanczos<T>>
                        : (const void*)banded_spmm_kernel<T, KH, false, SpmmLanczos<T>>;
    return segment_grid(fn, p->n, R, &p->grid_alpha);
  });
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
  extern "C" int eu_banded_spmm_alpha_##SUF(const eu::LanczosLaunch* p,           \
                                            void* stream) {                          \
    return eu::launch_banded_spmm_alpha<T>(p, (cudaStream_t)stream);                 \
  }                                                                                  \
  extern "C" int eu_banded_spmm_alpha_grid_##SUF(eu::LanczosLaunch* p) {             \
    return eu::spmm_alpha_grid<T>(p);                                                \
  }                                                                                  \
  extern "C" int eu_blockell_spmv_##SUF(const T* blocks, const int* bcols,           \
                                        const T* x, long long nbr, int w, int br,    \
                                        int bc, T* y, void* stream) {                \
    return eu::launch_blockell_spmv<T>(blocks, bcols, x, nbr, w, br, bc, y,          \
                                       (cudaStream_t)stream);                        \
  }

EU_SPMV_API(float, f32)
EU_SPMV_API(double, f64)

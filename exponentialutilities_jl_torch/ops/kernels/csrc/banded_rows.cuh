// The banded product over a block of batch rows, shared by K1
// (csrc/spmv.cu: banded_spmm_kernel in its plain and its Lanczos form) and
// K5 (csrc/lanczos_step.cu): the 16-byte pieces, the row-streaming body
// and the fixed-order reduction of per-row partials across a launch.
//
// Geometry (module notes of spmv.cu and lanczos_step.cu). A segment is
// R = kThreads V rows, V = 16 / sizeof(T), thread t of a block owning
// rows i0 .. i0 + V - 1 of it; segments in [blo, bhi) are interior (every
// x read i + o lies in [0, n), ops/kernels/spmv.banded_interior), the
// others check each read. A block walks the segments s = blockIdx.x,
// blockIdx.x + gridDim.x, ...; in each it loads the pieces of the k = KH
// diagonals once into registers and streams the batch rows past them, one
// row's k x values (x_q for q = i + o_j) then its k FMAs in offset order:
// a row's sum is B7's, term for term, so its bits are a B7 launch's on that
// row.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace eu {

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

// The 16-byte piece at a p that may not be 16-byte aligned, as V scalar
// loads (the values of one vector load). EVICT: a stream read once.
template <typename T, bool EVICT>
__device__ __forceinline__ typename Piece16<T>::type load_scalars(const T* p) {
  typename Piece16<T>::type v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int u = 0; u < (int)(16 / sizeof(T)); ++u) e[u] = EVICT ? __ldcs(p + u) : __ldg(p + u);
  return v;
}

constexpr int kGroupR = 4;      // KH = 0: diagonals whose loads precede their FMAs
constexpr int kWarpsR = kThreads / 32;
constexpr int kMinBlocksR = 3;  // blocks an SM the row kernels are built for

// One thread's V values of a length-n vector at rows i0 .., zero past n.
// EVICT: evict-first (a stream read once); else through the read-only
// path (re-read by other rows or blocks).
template <typename T, bool ALIGNED, bool INTERIOR, bool EVICT>
__device__ __forceinline__ void load_own(const T* p, long long i0, long long n,
                                         T (&e)[16 / sizeof(T)]) {
  using P = Piece16<T>;
  using VT = typename P::type;
  constexpr int V = 16 / sizeof(T);
  if constexpr (INTERIOR && ALIGNED) {
    P::split(EVICT ? __ldcs(reinterpret_cast<const VT*>(p + i0))
                   : __ldg(reinterpret_cast<const VT*>(p + i0)), e);
  } else if constexpr (INTERIOR) {
    P::split(load_scalars<T, EVICT>(p + i0), e);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      e[v] = i0 + v < n ? (EVICT ? __ldcs(p + i0 + v) : __ldg(p + i0 + v)) : T(0);
  }
}

// x_{i + o} for the V rows i0 .. of one thread, zero where i >= n or
// i + o leaves [0, n) (edge segments). An interior read whose offset keeps
// the 16-byte alignment is one vector load: the same values.
template <typename T, bool ALIGNED, bool INTERIOR>
__device__ __forceinline__ void load_x(const T* xr, long long i0, int o, long long n,
                                       T (&e)[16 / sizeof(T)]) {
  using P = Piece16<T>;
  using VT = typename P::type;
  constexpr int V = 16 / sizeof(T);
  if constexpr (INTERIOR) {
    if (ALIGNED && (o & (V - 1)) == 0) {
      P::split(__ldg(reinterpret_cast<const VT*>(xr + i0 + o)), e);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) e[v] = __ldg(xr + i0 + o + v);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long i = i0 + v, q = i + o;
      e[v] = (i < n && q >= 0 && q < n) ? __ldg(xr + q) : T(0);
    }
  }
}

// V values stored at rows i0 .. of a length-n vector (rows past n skipped).
template <typename T, bool ALIGNED, bool INTERIOR>
__device__ __forceinline__ void store_own(T* p, long long i0, long long n,
                                          const T (&e)[16 / sizeof(T)]) {
  using P = Piece16<T>;
  using VT = typename P::type;
  constexpr int V = 16 / sizeof(T);
  if constexpr (INTERIOR && ALIGNED) {
    *reinterpret_cast<VT*>(p + i0) = P::join(e);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (i0 + v < n) p[i0 + v] = e[v];
  }
}

// The rows of one segment: for each batch row r that `md` does not skip,
// acc = sum_j D[j, i] x_r[i + o_j] in offset order (one FMA a term), xc =
// x_r at offset 0 (valid where zc >= 0: the index of the zero offset), then
// md.out(r, i0, acc, xc). Mode `md` (a struct of the kernel) supplies the
// batch, skip(r) / skipped(r, i0), x(r) (row r's vector) and scale(r) (x is
// read times scale(r) where md.kScaled), and out. KH > 0: exactly KH
// diagonals, their pieces held in registers while the rows stream past;
// KH = 0: any k, kGroupR at a time, the pieces re-read through L1 for each
// row (the launchers pick KH from k: banded_dispatch).
template <typename T, int KH, bool ALIGNED, bool INTERIOR, typename Mode>
__device__ __forceinline__ void banded_rows(const T* __restrict__ diags,
                                            const int* o_sh, int k, int zc,
                                            long long n, long long i0, Mode& md) {
  using P = Piece16<T>;
  constexpr int V = 16 / sizeof(T);
  if constexpr (KH > 0) {
    T d[KH][V];
#pragma unroll
    for (int g = 0; g < KH; ++g)
      load_own<T, ALIGNED, INTERIOR, true>(diags + (long long)g * n, i0, n, d[g]);
#pragma unroll 1
    for (int r = 0; r < md.batch; ++r) {
      if (md.skip(r)) {
        md.template skipped<ALIGNED, INTERIOR>(r, i0);
        continue;
      }
      const T* xr = md.x(r);
      T xv[KH][V];
#pragma unroll
      for (int g = 0; g < KH; ++g) load_x<T, ALIGNED, INTERIOR>(xr, i0, o_sh[g], n, xv[g]);
      T acc[V], xc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = xc[v] = T(0);
      const T s = Mode::kScaled ? md.scale(r) : T(1);
#pragma unroll
      for (int g = 0; g < KH; ++g) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const T xs = Mode::kScaled ? xv[g][v] * s : xv[g][v];
          acc[v] = P::fma1(d[g][v], xs, acc[v]);
          if (g == zc) xc[v] = xs;
        }
      }
      md.template out<ALIGNED, INTERIOR>(r, i0, acc, xc);
    }
  } else {
#pragma unroll 1
    for (int r = 0; r < md.batch; ++r) {
      if (md.skip(r)) {
        md.template skipped<ALIGNED, INTERIOR>(r, i0);
        continue;
      }
      const T* xr = md.x(r);
      const T s = Mode::kScaled ? md.scale(r) : T(1);
      T acc[V], xc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = xc[v] = T(0);
#pragma unroll 1
      for (int j0 = 0; j0 < k; j0 += kGroupR) {
        T d[kGroupR][V], xv[kGroupR][V];
#pragma unroll
        for (int g = 0; g < kGroupR; ++g) {
          if (j0 + g < k) {
            load_own<T, ALIGNED, INTERIOR, false>(diags + (long long)(j0 + g) * n, i0, n, d[g]);
            load_x<T, ALIGNED, INTERIOR>(xr, i0, o_sh[j0 + g], n, xv[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroupR; ++g) {
          if (j0 + g < k) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const T xs = Mode::kScaled ? xv[g][v] * s : xv[g][v];
              acc[v] = P::fma1(d[g][v], xs, acc[v]);
              if (j0 + g == zc) xc[v] = xs;
            }
          }
        }
      }
      md.template out<ALIGNED, INTERIOR>(r, i0, acc, xc);
    }
  }
}

// Segments of a launch: s = blockIdx.x, + gridDim.x, ... over the
// ceil(n / R) segments, each interior one ([blo, bhi)) without checks.
// Every thread of the block runs every segment (a thread whose rows lie
// past n reads and adds zeros), so modes may use warp shuffles.
template <typename T, int KH, bool ALIGNED, typename Mode>
__device__ __forceinline__ void banded_segments(const T* __restrict__ diags,
                                                const int* o_sh, int k, int zc,
                                                long long n, long long blo,
                                                long long bhi, Mode& md) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const long long nseg = (n + R - 1) / R;
  for (long long s = blockIdx.x; s < nseg; s += gridDim.x) {
    const long long i0 = s * R + (long long)threadIdx.x * (16 / sizeof(T));
    if (s >= blo && s < bhi)                     // uniform in the block
      banded_rows<T, KH, ALIGNED, true>(diags, o_sh, k, zc, n, i0, md);
    else
      banded_rows<T, KH, ALIGNED, false>(diags, o_sh, k, zc, n, i0, md);
  }
}

// The held-diagonal counts that have their own instantiations (the
// 1-D Laplacian and advection stencils, config #3's 2-D Poisson); any
// other k takes KH = 0. f(std::integral_constant<int, KH>{}) is called.
template <typename F>
__host__ inline auto banded_dispatch(int k, F f) {
  if (k == 3) return f(std::integral_constant<int, 3>{});
  if (k == 5) return f(std::integral_constant<int, 5>{});
  return f(std::integral_constant<int, 0>{});
}

// Per-row partial sums of a launch, in a fixed order (no float atomics):
// each thread's term for row r goes through the warp's shuffle tree, lane
// 0 adds it to red[warp][r] (one row of shared memory a warp, segments in
// the block's order); at the block's end the warps' rows are summed in
// warp order into partial[blockIdx.x][r].
template <typename T>
__device__ __forceinline__ void warp_partial(T* red, int batch, int r, T p) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) p += __shfl_down_sync(0xffffffffu, p, s);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * batch + r] += p;
}

template <typename T>
__device__ __forceinline__ void clear_partials(T* red, int batch) {
  for (int i = threadIdx.x; i < kWarpsR * batch; i += kThreads) red[i] = T(0);
  __syncthreads();
}

// The block's partials out, then a ticket: true in the launch's last block
// only (which then reads every block's partials and resets the ticket for
// the next launch, so a graph replay finds it at 0).
template <typename T>
__device__ __forceinline__ bool publish_partials(const T* red, int batch,
                                                 T* partial, int* ticket) {
  __shared__ int last;
  __syncthreads();
  for (int r = threadIdx.x; r < batch; r += kThreads) {
    T s = red[r];
    for (int w = 1; w < kWarpsR; ++w) s += red[w * batch + r];
    partial[(long long)blockIdx.x * batch + r] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// In the last block: row r's total over the launch's blocks, in block
// order within a lane (lane l takes blocks l, l + 32, ...) and the shuffle
// tree across lanes; warp w takes rows w, w + kWarpsR, ... Lane 0 gets the
// total and calls fin(r, total).
template <typename T, typename Fin>
__device__ __forceinline__ void reduce_partials(const T* partial, int batch,
                                                int* ticket, Fin fin) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < batch; r += kWarpsR) {
    T a = T(0);
#pragma unroll 4
    for (int b = lane; b < (int)gridDim.x; b += 32)
      a += __ldcg(partial + (long long)b * batch + r);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) a += __shfl_down_sync(0xffffffffu, a, s);
    if (lane == 0) fin(r, a);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// What every launch of the fused batched Lanczos step on one matrix and
// one state shares (ops/kernels/lanczos_step.py LanczosPair, whose ctypes
// mirror is _LanczosLaunch), built once before the loop. The step index j
// is read from jj[0] on the device, so a captured pair replays step after
// step. Vectors (all (batch, n) rows of stride `urow`/`vrow`):
//   u      the next vector before its normalization (v_0 at j = 0);
//   v      the slots: vc_j at v + r vrow + slot(j) vslot, slot(j) = j (a
//          basis, nslots = 0) or j mod nslots (a ring of 2);
//   alpha  (batch,) K1's Lanczos form -> K5;  scale (batch,) 1 / |u|;
//   bprev, broke (bool bytes), m_used (int64), alphas, betas (batch, m):
//          the builder's state, as _lanczos_step keeps it;
//   partial (grid, batch) and ticket (2 ints): the launches' scratch.
struct LanczosLaunch {
  const void* diags;
  long long n, blo, bhi;
  Offsets1D offs;
  void* u;
  void* v;
  long long urow, vrow, vslot;
  int nslots, batch, m, zc;
  void* alpha;
  void* scale;
  void* bprev;
  unsigned char* broke;
  long long* m_used;
  void* alphas;
  void* betas;
  void* partial;
  int* ticket;
  const long long* jj;
  double tol;
  int grid_alpha, grid_update;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Refused unless every x read of the interior segments [blo, bhi) lies in
// [0, n) (B7's check).
inline int check_banded(long long n, long long blo, long long bhi,
                        const Offsets1D& o, long long R) {
  if (n < 1 || o.k < 1 || o.k > kMaxPoints || blo < 0 || bhi < blo)
    return (int)cudaErrorInvalidValue;
  if ((n + R - 1) / R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bhi > blo) {
    int lo = o.o[0], hi = o.o[0];
    for (int j = 1; j < o.k; ++j) {
      lo = lo < o.o[j] ? lo : o.o[j];
      hi = hi > o.o[j] ? hi : o.o[j];
    }
    if (blo * R + lo < 0 || bhi * R + (hi > 0 ? hi : 0) > n)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The segments' grid of a K1 or K5 instantiation: one block a segment, at
// most as many as the card holds at once (the blocks then stride over the
// segments; the last block's sum reads one partial a block).
inline int segment_grid(const void* fn, long long n, long long R, int* grid) {
  const int cap = max_coresident_blocks(fn);
  if (cap <= 0) return cap == 0 ? (int)cudaErrorInvalidConfiguration : -cap;
  const long long nseg = (n + R - 1) / R;
  *grid = (int)(nseg < cap ? nseg : cap);
  return 0;
}

// The fused step's operands line up for 16-byte pieces: every row and slot
// start on a 16-byte boundary.
template <typename T>
bool lanczos_aligned(const LanczosLaunch& p) {
  constexpr long long V = 16 / sizeof(T);
  return aligned16(p.diags) && aligned16(p.u) && aligned16(p.v) && p.n % V == 0 &&
         p.urow % V == 0 && p.vrow % V == 0 && p.vslot % V == 0;
}

// Checks of a fused-step descriptor (K1's Lanczos form and K5): B7's, a
// batch whose partials fit the default shared memory, the slots' layout.
template <typename T>
int check_lanczos(const LanczosLaunch& p) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const int e = check_banded(p.n, p.blo, p.bhi, p.offs, R);
  if (e) return e;
  if (p.batch < 1 || (size_t)kWarpsR * p.batch * sizeof(T) > 48 * 1024 || p.m < 1 ||
      p.nslots < 0 || p.zc >= p.offs.k || (p.zc >= 0 && p.offs.o[p.zc] != 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

__host__ __device__ inline long long lanczos_slot(const LanczosLaunch& p, long long j) {
  return p.nslots ? j % p.nslots : j;
}

}  // namespace eu

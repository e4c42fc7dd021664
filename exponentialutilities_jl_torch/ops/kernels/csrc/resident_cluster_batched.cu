// K3, B2's batched form (pass 1 of expv_batched's 1-D two-pass): the (m, 2)
// Lanczos record of every row of v0 (batch, n) in ONE launch of
// thread-block clusters, P rows to a cluster.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_lanczos_kernel  (B2, resident.py:461) under JAX's vmap
//
// B2's cluster form (csrc/resident_cluster.cu) runs one row on a cluster of
// C = 16 blocks of 1024 threads, u_k and y_k of a thread's R rows in
// registers. One cluster a row needs batch x C SMs, and a 16-block cluster
// needs a GPC with 16 free SMs: the H100 holds fewer than eight such
// clusters at once, so 8 rows ran in two waves of B2 (0.386 ms on the
// device against 0.190 for one row). Halving C instead doubles the rows a
// block owns, past what the registers hold in float64.
//
// Here a cluster carries P rows (P = 2 or 4; P = 1 is B2's kernel itself,
// launched over batch x C blocks): block r of the cluster owns the same
// slab [r L, (r + 1) L) of each of its rows, with B2's C and L, so each row
// keeps B2's slab split, B2's rows a thread (i = q 1024 + t) and B2's
// fixed-order sums, and its record is bit for bit B2's on that row. The
// cluster reduces its 2 P moments together: each block writes one slot of
// 2 P values into every block's shared memory, and ONE cluster barrier a
// pass serves every row. State placement: y_k and y_{k-1} of every row in
// shared memory (2 P spans of L + 2h; 200 KB at P = 2, L = 6250, float64),
// u_k of every row in registers (P R values a thread: 2 x 7 in float64).
// A pass therefore reads y_{k-1} and y_k from shared memory where B2 keeps
// y_k in a register: about 7 shared accesses a row against B2's 5, paid
// once for the P rows' barrier. The registers are the limit (64 a thread
// at 1024 threads; spills go to L2, since the shared memory leaves L1
// ~27 KB): each moment's warp sum goes to shared memory as it is made,
// and the per-row scalars (ca, cb, cc and the breakdown state) live in
// shared memory, computed after the cluster barrier by warp p for row p
// (B2 has every warp compute them, a third of its pass, clock-stamped on
// the H100) and published by one more block barrier.
//
// What bounds it: as B2, the latency of a pass (two block barriers, the
// cluster barrier, the butterflies), now shared by P rows, plus P times
// B2's shared-memory traffic. The plan (resident.LanczosPlan, through
// resident.cluster_batch_geometry) takes the smallest P whose
// ceil(batch / P) clusters the card holds at once (its
// cudaOccupancyMaxActiveClusters answer), so a batch of 8 rows of 1e5 runs
// as one wave.
//
// Pass k (par = k & 1), for each row p of the cluster:
//   y_k   own rows from (u_{k-1}) in registers and (y_{k-1}, y_{k-2}) in
//         shared memory, into y_{k-2}'s span; halo rows from the
//         neighbours' pub[p][par ^ 1]
//   --- block barrier ---
//   u_k = A y_k, the moments; the edge rows' (u_k, y_k, y_{k-1}) -> pub[p][par]
//   2 P moments -> parts[par][.][rank] of every block
//   === cluster barrier ===
//   scalars of row p from parts[par] by warp p
//   --- block barrier ---
// The parity argument of B2 holds for each row's pub and for parts.
#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace eu {

// u_k values a thread keeps in registers over its P rows: 7 rows of each
// of two rows in float64 (L <= 7168: config #2's L = 6250), 16 in float32;
// more spilled past the 64 registers a thread has
template <typename T>
constexpr int kRowRegs = sizeof(T) == 8 ? 14 : 32;

// Dynamic shared memory of a block: per row, two y spans of L + 2h and the
// published edges pub[2][2 sides][3][h].
template <typename T>
inline size_t rows_smem(const LanczosLaunch& L, int P) {
  const size_t h = (size_t)halo_of(L);
  return (size_t)P * (2 * ((size_t)L.rows + 2 * h) + 12 * h) * sizeof(T);
}

template <typename T, int P, int K>
__global__ void __launch_bounds__(kClusterThreads, 1)
resident_lanczos_cluster_rows_kernel(const T* __restrict__ v0,
                                     const __grid_constant__ LanczosLaunch L, int m, T tol,
                                     T* __restrict__ ab, int batch) {
  constexpr int R = kRowRegs<T> / P;   // rows of one batch row a thread
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_rows[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T red[2 * P * 32];
  __shared__ T parts[2][2 * P][16];   // [pass parity][2 p: ypy, 2 p + 1: yzy][rank]
  // row p's scalars: ca, cb, cc (y_{k+1} = ca u_k + cb y_k + cc y_{k-1}),
  // inv, beta_prev; and whether it is alive
  __shared__ T sc[P][5];
  __shared__ int alive_sh[P];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rank = (int)cl.block_rank();
  const int C = L.cluster, k = K > 0 ? K : L.k;
  const long long c = blockIdx.x / C;          // cluster c records rows c P + p
  const int live = (int)(batch - c * P < P ? batch - c * P : P);
  v0 += c * P * L.n;
  ab += c * P * 2 * (long long)m;
  const int rows = (int)L.rows;
  const long long n = L.n, lo = (long long)rank * rows;
  const int len = (int)(n - lo < rows ? (n - lo > 0 ? n - lo : 0) : rows);
  const int h = halo_of(L);
  const int span = rows + 2 * h;
  const int stride = 2 * span + 12 * h;   // a row's shared memory
  // row p: spans y[p][0], y[p][1] (span index h + i is local row i), then
  // pub[par][side][what][h]: side 0 the first h rows, 1 the last h; what 0
  // u_k, 1 y_k, 2 y_{k-1}
  T* base = reinterpret_cast<T*>(smem_rows);
  RowStencil<T, K> st;
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      st.c[j] = static_cast<const T*>(L.cvals)[j];
      st.o[j] = L.o[j];
    }
  }
  for (int j = t; j < k; j += kClusterThreads) {
    c_sh[j] = static_cast<const T*>(L.cvals)[j];
    o_sh[j] = L.o[j];
  }
  if (t < P) {
    sc[t][0] = sc[t][1] = sc[t][2] = T(0);
    sc[t][3] = T(1);
    sc[t][4] = T(0);
    alive_sh[t] = 1;
  }
  const T* pl = rank > 0 ? cl.map_shared_rank(base, rank - 1) : nullptr;
  const T* pr = rank + 1 < C ? cl.map_shared_rank(base, rank + 1) : nullptr;

  T ur[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < live) {   // y_0 = v0, y_{-1} = 0
      T* y0 = base + p * stride;
      for (int i = t - h; i < len + h; i += kClusterThreads) {
        const long long q = lo + i;
        y0[h + i] = q >= 0 && q < n ? v0[p * n + q] : T(0);
        if (i >= 0 && i < len) y0[span + h + i] = T(0);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) ur[p][r] = T(0);
  }
  __syncthreads();
  cl.sync();   // every block runs before any DSMEM store

  int cur = 0;   // y_k of the pass is y[p][cur], y_{k-1} y[p][cur ^ 1]
  for (int pass = 0; m > 0 && pass <= m; ++pass) {
    const int par = pass & 1;
    if (pass > 0) {
      // y_k into the span of y_{k-2}, own rows in place; the halo rows from
      // the neighbours' edges of pass k - 1
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p >= live) continue;
        const T ca = sc[p][0], cb = sc[p][1], cc = sc[p][2];
        const T* yc = base + p * stride + cur * span;
        T* yp = base + p * stride + (cur ^ 1) * span;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * kClusterThreads + t;
          if (i < len) yp[h + i] = row_y(ca, cb, cc, ur[p][r], yc[h + i], yp[h + i]);
        }
      }
      // halo row e of row p by thread p 2h + e: the rows' remote reads in
      // parallel
      for (int s = t; s < 2 * h * live; s += kClusterThreads) {
        const int p = s / (2 * h), e = s - p * 2 * h;
        const T ca = sc[p][0], cb = sc[p][1], cc = sc[p][2];
        T* yp = base + p * stride + (cur ^ 1) * span;
        const size_t pub = (size_t)p * stride + 2 * span;
        const int q = par ^ 1;
        if (e < h) {                                   // row lo - h + e
          if (pl == nullptr || lo - h + e < 0) continue;
          const T* src = pl + pub + (q * 2 + 1) * 3 * h;   // its last h rows
          yp[e] = row_y(ca, cb, cc, src[e], src[h + e], src[2 * h + e]);
        } else {                                       // row lo + L + j
          const int j = e - h;
          if (pr == nullptr || lo + rows + j >= n) continue;
          const T* src = pr + pub + (q * 2 + 0) * 3 * h;   // its first h rows
          yp[h + rows + j] = row_y(ca, cb, cc, src[j], src[h + j], src[2 * h + j]);
        }
      }
      cur ^= 1;
      __syncthreads();
    }
    // u_k = A y_k and the moments; the edges' (u_k, y_k, y_{k-1}) -> pub;
    // each moment's warp sum -> red (B2's block_total2, by values)
    const bool stencil = pass < m;   // the last pass needs beta_{m-1} only
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T ypy = T(0), yzy = T(0);
      if (p < live) {
        const T* yc = base + p * stride + cur * span;
        const T* yp = base + p * stride + (cur ^ 1) * span;
        T* pub = base + p * stride + 2 * span;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * kClusterThreads + t;
          if (i >= len) continue;
          const T y = yc[h + i];
          ypy = fma_rn(y, y, ypy);
          if (!stencil) continue;
          T z = T(0);
          if (i >= h && i < len - h) {   // interior: every read is the block's own
            if constexpr (K > 0) {
#pragma unroll
              for (int j = 0; j < K; ++j) z = fma_rn(st.c[j], yc[h + i + st.o[j]], z);
            } else {
              for (int j = 0; j < k; ++j) z = fma_rn(c_sh[j], yc[h + i + o_sh[j]], z);
            }
          } else {
            for (int j = 0; j < k; ++j) {
              const long long qq = lo + i + o_sh[j];
              if (qq < 0 || qq >= n) continue;   // Dirichlet: row outside [0, n)
              z = fma_rn(c_sh[j], yc[h + i + o_sh[j]], z);
            }
          }
          ur[p][r] = z;
          yzy = fma_rn(y, z, yzy);
          if (i < h) {
            T* d = pub + (par * 2 + 0) * 3 * h;
            d[i] = z;
            d[h + i] = y;
            d[2 * h + i] = yp[h + i];
          }
          if (i >= len - h && len == rows) {   // a right neighbour may read these
            T* d = pub + (par * 2 + 1) * 3 * h;
            const int e = i - (len - h);
            d[e] = z;
            d[h + e] = y;
            d[2 * h + e] = yp[h + i];
          }
        }
      }
      ypy = warp_total(ypy);
      yzy = warp_total(yzy);
      if (lane == 0) {
        red[32 * (2 * p) + warp] = ypy;
        red[32 * (2 * p + 1) + warp] = yzy;
      }
    }
    __syncthreads();
    if (warp < 2 * P) {   // warp v: moment v's block sum, into slot rank of every block
      const T tot = warp_total(red[32 * warp + lane]);
      if (lane < C) *cl.map_shared_rank(&parts[par][warp][rank], lane) = tot;
    }
    cl.sync();   // the pass's barrier: moments and edges are everywhere
    if (warp < live) {   // warp p: row p's scalars, into the block's copy
      const int p = warp;
      const T sy = warp_total(lane < C ? parts[par][2 * p][lane] : T(0));
      const T sz = warp_total(lane < C ? parts[par][2 * p + 1][lane] : T(0));
      T inv = sc[p][3], beta_prev = sc[p][4];
      bool alive = alive_sh[p];
      const T inv_prev = inv;
      T* rec = ab + p * 2 * (long long)m;
      const bool rec0 = rank == 0 && lane == 0;
      if (pass > 0) {   // beta_{k-1} = |y_k|
        const T beta = sqrt(sy > T(0) ? sy : T(0));
        const bool ok = alive && (beta >= tol);
        if (rec0) rec[2 * (pass - 1) + 1] = ok ? beta : T(0);
        inv = ok ? T(1) / (beta > T(0) ? beta : T(1)) : T(0);   // 0 after a breakdown
        beta_prev = ok ? beta : T(0);
        alive = ok;
      }
      __syncwarp();   // every lane has read the block's copy
      if (lane == 0) {
        if (pass < m) {
          const T alpha = inv * (inv * sz);   // v_k . A v_k
          if (rank == 0) rec[2 * pass] = alive ? alpha : T(0);
          sc[p][0] = inv;
          sc[p][1] = -alpha * inv;
          sc[p][2] = -beta_prev * inv_prev;   // beta_{-1} = 0
        }
        sc[p][3] = inv;
        sc[p][4] = beta_prev;
        alive_sh[p] = alive;
      }
    }
    __syncthreads();   // the scalars are written before the next pass reads them
  }
  cl.sync();   // no block leaves while another may read its shared memory
}

template <typename T, int P, int K>
static cudaError_t prepare_rows(size_t smem) {   // static: one flag per library
  static size_t allowed = 0;
  static bool nonportable = false;
  const void* fn = (const void*)resident_lanczos_cluster_rows_kernel<T, P, K>;
  if (!nonportable) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable = true;
  }
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  return cudaSuccess;
}

static cudaLaunchConfig_t rows_config(const LanczosLaunch& L, size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* attr, int clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.cluster * clusters);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = L.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of this geometry the card holds at once (0: a block's rows or
// shared memory do not fit); negative: a CUDA error.
template <typename T, int P, int K>
int rows_fits(const LanczosLaunch& L) {
  if ((long long)(kRowRegs<T> / P) * kClusterThreads < L.rows) return 0;
  const size_t smem = rows_smem<T>(L, P);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, (const void*)resident_lanczos_cluster_rows_kernel<T, P, K>);
  if (e != cudaSuccess) return -(int)e;
  if (smem + fa.sharedSizeBytes > (size_t)optin) return 0;
  e = prepare_rows<T, P, K>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = rows_config(L, smem, 0, &attr, 1);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(
      &count, (const void*)resident_lanczos_cluster_rows_kernel<T, P, K>, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return count;
}

template <typename T, int P, int K>
int launch_rows(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab, int batch,
                cudaStream_t stream) {
  if ((long long)(kRowRegs<T> / P) * kClusterThreads < L.rows) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem<T>(L, P);
  cudaError_t e = prepare_rows<T, P, K>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = rows_config(L, smem, stream, &attr, (batch + P - 1) / P);
  e = cudaLaunchKernelEx(&cfg, resident_lanczos_cluster_rows_kernel<T, P, K>, v0, L, m, tol, ab,
                         batch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// P in {2, 4}; 3 and 5 stencil points have their coefficients in
// registers (K), any other count reads them from shared memory (K = 0),
// as in B2.
template <typename T, int P>
int rows_fits_k(const LanczosLaunch& L) {
  return L.k == 3 ? rows_fits<T, P, 3>(L) : L.k == 5 ? rows_fits<T, P, 5>(L)
                                                     : rows_fits<T, P, 0>(L);
}

template <typename T>
int rows_fits_for(const LanczosLaunch& L, int per) {
  return per == 2 ? rows_fits_k<T, 2>(L) : per == 4 ? rows_fits_k<T, 4>(L)
                                                    : -(int)cudaErrorInvalidValue;
}

template <typename T, int P>
int launch_rows_k(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab, int batch,
                  cudaStream_t s) {
  return L.k == 3   ? launch_rows<T, P, 3>(L, v0, m, tol, ab, batch, s)
         : L.k == 5 ? launch_rows<T, P, 5>(L, v0, m, tol, ab, batch, s)
                    : launch_rows<T, P, 0>(L, v0, m, tol, ab, batch, s);
}

template <typename T>
int launch_rows_for(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab, int batch,
                    int per, cudaStream_t s) {
  return per == 2   ? launch_rows_k<T, 2>(L, v0, m, tol, ab, batch, s)
         : per == 4 ? launch_rows_k<T, 4>(L, v0, m, tol, ab, batch, s)
                    : (int)cudaErrorInvalidValue;
}

}  // namespace eu

// eu_lanczos_cluster_rows_fits_*: clusters of `per` rows (2 or 4) of the
// plan's shape the card holds at once (0: they do not fit; negative: a
// CUDA error code). eu_resident_lanczos_cluster_rows_*: K3 with `per` rows
// a cluster, the records of v0 (batch, n) into ab (batch, m, 2); a CUDA
// error code, 0 on success.
#define EU_CLUSTER_ROWS_API(T, SUF)                                                   \
  extern "C" int eu_lanczos_cluster_rows_fits_##SUF(const eu::LanczosLaunch* L,      \
                                                    int per) {                       \
    if (!eu::valid(*L)) return -(int)cudaErrorInvalidValue;                          \
    return eu::rows_fits_for<T>(*L, per);                                            \
  }                                                                                  \
  extern "C" int eu_resident_lanczos_cluster_rows_##SUF(                             \
      const eu::LanczosLaunch* L, const T* v0, int m, T tol, T* ab, int batch,       \
      int per, void* stream) {                                                       \
    if (!eu::valid(*L) || m < 0 || batch < 1 ||                                      \
        (long long)((batch + per - 1) / (per > 0 ? per : 1)) * L->cluster >          \
            0x7fffffffLL)                                                            \
      return (int)cudaErrorInvalidValue;                                             \
    return eu::launch_rows_for<T>(*L, v0, m, tol, ab, batch, per,                    \
                                  (cudaStream_t)stream);                             \
  }

EU_CLUSTER_ROWS_API(float, f32)
EU_CLUSTER_ROWS_API(double, f64)

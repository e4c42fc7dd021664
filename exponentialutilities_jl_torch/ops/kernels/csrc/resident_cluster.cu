// B2, cluster form: Lanczos pass 1 of a 1-D constant stencil on ONE
// thread-block cluster, every state vector on chip.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_lanczos_kernel  (B2, resident.py:461)
// for vectors up to the size where it is the faster form (the plan's
// resident.CLUSTER_MAX_ROWS rows a block: about 131k rows float64, 368k
// float32); the grid form (csrc/resident.cu, resident_lanczos_kernel)
// takes larger ones. The plan (resident.LanczosPlan) picks the form once,
// by size.
//
// What bounds B2 at config #2's n = 1e5: not bytes (the state is 2.4 MB)
// but the synchronisation of its global reductions (alpha, beta). The grid
// form pays three grid-wide barriers a step over ~390 blocks, and every
// block rereads all the partials from L2. Here C = 16 (or 8) blocks of
// 1024 threads hold the whole vector on chip: block r owns rows
// [r L, (r + 1) L), L = ceil(n / C), thread t its rows r 1024 + t (R of
// them, R a power of two), and a Lanczos step costs ONE hardware cluster
// barrier. Past the barriers, what bounds a step is shared-memory traffic:
// each row's u_k and y_k stay in the owning thread's registers, so a row
// costs one store of y_k, one load of y_{k-1} and the stencil's loads.
//
// One barrier a step: the vectors stay unnormalised. Pass k holds y_k with
// v_k = inv_k y_k (inv_0 = 1, y_0 = v0) and computes u_k = A y_k and two
// moments, ypy_k = y_k . y_k = beta_{k-1}^2 and yzy_k = y_k . u_k, reduced
// together (alpha_k = inv_k^2 yzy_k). After the pass's barrier every block
// knows beta_{k-1} and alpha_k, so pass k + 1 forms
//   y_{k+1} = A v_k - alpha_k v_k - beta_{k-1} v_{k-1}
//           = ca u_k + cb y_k + cc y_{k-1}   (row_y, one fused form)
// row by row, and u_{k+1} needs y_{k+1} at max|o| halo rows past each end:
// the block computes them itself, from the (u_k, y_k, y_{k-1}) that each
// neighbour published for its edge rows in pass k (read over DSMEM), with
// the same function and scalars as the owner, so the bits are the owner's.
// m records take m + 1 passes (the last computes beta_{m-1} only).
//
// Partials go through DSMEM: each block stores its two moments into a slot
// of every block's shared memory, and after the barrier every warp sums
// its own block's C slots in rank order with the same butterfly, so the
// scalars are bitwise the same in every block and in every run. (Reading
// the partials remotely instead, every warp of every block from the same
// words, cost about 2.3 us a reduction at C = 16 on the H100:
// sync_bench.cu.)
//
// Pass k (par = k & 1):
//   y_k   own rows from (u_{k-1}, y_{k-1}) in registers and y_{k-2} in
//         shared memory; halo rows from the neighbours' pub[par ^ 1]
//         (written in pass k - 1, before its barrier)
//   --- block barrier ---
//   u_k = A y_k, the moments; the edge rows' (u_k, y_k, y_{k-1}) -> pub[par]
//   moments -> parts[par][rank] of every block
//   === cluster barrier ===
//   scalars from own parts[par]
// pub[par] and parts[par] are rewritten in pass k + 2, after the barrier of
// pass k + 1, which every reader of pass k's values reached after reading
// them. A first barrier lets every block start before any DSMEM store, a
// last one keeps every block alive until no block reads its memory.
// K3, B2's batched form (pass 1 of expv_batched's 1-D two-pass), where it
// takes one row a cluster (resident.cluster_batch_geometry's P = 1: the
// card holds the batch's clusters at once, or no P does): the same kernel
// over a grid of batch x C blocks in clusters of C, cluster c recording row
// c of v0 (batch, n) into its (m, 2) slice of ab. The clusters never wait
// on each other (every barrier and DSMEM access is within a cluster), so
// the card runs as many clusters at once as it holds and queues the rest.
// Each row runs B2's arithmetic on the cluster's geometry, so its record
// is bit for bit a B2 launch's on that row. Clusters of two or four rows:
// csrc/resident_cluster_batched.cu.
#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace eu {

// Dynamic shared memory of a block: two y spans of L + 2h (own rows and
// halo rows) and the published edges pub[2][2 sides][3][h].
inline size_t cluster_smem(const LanczosLaunch& L, size_t itemsize) {
  const size_t h = (size_t)halo_of(L);
  return (2 * (size_t)L.rows + 4 * h + 12 * h) * itemsize;
}

// Two block sums in a fixed order, the same bits in every thread. red holds
// two values per warp; the caller keeps a barrier between two uses.
template <typename T>
__device__ __forceinline__ void block_total2(T& a, T& b, T* red) {
  a = warp_total(a);
  b = warp_total(b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = a;
    red[32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = warp_total(red[threadIdx.x & 31]);
  b = warp_total(red[32 + (threadIdx.x & 31)]);
}

template <typename T, int R, int K>
__global__ void __launch_bounds__(kClusterThreads, 1)
resident_lanczos_cluster_kernel(const T* __restrict__ v0, const __grid_constant__ LanczosLaunch L,
                                int m, T tol, T* __restrict__ ab) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T red[64];
  __shared__ T parts[2][2][32];   // [pass parity][ypy, yzy][rank]

  const int t = threadIdx.x;
  const int rank = (int)cl.block_rank();
  const int C = L.cluster, k = K > 0 ? K : L.k;
  {   // K3: cluster c of a batched launch records row c (c = 0: B2)
    const long long c = blockIdx.x / C;
    v0 += c * L.n;
    ab += c * 2 * (long long)m;
  }
  const int rows = (int)L.rows;
  const long long n = L.n, lo = (long long)rank * rows;
  const int len = (int)(n - lo < rows ? (n - lo > 0 ? n - lo : 0) : rows);
  const int h = halo_of(L);
  const int span = rows + 2 * h;
  T* ya = reinterpret_cast<T*>(smem_raw);   // span index h + i is local row i
  T* yb = ya + span;
  // pub[par][side][what][h]: side 0 the first h rows, 1 the last h; what 0
  // u_k, 1 y_k, 2 y_{k-1}
  T* pub = yb + span;
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
  // the halo rows [lo - h, lo) exist where rank > 0, [lo + L, lo + L + h)
  // where those rows are below n (rank + 1 owns them then: h <= L)
  const T* pl = rank > 0 ? cl.map_shared_rank(pub, rank - 1) : nullptr;
  const T* pr = rank + 1 < C ? cl.map_shared_rank(pub, rank + 1) : nullptr;

  // A thread's rows are i = r 1024 + t, r < R; their u_k and y_k stay in
  // registers (the stencil reads other threads' y from yc; the edge rows'
  // y_{k-1} is read back from yp)
  T ur[R], yr[R];
  T* yc = ya;   // y_k of the pass ...
  T* yp = yb;   // ... and y_{k-1}
  for (int i = t - h; i < len + h; i += kClusterThreads) {   // y_0 = v0, y_{-1} = 0
    const long long q = lo + i;
    yc[h + i] = q >= 0 && q < n ? v0[q] : T(0);
    if (i >= 0 && i < len) yp[h + i] = T(0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * kClusterThreads + t;
    yr[r] = i < len ? v0[lo + i] : T(0);
    ur[r] = T(0);
  }
  __syncthreads();
  cl.sync();   // every block runs before any DSMEM store

  T ca = T(0), cb = T(0), cc = T(0);   // y_{k+1} = ca u_k + cb y_k + cc y_{k-1}
  T inv = T(1), beta_prev = T(0);
  bool alive = true;
  for (int pass = 0; m > 0 && pass <= m; ++pass) {
    const int par = pass & 1;
    if (pass > 0) {
      // y_k into the buffer of y_{k-2}, own rows in place; the halo rows
      // from the neighbours' edges of pass k - 1
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * kClusterThreads + t;
        if (i < len) {
          yr[r] = row_y(ca, cb, cc, ur[r], yr[r], yp[h + i]);
          yp[h + i] = yr[r];
        }
      }
      const int q = par ^ 1;
      for (int e = t; e < 2 * h; e += kClusterThreads) {
        if (e < h) {                                   // row lo - h + e
          if (pl == nullptr || lo - h + e < 0) continue;
          const T* src = pl + (q * 2 + 1) * 3 * h;     // its last h rows
          yp[e] = row_y(ca, cb, cc, src[e], src[h + e], src[2 * h + e]);
        } else {                                       // row lo + L + j
          const int j = e - h;
          if (pr == nullptr || lo + rows + j >= n) continue;
          const T* src = pr + (q * 2 + 0) * 3 * h;     // its first h rows
          yp[h + rows + j] = row_y(ca, cb, cc, src[j], src[h + j], src[2 * h + j]);
        }
      }
      T* tmp = yp;
      yp = yc;
      yc = tmp;
      __syncthreads();
    }
    // u_k = A y_k and the moments; the edges' (u_k, y_k, y_{k-1}) -> pub
    T ypy = T(0), yzy = T(0);
    const bool stencil = pass < m;   // the last pass needs beta_{m-1} only
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * kClusterThreads + t;
      if (i >= len) continue;
      const T y = yr[r];
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
      ur[r] = z;
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
    block_total2(ypy, yzy, red);
    if (t < C) {
      *cl.map_shared_rank(&parts[par][0][rank], t) = ypy;
      *cl.map_shared_rank(&parts[par][1][rank], t) = yzy;
    }
    cl.sync();   // the pass's barrier: moments and edges are everywhere
    const int lane = t & 31;
    const T sy = warp_total(lane < C ? parts[par][0][lane] : T(0));
    const T sz = warp_total(lane < C ? parts[par][1][lane] : T(0));
    const T inv_prev = inv;
    if (pass > 0) {   // beta_{k-1} = |y_k|
      const T beta = sqrt(sy > T(0) ? sy : T(0));
      const bool ok = alive && (beta >= tol);
      if (rank == 0 && t == 0) ab[2 * (pass - 1) + 1] = ok ? beta : T(0);
      inv = ok ? T(1) / (beta > T(0) ? beta : T(1)) : T(0);   // 0 after a breakdown
      beta_prev = ok ? beta : T(0);
      alive = ok;
    }
    if (pass < m) {
      const T alpha = inv * (inv * sz);   // v_k . A v_k
      if (rank == 0 && t == 0) ab[2 * pass] = alive ? alpha : T(0);
      ca = inv;
      cb = -alpha * inv;
      cc = -beta_prev * inv_prev;   // beta_{-1} = 0
    }
  }
  cl.sync();   // no block leaves while another may read its shared memory
}

template <typename T, int R, int K>
static cudaError_t prepare(size_t smem) {   // static: one flag per library
  static size_t allowed = 0;
  static bool nonportable = false;
  const void* fn = (const void*)resident_lanczos_cluster_kernel<T, R, K>;
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

static cudaLaunchConfig_t cluster_config(const LanczosLaunch& L, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr,
                                         int batch = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.cluster * batch);
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

// How many clusters of this shape the card can hold at once (0: none, the
// cluster form does not fit); negative: a CUDA error.
template <typename T, int R, int K>
int cluster_fits(const LanczosLaunch& L) {
  const size_t smem = cluster_smem(L, sizeof(T));
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, (const void*)resident_lanczos_cluster_kernel<T, R, K>);
  if (e != cudaSuccess) return -(int)e;
  if (smem + fa.sharedSizeBytes > (size_t)optin) return 0;
  e = prepare<T, R, K>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(L, smem, 0, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, (const void*)resident_lanczos_cluster_kernel<T, R, K>,
                                     &cfg);
  if (e != cudaSuccess) return -(int)e;
  return count;
}

template <typename T, int R, int K>
int launch_cluster(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab,
                   cudaStream_t stream, int batch) {
  const size_t smem = cluster_smem(L, sizeof(T));
  cudaError_t e = prepare<T, R, K>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(L, smem, stream, &attr, batch);
  e = cudaLaunchKernelEx(&cfg, resident_lanczos_cluster_kernel<T, R, K>, v0, L, m, tol, ab);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows a thread: the smallest power of two R with 1024 R >= L, at most 8
// in float64 (16 spill and lose to the grid form) and 32 in float32; the
// plan keeps L within CLUSTER_MAX_ROWS, which these cover. 3 and 5
// stencil points have the coefficients in registers (K), any other count
// reads them from shared memory (K = 0).
template <typename T>
constexpr int kMaxRowsPerThread = sizeof(T) == 8 ? 8 : 32;

template <typename T, int K, int R = 1>
int fits_r(const LanczosLaunch& L) {
  if ((long long)R * kClusterThreads >= L.rows) return cluster_fits<T, R, K>(L);
  if constexpr (R < kMaxRowsPerThread<T>) return fits_r<T, K, 2 * R>(L);
  return 0;   // more rows a block than the form takes
}

template <typename T>
int fits_for(const LanczosLaunch& L) {
  return L.k == 3 ? fits_r<T, 3>(L) : L.k == 5 ? fits_r<T, 5>(L) : fits_r<T, 0>(L);
}

template <typename T, int K, int R = 1>
int launch_r(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab, cudaStream_t s,
             int batch) {
  if ((long long)R * kClusterThreads >= L.rows)
    return launch_cluster<T, R, K>(L, v0, m, tol, ab, s, batch);
  if constexpr (R < kMaxRowsPerThread<T>)
    return launch_r<T, K, 2 * R>(L, v0, m, tol, ab, s, batch);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_for(const LanczosLaunch& L, const T* v0, int m, T tol, T* ab, cudaStream_t s,
               int batch = 1) {
  return L.k == 3   ? launch_r<T, 3>(L, v0, m, tol, ab, s, batch)
         : L.k == 5 ? launch_r<T, 5>(L, v0, m, tol, ab, s, batch)
                    : launch_r<T, 0>(L, v0, m, tol, ab, s, batch);
}

}  // namespace eu

// eu_lanczos_cluster_fits_*: clusters of the plan's shape the card holds at
// once (0: the cluster form does not fit; negative: a CUDA error code).
// eu_resident_lanczos_cluster_*: the (m, 2) record into ab; a CUDA error
// code, 0 on success. eu_resident_lanczos_cluster_batched_*: K3, one
// cluster a row of v0 (batch, n), the records into ab (batch, m, 2).
#define EU_CLUSTER_API(T, SUF)                                                        \
  extern "C" int eu_lanczos_cluster_fits_##SUF(const eu::LanczosLaunch* L) {          \
    if (!eu::valid(*L)) return -(int)cudaErrorInvalidValue;                           \
    return eu::fits_for<T>(*L);                                                       \
  }                                                                                   \
  extern "C" int eu_resident_lanczos_cluster_##SUF(const eu::LanczosLaunch* L,        \
                                                   const T* v0, int m, T tol, T* ab,  \
                                                   void* stream) {                    \
    if (!eu::valid(*L) || m < 0) return (int)cudaErrorInvalidValue;                   \
    return eu::launch_for<T>(*L, v0, m, tol, ab, (cudaStream_t)stream);               \
  }                                                                                   \
  extern "C" int eu_resident_lanczos_cluster_batched_##SUF(                           \
      const eu::LanczosLaunch* L, const T* v0, int m, T tol, T* ab, int batch,        \
      void* stream) {                                                                 \
    if (!eu::valid(*L) || m < 0 || batch < 1 || (long long)batch * L->cluster >       \
        0x7fffffffLL)                                                                 \
      return (int)cudaErrorInvalidValue;                                              \
    return eu::launch_for<T>(*L, v0, m, tol, ab, (cudaStream_t)stream, batch);        \
  }

EU_CLUSTER_API(float, f32)
EU_CLUSTER_API(double, f64)

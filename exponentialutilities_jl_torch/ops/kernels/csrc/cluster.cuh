// What B2's cluster form (csrc/resident_cluster.cu) and K3's rows form
// (csrc/resident_cluster_batched.cu) share: the launch descriptor, the
// warp butterfly whose bits every lane shares, and the row function of
// y_{k+1}, so that the two kernels give the same bits on a row.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace eu {

constexpr int kClusterThreads = 1024;   // threads of a block of the cluster
static_assert(kClusterThreads == 32 * 32, "block_total2 reads one value per warp");

// What a cluster launch reads on the host, built once per plan (mirrored by
// resident._LanczosLaunch).
struct LanczosLaunch {
  const void* cvals;   // k coefficients, in the launch's dtype
  long long n;
  long long rows;      // L: rows a block owns
  int cluster;         // C blocks
  int k;
  int o[kMaxPoints];
};
static_assert(offsetof(LanczosLaunch, n) == 8 && offsetof(LanczosLaunch, rows) == 16 &&
                  offsetof(LanczosLaunch, cluster) == 24 && offsetof(LanczosLaunch, k) == 28 &&
                  offsetof(LanczosLaunch, o) == 32 && sizeof(LanczosLaunch) == 288,
              "LanczosLaunch layout is mirrored by resident._LanczosLaunch");

__host__ __device__ inline int halo_of(const LanczosLaunch& L) {
  int h = 0;
  for (int j = 0; j < L.k; ++j) h = L.o[j] > h ? L.o[j] : (-L.o[j] > h ? -L.o[j] : h);
  return h;
}

inline bool valid(const LanczosLaunch& L) {
  return L.k >= 1 && L.k <= kMaxPoints && L.n >= 1 && L.cluster >= 1 && L.cluster <= 16 &&
         L.rows >= 1 && L.rows <= (1 << 20) && (long long)L.cluster * L.rows >= L.n &&
         halo_of(L) <= L.rows;   // halo rows come from rank r - 1 or r + 1 only
}

// Sum over a warp by butterfly: every lane ends with the same bits (each
// level adds the same two values, in either order).
template <typename T>
__device__ __forceinline__ T warp_total(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// y_{k+1} of one row: ca u_k + cb y_k + cc y_{k-1}. One function for the
// owner's rows and a neighbour's halo rows: the same bits in both.
template <typename T>
__device__ __forceinline__ T row_y(T ca, T cb, T cc, T u, T y, T yp) {
  return fma_rn(ca, u, fma_rn(cb, y, cc * yp));
}

template <typename T, int K>
struct RowStencil {
  T c[K > 0 ? K : 1];
  int o[K > 0 ? K : 1];
};

}  // namespace eu

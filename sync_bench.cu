// The synchronisation costs behind B2's cluster form and B4's neighbour
// form (csrc/resident_cluster.cu, csrc/resident_family.cu), measured alone
// on one card: per step of a loop of m steps, the slope between m = 20
// and m = 120 (each launch timed 10 times with CUDA events).
//
//   cluster C=.. mode=0   two cluster.sync() a step (16 or 8 blocks of 1024)
//           mode=1        + two block sums, every warp of every block
//                           reading the C partials remotely
//           mode=2        + B2-like compute on 6250 (C = 16) rows a block
//   neighbour G=.. mode   flags between neighbouring blocks (256 threads):
//                         bit 0 a __threadfence before the release, bit 1 a
//                         volatile store after a fence instead of
//                         st.release, bit 2 one thread waits for both
//                         neighbours instead of two warps
//   grid.sync G=..        cg::this_grid().sync() alone
//
// Build and run on the card (no arguments, prints one line per case):
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//        -o "$TMPDIR/sync_bench" sync_bench.cu && "$TMPDIR/sync_bench"
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ double warp_total(double v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}
__device__ __forceinline__ double block_total(double v, double* red) {
  v = warp_total(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_total(red[threadIdx.x & 31]);
}

// mode 0: two cluster.sync a step; 1: + block_total + DSMEM partial reads;
// 2: + compute of R rows a thread (phase A/B like B2), no remote halo
template <int R>
__global__ void __launch_bounds__(1024, 1) ck(int m, int mode, int rows, double* out) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ double y[];
  __shared__ double red_a[32], red_b[32], part[2];
  const int t = threadIdx.x;
  for (int i = t; i < 2 * rows; i += 1024) y[i] = 1e-3 * (i % 7);
  cl.sync();
  double alpha = 0, beta = 1, inv = 1;
  const int C = cl.num_blocks();
  for (int s = 0; s < m; ++s) {
    const double* yc = y + (s & 1) * rows;
    double* yp = y + ((s & 1) ^ 1) * rows;
    double z[R];
    double acc = 0;
    if (mode >= 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * 1024 + t;
        z[r] = 0;
        if (i >= 1 && i < rows - 1) {
          double zz = 0;
          zz = fma(1.0, yc[i - 1] * inv, zz);
          zz = fma(-2.0, yc[i] * inv, zz);
          zz = fma(1.0, yc[i + 1] * inv, zz);
          z[r] = zz;
          acc = fma(yc[i] * inv, zz, acc);
        }
      }
    }
    if (mode >= 1) {
      acc = block_total(acc, red_a);
      if (t == 0) part[0] = acc;
    }
    cl.sync();
    if (mode >= 1) {
      const int lane = t & 31;
      alpha = warp_total(lane < C ? *cl.map_shared_rank(&part[0], lane) : 0.0);
    }
    acc = 0;
    if (mode >= 2) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * 1024 + t;
        if (i < rows) {
          const double v = (z[r] - alpha * (yc[i] * inv)) - beta * (yp[i] * inv);
          yp[i] = v;
          acc = fma(v, v, acc);
        }
      }
    }
    if (mode >= 1) {
      acc = block_total(acc, red_b);
      if (t == 0) part[1] = acc;
    }
    cl.sync();
    if (mode >= 1) {
      const int lane = t & 31;
      beta = warp_total(lane < C ? *cl.map_shared_rank(&part[1], lane) : 0.0);
      inv = 1.0 / (sqrt(beta) + 1.0);
    }
  }
  cl.sync();
  if (t == 0 && cl.block_rank() == 0) out[0] = alpha + beta;
}

__device__ __forceinline__ unsigned long long ld_acq(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
// neighbour flags: mode bit 0: __threadfence before the release; bit 1:
// relaxed volatile store instead of st.release; bit 2: one waiter thread
// (serial) instead of two warps
__global__ void __launch_bounds__(256) nk(int m, int mode, unsigned long long epoch,
                                          unsigned long long* flags, double* halo) {
  const int b = blockIdx.x, t = threadIdx.x, G = gridDim.x;
  __shared__ double h[2];   // the halo values read (kept so the loads stay)
  for (int s = 0; s < m; ++s) {
    const int par = (s + 1) & 1;
    if (t == 0) halo[(par * G + b) * 2] = s;
    if (t == 255) halo[(par * G + b) * 2 + 1] = s;
    __syncthreads();
    const unsigned long long want = (epoch << 32) | (unsigned long long)(s + 1);
    if (t == 0) {
      if (mode & 1) __threadfence();
      if (mode & 2) { __threadfence(); *(volatile unsigned long long*)(flags + b) = want; }
      else st_rel(flags + b, want);
    }
    if (mode & 4) {
      if (t == 0) {
        if (b > 0) while (ld_acq(flags + b - 1) < want) {}
        if (b + 1 < G) while (ld_acq(flags + b + 1) < want) {}
        if (b > 0) h[0] = __ldcg(halo + (par * G + b - 1) * 2 + 1);
        if (b + 1 < G) h[1] = __ldcg(halo + (par * G + b + 1) * 2);
      }
    } else {
      const int warp = t >> 5;
      if (warp == 0 && b > 0) {
        while (ld_acq(flags + b - 1) < want) {}
        if ((t & 31) == 0) h[0] = __ldcg(halo + (par * G + b - 1) * 2 + 1);
      } else if (warp == 1 && b + 1 < G) {
        while (ld_acq(flags + b + 1) < want) {}
        if ((t & 31) == 0) h[1] = __ldcg(halo + (par * G + b + 1) * 2);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256) gk(int m) {   // grid barriers alone
  cg::grid_group g = cg::this_grid();
  for (int s = 0; s < m; ++s) g.sync();
}

static float time_cluster(int C, int mode, int m, int rows) {
  const size_t smem = 2 * rows * sizeof(double);
  auto fn = ck<8>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  double* out;
  cudaMalloc(&out, 8);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = C; a.val.clusterDim.y = 1; a.val.clusterDim.z = 1;
  cfg.attrs = &a; cfg.numAttrs = 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaLaunchKernelEx(&cfg, fn, m, mode, rows, out);
  cudaEventRecord(e0);
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, fn, m, mode, rows, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaError_t err = cudaGetLastError();
  if (err) printf("error %s\n", cudaGetErrorString(err));
  cudaFree(out);
  return ms / 10;
}

static float time_nbr(int G, int mode, int m, unsigned long long* flags, double* halo, unsigned long long& epoch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int i = 0; i < 10; ++i) {
    ++epoch;
    void* args[] = {&m, &mode, &epoch, &flags, &halo};
    cudaLaunchCooperativeKernel((void*)nk, dim3(G), dim3(256), args, 0, 0);
  }
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaError_t err = cudaGetLastError();
  if (err) printf("error %s\n", cudaGetErrorString(err));
  return ms / 10;
}

static float time_grid(int G, int m) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int i = 0; i < 10; ++i) {
    void* args[] = {&m};
    cudaLaunchCooperativeKernel((void*)gk, dim3(G), dim3(256), args, 0, 0);
  }
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  return ms / 10;
}

int main() {
  const int rows = 6250;
  for (int C : {16, 8}) {
    for (int mode : {0, 1, 2}) {
      float a = time_cluster(C, mode, 20, C == 16 ? rows : 2 * rows);
      float b = time_cluster(C, mode, 120, C == 16 ? rows : 2 * rows);
      printf("cluster C=%d mode=%d: per step %.3f us (m=20 %.4f ms, m=120 %.4f ms)\n", C, mode,
             (b - a) / 100 * 1e3, a, b);
    }
  }
  unsigned long long* flags; double* halo;
  cudaMalloc(&flags, 8 * 512); cudaMemset(flags, 0, 8 * 512);
  cudaMalloc(&halo, 8 * 4 * 512);
  unsigned long long epoch = 0;
  for (int G : {132, 264}) {
    for (int mode : {0, 1, 2, 4, 5}) {
      float a = time_nbr(G, mode, 20, flags, halo, epoch);
      float b = time_nbr(G, mode, 120, flags, halo, epoch);
      printf("neighbour G=%d mode=%d: per step %.3f us\n", G, mode, (b - a) / 100 * 1e3);
    }
  }
  for (int G : {132, 264, 391}) {
    float a = time_grid(G, 20), b = time_grid(G, 120);
    printf("grid.sync G=%d: per step %.3f us\n", G, (b - a) / 100 * 1e3);
  }
  return 0;
}

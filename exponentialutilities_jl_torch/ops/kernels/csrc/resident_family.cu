// B4, B5 and B6: the (m, 4)-row recurrence of B1 with other per-row
// operators and p accumulators, each in ONE persistent cooperative launch.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_kernel_multi   (B4, resident.py:394)
//   _resident_banded_kernel  (B5, resident.py:186)
//   _resident_grid_kernel    (B6, resident.py:331)
//
//   omega_{k+1} = ca_k (A omega_k) + cb_k omega_k + cc_k omega_{k-1},
//   W[j] += cw[k, j] omega_k   (j < p),   omega_0 = x,  omega_{-1} = 0
//
// The three TPU kernels differ only in how A acts on one row: a 1-D
// constant stencil (B4), per-row diagonal values (B5), or a 2-D/3-D
// constant stencil on the natural row-major (nz, ny, nx) layout (B6); B4
// also keeps p accumulators where B5 and B6 keep one. Here they are one
// kernel template over the per-row operator (the structs below), built as
// B1 is (csrc/resident.cu): a co-resident grid sized by the occupancy API
// walks the vectors with grid-stride loops, and one cg::this_grid().sync()
// per step orders every write of omega_{k+1} before any read of it.
//
// What bounds them on the H100:
//   B4 at n = 1e5 (p = 4, float64: 3 state and 4 accumulator vectors,
//   5.6 MB) and B6 under its gate (4 vectors within 40 MB) keep their data
//   in the 50 MB L2, so a step is a few microseconds of L2 traffic and the
//   grid barrier's latency bounds it; the one-launch design pays that
//   barrier once per step instead of a kernel launch and the host's
//   launch gaps.
//   B5 at N = 1e6 in float64 streams the k = 5 diagonals plus the state
//   every step (~64 MB, more than L2): it is bound by HBM bandwidth, about
//   20-30 us per step at 3.35 TB/s. Each diagonal is read once per step,
//   coalesced (row i of diagonal j at D[j n + i]); reusing diagonals over
//   several steps (temporal tiling) is left to later tuning.
// There are no reductions, so every result is bitwise repeatable.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace eu {

// Per-row operators. points() coefficient values are staged in shared
// memory by the kernel and passed back to row() as `c`.

template <typename T>
struct Stencil1D {             // B4: y_i = sum_j c_j x_{i + o_j}, Dirichlet
  Offsets1D offs;
  const T* cvals;
  long long n;
  __device__ int points() const { return offs.k; }
  __device__ T coeff(int j) const { return cvals[j]; }
  __device__ T row(const T* x, long long i, const T* c) const {
    T z = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const long long q = i + offs.o[j];
      if (q >= 0 && q < n) z += c[j] * x[q];
    }
    return z;
  }
};

template <typename T>
struct Banded {                // B5: y_i = sum_j D[j, i] x_{i + o_j}
  Offsets1D offs;
  const T* diags;              // (k, n), row-major
  long long n;
  __device__ int points() const { return 0; }
  __device__ T coeff(int) const { return T(0); }
  __device__ T row(const T* x, long long i, const T*) const {
    T z = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const long long q = i + offs.o[j];
      if (q >= 0 && q < n) z += __ldg(diags + (long long)j * n + i) * x[q];
    }
    return z;
  }
};

template <typename T>
struct Grid3D {                // B6: constant stencil on (nz, ny, nx), Dirichlet
  Offsets3D offs;
  long long flat[kMaxPoints];  // (dz ny + dy) nx + dx per point
  const T* cvals;
  int nz, ny, nx;
  __device__ int points() const { return offs.k; }
  __device__ T coeff(int j) const { return cvals[j]; }
  __device__ T row(const T* x, long long i, const T* c) const {
    const long long plane = (long long)ny * nx;
    const int z = (int)(i / plane);
    const long long r = i - (long long)z * plane;
    const int y = (int)(r / nx);
    const int xx = (int)(r - (long long)y * nx);
    T acc = T(0);
    for (int j = 0; j < offs.k; ++j) {
      const int qz = z + offs.dz[j], qy = y + offs.dy[j], qx = xx + offs.dx[j];
      if (qz >= 0 && qz < nz && qy >= 0 && qy < ny && qx >= 0 && qx < nx)
        acc += c[j] * x[i + flat[j]];
    }
    return acc;
  }
};

// W (p, n) = sum_k cw[k * cw_stride + j] omega_k; buf holds 3n scratch
// values (previous, current, next), rotated per step.
template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
resident_family_kernel(const T* __restrict__ x, const T* __restrict__ rows,
                       const T* __restrict__ cw, int cw_stride, int p, Op op,
                       long long n, int m, T* __restrict__ W, T* buf) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T c_sh[kMaxPoints];
  for (int j = threadIdx.x; j < op.points(); j += kThreads) c_sh[j] = op.coeff(j);
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  T* bp = buf;
  T* bc = buf + n;
  T* bn = buf + 2 * n;
  for (long long i = i0; i < n; i += stride) {
    bc[i] = x[i];
    bp[i] = T(0);
    for (int j = 0; j < p; ++j) W[(long long)j * n + i] = T(0);
  }
  grid.sync();

  for (int step = 0; step < m; ++step) {
    const T ca = rows[4 * step + 0];
    const T cb = rows[4 * step + 1];
    const T cc = rows[4 * step + 2];
    const T* cwk = cw + (long long)step * cw_stride;
    for (long long i = i0; i < n; i += stride) {
      const T wc = bc[i];
      for (int j = 0; j < p; ++j) W[(long long)j * n + i] += cwk[j] * wc;
      const T z = op.row(bc, i, c_sh);
      bn[i] = ca * z + cb * wc + cc * bp[i];
    }
    grid.sync();   // every omega_{k+1} row is written before any is read
    T* t = bp;
    bp = bc;
    bc = bn;
    bn = t;
  }
}

template <typename T, typename Op>
int launch_family(const T* x, const T* rows, const T* cw, int cw_stride, int p,
                  Op op, long long n, int m, T* W, T* buf, cudaStream_t stream) {
  if (n < 1 || m < 0 || p < 1) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)resident_family_kernel<T, Op>;
  int grid = 0;
  const int e = grid_for(fn, n, &grid);
  if (e) return e;
  void* args[] = {(void*)&x, (void*)&rows, (void*)&cw, (void*)&cw_stride, (void*)&p,
                  (void*)&op, (void*)&n, (void*)&m, (void*)&W, (void*)&buf};
  cudaError_t le = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// B4: p accumulators, W (p, n), cw (m, p).
template <typename T>
int launch_multi(const T* x, const T* rows, const T* cw, int p, const T* cvals,
                 const int* offs, int k, long long n, int m, T* W, T* buf,
                 cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints) return (int)cudaErrorInvalidValue;
  Stencil1D<T> op{make_offsets(offs, k), cvals, n};
  return launch_family<T>(x, rows, cw, p, p, op, n, m, W, buf, stream);
}

// B5: one accumulator with cw the fourth column of rows.
template <typename T>
int launch_banded(const T* x, const T* rows, const T* diags, const int* offs, int k,
                  long long n, int m, T* w, T* buf, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints) return (int)cudaErrorInvalidValue;
  Banded<T> op{make_offsets(offs, k), diags, n};
  return launch_family<T>(x, rows, rows + 3, 4, 1, op, n, m, w, buf, stream);
}

// B6: one accumulator; offs holds k (dz, dy, dx) triples; 2-D grids as nz = 1.
template <typename T>
int launch_grid(const T* x, const T* rows, const T* cvals, const int* offs, int k,
                int nz, int ny, int nx, int m, T* w, T* buf, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints || nz < 1 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  Grid3D<T> op{};
  op.offs.k = k;
  for (int j = 0; j < k; ++j) {
    op.offs.dz[j] = offs[3 * j + 0];
    op.offs.dy[j] = offs[3 * j + 1];
    op.offs.dx[j] = offs[3 * j + 2];
    op.flat[j] = ((long long)op.offs.dz[j] * ny + op.offs.dy[j]) * nx + op.offs.dx[j];
  }
  op.cvals = cvals;
  op.nz = nz;
  op.ny = ny;
  op.nx = nx;
  const long long n = (long long)nz * ny * nx;
  return launch_family<T>(x, rows, rows + 3, 4, 1, op, n, m, w, buf, stream);
}

}  // namespace eu

#define EU_FAMILY_API(T, SUF)                                                        \
  extern "C" int eu_resident_multi_##SUF(                                            \
      const T* x, const T* rows, const T* cw, int p, const T* cvals, const int* offs,\
      int k, long long n, int m, T* W, T* buf, void* stream) {                      \
    return eu::launch_multi<T>(x, rows, cw, p, cvals, offs, k, n, m, W, buf,        \
                               (cudaStream_t)stream);                               \
  }                                                                                 \
  extern "C" int eu_resident_banded_##SUF(                                           \
      const T* x, const T* rows, const T* diags, const int* offs, int k,            \
      long long n, int m, T* w, T* buf, void* stream) {                             \
    return eu::launch_banded<T>(x, rows, diags, offs, k, n, m, w, buf,              \
                                (cudaStream_t)stream);                              \
  }                                                                                 \
  extern "C" int eu_resident_grid_##SUF(                                             \
      const T* x, const T* rows, const T* cvals, const int* offs, int k, int nz,    \
      int ny, int nx, int m, T* w, T* buf, void* stream) {                          \
    return eu::launch_grid<T>(x, rows, cvals, offs, k, nz, ny, nx, m, w, buf,       \
                              (cudaStream_t)stream);                                \
  }

EU_FAMILY_API(float, f32)
EU_FAMILY_API(double, f64)

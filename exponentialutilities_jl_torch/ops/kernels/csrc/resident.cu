// B1 and B2: the whole m-step recurrence of a 1-D constant stencil in ONE
// persistent cooperative launch. Both are the second form of their kernel
// now: B1's first is the neighbour form of csrc/resident_family.cu, B2's
// the cluster form of csrc/resident_cluster.cu; the grid kernels here take
// the sizes whose state does not fit those forms' shared memory.
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/resident.py
//   _resident_kernel          (B1, resident.py:89)
//   _resident_lanczos_kernel  (B2, resident.py:461)
//
// On the TPU both kernels keep every state vector in VMEM. On Hopper the
// state (3 vectors, 2.4 MB at n = 1e5 in f64) does not fit one SM's shared
// memory but does fit the 50 MB L2, so the kernels are persistent: one
// co-resident grid (sized by the occupancy API) walks the vector with
// grid-stride loops, and a cg::this_grid().sync() separates the steps.
// Each step reads ~k+2 and writes 1-2 values per row, all L2 traffic;
// what bounds a step at this size is the grid barrier's latency, which the
// one-launch design pays m times (B1) or 3m times (B2) instead of paying a
// kernel launch per step.
//
// Reductions (B1's sum of w^2, B2's alpha and beta) are per-block partials
// in a buffer plus a fixed-order second stage: bitwise repeatable for a
// given grid size, which the occupancy API fixes per card.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace eu {

template <typename T>
__device__ __forceinline__ T stencil_1d(const T* x, long long i, long long n,
                                        const int* o, const T* c, int k) {
  T z = T(0);
  for (int j = 0; j < k; ++j) {
    const long long q = i + o[j];
    if (q >= 0 && q < n) z += c[j] * x[q];   // Dirichlet: outside reads 0
  }
  return z;
}

// omega_{k+1} = ca_k A omega_k + cb_k omega_k + cc_k omega_{k-1},
// w += cw_k omega_k, omega_0 = s x (x where scale is null), omega_{-1} = 0;
// also *nrm2 = sum w^2. buf holds 3n scratch values (previous, current,
// next), rotated per step. A row is computed with the row functions of
// common.cuh, so w has the neighbour form's bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resident_recurrence_kernel(const T* __restrict__ x, const T* __restrict__ rows,
                           const T* __restrict__ cvals, const T* __restrict__ scale,
                           Offsets1D offs, long long n, int m, T* w, T* buf,
                           T* partials, T* nrm2) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T red[kThreads];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    c_sh[j] = cvals[j];
    o_sh[j] = offs.o[j];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  T* bp = buf;
  T* bc = buf + n;
  T* bn = buf + 2 * n;
  for (long long i = i0; i < n; i += stride) {
    bc[i] = scale ? scale[0] * x[i] : x[i];
    bp[i] = T(0);
    w[i] = T(0);
  }
  grid.sync();

  for (int step = 0; step < m; ++step) {
    const T ca = rows[4 * step + 0];
    const T cb = rows[4 * step + 1];
    const T cc = rows[4 * step + 2];
    const T cw = rows[4 * step + 3];
    for (long long i = i0; i < n; i += stride) {
      const T wc = bc[i];
      w[i] = accumulate(w[i], cw, wc);
      T z = T(0);
      for (int j = 0; j < k; ++j) {
        const long long q = i + o_sh[j];
        if (q >= 0 && q < n) z = stencil_term(z, c_sh[j], bc[q]);
      }
      bn[i] = next_row(ca, cb, cc, z, wc, bp[i]);
    }
    grid.sync();   // every omega_{k+1} row is written before any is read
    T* t = bp;
    bp = bc;
    bc = bn;
    bn = t;
  }

  T acc = T(0);
  for (long long i = i0; i < n; i += stride) acc += w[i] * w[i];
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  grid.sync();
  if (blockIdx.x == 0) {
    const T total = fixed_order_total(partials, gridDim.x, 1, red);
    if (threadIdx.x == 0) nrm2[0] = total;
  }
}

// Lanczos pass 1 from a normalized v0: per step alpha = v.Av and
// beta = |Av - alpha v - beta_prev v_prev|, written to ab (m, 2). A beta
// below tol zeroes that beta and every later step (masked-tail convention
// of ops/krylov.lanczos_coeffs). buf: 3n scratch; partials: 2*gridDim.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resident_lanczos_kernel(const T* __restrict__ v0, const T* __restrict__ cvals,
                        Offsets1D offs, long long n, int m, T tol, T* ab,
                        T* buf, T* partials) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T red[kThreads];
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    c_sh[j] = cvals[j];
    o_sh[j] = offs.o[j];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int nb = gridDim.x;
  T* pa = partials;        // alpha partials
  T* pb = partials + nb;   // beta^2 partials
  T* bp = buf;
  T* bc = buf + n;
  T* bn = buf + 2 * n;
  for (long long i = i0; i < n; i += stride) {
    bc[i] = v0[i];
    bp[i] = T(0);
  }
  grid.sync();

  T beta_prev = T(0);
  bool alive = true;
  for (int step = 0; step < m; ++step) {
    // phase A: z = A v (kept in bn), partial of v.z
    T acc = T(0);
    for (long long i = i0; i < n; i += stride) {
      const T z = stencil_1d(bc, i, n, o_sh, c_sh, k);
      bn[i] = z;
      acc += bc[i] * z;
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) pa[blockIdx.x] = acc;
    grid.sync();
    const T alpha = fixed_order_total(pa, nb, 1, red);

    // phase B: y = z - alpha v - beta_prev v_prev (in bn), partial of y.y
    acc = T(0);
    for (long long i = i0; i < n; i += stride) {
      const T y = (bn[i] - alpha * bc[i]) - beta_prev * bp[i];
      bn[i] = y;
      acc += y * y;
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) pb[blockIdx.x] = acc;
    grid.sync();
    const T ss = fixed_order_total(pb, nb, 1, red);
    const T beta = sqrt(ss > T(0) ? ss : T(0));
    const bool ok = alive && (beta >= tol);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ab[2 * step + 0] = alive ? alpha : T(0);
      ab[2 * step + 1] = ok ? beta : T(0);
    }

    // phase C: v_next = y / beta (0 after a breakdown)
    const T inv = ok ? T(1) / (beta > T(0) ? beta : T(1)) : T(0);
    for (long long i = i0; i < n; i += stride) bn[i] *= inv;
    grid.sync();
    beta_prev = ok ? beta : T(0);
    alive = ok;
    T* t = bp;
    bp = bc;
    bc = bn;
    bn = t;
  }
}

template <typename T>
int launch_recurrence(const T* x, const T* rows, const T* cvals, const T* scale,
                      const int* offs, int k, long long n, int m, T* w, T* buf,
                      T* partials, int partials_cap, T* nrm2, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints || n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)resident_recurrence_kernel<T>;
  int grid = 0;
  int e = grid_for(fn, n, &grid);
  if (e) return e;
  if (grid > partials_cap) return (int)cudaErrorInvalidValue;
  Offsets1D o = make_offsets(offs, k);
  void* args[] = {(void*)&x, (void*)&rows, (void*)&cvals, (void*)&scale, (void*)&o,
                  (void*)&n, (void*)&m, (void*)&w, (void*)&buf, (void*)&partials,
                  (void*)&nrm2};
  cudaError_t le = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lanczos(const T* v0, const T* cvals, const int* offs, int k, long long n,
                   int m, T tol, T* ab, T* buf, T* partials, int partials_cap,
                   cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints || n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)resident_lanczos_kernel<T>;
  int grid = 0;
  int e = grid_for(fn, n, &grid);
  if (e) return e;
  if (2 * grid > partials_cap) return (int)cudaErrorInvalidValue;
  Offsets1D o = make_offsets(offs, k);
  void* args[] = {(void*)&v0, (void*)&cvals, (void*)&o, (void*)&n, (void*)&m,
                  (void*)&tol, (void*)&ab, (void*)&buf, (void*)&partials};
  cudaError_t le = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // namespace eu

#define EU_RESIDENT_API(T, SUF)                                                      \
  extern "C" int eu_resident_recurrence_##SUF(                                       \
      const T* x, const T* rows, const T* cvals, const T* scale, const int* offs,   \
      int k, long long n, int m, T* w, T* buf, T* partials, int partials_cap,       \
      T* nrm2, void* stream) {                                                      \
    return eu::launch_recurrence<T>(x, rows, cvals, scale, offs, k, n, m, w, buf,   \
                                    partials, partials_cap, nrm2,                   \
                                    (cudaStream_t)stream);                          \
  }                                                                                 \
  extern "C" int eu_resident_lanczos_##SUF(                                          \
      const T* v0, const T* cvals, const int* offs, int k, long long n, int m,      \
      T tol, T* ab, T* buf, T* partials, int partials_cap, void* stream) {          \
    return eu::launch_lanczos<T>(v0, cvals, offs, k, n, m, tol, ab, buf, partials,  \
                                 partials_cap, (cudaStream_t)stream);               \
  }

EU_RESIDENT_API(float, f32)
EU_RESIDENT_API(double, f64)

// Largest grid either resident kernel launches for this card and dtype, so
// the caller can size the partials buffer (negative: a CUDA error code).
extern "C" int eu_resident_max_blocks(int f64) {
  const void* a = f64 ? (const void*)eu::resident_recurrence_kernel<double>
                      : (const void*)eu::resident_recurrence_kernel<float>;
  const void* b = f64 ? (const void*)eu::resident_lanczos_kernel<double>
                      : (const void*)eu::resident_lanczos_kernel<float>;
  const int ca = eu::max_coresident_blocks(a);
  const int cb = eu::max_coresident_blocks(b);
  if (ca < 0) return ca;
  if (cb < 0) return cb;
  return ca > cb ? ca : cb;
}

extern "C" const char* eu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

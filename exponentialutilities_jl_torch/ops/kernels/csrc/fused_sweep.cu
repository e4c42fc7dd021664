// B3 and B3-var: one fused sweep of the three-term recurrence over a
// 2-D/3-D grid with a box stencil, constant (B3) or with a per-cell
// coefficient field per stencil point (B3-var).
//
// Replaces exponentialutilities_jl_tpu/ops/kernels/lanczos_fused.py
//   _fused_kernel via its constant entries _kernel_plain and _kernel_accum
//   (lanczos_fused.py:380, :607, :614) and its variable-coefficient entries
//   _kernel_var and _kernel_var_accum (:621, :628); all called by
//   fused_lanczos_step (:783).
//
//   y  = ca Z + cb Vc + cc Vp           (written to Y)
//   Zn = A y                            (written to Zn; Dirichlet bounds)
//        B3:     Zn_i = sum_j c_j       y_{i + o_j}
//        B3-var: Zn_i = sum_j C[j, i]   y_{i + o_j}   (field read at the
//                                                       OUTPUT cell i)
//   moments = (sum y*y, sum y*Zn)
//   accum:  W += cw Vc  (in place)
//
// The TPU kernel streams ghost-padded z-planes through a 3-plane VMEM ring
// (variable mode adds a ring of coefficient planes). Here each block owns a
// (tz, ty, tx) tile of the natural contiguous (nz, ny, nx) layout, forms y
// on the tile plus a halo of max|offset| per axis in shared memory
// (out-of-grid cells are 0), and applies the stencil from shared memory.
// Out-of-grid neighbours read that zero halo in both forms, so a field
// entry of a boundary cell that faces outside (variable_diffusion_nd_stencil
// keeps them nonzero) multiplies 0, exactly as the plain twin's zero pad.
//
// Both are bound by device-memory bandwidth. B3 reads Z, Vc, Vp (and W)
// once and writes Y, Zn (and W) once: 5n values (7n with accum). B3-var
// adds the k fields, (5 + k) n values ((7 + k) n with accum): for the
// 7-point operator at 216^3 that is 12n = 967 MB in float64 (0.289 ms at
// 3.35 TB/s) and 14n = 1.13 GB (0.337 ms); float32 is half. The fields add
// no shared memory: each thread streams C[j * n + g] for its own output
// cell from global memory (64-bit offsets), coalesced along x since the
// tile's threads run x fastest, each read once. The halo re-reads of y's
// inputs mostly hit L2. Marching the tile along z to drop those re-reads
// (2.5-D), cp.async/TMA staging and register blocking are left to tuning.
//
// The moments are per-block partials plus a one-block fixed-order second
// stage, so a sweep's moments are bitwise repeatable: the Lanczos replay
// (lanczos_replay_fused) recomputes alpha and beta from its own sweeps and
// relies on getting exactly the values pass 1 recorded.
#include "common.cuh"

namespace eu {

template <typename T, bool ACCUM, bool VAR>
__global__ void __launch_bounds__(kThreads)
fused_sweep_kernel(const T* __restrict__ Z, const T* __restrict__ Vc,
                   const T* __restrict__ Vp, const T* __restrict__ coefs,
                   const T* __restrict__ cvals, const T* __restrict__ fields,
                   Offsets3D offs, int nz, int ny, int nx, int tz, int ty,
                   int tx, int hz, int hy, int hx, T* __restrict__ Y,
                   T* __restrict__ Zn, T* __restrict__ W,
                   T* __restrict__ partials) {
  extern __shared__ unsigned char smem_raw[];
  T* ysh = reinterpret_cast<T*>(smem_raw);
  __shared__ T c_sh[kMaxPoints];
  __shared__ int o_sh[kMaxPoints];
  __shared__ T red[kThreads];

  const int bx = tx + 2 * hx, by = ty + 2 * hy, bz = tz + 2 * hz;
  const int k = offs.k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    if (!VAR) c_sh[j] = cvals[j];
    o_sh[j] = (offs.dz[j] * by + offs.dy[j]) * bx + offs.dx[j];
  }
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty, z0 = blockIdx.z * tz;
  const T ca = coefs[0], cb = coefs[1], cc = coefs[2];
  const size_t n = (size_t)nz * ny * nx;

  // y on the tile and its halo; cells outside the grid are 0 (Dirichlet)
  const int nbrick = bx * by * bz;
  for (int l = threadIdx.x; l < nbrick; l += kThreads) {
    const int lx = l % bx;
    const int r = l / bx;
    const int ly = r % by;
    const int lz = r / by;
    const int x = x0 + lx - hx, y = y0 + ly - hy, z = z0 + lz - hz;
    T v = T(0);
    if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz) {
      const size_t g = ((size_t)z * ny + y) * nx + x;
      v = ca * Z[g] + cb * Vc[g] + cc * Vp[g];
    }
    ysh[l] = v;
  }
  __syncthreads();

  T s_yy = T(0), s_yz = T(0);
  const T cw = ACCUM ? coefs[3] : T(0);
  const int ntile = tx * ty * tz;
  for (int l = threadIdx.x; l < ntile; l += kThreads) {
    const int lx = l % tx;
    const int r = l / tx;
    const int ly = r % ty;
    const int lz = r / ty;
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x < nx && y < ny && z < nz) {
      const int s = ((lz + hz) * by + (ly + hy)) * bx + (lx + hx);
      const size_t g = ((size_t)z * ny + y) * nx + x;
      const T yv = ysh[s];
      T zn = T(0);
      if (VAR) {
        for (int j = 0; j < k; ++j) zn += fields[(size_t)j * n + g] * ysh[s + o_sh[j]];
      } else {
        for (int j = 0; j < k; ++j) zn += c_sh[j] * ysh[s + o_sh[j]];
      }
      Y[g] = yv;
      Zn[g] = zn;
      s_yy += yv * yv;
      s_yz += yv * zn;
      if (ACCUM) W[g] += cw * Vc[g];
    }
  }
  const size_t bid = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  s_yy = block_sum(s_yy, red);
  s_yz = block_sum(s_yz, red);
  if (threadIdx.x == 0) {
    partials[2 * bid + 0] = s_yy;
    partials[2 * bid + 1] = s_yz;
  }
}

// Second stage: moments[0:2] = fixed-order sums of the per-block partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const T* __restrict__ partials, int nblocks, T* __restrict__ moments) {
  __shared__ T red[kThreads];
  const T a = fixed_order_total(partials, nblocks, 2, red);
  const T b = fixed_order_total(partials + 1, nblocks, 2, red);
  if (threadIdx.x == 0) {
    moments[0] = a;
    moments[1] = b;
  }
}

template <typename T, bool VAR>
void launch_body(dim3 grid, size_t smem, cudaStream_t stream, const T* Z, const T* Vc,
                 const T* Vp, const T* coefs, const T* cvals, const T* fields,
                 const Offsets3D& o, int nz, int ny, int nx, int tz, int ty, int tx,
                 int hz, int hy, int hx, T* Y, T* Zn, T* W, T* partials) {
  if (W != nullptr)
    fused_sweep_kernel<T, true, VAR><<<grid, kThreads, smem, stream>>>(
        Z, Vc, Vp, coefs, cvals, fields, o, nz, ny, nx, tz, ty, tx, hz, hy, hx, Y, Zn, W,
        partials);
  else
    fused_sweep_kernel<T, false, VAR><<<grid, kThreads, smem, stream>>>(
        Z, Vc, Vp, coefs, cvals, fields, o, nz, ny, nx, tz, ty, tx, hz, hy, hx, Y, Zn, W,
        partials);
}

// One sweep: the constant form when `fields` is null (reads cvals), the
// variable form otherwise (reads the (k, n) fields, row-major).
template <typename T>
int launch_sweep(const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* cvals,
                 const T* fields, const int* offs, int k, int nz, int ny, int nx, int tz,
                 int ty, int tx, T* Y, T* Zn, T* W, T* partials, long long partials_cap,
                 T* moments, cudaStream_t stream) {
  if (k < 1 || k > kMaxPoints || nz < 1 || ny < 1 || nx < 1 || tz < 1 || ty < 1 || tx < 1)
    return (int)cudaErrorInvalidValue;
  if ((fields == nullptr) == (cvals == nullptr)) return (int)cudaErrorInvalidValue;
  Offsets3D o{};
  o.k = k;
  int hz = 0, hy = 0, hx = 0;
  for (int j = 0; j < k; ++j) {
    o.dz[j] = offs[3 * j + 0];
    o.dy[j] = offs[3 * j + 1];
    o.dx[j] = offs[3 * j + 2];
    const int az = o.dz[j] < 0 ? -o.dz[j] : o.dz[j];
    const int ay = o.dy[j] < 0 ? -o.dy[j] : o.dy[j];
    const int ax = o.dx[j] < 0 ? -o.dx[j] : o.dx[j];
    hz = az > hz ? az : hz;
    hy = ay > hy ? ay : hy;
    hx = ax > hx ? ax : hx;
  }
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, (nz + tz - 1) / tz);
  const long long nblocks = (long long)grid.x * grid.y * grid.z;
  if (grid.y > 65535 || grid.z > 65535 || 2 * nblocks > partials_cap || nblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(tx + 2 * hx) * (ty + 2 * hy) * (tz + 2 * hz) * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (fields != nullptr)
    launch_body<T, true>(grid, smem, stream, Z, Vc, Vp, coefs, cvals, fields, o, nz, ny, nx,
                         tz, ty, tx, hz, hy, hx, Y, Zn, W, partials);
  else
    launch_body<T, false>(grid, smem, stream, Z, Vc, Vp, coefs, cvals, fields, o, nz, ny, nx,
                          tz, ty, tx, hz, hy, hx, Y, Zn, W, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<T><<<1, kThreads, 0, stream>>>(partials, (int)nblocks, moments);
  return (int)cudaGetLastError();
}

}  // namespace eu

#define EU_SWEEP_API(T, SUF)                                                         \
  extern "C" int eu_fused_sweep_##SUF(                                               \
      const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* cvals,         \
      const int* offs, int k, int nz, int ny, int nx, int tz, int ty, int tx, T* Y, \
      T* Zn, T* W, T* partials, long long partials_cap, T* moments, void* stream) { \
    return eu::launch_sweep<T>(Z, Vc, Vp, coefs, cvals, nullptr, offs, k, nz, ny,   \
                               nx, tz, ty, tx, Y, Zn, W, partials, partials_cap,    \
                               moments, (cudaStream_t)stream);                      \
  }                                                                                  \
  extern "C" int eu_fused_sweep_var_##SUF(                                           \
      const T* Z, const T* Vc, const T* Vp, const T* coefs, const T* fields,        \
      const int* offs, int k, int nz, int ny, int nx, int tz, int ty, int tx, T* Y, \
      T* Zn, T* W, T* partials, long long partials_cap, T* moments, void* stream) { \
    return eu::launch_sweep<T>(Z, Vc, Vp, coefs, nullptr, fields, offs, k, nz, ny,  \
                               nx, tz, ty, tx, Y, Zn, W, partials, partials_cap,    \
                               moments, (cudaStream_t)stream);                      \
  }

EU_SWEEP_API(float, f32)
EU_SWEEP_API(double, f64)

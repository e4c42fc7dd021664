// K5: pass B of the fused batched Lanczos step (ops/kernels/lanczos_step.py,
// the step of ops/krylov.py's batched lanczos / lanczos_coeffs on a
// BandedOperator). Pass A is K1's Lanczos form (csrc/spmv.cu), which wrote
// v_j to its slot and alpha_j (batch,).
//
// K5 replaces no TPU kernel: it is the elementwise tail of JAX's vmapped
// Lanczos step (exponentialutilities_jl_tpu/ops/krylov.py:290-305 under
// models/expv.py _batched_build's vmap), which XLA fuses into a few loop
// fusions and the port ran as ~11 torch passes over the (batch, n) block a
// step (the update, the dot and the norm, the normalization, the where on
// broke, the copy of vp, the basis write). For each row r not broken down:
//   y'  = A v_j - alpha_r v_j - beta_{j-1, r} v_{j-1}      (u, next step)
//   partials of |y'|^2, summed by the launch's last block in block order;
// the last block then writes the step's (batch,) records as _lanczos_step
// does: alphas[r, j], betas[r, j] = bprev = |y'| (0 for a row already
// broken down), broke |= |y'| < tol, m_used = j + 1, and scale = 1 /
// |y'| (1 where |y'| = 0), with which pass A of step j + 1 reads v_{j+1} =
// u scale: the normalization costs no pass of its own. A row broken down
// before step j is skipped (u written zero).
//
// Bound: HBM. The step's inputs are the diagonals and v_j, v_{j-1}; its
// output is v_{j+1}: (k + 3 batch) n sizeof(T) bytes (+ batch n for the
// basis row). K5 recomputes A v_j from the diagonals and v_j instead of
// reading a y that pass A would have written: k n against 2 batch n
// bytes. So the pair moves (2k + 5 batch) n sizeof(T) bytes a step
// (pass A: k + 2 batch, K5: k + 3 batch), v_{j+1} staying in u until pass
// A of the next step reads it once. The product is banded_rows.cuh's, so
// K5's A v_j has pass A's bits and alpha belongs to this y.
//
// Every step index is read from jj[0] on the device (the builder's counter,
// advanced after the pair), so the pair is captured once and replayed.
#include <cstddef>

#include "banded_rows.cuh"

namespace eu {

template <typename T>
struct LanczosUpdate {
  static constexpr bool kScaled = false;
  static constexpr int V = 16 / sizeof(T);
  T* u;
  const T* v;
  long long n, urow, vrow, vslot;
  int nslots, batch, m;
  const T* alpha;
  T* scale_out;
  T* bprev;
  unsigned char* broke;
  long long* m_used;
  T* alphas;
  T* betas;
  T* partial;
  int* ticket;
  const long long* jj;
  T tol;
  bool have_xc;
  long long j;    // begin: the step
  const T* vc;    // slot j of row 0
  const T* vp;    // slot j - 1 of row 0, or null at j = 0
  T* red;
  static LanczosUpdate make(const LanczosLaunch& p) {
    return LanczosUpdate{static_cast<T*>(p.u), static_cast<const T*>(p.v), p.n, p.urow,
                         p.vrow, p.vslot, p.nslots, p.batch, p.m,
                         static_cast<const T*>(p.alpha), static_cast<T*>(p.scale),
                         static_cast<T*>(p.bprev), p.broke, p.m_used,
                         static_cast<T*>(p.alphas), static_cast<T*>(p.betas),
                         static_cast<T*>(p.partial), p.ticket, p.jj,
                         static_cast<T>(p.tol), p.zc >= 0, 0, nullptr, nullptr, nullptr};
  }
  __device__ void begin(unsigned char* smem) {
    j = *jj;
    vc = v + (nslots ? j % nslots : j) * vslot;
    vp = j > 0 ? v + (nslots ? (j - 1) % nslots : j - 1) * vslot : nullptr;
    red = reinterpret_cast<T*>(smem);
    clear_partials(red, batch);
  }
  __device__ bool skip(int r) const { return broke[r] != 0; }
  template <bool A, bool I>
  __device__ void skipped(int r, long long i0) {
    T z[V];
#pragma unroll
    for (int e = 0; e < V; ++e) z[e] = T(0);
    store_own<T, A, I>(u + r * urow, i0, n, z);
  }
  __device__ const T* x(int r) const { return vc + r * vrow; }
  __device__ T scale(int) const { return T(1); }
  template <bool A, bool I>
  __device__ void out(int r, long long i0, const T (&acc)[V], const T (&xc)[V]) {
    T w[V], q[V];
    if (have_xc) {
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = xc[e];
    } else {                      // no zero offset: v_j's own rows again
      load_own<T, A, I, false>(vc + r * vrow, i0, n, w);
    }
    if (vp != nullptr) {
      load_own<T, A, I, true>(vp + r * vrow, i0, n, q);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) q[e] = T(0);
    }
    const T a = alpha[r], b = bprev[r];
    T part = T(0);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      w[e] = fma_rn(-b, q[e], fma_rn(-a, w[e], acc[e]));
      part = fma_rn(w[e], w[e], part);
    }
    store_own<T, A, I>(u + r * urow, i0, n, w);
    warp_partial(red, batch, r, part);
  }
  __device__ void end() {
    if (!publish_partials(red, batch, partial, ticket)) return;
    // the records, as _lanczos_step writes them (values copied out of the
    // mode for the lambda)
    const long long jj = j, mm = m;
    const T tl = tol;
    const T* al = alpha;
    T *sc = scale_out, *bpv = bprev, *als = alphas, *bts = betas;
    unsigned char* br = broke;
    long long* mu = m_used;
    reduce_partials(partial, batch, ticket, [=](int r, T s2) {
      const T nrm = sqrt(s2);
      const bool active = br[r] == 0;
      const T bp = active ? nrm : T(0);
      als[r * mm + jj] = active ? al[r] : T(0);
      bts[r * mm + jj] = bp;
      bpv[r] = bp;
      br[r] = (!active || nrm < tl) ? 1 : 0;
      if (active) mu[r] = jj + 1;
      sc[r] = T(1) / (nrm > T(0) ? nrm : T(1));
    });
  }
};

template <typename T, int KH, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, kMinBlocksR)
lanczos_update_kernel(const T* __restrict__ diags, Offsets1D offs, long long blo,
                      long long bhi, int zc, LanczosUpdate<T> md) {
  extern __shared__ __align__(16) unsigned char update_smem[];
  __shared__ int o_sh[kMaxPoints];
  const int k = offs.k;
  for (int i = threadIdx.x; i < k; i += kThreads) o_sh[i] = offs.o[i];
  md.begin(update_smem);
  __syncthreads();
  banded_segments<T, KH, ALIGNED>(diags, o_sh, k, zc, md.n, blo, bhi, md);
  md.end();
}

template <typename T>
int launch_lanczos_update(const LanczosLaunch* p, cudaStream_t stream) {
  const int e = check_lanczos<T>(*p);
  if (e) return e;
  if (p->grid_update < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kWarpsR * p->batch * sizeof(T);
  const LanczosUpdate<T> md = LanczosUpdate<T>::make(*p);
  const T* diags = static_cast<const T*>(p->diags);
  const bool al = lanczos_aligned<T>(*p);
  return banded_dispatch(p->offs.k, [&](auto kh) -> int {
    constexpr int KH = decltype(kh)::value;
    if (al)
      lanczos_update_kernel<T, KH, true><<<p->grid_update, kThreads, smem, stream>>>(
          diags, p->offs, p->blo, p->bhi, p->zc, md);
    else
      lanczos_update_kernel<T, KH, false><<<p->grid_update, kThreads, smem, stream>>>(
          diags, p->offs, p->blo, p->bhi, p->zc, md);
    return (int)cudaGetLastError();
  });
}

// K5's grid: one block a segment, at most the blocks the card holds at
// once (written to the descriptor; the partials are sized from it).
template <typename T>
int update_grid(LanczosLaunch* p) {
  constexpr long long R = (long long)kThreads * (16 / sizeof(T));
  const bool al = lanczos_aligned<T>(*p);
  return banded_dispatch(p->offs.k, [&](auto kh) -> int {
    constexpr int KH = decltype(kh)::value;
    const void* fn = al ? (const void*)lanczos_update_kernel<T, KH, true>
                        : (const void*)lanczos_update_kernel<T, KH, false>;
    return segment_grid(fn, p->n, R, &p->grid_update);
  });
}

}  // namespace eu

static_assert(offsetof(eu::LanczosLaunch, offs) == 32 &&
                  offsetof(eu::LanczosLaunch, u) == 296 &&
                  offsetof(eu::LanczosLaunch, nslots) == 336 &&
                  offsetof(eu::LanczosLaunch, alpha) == 352 &&
                  offsetof(eu::LanczosLaunch, jj) == 424 &&
                  offsetof(eu::LanczosLaunch, tol) == 432 &&
                  sizeof(eu::LanczosLaunch) == 448,
              "the ctypes mirror in ops/kernels/lanczos_step.py assumes this layout");

#define EU_LANCZOS_API(T, SUF)                                                       \
  extern "C" int eu_lanczos_update_##SUF(const eu::LanczosLaunch* p, void* stream) { \
    return eu::launch_lanczos_update<T>(p, (cudaStream_t)stream);                    \
  }                                                                                  \
  extern "C" int eu_lanczos_update_grid_##SUF(eu::LanczosLaunch* p) {                \
    return eu::update_grid<T>(p);                                                    \
  }

EU_LANCZOS_API(float, f32)
EU_LANCZOS_API(double, f64)

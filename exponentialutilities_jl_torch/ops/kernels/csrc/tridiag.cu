// R1: the Hermitian reduced exponential of the Krylov paths,
//   out = s Q exp(t Lambda) Q^T e1,   T = Q Lambda Q^T,
// T the real symmetric tridiagonal with diagonal alpha (m values) and
// off-diagonal beta (m - 1 values), t real or complex, s an optional real
// scale (beta0 in the two-pass coefficients).
//
// R1 replaces no TPU kernel. The JAX package evaluates this formula with
// XLA's eigh inside one compiled program
// (exponentialutilities_jl_tpu/models/expv.py: _exp_reduced_e1,
// _lanczos_reduced_coeffs and the error-estimate loop's body). On the
// H100 torch.linalg.eigh reads its info to the host (a sync), so it cannot
// run inside a CUDA graph; R1 gives the port the same result with no host
// read.
//
// Design. One block: thread 0 runs the implicit QL iteration with
// Wilkinson shifts (the classic tqli; an off-diagonal deflates where
// |e_i| + |d_i| + |d_{i+1}| equals |d_i| + |d_{i+1}|, so the zero tail of a
// masked tridiagonal, left by a breakdown or by the error-estimate loop's
// mask, deflates at once) on the one copy of d and e in shared memory, one
// sweep at a time, and writes each sweep's rotations (c_i, s_i) into one
// of two shared buffers. Threads 32.. (the appliers; the rest of warp 0
// idles, so thread 0 issues alone) apply sweep k to the rows of Q they own
// (rows r, r + na, ...) while thread 0 computes sweep k + 1 into the other
// buffer: one barrier per sweep, at one call site for every thread. The
// sweep is a dependent scalar chain, so its latency is the kernel's: a
// rotation's norm takes one reciprocal square root (r = rr rsqrt(rr),
// rr = f^2 + g^2; in double for float data), with hypot and a division
// only where the double squares overflow or underflow. After the last
// sweep, every thread forms w_k = exp(t lambda_k) Q[0, k] and the rows
// out[r] = s sum_k Q[r, k] w_k.
// Storage: d, e and the two rotation buffers (6 m values) in dynamic shared
// memory; Q column-major (Q[k m + r]: a warp's rows are consecutive
// addresses) after them where (m^2 + 6 m) sizeof(T) fits the budget that
// the host picks (ops/kernels/tridiag.py), else in a global scratch
// buffer that the wrapper allocates (m = 250 in float64: 500 KB,
// L2-resident), an applier then loading four columns of its row at a time.
// Every changing scalar (t, s, the diagonals) is read from device memory,
// so a launch captured into a CUDA graph reads the values of each replay.
// Bound: the scalar recurrence. About two QL sweeps per eigenvalue, so
// ~m^2 rotations in one chain, each a reciprocal square root and a few
// dependent FMAs; the 6 flops per row of Q a rotation costs run beside it.
// The 2m values in and the m out are negligible. Making it faster (a
// divide-and-conquer split over warps) is later work.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

// r = sqrt(f^2 + g^2) and inv = 1 / r (0 where r is). Double: one
// reciprocal square root where the squares neither overflow nor
// underflow, hypot and a division elsewhere. Float: the same in double,
// where the squares of any float are safe (rsqrtf's 2 ulp, over the
// ~m^2 rotations of m = 250, moved the result by 1.2e-5 of its largest
// entry from the eigh twin's).
__device__ inline double rot_norm(double f, double g, double& inv) {
  const double rr = f * f + g * g;
  if (rr > 1e-290 && rr < 1e290) {
    inv = rsqrt(rr);
    return rr * inv;
  }
  const double r = hypot(f, g);
  inv = r != 0.0 ? 1.0 / r : 0.0;
  return r;
}

__device__ inline float rot_norm(float f, float g, float& inv) {
  const double rr = (double)f * f + (double)g * g;
  const double id = rr > 0.0 ? rsqrt(rr) : 0.0;
  inv = (float)id;
  return (float)(rr * id);
}

// The first index >= l whose off-diagonal is negligible (m - 1 when none
// is), testing four at a time with their loads issued first.
template <typename T>
__device__ inline int deflation_point(int l, int m, const T* d, const T* e) {
  int mm = l;
  while (mm < m - 1) {
    const int k = min(4, m - 1 - mm);
    T ev[4], dv[5];
#pragma unroll
    for (int u = 0; u < 4; ++u) ev[u] = u < k ? e[mm + u] : T(0);
#pragma unroll
    for (int u = 0; u < 5; ++u) dv[u] = u <= k ? d[mm + u] : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < k) {
        const T dd = fabs(dv[u]) + fabs(dv[u + 1]);
        if (fabs(ev[u]) + dd == dd) return mm + u;
      }
    }
    mm += k;
  }
  return mm;
}

// Thread 0's QL state between sweeps.
struct QlState {
  int l, iter;
  bool ok;
};

// Thread 0: run QL from st until it has made one sweep, writing its
// rotations into C/S (index i: the rotation of columns i and i + 1) and
// returning the indices it rotated, hi down to lo (lo > hi: none);
// hi = -1 when every eigenvalue has converged or an eigenvalue took
// max_iter iterations (st.ok false).
template <typename T>
__device__ inline int2 next_sweep(QlState& st, T* d, T* e, T* C, T* S, int m,
                                  int max_iter) {
  while (st.l < m && st.ok) {
    const int l = st.l;
    const int mm = deflation_point<T>(l, m, d, e);
    if (mm == l) {
      ++st.l;
      st.iter = 0;
      continue;
    }
    if (st.iter++ == max_iter) {
      st.ok = false;
      break;
    }
    // the shift: the eigenvalue of the leading 2 x 2 nearer d_l
    T g = (d[l + 1] - d[l]) / (T(2) * e[l]);
    T r = hypot(g, T(1));
    g = d[mm] - d[l] + e[l] / (g + copysign(r, g));
    T s = T(1), c = T(1), p = T(0);
    // the chain's operands d_{i+1} (not yet written in this sweep), e_i
    // and d_i, loaded one rotation ahead
    T dn = d[mm], ei = e[mm - 1], di = d[mm - 1];
    int i;
    for (i = mm - 1; i >= l; --i) {
      const int in = i > l ? i - 1 : i;
      const T e_n = e[in], d_n = d[in];
      const T f = s * ei, b = c * ei;
      T inv;
      r = rot_norm(f, g, inv);
      e[i + 1] = r;
      if (r == T(0)) {                   // underflow: deflate and restart
        d[i + 1] = dn - p;
        e[mm] = T(0);
        return make_int2(mm - 1, i + 1);
      }
      s = f * inv;
      c = g * inv;
      C[i] = c;
      S[i] = s;
      g = dn - p;
      r = (di - g) * s + T(2) * c * b;
      p = s * r;
      d[i + 1] = g + p;
      g = c * r - b;
      dn = di;
      ei = e_n;
      di = d_n;
    }
    d[l] -= p;
    e[l] = g;
    e[mm] = T(0);
    return make_int2(mm - 1, l);
  }
  return make_int2(-1, 0);
}

// An applier: rotations hi down to lo on row r of Q (column-major, order
// m), the row's column i + 1 carried in a register, four columns loaded
// at a time.
template <typename T>
__device__ inline void apply_sweep(T* Q, const T* C, const T* S, int m,
                                   int r, int hi, int lo) {
  T carry = Q[(size_t)(hi + 1) * m + r];
  int i = hi;
  for (; i - 3 >= lo; i -= 4) {
    T q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = Q[(size_t)(i - u) * m + r];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T c = C[i - u], s = S[i - u];
      Q[(size_t)(i - u + 1) * m + r] = s * q[u] + c * carry;
      carry = c * q[u] - s * carry;
    }
  }
  for (; i >= lo; --i) {
    const T q = Q[(size_t)i * m + r], c = C[i], s = S[i];
    Q[(size_t)(i + 1) * m + r] = s * q + c * carry;
    carry = c * q - s * carry;
  }
  Q[(size_t)lo * m + r] = carry;
}

template <typename T>
__global__ void tridiag_exp_kernel(const T* __restrict__ alpha,
                                   const T* __restrict__ beta,
                                   const T* __restrict__ tp, int t_complex,
                                   const T* __restrict__ sp,
                                   T* __restrict__ out, T* scratch, int m,
                                   int max_iter) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int2 meta[2];               // the sweep of each buffer
  __shared__ int status;
  T* d = reinterpret_cast<T*>(smem_raw);
  T* e = d + m;
  T* C = e + m;                          // 2 x m: buffer b at C + b m
  T* S = C + 2 * (size_t)m;
  T* Q = scratch ? scratch : S + 2 * (size_t)m;
  const int nt = blockDim.x, tid = threadIdx.x;

  for (int i = tid; i < m; i += nt) {
    d[i] = alpha[i];
    e[i] = i + 1 < m ? beta[i] : T(0);
  }
  for (int idx = tid; idx < m * m; idx += nt)
    Q[idx] = idx / m == idx % m ? T(1) : T(0);
  __syncthreads();

  QlState st{0, 0, true};
  for (int k = 0;; ++k) {
    const int b = k & 1;
    if (tid == 0) {
      meta[b] = next_sweep<T>(st, d, e, C + b * m, S + b * m, m, max_iter);
      if (meta[b].x < 0) status = st.ok;
    }
    __syncthreads();                     // sweep k handed over
    const int2 sw = meta[b];
    if (sw.x < 0) break;
    if (tid >= 32 && sw.y <= sw.x)
      for (int r = tid - 32; r < m; r += nt - 32)
        apply_sweep<T>(Q, C + b * m, S + b * m, m, r, sw.x, sw.y);
  }
  // (every applier finished the last sweep before the barrier that ended
  // the loop, so Q is complete and both buffers are free)

  // w_k = exp(t lambda_k) Q[0, k] into the rotation buffers
  const T tr = tp[0], ti = t_complex ? tp[1] : T(0);
  for (int k = tid; k < m; k += nt) {
    const T lam = d[k];
    const T w = Q[(size_t)k * m] * exp(tr * lam);
    if (t_complex) {
      T sn, cs;
      sincos(ti * lam, &sn, &cs);
      C[k] = w * cs;
      S[k] = w * sn;
    } else {
      C[k] = w;
    }
  }
  __syncthreads();
  const T sc = sp ? sp[0] : T(1);
  const bool ok = status;
  for (int r = tid; r < m; r += nt) {
    T re = T(0), im = T(0);
    for (int k = 0; k < m; ++k) {
      const T q = Q[(size_t)k * m + r];
      re += q * C[k];
      if (t_complex) im += q * S[k];
    }
    if (!ok) re = im = T(NAN);           // no convergence: poison, never guess
    if (t_complex) {
      out[2 * r] = sc * re;
      out[2 * r + 1] = sc * im;
    } else {
      out[r] = sc * re;
    }
  }
}

template <typename T>
cudaError_t launch(const T* alpha, const T* beta, const T* t, int t_complex,
                   const T* s, T* out, T* scratch, int m, int threads,
                   long long smem, int max_iter, cudaStream_t stream) {
  static long long allowed = 48 * 1024;  // one flag per instantiation
  if (m <= 0) return cudaSuccess;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        tridiag_exp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  tridiag_exp_kernel<T><<<1, threads, (size_t)smem, stream>>>(
      alpha, beta, t, t_complex, s, out, scratch, m, max_iter);
  return cudaGetLastError();
}

}  // namespace

extern "C" int eu_tridiag_exp_f32(const float* alpha, const float* beta,
                                  const float* t, int t_complex,
                                  const float* s, float* out, float* scratch,
                                  int m, int threads, long long smem,
                                  int max_iter, void* stream) {
  return (int)launch<float>(alpha, beta, t, t_complex, s, out, scratch, m,
                            threads, smem, max_iter, (cudaStream_t)stream);
}

extern "C" int eu_tridiag_exp_f64(const double* alpha, const double* beta,
                                  const double* t, int t_complex,
                                  const double* s, double* out,
                                  double* scratch, int m, int threads,
                                  long long smem, int max_iter,
                                  void* stream) {
  return (int)launch<double>(alpha, beta, t, t_complex, s, out, scratch, m,
                             threads, smem, max_iter, (cudaStream_t)stream);
}

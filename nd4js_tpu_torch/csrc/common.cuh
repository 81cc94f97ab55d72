// Shared device helpers of the nd4js_tpu_torch kernels: a block-wide sum
// and the Householder reflector of one column, with the sign and zero rules
// of nd4js_tpu/ops/house_panel.py:43-53.
#pragma once

#include <cuda_runtime.h>

namespace nd4js {

// Sum of `x` over the whole block. `scratch` holds one value per warp;
// every thread gets the result. Contains __syncthreads().
template <typename T>
__device__ T block_sum(T x, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}

// Scalars of the reflector H = I - tau·v·vᵀ that maps x to beta·e_0,
// v_0 = 1, v_i = x_i / den below: beta = -sign(x0)·‖x‖ (sign(0) = +1),
// tau = 0 for a zero column, den = 1 where it would be 0.
template <typename T>
struct Reflector {
  T beta, tau, den;
};

template <typename T>
__device__ Reflector<T> make_reflector(T x0, T sigma) {
  Reflector<T> h;
  const T nrm = sqrt(x0 * x0 + sigma);
  h.beta = x0 >= T(0) ? -nrm : nrm;
  const T den = x0 - h.beta;
  h.den = den == T(0) ? T(1) : den;
  const T safe_beta = h.beta == T(0) ? T(1) : h.beta;
  h.tau = nrm == T(0) ? T(0) : (h.beta - x0) / safe_beta;
  return h;
}

// Apply H = I - tau·v·vᵀ, v held in shared `v` (rows j..m-1, v[j] = 1), to
// columns c0..ncols-1 of the row-major (m, ld) matrix `a`, rows j..m-1:
//   w_c = tau · Σ_i v_i·a_ic ;  a_ic -= v_i·w_c.
// `part` is shared scratch of at least max(blockDim.x, ncols - c0) values,
// `w` of at least ncols - c0. Threads cover columns fastest, so each row's
// loads and stores are contiguous. Contains __syncthreads().
template <typename T>
__device__ void apply_reflector(T* a, int ld, int m, int j, int c0, int ncols,
                                const T* v, T tau, T* part, T* w) {
  const int nc = ncols - c0;
  if (nc <= 0) return;
  const int groups = blockDim.x >= nc ? blockDim.x / nc : 1;
  for (int idx = threadIdx.x; idx < groups * nc; idx += blockDim.x) {
    const int g = idx / nc;
    const int c = c0 + idx % nc;
    T s = T(0);
    for (int i = j + g; i < m; i += groups) s += v[i] * a[(size_t)i * ld + c];
    part[idx] = s;
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < nc; cc += blockDim.x) {
    T s = T(0);
    for (int g = 0; g < groups; ++g) s += part[g * nc + cc];
    w[cc] = tau * s;
  }
  __syncthreads();
  const size_t total = (size_t)(m - j) * nc;
  for (size_t idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = j + (int)(idx / nc);
    const int cc = (int)(idx % nc);
    a[(size_t)i * ld + c0 + cc] -= v[i] * w[cc];
  }
  __syncthreads();
}

// Householder step j on the row-major (m, ld) matrix `a`: form the
// reflector of column j (rows j..m-1) into shared `v` (v[i] for i >= j),
// apply it to columns j+1..ncols-1, and leave beta on the diagonal and
// zeros below it in column j. Returns the reflector (the same in every
// thread). `red` is shared scratch of one value per warp.
template <typename T>
__device__ Reflector<T> householder_step(T* a, int ld, int m, int j, int ncols,
                                         T* v, T* red, T* part, T* w) {
  T s = T(0);
  for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) {
    const T x = a[(size_t)i * ld + j];
    v[i] = x;
    s += x * x;
  }
  const T sigma = block_sum(s, red);   // syncs: v[] is complete after it
  const T x0 = a[(size_t)j * ld + j];
  const Reflector<T> h = make_reflector(x0, sigma);
  for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) v[i] /= h.den;
  if (threadIdx.x == 0) v[j] = T(1);
  __syncthreads();
  apply_reflector(a, ld, m, j, j + 1, ncols, v, h.tau, part, w);
  for (int i = j + threadIdx.x; i < m; i += blockDim.x)
    a[(size_t)i * ld + j] = i == j ? h.beta : T(0);
  __syncthreads();
  return h;
}

}  // namespace nd4js

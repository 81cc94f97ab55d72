// house_panel: unblocked Householder QR of a batched panel (Nb, M, B).
//
// Replaces the TPU kernel nd4js_tpu/ops/house_panel.py::house_panel
// (_house_panel_kernel). Same contract (house_panel.py:14-16): R_panel holds
// the R block in its top rows and zeros below, V the unit-diagonal reflectors
// with zeros above the diagonal, taus the scalars, H_0···H_{B-1} = I - V·T·Vᵀ
// with T from la/qr._form_t_batched.
//
// Bound on the H100: neither bytes nor operations. The panel is read and its
// outputs written once (3·M·B values), and it does 2·M·B² - 2/3·B³ flops, but
// each of the min(M, B) steps depends on the previous one, so a block spends
// its time on per-step reductions and barriers. Per step a block reads the
// trailing panel twice (w = τ·vᵀA, then A -= v·w), from L2: at M = 512 a fp32
// panel is 256 KB, more than the 227 KB of shared memory a block may hold, so
// it stays in global memory and only the column, v and w live in shared.
//
// Design: the simple first version. One thread block per matrix of the batch,
// columns mapped to threads fastest so that every row access is contiguous.
// house_stripe.cu computes the same panel faster: stripes of 8 columns in the
// shared memory of a thread-block cluster, each applied to the rest as a
// compact-WY block (the port of the TPU's house_stripe_t).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
size_t smem_bytes(int m, int b) {
  const int part = kThreads > b ? kThreads : b;
  return sizeof(T) * ((size_t)m + part + b + 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
house_panel_kernel(const T* __restrict__ a, T* r, T* vout, T* tau, int m, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);
  T* part = v + m;
  T* w = part + (kThreads > b ? kThreads : b);
  T* red = w + b;

  const size_t off = (size_t)blockIdx.x * m * b;
  a += off;
  r += off;
  vout += off;
  tau += (size_t)blockIdx.x * b;
  for (size_t idx = threadIdx.x; idx < (size_t)m * b; idx += blockDim.x) {
    r[idx] = a[idx];
    vout[idx] = T(0);
  }
  for (int c = threadIdx.x; c < b; c += blockDim.x) tau[c] = T(0);
  __syncthreads();

  const int steps = m < b ? m : b;
  for (int j = 0; j < steps; ++j) {
    const nd4js::Reflector<T> h =
        nd4js::householder_step(r, b, m, j, b, v, red, part, w);
    for (int i = j + threadIdx.x; i < m; i += blockDim.x) vout[(size_t)i * b + j] = v[i];
    if (threadIdx.x == 0) tau[j] = h.tau;
    __syncthreads();  // v is rewritten by the next step
  }
}

template <typename T>
int launch(const T* a, T* r, T* v, T* tau, int nb, int m, int b, void* stream) {
  if (nb == 0 || m == 0 || b == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<T>(m, b);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(house_panel_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  house_panel_kernel<T><<<nb, kThreads, smem, (cudaStream_t)stream>>>(a, r, v, tau, m, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_house_panel_f32(const float* a, float* r, float* v, float* tau, int nb, int m,
                          int b, void* stream) {
  return launch<float>(a, r, v, tau, nb, m, b, stream);
}

int nd4js_house_panel_f64(const double* a, double* r, double* v, double* tau, int nb,
                          int m, int b, void* stream) {
  return launch<double>(a, r, v, tau, nb, m, b, stream);
}

}  // extern "C"

// qr_gesv: the square solve x = R⁻¹·Qᵀ·y by Householder QR, factorisation,
// Qᵀ·y and back substitution in one launch.
//
// Replaces the TPU kernel nd4js_tpu/ops/house_stripe.py::qr_gesv
// (_qr_gesv_kernel over _house_stripe_body). Same contract: a (Nb, N, N),
// y (Nb, N, K) -> x (Nb, N, K); a singular R yields inf/nan, with no guard
// (house_stripe.py:211). Full precision only: the TPU's bf16-split dot modes
// have no counterpart here.
//
// Bound on the H100: neither bytes nor operations. It reads N·(N+K) values and
// writes N·K, and does 4/3·N³ + 3·N²·K flops, but the N reflector steps and N
// back-substitution steps are sequential, so one block's per-step reductions
// and barriers set its time. The [A | y] buffer (256 KB at N = 256 in fp32)
// stays in global memory and L2; shared memory holds v, w and the reduction.
//
// Design: the simple first version. One thread block per system works in
// place on the [A | y] scratch buffer the wrapper allocates (row-major,
// N + K columns): N column-by-column Householder steps on the remaining
// columns and the RHS (the TPU kernel's stripes of 8 were a Mosaic layout
// device and are not needed), then column-oriented back substitution.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
size_t smem_bytes(int n, int k) {
  const int ld = n + k;
  const int part = kThreads > ld ? kThreads : ld;
  return sizeof(T) * ((size_t)n + part + ld + 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_gesv_kernel(T* buf, T* x, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + k;
  T* v = reinterpret_cast<T*>(smem_raw);
  T* part = v + n;
  T* w = part + (kThreads > ld ? kThreads : ld);
  T* red = w + ld;

  buf += (size_t)blockIdx.x * n * ld;
  x += (size_t)blockIdx.x * n * k;
  for (int j = 0; j < n; ++j) nd4js::householder_step(buf, ld, n, j, ld, v, red, part, w);

  // R·x = z with z = Qᵀy in columns n..n+k-1; x_j = z_j / R_jj, then
  // z_i -= R_ij·x_j for the rows above. w holds x_j for the k columns.
  for (int j = n - 1; j >= 0; --j) {
    const T d = buf[(size_t)j * ld + j];
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      const T xj = buf[(size_t)j * ld + n + c] / d;
      w[c] = xj;
      x[(size_t)j * k + c] = xj;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < j * k; idx += blockDim.x) {
      const int i = idx / k;
      const int c = idx % k;
      buf[(size_t)i * ld + n + c] -= w[c] * buf[(size_t)i * ld + j];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(T* buf, T* x, int nb, int n, int k, void* stream) {
  if (nb == 0 || n == 0 || k == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<T>(n, k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(qr_gesv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qr_gesv_kernel<T><<<nb, kThreads, smem, (cudaStream_t)stream>>>(buf, x, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_qr_gesv_f32(float* buf, float* x, int nb, int n, int k, void* stream) {
  return launch<float>(buf, x, nb, n, k, stream);
}

int nd4js_qr_gesv_f64(double* buf, double* x, int nb, int n, int k, void* stream) {
  return launch<double>(buf, x, nb, n, k, stream);
}

}  // extern "C"

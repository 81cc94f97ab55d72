// kahan_sum: compensated (Kahan-Babuška-Neumaier) sums of the columns of a
// row-major (n, lanes) operand: out[j] = the sum over i of x[i, j].
//
// Replaces no Pallas kernel. The JAX package runs this recurrence as an XLA
// lax.scan over the reduced axis (nd4js_tpu/core/kahan.py:26-48, kahan_sum),
// which compiles to one device loop; in PyTorch the same loop on the host
// would launch some five ops an element (seconds for 10^6 elements), so the
// port runs it here. Each lane's result is bit-equal to the scan's: the same
// recurrence, the same branch (kahan.py:40-45), the same order, every add
// rounded to nearest with no contraction (the _rn intrinsics).
//
// Bound on the H100: bytes. An element costs one 4- or 8-byte read and
// about four adds, far under the 295 operations a byte where the card's
// arithmetic would bind: a (4096, 65536) float32 operand (1 GiB) takes at
// least 0.32 ms at 3.35 TB/s. With one lane (axis=None, a 1-D sum) the
// loop is one thread's dependent chain: its latency, not the bytes, is the
// time (a two-level compensated design for that case is later work).
//
// Design. One thread a lane, walking the rows in order; the wrapper
// (ops/kahan_sum.py) moves the reduced axis to the front and makes the
// operand contiguous as (n, lanes), so that the threads of a warp read
// neighbouring addresses on every row. The loop is unrolled so that each
// thread keeps several loads in flight ahead of its chain.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kahan_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int lanes) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= lanes) return;
  const T* p = x + j;
  const int64_t stride = lanes;
  T s = T(0), c = T(0);
#pragma unroll 16
  for (int i = 0; i < n; ++i) {
    const T xi = p[(int64_t)i * stride];
    const T t = add_rn(s, xi);
    // Neumaier: the compensation branch by magnitude; a NaN compares false
    // and takes the second branch, as jnp.where does
    const T comp = fabs(s) >= fabs(xi) ? add_rn(sub_rn(s, t), xi) : add_rn(sub_rn(xi, t), s);
    c = add_rn(c, comp);
    s = t;
  }
  out[j] = add_rn(s, c);
}

template <typename T>
int launch(const T* x, T* out, int n, int lanes, void* stream) {
  const int blocks = (lanes + kThreads - 1) / kThreads;
  kahan_sum_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, out, n, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_kahan_sum_f32(const float* x, float* out, int n, int lanes, void* stream) {
  return launch<float>(x, out, n, lanes, stream);
}

int nd4js_kahan_sum_f64(const double* x, double* out, int n, int lanes, void* stream) {
  return launch<double>(x, out, n, lanes, stream);
}

}  // extern "C"

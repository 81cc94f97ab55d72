// chol_leaf: Cholesky factor L, and L⁻¹ when asked, of a batch of small SPD
// blocks (Nb, n, n), n <= 64: the leaves of la/cholesky.py's half/half
// recursion.
//
// Replaces the TPU kernel nd4js_tpu/ops/chol_leaf.py::chol_leaf
// (_chol_leaf_kernel). Same contract as its caller consumes it: L lower
// triangular with zeros above, A = L·Lᵀ; non-SPD input gives NaN (sqrt of a
// negative), never an error. Unlike the TPU kernel, which reads the block
// transposed as it is, this one reads ONLY the lower triangle of A, as the
// plain version (_chol_base) does; the upper triangle may hold anything.
//
// Bound on the H100: neither bytes nor operations. It reads n² values and
// writes n² (2·n² with the inverse) per block, and does n³/3 flops (n³/2
// more for the inverse): 64 dependent column steps, each a dot product and a
// barrier, set the time of one block.
//
// Design: the simple first version. One thread block per matrix, one thread
// per row. The lower triangle is loaded into shared memory (row stride n + 1,
// so the threads' row reads fall in different banks) and factored left-
// looking: at step j, thread i >= j forms A_ij − Σ_k<j L_ik·L_jk, then divides
// by the square root of the diagonal's value. The inverse is forward
// substitution against I with one thread per column: column c of L⁻¹ depends
// only on L and itself, so that loop needs no barrier. In shared memory
// (2·64·65·8 = 66.5 KB for f64 with the inverse) it needs the opt-in above
// 48 KB.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // = the widest leaf: one thread per row

template <typename T>
size_t smem_bytes(int n, bool with_inv) {
  return sizeof(T) * ((size_t)(with_inv ? 2 : 1) * n * (n + 1) + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_leaf_kernel(const T* __restrict__ a, T* l, T* li, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + 1;
  T* s = reinterpret_cast<T*>(smem_raw);          // L, n rows of ld
  T* x = s + (size_t)n * ld;                      // L⁻¹ when li != nullptr
  T* piv = li ? x + (size_t)n * ld : x;           // the diagonal's value

  const size_t off = (size_t)blockIdx.x * n * n;
  a += off;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int c = idx % n;
    s[i * ld + c] = c <= i ? a[idx] : T(0);       // lower triangle only
  }
  __syncthreads();

  const int i = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    T v = T(0);
    if (i >= j && i < n) {
      v = s[i * ld + j];
      for (int k = 0; k < j; ++k) v -= s[i * ld + k] * s[j * ld + k];
      if (i == j) *piv = v;
    }
    __syncthreads();
    if (i >= j && i < n) s[i * ld + j] = v / sqrt(*piv);   // NaN if not SPD
    __syncthreads();
  }

  if (li) {
    const int c = threadIdx.x;   // one column of L⁻¹ per thread
    if (c < n) {
      for (int r = 0; r < c; ++r) x[r * ld + c] = T(0);
      for (int r = c; r < n; ++r) {
        T acc = r == c ? T(1) : T(0);
        for (int k = c; k < r; ++k) acc -= s[r * ld + k] * x[k * ld + c];
        x[r * ld + c] = acc / s[r * ld + r];
      }
    }
    __syncthreads();
  }

  l += off;
  if (li) li += off;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n;
    const int c = idx % n;
    l[idx] = s[r * ld + c];
    if (li) li[idx] = x[r * ld + c];
  }
}

template <typename T>
int launch(const T* a, T* l, T* li, int nb, int n, void* stream) {
  if (nb == 0 || n == 0) return (int)cudaSuccess;
  if (n > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(n, li != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chol_leaf_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chol_leaf_kernel<T><<<nb, kThreads, smem, (cudaStream_t)stream>>>(a, l, li, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_chol_leaf_f32(const float* a, float* l, float* li, int nb, int n, void* stream) {
  return launch<float>(a, l, li, nb, n, stream);
}

int nd4js_chol_leaf_f64(const double* a, double* l, double* li, int nb, int n,
                        void* stream) {
  return launch<double>(a, l, li, nb, n, stream);
}

}  // extern "C"

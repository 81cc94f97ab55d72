// rrqr: column-pivoted Householder QR with downdated squared column norms, on
// a batch of A (Nb, M, N), K = min(M, N) steps.
//
// Replaces the TPU kernel nd4js_tpu/ops/rrqr_kernel.py::rrqr_kernel
// (_rrqr_kernel). Same contract as its caller (la/rrqr.py) consumes it. The
// squared column norms are computed once on entry. At step j they are clamped
// at 0; the pivot p is the column ≥ j of largest norm, the lowest index on a
// tie; columns, perm entries and norms j and p swap; the reflector of column
// j, rows ≥ j, has β = −sign(x₀)·‖x‖, τ = (β − x₀)/β, τ = 0 for a zero
// column, v₀ = 1 (common.cuh: make_reflector); it is applied to the columns
// > j; column j becomes β at row j, zeros below, the old entries above; and
// the norm of each column c > j loses r_jc², r_jc its new row-j entry.
// Outputs: R_packed (column-major, as the (Nb, N, M) array Rᵀ), the
// reflectors (as the (Nb, K, M) array Vᵀ: a unit at j, zeros above), taus
// (Nb, K) and perm (Nb, N) int32. The TPU kernel's masked iota blends and
// lane sums are a plain pivoted QR here: an argmax, one column swap, one
// reflector.
//
// Layout: A comes column-major (the (Nb, N, M) array Aᵀ) so a column is
// contiguous. After the reflector is formed, one warp owns one trailing
// column c: it reduces vᵀa_c with shuffles, subtracts τ·(vᵀa_c)·v and
// downdates the column's norm, with no barrier between columns.
//
// Two regimes, chosen by the caller from the bytes of one matrix:
//   small: A, v and the norms fit in a block's 227 KB of shared memory
//     ((1024, 128, 128) in float32: 64 KB). One block per matrix runs all K
//     steps there.
//   large: A stays in global memory (the R_packed output, L2-resident at
//     (32, 512, 512) in float32: 32 MB). Two launches a step: one block per
//     matrix picks the pivot, swaps and forms the reflector; then a warp per
//     trailing column of every matrix applies it.
//
// Bound on the H100. The factorisation does about 4MNK − 2K²(M + N) + 4K³/3
// flops on MN values in and MN + MK out. At (1024, 128, 128) in float32 that
// is 2.9 GFLOP against 201 MB, so bytes bound it (60 µs against 43 µs); at
// (32, 512, 512), 5.7 GFLOP against 101 MB, operations (86 µs against
// 30 µs). The K steps are dependent: each waits for the last one's norms to
// choose its pivot.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kSmallThreads = 512;
constexpr int kPivotThreads = 1024;
constexpr int kUpdateWarps = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (value, index) with the larger value winning, the lower index on a tie
template <typename T>
__device__ __forceinline__ void arg_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Pivot of step j: clamp the norms ≥ j at 0 (stored back, as the TPU kernel
// stores its clamped norms) and return the index of the largest, the lowest
// on a tie (j if none compares, for NaN norms). Every thread gets it.
// `redv` and `redi` hold one entry per warp. Contains __syncthreads().
template <typename T>
__device__ int pick_pivot(T* nrm, int j, int n, T* redv, int* redi) {
  T best = T(-1);
  int bi = n;
  for (int c = j + threadIdx.x; c < n; c += blockDim.x) {
    T x = nrm[c];
    x = x < T(0) ? T(0) : x;
    nrm[c] = x;
    arg_better(best, bi, x, c);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T v2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    arg_better(best, bi, v2, i2);
  }
  __syncthreads();  // redv and redi may still be read by the last call
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    redv[warp] = best;
    redi[warp] = bi;
  }
  __syncthreads();
  best = redv[0];
  bi = redi[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) arg_better(best, bi, redv[w], redi[w]);
  return bi < n ? bi : j;
}

// Steps 1-3 of step j on one matrix, by one block: pivot, swap, reflector.
// `a` is column-major with columns of length m; `v` receives the reflector
// (rows 0..m-1, zeros above j) and so does row j of `vt`; column j of `a`
// becomes β at j above zeros. Returns τ. Contains __syncthreads().
template <typename T>
__device__ T pivot_and_reflect(T* a, int m, int n, int j, T* nrm, int* perm, T* v,
                               T* vt_row, T* tau_out, T* redv, int* redi) {
  const int p = pick_pivot(nrm, j, n, redv, redi);
  if (p != j) {
    T* cj = a + (size_t)j * m;
    T* cp = a + (size_t)p * m;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const T x = cj[i];
      cj[i] = cp[i];
      cp[i] = x;
    }
  }
  __syncthreads();  // every thread has read nrm[j] and nrm[p] in pick_pivot
  if (threadIdx.x == 0 && p != j) {
    const int t = perm[j];
    perm[j] = perm[p];
    perm[p] = t;
    const T x = nrm[j];
    nrm[j] = nrm[p];
    nrm[p] = x;
  }
  T* x = a + (size_t)j * m;
  T s = T(0);
  for (int i = j + 1 + threadIdx.x; i < m; i += blockDim.x) s += x[i] * x[i];
  const T sigma = nd4js::block_sum(s, redv);  // syncs: the swap is complete
  const nd4js::Reflector<T> h = nd4js::make_reflector(x[j], sigma);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T vi = i < j ? T(0) : (i == j ? T(1) : x[i] / h.den);
    v[i] = vi;
    vt_row[i] = vi;
  }
  __syncthreads();  // x is read in full before column j is overwritten
  for (int i = j + threadIdx.x; i < m; i += blockDim.x) x[i] = i == j ? h.beta : T(0);
  if (threadIdx.x == 0) *tau_out = h.tau;
  return h.tau;
}

// Step 4 of step j on column c > j, by one warp: a_c -= τ·(vᵀa_c)·v over
// rows ≥ j, then the norm downdate by the new row-j entry.
template <typename T>
__device__ void update_column(T* a, int m, int j, int c, const T* v, T tau, T* nrm) {
  const int lane = threadIdx.x & 31;
  T* col = a + (size_t)c * m;
  T s = T(0);
  for (int i = j + lane; i < m; i += 32) s += v[i] * col[i];
  const T w = tau * warp_sum(s);
  for (int i = j + lane; i < m; i += 32) col[i] -= v[i] * w;
  if (lane == 0) {  // row j is lane 0's own
    const T r = col[j];
    nrm[c] -= r * r;
  }
}

template <typename T>
size_t small_smem_bytes(int m, int n) {
  return sizeof(T) * ((size_t)n * m + m + n + 32) + sizeof(int) * ((size_t)n + 32);
}

template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
rrqr_small_kernel(const T* __restrict__ at, T* rt, T* vt, T* taus, int* perm_out, int m,
                  int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);  // n columns of m
  T* v = a + (size_t)n * m;               // m
  T* nrm = v + m;                         // n
  T* redv = nrm + n;                      // 32
  int* perm = reinterpret_cast<int*>(redv + 32);  // n
  int* redi = perm + n;                           // 32

  const size_t mat = blockIdx.x;
  const int k = m < n ? m : n;
  const size_t asz = (size_t)n * m;
  at += mat * asz;
  rt += mat * asz;
  vt += mat * k * (size_t)m;
  taus += mat * k;
  perm_out += mat * n;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (size_t i = threadIdx.x; i < asz; i += blockDim.x) a[i] = at[i];
  for (int c = threadIdx.x; c < n; c += blockDim.x) perm[c] = c;
  __syncthreads();
  for (int c = warp; c < n; c += nwarps) {
    const T* col = a + (size_t)c * m;
    T s = T(0);
    for (int i = threadIdx.x & 31; i < m; i += 32) s += col[i] * col[i];
    s = warp_sum(s);
    if ((threadIdx.x & 31) == 0) nrm[c] = s;
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const T tau = pivot_and_reflect(a, m, n, j, nrm, perm, v, vt + (size_t)j * m, taus + j,
                                    redv, redi);
    for (int c = j + 1 + warp; c < n; c += nwarps) update_column(a, m, j, c, v, tau, nrm);
    __syncthreads();
  }
  for (size_t i = threadIdx.x; i < asz; i += blockDim.x) rt[i] = a[i];
  for (int c = threadIdx.x; c < n; c += blockDim.x) perm_out[c] = perm[c];
}

template <typename T>
__global__ void __launch_bounds__(kUpdateWarps * 32)
rrqr_init_kernel(T* rt, T* nrm, int* perm, int m, int n) {
  const int c = blockIdx.y * kUpdateWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const size_t mat = blockIdx.x;
  const T* col = rt + (mat * n + c) * (size_t)m;
  T s = T(0);
  for (int i = threadIdx.x & 31; i < m; i += 32) s += col[i] * col[i];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) {
    nrm[mat * n + c] = s;
    perm[mat * n + c] = c;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPivotThreads)
rrqr_pivot_kernel(T* rt, T* vt, T* taus, int* perm, T* nrm, int m, int n, int j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);  // m
  T* redv = v + m;                        // 32
  int* redi = reinterpret_cast<int*>(redv + 32);
  const size_t mat = blockIdx.x;
  const int k = m < n ? m : n;
  pivot_and_reflect(rt + mat * n * (size_t)m, m, n, j, nrm + mat * n, perm + mat * n, v,
                    vt + (mat * k + j) * (size_t)m, taus + mat * k + j, redv, redi);
}

template <typename T>
__global__ void __launch_bounds__(kUpdateWarps * 32)
rrqr_update_kernel(T* rt, const T* __restrict__ vt, const T* __restrict__ taus, T* nrm,
                   int m, int n, int j) {
  const int c = j + 1 + blockIdx.y * kUpdateWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const size_t mat = blockIdx.x;
  const int k = m < n ? m : n;
  update_column(rt + mat * n * (size_t)m, m, j, c, vt + (mat * k + j) * (size_t)m,
                taus[mat * k + j], nrm + mat * n);
}

template <typename T>
int launch(const T* at, T* rt, T* vt, T* taus, int* perm, T* nrm, int nb, int m, int n,
           int small, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = m < n ? m : n;
  if (small) {
    const size_t smem = small_smem_bytes<T>(m, n);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(rrqr_small_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    rrqr_small_kernel<T><<<nb, kSmallThreads, smem, s>>>(at, rt, vt, taus, perm, m, n);
    return (int)cudaGetLastError();
  }
  const size_t pivot_smem = sizeof(T) * ((size_t)m + 32) + sizeof(int) * 32;
  if (pivot_smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (pivot_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(rrqr_pivot_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)pivot_smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaMemcpyAsync(rt, at, sizeof(T) * (size_t)nb * n * m,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  rrqr_init_kernel<T><<<dim3(nb, (n + kUpdateWarps - 1) / kUpdateWarps), kUpdateWarps * 32,
                        0, s>>>(rt, nrm, perm, m, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < k; ++j) {
    rrqr_pivot_kernel<T><<<nb, kPivotThreads, pivot_smem, s>>>(rt, vt, taus, perm, nrm, m,
                                                               n, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int trailing = n - j - 1;
    if (trailing == 0) continue;
    rrqr_update_kernel<T><<<dim3(nb, (trailing + kUpdateWarps - 1) / kUpdateWarps),
                            kUpdateWarps * 32, 0, s>>>(rt, vt, taus, nrm, m, n, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int nd4js_rrqr_f32(const float* at, float* rt, float* vt, float* taus, int* perm,
                   float* nrm, int nb, int m, int n, int small, void* stream) {
  return launch<float>(at, rt, vt, taus, perm, nrm, nb, m, n, small, stream);
}

int nd4js_rrqr_f64(const double* at, double* rt, double* vt, double* taus, int* perm,
                   double* nrm, int nb, int m, int n, int small, void* stream) {
  return launch<double>(at, rt, vt, taus, perm, nrm, nb, m, n, small, stream);
}

}  // extern "C"

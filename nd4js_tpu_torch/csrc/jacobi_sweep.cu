// jacobi_sweeps: whole sweeps of one-sided (Hestenes) Jacobi rotations on a
// batch of W (Nb, M, n), n even, accumulating into V (Nb, n, n).
//
// Replaces the TPU kernel nd4js_tpu/ops/jacobi_sweep.py::jacobi_sweeps
// (_sweep_kernel). Same arithmetic: the column norms are computed at the start
// of each sweep and carried through the rotations,
//   app' = c²·app − 2cs·apq + s²·aqq,  aqq' = s²·app + 2cs·apq + c²·aqq,
// clamped at 0 before each use; only apq is reduced afresh. A pair with
// |apq| ≤ tiny is left alone (t = 0); t = 1 for τ = 0; c = rsqrt(1 + t²),
// s = t·c; column p becomes c·p − s·q and column q becomes s·p + c·q.
// off[b] is the largest |apq| / (√app·√aqq + tiny), taken before each
// rotation, over every round of every sweep of the call.
//
// Pair order: the Brent-Luk tournament. Round r pairs top seat i (role p)
// with bottom seat i (role q); between rounds every column but the one at
// top seat 0 moves one place along a ring of n − 1 seats, so after a sweep's
// n − 1 rounds each column is back where it started. The TPU kernel moves
// the columns; here they stay in place and round r's pairs are computed from
// r (pair_cols), which gives the same pairs in the same roles.
//
// Layout: W and V come column-major, as (Nb, n, M) and (Nb, n, n) row-major
// arrays (the transposes of W and V), so a column is contiguous and one warp
// owns one pair: it reads both columns with consecutive lanes on consecutive
// addresses, reduces apq with shuffles and rotates both columns of W and V.
// The pairs of a round touch disjoint columns, so warps need no barrier
// inside a round.
//
// Two regimes, chosen by the caller from the bytes of one matrix:
//   small: W, V and the carried norms fit in a block's 227 KB of shared
//     memory (M = n = 128 in float32 does, in float64 does not). One block
//     per matrix keeps a whole sweep there, a __syncthreads() between rounds.
//   large: W and V stay in global memory, L2-resident; one launch per round
//     over the whole batch, a warp per pair (n/2 · Nb warps), plus one launch
//     per sweep that refreshes the norms. The carried norms live in a global
//     scratch array; off is an atomic max on its bits (off ≥ 0).
//
// Bound on the H100: operations. A sweep does about
// (n − 1)·(n/2)·(8M + 6n) + 2Mn flops on 2·(Mn + n²) values; at
// (1024, 64, 64) in float32 that is 1.9 GFLOP against 67 MB, 28 µs at
// 67 TFLOP/s against 20 µs for the bytes. Each round's apq is a dependent
// reduction, so a round costs at least one warp's shuffle tree.
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kLargeWarps = 8;       // warps per block in the large regime

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// max that keeps a NaN, as jnp.maximum does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ float tiny_of<float>() { return 1.17549435e-38f; }
template <>
__device__ __forceinline__ double tiny_of<double>() { return 2.2250738585072014e-308; }

// Column at ring seat k0 before any shuffle: ring seats 0..h-2 are top seats
// 1..h-1 (columns 1..h-1), ring seats h-1..2h-2 are bottom seats h-1..0
// (columns 2h-1..h).
__device__ __forceinline__ int ring_col(int k0, int h) {
  return k0 <= h - 2 ? k0 + 1 : h + (2 * h - 2 - k0);
}

// Columns (p, q) of pair i in round r: after r shuffles the content of ring
// seat k is what started at ring seat k − r.
__device__ __forceinline__ void pair_cols(int r, int i, int h, int* p, int* q) {
  const int ring = 2 * h - 1;
  if (i == 0) {
    *p = 0;
  } else {
    const int k = i - 1;
    *p = ring_col(((k - r) % ring + ring) % ring, h);
  }
  const int k = 2 * h - 2 - i;
  *q = ring_col(((k - r) % ring + ring) % ring, h);
}

// One pair, by one whole warp: columns p and q of W (columns of length m, one
// after another) and of V (length n), carried norms in nrm. Returns the
// pair's off measure (the same in every lane).
template <typename T>
__device__ T rotate_pair(T* w, int m, T* v, int n, T* nrm, int p, int q) {
  const int lane = threadIdx.x & 31;
  T app = nrm[p];
  T aqq = nrm[q];
  T* wp = w + (size_t)p * m;
  T* wq = w + (size_t)q * m;
  T apq = T(0);
  for (int i = lane; i < m; i += 32) apq += wp[i] * wq[i];
  apq = warp_sum(apq);
  const T tiny = tiny_of<T>();
  app = app < T(0) ? T(0) : app;
  aqq = aqq < T(0) ? T(0) : aqq;
  const T off = fabs(apq) / (sqrt(app) * sqrt(aqq) + tiny);
  const bool small = fabs(apq) <= tiny;
  const T safe = small ? T(1) : apq;
  const T tau = (aqq - app) / (T(2) * safe);
  const T sgn = tau > T(0) ? T(1) : (tau < T(0) ? T(-1) : T(0));
  T t = sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
  if (tau == T(0)) t = T(1);
  if (small) t = T(0);
  const T c = rsqrt(T(1) + t * t);
  const T s = t * c;
  for (int i = lane; i < m; i += 32) {
    const T x = wp[i], y = wq[i];
    wp[i] = c * x - s * y;
    wq[i] = s * x + c * y;
  }
  T* vp = v + (size_t)p * n;
  T* vq = v + (size_t)q * n;
  for (int i = lane; i < n; i += 32) {
    const T x = vp[i], y = vq[i];
    vp[i] = c * x - s * y;
    vq[i] = s * x + c * y;
  }
  const T c2 = c * c, s2 = s * s, cs2 = T(2) * c * s;
  __syncwarp();  // every lane has read nrm[p] and nrm[q]
  if (lane == 0) {
    nrm[p] = c2 * app - cs2 * apq + s2 * aqq;
    nrm[q] = s2 * app + cs2 * apq + c2 * aqq;
  }
  return off;
}

// Squared norm of column c (length m) into nrm[c], by one warp.
template <typename T>
__device__ void column_norm(const T* w, int m, T* nrm, int c) {
  const int lane = threadIdx.x & 31;
  const T* col = w + (size_t)c * m;
  T s = T(0);
  for (int i = lane; i < m; i += 32) s += col[i] * col[i];
  s = warp_sum(s);
  if (lane == 0) nrm[c] = s;
}

template <typename T>
size_t small_smem_bytes(int m, int n) {
  return sizeof(T) * ((size_t)n * m + (size_t)n * n + n + 32);
}

template <typename T>
__global__ void __launch_bounds__(1024)
jacobi_small_kernel(const T* __restrict__ wt_in, const T* __restrict__ vt_in, T* wt_out,
                    T* vt_out, T* off_out, int m, int n, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // n columns of m
  T* v = w + (size_t)n * m;               // n columns of n
  T* nrm = v + (size_t)n * n;             // n carried norms
  T* red = nrm + n;                       // one value per warp

  const size_t mat = blockIdx.x;
  const size_t wsz = (size_t)n * m, vsz = (size_t)n * n;
  wt_in += mat * wsz;
  vt_in += mat * vsz;
  wt_out += mat * wsz;
  vt_out += mat * vsz;
  const int h = n / 2;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (size_t i = threadIdx.x; i < wsz; i += blockDim.x) w[i] = wt_in[i];
  for (size_t i = threadIdx.x; i < vsz; i += blockDim.x) v[i] = vt_in[i];
  __syncthreads();
  T off = T(0);
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int c = warp; c < n; c += nwarps) column_norm(w, m, nrm, c);
    __syncthreads();
    for (int r = 0; r < n - 1; ++r) {
      for (int i = warp; i < h; i += nwarps) {
        int p, q;
        pair_cols(r, i, h, &p, &q);
        off = nan_max(rotate_pair(w, m, v, n, nrm, p, q), off);
      }
      __syncthreads();
    }
  }
  if ((threadIdx.x & 31) == 0) red[warp] = off;
  for (size_t i = threadIdx.x; i < wsz; i += blockDim.x) wt_out[i] = w[i];
  for (size_t i = threadIdx.x; i < vsz; i += blockDim.x) vt_out[i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    T o = T(0);
    for (int k = 0; k < nwarps; ++k) o = nan_max(red[k], o);
    off_out[mat] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
jacobi_norms_kernel(const T* __restrict__ wt, T* nrm, int m, int n) {
  const int c = blockIdx.y * kLargeWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const size_t mat = blockIdx.x;
  column_norm(wt + mat * n * (size_t)m, m, nrm + mat * n, c);
}

// off >= 0 (or a NaN with its sign bit clear), so its bits order as it does
__device__ __forceinline__ void atomic_max_nonneg(float* addr, float x) {
  atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
}
__device__ __forceinline__ void atomic_max_nonneg(double* addr, double x) {
  atomicMax(reinterpret_cast<unsigned long long*>(addr),
            (unsigned long long)__double_as_longlong(x));
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
jacobi_round_kernel(T* wt, T* vt, T* nrm, T* off, int m, int n, int r) {
  const int i = blockIdx.y * kLargeWarps + (threadIdx.x >> 5);
  const int h = n / 2;
  if (i >= h) return;
  const size_t mat = blockIdx.x;
  int p, q;
  pair_cols(r, i, h, &p, &q);
  const T o = rotate_pair(wt + mat * n * (size_t)m, m, vt + mat * n * (size_t)n, n,
                          nrm + mat * n, p, q);
  if ((threadIdx.x & 31) == 0) atomic_max_nonneg(off + mat, o);
}

template <typename T>
int launch(const T* wt_in, const T* vt_in, T* wt, T* vt, T* off, T* nrm, int nb, int m,
           int n, int sweeps, int small, void* stream) {
  if (n < 2 || n % 2 || m < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int h = n / 2;
  if (small) {
    const size_t smem = small_smem_bytes<T>(m, n);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(jacobi_small_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int warps = h < 32 ? h : 32;
    jacobi_small_kernel<T><<<nb, warps * 32, smem, s>>>(wt_in, vt_in, wt, vt, off, m, n,
                                                        sweeps);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemcpyAsync(wt, wt_in, sizeof(T) * (size_t)nb * n * m,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(vt, vt_in, sizeof(T) * (size_t)nb * n * n,
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(off, 0, sizeof(T) * (size_t)nb, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 norm_grid(nb, (n + kLargeWarps - 1) / kLargeWarps);
  const dim3 round_grid(nb, (h + kLargeWarps - 1) / kLargeWarps);
  for (int sw = 0; sw < sweeps; ++sw) {
    jacobi_norms_kernel<T><<<norm_grid, kLargeWarps * 32, 0, s>>>(wt, nrm, m, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int r = 0; r < n - 1; ++r) {
      jacobi_round_kernel<T><<<round_grid, kLargeWarps * 32, 0, s>>>(wt, vt, nrm, off, m,
                                                                      n, r);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int nd4js_jacobi_sweeps_f32(const float* wt_in, const float* vt_in, float* wt, float* vt,
                            float* off, float* nrm, int nb, int m, int n, int sweeps,
                            int small, void* stream) {
  return launch<float>(wt_in, vt_in, wt, vt, off, nrm, nb, m, n, sweeps, small, stream);
}

int nd4js_jacobi_sweeps_f64(const double* wt_in, const double* vt_in, double* wt,
                            double* vt, double* off, double* nrm, int nb, int m, int n,
                            int sweeps, int small, void* stream) {
  return launch<double>(wt_in, vt_in, wt, vt, off, nrm, nb, m, n, sweeps, small, stream);
}

}  // extern "C"

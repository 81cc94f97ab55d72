// trevc_solve: every eigenvector of a batch of split-complex upper triangular
// matrices Tc (Nb, n, n) by backward substitution, (Tc − λ_k)·x_k = 0 with
// x[k, k] = 1 and x[j > k, k] = 0 (LAPACK xTREVC).
//
// Replaces the TPU kernel nd4js_tpu/ops/trevc_solve.py::trevc_solve
// (_trevc_kernel), with the semantics of its XLA form
// (nd4js_tpu/la/schur.py::_trevc_backsub_blocked): for rows i = n−2 … 0,
//   x[i, k] = −(Σ_{j>i} T[i, j]·x[j, k]) / (T[i, i] − λ_k)      (k > i)
// where |T[i, i] − λ_k| ≤ smallnum is clamped to smallnum (a repeated
// eigenvalue then amplifies the earlier eigendirection), the division is
// Smith's, and a column whose new entry exceeds bignum in either part is
// rescaled as a whole by 1/max(|re|, |im|).
//
// Design. On the TPU a sequential grid of 64-row blocks carried x in VMEM
// from step to step. Blocks on Hopper run in no order, but column k of x
// depends on no other column (its growth rescale is its own), so the
// parallel axis is the columns: a block owns a tile of TK columns and runs
// every row bottom-up itself. x stays in global memory, row-major, so the
// TK threads of a row group read x[j, k0..k0+TK) at consecutive addresses.
// Each row's dot products are split over G row groups and summed in shared
// memory (in group order); the row's segment of T is staged in shared
// memory, read by all TK columns. A tile skips the rows at or below its
// last column, whose entries are the initial 1 and 0.
//
// Bound on the H100: operations, about n³/6 complex multiply-adds
// (4n³/3 flops) against 16n² bytes; at n = 1024 about 0.021 ms. The
// per-row barriers (n rows, three each) and the imbalance between the
// short left tiles and the long right ones keep it far from that.
#include <cuda_runtime.h>

namespace {

constexpr int kTK = 16;  // columns per block
constexpr int kG = 16;   // row groups per block

template <typename T>
__device__ __forceinline__ T hypot_t(T a, T b);
template <>
__device__ __forceinline__ float hypot_t<float>(float a, float b) { return hypotf(a, b); }
template <>
__device__ __forceinline__ double hypot_t<double>(double a, double b) { return hypot(a, b); }

// core/cpx.py div: Smith's algorithm, branch for branch
template <typename T>
__device__ __forceinline__ void smith_div(T ar, T ai, T br, T bi, T* zr, T* zi) {
  const bool use_r = fabs(br) >= fabs(bi);
  if (use_r) {
    const T r1 = bi / (br == T(0) ? T(1) : br);
    T den = br + bi * r1;
    if (den == T(0)) den = T(1);
    *zr = (ar + ai * r1) / den;
    *zi = (ai - ar * r1) / den;
  } else {
    const T r2 = br / (bi == T(0) ? T(1) : bi);
    T den = bi + br * r2;
    if (den == T(0)) den = T(1);
    *zr = (ar * r2 + ai) / den;
    *zi = (ai * r2 - ar) / den;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTK * kG)
trevc_kernel(const T* __restrict__ tre, const T* __restrict__ tim,
             const T* __restrict__ lre, const T* __restrict__ lim,
             const T* __restrict__ small, T* __restrict__ xre, T* __restrict__ xim, int n,
             T bignum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* srow_re = reinterpret_cast<T*>(smem_raw);   // n: T[i, :]
  T* srow_im = srow_re + n;
  __shared__ T part_re[kG][kTK], part_im[kG][kTK], fcol[kTK];

  const int c = threadIdx.x, g = threadIdx.y;
  const int tid = g * kTK + c;
  const int k0 = blockIdx.x * kTK;
  const int k = k0 + c;
  const size_t mo = (size_t)blockIdx.y * n * n;
  tre += mo;
  tim += mo;
  xre += mo;
  xim += mo;
  lre += (size_t)blockIdx.y * n;
  lim += (size_t)blockIdx.y * n;
  const int kmax = min(k0 + kTK, n) - 1;   // last column of the tile
  const T smallnum = small[blockIdx.y];
  const T lam_re = k < n ? lre[k] : T(0);
  const T lam_im = k < n ? lim[k] : T(0);

  if (k < n)
    for (int j = g; j < n; j += kG) {
      xre[(size_t)j * n + k] = j == k ? T(1) : T(0);
      xim[(size_t)j * n + k] = T(0);
    }
  __syncthreads();

  for (int i = min(n - 2, kmax - 1); i >= 0; --i) {
    for (int j = i + tid; j <= kmax; j += kTK * kG) {
      srow_re[j] = tre[(size_t)i * n + j];
      srow_im[j] = tim[(size_t)i * n + j];
    }
    __syncthreads();
    T sr = T(0), si = T(0);
    if (k <= kmax && k > i)
      for (int j = i + 1 + g; j <= k; j += kG) {
        const T a = srow_re[j], b = srow_im[j];
        const T xr = xre[(size_t)j * n + k], xi = xim[(size_t)j * n + k];
        sr += a * xr - b * xi;
        si += a * xi + b * xr;
      }
    part_re[g][c] = sr;
    part_im[g][c] = si;
    __syncthreads();
    if (g == 0) {
      T f = T(1);
      if (k <= kmax && k > i) {
        T ar = T(0), ai = T(0);
        for (int gg = 0; gg < kG; ++gg) {
          ar += part_re[gg][c];
          ai += part_im[gg][c];
        }
        T dr = srow_re[i] - lam_re, di = srow_im[i] - lam_im;
        if (hypot_t(dr, di) <= smallnum) {
          dr = smallnum;
          di = T(0);
        }
        T zr, zi;
        smith_div(-ar, -ai, dr, di, &zr, &zi);
        const T m = fmax(fabs(zr), fabs(zi));
        if (m > bignum) f = T(1) / m;
        xre[(size_t)i * n + k] = zr * f;
        xim[(size_t)i * n + k] = zi * f;
      }
      fcol[c] = f;
    }
    __syncthreads();
    // growth rescale of the rows already solved (rare)
    if (k <= kmax && fcol[c] != T(1))
      for (int j = i + 1 + g; j <= k; j += kG) {
        xre[(size_t)j * n + k] *= fcol[c];
        xim[(size_t)j * n + k] *= fcol[c];
      }
  }
}

template <typename T>
int launch(const T* tre, const T* tim, const T* lre, const T* lim, const T* small, T* xre,
           T* xim, int nb, int n, double bignum, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(T) * 2 * (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(trevc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kTK - 1) / kTK, nb);
  const dim3 block(kTK, kG);
  trevc_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      tre, tim, lre, lim, small, xre, xim, n, (T)bignum);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_trevc_solve_f32(const float* tre, const float* tim, const float* lre,
                          const float* lim, const float* small, float* xre, float* xim,
                          int nb, int n, double bignum, void* stream) {
  return launch<float>(tre, tim, lre, lim, small, xre, xim, nb, n, bignum, stream);
}

int nd4js_trevc_solve_f64(const double* tre, const double* tim, const double* lre,
                          const double* lim, const double* small, double* xre,
                          double* xim, int nb, int n, double bignum, void* stream) {
  return launch<double>(tre, tim, lre, lim, small, xre, xim, nb, n, bignum, stream);
}

}  // extern "C"

// house_stripe_t and qr_gesv: stripe-WY Householder elimination on one
// thread-block cluster per matrix, the body in house_stripe.cuh.
//
// Replaces the TPU kernels nd4js_tpu/ops/house_stripe.py::house_stripe_t
// (_house_stripe_kernel) and nd4js_tpu/ops/house_stripe.py::qr_gesv
// (_qr_gesv_kernel), both over _house_stripe_body, and, through the same
// panel launches, nd4js_tpu/ops/house_panel.py::house_panel
// (_house_panel_kernel), whose contract house_stripe_t meets as a drop-in
// (the JAX package's tests/test_qr.py:119-135). Its first port, one block
// of 512 threads a matrix with 128 dependent rank-1 steps each reading the
// trailing panel twice from L2, took 3.3066 ms at (32, 512, 128) where this
// body takes 0.29 (NVIDIA H100 80GB HBM3, 700 W). Same contracts:
//   house_stripe_t: panel (Nb, M, B) -> R_panel, V, taus in house_panel's
//     natural layout (house_stripe.py:311-319): R on and above the diagonal,
//     V unit-diagonal below it, a column with tau = 0 keeps only its unit
//     diagonal, min(M, B) reflectors;
//   qr_gesv: a (Nb, N, N), y (Nb, N, K) -> x (Nb, N, K); a singular R yields
//     inf/nan, with no guard (house_stripe.py:211).
// Full precision only: FP32/FP64 FMA, no TF32; the TPU's bf16-split dot
// modes have no counterpart here.
//
// Bound on the H100: neither bytes nor operations. A panel reads M·B values
// and writes 2·M·B + B, a solve reads N·(N+K) and writes N·K, and both do
// O(M·B²) or O(N³) flops, but the reflector steps are sequential: every one
// is a reduction over the stripe's rows and every stripe of 8 a cluster
// barrier, so the critical path is nhouse dependent steps plus nhouse/8
// barriers, and the back substitution's N/8 dependent block steps after
// them.
//
// Design: the columns of one matrix are spread over a cluster of 1, 2, 4 or
// 8 blocks and kept in their shared memory (the shared regime) when they fit
// 227 KB a block, so no reflector step reads the matrix from L2; larger
// systems keep the columns in the caller's global scratch (the global
// regime), and panels or systems of more rows than one block can stage
// stage the stripe and V in that scratch too (regime 2, gstage). The
// wrapper (ops/house_stripe.py) picks the regime by bytes and
// the cluster size by a rule it states; the launcher checks that a cluster
// can be placed. The scratch the wrapper passes is column-major per matrix: groups
// of 8 columns of M rows; qr_gesv's right-hand sides start at group N/8
// (rounded up), after zero columns. In the shared regime a row-major
// contiguous panel needs no scratch: the slabs load it straight (rowmajor),
// which saves the copy that took 9-19 % of a house_panel call at the
// headline's shapes (chip_smoke.py, phase 4).
#include <cuda_runtime.h>

#include "house_stripe.cuh"

namespace {

using namespace nd4js::stripe;

// The diagonal blocks q0..q1-1 of R into dg, 64 values each.
template <typename T, bool kShared>
__device__ void load_diagonal(const Ctx<T, kShared>& cx, int q0, int q1, int n, T* dg) {
  for (int e = threadIdx.x; e < (q1 - q0) * kW * kW; e += blockDim.x) {
    const int q = q0 + e / (kW * kW), a = (e >> 3) & 7, c = e & 7;
    const int s0 = q * kW, w = min(kW, n - s0);
    dg[e] = (a < w && c < w) ? cx.group_ptr(q)[(size_t)c * cx.ld + s0 + a] : T(0);
  }
}

// Back substitution R·x = z over the stripes, last to first, in the block
// that holds the right-hand sides (the last of the cluster). In the shared
// regime the diagonal blocks of R (from their owners) come into shared
// memory first, all at once, so that a stripe takes two barriers: x of its
// rows, by one thread a right-hand side in the order of the plain version,
// and z above it, by one thread a row. The global regime loads each block
// when it needs it.
template <typename T, bool kShared>
__device__ void back_substitute(Ctx<T, kShared>& cx, T* x, int n, int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ns = cx.sh.nstripes;
  if constexpr (kShared) {
    load_diagonal(cx, 0, ns, n, cx.dg);
    __syncthreads();
  }
  for (int q = ns - 1; q >= 0; --q) {
    const int s0 = q * kW, w = min(kW, n - s0);
    const T* R = cx.group_ptr(q);
    const T* dg = cx.dg;
    if constexpr (kShared) {
      dg += q * kW * kW;
    } else {
      load_diagonal(cx, q, q + 1, n, cx.dg);
      __syncthreads();
    }
    for (int kk = tid; kk < k; kk += nt) {
      const T* z = cx.local_col((cx.nstr + kk / kW) * kW + kk % kW);
      T zr[kW];
#pragma unroll
      for (int a = 0; a < kW; ++a) zr[a] = a < w ? z[s0 + a] : T(0);
#pragma unroll
      for (int a = kW - 1; a >= 0; --a) {
        if (a < w) {
          const T xa = zr[a] / dg[a * kW + a];
          cx.xq[a * k + kk] = xa;
          x[(size_t)(s0 + a) * k + kk] = xa;
#pragma unroll
          for (int b = 0; b < a; ++b) zr[b] -= dg[b * kW + a] * xa;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < s0; i += nt) {
      T rv[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) rv[c] = c < w ? R[(size_t)c * cx.ld + i] : T(0);
      for (int kk = 0; kk < k; ++kk) {
        T* z = cx.local_col((cx.nstr + kk / kW) * kW + kk % kW);
        T zi = z[i];
#pragma unroll
        for (int c = kW - 1; c >= 0; --c)
          if (c < w) zi -= rv[c] * cx.xq[c * k + kk];
        z[i] = zi;
      }
    }
    __syncthreads();
  }
}

// stages: 1 eliminates, 2 back-substitutes (3 both; 2 alone takes an
// already-eliminated [R | Qᵀy], to time the back substitution apart).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
qr_gesv_kernel(T* work, T* x, Shape sh, int n, int k, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mat = blockIdx.x / sh.csize;
  Ctx<T, kShared> cx;
  cx.init(sh, smem_raw, work, mat);
  if constexpr (kShared) load_slab(cx, work, mat);
  __syncthreads();
  if (stages & 1) {
    eliminate(cx);
  } else {
    cluster_arrive();
    cluster_wait();
  }
  if ((stages & 2) && cx.rank == sh.csize - 1) back_substitute(cx, x + (size_t)mat * n * k, n, k);
  // no block leaves while the last one may read its R
  cluster_arrive();
  cluster_wait();
}

// R_panel, V and taus of this block's columns, row-major (M, B), as
// house_stripe.py:311-319 unpacks them.
template <typename T, bool kShared>
__device__ void write_panel(const Ctx<T, kShared>& cx, T* r, T* v, T* tau, int b) {
  const int m = cx.sh.m;
  for (int q = 0; q < cx.nslots; ++q) {
    const int g = cx.group_of_slot(q);
    const T* col0 = cx.local_col(q * kW);
    for (int idx = threadIdx.x; idx < m * kW; idx += blockDim.x) {
      const int i = idx >> 3, kk = idx & 7, c = g * kW + kk;
      if (c >= b) continue;
      const T val = col0[(size_t)kk * cx.ld + i];
      const T t = c < cx.sh.nhouse ? cx.own[q * kW + kk] : T(0);
      r[(size_t)i * b + c] = i <= c ? val : T(0);
      v[(size_t)i * b + c] = i == c ? T(1) : ((i > c && t != T(0)) ? val : T(0));
      if (i == 0) tau[c] = t;
    }
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
house_stripe_kernel(T* work, T* r, T* v, T* tau, Shape sh, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mat = blockIdx.x / sh.csize;
  Ctx<T, kShared> cx;
  cx.init(sh, smem_raw, work, mat);
  if constexpr (kShared) load_slab(cx, work, mat);
  __syncthreads();
  eliminate(cx);  // ends at a cluster barrier: no peer reads this block after it
  const size_t off = (size_t)mat * sh.m * b;
  write_panel(cx, r + off, v + off, tau + (size_t)mat * b, b);
}

// One launch of `kernel` over nb matrices, a cluster of sh.csize blocks each.
template <typename T, typename Kernel, typename... Args>
int launch_stripe(Kernel kernel, const Shape& sh, int nb, void* stream, Args... args) {
  return nd4js::launch_clusters(kernel, nb * sh.csize, block_threads(sh.m), sh.csize,
                                smem_plan(sh).total * sizeof(T), stream, args...);
}

// regime: 1 shared, 0 global, 2 global with the stripe and V staged in the
// scratch too
Shape gesv_shape(int n, int k, int csize, int regime) {
  Shape sh;
  sh.m = n;
  sh.nhouse = n;
  sh.nstripes = (n + kW - 1) / kW;
  sh.ntail = (k + kW - 1) / kW;
  sh.ngroups = sh.nstripes + sh.ntail;
  sh.ktail = k;
  sh.csize = csize;
  sh.shared = regime == 1;
  sh.gstage = regime == 2;
  sh.rowmajor = 0;
  return sh;
}

Shape panel_shape(int m, int b, int csize, int regime) {
  Shape sh;
  sh.m = m;
  sh.nhouse = m < b ? m : b;
  sh.nstripes = (sh.nhouse + kW - 1) / kW;
  sh.ngroups = (b + kW - 1) / kW;
  sh.ntail = sh.ngroups - sh.nstripes;
  sh.ktail = 0;
  sh.csize = csize;
  sh.shared = regime == 1;
  sh.gstage = regime == 2;
  sh.rowmajor = 0;
  return sh;
}

template <typename T>
int gesv(T* work, T* x, int nb, int n, int k, int csize, int regime, int stages, void* stream) {
  if (nb == 0 || n == 0 || k == 0) return (int)cudaSuccess;
  const Shape sh = gesv_shape(n, k, csize, regime);
  if (sh.shared)
    return launch_stripe<T>(qr_gesv_kernel<T, true>, sh, nb, stream, work, x, sh, n, k, stages);
  return launch_stripe<T>(qr_gesv_kernel<T, false>, sh, nb, stream, work, x, sh, n, k, stages);
}

template <typename T>
int panel(T* work, T* r, T* v, T* tau, int nb, int m, int b, int csize, int regime, int rowmajor,
          void* stream) {
  if (nb == 0 || m == 0 || b == 0) return (int)cudaSuccess;
  if (rowmajor && regime != 1) return (int)cudaErrorInvalidValue;
  Shape sh = panel_shape(m, b, csize, regime);
  sh.rowmajor = rowmajor ? b : 0;
  if (sh.shared)
    return launch_stripe<T>(house_stripe_kernel<T, true>, sh, nb, stream, work, r, v, tau, sh,
                              b);
  return launch_stripe<T>(house_stripe_kernel<T, false>, sh, nb, stream, work, r, v, tau, sh,
                            b);
}

}  // namespace

extern "C" {

int nd4js_qr_gesv_f32(float* work, float* x, int nb, int n, int k, int csize, int shared,
                      int stages, void* stream) {
  return gesv<float>(work, x, nb, n, k, csize, shared, stages, stream);
}

int nd4js_qr_gesv_f64(double* work, double* x, int nb, int n, int k, int csize, int shared,
                      int stages, void* stream) {
  return gesv<double>(work, x, nb, n, k, csize, shared, stages, stream);
}

// rowmajor 1: `work` is the row-major panel itself (the shared regime only),
// 0: the column-major scratch.
int nd4js_house_stripe_t_f32(float* work, float* r, float* v, float* tau, int nb, int m, int b,
                             int csize, int shared, int rowmajor, void* stream) {
  return panel<float>(work, r, v, tau, nb, m, b, csize, shared, rowmajor, stream);
}

int nd4js_house_stripe_t_f64(double* work, double* r, double* v, double* tau, int nb, int m,
                             int b, int csize, int shared, int rowmajor, void* stream) {
  return panel<double>(work, r, v, tau, nb, m, b, csize, shared, rowmajor, stream);
}

// Shared memory (bytes) one block of a launch asks for, in regime `shared`
// (1 shared, 0 global, 2 global staged in the scratch): the wrapper's plan
// of regime and cluster size reads it here.
size_t nd4js_house_stripe_smem(int m, int ncols, int nhouse, int ktail, int csize, int shared,
                               int elem) {
  namespace st = nd4js::stripe;
  st::Shape sh;
  sh.m = m;
  sh.nhouse = nhouse;
  sh.nstripes = (nhouse + st::kW - 1) / st::kW;
  sh.ngroups = (ncols + st::kW - 1) / st::kW;
  sh.ntail = sh.ngroups - sh.nstripes;
  sh.ktail = ktail;
  sh.csize = csize;
  sh.shared = shared == 1;
  sh.gstage = shared == 2;
  sh.rowmajor = 0;
  return st::smem_plan(sh).total * (size_t)elem;
}

}  // extern "C"

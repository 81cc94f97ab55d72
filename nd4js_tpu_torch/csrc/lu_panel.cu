// lu_panel and lu_gesv: partial-pivot LU with virtual pivoting, of a batched
// panel (lu_panel) or of square systems with their right-hand sides, solved
// in the same launch (lu_gesv).
//
// Replaces the TPU kernels nd4js_tpu/ops/lu_panel.py::lu_panel
// (_lu_panel_kernel) and nd4js_tpu/ops/lu_panel.py::lu_gesv
// (_lu_gesv_kernel). Same contracts as their callers consume them:
//   lu_panel: (Nb, M, B), M >= B -> the factored panel with rows in INPUT
//     order and rank (Nb, M) int32, the step at which each row became pivot
//     (B if never); la/lu.py sorts rows by (rank, index) into packed form.
//   lu_gesv: a (Nb, N, N), y (Nb, N, K) -> x (Nb, N, K); a zero pivot gives
//     inf/nan, never an error.
// Pivot rule: the largest |a[row][j]| among rows not yet used, ties to the
// lowest row index, no pivot at all if one of them is NaN (as the TPU's
// max-then-first-index does); a zero pivot divides by 1, so a zero column
// gives a zero L column. The TPU kernels' transposed layout, stripes of 8,
// deferred stripe updates and bf16 splits were Mosaic devices: this is plain
// right-looking elimination in full precision. Its products and differences
// are rounded one by one (no fused multiply-add), as the plain versions in
// ops/lu_panel.py compute them.
//
// Bound on the H100: neither bytes nor operations. lu_panel reads and writes
// M·B values and does M·B² − B³/3 flops; lu_gesv reads N·(N+K) values,
// writes N·K and does 2/3·N³ + 2·N²·K flops. But each of the B (or N) steps
// waits for the previous one: a block-wide argmax, then a rank-1 update of
// the rows still unused, with barriers between. One block per matrix.
//
// Design: the simple first version. The matrix sits in shared memory when it
// fits in the 227 KB a block may hold (lu_gesv at N = 128: 66 KB in f32,
// 132 KB in f64; lu_panel up to M = 384 in f32), else in global memory,
// where it stays L2-resident (lu_panel at M = 512 in f32 is 256 KB). The
// unused rows are kept as a compact list, so each step touches only them;
// each warp updates whole rows, its lanes across the columns, so every row
// access is contiguous. lu_gesv
// eliminates [A | y] and then back-substitutes in place, finding row j of U
// through prow[j], the pivot row of step j.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;   // 227 KB, a Hopper block's maximum

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Shared scratch of one elimination besides the matrix.
template <typename T>
struct Scratch {
  T* l;       // m: multipliers, by position in live
  T* urow;    // ncols: the pivot row
  T* sv;      // kWarps: each warp's best |value|
  int* live;  // m: the rows not yet used, in no order
  int* si;    // kWarps: each warp's best row
  int* sq;    // kWarps: its position in live
  int* prow;  // m: the pivot row of each step (-1: none)
};

__host__ __device__ size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
size_t scratch_bytes(int m, int ncols) {
  return align16(sizeof(T) * ((size_t)m + ncols + kWarps)) +
         sizeof(int) * ((size_t)2 * m + 2 * kWarps);
}

template <typename T>
__device__ Scratch<T> carve(unsigned char* p, int m, int ncols) {
  Scratch<T> s;
  s.l = reinterpret_cast<T*>(p);
  s.urow = s.l + m;
  s.sv = s.urow + ncols;
  s.live = reinterpret_cast<int*>(p + align16(sizeof(T) * ((size_t)m + ncols + kWarps)));
  s.si = s.live + m;
  s.sq = s.si + kWarps;
  s.prow = s.sq + kWarps;
  return s;
}

// Is candidate (v, i) better than (bv, bi)? Larger value, then lower row;
// a NaN (carried with row m) beats everything.
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  const bool vn = v != v;
  const bool bn = bv != bv;
  if (vn != bn) return vn;
  if (vn) return false;
  if (v != bv) return v > bv;
  return i < bi;
}

// The pivot of column j among the nlive rows of s.live: (row, position in
// live); row m where there is none. Every thread gets the result.
// Contains __syncthreads().
template <typename T>
__device__ int2 pick_pivot(const T* a, int ld, int m, int j, int nlive,
                           const Scratch<T>& s) {
  T bv = T(-1);
  int bi = m, bq = -1;
  for (int q = threadIdx.x; q < nlive; q += blockDim.x) {
    const int row = s.live[q];
    const T v = fabs(a[(size_t)row * ld + j]);
    const int i = v != v ? m : row;
    if (better(v, i, bv, bi)) { bv = v; bi = i; bq = q; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    const int oq = __shfl_down_sync(0xffffffffu, bq, off);
    if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; bq = oq; }
  }
  __syncthreads();  // the scratch may still be read by the previous call
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    s.sv[w] = bv;
    s.si[w] = bi;
    s.sq[w] = bq;
  }
  __syncthreads();
  bv = s.sv[0];
  bi = s.si[0];
  bq = s.sq[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    if (better(s.sv[w], s.si[w], bv, bi)) { bv = s.sv[w]; bi = s.si[w]; bq = s.sq[w]; }
  return make_int2(bi, bq);
}

// Elimination step j on the row-major (m, ld) matrix `a`, columns j..ncols-1:
// choose the pivot, write the multipliers into column j of the other unused
// rows, update their columns j+1..ncols-1, and take the pivot row off the
// list. Records the step in rank[p] and s.prow[j] (rank may be null).
// Contains __syncthreads().
template <typename T>
__device__ void lu_step(T* a, int ld, int m, int ncols, int j, int& nlive,
                        const Scratch<T>& s, int* rank) {
  const int2 pq = pick_pivot(a, ld, m, j, nlive, s);
  const int p = pq.x;
  const T piv = p < m ? a[(size_t)p * ld + j] : T(0);
  const T safe = piv == T(0) ? T(1) : piv;
  for (int c = j + 1 + threadIdx.x; c < ncols; c += blockDim.x)
    s.urow[c] = p < m ? a[(size_t)p * ld + c] : T(0);
  for (int q = threadIdx.x; q < nlive; q += blockDim.x) {
    const int row = s.live[q];
    T lv = T(0);
    if (row != p) {
      lv = a[(size_t)row * ld + j] / safe;
      a[(size_t)row * ld + j] = lv;
    }
    s.l[q] = lv;
  }
  __syncthreads();
  // one warp per row, its lanes across the columns: contiguous accesses
  // and no index arithmetic beyond a stride
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < nlive; q += blockDim.x >> 5) {
    const int row = s.live[q];
    if (row == p) continue;
    const T lq = s.l[q];
    T* arow = a + (size_t)row * ld;
    for (int c = j + 1 + lane; c < ncols; c += 32) arow[c] = arow[c] - mul_rn(s.urow[c], lq);
  }
  __syncthreads();
  if (p < m) {   // the same in every thread
    if (threadIdx.x == 0) {
      if (rank) rank[p] = j;
      s.prow[j] = p;
      s.live[pq.y] = s.live[nlive - 1];
    }
    --nlive;
    __syncthreads();
  }
}

template <typename T>
__device__ void copy(T* dst, const T* src, size_t count) {
  for (size_t idx = threadIdx.x; idx < count; idx += blockDim.x) dst[idx] = src[idx];
}

// Works in place on `out` (Nb, M, B), which holds the panel on entry.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(T* out, int* rank, int m, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* g = out + (size_t)blockIdx.x * m * b;
  rank += (size_t)blockIdx.x * m;
  T* a = kShared ? reinterpret_cast<T*>(smem_raw) : g;
  const Scratch<T> s =
      carve<T>(smem_raw + (kShared ? align16(sizeof(T) * (size_t)m * b) : 0), m, b);
  if (kShared) copy(a, g, (size_t)m * b);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    rank[i] = b;
    s.live[i] = i;
  }
  __syncthreads();
  int nlive = m;
  for (int j = 0; j < b; ++j) lu_step(a, b, m, b, j, nlive, s, rank);
  if (kShared) copy(g, a, (size_t)m * b);
}

// buf (Nb, N, N + K) holds [A | y] on entry and is scratch; x (Nb, N, K).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
lu_gesv_kernel(T* buf, T* x, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n + k;
  T* g = buf + (size_t)blockIdx.x * n * ld;
  x += (size_t)blockIdx.x * n * k;
  T* a = kShared ? reinterpret_cast<T*>(smem_raw) : g;
  const Scratch<T> s =
      carve<T>(smem_raw + (kShared ? align16(sizeof(T) * (size_t)n * ld) : 0), n, ld);
  if (kShared) copy(a, g, (size_t)n * ld);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.live[i] = i;
    s.prow[i] = -1;
  }
  __syncthreads();
  int nlive = n;
  for (int j = 0; j < n; ++j) lu_step(a, ld, n, ld, j, nlive, s, (int*)nullptr);

  // U·x = z, with row j of U and z in row prow[j]: x_j = z_j / U_jj, then
  // z_i -= U_ij·x_j for the pivot rows of the earlier steps. urow holds x_j.
  T* w = s.urow;
  for (int j = n - 1; j >= 0; --j) {
    const int pr = s.prow[j];
    for (int c = threadIdx.x; c < k; c += blockDim.x) {
      const T d = pr >= 0 ? a[(size_t)pr * ld + j] : T(0);
      const T z = pr >= 0 ? a[(size_t)pr * ld + n + c] : T(0);
      const T xj = z / d;   // inf/nan on a zero pivot, like lu.js
      w[c] = xj;
      x[(size_t)j * k + c] = xj;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < j; q += blockDim.x) {
      const int row = s.prow[q];
      if (row < 0) continue;
      T* arow = a + (size_t)row * ld;
      for (int c = 0; c < k; ++c) arow[n + c] = arow[n + c] - mul_rn(arow[j], w[c]);
    }
    __syncthreads();
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB default.
template <typename K, typename... Args>
int launch(K kernel, int nb, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_panel(T* out, int* rank, int nb, int m, int b, void* stream) {
  if (nb == 0 || m == 0 || b == 0) return (int)cudaSuccess;
  if (m < b) return (int)cudaErrorInvalidValue;
  const size_t scratch = scratch_bytes<T>(m, b);
  const size_t whole = align16(sizeof(T) * (size_t)m * b) + scratch;
  if (whole <= kSmemMax)
    return launch(lu_panel_kernel<T, true>, nb, whole, stream, out, rank, m, b);
  return launch(lu_panel_kernel<T, false>, nb, scratch, stream, out, rank, m, b);
}

template <typename T>
int launch_gesv(T* buf, T* x, int nb, int n, int k, void* stream) {
  if (nb == 0 || n == 0 || k == 0) return (int)cudaSuccess;
  const size_t scratch = scratch_bytes<T>(n, n + k);
  const size_t whole = align16(sizeof(T) * (size_t)n * (n + k)) + scratch;
  if (whole <= kSmemMax)
    return launch(lu_gesv_kernel<T, true>, nb, whole, stream, buf, x, n, k);
  return launch(lu_gesv_kernel<T, false>, nb, scratch, stream, buf, x, n, k);
}

}  // namespace

extern "C" {

int nd4js_lu_panel_f32(float* out, int* rank, int nb, int m, int b, void* stream) {
  return launch_panel<float>(out, rank, nb, m, b, stream);
}

int nd4js_lu_panel_f64(double* out, int* rank, int nb, int m, int b, void* stream) {
  return launch_panel<double>(out, rank, nb, m, b, stream);
}

int nd4js_lu_gesv_f32(float* buf, float* x, int nb, int n, int k, void* stream) {
  return launch_gesv<float>(buf, x, nb, n, k, stream);
}

int nd4js_lu_gesv_f64(double* buf, double* x, int nb, int n, int k, void* stream) {
  return launch_gesv<double>(buf, x, nb, n, k, stream);
}

}  // extern "C"

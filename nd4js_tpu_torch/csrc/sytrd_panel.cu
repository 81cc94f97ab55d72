// sytrd_panel: one latrd panel of symmetric tridiagonalisation of a batch of
// symmetric blocks C (Nb, m, m), and the rank-2b update of the trailing block.
//
// Replaces the TPU kernel nd4js_tpu/ops/sytrd_panel.py::sytrd_panel
// (_sytrd_panel_kernel). Same contract as its caller (la/sytrd.py) consumes
// it: for each of the bk leading columns j, column j of C − V·Wᵀ − W·Vᵀ gives
// d[j], the reflector H_j = I − τ·v·vᵀ (unit at row j + 1, zeros above) and
// e[j] = β; then w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)), w −= ½τ(wᵀv)·v. A column
// already zero below the subdiagonal gives τ = 0, β = its subdiagonal entry.
// Outputs: the trailing block (C − V·Wᵀ − W·Vᵀ)[bk:, bk:] as its own
// (Nb, m − bk, m − bk) array, V and W as (Nb, bk, m) panels (one reflector a
// row), taus, d, e (Nb, bk). The trailing block is exactly symmetric: entry
// (i, j ≥ i) is computed once as (c_ij − x_ij) − x_ji, X = V·Wᵀ, and written
// to both (i, j) and (j, i), so the next panel may read column j as row j.
// The input must be exactly symmetric too (la/sytrd.py symmetrises it).
//
// Bound on the H100: operations. At (1, 1024, 64) in f32 a panel moves about
// 8.2 MB (C in, the trailing block out, V and W) but does about 0.27 GFLOP:
// 64 matrix-vector products with C (0.13 GFLOP), the update of the upper
// triangle of the trailing block (0.12 GFLOP) and the latrd corrections,
// about 4 µs at 67 TFLOP/s against 2.5 µs for the bytes. The column loop is
// far from that: its 64 steps are dependent, and each reads all of C again.
//
// Design: the simple first version. Two kernels, launched one after the
// other by the same C function:
//   sytrd_cols_kernel: one block of 1024 threads per matrix runs the column
//     loop. C (4 MB at m = 1024 in f32) does not fit in the 227 KB of shared
//     memory a block may hold, so it stays in global memory, resident in the
//     50 MB L2; each step's C·v is computed as vᵀC, a thread per column of C,
//     so a warp's loads are contiguous. V and W are kept transposed (a row a
//     reflector) for the same reason. The column and v live in shared memory.
//     At Nb = 1 this runs on 1 of the 132 SMs, bound by that SM's share of
//     L2 bandwidth (64 reads of C a panel).
//   sytrd_update_kernel: the rank-2b update over many blocks, one 32×32 tile
//     of the upper triangle each, with the tile's slices of V and W in
//     shared memory; a tile is mirrored through shared memory so both writes
//     are contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kMaxBk = 64;
constexpr size_t kSmemMax = 232448;   // 227 KB, a Hopper block's maximum

// Sum of v over the block; every thread gets the result. Contains
// __syncthreads().
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <typename T>
size_t cols_smem_bytes(int m, int bk) {
  return sizeof(T) * ((size_t)2 * m + 2 * bk + kWarps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sytrd_cols_kernel(const T* __restrict__ c, T* vt, T* wt, T* taus, T* d, T* e, int m,
                  int bk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // m: column j, later w
  T* v = col + m;                           // m: the reflector
  T* pw = v + m;                            // bk: Wᵀv
  T* pv = pw + bk;                          // bk: Vᵀv
  T* red = pv + bk;                         // kWarps

  const size_t mat = blockIdx.x;
  const size_t mm = (size_t)m;
  c += mat * mm * mm;
  vt += mat * bk * mm;
  wt += mat * bk * mm;
  taus += mat * bk;
  d += mat * bk;
  e += mat * bk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int j = 0; j < bk; ++j) {
    // finished column j of C − V·Wᵀ − W·Vᵀ, rows j.. (C symmetric: row j)
    for (int i = tid; i < m; i += kThreads) {
      T x = T(0);
      if (i >= j) {
        T a = T(0), b = T(0);
        for (int k = 0; k < j; ++k) {
          a += vt[k * mm + i] * wt[k * mm + j];
          b += wt[k * mm + i] * vt[k * mm + j];
        }
        x = c[j * mm + i] - a - b;
      }
      col[i] = x;
    }
    T part = T(0);
    __syncthreads();
    for (int i = j + 2 + tid; i < m; i += kThreads) part += col[i] * col[i];
    const T sigma = block_sum(part, red);
    const T x0 = col[j + 1];
    const T nrm = sqrt(x0 * x0 + sigma);
    T beta = x0 >= T(0) ? -nrm : nrm;
    if (sigma == T(0)) beta = x0;  // no-op reflector
    const T den = x0 - beta;
    const T safe_den = den == T(0) ? T(1) : den;
    const T safe_beta = beta == T(0) ? T(1) : beta;
    const T tau = sigma == T(0) ? T(0) : (beta - x0) / safe_beta;
    if (tid == 0) {
      d[j] = col[j];
      e[j] = beta;
      taus[j] = tau;
    }
    for (int i = tid; i < m; i += kThreads) {
      const T vi = i > j + 1 ? col[i] / safe_den : (i == j + 1 ? T(1) : T(0));
      v[i] = vi;
      vt[j * mm + i] = vi;
    }
    __syncthreads();
    // Wᵀv and Vᵀv over the earlier reflectors, a warp each (v is 0 above j + 1)
    for (int k = warp; k < j; k += kWarps) {
      T sw = T(0), sv = T(0);
      for (int i = j + 1 + lane; i < m; i += 32) {
        sw += wt[k * mm + i] * v[i];
        sv += vt[k * mm + i] * v[i];
      }
      for (int off = 16; off > 0; off >>= 1) {
        sw += __shfl_down_sync(0xffffffffu, sw, off);
        sv += __shfl_down_sync(0xffffffffu, sv, off);
      }
      if (lane == 0) {
        pw[k] = sw;
        pv[k] = sv;
      }
    }
    __syncthreads();
    // w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)) on all m rows, C·v read as vᵀC; every
    // read of col above is behind the last barrier, so col now takes w
    T wv = T(0);
    for (int i = tid; i < m; i += kThreads) {
      T acc = T(0);
#pragma unroll 8
      for (int l = j + 1; l < m; ++l) acc += c[l * mm + i] * v[l];
      T a = T(0), b = T(0);
      for (int k = 0; k < j; ++k) {
        a += vt[k * mm + i] * pw[k];
        b += wt[k * mm + i] * pv[k];
      }
      const T wi = tau * (acc - a - b);
      col[i] = wi;
      wv += wi * v[i];
    }
    const T corr = T(0.5) * tau * block_sum(wv, red);
    for (int i = tid; i < m; i += kThreads) wt[j * mm + i] = col[i] - corr * v[i];
    __syncthreads();  // the next step reads this step's V and W rows
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
sytrd_update_kernel(const T* __restrict__ c, const T* __restrict__ vt,
                    const T* __restrict__ wt, T* __restrict__ out, int m, int bk) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.z;
  if (ti > tj) return;  // the upper triangle of tiles only
  __shared__ T sv_r[kTile][kTile + 1];
  __shared__ T sw_r[kTile][kTile + 1];
  __shared__ T sv_c[kTile][kTile + 1];
  __shared__ T sw_c[kTile][kTile + 1];
  __shared__ T res[kTile][kTile + 1];

  const size_t mat = blockIdx.x;
  const size_t mm = (size_t)m;
  const size_t mt = (size_t)(m - bk);
  c += mat * mm * mm;
  vt += mat * bk * mm;
  wt += mat * bk * mm;
  out += mat * mt * mt;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int r0 = bk + ti * kTile;  // the tile's first row and column in C
  const int c0 = bk + tj * kTile;
  const int i = r0 + ty;
  const int jj = c0 + tx;

  T xij = T(0), xji = T(0);  // (V·Wᵀ)_ij and (V·Wᵀ)_ji
  for (int k0 = 0; k0 < bk; k0 += kTile) {
    const int k = k0 + ty;
    const bool kin = k < bk;
    sv_r[ty][tx] = kin && r0 + tx < m ? vt[k * mm + r0 + tx] : T(0);
    sw_r[ty][tx] = kin && r0 + tx < m ? wt[k * mm + r0 + tx] : T(0);
    sv_c[ty][tx] = kin && c0 + tx < m ? vt[k * mm + c0 + tx] : T(0);
    sw_c[ty][tx] = kin && c0 + tx < m ? wt[k * mm + c0 + tx] : T(0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      xij += sv_r[kk][ty] * sw_c[kk][tx];
      xji += sv_c[kk][tx] * sw_r[kk][ty];
    }
    __syncthreads();
  }
  T val = T(0);
  if (i <= jj && jj < m) {
    val = c[i * mm + jj] - xij - xji;
    out[(i - bk) * mt + (jj - bk)] = val;
  }
  res[ty][tx] = val;
  __syncthreads();
  // mirror: this thread writes (c0 + ty, r0 + tx) from its transpose
  const int si = r0 + tx;
  const int sj = c0 + ty;
  if (si < sj && sj < m) out[(sj - bk) * mt + (si - bk)] = res[tx][ty];
}

template <typename T>
int launch(const T* c, T* out, T* vt, T* wt, T* taus, T* d, T* e, int nb, int m, int bk,
           void* stream) {
  if (nb == 0) return (int)cudaSuccess;
  if (bk < 1 || bk > kMaxBk || bk > m - 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cols_smem_bytes<T>(m, bk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sytrd_cols_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  sytrd_cols_kernel<T><<<nb, kThreads, smem, s>>>(c, vt, wt, taus, d, e, m, bk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (m - bk + kTile - 1) / kTile;
  sytrd_update_kernel<T><<<dim3(nb, nt, nt), dim3(kTile, kTile), 0, s>>>(c, vt, wt, out, m,
                                                                         bk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_sytrd_panel_f32(const float* c, float* out, float* vt, float* wt, float* taus,
                          float* d, float* e, int nb, int m, int bk, void* stream) {
  return launch<float>(c, out, vt, wt, taus, d, e, nb, m, bk, stream);
}

int nd4js_sytrd_panel_f64(const double* c, double* out, double* vt, double* wt,
                          double* taus, double* d, double* e, int nb, int m, int bk,
                          void* stream) {
  return launch<double>(c, out, vt, wt, taus, d, e, nb, m, bk, stream);
}

}  // extern "C"

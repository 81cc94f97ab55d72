// schur_small: the complete real Schur form of a batch of small upper
// Hessenberg matrices (Nb, W, W), W ≤ 128, one block per matrix, in one
// launch: A = Q·T·Qᵀ with T quasi-triangular.
//
// Replaces the TPU kernel nd4js_tpu/ops/schur_small.py::schur_small
// (_make_kernel). Same iteration, rule for rule (schur_small.py:105-233):
//   * deflation scan: T[j+1, j] → 0 where |T[j+1, j]| ≤ max(16·eps·(|T[j,j]|
//     + |T[j+1,j+1]|), eps·‖T‖_F); then the subdiagonal next to a locked pair
//     (and not itself locked) → 0;
//   * active window [lo, hi): hi − 2 the last live (nonzero, unlocked)
//     subdiagonal, lo after the last dead one below hi − 1;
//   * hi − lo = 2: the cancellation-free 2×2 rotation and T[lo+1, lo] = 0
//     when the discriminant is ≥ 0, else lock the pair;
//   * otherwise one Francis double-shift chase over [lo, hi) with the
//     Wilkinson shift of the trailing 2×2, or the exceptional shift
//     λ = T[n,n] + 0.75·(|T[n,m]| + |T[m,m−1]|) when stuck % 10 == 9, and the
//     final 2×2 rotation at hi − 2;
//   * stuck counts chase rounds, is reset by a standardisation and whenever
//     hi changes; at most max_iter = 40·W rounds.
// T leaves with the chase's roundoff below the subdiagonal in place (the
// caller measures it). locked (Nb, W) holds 0/1 per subdiagonal position,
// iters (Nb,) the rounds taken.
//
// Design. The TPU kernel extracts every scalar as a masked reduction over
// the whole block and applies each 3-element reflector as a full-block
// update, because Mosaic cannot index lanes: O(W²) work a step. Here a
// reflector touches what it changes: three rows (W entries each) and three
// columns of T and of Q, one thread per row or column, with two barriers a
// step. Every thread rebuilds the reflector itself from three values that
// the threads owning those rows wrote to a small double-buffered array, so
// no thread waits on a scalar broadcast. The control scalars (lo, hi) come
// from one thread's scan of the subdiagonal, ‖T‖_F from a block reduction.
//
// Bound on the H100: neither bytes nor operations but the latency of the
// step chain: each chase step is a few W flops behind two barriers, and the
// steps of a matrix are sequential. The bound reported beside the kernel
// counts, over the plain version's trajectory on the same input, only the
// entries each step must update: ~10 flops for each of the (W − k + 1)
// columns of T's three rows, the (k + 4) rows of its three columns and the
// nonzero rows of Q's three columns.
//
// Memory: T lives in shared memory (W² values); Q too when both fit a
// block's 227 KB (W = 128 in float32), otherwise Q is updated in place in
// the output in global memory (float64 at W = 128), where it stays in L2.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kThreads = 128;        // one thread per row or column, W ≤ 128

template <typename T>
__device__ __forceinline__ T eps_of();
template <>
__device__ __forceinline__ float eps_of<float>() { return 1.1920929e-07f; }
template <>
__device__ __forceinline__ double eps_of<double>() { return 2.220446049250313e-16; }

template <typename T>
struct House3 {
  T v1, v2, tau;
};

// la/schur.py _house3: the reflector annihilating p1, p2 (v0 = 1)
template <typename T>
__device__ __forceinline__ House3<T> house3(T p0, T p1, T p2) {
  House3<T> h;
  const T sigma = p1 * p1 + p2 * p2;
  const T nrm = sqrt(p0 * p0 + sigma);
  const T beta = p0 >= T(0) ? -nrm : nrm;
  const T den = p0 - beta;
  const T sden = den == T(0) ? T(1) : den;
  h.v1 = sigma == T(0) ? T(0) : p1 / sden;
  h.v2 = sigma == T(0) ? T(0) : p2 / sden;
  const T sbeta = beta == T(0) ? T(1) : beta;
  h.tau = nrm == T(0) ? T(0) : (beta - p0) / sbeta;
  if (sigma == T(0)) h.tau = T(0);
  return h;
}

template <typename T>
__device__ __forceinline__ void rot2(T g1, T g2, T* cs, T* sn) {
  const T nrm = sqrt(g1 * g1 + g2 * g2);
  *cs = nrm == T(0) ? T(1) : g1 / nrm;
  *sn = nrm == T(0) ? T(0) : g2 / nrm;
}

// T ← Gᵀ·T·G and Q ← Q·G for G = I but [[cs, −sn], [sn, cs]] at (k, k+1):
// rows first, then columns, as (Gᵀ·T)·G. Contains __syncthreads().
template <typename T>
__device__ void apply_rot2(T* t, T* q, int W, int k, T cs, T sn) {
  const int tid = threadIdx.x;
  for (int c = tid; c < W; c += blockDim.x) {
    const T r0 = t[k * W + c], r1 = t[(k + 1) * W + c];
    t[k * W + c] = cs * r0 + sn * r1;
    t[(k + 1) * W + c] = -sn * r0 + cs * r1;
  }
  __syncthreads();
  for (int r = tid; r < W; r += blockDim.x) {
    const T c0 = t[r * W + k], c1 = t[r * W + k + 1];
    t[r * W + k] = cs * c0 + sn * c1;
    t[r * W + k + 1] = -sn * c0 + cs * c1;
    const T d0 = q[r * W + k], d1 = q[r * W + k + 1];
    q[r * W + k] = cs * d0 + sn * d1;
    q[r * W + k + 1] = -sn * d0 + cs * d1;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_small_kernel(const T* __restrict__ a, T* __restrict__ t_out, T* __restrict__ q_out,
                   T* __restrict__ lk_out, int* __restrict__ it_out, int W, int max_iter,
                   int q_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  T* lk = t + (size_t)W * W;         // W: 0/1 per subdiagonal position
  T* red = lk + W;                   // 32: block_sum scratch
  T* pbuf = red + 32;                // 2 × 3: the next bulge column, by parity
  T* q = q_in_smem ? pbuf + 8 : q_out + (size_t)blockIdx.x * W * W;
  __shared__ int ctl[2];             // lo, hi

  const int tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * W * W;
  const T eps = eps_of<T>();
  for (int idx = tid; idx < W * W; idx += blockDim.x) {
    t[idx] = a[off + idx];
    q[idx] = (idx / W == idx % W) ? T(1) : T(0);
  }
  for (int j = tid; j < W; j += blockDim.x) lk[j] = T(0);
  __syncthreads();

  int it = 0, stuck = 0, hi_prev = -1;
  while (hi_prev != 0 && it < max_iter) {
    // ---- deflation scan, with the norm floor eps·‖T‖_F
    T s = T(0);
    for (int idx = tid; idx < W * W; idx += blockDim.x) s += t[idx] * t[idx];
    const T floor = eps * sqrt(nd4js::block_sum(s, red));
    for (int j = tid; j < W - 1; j += blockDim.x) {
      const T sub = t[(j + 1) * W + j];
      const T dsum = fabs(t[j * W + j]) + fabs(t[(j + 1) * W + j + 1]);
      const T thr = T(16) * eps * dsum;
      if (fabs(sub) <= (thr > floor ? thr : floor)) t[(j + 1) * W + j] = T(0);
    }
    __syncthreads();
    // ---- re-zero next to locked pairs
    for (int j = tid; j < W - 1; j += blockDim.x) {
      const bool me = lk[j] > T(0.5);
      const bool nbr = (j > 0 && lk[j - 1] > T(0.5)) || lk[j + 1] > T(0.5);
      if (nbr && !me) t[(j + 1) * W + j] = T(0);
    }
    __syncthreads();
    // ---- active window [lo, hi)
    if (tid == 0) {
      int hi = 0;
      for (int j = 0; j < W - 1; ++j)
        if (lk[j] <= T(0.5) && t[(j + 1) * W + j] != T(0)) hi = j + 2;
      int lo = 0;
      for (int j = 0; j < hi - 1; ++j)
        if (!(lk[j] <= T(0.5) && t[(j + 1) * W + j] != T(0))) lo = j + 1;
      ctl[0] = lo;
      ctl[1] = hi;
    }
    __syncthreads();
    const int lo = ctl[0], hi = ctl[1];
    const bool size2 = hi - lo == 2;
    if (hi > 0 && size2) {
      const T aa = t[lo * W + lo], bb = t[lo * W + lo + 1];
      const T cc = t[(lo + 1) * W + lo], dd = t[(lo + 1) * W + lo + 1];
      const T disc = (aa - dd) * (aa - dd) + T(4) * bb * cc;
      // every thread has read the block before apply_rot2 rewrites it (a
      // late reader would build another rotation, or skip its barriers)
      __syncthreads();
      if (disc >= T(0)) {
        // cancellation-free: λ−aa = −sgn(p)(|p|+sq), λ−dd = −sgn(p)·bc/(sq+|p|)
        const T p = T(0.5) * (aa - dd);
        const T sq = sqrt(disc > T(0) ? disc : T(0)) * T(0.5);
        const T sgn = p >= T(0) ? T(1) : T(-1);
        const T lam_m_aa = -sgn * (fabs(p) + sq);
        const T den = sq + fabs(p);
        const T lam_m_dd = -sgn * bb * cc / (den == T(0) ? T(1) : den);
        const bool big_b = fabs(bb) >= fabs(cc);
        T cs, sn;
        rot2(big_b ? bb : lam_m_dd, big_b ? lam_m_aa : cc, &cs, &sn);
        apply_rot2(t, q, W, lo, cs, sn);
        if (tid == 0) t[(lo + 1) * W + lo] = T(0);
      } else if (tid == 0) {
        lk[lo] = T(1);
      }
    } else if (hi > 0) {
      const int m = hi - 2;
      const T h_mm = t[m * W + m], h_nn = t[(hi - 1) * W + hi - 1];
      const T h_mn = t[m * W + hi - 1], h_nm = t[(hi - 1) * W + m];
      T tr = h_mm + h_nn;
      T det = h_mm * h_nn - h_mn * h_nm;
      if (stuck % 10 == 9) {   // exceptional shift (dlahqr)
        const T s_mag = fabs(h_nm) + (m >= 1 ? fabs(t[m * W + m - 1]) : T(0));
        const T lam = h_nn + T(0.75) * s_mag;
        tr = T(2) * lam;
        det = lam * lam;
      }
      const T h00 = t[lo * W + lo], h01 = t[lo * W + lo + 1];
      const T h10 = t[(lo + 1) * W + lo], h11 = t[(lo + 1) * W + lo + 1];
      const T h21 = t[(lo + 2) * W + lo + 1];
      T p0 = h00 * h00 + h01 * h10 - tr * h00 + det;
      T p1 = h10 * (h00 + h11 - tr);
      T p2 = h10 * h21;
      __syncthreads();   // every thread has read the seed before the rows move
      for (int k = lo; k < hi - 2; ++k) {
        const House3<T> h = house3(p0, p1, p2);
        if (h.tau != T(0)) {
          for (int c = tid; c < W; c += blockDim.x) {
            const T w = h.tau * (t[k * W + c] + h.v1 * t[(k + 1) * W + c] +
                                 h.v2 * t[(k + 2) * W + c]);
            t[k * W + c] -= w;
            t[(k + 1) * W + c] -= h.v1 * w;
            t[(k + 2) * W + c] -= h.v2 * w;
          }
        }
        __syncthreads();
        T* nxt = pbuf + 3 * ((k - lo) & 1);
        for (int r = tid; r < W; r += blockDim.x) {
          if (h.tau != T(0)) {
            T* tr_ = t + r * W + k;
            const T w = h.tau * (tr_[0] + h.v1 * tr_[1] + h.v2 * tr_[2]);
            tr_[0] -= w;
            tr_[1] -= h.v1 * w;
            tr_[2] -= h.v2 * w;
            T* qr = q + r * W + k;
            const T wq = h.tau * (qr[0] + h.v1 * qr[1] + h.v2 * qr[2]);
            qr[0] -= wq;
            qr[1] -= h.v1 * wq;
            qr[2] -= h.v2 * wq;
          }
          // the next bulge column T[k+1..k+3, k], from the rows' owners
          if (r >= k + 1 && r <= k + 3) nxt[r - k - 1] = t[r * W + k];
        }
        __syncthreads();
        p0 = nxt[0];
        p1 = nxt[1];
        p2 = (k + 3 < hi) ? nxt[2] : T(0);
      }
      T cs, sn;
      rot2(p0, p1, &cs, &sn);
      apply_rot2(t, q, W, hi - 2, cs, sn);
    }
    if (hi > 0) stuck = size2 ? 0 : stuck + 1;
    if (hi != hi_prev) stuck = 0;
    hi_prev = hi;
    ++it;
    __syncthreads();
  }

  for (int idx = tid; idx < W * W; idx += blockDim.x) {
    t_out[off + idx] = t[idx];
    if (q_in_smem) q_out[off + idx] = q[idx];
  }
  for (int j = tid; j < W; j += blockDim.x) lk_out[(size_t)blockIdx.x * W + j] = lk[j];
  if (tid == 0) it_out[blockIdx.x] = it;
}

template <typename T>
size_t smem_bytes(int W, bool q_in_smem) {
  return sizeof(T) * ((size_t)W * W * (q_in_smem ? 2 : 1) + W + 32 + 8);
}

template <typename T>
int launch(const T* a, T* t, T* q, T* lk, int* its, int nb, int W, int max_iter,
           void* stream) {
  if (W < 1 || W > kThreads) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  const bool q_in_smem = smem_bytes<T>(W, true) <= kSmemMax;
  const size_t smem = smem_bytes<T>(W, q_in_smem);
  cudaError_t e = cudaFuncSetAttribute(schur_small_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  schur_small_kernel<T><<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      a, t, q, lk, its, W, max_iter, (int)q_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_schur_small_f32(const float* a, float* t, float* q, float* lk, int* its, int nb,
                          int W, int max_iter, void* stream) {
  return launch<float>(a, t, q, lk, its, nb, W, max_iter, stream);
}

int nd4js_schur_small_f64(const double* a, double* t, double* q, double* lk, int* its,
                          int nb, int W, int max_iter, void* stream) {
  return launch<double>(a, t, q, lk, its, nb, W, max_iter, stream);
}

}  // extern "C"

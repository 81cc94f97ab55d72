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
// update, because Mosaic cannot index lanes: O(W²) work a step. Here the
// block has two groups of warps, each W threads rounded up to whole warps
// (ops/schur_small.py::plan), and a step is two phases between block
// barriers:
//   * T's group, thread j for column j and row j of T: in the first phase
//     thread j applies the step's reflector to column j of T's three rows,
//     in the second to row j of T's three columns. Every thread rebuilds
//     the reflector itself from three values that the threads owning those
//     rows wrote to a small double-buffered array.
//   * Q's group, thread r for row r of Q: in the first phase, row r ← row·H
//     (and the same for each 2×2 rotation), skipping a transform whose
//     columns lie outside the row's nonzero span (exact: zeros stay zero).
//     Q is thus off T's threads.
// A round's control is one pass: thread j sums column j's squares (a warp
// shuffle tree, then one value a warp for ‖T‖_F), tests subdiagonal j, and
// a ballot a warp gives every thread the window [lo, hi). T and Q have an
// odd leading dimension, so a warp reading one column (32 rows) hits 32
// banks.
//
// Bound on the H100: neither bytes nor operations but the latency of the
// step chain: each chase step is a few W flops behind two barriers, and the
// steps of a matrix are sequential. The bound reported beside the kernel
// counts, over the plain version's trajectory on the same input, only the
// entries each step must update: ~10 flops for each of the (W − k + 1)
// columns of T's three rows, the (k + 4) rows of its three columns and the
// nonzero rows of Q's three columns.
//
// Memory: T lives in shared memory; Q too when both fit a
// block's 227 KB (W = 128 in float32), otherwise Q is updated in place in
// the output in global memory (float64 at W = 128), where it stays in L2.
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kMaxW = 128;
constexpr int kMaxWarps = kMaxW / 32;  // of each group

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

// (x0, x1, x2) ← (I − τ·v·vᵀ)·(x0, x1, x2) for v = (1, v1, v2)
template <typename T>
__device__ __forceinline__ void reflect3(T* x0, T* x1, T* x2, T v1, T v2, T tau) {
  const T a = *x0, b = *x1, c = *x2;
  const T w = tau * (a + v1 * b + v2 * c);
  *x0 = a - w;
  *x1 = b - v1 * w;
  *x2 = c - v2 * w;
}

// (x0, x1) ← (cs·x0 + sn·x1, −sn·x0 + cs·x1)
template <typename T>
__device__ __forceinline__ void rotate2(T* x0, T* x1, T cs, T sn) {
  const T a = *x0, b = *x1;
  *x0 = cs * a + sn * b;
  *x1 = -sn * a + cs * b;
}

template <typename T>
__global__ void __launch_bounds__(2 * kMaxW)
schur_small_kernel(const T* __restrict__ a, T* __restrict__ t_out, T* __restrict__ q_out,
                   T* __restrict__ lk_out, int* __restrict__ it_out, int W, int max_iter,
                   int ld, int nwarps, int q_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* t = reinterpret_cast<T*>(smem_raw);
  T* q = q_in_smem ? t + (size_t)W * ld : q_out + (size_t)blockIdx.x * W * W;
  const int ldq = q_in_smem ? ld : W;
  T* lk = (q_in_smem ? q : t) + (size_t)W * ld;   // W: 0/1 per subdiagonal position
  T* red = lk + W;                   // a partial ‖T‖_F² per T warp
  T* pbuf = red + kMaxWarps;         // 2 × 3: the next bulge column, by parity
  int* ballot = reinterpret_cast<int*>(pbuf + 8);    // a live mask per T warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool isq = warp >= nwarps;   // the Q group
  const int j = isq ? tid - 32 * nwarps : tid;
  const bool jt = !isq && j < W;     // thread j of T: column j, row j
  const bool jq = isq && j < W;      // thread j of Q: row j
  const size_t off = (size_t)blockIdx.x * W * W;
  for (int r = warp; r < W; r += 2 * nwarps)
    for (int c = lane; c < W; c += 32) {
      t[r * ld + c] = a[off + r * W + c];
      q[r * ldq + c] = r == c ? T(1) : T(0);
    }
  for (int i = tid; i < W; i += blockDim.x) lk[i] = T(0);
  __syncthreads();

  const T eps = eps_of<T>();
  // Q's row j ← row·G for each transform G of T's columns k.., skipping one
  // outside the row's nonzero span [cmin, cmax]
  int cmin = j, cmax = j;
  T* qr = q + (size_t)j * ldq;
  auto q_update = [&](int k, int width, T c0, T c1, T c2) {
    if (!jq || k > cmax || k + width - 1 < cmin) return;
    if (width == 3)
      reflect3(qr + k, qr + k + 1, qr + k + 2, c0, c1, c2);
    else
      rotate2(qr + k, qr + k + 1, c0, c1);
    cmin = k < cmin ? k : cmin;
    cmax = k + width - 1 > cmax ? k + width - 1 : cmax;
  };
  // T ← Gᵀ·T·G and Q ← Q·G, G = [[cs, −sn], [sn, cs]] at (k, k+1): T's rows
  // and Q, a barrier, T's columns, a barrier. With `zero`, T[k+1, k] is set
  // to 0 instead (a standardised 2×2 block).
  auto rotate = [&](int k, T cs, T sn, bool zero) {
    if (jt) rotate2(&t[k * ld + j], &t[(k + 1) * ld + j], cs, sn);
    q_update(k, 2, cs, sn, T(0));
    __syncthreads();
    if (jt) {
      rotate2(&t[j * ld + k], &t[j * ld + k + 1], cs, sn);
      if (zero && j == k + 1) t[j * ld + k] = T(0);
    }
    __syncthreads();
  };
  int it = 0, stuck = 0, hi_prev = -1;
  while (hi_prev != 0 && it < max_iter) {
    // ---- one pass: ‖T‖_F² by columns, and subdiagonal j
    T ss = T(0);
    if (jt)
      for (int r = 0; r < W; ++r) {
        const T x = t[r * ld + j];
        ss += x * x;
      }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (!isq && lane == 0) red[warp] = ss;
    const bool js = jt && j < W - 1;
    T sub = T(0), d0 = T(0), d1 = T(0);
    if (js) {
      sub = t[(j + 1) * ld + j];
      d0 = t[j * ld + j];
      d1 = t[(j + 1) * ld + j + 1];
    }
    __syncthreads();
    T total = T(0);
    for (int w = 0; w < nwarps; ++w) total += red[w];
    const T floor = eps * sqrt(total);
    bool live = false;
    if (js) {
      const T thr = T(16) * eps * (fabs(d0) + fabs(d1));
      const bool me = lk[j] > T(0.5);
      const bool nbr = (j > 0 && lk[j - 1] > T(0.5)) || lk[j + 1] > T(0.5);
      if (fabs(sub) <= (thr > floor ? thr : floor) || (nbr && !me)) {
        t[(j + 1) * ld + j] = T(0);
        sub = T(0);
      }
      live = !me && sub != T(0);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (!isq && lane == 0) ballot[warp] = (int)mask;
    __syncthreads();
    // ---- the window: hi − 2 the last live subdiagonal, lo − 1 the last dead
    // one below it
    int hi = 0, lo = 0;
    for (int w = nwarps - 1; w >= 0; --w) {
      const unsigned m = (unsigned)ballot[w];
      if (m) {
        hi = 32 * w + 31 - __clz(m) + 2;
        break;
      }
    }
    for (int w = (hi - 2) >> 5; hi > 0 && w >= 0; --w) {
      const int top = hi - 2 - 32 * w;   // bits 0..top−1 lie below hi − 2
      const unsigned below = top >= 32 ? 0xffffffffu : ((1u << top) - 1u);
      const unsigned dead = ~(unsigned)ballot[w] & below;
      if (dead) {
        lo = 32 * w + 31 - __clz(dead) + 1;
        break;
      }
    }
    const bool size2 = hi - lo == 2;
    if (hi > 0 && size2) {
      const T aa = t[lo * ld + lo], bb = t[lo * ld + lo + 1];
      const T cc = t[(lo + 1) * ld + lo], dd = t[(lo + 1) * ld + lo + 1];
      const T disc = (aa - dd) * (aa - dd) + T(4) * bb * cc;
      // every thread has read the block before the rotation rewrites it
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
        rotate(lo, cs, sn, true);
      } else if (tid == 0) {
        lk[lo] = T(1);   // read after the next round's first barrier
      }
    } else if (hi > 0) {
      const int m = hi - 2;
      const T h_mm = t[m * ld + m], h_nn = t[(hi - 1) * ld + hi - 1];
      const T h_mn = t[m * ld + hi - 1], h_nm = t[(hi - 1) * ld + m];
      T tr = h_mm + h_nn;
      T det = h_mm * h_nn - h_mn * h_nm;
      if (stuck % 10 == 9) {   // exceptional shift (dlahqr)
        const T s_mag = fabs(h_nm) + (m >= 1 ? fabs(t[m * ld + m - 1]) : T(0));
        const T lam = h_nn + T(0.75) * s_mag;
        tr = T(2) * lam;
        det = lam * lam;
      }
      const T h00 = t[lo * ld + lo], h01 = t[lo * ld + lo + 1];
      const T h10 = t[(lo + 1) * ld + lo], h11 = t[(lo + 1) * ld + lo + 1];
      const T h21 = t[(lo + 2) * ld + lo + 1];
      T p0 = h00 * h00 + h01 * h10 - tr * h00 + det;
      T p1 = h10 * (h00 + h11 - tr);
      T p2 = h10 * h21;
      __syncthreads();   // every thread has read the seed before the rows move
      for (int k = lo; k < hi - 2; ++k) {
        const House3<T> h = house3(p0, p1, p2);
        if (h.tau != T(0)) {
          if (jt)
            reflect3(&t[k * ld + j], &t[(k + 1) * ld + j], &t[(k + 2) * ld + j], h.v1, h.v2,
                     h.tau);
          q_update(k, 3, h.v1, h.v2, h.tau);
        }
        __syncthreads();
        T* nxt = pbuf + 3 * ((k - lo) & 1);
        if (jt) {
          T* row = t + j * ld + k;
          if (h.tau != T(0)) reflect3(row, row + 1, row + 2, h.v1, h.v2, h.tau);
          // the next bulge column T[k+1..k+3, k], from the rows' owners
          if (j >= k + 1 && j <= k + 3) nxt[j - k - 1] = row[0];
        }
        __syncthreads();
        p0 = nxt[0];
        p1 = nxt[1];
        p2 = (k + 3 < hi) ? nxt[2] : T(0);
      }
      T cs, sn;
      rot2(p0, p1, &cs, &sn);
      rotate(hi - 2, cs, sn, false);
    }
    if (hi > 0) stuck = size2 ? 0 : stuck + 1;
    if (hi != hi_prev) stuck = 0;
    hi_prev = hi;
    ++it;
  }
  if (tid == 0) it_out[blockIdx.x] = it;
  __syncthreads();
  for (int r = warp; r < W; r += 2 * nwarps)
    for (int c = lane; c < W; c += 32) {
      t_out[off + r * W + c] = t[r * ld + c];
      if (q_in_smem) q_out[off + r * W + c] = q[r * ld + c];
    }
  for (int i = tid; i < W; i += blockDim.x) lk_out[(size_t)blockIdx.x * W + i] = lk[i];
}

// Shared memory of a launch: T and, when q_in_smem, Q (W rows of ld each),
// the locks, the reductions' scratch, the next bulge column and the
// ballots.
size_t smem_need(int W, int ld, int q_in_smem, size_t elem) {
  return elem * ((size_t)W * ld * (q_in_smem ? 2 : 1) + W + kMaxWarps + 8) +
         sizeof(int) * kMaxWarps;
}

template <typename T>
int launch(const T* a, T* t, T* q, T* lk, int* its, int nb, int W, int max_iter, int ld,
           int nwarps, int q_in_smem, size_t smem, void* stream) {
  if (W < 1 || W > kMaxW || ld < W || (ld & 1) == 0 || 32 * nwarps < W ||
      nwarps > kMaxWarps || smem < smem_need(W, ld, q_in_smem, sizeof(T)) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(schur_small_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  schur_small_kernel<T><<<nb, 64 * nwarps, smem, (cudaStream_t)stream>>>(
      a, t, q, lk, its, W, max_iter, ld, nwarps, q_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_schur_small_f32(const float* a, float* t, float* q, float* lk, int* its, int nb,
                          int W, int max_iter, int ld, int nwarps, int q_in_smem,
                          size_t smem, void* stream) {
  return launch<float>(a, t, q, lk, its, nb, W, max_iter, ld, nwarps, q_in_smem, smem,
                       stream);
}

int nd4js_schur_small_f64(const double* a, double* t, double* q, double* lk, int* its,
                          int nb, int W, int max_iter, int ld, int nwarps, int q_in_smem,
                          size_t smem, void* stream) {
  return launch<double>(a, t, q, lk, its, nb, W, max_iter, ld, nwarps, q_in_smem, smem,
                        stream);
}

// Blocks of one launch that an SM holds at once (0 if none), from the
// kernel's registers and `smem` bytes of shared memory.
int nd4js_schur_small_blocks_per_sm(int f64, int nwarps, size_t smem) {
  int blocks = 0;
  cudaError_t e;
  if (f64) {
    e = cudaFuncSetAttribute(schur_small_kernel<double>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, schur_small_kernel<double>,
                                                        64 * nwarps, smem);
  } else {
    e = cudaFuncSetAttribute(schur_small_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, schur_small_kernel<float>,
                                                        64 * nwarps, smem);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // extern "C"

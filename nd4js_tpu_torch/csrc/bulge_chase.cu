// bulge_chase_steps: SL position steps of a train of NB Francis double-shift
// bulges through one (W, W) diagonal block B, accumulating the similarity:
// returns V_acc (W, W) with B' = V_accᵀ·B·V_acc and the bulges' carries P'.
//
// Replaces the TPU kernel nd4js_tpu/ops/bulge_chase.py::bulge_chase_steps
// (_make_kernel). Same arithmetic (bulge_chase.py:92-150): at step t bulge i
// sits at absolute position k = k0 + t − 3i, block row kb = t + 3(NB−1) − 3i,
// and acts while lo ≤ k ≤ hi − 2; with `seed`, a bulge entering at k = lo
// takes its carry from the first column of (B − s₁)(B − s₂)·e₁ at kb; at
// k = hi − 2 its third component is dropped; its 3-element reflector (v0 = 1,
// la/schur.py _house3) is applied from both sides of B and from the right of
// V_acc; its carry becomes B[kb+1..kb+3, kb] (the third 0 when k + 3 ≥ hi).
//
// Design. The TPU kernel holds B transposed and builds the NB reflectors as
// an (NB, W) masked scatter applied by six dot_generals a step, because
// Mosaic cannot index lanes: O(NB·W²) work a step. Here the NB reflectors of
// a step have disjoint 3-row supports, so they commute, and a step is two
// phases of O(NB·W): all row updates, then all column updates. The block has
// three groups of warps (ops/bulge_chase.py::plan sizes them):
//   * reflector warps, lane i for bulge i: after the row phase, lane i applies
//     its column update to rows kb+1..kb+3 itself, so it holds the next
//     carry, and builds the next step's reflector while the update warps do
//     the other rows. It logs (v1, v2, τ) of every step in shared memory.
//   * update warps: thread (g, c) applies the row update of the active
//     bulges g, g + G, … to column c, and their column update to row c.
//     The reflector and update warps (the step chain) meet at two named
//     barriers a step (bar.sync 1), not __syncthreads().
//   * accumulator warps, one thread a row of V_acc: row ← row·H for each
//     logged reflector in step order. They wait only for a step's reflectors
//     (a counter in shared memory), never for the chain's barriers, and skip
//     a reflector whose three columns lie outside the row's nonzero span
//     (exact: such a row holds zeros there, which stay zero).
// B and V_acc have an odd leading dimension, so a warp reading one column
// (32 rows) hits 32 banks.
//
// Bound on the H100: the step chain's latency and shared-memory bandwidth
// (each step moves 6·NB·W values of B). The bound reported beside the kernel
// counts what each of the SL·NB reflector steps must update, ~10 flops for
// each nonzero column of B's three rows (W − kb + 1 for a Hessenberg block
// with its bulges), each nonzero row of B's three columns (kb + 4) and each
// nonzero row of V_acc's three columns, against 2·W² values moved (B in,
// V_acc out).
//
// Memory: B and the log in shared memory; V_acc beside them when all fit a
// block's 227 KB (W = 128 in float32), otherwise V_acc is updated in place
// in the output in global memory (float64 at W = 128), where it stays in L2.
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kMaxThreads = 768;     // 24 warps: ops/bulge_chase.py::MAX_WARPS
constexpr int kChainBarrier = 1;     // named barrier of the step chain
constexpr int kChunk = 4;            // items an update thread loads at once

template <typename T>
struct House3 {
  T v1, v2, tau;
};

// a logged reflector, read with one vector load
template <typename T>
struct alignas(4 * sizeof(T)) Refl {
  T v1, v2, tau, pad;
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

// (x0, x1, x2) ← (I − τ·v·vᵀ)·(x0, x1, x2) for v = (1, v1, v2)
template <typename T>
__device__ __forceinline__ void reflect3(T& x0, T& x1, T& x2, T v1, T v2, T tau) {
  const T w = tau * (x0 + v1 * x1 + v2 * x2);
  x0 -= w;
  x1 -= v1 * w;
  x2 -= v2 * w;
}

__device__ __forceinline__ void chain_sync(int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(kChainBarrier), "r"(nthreads) : "memory");
}

// floor(a / 3) for any sign of a
__device__ __forceinline__ int floordiv3(int a) { return a >= 0 ? a / 3 : -((2 - a) / 3); }

struct Slide {
  int W, NB, SL, k0, lo, hi, seed, OFF;
  // the bulges active at step t: [first, last], empty when first > last
  __device__ __forceinline__ int first(int t) const {
    const int f = k0 + t - (hi - 2);
    return f > 0 ? -floordiv3(-f) : 0;   // ceil(f / 3), at least 0
  }
  __device__ __forceinline__ int last(int t) const {
    const int l = floordiv3(k0 + t - lo);
    return l < NB - 1 ? l : NB - 1;
  }
};

// Row (rows = true) or column phase of the update warps on the bulges
// [a, z]: thread (g, c) takes bulges a + g, a + g + G, …; the column phase
// leaves rows kb+1..kb+3 of each bulge to its reflector lane.
template <typename T, bool rows>
__device__ __forceinline__ void update_phase(T* b, int ld, const Refl<T>* rl, int t, int OFF,
                                             int a, int z, int g, int G, int c) {
  for (int i0 = a + g; i0 <= z; i0 += kChunk * G) {
    T x[kChunk][3], h[kChunk][3];
    int base[kChunk];
    bool on[kChunk];
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
      const int i = i0 + m * G;
      const int kb = t + OFF - 3 * i;
      on[m] = i <= z;
      if (on[m]) {
        const Refl<T> e = rl[i];
        h[m][0] = e.v1;
        h[m][1] = e.v2;
        h[m][2] = e.tau;
        on[m] = h[m][2] != T(0) && (rows || c < kb + 1 || c > kb + 3);
      }
      base[m] = rows ? kb * ld + c : c * ld + kb;
    }
    const int step = rows ? ld : 1;
#pragma unroll
    for (int m = 0; m < kChunk; ++m)
      if (on[m]) {
#pragma unroll
        for (int j = 0; j < 3; ++j) x[m][j] = b[base[m] + j * step];
      }
#pragma unroll
    for (int m = 0; m < kChunk; ++m)
      if (on[m]) {
        reflect3(x[m][0], x[m][1], x[m][2], h[m][0], h[m][1], h[m][2]);
#pragma unroll
        for (int j = 0; j < 3; ++j) b[base[m] + j * step] = x[m][j];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bulge_chase_kernel(const T* __restrict__ b_in, const T* __restrict__ p_in,
                   const T* __restrict__ shifts, T* __restrict__ v_out,
                   T* __restrict__ p_out, Slide s, int ld, int nref, int nupd,
                   int v_in_smem) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int W = s.W, NB = s.NB, SL = s.SL, OFF = s.OFF;
  Refl<T>* rlog = reinterpret_cast<Refl<T>*>(smem_raw);   // SL × NB reflectors
  T* b = reinterpret_cast<T*>(rlog + (size_t)SL * NB);
  T* v = v_in_smem ? b + (size_t)W * ld : v_out;
  const int ldv = v_in_smem ? ld : W;
  // steps logged, counted once per reflector warp
  int& published = *reinterpret_cast<int*>(b + (size_t)W * ld * (v_in_smem ? 2 : 1));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < W; r += nwarps)
    for (int c = lane; c < W; c += 32) {
      b[r * ld + c] = b_in[r * W + c];
      v[r * ldv + c] = r == c ? T(1) : T(0);
    }
  if (tid == 0) published = 0;
  __syncthreads();

  const int nchain = 32 * (nref + nupd);
  if (warp < nref) {
    // ---- reflector warps: lane i for bulge i
    const int i = warp * 32 + lane;
    const bool mine = i < NB;
    T p0 = T(0), p1 = T(0), p2 = T(0);
    if (mine) {
      p0 = p_in[3 * i];
      p1 = p_in[3 * i + 1];
      p2 = p_in[3 * i + 2];
    }
    // the reflector of step t into the log, seeding an entering bulge
    auto build = [&](int t) {
      if (!mine) return;
      const int k = s.k0 + t - 3 * i;
      const int kb = t + OFF - 3 * i;
      const bool act = k >= s.lo && k <= s.hi - 2;
      if (s.seed && k == s.lo) {
        const T tr = shifts[2 * i], det = shifts[2 * i + 1];
        const T b00 = b[kb * ld + kb], b01 = b[kb * ld + kb + 1];
        const T b10 = b[(kb + 1) * ld + kb], b11 = b[(kb + 1) * ld + kb + 1];
        const T b21 = b[(kb + 2) * ld + kb + 1];
        p0 = b00 * b00 + b01 * b10 - tr * b00 + det;
        p1 = b10 * (b00 + b11 - tr);
        p2 = b10 * b21;
      }
      House3<T> h = house3(p0, p1, k == s.hi - 2 ? T(0) : p2);
      if (!act) h.tau = T(0);
      rlog[(size_t)t * NB + i] = Refl<T>{h.v1, h.v2, h.tau, T(0)};
    };
    auto publish = [&]() {
      __threadfence_block();
      __syncwarp();
      if (lane == 0) atomicAdd(&published, 1);
    };
    if (SL > 0) {
      build(0);
      publish();
    }
    for (int t = 0; t < SL; ++t) {
      chain_sync(nchain);   // the step's reflectors and B after step t−1
      chain_sync(nchain);   // the row phase is done
      if (mine) {
        const int k = s.k0 + t - 3 * i;
        const int kb = t + OFF - 3 * i;
        if (k >= s.lo && k <= s.hi - 2) {
          const Refl<T> e = rlog[(size_t)t * NB + i];
          const T v1 = e.v1, v2 = e.v2, tau = e.tau;
          T x[3][3];
          for (int r = 0; r < 3; ++r)
            for (int j = 0; j < 3; ++j) x[r][j] = b[(kb + 1 + r) * ld + kb + j];
          if (tau != T(0))
            for (int r = 0; r < 3; ++r) {
              reflect3(x[r][0], x[r][1], x[r][2], v1, v2, tau);
              for (int j = 0; j < 3; ++j) b[(kb + 1 + r) * ld + kb + j] = x[r][j];
            }
          p0 = x[0][0];
          p1 = x[1][0];
          p2 = k + 3 < s.hi ? x[2][0] : T(0);
        }
      }
      if (t + 1 < SL) {
        build(t + 1);
        publish();
      }
    }
    if (mine) {
      p_out[3 * i] = p0;
      p_out[3 * i + 1] = p1;
      p_out[3 * i + 2] = p2;
    }
  } else if (warp < nref + nupd) {
    // ---- update warps: thread (g, c), g < G = threads / W
    const int u = tid - 32 * nref;
    const int G = 32 * nupd / W;
    const int g = u / W, c = u % W;
    for (int t = 0; t < SL; ++t) {
      const int a = s.first(t), z = s.last(t);
      const Refl<T>* rl = rlog + (size_t)t * NB;
      chain_sync(nchain);
      if (g < G) update_phase<T, true>(b, ld, rl, t, OFF, a, z, g, G, c);
      chain_sync(nchain);
      if (g < G) update_phase<T, false>(b, ld, rl, t, OFF, a, z, g, G, c);
    }
  } else {
    // ---- accumulator warps: thread r for row r of V_acc
    const int r = tid - nchain;
    int cmin = r, cmax = r;   // the row's nonzeros lie in [cmin, cmax]
    T* vr = v + (size_t)r * ldv;
    for (int t = 0; t < SL && r < W; ++t) {
      const int need = nref * (t + 1);
      while (*(volatile int*)&published < need) __nanosleep(32);
      __threadfence_block();
      const int a = s.first(t), z = s.last(t);
      const Refl<T>* rl = rlog + (size_t)t * NB;
      for (int i = a; i <= z; ++i) {
        const Refl<T> e = rl[i];
        const int kb = t + OFF - 3 * i;
        if (e.tau == T(0) || kb > cmax || kb + 2 < cmin) continue;
        T x0 = vr[kb], x1 = vr[kb + 1], x2 = vr[kb + 2];
        reflect3(x0, x1, x2, e.v1, e.v2, e.tau);
        vr[kb] = x0;
        vr[kb + 1] = x1;
        vr[kb + 2] = x2;
        cmin = kb < cmin ? kb : cmin;
        cmax = kb + 2 > cmax ? kb + 2 : cmax;
      }
    }
  }
  __syncthreads();
  if (v_in_smem)
    for (int r = warp; r < W; r += nwarps)
      for (int c = lane; c < W; c += 32) v_out[r * W + c] = v[r * ld + c];
}

// Shared memory of a launch: the log of SL·NB reflectors (4 values each),
// B, V_acc when v_in_smem (W rows of ld each), and the log's counter.
size_t smem_need(int W, int NB, int SL, int ld, int v_in_smem, size_t elem) {
  return elem * ((size_t)W * ld * (v_in_smem ? 2 : 1) + (size_t)SL * NB * 4) + 16;
}

template <typename T>
int launch(const T* b, const T* p, const T* shifts, T* v, T* po, int W, int NB, int SL,
           int k0, int lo, int hi, int seed, int ld, int nref, int nupd, int nacc,
           int v_in_smem, size_t smem, void* stream) {
  // every active bulge's 3-row support lies inside the block; the plan's
  // groups cover the bulges, the columns and the rows
  if (W < 4 || NB < 1 || SL < 0 || SL + 3 * NB > W || ld < W || (ld & 1) == 0 ||
      32 * nref < NB || 32 * nupd < W || 32 * nacc < W ||
      32 * (nref + nupd + nacc) > kMaxThreads ||
      smem < smem_need(W, NB, SL, ld, v_in_smem, sizeof(T)) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bulge_chase_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Slide s{W, NB, SL, k0, lo, hi, seed, 3 * (NB - 1)};
  bulge_chase_kernel<T><<<1, 32 * (nref + nupd + nacc), smem, (cudaStream_t)stream>>>(
      b, p, shifts, v, po, s, ld, nref, nupd, v_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_bulge_chase_f32(const float* b, const float* p, const float* shifts, float* v,
                          float* po, int W, int NB, int SL, int k0, int lo, int hi, int seed,
                          int ld, int nref, int nupd, int nacc, int v_in_smem, size_t smem,
                          void* stream) {
  return launch<float>(b, p, shifts, v, po, W, NB, SL, k0, lo, hi, seed, ld, nref, nupd,
                       nacc, v_in_smem, smem, stream);
}

int nd4js_bulge_chase_f64(const double* b, const double* p, const double* shifts,
                          double* v, double* po, int W, int NB, int SL, int k0, int lo,
                          int hi, int seed, int ld, int nref, int nupd, int nacc,
                          int v_in_smem, size_t smem, void* stream) {
  return launch<double>(b, p, shifts, v, po, W, NB, SL, k0, lo, hi, seed, ld, nref, nupd,
                        nacc, v_in_smem, smem, stream);
}

}  // extern "C"

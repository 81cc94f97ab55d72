// The stripe-WY Householder elimination body shared by the house_stripe_t
// and qr_gesv kernels (house_stripe.cu): the port of _house_stripe_body,
// nd4js_tpu/ops/house_stripe.py:75-161, in the natural layout.
//
// A matrix (m rows, columns padded to groups of 8) is eliminated by one
// thread-block cluster of C blocks (C in 1, 2, 4, 8). Its first nhouse
// columns form stripes of 8; stripe s is group s. Group g belongs to block
// g % C while g is a stripe, and to block C - 1 after (the right-hand sides
// of a solve, or the columns of a wide panel past its reflectors). Each
// block keeps the columns it owns, column-major, in one of two places:
//
//   shared regime  its own shared memory (a slab of 8-column slots),
//   global regime  the caller's column-major scratch in global memory, when
//                  the slabs would not fit 227 KB even at C = 8; the stripe
//                  being factored is then staged in shared memory, and so
//                  is V of the last two stripes (24 values a row), or, for
//                  more rows than that leaves room for (about 2400 in
//                  float32, 1200 in float64), both are staged in the
//                  scratch too, after the matrices' columns, one stage
//                  area a block (gstage).
//
// Round s: the owner of stripe s has factored it (8 rank-1 reflector steps
// inside the stripe, one reduction each, in the warps that hold the
// stripe's rows in registers, or in a quarter of the block's warps with the
// rows in shared memory when they are too many) and built its 8x8 T by the
// telescoped Neumann series. Every block that owns later columns copies
// V_s (from the owner's slab through distributed shared memory, or from
// global memory) and T_s, and applies Q_sᵀ = I − V·Tᵀ·Vᵀ to them as
// W1 = Vᵀ·slab, W2 = Tᵀ·W1, slab −= V·W2. Look-ahead: the owner of stripe
// s + 1 first updates that stripe; then its factoring warps factor it and
// arrive at the cluster barrier while its other warps update the block's
// other columns, so the factorisation of stripe s + 1 overlaps every
// update by stripe s. One cluster barrier (arrive, then wait) a round
// publishes the next stripe; a final one keeps every block alive while a
// peer may still read its shared memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace nd4js {
namespace stripe {

namespace cg = cooperative_groups;

constexpr int kW = 8;              // stripe width
constexpr int kRows = 4;           // rows a lane loads before it stores
constexpr int kMaxThreads = 512;
constexpr int kMaxFactorWarps = kMaxThreads / 128;

// One matrix's elimination and the cluster that runs it (host and device).
struct Shape {
  int m;         // rows
  int ngroups;   // groups of 8 columns
  int nhouse;    // reflectors
  int nstripes;  // ceil(nhouse / 8)
  int ntail;     // groups after the stripes, all in block csize - 1
  int ktail;     // right-hand sides of the back substitution (0: none)
  int csize;     // cluster size
  int shared;    // 1: the shared regime, 0: the global regime
  int gstage;    // global regime only: 1 stages the stripe and V in the
                 // scratch (stage_elems a block), not in shared memory
  int rowmajor;  // shared regime only: 0, or the columns of a row-major
                 // (m, rowmajor) panel that the slabs load straight
};

__host__ __device__ inline int stripes_of(const Shape& sh, int b) {
  return sh.nstripes > b ? (sh.nstripes - 1 - b) / sh.csize + 1 : 0;
}

__host__ __device__ inline int slots_of(const Shape& sh, int b) {
  return stripes_of(sh, b) + (b == sh.csize - 1 ? sh.ntail : 0);
}

__host__ __device__ inline int max_slots(const Shape& sh) {
  int best = 0;
  for (int b = 0; b < sh.csize; ++b) {
    const int s = slots_of(sh, b);
    best = s > best ? s : best;
  }
  return best;
}

// leading dimension of a column in shared memory: odd, so that a warp that
// reads 8 columns of 4 rows spreads over the banks
__host__ __device__ inline int odd_ld(int m) { return m | 1; }

// Elements of one block's stage area in the scratch (gstage): the stripe
// being factored, then V of the last two stripes.
// nd4js_tpu_torch/ops/house_stripe.py::_stage_elems mirrors this.
__host__ __device__ inline size_t stage_elems(int m) {
  return (size_t)kW * odd_ld(m) + (size_t)2 * kW * m;
}

__host__ __device__ inline int block_threads(int m) {
  return m <= 128 ? 128 : (m <= 256 ? 256 : kMaxThreads);
}

// Offsets, in elements, of the shared-memory regions of one block.
// nd4js_tpu_torch/ops/house_stripe.py::smem_bytes mirrors this.
struct Smem {
  size_t store, sbuf, vbuf, tl, taur, gs, taus, red, prow, tw, own, dg, xq, total;
};

__host__ __device__ inline Smem smem_plan(const Shape& sh) {
  Smem p;
  size_t o = 0;
  const size_t ld = (size_t)odd_ld(sh.m);
  const size_t slots = (size_t)max_slots(sh);
  p.store = o;
  o += sh.shared ? slots * kW * ld : 0;
  p.sbuf = o;
  o += (sh.shared || sh.gstage) ? 0 : kW * ld;
  p.vbuf = o;
  o += sh.gstage ? 0 : (size_t)2 * kW * sh.m;
  p.tl = o;    // T of the last two stripes, [2][8][8]
  o += 2 * kW * kW;
  p.taur = o;  // their taus, [2][8]
  o += 2 * kW;
  p.gs = o;    // strictly upper Vᵀ·V of the stripe being factored
  o += kW * kW;
  p.taus = o;  // its taus
  o += kW;
  p.red = o;   // the factor's reduction across its warps, two buffers
  o += 2 * kMaxFactorWarps * kW;
  p.prow = o;  // the pivot row of a reflector step, two buffers
  o += 2 * kW;
  p.tw = o;    // the series for T
  o += 3 * kW * kW;
  p.own = o;   // taus of this block's stripes, by slot
  o += slots * kW;
  p.dg = o;    // back substitution: the diagonal blocks of R (shared
               // regime), or one at a time (global regime)
  o += sh.ktail > 0 ? (size_t)kW * kW * (sh.shared ? sh.nstripes : 1) : 0;
  p.xq = o;    // ... and the 8 solved rows of x
  o += (size_t)kW * sh.ktail;
  p.total = o;
  return p;
}

// The warp's index, broadcast from lane 0: the compiler then knows it is the
// same in every lane, and compiles the shuffles of warp-specialised code as
// plain shuffles, not as the loop that a possibly divergent warp needs.
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum a[0..7] over the warp with 9 shuffles (each step hands half of the
// values to the partner lane). Returns, in every lane, the warp's total of
// value (lane >> 2) & 7.
template <typename T>
__device__ T warp_sum8_spread(T (&a)[kW]) {
  const int lane = threadIdx.x & 31;
  bool hi = lane & 16;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T send = hi ? a[k] : a[k + 4];
    const T keep = hi ? a[k + 4] : a[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  hi = lane & 8;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T send = hi ? a[k] : a[k + 2];
    const T keep = hi ? a[k + 2] : a[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  hi = lane & 4;
  {
    const T send = hi ? a[0] : a[1];
    const T keep = hi ? a[1] : a[0];
    a[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 2);
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
  return a[0];
}

// a[0..7] summed over the warp, in every lane.
template <typename T>
__device__ void warp_allsum8(T (&a)[kW]) {
  const T t = warp_sum8_spread(a);
#pragma unroll
  for (int k = 0; k < kW; ++k) a[k] = __shfl_sync(0xffffffffu, t, 4 * k);
}

// Where a block finds its columns, its peers' columns and its work arrays.
template <typename T, bool kShared>
struct Ctx {
  Shape sh;
  int rank, nstr, nslots, nstr_last;
  int ld;     // leading dimension of the column storage
  T* store;   // shared: this block's slab; global: this matrix's columns
  T *sbuf, *vbuf, *tl, *taur, *gs, *taus, *red, *prow, *tw, *own, *dg, *xq;

  __device__ void init(const Shape& s, unsigned char* smem, T* work, int mat) {
    sh = s;
    rank = (int)cg::this_cluster().block_rank();
    nstr = stripes_of(sh, rank);
    nslots = slots_of(sh, rank);
    nstr_last = stripes_of(sh, sh.csize - 1);
    const Smem p = smem_plan(sh);
    T* base = reinterpret_cast<T*>(smem);
    if constexpr (kShared) {
      ld = odd_ld(sh.m);
      store = base + p.store;
    } else {
      ld = sh.m;
      store = work + (size_t)mat * sh.ngroups * kW * sh.m;
    }
    sbuf = base + p.sbuf;
    vbuf = base + p.vbuf;
    if (!kShared && sh.gstage) {
      // after every matrix's columns, one stage area a block
      sbuf = work + (size_t)(gridDim.x / sh.csize) * sh.ngroups * kW * sh.m +
             (size_t)blockIdx.x * stage_elems(sh.m);
      vbuf = sbuf + (size_t)kW * odd_ld(sh.m);
    }
    tl = base + p.tl;
    taur = base + p.taur;
    gs = base + p.gs;
    taus = base + p.taus;
    red = base + p.red;
    prow = base + p.prow;
    tw = base + p.tw;
    own = base + p.own;
    dg = base + p.dg;
    xq = base + p.xq;
  }
  __device__ int owner(int g) const {
    return g < sh.nstripes ? g % sh.csize : sh.csize - 1;
  }
  __device__ int slot(int g) const {
    return g < sh.nstripes ? g / sh.csize : nstr_last + (g - sh.nstripes);
  }
  __device__ int group_of_slot(int q) const {
    return q < nstr ? rank + sh.csize * q : sh.nstripes + (q - nstr);
  }
  // `p` in this block's shared memory, as seen in block `o`'s
  template <typename U>
  __device__ U* peer(U* p, int o) const {
    return o == rank ? p : cg::this_cluster().map_shared_rank(p, o);
  }
  // the first column of group g, wherever it lives
  __device__ T* group_ptr(int g) const {
    if constexpr (kShared) {
      return peer(store + (size_t)slot(g) * kW * ld, owner(g));
    } else {
      return store + (size_t)g * kW * ld;
    }
  }
  // column lc of this block's slots (slot lc / 8, column lc % 8 of it)
  __device__ T* local_col(int lc) const {
    if constexpr (kShared) {
      return store + (size_t)lc * ld;
    } else {
      return store + ((size_t)group_of_slot(lc / kW) * kW + lc % kW) * ld;
    }
  }
};

// V of a factored stripe (columns of S, leading dimension ld) into vb
// (column-major, leading dimension m, rows s0..m-1): unit diagonal, the
// stored tail below, zero above; a column with tau = 0, or past w, is zero
// (house_stripe.py:134-139). Threads tid, tid + nt, ... share the rows,
// two at a time. Everything a pass reads is loaded before it stores
// anything (the compiler cannot prove that the stores miss the next loads),
// so that the loads, from a peer's shared memory too, are in flight
// together.
template <typename T>
__device__ void build_vbuf(const T* S, int ld, const T* tau, int s0, int w, int m, T* vb,
                           int tid, int nt) {
  T t[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) t[k] = k < w ? tau[k] : T(0);
  for (int i0 = s0 + tid; i0 < m; i0 += 2 * nt) {
    const int i1 = i0 + nt;
    const bool two = i1 < m;
    T r0[kW], r1[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      r0[k] = k < w ? S[(size_t)k * ld + i0] : T(0);
      r1[k] = (two && k < w) ? S[(size_t)k * ld + i1] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int d = s0 + k;
      vb[(size_t)k * m + i0] = t[k] == T(0) ? T(0) : (i0 > d ? r0[k] : (i0 == d ? T(1) : T(0)));
      if (two)
        vb[(size_t)k * m + i1] = t[k] == T(0) ? T(0) : (i1 > d ? r1[k] : (i1 == d ? T(1) : T(0)));
    }
  }
}

// T = (I + diag(τ)·striu(VᵀV))⁻¹·diag(τ) by the series of
// house_stripe.py:140-157, in one warp: X = I − N, S = N, then
// S ← S·S, X ← X + X·S while the span is below w.
template <typename T>
__device__ void build_t(const T* gs, const T* taus, int w, T* tw, T* tdst) {
  const int lane = threadIdx.x & 31;
  T* ns = tw;
  T* xs = tw + kW * kW;
  T* tmp = tw + 2 * kW * kW;
  for (int e = lane; e < kW * kW; e += 32) {
    const int a = e >> 3, b = e & 7;
    const T ta = a < w ? taus[a] : T(0);
    const T tb = b < w ? taus[b] : T(0);
    const T n = (b > a && ta != T(0) && tb != T(0)) ? ta * gs[a * kW + b] : T(0);
    ns[e] = n;
    xs[e] = (a == b ? T(1) : T(0)) - n;
  }
  __syncwarp();
  for (int span = 2; span < w; span *= 2) {
    for (int e = lane; e < kW * kW; e += 32) {
      const int a = e >> 3, b = e & 7;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kW; ++k) acc += ns[a * kW + k] * ns[k * kW + b];
      tmp[e] = acc;
    }
    __syncwarp();
    for (int e = lane; e < kW * kW; e += 32) ns[e] = tmp[e];
    __syncwarp();
    for (int e = lane; e < kW * kW; e += 32) {
      const int a = e >> 3, b = e & 7;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kW; ++k) acc += xs[a * kW + k] * ns[k * kW + b];
      tmp[e] = xs[e] + acc;
    }
    __syncwarp();
    for (int e = lane; e < kW * kW; e += 32) xs[e] = tmp[e];
    __syncwarp();
  }
  for (int e = lane; e < kW * kW; e += 32) {
    const int b = e & 7;
    tdst[e] = xs[e] * (b < w ? taus[b] : T(0));
  }
  __syncwarp();
}

// Rows of a stripe one lane keeps in registers (8 in float32, 4 in
// float64: 64 registers either way).
template <typename T>
struct RegRows {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};

// The most warps that factor a stripe: a quarter of the block (at least one).
__device__ __forceinline__ int max_factor_warps() { return max(1, (int)(blockDim.x >> 7)); }

// Warps whose registers hold the rows s0..m-1 of stripe s: 1, 2, 4 or
// more (a power of two, for which steps_in_registers is compiled).
template <typename T>
__device__ __forceinline__ int register_warps(int m, int s) {
  constexpr int rows = 32 * RegRows<T>::value;
  const int need = (m - s * kW + rows - 1) / rows;
  return need <= 1 ? 1 : (need <= 2 ? 2 : (need <= 4 ? 4 : need));
}

// Warps that factor stripe s: those that hold its rows in registers, or,
// when more would be needed, max_factor_warps() with the rows in shared
// memory (about 4 a thread at 256 or 512 rows).
template <typename T>
__device__ __forceinline__ int factor_warps(int m, int s) {
  return min(register_warps<T>(m, s), max_factor_warps());
}

// Barrier of the factoring warps alone (named barrier 1), so that the
// block's other warps go on with their updates meanwhile.
__device__ __forceinline__ void factor_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// The reflector steps of a stripe S (leading dimension ld, rows s0..m-1) in
// F warps, the rows in registers: lane l of warp f keeps rows
// s0 + l + 32·(r·F + f), so that row j of step jl is lane jl's first row
// in warp 0. One reduction a step,
//   p[c] = Σ_{i>j} x_i·S[c][i]  (c < w; p[jl] = σ),
// gives the step's column of VᵀV (the columns left of jl are V already)
// and w_c = τ·(a_jc + p[c]/den) right of it (house_stripe.py:92-127): by
// shuffles in one warp; across F > 1 warps through `red` and `prow` (the
// pivot row, double-buffered as `red` is) and one named barrier.
template <int F, typename T, bool kShared>
__device__ void steps_in_registers(Ctx<T, kShared>& cx, T* S, int ld, int s0, int w) {
  constexpr int R = RegRows<T>::value;
  const int lane = threadIdx.x & 31, f = warp_id(), m = cx.sh.m;
  T a[R][kW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = s0 + lane + 32 * (r * F + f);
#pragma unroll
    for (int c = 0; c < kW; ++c) a[r][c] = (i < m && c < w) ? S[(size_t)c * ld + i] : T(0);
  }
#pragma unroll
  for (int jl = 0; jl < kW; ++jl) {
    if (jl >= w) break;
    const int par = jl & 1;
    const bool pivot = f == 0 && lane == jl;
    T p[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) p[c] = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T x = (r > 0 || f > 0 || lane > jl) ? a[r][jl] : T(0);
#pragma unroll
      for (int c = 0; c < kW; ++c) p[c] += x * a[r][c];
    }
    T pr[kW];
    if constexpr (F == 1) {
      warp_allsum8(p);
#pragma unroll
      for (int c = 0; c < kW; ++c) pr[c] = __shfl_sync(0xffffffffu, a[0][c], jl);
    } else {
      T* red = cx.red + par * kMaxFactorWarps * kW;
      T* prow = cx.prow + par * kW;
      if (pivot) {
#pragma unroll
        for (int c = 0; c < kW; ++c) prow[c] = a[0][c];
      }
      const T part = warp_sum8_spread(p);
      if ((lane & 3) == 0) red[f * kW + (lane >> 2)] = part;
      factor_sync(32 * F);
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        p[c] = T(0);
        pr[c] = prow[c];
      }
      for (int q = 0; q < F; ++q) {
#pragma unroll
        for (int c = 0; c < kW; ++c) p[c] += red[q * kW + c];
      }
    }
    const Reflector<T> h = make_reflector(pr[jl], p[jl]);
    const T rden = T(1) / h.den;
    T wc[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const T g = pr[c] + p[c] * rden;
      wc[c] = (c > jl && c < w) ? h.tau * g : T(0);
      if (threadIdx.x == 0 && c < jl) cx.gs[c * kW + jl] = g;
    }
    if (threadIdx.x == 0) cx.taus[jl] = h.tau;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r > 0 || f > 0 || lane > jl) {
        const T v = a[r][jl] * rden;
        a[r][jl] = v;
#pragma unroll
        for (int c = jl + 1; c < kW; ++c) a[r][c] -= v * wc[c];
      }
    }
    if (pivot) {
      a[0][jl] = h.beta;
#pragma unroll
      for (int c = jl + 1; c < kW; ++c) a[0][c] = pr[c] - wc[c];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = s0 + lane + 32 * (r * F + f);
#pragma unroll
    for (int c = 0; c < kW; ++c)
      if (i < m && c < w) S[(size_t)c * ld + i] = a[r][c];
  }
}

// The reflector steps of a stripe S in nf threads (a multiple of 32), the
// rows in shared memory: thread t keeps rows t, t + nf, ... One reduction a
// step as in steps_in_registers, over the warps and then across them
// through `red` (one named barrier). The pivot row j reaches every thread
// through `prow`, written by the thread that updated it the step before
// (double-buffered, as `red` is).
template <typename T, bool kShared>
__device__ void steps_in_shared(Ctx<T, kShared>& cx, T* S, int ld, int s0, int w, int nf) {
  const int t = threadIdx.x, lane = t & 31, warp = warp_id();
  const int m = cx.sh.m;
  if (t == s0 % nf) {
#pragma unroll
    for (int c = 0; c < kW; ++c) cx.prow[c] = c < w ? S[(size_t)c * ld + s0] : T(0);
  }
  for (int jl = 0; jl < w; ++jl) {
    const int j = s0 + jl, par = jl & 1;
    // this thread's first row below j
    const int first = t > j ? t : t + ((j - t) / nf + 1) * nf;
    T p[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) p[c] = T(0);
    for (int i = first; i < m; i += nf) {
      T row[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) row[c] = c < w ? S[(size_t)c * ld + i] : T(0);
      T x = T(0);
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c == jl) x = row[c];
#pragma unroll
      for (int c = 0; c < kW; ++c) p[c] += x * row[c];
    }
    T* red = cx.red + par * kMaxFactorWarps * kW;
    const T part = warp_sum8_spread(p);
    if ((lane & 3) == 0) red[warp * kW + (lane >> 2)] = part;
    factor_sync(nf);
#pragma unroll
    for (int c = 0; c < kW; ++c) p[c] = T(0);
    for (int q = 0; q < nf / 32; ++q) {
#pragma unroll
      for (int c = 0; c < kW; ++c) p[c] += red[q * kW + c];
    }
    const T* pr = cx.prow + par * kW;
    T sigma = T(0), x0 = T(0);
#pragma unroll
    for (int c = 0; c < kW; ++c)
      if (c == jl) {
        sigma = p[c];
        x0 = pr[c];
      }
    const Reflector<T> h = make_reflector(x0, sigma);
    const T rden = T(1) / h.den;
    T wc[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const T g = pr[c] + p[c] * rden;
      wc[c] = (c > jl && c < w) ? h.tau * g : T(0);
      if (t == 0 && c < jl) cx.gs[c * kW + jl] = g;
    }
    if (t == 0) cx.taus[jl] = h.tau;
    if (t == j % nf) {
      S[(size_t)jl * ld + j] = h.beta;
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c > jl && c < w) S[(size_t)c * ld + j] = pr[c] - wc[c];
    }
    // this thread's rows below j, two at a time, all loads before the
    // stores (see build_vbuf)
    for (int i0 = first; i0 < m; i0 += 2 * nf) {
      const int i1 = i0 + nf;
      const bool two = i1 < m;
      T r0[kW], r1[kW];
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        r0[c] = (c >= jl && c < w) ? S[(size_t)c * ld + i0] : T(0);
        r1[c] = (two && c >= jl && c < w) ? S[(size_t)c * ld + i1] : T(0);
      }
      T v0 = T(0), v1 = T(0);
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c == jl) {
          v0 = r0[c] * rden;
          v1 = r1[c] * rden;
        }
#pragma unroll
      for (int c = 0; c < kW; ++c) {
        r0[c] = c == jl ? v0 : r0[c] - v0 * wc[c];
        r1[c] = c == jl ? v1 : r1[c] - v1 * wc[c];
      }
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c >= jl && c < w) {
          S[(size_t)c * ld + i0] = r0[c];
          if (two) S[(size_t)c * ld + i1] = r1[c];
        }
    }
    // the next pivot row, once this step has updated it
    if (jl + 1 < w && first == j + 1) {
      T* nx = cx.prow + (par ^ 1) * kW;
#pragma unroll
      for (int c = 0; c < kW; ++c) nx[c] = c < w ? S[(size_t)c * ld + j + 1] : T(0);
    }
  }
}

// Factor stripe s, owned by this block, in its first factor_warps(m, s)
// warps (the block's other warps meanwhile update its other columns): w
// rank-1 reflector steps that touch only the stripe, then T_s into
// tl[s & 1], its taus into taur[s & 1] and own[], V_s into vbuf[s & 1].
// In the global regime the stripe is staged in shared memory.
template <typename T, bool kShared>
__device__ void factor_stripe(Ctx<T, kShared>& cx, int s) {
  const int t = threadIdx.x, warp = warp_id();
  const int m = cx.sh.m, s0 = s * kW;
  const int w = min(kW, cx.sh.nhouse - s0);
  const int fw = factor_warps<T>(m, s), nf = 32 * fw;
  T* S;
  int ld;
  if constexpr (kShared) {
    S = cx.local_col(cx.slot(s) * kW);
    ld = cx.ld;
  } else {
    S = cx.sbuf;
    ld = odd_ld(m);
    const T* G = cx.group_ptr(s);
    for (int c = 0; c < w; ++c)
      for (int i = s0 + t; i < m; i += nf) S[(size_t)c * ld + i] = G[(size_t)c * cx.ld + i];
    factor_sync(nf);
  }
  if (fw != register_warps<T>(m, s))
    steps_in_shared(cx, S, ld, s0, w, nf);
  else if (fw == 1)
    steps_in_registers<1>(cx, S, ld, s0, w);
  else if (fw == 2)
    steps_in_registers<2>(cx, S, ld, s0, w);
  else
    steps_in_registers<4>(cx, S, ld, s0, w);
  factor_sync(nf);
  const int ring = s & 1;
  if (t < kW) {
    const T tau = t < w ? cx.taus[t] : T(0);
    cx.taur[ring * kW + t] = tau;
    cx.own[cx.slot(s) * kW + t] = tau;
  }
  if (warp == 0) build_t(cx.gs, cx.taus, w, cx.tw, cx.tl + ring * kW * kW);
  build_vbuf(S, ld, cx.taus, s0, w, m, cx.vbuf + (size_t)ring * kW * m, t, nf);
  if constexpr (!kShared) {
    T* G = cx.group_ptr(s);
    for (int c = 0; c < w; ++c)
      for (int i = s0 + t; i < m; i += nf) G[(size_t)c * cx.ld + i] = S[(size_t)c * ld + i];
  }
  factor_sync(nf);
}

// Apply Q_sᵀ = I − V·Tᵀ·Vᵀ (V in vb, T in tt) to this block's columns
// lc_lo..lc_hi-1, rows s0..m-1, in warps warp0..warp0 + nw - 1: a warp a
// column, lanes down the rows.
template <typename T, bool kShared>
__device__ void apply_wy(const Ctx<T, kShared>& cx, int lc_lo, int lc_hi, int s0, const T* vb,
                         const T* tt, int warp0, int nw) {
  const int lane = threadIdx.x & 31, warp = warp_id() - warp0;
  const int m = cx.sh.m;
  if (warp < 0 || warp >= nw) return;
  for (int lc = lc_lo + warp; lc < lc_hi; lc += nw) {
    T* col = cx.local_col(lc);
    T acc[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) acc[k] = T(0);
#pragma unroll 4
    for (int i = s0 + lane; i < m; i += 32) {
      const T x = col[i];
#pragma unroll
      for (int k = 0; k < kW; ++k) acc[k] += vb[(size_t)k * m + i] * x;
    }
    warp_allsum8(acc);
    T w2[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      T s = T(0);
#pragma unroll
      for (int l = 0; l < kW; ++l) s += acc[l] * tt[l * kW + k];
      w2[k] = s;
    }
    // kRows rows a pass, all loads before the stores (see build_vbuf)
    for (int i0 = s0 + lane; i0 < m; i0 += 32 * kRows) {
      T x[kRows], d[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = i0 + 32 * q;
        x[q] = i < m ? col[i] : T(0);
        d[q] = T(0);
#pragma unroll
        for (int k = 0; k < kW; ++k) d[q] += (i < m ? vb[(size_t)k * m + i] : T(0)) * w2[k];
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (i0 + 32 * q < m) col[i0 + 32 * q] = x[q] - d[q];
    }
  }
}

// The elimination: every stripe factored and applied to every later column
// (and to the rest of a last stripe narrower than 8). Ends at a cluster
// barrier after which every column is final.
template <typename T, bool kShared>
__device__ void eliminate(Ctx<T, kShared>& cx) {
  const Shape& sh = cx.sh;
  const int C = sh.csize, r = cx.rank;
  const int warp = warp_id(), nw = blockDim.x >> 5;
  if (cx.owner(0) == r && warp < factor_warps<T>(sh.m, 0)) factor_stripe(cx, 0);
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s < sh.nstripes; ++s) {
    const int p = s & 1, s0 = s * kW, o = cx.owner(s);
    const int w = min(kW, sh.nhouse - s0);
    const int done = r <= s ? (s - r) / C + 1 : 0;  // my stripes up to s
    const int lo = done * kW, hi = cx.nslots * kW;
    const bool partial = o == r && w < kW;           // the rest of group s
    const int plo = cx.slot(s) * kW + w, phi = cx.slot(s) * kW + kW;
    const bool ahead = s + 1 < sh.nstripes && cx.owner(s + 1) == r;
    T* vb = cx.vbuf + (size_t)p * kW * sh.m;
    T* tt = cx.tl + p * kW * kW;
    if (o != r && hi > lo) {
      const T* tsrc = cx.peer(cx.tl + p * kW * kW, o);
      if (threadIdx.x < kW * kW) tt[threadIdx.x] = tsrc[threadIdx.x];
      build_vbuf<T>(cx.group_ptr(s), cx.ld, cx.peer(cx.taur + p * kW, o), s0, w, sh.m, vb,
                    threadIdx.x, blockDim.x);
      __syncthreads();
    }
    if (ahead) {
      // stripe s + 1 first; then the factoring warps factor it and arrive
      // while the others update the rest
      const int nf = factor_warps<T>(sh.m, s + 1);
      apply_wy(cx, lo, lo + kW, s0, vb, tt, 0, nw);
      __syncthreads();
      if (warp < nf) {
        factor_stripe(cx, s + 1);
        cluster_arrive();
      } else {
        apply_wy(cx, lo + kW, hi, s0, vb, tt, nf, nw - nf);
        if (partial) apply_wy(cx, plo, phi, s0, vb, tt, nf, nw - nf);
        cluster_arrive();
      }
      cluster_wait();
    } else {
      apply_wy(cx, lo, hi, s0, vb, tt, 0, nw);
      if (partial) apply_wy(cx, plo, phi, s0, vb, tt, 0, nw);
      cluster_arrive();
      cluster_wait();
    }
  }
}

// Copy this block's groups into its slab (the shared regime only): from the
// caller's column-major scratch (groups of 8 columns of m rows), or, where
// sh.rowmajor = b, straight from the row-major (m, b) panel, zero columns
// past b (8 threads a row's 8 columns, so a warp reads 4 rows' 32 bytes).
template <typename T>
__device__ void load_slab(Ctx<T, true>& cx, const T* work, int mat) {
  const int m = cx.sh.m, b = cx.sh.rowmajor;
  if (b > 0) {
    const T* src = work + (size_t)mat * m * b;
    for (int q = 0; q < cx.nslots; ++q) {
      const int c0 = cx.group_of_slot(q) * kW;
      T* dst = cx.store + (size_t)q * kW * cx.ld;
      for (int idx = threadIdx.x; idx < kW * m; idx += blockDim.x) {
        const int i = idx >> 3, k = idx & 7;
        dst[(size_t)k * cx.ld + i] = c0 + k < b ? src[(size_t)i * b + c0 + k] : T(0);
      }
    }
    return;
  }
  const T* src = work + (size_t)mat * cx.sh.ngroups * kW * m;
  for (int q = 0; q < cx.nslots; ++q) {
    const T* g = src + (size_t)cx.group_of_slot(q) * kW * m;
    T* dst = cx.store + (size_t)q * kW * cx.ld;
    for (int idx = threadIdx.x; idx < kW * m; idx += blockDim.x) {
      const int k = idx / m, i = idx - k * m;
      dst[(size_t)k * cx.ld + i] = g[idx];
    }
  }
}

}  // namespace stripe
}  // namespace nd4js

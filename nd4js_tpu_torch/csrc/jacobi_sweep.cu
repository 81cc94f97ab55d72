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
// top seat 0 moves one place along a ring of n − 1 seats (top 1 … top h−1,
// bottom h−1 … bottom 0, h = n/2), so after a sweep's n − 1 rounds each
// column is back where it started.
//
// Layout: W and V come column-major, as (Nb, n, M) and (Nb, n, n) row-major
// arrays (the transposes of W and V), so a column is contiguous.
//
// Design (the ring kernel): one launch runs all the call's sweeps, each
// matrix on one thread-block cluster of 1-16 blocks (the wrapper's plan).
// Block b owns a contiguous range of pairs, top and bottom seats lo..hi−1,
// so a pair is always local. Its seats, in ring order, form one or two runs
// ("segments"): rank 0's bottom seats then its top seats (around the wrap),
// the last rank's top seats then its bottom seats, a middle rank's top run
// and its bottom run. Each run lives in a circular buffer of column slots in
// shared memory (W, V unless V stays in global memory, and the carried norm
// beside each slot): the shift between rounds is an offset into the buffer,
// not a copy. With one block (the whole ring in one run) the buffer has no
// spare slot and nothing is ever copied. With a cluster each run has one
// spare slot: the group of lanes that rotates the run's last seat writes its
// rotated column straight into the spare slot of the next run, on the peer
// block (a remote store into distributed shared memory), so that one
// cluster barrier a round publishes it and every read after the barrier is
// local. Top seat 0 has a fixed slot.
//
// A pair takes G lanes (4-32, the plan's `lanes`), the columns' entries in
// registers (up to kEntries rows a lane; longer columns are streamed twice),
// the groups of a warp starting at different rows so that they hit
// different shared-memory banks. apq is a shuffle tree over G lanes; the
// first round of a sweep takes the norms from the same registers.
//
// V in global memory (the plan's `vglobal`): V's columns stay in place in
// the output buffer, L2-resident, each slot carrying its column's index, and
// the group that rotates a pair reads and writes V's two columns there
// (through L2 only: the cluster barrier orders them between rounds). That
// halves the shared memory a matrix needs, so that a batch of 8 matrices of
// 512² in float32 runs in one wave of clusters of at most 9 blocks, where W
// and V in shared memory need clusters of at least 10, which an H100 holds
// 7 of at once.
//
// What no cluster of 16 holds (float64 at 1024²) runs the launch-a-round
// path: W and V in global memory, one launch a round over the whole batch,
// a warp per pair, plus one launch a sweep that refreshes the norms.
//
// Bound on the H100: operations. A sweep does about
// (n − 1)·(n/2)·(8M + 6n) + 2Mn flops on 2·(Mn + n²) values; at
// (1024, 64, 64) in float32 that is 1.9 GFLOP against 67 MB, 28 µs at
// 67 TFLOP/s against 20 µs for the bytes. Each round's apq is a dependent
// reduction, so a round costs at least a shuffle tree, a square root and
// two divides, and on a cluster one barrier.
//
// Before (one block of 1024 threads a matrix in shared memory, or one
// launch a round): 0.8895 ms at (1024, 64, 64), 5.8517 ms at (8, 512, 512)
// a sweep (NVIDIA H100 80GB HBM3, 700 W).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using nd4js::cluster_addr;
using nd4js::st_remote;

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kMaxThreads = 512;   // a ring block's most; 128 registers a thread
constexpr int kMaxCluster = 16;
constexpr int kEntries = 16;         // rows of a column a lane holds in registers
constexpr int kAlign = 32;           // a slot's columns start on 32 elements
constexpr int kRed = 32;             // one value a warp
constexpr int kLargeWarps = 8;       // warps a block in the launch-a-round path
constexpr int kPasses = 2;           // pairs a group of lanes takes a round, at most

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the aligned group of g lanes (a power of two); every lane of the
// group gets the same bits. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ T group_sum(T x, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
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

// The rotation of one pair from its norms and apq: (c, s), the pair's off
// measure, and the carried norms after it.
template <typename T>
struct Rot {
  T c, s, off, app, aqq;
};

template <typename T>
__device__ __forceinline__ Rot<T> rotation(T app, T aqq, T apq) {
  const T tiny = tiny_of<T>();
  app = app < T(0) ? T(0) : app;
  aqq = aqq < T(0) ? T(0) : aqq;
  Rot<T> r;
  r.off = fabs(apq) / (sqrt(app) * sqrt(aqq) + tiny);
  const bool small = fabs(apq) <= tiny;
  const T safe = small ? T(1) : apq;
  const T tau = (aqq - app) / (T(2) * safe);
  const T sgn = tau > T(0) ? T(1) : (tau < T(0) ? T(-1) : T(0));
  T t = sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
  if (tau == T(0)) t = T(1);
  if (small) t = T(0);
  r.c = rsqrt(T(1) + t * t);
  r.s = t * r.c;
  const T c2 = r.c * r.c, s2 = r.s * r.s, cs2 = T(2) * r.c * r.s;
  r.app = c2 * app - cs2 * apq + s2 * aqq;
  r.aqq = s2 * app + cs2 * apq + c2 * aqq;
  return r;
}

// ---------------------------------------------------------------- the ring

__host__ __device__ inline int round_up(int x) { return (x + kAlign - 1) / kAlign * kAlign; }

// First seat (pair) of rank b of a cluster of cs blocks, h pairs in all.
__host__ __device__ inline int seat_lo(int b, int cs, int h) {
  return (int)((long long)b * h / cs);
}

// A run of seats in a circular buffer: slots base..base+mod−1, positions
// 0..len−1 in ring order; the content of position k after `off` shifts sits
// at slot base + (k − off) mod `mod`.
struct Seg {
  int base, len, mod;
};

// The first run of rank b of a cluster (cs > 1): rank 0's bottom seats then
// its top seats past top 0, the last rank's top seats then its bottom seats,
// a middle rank's top seats. Each has one spare slot.
__host__ __device__ inline Seg first_seg(int b, int cs, int h) {
  const int s = seat_lo(b + 1, cs, h) - seat_lo(b, cs, h);
  if (b == 0) return Seg{0, 2 * s - 1, 2 * s};
  if (b == cs - 1) return Seg{0, 2 * s, 2 * s + 1};
  return Seg{0, s, s + 1};
}

// The run of rank b < cs − 1 whose position 0 is its last bottom seat
// (hi − 1): rank 0's only run, a middle rank's second.
__host__ __device__ inline Seg bottom_seg(int b, int cs, int h) {
  if (b == 0) return first_seg(0, cs, h);
  const int s = seat_lo(b + 1, cs, h) - seat_lo(b, cs, h);
  return Seg{s + 1, s, s + 1};
}

struct Ring {
  int lo, hi;      // the rank's seats
  int nseg;        // its runs
  Seg seg[2];
  int fixed;       // slot of top seat 0 (rank 0), else −1
  int nslots;
  // where each run's last seat goes: rank, and that rank's run
  int dst_rank[2];
  Seg dst[2];
};

__host__ __device__ inline Ring ring_of(int b, int cs, int h) {
  Ring R;
  R.lo = seat_lo(b, cs, h);
  R.hi = seat_lo(b + 1, cs, h);
  const int s = R.hi - R.lo;
  R.nseg = 1;
  R.fixed = -1;
  R.dst_rank[0] = R.dst_rank[1] = -1;
  R.dst[0] = R.dst[1] = Seg{0, 0, 1};
  R.seg[1] = Seg{0, 0, 1};
  if (cs == 1) {
    // the whole ring in one buffer with no spare: a shift is a relabelling
    R.seg[0] = Seg{0, 2 * h - 1, 2 * h - 1};
    R.fixed = 2 * h - 1;
    R.nslots = 2 * h;
    return R;
  }
  R.seg[0] = first_seg(b, cs, h);
  if (b == 0) {
    R.fixed = 2 * s;
    R.nslots = 2 * s + 1;
    R.dst_rank[0] = 1;  // top hi − 1 goes on to top hi
    R.dst[0] = first_seg(1, cs, h);
  } else if (b == cs - 1) {
    R.nslots = 2 * s + 1;
    R.dst_rank[0] = cs - 2;  // bottom lo goes on to bottom lo − 1
    R.dst[0] = bottom_seg(cs - 2, cs, h);
  } else {
    R.nseg = 2;
    R.seg[1] = Seg{s + 1, s, s + 1};
    R.nslots = 2 * s + 2;
    R.dst_rank[0] = b + 1;
    R.dst[0] = first_seg(b + 1, cs, h);
    R.dst_rank[1] = b - 1;
    R.dst[1] = bottom_seg(b - 1, cs, h);
  }
  return R;
}

// Slots a block of the launch lays out: the most any rank needs.
__host__ __device__ inline int max_slots(int cs, int h) {
  int most = 0;
  for (int b = 0; b < cs; ++b) {
    const int k = ring_of(b, cs, h).nslots;
    most = k > most ? k : most;
  }
  return most;
}

// Shared memory of one block, in bytes: the slots (W's column, and V's
// unless V stays in global memory, each from a multiple of kAlign
// elements), a norm a slot, the block's and the cluster's off, and a column
// index a slot. nd4js_tpu_torch/ops/jacobi_sweep.py::smem_bytes mirrors it.
__host__ __device__ inline size_t ring_bytes(int m, int n, int cs, int vglobal, size_t elem) {
  const size_t nslots = (size_t)max_slots(cs, n / 2);
  const size_t stride = (size_t)round_up(m) + (vglobal ? 0 : (size_t)round_up(n));
  return elem * (nslots * stride + nslots + kRed + kMaxCluster) + sizeof(int) * nslots;
}

// Run and position of seat t (top, or bottom), or run −1 for the fixed top 0.
__device__ __forceinline__ void seat_loc(const Ring& R, int cs, int h, int t, bool bottom,
                                         int* seg, int* pos) {
  const int s = R.hi - R.lo;
  if (!bottom && t == 0) {
    *seg = -1;
    *pos = 0;
  } else if (cs == 1) {
    *seg = 0;
    *pos = bottom ? 2 * h - 2 - t : t - 1;
  } else if (R.lo == 0) {
    *seg = 0;
    *pos = bottom ? s - 1 - t : s - 1 + t;
  } else if (R.hi == h) {
    *seg = 0;
    *pos = bottom ? s + (R.hi - 1 - t) : t - R.lo;
  } else {
    *seg = bottom ? 1 : 0;
    *pos = bottom ? R.hi - 1 - t : t - R.lo;
  }
}

// Where a seat's column is at shift 0: its slot, the circular buffer it
// cycles in (a fixed slot has mod 1), its run, and for a run's last seat on
// a cluster the peer (rank ≥ 0) that takes its rotated column.
struct SeatState {
  int slot, base, mod, run, rank;
};

__device__ __forceinline__ SeatState seat_state(const Ring& R, int cs, int h, int t,
                                                bool bottom) {
  int sg, ps;
  seat_loc(R, cs, h, t, bottom, &sg, &ps);
  SeatState st;
  st.rank = -1;
  st.run = sg < 0 ? 0 : sg;
  if (sg < 0) {
    st.slot = st.base = R.fixed;
    st.mod = 1;
    return st;
  }
  const Seg g = R.seg[sg];
  st.base = g.base;
  st.mod = g.mod;
  st.slot = g.base + ps;
  if (cs > 1 && ps == g.len - 1) st.rank = R.dst_rank[sg];
  return st;
}

// The slot of the same position after one more shift.
__device__ __forceinline__ int step_back(int slot, int base, int mod) {
  return slot == base ? slot + mod - 1 : slot - 1;
}

// 16 bytes of T: one vector load or store a lane.
template <typename T>
struct alignas(16) Chunk {
  static constexpr int N = 16 / (int)sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Chunk<T> ld_chunk(const T* p) {
  return *reinterpret_cast<const Chunk<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void st_chunk(T* p, const Chunk<T>& c) {
  *reinterpret_cast<Chunk<T>*>(p) = c;
}
// through L2 only, not the SM's L1 (V in global memory, written by other SMs)
__device__ __forceinline__ Chunk<float> ld_chunk_cg(const float* p) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  return Chunk<float>{{x.x, x.y, x.z, x.w}};
}
__device__ __forceinline__ Chunk<double> ld_chunk_cg(const double* p) {
  const double2 x = __ldcg(reinterpret_cast<const double2*>(p));
  return Chunk<double>{{x.x, x.y}};
}
__device__ __forceinline__ void st_chunk_cg(float* p, const Chunk<float>& c) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(c.v[0], c.v[1], c.v[2], c.v[3]));
}
__device__ __forceinline__ void st_chunk_cg(double* p, const Chunk<double>& c) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(c.v[0], c.v[1]));
}

__device__ __forceinline__ void st_remote(uint32_t a, const Chunk<float>& c) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(c.v[0]),
               "f"(c.v[1]), "f"(c.v[2]), "f"(c.v[3])
               : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t a, const Chunk<double>& c) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(a), "d"(c.v[0]), "d"(c.v[1])
               : "memory");
}

// (c·x − s·y, s·x + c·y) of two chunks
template <typename T>
__device__ __forceinline__ void rotate_chunks(T c, T s, const Chunk<T>& x, const Chunk<T>& y,
                                              Chunk<T>& a, Chunk<T>& b) {
#pragma unroll
  for (int k = 0; k < Chunk<T>::N; ++k) {
    a.v[k] = c * x.v[k] - s * y.v[k];
    b.v[k] = s * x.v[k] + c * y.v[k];
  }
}

// One column pair's rotated chunks, from registers, into its slots, or
// for a column that moves on, into the peer's.
template <typename T>
__device__ __forceinline__ void store_pair(T c, T s, const Chunk<T>* x, const Chunk<T>* y,
                                           T* p, T* q, uint32_t rp, uint32_t rq, bool remp,
                                           bool remq, int gl, int G, int swz, int len) {
  constexpr int N = Chunk<T>::N;
  constexpr int kC = kEntries / N;
#pragma unroll
  for (int e = 0; e < kC; ++e) {
    const int o = (gl + G * (e ^ swz)) * N;
    if (o < len) {
      Chunk<T> a, b;
      rotate_chunks(c, s, x[e], y[e], a, b);
      if (remp)
        st_remote(rp + o * (uint32_t)sizeof(T), a);
      else
        st_chunk(p + o, a);
      if (remq)
        st_remote(rq + o * (uint32_t)sizeof(T), b);
      else
        st_chunk(q + o, b);
    }
  }
}

// The same for a column too long for the registers: two passes over it.
template <typename T>
__device__ __forceinline__ void stream_pair(T c, T s, const T* p, const T* q, T* pd, T* qd,
                                            uint32_t rp, uint32_t rq, bool remp, bool remq,
                                            int gl, int G, int len, bool global) {
  for (int i = gl; i < len; i += G) {
    const T x = global ? __ldcg(p + i) : p[i];
    const T y = global ? __ldcg(q + i) : q[i];
    const T a = c * x - s * y, b = s * x + c * y;
    if (global) {
      __stcg(pd + i, a);
      __stcg(qd + i, b);
      continue;
    }
    if (remp)
      st_remote(rp + i * (uint32_t)sizeof(T), a);
    else
      pd[i] = a;
    if (remq)
      st_remote(rq + i * (uint32_t)sizeof(T), b);
    else
      qd[i] = b;
  }
}

template <typename T, bool kVGlobal>
__global__ void __launch_bounds__(kMaxThreads, 1)
jacobi_ring_kernel(const T* __restrict__ wt_in, const T* __restrict__ vt_in, T* wt_out,
                   T* vt_out, T* off_out, int m, int n, int sweeps, int lanes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int N = Chunk<T>::N;
  constexpr int kC = kEntries / N;  // chunks of a column a lane holds
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int h = n / 2;
  const Ring R = ring_of(rank, cs, h);
  const int nslots = max_slots(cs, h);
  const int ldw = round_up(m), ldv = round_up(n);
  const int stride = ldw + (kVGlobal ? 0 : ldv);
  T* cols = reinterpret_cast<T*>(smem_raw);
  T* nrm = cols + (size_t)nslots * stride;
  T* red = nrm + nslots;
  T* offs = red + kRed;
  int* colid = reinterpret_cast<int*>(offs + kMaxCluster);

  const size_t mat = blockIdx.x / cs;
  wt_in += mat * n * (size_t)m;
  wt_out += mat * n * (size_t)m;
  vt_in += mat * n * (size_t)n;
  vt_out += mat * n * (size_t)n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int s = R.hi - R.lo;

  // load: seat top t holds column t, bottom t column h + t, at shift 0;
  // the rows past m (and n) are zeros, which rotate into zeros
  for (int si = warp; si < 2 * s; si += nwarps) {
    const int t = R.lo + (si >> 1);
    const bool bottom = si & 1;
    const int slot = seat_state(R, cs, h, t, bottom).slot;
    const int col = bottom ? h + t : t;
    T* dst = cols + (size_t)slot * stride;
    for (int i = lane; i < ldw; i += 32) dst[i] = i < m ? wt_in[(size_t)col * m + i] : T(0);
    if constexpr (!kVGlobal)
      for (int i = lane; i < ldv; i += 32)
        dst[ldw + i] = i < n ? vt_in[(size_t)col * n + i] : T(0);
    if (lane == 0) colid[slot] = col;
  }
  if (cs > 1)
    cl.sync();  // every block of the cluster runs, and its slots are loaded
  else
    __syncthreads();

  const int G = lanes;
  const int gl = tid & (G - 1);
  const int group = tid / G;
  const int ngroups = nt / G;
  // two groups of four lanes share a quarter warp's 128 bytes of a vector
  // access: the odd one starts a chunk on, in the other half of the banks
  const int swz = G == 4 ? ((tid & 31) >> 2) & 1 : 0;
  const bool regw = ldw <= G * kEntries;
  const int vlen = kVGlobal ? n : ldv;
  const bool regv = vlen <= G * kEntries;
  const int npass = (s + ngroups - 1) / ngroups;  // at most kPasses (the plan's)
  // each pass's pair: the slots of its two seats, their buffers (base | mod
  // << 16), and which run's last seat each is (1 + run; 0: it stays)
  int sp[kPasses], sq[kPasses], bp[kPasses], bq[kPasses], op[kPasses], oq[kPasses];
  bool live[kPasses];
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    const int pi = ps * ngroups + group;
    live[ps] = pi < s;
    const int t = R.lo + (live[ps] ? pi : 0);
    const SeatState a = seat_state(R, cs, h, t, false), b = seat_state(R, cs, h, t, true);
    sp[ps] = a.slot;
    sq[ps] = b.slot;
    bp[ps] = a.base | a.mod << 16;
    bq[ps] = b.base | b.mod << 16;
    op[ps] = a.rank < 0 ? 0 : 1 + a.run;
    oq[ps] = b.rank < 0 ? 0 : 1 + b.run;
  }
  // where each run's last seat goes: the peer and its run's buffer
  const int drank0 = R.dst_rank[0], drank1 = R.dst_rank[1];
  const int dbase0 = R.dst[0].base, dbase1 = R.dst[1].base;
  const int dmod0 = R.dst[0].mod, dmod1 = R.dst[1].mod;
  T offm = T(0);

  for (int sw = 0, rt = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < n - 1; ++r, ++rt) {
      const bool fresh = r == 0;
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        if (ps >= npass) break;
        T* wp = cols + (size_t)sp[ps] * stride;
        T* wq = cols + (size_t)sq[ps] * stride;
        // read before the shuffles below, which every lane of the group
        // passes before lane 0 stores the new norms
        const T cpp = nrm[sp[ps]], cqq = nrm[sq[ps]];
        const int idp = colid[sp[ps]], idq = colid[sq[ps]];
        Chunk<T> x[kC], y[kC];
        T dot = T(0), np2 = T(0), nq2 = T(0);
        if (regw) {
#pragma unroll
          for (int e = 0; e < kC; ++e) {
            const int o = (gl + G * (e ^ swz)) * N;
            if (o < ldw) {
              x[e] = ld_chunk(wp + o);
              y[e] = ld_chunk(wq + o);
            } else {
#pragma unroll
              for (int k = 0; k < N; ++k) x[e].v[k] = y[e].v[k] = T(0);
            }
#pragma unroll
            for (int k = 0; k < N; ++k) dot += x[e].v[k] * y[e].v[k];
          }
          if (fresh)
#pragma unroll
            for (int e = 0; e < kC; ++e)
#pragma unroll
              for (int k = 0; k < N; ++k) {
                np2 += x[e].v[k] * x[e].v[k];
                nq2 += y[e].v[k] * y[e].v[k];
              }
        } else {
          for (int i = gl; i < ldw; i += G) {
            const T a = wp[i], b = wq[i];
            dot += a * b;
            np2 += a * a;
            nq2 += b * b;
          }
        }
        const T apq = group_sum(dot, G);
        T app = cpp, aqq = cqq;
        if (fresh) {
          app = group_sum(np2, G);
          aqq = group_sum(nq2, G);
        }
        const Rot<T> rot = rotation(app, aqq, apq);
        if (!live[ps]) continue;
        offm = nan_max(rot.off, offm);
        // a run's last seat moves on: its rotated column goes to the peer's
        // run, at that run's position 0 after this shift
        const bool remp = op[ps] != 0, remq = oq[ps] != 0;
        int rkp = rank, dsp = sp[ps], rkq = rank, dsq = sq[ps];
        if (remp) {
          const bool r1 = op[ps] == 2;
          const int dm = r1 ? dmod1 : dmod0;
          rkp = r1 ? drank1 : drank0;
          dsp = (r1 ? dbase1 : dbase0) + dm - 1 - rt % dm;
        }
        if (remq) {
          const bool r1 = oq[ps] == 2;
          const int dm = r1 ? dmod1 : dmod0;
          rkq = r1 ? drank1 : drank0;
          dsq = (r1 ? dbase1 : dbase0) + dm - 1 - rt % dm;
        }
        const uint32_t rp = remp ? cluster_addr(cols + (size_t)dsp * stride, rkp) : 0u;
        const uint32_t rq = remq ? cluster_addr(cols + (size_t)dsq * stride, rkq) : 0u;
        if (regw)
          store_pair(rot.c, rot.s, x, y, wp, wq, rp, rq, remp, remq, gl, G, swz, ldw);
        else
          stream_pair(rot.c, rot.s, wp, wq, wp, wq, rp, rq, remp, remq, gl, G, ldw, false);
        // V's two columns: in their slots (moving with W), or in place in
        // global memory through L2
        T* vp;
        T* vq;
        if constexpr (kVGlobal) {
          vp = vt_out + (size_t)idp * n;
          vq = vt_out + (size_t)idq * n;
        } else {
          vp = wp + ldw;
          vq = wq + ldw;
        }
        const uint32_t vo = ldw * (uint32_t)sizeof(T);
        if (regv) {
#pragma unroll
          for (int e = 0; e < kC; ++e) {
            const int o = (gl + G * (e ^ swz)) * N;
            if (o < vlen) {
              if constexpr (kVGlobal) {
                x[e] = ld_chunk_cg(vp + o);
                y[e] = ld_chunk_cg(vq + o);
              } else {
                x[e] = ld_chunk(vp + o);
                y[e] = ld_chunk(vq + o);
              }
            }
          }
          if constexpr (kVGlobal) {
#pragma unroll
            for (int e = 0; e < kC; ++e) {
              const int o = (gl + G * (e ^ swz)) * N;
              if (o < vlen) {
                Chunk<T> a, b;
                rotate_chunks(rot.c, rot.s, x[e], y[e], a, b);
                st_chunk_cg(vp + o, a);
                st_chunk_cg(vq + o, b);
              }
            }
          } else {
            store_pair(rot.c, rot.s, x, y, vp, vq, rp + vo, rq + vo, remp, remq, gl, G, swz,
                       vlen);
          }
        } else {
          stream_pair(rot.c, rot.s, vp, vq, vp, vq, rp + vo, rq + vo, remp, remq, gl, G, vlen,
                      kVGlobal);
        }
        if (gl == 0) {
          if (remp) {
            st_remote(cluster_addr(nrm + dsp, rkp), rot.app);
            st_remote(cluster_addr(colid + dsp, rkp), idp);
          } else {
            nrm[sp[ps]] = rot.app;
          }
          if (remq) {
            st_remote(cluster_addr(nrm + dsq, rkq), rot.aqq);
            st_remote(cluster_addr(colid + dsq, rkq), idq);
          } else {
            nrm[sq[ps]] = rot.aqq;
          }
        }
      }
      if (cs > 1)
        cl.sync();
      else
        __syncthreads();
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        sp[ps] = step_back(sp[ps], bp[ps] & 0xffff, bp[ps] >> 16);
        sq[ps] = step_back(sq[ps], bq[ps] & 0xffff, bq[ps] >> 16);
      }
    }
  }

  // every column is back at its seat; write them out from their slots
  const int shifts = sweeps * (n - 1);
  for (int si = warp; si < 2 * s; si += nwarps) {
    const int t = R.lo + (si >> 1);
    const bool bottom = si & 1;
    const SeatState st = seat_state(R, cs, h, t, bottom);
    const int slot = st.base + ((st.slot - st.base - shifts) % st.mod + st.mod) % st.mod;
    const int col = bottom ? h + t : t;
    const T* src = cols + (size_t)slot * stride;
    for (int i = lane; i < m; i += 32) wt_out[(size_t)col * m + i] = src[i];
    if constexpr (!kVGlobal)
      for (int i = lane; i < n; i += 32) vt_out[(size_t)col * n + i] = src[ldw + i];
  }
  // off: over the block, then over the cluster on rank 0
  for (int o = 16; o > 0; o >>= 1) offm = nan_max(__shfl_xor_sync(0xffffffffu, offm, o), offm);
  if (lane == 0) red[warp] = offm;
  __syncthreads();
  if (tid == 0) {
    T o = T(0);
    for (int k = 0; k < nwarps; ++k) o = nan_max(red[k], o);
    if (cs == 1)
      off_out[mat] = o;
    else if (rank == 0)
      offs[0] = o;
    else
      st_remote(cluster_addr(offs + rank, 0), o);
  }
  if (cs > 1) {
    cl.sync();
    if (rank == 0 && tid == 0) {
      T o = T(0);
      for (int k = 0; k < cs; ++k) o = nan_max(offs[k], o);
      off_out[mat] = o;
    }
  }
}

// ------------------------------------------------ the launch-a-round path

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

// One pair, by one whole warp, columns p and q in place in global memory.
// Returns the pair's off measure (the same in every lane).
template <typename T>
__device__ T rotate_pair(T* w, int m, T* v, int n, T* nrm, int p, int q) {
  const int lane = threadIdx.x & 31;
  T* wp = w + (size_t)p * m;
  T* wq = w + (size_t)q * m;
  T apq = T(0);
  for (int i = lane; i < m; i += 32) apq += wp[i] * wq[i];
  apq = warp_sum(apq);
  const Rot<T> rot = rotation(nrm[p], nrm[q], apq);
  const T c = rot.c, s = rot.s;
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
  __syncwarp();  // every lane has read nrm[p] and nrm[q]
  if (lane == 0) {
    nrm[p] = rot.app;
    nrm[q] = rot.aqq;
  }
  return rot.off;
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
jacobi_norms_kernel(const T* __restrict__ wt, T* nrm, int m, int n) {
  const int c = blockIdx.y * kLargeWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const size_t mat = blockIdx.x;
  const T* col = wt + (mat * n + c) * (size_t)m;
  T s = T(0);
  for (int i = threadIdx.x & 31; i < m; i += 32) s += col[i] * col[i];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) nrm[mat * n + c] = s;
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
int launch_rounds(const T* wt_in, const T* vt_in, T* wt, T* vt, T* off, T* nrm, int nb, int m,
                  int n, int sweeps, cudaStream_t s) {
  cudaError_t err = cudaMemcpyAsync(wt, wt_in, sizeof(T) * (size_t)nb * n * m,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(vt, vt_in, sizeof(T) * (size_t)nb * n * n, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(off, 0, sizeof(T) * (size_t)nb, s);
  if (err != cudaSuccess) return (int)err;
  const int h = n / 2;
  const dim3 norm_grid(nb, (n + kLargeWarps - 1) / kLargeWarps);
  const dim3 round_grid(nb, (h + kLargeWarps - 1) / kLargeWarps);
  for (int sw = 0; sw < sweeps; ++sw) {
    jacobi_norms_kernel<T><<<norm_grid, kLargeWarps * 32, 0, s>>>(wt, nrm, m, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int r = 0; r < n - 1; ++r) {
      jacobi_round_kernel<T><<<round_grid, kLargeWarps * 32, 0, s>>>(wt, vt, nrm, off, m, n, r);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

// The call on clusters of `cluster` blocks of `threads` threads, `lanes` a
// pair, V in global memory when `vglobal`, `smem` bytes a block, as the
// wrapper's plan computed them (checked against this file's layout); or,
// with cluster 0, the launch-a-round path.
template <typename T>
int launch(const T* wt_in, const T* vt_in, T* wt, T* vt, T* off, T* nrm, int nb, int m, int n,
           int sweeps, int cluster, int vglobal, int threads, int lanes, int smem,
           void* stream) {
  if (n < 2 || n % 2 || m < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 0) return launch_rounds(wt_in, vt_in, wt, vt, off, nrm, nb, m, n, sweeps, s);
  const int h = n / 2;
  if (cluster < 1 || cluster > kMaxCluster || cluster > h || threads < 32 ||
      threads > kMaxThreads || threads % 32 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      threads % lanes)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = ring_bytes(m, n, cluster, vglobal, sizeof(T));
  if (bytes != (size_t)smem || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  // a group of lanes takes at most kPasses pairs a round; V's columns in
  // global memory are read 16 bytes a lane
  const int pairs = (h + cluster - 1) / cluster;
  if ((pairs + threads / lanes - 1) / (threads / lanes) > kPasses ||
      (vglobal && n % (16 / (int)sizeof(T))))
    return (int)cudaErrorInvalidValue;
  if (vglobal) {
    const cudaError_t err = cudaMemcpyAsync(vt, vt_in, sizeof(T) * (size_t)nb * n * n,
                                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
    return nd4js::launch_clusters(jacobi_ring_kernel<T, true>, nb * cluster, threads, cluster,
                                  bytes, stream, wt_in, vt_in, wt, vt, off, m, n, sweeps, lanes);
  }
  return nd4js::launch_clusters(jacobi_ring_kernel<T, false>, nb * cluster, threads, cluster,
                                bytes, stream, wt_in, vt_in, wt, vt, off, m, n, sweeps, lanes);
}

}  // namespace

extern "C" {

// Clusters of a ring launch the card holds at once (its waves:
// ceil(nb / that)), or a negative CUDA error.
int nd4js_jacobi_clusters(int f64, int vglobal, int csize, int threads, int smem) {
  int clusters = 0;
  int rc;
  if (f64)
    rc = vglobal ? nd4js::active_clusters(jacobi_ring_kernel<double, true>, threads, csize,
                                          (size_t)smem, &clusters)
                 : nd4js::active_clusters(jacobi_ring_kernel<double, false>, threads, csize,
                                          (size_t)smem, &clusters);
  else
    rc = vglobal ? nd4js::active_clusters(jacobi_ring_kernel<float, true>, threads, csize,
                                          (size_t)smem, &clusters)
                 : nd4js::active_clusters(jacobi_ring_kernel<float, false>, threads, csize,
                                          (size_t)smem, &clusters);
  return rc != 0 ? -rc : clusters;
}

int nd4js_jacobi_sweeps_f32(const float* wt_in, const float* vt_in, float* wt, float* vt,
                            float* off, float* nrm, int nb, int m, int n, int sweeps, int cluster,
                            int vglobal, int threads, int lanes, int smem, void* stream) {
  return launch<float>(wt_in, vt_in, wt, vt, off, nrm, nb, m, n, sweeps, cluster, vglobal,
                       threads, lanes, smem, stream);
}

int nd4js_jacobi_sweeps_f64(const double* wt_in, const double* vt_in, double* wt, double* vt,
                            double* off, double* nrm, int nb, int m, int n, int sweeps,
                            int cluster, int vglobal, int threads, int lanes, int smem,
                            void* stream) {
  return launch<double>(wt_in, vt_in, wt, vt, off, nrm, nb, m, n, sweeps, cluster, vglobal,
                        threads, lanes, smem, stream);
}

}  // extern "C"

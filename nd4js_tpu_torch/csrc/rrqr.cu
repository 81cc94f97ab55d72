// rrqr: column-pivoted Householder QR with downdated squared column norms, on
// a batch of A (Nb, M, N), K = min(M, N) steps.
//
// Replaces the TPU kernel nd4js_tpu/ops/rrqr_kernel.py::rrqr_kernel
// (_rrqr_kernel). Same contract as its caller (la/rrqr.py) consumes it. The
// squared column norms are computed once on entry. At step j they are clamped
// at 0; the pivot p is the column ≥ j of largest norm, the lowest index on a
// tie (j if none compares, for NaN norms); columns, perm entries and norms j
// and p swap; the reflector of column j, rows ≥ j, has β = −sign(x₀)·‖x‖,
// τ = (β − x₀)/β, τ = 0 for a zero column, v₀ = 1 (common.cuh:
// make_reflector); it is applied to the columns > j; column j becomes β at
// row j, zeros below, the old entries above; and the norm of each column
// c > j loses r_jc², r_jc its new row-j entry. Outputs: R_packed
// (column-major, as the (Nb, N, M) array Rᵀ), the reflectors (as the
// (Nb, K, M) array Vᵀ: a unit at j, zeros above), taus (Nb, K) and perm
// (Nb, N) int32. One unblocked step at a time: a delayed (xLAQPS) update
// would choose pivots on other norms.
//
// Layout: A comes column-major (the (Nb, N, M) array Aᵀ) so a column is
// contiguous.
//
// Design: one launch runs all K steps, each matrix on one thread-block
// cluster of 1-16 blocks (the wrapper's plan). Block b owns a fixed range of
// physical columns; the first `ncs` of them stay in its shared memory and
// any rest in a global scratch copy (L2-resident), as in sytrd_panel.
// Columns never move: the pivot swap is a swap in the maps between logical
// positions and physical columns (pos, phys), which every block keeps whole
// and updates alike, and the perm output is phys. A warp owns fixed columns
// of its block. A step:
//   1. every thread reduces the candidates (the largest clamped norm of each
//      warp, or of each block of a cluster, with its logical index) to the
//      pivot p;
//   2. the block that owns column p forms the reflector: σ in partial sums
//      a warp and one block barrier, then each thread its rows of v (IEEE
//      divides), which it writes to its row of Vᵀ and pushes into every
//      block's shared memory (remote stores), with τ; one barrier (a
//      cluster barrier on a cluster). (One warp took 4000 cycles a step at
//      (32, 512, 512), all of it on every block's path: timer stamps in an
//      uncommitted copy, NVIDIA H100 80GB HBM3);
//   3. each warp applies the reflector to its active columns, eight at a
//      time with their reductions interleaved, and lane 0 downdates and
//      clamps their norms and keeps the warp's best (value, logical index):
//      the next pivot's argmax rides on the update; on a cluster warp 0
//      reduces the block's and pushes it to every peer; one barrier.
// So two barriers a step, against six in the block of 512 threads a matrix
// that this replaces, and two launches a step over the whole batch in its
// global-memory regime.
//
// Bound on the H100. The factorisation does about 4MNK − 2K²(M + N) + 4K³/3
// flops on MN values in and MN + MK out. At (1024, 128, 128) in float32 that
// is 2.9 GFLOP against 201 MB, so bytes bound it (60 µs against 43 µs); at
// (32, 512, 512), 5.7 GFLOP against 101 MB, operations (86 µs against
// 30 µs). The K steps are dependent: each waits for the last one's norms to
// choose its pivot.
//
// Before: 2.4280 ms at (1024, 128, 128), 7.9038 ms at (32, 512, 512)
// (NVIDIA H100 80GB HBM3, 700 W).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using nd4js::cluster_addr;
using nd4js::st_remote;

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kMaxThreads = 512;
constexpr int kManyThreads = 256;    // a block of the instance for several blocks an SM
constexpr int kMaxCluster = 16;
constexpr int kChunk = 8;            // columns a warp updates at once
constexpr int kAlign = 4;            // a column in shared memory starts on 4 elements
constexpr int kRed = 32;             // one value a warp

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (value, index) with the larger value winning, the lower index on a tie
template <typename T>
__device__ __forceinline__ void arg_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The best of `count` candidates (vals, idxs) in every lane: its index, and
// its value through `val`; (−1, n) if none compares.
template <typename T>
__device__ __forceinline__ int best_of(const T* vals, const int* idxs, int count, int n,
                                       T* val) {
  const int lane = threadIdx.x & 31;
  T v = T(-1);
  int i = n;
  for (int k = lane; k < count; k += 32) arg_better(v, i, vals[k], idxs[k]);
  for (int off = 16; off > 0; off >>= 1) {
    const T v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    arg_better(v, i, v2, i2);
  }
  *val = v;
  return i;
}

__host__ __device__ inline int round_up(int x) { return (x + kAlign - 1) / kAlign * kAlign; }

// First physical column of rank b of a cluster of cs blocks.
__host__ __device__ inline int cols_lo(int b, int cs, int n) { return b * n / cs; }

// Shared memory of one block, in bytes: ncs columns of round_up(M), v and τ,
// the block's norms, the cluster's and the warps' candidates, the warps'
// parts of σ, then the maps pos and phys, the candidates' indices, the two
// lists of active columns, each column's place in its list and the lists'
// lengths.
// nd4js_tpu_torch/ops/rrqr_kernel.py::smem_bytes mirrors it.
__host__ __device__ inline size_t rrqr_bytes(int m, int n, int cs, int ncs, size_t elem) {
  const size_t ldm = (size_t)round_up(m);
  const size_t ncmax = (size_t)((n + cs - 1) / cs);
  return elem * ((size_t)ncs * ldm + ldm + 1 + ncmax + kMaxCluster + 2 * kRed) +
         sizeof(int) * (2 * (size_t)n + kMaxCluster + kRed + 3 * ncmax + 2);
}

// Sums of eight values over the warp, each in every lane: halving
// exchanges leave lane l with the sum of value 4·l₄ + 2·l₃ + l₂ over its
// quarter (l₄, l₃, l₂ the lane's bits 4, 3, 2), two more levels finish it,
// and eight broadcasts hand every sum to every lane; 17 shuffles, against
// 40 for eight butterflies.
template <typename T>
__device__ __forceinline__ void reduce8(T (&a)[kChunk]) {
  static_assert(kChunk == 8, "reduce8 takes eight values");
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  T a4[4], a2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T send = b4 ? a[k] : a[k + 4];
    a4[k] = (b4 ? a[k + 4] : a[k]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T send = b3 ? a4[k] : a4[k + 2];
    a2[k] = (b3 ? a4[k + 2] : a4[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  T a1 = (b2 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? a2[0] : a2[1], 4);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    a[c] = __shfl_sync(0xffffffffu, a1, ((c >> 2) & 1) * 16 + ((c >> 1) & 1) * 8 + (c & 1) * 4);
}

// 16 bytes of T, for the shared-memory columns' loads and stores.
template <typename T>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);
  T v[N];
};

// Step 3 on one list of active columns (`base` + l·`stride`: columns in
// shared memory, 16 bytes a lane a row group when kVec, or in the scratch
// copy, one row a lane), shared out evenly among the warps,
// kChunk at a time: a_c −= v·(τ·vᵀa_c) over rows ≥ j, each column's
// reduction interleaved with the others'; then lane c downdates column c's
// norm by its new row-j entry (v_j = 1, so it is the old one less τ·vᵀa_c),
// clamps it and keeps the best (value, logical index) in (best, bi).
template <typename T, bool kVec, typename Lpos>
__device__ __forceinline__ void update_list(T* base, int stride, const int* list, int cnt,
                                            int j, int m, const T* vbuf, T tau, T* nrm, int c0,
                                            Lpos lpos, T& best, int& bi) {
  constexpr int N = Vec16<T>::N;
  // the vector that holds row j; its rows above j take v = 0 (vbuf holds an
  // earlier step's there), and the rows past m are zeros in every column
  // and in vbuf
  const int i0 = j / N * N;
  auto vload = [&](int ib) {
    Vec16<T> vv = *reinterpret_cast<const Vec16<T>*>(vbuf + ib);
    if (ib < j)
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (ib + k < j) vv.v[k] = T(0);
    return vv;
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int k0 = warp; k0 < cnt; k0 += kChunk * nwarps) {
    int off[kChunk];  // each column's offset from base, −1 past the list
    int lid = -1;     // lane c: column c's local index
    T oldj = T(0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int k = k0 + c * nwarps;
      const int l = k < cnt ? list[k] : -1;
      off[c] = l >= 0 ? l * stride : -1;
      if (lane == c && l >= 0) {
        lid = l;
        oldj = base[off[c] + j];
      }
    }
    T acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = T(0);
    if constexpr (kVec) {
#pragma unroll 2
      for (int ib = i0 + N * lane; ib < m; ib += 32 * N) {
        const Vec16<T> vv = vload(ib);
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (off[c] >= 0) {
            const Vec16<T> a = *reinterpret_cast<const Vec16<T>*>(base + off[c] + ib);
#pragma unroll
            for (int k = 0; k < N; ++k) acc[c] += vv.v[k] * a.v[k];
          }
      }
    } else {
#pragma unroll 4
      for (int i = j + lane; i < m; i += 32) {
        const T vi = vbuf[i];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (off[c] >= 0) acc[c] += vi * base[off[c] + i];
      }
    }
    reduce8(acc);
    T wl = T(0);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      acc[c] *= tau;
      if (lane == c) wl = acc[c];
    }
    if constexpr (kVec) {
#pragma unroll 2
      for (int ib = i0 + N * lane; ib < m; ib += 32 * N) {
        const Vec16<T> vv = vload(ib);
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (off[c] >= 0) {
            Vec16<T>* pa = reinterpret_cast<Vec16<T>*>(base + off[c] + ib);
            Vec16<T> a = *pa;
#pragma unroll
            for (int k = 0; k < N; ++k) a.v[k] -= vv.v[k] * acc[c];
            *pa = a;
          }
      }
    } else {
#pragma unroll 4
      for (int i = j + lane; i < m; i += 32) {
        const T vi = vbuf[i];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (off[c] >= 0) base[off[c] + i] -= vi * acc[c];
      }
    }
    if (lid >= 0) {
      const T r = oldj - wl;
      T nv = nrm[lid] - r * r;
      nv = nv < T(0) ? T(0) : nv;
      nrm[lid] = nv;
      arg_better(best, bi, nv, lpos(c0 + lid));
    }
  }
}

// kMany: one block a matrix of at most kManyThreads threads, whose
// registers let three share an SM (three 128² float32 matrices fit its
// shared memory).
template <typename T, bool kMany>
__global__ void __launch_bounds__(kMany ? kManyThreads : kMaxThreads, kMany ? 3 : 1)
rrqr_kernel(const T* __restrict__ at, T* rt, T* vt, T* taus, int* perm_out, T* work, int m,
            int n, int ncs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int k = m < n ? m : n;
  const int ldm = round_up(m);
  const int c0 = cols_lo(rank, cs, n);
  const int nc = cols_lo(rank + 1, cs, n) - c0;
  const int ncmax = (n + cs - 1) / cs;
  const int nsm = ncs < nc ? ncs : nc;  // the block's columns in shared memory
  T* cols = reinterpret_cast<T*>(smem_raw);
  T* vbuf = cols + (size_t)ncs * ldm;  // v over rows ≥ j, then τ at ldm
  T* nrm = vbuf + ldm + 1;             // the block's columns' norms
  T* candv = nrm + ncmax;              // each rank's best (pushed)
  T* redv = candv + kMaxCluster;       // each warp's best
  T* sig = redv + kRed;                // each warp's part of σ
  int* pos = reinterpret_cast<int*>(sig + kRed);  // logical position of a physical column
  int* phys = pos + n;                             // physical column at a logical position
  int* candi = phys + n;
  int* redi = candi + kMaxCluster;
  int* acts = redi + kRed;   // the active columns in shared memory, then
  int* actg = acts + ncmax;  // those in the scratch copy (local indices)
  int* where = actg + ncmax;  // each column's place in its list
  int* counts = where + ncmax;  // the two lists' lengths

  const size_t mat = blockIdx.x / cs;
  const size_t msz = (size_t)n * m;
  at += mat * msz;
  rt += mat * msz;
  vt += mat * k * (size_t)m;
  taus += mat * k;
  perm_out += mat * n;
  T* wcols = work == nullptr ? nullptr : work + mat * msz + (size_t)c0 * m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  // the block's l-th column: in shared memory, or in the scratch copy
  auto col = [&](int l) -> T* {
    return l < nsm ? cols + (size_t)l * ldm : wcols + (size_t)l * m;
  };

  for (int c = tid; c < n; c += nt) pos[c] = phys[c] = c;
  for (int l = tid; l < nc; l += nt) {
    if (l < nsm) {
      acts[l] = l;
      where[l] = l;
    } else {
      actg[l - nsm] = l;
      where[l] = l - nsm;
    }
  }
  if (tid == 0) {
    counts[0] = nsm;
    counts[1] = nc - nsm;
  }
  // load, with the squared norms; warp w loads columns w, w + nwarps, ...
  T best = T(-1);
  int bi = n;
  for (int i = m + tid; i < ldm; i += nt) vbuf[i] = T(0);
  for (int l = warp; l < nc; l += nwarps) {
    const T* src = at + (size_t)(c0 + l) * m;
    T* dst = col(l);
    T s = T(0);
    for (int i = lane; i < m; i += 32) {
      const T x = src[i];
      dst[i] = x;
      s += x * x;
    }
    if (l < nsm)
      for (int i = m + lane; i < ldm; i += 32) dst[i] = T(0);
    s = warp_sum(s);
    if (lane == 0) nrm[l] = s;
    arg_better(best, bi, s, c0 + l);
  }

  // publish each warp's (best, bi): to the block, then on a cluster each
  // block's to every rank; the barrier that ends a step
  auto publish = [&]() {
    if (lane == 0) {
      redv[warp] = best;
      redi[warp] = bi;
    }
    __syncthreads();
    if (cs > 1) {
      if (warp == 0) {
        T bv;
        const int b = best_of(redv, redi, nwarps, n, &bv);
        if (lane < cs) {
          st_remote(cluster_addr(candv + rank, lane), bv);
          st_remote(cluster_addr(candi + rank, lane), b);
        }
      }
      cl.sync();
    }
  };
  if (cs > 1)
    cl.sync();  // every block runs before the first remote store
  publish();

  for (int j = 0; j < k; ++j) {
    // 1. the pivot
    T pv;
    int p = cs > 1 ? best_of(candv, candi, cs, n, &pv) : best_of(redv, redi, nwarps, n, &pv);
    if (p >= n) p = j;
    const int P = phys[p], J = phys[j];
    int owner = P * cs / n;
    while (owner + 1 < cs && cols_lo(owner + 1, cs, n) <= P) ++owner;
    while (cols_lo(owner, cs, n) > P) --owner;
    // 2. the reflector, by the block that owns column p: σ in partial sums
    // a warp, one block barrier, then every thread forms the same
    // reflector and takes its rows of v (IEEE divides), pushing them to
    // every peer; the owner's last warp takes column p off its list
    if (rank == owner) {
      T* x = col(P - c0);
      const T x0 = x[j];
      T s = T(0);
      for (int i = j + 1 + tid; i < m; i += nt) s += x[i] * x[i];
      s = warp_sum(s);
      if (lane == 0) sig[warp] = s;
      __syncthreads();  // every thread has read x0, and the partial sums are in
      T sigma = T(0);
      for (int w = 0; w < nwarps; ++w) sigma += sig[w];
      const nd4js::Reflector<T> hr = nd4js::make_reflector(x0, sigma);
      T* vrow = vt + (size_t)j * m;  // zeros above j: the launch clears vt
      for (int i = j + tid; i < m; i += nt) {
        const T vi = i == j ? T(1) : x[i] / hr.den;
        vrow[i] = vi;
        vbuf[i] = vi;
        x[i] = i == j ? hr.beta : T(0);
        for (int q = 0; q < cs; ++q)
          if (q != rank) st_remote(cluster_addr(vbuf + i, q), vi);
      }
      if (tid == 0) {
        taus[j] = hr.tau;
        vbuf[ldm] = hr.tau;
        for (int q = 0; q < cs; ++q)
          if (q != rank) st_remote(cluster_addr(vbuf + ldm, q), hr.tau);
      }
    }
    if (rank == owner && tid == nt - 32) {
      const int l = P - c0;
      const int g = l < nsm ? 0 : 1;
      int* list = g == 0 ? acts : actg;
      const int last = list[--counts[g]];
      list[where[l]] = last;
      where[last] = where[l];
    }
    if (cs > 1)
      cl.sync();
    else
      __syncthreads();
    // the maps after the swap; until the next barrier every other thread
    // reads pos only for columns other than P and J
    auto lpos = [&](int q) { return q == P ? j : (q == J ? p : pos[q]); };
    if (tid == 0) {
      pos[P] = j;
      pos[J] = p;
      phys[j] = P;
      phys[p] = J;
    }
    // 3. the update of the active columns, the downdate and the next argmax
    const T tau = vbuf[ldm];
    best = T(-1);
    bi = n;
    update_list<T, true>(cols, ldm, acts, counts[0], j, m, vbuf, tau, nrm, c0, lpos, best, bi);
    if (counts[1] > 0)
      update_list<T, false>(wcols, m, actg, counts[1], j, m, vbuf, tau, nrm, c0, lpos, best,
                            bi);
    for (int o = 16; o > 0; o >>= 1) {
      const T v2 = __shfl_xor_sync(0xffffffffu, best, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      arg_better(best, bi, v2, i2);
    }
    publish();
  }

  // R_packed: each physical column at its logical place; perm = phys
  for (int l = warp; l < nc; l += nwarps) {
    const T* src = col(l);
    T* dst = rt + (size_t)pos[c0 + l] * m;
    for (int i = lane; i < m; i += 32) dst[i] = src[i];
  }
  if (rank == 0)
    for (int c = tid; c < n; c += nt) perm_out[c] = phys[c];
}

inline bool many_blocks(int cluster, int threads) {
  return cluster == 1 && threads <= kManyThreads;
}

// The factorisation on clusters of `cluster` blocks of `threads` threads,
// `ncs` columns a block in shared memory (the rest in `work`, a scratch the
// size of A), `smem` bytes a block, as the wrapper's plan computed them
// (checked against this file's layout).
template <typename T>
int launch(const T* at, T* rt, T* vt, T* taus, int* perm, T* work, int nb, int m, int n,
           int cluster, int threads, int ncs, int smem, void* stream) {
  if (m < 1 || n < 1 || n >= (1 << 26)) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  if (cluster < 1 || cluster > kMaxCluster || cluster > n || threads < 32 ||
      threads > kMaxThreads || threads % 32 || ncs < 0 || ncs > (n + cluster - 1) / cluster)
    return (int)cudaErrorInvalidValue;
  if (ncs < (n + cluster - 1) / cluster && work == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = rrqr_bytes(m, n, cluster, ncs, sizeof(T));
  if (bytes != (size_t)smem || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(vt, 0, sizeof(T) * (size_t)nb * (m < n ? m : n) * m,
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if (many_blocks(cluster, threads))
    return nd4js::launch_clusters(rrqr_kernel<T, true>, nb * cluster, threads, cluster, bytes,
                                  stream, at, rt, vt, taus, perm, work, m, n, ncs);
  return nd4js::launch_clusters(rrqr_kernel<T, false>, nb * cluster, threads, cluster, bytes,
                                stream, at, rt, vt, taus, perm, work, m, n, ncs);
}

}  // namespace

extern "C" {

// Clusters of a launch the card holds at once (its waves: ceil(nb / that)),
// or a negative CUDA error.
int nd4js_rrqr_clusters(int f64, int csize, int threads, int smem) {
  int clusters = 0;
  const bool many = many_blocks(csize, threads);
  int rc;
  if (f64)
    rc = many ? nd4js::active_clusters(rrqr_kernel<double, true>, threads, csize, (size_t)smem,
                                       &clusters)
              : nd4js::active_clusters(rrqr_kernel<double, false>, threads, csize, (size_t)smem,
                                       &clusters);
  else
    rc = many ? nd4js::active_clusters(rrqr_kernel<float, true>, threads, csize, (size_t)smem,
                                       &clusters)
              : nd4js::active_clusters(rrqr_kernel<float, false>, threads, csize, (size_t)smem,
                                       &clusters);
  return rc != 0 ? -rc : clusters;
}

int nd4js_rrqr_f32(const float* at, float* rt, float* vt, float* taus, int* perm, float* work,
                   int nb, int m, int n, int cluster, int threads, int ncs, int smem,
                   void* stream) {
  return launch<float>(at, rt, vt, taus, perm, work, nb, m, n, cluster, threads, ncs, smem,
                       stream);
}

int nd4js_rrqr_f64(const double* at, double* rt, double* vt, double* taus, int* perm,
                   double* work, int nb, int m, int n, int cluster, int threads, int ncs,
                   int smem, void* stream) {
  return launch<double>(at, rt, vt, taus, perm, work, nb, m, n, cluster, threads, ncs, smem,
                        stream);
}

}  // extern "C"

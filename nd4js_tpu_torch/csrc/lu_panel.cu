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
// right-looking elimination in full precision. Its multipliers are IEEE
// quotients and its products and differences are rounded one by one (no
// fused multiply-add), as the plain versions in ops/lu_panel.py compute them,
// so the pivots and the ranks come out equal to theirs.
//
// Bound on the H100: neither bytes nor operations. lu_panel reads and writes
// M·B values and does M·B² − B³/3 flops; lu_gesv reads N·(N+K) values,
// writes N·K and does 2/3·N³ + 2·N²·K flops. But each of the B (or N) steps
// waits for the previous one: the argmax of a column, then a rank-1 update of
// the rows still unused. A step is a chain of latencies.
//
// What held the first version back: one block of 512 threads a matrix (32 of
// 132 SMs at the panels' batch of 32; the 256 KB panel of M = 512 in global
// memory), five block barriers a step, the argmax of column j + 1 searched
// after step j's update instead of during it, every thread reducing the 16
// warps' candidates one after another; lu_gesv's matrix took 66 KB of shared
// memory (three systems an SM), its pivot search kept 128 of 512 threads
// busy, and its back substitution took two block barriers a row.
//
// Design.
// lu_elim (lu_panel, and lu_gesv where registers do not hold a system): each
// matrix on a thread-block cluster of 1-16 blocks (the wrapper's plan), block
// b holding a slab of rows in its shared memory at an odd stride (or, where
// no cluster holds the matrix, in global memory, L2-resident). A warp owns
// fixed rows of its block. A step j:
//   1. every warp reduces the candidates of column j that every warp of the
//      cluster pushed into its block before the last barrier (value, row;
//      redux.sync on the value's bits, then on the row) to the pivot p, and
//      finds row p's block in a table (no integer division on the chain);
//   2. lanes over the warp's rows: the live rows' entries of column j become
//      their multipliers (IEEE quotients), listed with their rows in the
//      warp's shared memory;
//   3. lanes over the columns, each lane owning the same columns every step
//      (immediate offsets, one predicate a chunk of 32), update the listed
//      rows eight at a time with their loads issued together, row p's
//      entries read once into registers from the block that holds it
//      (distributed shared memory);
//   4. lanes over the listed rows: the warp's best new |value| of column
//      j + 1 (the next pivot's candidate, taken from the update just made)
//      goes into every block's double buffer by remote stores, and one
//      barrier ends the step (a cluster barrier on a cluster, a block
//      barrier on one block).
// A cluster barrier costs about 1000 cycles a step more than a block's
// (barrier.cluster compiles to MEMBAR.ALL.GPU and the barrier), so the plan
// takes a cluster only where a block's slab would be long.
// lu_gesv in registers (float32, N <= 128, N + K <= 136): one block of eight
// warps a system, two blocks an SM. [A | y] lives in registers: warp w holds
// the columns w, w + 8, ..., each lane four rows of them (68 values; with
// four warps of 132 values each the compiler had too few registers left to
// overlap the products, and an uncommitted four-warp variant took 1.14 ms
// against eight's 0.86 at config 2, NVIDIA H100 80GB HBM3). A step: every
// warp takes the step's pivot and multipliers from a double buffer in
// shared memory, the pivot row's entries from the lane that holds them
// (shuffles, outside any branch), and updates its columns four at a time
// without a branch; the pivot row's entries are U's row j and z_j, which
// the warps store as they take them, so the rows already pivot need no mask
// (their registers are never read again). The warp holding column j + 1
// updates that column's group first, searches the next pivot there
// (redux.sync), divides the column into the next multipliers and publishes
// them before its other columns: steps hand on through two named barriers
// (published; read by all) instead of a block barrier, so the chain a step
// is one group's update and the pivot's search. Back substitution: one
// warp a right-hand side, lanes over the steps, on running sums in
// registers, U packed by columns in shared memory; no barrier a row.
//
// Before: 1.6238 ms at (32, 512, 128) (lu_panel) and 1.7532 ms at
// (1024, 128, 128), K = 1 (lu_gesv), float32 (NVIDIA H100 80GB HBM3, 700 W).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using nd4js::cluster_addr;
using nd4js::st_remote;

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kMaxThreads = 512;     // a block of lu_elim
constexpr int kMaxCluster = 16;
constexpr int kChunks = 4;           // column chunks of 32 a warp holds at once
constexpr int kQuad = 8;             // rows a warp updates at once
constexpr int kRegWarps = 8;         // lu_gesv in registers: warps a system
constexpr int kRegRows = 4;          // row slots a lane: N <= 128
constexpr int kRegCols = 17;         // column slots a warp: N + K <= 136
constexpr int kRegBlocks = 2;        // systems an SM holds (no spills)
constexpr int kRegGroup = 4;         // column slots updated without a branch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// First row of rank b of a cluster of cs blocks over m rows (m < 2^26: a
// 32-bit division; a 64-bit one is a subroutine of hundreds of cycles).
__host__ __device__ inline int rows_lo(int b, int cs, int m) { return b * m / cs; }

// Shared memory of one lu_elim block, in bytes: its rows of the matrix at
// an odd stride (shared regime); the candidates' values (a double buffer of
// one a warp of the cluster) and each warp's list of its live rows'
// multipliers (ceil(rows / warps) a warp); the candidates' rows, each
// warp's list of its live rows, the ranks of its rows (shared regime), the
// pivot row of each step (when solving) and each row's block and place in
// it (shared regime).
// nd4js_tpu_torch/ops/lu_panel.py::smem_bytes mirrors it.
__host__ __device__ inline size_t elim_bytes(int m, int ncols, int steps, int cs, int nw,
                                             bool shared, bool solve, size_t elem) {
  const size_t rmax = (size_t)((m + cs - 1) / cs);
  const size_t ncand = (size_t)cs * nw;
  const size_t lists = (rmax + nw - 1) / nw * nw;
  return (shared ? align16(elem * rmax * (size_t)(ncols | 1)) : 0) +
         align16(elem * (2 * ncand + lists)) +
         sizeof(int) * (2 * ncand + lists + (shared ? rmax + (size_t)m : 0) +
                        (solve ? (size_t)steps : 0));
}

// Shared memory of one lu_gesv_regs block, in bytes: U packed by columns
// (first the staging tile of the load, 32 rows at an odd stride), z in step
// order, the multipliers' double buffer, the stash of column j + 1 and the
// pivots' double buffer.
// nd4js_tpu_torch/ops/lu_panel.py::gesv_regs_bytes mirrors it.
__host__ __device__ inline size_t regs_bytes(int n, int k) {
  const size_t tri = (size_t)n * (n + 1) / 2;
  const size_t tile = (size_t)32 * ((n + k) | 1);
  const size_t area = (tri > tile ? tri : tile);
  return sizeof(float) * ((area + 3) / 4 * 4 + (size_t)n * k + 3 * 32 * kRegRows) +
         sizeof(int) * 2;
}

// A candidate pivot is (|value|, row), row kNone for none. The bits of a
// non-negative value order as unsigned integers, and a NaN's lie above
// inf's, so "larger value, then lower row" is an integer comparison without
// a branch, and a NaN wins: the step then has no pivot, as the plain
// versions' max-then-first-index gives.
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ unsigned long long key_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long key_of(double v) {
  return (unsigned long long)__double_as_longlong(v);
}

// Is candidate (v, i) better than (bv, bi)? (No branch: & and |.)
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  const unsigned long long a = key_of(v), b = key_of(bv);
  return (a > b) | ((a == b) & (i < bi));
}

// The warp's best candidate (v, i), in every lane: redux.sync reductions,
// the value's bits from the high word down, then the lowest row.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const unsigned vb = __float_as_uint(v);
  const unsigned mx = __reduce_max_sync(kFull, vb);
  i = (int)__reduce_min_sync(kFull, vb == mx ? (unsigned)i : (unsigned)kNone);
  v = __uint_as_float(mx);
}
__device__ __forceinline__ void warp_best(double& v, int& i) {
  const unsigned long long b = key_of(v);
  const unsigned hi = (unsigned)(b >> 32), lo = (unsigned)b;
  const unsigned mh = __reduce_max_sync(kFull, hi);
  const unsigned ml = __reduce_max_sync(kFull, hi == mh ? lo : 0u);
  i = (int)__reduce_min_sync(kFull, hi == mh && lo == ml ? (unsigned)i : (unsigned)kNone);
  v = __longlong_as_double((long long)(((unsigned long long)mh << 32) | ml));
}

// ---------------------------------------------------------------- lu_elim

// Elimination of `steps` columns of the row-major (Nb, m, ncols) array g, in
// place, each matrix on a cluster; rank (Nb, m) gets each row's step (steps
// if never). With k > 0 (one block a system, m = steps = n, ncols = n + k),
// then the back substitution into x (Nb, n, k).
template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
lu_elim(T* g, int* rank, T* x, int m, int ncols, int steps, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int me = (int)cl.block_rank();
  const int nw = (int)(blockDim.x >> 5), warp = (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  const int ncand = cs * nw;
  const int r0 = rows_lo(me, cs, m), nr = rows_lo(me + 1, cs, m) - r0;
  const int rmax = (m + cs - 1) / cs;
  const int lq = (rmax + nw - 1) / nw;  // the most rows a warp holds
  // a row's stride: odd in shared memory, so that lanes over rows read a
  // column without bank conflicts
  const int ld = kShared ? (ncols | 1) : ncols;
  const size_t mat = blockIdx.x / cs;
  T* gm = g + mat * (size_t)m * ncols;
  rank += mat * (size_t)m;
  unsigned char* sp = smem_raw;
  T* slab = kShared ? reinterpret_cast<T*>(sp) : gm + (size_t)r0 * ncols;
  if (kShared) sp += align16(sizeof(T) * (size_t)rmax * ld);
  T* candv = reinterpret_cast<T*>(sp);
  T* lm = candv + 2 * ncand + lq * warp;  // the warp's live rows' multipliers
  sp += align16(sizeof(T) * (2 * (size_t)ncand + (size_t)lq * nw));
  int* candi = reinterpret_cast<int*>(sp);
  int* lst = candi + 2 * ncand + lq * warp;  // the warp's live rows
  int* rk = kShared ? candi + 2 * ncand + lq * nw : rank + r0;  // each row's step
  int* prow = candi + 2 * ncand + lq * nw + (kShared ? rmax : 0);
  int* own = prow + (k > 0 ? steps : 0);  // shared regime: each row's block and place
  // the warp's rows: local rows warp, warp + nw, ...
  const int nq = warp < nr ? (nr - warp + nw - 1) / nw : 0;
  auto at = [&](int i, int c) -> T& {
    if constexpr (kShared)
      return slab[i * ld + c];
    else
      return slab[(size_t)i * ld + c];
  };

  if (kShared)
    for (int i = warp; i < nr; i += nw)
      for (int c = lane; c < ncols; c += 32) at(i, c) = gm[(size_t)(r0 + i) * ncols + c];
  for (int i = threadIdx.x; i < nr; i += blockDim.x) rk[i] = steps;
  if (kShared)
    for (int b = 0; b < cs; ++b)
      for (int r = rows_lo(b, cs, m) + (int)threadIdx.x; r < rows_lo(b + 1, cs, m);
           r += blockDim.x)
        own[r] = b << 16 | (r - rows_lo(b, cs, m));

  // the warp's candidate (bv, bi), the same in every lane, into every
  // block's buffer par: lanes < cs store to their peers
  auto push = [&](int par, T bv, int bi) {
    const int slot = par * ncand + me * nw + warp;
    if (cs == 1) {
      if (lane == 0) {
        candv[slot] = bv;
        candi[slot] = bi;
      }
    } else if (lane < cs) {
      st_remote(cluster_addr(candv + slot, lane), bv);
      st_remote(cluster_addr(candi + slot, lane), bi);
    }
  };
  auto barrier = [&]() {
    if (cs > 1)
      cl.sync();
    else
      __syncthreads();
  };

  barrier();  // the slab is in, and every block runs before the first push
  if (steps > 0) {
    T bv = T(0);
    int bi = kNone;
    for (int q = lane; q < nq; q += 32) {
      const int i = warp + nw * q;
      const T av = fabs(at(i, 0));
      const bool take = better(av, r0 + i, bv, bi);
      bv = take ? av : bv;
      bi = take ? r0 + i : bi;
    }
    warp_best(bv, bi);
    push(0, bv, bi);
  }
  barrier();

  for (int j = 0; j < steps; ++j) {
    const int par = j & 1;
    // 1. the pivot, and its row (a NaN candidate: no pivot)
    T pv = T(0);
    int p = kNone;
    for (int q = lane; q < ncand; q += 32) {
      const T v = candv[par * ncand + q];
      const int i = candi[par * ncand + q];
      const bool take = better(v, i, pv, p);
      pv = take ? v : pv;
      p = take ? i : p;
    }
    warp_best(pv, p);
    if (pv != pv) p = kNone;
    const bool has = p < m;
    const T* prw;
    if constexpr (kShared) {
      // where row p lies: own[p] = (block << 16) | its local row
      const int w = has ? own[p] : me << 16;
      T* row = slab + (w & 0xffff) * ld;
      prw = (w >> 16) == me ? row : cl.map_shared_rank(row, w >> 16);
    } else {
      prw = gm + (size_t)(has ? p : 0) * ncols;
    }
    auto ldp = [&](int c) -> T {
      if constexpr (kShared)
        return prw[c];
      else
        return __ldcg(prw + c);  // a peer's row, written since this SM last read it
    };
    const T piv = has ? ldp(j) : T(0);
    const T safe = piv == T(0) ? T(1) : piv;

    // 2. lanes over the warp's rows: mark the pivot's, divide the live
    // rows' entries of column j into their multipliers and list both
    int cnt = 0;
    for (int q0 = 0; q0 < nq; q0 += 32) {
      const int q = q0 + lane;
      const int i = warp + nw * q;
      bool live = false;
      if (q < nq) {
        if (r0 + i == p)
          rk[i] = j;
        else
          live = rk[i] == steps;
      }
      const unsigned mask = __ballot_sync(kFull, live);
      if (live) {
        const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
        const T lq_i = at(i, j) / safe;
        at(i, j) = lq_i;
        lst[pos] = i;
        lm[pos] = lq_i;
      }
      cnt += __popc(mask);
    }
    __syncwarp();

    // 3. the update of the listed rows, lanes owning the columns
    // cb + lane + 32·t of each block of 32·kChunks (immediate offsets, one
    // predicate a chunk), kQuad rows at a time with their loads issued
    // together
    for (int cb = (j + 1) / (32 * kChunks) * (32 * kChunks); cb < ncols;
         cb += 32 * kChunks) {
      const int tmin = cb > j ? 0 : (j + 1 - cb) / 32;  // chunks all done
      T u[kChunks];
      bool go[kChunks];
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const int c = cb + 32 * t + lane;
        go[t] = t >= tmin && c > j && c < ncols;
        u[t] = has && go[t] ? ldp(c) : T(0);
      }
      for (int t0 = 0; t0 < cnt; t0 += kQuad) {
        T* rw[kQuad];  // the rows at column cb + lane
        T l[kQuad];
#pragma unroll
        for (int r = 0; r < kQuad; ++r) {
          const bool ok = t0 + r < cnt;
          rw[r] = &at(ok ? lst[t0 + r] : lst[t0], cb + lane);
          l[r] = ok ? lm[t0 + r] : T(0);
        }
        const int nr8 = min(kQuad, cnt - t0);
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          if (t < tmin) continue;
          T v[kQuad];
#pragma unroll
          for (int r = 0; r < kQuad; ++r) v[r] = go[t] && r < nr8 ? rw[r][32 * t] : T(0);
#pragma unroll
          for (int r = 0; r < kQuad; ++r) {
            v[r] = v[r] - mul_rn(u[t], l[r]);
            if (go[t] && r < nr8) rw[r][32 * t] = v[r];
          }
        }
      }
    }
    __syncwarp();
    // 4. the next pivot's candidate, from the update just made: the warp's
    // best new |value| of column j + 1 (lanes over its listed rows) into
    // every block's double buffer; one barrier ends the step
    if (j + 1 < steps) {
      T cv = T(0);
      int ci = kNone;
      for (int t = lane; t < cnt; t += 32) {
        const int i = lst[t];
        const T av = fabs(at(i, j + 1));
        const bool take = better(av, r0 + i, cv, ci);
        cv = take ? av : cv;
        ci = take ? r0 + i : ci;
      }
      warp_best(cv, ci);
      push(par ^ 1, cv, ci);
    }
    if (k > 0 && threadIdx.x == 0) prow[j] = has ? p : -1;
    barrier();
  }


  if (k == 0) {
    if (kShared) {
      for (int i = warp; i < nr; i += nw)
        for (int c = lane; c < ncols; c += 32) gm[(size_t)(r0 + i) * ncols + c] = at(i, c);
      for (int i = threadIdx.x; i < nr; i += blockDim.x) rank[r0 + i] = rk[i];
    }
    return;
  }
  // U·x = z, one warp a right-hand side, lanes over the steps i < j: row i
  // of U and z_i in row prow[i]; x_j = z_j / U_jj, then z_i -= U_ij·x_j (a
  // zero pivot gives inf/nan; a step without pivot 0/0)
  const int n = steps;
  x += mat * (size_t)n * k;
  for (int kk = warp; kk < k; kk += nw) {
    for (int jj = n - 1; jj >= 0; --jj) {
      const int pr = prow[jj];
      const T d = pr >= 0 ? at(pr, jj) : T(0);
      const T z = pr >= 0 ? at(pr, n + kk) : T(0);
      const T xj = z / d;
      if (lane == 0) x[(size_t)jj * k + kk] = xj;
      for (int i = lane; i < jj; i += 32) {
        const int ri = prow[i];
        if (ri >= 0) at(ri, n + kk) = at(ri, n + kk) - mul_rn(at(ri, jj), xj);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------- lu_gesv_regs

// One step's update of a warp's columns in registers: the pivot row's entry
// of each live column from lane pl's row slot PS (PS = kRegRows: no pivot,
// the entries are 0), subtracted times each row's multiplier (0 on the rows
// already pivot, whose entries are U's and were stored at their step: they
// need no mask); the pivot row's entries are U's row j (or z_j), stored;
// the warp that holds column j + 1 stashes it and, right after the group
// that holds it, calls after() (the next pivot) before its other groups.
template <int PS, typename After>
__device__ __forceinline__ void regs_update(float (&a)[kRegCols][kRegRows],
                                            const float (&l)[kRegRows], int pl, int j, int n,
                                            int ncols, int warp, int lane, float* stash,
                                            bool stashes, float* up, float* zs, After after) {
  bool first = stashes;  // the warp of column j + 1: its first live group holds it
  // slots in groups of kRegGroup: one warp-uniform branch a group skips the
  // groups whose columns are all done. Inside a group there is no branch:
  // every slot is updated, for a column already done or past ncols holds
  // nothing that is read again, so that the group's shuffles and products
  // overlap
#pragma unroll
  for (int s0 = 0; s0 < kRegCols; s0 += kRegGroup) {
    if (warp + kRegWarps * (s0 + kRegGroup - 1) <= j || warp + kRegWarps * s0 >= ncols)
      continue;
    constexpr int kG = kRegGroup;
    float u[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g)
      u[g] = PS < kRegRows && s0 + g < kRegCols
                 ? __shfl_sync(kFull, a[s0 + g < kRegCols ? s0 + g : 0][PS < kRegRows ? PS : 0],
                               pl)
                 : 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (s0 + g < kRegCols)
#pragma unroll
        for (int i = 0; i < kRegRows; ++i)
          a[s0 + g][i] = a[s0 + g][i] - __fmul_rn(u[g], l[i]);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (s0 + g >= kRegCols) continue;
      const int c = warp + kRegWarps * (s0 + g);
      const bool keep = lane == ((s0 + g) & 31) && c > j && c < ncols;
      if (keep && c < n) up[c * (c + 1) / 2 + j] = u[g];
      if (keep && c >= n) zs[(c - n) * n + j] = u[g];
      const bool st = stashes && c == j + 1;
#pragma unroll
      for (int i = 0; i < kRegRows; ++i)
        if (st) stash[lane + 32 * i] = a[s0 + g][i];
    }
    if (first) {  // the next pivot, before this warp's other columns
      first = false;
      after();
    }
  }
}

// lu_gesv of one float32 system (n <= 128, n + k <= 136) a block of
// kRegWarps warps, a and y read as they are (no [A | y] copy).
__global__ void __launch_bounds__(kRegWarps * 32, kRegBlocks)
lu_gesv_regs(const float* __restrict__ A, const float* __restrict__ Y, float* __restrict__ X,
             int n, int k) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ncols = n + k;
  const int warp = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const size_t sys = blockIdx.x;
  A += sys * n * n;
  Y += sys * n * k;
  X += sys * n * k;
  const int ld = ncols | 1;  // the staging tile's stride: odd, so no bank conflicts
  const size_t tri = (size_t)n * (n + 1) / 2, tile = (size_t)32 * ld;
  T* up = reinterpret_cast<T*>(smem_raw);  // U's column j at up + j(j+1)/2
  T* zs = up + ((tri > tile ? tri : tile) + 3) / 4 * 4;  // z_j of rhs kk at kk·n + j
  T* lbuf = zs + (size_t)n * k;        // 2 × 128 multipliers
  T* stash = lbuf + 2 * 32 * kRegRows;  // 128: column j + 1
  int* pbuf = reinterpret_cast<int*>(stash + 32 * kRegRows);  // 2 pivots

  // [A | y] into registers, 32 rows at a time through the tile
  T a[kRegCols][kRegRows];
#pragma unroll
  for (int rg = 0; rg < kRegRows; ++rg) {
    __syncthreads();
    for (int r = warp; r < 32; r += kRegWarps) {
      const int row = 32 * rg + r;
      for (int c = lane; c < ncols; c += 32)
        up[r * ld + c] = row < n ? (c < n ? A[(size_t)row * n + c] : Y[(size_t)row * k + c - n])
                                 : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kRegCols; ++s) {
      const int c = warp + kRegWarps * s;
      a[s][rg] = c < ncols ? up[lane * ld + c] : T(0);
    }
  }
  unsigned live = 0;  // bit i: row lane + 32·i not yet pivot
#pragma unroll
  for (int i = 0; i < kRegRows; ++i)
    if (lane + 32 * i < n) live |= 1u << i;
  __syncthreads();  // the tile is read: up is U's from here
  // a step without pivot (a NaN candidate) stores no row: z_j = 0 there
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) zs[i] = T(0);

  // the pivot of column jn (stashed, rows as the lanes hold them), its
  // multipliers into buffer jn & 1, and U's diagonal entry jn
  auto pivot = [&](int jn) {
    const int par = jn & 1;
    T v[kRegRows];
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) v[i] = stash[lane + 32 * i];
    T bv = T(0);
    int bi = kNone;
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const bool take = (live >> i & 1u) & better(fabsf(v[i]), lane + 32 * i, bv, bi);
      bv = take ? fabsf(v[i]) : bv;
      bi = take ? lane + 32 * i : bi;
    }
    warp_best(bv, bi);
    if (bv != bv || bi >= n) bi = n;
    const int pn = bi;
    const bool has = pn < n;
    const int ps = pn >> 5;
    T pv = ps == 0 ? v[0] : ps == 1 ? v[1] : ps == 2 ? v[2] : v[3];
    pv = __shfl_sync(kFull, pv, pn & 31);
    const T piv = has ? pv : T(0);
    const T safe = piv == T(0) ? T(1) : piv;
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int row = lane + 32 * i;
      lbuf[par * 32 * kRegRows + row] = (live >> i & 1u) && row != pn ? v[i] / safe : T(0);
    }
    if (lane == 0) {
      pbuf[par] = pn;
      up[jn * (jn + 1) / 2 + jn] = piv;  // 0 without pivot: x_jn = 0/0
    }
  };

  // Steps hand on through named barriers, not a block barrier: step j's
  // multipliers are published when kReady + (j & 1) completes (their
  // producer, the warp of column j, arrives; every other warp waits), and
  // read by every warp when kTaken + (j & 1) completes (all arrive but the
  // producer of step j + 2, which rewrites the buffer and waits). So a warp
  // that has published the next pivot goes on with its other columns while
  // the others start the next step: the chain a step is one column's
  // update and the pivot's search, not a whole warp's update.
  constexpr int kReady = 1, kTaken = 3;
  constexpr int kThreads = kRegWarps * 32;
  auto bar_sync = [](int id) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
  };
  auto bar_arrive = [](int id) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
  };
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) stash[lane + 32 * i] = a[0][i];
    pivot(0);
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const int par = j & 1;
    if (j > 0 && warp != j % kRegWarps) bar_sync(kReady + par);
    const int p = pbuf[par];
    T l[kRegRows];
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) l[i] = lbuf[par * 32 * kRegRows + lane + 32 * i];
    if (j + 2 < n && warp != (j + 2) % kRegWarps) bar_arrive(kTaken + par);
    const bool has = p < n;
    if (has && lane == (p & 31)) live &= ~(1u << (p >> 5));
    const bool stashes = j + 1 < n && warp == (j + 1) % kRegWarps;
    const int pl = p & 31;
    auto next = [&]() {
      if (j >= 1) bar_sync(kTaken + (par ^ 1));  // every warp has read step j - 1
      pivot(j + 1);
      bar_arrive(kReady + (par ^ 1));
    };
    // the pivot row's slot is named at compile time in each case
    auto update = [&](auto ps) {
      regs_update<decltype(ps)::value>(a, l, pl, j, n, ncols, warp, lane, stash, stashes, up,
                                       zs, next);
    };
    switch (has ? p >> 5 : kRegRows) {
      case 0: update(std::integral_constant<int, 0>()); break;
      case 1: update(std::integral_constant<int, 1>()); break;
      case 2: update(std::integral_constant<int, 2>()); break;
      case 3: update(std::integral_constant<int, 3>()); break;
      default: update(std::integral_constant<int, kRegRows>());
    }
  }
  __syncthreads();

  // U·x = z: one warp a right-hand side, lanes over the steps, running sums
  // in registers
  for (int kk = warp; kk < k; kk += kRegWarps) {
    T z[kRegRows];
#pragma unroll
    for (int t = 0; t < kRegRows; ++t) {
      const int i = lane + 32 * t;
      z[t] = i < n ? zs[(size_t)kk * n + i] : T(0);
    }
    for (int jj = n - 1; jj >= 0; --jj) {
      const T* ucol = up + (size_t)jj * (jj + 1) / 2;
      const int ts = jj >> 5;
      const T zj = ts == 0 ? z[0] : ts == 1 ? z[1] : ts == 2 ? z[2] : z[3];
      // a zero pivot gives inf/nan, a step without pivot 0/0
      const T xj = __shfl_sync(kFull, zj, jj & 31) / ucol[jj];
      if (lane == (jj & 31)) X[(size_t)jj * k + kk] = xj;
#pragma unroll
      for (int t = 0; t < kRegRows; ++t) {
        const int i = lane + 32 * t;
        if (i < jj) z[t] = z[t] - __fmul_rn(ucol[i], xj);
      }
    }
  }
}

// ------------------------------------------------------------- launches

// lu_elim on clusters of `cluster` blocks of `threads` threads, the rows in
// shared memory or in global memory, `smem` bytes a block, as the wrapper's
// plan computed them (checked against this file's layout).
template <typename T>
int launch_elim(T* g, int* rank, T* x, int nb, int m, int ncols, int steps, int k,
                int cluster, int threads, int shared, int smem, void* stream) {
  if (m >= (1 << 26) || cluster < 1 || cluster > kMaxCluster || cluster > m || threads < 32 ||
      threads > kMaxThreads || threads % 32 || (k > 0 && cluster != 1))
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      elim_bytes(m, ncols, steps, cluster, threads / 32, shared != 0, k > 0, sizeof(T));
  if (bytes != (size_t)smem || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (shared)
    return nd4js::launch_clusters(lu_elim<T, true>, nb * cluster, threads, cluster, bytes,
                                  stream, g, rank, x, m, ncols, steps, k);
  return nd4js::launch_clusters(lu_elim<T, false>, nb * cluster, threads, cluster, bytes,
                                stream, g, rank, x, m, ncols, steps, k);
}

template <typename T>
int launch_panel(T* out, int* rank, int nb, int m, int b, int cluster, int threads,
                 int shared, int smem, void* stream) {
  if (m < b || b < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0 || m == 0) return (int)cudaSuccess;
  return launch_elim<T>(out, rank, (T*)nullptr, nb, m, b, b, 0, cluster, threads, shared, smem,
                        stream);
}

// layout 0: registers (float32 only; a and y read in place); 1: lu_elim in
// shared memory and 2: in global memory, on buf = [A | y] (and, in global
// memory, work: the rows' steps).
template <typename T>
int launch_gesv(const T* a, const T* y, T* buf, int* work, T* x, int nb, int n, int k,
                int layout, int threads, int smem, void* stream) {
  if (n < 0 || k < 0 || layout < 0 || layout > 2) return (int)cudaErrorInvalidValue;
  if (nb == 0 || n == 0 || k == 0) return (int)cudaSuccess;
  if (layout == 0) {
    if constexpr (sizeof(T) != sizeof(float)) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (n > 32 * kRegRows || n + k > kRegWarps * kRegCols || threads != 32 * kRegWarps ||
          (size_t)smem != regs_bytes(n, k))
        return (int)cudaErrorInvalidValue;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lu_gesv_regs, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
      }
      lu_gesv_regs<<<nb, threads, smem, (cudaStream_t)stream>>>(a, y, x, n, k);
      return (int)cudaGetLastError();
    }
  }
  if (buf == nullptr || (layout == 2 && work == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_elim<T>(buf, work, x, nb, n, n + k, n, k, 1, threads, layout == 1, smem, stream);
}

template <typename T>
int clusters_of(int shared, int csize, int threads, int smem, int* clusters) {
  return shared ? nd4js::active_clusters(lu_elim<T, true>, threads, csize, (size_t)smem, clusters)
                : nd4js::active_clusters(lu_elim<T, false>, threads, csize, (size_t)smem,
                                         clusters);
}

}  // namespace

extern "C" {

// Clusters of an lu_panel launch the card holds at once (its waves:
// ceil(nb / that)), or a negative CUDA error.
int nd4js_lu_panel_clusters(int f64, int shared, int csize, int threads, int smem) {
  int clusters = 0;
  const int rc = f64 ? clusters_of<double>(shared, csize, threads, smem, &clusters)
                     : clusters_of<float>(shared, csize, threads, smem, &clusters);
  return rc != 0 ? -rc : clusters;
}

int nd4js_lu_panel_f32(float* out, int* rank, int nb, int m, int b, int cluster, int threads,
                       int shared, int smem, void* stream) {
  return launch_panel<float>(out, rank, nb, m, b, cluster, threads, shared, smem, stream);
}

int nd4js_lu_panel_f64(double* out, int* rank, int nb, int m, int b, int cluster, int threads,
                       int shared, int smem, void* stream) {
  return launch_panel<double>(out, rank, nb, m, b, cluster, threads, shared, smem, stream);
}

int nd4js_lu_gesv_f32(const float* a, const float* y, float* buf, int* work, float* x, int nb,
                      int n, int k, int layout, int threads, int smem, void* stream) {
  return launch_gesv<float>(a, y, buf, work, x, nb, n, k, layout, threads, smem, stream);
}

int nd4js_lu_gesv_f64(const double* a, const double* y, double* buf, int* work, double* x,
                      int nb, int n, int k, int layout, int threads, int smem, void* stream) {
  return launch_gesv<double>(a, y, buf, work, x, nb, n, k, layout, threads, smem, stream);
}

}  // extern "C"

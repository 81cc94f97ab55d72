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
// Full precision: FP32/FP64 FMA, no TF32, no library call.
//
// Bound on the H100: operations. At (1, 1024, 64) in f32 a panel moves about
// 8.2 MB (C in, the trailing block out, V and W) but does about 0.27 GFLOP:
// 64 matrix-vector products with C (0.13 GFLOP), the update of the upper
// triangle of the trailing block (0.12 GFLOP) and the latrd corrections,
// about 4 µs at 67 TFLOP/s against 2.5 µs for the bytes. The column loop is
// far from that: its 64 steps are dependent, each a product with all of C.
//
// What held the first version back (NVIDIA H100 80GB HBM3, 700 W):
// one block of 1024 threads per matrix ran the column loop, so at Nb = 1 it
// used 1 of the 132 SMs, and every step read all of C (4 MB at 1024² f32)
// from L2 through that SM and the V and W rows three more times from global
// memory: 3.0660 ms a panel at (1, 1024, 1024), 48 µs a step, about
// 90 GB/s; 1.6861 ms at (32, 512, 512), on 32 SMs.
//
// Design: one thread-block cluster of CS blocks (1 to 16, the wrapper's
// plan) per matrix. Block b owns a slab of `rows` consecutive rows of C,
// which by symmetry are also its columns, and keeps them for the whole panel
// in its shared memory: columns lsplit..m−1 of its rows (ncs of them, as many
// as fit), the columns below lsplit read from L2 once a step (those are also
// the columns the loop stops reading first). Its rows of V and W stay in its
// shared memory too (k-major, an odd leading dimension).
//
// A step takes two cluster barriers, and no block reads a peer's shared
// memory: what a peer needs is pushed into the peer's shared memory by
// remote stores before the barrier that publishes it, so that after each
// barrier every read is local (a first version that pulled them with
// remote loads after each of three barriers a step spent more time on
// those loads than on the product with C).
//   1. Each block finishes W's column j − 1 on its rows (w − ½τ(wᵀv)·v),
//      forms its rows of column j of C − V·Wᵀ − W·Vᵀ (from the pivot row j
//      of V and W, pushed by its owner) and pushes them into every block's
//      copy of the column, with its partial σ and its partial Wᵀx and Vᵀx,
//      x the column below the subdiagonal; the owner of row j + 1 pushes
//      that row of V and W, the next step's pivot row. Barrier.
//   2. Every block sums the partial σ in rank order (so every block gets the
//      same bits), builds the reflector from x0 = col[j + 1], turns its
//      copy of the column into v = x/den + e_{j+1}, and forms
//      Wᵀv = (Wᵀx)/den + W[j + 1] (and Vᵀv) from the pushed partials; then
//      its rows of w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)) (a warp a pair of rows,
//      lanes along the row) and its partial wᵀv, pushed to every block,
//      with w[j + 1] from its owner. Barrier.
// Since v[j + 1] = 1, W[j + 1][j] = w[j + 1] − ½τ(wᵀv) needs no barrier of
// its own. Wᵀv formed as (Wᵀx)/den rounds differently from the plain
// version's Wᵀ(x/den), by about what a last-bit change of C would move it.
// The column j of C for the next step is loaded into a register before
// the product and stored after it, off the step's chain (a slab of more
// rows than threads loads its further rows at the start of the step, in
// an instance of its own).
// The rank-2b update of the trailing block is a second launch over many
// blocks, one 32×32 tile of the upper triangle each, with the tile's slices
// of V and W in shared memory; a tile is mirrored through shared memory so
// both writes are contiguous. `stages` runs the column loop (1), the update
// (2, on the V and W of an earlier launch) or both (3), to time them apart.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxBk = 64;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kRed = 32;             // the block sum's scratch: a value a warp
constexpr int kTile = 32;
constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum

// Offsets, in elements, of the shared-memory regions of one block of the
// column loop; nd4js_tpu_torch/ops/sytrd_panel.py::smem_elements mirrors the
// total, m + rows·ncs + 2·bk·(rows | 1) + 3·rows + 8·bk + 1
// + cs·(2·bk + 2) + 1 + kRed. The column and C's rows come first, so that
// both are 16-byte aligned where m and ncs are multiples of 16 bytes.
struct Layout {
  int ldr;  // leading dimension of a row of V or W over the slab's rows
  size_t vx, cs, vt, wt, cnext, vloc, wloc, vp, wp, pw, pv, mine, parts, wvs, wpre, red, total;
};

__host__ __device__ inline Layout layout(int m, int bk, int rows, int ncs, int csize) {
  Layout L;
  size_t o = 0;
  L.ldr = rows | 1;
  L.vx = o;     // column j of the whole matrix (pushed), then v in place
  o += m;
  L.cs = o;     // C: the slab's rows, columns lsplit..m−1
  o += (size_t)rows * ncs;
  L.vt = o;     // V: bk rows over the slab's rows
  o += (size_t)bk * L.ldr;
  L.wt = o;     // W, the same
  o += (size_t)bk * L.ldr;
  L.cnext = o;  // C's column j of the slab's rows
  o += rows;
  L.vloc = o;   // the slab's v and w
  o += rows;
  L.wloc = o;
  o += rows;
  L.vp = o;     // the pivot rows of V and W, by the step's parity (pushed)
  o += 2 * bk;
  L.wp = o;
  o += 2 * bk;
  L.pw = o;     // Wᵀv and Vᵀv over the cluster
  o += bk;
  L.pv = o;
  o += bk;
  L.mine = o;   // this block's partial Wᵀx, Vᵀx and σ, before the push
  o += 2 * bk + 1;
  L.parts = o;  // each rank's partial Wᵀx, Vᵀx and σ (pushed)
  o += (size_t)csize * (2 * bk + 1);
  L.wvs = o;    // each rank's partial wᵀv (pushed)
  o += csize;
  L.wpre = o;   // w[j + 1] before its correction (pushed)
  o += 1;
  L.red = o;
  o += kRed;
  L.total = o;
  return L;
}

// Sum over the warp; every lane gets the same bits (a butterfly adds each
// pair in both lanes, and addition commutes).
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the block, the same bits in every thread, with one
// __syncthreads(); `red` must not be in use by an earlier call (a barrier
// lies between any two calls here).
template <typename T>
__device__ __forceinline__ T block_allsum(T x, T* red) {
  const int lane = threadIdx.x & 31;
  x = warp_sum(x);
  if (lane == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : T(0));
}

// Sum of vals[b·stride] over the cluster's cs ranks, in every thread; the
// same tree in every warp of every block, so the same bits everywhere.
template <typename T>
__device__ __forceinline__ T rank_sum(const T* vals, int stride, int cs) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < cs ? vals[(size_t)lane * stride] : T(0));
}

// 16 bytes of T, for the product with C.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float dot(const float4& a, const float4& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double dot(const double2& a, const double2& b) {
    return a.x * b.x + a.y * b.y;
  }
};

// a0 += Σ p0[l]·v[l] and a1 += Σ p1[l]·v[l] over l in [lo, hi), the lanes
// along l: the first lo..(lo rounded up to 16 bytes) one element a lane,
// the rest 16 bytes a lane. hi, and p0, p1 and v at a multiple of 16
// bytes, must be 16-byte aligned; p0 and p1 are read through the
// read-only cache when kGlobal.
template <typename T, bool kGlobal>
__device__ __forceinline__ void dot2(const T* p0, const T* p1, const T* v, int lo, int hi,
                                     int lane, T& a0, T& a1) {
  using V = typename Vec<T>::type;
  constexpr int N = Vec<T>::n;
  const int la = min(hi, (lo + N - 1) / N * N);
  if (lo + lane < la) {
    const int l = lo + lane;
    a0 += (kGlobal ? __ldg(p0 + l) : p0[l]) * v[l];
    a1 += (kGlobal ? __ldg(p1 + l) : p1[l]) * v[l];
  }
#pragma unroll 2
  for (int l = la + lane * N; l < hi; l += 32 * N) {
    const V vv = *reinterpret_cast<const V*>(v + l);
    const V* q0 = reinterpret_cast<const V*>(p0 + l);
    const V* q1 = reinterpret_cast<const V*>(p1 + l);
    a0 += Vec<T>::dot(kGlobal ? __ldg(q0) : *q0, vv);
    a1 += Vec<T>::dot(kGlobal ? __ldg(q1) : *q1, vv);
  }
}

// Store `x` at `p` in the shared memory of rank q (this block's own
// directly).
template <typename T>
__device__ __forceinline__ void push(cg::cluster_group& cl, T* p, int q, int rank, T x) {
  *(q == rank ? p : cl.map_shared_rank(p, q)) = x;
}

// kMany: a slab of more rows than threads (one block a matrix of m > 1024
// rows, say), whose further rows load column j at the start of a step; an
// instance of its own, as that loop costs the common case spills at the
// 64-register cap of 1024 threads.
template <typename T, bool kMany>
__global__ void __launch_bounds__(kMaxThreads, 1)
sytrd_cols_kernel(const T* __restrict__ c, T* vt, T* wt, T* taus, T* d, T* e, int m, int bk,
                  int rows, int ncs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const Layout L = layout(m, bk, rows, ncs, cs);
  T* base = reinterpret_cast<T*>(smem_raw);
  T* Cs = base + L.cs;
  T* Vt = base + L.vt;
  T* Wt = base + L.wt;
  T* vx = base + L.vx;
  T* cnext = base + L.cnext;
  T* vloc = base + L.vloc;
  T* wloc = base + L.wloc;
  T* pw = base + L.pw;
  T* pv = base + L.pv;
  T* mine = base + L.mine;
  T* parts = base + L.parts;
  T* wvs = base + L.wvs;
  T* wpre = base + L.wpre;
  T* red = base + L.red;
  const int ldr = L.ldr;
  const int pstride = 2 * bk + 1;  // one rank's partials: Wᵀx, Vᵀx, σ

  const size_t mat = blockIdx.x / cs;
  const size_t mm = (size_t)m;
  c += mat * mm * mm;
  vt += mat * bk * mm;
  wt += mat * bk * mm;
  taus += mat * bk;
  d += mat * bk;
  e += mat * bk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int r0 = rank * rows;
  const int nrows = max(0, min(rows, m - r0));
  const int lsplit = m - ncs;
  // 16-byte loads in the product with C where every row and the split
  // keep 16-byte alignment
  const bool vec = m % Vec<T>::n == 0 && ncs % Vec<T>::n == 0;

  for (size_t idx = tid; idx < (size_t)nrows * ncs; idx += nt) {
    const int il = (int)(idx / ncs), l = (int)(idx - (size_t)il * ncs);
    Cs[idx] = c[(size_t)(r0 + il) * mm + lsplit + l];
  }
  if constexpr (kMany)
    for (int il = tid; il < nrows; il += nt) cnext[il] = c[(size_t)(r0 + il) * mm];
  else if (tid < nrows)
    cnext[tid] = c[(size_t)(r0 + tid) * mm];
  cl.sync();  // every block of the cluster runs (its shared memory may be
              // written), and its slab is loaded

  T tau = T(0);
  for (int j = 0;; ++j) {
    T* vp = base + L.vp + (j & 1) * bk;  // pivot row j
    T* wp = base + L.wp + (j & 1) * bk;
    if (j > 0) {
      // 1a. finish step j − 1: W's column j − 1 on the slab's rows, and the
      // pivot row's entry j − 1 (v_{j−1}[j] = 1)
      const T corr = T(0.5) * tau * rank_sum(wvs, 1, cs);
      for (int il = tid; il < nrows; il += nt) {
        const T wi = wloc[il] - corr * vloc[il];
        Wt[(size_t)(j - 1) * ldr + il] = wi;
        wt[(size_t)(j - 1) * mm + r0 + il] = wi;
      }
      if (j == bk) break;
      if (tid == 0) {
        vp[j - 1] = T(1);
        wp[j - 1] = *wpre - corr;
      }
      // a slab of more rows than threads: column j of its further rows
      if constexpr (kMany)
        for (int il = tid + nt; il < nrows; il += nt)
          cnext[il] = j >= lsplit ? Cs[(size_t)il * ncs + (j - lsplit)]
                                  : c[(size_t)(r0 + il) * mm + j];
      __syncthreads();
    }
    // 1b. column j of C − V·Wᵀ − W·Vᵀ on the slab's rows j.., a warp a row
    T part = T(0);
    for (int il = warp; il < nrows; il += nwarps) {
      const int i = r0 + il;
      if (i < j) continue;
      T s = T(0);
      for (int k = lane; k < j; k += 32)
        s += Vt[(size_t)k * ldr + il] * wp[k] + Wt[(size_t)k * ldr + il] * vp[k];
      const T x = cnext[il] - warp_sum(s);
      if (lane == 0) {
        vx[i] = x;
        if (i > j + 1) part += x * x;
        if (i == j) d[j] = x;
      }
    }
    const T sig = block_allsum(part, red);  // syncs: the slab's vx is complete
    // 1c. the partial Wᵀx and Vᵀx over the slab's rows below j + 1, eight
    // lanes a sum, and σ into `mine`; the slab's column pushed to every
    // peer, 32 consecutive values a warp's store; the owner of row j + 1
    // pushes its rows of V and W, the next step's pivot row
    {
      const int g = lane >> 3, sub = lane & 7;
      for (int t0 = warp * 4; t0 < 2 * j; t0 += nwarps * 4) {
        const int t = t0 + g, k = t >> 1;
        const T* src = (t & 1) ? Vt : Wt;
        T s = T(0);
        if (t < 2 * j)
          for (int il = sub; il < nrows; il += 8)
            if (r0 + il > j + 1) s += src[(size_t)k * ldr + il] * vx[r0 + il];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if (t < 2 * j && sub == 0) mine[(t & 1) * bk + k] = s;
      }
    }
    if (tid == 0) mine[2 * bk] = sig;
    {
      const int il0 = max(0, j - r0), cnt = nrows - il0;
      for (int idx = tid; idx < cs * cnt; idx += nt) {
        const int q = idx / cnt, i = r0 + il0 + (idx - q * cnt);
        if (q != rank) *cl.map_shared_rank(vx + i, q) = vx[i];
      }
    }
    {
      const int o1 = (j + 1) / rows;
      if (o1 == rank && j > 0) {
        const int jl = j + 1 - r0;
        T* vpn = base + L.vp + ((j + 1) & 1) * bk;
        T* wpn = base + L.wp + ((j + 1) & 1) * bk;
        for (int idx = tid; idx < 2 * j * cs; idx += nt) {
          const int q = idx / (2 * j), r = idx - q * (2 * j), k = r >> 1;
          if (r & 1)
            push(cl, wpn + k, q, rank, Wt[(size_t)k * ldr + jl]);
          else
            push(cl, vpn + k, q, rank, Vt[(size_t)k * ldr + jl]);
        }
      }
    }
    __syncthreads();
    // `mine` into every rank's parts[rank]: Wᵀx at 0..j − 1, Vᵀx at
    // bk..bk + j − 1, σ at 2·bk
    for (int idx = tid; idx < cs * (2 * j + 1); idx += nt) {
      const int q = idx / (2 * j + 1), r = idx - q * (2 * j + 1);
      const int off = r < j ? r : (r < 2 * j ? bk + r - j : 2 * bk);
      push(cl, parts + (size_t)rank * pstride + off, q, rank, mine[off]);
    }
    cl.sync();
    // 2a. the reflector, the same bits in every block
    T cn = T(0);  // the next step's column of C, loaded off the chain
    if (tid < nrows) {
      const int il = tid;
      cn = j + 1 >= lsplit ? Cs[(size_t)il * ncs + (j + 1 - lsplit)]
                           : c[(size_t)(r0 + il) * mm + j + 1];
    }
    const T sigma = rank_sum(parts + 2 * bk, pstride, cs);
    const T x0 = vx[j + 1];
    const T nrm = sqrt(x0 * x0 + sigma);
    T beta = x0 >= T(0) ? -nrm : nrm;
    if (sigma == T(0)) beta = x0;  // no-op reflector
    const T den = x0 - beta;
    const T safe_den = den == T(0) ? T(1) : den;
    const T safe_beta = beta == T(0) ? T(1) : beta;
    tau = sigma == T(0) ? T(0) : (beta - x0) / safe_beta;
    if (rank == 0 && tid == 0) {
      e[j] = beta;
      taus[j] = tau;
    }
    __syncthreads();  // every thread has read x0 = vx[j + 1] before 2b sets it to 1
    // 2b. v in place of the column; Wᵀv and Vᵀv
    for (int l = tid; l < m; l += nt) {
      const T vl = l > j + 1 ? vx[l] / safe_den : (l == j + 1 ? T(1) : T(0));
      vx[l] = vl;
      const int il = l - r0;
      if (il >= 0 && il < nrows) {
        vloc[il] = vl;
        Vt[(size_t)j * ldr + il] = vl;
        vt[(size_t)j * mm + l] = vl;
      }
    }
    {
      T* vpn = base + L.vp + ((j + 1) & 1) * bk;  // pivot row j + 1
      T* wpn = base + L.wp + ((j + 1) & 1) * bk;
      for (int t = tid; t < 2 * j; t += nt) {
        const int k = t >> 1;
        T s = T(0);
        for (int q = 0; q < cs; ++q) s += parts[(size_t)q * pstride + (t & 1) * bk + k];
        if (t & 1)
          pv[k] = s / safe_den + vpn[k];
        else
          pw[k] = s / safe_den + wpn[k];
      }
    }
    __syncthreads();
    // 2c. w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)) on the slab's rows, a warp a pair
    T wv = T(0);
    const int lo = max(j + 1, lsplit);
    for (int il0 = 2 * warp; il0 < nrows; il0 += 2 * nwarps) {
      const int il1 = il0 + 1;
      const bool two = il1 < nrows;
      T a0 = T(0), a1 = T(0);
      // columns j + 1 .. lsplit − 1 from L2, the rest from shared memory
      const T* g0 = c + (size_t)(r0 + il0) * mm;
      const T* g1 = two ? g0 + mm : g0;
      const T* s0 = Cs + (size_t)il0 * ncs - lsplit;
      const T* s1 = two ? s0 + ncs : s0;
      if (vec) {
        dot2<T, true>(g0, g1, vx, j + 1, max(j + 1, lsplit), lane, a0, a1);
        dot2<T, false>(s0, s1, vx, lo, m, lane, a0, a1);
      } else {
#pragma unroll 4
        for (int l = j + 1 + lane; l < lsplit; l += 32) {
          const T vl = vx[l];
          a0 += __ldg(g0 + l) * vl;
          a1 += __ldg(g1 + l) * vl;
        }
#pragma unroll 4
        for (int l = lo + lane; l < m; l += 32) {
          const T vl = vx[l];
          a0 += s0[l] * vl;
          a1 += s1[l] * vl;
        }
      }
      for (int k = lane; k < j; k += 32) {
        const T pwk = pw[k], pvk = pv[k];
        a0 -= Vt[(size_t)k * ldr + il0] * pwk + Wt[(size_t)k * ldr + il0] * pvk;
        a1 -= Vt[(size_t)k * ldr + il1] * pwk + Wt[(size_t)k * ldr + il1] * pvk;
      }
      a0 = warp_sum(a0);
      a1 = warp_sum(a1);
      const T w0 = tau * a0, w1 = tau * a1;
      if (lane == 0) {
        wloc[il0] = w0;
        wv += w0 * vloc[il0];
        if (two) {
          wloc[il1] = w1;
          wv += w1 * vloc[il1];
        }
      }
      // the owner of row j + 1 pushes w[j + 1]
      const int jl = j + 1 - r0;
      if (jl == il0 && lane < cs) push(cl, wpre, lane, rank, w0);
      if (two && jl == il1 && lane < cs) push(cl, wpre, lane, rank, w1);
    }
    if (tid < nrows) cnext[tid] = cn;
    const T wvb = block_allsum(wv, red);
    if (tid < cs) push(cl, wvs + rank, tid, rank, wvb);
    cl.sync();
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

// The column loop on clusters of `csize` blocks of `threads` threads, each
// block `rows` rows of C with `ncs` of its columns in shared memory, and
// `smem` bytes of shared memory a block, as the wrapper's plan computed them
// (checked against this file's layout); then the trailing update.
template <typename T>
int launch(const T* c, T* out, T* vt, T* wt, T* taus, T* d, T* e, int nb, int m, int bk,
           int csize, int threads, int rows, int ncs, int smem, int stages, void* stream) {
  if (nb == 0) return (int)cudaSuccess;
  if (bk < 1 || bk > kMaxBk || bk > m - 1) return (int)cudaErrorInvalidValue;
  if (csize < 1 || csize > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || rows < 1 || (size_t)rows * csize < (size_t)m ||
      ncs < 0 || ncs > m || stages < 1 || stages > 3)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = layout(m, bk, rows, ncs, csize).total * sizeof(T);
  if (bytes != (size_t)smem || bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stages & 1) {
    const int rc =
        rows > threads
            ? nd4js::launch_clusters(sytrd_cols_kernel<T, true>, nb * csize, threads, csize,
                                     bytes, stream, c, vt, wt, taus, d, e, m, bk, rows, ncs)
            : nd4js::launch_clusters(sytrd_cols_kernel<T, false>, nb * csize, threads, csize,
                                     bytes, stream, c, vt, wt, taus, d, e, m, bk, rows, ncs);
    if (rc != 0) return rc;
  }
  if (stages & 2) {
    const int nt = (m - bk + kTile - 1) / kTile;
    sytrd_update_kernel<T><<<dim3(nb, nt, nt), dim3(kTile, kTile), 0, s>>>(c, vt, wt, out, m,
                                                                           bk);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Clusters of the column loop's launch that the card holds at once (its
// waves: ceil(nb / that)), or a negative CUDA error. Both instances take
// the same: one block of `threads` and `smem` bytes an SM.
int nd4js_sytrd_panel_clusters(int f64, int csize, int threads, int smem) {
  int clusters = 0;
  const int rc = f64 ? nd4js::active_clusters(sytrd_cols_kernel<double, false>, threads, csize,
                                              (size_t)smem, &clusters)
                     : nd4js::active_clusters(sytrd_cols_kernel<float, false>, threads, csize,
                                              (size_t)smem, &clusters);
  return rc != 0 ? -rc : clusters;
}

int nd4js_sytrd_panel_f32(const float* c, float* out, float* vt, float* wt, float* taus,
                          float* d, float* e, int nb, int m, int bk, int csize, int threads,
                          int rows, int ncs, int smem, int stages, void* stream) {
  return launch<float>(c, out, vt, wt, taus, d, e, nb, m, bk, csize, threads, rows, ncs, smem,
                       stages, stream);
}

int nd4js_sytrd_panel_f64(const double* c, double* out, double* vt, double* wt,
                          double* taus, double* d, double* e, int nb, int m, int bk, int csize,
                          int threads, int rows, int ncs, int smem, int stages, void* stream) {
  return launch<double>(c, out, vt, wt, taus, d, e, nb, m, bk, csize, threads, rows, ncs, smem,
                        stages, stream);
}

}  // extern "C"

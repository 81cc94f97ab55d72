// trevc_solve: every eigenvector of a batch of split-complex upper triangular
// matrices Tc (Nb, n, n) by backward substitution, (Tc − λ_k)·x_k = 0 with
// x[k, k] = 1 and x[j > k, k] = 0 (LAPACK xTREVC).
//
// Replaces the TPU kernel nd4js_tpu/ops/trevc_solve.py::trevc_solve
// (_trevc_kernel), with the semantics of its XLA form
// (nd4js_tpu/la/schur.py::_trevc_backsub_blocked): for rows i = n−2 … 0,
//   x[i, k] = −(Σ_{j>i} T[i, j]·x[j, k]) / (T[i, i] − λ_k)      (k > i)
// where |T[i, i] − λ_k| ≤ smallnum is clamped to smallnum (a repeated
// eigenvalue then amplifies the earlier eigendirection), the division is
// Smith's, and a column whose new entry exceeds bignum in either part is
// rescaled as a whole by 1/max(|re|, |im|): the rows of its 64-row block
// and its running sums at once, the rows below at the block's end.
//
// Bound on the H100: operations, about n³/6 complex multiply-adds
// (4n³/3 flops) against 16n² bytes; at n = 1024 about 0.021 ms. This
// design's floor is the chain of the rightmost column: n − 1 rows, each a
// Smith quotient, a shuffle and a multiply-add, one after another.
//
// What held the first version back: tiles of 16 columns, so the rightmost
// tile ran 1023 rows while most of the card idled; x in global memory; and
// for every row a full dot product over all the rows below, three block
// barriers and a serial sum of 16 partials.
//
// Design: the TPU kernel's blocked structure, on chip. Column k of x
// depends on no other column (its rescale is its own), so a thread block
// owns a tile of 1-8 adjacent columns (blockIdx.x; ops/trevc_solve.py::plan
// gives each tile's first column and width: uniform tiles of 4, the fastest
// tiling timed at n = 1024, the rightmost, whose chain is n rows long,
// first) and keeps x of its tile in shared memory, column by column, rows
// 0 … its last column; only the result is written out. It walks the
// reference's row blocks [b0, b1) of 64, bottom-up from the first that
// holds a row above its last column. Per row block:
//  1. the contraction below the block, acc = T[b0:b1, b1:kmax+1]·x[b1:,
//     tile], by all 256 threads: each warp owns 8 of the block's rows, its
//     lanes walk the columns 16 bytes of a row at a time, straight from
//     global memory (coalesced, read-only, no staging and no barrier),
//     every tile column at once (the width a template argument); the
//     lanes' sums meet by shuffles. Meanwhile the block's 64×64 diagonal
//     block arrives in shared memory by cp.async;
//  2. the in-block recurrence: warp c solves column c on its own, lanes
//     holding rows l and l + 32 of the block and their running sums. The
//     Smith divisor of each row and its IEEE reciprocal are formed before
//     the loop; a row is then the owner lane's numerator, its quotient by
//     the reciprocal and one correcting FMA (Markstein: the IEEE quotient
//     bit for bit while the operands lie within [2^-30, 2^30] in float32
//     and [2^-300, 2^300] in float64, else a division), a shuffle, and the
//     rank-1 update of the rows above by T[rows, i]·x_i: no block barrier,
//     no dot product, no serial reduction. The rare cases (an operand out
//     of range, growth past bignum) are warp votes, so the common path
//     holds no divergent branch;
//  3. the rows below the block of each rescaled column take the product
//     of its factors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNT = 256;         // threads a block
constexpr int kNB = 64;          // rows a block of the recurrence (the reference's nbk)
constexpr int kWMax = 8;         // columns a tile: one warp each
constexpr int kRowsWarp = kNB / (kNT / 32);   // rows of the contraction a warp owns
constexpr int kLdD = kNB + 1;    // row stride of the diagonal block
constexpr unsigned kFull = 0xffffffffu;

static_assert(kNT == kWMax * 32, "one warp a tile column");

template <typename T>
__device__ __forceinline__ T hypot_t(T a, T b);
template <>
__device__ __forceinline__ float hypot_t<float>(float a, float b) { return hypotf(a, b); }
template <>
__device__ __forceinline__ double hypot_t<double>(double a, double b) { return hypot(a, b); }

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"((int)sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The Smith divisor of one pivot b, as core/cpx.py div: z = a / b is
// (ar + ai·r, ai − ar·r) / den when |br| >= |bi|, else (ar·r + ai,
// ai·r − ar) / den, r and den as below. The two branches are taken by
// selecting operands, not by jumping: the same products and sums.
template <typename T>
struct Smith {
  T r, den;
  bool use_r;
};

template <typename T>
__device__ __forceinline__ Smith<T> smith_of(T br, T bi) {
  Smith<T> s;
  s.use_r = fabs(br) >= fabs(bi);
  const T num = s.use_r ? bi : br, piv = s.use_r ? br : bi, oth = s.use_r ? bi : br;
  s.r = num / (piv == T(0) ? T(1) : piv);
  s.den = piv + oth * s.r;
  if (s.den == T(0)) s.den = T(1);
  return s;
}

// a / d rounded to nearest from rd = RN(1/d): q = RN(a·rd), the remainder
// a − d·q is exact (one FMA), and RN(q + rem·rd) is RN(a / d) (Markstein's
// theorem) while the quotient is normal and the remainder representable,
// which |a| and |d| within [lo, hi] ensure; outside it the division is
// taken as such. Either way the quotient is the IEEE one, bit for bit.
template <typename T>
struct Range;
template <>
struct Range<float> {
  static constexpr float lo = 0x1p-30f, hi = 0x1p30f;
};
template <>
struct Range<double> {
  static constexpr double lo = 0x1p-300, hi = 0x1p300;
};

template <typename T>
__device__ __forceinline__ bool in_range(T x) {
  const T a = fabs(x);
  return a >= Range<T>::lo && a <= Range<T>::hi;
}

template <typename T>
__device__ __forceinline__ T rcp_rn(T d);
template <>
__device__ __forceinline__ float rcp_rn<float>(float d) { return __frcp_rn(d); }
template <>
__device__ __forceinline__ double rcp_rn<double>(double d) { return __drcp_rn(d); }

// The Smith numerator of (ar, ai) by a pivot with divisor terms s:
// use_r: (ai·r + ar, (−ar)·r + ai); else: (ar·r + ai, ai·r + (−ar)).
template <typename T>
__device__ __forceinline__ void smith_num(T ar, T ai, const Smith<T>& s, T* nr, T* ni) {
  const T p = s.use_r ? ai : ar, q = s.use_r ? ar : ai;
  const T u = s.use_r ? -ar : ai, v = s.use_r ? ai : -ar;
  *nr = fma(p, s.r, q);
  *ni = fma(u, s.r, v);
}

// n / den from rd = RN(1/den), when den (rd != 0) and n are in range
template <typename T>
__device__ __forceinline__ T quotient(T n, T den, T rd) {
  const T q = n * rd;
  return fma(fma(-den, q, n), rd, q);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
struct Smem {
  T *dre, *dim;       // the diagonal block T[b0:b1, b0:b1], rows of kLdD
  T *red_r, *red_i;   // the sums below the block, kNB rows of w + 1
  T *xre, *xim;       // x of the tile by column: column q at q·rows
  int rows;           // kmax + 1
};

// T[b0 + r, b0 + c] for r <= c < nb: the diagonal block's upper triangle
template <typename T>
__device__ __forceinline__ void load_diag(const Smem<T>& sm, const T* tre, const T* tim,
                                           int n, int b0, int nb) {
  for (int e = threadIdx.x; e < kNB * kNB; e += kNT) {
    const int r = e / kNB, c = e % kNB;
    if (c < nb && r <= c) {
      const size_t a = (size_t)(b0 + r) * n + b0 + c;
      cp_async(sm.dre + r * kLdD + c, tre + a);
      cp_async(sm.dim + r * kLdD + c, tim + a);
    }
  }
  cp_commit();
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// The contraction below the block, acc = T[b0:b1, b1:kmax+1]·x[b1:kmax+1,
// tile], into red: warp v owns rows 8v … 8v + 7 of the block (RP at a
// time). Its lanes walk the columns 16 bytes of a row at a time (vec: n and
// the pointers allow it; the range's two edges masked), 32 lanes a 512-byte
// stretch, reading T straight from global memory (read-only) and x of the
// tile from shared memory; the lanes' sums then meet by shuffles, in a
// fixed order.
template <int WT, typename T>
__device__ __forceinline__ void contract(const Smem<T>& sm, const T* __restrict__ tre,
                                         const T* __restrict__ tim, int n, int b0, int nb,
                                         int b1, int kmax, int lane, int warp, bool vec) {
  using V = typename Vec<T>::type;
  constexpr int NV = sizeof(V) / sizeof(T);
  // rows a pass: at most 16 sums (both parts) a lane, so that two blocks
  // fit an SM's registers
  constexpr int RP = WT <= 4 ? 4 : 2;
  const int ldr = WT + 1;
  for (int p0 = 0; p0 < kRowsWarp; p0 += RP) {
    const int r0 = warp * kRowsWarp + p0;
    if (r0 >= nb) break;
    T ar[RP][WT], ai[RP][WT];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int q = 0; q < WT; ++q) ar[i][q] = ai[i][q] = T(0);
    const T* rr = tre + (size_t)(b0 + r0) * n;
    const T* ri = tim + (size_t)(b0 + r0) * n;
    const int step = vec ? NV : 1;
    for (int j = (vec ? b1 & ~(NV - 1) : b1) + lane * step; j <= kmax; j += 32 * step) {
      // T[row, j … j + step − 1] of the RP rows, zero outside [b1, kmax]
      T a[RP][NV], b[RP][NV];
      const bool whole = vec && j >= b1 && j + NV - 1 <= kmax;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        if (whole && r0 + i < nb) {
          const V va = __ldg(reinterpret_cast<const V*>(rr + (size_t)i * n + j));
          const V vb = __ldg(reinterpret_cast<const V*>(ri + (size_t)i * n + j));
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            a[i][e] = reinterpret_cast<const T*>(&va)[e];
            b[i][e] = reinterpret_cast<const T*>(&vb)[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            const bool in = r0 + i < nb && e < step && j + e >= b1 && j + e <= kmax;
            a[i][e] = in ? __ldg(rr + (size_t)i * n + j + e) : T(0);
            b[i][e] = in ? __ldg(ri + (size_t)i * n + j + e) : T(0);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int jx = min(j + e, kmax);   // x inside the tile; its weight is 0 past kmax
#pragma unroll
        for (int q = 0; q < WT; ++q) {
          const T xr = sm.xre[q * sm.rows + jx], xi = sm.xim[q * sm.rows + jx];
#pragma unroll
          for (int i = 0; i < RP; ++i) {
            ar[i][q] = fma(a[i][e], xr, fma(-b[i][e], xi, ar[i][q]));
            ai[i][q] = fma(a[i][e], xi, fma(b[i][e], xr, ai[i][q]));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int q = 0; q < WT; ++q) {
        const T sr = warp_sum(ar[i][q]), si = warp_sum(ai[i][q]);
        if (lane == 0 && r0 + i < nb) {
          sm.red_r[(r0 + i) * ldr + q] = sr;
          sm.red_i[(r0 + i) * ldr + q] = si;
        }
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kNT, 2)
trevc_kernel(const T* __restrict__ tre, const T* __restrict__ tim,
             const T* __restrict__ lre, const T* __restrict__ lim,
             const T* __restrict__ small, const int* __restrict__ tiles,
             T* __restrict__ xre, T* __restrict__ xim, int n, T bignum, int stages,
             bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k0 = tiles[2 * blockIdx.x], w = tiles[2 * blockIdx.x + 1];
  const int kmax = k0 + w - 1;
  const int ldr = w + 1;
  Smem<T> sm;
  sm.dre = reinterpret_cast<T*>(smem_raw);
  sm.dim = sm.dre + kNB * kLdD;
  sm.red_r = sm.dim + kNB * kLdD;
  sm.red_i = sm.red_r + kNB * ldr;
  sm.xre = sm.red_i + kNB * ldr;
  sm.rows = kmax + 1;
  sm.xim = sm.xre + sm.rows * w;

  const size_t mo = (size_t)blockIdx.y * n * n;
  tre += mo;
  tim += mo;
  xre += mo;
  xim += mo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // recurrence: warp c solves column k (c < w)
  const int c = warp, k = k0 + c;
  const T lam_r = c < w ? lre[(size_t)blockIdx.y * n + k] : T(0);
  const T lam_i = c < w ? lim[(size_t)blockIdx.y * n + k] : T(0);
  const T smallnum = small[blockIdx.y];

  for (int e = tid; e < sm.rows * w; e += kNT) {
    const int q = e / sm.rows;
    sm.xre[e] = e - q * sm.rows == k0 + q ? T(1) : T(0);
    sm.xim[e] = T(0);
  }
  __syncthreads();

  // the row blocks [b0, b1) of the reference, from the first that holds a
  // row above kmax (b0 < kmax); column 0 alone has no rows to solve
  for (int b1 = kmax == 0 ? 0 : n - 1 - kNB * ((n - 1 - kmax) / kNB); b1 > 0; b1 -= kNB) {
    const int b0 = max(0, b1 - kNB), nb = b1 - b0;
    load_diag(sm, tre, tim, n, b0, nb);

    // 1. the sums below the block
    if (stages & 1) {
      switch (w) {
        case 1: contract<1>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 2: contract<2>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 3: contract<3>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 4: contract<4>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 5: contract<5>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 6: contract<6>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        case 7: contract<7>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
        default: contract<8>(sm, tre, tim, n, b0, nb, b1, kmax, lane, warp, vec); break;
      }
    } else {   // unit sums: the recurrence alone, on quotients in range
      for (int e = tid; e < kNB * ldr; e += kNT) sm.red_r[e] = sm.red_i[e] = T(1);
    }
    cp_wait_all();   // the diagonal block
    __syncthreads();

    // 2. the recurrence of column k over rows b0 + il, il <= top
    const int top = c < w ? min(nb - 1, k - b0) : -1;
    if (top >= 0 && (stages & 2)) {
      T* xc_r = sm.xre + c * sm.rows;   // column k of x
      T* xc_i = sm.xim + c * sm.rows;
      T sr[2] = {T(0), T(0)}, si[2] = {T(0), T(0)};
      Smith<T> piv[2];
      T rd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int il = lane + 32 * h;
        piv[h].r = T(0);
        piv[h].den = T(1);
        piv[h].use_r = true;
        if (il <= top) {
          sr[h] = sm.red_r[il * ldr + c];
          si[h] = sm.red_i[il * ldr + c];
          T dr = sm.dre[il * kLdD + il] - lam_r, di = sm.dim[il * kLdD + il] - lam_i;
          if (hypot_t(dr, di) <= smallnum) {
            dr = smallnum;
            di = T(0);
          }
          piv[h] = smith_of(dr, di);
        }
        rd[h] = in_range(piv[h].den) ? rcp_rn(piv[h].den) : T(0);
      }
      T ftot = T(1);
      int first = top;
      if (b0 + top == k) {   // row k: the unit, already in x; its update
        const T tr = sm.dre[lane * kLdD + top], ti = sm.dim[lane * kLdD + top];
        if (lane < top) {
          sr[0] += tr;
          si[0] += ti;
        }
        if (lane + 32 < top) {
          sr[1] += sm.dre[(lane + 32) * kLdD + top];
          si[1] += sm.dim[(lane + 32) * kLdD + top];
        }
        --first;
      }
#pragma unroll
      for (int h = 1; h >= 0; --h) {
        for (int il = min(first, 32 * h + 31); il >= 32 * h; --il) {
          // T[b0 + lane, b0 + il] and T[b0 + lane + 32, b0 + il]
          const T t0r = sm.dre[lane * kLdD + il], t0i = sm.dim[lane * kLdD + il];
          T t1r = T(0), t1i = T(0);
          if (h == 1) {
            t1r = sm.dre[(lane + 32) * kLdD + il];
            t1i = sm.dim[(lane + 32) * kLdD + il];
          }
          const int src = il - 32 * h;
          T nr, ni;
          smith_num(-sr[h], -si[h], piv[h], &nr, &ni);
          T zr = __shfl_sync(kFull, quotient(nr, piv[h].den, rd[h]), src);
          T zi = __shfl_sync(kFull, quotient(ni, piv[h].den, rd[h]), src);
          // the owner's operands outside the range: the division as such
          // (rare; a vote, so the whole warp takes the branch or none)
          const bool out = !(rd[h] != T(0) && in_range(nr) && in_range(ni));
          if (__any_sync(kFull, out && lane == src)) {
            zr = __shfl_sync(kFull, nr / piv[h].den, src);
            zi = __shfl_sync(kFull, ni / piv[h].den, src);
          }
          // the rank-1 update of the rows above, before the growth test: a
          // rescale then scales the updated sums, (s + t·z)·f = s·f + t·(z·f)
          if (lane < il) {
            sr[0] = fma(t0r, zr, fma(-t0i, zi, sr[0]));
            si[0] = fma(t0r, zi, fma(t0i, zr, si[0]));
          }
          if (h == 1 && lane + 32 < il) {
            sr[1] = fma(t1r, zr, fma(-t1i, zi, sr[1]));
            si[1] = fma(t1r, zi, fma(t1i, zr, si[1]));
          }
          const T m = fmax(fabs(zr), fabs(zi));
          if (__any_sync(kFull, m > bignum)) {   // growth: rescale the column (rare)
            const T f = T(1) / m;
            zr *= f;
            zi *= f;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              sr[q] *= f;
              si[q] *= f;
            }
            ftot *= f;
            __syncwarp();
            for (int j = b0 + il + 1 + lane; j <= b0 + top; j += 32) {
              xc_r[j] *= f;
              xc_i[j] *= f;
            }
            __syncwarp();
          }
          xc_r[b0 + il] = zr;   // the same value from every lane
          xc_i[b0 + il] = zi;
        }
      }
      // 3. the rows below the block take the block's factors
      if (ftot != T(1)) {
        __syncwarp();
        for (int j = b1 + lane; j <= k; j += 32) {
          xc_r[j] *= ftot;
          xc_i[j] *= ftot;
        }
      }
    }
    __syncthreads();   // x of the block is final; the diagonal block is free
  }

  for (int e = tid; e < n * w; e += kNT) {
    const int j = e / w, q = e - j * w;
    const size_t a = (size_t)j * n + k0 + q;
    xre[a] = j <= kmax ? sm.xre[q * sm.rows + j] : T(0);
    xim[a] = j <= kmax ? sm.xim[q * sm.rows + j] : T(0);
  }
}

template <typename T>
int launch(const T* tre, const T* tim, const T* lre, const T* lim, const T* small,
           const int* tiles, T* xre, T* xim, int nb, int n, int ntiles, int smem,
           double bignum, int stages, void* stream) {
  if (n < 1 || ntiles < 1 || smem < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(trevc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte reads of T's rows when every row starts on 16 bytes
  constexpr int nv = 16 / (int)sizeof(T);
  const bool vec = n % nv == 0 && ((uintptr_t)tre & 15) == 0 && ((uintptr_t)tim & 15) == 0;
  const dim3 grid(ntiles, nb);
  trevc_kernel<T><<<grid, kNT, smem, (cudaStream_t)stream>>>(
      tre, tim, lre, lim, small, tiles, xre, xim, n, (T)bignum, stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_trevc_solve_f32(const float* tre, const float* tim, const float* lre,
                          const float* lim, const float* small, const int* tiles, float* xre,
                          float* xim, int nb, int n, int ntiles, int smem, double bignum,
                          int stages, void* stream) {
  return launch<float>(tre, tim, lre, lim, small, tiles, xre, xim, nb, n, ntiles, smem,
                       bignum, stages, stream);
}

int nd4js_trevc_solve_f64(const double* tre, const double* tim, const double* lre,
                          const double* lim, const double* small, const int* tiles,
                          double* xre, double* xim, int nb, int n, int ntiles, int smem,
                          double bignum, int stages, void* stream) {
  return launch<double>(tre, tim, lre, lim, small, tiles, xre, xim, nb, n, ntiles, smem,
                        bignum, stages, stream);
}

}  // extern "C"

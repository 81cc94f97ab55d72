// chol_leaf: Cholesky factor L, and L⁻¹ when asked, of a batch of small SPD
// blocks (Nb, n, n), n <= 64: the leaves of la/cholesky.py's half/half
// recursion.
//
// Replaces the TPU kernel nd4js_tpu/ops/chol_leaf.py::chol_leaf
// (_chol_leaf_kernel). Same contract as its caller consumes it: L lower
// triangular with zeros above, A = L·Lᵀ; non-SPD input gives NaN (sqrt of a
// negative), never an error. Unlike the TPU kernel, which reads the block
// transposed as it is, this one reads ONLY the lower triangle of A, as the
// plain version (_chol_base) does; the upper triangle may hold anything.
//
// Bound on the H100: bytes, at a large batch. A block reads its lower
// triangle (n(n+1)/2 values) and writes L and L⁻¹ dense (2n²); the flops,
// n³/3 for the factor and as many for the inverse, weigh less: config 2's
// (1024, 64, 64) with L⁻¹ moves 41.9 MB, 0.0126 ms at 3.35 TB/s. At a batch
// of 32 or 1, where 72 of the main path's 74 launches run, that bound is
// microseconds and the time is the latency of one matrix's n dependent
// steps: a barrier, a shuffle, a square root and a divide each, some
// hundreds of cycles on the H100 (PERF.md §6 has the measured µs a step).
//
// What held the first version back: one thread a row, left-looking, so step
// j was a serial dot product of length j and two block barriers; and an
// inverse with one thread a column, whose first column ran 64 times as long
// as its last.
//
// Design. One thread block a matrix, W = 8 or 16 warps (ops/chol_leaf.py::
// plan: 16 while the batch fits the card in one wave, else 8). Warp w owns
// the columns k = q·W + w of A and of X = L⁻¹; lane l holds rows l and
// l + 32 of each, in registers. The factor is right-looking, as the TPU
// kernel's: at step j every warp applies the rank-1 update by column j of L
// to its own columns k > j. The warp that owns column j + 1 updates that
// column first, takes its pivot from the owning lane by a shuffle, its IEEE
// square root, divides the column by it (the plain version's col /
// sqrt(piv)) and writes it into the other half of a double buffer in
// shared memory; one block barrier at the start of each step publishes it.
// The double buffer is what lets one barrier a step do: the half the owner
// writes during step j held column j − 1, which every warp had read before
// that barrier (one buffer would need a second barrier a step). The inverse
// is forward elimination on [L | I] in the same loop: row j of X is final
// up to its division by L[j, j] (taken as the product with the IEEE
// reciprocal 1 / L[j, j]), and every row i > j receives X[i, :] −=
// L[i, j]·X[j, :], the same rank-1 shape as the factor's update: each warp
// updates its own columns of X, with X[j, c] from its lane by a shuffle.
// Each step is instantiated with its index, so each slot of registers is
// named at compile time, and the slots of rows 0-31 drop out from step 31
// on. The block is loaded and stored through shared memory (row stride
// n + 1: a column read by 32 lanes hits 32 banks) with 16-byte global
// accesses where n and the pointers allow, with no division by n.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kLeaf = 64;        // widest leaf: two rows a lane
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

// blocks an SM must hold at once, by the launch bounds (float32: two of 8
// warps, one of 16)
template <typename T, int W>
constexpr int min_blocks() {
  return 16 / W / (int)(sizeof(T) / 4) > 0 ? 16 / W / (int)(sizeof(T) / 4) : 1;
}

// slot (q, h) holds rows lane + 32·h of column q·W + w; rows 0-31 of a
// column k >= 32 are above the diagonal and have no slot
template <int W>
__device__ __forceinline__ constexpr bool live(int q, int h) {
  return h == 1 || q * W <= 31;
}

template <typename T, int W>
__device__ __forceinline__ void load_lower(const T* __restrict__ a, T* s, int n, int ld,
                                           bool vec, int lane, int w) {
  using V = typename Vec<T>::type;
  constexpr int NV = Vec<T>::n;
  if (vec) {
    for (int r = w; r < n; r += W) {
      const V* row = reinterpret_cast<const V*>(a + (size_t)r * n);
      for (int v = lane; v * NV <= r; v += 32) {
        const V x = row[v];
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (v * NV + i <= r) s[r * ld + v * NV + i] = e[i];
      }
    }
  } else {
    for (int r = w; r < n; r += W)
      for (int c = lane; c <= r; c += 32) s[r * ld + c] = a[(size_t)r * n + c];
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_rows(const T* s, T* __restrict__ out, int n, int ld,
                                           bool vec, int lane, int w) {
  using V = typename Vec<T>::type;
  constexpr int NV = Vec<T>::n;
  if (vec) {
    for (int r = w; r < n; r += W) {
      V* row = reinterpret_cast<V*>(out + (size_t)r * n);
      for (int v = lane; v * NV < n; v += 32) {
        V x;
        T* e = reinterpret_cast<T*>(&x);
#pragma unroll
        for (int i = 0; i < NV; ++i) e[i] = s[r * ld + v * NV + i];
        row[v] = x;
      }
    }
  } else {
    for (int r = w; r < n; r += W)
      for (int c = lane; c < n; c += 32) out[(size_t)r * n + c] = s[r * ld + c];
  }
}

// the registers of a warp's columns into rows of s, zeros above the diagonal
template <typename T, int W>
__device__ __forceinline__ void stage(const T (&v)[kLeaf / W][2], T* s, int n, int ld,
                                      int lane, int w) {
#pragma unroll
  for (int q = 0; q < kLeaf / W; ++q) {
    const int k = q * W + w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < n && k < n) s[r * ld + k] = live<W>(q, h) && r >= k ? v[q][h] : T(0);
    }
  }
}

// Step J of the factor, column J of L in col[J & 1], published by the
// barrier the step starts with. The owner of column J + 1 applies the
// step's update to it first, takes its pivot, root and column into the
// other buffer; then every warp updates its trailing columns and
// eliminates column J from X. J is a template argument, so every register
// slot below is named at compile time.
template <int J, typename T, int W, bool INV>
__device__ __forceinline__ void step(T (&av)[kLeaf / W][2], T (&xv)[INV ? kLeaf / W : 1][2],
                                     T (*col)[kLeaf], int n, int lane, int w) {
  constexpr int NQ = kLeaf / W;
  constexpr int JN = J + 1;
  __syncthreads();   // column J is in col[J & 1]; every warp has read J − 1
  const T* cj = col[J & 1];
  const T lr[2] = {cj[lane], cj[lane + 32]};   // L[row, J]; 0 above row J
  if constexpr (JN < kLeaf) {
    constexpr int Q = JN / W;
    if (JN < n && w == JN % W) {
      const T lk = cj[JN];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live<W>(Q, h) && !(h == 0 && J >= 31)) av[Q][h] -= lr[h] * lk;
      const T d = sqrt(__shfl_sync(kFull, av[Q][JN / 32], JN % 32));   // NaN if not SPD
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live<W>(Q, h)) av[Q][h] = av[Q][h] / d;
      T* cn = col[JN & 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        cn[r] = live<W>(Q, h) && r >= JN && r < n ? av[Q][h] : T(0);
      }
    }
  }
  // the rank-1 update of the other trailing columns
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q * W + W - 1 <= JN) continue;   // every column of the slot <= J + 1
    const int k = q * W + w;
    if (k > JN && k < n) {
      const T lk = cj[k];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live<W>(q, h) && !(h == 0 && J >= 31)) av[q][h] -= lr[h] * lk;
    }
  }
  // forward elimination of X: row J final, then rows i > J
  if constexpr (INV) {
    const T rinv = T(1) / cj[J];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q * W > J) continue;   // every column of the slot > J: X[J, c] = 0
      const int c = q * W + w;
      if (c <= J) {
        const T xj = __shfl_sync(kFull, xv[q][J / 32], J % 32) * rinv;
        if (lane == J % 32) xv[q][J / 32] = xj;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (live<W>(q, h) && !(h == 0 && J >= 31) && lane + 32 * h > J)
            xv[q][h] -= lr[h] * xj;
      }
    }
  }
}

// steps 0 … n − 1, each instantiated with its index
template <typename T, int W, bool INV, int... J>
__device__ __forceinline__ void steps(std::integer_sequence<int, J...>,
                                      T (&av)[kLeaf / W][2],
                                      T (&xv)[INV ? kLeaf / W : 1][2], T (*col)[kLeaf],
                                      int n, int lane, int w) {
  (void)((J < n && (step<J, T, W, INV>(av, xv, col, n, lane, w), true)) && ...);
}

template <typename T, int W, bool INV>
__global__ void __launch_bounds__(32 * W, min_blocks<T, W>())
chol_leaf_kernel(const T* __restrict__ a, T* __restrict__ l, T* __restrict__ li, int n,
                 bool vec) {
  constexpr int NQ = kLeaf / W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);   // n rows of ld: A in, L and L⁻¹ out
  __shared__ T col[2][kLeaf];              // column j of L, double-buffered
  const int ld = n + 1;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const size_t off = (size_t)blockIdx.x * n * n;

  load_lower<T, W>(a + off, s, n, ld, vec, lane, w);
  __syncthreads();

  T av[NQ][2];                  // A, then L, by column
  T xv[INV ? NQ : 1][2];        // X, from I to L⁻¹
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int k = q * W + w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (live<W>(q, h)) {
        av[q][h] = r < n && k < n && r >= k ? s[r * ld + k] : T(0);
        if constexpr (INV) xv[q][h] = r == k ? T(1) : T(0);
      }
    }
  }

  // column 0: warp 0 owns it
  if (w == 0) {
    const T d = sqrt(__shfl_sync(kFull, av[0][0], 0));   // NaN if not SPD
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      av[0][h] = av[0][h] / d;
      col[0][lane + 32 * h] = lane + 32 * h < n ? av[0][h] : T(0);
    }
  }

  steps<T, W, INV>(std::make_integer_sequence<int, kLeaf>(), av, xv, col, n, lane, w);
  __syncthreads();

  stage<T, W>(av, s, n, ld, lane, w);
  __syncthreads();
  store_rows<T, W>(s, l + off, n, ld, vec, lane, w);
  if constexpr (INV) {
    __syncthreads();
    stage<T, W>(xv, s, n, ld, lane, w);
    __syncthreads();
    store_rows<T, W>(s, li + off, n, ld, vec, lane, w);
  }
}

template <typename T, int W>
int launch_w(const T* a, T* l, T* li, int nb, int n, bool vec, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)n * (n + 1);   // at most 33.3 KB
  if (li)
    chol_leaf_kernel<T, W, true><<<nb, 32 * W, smem, stream>>>(a, l, li, n, vec);
  else
    chol_leaf_kernel<T, W, false><<<nb, 32 * W, smem, stream>>>(a, l, li, n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* a, T* l, T* li, int nb, int n, int warps, void* stream) {
  if (nb == 0 || n == 0) return (int)cudaSuccess;
  if (n > kLeaf) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = n % Vec<T>::n == 0 && aligned(a) && aligned(l) && (!li || aligned(li));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (warps) {
    case 8: return launch_w<T, 8>(a, l, li, nb, n, vec, st);
    case 16: return launch_w<T, 16>(a, l, li, nb, n, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int nd4js_chol_leaf_f32(const float* a, float* l, float* li, int nb, int n, int warps,
                        void* stream) {
  return launch<float>(a, l, li, nb, n, warps, stream);
}

int nd4js_chol_leaf_f64(const double* a, double* l, double* li, int nb, int n, int warps,
                        void* stream) {
  return launch<double>(a, l, li, nb, n, warps, stream);
}

}  // extern "C"

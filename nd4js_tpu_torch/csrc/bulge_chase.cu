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
// a step have disjoint 3-row supports, so they commute: one barrier-separated
// phase applies all NB row updates (a thread per bulge and column), the next
// all NB column updates of B and V_acc (a thread per bulge and row), O(NB·W)
// a step in the normal orientation. The thread of bulge i then reads its next
// carry and builds its next reflector, so a step costs three barriers.
//
// Bound on the H100: the step chain's latency. The bound reported beside
// the kernel counts what each of the SL·NB reflector steps must update,
// ~10 flops for each nonzero column of B's three rows (W − kb + 1 for a
// Hessenberg block with its bulges), each nonzero row of B's three columns
// (kb + 4) and each nonzero row of V_acc's three columns, against 2·W²
// values moved (B in, V_acc out).
//
// Memory: B in shared memory; V_acc beside it when both fit a block's 227 KB
// (W = 128 in float32), otherwise V_acc is updated in place in the output in
// global memory (float64 at W = 128), where it stays in L2.
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemMax = 232448;  // 227 KB, a Hopper block's maximum
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bulge_chase_kernel(const T* __restrict__ b_in, const T* __restrict__ p_in,
                   const T* __restrict__ shifts, T* __restrict__ v_out,
                   T* __restrict__ p_out, int W, int NB, int SL, int k0, int lo, int hi,
                   int seed, int v_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b = reinterpret_cast<T*>(smem_raw);
  T* P = b + (size_t)W * W;          // NB × 3 carries
  T* rf = P + 3 * NB;                // NB × 3: v1, v2, tau of this step
  T* v = v_in_smem ? rf + 3 * NB : v_out;

  const int tid = threadIdx.x;
  const int OFF = 3 * (NB - 1);
  for (int idx = tid; idx < W * W; idx += blockDim.x) {
    b[idx] = b_in[idx];
    v[idx] = (idx / W == idx % W) ? T(1) : T(0);
  }
  for (int idx = tid; idx < 3 * NB; idx += blockDim.x) P[idx] = p_in[idx];
  __syncthreads();

  for (int t = 0; t < SL; ++t) {
    // ---- each bulge's reflector (thread i for bulge i)
    for (int i = tid; i < NB; i += blockDim.x) {
      const int k = k0 + t - 3 * i;
      const int kb = t + OFF - 3 * i;
      const bool act = k >= lo && k <= hi - 2;
      T p0 = P[3 * i], p1 = P[3 * i + 1], p2 = P[3 * i + 2];
      if (seed && k == lo) {
        const T tr = shifts[2 * i], det = shifts[2 * i + 1];
        const T b00 = b[kb * W + kb], b01 = b[kb * W + kb + 1];
        const T b10 = b[(kb + 1) * W + kb], b11 = b[(kb + 1) * W + kb + 1];
        const T b21 = b[(kb + 2) * W + kb + 1];
        p0 = b00 * b00 + b01 * b10 - tr * b00 + det;
        p1 = b10 * (b00 + b11 - tr);
        p2 = b10 * b21;
        P[3 * i] = p0;
        P[3 * i + 1] = p1;
        P[3 * i + 2] = p2;
      }
      if (k == hi - 2) p2 = T(0);
      const T sigma = p1 * p1 + p2 * p2;
      const T nrm = sqrt(p0 * p0 + sigma);
      const T beta = p0 >= T(0) ? -nrm : nrm;
      const T den = p0 - beta;
      const T sden = den == T(0) ? T(1) : den;
      const T sbeta = beta == T(0) ? T(1) : beta;
      T tau = nrm == T(0) ? T(0) : (beta - p0) / sbeta;
      if (sigma == T(0) || !act) tau = T(0);
      rf[3 * i] = sigma == T(0) ? T(0) : p1 / sden;
      rf[3 * i + 1] = sigma == T(0) ? T(0) : p2 / sden;
      rf[3 * i + 2] = tau;
    }
    __syncthreads();
    // ---- all NB row updates: B ← (I − τ·v·vᵀ)·B on rows kb..kb+2
    for (int idx = tid; idx < NB * W; idx += blockDim.x) {
      const int i = idx / W, c = idx % W;
      const T tau = rf[3 * i + 2];
      if (tau == T(0)) continue;
      const T v1 = rf[3 * i], v2 = rf[3 * i + 1];
      const int kb = t + OFF - 3 * i;
      T* r0 = b + kb * W + c;
      const T w = tau * (r0[0] + v1 * r0[W] + v2 * r0[2 * W]);
      r0[0] -= w;
      r0[W] -= v1 * w;
      r0[2 * W] -= v2 * w;
    }
    __syncthreads();
    // ---- all NB column updates: B ← B·(I − τ·v·vᵀ), V_acc ← V_acc·(…)
    for (int idx = tid; idx < NB * W; idx += blockDim.x) {
      const int i = idx / W, r = idx % W;
      const T tau = rf[3 * i + 2];
      if (tau == T(0)) continue;
      const T v1 = rf[3 * i], v2 = rf[3 * i + 1];
      const int kb = t + OFF - 3 * i;
      T* c0 = b + r * W + kb;
      const T w = tau * (c0[0] + v1 * c0[1] + v2 * c0[2]);
      c0[0] -= w;
      c0[1] -= v1 * w;
      c0[2] -= v2 * w;
      T* q0 = v + r * W + kb;
      const T wq = tau * (q0[0] + v1 * q0[1] + v2 * q0[2]);
      q0[0] -= wq;
      q0[1] -= v1 * wq;
      q0[2] -= v2 * wq;
    }
    __syncthreads();
    // ---- the active bulges' next carries, B[kb+1..kb+3, kb]
    for (int i = tid; i < NB; i += blockDim.x) {
      const int k = k0 + t - 3 * i;
      const int kb = t + OFF - 3 * i;
      if (k >= lo && k <= hi - 2) {
        P[3 * i] = b[(kb + 1) * W + kb];
        P[3 * i + 1] = b[(kb + 2) * W + kb];
        P[3 * i + 2] = k + 3 < hi ? b[(kb + 3) * W + kb] : T(0);
      }
    }
    // the same thread reads P[i] at the next step: no barrier needed here,
    // and B is not written again before the next step's first barrier
  }
  __syncthreads();
  if (v_in_smem)
    for (int idx = tid; idx < W * W; idx += blockDim.x) v_out[idx] = v[idx];
  for (int idx = tid; idx < 3 * NB; idx += blockDim.x) p_out[idx] = P[idx];
}

template <typename T>
size_t smem_bytes(int W, int NB, bool v_in_smem) {
  return sizeof(T) * ((size_t)W * W * (v_in_smem ? 2 : 1) + 6 * (size_t)NB);
}

template <typename T>
int launch(const T* b, const T* p, const T* shifts, T* v, T* po, int W, int NB, int SL,
           int k0, int lo, int hi, int seed, void* stream) {
  // every active bulge's 3-row support lies inside the block
  if (W < 4 || NB < 1 || SL < 0 || SL + 3 * NB > W) return (int)cudaErrorInvalidValue;
  const bool v_in_smem = smem_bytes<T>(W, NB, true) <= kSmemMax;
  const size_t smem = smem_bytes<T>(W, NB, v_in_smem);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bulge_chase_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  bulge_chase_kernel<T><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      b, p, shifts, v, po, W, NB, SL, k0, lo, hi, seed, (int)v_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nd4js_bulge_chase_f32(const float* b, const float* p, const float* shifts, float* v,
                          float* po, int W, int NB, int SL, int k0, int lo, int hi, int seed,
                          void* stream) {
  return launch<float>(b, p, shifts, v, po, W, NB, SL, k0, lo, hi, seed, stream);
}

int nd4js_bulge_chase_f64(const double* b, const double* p, const double* shifts,
                          double* v, double* po, int W, int NB, int SL, int k0, int lo,
                          int hi, int seed, void* stream) {
  return launch<double>(b, p, shifts, v, po, W, NB, SL, k0, lo, hi, seed, stream);
}

}  // extern "C"

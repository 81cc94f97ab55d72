// Shared helpers of the nd4js_tpu_torch kernels: the Householder reflector
// of one column, with the sign and zero rules of
// nd4js_tpu/ops/house_panel.py:43-53, stores into a cluster peer's shared
// memory, and the launch of a kernel on thread-block clusters.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace nd4js {

// Scalars of the reflector H = I - tau·v·vᵀ that maps x to beta·e_0,
// v_0 = 1, v_i = x_i / den below: beta = -sign(x0)·‖x‖ (sign(0) = +1),
// tau = 0 for a zero column, den = 1 where it would be 0.
template <typename T>
struct Reflector {
  T beta, tau, den;
};

template <typename T>
__device__ Reflector<T> make_reflector(T x0, T sigma) {
  Reflector<T> h;
  const T nrm = sqrt(x0 * x0 + sigma);
  h.beta = x0 >= T(0) ? -nrm : nrm;
  const T den = x0 - h.beta;
  h.den = den == T(0) ? T(1) : den;
  const T safe_beta = h.beta == T(0) ? T(1) : h.beta;
  h.tau = nrm == T(0) ? T(0) : (h.beta - x0) / safe_beta;
  return h;
}

// The address of `p` in the shared memory of cluster rank q, and stores of
// one value there (into a peer's shared memory: a barrier with release
// semantics, such as the cluster barrier, publishes them).
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int q) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(q));
  return r;
}
__device__ __forceinline__ void st_remote(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(x) : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t a, double x) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(a), "d"(x) : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t a, int x) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
}

// Shared memory one block may ask for on Hopper (227 KB).
constexpr int kSmemMax = 232448;
// What launch_clusters returns when no part of the card can hold one cluster.
constexpr int kCannotPlace = -2;

// Launch configurations already checked by cudaOccupancyMaxActiveClusters,
// which costs far more host time than the launch itself: (kernel, device,
// threads, cluster size, shared memory) of each, with the answer.
struct Placed {
  const void* kernel;
  int device, threads, csize;
  size_t smem;
  int clusters;
};

inline std::mutex& placed_lock() {
  static std::mutex lock;
  return lock;
}

inline std::vector<Placed>& placed() {
  static std::vector<Placed> seen;
  return seen;
}

// Clusters of `csize` blocks of `threads` threads, each block with `smem`
// bytes of dynamic shared memory, that the card holds at once (through
// `clusters`), from cudaOccupancyMaxActiveClusters; remembered per kernel,
// device and configuration. The first check of a kernel on a device also
// lifts its shared-memory limit to 227 KB and, for clusters above the
// portable 8 blocks, allows those. Returns a CUDA error.
template <typename Kernel>
int active_clusters(Kernel kernel, int threads, int csize, size_t smem, int* clusters) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> hold(placed_lock());
    for (const Placed& p : placed())
      if (p.kernel == (const void*)kernel && p.device == device && p.threads == threads &&
          p.csize == csize && p.smem == smem) {
        *clusters = p.clusters;
        return (int)cudaSuccess;
      }
  }
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  if (csize > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)csize);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(placed_lock());
  placed().push_back({(const void*)kernel, device, threads, csize, smem, *clusters});
  return (int)cudaSuccess;
}

// One launch of `kernel` as `blocks` blocks of `threads` threads, in
// clusters of `csize` blocks, each block with `smem` bytes of dynamic shared
// memory, on `stream`. Returns a CUDA error, or kCannotPlace when no part of
// the card can hold one cluster with its shared memory.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int blocks, int threads, int csize, size_t smem, void* stream,
                    Args... args) {
  int clusters = 0;
  const int rc = active_clusters(kernel, threads, csize, smem, &clusters);
  if (rc != 0) return rc;
  if (clusters < 1) return kCannotPlace;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace nd4js

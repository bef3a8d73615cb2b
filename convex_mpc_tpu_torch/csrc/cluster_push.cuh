// Thread-block clusters (sm_90). Device side: point-to-point transfers
// inside a cluster — a CTA stores values into a peer's shared memory with
// st.async, each store counting its bytes on an mbarrier in the peer's
// shared memory; the peer arms the barrier with the bytes it expects and
// waits for the phase to complete, so no cluster-wide barrier is needed per
// transfer. Host side: the launch check of a cluster kernel, cached per
// shape.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace cluster_push {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// the shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// one expected arrival per phase: the arm below
__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// makes the initialised barriers visible to the cluster's st.async
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive, expecting `bytes` more to land in this phase
__device__ __forceinline__ void bar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of the given parity has completed; what landed is then
// visible to the calling thread
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// v into the shared::cluster address `addr`, its 4 bytes counted on `bar`
// (a shared::cluster address in the same CTA)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// v into the shared::cluster address `addr` (16-byte aligned), its 16 bytes
// counted on `bar` (a shared::cluster address in the same CTA)
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// A launch of `csize`-CTA clusters of `threads` threads with `smem` bytes of
// dynamic shared memory each, `clusters` clusters in all.
inline cudaLaunchConfig_t cluster_config(int clusters, int csize, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((clusters > 1 ? clusters : 1) * csize));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of cfg's shape of `kernel` can be resident at once on
// the current device (cudaOccupancyMaxActiveClusters), into *clusters; 0 if
// the shape does not fit: more threads than the kernel's launch bounds allow,
// or more shared memory than one block may have. Raises the kernel's
// dynamic shared-memory limit to cfg's on the way (never lowers it), and
// for a cluster of more than 8 CTAs (the portable limit) allows it
// non-portable cluster sizes first. Both attributes are set once per
// (kernel, device), and the answer is kept per (kernel, device, shape), so a
// repeated launch makes none of these host calls again.
template <typename... Args>
cudaError_t resident_clusters(void (*kernel)(Args...), const cudaLaunchConfig_t& cfg,
                              int* clusters) {
  struct Entry {
    const void* fn;
    int dev;
    unsigned threads, csize;
    size_t smem;
    int clusters;
  };
  struct Limit {  // the dynamic shared-memory limit set so far; non-portable sizes allowed
    const void* fn;
    int dev;
    size_t smem;
    bool nonportable;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  static std::vector<Limit> limits;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const unsigned threads = cfg.blockDim.x, csize = cfg.attrs[0].val.clusterDim.x;
  const size_t smem = cfg.dynamicSmemBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : known)
    if (e.fn == fn && e.dev == dev && e.threads == threads && e.csize == csize && e.smem == smem) {
      *clusters = e.clusters;
      return cudaSuccess;
    }
  int found = 0;
  cudaFuncAttributes fa;
  int optin = 0;
  if ((err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if ((int)threads <= fa.maxThreadsPerBlock && fa.sharedSizeBytes + smem <= (size_t)optin) {
    Limit* lim = nullptr;
    for (Limit& x : limits)
      if (x.fn == fn && x.dev == dev) lim = &x;
    if (lim == nullptr) {
      limits.push_back({fn, dev, 0, false});
      lim = &limits.back();
    }
    if (lim->smem < smem) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      lim->smem = smem;
    }
    if (csize > 8 && !lim->nonportable) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      lim->nonportable = true;
    }
    if ((err = cudaOccupancyMaxActiveClusters(&found, kernel, &cfg)) != cudaSuccess) return err;
  }
  known.push_back({fn, dev, threads, csize, smem, found});
  *clusters = found;
  return cudaSuccess;
}

}  // namespace cluster_push

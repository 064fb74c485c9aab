// The thread-block-cluster calls of the scatter kernel (T's deterministic
// variant), in inline PTX for sm_90. A CTA reaches another CTA's shared
// memory of its cluster through a shared::cluster address (mapa), which
// atom/ld/st take directly. tests/test_torch_port_geo_emu.py compiles
// scatter.cu on the CPU against its own version of this header.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// A shared::cluster byte address: add byte offsets to it.
using cluster_addr = uint32_t;

// The CTA's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives before any goes on;
// shared-memory writes before it (the CTA's own and remote ones) are seen
// after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of p (in this CTA's shared memory) in CTA rank's copy.
__device__ __forceinline__ cluster_addr cluster_map(const void* p, unsigned rank) {
  cluster_addr a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}

// Adds v to the 32-bit word at a; returns its old value.
__device__ __forceinline__ unsigned cluster_fetch_add32(cluster_addr a, unsigned v) {
  unsigned old;
  asm volatile("atom.relaxed.cluster.shared::cluster.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(a), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned cluster_load(cluster_addr a) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_store(cluster_addr a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// Launches kernel on a 1-D grid of clusters of `cluster` CTAs with `smem`
// bytes of dynamic shared memory each (set as the kernel's maximum first).
template <typename... Args>
cudaError_t cluster_launch(void (*kernel)(Args...), unsigned grid, unsigned threads, size_t smem,
                           unsigned cluster, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many such clusters the card can hold at once (0 where none fits).
template <typename... Args>
cudaError_t cluster_occupancy(void (*kernel)(Args...), unsigned threads, size_t smem,
                              unsigned cluster, int* n) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

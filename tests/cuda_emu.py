"""A CUDA-on-CPU shim for the kernels' emulation tests
(``tests/test_torch_port_*_emu.py``).

A kernel's CUDA source is compiled with the host's C++ compiler against a
small shim of the CUDA features the sources use (``SHIM``, written as
``cuda_runtime.h``): one ``std::thread`` per CUDA thread of a block,
``std::barrier`` for ``__syncthreads``, a byte buffer per block for its
dynamic shared memory, float4, float and 64-bit atomics
(``std::atomic_ref``, on shared memory too), memset, and the warp
shuffles (of 32- and 64-bit values) and votes, through a barrier a warp,
and float32 operations rounded once (``__fadd_rn``, ...).
The blocks of a grid run one after another; the blocks of a thread-block
cluster (``shim_launch_cluster``) run at once, with a barrier across the
cluster, each block's rank in it and every block's buffer reachable from
the others. ``CP_ASYNC`` makes ``cp.async`` plain copies and ``BF16`` is
bfloat16 as CUDA's header gives it. The shim reports 4 SMs, so a frame
splits into several row ranges. Float arithmetic differs from the card's
(no fused multiply-adds, exact divisions), so the card's own checks stay
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``. A shim feature a
new kernel needs goes here.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from colvo_torch.kernels import build

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct Index { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline thread_local Index threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local unsigned char* block_smem_bytes = nullptr;  // dynamic shared memory
inline thread_local float* block_smem = nullptr;                // the same, as floats
inline thread_local std::unique_ptr<std::barrier<>>* warp_barriers = nullptr;
inline thread_local long long* warp_scratch = nullptr;
// Thread-block clusters: the block's rank, a barrier across the cluster's
// threads and the dynamic shared memory of each of its blocks by rank.
inline thread_local unsigned shim_cluster_rank = 0;
inline thread_local std::barrier<>* shim_cluster_barrier = nullptr;
inline thread_local unsigned char** shim_cluster_smem = nullptr;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 4;
  return 0;
}
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}
inline long long __float2ll_rn(float v) { return std::llrint(v); }
inline float __ll2float_rn(long long v) { return static_cast<float>(v); }
inline int __clzll(long long v) { return v ? __builtin_clzll(static_cast<unsigned long long>(v)) : 64; }
// A warp's threads meet at their warp's barrier (blocks hold whole warps):
// each lane posts a 32- or 64-bit value and reads lane ``src``'s.
template <class T> T shim_exchange(T v, unsigned src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8);
  const unsigned w = threadIdx.x / 32;
  std::memcpy(&warp_scratch[threadIdx.x], &v, sizeof(T));
  warp_barriers[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &warp_scratch[32 * w + src], sizeof(T));
  warp_barriers[w]->arrive_and_wait();
  return r;
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  return shim_exchange(v, lane >= delta ? lane - delta : lane);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  return shim_exchange(v, lane + delta < 32 ? lane + delta : lane);
}
template <class T> T __shfl_xor_sync(unsigned, T v, unsigned mask) {
  return shim_exchange(v, (threadIdx.x % 32) ^ mask);
}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline float __fdividef(float a, float b) { return a / b; }
// IEEE float32 operations rounded once (the host's compiler contracts
// nothing here: ISO C++ mode, no FMA instructions in the baseline x86-64).
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// Compiled with -DSHIM_REVERSE, the blocks of a grid run last to first and
// a block's threads start last to first.
#ifdef SHIM_REVERSE
constexpr bool shim_reverse = true;
#else
constexpr bool shim_reverse = false;
#endif
// One block's state: its shared memory (NaN floats before the kernel
// writes it), its barrier, its warps' barriers and shuffle scratch.
struct ShimBlock {
  std::unique_ptr<float[]> smem;
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<long long> scratch;
  ShimBlock(size_t bytes, int threads)
      : smem(new float[(bytes + 15) / 4 + 4]), bar(threads), scratch(threads) {
    std::fill(smem.get(), smem.get() + (bytes + 15) / 4 + 4, std::nanf(""));
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.emplace_back(new std::barrier<>(min(32, threads - 32 * w)));
  }
  unsigned char* bytes() { return reinterpret_cast<unsigned char*>(smem.get()); }
};
// Runs the blocks of each cluster of `cluster` blocks at once (a thread per
// CUDA thread of each); clusters and plain grids (cluster 1) run one after
// another. A 1-D grid of clusters.
template <class K, class... A>
void shim_launch_cluster(K kernel, dim3 grid, int threads, size_t bytes, unsigned cluster,
                         A... args) {
  const unsigned n = grid.x * grid.y * grid.z;
  for (unsigned ci = 0; ci < n / cluster; ++ci) {
    const unsigned c = shim_reverse ? n / cluster - 1 - ci : ci;
    std::vector<std::unique_ptr<ShimBlock>> blocks;
    std::vector<unsigned char*> smems;
    for (unsigned r = 0; r < cluster; ++r) {
      blocks.emplace_back(new ShimBlock(bytes, threads));
      smems.push_back(blocks.back()->bytes());
    }
    std::barrier<> cbar(static_cast<std::ptrdiff_t>(cluster) * threads);
    std::vector<std::thread> pool;
    for (unsigned ri = 0; ri < cluster; ++ri) {
      const unsigned r = shim_reverse ? cluster - 1 - ri : ri;
      const unsigned b = c * cluster + r;
      for (int ti = 0; ti < threads; ++ti)
        pool.emplace_back([&, r, b, t = shim_reverse ? threads - 1 - ti : ti] {
          ShimBlock& blk = *blocks[r];
          threadIdx.x = t;
          blockIdx.x = b % grid.x;
          blockIdx.y = b / grid.x % grid.y;
          blockIdx.z = b / (grid.x * grid.y);
          blockDim.x = threads;
          gridDim.x = grid.x;
          gridDim.y = grid.y;
          gridDim.z = grid.z;
          block_barrier = &blk.bar;
          block_smem_bytes = blk.bytes();
          block_smem = blk.smem.get();
          warp_barriers = blk.warps.data();
          warp_scratch = blk.scratch.data();
          shim_cluster_rank = r;
          shim_cluster_barrier = &cbar;
          shim_cluster_smem = smems.data();
          kernel(args...);
        });
    }
    for (auto& th : pool) th.join();
  }
}
template <class K, class... A>
void shim_launch(K kernel, dim3 grid, int threads, size_t bytes, A... args) {
  shim_launch_cluster(kernel, grid, threads, bytes, 1u, args...);
}
"""

CP_ASYNC = r"""
#pragma once
inline void cp_async_f32(float* dst, const float* src, bool in) { *dst = in ? *src : 0.0f; }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
"""



# bfloat16 as CUDA's header gives it: the top 16 bits of a float, rounded
# to nearest even from float.
BF16 = r"""
#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const unsigned u = static_cast<unsigned>(v.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
"""

# A kernel launch ``k<<<grid, block, smem, stream>>>(``, template
# arguments allowed.
LAUNCH = re.compile(r"([\w]+(?:<\w+>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(")


def workdir(tmp_path_factory, name: str, headers: dict):
    """A new directory holding ``headers`` (file name → text) and the C++
    compiler to build there; skips the test without a C++20 compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler")
    d = tmp_path_factory.mktemp(name)
    for file, text in headers.items():
        (d / file).write_text(text)
    return d, cxx


def compile_source(d, cxx, name, *flags) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built in ``d`` against the headers there, with its
    shared memory the shim's buffer and every launch a ``shim_launch``."""
    src = (build.CSRC / f"{name}.cu").read_text()
    src = src.replace("extern __shared__ float smem[];", "float* smem = block_smem;")
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = block_smem_bytes;")
    src, n_launch = LAUNCH.subn(r"shim_launch(\1, \2, \3, \4, ", src)
    assert n_launch >= 1 and "extern __shared__" not in src
    (d / f"{name}.cpp").write_text(src)
    out = d / f"{name}{''.join(flags)}.so"
    run = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w", *flags,
                          f"-I{d}", f"-I{build.CSRC}", "-o", str(out), str(d / f"{name}.cpp")],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return ctypes.CDLL(str(out))

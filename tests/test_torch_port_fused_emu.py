"""Kernel F's CUDA source (``csrc/fused_loss.cu``) on the CPU.

The source is compiled with the host's C++ compiler against a small shim
of the CUDA features it uses: one ``std::thread`` per CUDA thread of a
block, ``std::barrier`` for ``__syncthreads``, a buffer per block for its
dynamic shared memory, and plain copies for ``cp.async``. The blocks of a
grid run one after another. That executes the kernels' own indexing,
rings, walks and edge handling, which the plain versions do not, against
those plain versions, at shapes that cut the strips, chunks and row
ranges and at windows that take every branch. The shim reports 4 SMs, so
a frame splits into several row ranges. Float arithmetic differs from the
card's (no fused multiply-adds, exact divisions), so the card's own check
stays ``chip_smoke.py``; the tolerances are the same.
``tests/test_torch_port_geo_emu.py`` runs the sampler and scatter sources
against the same shim (``SHIM``), which also carries float4, float
atomics, memset and the warp shuffles those use.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from colvo_torch.kernels import build, fused_loss
from colvo_torch.kernels.sampler import sample_plain
from colvo_torch.losses.photometric import lcc_calibrate

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
#define __launch_bounds__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct Index { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
inline thread_local Index threadIdx, blockIdx, blockDim;
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local float* block_smem = nullptr;
inline thread_local std::unique_ptr<std::barrier<>>* warp_barriers = nullptr;
inline thread_local int* warp_scratch = nullptr;
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
// each lane posts a 32-bit value and reads lane ``src``'s.
template <class T> T shim_exchange(T v, unsigned src) {
  static_assert(sizeof(T) == 4);
  const unsigned w = threadIdx.x / 32;
  std::memcpy(&warp_scratch[threadIdx.x], &v, 4);
  warp_barriers[w]->arrive_and_wait();
  T r;
  std::memcpy(&r, &warp_scratch[32 * w + src], 4);
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
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcs(const T* p) { return *p; }
template <class T> void __stcs(T* p, T v) { *p = v; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline float __fdividef(float a, float b) { return a / b; }
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// Compiled with -DSHIM_REVERSE, the blocks of a grid run last to first and
// a block's threads start last to first.
#ifdef SHIM_REVERSE
constexpr bool shim_reverse = true;
#else
constexpr bool shim_reverse = false;
#endif
template <class K, class... A>
void shim_launch(K kernel, dim3 grid, int threads, size_t bytes, A... args) {
  for (unsigned zi = 0; zi < grid.z; ++zi)
    for (unsigned yi = 0; yi < grid.y; ++yi)
      for (unsigned xi = 0; xi < grid.x; ++xi) {
        const unsigned z = shim_reverse ? grid.z - 1 - zi : zi;
        const unsigned y = shim_reverse ? grid.y - 1 - yi : yi;
        const unsigned x = shim_reverse ? grid.x - 1 - xi : xi;
        std::vector<float> smem(bytes / sizeof(float), std::nanf(""));
        std::barrier<> bar(threads);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (int w = 0; w < (threads + 31) / 32; ++w)
          warps.emplace_back(new std::barrier<>(min(32, threads - 32 * w)));
        std::vector<int> scratch(threads);
        std::vector<std::thread> pool;
        for (int ti = 0; ti < threads; ++ti)
          pool.emplace_back([&, t = shim_reverse ? threads - 1 - ti : ti] {
            threadIdx.x = t;
            blockIdx.x = x;
            blockIdx.y = y;
            blockIdx.z = z;
            blockDim.x = threads;
            block_barrier = &bar;
            block_smem = smem.data();
            warp_barriers = warps.data();
            warp_scratch = scratch.data();
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
}
"""

CP_ASYNC = r"""
#pragma once
inline void cp_async_f32(float* dst, const float* src, bool in) { *dst = in ? *src : 0.0f; }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler")
    d = tmp_path_factory.mktemp("fused_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cp_async.cuh").write_text(CP_ASYNC)
    src = (build.CSRC / "fused_loss.cu").read_text()
    src = src.replace("extern __shared__ float smem[];", "float* smem = block_smem;")
    src, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\((\w+)\);",
                            r"shim_launch(\1, \2, \3, \4, \5);", src)
    assert n_launch == 1 and "block_smem" in src
    (d / "fused_loss.cpp").write_text(src)
    out = d / "fused_loss.so"
    run = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
                          f"-I{d}", f"-I{build.CSRC}", "-o", str(out), str(d / "fused_loss.cpp")],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.colvo_fused_err_fwd.argtypes = [p, ll, p, ll, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.colvo_fused_err_bwd.argtypes = [p, ll, p, ll, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    return lib


def _inputs(n, c, h, w, hs, ws, seed):
    """A source one frame longer than used (a batch stride that is not the
    frame's size), a relit target, near-identity coords scaled to the
    source with noise, out-of-bounds and ±1e20 coords."""
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.random((n + 1, c, hs, ws), dtype=np.float32))[1:]
    tgt = torch.tensor(0.8 * rng.random((n, c, h, w), dtype=np.float32) + 0.1)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    x = gx[None] * (ws / w) + rng.normal(0, 3.0, (n, h, w)).astype(np.float32)
    y = gy[None] * (hs / h) + rng.normal(0, 3.0, (n, h, w)).astype(np.float32)
    x[0, 1, 3], x[0, 2, 5], y[0, 3, 2] = 1e20, -1e20, 1e20
    g = torch.tensor(rng.normal(size=(n, h, w)).astype(np.float32))
    g[:, :2] = 0.0
    return src, tgt, torch.tensor(x), torch.tensor(y), g


@pytest.mark.parametrize("n,c,h,w,hs,ws,window", [
    (2, 3, 36, 50, 40, 56, 15),   # the main window; 36 rows split into row ranges
    (1, 3, 150, 70, 97, 131, 4),  # even window (lo ≠ hi), several strips and ranges
    (1, 1, 30, 20, 25, 33, 31),   # a window wider than the image
    (1, 5, 20, 30, 22, 33, 0),    # no LCC; a channel count compiled at run time
    (2, 2, 9, 7, 12, 10, 3),      # an image smaller than a chunk and a strip
])
def test_fused_kernel_source_matches_plain_versions(lib, n, c, h, w, hs, ws, window):
    """e ≤5e-5 abs; gx, gy ≤1e-4 of max off the pixels within 1e-5 of an
    L1 sign change, which may be ≤0.1 % of all (the card's tolerances,
    chip_smoke.py)."""
    torch.set_num_threads(2)
    src, tgt, x, y, g = _inputs(n, c, h, w, hs, ws, 40 + window)
    e = torch.full((n, h, w), float("nan"))
    gx, gy = torch.full_like(e, float("nan")), torch.full_like(e, float("nan"))
    frames = (src.data_ptr(), src.stride(0), tgt.data_ptr(), tgt.stride(0), x.data_ptr(),
              y.data_ptr())
    assert lib.colvo_fused_err_fwd(*frames, e.data_ptr(), n, c, hs, ws, h, w, window, 0.85,
                                   None) == 0
    assert lib.colvo_fused_err_bwd(*frames, g.data_ptr(), gx.data_ptr(), gy.data_ptr(), n, c,
                                   hs, ws, h, w, window, 0.85, None) == 0
    torch.testing.assert_close(e, fused_loss.err_plain(src, tgt, x, y, window, 0.85),
                               atol=5e-5, rtol=0)
    pgx, pgy = fused_loss.err_bwd_plain(src, tgt, x, y, g, window, 0.85)
    t = tgt.permute(0, 2, 3, 1)
    w_hat = sample_plain(src, x, y, False)[0].permute(0, 2, 3, 1)
    if window:
        w_hat = lcc_calibrate(w_hat, t, "affine", window)
    ties = (w_hat - t).abs().amin(-1) < 1e-5
    assert ties.float().mean().item() <= 1e-3
    scale = max(pgx.abs().max().item(), pgy.abs().max().item())
    for got, want in ((gx, pgx), (gy, pgy)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[~ties], want[~ties], atol=1e-4 * scale, rtol=0)

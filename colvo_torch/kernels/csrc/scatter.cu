// T: source cotangent of border-clamped bilinear sampling,
//   d src[r, c] = sum_p g_p * w_p over the output pixels p whose four
//   bilinear taps touch (r, c).
//
// Replaces the Pallas TPU kernel colvo/kernels/scatter.py:_scatter_call
// (:217, body _scatter_kernel :90), the backward of
// bilinear_sample_fullgrad. The TPU version walks offset classes under
// static caps (V_CAP=128 / H_CAP=160, :86-87) and drops classes beyond
// them. This kernel is exact for any warp: nothing is dropped, so the
// reference's scatter-overflow audit has nothing to count.
//
// Bound on Hopper: bytes. It reads x, y and g once and writes one source
// plane per channel; at the geometric-consistency shapes (24 planes at
// 256x320, 128x160, 64x80, 32x40) that is ~42 MB, ~12.5 us at 3.35 TB/s
// (~52 MB and ~16 us with the output's zero fill).
// Design: one thread per output pixel, four f32 atomicAdds per channel
// into a zeroed (N, C, H, W) buffer (the wrapper zero-fills it). A smooth
// warp sends neighbouring threads to neighbouring targets, so the atomics
// resolve in L2 with little contention; pixels with a zero cotangent are
// skipped, as in the TPU kernel.
// Float atomics add in an order that changes from run to run, so results
// differ between runs in the last bits: the kernel is not deterministic,
// and the port refuses train.deterministic=True on a CUDA device.
//
// Layout: x/y (N, h, w), g (N, C, h, w), d_src (N, C, H, W), all f32.

#include <cstdint>

#include "bilinear.cuh"

namespace {

__global__ void bilinear_scatter_kernel(const float* __restrict__ xs,
                                        const float* __restrict__ ys,
                                        const float* __restrict__ g,
                                        float* __restrict__ dsrc, int n, int c,
                                        int h_src, int w_src, int hw_out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * hw_out) return;
  const int b = static_cast<int>(idx / hw_out);
  const int p = static_cast<int>(idx - static_cast<long long>(b) * hw_out);

  int x0, x1, y0, y1;
  float wx, wy;
  bilinear_taps(xs[idx], w_src, x0, x1, wx);
  bilinear_taps(ys[idx], h_src, y0, y1, wy);
  const int o00 = y0 * w_src + x0, o01 = y0 * w_src + x1;
  const int o10 = y1 * w_src + x0, o11 = y1 * w_src + x1;
  const long long plane = static_cast<long long>(h_src) * w_src;

  long long gi = static_cast<long long>(b) * c * hw_out + p;
  float* d = dsrc + static_cast<long long>(b) * c * plane;
  for (int ch = 0; ch < c; ++ch, gi += hw_out, d += plane) {
    const float gv = g[gi];
    if (gv == 0.0f) continue;
    atomicAdd(d + o00, gv * (1.0f - wx) * (1.0f - wy));
    atomicAdd(d + o01, gv * wx * (1.0f - wy));
    atomicAdd(d + o10, gv * (1.0f - wx) * wy);
    atomicAdd(d + o11, gv * wx * wy);
  }
}

}  // namespace

// Plain C entry point for ctypes; d_src must be zero-filled by the caller.
// Returns the launch's cudaError_t (0 on success).
extern "C" int colvo_bilinear_scatter(const float* x, const float* y,
                                      const float* g, float* d_src, int n,
                                      int c, int h_src, int w_src, int h_out,
                                      int w_out, cudaStream_t stream) {
  const int hw_out = h_out * w_out;
  const long long total = static_cast<long long>(n) * hw_out;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  bilinear_scatter_kernel<<<blocks, threads, 0, stream>>>(x, y, g, d_src, n, c,
                                                          h_src, w_src, hw_out);
  return static_cast<int>(cudaGetLastError());
}

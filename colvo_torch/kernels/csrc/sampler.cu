// S: border-clamped bilinear sampling of C channel planes, with optional
// analytic d/dx and d/dy per channel, in one pass.
//
// Replaces the Pallas TPU kernels of colvo/kernels/sampler.py:
//   _chan_call (with_grads True/False, :658/:664; bodies _sample_grad_kernel_mc
//   :618 and _sample_kernel_mc :611 via _gather_block_mc :178) and
//   _plane_call (:700/:706; bodies _sample_grad_kernel :676 and
//   _sample_kernel :670 via _gather_block :80).
// The TPU's alternative Mosaic schedules of the same gather
// (_gather_block_mc_skipg :265, _gather_block_mc_cls :367, _gather_block_cls
// :482) compute the same function and are not separate kernels here.
//
// Bound on Hopper: bytes. Each output pixel reads its two coords once and
// four source taps per channel, and writes 1 or 3 floats per channel; the
// arithmetic is a few FMAs per byte. At the photometric shape (src
// 12x3x256x320 f32 = 11.8 MB, coords 7.9 MB, value+dx+dy 35.4 MB) the least
// time is ~16 us at 3.35 TB/s.
// Design: one thread per output pixel; the tap indices and weights are
// computed once and reused across channels. The source stays in global
// memory: a whole frame stack fits the 50 MB L2, and a smooth warp makes
// neighbouring threads read neighbouring taps, so the four gathers are
// mostly L2 hits and the DRAM traffic stays near one read of the source.
// The TPU's 128-lane / 3-group / 8-row gather schedule answers Mosaic's
// in-register gather limits, which Hopper does not have, and is not carried
// over.
//
// Layout: src (N, C, H, W) with a free batch stride, x/y (N, h, w), outputs
// (N, C, h, w), all f32. Lerp order matches colvo/geometry/ops.py:153-155
// and the gradients those of colvo/kernels/sampler.py:46-49.

#include <cstdint>

#include "bilinear.cuh"

namespace {

template <bool WITH_GRAD>
__global__ void bilinear_sample_kernel(const float* __restrict__ src,
                                       long long src_bstride,
                                       const float* __restrict__ xs,
                                       const float* __restrict__ ys,
                                       float* __restrict__ out,
                                       float* __restrict__ dxo,
                                       float* __restrict__ dyo, int n, int c,
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

  const float* s = src + b * src_bstride;
  long long o = static_cast<long long>(b) * c * hw_out + p;
  for (int ch = 0; ch < c; ++ch, s += plane, o += hw_out) {
    const float v00 = __ldg(s + o00), v01 = __ldg(s + o01);
    const float v10 = __ldg(s + o10), v11 = __ldg(s + o11);
    const float top = v00 + wx * (v01 - v00);
    const float bot = v10 + wx * (v11 - v10);
    out[o] = top + wy * (bot - top);
    if (WITH_GRAD) {
      const float dt = v01 - v00, db = v11 - v10;
      dxo[o] = dt + wy * (db - dt);
      dyo[o] = bot - top;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. dx/dy are ignored when with_grad == 0.
// Returns the launch's cudaError_t (0 on success).
extern "C" int colvo_bilinear_sample(const float* src, long long src_bstride,
                                     const float* x, const float* y, float* out,
                                     float* dx, float* dy, int n, int c,
                                     int h_src, int w_src, int h_out, int w_out,
                                     int with_grad, cudaStream_t stream) {
  const int hw_out = h_out * w_out;
  const long long total = static_cast<long long>(n) * hw_out;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (with_grad) {
    bilinear_sample_kernel<true><<<blocks, threads, 0, stream>>>(
        src, src_bstride, x, y, out, dx, dy, n, c, h_src, w_src, hw_out);
  } else {
    bilinear_sample_kernel<false><<<blocks, threads, 0, stream>>>(
        src, src_bstride, x, y, out, nullptr, nullptr, n, c, h_src, w_src, hw_out);
  }
  return static_cast<int>(cudaGetLastError());
}

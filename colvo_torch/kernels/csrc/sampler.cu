// S: border-clamped bilinear sampling of C channel planes, with optional
// analytic d/dx and d/dy per channel, in one pass.
//
// Two kernels. bilinear_sample_kernel (colvo_bilinear_sample) replaces the
// Pallas TPU kernel _chan_call of colvo/kernels/sampler.py (with_grads
// True/False, :658/:664; bodies _sample_grad_kernel_mc :618 and
// _sample_kernel_mc :611 via _gather_block_mc :178) for C > 1.
// bilinear_sample_multi_kernel (colvo_bilinear_sample_multi, below)
// replaces _plane_call (:700/:706; bodies _sample_grad_kernel :676 and
// _sample_kernel :670 via _gather_block :80) and takes every C = 1 call.
// With group > 1 bilinear_sample_kernel also replaces the grouped launch
// of _chan_call (bilinear_sample_pallas_grouped :797, source index map
// i // group :646):
// output plane i samples source frame i / group, so one launch serves the
// n_scales warps of every source frame without a repeated source stack.
// The TPU's alternative Mosaic schedules of the same gather
// (_gather_block_mc_skipg :265, _gather_block_mc_cls :367, _gather_block_cls
// :482) compute the same function and are not separate kernels here.
//
// Bound on Hopper: bytes. Each output pixel reads its two coords once and
// four source taps per channel, and writes 1 or 3 floats per channel; the
// arithmetic is a few FMAs per byte. At the photometric shape (src
// 12x3x256x320 f32 = 11.8 MB, coords 7.9 MB, value+dx+dy 35.4 MB) the least
// time is ~16 us at 3.35 TB/s.
// Design of bilinear_sample_kernel: one thread per output pixel; the tap
// indices and weights are computed once and reused across channels. The
// source stays in global memory: a whole frame stack fits the 50 MB L2,
// and a smooth warp makes neighbouring threads read neighbouring taps, so
// the four gathers are mostly L2 hits and the DRAM traffic stays near one
// read of the source. The TPU's 128-lane / 3-group / 8-row gather
// schedule answers Mosaic's in-register gather limits, which Hopper does
// not have, and is not carried over.
//
// Layout: src (N / group, C, H, W) with a free batch stride, x/y (N, h, w),
// outputs (N, C, h, w), all f32. Lerp order matches colvo/geometry/ops.py:153-155
// and the gradients those of colvo/kernels/sampler.py:46-49.
//
// Multi-plane-set entry (colvo_bilinear_sample_multi): the geometric-
// consistency depth warp, C = 1 at every geo scale, value with or without
// d/dx, d/dy (P3 _plane_call(with_grads=True) :700, P4 :706). The
// reference launches once per scale; the planes of each scale are sampled
// on their own, so one launch serves every scale of a step through a table
// of up to kMaxDescs descriptors passed by value, and a CTA finds its
// descriptor by a scan of their first blocks.
// Bound: bytes, 4 B of x and y each read and 4 B (value) or 12 B (value,
// d/dx, d/dy) written per pixel, plus the source once: at the four geo
// scales (24 planes at 256x320 .. 32x40, 2.61 M pixels) 62.7 MB with
// gradients, 18.7 us at 3.35 TB/s; 41.8 MB, 12.5 us, for the value alone.
// Design: a thread takes 4 adjacent pixels of a row, with float4
// streaming loads of x and y and float4 streaming stores of each output
// (evict-first, so that the L2 keeps the source), and keeps 16 taps in
// flight; where w_out % 4 != 0 or a pointer is not 16-byte aligned
// (the wrapper decides) the same kernel takes one pixel a thread. What
// holds it back: the four dependent tap gathers per pixel, which the L1
// and L2 serve; the small scales' partial waves, which one launch merges,
// no longer do. On the H100 two quads a thread, 128-thread CTAs and
// register caps (they spill) were slower.

#include <cstdint>

#include "bilinear.cuh"

constexpr int kMaxDescs = 8;

// One plane set of the multi-plane-set sampler. block0 is set by the entry
// point.
struct SampleDesc {
  const float* src;        // (N, C, H, W) planes, batch stride src_bstride floats
  const float* x;          // (N, h, w)
  const float* y;
  float* out;              // (N, C, h, w)
  float* dx;               // ignored without gradients
  float* dy;
  long long src_bstride;
  int n, c, h_src, w_src, h_out, w_out;
  int vec;                 // 1: four pixels a thread by float4
  int block0;              // first CTA of this descriptor
};

struct GeoParams {
  SampleDesc d[kMaxDescs];
  int n_desc;
  int with_grad;
};

namespace {

constexpr int kThreads = 256;

// Flat source offsets of the four taps of (x, y), and the fractions.
struct Taps {
  int o00, o01, o10, o11;
  float wx, wy;
};

__device__ __forceinline__ Taps make_taps(float x, float y, int h, int w) {
  Taps t;
  int x0, x1, y0, y1;
  bilinear_taps(x, w, x0, x1, t.wx);
  bilinear_taps(y, h, y0, y1, t.wy);
  t.o00 = y0 * w + x0;
  t.o01 = y0 * w + x1;
  t.o10 = y1 * w + x0;
  t.o11 = y1 * w + x1;
  return t;
}

// Value and d/dx, d/dy of one source plane at one tap set, in the lerp
// order of bilinear_sample_kernel.
template <bool WITH_GRAD>
__device__ __forceinline__ void lerp(const float* __restrict__ s, const Taps& t, float& v,
                                     float& gx, float& gy) {
  const float v00 = __ldg(s + t.o00), v01 = __ldg(s + t.o01);
  const float v10 = __ldg(s + t.o10), v11 = __ldg(s + t.o11);
  const float top = v00 + t.wx * (v01 - v00);
  const float bot = v10 + t.wx * (v11 - v10);
  v = top + t.wy * (bot - top);
  if (WITH_GRAD) {
    const float dt = v01 - v00, db = v11 - v10;
    gx = dt + t.wy * (db - dt);
    gy = bot - top;
  }
}

template <bool WITH_GRAD>
__global__ void __launch_bounds__(kThreads) bilinear_sample_multi_kernel(const GeoParams p) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxDescs; ++j)
    if (j < p.n_desc && static_cast<int>(blockIdx.x) >= p.d[j].block0) k = j;
  const SampleDesc& d = p.d[k];
  const int hw = d.h_out * d.w_out;
  const long long plane = static_cast<long long>(d.h_src) * d.w_src;
  const long long t = static_cast<long long>(blockIdx.x - d.block0) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(d.n) * hw;

  if (d.vec) {
    // Four pixels of one row (w_out % 4 == 0, so a quad never crosses
    // one); streaming loads: the coordinates are read once, the source
    // taps again and again.
    const long long px = 4 * t;
    if (px >= total) return;
    const int b = static_cast<int>(px / hw);
    const int q = static_cast<int>(px - static_cast<long long>(b) * hw);
    const float4 xv = __ldcs(reinterpret_cast<const float4*>(d.x + px));
    const float4 yv = __ldcs(reinterpret_cast<const float4*>(d.y + px));
    const Taps t0 = make_taps(xv.x, yv.x, d.h_src, d.w_src);
    const Taps t1 = make_taps(xv.y, yv.y, d.h_src, d.w_src);
    const Taps t2 = make_taps(xv.z, yv.z, d.h_src, d.w_src);
    const Taps t3 = make_taps(xv.w, yv.w, d.h_src, d.w_src);
    const float* s = d.src + b * d.src_bstride;
    long long o = static_cast<long long>(b) * d.c * hw + q;
    for (int ch = 0; ch < d.c; ++ch, s += plane, o += hw) {
      float4 v, gx, gy;
      lerp<WITH_GRAD>(s, t0, v.x, gx.x, gy.x);
      lerp<WITH_GRAD>(s, t1, v.y, gx.y, gy.y);
      lerp<WITH_GRAD>(s, t2, v.z, gx.z, gy.z);
      lerp<WITH_GRAD>(s, t3, v.w, gx.w, gy.w);
      // streaming stores: a later kernel reads the outputs, this one the
      // source
      __stcs(reinterpret_cast<float4*>(d.out + o), v);
      if (WITH_GRAD) {
        __stcs(reinterpret_cast<float4*>(d.dx + o), gx);
        __stcs(reinterpret_cast<float4*>(d.dy + o), gy);
      }
    }
    return;
  }
  if (t >= total) return;
  const int b = static_cast<int>(t / hw);
  const int q = static_cast<int>(t - static_cast<long long>(b) * hw);
  const Taps tp = make_taps(__ldcs(d.x + t), __ldcs(d.y + t), d.h_src, d.w_src);
  const float* s = d.src + b * d.src_bstride;
  long long o = static_cast<long long>(b) * d.c * hw + q;
  for (int ch = 0; ch < d.c; ++ch, s += plane, o += hw) {
    float v, gx, gy;
    lerp<WITH_GRAD>(s, tp, v, gx, gy);
    d.out[o] = v;
    if (WITH_GRAD) {
      d.dx[o] = gx;
      d.dy[o] = gy;
    }
  }
}

template <bool WITH_GRAD>
__global__ void bilinear_sample_kernel(const float* __restrict__ src,
                                       long long src_bstride,
                                       const float* __restrict__ xs,
                                       const float* __restrict__ ys,
                                       float* __restrict__ out,
                                       float* __restrict__ dxo,
                                       float* __restrict__ dyo, int n, int c,
                                       int h_src, int w_src, int hw_out,
                                       int group) {
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

  const float* s = src + (b / group) * src_bstride;
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

// Plain C entry point for ctypes. dx/dy are ignored when with_grad == 0;
// n counts output planes, and plane b samples source frame b / group.
// Returns the launch's cudaError_t (0 on success).
extern "C" int colvo_bilinear_sample(const float* src, long long src_bstride,
                                     const float* x, const float* y, float* out,
                                     float* dx, float* dy, int n, int c,
                                     int h_src, int w_src, int h_out, int w_out,
                                     int with_grad, int group,
                                     cudaStream_t stream) {
  const int hw_out = h_out * w_out;
  const long long total = static_cast<long long>(n) * hw_out;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (with_grad) {
    bilinear_sample_kernel<true><<<blocks, threads, 0, stream>>>(
        src, src_bstride, x, y, out, dx, dy, n, c, h_src, w_src, hw_out, group);
  } else {
    bilinear_sample_kernel<false><<<blocks, threads, 0, stream>>>(
        src, src_bstride, x, y, out, nullptr, nullptr, n, c, h_src, w_src, hw_out,
        group);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes: samples every descriptor's planes in one
// launch (with d/dx, d/dy when p.with_grad). The caller fills each
// descriptor but block0. Returns the launch's cudaError_t (0 on success).
extern "C" int colvo_bilinear_sample_multi(GeoParams p, cudaStream_t stream) {
  if (p.n_desc < 1 || p.n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0;
  for (int i = 0; i < p.n_desc; ++i) {
    SampleDesc& d = p.d[i];
    const long long px = static_cast<long long>(d.n) * d.h_out * d.w_out;
    d.block0 = static_cast<int>(blocks);
    blocks += ((d.vec ? px / 4 : px) + kThreads - 1) / kThreads;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p.with_grad) {
    bilinear_sample_multi_kernel<true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    bilinear_sample_multi_kernel<false><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

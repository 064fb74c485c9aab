// F: fused photometric error of a warped source frame, and its coordinate
// cotangent.
//
//   w   = bilinear sample of the source at (x, y) (border taps), 0 outside
//         the output image
//   ŵ   = a·w + b with a = clip(cov(w,t)/(var(w)+1e-4), 0.5, 2) and
//         b = μt − a·μw over an L×L window (L = 0: no LCC, ŵ = w); a and b
//         are constants to the gradient
//   e_c = α/2·(1 − SSIM3x3(ŵ, t)) + (1 − α)·|ŵ − t|,  e = mean over channels
//
// Every window statistic is a zero-padded box sum over the in-image
// overlap count nh·nw (SAME mean pooling), as in
// colvo_torch/losses/photometric.py.
//
// Replaces the Pallas TPU kernels of colvo/kernels/fused_loss.py:
//   forward  _err_planes (:275, body _fwd_kernel :189, via _block_fields
//            :122 and _ssim_moments :179)
//   backward _err_bwd (:312, body _bwd_kernel :203): cotangent of e with
//            respect to x and y only.
// The TPU's (plane, 64-row block, 16-row halo, 128-lane) schedule answers
// VMEM and lane limits and is not carried over.
//
// Design: one CTA per (frame, 16x32 output tile), looping over the frame's
// channels, so the coords are read once per pixel and channel from L1/L2
// and the channel mean happens in registers. Per channel the CTA gathers w
// and t for the tile plus a halo into shared memory (halo ⌊L/2⌋+1 forward,
// ⌊L/2⌋+2 backward), takes the window sums separably (L+L taps, not L²),
// calibrates ŵ on the tile plus 1 (forward) or 2 (backward) pixels, and
// reduces the 3x3 SSIM moments. The backward recomputes the same fields,
// forms the SSIM terms F_k = g̃·G_k/n3 with g̃ = −α/2·g/C on the tile plus
// 1 pixel, and applies the transpose of the 3x3 box mean:
//   dŵ = B3(F1) + 2ŵ·B3(F2) + t·B3(F3) + (1−α)·g/C·sign(ŵ − t),
//   gx = Σ_c a·dŵ·∂w/∂x,  gy = Σ_c a·dŵ·∂w/∂y.
// Nothing but e (forward) or gx, gy (backward) goes to device memory.
//
// Bound on Hopper: bytes, narrowly. At the training shape (12 frames x 3 x
// 256 x 320 f32) the forward moves ~35 MB (src, tgt, x, y in; e out),
// ~0.011 ms at 3.35 TB/s, and the backward ~43 MB (+ g in, gx, gy out),
// ~0.013 ms; their f32 operations with separable window sums take ~0.008
// and ~0.011 ms at 67 TFLOP/s (chip_smoke.py counts both).
//
// Layout: src (N, C, Hs, Ws) and tgt (N, C, h, w) with free batch strides
// and contiguous planes; x, y, g, e, gx, gy (N, h, w) contiguous; all f32.

#include <cstdint>

#include "bilinear.cuh"

namespace {

constexpr int TH = 16;
constexpr int TW = 32;
constexpr int THREADS = 256;
constexpr int PER_THREAD = TH * TW / THREADS;
constexpr float C1 = 1e-4f;
constexpr float C2 = 9e-4f;
constexpr float LCC_EPS = 1e-4f;

struct Params {
  const float* src;
  long long src_bstride;
  const float* tgt;
  long long tgt_bstride;
  const float* xs;
  const float* ys;
  int c, h_src, w_src, h, w;
  int lcc;     // 0: no LCC (ŵ = w)
  int lo, hi;  // the LCC window spans [i − lo, i + hi]
  float alpha;
};

// Sizes of the tile's regions: A (gathered w and t, halo ra), B (calibrated
// ŵ and a, halo rb), and the scratch for the horizontal window sums.
struct Regions {
  int ra, rb, ah, aw, bh, bw;
  __device__ Regions(int ra_, int rb_)
      : ra(ra_), rb(rb_), ah(TH + 2 * ra_), aw(TW + 2 * ra_), bh(TH + 2 * rb_),
        bw(TW + 2 * rb_) {}
};

// In-image overlap of the window [i − lo, i + hi] with [0, n).
__device__ __forceinline__ int overlap(int i, int n, int lo, int hi) {
  return min(i + hi, n - 1) - max(i - lo, 0) + 1;
}

__device__ __forceinline__ float sample(const float* s, float x, float y, int h_src,
                                        int w_src, float* dx, float* dy) {
  int x0, x1, y0, y1;
  float wx, wy;
  bilinear_taps(x, w_src, x0, x1, wx);
  bilinear_taps(y, h_src, y0, y1, wy);
  const float v00 = __ldg(s + y0 * w_src + x0), v01 = __ldg(s + y0 * w_src + x1);
  const float v10 = __ldg(s + y1 * w_src + x0), v11 = __ldg(s + y1 * w_src + x1);
  const float top = v00 + wx * (v01 - v00);
  const float bot = v10 + wx * (v11 - v10);
  if (dx != nullptr) {
    const float dt = v01 - v00, db = v11 - v10;
    *dx = dt + wy * (db - dt);
    *dy = bot - top;
  }
  return top + wy * (bot - top);
}

// Gathers w and t of channel ch over region A (zero outside the image).
__device__ void load_block(const Params& p, int b, int ch, int gy0, int gx0,
                           const Regions& g, float* sw, float* st) {
  const float* s = p.src + b * p.src_bstride + static_cast<long long>(ch) * p.h_src * p.w_src;
  const float* t = p.tgt + b * p.tgt_bstride + static_cast<long long>(ch) * p.h * p.w;
  const long long base = static_cast<long long>(b) * p.h * p.w;
  for (int k = threadIdx.x; k < g.ah * g.aw; k += THREADS) {
    const int r = k / g.aw, col = k - r * g.aw;
    const int gr = gy0 - g.ra + r, gc = gx0 - g.ra + col;
    float wv = 0.0f, tv = 0.0f;
    if (gr >= 0 && gr < p.h && gc >= 0 && gc < p.w) {
      const int q = gr * p.w + gc;
      wv = sample(s, p.xs[base + q], p.ys[base + q], p.h_src, p.w_src, nullptr, nullptr);
      tv = t[q];
    }
    sw[k] = wv;
    st[k] = tv;
  }
}

// ŵ (and a, where sa is given) over region B from w and t over region A;
// hs is scratch for the four horizontal window sums. Ends synchronised.
__device__ void calibrate(const Params& p, int gy0, int gx0, const Regions& g,
                          const float* sw, const float* st, float* hs, float* swh,
                          float* sa) {
  const int d = g.ra - g.rb;
  if (!p.lcc) {
    for (int k = threadIdx.x; k < g.bh * g.bw; k += THREADS) {
      const int i = k / g.bw, j = k - i * g.bw;
      swh[k] = sw[(i + d) * g.aw + j + d];
      if (sa != nullptr) sa[k] = 1.0f;
    }
    __syncthreads();
    return;
  }
  const int n_hs = g.ah * g.bw;
  for (int k = threadIdx.x; k < n_hs; k += THREADS) {
    const int r = k / g.bw, j = k - r * g.bw;
    const float* rw = sw + r * g.aw + j + d;
    const float* rt = st + r * g.aw + j + d;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int o = -p.lo; o <= p.hi; ++o) {
      const float wv = rw[o], tv = rt[o];
      s0 += wv;
      s1 += tv;
      s2 += wv * wv;
      s3 += wv * tv;
    }
    hs[k] = s0;
    hs[n_hs + k] = s1;
    hs[2 * n_hs + k] = s2;
    hs[3 * n_hs + k] = s3;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < g.bh * g.bw; k += THREADS) {
    const int i = k / g.bw, j = k - i * g.bw;
    const int gr = gy0 - g.rb + i, gc = gx0 - g.rb + j;
    float what = 0.0f, av = 0.0f;
    if (gr >= 0 && gr < p.h && gc >= 0 && gc < p.w) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int o = -p.lo; o <= p.hi; ++o) {
        const int q = (i + d + o) * g.bw + j;
        s0 += hs[q];
        s1 += hs[n_hs + q];
        s2 += hs[2 * n_hs + q];
        s3 += hs[3 * n_hs + q];
      }
      const float n = static_cast<float>(overlap(gr, p.h, p.lo, p.hi) *
                                         overlap(gc, p.w, p.lo, p.hi));
      const float mu_w = s0 / n, mu_t = s1 / n;
      const float var = s2 / n - mu_w * mu_w;
      const float cov = s3 / n - mu_w * mu_t;
      av = fminf(fmaxf(cov / (var + LCC_EPS), 0.5f), 2.0f);
      what = av * sw[(i + d) * g.aw + j + d] + (mu_t - av * mu_w);
    }
    swh[k] = what;
    if (sa != nullptr) sa[k] = av;
  }
  __syncthreads();
}

struct Moments {
  float n3, mx, my, sx, sy, sxy;
};

// 3x3 SSIM moments of (ŵ, t) at B index (i, j), global pixel (gr, gc).
__device__ __forceinline__ Moments moments(const Params& p, const Regions& g,
                                           const float* swh, const float* st, int i,
                                           int j, int gr, int gc) {
  const int d = g.ra - g.rb;
  float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
  for (int u = -1; u <= 1; ++u) {
    for (int v = -1; v <= 1; ++v) {
      const float xv = swh[(i + u) * g.bw + j + v];
      const float yv = st[(i + u + d) * g.aw + j + v + d];
      sx += xv;
      sy += yv;
      sxx += xv * xv;
      syy += yv * yv;
      sxy += xv * yv;
    }
  }
  Moments m;
  m.n3 = static_cast<float>(overlap(gr, p.h, 1, 1) * overlap(gc, p.w, 1, 1));
  m.mx = sx / m.n3;
  m.my = sy / m.n3;
  m.sx = sxx / m.n3 - m.mx * m.mx;
  m.sy = syy / m.n3 - m.my * m.my;
  m.sxy = sxy / m.n3 - m.mx * m.my;
  return m;
}

__global__ void __launch_bounds__(THREADS)
    fused_err_fwd_kernel(Params p, float* __restrict__ err) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, gy0 = blockIdx.y * TH, gx0 = blockIdx.x * TW;
  const Regions g(p.lcc ? p.hi + 1 : 1, 1);
  float* sw = smem;
  float* st = sw + g.ah * g.aw;
  float* swh = st + g.ah * g.aw;
  float* hs = swh + g.bh * g.bw;

  float acc_s[PER_THREAD], acc_l1[PER_THREAD];
  for (int k = 0; k < PER_THREAD; ++k) acc_s[k] = acc_l1[k] = 0.0f;

  for (int ch = 0; ch < p.c; ++ch) {
    load_block(p, b, ch, gy0, gx0, g, sw, st);
    __syncthreads();
    calibrate(p, gy0, gx0, g, sw, st, hs, swh, nullptr);
    for (int k = 0; k < PER_THREAD; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int i = idx / TW + 1, j = idx % TW + 1;  // B index of the tile pixel
      const int gr = gy0 + i - 1, gc = gx0 + j - 1;
      if (gr >= p.h || gc >= p.w) continue;
      const Moments m = moments(p, g, swh, st, i, j, gr, gc);
      const float num = (2.0f * m.mx * m.my + C1) * (2.0f * m.sxy + C2);
      const float den = (m.mx * m.mx + m.my * m.my + C1) * (m.sx + m.sy + C2);
      acc_s[k] += num / den;
      acc_l1[k] += fabsf(swh[i * g.bw + j] - st[(i + g.ra - 1) * g.aw + j + g.ra - 1]);
    }
    __syncthreads();  // the next channel overwrites shared memory
  }
  const float n_c = static_cast<float>(p.c);
  for (int k = 0; k < PER_THREAD; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int gr = gy0 + idx / TW, gc = gx0 + idx % TW;
    if (gr >= p.h || gc >= p.w) continue;
    const float s = acc_s[k] / n_c, l1 = acc_l1[k] / n_c;
    err[(static_cast<long long>(b) * p.h + gr) * p.w + gc] =
        p.alpha * 0.5f * (1.0f - s) + (1.0f - p.alpha) * l1;
  }
}

__global__ void __launch_bounds__(THREADS)
    fused_err_bwd_kernel(Params p, const float* __restrict__ gin, float* __restrict__ gx,
                         float* __restrict__ gy) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, gy0 = blockIdx.y * TH, gx0 = blockIdx.x * TW;
  const Regions g(p.lcc ? p.hi + 2 : 2, 2);
  const int c_h = TH + 2, c_w = TW + 2;  // region C: the tile plus 1 pixel
  float* sw = smem;
  float* st = sw + g.ah * g.aw;
  float* swh = st + g.ah * g.aw;
  float* sa = swh + g.bh * g.bw;
  float* hs = sa + g.bh * g.bw;  // window sums, then F1, F2, F3 over region C
  float* f1 = hs;
  float* f2 = f1 + c_h * c_w;
  float* f3 = f2 + c_h * c_w;

  const long long base = static_cast<long long>(b) * p.h * p.w;
  const float inv_c = 1.0f / static_cast<float>(p.c);
  float acc_x[PER_THREAD], acc_y[PER_THREAD];
  for (int k = 0; k < PER_THREAD; ++k) acc_x[k] = acc_y[k] = 0.0f;

  for (int ch = 0; ch < p.c; ++ch) {
    load_block(p, b, ch, gy0, gx0, g, sw, st);
    __syncthreads();
    calibrate(p, gy0, gx0, g, sw, st, hs, swh, sa);
    for (int k = threadIdx.x; k < c_h * c_w; k += THREADS) {
      const int ci = k / c_w, cj = k - ci * c_w;
      const int gr = gy0 - 1 + ci, gc = gx0 - 1 + cj;
      float v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      if (gr >= 0 && gr < p.h && gc >= 0 && gc < p.w) {
        const Moments m = moments(p, g, swh, st, ci + 1, cj + 1, gr, gc);
        const float n1 = 2.0f * m.mx * m.my + C1;
        const float n2 = 2.0f * m.sxy + C2;
        const float d1 = m.mx * m.mx + m.my * m.my + C1;
        const float d2 = m.sx + m.sy + C2;
        const float ds_dmu = (2.0f * m.my * n2 * d1 - 2.0f * m.mx * n1 * n2) / (d1 * d1 * d2);
        const float ds_dsx = -(n1 * n2) / (d1 * d2 * d2);
        const float ds_dsxy = 2.0f * n1 / (d1 * d2);
        const float gt = -(p.alpha * 0.5f) * (gin[base + gr * p.w + gc] * inv_c);
        v1 = gt * (ds_dmu - 2.0f * m.mx * ds_dsx - m.my * ds_dsxy) / m.n3;
        v2 = gt * ds_dsx / m.n3;
        v3 = gt * ds_dsxy / m.n3;
      }
      f1[k] = v1;
      f2[k] = v2;
      f3[k] = v3;
    }
    __syncthreads();
    const float* s = p.src + b * p.src_bstride + static_cast<long long>(ch) * p.h_src * p.w_src;
    for (int k = 0; k < PER_THREAD; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int ti = idx / TW, tj = idx % TW;
      const int gr = gy0 + ti, gc = gx0 + tj;
      if (gr >= p.h || gc >= p.w) continue;
      float b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
      for (int u = 0; u <= 2; ++u) {
        for (int v = 0; v <= 2; ++v) {
          const int q = (ti + u) * c_w + tj + v;
          b1 += f1[q];
          b2 += f2[q];
          b3 += f3[q];
        }
      }
      const int bi = (ti + 2) * g.bw + tj + 2;
      const float what = swh[bi];
      const float tv = st[(ti + g.ra) * g.aw + tj + g.ra];
      const float gq = gin[base + gr * p.w + gc] * inv_c;
      const float diff = what - tv;
      const float sgn = static_cast<float>((diff > 0.0f) - (diff < 0.0f));
      const float dwhat = b1 + 2.0f * what * b2 + tv * b3 + (1.0f - p.alpha) * gq * sgn;
      const float dw = sa[bi] * dwhat;
      const int q = gr * p.w + gc;
      float dx, dy;
      sample(s, p.xs[base + q], p.ys[base + q], p.h_src, p.w_src, &dx, &dy);
      acc_x[k] += dw * dx;
      acc_y[k] += dw * dy;
    }
    __syncthreads();  // the next channel overwrites shared memory
  }
  for (int k = 0; k < PER_THREAD; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int gr = gy0 + idx / TW, gc = gx0 + idx % TW;
    if (gr >= p.h || gc >= p.w) continue;
    gx[base + gr * p.w + gc] = acc_x[k];
    gy[base + gr * p.w + gc] = acc_y[k];
  }
}

// Shared memory of one CTA, in floats: w, t over A; ŵ (and a) over B; the
// four horizontal window sums over A's rows and B's columns (the backward
// reuses them for F1..F3 over the tile plus 1 pixel).
size_t smem_floats(int lcc, int hi, bool backward) {
  const int ra = (lcc ? hi + 1 : 1) + (backward ? 1 : 0);
  const int rb = backward ? 2 : 1;
  const size_t a = static_cast<size_t>(TH + 2 * ra) * (TW + 2 * ra);
  const size_t bsz = static_cast<size_t>(TH + 2 * rb) * (TW + 2 * rb);
  size_t scratch = lcc ? 4 * static_cast<size_t>(TH + 2 * ra) * (TW + 2 * rb) : 0;
  if (backward) {
    const size_t f = 3 * static_cast<size_t>(TH + 2) * (TW + 2);
    scratch = scratch > f ? scratch : f;
  }
  return 2 * a + (backward ? 2 : 1) * bsz + scratch;
}

template <typename Kernel>
int launch_config(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

Params make_params(const float* src, long long src_bstride, const float* tgt,
                   long long tgt_bstride, const float* x, const float* y, int c,
                   int h_src, int w_src, int h, int w, int window, float alpha) {
  Params p;
  p.src = src;
  p.src_bstride = src_bstride;
  p.tgt = tgt;
  p.tgt_bstride = tgt_bstride;
  p.xs = x;
  p.ys = y;
  p.c = c;
  p.h_src = h_src;
  p.w_src = w_src;
  p.h = h;
  p.w = w;
  p.lcc = window > 0;
  p.lo = window > 0 ? (window - 1) / 2 : 0;
  p.hi = window > 0 ? window - 1 - p.lo : 0;
  p.alpha = alpha;
  return p;
}

}  // namespace

// Plain C entry points for ctypes; window 0 turns LCC off. Each returns the
// launch's cudaError_t (0 on success).
extern "C" int colvo_fused_err_fwd(const float* src, long long src_bstride,
                                   const float* tgt, long long tgt_bstride,
                                   const float* x, const float* y, float* err, int n,
                                   int c, int h_src, int w_src, int h, int w, int window,
                                   float alpha, cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) return 0;
  const Params p = make_params(src, src_bstride, tgt, tgt_bstride, x, y, c, h_src, w_src,
                               h, w, window, alpha);
  const size_t bytes = smem_floats(p.lcc, p.hi, false) * sizeof(float);
  const int e = launch_config(fused_err_fwd_kernel, bytes);
  if (e != 0) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_err_fwd_kernel<<<grid, THREADS, bytes, stream>>>(p, err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int colvo_fused_err_bwd(const float* src, long long src_bstride,
                                   const float* tgt, long long tgt_bstride,
                                   const float* x, const float* y, const float* g,
                                   float* gx, float* gy, int n, int c, int h_src,
                                   int w_src, int h, int w, int window, float alpha,
                                   cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) return 0;
  const Params p = make_params(src, src_bstride, tgt, tgt_bstride, x, y, c, h_src, w_src,
                               h, w, window, alpha);
  const size_t bytes = smem_floats(p.lcc, p.hi, true) * sizeof(float);
  const int e = launch_config(fused_err_bwd_kernel, bytes);
  if (e != 0) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_err_bwd_kernel<<<grid, THREADS, bytes, stream>>>(p, g, gx, gy);
  return static_cast<int>(cudaGetLastError());
}

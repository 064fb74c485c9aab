// E: the photometric loss's SSIM+L1 error of a warped frame against its
// target, and the warp's cotangent: colvo_torch/kernels/window.py's
// photometric_error in one launch each way.
//
// It replaces no TPU kernel: the JAX package leaves the default loss's SSIM
// to XLA's reduce_window. In the port the plain path pads, permutes and
// runs PyTorch's avg_pool2d for five 3×3 means and a count plane, with some
// 60 elementwise passes around them forward and 70 more backward: ~2.7 GB
// of reads and writes a call with a gradient at the training shape (12 ×
// 256 × 320 × 3), 10 calls a default step. These kernels compute the same
// function from the frames alone.
//
// Function, per pixel and channel, over the 3×3 window with zero padding,
// each sum divided by the window's in-image count n (SAME mean pooling):
//   μw = Σŵ/n, μt = Σt/n, σw = Σŵ²/n − μw², σt = Σt²/n − μt²,
//   σwt = Σŵt/n − μw·μt
//   SSIM = (2μwμt + C1)(2σwt + C2) / ((μw² + μt² + C1)(σw + σt + C2))
//   e = mean over channels of α/2·(1 − SSIM) + (1 − α)·|ŵ − t|
// Backward (the target is data): with g̃ = −α/2·g/C and G1-G3 the SSIM's
// derivatives in μw, σw and σwt (kernel F's, csrc/fused_loss.cu), and for
// each window q its A = g̃·G1/n, B = g̃·G2/n, D = g̃·G3/n (0 outside),
//   dŵ_p = Σ_{q ∋ p} [A_q + 2B_q·(ŵ_p − μw_q) + D_q·(t_p − μt_q)]
//          + (1 − α)·g_p/C·sign(ŵ_p − t_p),
// the 3×3 transpose of kernel F's B3(F1) + 2ŵ·B3(F2) + t·B3(F3) summed
// about each window's means: in flat regions G2 grows as 1/C2, and the
// uncentred terms would cancel to a few ulp of their size.
//
// Bound on Hopper: bytes. At 12 × 256 × 320 × 3 float32 the forward reads ŵ
// and t (23.6 MB) and writes e (3.9 MB): 0.0082 ms at 3.35 TB/s; the
// backward reads ŵ, t and g (27.5 MB) and writes dŵ (11.8 MB): 0.0117 ms.
// Their ~80 and ~150 float32 operations a pixel and channel take ~0.004
// and ~0.007 ms at 67 TFLOP/s.
//
// Design. A CTA of 256 threads owns a tile of FWD_TH or BWD_TH × TW = 16 ×
// 32 output pixels of one image. It loads ŵ and t over the tile and a halo (1 pixel
// forward; 2 backward, where the windows' terms are needed on the tile and
// a 1-pixel ring) as float into shared memory, channel planes with odd
// pitches, zero outside the image (float by cp.async; bfloat16 by loads); a
// warp's loads follow the tensor's stride-1 dimension (W of a plane stack,
// C of an interleaved frame), so they coalesce. Forward: a thread per pixel
// sums its windows' five moments for each channel straight from shared
// memory (a warp reads one row of 32 columns) and writes e once. Backward:
// a thread per pixel of the ring-extended tile recomputes the moments and
// writes A, B, D, μw and μt to shared memory; then a thread per output
// element, in the output's stride-1 order, sums its 3×3 windows' terms and
// writes dŵ once. Nothing but e or dŵ goes to device memory, and nothing is
// saved between the two: the backward reads the frames again. No atomics:
// the output is the same bits on every run. At the training shape 10 × 16
// × 12 = 1,920 CTAs; 14.8 KiB (forward) and 56.7 KiB (backward) of shared
// memory a CTA at C = 3; 40 and 32 registers a thread.
// What sets the pace is the loads, not the arithmetic: at the training
// shape the forward takes ~6× and the backward ~7× its byte bound, and with
// the moments taken out ~80 % of that remains; tiles of 4, 8 or 32 rows,
// eight CTAs an SM and fast divisions were no faster (PERF.md).
//
// Layout: any strides. The images are the leading dims (at most kMaxLead
// after dropping those of size 1; the target's strides may be 0, a
// broadcast), then H, W, C; e and g are (..., H, W). Storage float or
// bfloat16, arithmetic float32.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kMaxLead = 6;

// One call: tensors and their element strides over (H, W, C) and over the
// leading dims (outermost first). out is e (forward; o_hwc[2] unused) or dŵ
// (backward); g is the backward's cotangent of e.
struct SsimArgs {
  const void* w;
  const void* t;
  const void* g;
  void* out;
  long long w_hwc[3], t_hwc[3], o_hwc[3], g_hw[2];
  long long lead[kMaxLead], w_lead[kMaxLead], t_lead[kMaxLead], o_lead[kMaxLead],
      g_lead[kMaxLead];
  int n_lead, h, w_, c;
  float alpha;
};

namespace {

constexpr int THREADS = 256;
constexpr int TW = 32;  // output columns of a tile (a warp's row)
constexpr int FWD_TH = 16;  // output rows of a forward tile
constexpr int BWD_TH = 16;  // output rows of a backward tile
constexpr float C1 = 1e-4f;
constexpr float C2 = 9e-4f;
constexpr int TERMS = 5;  // a window's backward terms: A, B, D, μw, μt

// A tile of th output rows with a halo of `halo` pixels, each channel a
// plane of odd pitch.
template <int th, int halo>
struct Tile {
  static constexpr int rows = th + 2 * halo, cols = TW + 2 * halo, pitch = cols | 1,
                       plane = rows * pitch;
};
using FwdTile = Tile<FWD_TH, 1>;   // ŵ, t forward
using BwdTile = Tile<BWD_TH, 2>;   // ŵ, t backward
using RingTile = Tile<BWD_TH, 1>;  // g and the windows' terms backward

__host__ __device__ constexpr size_t fwd_floats(int nc) { return 2 * nc * FwdTile::plane; }
__host__ __device__ constexpr size_t bwd_floats(int nc) {
  return 2 * nc * BwdTile::plane + (1 + TERMS * nc) * RingTile::plane;
}

// In-image count of the 3-wide window at i in [0, n).
__device__ __forceinline__ int overlap3(int i, int n) {
  return min(i + 1, n - 1) - max(i - 1, 0) + 1;
}

__device__ __forceinline__ float to_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Element offsets of image blockIdx.z in each tensor.
struct Image {
  long long w0, t0, o0, g0;
  __device__ explicit Image(const SsimArgs& p) {
    unsigned n = blockIdx.z;  // (the images fit a grid's z: 32-bit division)
    w0 = t0 = o0 = g0 = 0;
    for (int d = p.n_lead - 1; d >= 0; --d) {
      const unsigned size = static_cast<unsigned>(p.lead[d]);
      const long long i = n % size;
      n /= size;
      w0 += i * p.w_lead[d];
      t0 += i * p.t_lead[d];
      o0 += i * p.o_lead[d];
      g0 += i * p.g_lead[d];
    }
  }
};

// Rows [r_first, r_first + rows) × columns [c_first, c_first + cols) of nc
// channels of one image into planes [nc][rows][pitch] as float, zero
// outside the image: a warp a line, its lanes along the tensor's stride-1
// dimension (W of a plane stack or of g, C of an interleaved frame). Float
// by cp.async (complete after cp_async_wait_all), bfloat16 by loads.
template <typename T>
__device__ void load_tile(const SsimArgs& p, const T* __restrict__ src, const long long (&s)[3],
                          float* dst, int nc, int r_first, int c_first, int rows, int cols,
                          int pitch) {
  const bool interleaved = s[2] == 1 && nc > 1;
  const int plane = rows * pitch;
  const int lines = interleaved ? rows : nc * rows, len = interleaved ? cols * nc : cols;
  for (int line = threadIdx.x / 32; line < lines; line += THREADS / 32) {
    const int ch0 = interleaved ? 0 : line / rows, r = interleaved ? line : line - ch0 * rows;
    const int gr = r_first + r;
    const bool row_in = gr >= 0 && gr < p.h;
    for (int f = threadIdx.x % 32; f < len; f += 32) {
      const int j = interleaved ? f / nc : f, ch = interleaved ? f - j * nc : ch0;
      const int gc = c_first + j;
      const bool in = row_in && gc >= 0 && gc < p.w_;
      const T* at = src + (in ? gr * s[0] + gc * s[1] + ch * s[2] : 0);
      float* d = dst + ch * plane + r * pitch + j;
      if constexpr (std::is_same<T, float>::value) {
        cp_async_f32(d, at, in);
      } else {
        *d = in ? to_f(at) : 0.0f;
      }
    }
  }
}

struct Moments {
  float mw, mt, sw, st, swt;
};

// The 3×3 moments of (ŵ, t) of the window whose top-left element is at w3
// and t3 in planes of pitch `pitch`; inv_n: 1 / its in-image count.
__device__ __forceinline__ Moments moments(const float* w3, const float* t3, int pitch,
                                           float inv_n) {
  float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float x = w3[u * pitch + v], y = t3[u * pitch + v];
      sx += x;
      sy += y;
      sxx += x * x;
      syy += y * y;
      sxy += x * y;
    }
  }
  Moments m;
  m.mw = sx * inv_n;
  m.mt = sy * inv_n;
  m.sw = sxx * inv_n - m.mw * m.mw;
  m.st = syy * inv_n - m.mt * m.mt;
  m.swt = sxy * inv_n - m.mw * m.mt;
  return m;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS) ssim_err_fwd_kernel(SsimArgs p) {
  extern __shared__ float smem[];
  using G = FwdTile;
  const int nc = NC > 0 ? NC : p.c;
  const Image im(p);
  const int r0 = blockIdx.y * FWD_TH, c0 = blockIdx.x * TW;
  float* sw = smem;
  float* st = smem + nc * G::plane;
  load_tile(p, static_cast<const T*>(p.w) + im.w0, p.w_hwc, sw, nc, r0 - 1, c0 - 1, G::rows,
            G::cols, G::pitch);
  load_tile(p, static_cast<const T*>(p.t) + im.t0, p.t_hwc, st, nc, r0 - 1, c0 - 1, G::rows,
            G::cols, G::pitch);
  cp_async_wait_all();
  __syncthreads();
  T* e = static_cast<T*>(p.out) + im.o0;
  const float fc = static_cast<float>(nc);
  for (int i = threadIdx.x; i < FWD_TH * TW; i += THREADS) {
    const int r = i / TW, j = i % TW, gr = r0 + r, gc = c0 + j;
    if (gr >= p.h || gc >= p.w_) continue;
    const float inv_n = 1.0f / static_cast<float>(overlap3(gr, p.h) * overlap3(gc, p.w_));
    float s = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch) {
      const float* w3 = sw + ch * G::plane + r * G::pitch + j;
      const float* t3 = st + ch * G::plane + r * G::pitch + j;
      const Moments m = moments(w3, t3, G::pitch, inv_n);
      const float num = (2.0f * m.mw * m.mt + C1) * (2.0f * m.swt + C2);
      const float den = (m.mw * m.mw + m.mt * m.mt + C1) * (m.sw + m.st + C2);
      s += num / den;
      l1 += fabsf(w3[G::pitch + 1] - t3[G::pitch + 1]);
    }
    put(e + gr * p.o_hwc[0] + gc * p.o_hwc[1],
        p.alpha * 0.5f * (1.0f - s / fc) + (1.0f - p.alpha) * (l1 / fc));
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS) ssim_err_bwd_kernel(SsimArgs p) {
  extern __shared__ float smem[];
  using G = BwdTile;
  using R = RingTile;
  const int nc = NC > 0 ? NC : p.c;
  const Image im(p);
  const int r0 = blockIdx.y * BWD_TH, c0 = blockIdx.x * TW;
  float* sw = smem;
  float* st = sw + nc * G::plane;
  float* sg = st + nc * G::plane;
  float* sf = sg + R::plane;  // the windows' terms: [TERMS][nc][R::plane]
  const int f_stat = nc * R::plane;
  const long long g_hwc[3] = {p.g_hw[0], p.g_hw[1], 0};
  load_tile(p, static_cast<const T*>(p.w) + im.w0, p.w_hwc, sw, nc, r0 - 2, c0 - 2, G::rows,
            G::cols, G::pitch);
  load_tile(p, static_cast<const T*>(p.t) + im.t0, p.t_hwc, st, nc, r0 - 2, c0 - 2, G::rows,
            G::cols, G::pitch);
  load_tile(p, static_cast<const T*>(p.g) + im.g0, g_hwc, sg, 1, r0 - 1, c0 - 1, R::rows,
            R::cols, R::pitch);
  cp_async_wait_all();
  __syncthreads();
  const float fc = static_cast<float>(nc);
  const float g_ssim = -(p.alpha * 0.5f) / fc;
  // The terms of the windows on the tile and a 1-pixel ring: ring pixel
  // (r, j) is image pixel (r0 − 1 + r, c0 − 1 + j), its window's top-left
  // (r, j) of the planes.
  for (int i = threadIdx.x; i < R::rows * R::cols; i += THREADS) {
    const int r = i / R::cols, j = i - r * R::cols, gr = r0 - 1 + r, gc = c0 - 1 + j;
    float* fo = sf + r * R::pitch + j;
    if (gr < 0 || gr >= p.h || gc < 0 || gc >= p.w_) {
      for (int k = 0; k < TERMS * nc; ++k) fo[k * R::plane] = 0.0f;
      continue;
    }
    const float inv_n = 1.0f / static_cast<float>(overlap3(gr, p.h) * overlap3(gc, p.w_));
    const float gn = g_ssim * sg[r * R::pitch + j] * inv_n;
#pragma unroll
    for (int ch = 0; ch < nc; ++ch) {
      const Moments m = moments(sw + ch * G::plane + r * G::pitch + j,
                                st + ch * G::plane + r * G::pitch + j, G::pitch, inv_n);
      const float n1 = 2.0f * m.mw * m.mt + C1, n2 = 2.0f * m.swt + C2;
      const float d1 = m.mw * m.mw + m.mt * m.mt + C1, d2 = m.sw + m.st + C2;
      const float inv_d1 = 1.0f / d1, inv_d2 = 1.0f / d2, inv_d = inv_d1 * inv_d2;
      float* q = fo + ch * R::plane;
      q[0] = gn * ((2.0f * m.mt * n2 - 2.0f * m.mw * n1 * n2 * inv_d1) * inv_d);
      q[f_stat] = gn * (-(n1 * n2) * inv_d * inv_d2);
      q[2 * f_stat] = gn * (2.0f * n1 * inv_d);
      q[3 * f_stat] = m.mw;
      q[4 * f_stat] = m.mt;
    }
  }
  __syncthreads();
  // dŵ, a thread an output element in the output's stride-1 order.
  const bool out_interleaved = p.o_hwc[2] == 1 && nc > 1;
  T* out = static_cast<T*>(p.out) + im.o0;
  const float g_l1 = (1.0f - p.alpha) / fc;
  for (int f = threadIdx.x; f < BWD_TH * TW * nc; f += THREADS) {
    int px, ch;
    if (out_interleaved) {
      px = f / nc;
      ch = f - px * nc;
    } else {
      ch = f / (BWD_TH * TW);
      px = f - ch * (BWD_TH * TW);
    }
    const int r = px / TW, j = px % TW, gr = r0 + r, gc = c0 + j;
    if (gr >= p.h || gc >= p.w_) continue;
    const int c = ch * G::plane + (r + 2) * G::pitch + j + 2;
    const float wv = sw[c], tv = st[c], diff = wv - tv;
    const float* q3 = sf + ch * R::plane + r * R::pitch + j;  // windows of rows gr − 1 .. gr + 1
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float* q = q3 + u * R::pitch + v;
        acc += q[0] + 2.0f * q[f_stat] * (wv - q[3 * f_stat]) +
               q[2 * f_stat] * (tv - q[4 * f_stat]);
      }
    }
    const float sgn = static_cast<float>((diff > 0.0f) - (diff < 0.0f));
    put(out + gr * p.o_hwc[0] + gc * p.o_hwc[1] + ch * p.o_hwc[2],
        acc + g_l1 * sg[(r + 1) * R::pitch + j + 1] * sgn);
  }
}

using Kernel = void (*)(SsimArgs);

// Sets the kernel's shared memory and launches a CTA a tile of th rows of
// an image.
int launch(Kernel kernel, const SsimArgs& p, long long n_images, int th, size_t floats,
           cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = floats * sizeof(float);
  if (bytes > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((p.w_ + TW - 1) / TW),
                  static_cast<unsigned>((p.h + th - 1) / th), static_cast<unsigned>(n_images));
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int refuse(const SsimArgs& p, long long n_images) {
  if (n_images > 65535 || p.n_lead > kMaxLead || (p.h + FWD_TH - 1) / FWD_TH > 65535 ||
      (p.h + BWD_TH - 1) / BWD_TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes: n_images = the product of p.lead; bf16
// selects bfloat16 storage (else float). They return the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue where the channels'
// tiles cannot fit shared memory, or the images exceed a grid's 65,535).
int colvo_ssim_err_fwd(SsimArgs p, long long n_images, int bf16, cudaStream_t stream) {
  if (n_images == 0 || p.h == 0 || p.w_ == 0 || p.c == 0) return 0;
  if (const int e = refuse(p, n_images)) return e;
  const Kernel k = bf16 ? (p.c == 3 ? ssim_err_fwd_kernel<__nv_bfloat16, 3>
                                    : ssim_err_fwd_kernel<__nv_bfloat16, 0>)
                        : (p.c == 3 ? ssim_err_fwd_kernel<float, 3>
                                    : ssim_err_fwd_kernel<float, 0>);
  return launch(k, p, n_images, FWD_TH, fwd_floats(p.c), stream);
}

// Dynamic shared memory a CTA of the forward (backward = 0) or the
// backward takes at c channels, in bytes.
long long colvo_ssim_smem_bytes(int c, int backward) {
  return static_cast<long long>((backward ? bwd_floats(c) : fwd_floats(c)) * sizeof(float));
}

int colvo_ssim_err_bwd(SsimArgs p, long long n_images, int bf16, cudaStream_t stream) {
  if (n_images == 0 || p.h == 0 || p.w_ == 0 || p.c == 0) return 0;
  if (const int e = refuse(p, n_images)) return e;
  const Kernel k = bf16 ? (p.c == 3 ? ssim_err_bwd_kernel<__nv_bfloat16, 3>
                                    : ssim_err_bwd_kernel<__nv_bfloat16, 0>)
                        : (p.c == 3 ? ssim_err_bwd_kernel<float, 3>
                                    : ssim_err_bwd_kernel<float, 0>);
  return launch(k, p, n_images, BWD_TH, bwd_floats(p.c), stream);
}

}  // extern "C"

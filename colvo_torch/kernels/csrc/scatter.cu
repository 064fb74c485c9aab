// T: source cotangent of border-clamped bilinear sampling,
//   d src[r, c] = sum_p g_p * w_p over the output pixels p whose four
//   bilinear taps touch (r, c).
//
// Replaces the Pallas TPU kernel colvo/kernels/scatter.py:_scatter_call
// (:217, body _scatter_kernel :90), the backward of
// bilinear_sample_fullgrad. The TPU version walks offset classes under
// static caps (V_CAP=128 / H_CAP=160, :86-87) and drops classes beyond
// them. This kernel is exact for any warp: nothing is dropped, so the
// reference's scatter-overflow audit has nothing to count. The reference
// launches once per geo scale; the planes are independent, so one launch
// here serves every scale of a step through a table of up to kMaxDescs
// descriptors passed by value (a CTA finds its own by a scan of their
// first blocks), after one memset of the one output buffer they share.
//
// Bound on Hopper: bytes. It reads x, y and g once and writes one source
// plane per channel; at the geometric-consistency shapes (24 planes at
// 256x320, 128x160, 64x80, 32x40) that is 41.8 MB, 12.5 us at 3.35 TB/s
// (10.4 MB more, 3.1 us, for the memset).
// Design: the adds go to global memory as native float reductions
// (red.global.add.f32, resolved in L2); the kernel cuts their number. A
// warp walks down kRows rows of 32 adjacent output pixels of one plane,
// its x, y and g loaded first with streaming loads. Each step adds the
// pixel's two upper taps (row y0) and keeps its two lower taps (row y1)
// pending in registers: where the next pixel's upper taps hit the same
// two cells, the pending terms join them, else they are added on their
// own. Before a row of terms is added, each lane passes its right-hand
// term to the next lane by a shuffle where that lane's left-hand cell is
// the same one. By count, a smooth warp needs about 1.2 adds per pixel
// in place of four,
// with neighbouring lanes on neighbouring addresses; any other warp (a
// border pile-up, an out-of-bounds band, a wrapped tap for floor(x) >=
// 2^31, a diverged warp) merges less and adds up to four times a pixel,
// exactly. Pixels with g = 0 add nothing, as in the TPU kernel. Cells
// are compared by their indices, so a wrapped tap (x1 = 0 beside
// x0 = W - 1) joins only a term of the same cell. What holds it back:
// the memset, and the L2's reduction rate for the adds that remain.
// (A shared-memory variant that accumulated each tile's box of source
// cells was slower on the H100: float atomics on shared memory compile
// to a compare-and-swap loop there.)
// Float atomics add in an order that changes from run to run, so results
// differ between runs in the last bits: the kernel is not deterministic,
// and the port refuses train.deterministic=True on a CUDA device.
//
// Layout: x/y (N, h, w), g (N, C, h, w), d_src (N, C, H, W), all f32;
// plane b * C + ch of g and d_src takes the coordinates of plane b.

#include <cstdint>

#include "bilinear.cuh"

constexpr int kMaxDescs = 8;

// One plane set of the multi-plane-set scatter. The entry point sets the
// tile counts and block0.
struct ScatterDesc {
  const float* x;          // (N, h, w)
  const float* y;
  const float* g;          // (N, C, h, w)
  float* dsrc;             // (N, C, H, W), inside the buffer the entry point zeroes
  int n, c, h_src, w_src, h_out, w_out;
  int tiles_x, tiles_per_plane;  // warp tiles of kRows x 32 pixels
  int block0;              // first CTA of this descriptor
};

struct ScatterParams {
  ScatterDesc d[kMaxDescs];
  int n_desc;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a warp walks down
constexpr unsigned kFull = 0xffffffffu;

// Adds a row of terms, va at (row, xa) and vb at (row, xb) in each lane,
// after joining terms of one cell within the lane and across neighbouring
// lanes. A lane with row < 0 has nothing to add. Called by the whole warp.
__device__ __forceinline__ void add_row(float* __restrict__ dst, int w_src, int lane, int row,
                                        int xa, int xb, float va, float vb) {
  if (xa == xb) {
    va += vb;
    vb = 0.0f;
  }
  const int prow = __shfl_up_sync(kFull, row, 1);
  const int pxb = __shfl_up_sync(kFull, xb, 1);
  const float pvb = __shfl_up_sync(kFull, vb, 1);
  const int nrow = __shfl_down_sync(kFull, row, 1);
  const int nxa = __shfl_down_sync(kFull, xa, 1);
  if (row < 0) return;
  if (lane > 0 && prow == row && pxb == xa) va += pvb;     // the lane before gives vb
  if (lane < 31 && nrow == row && nxa == xb) vb = 0.0f;    // the lane after takes vb
  float* out = dst + row * w_src;
  if (va != 0.0f) atomicAdd(out + xa, va);
  if (vb != 0.0f) atomicAdd(out + xb, vb);
}

__global__ void __launch_bounds__(kThreads) bilinear_scatter_multi_kernel(const ScatterParams p) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxDescs; ++j)
    if (j < p.n_desc && static_cast<int>(blockIdx.x) >= p.d[j].block0) k = j;
  const ScatterDesc& d = p.d[k];
  const int tile = (static_cast<int>(blockIdx.x) - d.block0) * kWarps +
                   static_cast<int>(threadIdx.x) / 32;
  if (tile >= d.n * d.c * d.tiles_per_plane) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int plane = tile / d.tiles_per_plane;  // b * C + ch
  const int t = tile - plane * d.tiles_per_plane;
  const int ty = t / d.tiles_x, tx = t - ty * d.tiles_x;
  const long long hw = static_cast<long long>(d.h_out) * d.w_out;
  const float* xs = d.x + (plane / d.c) * hw;
  const float* ys = d.y + (plane / d.c) * hw;
  const float* gs = d.g + plane * hw;
  float* dst = d.dsrc + plane * static_cast<long long>(d.h_src) * d.w_src;
  const int col = tx * 32 + lane, row0 = ty * kRows;

  // The column's pixels, loaded first and streaming (read once; the L2
  // keeps the cells the adds go to); off the plane g = 0 and the taps are
  // those of (0, 0).
  float xv[kRows], yv[kRows], gv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool in = row0 + i < d.h_out && col < d.w_out;
    const int o = (row0 + i) * d.w_out + col;
    xv[i] = in ? __ldcs(xs + o) : 0.0f;
    yv[i] = in ? __ldcs(ys + o) : 0.0f;
    gv[i] = in ? __ldcs(gs + o) : 0.0f;
  }
  // The pending lower-row terms: pa at (py, pxa), pb at (py, pxb).
  int py = -1, pxa = 0, pxb = 0;
  float pa = 0.0f, pb = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    int x0, x1, y0, y1;
    float wx, wy;
    bilinear_taps(xv[i], d.w_src, x0, x1, wx);
    bilinear_taps(yv[i], d.h_src, y0, y1, wy);
    float a00 = gv[i] * (1.0f - wx) * (1.0f - wy), a01 = gv[i] * wx * (1.0f - wy);
    const float a10 = gv[i] * (1.0f - wx) * wy, a11 = gv[i] * wx * wy;
    const bool join = py == y0 && pxa == x0 && pxb == x1;
    if (join) {
      a00 += pa;
      a01 += pb;
    }
    add_row(dst, d.w_src, lane, join ? -1 : py, pxa, pxb, pa, pb);
    add_row(dst, d.w_src, lane, y0, x0, x1, a00, a01);
    py = y1, pxa = x0, pxb = x1, pa = a10, pb = a11;
  }
  add_row(dst, d.w_src, lane, py, pxa, pxb, pa, pb);
}

}  // namespace

// Plain C entry point for ctypes: zeroes out[0 .. out_floats) (the buffer
// that holds every descriptor's d_src) and scatters every descriptor in one
// launch. The caller fills each descriptor but the tile counts and block0.
// Returns the first cudaError_t (0 on success).
extern "C" int colvo_bilinear_scatter_multi(ScatterParams p, float* out, long long out_floats,
                                            cudaStream_t stream) {
  if (p.n_desc < 1 || p.n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  if (out_floats > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_floats * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long blocks = 0;
  for (int i = 0; i < p.n_desc; ++i) {
    ScatterDesc& d = p.d[i];
    d.tiles_x = (d.w_out + 31) / 32;
    d.tiles_per_plane = d.tiles_x * ((d.h_out + kRows - 1) / kRows);
    d.block0 = static_cast<int>(blocks);
    blocks += (static_cast<long long>(d.n) * d.c * d.tiles_per_plane + kWarps - 1) / kWarps;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL / kWarps) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  bilinear_scatter_multi_kernel<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

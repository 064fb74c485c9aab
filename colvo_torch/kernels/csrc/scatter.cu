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
// differ between runs in the last bits.
//
// The deterministic variant (colvo_bilinear_scatter_multi_det, chosen
// under torch.use_deterministic_algorithms(True), train.deterministic)
// gives the same bits on every run. It adds in fixed point, where addition
// is associative and so the order of the atomics does not matter:
//   1. plane_absmax_kernel: max |g| of each plane, by an integer atomicMax
//      on the bits of |g| (order-free; NaN ranks above inf above any
//      finite value);
//   2. the scatter kernel above, with the same joins in registers and
//      across lanes (their order is fixed by the code, not by timing);
//      each joined term is scaled by the plane's power of two 2^s and
//      rounded to an int64 added by a native 64-bit integer atomic
//      (red.global.add.u64). s is the largest shift for which the 4 h w
//      terms of a plane, each at most max |g|, cannot overflow 2^62;
//   3. fixed_to_float_kernel: d_src = int64 sum * 2^-s, in float32, a CTA
//      for 1024 cells of one plane.
// The quantum 2^-s is about max |g| * 2^-40 at 256x320, far below float32's
// rounding of the sums. A plane whose max |g| or any of whose terms is inf
// or NaN comes out NaN in every cell (the float kernel puts NaN only in the
// cells those terms reach); a plane with g = 0 everywhere comes out 0. It
// costs a memset of the int64 buffer and the plane maxima, a read of g
// more and the conversion pass, and 64-bit atomics in place of 32-bit ones.
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

// Where the deterministic variant adds its terms: the plane's int64
// accumulators, its fixed-point scale 2^s as two float factors (s may be
// past a float's exponent range; each factor is not, and scaling by each
// is exact), and its slot of the plane maxima, which a non-finite term
// sets to NaN.
struct FixedPoint {
  unsigned long long* acc;
  unsigned* flag;
  float scale_a, scale_b;
};

constexpr unsigned kInfBits = 0x7f800000u;  // |v| bits at or above this: inf or NaN
constexpr unsigned kNanBits = 0x7fffffffu;
constexpr int kChunk = 4 * kThreads;  // cells a CTA of the conversion pass converts

// 2^s as a float, for -126 <= s <= 127.
__device__ __forceinline__ float pow2(int s) { return __uint_as_float((s + 127u) << 23); }

// The fixed-point shift s of a plane of h_out x w_out terms, each at most
// max |g| (mb: its bits; finite, not 0): max |g| < 2^e, the 4 h w terms <
// 2^(e + f), and 2^(e + f + s) = 2^62 leaves int64 a bit of headroom. s
// lies in [-106, 185].
__device__ __forceinline__ int plane_shift(unsigned mb, int h_out, int w_out) {
  const int e = static_cast<int>(max(mb >> 23, 1u)) - 126;
  const int f = 64 - __clzll(4ull * h_out * w_out - 1);
  return 62 - e - f;
}

__device__ __forceinline__ void add_term(float* __restrict__ out, FixedPoint* fx, long long i,
                                         float v) {
  if (v == 0.0f) return;
  if (fx == nullptr) {
    atomicAdd(out + i, v);
  } else if ((__float_as_uint(v) & kInfBits) == kInfBits) {
    atomicMax(fx->flag, kNanBits);
  } else {
    const long long q = __float2ll_rn(v * fx->scale_a * fx->scale_b);
    if (q != 0) atomicAdd(fx->acc + i, static_cast<unsigned long long>(q));
  }
}

// Adds a row of terms, va at (row, xa) and vb at (row, xb) in each lane,
// after joining terms of one cell within the lane and across neighbouring
// lanes. A lane with row < 0 has nothing to add. Called by the whole warp.
// With fx, in fixed point (the deterministic variant); else to dst.
__device__ __forceinline__ void add_row(float* __restrict__ dst, FixedPoint* fx, int w_src,
                                        int lane, int row, int xa, int xb, float va, float vb) {
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
  const long long base = static_cast<long long>(row) * w_src;
  add_term(dst, fx, base + xa, va);
  add_term(dst, fx, base + xb, vb);
}

// The descriptor of CTA blockIdx.x, by a scan of the first blocks.
__device__ __forceinline__ int desc_of_block(const ScatterParams& p) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxDescs; ++j)
    if (j < p.n_desc && static_cast<int>(blockIdx.x) >= p.d[j].block0) k = j;
  return k;
}

// The first plane of descriptor k among all descriptors' planes.
__device__ __forceinline__ int first_plane(const ScatterParams& p, int k) {
  int plane0 = 0;
  for (int j = 0; j < k; ++j) plane0 += p.d[j].n * p.d[j].c;
  return plane0;
}

// kDet: the deterministic variant, adding to acc in fixed point with each
// plane's shift from pmax (plane_absmax_kernel's result).
template <bool kDet>
__global__ void __launch_bounds__(kThreads)
    bilinear_scatter_multi_kernel(const ScatterParams p, unsigned long long* __restrict__ acc,
                                  unsigned* __restrict__ pmax, const float* out_base) {
  const int k = desc_of_block(p);
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
  FixedPoint fixed, *fx = nullptr;
  if constexpr (kDet) {
    fixed.flag = pmax + first_plane(p, k) + plane;
    const unsigned mb = *fixed.flag;
    // g = 0 on the whole plane: nothing to add; inf or NaN: the plane is NaN
    if (mb == 0 || mb >= kInfBits) return;  // the whole warp
    const int shift = plane_shift(mb, d.h_out, d.w_out);
    fixed.scale_a = pow2(shift / 2);
    fixed.scale_b = pow2(shift - shift / 2);
    fixed.acc = acc + (dst - out_base);
    fx = &fixed;
  }

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
    add_row(dst, fx, d.w_src, lane, join ? -1 : py, pxa, pxb, pa, pb);
    add_row(dst, fx, d.w_src, lane, y0, x0, x1, a00, a01);
    py = y1, pxa = x0, pxb = x1, pa = a10, pb = a11;
  }
  add_row(dst, fx, d.w_src, lane, py, pxa, pxb, pa, pb);
}

// Pass 1 of the deterministic variant: the bits of max |g| of each plane
// into pmax (zeroed), over the scatter's warp tiles.
__global__ void __launch_bounds__(kThreads) plane_absmax_kernel(const ScatterParams p,
                                                                unsigned* __restrict__ pmax) {
  const int k = desc_of_block(p);
  const ScatterDesc& d = p.d[k];
  const int tile = (static_cast<int>(blockIdx.x) - d.block0) * kWarps +
                   static_cast<int>(threadIdx.x) / 32;
  if (tile >= d.n * d.c * d.tiles_per_plane) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int plane = tile / d.tiles_per_plane;
  const int t = tile - plane * d.tiles_per_plane;
  const int ty = t / d.tiles_x, tx = t - ty * d.tiles_x;
  const long long hw = static_cast<long long>(d.h_out) * d.w_out;
  const float* gs = d.g + plane * hw;
  const int col = tx * 32 + lane, row0 = ty * kRows;
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (row0 + i < d.h_out && col < d.w_out)
      m = max(m, __float_as_uint(gs[(row0 + i) * d.w_out + col]) & 0x7fffffffu);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = max(m, __shfl_down_sync(kFull, m, o));
  if (lane == 0 && m != 0) atomicMax(pmax + first_plane(p, k) + plane, m);
}

// Pass 3 of the deterministic variant: every cell of every descriptor's
// d_src from its int64 sum, kChunk cells of one plane a CTA (its plane's
// shift computed once); NaN where the plane's max |g| or a term was inf or
// NaN.
__global__ void __launch_bounds__(kThreads)
    fixed_to_float_kernel(const ScatterParams p, const long long* __restrict__ acc,
                          const unsigned* __restrict__ pmax, const float* out_base) {
  int k = 0, first = 0, plane0 = 0, chunks = 1;
  for (int j = 0; j < p.n_desc; ++j) {
    const ScatterDesc& dj = p.d[j];
    chunks = (dj.h_src * dj.w_src + kChunk - 1) / kChunk;
    const int blocks = dj.n * dj.c * chunks;
    k = j;
    if (static_cast<int>(blockIdx.x) < first + blocks) break;
    first += blocks;
    plane0 += dj.n * dj.c;
  }
  const ScatterDesc& d = p.d[k];
  const int local = static_cast<int>(blockIdx.x) - first;
  const int plane = local / chunks;
  if (plane >= d.n * d.c) return;
  const int hw = d.h_src * d.w_src;
  const unsigned mb = pmax[plane0 + plane];
  float scale_a = 0.0f, scale_b = 0.0f;  // (a plane with g = 0 everywhere is 0)
  if (mb >= kInfBits) {
    scale_a = __uint_as_float(kNanBits);
  } else if (mb != 0) {
    const int shift = -plane_shift(mb, d.h_out, d.w_out);
    scale_a = pow2(shift / 2);
    scale_b = pow2(shift - shift / 2);
  }
  float* out = d.dsrc + static_cast<long long>(plane) * hw;
  const long long* sums = acc + (out - out_base);
#pragma unroll
  for (int m = 0; m < kChunk / kThreads; ++m) {
    const int i = (local - plane * chunks) * kChunk + m * kThreads + threadIdx.x;
    if (i < hw) out[i] = __ll2float_rn(sums[i]) * scale_a * scale_b;
  }
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
  bilinear_scatter_multi_kernel<false><<<grid, kThreads, 0, stream>>>(p, nullptr, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

// The deterministic variant: the same descriptors and buffer (every cell
// of which it writes), and a workspace ws of out_floats int64 accumulators
// followed by one 32-bit slot a plane of all descriptors (zeroed here).
// Four operations on the stream: the memset of ws, the plane maxima, the
// fixed-point scatter, the conversion to float32. Returns the first
// cudaError_t (0 on success).
extern "C" int colvo_bilinear_scatter_multi_det(ScatterParams p, float* out, long long out_floats,
                                                long long* ws, cudaStream_t stream) {
  if (p.n_desc < 1 || p.n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0, planes = 0, cells = 0, fblocks = 0;
  for (int i = 0; i < p.n_desc; ++i) {
    ScatterDesc& d = p.d[i];
    // the conversion pass indexes a plane's cells with int
    if (static_cast<long long>(d.h_src) * d.w_src > 0x7fffffffLL - kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
    d.tiles_x = (d.w_out + 31) / 32;
    d.tiles_per_plane = d.tiles_x * ((d.h_out + kRows - 1) / kRows);
    d.block0 = static_cast<int>(blocks);
    blocks += (static_cast<long long>(d.n) * d.c * d.tiles_per_plane + kWarps - 1) / kWarps;
    planes += static_cast<long long>(d.n) * d.c;
    cells += static_cast<long long>(d.n) * d.c * d.h_src * d.w_src;
    fblocks += static_cast<long long>(d.n) * d.c *
               ((static_cast<long long>(d.h_src) * d.w_src + kChunk - 1) / kChunk);
  }
  if (cells != out_floats) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0x7fffffffLL / kWarps || fblocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* pmax = reinterpret_cast<unsigned*>(ws + out_floats);
  const size_t ws_bytes = out_floats * sizeof(long long) + planes * sizeof(unsigned);
  cudaError_t err = cudaMemsetAsync(ws, 0, ws_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    const unsigned grid = static_cast<unsigned>(blocks);
    plane_absmax_kernel<<<grid, kThreads, 0, stream>>>(p, pmax);
    bilinear_scatter_multi_kernel<true><<<grid, kThreads, 0, stream>>>(
        p, reinterpret_cast<unsigned long long*>(ws), pmax, out);
  }
  if (fblocks > 0) {
    const unsigned grid = static_cast<unsigned>(fblocks);
    fixed_to_float_kernel<<<grid, kThreads, 0, stream>>>(p, ws, pmax, out);
  }
  return static_cast<int>(cudaGetLastError());
}

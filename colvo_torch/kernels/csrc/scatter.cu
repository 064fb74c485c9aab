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
// first blocks).
//
// Bound on Hopper: bytes. It reads x, y and g once and writes one source
// plane per channel; at the geometric-consistency shapes (24 planes at
// 256x320, 128x160, 64x80, 32x40) that is 41.8 MB, 12.5 us at 3.35 TB/s.
//
// The float variant (colvo_bilinear_scatter_multi) zeroes the output (10.4
// MB more, 3.1 us) and adds to it in global memory by native float
// reductions (red.global.add.f32, resolved in L2); the kernel cuts their
// number. A warp walks down kRows rows of 32 adjacent output pixels of one
// plane, its x, y and g loaded first with streaming loads. Each step adds
// the pixel's two upper taps (row y0) and keeps its two lower taps (row
// y1) pending in registers: where the next pixel's upper taps hit the same
// two cells, the pending terms join them, else they are added on their
// own. Before a row of terms is added, each lane passes its right-hand
// term to the next lane by a shuffle where that lane's left-hand cell is
// the same one. By count, a smooth warp needs about 1.2 adds per pixel in
// place of four, with neighbouring lanes on neighbouring addresses; any
// other warp (a border pile-up, an out-of-bounds band, a wrapped tap for
// floor(x) >= 2^31, a diverged warp) merges less and adds up to four
// times a pixel, exactly. Cells are compared by their indices, so a
// wrapped tap (x1 = 0 beside x0 = W - 1) joins only a term of the same
// cell. Pixels with g = 0 add nothing. What holds it back: the memset, and
// the L2's reduction rate for the adds that remain. Float atomics add in
// an order that changes from run to run, so results differ between runs in
// the last bits.
//
// The deterministic variant (colvo_bilinear_scatter_multi_det, chosen
// under torch.use_deterministic_algorithms(True), train.deterministic)
// computes a function of the terms alone, whatever the schedule:
//   * each of a pixel's four terms, (g (1 - wx)) (1 - wy), (g wx) (1 - wy),
//     (g (1 - wx)) wy, (g wx) wy in float32, is scaled by its plane's 2^s
//     (two float factors, each exact) and rounded on its own to an int64
//     (__float2ll_rn, half to even); every join after that is an int64
//     add, which is exact and order-free;
//   * s is the largest shift for which the 4 h w terms of a plane, each at
//     most max |g| of the plane, cannot overflow 2^62; the quantum 2^-s is
//     about max |g| * 2^-43 at 256x320;
//   * d_src = __ll2float_rn(sum) * 2^-s; a plane whose max |g| is inf or
//     NaN, or with a pixel of g != 0 whose term is not finite (a NaN or
//     inf coordinate), is NaN in every cell; a plane with g = 0 everywhere
//     is 0. Pixels with g = 0 add nothing.
// FixedTerm holds this rule for both paths below (from_fixed the way
// back); kernels/scatter.py::scatter_plain_fixed computes the same bits in
// PyTorch.
// Design: a thread-block cluster of kCluster CTAs holds a source plane's
// int64 sums in its shared memory, so they never go to device memory. A
// plane is split into `parts` bands of rows (1, 2, 4 or 8 CTAs, the
// fewest whose bands fit kBandBytes: two CTAs an SM); a cluster holds
// kCluster / parts planes, and all descriptors go in one launch (the
// cluster shape is the same for every plane size; only `parts` changes).
// A CTA of 768 threads takes the output rows of its band's share of the
// plane, a pixel a thread at a time with the next pixel's x, y and g in
// flight. It (1) reads g of its pixels for their max |g| by the bits of
// |g| (NaN above inf above any finite value) and zeroes its band; (2) at a cluster
// barrier the plane's CTAs read each other's maxima through distributed
// shared memory, which gives every CTA the plane's shift; (3) adds each
// of a pixel's terms to the band that owns its row (taps are
// border-clamped, so every tap lands in the plane), its own or another
// CTA's of the cluster; a non-finite term flags the plane in each of its
// CTAs; (4) after a second cluster barrier it converts its band to
// float32 and writes d_src once. A sum is kept as two 32-bit halves: the
// low half's atomic add returns its old value, and its carry joins the
// high half's add. On sm_90 a 64-bit atomicAdd on shared memory compiles
// to a compare-and-swap loop, and atomics of two sizes on one word are not
// atomic to each other, so both the CTA's own adds (atom.shared) and
// another CTA's (atom.shared::cluster) use the halves. Where all four taps
// of a pixel are in the CTA's band (most pixels), the four low halves'
// atomics are issued together and then the four high halves', so their
// round trips overlap. Device-memory
// traffic at the geo shapes is 52.2 MB: x and y read once, g twice (the
// maxima and the walk, the second mostly from L2), d_src written once.
// The choices were measured on the H100 (PERF.md, section 6): the float
// kernel's warp tiles with their register and cross-lane joins, and g
// held in registers between the passes, cost more in occupancy (16 warps
// an SM at 124 registers) than they save; the compare-and-swap adds cost
// more than the halves; 768 threads a CTA (40 registers) run faster than
// 1024 (32 registers, which spill). What bounds it now: the walk's loads
// (x, y and g, at about 2.7 TB/s) and its shared-memory atomics, which
// overlap only in part; then the fixed costs (launch, zeroing, the
// barriers, and a second wave for the small scales: 36 clusters at the
// geo shapes, 30 at once).
// A plane whose band would not fit the CTA's shared memory even at 8
// CTAs (sources well above 256x320) takes the global path, chosen by
// shape in the entry point: the sums go to an int64 workspace in device
// memory by red.global.add.u64 after a memset, a pass for the plane maxima
// and a conversion pass, with the float variant's warp tiles and joins
// (the same rule, the same bits; launch key T/C1/det/global).
//
// Layout: x/y (N, h, w), g (N, C, h, w), d_src (N, C, H, W), all f32;
// plane b * C + ch of g and d_src takes the coordinates of plane b.

#include <cstdint>

#include "bilinear.cuh"
#include "cluster.cuh"

constexpr int kMaxDescs = 8;

// One plane set of the multi-plane-set scatter. The entry point sets the
// tile counts, block0 and (deterministic variant) parts and band_rows.
struct ScatterDesc {
  const float* x;          // (N, h, w)
  const float* y;
  const float* g;          // (N, C, h, w)
  float* dsrc;             // (N, C, H, W), inside the buffer the entry point fills
  int n, c, h_src, w_src, h_out, w_out;
  int tiles_x, tiles_per_plane;  // warp tiles of kRows x 32 pixels
  int block0;              // first CTA of this descriptor
  int parts, band_rows;    // CTAs a plane and source rows a CTA (cluster kernel)
};

struct ScatterParams {
  ScatterDesc d[kMaxDescs];
  int n_desc;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a warp tile walks down
constexpr unsigned kFull = 0xffffffffu;

// The cluster kernel: kDetThreads a CTA; a CTA aims to hold kBandBytes of
// sums (two CTAs an SM), and at most the card's shared memory a CTA less
// the header (or COLVO_T_SMEM_CAP, a smaller cap the tests set; they also
// set a smaller COLVO_T_BAND_BYTES, to split small planes).
#ifndef COLVO_T_BAND_BYTES
#define COLVO_T_BAND_BYTES 81920
#endif
#ifndef COLVO_T_SMEM_CAP
#define COLVO_T_SMEM_CAP (1 << 30)
#endif
constexpr int kDetThreads = 768;  // 40 registers a thread at two CTAs an SM, no spill
constexpr int kCluster = 8;
constexpr long long kBandBytes = COLVO_T_BAND_BYTES;
constexpr int kHeader = 16;  // shared bytes before the sums: [0] max |g| bits, [1] NaN flag

constexpr unsigned kInfBits = 0x7f800000u;  // |v| bits at or above this: inf or NaN
constexpr unsigned kNanBits = 0x7fffffffu;
constexpr int kChunk = 4 * kThreads;  // cells a CTA of the global conversion pass converts

// 2^s as a float, for -126 <= s <= 127.
__device__ __forceinline__ float pow2(int s) { return __uint_as_float((s + 127u) << 23); }

// The fixed-point shift s of a plane of h_out x w_out pixels, four terms
// each, each term at most max |g| (mb: its bits; finite, not 0): max |g| <
// 2^e, the 4 h w terms < 2^(e + f), and 2^(e + f + s) = 2^62 leaves int64 a
// bit of headroom. s lies in [-106, 185].
__device__ __forceinline__ int plane_shift(unsigned mb, int h_out, int w_out) {
  const int e = static_cast<int>(max(mb >> 23, 1u)) - 126;
  const int f = 64 - __clzll(4ull * h_out * w_out - 1);
  return 62 - e - f;
}

// Where the float variant adds its terms: float atomics to the plane.
struct FloatSink {
  using T = float;
  float* dst;
  int w_src;
  __device__ __forceinline__ bool pixel(float, float, float) const { return true; }
  __device__ __forceinline__ float term(float v) const { return v; }
  __device__ __forceinline__ void add(int row, int col, float v) const {
    if (v != 0.0f) atomicAdd(dst + static_cast<long long>(row) * w_src + col, v);
  }
};

// The deterministic variant's rounding of a term (§ the header), for a
// plane of shift s: scale_a = 2^(s / 2) and scale_b = 2^(s - s / 2). A
// pixel with g = 0 adds nothing; with g finite (the plane's max |g| is),
// its terms are finite unless wx or wy is not (a NaN or inf coordinate):
// then the pixel sets bad and adds nothing.
struct FixedTerm {
  using T = long long;
  float scale_a, scale_b;
  bool bad;
  __device__ __forceinline__ explicit FixedTerm(int shift)
      : scale_a(pow2(shift / 2)), scale_b(pow2(shift - shift / 2)), bad(false) {}
  __device__ __forceinline__ bool pixel(float g, float wx, float wy) {
    if (g == 0.0f) return false;
    if ((__float_as_uint(wx) & kInfBits) == kInfBits ||
        (__float_as_uint(wy) & kInfBits) == kInfBits) {
      bad = true;
      return false;
    }
    return true;
  }
  __device__ __forceinline__ long long term(float v) const {
    return __float2ll_rn(v * scale_a * scale_b);
  }
};

// The global path's sink: int64 atomics to the plane's sums in device memory.
struct GlobalFixedSink : FixedTerm {
  unsigned long long* acc;
  int w_src;
  __device__ __forceinline__ GlobalFixedSink(int shift, unsigned long long* acc, int w_src)
      : FixedTerm(shift), acc(acc), w_src(w_src) {}
  __device__ __forceinline__ void add(int row, int col, long long q) const {
    if (q != 0)
      atomicAdd(acc + static_cast<long long>(row) * w_src + col, static_cast<unsigned long long>(q));
  }
};

// The high half's part of adding q to an int64 kept as two 32-bit halves,
// once the low half's atomic add of q's low bits returned old: q's high
// bits and the carry out of the low half.
__device__ __forceinline__ unsigned high_half(long long q, unsigned old) {
  const unsigned lo = static_cast<unsigned>(q);
  return static_cast<unsigned>(static_cast<unsigned long long>(q) >> 32) + (old + lo < old ? 1u : 0u);
}

// The factors that take a plane's int64 sums back to float32 (mb: the bits
// of its max |g|): 2^-s as two factors; NaN where max |g| is inf or NaN or
// a term was not (bad), 0 where g = 0 on the whole plane.
__device__ __forceinline__ FixedTerm from_fixed(unsigned mb, bool bad, int h_out, int w_out) {
  FixedTerm back(0);
  if (mb >= kInfBits || bad) {
    back.scale_a = __uint_as_float(kNanBits);
  } else if (mb == 0) {
    back.scale_a = back.scale_b = 0.0f;
  } else {
    back = FixedTerm(-plane_shift(mb, h_out, w_out));
  }
  return back;
}

// The cluster kernel's add of q at (row, col) of a plane split into bands
// of band_rows rows: rows [r0, r0 + band_rows) are this CTA's (its sums at
// acc), the others belong to the CTA of the cluster rank0 + row /
// band_rows (rank0: the plane's first CTA, this CTA's rank less its part),
// at the same offset of its band. The owner of row r is (r + 0.5) /
// band_rows, truncated (exact in float for rows below 2^16).
__device__ __forceinline__ void cluster_fixed_add(unsigned long long* acc, int part, int band_rows,
                                                  int w_src, int row, int col, long long q) {
  if (q == 0) return;
  const int rel = row - part * band_rows;
  if (rel >= 0 && rel < band_rows) {
    unsigned* word = reinterpret_cast<unsigned*>(acc + rel * w_src + col);
    const unsigned hi = high_half(q, atomicAdd(word, static_cast<unsigned>(q)));
    if (hi != 0) atomicAdd(word + 1, hi);
  } else {
    const int owner = static_cast<int>((static_cast<float>(row) + 0.5f) /
                                       static_cast<float>(band_rows));
    const cluster_addr word = cluster_map(acc, cluster_rank() - part + owner) +
                              8u * static_cast<unsigned>((row - owner * band_rows) * w_src + col);
    const unsigned hi = high_half(q, cluster_fetch_add32(word, static_cast<unsigned>(q)));
    if (hi != 0) cluster_fetch_add32(word + 4u, hi);
  }
}

// Adds a row of terms, va at (row, xa) and vb at (row, xb) in each lane,
// after joining terms of one cell within the lane and across neighbouring
// lanes. A lane with row < 0 has nothing to add. Called by the whole warp.
template <class Sink>
__device__ __forceinline__ void add_row(Sink& s, int lane, int row, int xa, int xb,
                                        typename Sink::T va, typename Sink::T vb) {
  if (xa == xb) {
    va += vb;
    vb = 0;
  }
  const int prow = __shfl_up_sync(kFull, row, 1);
  const int pxb = __shfl_up_sync(kFull, xb, 1);
  const typename Sink::T pvb = __shfl_up_sync(kFull, vb, 1);
  const int nrow = __shfl_down_sync(kFull, row, 1);
  const int nxa = __shfl_down_sync(kFull, xa, 1);
  if (row < 0) return;
  if (lane > 0 && prow == row && pxb == xa) va += pvb;     // the lane before gives vb
  if (lane < 31 && nrow == row && nxa == xb) vb = 0;       // the lane after takes vb
  s.add(row, xa, va);
  s.add(row, xb, vb);
}

// One warp tile: each lane walks its column of kRows pixels (xv, yv, gv;
// off the plane g = 0 and the taps are those of (0, 0)), adding the
// pixel's upper taps and keeping its lower ones pending, joined with the
// next pixel's upper ones where they hit the same two cells.
template <class Sink>
__device__ __forceinline__ void walk_tile(Sink& s, int lane, int h_src, int w_src,
                                          const float (&xv)[kRows], const float (&yv)[kRows],
                                          const float (&gv)[kRows]) {
  using T = typename Sink::T;
  // The pending lower-row terms: pa at (py, pxa), pb at (py, pxb).
  int py = -1, pxa = 0, pxb = 0;
  T pa = 0, pb = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    int x0, x1, y0, y1;
    float wx, wy;
    bilinear_taps(xv[i], w_src, x0, x1, wx);
    bilinear_taps(yv[i], h_src, y0, y1, wy);
    const float g = gv[i];
    const bool take = s.pixel(g, wx, wy);
    T a00 = take ? s.term(g * (1.0f - wx) * (1.0f - wy)) : 0;
    T a01 = take ? s.term(g * wx * (1.0f - wy)) : 0;
    const T a10 = take ? s.term(g * (1.0f - wx) * wy) : 0;
    const T a11 = take ? s.term(g * wx * wy) : 0;
    const bool join = py == y0 && pxa == x0 && pxb == x1;
    if (join) {
      a00 += pa;
      a01 += pb;
    }
    add_row(s, lane, join ? -1 : py, pxa, pxb, pa, pb);
    add_row(s, lane, y0, x0, x1, a00, a01);
    py = y1, pxa = x0, pxb = x1, pa = a10, pb = a11;
  }
  add_row(s, lane, py, pxa, pxb, pa, pb);
}

// Loads the column of a warp tile (row0, col) of a plane's x, y or g, with
// streaming loads (read once); 0 off the plane.
__device__ __forceinline__ void load_column(float (&v)[kRows], const float* src, int row0,
                                            int col, int h_out, int w_out) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool in = row0 + i < h_out && col < w_out;
    v[i] = in ? __ldcs(src + (row0 + i) * w_out + col) : 0.0f;
  }
}

// The descriptor of CTA blockIdx.x, by a scan of the first blocks.
__device__ __forceinline__ int desc_of_block(const ScatterParams& p) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxDescs; ++j)
    if (j < p.n_desc && static_cast<int>(blockIdx.x) >= p.d[j].block0) k = j;
  return k;
}

// The first plane and the first cell of descriptor k among all
// descriptors' planes and cells.
__device__ __forceinline__ int first_plane(const ScatterParams& p, int k) {
  int plane0 = 0;
  for (int j = 0; j < k; ++j) plane0 += p.d[j].n * p.d[j].c;
  return plane0;
}

__device__ __forceinline__ long long first_cell(const ScatterParams& p, int k) {
  long long cell0 = 0;
  for (int j = 0; j < k; ++j)
    cell0 += static_cast<long long>(p.d[j].n) * p.d[j].c * p.d[j].h_src * p.d[j].w_src;
  return cell0;
}

// A warp tile of the grid-wide kernels (float variant and global path):
// plane, tile row and column of warp threadIdx.x / 32 of this CTA; false
// where the warp has none.
__device__ __forceinline__ bool warp_tile(const ScatterDesc& d, int& plane, int& ty, int& tx) {
  const int tile = (static_cast<int>(blockIdx.x) - d.block0) * kWarps +
                   static_cast<int>(threadIdx.x) / 32;
  if (tile >= d.n * d.c * d.tiles_per_plane) return false;
  plane = tile / d.tiles_per_plane;  // b * C + ch
  const int t = tile - plane * d.tiles_per_plane;
  ty = t / d.tiles_x;
  tx = t - ty * d.tiles_x;
  return true;
}

// The float variant: a warp tile a warp.
__global__ void __launch_bounds__(kThreads) bilinear_scatter_multi_kernel(const ScatterParams p) {
  const ScatterDesc& d = p.d[desc_of_block(p)];
  int plane, ty, tx;
  if (!warp_tile(d, plane, ty, tx)) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(d.h_out) * d.w_out;
  const int col = tx * 32 + lane, row0 = ty * kRows;
  float xv[kRows], yv[kRows], gv[kRows];
  load_column(xv, d.x + (plane / d.c) * hw, row0, col, d.h_out, d.w_out);
  load_column(yv, d.y + (plane / d.c) * hw, row0, col, d.h_out, d.w_out);
  load_column(gv, d.g + plane * hw, row0, col, d.h_out, d.w_out);
  FloatSink s{d.dsrc + plane * static_cast<long long>(d.h_src) * d.w_src, d.w_src};
  walk_tile(s, lane, d.h_src, d.w_src, xv, yv, gv);
}

// The deterministic cluster kernel (§ the header): a cluster of kCluster
// CTAs holds kCluster / parts planes of one descriptor, `parts` CTAs a
// plane. Every CTA, with a plane or without, passes both cluster barriers.
__global__ void __launch_bounds__(kDetThreads, 2) scatter_det_cluster_kernel(const ScatterParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hdr = reinterpret_cast<unsigned*>(smem);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem + kHeader);
  const ScatterDesc& d = p.d[desc_of_block(p)];
  const unsigned rank = cluster_rank();
  const int parts = d.parts;
  const int part = static_cast<int>(rank) % parts;
  const unsigned rank0 = rank - part;  // the plane's first CTA
  const int plane = (static_cast<int>(blockIdx.x) - d.block0) / kCluster * (kCluster / parts) +
                    static_cast<int>(rank) / parts;
  const bool active = plane < d.n * d.c;
  const int r0 = part * d.band_rows;
  const int cells = active ? max(min(d.h_src - r0, d.band_rows), 0) * d.w_src : 0;
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(d.h_out) * d.w_out;
  // the CTA's output pixels: its share of the plane's rows
  const int rows = (d.h_out + parts - 1) / parts;
  const int p0 = active ? min(part * rows, d.h_out) * d.w_out : 0;
  const int p1 = active ? min((part + 1) * rows, d.h_out) * d.w_out : 0;
  const float* gs = d.g + (active ? plane : 0) * hw;

  // (1) the max |g| of the CTA's pixels; the band zeroed.
  unsigned m = 0;
  for (int i = p0 + threadIdx.x; i < p1; i += kDetThreads)
    m = max(m, __float_as_uint(__ldcs(gs + i)) & kNanBits);
  if (threadIdx.x == 0) hdr[0] = hdr[1] = 0;
  for (int i = threadIdx.x; i < cells; i += kDetThreads) acc[i] = 0;
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = max(m, __shfl_down_sync(kFull, m, o));
  if (lane == 0 && m != 0) atomicMax(hdr, m);
  cluster_sync();

  // (2) the plane's max |g| from its CTAs' maxima, in every warp.
  unsigned mb = lane < parts ? cluster_load(cluster_map(hdr, rank0 + lane)) : 0u;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) mb = max(mb, __shfl_xor_sync(kFull, mb, o));

  // (3) the terms, to the bands that own their rows.
  bool bad = false;
  if (active && mb != 0 && mb < kInfBits) {
    FixedTerm t(plane_shift(mb, d.h_out, d.w_out));
    const int band_rows = d.band_rows, w_src = d.w_src, h_src = d.h_src;
    const float* xs = d.x + (plane / d.c) * hw;
    const float* ys = d.y + (plane / d.c) * hw;
    // a pixel a thread at a time, the next one's loads in flight
    int i = p0 + threadIdx.x;
    float g = 0.0f, x = 0.0f, y = 0.0f;
    if (i < p1) g = __ldcs(gs + i), x = __ldcs(xs + i), y = __ldcs(ys + i);
    for (; i < p1; i += kDetThreads) {
      const int next = i + kDetThreads;
      float gn = 0.0f, xn = 0.0f, yn = 0.0f;
      if (next < p1) gn = __ldcs(gs + next), xn = __ldcs(xs + next), yn = __ldcs(ys + next);
      int x0, x1, y0, y1;
      float wx, wy;
      bilinear_taps(x, w_src, x0, x1, wx);
      bilinear_taps(y, h_src, y0, y1, wy);
      if (t.pixel(g, wx, wy)) {
        if (static_cast<unsigned>(y0 - r0) < static_cast<unsigned>(band_rows) &&
            static_cast<unsigned>(y1 - r0) < static_cast<unsigned>(band_rows)) {
          // all four taps in this CTA's band (the common case): the four
          // low halves' atomics go out together, then the high halves'
          // (their q >> 32 is almost never 0, so they are not tested)
          const long long q00 = t.term(g * (1.0f - wx) * (1.0f - wy));
          const long long q01 = t.term(g * wx * (1.0f - wy));
          const long long q10 = t.term(g * (1.0f - wx) * wy);
          const long long q11 = t.term(g * wx * wy);
          unsigned* a0 = reinterpret_cast<unsigned*>(acc + (y0 - r0) * w_src);
          unsigned* a1 = reinterpret_cast<unsigned*>(acc + (y1 - r0) * w_src);
          const unsigned o00 = atomicAdd(a0 + 2 * x0, static_cast<unsigned>(q00));
          const unsigned o01 = atomicAdd(a0 + 2 * x1, static_cast<unsigned>(q01));
          const unsigned o10 = atomicAdd(a1 + 2 * x0, static_cast<unsigned>(q10));
          const unsigned o11 = atomicAdd(a1 + 2 * x1, static_cast<unsigned>(q11));
          atomicAdd(a0 + 2 * x0 + 1, high_half(q00, o00));
          atomicAdd(a0 + 2 * x1 + 1, high_half(q01, o01));
          atomicAdd(a1 + 2 * x0 + 1, high_half(q10, o10));
          atomicAdd(a1 + 2 * x1 + 1, high_half(q11, o11));
        } else {
          // (rounded here, not before the band test: 0.5 us faster at the
          // geo shapes on an H100)
          cluster_fixed_add(acc, part, band_rows, w_src, y0, x0,
                            t.term(g * (1.0f - wx) * (1.0f - wy)));
          cluster_fixed_add(acc, part, band_rows, w_src, y0, x1, t.term(g * wx * (1.0f - wy)));
          cluster_fixed_add(acc, part, band_rows, w_src, y1, x0, t.term(g * (1.0f - wx) * wy));
          cluster_fixed_add(acc, part, band_rows, w_src, y1, x1, t.term(g * wx * wy));
        }
      }
      g = gn, x = xn, y = yn;
    }
    bad = t.bad;
  }
  if (bad)
    for (int r = 0; r < parts; ++r) cluster_store(cluster_map(hdr + 1, rank0 + r), 1u);
  cluster_sync();

  // (4) the band to float32: NaN where the plane's max |g| or a term was
  // inf or NaN, 0 where g = 0 on the whole plane.
  if (cells == 0) return;
  const FixedTerm back = from_fixed(mb, hdr[1] != 0, d.h_out, d.w_out);
  float* out = d.dsrc + plane * static_cast<long long>(d.h_src) * d.w_src +
               static_cast<long long>(r0) * d.w_src;
  for (int i = threadIdx.x; i < cells; i += kDetThreads)
    __stcs(out + i, __ll2float_rn(static_cast<long long>(acc[i])) * back.scale_a * back.scale_b);
}

// The global path, pass 1: the bits of max |g| of each plane into pmax
// (zeroed), over the warp tiles.
__global__ void __launch_bounds__(kThreads) plane_absmax_kernel(const ScatterParams p,
                                                                unsigned* __restrict__ pmax) {
  const int k = desc_of_block(p);
  const ScatterDesc& d = p.d[k];
  int plane, ty, tx;
  if (!warp_tile(d, plane, ty, tx)) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  float gv[kRows];
  load_column(gv, d.g + plane * static_cast<long long>(d.h_out) * d.w_out, ty * kRows,
              tx * 32 + lane, d.h_out, d.w_out);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) m = max(m, __float_as_uint(gv[i]) & kNanBits);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = max(m, __shfl_down_sync(kFull, m, o));
  if (lane == 0 && m != 0) atomicMax(pmax + first_plane(p, k) + plane, m);
}

// The global path, pass 2: the terms in fixed point to the int64 sums acc
// (zeroed; descriptor after descriptor, plane after plane), with each
// plane's shift from pmax; a non-finite term sets its plane's max to NaN.
__global__ void __launch_bounds__(kThreads)
    scatter_det_global_kernel(const ScatterParams p, unsigned long long* __restrict__ acc,
                              unsigned* __restrict__ pmax) {
  const int k = desc_of_block(p);
  const ScatterDesc& d = p.d[k];
  int plane, ty, tx;
  if (!warp_tile(d, plane, ty, tx)) return;  // the whole warp
  unsigned* flag = pmax + first_plane(p, k) + plane;
  const unsigned mb = *flag;
  // g = 0 on the whole plane: nothing to add; inf or NaN: the plane is NaN
  if (mb == 0 || mb >= kInfBits) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const long long hw = static_cast<long long>(d.h_out) * d.w_out;
  const int col = tx * 32 + lane, row0 = ty * kRows;
  float xv[kRows], yv[kRows], gv[kRows];
  load_column(xv, d.x + (plane / d.c) * hw, row0, col, d.h_out, d.w_out);
  load_column(yv, d.y + (plane / d.c) * hw, row0, col, d.h_out, d.w_out);
  load_column(gv, d.g + plane * hw, row0, col, d.h_out, d.w_out);
  GlobalFixedSink s(plane_shift(mb, d.h_out, d.w_out),
                    acc + first_cell(p, k) + plane * static_cast<long long>(d.h_src) * d.w_src,
                    d.w_src);
  walk_tile(s, lane, d.h_src, d.w_src, xv, yv, gv);
  if (s.bad) atomicMax(flag, kNanBits);
}

// The global path, pass 3: every cell of every descriptor's d_src from its
// int64 sum, kChunk cells of one plane a CTA (its plane's shift computed
// once).
__global__ void __launch_bounds__(kThreads)
    fixed_to_float_kernel(const ScatterParams p, const long long* __restrict__ acc,
                          const unsigned* __restrict__ pmax) {
  int k = 0, first = 0, plane0 = 0, chunks = 1;
  long long cell0 = 0;
  for (int j = 0; j < p.n_desc; ++j) {
    const ScatterDesc& dj = p.d[j];
    chunks = (dj.h_src * dj.w_src + kChunk - 1) / kChunk;
    const int blocks = dj.n * dj.c * chunks;
    k = j;
    if (static_cast<int>(blockIdx.x) < first + blocks) break;
    first += blocks;
    plane0 += dj.n * dj.c;
    cell0 += static_cast<long long>(dj.n) * dj.c * dj.h_src * dj.w_src;
  }
  const ScatterDesc& d = p.d[k];
  const int local = static_cast<int>(blockIdx.x) - first;
  const int plane = local / chunks;
  if (plane >= d.n * d.c) return;
  const int hw = d.h_src * d.w_src;
  const FixedTerm back = from_fixed(pmax[plane0 + plane], false, d.h_out, d.w_out);
  float* out = d.dsrc + static_cast<long long>(plane) * hw;
  const long long* sums = acc + cell0 + static_cast<long long>(plane) * hw;
#pragma unroll
  for (int m = 0; m < kChunk / kThreads; ++m) {
    const int i = (local - plane * chunks) * kChunk + m * kThreads + threadIdx.x;
    if (i < hw) out[i] = __ll2float_rn(sums[i]) * back.scale_a * back.scale_b;
  }
}

// Sets each descriptor's tile counts and block0 for a grid of one warp
// tile a warp; returns the CTAs, or -1 where the grid is too large.
long long tile_grid(ScatterParams& p) {
  long long blocks = 0;
  for (int i = 0; i < p.n_desc; ++i) {
    ScatterDesc& d = p.d[i];
    d.tiles_x = (d.w_out + 31) / 32;
    d.tiles_per_plane = d.tiles_x * ((d.h_out + kRows - 1) / kRows);
    d.block0 = static_cast<int>(blocks);
    blocks += (static_cast<long long>(d.n) * d.c * d.tiles_per_plane + kWarps - 1) / kWarps;
  }
  return blocks > 0x7fffffffLL / kWarps ? -1 : blocks;
}

// The deterministic variant's plan: splits p's descriptors into those the
// cluster kernel takes (pc, with parts, band_rows and block0 set) and
// those of the global path (pg), by shape against the card's shared
// memory a CTA (max_smem); sets each of p's parts (0: the global path).
// Sets the cluster kernel's CTAs, its shared memory a CTA and the global
// path's workspace in int64 elements (its sums, then a 32-bit slot a
// plane).
void plan_det(ScatterParams& p, int max_smem, ScatterParams& pc, ScatterParams& pg,
              long long& blocks, long long& smem, long long& ws_longs) {
  pc.n_desc = pg.n_desc = 0;
  blocks = smem = 0;
  long long g_cells = 0, g_planes = 0;
  const long long cap = (max_smem < COLVO_T_SMEM_CAP ? max_smem : COLVO_T_SMEM_CAP) - kHeader;
  for (int i = 0; i < p.n_desc; ++i) {
    ScatterDesc d = p.d[i];
    const long long planes = static_cast<long long>(d.n) * d.c;
    auto band = [&](int parts) { return (d.h_src + parts - 1) / parts; };
    auto bytes = [&](int parts) { return 8LL * band(parts) * d.w_src; };
    int parts = 1;
    while (parts < kCluster && bytes(parts) > kBandBytes) parts *= 2;
    const bool fits = bytes(parts) <= cap;
    p.d[i].parts = fits ? parts : 0;
    if (fits) {
      d.parts = parts;
      d.band_rows = band(parts);
      d.block0 = static_cast<int>(blocks);
      blocks += (planes * parts + kCluster - 1) / kCluster * kCluster;
      if (kHeader + bytes(parts) > smem) smem = kHeader + bytes(parts);
      pc.d[pc.n_desc++] = d;
    } else {
      pg.d[pg.n_desc++] = d;
      g_cells += planes * d.h_src * d.w_src;
      g_planes += planes;
    }
  }
  ws_longs = pg.n_desc ? g_cells + (g_planes + 1) / 2 : 0;
}

int max_smem_optin(int& max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry point for ctypes: zeroes out[0 .. out_floats) (the buffer
// that holds every descriptor's d_src) and scatters every descriptor in one
// launch. The caller fills each descriptor but the tile counts, block0,
// parts and band_rows. Returns the first cudaError_t (0 on success).
extern "C" int colvo_bilinear_scatter_multi(ScatterParams p, float* out, long long out_floats,
                                            cudaStream_t stream) {
  if (p.n_desc < 1 || p.n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  if (out_floats > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_floats * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = tile_grid(p);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  bilinear_scatter_multi_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The deterministic variant's plan for *p: *paths gets bit 0 where the
// cluster kernel runs and bit 1 where the global path does, *ws_longs the
// int64 workspace the global path needs, *smem_bytes the cluster kernel's
// shared memory a CTA, *cluster its CTAs a cluster, and each descriptor
// its CTAs a plane (parts; 0 on the global path). Returns a cudaError_t.
extern "C" int colvo_scatter_det_plan(ScatterParams* p, int* paths, long long* ws_longs,
                                      int* smem_bytes, int* cluster) {
  if (p->n_desc < 1 || p->n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  int max_smem = 0;
  const int err = max_smem_optin(max_smem);
  if (err != 0) return err;
  ScatterParams pc, pg;
  long long blocks, smem;
  plan_det(*p, max_smem, pc, pg, blocks, smem, *ws_longs);
  *paths = (blocks > 0 ? 1 : 0) | (pg.n_desc ? 2 : 0);
  *smem_bytes = static_cast<int>(smem);
  *cluster = kCluster;
  return 0;
}

// How many clusters of the cluster kernel the card holds at once with
// smem_bytes of shared memory a CTA (into *clusters). Returns a cudaError_t.
extern "C" int colvo_scatter_det_occupancy(int smem_bytes, int* clusters) {
  return static_cast<int>(cluster_occupancy(scatter_det_cluster_kernel, kDetThreads,
                                            static_cast<size_t>(smem_bytes), kCluster,
                                            clusters));
}

// The deterministic variant: the same descriptors (every cell of their
// out_floats floats of d_src it writes) and, where the plan has a global path, a workspace
// ws of ws_longs int64 (colvo_scatter_det_plan's size; zeroed here). The
// descriptors that fit a cluster go in one launch of the cluster kernel;
// the others take the global path's memset and three passes. Returns the
// first cudaError_t (0 on success).
extern "C" int colvo_bilinear_scatter_multi_det(ScatterParams p, long long out_floats,
                                                long long* ws, long long ws_longs,
                                                cudaStream_t stream) {
  if (p.n_desc < 1 || p.n_desc > kMaxDescs) return static_cast<int>(cudaErrorInvalidValue);
  long long cells = 0;
  for (int i = 0; i < p.n_desc; ++i) {
    const ScatterDesc& d = p.d[i];
    // the kernels index a plane's cells and pixels with int
    if (static_cast<long long>(d.h_src) * d.w_src > 0x7fffffffLL - kChunk ||
        static_cast<long long>(d.h_out) * d.w_out > 0x7fffffffLL - kDetThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    cells += static_cast<long long>(d.n) * d.c * d.h_src * d.w_src;
  }
  if (cells != out_floats) return static_cast<int>(cudaErrorInvalidValue);
  int max_smem = 0;
  int err = max_smem_optin(max_smem);
  if (err != 0) return err;
  ScatterParams pc, pg;
  long long blocks, smem, need;
  plan_det(p, max_smem, pc, pg, blocks, smem, need);
  if (need > ws_longs || (need > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    err = static_cast<int>(cluster_launch(scatter_det_cluster_kernel, static_cast<unsigned>(blocks),
                                          kDetThreads, static_cast<size_t>(smem), kCluster, stream,
                                          pc));
    if (err != 0) return err;
  }
  if (pg.n_desc == 0) return 0;
  long long g_planes = 0, fblocks = 0, g_cells = 0;
  for (int i = 0; i < pg.n_desc; ++i) {
    const ScatterDesc& d = pg.d[i];
    g_planes += static_cast<long long>(d.n) * d.c;
    g_cells += static_cast<long long>(d.n) * d.c * d.h_src * d.w_src;
    fblocks += static_cast<long long>(d.n) * d.c *
               ((static_cast<long long>(d.h_src) * d.w_src + kChunk - 1) / kChunk);
  }
  const long long gblocks = tile_grid(pg);
  if (gblocks < 0 || fblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  unsigned* pmax = reinterpret_cast<unsigned*>(ws + g_cells);
  cudaError_t e = cudaMemsetAsync(ws, 0, g_cells * sizeof(long long) + g_planes * sizeof(unsigned),
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (gblocks > 0) {
    const unsigned grid = static_cast<unsigned>(gblocks);
    plane_absmax_kernel<<<grid, kThreads, 0, stream>>>(pg, pmax);
    scatter_det_global_kernel<<<grid, kThreads, 0, stream>>>(
        pg, reinterpret_cast<unsigned long long*>(ws), pmax);
  }
  if (fblocks > 0) {
    fixed_to_float_kernel<<<static_cast<unsigned>(fblocks), kThreads, 0, stream>>>(pg, ws, pmax);
  }
  return static_cast<int>(cudaGetLastError());
}

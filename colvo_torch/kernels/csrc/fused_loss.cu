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
// Block and grid. A CTA of 256 threads owns a column strip of one frame,
// TW output columns wide (64 forward, 32 backward), and a range of its
// rows, which it walks down in chunks of CHUNK = 8 rows entering the window.
// The host splits the rows so that the grid fills the card's CTA slots
// about once; at 12×3×256×320 both kernels run 240 CTAs, two per SM: the
// forward 5 strips × 4 ranges of 64 rows, the backward 10 strips × 2
// ranges of 128 rows. Each chunk's output rows lag its entering rows by
// ⌊L/2⌋ + 1 (forward) or + 2 (backward), and rings of rows in shared memory
// hold what later chunks still read. Per chunk, between barriers:
//   S1  gather: the entering rows over the strip plus a halo of
//       ra = ⌊L/2⌋ + 1 (+1 backward) columns. The bilinear taps are computed
//       once per pixel and the C channels sampled together, two pixels a
//       thread so that all their loads are in flight at once (__ldg; the
//       source planes sit in L2). w and t go into the raw ring; the
//       backward also keeps ∂w/∂x, ∂w/∂y of the strip's own pixels from
//       the same gather, so nothing is sampled twice.
//   S2  vertical window sums of (w, t, w², wt): one walker per (channel,
//       column) adds the row that enters the window and subtracts the row
//       that leaves, its four sums in registers across chunks; it sums its
//       window directly every second chunk, which bounds float32 drift.
//   S3  horizontal window sums: one thread per (row, channel, 8-column
//       segment) sums the segment's first window directly and slides it
//       (two reads per statistic and column); then a and ŵ over the strip
//       plus 1 (forward) or 2 (backward) columns, into the ŵ ring.
//   S4  forward: 3×3 SSIM moments and L1 of two neighbouring pixels a
//       thread (the four column sums serve both), e once per pixel.
//       Backward: S4a the SSIM terms F_k = g̃·G_k/n3 (g̃ = −α/2·g/C) on the
//       strip plus 1, into the F ring; S4b their 3×3 transpose,
//         dŵ = B3(F1) + 2ŵ·B3(F2) + t·B3(F3) + (1−α)·g/C·sign(ŵ − t),
//         gx = Σ_c a·dŵ·∂w/∂x,  gy = Σ_c a·dŵ·∂w/∂y.
// Windows of up to DIRECT = 4 are summed directly (as cheap as running
// sums, and as exact as the plain version where few pixels make the
// variance ill-conditioned); larger ones cost a few reads per statistic
// and output whatever L.
//
// Asynchronous loads: the next chunk's rectangular tiles (x, y, the C
// planes of t and, backward, g) come into a second stage buffer by
// cp.async (4-byte copies, zero-filled outside the image) while the
// current chunk computes. The data-dependent source gather stays __ldg.
// Nothing but e (forward) or gx, gy (backward) goes to device memory.
//
// Resources at C=3, L=15 (shared memory sized at run time for any C and
// L; the host halves TW where a large L or C would not fit): forward
// 106.9 KiB of shared memory a CTA (raw ring of 23 rows 43.7 KiB, vertical
// sums 30.4 KiB, ŵ ring 7.9 KiB, two stages 25.0 KiB), backward 98.4 KiB;
// 128 and 126 registers a thread (nvcc -Xptxas -v, sm_90a), no spills, so
// two CTAs fit an SM either way. The kernels are compiled for C=3 with
// the channel loops unrolled, and for any other count.
//
// Bound on Hopper: bytes, narrowly. At the training shape the forward
// moves ~35 MB (src, tgt, x, y in; e out), 0.0106 ms at 3.35 TB/s, and the
// backward ~43 MB (+ g in, gx, gy out), 0.0129 ms; their f32 operations
// take ~0.008 and ~0.011 ms at 67 TFLOP/s (chip_smoke.py counts both). What
// sets the pace is latency: the L2 round trips of the source gather and
// the dependent chains of the running sums between the phases' barriers.
// This is a stencil with no matrix product, so it uses no tensor cores
// (no wgmma).
//
// Layout: src (N, C, Hs, Ws) and tgt (N, C, h, w) with free batch strides
// and contiguous planes; x, y, g, e, gx, gy (N, h, w) contiguous; all f32.

#include <cstdint>

#include "bilinear.cuh"
#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FWD_TW = 64, BWD_TW = 32;  // output columns of a strip (at most)
constexpr int CHUNK = 8;                 // rows that enter the window per chunk
constexpr int SEG = 8;                   // columns of one horizontal running sum
constexpr int DIRECT = 4;                // windows up to this size are summed directly
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
  const float* g;  // backward only
  float* out0;     // e (forward) or gx (backward)
  float* out1;     // gy (backward)
  int c, h_src, w_src, h, w;
  int lcc;     // 0: no LCC (ŵ = w)
  int lo, hi;  // the LCC window spans [i − lo, i + hi]
  float alpha;
  int tw, rows;  // strip width and output rows of one CTA (set by the host)
};

// Division of small non-negative ints (n·d < 2^32) by a divisor d ≥ 2
// fixed for the launch: one multiply-high instead of an integer division.
struct Div {
  unsigned m;
  __device__ explicit Div(int d) : m(0xFFFFFFFFu / static_cast<unsigned>(d) + 1u) {}
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
  }
};

// Odd row pitch: threads that read one column of consecutive rows hit
// distinct shared-memory banks.
__host__ __device__ __forceinline__ int pitch(int n) { return n | 1; }

// The strip's geometry for nc channels and chunks of ch entering rows.
// Column spans: A (gathered w, t; halo ra), B (ŵ, a; halo rb), F (F1-F3
// and g; halo 1). Row lags behind the entering row a: ŵ row v = a − lag,
// F row v − 1, output row v − 1 (forward) or v − 2 (backward). Rings of
// rows: raw w, t; ŵ, a, F; ∂w/∂x, ∂w/∂y. Shared memory, in floats, in this
// order: w, t [ring][nc][pa]; vertical sums [4][ch][nc][pa]; ŵ and
// (backward) a [wring][nc][pb]; (backward) F1-F3 [3][wring][nc][pf] and ∂w
// [2][dring][nc][tw]; two stages of x, y [ch][ca], t [ch][nc][ca] and
// (backward) g [ch+1][cf].
struct Geo {
  int nc, ch, rb, ra, tw, ca, cb, cf, pa, pb, pf, lag, ring, wring, dring;
  __host__ __device__ Geo(const Params& p, int nc_, bool backward, int chunk) {
    nc = nc_;
    ch = chunk;
    rb = backward ? 2 : 1;
    tw = p.tw;
    ra = (p.lcc ? p.hi : 0) + rb;
    ca = tw + 2 * ra;
    cb = tw + 2 * rb;
    cf = tw + 2;
    pa = pitch(ca);
    pb = pitch(cb);
    pf = pitch(cf);
    lag = p.lcc ? p.hi : 0;
    const int vertical = p.lcc ? p.lo + p.hi + 1 : 0;  // rows before a the walkers read
    ring = (vertical > lag + 2 ? vertical : lag + 2) + ch;
    wring = ch + 2;
    dring = lag + 2 + ch;
  }
  __host__ __device__ int raw_size() const { return ring * nc * pa; }
  __host__ __device__ int vsum() const { return 2 * raw_size(); }
  __host__ __device__ int what() const { return vsum() + 4 * ch * nc * pa; }
  __host__ __device__ int what_size() const { return wring * nc * pb; }
  __host__ __device__ int fsum(bool bwd) const { return what() + (bwd ? 2 : 1) * what_size(); }
  __host__ __device__ int dxy(bool bwd) const { return fsum(bwd) + (bwd ? 3 * wring * nc * pf : 0); }
  __host__ __device__ int stage(bool bwd) const { return dxy(bwd) + (bwd ? 2 * dring * nc * tw : 0); }
  __host__ __device__ int stage_size(bool bwd) const {
    return ch * (2 + nc) * ca + (bwd ? (ch + 1) * cf : 0);
  }
  __host__ __device__ int total(bool bwd) const { return stage(bwd) + 2 * stage_size(bwd); }
};

// Slots of a ring of n rows whose row `first` sat in slot 0, for rows within
// n of `ref`: one modulo per chunk, then a compare and a select per row.
struct Ring {
  int ref, slot, n;
  __device__ Ring(int ref_, int first, int n_)
      : ref(ref_), slot(((ref_ - first) % n_ + n_) % n_), n(n_) {}
  __device__ __forceinline__ int operator()(int row) const {
    int s = slot + row - ref;
    s += s < 0 ? n : 0;
    return s >= n ? s - n : s;
  }
};

// Reciprocal by the special-function unit (~2 ulp; no IEEE slow path).
__device__ __forceinline__ float fast_rcp(float v) { return __fdividef(1.0f, v); }

// In-image overlap of the window [i − lo, i + hi] with [0, n).
__device__ __forceinline__ int overlap(int i, int n, int lo, int hi) {
  return min(i + hi, n - 1) - max(i - lo, 0) + 1;
}

// The CTA's walk: frame b, output columns [c0, c0 + tw), output rows
// [r0, r1), entering rows a_start..a_end.
struct Walk {
  int b, c0, r0, r1, a_start, a_end;
  __device__ Walk(const Params& p, const Geo& g) {
    b = blockIdx.z;
    c0 = blockIdx.x * p.tw;
    r0 = blockIdx.y * p.rows;
    r1 = min(r0 + p.rows, p.h);
    a_start = r0 - g.rb - (p.lcc ? p.lo : 0);
    a_end = r1 - 1 + g.rb + g.lag;
  }
};

// The per-CTA constants every phase needs.
template <int NC>
struct Ctx {
  Params p;
  Geo g;
  Walk k;
  Div by_ca, by_cf, by_rc, by_tw2, by_cf2;
  __device__ Ctx(const Params& p_, bool backward, int chunk)
      : p(p_), g(p_, NC > 0 ? NC : p_.c, backward, chunk), k(p, g), by_ca(g.ca), by_cf(g.cf),
        by_rc(g.ch * g.nc), by_tw2(g.tw / 2), by_cf2(g.cf / 2) {}
  __device__ __forceinline__ int nc() const { return NC > 0 ? NC : g.nc; }
};

// Starts the cp.async loads of the chunk whose first entering row is a0:
// x, y and t on its entering rows over A; g (backward) on the rows of its
// F and output rows over F.
template <int NC>
__device__ void prefetch_stage(const Ctx<NC>& x, int a0, float* st, bool backward) {
  const Params& p = x.p;
  const Geo& g = x.g;
  const long long plane = static_cast<long long>(p.h) * p.w;
  const long long base = x.k.b * plane;
  float* sx = st;
  float* sy = sx + g.ch * g.ca;
  float* stt = sy + g.ch * g.ca;
  const float* tgt = p.tgt + x.k.b * p.tgt_bstride;
  for (int i = threadIdx.x; i < g.ch * g.ca; i += THREADS) {
    const int r = x.by_ca(i), j = i - r * g.ca;
    const int gr = a0 + r, gc = x.k.c0 - g.ra + j;
    const bool in = gr >= 0 && gr < p.h && gc >= 0 && gc < p.w;
    const long long q = in ? gr * static_cast<long long>(p.w) + gc : 0;
    cp_async_f32(sx + i, p.xs + base + q, in);
    cp_async_f32(sy + i, p.ys + base + q, in);
#pragma unroll
    for (int ch = 0; ch < x.nc(); ++ch)
      cp_async_f32(stt + (r * x.nc() + ch) * g.ca + j, tgt + ch * plane + q, in);
  }
  if (backward) {
    float* sg = stt + g.ch * x.nc() * g.ca;
    const int f0 = a0 - g.lag - 2;
    for (int i = threadIdx.x; i < (g.ch + 1) * g.cf; i += THREADS) {
      const int r = x.by_cf(i), j = i - r * g.cf;
      const int gr = f0 + r, gc = x.k.c0 - 1 + j;
      const bool in = gr >= 0 && gr < p.h && gc >= 0 && gc < p.w;
      cp_async_f32(sg + i, p.g + base + (in ? gr * static_cast<long long>(p.w) + gc : 0), in);
    }
  }
  cp_async_commit();
}

// S1: the entering rows [a0, a0 + n_rows) over A: taps once, all channels;
// w, t into the raw ring; ∂w/∂x, ∂w/∂y of the strip's own columns into
// their ring (backward). A thread takes GATHER pixels at once, so that all
// their source loads of a channel are in flight together (three spill at
// the 128 registers that two CTAs an SM allow).
constexpr int GATHER = 2;

template <int NC>
__device__ void gather(const Ctx<NC>& x, int a0, int n_rows, const float* __restrict__ st,
                       float* __restrict__ rw, float* __restrict__ rt, float* __restrict__ dxy,
                       const Ring& raw_ring, const Ring& d_ring, bool backward) {
  const Params& p = x.p;
  const Geo& g = x.g;
  const float* sx = st;
  const float* sy = sx + g.ch * g.ca;
  const float* stt = sy + g.ch * g.ca;
  const long long splane = static_cast<long long>(p.h_src) * p.w_src;
  const float* s = p.src + x.k.b * p.src_bstride;
  const int d_plane = g.dring * x.nc() * g.tw;
  const int n = n_rows * g.ca;
  for (int i0 = threadIdx.x; i0 < n; i0 += GATHER * THREADS) {
    int o[GATHER][4], q[GATHER], ts[GATHER], dq[GATHER];
    float wx[GATHER], wy[GATHER];
    bool live[GATHER], in[GATHER];
#pragma unroll
    for (int b = 0; b < GATHER; ++b) {
      const int i = i0 + b * THREADS;
      live[b] = i < n;
      const int r = x.by_ca(i), j = i - r * g.ca;
      const int gr = a0 + r, gc = x.k.c0 - g.ra + j;
      in[b] = live[b] && gr >= 0 && gr < p.h && gc >= 0 && gc < p.w;
      q[b] = live[b] ? raw_ring(gr) * x.nc() * g.pa + j : 0;
      ts[b] = r * x.nc() * g.ca + j;
      const int jt = j - g.ra;
      dq[b] = backward && live[b] && jt >= 0 && jt < g.tw ? d_ring(gr) * x.nc() * g.tw + jt : -1;
      int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
      wx[b] = wy[b] = 0.0f;
      if (in[b]) {
        bilinear_taps(sx[i], p.w_src, x0, x1, wx[b]);
        bilinear_taps(sy[i], p.h_src, y0, y1, wy[b]);
      }
      o[b][0] = y0 * p.w_src + x0;
      o[b][1] = y0 * p.w_src + x1;
      o[b][2] = y1 * p.w_src + x0;
      o[b][3] = y1 * p.w_src + x1;
    }
#pragma unroll
    for (int ch = 0; ch < x.nc(); ++ch) {
      const float* sc = s + ch * splane;
      float v[GATHER][4];
#pragma unroll
      for (int b = 0; b < GATHER; ++b)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) v[b][c4] = __ldg(sc + o[b][c4]);
#pragma unroll
      for (int b = 0; b < GATHER; ++b) {
        if (!live[b]) continue;
        const float top = v[b][0] + wx[b] * (v[b][1] - v[b][0]);
        const float bot = v[b][2] + wx[b] * (v[b][3] - v[b][2]);
        rw[q[b] + ch * g.pa] = in[b] ? top + wy[b] * (bot - top) : 0.0f;
        rt[q[b] + ch * g.pa] = in[b] ? stt[ts[b] + ch * g.ca] : 0.0f;
        if (dq[b] >= 0) {
          const float dt = v[b][1] - v[b][0], db = v[b][3] - v[b][2];
          dxy[dq[b] + ch * g.tw] = in[b] ? dt + wy[b] * (db - dt) : 0.0f;
          dxy[d_plane + dq[b] + ch * g.tw] = in[b] ? bot - top : 0.0f;
        }
      }
    }
  }
}

// S2: vertical window sums (w, t, w², wt) of the ŵ rows a − lag for the
// entering rows a0..a0 + n_rows − 1, one walker per (channel, A column).
// A walker sums its window directly on a restart, then each row adds the
// row that enters and subtracts the one that leaves. Where every walker
// has a thread of its own for the whole walk (at most WALKERS a thread),
// the sums stay in registers from chunk to chunk and restart every
// RESTART chunks, which bounds the float32 drift of the running sums;
// otherwise they restart every chunk. Windows of up to DIRECT rows are
// summed directly on every row (as cheap, and as exact as the plain
// version where a few pixels make the variance ill-conditioned).
constexpr int WALKERS = 2;
constexpr int RESTART = 2;

template <int NC>
__device__ __forceinline__ void vertical(const Ctx<NC>& x, int a0, int n_rows, bool restart,
                                         const float* __restrict__ rw,
                                         const float* __restrict__ rt, float* __restrict__ vsum,
                                         const Ring& raw_ring, float (&sums)[WALKERS][4]) {
  const Params& p = x.p;
  const Geo& g = x.g;
  const int window = p.lo + p.hi + 1;
  const int n_walkers = x.nc() * g.ca;
  const bool keep = n_walkers <= WALKERS * THREADS;
  const int stat = g.ch * x.nc() * g.pa;
  const int row = x.nc() * g.pa;
#pragma unroll
  for (int m = 0; m < WALKERS; ++m) {
    for (int i = threadIdx.x + m * THREADS; i < n_walkers; i += WALKERS * THREADS) {
      const int ch = x.by_ca(i), j = i - ch * g.ca;
      const int col = ch * g.pa + j;
      float s0 = sums[m][0], s1 = sums[m][1], s2 = sums[m][2], s3 = sums[m][3];
      for (int r = 0; r < n_rows; ++r) {
        const int a = a0 + r;
        if ((r == 0 && (restart || !keep)) || window <= DIRECT) {
          s0 = s1 = s2 = s3 = 0.0f;
          for (int q = a - window + 1; q <= a; ++q) {
            const int o = raw_ring(q) * row + col;
            const float wv = rw[o], tv = rt[o];
            s0 += wv;
            s1 += tv;
            s2 += wv * wv;
            s3 += wv * tv;
          }
        } else {
          const int oi = raw_ring(a) * row + col;
          const int ol = raw_ring(a - window) * row + col;
          const float wi = rw[oi], ti = rt[oi], wl = rw[ol], tl = rt[ol];
          s0 += wi - wl;
          s1 += ti - tl;
          s2 += wi * wi - wl * wl;
          s3 += wi * ti - wl * tl;
        }
        float* v = vsum + r * row + col;
        v[0] = s0;
        v[stat] = s1;
        v[2 * stat] = s2;
        v[3 * stat] = s3;
      }
      sums[m][0] = s0;
      sums[m][1] = s1;
      sums[m][2] = s2;
      sums[m][3] = s3;
    }
  }
}

// S3: ŵ (and a) over B for the ŵ rows v0 + r that lie in [r0 − rb, r1 + rb):
// one thread per (row, channel, SEG-column segment), rows fastest, so the
// threads of a warp read one column of many rows (odd pitches: no bank
// conflicts). Each segment sums its first window directly and slides it.
template <int NC>
__device__ void calibrate(const Ctx<NC>& x, int v0, const float* rw, const float* vsum,
                          float* what, float* avec, const Ring& raw_ring, const Ring& w_ring) {
  const Params& p = x.p;
  const Geo& g = x.g;
  const int n_seg = (g.cb + SEG - 1) / SEG;
  const int n_rc = g.ch * x.nc();
  const int d = g.ra - g.rb;  // A column of B column 0
  const bool direct = p.lo + p.hi + 1 <= DIRECT;
  const int stat = n_rc * g.pa;
  for (int i = threadIdx.x; i < n_rc * n_seg; i += THREADS) {
    const int seg = x.by_rc(i), rc = i - seg * n_rc;
    const int r = rc / x.nc(), ch = rc - r * x.nc();
    const int v = v0 + r;
    if (v < x.k.r0 - g.rb || v >= x.k.r1 + g.rb) continue;
    const bool row_in = v >= 0 && v < p.h;
    const float* wrow = rw + (raw_ring(v) * x.nc() + ch) * g.pa + d;
    const int wo = (w_ring(v) * x.nc() + ch) * g.pb;
    const float* vr = vsum + rc * g.pa + d;
    const int j0 = seg * SEG, j1 = min(j0 + SEG, g.cb);
    const float nh = static_cast<float>(row_in ? overlap(v, p.h, p.lo, p.hi) : 0);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int j = j0; j < j1; ++j) {
      if (p.lcc && (j == j0 || direct)) {
        s0 = s1 = s2 = s3 = 0.0f;
        for (int o = j - p.lo; o <= j + p.hi; ++o) {
          s0 += vr[o];
          s1 += vr[stat + o];
          s2 += vr[2 * stat + o];
          s3 += vr[3 * stat + o];
        }
      } else if (p.lcc) {
        const int e = j + p.hi, l = j - p.lo - 1;
        s0 += vr[e] - vr[l];
        s1 += vr[stat + e] - vr[stat + l];
        s2 += vr[2 * stat + e] - vr[2 * stat + l];
        s3 += vr[3 * stat + e] - vr[3 * stat + l];
      }
      const int gc = x.k.c0 - g.rb + j;
      float wh = 0.0f, av = 1.0f;
      if (row_in && gc >= 0 && gc < p.w) {
        wh = wrow[j];
        if (p.lcc) {
          const float inv_n = fast_rcp(nh * static_cast<float>(overlap(gc, p.w, p.lo, p.hi)));
          const float mu_w = s0 * inv_n, mu_t = s1 * inv_n;
          const float var = s2 * inv_n - mu_w * mu_w;
          const float cov = s3 * inv_n - mu_w * mu_t;
          av = fminf(fmaxf(cov * fast_rcp(var + LCC_EPS), 0.5f), 2.0f);
          wh = av * wh + (mu_t - av * mu_w);
        }
      }
      what[wo + j] = wh;
      if (avec != nullptr) avec[wo + j] = av;
    }
  }
}

struct Moments {
  float mx, my, sx, sy, sxy;
};

// 1 / the in-image count of the 3×3 window at image pixel (gr, gc).
__device__ __forceinline__ float inv_n3(const Params& p, int gr, int gc) {
  return fast_rcp(static_cast<float>(overlap(gr, p.h, 1, 1) * overlap(gc, p.w, 1, 1)));
}

// 3×3 SSIM moments of (ŵ, t) at two neighbouring pixels of a row: w3[u]
// and t3[u] point at ŵ and t of row u − 1 of the windows, at the left
// pixel's column; the sums of the four columns serve both windows. inv_n:
// inv_n3 of each pixel.
__device__ __forceinline__ void moments2(const float* const (&w3)[3], const float* const (&t3)[3],
                                         const float (&inv_n)[2], Moments (&m)[2]) {
  float cs[4][5];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float xv = w3[u][v - 1], yv = t3[u][v - 1];
      sx += xv;
      sy += yv;
      sxx += xv * xv;
      syy += yv * yv;
      sxy += xv * yv;
    }
    cs[v][0] = sx;
    cs[v][1] = sy;
    cs[v][2] = sxx;
    cs[v][3] = syy;
    cs[v][4] = sxy;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float s5[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) s5[k] = cs[q][k] + cs[q + 1][k] + cs[q + 2][k];
    m[q].mx = s5[0] * inv_n[q];
    m[q].my = s5[1] * inv_n[q];
    m[q].sx = s5[2] * inv_n[q] - m[q].mx * m[q].mx;
    m[q].sy = s5[3] * inv_n[q] - m[q].my * m[q].my;
    m[q].sxy = s5[4] * inv_n[q] - m[q].mx * m[q].my;
  }
}

// Pointers to ŵ (B column jb) and t (A column ja) of channel 0 on the rows
// row − 1 .. row + 1.
template <int NC>
__device__ __forceinline__ void rows3(const Ctx<NC>& x, const float* what, const float* rt, int row,
                                      int jb, int ja, const Ring& raw_ring, const Ring& w_ring,
                                      const float* (&w3)[3], const float* (&t3)[3]) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    w3[u] = what + w_ring(row - 1 + u) * x.nc() * x.g.pb + jb;
    t3[u] = rt + raw_ring(row - 1 + u) * x.nc() * x.g.pa + ja;
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS) fused_err_fwd_kernel(Params params) {
  extern __shared__ float smem[];
  const Ctx<NC> x(params, false, CHUNK);
  const Params& p = x.p;
  const Geo& g = x.g;
  const Walk& k = x.k;
  float* rw = smem;
  float* rt = rw + g.raw_size();
  float* vsum = smem + g.vsum();
  float* what = smem + g.what();
  float* stages = smem + g.stage(false);
  const int stage_size = g.stage_size(false);
  if (p.lcc)
    for (int i = threadIdx.x; i < 2 * g.raw_size(); i += THREADS) rw[i] = 0.0f;
  const float inv_c = 1.0f / static_cast<float>(x.nc());
  float sums[WALKERS][4] = {};  // the vertical walkers' running sums

  prefetch_stage(x, k.a_start, stages, false);
  for (int n = 0, a0 = k.a_start; a0 <= k.a_end; ++n, a0 += CHUNK) {
    cp_async_wait_all();
    __syncthreads();
    const float* st = stages + (n & 1) * stage_size;
    if (a0 + CHUNK <= k.a_end)
      prefetch_stage(x, a0 + CHUNK, stages + ((n + 1) & 1) * stage_size, false);
    const int n_rows = min(CHUNK, k.a_end - a0 + 1);
    const int v0 = a0 - g.lag;
    const Ring raw_ring(a0, k.a_start, g.ring), w_ring(v0, k.a_start, g.wring);
    gather(x, a0, n_rows, st, rw, rt, nullptr, raw_ring, raw_ring, false);
    __syncthreads();
    if (p.lcc) {
      vertical(x, a0, n_rows, n % RESTART == 0, rw, rt, vsum, raw_ring, sums);
      __syncthreads();
    }
    calibrate(x, v0, rw, vsum, what, nullptr, raw_ring, w_ring);
    __syncthreads();
    // S4: output rows o = v0 − 1 + r, two neighbouring pixels a thread.
    for (int i = threadIdx.x; i < CHUNK * (g.tw / 2); i += THREADS) {
      const int r = x.by_tw2(i), jt = 2 * (i - r * (g.tw / 2));
      const int o = v0 - 1 + r, gc = k.c0 + jt;
      if (o < k.r0 || o >= k.r1 || gc >= p.w) continue;
      const float* w3[3];
      const float* t3[3];
      rows3(x, what, rt, o, jt + g.rb, jt + g.ra, raw_ring, w_ring, w3, t3);
      const float inv_n[2] = {inv_n3(p, o, gc), gc + 1 < p.w ? inv_n3(p, o, gc + 1) : 0.0f};
      float acc_s[2] = {0.0f, 0.0f}, acc_l1[2] = {0.0f, 0.0f};
#pragma unroll
      for (int ch = 0; ch < x.nc(); ++ch) {
        const float* wp[3] = {w3[0] + ch * g.pb, w3[1] + ch * g.pb, w3[2] + ch * g.pb};
        const float* tp[3] = {t3[0] + ch * g.pa, t3[1] + ch * g.pa, t3[2] + ch * g.pa};
        Moments m[2];
        moments2(wp, tp, inv_n, m);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float num = (2.0f * m[q].mx * m[q].my + C1) * (2.0f * m[q].sxy + C2);
          const float den = (m[q].mx * m[q].mx + m[q].my * m[q].my + C1) * (m[q].sx + m[q].sy + C2);
          acc_s[q] += __fdividef(num, den);
          acc_l1[q] += fabsf(wp[1][q] - tp[1][q]);
        }
      }
      float* e = p.out0 + (static_cast<long long>(k.b) * p.h + o) * p.w + gc;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (gc + q < p.w)
          e[q] = p.alpha * 0.5f * (1.0f - acc_s[q] * inv_c) + (1.0f - p.alpha) * (acc_l1[q] * inv_c);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(THREADS) fused_err_bwd_kernel(Params params) {
  extern __shared__ float smem[];
  const Ctx<NC> x(params, true, CHUNK);
  const Params& p = x.p;
  const Geo& g = x.g;
  const Walk& k = x.k;
  float* rw = smem;
  float* rt = rw + g.raw_size();
  float* vsum = smem + g.vsum();
  float* what = smem + g.what();
  float* avec = what + g.what_size();
  float* fsum = smem + g.fsum(true);
  float* dxy = smem + g.dxy(true);
  float* stages = smem + g.stage(true);
  const int stage_size = g.stage_size(true);
  const int f_stat = g.wring * x.nc() * g.pf;
  const int d_plane = g.dring * x.nc() * g.tw;
  if (p.lcc)
    for (int i = threadIdx.x; i < 2 * g.raw_size(); i += THREADS) rw[i] = 0.0f;
  const float inv_c = 1.0f / static_cast<float>(x.nc());
  float sums[WALKERS][4] = {};  // the vertical walkers' running sums
  const long long base = static_cast<long long>(k.b) * p.h * p.w;

  prefetch_stage(x, k.a_start, stages, true);
  for (int n = 0, a0 = k.a_start; a0 <= k.a_end; ++n, a0 += CHUNK) {
    cp_async_wait_all();
    __syncthreads();
    const float* st = stages + (n & 1) * stage_size;
    const float* sg = st + CHUNK * (2 + x.nc()) * g.ca;  // g on rows v0 − 2 .. v0 + CHUNK − 2
    if (a0 + CHUNK <= k.a_end)
      prefetch_stage(x, a0 + CHUNK, stages + ((n + 1) & 1) * stage_size, true);
    const int n_rows = min(CHUNK, k.a_end - a0 + 1);
    const int v0 = a0 - g.lag;
    const Ring raw_ring(a0, k.a_start, g.ring), w_ring(v0, k.a_start, g.wring),
        d_ring(a0, k.a_start, g.dring);
    gather(x, a0, n_rows, st, rw, rt, dxy, raw_ring, d_ring, true);
    __syncthreads();
    if (p.lcc) {
      vertical(x, a0, n_rows, n % RESTART == 0, rw, rt, vsum, raw_ring, sums);
      __syncthreads();
    }
    calibrate(x, v0, rw, vsum, what, avec, raw_ring, w_ring);
    __syncthreads();
    // S4a: F1-F3 on rows f = v0 − 1 + r, columns c0 − 1 + jf, into their
    // ring (the output rows read F of rows o − 1 .. o + 1); two neighbouring
    // pixels a thread.
    for (int i = threadIdx.x; i < CHUNK * (g.cf / 2); i += THREADS) {
      const int r = x.by_cf2(i), jf = 2 * (i - r * (g.cf / 2));
      const int f = v0 - 1 + r, gc = k.c0 - 1 + jf;
      if (f < k.r0 - 1 || f > k.r1) continue;
      bool in[2];
      float gt[2], inv_n[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        in[q] = f >= 0 && f < p.h && gc + q >= 0 && gc + q < p.w;
        gt[q] = -(p.alpha * 0.5f) * (sg[(r + 1) * g.cf + jf + q] * inv_c);
        inv_n[q] = in[q] ? inv_n3(p, f, gc + q) : 0.0f;
      }
      const float* w3[3];
      const float* t3[3];
      rows3(x, what, rt, f, jf + 1, jf - 1 + g.ra, raw_ring, w_ring, w3, t3);
      float* fo = fsum + w_ring(f) * x.nc() * g.pf + jf;
#pragma unroll
      for (int ch = 0; ch < x.nc(); ++ch) {
        const float* wp[3] = {w3[0] + ch * g.pb, w3[1] + ch * g.pb, w3[2] + ch * g.pb};
        const float* tp[3] = {t3[0] + ch * g.pa, t3[1] + ch * g.pa, t3[2] + ch * g.pa};
        Moments m[2];
        moments2(wp, tp, inv_n, m);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float n1 = 2.0f * m[q].mx * m[q].my + C1;
          const float n2 = 2.0f * m[q].sxy + C2;
          const float d1 = m[q].mx * m[q].mx + m[q].my * m[q].my + C1;
          const float d2 = m[q].sx + m[q].sy + C2;
          const float inv_d1 = fast_rcp(d1), inv_d2 = fast_rcp(d2);
          const float inv_d = inv_d1 * inv_d2;  // ∂SSIM/∂μx, σx², σxy over 1/(d1·d2)
          const float ds_dmu = (2.0f * m[q].my * n2 - 2.0f * m[q].mx * n1 * n2 * inv_d1) * inv_d;
          const float ds_dsx = -(n1 * n2) * inv_d * inv_d2;
          const float ds_dsxy = 2.0f * n1 * inv_d;
          const float gn = gt[q] * inv_n[q];
          const float v1 = gn * (ds_dmu - 2.0f * m[q].mx * ds_dsx - m[q].my * ds_dsxy);
          fo[ch * g.pf + q] = in[q] ? v1 : 0.0f;
          fo[f_stat + ch * g.pf + q] = in[q] ? gn * ds_dsx : 0.0f;
          fo[2 * f_stat + ch * g.pf + q] = in[q] ? gn * ds_dsxy : 0.0f;
        }
      }
    }
    __syncthreads();
    // S4b: output rows o = v0 − 2 + r, two neighbouring pixels a thread.
    for (int i = threadIdx.x; i < CHUNK * (g.tw / 2); i += THREADS) {
      const int r = x.by_tw2(i), jt = 2 * (i - r * (g.tw / 2));
      const int o = v0 - 2 + r, gc = k.c0 + jt;
      if (o < k.r0 || o >= k.r1 || gc >= p.w) continue;
      const int bo = w_ring(o) * x.nc() * g.pb + jt + g.rb;
      const float* tq = rt + raw_ring(o) * x.nc() * g.pa + jt + g.ra;
      const float* dq = dxy + d_ring(o) * x.nc() * g.tw + jt;
      const float* fr[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) fr[u] = fsum + w_ring(o - 1 + u) * x.nc() * g.pf + jt;
      float gq[2], acc_x[2] = {0.0f, 0.0f}, acc_y[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 2; ++q) gq[q] = sg[r * g.cf + jt + 1 + q] * inv_c;
#pragma unroll
      for (int ch = 0; ch < x.nc(); ++ch) {
        float cs[4][3];  // F1-F3 summed over rows o − 1 .. o + 1, columns jt − 1 .. jt + 2
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) {
            const int off = kk * f_stat + ch * g.pf + v;
            cs[v][kk] = fr[0][off] + fr[1][off] + fr[2][off];
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float b1 = cs[q][0] + cs[q + 1][0] + cs[q + 2][0];
          const float b2 = cs[q][1] + cs[q + 1][1] + cs[q + 2][1];
          const float b3 = cs[q][2] + cs[q + 1][2] + cs[q + 2][2];
          const float wh = what[bo + ch * g.pb + q];
          const float tv = tq[ch * g.pa + q];
          const float diff = wh - tv;
          const float sgn = static_cast<float>((diff > 0.0f) - (diff < 0.0f));
          const float dwhat = b1 + 2.0f * wh * b2 + tv * b3 + (1.0f - p.alpha) * gq[q] * sgn;
          const float dw = avec[bo + ch * g.pb + q] * dwhat;
          acc_x[q] += dw * dq[ch * g.tw + q];
          acc_y[q] += dw * dq[d_plane + ch * g.tw + q];
        }
      }
      const long long out = base + o * static_cast<long long>(p.w) + gc;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (gc + q < p.w) {
          p.out0[out + q] = acc_x[q];
          p.out1[out + q] = acc_y[q];
        }
      }
    }
  }
}

Params make_params(const float* src, long long src_bstride, const float* tgt,
                   long long tgt_bstride, const float* x, const float* y, int c, int h_src,
                   int w_src, int h, int w, int window, float alpha) {
  Params p{};
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

// Chooses the strip width (the widest from tw_max down that fits shared
// memory), sets the kernel's shared memory, and splits the rows so that
// the grid fills the card's CTA slots about once.
template <typename Kernel>
int launch(Kernel kernel, Params& p, int n, int tw_max, bool backward, cudaStream_t stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  size_t bytes = 0;
  for (p.tw = tw_max; p.tw >= 8; p.tw /= 2) {
    bytes = static_cast<size_t>(Geo(p, p.c, backward, CHUNK).total(backward)) * sizeof(float);
    if (bytes <= static_cast<size_t>(max_smem)) break;
  }
  if (p.tw < 8) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int strips = (p.w + p.tw - 1) / p.tw;
  const int max_splits = (p.h + CHUNK - 1) / CHUNK;
  int splits = sms * (per_sm > 0 ? per_sm : 1) / (n * strips);
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  p.rows = (p.h + splits - 1) / splits;
  const dim3 grid(strips, (p.h + p.rows - 1) / p.rows, n);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The kernels are compiled for C=3 (RGB frames, the loss's only use) with
// the loops over channels unrolled, and for any count read at run time.
int launch_fwd(Params& p, int n, cudaStream_t stream) {
  return p.c == 3 ? launch(fused_err_fwd_kernel<3>, p, n, FWD_TW, false, stream)
                  : launch(fused_err_fwd_kernel<0>, p, n, FWD_TW, false, stream);
}

int launch_bwd(Params& p, int n, cudaStream_t stream) {
  return p.c == 3 ? launch(fused_err_bwd_kernel<3>, p, n, BWD_TW, true, stream)
                  : launch(fused_err_bwd_kernel<0>, p, n, BWD_TW, true, stream);
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
  Params p = make_params(src, src_bstride, tgt, tgt_bstride, x, y, c, h_src, w_src, h, w,
                         window, alpha);
  p.out0 = err;
  return launch_fwd(p, n, stream);
}

extern "C" int colvo_fused_err_bwd(const float* src, long long src_bstride,
                                   const float* tgt, long long tgt_bstride,
                                   const float* x, const float* y, const float* g,
                                   float* gx, float* gy, int n, int c, int h_src,
                                   int w_src, int h, int w, int window, float alpha,
                                   cudaStream_t stream) {
  if (static_cast<long long>(n) * h * w == 0) return 0;
  Params p = make_params(src, src_bstride, tgt, tgt_bstride, x, y, c, h_src, w_src, h, w,
                         window, alpha);
  p.g = g;
  p.out0 = gx;
  p.out1 = gy;
  return launch_bwd(p, n, stream);
}


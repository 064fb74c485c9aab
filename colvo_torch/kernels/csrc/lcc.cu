// L: LCC's windowed calibration of a warped frame to its target, the
// windowed step of colvo_torch/losses/photometric.py's lcc_calibrate.
//
// It replaces no TPU kernel: the JAX package leaves the default loss's
// reduce_window to XLA. In the port the plain path pads, permutes and runs
// PyTorch's avg_pool2d for each of four L×L means and two count planes,
// 225 taps an output at L = 15, with a dozen elementwise passes around
// them: ~1.2 ms a call at the training shape (12 × 256 × 320 × 3), 8 calls
// a default step. This kernel computes the same function in one pass.
//
// Function, per pixel and channel, over the window [i − lo, i + hi] ×
// [j − lo, j + hi] (lo = (L − 1)/2, hi = L − 1 − lo) with zero padding,
// each sum divided by the window's in-image overlap n = nh·nw (SAME mean
// pooling):
//   μw = Σw/n, μt = Σt/n, var = Σw²/n − μw², cov = Σwt/n − μw·μt
//   affine: a = clamp(cov/(var + 1e-4), clip), b = μt − a·μw, ŵ = a·w + b
//   gain:   a = clamp(μt/(μw + 1e-4), clip), ŵ = a·w
// It writes ŵ and, where the wrapper asks for it (the gradient is g·a), a.
//
// Bound on Hopper: bytes. At 12 × 256 × 320 × 3 f32 it reads w and t
// (23.6 MB) and writes ŵ and a (23.6 MB): 0.0141 ms at 3.35 TB/s. Running
// sums make the arithmetic ~35 f32 operations a pixel and channel.
//
// Design. A CTA of 256 threads walks a column strip of one image, TW = 64
// output columns wide (the host halves TW where a large window or channel
// count would not fit shared memory), down a range of its rows, in chunks
// of CHUNK = 8 rows entering the window; the host splits the rows, in
// multiples of 16, so that the grid fills the card's CTA slots about once
// (at the training shape 5
// strips × 4 ranges of 64 rows × 12 images, 240 CTAs, two an SM). Per
// chunk, between barriers:
//   load   the next chunk's rows of w and t over the strip plus the
//          window's halo (TW + L − 1 columns, zero outside the image), as
//          float, into their rings, while this chunk computes (cp.async
//          for float; bfloat16 loads, eight in flight a thread); a
//          thread's loads follow the tensor's stride-1 dimension (W of a
//          plane stack, C of an interleaved frame), so a warp's coalesce;
//   S2     horizontal window sums of (w, t, w², wt) of the chunk's rows:
//          one thread per (row, channel, SEG = 8-column segment), rows
//          fastest, so a warp reads one column of many rows (odd
//          pitches: no bank conflicts); each segment sums its first
//          window directly and slides it;
//   S3     vertical window sums over those: one walker per (channel,
//          column), in the output's stride-1 order, adds the row that
//          enters and subtracts the row that leaves, its sums in
//          registers across chunks, and sums its window directly on
//          every RESTART·CHUNK = 16th output row, which bounds float32 drift
//          (kernel F's rule, csrc/fused_loss.cu); then a and ŵ of its
//          pixel, stored straight to device memory (streaming stores,
//          coalesced), the reads of GROUP = 2 rows issued before their
//          stores.
// Windows of up to DIRECT = 4 are summed directly on every row and column:
// their variances are small, and a running sum's rounding, which does not
// shrink with them, would show (at L = 3, three times the error of the
// plain float32 path).
// The means multiply by 1/n. No atomics, and no sum depends on the order
// in which threads or CTAs run, nor on how the host splits the rows (the
// restarts fall on fixed rows): the output is the same bits on every run,
// and an image's the same whatever else the call holds.
// What sets the pace is not bytes: ~4.6× the bound at the training shape,
// the chunks' two barriers and the loads of a chunk, which the compute of
// the one before does not fully hide, with 16 warps an SM (PERF.md).
//
// Resources at C = 3, L = 15: 106.2 KiB of shared memory a CTA (raw w 21.3
// KiB, raw t 14.8, horizontal sums 70.1), so two CTAs fit an SM.
//
// Layout: any strides. The images are the leading dims (at most kMaxLead
// after dropping those of size 1; the target's may be 0, a broadcast),
// then H, W, C. ŵ and a share one layout. Storage float or bfloat16,
// arithmetic float32.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kMaxLead = 6;

// One call: tensors, element strides of (H, W, C) and of the leading dims
// (outermost first) for w, t and the outputs, the window, the mode, the
// clip; tw and rows are the host's.
struct LccArgs {
  const void* w;
  const void* t;
  void* out;
  void* a;  // nullptr: a is not written
  long long w_hwc[3], t_hwc[3], o_hwc[3];
  long long lead[kMaxLead], w_lead[kMaxLead], t_lead[kMaxLead], o_lead[kMaxLead];
  int n_lead, h, w_, c, lo, hi, gain;
  float clip_lo, clip_hi;
  int tw, rows;
};

namespace {

constexpr int THREADS = 256;
constexpr int TW_MAX = 64;   // output columns of a strip (at most)
constexpr int CHUNK = 8;     // rows that enter the window per chunk
constexpr int SEG = 8;       // columns of one horizontal running sum
constexpr int DIRECT = 4;    // windows up to this size are summed directly
constexpr int WALKERS = 2;   // vertical walkers a thread keeps in registers
constexpr int RESTART = 2;   // chunks between direct vertical sums
constexpr int GROUP = 2;     // rows of a chunk whose reads a walker issues together
constexpr float LCC_EPS = 1e-4f;

__host__ __device__ __forceinline__ int pitch(int n) { return n | 1; }

// Division of small non-negative ints by a divisor fixed for the launch:
// one multiply-high (n·d < 2^32).
struct Div {
  unsigned m;
  int d;
  __device__ explicit Div(int d_)
      : m(d_ > 1 ? 0xFFFFFFFFu / static_cast<unsigned>(d_) + 1u : 0u), d(d_) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), m));
  }
};

// The strip's geometry: A columns (TW + L − 1: the strip and the window's
// halo) and three rings of rows in shared memory, in floats, in this
// order: raw w [hi + 2·CHUNK][nc][pa] (down to the oldest output row's own
// row, which ŵ = a·w + b reads, and up to the next chunk's rows), raw t
// [2·CHUNK][nc][pa] (this chunk's and the next one's rows), and the
// horizontal window sums of (w, t, w², wt) as float4 [L + CHUNK][nc][pt]
// (the window's rows behind the chunk, and the chunk's; 16-byte aligned).
struct Geo {
  int nc, window, tw, ca, pa, pt, rw_rows, rt_rows, rh_rows;
  __host__ __device__ Geo(const LccArgs& p) {
    nc = p.c;
    window = p.lo + p.hi + 1;
    tw = p.tw;
    ca = tw + window - 1;
    pa = pitch(ca);
    pt = pitch(tw);
    rw_rows = p.hi + 2 * CHUNK;
    rt_rows = 2 * CHUNK;
    rh_rows = window + CHUNK;
  }
  __host__ __device__ int rt_off() const { return rw_rows * nc * pa; }
  __host__ __device__ int h_off() const { return (rt_off() + rt_rows * nc * pa + 3) / 4 * 4; }
  __host__ __device__ int total() const { return h_off() + 4 * rh_rows * nc * pt; }
};

// Slots of a ring of n rows whose row `first` sat in slot 0, for rows within
// n of `ref` (ref ≥ first): one modulo per chunk, then a compare and a
// select per row.
struct Ring {
  int ref, slot, n;
  __device__ Ring(int ref_, int first, int n_) : ref(ref_), slot((ref_ - first) % n_), n(n_) {}
  __device__ __forceinline__ int operator()(int row) const {
    int s = slot + row - ref;
    s += s < 0 ? n : 0;
    return s >= n ? s - n : s;
  }
};

// In-image overlap of the window [i − lo, i + hi] with [0, n).
__device__ __forceinline__ int overlap(int i, int n, int lo, int hi) {
  return min(i + hi, n - 1) - max(i - lo, 0) + 1;
}

__device__ __forceinline__ float to_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// clamp(v, lo, hi) that keeps a NaN, as torch.clamp does.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The CTA's walk: image blockIdx.z's element offsets in w, t and the
// outputs, output columns [c0, c0 + tw), output rows [r0, r1), entering
// rows base..a_last in chunks, of which a_first on have an output row
// (a − hi). base lies at or before the row the first output row's running
// sums take out (r0 − lo − 1), so that every chunk's first output row is a
// multiple of CHUNK; with r0 a multiple of RESTART·CHUNK (the host's), the
// sums restart on the same rows whatever the rows of a CTA, and an image's
// output does not depend on the other images of the call.
struct Walk {
  int c0, r0, r1, a_first, a_last, base;
  long long w0, t0, o0;
  __device__ Walk(const LccArgs& p, const Geo& g) {
    c0 = blockIdx.x * p.tw;
    r0 = blockIdx.y * p.rows;
    r1 = min(r0 + p.rows, p.h);
    a_first = r0 + p.hi;
    a_last = r1 - 1 + p.hi;
    base = a_first - (g.window + CHUNK - 1) / CHUNK * CHUNK;
    unsigned n = blockIdx.z;  // (the images fit a grid's z: 32-bit division)
    w0 = t0 = o0 = 0;
    for (int d = p.n_lead - 1; d >= 0; --d) {
      const unsigned size = static_cast<unsigned>(p.lead[d]);
      const long long i = n % size;
      n /= size;
      w0 += i * p.w_lead[d];
      t0 += i * p.t_lead[d];
      o0 += i * p.o_lead[d];
    }
  }
};

// Rows [q0, q0 + nq) of one tensor over the A columns into its ring, as
// float, zero outside the image: a warp a row, its lanes along the
// tensor's stride-1 dimension (W of a plane stack, C of an interleaved
// frame), so a warp's loads coalesce. Float by cp.async (complete after
// cp_async_wait_all); bfloat16 by loads LOADS at a time, all in flight
// before the first is converted. In-image offsets fit 32 bits (the
// wrapper checks).
constexpr int LOADS = 8;

template <typename T>
__device__ void load_rows(const LccArgs& p, const Geo& g, const Walk& k,
                          const T* __restrict__ src, const long long (&s)[3],
                          float* __restrict__ ring, int q0, int nq, const Ring& slot) {
  const bool interleaved = s[2] == 1 && g.nc > 1;
  const int s1 = static_cast<int>(s[1]), s2 = static_cast<int>(s[2]);
  // element f of a row is (ch, j) = (f / ca, f % ca) of a plane stack, or
  // (f % nc, f / nc) of an interleaved frame; a lane steps f by 32
  const int inner = interleaved ? g.nc : g.ca, lane = threadIdx.x % 32;
  const int d_outer = 32 / inner, d_inner = 32 % inner, per_row = g.ca * g.nc;
  for (int r = threadIdx.x / 32; r < nq; r += THREADS / 32) {
    const int q = q0 + r;
    const bool row_in = q >= 0 && q < p.h;
    const T* row = src + (row_in ? q * s[0] : 0);
    float* dst = ring + slot(q) * g.nc * g.pa;
    int outer = lane / inner, in_i = lane % inner;
    for (int f0 = lane; f0 < per_row; f0 += LOADS * 32) {
      int d[LOADS], off[LOADS];
      bool in[LOADS];
#pragma unroll
      for (int b = 0; b < LOADS; ++b) {
        const int ch = interleaved ? in_i : outer, j = interleaved ? outer : in_i;
        const int col = k.c0 - p.lo + j;
        const bool live = f0 + b * 32 < per_row;
        in[b] = live && row_in && col >= 0 && col < p.w_;
        off[b] = in[b] ? col * s1 + ch * s2 : 0;
        d[b] = live ? ch * g.pa + j : -1;
        in_i += d_inner;
        outer += d_outer + (in_i >= inner);
        in_i -= in_i >= inner ? inner : 0;
      }
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int b = 0; b < LOADS; ++b)
          if (d[b] >= 0) cp_async_f32(dst + d[b], row + off[b], in[b]);
      } else {
        float v[LOADS];
#pragma unroll
        for (int b = 0; b < LOADS; ++b) v[b] = in[b] ? to_f(row + off[b]) : 0.0f;
#pragma unroll
        for (int b = 0; b < LOADS; ++b)
          if (d[b] >= 0) dst[d[b]] = v[b];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) lcc_window_kernel(LccArgs p) {
  extern __shared__ float smem[];
  const Geo g(p);
  const Walk k(p, g);
  const int tw = min(g.tw, p.w_ - k.c0);  // the strip's columns inside the image
  const bool out_interleaved = p.o_hwc[2] == 1 && g.nc > 1;
  const Div by_nc(g.nc), by_rc(CHUNK * g.nc), by_walker(out_interleaved ? g.nc : tw);
  float* rw = smem;
  float* rt = smem + g.rt_off();
  float4* hs = reinterpret_cast<float4*>(smem + g.h_off());
  const int hrow = g.nc * g.pt;
  const int n_seg = (tw + SEG - 1) / SEG;
  const int walkers = g.nc * tw;
  const bool keep = walkers <= WALKERS * THREADS;
  const bool direct = g.window <= DIRECT;
  const T* wsrc = static_cast<const T*>(p.w) + k.w0;
  const T* tsrc = static_cast<const T*>(p.t) + k.t0;
  T* out = static_cast<T*>(p.out) + k.o0;
  T* aout = p.a != nullptr ? static_cast<T*>(p.a) + k.o0 : nullptr;
  float sums[WALKERS][4] = {};

  {
    const int n0 = min(CHUNK, k.a_last - k.base + 1);
    load_rows(p, g, k, wsrc, p.w_hwc, rw, k.base, n0,
              Ring(k.base, k.base, g.rw_rows));
    load_rows(p, g, k, tsrc, p.t_hwc, rt, k.base, n0,
              Ring(k.base, k.base, g.rt_rows));
    cp_async_wait_all();
  }
  for (int a0 = k.base; a0 <= k.a_last; a0 += CHUNK) {
    const int n_rows = min(CHUNK, k.a_last - a0 + 1);
    const Ring sw(a0, k.base, g.rw_rows), st(a0, k.base, g.rt_rows), sh(a0, k.base, g.rh_rows);
    __syncthreads();
    // The next chunk's rows, into slots this chunk does not read, while it
    // computes.
    const int a1 = a0 + CHUNK;
    if (a1 <= k.a_last) {
      const int n1 = min(CHUNK, k.a_last - a1 + 1);
      load_rows(p, g, k, wsrc, p.w_hwc, rw, a1, n1, Ring(a1, k.base, g.rw_rows));
      load_rows(p, g, k, tsrc, p.t_hwc, rt, a1, n1, Ring(a1, k.base, g.rt_rows));
    }
    // S2: horizontal window sums of (w, t, w², wt) of the entering rows.
    for (int i = threadIdx.x; i < CHUNK * g.nc * n_seg; i += THREADS) {
      const int seg = by_rc(i), rc = i - seg * CHUNK * g.nc;
      const int r = by_nc(rc), ch = rc - r * g.nc;
      if (r >= n_rows) continue;
      const int q = a0 + r;
      const float* wr = rw + (sw(q) * g.nc + ch) * g.pa;
      const float* tr = rt + (st(q) * g.nc + ch) * g.pa;
      float4* h = hs + sh(q) * hrow + ch * g.pt;
      const int j0 = seg * SEG, j1 = min(j0 + SEG, tw);
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (int j = j0; j < j1; ++j) {
        if (j == j0 || direct) {
          s0 = s1 = s2 = s3 = 0.0f;
          for (int o = j; o < j + g.window; ++o) {
            const float wv = wr[o], tv = tr[o];
            s0 += wv;
            s1 += tv;
            s2 += wv * wv;
            s3 += wv * tv;
          }
        } else {
          const int e = j + g.window - 1, l = j - 1;
          const float wi = wr[e], ti = tr[e], wl = wr[l], tl = tr[l];
          s0 += wi - wl;
          s1 += ti - tl;
          s2 += wi * wi - wl * wl;
          s3 += wi * ti - wl * tl;
        }
        float4 hv;
        hv.x = s0;
        hv.y = s1;
        hv.z = s2;
        hv.w = s3;
        h[j] = hv;
      }
    }
    __syncthreads();
    // S3: vertical window sums of the output rows a − hi, one walker per
    // (channel, column) in the output's stride-1 order; a and ŵ to device
    // memory. A walker's sums restart (the window before its first row,
    // summed directly) on output rows that are multiples of RESTART·CHUNK,
    // the first one included, and every chunk where a thread has more
    // walkers than it keeps; a full chunk's rows are unrolled with no
    // branch between them.
    const int a_s = max(a0, k.a_first), a_e = a0 + n_rows;
    const bool restart = (a_s - p.hi) % (RESTART * CHUNK) == 0 || !keep;
#pragma unroll
    for (int m = 0; m < WALKERS; ++m) {
      for (int i = threadIdx.x + m * THREADS; i < walkers && a_s < a_e; i += WALKERS * THREADS) {
        int ch, j;
        if (out_interleaved) {
          j = by_walker(i);
          ch = i - j * g.nc;
        } else {
          ch = by_walker(i);
          j = i - ch * tw;
        }
        const float4* hc = hs + ch * g.pt + j;
        const float* wc = rw + ch * g.pa + j + p.lo;
        const float nw = static_cast<float>(overlap(k.c0 + j, p.w_, p.lo, p.hi));
        T* oc = out + (k.c0 + j) * p.o_hwc[1] + ch * p.o_hwc[2];
        T* ac = aout != nullptr ? aout + (k.c0 + j) * p.o_hwc[1] + ch * p.o_hwc[2] : nullptr;
        float s0 = sums[m][0], s1 = sums[m][1], s2 = sums[m][2], s3 = sums[m][3];
        if (restart && !direct) {
          s0 = s1 = s2 = s3 = 0.0f;
          for (int q = a_s - g.window; q < a_s; ++q) {
            const float4 hq = hc[sh(q) * hrow];
            s0 += hq.x;
            s1 += hq.y;
            s2 += hq.z;
            s3 += hq.w;
          }
        }
        // a and ŵ of output row a − hi from the sums and the pixel's w
        auto emit = [&](int a, float wv) {
          const int v = a - p.hi;
          const float inv = 1.0f / (nw * static_cast<float>(overlap(v, p.h, p.lo, p.hi)));
          const float mu_w = s0 * inv, mu_t = s1 * inv;
          float av, wh;
          if (p.gain) {
            av = clamp_nan(mu_t / (mu_w + LCC_EPS), p.clip_lo, p.clip_hi);
            wh = av * wv;
          } else {
            const float var = s2 * inv - mu_w * mu_w;
            const float cov = s3 * inv - mu_w * mu_t;
            av = clamp_nan(cov / (var + LCC_EPS), p.clip_lo, p.clip_hi);
            wh = av * wv + (mu_t - av * mu_w);
          }
          const long long o = v * p.o_hwc[0];
          put(oc + o, wh);
          if (ac != nullptr) put(ac + o, av);
        };
        if (a_s == a0 && n_rows == CHUNK && !direct) {
          // a full chunk, GROUP rows at a time: a group's reads first, so
          // that no load waits on a store
#pragma unroll 1
          for (int r0 = 0; r0 < CHUNK; r0 += GROUP) {
            float4 hn[GROUP], ho[GROUP];
            float wv[GROUP];
#pragma unroll
            for (int r = 0; r < GROUP; ++r) {
              const int a = a0 + r0 + r;
              hn[r] = hc[sh(a) * hrow];
              ho[r] = hc[sh(a - g.window) * hrow];
              wv[r] = wc[sw(a - p.hi) * g.nc * g.pa];
            }
#pragma unroll
            for (int r = 0; r < GROUP; ++r) {
              s0 += hn[r].x - ho[r].x;
              s1 += hn[r].y - ho[r].y;
              s2 += hn[r].z - ho[r].z;
              s3 += hn[r].w - ho[r].w;
              emit(a0 + r0 + r, wv[r]);
            }
          }
        } else {
          for (int a = a_s; a < a_e; ++a) {
            if (direct) {
              s0 = s1 = s2 = s3 = 0.0f;
              for (int q = a - g.window + 1; q <= a; ++q) {
                const float4 hq = hc[sh(q) * hrow];
                s0 += hq.x;
                s1 += hq.y;
                s2 += hq.z;
                s3 += hq.w;
              }
            } else {
              const float4 hn = hc[sh(a) * hrow], ho = hc[sh(a - g.window) * hrow];
              s0 += hn.x - ho.x;
              s1 += hn.y - ho.y;
              s2 += hn.z - ho.z;
              s3 += hn.w - ho.w;
            }
            emit(a, wc[sw(a - p.hi) * g.nc * g.pa]);
          }
        }
        sums[m][0] = s0;
        sums[m][1] = s1;
        sums[m][2] = s2;
        sums[m][3] = s3;
      }
    }
    cp_async_wait_all();
  }
}

// Chooses the strip width (the widest from TW_MAX down that fits shared
// memory), sets the kernel's shared memory, and splits the rows so that
// the grid fills the card's CTA slots about once.
template <typename Kernel>
int launch(Kernel kernel, LccArgs& p, long long n_images, cudaStream_t stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  size_t bytes = 0;
  for (p.tw = TW_MAX; p.tw >= 8; p.tw /= 2) {
    bytes = static_cast<size_t>(Geo(p).total()) * sizeof(float);
    if (bytes <= static_cast<size_t>(max_smem)) break;
  }
  if (p.tw < 8) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long strips = (p.w_ + p.tw - 1) / p.tw;
  constexpr int kAlign = RESTART * CHUNK;  // a CTA's first row: a restart row
  const long long max_splits = (p.h + kAlign - 1) / kAlign;
  long long splits = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) / (n_images * strips);
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  p.rows = static_cast<int>(((p.h + splits - 1) / splits + kAlign - 1) / kAlign * kAlign);
  const dim3 grid(static_cast<unsigned>(strips), static_cast<unsigned>((p.h + p.rows - 1) / p.rows),
                  static_cast<unsigned>(n_images));
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes: n_images = the product of p.lead; bf16
// selects bfloat16 storage (else float). Returns the launch's cudaError_t
// (0 on success; cudaErrorInvalidValue where the window cannot fit shared
// memory, or the images exceed a grid's 65,535).
int colvo_lcc_window(LccArgs p, long long n_images, int bf16, cudaStream_t stream) {
  if (n_images == 0 || p.h == 0 || p.w_ == 0 || p.c == 0) return 0;
  if (n_images > 65535 || p.n_lead > kMaxLead || p.lo < 0 || p.hi < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch(lcc_window_kernel<__nv_bfloat16>, p, n_images, stream)
              : launch(lcc_window_kernel<float>, p, n_images, stream);
}

}  // extern "C"

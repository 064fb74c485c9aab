// FA: CoaT's factorized attention with its convolutional relative position
// term, the attention of MPViT's MHCA blocks (colvo_torch/models/mpvit.py),
// forward and backward.
//
// It replaces no TPU kernel: the JAX package has no MPViT. In plain
// PyTorch the op is a softmax over a non-last dimension and two batched
// GEMMs of shape (d × N)·(N × d) with d = 8 to 36, shapes no library
// kernel runs near its bound, and a dozen elementwise passes around them.
//
// Function, per frame f and head h, with q, k, v (N × d) the head's slices
// of the qkv projection (F, N, 3, heads, d), cv (N × d) the CRPE term and
// s = d^−½:
//   P = softmax of k over the N tokens, column by column
//   KV = Pᵀ·v (d × d)
//   out = s·q·KV + q ∘ cv
// Backward, from g = ∂out:
//   dKV = s·qᵀ·g
//   dq = s·g·KVᵀ + g ∘ cv,  dcv = g ∘ q,  dv = P·dKV,
//   dk = P ∘ (v·dKVᵀ − c), with c_i = Σ_j dKV_ij·KV_ij
// P is recomputed from k and the forward's column max and sum, which the
// forward saves with KV (d² + 2d floats a head).
//
// Design. Each direction is three kernels. Reduce and apply serve a group
// of G heads (the host's choice: the most heads, a divisor of them, whose
// G·d² sums fit PAIRS registers a thread), so that a token's slice they
// read is G·d contiguous elements:
//   reduce   a CTA a (chunk of tokens, head group, frame) walks its
//            tokens in tiles of T rows staged in shared memory as float,
//            and keeps its share of the G·d² sums in registers (pair p =
//            thread + k·THREADS). The forward keeps an online column max
//            and sum and rescales its sums when the max grows; it writes
//            each head's chunk (max, sum, Σ e·v) to a workspace, the
//            backward its Σ q·g.
//   combine  a CTA a (head, frame) sums the chunks in their fixed order:
//            the forward's KV, max and sum, which the backward keeps, the
//            backward's dKV and c, into the workspace's first chunk.
//   apply    a CTA a (chunk of tokens, head group, frame) loads the
//            group's d × d matrices into shared memory at an odd row pitch
//            (no bank conflicts whether a warp walks a row or a column),
//            then runs the elementwise pass over its tokens in tiles of T
//            rows.
// The host sizes the chunks in whole tiles so that each grid holds about
// eight CTAs an SM. No atomics; no sum depends on the order in which
// threads or CTAs run: the outputs are the same bits on every run of a
// shape on a card.
//
// Bound on Hopper: bytes, each tensor moved once. A forward reads q, k, v
// and cv and writes out: 10 bytes an element of (F, N, C) in bfloat16; a
// backward reads q, k, v, g and cv and writes dq, dk, dv and dcv: 18.
//
// Layout: qkv (F, N, 3·C) with C = heads·d, cv, out, g and dcv (F, N, C),
// dense; storage float or bfloat16, arithmetic float32; d ≤ kMaxD.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxD = 64;

// One call: the tensors and the sizes. ws holds the reduce's chunks;
// stats the head's KV (d²), max (d) and sum (d), in that order.
struct FaArgs {
  const void* qkv;
  const void* cv;
  const void* g;     // backward
  void* out;         // forward: out; backward: dqkv
  void* dcv;         // backward
  float* ws;
  float* stats;
  int frames, n, heads, d, group, chunk, tile;
  float scale;
};

namespace {

constexpr int THREADS = 256;
constexpr int PAIRS = kMaxD * kMaxD / THREADS;  // register sums a thread keeps

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__host__ __device__ __forceinline__ int n_chunks(int n, int chunk) { return (n + chunk - 1) / chunk; }
__host__ __device__ __forceinline__ int pitch(int d) { return d | 1; }
// A head's chunk in the workspace: d² sums, then d and d.
__host__ __device__ __forceinline__ int ws_stride(const FaArgs& p) { return p.d * p.d + 2 * p.d; }

// A CTA's place: its chunk, its head group's first channel and the frame.
struct Where {
  int chunk, h0, f, w;  // w = G·d, the group's channels
  __device__ explicit Where(const FaArgs& p)
      : chunk(blockIdx.x), h0(blockIdx.y * p.group * p.d), f(blockIdx.z), w(p.group * p.d) {}
};

// Stage rows [r0, r0 + rows) of `part` (0 q, 1 k, 2 v) of the group's
// channels of frame f into dst[rows][w], as float.
template <typename T>
__device__ __forceinline__ void stage_qkv(float* dst, const T* qkv, const FaArgs& p,
                                          const Where& at, int part, int r0, int rows) {
  const int c3 = 3 * p.heads * p.d;
  const T* base = qkv + (static_cast<long long>(at.f) * p.n + r0) * c3 + part * p.heads * p.d
                  + at.h0;
  for (int i = threadIdx.x; i < rows * at.w; i += THREADS) {
    const int r = i / at.w, c = i - r * at.w;
    dst[i] = load(base + static_cast<long long>(r) * c3 + c);
  }
}

// The same from an (F, N, C) tensor.
template <typename T>
__device__ __forceinline__ void stage_nc(float* dst, const T* x, const FaArgs& p, const Where& at,
                                         int r0, int rows) {
  const int c = p.heads * p.d;
  const T* base = x + (static_cast<long long>(at.f) * p.n + r0) * c + at.h0;
  for (int i = threadIdx.x; i < rows * at.w; i += THREADS) {
    const int r = i / at.w, j = i - r * at.w;
    dst[i] = load(base + static_cast<long long>(r) * c + j);
  }
}

// The workspace slot of a head's chunk.
__device__ __forceinline__ long long ws_at(const FaArgs& p, int f, int head, int chunk) {
  return ((static_cast<long long>(f) * p.heads + head) * n_chunks(p.n, p.chunk) + chunk)
         * ws_stride(p);
}

// Forward reduce: each head's chunk column max m, Σ exp(k − m) and
// Σ exp(k − m)·v.
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_fwd_reduce(FaArgs p) {
  extern __shared__ float smem[];
  const Where at(p);
  const int d = p.d, w = at.w, dd = d * d, pairs = p.group * dd;
  float* e = smem;                 // [tile][w]: k, then exp(k − m)
  float* v = e + p.tile * w;       // [tile][w]
  float* m = v + p.tile * w;       // [w] running max
  float* sum = m + w;              // [w] running sum
  float* rescale = sum + w;        // [w] this tile's factor on the sums
  const T* qkv = static_cast<const T*>(p.qkv);
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.0f;
  for (int c = threadIdx.x; c < w; c += THREADS) {
    m[c] = -INFINITY;
    sum[c] = 0.0f;
  }
  const int r_begin = at.chunk * p.chunk, r_end = min(p.n, r_begin + p.chunk);
  for (int r0 = r_begin; r0 < r_end; r0 += p.tile) {
    const int rows = min(p.tile, r_end - r0);
    __syncthreads();  // the last tile's sums are done with e and v
    stage_qkv(e, qkv, p, at, 1, r0, rows);
    stage_qkv(v, qkv, p, at, 2, r0, rows);
    __syncthreads();
    for (int c = threadIdx.x; c < w; c += THREADS) {
      float mx = m[c];
      for (int r = 0; r < rows; ++r) mx = fmaxf(mx, e[r * w + c]);
      rescale[c] = m[c] == -INFINITY ? 0.0f : expf(m[c] - mx);
      m[c] = mx;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * w; i += THREADS) e[i] = expf(e[i] - m[i % w]);
    __syncthreads();
    for (int c = threadIdx.x; c < w; c += THREADS) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += e[r * w + c];
      sum[c] = sum[c] * rescale[c] + s;
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pair = threadIdx.x + i * THREADS;
      if (pair < pairs) {
        const int g = pair / dd, rem = pair - g * dd, c = g * d + rem / d, j = g * d + rem % d;
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += e[r * w + c] * v[r * w + j];
        acc[i] = acc[i] * rescale[c] + s;
      }
    }
  }
  __syncthreads();
  const int head0 = at.h0 / d;
  for (int c = threadIdx.x; c < w; c += THREADS) {
    float* out = p.ws + ws_at(p, at.f, head0 + c / d, at.chunk) + dd;
    out[c % d] = m[c];
    out[d + c % d] = sum[c];
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int pair = threadIdx.x + i * THREADS;
    if (pair < pairs) {
      const int g = pair / dd;
      p.ws[ws_at(p, at.f, head0 + g, at.chunk) + pair - g * dd] = acc[i];
    }
  }
}

// Forward combine: a head's KV, max and sum from its chunks, into stats.
__global__ void __launch_bounds__(THREADS) fa_fwd_combine(FaArgs p) {
  extern __shared__ float smem[];
  float* mx = smem;      // [d]
  float* sm = mx + p.d;  // [d]
  const int d = p.d, dd = d * d, head = blockIdx.x, f = blockIdx.y;
  const int nch = n_chunks(p.n, p.chunk), stride = ws_stride(p);
  const float* ws = p.ws + ws_at(p, f, head, 0);
  float* st = p.stats + (static_cast<long long>(f) * p.heads + head) * (dd + 2 * d);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float m = -INFINITY;
    for (int i = 0; i < nch; ++i) m = fmaxf(m, ws[i * stride + dd + c]);
    float s = 0.0f;
    for (int i = 0; i < nch; ++i)
      s += ws[i * stride + dd + d + c] * expf(ws[i * stride + dd + c] - m);
    mx[c] = m;
    sm[c] = s;
    st[dd + c] = m;
    st[dd + d + c] = s;
  }
  __syncthreads();
  for (int pair = threadIdx.x; pair < dd; pair += THREADS) {
    const int c = pair / d;
    float s = 0.0f;
    for (int i = 0; i < nch; ++i)
      s += ws[i * stride + pair] * expf(ws[i * stride + dd + c] - mx[c]);
    st[pair] = s / sm[c];
  }
}

// Forward apply: out = s·q·KV + q ∘ cv, KV the combine's.
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_fwd_apply(FaArgs p) {
  extern __shared__ float smem[];
  const Where at(p);
  const int d = p.d, w = at.w, dd = d * d, pd = pitch(d);
  float* kv = smem;              // [w][pd]: row g·d + c holds head g's KV row c
  float* q = kv + w * pd;        // [tile][w]
  float* cv = q + p.tile * w;    // [tile][w]
  for (int i = threadIdx.x; i < p.group * dd; i += THREADS) {
    const int g = i / dd, e = i - g * dd;
    kv[(g * d + e / d) * pd + e % d] =
        p.stats[(static_cast<long long>(at.f) * p.heads + at.h0 / d + g) * (dd + 2 * d) + e];
  }
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* cvp = static_cast<const T*>(p.cv);
  T* out = static_cast<T*>(p.out);
  const int c_all = p.heads * d;
  const int r_begin = at.chunk * p.chunk, r_end = min(p.n, r_begin + p.chunk);
  for (int r0 = r_begin; r0 < r_end; r0 += p.tile) {
    const int rows = min(p.tile, r_end - r0);
    __syncthreads();
    stage_qkv(q, qkv, p, at, 0, r0, rows);
    stage_nc(cv, cvp, p, at, r0, rows);
    __syncthreads();
    T* o = out + (static_cast<long long>(at.f) * p.n + r0) * c_all + at.h0;
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      const int r = i / w, x = i - r * w, g0 = x - x % d;
      const float* qr = q + r * w + g0;
      const float* kc = kv + g0 * pd + x % d;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s += qr[c] * kc[c * pd];
      store(o + static_cast<long long>(r) * c_all + x, p.scale * s + q[i] * cv[i]);
    }
  }
}

// Backward reduce: each head's chunk Σ q·g (d × d).
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_reduce(FaArgs p) {
  extern __shared__ float smem[];
  const Where at(p);
  const int d = p.d, w = at.w, dd = d * d, pairs = p.group * dd;
  float* q = smem;              // [tile][w]
  float* g = q + p.tile * w;    // [tile][w]
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* gp = static_cast<const T*>(p.g);
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.0f;
  const int r_begin = at.chunk * p.chunk, r_end = min(p.n, r_begin + p.chunk);
  for (int r0 = r_begin; r0 < r_end; r0 += p.tile) {
    const int rows = min(p.tile, r_end - r0);
    __syncthreads();
    stage_qkv(q, qkv, p, at, 0, r0, rows);
    stage_nc(g, gp, p, at, r0, rows);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pair = threadIdx.x + i * THREADS;
      if (pair < pairs) {
        const int h = pair / dd, rem = pair - h * dd, c = h * d + rem / d, j = h * d + rem % d;
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += q[r * w + c] * g[r * w + j];
        acc[i] += s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int pair = threadIdx.x + i * THREADS;
    if (pair < pairs) {
      const int h = pair / dd;
      p.ws[ws_at(p, at.f, at.h0 / d + h, at.chunk) + pair - h * dd] = acc[i];
    }
  }
}

// Backward combine: a head's dKV = s·Σ chunks and c_i = Σ_j dKV_ij·KV_ij,
// into the workspace's first chunk (each sum read, then written, by one
// thread).
__global__ void __launch_bounds__(THREADS) fa_bwd_combine(FaArgs p) {
  extern __shared__ float smem[];
  float* prod = smem;  // [d][d]: dKV ∘ KV
  const int d = p.d, dd = d * d, head = blockIdx.x, f = blockIdx.y;
  const int nch = n_chunks(p.n, p.chunk), stride = ws_stride(p);
  float* ws = p.ws + ws_at(p, f, head, 0);
  const float* kv = p.stats + (static_cast<long long>(f) * p.heads + head) * (dd + 2 * d);
  for (int pair = threadIdx.x; pair < dd; pair += THREADS) {
    float s = 0.0f;
    for (int i = 0; i < nch; ++i) s += ws[i * stride + pair];
    s *= p.scale;
    ws[pair] = s;
    prod[pair] = s * kv[pair];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.0f;
    for (int j = 0; j < d; ++j) s += prod[c * d + j];
    ws[dd + c] = s;
  }
}

// Backward apply: dq, dk, dv and dcv, dKV and c the combine's.
template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_apply(FaArgs p) {
  extern __shared__ float smem[];
  const Where at(p);
  const int d = p.d, w = at.w, dd = d * d, pd = pitch(d);
  float* kv = smem;              // [w][pd], as the forward's apply
  float* dkv = kv + w * pd;      // [w][pd]
  float* mx = dkv + w * pd;      // [w]
  float* sm = mx + w;            // [w]
  float* cc = sm + w;            // [w]
  float* q = cc + w;             // [tile][w] each: q, k (then P), v, g, cv
  float* k = q + p.tile * w;
  float* v = k + p.tile * w;
  float* g = v + p.tile * w;
  float* cv = g + p.tile * w;
  for (int i = threadIdx.x; i < p.group * (dd + 2 * d); i += THREADS) {
    const int h = i / (dd + 2 * d), e = i - h * (dd + 2 * d), head = at.h0 / d + h;
    const float x = p.stats[(static_cast<long long>(at.f) * p.heads + head) * (dd + 2 * d) + e];
    const float y = e < dd + d ? p.ws[ws_at(p, at.f, head, 0) + e] : 0.0f;
    if (e < dd) {
      kv[(h * d + e / d) * pd + e % d] = x;
      dkv[(h * d + e / d) * pd + e % d] = y;
    } else if (e < dd + d) {
      mx[h * d + e - dd] = x;
      cc[h * d + e - dd] = y;
    } else {
      sm[h * d + e - dd - d] = x;
    }
  }
  __syncthreads();
  const T* qkv = static_cast<const T*>(p.qkv);
  const T* gp = static_cast<const T*>(p.g);
  const T* cvp = static_cast<const T*>(p.cv);
  T* dqkv = static_cast<T*>(p.out);
  T* dcv = static_cast<T*>(p.dcv);
  const int c_all = p.heads * d;
  const int r_begin = at.chunk * p.chunk, r_end = min(p.n, r_begin + p.chunk);
  for (int r0 = r_begin; r0 < r_end; r0 += p.tile) {
    const int rows = min(p.tile, r_end - r0);
    __syncthreads();
    stage_qkv(q, qkv, p, at, 0, r0, rows);
    stage_qkv(k, qkv, p, at, 1, r0, rows);
    stage_qkv(v, qkv, p, at, 2, r0, rows);
    stage_nc(g, gp, p, at, r0, rows);
    stage_nc(cv, cvp, p, at, r0, rows);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      const int c = i % w;
      k[i] = expf(k[i] - mx[c]) / sm[c];
    }
    __syncthreads();
    const long long row0 = static_cast<long long>(at.f) * p.n + r0;
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      const int r = i / w, x = i - r * w, g0 = x - x % d;
      const float *gr = g + r * w + g0, *pr = k + r * w + g0, *vr = v + r * w + g0;
      const float *kvx = kv + x * pd, *dkvx = dkv + x * pd, *dkvc = dkv + g0 * pd + x % d;
      float dq = 0.0f, dv = 0.0f, dk = 0.0f;
      for (int j = 0; j < d; ++j) {
        dq += gr[j] * kvx[j];
        dv += pr[j] * dkvc[j * pd];
        dk += vr[j] * dkvx[j];
      }
      T* o = dqkv + (row0 + r) * 3 * c_all + at.h0 + x;
      store(o, p.scale * dq + g[i] * cv[i]);
      store(o + c_all, k[i] * (dk - cc[x]));
      store(o + 2 * c_all, dv);
      store(dcv + (row0 + r) * c_all + at.h0 + x, g[i] * q[i]);
    }
  }
}

template <typename K>
int launch(K kernel, const FaArgs& p, int chunk, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_chunks(p.n, chunk), p.heads / p.group, p.frames);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_heads(K kernel, const FaArgs& p, size_t smem, cudaStream_t stream) {
  dim3 grid(p.heads, p.frames);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int check(const FaArgs& p) {
  if (p.d < 1 || p.d > kMaxD || p.heads < 1 || p.group < 1 || p.heads % p.group ||
      p.group * p.d * p.d > PAIRS * THREADS || p.frames > 65535 || p.heads > 65535 ||
      p.tile < 1 || p.chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

size_t floats(size_t n) { return n * sizeof(float); }

template <typename T>
int forward(const FaArgs& p, cudaStream_t stream) {
  const size_t w = p.group * p.d;
  int err = launch(fa_fwd_reduce<T>, p, p.chunk, floats(2 * p.tile * w + 3 * w), stream);
  if (!err) err = launch_heads(fa_fwd_combine, p, floats(2 * p.d), stream);
  if (err) return err;
  return launch(fa_fwd_apply<T>, p, p.chunk, floats(w * pitch(p.d) + 2 * p.tile * w), stream);
}

template <typename T>
int backward(const FaArgs& p, cudaStream_t stream) {
  const size_t w = p.group * p.d;
  int err = launch(fa_bwd_reduce<T>, p, p.chunk, floats(2 * p.tile * w), stream);
  if (!err) err = launch_heads(fa_bwd_combine, p, floats(p.d * p.d), stream);
  if (err) return err;
  return launch(fa_bwd_apply<T>, p, p.chunk,
                floats(2 * w * pitch(p.d) + 3 * w + 5 * p.tile * w), stream);
}

}  // namespace

extern "C" {

int colvo_fa_fwd(FaArgs p, int bf16, cudaStream_t stream) {
  if (p.frames == 0 || p.n == 0) return 0;
  if (int err = check(p)) return err;
  return bf16 ? forward<__nv_bfloat16>(p, stream) : forward<float>(p, stream);
}

int colvo_fa_bwd(FaArgs p, int bf16, cudaStream_t stream) {
  if (p.frames == 0 || p.n == 0) return 0;
  if (int err = check(p)) return err;
  return bf16 ? backward<__nv_bfloat16>(p, stream) : backward<float>(p, stream);
}

}  // extern "C"

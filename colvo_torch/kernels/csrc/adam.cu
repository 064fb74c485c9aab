// A: the training step's update, the global-norm clip and Adam, over the
// list of one parameter group's tensors: one launch a pass.
//
// It replaces no TPU kernel: the JAX package leaves optax's clip and Adam
// to XLA, which fuses them. In the port the plain path
// (colvo_torch/kernels/adam.py: clip_plain, step_plain) is a chain of
// ~17 torch._foreach_* passes, each writing a full-size temporary that the
// next one reads back: ~152 B a float32 parameter a step, 18.3 ms of the
// ViT-L training step (346.6 M parameters).
//
// Function, as the plain chain computes it, per element:
//   A/sumsq  Σg² over every element of every tensor; norm = sqrt(Σg²),
//            scale = norm < max_norm ? 1 : (1/norm)·max_norm (PyTorch's
//            max_norm / tensor: a reciprocal, then a product).
//   A/clip   g ← g·scale, where scale ≠ 1 (g·1 is g, bit for bit).
//   A/step   t = step + 1 (every tensor's step count is incremented),
//            bc1 = 1 − β1^t, bc2 = 1 − β2^t (float32 powf, as torch.pow);
//            μ' = (1−β1)·g + round_μ(β1_μ·μ)   (β1_μ is β1 in μ's dtype;
//                                               round_μ rounds to μ's dtype)
//            ν' = β2·ν + (g·g)·(1−β2)
//            u  = (μ'/bc1) / (sqrt(ν'/bc2) + eps)  [+ wd·p]
//            p' = p + u·(−lr),  μ' stored in μ's dtype (round to nearest
//            even), ν' in float32.
// Every operation is float32 and rounded once (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: nvcc contracts none of them into an FMA), in the
// chain's order, so A/step gives the chain's bits. The sums of A/sumsq are
// in float64.
//
// Bound on Hopper: bytes. A/sumsq reads g (4 B a parameter), A/clip reads
// and writes it only where the clip engages (8 B), A/step reads p, g, μ,
// ν and writes p, μ, ν (28 B with a float32 μ, 24 B with a bf16 one).
//
// Design. The tensors lie end to end in one flat space of quads (four
// elements; each tensor starts on a quad, so its last quad may be part
// padding). A fixed chunk of kChunkQuads quads goes to a CTA at a time,
// kQuadsPerThread a thread at a stride of kThreads (coalesced), so small
// tensors share chunks and the whole list is one launch, whatever its
// sizes. The table (built once a list on the device by adam_table_kernel,
// from launches whose arguments carry the tensors' addresses, so that a
// CUDA graph can capture the build too) holds each tensor's first quad,
// size and addresses, and each chunk's first tensor: a chunk that one
// tensor covers needs no search; in one that several share, a thread
// finds its quad's tensor by a binary search between the chunk's first
// tensor and the next chunk's. A quad whose tensors are all 16-byte
// aligned (8 bytes for a bf16 μ) moves in 16-byte loads and stores, the
// others element by element. The CTAs are persistent (a grid of
// kMinBlocks an SM, which __launch_bounds__ guarantees fit), walking the
// chunks at a stride of the grid.
//
// A/sumsq: each CTA sums its chunks in float64 in a fixed order (thread,
// then a shuffle tree, then its warps in order) into its own partial; the
// last CTA to finish (a ticket counter, reset by it) adds the partials in
// CTA order and writes the norm and the scale. Nothing depends on the
// order in which CTAs run: the norm is the same bits on every call and in
// every replay. A/step reads the first tensor's step count at its start;
// the last CTA to finish increments every tensor's count. No kernel reads
// a host scalar that changes between steps: the learning rate is read
// from the device where the group keeps it there.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kBatch = 64;   // tensors one adam_table_kernel launch writes
constexpr int kArrays = 5;   // p, g, μ, ν, step

// The tensors lo .. lo + count − 1 of a list, for one table launch: their
// first quads (and the quad after the last), element counts and addresses
// (0 where a list has no such array: the clip's has only g).
struct TableBatch {
  long long qoff[kBatch + 1];
  long long numel[kBatch];
  long long ptr[kArrays][kBatch];
  int lo, count;
};

// One step's constants, each rounded to float32 as the plain chain does.
struct StepArgs {
  const float* lr;  // the group's learning rate on the device, or nullptr: lr_value
  float lr_value;
  float b1, b2;     // β1 (the base of bc1), β2 (ν's factor, the base of bc2)
  float b1_mu;      // β1 in μ's dtype
  float c1, c2;     // 1 − β1, 1 − β2
  float eps, wd;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // CTAs an SM: the persistent grid
constexpr int kQuadsPerThread = 4;
constexpr long long kChunkQuads = static_cast<long long>(kThreads) * kQuadsPerThread;
enum { kP = 0, kG = 1, kMu = 2, kNu = 3, kStep = 4 };

// The table in device memory, in 64-bit words: the tickets (two 32-bit
// counters: A/sumsq's, A/step's), qoff[n + 1], numel[n], ptr[kArrays][n],
// first[n_chunks + 1] (first[n_chunks] = n − 1).
__host__ __device__ constexpr long long table_words(int n, long long n_chunks) {
  return 1 + (n + 1) + n + static_cast<long long>(kArrays) * n + (n_chunks + 1);
}

struct Table {
  long long* words;
  int n;
  long long n_chunks;
  __device__ unsigned* ticket(int k) const { return reinterpret_cast<unsigned*>(words) + k; }
  __device__ long long* qoff() const { return words + 1; }
  __device__ long long* numel() const { return qoff() + n + 1; }
  __device__ long long* ptr(int a) const { return numel() + n + static_cast<long long>(a) * n; }
  __device__ long long* first() const { return ptr(kArrays); }
};

// The tensor of quad q: the last of lo .. hi whose first quad is at most q.
__device__ __forceinline__ int tensor_of(const long long* qoff, int lo, int hi, long long q) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (qoff[mid] <= q) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Calls visit(i, e, left) for each of this CTA's quads: tensor i, its
// element e, left = the quad's elements in the tensor (1 to 4).
template <class Visit>
__device__ __forceinline__ void walk(const Table& t, Visit&& visit) {
  const long long* qoff = t.qoff();
  const long long* numel = t.numel();
  const long long* first = t.first();
  const long long quads = qoff[t.n];
  for (long long c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const int lo = static_cast<int>(first[c]), hi = static_cast<int>(first[c + 1]);
    for (int j = 0; j < kQuadsPerThread; ++j) {
      const long long q = c * kChunkQuads + static_cast<long long>(j) * kThreads + threadIdx.x;
      if (q >= quads) break;
      const int i = lo == hi ? lo : tensor_of(qoff, lo, hi, q);
      const long long e = 4 * (q - qoff[i]);
      const long long left = numel[i] - e;
      visit(i, e, left < 4 ? static_cast<int>(left) : 4);
    }
  }
}

__device__ __forceinline__ bool aligned(long long address, int bytes) {
  return (static_cast<unsigned long long>(address) & static_cast<unsigned>(bytes - 1)) == 0;
}

// A float's bits rounded to bfloat16's (to nearest even), as PyTorch's
// conversion on the card rounds them.
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// μ's dtype: a load, a store, and the rounding of a product to it.
__device__ __forceinline__ float mu_round(float v, const float*) { return v; }
__device__ __forceinline__ float mu_round(float v, const __nv_bfloat16*) {
  return __uint_as_float(bf16_bits(v) << 16);
}
__device__ __forceinline__ float mu_load(const float* m) { return *m; }
__device__ __forceinline__ float mu_load(const __nv_bfloat16* m) { return __bfloat162float(*m); }
__device__ __forceinline__ void mu_store(float* m, float v) { *m = v; }
__device__ __forceinline__ void mu_store(__nv_bfloat16* m, float v) {
  *m = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void mu_load4(const float* m, float (&v)[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(m));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void mu_load4(const __nv_bfloat16* m, float (&v)[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(m));  // element 0 in x's low half
  v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void mu_store4(float* m, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(m), float4{v[0], v[1], v[2], v[3]});
}
__device__ __forceinline__ void mu_store4(__nv_bfloat16* m, const float (&v)[4]) {
  uint2 x;
  x.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  x.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  __stcs(reinterpret_cast<uint2*>(m), x);
}

// A step's constants on the device.
struct Coef {
  float b1_mu, c1, b2, c2, bc1, bc2, eps, wd, neg_lr;
  bool decay;
};

// One element's update, in the plain chain's order of operations.
template <typename Mu>
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v, const Coef& k) {
  const float b1m = mu_round(__fmul_rn(m, k.b1_mu), static_cast<const Mu*>(nullptr));
  m = __fadd_rn(__fmul_rn(g, k.c1), b1m);
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g, g), k.c2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps);
  float u = __fdiv_rn(__fdiv_rn(m, k.bc1), den);
  if (k.decay) u = __fadd_rn(u, __fmul_rn(p, k.wd));
  p = __fadd_rn(p, __fmul_rn(u, k.neg_lr));
}

// The sum of v over the CTA, in a fixed order, in thread 0 (scratch:
// kWarps doubles of shared memory).
__device__ __forceinline__ double cta_sum(double v, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? scratch[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

// Whether this CTA is the last of the grid to finish (every CTA calls it
// once, after its writes); the last one resets the ticket.
__device__ __forceinline__ bool last_cta(unsigned* ticket, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (*flag) *ticket = 0;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads) adam_table_kernel(Table t, TableBatch b) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long* qoff = t.qoff();
  for (long long k = tid; k < b.count; k += stride) {
    qoff[b.lo + k] = b.qoff[k];
    t.numel()[b.lo + k] = b.numel[k];
    for (int a = 0; a < kArrays; ++a) t.ptr(a)[b.lo + k] = b.ptr[a][k];
  }
  if (tid == 0 && b.lo == 0) t.words[0] = 0;  // the tickets
  if (tid == 0 && b.lo + b.count == t.n) {
    qoff[t.n] = b.qoff[b.count];
    t.first()[t.n_chunks] = t.n - 1;
  }
  // the chunks whose first quad lies in these tensors
  const long long c0 = (b.qoff[0] + kChunkQuads - 1) / kChunkQuads;
  const long long c1 = (b.qoff[b.count] + kChunkQuads - 1) / kChunkQuads;
  for (long long c = c0 + tid; c < c1; c += stride) {
    int i = b.count - 1;
    while (b.qoff[i] > c * kChunkQuads) --i;
    t.first()[c] = b.lo + i;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    adam_sumsq_kernel(Table t, double* partial, float* out, float max_norm) {
  extern __shared__ float smem[];  // kWarps doubles, then the last-CTA flag
  double* scratch = reinterpret_cast<double*>(smem);
  int* flag = reinterpret_cast<int*>(scratch + kWarps);
  const long long* gp = t.ptr(kG);
  double acc = 0.0;
  walk(t, [&](int i, long long e, int left) {
    const float* g = reinterpret_cast<const float*>(gp[i]) + e;
    if (left == 4 && aligned(gp[i], 16)) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(g));
      acc += static_cast<double>(x.x) * x.x;
      acc += static_cast<double>(x.y) * x.y;
      acc += static_cast<double>(x.z) * x.z;
      acc += static_cast<double>(x.w) * x.w;
    } else {
      for (int k = 0; k < left; ++k) {
        const float x = __ldcs(g + k);
        acc += static_cast<double>(x) * x;
      }
    }
  });
  acc = cta_sum(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
  if (!last_cta(t.ticket(0), flag)) return;
  double s = 0.0;
  for (unsigned k = threadIdx.x; k < gridDim.x; k += kThreads) s += __ldcg(partial + k);
  s = cta_sum(s, scratch);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(s));
    out[0] = norm;
    out[1] = norm < max_norm ? 1.0f : __fmul_rn(__frcp_rn(norm), max_norm);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    adam_clip_kernel(Table t, const float* out) {
  const float s = out[1];
  if (s == 1.0f) return;
  const long long* gp = t.ptr(kG);
  walk(t, [&](int i, long long e, int left) {
    float* g = reinterpret_cast<float*>(gp[i]) + e;
    if (left == 4 && aligned(gp[i], 16)) {
      float4 x = __ldcs(reinterpret_cast<const float4*>(g));
      x.x = __fmul_rn(x.x, s), x.y = __fmul_rn(x.y, s);
      x.z = __fmul_rn(x.z, s), x.w = __fmul_rn(x.w, s);
      __stcs(reinterpret_cast<float4*>(g), x);
    } else {
      for (int k = 0; k < left; ++k) g[k] = __fmul_rn(g[k], s);
    }
  });
}

template <typename Mu>
__global__ void __launch_bounds__(kThreads, kMinBlocks) adam_step_kernel(Table t, StepArgs a) {
  extern __shared__ float smem[];  // the last-CTA flag
  int* flag = reinterpret_cast<int*>(smem);
  const long long* pp = t.ptr(kP);
  const long long* gp = t.ptr(kG);
  const long long* mp = t.ptr(kMu);
  const long long* vp = t.ptr(kNu);
  const long long* sp = t.ptr(kStep);
  Coef k;
  const float step = __fadd_rn(*reinterpret_cast<const float*>(sp[0]), 1.0f);
  k.b1_mu = a.b1_mu, k.c1 = a.c1, k.b2 = a.b2, k.c2 = a.c2, k.eps = a.eps, k.wd = a.wd;
  k.bc1 = __fsub_rn(1.0f, powf(a.b1, step));
  k.bc2 = __fsub_rn(1.0f, powf(a.b2, step));
  k.neg_lr = -(a.lr != nullptr ? *a.lr : a.lr_value);
  k.decay = a.wd != 0.0f;
  walk(t, [&](int i, long long e, int left) {
    float* p = reinterpret_cast<float*>(pp[i]) + e;
    const float* g = reinterpret_cast<const float*>(gp[i]) + e;
    Mu* m = reinterpret_cast<Mu*>(mp[i]) + e;
    float* v = reinterpret_cast<float*>(vp[i]) + e;
    if (left == 4 && aligned(pp[i] | gp[i] | vp[i], 16) &&
        aligned(mp[i], 4 * static_cast<int>(sizeof(Mu)))) {
      float4 p4 = __ldcs(reinterpret_cast<const float4*>(p));
      const float4 g4 = __ldcs(reinterpret_cast<const float4*>(g));
      float4 v4 = __ldcs(reinterpret_cast<const float4*>(v));
      float m4[4];
      mu_load4(m, m4);
      adam1<Mu>(p4.x, g4.x, m4[0], v4.x, k);
      adam1<Mu>(p4.y, g4.y, m4[1], v4.y, k);
      adam1<Mu>(p4.z, g4.z, m4[2], v4.z, k);
      adam1<Mu>(p4.w, g4.w, m4[3], v4.w, k);
      __stcs(reinterpret_cast<float4*>(p), p4);
      __stcs(reinterpret_cast<float4*>(v), v4);
      mu_store4(m, m4);
    } else {
      for (int j = 0; j < left; ++j) {
        float pj = p[j], mj = mu_load(m + j), vj = v[j];
        adam1<Mu>(pj, g[j], mj, vj, k);
        p[j] = pj, v[j] = vj;
        mu_store(m + j, mj);
      }
    }
  });
  if (!last_cta(t.ticket(1), flag)) return;
  for (int i = threadIdx.x; i < t.n; i += kThreads) {
    float* s = reinterpret_cast<float*>(sp[i]);
    *s = __fadd_rn(*s, 1.0f);
  }
}

// The persistent grid of A's passes: kMinBlocks CTAs an SM, at most one a
// chunk, at least one.
int grid_of(long long n_chunks, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most = static_cast<long long>(sms) * kMinBlocks;
  *grid = static_cast<int>(n_chunks < 1 ? 1 : (n_chunks < most ? n_chunks : most));
  return 0;
}

}  // namespace

extern "C" {

// The table's 64-bit words for n tensors in n_chunks chunks, and the
// quads of a chunk: the wrapper lays the tensors out and allocates.
long long colvo_adam_table_words(int n, long long n_chunks) { return table_words(n, n_chunks); }
long long colvo_adam_chunk_quads() { return kChunkQuads; }
int colvo_adam_batch() { return kBatch; }

// The grid A's passes launch for n_chunks chunks (A/sumsq's partials: one
// double a CTA); -1 if the device cannot be read.
int colvo_adam_grid(long long n_chunks) {
  int grid = 0;
  return grid_of(n_chunks, &grid) == 0 ? grid : -1;
}

// Plain C entry points for ctypes. Each returns the launch's cudaError_t
// (0 on success). table: colvo_adam_table_words(n, n_chunks) words.
//
// Writes b's tensors into the table (and, with the batch that holds the
// last tensor, the end of the layout; with the first, zeroed tickets).
int colvo_adam_table(long long* table, int n, long long n_chunks, TableBatch b,
                     cudaStream_t stream) {
  if (b.count < 1 || b.count > kBatch || b.lo < 0 || b.lo + b.count > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Table t{table, n, n_chunks};
  const long long chunks = (b.qoff[b.count] + kChunkQuads - 1) / kChunkQuads -
                           (b.qoff[0] + kChunkQuads - 1) / kChunkQuads;
  const long long work = chunks > b.count ? chunks : b.count;
  const long long blocks = (work + kThreads - 1) / kThreads;
  adam_table_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks)),
                      kThreads, 0, stream>>>(t, b);
  return static_cast<int>(cudaGetLastError());
}

// Σg² of the table's g → out[0] the norm, out[1] the clip's scale;
// partial: grid doubles (colvo_adam_grid).
int colvo_adam_sumsq(long long* table, int n, long long n_chunks, int grid, double* partial,
                     float* out, float max_norm, cudaStream_t stream) {
  const Table t{table, n, n_chunks};
  adam_sumsq_kernel<<<grid, kThreads, kWarps * sizeof(double) + sizeof(double), stream>>>(
      t, partial, out, max_norm);
  return static_cast<int>(cudaGetLastError());
}

// g ← g·out[1] where out[1] ≠ 1.
int colvo_adam_clip(long long* table, int n, long long n_chunks, int grid, const float* out,
                    cudaStream_t stream) {
  const Table t{table, n, n_chunks};
  adam_clip_kernel<<<grid, kThreads, 0, stream>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}

// One Adam step over the table's p, g, μ (bf16: bfloat16, else float), ν
// and step counts.
int colvo_adam_step(long long* table, int n, long long n_chunks, int grid, StepArgs a, int bf16,
                    cudaStream_t stream) {
  const Table t{table, n, n_chunks};
  if (bf16) {
    adam_step_kernel<__nv_bfloat16><<<grid, kThreads, sizeof(double), stream>>>(t, a);
  } else {
    adam_step_kernel<float><<<grid, kThreads, sizeof(double), stream>>>(t, a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

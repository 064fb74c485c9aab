// P: the training loss's backprojection -> SE(3) -> pinhole projection of
// one depth grid to all its source frames, forward and backward.
//
// It replaces no TPU kernel: the JAX package leaves
// colvo/geometry/ops.py's backproject and project to XLA. In the port the
// plain path (colvo_torch/geometry/ops.py) lowers the rotation R.p to a
// batched matmul whose backward is a cuBLAS GEMM with a 3x3 output per
// batch row and K = h*w pixels: at 12x256x320 one 32x32x8 tile a row, 12
// CTAs on 132 SMs, ~2.2 ms a call. This kernel pair computes the same
// function in one pass each way.
//
// Function, per pixel (col, row) of grid n and source s, exactly as
// ops.project(ops.backproject(...)) does it:
//   r = Kinv[n] (col, row, 1)^T,  p = depth * r,  c = R[s,n] p + t[s,n],
//   u = K[n] c,  z = u2,  x = u0 / (z + 1e-7),  y = u1 / (z + 1e-7).
//
// Bound on Hopper: bytes. Forward: 4 B of depth read and 12 B written a
// source; backward: 4 B of depth and 12 B of cotangents a source read, 4 B
// of d_depth written, the d_T partials negligible. At the full-resolution
// grid (N = 12, 256x320, 2 sources) 27.5 MB forward and 31.5 MB backward,
// 8.2 and 9.4 us at 3.35 TB/s; ~60 f32 operations a pixel and source.
//
// Design. Forward (project_depth_kernel): a thread a pixel, the ray and
// point in registers, one loop over the sources; x, y and z go to
// (S*N, h, w) planes, plane s*N + n, the layout kernels S and T read, so
// no (..., 3) points tensor or strided slice exists. K, K^-1 and T are
// the same for every thread of a CTA (its grid n is blockIdx.y): uniform
// loads through the L1.
//
// Backward (project_depth_bwd_kernel, then project_depth_sum_kernel): a
// CTA takes kTile = kThreads * kPixels pixels of one grid, kPixels a
// thread at a stride of kThreads (coalesced), with depth, the point and
// d_depth of each in registers. Per source it recomputes the forward,
// takes the cotangents of u, c and p, adds d_depth += d_p . r, and sums
// the 12 entries of d[R | t] = d_c (p, 1)^T over its pixels; the CTA then
// sums them by a warp-shuffle tree and a fixed walk over its warps into
// one partial, written to its own slot (partial[s][n][tile][12]). The sum
// kernel adds a (s, n, entry)'s partials in tile order, a warp each
// (lane stride, then a shuffle tree), and writes d_T as (S, N, 4, 4) with
// a zero bottom row. No float atomics: every sum has an order fixed by
// the shapes alone, so d_T and d_depth are the same bits on every run.

#include <cstdint>

#include <cuda_runtime.h>

// The layout of one call's matrices: K and K^-1 at n * k_nstride floats
// (0: one for every grid), T[s, n] at s * t_sstride + n * t_nstride floats,
// each 4x4 row-major.
struct Mats {
  const float* k;
  const float* kinv;
  const float* t;
  long long k_nstride, kinv_nstride, t_sstride, t_nstride;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = 8;  // a thread's pixels in the backward
constexpr int kTile = kThreads * kPixels;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-7f;  // the divide's guard, as in ops.project

// One source's transform and intrinsics, read by every thread of a CTA.
struct Pose {
  float r[9], t[3], k[9];
};

__device__ __forceinline__ Pose load_pose(const Mats& m, int s, int n) {
  Pose q;
  const float* t = m.t + s * m.t_sstride + n * m.t_nstride;
  const float* k = m.k + n * m.k_nstride;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q.r[3 * i + j] = __ldg(t + 4 * i + j);
      q.k[3 * i + j] = __ldg(k + 3 * i + j);
    }
    q.t[i] = __ldg(t + 4 * i + 3);
  }
  return q;
}

// r = K^-1 (col, row, 1)^T for pixel p of a w-wide grid.
__device__ __forceinline__ void ray(const Mats& m, int n, int p, int w, float r[3]) {
  const float* ki = m.kinv + n * m.kinv_nstride;
  const int row = p / w;
  const float fx = static_cast<float>(p - row * w), fy = static_cast<float>(row);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = __ldg(ki + 3 * i) * fx + __ldg(ki + 3 * i + 1) * fy + __ldg(ki + 3 * i + 2);
}

// c = R p + t and u = K c.
__device__ __forceinline__ void transform(const Pose& q, const float p[3], float c[3],
                                          float u[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = q.r[3 * i] * p[0] + q.r[3 * i + 1] * p[1] + q.r[3 * i + 2] * p[2] + q.t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u[i] = q.k[3 * i] * c[0] + q.k[3 * i + 1] * c[1] + q.k[3 * i + 2] * c[2];
}

__global__ void __launch_bounds__(kThreads)
    project_depth_kernel(const float* __restrict__ depth, const Mats m, float* __restrict__ xo,
                         float* __restrict__ yo, float* __restrict__ zo, int n_grids,
                         int n_src, int h, int w) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= hw) return;
  float r[3], pt[3], c[3], u[3];
  ray(m, n, p, w, r);
  const float d = depth[static_cast<long long>(n) * hw + p];
#pragma unroll
  for (int i = 0; i < 3; ++i) pt[i] = d * r[i];
  for (int s = 0; s < n_src; ++s) {
    transform(load_pose(m, s, n), pt, c, u);
    const float den = u[2] + kEps;
    const long long o = (static_cast<long long>(s) * n_grids + n) * hw + p;
    xo[o] = u[0] / den;
    yo[o] = u[1] / den;
    zo[o] = u[2];
  }
}

// v summed over the warp by a shuffle tree; lane 0 holds the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    project_depth_bwd_kernel(const float* __restrict__ depth, const Mats m,
                             const float* __restrict__ gx, const float* __restrict__ gy,
                             const float* __restrict__ gz, float* __restrict__ d_depth,
                             float* __restrict__ partial, int n_grids, int n_src, int h,
                             int w) {
  extern __shared__ float smem[];  // [kWarps][12]
  const int hw = h * w;
  const int n = blockIdx.y, tile = blockIdx.x, tiles = (hw + kTile - 1) / kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long grid0 = static_cast<long long>(n) * hw;
  float r[kPixels][3], d[kPixels], dd[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = tile * kTile + k * kThreads + threadIdx.x;
    d[k] = 0.0f;
    dd[k] = 0.0f;
    if (p < hw) {
      ray(m, n, p, w, r[k]);
      d[k] = depth[grid0 + p];
    }
  }
  for (int s = 0; s < n_src; ++s) {
    const Pose q = load_pose(m, s, n);
    const long long plane = (static_cast<long long>(s) * n_grids + n) * hw;
    float acc[12];  // d[R | t], row-major 3x4
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      const int p = tile * kTile + k * kThreads + threadIdx.x;
      if (p >= hw) continue;
      float pt[3], c[3], u[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) pt[i] = d[k] * r[k][i];
      transform(q, pt, c, u);
      const float inv = 1.0f / (u[2] + kEps);
      const float ex = __ldg(gx + plane + p), ey = __ldg(gy + plane + p);
      const float ez = __ldg(gz + plane + p);
      // x = u0 / den, y = u1 / den, z = u2: d/du2 of x is -x / den
      const float du[3] = {ex * inv, ey * inv,
                           ez - (ex * (u[0] * inv) + ey * (u[1] * inv)) * inv};
      float dc[3], dp = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dc[j] = q.k[j] * du[0] + q.k[3 + j] * du[1] + q.k[6 + j] * du[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[4 * i + j] += dc[i] * pt[j];
        acc[4 * i + 3] += dc[i];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dp += (q.r[j] * dc[0] + q.r[3 + j] * dc[1] + q.r[6 + j] * dc[2]) * r[k][j];
      dd[k] += dp;
    }
    float* out = partial + ((static_cast<long long>(s) * n_grids + n) * tiles + tile) * 12;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float v = warp_sum(acc[j]);
      if (lane == 0) smem[warp * 12 + j] = v;
    }
    __syncthreads();
    if (threadIdx.x < 12) {
      float v = 0.0f;
      for (int i = 0; i < kWarps; ++i) v += smem[i * 12 + threadIdx.x];
      out[threadIdx.x] = v;
    }
    __syncthreads();  // smem is the next source's
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = tile * kTile + k * kThreads + threadIdx.x;
    if (p < hw) d_depth[grid0 + p] = dd[k];
  }
}

// d_T (S*N, 4, 4): entry e of (s, n) is warp (s*N + n) * 16 + e; rows 0-2
// sum the tiles' partials in tile order, row 3 is zero.
__global__ void __launch_bounds__(kThreads)
    project_depth_sum_kernel(const float* __restrict__ partial, float* __restrict__ d_t,
                             int mats, int tiles) {
  const int g = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (g >= mats * 16) return;
  const int sn = g / 16, e = g % 16;
  if (e >= 12) {
    if (lane == 0) d_t[g] = 0.0f;
    return;
  }
  const float* src = partial + static_cast<long long>(sn) * tiles * 12 + e;
  float v = 0.0f;
  for (int i = lane; i < tiles; i += 32) v += src[static_cast<long long>(i) * 12];
  v = warp_sum(v);
  if (lane == 0) d_t[g] = v;
}

}  // namespace

extern "C" {

// The number of floats of the backward's partial sums for these shapes:
// the wrapper allocates them.
long long colvo_project_depth_partials(int n_grids, int n_src, int h, int w) {
  const long long tiles = (static_cast<long long>(h) * w + kTile - 1) / kTile;
  return static_cast<long long>(n_src) * n_grids * tiles * 12;
}

// Plain C entry points for ctypes. depth (N, h, w); x, y, z (S*N, h, w);
// Mats as above. Return the launch's cudaError_t (0 on success).
int colvo_project_depth_fwd(const float* depth, Mats m, float* x, float* y, float* z,
                            int n_grids, int n_src, int h, int w, cudaStream_t stream) {
  const long long hw = static_cast<long long>(h) * w;
  if (hw == 0 || n_grids == 0 || n_src == 0) return 0;
  if (hw > 0x7fffffffLL - kTile || n_grids > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads), n_grids);
  project_depth_kernel<<<grid, kThreads, 0, stream>>>(depth, m, x, y, z, n_grids, n_src, h, w);
  return static_cast<int>(cudaGetLastError());
}

// gx, gy, gz (S*N, h, w) the cotangents of x, y, z; d_depth (N, h, w);
// partial colvo_project_depth_partials(...) floats; d_t (S, N, 4, 4).
int colvo_project_depth_bwd(const float* depth, Mats m, const float* gx, const float* gy,
                            const float* gz, float* d_depth, float* partial, float* d_t,
                            int n_grids, int n_src, int h, int w, cudaStream_t stream) {
  const long long hw = static_cast<long long>(h) * w;
  if (n_grids == 0 || n_src == 0) return 0;
  if (hw > 0x7fffffffLL - kTile || n_grids > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((hw + kTile - 1) / kTile);
  if (tiles > 0) {  // (an empty grid: the sum kernel writes zeros)
    const dim3 grid(tiles, n_grids);
    const size_t bytes = kWarps * 12 * sizeof(float);
    project_depth_bwd_kernel<<<grid, kThreads, bytes, stream>>>(depth, m, gx, gy, gz, d_depth,
                                                                 partial, n_grids, n_src, h, w);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long warps = static_cast<long long>(n_src) * n_grids * 16;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  project_depth_sum_kernel<<<blocks, kThreads, 0, stream>>>(partial, d_t, n_src * n_grids,
                                                            tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

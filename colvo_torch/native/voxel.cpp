// Host-side native code of colvo_torch (a copy of colvo/native/voxel.cpp).
//
// What stays on the host and is hot in serving: the f64 chain of relative
// poses into a trajectory, and the voxel-grid downsampling of the stitched
// reconstruction (millions of points). The numpy plain versions
// (colvo_torch/vo/driver.py::chain_relative_poses_np,
// colvo_torch/vo/recon.py::voxel_downsample_np) take several passes over
// the data; these take one. Exposed through ctypes with a plain C
// interface.
//
// Build: colvo_torch/native/__init__.py compiles this with g++ -O3 on first
// use, into colvo_torch/native/_build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Slot {
  int64_t key;      // packed voxel coords; kEmpty = empty
  int64_t index;    // output slot index
};

constexpr int64_t kEmpty = INT64_MIN;

inline int64_t pack(int64_t x, int64_t y, int64_t z) {
  // 21 bits per signed coordinate (±1M cells)
  return ((x & 0x1FFFFF) << 42) | ((y & 0x1FFFFF) << 21) | (z & 0x1FFFFF);
}

inline uint64_t hash_key(int64_t k) {
  uint64_t h = static_cast<uint64_t>(k);
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  return h;
}

}  // namespace

extern "C" {

// Average points (and optional colors) within voxel cells.
//
// points:  n×3 float32 input
// colors:  n×3 float32 input or nullptr
// out_*:   preallocated n×3 float32 outputs (filled up to the return value)
// voxel:   cell size
// returns: number of unique cells (≤ n), in order of first appearance
int64_t voxel_downsample(const float* points, const float* colors, int64_t n,
                         float voxel, float* out_points, float* out_colors) {
  if (n == 0) return 0;
  // open addressing, power-of-two capacity ≥ 2n
  uint64_t cap = 1;
  while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
  std::vector<Slot> table(cap, Slot{kEmpty, 0});
  std::vector<double> acc_p(static_cast<size_t>(n) * 3, 0.0);
  std::vector<double> acc_c;
  if (colors) acc_c.assign(static_cast<size_t>(n) * 3, 0.0);
  std::vector<int64_t> counts(n, 0);

  const float inv = 1.0f / voxel;
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * 3;
    int64_t key = pack(static_cast<int64_t>(std::floor(p[0] * inv)),
                       static_cast<int64_t>(std::floor(p[1] * inv)),
                       static_cast<int64_t>(std::floor(p[2] * inv)));
    uint64_t slot = hash_key(key) & (cap - 1);
    while (true) {
      if (table[slot].key == key) break;
      if (table[slot].key == kEmpty) {
        table[slot].key = key;
        table[slot].index = n_unique++;
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
    int64_t out = table[slot].index;
    acc_p[out * 3 + 0] += p[0];
    acc_p[out * 3 + 1] += p[1];
    acc_p[out * 3 + 2] += p[2];
    if (colors) {
      const float* c = colors + i * 3;
      acc_c[out * 3 + 0] += c[0];
      acc_c[out * 3 + 1] += c[1];
      acc_c[out * 3 + 2] += c[2];
    }
    counts[out] += 1;
  }
  for (int64_t i = 0; i < n_unique; ++i) {
    double cnt = static_cast<double>(counts[i]);
    out_points[i * 3 + 0] = static_cast<float>(acc_p[i * 3 + 0] / cnt);
    out_points[i * 3 + 1] = static_cast<float>(acc_p[i * 3 + 1] / cnt);
    out_points[i * 3 + 2] = static_cast<float>(acc_p[i * 3 + 2] / cnt);
    if (colors) {
      out_colors[i * 3 + 0] = static_cast<float>(acc_c[i * 3 + 0] / cnt);
      out_colors[i * 3 + 1] = static_cast<float>(acc_c[i * 3 + 1] / cnt);
      out_colors[i * 3 + 2] = static_cast<float>(acc_c[i * 3 + 2] / cnt);
    }
  }
  return n_unique;
}

// Chain per-pair relative SE(3) transforms into global poses. rels: (n,4,4)
// row-major float64 target→source relative transforms; out: (n+1,4,4)
// cam→world chain with periodic rotation renormalization (Gram–Schmidt).
void chain_poses(const double* rels, int64_t n, int64_t renorm_every,
                 double* out) {
  double t[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  std::memcpy(out, t, sizeof(t));
  for (int64_t i = 0; i < n; ++i) {
    const double* r = rels + i * 16;
    // rel maps prev→cur, so cam→world updates by rel⁻¹ (rigid inverse)
    double rinv[16];
    // rotation transpose
    rinv[0] = r[0]; rinv[1] = r[4]; rinv[2] = r[8];
    rinv[4] = r[1]; rinv[5] = r[5]; rinv[6] = r[9];
    rinv[8] = r[2]; rinv[9] = r[6]; rinv[10] = r[10];
    // -Rᵀ·t
    rinv[3] = -(rinv[0] * r[3] + rinv[1] * r[7] + rinv[2] * r[11]);
    rinv[7] = -(rinv[4] * r[3] + rinv[5] * r[7] + rinv[6] * r[11]);
    rinv[11] = -(rinv[8] * r[3] + rinv[9] * r[7] + rinv[10] * r[11]);
    rinv[12] = rinv[13] = rinv[14] = 0.0; rinv[15] = 1.0;

    double next[16];
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) {
        double s = 0;
        for (int c = 0; c < 4; ++c) s += t[a * 4 + c] * rinv[c * 4 + b];
        next[a * 4 + b] = s;
      }
    std::memcpy(t, next, sizeof(t));

    // renorm_every <= 0 means "never renormalize"; an unguarded modulo here
    // would be a SIGFPE, not an exception.
    if (renorm_every > 0 && (i + 1) % renorm_every == 0) {
      // Gram–Schmidt on the 3×3 block (columns)
      double* m = t;
      double cx[3] = {m[0], m[4], m[8]};
      double cy[3] = {m[1], m[5], m[9]};
      double nx = std::sqrt(cx[0] * cx[0] + cx[1] * cx[1] + cx[2] * cx[2]);
      for (int a = 0; a < 3; ++a) cx[a] /= nx;
      double dot = cx[0] * cy[0] + cx[1] * cy[1] + cx[2] * cy[2];
      for (int a = 0; a < 3; ++a) cy[a] -= dot * cx[a];
      double ny = std::sqrt(cy[0] * cy[0] + cy[1] * cy[1] + cy[2] * cy[2]);
      for (int a = 0; a < 3; ++a) cy[a] /= ny;
      double cz[3] = {cx[1] * cy[2] - cx[2] * cy[1],
                      cx[2] * cy[0] - cx[0] * cy[2],
                      cx[0] * cy[1] - cx[1] * cy[0]};
      m[0] = cx[0]; m[4] = cx[1]; m[8] = cx[2];
      m[1] = cy[0]; m[5] = cy[1]; m[9] = cy[2];
      m[2] = cz[0]; m[6] = cz[1]; m[10] = cz[2];
    }
    std::memcpy(out + (i + 1) * 16, t, sizeof(t));
  }
}

}  // extern "C"

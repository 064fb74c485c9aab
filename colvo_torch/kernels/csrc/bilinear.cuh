// Shared bilinear tap math for the sampler (S) and scatter (T) kernels.
#pragma once

#include <cuda_runtime.h>

// Border-clamped taps along one axis of length n: lower index i0, upper
// index i1, fraction w. Mirrors colvo_torch.geometry.ops.bilinear_taps:
// floor(c) is clamped in float to [-1, n] before the int cast (cvt's
// saturation is not relied on), and for floor(c) >= 2^31 the upper tap
// wraps to 0 exactly as the reference's saturating int32 convert followed
// by a wrapping +1 does.
__device__ __forceinline__ void bilinear_taps(float c, int n, int& i0, int& i1,
                                              float& w) {
  const float f = floorf(c);
  w = c - f;
  const int i = static_cast<int>(fminf(fmaxf(f, -1.0f), static_cast<float>(n)));
  i0 = min(max(i, 0), n - 1);
  i1 = (f >= 2147483648.0f) ? 0 : min(max(i + 1, 0), n - 1);
}

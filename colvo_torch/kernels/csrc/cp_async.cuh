// Asynchronous global → shared copies (cp.async, sm_80+) for the fused-loss
// kernel's staging of its rectangular inputs.
#pragma once

#include <cuda_runtime.h>

// Copies one float, or writes 0 where `in` is false (the source is then not
// read, but must be a valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

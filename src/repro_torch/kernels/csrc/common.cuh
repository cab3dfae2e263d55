// Shared helpers of the plane kernels: 16-byte vectors of f32 or bf16
// elements, conversions to and from the f32 the math runs in, and the
// launch size that fills the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace plane {

// One 16-byte vector: 4 f32 or 8 bf16 consecutive elements, loaded and
// stored with one 128-bit access (callers check 16-byte alignment).
template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Blocks for a grid-stride loop over n_items: enough to cover them, at
// most blocks_per_sm resident blocks on every SM of the current device.
inline int64_t grid_blocks(int64_t n_items, int threads, int blocks_per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (n_items + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * blocks_per_sm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace plane

// Device helpers shared by the training-attention kernels
// (flash_attention.cu, block_sparse_attention.cu): the input types, the
// masked-score value and the counter-based dropout hash (and, through
// column_chunk.cuh, the column chunks of a wide head).
//
// `ops/_build.py` hashes every header in this directory into each
// library's digest, so an edited header rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>
#include <stdint.h>

#include "column_chunk.cuh"

namespace {

// DEFAULT_MASK_VALUE = -0.7 * f32max (flash_attention.py:31): finite, so
// a row whose keys are all masked still averages over them
constexpr float kMaskValue = -0.7f * FLT_MAX;

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// murmur3 fmix32 over the coordinates (flash_attention.py:67-76, :106):
// uint32 wrapping arithmetic, logical shifts, top 24 bits vs threshold.
__device__ __forceinline__ float drop_mult(uint32_t seed, uint32_t head,
                                          int q, int k, uint32_t thr,
                                          float inv_keep) {
  uint32_t h = static_cast<uint32_t>(q) * 0x9E3779B9u +
               static_cast<uint32_t>(k) * 0xC2B2AE35u + head * 0x85EBCA6Bu +
               seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (h >> 8) < thr ? inv_keep : 0.0f;
}

// the dropout hash's head coordinate of program (b * H + h) = bh over a
// rank's H heads: b * num_heads + head_offset + h, the head's coordinate
// in the unsharded model (num_heads its head count, head_offset the
// rows before this rank's times num_heads plus the rank's first head;
// num_heads == H is the unsharded b * H + h + head_offset)
__device__ __forceinline__ uint32_t global_head_of(int bh, int H,
                                                  int num_heads,
                                                  int head_offset) {
  return static_cast<uint32_t>(bh + (bh / H) * (num_heads - H) +
                               head_offset);
}

}  // namespace

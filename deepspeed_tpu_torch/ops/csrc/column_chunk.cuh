// The column chunks of a wide head, shared by every attention source
// (flash_attention.cu, block_sparse_attention.cu, flash_decode.cu). Past
// kColChunk columns a launch splits a head's output columns into chunks
// of it, one CTA each, and streams the score contraction over D in
// windows of it; at or below it one chunk holds every column.
// `ops/head_dim.py` holds the same width (COLUMN_CHUNK) and sets the
// count (n_col), which each entry checks against column_chunks(D).

#pragma once

#include <stdint.h>

namespace {

constexpr int kColChunk = 256;

__host__ __device__ __forceinline__ int64_t column_chunks(int64_t D) {
  return (D + kColChunk - 1) / kColChunk;
}

}  // namespace

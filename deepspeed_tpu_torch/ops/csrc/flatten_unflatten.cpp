// Flatten/unflatten: pack many arrays into one contiguous buffer and back.
//
// A copy of the JAX package's csrc/utils/flatten_unflatten.cpp (apex-style
// _flatten_dense_tensors/_unflatten_dense_tensors) for fp32 host arrays,
// built by g++ -fopenmp through ops/_build.py:load_host_library and
// wrapped for CPU tensors by ops/op_builder/utils.py.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Copy `count` source arrays (sizes[i] floats each) into `dst` back to back.
void ds_flatten(const float* const* srcs, const int64_t* sizes, int32_t count,
                float* dst) {
  int64_t offset = 0;
  // Prefix offsets first so the copies can run in parallel.
  int64_t* offsets = new int64_t[count];
  for (int32_t i = 0; i < count; ++i) {
    offsets[i] = offset;
    offset += sizes[i];
  }
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int32_t i = 0; i < count; ++i) {
    std::memcpy(dst + offsets[i], srcs[i], sizes[i] * sizeof(float));
  }
  delete[] offsets;
}

// Scatter `src` back into `count` destination arrays.
void ds_unflatten(const float* src, const int64_t* sizes, int32_t count,
                  float* const* dsts) {
  int64_t offset = 0;
  int64_t* offsets = new int64_t[count];
  for (int32_t i = 0; i < count; ++i) {
    offsets[i] = offset;
    offset += sizes[i];
  }
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int32_t i = 0; i < count; ++i) {
    std::memcpy(dsts[i], src + offsets[i], sizes[i] * sizeof(float));
  }
  delete[] offsets;
}

}  // extern "C"

// Block-sparse layout -> LUT construction (a copy of the JAX package's
// csrc/sparse_attention/lut_builder.cpp, built by g++ -fopenmp through
// ops/_build.py:load_host_library): per-(head, q-block) lists of nonzero
// k-block indices, OpenMP-parallel over rows. It serves
// ops/sparse_attention/block_sparse_attention.py:build_lut; the numpy
// builder there (build_lut_numpy) is its plain version, used by tests
// only, never as a fallback.

#include <cstdint>

extern "C" {

// layout: [H * nq * nk] 0/1 int64 (row-major). Writes:
//   lut  [H * nq * max_nnz] int32 (padded with 0)
//   nnz  [H * nq]           int32
// max_nnz must be >= the densest row (call ds_lut_max_nnz first).
void ds_build_lut(const int64_t* layout, int64_t H, int64_t nq, int64_t nk,
                  int64_t max_nnz, int32_t* lut, int32_t* nnz) {
#pragma omp parallel for
    for (int64_t row = 0; row < H * nq; ++row) {
        const int64_t* lrow = layout + row * nk;
        int32_t* lut_row = lut + row * max_nnz;
        int32_t count = 0;
        for (int64_t kb = 0; kb < nk; ++kb) {
            if (lrow[kb] != 0) {
                lut_row[count++] = static_cast<int32_t>(kb);
            }
        }
        for (int32_t j = count; j < max_nnz; ++j) lut_row[j] = 0;
        nnz[row] = count;
    }
}

int64_t ds_lut_max_nnz(const int64_t* layout, int64_t H, int64_t nq,
                       int64_t nk) {
    int64_t max_nnz = 1;
#pragma omp parallel for reduction(max : max_nnz)
    for (int64_t row = 0; row < H * nq; ++row) {
        const int64_t* lrow = layout + row * nk;
        int64_t count = 0;
        for (int64_t kb = 0; kb < nk; ++kb) count += (lrow[kb] != 0);
        if (count > max_nnz) max_nnz = count;
    }
    return max_nnz;
}

}  // extern "C"

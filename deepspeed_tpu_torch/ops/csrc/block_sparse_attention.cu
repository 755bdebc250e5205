// Block-sparse flash attention for training, for Hopper (sm_90a):
// forward, dQ and dK/dV over a block layout's lookup tables.
//
// Replaces three Pallas kernels of
// deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:
//   K7  `_pallas_impl` (kernel :241, pallas_call :320)  -> fwd_mma_kernel
//   K8a `_pallas_bwd_impl` dq_kernel (:381, call :429)  -> dq_mma_kernel
//   K8b `_pallas_bwd_impl` dkv_kernel (:450, call :508) -> dkv_mma_kernel
// Same functions: each (b*h, q-block) walks its row of the forward LUT
// (`lut[h, qi, j]` for j < `nnz[h, qi]`, the nonzero k-blocks of the
// layout) with an fp32 online softmax; dK/dV walk the transposed LUT
// (each k-block's nonzero q-blocks). The forward pre-scales q by
// sm_scale before its dot (:263), the backward scales the dot (:366-373);
// a causal mask inside a block pair writes the finite DEFAULT_MASK_VALUE
// (:268-270), so a row whose visited keys are all masked averages over
// them, as JAX does. `l` sums the undropped probabilities and the
// accumulator the dropped ones (:271-285); out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)). A row with no LUT entry writes out = 0
// and lse = -inf; dQ of such a row and dK/dV of a k-block no q-block
// visits are 0 (their loops run no iteration, so no -inf - -inf). The
// dropout multiplier is the counter hash at head b*H + h and global q/k
// positions (`dropout_multiplier`, flash_attention.py:45), bit for bit.
//
// What bounds them on the card: operations. At the BERT-Large bench
// shape (B 32, T 512, H 16, D 64, block 64, 5 of 8 k-blocks a row) the
// work is 21.5 GFLOP (K7), 32.2 GFLOP (K8a) and 43 GFLOP (K8b) against
// 135-235 MB, 8-15x past the card's ridge point even at the fp32 rate.
// So every kernel keeps the scores on chip and reads each visited K/V
// (or Q/dO) block once per visit, and the multiplies set the time.
//
// All three multiply on the tensor cores at the reference's fp32
// precision (the TPU kernels widen every operand to f32 before their
// dots, :263-264, :367, :401-417, :471-495): every product goes through
// `mma.sync.m16n8k8` in TF32 as three passes, hi.hi + hi.lo + lo.hi into
// fp32 accumulators (the small terms first), with hi = tf32_rna(x) and
// lo = tf32_rna(x - hi); only lo.lo, about 2^-22 of each product, is
// left out. bf16 and fp16 inputs are exact in TF32 (8 and 11 significant
// bits, exponents inside TF32's 8 bits, fp16 subnormals too), so on them
// every product whose operands are both inputs takes one pass and those
// with an fp32 left operand (dS, P) two. K7's left operand of S is q *
// sm_scale rounded to f32, as the JAX kernel forms it (:263): on a
// 2-byte input it is exact when sm_scale is a power of two (head dim 64
// or 256), which the wrapper decides per call (`q_exact`); else it
// keeps its lo term. At 495 TFLOP/s over three passes the bound is 165
// TFLOP/s, 2.5x the fp32 FMA rate. Design:
// - A CTA owns a tile of kR rows (64, or 32 at D > 128; a smaller block
//   is one tile) of its own block: q rows for the forward and dQ, k rows
//   for dK/dV. Warps are (kR / 16 row groups) x (D slices): each owns 16
//   rows and accumulates kDc columns of O or dQ (128) or of dK and dV (64
//   each) in registers; the row group's score chunk is recomputed by
//   each slice.
// - Own tiles (Q, dO or K, V) and the visited block's tiles (K, V or Q,
//   dO, with K8b's lse / delta rows) sit in shared memory, rows padded to
//   4 (mod 8) 32-bit words, so every fragment load below is free of bank
//   conflicts and every row 16-byte aligned. K7 stages its own Q once as
//   f32 q * sm_scale, split into hi and lo planes. The other tiles come
//   in by cp.async (16 bytes a copy where the strides allow it) in the
//   input type, and so do the visited blocks of K8b and of 2-byte
//   inputs, the next one copied into a second buffer while this one is
//   computed. f32 K7 and K8a split each visited element into hi and lo
//   once, as it is staged (hi in the tile, lo in a plane beside it),
//   instead of by each warp at each use; that takes the second buffer's
//   space, and the SM's other CTA computes while one stages. (K8b, with
//   twice K8a's B loads a tile, ran slower that way on the card.)
// - TF32 rounding is two integer instructions (tf32_rna), and the small
//   passes of S and dP sum in their own accumulators, so no chain of
//   dependent HMMA runs the whole length of D.
// - Per chunk of up to 32 visited rows: S (S^T in K8b) and dP by
//   m16n8k8 over D, then p, dS (and dropped p) elementwise in the
//   accumulator fragment at each element's (q, k) (row g / g + 8,
//   columns 2t / 2t + 1), then that fragment is the A operand of the
//   next product as it stands: A's k index t / t + 4 is read as visited
//   row 2t / 2t + 1, and B's k rows are read in the same order. Scores
//   never leave registers. K7's online softmax runs in the fragment: a
//   row lives in the four lanes of a quad, so its max and its sum take
//   two xor-shuffles (1, 2).
//
// Any head dim. Up to kColChunk (256) columns a tile row holds all of D.
// Past it a launch splits the output columns into chunks of kColChunk,
// one CTA each along grid z (`n_col`, from ops/head_dim.py), and each
// CTA streams the contraction of S (and dP) over D in windows of
// kColChunk columns through the same tiles (32 rows, staged
// synchronously), accumulating in registers. K8a / K8b
// visit their own chunk's window last, so the tiles then hold the
// columns their accumulation reads; K7 stages its V chunk beside the
// first window. Every chunk's CTA forms the same S in the same order,
// so their softmax statistics agree bit for bit; only chunk 0 writes
// lse. No atomics: each output element has one writer.
//
// The layout block (16, 32, 64 or 128) is a template parameter; T is a
// multiple of it (the wrapper checks), so no tile is ragged. q, k, v and
// dO are read in place as [B, T, H, D] through their strides; outputs
// are contiguous [B, T, H, D], lse / delta [B * H, T]. The LUTs are
// int32 device tensors the wrapper uploads once per layout.
//
// The source is built once per storage type (BSA_DTYPE, set by
// ops/_build.py: 0 f32, 1 bf16, 2 fp16) and part (BSA_PART: 0 the
// forward, 1 the backward), six nvcc runs side by side, each library
// taking only its own type and kernels.
//
// Interface: a plain C function (ctypes) taking a struct of 8-byte
// fields, launched on the caller's stream; it returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_common.cuh"

// The launch parameters: every field 8 bytes wide (mirrored by
// `_Params` in ops/sparse_attention/block_sparse_attention.py).
struct SparseParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;          // dO (backward)
  const float* lse;       // [B*H, T] (backward input)
  const float* delta;     // [B*H, T] (backward input)
  const int32_t* lut;     // [H, nb, max_nnz]: forward LUT, or transposed (K8b)
  const int32_t* nnz;     // [H, nb]
  void* out;              // [B, T, H, D] (K7)
  float* lse_out;         // [B*H, T] (K7)
  void* dq;               // [B, T, H, D] (K8a)
  void* dk;               // [B, T, H, D] (K8b)
  void* dv;
  int64_t B, T, H, D, block, max_nnz, causal, dropping, seed, keep_threshold;
  int64_t head_offset;    // the rank's rows and first head (global_head_of)
  int64_t num_heads;      // the unsharded model's heads (H at one rank)
  int64_t n_col;          // column chunks of kColChunk (grid z)
  int64_t q_exact;        // K7: q * sm_scale is exact in TF32 (no lo term)
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  double sm_scale, inv_keep;
};

namespace {

// ---------------------------------------------------------------------------
// The tensor-core pieces: mma.sync m16n8k8 TF32, three passes
// ---------------------------------------------------------------------------

// round to TF32 (10 explicit mantissa bits), nearest, ties away from
// zero: what cvt.rna.tf32.f32 gives for every finite x, in two integer
// instructions (half a step added to the magnitude bits, the 13 low bits
// cleared), which issue faster on the card than the cvt
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as TF32 operands: hi = tf32(x), lo = tf32(x - hi); a value exact in
// TF32 (a bf16 input) is its own hi and has no lo
template <bool kExact>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  }
}

// c += a.b for one 16 x 8 x 8 tile (fragments per the PTX ISA: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4,
// g); c0/c1 (g, 2t / 2t + 1), c2/c3 (g + 8, 2t / 2t + 1))
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b at fp32 precision: lo.hi + hi.lo + hi.hi, the small terms
// first; an exact operand has no lo term
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!kExactA) mma_tf32(c, al, bh);
  if (!kExactB) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// the same with the small terms summed in a second accumulator `cs`
// (added to c once the dot is done): two dependent chains of HMMA half as
// long, where a chain over D would leave the tensor pipe waiting
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3_split(float (&c)[4], float (&cs)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (!kExactA) mma_tf32(cs, al, bh);
  if (!kExactB) mma_tf32(cs, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// 32-bit words of a staged row of D elements of `bytes` each: the row
// rounded up to 8 words, plus 4, so rows sit 4 (mod 8) words apart (no
// bank conflict in any fragment load) and start 16-byte aligned
__host__ __device__ __forceinline__ int row_words(int D, int bytes) {
  return (D * bytes + 31) / 32 * 8 + 4;
}

// the tiling of one K8 instance: kDkv selects K8b
template <int kBlk, int kDmax, bool kDkv>
struct MmaTile {
  static constexpr int kRmax = kDmax > 128 ? 32 : 64;
  static constexpr int kR = kBlk < kRmax ? kBlk : kRmax;  // rows a CTA owns
  static constexpr int kSub = kBlk / kR;        // tiles a block
  static constexpr int kRowWarps = kR / 16;     // 16 rows a warp
  // accumulator columns a warp owns: dQ 128, dK and dV 64 each
  static constexpr int kDc = kDkv ? 64 : (kDmax < 128 ? kDmax : 128);
  static constexpr int kSlices = kDmax / kDc;   // warps sharing 16 rows
  static constexpr int kThreads = 32 * kRowWarps * kSlices;
  static constexpr int kNt = kR / 8 < 4 ? kR / 8 : 4;  // n-tiles a chunk
  static constexpr int kChunk = 8 * kNt;        // visited rows a chunk
  static constexpr int kAcc = kDc / 8;          // n-tiles of an accumulator
};

// rows [r0, r0 + kR) of a [B, T, H, D] tensor of (b, h) into a staged
// tile with `lde` elements a row: 16-byte cp.async copies when `vec`
// (D * sizeof(T), base and strides all multiples of 16 bytes), else one
// element a thread, synchronously
template <typename T, int kR, int kThr>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int64_t sb,
                                           int64_t st, int64_t sh, int b,
                                           int h, int r0, int D, int lde,
                                           bool vec) {
  const T* base = src + b * sb + h * sh + static_cast<int64_t>(r0) * st;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = D / kPer;
    for (int i = threadIdx.x; i < kR * chunks; i += kThr) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPer;
      cp_async16(dst + r * lde + c, base + r * st + c);
    }
  } else {
    for (int i = threadIdx.x; i < kR * D; i += kThr) {
      const int r = i / D;
      const int d = i - r * D;
      dst[r * lde + d] = base[r * st + d];
    }
  }
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a staged tile
template <bool kExact, typename T>
__device__ __forceinline__ void load_a(const T* tile, int lde, int r0,
                                       int c0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const T* at = tile + (r0 + g) * lde + c0 + t;
  split_tf32<kExact>(to_f32(at[0]), hi[0], lo[0]);
  split_tf32<kExact>(to_f32(at[8 * lde]), hi[1], lo[1]);
  split_tf32<kExact>(to_f32(at[4]), hi[2], lo[2]);
  split_tf32<kExact>(to_f32(at[8 * lde + 4]), hi[3], lo[3]);
}

// B fragment of X^T for X's rows [r0, r0 + 8) x columns [c0, c0 + 8):
// b0 = X[r0 + g][c0 + t], b1 = X[r0 + g][c0 + t + 4]
template <bool kExact, typename T>
__device__ __forceinline__ void load_bt(const T* tile, int lde, int r0,
                                        int c0, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const T* at = tile + (r0 + g) * lde + c0 + t;
  split_tf32<kExact>(to_f32(at[0]), hi[0], lo[0]);
  split_tf32<kExact>(to_f32(at[4]), hi[1], lo[1]);
}

// B fragment of X's rows [r0, r0 + 8) x columns [c0, c0 + 8), its k rows
// in the order an accumulator fragment gives them as an A operand (k
// index t is row 2t, t + 4 is row 2t + 1): b0 = X[r0 + 2t][c0 + g], b1 =
// X[r0 + 2t + 1][c0 + g]
template <bool kExact, typename T>
__device__ __forceinline__ void load_b_paired(const T* tile, int lde, int r0,
                                              int c0, int g, int t,
                                              uint32_t (&hi)[2],
                                              uint32_t (&lo)[2]) {
  const T* at = tile + (r0 + 2 * t) * lde + c0 + g;
  split_tf32<kExact>(to_f32(at[0]), hi[0], lo[0]);
  split_tf32<kExact>(to_f32(at[lde]), hi[1], lo[1]);
}

// an accumulator fragment (rows g / g + 8, columns 2t / 2t + 1) as the A
// operand over those 8 columns, split into TF32 hi / lo
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32<false>(c[0], hi[0], lo[0]);
  split_tf32<false>(c[2], hi[1], lo[1]);
  split_tf32<false>(c[1], hi[2], lo[2]);
  split_tf32<false>(c[3], hi[3], lo[3]);
}

// four f32 values split into TF32 hi (to `hi`) and lo (to `lo`)
__device__ __forceinline__ void store_split4(float* hi, float* lo,
                                             float4 x) {
  uint32_t h4[4], l4[4];
  split_tf32<false>(x.x, h4[0], l4[0]);
  split_tf32<false>(x.y, h4[1], l4[1]);
  split_tf32<false>(x.z, h4[2], l4[2]);
  split_tf32<false>(x.w, h4[3], l4[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
}

// rows [r0, r0 + kR) of a [B, T, H, D] f32 tensor of (b, h), split once
// as they are staged: TF32 hi into `hi`, lo into `lo` (16-byte loads when
// `vec`)
template <int kR, int kThr>
__device__ __forceinline__ void stage_split(float* hi, float* lo,
                                           const float* src, int64_t sb,
                                           int64_t st, int64_t sh, int b,
                                           int h, int r0, int D, int lde,
                                           bool vec) {
  const float* base = src + b * sb + h * sh + static_cast<int64_t>(r0) * st;
  if (vec) {
    const int chunks = D / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kR * chunks; i += kThr) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 4;
      store_split4(hi + r * lde + c, lo + r * lde + c,
                   *reinterpret_cast<const float4*>(base + r * st + c));
    }
  } else {
    for (int i = threadIdx.x; i < kR * D; i += kThr) {
      const int r = i / D;
      const int d = i - r * D;
      uint32_t h1, l1;
      split_tf32<false>(base[r * st + d], h1, l1);
      hi[r * lde + d] = __uint_as_float(h1);
      lo[r * lde + d] = __uint_as_float(l1);
    }
  }
}

// load_bt and load_b_paired on a tile split at staging (hi, lo planes)
__device__ __forceinline__ void load_bt_split(const float* hi,
                                              const float* lo, int lde,
                                              int r0, int c0, int g, int t,
                                              uint32_t (&bh)[2],
                                              uint32_t (&bl)[2]) {
  const int i = (r0 + g) * lde + c0 + t;
  bh[0] = __float_as_uint(hi[i]);
  bh[1] = __float_as_uint(hi[i + 4]);
  bl[0] = __float_as_uint(lo[i]);
  bl[1] = __float_as_uint(lo[i + 4]);
}

__device__ __forceinline__ void load_b_paired_split(const float* hi,
                                                    const float* lo, int lde,
                                                    int r0, int c0, int g,
                                                    int t, uint32_t (&bh)[2],
                                                    uint32_t (&bl)[2]) {
  const int i = (r0 + 2 * t) * lde + c0 + g;
  bh[0] = __float_as_uint(hi[i]);
  bh[1] = __float_as_uint(hi[i + lde]);
  bl[0] = __float_as_uint(lo[i]);
  bl[1] = __float_as_uint(lo[i + lde]);
}

// The part of the source this library is built with (ops/_build.py
// passes -DBSA_PART): 0 the forward K7, 1 the backward K8a and K8b
#ifndef BSA_PART
#define BSA_PART 0
#endif

// rows [r0, r0 + kR) x columns [0, n) of a [B, T, H, D] tensor of (b, h)
// (`src` at the first column), times `scale` in f32, split into TF32 hi
// and lo planes of row stride `ld`
template <typename T, int kR, int kThr>
__device__ __forceinline__ void stage_scaled_split(
    float* hi, float* lo, const T* src, int64_t sb, int64_t st, int64_t sh,
    int b, int h, int r0, int n, int ld, float scale) {
  const T* base = src + b * sb + h * sh + static_cast<int64_t>(r0) * st;
  for (int i = threadIdx.x; i < kR * n; i += kThr) {
    const int r = i / n;
    const int d = i - r * n;
    uint32_t h1, l1;
    split_tf32<false>(to_f32(base[r * st + d]) * scale, h1, l1);
    hi[r * ld + d] = __uint_as_float(h1);
    lo[r * ld + d] = __uint_as_float(l1);
  }
}

// the A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a tile
// split at staging (hi, lo planes); the lo plane only when `with_lo`
__device__ __forceinline__ void load_a_split(const float* hi, const float* lo,
                                             int ld, int r0, int c0, int g,
                                             int t, bool with_lo,
                                             uint32_t (&ah)[4],
                                             uint32_t (&al)[4]) {
  const int i = (r0 + g) * ld + c0 + t;
  ah[0] = __float_as_uint(hi[i]);
  ah[1] = __float_as_uint(hi[i + 8 * ld]);
  ah[2] = __float_as_uint(hi[i + 4]);
  ah[3] = __float_as_uint(hi[i + 8 * ld + 4]);
  if (with_lo) {
    al[0] = __float_as_uint(lo[i]);
    al[1] = __float_as_uint(lo[i + 8 * ld]);
    al[2] = __float_as_uint(lo[i + 4]);
    al[3] = __float_as_uint(lo[i + 8 * ld + 4]);
  }
}

// columns [c_from, (c_from + 7) & ~7) of `rows` rows (stride ld) set to
// zero: the pad the last 8-column step of a product reads
template <typename T, int kThr>
__device__ __forceinline__ void zero_pad(T* tile, int ld, int rows,
                                         int c_from) {
  const int w = ((c_from + 7) & ~7) - c_from;
  for (int i = threadIdx.x; i < rows * w; i += kThr) {
    const int r = i / w;
    tile[r * ld + c_from + (i - r * w)] = from_f32<T>(0.0f);
  }
}

// K7: grid (B*H, nq * kSub, n_col); the CTA owns kR q rows of a q-block
// and the output columns of its column chunk, walks the forward LUT's
// k-blocks and keeps the online softmax and O in registers. kWide (past
// kColChunk columns, kDmax 256 only) compiles the column chunks' code.
template <typename T, int kBlk, int kDmax, bool kWide>
__device__ __forceinline__ void fwd_mma(const SparseParams& p, bool vec) {
  using G = MmaTile<kBlk, kDmax, false>;       // K8a's tiling
  constexpr int kR = G::kR, kThr = G::kThreads, kNt = G::kNt;
  constexpr int kAcc = G::kAcc, kDc = G::kDc;
  constexpr bool kExact = sizeof(T) == 2;      // 2-byte K, V exact in TF32
  // f32 splits each visited element once, at staging (on the card faster
  // than splitting at each use from the cp.async double buffer); 2-byte
  // inputs need no split and keep the double buffer
  constexpr bool kSplitOnce = !kExact;
  static_assert(kDmax <= 128 || kR == G::kChunk,
                "a wide head's window is staged once per visited tile");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = static_cast<int>(p.D);
  static_assert(!kWide || kDmax == 256, "a wide head takes 256-column rows");
  constexpr bool wide = kWide;
  // the column chunk is read from the grid even where it is 0: with it
  // folded to a constant ptxas gives f32 K7 at head dim 64 168 registers
  // in place of 197, and the kernel took 12% longer on the card
  const int cc = blockIdx.z, oc0 = cc * kColChunk;
  const int on = min(kColChunk, D - oc0);      // this CTA's output columns
  const int oDp = (on + 7) & ~7;
  const int Dw = wide ? kColChunk : D;         // columns a tile row holds
  const int Tq = static_cast<int>(p.T), H = static_cast<int>(p.H);
  const int nb = Tq / kBlk;
  const int words = row_words(Dw, sizeof(T));
  const int lde = words * 4 / static_cast<int>(sizeof(T));
  const int ld32 = row_words(Dw, 4);
  const int plane = kR * ld32;                 // words of an f32 plane
  const int tile = kR * words;                 // words of a tile in T
  float* qhi = smem;                           // q * sm_scale, split
  float* qlo = smem + plane;
  float* vis = smem + 2 * plane;               // the visited tiles
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qb = blockIdx.y / G::kSub;
  const int q0 = qb * kBlk + (blockIdx.y - qb * G::kSub) * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % G::kRowWarps, slice = warp / G::kRowWarps;
  const int g = lane >> 2, t = lane & 3;
  const int r16 = rw * 16;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  // the dropout hash's head coordinate: this program's head in the
  // unsharded model, at its row of the global batch
  const uint32_t ghead = global_head_of(bh, H, static_cast<int>(p.num_heads),
                                        static_cast<int>(p.head_offset));
  const bool q_lo = !kExact || p.q_exact == 0;  // the scaled q has a lo
  const int lrow = h * nb + qb;
  const int n = p.nnz[lrow] * G::kSub;         // visited tiles
  const int32_t* lut = p.lut + static_cast<int64_t>(lrow) * p.max_nnz;
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  float acc[kAcc][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[a][r] = 0.0f;

  if (n > 0) {
    auto kv_tile = [&](int i) { return reinterpret_cast<T*>(vis + i * tile); };
    // split at staging (f32): K hi, V hi, K lo, V lo planes
    float* khi = vis;
    float* vhi = vis + plane;
    float* klo = vis + 2 * plane;
    float* vlo = vis + 3 * plane;
    // a wide head's window wi of Q and K (and V's output chunk beside the
    // first), staged synchronously into buffer 0
    auto stage_window = [&](int wi, int v0) {
      const int w0 = wi * kColChunk;
      const int wn = min(kColChunk, D - w0);
      __syncthreads();                 // the previous window is no longer read
      stage_scaled_split<T, kR, kThr>(qhi, qlo, qg + w0, p.q_sb, p.q_st,
                                      p.q_sh, b, h, q0, wn, ld32, sm_scale);
      if constexpr (kSplitOnce) {
        stage_split<kR, kThr>(khi, klo, reinterpret_cast<const float*>(kg) +
                              w0, p.k_sb, p.k_st, p.k_sh, b, h, v0, wn, ld32,
                              vec);
        if (wi == 0) {
          stage_split<kR, kThr>(vhi, vlo, reinterpret_cast<const float*>(vg)
                                + oc0, p.v_sb, p.v_st, p.v_sh, b, h, v0, on,
                                ld32, vec);
        }
      } else {
        stage_tile<T, kR, kThr>(kv_tile(0), kg + w0, p.k_sb, p.k_st, p.k_sh,
                                b, h, v0, wn, lde, vec);
        if (wi == 0) {
          stage_tile<T, kR, kThr>(kv_tile(1), vg + oc0, p.v_sb, p.v_st,
                                  p.v_sh, b, h, v0, on, lde, vec);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      zero_pad<float, kThr>(qhi, ld32, 2 * kR, wn);
      if constexpr (kSplitOnce) {
        zero_pad<float, kThr>(khi, ld32, kR, wn);
        zero_pad<float, kThr>(klo, ld32, kR, wn);
        if (wi == 0) {
          zero_pad<float, kThr>(vhi, ld32, kR, on);
          zero_pad<float, kThr>(vlo, ld32, kR, on);
        }
      } else {
        zero_pad<T, kThr>(kv_tile(0), lde, kR, wn);
        if (wi == 0) zero_pad<T, kThr>(kv_tile(1), lde, kR, on);
      }
      __syncthreads();
      return wn;
    };
    // one visited tile at v0: kt / vt its K and V tiles (TF32 hi halves
    // with kSplitOnce, klo_ / vlo_ the lo planes; else as staged)
    auto visit = [&](int v0, const T* kt, const T* vt, const float* klo_,
                     const float* vlo_) {
      auto frag_bt = [&](int r0, int c0, uint32_t (&bh_)[2],
                         uint32_t (&bl_)[2]) {
        if constexpr (!kSplitOnce) {
          load_bt<kExact>(kt, lde, r0, c0, g, t, bh_, bl_);
        } else {
          load_bt_split(reinterpret_cast<const float*>(kt), klo_, lde, r0,
                        c0, g, t, bh_, bl_);
        }
      };
      auto frag_b_paired = [&](int r0, int c0, uint32_t (&bh_)[2],
                               uint32_t (&bl_)[2]) {
        if constexpr (!kSplitOnce) {
          load_b_paired<kExact>(vt, lde, r0, c0, g, t, bh_, bl_);
        } else {
          load_b_paired_split(reinterpret_cast<const float*>(vt), vlo_, lde,
                              r0, c0, g, t, bh_, bl_);
        }
      };
      for (int c0 = 0; c0 < kR; c0 += G::kChunk) {
        float s[kNt][4], s_lo[kNt][4];
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[j][r] = s_lo[j][r] = 0.0f;
        const int n_win = wide ? static_cast<int>(gridDim.z) : 1;
        for (int wi = 0; wi < n_win; ++wi) {
          const int wn = wide ? stage_window(wi, v0) : D;
          const int wDp = (wn + 7) & ~7;
          // S = (q sm_scale) K^T: lo.hi + hi.lo (small terms, their own
          // accumulator) + hi.hi; an exact operand has no lo pass
          for (int kk = 0; kk < wDp; kk += 8) {
            uint32_t ah[4], al[4];
            load_a_split(qhi, qlo, ld32, r16, kk, g, t, q_lo, ah, al);
#pragma unroll
            for (int j = 0; j < kNt; ++j) {
              uint32_t bh_[2], bl_[2];
              frag_bt(c0 + 8 * j, kk, bh_, bl_);
              if (q_lo) mma_tf32(s_lo[j], al, bh_);
              if (!kExact) mma_tf32(s_lo[j], ah, bl_);
              mma_tf32(s[j], ah, bh_);
            }
          }
        }
        // the causal mask, then the online softmax over this chunk's keys:
        // a thread holds rows g (r 0, 1) and g + 8 (r 2, 3), the rest of
        // each row is in the other lanes of its quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qpos = q0 + r16 + g + 8 * (r >> 1);
            const int kpos = v0 + c0 + 8 * j + 2 * t + (r & 1);
            float x = s[j][r] + s_lo[j][r];
            if (p.causal && kpos > qpos) x = kMaskValue;
            s[j][r] = x;
            mx[r >> 1] = fmaxf(mx[r >> 1], x);
          }
        }
        float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          // every score is finite (masked ones too), so m_new is finite
          const float m_new = fmaxf(m[i], mx[i]);
          corr[i] = expf(m[i] - m_new);
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float pr = expf(s[j][r] - m[r >> 1]);
            psum[r >> 1] += pr;
            if (p.dropping) {
              const int qpos = q0 + r16 + g + 8 * (r >> 1);
              const int kpos = v0 + c0 + 8 * j + 2 * t + (r & 1);
              pr *= drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
            }
            s[j][r] = pr;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
          psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
          l[i] = l[i] * corr[i] + psum[i];     // l sums the undropped probs
        }
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a][r] *= corr[r >> 1];
        // O += P.V over this chunk's keys, P (dropped) split hi / lo
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t ph[4], pl[4];
          acc_as_a(s[j], ph, pl);
#pragma unroll
          for (int a = 0; a < kAcc; ++a) {
            const int d0 = slice * kDc + 8 * a;
            if (d0 < oDp) {
              uint32_t bh_[2], bl_[2];
              frag_b_paired(c0 + 8 * j, d0, bh_, bl_);
              mma3<false, kExact>(acc[a], ph, pl, bh_, bl_);
            }
          }
        }
      }
    };
    auto tile_v0 = [&](int e) {
      return lut[e / G::kSub] * kBlk + (e % G::kSub) * kR;
    };
    // the own q tile, scaled and split once; the pad columns [D, Dp) of
    // every tile read by the last 8-column step, zeroed once (a wide
    // head stages its windows inside `visit`)
    if (!wide) {
      stage_scaled_split<T, kR, kThr>(qhi, qlo, qg, p.q_sb, p.q_st, p.q_sh,
                                      b, h, q0, D, ld32, sm_scale);
      zero_pad<float, kThr>(qhi, ld32, 2 * kR, D);
      if constexpr (kSplitOnce) {
        zero_pad<float, kThr>(vis, ld32, 4 * kR, D);
      } else {
        zero_pad<T, kThr>(kv_tile(0), lde, 4 * kR, D);
      }
    }
    // 2-byte: the next visited tile is copied (cp.async) into the second
    // buffer while this one is computed; the LUT is read a step ahead
    auto prefetch = [&](int e) {
      const int v0 = tile_v0(e);
      const int buf = e & 1;
      stage_tile<T, kR, kThr>(kv_tile(2 * buf), kg, p.k_sb, p.k_st, p.k_sh,
                              b, h, v0, D, lde, vec);
      stage_tile<T, kR, kThr>(kv_tile(2 * buf + 1), vg, p.v_sb, p.v_st,
                              p.v_sh, b, h, v0, D, lde, vec);
    };
    // f32: each visited element split into TF32 hi / lo once, as it is
    // staged; at D <= 64 (16-byte rows) the next visited tile waits in
    // registers, 64 a thread, while this one is computed; past it the
    // staging is synchronous
    const float* k32 = reinterpret_cast<const float*>(kg);
    const float* v32 = reinterpret_cast<const float*>(vg);
    constexpr int kPre = kSplitOnce && kDmax == 64
                             ? kR * kDmax / (4 * kThr) : 1;
    const bool reg_prefetch = kSplitOnce && kDmax == 64 && vec;
    const int chunks = D / 4;
    float4 pre1[kPre], pre2[kPre];
    auto fetch = [&](int e) {
      const int v0 = tile_v0(e);
      const float* s1 = k32 + b * p.k_sb + h * p.k_sh +
                        static_cast<int64_t>(v0) * p.k_st;
      const float* s2 = v32 + b * p.v_sb + h * p.v_sh +
                        static_cast<int64_t>(v0) * p.v_st;
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int i = threadIdx.x + k * kThr;
        if (i < kR * chunks) {
          const int r = i / chunks;
          const int c = (i - r * chunks) * 4;
          pre1[k] = *reinterpret_cast<const float4*>(s1 + r * p.k_st + c);
          pre2[k] = *reinterpret_cast<const float4*>(s2 + r * p.v_st + c);
        }
      }
    };
    if (!wide) {
      if constexpr (!kSplitOnce) {
        prefetch(0);
        cp_async_commit();
      } else {
        if (reg_prefetch) fetch(0);
      }
    }
    for (int e = 0; e < n; ++e) {
      const int v0 = tile_v0(e);
      const T* kt;
      const T* vt;
      if constexpr (!kSplitOnce) {
        const int buf = wide ? 0 : e & 1;
        if (!wide) {
          if (e + 1 < n) {
            prefetch(e + 1);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
        }
        kt = kv_tile(2 * buf);
        vt = kv_tile(2 * buf + 1);
      } else {
        if (!wide) {
          __syncthreads();   // the previous tile is no longer read
          if (reg_prefetch) {
#pragma unroll
            for (int k = 0; k < kPre; ++k) {
              const int i = threadIdx.x + k * kThr;
              if (i < kR * chunks) {
                const int at = (i / chunks) * ld32 + (i % chunks) * 4;
                store_split4(khi + at, klo + at, pre1[k]);
                store_split4(vhi + at, vlo + at, pre2[k]);
              }
            }
          } else {
            stage_split<kR, kThr>(khi, klo, k32, p.k_sb, p.k_st, p.k_sh, b,
                                  h, v0, D, ld32, vec);
            stage_split<kR, kThr>(vhi, vlo, v32, p.v_sb, p.v_st, p.v_sh, b,
                                  h, v0, D, ld32, vec);
          }
          __syncthreads();
          if (reg_prefetch && e + 1 < n) fetch(e + 1);
        }
        kt = reinterpret_cast<const T*>(khi);
        vt = reinterpret_cast<const T*>(vhi);
      }
      visit(v0, kt, vt, klo, vlo);
      if constexpr (!kSplitOnce) {
        if (!wide) __syncthreads();   // this buffer is refilled at e + 2
      }
    }
  }
  // out = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) from chunk 0
  // (an empty row: acc 0, m -inf, so out 0 and lse -inf)
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r16 + g + 8 * i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const int64_t at = ((static_cast<int64_t>(b) * Tq + row) * H + h) * D +
                       oc0;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = slice * kDc + 8 * a + 2 * t + c;
        if (d < on) out[at + d] = from_f32<T>(acc[a][2 * i + c] / l_safe);
      }
    }
    if (cc == 0 && slice == 0 && t == 0) {
      p.lse_out[static_cast<int64_t>(bh) * Tq + row] = m[i] + logf(l_safe);
    }
  }
}

// K7
template <typename T, int kBlk, int kDmax, bool kWide>
__global__ void __launch_bounds__(MmaTile<kBlk, kDmax, false>::kThreads)
    fwd_mma_kernel(const SparseParams p, int vec) {
  fwd_mma<T, kBlk, kDmax, kWide>(p, vec != 0);
}

// K8a (kDkv false): grid (B*H, nq * kSub); the CTA owns q rows, visits
// the forward LUT's k-blocks and accumulates dQ += dS.K.
// K8b (kDkv true): grid (B*H, nk * kSub); the CTA owns k rows, visits the
// transposed LUT's q-blocks and accumulates dK += dS^T.Q, dV += P^T.dO.
// In both, "own" rows index the score fragment's rows and "visited" rows
// its columns: S = Q.K^T in K8a, S^T = K.Q^T in K8b. kWide as for K7.
template <typename T, int kBlk, int kDmax, bool kDkv, bool kWide>
__device__ __forceinline__ void bwd_mma(const SparseParams& p, bool vec) {
  using G = MmaTile<kBlk, kDmax, kDkv>;
  constexpr int kR = G::kR, kThr = G::kThreads, kNt = G::kNt;
  constexpr int kAcc = G::kAcc, kDc = G::kDc;
  constexpr bool kExact = sizeof(T) == 2;      // bf16 / fp16 exact in TF32
  // f32 K8a splits each visited element once, at staging; K8b (twice
  // the B loads a tile: dK and dV) and 2-byte inputs keep the double
  // buffer
  constexpr bool kSplitOnce = !kExact && !kDkv;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = static_cast<int>(p.D), Dp = (D + 7) & ~7;
  static_assert(!kWide || kDmax == 256, "a wide head takes 256-column rows");
  constexpr bool wide = kWide;
  const int cc = wide ? blockIdx.z : 0, oc0 = cc * kColChunk;
  const int on = wide ? min(kColChunk, D - oc0) : D;  // output columns
  const int oDp = (on + 7) & ~7;
  const int Dw = wide ? kColChunk : D;         // columns a tile row holds
  const int Tq = static_cast<int>(p.T), H = static_cast<int>(p.H);
  const int nb = Tq / kBlk;
  const int words = row_words(Dw, sizeof(T));
  const int lde = words * 4 / static_cast<int>(sizeof(T));
  const int tile = kR * words;                 // 32-bit words of a tile
  T* own1 = reinterpret_cast<T*>(smem);        // Q (K8a) / K (K8b)
  T* own2 = reinterpret_cast<T*>(smem + tile); // dO / V
  float* stats = smem + 6 * tile;              // K8b: lse, delta [2][kR]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int ob = blockIdx.y / G::kSub;
  const int o0 = ob * kBlk + (blockIdx.y - ob * G::kSub) * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % G::kRowWarps, slice = warp / G::kRowWarps;
  const int g = lane >> 2, t = lane & 3;
  const int r16 = rw * 16;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  // the dropout hash's head coordinate: this program's head in the
  // unsharded model, at its row of the global batch
  const uint32_t ghead = global_head_of(bh, H, static_cast<int>(p.num_heads),
                                        static_cast<int>(p.head_offset));
  const int lrow = h * nb + ob;
  const int n = p.nnz[lrow] * G::kSub;         // visited tiles
  const int32_t* lut = p.lut + static_cast<int64_t>(lrow) * p.max_nnz;

  const T* o1 = static_cast<const T*>(kDkv ? p.k : p.q);
  const T* o2 = static_cast<const T*>(kDkv ? p.v : p.g);
  const T* v1 = static_cast<const T*>(kDkv ? p.q : p.k);
  const T* v2 = static_cast<const T*>(kDkv ? p.g : p.v);
  const int64_t o1b = kDkv ? p.k_sb : p.q_sb, o1t = kDkv ? p.k_st : p.q_st,
                o1h = kDkv ? p.k_sh : p.q_sh;
  const int64_t o2b = kDkv ? p.v_sb : p.g_sb, o2t = kDkv ? p.v_st : p.g_st,
                o2h = kDkv ? p.v_sh : p.g_sh;
  const int64_t v1b = kDkv ? p.q_sb : p.k_sb, v1t = kDkv ? p.q_st : p.k_st,
                v1h = kDkv ? p.q_sh : p.k_sh;
  const int64_t v2b = kDkv ? p.g_sb : p.v_sb, v2t = kDkv ? p.g_st : p.v_st,
                v2h = kDkv ? p.g_sh : p.v_sh;

  // K8a: lse / delta of this thread's own rows (g, g + 8); an empty row
  // never reads its -inf lse (its loop below is empty)
  float lse_r[2] = {0.0f, 0.0f}, delta_r[2] = {0.0f, 0.0f};
  if (!kDkv && n > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t at = static_cast<int64_t>(bh) * Tq + o0 + r16 + g + 8 * i;
      lse_r[i] = p.lse[at];
      delta_r[i] = p.delta[at];
    }
  }
  float acc1[kAcc][4], acc2[kDkv ? kAcc : 1][4];
#pragma unroll
  for (int j = 0; j < kAcc; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[j][r] = 0.0f;
#pragma unroll
  for (int j = 0; j < (kDkv ? kAcc : 1); ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc2[j][r] = 0.0f;

  if (n > 0) {
    // columns [D, Dp) of every tile are read by the last 8-column step
    if (!wide && D < Dp) {
      T* all = reinterpret_cast<T*>(smem);
      for (int i = threadIdx.x; i < 6 * kR * (Dp - D); i += kThr) {
        const int r = i / (Dp - D);
        all[r * lde + D + (i - r * (Dp - D))] = from_f32<T>(0.0f);
      }
      __syncthreads();
    }
    // one visited tile at v0: y1 / y2 its K, V (K8a) or Q, dO (K8b)
    // tiles. With kSplitOnce they hold the TF32 hi halves and y1lo / y2lo
    // the lo halves; else the tiles as staged, split at each use (bf16
    // needs no split)
    // a wide head's window of the own and visited tiles, staged
    // synchronously into buffer 0 (with K8b's lse / delta rows beside the
    // first); window wi is column chunk (cc + 1 + wi) mod n_col, so the
    // last is the CTA's own chunk, which the accumulation then reads
    auto stage_window = [&](int wi, int v0) {
      const int nw = static_cast<int>(gridDim.z);
      const int w0 = (cc + 1 + wi) % nw * kColChunk;
      const int wn = min(kColChunk, D - w0);
      T* y1 = reinterpret_cast<T*>(smem + 2 * tile);
      T* y2 = reinterpret_cast<T*>(smem + 3 * tile);
      __syncthreads();                 // the previous window is no longer read
      stage_tile<T, kR, kThr>(own1, o1 + w0, o1b, o1t, o1h, b, h, o0, wn,
                              lde, vec);
      stage_tile<T, kR, kThr>(own2, o2 + w0, o2b, o2t, o2h, b, h, o0, wn,
                              lde, vec);
      if constexpr (kSplitOnce) {
        float* y1lo = smem + 4 * tile;
        float* y2lo = smem + 5 * tile;
        stage_split<kR, kThr>(reinterpret_cast<float*>(y1), y1lo,
                              reinterpret_cast<const float*>(v1) + w0, v1b,
                              v1t, v1h, b, h, v0, wn, lde, vec);
        stage_split<kR, kThr>(reinterpret_cast<float*>(y2), y2lo,
                              reinterpret_cast<const float*>(v2) + w0, v2b,
                              v2t, v2h, b, h, v0, wn, lde, vec);
        zero_pad<float, kThr>(y1lo, lde, 2 * kR, wn);
      } else {
        stage_tile<T, kR, kThr>(y1, v1 + w0, v1b, v1t, v1h, b, h, v0, wn,
                                lde, vec);
        stage_tile<T, kR, kThr>(y2, v2 + w0, v2b, v2t, v2h, b, h, v0, wn,
                                lde, vec);
      }
      if (kDkv && wi == 0) {
        for (int i = threadIdx.x; i < kR; i += kThr) {
          const int64_t at = static_cast<int64_t>(bh) * Tq + v0 + i;
          stats[i] = p.lse[at];
          stats[kR + i] = p.delta[at];
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      zero_pad<T, kThr>(own1, lde, 4 * kR, wn);   // own1, own2, y1, y2
      __syncthreads();
      return wn;
    };
    auto visit = [&](int v0, const T* y1, const T* y2, const float* y1lo,
                     const float* y2lo, const float* lse_s,
                     const float* delta_s) {
      auto frag_bt = [&](const T* y, const float* ylo, int r0, int c0,
                         uint32_t (&bh_)[2], uint32_t (&bl_)[2]) {
        if constexpr (!kSplitOnce) {
          load_bt<kExact>(y, lde, r0, c0, g, t, bh_, bl_);
        } else {
          load_bt_split(reinterpret_cast<const float*>(y), ylo, lde, r0, c0,
                        g, t, bh_, bl_);
        }
      };
      auto frag_b_paired = [&](const T* y, const float* ylo, int r0, int c0,
                               uint32_t (&bh_)[2], uint32_t (&bl_)[2]) {
        if constexpr (!kSplitOnce) {
          load_b_paired<kExact>(y, lde, r0, c0, g, t, bh_, bl_);
        } else {
          load_b_paired_split(reinterpret_cast<const float*>(y), ylo, lde,
                              r0, c0, g, t, bh_, bl_);
        }
      };
      for (int c0 = 0; c0 < kR; c0 += G::kChunk) {
        float s[kNt][4], dp[kNt][4], s_lo[kNt][4], dp_lo[kNt][4];
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[j][r] = dp[j][r] = s_lo[j][r] = dp_lo[j][r] = 0.0f;
          }
        const int n_win = wide ? static_cast<int>(gridDim.z) : 1;
        for (int wi = 0; wi < n_win; ++wi) {
          const int wDp = wide ? (stage_window(wi, v0) + 7) & ~7 : Dp;
          for (int kk = 0; kk < wDp; kk += 8) {
            uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
            load_a<kExact>(own1, lde, r16, kk, g, t, a1h, a1l);
            load_a<kExact>(own2, lde, r16, kk, g, t, a2h, a2l);
#pragma unroll
            for (int j = 0; j < kNt; ++j) {
              uint32_t bh_[2], bl_[2];
              frag_bt(y1, y1lo, c0 + 8 * j, kk, bh_, bl_);
              mma3_split<kExact, kExact>(s[j], s_lo[j], a1h, a1l, bh_, bl_);
              frag_bt(y2, y2lo, c0 + 8 * j, kk, bh_, bl_);
              mma3_split<kExact, kExact>(dp[j], dp_lo[j], a2h, a2l, bh_,
                                         bl_);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[j][r] += s_lo[j][r];
            dp[j][r] += dp_lo[j][r];
          }
        // p = exp(s sm_scale - lse) (:366-373); s becomes the scaled dS,
        // dp (K8b) the dropped p
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int own = o0 + r16 + g + 8 * (r >> 1);
            const int col = c0 + 8 * j + 2 * t + (r & 1);
            const int qpos = kDkv ? v0 + col : own;
            const int kpos = kDkv ? own : v0 + col;
            float x = s[j][r] * sm_scale;
            if (p.causal && kpos > qpos) x = kMaskValue;
            const float l = kDkv ? lse_s[col] : lse_r[r >> 1];
            const float dl = kDkv ? delta_s[col] : delta_r[r >> 1];
            const float pr = expf(x - l);
            float mult = 1.0f;
            if (p.dropping) {
              mult = drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
            }
            s[j][r] = pr * (dp[j][r] * mult - dl) * sm_scale;
            if (kDkv) dp[j][r] = pr * mult;
          }
        }
        // acc1 += dS.(K | Q), acc2 += P.dO over this chunk's visited rows
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t dsh[4], dsl[4], pdh[4], pdl[4];
          acc_as_a(s[j], dsh, dsl);
          if (kDkv) acc_as_a(dp[j], pdh, pdl);
#pragma unroll
          for (int a = 0; a < kAcc; ++a) {
            const int d0 = slice * kDc + 8 * a;
            if (d0 < oDp) {
              uint32_t bh_[2], bl_[2];
              frag_b_paired(y1, y1lo, c0 + 8 * j, d0, bh_, bl_);
              mma3<false, kExact>(acc1[a], dsh, dsl, bh_, bl_);
              if (kDkv) {
                frag_b_paired(y2, y2lo, c0 + 8 * j, d0, bh_, bl_);
                mma3<false, kExact>(acc2[kDkv ? a : 0], pdh, pdl, bh_, bl_);
              }
            }
          }
        }
      }
    };
    auto tile_at = [&](int i) {
      return reinterpret_cast<T*>(smem + i * tile);
    };
    auto tile_v0 = [&](int e) {
      return lut[e / G::kSub] * kBlk + (e % G::kSub) * kR;
    };
    // (a wide head stages its windows inside `visit`)
    if (!wide) {
      stage_tile<T, kR, kThr>(own1, o1, o1b, o1t, o1h, b, h, o0, D, lde,
                              vec);
      stage_tile<T, kR, kThr>(own2, o2, o2b, o2t, o2h, b, h, o0, D, lde,
                              vec);
    }
    // K8b and 2-byte inputs: the next visited tile is copied (cp.async)
    // into the second buffer while this one is computed; the LUT is read
    // a step ahead
    auto prefetch = [&](int e) {
      const int v0 = tile_v0(e);
      const int buf = e & 1;
      stage_tile<T, kR, kThr>(tile_at(2 + 2 * buf), v1, v1b, v1t, v1h, b, h,
                              v0, D, lde, vec);
      stage_tile<T, kR, kThr>(tile_at(3 + 2 * buf), v2, v2b, v2t, v2h, b, h,
                              v0, D, lde, vec);
      if (kDkv) {
        // every visited q-block has this k-block in its LUT row: its
        // rows' lse are finite
        for (int i = threadIdx.x; i < kR; i += kThr) {
          const int64_t at = static_cast<int64_t>(bh) * Tq + v0 + i;
          cp_async4(stats + buf * 2 * kR + i, p.lse + at);
          cp_async4(stats + buf * 2 * kR + kR + i, p.delta + at);
        }
      }
    };
    // f32 K8a: each visited element is split into TF32 hi / lo once, as
    // it is staged, instead of by every warp at every use; tiles 2, 3
    // hold the hi halves and 4, 5 the lo halves (one buffer). At D <= 64
    // (16-byte rows) the next visited tile waits in registers, 64 a
    // thread, while this one is computed; past it the staging is
    // synchronous
    float* y1s = smem + 2 * tile;
    float* y2s = smem + 3 * tile;
    float* y1lo = smem + 4 * tile;
    float* y2lo = smem + 5 * tile;
    const float* k32 = reinterpret_cast<const float*>(v1);
    const float* v32 = reinterpret_cast<const float*>(v2);
    constexpr int kPre = kSplitOnce && kDmax == 64
                             ? kR * kDmax / (4 * kThr) : 1;
    const bool reg_prefetch = kSplitOnce && kDmax == 64 && vec;
    const int chunks = D / 4;
    float4 pre1[kPre], pre2[kPre];
    auto fetch = [&](int e) {
      const int v0 = tile_v0(e);
      const float* s1 = k32 + b * v1b + h * v1h +
                        static_cast<int64_t>(v0) * v1t;
      const float* s2 = v32 + b * v2b + h * v2h +
                        static_cast<int64_t>(v0) * v2t;
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int i = threadIdx.x + k * kThr;
        if (i < kR * chunks) {
          const int r = i / chunks;
          const int c = (i - r * chunks) * 4;
          pre1[k] = *reinterpret_cast<const float4*>(s1 + r * v1t + c);
          pre2[k] = *reinterpret_cast<const float4*>(s2 + r * v2t + c);
        }
      }
    };
    if (!wide) {
      if constexpr (!kSplitOnce) {
        prefetch(0);
      } else {
        if (reg_prefetch) fetch(0);
      }
      cp_async_commit();                // the own tiles (and tile 0)
      if constexpr (kSplitOnce) cp_async_wait<0>();
    }
    for (int e = 0; e < n; ++e) {
      const int v0 = tile_v0(e);
      const T* y1;
      const T* y2;
      const float* lse_s = stats;
      if constexpr (!kSplitOnce) {
        const int buf = wide ? 0 : e & 1;
        if (!wide) {
          if (e + 1 < n) {
            prefetch(e + 1);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
        }
        y1 = tile_at(2 + 2 * buf);
        y2 = tile_at(3 + 2 * buf);
        lse_s = stats + buf * 2 * kR;
      } else {
        if (!wide) {
          __syncthreads();   // the previous tile is no longer read
          if (reg_prefetch) {
#pragma unroll
            for (int k = 0; k < kPre; ++k) {
              const int i = threadIdx.x + k * kThr;
              if (i < kR * chunks) {
                const int at = (i / chunks) * lde + (i % chunks) * 4;
                store_split4(y1s + at, y1lo + at, pre1[k]);
                store_split4(y2s + at, y2lo + at, pre2[k]);
              }
            }
          } else {
            stage_split<kR, kThr>(y1s, y1lo, k32, v1b, v1t, v1h, b, h, v0,
                                  D, lde, vec);
            stage_split<kR, kThr>(y2s, y2lo, v32, v2b, v2t, v2h, b, h, v0,
                                  D, lde, vec);
          }
          __syncthreads();
          if (reg_prefetch && e + 1 < n) fetch(e + 1);
        }
        y1 = reinterpret_cast<const T*>(y1s);
        y2 = reinterpret_cast<const T*>(y2s);
      }
      visit(v0, y1, y2, y1lo, y2lo, lse_s, lse_s + kR);
      if constexpr (!kSplitOnce) {
        if (!wide) __syncthreads();   // this buffer is refilled at e + 2
      }
    }
  }
  // acc1 -> dQ (K8a) / dK (K8b), acc2 -> dV
  T* out1 = static_cast<T*>(kDkv ? p.dk : p.dq);
  T* out2 = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int own = o0 + r16 + g + 8 * i;
    const int64_t at = ((static_cast<int64_t>(b) * Tq + own) * H + h) * D +
                       oc0;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = slice * kDc + 8 * a + 2 * t + c;
        if (d < on) {
          out1[at + d] = from_f32<T>(acc1[a][2 * i + c]);
          if (kDkv) out2[at + d] = from_f32<T>(acc2[kDkv ? a : 0][2 * i + c]);
        }
      }
    }
  }
}

// K8a
template <typename T, int kBlk, int kDmax, bool kWide>
__global__ void __launch_bounds__(MmaTile<kBlk, kDmax, false>::kThreads)
    dq_mma_kernel(const SparseParams p, int vec) {
  bwd_mma<T, kBlk, kDmax, false, kWide>(p, vec != 0);
}

// K8b
template <typename T, int kBlk, int kDmax, bool kWide>
__global__ void __launch_bounds__(MmaTile<kBlk, kDmax, true>::kThreads)
    dkv_mma_kernel(const SparseParams p, int vec) {
  bwd_mma<T, kBlk, kDmax, true, kWide>(p, vec != 0);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// 16-byte cp.async copies need 16-byte rows, base addresses and strides
template <typename T>
bool vec_rows(const SparseParams& p) {
  const int64_t s = sizeof(T);
  if ((p.D * s) % 16 != 0) return false;
  for (const void* ptr : {p.q, p.k, p.v, p.g}) {
    if (!aligned16(ptr)) return false;
  }
  for (int64_t stride : {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh,
                         p.v_sb, p.v_st, p.v_sh, p.g_sb, p.g_st, p.g_sh}) {
    if ((stride * s) % 16 != 0) return false;
  }
  return true;
}

// shared memory of a launch: K7 the q planes (f32) and four visited
// tiles; K8 six tiles (K8b: lse / delta rows of two buffers beside)
template <typename T, int kR>
size_t smem_bytes(int which, int64_t D) {
  const int Dw = static_cast<int>(D < kColChunk ? D : kColChunk);
  const size_t words = row_words(Dw, sizeof(T));
  if (which == 0) {
    return (2 * static_cast<size_t>(kR) * row_words(Dw, 4) +
            4 * kR * words) * sizeof(float);
  }
  return (6 * kR * words + (which == 2 ? 4 * kR : 0)) * sizeof(float);
}

template <typename T, int kBlk, int kDmax, bool kWide = false>
cudaError_t launch_typed(int which, const SparseParams& p, cudaStream_t st) {
  using F = MmaTile<kBlk, kDmax, false>;
  using B = MmaTile<kBlk, kDmax, true>;
  void (*kernel)(const SparseParams, int);
  int threads;
  switch (which) {
#if BSA_PART == 0
    case 0: kernel = fwd_mma_kernel<T, kBlk, kDmax, kWide>;
      threads = F::kThreads;
      break;
#else
    case 1: kernel = dq_mma_kernel<T, kBlk, kDmax, kWide>;
      threads = F::kThreads;
      break;
    case 2: kernel = dkv_mma_kernel<T, kBlk, kDmax, kWide>;
      threads = B::kThreads;
      break;
#endif
    default: return cudaErrorInvalidValue;
  }
  const size_t bytes = smem_bytes<T, F::kR>(which, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(p.B * p.H),
                static_cast<unsigned>(p.T / kBlk * F::kSub),
                static_cast<unsigned>(p.n_col)),
           threads, bytes, st>>>(p, vec_rows<T>(p) ? 1 : 0);
  return cudaGetLastError();
}

// past 256 columns a kDmax 256 instance of its own (kWide, chosen here
// when n_col > 1) streams windows of 256; up to 256 the kernels hold no
// column-chunk code
template <typename T, int kBlk>
cudaError_t launch_dim(int which, const SparseParams& p, cudaStream_t st) {
  if (p.D <= 64) return launch_typed<T, kBlk, 64>(which, p, st);
  if (p.D <= 128) return launch_typed<T, kBlk, 128>(which, p, st);
  if (p.n_col > 1) return launch_typed<T, kBlk, 256, true>(which, p, st);
  return launch_typed<T, kBlk, 256>(which, p, st);
}

template <typename T>
cudaError_t launch_block(int which, const SparseParams& p, cudaStream_t st) {
  switch (p.block) {
    case 16: return launch_dim<T, 16>(which, p, st);
    case 32: return launch_dim<T, 32>(which, p, st);
    case 64: return launch_dim<T, 64>(which, p, st);
    case 128: return launch_dim<T, 128>(which, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// the storage type this library is built for (ops/_build.py passes
// -DBSA_DTYPE): 0 f32, 1 bf16, 2 fp16 (the DType codes)
#ifndef BSA_DTYPE
#define BSA_DTYPE 0
#endif
#if BSA_DTYPE == 0
using Elem = float;
#elif BSA_DTYPE == 1
using Elem = __nv_bfloat16;
#elif BSA_DTYPE == 2
using Elem = __half;
#else
#error "BSA_DTYPE must be 0 (f32), 1 (bf16) or 2 (fp16)"
#endif

}  // namespace

// `dtype` must be the library's own (BSA_DTYPE) and `which` one of its
// part's kernels (else cudaErrorInvalidValue); `n_col` the launch's
// column chunks, column_chunks(D)
extern "C" int block_sparse_attention_launch(int which,
                                             const SparseParams* p,
                                             int dtype, void* stream) {
  if (dtype != BSA_DTYPE || p->B < 1 || p->H < 1 || p->T < p->block ||
      p->T % p->block != 0 || p->D < 1 || p->max_nnz < 1 ||
      p->n_col != column_chunks(p->D) || p->n_col > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_block<Elem>(
      which, *p, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* block_sparse_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

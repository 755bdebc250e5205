// Block-sparse flash attention for training, for Hopper (sm_90a):
// forward, dQ and dK/dV over a block layout's lookup tables.
//
// Replaces three Pallas kernels of
// deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py:
//   K7  `_pallas_impl` (kernel :241, pallas_call :320)         -> fwd_kernel
//   K8a `_pallas_bwd_impl` dq_kernel (:381, pallas_call :429)  -> dq_kernel
//   K8b `_pallas_bwd_impl` dkv_kernel (:450, pallas_call :508) -> dkv_kernel
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
// What bounds it on the card: at the BERT-Large bench shape (B 32, T 512,
// H 16, D 64, block 64, 5 of 8 k-blocks a row) the work is 21.5 GFLOP
// (K7) to 43 GFLOP (K8b) against 135-235 MB, so the H100's bound is its
// memory rate; the kernel must read each visited K/V (or Q/dO) block once
// per visit and keep every score on chip. One CTA of 256 threads owns a
// tile of up to 64 rows of one layout block (a 128-block is two tiles),
// stages the visited blocks' tiles in padded shared memory, and never
// writes a score to device memory. This first version multiplies in fp32
// FMA (the TPU kernel's own precision: it widens every operand to f32
// before its dots), as K1-K3 do; each thread holds a (tile/16)^2 block
// of the score tile and (tile/16) x D/16 of the accumulator in
// registers. Tensor cores (mma.sync, then wgmma with TMA) come next.
//
// The layout block (16, 32, 64 or 128) is a template parameter; T is a
// multiple of it (the wrapper checks), so no tile is ragged. q, k, v and
// dO are read in place as [B, T, H, D] through their strides; outputs
// are contiguous [B, T, H, D], lse / delta [B * H, T]. The LUTs are int32
// device tensors the wrapper uploads once per layout.
//
// Interface: a plain C function (ctypes) taking a struct of 8-byte
// fields, launched on the caller's stream; it returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  double sm_scale, inv_keep;
};

namespace {

constexpr int kThreads = 256;   // 16 x 16 (tx, ty)

// tile geometry of a layout block: kR rows (and keys) per tile, kSub
// tiles per block, kI score rows (and columns) per thread
template <int kBlk>
struct Tile {
  static constexpr int kR = kBlk < 64 ? kBlk : 64;
  static constexpr int kSub = kBlk / kR;
  static constexpr int kI = kR / 16;
  static constexpr int kPs = kR + 1;   // padded row stride of a score tile
};

// rows [r0, r0 + kR) of a [B, T, H, D] tensor of (b, h) into a padded f32
// tile [kR][D + 1], times `scale`
template <typename T, int kR>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t sb, int64_t st, int64_t sh,
                                          int b, int h, int r0, int D,
                                          float scale) {
  const int ld = D + 1;
  const T* base = src + b * sb + h * sh + static_cast<int64_t>(r0) * st;
  for (int i = threadIdx.x; i < kR * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * ld + d] = to_f32(base[r * st + d]) * scale;
  }
}

// K7: grid (B*H, nq * kSub); one CTA per tile of a q-block
template <typename T, int kBlk, int kJ>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const SparseParams p) {
  using G = Tile<kBlk>;
  constexpr int kR = G::kR, kI = G::kI, kPs = G::kPs;
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), H = static_cast<int>(p.H);
  const int nb = Tq / kBlk;
  float* Qs = smem;
  float* Ks = Qs + kR * ld;
  float* Vs = Ks + kR * ld;
  float* Ps = Vs + kR * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qi = blockIdx.y / G::kSub;
  const int q0 = qi * kBlk + (blockIdx.y - qi * G::kSub) * kR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  const int row = h * nb + qi;
  const int n = p.nnz[row];
  const int32_t* lut = p.lut + static_cast<int64_t>(row) * p.max_nnz;

  // the TPU kernel scales q before its dot (:263)
  load_tile<T, kR>(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh,
                   b, h, q0, D, static_cast<float>(p.sm_scale));
  float m[kI], l[kI], acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  for (int e = 0; e < n * G::kSub; ++e) {
    const int k0 = lut[e / G::kSub] * kBlk + (e % G::kSub) * kR;
    __syncthreads();
    load_tile<T, kR>(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh,
                     b, h, k0, D, 1.0f);
    load_tile<T, kR>(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh,
                     b, h, k0, D, 1.0f);
    __syncthreads();
    float s[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[kI], c[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) a[i] = Qs[(ty * kI + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kI; ++j) c[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) s[i][j] += a[i] * c[j];
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int qpos = q0 + ty * kI + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        if (p.causal && k0 + tx + 16 * j > qpos) s[i][j] = kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      // every score is finite (masked ones too), so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float pr = expf(s[i][j] - m_new);
        psum += pr;
        if (p.dropping) {
          pr *= drop_mult(seed, static_cast<uint32_t>(bh), qpos, kpos, thr,
                          inv_keep);
        }
        Ps[(ty * kI + i) * kPs + tx + 16 * j] = pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l[i] = l[i] * corr + psum;         // l sums the undropped probs
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    for (int kk = 0; kk < kR; ++kk) {
      float pr[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) pr[i] = Ps[(ty * kI + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? Vs[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kI; ++i) acc[i][j] += pr[i] * vv;
      }
    }
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty * kI + i;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] / l_safe);
    }
    // an empty row: m = -inf, so lse = -inf
    if (tx == 0) p.lse_out[static_cast<int64_t>(bh) * Tq + t] =
        m[i] + logf(l_safe);
  }
}

// K8a: grid (B*H, nq * kSub); dq over the forward LUT's k-blocks
template <typename T, int kBlk, int kJ>
__global__ void __launch_bounds__(kThreads) dq_kernel(const SparseParams p) {
  using G = Tile<kBlk>;
  constexpr int kR = G::kR, kI = G::kI, kPs = G::kPs;
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), H = static_cast<int>(p.H);
  const int nb = Tq / kBlk;
  float* Qs = smem;
  float* Gs = Qs + kR * ld;
  float* Ks = Gs + kR * ld;
  float* Vs = Ks + kR * ld;
  float* Ss = Vs + kR * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qi = blockIdx.y / G::kSub;
  const int q0 = qi * kBlk + (blockIdx.y - qi * G::kSub) * kR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  const int row = h * nb + qi;
  const int n = p.nnz[row];
  const int32_t* lut = p.lut + static_cast<int64_t>(row) * p.max_nnz;

  float lse[kI], delta[kI], acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int64_t at = static_cast<int64_t>(bh) * Tq + q0 + ty * kI + i;
    // an empty row never reads its -inf lse: its loop below is empty
    lse[i] = n > 0 ? p.lse[at] : 0.0f;
    delta[i] = p.delta[at];
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  if (n > 0) {
    load_tile<T, kR>(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh,
                     b, h, q0, D, 1.0f);
    load_tile<T, kR>(Gs, static_cast<const T*>(p.g), p.g_sb, p.g_st, p.g_sh,
                     b, h, q0, D, 1.0f);
  }
  for (int e = 0; e < n * G::kSub; ++e) {
    const int k0 = lut[e / G::kSub] * kBlk + (e % G::kSub) * kR;
    __syncthreads();
    load_tile<T, kR>(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh,
                     b, h, k0, D, 1.0f);
    load_tile<T, kR>(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh,
                     b, h, k0, D, 1.0f);
    __syncthreads();
    float s[kI][kI], dp[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[kI], gg[kI], kc[kI], vc[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        a[i] = Qs[(ty * kI + i) * ld + d];
        gg[i] = Gs[(ty * kI + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        kc[j] = Ks[(tx + 16 * j) * ld + d];
        vc[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          s[i][j] += a[i] * kc[j];
          dp[i][j] += gg[i] * vc[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int qpos = q0 + ty * kI + i;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;      // scores_block (:366-373)
        if (p.causal && kpos > qpos) x = kMaskValue;
        const float pr = expf(x - lse[i]);
        float dpv = dp[i][j];
        if (p.dropping) {
          dpv *= drop_mult(seed, static_cast<uint32_t>(bh), qpos, kpos, thr,
                           inv_keep);
        }
        Ss[(ty * kI + i) * kPs + tx + 16 * j] =
            pr * (dpv - delta[i]) * sm_scale;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kR; ++kk) {
      float ds[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) ds[i] = Ss[(ty * kI + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float kv = d < D ? Ks[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kI; ++i) acc[i][j] += ds[i] * kv;
      }
    }
  }
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty * kI + i;
    T* drow = dq + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) drow[d] = from_f32<T>(acc[i][j]);
    }
  }
}

// K8b: grid (B*H, nk * kSub); dk, dv over the transposed LUT's q-blocks.
// Here ty owns kI keys and tx kI queries of the transposed score tile.
template <typename T, int kBlk, int kJ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const SparseParams p) {
  using G = Tile<kBlk>;
  constexpr int kR = G::kR, kI = G::kI, kPs = G::kPs;
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), H = static_cast<int>(p.H);
  const int nb = Tq / kBlk;
  float* Ks = smem;
  float* Vs = Ks + kR * ld;
  float* Qs = Vs + kR * ld;
  float* Gs = Qs + kR * ld;
  float* Pt = Gs + kR * ld;           // dropped probs, [key][query]
  float* St = Pt + kR * kPs;          // scaled dS, [key][query]
  float* lse_s = St + kR * kPs;
  float* delta_s = lse_s + kR;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int ki = blockIdx.y / G::kSub;
  const int k0 = ki * kBlk + (blockIdx.y - ki * G::kSub) * kR;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  const int row = h * nb + ki;
  const int n = p.nnz[row];
  const int32_t* lut = p.lut + static_cast<int64_t>(row) * p.max_nnz;

  if (n > 0) {
    load_tile<T, kR>(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh,
                     b, h, k0, D, 1.0f);
    load_tile<T, kR>(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh,
                     b, h, k0, D, 1.0f);
  }
  float dk[kI][kJ], dv[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk[i][j] = dv[i][j] = 0.0f;
  for (int e = 0; e < n * G::kSub; ++e) {
    // every visited q-block has this k-block in its LUT row: its rows'
    // lse are finite
    const int q0 = lut[e / G::kSub] * kBlk + (e % G::kSub) * kR;
    __syncthreads();
    load_tile<T, kR>(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh,
                     b, h, q0, D, 1.0f);
    load_tile<T, kR>(Gs, static_cast<const T*>(p.g), p.g_sb, p.g_st, p.g_sh,
                     b, h, q0, D, 1.0f);
    for (int c = threadIdx.x; c < kR; c += kThreads) {
      const int64_t at = static_cast<int64_t>(bh) * Tq + q0 + c;
      lse_s[c] = p.lse[at];
      delta_s[c] = p.delta[at];
    }
    __syncthreads();
    float s[kI][kI], dp[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kr[kI], vr[kI], qc[kI], gc[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        kr[i] = Ks[(ty * kI + i) * ld + d];
        vr[i] = Vs[(ty * kI + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        qc[j] = Qs[(tx + 16 * j) * ld + d];
        gc[j] = Gs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          s[i][j] += kr[i] * qc[j];
          dp[i][j] += vr[i] * gc[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int kpos = k0 + ty * kI + i;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        float x = s[i][j] * sm_scale;
        if (p.causal && kpos > qpos) x = kMaskValue;
        const float pr = expf(x - lse_s[c]);
        float mult = 1.0f;
        if (p.dropping) {
          mult = drop_mult(seed, static_cast<uint32_t>(bh), qpos, kpos, thr,
                           inv_keep);
        }
        Pt[(ty * kI + i) * kPs + c] = pr * mult;
        St[(ty * kI + i) * kPs + c] =
            pr * (dp[i][j] * mult - delta_s[c]) * sm_scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < kR; ++c) {
      float pr[kI], ds[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        pr[i] = Pt[(ty * kI + i) * kPs + c];
        ds[i] = St[(ty * kI + i) * kPs + c];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float gv = d < D ? Gs[c * ld + d] : 0.0f;
        const float qv = d < D ? Qs[c * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          dv[i][j] += pr[i] * gv;
          dk[i][j] += ds[i] * qv;
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int kpos = k0 + ty * kI + i;
    const int64_t at = ((static_cast<int64_t>(b) * Tq + kpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkp[at + d] = from_f32<T>(dk[i][j]);
        dvp[at + d] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

template <typename F>
cudaError_t launch_kernel(F kernel, size_t bytes, dim3 grid,
                          const SparseParams& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int kBlk, int kJ>
cudaError_t launch_typed(int which, const SparseParams& p, cudaStream_t st) {
  using G = Tile<kBlk>;
  constexpr int kR = G::kR, kPs = G::kPs;
  const size_t ld = static_cast<size_t>(p.D) + 1;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>(p.T / kBlk * G::kSub));
  switch (which) {
    case 0:
      return launch_kernel(fwd_kernel<T, kBlk, kJ>,
                           (3 * kR * ld + kR * kPs) * sizeof(float), grid, p,
                           st);
    case 1:
      return launch_kernel(dq_kernel<T, kBlk, kJ>,
                           (4 * kR * ld + kR * kPs) * sizeof(float), grid, p,
                           st);
    case 2:
      return launch_kernel(dkv_kernel<T, kBlk, kJ>,
                           (4 * kR * ld + 2 * kR * kPs + 2 * kR) *
                               sizeof(float),
                           grid, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int kBlk>
cudaError_t launch_dim(int which, const SparseParams& p, cudaStream_t st) {
  if (p.D <= 64) return launch_typed<T, kBlk, 4>(which, p, st);
  return launch_typed<T, kBlk, 8>(which, p, st);
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

}  // namespace

extern "C" int block_sparse_attention_launch(int which,
                                             const SparseParams* p,
                                             int dtype, void* stream) {
  if (p->B < 1 || p->H < 1 || p->T < p->block || p->T % p->block != 0 ||
      p->D < 1 || p->D > 128 || p->max_nnz < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: err = launch_block<float>(which, *p, st); break;
    case kBF16: err = launch_block<__nv_bfloat16>(which, *p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* block_sparse_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash attention for training, for Hopper (sm_90a): forward, dQ and
// dK/dV, the FlashAttention-2 split.
//
// Replaces three Pallas kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py:
//   K1 `_pallas_fwd` (kernel :311, pallas_call :391)      -> fwd_kernel
//   K2 `_pallas_bwd` dq_kernel (:489, pallas_call :545)   -> dq_kernel
//   K3 `_pallas_bwd` dkv_kernel (:556, pallas_call :655)  -> dkv_kernel
// Same functions: causal or not, an optional additive f32 key bias
// [B, S], in-kernel attention-prob dropout from the counter hash
// (bit-identical to `dropout_multiplier`, :45) at the global head
// coordinate bh + (bh / H) * (Hg - H) + offset (:358), the forward's
// logsumexp, the fully-masked-row guard max(l, 1e-30) (:370), and with a
// bias the per-head dbias partials (column sums of the pre-scale dS).
//
// What bounds it on the card: operations. Per (b, h) the work is
// O(T * S * D) against O((T + S) * D) bytes, far above the H100's ridge
// point, so the kernel must keep the [T, S] tiles on chip, as the TPU
// kernel keeps them in VMEM: one CTA owns a 64-row Q tile (K1, K2) or a
// 64-key KV tile (K3), stages the other side's 64-row tiles in shared
// memory, and never writes a score to device memory. This first version
// multiplies in fp32 FMA (the TPU kernel's own precision: it widens
// every operand to f32 before its dots); each thread holds a 4 x 4
// block of the score tile and a 4 x D/16 block of the accumulator in
// registers, reading the padded shared tiles without bank conflicts.
// Tensor-core products (mma.sync / wgmma with TMA) are the next step.
//
// Causal tiles above the diagonal are skipped (K1/K2 stop at the
// diagonal tile; K3 starts there). Any T and S: rows and keys past the
// end are zero-filled on load, excluded from the softmax and never
// written. q, k, v and dO are read in place as [B, T, H, D] through
// their strides; outputs are contiguous [B, T, H, D], lse / delta /
// dbias [B * H, T or S].
//
// Interface: a plain C function (ctypes) taking a struct of 8-byte
// fields, launched on the caller's stream; it returns the cudaError_t
// of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// The launch parameters: every field 8 bytes wide (mirrored by
// `_Params` in ops/flash_attention.py). At global scope: the extern "C"
// entry point takes a pointer to it.
struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;          // dO (backward)
  const float* bias;      // [B, S] or null
  const float* lse;       // [B*H, T] (backward input)
  const float* delta;     // [B*H, T] (backward input)
  void* out;              // [B, T, H, D] (K1)
  float* lse_out;         // [B*H, T] (K1)
  void* dq;               // [B, T, H, D] (K2)
  void* dk;               // [B, S, H, D] (K3)
  void* dv;
  float* dbias;           // [B*H, S] (K3, with a bias)
  int64_t B, T, S, H, D, causal, dropping, seed, head_offset, num_heads,
      keep_threshold;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  double sm_scale, inv_keep;
};

namespace {

constexpr int kB = 64;          // Q-tile rows = KV-tile keys
constexpr int kThreads = 256;   // 16 x 16: ty owns 4 rows, tx 4 columns
constexpr int kPs = kB + 1;     // padded row stride of a score tile
// DEFAULT_MASK_VALUE = -0.7 * f32max (flash_attention.py:31)
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

__device__ __forceinline__ uint32_t global_head(const AttnParams& p,
                                                int bh) {
  const int H = static_cast<int>(p.H);
  return static_cast<uint32_t>(bh + (bh / H) * (static_cast<int>(
      p.num_heads) - H) + static_cast<int>(p.head_offset));
}

// rows [r0, r0 + kB) of a [B, L, H, D] tensor of (b, h) into a padded
// f32 tile [kB][D + 1], times `scale`; rows past L are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t sb, int64_t sl, int64_t sh,
                                          int b, int h, int r0, int L,
                                          int D, float scale) {
  const int ld = D + 1;
  const T* base = src + b * sb + h * sh;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < L ? to_f32(base[row * sl + d]) * scale : 0.0f;
  }
}

// K1: grid (B*H, ceil(T / kB)); the heaviest causal tiles start first
template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Qs = smem;
  float* Ks = Qs + kB * ld;
  float* Vs = Ks + kB * ld;
  float* Ps = Vs + kB * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  // the TPU kernel scales q before its dot (:333)
  load_tile(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh, b, h, q0,
            Tq, D, sm_scale);
  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  const int k_end = p.causal ? min(S, q0 + kB) : S;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh, b, h,
              k0, S, D, 1.0f);
    load_tile(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh, b, h,
              k0, S, D, 1.0f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (p.causal && kpos > qpos) x = kMaskValue;
        if (kpos >= S) {
          x = -INFINITY;                 // past the end: excluded
        } else if (p.bias != nullptr) {
          x += p.bias[b * S + kpos];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      // every tile holds a key < S, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float pr = expf(s[i][j] - m_new);
        psum += pr;
        if (p.dropping) {
          pr *= drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
        }
        Ps[(ty * 4 + i) * kPs + tx + 16 * j] = pr;
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
    const int kn = min(kB, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? Vs[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pr[i] * vv;
      }
    }
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] / l_safe);
    }
    if (tx == 0) p.lse_out[static_cast<int64_t>(bh) * Tq + t] =
        m[i] + logf(l_safe);
  }
}

// K2: grid (B*H, ceil(T / kB)); dq accumulated over KV tiles
template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads) dq_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Qs = smem;
  float* Gs = Qs + kB * ld;
  float* Ks = Gs + kB * ld;
  float* Vs = Ks + kB * ld;
  float* Ss = Vs + kB * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  load_tile(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh, b, h, q0,
            Tq, D, 1.0f);
  load_tile(Gs, static_cast<const T*>(p.g), p.g_sb, p.g_st, p.g_sh, b, h, q0,
            Tq, D, 1.0f);
  float lse[4], delta[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    const int64_t at = static_cast<int64_t>(bh) * Tq + t;
    lse[i] = t < Tq ? p.lse[at] : 0.0f;
    delta[i] = t < Tq ? p.delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  const int k_end = p.causal ? min(S, q0 + kB) : S;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh, b, h,
              k0, S, D, 1.0f);
    load_tile(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh, b, h,
              k0, S, D, 1.0f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], gg[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * ld + d];
        gg[i] = Gs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * ld + d];
        vc[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * kc[j];
          dp[i][j] += gg[i] * vc[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float ds = 0.0f;
        if (kpos < S) {
          float x = s[i][j] * sm_scale;
          if (p.causal && kpos > qpos) x = kMaskValue;
          if (p.bias != nullptr) x += p.bias[b * S + kpos];
          const float pr = expf(x - lse[i]);
          float dpv = dp[i][j];
          if (p.dropping) {
            dpv *= drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
          }
          ds = pr * (dpv - delta[i]) * sm_scale;
        }
        Ss[(ty * 4 + i) * kPs + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    const int kn = min(kB, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float kv = d < D ? Ks[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += ds[i] * kv;
      }
    }
  }
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f32<T>(acc[i][j]);
    }
  }
}

// K3: grid (B*H, ceil(S / kB)); dk, dv (and dbias partials) over Q tiles.
// Here ty owns 4 keys and tx 4 queries of the transposed score tile.
template <typename T, int kJ>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  const int D = static_cast<int>(p.D), ld = D + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Ks = smem;
  float* Vs = Ks + kB * ld;
  float* Qs = Vs + kB * ld;
  float* Gs = Qs + kB * ld;
  float* Pt = Gs + kB * ld;           // dropped probs, [key][query]
  float* St = Pt + kB * kPs;          // scaled dS, [key][query]
  float* lse_s = St + kB * kPs;
  float* delta_s = lse_s + kB;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kB;     // causal: low keys see most rows
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  load_tile(Ks, static_cast<const T*>(p.k), p.k_sb, p.k_st, p.k_sh, b, h, k0,
            S, D, 1.0f);
  load_tile(Vs, static_cast<const T*>(p.v), p.v_sb, p.v_st, p.v_sh, b, h, k0,
            S, D, 1.0f);
  float dk[4][kJ], dv[4][kJ], dbias[4], kbias[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    dbias[i] = 0.0f;
    kbias[i] = (p.bias != nullptr && kpos < S) ? p.bias[b * S + kpos] : 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }
  // Q tiles strictly above the diagonal see nothing of this KV tile
  const int q_start = p.causal ? (k0 / kB) * kB : 0;
  for (int q0 = q_start; q0 < Tq; q0 += kB) {
    __syncthreads();
    load_tile(Qs, static_cast<const T*>(p.q), p.q_sb, p.q_st, p.q_sh, b, h,
              q0, Tq, D, 1.0f);
    load_tile(Gs, static_cast<const T*>(p.g), p.g_sb, p.g_st, p.g_sh, b, h,
              q0, Tq, D, 1.0f);
    for (int c = threadIdx.x; c < kB; c += kThreads) {
      const int t = q0 + c;
      const int64_t at = static_cast<int64_t>(bh) * Tq + t;
      lse_s[c] = t < Tq ? p.lse[at] : 0.0f;
      delta_s[c] = t < Tq ? p.delta[at] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kr[4], vr[4], qc[4], gc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kr[i] = Ks[(ty * 4 + i) * ld + d];
        vr[i] = Vs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[j] = Qs[(tx + 16 * j) * ld + d];
        gc[j] = Gs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += kr[i] * qc[j];
          dp[i][j] += vr[i] * gc[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        float pd = 0.0f, ds = 0.0f;
        if (qpos < Tq && kpos < S) {
          float x = s[i][j] * sm_scale;
          if (p.causal && kpos > qpos) x = kMaskValue;
          x += kbias[i];
          const float pr = expf(x - lse_s[c]);
          float mult = 1.0f;
          if (p.dropping) {
            mult = drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
          }
          pd = pr * mult;
          const float ds0 = pr * (dp[i][j] * mult - delta_s[c]);
          dbias[i] += ds0;
          ds = ds0 * sm_scale;
        }
        Pt[(ty * 4 + i) * kPs + c] = pd;
        St[(ty * 4 + i) * kPs + c] = ds;
      }
    }
    __syncthreads();
    const int qn = min(kB, Tq - q0);
    for (int c = 0; c < qn; ++c) {
      float pr[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Pt[(ty * 4 + i) * kPs + c];
        ds[i] = St[(ty * 4 + i) * kPs + c];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float gv = d < D ? Gs[c * ld + d] : 0.0f;
        const float qv = d < D ? Qs[c * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] += pr[i] * gv;
          dk[i][j] += ds[i] * qv;
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    float db = dbias[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      db += __shfl_xor_sync(0xffffffffu, db, off);
    }
    if (kpos >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + kpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkp[row + d] = from_f32<T>(dk[i][j]);
        dvp[row + d] = from_f32<T>(dv[i][j]);
      }
    }
    if (tx == 0 && p.dbias != nullptr) {
      p.dbias[static_cast<int64_t>(bh) * S + kpos] = db;
    }
  }
}

template <typename T, int kJ>
cudaError_t launch_typed(int which, const AttnParams& p, cudaStream_t st) {
  const int ld = static_cast<int>(p.D) + 1;
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  const unsigned nq = static_cast<unsigned>((p.T + kB - 1) / kB);
  const unsigned nk = static_cast<unsigned>((p.S + kB - 1) / kB);
  size_t bytes;
  cudaError_t err;
  switch (which) {
    case 0:
      bytes = (3 * kB * ld + kB * kPs) * sizeof(float);
      err = cudaFuncSetAttribute(fwd_kernel<T, kJ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      fwd_kernel<T, kJ><<<dim3(bh, nq), kThreads, bytes, st>>>(p);
      break;
    case 1:
      bytes = (4 * kB * ld + kB * kPs) * sizeof(float);
      err = cudaFuncSetAttribute(dq_kernel<T, kJ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      dq_kernel<T, kJ><<<dim3(bh, nq), kThreads, bytes, st>>>(p);
      break;
    case 2:
      bytes = (4 * kB * ld + 2 * kB * kPs + 2 * kB) * sizeof(float);
      err = cudaFuncSetAttribute(dkv_kernel<T, kJ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      dkv_kernel<T, kJ><<<dim3(bh, nk), kThreads, bytes, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int which, const AttnParams& p, cudaStream_t st) {
  if (p.D <= 64) return launch_typed<T, 4>(which, p, st);
  return launch_typed<T, 8>(which, p, st);
}

}  // namespace

extern "C" int flash_attention_launch(int which, const AttnParams* p,
                                      int dtype, void* stream) {
  if (p->B < 1 || p->H < 1 || p->T < 1 || p->S < 1 || p->D < 1 ||
      p->D > 128 || p->num_heads < p->H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32: err = launch_dim<float>(which, *p, st); break;
    case kBF16: err = launch_dim<__nv_bfloat16>(which, *p, st); break;
    case kF16: err = launch_dim<__half>(which, *p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

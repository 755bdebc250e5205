// Flash attention for training, for Hopper (sm_90a): forward, dQ and
// dK/dV, the FlashAttention-2 split.
//
// Replaces three Pallas kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py:
//   K1 `_pallas_fwd` (kernel :311, pallas_call :391)      -> fwd_wgmma_kernel,
//                                                           fwd_kernel
//   K2 `_pallas_bwd` dq_kernel (:489, pallas_call :545)   -> dq_wgmma_kernel,
//                                                           dq_kernel
//   K3 `_pallas_bwd` dkv_kernel (:556, pallas_call :655)  -> dkv_wgmma_kernel,
//                                                           dkv_kernel
// Same functions: causal or not, an optional additive f32 key bias
// [B, S], in-kernel attention-prob dropout from the counter hash
// (bit-identical to `dropout_multiplier`, :45) at the global head
// coordinate bh + (bh / H) * (Hg - H) + offset (:358), the forward's
// logsumexp, the fully-masked-row guard max(l, 1e-30) (:370), and with a
// bias the per-head dbias partials (column sums of the pre-scale dS).
//
// What bounds it on the card: operations. Per (b, h) the work is
// O(T * S * D) against O((T + S) * D) bytes, far above the H100's ridge
// point, so a kernel keeps the [T, S] tiles on chip, as the TPU kernel
// keeps them in VMEM, and never writes a score to device memory.
//
// Two routes, chosen by the caller for each call (`AttnParams.
// tensor_core`; the wrapper decides it from the inputs, as the reference
// dispatches on shape, :794) and never switched here:
// - Tensor cores, for bf16 inputs with D <= 128 that meet TMA's rule
//   (16-byte-aligned base addresses and strides): `fwd_wgmma_kernel` (K1),
//   `dq_wgmma_kernel` (K2), `dkv_wgmma_kernel` (K3). A producer warp
//   feeds a TMA ring of 128-byte swizzled tiles in shared memory through
//   mbarriers, and two consumer warpgroups run every product as bf16
//   `wgmma` with fp32 accumulation (helpers in hopper_common.cuh).
//   Q.K^T and dO.V^T of bf16 inputs are exact products summed in fp32,
//   as the reference's f32 dots. The products whose left operand is an
//   fp32 intermediate (P.V in K1; dS.K in K2; P^T.dO and dS^T.Q in K3)
//   take it as two bf16 register operands, hi = bf16(x) and lo = bf16(x
//   - hi), into one fp32 accumulator: x to 2^-17, which keeps the
//   reference's f32 precision (one bf16 rounding of P or dS, as
//   FlashAttention-2/3 make it, would be a precision change;
//   tests/test_torch_flash_attention_split.py pins why). A tensor-core
//   launch on inputs that break the rule is refused.
// - FMA, for f32 and fp16 inputs and for bf16 inputs off TMA's rule (a
//   head dim whose rows are not a multiple of 16 bytes, a view a few
//   elements into its storage): `fwd_kernel`, `dq_kernel`, `dkv_kernel`.
//   One CTA owns a 64-row Q tile (K1, K2) or a 64-key KV tile (K3),
//   stages the other side's 64-row tiles in shared memory as f32, and
//   each thread holds a 4 x 4 block of the score tile and a 4 x D/16
//   block of the accumulator in registers. Past D 128, K2 and K3 take
//   32-row tiles (2 x 2 a thread), since four 64-row f32 tiles no
//   longer fit in shared memory. TF32 for f32 inputs would be
//   a precision change; fp16 on the tensor cores needs its own range
//   argument for the lo term (fp16 subnormals).
//
// Any head dim on the FMA route (the tensor-core kernels hold up to 128).
// Past kColChunk (256) columns no f32 tile of >= 32 rows fits beside its
// partners, so a launch splits the output columns into chunks of 256, one
// CTA each along grid z (`n_col`, from ops/head_dim.py), and each CTA
// streams the score contraction over D in windows of 256 columns through
// the same tiles, accumulating in registers (K2 and K3
// take their own chunk's window last, whose tiles their accumulation then
// reads). Every chunk's CTA forms the same scores in the same order, so
// their row statistics agree bit for bit; chunk 0 alone writes lse (K1)
// and the dbias partials (K3). No atomics: each output has one writer.
//
// Causal tiles above the diagonal are skipped (K1/K2 stop at the
// diagonal tile; K3 starts there). Any T and S: rows and keys past the
// end are zero-filled on load (by the TMA box itself on the tensor-core
// route), excluded from the softmax and never written. q, k, v and dO are
// read in place as [B, T, H, D] through their strides; outputs are
// contiguous [B, T, H, D], lse / delta / dbias [B * H, T or S].
//
// Interface: a plain C function (ctypes) taking a struct of 8-byte
// fields, launched on the caller's stream; it returns the cudaError_t
// of the launch. `wgmma_tile_check` runs one 64 x N x K product through
// the same TMA loads and wgmma forms, for the card-side check.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

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
  int64_t tensor_core;    // the route: 1 tensor-core kernels, 0 FMA kernels
  int64_t n_col;          // FMA route: column chunks of kColChunk (grid z)
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  double sm_scale, inv_keep;
};

namespace {

// FMA kernels: a tile of kBr (64, or 32 for K2 / K3 past D 128) Q rows
// = KV keys; 16 x 16 threads, ty owns kBr / 16 rows and tx kBr / 16
// columns of the score tile
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t global_head(const AttnParams& p,
                                                int bh) {
  return global_head_of(bh, static_cast<int>(p.H),
                        static_cast<int>(p.num_heads),
                        static_cast<int>(p.head_offset));
}

// rows [r0, r0 + kRows) x columns [0, n) of a [B, L, H, D] tensor of
// (b, h) (`src` at the first column) into a padded f32 tile of row
// stride ld, times `scale`; rows past L are zero
template <int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t sb, int64_t sl, int64_t sh,
                                          int b, int h, int r0, int L,
                                          int n, float scale) {
  const T* base = src + b * sb + h * sh;
  for (int i = threadIdx.x; i < kRows * n; i += kThreads) {
    const int r = i / n;
    const int d = i - r * n;
    const int row = r0 + r;
    dst[r * ld + d] = row < L ? to_f32(base[row * sl + d]) * scale : 0.0f;
  }
}

// K1: grid (B*H, ceil(T / kBr), n_col); the heaviest causal tiles start
// first
template <typename T, int kJ, int kBr, bool kWide>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  constexpr int kI = kBr / 16, kPs = kBr + 1;
  const int D = static_cast<int>(p.D);
  // past kColChunk columns (the kWide instance): the CTA owns the output
  // columns [oc0, oc0 + on) and streams Q.K^T over D in windows of
  // kColChunk, V's chunk staged beside them
  static_assert(!kWide || kJ == 16, "a wide head takes 256-column rows");
  constexpr bool wide = kWide;
  const int oc0 = wide ? blockIdx.z * kColChunk : 0;
  const int on = wide ? min(kColChunk, D - oc0) : D;
  const int ld = (wide ? kColChunk : D) + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Qs = smem;
  float* Ks = Qs + kBr * ld;
  float* Vs = Ks + kBr * ld;
  float* Ps = Vs + kBr * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  // the TPU kernel scales q before its dot (:333)
  if (!wide) {
    load_tile<kBr>(Qs, ld, qg, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq, D,
                   sm_scale);
  }
  float m[kI], l[kI], acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  const int k_end = p.causal ? min(S, q0 + kBr) : S;
  const int n_win = wide ? static_cast<int>(gridDim.z) : 1;
  for (int k0 = 0; k0 < k_end; k0 += kBr) {
    __syncthreads();
    if (wide) {
      load_tile<kBr>(Vs, ld, vg + oc0, p.v_sb, p.v_st, p.v_sh, b, h, k0, S,
                     on, 1.0f);
    } else {
      load_tile<kBr>(Ks, ld, kg, p.k_sb, p.k_st, p.k_sh, b, h, k0, S, D,
                     1.0f);
      load_tile<kBr>(Vs, ld, vg, p.v_sb, p.v_st, p.v_sh, b, h, k0, S, D,
                     1.0f);
      __syncthreads();
    }
    float s[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = 0.0f;
    for (int wi = 0; wi < n_win; ++wi) {
      int wn = D;
      if (wide) {
        const int w0 = wi * kColChunk;
        wn = min(kColChunk, D - w0);
        if (wi > 0) __syncthreads();   // the last window is no longer read
        load_tile<kBr>(Qs, ld, qg + w0, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq,
                       wn, sm_scale);
        load_tile<kBr>(Ks, ld, kg + w0, p.k_sb, p.k_st, p.k_sh, b, h, k0, S,
                       wn, 1.0f);
        __syncthreads();
      }
      for (int d = 0; d < wn; ++d) {
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
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int qpos = q0 + ty * kI + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
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
      for (int j = 0; j < kI; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float pr = expf(s[i][j] - m_new);
        psum += pr;
        if (p.dropping) {
          pr *= drop_mult(seed, ghead, qpos, kpos, thr, inv_keep);
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
    const int kn = min(kBr, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pr[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) pr[i] = Ps[(ty * kI + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < on ? Vs[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kI; ++i) acc[i][j] += pr[i] * vv;
      }
    }
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty * kI + i;
    if (t >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D + oc0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < on) orow[d] = from_f32<T>(acc[i][j] / l_safe);
    }
    // every chunk's CTA has the same m and l; chunk 0 writes lse
    if (tx == 0 && (!wide || blockIdx.z == 0)) {
      p.lse_out[static_cast<int64_t>(bh) * Tq + t] = m[i] + logf(l_safe);
    }
  }
}

// K2: grid (B*H, ceil(T / kBr), n_col); dq accumulated over KV tiles
template <typename T, int kJ, int kBr, bool kWide>
__global__ void __launch_bounds__(kThreads) dq_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  constexpr int kI = kBr / 16, kPs = kBr + 1;
  const int D = static_cast<int>(p.D);
  // past kColChunk columns (the kWide instance): the CTA owns dq's
  // columns [oc0, oc0 + on) and streams S and dP over D in windows of
  // kColChunk, its own chunk last, so Ks then holds the K columns dq reads
  static_assert(!kWide || kJ == 16, "a wide head takes 256-column rows");
  constexpr bool wide = kWide;
  const int oc0 = wide ? blockIdx.z * kColChunk : 0;
  const int on = wide ? min(kColChunk, D - oc0) : D;
  const int ld = (wide ? kColChunk : D) + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Qs = smem;
  float* Gs = Qs + kBr * ld;
  float* Ks = Gs + kBr * ld;
  float* Vs = Ks + kBr * ld;
  float* Ss = Vs + kBr * ld;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  const T* qg = static_cast<const T*>(p.q);
  const T* gg_ = static_cast<const T*>(p.g);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  if (!wide) {
    load_tile<kBr>(Qs, ld, qg, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq, D,
                   1.0f);
    load_tile<kBr>(Gs, ld, gg_, p.g_sb, p.g_st, p.g_sh, b, h, q0, Tq, D,
                   1.0f);
  }
  float lse[kI], delta[kI], acc[kI][kJ];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty * kI + i;
    const int64_t at = static_cast<int64_t>(bh) * Tq + t;
    lse[i] = t < Tq ? p.lse[at] : 0.0f;
    delta[i] = t < Tq ? p.delta[at] : 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
  }
  const int k_end = p.causal ? min(S, q0 + kBr) : S;
  const int n_win = wide ? static_cast<int>(gridDim.z) : 1;
  for (int k0 = 0; k0 < k_end; k0 += kBr) {
    __syncthreads();
    if (!wide) {
      load_tile<kBr>(Ks, ld, kg, p.k_sb, p.k_st, p.k_sh, b, h, k0, S, D,
                     1.0f);
      load_tile<kBr>(Vs, ld, vg, p.v_sb, p.v_st, p.v_sh, b, h, k0, S, D,
                     1.0f);
      __syncthreads();
    }
    float s[kI][kI], dp[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int wi = 0; wi < n_win; ++wi) {
      int wn = D;
      if (wide) {
        const int w0 = (blockIdx.z + 1 + wi) % n_win * kColChunk;
        wn = min(kColChunk, D - w0);
        if (wi > 0) __syncthreads();   // the last window is no longer read
        load_tile<kBr>(Qs, ld, qg + w0, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq,
                       wn, 1.0f);
        load_tile<kBr>(Gs, ld, gg_ + w0, p.g_sb, p.g_st, p.g_sh, b, h, q0,
                       Tq, wn, 1.0f);
        load_tile<kBr>(Ks, ld, kg + w0, p.k_sb, p.k_st, p.k_sh, b, h, k0, S,
                       wn, 1.0f);
        load_tile<kBr>(Vs, ld, vg + w0, p.v_sb, p.v_st, p.v_sh, b, h, k0, S,
                       wn, 1.0f);
        __syncthreads();
      }
      for (int d = 0; d < wn; ++d) {
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
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int qpos = q0 + ty * kI + i;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
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
        Ss[(ty * kI + i) * kPs + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    const int kn = min(kBr, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float ds[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) ds[i] = Ss[(ty * kI + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float kv = d < on ? Ks[kk * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kI; ++i) acc[i][j] += ds[i] * kv;
      }
    }
  }
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty * kI + i;
    if (t >= Tq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D + oc0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < on) row[d] = from_f32<T>(acc[i][j]);
    }
  }
}

// K3: grid (B*H, ceil(S / kBr), n_col); dk, dv (and dbias partials) over
// Q tiles. Here ty owns kI keys and tx kI queries of the transposed score
// tile.
template <typename T, int kJ, int kBr, bool kWide>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const AttnParams p) {
  extern __shared__ float smem[];
  constexpr int kI = kBr / 16, kPs = kBr + 1;
  const int D = static_cast<int>(p.D);
  // past kColChunk columns (the kWide instance): the CTA owns dk's and
  // dv's columns [oc0, oc0 + on) and streams S^T and dP^T over D in
  // windows of kColChunk, its own chunk last, so Qs and Gs then hold the
  // columns dk and dv read; chunk 0 writes the dbias partials
  static_assert(!kWide || kJ == 16, "a wide head takes 256-column rows");
  constexpr bool wide = kWide;
  const int oc0 = wide ? blockIdx.z * kColChunk : 0;
  const int on = wide ? min(kColChunk, D - oc0) : D;
  const int ld = (wide ? kColChunk : D) + 1;
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const int H = static_cast<int>(p.H);
  float* Ks = smem;
  float* Vs = Ks + kBr * ld;
  float* Qs = Vs + kBr * ld;
  float* Gs = Qs + kBr * ld;
  float* Pt = Gs + kBr * ld;           // dropped probs, [key][query]
  float* St = Pt + kBr * kPs;          // scaled dS, [key][query]
  float* lse_s = St + kBr * kPs;
  float* delta_s = lse_s + kBr;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kBr;     // causal: low keys see most rows
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);

  const T* qg = static_cast<const T*>(p.q);
  const T* gg_ = static_cast<const T*>(p.g);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  if (!wide) {
    load_tile<kBr>(Ks, ld, kg, p.k_sb, p.k_st, p.k_sh, b, h, k0, S, D,
                   1.0f);
    load_tile<kBr>(Vs, ld, vg, p.v_sb, p.v_st, p.v_sh, b, h, k0, S, D,
                   1.0f);
  }
  float dk[kI][kJ], dv[kI][kJ], dbias[kI], kbias[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int kpos = k0 + ty * kI + i;
    dbias[i] = 0.0f;
    kbias[i] = (p.bias != nullptr && kpos < S) ? p.bias[b * S + kpos] : 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }
  // Q tiles strictly above the diagonal see nothing of this KV tile
  const int q_start = p.causal ? (k0 / kBr) * kBr : 0;
  const int n_win = wide ? static_cast<int>(gridDim.z) : 1;
  for (int q0 = q_start; q0 < Tq; q0 += kBr) {
    __syncthreads();
    if (!wide) {
      load_tile<kBr>(Qs, ld, qg, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq, D,
                     1.0f);
      load_tile<kBr>(Gs, ld, gg_, p.g_sb, p.g_st, p.g_sh, b, h, q0, Tq, D,
                     1.0f);
    }
    for (int c = threadIdx.x; c < kBr; c += kThreads) {
      const int t = q0 + c;
      const int64_t at = static_cast<int64_t>(bh) * Tq + t;
      lse_s[c] = t < Tq ? p.lse[at] : 0.0f;
      delta_s[c] = t < Tq ? p.delta[at] : 0.0f;
    }
    __syncthreads();
    float s[kI][kI], dp[kI][kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kI; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int wi = 0; wi < n_win; ++wi) {
      int wn = D;
      if (wide) {
        const int w0 = (blockIdx.z + 1 + wi) % n_win * kColChunk;
        wn = min(kColChunk, D - w0);
        if (wi > 0) __syncthreads();   // the last window is no longer read
        load_tile<kBr>(Ks, ld, kg + w0, p.k_sb, p.k_st, p.k_sh, b, h, k0, S,
                       wn, 1.0f);
        load_tile<kBr>(Vs, ld, vg + w0, p.v_sb, p.v_st, p.v_sh, b, h, k0, S,
                       wn, 1.0f);
        load_tile<kBr>(Qs, ld, qg + w0, p.q_sb, p.q_st, p.q_sh, b, h, q0, Tq,
                       wn, 1.0f);
        load_tile<kBr>(Gs, ld, gg_ + w0, p.g_sb, p.g_st, p.g_sh, b, h, q0,
                       Tq, wn, 1.0f);
        __syncthreads();
      }
      for (int d = 0; d < wn; ++d) {
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
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int kpos = k0 + ty * kI + i;
#pragma unroll
      for (int j = 0; j < kI; ++j) {
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
        Pt[(ty * kI + i) * kPs + c] = pd;
        St[(ty * kI + i) * kPs + c] = ds;
      }
    }
    __syncthreads();
    const int qn = min(kBr, Tq - q0);
    for (int c = 0; c < qn; ++c) {
      float pr[kI], ds[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        pr[i] = Pt[(ty * kI + i) * kPs + c];
        ds[i] = St[(ty * kI + i) * kPs + c];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int d = tx + 16 * j;
        const float gv = d < on ? Gs[c * ld + d] : 0.0f;
        const float qv = d < on ? Qs[c * ld + d] : 0.0f;
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
    float db = dbias[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      db += __shfl_xor_sync(0xffffffffu, db, off);
    }
    if (kpos >= S) continue;
    const int64_t row = ((static_cast<int64_t>(b) * S + kpos) * H + h) * D +
                        oc0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 16 * j;
      if (d < on) {
        dkp[row + d] = from_f32<T>(dk[i][j]);
        dvp[row + d] = from_f32<T>(dv[i][j]);
      }
    }
    if (tx == 0 && p.dbias != nullptr && (!wide || blockIdx.z == 0)) {
      p.dbias[static_cast<int64_t>(bh) * S + kpos] = db;
    }
  }
}

// fp32 bytes of each FMA kernel's shared memory at row tile kBr (tile
// rows of at most kColChunk columns)
size_t fma_smem_bytes(int which, int kBr, int64_t D) {
  const size_t ld = static_cast<size_t>(D < kColChunk ? D : kColChunk) + 1;
  const size_t ps = kBr + 1;
  switch (which) {
    case 0: return (3 * kBr * ld + kBr * ps) * sizeof(float);
    case 1: return (4 * kBr * ld + kBr * ps) * sizeof(float);
    default: return (4 * kBr * ld + 2 * kBr * ps + 2 * kBr) * sizeof(float);
  }
}

template <typename F>
cudaError_t launch_fma(F kernel, int which, int kBr, unsigned rows,
                       const AttnParams& p, cudaStream_t st) {
  const size_t bytes = fma_smem_bytes(which, kBr, p.D);
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (rows + kBr - 1) / kBr, static_cast<unsigned>(p.n_col)),
           kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

// kBf rows a tile for K1, kBb for K2 / K3
template <typename T, int kJ, int kBf, int kBb, bool kWide = false>
cudaError_t launch_typed(int which, const AttnParams& p, cudaStream_t st) {
  const unsigned T_ = static_cast<unsigned>(p.T);
  const unsigned S_ = static_cast<unsigned>(p.S);
  switch (which) {
    case 0:
      return launch_fma(fwd_kernel<T, kJ, kBf, kWide>, 0, kBf, T_, p, st);
    case 1:
      return launch_fma(dq_kernel<T, kJ, kBb, kWide>, 1, kBb, T_, p, st);
    case 2:
      return launch_fma(dkv_kernel<T, kJ, kBb, kWide>, 2, kBb, S_, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// Past D 128 the K2 / K3 tiles of 64 rows (263 KB and more at D 256) do
// not fit in shared memory: they take 32 rows; K1 keeps 64 (214 KB). Past
// D 256 an instance of its own (kWide, chosen here when n_col > 1) streams
// windows of kColChunk columns; up to 256 the kernels hold no column
// arithmetic.
template <typename T>
cudaError_t launch_dim(int which, const AttnParams& p, cudaStream_t st) {
  if (p.D <= 64) return launch_typed<T, 4, 64, 64>(which, p, st);
  if (p.D <= 128) return launch_typed<T, 8, 64, 64>(which, p, st);
  if (p.n_col > 1) return launch_typed<T, 16, 64, 32, true>(which, p, st);
  return launch_typed<T, 16, 64, 32>(which, p, st);
}

// ---------------------------------------------------------------------------
// bf16 K1, K2 and K3 on the tensor cores
// ---------------------------------------------------------------------------
//
// A CTA is three warpgroups: warpgroup 0 the producer (one thread issues
// every TMA load; the warpgroup hands its registers to the others), 1
// and 2 the consumers, each owning 64 rows of the CTA's 128 (K1, K2:
// query rows; K3: keys). Tiles are 128-byte-swizzled boxes of [rows x 64 bf16]
// (hopper_common.cuh); a head dim past 64 takes two boxes side by side,
// and columns past D are zero-filled by the box. Each mbarrier's n-th
// completion has parity n & 1.

constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kConsumers = 2;            // consumer warpgroups of a CTA
constexpr int kWgmmaThreads = (kConsumers + 1) * kWg;
constexpr int kBox128 = 128 * 128;       // bytes of a [128 x 64] bf16 box
constexpr int kBox64 = 64 * 128;         // bytes of a [64 x 64] bf16 box
// one CTA an SM: 128 x 24 + 2 x 128 x 240 registers <= 65536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// the launch's tensor maps, in kernel parameter space
struct TmaMaps {
  CUtensorMap q, k, v, g, lse, delta;
};

// a thread's 2-row accumulator slice (rows pos0 and pos0 + 8): write it,
// row r scaled by inv[r], as bf16 into a contiguous [B, L, H, D] tensor
template <int kN>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[kN / 2],
                                           int pos0, const float (&inv)[2],
                                           int L, int b, int h,
                                           const AttnParams& p, int cq) {
  const int H = static_cast<int>(p.H), D = static_cast<int>(p.D);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = pos0 + 8 * r;
    if (pos >= L) continue;
    __nv_bfloat16* row =
        dst + ((static_cast<int64_t>(b) * L + pos) * H + h) * D;
#pragma unroll
    for (int c8 = 0; c8 < kN / 8; ++c8) {
      const int d = 8 * c8 + cq;
      const float x0 = acc[4 * c8 + 2 * r] * inv[r];
      const float x1 = acc[4 * c8 + 2 * r + 1] * inv[r];
      if ((D & 1) == 0 && d + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) row[d] = __float2bfloat16_rn(x0);
        if (d + 1 < D) row[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- K1 ----------------------------------------------------------------
// grid (B*H, ceil(T / 128)), the heaviest causal tiles first. The
// producer loads the CTA's [128 x D] Q tile once, then K and V tiles of
// 128 keys into a 2-stage ring; one producer thread walks the K tiles and
// another the V tiles, each stage with its own full and empty barriers,
// so a K tile is refilled as soon as its product is done. A consumer
// (64 rows), per K/V tile: S = Q.K^T (wgmma m64n128, A and B from shared
// memory, K-major); sm_scale, masks, bias and the online softmax in fp32
// registers; O += P_hi.V + P_lo.V (A = P from registers, B = V MN-major).
// The two consumers drift apart by a product's length, so one's softmax
// runs while the other's products do. Every loop over a thread's
// registers is unrolled, so each variant of the loop body is code: the
// tile walk is not unrolled further, and dropout is a pass of its own,
// which keeps the hot loop inside the instruction cache (unrolling two
// tiles, to overlap S_{j+1} with the softmax of S_j, was slower).

constexpr int kFwdKeys = 128;   // keys of a K / V tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int kD>
struct FwdLayout {
  static constexpr int kRows = 64 * kConsumers;       // query rows of a CTA
  static constexpr int kTile = (kD / 64) * kBox128;   // Q, or a K/V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                    // 2 stages
  static constexpr int kV = 3 * kTile;                // 2 stages
  static constexpr int kBar = 5 * kTile;
  // barrier slots (8 bytes each) after kBar; 1024 bytes of alignment slack
  static constexpr int kQFull = 0, kKFull = 1, kVFull = 3, kKEmpty = 5,
                       kVEmpty = 7;
  static constexpr int kBytes = kBar + 9 * 8 + 1024;
};

// what a K1 consumer thread knows about its rows
struct FwdRows {
  const AttnParams* p;
  uint32_t base, bars, q_tile, ghead, seed, thr;
  int qpos[2], q_lo, cq, S;
  float sm_scale, inv_keep;
  const float* bias;          // the batch row's [S] key bias, or null

  __device__ __forceinline__ uint32_t bar(int slot, int s) const {
    return bars + 8 * (slot + s);
  }
  __device__ __forceinline__ void wait_bar(int slot, int s,
                                           uint32_t par) const {
    hopper::mbar_wait(bar(slot, s), par);
  }
};

// S = Q.K_j^T into sc, asynchronously (the caller commits and waits)
template <int kD>
__device__ __forceinline__ void fwd_issue_qk(const FwdRows& c, int j,
                                             float (&sc)[kFwdKeys / 2]) {
  using L = FwdLayout<kD>;
  const int s = j & 1;
  const uint32_t k_tile = c.base + L::kK + s * L::kTile;
  c.wait_bar(L::kKFull, s, (j >> 1) & 1);
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox128 + (kk % 4) * 32;
    hopper::wgmma_ss<kFwdKeys>(sc, hopper::smem_desc(c.q_tile + off, 16, 1024),
                               hopper::smem_desc(k_tile + off, 16, 1024),
                               kk > 0);
  }
  hopper::wgmma_commit();
}

// S_j (in sc) -> P_j in fp32, in place: scores as the reference forms
// them (scale, causal mask, then the key bias; keys past S excluded),
// then the online softmax. Updates the running max m and the per-thread
// partial sums l; returns in corr the factor O must be rescaled by.
template <int kD>
__device__ __forceinline__ void fwd_softmax(const FwdRows& c, int j,
                                            float (&sc)[kFwdKeys / 2],
                                            float (&m)[2], float (&l)[2],
                                            float (&corr)[2]) {
  constexpr int kS = kFwdKeys / 2;
  const AttnParams& p = *c.p;
  const int k0 = j * kFwdKeys;
  // tiles that need no mask take the short path
  const bool edge =
      (p.causal && k0 + kFwdKeys - 1 > c.q_lo) || k0 + kFwdKeys > c.S;
  float mx[2] = {m[0], m[1]};
  if (edge || c.bias != nullptr) {
#pragma unroll
    for (int c8 = 0; c8 < kS / 4; ++c8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * c8 + c.cq + e;
        const float kb =
            (c.bias != nullptr && kpos < c.S) ? __ldg(c.bias + kpos) : 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = sc[4 * c8 + 2 * r + e] * c.sm_scale;
          if (edge) {
            if (p.causal && kpos > c.qpos[r]) x = kMaskValue;
            x = kpos < c.S ? x + kb : -INFINITY;
          } else {
            x += kb;
          }
          sc[4 * c8 + 2 * r + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      sc[i] *= c.sm_scale;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
  }
  // tile 0 holds key 0 < S, so every row's running max is finite
  float mlog[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = ex2((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
    mlog[r] = mx[r] * kLog2e;
  }
  if (edge) {
    // a masked score overflows to -inf here: its prob is 0
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      sc[i] = ex2((sc[i] - m[(i >> 1) & 1]) * kLog2e);
      ls[(i >> 1) & 1] += sc[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      sc[i] = ex2(fmaf(sc[i], kLog2e, -mlog[(i >> 1) & 1]));
      ls[(i >> 1) & 1] += sc[i];
    }
  }
  // l sums the undropped probs; P.V takes the dropped ones
  if (p.dropping) {
#pragma unroll
    for (int c8 = 0; c8 < kS / 4; ++c8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sc[4 * c8 + 2 * r + e] *=
              drop_mult(c.seed, c.ghead, c.qpos[r], k0 + 8 * c8 + c.cq + e,
                        c.thr, c.inv_keep);
        }
      }
    }
  }
  // l stays a per-thread partial (corr is the row's, so the quad's
  // partials add up at the end)
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
}

// O += P_hi.V_j + P_lo.V_j, asynchronously (the caller commits and
// waits; the fragments stay live until then)
template <int kD>
__device__ __forceinline__ void fwd_issue_pv(
    const FwdRows& c, int j, const uint32_t (&p_hi)[kFwdKeys / 4],
    const uint32_t (&p_lo)[kFwdKeys / 4], float (&o)[kD / 2]) {
  using L = FwdLayout<kD>;
  const int s = j & 1;
  const uint32_t v_tile = c.base + L::kV + s * L::kTile;
  c.wait_bar(L::kVFull, s, (j >> 1) & 1);
  hopper::fence_regs(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    const uint64_t vd = hopper::smem_desc(v_tile + kk * 2048, kBox128, 1024);
    hopper::wgmma_rs<kD>(o, p_hi + 4 * kk, vd, 1);
    hopper::wgmma_rs<kD>(o, p_lo + 4 * kk, vd, 1);
  }
  hopper::wgmma_commit();
}

template <int kD>
__device__ __forceinline__ void rescale(float (&o)[kD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// one K/V tile: S_j = Q.K_j^T, the softmax into P_j, O += P_j.V_j
template <int kD>
__device__ __forceinline__ void fwd_step(const FwdRows& c, int j,
                                         float (&sc)[kFwdKeys / 2],
                                         float (&o)[kD / 2], float (&m)[2],
                                         float (&l)[2]) {
  using L = FwdLayout<kD>;
  fwd_issue_qk<kD>(c, j, sc);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  hopper::mbar_arrive(c.bar(L::kKEmpty, j & 1));
  float corr[2];
  fwd_softmax<kD>(c, j, sc, m, l, corr);
  rescale<kD>(o, corr);
  uint32_t p_hi[kFwdKeys / 4], p_lo[kFwdKeys / 4];
  hopper::split_bf16(sc, p_hi, p_lo);
  hopper::fence_regs(p_hi);
  hopper::fence_regs(p_lo);
  fwd_issue_pv<kD>(c, j, p_hi, p_lo, o);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  hopper::mbar_arrive(c.bar(L::kVEmpty, j & 1));
}

template <int kD>
__device__ __forceinline__ void fwd_consumer(const AttnParams& p,
                                             uint32_t base, uint32_t bars,
                                             int cw, int b, int bh, int q0,
                                             int n_tiles) {
  using L = FwdLayout<kD>;
  constexpr int kS = kFwdKeys / 2;      // score floats a thread
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int row = cw * 64 + warp * 16 + lane / 4;
  FwdRows c;
  c.p = &p;
  c.base = base;
  c.bars = bars;
  c.q_tile = base + L::kQ + cw * 64 * 128;
  c.ghead = global_head(p, bh);
  c.seed = static_cast<uint32_t>(p.seed);
  c.thr = static_cast<uint32_t>(p.keep_threshold);
  c.qpos[0] = q0 + row;
  c.qpos[1] = q0 + row + 8;
  c.q_lo = q0 + cw * 64;                // the warpgroup's first row
  c.cq = 2 * (lane % 4);
  c.S = static_cast<int>(p.S);
  c.sm_scale = static_cast<float>(p.sm_scale);
  c.inv_keep = static_cast<float>(p.inv_keep);
  c.bias = p.bias == nullptr ? nullptr
                           : p.bias + static_cast<int64_t>(b) * c.S;
  float o[kD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;

  c.wait_bar(L::kQFull, 0, 0);
  float sc[kS];
  for (int j = 0; j < n_tiles; ++j) fwd_step<kD>(c, j, sc, o, m, l);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.0f / l_safe;
    if (lane % 4 == 0 && c.qpos[r] < p.T) {
      p.lse_out[static_cast<int64_t>(bh) * p.T + c.qpos[r]] =
          m[r] + logf(l_safe);
    }
  }
  store_rows<kD>(static_cast<__nv_bfloat16*>(p.out), o, c.qpos[0], inv,
                 static_cast<int>(p.T), b, bh % static_cast<int>(p.H), p,
                 c.cq);
}

template <int kD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ AttnParams p,
                     const __grid_constant__ TmaMaps maps) {
  using L = FwdLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_u32(hopper::align_1024(smem_raw));
  const uint32_t bars = base + L::kBar;
  const int H = static_cast<int>(p.H), S = static_cast<int>(p.S);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;
  const int k_end = p.causal ? min(S, q0 + L::kRows) : S;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars + 8 * L::kQFull, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8 * (L::kKFull + s), 1);
      hopper::mbar_init(bars + 8 * (L::kVFull + s), 1);
      hopper::mbar_init(bars + 8 * (L::kKEmpty + s), kConsumers * kWg);
      hopper::mbar_init(bars + 8 * (L::kVEmpty + s), kConsumers * kWg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < kWg) {
    hopper::regs_dealloc<kProducerRegs>();
    // thread 0: Q, then the K tiles; thread 32: the V tiles
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool is_k = threadIdx.x == 0;
      const CUtensorMap* map = is_k ? &maps.k : &maps.v;
      const int full = is_k ? L::kKFull : L::kVFull;
      const int empty = is_k ? L::kKEmpty : L::kVEmpty;
      const int dst = is_k ? L::kK : L::kV;
      if (is_k) {
        const uint32_t qf = bars + 8 * L::kQFull;
        hopper::mbar_expect_tx(qf, L::kTile);
        for (int i = 0; i < kD / 64; ++i) {
          hopper::tma_load_4d(base + L::kQ + i * kBox128, &maps.q, qf,
                              64 * i, h, q0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) {
          hopper::mbar_wait(bars + 8 * (empty + s), ((j >> 1) - 1) & 1);
        }
        const uint32_t f = bars + 8 * (full + s);
        hopper::mbar_expect_tx(f, L::kTile);
        for (int i = 0; i < kD / 64; ++i) {
          hopper::tma_load_4d(base + dst + s * L::kTile + i * kBox128, map, f,
                              64 * i, h, j * kFwdKeys, b);
        }
      }
    }
  } else {
    hopper::regs_alloc<kConsumerRegs>();
    fwd_consumer<kD>(p, base, bars, threadIdx.x / kWg - 1, b, bh, q0,
                     n_tiles);
  }
}

// ---- K3 ----------------------------------------------------------------
// grid (B*H, ceil(S / 128)); causal: low keys see most rows, so they
// start first. The producer loads the CTA's K and V tiles (128 keys)
// once, then Q and dO tiles of 64 rows with their lse and delta into a
// 2-stage ring. A consumer (64 keys), per Q tile: S^T = K.Q^T and
// dP^T = V.dO^T (wgmma m64n64, A and B from shared memory, K-major);
// P, dS0 and the dbias partial in fp32 registers (dbias before any
// rounding); dV += (P mult)^T.dO and dK += (dS0 sm_scale)^T.Q as hi/lo
// pairs (A from registers, B = dO or Q MN-major).

constexpr int kDkvRows = 64;    // query rows of a Q / dO tile

template <int kD>
struct DkvLayout {
  static constexpr int kKeys = 64 * kConsumers;    // keys of a CTA
  static constexpr int kKV = (kD / 64) * kBox128;   // K or V
  static constexpr int kQT = (kD / 64) * kBox64;    // a Q or dO stage
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;                // 2 stages
  static constexpr int kG = kQ + 2 * kQT;           // 2 stages
  static constexpr int kLse = kG + 2 * kQT;         // 2 stages of 64 f32
  static constexpr int kDelta = kLse + 2 * 256;
  static constexpr int kBar = kDelta + 2 * 256;
  // kv_full, full[2], empty[2]; 1024 bytes of alignment slack
  static constexpr int kBytes = kBar + 5 * 8 + 1024;
};

template <int kD>
__device__ __forceinline__ void dkv_consumer(const AttnParams& p,
                                             const uint8_t* smem,
                                             uint32_t base, uint32_t bars,
                                             int cw, int b, int h, int bh,
                                             int k0, int q_start) {
  using L = DkvLayout<kD>;
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int k_lo = k0 + cw * 64;        // the warpgroup's first key
  const int krow = k_lo + warp * 16 + lane / 4;
  const int kpos[2] = {krow, krow + 8};
  const int cq = 2 * (lane % 4);
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  float kbias[2], dbias[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kbias[r] = (p.bias != nullptr && kpos[r] < S)
                   ? p.bias[static_cast<int64_t>(b) * S + kpos[r]]
                   : 0.0f;
  }
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.0f;
  const uint32_t k_tile = base + L::kK + cw * 64 * 128;
  const uint32_t v_tile = base + L::kV + cw * 64 * 128;
  hopper::mbar_wait(bars, 0);
  int it = 0;
  for (int q0 = q_start; q0 < Tq; q0 += kDkvRows, ++it) {
    const int s = it & 1;
    const uint32_t par = (it >> 1) & 1;
    const uint32_t q_tile = base + L::kQ + s * L::kQT;
    const uint32_t g_tile = base + L::kG + s * L::kQT;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::kLse + s * 256);
    const float* delta_s =
        reinterpret_cast<const float*>(smem + L::kDelta + s * 256);
    float st[kDkvRows / 2], dpt[kDkvRows / 2];
    hopper::mbar_wait(bars + 8 * (1 + s), par);
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t oa = (kk / 4) * kBox128 + (kk % 4) * 32;
      const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
      hopper::wgmma_ss<kDkvRows>(st, hopper::smem_desc(k_tile + oa, 16, 1024),
                                 hopper::smem_desc(q_tile + ob, 16, 1024),
                                 kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t oa = (kk / 4) * kBox128 + (kk % 4) * 32;
      const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
      hopper::wgmma_ss<kDkvRows>(dpt,
                                 hopper::smem_desc(v_tile + oa, 16, 1024),
                                 hopper::smem_desc(g_tile + ob, 16, 1024),
                                 kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // rows are keys, columns queries: st becomes P mult, dpt dS0 sm_scale.
    // A tile with no causal mask, no row or key past the end and no
    // dropout takes the short path.
    const bool edge = (p.causal && k_lo + 63 > q0) ||
                      q0 + kDkvRows > Tq || k_lo + 64 > S;
    if (!edge && !p.dropping) {
#pragma unroll
      for (int c8 = 0; c8 < kDkvRows / 8; ++c8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * c8 + cq + e;
          const float lse_log = lse_s[c] * kLog2e, delta = delta_s[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c8 + 2 * r + e;
            const float x = st[i] * sm_scale + kbias[r];
            const float pr = ex2(fmaf(x, kLog2e, -lse_log));
            const float ds0 = pr * (dpt[i] - delta);
            dbias[r] += ds0;
            st[i] = pr;
            dpt[i] = ds0 * sm_scale;
          }
        }
      }
    } else {
#pragma unroll
      for (int c8 = 0; c8 < kDkvRows / 8; ++c8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * c8 + cq + e;
          const int qpos = q0 + c;
          const float lse = lse_s[c], delta = delta_s[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c8 + 2 * r + e;
            float pd = 0.0f, ds = 0.0f;
            if (qpos < Tq && kpos[r] < S) {
              float x = st[i] * sm_scale;
              if (p.causal && kpos[r] > qpos) x = kMaskValue;
              x += kbias[r];
              // a masked score overflows to -inf here: its prob is 0
              const float pr = ex2((x - lse) * kLog2e);
              float mult = 1.0f;
              if (p.dropping) {
                mult = drop_mult(seed, ghead, qpos, kpos[r], thr, inv_keep);
              }
              pd = pr * mult;
              const float ds0 = pr * (dpt[i] * mult - delta);
              dbias[r] += ds0;
              ds = ds0 * sm_scale;
            }
            st[i] = pd;
            dpt[i] = ds;
          }
        }
      }
    }
    uint32_t p_hi[kDkvRows / 4], p_lo[kDkvRows / 4];
    uint32_t s_hi[kDkvRows / 4], s_lo[kDkvRows / 4];
    hopper::split_bf16(st, p_hi, p_lo);
    hopper::split_bf16(dpt, s_hi, s_lo);
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::fence_regs(p_hi);
    hopper::fence_regs(p_lo);
    hopper::fence_regs(s_hi);
    hopper::fence_regs(s_lo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      const uint64_t gd = hopper::smem_desc(g_tile + kk * 2048, kBox64, 1024);
      hopper::wgmma_rs<kD>(dv, p_hi + 4 * kk, gd, 1);
      hopper::wgmma_rs<kD>(dv, p_lo + 4 * kk, gd, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      const uint64_t qd = hopper::smem_desc(q_tile + kk * 2048, kBox64, 1024);
      hopper::wgmma_rs<kD>(dk, s_hi + 4 * kk, qd, 1);
      hopper::wgmma_rs<kD>(dk, s_lo + 4 * kk, qd, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    hopper::mbar_arrive(bars + 8 * (3 + s));
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<kD>(static_cast<__nv_bfloat16*>(p.dk), dk, kpos[0], one, S, b,
                 h, p, cq);
  store_rows<kD>(static_cast<__nv_bfloat16*>(p.dv), dv, kpos[0], one, S, b,
                 h, p, cq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float db = quad_sum(dbias[r]);
    if (p.dbias != nullptr && lane % 4 == 0 && kpos[r] < S) {
      p.dbias[static_cast<int64_t>(bh) * S + kpos[r]] = db;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ AttnParams p,
                     const __grid_constant__ TmaMaps maps) {
  using L = DkvLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t bars = base + L::kBar;
  const int H = static_cast<int>(p.H), Tq = static_cast<int>(p.T);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * L::kKeys;
  // Q tiles strictly above the diagonal see nothing of these keys
  const int q_start = p.causal ? k0 : 0;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8 * (1 + s), 1);
      hopper::mbar_init(bars + 8 * (3 + s), kConsumers * kWg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < kWg) {
    hopper::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bars, 2 * L::kKV);
      for (int i = 0; i < kD / 64; ++i) {
        hopper::tma_load_4d(base + L::kK + i * kBox128, &maps.k, bars,
                            64 * i, h, k0, b);
        hopper::tma_load_4d(base + L::kV + i * kBox128, &maps.v, bars,
                            64 * i, h, k0, b);
      }
      int it = 0;
      for (int q0 = q_start; q0 < Tq; q0 += kDkvRows, ++it) {
        const int s = it & 1;
        if (it >= 2) {
          hopper::mbar_wait(bars + 8 * (3 + s), ((it >> 1) - 1) & 1);
        }
        const uint32_t full = bars + 8 * (1 + s);
        hopper::mbar_expect_tx(full, 2 * L::kQT + 2 * 256);
        for (int i = 0; i < kD / 64; ++i) {
          hopper::tma_load_4d(base + L::kQ + s * L::kQT + i * kBox64, &maps.q,
                              full, 64 * i, h, q0, b);
          hopper::tma_load_4d(base + L::kG + s * L::kQT + i * kBox64, &maps.g,
                              full, 64 * i, h, q0, b);
        }
        hopper::tma_load_1d(base + L::kLse + s * 256, &maps.lse, full,
                            bh * Tq + q0);
        hopper::tma_load_1d(base + L::kDelta + s * 256, &maps.delta, full,
                            bh * Tq + q0);
      }
    }
  } else {
    hopper::regs_alloc<kConsumerRegs>();
    dkv_consumer<kD>(p, smem, base, bars, threadIdx.x / kWg - 1, b, h, bh,
                     k0, q_start);
  }
}

// ---- K2 ----------------------------------------------------------------
// grid (B*H, ceil(T / 128)), the heaviest causal tiles first (K1's CTA
// shape). The producer loads the CTA's [128 x D] Q and dO tiles and
// their 128 lse and delta values once, then K and V tiles of 64 keys
// into a 2-stage ring: one producer thread walks the K tiles and another
// the V tiles, each stage with its own full and empty barriers. A
// consumer (64 query rows), per K/V tile: S = Q.K_j^T and dP = dO.V_j^T
// (wgmma m64n64, A and B from shared memory, K-major), which frees the V
// stage; in fp32 registers dP mult (dropout, a pass of its own), then
// P = exp(S sm_scale [mask] + bias - lse) and dS = P (dP mult - delta)
// sm_scale (K3's arithmetic); dQ += dS_hi.K_j + dS_lo.K_j (A from
// registers, B = the same K tile read MN-major, so K is loaded once for
// both of its products), which frees the K stage. 64-key tiles keep S,
// dP, the hi/lo pair and dQ (32 + 32 + 32 + kD/2 floats a thread) inside
// the consumer's 240 registers. Causal: a consumer stops at its own
// diagonal tile, so the first consumer may skip the CTA's last tile; no
// refill ever waits for that tile's release.

constexpr int kDqKeys = 64;     // keys of a K / V tile

template <int kD>
struct DqLayout {
  static constexpr int kRows = 64 * kConsumers;     // query rows of a CTA
  static constexpr int kQT = (kD / 64) * kBox128;   // Q or dO
  static constexpr int kKT = (kD / 64) * kBox64;    // a K or V stage
  static constexpr int kQ = 0;
  static constexpr int kG = kQT;
  static constexpr int kK = 2 * kQT;                // 2 stages
  static constexpr int kV = kK + 2 * kKT;           // 2 stages
  static constexpr int kLse = kV + 2 * kKT;         // kRows f32
  static constexpr int kDelta = kLse + 4 * kRows;   // kRows f32
  static constexpr int kBar = kDelta + 4 * kRows;
  // barrier slots (8 bytes each) after kBar; 1024 bytes of alignment slack
  static constexpr int kQFull = 0, kKFull = 1, kVFull = 3, kKEmpty = 5,
                       kVEmpty = 7;
  static constexpr int kBytes = kBar + 9 * 8 + 1024;
};

template <int kD>
__device__ __forceinline__ void dq_consumer(const AttnParams& p,
                                            const uint8_t* smem,
                                            uint32_t base, uint32_t bars,
                                            int cw, int b, int h, int bh,
                                            int q0, int n_tiles) {
  using L = DqLayout<kD>;
  constexpr int kS = kDqKeys / 2;       // score floats a thread
  const int tid = threadIdx.x % kWg, warp = tid / 32, lane = tid % 32;
  const int row = cw * 64 + warp * 16 + lane / 4;   // of the CTA's rows
  const int qpos[2] = {q0 + row, q0 + row + 8};
  const int q_lo = q0 + cw * 64;        // the warpgroup's first row
  const int cq = 2 * (lane % 4);
  const int Tq = static_cast<int>(p.T), S = static_cast<int>(p.S);
  const float sm_scale = static_cast<float>(p.sm_scale);
  const float inv_keep = static_cast<float>(p.inv_keep);
  const uint32_t ghead = global_head(p, bh);
  const uint32_t seed = static_cast<uint32_t>(p.seed);
  const uint32_t thr = static_cast<uint32_t>(p.keep_threshold);
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + static_cast<int64_t>(b) * S;
  const uint32_t q_tile = base + L::kQ + cw * 64 * 128;
  const uint32_t g_tile = base + L::kG + cw * 64 * 128;
  hopper::mbar_wait(bars + 8 * L::kQFull, 0);
  // rows past T read the next head's statistics (or zeros past the
  // end): their dS is masked to 0 and their dQ is never written
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::kDelta);
  float lse[2], lse_log[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = lse_s[row + 8 * r];
    lse_log[r] = lse[r] * kLog2e;
    delta[r] = delta_s[row + 8 * r];
  }
  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.0f;
  const int k_end = p.causal ? min(S, q_lo + 64) : S;
  const int my_tiles = min(n_tiles, (k_end + kDqKeys - 1) / kDqKeys);
  for (int j = 0; j < my_tiles; ++j) {
    const int s = j & 1;
    const uint32_t par = (j >> 1) & 1;
    const uint32_t k_tile = base + L::kK + s * L::kKT;
    const uint32_t v_tile = base + L::kV + s * L::kKT;
    const int k0 = j * kDqKeys;
    float sc[kS], dp[kS];
    hopper::mbar_wait(bars + 8 * (L::kKFull + s), par);
    hopper::mbar_wait(bars + 8 * (L::kVFull + s), par);
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t oa = (kk / 4) * kBox128 + (kk % 4) * 32;
      const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
      hopper::wgmma_ss<kDqKeys>(sc, hopper::smem_desc(q_tile + oa, 16, 1024),
                                hopper::smem_desc(k_tile + ob, 16, 1024),
                                kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t oa = (kk / 4) * kBox128 + (kk % 4) * 32;
      const uint32_t ob = (kk / 4) * kBox64 + (kk % 4) * 32;
      hopper::wgmma_ss<kDqKeys>(dp, hopper::smem_desc(g_tile + oa, 16, 1024),
                                hopper::smem_desc(v_tile + ob, 16, 1024),
                                kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::mbar_arrive(bars + 8 * (L::kVEmpty + s));

    if (p.dropping) {
#pragma unroll
      for (int c8 = 0; c8 < kS / 4; ++c8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            dp[4 * c8 + 2 * r + e] *=
                drop_mult(seed, ghead, qpos[r], k0 + 8 * c8 + cq + e, thr,
                          inv_keep);
          }
        }
      }
    }
    // sc becomes dS. A tile with no causal mask and no row or key past
    // the end takes the short path.
    const bool edge = (p.causal && k0 + kDqKeys - 1 > q_lo) ||
                      k0 + kDqKeys > S || q_lo + 64 > Tq;
    if (!edge) {
#pragma unroll
      for (int c8 = 0; c8 < kS / 4; ++c8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * c8 + cq + e;
          const float kb = bias != nullptr ? __ldg(bias + kpos) : 0.0f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c8 + 2 * r + e;
            const float x = sc[i] * sm_scale + kb;
            const float pr = ex2(fmaf(x, kLog2e, -lse_log[r]));
            sc[i] = pr * (dp[i] - delta[r]) * sm_scale;
          }
        }
      }
    } else {
#pragma unroll
      for (int c8 = 0; c8 < kS / 4; ++c8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * c8 + cq + e;
          const float kb =
              (bias != nullptr && kpos < S) ? __ldg(bias + kpos) : 0.0f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c8 + 2 * r + e;
            float ds = 0.0f;
            if (qpos[r] < Tq && kpos < S) {
              float x = sc[i] * sm_scale;
              if (p.causal && kpos > qpos[r]) x = kMaskValue;
              x += kb;
              // a masked score overflows to -inf here: its prob is 0
              const float pr = ex2((x - lse[r]) * kLog2e);
              ds = pr * (dp[i] - delta[r]) * sm_scale;
            }
            sc[i] = ds;
          }
        }
      }
    }
    uint32_t s_hi[kS / 2], s_lo[kS / 2];
    hopper::split_bf16(sc, s_hi, s_lo);
    hopper::fence_regs(dq);
    hopper::fence_regs(s_hi);
    hopper::fence_regs(s_lo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      const uint64_t kd = hopper::smem_desc(k_tile + kk * 2048, kBox64, 1024);
      hopper::wgmma_rs<kD>(dq, s_hi + 4 * kk, kd, 1);
      hopper::wgmma_rs<kD>(dq, s_lo + 4 * kk, kd, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    hopper::mbar_arrive(bars + 8 * (L::kKEmpty + s));
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<kD>(static_cast<__nv_bfloat16*>(p.dq), dq, qpos[0], one, Tq, b,
                 h, p, cq);
}

template <int kD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ AttnParams p,
                    const __grid_constant__ TmaMaps maps) {
  using L = DqLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t bars = base + L::kBar;
  const int H = static_cast<int>(p.H), S = static_cast<int>(p.S);
  const int Tq = static_cast<int>(p.T);
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRows;
  const int k_end = p.causal ? min(S, q0 + L::kRows) : S;
  const int n_tiles = (k_end + kDqKeys - 1) / kDqKeys;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars + 8 * L::kQFull, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(bars + 8 * (L::kKFull + s), 1);
      hopper::mbar_init(bars + 8 * (L::kVFull + s), 1);
      hopper::mbar_init(bars + 8 * (L::kKEmpty + s), kConsumers * kWg);
      hopper::mbar_init(bars + 8 * (L::kVEmpty + s), kConsumers * kWg);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < kWg) {
    hopper::regs_dealloc<kProducerRegs>();
    // thread 0: Q, dO, lse and delta, then the K tiles; thread 32: the V
    // tiles. A refill of tile j waits for the release of tile j - 2,
    // which both consumers read (each reads a prefix of the tiles, and
    // the two prefixes differ by at most the last tile).
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool is_k = threadIdx.x == 0;
      const CUtensorMap* map = is_k ? &maps.k : &maps.v;
      const int full = is_k ? L::kKFull : L::kVFull;
      const int empty = is_k ? L::kKEmpty : L::kVEmpty;
      const int dst = is_k ? L::kK : L::kV;
      if (is_k) {
        const uint32_t qf = bars + 8 * L::kQFull;
        hopper::mbar_expect_tx(qf, 2 * L::kQT + 8 * L::kRows);
        for (int i = 0; i < kD / 64; ++i) {
          hopper::tma_load_4d(base + L::kQ + i * kBox128, &maps.q, qf,
                              64 * i, h, q0, b);
          hopper::tma_load_4d(base + L::kG + i * kBox128, &maps.g, qf,
                              64 * i, h, q0, b);
        }
        hopper::tma_load_1d(base + L::kLse, &maps.lse, qf, bh * Tq + q0);
        hopper::tma_load_1d(base + L::kDelta, &maps.delta, qf, bh * Tq + q0);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) {
          hopper::mbar_wait(bars + 8 * (empty + s), ((j >> 1) - 1) & 1);
        }
        const uint32_t f = bars + 8 * (full + s);
        hopper::mbar_expect_tx(f, L::kKT);
        for (int i = 0; i < kD / 64; ++i) {
          hopper::tma_load_4d(base + dst + s * L::kKT + i * kBox64, map, f,
                              64 * i, h, j * kDqKeys, b);
        }
      }
    }
  } else {
    hopper::regs_alloc<kConsumerRegs>();
    dq_consumer<kD>(p, smem, base, bars, threadIdx.x / kWg - 1, b, h, bh, q0,
                    n_tiles);
  }
}

// the map of a [B, L, H, D] bf16 tensor read in [rows x 64] boxes:
// dims {D, H, L, B}
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, const AttnParams& p,
                     int64_t len, int64_t sb, int64_t sl, int64_t sh,
                     int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(p.D),
                            static_cast<uint64_t>(p.H),
                            static_cast<uint64_t>(len),
                            static_cast<uint64_t>(p.B)};
  const int64_t strides[3] = {sh, sl, sb};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, 4,
                          dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the map of a contiguous f32 [B * H, T] row statistic, flat, in boxes of
// `rows` (a box that runs past a row's end reads the next row: those
// queries are masked)
cudaError_t stat_map(CUtensorMap* map, const float* ptr, const AttnParams& p,
                     int rows) {
  const uint64_t n = static_cast<uint64_t>(p.B * p.H * p.T);
  const uint32_t box[1] = {static_cast<uint32_t>(rows)};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, 1, &n,
                          nullptr, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int kD>
cudaError_t launch_wgmma(int which, const AttnParams& p, cudaStream_t st) {
  TmaMaps maps;
  memset(&maps, 0, sizeof(maps));
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  cudaError_t err;
  if (which == 0) {
    using L = FwdLayout<kD>;
    if ((err = bf16_map(&maps.q, p.q, p, p.T, p.q_sb, p.q_st, p.q_sh,
                        L::kRows)) != cudaSuccess ||
        (err = bf16_map(&maps.k, p.k, p, p.S, p.k_sb, p.k_st, p.k_sh,
                        kFwdKeys)) != cudaSuccess ||
        (err = bf16_map(&maps.v, p.v, p, p.S, p.v_sb, p.v_st, p.v_sh,
                        kFwdKeys)) != cudaSuccess) {
      return err;
    }
    err = cudaFuncSetAttribute(fwd_wgmma_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    const unsigned nq = static_cast<unsigned>((p.T + L::kRows - 1) / L::kRows);
    fwd_wgmma_kernel<kD>
        <<<dim3(bh, nq), kWgmmaThreads, L::kBytes, st>>>(p, maps);
  } else if (which == 1) {
    using L = DqLayout<kD>;
    if ((err = bf16_map(&maps.q, p.q, p, p.T, p.q_sb, p.q_st, p.q_sh,
                        L::kRows)) != cudaSuccess ||
        (err = bf16_map(&maps.g, p.g, p, p.T, p.g_sb, p.g_st, p.g_sh,
                        L::kRows)) != cudaSuccess ||
        (err = bf16_map(&maps.k, p.k, p, p.S, p.k_sb, p.k_st, p.k_sh,
                        kDqKeys)) != cudaSuccess ||
        (err = bf16_map(&maps.v, p.v, p, p.S, p.v_sb, p.v_st, p.v_sh,
                        kDqKeys)) != cudaSuccess ||
        (err = stat_map(&maps.lse, p.lse, p, L::kRows)) != cudaSuccess ||
        (err = stat_map(&maps.delta, p.delta, p, L::kRows)) != cudaSuccess) {
      return err;
    }
    err = cudaFuncSetAttribute(dq_wgmma_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    const unsigned nq = static_cast<unsigned>((p.T + L::kRows - 1) / L::kRows);
    dq_wgmma_kernel<kD>
        <<<dim3(bh, nq), kWgmmaThreads, L::kBytes, st>>>(p, maps);
  } else {
    using L = DkvLayout<kD>;
    if ((err = bf16_map(&maps.q, p.q, p, p.T, p.q_sb, p.q_st, p.q_sh,
                        kDkvRows)) != cudaSuccess ||
        (err = bf16_map(&maps.g, p.g, p, p.T, p.g_sb, p.g_st, p.g_sh,
                        kDkvRows)) != cudaSuccess ||
        (err = bf16_map(&maps.k, p.k, p, p.S, p.k_sb, p.k_st, p.k_sh,
                        L::kKeys)) != cudaSuccess ||
        (err = bf16_map(&maps.v, p.v, p, p.S, p.v_sb, p.v_st, p.v_sh,
                        L::kKeys)) != cudaSuccess ||
        (err = stat_map(&maps.lse, p.lse, p, kDkvRows)) != cudaSuccess ||
        (err = stat_map(&maps.delta, p.delta, p, kDkvRows)) != cudaSuccess) {
      return err;
    }
    err = cudaFuncSetAttribute(dkv_wgmma_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    const unsigned nk = static_cast<unsigned>((p.S + L::kKeys - 1) / L::kKeys);
    dkv_wgmma_kernel<kD>
        <<<dim3(bh, nk), kWgmmaThreads, L::kBytes, st>>>(p, maps);
  }
  return cudaGetLastError();
}

// TMA's rule for the tensor-core route's inputs: 16-byte-aligned base
// addresses, and 16-byte strides on every dim longer than 1 (the head
// dim contiguous, as the wrapper checks). The wrapper sends inputs that
// break it to the FMA kernels; the launch refuses them here.
bool tma_ok(const void* ptr, int64_t sb, int64_t sl, int64_t sh, int64_t len,
            const AttnParams& p) {
  const auto legal = [](int64_t stride, int64_t extent) {
    return extent <= 1 || (stride * 2) % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && legal(sb, p.B) &&
         legal(sl, len) && legal(sh, p.H);
}

bool tma_legal(int which, const AttnParams& p) {
  bool ok = tma_ok(p.q, p.q_sb, p.q_st, p.q_sh, p.T, p) &&
            tma_ok(p.k, p.k_sb, p.k_st, p.k_sh, p.S, p) &&
            tma_ok(p.v, p.v_sb, p.v_st, p.v_sh, p.S, p);
  if (which != 0) {
    ok = ok && tma_ok(p.g, p.g_sb, p.g_st, p.g_sh, p.T, p) &&
         reinterpret_cast<uintptr_t>(p.lse) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.delta) % 16 == 0;
  }
  return ok;
}

// ---- the tile check ------------------------------------------------------
// C[64 x N] = A[64 x K] B through the kernels' TMA loads and wgmma forms:
// B K-major ([N, K] row-major: C = A B^T; A from shared memory, as
// S = Q.K^T) or MN-major ([K, N] row-major: C = A B; A in registers
// in the accumulator's fragment order, as O += P.V).

template <int kN, int kK, bool kMN>
__global__ void __launch_bounds__(kWg)
    tile_check_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __nv_bfloat16* a, float* c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_u32(hopper::align_1024(smem_raw));
  const uint32_t a_tile = base;                    // K/64 boxes [64 x 64]
  const uint32_t b_tile = base + kK * 128;         // boxes of 128-byte rows
  const uint32_t bar = b_tile + kN * kK * 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, (kMN ? 0 : 64 * kK * 2) + kN * kK * 2);
    if (!kMN) {
      for (int i = 0; i < kK / 64; ++i) {
        hopper::tma_load_2d(a_tile + i * kBox64, &map_a, bar, 64 * i, 0);
        hopper::tma_load_2d(b_tile + i * kN * 128, &map_b, bar, 64 * i, 0);
      }
    } else {
      for (int i = 0; i < kN / 64; ++i) {
        hopper::tma_load_2d(b_tile + i * kK * 128, &map_b, bar, 64 * i, 0);
      }
    }
  }
  hopper::mbar_wait(bar, 0);
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
  if constexpr (!kMN) {
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      const uint32_t oa = (kk / 4) * kBox64 + (kk % 4) * 32;
      const uint32_t ob = (kk / 4) * kN * 128 + (kk % 4) * 32;
      hopper::wgmma_ss<kN>(acc, hopper::smem_desc(a_tile + oa, 16, 1024),
                           hopper::smem_desc(b_tile + ob, 16, 1024), 1);
    }
  } else {
    uint32_t frag[kK / 4];
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      const int col = 16 * kk + cq;
      frag[4 * kk + 0] = a32[(row * kK + col) / 2];
      frag[4 * kk + 1] = a32[((row + 8) * kK + col) / 2];
      frag[4 * kk + 2] = a32[(row * kK + col + 8) / 2];
      frag[4 * kk + 3] = a32[((row + 8) * kK + col + 8) / 2];
    }
    hopper::fence_regs(acc);
    hopper::fence_regs(frag);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      hopper::wgmma_rs<kN>(acc, frag + 4 * kk,
                           hopper::smem_desc(b_tile + kk * 2048, kK * 128,
                                             1024),
                           1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int c8 = 0; c8 < kN / 8; ++c8) {
    const int col = 8 * c8 + cq;
    c[row * kN + col] = acc[4 * c8];
    c[row * kN + col + 1] = acc[4 * c8 + 1];
    c[(row + 8) * kN + col] = acc[4 * c8 + 2];
    c[(row + 8) * kN + col + 1] = acc[4 * c8 + 3];
  }
}

template <int kN, int kK, bool kMN>
cudaError_t launch_tile_check(const void* a, const void* b, float* c,
                              cudaStream_t st) {
  CUtensorMap map_a, map_b;
  memset(&map_a, 0, sizeof(map_a));
  const uint64_t dims_a[2] = {kK, 64};
  const int64_t stride_a[1] = {kK};
  const uint32_t box_a[2] = {64, 64};
  cudaError_t err = hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     2, a, 2, dims_a, stride_a, box_a,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // K-major B [N, K]: boxes [N rows x 64]; MN-major B [K, N]: [K x 64]
  const uint64_t dims_b[2] = {kMN ? kN : kK, kMN ? kK : kN};
  const int64_t stride_b[1] = {kMN ? kN : kK};
  const uint32_t box_b[2] = {64, kMN ? kK : kN};
  err = hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, 2,
                         dims_b, stride_b, box_b, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const int bytes = kK * 128 + kN * kK * 2 + 8 + 1024;
  err = cudaFuncSetAttribute(tile_check_kernel<kN, kK, kMN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  tile_check_kernel<kN, kK, kMN><<<1, kWg, bytes, st>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(a), c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(int which, const AttnParams* p,
                                      int dtype, void* stream) {
  if (p->B < 1 || p->H < 1 || p->T < 1 || p->S < 1 || p->D < 1 ||
      p->num_heads < p->H || p->n_col != column_chunks(p->D) ||
      p->n_col > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the route is the caller's: bf16 inputs that meet TMA's rule run on
  // the tensor cores, every other input on the FMA kernels. A tensor-core
  // launch on inputs that break the rule is refused, never rerouted.
  if (p->tensor_core) {
    // the wgmma kernels hold at most a 128-wide head
    if (dtype != kBF16 || p->D > 128) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (!tma_legal(which, *p)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return static_cast<int>(p->D <= 64 ? launch_wgmma<64>(which, *p, st)
                                       : launch_wgmma<128>(which, *p, st));
  }
  cudaError_t err;
  switch (dtype) {
    case kF32: err = launch_dim<float>(which, *p, st); break;
    case kBF16: err = launch_dim<__nv_bfloat16>(which, *p, st); break;
    case kF16: err = launch_dim<__half>(which, *p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// C f32 [64, n] = a bf16 [64, k] times b bf16 ([n, k] when b_mn_major is
// 0, C = a b^T; [k, n] when 1, C = a b), all contiguous; n, k in {64, 128}
extern "C" int wgmma_tile_check(const void* a, const void* b, float* c, int n,
                                int k, int b_mn_major, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (n == 128) * 4 + (k == 128) * 2 + (b_mn_major != 0);
  if ((n != 64 && n != 128) || (k != 64 && k != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (key) {
    case 0: err = launch_tile_check<64, 64, false>(a, b, c, st); break;
    case 1: err = launch_tile_check<64, 64, true>(a, b, c, st); break;
    case 2: err = launch_tile_check<64, 128, false>(a, b, c, st); break;
    case 3: err = launch_tile_check<64, 128, true>(a, b, c, st); break;
    case 4: err = launch_tile_check<128, 64, false>(a, b, c, st); break;
    case 5: err = launch_tile_check<128, 64, true>(a, b, c, st); break;
    case 6: err = launch_tile_check<128, 128, false>(a, b, c, st); break;
    default: err = launch_tile_check<128, 128, true>(a, b, c, st); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

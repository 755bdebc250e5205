// Flash decode over the serving KV cache, for Hopper (sm_90a): the ring
// layout (K5) and the paged pool (K6) share one kernel body.
//
// K5 replaces the Pallas kernel `_flash_decode_kernel` behind
// `flash_decode` in deepspeed_tpu/ops/pallas/flash_decode.py (the
// pallas_call at :260). Same function: one query token per (row, head)
// attends over that row's cache k/v [B, S, H, D] up to and including
// position positions[b]; int8 / fp8 storage is dequantized in
// registers through per-(row, position, head) f32 scales.
//
// K6 replaces the same body behind `flash_decode_paged` (the
// pallas_call at :353): the keys live in a pool [n_pages, page_size, H,
// D] and row b's key s sits in page page_table[b, s / page_size] at
// slot s % page_size. The walk, the arithmetic and the merge are K5's;
// only the address of a key differs, so over an in-order table that
// maps a row onto the same bytes as a ring row, K6 gives K5's result
// bit for bit. The table is read in place through its row stride, and
// only entries that cover a key s <= min(positions[b], S - 1) are ever
// loaded: entries past a row's occupancy may hold anything, out-of-range
// page ids included.
//
// What bounds it on the card: bytes. Per (row, head) the work is
// 4 * D flops per cached key against 2 * D * sizeof(storage) bytes of
// k/v, i.e. well under one flop per byte — three orders of magnitude
// below the H100's bf16 ridge point. So the design is about reading
// only the bytes that matter:
//
// - positions past positions[b] are never loaded (the CUDA form of the
//   TPU kernel's clamped index map: stale ring tenants cost no traffic
//   and cannot leak into the output);
// - k and v are read in place as [B, S, H, D] through their strides —
//   no head-folded copy of the cache is ever made;
// - quantized payloads are widened in registers; no dequantized copy
//   of the cache exists.
//
// Layout: one CTA per (head, row), kWarps warps. Warp w walks key
// groups starting at w * kKeys with a stride of kWarps * kKeys keys;
// each lane owns head-dim elements d = lane + 32 * j. A warp keeps an
// fp32 running max / sum / acc[D] (online softmax); the warps merge
// through shared memory with a log-sum-exp combine. Loading kKeys rows
// before reducing any of them keeps several loads in flight per warp.
//
// Numerics follow the TPU kernel: score = (q_f32 . k_f32) * k_scale *
// D^-0.5 (in that order); value scales multiply the probabilities after
// the running sum has taken them; out = acc / max(l, 1e-30), cast to
// q's dtype. A row whose position is negative attends to nothing and
// writes zeros, as the TPU kernel's all-skipped grid does.
//
// Interface: a plain C function (ctypes), launched on the caller's
// stream; it returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxJ = kMaxD / 32;
constexpr int kKeys = 4;

// dtype codes shared with ops/flash_decode.py
enum DType : int {
  kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kE4M3 = 4, kE5M2 = 5,
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

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

// A key's address is (lead, slot): the ring's (row b, position s) or
// the pool's (page, s % page_size). Each buffer's leading stride (*_sb)
// is the row stride for the ring and the page stride for the pool.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // null unless quantized
  const float* v_scale;
  const int32_t* positions;
  const int32_t* page_table;   // paged only: [B, pages_per_row]
  void* out;
  int S, D;
  int page_size;               // paged only
  float sm_scale;
  int64_t q_sb, q_sh;            // element strides
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t ks_sb, ks_ss, ks_sh;
  int64_t vs_sb, vs_ss, vs_sh;
  int64_t o_sb, o_sh;
  int64_t t_sb;                // page-table row stride
};

// (lead, slot) of row b's key s; the caller guarantees s <= pos, so a
// paged lookup only touches entries inside the row's occupancy.
template <bool kPaged>
__device__ __forceinline__ void key_address(const Params& p, int b, int s,
                                            int64_t& lead, int64_t& slot) {
  if (kPaged) {
    lead = p.page_table[b * p.t_sb + s / p.page_size];
    slot = s % p.page_size;
  } else {
    lead = b;
    slot = s;
  }
}

template <typename QT, typename KT, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool quant = p.k_scale != nullptr;

  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];

  QT* out = static_cast<QT*>(p.out) + b * p.o_sb + h * p.o_sh;
  int pos = p.positions[b];
  if (pos < 0) {
    for (int d = threadIdx.x; d < p.D; d += kThreads) {
      out[d] = from_f32<QT>(0.0f);
    }
    return;
  }
  if (pos > p.S - 1) pos = p.S - 1;   // every slot admitted

  const QT* qrow = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh;
  const KT* kbase = static_cast<const KT*>(p.k) + h * p.k_sh;
  const KT* vbase = static_cast<const KT*>(p.v) + h * p.v_sh;

  float qv[kMaxJ];
  float acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < p.D ? to_f32(qrow[d]) : 0.0f;
    acc[j] = 0.0f;
  }
  float m = -INFINITY;
  float l = 0.0f;

  for (int s0 = warp * kKeys; s0 <= pos; s0 += kWarps * kKeys) {
    // scores of this warp's kKeys keys; keys past pos score -inf
    float sc[kKeys];
    float kv[kKeys][kMaxJ];
    int64_t lead[kKeys], slot[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int s = s0 + u;
      lead[u] = 0;
      slot[u] = 0;
      if (s <= pos) key_address<kPaged>(p, b, s, lead[u], slot[u]);
      const KT* krow = kbase + lead[u] * p.k_sb + slot[u] * p.k_ss;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int d = lane + 32 * j;
        kv[u][j] = (s <= pos && d < p.D) ? to_f32(krow[d]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) dot += qv[j] * kv[u][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      sc[u] = dot;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int s = s0 + u;
      if (s <= pos) {
        float x = sc[u];
        if (quant) {
          x *= p.k_scale[lead[u] * p.ks_sb + slot[u] * p.ks_ss + h * p.ks_sh];
        }
        x *= p.sm_scale;
        sc[u] = x;
        m_new = fmaxf(m_new, x);
      } else {
        sc[u] = -INFINITY;
      }
    }
    // s0 <= pos, so the group holds at least one live key: m_new is
    // finite and exp(-inf - m_new) is an exact 0 for dead keys.
    const float corr = expf(m - m_new);
    float pr[kKeys];
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      pr[u] = expf(sc[u] - m_new);
      psum += pr[u];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int s = s0 + u;
      if (quant && s <= pos) {
        pr[u] *= p.v_scale[lead[u] * p.vs_sb + slot[u] * p.vs_ss +
                           h * p.vs_sh];
      }
      const KT* vrow = vbase + lead[u] * p.v_sb + slot[u] * p.v_ss;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int d = lane + 32 * j;
        kv[u][j] = (s <= pos && d < p.D) ? to_f32(vrow[d]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      float a = acc[j] * corr;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) a += pr[u] * kv[u][j];
      acc[j] = a;
    }
  }

  // log-sum-exp merge of the warps' partial states
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int d = lane + 32 * j;
    if (d < p.D) s_acc[warp][d] = acc[j];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  // warp 0 holds key 0, so the merged max is finite
  float m_all = s_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float l_all = 0.0f;
  float wgt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(s_m[w] - m_all);   // 0 for warps that saw no key
    l_all += s_l[w] * wgt[w];
  }
  const float inv = 1.0f / fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_acc[w][d] * wgt[w];
    out[d] = from_f32<QT>(o * inv);
  }
}

template <typename QT, typename KT, bool kPaged>
cudaError_t launch_typed(const Params& p, int B, int H,
                         cudaStream_t stream) {
  flash_decode_kernel<QT, KT, kPaged>
      <<<dim3(H, B), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, bool kPaged>
cudaError_t launch_kv(const Params& p, int B, int H, int kv_dtype,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_typed<QT, float, kPaged>(p, B, H, stream);
    case kBF16:
      return launch_typed<QT, __nv_bfloat16, kPaged>(p, B, H, stream);
    case kF16: return launch_typed<QT, __half, kPaged>(p, B, H, stream);
    case kI8: return launch_typed<QT, int8_t, kPaged>(p, B, H, stream);
    case kE4M3:
      return launch_typed<QT, __nv_fp8_e4m3, kPaged>(p, B, H, stream);
    case kE5M2:
      return launch_typed<QT, __nv_fp8_e5m2, kPaged>(p, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPaged>
cudaError_t launch_q(const Params& p, int B, int H, int q_dtype,
                     int kv_dtype, cudaStream_t stream) {
  switch (q_dtype) {
    case kF32: return launch_kv<float, kPaged>(p, B, H, kv_dtype, stream);
    case kBF16:
      return launch_kv<__nv_bfloat16, kPaged>(p, B, H, kv_dtype, stream);
    case kF16: return launch_kv<__half, kPaged>(p, B, H, kv_dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

void set_common(Params& p, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const void* positions, void* out, int S, int D,
                float sm_scale) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.positions = static_cast<const int32_t*>(positions);
  p.page_table = nullptr;
  p.out = out;
  p.S = S;
  p.D = D;
  p.page_size = 0;
  p.sm_scale = sm_scale;
  p.t_sb = 0;
}

}  // namespace

extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out,
    int B, int S, int H, int D, float sm_scale,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t ks_sb, int64_t ks_ss, int64_t ks_sh,
    int64_t vs_sb, int64_t vs_ss, int64_t vs_sh,
    int64_t o_sb, int64_t o_sh,
    int q_dtype, int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, q, k, v, k_scale, v_scale, positions, out, S, D, sm_scale);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.ks_sb = ks_sb; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
  p.vs_sb = vs_sb; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  return static_cast<int>(launch_q<false>(
      p, B, H, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream)));
}

// K6: the pool's leading strides (k_sp, v_sp, ks_sp, vs_sp) step one
// page; S = pages_per_row * page_size.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, const void* page_table,
    void* out, int B, int S, int H, int D, int page_size, float sm_scale,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sp, int64_t k_ss, int64_t k_sh,
    int64_t v_sp, int64_t v_ss, int64_t v_sh,
    int64_t ks_sp, int64_t ks_ss, int64_t ks_sh,
    int64_t vs_sp, int64_t vs_ss, int64_t vs_sh,
    int64_t t_sb, int64_t o_sb, int64_t o_sh,
    int q_dtype, int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > kMaxD || page_size < 1 ||
      S % page_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, q, k, v, k_scale, v_scale, positions, out, S, D, sm_scale);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.page_size = page_size;
  p.t_sb = t_sb;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.ks_sb = ks_sp; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
  p.vs_sb = vs_sp; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  return static_cast<int>(launch_q<true>(
      p, B, H, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

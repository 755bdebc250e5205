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
// below the H100's bf16 ridge point. At serving's batch the bytes are
// few (a few MB a call), so what sets the time is how many dependent
// trips to device memory a CTA makes and how many CTAs share them. The
// design reads only the bytes that matter, in as few trips as it can:
//
// - positions past positions[b] are never loaded (the CUDA form of the
//   TPU kernel's clamped index map: stale ring tenants cost no traffic
//   and cannot leak into the output);
// - k and v are read in place as [B, S, H, D] (or [n_pages, page_size,
//   H, D]) through their strides — no head-folded copy is ever made;
// - quantized payloads are widened in registers; no dequantized copy
//   of the cache exists.
//
// Layout: grid (head, row, chunk) over fixed chunks of kChunk keys of
// key INDEX (independent of the page size, so K5 and K6 split the same
// way). A chunk that starts past min(positions[b], S - 1) exits at once,
// without touching the table. A paged CTA first stages the (page, slot)
// of each of its live keys in shared memory, reading only the table
// entries that cover keys s <= min(positions[b], S - 1); the key loop
// then has no division and no table load. Lanes form groups of
// lanes-per-key (a power of two, the fewest whose 16-byte vectors
// cover a row: bf16 D 64 = 128 bytes = 8 lanes); a group owns a key
// slot and walks the chunk's keys slot, slot + n_slots, ..., 2 or 4 keys
// at a time, issuing the K and V rows (and scales) of all those keys before
// any of their softmax. A layout that a 16-byte vector cannot read
// (D * itemsize, a stride or a base address not a multiple of 16 bytes)
// takes the same walk with one element a lane per load instead. Each
// group keeps an fp32 running max / sum / acc over its lanes' elements
// (online softmax); the groups merge through shared memory in slot
// order with a log-sum-exp combine into the chunk's (m, l, acc[D]).
// One live chunk writes the output directly. Otherwise each CTA writes
// its partial to a workspace [B*H, n_chunks, D + 2], takes a ticket
// (an atomic counter per (row, head)), and the CTA that takes the last
// ticket merges the partials in chunk order 0, 1, ..., n - 1 (fixed, so
// the result does not depend on which CTA finishes last) and resets the
// counter to 0 for the next launch: one launch a call, and safe to
// replay from a CUDA graph. A chunk or group that saw no live key has
// m = -inf and weight exp(-inf - m_all) = 0; m_all is finite because
// group 0 of chunk 0 holds key 0.
//
// Numerics follow the TPU kernel: score = (q_f32 . k_f32) * k_scale *
// D^-0.5 (in that order); value scales multiply the probabilities after
// the running sum has taken them; out = acc / max(l, 1e-30), cast to
// q's dtype. A row whose position is negative attends to nothing and
// writes zeros, as the TPU kernel's all-skipped grid does.
//
// Any head dim. A CTA holds at most kColChunk (256) output columns: past
// it the grid's x splits each head into column chunks of 256 (`n_col`,
// from ops/head_dim.py), and each CTA forms the full score
// of every key, streaming q's and k's elements over D in chunks of 256
// (a walk of its own, one element a lane), but reads and accumulates
// only its own chunk of v. Every chunk's CTA forms the same scores in
// the same order, so their (m, l) agree bit for bit; chunk 0 writes them
// to the workspace, each CTA its own columns, and the merge waits for
// all n_live x n_col tickets. The host picks that path (kWide) only when
// n_col > 1: at D <= 256 the kernel is the one-chunk kernel above, with
// no column arithmetic.
//
// Interface: a plain C function (ctypes), launched on the caller's
// stream; it returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "column_chunk.cuh"

namespace {

constexpr int kChunk = 128;     // keys of a CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// keys a group loads before reducing any: 4 for 2-byte storage on the
// 16-byte walk, 2 where a key's row takes more registers a lane (f32 rows
// up to two vectors a lane; 1-byte rows 16 elements a lane, and at D 64
// a group has only 2 keys of a chunk anyway; the element-a-lane walk up
// to 8 elements). The registers of the heaviest walk set those of the
// whole kernel, and with them how many CTAs an SM holds.
constexpr int kU = 4;
constexpr int kUWide = 2;
// shared-memory acc of the groups: (kThreads / lanes-per-key) * D floats,
// at most 4096 (int8 or fp8 rows of 16-byte vectors)
constexpr int kMaxSlots = kThreads;
constexpr int kSlotFloats = 4096;

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

// element e of a 16-byte vector of KT, widened
template <typename KT>
__device__ __forceinline__ float widen(const uint4& v, int e) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(KT));   // a word's
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  const uint32_t w = words[e / kPer] >> (32 / kPer * (e % kPer));
  if constexpr (std::is_same<KT, float>::value) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>(w)));
  } else if constexpr (std::is_same<KT, __half>::value) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
  } else if constexpr (std::is_same<KT, int8_t>::value) {
    return static_cast<float>(static_cast<int8_t>(w & 0xFFu));
  } else {
    KT x;
    x.__x = static_cast<__nv_fp8_storage_t>(w & 0xFFu);
    return to_f32(x);
  }
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
  float* ws;                   // [B*H, n_chunks, D + 2] chunk partials
  int32_t* tickets;            // [B*H], 0 between launches
  int S, D, H;
  int n_col;                   // column chunks of kColChunk
  int page_size;               // paged only
  int n_chunks;
  int vec;                     // 16-byte loads of k/v rows
  int lpk_shift;               // log2 of the lanes a key's row takes
  float sm_scale;
  int64_t q_sb, q_sh;            // element strides
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t ks_sb, ks_ss, ks_sh;
  int64_t vs_sb, vs_ss, vs_sh;
  int64_t o_sb, o_sh;
  int64_t t_sb;                // page-table row stride
};

// What a group's walk leaves in shared memory for the chunk merge
struct ChunkSmem {
  int32_t lead[kChunk];        // paged: the page of key c0 + i
  int32_t slot[kChunk];        // paged: its slot in that page
  float m[kMaxSlots];
  float l[kMaxSlots];
  float w[kMaxSlots];
  float acc[kSlotFloats];      // [group][D]
};

// One group's walk over the chunk's live keys [c0, last]: kVec loads a
// row as 16-byte vectors of kE elements, else one element a lane a
// load. Writes the group's (m, l, acc over its elements of the output
// columns [oc0, oc0 + on)) to shared memory. Lanes of a group hold the
// same m and l (the butterfly sums give every lane the same bits). With
// kWide (past kColChunk columns: one element a lane) the dot runs over
// D in chunks of kColChunk, q's and k's elements of each chunk loaded in
// turn; without it (oc0 0, on D) the walk holds q and a key's whole row.
template <typename QT, typename KT, bool kPaged, bool kVec, bool kWide>
__device__ __forceinline__ void group_walk(const Params& p, ChunkSmem& sm,
                                           int b, int h, int c0, int last,
                                           int quant, int oc0, int on) {
  constexpr int kE = kVec ? 16 / static_cast<int>(sizeof(KT)) : 1;
  constexpr int kVPL = kVec ? (sizeof(KT) == 4 ? 2 : 1) : 8;
  constexpr int kN = (kVec && sizeof(KT) == 2) ? kU : kUWide;
  using Raw = typename std::conditional<kVec, uint4, KT>::type;
  static_assert(!kWide || !kVec, "a wide head takes the element walk");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = p.lpk_shift, lpk = 1 << shift;
  const int gl = lane & (lpk - 1);
  const int group = warp * (32 >> shift) + (lane >> shift);
  const int n_groups = kWarps * (32 >> shift);
  const int nv = on / kE;              // vectors (elements) of the output

  const QT* qrow = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh;
  const KT* kbase = static_cast<const KT*>(p.k) + h * p.k_sh;
  const KT* vbase = static_cast<const KT*>(p.v) + h * p.v_sh + oc0;
  float qv[kVPL][kE], acc[kVPL][kE];
  // q's elements of columns [c, c + n)
  auto load_q = [&](int c, int n) {
#pragma unroll
    for (int j = 0; j < kVPL; ++j) {
      const int vi = gl + (j << shift);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        qv[j][e] = vi < n / kE ? to_f32(qrow[c + vi * kE + e]) : 0.0f;
      }
    }
  };
  if constexpr (!kWide) load_q(0, p.D);
#pragma unroll
  for (int j = 0; j < kVPL; ++j)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[j][e] = 0.0f;
  float m = -INFINITY, l = 0.0f;
  const int n_live = last - c0 + 1;
  // the walk is uniform over a warp (its shuffles need every lane): it
  // runs while the warp's first group has a live key
  const int warp_first = warp * (32 >> shift);
  for (int base = 0; warp_first + base < n_live; base += kN * n_groups) {
    const int i0 = group + base;
    Raw kr[kN][kVPL], vr[kN][kVPL];
    float ks[kN], vs[kN];
    bool live[kN];
    const KT* krows[kN];
    // every load of the kN keys first (past kColChunk columns, k's
    // chunks come in turn below)
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int i = i0 + u * n_groups;
      live[u] = i < n_live;
      const int ii = live[u] ? i : 0;
      int64_t lead, slot;
      if (kPaged) {
        lead = sm.lead[ii];
        slot = sm.slot[ii];
      } else {
        lead = b;
        slot = c0 + ii;
      }
      krows[u] = kbase + lead * p.k_sb + slot * p.k_ss;
      const KT* vrow = vbase + lead * p.v_sb + slot * p.v_ss;
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        const int vi = gl + (j << shift);
        if (live[u] && vi < nv) {
          if constexpr (!kWide) {
            kr[u][j] = *reinterpret_cast<const Raw*>(krows[u] + vi * kE);
          }
          vr[u][j] = *reinterpret_cast<const Raw*>(vrow + vi * kE);
        } else {
          kr[u][j] = Raw{};
          vr[u][j] = Raw{};
        }
      }
      ks[u] = 1.0f;
      vs[u] = 1.0f;
      if (quant && live[u]) {
        ks[u] = p.k_scale[lead * p.ks_sb + slot * p.ks_ss + h * p.ks_sh];
        vs[u] = p.v_scale[lead * p.vs_sb + slot * p.vs_ss + h * p.vs_sh];
      }
    }
    // a wide head's dots, each lane's share over every chunk of D
    float dots[kN];
    if constexpr (kWide) {
#pragma unroll
      for (int u = 0; u < kN; ++u) dots[u] = 0.0f;
      for (int c = 0; c < p.D; c += kColChunk) {
        const int n = min(kColChunk, p.D - c);
        load_q(c, n);
#pragma unroll
        for (int u = 0; u < kN; ++u) {
#pragma unroll
          for (int j = 0; j < kVPL; ++j) {
            const int vi = gl + (j << shift);
            const float x = live[u] && vi < n ? to_f32(krows[u][c + vi])
                                              : 0.0f;
            dots[u] += qv[j][0] * x;
          }
        }
      }
    }
    // scores; keys past the chunk's last live key score -inf
    float sc[kN];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      float dot = 0.0f;
      if constexpr (kWide) {
        dot = dots[u];
      } else {
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            float x;
            if constexpr (kVec) {
              x = widen<KT>(kr[u][j], e);
            } else {
              x = to_f32(kr[u][j]);
            }
            dot += qv[j][e] * x;
          }
        }
      }
      for (int off = 1; off < lpk; off <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (live[u]) {
        float x = dot;
        if (quant) x *= ks[u];
        x *= p.sm_scale;
        sc[u] = x;
        m_new = fmaxf(m_new, x);
      } else {
        sc[u] = -INFINITY;
      }
    }
    // a group with no live key left changes nothing; otherwise key i0 is
    // live, so m_new is finite and exp(-inf - m_new) is an exact 0 for
    // dead keys
    if (!live[0]) continue;
    const float corr = expf(m - m_new);
    float pr[kN];
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      pr[u] = expf(sc[u] - m_new);
      psum += pr[u];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      if (quant) pr[u] *= vs[u];
    }
#pragma unroll
    for (int j = 0; j < kVPL; ++j) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float a = acc[j][e] * corr;
#pragma unroll
        for (int u = 0; u < kN; ++u) {
          float x;
          if constexpr (kVec) {
            x = widen<KT>(vr[u][j], e);
          } else {
            x = to_f32(vr[u][j]);
          }
          a += pr[u] * x;
        }
        acc[j][e] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVPL; ++j) {
    const int vi = gl + (j << shift);
    if (vi < nv) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        sm.acc[group * on + vi * kE + e] = acc[j][e];
      }
    }
  }
  if (gl == 0) {
    sm.m[group] = m;
    sm.l[group] = l;
  }
}

// Three CTAs an SM (80 registers a thread): 396 CTA slots on 132 SMs
// hold the 384 CTAs of 8 rows x 12 heads x 4 chunks in one wave, where
// two (128 registers) would take a second wave. ptxas spills a few
// dozen bytes a thread at this bound; the wave matters more.
// kWide (n_col > 1): grid x is head x column chunk, and the CTA owns the
// output columns [oc0, oc0 + on); else grid x is the head and on is D.
template <typename QT, typename KT, bool kPaged, bool kWide>
__global__ void __launch_bounds__(kThreads, 3)
flash_decode_kernel(const Params p) {
  const int h = kWide ? blockIdx.x / p.n_col : blockIdx.x;
  const int cc = kWide ? blockIdx.x - h * p.n_col : 0;   // column chunk
  const int b = blockIdx.y;
  const int chunk = blockIdx.z;
  const int bh = b * p.H + h;
  const int c0 = chunk * kChunk;
  const int oc0 = cc * kColChunk;
  const int on = kWide ? min(kColChunk, p.D - oc0) : p.D;   // its columns
  const int quant = p.k_scale != nullptr;
  __shared__ ChunkSmem sm;
  __shared__ int is_last;

  QT* out = static_cast<QT*>(p.out) + b * p.o_sb + h * p.o_sh;
  int pos = p.positions[b];
  if (pos < 0) {
    if (chunk == 0) {
      for (int d = threadIdx.x; d < on; d += kThreads) {
        out[oc0 + d] = from_f32<QT>(0.0f);
      }
    }
    return;
  }
  if (pos > p.S - 1) pos = p.S - 1;   // every slot admitted
  if (c0 > pos) return;               // a dead chunk: no table read
  const int n_live = pos / kChunk + 1;
  const int last = min(pos, c0 + kChunk - 1);

  if (kPaged) {
    // the (page, slot) of every live key of the chunk: only table
    // entries that cover keys <= pos are read
    for (int i = threadIdx.x; i <= last - c0; i += kThreads) {
      const int s = c0 + i;
      sm.lead[i] = p.page_table[b * p.t_sb + s / p.page_size];
      sm.slot[i] = s % p.page_size;
    }
    __syncthreads();
  }
  if constexpr (kWide) {
    group_walk<QT, KT, kPaged, false, true>(p, sm, b, h, c0, last, quant,
                                            oc0, on);
  } else if (p.vec) {
    group_walk<QT, KT, kPaged, true, false>(p, sm, b, h, c0, last, quant, 0,
                                            p.D);
  } else {
    group_walk<QT, KT, kPaged, false, false>(p, sm, b, h, c0, last, quant,
                                             0, p.D);
  }
  __syncthreads();

  // the chunk's (m, l, acc): its groups merged in group order
  const int n_groups = kWarps * (32 >> p.lpk_shift);
  float m_all = sm.m[0];              // group 0 holds key c0: finite
  for (int g = 1; g < n_groups; ++g) m_all = fmaxf(m_all, sm.m[g]);
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    sm.w[g] = expf(sm.m[g] - m_all);  // 0 for groups that saw no key
  }
  __syncthreads();
  float l_all = 0.0f;
  for (int g = 0; g < n_groups; ++g) l_all += sm.l[g] * sm.w[g];
  if (n_live == 1) {
    const float inv = 1.0f / fmaxf(l_all, 1e-30f);
    for (int d = threadIdx.x; d < on; d += kThreads) {
      float o = 0.0f;
      for (int g = 0; g < n_groups; ++g) o += sm.acc[g * on + d] * sm.w[g];
      out[oc0 + d] = from_f32<QT>(o * inv);
    }
    return;
  }
  float* part = p.ws + (static_cast<int64_t>(bh) * p.n_chunks + chunk) *
                           (p.D + 2);
  for (int d = threadIdx.x; d < on; d += kThreads) {
    float o = 0.0f;
    for (int g = 0; g < n_groups; ++g) o += sm.acc[g * on + d] * sm.w[g];
    part[oc0 + d] = o;
  }
  // every column chunk's CTA has the same (m, l); chunk 0 writes them
  if (threadIdx.x == 0 && (!kWide || cc == 0)) {
    part[p.D] = m_all;
    part[p.D + 1] = l_all;
  }
  // publish the partial, then take a ticket; the last of the n_live x
  // n_col tickets merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(p.tickets + bh, 1) ==
              (kWide ? n_live * p.n_col : n_live) - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) p.tickets[bh] = 0;   // ready for the next launch
  const float* parts = p.ws + static_cast<int64_t>(bh) * p.n_chunks *
                                  (p.D + 2);
  float mm = -INFINITY;
  for (int c = 0; c < n_live; ++c) {
    mm = fmaxf(mm, __ldcg(parts + c * (p.D + 2) + p.D));
  }
  float ll = 0.0f;
  for (int c = 0; c < n_live; ++c) {
    const float* pc = parts + c * (p.D + 2);
    ll += __ldcg(pc + p.D + 1) * expf(__ldcg(pc + p.D) - mm);
  }
  const float inv = 1.0f / fmaxf(ll, 1e-30f);
  for (int d = threadIdx.x; d < p.D; d += kThreads) {
    float o = 0.0f;
    for (int c = 0; c < n_live; ++c) {
      const float* pc = parts + c * (p.D + 2);
      o += __ldcg(pc + d) * expf(__ldcg(pc + p.D) - mm);
    }
    out[d] = from_f32<QT>(o * inv);
  }
}

template <typename QT, typename KT, bool kPaged>
cudaError_t launch_typed(const Params& p, int B, cudaStream_t stream) {
  if (p.n_col > 1) {
    flash_decode_kernel<QT, KT, kPaged, true>
        <<<dim3(p.H * p.n_col, B, p.n_chunks), kThreads, 0, stream>>>(p);
  } else {
    flash_decode_kernel<QT, KT, kPaged, false>
        <<<dim3(p.H, B, p.n_chunks), kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename QT, bool kPaged>
cudaError_t launch_kv(const Params& p, int B, int kv_dtype,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_typed<QT, float, kPaged>(p, B, stream);
    case kBF16:
      return launch_typed<QT, __nv_bfloat16, kPaged>(p, B, stream);
    case kF16: return launch_typed<QT, __half, kPaged>(p, B, stream);
    case kI8: return launch_typed<QT, int8_t, kPaged>(p, B, stream);
    case kE4M3:
      return launch_typed<QT, __nv_fp8_e4m3, kPaged>(p, B, stream);
    case kE5M2:
      return launch_typed<QT, __nv_fp8_e5m2, kPaged>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPaged>
cudaError_t launch_q(const Params& p, int B, int q_dtype, int kv_dtype,
                     cudaStream_t stream) {
  switch (q_dtype) {
    case kF32: return launch_kv<float, kPaged>(p, B, kv_dtype, stream);
    case kBF16:
      return launch_kv<__nv_bfloat16, kPaged>(p, B, kv_dtype, stream);
    case kF16: return launch_kv<__half, kPaged>(p, B, kv_dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

int item_bytes(int kv_dtype) {
  return kv_dtype == kF32 ? 4 : kv_dtype <= kF16 ? 2 : 1;
}

// The walk's geometry from the storage layout: 16-byte vectors when the
// row, both base addresses and every k/v stride are multiples of 16
// bytes, else one element a lane a load; a key's row takes the fewest
// lanes (a power of two, at most 32) whose loads cover it.
void set_walk(Params& p, int kv_dtype) {
  const int64_t isz = item_bytes(kv_dtype);
  const int64_t strides[6] = {p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  bool vec = (p.D * isz) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  for (int64_t st : strides) vec = vec && (st * isz) % 16 == 0;
  p.vec = vec && p.n_col == 1;   // a wide head takes the element walk
  const int w = p.D < kColChunk ? p.D : kColChunk;   // a chunk's columns
  const int nv = p.vec ? static_cast<int>(w * isz / 16) : w;
  p.lpk_shift = 0;
  while ((1 << p.lpk_shift) < nv && p.lpk_shift < 5) ++p.lpk_shift;
}

void set_common(Params& p, const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const void* positions, void* out, void* ws, void* tickets,
                int S, int H, int D, int n_col, float sm_scale) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.positions = static_cast<const int32_t*>(positions);
  p.page_table = nullptr;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int32_t*>(tickets);
  p.S = S;
  p.H = H;
  p.D = D;
  p.n_col = n_col;
  p.page_size = 0;
  p.n_chunks = (S + kChunk - 1) / kChunk;
  p.sm_scale = sm_scale;
  p.t_sb = 0;
}

bool bad_shape(int B, int S, int H, int D, int n_col) {
  return B < 1 || H < 1 || S < 1 || D < 1 || S / kChunk >= 65535 ||
         n_col != column_chunks(D) ||
         static_cast<int64_t>(H) * n_col > 0x7fffffff;
}

}  // namespace

// ws: f32 [B * H, ceil(S / 128), D + 2] scratch; tickets: int32 [B * H],
// all 0 before the launch (each launch leaves them 0 again); n_col: the
// head's column chunks of 256, ceil(D / 256)
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out, void* ws,
    void* tickets, int B, int S, int H, int D, int n_col, float sm_scale,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t ks_sb, int64_t ks_ss, int64_t ks_sh,
    int64_t vs_sb, int64_t vs_ss, int64_t vs_sh,
    int64_t o_sb, int64_t o_sh,
    int q_dtype, int kv_dtype, void* stream) {
  if (bad_shape(B, S, H, D, n_col)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, q, k, v, k_scale, v_scale, positions, out, ws, tickets, S, H,
             D, n_col, sm_scale);
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.ks_sb = ks_sb; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
  p.vs_sb = vs_sb; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  set_walk(p, kv_dtype);
  return static_cast<int>(launch_q<false>(
      p, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream)));
}

// K6: the pool's leading strides (k_sp, v_sp, ks_sp, vs_sp) step one
// page; S = pages_per_row * page_size. ws and tickets as for K5.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, const void* page_table,
    void* out, void* ws, void* tickets, int B, int S, int H, int D, int n_col,
    int page_size, float sm_scale,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sp, int64_t k_ss, int64_t k_sh,
    int64_t v_sp, int64_t v_ss, int64_t v_sh,
    int64_t ks_sp, int64_t ks_ss, int64_t ks_sh,
    int64_t vs_sp, int64_t vs_ss, int64_t vs_sh,
    int64_t t_sb, int64_t o_sb, int64_t o_sh,
    int q_dtype, int kv_dtype, void* stream) {
  if (bad_shape(B, S, H, D, n_col) || page_size < 1 || S % page_size != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, q, k, v, k_scale, v_scale, positions, out, ws, tickets, S, H,
             D, n_col, sm_scale);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.page_size = page_size;
  p.t_sb = t_sb;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.ks_sb = ks_sp; p.ks_ss = ks_ss; p.ks_sh = ks_sh;
  p.vs_sb = vs_sp; p.vs_ss = vs_ss; p.vs_sh = vs_sh;
  p.o_sb = o_sb; p.o_sh = o_sh;
  set_walk(p, kv_dtype);
  return static_cast<int>(launch_q<true>(
      p, B, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

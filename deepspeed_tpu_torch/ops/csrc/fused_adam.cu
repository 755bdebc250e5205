// One-pass fused Adam / AdamW over every param leaf in ONE launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_adam_kernel` of
// deepspeed_tpu/ops/pallas/fused_adam.py (:30, pallas_call :76), which
// runs one grid per leaf. Same function per element, in the same order
// (:32-44): L2 decay folded into the gradient (ADAM_MODE_1) or decoupled
// (ADAM_MODE_0, AdamW); p, m and v updated in place. Hyperparameters
// come from an f32[8] device vector (lr, beta1, beta2, eps,
// weight_decay, bias_correction1, bias_correction2, skip), so one
// launch serves every step of an lr schedule with no host sync; a
// nonzero `skip` (the fp16 overflow verdict) leaves every leaf as it
// was.
//
// What bounds it on the card: bytes. Per element it reads p, g, m, v
// and writes p, m, v (28 bytes) for ~15 flops, far below the ridge
// point, so the design is the reference's multi_tensor_adam.cu shape: a
// device table of (leaf, start) chunks covers all leaves, each CTA
// streams one chunk with 16-byte vector loads where the pointers allow,
// and the whole update is a single pass over the state with one launch
// per optimizer step (not one per leaf).
//
// The arithmetic uses explicitly rounded operations (no fused
// multiply-add), so it matches the plain PyTorch version bit for bit.
//
// Interface: a plain C function (ctypes), launched on the caller's
// stream; it returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2, one_minus_b1, one_minus_b2;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, const Hyper& hp,
                                          bool adam_w) {
  if (!adam_w) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  const float mn = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.one_minus_b1, g));
  const float vn = __fadd_rn(__fmul_rn(hp.b2, v),
                             __fmul_rn(__fmul_rn(hp.one_minus_b2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(mn, hp.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, hp.bc2)), hp.eps));
  if (adam_w) upd = __fadd_rn(upd, __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, upd));
  m = mn;
  v = vn;
}

// leaves: [n_leaves][5] = p, g, m, v pointers and numel;
// chunks: [n_chunks][2] = leaf index, first element
__global__ void __launch_bounds__(kThreads)
adam_kernel(const int64_t* __restrict__ leaves,
            const int64_t* __restrict__ chunks,
            const float* __restrict__ hyper, int64_t chunk_size,
            int adam_w) {
  if (hyper[7] != 0.0f) return;                // overflow: skip the step
  Hyper hp;
  hp.lr = hyper[0];
  hp.b1 = hyper[1];
  hp.b2 = hyper[2];
  hp.eps = hyper[3];
  hp.wd = hyper[4];
  hp.bc1 = hyper[5];
  hp.bc2 = hyper[6];
  hp.one_minus_b1 = __fsub_rn(1.0f, hp.b1);
  hp.one_minus_b2 = __fsub_rn(1.0f, hp.b2);
  const int64_t leaf = chunks[2 * blockIdx.x];
  const int64_t start = chunks[2 * blockIdx.x + 1];
  const int64_t* L = leaves + 5 * leaf;
  float* p = reinterpret_cast<float*>(L[0]);
  const float* g = reinterpret_cast<const float*>(L[1]);
  float* m = reinterpret_cast<float*>(L[2]);
  float* v = reinterpret_cast<float*>(L[3]);
  const int64_t end = min(start + chunk_size, L[4]);
  const bool aligned =
      ((L[0] | L[1] | L[2] | L[3]) & 15) == 0 && (start & 3) == 0;
  int64_t i = start;
  if (aligned) {
    const int64_t n4 = (end - start) >> 2;
    float4* p4 = reinterpret_cast<float4*>(p + start);
    const float4* g4 = reinterpret_cast<const float4*>(g + start);
    float4* m4 = reinterpret_cast<float4*>(m + start);
    float4* v4 = reinterpret_cast<float4*>(v + start);
    for (int64_t j = threadIdx.x; j < n4; j += kThreads) {
      float4 pp = p4[j], gg = g4[j], mm = m4[j], vv = v4[j];
      adam_elem(pp.x, gg.x, mm.x, vv.x, hp, adam_w);
      adam_elem(pp.y, gg.y, mm.y, vv.y, hp, adam_w);
      adam_elem(pp.z, gg.z, mm.z, vv.z, hp, adam_w);
      adam_elem(pp.w, gg.w, mm.w, vv.w, hp, adam_w);
      p4[j] = pp;
      m4[j] = mm;
      v4[j] = vv;
    }
    i = start + (n4 << 2);
  }
  for (int64_t j = i + threadIdx.x; j < end; j += kThreads) {
    float pp = p[j], mm = m[j], vv = v[j];
    adam_elem(pp, g[j], mm, vv, hp, adam_w);
    p[j] = pp;
    m[j] = mm;
    v[j] = vv;
  }
}

}  // namespace

extern "C" int fused_adam_launch(const void* leaves, const void* chunks,
                                 const void* hyper, int64_t n_chunks,
                                 int64_t chunk_size, int adam_w,
                                 void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffff || chunk_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adam_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(leaves),
      static_cast<const int64_t*>(chunks),
      static_cast<const float*>(hyper), chunk_size, adam_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

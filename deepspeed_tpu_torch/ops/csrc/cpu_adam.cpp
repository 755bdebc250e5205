// CPU Adam/AdamW — the host-offload optimizer for ZeRO-Offload.
//
// TPU-native equivalent of the reference's csrc/adam/cpu_adam.cpp
// (Adam_Optimizer::Step/Step_4/Step_8 with AVX512/AVX256 + OpenMP): fp32
// master weights and moments live in host RAM; one tiled, vectorized update
// per optimizer step; the fused fp32→bf16 conversion feeds the device
// upload (the analog of the reference's overlapped fp16 copy-back).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct AdamConfig {
  float lr;
  float beta1;
  float beta2;
  float eps;
  float weight_decay;
  bool adamw_mode;       // true: decoupled decay; false: decay into grad
  bool bias_correction;
};

std::map<int, AdamConfig> g_optimizers;
std::mutex g_mutex;

inline void adam_scalar(float* p, const float* g, float* m, float* v,
                        int64_t lo, int64_t hi, const AdamConfig& c,
                        float step_size, float bc2_sqrt) {
  const float b1 = c.beta1, b2 = c.beta2, eps = c.eps, wd = c.weight_decay;
  const bool adamw = c.adamw_mode;
  // Decoupled (AdamW) decay uses the raw lr, not the bias-corrected step
  // size — matches ops/adam/fused_adam.py adam_update.
  const float lr_wd = adamw ? c.lr * wd : 0.f;
  for (int64_t i = lo; i < hi; ++i) {
    float grad = g[i];
    if (!adamw && wd != 0.f) grad += wd * p[i];
    float mi = b1 * m[i] + (1.f - b1) * grad;
    float vi = b2 * v[i] + (1.f - b2) * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float denom = std::sqrt(vi) / bc2_sqrt + eps;
    p[i] -= step_size * (mi / denom) + lr_wd * p[i];
  }
}

#if defined(__AVX512F__)
constexpr int64_t kSimdWidth = 16;
inline void adam_simd(float* p, const float* g, float* m, float* v,
                      int64_t lo, int64_t hi, const AdamConfig& c,
                      float step_size, float bc2_sqrt) {
  const __m512 b1 = _mm512_set1_ps(c.beta1);
  const __m512 b1m = _mm512_set1_ps(1.f - c.beta1);
  const __m512 b2 = _mm512_set1_ps(c.beta2);
  const __m512 b2m = _mm512_set1_ps(1.f - c.beta2);
  const __m512 eps = _mm512_set1_ps(c.eps);
  const __m512 wd = _mm512_set1_ps(c.weight_decay);
  const __m512 step = _mm512_set1_ps(step_size);
  const __m512 bc2 = _mm512_set1_ps(1.f / bc2_sqrt);
  const bool adamw = c.adamw_mode;
  const bool has_wd = c.weight_decay != 0.f;
  const __m512 lr_wd =
      _mm512_set1_ps(adamw && has_wd ? c.lr * c.weight_decay : 0.f);
  int64_t i = lo;
  for (; i + kSimdWidth <= hi; i += kSimdWidth) {
    __m512 pi = _mm512_loadu_ps(p + i);
    __m512 gi = _mm512_loadu_ps(g + i);
    if (!adamw && has_wd) gi = _mm512_fmadd_ps(wd, pi, gi);
    __m512 mi = _mm512_fmadd_ps(b1, _mm512_loadu_ps(m + i),
                                _mm512_mul_ps(b1m, gi));
    __m512 vi = _mm512_fmadd_ps(b2, _mm512_loadu_ps(v + i),
                                _mm512_mul_ps(b2m, _mm512_mul_ps(gi, gi)));
    _mm512_storeu_ps(m + i, mi);
    _mm512_storeu_ps(v + i, vi);
    __m512 denom = _mm512_add_ps(_mm512_mul_ps(_mm512_sqrt_ps(vi), bc2), eps);
    __m512 upd = _mm512_div_ps(mi, denom);
    __m512 out = _mm512_fnmadd_ps(step, upd, pi);
    _mm512_storeu_ps(p + i, _mm512_fnmadd_ps(lr_wd, pi, out));
  }
  adam_scalar(p, g, m, v, i, hi, c, step_size, bc2_sqrt);
}
#elif defined(__AVX2__)
constexpr int64_t kSimdWidth = 8;
inline void adam_simd(float* p, const float* g, float* m, float* v,
                      int64_t lo, int64_t hi, const AdamConfig& c,
                      float step_size, float bc2_sqrt) {
  const __m256 b1 = _mm256_set1_ps(c.beta1);
  const __m256 b1m = _mm256_set1_ps(1.f - c.beta1);
  const __m256 b2 = _mm256_set1_ps(c.beta2);
  const __m256 b2m = _mm256_set1_ps(1.f - c.beta2);
  const __m256 eps = _mm256_set1_ps(c.eps);
  const __m256 wd = _mm256_set1_ps(c.weight_decay);
  const __m256 step = _mm256_set1_ps(step_size);
  const __m256 bc2 = _mm256_set1_ps(1.f / bc2_sqrt);
  const bool adamw = c.adamw_mode;
  const bool has_wd = c.weight_decay != 0.f;
  const __m256 lr_wd =
      _mm256_set1_ps(adamw && has_wd ? c.lr * c.weight_decay : 0.f);
  int64_t i = lo;
  for (; i + kSimdWidth <= hi; i += kSimdWidth) {
    __m256 pi = _mm256_loadu_ps(p + i);
    __m256 gi = _mm256_loadu_ps(g + i);
    if (!adamw && has_wd) gi = _mm256_fmadd_ps(wd, pi, gi);
    __m256 mi = _mm256_fmadd_ps(b1, _mm256_loadu_ps(m + i),
                                _mm256_mul_ps(b1m, gi));
    __m256 vi = _mm256_fmadd_ps(b2, _mm256_loadu_ps(v + i),
                                _mm256_mul_ps(b2m, _mm256_mul_ps(gi, gi)));
    _mm256_storeu_ps(m + i, mi);
    _mm256_storeu_ps(v + i, vi);
    __m256 denom = _mm256_add_ps(_mm256_mul_ps(_mm256_sqrt_ps(vi), bc2), eps);
    __m256 upd = _mm256_div_ps(mi, denom);
    __m256 out = _mm256_fnmadd_ps(step, upd, pi);
    _mm256_storeu_ps(p + i, _mm256_fnmadd_ps(lr_wd, pi, out));
  }
  adam_scalar(p, g, m, v, i, hi, c, step_size, bc2_sqrt);
}
#else
inline void adam_simd(float* p, const float* g, float* m, float* v,
                      int64_t lo, int64_t hi, const AdamConfig& c,
                      float step_size, float bc2_sqrt) {
  adam_scalar(p, g, m, v, lo, hi, c, step_size, bc2_sqrt);
}
#endif

}  // namespace

extern "C" {

int ds_create_adam(int id, float lr, float beta1, float beta2, float eps,
                   float weight_decay, int adamw_mode, int bias_correction) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_optimizers[id] = AdamConfig{lr,  beta1, beta2, eps, weight_decay,
                                adamw_mode != 0, bias_correction != 0};
  return 0;
}

int ds_destroy_adam(int id) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_optimizers.erase(id);
  return 0;
}

// One Adam step over a flat buffer. `step` is the 1-based applied-step
// count; `lr`/`beta1` override the stored values when >= 0 (lr and
// momentum schedules).
int ds_adam_step(int id, int64_t step, float lr, float beta1, float* params,
                 const float* grads, float* exp_avg, float* exp_avg_sq,
                 int64_t n) {
  AdamConfig c;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    auto it = g_optimizers.find(id);
    if (it == g_optimizers.end()) return -1;
    c = it->second;
  }
  if (lr >= 0.f) c.lr = lr;
  if (beta1 >= 0.f) c.beta1 = beta1;
  float bc1 = 1.f, bc2_sqrt = 1.f;
  if (c.bias_correction) {
    bc1 = 1.f - std::pow(c.beta1, static_cast<float>(step));
    bc2_sqrt = std::sqrt(1.f - std::pow(c.beta2, static_cast<float>(step)));
  }
  const float step_size = c.lr / bc1;

  constexpr int64_t kTile = 1 << 16;
  const int64_t tiles = (n + kTile - 1) / kTile;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t lo = t * kTile;
    const int64_t hi = lo + kTile < n ? lo + kTile : n;
    adam_simd(params, grads, exp_avg, exp_avg_sq, lo, hi, c, step_size,
              bc2_sqrt);
  }
  return 0;
}

// Fused fp32 → bf16 conversion (round-to-nearest-even) for the device
// upload of updated params — the analog of the reference's fused fp16
// param copy-back (cpu_adam.cpp param_update kernel).
void ds_fp32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], sizeof(bits));
    if ((bits & 0x7fffffffu) > 0x7f800000u) {
      // NaN: rounding carry would overflow the exponent (NaN -> Inf/-0);
      // keep a quiet NaN with the sign preserved.
      dst[i] = static_cast<uint16_t>((bits >> 16) | 0x0040u);
      continue;
    }
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;  // round to nearest even
    dst[i] = static_cast<uint16_t>(bits >> 16);
  }
}

int ds_simd_width() {
#if defined(__AVX512F__)
  return 16;
#elif defined(__AVX2__)
  return 8;
#else
  return 1;
#endif
}

}  // extern "C"

// Host Adam for ZeRO-Offload: the optimizer step over fp32 master weights
// and moments in host memory, while the GPU holds only the compute-dtype
// parameters, and the host halves of the gradient and weight streams.
//
// The port's copy of the JAX package's csrc/adam/cpu_adam.cpp, with the
// same C ABI and the same arithmetic: ``ds_adam_step`` is that file's,
// line for line, so that both builds (same compiler flags) give the same
// bits. SIMD width is picked at compile time: AVX-512 (16 wide), AVX2 + FMA
// (8 wide) or scalar; OpenMP splits every loop over the host's threads.
//
// What differs from the JAX package's copy:
//   - ``ds_fp32_to_bf16`` / ``ds_fp32_to_fp16`` round to nearest even as
//     PyTorch's ``Tensor.to`` does, subnormals included (the fp16 scalar
//     path of the JAX copy flushes them), so the card's parameters are the
//     rounded master bit for bit;
//   - ``ds_accum_add_*`` add one micro step's gradients (bf16, fp16 or
//     fp32) into the fp32 host accumulator: widening is exact, then one
//     fp32 add, as the JAX engine's ``buf += np.asarray(g, float32)``;
//   - ``ds_sumsq_f64``: the float64 sum of squares of a region, the step's
//     global-norm term and its finite check in one pass;
//   - ``ds_set_num_threads`` / ``ds_get_num_threads``: the OpenMP pool.

#include <cmath>
#include <cstdint>
#include <cstddef>
#include <omp.h>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

extern "C" {

// Scalar tail / fallback kernel.
static void adam_scalar(float* p, const float* g, float* m, float* v,
                        std::size_t begin, std::size_t end, float lr,
                        float beta1, float beta2, float eps, float wd,
                        int adamw, float bc1, float bc2, float inv_scale) {
    for (std::size_t i = begin; i < end; ++i) {
        float grad = g[i] * inv_scale;
        if (!adamw && wd > 0.f) grad += wd * p[i];
        float m_new = beta1 * m[i] + (1.f - beta1) * grad;
        float v_new = beta2 * v[i] + (1.f - beta2) * grad * grad;
        float update = (m_new / bc1) / (std::sqrt(v_new / bc2) + eps);
        if (adamw && wd > 0.f) update += wd * p[i];
        p[i] -= lr * update;
        m[i] = m_new;
        v[i] = v_new;
    }
}

// One Adam step over n contiguous fp32 elements, in place.
//   step: 1-based optimizer step (for bias correction)
//   grad_scale: grads are divided by this (fused fp16 unscale)
void ds_adam_step(float* params, const float* grads, float* exp_avg,
                  float* exp_avg_sq, std::int64_t n, float lr, float beta1,
                  float beta2, float eps, float weight_decay, int adamw,
                  int bias_correction, std::int64_t step, float grad_scale) {
    const float bc1 = bias_correction ? 1.f - std::pow(beta1, (float)step) : 1.f;
    const float bc2 = bias_correction ? 1.f - std::pow(beta2, (float)step) : 1.f;
    const float inv_scale = 1.f / grad_scale;

#if defined(__AVX512F__)
    constexpr std::int64_t W = 16;
#elif defined(__AVX2__)
    constexpr std::int64_t W = 8;
#else
    constexpr std::int64_t W = 1;
#endif
    const std::int64_t vec_end = n - (n % W);

#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < vec_end; i += W) {
#if defined(__AVX512F__)
        __m512 g = _mm512_mul_ps(_mm512_loadu_ps(grads + i),
                                 _mm512_set1_ps(inv_scale));
        __m512 p = _mm512_loadu_ps(params + i);
        if (!adamw && weight_decay > 0.f)
            g = _mm512_fmadd_ps(_mm512_set1_ps(weight_decay), p, g);
        __m512 m = _mm512_loadu_ps(exp_avg + i);
        __m512 v = _mm512_loadu_ps(exp_avg_sq + i);
        m = _mm512_fmadd_ps(_mm512_set1_ps(beta1), m,
                            _mm512_mul_ps(_mm512_set1_ps(1.f - beta1), g));
        v = _mm512_fmadd_ps(_mm512_set1_ps(beta2), v,
                            _mm512_mul_ps(_mm512_set1_ps(1.f - beta2),
                                          _mm512_mul_ps(g, g)));
        __m512 denom = _mm512_add_ps(
            _mm512_sqrt_ps(_mm512_div_ps(v, _mm512_set1_ps(bc2))),
            _mm512_set1_ps(eps));
        __m512 upd = _mm512_div_ps(_mm512_div_ps(m, _mm512_set1_ps(bc1)),
                                   denom);
        if (adamw && weight_decay > 0.f)
            upd = _mm512_fmadd_ps(_mm512_set1_ps(weight_decay), p, upd);
        p = _mm512_fnmadd_ps(_mm512_set1_ps(lr), upd, p);
        _mm512_storeu_ps(params + i, p);
        _mm512_storeu_ps(exp_avg + i, m);
        _mm512_storeu_ps(exp_avg_sq + i, v);
#elif defined(__AVX2__)
        __m256 g = _mm256_mul_ps(_mm256_loadu_ps(grads + i),
                                 _mm256_set1_ps(inv_scale));
        __m256 p = _mm256_loadu_ps(params + i);
        if (!adamw && weight_decay > 0.f)
            g = _mm256_fmadd_ps(_mm256_set1_ps(weight_decay), p, g);
        __m256 m = _mm256_loadu_ps(exp_avg + i);
        __m256 v = _mm256_loadu_ps(exp_avg_sq + i);
        m = _mm256_fmadd_ps(_mm256_set1_ps(beta1), m,
                            _mm256_mul_ps(_mm256_set1_ps(1.f - beta1), g));
        v = _mm256_fmadd_ps(_mm256_set1_ps(beta2), v,
                            _mm256_mul_ps(_mm256_set1_ps(1.f - beta2),
                                          _mm256_mul_ps(g, g)));
        __m256 denom = _mm256_add_ps(
            _mm256_sqrt_ps(_mm256_div_ps(v, _mm256_set1_ps(bc2))),
            _mm256_set1_ps(eps));
        __m256 upd = _mm256_div_ps(_mm256_div_ps(m, _mm256_set1_ps(bc1)),
                                   denom);
        if (adamw && weight_decay > 0.f)
            upd = _mm256_fmadd_ps(_mm256_set1_ps(weight_decay), p, upd);
        p = _mm256_fnmadd_ps(_mm256_set1_ps(lr), upd, p);
        _mm256_storeu_ps(params + i, p);
        _mm256_storeu_ps(exp_avg + i, m);
        _mm256_storeu_ps(exp_avg_sq + i, v);
#else
        adam_scalar(params, grads, exp_avg, exp_avg_sq, i, i + W, lr, beta1,
                    beta2, eps, weight_decay, adamw, bc1, bc2, inv_scale);
#endif
    }
    adam_scalar(params, grads, exp_avg, exp_avg_sq, vec_end, n, lr, beta1,
                beta2, eps, weight_decay, adamw, bc1, bc2, inv_scale);
}

static inline std::uint32_t f32_bits(float x) {
    std::uint32_t b;
    __builtin_memcpy(&b, &x, 4);
    return b;
}

static inline float bits_f32(std::uint32_t b) {
    float x;
    __builtin_memcpy(&x, &b, 4);
    return x;
}

// fp32 -> bf16, round to nearest even (PyTorch's round_to_nearest_even:
// infinities carry through the add unchanged); a NaN becomes the quiet
// NaN 0x7fc0 with its sign.
void ds_fp32_to_bf16(const float* src, std::uint16_t* dst, std::int64_t n) {
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i) {
        std::uint32_t bits = f32_bits(src[i]);
        if ((bits & 0x7fffffffu) > 0x7f800000u) {
            dst[i] = (std::uint16_t)(((bits >> 16) & 0x8000u) | 0x7fc0u);
            continue;
        }
        bits += 0x7fffu + ((bits >> 16) & 1u);
        dst[i] = (std::uint16_t)(bits >> 16);
    }
}

// One fp32 -> fp16 conversion, round to nearest even in integer arithmetic
// (no floating-point step a compiler could contract), subnormals included;
// a NaN becomes 0x7e00 with its sign.
static inline std::uint16_t fp16_rne(std::uint32_t b) {
    const std::uint32_t sign = (b >> 16) & 0x8000u;
    const std::uint32_t a = b & 0x7fffffffu;
    if (a > 0x7f800000u) return (std::uint16_t)(sign | 0x7e00u);
    if (a >= 0x477ff000u)                 // >= 65520 (and inf): inf
        return (std::uint16_t)(sign | 0x7c00u);
    if (a >= 0x38800000u) {               // >= 2**-14: a normal fp16
        std::uint32_t r = a - 0x38000000u;  // exponent rebiased 127 -> 15
        r += 0x0fffu + ((r >> 13) & 1u);
        return (std::uint16_t)(sign | (r >> 13));
    }
    if (a < 0x33000000u)                  // < 2**-25: rounds to zero
        return (std::uint16_t)sign;
    // a subnormal fp16: the value in units of 2**-24 is m * 2**(e - 126)
    const std::uint32_t e = a >> 23;
    const std::uint32_t m = (a & 0x7fffffu) | 0x800000u;
    const std::uint32_t shift = 126u - e;   // 14 .. 24
    std::uint32_t q = m >> shift;
    const std::uint32_t rem = m & ((1u << shift) - 1u);
    const std::uint32_t half = 1u << (shift - 1u);
    if (rem > half || (rem == half && (q & 1u))) ++q;
    return (std::uint16_t)(sign | q);
}

void ds_fp32_to_fp16(const float* src, std::uint16_t* dst, std::int64_t n) {
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i)
        dst[i] = fp16_rne(f32_bits(src[i]));
}

// The exact fp16 value of h as fp32 (every fp16 is an fp32).
static inline float fp16_to_f32(std::uint16_t h) {
    const std::uint32_t sign = (std::uint32_t)(h & 0x8000u) << 16;
    const std::uint32_t e = (h >> 10) & 0x1fu;
    const std::uint32_t m = h & 0x3ffu;
    if (e == 0x1fu) return bits_f32(sign | 0x7f800000u | (m << 13));
    if (e != 0) return bits_f32(sign | ((e + 112u) << 23) | (m << 13));
    // zero or subnormal: m * 2**-24, exact in fp32
    const float x = (float)m * 5.9604644775390625e-8f;
    return sign ? -x : x;
}

// acc[i] += widen(src[i]): one micro step's gradients into the fp32 host
// accumulator.
void ds_accum_add_bf16(float* acc, const std::uint16_t* src, std::int64_t n) {
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i)
        acc[i] += bits_f32((std::uint32_t)src[i] << 16);
}

void ds_accum_add_fp16(float* acc, const std::uint16_t* src, std::int64_t n) {
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i)
        acc[i] += fp16_to_f32(src[i]);
}

void ds_accum_add_f32(float* acc, const float* src, std::int64_t n) {
#pragma omp parallel for schedule(static)
    for (std::int64_t i = 0; i < n; ++i)
        acc[i] += src[i];
}

// The float64 sum of x[i]**2. It is finite exactly when every x[i] is:
// the square of the largest fp32 is about 1.2e77, so no finite input can
// overflow the sum. The order of the sum follows the thread count.
double ds_sumsq_f64(const float* x, std::int64_t n) {
    double total = 0.0;
#pragma omp parallel for schedule(static) reduction(+:total)
    for (std::int64_t i = 0; i < n; ++i) {
        const double d = (double)x[i];
        total += d * d;
    }
    return total;
}

void ds_set_num_threads(int n) { omp_set_num_threads(n); }

int ds_get_num_threads(void) { return omp_get_max_threads(); }

int ds_simd_width(void) {
#if defined(__AVX512F__)
    return 16;
#elif defined(__AVX2__)
    return 8;
#else
    return 1;
#endif
}

}  // extern "C"

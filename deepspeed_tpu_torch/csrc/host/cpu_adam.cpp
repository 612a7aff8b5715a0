// Host SIMD Adam — the ZeRO-Offload optimizer kernel (the port's copy of
// csrc/adam/cpu_adam.cpp, with an explicit OpenMP thread count on every
// entry point).
//
// Role of the reference's csrc/adam/cpu_adam.cpp (AVX256/AVX512 paths in
// csrc/includes/cpu_adam.h:28-139, OpenMP-parallel): run the fp32
// optimizer update on host-resident shards so device memory holds only
// bf16 params + activations.  Here the SIMD comes from -O3 -march=native
// auto-vectorization over flat contiguous arrays (the loop below compiles
// to packed FMA on AVX2/AVX-512 hosts) with OpenMP across cores; the
// C ABI is consumed by ctypes from deepspeed_tpu_torch/ops/adam/cpu_adam.py.
//
// num_threads: the OpenMP team of each call.  The caller passes it, so a
// process that also runs torch's own OpenMP runtime (or several test
// workers on one host) never gets a team of every core by default.  Each
// element is computed alone, so the result does not depend on it.
#include <cmath>
#include <cstdint>

extern "C" {

// Flat fused Adam/AdamW step over contiguous fp32 buffers.
//   params/grads/exp_avg/exp_avg_sq: length n
//   step: 1-based step count (bias correction)
//   adamw: 1 = decoupled weight decay (AdamW), 0 = L2-style (classic)
void ds_cpu_adam_step(float* params, const float* grads, float* exp_avg,
                      float* exp_avg_sq, int64_t n, float lr, float beta1,
                      float beta2, float eps, float weight_decay, int64_t step,
                      int adamw, int num_threads) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);
    const float b1 = beta1, b2 = beta2;
    const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;
    const float decay = weight_decay;

#pragma omp parallel for schedule(static) num_threads(num_threads)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        float p = params[i];
        if (!adamw && decay > 0.0f) g += decay * p;  // classic L2
        float m = b1 * exp_avg[i] + omb1 * g;
        float v = b2 * exp_avg_sq[i] + omb2 * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        float denom = std::sqrt(v) * inv_sqrt_bc2 + eps;
        float update = step_size * (m / denom);  // lr/bc1 folds bias corr.
        if (adamw && decay > 0.0f) update += lr * decay * p;  // decoupled, plain lr
        params[i] = p - update;
    }
}

// Fused momentum-SGD for completeness (host path for the SGD optimizer).
void ds_cpu_sgd_step(float* params, const float* grads, float* momentum_buf,
                     int64_t n, float lr, float momentum, float weight_decay,
                     int num_threads) {
#pragma omp parallel for schedule(static) num_threads(num_threads)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i] + weight_decay * params[i];
        if (momentum > 0.0f) {
            float m = momentum * momentum_buf[i] + g;
            momentum_buf[i] = m;
            g = m;
        }
        params[i] -= lr * g;
    }
}

// Cast fp32 host buffer -> bf16 (round-to-nearest-even) for the
// device-bound copy after the host step (the reference overlaps an H2D
// fp16 copy-back, cpu_adam.cpp param_copy path).
void ds_fp32_to_bf16(const float* src, uint16_t* dst, int64_t n, int num_threads) {
#pragma omp parallel for schedule(static) num_threads(num_threads)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        __builtin_memcpy(&bits, &src[i], 4);
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

}  // extern "C"

// Device functions shared by the flash-attention kernels: flash_fwd.cu (B1),
// flash_bwd.cu (B2) and flash_bwd_2pass.cu (B6a, B6b).  One copy of the
// score tile, the two bias forms and the dropout keep factor, so the
// forward and the two backwards cannot drift apart.
//
// The extended options (``Ext``) are chosen at run time and are uniform
// over a block:
//   * a key-row bias ``kbias`` (B, Tk) f32 (BERT's key-padding mask), or a
//     full bias ``fbias`` read through its four element strides (b, h, row,
//     key), stride 0 on a broadcast dim, so a (B, 1, Tq, Tk) mask is never
//     expanded to (B*H, Tq, Tk) in device memory;
//   * attention-probability dropout with in-kernel Threefry-2x32 bits
//     (deepspeed_tpu/ops/attention/flash_attention.py::_threefry2x32_bits,
//     _drop_keep_tile): key (k0, k1), counter (row * sk + col, b * H + h)
//     in uint32 wrap arithmetic, both absolute positions, so every tiling
//     regenerates the same bits; keep iff bits < threshold, and a kept
//     score is scaled by inv_keep = 1 / keep_prob (f32), a dropped one by 0.
// The bias is added in f32 after the scale, each step rounded on its own:
// s = (q.k) * scale + bias.  Dropout touches only the value path (the
// forward's m, l and lse come from the full p) and, in the backward, dV's
// p and dp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per tile row
constexpr int kPP = kBK + 1;   // row stride of a (kBQ x kBK) float tile in shared memory

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

struct Ext {
  const float* kbias;  // (BH / H, sk) or null
  const float* fbias;  // through the strides below, or null
  long long fb_b, fb_h, fb_q, fb_k;
  int H;
  int dropout;
  uint32_t k0, k1, threshold;
  float inv_keep;
};

// shared-memory floats the staged bias takes: the key row always (a few
// floats), the full (kBQ x kBK) tile only when there is a full bias
__host__ __device__ inline int bias_smem_floats(const Ext& e) {
  return kBK + (e.fbias != nullptr ? kBQ * kPP : 0);
}

// first output word of 20-round Threefry-2x32 (the Random123 / jax.random
// schedule) on counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ uint32_t threefry2x32_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                      uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0;
}

// the dropout factor of score (gq, gk) of batch*head bh: inv_keep if kept, else 0
__device__ __forceinline__ float keep_factor(const Ext& e, uint32_t bh, int gq, int gk, int sk) {
  const uint32_t x0 = static_cast<uint32_t>(gq) * static_cast<uint32_t>(sk) + static_cast<uint32_t>(gk);
  return threefry2x32_bits(e.k0, e.k1, x0, bh) < e.threshold ? e.inv_keep : 0.f;
}

// stage the bias of query rows [q0, q0 + kBQ) x keys [k0, k0 + kBK) of
// batch*head bh: the key-row form into Bk[kk], the full form into
// Bt[rr * kPP + kk] (consecutive threads read consecutive keys); 0 off the
// ragged edge.  The caller synchronizes before reading.
__device__ __forceinline__ void stage_bias(const Ext& e, float* Bk, float* Bt, size_t bh, int q0,
                                           int k0, int sq, int sk, int tid) {
  if (e.kbias != nullptr) {
    if (tid < kBK) Bk[tid] = k0 + tid < sk ? e.kbias[(bh / e.H) * sk + k0 + tid] : 0.f;
  } else if (e.fbias != nullptr) {
    const float* base = e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                        static_cast<long long>(bh % e.H) * e.fb_h;
    for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
      const int rr = idx / kBK, kk = idx % kBK;
      const int gq = q0 + rr, gk = k0 + kk;
      Bt[rr * kPP + kk] = gq < sq && gk < sk ? base[gq * e.fb_q + gk * e.fb_k] : 0.f;
    }
  }
}

// the scaled score plus the staged bias of tile row rr, key kk
__device__ __forceinline__ float biased_score(const Ext& e, float dot, float scale, const float* Bk,
                                              const float* Bt, int rr, int kk) {
  const float s = __fmul_rn(dot, scale);
  if (e.kbias != nullptr) return __fadd_rn(s, Bk[kk]);
  if (e.fbias != nullptr) return __fadd_rn(s, Bt[rr * kPP + kk]);
  return s;
}

// The backward's score tile, for every backward kernel: the thread owning
// row r (quarter c) of the staged Q / dO tile computes, for keys c + 4i of
// the staged K / V tile,
//   p  = exp(s - lse)          (s biased as above; 0 where masked)
//   pd = p * keep              (dV's probability, rounded to dO's type) -> Ps
//   ds = p * (dp * keep - delta) * scale (rounded to q's type)          -> dSs
// with keep the dropout factor (1 without dropout).  Without EXT this is
// the bias-free code of the first backward kernel, unchanged; WANT_P =
// false (the dq pass) skips Ps.  T is the operands' type.
template <typename T, int D, bool EXT, bool WANT_P>
__device__ __forceinline__ void score_tile_bwd(const float* Qs, const float* dOs, const float* Ks,
                                               const float* Vs, const float* lse_s,
                                               const float* delta_s, const float* Bk,
                                               const float* Bt, float* Ps, float* dSs,
                                               const Ext& e, uint32_t bh, int q0, int k0, int sq,
                                               int sk, int causal, float sm_scale, int r, int c) {
  constexpr int DP = D + 1;
  const int gq = q0 + r;
  const int qpos = (sk - sq) + gq;  // end-aligned causal position
  const float row_lse = lse_s[r];
  const float row_delta = delta_s[r];
#pragma unroll 4
  for (int i = 0; i < kBK / 4; ++i) {
    const int kk = c + 4 * i;
    const int gk = k0 + kk;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int e2 = 0; e2 < D; ++e2) {
      s += Qs[r * DP + e2] * Ks[kk * DP + e2];
      dp += dOs[r * DP + e2] * Vs[kk * DP + e2];
    }
    const bool ok = gq < sq && gk < sk && (!causal || qpos >= gk);
    // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
    // exp(mask - lse) is 0 for every finite lse
    float p;
    if (EXT) {
      p = !ok ? 0.f : expf(biased_score(e, s, sm_scale, Bk, Bt, r, kk) - row_lse);
    } else {
      p = !ok ? 0.f : expf(s * sm_scale - row_lse);
    }
    float pd = p;
    if (EXT && e.dropout) {
      const float kf = keep_factor(e, bh, gq, gk, sk);
      pd = __fmul_rn(p, kf);
      dp = __fmul_rn(dp, kf);
    }
    if (WANT_P) Ps[r * kPP + kk] = round_to<T>(pd);
    dSs[r * kPP + kk] = round_to<T>(p * (dp - row_delta) * sm_scale);
  }
}

}  // namespace flash

// Flash-attention forward for Hopper (sm_90a), the f32 body: online-softmax
// attention over (B*H, T, d), end-aligned causal or full, with an optional
// log-sum-exp output, an optional additive score bias (the key-row form
// (B, Tk) or the full form through its strides) and optional
// attention-probability dropout with in-kernel Threefry bits.  bf16
// tensors take the tensor-core body, flash_fwd_tc.cu, with the same
// contract; this one serves f32, whose 2e-5 parity bound TF32's 10-bit
// mantissa cannot meet, so its dots stay on the CUDA cores.
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::_flash_fwd_kernel
// (Pallas, TPU), driven there by _flash_fwd_pallas and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_fwd_cuda.
// Ported: the whole contract but the materialized uint8 keep-mask operand
// (``mask``, which no caller of the JAX package's public entry point
// passes): causal or full, no bias / ``kbias`` / ``fbias``, in-kernel
// dropout (``kdrop``).
//
// Rounding points kept from the Pallas kernel (for parity):
//   * the Q.K^T dot takes the operands in their own type and sums in f32;
//   * the softmax state (m, l) and the accumulator are f32;
//   * p is rounded to v's type before the P.V dot, while l sums the
//     unrounded p; with dropout, the rounded value is p * keep where keep
//     is 1 / keep_prob (f32) on a kept score and 0 on a dropped one, and l
//     still sums the full p;
//   * causal masking is end-aligned: query row i sits at position
//     (sk - sq) + i;
//   * a row whose l stays 0 divides by 1;
//   * a bias is added in f32 after the scale, before the causal mask:
//     s = (q.k) * scale + bias, each step rounded on its own.  A key
//     masked by a bias of -1e9 weighs exp(-1e9 - m) = 0 exactly once its
//     row has seen a real key.
//
// What bounds it: the causal forward does about T/4 flops per byte it
// must move (q, k, v read once, out written once), so at T 1024, d 64 the
// f32 floor is the CUDA-core rate (67 TFLOP/s).  This body does its dots
// from shared memory, one float read per multiply-add, so shared-memory
// reads bound it in practice, far above that floor (see PERF.md);
// dropout adds ~85 integer operations a score (Threefry's 20 rounds).
// What the design does: every score stays in registers and shared memory
// (no T x T matrix in device memory, no keep mask either: the bits are
// regenerated from the position), key tiles wholly above the causal
// diagonal are skipped, and a ragged last tile is masked in-kernel, so
// any T is served.
//
// Layout: one block of 256 threads per (64-query tile, batch*head).
// Four threads own one query row: each computes 16 of the 64 scores of a
// key tile and 1/4 of the row's output dims.  K/V tiles of 64 rows are
// staged in shared memory, with the tile's bias beside them (64 key-row
// values, or the 64 x 64 full tile).  EXT, a template flag, selects the
// kernel that reads the run-time options (bias form, dropout); without it
// the kernel is the bias-free code it was before those options existed.
// Row strides are padded by one float so the 8 rows a warp touches fall
// in different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::Ext;
using flash::kBK;
using flash::kBQ;
using flash::kPP;
using flash::kThreads;
using flash::narrow;
using flash::round_to;
using flash::widen;

// Q, K, V and P tiles; the extended kernel's bias follows (bias_smem_floats)
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D, bool EXT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, const Ext e, int sq, int sk,
                 int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kPP;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x DP
  float* Ks = Qs + kBQ * DP;    // kBK x DP
  float* Vs = Ks + kBK * DP;    // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x PP
  float* Bs = Ps + kBQ * PP;    // kBK, the tile's key-row bias (EXT only)
  float* Bt = Bs + kBK;         // kBQ x PP, the tile's full bias (EXT with fbias only)

  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row within the tile
  const int c = tid & 3;    // quarter of the row this thread owns
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, e2 = idx % D;
    const int gq = q0 + rr;
    Qs[rr * DP + e2] = gq < sq ? widen(qb[static_cast<size_t>(gq) * D + e2]) : 0.f;
  }

  const int offset = sk - sq;       // end-aligned causal offset
  const int qpos = offset + q0 + r;  // this row's key-space position
  // key tiles wholly above the diagonal of the tile's last row are skipped
  const int kv_end = causal ? min(sk, max(0, offset + q0 + kBQ)) : sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  float m = -INFINITY, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int kk = idx / D, e2 = idx % D;
      const int gk = k0 + kk;
      const bool in = gk < sk;  // ragged last tile: zero rows, masked below
      Ks[kk * DP + e2] = in ? widen(kb[static_cast<size_t>(gk) * D + e2]) : 0.f;
      Vs[kk * D + e2] = in ? widen(vb[static_cast<size_t>(gk) * D + e2]) : 0.f;
    }
    if (EXT) flash::stage_bias(e, Bs, Bt, bh, q0, k0, sq, sk, tid);
    __syncthreads();

    float s[kBK / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int kk = c + 4 * i;
      const int gk = k0 + kk;
      float dot = 0.f;
#pragma unroll
      for (int e2 = 0; e2 < D; ++e2) dot += Qs[r * DP + e2] * Ks[kk * DP + e2];
      const bool ok = gk < sk && (!causal || qpos >= gk);
      // a masked key weighs exp(mask - m) = 0 in the Pallas kernel once
      // the row has seen a real key, which end-aligned causal rows (sq <=
      // sk) always have in their first tile; so masked keys drop out here
      s[i] = !ok ? -INFINITY : EXT ? flash::biased_score(e, dot, sm_scale, Bs, Bt, r, kk)
                                   : dot * sm_scale;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const float p = s[i] == -INFINITY ? 0.f : expf(s[i] - m_new);
      lsum += p;  // the softmax statistics take the full p
      float pv = p;
      if (EXT && e.dropout)
        pv = __fmul_rn(p, flash::keep_factor(e, static_cast<uint32_t>(bh), q0 + r, k0 + c + 4 * i, sk));
      Ps[r * PP + c + 4 * i] = round_to<T>(pv);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // the row's four threads have written their p
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int e2 = c + 4 * i;
      float a = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < kBK; ++kk) a += Ps[r * PP + kk] * Vs[kk * D + e2];
      acc[i] = acc[i] * alpha + a;
    }
  }

  const int gq = q0 + r;
  if (gq < sq) {
    const float denom = l == 0.f ? 1.f : l;
    T* orow = out + (bh * sq + gq) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) orow[c + 4 * i] = narrow<T>(acc[i] / denom);
    if (lse != nullptr && c == 0)
      lse[bh * sq + gq] = l == 0.f ? INFINITY : m + logf(fmaxf(l, 1e-37f));
  }
}

template <typename T, int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
           int BH, int sq, int sk, int causal, float sm_scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>() + (EXT ? sizeof(float) * flash::bias_smem_floats(e) : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, EXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, D, EXT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), e, sq, sk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_ext(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
                 int BH, int sq, int sk, int causal, float sm_scale, cudaStream_t st) {
  if (e.kbias == nullptr && e.fbias == nullptr && !e.dropout)
    return launch<T, D, false>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
  return launch<T, D, true>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
               int BH, int sq, int sk, int d, int causal, float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16: return dispatch_ext<T, 16>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 32: return dispatch_ext<T, 32>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 64: return dispatch_ext<T, 64>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 128: return dispatch_ext<T, 128>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32 (q, k, v and out; bf16 is flash_fwd_tc.cu's).  lse (f32,
// (BH, sq)) may be null.  The extended options, each off when null / 0:
// kbias (f32, (BH / H, sk): one row of key biases per batch row, shared by
// its H heads), or fbias (f32, element (b, h, i, j) at b * fb_b + h * fb_h
// + i * fb_q + j * fb_k), not both; dropout with key (k0, k1), keep iff
// bits < threshold, a kept p scaled by inv_keep.  H is read only with a
// bias.  With none of them the kernel is the one without options.  Causal
// needs sq <= sk.  Returns a cudaError_t.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            const void* kbias, const void* fbias, long long fb_b, long long fb_h,
                            long long fb_q, long long fb_k, int dropout, unsigned k0, unsigned k1,
                            unsigned threshold, float inv_keep, int BH, int H, int sq, int sk,
                            int d, int dtype, int causal, float sm_scale, void* stream) {
  if (BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (kbias != nullptr && fbias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((kbias != nullptr || fbias != nullptr) && (H < 1 || BH % H != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Ext e{static_cast<const float*>(kbias), static_cast<const float*>(fbias), fb_b, fb_h, fb_q,
              fb_k, H < 1 ? 1 : H, dropout, k0, k1, threshold, inv_keep};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, lse, e, BH, sq, sk, d, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

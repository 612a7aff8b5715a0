// Flash decode for Hopper (sm_90a): single-query attention of every slot
// of the serving pool against its own KV cache.
//
// Replaces: deepspeed_tpu/ops/kernels/flash_decode.py::_flash_decode_kernel
// (Pallas, TPU), driven there by flash_decode() and here by
// deepspeed_tpu_torch/ops/kernels/flash_decode.py::flash_decode_cuda.
//
// Contract (the same as the Pallas kernel's):
//   q (B, H, 1, d) f32|bf16; K/V caches (B, H, S, d) in q's type, or int8
//   codes with (B, H, S, 1) f32 per-row scales; pos (B,) int32;
//   optional key-padding mask (B, S) uint8 (nonzero = attendable).
//   Key j of slot b is attendable iff j <= pos[b] (and kpm[b, j] != 0).
//   q, k and v are widened to f32 before the dots; for int8 the score is
//   multiplied by sm_scale and then by the key scale outside the dot, and
//   p is multiplied by the value scale before the PV dot.  Masked scores
//   are -1e30 (not -inf), so a row with no attendable key attends
//   uniformly over all S keys and stays finite, as in the JAX version.
//   Serving writes the step's K/V into the cache before it attends; the
//   kernel relies on that (key pos[b] is the token's own key).
//
// What bounds it: device-memory bytes.  Each step reads every attendable
// key and value row once (2 * (pos+1) * d * itemsize per slot and head)
// and does ~4 flops per byte, far below the H100's ~295 flops per byte.
//
// Design: one block per (slot, head), 16 warps.  Only keys j <= pos[b]
// are read, so an idle or short slot costs nothing beyond its prefix.
// Warp w takes keys w, w + 16, ...; it loads 4 keys' K and V rows before
// it reduces any of them, so each warp keeps several row loads in flight
// (the 96 blocks of the serving shape are fewer than the card's 132 SMs,
// so per-warp memory parallelism is what feeds the bandwidth).  Lanes
// split a row's d elements, so a row load is one coalesced access.  Each
// warp keeps its own online-softmax state (m, l, acc); the 16 states are
// merged through shared memory at the end.  Fixed sizes, no autotuning.
// On an H100 this design reaches ~7 % of the bytes bound at the serving
// shape (PERF.md): one 2-byte (bf16) or 1-byte (int8) load per lane per
// element, with half the lanes idle at d = 64, so load instructions and
// their latency, not bytes, bound it; 16-byte vector loads are the next
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;        // keys loaded per warp before reducing
constexpr int kMaxD = 128;
constexpr int kPerLane = kMaxD / 32;
constexpr float kMask = -1e30f;   // the JAX version's NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    const uint8_t* __restrict__ kpm, TQ* __restrict__ out,
                    int H, int S, int d, float sm_scale) {
  __shared__ float sh_m[kWarps];
  __shared__ float sh_l[kWarps];
  __shared__ float sh_acc[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int last = min(pos[b], S - 1);
  const size_t row0 = static_cast<size_t>(bh) * S;  // first cache row of (b, h)
  const uint8_t* mask_row = kpm ? kpm + static_cast<size_t>(b) * S : nullptr;

  // Does the row have any attendable key?  (block-uniform branch)
  int any = last >= 0;
  if (mask_row != nullptr && any) {
    int mine = 0;
    for (int j = threadIdx.x; j <= last; j += kThreads) mine |= mask_row[j] != 0;
    any = __syncthreads_or(mine);
  }
  // With none, every score is kMask and the softmax is uniform over S.
  const int n = any ? last + 1 : S;

  float qr[kPerLane], acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    qr[i] = e < d ? widen(q[static_cast<size_t>(bh) * d + e]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMask, l = 0.f;

  for (int j0 = warp; j0 < n; j0 += kWarps * kUnroll) {
    float kr[kUnroll][kPerLane], vr[kUnroll][kPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      const size_t off = (row0 + min(j, n - 1)) * d;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        kr[u][i] = (j < n && e < d) ? widen(k[off + e]) : 0.f;
        vr[u][i] = (j < n && e < d) ? widen(v[off + e]) : 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) part += qr[i] * kr[u][i];
      s[u] = warp_sum(part);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j < n) {
        float sj = s[u] * sm_scale;
        if (QUANT) sj *= ks[row0 + j];
        const bool allowed = any && (mask_row == nullptr || mask_row[j] != 0);
        s[u] = allowed ? sj : kMask;
        m_new = fmaxf(m_new, s[u]);
      }
    }
    const float alpha = expf(m - m_new);
    float p[kUnroll];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      p[u] = j < n ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
      if (QUANT && j < n) p[u] *= vs[row0 + j];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a += p[u] * vr[u][i];
      acc[i] = a;
    }
  }

  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < d) sh_acc[warp][e] = acc[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float big = kMask;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sh_m[w]);
    float tot_l = 0.f, tot_a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sh_m[w] - big);
      tot_l += c * sh_l[w];
      tot_a += c * sh_acc[w][e];
    }
    if (tot_l == 0.f) tot_l = 1.f;
    out[static_cast<size_t>(bh) * d + e] = narrow<TQ>(tot_a / tot_l);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* kpm, void* out, int B, int H, int S, int d,
           float sm_scale, cudaStream_t stream) {
  flash_decode_kernel<TQ, TKV, QUANT><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(kpm),
      static_cast<TQ*>(out), H, S, d, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then ks/vs are the f32 scales).  kpm may be null.  Returns a cudaError_t.
extern "C" int ds_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* pos,
                               const void* kpm, void* out, int B, int H, int S, int d,
                               int q_dtype, int kv_dtype, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d,
                                                       sm_scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d,
                                               sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

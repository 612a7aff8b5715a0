// Flash-attention forward for Hopper (sm_90a): online-softmax attention
// over (B*H, T, d), end-aligned causal or full, with an optional
// log-sum-exp output.
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::_flash_fwd_kernel
// (Pallas, TPU), driven there by _flash_fwd_pallas and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_fwd_cuda.
// This slice ports the variant the serving prefill runs: no bias, no
// dropout.  The lse output is there for the training slice.
//
// Rounding points kept from the Pallas kernel (for parity):
//   * the Q.K^T dot takes the operands in their own type (bf16 or f32)
//     and sums in f32 — operands are widened exactly to f32 in shared
//     memory, so each product is exact and the sum is f32;
//   * the softmax state (m, l) and the accumulator are f32;
//   * p is rounded to v's type before the P.V dot, while l sums the
//     unrounded p;
//   * causal masking is end-aligned: query row i sits at position
//     (sk - sq) + i;
//   * a row whose l stays 0 divides by 1.
//
// What bounds it: the causal forward does about T/4 flops per byte it
// must move (q, k, v read once, out written once), so at the prefill
// shapes (T <= 1024, d = 64) the card's floor is bytes, just below the
// bf16 tensor-core balance point (~295 flops/byte).  This first version
// does its dots on the CUDA cores in f32 (no wgmma, no TMA), so the
// CUDA-core rate and shared-memory reads bound it in practice, far above
// that floor (see PERF.md).  What the design does: every score stays in
// registers and shared memory (no T x T matrix in device memory), key
// tiles wholly above the causal diagonal are skipped, and a ragged last
// tile is masked in-kernel, so any T is served.  Making it fast (wgmma on
// 64-row tiles fed by TMA) is later work.
//
// Layout: one block of 256 threads per (64-query tile, batch*head).
// Four threads own one query row: each computes 16 of the 64 scores of a
// key tile and 1/4 of the row's output dims.  K/V tiles of 64 rows are
// staged in shared memory; row strides are padded by one float so the 8
// rows a warp touches fall in different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per query row

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to the value operand's type, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                 float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x DP
  float* Ks = Qs + kBQ * DP;    // kBK x DP
  float* Vs = Ks + kBK * DP;    // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x PP

  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row within the tile
  const int c = tid & 3;    // quarter of the row this thread owns
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, e = idx % D;
    const int gq = q0 + rr;
    Qs[rr * DP + e] = gq < sq ? widen(qb[static_cast<size_t>(gq) * D + e]) : 0.f;
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
      const int kk = idx / D, e = idx % D;
      const int gk = k0 + kk;
      const bool in = gk < sk;  // ragged last tile: zero rows, masked below
      Ks[kk * DP + e] = in ? widen(kb[static_cast<size_t>(gk) * D + e]) : 0.f;
      Vs[kk * D + e] = in ? widen(vb[static_cast<size_t>(gk) * D + e]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int kk = c + 4 * i;
      const int gk = k0 + kk;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) dot += Qs[r * DP + e] * Ks[kk * DP + e];
      const bool ok = gk < sk && (!causal || qpos >= gk);
      // a masked key weighs exp(mask - m) = 0 in the Pallas kernel once
      // the row has seen a real key, which end-aligned causal rows (sq <=
      // sk) always have in their first tile; so masked keys drop out here
      s[i] = ok ? dot * sm_scale : -INFINITY;
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
      lsum += p;
      Ps[r * PP + c + 4 * i] = round_to<T>(p);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = alpha * l + lsum;
    m = m_new;
    __syncwarp();  // the row's four threads have written their p
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int e = c + 4 * i;
      float a = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < kBK; ++kk) a += Ps[r * PP + kk] * Vs[kk * D + e];
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int sq,
           int sk, int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), sq, sk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int sq,
               int sk, int d, int causal, float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, BH, sq, sk, causal, sm_scale, st);
    case 32: return launch<T, 32>(q, k, v, out, lse, BH, sq, sk, causal, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, out, lse, BH, sq, sk, causal, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, out, lse, BH, sq, sk, causal, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it).  lse (f32,
// (BH, sq)) may be null.  Causal needs sq <= sk.  Returns a cudaError_t.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int BH, int sq, int sk, int d, int dtype, int causal,
                            float sm_scale, void* stream) {
  if (BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, lse, BH, sq, sk, d, causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, BH, sq, sk, d, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

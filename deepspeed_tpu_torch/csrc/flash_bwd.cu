// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// online-softmax attention over (B*H, T, d) in one pass, from the forward's
// log-sum-exp and delta = rowsum(dO * O).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_bwd_fused_kernel (Pallas, TPU), driven there by
// _flash_bwd_fused_pallas / _flash_bwd_fused_chunked and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_bwd_cuda.
// This slice ports the variant the GPT-2 training step runs: causal
// (end-aligned, as the forward) or full, no bias, no dropout.
//
// Rounding points kept from the Pallas kernel (for parity):
//   * the dots take their operands in their own type (bf16 or f32) and sum
//     in f32: operands are widened exactly to f32 in shared memory;
//   * p = exp(s * scale - lse) is computed once per score, in f32;
//   * p is rounded to dO's type before the dV product;
//   * ds = p * (dp - delta) * scale is rounded to q's type before the dK
//     and dQ products;
//   * dq is summed in f32 and cast to q's type by the wrapper.
//
// What bounds it: at the training shape (B 8, H 12, T 1024, d 64, causal)
// the work is ~5 T^2 d BH / 2 multiply-adds (32 GFLOP) against ~88 MB of
// q, k, v, dO in and dq, dk, dv out, so on this card the floor is the
// tensor-core rate (~0.033 ms), not bytes.  This first version does its
// dots on the CUDA cores in f32 from shared memory (no wgmma, no TMA), so
// the CUDA-core rate and shared-memory reads bound it in practice, far
// above that floor (see PERF.md).  What the design does about the work:
// every score and probability stays in registers and shared memory (no
// T x T matrix in device memory), q tiles wholly above the causal diagonal
// are skipped, and p is computed once per score for all three products.
//
// Design: the TPU kernel keeps dq resident in VMEM across a sequential kv
// grid axis; Hopper runs blocks in no order, so that does not carry over.
// Here one block of 256 threads owns one (64-row K/V tile, batch*head): K
// and V stay in shared memory while the block walks the q tiles from the
// causal lower bound to the end, accumulating dk and dv in registers.  dq
// gets each tile's contribution through atomicAdd into an f32 buffer the
// wrapper zeroes (so the order of dq's sum varies between runs).  The TPU
// kernel's q-chunked variant exists only to fit dq in VMEM; nothing here
// holds dq on chip, so no chunking is needed.  A ragged last tile (q or
// kv) is masked in-kernel, so any T is served.
//
// Thread layout: for the score tile, four threads own one query row and
// compute 16 of its 64 scores; for dk/dv, four threads own one key row and
// a quarter of its d columns; for dq, four threads own one query row and a
// quarter of its columns.  Row strides are padded by one float so the 8
// rows a warp touches fall in different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per row

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles (rows of D + 1 floats), P and dS tiles, lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (64 + 1) + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq32,
                 T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal,
                 float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 4;  // columns a thread owns
  extern __shared__ float smem[];
  float* Ks = smem;              // kBK x DP
  float* Vs = Ks + kBK * DP;     // kBK x DP
  float* Qs = Vs + kBK * DP;     // kBQ x DP
  float* dOs = Qs + kBQ * DP;    // kBQ x DP
  float* Ps = dOs + kBQ * DP;    // kBQ x PP, p rounded to dO's type
  float* dSs = Ps + kBQ * PP;    // kBQ x PP, ds rounded to q's type
  float* lse_s = dSs + kBQ * PP; // kBQ
  float* delta_s = lse_s + kBQ;  // kBQ

  const int k0 = blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // the row this thread works on (query or key)
  const int c = tid & 3;   // the quarter of the row it owns
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  const float* lseb = lse + bh * sq;
  const float* deltab = delta + bh * sq;
  float* dqb = dq32 + bh * sq * D;

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int kk = idx / D, e = idx % D;
    const int gk = k0 + kk;
    const bool in = gk < sk;  // ragged last tile: zero rows, masked below
    Ks[kk * DP + e] = in ? widen(kb[static_cast<size_t>(gk) * D + e]) : 0.f;
    Vs[kk * DP + e] = in ? widen(vb[static_cast<size_t>(gk) * D + e]) : 0.f;
  }

  const int offset = sk - sq;  // end-aligned causal offset
  // the first q tile with a row that sees key k0: offset + gq >= k0
  const int q_lo = causal ? max(0, k0 - offset) / kBQ : 0;
  const int n_qt = (sq + kBQ - 1) / kBQ;

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = q_lo; t < n_qt; ++t) {
    const int q0 = t * kBQ;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int rr = idx / D, e = idx % D;
      const int gq = q0 + rr;
      const bool in = gq < sq;
      Qs[rr * DP + e] = in ? widen(qb[static_cast<size_t>(gq) * D + e]) : 0.f;
      dOs[rr * DP + e] = in ? widen(dob[static_cast<size_t>(gq) * D + e]) : 0.f;
    }
    if (tid < kBQ) {
      const int gq = q0 + tid;
      lse_s[tid] = gq < sq ? lseb[gq] : 0.f;
      delta_s[tid] = gq < sq ? deltab[gq] : 0.f;
    }
    __syncthreads();

    // scores, probabilities and their cotangents for row r, keys c + 4i
    {
      const int gq = q0 + r;
      const int qpos = offset + gq;
      const float row_lse = lse_s[r];
      const float row_delta = delta_s[r];
#pragma unroll 4
      for (int i = 0; i < kBK / 4; ++i) {
        const int kk = c + 4 * i;
        const int gk = k0 + kk;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          s += Qs[r * DP + e] * Ks[kk * DP + e];
          dp += dOs[r * DP + e] * Vs[kk * DP + e];
        }
        const bool ok = gq < sq && gk < sk && (!causal || qpos >= gk);
        // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
        // exp(mask - lse) is 0 for every finite lse
        const float p = ok ? expf(s * sm_scale - row_lse) : 0.f;
        Ps[r * PP + kk] = round_to<T>(p);
        dSs[r * PP + kk] = round_to<T>(p * (dp - row_delta) * sm_scale);
      }
    }
    __syncthreads();

    // dv[kk] += p^T dO and dk[kk] += ds^T q for key row kk = r
#pragma unroll 4
    for (int rr = 0; rr < kBQ; ++rr) {
      const float pv = Ps[rr * PP + r];
      const float ds = dSs[rr * PP + r];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e = c + 4 * i;
        dv_acc[i] += pv * dOs[rr * DP + e];
        dk_acc[i] += ds * Qs[rr * DP + e];
      }
    }

    // dq[r] += ds k, summed into the f32 buffer across kv blocks
    const int gq = q0 + r;
    if (gq < sq) {
#pragma unroll 4
      for (int i = 0; i < NC; ++i) {
        const int e = c + 4 * i;
        float a = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < kBK; ++kk) a += dSs[r * PP + kk] * Ks[kk * DP + e];
        atomicAdd(dqb + static_cast<size_t>(gq) * D + e, a);
      }
    }
  }

  const int gk = k0 + r;
  if (gk < sk) {
    T* dkrow = dk + (bh * sk + gk) * D;
    T* dvrow = dv + (bh * sk + gk) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dkrow[c + 4 * i] = narrow<T>(dk_acc[i]);
      dvrow[c + 4 * i] = narrow<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq32, void* dk, void* dv, int BH, int sq, int sk,
           int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sk + kBK - 1) / kBK, BH);
  flash_bwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq32), static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq32, void* dk, void* dv, int BH, int sq, int sk, int d,
               int causal, float sm_scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, causal, sm_scale, st);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, causal, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, causal, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, causal, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, dout, dk and dv share it).  lse
// and delta are f32 (BH, sq); dq32 is an f32 (BH, sq, d) buffer that the
// caller zeroes.  Causal needs sq <= sk.  Returns a cudaError_t.
extern "C" int ds_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq32, void* dk, void* dv,
                            int BH, int sq, int sk, int d, int dtype, int causal,
                            float sm_scale, void* stream) {
  if (BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, d, causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq32, dk, dv, BH, sq, sk, d, causal,
                                     sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

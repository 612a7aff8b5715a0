// Two-pass flash-attention backward for Hopper (sm_90a): a dq pass (B6a)
// and a dk/dv pass (B6b) over (B*H, T, d), from the forward's log-sum-exp
// and delta = rowsum(dO * O), with the forward's options (no bias /
// key-row ``kbias`` / full ``fbias`` through its strides, in-kernel
// Threefry dropout; flash_common.cuh).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_bwd_dq_kernel (B6a) and _flash_bwd_dkv_kernel (B6b) (Pallas, TPU),
// driven there by _flash_bwd_pallas and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_bwd2_cuda.
// Both packages take this backward where a bias meets a sequence whose f32
// dq passes 2 MiB a batch*head (sq * d * 4 > _FUSED_BWD_MAX_SQ_BYTES: T >
// 8192 at d 64); the single-pass kernel (B2, flash_bwd.cu) takes the rest.
// Ported: the whole contract but the materialized uint8 keep-mask operand.
//
// Rounding points: those of B2 (flash_bwd.cu), from the same device
// function (flash::score_tile_bwd), except that dq is summed in f32
// registers and written once in q's type, as the Pallas dq kernel writes
// it: no atomics, so dq is the same bits from run to run.
//
// What bounds it: the two passes recompute the scores, probabilities and
// dp each (14 T^2 d BH flops where B2 does 10), so the floor is the
// tensor-core rate, not bytes; this first version does its dots on the
// CUDA cores in f32 from shared memory, and dropout regenerates the
// Threefry bits in each pass.  What the design does: nothing of T x T size
// reaches device memory, dq needs no f32 buffer and no atomics, and tiles
// wholly above the causal diagonal are skipped.
//
// B6a: one block of 256 threads per (64-row q tile, batch*head) keeps Q,
// dO, lse and delta of its tile in shared memory and walks the kv tiles up
// to the causal bound; four threads own one query row, 16 of its scores
// and a quarter of its dq columns, summed in registers.  B6b: one block
// per (64-row kv tile, batch*head) keeps K and V and walks the q tiles from
// the causal lower bound, dk and dv in registers (B2 without dq).  The
// bias is staged per tile as in B2.
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
using flash::widen;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles (rows of D + 1 floats), the dS tile, lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * (64 + 1) + 2 * 64);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles, lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (64 + 1) + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const Ext e, T* __restrict__ dq, int sq,
                    int sk, int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kPP;
  constexpr int NC = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x DP
  float* dOs = Qs + kBQ * DP;    // kBQ x DP
  float* Ks = dOs + kBQ * DP;    // kBK x DP
  float* Vs = Ks + kBK * DP;     // kBK x DP
  float* dSs = Vs + kBK * DP;    // kBQ x PP, ds rounded to q's type
  float* lse_s = dSs + kBQ * PP; // kBQ
  float* delta_s = lse_s + kBQ;  // kBQ
  float* Bk = delta_s + kBQ;     // kBK, a K tile's key-row bias
  float* Bt = Bk + kBK;          // kBQ x PP, the full bias tile (fbias only)

  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, e2 = idx % D;
    const int gq = q0 + rr;
    const bool in = gq < sq;
    Qs[rr * DP + e2] = in ? widen(qb[static_cast<size_t>(gq) * D + e2]) : 0.f;
    dOs[rr * DP + e2] = in ? widen(dob[static_cast<size_t>(gq) * D + e2]) : 0.f;
  }
  if (tid < kBQ) {
    const int gq = q0 + tid;
    lse_s[tid] = gq < sq ? lse[bh * sq + gq] : 0.f;
    delta_s[tid] = gq < sq ? delta[bh * sq + gq] : 0.f;
  }

  const int offset = sk - sq;  // end-aligned causal offset
  // key tiles wholly above the diagonal of the tile's last row are skipped
  const int kv_end = causal ? min(sk, max(0, offset + q0 + kBQ)) : sk;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  float dq_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int kk = idx / D, e2 = idx % D;
      const int gk = k0 + kk;
      const bool in = gk < sk;  // ragged last tile: zero rows, masked in the score tile
      Ks[kk * DP + e2] = in ? widen(kb[static_cast<size_t>(gk) * D + e2]) : 0.f;
      Vs[kk * DP + e2] = in ? widen(vb[static_cast<size_t>(gk) * D + e2]) : 0.f;
    }
    flash::stage_bias(e, Bk, Bt, bh, q0, k0, sq, sk, tid);
    __syncthreads();

    flash::score_tile_bwd<T, D, true, false>(Qs, dOs, Ks, Vs, lse_s, delta_s, Bk, Bt, nullptr,
                                             dSs, e, static_cast<uint32_t>(bh), q0, k0, sq, sk,
                                             causal, sm_scale, r, c);
    __syncwarp();  // the row's four threads have written their ds

    // dq[r] += ds k over this tile's keys, in registers
#pragma unroll 4
    for (int i = 0; i < NC; ++i) {
      const int e2 = c + 4 * i;
      float a = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < kBK; ++kk) a += dSs[r * PP + kk] * Ks[kk * DP + e2];
      dq_acc[i] += a;
    }
  }

  const int gq = q0 + r;
  if (gq < sq) {
    T* dqrow = dq + (bh * sq + gq) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) dqrow[c + 4 * i] = narrow<T>(dq_acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const Ext e, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int causal, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kPP;
  constexpr int NC = D / 4;
  extern __shared__ float smem[];
  float* Ks = smem;              // kBK x DP
  float* Vs = Ks + kBK * DP;     // kBK x DP
  float* Qs = Vs + kBK * DP;     // kBQ x DP
  float* dOs = Qs + kBQ * DP;    // kBQ x DP
  float* Ps = dOs + kBQ * DP;    // kBQ x PP, p (after dropout) rounded to dO's type
  float* dSs = Ps + kBQ * PP;    // kBQ x PP, ds rounded to q's type
  float* lse_s = dSs + kBQ * PP; // kBQ
  float* delta_s = lse_s + kBQ;  // kBQ
  float* Bk = delta_s + kBQ;     // kBK, the K tile's key-row bias
  float* Bt = Bk + kBK;          // kBQ x PP, the full bias of a q tile (fbias only)

  const int k0 = blockIdx.x * kBK;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const T* qb = q + bh * sq * D;
  const T* dob = dout + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int kk = idx / D, e2 = idx % D;
    const int gk = k0 + kk;
    const bool in = gk < sk;
    Ks[kk * DP + e2] = in ? widen(kb[static_cast<size_t>(gk) * D + e2]) : 0.f;
    Vs[kk * DP + e2] = in ? widen(vb[static_cast<size_t>(gk) * D + e2]) : 0.f;
  }
  if (e.kbias != nullptr) flash::stage_bias(e, Bk, Bt, bh, 0, k0, sq, sk, tid);

  const int offset = sk - sq;
  const int q_lo = causal ? max(0, k0 - offset) / kBQ : 0;
  const int n_qt = (sq + kBQ - 1) / kBQ;

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = q_lo; t < n_qt; ++t) {
    const int q0 = t * kBQ;
    __syncthreads();
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int rr = idx / D, e2 = idx % D;
      const int gq = q0 + rr;
      const bool in = gq < sq;
      Qs[rr * DP + e2] = in ? widen(qb[static_cast<size_t>(gq) * D + e2]) : 0.f;
      dOs[rr * DP + e2] = in ? widen(dob[static_cast<size_t>(gq) * D + e2]) : 0.f;
    }
    if (tid < kBQ) {
      const int gq = q0 + tid;
      lse_s[tid] = gq < sq ? lse[bh * sq + gq] : 0.f;
      delta_s[tid] = gq < sq ? delta[bh * sq + gq] : 0.f;
    }
    if (e.fbias != nullptr) flash::stage_bias(e, Bk, Bt, bh, q0, k0, sq, sk, tid);
    __syncthreads();

    flash::score_tile_bwd<T, D, true, true>(Qs, dOs, Ks, Vs, lse_s, delta_s, Bk, Bt, Ps, dSs, e,
                                            static_cast<uint32_t>(bh), q0, k0, sq, sk, causal,
                                            sm_scale, r, c);
    __syncthreads();

    // dv[kk] += p^T dO and dk[kk] += ds^T q for key row kk = r
#pragma unroll 4
    for (int rr = 0; rr < kBQ; ++rr) {
      const float pv = Ps[rr * PP + r];
      const float ds = dSs[rr * PP + r];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e2 = c + 4 * i;
        dv_acc[i] += pv * dOs[rr * DP + e2];
        dk_acc[i] += ds * Qs[rr * DP + e2];
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

// the arguments every launch passes on unchanged
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq (B6a), or dk and dv (B6b)
  Ext e;
  int BH, sq, sk, causal;
  float sm_scale;
  cudaStream_t st;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t bytes = dq_smem_bytes<D>() + sizeof(float) * flash::bias_smem_floats(a.e);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.BH);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<T*>(a.out0), a.sq, a.sk, a.causal,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t bytes = dkv_smem_bytes<D>() + sizeof(float) * flash::bias_smem_floats(a.e);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.sk + kBK - 1) / kBK, a.BH);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.sq, a.sk, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DQ>
int dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DQ>
int entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, void* out0, void* out1, const void* kbias, const void* fbias,
          long long fb_b, long long fb_h, long long fb_q, long long fb_k, int dropout, unsigned k0,
          unsigned k1, unsigned threshold, float inv_keep, int BH, int H, int sq, int sk, int d,
          int dtype, int causal, float sm_scale, void* stream) {
  if (BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (kbias != nullptr && fbias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((kbias != nullptr || fbias != nullptr) && (H < 1 || BH % H != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Ext e{static_cast<const float*>(kbias), static_cast<const float*>(fbias), fb_b, fb_h, fb_q,
              fb_k, H < 1 ? 1 : H, dropout, k0, k1, threshold, inv_keep};
  const Args a{q, k, v, dout, lse, delta, out0, out1, e, BH, sq, sk, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float, DQ>(a, d);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, DQ>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B6a: dq (q's type, (BH, sq, d)), written once per row.  dtype: 0 float32,
// 1 bfloat16 (q, k, v, dout and dq share it); lse and delta are f32 (BH,
// sq).  The extended options are the forward's (ds_flash_fwd): kbias or
// fbias (not both), dropout with (k0, k1, threshold, inv_keep).  Causal
// needs sq <= sk.  Returns a cudaError_t.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, const void* kbias,
                               const void* fbias, long long fb_b, long long fb_h, long long fb_q,
                               long long fb_k, int dropout, unsigned k0, unsigned k1,
                               unsigned threshold, float inv_keep, int BH, int H, int sq, int sk,
                               int d, int dtype, int causal, float sm_scale, void* stream) {
  return entry<true>(q, k, v, dout, lse, delta, dq, nullptr, kbias, fbias, fb_b, fb_h, fb_q, fb_k,
                     dropout, k0, k1, threshold, inv_keep, BH, H, sq, sk, d, dtype, causal,
                     sm_scale, stream);
}

// B6b: dk and dv (k's and v's type, (BH, sk, d)); arguments as B6a's.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* kbias, const void* fbias, long long fb_b,
                                long long fb_h, long long fb_q, long long fb_k, int dropout,
                                unsigned k0, unsigned k1, unsigned threshold, float inv_keep,
                                int BH, int H, int sq, int sk, int d, int dtype, int causal,
                                float sm_scale, void* stream) {
  return entry<false>(q, k, v, dout, lse, delta, dk, dv, kbias, fbias, fb_b, fb_h, fb_q, fb_k,
                      dropout, k0, k1, threshold, inv_keep, BH, H, sq, sk, d, dtype, causal,
                      sm_scale, stream);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flash-attention backward for Hopper (sm_90a), the f32 body: dq, dk and
// dv of online-softmax attention over (B*H, T, d) in one pass (bf16
// tensors take the tensor-core body, flash_bwd_tc.cu, with the same
// contract; f32's 2e-5 parity bound keeps this one on the CUDA cores), from the forward's
// log-sum-exp and delta = rowsum(dO * O), with the forward's options: an
// additive score bias (the key-row form (B, Tk) or the full form through
// its strides) and attention-probability dropout with in-kernel Threefry
// bits (flash_common.cuh).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_bwd_fused_kernel (Pallas, TPU), driven there by
// _flash_bwd_fused_pallas / _flash_bwd_fused_chunked and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_bwd_cuda.
// Ported: the whole contract but the materialized uint8 keep-mask operand:
// causal (end-aligned, as the forward) or full, no bias / ``kbias`` /
// ``fbias``, in-kernel dropout.  Its two-pass sibling (B6a/B6b,
// flash_bwd_2pass.cu) shares the score tile, bias and keep factor.
//
// Rounding points kept from the Pallas kernel (for parity):
//   * the dots take their operands in their own type and sum in f32;
//   * p = exp(s * scale - lse) is computed once per score, in f32; with a
//     bias, p = exp((s * scale + bias) - lse), the bias added after the
//     scale as in the forward, so ds carries no bias term;
//   * with dropout, dV's p and dp are multiplied by the keep factor (1 /
//     keep_prob in f32 on a kept score, 0 on a dropped one), each product
//     rounded on its own;
//   * p (after dropout) is rounded to dO's type before the dV product;
//   * ds = p * (dp - delta) * scale is rounded to q's type before the dK
//     and dQ products;
//   * dq is summed in f32 and cast to q's type by the wrapper.
//
// What bounds it: at the training shape (B 8, H 12, T 1024, d 64, causal)
// the work is ~5 T^2 d BH / 2 multiply-adds (32 GFLOP) against ~176 MB of
// f32 q, k, v, dO in and dq, dk, dv out, so the f32 floor is the CUDA-core
// rate (67 TFLOP/s).  This body does its dots from shared memory, one
// float read per multiply-add, so shared-memory reads bound it in
// practice, far above that floor (see PERF.md); dropout adds Threefry's
// ~85 integer operations a score, once.  What the design does about the work: every
// score and probability stays in registers and shared memory (no T x T
// matrix in device memory, no keep mask: its bits are regenerated from
// the position), q tiles wholly above the causal diagonal are skipped,
// and p is computed once per score for all three products.
//
// Design: the TPU kernel keeps dq resident in VMEM across a sequential kv
// grid axis; Hopper runs blocks in no order, so that does not carry over.
// Here one block of 256 threads owns one (64-row K/V tile, batch*head): K
// and V stay in shared memory while the block walks its q tiles
// (flash_common.cuh's QTileWalk: from the causal lower bound up, rotated
// in a full square attention), accumulating dk and dv in registers.  dq
// gets each tile's contribution added into an f32 buffer the wrapper
// zeroes, the key tiles of a q tile taking turns in a fixed order
// (QTileWalk::rank, wait_turn / pass_turn), so dq is the same bits every
// run, as the JAX kernel's.  The TPU kernel's q-chunked variant exists
// only to fit dq in VMEM; nothing here
// holds dq on chip, so no chunking is needed.  A ragged last tile (q or
// kv) is masked in-kernel, so any T is served.
//
// Thread layout: for the score tile, four threads own one query row and
// compute 16 of its 64 scores; for dk/dv, four threads own one key row and
// a quarter of its d columns; for dq, four threads own one query row and a
// quarter of its columns.  Row strides are padded by one float so the 8
// rows a warp touches fall in different banks.  EXT, a template flag,
// selects the kernel that reads the run-time options (bias form, dropout);
// without it the kernel is the bias-free code it was before they existed.
// With a bias the block stages its tile's bias
// in shared memory (the K tile's 64 key-row values once, or each q tile's
// 64 x 64 full tile).
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
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles (rows of D + 1 floats), P and dS tiles, lse, delta;
  // the extended kernel's bias follows (bias_smem_floats)
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * (64 + 1) + 2 * 64);
}

template <typename T, int D, bool EXT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const Ext e, float* __restrict__ dq32,
                 int* __restrict__ dq_turn, T* __restrict__ dk, T* __restrict__ dv, int sq,
                 int sk, int causal, int rotate, int natural, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kPP;
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
  float* Bk = delta_s + kBQ;     // kBK, the K tile's key-row bias (EXT only)
  float* Bt = Bk + kBK;          // kBQ x PP, the full bias of a q tile (EXT with fbias only)

  const flash::QTileWalk w(blockIdx.x, sq, sk, causal, rotate, natural);
  const int k0 = w.kt * kBK;
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
    const int kk = idx / D, e2 = idx % D;
    const int gk = k0 + kk;
    const bool in = gk < sk;  // ragged last tile: zero rows, masked below
    Ks[kk * DP + e2] = in ? widen(kb[static_cast<size_t>(gk) * D + e2]) : 0.f;
    Vs[kk * DP + e2] = in ? widen(vb[static_cast<size_t>(gk) * D + e2]) : 0.f;
  }
  // the key-row bias of this K tile, staged once (the full form per q tile)
  if (EXT && e.kbias != nullptr) flash::stage_bias(e, Bk, Bt, bh, 0, k0, sq, sk, tid);

  const int n_qt = (sq + kBQ - 1) / kBQ;

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // the q tiles in QTileWalk's order: a key tile's predecessor in a q
  // tile's dq sum reached it one step earlier
  for (int step = 0; step < w.m; ++step) {
    const int t = w.tile(step);
    const int q0 = t * kBQ;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int rr = idx / D, e2 = idx % D;
      const int gq = q0 + rr;
      const bool in = gq < sq;
      Qs[rr * DP + e2] = in ? widen(qb[static_cast<size_t>(gq) * D + e2]) : 0.f;
      dOs[rr * DP + e2] = in ? widen(dob[static_cast<size_t>(gq) * D + e2]) : 0.f;
    }
    if (tid < kBQ) {
      const int gq = q0 + tid;
      lse_s[tid] = gq < sq ? lseb[gq] : 0.f;
      delta_s[tid] = gq < sq ? deltab[gq] : 0.f;
    }
    if (EXT && e.fbias != nullptr) flash::stage_bias(e, Bk, Bt, bh, q0, k0, sq, sk, tid);
    __syncthreads();

    // scores, probabilities and their cotangents for row r, keys c + 4i
    flash::score_tile_bwd<T, D, EXT, true>(Qs, dOs, Ks, Vs, lse_s, delta_s, Bk, Bt, Ps, dSs, e,
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

    // dq[r] += ds k, summed into the f32 buffer across kv blocks in the q
    // tile's turn (flash_common.cuh): one block adds at a time, in the
    // same order every run
    const int gq = q0 + r;
    float part[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int e2 = c + 4 * i;
      float a = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < kBK; ++kk) a += dSs[r * PP + kk] * Ks[kk * DP + e2];
      part[i] = a;
    }
    int* turn = dq_turn + bh * n_qt + t;
    flash::wait_turn(turn, w.rank(t));
    if (gq < sq) {
      float* row = dqb + static_cast<size_t>(gq) * D;
#pragma unroll
      for (int i = 0; i < NC; ++i) atomicAdd(row + c + 4 * i, part[i]);
    }
    flash::pass_turn(turn, w.rank(t));
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
  void *dq32, *dq_turn, *dk, *dv;
  Ext e;
  int BH, sq, sk, causal;
  float sm_scale;
  cudaStream_t st;
};

template <typename T, int D, bool EXT>
int launch(const Args& a) {
  const size_t bytes = smem_bytes<D>() + (EXT ? sizeof(float) * flash::bias_smem_floats(a.e) : 0);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, D, EXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;  // blocks an SM holds
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_kernel<T, D, EXT>,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const flash::WalkPlan plan = flash::plan_walk(a.sq, a.sk, D, a.causal, per_sm);
  dim3 grid((a.sk + kBK - 1) / kBK, a.BH);
  flash_bwd_kernel<T, D, EXT><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<float*>(a.dq32),
      static_cast<int*>(a.dq_turn), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.causal, plan.rotate, plan.natural, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_ext(const Args& a) {
  if (a.e.kbias == nullptr && a.e.fbias == nullptr && !a.e.dropout) return launch<T, D, false>(a);
  return launch<T, D, true>(a);
}

template <typename T>
int dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return dispatch_ext<T, 16>(a);
    case 32: return dispatch_ext<T, 32>(a);
    case 64: return dispatch_ext<T, 64>(a);
    case 128: return dispatch_ext<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32 (q, k, v, dout, dk and dv; bf16 is flash_bwd_tc.cu's).  lse
// and delta are f32 (BH, sq); dq32 is an f32 (BH, sq, d) buffer and dq_turn
// an int32 (BH, ceil(sq / 64)) buffer of turn counters (flash_common.cuh's
// QTileWalk), both zeroed by the caller.  The extended options are the
// forward's (ds_flash_fwd): kbias or fbias (not both), dropout with (k0,
// k1, threshold, inv_keep);
// with none of them the kernel is the one without options.  Causal needs
// sq <= sk.  Returns a cudaError_t.
extern "C" int ds_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq32, void* dq_turn,
                            void* dk, void* dv,
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
  const Args a{q, k, v, dout, lse, delta, dq32, dq_turn, dk, dv, e, BH, sq, sk, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

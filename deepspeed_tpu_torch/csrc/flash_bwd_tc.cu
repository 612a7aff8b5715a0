// Flash-attention backward for Hopper (sm_90a), the bf16 body: dq, dk and
// dv in one pass with its five products on the tensor cores (mma.sync
// m16n8k16, operands from shared memory by ldmatrix), Q/dO/lse/delta
// tiles brought by a double-buffered cp.async ring, dq added into device
// memory by bulk reductions.  Same function and
// options as the f32 body in flash_bwd.cu: the forward's log-sum-exp and
// delta = rowsum(dO * O), an additive score bias (the key-row form (B, Tk)
// or the full form through its strides) and attention-probability dropout
// with in-kernel Threefry bits (flash_common.cuh).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_bwd_fused_kernel (Pallas, TPU), driven there by
// _flash_bwd_fused_pallas / _flash_bwd_fused_chunked and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_bwd_cuda for
// bf16 tensors (f32 tensors take flash_bwd.cu).
//
// Rounding points, as flash_bwd.cu states them: bf16 operands summed in
// f32; p = exp(s * scale (+ bias) - lse) once per score in f32; with
// dropout, dV's p and dp times the keep factor, each product rounded on
// its own; p (after dropout) rounded to bf16 before the dV product; ds = p
// (dp - delta) scale rounded to bf16 before the dK and dQ products; dq
// summed in f32 (cast to bf16 by the wrapper).
//
// What bounds it: at GPT-2's training shape (B 8, H 12, T 1024, d 64,
// causal) the five products are 32 GFLOP against ~88 MB of q, k, v, dO in
// and dq, dk, dv out, so the floor is the tensor-core rate (~0.033 ms at
// 989 TFLOP/s).  The f32 body ran them on the CUDA cores at ~8 TFLOP/s.
// dq's f32 sum across key tiles goes through L2 (64 d adds for each pair
// of a q tile and a key tile: 53 M at that shape), as vector reductions in
// each q tile's turn (below); with dropout, Threefry's ~75 integer
// operations a score outweigh the products, as in the forward: the walk
// forms a tile's
// keep-bits ahead of its products (a DROP template flag; a body without
// dropout carries no Threefry code).
//
// Why mma.sync and not wgmma: three of the five products read an operand
// transposed (dO and Q for dV and dK, K and dS^T for dQ) and two take a
// register operand built from the score tile; ldmatrix's .trans form
// gives each of those fragments from one row-major tile in shared memory,
// where wgmma would need each tile in two swizzled layouts.  mma.sync is
// the class of FlashAttention-2's backward, the kernel behind PyTorch's
// SDPA backward on this card.
//
// What the design does: the decomposition of flash_bwd.cu, written once
// as flash_tc.cuh's tc::bwd::kv_tile_walk (the dk/dv pass of the two-pass
// backward, flash_bwd_2pass_tc.cu, and the block-sparse one,
// splash_attn_tc.cu, run it without dq).  One block of four warps owns
// one (64-row K/V tile, batch*head): K and V stay in shared memory while
// the block walks its q tiles (from the causal lower bound up, wrapped
// around where the walk rotates), the next q tile's Q, dO, lse and delta
// loading by cp.async while the current one computes.  Warp w owns keys
// 16w..16w+15:
//   S^T = K.Q^T and dP^T = V.dO^T (16 x 64 each, f32 accumulators);
//   P^T and dS^T formed on those accumulators with the bias, mask, lse,
//   delta and keep factor, then rounded to bf16 in registers;
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//   operands (the accumulator layout of two 8-column chunks is the A
//   layout of one 16-deep step), dk and dv held in registers;
//   dS^T staged to shared memory, and dQ += dS.K for q rows 16w..16w+15,
//   added into the f32 buffer by vector reductions in L2 in the q tile's
//   turn: the key tiles add into a q tile one at a time in a fixed order,
//   through an int32 counter a (batch*head, q tile) (flash_common.cuh's
//   QTileWalk), so dq is the same bits every run, as the JAX kernel's,
//   whose sequential kv axis sums dq in one order.  The walk is ordered so
//   that a key tile's predecessor in a q tile's sum reached that q tile
//   one step earlier: the turn waits for nobody once the walks run
//   (causal: each key tile walks up from its bound and the sum runs down
//   the key tiles; full and square: the walks are rotated).
// Rounding: the tensor cores sum S and dP in another order than the f32
// body's FMA chain and the plain version's f32 GEMMs, so where the f32 P or
// dS lies next to a bf16 rounding tie the two may round to neighbouring
// values.  Either is the contract's rounding of a value within an f32 sum's
// error of the exact one; the check holds the result (and the plain
// version) to the float64 function within the bound of that contract
// (flash_attention.flash_bwd_float64), not to the plain version's bits.
// Rows of every tile are padded by 16 bytes so ldmatrix's eight rows fall
// in different banks.  Q tiles wholly above the causal diagonal are
// skipped and only tiles that cross it (or a ragged end) are masked, so
// any T is served; rows past T load as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Ext;
using tc::bwd::kBK;
using tc::bwd::kThreads;

// the key-tile walk of flash_tc.cuh with dq, over the q tiles in the walk
// order of flash_common.cuh's QTileWalk
template <int D, bool EXT, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta, const Ext e,
                    float* __restrict__ dq32, int* __restrict__ dq_turn, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int sq, int sk, int causal, int rotate,
                    int natural, float sm_scale) {
  const flash::QTileWalk w(blockIdx.x, sq, sk, causal, rotate, natural);
  const int k0 = w.kt * kBK;
  tc::bwd::kv_tile_walk<D, EXT, DROP, true>(
      q, k, v, dout, lse, delta, e, dq32, dq_turn, blockIdx.y, k0, min(kBK, sk - k0), sq, sk,
      causal, sm_scale, tc::bwd::DenseQTiles(w, sq),
      tc::bwd::StoreDkv<D>(dk, dv, blockIdx.y, k0, sk));
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

template <int D, bool EXT, bool DROP>
int launch(const Args& a) {
  constexpr int bytes = tc::bwd::Smem<D, true>::kBytes;
  static int per_sm = 0;  // blocks an SM holds
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_kernel<D, EXT, DROP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_bwd_tc_kernel<D, EXT, DROP>, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const flash::WalkPlan plan = flash::plan_walk(a.sq, a.sk, D, a.causal, per_sm);
  dim3 grid((a.sk + kBK - 1) / kBK, a.BH);
  flash_bwd_tc_kernel<D, EXT, DROP><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<float*>(a.dq32),
      static_cast<int*>(a.dq_turn), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq,
      a.sk, a.causal, plan.rotate, plan.natural, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// the body for the options: none, a bias, or dropout (with or without a bias)
template <int D>
int dispatch_ext(const Args& a) {
  if (a.e.dropout) return launch<D, true, true>(a);
  if (a.e.kbias == nullptr && a.e.fbias == nullptr) return launch<D, false, false>(a);
  return launch<D, true, false>(a);
}

}  // namespace

// The bf16 backward: q, k, v, dout, dk and dv bf16 (B*H, T, d), contiguous
// and 16-byte aligned (cp.async's rule); the other arguments as
// ds_flash_bwd's (flash_bwd.cu: dq32 and the dq_turn counters zeroed by
// the caller), whose dtype must be 1.  Returns a cudaError_t.
extern "C" int ds_flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq32, void* dq_turn,
                               void* dk, void* dv,
                               const void* kbias, const void* fbias, long long fb_b,
                               long long fb_h, long long fb_q, long long fb_k, int dropout,
                               unsigned k0, unsigned k1, unsigned threshold, float inv_keep,
                               int BH, int H, int sq, int sk, int d, int dtype, int causal,
                               float sm_scale, void* stream) {
  if (dtype != 1 || BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kbias != nullptr && fbias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((kbias != nullptr || fbias != nullptr) && (H < 1 || BH % H != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Ext e{static_cast<const float*>(kbias), static_cast<const float*>(fbias), fb_b, fb_h, fb_q,
              fb_k, H < 1 ? 1 : H, dropout, k0, k1, threshold, inv_keep};
  const Args a{q, k, v, dout, lse, delta, dq32, dq_turn, dk, dv, e, BH, sq, sk, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return dispatch_ext<16>(a);
    case 32: return dispatch_ext<32>(a);
    case 64: return dispatch_ext<64>(a);
    case 128: return dispatch_ext<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Two-pass flash-attention backward for Hopper (sm_90a), the bf16 bodies:
// a dq pass (B6a) and a dk/dv pass (B6b) with their products on the tensor
// cores (mma.sync m16n8k16, operands from shared memory by ldmatrix), tiles
// brought by double-buffered cp.async rings.  Same function and options as
// the f32 bodies in flash_bwd_2pass.cu: the forward's log-sum-exp and delta
// = rowsum(dO * O), an additive score bias (the key-row form (B, Tk) or the
// full form through its strides) and attention-probability dropout with
// in-kernel Threefry bits (flash_common.cuh).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::
// _flash_bwd_dq_kernel (B6a, :480) and _flash_bwd_dkv_kernel (B6b, :538)
// (Pallas, TPU), driven there by _flash_bwd_pallas and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_bwd_dq_cuda
// and flash_bwd_dkv_cuda for bf16 tensors (f32 tensors take
// flash_bwd_2pass.cu).  Both packages take this backward where a bias
// meets a sequence whose f32 dq passes 2 MiB a batch*head (T > 8192 at d
// 64).  Ported: the whole contract but the materialized uint8 keep-mask
// operand.
//
// Rounding points: those of the single-pass bf16 body (flash_bwd_tc.cu,
// from the same device function, tc::bwd::probs): bf16 operands summed in
// f32; p = exp(s * scale (+ bias) - lse) once per score in f32; with
// dropout, dV's p and dp times the keep factor, each product rounded on
// its own; p (after dropout) rounded to bf16 before the dV product; ds = p
// (dp - delta) scale rounded to bf16 before the dK and dQ products.  dq is
// summed in f32 registers across the key tiles and rounded to bf16 once,
// as the Pallas dq kernel writes it: no atomics, so dq is the same bits
// from launch to launch.  The tensor cores sum S and dP in another order
// than the plain version's GEMMs, so a bf16 P or dS next to a rounding tie
// may round to the other neighbour: the check holds the result (and the
// plain version) to the float64 function within the bound of the bf16
// contract (flash_attention.flash_bwd_float64), as for B2.
//
// What bounds it: each pass recomputes S and dP (B6a three products, B6b
// four: 14 T^2 d BH flops together, ~1.2 ms at (1, 16, 9216, 64) at 989
// TFLOP/s), and with dropout each pass regenerates the Threefry keep-bits:
// ~75 integer operations a score on the INT32 pipe, ~6.1 ms a pass at that
// shape, six times the products.  So with dropout the integer pipe is the
// floor, else the tensor cores.  What the design does about it: the
// products run on the tensor cores, so the passes are left with the
// integer work; each pass computes a tile's 32 keep-bits a thread into
// one word in the same straight-line block as its S and dP products
// (DROP is a template flag, so a body without dropout carries no Threefry
// code), so the scheduler issues the integer chain while the tensor cores
// work; nothing of T x T size reaches device memory, and tiles wholly
// above the causal diagonal are skipped.  mma.sync rather than wgmma for the reason
// flash_bwd_tc.cu gives: the dQ product reads K transposed and takes dS as
// a register operand, which ldmatrix's .trans form serves from one
// row-major tile.
//
// B6a: flash_tc.cuh's tc::bwd::q_tile_walk (B9a runs it too, over a
// layout's key tiles): one block of four warps per (64-row q tile,
// batch*head) keeps Q, dO, lse and delta of its tile in shared memory and
// walks the key tiles up to the causal bound, the next K/V tile (and its
// key-row bias) loading by cp.async while the current one computes.  Warp
// w owns q rows 16w..16w+15:
//   S = Q.K^T and dP = dO.V^T (16 x 64 each, f32 accumulators);
//   dS = p (dp keep - delta) scale formed on them with the bias, mask,
//   lse, delta and keep-bits, rounded to bf16 in registers;
//   dQ += dS.K with dS as the register A operand and K's B fragments by
//   ldmatrix.trans, dq summed in registers (D / 2 floats a thread).
// B6b: flash_tc.cuh's tc::bwd::kv_tile_walk without dq: one block per
// (64-row K/V tile, batch*head), dk and dv in registers, no dS staging,
// over B2's q tiles in B2's order (so its dk and dv are B2's bits).
// Rows of every tile are padded by 16 bytes so ldmatrix's eight rows fall
// in different banks; rows past T load as zeros and only tiles that cross
// the diagonal or a ragged end are masked, so any T is served.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Ext;
using tc::bwd::kBK;
using tc::bwd::kBQ;
using tc::bwd::kThreads;

// B6a: the q-tile walk of flash_tc.cuh over the key tiles up to the causal
// bound
template <int D, bool EXT, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const Ext e, bf16* __restrict__ dq, int sq, int sk, int causal,
                       float sm_scale) {
  const int q0 = blockIdx.x * kBQ;
  tc::bwd::q_tile_walk<D, EXT, DROP>(q, k, v, dout, lse, delta, e, dq, blockIdx.y, q0,
                                     min(kBQ, sq - q0), sq, sk, causal, sm_scale,
                                     tc::DenseKTiles(q0, sq, sk, causal));
}

// B6b: the key-tile walk of flash_tc.cuh without dq, over B2's q tiles
template <int D, bool EXT, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const Ext e, bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                        int sk, int causal, int rotate, float sm_scale) {
  // no turns to wait on: key tile blockIdx.x (the longest causal walks
  // first), B2's walk for it
  const flash::QTileWalk w(blockIdx.x, sq, sk, causal, rotate, 1);
  const int k0 = w.kt * kBK;
  tc::bwd::kv_tile_walk<D, EXT, DROP, false>(
      q, k, v, dout, lse, delta, e, nullptr, nullptr, blockIdx.y, k0, min(kBK, sk - k0), sq, sk,
      causal, sm_scale, tc::bwd::DenseQTiles(w, sq),
      tc::bwd::StoreDkv<D>(dk, dv, blockIdx.y, k0, sk));
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

template <int D, bool EXT, bool DROP>
int launch_dq(const Args& a) {
  constexpr int bytes = tc::bwd::DqSmem<D>::kBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D, EXT, DROP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.BH);
  flash_bwd_dq_tc_kernel<D, EXT, DROP><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<bf16*>(a.out0), a.sq, a.sk, a.causal,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXT, bool DROP>
int launch_dkv(const Args& a) {
  constexpr int bytes = tc::bwd::Smem<D, false>::kBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D, EXT, DROP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  dim3 grid((a.sk + kBK - 1) / kBK, a.BH);
  flash_bwd_dkv_tc_kernel<D, EXT, DROP><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.sq, a.sk, a.causal,
      flash::plan_walk(a.sq, a.sk, D, a.causal, 1 << 20).rotate, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// the body for the options: none, a bias, or dropout (with or without a bias)
template <int D, bool DQ>
int dispatch_ext(const Args& a) {
  if (a.e.dropout) return DQ ? launch_dq<D, true, true>(a) : launch_dkv<D, true, true>(a);
  if (a.e.kbias == nullptr && a.e.fbias == nullptr)
    return DQ ? launch_dq<D, false, false>(a) : launch_dkv<D, false, false>(a);
  return DQ ? launch_dq<D, true, false>(a) : launch_dkv<D, true, false>(a);
}

template <bool DQ>
int entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, void* out0, void* out1, const void* kbias, const void* fbias,
          long long fb_b, long long fb_h, long long fb_q, long long fb_k, int dropout, unsigned k0,
          unsigned k1, unsigned threshold, float inv_keep, int BH, int H, int sq, int sk, int d,
          int dtype, int causal, float sm_scale, void* stream) {
  if (dtype != 1 || BH < 1 || sq < 1 || sk < 1 || (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kbias != nullptr && fbias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((kbias != nullptr || fbias != nullptr) && (H < 1 || BH % H != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out0) | reinterpret_cast<uintptr_t>(out1)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Ext e{static_cast<const float*>(kbias), static_cast<const float*>(fbias), fb_b, fb_h, fb_q,
              fb_k, H < 1 ? 1 : H, dropout, k0, k1, threshold, inv_keep};
  const Args a{q, k, v, dout, lse, delta, out0, out1, e, BH, sq, sk, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return dispatch_ext<16, DQ>(a);
    case 32: return dispatch_ext<32, DQ>(a);
    case 64: return dispatch_ext<64, DQ>(a);
    case 128: return dispatch_ext<128, DQ>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B6a, bf16: dq (B*H, sq, d), written once per row.  q, k, v, dout and dq
// bf16, contiguous and 16-byte aligned (cp.async's rule); the other
// arguments as ds_flash_bwd_dq's (flash_bwd_2pass.cu), whose dtype must be
// 1.  Returns a cudaError_t.
extern "C" int ds_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, const void* kbias,
                                  const void* fbias, long long fb_b, long long fb_h,
                                  long long fb_q, long long fb_k, int dropout, unsigned k0,
                                  unsigned k1, unsigned threshold, float inv_keep, int BH, int H,
                                  int sq, int sk, int d, int dtype, int causal, float sm_scale,
                                  void* stream) {
  return entry<true>(q, k, v, dout, lse, delta, dq, nullptr, kbias, fbias, fb_b, fb_h, fb_q, fb_k,
                     dropout, k0, k1, threshold, inv_keep, BH, H, sq, sk, d, dtype, causal,
                     sm_scale, stream);
}

// B6b, bf16: dk and dv (B*H, sk, d); arguments as B6a's.
extern "C" int ds_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
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

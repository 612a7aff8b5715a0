// Flash-attention forward for Hopper (sm_90a), the bf16 body: Q.K^T and
// P.V on the tensor cores (wgmma), K/V tiles brought by TMA.  Same
// function and options as the f32 body in flash_fwd.cu: online-softmax
// attention over (B*H, T, d), end-aligned causal or full, optional lse,
// an optional additive score bias (the key-row form (B, Tk) or the full
// form through its strides) and optional attention-probability dropout
// with in-kernel Threefry bits (flash_common.cuh).
//
// Replaces: deepspeed_tpu/ops/attention/flash_attention.py::_flash_fwd_kernel
// (Pallas, TPU), driven there by _flash_fwd_pallas and here by
// deepspeed_tpu_torch/ops/attention/flash_attention.py::flash_fwd_cuda for
// bf16 tensors (f32 tensors take flash_fwd.cu).
//
// Rounding points, as flash_fwd.cu states them: bf16 operands summed in
// f32 (the tensor cores' bf16 x bf16 products are exact, their sums f32);
// m, l and the output accumulator f32; p rounded to bf16 before P.V while
// l sums the unrounded p; with dropout the rounded value is p * keep; a
// bias added in f32 after the scale, each step rounded on its own; causal
// end-aligned (query row i at key position (sk - sq) + i); a row with l = 0
// divides by 1 and its lse is +inf.
//
// What bounds it: at GPT-2's training shape (B 8, H 12, T 1024, d 64,
// causal) the work is 12.9 GFLOP against 6.7 MB of q, k, v and out, ~1,900
// flops a byte, so the floor is the tensor-core rate (0.013 ms at 989
// TFLOP/s).  The f32 body ran its dots on the CUDA cores from shared
// memory at ~8 TFLOP/s.  With dropout, Threefry's ~85 integer operations
// a score (20 rounds) on the INT32 pipe outweigh the dots: at BERT's
// (8, 16, 512, 64) shape ~0.17 ms of integer work against 0.03 ms of
// tensor-core work.
//
// What the design does: one block of 160 threads per (64-query tile,
// batch*head) runs flash_tc.cuh's forward walk (tc::fwd::q_tile_walk: a
// producer warp keeping the K/V tiles in flight by TMA into a ring of
// stages, one consumer warpgroup on wgmma, the next tile's softmax under
// this tile's P.V) over the q tile's contiguous key tiles up to the causal
// bound (tc::DenseKTiles): key tiles wholly above the causal diagonal are
// never loaded and only tiles that cross it (or the ragged end) are
// masked; the causal grid walks the heaviest query tiles first.  Tensor
// maps are 3-D (d, T, B*H), so rows past T arrive as zeros and never as
// the next head's rows; they are masked in-kernel, so any T is served.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::Ext;
using tc::fwd::kBQ;
using tc::fwd::kThreads;

// With a bias or dropout at d <= 64, three blocks an SM (registers capped
// at 136) beat two with more registers by ~10 % on the card; at d 128 and
// without options the cap would spill the accumulators
template <int D, bool EXT>
__global__ void __launch_bounds__(kThreads, EXT && D <= 64 ? 3 : 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                    float* __restrict__ lse, const Ext e, int sq, int sk, int causal,
                    float sm_scale) {
  const int n_qt = gridDim.x;
  // causal: the last query tiles see the most keys, so they start first
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int q0 = qt * kBQ;
  tc::fwd::q_tile_walk<D, EXT>(&qmap, &kmap, &vmap, out, lse, e, blockIdx.y, q0,
                               min(kBQ, sq - q0), sq, sk, causal, sm_scale,
                               tc::DenseKTiles(q0, sq, sk, causal));
}

template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
           int BH, int sq, int sk, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const int err = tc::fwd::make_maps<D>(&qm, &km, &vm, q, k, v, BH, sq, sk);
  if (err) return err;
  constexpr int bytes = tc::fwd::Tile<D>::kSmem;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e2 = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, EXT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    sized = true;
  }
  dim3 grid((sq + kBQ - 1) / kBQ, BH);
  flash_fwd_tc_kernel<D, EXT><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), e, sq, sk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_ext(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
                 int BH, int sq, int sk, int causal, float sm_scale, cudaStream_t st) {
  if (e.kbias == nullptr && e.fbias == nullptr && !e.dropout)
    return launch<D, false>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
  return launch<D, true>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
}

}  // namespace

// The bf16 forward: q, k, v and out bf16 (B*H, T, d), contiguous and
// 16-byte aligned (TMA's rule); the other arguments as ds_flash_fwd's
// (flash_fwd.cu), whose dtype must be 1.  Returns a cudaError_t.
extern "C" int ds_flash_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
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
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Ext e{static_cast<const float*>(kbias), static_cast<const float*>(fbias), fb_b, fb_h, fb_q,
              fb_k, H < 1 ? 1 : H, dropout, k0, k1, threshold, inv_keep};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return dispatch_ext<16>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 32: return dispatch_ext<32>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 64: return dispatch_ext<64>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    case 128: return dispatch_ext<128>(q, k, v, out, lse, e, BH, sq, sk, causal, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// B6a: one block of four warps per (64-row q tile, batch*head) keeps Q, dO,
// lse and delta of its tile in shared memory and walks the key tiles up to
// the causal bound, the next K/V tile (and its key-row bias) loading by
// cp.async while the current one computes.  Warp w owns q rows
// 16w..16w+15:
//   S = Q.K^T and dP = dO.V^T (16 x 64 each, f32 accumulators);
//   dS = p (dp keep - delta) scale formed on them with the bias, mask,
//   lse, delta and keep-bits, rounded to bf16 in registers;
//   dQ += dS.K with dS as the register A operand and K's B fragments by
//   ldmatrix.trans, dq summed in registers (D / 2 floats a thread).
// B6b: flash_tc.cuh's tc::bwd::kv_tile_walk without dq: one block per
// (64-row K/V tile, batch*head), dk and dv in registers, no dS staging.
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

// shared memory of the dq pass: the Q and dO tiles, two buffers each of a
// K and a V tile, lse and delta of the q tile, two buffers of a K tile's
// key-row bias
template <int D>
struct DqSmem {
  static constexpr int kP = D + 8;       // row pitch (elements) of a tile
  static constexpr int kTile = 64 * kP;  // elements of a tile
  static constexpr int kBytes = 2 * 6 * kTile + 4 * (2 * kBQ + 2 * kBK);
};

template <int D, bool EXT, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const Ext e, bf16* __restrict__ dq, int sq, int sk, int causal,
                       float sm_scale) {
  using S = DqSmem<D>;
  constexpr int P = S::kP;
  constexpr int ND = D / 8;  // 8-column chunks of a d-wide accumulator
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + S::kTile;
  bf16* Ks = dOs + S::kTile;  // two buffers, each a K tile then a V tile
  bf16* Vs = Ks + S::kTile;
  float* lse_s = reinterpret_cast<float*>(Qs + 6 * S::kTile);  // kBQ
  float* delta_s = lse_s + kBQ;                                // kBQ
  float* kb_s = delta_s + kBQ;                                 // two buffers of kBK

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int qw = 16 * warp;  // this warp's q rows in the tile
  // ldmatrix addressing: the row and column a lane points at
  const int lrA = (lane & 7) + 8 * ((lane >> 3) & 1), lcA = 8 * (lane >> 4);  // A, row-major
  const int lrB = (lane & 7) + 8 * (lane >> 4), lcB = 8 * ((lane >> 3) & 1);  // B from [n][k]
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
  const float* kbias_b =
      EXT && e.kbias != nullptr ? e.kbias + static_cast<long long>(bh / e.H) * sk : nullptr;
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;
  const bool has_bias = EXT && (e.kbias != nullptr || e.fbias != nullptr);

  const int offset = sk - sq;  // end-aligned causal offset
  // key tiles wholly above the diagonal of the tile's last row are skipped
  const int kv_end = causal ? min(sk, max(0, offset + q0 + kBQ)) : sk;
  const int n_kt = (kv_end + kBK - 1) / kBK;

  auto load_kv_tile = [&](int t, int buf) {
    const int k0 = t * kBK;
    tc::bwd::load_tile<D>(Ks + 2 * buf * S::kTile, kb, k0, sk, tid);
    tc::bwd::load_tile<D>(Vs + 2 * buf * S::kTile, vb, k0, sk, tid);
    if (kbias_b != nullptr && tid < kBK) {
      const bool in = k0 + tid < sk;
      tc::cp_async4(kb_s + buf * kBK + tid, kbias_b + (in ? k0 + tid : 0), in);
    }
  };

  {
    tc::bwd::load_tile<D>(Qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    tc::bwd::load_tile<D>(dOs, dout + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    const int r = tid & 63;
    const bool in = q0 + r < sq;
    const size_t row = static_cast<size_t>(bh) * sq + (in ? q0 + r : 0);
    if (tid < 64)
      tc::cp_async4(lse_s + r, lse + row, in);
    else
      tc::cp_async4(delta_s + r, delta + row, in);
  }
  if (n_kt > 0) load_kv_tile(0, 0);
  tc::cp_async_commit();

  float dq_acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int buf = t & 1;
    const int k0 = t * kBK;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_kt) {
      load_kv_tile(t + 1, buf ^ 1);
      tc::cp_async_commit();
    }
    const bf16* Kt = Ks + 2 * buf * S::kTile;
    const bf16* Vt = Vs + 2 * buf * S::kTile;
    const float* kbt = kb_s + buf * kBK;

    // element i of this thread's 32 scores sits at q row qw + g + 8 * ((i
    // >> 1) & 1), key 8 * (i >> 2) + t2 + (i & 1) of the tile.  The
    // keep-bits first: integer work with no operand from the products, in
    // one block with them, so it issues while the tensor cores run
    uint32_t keep = 0;
    if (DROP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int gq = q0 + qw + g + 8 * ((i >> 1) & 1);
        const int gk = k0 + 8 * (i >> 2) + t2 + (i & 1);
        keep |= static_cast<uint32_t>(flash::keep_bit(e, static_cast<uint32_t>(bh), gq, gk, sk))
                << i;
      }
    }

    // S = Q.K^T and dP = dO.V^T for this warp's 16 q rows x 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qa[4], da[4];
      tc::ldsm_x4(qa, Qs + (qw + lrA) * P + 16 * kd + lcA);
      tc::ldsm_x4(da, dOs + (qw + lrA) * P + 16 * kd + lcA);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4(b, Kt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        tc::mma_bf16(s + 8 * n2, qa, b);
        tc::mma_bf16(s + 8 * n2 + 4, qa, b + 2);
        tc::ldsm_x4(b, Vt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        tc::mma_bf16(dp + 8 * n2, da, b);
        tc::mma_bf16(dp + 8 * n2 + 4, da, b + 2);
      }
    }

    // dS (into dp)
    const bool edge = q0 + kBQ > sq || k0 + kBK > sk || (causal && offset + q0 < k0 + kBK - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qq = qw + g + 8 * ((i >> 1) & 1);
      const int kk = 8 * (i >> 2) + t2 + (i & 1);
      const int gq = q0 + qq, gk = k0 + kk;
      const bool ok = !edge || (gq < sq && gk < sk && (!causal || offset + gq >= gk));
      float bias = 0.f;
      if (EXT) {
        if (kbias_b != nullptr)
          bias = kbt[kk];
        else if (fbias_bh != nullptr && gq < sq && gk < sk)
          bias = fbias_bh[gq * e.fb_q + gk * e.fb_k];
      }
      const float kf = DROP && !((keep >> i) & 1u) ? 0.f : e.inv_keep;
      // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
      // exp(mask - lse) is 0 for every finite lse
      dp[i] = ok ? tc::bwd::probs<EXT>(s[i], dp[i], bias, kf, has_bias, DROP, lse_s[qq],
                                        delta_s[qq], sm_scale).ds
                 : 0.f;
    }

    // dQ += dS.K (B = K read transposed), dS rounded to bf16 as the
    // register A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      tc::pack_a(sa, dp, kk);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, Kt + (16 * kk + lrA) * P + 16 * n2 + lcA);
        tc::mma_bf16(dq_acc + 8 * n2, sa, b);
        tc::mma_bf16(dq_acc + 8 * n2 + 4, sa, b + 2);
      }
    }
  }
  tc::cp_async_wait<0>();

  // dq rounded to bf16 once
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gq = q0 + qw + g + 8 * hh;
    if (gq < sq) {
      bf16* row = dq + (static_cast<size_t>(bh) * sq + gq) * D + t2;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(row + 8 * n) =
            tc::pack_bf16(dq_acc[4 * n + 2 * hh], dq_acc[4 * n + 2 * hh + 1]);
    }
  }
}

// B6b: the key-tile walk of flash_tc.cuh without dq
template <int D, bool EXT, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const Ext e, bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                        int sk, int causal, float sm_scale) {
  tc::bwd::kv_tile_walk<D, EXT, DROP, false>(q, k, v, dout, lse, delta, e, nullptr, dk, dv, sq,
                                             sk, causal, sm_scale);
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
  constexpr int bytes = DqSmem<D>::kBytes;
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
      static_cast<bf16*>(a.out1), a.sq, a.sk, a.causal, a.sm_scale);
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

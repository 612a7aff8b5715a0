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
// of a q tile and a key tile: 53 M at that shape; as scalar atomics they
// kept the kernel at ~0.35 ms on the card, as a bulk reduction a row at
// ~0.25); with dropout, Threefry's ~75 integer operations a score
// outweigh the products, as in the forward.
//
// Why mma.sync and not wgmma: three of the five products read an operand
// transposed (dO and Q for dV and dK, K and dS^T for dQ) and two take a
// register operand built from the score tile; ldmatrix's .trans form
// gives each of those fragments from one row-major tile in shared memory,
// where wgmma would need each tile in two swizzled layouts.  mma.sync is
// the class of FlashAttention-2's backward, the kernel behind PyTorch's
// SDPA backward on this card.
//
// What the design does: the decomposition of flash_bwd.cu.  One block of
// four warps owns one (64-row K/V tile, batch*head): K and V stay in
// shared memory while the block walks the q tiles from the causal lower
// bound to the end, the next q tile's Q, dO, lse and delta loading by
// cp.async while the current one computes.  Warp w owns keys 16w..16w+15:
//   S^T = K.Q^T and dP^T = V.dO^T (16 x 64 each, f32 accumulators);
//   P^T and dS^T formed on those accumulators with the bias, mask, lse,
//   delta and keep factor, then rounded to bf16 in registers;
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//   operands (the accumulator layout of two 8-column chunks is the A
//   layout of one 16-deep step), dk and dv held in registers;
//   dS^T staged to shared memory, and dQ += dS.K for q rows 16w..16w+15,
//   staged in the q tile's spent Q/dO buffer and added into the f32
//   buffer one row at a time by cp.reduce.async.bulk (an f32 add in L2;
//   blocks add in no fixed order, so the order of dq's sum varies
//   between runs).
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

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kPS = kBK + 8;  // row pitch (elements) of the staged dS^T tile

template <int D>
struct Smem {
  static constexpr int kP = D + 8;               // row pitch (elements) of a Q/dO/K/V tile
  static constexpr int kTile = 64 * kP;          // elements of a tile
  static constexpr int kBytes = 2 * (6 * kTile + kBK * kPS) + 4 * 4 * kBQ;
};

// rows [r0, r0 + 64) of a (T, D) bf16 matrix into a padded tile, 16 bytes a
// copy; rows past T zeroed
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = r0 + r < T;
    const bf16* s = src + static_cast<size_t>(in ? r0 + r : 0) * D + 8 * c;
    tc::cp_async16(dst + r * Smem<D>::kP + 8 * c, s, in);
  }
}

// dV's probability (p times the keep factor) and dS of one score from its S
// and dP, in f32, each step rounded as the f32 body rounds it
struct Probs {
  float pd, ds;
};
template <bool EXT>
__device__ __forceinline__ Probs probs(float s, float dp, float bias, float kf, bool has_bias,
                                       bool drop, float lse, float delta, float sm_scale) {
  float x;
  if (EXT) {
    x = __fmul_rn(s, sm_scale);
    if (has_bias) x = __fadd_rn(x, bias);
  } else {
    x = s * sm_scale;
  }
  const float p = expf(x - lse);
  float pd = p;
  if (EXT && drop) {
    pd = __fmul_rn(p, kf);
    dp = __fmul_rn(dp, kf);
  }
  return {pd, p * (dp - delta) * sm_scale};
}

template <int D, bool EXT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta, const Ext e,
                    float* __restrict__ dq32, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int sq, int sk, int causal, float sm_scale) {
  using S = Smem<D>;
  constexpr int P = S::kP;
  constexpr int ND = D / 8;  // 8-column chunks of a d-wide accumulator
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + S::kTile;
  bf16* Qs = Vs + S::kTile;        // two buffers, each a Q tile then a dO tile
  bf16* dOs = Qs + S::kTile;
  bf16* dSt = Qs + 4 * S::kTile;   // kBK x kPS: dS^T, keys as rows
  float* lse_s = reinterpret_cast<float*>(dSt + kBK * kPS);  // two buffers of kBQ
  float* delta_s = lse_s + 2 * kBQ;                          // two buffers of kBQ

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int kw = 16 * warp;  // this warp's keys in the tile (and q rows for dQ)
  // ldmatrix addressing: the row and column a lane points at
  const int lrA = (lane & 7) + 8 * ((lane >> 3) & 1), lcA = 8 * (lane >> 4);  // A, row-major
  const int lrB = (lane & 7) + 8 * (lane >> 4), lcB = 8 * ((lane >> 3) & 1);  // B from [n][k]
  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* dob = dout + static_cast<size_t>(bh) * sq * D;
  const float* lseb = lse + static_cast<size_t>(bh) * sq;
  const float* deltab = delta + static_cast<size_t>(bh) * sq;
  float* dqb = dq32 + static_cast<size_t>(bh) * sq * D;

  const int offset = sk - sq;  // end-aligned causal offset
  // the first q tile with a row that sees key k0: offset + gq >= k0
  const int q_lo = causal ? max(0, k0 - offset) / kBQ : 0;
  const int n_qt = (sq + kBQ - 1) / kBQ;

  auto load_q_tile = [&](int t, int buf) {
    const int q0 = t * kBQ;
    load_tile<D>(Qs + 2 * buf * S::kTile, qb, q0, sq, tid);
    load_tile<D>(dOs + 2 * buf * S::kTile, dob, q0, sq, tid);
    const int r = tid & 63;
    const bool in = q0 + r < sq;
    if (tid < 64)
      tc::cp_async4(lse_s + buf * kBQ + r, lseb + (in ? q0 + r : 0), in);
    else
      tc::cp_async4(delta_s + buf * kBQ + r, deltab + (in ? q0 + r : 0), in);
  };

  load_tile<D>(Ks, k + static_cast<size_t>(bh) * sk * D, k0, sk, tid);
  load_tile<D>(Vs, v + static_cast<size_t>(bh) * sk * D, k0, sk, tid);
  if (q_lo < n_qt) load_q_tile(q_lo, 0);
  tc::cp_async_commit();

  // the key-row bias of this thread's two keys (rows g and g + 8 of its warp's 16)
  float kbv[2] = {0.f, 0.f};
  if (EXT && e.kbias != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gk = k0 + kw + g + 8 * hh;
      kbv[hh] = gk < sk ? e.kbias[static_cast<long long>(bh / e.H) * sk + gk] : 0.f;
    }
  }
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;
  const bool has_bias = EXT && (e.kbias != nullptr || e.fbias != nullptr);
  const bool drop = EXT && e.dropout;

  float dk_acc[ND * 4], dv_acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = q_lo; t < n_qt; ++t) {
    const int buf = (t - q_lo) & 1;
    const int q0 = t * kBQ;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < n_qt) {
      load_q_tile(t + 1, buf ^ 1);
      tc::cp_async_commit();
    }
    const bf16* Qt = Qs + 2 * buf * S::kTile;
    const bf16* dOt = dOs + 2 * buf * S::kTile;
    const float* lse_t = lse_s + buf * kBQ;
    const float* delta_t = delta_s + buf * kBQ;

    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 keys x 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      tc::ldsm_x4(ka, Ks + (kw + lrA) * P + 16 * kd + lcA);
      tc::ldsm_x4(va, Vs + (kw + lrA) * P + 16 * kd + lcA);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4(b, Qt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        tc::mma_bf16(st + 8 * n2, ka, b);
        tc::mma_bf16(st + 8 * n2 + 4, ka, b + 2);
        tc::ldsm_x4(b, dOt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        tc::mma_bf16(dpt + 8 * n2, va, b);
        tc::mma_bf16(dpt + 8 * n2 + 4, va, b + 2);
      }
    }

    // P^T (times keep, into st) and dS^T (into dpt); element i sits at key
    // kw + g + 8 * ((i >> 1) & 1), query 8 * (i >> 2) + t2 + (i & 1)
    const bool edge = q0 + kBQ > sq || k0 + kBK > sk || (causal && offset + q0 < k0 + kBK - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int qq = 8 * (i >> 2) + t2 + (i & 1);
      const int gq = q0 + qq, gk = k0 + kw + g + 8 * hh;
      const bool ok = !edge || (gq < sq && gk < sk && (!causal || offset + gq >= gk));
      float bias = 0.f, kf = 1.f;
      if (EXT) {
        if (e.kbias != nullptr)
          bias = hh ? kbv[1] : kbv[0];
        else if (fbias_bh != nullptr && gq < sq && gk < sk)
          bias = fbias_bh[gq * e.fb_q + gk * e.fb_k];
        if (drop) kf = flash::keep_factor(e, static_cast<uint32_t>(bh), gq, gk, sk);
      }
      // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
      // exp(mask - lse) is 0 for every finite lse
      const Probs r = ok ? probs<EXT>(st[i], dpt[i], bias, kf, has_bias, drop, lse_t[qq],
                                      delta_t[qq], sm_scale)
                         : Probs{0.f, 0.f};
      st[i] = r.pd;
      dpt[i] = r.ds;
    }

    // dS^T rounded to bf16 into this warp's 16 rows of the dS^T tile (keys
    // as rows, queries as columns), for dQ
    bf16* Tw = dSt + kw * kPS;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<uint32_t*>(Tw + g * kPS + 8 * c + t2) =
          tc::pack_bf16(dpt[4 * c], dpt[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(Tw + (g + 8) * kPS + 8 * c + t2) =
          tc::pack_bf16(dpt[4 * c + 2], dpt[4 * c + 3]);
    }

    // dV += P^T.dO, then dK += dS^T.Q (B = dO / Q read transposed), P^T and
    // dS^T rounded to bf16 as register A operands
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4], sa[4];
      tc::pack_a(pa, st, kq);
      tc::pack_a(sa, dpt, kq);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, dOt + (16 * kq + lrA) * P + 16 * n2 + lcA);
        tc::mma_bf16(dv_acc + 8 * n2, pa, b);
        tc::mma_bf16(dv_acc + 8 * n2 + 4, pa, b + 2);
        tc::ldsm_x4_t(b, Qt + (16 * kq + lrA) * P + 16 * n2 + lcA);
        tc::mma_bf16(dk_acc + 8 * n2, sa, b);
        tc::mma_bf16(dk_acc + 8 * n2 + 4, sa, b + 2);
      }
    }
    __syncthreads();  // dS^T is whole

    // dQ[16 rows of this warp] += dS.K, into the f32 buffer
    float dq_acc[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) dq_acc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      tc::ldsm_x4_t(sa, dSt + (16 * kk + lrB) * kPS + kw + lcB);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, Ks + (16 * kk + lrA) * P + 16 * n2 + lcA);
        tc::mma_bf16(dq_acc + 8 * n2, sa, b);
        tc::mma_bf16(dq_acc + 8 * n2 + 4, sa, b + 2);
      }
    }
    // stage the warp's 16 rows in this tile's Q/dO buffer (read by no warp
    // after dS^T was whole), then add each row into the f32 buffer with one
    // bulk reduction
    float* stg = reinterpret_cast<float*>(Qs + 2 * buf * S::kTile);
    constexpr int SP = D + 8;  // row pitch (floats) of the staged dq tile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(stg + (kw + g + 8 * hh) * SP + 8 * n + t2) =
            make_float2(dq_acc[4 * n + 2 * hh], dq_acc[4 * n + 2 * hh + 1]);
    tc::fence_async_smem();
    __syncwarp();
    if (lane < 16 && q0 + kw + lane < sq) {
      tc::bulk_reduce_add_f32(dqb + static_cast<size_t>(q0 + kw + lane) * D,
                              stg + (kw + lane) * SP, D * 4);
      tc::bulk_commit();
      tc::bulk_wait_read();  // the staging rows may be overwritten after this
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gk = k0 + kw + g + 8 * hh;
    if (gk < sk) {
      const size_t base = (static_cast<size_t>(bh) * sk + gk) * D + t2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(dk + base + 8 * n) =
            tc::pack_bf16(dk_acc[4 * n + 2 * hh], dk_acc[4 * n + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * n) =
            tc::pack_bf16(dv_acc[4 * n + 2 * hh], dv_acc[4 * n + 2 * hh + 1]);
      }
    }
  }
}

// the arguments every launch passes on unchanged
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq32, *dk, *dv;
  Ext e;
  int BH, sq, sk, causal;
  float sm_scale;
  cudaStream_t st;
};

template <int D, bool EXT>
int launch(const Args& a) {
  constexpr int bytes = Smem<D>::kBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_kernel<D, EXT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  dim3 grid((a.sk + kBK - 1) / kBK, a.BH);
  flash_bwd_tc_kernel<D, EXT><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.e, static_cast<float*>(a.dq32),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_ext(const Args& a) {
  if (a.e.kbias == nullptr && a.e.fbias == nullptr && !a.e.dropout) return launch<D, false>(a);
  return launch<D, true>(a);
}

}  // namespace

// The bf16 backward: q, k, v, dout, dk and dv bf16 (B*H, T, d), contiguous
// and 16-byte aligned (cp.async's rule); the other arguments as
// ds_flash_bwd's (flash_bwd.cu), whose dtype must be 1.  Returns a
// cudaError_t.
extern "C" int ds_flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq32, void* dk, void* dv,
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
  const Args a{q, k, v, dout, lse, delta, dq32, dk, dv, e, BH, sq, sk, causal, sm_scale,
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

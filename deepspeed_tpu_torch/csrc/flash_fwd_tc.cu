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
// batch*head).  Warp 4 is the producer: one lane loads the Q tile once
// and keeps the K/V tiles of the (b, h) in flight through TMA into a ring
// of four stages (three at d 128), each guarded by a "full" mbarrier
// (transaction bytes) and an "empty" one (the consumers' 128 arrivals).
// Warps 0-3 are one consumer warpgroup owning the 64 query rows: S =
// Q.K^T by wgmma m64n64k16 with both operands in shared memory; the
// scale, bias, mask, online softmax (base 2, on the special-function
// unit) and keep factor on the accumulator fragments in registers; P
// rounded to bf16 in registers and used as the A operand of O += P.V by
// wgmma m64n{d}k16 with V read transposed from shared memory.  The next
// tile's S and this tile's P.V are issued together, and the next tile's
// softmax runs while P.V is on the tensor cores (FlashAttention-3's
// overlap within a warpgroup); nothing is in flight across an
// iteration, so the compiler keeps the products asynchronous.  Every
// score stays on chip; key tiles wholly above the causal diagonal
// are never loaded and only tiles that cross it (or the ragged end) are
// masked; the causal grid walks the heaviest query tiles first.  Tensor
// maps are 3-D (d, T, B*H), so rows past T arrive as zeros and never as
// the next head's rows; they are masked in-kernel, so any T is served.
// The tiles are stored as TMA writes them with the 128-byte swizzle
// (64-byte at d 32, 32-byte at d 16; d 128 as two 64-column sub-tiles),
// and the wgmma descriptors name the same swizzle.
#include <cuda.h>
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
constexpr int kThreads = 160;  // one consumer warpgroup and the producer warp

// the shared-memory layout of a 64-row tile of head dim D
template <int D>
struct Tile {
  static constexpr int kW = D > 64 ? 64 : D;                 // columns in a sub-tile
  static constexpr int kRowBytes = kW * 2;                    // the swizzle width
  static constexpr int kSubs = D / kW;                        // sub-tiles (2 at d 128)
  static constexpr int kSubBytes = 64 * kRowBytes;
  static constexpr int kBytes = kSubs * kSubBytes;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // K/V ring depth: a stage is released after its P.V, which overlaps the
  // next tile's softmax, so three or four stages keep the loads ahead
  static constexpr int kStages = D > 64 ? 3 : 4;
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024;  // Q, K/V ring, alignment

  // A or B operand stored K-major (d contiguous): the 16 columns of k-step kk
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    const int byte = kk * 32;
    return tc::wgmma_desc(base + (byte / kRowBytes) * kSubBytes + byte % kRowBytes, 16,
                          8 * kRowBytes, kLayout);
  }
  // B operand stored MN-major (V: keys are rows, d contiguous): the 16 keys of k-step kk
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return tc::wgmma_desc(base + kk * 16 * kRowBytes, kSubBytes, 8 * kRowBytes, kLayout);
  }
};

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
  using L = Tile<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], qbar;
  // 1024-byte alignment: the swizzle pattern repeats every 1024 bytes
  const uint32_t raw = tc::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + L::kBytes;                 // kStages tiles
  uint8_t* Vs = Ks + kStages * L::kBytes;       // kStages tiles

  const int n_qt = gridDim.x;
  // causal: the last query tiles see the most keys, so they start first
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int q0 = qt * kBQ;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int offset = sk - sq;  // end-aligned causal offset
  const int kv_end = causal ? min(sk, offset + q0 + kBQ) : sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 128);
    }
    tc::mbar_init(&qbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warp: one lane issues every load -------------------------
    if (tid == 128) {
      tc::mbar_arrive_expect_tx(&qbar, L::kBytes);
      for (int sub = 0; sub < L::kSubs; ++sub)
        tc::tma_load_3d(Qs + sub * L::kSubBytes, &qmap, &qbar, sub * L::kW, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // the consumers released this stage's previous tile, t - kStages
        if (t >= kStages) tc::mbar_wait(&empty[s], ((t / kStages) + 1) & 1);
        tc::mbar_arrive_expect_tx(&full[s], 2 * L::kBytes);
        for (int sub = 0; sub < L::kSubs; ++sub) {
          tc::tma_load_3d(Ks + s * L::kBytes + sub * L::kSubBytes, &kmap, &full[s], sub * L::kW,
                          t * kBK, bh);
          tc::tma_load_3d(Vs + s * L::kBytes + sub * L::kSubBytes, &vmap, &full[s], sub * L::kW,
                          t * kBK, bh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows, two a thread ---------------------
  constexpr int NO = D / 2;  // output accumulators a thread holds
  constexpr float kLog2e = 1.4426950408889634f;
  const int warp = tid >> 5, lane = tid & 31;
  const int rA = warp * 16 + (lane >> 2);  // tile rows rA and rA + 8
  const int cq = 2 * (lane & 3);           // first column of the thread's pair in a chunk
  const uint32_t sQ = tc::smem_addr(Qs), sK = tc::smem_addr(Ks), sV = tc::smem_addr(Vs);
  const float scale2 = sm_scale * kLog2e;
  const float* kbias_row = EXT && e.kbias != nullptr ? e.kbias + static_cast<long long>(bh / e.H) * sk
                                                     : nullptr;
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;

  // S = Q.K^T of the tile in stage s into sc (f32), issued and committed
  float sc[32];
  auto issue_s = [&](int s) {
    tc::fence_regs<32>(sc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::wgmma_ss_n64(sc, L::kmajor(sQ, kk), L::kmajor(sK + s * L::kBytes, kk), kk > 0);
    tc::wgmma_commit();
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // the softmax state in base 2: m is the row's running max of s * log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // the key-row bias of the thread's 16 columns of a tile, loaded before
  // the tile's S is issued, so the loads' latency hides under it
  float kbc[16];
  auto load_kbias = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int gk = k0 + 8 * (c >> 1) + cq + (c & 1);
      kbc[c] = gk < sk ? kbias_row[gk] : 0.f;
    }
  };

  // key tile t's softmax on sc: scale, bias, mask, the running max and
  // sum, alpha (the factor O takes before this tile's P.V), and p (times
  // the keep factor) left in sc
  auto softmax = [&](int t) {
    const int k0 = t * kBK;
    // element i sits at row rA + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + cq + (i & 1)
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > offset + q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int row = rA + 8 * h;
      const int gk = k0 + 8 * (i >> 2) + cq + (i & 1);
      float x;
      if (EXT) {
        x = __fmul_rn(sc[i], sm_scale);
        if (kbias_row != nullptr) {
          x = __fadd_rn(x, kbc[2 * (i >> 2) + (i & 1)]);
        } else if (fbias_bh != nullptr) {
          const int gq = q0 + row;
          x = __fadd_rn(x, gq < sq && gk < sk ? fbias_bh[gq * e.fb_q + gk * e.fb_k] : 0.f);
        }
        x *= kLog2e;
      } else {
        x = sc[i] * scale2;
      }
      // a masked key weighs exp(mask - m) = 0 in the Pallas kernel once the
      // row has seen a real key, which end-aligned causal rows always have
      // in their first tile; so masked keys drop out here
      if (edge && !(gk < sk && (!causal || offset + q0 + row >= gk))) x = -INFINITY;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no key yet subtracts 0, so its masked scores give 0, not NaN
      mu[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = tc::ex2(m[h] - mu[h]);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = tc::ex2(sc[i] - mu[h]);
      ls[h] += p;  // the softmax statistics take the full p
      float pv = p;
      if (EXT && e.dropout)
        pv = __fmul_rn(p, flash::keep_factor(e, static_cast<uint32_t>(bh), q0 + rA + 8 * h,
                                             k0 + 8 * (i >> 2) + cq + (i & 1), sk));
      sc[i] = pv;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
      l[h] = alpha[h] * l[h] + ls[h];
    }
  };

  // O = O * alpha + P.V of key tile t, P (rounded to bf16) the register A
  // operand; issued and committed
  uint32_t pa[4][4];
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    tc::fence_regs<NO>(o);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_rs<D>(o, pa[kk], L::mnmajor(sV + (t % kStages) * L::kBytes, kk));
    tc::wgmma_commit();
  };

  // Each step issues the next tile's S and this tile's P.V, then runs the
  // next tile's softmax while P.V is on the tensor cores.  No product is
  // in flight across an iteration, so the compiler can see which group
  // each wait retires and keeps the products asynchronous.
  tc::mbar_wait(&qbar, 0);
  tc::mbar_wait(&full[0], 0);
  if (kbias_row != nullptr) load_kbias(0);
  issue_s(0);
  tc::wgmma_wait<0>();
  tc::fence_regs<32>(sc);
  softmax(0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) tc::pack_a(pa[kk], sc, kk);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    tc::mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
    if (kbias_row != nullptr) load_kbias((t + 1) * kBK);
    issue_s((t + 1) % kStages);
    issue_pv(t);
    tc::wgmma_wait<1>();  // the next S is done; P.V may still run
    tc::fence_regs<32>(sc);
    softmax(t + 1);
    tc::wgmma_wait<0>();  // P.V is done: its registers and its stage are free
    tc::fence_regs<NO>(o);
    tc::mbar_arrive(&empty[t % kStages]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::pack_a(pa[kk], sc, kk);
  }
  issue_pv(n_tiles - 1);
  tc::wgmma_wait<0>();
  tc::fence_regs<NO>(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + rA + 8 * h;
    if (gq >= sq) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = out + (static_cast<size_t>(bh) * sq + gq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) =
          tc::pack_bf16(o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * sq + gq] =
          l[h] == 0.f ? INFINITY : m[h] * 0.6931471805599453f + logf(fmaxf(l[h], 1e-37f));
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over a (BH, T, D) bf16 tensor, 64-row boxes of the tile's
// sub-tile width, swizzled as the wgmma descriptors read it
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int BH, int T) {
  using L = Tile<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kW), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = L::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const Ext& e,
           int BH, int sq, int sk, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map<D>(&qm, q, BH, sq);
  if (!err) err = make_map<D>(&km, k, BH, sk);
  if (!err) err = make_map<D>(&vm, v, BH, sk);
  if (err) return err;
  constexpr int bytes = Tile<D>::kSmem;
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

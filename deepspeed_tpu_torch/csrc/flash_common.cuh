// Device functions shared by the flash-attention kernels: flash_fwd.cu and
// flash_fwd_tc.cu (B1), flash_bwd.cu and flash_bwd_tc.cu (B2),
// flash_bwd_2pass.cu and flash_bwd_2pass_tc.cu (B6a, B6b), splash_attn.cu
// (B8, B9a, B9b) and splash_attn_tc.cu (B9a, B9b).  One copy of the score
// tile, the two bias forms, the dropout keep factor, a block-sparse
// layout's geometry and B2's walk with its ordered dq sum, so the forward
// and the backwards cannot drift apart.
//
// The extended options (``Ext``) are chosen at run time and are uniform
// over a block:
//   * a key-row bias ``kbias`` (B, Tk) f32 (BERT's key-padding mask), or a
//     full bias ``fbias`` read through its four element strides (b, h, row,
//     key), stride 0 on a broadcast dim, so a (B, 1, Tq, Tk) mask is never
//     expanded to (B*H, Tq, Tk) in device memory;
//   * attention-probability dropout with in-kernel Threefry-2x32 bits
//     (deepspeed_tpu/ops/attention/flash_attention.py::_threefry2x32_bits,
//     _drop_keep_tile): key (k0, k1), counter (row * sk + col, b * H + h)
//     in uint32 wrap arithmetic, both absolute positions, so every tiling
//     regenerates the same bits; keep iff bits < threshold, and a kept
//     score is scaled by inv_keep = 1 / keep_prob (f32), a dropped one by 0.
// The bias is added in f32 after the scale, each step rounded on its own:
// s = (q.k) * scale + bias.  Dropout touches only the value path (the
// forward's m, l and lse come from the full p) and, in the backward, dV's
// p and dp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per tile row
constexpr int kPP = kBK + 1;   // row stride of a (kBQ x kBK) float tile in shared memory

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, kept as a float
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

struct Ext {
  const float* kbias;  // (BH / H, sk) or null
  const float* fbias;  // through the strides below, or null
  long long fb_b, fb_h, fb_q, fb_k;
  int H;
  int dropout;
  uint32_t k0, k1, threshold;
  float inv_keep;
};

// shared-memory floats the staged bias takes: the key row always (a few
// floats), the full (kBQ x kBK) tile only when there is a full bias
__host__ __device__ inline int bias_smem_floats(const Ext& e) {
  return kBK + (e.fbias != nullptr ? kBQ * kPP : 0);
}

// first output word of 20-round Threefry-2x32 (the Random123 / jax.random
// schedule) on counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ uint32_t threefry2x32_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                      uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
    x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0;
}

// whether dropout keeps score (gq, gk) of batch*head bh
__device__ __forceinline__ bool keep_bit(const Ext& e, uint32_t bh, int gq, int gk, int sk) {
  const uint32_t x0 = static_cast<uint32_t>(gq) * static_cast<uint32_t>(sk) + static_cast<uint32_t>(gk);
  return threefry2x32_bits(e.k0, e.k1, x0, bh) < e.threshold;
}

// the dropout factor of score (gq, gk) of batch*head bh: inv_keep if kept, else 0
__device__ __forceinline__ float keep_factor(const Ext& e, uint32_t bh, int gq, int gk, int sk) {
  return keep_bit(e, bh, gq, gk, sk) ? e.inv_keep : 0.f;
}

// a block-sparse layout's geometry (splash_attn.cu, splash_attn_tc.cu)
struct SplashGeom {
  int T, block, nb;
  int tiles;  // 64-row tiles of a layout block, ceil(block / 64)
  int H, LH;  // heads, and the layout's heads (1: head-uniform)
  int causal;
  float scale;
};

// the layout row of batch*head bh: 0 for a head-uniform layout, else its head
__device__ __forceinline__ int layout_head(const SplashGeom& g, size_t bh) {
  return g.LH == 1 ? 0 : static_cast<int>(bh % g.H);
}

// The single-pass backward's walk and its ordered dq sum (B2, both bodies;
// B6b walks B2's way so that its dk and dv are B2's bits).  Key tile kt
// visits the q tiles [lo, n_qt), lo the causal lower bound, and the key
// tiles that visit q tile t add their dq shares into it one at a time, in
// a fixed order, through an int32 counter a (batch*head, q tile) that the
// caller zeroes: kt waits until the counter reads its rank, adds, and
// passes the turn on (rank + 1) once its adds are done.  The walk makes
// each key tile's predecessor in that order reach the q tile one step of
// its walk earlier, so the turn is waiting when a block gets there and the
// order costs no idle time once the walks run (where every key tile
// reaches a q tile at the same step, its turns pass down a chain of blocks
// one hand-off after another, and each step waits for the whole chain):
//   * causal: each key tile walks up from its bound; tile t is summed in
//     descending key tile, kmax(t) first (the key tiles that reach t are
//     0..kmax(t), contiguous from 0; the higher one reaches it earlier);
//   * full, square, `rotate`: key tile kt starts its walk at q tile kt and
//     wraps around, so it reaches t at step (t - kt) mod n, the order of
//     tile t's sum (t first, then t - 1, ...);
//   * full, otherwise: every key tile walks up from 0, tile t is summed in
//     descending key tile (a key tile waits for the one above it).
// A block waits on blocks of its own blockIdx.y only, and every wait ends:
//   * by default the key tiles map to blockIdx.x in reverse (kt = n_kt - 1
//     - blockIdx.x), so each block waits on a lower blockIdx.x, which the
//     grid (key tiles, batch*head), x fastest, dispatches first (in-order
//     block dispatch, as FlashAttention-3's deterministic backward relies
//     on) - except in the rotated walk, whose key tile n - 1 waits on key
//     tile 0: it rotates only where all of a batch*head's key tiles are
//     resident on the card at once (the launcher asks the occupancy
//     calculator), so the block it waits on is resident or will be;
//   * where a batch*head's key tiles take at most a quarter of the
//     resident blocks (`natural`), blockIdx.x is the key tile: the longest
//     causal walks go first, and a batch*head's blocks are dispatched
//     together, so waiting on a higher blockIdx.x costs nothing.
// (Residency here assumes that no kernel launched beside this one on
// another stream holds the card's blocks while waiting on it: the port's
// engines launch on one stream.)
struct QTileWalk {
  int kt, n_kt, lo, m, st, offset, causal, rotate;
  __device__ __forceinline__ QTileWalk(int block_x, int sq, int sk, int causal_, int rotate_,
                                       int natural)
      : causal(causal_), rotate(rotate_) {
    n_kt = (sk + kBK - 1) / kBK;
    kt = natural ? block_x : n_kt - 1 - block_x;
    offset = sk - sq;  // end-aligned causal offset
    // the first q tile with a row that sees key kt * kBK: offset + gq >= k0
    lo = causal ? max(0, kt * kBK - offset) / kBQ : 0;
    m = max(0, (sq + kBQ - 1) / kBQ - lo);
    st = rotate && m > 0 ? kt % m : 0;
  }
  // the q tile of step s, s in [0, m)
  __device__ __forceinline__ int tile(int s) const {
    return lo + (st + s < m ? st + s : st + s - m);
  }
  // this key tile's place in the order of q tile t's dq sum
  __device__ __forceinline__ int rank(int t) const {
    if (rotate) return t >= kt ? t - kt : t - kt + m;  // m == n_kt
    const int kmax = causal ? min(n_kt - 1, (kBQ * (t + 1) + offset - 1) / kBK) : n_kt - 1;
    return kmax - kt;
  }
};

// B2's walk on the host, for a card whose SMs hold `per_sm` blocks each:
// whether blockIdx.x is the key tile (`natural`) and whether the full
// square walk rotates.  The rotation is decided on a card of at least 2
// blocks an SM where d <= 64 (both bf16 bodies' every variant holds that
// many) and 1 else, so that B2 and B6b agree on it; B2 takes it only where
// all of a batch*head's blocks are resident at once.
struct WalkPlan {
  int natural, rotate;
};
__host__ inline WalkPlan plan_walk(int sq, int sk, int d, int causal, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return {0, 0};
  const long long n_kt = (sk + kBK - 1) / kBK, slots = static_cast<long long>(sms) * per_sm;
  const bool rotate =
      !causal && sq == sk && n_kt <= static_cast<long long>(sms) * (d <= 64 ? 2 : 1);
  return {4 * n_kt <= slots, rotate && n_kt <= slots};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// a block's turn in a q tile's dq sum: wait (one thread, then the block at
// a barrier) until the counter reads `rank`; after the adds, pass it on.
// Every thread's adds come before the second barrier, and the release
// store after it makes them visible before the counter moves (the release
// is cumulative over what the barrier ordered before it; the tensor-core
// walk passes its turn at its next step's barrier instead)
__device__ __forceinline__ void wait_turn(const int* turn, int rank) {
  if (threadIdx.x == 0)
    while (ld_acquire(turn) != rank) {
    }
  __syncthreads();
}
__device__ __forceinline__ void pass_turn(int* turn, int rank) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(turn, rank + 1);
}

// stage the bias of query rows [q0, q0 + kBQ) x keys [k0, k0 + kBK) of
// batch*head bh: the key-row form into Bk[kk], the full form into
// Bt[rr * kPP + kk] (consecutive threads read consecutive keys); 0 off the
// ragged edge.  The caller synchronizes before reading.
__device__ __forceinline__ void stage_bias(const Ext& e, float* Bk, float* Bt, size_t bh, int q0,
                                           int k0, int sq, int sk, int tid) {
  if (e.kbias != nullptr) {
    if (tid < kBK) Bk[tid] = k0 + tid < sk ? e.kbias[(bh / e.H) * sk + k0 + tid] : 0.f;
  } else if (e.fbias != nullptr) {
    const float* base = e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                        static_cast<long long>(bh % e.H) * e.fb_h;
    for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
      const int rr = idx / kBK, kk = idx % kBK;
      const int gq = q0 + rr, gk = k0 + kk;
      Bt[rr * kPP + kk] = gq < sq && gk < sk ? base[gq * e.fb_q + gk * e.fb_k] : 0.f;
    }
  }
}

// the scaled score plus the staged bias of tile row rr, key kk
__device__ __forceinline__ float biased_score(const Ext& e, float dot, float scale, const float* Bk,
                                              const float* Bt, int rr, int kk) {
  const float s = __fmul_rn(dot, scale);
  if (e.kbias != nullptr) return __fadd_rn(s, Bk[kk]);
  if (e.fbias != nullptr) return __fadd_rn(s, Bt[rr * kPP + kk]);
  return s;
}

// The backward's score tile, for every backward kernel: the thread owning
// row r (quarter c) of the staged Q / dO tile computes, for keys c + 4i of
// the staged K / V tile,
//   p  = exp(s - lse)          (s biased as above; 0 where masked)
//   pd = p * keep              (dV's probability, rounded to dO's type) -> Ps
//   ds = p * (dp * keep - delta) * scale (rounded to q's type)          -> dSs
// with keep the dropout factor (1 without dropout).  Without EXT this is
// the bias-free code of the first backward kernel, unchanged; WANT_P =
// false (the dq pass) skips Ps.  T is the operands' type.
template <typename T, int D, bool EXT, bool WANT_P>
__device__ __forceinline__ void score_tile_bwd(const float* Qs, const float* dOs, const float* Ks,
                                               const float* Vs, const float* lse_s,
                                               const float* delta_s, const float* Bk,
                                               const float* Bt, float* Ps, float* dSs,
                                               const Ext& e, uint32_t bh, int q0, int k0, int sq,
                                               int sk, int causal, float sm_scale, int r, int c) {
  constexpr int DP = D + 1;
  const int gq = q0 + r;
  const int qpos = (sk - sq) + gq;  // end-aligned causal position
  const float row_lse = lse_s[r];
  const float row_delta = delta_s[r];
#pragma unroll 4
  for (int i = 0; i < kBK / 4; ++i) {
    const int kk = c + 4 * i;
    const int gk = k0 + kk;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int e2 = 0; e2 < D; ++e2) {
      s += Qs[r * DP + e2] * Ks[kk * DP + e2];
      dp += dOs[r * DP + e2] * Vs[kk * DP + e2];
    }
    const bool ok = gq < sq && gk < sk && (!causal || qpos >= gk);
    // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
    // exp(mask - lse) is 0 for every finite lse
    float p;
    if (EXT) {
      p = !ok ? 0.f : expf(biased_score(e, s, sm_scale, Bk, Bt, r, kk) - row_lse);
    } else {
      p = !ok ? 0.f : expf(s * sm_scale - row_lse);
    }
    float pd = p;
    if (EXT && e.dropout) {
      const float kf = keep_factor(e, bh, gq, gk, sk);
      pd = __fmul_rn(p, kf);
      dp = __fmul_rn(dp, kf);
    }
    if (WANT_P) Ps[r * kPP + kk] = round_to<T>(pd);
    dSs[r * kPP + kk] = round_to<T>(p * (dp - row_delta) * sm_scale);
  }
}

}  // namespace flash

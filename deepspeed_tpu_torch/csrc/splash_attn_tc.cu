// Block-sparse ("splash") attention for Hopper (sm_90a), the bf16 bodies:
// the forward (B8), the dq pass (B9a) and the dk/dv pass (B9b) over (B*H,
// T, d), restricted to the active (query block, key block) pairs of a
// layout, with their products on the tensor cores: the forward by wgmma
// with K/V tiles brought by TMA, the backward by mma.sync with operands
// from shared memory by ldmatrix and tiles brought by double-buffered
// cp.async rings.  Same function and arguments as the f32 bodies of
// splash_attn.cu.
//
// Replaces: deepspeed_tpu/ops/attention/sparse.py::_splash_kernel (B8),
// _splash_dq_kernel (B9a) and _splash_dkv_kernel (B9b) (Pallas, TPU),
// driven there by _splash_fwd / _splash_bwd and here by
// deepspeed_tpu_torch/ops/attention/sparse.py::splash_fwd_cuda,
// splash_bwd_dq_cuda and splash_bwd_dkv_cuda for bf16 tensors (f32 tensors
// take splash_attn.cu).  Ported: the whole contract of the f32 bodies
// (causal inside diagonal blocks or none, head-uniform or per-head
// layouts, any block size dividing T, the optional lse, untouched key
// columns, zero-degree rows).
//
// Rounding points: the Pallas kernels' and the f32 bodies' (bf16 operands
// summed in f32).  The forward's are B1's (flash_fwd_tc.cu): m, l and the
// output accumulator f32, p rounded to bf16 before P.V while l sums the
// unrounded p, a masked score weighing exactly 0, a row with no key
// writing 0 and lse +inf.  The backward's: p = exp(s * scale - lse) in
// f32, rounded to bf16 before the dV product; ds = p (dp - delta) scale
// rounded to bf16 before the dQ and dK products; dq, dk and dv summed in
// f32 and rounded once, from flash_tc.cuh's tc::bwd::probs.  The tensor
// cores sum S and dP in another order than the plain version's GEMMs, so a
// bf16 P or dS next to a rounding tie may round to the other neighbour:
// the check holds the gradients (and the plain version) to the float64
// function within the bound of the bf16 contract
// (sparse.splash_bwd_float64), as for B2 and B6.
//
// What bounds them: the layout's scores (causal inside diagonal blocks) at
// 4 d flops each forward, 6 d for the dq pass (S, dP, dQ) and 8 d for the
// dk/dv pass (S, dP, dV, dK) against a few bytes of q, k, v, dO per score:
// the tensor cores' rate, ~0.018 / 0.027 / 0.036 ms at GPT-2's (1, 12,
// 8192, 64) with its BigBird layout (block 256).  The f32 bodies run those
// dots on the CUDA cores at ~1 % of it.  What the design does: the dense
// attention's walks of flash_tc.cuh, fed by a layout's tiles instead of
// contiguous ones (tc::ListTiles, in shared memory), so nothing of T x T
// size reaches device memory, the inactive blocks are never read, and
// tiles wholly above the causal diagonal are never listed.
//
// B8 and B9a: one block per (64-row q tile of a layout row, batch*head);
// thread 0 lists the row's valid edges in the layout's order, each edge's
// 64-row key tiles up to the causal bound of the q tile's last row, into
// shared memory.  B8 (160 threads) runs tc::fwd::q_tile_walk, B1's walk:
// the listed K/V tiles stream by TMA through a ring of stages (the maps
// are 3-D, so any listed row starts a tile) while one warpgroup's wgmma
// products and online softmax consume them; a q tile with no listed tile
// writes 0 and lse +inf and loads nothing.  B9a (128 threads) runs
// tc::bwd::q_tile_walk (B6a's walk), the next (edge, tile) pair loading
// while the current one computes.  Both sum in registers in the list's
// order and write each row once: no atomics, the same bits every launch.
// B9b: one block per (64-row key tile, work item, batch*head) runs
// tc::bwd::kv_tile_walk (B2's walk without dq) over the item's valid edges
// (its piece of its column's run of the column-sorted edge list), each
// edge's q tiles listed in order, dk and dv in registers.  The items keep
// B9b balanced: BigBird's global column is attended by every row and
// would otherwise be one block's serial walk.  A column held by one item
// (every column but a global one, in practice) writes its dk and dv in
// bf16 directly; an item of a column cut into several writes f32 partials
// (B*H, W, block, d), which a second kernel sums per column in item order,
// so dk and dv are the same bits on every launch and only the split
// columns pay for the partials' round trip.
//
// Rows past a layout block: a 64-row tile of a block of 96 (or 16) also
// holds the next block's rows; the walks mask keys and query rows past the
// tile's length (p = 0), write no out, dq or dk/dv for them, and rows past
// T load as zeros.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tc::bwd::kBK;
using tc::bwd::kBQ;
using tc::bwd::kThreads;

using Geom = flash::SplashGeom;
using flash::layout_head;

// the row's valid key blocks in the layout's order, each cut into its
// 64-row tiles up to the causal bound of the q tile's last row (rows
// [q0, q0 + qn)), listed by first row into k0s; returns their count.  One
// thread (B8, B9a).
__device__ __forceinline__ int list_key_tiles(const int* __restrict__ idx,
                                              const int* __restrict__ valid, int deg,
                                              const Geom& g, int bh, int row, int q0, int qn,
                                              int* k0s) {
  const size_t at = (static_cast<size_t>(layout_head(g, bh)) * g.nb + row) * deg;
  int n = 0;
  for (int j = 0; j < deg; ++j) {
    if (!(valid[at + j] & 1)) continue;
    const int kblk = min(max(idx[at + j], 0), g.nb - 1);
    for (int kt = 0; kt < g.tiles; ++kt) {
      const int k0 = kblk * g.block + kt * kBK;
      if (g.causal && k0 > q0 + qn - 1) break;
      k0s[n++] = k0;
    }
  }
  return n;
}

// B8: one block of 160 threads per (64-row q tile of a layout row,
// batch*head); the list lies past the walk's shared memory
template <int D>
__global__ void __launch_bounds__(tc::fwd::kThreads)
splash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ idx,
                     const int* __restrict__ valid, int deg, const Geom g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int* k0s = reinterpret_cast<int*>(smem_raw + tc::fwd::Tile<D>::kSmem);  // deg * tiles
  __shared__ int n_tiles;
  const int row = blockIdx.x / g.tiles, qt = blockIdx.x % g.tiles;
  const int bh = blockIdx.y;
  const int q0 = row * g.block + qt * kBQ;
  const int qn = min(kBQ, g.block - qt * kBQ);
  if (threadIdx.x == 0) n_tiles = list_key_tiles(idx, valid, deg, g, bh, row, q0, qn, k0s);
  __syncthreads();
  const flash::Ext none{};  // no bias, no dropout
  tc::fwd::q_tile_walk<D, false>(&qmap, &kmap, &vmap, out, lse, none, bh, q0, qn, g.T, g.T,
                                 g.causal, g.scale, tc::ListTiles{k0s, n_tiles, g.block});
}

// B9a: one block per (64-row q tile of a layout row, batch*head)
template <int D>
__global__ void __launch_bounds__(kThreads)
splash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, const int* __restrict__ idx,
                    const int* __restrict__ valid, int deg, const Geom g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int* k0s = reinterpret_cast<int*>(smem_raw + tc::bwd::DqSmem<D>::kBytes);  // deg * tiles
  __shared__ int n_tiles;
  const int row = blockIdx.x / g.tiles, qt = blockIdx.x % g.tiles;
  const int bh = blockIdx.y;
  const int q0 = row * g.block + qt * kBQ;
  const int qn = min(kBQ, g.block - qt * kBQ);
  if (threadIdx.x == 0) n_tiles = list_key_tiles(idx, valid, deg, g, bh, row, q0, qn, k0s);
  __syncthreads();
  const flash::Ext none{};  // no bias, no dropout
  tc::bwd::q_tile_walk<D, false, false>(q, k, v, dout, lse, delta, none, dq, bh, q0, qn, g.T,
                                        g.T, g.causal, g.scale,
                                        tc::ListTiles{k0s, n_tiles, g.block});
}

// B9b: one block per (64-row key tile, work item, batch*head)
template <int D>
__global__ void __launch_bounds__(kThreads)
splash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dk32,
                     float* __restrict__ dv32, const int* __restrict__ qidx,
                     const int* __restrict__ flags, const int* __restrict__ item_col,
                     const int* __restrict__ item_off, const int* __restrict__ col_items, int E,
                     int W, const Geom g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int* q0s = reinterpret_cast<int*>(smem_raw + tc::bwd::Smem<D, false>::kBytes);  // nb * tiles
  __shared__ int n_tiles;
  const int item = blockIdx.x / g.tiles, kt = blockIdx.x % g.tiles;
  const int bh = blockIdx.y;
  const int lh = layout_head(g, bh);
  const int col = item_col[static_cast<size_t>(lh) * W + item];
  if (col < 0 || col >= g.nb) return;  // past this head's items (per-head layouts)
  const int k0 = col * g.block + kt * kBK;
  const int kn = min(kBK, g.block - kt * kBK);
  if (threadIdx.x == 0) {
    // the item's valid query blocks in edge order (a column holds each at
    // most once), each cut into its 64-row tiles, less those wholly above
    // the causal diagonal of the key tile's first key
    const int* off = item_off + static_cast<size_t>(lh) * (W + 1);
    const int e0 = min(max(off[item], 0), E), e1 = min(max(off[item + 1], e0), E);
    const size_t at = static_cast<size_t>(lh) * E;
    int n = 0;
    for (int e = e0; e < e1; ++e) {
      if (!(flags[at + e] & 1)) continue;
      const int qblk = min(max(qidx[at + e], 0), g.nb - 1);
      for (int qt = 0; qt < g.tiles && n < g.nb * g.tiles; ++qt) {
        const int r0 = qblk * g.block + qt * kBQ;
        if (g.causal && r0 + min(kBQ, g.block - qt * kBQ) - 1 < k0) continue;
        q0s[n++] = r0;
      }
    }
    n_tiles = n;
  }
  __syncthreads();
  const int* ci = col_items + static_cast<size_t>(lh) * (g.nb + 1);
  const tc::ListTiles src{q0s, n_tiles, g.block};
  const flash::Ext none{};  // no bias, no dropout
  if (ci[col + 1] - ci[col] <= 1) {  // the column's only item: dk, dv directly
    tc::bwd::kv_tile_walk<D, false, false, false>(
        q, k, v, dout, lse, delta, none, nullptr, nullptr, bh, k0, kn, g.T, g.T, g.causal,
        g.scale, src, tc::bwd::StoreDkv<D>(dk, dv, bh, k0, g.T));
  } else {  // an item of a split column: f32 partial rows of (B*H, W, block, D)
    const size_t part = ((static_cast<size_t>(bh) * W + item) * g.block + kt * kBK) * D;
    float* pk = dk32 + part;
    float* pv = dv32 + part;
    tc::bwd::kv_tile_walk<D, false, false, false>(
        q, k, v, dout, lse, delta, none, nullptr, nullptr, bh, k0, kn, g.T, g.T, g.causal,
        g.scale, src, [=](int kk, int c, float k_lo, float k_hi, float v_lo, float v_hi) {
          *reinterpret_cast<float2*>(pk + kk * D + c) = make_float2(k_lo, k_hi);
          *reinterpret_cast<float2*>(pv + kk * D + c) = make_float2(v_lo, v_hi);
        });
  }
}

// B9b's second pass: one block per (64-row key tile of a column, batch*head)
// sums a split column's item partials in item order and writes dk and dv;
// a column of one item was written by the first pass
__global__ void __launch_bounds__(kThreads)
splash_dkv_tc_sum_kernel(const float* __restrict__ dk32, const float* __restrict__ dv32,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const int* __restrict__ col_items, int W, int D, const Geom g) {
  const int col = blockIdx.x / g.tiles, kt = blockIdx.x % g.tiles;
  const int bh = blockIdx.y;
  const int* ci = col_items + static_cast<size_t>(layout_head(g, bh)) * (g.nb + 1);
  const int i0 = min(max(ci[col], 0), W), i1 = min(max(ci[col + 1], i0), W);
  if (i1 - i0 <= 1) return;
  const int n = min(kBK, g.block - kt * kBK) * D;
  const size_t out0 = (static_cast<size_t>(bh) * g.T + col * g.block + kt * kBK) * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    float a = 0.f, b = 0.f;
    for (int w = i0; w < i1; ++w) {
      const size_t at = ((static_cast<size_t>(bh) * W + w) * g.block + kt * kBK) * D + idx;
      a += dk32[at];
      b += dv32[at];
    }
    dk[out0 + idx] = __float2bfloat16_rn(a);
    dv[out0 + idx] = __float2bfloat16_rn(b);
  }
}

// the arguments every launch passes on unchanged
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;                 // out and lse (B8), dq (B9a), or dk and dv (B9b)
  float *dk32, *dv32;                // B9b's partials (BH, W, block, D)
  const int *ia, *ib;                // idx, valid (B8, B9a); qidx, flags (B9b)
  const int *item_col, *item_off, *col_items;  // B9b's work items
  int n;                             // deg (B8, B9a), E (B9b)
  int W;                             // B9b's items a head
  int BH;
  Geom g;
  cudaStream_t st;
};

// the largest dynamic shared memory a block may take (227 KB)
constexpr int kMaxSmem = 232448;

template <int D>
int launch_fwd(const Args& a) {
  CUtensorMap qm, km, vm;
  cudaError_t err = static_cast<cudaError_t>(
      tc::fwd::make_maps<D>(&qm, &km, &vm, a.q, a.k, a.v, a.BH, a.g.T, a.g.T));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the walk's ring, then the row's listed tiles
  const long long bytes = tc::fwd::Tile<D>::kSmem + 4LL * a.n * a.g.tiles;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(splash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.g.nb * a.g.tiles, a.BH);
  splash_fwd_tc_kernel<D><<<grid, tc::fwd::kThreads, static_cast<int>(bytes), a.st>>>(
      qm, km, vm, static_cast<bf16*>(a.out0), static_cast<float*>(a.out1), a.ia, a.ib, a.n, a.g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a) {
  const int bytes = tc::bwd::DqSmem<D>::kBytes + static_cast<int>(sizeof(int)) * a.n * a.g.tiles;
  cudaError_t err = cudaFuncSetAttribute(splash_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.g.nb * a.g.tiles, a.BH);
  splash_dq_tc_kernel<D><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), a.ia, a.ib, a.n, a.g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a) {
  const int bytes =
      tc::bwd::Smem<D, false>::kBytes + static_cast<int>(sizeof(int)) * a.g.nb * a.g.tiles;
  cudaError_t err = cudaFuncSetAttribute(splash_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.W * a.g.tiles, a.BH);
  splash_dkv_tc_kernel<D><<<grid, kThreads, bytes, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
      a.dk32, a.dv32, a.ia, a.ib, a.item_col, a.item_off, a.col_items, a.n, a.W, a.g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 sum_grid(a.g.nb * a.g.tiles, a.BH);
  splash_dkv_tc_sum_kernel<<<sum_grid, kThreads, 0, a.st>>>(
      a.dk32, a.dv32, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.col_items, a.W, D,
      a.g);
  return static_cast<int>(cudaGetLastError());
}

enum Pass { kFwd, kDq, kDkv };

template <Pass P>
int entry(Args a, int H, int LH, int T, int block, int d, int dtype, int causal,
          float sm_scale) {
  if (dtype != 1 || a.BH < 1 || H < 1 || a.BH % H != 0 || (LH != 1 && LH != H) || T < 1 ||
      block < 1 || T % block != 0 || a.n < 1 || a.BH > 65535 || (P == kDkv && a.W < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bf16 tensors (lse, delta and B8's lse are f32 rows, read one by one)
  const void* out1 = P == kFwd ? nullptr : a.out1;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.out0) | reinterpret_cast<uintptr_t>(out1) |
       reinterpret_cast<uintptr_t>(a.dk32) | reinterpret_cast<uintptr_t>(a.dv32)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nb = T / block;
  const int tiles = (block + kBQ - 1) / kBQ;
  if (static_cast<long long>(P == kDkv ? max(nb, a.W) : nb) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = Geom{T, block, nb, tiles, H, LH, causal, sm_scale};
  switch (d) {
    case 16: return P == kFwd ? launch_fwd<16>(a) : P == kDq ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32: return P == kFwd ? launch_fwd<32>(a) : P == kDq ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64: return P == kFwd ? launch_fwd<64>(a) : P == kDq ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128:
      return P == kFwd ? launch_fwd<128>(a) : P == kDq ? launch_dq<128>(a) : launch_dkv<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B8, bf16: out (BH, T, d) and the optional lse (f32, (BH, T)), each row
// written once.  q, k, v and out bf16, contiguous and 16-byte aligned
// (TMA's rule); the other arguments as ds_splash_fwd's (splash_attn.cu),
// whose dtype must be 1.  Returns a cudaError_t.
extern "C" int ds_splash_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
                                const void* idx, const void* valid, int BH, int H, int LH, int T,
                                int block, int deg, int d, int dtype, int causal, float sm_scale,
                                void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr, nullptr,
         static_cast<const int*>(idx), static_cast<const int*>(valid), nullptr, nullptr, nullptr,
         deg, 0, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kFwd>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

// B9a, bf16: dq (BH, T, d), written once per row.  q, k, v, dout and dq
// bf16, contiguous and 16-byte aligned (cp.async's rule); the other
// arguments as ds_splash_bwd_dq's (splash_attn.cu), whose dtype must be 1.
// Returns a cudaError_t.
extern "C" int ds_splash_bwd_dq_tc(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, const void* idx, const void* valid, int BH, int H,
                                   int LH, int T, int block, int deg, int d, int dtype,
                                   int causal, float sm_scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,
         static_cast<const int*>(idx), static_cast<const int*>(valid), nullptr, nullptr, nullptr,
         deg, 0, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kDq>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

// B9b, bf16: dk and dv (BH, T, d), each row written once: directly for a
// column of one work item, through the f32 partials dk32 / dv32 (BH, W,
// block, d) of the caller's scratch for a split column.  Arguments as
// ds_splash_bwd_dkv's (splash_attn.cu), whose dtype must be 1.  Two kernel
// launches on the stream.
extern "C" int ds_splash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, void* dk32, void* dv32, const void* qidx,
                                    const void* flags, const void* item_col,
                                    const void* item_off, const void* col_items, int BH, int H,
                                    int LH, int T, int block, int E, int W, int d, int dtype,
                                    int causal, float sm_scale, void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, static_cast<float*>(dk32), static_cast<float*>(dv32),
         static_cast<const int*>(qidx), static_cast<const int*>(flags),
         static_cast<const int*>(item_col), static_cast<const int*>(item_off),
         static_cast<const int*>(col_items), E, W, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kDkv>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

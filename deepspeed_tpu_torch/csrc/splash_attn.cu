// Block-sparse ("splash") attention for Hopper (sm_90a), the CUDA-core
// bodies (f32 tensors; bf16 tensors take splash_attn_tc.cu's tensor-core
// bodies): the forward (B8), the dq pass (B9a) and the dk/dv pass (B9b)
// over (B*H, T, d), restricted to the active (query block, key block) pairs
// of a layout.
//
// Replaces: deepspeed_tpu/ops/attention/sparse.py::_splash_kernel (B8),
// _splash_dq_kernel (B9a) and _splash_dkv_kernel (B9b) (Pallas, TPU),
// driven there by _splash_fwd / _splash_bwd and here by
// deepspeed_tpu_torch/ops/attention/sparse.py::splash_fwd_cuda,
// splash_bwd_dq_cuda and splash_bwd_dkv_cuda.  Ported: the whole contract
// (causal inside diagonal blocks or none, head-uniform or per-head layouts,
// any block size dividing T, the optional lse, zero-degree rows).
//
// The layout arrives in two host-built forms (cached per layout):
//   * the row walk, ``idx`` / ``valid`` (LH, nb * deg) int32: row n's
//     active key blocks, padded to the largest degree (B8, B9a);
//   * the column walk, from the column-sorted edge list: ``qidx`` and
//     ``flags`` (LH, E) int32 (bit 0: the edge is valid); the list cut into
//     work items of at most deg valid edges, ``item_col`` (LH, W) and
//     ``item_off`` (LH, W + 1) (item w: edges [item_off[w], item_off[w +
//     1]) of column item_col[w], -1 past a head's items), and
//     ``col_items`` (LH, nb + 1) (column c's items, in order); an untouched
//     column is one item holding one invalid edge (B9b).
// LH is 1 for a head-uniform layout (one row of indices for every head),
// else H (head h reads row h).
//
// Rounding points kept from the Pallas kernels (for parity): the Q.K^T
// and dO.V^T dots take the operands in their own type and sum in f32
// (operands widened exactly in shared memory); the softmax state (m, l)
// and the accumulators are f32; p is rounded to v's type before the P.V
// product while l sums the unrounded p; the backward's p = exp(s * scale -
// lse) and ds = p * (dp - delta) * scale, ds rounded to q's type before the
// dQ and dK products and p to dO's type before the dV product.  A masked
// score is the Pallas kernels' DEFAULT_MASK_VALUE followed by the keep
// mask after exp: it weighs exactly 0, and a row whose every score is
// masked keeps l = 0, writes out 0 and lse = +inf (the backward's p is
// then exactly 0).
//
// What bounds it: like the dense flash kernels, about T_active * d flops
// for every q/k/v byte, so the tensor cores' rate, not bytes, is the floor
// at the main path's shapes (block 256, d 64).  These bodies do their dots
// on the CUDA cores in f32 from shared memory (no wgmma, no TMA).
// What the design does: nothing of T x T size reaches device memory, the
// layout's inactive blocks are never read, key tiles wholly above the
// causal diagonal are skipped, and no output needs atomics: dq (B9a) sums
// a row's edges in registers in the layout's order and is written once;
// dk/dv (B9b) sum an item's edges in registers into an f32 partial, and a
// second kernel sums each column's partials in item order and writes
// dk/dv once, so all three give the same bits on every launch.  The items
// keep B9b balanced: a column attended by every row (BigBird's global
// column) would otherwise be one block's serial walk of T / block query
// blocks, ten times the others', and set the kernel's time.
//
// Tiling: a layout block is cut into 64-row tiles (block 256: four; a
// block below 64 leaves the tile's other rows idle).  B8 and B9a run one
// block of 256 threads per (64-query tile of a layout row, batch*head):
// the row's valid edges are compacted into shared memory (as B5 stages its
// page table), then each edge's key tiles stream through shared memory;
// four threads own one query row, 16 of each tile's scores and a quarter
// of the row's output columns, as in B1 / B6a.  B9b runs one block per
// (64-key tile, work item, batch*head) over the item's valid edges and
// each edge's query tiles, dk and dv in registers, as in B6b; then one
// block per (64-key tile of a column, batch*head) sums the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::kBK;
using flash::kBQ;
using flash::kPP;
using flash::kThreads;
using flash::narrow;
using flash::round_to;
using flash::widen;

using Geom = flash::SplashGeom;
using flash::layout_head;

// rows of tile `t` of a layout block: 64, or fewer in a block's last tile
__device__ __forceinline__ int tile_len(const Geom& g, int t) { return min(kBQ, g.block - t * kBQ); }

// the block ids of the valid entries (ok & 1) among `n` entries of an index
// list, in order, clamped into [0, nb), into ids[] (at most `cap`);
// returns their count.  One thread: n is a row's degree or a column's run.
__device__ __forceinline__ int compact_ids(const int* id, const int* ok, int n, int nb, int cap,
                                           int* ids) {
  int c = 0;
  for (int e = 0; e < n && c < cap; ++e)
    if (ok[e] & 1) ids[c++] = min(max(id[e], 0), nb - 1);
  return c;
}

// stage rows [r0, r0 + n) of (T, D) operand `src` into a tile with row
// stride DS, zero rows past n
template <typename T, int D, int DS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0, int n, int tid) {
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, e2 = idx % D;
    dst[rr * DS + e2] = rr < n ? widen(src[static_cast<size_t>(r0 + rr) * D + e2]) : 0.f;
  }
}

// Q/dO rows of a query tile starting at q0 (qn rows) against K/V rows of a
// key tile starting at k0 (kn rows): the thread owning query row r (quarter
// c) writes, for keys c + 4i,
//   p  = exp(s * scale - lse), 0 where masked, rounded to dO's type -> Ps
//   ds = p * (dp - delta) * scale, rounded to q's type                -> dSs
// (WANT_P = false, the dq pass, skips Ps).
template <typename T, int D, bool WANT_P>
__device__ __forceinline__ void bwd_tile(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* lse_s,
                                         const float* delta_s, float* Ps, float* dSs,
                                         const Geom& g, int q0, int qn, int k0, int kn, int r,
                                         int c) {
  constexpr int DP = D + 1;
  const float row_lse = lse_s[r];
  const float row_delta = delta_s[r];
#pragma unroll 4
  for (int i = 0; i < kBK / 4; ++i) {
    const int kk = c + 4 * i;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int e2 = 0; e2 < D; ++e2) {
      s += Qs[r * DP + e2] * Ks[kk * DP + e2];
      dp += dOs[r * DP + e2] * Vs[kk * DP + e2];
    }
    const bool ok = r < qn && kk < kn && (!g.causal || q0 + r >= k0 + kk);
    const float p = ok ? expf(s * g.scale - row_lse) : 0.f;
    if (WANT_P) Ps[r * kPP + kk] = round_to<T>(p);
    dSs[r * kPP + kk] = round_to<T>(p * (dp - row_delta) * g.scale);
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, K tiles (rows of D + 1 floats), the V tile, the P tile
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPP);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles, the dS tile, lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + kBQ * kPP + 2 * kBQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles, lse, delta
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * kBQ * kPP + 2 * kBQ);
}

// B8: one block per (64-query tile of a layout row, batch*head)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ idx,
                  const int* __restrict__ valid, int deg, const Geom g) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;           // kBQ x DP
  float* Ks = Qs + kBQ * DP;  // kBK x DP
  float* Vs = Ks + kBK * DP;  // kBK x D
  float* Ps = Vs + kBK * D;   // kBQ x kPP
  int* ids = reinterpret_cast<int*>(Ps + kBQ * kPP);  // deg: the row's valid key blocks
  __shared__ int n_ids;

  const int row = blockIdx.x / g.tiles;
  const int qt = blockIdx.x % g.tiles;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row within the tile
  const int c = tid & 3;   // quarter of the row this thread owns
  const int q0 = row * g.block + qt * kBQ;
  const int qn = tile_len(g, qt);
  const T* kb = k + bh * g.T * D;
  const T* vb = v + bh * g.T * D;

  if (tid == 0) {
    const size_t at = (static_cast<size_t>(layout_head(g, bh)) * g.nb + row) * deg;
    n_ids = compact_ids(idx + at, valid + at, deg, g.nb, deg, ids);
  }
  stage_rows<T, D, DP>(Qs, q + bh * g.T * D, q0, qn, tid);
  __syncthreads();
  const int n_edges = n_ids;

  float m = -INFINITY, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_edges; ++j) {
    const int kblk = ids[j];
    for (int kt = 0; kt < g.tiles; ++kt) {
      const int k0 = kblk * g.block + kt * kBK;
      // this key tile and the block's later ones lie wholly above the
      // diagonal of the tile's last row (uniform over the block)
      if (g.causal && k0 > q0 + qn - 1) break;
      const int kn = tile_len(g, kt);
      __syncthreads();  // the previous tile's readers are done
      for (int i2 = tid; i2 < kBK * D; i2 += kThreads) {
        const int kk = i2 / D, e2 = i2 % D;
        const bool in = kk < kn;
        Ks[kk * DP + e2] = in ? widen(kb[static_cast<size_t>(k0 + kk) * D + e2]) : 0.f;
        Vs[kk * D + e2] = in ? widen(vb[static_cast<size_t>(k0 + kk) * D + e2]) : 0.f;
      }
      __syncthreads();

      float s[kBK / 4];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const int kk = c + 4 * i;
        float dot = 0.f;
#pragma unroll
        for (int e2 = 0; e2 < D; ++e2) dot += Qs[r * DP + e2] * Ks[kk * DP + e2];
        const bool ok = r < qn && kk < kn && (!g.causal || q0 + r >= k0 + kk);
        s[i] = ok ? dot * g.scale : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const float p = s[i] == -INFINITY ? 0.f : expf(s[i] - m_new);
        lsum += p;
        Ps[r * kPP + c + 4 * i] = round_to<T>(p);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      l = alpha * l + lsum;
      m = m_new;
      __syncwarp();  // the row's four threads have written their p
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const int e2 = c + 4 * i;
        float a = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < kBK; ++kk) a += Ps[r * kPP + kk] * Vs[kk * D + e2];
        acc[i] = acc[i] * alpha + a;
      }
    }
  }

  if (r < qn) {
    const int gq = q0 + r;
    const float denom = l == 0.f ? 1.f : l;
    T* orow = out + (bh * g.T + gq) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) orow[c + 4 * i] = narrow<T>(acc[i] / denom);
    if (lse != nullptr && c == 0)
      lse[bh * g.T + gq] = l == 0.f ? INFINITY : m + logf(fmaxf(l, 1e-37f));
  }
}

// B9a: one block per (64-query tile of a layout row, batch*head), the
// forward's walk
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, const int* __restrict__ idx,
                 const int* __restrict__ valid, int deg, const Geom g) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;               // kBQ x DP
  float* dOs = Qs + kBQ * DP;     // kBQ x DP
  float* Ks = dOs + kBQ * DP;     // kBK x DP
  float* Vs = Ks + kBK * DP;      // kBK x DP
  float* dSs = Vs + kBK * DP;     // kBQ x kPP
  float* lse_s = dSs + kBQ * kPP; // kBQ
  float* delta_s = lse_s + kBQ;   // kBQ
  int* ids = reinterpret_cast<int*>(delta_s + kBQ);  // deg
  __shared__ int n_ids;

  const int row = blockIdx.x / g.tiles;
  const int qt = blockIdx.x % g.tiles;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int q0 = row * g.block + qt * kBQ;
  const int qn = tile_len(g, qt);
  const T* kb = k + bh * g.T * D;
  const T* vb = v + bh * g.T * D;

  if (tid == 0) {
    const size_t at = (static_cast<size_t>(layout_head(g, bh)) * g.nb + row) * deg;
    n_ids = compact_ids(idx + at, valid + at, deg, g.nb, deg, ids);
  }
  stage_rows<T, D, DP>(Qs, q + bh * g.T * D, q0, qn, tid);
  stage_rows<T, D, DP>(dOs, dout + bh * g.T * D, q0, qn, tid);
  if (tid < kBQ) {
    const bool in = tid < qn;
    lse_s[tid] = in ? lse[bh * g.T + q0 + tid] : INFINITY;
    delta_s[tid] = in ? delta[bh * g.T + q0 + tid] : 0.f;
  }
  __syncthreads();
  const int n_edges = n_ids;

  float dq_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dq_acc[i] = 0.f;

  for (int j = 0; j < n_edges; ++j) {
    const int kblk = ids[j];
    for (int kt = 0; kt < g.tiles; ++kt) {
      const int k0 = kblk * g.block + kt * kBK;
      if (g.causal && k0 > q0 + qn - 1) break;
      const int kn = tile_len(g, kt);
      __syncthreads();
      stage_rows<T, D, DP>(Ks, kb, k0, kn, tid);
      stage_rows<T, D, DP>(Vs, vb, k0, kn, tid);
      __syncthreads();

      bwd_tile<T, D, false>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, g, q0, qn, k0, kn, r, c);
      __syncwarp();  // the row's four threads have written their ds

      // dq[r] += ds k over this tile's keys, in registers (fully unrolled:
      // a partly unrolled loop would index dq_acc at run time, in memory)
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int e2 = c + 4 * i;
        float a = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < kBK; ++kk) a += dSs[r * kPP + kk] * Ks[kk * DP + e2];
        dq_acc[i] += a;
      }
    }
  }

  if (r < qn) {
    T* dqrow = dq + (bh * g.T + q0 + r) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) dqrow[c + 4 * i] = narrow<T>(dq_acc[i]);
  }
}

// B9b: one block per (64-key tile, work item, batch*head), the item's
// piece of its column's run of the column-sorted edge list, into the
// item's f32 partial rows (BH, W, block, D)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk32,
                  float* __restrict__ dv32, const int* __restrict__ qidx,
                  const int* __restrict__ flags, const int* __restrict__ item_col,
                  const int* __restrict__ item_off, int E, int W, const Geom g) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                // kBK x DP
  float* Vs = Ks + kBK * DP;       // kBK x DP
  float* Qs = Vs + kBK * DP;       // kBQ x DP
  float* dOs = Qs + kBQ * DP;      // kBQ x DP
  float* Ps = dOs + kBQ * DP;      // kBQ x kPP
  float* dSs = Ps + kBQ * kPP;     // kBQ x kPP
  float* lse_s = dSs + kBQ * kPP;  // kBQ
  float* delta_s = lse_s + kBQ;    // kBQ
  int* ids = reinterpret_cast<int*>(delta_s + kBQ);  // nb: the item's valid query blocks
  __shared__ int n_ids;

  const int item = blockIdx.x / g.tiles;
  const int kt = blockIdx.x % g.tiles;
  const size_t bh = blockIdx.y;
  const int lh = layout_head(g, bh);
  const int col = item_col[static_cast<size_t>(lh) * W + item];
  if (col < 0 || col >= g.nb) return;  // past this head's items (per-head layouts)
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int k0 = col * g.block + kt * kBK;
  const int kn = tile_len(g, kt);
  const T* qb = q + bh * g.T * D;
  const T* dob = dout + bh * g.T * D;

  if (tid == 0) {
    const int* off = item_off + static_cast<size_t>(lh) * (W + 1);
    const int e0 = min(max(off[item], 0), E), e1 = min(max(off[item + 1], e0), E);
    // a column holds each query block at most once: at most nb valid edges
    n_ids = compact_ids(qidx + static_cast<size_t>(lh) * E + e0,
                        flags + static_cast<size_t>(lh) * E + e0, e1 - e0, g.nb, g.nb, ids);
  }
  stage_rows<T, D, DP>(Ks, k + bh * g.T * D, k0, kn, tid);
  stage_rows<T, D, DP>(Vs, v + bh * g.T * D, k0, kn, tid);
  __syncthreads();
  const int n_edges = n_ids;

  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < n_edges; ++j) {
    const int qblk = ids[j];
    for (int qt = 0; qt < g.tiles; ++qt) {
      const int q0 = qblk * g.block + qt * kBQ;
      const int qn = tile_len(g, qt);
      // every query row of this tile lies before every key of ours
      if (g.causal && q0 + qn - 1 < k0) continue;
      __syncthreads();
      stage_rows<T, D, DP>(Qs, qb, q0, qn, tid);
      stage_rows<T, D, DP>(dOs, dob, q0, qn, tid);
      if (tid < kBQ) {
        const bool in = tid < qn;
        lse_s[tid] = in ? lse[bh * g.T + q0 + tid] : INFINITY;
        delta_s[tid] = in ? delta[bh * g.T + q0 + tid] : 0.f;
      }
      __syncthreads();

      bwd_tile<T, D, true>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, g, q0, qn, k0, kn, r, c);
      __syncthreads();

      // dv[kk] += p^T dO and dk[kk] += ds^T q for key row kk = r
#pragma unroll 4
      for (int rr = 0; rr < kBQ; ++rr) {
        const float pv = Ps[rr * kPP + r];
        const float ds = dSs[rr * kPP + r];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int e2 = c + 4 * i;
          dv_acc[i] += pv * dOs[rr * DP + e2];
          dk_acc[i] += ds * Qs[rr * DP + e2];
        }
      }
    }
  }

  if (r < kn) {
    const size_t row = (bh * W + item) * g.block + kt * kBK + r;
    float* dkrow = dk32 + row * D;
    float* dvrow = dv32 + row * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dkrow[c + 4 * i] = dk_acc[i];
      dvrow[c + 4 * i] = dv_acc[i];
    }
  }
}

// B9b's second pass: one block per (64-key tile of a column, batch*head)
// sums the column's item partials in item order and writes dk and dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
splash_dkv_sum_kernel(const float* __restrict__ dk32, const float* __restrict__ dv32,
                      T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ col_items,
                      int W, const Geom g) {
  const int col = blockIdx.x / g.tiles;
  const int kt = blockIdx.x % g.tiles;
  const size_t bh = blockIdx.y;
  const int* ci = col_items + static_cast<size_t>(layout_head(g, bh)) * (g.nb + 1);
  const int i0 = min(max(ci[col], 0), W), i1 = min(max(ci[col + 1], i0), W);
  const int n = tile_len(g, kt) * D;
  const size_t out0 = (bh * g.T + col * g.block + kt * kBK) * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    float a = 0.f, b = 0.f;
    for (int w = i0; w < i1; ++w) {
      const size_t at = ((bh * W + w) * g.block + kt * kBK) * D + idx;
      a += dk32[at];
      b += dv32[at];
    }
    dk[out0 + idx] = narrow<T>(a);
    dv[out0 + idx] = narrow<T>(b);
  }
}

// the arguments every launch passes on unchanged
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;                 // out / dq / dk, and lse (B8) / dv (B9b)
  float *dk32, *dv32;                // B9b's partials (BH, W, block, D)
  const int *ia, *ib;                // idx, valid (B8, B9a); qidx, flags (B9b)
  const int *item_col, *item_off, *col_items;  // B9b's work items
  int n;                             // deg (B8, B9a), E (B9b)
  int W;                             // B9b's items a head
  int BH;
  Geom g;
  cudaStream_t st;
};

enum Pass { kFwd, kDq, kDkv };

template <typename T, int D, Pass P>
int launch(const Args& a) {
  size_t bytes;
  const void* fn;
  if constexpr (P == kFwd) {
    bytes = fwd_smem_bytes<D>() + sizeof(int) * a.n;
    fn = reinterpret_cast<const void*>(splash_fwd_kernel<T, D>);
  } else if constexpr (P == kDq) {
    bytes = dq_smem_bytes<D>() + sizeof(int) * a.n;
    fn = reinterpret_cast<const void*>(splash_dq_kernel<T, D>);
  } else {
    bytes = dkv_smem_bytes<D>() + sizeof(int) * a.g.nb;
    fn = reinterpret_cast<const void*>(splash_dkv_kernel<T, D>);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P == kDkv ? a.W : a.g.nb) * a.g.tiles, a.BH);
  if constexpr (P == kFwd) {
    splash_fwd_kernel<T, D><<<grid, kThreads, bytes, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.ia, a.ib, a.n, a.g);
  } else if constexpr (P == kDq) {
    splash_dq_kernel<T, D><<<grid, kThreads, bytes, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.ia, a.ib, a.n, a.g);
  } else {
    splash_dkv_kernel<T, D><<<grid, kThreads, bytes, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), a.dk32, a.dv32, a.ia, a.ib, a.item_col, a.item_off,
        a.n, a.W, a.g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 sum_grid(a.g.nb * a.g.tiles, a.BH);
    splash_dkv_sum_kernel<T, D><<<sum_grid, kThreads, 0, a.st>>>(
        a.dk32, a.dv32, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.col_items, a.W, a.g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Pass P, typename T>
int dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return launch<T, 16, P>(a);
    case 32: return launch<T, 32, P>(a);
    case 64: return launch<T, 64, P>(a);
    case 128: return launch<T, 128, P>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Pass P>
int entry(Args a, int H, int LH, int T, int block, int d, int dtype, int causal,
          float sm_scale) {
  if (a.BH < 1 || H < 1 || a.BH % H != 0 || (LH != 1 && LH != H) || T < 1 || block < 1 ||
      T % block != 0 || a.n < 1 || a.BH > 65535 || (P == kDkv && a.W < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = T / block;
  const int tiles = (block + kBQ - 1) / kBQ;
  if (static_cast<long long>(P == kDkv ? max(nb, a.W) : nb) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = Geom{T, block, nb, tiles, H, LH, causal, sm_scale};
  if (dtype == 0) return dispatch_d<P, float>(a, d);
  if (dtype == 1) return dispatch_d<P, __nv_bfloat16>(a, d);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B8.  dtype: 0 float32, 1 bfloat16 (q, k, v and out share it), all (BH, T,
// d) with BH = B * H; lse (f32, (BH, T)) may be null.  idx / valid: the row
// walk, (LH, nb * deg) int32 with nb = T / block, LH 1 or H.  Returns a
// cudaError_t.
extern "C" int ds_splash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const void* idx, const void* valid, int BH, int H, int LH, int T,
                             int block, int deg, int d, int dtype, int causal, float sm_scale,
                             void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr, nullptr,
         static_cast<const int*>(idx), static_cast<const int*>(valid), nullptr, nullptr, nullptr,
         deg, 0, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kFwd>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

// B9a: dq (q's type, (BH, T, d)), written once per row.  dout as q; lse and
// delta f32 (BH, T); idx / valid as B8's.
extern "C" int ds_splash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, const void* idx,
                                const void* valid, int BH, int H, int LH, int T, int block,
                                int deg, int d, int dtype, int causal, float sm_scale,
                                void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,
         static_cast<const int*>(idx), static_cast<const int*>(valid), nullptr, nullptr, nullptr,
         deg, 0, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kDq>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

// B9b: dk and dv (k's and v's type, (BH, T, d)), each block written once,
// through the f32 partials dk32 / dv32 (BH, W, block, d) of the caller's
// scratch.  qidx / flags (LH, E), item_col (LH, W), item_off (LH, W + 1)
// and col_items (LH, nb + 1), int32: the column walk's items.  Two kernel
// launches on the stream.
extern "C" int ds_splash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 void* dk32, void* dv32, const void* qidx, const void* flags,
                                 const void* item_col, const void* item_off,
                                 const void* col_items, int BH, int H, int LH, int T, int block,
                                 int E, int W, int d, int dtype, int causal, float sm_scale,
                                 void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, static_cast<float*>(dk32), static_cast<float*>(dv32),
         static_cast<const int*>(qidx), static_cast<const int*>(flags),
         static_cast<const int*>(item_col), static_cast<const int*>(item_off),
         static_cast<const int*>(col_items), E, W, BH, {}, static_cast<cudaStream_t>(stream)};
  return entry<kDkv>(a, H, LH, T, block, d, dtype, causal, sm_scale);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

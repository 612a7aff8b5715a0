// Flash decode for Hopper (sm_90a): single-query attention of every slot
// of the serving pool against its own KV cache, either slot-contiguous
// (B4) or paged through a per-slot page table (B5).  One kernel body
// serves both; only the address of a key row differs.
//
// Replaces: deepspeed_tpu/ops/kernels/flash_decode.py::_flash_decode_kernel
// (B4) and ::_flash_decode_paged_kernel (B5) (Pallas, TPU), driven there
// by flash_decode() / flash_decode_paged() and here by
// deepspeed_tpu_torch/ops/kernels/flash_decode.py::flash_decode_cuda /
// flash_decode_paged_cuda.
//
// Contract (the same as the Pallas kernels'):
//   q (B, H, 1, d) f32|bf16; pos (B,) int32.
//   B4: K/V caches (B, H, S, d) in q's type, or int8 codes with
//     (B, H, S, 1) f32 per-row scales; optional key-padding mask (B, S)
//     uint8 (nonzero = attendable).
//   B5: K/V page pools (num_pages, H, page_len, d) in q's type, or int8
//     codes with (num_pages, H, page_len, 1) f32 scales; page table
//     (B, P) int32.  Key j of slot b lives at page table[b, j / page_len],
//     row j % page_len; the slot's logical cache is S = P * page_len keys.
//     No key-padding mask.
//   Key j of slot b is attendable iff j <= pos[b] (and kpm[b, j] != 0).
//   q, k and v are widened to f32 before the dots; for int8 the score is
//   multiplied by sm_scale and then by the key scale outside the dot, and
//   p is multiplied by the value scale before the PV dot.  Masked scores
//   are -1e30 (not -inf), so a row with no attendable key attends
//   uniformly over all S keys and stays finite, as in the JAX version
//   (for B5 that is the whole gathered view, garbage page included).
//   Serving writes the step's K/V into the cache before it attends; the
//   kernel relies on that (key pos[b] is the token's own key).
//
// What bounds it: device-memory bytes.  Each step reads every attendable
// key and value row once (2 * (pos+1) * d * itemsize per slot and head)
// and does ~4 flops per byte, far below the H100's ~295 flops per byte.
// The page table adds 4 bytes per page; B5 reads a slot's table row once
// per block into shared memory, so the per-key address costs one shared
// load, one divide and no extra device-memory traffic.
//
// Design: one block per (slot, head), 16 warps.  Only keys j <= pos[b]
// are read, so an idle or short slot costs nothing beyond its prefix
// (and the garbage page behind a paged slot's position mask is never
// touched).  Warp w takes keys w, w + 16, ...; it loads 4 keys' K and V
// rows before it reduces any of them, so each warp keeps several row
// loads in flight (the 96 blocks of the serving shape are fewer than the
// card's 132 SMs, so per-warp memory parallelism is what feeds the
// bandwidth).  Lanes split a row's d elements, so a row load is one
// coalesced access.  Each warp keeps its own online-softmax state (m, l,
// acc); the 16 states are merged through shared memory at the end.
// Fixed sizes, no autotuning.  Because B4 and B5 share the body and the
// key order, B5 over a page pool equals B4 over the gathered contiguous
// view bit for bit.  On an H100 this design reaches ~7 % of the bytes
// bound at the serving shape (PERF.md): one 2-byte (bf16) or 1-byte
// (int8) load per lane per element, with half the lanes idle at d = 64,
// so load instructions and their latency, not bytes, bound it; 16-byte
// vector loads are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;        // keys loaded per warp before reducing
constexpr int kMaxD = 128;
constexpr int kPerLane = kMaxD / 32;
constexpr float kMask = -1e30f;   // the JAX version's NEG_INF
// page-table entries a block stages: 8 K ints, with the 8.3 KB of static
// shared memory below the 48 KB a block gets without opting in
constexpr int kMaxPages = 8192;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Row addressing of key j of one (slot, head): row r of K/V starts at
// element r * d, and the int8 scale of that row is scales[r].
struct ContiguousRows {  // B4: the (B, H, S, d) cache, row0 = (b * H + h) * S
  size_t row0;
  __device__ __forceinline__ size_t operator()(int j) const { return row0 + j; }
};

struct PagedRows {  // B5: the (num_pages, H, page_len, d) pool via the slot's table
  const int* table;  // the slot's page-table row, staged in shared memory
  size_t h;
  int H, page_len;
  __device__ __forceinline__ size_t operator()(int j) const {
    return (static_cast<size_t>(table[j / page_len]) * H + h) * page_len + j % page_len;
  }
};

// The decode of one (slot, head) by one block: walks keys 0..n-1 in the
// order described above and writes out[bh, :].  S is the logical cache
// length (B5: P * page_len), rows maps a key to its row.
template <typename TQ, typename TKV, bool QUANT, typename Rows>
__device__ __forceinline__ void decode_one(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                           const TKV* __restrict__ v, const float* __restrict__ ks,
                                           const float* __restrict__ vs, int pos_b,
                                           const uint8_t* __restrict__ mask_row,
                                           TQ* __restrict__ out, size_t bh, int S, int d,
                                           float sm_scale, Rows rows) {
  __shared__ float sh_m[kWarps];
  __shared__ float sh_l[kWarps];
  __shared__ float sh_acc[kWarps][kMaxD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int last = min(pos_b, S - 1);

  // Does the row have any attendable key?  (block-uniform branch)
  int any = last >= 0;
  if (mask_row != nullptr && any) {
    int mine = 0;
    for (int j = threadIdx.x; j <= last; j += kThreads) mine |= mask_row[j] != 0;
    any = __syncthreads_or(mine);
  }
  // With none, every score is kMask and the softmax is uniform over S.
  const int n = any ? last + 1 : S;

  float qr[kPerLane], acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    qr[i] = e < d ? widen(q[bh * d + e]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMask, l = 0.f;

  for (int j0 = warp; j0 < n; j0 += kWarps * kUnroll) {
    float kr[kUnroll][kPerLane], vr[kUnroll][kPerLane];
    size_t row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      row[u] = rows(min(j, n - 1));
      const size_t off = row[u] * d;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int e = lane + 32 * i;
        kr[u][i] = (j < n && e < d) ? widen(k[off + e]) : 0.f;
        vr[u][i] = (j < n && e < d) ? widen(v[off + e]) : 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) part += qr[i] * kr[u][i];
      s[u] = warp_sum(part);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      if (j < n) {
        float sj = s[u] * sm_scale;
        if (QUANT) sj *= ks[row[u]];
        const bool allowed = any && (mask_row == nullptr || mask_row[j] != 0);
        s[u] = allowed ? sj : kMask;
        m_new = fmaxf(m_new, s[u]);
      }
    }
    const float alpha = expf(m - m_new);
    float p[kUnroll];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kWarps;
      p[u] = j < n ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
      if (QUANT && j < n) p[u] *= vs[row[u]];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a += p[u] * vr[u][i];
      acc[i] = a;
    }
  }

  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    if (e < d) sh_acc[warp][e] = acc[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float big = kMask;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sh_m[w]);
    float tot_l = 0.f, tot_a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sh_m[w] - big);
      tot_l += c * sh_l[w];
      tot_a += c * sh_acc[w][e];
    }
    if (tot_l == 0.f) tot_l = 1.f;
    out[bh * d + e] = narrow<TQ>(tot_a / tot_l);
  }
}

// B4: one block per (slot, head) of the slot-contiguous cache.
template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    const uint8_t* __restrict__ kpm, TQ* __restrict__ out,
                    int H, int S, int d, float sm_scale) {
  const size_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  decode_one<TQ, TKV, QUANT>(q, k, v, ks, vs, pos[b],
                             kpm ? kpm + static_cast<size_t>(b) * S : nullptr, out, bh, S, d,
                             sm_scale, ContiguousRows{bh * S});
}

// B5: one block per (slot, head) of the page pool.  The slot's table row
// (P entries) is staged in dynamic shared memory first, each entry
// clamped into [0, num_pages): an entry outside the pool (which the
// caller must not pass) then reads a wrong page, never memory outside
// the pool.  (A trap on such an entry cost ~10 us at the serving shape.)
template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ table,
                          const int* __restrict__ pos, TQ* __restrict__ out, int H, int P,
                          int page_len, int num_pages, int d, float sm_scale) {
  extern __shared__ int sh_table[];
  const size_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  for (int i = threadIdx.x; i < P; i += kThreads)
    sh_table[i] = min(max(table[static_cast<size_t>(b) * P + i], 0), num_pages - 1);
  __syncthreads();
  decode_one<TQ, TKV, QUANT>(q, k, v, ks, vs, pos[b], nullptr, out, bh, P * page_len, d,
                             sm_scale, PagedRows{sh_table, static_cast<size_t>(h), H, page_len});
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, const void* kpm, void* out, int B, int H, int S, int d,
           float sm_scale, cudaStream_t stream) {
  flash_decode_kernel<TQ, TKV, QUANT><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(kpm),
      static_cast<TQ*>(out), H, S, d, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int launch_paged(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* table, const void* pos, void* out, int B, int H, int P,
                 int page_len, int num_pages, int d, float sm_scale, cudaStream_t stream) {
  flash_decode_paged_kernel<TQ, TKV, QUANT>
      <<<B * H, kThreads, P * sizeof(int), stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
          static_cast<const float*>(ks), static_cast<const float*>(vs),
          static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<TQ*>(out),
          H, P, page_len, num_pages, d, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then ks/vs are the f32 scales).  kpm may be null.  Returns a cudaError_t.
extern "C" int ds_flash_decode(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* pos,
                               const void* kpm, void* out, int B, int H, int S, int d,
                               int q_dtype, int kv_dtype, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d,
                                                       sm_scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(q, k, v, ks, vs, pos, kpm, out, B, H, S, d,
                                               sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The paged form: k/v (and ks/vs) are pools of num_pages pages, table is
// (B, P) int32 with every entry in [0, num_pages).  P is bounded by the
// 48 KB of shared memory a block gets without opting in (the table row
// lives there).  Returns a cudaError_t.
extern "C" int ds_flash_decode_paged(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, const void* table,
                                     const void* pos, void* out, int B, int H, int P,
                                     int page_len, int num_pages, int d, int q_dtype,
                                     int kv_dtype, float sm_scale, void* stream) {
  if (B < 1 || H < 1 || P < 1 || P > kMaxPages || page_len < 1 || num_pages < 1 || d < 1 ||
      d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_paged<float, float, false>(q, k, v, ks, vs, table, pos, out, B, H, P, page_len,
                                             num_pages, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_paged<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, ks, vs, table, pos, out, B,
                                                             H, P, page_len, num_pages, d,
                                                             sm_scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch_paged<float, int8_t, true>(q, k, v, ks, vs, table, pos, out, B, H, P, page_len,
                                             num_pages, d, sm_scale, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch_paged<__nv_bfloat16, int8_t, true>(q, k, v, ks, vs, table, pos, out, B, H, P,
                                                     page_len, num_pages, d, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

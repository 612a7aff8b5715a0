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
//   q (B, H, 1, d) f32|bf16; pos (B,) int32; d 16, 32, 64 or 128.
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
// The page table adds 4 bytes per page.
//
// Design (FlashDecoding's split over keys): the keys of each (slot, head)
// are cut into chunks of kChunk, and one block of four warps takes one
// (chunk, slot * head); the grid is sized from S on the host, never from
// pos.  A block whose chunk starts past the row's last key (pos[b], or S
// - 1 where the row has no attendable key at all) writes an empty record
// and returns, so an idle or short slot costs little and the garbage page
// behind a paged slot's position mask is never read.  Inside a block each
// warp takes 32 consecutive keys, and a lane loads 16 bytes of a row (8
// bf16 elements, 4 f32 or 16 int8 codes): a row is d * itemsize / 16
// lanes (8 for a d-64 bf16 row, so one warp-wide load brings four rows),
// each lane keeps up to eight rows' K and V loads in flight before it
// reduces any, and a row's dot is summed by shuffles within its lane
// group.  Each lane group keeps its own online-softmax state (m, l, acc);
// the groups of a warp merge by a shuffle butterfly, the four warps
// through shared memory in warp order, and the block writes its (acc[d],
// m, l) to an f32 workspace (B*H, splits, d + 2).  A second kernel
// combines each row's records in split order and writes out.  Nothing is
// summed by atomics, so every launch gives the same bits; because B4 and
// B5 share the body, the chunk boundaries and the key order, B5 over a
// page pool equals B4 over the gathered contiguous view bit for bit.
// Fixed sizes, no autotuning.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // keys a block takes (deepspeed_tpu_torch: DECODE_CHUNK)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = kChunk / kWarps;  // consecutive keys a warp takes
constexpr float kMask = -1e30f;            // the JAX version's NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of a K/V row: N elements of T, widened to f32 exactly
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void widen(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Row addressing of key j of one (slot, head): row r of K/V starts at
// element r * d, and the int8 scale of that row is scales[r].
struct ContiguousRows {  // B4: the (B, H, S, d) cache, row0 = (b * H + h) * S
  size_t row0;
  __device__ __forceinline__ size_t operator()(int j) const { return row0 + j; }
};

struct PagedRows {  // B5: the (num_pages, H, page_len, d) pool via the slot's table
  const int* table;  // the chunk's page-table entries, staged in shared memory
  int p0;            // the page of table[0]
  size_t h;
  int H, page_len;
  __device__ __forceinline__ size_t operator()(int j) const {
    return (static_cast<size_t>(table[j / page_len - p0]) * H + h) * page_len + j % page_len;
  }
};

// The keys the row attends: [0, n), n = pos[b] + 1 (at most S) where the
// row has an attendable key, else all S (every score then masked, the
// softmax uniform).  Block-uniform.
__device__ __forceinline__ int row_keys(int pos_b, const uint8_t* __restrict__ mask_row, int S,
                                        int* any_out) {
  const int last = min(pos_b, S - 1);
  int any = last >= 0;
  if (mask_row != nullptr && any) {
    int mine = 0;
#pragma unroll 8
    for (int j = threadIdx.x; j <= last; j += kThreads) mine |= mask_row[j] != 0;
    any = __syncthreads_or(mine);
  }
  *any_out = any;
  return any ? last + 1 : S;
}

// One block's share of one (slot, head): keys [c0, c1) of the n the row
// attends, c0 = split * kChunk < n.  Writes the block's record (acc[D], m,
// l) of the softmax over those keys, in base e, to rec.
template <typename TQ, typename TKV, bool QUANT, int D, typename Rows>
__device__ __forceinline__ void decode_chunk(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                             const TKV* __restrict__ v,
                                             const float* __restrict__ ks,
                                             const float* __restrict__ vs, int any,
                                             const uint8_t* __restrict__ mask_row, int bh, int c0,
                                             int c1, float sm_scale, Rows rows,
                                             float* __restrict__ rec) {
  using VT = Vec<TKV>;
  constexpr int V = VT::N;          // elements a lane loads
  constexpr int L = D / V;          // lanes of a row
  constexpr int R = 32 / L;         // rows of one warp-wide load
  constexpr int U = L < 8 ? L : 8;  // row loads a lane keeps in flight
  constexpr int kStep = R * U;      // keys a warp takes a step
  static_assert(D % V == 0 && L >= 1 && L <= 32 && 32 % L == 0, "a row is 1..32 lanes");
  static_assert(kPerWarp % kStep == 0, "a warp's keys are whole steps");
  __shared__ float sh_m[kWarps], sh_l[kWarps], sh_acc[kWarps][D];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / L, li = lane % L;  // the lane's row in a load, its 16 bytes of it

  float qv[V], acc[V];
#pragma unroll
  for (int x = 0; x < V; ++x) {
    qv[x] = widen(q[static_cast<size_t>(bh) * D + li * V + x]);
    acc[x] = 0.f;
  }
  float m = kMask, l = 0.f;

  const int w0 = c0 + warp * kPerWarp;
  const int w1 = min(w0 + kPerWarp, c1);
  for (int j0 = w0; j0 < w1; j0 += kStep) {
    uint4 kr[U], vr[U];
    size_t row[U];
    bool keep[U];  // the key-padding mask's bytes, loaded with the rows
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * R + grp;
      row[u] = rows(min(j, c1 - 1));
      keep[u] = any;
      if (j < c1) {
        kr[u] = load16(k + row[u] * D + li * V);
        vr[u] = load16(v + row[u] * D + li * V);
        if (mask_row != nullptr) keep[u] = keep[u] && mask_row[j] != 0;
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[V];
      VT::widen(kr[u], kf);
      float part = 0.f;
#pragma unroll
      for (int x = 0; x < V; ++x) part += qv[x] * kf[x];
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      s[u] = part;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * R + grp;
      if (j < c1) {
        float sj = s[u] * sm_scale;
        if (QUANT) sj *= ks[row[u]];
        s[u] = keep[u] ? sj : kMask;
        m_new = fmaxf(m_new, s[u]);
      }
    }
    const float alpha = expf(m - m_new);
    float p[U];
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * R + grp;
      p[u] = j < c1 ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
      if (QUANT && j < c1) p[u] *= vs[row[u]];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[V];
      VT::widen(vr[u], vf);
#pragma unroll
      for (int x = 0; x < V; ++x) acc[x] += p[u] * vf[x];
    }
  }

  // the warp's lane groups merge by a butterfly; every group ends with the
  // warp's state (a group with no key holds m = kMask, l = 0 and weighs 0)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float big = fmaxf(m, mo);
    const float a = expf(m - big), b = expf(mo - big);
    l = l * a + lo * b;
#pragma unroll
    for (int x = 0; x < V; ++x) acc[x] = acc[x] * a + __shfl_xor_sync(0xffffffffu, acc[x], off) * b;
    m = big;
  }
  if (lane < L) {
#pragma unroll
    for (int x = 0; x < V; ++x) sh_acc[warp][li * V + x] = acc[x];
    if (lane == 0) {
      sh_m[warp] = m;
      sh_l[warp] = l;
    }
  }
  __syncthreads();
  // the four warps in warp order; a split whose keys are all masked, in a
  // row that has a real key, weighs exp(-1e30 - M) = 0 in the combine
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float big = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sh_m[w]);
    float tot_l = 0.f, tot_a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sh_m[w] - big);
      tot_l += c * sh_l[w];
      tot_a += c * sh_acc[w][e];
    }
    rec[e] = tot_a;
    if (e == 0) {
      rec[D] = big;
      rec[D + 1] = tot_l;
    }
  }
}

// an empty record: the chunk lies past the row's last key
__device__ __forceinline__ void empty_record(float* rec, int D) {
  if (threadIdx.x == 0) {
    rec[D] = -INFINITY;
    rec[D + 1] = 0.f;
  }
}

// B4: one block per (chunk, slot * head) of the slot-contiguous cache.
template <typename TQ, typename TKV, bool QUANT, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    const uint8_t* __restrict__ kpm, float* __restrict__ ws, int H, int S,
                    int splits, float sm_scale) {
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H;
  float* rec = ws + (static_cast<size_t>(bh) * splits + split) * (D + 2);
  const uint8_t* mask_row = kpm ? kpm + static_cast<size_t>(b) * S : nullptr;
  int any;
  const int n = row_keys(pos[b], mask_row, S, &any);
  const int c0 = split * kChunk;
  if (c0 >= n) return empty_record(rec, D);
  decode_chunk<TQ, TKV, QUANT, D>(q, k, v, ks, vs, any, mask_row, bh, c0, min(c0 + kChunk, n),
                                  sm_scale, ContiguousRows{static_cast<size_t>(bh) * S}, rec);
}

// B5: one block per (chunk, slot * head) of the page pool.  The chunk's
// page-table entries are staged in shared memory first, each clamped into
// [0, num_pages): an entry outside the pool (which the caller must not
// pass) then reads a wrong page, never memory outside the pool.
template <typename TQ, typename TKV, bool QUANT, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ table,
                          const int* __restrict__ pos, float* __restrict__ ws, int H, int P,
                          int page_len, int num_pages, int splits, float sm_scale) {
  __shared__ int sh_table[kChunk + 1];  // a chunk spans at most kChunk + 1 pages
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  float* rec = ws + (static_cast<size_t>(bh) * splits + split) * (D + 2);
  const int S = P * page_len;
  int any;
  const int n = row_keys(pos[b], nullptr, S, &any);
  const int c0 = split * kChunk;
  if (c0 >= n) return empty_record(rec, D);
  const int c1 = min(c0 + kChunk, n);
  const int p0 = c0 / page_len, np = (c1 - 1) / page_len + 1 - p0;
  for (int i = threadIdx.x; i < np; i += kThreads)
    sh_table[i] = min(max(table[static_cast<size_t>(b) * P + p0 + i], 0), num_pages - 1);
  __syncthreads();
  decode_chunk<TQ, TKV, QUANT, D>(q, k, v, ks, vs, any, nullptr, bh, c0, c1, sm_scale,
                                  PagedRows{sh_table, p0, static_cast<size_t>(h), H, page_len},
                                  rec);
}

// The combine: one block per slot * head merges the row's records in split
// order (an empty record, m = -inf, is skipped) and writes out.
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ ws, TQ* __restrict__ out, int splits) {
  const int bh = blockIdx.x, e = threadIdx.x;
  const float* recs = ws + static_cast<size_t>(bh) * splits * (D + 2);
  float big = -INFINITY;
  for (int s = 0; s < splits; ++s) big = fmaxf(big, recs[s * (D + 2) + D]);
  float tot_l = 0.f, tot_a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = recs[s * (D + 2) + D];
    if (ms == -INFINITY) continue;
    const float c = expf(ms - big);
    tot_l += c * recs[s * (D + 2) + D + 1];
    tot_a += c * recs[s * (D + 2) + e];
  }
  out[static_cast<size_t>(bh) * D + e] = narrow<TQ>(tot_a / (tot_l == 0.f ? 1.f : tot_l));
}

// the arguments every launch passes on unchanged
struct Args {
  const void *q, *k, *v, *ks, *vs, *pos;
  const void* kpm;    // B4's key-padding mask (may be null)
  const void* table;  // B5's page table
  float* ws;
  void* out;
  int B, H, S, splits;
  int P, page_len, num_pages;  // B5
  float sm_scale;
  cudaStream_t st;
};

template <typename TQ, typename TKV, bool QUANT, int D, bool PAGED>
int launch(const Args& a) {
  dim3 grid(a.splits, a.B * a.H);
  if constexpr (PAGED) {
    flash_decode_paged_kernel<TQ, TKV, QUANT, D><<<grid, kThreads, 0, a.st>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
        static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
        static_cast<const int*>(a.table), static_cast<const int*>(a.pos), a.ws, a.H, a.P,
        a.page_len, a.num_pages, a.splits, a.sm_scale);
  } else {
    flash_decode_kernel<TQ, TKV, QUANT, D><<<grid, kThreads, 0, a.st>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
        static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
        static_cast<const int*>(a.pos), static_cast<const uint8_t*>(a.kpm), a.ws, a.H, a.S,
        a.splits, a.sm_scale);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ, D><<<a.B * a.H, D, 0, a.st>>>(a.ws, static_cast<TQ*>(a.out), a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool PAGED>
int dispatch_types(const Args& a, int q_dtype, int kv_dtype) {
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, false, D, PAGED>(a);
  if (q_dtype == 1 && kv_dtype == 1) return launch<bf16, bf16, false, D, PAGED>(a);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, true, D, PAGED>(a);
  if (q_dtype == 1 && kv_dtype == 2) return launch<bf16, int8_t, true, D, PAGED>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PAGED>
int entry(const Args& a, int d, int q_dtype, int kv_dtype) {
  if (a.B < 1 || a.H < 1 || a.S < 1 || static_cast<long long>(a.B) * a.H > 65535 ||
      a.splits != (a.S + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte row loads: the caches and the workspace start on a 16-byte boundary
  if ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 16: return dispatch_types<16, PAGED>(a, q_dtype, kv_dtype);
    case 32: return dispatch_types<32, PAGED>(a, q_dtype, kv_dtype);
    case 64: return dispatch_types<64, PAGED>(a, q_dtype, kv_dtype);
    case 128: return dispatch_types<128, PAGED>(a, q_dtype, kv_dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (then ks/vs are the f32 scales).  kpm may be null.  k and v start on a
// 16-byte boundary; ws is the f32 workspace (B*H, splits, d + 2) with
// splits = ceil(S / 128).  Two kernel launches on the stream.  Returns a
// cudaError_t.
extern "C" int ds_flash_decode(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* pos, const void* kpm, void* ws,
                               void* out, int B, int H, int S, int splits, int d, int q_dtype,
                               int kv_dtype, float sm_scale, void* stream) {
  const Args a{q, k, v, ks, vs, pos, kpm, nullptr, static_cast<float*>(ws), out, B, H, S, splits,
               0, 0, 0, sm_scale, static_cast<cudaStream_t>(stream)};
  return entry<false>(a, d, q_dtype, kv_dtype);
}

// The paged form: k/v (and ks/vs) are pools of num_pages pages, table is
// (B, P) int32 with every entry in [0, num_pages); ws as ds_flash_decode's
// with S = P * page_len.  Returns a cudaError_t.
extern "C" int ds_flash_decode_paged(const void* q, const void* k, const void* v, const void* ks,
                                     const void* vs, const void* table, const void* pos, void* ws,
                                     void* out, int B, int H, int P, int page_len, int num_pages,
                                     int splits, int d, int q_dtype, int kv_dtype, float sm_scale,
                                     void* stream) {
  if (P < 1 || page_len < 1 || num_pages < 1 || static_cast<long long>(P) * page_len > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, ks, vs, pos, nullptr, table, static_cast<float*>(ws), out, B, H,
               P * page_len, splits, P, page_len, num_pages, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return entry<true>(a, d, q_dtype, kv_dtype);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

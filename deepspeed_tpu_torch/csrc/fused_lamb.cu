// Fused LAMB update for Hopper (sm_90a): two memory passes per parameter
// leaf, updating p, m and v in place.
//
// Replaces: deepspeed_tpu/ops/kernels/fused_update.py::_lamb_dir_kernel
// (B7a) and ::_lamb_apply_kernel (B7b) (Pallas, TPU), driven there by
// _lamb_pallas_leaf / engine_update and here by
// deepspeed_tpu_torch/ops/kernels/fused_update.py::lamb_leaf_cuda.
//
// Contract: p (f32 or bf16), g (f32 or bf16), m and v (f32), all of n
// elements; dir, an f32 scratch of at least n elements; scal = [lr, keep,
// c1, c2], four f32 values in device memory.  The body is the keep-folded
// LAMB of fused_update.py::_lamb_dir_body / _lamb_math:
//   g = keep > 0 ? g : 0
//   m' = m + keep * ((b1 - 1) m + (1 - b1) g)
//   v' = v + keep * ((b2 - 1) v + (1 - b2) g g)
//   d  = (m' / c1) / (sqrt(v' / c2) + eps)      (+ wd * p when wd > 0)
//   trust = clamp(||p|| / ||d||, min_coeff, max_coeff), 1 where a norm is 0
//   p' = p - ((keep * lr) * trust) * d            (rounded to p's type)
// Pass 1 (ds_fused_lamb_dir) reads p, g, m, v once, writes m', v' in place,
// d into dir and one (sum p^2, sum d^2) pair per block into partials.  The
// trust ratio needs the whole leaf's norms before any p can be written, so
// the wrapper resolves it on the device from the partials (torch ops, no
// host read) and pass 2 (ds_fused_lamb_apply) reads p, d and the trust and
// writes p'.  keep = 1 - overflow: a skipped step writes back the old m, v
// and p.  The scalars come from device memory, so neither the overflow flag
// nor the step count forces a host sync.  Every product and sum of m', v',
// d and p' is rounded on its own (__fmul_rn / __fadd_rn, no fused
// multiply-add), as the plain PyTorch version rounds them; only the norms'
// summation order differs from it.
//
// What bounds it: bytes.  Per f32 element pass 1 moves 28 bytes (p, g
// read; m, v read and written; d written) and pass 2 moves 12 (p, d read;
// p written) for ~25 flops in all, far below the card's balance point.
// Design: grid-stride loops; where every pointer is 16-byte aligned the
// bulk moves as 4-element vectors, the tail element by element.  Pass 1
// runs the grid the wrapper chose (its block count is the count of norm
// partials) and reduces each thread's sums through warp shuffles and
// shared memory, in a fixed order.  The TPU kernels' tiling envelope
// (size % 256, >= 8 rows) does not apply: every leaf takes the kernels,
// whatever its size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1m1, omb1, b2m1, omb2, eps, wd;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// the direction of one element; m and v updated in place
__device__ __forceinline__ float lamb_dir_one(float p, float g, float& m, float& v, float keep,
                                              float c1, float c2, const Hyper& h) {
  g = keep > 0.f ? g : 0.f;  // 0 * inf would poison the fold
  const float m_new = add(m, mul(keep, add(mul(h.b1m1, m), mul(h.omb1, g))));
  const float v_new = add(v, mul(keep, add(mul(h.b2m1, v), mul(mul(h.omb2, g), g))));
  float d = __fdiv_rn(__fdiv_rn(m_new, c1), add(__fsqrt_rn(__fdiv_rn(v_new, c2)), h.eps));
  if (h.wd > 0.f) d = add(d, mul(h.wd, p));
  m = m_new;
  v = v_new;
  return d;
}

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  __device__ static void load(const float* ptr, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(ptr);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static void store(float* ptr, const float* in) {
    *reinterpret_cast<float4*>(ptr) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* ptr, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(ptr);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(a); out[1] = __high2float(a);
    out[2] = __low2float(b); out[3] = __high2float(b);
  }
  __device__ static void store(__nv_bfloat16* ptr, const float* in) {
    uint2 raw;
    __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(ptr) = raw;
  }
};

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
lamb_dir_kernel(const TP* __restrict__ p, const TG* __restrict__ g, float* __restrict__ m,
                float* __restrict__ v, float* __restrict__ dir, float* __restrict__ partials,
                const float* __restrict__ scal, long long n, long long n_vec, Hyper h) {
  const float keep = scal[1], c1 = scal[2], c2 = scal[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float wsq = 0.f, dsq = 0.f;
  for (long long i = first; i < n_vec; i += stride) {
    const long long o = 4 * i;
    float pp[4], gg[4], mm[4], vv[4], dd[4];
    Vec4<TP>::load(p + o, pp);
    Vec4<TG>::load(g + o, gg);
    Vec4<float>::load(m + o, mm);
    Vec4<float>::load(v + o, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dd[j] = lamb_dir_one(pp[j], gg[j], mm[j], vv[j], keep, c1, c2, h);
      wsq += pp[j] * pp[j];
      dsq += dd[j] * dd[j];
    }
    Vec4<float>::store(m + o, mm);
    Vec4<float>::store(v + o, vv);
    Vec4<float>::store(dir + o, dd);
  }
  for (long long i = 4 * n_vec + first; i < n; i += stride) {
    const float pi = widen(p[i]);
    float mi = m[i], vi = v[i];
    const float di = lamb_dir_one(pi, widen(g[i]), mi, vi, keep, c1, c2, h);
    m[i] = mi;
    v[i] = vi;
    dir[i] = di;
    wsq += pi * pi;
    dsq += di * di;
  }
  // the block's partial sums: warps by shuffles, then warp 0 over the warps
  __shared__ float red[2][kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wsq += __shfl_xor_sync(0xffffffffu, wsq, o);
    dsq += __shfl_xor_sync(0xffffffffu, dsq, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = wsq;
    red[1][warp] = dsq;
  }
  __syncthreads();
  if (warp == 0) {
    wsq = lane < kThreads / 32 ? red[0][lane] : 0.f;
    dsq = lane < kThreads / 32 ? red[1][lane] : 0.f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      wsq += __shfl_xor_sync(0xffffffffu, wsq, o);
      dsq += __shfl_xor_sync(0xffffffffu, dsq, o);
    }
    if (lane == 0) {
      partials[2 * blockIdx.x] = wsq;
      partials[2 * blockIdx.x + 1] = dsq;
    }
  }
}

template <typename TP>
__global__ void __launch_bounds__(kThreads)
lamb_apply_kernel(TP* __restrict__ p, const float* __restrict__ dir,
                  const float* __restrict__ scal, const float* __restrict__ trust, long long n,
                  long long n_vec) {
  // ((keep * lr) * trust), the plain version's scalar product
  const float step = mul(mul(scal[1], scal[0]), trust[0]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < n_vec; i += stride) {
    const long long o = 4 * i;
    float pp[4], dd[4];
    Vec4<TP>::load(p + o, pp);
    Vec4<float>::load(dir + o, dd);
#pragma unroll
    for (int j = 0; j < 4; ++j) pp[j] = __fsub_rn(pp[j], mul(step, dd[j]));
    Vec4<TP>::store(p + o, pp);
  }
  for (long long i = 4 * n_vec + first; i < n; i += stride)
    p[i] = narrow<TP>(__fsub_rn(widen(p[i]), mul(step, dir[i])));
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

template <typename TP, typename TG>
int launch_dir(const void* p, const void* g, float* m, float* v, float* dir, float* partials,
               const float* scal, long long n, int blocks, const Hyper& h, cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) && aligned16(dir);
  const long long n_vec = vec ? n / 4 : 0;
  lamb_dir_kernel<TP, TG><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TP*>(p), static_cast<const TG*>(g), m, v, dir, partials, scal, n, n_vec, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP>
int launch_apply(void* p, const float* dir, const float* scal, const float* trust, long long n,
                 cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(dir);
  const long long n_vec = vec ? n / 4 : 0;
  lamb_apply_kernel<TP><<<grid_for(n_vec + (n - 4 * n_vec)), kThreads, 0, stream>>>(
      static_cast<TP*>(p), dir, scal, trust, n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1.  p_dtype, g_dtype: 0 float32, 1 bfloat16.  m, v, dir: float32;
// partials: 2 * blocks float32, one (sum p^2, sum d^2) pair per block, all
// written (zeros where a block had no element).  scal: four f32 device
// values [lr, keep, c1, c2].  The b1/b2 terms are passed as the host
// computed them: b1m1 = b1 - 1, omb1 = 1 - b1 (likewise for b2).  Returns a
// cudaError_t.
extern "C" int ds_fused_lamb_dir(const void* p, const void* g, void* m, void* v, void* dir,
                                 void* partials, const void* scal, long long n, int blocks,
                                 int p_dtype, int g_dtype, float b1m1, float omb1, float b2m1,
                                 float omb2, float eps, float weight_decay, void* stream) {
  if (n < 0 || blocks < 1 || p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1m1, omb1, b2m1, omb2, eps, weight_decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  float* df = static_cast<float*>(dir);
  float* pf = static_cast<float*>(partials);
  const float* sc = static_cast<const float*>(scal);
  if (p_dtype == 0 && g_dtype == 0)
    return launch_dir<float, float>(p, g, mf, vf, df, pf, sc, n, blocks, h, st);
  if (p_dtype == 0 && g_dtype == 1)
    return launch_dir<float, __nv_bfloat16>(p, g, mf, vf, df, pf, sc, n, blocks, h, st);
  if (p_dtype == 1 && g_dtype == 0)
    return launch_dir<__nv_bfloat16, float>(p, g, mf, vf, df, pf, sc, n, blocks, h, st);
  return launch_dir<__nv_bfloat16, __nv_bfloat16>(p, g, mf, vf, df, pf, sc, n, blocks, h, st);
}

// Pass 2.  p_dtype: 0 float32, 1 bfloat16.  dir: float32 from pass 1;
// scal as above; trust: one f32 device value.  Returns a cudaError_t.
extern "C" int ds_fused_lamb_apply(void* p, const void* dir, const void* scal, const void* trust,
                                   long long n, int p_dtype, void* stream) {
  if (n < 0 || p_dtype < 0 || p_dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* df = static_cast<const float*>(dir);
  const float* sc = static_cast<const float*>(scal);
  const float* tr = static_cast<const float*>(trust);
  if (p_dtype == 0) return launch_apply<float>(p, df, sc, tr, n, st);
  return launch_apply<__nv_bfloat16>(p, df, sc, tr, n, st);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

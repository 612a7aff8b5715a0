// Fused Adam / AdamW update for Hopper (sm_90a): one memory pass per
// parameter leaf, updating p, m and v in place.
//
// Replaces: deepspeed_tpu/ops/kernels/fused_update.py::_adam_kernel
// (Pallas, TPU), driven there by _adam_pallas_leaf / engine_update and here
// by deepspeed_tpu_torch/ops/kernels/fused_update.py::adam_leaf.
//
// Contract: p (f32 or bf16), g (f32 or bf16), m and v (f32), all of n
// elements; scal = [lr, keep, c1, c2], four f32 values in device memory.
// The body is the keep-folded Adam of fused_update.py::_adam_keep_body:
//   g = keep > 0 ? g : 0
//   Adam-L2 (adam_w_mode 0, wd > 0): g += wd * p
//   m' = m + keep * ((b1 - 1) m + (1 - b1) g)
//   v' = v + keep * ((b2 - 1) v + (1 - b2) g g)
//   u  = -(lr * (m' / c1) / (sqrt(v' / c2) + eps))
//   AdamW (adam_w_mode 1, wd > 0): u -= (lr * wd) * p
//   p' = p + keep * u            (rounded to p's type)
// keep = 1 - overflow: a skipped step writes back the old m, v and p.
// The scalars come from device memory, so the overflow flag and the step
// count never force a host sync (the TPU kernel read them from SMEM).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// fused multiply-add), as the plain PyTorch version rounds them.
//
// What bounds it: bytes.  Per f32 element it reads p, g, m, v and writes
// p, m, v (28 bytes) for ~20 flops, far below the card's balance point.
// Design: a grid-stride loop; where every pointer is 16-byte aligned the
// bulk moves as 4-element vectors (16-byte loads of m, v and f32 p/g), the
// tail element by element.  The TPU's tiling envelope (size % 256, >= 8
// rows; fused_update.py::_leaf_grid) does not apply: every leaf takes the
// kernel, whatever its size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1m1, omb1, b2m1, omb2, eps, wd;
  int adam_w_mode;
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

// one element of the keep-folded body; p, m, v updated in place
__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, float lr,
                                         float keep, float c1, float c2, const Hyper& h) {
  g = keep > 0.f ? g : 0.f;  // 0 * inf would poison the fold
  if (!h.adam_w_mode && h.wd > 0.f) g = add(g, mul(h.wd, p));
  const float m_new = add(m, mul(keep, add(mul(h.b1m1, m), mul(h.omb1, g))));
  const float v_new = add(v, mul(keep, add(mul(h.b2m1, v), mul(mul(h.omb2, g), g))));
  const float denom = add(__fsqrt_rn(__fdiv_rn(v_new, c2)), h.eps);
  float upd = -__fdiv_rn(mul(lr, __fdiv_rn(m_new, c1)), denom);
  if (h.adam_w_mode && h.wd > 0.f) upd = add(upd, -mul(mul(lr, h.wd), p));
  p = add(p, mul(keep, upd));
  m = m_new;
  v = v_new;
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
fused_adam_kernel(TP* __restrict__ p, const TG* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, const float* __restrict__ scal, long long n,
                  long long n_vec, Hyper h) {
  const float lr = scal[0], keep = scal[1], c1 = scal[2], c2 = scal[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the bulk: n_vec groups of 4 elements, 16-byte (or 8-byte bf16) accesses
  for (long long i = first; i < n_vec; i += stride) {
    const long long o = 4 * i;
    float pp[4], gg[4], mm[4], vv[4];
    Vec4<TP>::load(p + o, pp);
    Vec4<TG>::load(g + o, gg);
    Vec4<float>::load(m + o, mm);
    Vec4<float>::load(v + o, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) adam_one(pp[j], gg[j], mm[j], vv[j], lr, keep, c1, c2, h);
    Vec4<TP>::store(p + o, pp);
    Vec4<float>::store(m + o, mm);
    Vec4<float>::store(v + o, vv);
  }
  // the tail (and every element of a leaf that is not 16-byte aligned)
  for (long long i = 4 * n_vec + first; i < n; i += stride) {
    float pi = widen(p[i]), mi = m[i], vi = v[i];
    adam_one(pi, widen(g[i]), mi, vi, lr, keep, c1, c2, h);
    p[i] = narrow<TP>(pi);
    m[i] = mi;
    v[i] = vi;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename TP, typename TG>
int launch(void* p, const void* g, float* m, float* v, const float* scal, long long n,
           const Hyper& h, cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const long long n_vec = vec ? n / 4 : 0;
  const long long work = n_vec + (n - 4 * n_vec);
  // enough blocks to fill the card several times over; the loop strides
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  fused_adam_kernel<TP, TG><<<blocks, kThreads, 0, stream>>>(
      static_cast<TP*>(p), static_cast<const TG*>(g), m, v, scal, n, n_vec, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p_dtype, g_dtype: 0 float32, 1 bfloat16.  m, v: float32.  scal: four
// f32 device values [lr, keep, c1, c2].  The b1/b2 terms are passed as the
// host computed them: b1m1 = b1 - 1, omb1 = 1 - b1 (likewise for b2).
// Returns a cudaError_t.
extern "C" int ds_fused_adam(void* p, const void* g, void* m, void* v, const void* scal,
                             long long n, int p_dtype, int g_dtype, float b1m1, float omb1,
                             float b2m1, float omb2, float eps, float weight_decay,
                             int adam_w_mode, void* stream) {
  if (n < 0 || p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Hyper h{b1m1, omb1, b2m1, omb2, eps, weight_decay, adam_w_mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scal);
  if (p_dtype == 0 && g_dtype == 0) return launch<float, float>(p, g, mf, vf, sc, n, h, st);
  if (p_dtype == 0 && g_dtype == 1) return launch<float, __nv_bfloat16>(p, g, mf, vf, sc, n, h, st);
  if (p_dtype == 1 && g_dtype == 0) return launch<__nv_bfloat16, float>(p, g, mf, vf, sc, n, h, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(p, g, mf, vf, sc, n, h, st);
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

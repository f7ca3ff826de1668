// Fused one-pass AdamW update, in place, for Hopper (sm_90a), CUDA C++.
//
// Replaces: distributed_tensorflow_tpu/ops/fused_adamw.py _adamw_kernel
// (:53; _fused_leaf_update :67, pl.pallas_call at :105). For one
// parameter tensor, flat and contiguous, with p and g in one of f32,
// bf16 and f16, mu and nu each in any of the three, and the bias
// corrections c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) as f32 scalars:
//   mu' = b1 mu + (1 - b1) g
//   nu' = b2 nu + (1 - b2) g^2
//   u   = (mu' c1) / (sqrt(nu' c2) + eps) + wd p
//   p'  = p - lr u
// all in f32, b1 an f32 scalar even for a bf16 mu (the JAX fused update
// casts mu to f32 and multiplies by the Python-float b1; optax would
// round b1 to bf16). As _adamw_kernel does (:62-64), each tensor is read
// in its own dtype and each output rounded to its input's dtype (round
// to nearest even). p', mu', nu' are written over p, mu, nu: the
// TPU kernel's input->output aliasing (:122) becomes a plain in-place
// write. Each operation is rounded on its own (__fmul_rn, __fadd_rn,
// which the compiler never contracts into an FMA), in the plain
// version's order, so the kernel gives the plain PyTorch version's
// bits.
//
// Design. The TPU version reshapes a leaf to (rows, 1024) tiles, padding
// odd sizes, so that its blocks follow the (8, 128) tiling. Here the
// tensor stays flat: each thread of a grid-stride loop takes 4
// consecutive elements, as one 16-byte (f32) or 8-byte (bf16, f16) load
// of each of p, g, mu and nu, when every pointer is aligned for it; the
// n mod 4 tail, or the whole tensor when a pointer is not aligned, goes
// element by element.
//
// Bound: bytes. Each parameter reads p, g, mu, nu and writes p, mu, nu
// once: 28 B with an f32 mu, 24 B with a bf16 mu (16 B with bf16 p, g
// and mu, and an f32 nu), against 13 operations.
// For all of transformer_big (234.9 M parameters) that is 6.58 GB =
// 1.96 ms or 5.64 GB = 1.68 ms at 3.35 TB/s, in 98 launches (one per
// parameter tensor, as JAX launches one per leaf).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int MAX_BLOCKS = 132 * 8;

typedef __nv_bfloat16 bf16;
typedef __half f16;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
template <typename X>
__device__ __forceinline__ X from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half(x);
}

// One element, in registers; returns p', writes mu', nu' to m, v.
__device__ __forceinline__ float update(float p, float g, float& m, float& v,
                                        const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.c2)), h.eps);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(m, h.c1), den),
                            __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(h.lr, u));
}

template <typename P, typename M, typename NU>
__device__ __forceinline__ void update_one(P* p, const P* g, M* mu, NU* nu,
                                           long long i, const Hyper& h) {
  float m = to_f32(mu[i]), v = to_f32(nu[i]);
  p[i] = from_f32<P>(update(to_f32(p[i]), to_f32(g[i]), m, v, h));
  mu[i] = from_f32<M>(m);
  nu[i] = from_f32<NU>(v);
}

// 4 consecutive elements at once: a float4, or four 16-bit values in one
// 8-byte word
__device__ __forceinline__ void load4(const float* a, long long q,
                                      float x[4]) {
  const float4 w = reinterpret_cast<const float4*>(a)[q];
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}
__device__ __forceinline__ void load4(const bf16* a, long long q,
                                      float x[4]) {
  const uint2 w = reinterpret_cast<const uint2*>(a)[q];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const f16* a, long long q,
                                      float x[4]) {
  const uint2 w = reinterpret_cast<const uint2*>(a)[q];
  const __half2 lo = *reinterpret_cast<const __half2*>(&w.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&w.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* a, long long q,
                                       const float x[4]) {
  reinterpret_cast<float4*>(a)[q] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* a, long long q,
                                       const float x[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&lo);
  w.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(a)[q] = w;
}
__device__ __forceinline__ void store4(f16* a, long long q,
                                       const float x[4]) {
  const __half2 lo = __floats2half2_rn(x[0], x[1]);
  const __half2 hi = __floats2half2_rn(x[2], x[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&lo);
  w.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(a)[q] = w;
}

// Elements [0, 4 n4) in groups of 4 with vector loads (n4 = 0 when the
// pointers are not aligned for them), then [4 n4, n) one by one.
template <typename P, typename M, typename NU>
__global__ void __launch_bounds__(NT)
fused_adamw_kernel(P* __restrict__ p, const P* __restrict__ g,
                   M* __restrict__ mu, NU* __restrict__ nu, long long n,
                   long long n4, Hyper h) {
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long q = first; q < n4; q += stride) {
    float pv[4], gv[4], m[4], v[4], po[4];
    load4(p, q, pv);
    load4(g, q, gv);
    load4(mu, q, m);
    load4(nu, q, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) po[e] = update(pv[e], gv[e], m[e], v[e], h);
    store4(p, q, po);
    store4(mu, q, m);
    store4(nu, q, v);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    update_one(p, g, mu, nu, i, h);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename P, typename M, typename NU>
cudaError_t launch(void* p, const void* g, void* mu, void* nu, long long n,
                   const Hyper& h, cudaStream_t stream) {
  const bool vec = aligned(p, 4 * sizeof(P)) && aligned(g, 4 * sizeof(P)) &&
                   aligned(mu, 4 * sizeof(M)) && aligned(nu, 4 * sizeof(NU));
  const long long n4 = vec ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  const long long blocks = (work + NT - 1) / NT;
  const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  fused_adamw_kernel<P, M, NU><<<grid, NT, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), static_cast<M*>(mu),
      static_cast<NU*>(nu), n, n4, h);
  return cudaGetLastError();
}

// f(X()) for dtype code 0 = float32, 1 = bfloat16, 2 = float16
template <typename F>
cudaError_t by_dtype(int dtype, F f) {
  if (dtype == 0) return f(float());
  if (dtype == 1) return f(bf16());
  if (dtype == 2) return f(f16());
  return cudaErrorInvalidValue;
}

cudaError_t adamw_entry(void* p, const void* g, void* mu, void* nu,
                        long long n, int p_dtype, int mu_dtype, int nu_dtype,
                        const Hyper& h, cudaStream_t st) {
  if (n < 1) return cudaErrorInvalidValue;
  return by_dtype(p_dtype, [&](auto pt) {
    return by_dtype(mu_dtype, [&](auto mt) {
      return by_dtype(nu_dtype, [&](auto vt) {
        return launch<decltype(pt), decltype(mt), decltype(vt)>(p, g, mu, nu,
                                                                n, h, st);
      });
    });
  });
}

}  // namespace

extern "C" {

// Dtype codes 0 = float32, 1 = bfloat16, 2 = float16: p_dtype of p and g,
// mu_dtype of mu, nu_dtype of nu. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype it does not take or n < 1).
int fused_adamw(void* p, const void* g, void* mu, void* nu, long long n,
                int p_dtype, int mu_dtype, int nu_dtype, float lr, float b1,
                float omb1, float b2, float omb2, float eps, float wd,
                float c1, float c2, void* stream) {
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, c1, c2};
  return (int)adamw_entry(p, g, mu, nu, n, p_dtype, mu_dtype, nu_dtype, h,
                          static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

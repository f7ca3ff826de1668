// Fused one-pass AdamW update, in place, for Hopper (sm_90a), CUDA C++.
//
// Replaces: distributed_tensorflow_tpu/ops/fused_adamw.py _adamw_kernel
// (:53; _fused_leaf_update :67, pl.pallas_call at :105). For one
// parameter tensor, flat and contiguous, with p, g, nu in f32 and mu in
// f32 or bf16, and the bias corrections c1 = 1 / (1 - b1^t),
// c2 = 1 / (1 - b2^t) as f32 scalars:
//   mu' = b1 mu + (1 - b1) g
//   nu' = b2 nu + (1 - b2) g^2
//   u   = (mu' c1) / (sqrt(nu' c2) + eps) + wd p
//   p'  = p - lr u
// all in f32, b1 an f32 scalar even for a bf16 mu (the JAX fused update
// casts mu to f32 and multiplies by the Python-float b1; optax would
// round b1 to bf16). p', mu', nu' are written over p, mu, nu: the
// TPU kernel's input->output aliasing (:122) becomes a plain in-place
// write. Each operation is rounded on its own (__fmul_rn, __fadd_rn,
// which the compiler never contracts into an FMA), in the plain
// version's order, so the kernel gives the plain PyTorch version's
// bits.
//
// Design. The TPU version reshapes a leaf to (rows, 1024) tiles, padding
// odd sizes, so that its blocks follow the (8, 128) tiling. Here the
// tensor stays flat: each thread of a grid-stride loop takes 4
// consecutive elements, as one 16-byte load of p, g and nu each and one
// 16-byte (f32) or 8-byte (bf16) load of mu, when every pointer is
// aligned for it; the n mod 4 tail, or the whole tensor when a pointer
// is not aligned, goes element by element.
//
// Bound: bytes. Each parameter reads p, g, mu, nu and writes p, mu, nu
// once: 28 B with an f32 mu, 24 B with a bf16 mu, against 13 operations.
// For all of transformer_big (234.9 M parameters) that is 6.58 GB =
// 1.96 ms or 5.64 GB = 1.68 ms at 3.35 TB/s, in 98 launches (one per
// parameter tensor, as JAX launches one per leaf).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int MAX_BLOCKS = 132 * 8;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

template <typename M>
__device__ __forceinline__ void update_one(float* p, const float* g, M* mu,
                                           float* nu, long long i,
                                           const Hyper& h) {
  float m = load_f32(mu + i), v = nu[i];
  p[i] = update(p[i], g[i], m, v, h);
  store_f32(mu + i, m);
  nu[i] = v;
}

// 4 moments of mu at once: a float4, or 4 bf16 in one 8-byte word
__device__ __forceinline__ void load4(const float* mu, long long q,
                                      float m[4]) {
  const float4 x = reinterpret_cast<const float4*>(mu)[q];
  m[0] = x.x; m[1] = x.y; m[2] = x.z; m[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* mu, long long q,
                                      float m[4]) {
  const uint2 w = reinterpret_cast<const uint2*>(mu)[q];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  m[0] = __low2float(lo); m[1] = __high2float(lo);
  m[2] = __low2float(hi); m[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* mu, long long q,
                                       const float m[4]) {
  reinterpret_cast<float4*>(mu)[q] = make_float4(m[0], m[1], m[2], m[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* mu, long long q,
                                       const float m[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(m[0], m[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(m[2], m[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned int*>(&lo);
  w.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(mu)[q] = w;
}

// Elements [0, 4 n4) in groups of 4 with vector loads (n4 = 0 when the
// pointers are not aligned for them), then [4 n4, n) one by one.
template <typename M>
__global__ void __launch_bounds__(NT)
fused_adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                   M* __restrict__ mu, float* __restrict__ nu, long long n,
                   long long n4, Hyper h) {
  const long long stride = (long long)gridDim.x * NT;
  const long long first = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long q = first; q < n4; q += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[q];
    const float4 gv = reinterpret_cast<const float4*>(g)[q];
    const float4 vv = reinterpret_cast<const float4*>(nu)[q];
    float m[4];
    load4(mu, q, m);
    float v[4] = {vv.x, vv.y, vv.z, vv.w};
    float4 po;
    po.x = update(pv.x, gv.x, m[0], v[0], h);
    po.y = update(pv.y, gv.y, m[1], v[1], h);
    po.z = update(pv.z, gv.z, m[2], v[2], h);
    po.w = update(pv.w, gv.w, m[3], v[3], h);
    reinterpret_cast<float4*>(p)[q] = po;
    store4(mu, q, m);
    reinterpret_cast<float4*>(nu)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    update_one(p, g, mu, nu, i, h);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename M>
cudaError_t launch(void* p, const void* g, void* mu, void* nu, long long n,
                   const Hyper& h, cudaStream_t stream) {
  const bool vec = aligned(p, 16) && aligned(g, 16) && aligned(nu, 16) &&
                   aligned(mu, 4 * sizeof(M));
  const long long n4 = vec ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  const long long blocks = (work + NT - 1) / NT;
  const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  fused_adamw_kernel<M><<<grid, NT, 0, stream>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<M*>(mu), static_cast<float*>(nu), n, n4, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mu_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a dtype it does not take or
// n < 1).
int fused_adamw(void* p, const void* g, void* mu, void* nu, long long n,
                int mu_dtype, float lr, float b1, float omb1, float b2,
                float omb2, float eps, float wd, float c1, float c2,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, c1, c2};
  if (mu_dtype == 0) return (int)launch<float>(p, g, mu, nu, n, h, st);
  if (mu_dtype == 1)
    return (int)launch<__nv_bfloat16>(p, g, mu, nu, n, h, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash-attention forward for Hopper (sm_90a), CUDA C++, CUDA cores.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py _fwd_kernel
// (driven by _flash_forward, pl.pallas_call at :227). Same function:
// o = softmax(q k^T * sm_scale + mask) v and the per-row logsumexp lse
// (f32), for q (BH, Sq, hd) and k, v (BH, Sk, hd), contiguous, bf16 or
// f32, hd in {64, 128}. Causal masking is bottom-right aligned: query i
// sees key j iff j <= i + causal_offset (the wrapper defaults the offset
// to Sk - Sq). Ragged tails of q and k are masked here. A row that sees
// no key stores o = 0 and lse = +inf, row by row (the Pallas kernel gets
// that only where a whole q-block sees no key).
//
// Design. The TPU kernel walks a sequential (bh, q-block, k-block) grid
// and carries m, l, acc in VMEM scratch across k-blocks. Here one thread
// block owns one (bh, 64-row q-tile) and loops over 64-row k-tiles
// itself; k-tiles wholly above the causal diagonal are never visited.
// 256 threads: thread (ty, tx), ty, tx in 0..15, owns query rows
// ty + 16 i (i < 4) and, of each 64 x 64 score tile, key columns
// tx + 16 j (j < 4) -- a 4 x 4 register tile, so each shared-memory
// read feeds four FMAs. The 16 threads of a row sit in one half-warp,
// so row max and row sum are __shfl_xor reductions. m, l and the output
// accumulator (rows ty + 16 i, dims tx + 16 j) stay in registers in
// f32. The Q tile (pre-converted to f32) stays in shared memory for the
// whole loop; K, V and the probability tile P are restaged per k-tile.
// Masked scores are -inf (not the Pallas finite mask value), so p is
// exactly 0 on masked keys and an all-masked row keeps l = 0.
//
// Bound at the serving main path's shape (transformer_big prefill,
// S = 1024, H = 16, hd = 64, bf16, causal): 4 * hd * S (S + 1) / 2 * H
// = 2.15 GFLOP -> 2.2 us at 989 TFLOP/s (bf16 tensor cores), and
// q, k, v, o = 8.4 MB -> 2.5 us at 3.35 TB/s; the bound is ~2.5 us a
// launch (bytes), 12 launches (one a layer) per prefill. This first
// kernel runs on CUDA cores in f32 (67 TFLOP/s peak, ~32 us for the
// same FLOPs) and is shared-memory-read bound inside the tile products,
// so it sits far from that bound; the route to it is mma.sync / wgmma on
// bf16 tiles with TMA-fed K/V stages, a later change. What the design
// does keep: every input byte is read from device memory once per
// q-tile that needs it, the S x S score matrix never leaves the SM, and
// causal work is halved by skipping tiles above the diagonal.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key rows per k-tile
constexpr int NT = 256;   // threads per block
constexpr int PS = BN + 1;  // padded row stride of the P tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles at stride HD + 1 (conflict-free column reads), V at
  // stride HD, P at stride BN + 1
  return sizeof(float) *
         (size_t)(BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, float sm_scale,
                 int causal, int causal_offset) {
  constexpr int QS = HD + 1;
  constexpr int DJ = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * QS;
  float* Vs = Ks + BN * QS;
  float* Ps = Vs + BN * HD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const T* qb = q + (size_t)bh * Sq * HD;
  const T* kb = k + (size_t)bh * Sk * HD;
  const T* vb = v + (size_t)bh * Sk * HD;

  for (int e = tid; e < BM * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * QS + d] =
        (q0 + r < Sq) ? to_f32(qb[(size_t)(q0 + r) * HD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys [0, k_end) can be visible to some row of this tile
  int k_end = Sk;
  if (causal) {
    const long long last = (long long)q0 + BM - 1 + causal_offset;
    k_end = last < 0 ? 0 : (last + 1 < Sk ? (int)(last + 1) : Sk);
  }

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // Q visible / previous tile's K, V, P consumed
    for (int e = tid; e < BN * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * HD + d;
      Ks[r * QS + d] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row + causal_offset);
        s[i][j] = ok ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // all keys so far masked: keep the state (p = 0, alpha = 1)
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);  // exp(-inf) = 0
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const bool empty = l[i] == 0.f;
    const float denom = empty ? 1.f : l[i];
    T* orow = o + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
    if (tx == 0)
      lse[(size_t)bh * Sq + row] = empty ? INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Sq, int Sk, float sm_scale,
                   int causal, int causal_offset, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, BH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, sm_scale,
      causal, causal_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a dtype / head_dim it does not take).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int BH, int Sq, int Sk, int hd, int dtype,
              float sm_scale, int causal, int causal_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0 && hd == 64)
    err = launch<float, 64>(q, k, v, o, l, BH, Sq, Sk, sm_scale, causal,
                            causal_offset, st);
  else if (dtype == 0 && hd == 128)
    err = launch<float, 128>(q, k, v, o, l, BH, Sq, Sk, sm_scale, causal,
                             causal_offset, st);
  else if (dtype == 1 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, l, BH, Sq, Sk, sm_scale,
                                    causal, causal_offset, st);
  else if (dtype == 1 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, l, BH, Sq, Sk, sm_scale,
                                     causal, causal_offset, st);
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

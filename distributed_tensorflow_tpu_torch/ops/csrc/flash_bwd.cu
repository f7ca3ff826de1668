// Flash-attention backward for Hopper (sm_90a), CUDA C++, CUDA cores.
//
// Replaces: distributed_tensorflow_tpu/ops/attention.py _bwd_dq_kernel
// (:260) and _bwd_dkv_kernel (:309), driven by _flash_backward (:360;
// pl.pallas_call at :388 and :409). Same functions: with p = exp(q k^T
// * sm_scale - lse) recomputed from the forward's row logsumexp and
// delta = rowsum(o * do) (f32, computed by the caller),
//   ds = p * (do v^T - delta) * sm_scale,
//   dq = ds k,  dk = ds^T q,  dv = p^T do,
// for q, do (BH, Sq, hd) and k, v (BH, Sk, hd), contiguous, bf16 or f32,
// hd in {64, 128}; lse, delta (BH, Sq) f32. Masking is the forward's
// (flash_fwd.cu): bottom-right causal via causal_offset, ragged q and k
// tails masked here, and a row whose lse is +inf (it saw no key) gets
// p = 0. Rounding follows the Pallas kernels: ds is rounded to the input
// dtype before both of its products (:299, :349) and p before p^T do
// (:345); every product accumulates in f32 and the outputs are stored
// in the input dtype.
//
// Design. The TPU kernels walk sequential grids and carry dq (resp. dk,
// dv) in VMEM scratch across the inner grid axis. Here one thread block
// owns one (bh, 64-row tile) and loops over the other axis itself:
// flash_bwd_dq_kernel owns a q-tile and walks the k-tiles up to the
// causal diagonal; flash_bwd_dkv_kernel owns a k-tile and walks the
// q-tiles from the diagonal down. 256 threads: thread (ty, tx), ty, tx
// in 0..15, owns rows ty + 16 i (i < 4) of its tile and, of each 64 x 64
// score tile, columns tx + 16 j (j < 4) -- the forward's 4 x 4 register
// tile -- and of each output row the dims tx + 16 j. Accumulators stay
// in f32 registers (one for dq; two, dk and dv, in the dkv kernel). The
// tiles the block owns stay in shared memory for the whole loop (as f32,
// at stride hd + 1 so that column reads are conflict-free); the other
// side's tiles are restaged per step, and the ds (resp. p^T and ds^T)
// tile goes through shared memory to feed the second product.
//
// Bound at the train step's shape ((8, 16, 1024, 64) bf16 causal, one
// launch of each kernel per layer, 67.2 M unmasked (q, k) pairs): the
// backward as a whole needs 10 hd FLOP a pair (s, dp, dq, dk, dv), 43.0
// GFLOP -> 43.5 us at 989 TFLOP/s, against q, k, v, o, do, lse, delta
// read once and dq, dk, dv written once, 135 MB -> 40.4 us at 3.35 TB/s:
// bound by operations. Split as launched, the dq kernel needs 6 hd a
// pair (s, dp, dq: 26 us) and the dkv kernel 8 hd (s, dp, dk, dv: 35
// us), each recomputing s and dp. These kernels run f32 FMAs on CUDA
// cores (67 TFLOP/s peak)
// from shared memory, as the forward does; the route to the bound is
// mma.sync / wgmma on bf16 tiles, a later change. What the design keeps:
// the S x S score and probability matrices never leave the SM, every
// block reads its own tile once, and causal work is halved by skipping
// the tiles above the diagonal.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BM = 64;      // q rows per tile
constexpr int BN = 64;      // k rows per tile
constexpr int NT = 256;     // threads per block
constexpr int PS = BN + 1;  // padded row stride of the ds / p tiles

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
// x rounded to T's precision, kept as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Rows [r0, r0 + 64) of a contiguous (rows, HD) matrix into shared
// memory as f32 at stride HD + 1; rows past `rows` are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows) {
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        (r0 + r < rows) ? to_f32(src[(size_t)(r0 + r) * HD + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], both tiles at
// stride HD + 1.
template <int HD>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[4][4], int ty, int tx) {
  constexpr int S = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * S + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * S + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V at stride HD + 1; dS at stride PS
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + BM * PS);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO at stride HD + 1; P^T, dS^T at stride PS; lse, delta
  return sizeof(float) * (size_t)(4 * 64 * (HD + 1) + 2 * BN * PS + 2 * BM);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, float sm_scale, int causal,
                    int causal_offset) {
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DOs = Qs + 64 * S;
  float* Ks = DOs + 64 * S;
  float* Vs = Ks + 64 * S;
  float* DSs = Vs + 64 * S;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const size_t qoff = (size_t)bh * Sq * HD;
  const size_t koff = (size_t)bh * Sk * HD;

  stage<T, HD>(Qs, q + qoff, q0, Sq);
  stage<T, HD>(DOs, dout + qoff, q0, Sq);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] : INFINITY;
    dl_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // keys [0, k_end) can be visible to some row of this tile
  int k_end = Sk;
  if (causal) {
    const long long last = (long long)q0 + BM - 1 + causal_offset;
    k_end = last < 0 ? 0 : (last + 1 < Sk ? (int)(last + 1) : Sk);
  }

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // Q, dO visible / previous K, V, dS consumed
    stage<T, HD>(Ks, k + koff, k0, Sk);
    stage<T, HD>(Vs, v + koff, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<HD>(Qs, Ks, s, ty, tx);
    tile_abt<HD>(DOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Sq && col < Sk &&
                        (!causal || col <= row + causal_offset);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        DSs[(ty + 16 * i) * PS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - dl_r[i]) * sm_scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = DSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(da[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + qoff + (size_t)row * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, float sm_scale,
                     int causal, int causal_offset) {
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * S;
  float* Qs = Vs + 64 * S;
  float* DOs = Qs + 64 * S;
  float* PTs = DOs + 64 * S;
  float* DSTs = PTs + BN * PS;
  float* lse_s = DSTs + BN * PS;
  float* dl_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BN;
  const size_t qoff = (size_t)bh * Sq * HD;
  const size_t koff = (size_t)bh * Sk * HD;

  stage<T, HD>(Ks, k + koff, k0, Sk);
  stage<T, HD>(Vs, v + koff, k0, Sk);
  float acc_dk[4][DJ], acc_dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // query row r sees key k0 iff r >= k0 - causal_offset: start at the
  // q-tile holding that row
  int q_begin = 0;
  if (causal) {
    const long long first = (long long)k0 - causal_offset;
    q_begin = first <= 0 ? 0
                         : (first >= Sq ? Sq : (int)(first / BM) * BM);
  }

  for (int q0 = q_begin; q0 < Sq; q0 += BM) {
    __syncthreads();  // K, V visible / previous Q, dO, P^T, dS^T consumed
    stage<T, HD>(Qs, q + qoff, q0, Sq);
    stage<T, HD>(DOs, dout + qoff, q0, Sq);
    if (tid < BM) {
      const int row = q0 + tid;
      lse_s[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : INFINITY;
      dl_s[tid] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are keys (ty + 16 i), columns queries
    float s[4][4], dpt[4][4];
    tile_abt<HD>(Ks, Qs, s, ty, tx);
    tile_abt<HD>(Vs, DOs, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = row < Sq && key < Sk &&
                        (!causal || key <= row + causal_offset);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_s[c]) : 0.f;
        PTs[(ty + 16 * i) * PS + c] = round_to<T>(p);
        DSTs[(ty + 16 * i) * PS + c] =
            round_to<T>(p * (dpt[i][j] - dl_s[c]) * sm_scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      float pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = PTs[(ty + 16 * i) * PS + c];
        da[i] = DSTs[(ty + 16 * i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = DOs[c * S + tx + 16 * j];
        const float qv = Qs[c * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][j] = fmaf(pa[i], dov, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(da[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    T* dko = dk + koff + (size_t)key * HD;
    T* dvo = dv + koff + (size_t)key * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dko[tx + 16 * j] = from_f32<T>(acc_dk[i][j]);
      dvo[tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse,
                      const float* delta, void* dq, int BH, int Sq, int Sk,
                      float sm_scale, int causal, int causal_offset,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, HD>;
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, BH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Sk, sm_scale, causal, causal_offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int BH,
                       int Sq, int Sk, float sm_scale, int causal,
                       int causal_offset, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BN - 1) / BN, BH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, sm_scale, causal,
      causal_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a dtype / head_dim it does not
// take).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int BH, int Sq, int Sk, int hd, int dtype,
                 float sm_scale, int causal, int causal_offset,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    err = launch_dq<float, 64>(q, k, v, dout, l, dl, dq, BH, Sq, Sk,
                               sm_scale, causal, causal_offset, st);
  else if (dtype == 0 && hd == 128)
    err = launch_dq<float, 128>(q, k, v, dout, l, dl, dq, BH, Sq, Sk,
                                sm_scale, causal, causal_offset, st);
  else if (dtype == 1 && hd == 64)
    err = launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, BH, Sq,
                                       Sk, sm_scale, causal, causal_offset,
                                       st);
  else if (dtype == 1 && hd == 128)
    err = launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, BH, Sq,
                                        Sk, sm_scale, causal, causal_offset,
                                        st);
  return (int)err;
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int BH, int Sq, int Sk, int hd,
                  int dtype, float sm_scale, int causal, int causal_offset,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (BH > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    err = launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, BH, Sq, Sk,
                                sm_scale, causal, causal_offset, st);
  else if (dtype == 0 && hd == 128)
    err = launch_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, BH, Sq, Sk,
                                 sm_scale, causal, causal_offset, st);
  else if (dtype == 1 && hd == 64)
    err = launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, BH,
                                        Sq, Sk, sm_scale, causal,
                                        causal_offset, st);
  else if (dtype == 1 && hd == 128)
    err = launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk, dv, BH,
                                         Sq, Sk, sm_scale, causal,
                                         causal_offset, st);
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

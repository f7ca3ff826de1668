// Flash-attention backward for Hopper (sm_90a), CUDA C++, CUDA cores, f32.
//
// Replaces, for f32 inputs: distributed_tensorflow_tpu/ops/attention.py
// _bwd_dq_kernel (:260) and _bwd_dkv_kernel (:309), driven by
// _flash_backward (:360; pl.pallas_call at :388 and :409). bf16 goes to
// flash_bwd_dq_tc and flash_bwd_dkv_tc in flash_tc.cu (tensor cores); f32
// stays here, where its products keep f32 parity (on tensor cores f32
// would be TF32). Same functions: with p = exp(q k^T * sm_scale - lse)
// recomputed from the forward's row logsumexp and delta = rowsum(o * do)
// (f32, computed by the caller),
//   ds = p * (do v^T - delta) * sm_scale,
//   dq = ds k,  dk = ds^T q,  dv = p^T do,
// for q, do (BH, Sq, hd) and k, v (BH, Sk, hd), contiguous, f32, hd in
// {64, 128, 256}; lse, delta (BH, Sq) f32. Masking is the forward's
// (flash_fwd.cu): bottom-right causal via causal_offset, ragged q and k
// tails masked here, and a row whose lse is +inf (it saw no key) gets
// p = 0. Every product accumulates in f32 (in f32 the Pallas kernels'
// roundings of ds and p to the input dtype, :299, :345, :349, are exact).
//
// Design. The TPU kernels walk sequential grids and carry dq (resp. dk,
// dv) in VMEM scratch across the inner grid axis. Here one thread block
// owns one (bh, 64-row tile) and loops over the other axis itself:
// flash_bwd_dq_kernel owns a q-tile and walks the k-tiles up to the
// causal diagonal; flash_bwd_dkv_kernel owns a k-tile and walks the
// q-tiles from the diagonal down. The grid is (BH, tiles), so BH is
// limited only by grid x. 256 threads: thread (ty, tx), ty, tx in 0..15,
// owns rows ty + 16 i (i < 4) of its tile and, of each 64 x 64 score
// tile, columns tx + 16 j (j < 4) -- the forward's 4 x 4 register tile
// -- and of each output row the dims tx + 16 j. Accumulators stay in
// f32 registers (one for dq; two, dk and dv, in the dkv kernel). The
// tiles the block owns stay in shared memory for the whole loop (at
// stride hd + 1 so that column reads are conflict-free); the other
// side's tiles are restaged per step, and the ds (resp. p^T and ds^T)
// tile goes through shared memory to feed the second product.
//
// Bound at the f32 train-parity shape it runs on (2 layers of
// transformer_big, (2, 16, 256, 64) causal, 1.1 M unmasked (q, k) pairs
// a head): the dq kernel needs 6 hd FLOP a pair (s, dp, dq) and the dkv
// kernel 8 hd (s, dp, dk, dv), each recomputing s and dp: at 67 TFLOP/s
// (f32 CUDA cores) both are bound by operations. These kernels run f32
// FMAs from shared memory, as flash_fwd.cu does. What the design keeps:
// the S x S score and probability matrices never leave the SM, every
// block reads its own tile once, and causal work is halved by skipping
// the tiles above the diagonal.
//
// Tiles are BT rows (a template argument): 64 at hd 64 and 128; at hd 256
// four 64 x 257 f32 tiles would take 263 KB, past the 232,448 bytes a
// block may have, so the tiles there are 32 rows (thread (ty, tx) owns
// rows ty + 16 i, i < 2, a 2 x 2 register tile of each 32 x 32 score
// tile): 135,808 bytes (dq) and 140,288 (dk/dv) of shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;     // threads per block

// rows of a q- or k-tile at head dim HD
template <int HD>
__host__ __device__ constexpr int tile_rows() {
  return HD > 128 ? 32 : 64;
}

// Rows [r0, r0 + BT) of a contiguous (rows, HD) matrix into shared
// memory at stride HD + 1; rows past `rows` are zero.
template <int HD, int BT>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int rows) {
  for (int e = threadIdx.x; e < BT * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] =
        (r0 + r < rows) ? src[(size_t)(r0 + r) * HD + d] : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], both tiles at
// stride HD + 1; R = BT / 16 rows and columns a thread.
template <int HD, int R>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float acc[R][R], int ty, int tx) {
  constexpr int S = HD + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * S + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * S + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V at stride HD + 1; dS at stride BT + 1
  constexpr int BT = tile_rows<HD>();
  return sizeof(float) * (size_t)(4 * BT * (HD + 1) + BT * (BT + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO at stride HD + 1; P^T, dS^T at stride BT + 1; lse, delta
  constexpr int BT = tile_rows<HD>();
  return sizeof(float) *
         (size_t)(4 * BT * (HD + 1) + 2 * BT * (BT + 1) + 2 * BT);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Sk, float sm_scale, int causal,
                    int causal_offset) {
  constexpr int BT = tile_rows<HD>();
  constexpr int R = BT / 16;     // rows (and score columns) per thread
  constexpr int PS = BT + 1;     // padded row stride of the dS tile
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DOs = Qs + BT * S;
  float* Ks = DOs + BT * S;
  float* Vs = Ks + BT * S;
  float* DSs = Vs + BT * S;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const size_t qoff = (size_t)bh * Sq * HD;
  const size_t koff = (size_t)bh * Sk * HD;

  stage<HD, BT>(Qs, q + qoff, q0, Sq);
  stage<HD, BT>(DOs, dout + qoff, q0, Sq);
  float lse_r[R], dl_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[(size_t)bh * Sq + row] : INFINITY;
    dl_r[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // keys [0, k_end) can be visible to some row of this tile
  int k_end = Sk;
  if (causal) {
    const long long last = (long long)q0 + BT - 1 + causal_offset;
    k_end = last < 0 ? 0 : (last + 1 < Sk ? (int)(last + 1) : Sk);
  }

  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // Q, dO visible / previous K, V, dS consumed
    stage<HD, BT>(Ks, k + koff, k0, Sk);
    stage<HD, BT>(Vs, v + koff, k0, Sk);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_abt<HD, R>(Qs, Ks, s, ty, tx);
    tile_abt<HD, R>(DOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Sq && col < Sk &&
                        (!causal || col <= row + causal_offset);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        DSs[(ty + 16 * i) * PS + tx + 16 * j] =
            p * (dp[i][j] - dl_r[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float da[R];
#pragma unroll
      for (int i = 0; i < R; ++i) da[i] = DSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = Ks[c * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(da[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* out = dq + qoff + (size_t)row * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, float sm_scale,
                     int causal, int causal_offset) {
  constexpr int BT = tile_rows<HD>();
  constexpr int R = BT / 16;     // rows (and score columns) per thread
  constexpr int PS = BT + 1;     // padded row stride of the P^T, dS^T tiles
  constexpr int S = HD + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * S;
  float* Qs = Vs + BT * S;
  float* DOs = Qs + BT * S;
  float* PTs = DOs + BT * S;
  float* DSTs = PTs + BT * PS;
  float* lse_s = DSTs + BT * PS;
  float* dl_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const size_t qoff = (size_t)bh * Sq * HD;
  const size_t koff = (size_t)bh * Sk * HD;

  stage<HD, BT>(Ks, k + koff, k0, Sk);
  stage<HD, BT>(Vs, v + koff, k0, Sk);
  float acc_dk[R][DJ], acc_dv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // query row r sees key k0 iff r >= k0 - causal_offset: start at the
  // q-tile holding that row
  int q_begin = 0;
  if (causal) {
    const long long first = (long long)k0 - causal_offset;
    q_begin = first <= 0 ? 0
                         : (first >= Sq ? Sq : (int)(first / BT) * BT);
  }

  for (int q0 = q_begin; q0 < Sq; q0 += BT) {
    __syncthreads();  // K, V visible / previous Q, dO, P^T, dS^T consumed
    stage<HD, BT>(Qs, q + qoff, q0, Sq);
    stage<HD, BT>(DOs, dout + qoff, q0, Sq);
    if (tid < BT) {
      const int row = q0 + tid;
      lse_s[tid] = row < Sq ? lse[(size_t)bh * Sq + row] : INFINITY;
      dl_s[tid] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are keys (ty + 16 i), columns queries
    float s[R][R], dpt[R][R];
    tile_abt<HD, R>(Ks, Qs, s, ty, tx);
    tile_abt<HD, R>(Vs, DOs, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = row < Sq && key < Sk &&
                        (!causal || key <= row + causal_offset);
        const float p = ok ? expf(s[i][j] * sm_scale - lse_s[c]) : 0.f;
        PTs[(ty + 16 * i) * PS + c] = p;
        DSTs[(ty + 16 * i) * PS + c] = p * (dpt[i][j] - dl_s[c]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pa[R], da[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pa[i] = PTs[(ty + 16 * i) * PS + c];
        da[i] = DSTs[(ty + 16 * i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = DOs[c * S + tx + 16 * j];
        const float qv = Qs[c * S + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc_dv[i][j] = fmaf(pa[i], dov, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(da[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    float* dko = dk + koff + (size_t)key * HD;
    float* dvo = dv + koff + (size_t)key * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dko[tx + 16 * j] = acc_dk[i][j];
      dvo[tx + 16 * j] = acc_dv[i][j];
    }
  }
}

// one launch of `kern` over (BH, tiles) blocks; q-tiles (dq) or k-tiles
// (dkv) of tile_rows<hd>() rows on grid y, whose limit is 65535
template <typename Kernel, typename... Outs>
cudaError_t launch(Kernel kern, size_t smem, int tiles, const void* q,
                   const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int BH, int Sq,
                   int Sk, float sm_scale, int causal, int causal_offset,
                   cudaStream_t stream, Outs... outs) {
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(BH, tiles), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(outs)..., Sq, Sk, sm_scale, causal,
      causal_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (bfloat16 and float16 take flash_bwd_dq_tc /
// flash_bwd_dkv_tc); hd 64, 128 or 256.
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a dtype / head_dim it does not take, cudaErrorInvalidConfiguration
// past the grid's limit of 65535 tiles on y; BH, on x, takes any int).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int BH, int Sq, int Sk, int hd, int dtype,
                 float sm_scale, int causal, int causal_offset,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return (int)launch(flash_bwd_dq_kernel<64>, dq_smem_bytes<64>(),
                       (Sq + 63) / 64, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dq);
  if (hd == 128)
    return (int)launch(flash_bwd_dq_kernel<128>, dq_smem_bytes<128>(),
                       (Sq + 63) / 64, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dq);
  if (hd == 256)
    return (int)launch(flash_bwd_dq_kernel<256>, dq_smem_bytes<256>(),
                       (Sq + 31) / 32, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dq);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int BH, int Sq, int Sk, int hd,
                  int dtype, float sm_scale, int causal, int causal_offset,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return (int)launch(flash_bwd_dkv_kernel<64>, dkv_smem_bytes<64>(),
                       (Sk + 63) / 64, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dk, dv);
  if (hd == 128)
    return (int)launch(flash_bwd_dkv_kernel<128>, dkv_smem_bytes<128>(),
                       (Sk + 63) / 64, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dk, dv);
  if (hd == 256)
    return (int)launch(flash_bwd_dkv_kernel<256>, dkv_smem_bytes<256>(),
                       (Sk + 31) / 32, q, k, v, dout, lse, delta, BH, Sq, Sk,
                       sm_scale, causal, causal_offset, st, dk, dv);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

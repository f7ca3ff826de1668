// Flash-attention forward for Hopper (sm_90a), CUDA C++, CUDA cores, f32.
//
// Replaces, for f32 inputs: distributed_tensorflow_tpu/ops/attention.py
// _fwd_kernel (:135; driven by _flash_forward, pl.pallas_call at :227).
// bf16 goes to flash_fwd_tc in flash_tc.cu (tensor cores); f32 stays
// here, where its products keep f32 parity (on tensor cores f32 would be
// TF32). Same function: o = softmax(q k^T * sm_scale + mask) v and the
// per-row logsumexp lse, for q (BH, Sq, hd) and k, v (BH, Sk, hd),
// contiguous, f32, hd in {64, 128}. Causal masking is bottom-right
// aligned: query i sees key j iff j <= i + causal_offset (the wrapper
// defaults the offset to Sk - Sq). Ragged tails of q and k are masked
// here. A row that sees no key stores o = 0 and lse = +inf, row by row
// (the Pallas kernel gets that only where a whole q-block sees no key).
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
// f32. The grid is (BH, q-tiles), so BH is limited only by grid x. The
// Q tile stays in shared memory for the whole loop; K, V and the
// probability tile P are restaged per k-tile.
// Masked scores are -inf (not the Pallas finite mask value), so p is
// exactly 0 on masked keys and an all-masked row keeps l = 0.
//
// Bound at the f32 train-parity shape it runs on (2 layers of
// transformer_big, (2, 16, 256, 64) causal): 4 hd a unmasked pair,
// 0.27 GFLOP -> 4.0 us at 67 TFLOP/s (f32 CUDA cores), against q, k, v,
// o = 8.4 MB -> 2.5 us at 3.35 TB/s: bound by operations. The 4 x 4
// register tile makes the products shared-memory-read bound, below
// that. What the design keeps: every input byte is read from device
// memory once per q-tile that needs it, the S x S score matrix never
// leaves the SM, and causal work is halved by skipping tiles above the
// diagonal.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key rows per k-tile
constexpr int NT = 256;   // threads per block
constexpr int PS = BN + 1;  // padded row stride of the P tile

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles at stride HD + 1 (conflict-free column reads), V at
  // stride HD, P at stride BN + 1
  return sizeof(float) *
         (size_t)(BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * PS);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BM;
  const float* qb = q + (size_t)bh * Sq * HD;
  const float* kb = k + (size_t)bh * Sk * HD;
  const float* vb = v + (size_t)bh * Sk * HD;

  for (int e = tid; e < BM * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * QS + d] =
        (q0 + r < Sq) ? qb[(size_t)(q0 + r) * HD + d] : 0.f;
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
      Ks[r * QS + d] = in ? kb[g] : 0.f;
      Vs[r * HD + d] = in ? vb[g] : 0.f;
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
    float* orow = o + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0)
      lse[(size_t)bh * Sq + row] = empty ? INFINITY : m[i] + logf(l[i]);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Sq, int Sk, float sm_scale,
                   int causal, int causal_offset, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + BM - 1) / BM);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk,
      sm_scale,
      causal, causal_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (bfloat16 takes flash_fwd_tc). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a dtype
// / head_dim it does not take, cudaErrorInvalidConfiguration past the
// grid's limit of 65535 q-tiles on y; BH, on x, takes any int).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int BH, int Sq, int Sk, int hd, int dtype,
              float sm_scale, int causal, int causal_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if ((Sq + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0 && hd == 64)
    err = launch<64>(q, k, v, o, l, BH, Sq, Sk, sm_scale, causal,
                     causal_offset, st);
  else if (dtype == 0 && hd == 128)
    err = launch<128>(q, k, v, o, l, BH, Sq, Sk, sm_scale, causal,
                      causal_offset, st);
  return (int)err;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

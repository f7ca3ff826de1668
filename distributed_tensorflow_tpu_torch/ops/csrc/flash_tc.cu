// Flash attention in bf16 and f16 on Hopper's tensor cores (sm_90a):
// mma.sync m16n8k16 (bf16 -> f32, f16 -> f32) fed by ldmatrix from
// shared-memory tiles that cp.async fills through a ring of stages. Every
// kernel is a template on its 16-bit element type T; "bf16" below stands
// for T. f32 attention stays on the CUDA-core kernels of flash_fwd.cu and
// flash_bwd.cu, whose f32 products keep f32 parity (on tensor cores f32
// would be TF32).
//
// Replaces, for bf16 and f16 inputs, in
// distributed_tensorflow_tpu/ops/attention.py:
// - flash_fwd_tc: _fwd_kernel (:135; _flash_forward :210, pl.pallas_call
//   at :227). For q (BH, Sq, hd) and k, v (BH, Sk, hd), bf16, hd in
//   {64, 128, 256}: o = softmax(q k^T sm_scale + mask) v in bf16 and the
//   row logsumexp lse in f32. As in Pallas, p is rounded to bf16 before
//   p v (:184) and l is summed from the unrounded f32 p (:182).
// - flash_bwd_dkv_tc: _bwd_dkv_kernel (:309; pl.pallas_call at :409).
//   With p = exp(q k^T sm_scale - lse) recomputed from the forward's lse
//   and delta = rowsum(o do) (f32, computed by the caller, :371):
//   dv = p^T do with p rounded to bf16 (:345), ds = p (do v^T - delta)
//   sm_scale rounded to bf16 (:349), dk = ds^T q; f32 sums, bf16 outputs.
// - flash_bwd_dq_tc: _bwd_dq_kernel (:260; pl.pallas_call at :388). With
//   p and delta as above, ds = p (do v^T - delta) sm_scale rounded to
//   bf16 (:299) and dq = ds k, summed in f32 and written once in bf16.
// Masking is that of flash_fwd.cu: bottom-right causal via causal_offset
// (query i sees key j iff j <= i + causal_offset), the ragged q and k
// tails masked here, and a row that sees no key gets o = 0 and lse = +inf
// in the forward, p = 0 in the backward.
//
// Bound at the train step's shape ((8, 16, 1024, 64) causal, 12 launches
// of each a step; 67.2 M unmasked (q, k) pairs): the forward does 4 hd a
// pair, 17.2 GFLOP -> 17.4 us at 989 TFLOP/s, against q, k, v, o and lse,
// 67.6 MB -> 20.2 us at 3.35 TB/s: bound by bytes. The dk/dv kernel does
// 8 hd a pair (s, dp, dk, dv), 34.4 GFLOP -> 34.8 us, against q, k, v,
// do, lse, delta, dk and dv, 101.7 MB -> 30.4 us: bound by operations.
// The dq kernel does 6 hd a pair (s, dp, dq), 25.8 GFLOP -> 26.1 us,
// against q, k, v, do, lse, delta and dq, 84.9 MB -> 25.3 us: bound by
// operations, barely.
// At the serve shape (1, 16, 1024, 64) the forward's bound is 2.5 us
// (bytes). mma.sync reaches a fraction of the peak that wgmma would; what
// the design does about the rest: every product is on the tensor cores,
// each operand is read from device memory once per block that needs it
// in 16-byte cp.async copies, the next tile loads while this one is
// multiplied, the probabilities never leave the registers, and the
// causal tiles above the diagonal are never visited.
//
// Forward design. A block of 4 warps owns 64 query rows, 16 a warp; the
// warp's Q fragments are loaded once with ldmatrix and stay in registers.
// K and V stream through a 2-stage cp.async ring of 64-row tiles (zero
// past Sk), rows padded by 16 bytes so that ldmatrix meets no bank
// conflicts. S = Q K^T is a 16 x 64 mma tile a warp (K read row by row is
// K^T's column-major layout). The online softmax runs on the accumulator
// fragments in log2 units (exp2f of the scores times sm_scale log2(e)): a
// row lies in the 4 lanes of a quad, so its max is two __shfl_xor; l is
// summed per lane and reduced once at the end. Masked scores are -inf
// and an all-masked row keeps base 0, so p = 0 and l = 0 there. P is
// rounded to bf16 in registers and fed straight back as the A operand of
// P V: the C fragments of two adjacent n8 tiles are the A fragment of one
// k16 step. V is read with ldmatrix.trans. Only tiles that cross the
// causal diagonal or the Sk tail pay for the mask. The grid is (BH,
// q-tiles), the last q-tile (the most k-tiles) first.
//
// dk/dv design. A block of 4 warps owns 64 key rows, 16 a warp, and walks
// the q-tiles from the causal diagonal down; each q-tile's Q, dO, lse and
// delta come through a 2-stage cp.async ring (rows past Sq staged with
// lse = +inf, so p = 0 there). The transposed tiles are computed
// directly, so that the A operands of the gradient products come out of
// the accumulators in registers: S^T = K Q^T and dP^T = V dO^T (K, V as
// A, Q, dO as B, all read row by row), then P^T (bf16) feeds dV += P^T dO
// and dS^T (bf16) feeds dK += dS^T Q, with dO and Q read by
// ldmatrix.trans. lse and delta are indexed by the accumulator's column
// from shared memory. At hd 64 the K and V fragments stay in registers;
// at hd 128 the dK and dV accumulators double (128 registers a thread),
// so K and V stay in shared memory and are re-read with ldmatrix. The
// grid is (BH, k-tiles), the first k-tile (the most q-tiles) first.
//
// dq design. The forward's shape with the roles of the backward: a block
// of 4 warps owns 64 query rows, 16 a warp, and walks the k-tiles up to
// the causal limit through the forward's 2-stage K, V ring. Each warp
// computes S = Q K^T and dP = dO V^T as 16 x 64 mma tiles (K and V as B
// operands, read row by row), turns S into p with the row's lse and dP
// into dS = p (dP - delta) sm_scale in place (lse and delta of its two
// rows a thread in registers), and feeds dS, packed to bf16 straight
// from the accumulators, as the A operand of dQ += dS K, K read by
// ldmatrix.trans (the forward's P V). At hd 64 the Q and dO fragments
// stay in registers; at hd 128 the dQ accumulator doubles (64 registers
// a thread), so Q and dO stay in shared memory and are re-read with
// ldmatrix. Each block writes only its own rows of dq, once: no atomics,
// the same dq on every run. The grid is (BH, q-tiles), the last q-tile
// (the most k-tiles) first. BH sits on grid x in all three kernels, so
// it takes any int; the tiles on grid y are limited to 65535.
//
// Head dim 256 (Gemma-7B's). A block keeps the same 64-row tiles and 4
// warps, but no warp holds a 16 x 256 f32 accumulator (128 registers; two
// of them in dk/dv): the output columns are cut into windows on grid z,
// DV = 128 wide in the forward and dq (block z accumulates columns
// [128 z, 128 z + 128) of o or dq: the hd-128 kernel's registers) and 64
// wide in dk/dv (at 128 its two accumulators and the 16 k-steps of the
// score products spilled registers). The score products (q k^T, do v^T)
// still run over all 256 columns, so each block of a tile recomputes
// them: the forward does 1.5x the operations of one pass, dq 1.33x and
// dk/dv 2.5x (4 windows), and the two forward blocks of a tile compute
// the same row max and sum (lse written once, by z = 0). Q (dq: Q and dO) is read from shared
// memory at every k-step, not held in registers. Tiles stay whole rows
// (264 columns padded) in shared memory: 168,960 bytes (forward),
// 202,752 (dq) and 203,776 (dk/dv) a block, one block an SM, under the
// 232,448 a block may take.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NT = 128;       // 4 warps
constexpr int BM = 64;        // rows a block owns (queries; keys in dkv)
constexpr int BN = 64;        // rows of a streamed tile
constexpr int STAGES = 2;     // cp.async ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// output columns a block accumulates: all of a head up to 128, a
// 128-wide window (grid z) at 256; the dk/dv kernel, which holds two
// accumulators, a 64-wide one
template <int HD>
__host__ __device__ constexpr int out_cols() {
  return HD > 128 ? 128 : HD;
}
template <int HD>
__host__ __device__ constexpr int dkv_out_cols() {
  return HD > 128 ? 64 : HD;
}

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Rows [r0, r0 + 64) of a contiguous (rows, HD) 16-bit matrix into a
// 64 x (HD + 8) shared tile by 16-byte cp.async copies; rows past `rows`
// are zero-filled.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows) {
  constexpr int SEGS = HD / 8;
#pragma unroll
  for (int i = 0; i < 64 * SEGS / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / SEGS, c = (idx % SEGS) * 8;
    const bool p = r0 + r < rows;
    cp_async16(dst + r * (HD + 8) + c,
               p ? src + (size_t)(r0 + r) * HD + c : src, p);
  }
}

// A fragment (16 x 16, rows row0 + 0..15, columns 16 ks + 0..15) of a
// shared tile at stride LD
template <int LD, typename T>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const T* t,
                                       int row0, int ks, int lane) {
  ldsm_x4(a, t + (row0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (rows n0 + 0..15 of the tile as the n
// index, columns 16 ks + 0..15 as k): b[0..1] n-tile n0, b[2..3] n0 + 8
template <int LD, typename T>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const T* t,
                                       int n0, int ks, int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of one k16 step (rows 16 kk + 0..15 of the tile as k) over
// two n8 tiles (columns d0 + 0..15 as n), read transposed: b[0..1]
// columns d0 + 0..7, b[2..3] d0 + 8..15
template <int LD, typename T>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const T* t,
                                        int kk, int d0, int lane) {
  ldsm_x4_t(b, t + (kk * 16 + (lane & 15)) * LD + d0 + (lane >> 4) * 8);
}

// acc (16 x DV) += A (16 x 64, the f32 C fragments c of 8 n8 tiles,
// rounded to T) times columns [0, DV) of the 64-row shared tile t at
// stride LD (t points at the first column of the window)
template <typename T, int DV, int LD>
__device__ __forceinline__ void gemm_c_as_a(float (&acc)[DV / 8][4],
                                            const float (&c)[8][4],
                                            const T* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack2<T>(c[2 * kk][0], c[2 * kk][1]),
        pack2<T>(c[2 * kk][2], c[2 * kk][3]),
        pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]),
        pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DV / 16; ++dp) {
      uint32_t b[4];
      ldsm_bt<LD>(b, t, kk, dp * 16, lane);
      mma16<T>(acc[2 * dp], a, b[0], b[1]);
      mma16<T>(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
constexpr size_t fwd_smem_bytes() {
  // Q, then per stage a K and a V tile
  return sizeof(bf16) * (size_t)(BM + STAGES * 2 * BN) * (HD + 8);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, then per stage a K and a V tile
  return sizeof(bf16) * (size_t)(2 * BM + STAGES * 2 * BN) * (HD + 8);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, then per stage a Q and a dO tile; lse and delta per stage
  return sizeof(bf16) * (size_t)(2 * BN + STAGES * 2 * BM) * (HD + 8) +
         sizeof(float) * (size_t)STAGES * 2 * BM;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, HD == 64 ? 3 : (HD == 128 ? 2 : 1))
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, float scale_log2,
                    int causal, int causal_offset) {
  constexpr int LD = HD + 8;
  constexpr int TILE = BN * LD;
  constexpr int DV = out_cols<HD>();
  constexpr bool RESIDENT = HD <= 128;  // Q fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KV = Qs + BM * LD;  // stage s: K at KV + 2 s TILE, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qd = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int c0 = blockIdx.z * DV;                     // output columns
  const T* kb = k + (size_t)bh * Sk * HD;
  const T* vb = v + (size_t)bh * Sk * HD;
  // this thread's rows: row0 (fragment elements 0, 1) and row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + (lane >> 2);

  // keys [0, k_end) can be visible to some row of this tile
  int k_end = Sk;
  if (causal) {
    const long long last = (long long)q0 + BM - 1 + causal_offset;
    k_end = last < 0 ? 0 : (last + 1 < Sk ? (int)(last + 1) : Sk);
  }
  const int ntiles = (k_end + BN - 1) / BN;

  load_tile<HD>(Qs, q + (size_t)bh * Sq * HD, q0, Sq);
  cp_async_commit();
  auto load_kv = [&](int t) {
    T* Ks = KV + (t % STAGES) * 2 * TILE;
    load_tile<HD>(Ks, kb, t * BN, Sk);
    load_tile<HD>(Ks + TILE, vb, t * BN, Sk);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // Q landed
  __syncthreads();
  uint32_t qf[RESIDENT ? HD / 16 : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_a<LD>(qf[ks], Qs, warp * 16, ks, lane);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage no longer read
    if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
    cp_async_commit();
    const T* Ks = KV + (t % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;
    const int k0 = t * BN;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        ldsm_a<LD>(a, Qs, warp * 16, ks, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_b<LD>(b, Ks, nj * 16, ks, lane);
        mma16<T>(s[2 * nj], a, b[0], b[1]);
        mma16<T>(s[2 * nj + 1], a, b[2], b[3]);
      }
    }

    // the Sk tail, or a key past the warp's first row's causal limit
    const bool mask = k0 + BN > Sk ||
                      (causal && k0 + BN - 1 > q0 + warp * 16 + causal_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (mask) {
          const int col = k0 + j * 8 + 2 * qd + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row + causal_offset))
            x = -INFINITY;
        }
        s[j][e] = x;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // all keys so far masked: p = exp2(-inf) = 0 and l stays 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - base);  // 0 while m was -inf
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(s[j][e] - base);
          s[j][e] = p;
          l[r] += p;  // this lane's columns; the quad is summed at the end
        }
    }
    gemm_c_as_a<T, DV, LD>(acc, s, Vs + c0, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const bool empty = lr == 0.f;  // acc is 0 there too
    const float denom = empty ? 1.f : lr;
    T* orow = o + ((size_t)bh * Sq + row) * HD + c0 + 2 * qd;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      store2<T>(orow + j * 8, acc[j][2 * r] / denom,
                acc[j][2 * r + 1] / denom);
    if (qd == 0 && blockIdx.z == 0)
      lse[(size_t)bh * Sq + row] =
          empty ? INFINITY : (m[r] + log2f(lr)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// Backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int Sq, int Sk, float sm_scale,
                        float scale_log2, int causal, int causal_offset) {
  constexpr int LD = HD + 8;
  constexpr int TILE = BM * LD;
  constexpr int DV = dkv_out_cols<HD>();
  constexpr bool RESIDENT = HD == 64;  // K, V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BN * LD;
  T* QD = Vs + BN * LD;  // stage s: Q at QD + 2 s TILE, dO after it
  float* LDl = reinterpret_cast<float*>(QD + STAGES * 2 * TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qd = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // k-tile 0 sees the most q-tiles
  const int c0 = blockIdx.z * DV;  // output columns
  const size_t qoff = (size_t)bh * Sq * HD;
  const T* qb = q + qoff;
  const T* dob = dout + qoff;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;
  // this thread's key rows: key0 (fragment elements 0, 1), key0 + 8 (2, 3)
  const int wk0 = k0 + warp * 16;
  const int key0 = wk0 + (lane >> 2);

  // query row r sees key k0 iff r >= k0 - causal_offset: start at the
  // q-tile holding that row
  int q_begin = 0;
  if (causal) {
    const long long first = (long long)k0 - causal_offset;
    q_begin = first <= 0 ? 0 : (first >= Sq ? Sq : (int)(first / BM) * BM);
  }
  const int ntiles = (Sq - q_begin + BM - 1) / BM;

  load_tile<HD>(Ks, k + (size_t)bh * Sk * HD, k0, Sk);
  load_tile<HD>(Vs, v + (size_t)bh * Sk * HD, k0, Sk);
  cp_async_commit();
  auto load_q = [&](int t) {
    const int qt0 = q_begin + t * BM;
    T* Qst = QD + (t % STAGES) * 2 * TILE;
    load_tile<HD>(Qst, qb, qt0, Sq);
    load_tile<HD>(Qst + TILE, dob, qt0, Sq);
    float* L = LDl + (t % STAGES) * 2 * BM;
    if (threadIdx.x < BM) {
      const int row = qt0 + threadIdx.x;
      if (row < Sq) {
        cp_async4(L + threadIdx.x, lb + row);
        cp_async4(L + BM + threadIdx.x, db + row);
      } else {  // p = exp2(s - inf) = 0 on rows past Sq
        L[threadIdx.x] = INFINITY;
        L[BM + threadIdx.x] = 0.f;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_q(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // K, V landed
  __syncthreads();
  uint32_t kf[RESIDENT ? HD / 16 : 1][4], vf[RESIDENT ? HD / 16 : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_a<LD>(kf[ks], Ks, warp * 16, ks, lane);
      ldsm_a<LD>(vf[ks], Vs, warp * 16, ks, lane);
    }
  }

  float dk_acc[DV / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // q-tile t landed; q-tile t - 1's stage no longer read
    if (t + STAGES - 1 < ntiles) load_q(t + STAGES - 1);
    cp_async_commit();
    const T* Qs = QD + (t % STAGES) * 2 * TILE;
    const T* DOs = Qs + TILE;
    const float* L = LDl + (t % STAGES) * 2 * BM;
    const float* Dl = L + BM;
    const int qt0 = q_begin + t * BM;

    // S^T (keys x queries) = K Q^T, then P^T in place
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = kf[ks][i];
      } else {
        ldsm_a<LD>(a, Ks, warp * 16, ks, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_b<LD>(b, Qs, nj * 16, ks, lane);
        mma16<T>(st[2 * nj], a, b[0], b[1]);
        mma16<T>(st[2 * nj + 1], a, b[2], b[3]);
      }
    }
    // a key past Sk, or past the causal limit of the tile's first query
    const bool mask = wk0 + 15 >= Sk ||
                      (causal && wk0 + 15 > qt0 + causal_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * qd;  // query column in the tile
      const float2 lc = *reinterpret_cast<const float2*>(L + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[j][e] * scale_log2 -
                        ((e & 1) ? lc.y : lc.x) * LOG2E);
        if (mask) {
          const int key = key0 + 8 * (e >> 1);
          if (key >= Sk || (causal && key > qt0 + c + (e & 1) +
                                                causal_offset))
            p = 0.f;
        }
        st[j][e] = p;
      }
    }
    gemm_c_as_a<T, DV, LD>(dv_acc, st, DOs + c0, lane);

    // dP^T = V dO^T, then dS^T in place
    float dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = vf[ks][i];
      } else {
        ldsm_a<LD>(a, Vs, warp * 16, ks, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_b<LD>(b, DOs, nj * 16, ks, lane);
        mma16<T>(dpt[2 * nj], a, b[0], b[1]);
        mma16<T>(dpt[2 * nj + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dc =
          *reinterpret_cast<const float2*>(Dl + j * 8 + 2 * qd);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? dc.y : dc.x)) *
                    sm_scale;
    }
    gemm_c_as_a<T, DV, LD>(dk_acc, dpt, Qs + c0, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = ((size_t)bh * Sk + key) * HD + c0 + 2 * qd;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      store2<T>(dk + off + j * 8, dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      store2<T>(dv + off + j * 8, dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int Sq, int Sk, float sm_scale, float scale_log2,
                       int causal, int causal_offset) {
  constexpr int LD = HD + 8;
  constexpr int TILE = BN * LD;
  constexpr int DV = out_cols<HD>();
  constexpr bool RESIDENT = HD == 64;  // Q, dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* DOs = Qs + BM * LD;
  T* KV = DOs + BM * LD;  // stage s: K at KV + 2 s TILE, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qd = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int c0 = blockIdx.z * DV;                     // output columns
  const size_t qoff = (size_t)bh * Sq * HD;
  const T* kb = k + (size_t)bh * Sk * HD;
  const T* vb = v + (size_t)bh * Sk * HD;
  // this thread's rows: row0 (fragment elements 0, 1) and row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + (lane >> 2);

  // keys [0, k_end) can be visible to some row of this tile
  int k_end = Sk;
  if (causal) {
    const long long last = (long long)q0 + BM - 1 + causal_offset;
    k_end = last < 0 ? 0 : (last + 1 < Sk ? (int)(last + 1) : Sk);
  }
  const int ntiles = (k_end + BN - 1) / BN;

  load_tile<HD>(Qs, q + qoff, q0, Sq);
  load_tile<HD>(DOs, dout + qoff, q0, Sq);
  cp_async_commit();
  auto load_kv = [&](int t) {
    T* Ks = KV + (t % STAGES) * 2 * TILE;
    load_tile<HD>(Ks, kb, t * BN, Sk);
    load_tile<HD>(Ks + TILE, vb, t * BN, Sk);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }
  // lse (in log2 units) and delta of this thread's two rows; rows past Sq
  // get lse = +inf, so p = exp2(s - inf) = 0 there
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse[(size_t)bh * Sq + row] * LOG2E : INFINITY;
    dl[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  cp_async_wait<STAGES - 1>();  // Q, dO landed
  __syncthreads();
  uint32_t qf[RESIDENT ? HD / 16 : 1][4], dof[RESIDENT ? HD / 16 : 1][4];
  if constexpr (RESIDENT) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_a<LD>(qf[ks], Qs, warp * 16, ks, lane);
      ldsm_a<LD>(dof[ks], DOs, warp * 16, ks, lane);
    }
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; tile t - 1's stage no longer read
    if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
    cp_async_commit();
    const T* Ks = KV + (t % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;
    const int k0 = t * BN;

    // S = Q K^T, then p in place
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        ldsm_a<LD>(a, Qs, warp * 16, ks, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_b<LD>(b, Ks, nj * 16, ks, lane);
        mma16<T>(s[2 * nj], a, b[0], b[1]);
        mma16<T>(s[2 * nj + 1], a, b[2], b[3]);
      }
    }
    // the Sk tail, or a key past the warp's first row's causal limit
    const bool mask = k0 + BN > Sk ||
                      (causal && k0 + BN - 1 > q0 + warp * 16 + causal_offset);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (mask) {
          const int col = k0 + j * 8 + 2 * qd + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row + causal_offset)) p = 0.f;
        }
        s[j][e] = p;
      }

    // dP = dO V^T, then dS in place
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dof[ks][i];
      } else {
        ldsm_a<LD>(a, DOs, warp * 16, ks, lane);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_b<LD>(b, Vs, nj * 16, ks, lane);
        mma16<T>(dp[2 * nj], a, b[0], b[1]);
        mma16<T>(dp[2 * nj + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * sm_scale;
    gemm_c_as_a<T, DV, LD>(acc, dp, Ks + c0, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    T* out = dq + qoff + (size_t)row * HD + c0 + 2 * qd;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      store2<T>(out + j * 8, acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// grid of a launch: (BH, 64-row tiles, output-column windows of DV)
template <int HD, int DV>
dim3 grid_of(int BH, int rows) {
  return dim3(BH, (rows + BM - 1) / BM, HD / DV);
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int Sq, int Sk, float sm_scale,
                       int causal, int causal_offset, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<T, HD>;
  constexpr size_t smem = fwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of<HD, out_cols<HD>()>(BH, Sq);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, sm_scale * LOG2E, causal,
      causal_offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Sq, int Sk, float sm_scale,
                      int causal, int causal_offset, cudaStream_t stream) {
  auto kern = flash_bwd_dq_tc_kernel<T, HD>;
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of<HD, out_cols<HD>()>(BH, Sq);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, sm_scale, sm_scale * LOG2E, causal,
      causal_offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk,
                       float sm_scale, int causal, int causal_offset,
                       cudaStream_t stream) {
  auto kern = flash_bwd_dkv_tc_kernel<T, HD>;
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of<HD, dkv_out_cols<HD>()>(BH, Sk);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, sm_scale,
      sm_scale * LOG2E, causal, causal_offset);
  return cudaGetLastError();
}

// f(Tag<T, HD>) for dtype (1 = bf16, 2 = f16) and hd (64, 128, 256);
// cudaErrorInvalidValue for any other
template <typename T, int HD>
struct Tag {
  using type = T;
  static constexpr int hd = HD;
};

template <typename F>
cudaError_t dispatch(int dtype, int hd, F f) {
  if (dtype == 1) {
    if (hd == 64) return f(Tag<bf16, 64>());
    if (hd == 128) return f(Tag<bf16, 128>());
    if (hd == 256) return f(Tag<bf16, 256>());
  } else if (dtype == 2) {
    if (hd == 64) return f(Tag<f16, 64>());
    if (hd == 128) return f(Tag<f16, 128>());
    if (hd == 256) return f(Tag<f16, 256>());
  }
  return cudaErrorInvalidValue;
}

// the C entry points' bodies: checks, then the launch of dtype and hd
cudaError_t fwd_entry(const void* q, const void* k, const void* v, void* o,
                      void* lse, int BH, int Sq, int Sk, int hd, int dtype,
                      float sm_scale, int causal, int causal_offset,
                      cudaStream_t st) {
  if ((Sq + BM - 1) / BM > 65535) return cudaErrorInvalidConfiguration;
  return dispatch(dtype, hd, [&](auto tag) {
    using D = decltype(tag);
    return launch_fwd<typename D::type, D::hd>(
        q, k, v, o, lse, BH, Sq, Sk, sm_scale, causal, causal_offset, st);
  });
}

cudaError_t dq_entry(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int Sq, int Sk, int hd, int dtype,
                     float sm_scale, int causal, int causal_offset,
                     cudaStream_t st) {
  if ((Sq + BM - 1) / BM > 65535) return cudaErrorInvalidConfiguration;
  return dispatch(dtype, hd, [&](auto tag) {
    using D = decltype(tag);
    return launch_dq<typename D::type, D::hd>(q, k, v, dout, lse, delta, dq,
                                              BH, Sq, Sk, sm_scale, causal,
                                              causal_offset, st);
  });
}

cudaError_t dkv_entry(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int BH, int Sq, int Sk, int hd,
                      int dtype, float sm_scale, int causal,
                      int causal_offset, cudaStream_t st) {
  if ((Sk + BN - 1) / BN > 65535) return cudaErrorInvalidConfiguration;
  return dispatch(dtype, hd, [&](auto tag) {
    using D = decltype(tag);
    return launch_dkv<typename D::type, D::hd>(q, k, v, dout, lse, delta, dk,
                                               dv, BH, Sq, Sk, sm_scale,
                                               causal, causal_offset, st);
  });
}

}  // namespace

extern "C" {

// The arguments of flash_fwd / flash_bwd_dq / flash_bwd_dkv (flash_fwd.cu,
// flash_bwd.cu); dtype must be 1 (bfloat16) or 2 (float16), hd 64, 128 or
// 256. Each returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype or head_dim it does not take,
// cudaErrorInvalidConfiguration past the grid's limit of 65535 tiles on
// y; BH, on x, takes any int).
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Sq, int Sk, int hd, int dtype,
                 float sm_scale, int causal, int causal_offset, void* stream) {
  return (int)fwd_entry(q, k, v, o, lse, BH, Sq, Sk, hd, dtype, sm_scale,
                        causal, causal_offset,
                        static_cast<cudaStream_t>(stream));
}

int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int BH, int Sq, int Sk, int hd, int dtype,
                    float sm_scale, int causal, int causal_offset,
                    void* stream) {
  return (int)dq_entry(q, k, v, dout, lse, delta, dq, BH, Sq, Sk, hd, dtype,
                       sm_scale, causal, causal_offset,
                       static_cast<cudaStream_t>(stream));
}

int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int BH, int Sq, int Sk, int hd,
                     int dtype, float sm_scale, int causal,
                     int causal_offset, void* stream) {
  return (int)dkv_entry(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, hd,
                        dtype, sm_scale, causal, causal_offset,
                        static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

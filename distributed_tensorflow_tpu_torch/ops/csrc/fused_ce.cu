// Fused cross-entropy against a tied embedding, for Hopper (sm_90a),
// CUDA C++, CUDA cores: the (N, V) logits never reach device memory.
// These kernels take f32 only, whose f32 products keep f32 parity (on
// tensor cores f32 would be TF32); bf16 runs on the tensor cores of
// fused_ce_tc.cu, and returns cudaErrorInvalidValue here.
//
// Replaces: distributed_tensorflow_tpu/ops/fused_ce.py
// - fused_ce_fwd: _fwd_kernel (:75; _fwd_call :288, pl.pallas_call at
//   :292). For h (N, D) and E (V, D) in one dtype and targets t (N,)
//   int32: lse_i = logsumexp_v(h_i . E_v) and the target
//   logit tl_i = h_i . E_{t_i}, both (N,) f32. A target outside [0, V)
//   picks up 0, as the one-hot never matches there.
// - the backward, from the saved lse and the per-row cotangent g (N,)
//   f32. Each kernel rebuilds, as _p_adj does (:123), p_adj_iv =
//   (exp(h_i . E_v - lse_i) - [v = t_i]) g_i, rounds it to E's dtype
//   (:220) and feeds that tile to the products it computes:
//   - fused_ce_bwd: _bwd_merged_b_kernel (:201; call :397), the merged
//     variant "b": dh = p_adj E accumulated on chip and written once in
//     h's dtype, dE = p_adj^T h added into an f32 (V, D) accumulator that
//     the caller zeroes and later casts to E's dtype, as :425 does;
//   - fused_ce_bwd_a: _bwd_merged_kernel (:159; call :356), the merged
//     variant "a", the roles swapped: dE on chip, written once, and dh
//     added into an f32 (N, D) accumulator, which takes the place of the
//     TPU's aliased dh buffer (:355, :377);
//   - fused_ce_dh: _dh_kernel (:137; call :326), dh alone, on chip;
//   - fused_ce_de: _de_kernel (:242; call :432), dE alone, on chip.
//   "split" is fused_ce_dh then fused_ce_de: no atomics, so it gives the
//   same dE on every run.
// The vocab tail past V is masked in all (the role of _col_ids and
// _masked_e, :70-120), and so are the token rows past N. A row with
// lse = +inf gets p = 0 but for -g at its target.
//
// Design. The TPU kernels walk a sequential (N/bn, V/bv) grid, carrying
// the online (max, sum-exp) pair -- or a gradient accumulator -- in VMEM
// scratch across tiles, and the merged variants carry the other gradient
// across sweeps through an input->output aliased HBM buffer. Here one
// thread block owns a tile of BN = 32 rows and loops over the other
// operand in tiles of BV = 64 rows. In the forward, and in the backward
// kernels whose gradient stays with the tokens (#7, #5), the rows are
// token rows of h and the loop runs over E; in the other two (#6, #8)
// they are vocab rows of E and the loop runs over h: the same body with
// the operands swapped. 256 threads: thread (ty, tx), ty,
// tx in 0..15, owns rows ty + 16 i (i < 2) of the row tile and columns
// tx + 16 j (j < 4) of each 32 x 64 logits tile, which is built in f32
// registers over d_model in chunks staged through shared memory.
// The forward keeps m, l and the target logit per row in registers; a
// row's 16 threads sit in one half-warp, so the row reductions are
// __shfl_xor. Its block holds four such groups of 256 threads (1024),
// each its own stream of vocab tiles (g, g + 4, g + 8, ...), whose row
// states are merged through shared memory at the end: four times the
// warps on an SM to hide the latency of the staging loads (with one
// group the forward ran at a quarter of this speed on an H100). A
// backward block has two such groups (512 threads) that split d_model
// between them: for the logits tile each sums half of every 64-wide
// chunk (group 1 hands its part to group 0 through shared memory, which
// forms p_adj), and for the gradients each takes half of every 128-wide
// chunk. It writes the p_adj tile to shared memory and then walks
// d_model: the row gradient (BN x D, f32) lives in shared memory for the
// block's whole life (128 KB at D = 1024, so D <= 1024), and in the
// merged kernels each thread adds a 4 x 4 piece of the tile's
// contribution to the other gradient into its f32 accumulator with
// atomicAdd (on an H100 a float4 atomicAdd, 4x fewer operations, was no
// faster) -- blocks run in no order on Hopper, so the TPU's sequential
// read-modify-write becomes atomics, whose summation order varies from
// run to run. With BN = 32 a row chunk of N = 4096 gives 128 token
// blocks, one per SM on 128 of the 132, and V = 32768 gives 1024 vocab
// blocks.
//
// Bound at the train step's shape (one row chunk: N = 4096, V = 32768,
// D = 1024, bf16; two chunks, so two launches of each kernel, a step):
// the forward does 2 N V D = 275 GFLOP -> 278 us at 989 TFLOP/s against
// h and E read once (75.5 MB -> 23 us); the merged backwards (#7, #6)
// 6 N V D = 825 GFLOP -> 834 us against h, E read and dh, dE written
// (151 MB -> 45 us); #5 and #8 each 4 N V D (the logits again, then
// one product) = 550 GFLOP -> 556 us. All are bound by operations, by
// far (in f32, at 67 TFLOP/s on CUDA cores: 4.1, 12.3, 8.2 ms). These
// kernels run f32 FMAs on CUDA cores and reach about 12 TFLOP/s, the
// rate at which the shared-memory reads of a 2 x 4 register tile (6
// loads for 8 FMAs) feed the FMA units; bf16 runs, every kernel of it,
// on the tensor cores (fused_ce_tc.cu).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BN = 32;       // token rows per block
constexpr int BV = 64;       // vocab rows per tile
constexpr int DK = 32;       // d_model chunk of the logits product
constexpr int NT = 256;      // threads per block (per vocab stream)
constexpr int NG = 4;        // vocab streams per forward block
constexpr int FWD_NT = NG * NT;
constexpr int LS = DK + 1;   // padded stride of the staged logits chunks
constexpr int BWD_NT = 2 * NT;  // backward: two groups split d_model
constexpr int DL = 64;       // backward: d_model chunk of the logits
constexpr int LL = DL + 1;   //   at a padded stride
constexpr int DG = 128;      // backward: d_model chunk of the gradients
// backward staging floats: the larger of the two phases' buffers
constexpr int BWD_R = (BN * LL + BV * LL + BN * (BV + 1) > (BV + BN) * DG)
                          ? BN * LL + BV * LL + BN * (BV + 1)
                          : (BV + BN) * DG;
constexpr int PS = BV + 1;   // padded stride of the p_adj tile
constexpr int MAX_D = 1024;  // widest window: BN x window f32 in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The forward's logits: acc[i][j] = h[n0 + ty + 16 i] . E[v0 + tx + 16 j]
// (0 past N or V), in f32 over d_model chunks of DK. The block stages
// the chunk of h rows [n0, n0 + BN) in Hs (BN x LS) and of the NG tiles'
// E rows [w0, w0 + NG BV) in Es (NG BV x LS); this thread's group reads
// its tile's rows from v0 - w0 on. Starts with a barrier, so the
// previous use of shared memory is complete.
template <typename T>
__device__ __forceinline__ void logits_tile(const T* __restrict__ h,
                                            const T* __restrict__ E, int N,
                                            int V, int D, int n0, int w0,
                                            int v0, float* Hs, float* Es,
                                            float acc[2][4], int ty,
                                            int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* Et = Es + (v0 - w0) * LS;
  for (int d0 = 0; d0 < D; d0 += DK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BN * DK; e += FWD_NT) {
      const int r = e / DK, c = e % DK;
      Hs[r * LS + c] = (n0 + r < N && d0 + c < D)
                           ? to_f32(h[(size_t)(n0 + r) * D + d0 + c])
                           : 0.f;
    }
    for (int e = threadIdx.x; e < NG * BV * DK; e += FWD_NT) {
      const int r = e / DK, c = e % DK;
      Es[r * LS + c] = (w0 + r < V && d0 + c < D)
                           ? to_f32(E[(size_t)(w0 + r) * D + d0 + c])
                           : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = Hs[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Et[(tx + 16 * j) * LS + c];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_NT)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ E,
                    const int* __restrict__ t, float* __restrict__ lse,
                    float* __restrict__ tl, int N, int V, int D) {
  __shared__ float Hs[BN * LS];
  __shared__ float Es[NG * BV * LS];
  __shared__ float part[NG][3][BN];  // per group and row: m, l, target
  const int tid = threadIdx.x;
  const int grp = tid / NT;          // this thread's vocab stream
  const int tx = tid & 15;
  const int ty = (tid % NT) >> 4;
  const int n0 = blockIdx.x * BN;

  int tr[2];
  float m[2], l[2], tg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = n0 + ty + 16 * i;
    tr[i] = row < N ? t[row] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
    tg[i] = 0.f;
  }

  // group g takes vocab tiles g, g + NG, g + 2 NG, ...; every group runs
  // the same number of steps (the barriers are block-wide)
  for (int w0 = 0; w0 < V; w0 += NG * BV) {
    const int v0 = w0 + grp * BV;
    float s[2][4];
    logits_tile<T>(h, E, N, V, D, n0, w0, v0, Hs, Es, s, ty, tx);
    if (v0 >= V) continue;  // past the vocab: uniform across the group
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col >= V) s[i][j] = -INFINITY;
        else if (col == tr[i]) tg[i] += s[i][j];
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // column v0 < V is in the tile, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      tg[i] += __shfl_xor_sync(0xffffffffu, tg[i], off);
    if (tx == 0) {
      part[grp][0][ty + 16 * i] = m[i];
      part[grp][1][ty + 16 * i] = l[i];
      part[grp][2][ty + 16 * i] = tg[i];
    }
  }
  __syncthreads();
  // merge the groups' (max, sum-exp) pairs; group 0 always saw column 0,
  // so mx is finite, and a group that saw nothing adds l = 0
  if (tid < BN && n0 + tid < N) {
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, part[g][0][tid]);
    float sum = 0.f, target = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (part[g][1][tid] > 0.f)
        sum += part[g][1][tid] * expf(part[g][0][tid] - mx);
      target += part[g][2][tid];
    }
    lse[n0 + tid] = mx + logf(sum);
    tl[n0 + tid] = target;
  }
}

// for a window of W columns of d_model
size_t bwd_smem_bytes(int W) {
  return sizeof(float) * ((size_t)BN * W + BN * PS + BWD_R);
}

// The four backward kernels, one body. The block owns BN rows of the
// "row" operand A and loops over the "column" operand B in tiles of BV
// rows; s[r][c] = A_r . B_c is a logits entry, of token r and vocab c
// when TOK_ROWS (A = h, B = E), of vocab r and token c otherwise (A = E,
// B = h). From the tile it forms p_adj (rounded to T), adds
// p_adj B into the row gradient dA, kept in shared memory and written
// once in T, and, when ATOMIC_B, adds p_adj^T A into the f32 column
// gradient dB with atomics:
//   #7 fused_ce_bwd   (_bwd_merged_b_kernel): TOK_ROWS, ATOMIC_B
//   #5 fused_ce_dh    (_dh_kernel):           TOK_ROWS
//   #8 fused_ce_de    (_de_kernel):           vocab rows
//   #6 fused_ce_bwd_a (_bwd_merged_kernel):   vocab rows, ATOMIC_B
// Both gradients are computed for the window of d_model columns
// [d_off, d_off + W) only (all of D when d_off = 0 and W = D): the logits
// run over the full D, the products and the writes over the window, so a
// D too wide for the BN x D accumulator is covered by one launch a window.
template <typename T, bool TOK_ROWS, bool ATOMIC_B>
__device__ __forceinline__ void bwd_body(
    const T* __restrict__ A, const T* __restrict__ B,
    const int* __restrict__ t, const float* __restrict__ lse,
    const float* __restrict__ g, T* __restrict__ dA,
    float* __restrict__ dB, int NR, int NC, int D, int d_off, int W,
    float* smem) {
  const int d_end = d_off + W;
  float* dAs = smem;            // BN x W, the dA accumulator
  float* Ps = dAs + BN * W;     // BN x PS, p_adj in T's precision
  float* R = Ps + BN * PS;      // staging, used by the two phases in turn:
  float* As = R;                //   logits: A chunk BN x LL,
  float* Bs = As + BN * LL;     //     B chunk BV x LL,
  float* Lp = Bs + BV * LL;     //     group 1's partial logits BN x PS;
  float* Bc = R;                //   gradients: B chunk BV x DG,
  float* Ac = Bc + BV * DG;     //     A chunk BN x DG

  const int tid = threadIdx.x;
  const int grp = tid / NT;     // which half of each d_model chunk
  const int tx = tid & 15;
  const int ty = (tid % NT) >> 4;
  const int r0 = blockIdx.x * BN;

  for (int e = tid; e < BN * W; e += BWD_NT) dAs[e] = 0.f;
  // the token data of this thread's rows (TOK_ROWS) or, loaded per tile,
  // of its columns
  int tk[4];
  float lk[4], gk[4];
  if (TOK_ROWS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + ty + 16 * i;
      tk[i] = row < NR ? t[row] : -1;
      lk[i] = row < NR ? lse[row] : 0.f;
      gk[i] = row < NR ? g[row] : 0.f;
    }
  }

  for (int c0 = 0; c0 < NC; c0 += BV) {
    // logits tile, rows ty + 16 i, columns tx + 16 j: each group sums
    // its half of every 64-wide d_model chunk, group 1 hands its part
    // to group 0 through Lp
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DL) {
      __syncthreads();  // previous chunk / previous tile's Bc, Ac used
      for (int e = tid; e < BN * DL; e += BWD_NT) {
        const int r = e / DL, c = e % DL;
        As[r * LL + c] = (r0 + r < NR && d0 + c < D)
                             ? to_f32(A[(size_t)(r0 + r) * D + d0 + c])
                             : 0.f;
      }
      for (int e = tid; e < BV * DL; e += BWD_NT) {
        const int r = e / DL, c = e % DL;
        Bs[r * LL + c] = (c0 + r < NC && d0 + c < D)
                             ? to_f32(B[(size_t)(c0 + r) * D + d0 + c])
                             : 0.f;
      }
      __syncthreads();
      const int k0 = grp * (DL / 2);
#pragma unroll 8
      for (int c = k0; c < k0 + DL / 2; ++c) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = As[(ty + 16 * i) * LL + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LL + c];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Lp[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    if (grp == 0) {
      if (!TOK_ROWS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          tk[j] = col < NC ? t[col] : -1;
          lk[j] = col < NC ? lse[col] : 0.f;
          gk[j] = col < NC ? g[col] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          const int k = TOK_ROWS ? i : j;      // this entry's token data
          const int voc = TOK_ROWS ? col : row;
          float p = 0.f;
          if (row < NR && col < NC) {
            p = expf(s[i][j] + Lp[(ty + 16 * i) * PS + tx + 16 * j] -
                     lk[k]);
            if (voc == tk[k]) p -= 1.f;
            p *= gk[k];
          }
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
        }
      }
    }

    // gradients over d_model chunks of DG: group grp takes dims
    // [dg, dg + DG / 2) of each
    const int dg = grp * (DG / 2);
    for (int d0 = d_off; d0 < d_end; d0 += DG) {
      __syncthreads();  // Ps visible / Lp, previous chunk consumed
      for (int e = tid; e < BV * DG; e += BWD_NT) {
        const int r = e / DG, c = e % DG;
        Bc[e] = (c0 + r < NC && d0 + c < d_end)
                    ? to_f32(B[(size_t)(c0 + r) * D + d0 + c])
                    : 0.f;
      }
      if (ATOMIC_B) {
        for (int e = tid; e < BN * DG; e += BWD_NT) {
          const int r = e / DG, c = e % DG;
          Ac[e] = (r0 + r < NR && d0 + c < d_end)
                      ? to_f32(A[(size_t)(r0 + r) * D + d0 + c])
                      : 0.f;
        }
      }
      __syncthreads();

      // dA[ty + 16 i][d0 + dg + tx + 16 j] += sum_c p[.][c] B[c0 + c][.]
      float a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < BV; ++c) {
        float pa[2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) pa[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bc[c * DG + dg + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = fmaf(pa[i], bv[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dim = d0 + dg + tx + 16 * j;
          if (dim < d_end) dAs[(ty + 16 * i) * W + dim - d_off] += a[i][j];
        }

      if (!ATOMIC_B) continue;
      // dB[c0 + ty + 16 i][d0 + dg + tx + 16 j] += sum_r p[r][.] A[r0 + r][.]
      float b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[i][j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < BN; ++r) {
        float pv[4], av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[r * PS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) av[j] = Ac[r * DG + dg + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) b[i][j] = fmaf(pv[i], av[j], b[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cr = c0 + ty + 16 * i;
        if (cr >= NC) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int dim = d0 + dg + tx + 16 * j;
          if (dim < d_end) atomicAdd(&dB[(size_t)cr * D + dim], b[i][j]);
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < BN * W; e += BWD_NT) {
    const int r = e / W;
    if (r0 + r < NR)
      dA[(size_t)(r0 + r) * D + d_off + e % W] = from_f32<T>(dAs[e]);
  }
}

// h (N, D), E (V, D), t, lse, g (N,) as in the forward; the outputs as
// the C entry points below say. Each kernel is its own symbol, so a
// profile tells them apart.
#define CE_BWD_ARGS                                                     \
  const T *__restrict__ h, const T *__restrict__ E,                     \
      const int *__restrict__ t, const float *__restrict__ lse,         \
      const float *__restrict__ g, T *__restrict__ dA,                  \
      float *__restrict__ dB, int N, int V, int D, int d_off, int W

template <typename T>
__global__ void __launch_bounds__(BWD_NT) fused_ce_bwd_kernel(CE_BWD_ARGS) {
  extern __shared__ float smem[];
  bwd_body<T, true, true>(h, E, t, lse, g, dA, dB, N, V, D, d_off, W, smem);
}

template <typename T>
__global__ void __launch_bounds__(BWD_NT) fused_ce_dh_kernel(CE_BWD_ARGS) {
  extern __shared__ float smem[];
  bwd_body<T, true, false>(h, E, t, lse, g, dA, dB, N, V, D, d_off, W,
                           smem);
}

template <typename T>
__global__ void __launch_bounds__(BWD_NT) fused_ce_de_kernel(CE_BWD_ARGS) {
  extern __shared__ float smem[];
  bwd_body<T, false, false>(E, h, t, lse, g, dA, dB, V, N, D, d_off, W,
                            smem);
}

template <typename T>
__global__ void __launch_bounds__(BWD_NT)
fused_ce_bwd_a_kernel(CE_BWD_ARGS) {
  extern __shared__ float smem[];
  bwd_body<T, false, true>(E, h, t, lse, g, dA, dB, V, N, D, d_off, W,
                           smem);
}

template <typename T>
cudaError_t launch_fwd(const void* h, const void* E, const int* t,
                       float* lse, float* tl, int N, int V, int D,
                       cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN);
  fused_ce_fwd_kernel<T><<<grid, FWD_NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(E), t, lse, tl, N, V,
      D);
  return cudaGetLastError();
}

// rows: N for the kernels whose rows are tokens, V for the others
template <typename T>
cudaError_t launch_bwd(void (*kern)(const T*, const T*, const int*,
                                    const float*, const float*, T*, float*,
                                    int, int, int, int, int),
                       int rows, const void* h, const void* E, const int* t,
                       const float* lse, const float* g, void* dA, float* dB,
                       int N, int V, int D, int d_off, int W,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + BN - 1) / BN);
  kern<<<grid, BWD_NT, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(E), t, lse, g,
      static_cast<T*>(dA), dB, N, V, D, d_off, W);
  return cudaGetLastError();
}

// variant: 0 = "b" (#7), 1 = dh of "split" (#5), 2 = dE of "split" (#8),
// 3 = "a" (#6); each in f32 (bf16 runs on the tensor cores,
// fused_ce_tc.cu)
cudaError_t launch_bwd_variant(int variant, int dtype, const void* h,
                               const void* E, const int* t, const float* lse,
                               const float* g, void* dA, float* dB, int N,
                               int V, int D, int d_off, int W,
                               cudaStream_t stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return launch_bwd<float>(fused_ce_bwd_kernel<float>, N, h, E, t, lse,
                               g, dA, dB, N, V, D, d_off, W, stream);
    case 1:
      return launch_bwd<float>(fused_ce_dh_kernel<float>, N, h, E, t, lse, g,
                               dA, dB, N, V, D, d_off, W, stream);
    case 2:
      return launch_bwd<float>(fused_ce_de_kernel<float>, V, h, E, t, lse, g,
                               dA, dB, N, V, D, d_off, W, stream);
    case 3:
      return launch_bwd<float>(fused_ce_bwd_a_kernel<float>, V, h, E, t, lse,
                               g, dA, dB, N, V, D, d_off, W, stream);
  }
  return cudaErrorInvalidValue;
}

// The backward kernels. dh: (N, D) in the dtype, written once by
// fused_ce_bwd and fused_ce_dh; dh_acc: (N, D) f32, zeroed by the caller,
// added into by fused_ce_bwd_a; de: (V, D) in the dtype, written once by
// fused_ce_de and fused_ce_bwd_a; de_acc: (V, D) f32, zeroed by the
// caller, added into by fused_ce_bwd. Each computes the gradient columns
// [d_off, d_off + W) of its outputs (a window of at most MAX_D; d_off = 0,
// W = D for all of them when D <= MAX_D) from the logits over all of D.
int bwd_entry(int variant, const void* h, const void* E, const void* t,
              const void* lse, const void* g, void* dA, void* dB, int N,
              int V, int D, int d_off, int W, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(t);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* b = static_cast<float*>(dB);
  if (D < 1 || V < 1 || N < 1 || W < 1 || W > MAX_D || d_off < 0 ||
      d_off + W > D)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd_variant(variant, dtype, h, E, ti, l, gg, dA, b, N, V,
                                 D, d_off, W, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (1 = bfloat16 is refused: fused_ce_tc.cu). Each
// returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a dtype
// or a D it does not take).
int fused_ce_fwd(const void* h, const void* E, const void* t, void* lse,
                 void* tl, int N, int V, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(t);
  float* l = static_cast<float*>(lse);
  float* tg = static_cast<float*>(tl);
  if (D < 1 || V < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_fwd<float>(h, E, ti, l, tg, N, V, D, st);
  return (int)cudaErrorInvalidValue;  // bf16: fused_ce_tc.cu
}

int fused_ce_bwd(const void* h, const void* E, const void* t,
                 const void* lse, const void* g, void* dh, void* de_acc,
                 int N, int V, int D, int d_off, int W, int dtype,
                 void* stream) {
  return bwd_entry(0, h, E, t, lse, g, dh, de_acc, N, V, D, d_off, W, dtype,
                   stream);
}

int fused_ce_dh(const void* h, const void* E, const void* t,
                const void* lse, const void* g, void* dh, int N, int V,
                int D, int d_off, int W, int dtype, void* stream) {
  return bwd_entry(1, h, E, t, lse, g, dh, nullptr, N, V, D, d_off, W, dtype,
                   stream);
}

int fused_ce_de(const void* h, const void* E, const void* t,
                const void* lse, const void* g, void* de, int N, int V,
                int D, int d_off, int W, int dtype, void* stream) {
  return bwd_entry(2, h, E, t, lse, g, de, nullptr, N, V, D, d_off, W, dtype,
                   stream);
}

int fused_ce_bwd_a(const void* h, const void* E, const void* t,
                   const void* lse, const void* g, void* dh_acc, void* de,
                   int N, int V, int D, int d_off, int W, int dtype,
                   void* stream) {
  return bwd_entry(3, h, E, t, lse, g, de, dh_acc, N, V, D, d_off, W, dtype,
                   stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

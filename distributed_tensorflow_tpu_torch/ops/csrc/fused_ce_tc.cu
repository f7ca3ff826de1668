// Fused cross-entropy against a tied embedding, bf16, on Hopper's tensor
// cores (sm_90a): mma.sync fed by ldmatrix from shared memory tiles that
// cp.async fills through a ring of stages. The (N, V) logits never reach
// device memory.
//
// Replaces, for bf16 inputs (f32 stays on the CUDA-core kernels of
// fused_ce.cu, whose f32 products keep f32 parity; on tensor cores f32
// would be TF32), in distributed_tensorflow_tpu/ops/fused_ce.py:
// - fused_ce_fwd_tc: _fwd_kernel (:75; pl.pallas_call at :292). For h
//   (N, D) and E (V, D) bf16 and targets t (N,) int32: lse_i =
//   logsumexp_v(h_i . E_v) and the target logit tl_i = h_i . E_{t_i},
//   both f32, from bf16 products summed in f32. A target outside [0, V)
//   picks up 0 (the caller zeroes tl).
// - fused_ce_bwd_tc: _bwd_merged_b_kernel (:201, with _p_adj :123), the
//   merged variant "b": from the saved lse and the per-row cotangent g
//   (N,) f32, p_adj = (exp(h E^T - lse) - onehot(t)) g rounded to bf16
//   (:220), dh = p_adj E and dE = p_adj^T h, each summed in f32 and
//   written once in bf16.
// - fused_ce_dh_tc and fused_ce_de_tc: _dh_kernel (:137; call :326) and
//   _de_kernel (:242; call :432), the variant "split": the same p_adj,
//   rebuilt per tile as _p_adj does (:123), and one of the two products
//   each, dh = p_adj E and dE = p_adj^T h. They are the two passes of
//   fused_ce_bwd_tc, launched one at a time.
// - fused_ce_bwd_a_tc: _bwd_merged_kernel (:159; call :356), the merged
//   variant "a", in one pass: p_adj rounded to bf16 once (:180) and fed
//   to both products, dE = p_adj^T h summed in f32 on chip and written
//   once in bf16, dh = p_adj E added in f32 across vocab groups into an
//   accumulator that the caller zeroes and casts, where the TPU kernel
//   carries dh in an aliased HBM buffer (:355, :377).
// The vocab tail past V and the token rows past N are zero-filled as they
// are staged (cp.async with src-size 0), so no uninitialised row is read
// (the role of _masked_e, :111), and masked out of the results. A row with
// lse = +inf gets p = 0 but for -g at its target.
//
// Bound at the train step's chunk (N = 4096, V = 32768, D = 1024; two
// chunks, so two launches of each, a step): the forward does 2 N V D =
// 275 GFLOP -> 0.278 ms at 989 TFLOP/s bf16, against 75.5 MB of h and E
// (23 us at 3.35 TB/s); the backward function 6 N V D = 825 GFLOP ->
// 0.834 ms ("a" does just that). Both are bound by operations, by far.
// Each "split" pass does 4 N V D = 550 GFLOP (the logits again, then its
// product) -> 0.556 ms.
//
// Forward design. One block (8 warps) owns 128 token rows and a slice of
// the vocabulary; it walks the slice in tiles of 128 vocab rows and
// d_model in chunks of 64, through a 3-stage cp.async ring that runs on
// across tile boundaries. Each warp holds a 32 x 64 f32 logits tile in
// mma.sync (m16n8k16, bf16 -> f32) accumulators; after a tile's last
// chunk it folds the tile into per-row online (max, sum-exp) pairs in
// registers -- a row's values sit in the four lanes of a quad, reduced
// with __shfl_xor -- and the lane that holds a row's target column
// writes tl. With 128-row tiles a 4096-row chunk is only 32 row tiles,
// so the vocabulary is split across blocks too (8 slices at N = 4096 on
// 132 SMs, two blocks an SM: 256 blocks, one wave); each warp writes its
// rows' (m, l) partial to f32 scratch and fused_ce_lse_merge_kernel
// folds the partials of a row in a fixed order, so lse is the same on
// every run.
//
// Backward design. dh of a token tile must stay on chip, and 64 rows of
// it at D = 1024 (256 KB in f32) fit neither shared memory nor the
// register file, so a block owns 32 rows and keeps its 32 x D f32
// gradient in the registers of its 8 warps (each warp an interleaved
// set of 8-column tiles, 128 registers a thread at D = 1024); mma.sync's
// 16-row tiles take 32 rows where wgmma's 64-row minimum would not. The
// block's own 32 rows of the row operand stay resident in shared memory
// (64 KB at D = 1024); the column operand streams through in 64-row
// tiles, each staged once by cp.async in 128-wide d_model chunks and
// read twice from shared memory: for its 32 x 64 logits (two groups of
// four warps split each chunk's depth and meet in shared memory), and
// for the gradient product p_adj (bf16, in registers after one ldmatrix)
// times the tile. The next tile's chunks load into the slots the
// gradient product has finished with. (Staging each tile twice, once a
// phase, would read 17 GB from L2 a pass at the train chunk: N/32 row
// blocks each reading all of E twice.)
// The other gradient, dE = p_adj^T h, is not added with atomics: at
// 32-row tiles that is N/32 x V x D = 4.29e9 f32 adds a launch, and
// tools/torch_ce_atomics_probe.py measured that atomic pass alone, with
// no arithmetic, at 5.23 ms with float4 adds (5.25 ms scalar) on an
// NVIDIA H100 80GB HBM3 at 700 W: above the 3 ms at which a second pass
// is cheaper. So the backward is two passes of one body: a dh pass over
// token tiles (rows h, columns E) and a dE pass over vocab tiles (rows E,
// columns h), each recomputing the logits: 8 N V D operations instead of
// 6 (1.11 ms at peak), no atomics, and a dE that is the same on every
// run.
//
// Variant "a" design. "a" keeps its trait: one pass, each (token tile,
// vocab group)'s logits computed once for both products, dE on chip.
// It is the dE pass (vocab rows, 32 a block, E's rows resident; h
// streaming through in 64-token tiles) with a third product on each
// tile: the 64 x D dh contribution p_adj^T (64 x 32) E_rows (32 x D),
// p_adj^T read from the bf16 p_adj tile and E's rows from the resident
// copy, both by ldmatrix.trans, in the dE product's 128-wide d_model
// chunks. Its depth is only 32, so each 16 x 8 piece is done after two
// mma.sync and goes straight from the accumulators to device memory as
// a float4 atomicAdd (red.global.add.v4.f32): (V / 32) N D = 4.29e9 f32
// adds a launch at the train chunk. tools/torch_ce_atomics_probe.py
// measured the layouts of those adds alone (NVIDIA H100 80GB HBM3,
// 700 W): with dh_acc row-major, a warp's adds cover 16 rows x 32 bytes
// and ran at 8.63 ms (TMA bulk reduce-adds of staged 256-byte rows
// 7.99 ms); thread-block clusters that pre-sum 2 or 4 blocks' chunks in
// distributed shared memory (R = 64, 128 rows summed before the add)
// took 14.9-23.1 ms, about 1 us a cluster barrier. So dh_acc is kept in
// the fragments' order: each 16 x 8 tile is 512 contiguous bytes in
// lane order, after one shuffle between lanes q and q ^ 1 a lane holds
// 4 contiguous columns, and a warp's float4 add covers 512 contiguous
// bytes: 5.63 ms alone (bulk from that order 5.72). The wrapper reads
// dh_acc through a permuted view as it casts it to bf16. Each block
// starts at its own token tile, so the blocks in flight add into
// different rows. Inside the kernel the adds cost 2.8 ms of its 7.1
// (4.3 ms with them switched off); every vocab group also reads all of
// h from L2 (8.6 GB a launch), so L2 is the likely bound. Spreading the
// adds over the chunk loop instead of a phase of their own saved
// 0.3 ms, none of it in the adds' own cost. dh is summed in another
// order on every run (the atomics), so it may differ by f32 rounding
// before its bf16 cast; dE is written once and is the same on every
// run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_BM = 128;          // token rows per block
constexpr int F_BV = 128;          // vocab rows per tile
constexpr int F_BK = 64;           // d_model chunk
constexpr int F_LD = F_BK + 8;     // padded row: ldmatrix without conflicts
constexpr int F_STAGES = 3;
constexpr int F_STAGE = (F_BM + F_BV) * F_LD;  // bf16 elements a stage
constexpr size_t F_SMEM = sizeof(bf16) * F_STAGES * F_STAGE;
// partial (m, l) pairs a row gets from one vocab slice: one per warp column
constexpr int F_PARTS = 2;

// Block (x, y): token rows [128 x, 128 x + 128), vocab tiles [y tps,
// min((y + 1) tps, ceil(V / 128))). Warp w: rows 32 (w % 4) of the block,
// columns 64 (w / 4) of each vocab tile. Writes tl where a thread holds
// the target column, and (m, l) of each row over this warp's columns of
// the slice to pm, pl [(2 y + w / 4) N + row].
__global__ void __launch_bounds__(F_THREADS, 2)
fused_ce_fwd_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ E,
                       const int* __restrict__ t, float* __restrict__ tl,
                       float* __restrict__ pm, float* __restrict__ pl, int N,
                       int V, int D, int tiles_per_slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gr = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * F_BM;
  const int vt0 = blockIdx.y * tiles_per_slice;
  const int ntiles = min(tiles_per_slice, (V + F_BV - 1) / F_BV - vt0);
  const int KC = (D + F_BK - 1) / F_BK;
  const int total = ntiles * KC;

  // this thread's rows: 32 wm + 16 mi + gr + 8 hf, as r = 2 mi + hf
  int trow[4];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = n0 + wm * 32 + (r >> 1) * 16 + gr + 8 * (r & 1);
    trow[r] = row < N ? t[row] : -1;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  // stage of load li: token rows and vocab tile vt0 + li / KC, d_model
  // chunk li % KC; 1024 16-byte pieces of each operand, 4 a thread
  auto load = [&](int li) {
    bf16* As = smem + (li % F_STAGES) * F_STAGE;
    bf16* Bs = As + F_BM * F_LD;
    const int v0 = (vt0 + li / KC) * F_BV;
    const int d0 = (li % KC) * F_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * F_THREADS;
      const int r = idx >> 3, d = d0 + (idx & 7) * 8;
      const bool pa = n0 + r < N && d < D;
      cp_async16(As + r * F_LD + (idx & 7) * 8,
                 pa ? h + (size_t)(n0 + r) * D + d : h, pa);
      const bool pb = v0 + r < V && d < D;
      cp_async16(Bs + r * F_LD + (idx & 7) * 8,
                 pb ? E + (size_t)(v0 + r) * D + d : E, pb);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][nt][k] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1 no longer read
    if (it + F_STAGES - 1 < total) load(it + F_STAGES - 1);
    cp_async_commit();
    const bf16* As = smem + (it % F_STAGES) * F_STAGE;
    const bf16* Bs = As + F_BM * F_LD;
#pragma unroll
    for (int ks = 0; ks < F_BK / 16; ++ks) {
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * F_LD +
                           ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        ldsm_x4(b[nj], Bs + (wn * 64 + nj * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * F_LD +
                           ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
        }
    }
    if (it % KC != KC - 1) continue;

    // the tile is complete: fold it into the rows' online (m, l)
    const int vbase = (vt0 + it / KC) * F_BV + wn * 64 + 2 * q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int mi = r >> 1, hf = r & 1;
      const int row = n0 + wm * 32 + mi * 16 + gr + 8 * hf;
      float s[16];
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = vbase + nt * 8 + e;
          float x = acc[mi][nt][2 * hf + e];
          if (col >= V) x = -INFINITY;
          else if (col == trow[r]) tl[row] = x;  // trow = -1 past N
          s[nt * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // m_new = -inf: this warp has seen no column of the vocab yet
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
      if (m_new > -INFINITY) {
#pragma unroll
        for (int k = 0; k < 16; ++k) rs += __expf(s[k] - m_new);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if (m_new > -INFINITY) {
        l[r] = l[r] * __expf(m[r] - m_new) + rs;
        m[r] = m_new;
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nt][k] = 0.f;
  }
  cp_async_wait<0>();

  if (q == 0) {
    const size_t part = (size_t)(blockIdx.y * F_PARTS + wn) * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = n0 + wm * 32 + (r >> 1) * 16 + gr + 8 * (r & 1);
      if (row < N) {
        pm[part + row] = m[r];
        pl[part + row] = l[r];
      }
    }
  }
}

// lse of each row from its P partial (m, l) pairs, in partial order; a
// partial that saw no column (l = 0, m = -inf) adds nothing
__global__ void fused_ce_lse_merge_kernel(const float* __restrict__ pm,
                                          const float* __restrict__ pl,
                                          float* __restrict__ lse, int N,
                                          int P) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = -INFINITY;
  for (int p = 0; p < P; ++p) mx = fmaxf(mx, pm[(size_t)p * N + row]);
  float sum = 0.f;
  for (int p = 0; p < P; ++p) {
    const float lp = pl[(size_t)p * N + row];
    if (lp > 0.f) sum += lp * expf(pm[(size_t)p * N + row] - mx);
  }
  lse[row] = mx + logf(sum);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int B_THREADS = 256;
constexpr int B_BR = 32;            // rows of the row operand per block
constexpr int B_BC = 64;            // rows of the column operand per tile
constexpr int B_DC = 128;           // d_model chunk
constexpr int B_LD = B_DC + 8;      // padded chunk row
constexpr int B_MAX_D = 1024;       // the row gradient in registers
constexpr int B_MAX_C = B_MAX_D / B_DC;
constexpr int B_PLD = B_BC + 8;     // p_adj tile row (bf16)
constexpr int B_RLD = B_BC + 4;     // logits hand-over row (f32)

size_t bwd_smem_bytes(int D) {
  const int kc = (D + B_DC - 1) / B_DC;
  return sizeof(float) * B_BR * B_RLD +
         sizeof(bf16) * ((size_t)kc * B_BC * B_LD +
                         (size_t)B_BR * (kc * B_DC + 8) + B_BR * B_PLD);
}

// The block owns rows [32 x, 32 x + 32) of the row operand A (NR x D)
// and walks the column operand B (NC x D) in tiles of 64 rows. s[r][c] =
// A_r . B_c is a logits entry: of token r and vocab c when TOK_ROWS (A =
// h, B = E: the dh pass), of vocab r and token c otherwise (A = E, B = h:
// the dE pass). p_adj (bf16) times the B tile is added into the row
// gradient dA (32 x D f32, in registers), written once in bf16.
// Logits: warp w sums k-half w / 4 of each chunk for columns 16 (w % 4).
// Gradient: warp w owns the 8-column tiles at d = 64 j + 8 w.
//
// Each B tile is staged once, in KC = ceil(D / 128) chunk slots, and
// read by both phases. A slot is refilled with the next tile's chunk
// once every warp has finished the gradient product on it, two slots at
// a time to save barriers: the gradient step of even chunk c >= 2
// refills chunks c - 2 and c - 1 (chunks [0, L), L = 2 floor((KC - 1)
// / 2)), and the next tile's first logits step the rest, [L, KC). The
// logits wait for the first lot before chunk 0 and for the rest before
// chunk L: 7 barriers a tile at D = 1024.
// DH_ADD (the variant "a": vocab rows, A = E, B = h) adds a third
// product on each tile, dB += p_adj^T A_rows into the f32 token
// gradient dB (in fragment order, see fused_ce_bwd_a_tc), with float4
// atomics, chunk by chunk beside the gradient product; the block walks
// the tiles from its own, tile x % ntiles.
template <bool TOK_ROWS, bool DH_ADD>
__device__ __forceinline__ void bwd_tc_body(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    const int* __restrict__ t, const float* __restrict__ lse,
    const float* __restrict__ g, bf16* __restrict__ dA,
    float* __restrict__ dB, int NR, int NC, int D,
    unsigned char* smem_raw) {
  const int KC = (D + B_DC - 1) / B_DC;
  const int ALD = KC * B_DC + 8;
  float* Red = reinterpret_cast<float*>(smem_raw);
  bf16* Bt = reinterpret_cast<bf16*>(smem_raw + sizeof(float) * B_BR * B_RLD);
  bf16* As = Bt + KC * B_BC * B_LD;
  bf16* Ps = As + B_BR * ALD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = warp >> 2, wn = warp & 3;
  const int gr = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.x * B_BR;
  const int ntiles = (NC + B_BC - 1) / B_BC;
  // the column tile of step i: in order, or for DH_ADD from the block's
  // own tile on, so that the blocks in flight add into different rows
  auto tile_of = [&](int i) {
    return DH_ADD ? (i + blockIdx.x) % ntiles : i;
  };

  // the block's rows of A, zero past NR and D, and column tile 0: the
  // first cp.async group
  {
    const int segs = KC * B_DC / 8;
    for (int idx = tid; idx < B_BR * segs; idx += B_THREADS) {
      const int r = idx / segs, d = (idx % segs) * 8;
      const bool p = r0 + r < NR && d < D;
      cp_async16(As + r * ALD + d, p ? A + (size_t)(r0 + r) * D + d : A, p);
    }
  }
  // chunk c of column tile T into slot c: 1024 16-byte pieces, 4 a thread
  auto load = [&](int T, int c) {
    bf16* dst = Bt + c * B_BC * B_LD;
    const int c0 = T * B_BC, d0 = c * B_DC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * B_THREADS;
      const int r = idx >> 4, d = d0 + (idx & 15) * 8;
      const bool p = c0 + r < NC && d < D;
      cp_async16(dst + r * B_LD + (idx & 15) * 8,
                 p ? B + (size_t)(c0 + r) * D + d : B, p);
    }
  };
  for (int c = 0; c < KC; ++c) load(tile_of(0), c);
  cp_async_commit();
  const int L = 2 * ((KC - 1) / 2);  // chunks refilled two at a time

  // token data of this thread's logits rows (TOK_ROWS): r = 2 mi + hf
  int tkr[4];
  float lkr[4], gkr[4];
  if (TOK_ROWS) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + (r >> 1) * 16 + gr + 8 * (r & 1);
      const bool ok = row < NR;
      tkr[r] = ok ? t[row] : -1;
      lkr[r] = ok ? lse[row] : 0.f;
      gkr[r] = ok ? g[row] : 0.f;
    }
  }

  float acc[2 * B_MAX_C][2][4];
#pragma unroll
  for (int j = 0; j < 2 * B_MAX_C; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][mi][k] = 0.f;

  for (int T = 0; T < ntiles; ++T) {
    const int c0 = tile_of(T) * B_BC;
    // logits: 32 x 64, this warp's 16 columns over its k-half
    float sacc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) sacc[mi][nt][k] = 0.f;
    for (int c = 0; c < KC; ++c) {
      if (c == 0) {
        // chunks [0, L) landed; every warp is done with the last tile
        cp_async_wait<0>();
        __syncthreads();
        if (T > 0) {
          for (int cc = L; cc < KC; ++cc) load(tile_of(T), cc);
          cp_async_commit();
        }
      }
      if (c == L && T > 0) {  // chunks [L, KC) landed
        cp_async_wait<0>();
        __syncthreads();
      }
      const bf16* Bs = Bt + c * B_BC * B_LD;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = (kh * 4 + kk) * 16;
        uint32_t a[2][4], b[4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], As + (mi * 16 + (lane & 15)) * ALD + c * B_DC + k +
                             (lane >> 4) * 8);
        ldsm_x4(b, Bs + (wn * 16 + (lane & 7) + ((lane >> 4) << 3)) * B_LD +
                       k + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(sacc[mi][0], a[mi], b[0], b[1]);
          mma_bf16(sacc[mi][1], a[mi], b[2], b[3]);
        }
      }
    }

    // p_adj: k-half 1 hands its sums to k-half 0, which forms the tile
    if (kh == 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                Red + (mi * 16 + gr + 8 * hf) * B_RLD + wn * 16 + nt * 8 +
                2 * q) = make_float2(sacc[mi][nt][2 * hf],
                                     sacc[mi][nt][2 * hf + 1]);
    }
    __syncthreads();
    if (kh == 0) {
      // token data of this thread's columns (vocab rows: columns are
      // tokens), [nt][e]
      int tkc[2][2];
      float lkc[2][2], gkc[2][2];
      if (!TOK_ROWS) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + wn * 16 + nt * 8 + 2 * q + e;
            const bool ok = col < NC;
            tkc[nt][e] = ok ? t[col] : -1;
            lkc[nt][e] = ok ? lse[col] : 0.f;
            gkc[nt][e] = ok ? g[col] : 0.f;
          }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = mi * 16 + gr + 8 * hf;
          const int row = r0 + rl;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int cl = wn * 16 + nt * 8 + 2 * q;
            const float2 o =
                *reinterpret_cast<const float2*>(Red + rl * B_RLD + cl);
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + cl + e;
              const float s = sacc[mi][nt][2 * hf + e] + (e ? o.y : o.x);
              const int tk = TOK_ROWS ? tkr[2 * mi + hf] : tkc[nt][e];
              const float lk = TOK_ROWS ? lkr[2 * mi + hf] : lkc[nt][e];
              const float gk = TOK_ROWS ? gkr[2 * mi + hf] : gkc[nt][e];
              const int voc = TOK_ROWS ? col : row;
              float p = 0.f;
              if (row < NR && col < NC) {
                p = __expf(s - lk);
                if (voc == tk) p -= 1.f;
                p *= gk;
              }
              pv[e] = p;
            }
            *reinterpret_cast<__nv_bfloat162*>(Ps + rl * B_PLD + cl) =
                __floats2bfloat162_rn(pv[0], pv[1]);
          }
        }
    }
    __syncthreads();
    uint32_t pf[2][4][4];  // p_adj as mma A fragments: [m tile][k step]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldsm_x4(pf[mi][ks], Ps + (mi * 16 + (lane & 15)) * B_PLD + ks * 16 +
                                (lane >> 4) * 8);
    // DH_ADD: dB[c0 + 0..63, :] += p_adj^T (64 x 32) A rows (32 x D),
    // chunk by chunk beside the gradient product, so that the adds spread
    // over the chunk loop. Warp w owns tokens 32 (w >> 2) + 16 mi and, of
    // each 128-wide chunk, columns 32 (w & 3) + 8 nt. p_adj^T fragments
    // by ldmatrix.trans of Ps (vocab-major), A's by ldmatrix.trans of As.
    // dB is in fragment order: the 16 x 8 tile (slab, ct) at ((slab D / 8
    // + ct) 32 + lane) 4, lane 4 gr + 2 qh + hf holding row 8 hf + gr,
    // columns 4 qh .. 4 qh + 3.
    const int wt = warp >> 2, wc = warp & 3;
    uint32_t pt[2][2][4];  // [m tile][k step]
    float* slab0 = nullptr;
    if (DH_ADD) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ldsm_x4_t(pt[mi][ks],
                    Ps + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * B_PLD +
                        wt * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
      slab0 = dB + (size_t)(c0 / 16 + wt * 2) * (D / 8) * 128 + lane * 4;
    }

    // gradient: dA[:, 64 j + 8 warp + (0..7)] += p_adj B_tile[:, same]
#pragma unroll
    for (int c = 0; c < B_MAX_C; ++c) {
      if (c < KC) {
        if (c >= 2 && !(c & 1) && T + 1 < ntiles) {
          __syncthreads();  // slots c - 2, c - 1 read by every warp
          load(tile_of(T + 1), c - 2);
          load(tile_of(T + 1), c - 1);
          cp_async_commit();
        }
        const bf16* Bs = Bt + c * B_BC * B_LD;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            uint32_t b[4];  // k steps 2 kp and 2 kp + 1
            ldsm_x4_t(b, Bs + (kp * 32 + lane) * B_LD + jj * 64 + warp * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(acc[2 * c + jj][mi], pf[mi][2 * kp], b[0], b[1]);
              mma_bf16(acc[2 * c + jj][mi], pf[mi][2 * kp + 1], b[2], b[3]);
            }
          }
        if (DH_ADD) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ct = c * (B_DC / 8) + wc * 4 + nt;
            if (ct * 8 >= D) continue;  // D % 8 == 0: all in or all out
            uint32_t b[4];  // k steps 0 and 1 (vocab rows 0-15, 16-31)
            ldsm_x4_t(b, As + lane * ALD + c * B_DC + wc * 32 + nt * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              float h4[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(h4, pt[mi][0], b[0], b[1]);
              mma_bf16(h4, pt[mi][1], b[2], b[3]);
              // lanes q, q ^ 1 swap a pair: 4 contiguous columns a lane
              const bool odd = q & 1;
              const float s0 = __shfl_xor_sync(0xffffffffu,
                                               odd ? h4[0] : h4[2], 1);
              const float s1 = __shfl_xor_sync(0xffffffffu,
                                               odd ? h4[1] : h4[3], 1);
              atomicAdd(reinterpret_cast<float4*>(
                            slab0 + ((size_t)mi * (D / 8) + ct) * 128),
                        odd ? make_float4(s0, s1, h4[2], h4[3])
                            : make_float4(h4[0], h4[1], s0, s1));
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2 * B_MAX_C; ++j) {
    const int col = j * 64 + warp * 8 + 2 * q;
    if (col >= D) continue;  // D % 8 == 0: a column tile is all in or out
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + mi * 16 + gr + 8 * hf;
        if (row < NR)
          *reinterpret_cast<__nv_bfloat162*>(dA + (size_t)row * D + col) =
              __floats2bfloat162_rn(acc[j][mi][2 * hf],
                                    acc[j][mi][2 * hf + 1]);
      }
  }
}

// the two passes, each its own symbol so that a profile tells them apart
__global__ void __launch_bounds__(B_THREADS, 1)
fused_ce_bwd_tc_dh_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ E,
                          const int* __restrict__ t,
                          const float* __restrict__ lse,
                          const float* __restrict__ g, bf16* __restrict__ dh,
                          int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_tc_body<true, false>(h, E, t, lse, g, dh, nullptr, N, V, D,
                           smem_raw);
}

__global__ void __launch_bounds__(B_THREADS, 1)
fused_ce_bwd_tc_de_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ E,
                          const int* __restrict__ t,
                          const float* __restrict__ lse,
                          const float* __restrict__ g, bf16* __restrict__ de,
                          int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_tc_body<false, false>(E, h, t, lse, g, de, nullptr, V, N, D,
                            smem_raw);
}

// the variant "a": the dE pass body, which also adds dh
__global__ void __launch_bounds__(B_THREADS, 1)
fused_ce_bwd_a_tc_kernel(const bf16* __restrict__ h,
                         const bf16* __restrict__ E,
                         const int* __restrict__ t,
                         const float* __restrict__ lse,
                         const float* __restrict__ g,
                         float* __restrict__ dh_acc, bf16* __restrict__ de,
                         int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_tc_body<false, true>(E, h, t, lse, g, de, dh_acc, V, N, D, smem_raw);
}

// One backward pass, the dh pass over the N token rows or the dE pass
// over the V vocab rows, after checking the shapes the passes take.
cudaError_t bwd_pass(bool dh_pass, const void* h, const void* E,
                     const void* t, const void* lse, const void* g,
                     void* out, int N, int V, int D, cudaStream_t st) {
  if (N < 1 || V < 1 || D < 8 || D % 8 || D > B_MAX_D)
    return cudaErrorInvalidValue;
  const auto kern =
      dh_pass ? fused_ce_bwd_tc_dh_kernel : fused_ce_bwd_tc_de_kernel;
  const size_t smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<((dh_pass ? N : V) + B_BR - 1) / B_BR, B_THREADS, smem, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(E),
      static_cast<const int*>(t), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<bf16*>(out), N, V, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h (N, D), E (V, D) bf16 with D % 8 == 0 (16-byte rows); t (N,) int32.
// lse, tl (N,) f32, tl zeroed by the caller; pm, pl f32 scratch of
// 2 slices x N each. Vocab tiles of 128 go to slices of tiles_per_slice
// each, slices of them (every slice non-empty). Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// shape it does not take).
int fused_ce_fwd_tc(const void* h, const void* E, const void* t, void* lse,
                    void* tl, void* pm, void* pl, int N, int V, int D,
                    int tiles_per_slice, int slices, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vtiles = (V + F_BV - 1) / F_BV;
  if (N < 1 || V < 1 || D < 8 || D % 8 || tiles_per_slice < 1 ||
      slices < 1 || (slices - 1) * tiles_per_slice >= vtiles ||
      slices * tiles_per_slice < vtiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + F_BM - 1) / F_BM, slices);
  fused_ce_fwd_tc_kernel<<<grid, F_THREADS, F_SMEM, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(E),
      static_cast<const int*>(t), static_cast<float*>(tl),
      static_cast<float*>(pm), static_cast<float*>(pl), N, V, D,
      tiles_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_lse_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<float*>(lse), N, F_PARTS * slices);
  return (int)cudaGetLastError();
}

// h (N, D), E (V, D) bf16 with D % 8 == 0 and D <= 1024; t, lse, g (N,);
// dh (N, D) and de (V, D) bf16, each written once: the dh pass, then the
// dE pass, on the stream in that order.
int fused_ce_bwd_tc(const void* h, const void* E, const void* t,
                    const void* lse, const void* g, void* dh, void* de,
                    int N, int V, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bwd_pass(true, h, E, t, lse, g, dh, N, V, D, st);
  if (err != cudaSuccess) return (int)err;
  return (int)bwd_pass(false, h, E, t, lse, g, de, N, V, D, st);
}

// The variant "split", one pass each, with fused_ce_bwd_tc's arguments:
// dh (N, D), written once by fused_ce_dh_tc; de (V, D), by fused_ce_de_tc.
int fused_ce_dh_tc(const void* h, const void* E, const void* t,
                   const void* lse, const void* g, void* dh, int N, int V,
                   int D, void* stream) {
  return (int)bwd_pass(true, h, E, t, lse, g, dh, N, V, D,
                       static_cast<cudaStream_t>(stream));
}

int fused_ce_de_tc(const void* h, const void* E, const void* t,
                   const void* lse, const void* g, void* de, int N, int V,
                   int D, void* stream) {
  return (int)bwd_pass(false, h, E, t, lse, g, de, N, V, D,
                       static_cast<cudaStream_t>(stream));
}

// The variant "a", one pass: h (N, D), E (V, D) bf16 with D % 8 == 0 and
// D <= 1024; t, lse, g (N,); de (V, D) bf16, written once; dh_acc f32,
// zeroed by the caller, of ceil(N / 64) * 64 rows x D in fragment order
// (the 16 x 8 tile of rows 16 s, columns 8 c at ((s D / 8 + c) 32 + l) 4,
// l = 4 (r % 8) + 2 ((d % 8) / 4) + (r % 16) / 8 holding row r, columns
// d .. d + 3 of it, d % 4 == 0), into which dh is added.
int fused_ce_bwd_a_tc(const void* h, const void* E, const void* t,
                      const void* lse, const void* g, void* dh_acc, void* de,
                      int N, int V, int D, void* stream) {
  if (N < 1 || V < 1 || D < 8 || D % 8 || D > B_MAX_D)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_a_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_ce_bwd_a_tc_kernel<<<(V + B_BR - 1) / B_BR, B_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(E),
      static_cast<const int*>(t), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dh_acc),
      static_cast<bf16*>(de), N, V, D);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#!/usr/bin/env python3
"""The gradient adds of a one-pass merged CE backward, alone, on one GPU.

    python3 tools/torch_ce_atomics_probe.py [--pattern dh|a_kernel|de] [N V D]

A merged cross-entropy backward that keeps one gradient on chip must add
its blocks' contributions to the other into an f32 accumulator. This
tool runs those adds without any arithmetic, in the kernel's address
pattern and volume, times each way of issuing them with CUDA events and
prints one JSON line per layout, then the card's name and power limit.
The kernel sources are written beside the port's built kernels and built
with the port's ``nvcc`` flags. Needs a CUDA device; imports nothing of
JAX.

``--pattern dh`` (the default): variant "a" (#6, ``fused_ce_bwd_a_tc``).
A block owns 32 vocab rows, keeps dE on chip and walks the tokens in
64-row tiles, each block starting at its own tile; for every tile it
adds a 64 x D contribution into the f32 (N, D) dh accumulator: (V/R) N D
adds a launch when R vocab rows are summed before the add. The blocks
ask for 200 KB of shared memory, so one runs on an SM, as the kernel's
do. Layouts, each holding the contribution as the kernel's ``mma.sync``
fragments hold it:

- ``red_v4_r32``: d_model in chunks of 128, each thread adds its 32
  values as eight ``float4`` ``atomicAdd``s (``red.global.add.v4.f32``)
  after one lane shuffle has made four columns contiguous;
- ``bulk_r32``: chunks of 64 staged in a padded 64 x 72 f32 shared tile,
  then one TMA bulk reduce-add (``cp.reduce.async.bulk ... add.f32``) of
  256 bytes per row, issued by 64 threads; one staging buffer, whose
  reads are awaited before it is written again;
- ``cluster{2,4}_red_r{64,128}``: thread-block clusters of 2 or 4 blocks
  (adjacent vocab groups, on the same token tile at once) sum their
  64 x 32 chunks in distributed shared memory first: each block writes
  the rows a peer owns into that peer's slot buffer (double-buffered,
  one cluster barrier a chunk), the owner sums the C slots and adds
  them with vector ``atomicAdd``s;
- ``cluster{2,4}_bulk_r{64,128}``: the same pre-sum, the owner's sum
  staged and added with one bulk reduce-add per row;
- ``red_v4_r64``, ``red_v4_r128``: ``red_v4`` by half and a quarter as
  many blocks, the adds a perfect pre-sum would leave, for reference;
- ``blocked_red_v4_r32``, ``blocked_bulk_r32``: the accumulator in the
  fragments' order (each 16 x 8 tile 512 contiguous bytes in lane
  order), so a warp's ``float4`` add covers 512 contiguous bytes; the
  bulk form stages chunks of 64 columns in that order and adds each
  16-row slab of a chunk (4 KB) with one bulk reduce-add.

Every contribution is 1.0, so the accumulator holds exact counts, and
each layout is checked to have added every contribution exactly once.

``--pattern a_kernel``: the adds inside ``fused_ce_bwd_a_tc`` itself. The
tool builds two copies of ``csrc/fused_ce_tc.cu``: as it is, and with
its one ``atomicAdd`` behind a test of the value that never holds, so
that the dh product and its shuffles still run but nothing is added.
Both are launched on the same seeded bf16 inputs at (N, V, D), timed in
turns (with adds, without, without, with): their difference is what the
adds cost inside the kernel, past what the tensor-core work hides.

``--pattern de``: variant "b" (#7) in one pass, the measurement that
made its bf16 kernel two passes without atomics. N/32 blocks
of 256 threads each walk the vocabulary in 64-row tiles and add a
64 x D tile into the f32 (V, D) dE accumulator, with scalar and with
``float4`` ``atomicAdd``, every block starting at tile 0 or each at its
own tile.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DE_SOURCE = r"""
#include <cuda_runtime.h>

// mode 0: scalar adds, 1: float4 adds; stagger: block b starts at tile b
__global__ void probe_kernel(float* de, int V, int D, int mode,
                             int stagger) {
  const int tiles = V / 64;
  const float val = 1e-7f * (float)(threadIdx.x + 1);
  for (int i = 0; i < tiles; ++i) {
    const int vt = stagger ? (i + blockIdx.x) % tiles : i;
    float* base = de + (size_t)vt * 64 * D;
    if (mode == 0) {
      for (int e = threadIdx.x; e < 64 * D; e += blockDim.x)
        atomicAdd(base + e, val);
    } else {
      float4* b4 = reinterpret_cast<float4*>(base);
      const float4 v = make_float4(val, val, val, val);
      for (int e = threadIdx.x; e < 64 * D / 4; e += blockDim.x)
        atomicAdd(b4 + e, v);
    }
  }
}

extern "C" int probe(void* de, int blocks, int V, int D, int mode,
                     int stagger, void* stream) {
  probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (float*)de, V, D, mode, stagger);
  return (int)cudaGetLastError();
}
"""

DH_SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int TOK = 64;              // token rows of a tile
constexpr int SLD = 72;              // staging row (f32): 64 + 8
constexpr int CW = 32;               // cluster chunk width
constexpr int CLD = CW + 8;          // cluster slot row (f32)
constexpr size_t SMEM = 200 * 1024;  // one block an SM

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bulk_add(float* g, const float* s, int n) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(g), "r"(saddr(s)), "r"(n) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// red_v4: chunks of 128 columns; warp (wt, wc) holds rows 32 wt + 16 mi +
// gr + 8 hf and columns 32 wc + 8 nt + 2 q (+1); lanes q, q ^ 1 swap one
// pair, so a lane adds row gr + 8 (q & 1), columns 8 nt + 4 (q >> 1) (+3)
__global__ void __launch_bounds__(THREADS, 1)
dh_red(float* acc, int N, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wt = warp >> 2, wc = warp & 3, gr = lane >> 2, q = lane & 3;
  const int ntiles = N / TOK;
  for (int i = 0; i < ntiles; ++i) {
    const int T = (i + blockIdx.x) % ntiles;
    for (int c = 0; c < D / 128; ++c)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float x = 1.f, y = 1.f;
          const float rx = __shfl_xor_sync(0xffffffffu, x, 1);
          const float ry = __shfl_xor_sync(0xffffffffu, y, 1);
          const int row = T * TOK + wt * 32 + mi * 16 + gr + 8 * (q & 1);
          const int col = c * 128 + wc * 32 + nt * 8 + 4 * (q >> 1);
          atomicAdd(reinterpret_cast<float4*>(acc + (size_t)row * D + col),
                    make_float4(x, y, rx, ry));
        }
  }
}

// blocked: the accumulator in fragment order -- each 16 x 8 tile (16-row
// slab r / 16, 8-column tile c / 8) is 512 contiguous bytes, lane 4 gr +
// 2 qh + hf holding row 8 hf + gr, columns 4 qh (+3) -- so one red_v4
// instruction of a warp covers 512 contiguous bytes (4 whole lines).
// BULK: chunks of 64 columns staged in that order, one 4 KB bulk
// reduce-add per 16-row slab
__device__ __forceinline__ size_t blocked(int slab, int ct, int D,
                                          int lane) {
  return (((size_t)slab * (D / 8) + ct) * 32 + lane) * 4;
}

template <bool BULK>
__global__ void __launch_bounds__(THREADS, 1)
dh_blocked(float* acc, int N, int D) {
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wt = warp >> 2, wc = warp & 3;
  const int ntiles = N / TOK;
  const int W = BULK ? 64 : 128, NT = W / 32;
  for (int i = 0; i < ntiles; ++i) {
    const int T = (i + blockIdx.x) % ntiles;
    for (int c = 0; c < D / W; ++c) {
      if (BULK) {
        if (tid < 4) bulk_wait_read();
        __syncthreads();
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= NT) break;
          float x = 1.f, y = 1.f;
          const float rx = __shfl_xor_sync(0xffffffffu, x, 1);
          const float ry = __shfl_xor_sync(0xffffffffu, y, 1);
          const int slab = wt * 2 + mi;          // of the tile's 4
          const int ct = wc * NT + nt;           // of the chunk's W / 8
          if (BULK) {
            *reinterpret_cast<float4*>(smem + blocked(slab, ct, W, lane)) =
                make_float4(x, y, rx, ry);
          } else {
            atomicAdd(reinterpret_cast<float4*>(
                          acc + blocked(T * 4 + slab, c * (W / 8) + ct, D,
                                        lane)),
                      make_float4(x, y, rx, ry));
          }
        }
      if (BULK) {
        fence_async_smem();
        __syncthreads();
        if (tid < 4) {
          bulk_add(acc + blocked(T * 4 + tid, c * 8, D, 0),
                   smem + blocked(tid, 0, W, 0), 16 * W * 4);
          bulk_commit();
        }
      }
    }
  }
  if (BULK && tid < 4) bulk_wait();
}

// bulk: chunks of 64 columns staged in a 64 x 72 tile; warp (wt, wc)
// writes rows 32 wt + 16 mi + gr + 8 hf, columns 16 wc + 8 nt + 2 q
__global__ void __launch_bounds__(THREADS, 1)
dh_bulk(float* acc, int N, int D) {
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wt = warp >> 2, wc = warp & 3, gr = lane >> 2, q = lane & 3;
  const int ntiles = N / TOK;
  for (int i = 0; i < ntiles; ++i) {
    const int T = (i + blockIdx.x) % ntiles;
    for (int c = 0; c < D / 64; ++c) {
      if (tid < TOK) bulk_wait_read();
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                smem + (wt * 32 + mi * 16 + gr + 8 * hf) * SLD + wc * 16 +
                nt * 8 + 2 * q) = make_float2(1.f, 1.f);
      fence_async_smem();
      __syncthreads();
      if (tid < TOK) {
        bulk_add(acc + (size_t)(T * TOK + tid) * D + c * 64, smem + tid * SLD,
                 64 * 4);
        bulk_commit();
      }
    }
  }
  if (tid < TOK) bulk_wait();
}

// cluster pre-sum: chunks of 32 columns; rank p owns rows [p R, p R + R),
// R = 64 / C. Slot buffers [2][C][R][CLD] f32; the block writes the rows
// p owns into p's slot [rank], one cluster barrier, then p sums its C
// slots and adds them (BULK: staged after the slots, one bulk add a row)
template <int C, bool BULK>
__global__ void __launch_bounds__(THREADS, 1)
dh_cluster(float* acc, int N, int D) {
  extern __shared__ __align__(128) float smem[];
  constexpr int R = TOK / C;
  constexpr int BUF = C * R * CLD;      // = TOK * CLD
  constexpr int PER = R * CW / THREADS; // summed values a thread
  float* sum = smem + 2 * BUF;          // R x CLD staging (BULK)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wt = warp >> 2, wc = warp & 3, gr = lane >> 2, q = lane & 3;
  const int ntiles = N / TOK;
  const int group = blockIdx.x / C;
  int n = 0;
  for (int i = 0; i < ntiles; ++i) {
    const int T = (i + group) % ntiles;
    for (int c = 0; c < D / CW; ++c, ++n) {
      float* buf = smem + (n & 1) * BUF;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = wt * 32 + mi * 16 + gr + 8 * hf;
          float* dst = cluster.map_shared_rank(buf, row / R);
          *reinterpret_cast<float2*>(dst + (rank * R + row % R) * CLD +
                                     wc * 8 + 2 * q) = make_float2(1.f, 1.f);
        }
      cluster.sync();
      const int e0 = tid * PER, lr = e0 / CW, col = e0 % CW;
      float s[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) s[k] = 0.f;
#pragma unroll
      for (int p = 0; p < C; ++p)
#pragma unroll
        for (int k = 0; k < PER; ++k)
          s[k] += buf[(p * R + lr) * CLD + col + k];
      float* g = acc + (size_t)(T * TOK + rank * R + lr) * D + c * CW + col;
      if (BULK) {
        if (tid < R) bulk_wait_read();
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER; ++k) sum[lr * CLD + col + k] = s[k];
        fence_async_smem();
        __syncthreads();
        if (tid < R) {
          bulk_add(acc + (size_t)(T * TOK + rank * R + tid) * D + c * CW,
                   sum + tid * CLD, CW * 4);
          bulk_commit();
        }
      } else if (PER == 4) {
        atomicAdd(reinterpret_cast<float4*>(g),
                  make_float4(s[0], s[1], s[2], s[3]));
      } else {
        atomicAdd(reinterpret_cast<float2*>(g), make_float2(s[0], s[1]));
      }
    }
  }
  if (BULK && tid < R) bulk_wait();
  cluster.sync();  // no block leaves while a peer may still write to it
}

template <typename K>
int launch(K kern, int blocks, int cluster, float* acc, int N, int D,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, acc, N, D);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// layout: 0 red_v4, 1 bulk, 2/3 cluster 2 red/bulk, 4/5 cluster 4
// red/bulk, 6/7 fragment order red_v4/bulk; blocks: vocab groups (a
// multiple of the cluster)
extern "C" int probe_dh(void* acc, int layout, int blocks, int N, int D,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* a = (float*)acc;
  if (N % TOK || D % 128) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case 0: return launch(dh_red, blocks, 1, a, N, D, st);
    case 1: return launch(dh_bulk, blocks, 1, a, N, D, st);
    case 2: return launch(dh_cluster<2, false>, blocks, 2, a, N, D, st);
    case 3: return launch(dh_cluster<2, true>, blocks, 2, a, N, D, st);
    case 4: return launch(dh_cluster<4, false>, blocks, 4, a, N, D, st);
    case 5: return launch(dh_cluster<4, true>, blocks, 4, a, N, D, st);
    case 6: return launch(dh_blocked<false>, blocks, 1, a, N, D, st);
    case 7: return launch(dh_blocked<true>, blocks, 1, a, N, D, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* probe_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""

#: dh layouts: (name, layout code, vocab rows a block, cluster size)
DH_LAYOUTS = (("red_v4_r32", 0, 32, 1), ("bulk_r32", 1, 32, 1),
              ("cluster2_red_r64", 2, 32, 2), ("cluster2_bulk_r64", 3, 32, 2),
              ("cluster4_red_r128", 4, 32, 4),
              ("cluster4_bulk_r128", 5, 32, 4),
              ("red_v4_r64", 0, 64, 1), ("red_v4_r128", 0, 128, 1),
              ("blocked_red_v4_r32", 6, 32, 1),
              ("blocked_bulk_r32", 7, 32, 1))


def build(name: str, source: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` into ``<name>.so`` beside the port's kernels;
    returns the library and nvcc's ``-Xptxas -v`` report."""
    from distributed_tensorflow_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, f"{name}.cu")
    lib = os.path.join(_build.BUILD_DIR, f"{name}.so")
    with open(src, "w") as f:
        f.write(source)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(lib), proc.stdout + proc.stderr


def timed(run, reps: int = 3) -> list[float]:
    import torch
    run()                                                  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def probe_de(n: int, v: int, d: int) -> dict:
    import torch
    lib, _ = build("ce_atomics_probe", DE_SOURCE)
    lib.probe.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
    lib.probe.restype = ctypes.c_int
    de = torch.zeros((v, d), dtype=torch.float32, device="cuda")
    blocks = (n + 31) // 32
    stream = torch.cuda.current_stream().cuda_stream
    out = {"pattern": "de", "shape": [n, v, d], "blocks": blocks,
           "adds": blocks * v * d, "accumulator_bytes": v * d * 4}
    for name, mode, stagger in (("scalar", 0, 0), ("float4", 1, 0),
                                ("float4_staggered", 1, 1),
                                ("scalar_staggered", 0, 1)):
        def run():
            err = lib.probe(de.data_ptr(), blocks, v, d, mode, stagger,
                            stream)
            if err:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")
        times = timed(run)
        out[f"{name}_ms"] = min(times)
        out[f"{name}_ms_runs"] = times
    out["best_ms"] = min(out[k] for k in out if k.endswith("_ms"))
    return out


def probe_dh(n: int, v: int, d: int) -> list[dict]:
    import torch
    lib, log = build("ce_dh_adds_probe", DH_SOURCE)
    lib.probe_dh.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])
    lib.probe_dh.restype = ctypes.c_int
    lib.probe_error.argtypes = [ctypes.c_int]
    lib.probe_error.restype = ctypes.c_char_p
    acc = torch.zeros((n, d), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, layout, per_block, cluster in DH_LAYOUTS:
        groups = -(-v // per_block)
        blocks = -(-groups // cluster) * cluster

        def run():
            err = lib.probe_dh(acc.data_ptr(), layout, blocks, n, d, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err} "
                                   f"({lib.probe_error(err).decode()})")

        acc.zero_()
        times = timed(run)
        torch.cuda.synchronize()
        # each launch adds one contribution of 1.0 per block to every
        # element (a cluster's C blocks' summed): 4 launches
        want = 4.0 * blocks
        exact = bool((acc == want).all().item())
        adds = blocks // cluster * n * d
        best = min(times)
        rows.append({"pattern": "dh", "layout": name,
                     "shape": [n, v, d], "vocab_rows_summed":
                     per_block * cluster, "cluster": cluster,
                     "blocks": blocks, "adds": adds, "ms": best,
                     "ms_runs": times,
                     "gb_s": adds * 4 / (best * 1e-3) / 1e9,
                     "exact": exact})
    rows.append({"pattern": "dh", "ptxas": log[-3000:]})
    return rows


#: the one add of fused_ce_tc.cu, and the same behind a test that never
#: holds but that the compiler cannot decide (the entry point refuses
#: D < 8), so the values it adds are still computed
KERNEL_ADD = "atomicAdd(reinterpret_cast<float4*>("
KERNEL_NO_ADD = "if (D < 0) " + KERNEL_ADD


def probe_a_kernel(n: int, v: int, d: int) -> list[dict]:
    import torch

    import chip_smoke as cs
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import fused_ce as ce
    with open(os.path.join(_build.CSRC, "fused_ce_tc.cu")) as f:
        source = f.read()
    if source.count(KERNEL_ADD) != 1:
        raise RuntimeError("fused_ce_tc.cu no longer has exactly one "
                           "float4 atomicAdd to switch off")
    libs = {}
    for name, src in (("with_adds", source),
                      ("without_adds",
                       source.replace(KERNEL_ADD, KERNEL_NO_ADD))):
        src = f'#include "{_build.CSRC}/mma_sm90.cuh"\n' + src.replace(
            '#include "mma_sm90.cuh"', "")
        lib, _ = build(f"ce_a_kernel_{name}", src)
        fn = lib.fused_ce_bwd_a_tc
        fn.argtypes = ce.CE_TC_ARGTYPES["fused_ce_bwd_a_tc"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = cs._rand((n, d), torch.bfloat16, gen)
    e = cs._rand((v, d), torch.bfloat16, gen, 0.1)
    t = torch.randint(0, v, (n,), device="cuda", generator=gen)
    g = torch.rand(n, device="cuda", generator=gen) / n
    lse, _ = ce.fused_ce_fwd(h, e, t)
    t32 = t.to(torch.int32)
    rows = -(-n // ce.TC_A_TOKEN_TILE) * ce.TC_A_TOKEN_TILE
    dh_acc = torch.zeros(rows * d, dtype=torch.float32, device="cuda")
    de = torch.empty_like(e)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn):
        def run():
            err = fn(h.data_ptr(), e.data_ptr(), t32.data_ptr(),
                     lse.data_ptr(), g.data_ptr(), dh_acc.data_ptr(),
                     de.data_ptr(), n, v, d, stream)
            if err:
                raise RuntimeError(f"fused_ce_bwd_a_tc: CUDA error {err}")
        return run

    with_adds, without = (launcher(libs[k]) for k in ("with_adds",
                                                      "without_adds"))
    w1 = cs.time_ms(with_adds, 5)
    o1 = cs.time_ms(without, 5)
    o2 = cs.time_ms(without, 5)
    w2 = cs.time_ms(with_adds, 5)
    w, o = (w1 + w2) / 2, (o1 + o2) / 2
    flops = 6 * n * v * d
    return [{"pattern": "a_kernel", "shape": [n, v, d],
             "with_adds_ms": w, "with_adds_ms_runs": [w1, w2],
             "without_adds_ms": o, "without_adds_ms_runs": [o1, o2],
             "adds_cost_ms": w - o,
             "adds": -(-v // 32) * rows * d,
             "tflops_with_adds": flops / (w * 1e-3) / 1e12,
             "tflops_without_adds": flops / (o * 1e-3) / 1e12}]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pattern", choices=("dh", "a_kernel", "de"),
                    default="dh")
    ap.add_argument("shape", nargs="*", type=int,
                    default=[4096, 32768, 1024])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ce_atomics_probe: no CUDA device", file=sys.stderr)
        return 2
    n, v, d = args.shape
    rows = {"dh": probe_dh, "a_kernel": probe_a_kernel,
            "de": lambda *a: [probe_de(*a)]}[args.pattern](n, v, d)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if all(r.get("exact", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

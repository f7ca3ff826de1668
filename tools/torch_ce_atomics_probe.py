#!/usr/bin/env python3
"""The dE atomics of a one-pass merged CE backward, alone, on one GPU.

    python3 tools/torch_ce_atomics_probe.py [N V D]

A merged cross-entropy backward whose blocks each own 32 token rows and
keep dh on chip (variant "b") must add every block's dE tile contribution
into an f32 (V, D) accumulator: N/32 x V x D f32 adds a launch, 4.29e9
at the train step's chunk (N 4096, V 32768, D 1024). This tool runs that
atomic pass without any arithmetic, in the kernel's address pattern and
volume: N/32 blocks of 256 threads, each walking the vocabulary in
64-row tiles and adding a 64 x D tile into the accumulator, with scalar
``atomicAdd`` (``red.global.add.f32``) and with ``float4``
``atomicAdd`` (sm_90: ``red.global.add.v4.f32``), every block starting
at tile 0 or each at its own tile. It times each with CUDA events and
prints one JSON line with the card's name and power limit. The kernel
source is written beside the port's built kernels and built with the
port's ``nvcc`` flags. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SOURCE = r"""
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


def build() -> ctypes.CDLL:
    from distributed_tensorflow_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "ce_atomics_probe.cu")
    lib = os.path.join(_build.BUILD_DIR, "ce_atomics_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    so.probe.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    so.probe.restype = ctypes.c_int
    return so


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_ce_atomics_probe: no CUDA device", file=sys.stderr)
        return 2
    n, v, d = (int(x) for x in sys.argv[1:4]) if len(sys.argv) >= 4 \
        else (4096, 32768, 1024)
    lib = build()
    de = torch.zeros((v, d), dtype=torch.float32, device="cuda")
    blocks = (n + 31) // 32
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode, stagger):
        err = lib.probe(de.data_ptr(), blocks, v, d, mode, stagger, stream)
        if err:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")

    out = {"shape": [n, v, d], "blocks": blocks,
           "adds": blocks * v * d, "accumulator_bytes": v * d * 4}
    for name, mode, stagger in (("scalar", 0, 0), ("float4", 1, 0),
                                ("float4_staggered", 1, 1),
                                ("scalar_staggered", 0, 1)):
        run(mode, stagger)                                 # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run(mode, stagger)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[f"{name}_ms"] = min(times)
        out[f"{name}_ms_runs"] = times
    out["best_ms"] = min(out[k] for k in out if k.endswith("_ms")
                         and not k.endswith("runs_ms"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

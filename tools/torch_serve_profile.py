#!/usr/bin/env python3
"""Where a serving step's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_serve_profile.py [--prompt-len 512] [--slots 8]

Builds the port's ``InferenceEngine`` at the full width of
``transformer_big`` in bf16 (random weights from seed 0) and traces two
windows with ``torch.profiler``:

- ``prefill`` — one request with a ``--prompt-len`` prompt and one new
  token (prefill only);
- ``decode``  — ``--steps`` steps of a full decode batch of ``--slots``
  sequences (prompts of ``--decode-prompt-len``), no admissions.

For each window it prints one JSON line: host wall time per step, the
device's busy time (union of kernel intervals) and idle share, kernel
launches per step, and the kernels with the most device time. Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _kernels(prof):
    """The device events of a trace, without the ranges that annotate a
    stretch of them (``Optimizer.step#...``), which would count twice."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(name, prof, wall_s, steps):
    ks = _kernels(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in ks)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in ks:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    wall_us = wall_s * 1e6
    return {"window": name, "steps": steps,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": (1 - busy / wall_us) if ks else None,
            "kernel_launches_per_step": len(ks) / steps,
            "top_kernels": [{"name": n[:90], "count": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--decode-prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request

    cfg = TransformerConfig.transformer_big()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    engine = InferenceEngine(
        cfg, params, device="cuda", max_slots=args.slots, block_size=16,
        num_blocks=args.slots * cfg.max_seq_len // 16 + 1)
    del params
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    engine.generate([prompt(64), prompt(args.prompt_len)],
                    max_new_tokens=4)                      # warm-up
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)

    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate([prompt(args.prompt_len)], max_new_tokens=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps(summarize("prefill", prof, wall, 1)), flush=True)

    for i in range(args.slots):
        engine.submit(Request(id=f"d{i}", tokens=prompt(
            args.decode_prompt_len), max_new_tokens=args.steps + 8))
    while len(engine.scheduler.queue) or not all(
            s.prefilled for s in engine.scheduler.running.values()):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps(summarize(f"decode_batch{args.slots}", prof, wall,
                               args.steps)), flush=True)
    engine.run_until_idle()
    return 0


if __name__ == "__main__":
    sys.exit(main())

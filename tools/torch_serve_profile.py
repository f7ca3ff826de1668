#!/usr/bin/env python3
"""Where a serving step's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_serve_profile.py [--prompt-len 512] [--slots 8]
        [--batch N] [--prefix-len 0] [--speculative-k 0]

Builds the port's ``InferenceEngine`` at the full width of
``transformer_big`` in bf16 (random weights from seed 0) and traces two
windows with ``torch.profiler``:

- ``prefill`` — one request with a ``--prompt-len`` prompt and one new
  token (prefill only). With ``--prefix-len P`` the engine caches
  prefixes and the prompt shares its first P tokens with a prompt
  served in the warm-up, so the window is one prefix hit's suffix
  prefill (``prefill_hit``: ``--prompt-len`` - P tokens against the
  whole prompt). Before it, untraced, the line's ``host_ms`` times a
  hit of that shape at its first use and again, and a cold prefill of
  the whole prompt's length again (each one request, host clock);
- ``decode``  — ``--steps`` steps of a decode batch of ``--batch``
  sequences (default: ``--slots``, a full batch; prompts of
  ``--decode-prompt-len``) in an engine of ``--slots`` slots, no
  admissions. With
  ``--speculative-k k`` each step is a speculative one (``spec_decode``:
  up to k proposals of the default truncated draft, as many as the
  widest span can commit, then one verify).

For each window it prints one JSON line: host wall time per step, the
device's busy time (union of kernel intervals) and idle share, kernel
launches per step, device time by group (the port's hand-written
kernels, matrix products, the rest) and the kernels with the most device
time. Needs a CUDA device; imports nothing of JAX.
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

# device-kernel name fragments of each group, first match wins
GROUPS = (("flash_fwd_tc", ("flash_fwd_tc_kernel",)),
          ("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_bwd_dq_tc", ("flash_bwd_dq_tc_kernel",)),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("flash_bwd_dkv_tc", ("flash_bwd_dkv_tc_kernel",)),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("fused_ce_fwd", ("fused_ce_fwd_kernel", "fused_ce_fwd_tc_kernel",
                            "fused_ce_lse_merge_kernel")),
          ("fused_ce_bwd", ("fused_ce_bwd_kernel", "fused_ce_bwd_tc_dh_kernel",
                            "fused_ce_bwd_tc_de_kernel")),
          ("fused_adamw", ("fused_adamw_kernel",)),
          ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


def _kernels(prof):
    """The device events of a trace, without the ranges that annotate a
    stretch of them (``Optimizer.step#...``), which would count twice."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(name, prof, wall_s, steps, group=None):
    """One window's numbers; ``group`` maps a device event to its group
    (by default :func:`group_of` its name)."""
    group = group or (lambda e: group_of(e.name))
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
    groups = collections.defaultdict(lambda: [0, 0.0])
    for e in ks:
        for acc in (by_name[e.name], groups[group(e)]):
            acc[0] += 1
            acc[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    wall_us = wall_s * 1e6
    return {"window": name, "steps": steps,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": (1 - busy / wall_us) if ks else None,
            "kernel_launches_per_step": len(ks) / steps,
            "by_group_per_step": {
                k: {"launches": c / steps, "ms": us / steps / 1e3}
                for k, (c, us) in sorted(groups.items(),
                                         key=lambda kv: -kv[1][1])},
            "top_kernels": [{"name": n[:90], "count": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences in the decode window (default: --slots)")
    ap.add_argument("--decode-prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prefix-len", type=int, default=0)
    ap.add_argument("--speculative-k", type=int, default=0)
    args = ap.parse_args()
    batch = args.slots if args.batch is None else args.batch
    if not 1 <= batch <= args.slots:
        ap.error("--batch must lie in [1, --slots]")
    if not 0 <= args.prefix_len < args.prompt_len:
        ap.error("--prefix-len must lie in [0, --prompt-len)")
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
        num_blocks=args.slots * cfg.max_seq_len // 16 + 1,
        prefix_caching=args.prefix_len > 0,
        speculative_k=args.speculative_k)
    del params
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def timed_ms(tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate([tokens], max_new_tokens=1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    shared = prompt(args.prompt_len)
    engine.generate([prompt(64), shared],
                    max_new_tokens=4)                      # warm-up
    host_ms = {}
    if args.prefix_len:      # the hit path: its shape's first use, again
        def hit():
            return (shared[:args.prefix_len]
                    + prompt(args.prompt_len - args.prefix_len))
        for key in ("hit_first_use", "hit_again"):
            host_ms[key] = timed_ms(hit())
        host_ms["cold_again"] = timed_ms(prompt(args.prompt_len))
        target = hit()
    else:
        target = prompt(args.prompt_len)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}), flush=True)

    hits0 = engine.stats().get("prefix_cache", {}).get("hit_tokens", 0)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate([target], max_new_tokens=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    window = "prefill_hit" if args.prefix_len else "prefill"
    print(json.dumps({**summarize(window, prof, wall, 1),
                      "prompt_len": args.prompt_len, "host_ms": host_ms,
                      "cached_tokens": engine.stats().get(
                          "prefix_cache", {}).get("hit_tokens", 0) - hits0}),
          flush=True)

    for i in range(batch):
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
    window = "spec_decode" if args.speculative_k else "decode"
    print(json.dumps({**summarize(f"{window}_batch{batch}", prof,
                                  wall, args.steps), "slots": args.slots,
                      **({"speculative": engine.stats()["speculative"]}
                         if args.speculative_k else {})}), flush=True)
    engine.run_until_idle()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a train step's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_train_profile.py [--fused-optimizer]

Builds the port's train step (``make_train_step``) of ``bench.py``'s
headline row at the full width of ``transformer_big`` in bf16 (random
weights from seed 0, batch 8 x 1024, no remat, unrolled layers, kernel
cross-entropy, bf16 AdamW first moment: the ``train`` phase of
``chip_smoke.py``; with ``--fused-optimizer`` its ``train_fused``
phase), takes one warm-up step, then traces one step with
``torch.profiler``. Prints one JSON line: host wall time of the step,
the device's busy time (union of kernel intervals) and idle share,
kernel launches, device time by group (the port's hand-written kernels,
matrix products, the plain optimizer's step, the rest) and the kernels
with the most device time. The ``optimizer`` group holds the kernels
that run inside the device-side range ``torch.optim`` puts around
``Optimizer.step``. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torch_serve_profile import _kernels, summarize  # noqa: E402

BATCH = 8

# device-kernel name fragments of each group, first match wins
GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
          ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("fused_ce_fwd", ("fused_ce_fwd_kernel",)),
          ("fused_ce_bwd", ("fused_ce_bwd_kernel",)),
          ("fused_adamw", ("fused_adamw_kernel",)),
          ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, frags in GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


def optimizer_ranges(prof):
    """Device time ranges of the ``Optimizer.step`` annotations."""
    import torch
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "is_user_annotation", False)
            and e.name.startswith("Optimizer.step")]


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_params, make_optimizer,
        make_train_step)

    fused = "--fused-optimizer" in sys.argv[1:]
    cfg = TransformerConfig.transformer_big(
        max_seq_len=1024, remat=False, scan_layers=False, loss_impl="kernel",
        adam_mu_dtype=torch.bfloat16, fused_optimizer=fused)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    model = TransformerLM(cfg, params, device="cuda")
    del params
    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(cfg, model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, cfg.max_seq_len))).to("cuda")
    batch = {"tokens": tokens}
    state = {"model": model, "optimizer": opt, "step": 0}
    state, _ = step(state, batch)                          # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize("train_step", prof, wall, 1)
    groups = collections.defaultdict(lambda: [0, 0.0])
    opt_ranges = optimizer_ranges(prof)
    for e in _kernels(prof):
        name = group_of(e.name)
        if name == "other" and any(a <= e.time_range.start < b
                                   for a, b in opt_ranges):
            name = "optimizer"
        g = groups[name]
        g[0] += 1
        g[1] += (e.time_range.end - e.time_range.start) / 1e3
    out.update({
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "config": "transformer_big", "layers": cfg.n_layers,
        "batch": BATCH, "seq_len": cfg.max_seq_len,
        "dtype": "bfloat16", "fused_optimizer": fused,
        "loss": metrics["loss"].item(),
        "optimizer_ranges_ms": [(b - a) / 1e3 for a, b in opt_ranges],
        "by_group": {k: {"launches": c, "ms": ms}
                     for k, (c, ms) in sorted(groups.items(),
                                              key=lambda kv: -kv[1][1])}})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

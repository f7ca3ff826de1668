#!/usr/bin/env python3
"""Plain AdamW against the fused AdamW kernel on the PyTorch port's train
step, in turns on one GPU: the port's counterpart of ``tools/opt_ab.py``.

    python3 tools/torch_opt_ab.py [batch] [n_iters] [rounds]

Builds two arms of the ``bench.py`` headline configuration
(``transformer_big``, max_seq_len 1024, no remat, unrolled layers,
kernel cross-entropy, bf16 AdamW first moment) from the same seeded
weights and tokens: ``plain`` runs ``AdamW.step`` (plain tensor ops),
``fused`` runs ``fused_optimizer=True`` (one ``fused_adamw`` launch per
parameter tensor). After one warm-up step each, every round times
``n_iters`` steps of each arm with CUDA events, in turns; the best round
per arm is its step time. Then the optimizer update alone is timed per
arm. Prints one JSON line per arm, one with the difference, and the
card's name and power limit. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _cuda_ms(fn, n: int) -> float:
    """Mean time of ``fn`` over ``n`` calls between two CUDA events (the
    card's time, including any wait for the host to launch)."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def build(fused: bool, batch: int):
    """``(step, state, batch, optimizer_update)`` of one arm."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_params, make_optimizer,
        make_train_step)

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
        0, cfg.vocab_size, (batch, cfg.max_seq_len))).to("cuda")

    # the arm's optimizer update alone, over the current gradients
    update = opt.fused_step if fused else opt.step
    return (step, {"model": model, "optimizer": opt, "step": 0},
            {"tokens": tokens}, update)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_opt_ab: no CUDA device", file=sys.stderr)
        return 2
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    torch.backends.cuda.matmul.allow_tf32 = False

    arms = {name: build(fused, batch)
            for name, fused in (("plain", False), ("fused", True))}
    states, losses = {}, {}
    for name, (step, state, data, _) in arms.items():
        states[name], metrics = step(state, data)            # warm-up
        losses[name] = [metrics["loss"].item()]

    runs = {name: [] for name in arms}
    for _ in range(rounds):
        for name, (step, _, data, _) in arms.items():
            def one(name=name, step=step, data=data):
                states[name], metrics = step(states[name], data)
                losses[name].append(metrics["loss"])
            runs[name].append(_cuda_ms(one, n_iters))
    updates = {name: _cuda_ms(update, 10)
               for name, (_, _, _, update) in arms.items()}

    tokens = batch * 1024
    out = {}
    for name in arms:
        best = min(runs[name])
        out[name] = {"arm": name, "batch": batch, "n_iters": n_iters,
                     "rounds": rounds, "step_ms_rounds": runs[name],
                     "step_ms_best": best, "tokens_per_s": tokens / best * 1e3,
                     "optimizer_update_ms": updates[name],
                     "loss_first": losses[name][0],
                     "loss_last": float(losses[name][-1])}
        print(json.dumps(out[name]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "step_ms_saved": out["plain"]["step_ms_best"]
        - out["fused"]["step_ms_best"],
        "optimizer_ms_saved": updates["plain"] - updates["fused"],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

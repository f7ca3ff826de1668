#!/usr/bin/env python3
"""Data-parallel training of the PyTorch port across GPUs, with the phase
breakdown of ``bench.py``'s ``transformer_phase_breakdown``.

    python3 tools/torch_dp_run.py --world 4 [--mesh dp|dcn2xdp2]
        [--zero 0|1|2] [--grad-sync auto|none|gspmd]
        [--workload transformer|bert] [--device cuda|cpu] [--tiny]

Spawns one rank a device through the port's ``testing/
multi_process_runner`` (NCCL on ``cuda``, gloo on ``cpu``) and builds
``make_sharded_train_step`` (BERT: ``models/bert.py``'s) over the mesh:
``transformer`` is ``bench.py``'s headline row (``transformer_big``,
max_seq_len 1024, no remat, unrolled layers, kernel cross-entropy, bf16
AdamW first moment) at 8 × 1024 tokens a rank, ``bert`` its ``run_bert``
(``bert_base``, full-logits MLM loss) at 32 × 512 a rank; random
weights from seed 0, one seeded batch. Each rank times, with CUDA
events, the best of ``--reps`` means over ``--iters`` steps after a
warm-up step of:

- the full step;
- the same compute without the gradient sync (``grad_sync="none"``;
  for BERT, and at one rank, the step on the rank's rows alone);
- the bucketed all-reduce alone on a gradient-shaped list of tensors
  (serial: nothing to hide behind), chained.

Rank 0 prints one JSON line with ``bench.py``'s fields: ``compute_frac``
(no-sync over full), ``collective_frac`` (exposed over full, exposed =
full − no-sync), ``overlap_eff`` (1 − exposed / serial),
``nosync_step_ms``, ``collective_serial_ms``, ``n_buckets``; and the
step ms, tokens/s, the kernels' launches a step and every rank's times,
with the card's name and power limit. ``--out`` writes the same line to
a file. ``--tiny`` swaps in ``TransformerConfig.tiny()`` (for a CPU
rehearsal; its numbers are no device's). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: rows a rank, as bench.py's scaling row (transformer) and run_bert
BATCH = {"transformer": 8, "bert": 32}


def _config(workload: str, tiny: bool):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    if tiny:
        return TransformerConfig.tiny(causal=workload == "transformer",
                                      max_seq_len=64, remat=False)
    if workload == "bert":
        return TransformerConfig.bert_base(remat=False, scan_layers=False)
    return TransformerConfig.transformer_big(
        max_seq_len=1024, remat=False, scan_layers=False,
        loss_impl="kernel", adam_mu_dtype=torch.bfloat16)


def _timer(device):
    import time
    import torch
    if device.type == "cuda":
        def timed(fn, iters):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                fn()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3 / iters
    else:
        def timed(fn, iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters
    return timed


def _best(timed, fn, iters, reps):
    fn()                                         # warm-up
    return min(timed(fn, iters) for _ in range(reps))


def _launches() -> dict:
    from distributed_tensorflow_tpu_torch.ops import attention, fused_ce
    return {"flash_fwd_tc": attention.flash_attention_fwd.launches_tc,
            "flash_bwd_dq_tc": attention.flash_attention_bwd.launches_dq_tc,
            "flash_bwd_dkv_tc":
                attention.flash_attention_bwd.launches_dkv_tc,
            "fused_ce_fwd_tc": fused_ce.fused_ce_fwd.launches_tc,
            "fused_ce_bwd_tc": fused_ce.fused_ce_bwd.launches_tc}


def _rank(args) -> dict:
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import bert as tbert
    from distributed_tensorflow_tpu_torch.models import transformer as tf
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp)
    rt = bootstrap.initialize(device=args.device)
    world, rank, device = dist.get_world_size(), dist.get_rank(), rt.device
    if args.mesh == "dcn2xdp2":
        mesh = topology.make_hybrid_mesh({"dcn": 2}, {"dp": -1},
                                         device=args.device)
    else:
        mesh = topology.make_mesh({"dp": world}, device=args.device)
    cfg = _config(args.workload, args.tiny)
    rows = BATCH[args.workload]
    gb = rows * world
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (gb, cfg.max_seq_len))).to(device)
    batch = {"tokens": tokens}
    timed = _timer(device)
    out = {"rank": rank, "device": (torch.cuda.get_device_name()
                                    if device.type == "cuda" else "cpu")}

    # the full step
    if args.workload == "bert":
        state, step = tbert.make_sharded_train_step(cfg, mesh, gb)
    else:
        state, step = tf.make_sharded_train_step(
            cfg, mesh, gb, zero=args.zero, grad_sync=args.grad_sync)
    box = {"state": state}

    def full():
        box["state"], m = step(box["state"], batch)
        box["loss"] = m["loss"]
    full()
    from distributed_tensorflow_tpu_torch.ops import attention, fused_ce
    before = _launches()
    dt_full = _best(timed, full, args.iters, args.reps)
    after = _launches()
    n_steps = 1 + args.iters * args.reps
    out["launches_per_step"] = {k: (after[k] - before[k]) / n_steps
                                for k in after}
    out["loss"] = float(box["loss"])
    model = box["state"]["model"]
    leaves = tf.jax_leaf_params(cfg, model)
    grads = [torch.cat([p.detach().reshape(-1) for p in ps])
             for ps in leaves]
    del box, state, step, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the same compute without the sync
    if args.workload == "transformer" and world > 1 and \
            args.mesh in ("dp", "dcn2xdp2"):
        nstate, nstep = tf.make_sharded_train_step(cfg, mesh, gb,
                                                   grad_sync="none")
        local = batch
    else:
        model = tf.TransformerLM(cfg, device=device,
                                 generator=torch.Generator(
                                     device=device).manual_seed(0))
        opt = tf.make_optimizer(cfg, model.parameters())
        nstep = (tbert.make_train_step(cfg, model, opt)
                 if args.workload == "bert"
                 else tf.make_train_step(cfg, model, opt))
        nstate = {"model": model, "optimizer": opt, "step": 0}
        local = {"tokens": tokens[rank * rows:(rank + 1) * rows]}
    nbox = {"state": nstate}

    def nosync():
        nbox["state"], _ = nstep(nbox["state"], local)
    dt_nosync = _best(timed, nosync, args.iters, args.reps)
    del nbox, nstate, nstep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the bucketed all-reduce alone, chained on a gradient-shaped list
    axes = topology.data_axes(mesh)
    outer, inner = tf._hybrid_axes(mesh, axes)
    bucketer = GradientBucketer(mesh, axes, outer_axis=outer,
                                inner_axis=inner)
    gbox = {"g": grads}

    def collective():
        gbox["g"] = bucketer.all_reduce(gbox["g"], ReduceOp.MEAN)
    dt_coll = _best(timed, collective, args.iters, args.reps)
    plan = bucketer.plan_summary(grads)
    bootstrap.shutdown()

    exposed = max(0.0, dt_full - dt_nosync)
    eff = (None if dt_coll <= 0 else
           max(0.0, min(1.0, 1.0 - exposed / dt_coll)))
    out.update({
        "step_ms": dt_full * 1e3,
        "tokens_per_s": gb * cfg.max_seq_len / dt_full,
        "compute_frac": min(1.0, dt_nosync / dt_full),
        "collective_frac": exposed / dt_full,
        "infeed_wait_frac": 0.0,
        "overlap_eff": eff,
        "nosync_step_ms": dt_nosync * 1e3,
        "exposed_collective_ms": exposed * 1e3,
        "collective_serial_ms": dt_coll * 1e3,
        "n_buckets": len(plan),
        "bucket_bytes": sum(b["bytes"] for b in plan)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every visible card)")
    ap.add_argument("--mesh", choices=("dp", "dcn2xdp2"), default="dp")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2), default=0)
    ap.add_argument("--grad-sync", default="auto",
                    choices=("auto", "none", "gspmd", "bucketed"))
    ap.add_argument("--workload", choices=("transformer", "bert"),
                    default="transformer")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_dp_run: no CUDA device", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    ranks = multi_process_runner.run(_rank, world, args=(args,),
                                     device=args.device,
                                     timeout=1800).return_values
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    r0 = ranks[0]
    line = {"workload": args.workload, "world": world, "mesh": args.mesh,
            "zero": args.zero, "grad_sync": args.grad_sync,
            "device": args.device, "tiny": args.tiny,
            "rows_per_rank": BATCH[args.workload],
            "iters": args.iters, "reps": args.reps, "nvidia_smi": smi,
            **{k: v for k, v in r0.items() if k != "rank"},
            "ranks": [{k: r[k] for k in ("rank", "step_ms",
                                         "nosync_step_ms",
                                         "collective_serial_ms", "loss")}
                      for r in ranks]}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

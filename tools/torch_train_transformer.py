#!/usr/bin/env python3
"""Flagship transformer pretraining across every parallelism axis, on
the port — the counterpart of ``examples/train_transformer.py``.

Pick a mesh shape, get one train step, feed global batches. The mesh
spans processes, one a card: ``--axes`` needs as many ranks as its
sizes multiply to (a -1 is filled from the visible cards), and the
script spawns them itself (``testing/multi_process_runner``; under
``torchrun`` it is one of them).

    # data parallel over every visible card
    python3 tools/torch_train_transformer.py --axes dp=-1
    # fsdp + tensor parallel
    python3 tools/torch_train_transformer.py --axes dp=2,fsdp=2,tp=2
    # GPipe pipeline over dp×pp
    python3 tools/torch_train_transformer.py --axes dp=2,pp=2 --microbatches 4
    # MoE experts over dp×ep
    python3 tools/torch_train_transformer.py --axes dp=2,ep=2 --moe-experts 4
    # causal sequence parallelism (ring / striped)
    python3 tools/torch_train_transformer.py --axes dp=2,sp=2 --sp-impl ring
    # the CPU, tiny model, gloo ranks
    python3 tools/torch_train_transformer.py --device cpu --axes dp=2

The model: on the card ``TransformerConfig.transformer_big()`` (d 1024,
16 heads, d_ff 4096, 1024 tokens, batch 8 — ``bench.py``'s headline
row: kernel cross-entropy, bf16 AdamW first moment, no remat; a mesh
with ``pp`` keeps the config's defaults, the pipelined step's), so the
step runs the flash-attention kernels and the fused cross-entropy on
the card. ``tiny()`` only under ``--tiny`` or ``--device cpu``: there
is no fallback by backend.

The tokens: uniform over the vocabulary from a ``torch.Generator``
seeded 0 (:func:`synthetic_tokens`). The JAX script draws them with
``jax.random``, which the port does not import, so the two scripts'
batches differ; :func:`run` takes ``tokens=`` (and ``params=``) to feed
the same ones.

The tokens/s line times the steps from the first, its warm-up
included, as the JAX script does, stopped after a
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_train_transformer"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--axes", default="dp=-1",
                    help="mesh axes, e.g. dp=2,fsdp=2,tp=2")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized model (default on CPU)")
    ap.add_argument("--microbatches", type=int, default=2,
                    help="pipeline microbatches when the mesh has pp")
    ap.add_argument("--schedule", default="gpipe",
                    choices=["gpipe", "1f1b"],
                    help="pipeline schedule (1f1b = interleaved "
                         "one-forward-one-backward, O(stages) "
                         "activation memory)")
    ap.add_argument("--grad-sync", default="auto",
                    choices=["auto", "bucketed", "gspmd"],
                    help="gradient sync on non-pp meshes (auto = "
                         "reverse-order bucketed collectives on >1 "
                         "device pure-dp meshes)")
    ap.add_argument("--moe-experts", type=int, default=0)
    ap.add_argument("--sp-impl", default="ring",
                    choices=["ring", "ulysses", "striped"])
    torch_entry.add_device_flag(ap)
    return ap


def make_config(args, device: str, shape: dict):
    """The script's model: ``tiny()`` under ``--tiny`` or on the CPU,
    else ``transformer_big()`` (the module docstring)."""
    import torch

    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    tiny = args.tiny or device == "cpu"
    kw = {}
    if args.seq_len:
        kw["max_seq_len"] = args.seq_len
    if args.moe_experts:
        kw["moe_experts"] = args.moe_experts
    if shape.get("sp", 1) > 1:
        kw["sp_impl"] = args.sp_impl
        if tiny and args.sp_impl == "striped" and device == "cpu":
            kw["sp_attn_impl"] = "interpret"
    if tiny:
        return TransformerConfig.tiny(**kw)
    if shape.get("pp", 1) <= 1:
        kw = {"remat": False, "loss_impl": "kernel",
              "adam_mu_dtype": torch.bfloat16, **kw}
    return TransformerConfig.transformer_big(**kw)


def synthetic_tokens(global_batch: int, seq_len: int, vocab_size: int,
                     seed: int = 0, device="cpu"):
    """``(global_batch, seq_len)`` int64 tokens uniform over
    ``[0, vocab_size)`` from a ``torch.Generator`` seeded ``seed``."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab_size, (global_batch, seq_len),
                         generator=gen).to(device)


def rank_main(args_dict: dict, tokens=None, params=None,
              echo: bool = False) -> dict:
    """One rank (or the only process): the mesh, the step, the loop.
    Returns ``{"lines", "losses", "tokens_per_s", ...}``; prints its
    lines as it goes when ``echo``."""
    import torch

    from distributed_tensorflow_tpu_torch.cluster.topology import mesh_shape
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_pipelined_train_step, make_sharded_train_step)

    r = torch_entry.Rank(args_dict, echo)
    args = r.args
    shape = mesh_shape(r.mesh)
    r.say(f"mesh: {shape} on {args.device}")
    cfg = make_config(args, args.device, shape)
    if shape.get("pp", 1) > 1:
        state, step = make_pipelined_train_step(
            cfg, r.mesh, args.global_batch,
            num_microbatches=args.microbatches,
            schedule=args.schedule, params=params)
    else:
        state, step = make_sharded_train_step(cfg, r.mesh, args.global_batch,
                                              grad_sync=args.grad_sync,
                                              params=params)
    if tokens is None:
        tokens = synthetic_tokens(args.global_batch, cfg.max_seq_len,
                                  cfg.vocab_size)
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.tensor(tokens)
    tokens = tokens.to(device=r.rt.device, dtype=torch.int64)
    cuda = r.rt.device.type == "cuda"
    losses = []
    t0 = time.perf_counter()
    t1 = None
    for i in range(args.steps):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(metrics["loss"].detach())
        if i % 5 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            r.say(f"step {i}: loss={loss:.4f}")
        if i == 0:
            t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    dt = t_end - t0
    tok = args.steps * args.global_batch * cfg.max_seq_len
    r.say(f"{tok / dt:,.0f} tokens/s over {args.steps} steps")
    out = {"losses": [float(v) for v in losses], "tokens_per_s": tok / dt,
           "mesh": shape, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "seq_len": cfg.max_seq_len, "global_batch": args.global_batch}
    if args.steps > 1:
        out["steady_tokens_per_s"] = ((args.steps - 1) * args.global_batch
                                      * cfg.max_seq_len / (t_end - t1))
        out["steady_step_ms"] = (t_end - t1) / (args.steps - 1) * 1e3
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["card"] = torch.cuda.get_device_name()
    return r.finish(out)


def run(args, tokens=None, params=None) -> dict:
    """The script's run: in this process when the mesh has one rank or
    a launcher started it (``WORLD_SIZE`` set), else over spawned ranks,
    whose rank 0 lines are printed once they finish. ``tokens`` (the
    global batch) and ``params`` (the port's full parameter dict, e.g.
    JAX's converted by ``params_from_jax``) replace the seeded tokens
    and the seeded initialisation. Returns rank 0's results."""
    return torch_entry.run_ranks(PROG, rank_main, args, tokens, params)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

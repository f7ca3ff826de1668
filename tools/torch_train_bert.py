#!/usr/bin/env python3
"""BERT MLM pretraining on a synthetic corpus, on the port — the
counterpart of ``examples/train_bert.py`` (BASELINE.md config #3).

The encoder is the flagship transformer in bidirectional mode with
dynamic 80/10/10 masking, sharded over the mesh axes you pick (dp /
fsdp / tp), one process a card (the script spawns the ranks, as
``tools/torch_train_transformer.py`` does).

    python3 tools/torch_train_bert.py --axes dp=-1 --steps 20
    python3 tools/torch_train_bert.py --axes dp=2,tp=2 --seq 512
    python3 tools/torch_train_bert.py --device cpu --steps 5

On the card the model is ``bert_config()`` (bert_base: d 768, 12 heads,
12 layers, V 30522), so attention runs the flash kernels, not causal;
``tiny_bert_config()`` only under ``--tiny`` or ``--device cpu``. The
corpus is ``synthetic_corpus`` (JAX's tokens, token for token); the
masks come from a ``torch.Generator`` seeded by ``(seed, step)``
(``models/bert.py mask_seed``), where JAX draws them with
``jax.random``: :func:`run` takes ``masking=`` to feed JAX's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_train_bert"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--axes", default="dp=-1")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized model (default on CPU)")
    torch_entry.add_device_flag(ap)
    return ap


def rank_main(args_dict: dict, params=None, masking=None,
              echo: bool = False) -> dict:
    """One rank (or the only process). Returns ``{"lines", "losses",
    "samples_per_s", ...}``."""
    import torch

    from distributed_tensorflow_tpu_torch.cluster.topology import mesh_shape
    from distributed_tensorflow_tpu_torch.models import bert

    r = torch_entry.Rank(args_dict, echo)
    args = r.args
    tiny = args.tiny or args.device == "cpu"
    cfg = (bert.tiny_bert_config(max_seq_len=args.seq)
           if tiny else bert.bert_config(max_seq_len=args.seq))
    state, step_fn = bert.make_sharded_train_step(
        cfg, r.mesh, args.global_batch, params=params, masking=masking)
    batch = bert.synthetic_corpus(args.global_batch, cfg.max_seq_len,
                                  cfg.vocab_size, device=r.rt.device)
    cuda = r.rt.device.type == "cuda"
    losses = []
    t0 = None
    for i in range(args.steps):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].detach())
        if i == 0:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.time()
        if i % 5 == 0 or i == args.steps - 1:
            r.say(f"step {i}: mlm_loss={float(metrics['loss']):.4f}")
    if cuda:
        torch.cuda.synchronize()
    out = {"losses": [float(v) for v in losses], "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "seq_len": cfg.max_seq_len,
           "global_batch": args.global_batch}
    if args.steps > 1:
        rate = (args.steps - 1) * args.global_batch / (time.time() - t0)
        r.say(f"throughput: {rate:,.1f} samples/sec on "
              f"{mesh_shape(r.mesh)}")
        out["samples_per_s"] = rate
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return r.finish(out)


def run(args, params=None, masking=None) -> dict:
    """In this process for a one-rank mesh (or under a launcher), else
    over spawned ranks; ``params`` (the port's full parameter dict) and
    ``masking(step, tokens) -> (inputs, labels)`` replace the seeded
    initialisation and masks. Returns rank 0's results."""
    return torch_entry.run_ranks(PROG, rank_main, args, params, masking)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

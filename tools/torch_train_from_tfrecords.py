#!/usr/bin/env python3
"""Train Wide&Deep or DLRM from TFRecord files of tf.Example protos on
the card — the port of ``examples/train_from_tfrecords.py``.

The migration path a reference user takes: their click logs are
TFRecord shards of ``tf.train.Example``. This script

1. writes synthetic click logs as sharded tf.Example TFRecords (a
   stand-in for an existing dataset; ``--data-dir`` reads real ones),
2. builds the host pipeline with the port's parser,
   ``Dataset.from_files(shards, example_reader(spec))`` → map → repeat →
   shuffle → batch → prefetch, FILE auto-sharded across processes with
   ``auto_shard_dataset`` (each process reads its slice of the shards
   and assembles its rows of the global batch),
3. trains with ``models/wide_deep.py make_sharded_train_step`` over a
   ``{"dp": world}`` mesh (one card: ``{"dp": 1}``).

    python3 tools/torch_train_from_tfrecords.py --steps 60
    python3 tools/torch_train_from_tfrecords.py --preset dlrm_like \\
        --global-batch 4096 --steps 12
    python3 tools/torch_train_from_tfrecords.py --device cpu --steps 20

Prints one JSON line: the losses, steps/s and examples/s of the timed
steps (all but the first), the step loop's wait on the input pipeline
a step, and the host pipeline's own ms a batch (parsing, shuffling and
batching with nothing consuming but the timer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: preset -> (config constructor name, default global batch, examples a
#: shard); tiny is the JAX example's default
PRESETS = {"tiny": ("tiny", 128, 512), "dlrm_like": ("dlrm_like", 4096, 4096)}
SHUFFLE_BUFFER, PREFETCH = 1024, 2


def make_config(preset: str):
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    return getattr(wd.WideDeepConfig, PRESETS[preset][0])()


def write_click_shards(cfg, out_dir: str, n_shards: int = 4,
                       per_shard: int = 512) -> list:
    """Synthetic click logs (``synthetic_clicks``, seed 0) as tf.Example
    TFRecord shards: ``dense`` floats, ``categorical`` and ``label``
    int64s, as the JAX example writes them."""
    from distributed_tensorflow_tpu_torch.input import encode_example
    from distributed_tensorflow_tpu_torch.input.native_loader import (
        write_tfrecords)
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    data = wd.synthetic_clicks(cfg, n_shards * per_shard)
    paths = []
    for s in range(n_shards):
        lo = s * per_shard
        payloads = (
            encode_example({
                "dense": np.asarray(data["dense"][i]),
                "categorical": np.asarray(data["categorical"][i], np.int64),
                "label": np.asarray([int(data["label"][i])], np.int64)})
            for i in range(lo, lo + per_shard))
        path = os.path.join(out_dir, f"clicks-{s:05d}-of-{n_shards:05d}")
        write_tfrecords(path, payloads)
        paths.append(path)
    return paths


def feature_spec(cfg) -> dict:
    from distributed_tensorflow_tpu_torch.input import FixedLenFeature
    return {
        "dense": FixedLenFeature((cfg.num_dense_features,), np.float32),
        "categorical": FixedLenFeature((len(cfg.vocab_sizes),), np.int64),
        "label": FixedLenFeature((1,), np.int64),
    }


def to_batch(ex: dict) -> dict:
    return {"dense": ex["dense"],
            "categorical": ex["categorical"].astype(np.int32),
            "label": ex["label"][0].astype(np.int32)}


def make_pipeline(files, cfg, per_process: int, process_id: int = 0,
                  num_processes: int = 1):
    """The JAX example's chain: repeat BEFORE shuffle (a fresh shuffle
    pass an epoch), shuffled with the process id as seed, FILE-sharded
    (each process re-reads only its slice of the shards)."""
    from distributed_tensorflow_tpu_torch.input import (
        Dataset, example_reader)
    from distributed_tensorflow_tpu_torch.input.dataset import (
        AutoShardPolicy, auto_shard_dataset)
    ds = (Dataset.from_files(files, example_reader(feature_spec(cfg)))
          .map(to_batch)
          .repeat()
          .shuffle(SHUFFLE_BUFFER, seed=process_id)
          .batch(per_process, drop_remainder=True)
          .prefetch(PREFETCH))
    return auto_shard_dataset(ds, num_processes, process_id,
                              AutoShardPolicy.AUTO)


def host_ms_per_batch(files, cfg, per_process: int, n: int) -> float:
    """The host pipeline alone: ms a batch over ``n`` batches after the
    first (parsing, shuffling, batching; nothing else consumes)."""
    it = iter(make_pipeline(files, cfg, per_process))
    next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) * 1e3 / n


def train(cfg, files, global_batch: int, steps: int, device="cuda",
          params=None) -> dict:
    """``steps`` steps of the sharded W&D step fed by the pipeline; the
    first is warm-up, the rest are timed. Each step's time ends when
    its loss is on the host. ``params`` (a flax tree of numpy arrays)
    seeds the model; else rank 0 initialises it from seed 0."""
    import torch

    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.topology import make_mesh
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    runtime = bootstrap.initialize(device=device)
    per_process = global_batch // runtime.num_processes
    it = iter(make_pipeline(files, cfg, per_process, runtime.process_id,
                            runtime.num_processes))
    mesh = make_mesh({"dp": -1}, device=device)
    state, step = wd.make_sharded_train_step(cfg, mesh, global_batch,
                                             params=params)
    model = state["model"]
    dev = next(model.parameters()).device

    def rows_loss(host) -> float:
        """This process's rows' mean loss under the current weights."""
        b = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        with torch.no_grad():
            return wd.sigmoid_bce(model(b["dense"], b["categorical"]),
                                  b["label"]).mean().item()

    first = next(it)
    before = rows_loss(first)
    losses, step_s, wait_s = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        host = first if i == 0 else next(it)    # this process's rows
        t1 = time.perf_counter()
        # every rank's copy of the global batch: each rank's own rows at
        # its offset (the step takes this rank's slice back out)
        batch = {k: np.concatenate([v] * runtime.num_processes)
                 for k, v in host.items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        t2 = time.perf_counter()
        if i:
            step_s.append(t2 - t0)
            wait_s.append(t1 - t0)
    if device != "cpu":
        torch.cuda.synchronize()
    mean_s = float(np.mean(step_s)) if step_s else float("nan")
    return {"losses": losses,
            # the first batch's rows before and after the steps: on fresh
            # rows each step the loss moves little, on these it must fall
            "first_batch_loss_before": before,
            "first_batch_loss_after": rows_loss(first),
            "step_ms": [s * 1e3 for s in step_s],
            "steps_per_s": 1.0 / mean_s,
            "examples_per_s": global_batch / mean_s,
            "input_wait_ms_per_step": float(np.mean(wait_s)) * 1e3
            if wait_s else float("nan"),
            "input_wait_share": float(np.sum(wait_s) / np.sum(step_s))
            if step_s else float("nan"),
            "world": runtime.num_processes, "per_process": per_process}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--per-shard", type=int, default=None)
    ap.add_argument("--data-dir", default=None,
                    help="existing TFRecord dir (default: write synthetic)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = make_config(args.preset)
    _, batch, per_shard = PRESETS[args.preset]
    batch = args.global_batch or batch
    tmp = None
    if args.data_dir:
        files = sorted(os.path.join(args.data_dir, f)
                       for f in os.listdir(args.data_dir))
    else:
        tmp = tempfile.TemporaryDirectory(prefix="clicks_")
        t0 = time.perf_counter()
        files = write_click_shards(cfg, tmp.name, args.shards,
                                   args.per_shard or per_shard)
        write_s = time.perf_counter() - t0
    try:
        out = {"preset": args.preset, "global_batch": batch,
               "files": len(files)}
        if tmp is not None:
            out["write_s"] = write_s
        out["host_ms_per_batch"] = host_ms_per_batch(files, cfg, batch, 3)
        out.update(train(cfg, files, batch, args.steps, args.device))
        k = min(10, len(out["losses"]))
        out["loss_first"] = sum(out["losses"][:k]) / k
        out["loss_last"] = sum(out["losses"][-k:]) / k
        print(json.dumps(out), flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()
        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

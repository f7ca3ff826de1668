#!/usr/bin/env python3
"""ResNet-50 sync data-parallel training, single- or multi-worker, on
the port — the counterpart of ``examples/train_resnet.py`` (BASELINE.md
config #2: ResNet-50 under ``MultiWorkerMirroredStrategy``).

Every process trains on its rows of the global batch
(``models/resnet.py make_sharded_train_step`` over a ``{"dp": -1}``
mesh, one process a card); the gradients and BatchNorm statistics are
meaned over the ranks.

Input: synthetic batches (the default; each process draws its rows
with its process id as seed, as JAX's does) or real on-disk JPEGs
through the parallel host pipeline (``input/image_ops.py
jpeg_pipeline``, FILE-sharded across processes, ``InfeedLoop`` staging
the batches on the card), with the infeed wait reported:

    # one process, synthetic batches
    python3 tools/torch_train_resnet.py --steps 30
    # real JPEGs: generate 512 on disk, then train from them
    python3 tools/torch_train_resnet.py --steps 30 --gen-jpegs 512
    # ResNet-50 at 224² (32² picks the tiny config, as JAX's does)
    python3 tools/torch_train_resnet.py --image-size 224 --gen-jpegs 256
    # a TF_CONFIG cluster of 3 worker processes on one box
    python3 tools/torch_train_resnet.py --spawn 3 --steps 10 --gen-jpegs 512
    python3 tools/torch_train_resnet.py --device cpu --steps 5

``--spawn N`` runs N workers through the port's
``testing/multi_process_runner.MultiProcessRunner`` with ``TF_CONFIG``
injected per process, as a cluster launch would; each worker imports
:func:`worker_main` from this script by its module name.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_train_resnet"


def _embed(local, rows: slice, global_batch: int):
    """``local`` (this process's rows) at ``rows`` of a global-batch
    tensor: the sharded step reads only its rows of the batch it is
    given."""
    import torch
    local = torch.as_tensor(local)
    if rows.start == 0 and rows.stop - rows.start == global_batch:
        return local
    out = local.new_zeros((global_batch,) + tuple(local.shape[1:]))
    out[rows] = local
    return out


def _jpeg_infeed(data_dir: str, runtime, rows: slice, global_batch: int,
                 per_process_batch: int, image_size: int,
                 num_classes: int):
    """files -> FILE-sharded parallel decode pipeline -> InfeedLoop
    staging this process's rows of the global batch on its device."""
    import glob

    import torch

    from distributed_tensorflow_tpu_torch.input.dataset import AUTOTUNE
    from distributed_tensorflow_tpu_torch.input.image_ops import (
        jpeg_pipeline)
    from distributed_tensorflow_tpu_torch.training.loops import InfeedLoop

    files = sorted(glob.glob(os.path.join(data_dir, "*.jpg")))
    if len(files) < runtime.num_processes:
        raise SystemExit(
            f"{data_dir} has {len(files)} JPEGs; FILE sharding needs at "
            f"least one per process ({runtime.num_processes})")
    ds = jpeg_pipeline(
        files, batch_size=per_process_batch, image_size=image_size,
        num_parallel_calls=AUTOTUNE, prefetch_depth=4,
        num_shards=runtime.num_processes,
        shard_index=runtime.process_id)
    device = runtime.device

    def place(batch):
        if int(batch["label"].max()) >= num_classes:
            raise ValueError(
                f"label {int(batch['label'].max())} >= num_classes "
                f"{num_classes}; generate the data with matching classes")
        return {k: _embed(torch.as_tensor(batch[k]), rows,
                          global_batch).to(device, non_blocking=True)
                for k in ("image", "label")}

    return InfeedLoop(iter(ds), place_fn=place, buffer_size=3), ds


def train(steps: int, global_batch: int, image_size: int,
          data_dir: str | None = None, device: str = "cuda", *,
          batch=None, params=None, batch_stats=None) -> dict:
    """One worker's run; returns ``{"losses", "final_loss", ...}``.
    ``batch`` (the global batch, numpy) replaces the synthetic one,
    ``params`` / ``batch_stats`` (flax trees) the seeded init."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.topology import make_mesh
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.models.transformer import (
        _data_rows)

    owned = not dist.is_initialized()
    runtime = bootstrap.initialize(device=device)   # reads TF_CONFIG
    mesh = make_mesh({"dp": -1}, device=device)     # every rank
    if global_batch < runtime.num_processes:
        raise SystemExit(
            f"--global-batch {global_batch} is smaller than the process "
            f"count {runtime.num_processes}; every process needs >= 1 "
            f"sample")
    if global_batch % runtime.num_processes:
        adjusted = (global_batch // runtime.num_processes
                    * runtime.num_processes)
        print(f"global batch {global_batch} not divisible by "
              f"{runtime.num_processes} processes; using {adjusted}",
              flush=True)
        global_batch = adjusted
    cfg = resnet.ResNetConfig.resnet50() if image_size >= 128 \
        else resnet.ResNetConfig.tiny()
    state, step_fn = resnet.make_sharded_train_step(
        cfg, mesh, global_batch, image_size=image_size, params=params,
        batch_stats=batch_stats)
    per_process = global_batch // runtime.num_processes
    rows = _data_rows(mesh, global_batch)
    dev = runtime.device

    infeed = None
    if data_dir is not None:
        infeed, _ds = _jpeg_infeed(data_dir, runtime, rows, global_batch,
                                   per_process, image_size,
                                   cfg.num_classes)
        next_batch = infeed.next
    else:
        if batch is None:
            local = resnet.synthetic_images(
                per_process, image_size, cfg.num_classes,
                seed=runtime.process_id)
            static = {k: _embed(local[k], rows, global_batch).to(dev)
                      for k in ("image", "label")}
        else:
            static = {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
                      for k in ("image", "label")}
        next_batch = lambda: static  # noqa: E731

    cuda = dev.type == "cuda"
    losses = []
    t0, imgs = None, 0
    for i in range(steps):
        b = next_batch()
        state, metrics = step_fn(state, b)
        losses.append(metrics["loss"].detach())
        if i == 0:                      # skip the warm-up in the rate
            if cuda:
                torch.cuda.synchronize()
            if infeed is not None:      # spin-up wait is not steady state
                infeed.total_wait_s = 0.0
                infeed.batches = 0
            t0 = time.time()
        else:
            imgs += global_batch
        if i % 10 == 0 or i == steps - 1:
            print(f"[p{runtime.process_id}] step {i}: "
                  f"loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)
    if cuda:
        torch.cuda.synchronize()
    dt = time.time() - t0
    out = {"losses": [float(v) for v in losses],
           "final_loss": float(metrics["loss"]),
           "process_id": runtime.process_id,
           "global_batch": global_batch, "image_size": image_size,
           "model": "resnet50" if image_size >= 128 else "tiny"}
    if runtime.is_chief and imgs:
        out["images_per_s"] = imgs / dt
        print(f"throughput: {imgs / dt:,.1f} images/sec "
              f"({runtime.num_processes} processes, "
              f"{runtime.num_processes} devices)", flush=True)
        if infeed is not None:
            frac = infeed.wait_fraction(dt)
            out["infeed_wait_frac"] = frac
            print(f"infeed wait: {infeed.total_wait_s * 1e3:.1f} ms over "
                  f"{infeed.batches} steps = {frac:.1%} of wall time "
                  f"({'host-bound' if frac >= 0.05 else 'device-bound'})",
                  flush=True)
    if infeed is not None:
        infeed.stop()
    if runtime.is_chief:
        torch_entry.write_report(out)
    if owned:
        bootstrap.shutdown()
    return out


def worker_main(steps: int, global_batch: int, image_size: int,
                data_dir: str | None = None, device: str = "cuda"):
    """One worker process (JAX's ``worker_main``); returns its final
    loss."""
    return train(steps, global_batch, image_size, data_dir,
                 device)["final_loss"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=32,
                    help="32 = tiny config for CPU demo; 224 = ResNet-50")
    ap.add_argument("--data-dir", default=None,
                    help="directory of img_*_cls<label>.jpg files; train "
                         "on REAL decoded JPEGs through the parallel "
                         "host pipeline")
    ap.add_argument("--gen-jpegs", type=int, default=0,
                    help="generate N JPEGs on disk first and train from "
                         "them (implies the real-data path)")
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N local worker processes with TF_CONFIG "
                         "(multi-worker demo on one box)")
    torch_entry.add_device_flag(ap)
    return ap


def run(args, batch=None, params=None, batch_stats=None):
    """The script's run: the data directory (``--gen-jpegs`` writes
    one), then one worker in this process or ``--spawn`` workers.
    Returns the worker's results (``--spawn``: the final losses)."""
    torch_entry.check_device(args.device, PROG)
    data_dir = args.data_dir
    if args.gen_jpegs:
        import tempfile

        from distributed_tensorflow_tpu_torch.input.image_ops import (
            generate_jpeg_directory)
        num_classes = 1000 if args.image_size >= 128 else 10
        data_dir = tempfile.mkdtemp(prefix="dtx_jpegs_")
        # sources ~25% larger than the train crop (RandomCrop headroom)
        generate_jpeg_directory(data_dir, args.gen_jpegs,
                                image_size=args.image_size * 5 // 4,
                                num_classes=num_classes)
        print(f"generated {args.gen_jpegs} JPEGs in {data_dir}",
              flush=True)

    if args.spawn > 1:
        from distributed_tensorflow_tpu_torch.testing import (
            multi_process_runner as mpr)
        runner = mpr.MultiProcessRunner(
            torch_entry.worker(PROG, "worker_main"),
            mpr.create_cluster_spec(num_workers=args.spawn),
            args=(args.steps, args.global_batch, args.image_size,
                  data_dir, args.device),
            device=args.device, timeout=900)
        try:
            result = runner.start().join()
        finally:
            runner.terminate_all()
        losses = result.return_values
        print(f"all {len(losses)} workers done; final losses {losses}")
        assert len(set(round(x, 5) for x in losses)) == 1, \
            "sync DP must keep workers bit-identical"
        return {"final_losses": losses}
    return train(args.steps, args.global_batch, args.image_size, data_dir,
                 args.device, batch=batch, params=params,
                 batch_stats=batch_stats)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Rank functions for the port's data-parallel ResNet test.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU.
"""

import numpy as np
import torch

from torch_dp_ranks import _init


def resnet_dp_rank(axes: dict, params: dict, stats: dict, batch: dict,
                   steps: int) -> dict:
    """``steps`` of ``resnet.make_sharded_train_step`` on ``axes`` from
    the flax ``params``/``batch_stats``: the losses, accuracies and the
    final variables (flax layout), then the same with every BatchNorm's
    sync removed (per-replica statistics, the control)."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import resnet
    _init()
    mesh = topology.make_mesh(axes, device="cpu")
    cfg = resnet.ResNetConfig.tiny()
    out = {"rank": dist.get_rank()}
    for name, sync in (("synced", True), ("per_replica", False)):
        state, step = resnet.make_sharded_train_step(
            cfg, mesh, batch["label"].shape[0], params=params,
            batch_stats=stats)
        if not sync:
            state["model"].set_stats_sync(None)
        losses, accs = [], []
        for _ in range(steps):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        out[name] = {"losses": losses, "accuracy": accs,
                     **resnet.flax_variables(state["model"])}
    return out

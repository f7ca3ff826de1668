"""Rank functions for the port's tensor-parallel Wide&Deep test.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU.
"""

import numpy as np
import torch

from torch_dp_ranks import _init


def wide_deep_rank(cases: list, batches: dict) -> dict:
    """Each ``(name, kind, axes, config kwargs, init)`` case trained on
    ``batches[name]`` (every rank's copy of the global batches): ``kind``
    "flax" (``make_sharded_train_step`` from the flax params ``init``)
    or "emb" (``make_embedding_train_step`` from JAX's ``{"dense":
    {"params"}, "emb"}`` state ``init``). Returns the losses, the full
    parameters (tables gathered over ``tp``) and the local table
    shapes."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import wide_deep as tw
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        all_gather)
    _init()
    out = {"rank": dist.get_rank()}
    meshes = {}
    for name, kind, axes, cfg_kw, init in cases:
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = topology.make_mesh(axes, device="cpu")
        mesh = meshes[key]
        cfg = tw.WideDeepConfig.tiny(**cfg_kw)
        gb = batches[name][0]["label"].shape[0]
        if kind == "flax":
            state, step = tw.make_sharded_train_step(cfg, mesh, gb,
                                                     params=init)
        else:
            state, step = tw.make_embedding_train_step(
                cfg, mesh, gb, dense_params=init["dense"]["params"],
                emb_state=init["emb"])
        losses = []
        for b in batches[name]:
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            losses.append(float(m["loss"]))
        if kind == "flax":
            model = state["model"]
            res = {"params": tw.gather_params(model, mesh),
                   "local": {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}
        else:
            emb = state["emb"]

            def full(t):
                if "tp" not in axes:
                    return t.numpy().copy()
                return all_gather(t.contiguous(), mesh, "tp").numpy().copy()
            res = {"dense": tw.flax_params(state["dense"]["model"]),
                   "tables": {k: full(v) for k, v in emb["tables"].items()},
                   "slots": {k: {s: full(a) for s, a in v.items()}
                             for k, v in emb["slots"].items()},
                   "local": {k: tuple(v.shape)
                             for k, v in emb["tables"].items()}}
        out[name] = {"losses": losses, **res}
    return out

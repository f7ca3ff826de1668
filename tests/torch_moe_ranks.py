"""Rank functions for the port's MoE and fully-sharded training tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Every function initialises the process group, runs a
batch of cases and returns numpy arrays, which the test files hold
against the JAX package and the single-device step.
"""

import numpy as np
import torch

from torch_dp_ranks import _init, _params_from_np
from torch_tp_ranks import _flat_full, _run


def dropped_rows(model, tokens: torch.Tensor, rows=slice(None),
                 cols=slice(None)) -> np.ndarray:
    """``(L, rows, cols)``: which of ``tokens[rows, cols]`` each MoE layer
    dropped (kept in no pass), from one forward without gradients (every
    rank of a mesh runs it together)."""
    from distributed_tensorflow_tpu_torch.parallel import moe
    with torch.no_grad(), moe.routing_log() as log:
        model(tokens[rows][:, cols])
    return np.stack([entry["dropped"].numpy() for entry in log])


def train_rank(cases: list, tokens: np.ndarray, steps: int) -> dict:
    """``cases``: ``(name, axes, config kwargs, step kwargs, init)``, each
    run ``steps`` steps from the full parameters ``init`` on ``tokens``;
    returns each case's losses, gathered parameters, local shapes, and
    (a MoE config) the dropped rows of its rows and ``sp`` chunk at the
    init, with this rank's data shard and chunk."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, _data_rows, gather_params,
        make_sharded_train_step)
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    _init()
    tok = torch.from_numpy(tokens)
    out = {"rank": dist.get_rank()}
    for name, axes, cfg_kw, kw, init in cases:
        mesh = topology.make_mesh(axes, device="cpu")
        cfg = TransformerConfig.tiny(**cfg_kw)
        state, step = make_sharded_train_step(
            cfg, mesh, tokens.shape[0], params=_params_from_np(cfg, init),
            **kw)
        model = state["model"]
        case = {"data_index": topology.data_shard_index(mesh),
                "sp_index": topology.sp_index(mesh),
                "local_shapes": {k: tuple(v.shape) for k, v in _flat_full(
                    model.stacked_params()).items()}}
        if cfg.moe_experts > 0:
            sp = model.sp
            case["dropped"] = dropped_rows(
                model, tok, _data_rows(mesh, tokens.shape[0]),
                sp.chunk(tokens.shape[1]) if sp else slice(None))
        gathers = (C.FsdpGather.calls, C.FsdpGather.scatters)
        state, losses = _run(step, state, tok, steps)
        case["fsdp_gathers"] = C.FsdpGather.calls - gathers[0]
        case["fsdp_scatters"] = C.FsdpGather.scatters - gathers[1]
        case["losses"] = losses
        case["params"] = _flat_full(gather_params(
            cfg, model.stacked_params(), mesh))
        if hasattr(step, "partition"):
            case["summary"] = step.partition.summary()
        out[name] = case
    return out


def shards_rank(cases: list) -> dict:
    """For each ``(name, axes, config kwargs)``: the full parameters (seed
    7) to this rank's shards (:func:`shard_params`) and back
    (:func:`gather_params`), bitwise, and the shards' shapes and
    contiguity."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, gather_params, init_params, shard_params)
    _init()
    out = {}
    for name, axes, cfg_kw in cases:
        mesh = topology.make_mesh(axes, device="cpu")
        cfg = TransformerConfig.tiny(**cfg_kw)
        full = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        shards = shard_params(cfg, full, mesh)
        back = gather_params(cfg, shards, mesh)
        out[name] = {
            "round_trip": all(np.array_equal(a, b) for a, b in zip(
                _flat_full(full).values(), _flat_full(back).values())),
            "shapes": {k: v.shape for k, v in _flat_full(shards).items()},
            "contiguous": all(t.is_contiguous() for t in
                              torch.utils._pytree.tree_leaves(shards))}
    return out


def jobs_rank(jobs: list) -> dict:
    """Each ``(key, function name, args)`` in turn in one spawn: a
    function of this module or of ``torch_tp_ranks`` (the group is
    initialised once)."""
    import torch_tp_ranks
    return {key: (globals().get(fn) or getattr(torch_tp_ranks, fn))(*args)
            for key, fn, args in jobs}


def fsdp_gather_rank() -> dict:
    """``fsdp_gather`` of this rank's two rows of an ``(8, 3)`` weight over
    a ``{"fsdp": 4}`` mesh, the whole weighted by ``rank + 1``."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    _init()
    mesh = topology.make_mesh({"fsdp": 4}, device="cpu")
    rank = dist.get_rank()
    whole = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    shard = whole[2 * rank:2 * rank + 2].clone().requires_grad_(True)
    counts = (C.FsdpGather.calls, C.FsdpGather.scatters)
    y = C.fsdp_gather(shard, torch.float32, mesh.get_group("fsdp"), 0)
    (y * (rank + 1)).sum().backward()
    return {"y": y.detach().numpy(), "grad": shard.grad.numpy(),
            "calls": C.FsdpGather.calls - counts[0],
            "scatters": C.FsdpGather.scatters - counts[1]}

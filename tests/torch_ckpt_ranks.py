"""Rank functions for the port's checkpointing and mesh-repair tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Every function initialises the process group, runs its
cases and returns numpy arrays and plain values, which the test files
hold against the JAX package or against one process.
"""

import os

import numpy as np
import torch

from torch_dp_ranks import _init, _params_from_np


def _refused(fn):
    try:
        fn()
    except Exception as e:                 # the type is what is compared
        return type(e).__name__, str(e)
    return None


def mesh_repair_rank(sharded: list, tokens: np.ndarray, steps: int,
                     pipelined: list, pp_init: dict,
                     refusals: list) -> dict:
    """C-4(c), (d) and (b) on 4 ranks: ``sharded`` — ``(name, axes,
    init)`` of ``make_sharded_train_step`` (``tiny()``); ``pipelined`` —
    ``(name, axes, schedule)`` of ``make_pipelined_train_step``
    (``tiny(n_layers=4)`` from ``pp_init``, 8 rows in 4 microbatches);
    ``refusals`` — ``(axes, config kwargs, sequence length)`` each built
    and stepped once on a batch of 4 rows."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_sharded_train_step)
    import torch_pp_ranks
    import torch_tp_ranks
    out = torch_tp_ranks.train_rank(
        [(name, axes, {}, {}, init) for name, axes, init in sharded],
        tokens, steps, [])
    for name, axes, schedule in pipelined:
        mesh = topology.make_mesh(axes, device="cpu")
        run = torch_pp_ranks._train(mesh, pp_init, tokens, steps, schedule,
                                    {})
        out[name] = {"losses": run["losses"], "params": run["params"]}

    def build_and_step(axes, cfg_kw, seq):
        cfg = TransformerConfig.tiny(**cfg_kw)
        state, step = make_sharded_train_step(
            cfg, topology.make_mesh(axes, device="cpu"), 4)
        step(state, {"tokens": torch.from_numpy(tokens[:4, :seq].copy())})

    out["refusals"] = [_refused(lambda: build_and_step(*r))
                       for r in refusals]
    return out


def _flat_full(params) -> dict:
    out = {"embed": params["embed"],
           "final_norm/scale": params["final_norm"]["scale"]}
    for g, leaves in params["layers"].items():
        for n, t in leaves.items():
            out[f"layers/{g}/{n}"] = t
    return {k: v.detach().float().numpy().copy() for k, v in out.items()}


def _full_state(cfg, state, mesh) -> dict:
    """Every leaf of ``train_state_variables`` as its global value."""
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        _flatten)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        train_state_variables)
    flat = _flatten(train_state_variables(cfg, state, mesh))
    return {k: v.read_value().float().numpy().copy() for k, v in flat.items()}


def _coordination(agent, rank: int, world: int) -> dict:
    """The agent over the process group's store: write-once keys, the
    directory listing, increments, a barrier one rank misses, a get that
    times out, a directory delete."""
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        BarrierTimeoutError, CoordinationError)
    out = {"distributed": agent.is_distributed,
           "ids": (agent.process_id, agent.num_processes)}
    try:
        agent.key_value_set("once/k", f"r{rank}", allow_overwrite=False)
        out["once"] = True
    except CoordinationError:
        out["once"] = False
    agent.key_value_set(f"dir/r{rank}", str(rank))
    agent.key_value_set(f"dir/r{rank}", str(rank * 10))   # overwrite
    out["inc"] = agent.key_value_increment("ctr", rank + 1)
    agent.barrier("after_writes", timeout_s=60)
    out["once_value"] = agent.key_value_get("once/k").decode()
    out["dir"] = [(k, v.decode()) for k, v in agent.key_value_dir_get("dir/")]
    out["ctr"] = int(agent.key_value_get("ctr"))
    try:
        agent.key_value_get("never", timeout_s=0.3)
        out["get_timeout"] = None
    except CoordinationError as e:
        out["get_timeout"] = type(e).__name__
    out["missing"] = agent.key_value_try_get("never")
    if rank != world - 1:
        try:
            agent.barrier("partial", timeout_s=1.0)
            out["partial"] = None
        except BarrierTimeoutError as e:
            out["partial"] = str(e)
    agent.barrier("after_partial", timeout_s=60)
    if rank == 0:
        agent.key_value_delete("dir")
    agent.barrier("after_delete", timeout_s=60)
    out["dir_after_delete"] = agent.key_value_dir_get("dir/")
    agent.barrier("coordination_done", timeout_s=60)
    return out


def _values(rank: int, workdir: str) -> dict:
    """``parallel/values.py`` on 4 ranks: a ``SyncOnReadVariable`` a
    replica row over ``{"dp": 4}`` read with each aggregation; a
    variable cut by ``("tp", None)`` over ``{"dp": 2, "tp": 2}`` (5 rows,
    padded to 6) gathered and assigned; both and a ``MirroredVariable``
    checkpointed there and restored onto ``{"tp": 4}`` variables."""
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint)
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel.values import (
        DistributedVariable, MirroredVariable, SyncOnReadVariable,
        VariableAggregation, scatter_dims)
    rows = torch.arange(12.0).reshape(4, 3) - 5.0
    dp4 = topology.make_mesh({"dp": 4}, device="cpu")
    out = {}
    for agg in ("sum", "mean", "only_first_replica"):
        v = SyncOnReadVariable(rows[rank:rank + 1].clone(), mesh=dp4,
                               aggregation=VariableAggregation(agg))
        out[agg] = v.read_value().numpy()
    full = torch.arange(40.0).reshape(5, 8)
    a = topology.make_mesh({"dp": 2, "tp": 2}, device="cpu")
    cut = DistributedVariable(scatter_dims(full, a, ("tp", None)).clone(),
                              mesh=a, spec=("tp", None), shape=(5, 8))
    out["local_shape"] = tuple(cut.value.shape)
    out["gathered"] = cut.read_value().numpy()
    cut.assign(full * 2)
    out["assigned"] = cut.read_value().numpy()
    on_read = SyncOnReadVariable(rows[rank:rank + 1].clone(), mesh=dp4)
    path = Checkpoint(cut=cut, on_read=on_read,
                      mirrored=MirroredVariable(torch.ones(3) * 7)).save(
        os.path.join(workdir, "values", "ck"))
    b = topology.make_mesh({"tp": 4}, device="cpu")
    cut_b = DistributedVariable(torch.zeros(2, 8), mesh=b, spec=("tp", None),
                                shape=(5, 8))
    on_read_b = SyncOnReadVariable(torch.zeros(1, 3), mesh=dp4)
    mirrored_b = MirroredVariable(torch.zeros(3))
    Checkpoint(cut=cut_b, on_read=on_read_b, mirrored=mirrored_b).restore(
        path)
    out["restored"] = {"cut": cut_b.read_value().numpy(),
                       "on_read": on_read_b.read_value().numpy(),
                       "mirrored": mirrored_b.read_value().numpy()}
    return out


def ckpt_mesh_rank(init: dict, tokens: np.ndarray, workdir: str) -> dict:
    """On 4 ranks: the coordination agent over the store; a ``{"dp": 2,
    "tp": 2}`` train state saved after 2 steps, restored onto ``{"tp":
    4}`` and stepped on, saved there and restored back onto dp2×tp2; the
    restore ladder with a ``SnapshotStore`` a rank (ring replication over
    the KV), after rank 1's memory is wiped."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.checkpoint import (
        peer_snapshot as ps)
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_sharded_train_step, train_state_variables)
    _init()
    rank, world = dist.get_rank(), dist.get_world_size()
    agent = coordination_service()
    out = {"rank": rank, "coord": _coordination(agent, rank, world),
           "values": _values(rank, workdir)}
    cfg = TransformerConfig.tiny()
    tok = torch.from_numpy(tokens)
    gb = tokens.shape[0]

    def build(axes, seed_params):
        mesh = topology.make_mesh(axes, device="cpu")
        state, step = make_sharded_train_step(
            cfg, mesh, gb, params=_params_from_np(cfg, seed_params))
        return mesh, state, step

    def manager(state, mesh, d, **kw):
        ckpt = Checkpoint(**train_state_variables(cfg, state, mesh),
                          step=np.int64(state["step"]))
        return ckpt, CheckpointManager(ckpt, os.path.join(workdir, d), **kw)

    zeros = {k: np.zeros_like(v) for k, v in init.items()}
    mesh_a, state, step = build({"dp": 2, "tp": 2}, init)
    for _ in range(2):
        state, _m = step(state, {"tokens": tok})
    ckpt, mgr = manager(state, mesh_a, "a")
    mgr.save(2)
    out["saved"] = _full_state(cfg, state, mesh_a)
    state, m = step(state, {"tokens": tok})
    out["loss_a"] = float(m["loss"])

    mesh_b, state_b, step_b = build({"tp": 4}, zeros)
    ckpt_b, mgr_b = manager(state_b, mesh_b, "a")
    tier, n, flat = mgr_b.restore_latest()
    state_b["step"] = int(flat["step"])
    out["restored_b"] = (tier, n, _full_state(cfg, state_b, mesh_b))
    state_b, m = step_b(state_b, {"tokens": tok})
    out["loss_b"] = float(m["loss"])
    _ckpt, mgr_b2 = manager(state_b, mesh_b, "b")
    mgr_b2.save(3)
    out["saved_b"] = _full_state(cfg, state_b, mesh_b)

    mesh_c, state_c, _step = build({"dp": 2, "tp": 2}, zeros)
    _ckpt, mgr_c = manager(state_c, mesh_c, "b")
    mgr_c.restore_latest()
    out["restored_c"] = _full_state(cfg, state_c, mesh_c)

    # the ladder: local + durable disk tiers and ring-replicated memory
    mem = os.path.join(workdir, "mem", f"w{rank}")
    ckpt_l, mgr_l = manager(state_b, mesh_b, "ladder_durable",
                            local_dir=os.path.join(workdir, "ladder_local"),
                            snapshot_store=ps.SnapshotStore(mem))
    mgr_l.save(4, async_write=False)
    mgr_l.snapshot(5)
    agent.barrier("snapshots_taken", timeout_s=60)
    if rank == 1:
        ps.wipe_memdir(mem)                 # this machine's RAM is gone
    agent.barrier("wiped", timeout_s=60)
    store = ps.SnapshotStore(mem)
    mesh_d, state_d, _step = build({"tp": 4}, zeros)
    _ckpt, mgr_d = manager(state_d, mesh_d, "ladder_durable",
                           local_dir=os.path.join(workdir, "ladder_local"),
                           snapshot_store=store)
    store.load_surviving()
    out["inventory"] = store.inventory()
    res = mgr_d.restore_latest()
    out["ladder"] = {"tier": res[0], "step": res[1],
                     **{k: mgr_d.last_restore[k]
                        for k in ("available", "best_available")}}
    out["ladder_state"] = _full_state(cfg, state_d, mesh_d)
    agent.barrier("done", timeout_s=60)
    return out

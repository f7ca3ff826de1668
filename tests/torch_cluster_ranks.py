"""Rank functions for the port's cluster-slice parity tests: the
all-reduce algorithms, ``MultiWorkerMirroredStrategy`` from
``TF_CONFIG``, the sharded variable, remote dispatch and
``train_and_evaluate``.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name; each task runs on gloo on
the CPU.
"""

import os
import time

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def all_reduce_rank(contribs: dict, algorithms) -> dict:
    """Every algorithm on each of ``contribs`` (name -> (n, ...) array,
    row r this rank's): the result, or the refusal's message."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.parallel import (
        all_reduce_algorithms as ar)
    bootstrap.initialize(device="cpu")
    r = dist.get_rank()
    out = {}
    for alg in algorithms:
        for name, c in contribs.items():
            try:
                out[(alg, name)] = _np(ar.all_reduce(
                    torch.from_numpy(c[r]), algorithm=alg))
            except ValueError as e:
                out[(alg, name)] = f"ValueError: {e}"
    bootstrap.shutdown()
    return out


def multi_worker_rank(x: np.ndarray, workdir: str) -> dict:
    """``MultiWorkerMirroredStrategy`` from ``TF_CONFIG`` alone: run,
    reduce and gather on ``x`` (one row a replica), then
    ``check_health``: True with every rank in, then False on rank 0
    within a 2 s timeout while rank 1 stays out (rank 1 enters after)."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.parallel.multi_worker import (
        MultiWorkerMirroredStrategy)
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        get_replica_context)
    from distributed_tensorflow_tpu_torch.parallel.values import PerReplica
    s = MultiWorkerMirroredStrategy(device="cpu")
    rank = dist.get_rank()
    R = s.num_replicas_in_sync
    px = PerReplica([x[i] for i in range(R)])

    def fn(v):
        ctx = get_replica_context()
        return {"y": v * 2.0 + 1.0, "sum": ctx.all_reduce("sum", v),
                "id": ctx.replica_id_in_sync_group}
    res = s.run(fn, args=(px,))
    out = {"rank": rank, "replicas": R, "task": (s.task_type, s.task_id),
           "resolver": s.cluster_resolver,
           "run/y": [_np(v) for v in res["y"].values],
           "run/sum": [_np(v) for v in res["sum"].values],
           "run/id": [_np(v) for v in res["id"].values],
           "gather": _np(s.gather(res["y"], axis=0))}
    for op in ("sum", "mean"):
        out[f"reduce/{op}"] = _np(s.reduce(op, res["y"], axis=None))
        out[f"reduce/{op}/axis0"] = _np(s.reduce(op, res["y"], axis=0))
    out["health/all_in"] = s.check_health(timeout_s=10.0)
    flag = os.path.join(workdir, "rank0_timed_out")
    if rank == 0:
        t0 = time.monotonic()
        out["health/held_back"] = s.check_health(timeout_s=2.0)
        out["health/seconds"] = time.monotonic() - t0
        open(flag, "w").close()
    else:
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.05)
        out["health/late"] = s.check_health(timeout_s=10.0)
    dist.barrier()
    return out


def ps_strategies_rank(table: np.ndarray, ids: np.ndarray,
                       new: np.ndarray, x: np.ndarray) -> dict:
    """Two ranks: a ``ShardedVariable`` over ``{"ps_shard": 2}`` (reads,
    assign, lookup, logical shards), ``ParameterServerStrategy`` V2 in
    the group, ``CentralStorageStrategy`` with a MEAN write inside
    ``run`` (``x``: one row a replica) and ``TPUStrategy`` with a model
    axis."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel.central_storage import (
        CentralStorageStrategy)
    from distributed_tensorflow_tpu_torch.parallel.parameter_server import (
        ParameterServerStrategy)
    from distributed_tensorflow_tpu_torch.parallel.sharded_variable import (
        FixedShardsPartitioner, ShardedVariable)
    from distributed_tensorflow_tpu_torch.parallel.tpu_strategy import (
        TPUStrategy)
    from distributed_tensorflow_tpu_torch.parallel.values import PerReplica
    bootstrap.initialize(device="cpu")
    out = {"rank": dist.get_rank()}
    mesh = topology.make_mesh({"ps_shard": 2}, device="cpu")
    v = ShardedVariable(table, mesh=mesh, shard_axis_name="ps_shard",
                        num_shards=3)
    out["sharded/local_rows"] = v.value.shape[0]
    out["sharded/read"] = _np(v.read_value())
    out["sharded/lookup"] = _np(v.embedding_lookup(ids))
    out["sharded/variables"] = v.variables
    v.assign(new)
    out["sharded/assigned"] = _np(v.read_value())
    out["sharded/lookup_after"] = _np(v.embedding_lookup(ids))

    ps = ParameterServerStrategy(
        variable_partitioner=FixedShardsPartitioner(3), device="cpu")
    with ps.scope():
        big = ps.create_variable(table)
        small = ps.create_variable(np.ones(3, np.float32))
    out["ps/kinds"] = (type(big).__name__, type(small).__name__,
                       big.num_shards)
    out["ps/read"] = _np(big.read_value())
    out["ps/variables"] = big.variables

    cs = CentralStorageStrategy(device="cpu")
    with cs.scope():
        w = cs.create_variable(np.zeros(4, np.float32))
    cs.run(lambda t: w.assign(t * 3.0),
           args=(PerReplica([x[i] for i in range(len(x))]),))
    out["central/device"] = str(w.device)
    out["central/value"] = _np(w.read_value())
    out["central/replicas"] = cs.num_replicas_in_sync

    tpu = TPUStrategy(model_axes={"tp": 2}, device="cpu")
    out["tpu/split"] = _np(tpu.split_to_logical_devices(
        torch.from_numpy(table), [2, 1]))
    try:
        tpu.split_to_logical_devices(torch.from_numpy(table), [2, 2])
        out["tpu/too_many"] = None
    except ValueError as e:
        out["tpu/too_many"] = str(e)
    dist.barrier()
    bootstrap.shutdown()
    return out


def _square(x):
    return x * x


def _slow_identity(x):
    time.sleep(0.4)
    return x


def _range_dataset():
    return iter(range(100, 1000, 100))


def _consume_next(it):
    return next(it)


def _counter():
    return {"n": 0}


def _bump(res):
    res["n"] += 1
    return res["n"]


def _raise(msg):
    raise KeyError(msg)


def _worker_device():
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import lane_device
    return str(lane_device())


def remote_dispatch_task(workdir: str, kill: bool) -> tuple:
    """Rank 0 is the coordinator, the others serve closures
    (``run_worker_loop``). ``kill``: slow closures while the parent
    kills worker 2; else remote results, worker-side datasets and
    resources, a remote error and the payload cap."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.coordinator import remote_dispatch
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import ClusterCoordinator
    rt = bootstrap.initialize(device="cpu")
    if rt.process_id != 0:
        if kill and rt.process_id == 2:
            open(os.path.join(workdir, "victim_ready"), "w").close()
        remote_dispatch.run_worker_loop()
        return ("worker-done", rt.process_id)
    coord = ClusterCoordinator(
        remote_worker_ids=list(range(1, rt.num_processes)))
    out = {}
    if kill:
        while not os.path.exists(os.path.join(workdir, "victim_ready")):
            time.sleep(0.1)
        rvs = [coord.schedule(_slow_identity, args=(i,)) for i in range(10)]
        open(os.path.join(workdir, "kill_now"), "w").close()
        coord.join(timeout=120)
        out["values"] = sorted(coord.fetch(rvs))
        out["retries"] = sum(w.failures for w in coord.cluster.workers)
    else:
        rvs = [coord.schedule(_square, args=(i,)) for i in range(10)]
        coord.join(timeout=120)
        out["values"] = sorted(coord.fetch(rvs))
        it = coord.create_per_worker_dataset(_range_dataset)
        out["handles"] = [type(h).__name__ for h in it.values]
        rvs = [coord.schedule(_consume_next, args=(it,)) for _ in range(4)]
        coord.join(timeout=120)
        out["dataset"] = sorted(coord.fetch(rvs))
        res = coord.create_per_worker_resource(_counter)
        rvs = [coord.schedule(_bump, args=(res,)) for _ in range(6)]
        coord.join(timeout=120)
        out["resource"] = sorted(coord.fetch(rvs))
        out["devices"] = coord.schedule(_worker_device).fetch(timeout=60)
        try:
            coord.schedule(_raise, args=("boom",)).fetch(timeout=60)
        except remote_dispatch.RemoteClosureError as e:
            out["error"] = "KeyError: 'boom'" in str(e)
        try:
            coord.join()
        except remote_dispatch.RemoteClosureError:
            pass
        try:
            coord.cluster.workers[0].lane.submit(
                _square, (np.zeros(2 << 20, np.float32),), {})
        except ValueError as e:
            out["cap"] = "payload" in str(e)
    coord.shutdown()
    return ("coordinator", out)


def train_and_evaluate_task(workdir: str) -> tuple:
    """JAX ``tests/test_multi_process.py:662-735`` on the port: the two
    trainers save rotating checkpoints 1..3 (``max_to_keep=2``) in the
    process group; the evaluator, outside it, evaluates each one with a
    ``SidecarEvaluator`` and writes summaries. The evaluator also reads
    a key the chief published, through its store client."""
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    from distributed_tensorflow_tpu_torch.coordinator.evaluator import (
        SidecarEvaluator, train_and_evaluate)
    final = 3

    def train_fn(ctx):
        import torch.distributed as dist
        rt = bootstrap.runtime()
        agent = coordination_service()
        if ctx.is_chief:
            agent.key_value_set("tne/chief", "hello")
        w = torch.zeros(())
        ckpt = Checkpoint(w=w)
        mgr = CheckpointManager(ckpt, workdir, checkpoint_name="tne",
                                max_to_keep=2)
        for step in range(1, final + 1):
            w = w + 1.0
            ckpt._objects["w"] = w
            agent.barrier(f"tne_step/{step}", timeout_s=120)
            mgr.save(checkpoint_number=step)
            time.sleep(0.3)            # a rotation window for the evaluator
        out = ("trainer", rt.process_id, dist.get_world_size())
        bootstrap.shutdown()
        return out

    def eval_fn(ctx):
        rt = bootstrap.runtime()
        seen = ctx.agent.key_value_get("tne/chief", timeout_s=60).decode()
        ckpt = Checkpoint(w=torch.zeros(()))
        ev = SidecarEvaluator(
            ckpt, workdir,
            lambda c, step: {"w": float(np.asarray(c._objects["w"]))},
            checkpoint_name="tne",
            summary_dir=os.path.join(workdir, "eval_logs"),
            poll_interval_s=0.1, final_step=final, idle_timeout_s=90)
        return ("evaluator", ev.run(), seen, rt.in_group,
                torch.distributed.is_initialized())

    return train_and_evaluate(train_fn, eval_fn, strategy=None,
                              device="cpu")

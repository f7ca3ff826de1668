"""Rank functions for the port's strategy-API parity tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name; each rank runs on gloo on
the CPU. :func:`strategy_checks` also runs in the test process itself
for one replica (no process group).
"""

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _per_replica(pr) -> list:
    return [_np(v) for v in pr.values]


def strategy_checks(strategy, x: np.ndarray, data: dict,
                    mnist_params: dict | None, global_batch: int,
                    steps: int) -> dict:
    """Every check of the strategy test on ``strategy``: ``x`` holds one
    row a replica (the ``PerReplica`` argument); ``data`` an MNIST-shaped
    dataset; ``mnist_params`` the JAX MNIST CNN's initial flax params
    (None: no ``compile_step`` run)."""
    from distributed_tensorflow_tpu_torch.input.dataset import Dataset
    from distributed_tensorflow_tpu_torch.parallel.strategy import (
        get_replica_context)
    from distributed_tensorflow_tpu_torch.parallel.values import (
        PerReplica, VariableAggregation, VariableSynchronization)
    R = strategy.num_replicas_in_sync
    out = {}
    px = PerReplica([x[i] for i in range(R)])

    # run outputs, reductions, gather
    def fn(v):
        ctx = get_replica_context()
        return {"y": v * 2.0 + 1.0,
                "id": ctx.replica_id_in_sync_group,
                "sum": ctx.all_reduce("sum", v),
                "mean": ctx.all_reduce("mean", v),
                "max": ctx.all_reduce("max", v),
                "gather": ctx.all_gather(v[None], axis=0),
                "merged": ctx.merge_call(
                    lambda s, t: s.extended.reduce_to("sum", t) + 1.0,
                    args=(v,))}
    res = strategy.run(fn, args=(px,))
    for k, pr in res.items():
        out[f"run/{k}"] = _per_replica(pr)
    for op in ("sum", "mean", "max", "min"):
        out[f"reduce/{op}"] = _np(strategy.reduce(op, res["y"], axis=None))
        out[f"reduce/{op}/axis0"] = _np(strategy.reduce(op, res["y"],
                                                        axis=0))
    out["gather"] = _np(strategy.gather(res["y"], axis=0))

    # variables: writes inside run, with each aggregation
    with strategy.scope():
        mean_v = strategy.create_variable(np.zeros(4, np.float32))
        sum_v = strategy.create_variable(
            np.ones(4, np.float32), aggregation=VariableAggregation.SUM)
        first_v = strategy.create_variable(
            np.zeros(4, np.float32),
            aggregation=VariableAggregation.ONLY_FIRST_REPLICA)
        read_sum = strategy.create_variable(
            np.zeros(4, np.float32),
            synchronization=VariableSynchronization.ON_READ,
            aggregation=VariableAggregation.SUM)
        read_mean = strategy.create_variable(
            np.ones(4, np.float32),
            synchronization=VariableSynchronization.ON_READ,
            aggregation=VariableAggregation.MEAN)

    def write(v):
        mean_v.assign(v * 3.0)
        sum_v.assign_add(v)
        first_v.assign(v - 1.0)
        read_sum.assign_add(v)
        read_mean.assign_sub(v * 0.5)
        return read_sum.read_value()
    for _ in range(2):
        local_reads = strategy.run(write, args=(px,))
    out["var/local_read"] = _per_replica(local_reads)
    for name, var in (("mean", mean_v), ("sum", sum_v), ("first", first_v),
                      ("on_read_sum", read_sum), ("on_read_mean",
                                                  read_mean)):
        out[f"var/{name}"] = _np(var.read_value())

    # values from a function
    vals = strategy.experimental_distribute_values_from_function(
        lambda ctx: np.full(3, ctx.replica_id_in_sync_group + 0.5,
                            np.float32))
    out["values_fn"] = _per_replica(strategy.run(lambda v: v * 2.0,
                                                 args=(vals,)))

    # the distributed dataset: this rank's rows of each global batch
    ds = Dataset.from_tensor_slices(data).batch(global_batch)
    it = iter(strategy.experimental_distribute_dataset(ds))
    first = next(it)
    out["dataset/image"] = _np(first["image"])
    out["dataset/label"] = _np(first["label"])

    if mnist_params is not None:
        from distributed_tensorflow_tpu_torch.models import mnist_cnn
        model = mnist_cnn.params_from_jax(mnist_params, device="cpu")
        tx = mnist_cnn.make_optimizer(model.parameters())
        state = strategy.replicate({"model": model, "optimizer": tx,
                                    "step": 0})
        step_fn = strategy.compile_step(mnist_cnn.make_train_step(model, tx))
        losses, accs = [], []
        it = iter(strategy.experimental_distribute_dataset(ds))
        for _ in range(steps):
            state, m = step_fn(state, next(it))
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
        out["mnist/losses"] = losses
        out["mnist/accuracy"] = accs
        out["mnist/params"] = mnist_cnn.flax_params(model)
        # a step that never steps its optimizer cannot be synchronised
        if R > 1:
            bad = strategy.compile_step(lambda st, b: (st, {}))
            try:
                bad(state, next(it))
                out["mnist/unsynced_raises"] = False
            except RuntimeError:
                out["mnist/unsynced_raises"] = True
    return out


def strategy_rank(x, data, mnist_params, global_batch, steps) -> dict:
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.parallel.mirrored import (
        MirroredStrategy)
    from torch_dp_ranks import _init
    torch.set_num_threads(1)
    _init()
    strategy = MirroredStrategy(devices=["cpu"])
    out = strategy_checks(strategy, x, data, mnist_params, global_batch,
                          steps)
    out["rank"] = dist.get_rank()
    out["replica_id"] = strategy.replica_id
    return out


def cross_device_rank(values: dict, meshes: list) -> dict:
    """:func:`cross_device_checks` on each mesh of ``meshes`` (one
    process group)."""
    import torch.distributed as dist
    from torch_dp_ranks import _init
    torch.set_num_threads(1)
    _init()
    return {"rank": dist.get_rank(),
            **{str(axes): cross_device_checks(values, axes)
               for axes in meshes}}


def cross_device_checks(values: dict, mesh_axes: dict) -> dict:
    """``IciAllReduce`` / ``ReductionToOneDevice`` / the hierarchical
    form on ``mesh_axes``: ``values`` maps a case to per-replica arrays
    (R, ...) of the reduced tensors (bf16 as uint16 bits)."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import cross_device_ops
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        CommunicationOptions)
    from distributed_tensorflow_tpu_torch.parallel.values import PerReplica
    mesh = topology.make_mesh(mesh_axes, device="cpu")
    axes = tuple(mesh_axes)
    out = {}

    def pr(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
            return PerReplica(list(t.unbind(0)))
        return PerReplica([a[i] for i in range(a.shape[0])])

    def res(m):
        v = m.values[0]
        if v.dtype == torch.bfloat16:
            return {"bf16": v.view(torch.int16).numpy()}
        return v.numpy()

    for bpp in (0, 24):
        opts = CommunicationOptions(bytes_per_pack=bpp)
        ops = cross_device_ops.IciAllReduce(mesh, axes, opts)
        for op in ("sum", "mean"):
            got = ops.batch_reduce(op, [pr(values[k])
                                        for k in sorted(values)])
            for k, m in zip(sorted(values), got):
                out[f"ici/{bpp}/{op}/{k}"] = res(m)
                out[f"ici/{bpp}/{op}/{k}/dtype"] = str(m.values[0].dtype)
        out[f"ici/{bpp}/reduce_sum"] = res(ops.reduce("sum", pr(values["f32"])))
    one = cross_device_ops.ReductionToOneDevice(mesh, axes)
    for op in ("sum", "mean", "max", "min"):
        out[f"one/{op}"] = res(one.reduce(op, pr(values["f32"])))
    if len(axes) == 2:
        h = cross_device_ops.HierarchicalAllReduce(mesh, axes)
        for op in ("sum", "mean"):
            out[f"hier/{op}"] = res(h.reduce(op, pr(values["f32"])))
        out["selected"] = type(cross_device_ops.select_cross_device_ops(
            mesh, axes)).__name__
    return out

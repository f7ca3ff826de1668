"""ParameterServerStrategy — asynchronous training with sharded
variables — port of ``distributed_tensorflow_tpu/parallel/
parameter_server.py`` (≙ the reference's ``parameter_server_strategy_v2.py:77``
``ParameterServerStrategyV2`` and ``parameter_server_strategy.py``, V1).

- **V2** (:class:`ParameterServerStrategy`): the variables the
  partitioner cuts are :class:`~distributed_tensorflow_tpu_torch.parallel.
  sharded_variable.ShardedVariable` s over the mesh's ``ps_shard`` dim
  (every rank of the process group; one shard with no group), the
  rest mirrored; the asynchrony lives in the
  :class:`~distributed_tensorflow_tpu_torch.coordinator.
  cluster_coordinator.ClusterCoordinator` that :meth:`make_coordinator`
  builds: remote lanes to the other ranks' worker loops in a process
  group, thread lanes on the visible cards in one process.
- **V1** (:class:`ParameterServerStrategyV1`): each variable whole on
  one parameter device, round-robin, an :class:`~distributed_tensorflow_
  tpu_torch.parallel.ps_values.AggregatingVariable` (host CPU by
  default).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.cluster.resolver import ClusterResolver
from distributed_tensorflow_tpu_torch.parallel.sharded_variable import (
    FixedShardsPartitioner,
    Partitioner,
    ShardedVariable,
)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy, resolve_device)
from distributed_tensorflow_tpu_torch.parallel.values import (
    VariableAggregation,
    VariableSynchronization,
)


class ParameterServerStrategy(Strategy):
    """Async PS training: sharded variables and coordinator-driven
    dispatch. ``variable_partitioner`` decides which variables are cut
    on axis 0 (≙ ``_create_variable``, parameter_server_strategy_v2.py:689);
    ``device`` is this rank's device (default its card)."""

    SHARD_AXIS = "ps_shard"

    def __init__(self, cluster_resolver: ClusterResolver | None = None,
                 variable_partitioner: Partitioner | None = None,
                 mesh=None, *, device=None):
        self._cluster_resolver = cluster_resolver
        if mesh is None and dist.is_initialized():
            kind = (resolve_device(device).type if device is not None
                    else "cuda")
            mesh = topo_lib.make_mesh(
                {topo_lib.DATA_AXIS: 1,
                 self.SHARD_AXIS: dist.get_world_size()}, device=kind)
        self.variable_partitioner = (variable_partitioner
                                     or FixedShardsPartitioner(1))
        super().__init__(mesh=mesh, data_axis_names=(topo_lib.DATA_AXIS,),
                         device=device)

    _world_mesh = False

    @property
    def cluster_resolver(self) -> ClusterResolver | None:
        return self._cluster_resolver

    def gradient_bucketer(self):
        # asynchronous: gradients apply through the coordinator, never
        # through a synchronous all-reduce
        return None

    def create_variable(self, value, *, name=None, trainable=True,
                        synchronization=VariableSynchronization.AUTO,
                        aggregation=VariableAggregation.NONE, dtype=None):
        """Cut large variables on axis 0, mirror the rest."""
        t = torch.as_tensor(value)
        if dtype is not None:
            t = t.to(dtype)
        parts = self.variable_partitioner(tuple(t.shape), t.dtype) \
            if t.dim() >= 1 else [1]
        if parts and parts[0] > 1:
            var = ShardedVariable(
                t, mesh=self.mesh, shard_axis_name=self.SHARD_AXIS,
                num_shards=parts[0], name=name, trainable=trainable,
                device=self.device)
            self._variables.append(var)
            return var
        return super().create_variable(
            t, name=name, trainable=trainable,
            synchronization=synchronization, aggregation=aggregation,
            dtype=dtype)

    def make_coordinator(self, **kwargs):
        """The :class:`~distributed_tensorflow_tpu_torch.coordinator.
        cluster_coordinator.ClusterCoordinator` of this strategy. In a
        process group its lanes are remote: every other rank, which runs
        ``remote_dispatch.run_worker_loop()``; in one process, thread
        lanes on the visible cards."""
        from distributed_tensorflow_tpu_torch.cluster.coordination import (
            coordination_service)
        from distributed_tensorflow_tpu_torch.coordinator \
            .cluster_coordinator import ClusterCoordinator
        agent = coordination_service()
        if agent.is_distributed and "remote_worker_ids" not in kwargs:
            kwargs["remote_worker_ids"] = [
                p for p in range(agent.num_processes)
                if p != agent.process_id]
        return ClusterCoordinator(strategy=self, **kwargs)


#: the V2 name of reference scripts
ParameterServerStrategyV2 = ParameterServerStrategy


class ParameterServerStrategyV1(Strategy):
    """The graph-era PS strategy (≙ parameter_server_strategy.py): each
    variable whole on one parameter device, round-robin (≙ :872), as an
    :class:`~distributed_tensorflow_tpu_torch.parallel.ps_values.
    AggregatingVariable`; ON_READ variables stay per-replica."""

    def __init__(self, mesh=None, parameter_devices: Sequence | None = None,
                 cluster_resolver: ClusterResolver | None = None, *,
                 device=None):
        super().__init__(mesh=mesh, data_axis_names=(topo_lib.DATA_AXIS,),
                         device=device)
        self._cluster_resolver = cluster_resolver
        if parameter_devices is None:
            from distributed_tensorflow_tpu_torch.parallel.ps_values import (
                _default_parameter_device)
            parameter_devices = [_default_parameter_device()]
        self._parameter_devices = [resolve_device(d)
                                   for d in parameter_devices]
        self._next_ps = 0

    @property
    def cluster_resolver(self) -> ClusterResolver | None:
        return self._cluster_resolver

    @property
    def parameter_devices(self) -> list:
        return list(self._parameter_devices)

    def create_variable(self, value, *, name=None, trainable=True,
                        synchronization=None, aggregation=None,
                        dtype=None):
        from distributed_tensorflow_tpu_torch.parallel.ps_values import (
            AggregatingVariable)
        if synchronization is VariableSynchronization.ON_READ:
            return super().create_variable(
                value, name=name, trainable=trainable,
                synchronization=synchronization,
                aggregation=aggregation or VariableAggregation.SUM,
                dtype=dtype)
        device = self._parameter_devices[
            self._next_ps % len(self._parameter_devices)]
        self._next_ps += 1
        var = AggregatingVariable(
            value, device=device, name=name, trainable=trainable,
            aggregation=aggregation or VariableAggregation.MEAN,
            dtype=dtype)
        self._variables.append(var)
        return var

"""MultiWorkerMirroredStrategy — synchronous data parallelism across
processes and hosts — port of ``distributed_tensorflow_tpu/parallel/
multi_worker.py`` (≙ the reference's ``collective_all_reduce_strategy.py:57``
``CollectiveAllReduceStrategy``).

What the reference's ``_initialize_multi_worker`` (:507) does — parse
``TF_CONFIG``, start the servers, build a collective group over every
worker — is :func:`~distributed_tensorflow_tpu_torch.cluster.bootstrap.
initialize` here: the cluster resolver (``TF_CONFIG`` by default) gives
the process group's store address, rank and world size. A replica is a
rank (one card each, ``cuda:LOCAL_RANK``), and the mesh spans every
rank (``{"dp": world}``, or the mesh given); the gradient sync is PR
18's bucketed all-reduce, NCCL's on the cards.

``check_health`` (≙ ``context.check_collective_ops_peer_health``,
context.py:1105) is a barrier on the coordination KV with a timeout,
its name taken from a cluster-wide counter, never a collective: a peer
that does not enter makes it return False within ``timeout_s``.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.cluster import bootstrap
from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.cluster.resolver import ClusterResolver
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    CommunicationOptions)
from distributed_tensorflow_tpu_torch.parallel.strategy import Strategy


class CollectiveAllReduceStrategy(Strategy):
    """Multi-worker sync data parallelism over every rank of the
    cluster. ``device`` is the ranks' device type when this strategy
    creates the process group ("cuda" by default); a group that exists
    already keeps its own."""

    def __init__(self, cluster_resolver: ClusterResolver | None = None,
                 communication_options: CommunicationOptions | None = None,
                 mesh=None, *, device="cuda"):
        self._runtime = bootstrap.initialize(cluster_resolver,
                                             device=device)
        if not self._runtime.in_group:
            raise ValueError(
                f"a {self._runtime.task_type!r} task is outside the "
                "process group and holds no replica")
        self._cluster_resolver = cluster_resolver
        dev = self._runtime.device
        if mesh is None:
            mesh = topo_lib.make_mesh(
                {topo_lib.DATA_AXIS: self._runtime.num_processes},
                device=dev.type)
        data_axes = topo_lib.data_axes(mesh) or (topo_lib.DATA_AXIS,)
        super().__init__(mesh=mesh, data_axis_names=data_axes,
                         communication_options=communication_options,
                         device=dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)

    @property
    def cluster_resolver(self) -> ClusterResolver | None:
        return self._cluster_resolver

    @property
    def task_type(self) -> str | None:
        return (getattr(self._cluster_resolver, "task_type", None)
                or self._runtime.task_type)

    @property
    def task_id(self) -> int | None:
        tid = getattr(self._cluster_resolver, "task_id", None)
        return tid if tid is not None else self._runtime.task_id

    def check_health(self, timeout_s: float = 30.0) -> bool:
        """True when every rank enters this round's barrier within
        ``timeout_s``, else False (JAX ``:66-93``). Every participant
        bumps one cluster-wide counter; the round is its value over the
        world size, so a missed round does not shift the names of later
        ones."""
        from distributed_tensorflow_tpu_torch.cluster.coordination import (
            coordination_service)
        agent = coordination_service()
        if not agent.is_distributed:
            return True
        try:
            n = agent.key_value_increment("dtx_health_check/seq", 1)
            round_id = (n - 1) // agent.num_processes
            agent.barrier(f"dtx_health_check/{round_id}",
                          timeout_s=timeout_s)
            return True
        except Exception:
            return False


class MultiWorkerMirroredStrategy(CollectiveAllReduceStrategy):
    """The user-facing name (``tf.distribute.MultiWorkerMirroredStrategy``)."""

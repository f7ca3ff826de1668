"""Legacy distribute coordinator — the Estimator-era orchestration entry
— port of ``distributed_tensorflow_tpu/coordinator/
distribute_coordinator.py`` (≙ the reference's
``distribute_coordinator.py``: ``run_distribute_coordinator`` :627,
``DistributeCoordinatorMode``, ``_WorkerContext``).

INDEPENDENT_WORKER creates the process group from the cluster
(``cluster/bootstrap.initialize``) for a chief or worker task; the
``evaluator`` task never joins it. STANDALONE_CLIENT runs locally.
Kept for ported ``train_and_evaluate`` scripts; new code uses a
``Strategy`` and ``Model.fit``.
"""

from __future__ import annotations

import enum
from typing import Callable

from distributed_tensorflow_tpu_torch.cluster import bootstrap
from distributed_tensorflow_tpu_torch.cluster.resolver import (
    ClusterSpec,
    SimpleClusterResolver,
    TFConfigClusterResolver,
)


class CoordinatorMode(enum.Enum):
    """≙ DistributeCoordinatorMode."""
    STANDALONE_CLIENT = "standalone_client"
    INDEPENDENT_WORKER = "independent_worker"


class WorkerContext:
    """What ``worker_fn`` receives (≙ _WorkerContext): cluster facts plus
    the strategy, already entered."""

    def __init__(self, strategy, cluster_spec: ClusterSpec,
                 task_type: str | None, task_id: int | None):
        self.strategy = strategy
        self.cluster_spec = cluster_spec
        self.task_type = task_type
        self.task_id = task_id
        #: the evaluator's KV client (``evaluator.train_and_evaluate``)
        self.agent = None

    @property
    def is_chief(self) -> bool:
        from distributed_tensorflow_tpu_torch.cluster.resolver import is_chief
        if not self.cluster_spec or self.task_type is None:
            return True
        return is_chief(self.cluster_spec, self.task_type,
                        self.task_id or 0)

    @property
    def distributed_mode(self) -> bool:
        return bool(self.cluster_spec)


def run_distribute_coordinator(
        worker_fn: Callable, strategy,
        mode: CoordinatorMode = CoordinatorMode.INDEPENDENT_WORKER,
        cluster_spec: ClusterSpec | dict | None = None,
        task_type: str | None = None, task_id: int | None = None, *,
        device="cuda"):
    """≙ run_distribute_coordinator (:627): resolve the cluster, connect
    the runtime, and run ``worker_fn(context)`` under the strategy scope.

    INDEPENDENT_WORKER: every task calls this with its own TF_CONFIG
    (or explicit spec) and the chief and worker tasks join one process
    group on ``device``. STANDALONE_CLIENT: run locally.
    """
    if isinstance(cluster_spec, dict):
        cluster_spec = ClusterSpec(cluster_spec)
    if cluster_spec is None:
        resolver = TFConfigClusterResolver()
        cluster_spec = resolver.cluster_spec()
        task_type = task_type or resolver.task_type
        task_id = task_id if task_id is not None else resolver.task_id
    else:
        resolver = SimpleClusterResolver(cluster_spec,
                                         task_type=task_type or "",
                                         task_id=task_id or 0)

    from distributed_tensorflow_tpu_torch.cluster.resolver import EVALUATOR
    if (mode is CoordinatorMode.INDEPENDENT_WORKER and cluster_spec
            and task_type != EVALUATOR):
        # The evaluator task is its own single-task world (≙ the
        # reference's "evaluator" special case :627): it must never join
        # the group, or the trainers' collectives would wait on it.
        bootstrap.initialize(resolver=resolver, device=device)

    ctx = WorkerContext(strategy, cluster_spec, task_type, task_id)
    if strategy is None:
        # strategy-less orchestration (the worker_fn builds its own
        # sharded programs, e.g. train_and_evaluate roles)
        return worker_fn(ctx)
    with strategy.scope():
        return worker_fn(ctx)

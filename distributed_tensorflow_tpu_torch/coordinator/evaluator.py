"""Sidecar evaluator task + ``train_and_evaluate`` orchestration — port
of ``distributed_tensorflow_tpu/coordinator/evaluator.py`` (≙ the
reference's ``distribute_coordinator.py:627`` evaluator orchestration
and the Keras ``SidecarEvaluator``).

The evaluator is a process OUTSIDE the process group: the trainers'
collectives never wait on it. It sees training progress through the
checkpoint directory, whose index-last commit protocol
(``checkpoint/checkpoint.py``, JAX's format) lets it observe only
complete checkpoints, and it reaches the coordination KV through a
client of the group's store (``cluster/bootstrap.py``): its
``WorkerContext.agent``.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Any, Callable

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    Checkpoint,
    CheckpointCorruptError,
    latest_checkpoint,
)

_log = logging.getLogger(__name__)


class SidecarEvaluator:
    """Continuously evaluate every new checkpoint in a directory.

    ``eval_fn(checkpoint, step) -> dict[str, float]`` runs after the
    checkpoint is restored in place; returned metrics are written as TB
    scalars to ``summary_dir`` (utils/summary.py — real event files).

    Stops when a checkpoint with number >= ``final_step`` has been
    evaluated (≙ the reference stopping at the final checkpoint), or
    after ``idle_timeout_s`` with nothing new (trainer died).

    ``evaluate_every_checkpoint=True`` walks EVERY unseen checkpoint in
    step order instead of only the latest — for evaluators slower than
    the trainer's rotation cadence that must not skip steps.
    """

    def __init__(self, checkpoint: Checkpoint, directory: str,
                 eval_fn: Callable[[Checkpoint, int], dict],
                 *, checkpoint_name: str = "ckpt",
                 summary_dir: str | None = None,
                 poll_interval_s: float = 0.5,
                 final_step: int | None = None,
                 idle_timeout_s: float = 120.0,
                 evaluate_every_checkpoint: bool = False):
        self._checkpoint = checkpoint
        self._directory = directory
        self._eval_fn = eval_fn
        self._name = checkpoint_name
        self._summary_dir = summary_dir
        self._poll_s = poll_interval_s
        self._final_step = final_step
        self._idle_timeout_s = idle_timeout_s
        self._eval_all = evaluate_every_checkpoint

    @staticmethod
    def _step_of(path: str) -> int:
        """Checkpoint number from a ``<name>-<number>`` path; raises on
        an unparseable name — a silent -1 would quietly disable the
        ``final_step`` stop condition and leave the loop exiting only
        via idle timeout."""
        m = re.search(r"-(\d+)$", path)
        if not m:
            raise ValueError(
                f"checkpoint path {path!r} does not end in "
                f"'-<number>'; cannot order it / match final_step")
        return int(m.group(1))

    def _pending_paths(self, seen: set) -> list:
        """Unseen checkpoints to evaluate, oldest first (or just the
        latest when evaluate_every_checkpoint=False)."""
        if not self._eval_all:
            path = latest_checkpoint(self._directory, self._name)
            return [path] if path is not None and path not in seen else []
        from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
            _INDEX_FILE)
        pat = re.compile(re.escape(self._name) + r"-(\d+)$")
        found = []
        try:
            names = os.listdir(self._directory)
        except OSError:
            return []
        for n in names:
            m = pat.match(n)
            full = os.path.join(self._directory, n)
            # the index file is the COMMIT MARKER (written last by
            # _commit): a dir without it is a checkpoint mid-write —
            # listing it would mark it seen and permanently skip it
            if (m and full not in seen
                    and os.path.exists(os.path.join(full, _INDEX_FILE))):
                found.append((int(m.group(1)), full))
        return [p for _, p in sorted(found)]

    def run(self) -> list[tuple[int, dict]]:
        """The evaluator loop; returns [(step, metrics), ...] evaluated."""
        writer = None
        if self._summary_dir is not None:
            from distributed_tensorflow_tpu_torch.utils.summary import (
                SummaryWriter)
            writer = SummaryWriter(self._summary_dir,
                                   filename_suffix=".eval")
        evaluated: list[tuple[int, dict]] = []
        seen: set[str] = set()
        deadline = time.monotonic() + self._idle_timeout_s
        try:
            while True:
                progressed = False
                for path in self._pending_paths(seen):
                    seen.add(path)
                    # paths come from the name-(\d+) pattern, so this
                    # cannot fail here; _step_of stays strict for any
                    # external caller (a silent -1 would disable the
                    # final_step stop)
                    step = self._step_of(path)
                    try:
                        self._checkpoint.restore_into(path)
                    except (OSError, KeyError, ValueError,
                            CheckpointCorruptError):
                        # rotation race or torn shard: the trainer swept
                        # (or half-wrote) this checkpoint — skip it, the
                        # next poll sees a newer one (tf_keras
                        # SidecarEvaluator tolerates this the same way)
                        _log.info(
                            "SidecarEvaluator: checkpoint %r vanished "
                            "mid-restore (rotation race); skipping",
                            path)
                        continue
                    metrics = self._eval_fn(self._checkpoint, step) or {}
                    if writer is not None:
                        writer.scalars(
                            {f"eval/{k}": float(v)
                             for k, v in metrics.items()}, step)
                        writer.flush()
                    evaluated.append((step, metrics))
                    progressed = True
                    deadline = time.monotonic() + self._idle_timeout_s
                    if (self._final_step is not None
                            and step >= self._final_step):
                        return evaluated
                if not progressed:
                    if time.monotonic() > deadline:
                        return evaluated      # trainer gone quiet: stop
                    time.sleep(self._poll_s)
        finally:
            if writer is not None:
                writer.close()


def train_and_evaluate(train_fn: Callable, eval_fn: Callable, strategy,
                       cluster_spec=None, task_type: str | None = None,
                       task_id: int | None = None, *,
                       device="cuda") -> Any:
    """Role dispatch for ported ``tf.estimator.train_and_evaluate``
    scripts (≙ distribute_coordinator.py:627 orchestration): every task
    calls this with its own TF_CONFIG; chief/worker tasks run
    ``train_fn(context)`` in the process group (on ``device``), the
    ``evaluator`` task runs ``eval_fn(context)`` outside it, with a
    client of the group's store for the KV (``context.agent``).

    Both callbacks receive a ``WorkerContext``; the evaluator's context
    has ``task_type == "evaluator"`` and typically constructs a
    :class:`SidecarEvaluator` over the shared checkpoint directory.
    """
    from distributed_tensorflow_tpu_torch.cluster.resolver import (
        ClusterSpec, EVALUATOR, SimpleClusterResolver,
        TFConfigClusterResolver)
    from distributed_tensorflow_tpu_torch.coordinator.distribute_coordinator \
        import WorkerContext, run_distribute_coordinator

    if isinstance(cluster_spec, dict):
        cluster_spec = ClusterSpec(cluster_spec)
    if cluster_spec is None:
        resolver = TFConfigClusterResolver()
        cluster_spec = resolver.cluster_spec()
        task_type = task_type or resolver.task_type
        task_id = task_id if task_id is not None else resolver.task_id

    if task_type == EVALUATOR:
        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        from distributed_tensorflow_tpu_torch.cluster.coordination import (
            coordination_service)
        if cluster_spec:
            bootstrap.initialize(SimpleClusterResolver(
                cluster_spec, task_type=task_type, task_id=task_id or 0),
                device=device)
        ctx = WorkerContext(strategy, cluster_spec, task_type, task_id)
        ctx.agent = coordination_service()
        return eval_fn(ctx)
    return run_distribute_coordinator(
        train_fn, strategy, cluster_spec=cluster_spec,
        task_type=task_type, task_id=task_id, device=device)

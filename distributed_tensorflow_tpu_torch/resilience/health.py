"""Per-worker health tracking with quarantine — port of
``distributed_tensorflow_tpu/resilience/health.py``, on the port's
metrics registry.

Feeds the coordinator's dispatch loop (coordinator/cluster_coordinator.py):
a lane whose worker keeps failing closures is quarantined — it stops
pulling work for ``quarantine_s`` so closures drain through healthy
lanes instead of ping-ponging off the same dying worker (≙ the
reference's wait_on_failure backoff keeping a failing worker out of
rotation, cluster_coordinator.py:879 — generalized to a policy).

Liveness guard: the tracker refuses to quarantine the LAST healthy
worker — with everyone else down, a flaky lane still beats no lane, and
the queue can never deadlock with work pending and all lanes benched.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from distributed_tensorflow_tpu_torch.telemetry import registry as _telemetry


@dataclasses.dataclass
class _WorkerHealth:
    consecutive_failures: int = 0
    total_failures: int = 0
    total_successes: int = 0
    quarantined_until: float | None = None
    quarantine_count: int = 0


class WorkerHealthTracker:
    """Failure bookkeeping for a set of workers.

    ``record_failure``/``record_success`` from dispatch; ``is_quarantined``
    gates pulling work. ``failure_threshold`` consecutive failures =>
    quarantined for ``quarantine_s`` (a success clears everything).
    """

    def __init__(self, failure_threshold: int = 3,
                 quarantine_s: float = 5.0,
                 time_fn=time.monotonic):
        self.failure_threshold = failure_threshold
        self.quarantine_s = quarantine_s
        self._now = time_fn
        self._lock = threading.Lock()
        self._workers: dict[int, _WorkerHealth] = {}
        # registry export: counters are process-cumulative (shared across
        # tracker instances); the per-worker detail rides a snapshot
        # collector (latest tracker wins — one live tracker per process)
        reg = _telemetry.get_registry()
        self._failures_total = reg.counter(
            "resilience/worker_failures_total")
        self._quarantines_total = reg.counter(
            "resilience/quarantines_total")
        reg.register_collector("resilience/health", self._collect)

    def _collect(self) -> dict:
        snap = self.snapshot()
        return {"healthy_workers": len(self.healthy_workers()),
                "quarantined_workers": sum(
                    1 for h in snap.values() if h["quarantined"])}

    def register(self, worker_id: int):
        with self._lock:
            self._workers.setdefault(worker_id, _WorkerHealth())

    def _healthy_ids_locked(self) -> list[int]:
        now = self._now()
        return [w for w, h in self._workers.items()
                if h.quarantined_until is None or h.quarantined_until <= now]

    def record_failure(self, worker_id: int) -> bool:
        """Returns True if this failure newly quarantined the worker."""
        self._failures_total.increment()
        with self._lock:
            h = self._workers.setdefault(worker_id, _WorkerHealth())
            h.consecutive_failures += 1
            h.total_failures += 1
            if h.consecutive_failures < self.failure_threshold:
                return False
            healthy = self._healthy_ids_locked()
            if healthy == [worker_id]:
                return False          # never bench the last healthy lane
            h.quarantined_until = self._now() + self.quarantine_s
            h.quarantine_count += 1
            h.consecutive_failures = 0
        self._quarantines_total.increment()
        return True

    def record_success(self, worker_id: int):
        with self._lock:
            h = self._workers.setdefault(worker_id, _WorkerHealth())
            h.consecutive_failures = 0
            h.total_successes += 1
            h.quarantined_until = None

    def worker_restarted(self, worker_id: int):
        """Supervisor-confirmed restart (a new cluster generation): the
        process behind this lane is fresh, so the quarantine and the
        consecutive-failure streak no longer describe it — clear both.
        Lifetime totals (``total_failures``, ``quarantine_count``) are
        kept: they describe the lane's history, not its current
        incarnation."""
        with self._lock:
            h = self._workers.setdefault(worker_id, _WorkerHealth())
            h.consecutive_failures = 0
            h.quarantined_until = None

    def is_quarantined(self, worker_id: int) -> bool:
        with self._lock:
            h = self._workers.get(worker_id)
            if h is None or h.quarantined_until is None:
                return False
            if h.quarantined_until <= self._now():
                h.quarantined_until = None     # quarantine expired
                return False
            return True

    def is_healthy(self, worker_id: int) -> bool:
        return not self.is_quarantined(worker_id)

    def healthy_workers(self) -> list[int]:
        with self._lock:
            return sorted(self._healthy_ids_locked())

    def snapshot(self) -> dict[int, dict]:
        """Introspection / metrics export."""
        with self._lock:
            now = self._now()
            return {
                w: {"consecutive_failures": h.consecutive_failures,
                    "total_failures": h.total_failures,
                    "total_successes": h.total_successes,
                    "quarantine_count": h.quarantine_count,
                    "quarantined": (h.quarantined_until is not None
                                    and h.quarantined_until > now)}
                for w, h in self._workers.items()}

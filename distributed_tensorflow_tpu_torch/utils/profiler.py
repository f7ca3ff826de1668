"""Input-pipeline stage counters — port of the input-pipeline half of
``distributed_tensorflow_tpu/utils/profiler.py`` (JAX ``:297-417``).

Every concurrent stage (``Dataset.map`` with ``num_parallel_calls``,
``interleave``, ``prefetch``, the distributed iterator's device copy,
``training/loops.py InfeedLoop``) keeps a :class:`StageStats`: elements,
and four wait channels that say WHO blocks WHOM:

- ``busy_s``          the stage's own work (map fn, decode, upstream
                      ``next()`` for prefetch)
- ``producer_wait_s`` blocked pulling from upstream (upstream is the
                      bottleneck)
- ``blocked_put_s``   blocked handing off downstream (a full bounded
                      queue: downstream is the bottleneck)
- ``consumer_wait_s`` the consumer blocked on this stage (this stage is
                      the bottleneck)

Stages register weakly (:func:`register_stage`); :func:`pipeline_stats`
snapshots the live ones, :func:`bottleneck_stage` names the one its
consumer waited on longest, and the registry collector ``input/
pipeline`` exports them through ``telemetry.get_registry()``.
"""

from __future__ import annotations

import threading
import time
import weakref

_stage_registry: "list[weakref.ref]" = []
_stage_lock = threading.Lock()


class StageStats:
    """Thread-safe counters for one concurrent pipeline stage."""

    def __init__(self, name: str, *, workers: int | None = None,
                 register: bool = True):
        self.name = name
        self.workers = workers
        self._lock = threading.Lock()
        self._elements = 0
        self._busy_s = 0.0
        self._producer_wait_s = 0.0
        self._blocked_put_s = 0.0
        self._consumer_wait_s = 0.0
        self._queue_depth_sum = 0
        self._queue_samples = 0
        self._first_t: float | None = None
        self._last_t: float | None = None
        if register:
            register_stage(self)

    def record(self, *, elements: int = 0, busy_s: float = 0.0,
               producer_wait_s: float = 0.0, blocked_put_s: float = 0.0,
               consumer_wait_s: float = 0.0,
               queue_depth: int | None = None) -> None:
        now = time.monotonic()
        with self._lock:
            if self._first_t is None:
                self._first_t = now
            self._last_t = now
            self._elements += elements
            self._busy_s += busy_s
            self._producer_wait_s += producer_wait_s
            self._blocked_put_s += blocked_put_s
            self._consumer_wait_s += consumer_wait_s
            if queue_depth is not None:
                self._queue_depth_sum += queue_depth
                self._queue_samples += 1

    def snapshot(self) -> dict:
        with self._lock:
            wall = ((self._last_t - self._first_t)
                    if self._first_t is not None else 0.0)
            return {
                "name": self.name,
                "workers": self.workers,
                "elements": self._elements,
                "busy_s": round(self._busy_s, 6),
                "producer_wait_s": round(self._producer_wait_s, 6),
                "blocked_put_s": round(self._blocked_put_s, 6),
                "consumer_wait_s": round(self._consumer_wait_s, 6),
                "mean_queue_depth": (
                    round(self._queue_depth_sum / self._queue_samples, 3)
                    if self._queue_samples else None),
                "elements_per_sec": (
                    round(self._elements / wall, 2) if wall > 0 else None),
            }


def register_stage(stats: StageStats) -> None:
    """Add a stage to the process-wide registry (weakly held: an
    abandoned pipeline's stages disappear with it)."""
    with _stage_lock:
        _stage_registry.append(weakref.ref(stats))


def pipeline_stats(prefix: str | None = None) -> "list[dict]":
    """Snapshots of every live registered stage, registration order;
    ``prefix`` filters on the stage name (e.g. ``"map"``)."""
    out = []
    with _stage_lock:
        live = []
        for ref in _stage_registry:
            s = ref()
            if s is not None:
                live.append(ref)
                if prefix is None or s.name.startswith(prefix):
                    out.append(s.snapshot())
        _stage_registry[:] = live
    return out


def clear_pipeline_stats() -> None:
    """Drop all registered stages (test isolation)."""
    with _stage_lock:
        _stage_registry.clear()


def bottleneck_stage() -> dict | None:
    """The stage its consumer waited on the longest (None when nothing
    is registered)."""
    snaps = pipeline_stats()
    if not snaps:
        return None
    return max(snaps, key=lambda s: s["consumer_wait_s"])


def _pipeline_collector() -> dict:
    out = {}
    for snap in pipeline_stats():
        stage = snap.get("name", "?")
        for k, v in snap.items():
            if k in ("name", "workers") or v is None:
                continue
            out[f"{stage}/{k}"] = v
    return out


def _register_telemetry_collector():
    from distributed_tensorflow_tpu_torch.telemetry import registry as _treg
    _treg.get_registry().register_collector("input/pipeline",
                                            _pipeline_collector)


_register_telemetry_collector()

"""Stall detection: no step completed within k x trailing median.

The port's copy of ``distributed_tensorflow_tpu/telemetry/stall.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

Layered on :class:`coordinator.watchdog.WatchDog`: the training driver
reports each completed step (:meth:`StallDetector.step_completed`); the
detector keeps a trailing window of step intervals and arms the
watchdog with ``factor`` x the median interval. If no step completes
within that budget the watchdog triggers and the detector emits a
structured ``stall.suspected`` event naming the suspect worker —
non-fatal (escalation rides the WatchDog ``on_triggered`` contract: a
raising callback never kills the watch loop, and training continues).

Suspect attribution, in order of evidence quality:

1. a dispatch lane currently blocked in ``RemoteLane.wait`` (the
   ``coordinator/dispatch/waiting/<wid>`` gauges set by
   remote_dispatch) — the worker the coordinator is literally waiting
   on right now;
2. from the last fleet rollup (aggregate.FleetAggregator): the worker
   with the fewest completed steps, else the stalest publisher.
"""

from __future__ import annotations

import collections
import statistics
import sys
import threading
import time

from distributed_tensorflow_tpu_torch.telemetry import events as _events
from distributed_tensorflow_tpu_torch.telemetry import registry as _registry

#: Gauge-name prefix remote_dispatch sets while a lane blocks on a
#: worker's result (value = monotonic time the wait started).
WAITING_GAUGE_PREFIX = "coordinator/dispatch/waiting/"


def suspect_worker(rollup: dict | None = None,
                   reg=None,
                   step_metric: str = "training/steps_completed"):
    """Best-evidence suspect: ``(worker_id, reason)`` or (None, "")."""
    reg = reg or _registry.get_registry()
    # 1. lanes blocked in dispatch right now: oldest wait wins
    oldest: tuple[float, str] | None = None
    for name in reg.names():
        if not name.startswith(WAITING_GAUGE_PREFIX):
            continue
        g = reg.get(name)
        since = g.value if g is not None else None
        if isinstance(since, (int, float)):
            wid = name[len(WAITING_GAUGE_PREFIX):]
            if oldest is None or since < oldest[0]:
                oldest = (since, wid)
    if oldest is not None:
        age = time.monotonic() - oldest[0]
        return oldest[1], (f"dispatch lane blocked on worker "
                           f"{oldest[1]} for {age:.1f}s")
    # 2. fleet rollup: fewest completed steps, else stalest publisher
    if rollup:
        steps = (rollup.get("metrics", {}).get(step_metric, {})
                 .get("per_worker") or {})
        numeric = {p: v for p, v in steps.items()
                   if isinstance(v, (int, float))}
        if len(numeric) > 1 and len(set(numeric.values())) > 1:
            wid = min(numeric, key=numeric.get)
            return wid, (f"worker {wid} at step {numeric[wid]} "
                         f"(fleet max {max(numeric.values())})")
        workers = rollup.get("workers") or {}
        walls = {p: w.get("wall") for p, w in workers.items()
                 if isinstance(w.get("wall"), (int, float))}
        if walls:
            wid = min(walls, key=walls.get)
            return wid, (f"worker {wid} last published "
                         f"{time.time() - walls[wid]:.1f}s ago")
    return None, ""


class StallDetector:
    """Adaptive no-progress detector for a step loop.

    ::

        detector = StallDetector(factor=4.0, rollup_fn=lambda:
                                 aggregator.last_rollup)
        for step in range(n):
            state = train_step(state)
            detector.step_completed(step)
        detector.stop()

    Until ``min_steps`` intervals are observed the watchdog is armed
    with ``warmup_timeout_s`` (generous: compile time, first-batch
    staging); after that the budget tracks ``factor`` x trailing median
    step time, clamped to [``min_timeout_s``, ``warmup_timeout_s``].
    Triggers emit ``stall.suspected`` (telemetry event log), increment
    ``coordinator/stalls_suspected``, and call ``on_stall(info)``.
    """

    def __init__(self, factor: float = 4.0, window: int = 32,
                 min_steps: int = 5, min_timeout_s: float = 1.0,
                 warmup_timeout_s: float = 300.0,
                 rollup_fn=None, on_stall=None, reg=None,
                 output=sys.stderr):
        self.factor = factor
        self.min_steps = min_steps
        self.min_timeout_s = min_timeout_s
        self.warmup_timeout_s = warmup_timeout_s
        self.rollup_fn = rollup_fn
        self.on_stall = on_stall
        self.reg = reg or _registry.get_registry()
        self._intervals: collections.deque = collections.deque(
            maxlen=window)
        self._last_step_t: float | None = None
        self._last_step = None
        self._lock = threading.Lock()
        self._stall_counter = self.reg.counter(
            "coordinator/stalls_suspected",
            "stall.suspected events emitted")
        # deferred import: the coordinator package imports telemetry, so
        # binding WatchDog at module-import time would be a cycle
        from distributed_tensorflow_tpu_torch.coordinator.watchdog import WatchDog
        self._watchdog = WatchDog(timeout=warmup_timeout_s,
                                  on_triggered=self._triggered,
                                  output=output)

    @property
    def triggered_count(self) -> int:
        return self._watchdog.triggered_count

    def median_step_s(self) -> float | None:
        with self._lock:
            if len(self._intervals) < self.min_steps:
                return None
            return statistics.median(self._intervals)

    def step_completed(self, step=None, dur_s: float | None = None):
        """Report one completed step; re-arms the watchdog budget."""
        now = time.monotonic()
        with self._lock:
            if self._last_step_t is not None:
                self._intervals.append(
                    dur_s if dur_s is not None else now - self._last_step_t)
            elif dur_s is not None:
                self._intervals.append(dur_s)
            self._last_step_t = now
            self._last_step = step
            enough = len(self._intervals) >= self.min_steps
            median = (statistics.median(self._intervals)
                      if enough else None)
        if median is not None:
            budget = min(self.warmup_timeout_s,
                         max(self.min_timeout_s, self.factor * median))
            self._watchdog.set_timeout(budget)
        self._watchdog.report_activity()

    def _triggered(self):
        median = self.median_step_s()
        with self._lock:
            last_t, last_step = self._last_step_t, self._last_step
        stalled_s = (time.monotonic() - last_t) if last_t else None
        rollup = None
        if self.rollup_fn is not None:
            try:
                rollup = self.rollup_fn()
            except Exception:
                rollup = None
        wid, reason = suspect_worker(rollup, self.reg)
        # the badput class the blocked time is accruing to (the live
        # goodput ledger's current bucket; "idle" when no ledger is
        # active) — a stall names both the blocked lane AND the bucket
        # it is pricing into
        from distributed_tensorflow_tpu_torch.telemetry import goodput
        info = {"last_step": last_step,
                "stalled_s": round(stalled_s, 3) if stalled_s else None,
                "median_step_s": (round(median, 6)
                                  if median is not None else None),
                "factor": self.factor,
                "suspect_worker": wid, "suspect_reason": reason,
                "badput_bucket": goodput.accruing_bucket()}
        self._stall_counter.increment()
        _events.event("stall.suspected", **info)
        if self.on_stall is not None:
            self.on_stall(info)         # WatchDog guards raises

    def stop(self):
        self._watchdog.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

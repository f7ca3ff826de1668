"""Coordinator metrics: counters and timers — port of
``distributed_tensorflow_tpu/coordinator/metric_utils.py``, on the
port's metrics registry (``telemetry/registry.py``).

≙ tensorflow/python/distribute/coordinator/metric_utils.py (SURVEY.md §2.5,
:89 ``monitored_timer``) and the tf.monitoring gauges in distribute_lib
(SURVEY §5.5). Thin shims over :mod:`distributed_tensorflow_tpu_torch.
telemetry` instruments with JAX's surface (``Counter(name).value``,
``Timer(name).time()``, ``total_seconds``/``average_seconds``), each
registered in the process-wide MetricsRegistry under
``coordinator/<name>``, so coordinator activity shows up in the
registry's snapshots.

Instances own their storage (one closure queue per Cluster keeps its own
counts); registration is latest-wins, so the registry always reads the
live instance.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.telemetry import registry as _telemetry

_NAMESPACE = "coordinator"


def _register(instrument, name: str):
    _telemetry.get_registry().register(instrument,
                                       f"{_NAMESPACE}/{name}")
    return instrument


class Counter(_telemetry.Counter):
    def __init__(self, name: str, description: str = ""):
        super().__init__(name, description)
        _register(self, name)


class Gauge(_telemetry.Gauge):
    """≙ tf.monitoring StringGauge/IntGauge (distribution_strategy_gauge)."""

    def __init__(self, name: str, description: str = ""):
        super().__init__(name, description)
        _register(self, name)


class Timer(_telemetry.Timer):
    """Accumulating timer (≙ monitored_timer, metric_utils.py:89)."""

    def __init__(self, name: str, description: str = ""):
        super().__init__(name, description)
        _register(self, name)


class CoordinatorMetrics:
    """The queued/inflight/execution instrument set (≙ metric_utils.py)."""

    def __init__(self):
        self.closure_execution = Timer("closure_execution")
        self.remote_value_fetch = Timer("remote_value_fetch")
        self.queued = Gauge("queued_closures")
        self.inflight = Gauge("inflight_closures")

# global gauges ≙ distribution_strategy_gauge (distribute_lib.py top)
strategy_gauge = Gauge("distribution_strategy")
replica_gauge = Gauge("num_replicas")

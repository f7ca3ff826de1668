"""Telemetry for the port: the metrics registry and structured events
that the serving engine and scheduler record into (same instrument
names, event names and JSONL fields as the JAX package), and the
goodput ledger (:mod:`goodput`, imported on its own). Off by
default: with no event log configured, call sites cost one None check.

    from distributed_tensorflow_tpu_torch import telemetry
    telemetry.configure("run1/telemetry")
    with telemetry.span("serve.step", step=i):
        ...
"""

from distributed_tensorflow_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from distributed_tensorflow_tpu_torch.telemetry.events import (
    EventLog,
    configure,
    enabled,
    event,
    event_log_path,
    read_events,
    read_run,
    shutdown,
    span,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry",
    "EventLog", "configure", "enabled", "event",
    "event_log_path", "read_events", "read_run", "shutdown", "span",
]

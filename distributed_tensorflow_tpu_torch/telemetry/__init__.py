"""Telemetry for the port: the metrics registry and structured events
that the serving engine and scheduler record into (same instrument
names, event names and JSONL fields as the JAX package), and the
goodput ledger (:mod:`goodput`, imported on its own), the serving
SLOs and burn rates (:mod:`slo`) and the live metrics export
(:mod:`exporter`: Prometheus text, ``metrics-live.prom``). Off by
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
    Timer,
    counter,
    gauge,
    get_registry,
    histogram,
    timer,
)
from distributed_tensorflow_tpu_torch.telemetry.events import (
    ENV_TELEMETRY_DIR,
    EventLog,
    EventLogCorruptError,
    configure,
    enabled,
    event,
    event_log_path,
    get_event_log,
    read_events,
    read_run,
    rotated_segments,
    shutdown,
    span,
)
from distributed_tensorflow_tpu_torch.telemetry.exporter import (
    ENV_METRICS_PORT,
    LIVE_METRICS_FILE,
    MetricsExporter,
    SeriesHistory,
    render_prometheus,
    render_rollup,
)
from distributed_tensorflow_tpu_torch.telemetry.slo import (
    DEFAULT_BURN_WINDOWS,
    SLO,
    SLOMonitor,
    default_serving_slos,
    evaluate_records,
    records_from_events,
    windows_for_span,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Timer",
    "counter", "gauge", "get_registry", "histogram", "timer",
    "ENV_TELEMETRY_DIR", "EventLog", "EventLogCorruptError", "configure",
    "enabled", "event", "event_log_path", "get_event_log", "read_events",
    "read_run", "rotated_segments", "shutdown", "span",
    "ENV_METRICS_PORT", "LIVE_METRICS_FILE", "MetricsExporter",
    "SeriesHistory", "render_prometheus", "render_rollup",
    "DEFAULT_BURN_WINDOWS", "SLO", "SLOMonitor", "default_serving_slos",
    "evaluate_records", "records_from_events", "windows_for_span",
]

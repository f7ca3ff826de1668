"""Telemetry for the port: the metrics registry and structured events
that the serving engine and scheduler record into (same instrument
names, event names and JSONL fields as the JAX package), and the
goodput ledger (:mod:`goodput`), the serving SLOs and burn rates
(:mod:`slo`), the live metrics export (:mod:`exporter`: Prometheus
text, ``metrics-live.prom``), and the fleet's observability: the
cross-host trace assembler and bottleneck classifier (:mod:`trace`),
the stall detector (:mod:`stall`), the fleet rollups over the
coordination KV (:mod:`aggregate`) and the day audit (:mod:`audit`).
The goodput, trace, stall and rollup names load on first use. Off by
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

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_M = "distributed_tensorflow_tpu_torch.telemetry."

#: package-level name -> the submodule that defines it
_LAZY = {
    **{n: _M + "aggregate" for n in (
        "FleetAggregator", "MetricsPublisher", "RollupTopology",
        "collect_rollup", "collect_rollup_tree", "merge_rollup",
        "publish_snapshot", "read_snapshots", "rollup_scalars",
        "run_duties")},
    **{n: _M + "stall" for n in ("StallDetector", "suspect_worker")},
    **{n: _M + "trace" for n in (
        "BOTTLENECK_THRESHOLDS", "assemble_run", "assemble_trace",
        "classify_run", "estimate_clock_offsets", "overlap_efficiency",
        "trace_completeness", "write_trace")},
    **{n: _M + "goodput" for n in (
        "BADPUT_BUCKETS", "GoodputLedger", "ledger_from_events",
        "ledger_from_run")},
    **{n: _M + "audit" for n in ("audit_day", "check_audit")},
}
__getattr__, __dir__ = _lazy_names(globals(), _LAZY)

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
    *_LAZY,
]

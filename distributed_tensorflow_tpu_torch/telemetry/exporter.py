"""Streaming metrics export: ring-buffer history, Prometheus scrape,
file fallback, fleet merge.

The port's copy of ``distributed_tensorflow_tpu/telemetry/exporter.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The registry answers "what are the numbers *now*" to in-process
callers only; everything else (obs_report, trend tooling) reads files
after the run exits. This module is the live path out:

- :class:`SeriesHistory` — per-instrument bounded ring-buffer
  time-series built from periodic snapshot DELTAS, so counter rates
  (``rate()``) come from history, not from a second instrument set.
- :func:`render_prometheus` — a registry snapshot as Prometheus text
  exposition (counters/gauges; histograms+timers as summaries with
  ``quantile`` labels, ``_count``/``_sum``).
- :func:`render_rollup` — the fleet merge path: one coordination-KV
  rollup (telemetry/aggregate.py) rendered with ``worker="<pid>"``
  labels, so ONE scrape of the coordinator/supervisor sees every
  worker.
- :class:`MetricsExporter` — the periodic tick: snapshot → history →
  render → serve. Serving is opt-in twice over: an HTTP ``/metrics``
  endpoint (stdlib ``http.server``) when ``DTX_METRICS_PORT`` (or the
  ``port=`` arg) is set, and a ``metrics-live.prom`` file (atomic
  rename) whenever a directory is given — the portless fallback test
  environments and the chaos sweeps scrape.

Metric names sanitize ``training/step_time`` → ``dtx_training_step_time``
(Prometheus charset); every value is a float sample on one line, no
client library required.
"""

from __future__ import annotations

import collections
import http.server
import os
import re
import threading
import time

from distributed_tensorflow_tpu_torch.telemetry import registry as _registry

#: Env var enabling the HTTP endpoint in any process that starts a
#: MetricsExporter (0/absent = file-only). Port 0 binds an ephemeral
#: port (exposed as ``exporter.port``).
ENV_METRICS_PORT = "DTX_METRICS_PORT"

#: File name of the scrape fallback written into the export directory.
LIVE_METRICS_FILE = "metrics-live.prom"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, prefix: str = "dtx_") -> str:
    return prefix + _NAME_RE.sub("_", str(name)).strip("_")


def _num(v):
    return (float(v) if isinstance(v, (int, float))
            and not isinstance(v, bool) else None)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render_prometheus(snapshot: dict, *, prefix: str = "dtx_",
                      labels: "dict | None" = None) -> "list[str]":
    """Registry snapshot (``MetricsRegistry.snapshot()``) → exposition
    lines. Histograms/timers render as summaries (quantile labels)."""
    lab = ""
    if labels:
        lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    lines: list[str] = []
    for name, entry in sorted(snapshot.items()):
        pname = _prom_name(name, prefix)
        kind = entry.get("type")
        if kind == "counter":
            v = _num(entry.get("value"))
            if v is not None:
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname}{{{lab}}} {v:g}" if lab
                             else f"{pname} {v:g}")
        elif kind in ("histogram", "timer"):
            lines.append(f"# TYPE {pname} summary")
            for q in ("p50", "p95", "p99"):
                v = _num(entry.get(q))
                if v is not None:
                    ql = f'quantile="0.{q[1:]}"'
                    both = f"{ql},{lab}" if lab else ql
                    lines.append(f"{pname}{{{both}}} {v:g}")
            c, s = _num(entry.get("count")), _num(entry.get("sum"))
            if c is not None:
                lines.append(f"{pname}_count{{{lab}}} {c:g}" if lab
                             else f"{pname}_count {c:g}")
            if s is not None:
                lines.append(f"{pname}_sum{{{lab}}} {s:g}" if lab
                             else f"{pname}_sum {s:g}")
        else:                            # gauge (and collector output)
            v = _num(entry.get("value"))
            if v is not None:
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname}{{{lab}}} {v:g}" if lab
                             else f"{pname} {v:g}")
    return lines


def render_rollup(rollup: dict, *, prefix: str = "dtx_fleet_",
                  stale_after_s: "float | None" = None,
                  now: "float | None" = None,
                  retired: "dict | None" = None) -> "list[str]":
    """Fleet rollup (``aggregate.merge_rollup``) → per-worker labelled
    samples plus the merged stats — the one-scrape-sees-all-workers
    path.

    ``stale_after_s`` drops the ``worker="<pid>"`` label series of
    workers whose last snapshot (``rollup["workers"][pid]["wall"]``)
    is older than that many seconds before ``now`` (default: the
    NEWEST snapshot wall in the rollup, so the filter needs no clock
    agreement with the workers). A worker that died before a reform
    leaves its final snapshot in the KV forever; without the filter a
    post-recovery scrape keeps reporting that ghost as a live series.
    The merged ``stat=`` samples are untouched — they answer "what did
    the fleet do", the per-worker labels answer "who is alive doing
    it".

    ``retired`` extends the same dedup to ROLE CHANGES: a worker the
    autoscaler repurposed (training↔serving) keeps heartbeating, so the
    age filter never fires, yet its pre-reassignment snapshot must not
    linger as a ghost series of the OLD role. It maps ``pid -> wall of
    reassignment``: that worker's label series are dropped until it
    publishes a snapshot NEWER than its reassignment (i.e. from the new
    role's registry — or from the old role again, if it was handed
    back)."""
    stale: set = set()
    workers = rollup.get("workers") or {}
    if stale_after_s is not None and workers:
        walls = {pid: w.get("wall") for pid, w in workers.items()
                 if isinstance(w, dict)
                 and isinstance(w.get("wall"), (int, float))}
        if walls:
            ref = now if now is not None else max(walls.values())
            stale = {pid for pid, wall in walls.items()
                     if ref - wall > stale_after_s}
            # snapshot payloads key workers by int, JSON round-trips
            # may key them by str: treat both spellings as the pid
            stale |= {str(p) for p in stale}
    if retired:
        for pid, rwall in retired.items():
            w = workers.get(pid)
            if w is None:
                w = workers.get(str(pid)) or (
                    workers.get(int(pid)) if str(pid).isdigit() else None)
            wall = w.get("wall") if isinstance(w, dict) else None
            if not isinstance(wall, (int, float)) or wall <= rwall:
                stale.add(pid)
                stale.add(str(pid))
    lines: list[str] = []
    for name, entry in sorted((rollup.get("metrics") or {}).items()):
        pname = _prom_name(name, prefix)
        lines.append(f"# TYPE {pname} gauge")
        for stat in ("sum", "max", "mean", "p50", "p95", "count"):
            v = _num(entry.get(stat))
            if v is not None:
                lines.append(f'{pname}{{stat="{stat}"}} {v:g}')
        per_worker = entry.get("per_worker") \
            or entry.get("per_worker_count") or {}
        for pid, v in sorted(per_worker.items(), key=lambda kv:
                             str(kv[0])):
            if pid in stale or str(pid) in stale:
                continue
            v = _num(v)
            if v is not None:
                lines.append(f'{pname}{{worker="{pid}"}} {v:g}')
    return lines


# ---------------------------------------------------------------------------
# Ring-buffer history + rates
# ---------------------------------------------------------------------------

class SeriesHistory:
    """Bounded time-series per instrument, fed by snapshot deltas.

    Each :meth:`record` appends ``(wall, value)`` for every numeric
    scalar the snapshot carries (counter/gauge values; histogram/timer
    count+sum) — but ONLY for entries that changed since the previous
    snapshot (the ``delta`` discipline of aggregate.py: repeated ticks
    of an idle process cost nothing). ``rate()`` differentiates the
    ring buffer, which is what turns monotonic counters into the
    steps/s / tokens/s the health surface shows.
    """

    def __init__(self, points: int = 512):
        self._points = points
        self._series: "dict[str, collections.deque]" = {}
        self._prev: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _scalars(name: str, entry: dict):
        kind = entry.get("type")
        if kind in ("histogram", "timer"):
            for stat in ("count", "sum"):
                v = _num(entry.get(stat))
                if v is not None:
                    yield f"{name}/{stat}", v
        else:
            v = _num(entry.get("value"))
            if v is not None:
                yield name, v

    def record(self, snapshot: dict, wall: "float | None" = None):
        wall = wall if wall is not None else time.time()
        with self._lock:
            for name, entry in snapshot.items():
                if self._prev.get(name) == entry:
                    continue            # unchanged: no new point
                for key, v in self._scalars(name, entry):
                    ring = self._series.get(key)
                    if ring is None:
                        ring = self._series[key] = collections.deque(
                            maxlen=self._points)
                    ring.append((wall, v))
            self._prev = dict(snapshot)

    def names(self) -> "list[str]":
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> "list[tuple[float, float]]":
        with self._lock:
            return list(self._series.get(name, ()))

    def rate(self, name: str, window_s: float = 60.0,
             now: "float | None" = None) -> "float | None":
        """Per-second rate of a monotonic series over the trailing
        window (None with <2 in-window points)."""
        pts = self.series(name)
        now = now if now is not None else (pts[-1][0] if pts else 0.0)
        pts = [(t, v) for t, v in pts if t >= now - window_s]
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])


# ---------------------------------------------------------------------------
# The exporter
# ---------------------------------------------------------------------------

class _ScrapeHandler(http.server.BaseHTTPRequestHandler):
    exporter: "MetricsExporter" = None     # bound per server below

    def do_GET(self):                      # noqa: N802 (stdlib API)
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = self.server.exporter.scrape().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):             # quiet: scrapes are periodic
        pass


class MetricsExporter:
    """Periodic snapshot → history → render → serve loop.

    ::

        exporter = MetricsExporter(dir=run_dir)       # file fallback
        exporter = MetricsExporter(port=0)            # HTTP, any port
        ...
        exporter.stop()                               # final tick

    ``rollup_fn`` (→ a fleet rollup dict) merges every worker into the
    scrape; ``extra_fn`` (→ list of pre-rendered exposition lines)
    appends e.g. the goodput ledger / SLO burn lines. Both are called
    on the tick thread and guarded — a failing provider degrades the
    scrape, never kills it.
    """

    def __init__(self, reg=None, *, interval_s: float = 2.0,
                 dir: "str | None" = None, port: "int | None" = None,
                 rollup_fn=None, extra_fn=None, history_points: int = 512,
                 labels: "dict | None" = None,
                 stale_workers_after_s: "float | None" = 30.0):
        self.reg = reg or _registry.get_registry()
        self.interval_s = interval_s
        self.dir = dir
        self.history = SeriesHistory(history_points)
        self._rollup_fn = rollup_fn
        self._extra_fn = extra_fn
        #: drop ghost ``worker=`` series whose snapshot is this much
        #: older than the fleet's newest (None keeps every label —
        #: see render_rollup)
        self.stale_workers_after_s = stale_workers_after_s
        #: pid -> wall of the worker's last role reassignment (the
        #: autoscaler repurposing it training↔serving): its label
        #: series are suppressed until a snapshot newer than that wall
        #: arrives (see render_rollup's ``retired``)
        self._retired: dict = {}
        self._labels = labels
        self._text = "# dtx exporter: no tick yet\n"
        self._text_lock = threading.Lock()
        self._server = None
        self.port = None
        if port is None:
            env = os.environ.get(ENV_METRICS_PORT)
            port = int(env) if env and env.isdigit() else None
        if port is not None:
            self._server = http.server.ThreadingHTTPServer(
                ("127.0.0.1", port), _ScrapeHandler)
            self._server.exporter = self
            self.port = self._server.server_address[1]
            threading.Thread(target=self._server.serve_forever,
                             daemon=True,
                             name="dtx-metrics-http").start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtx-metrics-export")
        self._thread.start()

    # -- the tick ---------------------------------------------------------
    def tick(self) -> str:
        wall = time.time()
        snap = self.reg.snapshot()
        self.history.record(snap, wall)
        lines = [f"# dtx metrics  wall={wall:.3f}"]
        lines += render_prometheus(snap, labels=self._labels)
        if self._rollup_fn is not None:
            try:
                rollup = self._rollup_fn()
                if rollup:
                    lines += render_rollup(
                        rollup,
                        stale_after_s=self.stale_workers_after_s,
                        retired=self._retired or None)
            except Exception:
                lines.append("# rollup_fn failed")
        if self._extra_fn is not None:
            try:
                lines += list(self._extra_fn() or [])
            except Exception:
                lines.append("# extra_fn failed")
        text = "\n".join(lines) + "\n"
        with self._text_lock:
            self._text = text
        if self.dir:
            try:
                os.makedirs(self.dir, exist_ok=True)
                path = os.path.join(self.dir, LIVE_METRICS_FILE)
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(text)
                os.replace(tmp, path)    # scrapers never see a torn file
            except OSError:
                pass
        return text

    def retire_worker(self, pid, wall: "float | None" = None):
        """Mark a worker as reassigned (role change / slot removed by a
        scale action) at ``wall`` (default now): its ``worker=`` label
        series vanish from the scrape until it publishes a snapshot
        newer than that instant."""
        self._retired[pid] = wall if wall is not None else time.time()

    def unretire_worker(self, pid):
        self._retired.pop(pid, None)

    def scrape(self) -> str:
        """Latest rendered exposition text (what ``/metrics`` serves)."""
        with self._text_lock:
            return self._text

    def _run(self):
        # first tick immediately: a short run must still leave a scrape
        try:
            self.tick()
        except Exception:
            pass
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass                    # registry torn down mid-run

    def stop(self):
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=5.0)
            try:
                self.tick()             # final flush
            except Exception:
                pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

"""Structured run events: append-only JSONL spans/events.

The port's own copy of ``distributed_tensorflow_tpu/telemetry/
events.py`` — the writer side the serving engine and scheduler use,
with the same record format, so the JAX package's report tools read the
port's files unchanged::

    {"ev": "serve.step", "t": 12.034561, "wall": 1755312000.2,
     "pid": 0, "dur_s": 0.0312, "step": 7, "admitted": 1}

- ``ev``    event name (``serve.step``, ``serve.prefill``, ...)
- ``t``     monotonic seconds since this process's log was opened
- ``wall``  wall time
- ``pid``   the process id in the cluster (``DTX_TASK_ID``, else 0)
- ``dur_s`` present on span-end events: the span's duration

With no log configured (the default) ``event``/``span`` cost one
module-global None check; :func:`configure` opens one.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

class EventLog:
    """Append-only, line-buffered JSONL event writer for one process."""

    def __init__(self, path: str, process_id: "int | str | None" = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.process_id = process_id if process_id is not None else 0
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1, encoding="utf-8")
        self._t0 = time.monotonic()
        self._last_t = 0.0

    def event(self, name: str, **fields):
        """Append one structured event; returns the record written."""
        rec = {"ev": name}
        with self._lock:
            if self._f is None:
                return None
            t = max(time.monotonic() - self._t0, self._last_t)
            self._last_t = t
            rec["t"] = round(t, 6)
            rec["wall"] = round(time.time(), 6)
            rec["pid"] = self.process_id
            rec.update(fields)
            self._f.write(json.dumps(rec) + "\n")
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Scoped span: emits ``<name>`` at exit with ``dur_s`` (and
        ``error`` when the body raised). Yields a dict the body may add
        result fields to."""
        extra: dict = {}
        t0 = time.perf_counter()
        try:
            yield extra
        except BaseException as e:
            extra["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            merged = {"dur_s": round(time.perf_counter() - t0, 6)}
            merged.update(fields)
            merged.update(extra)
            self.event(name, **merged)

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_LOG: EventLog | None = None
_LOG_LOCK = threading.Lock()


def _default_process_id() -> int:
    for var in ("DTX_TASK_ID", "DTX_MPR_TASK_INDEX"):
        try:
            return int(os.environ[var])
        except (KeyError, ValueError):
            continue
    return 0


def event_log_path(logdir: str, process_id) -> str:
    return os.path.join(logdir, f"events-{process_id}.jsonl")


def configure(logdir: str, process_id: int | None = None) -> EventLog:
    """Open (or replace) the process-wide event log under ``logdir``."""
    global _LOG
    pid = process_id if process_id is not None else _default_process_id()
    with _LOG_LOCK:
        if _LOG is not None:
            _LOG.close()
        _LOG = EventLog(event_log_path(logdir, pid), process_id=pid)
        return _LOG


def shutdown():
    """Close and detach the process-wide log."""
    global _LOG
    with _LOG_LOCK:
        if _LOG is not None:
            _LOG.close()
        _LOG = None


def enabled() -> bool:
    """True when a process-wide event log is configured."""
    return _LOG is not None


def event(name: str, **fields):
    """Module-level event; a no-op when telemetry is off."""
    log = _LOG
    if log is None:
        return None
    return log.event(name, **fields)


@contextlib.contextmanager
def span(name: str, **fields):
    """Module-level span; a plain passthrough when telemetry is off."""
    log = _LOG
    if log is None:
        yield {}
        return
    with log.span(name, **fields) as extra:
        yield extra


def read_events(path: str) -> list[dict]:
    """Parse one JSONL event file (a torn final line is dropped)."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    out = []
    for i, line in enumerate(lines):
        try:
            out.append(json.loads(line))
        except ValueError:
            if i != len(lines) - 1:
                raise
    return out


def read_run(logdir: str) -> dict:
    """Every per-process event file under ``logdir``:
    ``{process_id: [events...]}``, keyed by the id in the file name
    (numeric ids as ints)."""
    import glob
    import re
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events-*.jsonl"))):
        m = re.search(r"events-([A-Za-z0-9_]+)\.jsonl$", path)
        suffix = m.group(1) if m else str(len(out))
        out[int(suffix) if suffix.isdigit() else suffix] = read_events(path)
    return out

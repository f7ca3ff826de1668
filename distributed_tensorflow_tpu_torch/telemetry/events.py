"""Structured run events: append-only JSONL spans/events.

The port's own copy of ``distributed_tensorflow_tpu/telemetry/
events.py`` — writer and reader, with the same record format, rotation
and file names, so the JAX package's report tools read the port's
files unchanged and each package reads the other's::

    {"ev": "serve.step", "t": 12.034561, "wall": 1755312000.2,
     "pid": 0, "dur_s": 0.0312, "step": 7, "admitted": 1}

- ``ev``    event name (``serve.step``, ``serve.prefill``, ...)
- ``t``     monotonic seconds since this process's log was opened
- ``wall``  wall time
- ``pid``   the process id in the cluster: the rank of an initialised
  ``torch.distributed`` process group, else ``DTX_TASK_ID`` /
  ``DTX_MPR_TASK_INDEX``, else 0
- ``dur_s`` present on span-end events: the span's duration

With no log configured (the default) ``event``/``span`` cost one
module-global None check; :func:`configure` opens one, and so does
importing this module with ``DTX_TELEMETRY_DIR`` set (spawned ranks
inherit it). ``DTX_TELEMETRY_ROTATE_BYTES`` (or ``max_bytes=``) rotates
a file to ``<path>.N`` past that size; :func:`read_events` chains the
rotated segments back, oldest first, drops a torn final line of the
live file and raises :class:`EventLogCorruptError` on anything else
malformed.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import threading
import time


class EventLogCorruptError(ValueError):
    """An event file is malformed before its final line, or a line is
    not a JSON object (a torn final line is what a crashed writer
    leaves; anything else is corruption)."""


#: rotate a process's file once a write takes it past this many bytes
#: (unset or 0: never)
ENV_ROTATE_BYTES = "DTX_TELEMETRY_ROTATE_BYTES"
#: a directory to open the process-wide log in at import
ENV_TELEMETRY_DIR = "DTX_TELEMETRY_DIR"


class EventLog:
    """Append-only, line-buffered JSONL event writer for one process.

    With ``max_bytes`` (else ``DTX_TELEMETRY_ROTATE_BYTES``) the file
    moves to ``<path>.1`` when a write takes it past the cap, older
    segments shifting up first, so every segment ends at a line
    boundary. ``run_id`` writes a ``run.start`` event first."""

    def __init__(self, path: str, process_id: "int | str | None" = None,
                 run_id: str | None = None,
                 max_bytes: "int | None" = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.process_id = process_id if process_id is not None else 0
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(ENV_ROTATE_BYTES, "0"))
            except ValueError:
                max_bytes = 0
        self.max_bytes = max_bytes or 0
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1, encoding="utf-8")
        self._t0 = time.monotonic()
        self._last_t = 0.0
        # a reformed cluster's restarted process appends to the same
        # events-<pid>.jsonl, so each record says which generation wrote
        # it; generation 0 stays unstamped
        try:
            from distributed_tensorflow_tpu_torch.cluster import elastic
            self._gen = elastic.generation()
        except Exception:
            self._gen = 0
        if run_id:
            self.event("run.start", run_id=run_id)

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
            if self._gen:
                rec["gen"] = self._gen
            rec.update(fields)
            line = json.dumps(rec) + "\n"
            self._f.write(line)
            self._size += len(line)
            if self.max_bytes and self._size > self.max_bytes:
                self._rotate_locked()
        return rec

    def _rotate_locked(self):
        """Shift ``<path>.N`` up by one and move the live file to
        ``<path>.1`` (the caller holds the lock)."""
        self._f.close()
        n = 1
        while os.path.exists(f"{self.path}.{n}"):
            n += 1
        for i in range(n, 1, -1):
            os.replace(f"{self.path}.{i - 1}", f"{self.path}.{i}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", buffering=1, encoding="utf-8")
        self._size = 0

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

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_LOG: EventLog | None = None
_LOG_LOCK = threading.Lock()


def _default_process_id() -> int:
    """The rank of an initialised process group (where JAX asks
    ``jax.process_index()``), else the launcher's task index."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    for var in ("DTX_TASK_ID", "DTX_MPR_TASK_INDEX"):
        try:
            return int(os.environ[var])
        except (KeyError, ValueError):
            continue
    return 0


def event_log_path(logdir: str, process_id) -> str:
    return os.path.join(logdir, f"events-{process_id}.jsonl")


def configure(logdir: str, process_id: int | None = None,
              run_id: str | None = None) -> EventLog:
    """Open (or replace) the process-wide event log under ``logdir``;
    ``run_id`` writes a ``run.start`` event first."""
    global _LOG
    pid = process_id if process_id is not None else _default_process_id()
    with _LOG_LOCK:
        if _LOG is not None:
            _LOG.close()
        _LOG = EventLog(event_log_path(logdir, pid), process_id=pid,
                        run_id=run_id)
        return _LOG


def shutdown():
    """Close and detach the process-wide log."""
    global _LOG
    with _LOG_LOCK:
        if _LOG is not None:
            _LOG.close()
        _LOG = None


def get_event_log() -> EventLog | None:
    """The process-wide log, or None when telemetry is off."""
    return _LOG


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


# spawned ranks inherit the directory (the JAX package's env activation)
_env = os.environ.get(ENV_TELEMETRY_DIR)
if _env:
    configure(_env)
del _env


def rotated_segments(path: str) -> list[str]:
    """``path``'s rotated segments, oldest first (``path.N`` is older
    than ``path.N-1``; the live ``path`` is not included)."""
    segs = []
    for p in glob.glob(glob.escape(path) + ".*"):
        m = re.match(re.escape(path) + r"\.(\d+)$", p)
        if m:
            segs.append((int(m.group(1)), p))
    return [p for _, p in sorted(segs, reverse=True)]


def _read_one(path: str, *, tolerate_torn_tail: bool) -> list[dict]:
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    out = []
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("event record is not an object")
        except ValueError as e:
            if i == len(lines) - 1 and tolerate_torn_tail:
                break
            raise EventLogCorruptError(
                f"{path}:{i + 1}: malformed event line: {e}") from e
        out.append(rec)
    return out


def read_events(path: str, *, tolerate_torn_tail: bool = True,
                include_rotated: bool = True) -> list[dict]:
    """Parse one JSONL event file, after its rotated segments (oldest
    first). Only the live file's final line may be torn, and it is
    dropped with ``tolerate_torn_tail``; anything else malformed raises
    :class:`EventLogCorruptError`."""
    out: list[dict] = []
    if include_rotated:
        for seg in rotated_segments(path):
            out.extend(_read_one(seg, tolerate_torn_tail=False))
    out.extend(_read_one(path, tolerate_torn_tail=tolerate_torn_tail))
    return out


def read_run(logdir: str, *, tolerate_torn_tail: bool = True) -> dict:
    """Every per-process event file under ``logdir``, each with its
    rotated segments: ``{process_id: [events...]}``, keyed by the id in
    the file name (numeric ids as ints)."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events-*.jsonl"))):
        m = re.search(r"events-([A-Za-z0-9_]+)\.jsonl$", path)
        suffix = m.group(1) if m else str(len(out))
        pid = int(suffix) if suffix.isdigit() else suffix
        out[pid] = read_events(path, tolerate_torn_tail=tolerate_torn_tail)
    return out

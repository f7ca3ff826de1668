"""Profiling and input-pipeline counters — port of
``distributed_tensorflow_tpu/utils/profiler.py``.

The profiler half maps the reference's ``tf.profiler`` surface onto
``torch.profiler`` (CUPTI on the card), as JAX's maps it onto
``jax.profiler``:

- ``start(logdir)`` / ``stop()``         ≙ tf.profiler.experimental.start/stop
- ``Trace("name", step_num=i)``         ≙ tf.profiler.experimental.Trace
                                          (``record_function``)
- ``trace(target, logdir)``             ≙ the remote client: "local" runs
                                          here, a process id through
                                          ``coordinator/remote_dispatch``
- ``annotate_function``, ``step_marker`` (which also emits the
  ``profiler.step_marker`` telemetry event with the step)
- ``op_profile(logdir)``                 per-op table of a collected trace

A session writes the Chrome trace ``torch.profiler`` exports, under
``<logdir>/plugins/profile/<run>/<host>.pt.trace.json`` (JAX writes an
XSpace ``*.xplane.pb`` at the same place); ``op_profile`` reads it back:
kernel rows on the card, CPU-op rows on the CPU. ``start_server`` has no
``torch.profiler`` counterpart: its role, a worker that takes profiling
requests, is ``remote_dispatch.run_worker_loop`` (``trace(process_id,
...)`` then runs the session there), so it raises.

The input-pipeline half (JAX ``:297-417``): every concurrent stage
(``Dataset.map`` with ``num_parallel_calls``, ``interleave``,
``prefetch``, the distributed iterator's device copy, ``training/
loops.py InfeedLoop``) keeps a :class:`StageStats`: elements, and four
wait channels that say WHO blocks WHOM:

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

import contextlib
import dataclasses
import functools
import glob
import json
import os
import socket
import threading
import time
import weakref


@dataclasses.dataclass(frozen=True)
class ProfilerOptions:
    """≙ tf.profiler.experimental.ProfilerOptions (profiler_v2.py:46).

    ``python_tracer_level`` > 0 records Python call stacks
    (``with_stack``); ``device_tracer_level`` > 0 traces the card's
    kernels when there is one (CUPTI); ``host_tracer_level`` and
    ``delay_ms`` are accepted for API parity, as JAX accepts them."""
    host_tracer_level: int = 2
    python_tracer_level: int = 1
    device_tracer_level: int = 1
    delay_ms: int = 0


_session: dict = {}
_session_lock = threading.Lock()


def start(logdir: str, options: ProfilerOptions | None = None) -> None:
    """Start collecting a trace in this process (host ops, and the card's
    kernels where there is one). One session at a time, as JAX's."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    options = options or ProfilerOptions()
    activities = [ProfilerActivity.CPU]
    if options.device_tracer_level > 0 and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _session_lock:
        if _session:
            raise RuntimeError("a profiler session is already running "
                               f"(logdir {_session['logdir']!r})")
        prof = _profile(activities=activities,
                        with_stack=options.python_tracer_level > 0)
        prof.start()
        _session.update(prof=prof, logdir=logdir)


def stop() -> str:
    """Stop tracing and write the Chrome trace; returns its path."""
    with _session_lock:
        if not _session:
            raise RuntimeError("no profiler session is running")
        prof, logdir = _session.pop("prof"), _session.pop("logdir")
    prof.stop()
    run = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    path = os.path.join(run, f"{socket.gethostname()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile(logdir: str, options: ProfilerOptions | None = None):
    start(logdir, options)
    try:
        yield
    finally:
        stop()


def _trace_name(name: str, kwargs: dict) -> str:
    if kwargs:
        name = name + " " + " ".join(
            f"{k}={v}" for k, v in sorted(kwargs.items()))
    return name


class Trace:
    """Scoped trace annotation visible in the trace viewer (a
    ``record_function`` range). ≙ tf.profiler.experimental.Trace::

        with Trace("train_step", step_num=i):
            state, metrics = step(state, batch)
    """

    def __init__(self, name: str, **kwargs):
        import torch
        self.name = _trace_name(name, kwargs)
        self._rf = torch.profiler.record_function(self.name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        return self._rf.__exit__(*exc)


def annotate_function(fn=None, *, name: str | None = None):
    """Decorator: annotate every call of ``fn`` in the profile."""
    if fn is None:
        return functools.partial(annotate_function, name=name)
    label = name or getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with Trace(label):
            return fn(*args, **kwargs)
    return wrapper


def start_server(port: int):
    """No ``torch.profiler`` counterpart of JAX's profiling server: run
    ``coordinator.remote_dispatch.run_worker_loop()`` on the worker and
    collect from it with ``trace(<its process id>, logdir)``."""
    raise NotImplementedError(
        "torch.profiler has no profiling server; run "
        "coordinator.remote_dispatch.run_worker_loop() on the worker and "
        "call profiler.trace(<process id>, logdir)")


def stop_server():
    raise NotImplementedError(
        "torch.profiler has no profiling server (see start_server)")


def _profile_here(logdir: str, duration_ms: int) -> str:
    """Run a profiling session of ``duration_ms`` in THIS process (run on
    the target through remote dispatch)."""
    with profile(logdir):
        time.sleep(duration_ms / 1000.0)
    return logdir


def trace(target, logdir: str, duration_ms: int = 2000,
          host_tracer_level: int = 2, num_tracing_attempts: int = 1):
    """Collect ``duration_ms`` of profile from ``target`` into ``logdir``.

    ≙ tf.profiler.experimental.client.trace, over the framework's own
    control plane as in JAX: the session's closure is dispatched to the
    target PROCESS over the coordination service
    (``coordinator/remote_dispatch.py``; the target runs
    ``remote_dispatch.run_worker_loop``). ``target``: "local"/None = this
    process; an int = a remote process id. ``num_tracing_attempts``
    retries transient failures."""
    del host_tracer_level           # parity knob
    last_err = None
    for _ in range(max(1, num_tracing_attempts)):
        try:
            if target in (None, "local"):
                return _profile_here(logdir, duration_ms)
            if isinstance(target, int):
                from distributed_tensorflow_tpu_torch.coordinator \
                    .remote_dispatch import RemoteLane
                return RemoteLane(target).execute(
                    _profile_here, (logdir, duration_ms), {},
                    timeout_s=duration_ms / 1000.0 + 60.0)
            break
        except (RuntimeError, TimeoutError) as e:
            last_err = e
    if last_err is not None:
        raise last_err
    raise TypeError(
        f"target must be 'local' or a process id, got {target!r}; "
        f"address-based collection would need a grpc ProfilerService "
        f"client, which the runtime deliberately does not depend on")


@contextlib.contextmanager
def step_marker(step: int):
    """Mark a training step boundary: a ``"train step_num=<step>"``
    range in the trace and, when telemetry is on, a
    ``profiler.step_marker`` event stamped with the SAME step integer
    the telemetry layer carries (``StepTelemetry.step_completed(step)``,
    the ``step`` of ``train.step`` events), so a trace and the
    framework's timeline line up step by step."""
    from distributed_tensorflow_tpu_torch.telemetry import events
    events.event("profiler.step_marker", step=int(step))
    with Trace("train", step_num=step):
        yield


# ---------------------------------------------------------------------------
# Op-profile analysis: read a collected trace back into a per-op table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpTime:
    name: str          # kernel or op name
    total_ms: float    # summed time across the collected trace
    fraction: float    # share of the total over the selected rows
    count: int         # number of trace events


#: Chrome-trace categories of each device kind's rows
_CATEGORIES = {"GPU": ("kernel", "gpu_memcpy", "gpu_memset"),
               "CPU": ("cpu_op",)}


def _load_trace(logdir: str) -> dict:
    """Parse the newest ``*.pt.trace.json`` under ``logdir``."""
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.pt.trace.json")),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(
            f"no *.pt.trace.json under {logdir}/plugins/profile — call "
            f"profiler.start/stop (or profiler.trace) first")
    with open(paths[-1]) as f:
        return json.load(f)


def op_profile(logdir: str, top: int = 20,
               device_substr: str = "GPU") -> "list[OpTime]":
    """Aggregate op time from a collected trace: the ``top`` names by
    total time among the rows of ``device_substr`` ("GPU": the card's
    kernels, copies and memsets; "CPU": the host's ``aten`` ops, each
    with its inclusive time). Use after ``profiler.profile(logdir)``::

        with profiler.profile("/tmp/prof"):
            train_step(...)
        for row in profiler.op_profile("/tmp/prof"):
            print(f"{row.total_ms:8.2f}ms {row.fraction:5.1%} {row.name}")
    """
    from collections import defaultdict
    key = next((k for k in _CATEGORIES if k in device_substr.upper()),
               None)
    if key is None:
        raise ValueError(f"device_substr={device_substr!r}: expected one "
                         f"naming {sorted(_CATEGORIES)}")
    tot = defaultdict(lambda: [0.0, 0])
    for ev in _load_trace(logdir).get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in _CATEGORIES[key]:
            cell = tot[ev.get("name", "?")]
            cell[0] += float(ev.get("dur", 0.0))
            cell[1] += 1
    if not tot:
        raise ValueError(f"no {key} op events in the trace under {logdir}")
    total_us = sum(v[0] for v in tot.values()) or 1.0
    rows = [OpTime(name=name, total_ms=us / 1e3, fraction=us / total_us,
                   count=n) for name, (us, n) in tot.items()]
    rows.sort(key=lambda r: -r.total_ms)
    return rows[:top]


# ---------------------------------------------------------------------------
# Host input-pipeline telemetry
# ---------------------------------------------------------------------------

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

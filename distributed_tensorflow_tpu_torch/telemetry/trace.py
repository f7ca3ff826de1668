"""Cross-host trace timeline: merge per-process event logs into one

The port's copy of ``distributed_tensorflow_tpu/telemetry/trace.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).
Chrome-trace/Perfetto JSON, attribute step time to phases, name the
bottleneck.

The reference answers "why is my pod slow?" with the tf.profiler /
TensorBoard-profile toolchain (SURVEY §5.1 — trace viewer + input
pipeline analyzer over XPlane). ``utils/profiler.py`` keeps that capture
surface, but its output is opaque to this framework's own tooling and
the ``telemetry/`` JSONL span logs stay trapped in per-host files. This
module is the missing layer between the two:

- **Trace assembly** (:func:`assemble_trace` / :func:`assemble_run`):
  every worker's ``events-<pid>.jsonl`` (plus the recovery supervisor's)
  merges into ONE Chrome-trace JSON — open it in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``. Torn-tail tolerant
  like :func:`events.read_events`; spans carrying a ``span_id`` (remote
  dispatch closures, tiered checkpoint commits) become Perfetto *flow
  arrows*, so dispatch→execute→result and capture→local→durable render
  as causally linked tracks.
- **Clock alignment** (:func:`estimate_clock_offsets`): per-host wall
  clocks are aligned from sync points the run already produces —
  ``clock.sync`` events emitted when a coordination-service barrier
  releases (every participant exits within the release latency, so their
  recorded walls read the same instant), and the supervisor's
  ``clock.hb`` observations pairing a worker heartbeat's self-reported
  wall with the file's mtime (both stamped within the write latency).
  Accuracy is bounded by those latencies: sub-ms in-process, ~RTT
  across a real fabric.
- **Bottleneck classification** (:func:`classify_run`): from per-step
  phase attribution (compute / collective / infeed wait / host callback
  / checkpoint blocking — see ``training/loops.StepTelemetry``) plus the
  recovery timeline, a run is named input-bound / comm-bound /
  compute-bound / checkpoint-bound / recovery-bound against the explicit
  thresholds in :data:`BOTTLENECK_THRESHOLDS`.
- **Overlap accounting** (:func:`overlap_efficiency`): the fraction of
  collective time hidden behind the remaining backward pass — the direct
  measure of the bucketed-collective win (see
  ``parallel/collectives.simulate_overlap`` for the schedule model).
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import zlib

from distributed_tensorflow_tpu_torch.telemetry import events as _events

#: Event emitted by CoordinationServiceAgent.barrier at barrier release:
#: every participant records its wall clock for the same shared instant.
CLOCK_SYNC_EVENT = "clock.sync"

#: Event emitted by the recovery supervisor when it observes a fresh
#: worker heartbeat: pairs the worker's self-reported wall with the
#: heartbeat file's mtime (supervisor/filesystem clock domain).
CLOCK_HB_EVENT = "clock.hb"

#: The synthetic Chrome-trace pid block non-numeric process ids (the
#: recovery supervisor) are mapped into.
_SYNTHETIC_PID_BASE = 100000


# ---------------------------------------------------------------------------
# Clock-offset estimation
# ---------------------------------------------------------------------------

def _pairwise_offsets(events_by_pid: dict) -> dict:
    """Collect pairwise clock-offset observations.

    Returns ``{(a, b): [delta, ...]}`` where each ``delta`` observes
    ``offset_a - offset_b`` (with ``offset_p`` = how far pid p's wall
    clock runs AHEAD of true time): for a shared instant read as
    ``w_a`` by a and ``w_b`` by b, ``w_a - w_b = offset_a - offset_b``.
    """
    obs: dict = collections.defaultdict(list)

    # clock.sync: group by (gen, barrier name, per-process occurrence
    # index) — the i-th crossing of barrier NAME in generation G is the
    # same shared instant on every participant.
    sync_walls: dict = collections.defaultdict(dict)
    for pid, events in events_by_pid.items():
        counts: dict = collections.Counter()
        for ev in events:
            if ev.get("ev") != CLOCK_SYNC_EVENT:
                continue
            name = ev.get("barrier", "?")
            key = (ev.get("gen", 0), name, counts[name])
            counts[name] += 1
            wall = ev.get("wall")
            if isinstance(wall, (int, float)):
                sync_walls[key][pid] = wall
    for walls in sync_walls.values():
        pids = sorted(walls, key=str)
        for i, a in enumerate(pids):
            for b in pids[i + 1:]:
                obs[(a, b)].append(walls[a] - walls[b])

    # clock.hb: the OBSERVING process (usually "supervisor") pairs a
    # worker's self-reported wall with the heartbeat file's mtime in its
    # own clock domain: offset_worker - offset_observer ≈ wall - mtime.
    for pid, events in events_by_pid.items():
        for ev in events:
            if ev.get("ev") != CLOCK_HB_EVENT:
                continue
            worker = ev.get("worker")
            w_wall, mtime = ev.get("worker_wall"), ev.get("mtime")
            if (worker is None or worker == pid
                    or not isinstance(w_wall, (int, float))
                    or not isinstance(mtime, (int, float))):
                continue
            obs[(worker, pid)].append(w_wall - mtime)
    return dict(obs)


def estimate_clock_offsets(events_by_pid: dict,
                           reference=None) -> dict:
    """Per-process clock offsets (seconds) relative to ``reference``.

    ``aligned_wall = wall - offset[pid]`` puts every process on the
    reference clock. Offsets come from the run's own sync points (see
    :func:`_pairwise_offsets`); per edge the MEDIAN observation is used
    (robust to one slow barrier release). Processes unreachable from the
    reference through any sync edge get offset 0.0 (flagged by
    :func:`assemble_trace` metadata).

    ``reference`` defaults to pid 0 when present, else the smallest
    numeric pid, else the first key.
    """
    pids = list(events_by_pid)
    if not pids:
        return {}
    if reference is None:
        numeric = sorted(p for p in pids if isinstance(p, int))
        reference = (0 if 0 in pids else
                     numeric[0] if numeric else pids[0])
    edges: dict = collections.defaultdict(dict)
    for (a, b), deltas in _pairwise_offsets(events_by_pid).items():
        d = statistics.median(deltas)
        edges[a][b] = d          # offset_a - offset_b = d
        edges[b][a] = -d
    offsets = {p: 0.0 for p in pids}
    seen = {reference}
    frontier = [reference]
    while frontier:
        a = frontier.pop()
        for b, d in edges.get(a, {}).items():
            if b in seen or b not in offsets:
                continue
            # d = offset_a - offset_b  ->  offset_b = offset_a - d
            offsets[b] = offsets[a] - d
            seen.add(b)
            frontier.append(b)
    offsets["__unaligned__"] = [p for p in pids if p not in seen]
    return offsets


# ---------------------------------------------------------------------------
# Chrome-trace assembly
# ---------------------------------------------------------------------------

#: Dotted-namespace prefix -> named track (Chrome-trace tid). Everything
#: else lands on a track named after its first namespace component.
_TRACK_ORDER = ["train", "serve", "checkpoint", "recovery", "dispatch",
                "worker", "pipeline", "input", "fault", "stall",
                "scaling", "profiler", "clock", "run"]

_SKIP_ARG_FIELDS = frozenset({"ev", "t", "wall", "pid", "dur_s"})


def _track(name: str) -> str:
    return name.split(".", 1)[0] if isinstance(name, str) else "other"


def _numeric_pid(pid, synthetic: dict) -> int:
    if isinstance(pid, int):
        return pid
    if pid not in synthetic:
        synthetic[pid] = _SYNTHETIC_PID_BASE + len(synthetic)
    return synthetic[pid]


def _flow_id(span_id: str) -> int:
    return zlib.crc32(str(span_id).encode()) & 0x7FFFFFFF


def assemble_trace(events_by_pid: dict, *, offsets: dict | None = None,
                   run_id: str | None = None) -> dict:
    """Merge per-process event lists into one Chrome-trace JSON dict.

    - every process becomes a trace *process* (the supervisor gets a
      synthetic numeric pid, named in metadata);
    - events within a process land on *threads* named by event namespace
      (``train``, ``checkpoint``, ``recovery`` ...);
    - events carrying ``dur_s`` become complete slices (``ph: X``; the
      JSONL record is written at span END, so the slice starts at
      ``wall - dur_s``), the rest instant events (``ph: i``);
    - events sharing a ``span_id`` are joined by flow arrows in record
      order — the dispatch→execute→result and capture→commit chains;
    - timestamps are wall clocks aligned by ``offsets`` (defaults to
      :func:`estimate_clock_offsets`), rebased so the earliest event is
      t=0.

    The result round-trips through ``json.dumps`` and loads in Perfetto
    / ``chrome://tracing`` as-is.
    """
    if offsets is None:
        offsets = estimate_clock_offsets(events_by_pid)
    unaligned = offsets.get("__unaligned__", [])
    synthetic: dict = {}
    trace_events: list[dict] = []

    # first pass: aligned start times (for rebasing + flow ordering)
    aligned: dict = {}
    t0 = None
    for pid, events in events_by_pid.items():
        off = offsets.get(pid, 0.0)
        for i, ev in enumerate(events):
            wall = ev.get("wall")
            if not isinstance(wall, (int, float)):
                continue
            dur = ev.get("dur_s")
            dur = dur if isinstance(dur, (int, float)) and dur >= 0 else 0.0
            start = wall - off - dur
            aligned[(pid, i)] = (start, dur)
            t0 = start if t0 is None else min(t0, start)
    t0 = t0 or 0.0

    flows: dict = collections.defaultdict(list)
    for pid, events in sorted(events_by_pid.items(), key=lambda kv:
                              str(kv[0])):
        cpid = _numeric_pid(pid, synthetic)
        label = (f"worker {pid}" if isinstance(pid, int) else str(pid))
        trace_events.append({"ph": "M", "pid": cpid, "tid": 0,
                             "name": "process_name",
                             "args": {"name": label + (
                                 " (clock unaligned)"
                                 if pid in unaligned else "")}})
        tracks: dict = {}
        for i, ev in enumerate(events):
            if (pid, i) not in aligned:
                continue
            start, dur = aligned[(pid, i)]
            name = ev.get("ev", "?")
            track = _track(name)
            if track not in tracks:
                tid = len(tracks) + 1
                tracks[track] = tid
                trace_events.append({
                    "ph": "M", "pid": cpid, "tid": tid,
                    "name": "thread_name", "args": {"name": track}})
            tid = tracks[track]
            ts = round((start - t0) * 1e6, 3)
            args = {k: v for k, v in ev.items()
                    if k not in _SKIP_ARG_FIELDS}
            rec = {"name": name, "cat": track, "pid": cpid, "tid": tid,
                   "ts": ts, "args": args}
            if dur > 0:
                rec.update(ph="X", dur=round(dur * 1e6, 3))
            else:
                rec.update(ph="i", s="t")
            trace_events.append(rec)
            span_id = ev.get("span_id")
            if span_id is not None:
                flows[str(span_id)].append(
                    (start, {"pid": cpid, "tid": tid, "ts": ts}))

    # flow arrows: s -> t ... t -> f in aligned time order
    n_links = 0
    for span_id, points in flows.items():
        if len(points) < 2:
            continue
        points.sort(key=lambda p: p[0])
        fid = _flow_id(span_id)
        for j, (_, where) in enumerate(points):
            ph = ("s" if j == 0 else
                  "f" if j == len(points) - 1 else "t")
            rec = {"ph": ph, "id": fid, "name": span_id, "cat": "flow"}
            rec.update(where)
            if ph == "f":
                rec["bp"] = "e"
            trace_events.append(rec)
        n_links += len(points) - 1

    meta = {
        "run_id": run_id,
        "clock_offsets_s": {str(p): round(v, 6)
                            for p, v in offsets.items()
                            if p != "__unaligned__"},
        "clock_unaligned": [str(p) for p in unaligned],
        "flow_links": n_links,
        "processes": sorted(str(p) for p in events_by_pid),
    }
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": meta}


def assemble_run(run_dir: str, *, reference=None) -> dict:
    """Read every ``events-*.jsonl`` under ``run_dir`` (torn tails
    tolerated) and assemble the merged trace."""
    events_by_pid = _events.read_run(run_dir)
    offsets = estimate_clock_offsets(events_by_pid, reference=reference)
    return assemble_trace(events_by_pid, offsets=offsets,
                          run_id=os.path.basename(
                              os.path.normpath(run_dir)))


def write_trace(run_dir: str, out_path: str | None = None) -> str:
    """Assemble ``run_dir`` and write the Chrome-trace JSON (default:
    ``<run_dir>/trace.json``). Returns the output path."""
    out_path = out_path or os.path.join(run_dir, "trace.json")
    trace = assemble_run(run_dir)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    return out_path


# ---------------------------------------------------------------------------
# Completeness: is every generation's telemetry present and mergeable?
# ---------------------------------------------------------------------------

def trace_completeness(events_by_pid: dict) -> dict:
    """Verify the merged timeline covers every cluster generation.

    A generation counts as covered when at least one WORKER event
    carries it (records are stamped ``gen`` by EventLog for generation
    > 0; generation-0 events are unstamped). Generations are enumerated
    from the supervisor's ``recovery.generation_start`` timeline when
    present, else from the stamps themselves. A SIGKILL'd worker's torn
    tail must not break this — callers read with the default
    torn-tail-tolerant reader.

    Returns ``{"generations": {gen: {"worker_events": n, "pids":
    [...]}}, "missing": [gen, ...], "complete": bool}``.
    """
    expected: set[int] = set()
    for events in events_by_pid.values():
        for ev in events:
            if ev.get("ev") == "recovery.generation_start":
                g = ev.get("generation")
                if isinstance(g, int):
                    expected.add(g)
    per_gen: dict = collections.defaultdict(
        lambda: {"worker_events": 0, "pids": set()})
    for pid, events in events_by_pid.items():
        if not isinstance(pid, int):
            continue                     # supervisor: not a worker
        for ev in events:
            g = ev.get("gen", 0)
            if not isinstance(g, int):
                continue
            per_gen[g]["worker_events"] += 1
            per_gen[g]["pids"].add(pid)
    if not expected:
        expected = set(per_gen) or {0}
    missing = sorted(g for g in expected
                     if per_gen.get(g, {}).get("worker_events", 0) == 0)
    return {
        "generations": {g: {"worker_events": d["worker_events"],
                            "pids": sorted(d["pids"])}
                        for g, d in sorted(per_gen.items())},
        "expected_generations": sorted(expected),
        "missing": missing,
        "complete": not missing,
    }


# ---------------------------------------------------------------------------
# Overlap efficiency (the bucketed-collective win, measured)
# ---------------------------------------------------------------------------

def overlap_efficiency(total_collective_s: float,
                       exposed_collective_s: float) -> float | None:
    """Fraction of collective time hidden behind compute.

    ``total_collective_s`` is what the collectives cost run back-to-back
    (serial); ``exposed_collective_s`` is how much of that actually
    extended the step's critical path. 1.0 = fully overlapped, 0.0 = the
    schedule hid nothing. None when there was no collective at all.
    """
    if total_collective_s <= 0:
        return None
    eff = 1.0 - exposed_collective_s / total_collective_s
    return max(0.0, min(1.0, eff))


# ---------------------------------------------------------------------------
# Bottleneck classification
# ---------------------------------------------------------------------------

#: Explicit thresholds, in the priority order of the table below: a run
#: triggers a class when the measured fraction meets the threshold; when
#: several trigger, the LARGEST ratio (measured / threshold) wins.
#:
#: - ``recovery`` — recovery downtime (sum of death→restored MTTRs) as a
#:   fraction of the run's wall span
#: - ``infeed``   — step-loop time blocked on the input pipeline, as a
#:   fraction of total step time (InfeedLoop.wait_fraction's signal)
#: - ``checkpoint`` — step-loop time blocked capturing/committing
#:   checkpoints, as a fraction of total step time
#: - ``collective`` — EXPOSED collective time (not hidden behind the
#:   backward pass), as a fraction of total step time
BOTTLENECK_THRESHOLDS = {
    "recovery": 0.20,
    "infeed": 0.15,
    "checkpoint": 0.10,
    "collective": 0.25,
}

_CLASS_NAMES = {
    "recovery": "recovery-bound",
    "infeed": "input-bound",
    "checkpoint": "checkpoint-bound",
    "collective": "comm-bound",
}


def classify_run(fractions: dict) -> dict:
    """Name a run's bottleneck from measured phase fractions.

    ``fractions`` maps the :data:`BOTTLENECK_THRESHOLDS` keys to
    measured fractions (missing/None = 0). Returns ``{"class": name,
    "trigger": key | None, "measured": {...}, "thresholds": {...},
    "reasons": [...]}`` where ``class`` is one of input-bound /
    comm-bound / compute-bound / checkpoint-bound / recovery-bound.
    A run that trips no threshold is compute-bound — the healthy state.
    """
    measured = {k: float(fractions.get(k) or 0.0)
                for k in BOTTLENECK_THRESHOLDS}
    reasons = []
    best_key, best_ratio = None, 0.0
    for key, thresh in BOTTLENECK_THRESHOLDS.items():
        frac = measured[key]
        if frac >= thresh:
            reasons.append(f"{key} fraction {frac:.1%} >= "
                           f"threshold {thresh:.0%}")
            ratio = frac / thresh
            if ratio > best_ratio:
                best_key, best_ratio = key, ratio
    return {
        "class": _CLASS_NAMES.get(best_key, "compute-bound"),
        "trigger": best_key,
        "measured": {k: round(v, 4) for k, v in measured.items()},
        "thresholds": dict(BOTTLENECK_THRESHOLDS),
        "reasons": reasons,
    }

#!/usr/bin/env python3
"""Assemble a run's per-process event logs into ONE Chrome-trace JSON
and summarize the merged timeline.

On the port: the counterpart of ``tools/trace_report.py``, whose output
it gives byte for byte on the same run directory (either package's);
it adds only ``--device`` (default ``cuda``, as every port script).

Usage::

    python3 tools/torch_trace_report.py RUN_DIR              # write + summary
    python3 tools/torch_trace_report.py RUN_DIR -o out.json  # explicit output
    python3 tools/torch_trace_report.py RUN_DIR --check      # CI gate
    python3 tools/torch_trace_report.py RUN_DIR --pipeline   # synthetic
                                                             # stage tracks

``RUN_DIR`` is a telemetry directory (``DTX_TELEMETRY_DIR`` /
``telemetry.configure``): one ``events-<pid>.jsonl`` per process plus
the recovery supervisor's ``events-supervisor.jsonl``. The merged trace
lands at ``<RUN_DIR>/trace.json`` by default — open it at
https://ui.perfetto.dev or ``chrome://tracing``. Per-host clocks are
aligned from the run's own sync points (barrier-release ``clock.sync``
events + supervisor heartbeat ``clock.hb`` observations — see
telemetry/trace.py); spans sharing a ``span_id`` (dispatched closures,
tiered checkpoint commits, and ``kv.migrate`` export/adopt pairs —
one ``kvmig/<request>`` id across both replicas, so a KV-block
migration draws an arrow from the prefill replica to the decode
replica that adopted the blocks) render as flow arrows.

``--check`` is the CI gate ``chaos_sweep --kill`` runs per seed: exit
non-zero when any event file is corrupt mid-file (torn FINAL lines from
SIGKILL'd writers are tolerated and reported), when a cluster
generation left no mergeable worker events (the timeline has a hole),
or when the assembled trace is not valid JSON.

``--pipeline`` appends synthetic per-stage tracks derived from any
``pipeline.schedule`` events in the run (the compiled schedule is one
fused XLA program, so stage activity is analytic — see
parallel/pipeline.schedule_spans).

When the run contains a production-day driver's ``day.phase`` markers
(testing/day_sim.py), synthetic "production day (audit)" tracks are
appended automatically: one row of diurnal-phase spans plus one row
per audit attribution cause with its merged windows
(telemetry/audit.cause_windows) — the rack-loss recovery window and
the spike-overload window land on the same timeline as the worker
events they explain.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))
import torch_entry  # noqa: E402

from distributed_tensorflow_tpu_torch.telemetry import (  # noqa: E402
    events as tv_events, trace as tv_trace)


def _torn_tails(run_dir: str) -> "list[str]":
    import glob
    out = []
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "events-*.jsonl"))):
        try:
            with open(path, "r", encoding="utf-8",
                      errors="replace") as f:
                lines = [ln for ln in f.read().split("\n") if ln]
            if lines:
                json.loads(lines[-1])
        except ValueError:
            out.append(path)
    return out


def _pipeline_tracks(events_by_pid: dict, trace: dict):
    """Append synthetic per-stage tracks for every pipeline.schedule
    event, scaled so one schedule spans the median measured step."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import (
        schedule_spans)
    scheds = [ev for events in events_by_pid.values() for ev in events
              if ev.get("ev") == "pipeline.schedule"]
    if not scheds:
        return 0
    step_durs = sorted(
        ev["dur_s"] for events in events_by_pid.values() for ev in events
        if ev.get("ev") == "train.step"
        and isinstance(ev.get("dur_s"), (int, float)))
    step_s = step_durs[len(step_durs) // 2] if step_durs else 1.0
    n = 0
    for k, ev in enumerate(scheds):
        s, m = ev.get("n_stages", 1), ev.get("n_micro", 1)
        sched = ev.get("schedule", "gpipe")
        cycles = (m + s - 1) if sched == "gpipe" else (m + 2 * (s - 1))
        spans = schedule_spans(s, m, sched,
                               t_cycle_s=step_s / max(1, cycles))
        pid = tv_trace._SYNTHETIC_PID_BASE + 1000 + k
        trace["traceEvents"].append(
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"pipeline schedule {sched} "
                              f"(pp={s}, m={m}, analytic)"}})
        for stage, row in enumerate(spans):
            trace["traceEvents"].append(
                {"ph": "M", "pid": pid, "tid": stage + 1,
                 "name": "thread_name",
                 "args": {"name": f"stage {stage}"}})
            for sp in row:
                trace["traceEvents"].append(
                    {"ph": "X", "pid": pid, "tid": stage + 1,
                     "name": sp["kind"], "cat": "pipeline",
                     "ts": round(sp["t0"] * 1e6, 3),
                     "dur": round((sp["t1"] - sp["t0"]) * 1e6, 3),
                     "args": {"schedule": sched}})
                n += 1
    return n


def _day_tracks(events_by_pid: dict, trace: dict,
                offsets: dict) -> int:
    """Append synthetic production-day tracks when a day driver ran:
    one row of phase spans (the diurnal curve) plus one row
    per attribution cause with its merged windows — so the trace shows
    WHERE the audit priced each SLO burn, on the same timeline as the
    real worker events."""
    from distributed_tensorflow_tpu_torch.telemetry import audit as tv_audit
    phases = tv_audit.phase_spans(events_by_pid)
    if not phases:
        return 0
    # the same rebasing assemble_trace used: earliest aligned start
    t0 = None
    for pid, events in events_by_pid.items():
        off = offsets.get(pid, 0.0)
        for ev in events:
            wall = ev.get("wall")
            if not isinstance(wall, (int, float)):
                continue
            dur = ev.get("dur_s")
            dur = dur if isinstance(dur, (int, float)) and dur >= 0 \
                else 0.0
            start = wall - off - dur
            t0 = start if t0 is None else min(t0, start)
    t0 = t0 or 0.0
    pid = tv_trace._SYNTHETIC_PID_BASE + 2000
    trace["traceEvents"].append(
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": "production day (audit)"}})
    trace["traceEvents"].append(
        {"ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
         "args": {"name": "phase"}})
    n = 0
    for ph in phases:
        trace["traceEvents"].append(
            {"ph": "X", "pid": pid, "tid": 1, "name": ph["phase"],
             "cat": "day", "ts": round((ph["start"] - t0) * 1e6, 3),
             "dur": round(ph["dur_s"] * 1e6, 3),
             "args": {"rate_rps": ph.get("rate_rps")}})
        n += 1
    windows = tv_audit.cause_windows(events_by_pid)
    tid = 1
    for cause in tv_audit.CAUSES:
        spans = windows.get(cause) or []
        if not spans:
            continue
        tid += 1
        trace["traceEvents"].append(
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
             "args": {"name": f"cause: {cause}"}})
        for lo, hi in spans:
            trace["traceEvents"].append(
                {"ph": "X", "pid": pid, "tid": tid, "name": cause,
                 "cat": "day", "ts": round((lo - t0) * 1e6, 3),
                 "dur": round(max(0.0, hi - lo) * 1e6, 3),
                 "args": {}})
            n += 1
    return n


def _migrate_pairs(mig_spans: "list[dict]") -> "dict[str, set]":
    """``{span_id: {directions seen}}`` over kv.migrate spans."""
    pairs: "dict[str, set]" = {}
    for ev in mig_spans:
        sid = ev.get("span_id")
        if sid:
            pairs.setdefault(sid, set()).add(ev.get("direction"))
    return pairs


def summarize_trace(run_dir: str) -> dict:
    """Everything --check and the text summary need, in one read."""
    events_by_pid = tv_events.read_run(run_dir)
    offsets = tv_trace.estimate_clock_offsets(events_by_pid)
    completeness = tv_trace.trace_completeness(events_by_pid)
    return {"events_by_pid": events_by_pid, "offsets": offsets,
            "completeness": completeness,
            "torn_tails": _torn_tails(run_dir)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", help="telemetry run directory")
    ap.add_argument("-o", "--out", default=None,
                    help="output trace path (default "
                         "<RUN_DIR>/trace.json)")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: corrupt files / missing generations "
                         "/ unassemblable trace exit non-zero")
    ap.add_argument("--pipeline", action="store_true",
                    help="append analytic per-stage pipeline tracks "
                         "for pipeline.schedule events")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON")
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, "torch_trace_report")

    if not os.path.isdir(args.target):
        print(f"trace_report: {args.target} is not a directory",
              file=sys.stderr)
        return 2
    try:
        info = summarize_trace(args.target)
    except tv_events.EventLogCorruptError as e:
        print(f"trace_report: CORRUPT event log: {e}", file=sys.stderr)
        return 1
    events_by_pid = info["events_by_pid"]
    if not events_by_pid:
        print(f"trace_report: no events-*.jsonl under {args.target}",
              file=sys.stderr)
        return 2

    trace = tv_trace.assemble_trace(
        events_by_pid, offsets=info["offsets"],
        run_id=os.path.basename(os.path.normpath(args.target)))
    n_pipeline = (_pipeline_tracks(events_by_pid, trace)
                  if args.pipeline else 0)
    n_day = _day_tracks(events_by_pid, trace, info["offsets"])
    out_path = args.out or os.path.join(args.target, "trace.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")

    comp = info["completeness"]
    meta = trace["otherData"]
    # kv.migrate export/adopt spans pair up by span_id (kvmig/<rid>):
    # a pair crossing two pids is one rendered migration arrow
    mig_spans = [ev for evs in events_by_pid.values() for ev in evs
                 if ev.get("ev") == "kv.migrate"]
    mig_pairs = sum(
        1 for sid, dirs in _migrate_pairs(mig_spans).items()
        if "export" in dirs and "adopt" in dirs)
    # router re-routes: every request already threads one
    # req/<rid> flow chain (router.route -> serve.admit -> ... ->
    # serve.request); a re-routed rid's chain ALSO crosses from the
    # dead replica's spans to the survivor's — count those arrows
    rr_rids = {ev.get("id") for evs in events_by_pid.values()
               for ev in evs if ev.get("ev") == "router.reroute"}
    rr_rids.discard(None)
    rr_cross = 0
    if rr_rids:
        pids_by_rid: dict = {}
        for pid, evs in events_by_pid.items():
            for ev in evs:
                rid = ev.get("id")
                if rid in rr_rids and str(ev.get("ev", "")
                                          ).startswith("serve."):
                    pids_by_rid.setdefault(rid, set()).add(pid)
        rr_cross = sum(1 for p in pids_by_rid.values() if len(p) >= 2)
    summary = {
        "trace": out_path,
        "processes": meta["processes"],
        "events": sum(len(v) for v in events_by_pid.values()),
        "flow_links": meta["flow_links"],
        "clock_offsets_s": meta["clock_offsets_s"],
        "clock_unaligned": meta["clock_unaligned"],
        "generations": comp["generations"],
        "missing_generations": comp["missing"],
        "torn_tails": info["torn_tails"],
        "pipeline_spans": n_pipeline,
        "day_spans": n_day,
        "kv_migrate_spans": len(mig_spans),
        "kv_migrate_pairs": mig_pairs,
        "router_reroute_spans": len(rr_rids),
        "router_reroute_cross_replica": rr_cross,
    }
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(f"trace written: {out_path}")
        print(f"  processes: {', '.join(meta['processes'])}")
        print(f"  events: {summary['events']}  "
              f"flow links: {meta['flow_links']}")
        offs = ", ".join(f"p{p}={v * 1e3:+.2f}ms"
                         for p, v in meta["clock_offsets_s"].items())
        print(f"  clock offsets vs reference: {offs}"
              + (f"  (unaligned: {meta['clock_unaligned']})"
                 if meta["clock_unaligned"] else ""))
        for g, d in comp["generations"].items():
            print(f"  gen {g}: {d['worker_events']} worker events "
                  f"from pids {d['pids']}")
        for path in info["torn_tails"]:
            print(f"  torn tail tolerated: {path}")
        if n_pipeline:
            print(f"  pipeline: {n_pipeline} analytic stage spans")
        if n_day:
            print(f"  production day: {n_day} phase + cause-window "
                  f"spans")
        if mig_spans:
            print(f"  kv.migrate: {len(mig_spans)} spans, "
                  f"{mig_pairs} export->adopt flow arrows")
        if rr_rids:
            print(f"  router: {len(rr_rids)} re-routed request "
                  f"span(s), {rr_cross} crossing replicas "
                  f"(req/<rid> flow arrows)")
        print("  open at https://ui.perfetto.dev or chrome://tracing")

    if args.check:
        rc = 0
        if comp["missing"]:
            print(f"trace_report: INCOMPLETE — generations "
                  f"{comp['missing']} left no mergeable worker events",
                  file=sys.stderr)
            rc = 1
        try:
            with open(out_path, "r", encoding="utf-8") as f:
                json.load(f)
        except ValueError as e:
            print(f"trace_report: assembled trace is not valid JSON: "
                  f"{e}", file=sys.stderr)
            rc = 1
        if rc == 0:
            print(f"trace check ok: {len(meta['processes'])} processes, "
                  f"generations {sorted(comp['generations'])} all "
                  f"mergeable"
                  + (f", {len(info['torn_tails'])} torn tail(s) "
                     f"tolerated" if info["torn_tails"] else ""))
        return rc
    return 0


if __name__ == "__main__":
    rc = main()
    torch_entry.write_report()
    sys.exit(rc)

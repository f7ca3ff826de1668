#!/usr/bin/env python3
"""Render a run's telemetry (JSONL event logs + fleet rollups) into a
human-readable observability report.

On the port: the counterpart of ``tools/obs_report.py``, whose output
it gives byte for byte on the same run directory (either package's);
it adds only ``--device`` (default ``cuda``, as every port script).

Usage::

    python3 tools/torch_obs_report.py RUN_DIR            # text report
    python3 tools/torch_obs_report.py RUN_DIR --json     # machine-readable
    python3 tools/torch_obs_report.py RUN_DIR --check    # validate event logs

``RUN_DIR`` is the directory passed to ``telemetry.configure`` (or
``DTX_TELEMETRY_DIR``): it holds one ``events-<pid>.jsonl`` per process
and, when a FleetAggregator ran, TensorBoard event files with the
``fleet/*`` scalar rollups. A single ``.jsonl`` file also works.

The report answers the operator questions the event schema was designed
for: step-time p50/p95/p99, infeed-wait fraction of step time, dispatch
retries/failures by worker, chaos fault firings by site, checkpoint
save/restore durations, any ``stall.suspected`` events, and — for
supervised elastic runs — the ``recovery.*`` timeline (worker deaths,
straggler kills, restarts, generation starts) written by the recovery
supervisor into ``events-supervisor.jsonl``.

``--check`` is the CI gate: exit 0 when every event file parses (a torn
FINAL line — a crashed writer — is tolerated and reported), non-zero on
malformed or mid-file-corrupt JSONL. ``--require NAME`` (repeatable)
additionally fails the check unless at least one event named ``NAME``
(or under the ``NAME.`` namespace) appears anywhere in the run — e.g.
``--check --require recovery.restart`` is how ``chaos_sweep --kill``
asserts that a swept run actually recorded a recovery.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))
import torch_entry  # noqa: E402

from distributed_tensorflow_tpu_torch.telemetry.events import (  # noqa: E402
    EventLogCorruptError, read_events)
from distributed_tensorflow_tpu_torch.telemetry.trace import (  # noqa: E402
    classify_run)

#: train.step phase fields (seconds) accumulated into the attribution
#: table; emitted by StepTelemetry(phases=...) / the elastic worker.
_PHASE_FIELDS = ("compute_s", "collective_s", "infeed_wait_s", "host_s",
                 "ckpt_block_s")


def _event_files(target: str) -> list[str]:
    if os.path.isfile(target):
        return [target]
    files = sorted(glob.glob(os.path.join(target, "events-*.jsonl")))
    return files


def _percentiles(values: list[float]) -> dict:
    if not values:
        return {}
    s = sorted(values)

    def pct(q):
        return s[min(len(s) - 1, max(0, int(round(q / 100 * (len(s) - 1)))))]

    return {"count": len(s), "mean": sum(s) / len(s),
            "p50": pct(50), "p95": pct(95), "p99": pct(99),
            "max": s[-1]}


def _torn_tail(path: str) -> bool:
    """True when the file's final line is malformed (torn by a crashed
    writer) — tolerated, but worth reporting."""
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        if not lines:
            return False
        json.loads(lines[-1])
        return False
    except ValueError:
        return True


def summarize(events_by_pid: "dict[int, list[dict]]") -> dict:
    """Aggregate a run's events into the report structure."""
    steps: list[float] = []
    infeed_wait = 0.0
    step_time_total = 0.0
    phase_totals = {k: 0.0 for k in _PHASE_FIELDS}
    phase_seen = {k: False for k in _PHASE_FIELDS}
    step_rows: list[dict] = []
    overlap_effs: list[float] = []
    retries = collections.Counter()
    failures = collections.Counter()
    faults_by_site = collections.Counter()
    ckpt = collections.defaultdict(list)
    stalls: list[dict] = []
    recovery: list[dict] = []
    per_pid: dict[int, dict] = {}
    wall_min = wall_max = None
    serve_latency: list[float] = []
    serve_steps = 0
    serve_tokens = 0
    serve_prompt_tokens = 0
    serve_cached_tokens = 0
    serve_drafts_proposed = 0
    serve_drafts_accepted = 0
    # multi-tenant router: router.* + tenant-stamped serve.*
    router_routes = collections.Counter()     # route reason -> n
    router_reroutes = collections.Counter()   # reroute cause -> n
    router_sheds = collections.Counter()      # tenant -> shed ticks
    router_rejects = collections.Counter()    # "tenant/cause" -> n
    router_tenants: dict = {}                 # tenant -> summary event
    router_resumes = 0
    class_latency: dict = {}                  # pclass -> [dur_s]
    # online streaming: stream.* / embed.* telemetry
    online_produced = 0            # newest produced offset
    online_produced_wall = None
    online_applied = 0             # newest applied offset
    online_applied_wall = None
    online_events = 0              # events applied (sum of batch n)
    online_first_apply = online_last_apply = None
    online_committed = 0
    online_freshness: list[float] = []
    online_lag_events = None       # last published snapshot's lag
    online_snapshots = 0
    online_tables: dict = {}       # table -> latest embed.update

    # the supervisor writes under pid "supervisor": sort keys as strings
    for pid, events in sorted(events_by_pid.items(), key=lambda kv:
                              str(kv[0])):
        pid_steps: list[float] = []
        pid_wait = 0.0
        for ev in events:
            name = ev.get("ev")
            w = ev.get("wall")
            if isinstance(w, (int, float)):
                wall_min = w if wall_min is None else min(wall_min, w)
                wall_max = w if wall_max is None else max(wall_max, w)
            if name == "train.step":
                d = ev.get("dur_s")
                if isinstance(d, (int, float)):
                    pid_steps.append(d)
                    step_time_total += d
                w = ev.get("infeed_wait_s")
                if isinstance(w, (int, float)):
                    pid_wait += w
                    phase_totals["infeed_wait_s"] += w
                    phase_seen["infeed_wait_s"] = True
                row = {"pid": pid, "step": ev.get("step"),
                       "gen": ev.get("gen", 0), "dur_s": d}
                for k in _PHASE_FIELDS:
                    if k == "infeed_wait_s":
                        continue
                    v = ev.get(k)
                    if isinstance(v, (int, float)):
                        phase_totals[k] += v
                        phase_seen[k] = True
                        row[k] = v
                wv = ev.get("infeed_wait_s")
                if isinstance(wv, (int, float)):
                    row["infeed_wait_s"] = wv
                oe = ev.get("overlap_eff")
                if isinstance(oe, (int, float)):
                    overlap_effs.append(oe)
                    row["overlap_eff"] = oe
                step_rows.append(row)
            elif name == "dispatch.retry":
                retries[f"worker {ev.get('worker')}"] += 1
            elif name in ("dispatch.failure", "dispatch.closure_error",
                          "worker.closure_error"):
                failures[name] += 1
            elif name == "dispatch.preempted":
                retries[f"worker {ev.get('worker')} (preempted)"] += 1
            elif name == "fault.fired":
                faults_by_site[ev.get("site", "?")] += 1
            elif name in ("checkpoint.save", "checkpoint.restore",
                          "checkpoint.commit"):
                d = ev.get("dur_s")
                if isinstance(d, (int, float)):
                    ckpt[name].append(d)
            elif name == "serve.request":
                d = ev.get("dur_s")
                if isinstance(d, (int, float)):
                    serve_latency.append(d)
                    if ev.get("tenant"):
                        class_latency.setdefault(
                            ev.get("pclass") or "?", []).append(d)
                nt = ev.get("new_tokens")
                if isinstance(nt, (int, float)):
                    serve_tokens += int(nt)
            elif name == "serve.step":
                serve_steps += 1
                p = ev.get("proposed_drafts")
                if isinstance(p, (int, float)):
                    serve_drafts_proposed += int(p)
                a = ev.get("accepted_drafts")
                if isinstance(a, (int, float)):
                    serve_drafts_accepted += int(a)
            elif name == "serve.prefill":
                pt = ev.get("prompt_tokens")
                if isinstance(pt, (int, float)):
                    serve_prompt_tokens += int(pt)
                ct = ev.get("cached_tokens")
                if isinstance(ct, (int, float)):
                    serve_cached_tokens += int(ct)
            elif name == "router.route":
                router_routes[ev.get("reason") or "?"] += 1
            elif name == "router.reroute":
                router_reroutes[ev.get("cause") or "?"] += 1
            elif name == "router.shed":
                router_sheds[ev.get("tenant") or "?"] += 1
            elif name == "serve.reject":
                router_rejects[f"{ev.get('tenant') or '-'}"
                               f"/{ev.get('cause') or '-'}"] += 1
            elif name == "router.tenant":
                router_tenants[ev.get("tenant") or "?"] = {
                    k: ev.get(k) for k in
                    ("pclass", "admitted", "rejected_quota",
                     "rejected_total", "sheds", "tokens_admitted",
                     "quota_utilization")}
            elif name == "router.resume":
                router_resumes += 1
            elif name == "stream.produced":
                o = ev.get("offset")
                if isinstance(o, (int, float)) and o >= online_produced:
                    online_produced = int(o)
                    online_produced_wall = ev.get("wall")
            elif name == "stream.batch_applied":
                hi = ev.get("hi")
                if isinstance(hi, (int, float)) \
                        and hi >= online_applied:
                    online_applied = int(hi)
                    online_applied_wall = ev.get("wall")
                n = ev.get("n")
                if isinstance(n, (int, float)):
                    online_events += int(n)
                if isinstance(w, (int, float)):
                    online_first_apply = (w if online_first_apply is None
                                          else online_first_apply)
                    online_last_apply = w
            elif name == "stream.commit":
                o = ev.get("offset")
                if isinstance(o, (int, float)):
                    online_committed = max(online_committed, int(o))
            elif name == "stream.snapshot_published":
                online_snapshots += 1
                f = ev.get("freshness_s")
                if isinstance(f, (int, float)):
                    online_freshness.append(f)
                lag = ev.get("lag_events")
                if isinstance(lag, (int, float)):
                    online_lag_events = int(lag)
            elif name == "embed.update":
                online_tables[ev.get("table", "?")] = {
                    k: ev.get(k) for k in
                    ("capacity", "mapped", "admissions", "evictions",
                     "grows")}
            elif name == "stall.suspected":
                stalls.append({k: ev.get(k) for k in
                               ("pid", "stalled_s", "median_step_s",
                                "suspect_worker", "suspect_reason",
                                "badput_bucket")})
            elif isinstance(name, str) and name.startswith("recovery."):
                recovery.append(ev)
        steps.extend(pid_steps)
        infeed_wait += pid_wait
        per_pid[pid] = {"events": len(events),
                        "steps": len(pid_steps),
                        "step_time": _percentiles(pid_steps),
                        "infeed_wait_s": round(pid_wait, 6)}

    # failure-domain annotation: the day driver's
    # day.topology event carries the {pid: rack} placement map; stamp
    # it onto every recovery event so the timeline shows WHICH rack a
    # death/restore belonged to (correlated kills become visible as one
    # domain repeating)
    domain_map: dict = {}
    for events in events_by_pid.values():
        for ev in events:
            if ev.get("ev") == "day.topology":
                domain_map.update(ev.get("domains") or {})
    if domain_map:
        for ev in recovery:
            if ev.get("domain") is None:
                tid = ev.get("task_id", ev.get("pid"))
                dom = domain_map.get(str(tid))
                if dom is not None:
                    ev["domain"] = dom

    recovery.sort(key=lambda ev: ev.get("wall", 0.0))
    restore_tiers = collections.Counter(
        ev.get("tier", "?") for ev in recovery
        if ev.get("ev") == "recovery.restore_tier"
        and ev.get("tier") != "none")      # "none" = cold start
    mttrs = recovery_mttrs(recovery)

    # -- step-phase attribution + bottleneck class -------------
    # checkpoint blocking is attributable two ways: the per-step
    # ckpt_block_s phase (when the step loop emits it) and the
    # checkpoint.save span durations (always emitted). Take the larger —
    # they measure the same blocking from two vantage points.
    ckpt_block = max(phase_totals["ckpt_block_s"],
                     sum(ckpt.get("checkpoint.save", [])))
    wall_span = ((wall_max - wall_min)
                 if wall_min is not None and wall_max is not None else 0.0)
    fractions = {}
    phases_report = None
    if step_time_total > 0:
        fractions = {
            "infeed": phase_totals["infeed_wait_s"] / step_time_total,
            "collective": phase_totals["collective_s"] / step_time_total,
            "checkpoint": ckpt_block / step_time_total,
            "recovery": (sum(mttrs.values()) / wall_span
                         if wall_span > 0 else 0.0),
        }
        if phase_seen["compute_s"]:
            compute_frac = phase_totals["compute_s"] / step_time_total
        else:
            # no measured compute phase: compute is the remainder after
            # every attributed non-compute phase
            others = sum(phase_totals[k] for k in (
                "collective_s", "infeed_wait_s", "host_s",
                "ckpt_block_s"))
            compute_frac = max(0.0, 1.0 - others / step_time_total)
        phases_report = {
            "step_time_total_s": round(step_time_total, 6),
            "fractions": {
                "compute": round(compute_frac, 4),
                "collective": round(fractions["collective"], 4),
                "infeed_wait": round(fractions["infeed"], 4),
                "host": round(phase_totals["host_s"] / step_time_total,
                              4),
                "ckpt_block": round(ckpt_block / step_time_total, 4),
            },
            "attributed": {k: phase_seen[k] for k in _PHASE_FIELDS},
            "overlap_eff": (round(sum(overlap_effs) / len(overlap_effs),
                                  4) if overlap_effs else None),
        }
    bottleneck = classify_run(fractions) if fractions else None

    # -- production-day audit ---------------------------------
    # only when a day driver ran: phase markers make the cause windows
    # and the per-phase goodput cut meaningful
    day_report = None
    if any(ev.get("ev") == "day.phase" for evs in events_by_pid.values()
           for ev in evs):
        from distributed_tensorflow_tpu_torch.telemetry import audit as _audit
        a = _audit.audit_day(events_by_pid)
        day_report = {
            "phases": a["phases"],
            "slos": {
                name: {"requests": res["requests"], "bad": res["bad"],
                       "budget_consumed": res["budget_consumed"],
                       "by_cause": res["by_cause"],
                       "unattributed": res["unattributed"]}
                for name, res in a["slos"].items()},
            "max_unattributed_frac": a["max_unattributed_frac"],
            "rack_loss": a["rack_loss"],
            "requests": a["requests"],
        }

    # -- goodput/badput ledger --------------------------------
    from distributed_tensorflow_tpu_torch.telemetry import goodput as _goodput
    ledger = _goodput.ledger_from_events(events_by_pid)
    goodput_report = None
    if ledger["wall_s"] > 0:
        goodput_report = {
            "wall_s": round(ledger["wall_s"], 6),
            "goodput_s": round(ledger["goodput_s"], 6),
            "goodput_frac": round(ledger["goodput_frac"], 4),
            "badput_s": {b: round(v, 6)
                         for b, v in ledger["badput_s"].items()},
            "identity_error_s": round(ledger["identity_error_s"], 6),
        }

    return {
        "processes": per_pid,
        "step_time": _percentiles(steps),
        "serving": {
            "requests": len(serve_latency),
            "steps": serve_steps,
            "request_latency": _percentiles(serve_latency),
            "tokens_generated": serve_tokens,
            # serving-speed telemetry: absent fields mean
            # the feature never fired in this run
            "prompt_tokens": serve_prompt_tokens,
            "cache_hit_tokens": serve_cached_tokens,
            "cache_hit_rate": (round(serve_cached_tokens
                                     / serve_prompt_tokens, 4)
                               if serve_prompt_tokens else None),
            "drafts_proposed": serve_drafts_proposed,
            "drafts_accepted": serve_drafts_accepted,
            "accepted_draft_rate": (round(serve_drafts_accepted
                                          / serve_drafts_proposed, 4)
                                    if serve_drafts_proposed else None),
        } if (serve_latency or serve_steps) else None,
        "router": {
            "routes": sum(router_routes.values()),
            "route_reasons": dict(router_routes),
            "reroutes": dict(router_reroutes),
            "sheds": dict(router_sheds),
            "rejects_by_tenant_cause": dict(router_rejects),
            "resumes": router_resumes,
            "tenants": router_tenants,
            "class_latency": {pc: _percentiles(v)
                              for pc, v in sorted(
                                  class_latency.items())},
        } if (router_routes or router_rejects
              or router_tenants) else None,
        "online": {
            "events_produced": online_produced,
            "events_applied": online_events,
            "applied_offset": online_applied,
            "committed_offset": online_committed,
            "events_per_sec": (round(
                online_events / (online_last_apply
                                 - online_first_apply), 1)
                if online_first_apply is not None
                and online_last_apply is not None
                and online_last_apply > online_first_apply else None),
            # current lag: newest produced offset minus newest applied,
            # in events AND seconds (production wall vs apply wall)
            "lag_events": (online_produced - online_applied
                           if online_produced else None),
            "lag_s": (round(max(0.0, online_produced_wall
                                - online_applied_wall), 3)
                      if isinstance(online_produced_wall, (int, float))
                      and isinstance(online_applied_wall, (int, float))
                      else None),
            "snapshots_published": online_snapshots,
            "snapshot_lag_events": online_lag_events,
            "freshness": _percentiles(online_freshness),
            "tables": online_tables,
        } if (online_produced or online_applied
              or online_snapshots) else None,
        "phases": phases_report,
        "goodput": goodput_report,
        "day": day_report,
        "domains": domain_map or None,
        "bottleneck": bottleneck,
        "steps_table": step_rows,
        "infeed_wait_fraction": (round(infeed_wait / step_time_total, 4)
                                 if step_time_total > 0 else None),
        "retries": dict(retries),
        "failures": dict(failures),
        "fault_firings": dict(faults_by_site),
        "checkpoint_durations": {
            k: _percentiles(v) for k, v in sorted(ckpt.items())},
        "stalls_suspected": stalls,
        "recovery_timeline": recovery,
        "recovery": {
            "restarts": sum(1 for ev in recovery
                            if ev.get("ev") == "recovery.restart"),
            "worker_deaths": sum(1 for ev in recovery
                                 if ev.get("ev") ==
                                 "recovery.worker_death"),
            "completed": any(ev.get("ev") == "recovery.run_complete"
                             for ev in recovery),
            "failed": any(ev.get("ev") == "recovery.failed"
                          for ev in recovery),
            "reshards": sum(1 for ev in recovery
                            if ev.get("ev") == "recovery.reshard"),
            "restore_tiers": dict(restore_tiers),
            "mttr_s": mttrs,
        } if recovery else None,
    }


def recovery_mttrs(recovery: "list[dict]") -> "dict[int, float]":
    """Per-recovery MTTR over the recovery timeline: for each reformed
    generation g, wall time from the FIRST ``recovery.worker_death`` of
    generation g-1 to the moment the new generation is restored — the
    last ``recovery.restore_tier`` event of generation g when workers
    emitted one, else the supervisor's ``recovery.generation_start``.
    Returns {generation: mttr_seconds}."""
    death_start: dict[int, float] = {}
    resumed: dict[int, float] = {}
    for ev in recovery:
        wall, name = ev.get("wall"), ev.get("ev")
        gen = ev.get("generation")
        if not isinstance(wall, (int, float)) or gen is None:
            continue
        if name == "recovery.worker_death":
            death_start.setdefault(int(gen), wall)
            death_start[int(gen)] = min(death_start[int(gen)], wall)
        elif name == "recovery.restore_tier":
            resumed[int(gen)] = max(resumed.get(int(gen), wall), wall)
        elif name == "recovery.generation_start":
            resumed.setdefault(int(gen), wall)
    return {g + 1: round(resumed[g + 1] - w0, 3)
            for g, w0 in sorted(death_start.items())
            if g + 1 in resumed}


def read_rollup_scalars(target: str) -> dict:
    """Latest value of every ``fleet/*`` scalar in the run directory's
    TensorBoard event files (absent aggregator -> {})."""
    if not os.path.isdir(target):
        return {}
    from distributed_tensorflow_tpu_torch.utils.summary import read_scalars
    latest: dict[str, tuple[int, float]] = {}
    for path in sorted(glob.glob(os.path.join(target,
                                              "events.out.tfevents.*"))):
        try:
            for tag, step, value in read_scalars(path):
                if not tag.startswith("fleet/"):
                    continue
                if tag not in latest or step >= latest[tag][0]:
                    latest[tag] = (step, value)
        except ValueError:
            continue                    # torn event file: skip it
    return {tag: v for tag, (s, v) in sorted(latest.items())}


def _fmt_ms(seconds) -> str:
    return f"{seconds * 1e3:.2f}ms" if seconds is not None else "-"


def _fmt_recovery_line(ev: dict) -> str:
    name = ev.get("ev", "?")
    t = ev.get("t")
    head = f"  t+{t:8.3f}s " if isinstance(t, (int, float)) else "  "
    gen = ev.get("generation")
    dom = ev.get("domain")
    head += f"{'[' + str(dom) + ']':<9}" if dom is not None else ""
    tail = [name] + ([f"gen{gen}"] if gen is not None else [])
    if name == "recovery.worker_death":
        tail.append(f"{ev.get('task_type')}:{ev.get('task_id')} "
                    f"{ev.get('kind')} exit={ev.get('exitcode')}")
    elif name == "recovery.chaos_kill":
        tail.append(f"worker {ev.get('worker')} at step "
                    f"{ev.get('at_step')}")
    elif name == "recovery.kill_straggler":
        tail.append(f"{ev.get('task_type')}:{ev.get('task_id')}")
    elif name == "recovery.restart":
        tail.append(f"restart #{ev.get('restart')} "
                    f"(budget left {ev.get('budget_left')}, "
                    f"backoff {ev.get('backoff_s')}s)")
    elif name == "recovery.recover":
        tail.append(f"recovered in {_fmt_ms(ev.get('dur_s'))}")
    elif name == "recovery.restore_tier":
        if ev.get("tier") == "none":
            tail.append(f"p{ev.get('pid')} cold start "
                        f"(nothing to restore)")
        else:
            tail.append(f"p{ev.get('pid')} restored from "
                        f"{ev.get('tier')} tier at step {ev.get('step')}"
                        + (" (resharded)" if ev.get("resharded") else ""))
    elif name == "recovery.reshard":
        tail.append(f"shrink {ev.get('old_workers')}->"
                    f"{ev.get('new_workers')} workers "
                    f"(task {ev.get('removed_task')} gone for good)")
    elif name == "recovery.run_complete":
        tail.append(f"restarts={ev.get('restarts')}")
    elif name == "recovery.failed":
        tail.append(f"restarts={ev.get('restarts')} "
                    f"failures={ev.get('failures')}")
    return head + " ".join(str(p) for p in tail)


def _render_phase_table(report: dict, out: "list[str]",
                        max_rows: int = 40):
    """Per-step phase table (every k-th step when the run is long) and
    the phase-fraction summary + named bottleneck class."""
    ph = report.get("phases")
    if not ph:
        return
    fr = ph["fractions"]
    out.append("phase attribution (fraction of total step time):")
    out.append("  " + "  ".join(f"{k} {v:.1%}"
                                for k, v in fr.items()))
    if ph.get("overlap_eff") is not None:
        out.append(f"  collective overlap efficiency "
                   f"{ph['overlap_eff']:.1%} (share of collective time "
                   f"hidden behind backward)")
    rows = [r for r in report.get("steps_table", [])
            if any(k in r for k in _PHASE_FIELDS)]
    if rows:
        stride = max(1, (len(rows) + max_rows - 1) // max_rows)
        if stride > 1:
            out.append(f"per-step phases (every {stride}th step of "
                       f"{len(rows)}):")
        else:
            out.append("per-step phases:")
        hdr = (f"  {'pid':>4} {'gen':>3} {'step':>6} {'dur':>9} "
               f"{'compute':>9} {'collect':>9} {'infeed':>9} "
               f"{'host':>9} {'ckpt':>9}")
        out.append(hdr)
        for r in rows[::stride]:
            def cell(key):
                v = r.get(key)
                return _fmt_ms(v) if isinstance(v, (int, float)) else "-"
            out.append(
                f"  {str(r['pid']):>4} {r.get('gen', 0):>3} "
                f"{str(r.get('step', '-')):>6} {cell('dur_s'):>9} "
                f"{cell('compute_s'):>9} {cell('collective_s'):>9} "
                f"{cell('infeed_wait_s'):>9} {cell('host_s'):>9} "
                f"{cell('ckpt_block_s'):>9}")
    b = report.get("bottleneck")
    if b:
        why = ("; ".join(b["reasons"]) if b["reasons"]
               else "no phase exceeded its threshold")
        out.append(f"bottleneck: {b['class']} ({why})")


def render_text(report: dict, rollup: dict) -> str:
    out = []
    st = report["step_time"]
    out.append("== telemetry report ==")
    out.append(f"processes: {len(report['processes'])}  "
               f"steps: {st.get('count', 0)}")
    if st:
        out.append(f"step time   p50 {_fmt_ms(st['p50'])}  "
                   f"p95 {_fmt_ms(st['p95'])}  p99 {_fmt_ms(st['p99'])}  "
                   f"max {_fmt_ms(st['max'])}")
    if report["infeed_wait_fraction"] is not None:
        out.append(f"infeed wait {report['infeed_wait_fraction']:.1%} "
                   f"of step time")
    if report.get("serving"):
        sv = report["serving"]
        lat = sv["request_latency"]
        out.append(f"serving: {sv['requests']} request(s) over "
                   f"{sv['steps']} serve step(s), "
                   f"{sv['tokens_generated']} tokens generated")
        if lat:
            out.append(f"request latency  p50 {_fmt_ms(lat['p50'])}  "
                       f"p95 {_fmt_ms(lat['p95'])}  "
                       f"p99 {_fmt_ms(lat['p99'])}  "
                       f"max {_fmt_ms(lat['max'])}")
        if sv.get("cache_hit_rate") is not None \
                and sv.get("cache_hit_tokens"):
            out.append(f"prefix cache  hit rate "
                       f"{sv['cache_hit_rate']:.1%} "
                       f"({sv['cache_hit_tokens']}/"
                       f"{sv['prompt_tokens']} prompt tokens served "
                       f"from cache)")
        if sv.get("drafts_proposed"):
            out.append(f"speculation   accepted rate "
                       f"{sv['accepted_draft_rate']:.1%} "
                       f"({sv['drafts_accepted']}/"
                       f"{sv['drafts_proposed']} draft tokens)")
    if report.get("router"):
        rt = report["router"]
        reasons = "  ".join(f"{k} {v}" for k, v in
                            sorted(rt["route_reasons"].items()))
        line = f"router: {rt['routes']} routed"
        if reasons:
            line += f" ({reasons})"
        if rt["reroutes"]:
            causes = "  ".join(f"{k} {v}" for k, v in
                               sorted(rt["reroutes"].items()))
            line += (f", {sum(rt['reroutes'].values())} "
                     f"rerouted ({causes})")
        if rt["resumes"]:
            line += f", {rt['resumes']} journal resume(s)"
        out.append(line)
        for pc, lat in rt["class_latency"].items():
            out.append(f"  {pc:<12} p50 {_fmt_ms(lat['p50'])}  "
                       f"p95 {_fmt_ms(lat['p95'])}  "
                       f"p99 {_fmt_ms(lat['p99'])}  "
                       f"max {_fmt_ms(lat['max'])}  "
                       f"({lat['count']} served)")
        for name, t in sorted(rt["tenants"].items()):
            qu = t.get("quota_utilization")
            out.append(f"  tenant {name} ({t.get('pclass')}): "
                       f"{t.get('admitted')} admitted "
                       f"({t.get('tokens_admitted')} tokens), "
                       f"{t.get('rejected_total')} rejected, "
                       f"{t.get('sheds')} shed tick(s)"
                       + (f", quota {qu:.1%} used"
                          if isinstance(qu, (int, float)) else ""))
        if rt["rejects_by_tenant_cause"]:
            rej = "  ".join(
                f"{k} {v}" for k, v in
                sorted(rt["rejects_by_tenant_cause"].items()))
            out.append(f"  rejects by tenant/cause: {rej}")
        if rt["sheds"]:
            sh = "  ".join(f"{k} {v}" for k, v in
                           sorted(rt["sheds"].items()))
            out.append(f"  shed ticks by tenant: {sh}")
    if report.get("online"):
        on = report["online"]
        out.append(f"online: {on['events_applied']} event(s) applied "
                   f"(offset {on['applied_offset']}, committed "
                   f"{on['committed_offset']}) of "
                   f"{on['events_produced']} produced"
                   + (f", {on['events_per_sec']:g} events/s"
                      if on.get("events_per_sec") else ""))
        lag_bits = []
        if on.get("lag_events") is not None:
            lag_bits.append(f"{on['lag_events']} event(s)")
        if on.get("lag_s") is not None:
            lag_bits.append(f"{on['lag_s']:g}s")
        if lag_bits:
            out.append("  lag (produced - applied): "
                       + ", ".join(lag_bits))
        fr = on.get("freshness")
        if fr:
            out.append(f"  freshness (update->servable)  "
                       f"p50 {fr['p50']:.3f}s  p99 {fr['p99']:.3f}s  "
                       f"max {fr['max']:.3f}s over "
                       f"{on['snapshots_published']} snapshot(s)"
                       + (f", last lag "
                          f"{on['snapshot_lag_events']} event(s)"
                          if on.get("snapshot_lag_events") is not None
                          else ""))
        for name, t in sorted(on.get("tables", {}).items()):
            out.append(f"  table {name}: {t.get('mapped')}/"
                       f"{t.get('capacity')} rows mapped, "
                       f"{t.get('admissions')} admitted, "
                       f"{t.get('evictions')} evicted, "
                       f"{t.get('grows')} grow(s)")
    _render_phase_table(report, out)
    gp = report.get("goodput")
    if gp:
        bad = "  ".join(f"{b} {v / gp['wall_s']:.1%}"
                        for b, v in gp["badput_s"].items() if v > 0)
        out.append(f"goodput {gp['goodput_frac']:.1%} of "
                   f"{gp['wall_s']:.1f}s hardware time"
                   + (f"  (badput: {bad})" if bad else "")
                   + "  — details: tools/health_report.py")
    day = report.get("day")
    if day:
        out.append("production day (telemetry/audit.py):")
        if day.get("phases"):
            out.append(f"  {'phase':<12} {'dur':>7} {'hw-sec':>8} "
                       f"{'goodput':>8}")
            for ph in day["phases"]:
                gf = (f"{ph['goodput_frac']:.1%}"
                      if ph.get("goodput_frac") is not None else "-")
                out.append(f"  {ph['phase']:<12} {ph['dur_s']:6.2f}s "
                           f"{ph['wall_s']:7.2f}s {gf:>8}")
        out.append("  SLO budget spend by cause:")
        for name, res in day["slos"].items():
            out.append(f"    {name}: {res['bad']}/{res['requests']} "
                       f"bad, {res['budget_consumed']:.2f}x budget")
            for cause, c in res["by_cause"].items():
                if c["bad"]:
                    out.append(f"      {cause:<16} {c['bad']:>5} bad "
                               f"({c['budget_consumed']:.2f}x)")
            un = res["unattributed"]
            if un["bad"]:
                out.append(f"      {'UNATTRIBUTED':<16} "
                           f"{un['bad']:>5} bad "
                           f"({un['frac_of_bad']:.1%} of bad)")
        rack = day.get("rack_loss")
        if rack:
            mttr = (f"{rack['mttr_s']:.3f}s"
                    if rack.get("mttr_s") is not None else "unrecovered")
            out.append(f"  rack loss: {rack['domain']} (victims "
                       f"{rack['victims']}), MTTR {mttr}, restored "
                       f"from {rack['restore_tiers']} "
                       f"[{'WARM' if rack['warm'] else 'COLD'}]")
    for pid, info in sorted(report["processes"].items(),
                            key=lambda kv: str(kv[0])):
        p = info["step_time"]
        out.append(f"  [p{pid}] {info['events']} events, "
                   f"{info['steps']} steps"
                   + (f", step p50 {_fmt_ms(p['p50'])}" if p else ""))
    if report["retries"]:
        out.append("retries:")
        for site, n in sorted(report["retries"].items()):
            out.append(f"  {site}: {n}")
    if report["failures"]:
        out.append("failures:")
        for kind, n in sorted(report["failures"].items()):
            out.append(f"  {kind}: {n}")
    if report["fault_firings"]:
        out.append("chaos fault firings:")
        for site, n in sorted(report["fault_firings"].items()):
            out.append(f"  {site}: {n}")
    for kind, p in report["checkpoint_durations"].items():
        out.append(f"{kind}: n={p['count']} p50 {_fmt_ms(p['p50'])} "
                   f"max {_fmt_ms(p['max'])}")
    for s in report["stalls_suspected"]:
        out.append(f"STALL suspected (p{s.get('pid')}): "
                   f"{s.get('stalled_s')}s without a step "
                   f"(median {s.get('median_step_s')}s) — suspect "
                   f"worker {s.get('suspect_worker')}: "
                   f"{s.get('suspect_reason')}"
                   + (f" [accruing to {s['badput_bucket']}]"
                      if s.get("badput_bucket") else ""))
    if report.get("recovery_timeline"):
        rec = report["recovery"]
        status = ("job completed" if rec["completed"]
                  else "RECOVERY FAILED (budget exhausted)"
                  if rec["failed"] else "in progress")
        out.append(f"recovery: {rec['worker_deaths']} worker death(s), "
                   f"{rec['restarts']} restart(s)"
                   + (f", {rec['reshards']} shrink(s)"
                      if rec.get("reshards") else "")
                   + f" — {status}")
        if rec.get("restore_tiers"):
            out.append("restore tiers: " + "  ".join(
                f"{t}×{n}" for t, n in sorted(
                    rec["restore_tiers"].items())))
        for gen, mttr in sorted((rec.get("mttr_s") or {}).items()):
            out.append(f"MTTR (gen {gen}): {mttr:.3f}s "
                       f"(death -> restored)")
        out.append("recovery timeline:")
        for ev in report["recovery_timeline"]:
            out.append(_fmt_recovery_line(ev))
    if rollup:
        out.append("fleet rollup (latest TensorBoard scalars):")
        for tag, v in rollup.items():
            out.append(f"  {tag} = {v:.6g}")
    return "\n".join(out)


def _events_by_pid(files: "list[str]") -> dict:
    """{pid: events} keyed by the events-<pid>.jsonl suffix (numeric ids
    as ints, the supervisor as the string "supervisor")."""
    import re
    out: dict = {}
    for path in files:
        m = re.search(r"events-([A-Za-z0-9_]+)\.jsonl$", path)
        suffix = m.group(1) if m else str(len(out))
        pid = int(suffix) if suffix.isdigit() else suffix
        out[pid] = read_events(path)
    return out


def check(target: str, require: "list[str] | None" = None,
          mttr_budget: "float | None" = None,
          expect_bottleneck: "str | None" = None,
          forbid_bottleneck: "list[str] | None" = None) -> int:
    """Validate every event file; 0 = ok (torn tails reported but
    tolerated), 1 = corrupt/malformed, a ``require``d event is absent
    from the whole run, a recovery's MTTR exceeded ``mttr_budget``
    seconds, or the run's bottleneck class violates
    ``expect_bottleneck``/``forbid_bottleneck``; 2 = nothing to check."""
    files = _event_files(target)
    if not files:
        print(f"obs_report --check: no events-*.jsonl under {target}",
              file=sys.stderr)
        return 2
    rc = 0
    seen_names: set = set()
    recovery_events: list = []
    for path in files:
        try:
            events = read_events(path, tolerate_torn_tail=True)
        except EventLogCorruptError as e:
            print(f"CORRUPT  {path}: {e}", file=sys.stderr)
            rc = 1
            continue
        seen_names.update(ev.get("ev") for ev in events
                          if isinstance(ev.get("ev"), str))
        recovery_events.extend(
            ev for ev in events
            if isinstance(ev.get("ev"), str)
            and ev["ev"].startswith("recovery."))
        torn = _torn_tail(path)
        note = "  (torn tail line tolerated)" if torn else ""
        print(f"ok       {path}: {len(events)} events{note}")
    for req in require or []:
        if not any(n == req or n.startswith(req + ".")
                   for n in seen_names):
            print(f"MISSING  required event {req!r} never recorded "
                  f"in {target}", file=sys.stderr)
            rc = 1
    if mttr_budget is not None:
        recovery_events.sort(key=lambda ev: ev.get("wall", 0.0))
        mttrs = recovery_mttrs(recovery_events)
        for gen, mttr in sorted(mttrs.items()):
            status = "ok" if mttr <= mttr_budget else "OVER BUDGET"
            line = (f"mttr     gen {gen}: {mttr:.3f}s "
                    f"(budget {mttr_budget}s) {status}")
            if mttr > mttr_budget:
                print(line, file=sys.stderr)
                rc = 1
            else:
                print(line)
    if expect_bottleneck or forbid_bottleneck:
        try:
            report = summarize(_events_by_pid(files))
        except EventLogCorruptError:
            return 1                    # already reported above
        b = report.get("bottleneck")
        cls = b["class"] if b else None
        detail = ("; ".join(b["reasons"]) if b and b["reasons"]
                  else "no threshold tripped")
        if cls is None:
            print("BOTTLENECK no train.step events: class "
                  "unclassifiable", file=sys.stderr)
            rc = 1
        else:
            print(f"bottleneck class: {cls} ({detail})")
            if expect_bottleneck and cls != expect_bottleneck:
                print(f"BOTTLENECK expected {expect_bottleneck!r}, "
                      f"classified {cls!r}", file=sys.stderr)
                rc = 1
            if forbid_bottleneck and cls in forbid_bottleneck:
                print(f"BOTTLENECK forbidden class {cls!r} "
                      f"({detail})", file=sys.stderr)
                rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", help="telemetry run directory (or one "
                                   "events-*.jsonl file)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--check", action="store_true",
                    help="validate event logs; non-zero exit on "
                         "malformed/torn-mid-file JSONL")
    ap.add_argument("--require", action="append", metavar="EVENT",
                    help="with --check: fail unless an event with this "
                         "name (or namespace prefix) was recorded, e.g. "
                         "--require recovery.restore_tier")
    ap.add_argument("--mttr-budget", type=float, default=None,
                    metavar="SECONDS",
                    help="with --check: fail if any recovery's MTTR "
                         "(first worker death -> cluster restored) "
                         "exceeds this many seconds")
    ap.add_argument("--expect-bottleneck", default=None, metavar="CLASS",
                    help="with --check: fail unless the run classifies "
                         "as this bottleneck class (input-bound / "
                         "comm-bound / compute-bound / checkpoint-bound "
                         "/ recovery-bound)")
    ap.add_argument("--forbid-bottleneck", action="append",
                    metavar="CLASS",
                    help="with --check: fail when the run classifies as "
                         "this class (repeatable) — e.g. "
                         "--forbid-bottleneck input-bound gates a "
                         "training fleet on host-boundedness")
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, "torch_obs_report")

    if args.check:
        return check(args.target, require=args.require,
                     mttr_budget=args.mttr_budget,
                     expect_bottleneck=args.expect_bottleneck,
                     forbid_bottleneck=args.forbid_bottleneck)
    for opt, name in ((args.require, "--require"),
                      (args.mttr_budget, "--mttr-budget"),
                      (args.expect_bottleneck, "--expect-bottleneck"),
                      (args.forbid_bottleneck, "--forbid-bottleneck")):
        if opt is not None and opt != []:
            ap.error(f"{name} only applies with --check")

    files = _event_files(args.target)
    if not files:
        print(f"obs_report: no events-*.jsonl under {args.target}",
              file=sys.stderr)
        return 2
    try:
        events_by_pid = _events_by_pid(files)
    except EventLogCorruptError as e:
        print(f"obs_report: {e}", file=sys.stderr)
        return 1
    report = summarize(events_by_pid)
    rollup = read_rollup_scalars(args.target)
    if args.json:
        print(json.dumps({"report": report, "fleet_rollup": rollup},
                         indent=2))
    else:
        print(render_text(report, rollup))
    return 0


if __name__ == "__main__":
    rc = main()
    torch_entry.write_report()
    sys.exit(rc)

#!/usr/bin/env python3
"""Live fleet health: goodput/badput ledger, SLO burn, stalls, scrape.

On the port: the counterpart of ``tools/health_report.py``, whose
standard output, ``--json`` and ``--check`` exit codes it gives
byte for byte on the same run directory (either package's), over the
port's own telemetry modules; it adds only ``--device`` (default
``cuda``, as every port script).

The operator's "is the fleet healthy RIGHT NOW and what fraction of the
hardware-hours became progress?" surface. Reads a telemetry run
directory (works mid-run — the event files are line-buffered and the
readers tolerate torn tails) and renders:

- the **goodput/badput ledger** (telemetry/goodput.py): what share of
  every worker's wall clock was productive step time vs named waste —
  startup/compile, infeed wait, checkpoint blocking, recovery/respawn,
  preemption replay, idle. The buckets sum to wall by construction;
  the report prints the identity error so you can see it hold.
- **SLO burn** (telemetry/slo.py): p99-latency / TTFT / availability
  objectives over the run's ``serve.request`` completions, with
  multi-window burn rates (windows auto-scale to the observed span
  unless pinned via ``--slo-window``).
- **stalls**: every ``stall.suspected`` with the suspect worker AND the
  badput bucket the blocked time was accruing to.
- the **live scrape** status: age and location of ``metrics-live.prom``
  (the supervisor's exporter writes it once a second; a stale file
  means the exporter — or the run — is gone).

Usage::

    python tools/torch_health_report.py RUN_DIR              # human report
    python tools/torch_health_report.py RUN_DIR --json
    python tools/torch_health_report.py RUN_DIR --check \\
        --goodput-floor 0.5 --slo-budget 1.0           # CI gate

``--check`` exits non-zero when: the ledger identity is violated past
--identity-tol (1% default), goodput fraction is below
``--goodput-floor``, any SLO consumed more than ``--slo-budget`` of its
error budget or has a firing burn-rate window pair. ``--slo-latency-ms``
/ ``--slo-ttft-ms`` pin the objective thresholds (defaults mirror the
README SLO table).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))
import torch_entry  # noqa: E402

from distributed_tensorflow_tpu_torch.telemetry import (  # noqa: E402
    events as tv_events, exporter as tv_exporter, goodput as tv_goodput,
    slo as tv_slo)


def build_report(run_dir: str, *, latency_s: float = 0.5,
                 ttft_s: float = 0.25, freshness_s: float = 5.0,
                 windows: "tuple | None" = None) -> dict:
    """Assemble the health report structure from a run directory."""
    events_by_pid = tv_events.read_run(run_dir)
    ledger = tv_goodput.ledger_from_events(events_by_pid)

    records = tv_slo.records_from_events(events_by_pid)
    slo_report = None
    if records:
        if windows is None:
            span = ((records[-1]["wall"] - records[0]["wall"])
                    if len(records) > 1 else 1.0)
            windows = tv_slo.windows_for_span(max(span, 1e-3))
        slos = tv_slo.default_serving_slos(
            latency_s=latency_s, ttft_s=ttft_s, windows=windows)
        slo_report = tv_slo.evaluate_records(records, slos)
        # cause itemization: when the run logged any
        # control-plane transition the audit can window (recovery
        # reform, scale.applied, serve.swap, kv.migrate, a spike
        # phase), break each serving SLO's budget spend down by
        # attributed cause — the unattributed remainder is the share
        # no logged transition explains
        from distributed_tensorflow_tpu_torch.telemetry import (
            audit as tv_audit)
        cause_ws = tv_audit.cause_windows(events_by_pid)
        if any(cause_ws.values()):
            tv_audit.itemize_slos(tv_audit.day_records(events_by_pid),
                                  slos, slo_report, cause_ws)

    # per-tenant SLO burn: tenant-stamped completions are
    # ADDITIONALLY evaluated per tenant against its own burn windows —
    # one tenant's overrun cannot fire another's verdict. Without the
    # run's real TenantConfig to hand, interactive tenants inherit the
    # report's latency threshold and batch tenants 10x it (the README
    # priority-class split).
    tenant_report = None
    t_records = [r for r in (records or []) if r.get("tenant")]
    if t_records:
        from distributed_tensorflow_tpu_torch.serving import tenancy as tn
        seen: dict = {}
        for r in t_records:
            seen.setdefault(r["tenant"], r.get("pclass"))
        cfgs = [tn.TenantConfig(
                    name, pclass=(pc if pc in tn.PRIORITY_CLASSES
                                  else "interactive"),
                    slo_latency_s=(latency_s * 10 if pc == "batch"
                                   else latency_s))
                for name, pc in sorted(seen.items())]
        tenant_report = tn.evaluate_tenants(t_records, cfgs,
                                            windows=windows)

    # online freshness SLO: update->servable burn over the
    # evaluator's snapshot stamps. Folded into the same slo dict so
    # --slo-budget gates it identically; names never collide with the
    # serving set.
    online_report = None
    fresh_records = tv_slo.freshness_records_from_events(events_by_pid)
    if fresh_records:
        fw = windows
        if fw is None:
            span = ((fresh_records[-1]["wall"]
                     - fresh_records[0]["wall"])
                    if len(fresh_records) > 1 else 1.0)
            fw = tv_slo.windows_for_span(max(span, 1e-3))
        online_slos = tv_slo.default_online_slos(
            freshness_s=freshness_s, windows=fw)
        online_report = tv_slo.evaluate_records(fresh_records,
                                                online_slos)
        slo_report = {**(slo_report or {}), **online_report}

    stalls = []
    scale_decisions = 0
    scale_applied = []
    for pid, events in events_by_pid.items():
        for ev in events:
            if ev.get("ev") == "stall.suspected":
                stalls.append({"pid": pid,
                               "stalled_s": ev.get("stalled_s"),
                               "suspect_worker": ev.get("suspect_worker"),
                               "badput_bucket": ev.get("badput_bucket")})
            elif ev.get("ev") == "scale.decision":
                scale_decisions += 1
            elif ev.get("ev") == "scale.applied":
                scale_applied.append({
                    "wall": ev.get("wall"),
                    "generation": ev.get("generation"),
                    "direction": ev.get("direction"),
                    "from": ev.get("from_workers"),
                    "to": ev.get("to_workers"),
                    "reason": ev.get("reason")})
    scale_applied.sort(key=lambda s: s.get("wall") or 0.0)

    live = None
    prom = os.path.join(run_dir, tv_exporter.LIVE_METRICS_FILE)
    if os.path.isfile(prom):
        try:
            live = {"path": prom,
                    "age_s": round(time.time() - os.path.getmtime(prom),
                                   3)}
        except OSError:
            live = None

    online = None
    if fresh_records:
        lags = [r["lag_events"] for r in fresh_records
                if isinstance(r.get("lag_events"), (int, float))]
        fresh = [r["freshness_s"] for r in fresh_records
                 if isinstance(r.get("freshness_s"), (int, float))]
        online = {
            "snapshots": len(fresh_records),
            "last_offset": fresh_records[-1].get("offset"),
            "last_lag_events": (lags[-1] if lags else None),
            "freshness_p50_s": (round(sorted(fresh)[len(fresh) // 2], 4)
                                if fresh else None),
            "freshness_max_s": (round(max(fresh), 4) if fresh
                                else None),
            "slo": online_report,
        }

    return {"ledger": ledger, "slo": slo_report, "stalls": stalls,
            "tenants": tenant_report, "online": online,
            "scale": {"decisions": scale_decisions,
                      "applied": scale_applied},
            "live_scrape": live,
            "processes": sorted(str(p) for p in events_by_pid)}


def _fmt_s(v) -> str:
    return f"{v:8.3f}s" if isinstance(v, (int, float)) else "       -"


def render_text(report: dict) -> str:
    out = ["== fleet health =="]
    led = report["ledger"]
    wall = led["wall_s"]
    if wall <= 0:
        out.append("no worker wall clock observed (empty run?)")
    else:
        frac = led.get("goodput_frac")
        out.append(f"goodput  {frac:6.1%}  "
                   f"({led['goodput_s']:.3f}s of {wall:.3f}s "
                   f"hardware time, {len(led['per_worker'])} worker(s))")
        out.append("badput breakdown:")
        for b in tv_goodput.BADPUT_BUCKETS:
            v = led["badput_s"][b]
            if v > 0 or b in ("recovery", "idle"):
                out.append(f"  {b:<15} {_fmt_s(v)}  "
                           f"{v / wall:6.1%}")
        out.append(f"ledger identity error: "
                   f"{led['identity_error_s']:+.6f}s "
                   f"({abs(led['identity_error_s']) / wall:.3%} of wall)")
    if report.get("slo"):
        out.append("SLOs:")
        for name, res in report["slo"].items():
            state = "FIRING" if res["firing"] else "ok"
            thr = (f" <= {res['threshold_s'] * 1e3:g}ms"
                   if res["threshold_s"] else "")
            out.append(f"  {name:<14} [{state}] objective "
                       f"{res['objective']:.1%}{thr}  "
                       f"{res['bad']}/{res['requests']} bad  "
                       f"budget consumed {res['budget_consumed']:.2f}x")
            for cause, c in (res.get("by_cause") or {}).items():
                if c["bad"]:
                    out.append(f"    cause {cause:<16} {c['bad']:>5} "
                               f"bad  {c['budget_consumed']:6.2f}x "
                               f"budget")
            un = res.get("unattributed")
            if un and un["bad"]:
                out.append(f"    cause {'UNATTRIBUTED':<16} "
                           f"{un['bad']:>5} bad  "
                           f"{un['budget_consumed']:6.2f}x budget  "
                           f"({un['frac_of_bad']:.1%} of bad)")
            for w in res["windows"]:
                bl = (f"{w['burn_long']:.2f}"
                      if w["burn_long"] is not None else "-")
                bs = (f"{w['burn_short']:.2f}"
                      if w["burn_short"] is not None else "-")
                out.append(f"    window {w['long_s']:g}s/"
                           f"{w['short_s']:g}s: burn {bl}/{bs} "
                           f"(max {w['max_burn']:g})"
                           + ("  FIRING" if w["firing"] else ""))
    if report.get("tenants"):
        out.append("per-tenant SLOs:")
        for tenant, slos in sorted(report["tenants"].items()):
            for name, res in slos.items():
                state = "FIRING" if res["firing"] else "ok"
                thr = (f" <= {res['threshold_s'] * 1e3:g}ms"
                       if res["threshold_s"] else "")
                out.append(f"  {name:<22} [{state}] objective "
                           f"{res['objective']:.1%}{thr}  "
                           f"{res['bad']}/{res['requests']} bad  "
                           f"budget consumed "
                           f"{res['budget_consumed']:.2f}x")
    on = report.get("online")
    if on:
        out.append(f"online: {on['snapshots']} snapshot(s) served, "
                   f"last offset {on['last_offset']}"
                   + (f", lag {on['last_lag_events']} event(s)"
                      if on.get("last_lag_events") is not None else "")
                   + (f", freshness p50 {on['freshness_p50_s']:g}s "
                      f"max {on['freshness_max_s']:g}s"
                      if on.get("freshness_p50_s") is not None else ""))
    scale = report.get("scale") or {}
    if scale.get("applied") or scale.get("decisions"):
        out.append(f"autoscaling: {scale.get('decisions', 0)} "
                   f"decision(s), {len(scale.get('applied', []))} "
                   f"applied")
        for s in scale.get("applied", []):
            out.append(f"  gen{s['generation']}: {s['from']} -> "
                       f"{s['to']} ({s['direction']}, {s['reason']})")
    for s in report["stalls"]:
        out.append(f"STALL (p{s['pid']}): {s.get('stalled_s')}s, "
                   f"suspect worker {s.get('suspect_worker')}, "
                   f"accruing to {s.get('badput_bucket') or 'idle'}")
    live = report.get("live_scrape")
    if live:
        out.append(f"live scrape: {live['path']} "
                   f"(age {live['age_s']:.1f}s)")
    else:
        out.append("live scrape: no metrics-live.prom "
                   "(exporter not running)")
    return "\n".join(out)


def check(report: dict, *, goodput_floor: "float | None",
          slo_budget: "float | None", identity_tol: float) -> int:
    """Gate the report; prints verdict lines, returns the exit code."""
    rc = 0
    led = report["ledger"]
    wall = led["wall_s"]
    if wall <= 0:
        print("health_report --check: no worker events to gate",
              file=sys.stderr)
        return 2
    err_frac = abs(led["identity_error_s"]) / wall
    if err_frac > identity_tol:
        print(f"IDENTITY  wall != goodput + badput by "
              f"{led['identity_error_s']:+.3f}s ({err_frac:.2%} > "
              f"{identity_tol:.2%})", file=sys.stderr)
        rc = 1
    else:
        print(f"ok       ledger identity holds "
              f"({err_frac:.4%} <= {identity_tol:.2%})")
    if goodput_floor is not None:
        frac = led.get("goodput_frac") or 0.0
        if frac < goodput_floor:
            print(f"GOODPUT  {frac:.1%} below floor "
                  f"{goodput_floor:.1%}", file=sys.stderr)
            rc = 1
        else:
            print(f"ok       goodput {frac:.1%} >= floor "
                  f"{goodput_floor:.1%}")
    if slo_budget is not None:
        if not report.get("slo"):
            print("SLO      no serve.request completions to evaluate",
                  file=sys.stderr)
            rc = 1
        else:
            for name, res in report["slo"].items():
                bad = (res["budget_consumed"] > slo_budget
                       or res["firing"])
                if bad:
                    why = []
                    if res["budget_consumed"] > slo_budget:
                        why.append(f"budget consumed "
                                   f"{res['budget_consumed']:.2f}x > "
                                   f"{slo_budget:g}x")
                    if res["firing"]:
                        why.append("burn-rate window firing")
                    print(f"SLO      {name}: " + "; ".join(why),
                          file=sys.stderr)
                    rc = 1
                else:
                    print(f"ok       SLO {name}: budget consumed "
                          f"{res['budget_consumed']:.2f}x, not firing")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", help="telemetry run directory")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="CI gate mode (see module docstring)")
    ap.add_argument("--goodput-floor", type=float, default=None,
                    metavar="FRAC",
                    help="with --check: fail when goodput fraction is "
                         "below this (e.g. 0.5)")
    ap.add_argument("--slo-budget", type=float, default=None,
                    metavar="X",
                    help="with --check: fail when any SLO consumed more "
                         "than X times its error budget, or is firing")
    ap.add_argument("--identity-tol", type=float, default=0.01,
                    help="max |wall - (goodput+badput)| as a fraction "
                         "of wall (default 0.01)")
    ap.add_argument("--slo-latency-ms", type=float, default=500.0,
                    help="p99 latency objective threshold (default 500)")
    ap.add_argument("--slo-ttft-ms", type=float, default=250.0,
                    help="p95 TTFT objective threshold (default 250)")
    ap.add_argument("--slo-freshness-s", type=float, default=5.0,
                    help="online freshness (update->servable) objective "
                         "threshold in seconds (default 5)")
    ap.add_argument("--slo-window", action="append", metavar="L,S,B",
                    help="burn window triple long_s,short_s,max_burn "
                         "(repeatable; default: SRE presets scaled to "
                         "the run span)")
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, "torch_health_report")

    if not os.path.isdir(args.target):
        print(f"health_report: no run directory {args.target}",
              file=sys.stderr)
        return 2
    windows = None
    if args.slo_window:
        windows = tuple(tuple(float(x) for x in w.split(","))
                        for w in args.slo_window)
        for w in windows:
            if len(w) != 3:
                ap.error(f"--slo-window wants long_s,short_s,max_burn; "
                         f"got {w}")
    try:
        report = build_report(args.target,
                              latency_s=args.slo_latency_ms / 1e3,
                              ttft_s=args.slo_ttft_ms / 1e3,
                              freshness_s=args.slo_freshness_s,
                              windows=windows)
    except tv_events.EventLogCorruptError as e:
        print(f"health_report: {e}", file=sys.stderr)
        return 1
    if args.check:
        return check(report, goodput_floor=args.goodput_floor,
                     slo_budget=args.slo_budget,
                     identity_tol=args.identity_tol)
    for opt, name in ((args.goodput_floor, "--goodput-floor"),
                      (args.slo_budget, "--slo-budget")):
        if opt is not None:
            ap.error(f"{name} only applies with --check")
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Production-day scorecard: goodput identity, cause-itemized SLO
budget spend, phase breakdown, rack-loss recovery tier.

On the port: the counterpart of ``tools/day_report.py``, whose
standard output, ``--json`` and ``--check`` exit codes it gives
byte for byte on the same run directory (either package's), over the
port's own telemetry modules; it adds only ``--device`` (default
``cuda``, as every port script).

The retrospective surface over a ``bench.py --day`` /
``testing/day_sim.DaySim`` run (or any telemetry run directory with a
day driver's ``day.*`` markers): everything is recomputed purely from
the event logs by ``telemetry/audit.audit_day`` — no in-process state.

- **ledger**: the fleet goodput identity (``wall == goodput + Σ
  badput``) with its residual, plus the badput buckets that matter to a
  day (recovery, scale_transition, preempt_replay, idle).
- **phases**: the diurnal curve re-cut — per-phase hardware-seconds and
  goodput fraction, so "the spike cost us X" is a number, not a vibe.
- **SLO budget by cause**: each SLO's ``budget_consumed`` itemized by
  attributed cause (recovery > scale_transition > rollout > kv_migrate
  > preempt_replay > spike_overload) with the ``unattributed``
  remainder printed — and gated — explicitly: an unexplained burn is an
  observability bug.
- **rack loss**: the correlated-failure scorecard — kill → next
  generation MTTR and the restore tiers the reformed trainers reported
  (``host``/``peer`` = warm, ``durable`` = the placement policy
  failed).

Usage::

    python tools/torch_day_report.py RUN_DIR                 # human scorecard
    python tools/torch_day_report.py RUN_DIR --json
    python tools/torch_day_report.py RUN_DIR --check         # CI gates

``--check`` exits non-zero when: the ledger identity residual exceeds
``--identity-tol`` (1% default); any SLO's unattributed share of bad
records exceeds ``--max-unattributed`` (5% default); the run contains a
rack kill whose restore fell through the warm (host/peer) tiers — or
no rack kill / no observable restore at all (disable with
``--allow-cold`` for non-day runs); any admitted request was dropped;
optionally goodput below ``--goodput-floor`` or rack MTTR over
``--max-mttr-s``.
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
    audit as tv_audit, events as tv_events, goodput as tv_goodput,
    slo as tv_slo)


def build_audit(run_dir: str, *, latency_s: float = 0.5,
                ttft_s: float = 0.25) -> dict:
    """read_run -> audit_day with the report's SLO thresholds."""
    events_by_pid = tv_events.read_run(run_dir)
    if not events_by_pid:
        raise tv_events.EventLogCorruptError(
            f"no events-*.jsonl under {run_dir}")
    walls = [ev["wall"] for evs in events_by_pid.values() for ev in evs
             if ev.get("ev") == "serve.request"
             and isinstance(ev.get("wall"), (int, float))]
    span = (max(walls) - min(walls)) if len(walls) > 1 else 1.0
    slos = tv_slo.default_serving_slos(
        latency_s=latency_s, ttft_s=ttft_s,
        windows=tv_slo.windows_for_span(max(span, 1e-3)))
    return tv_audit.audit_day(events_by_pid, slos=slos)


def render_text(audit: dict) -> str:
    out = ["== production-day scorecard =="]
    led = audit["ledger"]
    wall = led["wall_s"]
    if wall <= 0:
        out.append("no worker wall clock observed (empty run?)")
        return "\n".join(out)
    out.append(f"goodput  {led['goodput_frac']:6.1%}  "
               f"({led['goodput_s']:.3f}s of {wall:.3f}s "
               f"hardware time, {led['workers']} worker(s))")
    out.append("badput breakdown:")
    for b in tv_goodput.BADPUT_BUCKETS:
        v = led["badput_s"].get(b, 0.0)
        if v > 0 or b in ("recovery", "scale_transition", "idle"):
            out.append(f"  {b:<16} {v:8.3f}s  {v / wall:6.1%}")
    out.append(f"ledger identity error: {led['identity_error_s']:+.6f}s "
               f"({led['identity_error_frac']:.3%} of wall)")

    if audit["phases"]:
        out.append("day phases:")
        out.append(f"  {'phase':<12} {'dur':>7} {'rate':>7} "
                   f"{'hw-sec':>8} {'goodput':>8}")
        for ph in audit["phases"]:
            gf = (f"{ph['goodput_frac']:6.1%}"
                  if ph.get("goodput_frac") is not None else "     -")
            rate = (f"{ph['rate_rps']:g}/s"
                    if ph.get("rate_rps") is not None else "-")
            out.append(f"  {ph['phase']:<12} {ph['dur_s']:6.2f}s "
                       f"{rate:>7} {ph['wall_s']:7.2f}s {gf:>8}")

    req = audit["requests"]
    drop = (f", {req['dropped']} DROPPED" if req.get("dropped")
            else ", 0 dropped" if req.get("generated") is not None
            else "")
    out.append(f"requests: {req['completed']} completed"
               + (f" of {req['generated']} generated" if
                  req.get("generated") is not None else "") + drop)

    out.append("SLO budget spend by cause:")
    for name, res in audit["slos"].items():
        state = "FIRING" if res.get("firing") else "ok"
        out.append(f"  {name:<14} [{state}] {res['bad']}/"
                   f"{res['requests']} bad, budget consumed "
                   f"{res['budget_consumed']:.2f}x")
        for cause in tv_audit.CAUSES:
            c = res["by_cause"].get(cause)
            if c and c["bad"]:
                out.append(f"    {cause:<16} {c['bad']:>5} bad  "
                           f"{c['budget_consumed']:7.2f}x budget")
        un = res["unattributed"]
        out.append(f"    {'unattributed':<16} {un['bad']:>5} bad  "
                   f"{un['budget_consumed']:7.2f}x budget  "
                   f"({un['frac_of_bad']:.1%} of bad)")

    rack = audit.get("rack_loss")
    if rack:
        warm = "WARM" if rack["warm"] else "COLD"
        mttr = (f"{rack['mttr_s'] * 1e3:.0f}ms"
                if rack.get("mttr_s") is not None else "unrecovered")
        out.append(f"rack loss: domain {rack['domain']} "
                   f"(victims {rack['victims']}), MTTR {mttr}, "
                   f"restored from {rack['restore_tiers'] or ['?']} "
                   f"[{warm}]")
    else:
        out.append("rack loss: none in this run")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", help="telemetry run directory")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="CI gate mode (see module docstring)")
    ap.add_argument("--identity-tol", type=float, default=0.01,
                    help="max |wall - (goodput+badput)| as a fraction "
                         "of wall (default 0.01)")
    ap.add_argument("--max-unattributed", type=float, default=0.05,
                    help="max unattributed share of any SLO's bad "
                         "records (default 0.05)")
    ap.add_argument("--goodput-floor", type=float, default=None,
                    metavar="FRAC",
                    help="with --check: fail below this day goodput "
                         "fraction")
    ap.add_argument("--max-mttr-s", type=float, default=None,
                    help="with --check: fail when rack-loss MTTR "
                         "exceeds this")
    ap.add_argument("--allow-cold", action="store_true",
                    help="with --check: don't require a warm "
                         "(host/peer) rack-loss restore — for runs "
                         "without a rack kill")
    ap.add_argument("--slo-latency-ms", type=float, default=500.0,
                    help="p99 latency objective threshold (default 500)")
    ap.add_argument("--slo-ttft-ms", type=float, default=250.0,
                    help="p95 TTFT objective threshold (default 250)")
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, "torch_day_report")

    if not os.path.isdir(args.target):
        print(f"day_report: no run directory {args.target}",
              file=sys.stderr)
        return 2
    try:
        audit = build_audit(args.target,
                            latency_s=args.slo_latency_ms / 1e3,
                            ttft_s=args.slo_ttft_ms / 1e3)
    except tv_events.EventLogCorruptError as e:
        print(f"day_report: {e}", file=sys.stderr)
        return 1

    if args.check:
        fails = tv_audit.check_audit(
            audit, identity_tol=args.identity_tol,
            max_unattributed=args.max_unattributed,
            goodput_floor=args.goodput_floor,
            require_warm_restore=not args.allow_cold,
            max_rack_mttr_s=args.max_mttr_s)
        for f in fails:
            print(f"FAIL  {f}", file=sys.stderr)
        if fails:
            return 1
        led = audit["ledger"]
        rack = audit.get("rack_loss")
        print(f"day check ok: identity "
              f"{led['identity_error_frac']:.4%} <= "
              f"{args.identity_tol:.0%}, max unattributed "
              f"{audit['max_unattributed_frac']:.1%} <= "
              f"{args.max_unattributed:.0%}, goodput "
              f"{led['goodput_frac']:.1%}"
              + (f", rack restored {rack['restore_tiers']} in "
                 f"{rack['mttr_s'] * 1e3:.0f}ms"
                 if rack and rack.get("mttr_s") is not None else ""))
        return 0
    for opt, name in ((args.goodput_floor, "--goodput-floor"),
                      (args.max_mttr_s, "--max-mttr-s")):
        if opt is not None:
            ap.error(f"{name} only applies with --check")
    if args.json:
        print(json.dumps(audit, indent=2))
    else:
        print(render_text(audit))
    return 0


if __name__ == "__main__":
    sys.exit(main())

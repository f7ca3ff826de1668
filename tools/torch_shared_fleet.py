#!/usr/bin/env python3
"""Shared training+serving fleet with SLO-driven autoscaling, on the
port — the counterpart of ``examples/shared_fleet.py``.

A fixed worker budget (default 3 processes) is split between an elastic
MNIST training job (``tools/torch_train_mnist.py elastic_worker``) and
serving replicas (``serving/replica.py serving_replica``), both under
recovery supervisors composed by ``resilience/autoscaler.py
SharedFleetSupervisor``. A seeded open-loop traffic spike saturates the
serving replica; the p99-latency burn windows fire; the arbiter makes
training donate a worker (a topology-elastic shrink: the trainer
resumes from its warm snapshot tiers) and grows serving; once the burn
clears and holds, serving drains the extra replica (zero dropped
requests) and training reclaims the capacity. Every reform gap is
priced into the ``scale_transition`` badput bucket.

    python3 tools/torch_shared_fleet.py --telemetry-dir /tmp/fleet --seed 0
    python3 tools/torch_shared_fleet.py --device cpu --duration 30

then ``cat /tmp/fleet/spike-summary.json`` (the spike table, recomputed
from the run's telemetry) or ``python3 tools/torch_obs_report.py
/tmp/fleet/serve``.

The serving model is JAX's ``tiny(max_seq_len=64)`` (the policy's
pacing and latency budget are timed for it); on the card it takes the
flash attention forward, so every prefill launches #1. Each process
takes a card from ``LOCAL_RANK`` (the trainers join an NCCL group, the
replicas none), so the default split needs two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_shared_fleet"


def build_policy(args):
    from distributed_tensorflow_tpu_torch.resilience.autoscaler import (
        AutoscalePolicy,
    )
    from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo
    slo = tv_slo.SLO("p99_latency", "latency", objective=0.99,
                     threshold_s=args.latency_slo_ms / 1e3,
                     windows=((args.burn_window_long,
                               args.burn_window_short,
                               args.burn_threshold),))
    return AutoscalePolicy(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        train_floor=args.train_floor,
        fire_consecutive=args.fire_consecutive,
        clear_burn=args.clear_burn,
        clear_hold_s=args.clear_hold,
        cooldown_s=args.cooldown,
        min_evidence=args.min_evidence,
        interval_s=0.5,
        slo=slo)


def spike_kwargs(args) -> dict:
    return dict(duration_s=args.duration, base_qps=args.base_qps,
                spike_qps=args.spike_qps,
                spike_start_s=args.spike_start,
                spike_end_s=args.spike_end,
                linger_s=args.linger)


def serve_config(device: str):
    """``None`` (the replica's default, JAX's ``tiny(max_seq_len=64)``)
    on the CPU; that config through the flash forward on the card."""
    if device == "cpu":
        return None
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.tiny(max_seq_len=64, attention_impl=None)


def run_fleet(args) -> dict:
    """Run the shared fleet once; returns the analysis summary (also
    written to ``<telemetry-dir>/spike-summary.json``)."""
    import tempfile

    from distributed_tensorflow_tpu_torch.resilience.autoscaler import (
        SharedFleetSupervisor,
    )
    from distributed_tensorflow_tpu_torch.serving.replica import (
        serving_replica)

    tdir = args.telemetry_dir or tempfile.mkdtemp(prefix="shared_fleet_")
    os.makedirs(tdir, exist_ok=True)
    ckpt_dir = args.ckpt_dir or os.path.join(tdir, "ckpt")
    policy = build_policy(args)
    spike = spike_kwargs(args)
    fleet = SharedFleetSupervisor(
        budget=args.budget,
        train_fn=torch_entry.worker("torch_train_mnist", "elastic_worker"),
        train_args=(ckpt_dir, args.train_steps, args.save_every,
                    64, 1e-3),
        train_kwargs={"local_dir": ckpt_dir.rstrip("/") + ".local",
                      "snapshot_every": args.snapshot_every,
                      "step_delay_s": args.train_step_delay,
                      "device": args.device},
        serve_fn=serving_replica,
        serve_args=(tdir, 0, args.seed),
        serve_kwargs={"spike": spike,
                      "step_delay_s": args.serve_step_delay,
                      "cfg": serve_config(args.device),
                      "engine_kwargs": {"max_slots": args.max_slots,
                                        "num_blocks": 96,
                                        "device": args.device}},
        train_workers=args.train_workers,
        serve_replicas=args.replicas,
        policy=policy,
        telemetry_dir=tdir,
        train_sup_kwargs=dict(
            generation_timeout_s=args.generation_timeout,
            device=args.device),
        serve_sup_kwargs=dict(
            generation_timeout_s=args.generation_timeout,
            drain_timeout_s=15.0, device=args.device))
    print(f"shared fleet: budget {args.budget} = "
          f"{args.train_workers} trainer(s) + {args.replicas} "
          f"replica(s); spike {args.spike_qps} qps in "
          f"[{args.spike_start}, {args.spike_end}]s of "
          f"{args.duration}s @ base {args.base_qps} qps", flush=True)
    result = fleet.run()
    print(f"fleet run done: serve scales={result.serve_scales} "
          f"train scales={result.train_scales} final split="
          f"{result.final_train_workers}+{result.final_serve_replicas}"
          f"{' (training stopped)' if result.train_stopped else ''}",
          flush=True)
    summary = analyze(tdir, seed=args.seed, spike=spike, policy=policy,
                      train_workers=args.train_workers)
    summary["result"] = {
        "serve_scales": result.serve_scales,
        "train_scales": result.train_scales,
        "final_train_workers": result.final_train_workers,
        "final_serve_replicas": result.final_serve_replicas,
        "train_stopped": result.train_stopped,
    }
    with open(os.path.join(tdir, "spike-summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def _phase_ledger(events_by_pid: dict, lo: float, hi: float) -> dict:
    """Goodput over an event-wall slice (phase tables: before/during/
    after the spike). The walker is self-contained, so the identity
    holds within the slice too."""
    from distributed_tensorflow_tpu_torch.telemetry import goodput
    sliced = {pid: [e for e in events
                    if isinstance(e.get("wall"), (int, float))
                    and lo <= e["wall"] < hi]
              for pid, events in events_by_pid.items()}
    return goodput.ledger_from_events(
        {p: ev for p, ev in sliced.items() if ev})


def analyze(tdir: str, *, seed: int, spike: dict, policy,
            train_workers: int) -> dict:
    """The spike table: scale-up latency, SLO recovery time, goodput
    before/during/after, transition pricing, capacity return — all
    recomputed from the run's telemetry (nothing self-reported)."""
    from distributed_tensorflow_tpu_torch.serving.replica import (
        completed_ids_all, seeded_spike_schedule,
    )
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import (
        goodput as tv_goodput)
    from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo

    serve_dir = os.path.join(tdir, "serve")
    train_dir = os.path.join(tdir, "train")
    with open(os.path.join(tdir, "run-epoch.json")) as f:
        epoch = float(json.load(f)["epoch"])
    spike_start_wall = epoch + spike["spike_start_s"]
    serve_events = tv_events.read_run(serve_dir)
    train_events = tv_events.read_run(train_dir)
    flat_serve = [e for evs in serve_events.values() for e in evs]
    flat_train = [e for evs in train_events.values() for e in evs]

    def _applied(flat, direction=None, reason=None):
        out = [e for e in flat if e.get("ev") == "scale.applied"]
        if direction:
            out = [e for e in out if e.get("direction") == direction]
        if reason:
            out = [e for e in out if e.get("reason") == reason]
        return out

    decisions = [e for e in flat_serve
                 if e.get("ev") == "scale.decision"]
    up_dec = [d for d in decisions if d.get("direction") == "up"
              and d.get("outcome") in ("requested", "donate")]
    ups = _applied(flat_serve, "up")
    downs = _applied(flat_serve, "down")
    donations = _applied(flat_train, "down", "donate_to_serving")
    reclaims = _applied(flat_train, "up", "reclaim")

    records = tv_slo.records_from_events(serve_events)
    slo = policy.slo
    lw, sw, _burn = slo.windows[0]

    def burn_at(t: float) -> "tuple[float | None, float | None]":
        w = tv_slo.burn_windows(records, slo, now=t)[0]
        return w["burn_long"], w["burn_short"]

    summary: dict = {"seed": seed, "spike": dict(spike),
                     "slo": {"threshold_s": slo.threshold_s,
                             "windows": list(slo.windows)},
                     "epoch": epoch}
    # --- scale-up latency: spike start -> decision -> applied
    su: dict = {"decisions": len(decisions),
                "applied_up": len(ups), "applied_down": len(downs),
                "donations": len(donations), "reclaims": len(reclaims)}
    if up_dec:
        su["detect_s"] = round(up_dec[0]["wall"] - spike_start_wall, 3)
    if ups:
        su["scale_up_latency_s"] = round(
            ups[0]["wall"] - spike_start_wall, 3)
        if up_dec:
            su["actuation_s"] = round(
                ups[0]["wall"] - up_dec[0]["wall"], 3)
    summary["scale_up"] = su
    # --- burn trail + SLO recovery: earliest post-scale-up instant
    # where BOTH windows are back under 1.0x and stay there
    peak = max((b for b in (burn_at(t / 2.0 + spike_start_wall)[1]
                            for t in range(0, int(2 * (
                                spike["duration_s"]
                                - spike["spike_start_s"] + 10))))
                if b is not None), default=None)
    summary["burn_peak_short"] = (round(peak, 2)
                                  if peak is not None else None)
    # recovery is evidence-based, not silence-based: the reform gap has
    # no completions at all (burn reads None), which must not count as
    # "recovered". The SLO has recovered once bad completions STOP and
    # good traffic follows — measured over the span between the
    # scale-up and the scale-down reform (the scale-down's own respawn
    # gap delays whatever arrives during it; that is transition cost,
    # reported separately as post_reclaim_bad, not a failure of the
    # recovery the scale-up bought).
    recovery_wall = None
    post_reclaim_bad = 0
    if ups and records:
        last_wall = max(r["wall"] for r in records)
        span_end = downs[0]["wall"] if downs else last_wall
        in_span = [r for r in records if r["wall"] <= span_end]
        post_reclaim_bad = sum(
            1 for r in records
            if r["wall"] > span_end and slo.is_bad(r))
        bad_walls = [r["wall"] for r in in_span if slo.is_bad(r)]
        if not bad_walls:
            recovery_wall = ups[0]["wall"]
        else:
            candidate = max(max(bad_walls) + sw, ups[0]["wall"])
            good_after = [r for r in in_span
                          if r["wall"] > max(bad_walls)
                          and not slo.is_bad(r)]
            if candidate < span_end and good_after:
                recovery_wall = candidate
        if recovery_wall is not None:
            bl, bs = burn_at(span_end)
            # the burn must actually read clean at the span's end
            if (bl is not None and bl > 1.0) or \
                    (bs is not None and bs > 1.0):
                recovery_wall = None
        if recovery_wall is not None:
            summary["slo_recovery_s"] = round(
                recovery_wall - ups[0]["wall"], 3)
    summary["slo_recovered"] = recovery_wall is not None
    summary["post_reclaim_bad"] = post_reclaim_bad
    # --- capacity return
    summary["capacity_returned"] = bool(
        reclaims and reclaims[-1].get("to_workers") == train_workers)
    # --- zero dropped requests
    sched = seeded_spike_schedule(
        seed, **{k: v for k, v in spike.items() if k != "linger_s"})
    seen = completed_ids_all(tdir)
    missing = sorted({r.id for r in sched} - set(seen))
    summary["requests"] = {"scheduled": len(sched),
                           "served": len(seen),
                           "dropped": len(missing),
                           "missing_ids": missing[:8]}
    # --- goodput: whole-run per job + serve phases before/during/after
    ledgers = {}
    for role, d in (("serve", serve_dir), ("train", train_dir)):
        led = tv_goodput.ledger_from_run(d)
        wall = led["wall_s"]
        ledgers[role] = {
            "wall_s": round(wall, 3),
            "goodput_frac": (round(led["goodput_frac"], 4)
                             if led["goodput_frac"] is not None
                             else None),
            "identity_error_frac": (
                round(abs(led["identity_error_s"]) / wall, 6)
                if wall > 0 else None),
            "badput_s": {k: round(v, 3)
                         for k, v in led["badput_s"].items()},
        }
    summary["ledger"] = ledgers
    phases = {}
    bounds = {
        "before": (epoch, spike_start_wall),
        "during": (spike_start_wall,
                   recovery_wall if recovery_wall is not None
                   else epoch + spike["spike_end_s"]),
        "after": (recovery_wall if recovery_wall is not None
                  else epoch + spike["spike_end_s"],
                  epoch + spike["duration_s"]
                  + spike.get("linger_s", 0.0)),
    }
    for name, (lo, hi) in bounds.items():
        led = _phase_ledger(serve_events, lo, hi)
        phases[name] = {
            "wall_s": round(led["wall_s"], 3),
            "goodput_frac": (round(led["goodput_frac"], 4)
                             if led["goodput_frac"] is not None
                             else None)}
        in_phase = [r for r in records if lo <= r["wall"] < hi
                    and isinstance(r.get("latency_s"), (int, float))]
        if in_phase:
            lats = sorted(r["latency_s"] for r in in_phase)
            phases[name]["p99_latency_ms"] = round(
                lats[min(len(lats) - 1,
                         int(0.99 * (len(lats) - 1)))] * 1e3, 1)
            phases[name]["completions"] = len(in_phase)
    summary["phases"] = phases
    # --- warm resume evidence: restore tiers in the train job's scale
    # generations (the donation must NOT be a cold restart)
    scale_gens = {e.get("generation") for e in flat_train
                  if e.get("ev") == "scale.applied"}
    tiers = [{"generation": e.get("generation"), "tier": e.get("tier"),
              "step": e.get("step"),
              "best_available": e.get("best_available")}
             for e in flat_train
             if e.get("ev") == "recovery.restore_tier"
             and e.get("generation") in scale_gens]
    summary["train_restore_tiers"] = tiers
    summary["train_warm_resume"] = bool(
        tiers and all(t["tier"] not in (None, "none") for t in tiers)
        and any(t["tier"] in ("host", "peer", "memory")
                for t in tiers))
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=3,
                    help="fixed worker budget shared by both jobs")
    ap.add_argument("--train-workers", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed (arrivals + prompts)")
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    # workload shape
    ap.add_argument("--duration", type=float, default=50.0)
    ap.add_argument("--base-qps", type=float, default=1.5)
    ap.add_argument("--spike-qps", type=float, default=6.0)
    ap.add_argument("--spike-start", type=float, default=10.0)
    ap.add_argument("--spike-end", type=float, default=26.0)
    ap.add_argument("--linger", type=float, default=25.0,
                    help="replicas keep serving (idle) this long past "
                         "the schedule so the clear window and the "
                         "reclaim happen in-run")
    # capacity/pacing
    ap.add_argument("--max-slots", type=int, default=2,
                    help="decode slots per replica (capacity knob)")
    ap.add_argument("--serve-step-delay", type=float, default=0.15,
                    help="per-engine-step pacing: sets one replica's "
                         "capacity (~3 req/s) just above base-qps and "
                         "well under spike-qps, so the spike — and "
                         "only the spike — saturates")
    ap.add_argument("--train-step-delay", type=float, default=0.05)
    ap.add_argument("--train-steps", type=int, default=100000,
                    help="effectively 'train forever'; the fleet stops "
                         "the trainer once serving completes")
    ap.add_argument("--save-every", type=int, default=40)
    ap.add_argument("--snapshot-every", type=int, default=10)
    # policy knobs (the README Autoscaling table)
    ap.add_argument("--latency-slo-ms", type=float, default=2000.0)
    ap.add_argument("--min-evidence", type=int, default=4,
                    help="completions required inside the short burn "
                         "window before a firing reading counts — at "
                         "base qps the window can't hold this many, "
                         "so only the spike can fire (no-evidence "
                         "startup blips can't)")
    ap.add_argument("--burn-threshold", type=float, default=2.0)
    ap.add_argument("--burn-window-long", type=float, default=6.0)
    ap.add_argument("--burn-window-short", type=float, default=2.0)
    ap.add_argument("--fire-consecutive", type=int, default=2)
    ap.add_argument("--clear-burn", type=float, default=1.0)
    ap.add_argument("--clear-hold", type=float, default=5.0)
    ap.add_argument("--cooldown", type=float, default=15.0,
                    help="min gap between applied scale actions; keep "
                         "it past long-window + reform time so the "
                         "transition's own slow completions can't "
                         "re-trigger a flap")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=2)
    ap.add_argument("--train-floor", type=int, default=1)
    ap.add_argument("--generation-timeout", type=float, default=600.0)
    torch_entry.add_device_flag(ap)
    return ap


def run(args) -> dict:
    torch_entry.check_device(args.device, PROG)
    summary = run_fleet(args)
    su = summary["scale_up"]
    print(f"spike table: scale_up_latency="
          f"{su.get('scale_up_latency_s', '-')}s "
          f"(detect {su.get('detect_s', '-')}s + actuate "
          f"{su.get('actuation_s', '-')}s), "
          f"burn peak {summary.get('burn_peak_short')}x, "
          f"slo_recovery={summary.get('slo_recovery_s', '-')}s, "
          f"capacity_returned={summary['capacity_returned']}, "
          f"dropped={summary['requests']['dropped']}")
    for role, led in summary["ledger"].items():
        print(f"  {role}: goodput {led['goodput_frac']}, "
              f"scale_transition {led['badput_s']['scale_transition']}s"
              f", identity err {led['identity_error_frac']}")
    print(f"summary: {os.path.join(args.telemetry_dir or '', 'spike-summary.json')}")
    torch_entry.write_report({"summary": summary})
    return summary


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

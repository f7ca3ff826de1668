#!/usr/bin/env python3
"""Multi-tenant routed serving on the port: an affinity router in its own
process in front of supervised router-fed replicas.

The port's counterpart of ``examples/serve_router.py``. One seeded
multi-tenant workload (an interactive tenant, a batch tenant and a
quota-capped interactive tenant, with an interactive traffic spike)
runs twice:

- **affinity phase**: ``--workers`` ``routed_replica``s under the
  ``RecoverySupervisor``, each tailing its inbox, exporting live
  metrics and logging completions, with the ``Router`` in a process of
  its own: it paces the seeded arrivals from the shared epoch, admits
  under per-tenant quotas and weighted-fair priority classes, routes by
  prefix-cache affinity (least-loaded by scraped queue depth as the
  fallback), journals every decision, acks from the union of the
  completion logs and re-routes unacked work off replicas whose scrape
  goes stale. ``--kill-seed`` SIGKILLs a replica mid-load (the
  supervisor's chaos plan) and the router once, a seeded time after the
  run epoch: the respawned router resumes from its journal.
- **random phase**: the same workload, the same kills, ``policy=
  "random"`` — the baseline the affinity hit rate is measured against.

``analyze`` writes ``router-summary.json`` with the JAX example's
fields: dropped requests, duplicates and mismatched duplicates, the
journal's double-route audit, per-tenant rejects and sheds, per-class
latency, the affinity and random prefix-hit rates and the goodput
ledger.

    python3 tools/torch_serve_router.py --device cpu --preset tiny \\
        --run-dir /tmp/router --workers 2 --kill-seed 0

``--preset tiny`` is JAX's replica model (``tiny(max_seq_len=64)``) and
workload; ``--preset transformer_big`` serves ``transformer_big()``
(random weights from seed 0) on prompts of a 256-token session prefix
(16 blocks of 16) and a 16-64-token suffix, with the token budgets and
quotas scaled by the requests' size. ``--device cuda`` (the default)
puts replica ``i`` on card ``i``; the router uses no card. There the
tiny preset's replicas run JAX's tiny config, attention through
``mha_reference`` (no flash kernel), and its chaos arrivals last
``CARD_CHAOS_DURATION_S``.
"""

import argparse
import json
import os
import signal
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

#: workload shape of both phases (JAX's): the spike multiplies the
#: INTERACTIVE arrival rates inside the window
WORKLOAD = dict(duration_s=22.0, spike=(6.0, 12.0, 4.0),
                sessions_per_tenant=6, session_prefix_blocks=3,
                block_size=8, rates={"acme": 2.5, "batchco": 1.2,
                                     "burst": 1.5})

#: the chaos variant: arrivals outlast the restart outage, so the
#: recovery window has samples after it
CHAOS_WORKLOAD = dict(WORKLOAD, duration_s=44.0,
                      rates={"acme": 1.8, "batchco": 0.8,
                             "burst": 1.2})

#: the chaos variant's arrivals on the card at the tiny preset. JAX's
#: 44 s were sized for a 15-20 s gang-restart outage; on an H100 beside
#: three other chaos sweeps a respawned replica (spawn, torch import,
#: CUDA init, warm-up) took 25.4 s, its warm-up ended at 37.7 s and the
#: recovery window (warm-up + CHAOS_RECOVERY_LAG_S) opened after the
#: last arrival, with no sample to judge. 20 s more arrivals at the same
#: rates keep the window's samples with JAX's gate unchanged
CARD_CHAOS_DURATION_S = 64.0

#: arrivals this long after the disturbance ends (the spike's end, or
#: the last respawned replica's warm-up under chaos) must meet the
#: tenant SLO again
RECOVERY_LAG_S = 5.0
CHAOS_RECOVERY_LAG_S = 10.0

#: per preset: the model (None: JAX's tiny), the workload's prompt
#: shape, the replicas' engine, and ``scale``, the factor on the
#: token-denominated budgets (tick budget, quotas) — a request's mean
#: cost (prompt + new tokens) over the tiny workload's
PRESETS = {
    "tiny": dict(workload={}, engine={}, scale=1,
                 card_chaos_duration_s=CARD_CHAOS_DURATION_S),
    "transformer_big": dict(
        workload=dict(block_size=16, session_prefix_blocks=16,
                      suffix_range=(16, 64), new_tokens_range=(16, 64),
                      vocab_size=32768),
        engine=dict(num_blocks=768, block_size=16, max_slots=8,
                    max_prompt_len=320),
        scale=11),
}


def model_config(preset: str, dtype: str = "bfloat16"):
    """The replicas' model: None (JAX's tiny) or ``transformer_big()``
    in ``dtype`` on the flash forward."""
    if preset == "tiny":
        return None
    import torch

    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.transformer_big(dtype=getattr(torch, dtype))


def workload_params(chaos: bool, preset: str = "tiny",
                    device: str = "cpu") -> dict:
    """The workload's shape: JAX's, the preset's prompt shape, and under
    chaos on the card the preset's ``card_chaos_duration_s``."""
    wl = dict(CHAOS_WORKLOAD if chaos else WORKLOAD,
              **PRESETS[preset]["workload"])
    card_s = PRESETS[preset].get("card_chaos_duration_s")
    if chaos and device == "cuda" and card_s:
        wl["duration_s"] = card_s
    return wl


def phase_tenants(preset: str = "tiny"):
    """The three-tenant contract (JAX's): a weighted interactive
    tenant, a batch tenant with a long SLO and early anti-starvation
    promotion, and a quota-capped interactive tenant whose overrun
    exercises ``serve.reject cause=quota``; the quota scaled by the
    preset's request size."""
    from distributed_tensorflow_tpu_torch.serving.tenancy import (
        TenantConfig)
    k = PRESETS[preset]["scale"]
    return (
        TenantConfig("acme", pclass="interactive", weight=2.0,
                     slo_latency_s=2.0),
        TenantConfig("batchco", pclass="batch", weight=1.0,
                     slo_latency_s=15.0, starvation_frac=0.15),
        TenantConfig("burst", pclass="interactive", weight=1.0,
                     quota_tokens_per_s=40.0 * k, quota_burst=80.0 * k,
                     slo_latency_s=2.0),
    )


def router_main(run_dir: str, tdir: str, seed: int, policy: str,
                n_replicas: int, chaos: bool = False,
                preset: str = "tiny", device: str = "cpu",
                tick_s: float = 0.04,
                max_wall_s: float = 240.0):
    """The router process (spawn target; both incarnations run this —
    the second resumes from the journal the first left)."""
    from distributed_tensorflow_tpu_torch.serving import replica as rep
    from distributed_tensorflow_tpu_torch.serving import router as rt
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    tv_events.configure(tdir, process_id="router")
    replicas = list(range(n_replicas))
    wl_params = workload_params(chaos, preset, device)

    # wait until every replica's exporter has ticked once (its engine is
    # warm): arrivals must not start while the fleet is starting up
    mfile = {t: os.path.join(rep.replica_metrics_dir(run_dir, t),
                             "metrics-live.prom") for t in replicas}
    deadline = time.time() + 120.0
    while (not all(os.path.exists(p) for p in mfile.values())
           and time.time() < deadline
           and not os.path.exists(os.path.join(run_dir,
                                               "run-epoch.json"))):
        time.sleep(0.05)
    epoch = rep.run_epoch(run_dir)      # first router incarnation wins

    def clock():
        return time.time() - epoch

    def submit(replica, request, meta):
        # line-buffered append; a replica rewinds the torn tail of a
        # router SIGKILLed mid-write
        with open(rep.inbox_path(run_dir, replica), "a",
                  buffering=1) as f:
            f.write(json.dumps(rep.request_to_wire(request, meta))
                    + "\n")

    router = rt.Router(replicas=replicas, tenants=phase_tenants(preset),
                       submit_fn=submit, policy=policy,
                       block_size=wl_params["block_size"],
                       tick_token_budget=16 * PRESETS[preset]["scale"],
                       seed=seed, run_dir=run_dir, reroute_timeout_s=3.0,
                       clock=clock)
    wl = rt.seeded_tenant_workload(seed, tenants=phase_tenants(preset),
                                   **wl_params)
    import collections
    pending = collections.deque(wl)
    t_end = time.time() + max_wall_s
    while time.time() < t_end:
        now = clock()
        while pending and pending[0].arrival_s <= now:
            router.offer(pending.popleft())
        depths = {}
        stale = set()
        for t, p in mfile.items():
            try:
                m = os.path.getmtime(p)
            except OSError:
                continue
            if time.time() - m > 1.5:
                stale.add(t)
            else:
                d = rt.parse_queue_depth(p)
                if d is not None:
                    depths[t] = d
        router.observe_depths(depths)
        router.dispatch(stale=stale)
        router.note_completed(rep.completed_ids_all(run_dir))
        router.tick_reroutes(stale=stale)
        if not pending and not router.queued and not router.inflight:
            break
        time.sleep(tick_s)
    router.emit_tenant_summary()
    stats = router.stats()
    stats["drained_clean"] = (not pending and not router.queued
                              and not router.inflight)
    tmp = os.path.join(run_dir, "router-stats.json.tmp")
    with open(tmp, "w") as f:
        json.dump(stats, f, indent=2, default=str)
    os.replace(tmp, os.path.join(run_dir, "router-stats.json"))
    for t in replicas:                  # release the fleet
        with open(rep.inbox_path(run_dir, t), "a", buffering=1) as f:
            f.write(json.dumps({"eof": True}) + "\n")
    router.close()
    tv_events.shutdown()
    print(f"[router] done: {stats['routes']} routed, "
          f"{stats['reroutes']} rerouted, "
          f"{stats['acked']} acked", flush=True)


def run_phase(phase_dir: str, seed: int, policy: str, workers: int,
              kill_seed=None, router_kill_s=None, *, device="cuda",
              preset: str = "tiny", dtype: str = "bfloat16") -> dict:
    """One phase: the supervised replica fleet and the router process
    (SIGKILLed and respawned once, ``router_kill_s`` after the run
    epoch, when given). Returns the supervisor's restarts and last
    generation, whether the router was killed, and the supervisor's
    result."""
    import multiprocessing as mp
    import threading

    from distributed_tensorflow_tpu_torch.resilience import (
        RecoverySupervisor, seeded_kill_plan)
    from distributed_tensorflow_tpu_torch.serving.replica import (
        routed_replica)

    os.makedirs(phase_dir, exist_ok=True)
    tdir = os.path.join(phase_dir, "telemetry")
    kill_plan = ()
    if kill_seed is not None:
        kill_plan = seeded_kill_plan(kill_seed, workers, kills=1,
                                     step_range=(40, 120))
        print(f"[{os.path.basename(phase_dir)}] replica kill plan "
              f"(seed {kill_seed}): {kill_plan}", flush=True)

    ctx = mp.get_context("spawn")
    rargs = (phase_dir, tdir, seed, policy, workers,
             kill_seed is not None, preset, device)
    router_proc = ctx.Process(target=router_main, args=rargs,
                              name="dtx-router")
    router_proc.start()
    procs = [router_proc]
    router_kills: list = []

    def _chaos_router():
        # the kill lands router_kill_s into the arrivals: the fleet's
        # start-up (which sets the epoch) varies with the model
        epoch_path = os.path.join(phase_dir, "run-epoch.json")
        while not os.path.exists(epoch_path) and router_proc.is_alive():
            time.sleep(0.05)
        time.sleep(router_kill_s)
        if router_proc.is_alive():
            print(f"[chaos] SIGKILL router pid {router_proc.pid} at "
                  f"epoch+{router_kill_s:.1f}s", flush=True)
            os.kill(router_proc.pid, signal.SIGKILL)
            router_proc.join()
            router_kills.append(router_proc.pid)
            r2 = ctx.Process(target=router_main, args=rargs,
                             name="dtx-router-2")
            r2.start()
            procs.append(r2)

    killer = None
    if router_kill_s is not None:
        killer = threading.Thread(target=_chaos_router, daemon=True)
        killer.start()

    engine_kwargs = dict(PRESETS[preset]["engine"], device=device)
    sup = RecoverySupervisor(
        routed_replica, num_workers=workers, args=(phase_dir, seed),
        kwargs={"step_delay_s": 0.0, "engine_kwargs": engine_kwargs,
                "cfg": model_config(preset, dtype)},
        device=device, max_restarts=6, kill_plan=kill_plan,
        generation_timeout_s=300.0, telemetry_dir=tdir)
    try:
        result = sup.run()
        if killer is not None:
            killer.join(timeout=60.0)
        procs[-1].join(timeout=90.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
    for task, served, total in sorted(result.return_values):
        print(f"[{os.path.basename(phase_dir)}] replica {task}: "
              f"served {served} this generation", flush=True)
    return {"restarts": sup.restarts_used,
            "router_killed": bool(router_kills),
            "generation": sup.generation, "result": result}


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _hit_rate(tdir: str) -> "tuple[float, int]":
    """Prefix-cache hit rate over a phase's ``serve.prefill`` events
    (warm-ups excluded): hit tokens / prompt tokens."""
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    cached = prompt = 0
    for events in tv_events.read_run(tdir).values():
        for ev in events:
            if ev.get("ev") != "serve.prefill" \
                    or str(ev.get("id", "")).startswith("warmup-"):
                continue
            prompt += int(ev.get("prompt_tokens") or 0)
            cached += int(ev.get("cached_tokens") or 0)
    return (cached / prompt if prompt else 0.0), prompt


def served_union(phase_dir: str) -> "tuple[dict, int, int, list]":
    """``(first tokens by id, duplicates, mismatched duplicates, the
    first mismatched id or None)`` over a phase's completion logs."""
    import glob as _glob
    served: dict = {}
    duplicates = mismatched = 0
    first = None
    for path in sorted(_glob.glob(os.path.join(phase_dir,
                                               "served-*.jsonl"))):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                rid, toks = rec.get("id"), rec.get("tokens")
                if rid is None:
                    continue
                if rid in served:
                    duplicates += 1
                    if served[rid] != toks:
                        mismatched += 1
                        first = first or rid
                else:
                    served[rid] = toks
    return served, duplicates, mismatched, first


def analyze(run_dir: str, seed: int, chaos: bool = False,
            preset: str = "tiny", policy: str = "affinity",
            device: str = "cpu") -> dict:
    """Cross-phase verdicts -> ``router-summary.json`` (JAX's fields):
    the ``policy`` phase's directory against ``random``'s."""
    from distributed_tensorflow_tpu_torch.serving import router as rt
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    aff = os.path.join(run_dir, policy)
    rnd = os.path.join(run_dir, "random")
    tenants = {t.name: t for t in phase_tenants(preset)}
    wl_params = workload_params(chaos, preset, device)
    wl = rt.seeded_tenant_workload(seed, tenants=phase_tenants(preset),
                                   **wl_params)

    # ---- zero dropped + byte-identical duplicates (affinity phase) --
    journal = rt.RouterJournal.replay(
        os.path.join(aff, rt.ROUTER_JOURNAL))
    rejected = {r["id"] for r in journal if r["kind"] == "reject"}
    route_counts: dict = {}
    for r in journal:
        if r["kind"] == "route":
            route_counts[r["id"]] = route_counts.get(r["id"], 0) + 1
    double_routes = sum(1 for n in route_counts.values() if n > 1)
    served_tokens, duplicates, mismatched, _ = served_union(aff)
    expected = {r.id for r in wl} - rejected
    dropped = sorted(expected - set(served_tokens))

    # ---- per-class latency + recovery/starvation verdicts -----------
    by_class: dict = {}     # pclass -> [(rid, lat)]
    reject_by: dict = {}
    sheds = 0
    spike_end = wl_params["spike"][1]
    last_warm_wall = None   # when the LAST (re)spawned replica warmed
    for events in tv_events.read_run(
            os.path.join(aff, "telemetry")).values():
        for ev in events:
            name = ev.get("ev")
            if name == "serve.request" and ev.get("tenant"):
                lat = float(ev.get("dur_s") or 0.0)
                by_class.setdefault(ev.get("pclass"), []).append(
                    (ev.get("id"), lat))
            elif name == "serve.prefill" \
                    and str(ev.get("id", "")).startswith("warmup-"):
                w = float(ev.get("wall") or 0.0)
                if last_warm_wall is None or w > last_warm_wall:
                    last_warm_wall = w
            elif name == "serve.reject":
                key = (ev.get("tenant") or "-",
                       ev.get("cause") or "-")
                reject_by[key] = reject_by.get(key, 0) + 1
            elif name == "router.shed":
                sheds += 1

    def _pct(vals, q):
        if not vals:
            return None
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(q * (len(vals) - 1)))]

    # recovery window: arrivals after the LAST disturbance settles (the
    # spike's end or the last respawned replica's warm-up) plus a lag
    recover_rel = spike_end
    epoch_path = os.path.join(aff, "run-epoch.json")
    if last_warm_wall is not None and os.path.exists(epoch_path):
        with open(epoch_path) as f:
            epoch = float(json.load(f)["epoch"])
        recover_rel = max(recover_rel, last_warm_wall - epoch)
    recover_rel += CHAOS_RECOVERY_LAG_S if chaos else RECOVERY_LAG_S
    arrivals = {r.id: r.arrival_s for r in wl}

    def _window(pclass):
        return [lat for rid, lat in by_class.get(pclass, [])
                if arrivals.get(rid, -1.0) >= recover_rel]

    post = _window("interactive")
    batch_post = _window("batch")
    acme_slo = tenants["acme"].slo_latency_s
    interactive_recovered = (bool(post)
                             and (_pct(post, 0.99) or 9e9) <= acme_slo)
    batch_lats = [lat for _, lat in by_class.get("batch", [])]
    batch_slo = tenants["batchco"].slo_latency_s
    if chaos:
        # outage-spanning batch waits are the outage's cost; starvation
        # is batch STILL past its SLO after the fleet recovered
        batch_starved = (bool(batch_post)
                         and (_pct(batch_post, 0.99) or 9e9)
                         > batch_slo)
    else:
        batch_starved = bool(batch_lats) and max(batch_lats) > batch_slo

    # ---- affinity vs random hit rate (same seeded workload) ---------
    hit_aff, ptoks_aff = _hit_rate(os.path.join(aff, "telemetry"))
    hit_rnd, ptoks_rnd = _hit_rate(os.path.join(rnd, "telemetry"))

    # ---- goodput identity with the re-route cost priced -------------
    ledger = goodput.ledger_from_run(os.path.join(aff, "telemetry"))
    wall = ledger.get("wall_s") or 0.0
    identity_frac = (abs(ledger.get("identity_error_s") or 0.0)
                     / wall if wall > 0 else 0.0)

    stats_path = os.path.join(aff, "router-stats.json")
    router_stats = {}
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            router_stats = json.load(f)

    summary = {
        "seed": seed,
        "requests": len(wl),
        "rejected_quota": len(rejected),
        "served_unique": len(served_tokens),
        "dropped": dropped,
        "duplicates": duplicates,
        "duplicates_mismatched": mismatched,
        "double_routes": double_routes,
        "reroutes": router_stats.get("reroutes", 0),
        "route_reasons": router_stats.get("route_reasons", {}),
        "sheds": sheds,
        "rejects_by_tenant_cause": {f"{t}/{c}": n for (t, c), n
                                    in sorted(reject_by.items())},
        "interactive_p50_s": _pct([lat for _, lat in
                                   by_class.get("interactive", [])],
                                  0.5),
        "interactive_p99_s": _pct([lat for _, lat in
                                   by_class.get("interactive", [])],
                                  0.99),
        "batch_p50_s": _pct(batch_lats, 0.5),
        "batch_p99_s": _pct(batch_lats, 0.99),
        "batch_max_s": max(batch_lats) if batch_lats else None,
        "interactive_recovered": interactive_recovered,
        "interactive_recovery_p99_s": _pct(post, 0.99),
        "recovery_window_start_s": round(recover_rel, 2),
        "recovery_samples": {"interactive": len(post),
                             "batch": len(batch_post)},
        "batch_recovery_p99_s": _pct(batch_post, 0.99),
        "batch_starved_past_slo": batch_starved,
        "affinity_hit_rate": round(hit_aff, 4),
        "random_hit_rate": round(hit_rnd, 4),
        "affinity_uplift": round(hit_aff - hit_rnd, 4),
        "prompt_tokens": {"affinity": ptoks_aff, "random": ptoks_rnd},
        "goodput_frac": ledger.get("goodput_frac"),
        "identity_error_frac": round(identity_frac, 6),
        "badput_reroute_replay_s": round(
            ledger["badput_s"].get("reroute_replay", 0.0), 4),
        "badput_recovery_s": round(
            ledger["badput_s"].get("recovery", 0.0), 4),
    }
    out = os.path.join(run_dir, "router-summary.json")
    with open(out + ".tmp", "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(out + ".tmp", out)
    return summary


def router_kill_after_s(kill_seed: int) -> float:
    """The router's seeded kill time, seconds after the run epoch
    (JAX's draw: inside the spike window)."""
    import random as _random
    rng = _random.Random(f"dtx-router-kill:{kill_seed}")
    return 8.0 + 4.0 * rng.random()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (replica i on card i) or cpu")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--policy", default="affinity",
                    choices=("affinity", "least_loaded", "random"),
                    help="the first phase's routing policy")
    ap.add_argument("--kill-seed", type=int, default=None,
                    help="SIGKILL one replica mid-load (supervisor "
                         "chaos plan) AND the router at a seeded time")
    ap.add_argument("--skip-random", action="store_true",
                    help="skip the random-routing baseline phase")
    args = ap.parse_args()
    os.makedirs(args.run_dir, exist_ok=True)
    router_kill_s = (None if args.kill_seed is None
                     else router_kill_after_s(args.kill_seed))
    kw = dict(device=args.device, preset=args.preset)

    t0 = time.time()
    info = run_phase(os.path.join(args.run_dir, args.policy),
                     args.seed, args.policy, args.workers,
                     kill_seed=args.kill_seed,
                     router_kill_s=router_kill_s, **kw)
    print(f"[{args.policy}] phase done in {time.time() - t0:.1f}s: "
          f"{info['restarts']} restarts, router killed "
          f"{info['router_killed']}", flush=True)
    if args.skip_random or args.policy == "random":
        return 0
    # the baseline suffers the SAME kill plan: affinity against random
    # is fair only if both phases lose the same caches
    t1 = time.time()
    info2 = run_phase(os.path.join(args.run_dir, "random"),
                      args.seed, "random", args.workers,
                      kill_seed=args.kill_seed,
                      router_kill_s=router_kill_s, **kw)
    print(f"[random] phase done in {time.time() - t1:.1f}s: "
          f"{info2['restarts']} restarts", flush=True)
    summary = analyze(args.run_dir, args.seed,
                      chaos=args.kill_seed is not None,
                      preset=args.preset, policy=args.policy,
                      device=args.device)
    print(json.dumps(summary, indent=2))
    ok = (not summary["dropped"]
          and summary["duplicates_mismatched"] == 0
          and summary["double_routes"] == 0
          and summary["interactive_recovered"]
          and not summary["batch_starved_past_slo"]
          and summary["affinity_hit_rate"] > summary["random_hit_rate"])
    print(f"router verdict: {'OK' if ok else 'VIOLATIONS'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Live model rollout on the port: zero-downtime hot-swap + SLO-gated
canary — the counterpart of ``examples/live_rollout.py``.

Two snapshots of the serving model sit in one checkpoint directory —
the BASE version (step 1) and a TARGET version (step 2). Supervised
serving replicas serve a seeded open-loop workload while a
``resilience/rollout.py RolloutController``, ticked from the
supervisor's watch loop, ramps the fleet: the first replica hot-swaps
to the target at once (the canary: ``begin_load_version`` restores in
the background and the flip lands at a step boundary, in-flight
requests re-queued, none dropped), every further replica moves only
after the canary's per-version SLO burn stays clear, and a burning
canary rolls the whole fleet back to the pinned base.

- ``--null-swap``: step 2 has byte-identical weights; every completion
  must match the no-swap reference.
- ``--bad-canary``: the target is degraded (a per-step delay while
  serving it); the controller must roll back.
- ``--restart-mode``: a reassigned replica aborts and the supervisor
  respawns it pinned to the target (``from_checkpoint(at_step=)``).
- ``--kills N``: seeded SIGKILLs through the supervisor mid-rollout;
  completions must still cover the workload, and every completion's
  tokens must equal the pure output of the version it is stamped with.

    python3 tools/torch_live_rollout.py --telemetry-dir /tmp/rollout
    python3 tools/torch_live_rollout.py --device cpu --kills 1

The model is JAX's ``tiny(max_seq_len=64)`` (the canary policy's
latency budget is timed for it); on the card it takes the flash
attention forward (``attention_impl=None``), so every prefill launches
#1. Each replica takes its card from ``LOCAL_RANK`` and joins no
process group; the snapshots' weights are ``init_params`` from a
``torch.Generator`` seeded 0 (base) and 7 (target), where JAX's come
from ``jax.random``. The run's table is recomputed from the telemetry
and completion logs into ``<telemetry-dir>/rollout-summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_live_rollout"
BASE_STEP = 1
TARGET_STEP = 2
_VOCAB = 256

ENGINE_KWARGS = dict(num_blocks=48, block_size=8, max_slots=4,
                     max_prompt_len=16, queue_capacity=4096,
                     prefix_caching=True)


def _cfg(device: str = "cpu"):
    """JAX's ``tiny(max_seq_len=64)``; on the card through the flash
    forward."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    if device == "cpu":
        return TransformerConfig.tiny(max_seq_len=64)
    return TransformerConfig.tiny(max_seq_len=64, attention_impl=None)


def write_snapshots(ckpt_dir: str, *, null_swap: bool = False,
                    device: str = "cpu") -> float:
    """Write the base (step 1) and target (step 2) snapshots; with
    ``null_swap`` the target carries byte-identical weights. Returns
    the target's publish wall (save-commit time)."""
    import time

    import torch

    from distributed_tensorflow_tpu_torch.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        init_params, jax_params_layout)

    cfg = _cfg(device)

    def _params(seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        return jax_params_layout(cfg, init_params(cfg, gen, "cpu"))

    for step, seed in ((BASE_STEP, 0),
                       (TARGET_STEP, 0 if null_swap else 7)):
        mgr = CheckpointManager(Checkpoint(params=_params(seed)),
                                ckpt_dir, max_to_keep=8)
        mgr.save(step)
    return time.time()


def rollout_workload(seed: int, *, duration_s: float = 24.0,
                     qps: float = 5.0) -> list:
    """Constant-rate seeded open-loop arrivals (the spike schedule with
    the spike flattened away), JAX's exactly."""
    from distributed_tensorflow_tpu_torch.serving.replica import (
        seeded_spike_schedule)
    return seeded_spike_schedule(
        seed, duration_s=duration_s, base_qps=qps, spike_qps=qps,
        spike_start_s=0.0, spike_end_s=0.0, vocab_size=_VOCAB,
        new_tokens_range=(2, 6))


def reference_outputs(ckpt_dir: str, requests: list, step: int,
                      device: str = "cpu") -> dict:
    """``{request_id: tokens}`` a pure engine pinned at ``step``
    produces for ``requests``, one at a time: the no-mixed-version
    oracle."""
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    eng = InferenceEngine.from_checkpoint(
        _cfg(device), ckpt_dir, at_step=step, device=device,
        **ENGINE_KWARGS)
    out = {}
    for r in requests:
        eng.submit(r)
        while not eng.scheduler.idle:
            for rec in eng.step():
                out[rec["id"]] = list(rec["tokens"])
    return out


def rollout_replica(run_dir: str, ckpt_dir: str, assignment_path: str,
                    seed: int, *, duration_s: float = 24.0,
                    qps: float = 5.0, step_delay_s: float = 0.0,
                    bad_step: "int | None" = None,
                    bad_delay_s: float = 0.4,
                    restart_mode: bool = False,
                    engine_kwargs: "dict | None" = None,
                    max_retries: int = 50):
    """One generation of one rollout-managed serving replica (JAX's):
    ``serving/replica.py serving_replica``'s contract plus the rollout
    loop — every step it polls the controller's assignment file and,
    when its assigned snapshot differs from the engine's, hot-swaps
    through ``begin_load_version`` (or, under ``restart_mode``, aborts
    so the supervisor respawns it pinned to the assignment).
    ``bad_step`` degrades serving while that version is live."""
    import collections as _collections
    import time as _time

    from distributed_tensorflow_tpu_torch.cluster import elastic
    from distributed_tensorflow_tpu_torch.resilience.faults import (
        FaultInjected)
    from distributed_tensorflow_tpu_torch.resilience.rollout import (
        read_assignment)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.replica import (
        _replica_setup, completed_ids_all, run_epoch)
    from distributed_tensorflow_tpu_torch.serving.scheduler import (
        Request as _Req)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    task, n_replicas, device = _replica_setup(engine_kwargs)
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=task)
    goodput.activate(goodput.GoodputLedger())

    def _assigned() -> "tuple[int, float | None]":
        a = read_assignment(assignment_path)
        if not a:
            return BASE_STEP, None
        return (int(a["assignment"].get(str(task), a["base_step"])),
                a.get("published_wall"))

    kwargs = dict(ENGINE_KWARGS)
    kwargs.update(engine_kwargs or {})
    kwargs["device"] = device
    # a (re)started replica adopts the CURRENT assignment at startup:
    # its pin-restore emits the mode="restart" serve.swap
    start_step, pub_wall = _assigned()
    engine = InferenceEngine.from_checkpoint(
        _cfg(device.type), ckpt_dir, at_step=start_step, **kwargs)

    workload = rollout_workload(seed, duration_s=duration_s, qps=qps)
    done = completed_ids_all(run_dir)
    mine = [r for i, r in enumerate(workload)
            if i % n_replicas == task]
    todo = [r for r in mine if r.id not in done]
    gen = elastic.generation()
    print(f"[gen {gen} rollout-{task}] v{engine.weights_step}, "
          f"{len(mine) - len(todo)} already served, {len(todo)} of "
          f"{len(mine)} to go", flush=True)

    # warm up BEFORE anchoring the epoch (start-up is not client-visible
    # queueing)
    engine.submit(_Req(id=f"warmup-{task}-g{gen}", tokens=(1, 2, 3),
                       max_new_tokens=2))
    engine.run_until_idle(retry_faults=True)
    epoch = run_epoch(run_dir)

    pending = _collections.deque(todo)
    served = 0
    step = 0
    retries = 0
    log_path = os.path.join(run_dir, f"served-{task}.jsonl")
    with open(log_path, "a", buffering=1) as log:
        while (pending or not engine.scheduler.idle
               or _time.time() - epoch < duration_s):
            elastic.heartbeat(step)
            target, pub_wall = _assigned()
            if (target != engine.weights_step
                    and engine._pending_swap is None
                    and (engine._swap_thread is None
                         or not engine._swap_thread.is_alive())):
                if restart_mode:
                    # the pre-hot-swap world: a new version means a
                    # rolling restart — abort, respawn, re-pin
                    print(f"[gen {gen} rollout-{task}] restart for "
                          f"v{target}", flush=True)
                    log.flush()
                    tv_events.shutdown()
                    os._exit(1)
                engine.begin_load_version(target,
                                          published_wall=pub_wall)
            now_rel = _time.time() - epoch
            while pending and pending[0].arrival_s <= now_rel:
                r = pending.popleft()
                engine.submit(r, arrival_wall=epoch + r.arrival_s)
            if engine.scheduler.idle and engine._pending_swap is None:
                _time.sleep(min(0.05, max(
                    0.001, (pending[0].arrival_s - now_rel)
                    if pending else 0.05)))
                continue
            if step_delay_s:
                _time.sleep(step_delay_s)
            if bad_step is not None and engine.weights_step == bad_step:
                # the degraded candidate: every step under it drags
                _time.sleep(bad_delay_s)
            try:
                finished = engine.step()
            except FaultInjected:
                retries += 1
                if retries > max_retries:
                    raise
                finished = []
            for rec in finished:
                log.write(json.dumps({
                    "id": rec["id"], "tokens": rec["tokens"],
                    "prompt_tokens": rec["prompt_tokens"],
                    "latency_s": round(rec["latency_s"], 6),
                    "model_version": rec["model_version"],
                    "gen": gen}) + "\n")
                served += 1
            step += 1
    elastic.heartbeat(step)
    print(f"[gen {gen} rollout-{task}] served {served}, final "
          f"v{engine.weights_step}, swaps={engine.swaps}, "
          f"{retries} injected-fault retries", flush=True)
    torch_entry.write_report({"task": task, "served": served},
                             suffix=f"-{task}-g{gen}")
    goodput.activate(None)
    if tdir:
        tv_events.shutdown()
    return task, served, engine.weights_step


def build_policy(args):
    from distributed_tensorflow_tpu_torch.resilience.rollout import (
        RolloutPolicy)
    from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo
    slo = tv_slo.SLO("rollout_p99_latency", "latency", objective=0.9,
                     threshold_s=args.latency_slo_ms / 1e3,
                     windows=((args.burn_window_long,
                               args.burn_window_short,
                               args.burn_threshold),))
    return RolloutPolicy(
        fire_consecutive=args.fire_consecutive,
        clear_hold_s=args.clear_hold,
        clear_burn=args.clear_burn,
        cooldown_s=args.cooldown,
        interval_s=0.25,
        min_evidence=args.min_evidence,
        slo=slo)


def run_rollout(args) -> dict:
    """One supervised rollout run; returns the analysis summary (also
    written to ``<telemetry-dir>/rollout-summary.json``)."""
    import tempfile

    from distributed_tensorflow_tpu_torch.resilience.autoscaler import (
        serving_records_fn)
    from distributed_tensorflow_tpu_torch.resilience.rollout import (
        RolloutController)
    from distributed_tensorflow_tpu_torch.resilience.supervisor import (
        RecoverySupervisor, seeded_kill_plan)

    tdir = args.telemetry_dir or tempfile.mkdtemp(prefix="dtx_rollout_")
    os.makedirs(tdir, exist_ok=True)
    ckpt_dir = args.ckpt_dir or os.path.join(tdir, "ckpt")
    published_wall = write_snapshots(ckpt_dir, null_swap=args.null_swap,
                                     device=args.device)
    assignment_path = os.path.join(tdir, "rollout-target.json")
    policy = build_policy(args)
    ctrl = RolloutController(
        [str(i) for i in range(args.replicas)],
        base_step=BASE_STEP, target_step=TARGET_STEP,
        policy=policy, assignment_path=assignment_path,
        published_wall=published_wall,
        records_fn=serving_records_fn(tdir))
    kill_plan = (seeded_kill_plan(args.seed, args.replicas,
                                  kills=args.kills,
                                  step_range=tuple(args.kill_steps))
                 if args.kills else ())
    sup = RecoverySupervisor(
        torch_entry.worker(PROG, "rollout_replica"),
        num_workers=args.replicas,
        args=(tdir, ckpt_dir, assignment_path, args.seed),
        kwargs=dict(duration_s=args.duration, qps=args.qps,
                    step_delay_s=args.step_delay,
                    bad_step=(TARGET_STEP if args.bad_canary else None),
                    bad_delay_s=args.bad_delay,
                    restart_mode=args.restart_mode,
                    engine_kwargs={"device": args.device}),
        device=args.device,
        telemetry_dir=tdir,
        autoscaler=ctrl,
        kill_plan=kill_plan,
        max_restarts=max(6, 2 * args.replicas + 2 * args.kills),
        generation_timeout_s=args.generation_timeout)
    print(f"live rollout: {args.replicas} replica(s), v{BASE_STEP} -> "
          f"v{TARGET_STEP}"
          f"{' (null swap)' if args.null_swap else ''}"
          f"{' (bad canary)' if args.bad_canary else ''}"
          f"{' (restart mode)' if args.restart_mode else ''}"
          f"{f' ({args.kills} seeded kill(s))' if args.kills else ''}, "
          f"{args.duration}s @ {args.qps} qps", flush=True)
    sup.run()
    summary = analyze(tdir, ckpt_dir, args=args, controller=ctrl)
    with open(os.path.join(tdir, "rollout-summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def analyze(tdir: str, ckpt_dir: str, *, args, controller=None) -> dict:
    """The rollout table, recomputed from telemetry + completion logs
    (JAX's): coverage, per-version byte-identity against pure-engine
    references, swap/restart freshness, decisions, the priced
    ``rollout`` badput bucket and the ledger identity."""
    from distributed_tensorflow_tpu_torch.resilience.rollout import (
        read_assignment, version_step)
    from distributed_tensorflow_tpu_torch.serving.replica import (
        completed_ids_all)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput as tv_goodput
    from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo

    device = args.device
    workload = rollout_workload(args.seed, duration_s=args.duration,
                                qps=args.qps)
    by_id = {r.id: r for r in workload}
    events = tv_events.read_run(tdir)
    flat = [e for evs in events.values() for e in evs]

    # --- coverage: the zero-dropped gate
    served = completed_ids_all(tdir)
    served = {k: v for k, v in served.items() if not
              k.startswith("warmup")}
    missing = sorted(set(by_id) - set(served))
    summary: dict = {
        "seed": args.seed,
        "mode": {"null_swap": args.null_swap,
                 "bad_canary": args.bad_canary,
                 "restart_mode": args.restart_mode,
                 "kills": args.kills},
        "requests": {"scheduled": len(workload), "served": len(served),
                     "dropped": len(missing),
                     "missing_ids": missing[:8]},
    }

    # --- versions: every completion's tokens must equal the PURE
    # output of the version it is stamped with (no mixed streams)
    versions: dict = {}
    for pid, evs in events.items():
        for e in evs:
            if e.get("ev") == "serve.request" and "id" in e:
                versions[e["id"]] = e.get("model_version")
    refs = {step: reference_outputs(
                ckpt_dir, [by_id[i] for i in sorted(set(served)
                                                    & set(by_id))],
                step, device)
            for step in (BASE_STEP, TARGET_STEP)}
    mixed = []
    unversioned = 0
    for rid, tokens in served.items():
        step = version_step(versions.get(rid))
        if step is None:
            unversioned += 1
            continue
        if list(tokens) != refs[step].get(rid):
            mixed.append(rid)
    summary["versions"] = {
        "mixed_or_wrong": len(mixed), "examples": mixed[:8],
        "unversioned": unversioned,
        "by_version": {str(s): sum(
            1 for rid in served
            if version_step(versions.get(rid)) == s)
            for s in (BASE_STEP, TARGET_STEP)}}

    # --- swaps + freshness (publish -> per-replica serve.swap)
    swaps = [e for e in flat if e.get("ev") == "serve.swap"]
    summary["swaps"] = {
        "hot": sum(1 for e in swaps if e.get("mode") == "swap"),
        "restart": sum(1 for e in swaps if e.get("mode") == "restart"),
        "requeued": sum(int(e.get("requeued") or 0) for e in swaps),
        "errors": sum(1 for e in flat
                      if e.get("ev") == "serve.swap_error")}
    fresh = tv_slo.freshness_records_from_events(events)
    target_fresh = [r["freshness_s"] for r in fresh
                    if r.get("step") == TARGET_STEP
                    and isinstance(r.get("freshness_s"), (int, float))]
    if target_fresh:
        lst = sorted(target_fresh)

        def _pct(q: float) -> float:
            return lst[min(len(lst) - 1, round(q * (len(lst) - 1)))]

        summary["freshness"] = {
            "n": len(lst),
            "p50_s": round(_pct(0.5), 3),
            "p99_s": round(_pct(0.99), 3),
            "max_s": round(lst[-1], 3)}

    # --- decisions + final state
    decisions = [e for e in flat if e.get("ev") == "rollout.decision"]
    assignment = read_assignment(
        os.path.join(tdir, "rollout-target.json")) or {}
    summary["rollout"] = {
        "decisions": [{k: d.get(k) for k in
                       ("action", "replica", "step", "reason")}
                      for d in decisions],
        "state": assignment.get("state"),
        "assignment": assignment.get("assignment"),
        "rolled_back": assignment.get("state") == "rolled_back",
        "promoted": assignment.get("state") == "promoted"}
    if controller is not None:
        summary["rollout"]["controller_state"] = controller.state

    # --- the ledger: transitions priced, identity intact
    led = tv_goodput.ledger_from_run(tdir)
    wall = led["wall_s"]
    summary["ledger"] = {
        "wall_s": round(wall, 3),
        "goodput_frac": (round(led["goodput_frac"], 4)
                         if led["goodput_frac"] is not None else None),
        "rollout_badput_s": round(led["badput_s"].get("rollout", 0.0),
                                  3),
        "identity_error_frac": (round(abs(led["identity_error_s"])
                                      / wall, 6) if wall > 0 else None),
    }
    return summary


def final_state_problems(rollout: dict) -> list:
    """What is wrong with a summary's final rollout state (empty: it is
    one the controller may end a run in, and the replicas' assignment
    agrees with it): promoted puts every replica on the target, a
    rollback (for an SLO burn, the only reason the controller takes
    one) every replica on the base, and a run cut while ramping took no
    rollback."""
    decisions = rollout["decisions"]
    steps = set((rollout["assignment"] or {}).values())
    back = [d for d in decisions if d["action"] == "rollback"]
    if rollout["promoted"]:
        want = {decisions[-1]["step"]}
        ok = not back and decisions[-1]["action"] == "promote"
    elif rollout["rolled_back"]:
        want = {back[-1]["step"]} if back else set()
        ok = len(back) == 1 and back[0]["reason"] == "slo_burn"
    else:
        want = steps
        ok = not back and rollout["state"] in ("baseline", "ramping")
    if ok and steps == want:
        return []
    return [f"rollout ended {rollout['state']} with assignment "
            f"{rollout['assignment']} after {decisions}"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--duration", type=float, default=24.0)
    ap.add_argument("--qps", type=float, default=5.0)
    ap.add_argument("--step-delay", type=float, default=0.02)
    # scenario switches (module docstring)
    ap.add_argument("--null-swap", action="store_true")
    ap.add_argument("--bad-canary", action="store_true")
    ap.add_argument("--bad-delay", type=float, default=0.4)
    ap.add_argument("--restart-mode", action="store_true")
    ap.add_argument("--kills", type=int, default=0)
    ap.add_argument("--kill-steps", type=int, nargs=2,
                    default=(20, 120),
                    help="heartbeat-step window seeded kills land in "
                         "(mid-swap territory at the default pacing)")
    # canary policy knobs (the README "Live rollout" table)
    ap.add_argument("--latency-slo-ms", type=float, default=500.0)
    ap.add_argument("--burn-threshold", type=float, default=2.0)
    ap.add_argument("--burn-window-long", type=float, default=6.0)
    ap.add_argument("--burn-window-short", type=float, default=2.0)
    ap.add_argument("--fire-consecutive", type=int, default=2)
    ap.add_argument("--clear-burn", type=float, default=1.0)
    ap.add_argument("--clear-hold", type=float, default=2.0)
    ap.add_argument("--cooldown", type=float, default=2.0)
    ap.add_argument("--min-evidence", type=int, default=3)
    ap.add_argument("--generation-timeout", type=float, default=600.0)
    torch_entry.add_device_flag(ap)
    return ap


def run(args) -> dict:
    torch_entry.check_device(args.device, PROG)
    summary = run_rollout(args)
    r = summary["requests"]
    v = summary["versions"]
    print(f"rollout table: state={summary['rollout']['state']} "
          f"dropped={r['dropped']} mixed={v['mixed_or_wrong']} "
          f"swaps={summary['swaps']['hot']}h/"
          f"{summary['swaps']['restart']}r "
          f"freshness_p99={summary.get('freshness', {}).get('p99_s', '-')}s "
          f"rollout_badput={summary['ledger']['rollout_badput_s']}s "
          f"identity_err={summary['ledger']['identity_error_frac']}")
    print(f"summary: {os.path.join(args.telemetry_dir or '', 'rollout-summary.json')}")
    torch_entry.write_report({"summary": summary})
    return summary


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

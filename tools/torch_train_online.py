#!/usr/bin/env python3
"""Online recommender on the port: fault-tolerant streaming training
with dynamic embeddings and a freshness SLO — the counterpart of
``examples/train_online.py``.

Topology (one recovery supervisor, ``--supervised``)::

    task 0            task 1..W          task W+1         task W+2
    trainer/coord     grad worker(s)     ingestor         evaluator

- The **ingestor** appends seeded Zipf click events to the append-only
  log (``input/stream.py``); a restarted ingestor truncates the torn
  tail and continues at the next offset.
- The **trainer** tails the log, trains the dynamic user/item tables
  and the dense tower, and commits model + membership + cursor
  atomically every ``--commit-every`` batches
  (``models/online_dlrm.py OnlineTrainer``); its gradients are computed
  on the grad worker(s) through remote dispatch — their loop is
  ``tools/torch_ps_run.py``'s remote lane (``remote_task``).
- The **evaluator** restores every new snapshot, scores a held-out
  batch and stamps it with its stream offset and update→servable
  freshness (``stream.snapshot_published``).

``--kill-seed`` SIGKILLs a seed-chosen trainer, ingestor or evaluator
mid-run; the supervisor reforms the cluster and the run finishes with
no lost and no double-applied event. Without ``--supervised`` the log
is produced up front and trained inline in this process.

    python3 tools/torch_train_online.py --events 480
    python3 tools/torch_train_online.py --supervised --kill-seed 0 \\
        --telemetry-dir /tmp/online
    python3 tools/torch_train_online.py --device cpu --supervised

One process a task: on the card each task takes its own
(``LOCAL_RANK``), so the default topology needs four.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_train_online"


def seeded_online_kill_plan(seed: int, grad_workers: int, *, kills=1):
    """Seed-derived SIGKILLs over the online roles (JAX's, exactly):
    trainer (task 0), ingestor (task W+1), evaluator (task W+2); the
    after_step budget is per role (trainer heartbeats per applied
    batch, ingestor per produced chunk, evaluator per poll)."""
    import random as _random

    from distributed_tensorflow_tpu_torch.resilience import KillSpec
    rng = _random.Random(f"dtx-online-kill:{seed}")
    roles = [(0, (2, 8)),                       # trainer: batches
             (grad_workers + 1, (1, 4)),        # ingestor: chunks
             (grad_workers + 2, (2, 10))]       # evaluator: polls
    victims = rng.sample(roles, k=min(kills, len(roles)))
    return [KillSpec(worker=task, after_step=rng.randrange(*rng_range))
            for task, rng_range in victims]


def _online_cfg(args):
    from distributed_tensorflow_tpu_torch.models.online_dlrm import (
        OnlineConfig)
    return OnlineConfig(
        batch_size=args.batch_size,
        initial_capacity=args.initial_capacity,
        max_capacity=args.max_capacity,
        admission_threshold=args.admission_threshold,
        ttl_steps=args.ttl_steps,
        n_users=args.users, n_items=args.items,
        seed=args.seed)


def online_cluster_task(args_dict):
    """One generation of one online-cluster task; the role comes from
    the process id, and every role is restartable."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        CoordinationError, coordination_service)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    args = argparse.Namespace(**args_dict)
    runtime = bootstrap.initialize(device=args.device)
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=runtime.process_id)
    agent = coordination_service()
    w = args.grad_workers
    pid = runtime.process_id
    try:
        if pid == 0:
            return _trainer_task(args, runtime, agent)
        if 1 <= pid <= w:
            torch_entry.worker("torch_ps_run", "remote_task")(
                {"device": args.device})
            bootstrap.shutdown()
            return ("grad_worker", pid)
        if pid == w + 1:
            return _ingestor_task(args, runtime, agent)
        return _evaluator_task(args, runtime, agent)
    except CoordinationError:
        # coordinator torn down at job end while this task was mid-RPC
        return (("task", pid), "released")


def _stream_path(args):
    from distributed_tensorflow_tpu_torch.input import stream as stream_lib
    return os.path.join(args.stream_dir, stream_lib.LOG_NAME)


def _ingestor_task(args, runtime, agent):
    """Append the seeded event stream in paced chunks; resumable."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.input import stream as stream_lib
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    cfg = _online_cfg(args)
    writer = stream_lib.StreamWriter.open(_stream_path(args))
    produced = writer.next_offset
    chunks = 0
    t0 = time.perf_counter()
    while produced < args.events:
        n = min(args.chunk, args.events - produced)
        chunk = stream_lib.seeded_events(
            args.seed, produced, n, n_users=cfg.n_users,
            n_items=cfg.n_items, n_dense=cfg.n_dense,
            zipf_a=cfg.zipf_a)
        produced = stream_lib.append_chunk(writer, chunk)
        chunks += 1
        elastic.heartbeat(chunks)
        tv_events.event(
            "stream.produced", offset=produced, chunk=chunks,
            events_per_sec=round(
                produced / max(time.perf_counter() - t0, 1e-9), 1))
        if produced < args.events and args.pace_s > 0:
            time.sleep(args.pace_s)
    writer.close()
    agent.key_value_set("dtx_online/done/ingestor", "1")
    bootstrap.shutdown()
    return ("ingestor", produced)


def _trainer_task(args, runtime, agent):
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.coordinator import remote_dispatch
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import ClusterCoordinator
    from distributed_tensorflow_tpu_torch.models import online_dlrm as od

    cfg = _online_cfg(args)
    coordinator = None
    if args.grad_workers > 0:
        coordinator = ClusterCoordinator(
            remote_worker_ids=list(range(1, args.grad_workers + 1)))
    trainer = od.OnlineTrainer(
        cfg, _stream_path(args), args.ckpt_dir,
        commit_every=args.commit_every, coordinator=coordinator,
        local_dir=args.ckpt_dir.rstrip("/") + ".local",
        agent=agent, device=runtime.device)
    start = trainer.restore()
    print(f"[gen {runtime.generation}] trainer resumed at offset "
          f"{start} (step {trainer.step})")
    summary = trainer.run(
        args.events, idle_timeout_s=args.idle_timeout,
        heartbeat_fn=elastic.heartbeat,
        on_batch=lambda t: (od.table_stats_event(t)
                            if t.step % args.commit_every == 0
                            else None))
    trainer.sync()
    od.table_stats_event(trainer)
    print(f"[gen {runtime.generation}] trainer done: {summary}")
    # wait for the sidecars to observe the final state before tearing
    # down the coordination service this process hosts
    deadline = time.monotonic() + args.idle_timeout
    pending = {"ingestor", "evaluator"}
    while pending and time.monotonic() < deadline:
        for role in list(pending):
            if agent.key_value_try_get(f"dtx_online/done/{role}") \
                    is not None:
                pending.discard(role)
        if pending:
            time.sleep(0.1)
    if args.grad_workers > 0:
        remote_dispatch.shutdown_workers(
            agent, worker_ids=list(range(1, args.grad_workers + 1)))
    bootstrap.shutdown()
    return ("trainer", summary["offset"], summary["loss_last"])


def _evaluator_task(args, runtime, agent):
    """Serve fresh snapshots: restore every new checkpoint, score it,
    stamp it with stream offset + update→servable freshness."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointCorruptError, latest_checkpoint)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.input import stream as stream_lib
    from distributed_tensorflow_tpu_torch.models import online_dlrm as od
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    cfg = _online_cfg(args)
    ckpt = Checkpoint(single_writer=True,
                      online=od.checkpoint_template(cfg))
    path = _stream_path(args)
    seen: set = set()
    published = 0
    polls = 0
    while True:
        # heartbeat per POLL: the evaluator's progress signal (and the
        # chaos plan's step clock) ticks while it waits for a commit
        polls += 1
        elastic.heartbeat(polls)
        latest = latest_checkpoint(args.ckpt_dir, "online")
        if latest is None or latest in seen:
            time.sleep(args.eval_poll_s)
            continue
        seen.add(latest)
        try:
            flat = ckpt.restore(latest)
        except (OSError, KeyError, ValueError, CheckpointCorruptError):
            continue           # rotation race / torn write: next poll
        state = od.unpack_restored(flat)
        offset = int(np.asarray(state["offset"]))
        step = int(np.asarray(state["step"]))
        commit_wall = float(np.asarray(state["commit_wall"]))
        loss = od.eval_snapshot(cfg, state, device=runtime.device)
        now = time.time()
        lag = stream_lib.count_records(path) - offset
        published += 1
        tv_events.event(
            "stream.snapshot_published", offset=offset, step=step,
            freshness_s=round(now - commit_wall, 6),
            lag_events=int(lag), eval_loss=round(loss, 5),
            snapshot=published)
        print(f"[gen {runtime.generation}] snapshot {published}: "
              f"offset {offset} freshness "
              f"{now - commit_wall:.3f}s lag {lag} loss {loss:.4f}")
        if offset >= args.events:
            break
    agent.key_value_set("dtx_online/done/evaluator", "1")
    bootstrap.shutdown()
    return ("evaluator", published)


def run_supervised(args) -> dict:
    import tempfile

    from distributed_tensorflow_tpu_torch.resilience import (
        RecoverySupervisor)

    base = args.stream_dir or tempfile.mkdtemp(prefix="online_")
    args.stream_dir = base
    args.ckpt_dir = args.ckpt_dir or os.path.join(base, "ckpt")
    kill_plan = ()
    if args.kill_seed is not None:
        kill_plan = seeded_online_kill_plan(
            args.kill_seed, args.grad_workers, kills=args.kills)
        print(f"online kill plan (seed {args.kill_seed}): {kill_plan}")
    n_tasks = 1 + args.grad_workers + 2
    sup = RecoverySupervisor(
        torch_entry.worker(PROG, "online_cluster_task"),
        num_workers=n_tasks, args=(vars(args),), device=args.device,
        max_restarts=args.restart_budget, kill_plan=kill_plan,
        generation_timeout_s=args.generation_timeout,
        telemetry_dir=args.telemetry_dir)
    result = sup.run()
    for value in sorted(result.return_values, key=str):
        print(f"task result: {value}")
    print(f"done: {args.events} events through {n_tasks} tasks, "
          f"{sup.restarts_used} restart(s), "
          f"final generation {sup.generation}")
    if args.telemetry_dir:
        print(f"timeline: python3 tools/torch_obs_report.py "
              f"{args.telemetry_dir}")
    out = {"results": [list(v) if isinstance(v, tuple) else v
                       for v in result.return_values],
           "restarts": sup.restarts_used, "generation": sup.generation}
    torch_entry.write_report(out)
    return out


def run_local(args) -> dict:
    """Single-process path: pre-produce the log, train inline (no
    supervisor, no remote dispatch)."""
    import tempfile

    from distributed_tensorflow_tpu_torch.input import stream as stream_lib
    from distributed_tensorflow_tpu_torch.models import online_dlrm as od
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    if args.telemetry_dir:
        tv_events.configure(args.telemetry_dir, process_id=0)
    base = args.stream_dir or tempfile.mkdtemp(prefix="online_")
    args.stream_dir = base
    args.ckpt_dir = args.ckpt_dir or os.path.join(base, "ckpt")
    cfg = _online_cfg(args)
    path = _stream_path(args)
    writer = stream_lib.StreamWriter.open(path)
    while writer.next_offset < args.events:
        n = min(args.chunk, args.events - writer.next_offset)
        stream_lib.append_chunk(writer, stream_lib.seeded_events(
            args.seed, writer.next_offset, n, n_users=cfg.n_users,
            n_items=cfg.n_items, n_dense=cfg.n_dense,
            zipf_a=cfg.zipf_a))
    writer.close()
    trainer = od.OnlineTrainer(cfg, path, args.ckpt_dir,
                               commit_every=args.commit_every,
                               device=args.device)
    trainer.restore()
    summary = trainer.run(args.events, idle_timeout_s=args.idle_timeout)
    print(f"online: {summary}")
    torch_entry.write_report({"summary": summary})
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=480,
                    help="total stream events (the run's end condition)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=48,
                    help="ingestor append-chunk size")
    ap.add_argument("--pace-s", type=float, default=0.25,
                    help="ingestor pause between chunks (stream pacing)")
    ap.add_argument("--commit-every", type=int, default=3,
                    help="trainer: commit cursor+state every N batches")
    ap.add_argument("--grad-workers", type=int, default=1,
                    help="async-PS grad worker tasks (0 = compute "
                         "gradients in the trainer process)")
    ap.add_argument("--initial-capacity", type=int, default=256)
    ap.add_argument("--max-capacity", type=int, default=1024)
    ap.add_argument("--admission-threshold", type=int, default=2)
    ap.add_argument("--ttl-steps", type=int, default=2048)
    ap.add_argument("--users", type=int, default=50_000)
    ap.add_argument("--items", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--supervised", action="store_true",
                    help="run the full 4-role topology under the "
                         "recovery supervisor")
    ap.add_argument("--kill-seed", type=int, default=None,
                    help="supervised chaos: SIGKILL a seed-chosen "
                         "trainer/ingestor/evaluator mid-run")
    ap.add_argument("--kills", type=int, default=1)
    ap.add_argument("--restart-budget", type=int, default=3)
    ap.add_argument("--generation-timeout", type=float, default=300.0)
    ap.add_argument("--idle-timeout", type=float, default=60.0,
                    help="trainer: stream idle budget before giving up")
    ap.add_argument("--eval-poll-s", type=float, default=0.3)
    ap.add_argument("--stream-dir", default=None,
                    help="directory holding stream.log (default: tmp)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--telemetry-dir", default=None)
    torch_entry.add_device_flag(ap)
    return ap


def run(args) -> dict:
    torch_entry.check_device(args.device, PROG)
    return run_supervised(args) if args.supervised else run_local(args)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Config #1 on the port: the MNIST CNN under MirroredStrategy
semantics — the counterpart of ``examples/train_mnist.py``.

The default is the native path: a distributed dataset, replicated
state and one step through ``strategy.compile_step``
(``parallel/mirrored.py``; one card, or ``devices=["cpu"]``).
``--telemetry-dir`` writes the ``train.step`` events and a live
``metrics-live.prom`` there.

``--elastic`` runs the job as an N-worker cluster under the recovery
supervisor: the workers train data-parallel (gradients meaned over the
process group, one process a card) with periodic checkpoints and host
snapshots between them; kill one (``--kill-seed``) and the supervisor
reforms the cluster under a fresh generation, which resumes from the
best surviving tier.

``--data-service`` runs the disaggregated-input topology: task 0 trains
and dispatches FILE splits, tasks 1..M are input workers executing the
registered pipeline under heartbeat-backed leases over the coordination
KV; ``--kill-seed`` SIGKILLs input workers mid-epoch. Its process group
is gloo whatever the device (the input workers run no device work); the
trainer's model sits on its card.

    python3 tools/torch_train_mnist.py --steps 100
    python3 tools/torch_train_mnist.py --elastic --workers 2 --kill-seed 0 \\
        --telemetry-dir /tmp/mnist
    python3 tools/torch_train_mnist.py --data-service --kill-seed 0
    python3 tools/torch_train_mnist.py --device cpu --elastic --workers 2

Render a run with ``python3 tools/torch_obs_report.py <telemetry-dir>``.
The seeded plans (``seeded_input_kill_plan`` here, ``seeded_kill_plan``
and ``seeded_shrink_plan`` of ``resilience/supervisor.py``) are JAX's,
exactly. The supervised workers are imported from this script by its
module name.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_train_mnist"

#: deterministic synthetic sample pool shared by every worker/generation
_POOL = 512


# ---------------------------------------------------------------------------
# Disaggregated data service: task 0 = trainer + dispatcher, tasks 1..M =
# input workers, all under one recovery supervisor
# ---------------------------------------------------------------------------

def _npz_reader(path):
    """Per-file reader of the split files ``write_mnist_split_files``
    lays down — module-level so the split pipeline factory pickles by
    reference into input-worker processes."""
    import numpy as np
    with np.load(path) as z:
        images, labels = z["image"], z["label"]
    for i in range(len(labels)):
        yield {"image": images[i], "label": labels[i]}


def mnist_split_pipeline(files):
    """The registered per-split pipeline (``SplitProvider.from_factory``):
    unbatched examples; the trainer batches."""
    from distributed_tensorflow_tpu_torch.input.dataset import Dataset
    return Dataset.from_files(list(files), _npz_reader)


def write_mnist_split_files(data_dir, num_files, pool=_POOL):
    """Shard the deterministic synthetic pool into FILE splits (JAX's
    files, byte for byte)."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models.mnist_cnn import (
        synthetic_data)
    data = synthetic_data(pool)
    per = pool // num_files
    os.makedirs(data_dir, exist_ok=True)
    files = []
    for i in range(num_files):
        path = os.path.join(data_dir, f"mnist-{i:03d}.npz")
        sl = slice(i * per, (i + 1) * per)
        np.savez(path, image=data["image"][sl], label=data["label"][sl])
        files.append(path)
    return files


def seeded_input_kill_plan(seed, input_workers, *, kills=1,
                           step_range=(1, 3)):
    """Seed-derived SIGKILLs of INPUT-WORKER tasks (cluster task ids
    1..M; task 0 is the trainer), JAX's exactly: fire once the victim's
    heartbeat reports >= after_step splits processed."""
    import random as _random

    from distributed_tensorflow_tpu_torch.resilience import KillSpec
    rng = _random.Random(f"dtx-data-kill:{seed}")
    victims = rng.sample(range(input_workers),
                         k=min(kills, input_workers))
    return [KillSpec(worker=1 + v, after_step=rng.randrange(*step_range))
            for v in victims]


def _train_device(device: str):
    """The trainer's device: its card (``LOCAL_RANK``) or the CPU."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _train_state(lr, device, params=None):
    """``(model, optimizer)`` from seed 0, or holding ``params`` (a flax
    param tree of arrays, e.g. JAX's ``PRNGKey(0)`` init) when given."""
    from distributed_tensorflow_tpu_torch.models.layers import load_flax
    from distributed_tensorflow_tpu_torch.models.mnist_cnn import (
        create_train_state)
    _state, model, opt = create_train_state(0, learning_rate=lr,
                                            device=device)
    if params is not None:
        load_flax(model, params)
    return model, opt


def data_service_worker(data_dir, ckpt_dir, epochs, global_batch, lr,
                        input_workers, device="cuda", params=None):
    """One generation of one data-service cluster task (JAX's). Task 0
    is the trainer (plus the split dispatcher); tasks 1..M are input
    workers executing the registered pipeline over leased FILE
    splits. All KV traffic is generation-namespaced. ``params``: the
    trainer's initial weights (a flax param tree; default seed 0)."""
    import glob as _glob

    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        CoordinationError, coordination_service)
    from distributed_tensorflow_tpu_torch.input import data_service as dsvc
    from distributed_tensorflow_tpu_torch.input.split_provider import (
        SplitProvider)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events

    runtime = bootstrap.initialize(device="cpu")
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=runtime.process_id)
    agent = coordination_service()
    files = sorted(_glob.glob(os.path.join(data_dir, "*.npz")))
    provider = SplitProvider.from_factory(files, mnist_split_pipeline,
                                          seed=0)
    cfg = dsvc.DataServiceConfig(job="mnist", lease_timeout_s=1.0,
                                 fetch_timeout_s=60.0)
    if runtime.process_id == 0:
        return _data_service_trainer(
            runtime, agent, provider, cfg, ckpt_dir, epochs,
            global_batch, lr, input_workers, device, params)
    wid = runtime.process_id - 1
    worker = dsvc.DataInputWorker(
        agent, provider, cfg, worker_id=wid,
        num_workers=input_workers, epochs=epochs,
        heartbeat_fn=elastic.heartbeat)
    try:
        worker.run()
    except CoordinationError:
        pass          # coordinator torn down at job end: released
    bootstrap.shutdown()
    return ("input_worker", wid, worker.splits_processed)


def _state_tree(model, opt) -> dict:
    """The model's parameters and the Adam moments and count, by
    parameter name: what the elastic and data-service checkpoints
    hold."""
    import torch
    named = dict(model.named_parameters())
    group = opt.param_groups[0]
    sts = {n: opt.moments(p, group) for n, p in named.items()}
    count = next(iter(sts.values()))["count"]
    return {"params": {n: p.detach() for n, p in named.items()},
            "mu": {n: st["mu"] for n, st in sts.items()},
            "nu": {n: st["nu"] for n, st in sts.items()},
            "count": torch.tensor(int(count), dtype=torch.int64)}


def _load_state(model, opt, flat: dict):
    """Copy a restored flat checkpoint (``_state_tree``'s paths: arrays
    from a disk tier, tensors on the device from a memory tier) into the
    model and the optimizer."""
    import numpy as np
    import torch

    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))

    named = dict(model.named_parameters())
    group = opt.param_groups[0]
    count = int(tensor(flat["count"]).item())
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(tensor(flat[f"params/{n}"]))
            st = opt.moments(p, group)
            for k in ("mu", "nu"):
                st[k] = tensor(flat[f"{k}/{n}"]).to(p.device,
                                                    st[k].dtype).clone()
            st["count"] = count


def _grad_step(model, opt, images, labels):
    """Forward and backward on one batch; returns the loss (a host
    float: the step has finished)."""
    import torch

    from distributed_tensorflow_tpu_torch.models.transformer import (
        softmax_cross_entropy)
    dev = next(model.parameters()).device
    opt.zero_grad(set_to_none=True)
    logits = model(torch.as_tensor(images).to(dev))
    loss = softmax_cross_entropy(
        logits, torch.as_tensor(labels).to(dev).long()).mean()
    loss.backward()
    return float(loss.detach())


def _data_service_trainer(runtime, agent, provider, cfg, ckpt_dir,
                          epochs, global_batch, lr, input_workers, device,
                          params):
    import time as _time

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.input import data_service as dsvc
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    ledger = goodput.GoodputLedger()
    goodput.activate(ledger)
    dispatcher = dsvc.DataServiceDispatcher(
        agent, provider, cfg, num_workers=input_workers, epochs=epochs)
    dispatcher.start()
    client = dsvc.DataServiceClient(
        agent, cfg, heartbeat_fn=lambda _s: elastic.heartbeat())

    dev = _train_device(device)
    model, opt = _train_state(lr, dev, params)
    # single_writer: the trainer alone owns the model state — the input
    # workers are cluster members but never checkpoint
    ckpt = Checkpoint(single_writer=True, **_state_tree(model, opt))
    mgr = CheckpointManager(ckpt, ckpt_dir, checkpoint_name="dsvc")
    start_epoch = 0
    res = mgr.restore_latest()
    if res is not None:
        tier, start_epoch, restored = res
        _load_state(model, opt, restored)
        print(f"[gen {runtime.generation}] trainer resumed at epoch "
              f"{start_epoch} from the {tier} tier")

    loss = float("nan")
    step = 0
    last_wait = client.total_wait_s
    for epoch in range(start_epoch, epochs):
        batch_buf = []
        for el in client.epoch(epoch):
            batch_buf.append(el)
            if len(batch_buf) < global_batch:
                continue
            t0 = _time.perf_counter()
            images = np.stack([b["image"] for b in batch_buf])
            labels = np.stack([b["label"] for b in batch_buf])
            batch_buf = []
            loss = _grad_step(model, opt, images, labels)
            opt.step()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dur_s = _time.perf_counter() - t0
            # fetch-wait accrued since the previous step prices into
            # the infeed_wait badput bucket
            wait_s = client.total_wait_s - last_wait
            last_wait = client.total_wait_s
            elastic.heartbeat(step)
            tv_events.event("train.step", step=step, loss=loss,
                            dur_s=round(dur_s + wait_s, 6),
                            infeed_wait_s=round(wait_s, 6))
            ledger.step_completed(dur_s + wait_s, infeed_s=wait_s)
            step += 1
        ckpt._objects.update(_state_tree(model, opt))
        ledger.enter("ckpt_block")
        mgr.save(checkpoint_number=epoch + 1)
        ledger.enter("idle")
        print(f"[gen {runtime.generation}] epoch {epoch} done: "
              f"loss={loss:.4f} fetch_wait={client.total_wait_s:.2f}s "
              f"reassigned={dispatcher.splits_reassigned}")
    dsvc.signal_shutdown(agent, cfg)
    dsvc.await_shutdown_acks(agent, cfg, input_workers)
    dispatcher.stop()
    ckpt.sync()
    bootstrap.shutdown()
    return (0, start_epoch, loss)


def elastic_worker(ckpt_dir, total_steps, save_every, global_batch, lr,
                   local_dir=None, snapshot_every=None, snapshot_keep=2,
                   step_delay_s=0.0, device="cuda", params=None):
    """One generation of one elastic worker (JAX's): bootstrap from
    ``TF_CONFIG``, restore down the recovery ladder (own host snapshot >
    peer replica > local disk > durable disk), train data-parallel
    (each process's gradients all-reduced and meaned over the group),
    checkpoint every ``save_every`` steps with host snapshots every
    ``snapshot_every`` in between, heartbeat every step. The per-worker
    batch is ``global_batch // nproc`` of the CURRENT process count, so
    the same function runs at any topology the supervisor reforms to.
    ``params``: the initial weights (a flax param tree; default seed
    0)."""
    import time as _time

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.checkpoint.peer_snapshot import (
        SnapshotStore)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    from distributed_tensorflow_tpu_torch.models.mnist_cnn import (
        synthetic_data)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    runtime = bootstrap.initialize(device=device)
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=runtime.process_id)
    # live goodput ledger: enter("ckpt_block") names the bucket a stall
    # during a blocking save accrues to
    ledger = goodput.GoodputLedger()
    goodput.activate(ledger)

    model, opt = _train_state(lr, runtime.device, params)
    data = synthetic_data(_POOL)
    ckpt = Checkpoint(**_state_tree(model, opt))
    # snapshot_every == 0 disables the host/peer memory tiers entirely
    memdir = elastic.peer_memdir()
    store = (SnapshotStore(memdir, keep=snapshot_keep)
             if memdir and snapshot_every != 0 else None)
    mgr = CheckpointManager(ckpt, ckpt_dir, checkpoint_name="elastic",
                            local_dir=local_dir, snapshot_store=store)
    start_step = 0
    res = mgr.restore_latest()
    if res is not None:
        tier, start_step, restored = res
        _load_state(model, opt, restored)
        print(f"[gen {runtime.generation} p{runtime.process_id}] resumed "
              f"at step {start_step} from the {tier} tier")

    nproc, pid = runtime.num_processes, runtime.process_id
    per_batch = max(1, global_batch // nproc)
    params = list(model.parameters())
    cuda = runtime.device.type == "cuda"
    loss = float("nan")

    def refresh_tracked():
        ckpt._objects.update(_state_tree(model, opt))

    for step in range(start_step, total_steps):
        elastic.heartbeat(step)
        if step_delay_s:
            # pacing for shared-fleet runs: a trainer sharing the host
            # with serving replicas models a device-bound step
            _time.sleep(step_delay_s)
        # per-step phase attribution: compute = the local forward,
        # backward and update, collective = the gradient all-reduce
        # (host-driven here: entirely exposed), ckpt_block = the step
        # loop blocked on checkpoint capture/commit/snapshot
        t0 = _time.perf_counter()
        start = (step * global_batch + pid * per_batch) % _POOL
        idx = (np.arange(per_batch) + start) % _POOL
        loss = _grad_step(model, opt, data["image"][idx],
                          data["label"][idx])
        t1 = _time.perf_counter()
        if nproc > 1:
            for p in params:
                dist.all_reduce(p.grad)
                p.grad.div_(nproc)
            if cuda:
                torch.cuda.synchronize()
        t2 = _time.perf_counter()
        opt.step()
        if cuda:
            torch.cuda.synchronize()
        t3 = _time.perf_counter()
        ckpt_s = 0.0
        if (step + 1) % save_every == 0:
            refresh_tracked()
            ledger.enter("ckpt_block")
            mgr.save(checkpoint_number=step + 1)
            ledger.enter("idle")
            ckpt_s = _time.perf_counter() - t3
        elif (store is not None and snapshot_every
              and (step + 1) % snapshot_every == 0):
            refresh_tracked()
            ledger.enter("ckpt_block")
            mgr.snapshot(step + 1)   # memory-only: the cheap hot tier
            ledger.enter("idle")
            ckpt_s = _time.perf_counter() - t3
        dur_s = _time.perf_counter() - t0
        tv_events.event(
            "train.step", step=step, loss=loss,
            dur_s=round(dur_s, 6),
            compute_s=round((t1 - t0) + (t3 - t2), 6),
            collective_s=round(t2 - t1, 6),
            ckpt_block_s=round(ckpt_s, 6))
        ledger.step_completed(dur_s, ckpt_s=ckpt_s)
        if step % 10 == 0 and pid == 0:
            print(f"[gen {runtime.generation}] step {step}: "
                  f"loss={float(loss):.4f}")
    ckpt.sync()
    bootstrap.shutdown()
    return runtime.process_id, start_step, float(loss)


def elastic_kill_plan(args) -> list:
    """The ``--elastic`` chaos plan (JAX's step range)."""
    from distributed_tensorflow_tpu_torch.resilience import (
        seeded_kill_plan, seeded_shrink_plan)
    if args.kill_seed is None:
        return []
    step_range = (2, max(3, args.steps - 4))
    if args.permanent_kill:
        return seeded_shrink_plan(args.kill_seed, args.workers,
                                  step_range=step_range)
    return seeded_kill_plan(args.kill_seed, args.workers, kills=args.kills,
                            step_range=step_range)


def run_elastic(args, params=None) -> dict:
    import tempfile

    from distributed_tensorflow_tpu_torch.resilience import (
        RecoverySupervisor)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="mnist_elastic_")
    local_dir = args.local_ckpt_dir
    if local_dir is None and not args.no_local_tier:
        local_dir = ckpt_dir.rstrip("/") + ".local"
    snapshot_every = args.snapshot_every
    if snapshot_every is None:
        snapshot_every = max(1, args.save_every // 2)
    kill_plan = elastic_kill_plan(args)
    if args.kill_seed is not None:
        print(f"chaos kill plan (seed {args.kill_seed}): {kill_plan}")
    sup = RecoverySupervisor(
        torch_entry.worker(PROG, "elastic_worker"),
        num_workers=args.workers,
        args=(ckpt_dir, args.steps, args.save_every, args.global_batch,
              args.lr),
        kwargs={"local_dir": local_dir,
                "snapshot_every": 0 if args.no_snapshots
                else snapshot_every,
                "device": args.device, "params": params},
        device=args.device,
        max_restarts=args.restart_budget, kill_plan=kill_plan,
        shrink_after=args.shrink_after, min_workers=args.min_workers,
        generation_timeout_s=args.generation_timeout,
        telemetry_dir=args.telemetry_dir)
    result = sup.run()
    for pid, start_step, loss in sorted(result.return_values):
        print(f"worker {pid}: resumed@{start_step} final loss={loss:.4f}")
    print(f"done: {sup.restarts_used} restart(s), "
          f"{sup.failures_total} recorded failure(s), "
          f"final generation {sup.generation}, "
          f"final cluster size {sup.num_workers}")
    if args.telemetry_dir:
        print(f"recovery timeline: python3 tools/torch_obs_report.py "
              f"{args.telemetry_dir}")
    out = {"final": sorted(result.return_values),
           "restarts": sup.restarts_used, "generation": sup.generation,
           "workers": sup.num_workers,
           "kill_plan": [k.__dict__ for k in kill_plan]}
    torch_entry.write_report(out)
    return out


def run_data_service(args, params=None) -> dict:
    import tempfile

    from distributed_tensorflow_tpu_torch.resilience import (
        RecoverySupervisor)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="mnist_dsvc_")
    data_dir = os.path.join(ckpt_dir, "splits")
    files = write_mnist_split_files(data_dir, args.split_files)
    kill_plan = ()
    if args.kill_seed is not None:
        kill_plan = seeded_input_kill_plan(
            args.kill_seed, args.input_workers, kills=args.kills)
        print(f"input-worker kill plan (seed {args.kill_seed}): "
              f"{kill_plan}")
    sup = RecoverySupervisor(
        torch_entry.worker(PROG, "data_service_worker"),
        num_workers=1 + args.input_workers,
        args=(data_dir, ckpt_dir, args.epochs, args.global_batch,
              args.lr, args.input_workers, args.device, params),
        device="cpu",
        max_restarts=args.restart_budget, kill_plan=kill_plan,
        generation_timeout_s=args.generation_timeout,
        telemetry_dir=args.telemetry_dir)
    result = sup.run()
    for value in sorted(result.return_values, key=str):
        print(f"task result: {value}")
    print(f"done: {len(files)} splits x {args.epochs} epochs over "
          f"{args.input_workers} input worker(s), "
          f"{sup.restarts_used} restart(s), "
          f"final generation {sup.generation}")
    if args.telemetry_dir:
        print(f"recovery timeline: python3 tools/torch_obs_report.py "
              f"{args.telemetry_dir}")
    out = {"results": [list(v) for v in result.return_values],
           "restarts": sup.restarts_used, "generation": sup.generation}
    torch_entry.write_report(out)
    return out


def run_native(args, params=None) -> dict:
    """The native path (``chip_smoke.py strategy_native``'s): returns
    ``{"losses", ...}``."""
    import time

    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.input.dataset import Dataset
    from distributed_tensorflow_tpu_torch.models.layers import load_flax
    from distributed_tensorflow_tpu_torch.models.mnist_cnn import (
        create_train_state, make_train_step, synthetic_data)
    from distributed_tensorflow_tpu_torch.parallel.mirrored import (
        MirroredStrategy)
    from distributed_tensorflow_tpu_torch.training.loops import (
        StepTelemetry)

    exporter = None
    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir)
        # live scrape: metrics-live.prom in the run dir (plus /metrics
        # when DTX_METRICS_PORT is set)
        exporter = telemetry.MetricsExporter(dir=args.telemetry_dir)

    strategy = (MirroredStrategy(devices=["cpu"]) if args.device == "cpu"
                else MirroredStrategy())
    print(f"devices: {strategy.num_replicas_in_sync} replicas on "
          f"{args.device}")

    data = synthetic_data(4096)
    ds = Dataset.from_tensor_slices(data).shuffle(4096).batch(
        args.global_batch).repeat()
    dist_ds = strategy.experimental_distribute_dataset(ds)

    state, model, tx = create_train_state(0, learning_rate=args.lr,
                                          device=strategy.device)
    if params is not None:
        load_flax(model, params)
    state = strategy.replicate(state)
    step_fn = strategy.compile_step(make_train_step(model, tx))

    steps_telemetry = StepTelemetry()
    it = iter(dist_ds)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = step_fn(state, next(it))
        losses.append(metrics["loss"])
        log_step = step % 20 == 0 or step == args.steps - 1
        steps_telemetry.step_completed(
            step, loss=metrics["loss"] if log_step else None)
        if log_step:
            print(f"step {step}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    print("done")
    if exporter is not None:
        exporter.stop()
    telemetry.shutdown()
    out = {"losses": losses, "steps_per_s": args.steps / wall,
           "replicas": strategy.num_replicas_in_sync}
    torch_entry.write_report(out)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--telemetry-dir", default=None,
                    help="enable telemetry: per-step train.step events "
                         "(JSONL) land here; render with "
                         "tools/torch_obs_report.py")
    ap.add_argument("--elastic", action="store_true",
                    help="run as a multi-worker job under the recovery "
                         "supervisor (worker death -> reform -> resume)")
    ap.add_argument("--workers", type=int, default=2,
                    help="elastic: number of worker processes")
    ap.add_argument("--save-every", type=int, default=10,
                    help="elastic: checkpoint every N steps")
    ap.add_argument("--restart-budget", type=int, default=3,
                    help="elastic: max cluster reforms before "
                         "RecoveryFailedError")
    ap.add_argument("--ckpt-dir", default=None,
                    help="elastic: checkpoint directory (default: tmp)")
    ap.add_argument("--kill-seed", type=int, default=None,
                    help="elastic chaos: SIGKILL workers on a schedule "
                         "derived from this seed")
    ap.add_argument("--kills", type=int, default=1,
                    help="elastic chaos: number of scheduled kills")
    ap.add_argument("--permanent-kill", action="store_true",
                    help="elastic chaos: the seed-chosen worker's "
                         "machine dies for good (kill re-fires every "
                         "generation; pair with --shrink-after)")
    ap.add_argument("--shrink-after", type=int, default=None,
                    help="elastic: after N failed restarts of the same "
                         "task, reform at one fewer worker "
                         "(topology-elastic resharded restore)")
    ap.add_argument("--min-workers", type=int, default=1,
                    help="elastic: never shrink below this many workers")
    ap.add_argument("--local-ckpt-dir", default=None,
                    help="elastic: node-local fast checkpoint tier "
                         "(default: <ckpt-dir>.local)")
    ap.add_argument("--no-local-tier", action="store_true",
                    help="elastic: disable the local disk tier")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="elastic: host-snapshot cadence between disk "
                         "saves (default: save-every // 2)")
    ap.add_argument("--no-snapshots", action="store_true",
                    help="elastic: disable host/peer snapshot tiers")
    ap.add_argument("--generation-timeout", type=float, default=600.0,
                    help="elastic: per-generation wall budget (s)")
    ap.add_argument("--data-service", action="store_true",
                    help="run with a disaggregated input service under "
                         "the recovery supervisor: task 0 trains (and "
                         "dispatches FILE splits), tasks 1..M execute "
                         "the input pipeline under heartbeat-backed "
                         "leases (--kill-seed SIGKILLs input workers)")
    ap.add_argument("--input-workers", type=int, default=2,
                    help="data-service: input-worker tasks")
    ap.add_argument("--epochs", type=int, default=2,
                    help="data-service: epochs (each = one exactly-once "
                         "pass over every FILE split)")
    ap.add_argument("--split-files", type=int, default=8,
                    help="data-service: FILE splits the sample pool is "
                         "sharded into")
    torch_entry.add_device_flag(ap)
    return ap


def run(args, params=None) -> dict:
    """The script's run; ``params`` (a flax param tree, e.g. JAX's
    ``PRNGKey(0)`` init) replaces the seed-0 weights in every mode."""
    torch_entry.check_device(args.device, PROG)
    if args.data_service:
        return run_data_service(args, params)
    if args.elastic:
        return run_elastic(args, params)
    return run_native(args, params)


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

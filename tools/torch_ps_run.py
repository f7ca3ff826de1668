#!/usr/bin/env python3
"""The port's parameter-server and coordinator paths, end to end — the
counterpart of ``examples/train_dlrm_ps.py`` and of
``examples/train_online.py --grad-workers``.

    # async-PS DLRM over thread lanes (W&D tiny, lr 0.05)
    python3 tools/torch_ps_run.py --device cpu --workers 3 --steps 60
    # the same over remote lanes: a TF_CONFIG cluster of 1 + N processes
    python3 tools/torch_ps_run.py --device cpu --workers 2 --remote
    # the online DLRM trainer, its gradients through the coordinator
    python3 tools/torch_ps_run.py --device cpu --online --events 800

On the card drop ``--device cpu`` (thread lanes take card ``i % count``,
remote workers a card each). Prints one JSON line: losses (mean of the
first and last ten), steps, seconds, closures re-dispatched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _summary(losses: list, seconds: float, coord) -> dict:
    k = min(10, len(losses))
    return {"steps": len(losses), "loss_first": sum(losses[:k]) / k,
            "loss_last": sum(losses[-k:]) / k, "seconds": seconds,
            "redispatched": sum(w.failures for w in coord.cluster.workers)}


def run_threads(args) -> dict:
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import ClusterCoordinator
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    cfg = wd.WideDeepConfig.tiny(learning_rate=0.05)
    coord = ClusterCoordinator(num_workers=args.workers, device=args.device)
    t0 = time.perf_counter()
    try:
        _, losses = wd.train_dlrm_async_ps(
            cfg, coord, steps=args.steps, batch_size=args.batch_size,
            max_in_flight=args.in_flight)
    finally:
        coord.shutdown()
    return _summary(losses, time.perf_counter() - t0, coord)


def remote_task(args_dict: dict):
    """One task of ``--remote``: rank 0 coordinates, the others serve."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.coordinator import remote_dispatch
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import ClusterCoordinator
    from distributed_tensorflow_tpu_torch.models import wide_deep as wd
    rt = bootstrap.initialize(device=args_dict["device"])
    if rt.process_id != 0:
        remote_dispatch.run_worker_loop()
        return None
    cfg = wd.WideDeepConfig.tiny(learning_rate=0.05)
    coord = ClusterCoordinator(
        remote_worker_ids=list(range(1, rt.num_processes)))
    t0 = time.perf_counter()
    _, losses = wd.train_dlrm_async_ps(
        cfg, coord, steps=args_dict["steps"],
        batch_size=args_dict["batch_size"],
        max_in_flight=args_dict["in_flight"])
    out = _summary(losses, time.perf_counter() - t0, coord)
    coord.shutdown()
    return out


def run_remote(args) -> dict:
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    spec = multi_process_runner.create_cluster_spec(
        num_workers=args.workers + 1)
    runner = multi_process_runner.MultiProcessRunner(
        remote_task, spec, args=(vars(args),), device=args.device,
        timeout=1800)
    result = runner.start().join()
    return result.tasks[("worker", 0)].value


def run_online(args) -> dict:
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import ClusterCoordinator
    from distributed_tensorflow_tpu_torch.input import stream
    from distributed_tensorflow_tpu_torch.models import online_dlrm as od
    cfg = od.OnlineConfig.tiny()
    root = tempfile.mkdtemp(prefix="torch_ps_run_")
    log = os.path.join(root, "events.log")
    with stream.StreamWriter.open(log) as w:
        stream.append_chunk(w, stream.seeded_events(
            cfg.seed, 0, args.events, n_users=cfg.n_users,
            n_items=cfg.n_items))
    coord = ClusterCoordinator(num_workers=args.workers, device=args.device)
    try:
        t = od.OnlineTrainer(cfg, log, os.path.join(root, "ck"),
                             coordinator=coord, max_in_flight=args.in_flight,
                             device=args.device)
        out = t.run(args.events, idle_timeout_s=10.0)
    finally:
        coord.shutdown()
    return {k: out[k] for k in ("offset", "steps", "commits", "loss_last",
                                "events_per_sec")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--in-flight", type=int, default=4)
    ap.add_argument("--remote", action="store_true",
                    help="remote lanes: a TF_CONFIG cluster of processes")
    ap.add_argument("--online", action="store_true",
                    help="OnlineTrainer(coordinator=) instead of the DLRM")
    ap.add_argument("--events", type=int, default=800)
    args = ap.parse_args(argv)
    run = (run_online if args.online else run_remote if args.remote
           else run_threads)
    print(json.dumps({"mode": run.__name__, "device": args.device,
                      "workers": args.workers, **run(args)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

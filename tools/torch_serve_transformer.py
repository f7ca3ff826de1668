#!/usr/bin/env python3
"""Serve the flagship transformer on the port: continuous batching +
KV-cache decode — the counterpart of ``examples/serve_transformer.py``.

Default mode runs ONE in-process ``InferenceEngine`` against a seeded
request load and prints the latency/throughput summary. ``--elastic``
instead runs N serving replicas (``serving/replica.py
serving_replica``) under the recovery supervisor: each replica owns a
shard of the workload, heartbeats per engine step and appends completed
requests to ``served-<task>.jsonl``; kill one (``--kill-seed``) and the
supervisor reforms the cluster, the restarted replica re-queues its
unfinished requests from the completion log and serves them to the
same tokens. ``--elastic --disagg`` splits the fleet into one prefill
replica (task 0) and N-1 decode replicas. ``--ckpt-dir`` restores the
weights down the checkpoint recovery ladder; ``--write-ckpt`` first
writes a seed-deterministic checkpoint there. Render a run with
``python3 tools/torch_obs_report.py <telemetry-dir>``.

    python3 tools/torch_serve_transformer.py --requests 8
    python3 tools/torch_serve_transformer.py --write-ckpt --ckpt-dir /tmp/ck
    python3 tools/torch_serve_transformer.py --elastic --workers 2 \\
        --kill-seed 0 --telemetry-dir /tmp/serve
    python3 tools/torch_serve_transformer.py --device cpu --requests 8

The model: on the card ``TransformerConfig.transformer_big()`` in bf16
(every prefill runs the flash-attention forward, one launch a layer);
on the CPU JAX's ``tiny(max_seq_len=64)``. Without a checkpoint the
weights are ``serving/replica.py seeded_params`` (a ``torch.Generator``
seeded 0; JAX initialises with ``jax.random``, so the numbers differ:
:func:`run_local` and :func:`write_checkpoint` take ``params=`` to serve
JAX's converted weights). Each replica takes its card from
``LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_entry  # noqa: E402

PROG = "torch_serve_transformer"
#: the JAX script's engine (its pool, slots and prompt cap)
ENGINE_KWARGS = dict(num_blocks=64, block_size=8, max_slots=4,
                     max_prompt_len=16)


def model_config(device: str):
    """``tiny(max_seq_len=64)`` on the CPU, ``transformer_big()`` on the
    card."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    if device == "cpu":
        return TransformerConfig.tiny(max_seq_len=64)
    return TransformerConfig.transformer_big()


def run_local(args, params=None) -> dict:
    """One in-process engine over ``seeded_requests``. Returns
    ``{"streams": {id: tokens}, "stats", "tokens_per_s", ...}``."""
    import time

    import torch

    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.serving import InferenceEngine
    from distributed_tensorflow_tpu_torch.serving.replica import (
        seeded_params, seeded_requests)

    if args.telemetry_dir:
        telemetry.configure(args.telemetry_dir)
    cfg = model_config(args.device)
    speed_kw = dict(prefix_caching=args.prefix_cache,
                    speculative_k=args.speculative,
                    kv_dtype=args.kv_dtype)
    if args.ckpt_dir:
        engine = InferenceEngine.from_checkpoint(
            cfg, args.ckpt_dir, device=args.device,
            queue_capacity=args.requests + 1, **ENGINE_KWARGS, **speed_kw)
    else:
        if params is None:
            params = seeded_params(cfg, args.device)
        engine = InferenceEngine(cfg, params, device=args.device,
                                 queue_capacity=args.requests + 1,
                                 **ENGINE_KWARGS, **speed_kw)
    reqs = seeded_requests(args.seed, args.requests, cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run_until_idle()
    if args.device == "cuda":
        torch.cuda.synchronize()
    span = time.perf_counter() - t0
    lats = sorted(r["latency_s"] for r in done.values())
    toks = sum(len(r["tokens"]) for r in done.values())
    p = lambda q: lats[min(len(lats) - 1, int(q * (len(lats) - 1)))]  # noqa: E731
    print(f"served {len(done)}/{args.requests} requests in {span:.2f}s "
          f"— {toks / span:.1f} tokens/s, latency p50 "
          f"{p(0.5) * 1e3:.1f}ms p99 {p(0.99) * 1e3:.1f}ms")
    print(f"engine stats: {engine.stats()}")
    if args.telemetry_dir:
        telemetry.shutdown()
        print(f"report: python3 tools/torch_obs_report.py "
              f"{args.telemetry_dir}")
    out = {"streams": {rid: list(r["tokens"]) for rid, r in done.items()},
           "served": len(done), "seconds": span,
           "tokens_per_s": toks / span, "requests_per_s": len(done) / span,
           "latency_p50_s": p(0.5), "latency_p99_s": p(0.99),
           "stats": engine.stats(), "n_layers": cfg.n_layers,
           "d_model": cfg.d_model}
    torch_entry.write_report(out)
    return out


def write_checkpoint(ckpt_dir: str, device: str = "cuda", params=None):
    """A seed-deterministic serving checkpoint (what a trainer would
    have produced) so ``--ckpt-dir`` restores real weights: ``params``
    or ``seeded_params``, in JAX's leaf layout."""
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        jax_params_layout)
    from distributed_tensorflow_tpu_torch.serving.replica import (
        seeded_params)

    cfg = model_config(device)
    if params is None:
        params = seeded_params(cfg, device)
    mgr = CheckpointManager(
        Checkpoint(params=jax_params_layout(cfg, params)), ckpt_dir)
    mgr.save(checkpoint_number=1)
    print(f"wrote serving checkpoint to {ckpt_dir}")


def disagg_kill_plan(seed: int, num_workers: int, kills: int,
                     step_range):
    """Disaggregation-aware chaos schedule (JAX's, exactly): alternate
    kills between the prefill replica (task 0 — dies mid-migration) and
    a seed-chosen decode replica (dies holding adopted blocks)."""
    import random

    from distributed_tensorflow_tpu_torch.resilience import KillSpec

    rng = random.Random(f"dtx-kill-disagg:{seed}")
    plan = []
    for i in range(kills):
        worker = 0 if i % 2 == 0 else rng.randrange(1, num_workers)
        plan.append(KillSpec(worker=worker,
                             after_step=rng.randrange(*step_range)))
    return plan


def kill_plan_for(args) -> list:
    """The elastic run's chaos plan: step range sized to the per-replica
    workload so the SIGKILL lands while requests are in flight."""
    from distributed_tensorflow_tpu_torch.resilience import seeded_kill_plan
    if args.kill_seed is None:
        return []
    per_replica = max(1, args.requests // args.workers)
    step_range = (3, max(6, per_replica))
    if args.disagg:
        return disagg_kill_plan(args.kill_seed, args.workers, args.kills,
                                step_range)
    return seeded_kill_plan(args.kill_seed, args.workers, kills=args.kills,
                            step_range=step_range)


def run_elastic(args) -> dict:
    from distributed_tensorflow_tpu_torch.resilience import (
        RecoverySupervisor)
    from distributed_tensorflow_tpu_torch.serving.replica import (
        serving_replica)

    if args.disagg and args.workers < 2:
        raise SystemExit("--disagg needs --workers >= 2 "
                         "(one prefill + at least one decode replica)")
    run_dir = args.run_dir or args.telemetry_dir
    if not run_dir:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="serve_elastic_")
    os.makedirs(run_dir, exist_ok=True)
    kill_plan = kill_plan_for(args)
    if args.kill_seed is not None:
        print(f"chaos kill plan (seed {args.kill_seed}): {kill_plan}")
    cfg = model_config(args.device)
    sup = RecoverySupervisor(
        serving_replica, num_workers=args.workers,
        args=(run_dir, args.requests, args.seed, cfg.vocab_size),
        kwargs={"ckpt_dir": args.ckpt_dir,
                "step_delay_s": args.step_delay,
                "prefix_caching": args.prefix_cache,
                "speculative_k": args.speculative,
                "kv_dtype": args.kv_dtype,
                "disagg": args.disagg,
                "cfg": cfg,
                "engine_kwargs": {"device": args.device}},
        device=args.device,
        max_restarts=args.restart_budget, kill_plan=kill_plan,
        generation_timeout_s=args.generation_timeout,
        telemetry_dir=args.telemetry_dir)
    result = sup.run()
    for task, served, total in sorted(result.return_values):
        print(f"replica {task}: served {served} this generation "
              f"({total} total on its shard)")
    print(f"done: {sup.restarts_used} restart(s), "
          f"{sup.failures_total} recorded failure(s), "
          f"final generation {sup.generation}")
    print(f"completion logs: {run_dir}/served-*.jsonl")
    if args.telemetry_dir:
        print(f"report: python3 tools/torch_obs_report.py "
              f"{args.telemetry_dir}")
    out = {"run_dir": run_dir, "restarts": sup.restarts_used,
           "failures": sup.failures_total, "generation": sup.generation,
           "kill_plan": [k.__dict__ for k in kill_plan]}
    torch_entry.write_report(out)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=24,
                    help="seeded workload size")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed (replayable)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="enable telemetry (serve.step/serve.request "
                         "events + recovery timeline)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore serving weights down the recovery "
                         "ladder from this CheckpointManager directory")
    ap.add_argument("--write-ckpt", action="store_true",
                    help="first write a seed-deterministic checkpoint "
                         "to --ckpt-dir (exercises the restore path)")
    ap.add_argument("--elastic", action="store_true",
                    help="run N supervised serving replicas (worker "
                         "death -> reform -> re-queue in-flight)")
    ap.add_argument("--workers", type=int, default=1,
                    help="elastic: number of serving replicas")
    ap.add_argument("--run-dir", default=None,
                    help="elastic: completion-log directory "
                         "(default: the telemetry dir)")
    ap.add_argument("--kill-seed", type=int, default=None,
                    help="elastic chaos: SIGKILL replicas on a schedule "
                         "derived from this seed")
    ap.add_argument("--kills", type=int, default=1)
    ap.add_argument("--restart-budget", type=int, default=3)
    ap.add_argument("--generation-timeout", type=float, default=600.0)
    ap.add_argument("--step-delay", type=float, default=0.05,
                    help="elastic: per-step pacing seconds (gives "
                         "step-targeted chaos kills a window to land)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable copy-on-write prefix caching "
                         "(cross-request KV reuse; outputs invariant, "
                         "restarted replicas rebuild the cache cold)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding: K draft tokens per "
                         "slot per step (greedy outputs exactly equal "
                         "non-speculative)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("f32", "bf16", "int8"),
                    help="KV-pool storage dtype (int8: quantized, "
                         "2x+ slots per chip)")
    ap.add_argument("--disagg", action="store_true",
                    help="elastic: disaggregated prefill/decode — task "
                         "0 prefills and migrates KV blocks to decode "
                         "tasks 1..N-1 over the chunked blob transport "
                         "(needs --workers >= 2)")
    torch_entry.add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, PROG)
    if args.write_ckpt:
        if not args.ckpt_dir:
            ap.error("--write-ckpt requires --ckpt-dir")
        write_checkpoint(args.ckpt_dir, args.device)
    if args.elastic:
        run_elastic(args)
    else:
        run_local(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

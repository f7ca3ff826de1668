#!/usr/bin/env python3
"""Chaos seed sweep: run the chaos suite across N seeds, report survival.

On the port: the counterpart of ``tools/chaos_sweep.py``, with its
flags, modes, gates, printed lines and exit codes; it adds only
``--device {cuda,cpu}`` (default ``cuda``; without CUDA it exits
non-zero naming it), which every port script it runs is given. Each
mode runs the port's script where JAX's runs its example
(``tools/torch_train_mnist.py``, ``torch_serve_transformer.py``,
``torch_serve_router.py``, ``torch_shared_fleet.py``,
``torch_train_online.py``, ``torch_live_rollout.py``), and checks the
run directory with ``tools/torch_obs_report.py`` and
``tools/torch_trace_report.py``. Three modes run otherwise than JAX's:

- the default mode runs ``tests/test_torch_chaos.py`` (JAX's eight
  scenarios on the port's modules; it imports nothing of JAX, so it runs
  where JAX is not installed) as ``python -m pytest --noconftest``;
- ``--offload`` runs the pipeline over two spawned ranks (pp 2, gloo on
  the CPU, NCCL on the card) where JAX uses two virtual devices;
- ``--day`` runs the port's ``testing/day_sim.DaySim`` in this process.

Each seed runs ``tests/test_chaos.py`` in its own pytest process with
``DTX_CHAOS_SEED=<seed>`` (the chaos tests derive every fault schedule
from it, and probabilistic rules draw from per-site streams seeded by
it — see resilience/faults.py). A seed "survives" when the whole suite
passes; the survival rate is the headline robustness number.

``--kill`` sweeps the OTHER failure axis — whole-process death: each
seed runs an elastic 2-worker MNIST job under the recovery supervisor
(tools/torch_train_mnist.py --elastic) with a seed-derived worker SIGKILL
schedule (resilience/supervisor.seeded_kill_plan). A seed survives only
when the job completes AND ``obs_report.py --check --require`` confirms
the telemetry recorded an actual recovery with a ``recovery.
restore_tier`` event — AND that recovery restored from the warmest tier
that held the freshest state (a run that fell back to cold disk while a
peer replica was available fails the seed). ``--shrink`` makes the
seed-chosen machine die permanently: the supervisor must reform at N-1
workers via a resharded restore (``recovery.reshard`` gated).
``--mttr-budget`` additionally bounds each recovery's measured MTTR.
Every ``--kill``/``--serve`` seed also walks the goodput/badput ledger
(telemetry/goodput.py): the accounting identity ``wall == goodput +
Σ badput`` must hold within 1% across all generations (torn tails
included), the recovery must be priced into the ``recovery`` bucket,
and ``--goodput-floor`` requires the recovered run to still clear a
seeded goodput fraction.

``--serve`` sweeps the SERVING replica axis: each seed runs a
supervised serving job (tools/torch_serve_transformer.py --elastic) whose
replica is SIGKILLed mid-load on a seed-derived schedule — with the
serving-speed features ON (``--prefix-cache --speculative
2``), so the kill also proves the restarted incarnation rebuilds its
prefix cache COLD and re-drafts from scratch without changing a single
token. A seed survives only when the job completes, ``obs_report
--check --require`` confirms the recovery timeline
(``recovery.restart`` + ``recovery.run_complete``) AND serving traffic
(``serve.step``, ``serve.request``), and the completion logs prove
ZERO dropped requests: the union of ``served-*.jsonl`` ids equals the
full seeded request set, with any cross-generation duplicates having
generated IDENTICAL tokens (deterministic re-serve).

``--serve --disagg`` runs the DISAGGREGATED topology
instead (``serve_transformer --elastic --disagg``, >= 3 workers: task
0 prefills and migrates KV blocks, tasks 1..N-1 decode) with a
disaggregation-aware kill schedule: one SIGKILL lands on the prefill
replica mid-migration, one on a decode replica holding adopted
blocks. On top of the zero-dropped / byte-identical-duplicate gates,
every ``serve.alloc_check`` event must show block-allocator
conservation (``leaked_refs`` == 0, ``conserved``) with at least one
present — a migration torn by SIGKILL may never leak a block — the
``kv_migrate`` badput bucket must be priced (> 0s), and
``preempt_replay`` must stay under 1%% of wall: live KV handoff, not
replay, is how in-flight work survives.

``--data`` sweeps the DISAGGREGATED-INPUT axis: each seed
runs a supervised data-service mnist job (tools/torch_train_mnist.py
--data-service — task 0 trains and dispatches FILE splits, tasks 1..M
are input workers under heartbeat-backed leases) with a seed-derived
INPUT-WORKER SIGKILL schedule. A seed survives only when the job
completes, the recovery timeline is recorded, AND the exactly-once
split accounting holds: every epoch the trainer completed consumed
each split exactly once (zero lost, zero duplicated — the
``data.split_consumed`` records are the proof), with the goodput
identity intact and the recovery priced.

``--spike`` sweeps the AUTOSCALING axis: each seed runs a
shared training+serving fleet (tools/torch_shared_fleet.py — a fixed
worker budget, SLO-burn-driven capacity arbitration) under a
seed-derived traffic spike. A seed survives only when the burn windows
fired and scale-up actually happened (training donated a worker via
the topology-elastic shrink path, warm resume — no cold restart), the
p99 burn returned under 1.0x in-run, scale-down returned the capacity
after the clear window, ZERO requests were dropped across every
reform, and the goodput ledger priced the whole maneuver in the
``scale_transition`` bucket with ``wall == goodput + Σ badput`` intact
(±1%) in BOTH jobs' ledgers.

``--online`` sweeps the ONLINE-TRAINING axis: each seed
runs the streaming recommender topology (tools/torch_train_online.py
--supervised — trainer/coordinator + async-PS grad worker + ingestor +
evaluator) with a seed-derived SIGKILL of the trainer, ingestor, or
evaluator mid-stream. A seed survives only when the job completes, the
recovery timeline is recorded, the EXACTLY-ONCE offset accounting
holds (every generation resumes at the lineage's last committed
offset, applies a contiguous run of stream records from there, and the
final commit covers every produced event — zero lost, zero
double-applied in the surviving lineage), the freshness SLO re-clears
in-run (the final published snapshot covers the whole stream within
the freshness budget, with at least one snapshot served after the last
recovery), and the goodput identity holds (±1%, recovery priced).

``--rollout`` sweeps the LIVE-ROLLOUT axis: each seed runs
the canary rollout harness (tools/torch_live_rollout.py — supervised
serving replicas hot-swapping weights under an SLO-gated
RolloutController) twice: once with a seed-derived SIGKILL landing
mid-swap/mid-canary, and once with the canary version made
deliberately slow (``--bad-canary``). A seed survives only when
every seeded request is served exactly (zero dropped across the kill,
the requeue, and any rollback), every completion byte-matches the
PURE output of the version it is stamped with (no mixed-version token
streams), the goodput identity holds within ±1% with swap transitions
priced into the ``rollout`` bucket, and the bad-canary run AUTO-ROLLS
BACK on SLO burn. A third, in-process leg injects seeded faults into
the delta-snapshot publish path (``delta.publish`` raise + corrupt):
pre-commit failures must be retry-safe and post-commit tears must be
caught by crc with the longest intact chain served bit-identically.

``--offload`` sweeps the ACTIVATION-SPILL axis: each seed
runs a fresh 2-device 1F1B pipeline with host-offloaded activations
(``offload_activations=True``) in a subprocess and injects seeded
faults into the ``offload.spill`` site at a seed-chosen cycle. Leg 1:
a SINGLE spill failure must be absorbed by the store's retry with the
run's params bit-identical to the fault-free run (the retry re-copies
the same device buffer — no recompute, no drift). Leg 2: a DOUBLE
failure on the same cycle must surface as a clean ``OffloadSpillError``
on the cycle that consumes the lost stash entry — never a hang (the
subprocess is killed on timeout and the seed fails), never silently
wrong activations.

``--day`` sweeps the PRODUCTION-DAY axis: each seed runs
the compressed diurnal macro-scenario (testing/day_sim.py — one
supervisor-run serving+training fleet through night / morning ramp
(real ``request_scale``) / peak / flash spike past capacity / a
seeded whole-RACK kill at peak / night), then scores it purely from
the event logs (telemetry/audit.py). A seed survives only when ZERO
admitted requests were dropped, the goodput identity holds within 1%
across every worker and generation, at most 5% of any SLO's bad
records are unattributed (every budget burn must trace to a logged
cause: recovery, scale transition, spike overload, ...), and the
rack-loss restore came from a WARM tier — ``host`` or ``peer``, never
``durable``: the domain-spread placement must have kept a replica
outside the dead rack.

The simulated-fleet axis of this family lives in
``tools/fleet_sweep.py``: seed-derived crash/stall/partition schedules
through hundreds of in-process workers (testing/fleet_sim.py) plus the
FLEET_r*.json control-plane scaling-curve gates — run it alongside the
sweeps here.

Usage::

    python tools/chaos_sweep.py --seeds 10            # seeds 0..9
    python tools/chaos_sweep.py --seeds 5 --base-seed 100 --slow
    python tools/chaos_sweep.py --seeds 3 -- -k preemption
    python tools/chaos_sweep.py --kill --seeds 3      # SIGKILL sweep
    python tools/chaos_sweep.py --kill --shrink --workers 3 --seeds 3
    python tools/chaos_sweep.py --serve --seeds 3     # serving sweep
    python tools/chaos_sweep.py --serve --disagg --seeds 3  # disagg
    python tools/chaos_sweep.py --router --seeds 3    # multi-tenant router
    python tools/chaos_sweep.py --data --seeds 3      # input-worker sweep
    python tools/chaos_sweep.py --rollout --seeds 3   # live-rollout sweep
    python tools/chaos_sweep.py --offload --seeds 3   # activation-spill sweep
    python tools/chaos_sweep.py --day --seeds 3       # production-day sweep

(the port: ``python3 tools/torch_chaos_sweep.py [--device cpu] ...``,
the same flags)

Everything after ``--`` is forwarded to pytest (fault-schedule mode
only). Exit code is non-zero if any seed fails (CI-friendly).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_entry  # noqa: E402

#: the device every port script a mode runs is given (``--device``)
DEVICE = "cuda"
#: the environment variable that hands ``--device`` to
#: ``tests/test_torch_chaos.py``
ENV_CHAOS_DEVICE = "DTX_CHAOS_DEVICE"


def _script(name: str) -> str:
    """The port's ``tools/torch_<name>.py``, which a mode runs where
    JAX's runs ``examples/<name>.py`` or ``tools/<name>.py``."""
    return os.path.join(REPO, "tools", f"torch_{name}.py")


def run_seed(seed: int, include_slow: bool, extra: list[str]) -> tuple[bool, float]:
    env = dict(os.environ)
    env["DTX_CHAOS_SEED"] = str(seed)
    env[ENV_CHAOS_DEVICE] = DEVICE
    marker = "chaos" if include_slow else "chaos and not slow"
    # --noconftest: tests/conftest.py imports jax, which need not be
    # installed where the port runs (the unregistered markers only warn)
    cmd = [sys.executable, "-m", "pytest", "--noconftest",
           "tests/test_torch_chaos.py", "-q",
           "-m", marker, "-p", "no:cacheprovider", *extra]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    dt = time.monotonic() - t0
    ok = proc.returncode == 0
    if not ok:
        tail = proc.stdout.decode(errors="replace").splitlines()[-15:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    return ok, dt


def _goodput_gate(run_dir: str, floor: "float | None", *,
                  expect_recovery: bool) -> "list[str]":
    """Goodput-ledger gate: the accounting identity
    ``wall == goodput + Σ badput`` must hold (±1% of wall) across every
    generation of the run — torn tails, SIGKILL'd writers and all —
    the recovery must be visibly priced in the ``recovery`` bucket when
    one happened, and (with a floor) the recovered run must still clear
    the seeded goodput floor. Returns violation messages (empty = ok)."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry import goodput
    ledger = goodput.ledger_from_run(run_dir)
    bad = []
    wall = ledger["wall_s"]
    if wall <= 0:
        return [f"no worker wall clock observed under {run_dir}"]
    err = abs(ledger["identity_error_s"]) / wall
    if err > 0.01:
        bad.append(f"ledger identity violated: wall {wall:.3f}s vs "
                   f"goodput+badput off by "
                   f"{ledger['identity_error_s']:+.3f}s ({err:.2%})")
    if expect_recovery and ledger["badput_s"]["recovery"] <= 0:
        bad.append("a recovery ran but the ledger priced 0s into the "
                   "recovery bucket")
    if floor is not None and (ledger["goodput_frac"] or 0.0) < floor:
        bad.append(f"goodput {ledger['goodput_frac']:.1%} below the "
                   f"floor {floor:.1%}")
    return bad


def _restore_tier_gate(run_dir: str) -> "list[str]":
    """A recovery must restore from the WARMEST tier that held the
    freshest state: any ``recovery.restore_tier`` event whose chosen
    tier is colder than its recorded ``best_available`` is a failure of
    the fast-recovery ladder, even if the run converged. Returns the
    violation messages (empty = ok)."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry.events import read_run
    rank = {"host": 0, "peer": 0, "memory": 0, "local": 1,
            "durable": 2, "none": 3}
    bad = []
    for pid, events in read_run(run_dir).items():
        for ev in events:
            if ev.get("ev") != "recovery.restore_tier":
                continue
            if not ev.get("generation"):
                continue          # gen-0 cold start: nothing to recover
            tier, best = ev.get("tier"), ev.get("best_available")
            if rank.get(tier, 3) > rank.get(best, 3):
                bad.append(
                    f"p{pid} gen{ev.get('generation')}: restored from "
                    f"{tier!r} but {best!r} held the freshest state "
                    f"(available={ev.get('available')})")
    return bad


def run_kill_seed(seed: int, *, workers: int, steps: int,
                  save_every: int, budget: int,
                  keep_dirs: bool, shrink: bool = False,
                  mttr_budget: "float | None" = None,
                  goodput_floor: "float | None" = None) \
        -> tuple[bool, float]:
    """One supervised elastic run with a seed-derived SIGKILL schedule;
    survival requires a clean exit AND telemetry proof (via ``obs_report
    --check --require``) that a recovery actually ran, restored from
    the warmest available tier, and (``shrink``) reformed at N-1 via a
    resharded restore."""
    kind = "shrink" if shrink else "kill"
    run_dir = tempfile.mkdtemp(prefix=f"chaos_{kind}_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable, _script("train_mnist"), "--device", DEVICE,
           "--elastic", "--workers", str(workers), "--steps", str(steps),
           "--save-every", str(save_every), "--kill-seed", str(seed),
           "--restart-budget", str(budget),
           "--ckpt-dir", os.path.join(run_dir, "ckpt"),
           "--telemetry-dir", run_dir]
    if shrink:
        cmd += ["--permanent-kill", "--shrink-after", "2",
                "--min-workers", str(max(1, workers - 1))]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if ok:
        gate_cmd = [sys.executable,
                    _script("obs_report"), "--device", DEVICE,
                    run_dir, "--check", "--require", "recovery.restart",
                    "--require", "recovery.run_complete",
                    "--require", "recovery.restore_tier"]
        if shrink:
            gate_cmd += ["--require", "recovery.reshard"]
        if mttr_budget is not None:
            gate_cmd += ["--mttr-budget", str(mttr_budget)]
        gate = subprocess.run(gate_cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: run finished but telemetry gate "
                  f"FAILED (rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if ok:
        violations = _restore_tier_gate(run_dir)
        if violations:
            ok = False
            print(f"--- seed {seed}: recovery restored from a COLDER "
                  f"tier than available ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _goodput_gate(run_dir, goodput_floor,
                                   expect_recovery=True)
        if violations:
            ok = False
            print(f"--- seed {seed}: goodput-ledger gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        # Trace-assembler completeness: every generation's
        # spans must be present and mergeable into ONE timeline — a
        # SIGKILL'd worker's torn tail is tolerated, a generation-sized
        # hole or unassemblable trace is not.
        gate = subprocess.run(
            [sys.executable, _script("trace_report"), "--device",
             DEVICE,
             run_dir, "--check"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: trace assembly gate FAILED "
                  f"(rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if not ok and proc.returncode != 0:
        tail = proc.stdout.decode(errors="replace").splitlines()[-15:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _split_accounting_gate(run_dir: str, num_splits: int,
                           epochs: int, kills: int) -> "list[str]":
    """Exactly-once split delivery under input-worker churn:
    for every epoch the trainer COMPLETED (``data.epoch_consumed``),
    its ``data.split_consumed`` records must cover split ids
    0..num_splits-1 exactly once — zero lost, zero duplicated; the
    union of completed (generation, epoch) pairs must cover every
    configured epoch; and the supervisor must have recorded one
    ``recovery.chaos_kill`` per scheduled kill plus >= 1 worker death.
    Returns violation messages (empty = ok)."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry.events import read_run
    bad = []
    consumed: dict = {}          # (gen, epoch) -> list of split ids
    completed: set = set()       # (gen, epoch) the trainer finished
    chaos_kills = 0
    deaths = 0
    for pid, events in read_run(run_dir).items():
        for ev in events:
            gen = ev.get("gen", 0)
            name = ev.get("ev")
            if name == "data.split_consumed":
                consumed.setdefault((gen, ev.get("epoch")),
                                    []).append(ev.get("split"))
            elif name == "data.epoch_consumed":
                completed.add((gen, ev.get("epoch")))
            elif name == "recovery.chaos_kill":
                chaos_kills += 1
            elif name == "recovery.worker_death":
                deaths += 1
    if not completed:
        return [f"no completed data-service epoch recorded under "
                f"{run_dir}"]
    expected = set(range(num_splits))
    for key in sorted(completed):
        splits = consumed.get(key, [])
        dup = sorted({s for s in splits if splits.count(s) > 1})
        missing = sorted(expected - set(splits))
        extra = sorted(set(splits) - expected)
        if dup:
            bad.append(f"gen{key[0]} epoch {key[1]}: DUPLICATED "
                       f"split(s) {dup[:8]}")
        if missing:
            bad.append(f"gen{key[0]} epoch {key[1]}: LOST split(s) "
                       f"{missing[:8]}")
        if extra:
            bad.append(f"gen{key[0]} epoch {key[1]}: unknown split "
                       f"id(s) {extra[:8]}")
    done_epochs = {e for _, e in completed}
    missing_epochs = sorted(set(range(epochs)) - done_epochs)
    if missing_epochs:
        bad.append(f"epoch(s) never completed in any generation: "
                   f"{missing_epochs}")
    if chaos_kills < kills:
        bad.append(f"only {chaos_kills}/{kills} scheduled input-worker "
                   f"kills were recorded (recovery.chaos_kill)")
    if deaths < 1:
        bad.append("no recovery.worker_death recorded for the kill")
    return bad


def run_data_seed(seed: int, *, input_workers: int, epochs: int,
                  split_files: int, budget: int, kills: int,
                  keep_dirs: bool,
                  goodput_floor: "float | None" = None) \
        -> tuple[bool, float]:
    """One supervised data-service mnist run with a seed-derived
    INPUT-WORKER SIGKILL schedule; survival = clean exit + recovery
    telemetry + exactly-once split accounting on every completed epoch
    + the goodput-ledger identity (recovery priced)."""
    run_dir = tempfile.mkdtemp(prefix=f"chaos_data_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable,
           _script("train_mnist"), "--device", DEVICE,
           "--data-service", "--input-workers", str(input_workers),
           "--epochs", str(epochs), "--split-files", str(split_files),
           "--kill-seed", str(seed), "--kills", str(kills),
           "--restart-budget", str(budget),
           "--ckpt-dir", os.path.join(run_dir, "ckpt"),
           "--telemetry-dir", run_dir]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if ok:
        gate_cmd = [sys.executable,
                    _script("obs_report"), "--device", DEVICE,
                    run_dir, "--check",
                    "--require", "recovery.restart",
                    "--require", "recovery.run_complete",
                    "--require", "data.split_consumed"]
        gate = subprocess.run(gate_cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: run finished but telemetry gate "
                  f"FAILED (rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if ok:
        violations = _split_accounting_gate(run_dir, split_files,
                                            epochs, kills)
        if violations:
            ok = False
            print(f"--- seed {seed}: exactly-once split accounting "
                  f"FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _goodput_gate(run_dir, goodput_floor,
                                   expect_recovery=True)
        if violations:
            ok = False
            print(f"--- seed {seed}: goodput-ledger gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if not ok and proc.returncode != 0:
        tail = proc.stdout.decode(errors="replace").splitlines()[-15:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _stream_accounting_gate(run_dir: str, total_events: int) \
        -> "list[str]":
    """Exactly-once event application across generations:

    - every generation that applied batches first recorded a
      ``stream.resume`` at the lineage's last committed offset (the
      max ``stream.commit`` of all PRIOR generations — work a dead
      incarnation applied but never committed is replayed, work it
      committed is never re-applied);
    - within a generation, ``stream.batch_applied`` ranges are
      CONTIGUOUS from the resume offset (no gap = zero lost, no
      overlap = zero double-applied in the surviving lineage);
    - commit offsets never exceed the applied prefix, and the final
      commit covers every configured event.

    Returns violation messages (empty = ok)."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry.events import read_run
    resumes: dict = {}            # gen -> resume offset
    batches: dict = {}            # gen -> [(lo, hi)] in file order
    commits: dict = {}            # gen -> [offsets] in file order
    for pid, events in read_run(run_dir).items():
        for ev in events:
            gen = ev.get("gen", 0)
            name = ev.get("ev")
            if name == "stream.resume":
                resumes[gen] = ev.get("offset")
            elif name == "stream.batch_applied":
                batches.setdefault(gen, []).append(
                    (ev.get("lo"), ev.get("hi")))
            elif name == "stream.commit":
                commits.setdefault(gen, []).append(ev.get("offset"))
    if not batches:
        return [f"no stream.batch_applied events under {run_dir}"]
    bad = []
    gens = sorted(set(resumes) | set(batches) | set(commits))
    committed_prefix = 0
    for gen in gens:
        resume = resumes.get(gen)
        gen_batches = batches.get(gen, [])
        if resume is None:
            if gen_batches:
                bad.append(f"gen{gen}: applied {len(gen_batches)} "
                           f"batch(es) without a stream.resume")
            continue
        if resume != committed_prefix:
            why = ("LOST" if resume > committed_prefix
                   else "REPLAYS COMMITTED")
            bad.append(
                f"gen{gen}: resumed at offset {resume} but the "
                f"lineage's committed prefix is {committed_prefix} "
                f"({why} events)")
        cursor = resume
        for lo, hi in gen_batches:
            if lo != cursor:
                why = ("GAP (lost events)" if lo > cursor
                       else "OVERLAP (double-applied)")
                bad.append(f"gen{gen}: batch [{lo},{hi}) does not "
                           f"abut applied prefix {cursor} ({why})")
            cursor = max(cursor, hi if isinstance(hi, int) else cursor)
        prev = committed_prefix
        for off in commits.get(gen, []):
            if off < prev:
                bad.append(f"gen{gen}: commit offset regressed "
                           f"{prev} -> {off}")
            if off > cursor:
                bad.append(f"gen{gen}: committed offset {off} beyond "
                           f"the applied prefix {cursor}")
            prev = off
        if commits.get(gen):
            committed_prefix = max(committed_prefix,
                                   max(commits[gen]))
    if committed_prefix != total_events:
        bad.append(f"final committed offset {committed_prefix} != "
                   f"{total_events} produced events")
    return bad


def _freshness_gate(run_dir: str, total_events: int,
                    freshness_budget_s: float) -> "list[str]":
    """The freshness SLO must RE-CLEAR in-run after the injected kill:
    the final published snapshot covers the whole stream with zero lag
    and freshness within budget, at least one snapshot was served
    AFTER the last recovery restart, and the multi-window burn is not
    firing at end of run."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo
    from distributed_tensorflow_tpu_torch.telemetry.events import read_run
    events_by_pid = read_run(run_dir)
    records = tv_slo.freshness_records_from_events(events_by_pid)
    if not records:
        return [f"no stream.snapshot_published events under {run_dir}"]
    bad = []
    last = records[-1]
    if last.get("offset") != total_events:
        bad.append(f"final snapshot covers offset {last.get('offset')} "
                   f"of {total_events} events (model went stale)")
    if last.get("lag_events"):
        bad.append(f"final snapshot still lags the stream by "
                   f"{last['lag_events']} event(s)")
    f = last.get("freshness_s")
    if not isinstance(f, (int, float)) or f > freshness_budget_s:
        bad.append(f"final snapshot freshness {f}s exceeds the "
                   f"{freshness_budget_s}s budget (SLO never "
                   f"re-cleared)")
    last_restart = 0.0
    for events in events_by_pid.values():
        for ev in events:
            if ev.get("ev") == "recovery.restart" \
                    and isinstance(ev.get("wall"), (int, float)):
                last_restart = max(last_restart, ev["wall"])
    if last_restart and not any(
            isinstance(r.get("wall"), (int, float))
            and r["wall"] > last_restart for r in records):
        bad.append("no snapshot was published after the last recovery "
                   "(the evaluator never came back)")
    span = ((records[-1]["wall"] - records[0]["wall"])
            if len(records) > 1 else 1.0)
    slos = tv_slo.default_online_slos(
        freshness_s=freshness_budget_s,
        windows=tv_slo.windows_for_span(max(span, 1e-3)))
    for name, res in tv_slo.evaluate_records(records, slos).items():
        if res["firing"]:
            bad.append(f"online SLO {name} still FIRING at end of run")
    return bad


def run_online_seed(seed: int, *, events: int, budget: int,
                    keep_dirs: bool, freshness_budget: float,
                    goodput_floor: "float | None" = None) \
        -> tuple[bool, float]:
    """One supervised online-training run with a seed-derived SIGKILL
    of the trainer/ingestor/evaluator; survival = clean exit + recovery
    telemetry + exactly-once offset accounting + freshness-SLO
    re-clear + the goodput-ledger identity (recovery priced)."""
    run_dir = tempfile.mkdtemp(prefix=f"chaos_online_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable,
           _script("train_online"), "--device", DEVICE,
           "--supervised", "--events", str(events),
           "--kill-seed", str(seed),
           "--restart-budget", str(budget),
           "--stream-dir", os.path.join(run_dir, "stream"),
           "--ckpt-dir", os.path.join(run_dir, "ckpt"),
           "--telemetry-dir", run_dir]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if ok:
        gate_cmd = [sys.executable,
                    _script("obs_report"), "--device", DEVICE,
                    run_dir, "--check",
                    "--require", "recovery.restart",
                    "--require", "recovery.run_complete",
                    "--require", "stream.commit",
                    "--require", "stream.snapshot_published"]
        gate = subprocess.run(gate_cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: run finished but telemetry gate "
                  f"FAILED (rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if ok:
        violations = _stream_accounting_gate(run_dir, events)
        if violations:
            ok = False
            print(f"--- seed {seed}: exactly-once stream accounting "
                  f"FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _freshness_gate(run_dir, events, freshness_budget)
        if violations:
            ok = False
            print(f"--- seed {seed}: freshness-SLO gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _goodput_gate(run_dir, goodput_floor,
                                   expect_recovery=True)
        if violations:
            ok = False
            print(f"--- seed {seed}: goodput-ledger gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if not ok and proc.returncode != 0:
        tail = proc.stdout.decode(errors="replace").splitlines()[-15:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _served_requests_gate(run_dir: str, n_requests: int,
                          serve_seed: int) -> "list[str]":
    """Zero dropped in-flight requests: the union of every replica's
    ``served-*.jsonl`` must cover the full seeded request set exactly,
    and any request served by more than one generation (killed after
    completion, torn log line) must have produced IDENTICAL tokens —
    greedy decode over fixed weights is deterministic, so divergence
    means the restarted replica lost cache/weight state."""
    import glob

    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.serving.replica import seeded_requests
    expected = {r.id for r in seeded_requests(serve_seed, n_requests, 256)}
    seen: dict[str, list] = {}
    bad = []
    for path in sorted(glob.glob(os.path.join(run_dir, "served-*.jsonl"))):
        with open(path) as f:
            for line in f:
                try:
                    rec = __import__("json").loads(line)
                except ValueError:
                    continue              # torn tail: that id re-served
                rid, toks = rec.get("id"), rec.get("tokens")
                if rid in seen and seen[rid] != toks:
                    bad.append(f"{rid}: generations disagree "
                               f"({seen[rid]} vs {toks})")
                seen.setdefault(rid, toks)
    missing = expected - set(seen)
    if missing:
        bad.append(f"{len(missing)} request(s) DROPPED: "
                   f"{sorted(missing)[:8]}")
    extra = set(seen) - expected
    if extra:
        bad.append(f"unexpected request ids: {sorted(extra)[:8]}")
    return bad


def _alloc_conservation_gate(run_dir: str) -> "list[str]":
    """Block-allocator conservation under migration chaos:
    every replica emits a ``serve.alloc_check`` at exit — free +
    allocated must equal the pool, and every live ref must be owned by
    a sequence or the prefix cache (``leaked_refs`` == 0). A SIGKILL
    mid-migration that leaks blocks shows up here even though the run
    'worked'. At least one check must be present."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry.events import read_run
    checks, bad = 0, []
    for pid, events in read_run(run_dir).items():
        for ev in events:
            if ev.get("ev") != "serve.alloc_check":
                continue
            checks += 1
            if ev.get("leaked_refs") or not ev.get("conserved"):
                bad.append(
                    f"p{pid} task{ev.get('task')} gen{ev.get('gen')}: "
                    f"allocator NOT conserved — leaked_refs="
                    f"{ev.get('leaked_refs')} free={ev.get('free')} "
                    f"allocated={ev.get('allocated')}")
    if checks == 0:
        bad.append("no serve.alloc_check events recorded — the leak "
                   "gate never ran")
    return bad


def _migrate_ledger_gate(run_dir: str,
                         max_replay_frac: float = 0.01) -> "list[str]":
    """The disagg pricing gate: migrations must be visibly priced into
    the ``kv_migrate`` badput bucket, and ``preempt_replay`` must stay
    under ``max_replay_frac`` of wall — in-flight work survives kills
    by live KV handoff (re-adopting committed blobs), not by replaying
    decode steps."""
    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry import goodput
    ledger = goodput.ledger_from_run(run_dir)
    bad = []
    wall = ledger["wall_s"]
    if ledger["badput_s"].get("kv_migrate", 0.0) <= 0:
        bad.append("0s priced into the kv_migrate bucket — migrations "
                   "either did not run or were not priced")
    replay = ledger["badput_s"].get("preempt_replay", 0.0)
    if wall > 0 and replay / wall > max_replay_frac:
        bad.append(f"preempt_replay {replay:.3f}s is "
                   f"{replay / wall:.1%} of wall (> "
                   f"{max_replay_frac:.0%}) — migration should have "
                   f"made replay ~0")
    return bad


def run_serve_seed(seed: int, *, workers: int, requests: int,
                   budget: int, keep_dirs: bool,
                   goodput_floor: "float | None" = None,
                   disagg: bool = False) \
        -> tuple[bool, float]:
    """One supervised serving run with a seed-derived replica SIGKILL;
    survival = clean exit + recovery & serving telemetry + zero dropped
    requests (see ``--serve`` in the module docstring). With
    ``disagg``, the disaggregated topology plus the allocator-
    conservation and migrate-pricing gates (``--serve --disagg``)."""
    kind = "serve_disagg" if disagg else "serve"
    run_dir = tempfile.mkdtemp(prefix=f"chaos_{kind}_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable,
           _script("serve_transformer"), "--device", DEVICE,
           "--elastic", "--workers", str(workers),
           "--requests", str(requests), "--seed", str(seed),
           "--kill-seed", str(seed),
           "--restart-budget", str(budget),
           "--run-dir", run_dir, "--telemetry-dir", run_dir]
    if disagg:
        # two scheduled kills: the prefill replica mid-migration AND a
        # decode replica holding adopted blocks (serve_transformer's
        # disagg-aware kill plan alternates between them)
        cmd += ["--disagg", "--kills", "2"]
    else:
        # serving-speed features ON under chaos: the
        # SIGKILLed replica restarts with a COLD prefix cache and a
        # fresh draft, and the zero-dropped / byte-identical-
        # duplicate gates below prove correctness never depended on
        # cache or speculation state
        cmd += ["--prefix-cache", "--speculative", "2"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if ok:
        gate_cmd = [sys.executable,
                    _script("obs_report"), "--device", DEVICE,
                    run_dir, "--check",
                    "--require", "recovery.restart",
                    "--require", "recovery.run_complete",
                    "--require", "serve.step",
                    "--require", "serve.request"]
        gate = subprocess.run(gate_cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: run finished but telemetry gate "
                  f"FAILED (rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if ok:
        violations = _served_requests_gate(run_dir, requests, seed)
        if violations:
            ok = False
            print(f"--- seed {seed}: dropped/diverged requests ---")
            for v in violations:
                print(f"    {v}")
    if ok and disagg:
        violations = _alloc_conservation_gate(run_dir)
        if violations:
            ok = False
            print(f"--- seed {seed}: allocator-conservation gate "
                  f"FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok and disagg:
        violations = _migrate_ledger_gate(run_dir)
        if violations:
            ok = False
            print(f"--- seed {seed}: migrate-pricing gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _goodput_gate(run_dir, goodput_floor,
                                   expect_recovery=True)
        if violations:
            ok = False
            print(f"--- seed {seed}: goodput-ledger gate FAILED ---")
            for v in violations:
                print(f"    {v}")
    if not ok and proc.returncode != 0:
        tail = proc.stdout.decode(errors="replace").splitlines()[-15:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _router_summary_gates(summary: dict) -> "list[str]":
    """The --router survival conditions over one run's
    ``router-summary.json`` (tools/torch_serve_router.py analyze):
    zero dropped, byte-identical duplicates, no double-routing across
    the router restart, affinity beating the same-chaos random
    baseline, the interactive class re-meeting its SLO after the
    outage drains, batch not starved past its own SLO, batch shed
    first under pressure, the quota tenant rejected with the right
    cause, and the goodput identity with the re-route cost priced."""
    bad = []
    if summary.get("dropped"):
        bad.append(f"dropped requests: {summary['dropped']}")
    if summary.get("duplicates_mismatched"):
        bad.append(f"{summary['duplicates_mismatched']} duplicate "
                   f"serve(s) were NOT byte-identical")
    if summary.get("double_routes"):
        bad.append(f"{summary['double_routes']} rid(s) double-ROUTED "
                   f"(journal resume must never re-decide)")
    if not (summary.get("affinity_hit_rate", 0.0)
            > summary.get("random_hit_rate", 1.0)):
        bad.append(
            f"affinity hit rate {summary.get('affinity_hit_rate')} "
            f"not above random {summary.get('random_hit_rate')}")
    if not summary.get("interactive_recovered"):
        bad.append(
            f"interactive never re-met its SLO after the outage "
            f"(window p99 {summary.get('interactive_recovery_p99_s')}s"
            f", {summary.get('recovery_samples')})")
    if summary.get("batch_starved_past_slo"):
        bad.append(f"batch starved past its own SLO "
                   f"(recovery p99 "
                   f"{summary.get('batch_recovery_p99_s')}s)")
    if not summary.get("sheds"):
        bad.append("batch was never shed under pressure (priority "
                   "classes did not engage)")
    quota = {k: v for k, v
             in (summary.get("rejects_by_tenant_cause") or {}).items()
             if k.endswith("/quota")}
    if not quota:
        bad.append("the quota tenant's overrun was never rejected "
                   "with cause=quota")
    err = summary.get("identity_error_frac")
    if err is None or err > 0.01:
        bad.append(f"goodput identity violated ({err})")
    if summary.get("reroutes") \
            and summary.get("badput_reroute_replay_s", 0.0) <= 0.0:
        bad.append("re-routes happened but no reroute_replay badput "
                   "was priced")
    if summary.get("badput_recovery_s", 0.0) <= 0.0:
        bad.append("replica kill left no recovery badput (was the "
                   "outage measured at all?)")
    return bad


def run_router_seed(seed: int, *, workers: int, keep_dirs: bool) \
        -> tuple[bool, float]:
    """One multi-tenant routed-serving run with a seed-derived replica
    SIGKILL AND a seeded router SIGKILL mid-spike, plus the same-chaos
    random-routing baseline phase (module docstring, ``--router``).
    Survival = clean exit + router/recovery telemetry +
    ``_router_summary_gates`` over the run's router-summary.json."""
    run_dir = tempfile.mkdtemp(prefix=f"chaos_router_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable,
           _script("serve_router"), "--device", DEVICE,
           "--run-dir", run_dir, "--seed", str(seed),
           "--workers", str(workers), "--kill-seed", str(seed)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if not ok:
        tail = proc.stdout.decode(errors="replace").splitlines()[-20:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    if ok:
        gate_cmd = [sys.executable,
                    _script("obs_report"), "--device", DEVICE,
                    os.path.join(run_dir, "affinity", "telemetry"),
                    "--check",
                    "--require", "router.route",
                    "--require", "router.shed",
                    "--require", "serve.reject",
                    "--require", "serve.request",
                    "--require", "recovery.restart",
                    "--require", "recovery.run_complete"]
        gate = subprocess.run(gate_cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if gate.returncode != 0:
            ok = False
            print(f"--- seed {seed}: run finished but telemetry gate "
                  f"FAILED (rc={gate.returncode}) ---")
            print(gate.stdout.decode(errors="replace").strip())
    if ok:
        with open(os.path.join(run_dir, "router-summary.json")) as f:
            summary = json.load(f)
        violations = _router_summary_gates(summary)
        if violations:
            ok = False
            print(f"--- seed {seed}: router gates FAILED ---")
            for v in violations:
                print(f"    {v}")
        else:
            print(f"    seed {seed}: {summary['served_unique']} "
                  f"served / 0 dropped, {summary['duplicates']} "
                  f"byte-identical dup(s), "
                  f"{summary['reroutes']} reroute(s), affinity "
                  f"{summary['affinity_hit_rate']:.1%} vs random "
                  f"{summary['random_hit_rate']:.1%}, recovery p99 "
                  f"{summary['interactive_recovery_p99_s']}s")
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _spike_gates(summary: dict,
                 goodput_floor: "float | None") -> "list[str]":
    """The --spike survival conditions over one run's recomputed
    spike-summary (tools/torch_shared_fleet.py analyze): closed loop
    fired, SLO recovered, zero dropped, identity + scale_transition
    pricing, warm donation, capacity returned."""
    bad = []
    su = summary.get("scale_up") or {}
    if not su.get("applied_up"):
        bad.append("no scale-up was applied (burn windows never "
                   "actuated)")
    if not su.get("donations"):
        bad.append("training never donated a worker "
                   "(no donate_to_serving reform)")
    if not summary.get("slo_recovered"):
        bad.append("p99 burn never returned under 1.0x after scale-up")
    if not summary.get("capacity_returned"):
        bad.append("capacity was not returned to training after the "
                   "clear window")
    reqs = summary.get("requests") or {}
    if reqs.get("dropped"):
        bad.append(f"{reqs['dropped']} request(s) DROPPED: "
                   f"{reqs.get('missing_ids')}")
    if not summary.get("train_warm_resume"):
        bad.append(f"donation was not a warm resume "
                   f"(restore tiers: {summary.get('train_restore_tiers')})")
    priced = 0.0
    for role, led in (summary.get("ledger") or {}).items():
        err = led.get("identity_error_frac")
        if err is None or err > 0.01:
            bad.append(f"{role} ledger identity violated "
                       f"({err if err is not None else 'no wall'})")
        priced += (led.get("badput_s") or {}).get("scale_transition",
                                                  0.0)
        if goodput_floor is not None and role == "serve":
            frac = led.get("goodput_frac") or 0.0
            if frac < goodput_floor:
                bad.append(f"serve goodput {frac:.1%} below the floor "
                           f"{goodput_floor:.1%}")
    if priced <= 0:
        bad.append("no scale transition was priced into the "
                   "scale_transition badput bucket")
    return bad


def run_spike_seed(seed: int, *, budget: int, train_workers: int,
                   keep_dirs: bool,
                   goodput_floor: "float | None" = None,
                   extra_args: "list[str] | None" = None) \
        -> tuple[bool, float]:
    """One shared-fleet spike run (tools/torch_shared_fleet.py); survival
    gated on the recomputed spike summary (see ``--spike`` in the
    module docstring)."""
    run_dir = tempfile.mkdtemp(prefix=f"chaos_spike_s{seed}_")
    env = dict(os.environ)
    cmd = [sys.executable,
           _script("shared_fleet"), "--device", DEVICE,
           "--seed", str(seed), "--budget", str(budget),
           "--train-workers", str(train_workers),
           "--telemetry-dir", run_dir, *(extra_args or [])]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ok = proc.returncode == 0
    if ok:
        import json
        try:
            with open(os.path.join(run_dir, "spike-summary.json")) as f:
                summary = json.load(f)
        except (OSError, ValueError) as e:
            summary = None
            ok = False
            print(f"--- seed {seed}: no spike summary ({e}) ---")
        if summary is not None:
            violations = _spike_gates(summary, goodput_floor)
            if violations:
                ok = False
                print(f"--- seed {seed}: autoscale gates FAILED ---")
                for v in violations:
                    print(f"    {v}")
            else:
                su = summary["scale_up"]
                print(f"    seed {seed}: scale-up "
                      f"{su.get('scale_up_latency_s')}s after spike, "
                      f"burn peak {summary.get('burn_peak_short')}x, "
                      f"recovery {summary.get('slo_recovery_s')}s, "
                      f"capacity returned")
    if not ok and proc.returncode != 0:
        tail = proc.stdout.decode(errors="replace").splitlines()[-20:]
        print(f"--- seed {seed} FAILED (rc={proc.returncode}) ---")
        print("\n".join(tail))
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    (run dir kept for inspection: {run_dir})")
    return ok, dt


def _rollout_summary_gate(run_dir: str, *,
                          expect_rollback: bool = False) -> "list[str]":
    """Gates recomputed by examples/live_rollout.py's ``analyze``
    (coverage from completion-log unions, version identity against
    pure-engine references, the priced ledger) — this just enforces
    the thresholds."""
    import json
    bad = []
    try:
        with open(os.path.join(run_dir, "rollout-summary.json")) as f:
            s = json.load(f)
    except (OSError, ValueError) as e:
        return [f"no rollout summary: {e}"]
    req = s.get("requests", {})
    if req.get("dropped", 1) != 0:
        bad.append(f"{req.get('dropped')} request(s) DROPPED "
                   f"({req.get('missing_ids')})")
    ver = s.get("versions", {})
    if ver.get("mixed_or_wrong", 1) != 0:
        bad.append(f"{ver.get('mixed_or_wrong')} completion(s) with "
                   f"mixed/wrong-version tokens ({ver.get('examples')})")
    if ver.get("unversioned", 1) != 0:
        bad.append(f"{ver.get('unversioned')} completion(s) missing a "
                   f"model_version stamp")
    led = s.get("ledger", {})
    err = led.get("identity_error_frac")
    if err is None or err > 0.01:
        bad.append(f"ledger identity off by {err} (> 1%)")
    if expect_rollback and not s.get("rollout", {}).get("rolled_back"):
        bad.append(f"bad canary was NOT rolled back "
                   f"(state={s.get('rollout', {}).get('state')})")
    if not expect_rollback and s.get("swaps", {}).get("hot", 0) \
            + s.get("swaps", {}).get("restart", 0) == 0:
        bad.append("no swap ever happened (canary never started)")
    return bad


def _delta_fault_gate(seed: int) -> "list[str]":
    """Seeded faults on the ``delta.publish`` site: a pre-commit raise
    must leave nothing behind (retry publishes cleanly) and a
    post-commit corrupt must be caught by crc, with reconstruction
    serving the longest intact chain bit-identically."""
    import pickle
    import numpy as np

    sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.checkpoint import (
        DeltaSnapshotStore, states_equal)
    from distributed_tensorflow_tpu_torch.embedding.dynamic import (
        DynamicTable, DynamicTableConfig)
    from distributed_tensorflow_tpu_torch.resilience import faults
    from distributed_tensorflow_tpu_torch.resilience.faults import (
        FaultRule, FaultSchedule)

    bad = []
    tmp = tempfile.mkdtemp(prefix=f"chaos_delta_s{seed}_")
    rng = np.random.default_rng(seed)
    cfg = DynamicTableConfig(dim=8, initial_capacity=128,
                             max_capacity=512)
    table = DynamicTable(cfg, device=DEVICE)
    store = DeltaSnapshotStore(tmp, full_every=3)

    def _touch(n):
        ids = rng.integers(0, 900, size=n)
        rows = table.translate(ids)
        table.apply_row_grads(
            rows, rng.normal(size=(len(ids), cfg.dim))
            .astype(np.float32))

    publishes = 6
    raise_at = int(rng.integers(1, publishes + 1))
    sched = FaultSchedule(rules=[
        FaultRule(site="delta.publish", hits=(raise_at,))])
    fired = 0
    with faults.inject(sched):
        for _ in range(publishes):
            _touch(24)
            try:
                store.publish(table)
            except OSError:
                fired += 1
                store.publish(table)      # pre-commit: retry is clean
    if fired != 1:
        bad.append(f"raise fault fired {fired}x (expected 1 at "
                   f"publish #{raise_at})")
    good_state = table.state_dict()
    rt, info = store.reconstruct(cfg, device=DEVICE)
    if info["chain_broken"]:
        bad.append(f"chain broken after retried publishes: {info}")
    elif not states_equal(good_state, rt.state_dict()):
        bad.append("post-retry reconstruction is not bit-identical")
    # post-commit tear on the NEXT publish: crc must catch it and the
    # chain must fall back to the last intact record
    _touch(24)
    sched = FaultSchedule(rules=[
        FaultRule(site="delta.publish", action="corrupt", hits=(1,))])
    with faults.inject(sched):
        store.publish(table)
    rt, info = store.reconstruct(cfg, device=DEVICE)
    if not info["chain_broken"]:
        bad.append("post-commit tear was NOT detected")
    elif not states_equal(good_state, rt.state_dict()):
        bad.append("torn-chain fallback is not bit-identical to the "
                   "last intact publish")
    if not bad:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        bad.append(f"(delta dir kept: {tmp})")
    return bad


def run_rollout_seed(seed: int, *, replicas: int, duration: float,
                     keep_dirs: bool) -> tuple[bool, float]:
    """One live-rollout seed: a kill run (SIGKILL mid-swap/mid-canary),
    a bad-canary run (must auto-rollback on burn), and the in-process
    delta-publish fault leg (module docstring, ``--rollout``)."""
    env = dict(os.environ)
    t0 = time.monotonic()
    ok = True
    run_dirs = []
    legs = [
        ("kill", ["--kills", "1"], False),
        ("bad-canary", ["--bad-canary"], True),
    ]
    for name, extra, expect_rollback in legs:
        if not ok:
            break
        run_dir = tempfile.mkdtemp(prefix=f"chaos_rollout_s{seed}_"
                                          f"{name.replace('-', '')}_")
        run_dirs.append(run_dir)
        cmd = [sys.executable,
               _script("live_rollout"), "--device", DEVICE,
               "--seed", str(seed), "--replicas", str(replicas),
               "--duration", str(duration),
               "--telemetry-dir", run_dir,
               "--ckpt-dir", os.path.join(run_dir, "ckpt"),
               *extra]
        proc = subprocess.run(cmd, cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            ok = False
            tail = proc.stdout.decode(errors="replace") \
                .splitlines()[-20:]
            print(f"--- seed {seed} ({name}) FAILED "
                  f"(rc={proc.returncode}) ---")
            print("\n".join(tail))
            break
        violations = _rollout_summary_gate(
            run_dir, expect_rollback=expect_rollback)
        if violations:
            ok = False
            print(f"--- seed {seed}: rollout gates FAILED ({name}) ---")
            for v in violations:
                print(f"    {v}")
    if ok:
        violations = _delta_fault_gate(seed)
        if violations:
            ok = False
            print(f"--- seed {seed}: delta-publish fault gate "
                  f"FAILED ---")
            for v in violations:
                print(f"    {v}")
    dt = time.monotonic() - t0
    if not keep_dirs and ok:
        import shutil
        for d in run_dirs:
            shutil.rmtree(d, ignore_errors=True)
    elif not ok and run_dirs:
        print(f"    (run dir kept for inspection: {run_dirs[-1]})")
    return ok, dt


# --offload on the port: the pipeline spans two processes, one a pp
# rank (spawned by testing/multi_process_runner: gloo on the CPU, NCCL
# on the card), where JAX's child holds two virtual devices. The child
# (its own process, so that a hung consumer fails by the timeout) runs
# the three legs' ranks from this module and prints OFFLOAD-OK /
# OFFLOAD-FAIL lines; its exit code is the verdict.
_OFFLOAD_CHILD = r"""
import os
import sys

sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
import torch_chaos_sweep

sys.exit(torch_chaos_sweep.offload_child(int(sys.argv[1]), sys.argv[2]))
"""


def _offload_target(seed: int) -> int:
    """The seeded stash cycle JAX's child targets: S=2, M=4 -> 6 cycles;
    only cycles 0..M-1 write stash entries a later cycle consumes (the
    tail entries are warmup garbage nobody reads), so the seeded target
    must land there for the double failure to surface."""
    import numpy as np
    return int(np.random.default_rng(seed).integers(0, 4))


def _offload_rank(device: str, seed: int, hits: tuple) -> dict:
    """One rank of a leg: JAX's tiny 4-layer 1F1B step over ``{"pp": 2}``
    with the stash spilled to the host, run from the same initial state
    without faults and then under the seeded ``offload.spill`` rule of
    ``hits``; this rank's parameters after each, and the faults fired.
    Attention takes the flash op (``attention_impl=None``; JAX's tiny
    config takes the reference), so on the card the ranks run #1-#3; with
    ``DTX_ENTRY_REPORT`` set each rank writes its launch counters there
    (``-offload<rank>`` appended)."""
    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.topology import make_mesh
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_pipelined_train_step)
    from distributed_tensorflow_tpu_torch.resilience import faults
    # the double-failure leg ends with the consuming rank raising, and
    # its peer waits in a collective until the group's timeout (NCCL does
    # not see a peer exit): that leg's ranks, whose kernels the first leg
    # built, time out sooner
    bootstrap.initialize(device=device,
                         timeout_s=120 if len(hits) == 1 else 45)
    cfg = TransformerConfig.tiny(n_layers=4, attention_impl=None)
    mesh = make_mesh({"pp": 2}, device=device)
    # seeded tokens from numpy (JAX's child draws them from jax.random)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len)))}

    def params_after(sched):
        state0, step = make_pipelined_train_step(
            cfg, mesh, 8, 4, schedule="1f1b", offload_activations=True)
        with faults.inject(sched) as reg:
            step(state0, batch)
        return ({k: v.detach().cpu().numpy()
                 for k, v in state0["model"].state_dict().items()},
                [e[0] for e in reg.events()])

    base, _ = params_after(faults.FaultSchedule(seed=seed, rules=()))
    retried, fired = params_after(faults.FaultSchedule(seed=seed, rules=(
        faults.FaultRule(site="offload.spill",
                         tag=f"c{_offload_target(seed)}", hits=hits,
                         max_fires=len(hits)),)))
    torch_entry.write_report(
        suffix=f"-offload{torch.distributed.get_rank()}")
    return {"base": base, "retried": retried, "fired": fired}


def offload_child(seed: int, device: str) -> int:
    """The --offload legs (JAX's ``_OFFLOAD_CHILD``) over two spawned pp
    ranks: a single spill failure at the seeded cycle must be absorbed
    by the retry bit for bit, and a double one must raise a clean
    ``OffloadSpillError`` on the rank that consumes the stash."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.testing import (
        multi_process_runner as mpr)
    rank_fn = torch_entry.worker("torch_chaos_sweep", "_offload_rank")
    target = _offload_target(seed)

    def leg(hits):
        return mpr.run(rank_fn, 2, args=(device, seed, hits), device=device,
                       timeout=300).return_values

    ranks = leg((1,))
    if not any("offload.spill" in r["fired"] for r in ranks):
        print("OFFLOAD-FAIL: single-spill fault never fired")
        return 1
    for r in ranks:
        for k, v in r["base"].items():
            if not np.array_equal(v, r["retried"][k]):
                print("OFFLOAD-FAIL: params diverged after the retried "
                      "spill (retry must be a byte-for-byte re-copy)")
                return 1
    print(f"OFFLOAD-OK: single spill failure at c{target} absorbed "
          f"bit-identically")
    try:
        leg((1, 2))
    except mpr.SubprocessError as e:
        for t in e.mpr_result.tasks.values():
            for line in (t.error or "").splitlines():
                if line.startswith(("OffloadSpillError",
                                    "distributed_tensorflow_tpu_torch.")) \
                        and "OffloadSpillError: " in line:
                    print(f"OFFLOAD-OK: double spill failure surfaced "
                          f"cleanly: "
                          f"{line.split('OffloadSpillError: ', 1)[1]}")
                    return 0
    print("OFFLOAD-FAIL: double spill failure did NOT raise "
          "OffloadSpillError")
    return 1


def run_offload_seed(seed: int, *, timeout_s: float = 600.0) \
        -> tuple[bool, float]:
    """One activation-spill chaos seed (module docstring, --offload):
    retry-absorption and clean-double-failure legs over two spawned pp
    ranks, in a subprocess; a hung consumer fails via the timeout."""
    env = dict(os.environ)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _OFFLOAD_CHILD, str(seed), DEVICE],
            cwd=REPO, env=env, timeout=timeout_s,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        ok = proc.returncode == 0
        out = proc.stdout.decode(errors="replace")
    except subprocess.TimeoutExpired as e:
        ok = False
        out = ((e.stdout or b"").decode(errors="replace")
               + f"\nOFFLOAD-FAIL: HUNG (> {timeout_s:.0f}s) — a lost "
                 f"stash entry must error, not stall the consumer")
    for line in out.splitlines():
        if line.startswith("OFFLOAD-"):
            print(f"    seed {seed}: {line}")
    if not ok:
        tail = out.splitlines()[-15:]
        print(f"--- seed {seed} FAILED ---")
        print("\n".join(tail))
    return ok, time.monotonic() - t0


def run_day_seed(seed: int, *, keep_dirs: bool = False,
                 goodput_floor: "float | None" = None) \
        -> tuple[bool, float]:
    """One production-day seed (module docstring, --day): the
    compressed diurnal macro-scenario in-process (thread-backed
    SimRunner), scored afterwards purely from its event logs. Gates:
    zero dropped requests, goodput identity <=1%, unattributed SLO
    burn <=5%, rack-loss restore from a warm (host/peer) tier."""
    import shutil

    # the other axes shell out to example scripts with cwd=REPO; this
    # one runs the thread-backed sim in-process
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from distributed_tensorflow_tpu_torch.telemetry import (
        audit as tv_audit, events as tv_events)
    from distributed_tensorflow_tpu_torch.testing.day_sim import DaySim

    t0 = time.monotonic()
    run_dir = tempfile.mkdtemp(prefix=f"day_sweep_s{seed}_")
    fails: "list[str]" = []
    try:
        result = DaySim(seed=seed, logdir=run_dir).run()
        if result["error"] is not None:
            fails.append(f"supervisor error: {result['error']}")
        else:
            audit = tv_audit.audit_day(tv_events.read_run(run_dir))
            fails = tv_audit.check_audit(
                audit, identity_tol=0.01, max_unattributed=0.05,
                goodput_floor=goodput_floor,
                require_warm_restore=True, require_no_drops=True)
            if not fails:
                rack = audit["rack_loss"]
                led = audit["ledger"]
                print(f"    seed {seed}: goodput "
                      f"{led['goodput_frac']:.1%}, "
                      f"{audit['requests']['completed']} served / "
                      f"0 dropped, rack {rack['domain']} restored "
                      f"{rack['restore_tiers']} in "
                      f"{rack['mttr_s'] * 1e3:.0f}ms")
    except Exception as e:  # noqa: BLE001
        fails.append(f"day run raised: {e!r}")
    ok = not fails
    for f in fails:
        print(f"    seed {seed}: DAY-FAIL: {f}")
    if ok and not keep_dirs:
        shutil.rmtree(run_dir, ignore_errors=True)
    elif not ok:
        print(f"    seed {seed}: run dir kept: {run_dir}")
    return ok, time.monotonic() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5,
                    help="number of seeds to sweep (default 5)")
    ap.add_argument("--base-seed", type=int, default=0,
                    help="first seed (default 0)")
    ap.add_argument("--slow", action="store_true",
                    help="include slow (multi-process) chaos tests")
    ap.add_argument("--kill", action="store_true",
                    help="sweep seed-driven worker SIGKILLs through the "
                         "recovery supervisor instead of fault schedules")
    ap.add_argument("--serve", action="store_true",
                    help="sweep seed-driven SIGKILLs of SERVING replicas "
                         "mid-load: supervisor must restart the replica, "
                         "in-flight requests must be re-served (zero "
                         "dropped), recovery visible in obs_report")
    ap.add_argument("--disagg", action="store_true",
                    help="with --serve: disaggregated prefill/decode "
                         "topology (>= 3 workers) with kills landing "
                         "on the prefill replica mid-migration and a "
                         "decode replica holding adopted blocks; adds "
                         "the allocator-conservation and kv_migrate-"
                         "pricing gates")
    ap.add_argument("--router", action="store_true",
                    help="sweep the multi-tenant routed-serving axis "
                         "(tools/torch_serve_router.py): per seed a "
                         "replica SIGKILL mid-load AND a router "
                         "SIGKILL mid-spike, with a same-chaos "
                         "random-routing baseline; zero-dropped, "
                         "byte-identical-duplicate, no-double-route, "
                         "affinity>random, SLO-recovery, batch-"
                         "no-starvation, quota-reject and priced-"
                         "reroute gates")
    ap.add_argument("--spike", action="store_true",
                    help="sweep seeded traffic spikes through a shared "
                         "training+serving fleet: the autoscaler must "
                         "scale serving up by donating a trainer (warm "
                         "resume), recover the SLO, price the "
                         "transition, and return the capacity")
    ap.add_argument("--budget", type=int, default=3,
                    help="--spike: fixed worker budget")
    ap.add_argument("--data", action="store_true",
                    help="sweep seed-driven SIGKILLs of INPUT WORKERS "
                         "through a supervised data-service mnist run: "
                         "every completed epoch must show exactly-once "
                         "split delivery (zero lost, zero duplicated) "
                         "with the recovery visible in telemetry")
    ap.add_argument("--online", action="store_true",
                    help="sweep seed-driven SIGKILLs of the online "
                         "topology's trainer/ingestor/evaluator "
                         "(tools/torch_train_online.py --supervised): "
                         "exactly-once stream-offset accounting, "
                         "freshness-SLO re-clear, and the goodput "
                         "identity are gated per seed")
    ap.add_argument("--rollout", action="store_true",
                    help="sweep the live-rollout axis "
                         "(tools/torch_live_rollout.py): per seed a "
                         "SIGKILL mid-swap/mid-canary, a bad-canary "
                         "run that must auto-rollback, and seeded "
                         "delta-publish faults; zero-dropped, "
                         "no-mixed-version, priced-transition and "
                         "chain-honesty gates")
    ap.add_argument("--offload", action="store_true",
                    help="sweep seeded faults on the offload.spill "
                         "site of the host-offloaded 1F1B activation "
                         "stash: a single spill failure must be "
                         "retry-absorbed bit-identically, a double "
                         "failure must raise a clean OffloadSpillError "
                         "on the consuming cycle (never hang, never "
                         "silently wrong activations)")
    ap.add_argument("--day", action="store_true",
                    help="sweep the production-day axis "
                         "(testing/day_sim.py): per seed a compressed "
                         "diurnal curve with a flash spike and a "
                         "whole-rack kill at peak; zero-dropped, "
                         "goodput-identity, <=5%%-unattributed-burn "
                         "and warm-tier-restore gates")
    ap.add_argument("--duration", type=float, default=18.0,
                    help="--rollout: serving duration per run (s)")
    ap.add_argument("--events", type=int, default=480,
                    help="--online: stream events per run")
    ap.add_argument("--freshness-budget", type=float, default=10.0,
                    help="--online: final-snapshot update->servable "
                         "budget in seconds (the SLO threshold the "
                         "re-clear gate evaluates)")
    ap.add_argument("--input-workers", type=int, default=2,
                    help="--data: input-worker tasks per run")
    ap.add_argument("--epochs", type=int, default=2,
                    help="--data: epochs per run")
    ap.add_argument("--split-files", type=int, default=8,
                    help="--data: FILE splits per epoch")
    ap.add_argument("--kills", type=int, default=1,
                    help="--data: scheduled input-worker kills per run")
    ap.add_argument("--requests", type=int, default=24,
                    help="--serve: seeded workload size per run")
    ap.add_argument("--shrink", action="store_true",
                    help="with --kill: permanent-loss schedules — the "
                         "seed-chosen machine dies for good and the "
                         "supervisor must reform at N-1 via a resharded "
                         "restore (recovery.reshard gated)")
    ap.add_argument("--mttr-budget", type=float, default=None,
                    help="--kill: fail a seed whose recovery MTTR "
                         "exceeds this many seconds "
                         "(obs_report --mttr-budget)")
    ap.add_argument("--goodput-floor", type=float, default=None,
                    metavar="FRAC",
                    help="--kill/--serve: fail a seed whose recovered "
                         "run's goodput fraction lands below this; the "
                         "ledger identity (wall == goodput + badput "
                         "±1%%) and a non-empty recovery bucket are "
                         "gated unconditionally")
    ap.add_argument("--workers", type=int, default=2,
                    help="--kill: workers per supervised run")
    ap.add_argument("--steps", type=int, default=20,
                    help="--kill: training steps per run")
    ap.add_argument("--save-every", type=int, default=5,
                    help="--kill: checkpoint interval")
    ap.add_argument("--restart-budget", type=int, default=3,
                    help="--kill: supervisor restart budget")
    ap.add_argument("--keep-dirs", action="store_true",
                    help="--kill: keep telemetry dirs of passing seeds")
    ap.add_argument("pytest_args", nargs="*",
                    help="extra args forwarded to pytest (after --)")
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = torch_entry.check_device(args.device, "torch_chaos_sweep")

    if args.shrink and not args.kill:
        ap.error("--shrink requires --kill")
    if args.disagg and not args.serve:
        ap.error("--disagg requires --serve")
    if args.shrink and args.workers < 2:
        ap.error("--shrink needs at least 2 workers to shrink from")
    if sum(bool(x) for x in (args.serve, args.kill, args.data,
                             args.spike, args.online, args.rollout,
                             args.offload, args.day,
                             args.router)) > 1:
        ap.error("--kill, --serve, --data, --spike, --online, "
                 "--rollout, --offload, --day and --router are "
                 "separate sweep axes")
    results = []
    for s in range(args.base_seed, args.base_seed + args.seeds):
        if args.router:
            ok, dt = run_router_seed(s, workers=args.workers,
                                     keep_dirs=args.keep_dirs)
        elif args.day:
            ok, dt = run_day_seed(s, keep_dirs=args.keep_dirs,
                                  goodput_floor=args.goodput_floor)
        elif args.offload:
            ok, dt = run_offload_seed(s)
        elif args.rollout:
            ok, dt = run_rollout_seed(s, replicas=args.workers,
                                      duration=args.duration,
                                      keep_dirs=args.keep_dirs)
        elif args.online:
            ok, dt = run_online_seed(
                s, events=args.events, budget=args.restart_budget,
                keep_dirs=args.keep_dirs,
                freshness_budget=args.freshness_budget,
                goodput_floor=args.goodput_floor)
        elif args.spike:
            ok, dt = run_spike_seed(s, budget=args.budget,
                                    train_workers=args.workers,
                                    keep_dirs=args.keep_dirs,
                                    goodput_floor=args.goodput_floor,
                                    extra_args=args.pytest_args)
        elif args.data:
            ok, dt = run_data_seed(s, input_workers=args.input_workers,
                                   epochs=args.epochs,
                                   split_files=args.split_files,
                                   budget=args.restart_budget,
                                   kills=args.kills,
                                   keep_dirs=args.keep_dirs,
                                   goodput_floor=args.goodput_floor)
        elif args.serve:
            ok, dt = run_serve_seed(
                s,
                # disagg needs one prefill + at least two decode
                # replicas (a rescue migration target must exist)
                workers=(max(args.workers, 3) if args.disagg
                         else args.workers),
                requests=args.requests,
                budget=args.restart_budget,
                keep_dirs=args.keep_dirs,
                goodput_floor=args.goodput_floor,
                disagg=args.disagg)
        elif args.kill:
            ok, dt = run_kill_seed(s, workers=args.workers,
                                   steps=args.steps,
                                   save_every=args.save_every,
                                   budget=args.restart_budget,
                                   keep_dirs=args.keep_dirs,
                                   shrink=args.shrink,
                                   mttr_budget=args.mttr_budget,
                                   goodput_floor=args.goodput_floor)
        else:
            ok, dt = run_seed(s, args.slow, args.pytest_args)
        results.append((s, ok, dt))
        print(f"seed {s:>4}: {'PASS' if ok else 'FAIL'}  ({dt:.1f}s)",
              flush=True)

    survived = sum(1 for _, ok, _ in results if ok)
    rate = survived / len(results) if results else 0.0
    print(f"\nsurvival: {survived}/{len(results)} seeds "
          f"({100 * rate:.0f}%)")
    if survived != len(results):
        print("failing seeds:",
              [s for s, ok, _ in results if not ok])
    return 0 if survived == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())

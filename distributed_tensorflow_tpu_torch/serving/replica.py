"""Supervised serving replicas — port of
``distributed_tensorflow_tpu/serving/replica.py``.

A *serving replica* is one :class:`~distributed_tensorflow_tpu_torch.
serving.engine.InferenceEngine` driven by :func:`serving_replica` (a
static or timed workload) or :func:`routed_replica` (whatever the
router appends to its inbox): a worker function shaped like an elastic
trainer — module-level, heartbeating once per engine step, restartable
from scratch at any instant. Run it under
:class:`~distributed_tensorflow_tpu_torch.resilience.supervisor.
RecoverySupervisor` and a SIGKILLed replica is detected, its generation
reformed and the process respawned.

**Zero dropped requests.** A replica appends one JSONL record per
COMPLETED request to ``served-<task>.jsonl`` (line-buffered: a SIGKILL
loses at most the line in flight). On (re)start it reads the completion
logs back, treats every recorded id as done and serves the rest. Greedy
decode over fixed weights re-generates the same tokens for a request
that was half-decoded at the kill, so the union of the logs covers the
workload and any duplicate is byte-identical (the JAX package's
contract; the port's decode batches hold only the running sequences,
so the card's gate runs this in f32).

The workload generators (:func:`seeded_requests`,
:func:`seeded_spike_schedule`), the shared epoch (:func:`run_epoch`),
the completion logs, the inbox wire format and the drain modes are the
JAX package's, byte for byte, so either package's tools read the
other's run directory.

Differences on purpose: a replica joins no process group (replicas run
no collective and meet only through files in the run directory); its
task index and replica count come from ``TF_CONFIG`` and its card from
``LOCAL_RANK`` (``engine_kwargs={"device": "cpu"}`` runs it on the
CPU). ``cfg=None`` serves JAX's ``TransformerConfig.tiny(max_seq_len=
64)``; another config (``transformer_big()`` on the card) serves that
model. With no ``ckpt_dir`` the weights are :func:`seeded_params`
(``init_params`` from a ``torch.Generator`` seeded 0: every incarnation
serves the same model, though not JAX's numbers); with ``ckpt_dir`` they
come from :meth:`InferenceEngine.from_checkpoint`, which reads a
checkpoint either package wrote. Each replica publishes this process's
kernel launch counters to ``launches-<task>-g<gen>.json`` as it serves.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import random

from distributed_tensorflow_tpu_torch.ops import launch_counts
from distributed_tensorflow_tpu_torch.serving.scheduler import Request


def seeded_requests(seed: int, n: int, vocab_size: int, *,
                    prompt_range: tuple = (4, 12),
                    new_tokens_range: tuple = (2, 10)) -> list[Request]:
    """Deterministic synthetic workload (a string-seeded stream, stable
    across processes and runs): every replica incarnation regenerates
    the SAME request set from the seed."""
    rng = random.Random(f"dtx-serve:{seed}")
    out = []
    for i in range(n):
        plen = rng.randrange(*prompt_range)
        out.append(Request(
            id=f"r{i:04d}",
            tokens=tuple(rng.randrange(vocab_size) for _ in range(plen)),
            max_new_tokens=rng.randrange(*new_tokens_range)))
    return out


def seeded_spike_schedule(seed: int, *, duration_s: float = 40.0,
                          base_qps: float = 2.0, spike_qps: float = 8.0,
                          spike_start_s: float = 8.0,
                          spike_end_s: float = 22.0,
                          vocab_size: int = 256,
                          prompt_range: tuple = (4, 12),
                          new_tokens_range: tuple = (2, 6)
                          ) -> list[Request]:
    """Open-loop Poisson arrivals at ``base_qps`` with a spike window at
    ``spike_qps``, a pure function of the seed; arrival times in
    ``Request.arrival_s`` relative to the shared :func:`run_epoch`."""
    rng = random.Random(f"dtx-spike:{seed}")
    out: list[Request] = []
    t = 0.0
    i = 0
    while True:
        rate = (spike_qps if spike_start_s <= t < spike_end_s
                else base_qps)
        t += rng.expovariate(rate)
        if t >= duration_s:
            break
        plen = rng.randrange(*prompt_range)
        out.append(Request(
            id=f"s{i:05d}",
            tokens=tuple(rng.randrange(vocab_size)
                         for _ in range(plen)),
            max_new_tokens=rng.randrange(*new_tokens_range),
            arrival_s=round(t, 6)))
        i += 1
    return out


def run_epoch(run_dir: str) -> float:
    """The run's shared t=0 wall clock: first writer wins (O_EXCL), so
    every replica and every incarnation anchors the same arrival
    schedule to the same instant."""
    import time as _time
    path = os.path.join(run_dir, "run-epoch.json")
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        with os.fdopen(fd, "w") as f:
            json.dump({"epoch": _time.time()}, f)
    except FileExistsError:
        pass
    for _ in range(100):
        try:
            with open(path) as f:
                return float(json.load(f)["epoch"])
        except (OSError, ValueError):
            _time.sleep(0.01)            # racing writer: not yet flushed
    raise RuntimeError(f"unreadable run epoch at {path}")


def completed_ids_all(run_dir: str) -> dict[str, list]:
    """The UNION of every replica's completion log — what a (re)started
    replica treats as already done (a scale reform re-shards the
    workload, so another replica's completions count too)."""
    out: dict[str, list] = {}
    for path in sorted(_glob.glob(os.path.join(run_dir,
                                               "served-*.jsonl"))):
        out.update(completed_ids(path))
    return out


def completed_ids(path: str) -> dict[str, list]:
    """``{request_id: tokens}`` from a replica's completion log; torn
    trailing lines (SIGKILL mid-write) are skipped."""
    out: dict[str, list] = {}
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue                  # torn line: not completed
                if "id" in rec:
                    out[rec["id"]] = rec.get("tokens", [])
    except OSError:
        pass
    return out


def seeded_params(cfg, device) -> dict:
    """The weights a replica serves without a checkpoint: the port's
    ``init_params`` from a ``torch.Generator`` on ``device`` seeded 0 —
    every incarnation, and an in-process engine built from this, serves
    the same model."""
    import torch

    from distributed_tensorflow_tpu_torch.models.transformer import (
        init_params)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    return init_params(cfg, gen, device)


def launches_path(run_dir: str, task: int, gen: int) -> str:
    """Where replica ``task`` of generation ``gen`` publishes its
    launch counters (rewritten, atomically, as it serves)."""
    return os.path.join(run_dir, f"launches-{task}-g{gen}.json")


def _publish_launches(run_dir: str, task: int, gen: int, warmup=None):
    path = launches_path(run_dir, task, gen)
    rec = {"task": task, "gen": gen, "launches": launch_counts(),
           "warmup": warmup}
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def _replica_setup(engine_kwargs: "dict | None"):
    """``(task, n_replicas, device)``: the task's index among the
    cluster's chief and worker tasks and their count, from
    ``TF_CONFIG`` (JAX's ``process_id`` / ``num_processes``), and its
    device: ``engine_kwargs["device"]``, default the task's card
    ``cuda:LOCAL_RANK`` (no card raises)."""
    import torch

    from distributed_tensorflow_tpu_torch.cluster.resolver import (
        TFConfigClusterResolver)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)
    resolver = TFConfigClusterResolver()
    task, n = resolver.process_id(), resolver.num_processes()
    dev = resolve_device((engine_kwargs or {}).get("device", "cuda"))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", task)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return task, max(1, n), dev


def _make_engine(cfg, ckpt_dir, device, kwargs):
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    kwargs = dict(kwargs, device=device)
    if ckpt_dir:
        return InferenceEngine.from_checkpoint(cfg, ckpt_dir, **kwargs)
    # seed-deterministic weights: every incarnation serves the same
    # model, so re-served requests generate identical tokens
    return InferenceEngine(cfg, seeded_params(cfg, device), **kwargs)


def _handoff_index(kv) -> dict:
    """``{request_id: blob_prefix}`` of committed drain-by-migration
    handoffs, HIGHEST generation winning (later = more decode progress).
    Keys are ``handoff/g<gen>/t<task>/<rid>``."""
    best: dict = {}
    for key in kv.list("handoff/"):
        if not key.endswith("/n"):
            continue
        parts = key.split("/")      # handoff, g<gen>, t<task>, rid, n
        if len(parts) != 5:
            continue
        try:
            gen = int(parts[1][1:])
        except ValueError:
            continue
        rid = parts[3]
        if rid not in best or gen > best[rid][0]:
            best[rid] = (gen, key[:-len("/n")])
    return {rid: pfx for rid, (g, pfx) in best.items()}


def _try_adopt(engine, kv, prefix: str, timeout_s: float = 2.0) -> str:
    """Adopt one committed migration blob. Returns ``"adopted"``,
    ``"full"`` (fits but no capacity RIGHT NOW — retry later) or
    ``"bad"`` (fingerprint mismatch / corrupt blob — the caller
    re-serves from the prompt, which is always correct)."""
    from distributed_tensorflow_tpu_torch.serving import migrate as _mig
    try:
        payload = _mig.fetch_payload(kv, prefix, timeout_s=timeout_s)
        if payload.fingerprint != engine.pool_fingerprint():
            return "bad"
        if not engine.can_adopt(payload):
            return "full"
        engine.adopt_sequence(payload)
        return "adopted"
    except Exception:           # noqa: BLE001 — any bad blob re-serves
        return "bad"


def serving_replica(run_dir: str, n_requests: int, seed: int,
                    vocab_size: int = 256, *, max_retries: int = 50,
                    engine_kwargs: dict | None = None,
                    ckpt_dir: str | None = None,
                    step_delay_s: float = 0.0,
                    spike: dict | None = None,
                    prefix_caching: bool = False,
                    speculative_k: int = 0,
                    kv_dtype: str | None = None,
                    disagg: bool = False,
                    cfg=None, workload_kwargs: dict | None = None):
    """One generation of one supervised serving replica (JAX ``:200``).

    Serves the seeded workload to completion, heartbeating every engine
    step; restartable at any point via the completion log.
    ``step_delay_s`` paces the step loop. ``spike`` (kwargs for
    :func:`seeded_spike_schedule`, minus seed/vocab, plus ``linger_s``)
    switches to the open-loop timed workload: requests are submitted
    when their arrival time passes (relative to the shared
    :func:`run_epoch`), latency is measured from the true arrival, and
    the supervisor's drain flag is honored every step.
    ``prefix_caching`` / ``speculative_k`` / ``kv_dtype`` switch on the
    engine's output-invariant serving optimisations. ``disagg=True``
    (>= 2 replicas) makes task 0 the prefill replica that publishes
    every prefilled sequence's KV to its decode owner through
    ``serving/migrate.py``'s ``FileKV`` (``<run_dir>/kvwire``).
    ``cfg`` / ``ckpt_dir``: the module docstring; ``workload_kwargs``
    passes :func:`seeded_requests`' ``prompt_range`` /
    ``new_tokens_range`` (JAX's defaults without it).

    Returns ``(task_index, n_served_this_generation,
    n_total_completed)``."""
    import collections as _collections
    import time as _time

    from distributed_tensorflow_tpu_torch.cluster import elastic
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    from distributed_tensorflow_tpu_torch.resilience.faults import (
        FaultInjected)
    from distributed_tensorflow_tpu_torch.serving import migrate as _mig
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    task, n_replicas, device = _replica_setup(engine_kwargs)
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=task)
    # live goodput ledger: serve steps are goodput, replayed tokens are
    # preempt_replay badput; everything before the first step is startup
    goodput.activate(goodput.GoodputLedger())

    linger_s = 0.0
    epoch = None
    if spike is not None:
        spike = dict(spike)
        # keep serving (idle) past the schedule's end so the burn-clear
        # window — and the autoscaler's reclaim — happen while replicas
        # are still alive to be drained and resharded
        linger_s = float(spike.pop("linger_s", 0.0))
        workload = seeded_spike_schedule(seed, vocab_size=vocab_size,
                                         **spike)
        done = completed_ids_all(run_dir)
    else:
        workload = seeded_requests(seed, n_requests, vocab_size,
                                   **(workload_kwargs or {}))
        # disagg reads the UNION: completions land in the decode
        # replicas' logs, and the prefill replica must not re-admit them
        done = (completed_ids_all(run_dir) if disagg
                else completed_ids(os.path.join(run_dir,
                                                f"served-{task}.jsonl")))
    disagg = bool(disagg) and n_replicas >= 2 and spike is None

    cfg = cfg if cfg is not None else TransformerConfig.tiny(max_seq_len=64)
    kwargs = dict(num_blocks=48, block_size=8, max_slots=4,
                  max_prompt_len=16,
                  queue_capacity=len(workload) + 1,
                  prefix_caching=prefix_caching,
                  speculative_k=speculative_k,
                  kv_dtype=kv_dtype)
    kwargs.update(engine_kwargs or {})
    if disagg and task == 0:
        kwargs["role"] = "prefill"
    engine = _make_engine(cfg, ckpt_dir, device, kwargs)
    gen = elastic.generation()

    warm = None
    if spike is not None:
        # warm up BEFORE anchoring (or reading) the run epoch: start-up
        # is not client-visible queueing and must not poison the latency
        # SLO stream that drives the autoscaler
        engine.submit(Request(id=f"warmup-{task}-g{gen}",
                              tokens=(1, 2, 3), max_new_tokens=2))
        engine.run_until_idle(retry_faults=True)
        warm = launch_counts()
        epoch = run_epoch(run_dir)
    _publish_launches(run_dir, task, gen, warm)

    kv = _mig.FileKV(os.path.join(run_dir, "kvwire"))
    n_dec = max(1, n_replicas - 1)

    def _dtask(rid: str) -> int:
        """Deterministic request -> decode-replica owner (disagg)."""
        return 1 + int(rid.lstrip("rs")) % n_dec

    log_path = os.path.join(run_dir, f"served-{task}.jsonl")
    if disagg:
        mine = (list(workload) if task == 0
                else [r for r in workload if _dtask(r.id) == task])
    else:
        # replicas statically shard the workload (request i -> replica
        # i mod N); the union of the completion logs must cover it all
        mine = [r for i, r in enumerate(workload)
                if i % n_replicas == task]
    todo = [r for r in mine if r.id not in done]
    print(f"[gen {gen} serve-{task}] {len(mine) - len(todo)} already "
          f"served, {len(todo)} of {len(mine)} to go", flush=True)

    served = 0
    step = 0
    retries = 0
    drained = False
    pending = _collections.deque(todo)   # arrival order == index order
    finished_ids: set = set()
    if spike is None and not disagg:
        # drain-by-migration handoffs of a previous generation: adopt the
        # live KV instead of re-serving from the prompt; anything that
        # does not fit or match simply submits
        handoffs = _handoff_index(kv)
        adopted_n = 0
        for r in todo:
            pfx = handoffs.get(r.id)
            if pfx is not None and _try_adopt(engine, kv,
                                              pfx) == "adopted":
                adopted_n += 1
            else:
                engine.submit(r)
        if adopted_n:
            print(f"[gen {gen} serve-{task}] adopted {adopted_n} "
                  f"drained sequence(s) by KV migration", flush=True)
        pending.clear()

    def _log_finished(log, finished):
        nonlocal served
        for rec in finished:
            log.write(json.dumps({
                "id": rec["id"], "tokens": rec["tokens"],
                "prompt_tokens": rec["prompt_tokens"],
                "latency_s": round(rec["latency_s"], 6),
                "gen": gen}) + "\n")
            finished_ids.add(rec["id"])
            served += 1
        if finished:
            _publish_launches(run_dir, task, gen, warm)

    def _step(log) -> bool:
        """One retried engine step."""
        nonlocal retries
        try:
            _log_finished(log, engine.step())
        except FaultInjected:
            retries += 1
            if retries > max_retries:
                raise
        return True

    def _drain(log, mode: str):
        """Drain-before-stop: ``fast`` finishes only the RUNNING
        sequences (the queue re-shards), ``full`` everything admitted,
        ``migrate`` exports every running sequence's live KV to a
        per-generation handoff blob and then finishes the rest."""
        nonlocal drained
        held = 0
        migrated = 0
        if mode == "full":
            while not engine.scheduler.idle:
                elastic.heartbeat(step)
                _step(log)
        else:
            while engine.scheduler.queue.pop() is not None:
                held += 1
            if mode == "migrate":
                for seq in sorted(engine.scheduler.running.values(),
                                  key=lambda s: s.slot):
                    if not seq.prefilled or seq.done:
                        continue
                    rid = seq.request.id
                    payload = engine.export_sequence(seq,
                                                     reason="drain")
                    _mig.publish_payload(
                        kv, f"handoff/g{gen}/t{task}/{rid}", payload)
                    migrated += 1
            while engine.scheduler.running:
                elastic.heartbeat(step)
                _step(log)
        tv_events.event("serve.drain", task=task, mode=mode,
                        completed=served,
                        requeued=held + len(pending),
                        migrated=migrated or None)
        drained = True

    def _finish(msg: str):
        elastic.heartbeat(step)
        # allocator conservation audit at generation end
        tv_events.event("serve.alloc_check", task=task,
                        **engine.block_accounting())
        _publish_launches(run_dir, task, gen, warm)
        print(f"[gen {gen} serve-{task}] {msg}", flush=True)
        goodput.activate(None)
        if tdir:
            tv_events.shutdown()

    if disagg and task == 0:
        # ---- prefill replica: admit everything, prefill, publish ----
        pending.clear()
        todo = [r for r in todo
                if not _mig.payload_committed(
                    kv, f"mig/d{_dtask(r.id)}/{r.id}")]
        with open(log_path, "a", buffering=1) as log:
            for r in todo:
                engine.submit(r)
            while not engine.scheduler.idle:
                elastic.heartbeat(step)
                if elastic.drain_mode() is not None:
                    # every prefilled sequence is exported the step it
                    # commits, so drain just stops admitting
                    drained = True
                    break
                if step_delay_s:
                    _time.sleep(step_delay_s)
                _step(log)        # admit + prefill (+ scoring finishes)
                step += 1
                for seq in sorted(engine.scheduler.running.values(),
                                  key=lambda s: s.slot):
                    if seq.prefilled and not seq.done:
                        rid = seq.request.id
                        payload = engine.export_sequence(
                            seq, reason="prefill")
                        _mig.publish_payload(
                            kv, f"mig/d{_dtask(rid)}/{rid}", payload)
        _finish(f"prefilled+shipped, {served} completed at prefill "
                f"({'drained' if drained else 'complete'}), "
                f"{retries} injected-fault retries")
        return task, served, served

    if disagg:
        # ---- decode replica: adopt my blobs, run the token loop -----
        pending.clear()
        todo_by_id = {r.id: r for r in todo}
        todo_ids = set(todo_by_id)
        shipped: set = set()
        handoffs = _handoff_index(kv)
        with open(log_path, "a", buffering=1) as log:
            while todo_ids - finished_ids:
                elastic.heartbeat(step)
                mode = elastic.drain_mode()
                if mode is not None:
                    _drain(log, mode if mode == "full" else "migrate")
                    break
                for rid in sorted(todo_ids - finished_ids - shipped):
                    pfx = handoffs.get(rid, f"mig/d{task}/{rid}")
                    if not _mig.payload_committed(kv, pfx):
                        continue
                    got = _try_adopt(engine, kv, pfx)
                    if got == "full":
                        break           # capacity frees as seqs finish
                    if got == "bad":
                        # stale/incompatible blob: serve from the prompt
                        engine.submit(todo_by_id[rid])
                    shipped.add(rid)
                if engine.scheduler.running:
                    if step_delay_s:
                        _time.sleep(step_delay_s)
                    _step(log)
                    step += 1
                else:
                    _time.sleep(0.01)   # blobs still in flight
        _finish(f"served {served} this generation "
                f"({'drained' if drained else 'complete'}), "
                f"{retries} injected-fault retries")
        return task, served, len(mine) - len(todo) + served

    end_rel = (float(spike.get("duration_s", 40.0)) + linger_s
               if spike is not None else 0.0)

    def _more_to_do() -> bool:
        if pending or not engine.scheduler.idle:
            return True
        return (spike is not None
                and _time.time() - epoch < end_rel)

    with open(log_path, "a", buffering=1) as log:
        while _more_to_do():
            elastic.heartbeat(step)
            mode = elastic.drain_mode()
            if mode is not None:
                _drain(log, mode)
                break
            if spike is not None:
                now_rel = _time.time() - epoch
                while pending and pending[0].arrival_s <= now_rel:
                    r = pending.popleft()
                    # backdate the latency clock to the TRUE arrival
                    engine.submit(r, arrival_wall=epoch + r.arrival_s)
                if engine.scheduler.idle:
                    # nothing running, nothing due: doze until the next
                    # arrival (still heartbeating)
                    _time.sleep(min(0.05, max(
                        0.001, (pending[0].arrival_s - now_rel)
                        if pending else 0.05)))
                    continue
            if step_delay_s:
                _time.sleep(step_delay_s)
            _step(log)
            step += 1
    _finish(f"served {served} this generation "
            f"({'drained' if drained else 'complete'}), "
            f"{retries} injected-fault retries")
    return task, served, len(mine) - len(todo) + served


# ---------------------------------------------------------------------------
# Routed replicas (the multi-tenant frontend, serving/router.py)
# ---------------------------------------------------------------------------

def inbox_path(run_dir: str, task: int) -> str:
    """The line-buffered per-replica inbox the router appends routed
    requests to and :func:`routed_replica` tails."""
    return os.path.join(run_dir, f"inbox-{task}.jsonl")


def replica_metrics_dir(run_dir: str, task: int) -> str:
    """Where replica ``task`` exports its live metrics
    (``metrics-live.prom``): one directory a replica, so the router can
    scrape each one's queue depth (and judge liveness by mtime)."""
    return os.path.join(run_dir, f"metrics-{task}")


def request_to_wire(request: Request, meta: "dict | None" = None
                    ) -> dict:
    """One inbox line: the request's full content plus the router's
    routing metadata (``reroute`` marks re-dispatch after a replica
    death)."""
    return {"id": request.id, "tokens": list(request.tokens),
            "max_new_tokens": request.max_new_tokens,
            "eos_id": request.eos_id,
            "arrival_s": request.arrival_s,
            "tenant": request.tenant, "pclass": request.pclass,
            **(meta or {})}


def request_from_wire(rec: dict) -> Request:
    return Request(id=rec["id"], tokens=tuple(rec["tokens"]),
                   max_new_tokens=int(rec.get("max_new_tokens", 16)),
                   eos_id=rec.get("eos_id"),
                   arrival_s=float(rec.get("arrival_s", 0.0)),
                   tenant=rec.get("tenant"),
                   pclass=rec.get("pclass") or "interactive")


def _read_complete_lines(f) -> "list[str]":
    """New COMPLETE lines since the last call; a partial trailing line
    (the router mid-append) rewinds and is retried next poll."""
    lines = []
    while True:
        pos = f.tell()
        line = f.readline()
        if not line:
            break
        if not line.endswith("\n"):
            f.seek(pos)         # torn tail: the router is mid-write
            break
        lines.append(line)
    return lines


def routed_replica(run_dir: str, seed: int, *,
                   max_retries: int = 50,
                   engine_kwargs: "dict | None" = None,
                   step_delay_s: float = 0.0,
                   export_interval_s: float = 0.5,
                   cfg=None, ckpt_dir: "str | None" = None):
    """One generation of one ROUTER-FED serving replica (JAX ``:654``).

    Tails its inbox (:func:`inbox_path`), serves whatever lands there,
    and logs completions to ``served-<task>.jsonl``. A respawned
    incarnation re-reads the inbox from the top, skips every id in the
    fleet-wide completion union and re-serves the rest — plus whatever
    the router re-routes here (``reroute`` lines; their completions
    emit ``serve.rerouted`` and price ``reroute_replay``). Its
    :class:`~distributed_tensorflow_tpu_torch.telemetry.exporter.
    MetricsExporter` writes :func:`replica_metrics_dir`, which the
    router scrapes for queue depth and liveness. Prefix caching is on
    by default. ``cfg`` / ``ckpt_dir``: the module docstring.

    Exits when the router's ``eof`` sentinel has been read AND the
    engine is idle. Returns ``(task, served_this_gen, total_done)``."""
    import time as _time

    from distributed_tensorflow_tpu_torch.cluster import elastic
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    from distributed_tensorflow_tpu_torch.resilience.faults import (
        FaultInjected)
    from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
    from distributed_tensorflow_tpu_torch.telemetry import exporter as tv_exp
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    task, _, device = _replica_setup(engine_kwargs)
    tdir = os.environ.get(tv_events.ENV_TELEMETRY_DIR)
    if tdir:
        tv_events.configure(tdir, process_id=task)
    goodput.activate(goodput.GoodputLedger())

    cfg = cfg if cfg is not None else TransformerConfig.tiny(max_seq_len=64)
    kwargs = dict(num_blocks=96, block_size=8, max_slots=4,
                  max_prompt_len=40, queue_capacity=4096,
                  prefix_caching=True)
    kwargs.update(engine_kwargs or {})
    engine = _make_engine(cfg, ckpt_dir, device, kwargs)

    # warm up BEFORE the epoch is anchored (start-up is not
    # client-visible queueing), exactly like the spike path
    gen = elastic.generation()
    engine.submit(Request(id=f"warmup-{task}-g{gen}", tokens=(1, 2, 3),
                          max_new_tokens=2))
    engine.run_until_idle(retry_faults=True)
    warm = launch_counts()
    _publish_launches(run_dir, task, gen, warm)

    mdir = replica_metrics_dir(run_dir, task)
    os.makedirs(mdir, exist_ok=True)
    exp = tv_exp.MetricsExporter(interval_s=export_interval_s, dir=mdir)

    # the ROUTER anchors the run epoch once it sees the whole fleet's
    # exporters up; wait for its anchor, with a standalone fallback
    epoch_path = os.path.join(run_dir, "run-epoch.json")
    wait_until = _time.time() + 60.0
    while not os.path.exists(epoch_path) and _time.time() < wait_until:
        elastic.heartbeat(0)
        _time.sleep(0.05)
    epoch = run_epoch(run_dir)

    done = completed_ids_all(run_dir)
    inbox = inbox_path(run_dir, task)
    open(inbox, "a").close()         # the router may not have written yet
    log_path = os.path.join(run_dir, f"served-{task}.jsonl")

    served = 0
    step = 0
    retries = 0
    eof = False
    submitted: set = set()
    reroute_ids: set = set()
    print(f"[gen {gen} route-serve-{task}] up, {len(done)} in "
          f"completion union", flush=True)

    def _log_finished(log, finished):
        nonlocal served
        ledger = goodput.active_ledger()
        for rec in finished:
            if rec["id"].startswith("warmup-"):
                continue
            log.write(json.dumps({
                "id": rec["id"], "tokens": rec["tokens"],
                "prompt_tokens": rec["prompt_tokens"],
                "latency_s": round(rec["latency_s"], 6),
                "tenant": rec.get("tenant"),
                "pclass": rec.get("pclass"),
                "reroute": rec["id"] in reroute_ids,
                "gen": gen}) + "\n")
            served += 1
            if rec["id"] in reroute_ids:
                # duplicate/recovery work: the whole re-served request
                # prices into the reroute_replay badput bucket
                nt = len(rec["tokens"])
                tv_events.event("serve.rerouted", id=rec["id"],
                                tenant=rec.get("tenant"),
                                new_tokens=nt)
                if ledger is not None:
                    ledger.tokens(0, rerouted=nt)
        if finished:
            _publish_launches(run_dir, task, gen, warm)

    with open(log_path, "a", buffering=1) as log, open(inbox) as inb:
        while True:
            elastic.heartbeat(step)
            progressed = False
            for line in _read_complete_lines(inb):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("eof"):
                    eof = True
                    continue
                rid = rec.get("id")
                if rid is None or rid in submitted or rid in done:
                    continue
                submitted.add(rid)
                if rec.get("reroute"):
                    reroute_ids.add(rid)
                r = request_from_wire(rec)
                # backdate to the TRUE arrival: routing hops and
                # re-routes cannot reset the client's latency clock
                engine.submit(r, arrival_wall=epoch + r.arrival_s)
                progressed = True
            mode = elastic.drain_mode()
            if mode is not None:
                while not engine.scheduler.idle:
                    elastic.heartbeat(step)
                    try:
                        _log_finished(log, engine.step())
                    except FaultInjected:
                        retries += 1
                        if retries > max_retries:
                            raise
                tv_events.event("serve.drain", task=task, mode=mode,
                                completed=served, requeued=0)
                break
            if not engine.scheduler.idle:
                if step_delay_s:
                    _time.sleep(step_delay_s)
                try:
                    _log_finished(log, engine.step())
                except FaultInjected:
                    retries += 1
                    if retries > max_retries:
                        raise
                step += 1
            elif eof:
                break
            elif not progressed:
                _time.sleep(0.01)        # inbox quiet, engine idle

    elastic.heartbeat(step)
    tv_events.event("serve.alloc_check", task=task,
                    **engine.block_accounting())
    exp.stop()
    _publish_launches(run_dir, task, gen, warm)
    print(f"[gen {gen} route-serve-{task}] served {served} this "
          f"generation ({retries} injected-fault retries)", flush=True)
    goodput.activate(None)
    if tdir:
        tv_events.shutdown()
    return task, served, len(done) + served

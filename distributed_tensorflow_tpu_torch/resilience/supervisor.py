"""Recovery supervisor: detect worker failure → reform → resume.

The piece that turns the detection stack (chaos injection, RetryPolicy,
WorkerHealthTracker, checkpoint integrity, StallDetector, structured
telemetry) into an actual fault-tolerance story: a controlling process
that runs a multi-worker training job, watches it, and — when a worker
dies, is preempted, or stalls — executes a bounded recovery instead of
letting the run end (≙ Elastic Horovod's controller / the reference
failure-handling module's restart-the-job contract, closed-loop).

The port's copy of ``distributed_tensorflow_tpu/resilience/
supervisor.py``: the same protocol, events, kill and shrink plans and
decisions, over the port's spawn runner. Tasks are torch processes; a
chief or worker task's card is its ``LOCAL_RANK`` (``device="cuda"``,
the default, in place of JAX's ``devices_per_process``: one card a
task), and ``device="cpu"`` runs them on the CPU.

The recovery protocol, per failure:

1. **Detect.** Poll task exit codes (SIGKILL → negative signal code,
   preemption → :data:`~distributed_tensorflow_tpu_torch.checkpoint.
   failure_handling.EXIT_PREEMPTED`, crash → anything else) and, when
   configured, per-task heartbeat staleness (stall — the supervisor-side
   complement of the in-process StallDetector).
2. **Kill stragglers.** Survivors of a dead peer are typically wedged
   in a collective or barrier against it; they are SIGKILLed rather
   than waited out.
3. **Reform.** The cluster *generation id* is incremented and every
   task is respawned (``multi_process_runner.MultiProcessRunner.reform``:
   per-worker restart under a fresh cluster spec — fresh
   coordination-service ports) with ``DTX_CLUSTER_GENERATION`` bumped,
   so the new incarnation's KV keys and barriers live in a fresh
   namespace (cluster/elastic.py).
4. **Resume.** Restarted workers restore down the recovery ladder —
   own host snapshot > peer replica (checkpoint/peer_snapshot.py) >
   local disk > durable disk (``CheckpointManager.restore_latest``;
   torn checkpoints are already skipped) — and re-enter their step
   loop. Restart pacing follows a :class:`RetryPolicy` backoff; the
   restart budget is bounded, and exhaustion raises
   :class:`RecoveryFailedError` carrying the (bounded) failure history.
5. **Shrink** (optional, ``shrink_after``): when the SAME task slot has
   failed that many consecutive restarts, the machine is treated as
   gone for good — the cluster reforms at N-1 workers
   (``recovery.reshard`` event) and the topology-elastic restore
   stitches the N-worker checkpoint onto the smaller cluster instead
   of burning the remaining budget re-spawning into the hole.

The supervisor also owns each worker machine's *memdir* (the stand-in
for node RAM holding host/peer snapshots, ``cluster.elastic.
peer_memdir``): a slot whose failure means machine death (SIGKILL,
preemption) gets its memdir wiped; a stall or in-process crash keeps
it, so the respawned worker restores from its own host tier.

Every transition emits ``recovery.*`` telemetry events (plus a
``recovery.recover`` span around each reform), written both to the
supervisor's own ``events-supervisor.jsonl`` under ``telemetry_dir``
and to the process-wide event log when one is configured —
``tools/obs_report.py`` renders them as a recovery timeline.

Chaos: ``kill_plan`` schedules seed-driven SIGKILLs through the
supervisor itself (fired when the victim's heartbeat reaches a target
step), which is how ``tools/chaos_sweep.py --kill`` and the elastic
end-to-end tests drive worker death deterministically.

Beyond failure recovery, the supervisor is also the fleet's *resource
actuator*: :meth:`RecoverySupervisor.request_scale`
resizes the job on purpose through the SAME reform machinery a failure
uses — drain (optional), generation bump, reform at the new size,
topology-elastic restore — without touching the restart budget. Scale
generations are recorded (``scale.applied`` events +
``scale_generations``) so the goodput ledger prices their reform gaps
into the ``scale_transition`` badput bucket instead of ``recovery``.
An ``autoscaler`` hook (resilience/autoscaler.py) is ticked from the
watch loop, closing SLO burn -> scale decision -> reform in one place;
scale actions serialize behind the reform lock, so a decision arriving
mid-recovery is deferred to the next healthy tick, never lost.
"""

from __future__ import annotations

import dataclasses
import os
import random
import tempfile
import threading
import time
from typing import Callable, Mapping, Sequence

from distributed_tensorflow_tpu_torch.cluster import elastic
from distributed_tensorflow_tpu_torch.resilience import heartbeats as _hb
from distributed_tensorflow_tpu_torch.resilience.health import WorkerHealthTracker
from distributed_tensorflow_tpu_torch.resilience.retry import Backoff, RetryPolicy
from distributed_tensorflow_tpu_torch.telemetry import events as _events
from distributed_tensorflow_tpu_torch.testing import multi_process_runner as mpr


@dataclasses.dataclass(frozen=True)
class WorkerFailure:
    """One detected failure (an entry of the recovery history)."""

    generation: int
    task: tuple[str, int]
    kind: str                     # "killed" | "preempted" | "crash" | "stall"
    exitcode: int | None = None
    wall: float = 0.0
    detail: str = ""

    def describe(self) -> str:
        code = "" if self.exitcode is None else f" exit={self.exitcode}"
        extra = f" ({self.detail})" if self.detail else ""
        return (f"gen{self.generation} {self.task[0]}:{self.task[1]} "
                f"{self.kind}{code}{extra}")


class RecoveryFailedError(RuntimeError):
    """The restart budget is exhausted (or recovery is disabled) and the
    job still cannot finish. Carries the full failure ``history`` so the
    operator sees every death that led here, not just the last."""

    def __init__(self, msg: str, history: Sequence[WorkerFailure]):
        super().__init__(msg)
        self.history: list[WorkerFailure] = list(history)


@dataclasses.dataclass(frozen=True)
class KillSpec:
    """One scheduled chaos kill: SIGKILL ``worker`` once its heartbeat
    reports a step >= ``after_step``. A ``permanent`` spec models a
    machine that is gone for good: it re-fires in EVERY generation
    (once per generation) until the supervisor's shrink policy removes
    the slot."""

    worker: int
    after_step: int
    permanent: bool = False


def seeded_kill_plan(seed: int, num_workers: int, *, kills: int = 1,
                     step_range: tuple[int, int] = (3, 12)) -> list[KillSpec]:
    """Deterministic kill schedule from a chaos seed (the
    resilience/faults.py seeding discipline: a string-seeded stream that
    is a pure function of the seed, stable across processes/runs)."""
    rng = random.Random(f"dtx-kill:{seed}")
    return [KillSpec(worker=rng.randrange(num_workers),
                     after_step=rng.randrange(*step_range))
            for _ in range(kills)]


def seeded_shrink_plan(seed: int, num_workers: int, *,
                       step_range: tuple[int, int] = (3, 12)
                       ) -> list[KillSpec]:
    """A permanent-loss schedule: one seed-chosen worker's machine dies
    for good (its kill re-fires every generation), forcing the
    supervisor down the shrink path — reform at N-1 with a resharded
    restore."""
    rng = random.Random(f"dtx-shrink:{seed}")
    return [KillSpec(worker=rng.randrange(num_workers),
                     after_step=rng.randrange(*step_range),
                     permanent=True)]


class RecoverySupervisor:
    """Run ``worker_fn`` as an elastic multi-worker job that survives
    worker death.

    ``worker_fn`` is one cluster task's whole life for one generation:
    it must be restartable — bootstrap from ``TF_CONFIG``, restore from
    the latest checkpoint, train, checkpoint periodically — and should
    call :func:`cluster.elastic.heartbeat` once per step so the
    supervisor can see progress (stall detection, step-targeted chaos
    kills). Spawn semantics are those of
    :class:`testing.multi_process_runner.MultiProcessRunner`: the fn
    must be module-level (picklable by reference).

    ::

        sup = RecoverySupervisor(worker_fn, num_workers=2,
                                 args=(ckpt_dir, total_steps),
                                 max_restarts=3,
                                 telemetry_dir=run_dir)
        result = sup.run()            # or raises RecoveryFailedError
        values = result.return_values # final generation's returns
    """

    def __init__(self, worker_fn: Callable, *,
                 num_workers: int = 2,
                 args: tuple = (), kwargs: dict | None = None,
                 env: Mapping[str, str] | None = None,
                 device="cuda",
                 max_restarts: int = 3,
                 retry_policy: RetryPolicy | None = None,
                 health: WorkerHealthTracker | None = None,
                 stall_timeout_s: float | None = None,
                 heartbeat_grace_s: float | None = None,
                 generation_timeout_s: float = 600.0,
                 poll_interval_s: float = 0.05,
                 kill_plan: Sequence[KillSpec] = (),
                 max_failure_history: int = 256,
                 shrink_after: int | None = None,
                 min_workers: int = 1,
                 max_workers: int | None = None,
                 telemetry_dir: str | None = None,
                 work_dir: str | None = None,
                 heartbeats=None,
                 runner_factory=None,
                 cluster_spec_fn=None,
                 kv_gc=None,
                 autoscaler=None,
                 drain_on_scale: bool = False,
                 drain_timeout_s: float = 15.0,
                 drain_scale_down_mode: str = "full"):
        """Knobs beyond the obvious:

        - ``stall_timeout_s`` — heartbeat *staleness* budget: a worker
          whose newest heartbeat is older than this is declared stalled
          (None disables supervisor-side stall detection).
        - ``heartbeat_grace_s`` — separate budget for a worker that has
          not heartbeat at all yet this generation (spawn + imports +
          first compile are much slower than a steady-state step);
          defaults to ``stall_timeout_s``. Both budgets are per
          construction — nothing is hard-coded inside the loop.
        - ``max_failure_history`` — cap on retained
          :class:`WorkerFailure` entries: a long flapping run keeps the
          NEWEST this-many failures (``failures_total`` still counts
          them all), so supervisor memory stays bounded.
        - ``shrink_after`` — the shrink policy: after this many
          consecutive failed restarts of the SAME task slot, stop
          re-spawning into the hole — reform at N-1 workers (never
          below ``min_workers``) and let the topology-elastic restore
          reshard the checkpoint onto the smaller cluster. ``None``
          disables shrinking (restart budget semantics unchanged).
        - ``heartbeats`` — the liveness transport, a
          :class:`resilience.heartbeats.HeartbeatSource`-shaped object
          (``read_all``/``clear``/``generation``). Default: the
          per-task heartbeat FILES under the supervisor scratch dir.
          ``ShardedKVHeartbeats`` swaps in per-shard summary keys over
          the coordination KV so the watch loop polls O(N/shard)
          keys instead of O(N) files — the fleet-scale detect path
          (bench.py --fleet measures detect latency vs N through it).
        - ``runner_factory`` / ``cluster_spec_fn`` — how generations
          are spawned: default the real spawn-process
          ``MultiProcessRunner`` + fresh-port cluster specs; the
          simulated-fleet harness (testing/fleet_sim.py) injects an
          in-process thread runner and a portless spec so hundreds of
          workers drive THIS loop unchanged.
        - ``kv_gc`` — a :class:`cluster.kv_gc.GenerationGC`: at every
          reform the supervisor notes the outgoing generation's last
          heartbeat (the GC's grace anchor) and the watch loop sweeps
          dead generations' KV namespaces once their grace window
          elapses (``recovery.kv_gc`` event per sweep).
        - ``autoscaler`` — an object with ``tick(supervisor)`` called
          once per watch tick while the generation is healthy
          (resilience/autoscaler.py: the SLO-burn policy engine or the
          shared-fleet capacity arbiter). Its decisions land through
          :meth:`request_scale`; a tick that raises degrades to a
          ``scale.error`` event, never kills the job.
        - ``max_workers`` — upper clamp for :meth:`request_scale`
          (``min_workers`` is the lower clamp, shared with the shrink
          policy). ``drain_on_scale`` — before a scale reform, write
          per-task drain flags (cluster/elastic.drain_path) and give
          the generation ``drain_timeout_s`` to exit on its own;
          serving replicas use it to finish in-flight sequences so a
          scale-down drops zero requests. ``drain_scale_down_mode``
          picks the flag written on scale-DOWN: ``full`` (finish
          everything admitted before exiting) or ``migrate`` (export
          live KV blocks to the handoff namespace and exit now — the
          successor generation adopts them with zero replayed decode
          steps; serving/replica.py ``_drain``). Scale-up always
          drains ``fast``: the capacity is wanted immediately.
        """
        self._fn = worker_fn
        self._num_workers = num_workers
        self._args = args
        self._kwargs = kwargs or {}
        self._env = dict(env or {})
        self._device = device
        self.max_restarts = max_restarts
        self._policy = retry_policy or RetryPolicy(
            max_attempts=max_restarts + 1, initial_backoff_s=0.2,
            backoff_multiplier=2.0, max_backoff_s=10.0)
        self.health = health or WorkerHealthTracker()
        self._stall_timeout_s = stall_timeout_s
        self._heartbeat_grace_s = (heartbeat_grace_s
                                   if heartbeat_grace_s is not None
                                   else stall_timeout_s)
        self._generation_timeout_s = generation_timeout_s
        self._poll_s = poll_interval_s
        # chaos kills as mutable records: permanent specs re-fire once
        # per generation until their slot is shrunk away
        self._kills: list[dict] = [{"spec": s, "fired_gen": None}
                                   for s in kill_plan]
        self.max_failure_history = max_failure_history
        self.shrink_after = shrink_after
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.autoscaler = autoscaler
        self._drain_on_scale = drain_on_scale
        self._drain_timeout_s = drain_timeout_s
        self._drain_scale_down_mode = drain_scale_down_mode
        #: serializes generation-replacing actions (failure recovery
        #: AND scale reforms): a scale request landing while a recovery
        #: holds this lock stays pending and is applied at the next
        #: healthy watch tick — deferred, never lost
        self._reform_lock = threading.RLock()
        self._scale_lock = threading.Lock()
        self._pending_scale: "tuple[int, str] | None" = None
        self._stop_requested = threading.Event()
        self.scales_applied = 0
        #: generations created by scale actions (not failures) — the
        #: goodput ledger prices their reform gaps as scale_transition
        self.scale_generations: set[int] = set()
        self._fail_streak: dict[int, int] = {}
        self._hb_seen: dict[int, int | None] = {}
        self._telemetry_dir = telemetry_dir
        self._dir = work_dir or tempfile.mkdtemp(prefix="dtx_supervisor_")
        os.makedirs(self._dir, exist_ok=True)
        self._hb = heartbeats or _hb.FileHeartbeatSource(self._dir)
        self._last_hbs: dict = {}
        self._runner_factory = runner_factory or mpr.MultiProcessRunner
        self._spec_fn = (cluster_spec_fn or
                         (lambda n: mpr.create_cluster_spec(num_workers=n)))
        self.kv_gc = kv_gc
        self._log: _events.EventLog | None = None
        if telemetry_dir:
            self._log = _events.EventLog(
                os.path.join(telemetry_dir, "events-supervisor.jsonl"),
                process_id="supervisor")
        self.history: list[WorkerFailure] = []
        self.failures_total = 0
        self.generation = 0
        self.restarts_used = 0
        self._runner: mpr.MultiProcessRunner | None = None
        self._exporter = None

    # -- live health export -----------------------------------------------
    def _health_lines(self) -> "list[str]":
        """Exporter extra lines: the fleet goodput/badput ledger (and,
        for serving jobs, SLO burn) recomputed from the run's event
        files on every export tick — the workers' logs are
        line-buffered, so this is the live fleet surface one scrape
        (or ``metrics-live.prom`` read) sees."""
        from distributed_tensorflow_tpu_torch.telemetry import (
            events as tv_events, goodput, slo as tv_slo)
        events_by_pid = tv_events.read_run(self._telemetry_dir)
        ledger = goodput.ledger_from_events(events_by_pid)
        lines = goodput.prometheus_lines(ledger)
        records = tv_slo.records_from_events(events_by_pid)
        if records:
            span = ((records[-1]["wall"] - records[0]["wall"])
                    if len(records) > 1 else 1.0)
            slos = tv_slo.default_serving_slos(
                windows=tv_slo.windows_for_span(max(span, 1e-3)))
            mon = tv_slo.SLOMonitor(slos)
            for r in records:
                mon.observe(r)
            lines += mon.prometheus_lines()
        return lines

    def _start_exporter(self):
        if self._telemetry_dir is None:
            return
        from distributed_tensorflow_tpu_torch.telemetry import exporter
        try:
            self._exporter = exporter.MetricsExporter(
                dir=self._telemetry_dir, interval_s=1.0,
                extra_fn=self._health_lines,
                labels={"job": "supervisor"})
        except OSError:
            self._exporter = None       # port taken: file export only
                                        # would also have failed — skip

    def _stop_exporter(self):
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    @property
    def num_workers(self) -> int:
        """Current cluster size (shrinks under the shrink policy)."""
        return self._num_workers

    # -- telemetry --------------------------------------------------------
    def _event(self, name: str, **fields):
        if self._log is not None:
            # recovery transitions are rare and each must survive a
            # supervisor crash: flush per event
            self._log.event(name, **fields)
            self._log.flush()
        else:
            # no supervisor file: fall back to the process-wide log (if
            # any) so in-process callers still see the transitions
            _events.event(name, **fields)

    # -- lifecycle --------------------------------------------------------
    def _child_env(self, generation: int) -> dict[str, str]:
        env = dict(self._env)
        env[elastic.ENV_GENERATION] = str(generation)
        env[elastic.ENV_SUPERVISOR_DIR] = self._dir
        if self._telemetry_dir:
            env.setdefault(_events.ENV_TELEMETRY_DIR, self._telemetry_dir)
        return env

    def replicas_ready(self) -> bool:
        """Whether every task of the current generation has heartbeated
        at least once, as the watch loop's latest tick read them: a
        reformed gang that is serving, not one that is only spawned (a
        replica heartbeats once its warm-up request is done). The
        capacity arbiter holds a scale action open until this holds."""
        hbs = self._last_hbs
        return all(hbs.get(i) is not None for i in range(self._num_workers))

    def _clear_heartbeats(self, clear_n: int | None = None):
        self._hb_seen: dict[int, int | None] = {}
        self._last_hbs: dict = {}
        self._hb.generation = self.generation
        # a scale-down leaves heartbeat files of removed slots behind —
        # clear the LARGER of the old/new sizes so they cannot read as
        # live workers later
        self._hb.clear(clear_n if clear_n is not None
                       else self._num_workers)

    @staticmethod
    def _classify(exitcode: int | None) -> str:
        if exitcode is None:
            return "stall"
        if exitcode < 0:
            import signal as _signal
            return ("killed" if -exitcode == _signal.SIGKILL
                    else "preempted" if -exitcode == _signal.SIGTERM
                    else "crash")
        # imported here: checkpoint/checkpoint.py imports this package
        # (resilience.faults), and failure_handling imports it back
        from distributed_tensorflow_tpu_torch.checkpoint.failure_handling \
            import EXIT_PREEMPTED
        if exitcode == EXIT_PREEMPTED:
            return "preempted"
        return "crash"

    # -- the loop ---------------------------------------------------------
    def run(self) -> mpr.MultiProcessRunnerResult:
        """Run the job to completion, recovering from failures within
        the restart budget. Returns the final generation's result;
        raises :class:`RecoveryFailedError` on budget exhaustion."""
        spec = self._spec_fn(self._num_workers)
        self._runner = self._runner_factory(
            self._fn, spec, args=self._args, kwargs=self._kwargs,
            env=self._child_env(0), device=self._device,
            timeout=self._generation_timeout_s)
        self._event("recovery.run_start", num_workers=self._num_workers,
                    max_restarts=self.max_restarts,
                    chaos_kills=len(self._kills))
        self._start_exporter()
        self._clear_heartbeats()
        self._runner.start()
        self._event("recovery.generation_start", generation=0)
        backoff = Backoff(self._policy)
        try:
            while True:
                failures = self._watch()
                if failures == "scale":
                    self._apply_scale()
                    continue
                if failures == "stop":
                    self._event("recovery.run_stopped",
                                generation=self.generation,
                                restarts=self.restarts_used)
                    self._runner.terminate_all()
                    return self._runner.join(timeout=30,
                                             raise_on_error=False)
                if failures is None:
                    result = self._runner.join(timeout=60,
                                               raise_on_error=False)
                    failures = self._result_failures(result)
                    if not failures:
                        for i in range(self._num_workers):
                            self.health.record_success(i)
                        self._event("recovery.run_complete",
                                    generation=self.generation,
                                    restarts=self.restarts_used)
                        return result
                self._recover(failures, backoff)
        finally:
            self._runner.terminate_all()
            self._stop_exporter()

    def _result_failures(self, result) -> list[WorkerFailure]:
        return [WorkerFailure(generation=self.generation, task=k,
                              kind=self._classify(t.exitcode),
                              exitcode=t.exitcode, wall=time.time(),
                              detail=(t.error or "")[-300:])
                for k, t in sorted(result.tasks.items())
                if t.exitcode != 0 or t.error is not None]

    def _watch(self) -> "list[WorkerFailure] | None | str":
        """Watch the current generation. Returns failures needing
        recovery, None when every task exited cleanly, ``"scale"``
        when a scale request is pending (the run loop applies it), or
        ``"stop"`` after :meth:`request_stop`.

        Heartbeats are read from the source ONCE per tick (``read_all``
        — for the sharded KV source that is O(N/shard) key reads) and
        the one batch feeds clock-sync telemetry, chaos-kill targeting
        and stall detection alike."""
        runner = self._runner
        t0 = time.monotonic()
        while True:
            exits = runner.poll()
            bad = {k: c for k, c in exits.items() if c != 0}
            if bad:
                return [WorkerFailure(
                    generation=self.generation, task=k,
                    kind=self._classify(c), exitcode=c, wall=time.time())
                    for k, c in sorted(bad.items())]
            if len(exits) == runner.num_tasks:
                return None
            hbs = self._hb.read_all(self._num_workers)
            self._last_hbs = hbs
            self._observe_heartbeats(hbs)
            self._fire_due_kills(exits, hbs)
            stalled = self._check_stall(exits, t0, hbs)
            if stalled is not None:
                return [stalled]
            if self._stop_requested.is_set():
                return "stop"
            if self.autoscaler is not None:
                # the closed loop: SLO burn / goodput -> decision ->
                # request_scale, all on this tick. A policy bug logs,
                # it never kills the supervised job.
                try:
                    self.autoscaler.tick(self)
                except Exception as e:       # noqa: BLE001
                    self._event("scale.error",
                                generation=self.generation,
                                error=repr(e)[:300])
            with self._scale_lock:
                pending = self._pending_scale
            if pending is not None:
                return "scale"
            if self.kv_gc is not None:
                swept = self.kv_gc.maybe_sweep(current_gen=self.generation)
                if swept:
                    self._event("recovery.kv_gc",
                                generation=self.generation, swept=swept)
            if time.monotonic() - t0 > self._generation_timeout_s:
                return [WorkerFailure(
                    generation=self.generation, task=("worker", -1),
                    kind="stall", wall=time.time(),
                    detail=f"generation exceeded "
                           f"{self._generation_timeout_s}s")]
            time.sleep(self._poll_s)

    def _observe_heartbeats(self, hbs):
        """Telemetry-only: record one ``clock.hb`` event per fresh
        worker heartbeat, pairing the worker's self-reported wall clock
        with the heartbeat's observation time (this process's clock
        domain — the file mtime for file heartbeats). These pairs are
        how the trace assembler
        (telemetry/trace.estimate_clock_offsets) aligns the
        supervisor's recovery timeline with the workers' step
        timelines. No-op without a telemetry log."""
        if self._log is None:
            return
        for i, hb in hbs.items():
            if (hb[1] is not None and hb[2] is not None
                    and hb[1] != self._hb_seen.get(i)):
                self._hb_seen[i] = hb[1]
                self._event("clock.hb", generation=self.generation,
                            worker=i, step=hb[1],
                            worker_wall=hb[2], mtime=hb[0])

    def _fire_due_kills(self, exits, hbs):
        for rec in list(self._kills):
            spec = rec["spec"]
            if rec["fired_gen"] is not None and (
                    not spec.permanent
                    or rec["fired_gen"] >= self.generation):
                continue                    # spent (or already fired
            if spec.worker >= self._num_workers:   # this generation)
                self._kills.remove(rec)     # slot shrunk away: retire
                continue
            if ("worker", spec.worker) in exits:
                continue                    # already down — keep waiting
            hb = hbs.get(spec.worker)
            if hb is None or hb[1] is None or hb[1] < spec.after_step:
                continue
            self._event("recovery.chaos_kill", generation=self.generation,
                        worker=spec.worker, after_step=spec.after_step,
                        at_step=hb[1], permanent=spec.permanent)
            self._runner.terminate("worker", spec.worker)
            rec["fired_gen"] = self.generation
            if not spec.permanent:
                self._kills.remove(rec)

    def _check_stall(self, exits, t0: float, hbs) -> WorkerFailure | None:
        if self._stall_timeout_s is None:
            return None
        now = time.time()
        # (overage, age, budget, worker): worst = largest budget overrun
        worst: tuple[float, float, float, int] | None = None
        for i in range(self._num_workers):
            if ("worker", i) in exits:
                continue                          # finished: not stalled
            hb = hbs.get(i)
            # before the first heartbeat, age from generation start
            # against the (typically larger) heartbeat_grace_s budget —
            # spawn + torch import + first kernel load are not a stall
            if hb is not None:
                age, budget = now - hb[0], self._stall_timeout_s
            else:
                age, budget = (time.monotonic() - t0,
                               self._heartbeat_grace_s)
            over = age - budget
            if worst is None or over > worst[0]:
                worst = (over, age, budget, i)
        if worst is not None and worst[0] > 0:
            return WorkerFailure(
                generation=self.generation, task=("worker", worst[3]),
                kind="stall", wall=now,
                detail=f"no heartbeat for {worst[1]:.3f}s "
                       f"(budget {worst[2]}s)")
        return None

    # -- elastic resizing (the resource-manager surface) ------------------
    def request_scale(self, num_workers: int, *,
                      reason: str = "scale") -> "int | None":
        """Ask for an elastic resize to ``num_workers`` (clamped to
        ``[min_workers, max_workers]``). Thread-safe and asynchronous:
        the watch loop applies it at its next healthy tick through the
        same generation-bump + reform machinery a failure recovery
        uses — behind the reform lock, so a request landing mid-recovery
        is deferred, never lost, and never consumes the restart budget.
        Returns the accepted (clamped) target, or None for a no-op."""
        target = max(self.min_workers, int(num_workers))
        if self.max_workers is not None:
            target = min(target, self.max_workers)
        with self._scale_lock:
            if target == self._num_workers and self._pending_scale is None:
                return None
            self._pending_scale = (target, reason)
        return target

    def request_stop(self) -> None:
        """Ask the run loop to end the job at its next watch tick
        (``recovery.run_stopped``): the shared-fleet supervisor uses it
        to wind the training job down once the serving workload is
        done. The returned result carries whatever each task had
        produced; no recovery is attempted."""
        self._stop_requested.set()

    def _drain_generation(self, mode: str = "fast") -> int:
        """Write per-task drain flags (``mode``: ``fast`` = finish
        running work only, ``full`` = finish everything admitted — see
        cluster/elastic.drain_mode) and give the running generation up
        to ``drain_timeout_s`` to exit on its own (serving replicas
        finish and log — zero dropped requests). Returns how many
        tasks exited before the deadline; stragglers are terminated by
        the caller."""
        n = self._num_workers
        for i in range(n):
            try:
                with open(elastic.drain_path(self._dir, i), "w") as f:
                    f.write(mode)
            except OSError:
                pass
        deadline = time.monotonic() + self._drain_timeout_s
        while time.monotonic() < deadline:
            exits = self._runner.poll()
            if len(exits) >= self._runner.num_tasks:
                break
            time.sleep(self._poll_s)
        return len(self._runner.poll())

    def _clear_drains(self, n: int):
        for i in range(n):
            try:
                os.unlink(elastic.drain_path(self._dir, i))
            except OSError:
                pass

    def _apply_scale(self):
        """Apply the pending scale request: (drain ->) terminate ->
        generation bump -> reform at the new size. The new generation
        is recorded in ``scale_generations`` and announced with a
        ``scale.applied`` event so the goodput ledger prices the gap
        as ``scale_transition``, not ``recovery``."""
        with self._scale_lock:
            pending, self._pending_scale = self._pending_scale, None
        if pending is None:
            return
        target, reason = pending
        with self._reform_lock:
            old_n = self._num_workers
            if target == old_n:
                return
            direction = "up" if target > old_n else "down"
            drained = 0
            if self._drain_on_scale:
                # scale-up wants the capacity NOW (queued work
                # re-shards); scale-down happens at low load, so
                # completing the admitted queue ("full") — or handing
                # live KV to the successor ("migrate", zero replay) —
                # keeps those requests off the respawn gap's tail
                drained = self._drain_generation(
                    self._drain_scale_down_mode
                    if direction == "down" else "fast")
            self._runner.terminate_all()
            if self.kv_gc is not None:
                hbs = self._hb.read_all(old_n)
                last = max((h[0] for h in hbs.values()),
                           default=time.time())
                self.kv_gc.note_generation_end(self.generation, last)
            self.generation += 1
            self.scale_generations.add(self.generation)
            self.scales_applied += 1
            if direction == "down":
                # removed slots: retire their exporter label series
                # (role change / repurposed machine — the ghost-series
                # dedup, exporter.retire_worker) and forget their fail
                # streaks; memdirs stay — the machine is donated, not
                # dead, and may come back on a scale-up
                for i in range(target, old_n):
                    if self._exporter is not None:
                        self._exporter.retire_worker(i)
                self._fail_streak = {w: s for w, s in
                                     self._fail_streak.items()
                                     if w < target}
            self._num_workers = target
            self._clear_heartbeats(clear_n=max(old_n, target))
            self._clear_drains(max(old_n, target))
            self._runner.reform(
                self._spec_fn(target),
                env=self._child_env(self.generation),
                allow_resize=True)
            # emitted AFTER the reform so the event's wall is the
            # instant the new capacity is actually spawning — the
            # honest end of the actuation latency chaos_sweep --spike
            # and bench --autoscale measure
            self._event("scale.applied", generation=self.generation,
                        from_workers=old_n, to_workers=target,
                        reason=reason, direction=direction,
                        drained=drained)
        self._event("recovery.generation_start",
                    generation=self.generation)

    #: failure kinds that mean the MACHINE behind the slot lost its
    #: memory (peer-snapshot memdir wiped): a SIGKILL stands in for
    #: node death and a preemption reclaims the VM. A stall or an
    #: in-process crash leaves the machine — and its memdir — alive.
    _MACHINE_LOST_KINDS = frozenset({"killed", "preempted"})

    def _record_failures(self, failures: list[WorkerFailure]):
        import shutil

        from distributed_tensorflow_tpu_torch.cluster import elastic
        failed_ids = set()
        # a machine lost this round broke the group: the others' crashes
        # are its collateral (gloo and NCCL raise on a dead peer at once,
        # where JAX's survivors hang until the straggler kill), and
        # count toward no shrink streak, or the policy would drop a live
        # slot tied with the dead one
        lost = any(f.kind in self._MACHINE_LOST_KINDS for f in failures)
        for f in failures:
            self.history.append(f)
            self.failures_total += 1
            self.health.record_failure(f.task[1])
            if f.task[1] >= 0 and not (lost and f.kind == "crash"):
                failed_ids.add(f.task[1])
                self._fail_streak[f.task[1]] = \
                    self._fail_streak.get(f.task[1], 0) + 1
            if f.kind in self._MACHINE_LOST_KINDS and f.task[1] >= 0:
                shutil.rmtree(
                    elastic.peer_memdir_path(self._dir, f.task[1]),
                    ignore_errors=True)
            self._event("recovery.worker_death", generation=f.generation,
                        task_type=f.task[0], task_id=f.task[1],
                        kind=f.kind, exitcode=f.exitcode, detail=f.detail)
        # bounded memory on flapping runs: keep only the newest entries
        if len(self.history) > self.max_failure_history:
            del self.history[:-self.max_failure_history]
        # a slot that did NOT fail this round broke its streak
        for wid in list(self._fail_streak):
            if wid not in failed_ids:
                self._fail_streak[wid] = 0

    def _maybe_shrink(self) -> int | None:
        """Apply the shrink policy; returns the removed task id (or
        None). The worst repeat offender's slot is dropped, higher slots
        renumber down, and their machines' memdirs follow them."""
        import shutil

        from distributed_tensorflow_tpu_torch.cluster import elastic
        if self.shrink_after is None or self._num_workers <= \
                self.min_workers:
            return None
        over = {w: n for w, n in self._fail_streak.items()
                if n >= self.shrink_after}
        if not over:
            return None
        removed = max(over, key=lambda w: (over[w], -w))
        shutil.rmtree(elastic.peer_memdir_path(self._dir, removed),
                      ignore_errors=True)
        for i in range(removed + 1, self._num_workers):
            src = elastic.peer_memdir_path(self._dir, i)
            dst = elastic.peer_memdir_path(self._dir, i - 1)
            shutil.rmtree(dst, ignore_errors=True)
            if os.path.isdir(src):
                os.replace(src, dst)
        self._fail_streak = {
            (w - 1 if w > removed else w): n
            for w, n in self._fail_streak.items() if w != removed}
        for rec in list(self._kills):       # chaos plan follows the
            w = rec["spec"].worker          # machines, not the slots
            if w == removed:
                self._kills.remove(rec)     # the dead machine is gone
            elif w > removed:
                rec["spec"] = dataclasses.replace(rec["spec"],
                                                  worker=w - 1)
        self._num_workers -= 1
        return removed

    def _recover(self, failures: list[WorkerFailure],
                 backoff: Backoff):
        """Bounded recovery: record → kill stragglers → (budget
        permitting) back off, bump the generation, maybe shrink,
        reform, un-quarantine the restarted lanes. Holds the reform
        lock end to end — a scale request arriving mid-recovery stays
        pending until the next healthy watch tick."""
        with self._reform_lock:
            self._recover_locked(failures, backoff)

    def _recover_locked(self, failures: list[WorkerFailure],
                        backoff: Backoff):
        self._record_failures(failures)
        # a stalled task is still alive; every straggler of the dead
        # generation gets killed before the namespace moves on
        for key in self._runner.alive_tasks():
            self._event("recovery.kill_straggler",
                        generation=self.generation,
                        task_type=key[0], task_id=key[1])
        self._runner.terminate_all()
        if self.restarts_used >= self.max_restarts:
            self._event("recovery.failed", generation=self.generation,
                        restarts=self.restarts_used,
                        failures=self.failures_total)
            raise RecoveryFailedError(
                f"restart budget exhausted ({self.restarts_used}/"
                f"{self.max_restarts} restarts used) after "
                f"{self.failures_total} failure(s): "
                + "; ".join(f.describe() for f in self.history[-5:]),
                self.history)
        self.restarts_used += 1
        delay = backoff.next_s()
        if self.kv_gc is not None:
            # anchor the dying generation's GC grace window on the last
            # heartbeat anyone in it produced (stragglers get the full
            # grace past this instant before their keys are swept)
            hbs = self._hb.read_all(self._num_workers)
            last = max((h[0] for h in hbs.values()),
                       default=time.time())
            self.kv_gc.note_generation_end(self.generation, last)
        self.generation += 1
        removed = self._maybe_shrink()
        if removed is not None:
            self._event("recovery.reshard", generation=self.generation,
                        removed_task=removed,
                        old_workers=self._num_workers + 1,
                        new_workers=self._num_workers,
                        streak=self.shrink_after)
        span_cm = (self._log.span if self._log is not None
                   else _events.span)
        with span_cm("recovery.recover", generation=self.generation,
                     restart=self.restarts_used, backoff_s=round(delay, 3)):
            if delay > 0:
                time.sleep(delay)
            self._clear_heartbeats()
            self._event("recovery.restart", generation=self.generation,
                        restart=self.restarts_used,
                        budget_left=self.max_restarts - self.restarts_used,
                        backoff_s=round(delay, 3),
                        num_workers=self._num_workers)
            self._runner.reform(
                self._spec_fn(self._num_workers),
                env=self._child_env(self.generation),
                allow_resize=removed is not None)
            for f in failures:
                if 0 <= f.task[1] < self._num_workers:
                    self.health.worker_restarted(f.task[1])
        self._event("recovery.generation_start",
                    generation=self.generation)   # also flushes the span

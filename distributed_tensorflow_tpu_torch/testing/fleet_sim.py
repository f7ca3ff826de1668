"""Simulated-fleet harness: hundreds of workers, one process, real code.

The port's copy of ``distributed_tensorflow_tpu/testing/fleet_sim.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

Every "at scale" claim of the control plane — elastic recovery
(resilience/supervisor.py), fleet-merged metrics (telemetry/
aggregate.py), barriers and KV liveness (cluster/coordination.py) — is
untestable on a 1-core container if testing it needs a process (let
alone a chip) per worker. This harness runs **N lightweight worker
loops as threads of one process**, all driving the *real* modules:

- the real :class:`~distributed_tensorflow_tpu_torch.cluster.coordination.
  _LocalService` is the shared KV/barrier backend (the same code the
  single-process production fallback runs); each simulated worker
  holds a :class:`SimAgent` — a real ``CoordinationServiceAgent``
  whose identity (pid, N) is simulated but whose every op goes through
  the production method bodies, generation namespacing, chaos sites
  and op counting included;
- the real :class:`~distributed_tensorflow_tpu_torch.resilience.supervisor.
  RecoverySupervisor` watch/recover/reform loop supervises the fleet —
  only its spawn primitive is swapped (:class:`SimRunner`, threads
  instead of processes) via the supervisor's injectable
  ``runner_factory``, plus the sharded-KV heartbeat source and the
  generation GC it already supports;
- the real tree-rollup path (telemetry/aggregate.py) aggregates every
  worker's metrics registry, and the real seeded chaos layer
  (resilience/faults.py, site ``fleet.step``) drives crash / stall /
  partition faults deterministically.

Worker death is cooperative: ``SimRunner.terminate`` marks the task
dead **immediately** (exit code ``-SIGKILL``, what the supervisor
sees) and flags the thread, which exits at its next step boundary —
until then it is exactly the straggler a real SIGKILL survivor's
in-flight RPCs are, which the generation namespace must (and does)
fence off.

What this cannot simulate: real network latency/loss, true process
isolation, per-host clocks, and the GIL serializes "parallel" steps —
absolute throughput numbers are lower bounds; *scaling shapes* (ops vs N, fan-in vs N,
detect latency vs N) are the product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import re
import tempfile
import threading
import time
import traceback
from typing import Callable

from distributed_tensorflow_tpu_torch.cluster import coordination, elastic, kv_gc
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.resilience import heartbeats as hb
from distributed_tensorflow_tpu_torch.resilience.retry import Backoff, RetryPolicy
from distributed_tensorflow_tpu_torch.resilience.supervisor import (
    RecoverySupervisor,
)
from distributed_tensorflow_tpu_torch.telemetry import aggregate
from distributed_tensorflow_tpu_torch.telemetry import registry as _registry
from distributed_tensorflow_tpu_torch.testing import multi_process_runner as mpr

_SIGKILL = 9

#: supervisor stall detail: "no heartbeat for X.Xs (budget Ys)"
_STALL_RE = re.compile(r"no heartbeat for ([0-9.]+)s \(budget ([0-9.]+)")

#: Per-task env var naming the failure domain (rack) the simulated
#: worker is placed in — the placement fact placement-aware layers
#: (peer-snapshot ring, data-service leases) consume.
ENV_FAILURE_DOMAIN = "DTX_FAILURE_DOMAIN"


class DomainTopology:
    """pid → failure domain (rack/host) mapping of a simulated fleet.

    Contiguous block placement — ``rack = pid // workers_per_domain`` —
    deliberately mirrors how real schedulers pack consecutive task ids
    onto the same rack, which is exactly the placement that makes the
    blind ``(pid - 1) % N`` replica ring lose data under a rack kill
    (adjacent pids share a domain, so an owner and its replicator die
    together). The last domain may be short when ``num_workers`` is not
    a multiple of ``workers_per_domain``.
    """

    def __init__(self, num_workers: int, *, workers_per_domain: int = 4,
                 prefix: str = "rack"):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if workers_per_domain < 1:
            raise ValueError(f"workers_per_domain must be >= 1, got "
                             f"{workers_per_domain}")
        self.num_workers = int(num_workers)
        self.workers_per_domain = int(workers_per_domain)
        self.prefix = prefix

    @property
    def num_domains(self) -> int:
        return -(-self.num_workers // self.workers_per_domain)

    def domain_of(self, pid: int) -> str:
        if not 0 <= pid < self.num_workers:
            raise ValueError(f"pid {pid} outside fleet of "
                             f"{self.num_workers}")
        return f"{self.prefix}{pid // self.workers_per_domain}"

    @property
    def domains(self) -> "list[str]":
        return [f"{self.prefix}{d}" for d in range(self.num_domains)]

    def members(self, domain: str) -> "list[int]":
        return [p for p in range(self.num_workers)
                if self.domain_of(p) == domain]

    def as_map(self) -> "dict[int, str]":
        """{pid: domain} — the wire/placement-policy shape
        (checkpoint/peer_snapshot.assign_replicators, the data-service
        dispatcher's ``domains=``)."""
        return {p: self.domain_of(p) for p in range(self.num_workers)}

    def shrink(self, num_workers: int) -> "DomainTopology":
        """The same placement over a resized fleet (elastic scale keeps
        machines where they are; slots beyond the new size vanish)."""
        return DomainTopology(num_workers,
                              workers_per_domain=self.workers_per_domain,
                              prefix=self.prefix)


@dataclasses.dataclass(frozen=True)
class DomainKill:
    """One correlated failure: every worker of ``domain`` dies at once,
    ``after_s`` seconds into the run."""

    domain: str
    victims: tuple
    after_s: float


class _SimKilled(BaseException):
    """Raised inside a worker thread whose task was terminated (it is a
    BaseException so no retry/except-Exception layer swallows it)."""


class SimAgent(coordination.CoordinationServiceAgent):
    """A real CoordinationServiceAgent with simulated identity.

    ``_client`` is pinned to None so every op takes the production
    in-process path against the SHARED ``_LocalService`` instance;
    ``process_id``/``num_processes`` come from the simulated cluster,
    which is what turns the agent's ``barrier`` into a true N-party
    barrier. ``partition()`` models a network partition: every KV op
    raises ``CoordinationError`` until ``heal()``.
    """

    def __init__(self, service: coordination._LocalService,
                 pid: int, num_workers: int):
        super().__init__()
        self._local = service
        self._pid = pid
        self._n = num_workers
        self._partitioned = threading.Event()

    @property
    def _client(self):
        return None

    @property
    def process_id(self) -> int:
        return self._pid

    @property
    def num_processes(self) -> int:
        return self._n

    # -- simulated partition ----------------------------------------------
    def partition(self):
        self._partitioned.set()

    def heal(self):
        self._partitioned.clear()

    @property
    def partitioned(self) -> bool:
        return self._partitioned.is_set()

    def _check_net(self):
        if self._partitioned.is_set():
            raise coordination.CoordinationError(
                f"simulated network partition: worker {self._pid} "
                f"cannot reach the coordination service")

    def key_value_set(self, *a, **k):
        self._check_net()
        return super().key_value_set(*a, **k)

    def key_value_get(self, *a, **k):
        self._check_net()
        return super().key_value_get(*a, **k)

    def key_value_try_get(self, *a, **k):
        self._check_net()
        return super().key_value_try_get(*a, **k)

    def key_value_dir_get(self, *a, **k):
        self._check_net()
        return super().key_value_dir_get(*a, **k)

    def key_value_delete(self, *a, **k):
        self._check_net()
        return super().key_value_delete(*a, **k)

    def key_value_increment(self, *a, **k):
        self._check_net()
        return super().key_value_increment(*a, **k)

    def barrier(self, *a, **k):
        self._check_net()
        return super().barrier(*a, **k)


def make_sim_cluster(num_workers: int,
                     service: "coordination._LocalService | None" = None
                     ) -> "list[SimAgent]":
    """N agents sharing one in-memory service — the smallest useful
    slice of the harness (direct barrier/KV tests)."""
    service = service or coordination._LocalService()
    return [SimAgent(service, p, num_workers) for p in range(num_workers)]


def sim_cluster_spec(n: int) -> dict:
    """Portless cluster spec for thread-backed runners (the
    ``cluster_spec_fn`` a supervisor over a :class:`SimRunner` wants —
    resizable, so autoscaler-driven scale reforms work unchanged)."""
    return {"worker": [f"sim://{i}" for i in range(n)]}


@dataclasses.dataclass
class SimTaskContext:
    """What a simulated worker fn receives instead of a process env."""

    pid: int
    num_workers: int
    env: dict
    agent: SimAgent
    _kill: threading.Event

    @property
    def generation(self) -> int:
        try:
            return int(self.env.get(elastic.ENV_GENERATION, "0"))
        except ValueError:
            return 0

    @property
    def domain(self) -> "str | None":
        """The failure domain (rack) this task is placed in, when the
        runner was given a :class:`DomainTopology`."""
        return self.env.get(ENV_FAILURE_DOMAIN)

    def check_kill(self):
        if self._kill.is_set():
            raise _SimKilled()

    def sleep(self, seconds: float):
        """Kill-interruptible sleep."""
        if self._kill.wait(seconds):
            raise _SimKilled()


class _SimTask:
    def __init__(self, key):
        self.key = key
        self.kill = threading.Event()
        self.thread: "threading.Thread | None" = None
        self.exitcode: "int | None" = None
        self.error: "str | None" = None
        self.value = None
        self.exit_wall: "float | None" = None
        self._lock = threading.Lock()

    def mark_exit(self, code: int, error: "str | None" = None,
                  value=None) -> bool:
        """First exit report wins (a terminate beats the zombie thread's
        own later completion)."""
        with self._lock:
            if self.exitcode is not None:
                return False
            self.exitcode = code
            self.error = error
            self.value = value
            self.exit_wall = time.time()
            return True


class SimRunner:
    """Thread-backed stand-in for testing.multi_process_runner.
    MultiProcessRunner — same interface the RecoverySupervisor drives
    (poll/alive_tasks/terminate/terminate_all/join/reform), tasks are
    daemon threads running ``fn(SimTaskContext, *args, **kwargs)``.
    """

    #: thread stack size for simulated workers (the loops are shallow;
    #: the default 8 MiB per thread is pointless at N=1000)
    STACK_BYTES = 512 * 1024

    def __init__(self, fn: Callable, cluster_spec, *, args=(),
                 kwargs=None, env=None, device=None,
                 devices_per_process=1,
                 timeout: float = 300.0, agent_factory=None,
                 on_generation=None,
                 topology: "DomainTopology | None" = None):
        del device, devices_per_process     # threads hold no card
        self._fn = fn
        self._spec = {k: list(v) for k, v in cluster_spec.items()}
        self._args = args
        self._kwargs = kwargs or {}
        self._env = dict(env or {})
        self._timeout = timeout
        self._agent_factory = agent_factory or (
            lambda pid, n: SimAgent(coordination._LocalService(), pid, n))
        self._on_generation = on_generation
        #: failure-domain placement of this generation's tasks; each
        #: task sees its own domain in ``env[ENV_FAILURE_DOMAIN]``
        self.topology = topology
        self._tasks: dict[tuple[str, int], _SimTask] = {}
        self._task_env: dict[tuple[str, int], dict] = {}
        self.history: list[mpr.TaskResult] = []
        #: every agent ever handed to a task (op-count accounting)
        self.agents: list[SimAgent] = []

    # -- lifecycle --------------------------------------------------------
    def _task_keys(self):
        return [(t, i) for t in sorted(self._spec)
                for i in range(len(self._spec[t]))]

    @property
    def num_tasks(self) -> int:
        return sum(len(v) for v in self._spec.values())

    def _spawn(self, key, env):
        task = _SimTask(key)
        n = self.num_tasks
        agent = self._agent_factory(key[1], n)
        self.agents.append(agent)
        env = dict(env)
        if self.topology is not None and key[1] < self.topology.num_workers:
            env[ENV_FAILURE_DOMAIN] = self.topology.domain_of(key[1])
        ctx = SimTaskContext(pid=key[1], num_workers=n, env=env,
                             agent=agent, _kill=task.kill)
        prev_stack = None
        with contextlib.suppress(ValueError, RuntimeError):
            prev_stack = threading.stack_size(self.STACK_BYTES)
        try:
            task.thread = threading.Thread(
                target=self._run_task, args=(task, ctx), daemon=True,
                name=f"sim-{key[0]}-{key[1]}")
            task.thread.start()
        finally:
            if prev_stack is not None:
                with contextlib.suppress(ValueError, RuntimeError):
                    threading.stack_size(prev_stack)
        self._tasks[key] = task
        self._task_env[key] = dict(env)

    def _run_task(self, task: _SimTask, ctx: SimTaskContext):
        try:
            value = self._fn(ctx, *self._args, **self._kwargs)
            task.mark_exit(0, value=value)
        except _SimKilled:
            pass                          # terminate() already marked it
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else \
                (0 if e.code is None else 1)
            task.mark_exit(code, error=None if code == 0
                           else f"SystemExit({e.code})")
        except BaseException:
            task.mark_exit(1, error=traceback.format_exc())

    def start(self):
        if self._on_generation is not None:
            self._on_generation(self._gen_of(self._env))
        for key in self._task_keys():
            self._spawn(key, self._env)
        return self

    @staticmethod
    def _gen_of(env) -> int:
        try:
            return int(env.get(elastic.ENV_GENERATION, "0"))
        except ValueError:
            return 0

    def reform(self, cluster_spec=None, *, env=None,
               allow_resize: bool = False):
        self.terminate_all()
        for key, t in self._tasks.items():
            self.history.append(mpr.TaskResult(
                task_type=key[0], task_id=key[1], exitcode=t.exitcode,
                value=t.value, error=t.error))
        if cluster_spec is not None:
            new = {k: list(v) for k, v in cluster_spec.items()}
            if not allow_resize and sorted(
                    (t, len(v)) for t, v in new.items()) != sorted(
                    (t, len(v)) for t, v in self._spec.items()):
                raise ValueError("reform must keep the cluster shape")
            self._spec = new
            if self.topology is not None:
                # elastic resize keeps machines where they are: the
                # same block placement over the new worker count
                self.topology = self.topology.shrink(
                    len(self._spec.get("worker", [])) or 1)
        self._tasks.clear()
        merged_env = dict(self._env)
        merged_env.update(env or {})
        self._env = merged_env
        if self._on_generation is not None:
            self._on_generation(self._gen_of(merged_env))
        for key in self._task_keys():
            self._spawn(key, merged_env)

    # -- the supervisor-facing surface ------------------------------------
    def poll(self) -> dict:
        return {k: t.exitcode for k, t in self._tasks.items()
                if t.exitcode is not None}

    def alive_tasks(self):
        return sorted(k for k, t in self._tasks.items()
                      if t.exitcode is None)

    def terminate(self, task_type: str, task_id: int):
        t = self._tasks[(task_type, task_id)]
        t.kill.set()
        t.mark_exit(-_SIGKILL)

    def terminate_domain(self, domain: str) -> "list[int]":
        """Correlated kill: every live worker placed in ``domain`` exits
        AT ONCE (all exits marked before any thread gets a chance to
        run — the supervisor observes one simultaneous multi-worker
        failure, not a cascade). Returns the task ids killed."""
        if self.topology is None:
            raise ValueError("terminate_domain needs a topology")
        killed = []
        for pid in self.topology.members(domain):
            t = self._tasks.get(("worker", pid))
            if t is not None and t.exitcode is None:
                t.kill.set()
                t.mark_exit(-_SIGKILL)
                killed.append(pid)
        return killed

    def terminate_all(self):
        for t in self._tasks.values():
            if t.exitcode is None:
                t.kill.set()
                t.mark_exit(-_SIGKILL)
            else:
                t.kill.set()              # reap any zombie thread

    def join(self, timeout: "float | None" = None,
             raise_on_error: bool = True) -> mpr.MultiProcessRunnerResult:
        deadline = time.monotonic() + (timeout or self._timeout)
        while any(t.exitcode is None for t in self._tasks.values()):
            if time.monotonic() > deadline:
                for t in self._tasks.values():
                    if t.exitcode is None:
                        t.kill.set()
                        t.mark_exit(-_SIGKILL)
                break
            time.sleep(0.01)
        results = {k: mpr.TaskResult(
            task_type=k[0], task_id=k[1], exitcode=t.exitcode,
            value=t.value, error=t.error)
            for k, t in self._tasks.items()}
        result = mpr.MultiProcessRunnerResult(results)
        if raise_on_error:
            bad = {k: t for k, t in results.items()
                   if t.error is not None or t.exitcode != 0}
            if bad:
                k = sorted(bad)[0]
                raise mpr.SubprocessError(
                    f"sim task {k} failed (exit {bad[k].exitcode}):\n"
                    f"{bad[k].error}", result)
        return result

    def shutdown(self, timeout: float = 5.0):
        """Reap every thread (tests must not leak zombies)."""
        self.terminate_all()
        deadline = time.monotonic() + timeout
        for t in self._tasks.values():
            if t.thread is not None:
                t.thread.join(max(0.0, deadline - time.monotonic()))

    def exit_wall(self, task_id: int) -> "float | None":
        t = self._tasks.get(("worker", task_id))
        return t.exit_wall if t is not None else None


# ---------------------------------------------------------------------------
# Seeded fault plans
# ---------------------------------------------------------------------------

def seeded_fleet_schedule(seed: int, num_workers: int, *,
                          kinds=("crash", "stall", "partition"),
                          step_range: "tuple[int, int]" = (3, 9),
                          stall_s: float = 2.0) -> faults.FaultSchedule:
    """A deterministic chaos schedule over the ``fleet.step`` site: one
    rule per kind, victim + step drawn from a string-seeded stream
    (the resilience/faults.py discipline — a pure function of the
    seed). ``stall_s`` must exceed the supervisor's staleness budget
    for the stall to be DETECTED rather than ridden out."""
    rng = random.Random(f"dtx-fleet:{seed}")
    rules = []
    for kind in kinds:
        victim = rng.randrange(num_workers)
        at = rng.randrange(*step_range)
        if kind == "crash":
            rules.append(faults.FaultRule(site="fleet.step",
                                          action="raise",
                                          tag=str(victim), hits=(at,)))
        elif kind == "stall":
            rules.append(faults.FaultRule(site="fleet.step",
                                          action="delay", delay_s=stall_s,
                                          tag=str(victim), hits=(at,)))
        elif kind == "partition":
            rules.append(faults.FaultRule(site="fleet.step",
                                          action="signal",
                                          tag=str(victim), hits=(at,)))
        else:
            raise ValueError(f"unknown fleet fault kind {kind!r}")
    return faults.FaultSchedule(rules=tuple(rules), seed=seed)


def seeded_domain_kill_plan(seed: int, topology: DomainTopology, *,
                            kills: int = 1,
                            after_range: "tuple[float, float]" = (0.5, 1.5),
                            eligible: "tuple | list | None" = None
                            ) -> "list[DomainKill]":
    """Seed-derived CORRELATED failures: each kill takes a whole
    failure domain down at once (a rack loses power: every worker in
    it exits together — the failure mode the placement policy exists
    for, which independent per-worker kill plans can never produce).
    Victim domains and kill instants are a pure function of the seed
    (the resilience/faults.py string-seeded discipline); ``eligible``
    restricts the candidate domains (e.g. racks that hold trainers)."""
    rng = random.Random(f"dtx-domain-kill:{seed}")
    cands = list(eligible) if eligible is not None else topology.domains
    if not cands:
        return []
    victims = rng.sample(cands, k=min(kills, len(cands)))
    return [DomainKill(domain=d,
                       victims=tuple(topology.members(d)),
                       after_s=round(rng.uniform(*after_range), 3))
            for d in victims]


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetReport:
    """What one FleetSim.run measured."""

    num_workers: int
    steps: int
    wall_s: float
    completed: bool
    generations: int
    restarts: int
    #: KV ops by every WORKER agent, total and by op type
    worker_ops_total: int = 0
    worker_ops_by_type: dict = dataclasses.field(default_factory=dict)
    #: the busiest single agent's ops (the tree root reducer — the
    #: fan-in bottleneck the flat scheme put on the coordinator)
    max_agent_ops: int = 0
    #: supervisor-side heartbeat reads (sharded: O(N/shard) per tick)
    supervisor_ops_total: int = 0
    ops_per_sec: float = 0.0
    ops_per_worker_per_step: float = 0.0
    max_agent_ops_per_step: float = 0.0
    #: per-collect staleness of worker snapshots at the tree root
    rollup_latency_s_mean: "float | None" = None
    rollup_latency_s_max: "float | None" = None
    rollup_collects: int = 0
    rollup_workers_seen: int = 0
    #: barrier wall span (first arrival -> last release), when measured
    barrier_span_s: "float | None" = None
    #: per-failure detection/recovery timings from supervisor events
    detections: list = dataclasses.field(default_factory=list)
    detect_s_max: "float | None" = None
    mttr_s_max: "float | None" = None
    faults_fired: list = dataclasses.field(default_factory=list)
    kv_keys_final: int = 0
    kv_waiters_woken: int = 0
    swept_generations: list = dataclasses.field(default_factory=list)
    failures: list = dataclasses.field(default_factory=list)
    #: autoscaler-style scale reforms applied mid-run (``scale_plan``)
    scales_applied: int = 0
    scale_generations: list = dataclasses.field(default_factory=list)
    final_workers: int = 0
    error: "str | None" = None

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row["detections"] = [dict(d) for d in self.detections]
        return row


class FleetSim:
    """One simulated fleet run: N worker loops under the real
    RecoverySupervisor, sharded heartbeats, tree rollups, seeded chaos
    and generation GC, measured end to end.

    Worker loop per step: chaos site -> heartbeat (sharded publisher)
    -> metrics count -> periodic snapshot publish + reducer duties ->
    optional full-fleet barrier -> paced sleep. Pid 0 additionally
    publishes the generation's ``fleet/config`` key, which every other
    worker blocks on at generation start (the realistic reform
    thundering-herd the per-key-wakeup KV fix and decorrelated retry
    jitter exist for).
    """

    def __init__(self, num_workers: int, *,
                 steps: int = 12,
                 step_s: float = 0.01,
                 publish_every: int = 2,
                 fanout: int = 16,
                 hb_shard_size: int = 32,
                 barrier_at_step: "int | None" = None,
                 barrier_timeout_s: float = 30.0,
                 fault_schedule: "faults.FaultSchedule | None" = None,
                 partition_steps: int = 2,
                 stall_timeout_s: float = 1.0,
                 heartbeat_grace_s: float = 20.0,
                 max_restarts: int = 4,
                 gc_grace_s: float = 0.5,
                 collect_interval_s: float = 0.1,
                 generation_timeout_s: float = 120.0,
                 telemetry_dir: "str | None" = None,
                 scale_plan: "tuple | list" = (),
                 seed: int = 0):
        self.num_workers = num_workers
        self.steps = steps
        self.step_s = step_s
        self.publish_every = publish_every
        self.tree = aggregate.RollupTopology(num_workers, fanout=fanout)
        self.hb_shard_size = hb_shard_size
        self.barrier_at_step = barrier_at_step
        self.barrier_timeout_s = barrier_timeout_s
        self.fault_schedule = fault_schedule
        self.partition_steps = partition_steps
        self.stall_timeout_s = stall_timeout_s
        self.heartbeat_grace_s = heartbeat_grace_s
        self.max_restarts = max_restarts
        self.gc_grace_s = gc_grace_s
        self.collect_interval_s = collect_interval_s
        self.generation_timeout_s = generation_timeout_s
        self.telemetry_dir = telemetry_dir
        #: simulated scale events: ``[(after_s, target), ...]`` —
        #: ``after_s`` seconds into the run, ``request_scale(target)``
        #: lands on the real supervisor (same reform path the
        #: autoscaler drives). Targets must stay <= the construction-
        #: time ``num_workers``: the rollup topology is sized once.
        self.scale_plan = list(scale_plan)
        self.seed = seed
        self.kv = coordination._LocalService()
        self.current_gen = 0
        self._runner: "SimRunner | None" = None
        self._barrier_walls: dict[int, tuple] = {}
        self._barrier_lock = threading.Lock()

    # -- worker side ------------------------------------------------------
    def _worker_main(self, ctx: SimTaskContext):
        gen = ctx.generation
        with elastic.generation_override(gen):
            reg = _registry.MetricsRegistry()
            steps_done = reg.counter("training/steps_completed",
                                     "simulated steps")
            pub = hb.ShardedHeartbeatPublisher(
                ctx.agent, pid=ctx.pid, num_workers=ctx.num_workers,
                shard_size=self.hb_shard_size)
            backoff = Backoff(RetryPolicy(
                initial_backoff_s=0.005, max_backoff_s=0.1,
                decorrelated=True, seed=hash((self.seed, gen, ctx.pid))))
            if ctx.pid == 0:
                ctx.agent.key_value_set("fleet/config", json.dumps(
                    {"generation": gen, "num_workers": ctx.num_workers}))
            else:
                self._await_config(ctx, backoff)
            partition_left = 0
            for step in range(1, self.steps + 1):
                ctx.check_kill()
                if partition_left > 0:
                    partition_left -= 1
                    if partition_left == 0:
                        ctx.agent.heal()
                    ctx.sleep(self.step_s)
                    continue
                # beat BEFORE the chaos site: a worker that stalls (or
                # crashes) mid-step has already reported this step, so
                # supervisor-side detection runs on heartbeat
                # STALENESS, never on the (much larger) first-beat
                # grace budget
                pub.beat(step)
                decision = faults.fire("fleet.step", tag=ctx.pid)
                if decision is not None and decision.action == "signal":
                    partition_left = self.partition_steps
                    ctx.agent.partition()
                    ctx.sleep(self.step_s)
                    continue
                steps_done.increment()
                if step % self.publish_every == 0:
                    aggregate.publish_snapshot(
                        ctx.agent, reg, process_id=ctx.pid, seq=step)
                    aggregate.run_duties(ctx.agent, self.tree, ctx.pid)
                if self.barrier_at_step is not None \
                        and step == self.barrier_at_step:
                    arrive = time.time()
                    ctx.agent.barrier(f"fleet/step-{step}",
                                      timeout_s=self.barrier_timeout_s)
                    with self._barrier_lock:
                        self._barrier_walls[ctx.pid] = (arrive,
                                                        time.time())
                ctx.sleep(self.step_s)
            # final snapshot so short runs are visible at the root
            aggregate.publish_snapshot(ctx.agent, reg,
                                       process_id=ctx.pid, seq=self.steps)
            aggregate.run_duties(ctx.agent, self.tree, ctx.pid)
            return ctx.pid

    def _await_config(self, ctx: SimTaskContext, backoff: Backoff,
                      total_timeout_s: float = 30.0):
        """Blocking-get the generation config with kill-interruptible
        short reads + decorrelated-jitter pacing (the retry shape a real
        worker uses against a briefly unreachable coordinator)."""
        deadline = time.monotonic() + total_timeout_s
        while True:
            ctx.check_kill()
            try:
                ctx.agent.key_value_get("fleet/config", timeout_s=0.3)
                return
            except coordination.CoordinationError:
                if time.monotonic() > deadline:
                    raise
                d = min(backoff.next_s(),
                        max(deadline - time.monotonic(), 0.0))
                if d > 0:
                    ctx.sleep(d)

    # -- supervisor plumbing ----------------------------------------------
    def _agent(self, pid: int, num_workers: int) -> SimAgent:
        return SimAgent(self.kv, pid, num_workers)

    def _runner_factory(self, fn, spec, **kw):
        kw.pop("agent_factory", None)
        self._runner = SimRunner(
            fn, spec, agent_factory=self._agent,
            on_generation=self._note_generation, **kw)
        return self._runner

    def _note_generation(self, gen: int):
        self.current_gen = gen

    @staticmethod
    def _spec_fn(n: int) -> dict:
        return {"worker": [f"sim://{i}" for i in range(n)]}

    # -- the run ----------------------------------------------------------
    def run(self) -> FleetReport:
        n = self.num_workers
        tdir = self.telemetry_dir or tempfile.mkdtemp(prefix="fleet_sim_")
        sup_agent = SimAgent(self.kv, n, n)      # off-fleet identity
        gc_agent = SimAgent(self.kv, n + 1, n)
        supervisor = RecoverySupervisor(
            self._worker_main, num_workers=n,
            max_restarts=self.max_restarts,
            retry_policy=RetryPolicy(
                max_attempts=self.max_restarts + 1,
                initial_backoff_s=0.02, backoff_multiplier=1.5,
                max_backoff_s=0.2),
            stall_timeout_s=self.stall_timeout_s,
            heartbeat_grace_s=self.heartbeat_grace_s,
            generation_timeout_s=self.generation_timeout_s,
            poll_interval_s=0.02,
            telemetry_dir=tdir,
            heartbeats=hb.ShardedKVHeartbeats(
                sup_agent, shard_size=self.hb_shard_size),
            runner_factory=self._runner_factory,
            cluster_spec_fn=self._spec_fn,
            kv_gc=kv_gc.GenerationGC(gc_agent, grace_s=self.gc_grace_s))
        # the supervisor auto-starts a metrics exporter when it has a
        # telemetry dir; that is live-health machinery, not control
        # plane — keep the sim's op accounting clean
        supervisor._start_exporter = lambda: None

        outcome: dict = {}

        def _drive():
            try:
                outcome["result"] = supervisor.run()
            except BaseException as e:          # noqa: BLE001
                outcome["error"] = e

        schedule_cm = (faults.inject(self.fault_schedule)
                       if self.fault_schedule is not None
                       else contextlib.nullcontext())
        lat_samples: list[float] = []
        collects = 0
        workers_seen = 0
        bad_targets = [tg for _, tg in self.scale_plan if tg > n]
        if bad_targets:
            raise ValueError(
                f"scale_plan targets {bad_targets} exceed the "
                f"construction-time fleet size {n} (the rollup "
                f"topology is sized once)")
        pending_scales = sorted(self.scale_plan)
        t0 = time.time()
        with schedule_cm as registry:
            sup_thread = threading.Thread(target=_drive, daemon=True,
                                          name="sim-supervisor")
            sup_thread.start()
            while sup_thread.is_alive():
                sup_thread.join(self.collect_interval_s)
                elapsed = time.time() - t0
                # simulated autoscaler: fire due scale events through
                # the REAL request_scale/reform path
                while pending_scales and elapsed >= pending_scales[0][0]:
                    _, target = pending_scales.pop(0)
                    supervisor.request_scale(target, reason="sim_scale")
                sample = self._collect_once(gc_agent)
                if sample is not None:
                    collects += 1
                    lat_samples.extend(sample[0])
                    workers_seen = max(workers_seen, sample[1])
            fired = (registry.events()
                     if registry is not None else [])
        wall = time.time() - t0
        if self._runner is not None:
            self._runner.shutdown()
        # settle sweep: propagate the workers' final partials to the
        # root deterministically (thread completion order otherwise
        # decides how much of the last tick reached it). Runs on its
        # own agent so worker op accounting stays clean; excluded from
        # the latency samples (post-run ages are not rollup latency).
        settle_agent = SimAgent(self.kv, n + 2, n)
        with elastic.generation_override(self.current_gen):
            for _ in range(self.tree.depth):
                for pid in range(n):
                    aggregate.run_duties(settle_agent, self.tree, pid)
        final = self._collect_once(gc_agent)
        if final is not None:
            workers_seen = max(workers_seen, final[1])

        report = FleetReport(
            num_workers=n, steps=self.steps, wall_s=round(wall, 3),
            completed="result" in outcome,
            generations=supervisor.generation + 1,
            restarts=supervisor.restarts_used,
            faults_fired=[{"site": s, "tag": t, "hit": h, "action": a}
                          for s, t, h, a, _ in fired],
            failures=[f.describe() for f in supervisor.history],
            error=(str(outcome.get("error"))
                   if "error" in outcome else None),
        )
        self._account_ops(report, sup_agent, gc_agent, wall)
        if lat_samples:
            report.rollup_latency_s_mean = round(
                sum(lat_samples) / len(lat_samples), 4)
            report.rollup_latency_s_max = round(max(lat_samples), 4)
        report.rollup_collects = collects
        report.rollup_workers_seen = workers_seen
        if self._barrier_walls:
            with self._barrier_lock:
                walls = dict(self._barrier_walls)
            report.barrier_span_s = round(
                max(w[1] for w in walls.values())
                - min(w[0] for w in walls.values()), 4)
        report.detections = self._detections(tdir)
        if report.detections:
            ds = [d["detect_s"] for d in report.detections
                  if d.get("detect_s") is not None]
            ms = [d["mttr_s"] for d in report.detections
                  if d.get("mttr_s") is not None]
            if ds:
                report.detect_s_max = round(max(ds), 4)
            if ms:
                report.mttr_s_max = round(max(ms), 4)
        report.kv_keys_final = self.kv.num_keys()
        report.kv_waiters_woken = self.kv.stats.get("waiters_woken", 0)
        report.swept_generations = list(supervisor.kv_gc.swept)
        report.scales_applied = supervisor.scales_applied
        report.scale_generations = sorted(supervisor.scale_generations)
        report.final_workers = supervisor.num_workers
        return report

    def _collect_once(self, agent) -> "tuple[list[float], int] | None":
        """Coordinator-side tree collect: ONE root read; returns
        (per-worker snapshot ages, workers covered)."""
        with elastic.generation_override(self.current_gen):
            rollup = aggregate.collect_rollup_tree(agent, self.tree)
        workers = rollup.get("workers") or {}
        if not workers:
            return None
        now = time.time()
        ages = [now - w["wall"] for w in workers.values()
                if isinstance(w.get("wall"), (int, float))]
        return ages, len(workers)

    def _account_ops(self, report: FleetReport, sup_agent, gc_agent,
                     wall: float):
        by_type: dict[str, int] = {}
        total = 0
        max_agent = 0
        runner = self._runner
        for agent in (runner.agents if runner is not None else []):
            ops = sum(agent.op_counts.values())
            total += ops
            max_agent = max(max_agent, ops)
            for op, cnt in agent.op_counts.items():
                by_type[op] = by_type.get(op, 0) + cnt
        report.worker_ops_total = total
        report.worker_ops_by_type = dict(sorted(by_type.items()))
        report.max_agent_ops = max_agent
        report.supervisor_ops_total = (
            sum(sup_agent.op_counts.values())
            + sum(gc_agent.op_counts.values()))
        denom = max(self.num_workers * self.steps, 1)
        report.ops_per_worker_per_step = round(total / denom, 3)
        report.max_agent_ops_per_step = round(
            max_agent / max(self.steps, 1), 3)
        report.ops_per_sec = round(
            (total + report.supervisor_ops_total) / max(wall, 1e-6), 1)

    def _detections(self, tdir: str) -> "list[dict]":
        """Pair each ``recovery.worker_death`` with the task's actual
        exit instant (detect latency) and the next generation start
        (MTTR) from the supervisor's event log."""
        path = os.path.join(tdir, "events-supervisor.jsonl")
        events = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            return []
        runner = self._runner
        out = []
        for i, ev in enumerate(events):
            if ev.get("ev") != "recovery.worker_death":
                continue
            death_wall = ev.get("wall")
            task_id = ev.get("task_id")
            rec = {"kind": ev.get("kind"), "task_id": task_id,
                   "generation": ev.get("generation"),
                   "detect_s": None, "mttr_s": None}
            exit_wall = (runner.exit_wall(task_id)
                         if runner is not None and task_id is not None
                         and task_id >= 0 else None)
            if exit_wall is not None and death_wall is not None \
                    and ev.get("kind") != "stall":
                rec["detect_s"] = round(max(0.0, death_wall - exit_wall),
                                        4)
            elif ev.get("kind") == "stall" and ev.get("detail"):
                # "no heartbeat for X.Xs (budget Ys)": the overage past
                # the budget is the pure detection overhead
                m = _STALL_RE.search(ev["detail"])
                if m:
                    rec["detect_s"] = round(
                        max(0.0, float(m.group(1)) - float(m.group(2))),
                        4)
            if death_wall is not None:
                for later in events[i + 1:]:
                    if later.get("ev") == "recovery.generation_start" \
                            and later.get("wall") is not None:
                        rec["mttr_s"] = round(
                            later["wall"] - death_wall, 4)
                        break
            out.append(rec)
        return out


# ---------------------------------------------------------------------------
# Disaggregated data service: simulated input-worker fleet
# ---------------------------------------------------------------------------

def seeded_data_kill_schedule(seed: int, num_workers: int, *,
                              kills: int = 1,
                              attempt_range: "tuple[int, int]" = (1, 4)
                              ) -> faults.FaultSchedule:
    """Seed-derived input-worker deaths on the ``data.worker_step``
    site: each kill picks a victim and the split-processing ATTEMPT it
    dies on (per-tag hit counter — attempt 1 means the worker dies
    holding a lease it never completed). A pure function of the seed
    (the resilience/faults.py discipline)."""
    rng = random.Random(f"dtx-data-kill:{seed}")
    victims = rng.sample(range(num_workers),
                         k=min(kills, num_workers))
    rules = []
    for victim in victims:
        at = rng.randrange(*attempt_range)
        rules.append(faults.FaultRule(site="data.worker_step",
                                      action="raise",
                                      tag=str(victim), hits=(at,)))
    return faults.FaultSchedule(rules=tuple(rules), seed=seed)


@dataclasses.dataclass
class DataFleetReport:
    """What one DataServiceSim.run measured (the throughput rows and
    the chaos/property-test observables)."""

    num_workers: int
    num_splits: int
    epochs: int
    wall_s: float
    completed: bool
    #: exactly-once accounting, per epoch: the consumed multiset vs
    #: the expected one
    elements_delivered: int = 0
    expected_elements: int = 0
    duplicate_elements: int = 0
    missing_elements: int = 0
    #: per-epoch sorted element multisets (the property test's object)
    epoch_multisets: list = dataclasses.field(default_factory=list)
    splits_reassigned: int = 0
    workers_died: list = dataclasses.field(default_factory=list)
    elements_per_sec: float = 0.0
    fetch_wait_s: float = 0.0
    splits_per_worker: dict = dataclasses.field(default_factory=dict)
    rollup_workers_seen: int = 0
    rollup_splits_processed: "int | None" = None
    faults_fired: list = dataclasses.field(default_factory=list)
    error: "str | None" = None

    def to_row(self) -> dict:
        row = dataclasses.asdict(self)
        row.pop("epoch_multisets", None)      # big; not a bench field
        return row


class DataServiceSim:
    """N simulated input workers + the real dispatcher/worker/client
    code (input/data_service.py) over one in-memory KV.

    Worker threads run the REAL :class:`~distributed_tensorflow_tpu_torch.
    input.data_service.DataInputWorker` loop; a seeded ``raise`` on
    ``data.worker_step`` kills the thread mid-epoch (its heartbeats
    stop, exactly like a SIGKILL'd input-worker process), and the real
    dispatcher must re-issue the dead worker's leases to survivors.
    The consumer thread drains every epoch through the real
    :class:`DataServiceClient` and the report carries the exactly-once
    accounting (duplicates / missing vs the expected multiset), the
    reassignment count, and per-worker split throughput rolled up
    through the tree topology (each worker publishes its own
    metrics registry; the root rollup is collected once at the end).

    ``elements_per_split`` elements are synthesized per FILE split;
    ``work_s`` sleeps that long per split (GIL-releasing — models the
    decode/IO the disaggregation exists to offload).
    """

    def __init__(self, num_workers: int, num_splits: int, *,
                 epochs: int = 1, elements_per_split: int = 4,
                 work_s: float = 0.0, lease_timeout_s: float = 0.5,
                 poll_interval_s: float = 0.01,
                 fault_schedule: "faults.FaultSchedule | None" = None,
                 generation: int = 0, fanout: int = 16,
                 hb_shard_size: int = 32, seed: int = 0,
                 consumer_batch: int = 0,
                 consumer_step_s: float = 0.0,
                 timeout_s: float = 60.0,
                 topology: "DomainTopology | None" = None):
        self.topology = topology
        self.num_workers = num_workers
        self.num_splits = num_splits
        self.epochs = epochs
        self.elements_per_split = elements_per_split
        self.work_s = work_s
        #: trainer-shaped consumer pacing: every ``consumer_batch``
        #: elements cost one ``consumer_step_s`` "train step" (0 =
        #: drain flat out). fetch_wait_s / wall_s is then exactly the
        #: run's infeed-wait fraction — the bench's host-boundedness
        #: observable.
        self.consumer_batch = consumer_batch
        self.consumer_step_s = consumer_step_s
        self.fault_schedule = fault_schedule
        self.generation = generation
        self.tree = aggregate.RollupTopology(num_workers, fanout=fanout)
        self.seed = seed
        self.timeout_s = timeout_s
        self.kv = coordination._LocalService()
        from distributed_tensorflow_tpu_torch.input import data_service as _ds
        from distributed_tensorflow_tpu_torch.input.dataset import Dataset
        from distributed_tensorflow_tpu_torch.input.split_provider import (
            SplitProvider,
        )
        self._ds = _ds
        self.cfg = _ds.DataServiceConfig(
            job=f"sim{seed}", lease_timeout_s=lease_timeout_s,
            poll_interval_s=poll_interval_s,
            hb_shard_size=hb_shard_size, fetch_timeout_s=timeout_s)
        work = self.work_s

        def reader(path):
            idx = int(path.rsplit(":", 1)[1])
            if work:
                time.sleep(work)           # the offloaded decode/IO
            for j in range(self.elements_per_split):
                yield idx * 1_000_000 + j

        files = [f"sim://split:{i}" for i in range(num_splits)]
        self.provider = SplitProvider(
            files, lambda subset: Dataset.from_files(subset, reader),
            seed=seed)

    def expected_multiset(self) -> "list[int]":
        return sorted(s * 1_000_000 + j
                      for s in range(self.num_splits)
                      for j in range(self.elements_per_split))

    def _agent(self, pid: int) -> SimAgent:
        return SimAgent(self.kv, pid, self.num_workers)

    def run(self) -> DataFleetReport:
        n = self.num_workers
        report = DataFleetReport(
            num_workers=n, num_splits=self.num_splits,
            epochs=self.epochs, wall_s=0.0, completed=False,
            expected_elements=(self.num_splits
                               * self.elements_per_split * self.epochs))
        regs = [_registry.MetricsRegistry() for _ in range(n)]
        workers = []
        stop = threading.Event()
        died: dict[int, str] = {}
        died_lock = threading.Lock()

        def worker_main(wid: int):
            with elastic.generation_override(self.generation):
                iw = self._ds.DataInputWorker(
                    self._agent(wid), self.provider, self.cfg,
                    worker_id=wid, num_workers=n, epochs=self.epochs,
                    reg=regs[wid])
                workers.append(iw)
                beats = [0]
                orig_beat = iw.pub.beat

                def beat_and_publish(step):
                    orig_beat(step)
                    beats[0] += 1
                    if beats[0] % 5 == 0:
                        aggregate.publish_snapshot(
                            iw.agent, regs[wid], process_id=wid,
                            seq=beats[0])
                        aggregate.run_duties(iw.agent, self.tree, wid)
                iw.pub.beat = beat_and_publish
                try:
                    iw.run(stop)
                    # final partial so short runs reach the root
                    aggregate.publish_snapshot(iw.agent, regs[wid],
                                               process_id=wid,
                                               seq=beats[0] + 1)
                    aggregate.run_duties(iw.agent, self.tree, wid)
                except faults.FaultInjected as e:
                    with died_lock:
                        died[wid] = str(e)
                except coordination.CoordinationError:
                    with died_lock:
                        died[wid] = "coordination error"

        disp_holder: dict = {}

        def dispatcher_main():
            with elastic.generation_override(self.generation):
                disp = self._ds.DataServiceDispatcher(
                    self._agent(n), self.provider, self.cfg,
                    num_workers=n, epochs=self.epochs,
                    domains=(self.topology.as_map()
                             if self.topology is not None else None))
                disp_holder["disp"] = disp
                while not stop.is_set():
                    try:
                        if not disp.tick():
                            return
                    except faults.FaultInjected:
                        pass            # injected dispatch failure:
                    time.sleep(self.cfg.poll_interval_s)  # next tick

        schedule_cm = (faults.inject(self.fault_schedule)
                       if self.fault_schedule is not None
                       else contextlib.nullcontext())
        t0 = time.time()
        with schedule_cm as registry:
            threads = [threading.Thread(target=worker_main, args=(w,),
                                        daemon=True,
                                        name=f"data-worker-{w}")
                       for w in range(n)]
            dt_thread = threading.Thread(target=dispatcher_main,
                                         daemon=True,
                                         name="data-dispatcher")
            for t in threads:
                t.start()
            dt_thread.start()
            client = None
            try:
                with elastic.generation_override(self.generation):
                    client = self._ds.DataServiceClient(
                        self._agent(n + 1), self.cfg)
                    for e in range(self.epochs):
                        got = []
                        in_batch = 0
                        for el in client.epoch(e):
                            got.append(el)
                            in_batch += 1
                            if self.consumer_batch and \
                                    in_batch >= self.consumer_batch:
                                time.sleep(self.consumer_step_s)
                                in_batch = 0
                        report.epoch_multisets.append(sorted(got))
                    report.completed = True
            except Exception as exc:              # noqa: BLE001
                report.error = f"{type(exc).__name__}: {exc}"
            finally:
                with elastic.generation_override(self.generation):
                    self._ds.signal_shutdown(self._agent(n + 1),
                                             self.cfg)
                stop.set()
                for t in threads:
                    t.join(timeout=5.0)
                dt_thread.join(timeout=5.0)
            report.faults_fired = [
                {"site": s, "tag": t_, "hit": h, "action": a}
                for s, t_, h, a, _ in (registry.events()
                                       if registry is not None else [])]
        report.wall_s = round(time.time() - t0, 3)

        expected = self.expected_multiset()
        delivered = 0
        dup = miss = 0
        for got in report.epoch_multisets:
            delivered += len(got)
            from collections import Counter
            ce, cg = Counter(expected), Counter(got)
            dup += sum((cg - ce).values())
            miss += sum((ce - cg).values())
        report.elements_delivered = delivered
        report.duplicate_elements = dup
        report.missing_elements = miss
        if client is not None:
            report.fetch_wait_s = round(client.total_wait_s, 4)
        report.elements_per_sec = round(
            delivered / max(report.wall_s, 1e-6), 1)
        disp = disp_holder.get("disp")
        if disp is not None:
            report.splits_reassigned = disp.splits_reassigned
        report.workers_died = sorted(died)
        report.splits_per_worker = {
            iw.worker_id: iw.splits_processed for iw in workers}
        # settle sweep (the FleetSim discipline): propagate the final
        # partials to the root deterministically before collecting
        settle_agent = self._agent(n + 2)
        with elastic.generation_override(self.generation):
            for _ in range(self.tree.depth):
                for pid in range(n):
                    aggregate.run_duties(settle_agent, self.tree, pid)
            rollup = aggregate.collect_rollup_tree(settle_agent,
                                                   self.tree)
        workers_seen = rollup.get("workers") or {}
        report.rollup_workers_seen = len(workers_seen)
        splits_metric = (rollup.get("metrics") or {}).get(
            "data/splits_processed")
        if isinstance(splits_metric, dict) and \
                isinstance(splits_metric.get("sum"), (int, float)):
            report.rollup_splits_processed = int(splits_metric["sum"])
        return report

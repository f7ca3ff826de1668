"""Compressed production-day scenario over the simulated shared fleet.

The port's copy of ``distributed_tensorflow_tpu/testing/day_sim.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

The macro-scenario the per-subsystem sweeps cannot produce: ONE
supervisor-run fleet of serving replicas + elastic trainers driven
through a diurnal curve — night-rate serving over a batch-training
backfill, a morning interactive ramp (one trainer's capacity donated to
the day via the real ``request_scale`` path), peak, a flash spike past
fleet capacity, a whole-RACK loss at peak (``SimRunner.
terminate_domain`` — the correlated failure the placement policy
exists for), and the night-2 drain. Everything is the production code
under test:

- the real :class:`~distributed_tensorflow_tpu_torch.resilience.supervisor.
  RecoverySupervisor` watches/reforms (thread-backed :class:`~
  distributed_tensorflow_tpu_torch.testing.fleet_sim.SimRunner` underneath,
  with a :class:`~distributed_tensorflow_tpu_torch.testing.fleet_sim.
  DomainTopology` placing workers into racks);
- trainers snapshot + ring-replicate through the real
  ``checkpoint/peer_snapshot`` exchange — domain-spread
  (``assign_replicators`` with the rack map) or deliberately blind
  (``domain_spread=False``), which is how the warm-tier regression is
  demonstrated: a 2-trainer rack kill under the blind ring takes an
  owner AND its only replica, forcing a durable (cold) restore;
- every worker logs real telemetry events; the day is scored
  afterwards, purely from those logs, by ``telemetry/audit.py``.

Serving is queue-true rather than model-true: the driver generates
arrivals into one shared fleet queue; replicas admit up to their
capacity per tick and log each completion's true queueing delay + service
time as ``serve.request``. Load above fleet capacity (the spike) or a
reform outage (the rack loss: the WHOLE generation respawns) therefore
produces honest latency-tail violations at honest instants — which is
exactly what the audit's cause attribution is graded against. Admitted
requests are never dropped: the queue outlives worker incarnations and
a cooperative kill cannot interrupt the pop→log critical section.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import tempfile
import threading
import time

import numpy as np

from distributed_tensorflow_tpu_torch.checkpoint import peer_snapshot as ps
from distributed_tensorflow_tpu_torch.cluster import coordination, elastic
from distributed_tensorflow_tpu_torch.resilience.retry import RetryPolicy
from distributed_tensorflow_tpu_torch.resilience.supervisor import (
    RecoverySupervisor,
)
from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
from distributed_tensorflow_tpu_torch.testing import fleet_sim


@dataclasses.dataclass(frozen=True)
class DayPhase:
    """One segment of the diurnal curve."""

    name: str
    dur_s: float
    rate_rps: float
    #: elastic resize fired at phase start (None = keep)
    scale_to: "int | None" = None
    #: the seeded whole-rack kill lands inside this phase
    rack_kill: bool = False


def default_phases(*, compress: float = 1.0) -> "tuple[DayPhase, ...]":
    """The compressed day: ~6s of wall at ``compress=1``. Rates are
    sized against the default fleet's ~600 req/s serving capacity
    (4 replicas x 3/tick / 0.02s): the spike is the only segment past
    capacity, the rack loss rides peak-rate load."""
    c = compress
    return (
        DayPhase("night", 0.8 * c, 40.0),
        DayPhase("ramp", 0.8 * c, 150.0, scale_to=7),
        DayPhase("peak", 0.8 * c, 250.0),
        DayPhase("spike", 0.5 * c, 1400.0),
        # a second peak segment separates the spike's queue drain from
        # the rack kill, so the audit's two loudest causes
        # (spike_overload, recovery) are observably distinct
        DayPhase("peak_2", 1.2 * c, 250.0),
        DayPhase("rack_loss", 1.6 * c, 250.0, rack_kill=True),
        DayPhase("night_2", 0.8 * c, 40.0),
    )


class _PeerAgent(fleet_sim.SimAgent):
    """SimAgent that reports ``is_distributed`` from its simulated
    world size: the base class pins ``_client`` to None (every op takes
    the in-process service path), which ``CoordinationServiceAgent.
    is_distributed`` reads as single-process — correct for the fleet
    harness's own collectives but wrong here, where the trainer
    sub-world must run the REAL peer-snapshot exchange/negotiate
    collectives (both no-op on non-distributed agents)."""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


class DaySim:
    """One seeded compressed production day; ``run()`` returns the
    driver-side report, and ``logdir`` afterwards holds everything
    ``telemetry/audit.audit_day`` needs to score it.

    ``domain_spread=False`` keeps the fleet topology (and the
    correlated rack kill) but reverts the peer-snapshot ring to the
    blind ``(pid - 1) % N`` placement — the acceptance-criteria
    negative: the rack kill then takes an owner and its replica
    together and the restore falls through to the durable tier.
    """

    def __init__(self, *, seed: int = 0, logdir: "str | None" = None,
                 domain_spread: bool = True,
                 num_servers: int = 4, num_trainers: int = 4,
                 workers_per_domain: int = 2,
                 phases: "tuple | list | None" = None,
                 serve_tick_s: float = 0.02, server_capacity: int = 3,
                 service_s: float = 0.04,
                 train_step_s: float = 0.04, snap_every: int = 4,
                 exchange_timeout_s: float = 2.0,
                 max_restarts: int = 4,
                 drain_timeout_s: float = 15.0,
                 two_tenant: bool = False,
                 batch_frac: float = 0.25):
        if num_servers < 1 or num_trainers < 2:
            raise ValueError("need >=1 server and >=2 trainers")
        self.seed = seed
        self.logdir = logdir or tempfile.mkdtemp(prefix="day_sim_tel_")
        self.domain_spread = domain_spread
        self.num_servers = num_servers
        self.num_trainers = num_trainers
        self.workers_per_domain = workers_per_domain
        self.phases = tuple(phases) if phases is not None \
            else default_phases()
        self.serve_tick_s = serve_tick_s
        self.server_capacity = server_capacity
        self.service_s = service_s
        self.train_step_s = train_step_s
        self.snap_every = snap_every
        self.exchange_timeout_s = exchange_timeout_s
        self.max_restarts = max_restarts
        self.drain_timeout_s = drain_timeout_s
        self.kv = coordination._LocalService()
        self.topology = fleet_sim.DomainTopology(
            num_servers + num_trainers,
            workers_per_domain=workers_per_domain)
        self._runner: "fleet_sim.SimRunner | None" = None
        self._day_over = threading.Event()
        #: optional two-tenant serving stream: a seeded
        #: ``batch_frac`` share of arrivals belongs to the batch tenant
        #: and admits AFTER interactive each tick — the router
        #: frontend's batch-sheds-first policy on the diurnal curve.
        #: Batch therefore only queues behind interactive inside the
        #: already-attributed overload/recovery windows, so the audit's
        #: unattributed gate still holds.
        self.two_tenant = two_tenant
        self.batch_frac = batch_frac
        self._tenant_rng = random.Random(f"day-tenants:{seed}")
        #: the shared fleet admission queues: arrival wall stamps.
        #: Owned by the sim (not any worker incarnation), so a reform
        #: parks the backlog instead of dropping it. ``_queue_batch``
        #: stays empty unless ``two_tenant``.
        self._queue: "collections.deque[float]" = collections.deque()
        self._queue_batch: "collections.deque[float]" = \
            collections.deque()
        self._q_lock = threading.Lock()
        self._generated = 0
        self._completed = 0
        self._completed_batch = 0
        self._done_lock = threading.Lock()
        self._phase_name = "pre"

    # -- worker side ------------------------------------------------------
    def _worker_main(self, ctx: fleet_sim.SimTaskContext):
        gen = ctx.generation
        with elastic.generation_override(gen):
            log = tv_events.EventLog(
                tv_events.event_log_path(self.logdir, ctx.pid),
                process_id=ctx.pid)
            try:
                if ctx.pid < self.num_servers:
                    return self._server_loop(ctx, log)
                return self._trainer_loop(ctx, log)
            finally:
                log.close()

    def _server_loop(self, ctx, log):
        while not self._day_over.is_set():
            ctx.check_kill()
            tick_start = time.time()
            with self._q_lock:
                # interactive admits first; batch takes whatever
                # capacity is left this tick (the two-tenant day's
                # shed-first policy — a no-op pop when single-tenant)
                popped = [(self._queue.popleft(), "interactive")
                          for _ in range(min(self.server_capacity,
                                             len(self._queue)))]
                popped += [(self._queue_batch.popleft(), "batch")
                           for _ in range(
                               min(self.server_capacity - len(popped),
                                   len(self._queue_batch)))]
            now = time.time()
            n_batch = 0
            for arrival, kind in popped:
                # queueing delay + deterministic service time = the
                # honest completion latency; logged atomically with the
                # pop, so an admitted request is never lost to a kill
                lat = max(0.0, now - arrival) + self.service_s
                stamp = {}
                if self.two_tenant:
                    stamp["tenant"] = ("batchco" if kind == "batch"
                                       else "acme")
                    stamp["pclass"] = kind
                    n_batch += kind == "batch"
                log.event("serve.request", kind=kind,
                          dur_s=round(lat, 6),
                          ttft_s=round(0.5 * lat, 6),
                          new_tokens=32, replayed_tokens=0,
                          model_version="v1", error=False,
                          phase=self._phase_name, **stamp)
            with self._done_lock:
                self._completed += len(popped)
                self._completed_batch += n_batch
            ctx.sleep(self.serve_tick_s)
            log.event("serve.step",
                      dur_s=round(time.time() - tick_start, 6),
                      admitted=len(popped), phase=self._phase_name)
        return ctx.pid

    def _trainer_domains(self, world: int) -> "dict[int, str] | None":
        """Trainer-local {idx: rack} from the deterministic block
        placement (every incarnation recomputes the identical map — no
        coordination needed), or None when running the blind ring."""
        if not self.domain_spread:
            return None
        topo = fleet_sim.DomainTopology(
            self.num_servers + world,
            workers_per_domain=self.workers_per_domain)
        return {i: topo.domain_of(self.num_servers + i)
                for i in range(world)}

    def _trainer_loop(self, ctx, log):
        t_idx = ctx.pid - self.num_servers
        world = ctx.num_workers - self.num_servers
        agent = _PeerAgent(self.kv, t_idx, world)
        domains = self._trainer_domains(world)
        memdir = elastic.peer_memdir_path(
            ctx.env[elastic.ENV_SUPERVISOR_DIR], ctx.pid)
        store = ps.SnapshotStore(memdir, keep=2)
        store.load_surviving()
        step = 0
        if ctx.generation > 0:
            # collective restore decision for the reformed generation;
            # the cold durable fallback stands in for the real job's
            # disk checkpoint at step 0
            decision = ps.negotiate(
                store, agent, disk_best=(0, "cold://day-seed",
                                         "durable"),
                timeout_s=self.exchange_timeout_s * 4)
            if decision["source"] == "memory":
                ps.fetch_parts(store, agent, decision,
                               timeout_s=self.exchange_timeout_s * 4)
                tier = ("peer" if ps.any_fetched_remotely(store,
                                                          decision)
                        else "host")
                step = int(decision["step"])
            elif decision["source"] == "disk":
                tier = decision.get("tier", "durable")
                step = int(decision.get("step", 0))
            else:
                tier = "none"
            log.event("recovery.restore_tier", tier=tier, step=step,
                      source=decision["source"], t_idx=t_idx,
                      domain=ctx.domain)
        while not self._day_over.is_set():
            ctx.check_kill()
            t0 = time.time()
            ctx.sleep(self.train_step_s)
            step += 1
            log.event("train.step", step=step,
                      dur_s=round(time.time() - t0, 6),
                      phase=self._phase_name)
            if step % self.snap_every == 0:
                snap = ps.HostSnapshot(
                    owner=t_idx, step=step, world=world,
                    index={"day": True},
                    arrays={"w": np.full(4, float(step))})
                store.put(snap)
                ps.exchange(store, snap, agent,
                            timeout_s=self.exchange_timeout_s,
                            domains=domains)
        return ctx.pid

    # -- supervisor plumbing (the FleetSim injection pattern) -------------
    def _agent(self, pid: int, n: int) -> fleet_sim.SimAgent:
        return fleet_sim.SimAgent(self.kv, pid, n)

    def _runner_factory(self, fn, spec, **kw):
        kw.pop("agent_factory", None)
        self._runner = fleet_sim.SimRunner(
            fn, spec, agent_factory=self._agent,
            topology=self.topology, **kw)
        return self._runner

    # -- the day ----------------------------------------------------------
    def _eligible_racks(self) -> "list[str]":
        """Full trainer racks — the correlated-loss demo targets a rack
        whose loss removes BOTH of a (blind) owner/replicator pair."""
        topo = self._runner.topology
        out = []
        for d in topo.domains:
            members = topo.members(d)
            if members and min(members) >= self.num_servers and \
                    len(members) >= 2:
                out.append(d)
        return out

    def run(self) -> dict:
        n0 = self.num_servers + self.num_trainers
        work_dir = tempfile.mkdtemp(prefix="day_sim_work_")
        supervisor = RecoverySupervisor(
            self._worker_main, num_workers=n0,
            max_restarts=self.max_restarts,
            retry_policy=RetryPolicy(
                max_attempts=self.max_restarts + 1,
                initial_backoff_s=0.02, backoff_multiplier=1.5,
                max_backoff_s=0.2),
            stall_timeout_s=None,          # no heartbeats in this sim
            generation_timeout_s=300.0,
            poll_interval_s=0.02,
            telemetry_dir=self.logdir, work_dir=work_dir,
            min_workers=self.num_servers + 2,
            runner_factory=self._runner_factory,
            cluster_spec_fn=fleet_sim.sim_cluster_spec)
        supervisor._start_exporter = lambda: None
        outcome: dict = {}

        def _drive():
            try:
                outcome["result"] = supervisor.run()
            except BaseException as e:      # noqa: BLE001
                outcome["error"] = e

        driver = tv_events.EventLog(
            tv_events.event_log_path(self.logdir, "driver"),
            process_id="driver")
        driver.event("day.topology", seed=self.seed,
                     domain_spread=self.domain_spread,
                     num_servers=self.num_servers,
                     num_trainers=self.num_trainers,
                     domains={str(p): d for p, d in
                              self.topology.as_map().items()})
        kill_fired: "dict | None" = None
        t0 = time.time()
        sup_thread = threading.Thread(target=_drive, daemon=True,
                                      name="day-supervisor")
        sup_thread.start()
        try:
            for phase in self.phases:
                self._phase_name = phase.name
                driver.event("day.phase", phase=phase.name,
                             rate_rps=phase.rate_rps,
                             dur_s=phase.dur_s)
                if phase.scale_to is not None:
                    supervisor.request_scale(
                        phase.scale_to, reason=f"day_{phase.name}")
                kill_at = None
                if phase.rack_kill and self._runner is not None:
                    racks = self._eligible_racks()
                    plan = fleet_sim.seeded_domain_kill_plan(
                        self.seed, self._runner.topology, kills=1,
                        after_range=(0.25, 0.6),
                        eligible=racks or None)
                    if plan:
                        kill_at = (time.monotonic() + plan[0].after_s,
                                   plan[0].domain)
                deadline = time.monotonic() + phase.dur_s
                carry = 0.0
                last = time.monotonic()
                while time.monotonic() < deadline:
                    if not sup_thread.is_alive():
                        raise RuntimeError(
                            f"supervisor died mid-day: "
                            f"{outcome.get('error')}")
                    now = time.monotonic()
                    carry += phase.rate_rps * (now - last)
                    last = now
                    n = int(carry)
                    if n:
                        carry -= n
                        stamp = time.time()
                        n_batch = sum(
                            self._tenant_rng.random() < self.batch_frac
                            for _ in range(n)) if self.two_tenant \
                            else 0
                        with self._q_lock:
                            self._queue.extend(
                                [stamp] * (n - n_batch))
                            self._queue_batch.extend(
                                [stamp] * n_batch)
                        self._generated += n
                    if kill_at is not None and now >= kill_at[0]:
                        victims = self._runner.terminate_domain(
                            kill_at[1])
                        driver.event("day.rack_kill",
                                     domain=kill_at[1],
                                     victims=victims,
                                     phase=phase.name)
                        kill_fired = {"domain": kill_at[1],
                                      "victims": victims}
                        kill_at = None
                    time.sleep(0.005)
            # drain: the day is over when every admitted request has a
            # logged completion (dropped == 0 is a --check gate)
            self._phase_name = "drain"
            drain_deadline = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < drain_deadline:
                with self._done_lock:
                    done = self._completed
                if done >= self._generated:
                    break
                time.sleep(0.01)
        finally:
            driver.event("day.load", generated=self._generated,
                         completed=self._completed,
                         completed_batch=(self._completed_batch
                                          if self.two_tenant
                                          else None))
            driver.event("day.end")
            self._day_over.set()
            sup_thread.join(timeout=20.0)
            if sup_thread.is_alive():
                supervisor.request_stop()
                sup_thread.join(timeout=10.0)
            if self._runner is not None:
                self._runner.shutdown()
            driver.close()
        wall = time.time() - t0
        return {
            "seed": self.seed,
            "domain_spread": self.domain_spread,
            "logdir": self.logdir,
            "wall_s": round(wall, 3),
            "generated": self._generated,
            "completed": self._completed,
            "two_tenant": ({"batch_completed": self._completed_batch,
                            "interactive_completed":
                                self._completed
                                - self._completed_batch}
                           if self.two_tenant else None),
            "phases": [dataclasses.asdict(p) for p in self.phases],
            "rack_kill": kill_fired,
            "scales_applied": supervisor.scales_applied,
            "generations": supervisor.generation + 1,
            "final_workers": supervisor.num_workers,
            "completed_run": "result" in outcome,
            "error": (str(outcome["error"]) if "error" in outcome
                      else None),
        }

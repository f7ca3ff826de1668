"""Fault-tolerant disaggregated data service (tf.data-service equivalent).

The port's copy of ``distributed_tensorflow_tpu/input/data_service.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

≙ the reference's tf.data-service layer under ``input_lib.py`` (SURVEY
L5b): at pod scale the host input pipeline moves OFF the trainers onto
a fleet of **input workers** feeding them over the network, with a
**dispatcher** owning split assignment so the data contract — every
FILE split consumed **exactly once per epoch**, no loss, no
duplication — survives input-worker churn. This module is that layer
built on the repo's own control plane:

- **Transport + state = the coordination KV** (cluster/coordination.py,
  the same KV discipline throughout: point reads, write-once claim
  keys, peer-written binary payloads chunked under the 4 MiB cap — the
  checkpoint/peer_snapshot.py rules). Every key is generation-
  namespaced by the agent (cluster/elastic.py), so elastic trainer
  churn and straggler input workers are fenced exactly like the
  control-plane keys: a reformed generation's epoch state is disjoint
  from every dead incarnation's.
- **Splits** come from :class:`~distributed_tensorflow_tpu_torch.input.
  split_provider.SplitProvider` — one FILE per split, rebuilt per
  worker by replaying the pipeline's recorded op chain (the
  ``shard_files`` machinery).
- **Leases are heartbeat-backed** (resilience/heartbeats.py, ridden
  under the job's own key prefix): the dispatcher assigns splits to
  workers it can see heartbeating; a lease whose worker goes stale is
  re-issued to a live worker (``data.reassign`` event + counter).
- **Exactly-once is by construction**, not by protocol luck: a split's
  completion is ONE write-once ``done`` record (first completing
  attempt wins — ``allow_overwrite=False`` is atomic on the service);
  payload chunks are keyed by the producing worker so a dead worker's
  partial write can never alias the winner's; the trainer consumes
  each (epoch, split) exactly once because it tracks the remaining
  split set of the epoch and each split has exactly one done record.
  Processing may be *at-least-once* under churn (the split pipeline is
  deterministic, so duplicate attempts produce identical bytes);
  delivery is exactly-once.
- **Trainer fetch** paces on :class:`~distributed_tensorflow_tpu_torch.
  resilience.retry.RetryPolicy` with ``decorrelated=True`` jitter and
  accumulates ``total_wait_s`` with the same contract as
  ``training.loops.InfeedLoop`` — pass the client as
  ``StepTelemetry(infeed=client)`` and the fetch-wait lands in the
  ``infeed_wait`` badput bucket of the goodput ledger (live and
  event-walk paths both).

Chaos sites (resilience/faults.py): ``data.dispatch`` (per dispatcher
tick), ``data.fetch`` (per trainer split-fetch attempt; a ``raise``
is retried under the fetch policy), ``data.worker_step`` (per
input-worker split processing; ``raise`` crashes the worker mid-epoch,
``delay`` stalls it past the lease budget — both must end in a
re-issued lease and a complete epoch).

Generation contract: delivery is exactly-once *within a generation*.
When the supervisor reforms the cluster mid-epoch, the new generation's
namespace starts empty — the partially-delivered epoch is discarded and
re-delivered from scratch (deterministic: same seed, same splits, same
elements), the same replay-from-checkpoint semantics elastic training
already has for steps since the last save.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import threading
import time
from typing import Iterator

from distributed_tensorflow_tpu_torch.cluster import coordination, elastic
from distributed_tensorflow_tpu_torch.input.split_provider import SplitProvider
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.resilience import heartbeats as _hb
from distributed_tensorflow_tpu_torch.resilience.retry import Backoff, RetryPolicy
from distributed_tensorflow_tpu_torch.telemetry import events as _events
from distributed_tensorflow_tpu_torch.telemetry import registry as _registry


class DataServiceError(RuntimeError):
    """A data-service protocol failure (lost spec, fetch timeout)."""


@dataclasses.dataclass(frozen=True)
class DataServiceConfig:
    """Shared knobs of one data-service job.

    - ``job`` — the KV namespace of this job (``data/<job>/...``).
    - ``lease_timeout_s`` — heartbeat staleness past which a worker's
      leases are re-issued (the failure-detection budget; must exceed
      the worker's per-split processing time or healthy slow workers
      get their work stolen — stolen work is still correct, just
      wasted).
    - ``chunk_bytes`` — payload chunk ceiling (< the 4 MiB grpc cap,
      the peer_snapshot discipline).
    """

    job: str = "default"
    lease_timeout_s: float = 2.0
    poll_interval_s: float = 0.02
    chunk_bytes: int = 2 * 1024 * 1024
    hb_shard_size: int = 32
    fetch_timeout_s: float = 120.0

    @property
    def prefix(self) -> str:
        return f"data/{self.job}"


# -- key layout (all generation-namespaced by the agent) -----------------

def _spec_key(cfg: DataServiceConfig) -> str:
    return f"{cfg.prefix}/spec"


def _assign_key(cfg: DataServiceConfig, epoch: int, worker: int) -> str:
    return f"{cfg.prefix}/e{epoch}/assign/{worker}"


def _done_key(cfg: DataServiceConfig, epoch: int, split: int) -> str:
    return f"{cfg.prefix}/e{epoch}/s{split}/done"


def _chunk_key(cfg: DataServiceConfig, epoch: int, split: int,
               worker: int, k: int) -> str:
    return f"{cfg.prefix}/e{epoch}/s{split}/w{worker}/c{k}"


def _epoch_complete_key(cfg: DataServiceConfig, epoch: int) -> str:
    return f"{cfg.prefix}/e{epoch}/complete"


def _shutdown_key(cfg: DataServiceConfig) -> str:
    return f"{cfg.prefix}/shutdown"


# -- job registration ------------------------------------------------------

def register_job(agent, cfg: DataServiceConfig, provider: SplitProvider,
                 *, epochs: int, num_workers: int):
    """Publish the job spec (chief/dispatcher side). Split *identity*
    (file list order, epoch permutation seed) travels in the spec so
    every participant derives the identical universe."""
    agent.key_value_set(_spec_key(cfg), json.dumps({
        "num_splits": provider.num_splits, "epochs": int(epochs),
        "seed": provider.seed, "num_workers": int(num_workers)}))


def read_job_spec(agent, cfg: DataServiceConfig, *,
                  timeout_s: float = 30.0) -> dict:
    try:
        raw = agent.key_value_get(_spec_key(cfg), timeout_s=timeout_s)
    except coordination.CoordinationError as e:
        raise DataServiceError(
            f"data-service job {cfg.job!r} spec never published") from e
    return json.loads(raw.decode())


def signal_shutdown(agent, cfg: DataServiceConfig):
    """Trainer-side: release the input workers (this generation's)."""
    agent.key_value_set(_shutdown_key(cfg), b"1")


def _shutdown_requested(agent, cfg: DataServiceConfig) -> bool:
    return agent.key_value_try_get(_shutdown_key(cfg)) is not None


def acknowledge_shutdown(agent, cfg: DataServiceConfig, worker_id: int):
    """Input-worker side: confirm this worker saw the shutdown and will
    touch the KV no more. The trainer typically HOSTS the coordination
    service (process 0); tearing it down while workers still poll would
    turn a clean exit into a spurious failure the supervisor then
    'recovers' from."""
    agent.key_value_set(f"{cfg.prefix}/bye/{int(worker_id)}", b"1")


def await_shutdown_acks(agent, cfg: DataServiceConfig, num_workers: int,
                        *, timeout_s: float = 10.0) -> bool:
    """Trainer-side: wait (bounded) for every input worker's ack; False
    on timeout (dead workers never ack — exit anyway, their supervisor
    owns them)."""
    deadline = time.monotonic() + timeout_s
    pending = set(range(int(num_workers)))
    while pending and time.monotonic() < deadline:
        for w in sorted(pending):
            if agent.key_value_try_get(f"{cfg.prefix}/bye/{w}") \
                    is not None:
                pending.discard(w)
        if pending:
            time.sleep(0.02)
    return not pending


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

class DataServiceDispatcher:
    """Split-assignment authority of one job (≙ the tf.data-service
    dispatcher's split re-assignment of dead workers).

    Holds the lease table in memory and the *durable* facts in the KV
    (done records, assignment keys, epoch completion): a dispatcher
    reformed under a new generation re-derives everything it needs from
    the provider (deterministic split universe) and the new namespace
    (empty = restart the epoch), which is the same recover-by-replay
    contract the trainers have.

    Drive it with :meth:`tick` (deterministic tests / the simulated
    fleet) or :meth:`start`/:meth:`stop` (a background thread, the
    production shape). One tick: observe worker liveness -> collect
    done records -> re-issue leases of stale workers -> assign
    unleased splits -> publish changed assignments -> complete the
    epoch when every split is done.
    """

    def __init__(self, agent, provider: SplitProvider,
                 cfg: DataServiceConfig, *, num_workers: int,
                 epochs: int = 1, reg=None,
                 domains: "dict[int, str] | None" = None):
        self.agent = agent
        self.provider = provider
        self.cfg = cfg
        self.num_workers = int(num_workers)
        self.epochs = int(epochs)
        #: optional {worker_id: failure_domain} placement map: leases
        #: are spread across domains (least-loaded domain first, then
        #: least-loaded worker within it) and a dead worker's lease is
        #: re-issued OUTSIDE its domain when any other domain has a
        #: live member — a rack loss then stalls only that rack's
        #: in-flight splits, never a whole epoch's worth piled on one
        #: survivor rack.
        self.domains = dict(domains) if domains else None
        self.reader = _hb.ShardedKVHeartbeats(
            agent, shard_size=cfg.hb_shard_size,
            summary_stale_s=cfg.lease_timeout_s,
            key_prefix=cfg.prefix)
        # This dispatcher lives INSIDE one generation: capture it at
        # construction. The sharded reader pins its own generation on
        # every read (supervisor semantics — it outlives generations),
        # and tick() re-applies the override because the background
        # loop runs on its own thread — thread-local generation
        # overrides (fleet_sim) do not travel across threads, and a
        # reformed dispatcher polling the DEAD generation's keys would
        # never see a heartbeat or publish a visible assignment.
        self._gen = elastic.generation()
        self.reader.generation = self._gen
        self.epoch = 0
        self.splits_reassigned = 0
        self.epochs_completed = 0
        self._leases: "dict[int, int]" = {}       # split -> worker
        self._done: "set[int]" = set()
        self._assign_ver: "dict[int, int]" = {}
        self._published: "dict[int, list]" = {}
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        reg = reg or _registry.get_registry()
        self._m_reassigned = reg.counter(
            "data/splits_reassigned",
            "splits re-issued after input-worker death")
        self._m_epochs = reg.counter(
            "data/epochs_completed", "data-service epochs completed")
        self._m_outstanding = reg.gauge(
            "data/splits_outstanding", "splits not yet done this epoch")
        register_job(agent, cfg, provider, epochs=epochs,
                     num_workers=num_workers)

    # -- liveness ----------------------------------------------------------
    def _live_workers(self) -> "list[int]":
        hbs = self.reader.read_all(self.num_workers)
        now = time.time()
        return sorted(w for w, hb in hbs.items()
                      if hb[2] is not None
                      and now - hb[2] <= self.cfg.lease_timeout_s)

    # -- one tick ----------------------------------------------------------
    def tick(self) -> bool:
        """One dispatch round; returns True while the job is running
        (False once every epoch completed)."""
        with elastic.generation_override(self._gen):
            return self._tick()

    def _tick(self) -> bool:
        if self.epoch >= self.epochs:
            return False
        faults.fire("data.dispatch", tag=self.cfg.job)
        live = self._live_workers()
        self._collect_done()
        if live:
            self._reissue_stale(live)
            # Fleet-formation grace: the FIRST worker to heartbeat must
            # not be handed the whole epoch just because its peers are
            # a tick behind — wait for the full fleet (or the lease
            # budget, past which missing workers are treated as dead).
            if (len(live) >= self.num_workers
                    or time.monotonic() - self._t0
                    > 2 * self.cfg.lease_timeout_s):
                self._assign_unleased(live)
            self._publish_assignments()
        self._m_outstanding.set(
            self.provider.num_splits - len(self._done))
        if len(self._done) >= self.provider.num_splits:
            self.agent.key_value_set(
                _epoch_complete_key(self.cfg, self.epoch), b"1")
            _events.event("data.epoch_complete", job=self.cfg.job,
                          epoch=self.epoch,
                          reassigned=self.splits_reassigned)
            self._m_epochs.increment()
            self.epochs_completed += 1
            self.epoch += 1
            self._leases.clear()
            self._done.clear()
            self._published.clear()
        return self.epoch < self.epochs

    def _collect_done(self):
        for split in range(self.provider.num_splits):
            if split in self._done:
                continue
            if self.agent.key_value_try_get(
                    _done_key(self.cfg, self.epoch, split)) is not None:
                self._done.add(split)
                self._leases.pop(split, None)

    def _reissue_stale(self, live: "list[int]"):
        live_set = set(live)
        for split, worker in sorted(self._leases.items()):
            if worker in live_set or split in self._done:
                continue
            # a lease lost to a (likely whole-domain) failure is
            # re-placed outside the dead worker's domain when possible:
            # if the rest of that rack is about to be declared dead
            # too, re-issuing into it would just re-lose the lease
            new = self._least_loaded(live, avoid_domain=self._domain_of(worker))
            self._leases[split] = new
            self.splits_reassigned += 1
            self._m_reassigned.increment()
            _events.event("data.reassign", job=self.cfg.job,
                          epoch=self.epoch, split=split,
                          from_worker=worker, to_worker=new,
                          from_domain=self._domain_of(worker),
                          to_domain=self._domain_of(new))

    def _assign_unleased(self, live: "list[int]"):
        for split in self.provider.epoch_order(self.epoch):
            if split in self._done or split in self._leases:
                continue
            self._leases[split] = self._least_loaded(live)

    def _domain_of(self, worker: int) -> "str | None":
        if not self.domains:
            return None
        return self.domains.get(worker)

    def _least_loaded(self, live: "list[int]", *,
                      avoid_domain: "str | None" = None) -> int:
        load = {w: 0 for w in live}
        for w in self._leases.values():
            if w in load:
                load[w] += 1
        cands = sorted(load)
        if self.domains:
            if avoid_domain is not None:
                outside = [w for w in cands
                           if self._dom_key(w) != avoid_domain]
                if outside:
                    cands = outside
            dom_load: "dict[str, int]" = {}
            for w in cands:
                d = self._dom_key(w)
                dom_load[d] = dom_load.get(d, 0) + load[w]
            best = min(sorted(dom_load), key=lambda d: dom_load[d])
            cands = [w for w in cands if self._dom_key(w) == best]
        return min(cands, key=lambda w: load[w])

    def _dom_key(self, worker: int) -> str:
        """Placement key of a worker: its mapped domain, or a singleton
        pseudo-domain when unmapped (an unmapped worker never blocks
        domain spreading, never aliases another worker's domain)."""
        d = (self.domains or {}).get(worker)
        return d if d is not None else f"__w{worker}"

    def _publish_assignments(self):
        by_worker: "dict[int, list]" = {}
        for split, worker in self._leases.items():
            by_worker.setdefault(worker, []).append(split)
        for worker, splits in sorted(by_worker.items()):
            splits = sorted(splits)
            if self._published.get(worker) == splits:
                continue
            ver = self._assign_ver.get(worker, 0) + 1
            self._assign_ver[worker] = ver
            self.agent.key_value_set(
                _assign_key(self.cfg, self.epoch, worker),
                json.dumps({"ver": ver, "splits": splits}))
            self._published[worker] = splits

    # -- background loop ---------------------------------------------------
    def start(self) -> "DataServiceDispatcher":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"dtx-dispatch-{self.cfg.job}")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                if not self.tick():
                    return
            except coordination.CoordinationError:
                pass                    # transient KV blip: next tick
            self._stop.wait(self.cfg.poll_interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# Input worker
# ---------------------------------------------------------------------------

class DataInputWorker:
    """One input worker: heartbeat, poll the assignment key, process
    leased splits (replay the recorded pipeline over the split's file),
    publish the payload, claim the write-once done record.

    ``run`` loops until the job's epochs are exhausted, a shutdown is
    signalled, or ``stop`` is set (the simulated fleet's cooperative
    SIGKILL). Processing is idempotent: losing the done-record race (a
    re-issued lease both sides completed) is not an error — the bytes
    are identical by determinism and only the winner is consumed.
    """

    def __init__(self, agent, provider: SplitProvider,
                 cfg: DataServiceConfig, *, worker_id: int,
                 num_workers: int, epochs: "int | None" = None,
                 heartbeat_fn=None, reg=None):
        self.agent = agent
        self.provider = provider
        self.cfg = cfg
        self.worker_id = int(worker_id)
        self.num_workers = int(num_workers)
        self.epochs = epochs
        self.heartbeat_fn = heartbeat_fn
        self.pub = _hb.ShardedHeartbeatPublisher(
            agent, pid=self.worker_id, num_workers=num_workers,
            shard_size=cfg.hb_shard_size, key_prefix=cfg.prefix)
        #: generation captured at construction (the data_service
        #: contract: protocol objects live inside ONE generation and
        #: re-apply it on their own threads — see Dispatcher.tick)
        self._gen = elastic.generation()
        self.splits_processed = 0
        self.elements_out = 0
        reg = reg or _registry.get_registry()
        self._m_splits = reg.counter(
            "data/splits_processed", "splits this input worker produced")
        self._m_elements = reg.counter(
            "data/elements_out", "elements this input worker produced")
        self._m_busy = reg.timer(
            "data/split_process_time", "per-split processing seconds")

    def run(self, stop: "threading.Event | None" = None):
        """Serve until RELEASED, not until the work looks done: even
        with every epoch's splits produced, this worker keeps
        heartbeating and waits for the trainer's shutdown signal — the
        trainer may still be consuming (or still compiling), and an
        input worker that exits early tears the shared distributed
        runtime down under it."""
        with elastic.generation_override(self._gen):
            self._run(stop)

    def _run(self, stop: "threading.Event | None"):
        stop = stop or threading.Event()
        if self.epochs is None:
            self.epochs = read_job_spec(self.agent, self.cfg)["epochs"]
        epoch = 0
        beat = 0
        while not stop.is_set():
            beat += 1
            self.pub.beat(beat)
            if self.heartbeat_fn is not None:
                self.heartbeat_fn(self.splits_processed)
            if _shutdown_requested(self.agent, self.cfg):
                break
            if epoch < self.epochs and self.agent.key_value_try_get(
                    _epoch_complete_key(self.cfg, epoch)) is not None:
                epoch += 1
                continue
            if epoch < self.epochs:
                for split in self._assigned(epoch):
                    if stop.is_set():
                        break
                    self._process(epoch, split)
            if stop.wait(self.cfg.poll_interval_s):
                break
        # clean exit only (a chaos crash propagates past this): tell
        # the trainer it is safe to tear the coordination service down
        acknowledge_shutdown(self.agent, self.cfg, self.worker_id)

    def _assigned(self, epoch: int) -> "list[int]":
        raw = self.agent.key_value_try_get(
            _assign_key(self.cfg, epoch, self.worker_id))
        if raw is None:
            return []
        try:
            return list(json.loads(raw.decode()).get("splits", []))
        except (ValueError, UnicodeDecodeError):
            return []

    def _process(self, epoch: int, split: int):
        if self.agent.key_value_try_get(
                _done_key(self.cfg, epoch, split)) is not None:
            return                          # someone already finished it
        # Chaos site: fires once per split-processing attempt (tag =
        # worker id, per-tag hit counter = this worker's attempt
        # number). A ``raise`` crashes the worker mid-epoch, a
        # ``delay`` stalls it past the lease budget — either way the
        # dispatcher must re-issue the lease and the epoch must still
        # complete exactly-once.
        faults.fire("data.worker_step", tag=self.worker_id)
        t0 = time.monotonic()
        elements = self.provider.elements(split)
        payload = pickle.dumps(elements, protocol=pickle.HIGHEST_PROTOCOL)
        chunks = [payload[i:i + self.cfg.chunk_bytes]
                  for i in range(0, len(payload), self.cfg.chunk_bytes)] \
            or [b""]
        for k, chunk in enumerate(chunks):
            self.agent.key_value_set(
                _chunk_key(self.cfg, epoch, split, self.worker_id, k),
                chunk)
        dur = time.monotonic() - t0
        record = json.dumps({"worker": self.worker_id,
                             "chunks": len(chunks),
                             "elements": len(elements)})
        try:
            # write-once claim: the FIRST completing attempt wins; a
            # racing attempt (re-issued lease both sides finished) just
            # loses — its chunks are unreachable garbage the generation
            # GC sweeps with the namespace
            self.agent.key_value_set(_done_key(self.cfg, epoch, split),
                                     record, allow_overwrite=False)
        except Exception:
            return                          # lost the race: not an error
        self.splits_processed += 1
        self.elements_out += len(elements)
        self._m_splits.increment()
        self._m_elements.increment(len(elements))
        self._m_busy.record(dur)
        _events.event("data.split_done", job=self.cfg.job, epoch=epoch,
                      split=split, worker=self.worker_id,
                      elements=len(elements), dur_s=round(dur, 6))


# ---------------------------------------------------------------------------
# Trainer-side client
# ---------------------------------------------------------------------------

class DataServiceClient:
    """Trainer-side consumption of one job, epoch by epoch.

    :meth:`epoch` yields the epoch's elements in split-completion
    order — the SEQUENCE depends on worker timing, the MULTISET is
    deterministic (the exactly-once contract's unit). Fetch pacing is
    a decorrelated-jitter :class:`RetryPolicy` backoff (the
    thundering-herd shape N trainers polling one namespace need);
    transient fetch failures (chaos site ``data.fetch``) retry under
    the same policy.

    ``total_wait_s`` follows the ``InfeedLoop`` contract (cumulative
    seconds the consumer blocked on input), so
    ``StepTelemetry(infeed=client)`` prices fetch-wait into the
    ``infeed_wait`` badput bucket with zero extra wiring.
    """

    def __init__(self, agent, cfg: DataServiceConfig, *,
                 num_splits: "int | None" = None,
                 retry: "RetryPolicy | None" = None,
                 heartbeat_fn=None):
        self.agent = agent
        self.cfg = cfg
        if num_splits is None:
            num_splits = read_job_spec(agent, cfg)["num_splits"]
        self.num_splits = int(num_splits)
        self.retry = retry or RetryPolicy(
            max_attempts=8, initial_backoff_s=0.005, max_backoff_s=0.25,
            decorrelated=True, seed=0,
            retryable=(coordination.CoordinationError,))
        self.heartbeat_fn = heartbeat_fn
        self._gen = elastic.generation()
        self.total_wait_s = 0.0
        self.splits_consumed = 0
        self.elements_consumed = 0

    def _fetch_split(self, epoch: int, split: int, record: dict) -> list:
        def get_chunks():
            faults.fire("data.fetch", tag=str(split),
                        exc=coordination.CoordinationError,
                        msg=f"injected data.fetch failure (split {split})")
            parts = []
            for k in range(int(record["chunks"])):
                parts.append(self.agent.key_value_get(
                    _chunk_key(self.cfg, epoch, split,
                               int(record["worker"]), k),
                    timeout_s=self.cfg.fetch_timeout_s))
            return pickle.loads(b"".join(parts))

        return self.retry.call(get_chunks)

    def epoch(self, epoch: int) -> Iterator:
        """Yield every element of ``epoch`` exactly once (per split,
        split-completion order). Raises :class:`DataServiceError` if no
        split completes within ``fetch_timeout_s`` — dead fleet, not a
        slow one."""
        with elastic.generation_override(self._gen):
            yield from self._epoch(epoch)

    def _epoch(self, epoch: int) -> Iterator:
        remaining = set(range(self.num_splits))
        backoff = Backoff(self.retry)
        last_progress = time.monotonic()
        epoch_elements = 0
        while remaining:
            progressed = False
            for split in sorted(remaining):
                raw = self.agent.key_value_try_get(
                    _done_key(self.cfg, epoch, split))
                if raw is None:
                    continue
                record = json.loads(raw.decode())
                t0 = time.monotonic()
                elements = self._fetch_split(epoch, split, record)
                self.total_wait_s += time.monotonic() - t0
                remaining.discard(split)
                progressed = True
                backoff.reset()
                last_progress = time.monotonic()
                self.splits_consumed += 1
                self.elements_consumed += len(elements)
                epoch_elements += len(elements)
                _events.event("data.split_consumed", job=self.cfg.job,
                              epoch=epoch, split=split,
                              worker=int(record["worker"]),
                              elements=len(elements))
                yield from elements
            if remaining and not progressed:
                if (time.monotonic() - last_progress
                        > self.cfg.fetch_timeout_s):
                    raise DataServiceError(
                        f"epoch {epoch}: no split completed in "
                        f"{self.cfg.fetch_timeout_s}s "
                        f"({len(remaining)} outstanding: "
                        f"{sorted(remaining)[:8]})")
                if self.heartbeat_fn is not None:
                    self.heartbeat_fn(None)
                t0 = time.monotonic()
                backoff.sleep(max_s=0.25)
                self.total_wait_s += time.monotonic() - t0
        _events.event("data.epoch_consumed", job=self.cfg.job,
                      epoch=epoch, splits=self.num_splits,
                      elements=epoch_elements)

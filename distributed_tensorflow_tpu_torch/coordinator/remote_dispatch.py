"""Remote closure dispatch: coordinator -> worker processes — port of
``distributed_tensorflow_tpu/coordinator/remote_dispatch.py`` (≙ the
reference's remote execution path, ``cluster_coordinator.py:1027``
``Worker`` and :879 ``WorkerPreemptionHandler.wait_on_failure``).

Closures ride the coordination KV (``cluster/coordination.py``: the
process group's ``TCPStore``), pickled, under JAX's keys letter for
letter::

    coordinator                           worker process w
    -----------                           ----------------
    g<G>/task/<w>/<seq> <- pickle(...)    blocking get g<G>/task/<w>/<seq>
    blocking get g<G>/result/<w>/<seq>    run fn
      | heartbeat stale?                  set g<G>/result/<w>/<seq>
      v                                   seq += 1
    WorkerPreemptionError -> re-queue
    g<G>/done/<w> = watermark

(all under ``dtx_coord/``). The lifecycle rules are JAX's: every key
lives under a per-coordinator-incarnation generation ``g<G>``; the
coordinator deletes a closure's task and result keys once it has read
the result, and advances the ``done/<w>`` watermark a restarted worker
resumes from; a worker bumps its heartbeat key a few times a second and
a lane that sees it go stale while waiting raises
:class:`~distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator.
WorkerPreemptionError`. No collective is involved, so a killed worker
cannot hang the coordinator.

A store client serialises its operations, and a blocking ``wait`` holds
it; so each lane, and each worker's heartbeat, has a connection of its
own to the store (:func:`~distributed_tensorflow_tpu_torch.cluster.
coordination.private_agent`). This is a control plane:
``MAX_PAYLOAD_BYTES`` (JAX's 4 MiB) refuses a closure whose pickle is
bigger.
"""

from __future__ import annotations

import pickle
import threading
import time
import traceback
from typing import Any, Callable

from distributed_tensorflow_tpu_torch.cluster.coordination import (
    CoordinationError,
    CoordinationServiceAgent,
    coordination_service,
    private_agent,
)
from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator import (
    _on_lane)
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.resilience.retry import Backoff, RetryPolicy
from distributed_tensorflow_tpu_torch.telemetry import events as telemetry_events
from distributed_tensorflow_tpu_torch.telemetry import registry as telemetry_registry

_ROOT = "dtx_coord"
_HEARTBEAT_INTERVAL = 0.2

#: Pacing for the fast-fail path inside :meth:`RemoteLane.wait` — a
#: coordination-service error (not a timeout) backs off along this
#: schedule instead of hot-spinning until the staleness window closes.
#: Shared policy object (resilience/retry.py) rather than ad-hoc sleeps.
_WAIT_BACKOFF_POLICY = RetryPolicy(initial_backoff_s=0.05,
                                   backoff_multiplier=2.0,
                                   max_backoff_s=0.1)

#: Closure payloads ride the coordination service's KV store, which is a
#: control plane. Anything bigger than this belongs in the data plane
#: (collectives, checkpoints), not in a pickled closure.
MAX_PAYLOAD_BYTES = 4 << 20


class RemoteClosureError(RuntimeError):
    """The closure raised on the worker; carries the remote traceback."""


def _hb_key(worker_id: int) -> str:
    return f"{_ROOT}/hb/{worker_id}"


def _gen_dir(gen: int) -> str:
    return f"{_ROOT}/g{gen}"


def _task_key(gen: int, worker_id: int, seq: int) -> str:
    return f"{_gen_dir(gen)}/task/{worker_id}/{seq}"


def _result_key(gen: int, worker_id: int, seq: int) -> str:
    return f"{_gen_dir(gen)}/result/{worker_id}/{seq}"


def closure_span_id(gen: int, worker_id: int, seq: int) -> str:
    """Stable causality id one closure carries across processes: the
    coordinator's ``dispatch.send``/``dispatch.result`` events and the
    worker's ``worker.execute`` span all stamp it, so the merged trace
    (telemetry/trace.py) links them into one flow chain. (gen, worker,
    seq) already uniquely names a closure on the KV control plane — the
    span id is just its printable form."""
    return f"dispatch/g{gen}/w{worker_id}/c{seq}"


def _done_key(gen: int, worker_id: int) -> str:
    """Watermark: next seq this worker should run (restart fast-forward)."""
    return f"{_gen_dir(gen)}/done/{worker_id}"


def _shutdown_key(gen: int) -> str:
    return f"{_gen_dir(gen)}/shutdown"


# ---------------------------------------------------------------------------
# Generations: one per coordinator incarnation.
# ---------------------------------------------------------------------------

_GEN_LOCK = threading.Lock()
_GENERATION: int | None = None


def _coordinator_generation(agent: CoordinationServiceAgent) -> int:
    """This coordinator process's generation — allocated once, published
    as ``current_gen`` for workers to follow. A restarted coordinator
    allocates a fresh one, so stale task/result keys from a crashed
    incarnation are unreachable (and its immediate predecessor's
    namespace is garbage-collected here)."""
    global _GENERATION
    with _GEN_LOCK:
        if _GENERATION is None:
            gen = agent.key_value_increment(f"{_ROOT}/generation")
            if gen > 1:        # GC a crashed predecessor's namespace
                try:
                    agent.key_value_delete(_gen_dir(gen - 1))
                except Exception:
                    pass
            agent.key_value_set(f"{_ROOT}/current_gen", str(gen))
            _GENERATION = gen
        return _GENERATION


def _reset_generation_for_tests():
    global _GENERATION
    with _GEN_LOCK:
        _GENERATION = None


class RemoteLane:
    """Coordinator-side handle to one worker process (≙ the grpc channel
    + remote executor inside cluster_coordinator.Worker :1027)."""

    def __init__(self, worker_id: int,
                 agent: CoordinationServiceAgent | None = None,
                 staleness_s: float = 3.0):
        self.worker_id = worker_id
        self.agent = agent or private_agent()
        self.staleness_s = staleness_s
        self.generation = _coordinator_generation(
            agent or coordination_service())
        self._seq = 0
        # execute() may be called from the Worker dispatch thread AND
        # directly (per-worker resource creation): seq allocation must
        # be atomic or two callers share a task slot
        self._seq_lock = threading.Lock()
        # Consumed-seq bookkeeping for the restart watermark: this lane
        # is the SOLE writer of done/<w> (a single writer cannot race
        # itself), advancing it to the contiguous consumed prefix.
        self._consumed: set[int] = set()
        self._watermark = 0
        self._last_hb: bytes | None = None
        self._last_change = time.monotonic()

    # -- liveness ---------------------------------------------------------
    def alive(self) -> bool:
        """Heartbeat-derived liveness: the hb VALUE must keep changing.
        Monotonic-local staleness clocking — no cross-host clock trust."""
        hb = self.agent.key_value_try_get(_hb_key(self.worker_id))
        now = time.monotonic()
        if hb is None:
            # never seen: give the worker a startup grace window
            return now - self._last_change < self.staleness_s * 4
        if hb != self._last_hb:
            self._last_hb = hb
            self._last_change = now
            return True
        return now - self._last_change < self.staleness_s

    # -- execution --------------------------------------------------------
    def submit(self, fn: Callable, args: tuple, kwargs: dict) -> int:
        """Publish one closure without waiting; returns its seq (pair
        with :meth:`wait` — lets callers fan tasks out to many lanes
        before blocking on any result)."""
        payload = pickle.dumps((fn, args, kwargs))
        if len(payload) > MAX_PAYLOAD_BYTES:
            raise ValueError(
                f"closure payload is {len(payload)} bytes "
                f"(> {MAX_PAYLOAD_BYTES}): the KV control plane is not a "
                f"data path — move bulk data via collectives, "
                f"checkpoints, or per-worker datasets")
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        if telemetry_events.enabled():
            # span_id threads the closure through the merged timeline:
            # dispatch.send (coordinator) -> worker.execute (worker) ->
            # dispatch.result (coordinator) render as one flow chain in
            # the assembled trace (telemetry/trace.py).
            telemetry_events.event(
                "dispatch.send", worker=self.worker_id, closure=seq,
                span_id=closure_span_id(self.generation, self.worker_id,
                                        seq))
        self.agent.key_value_set(
            _task_key(self.generation, self.worker_id, seq), payload)
        return seq

    def wait(self, seq: int, timeout_s: float | None = None) -> Any:
        """Block for a submitted closure's result; translate worker death
        into WorkerPreemptionError (the retryable class). Consumed task +
        result keys are deleted — the KV store stays bounded regardless
        of how many closures the job schedules."""
        from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
            import WorkerPreemptionError
        # Stall attribution: while this lane blocks (including inside an
        # injected dispatch.wait chaos delay), the telemetry stall
        # detector can see WHICH worker the coordinator is waiting on
        # (telemetry/stall.suspect_worker reads these gauges).
        wait_gauge = telemetry_registry.gauge(
            f"coordinator/dispatch/waiting/{self.worker_id}")
        wait_gauge.set(time.monotonic())
        try:
            faults.fire("dispatch.wait", tag=self.worker_id,
                        exc=WorkerPreemptionError,
                        msg=f"injected preemption: worker "
                            f"{self.worker_id}, closure {seq}")
            deadline = (time.monotonic() + timeout_s) if timeout_s else None
            rkey = _result_key(self.generation, self.worker_id, seq)
            backoff = Backoff(_WAIT_BACKOFF_POLICY)
            return self._wait_inner(seq, rkey, deadline, backoff)
        finally:
            wait_gauge.set(None)

    def _wait_inner(self, seq: int, rkey: str, deadline, backoff):
        from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
            import WorkerPreemptionError
        while True:
            # Blocking get in staleness-sized slices: wakes immediately
            # when the worker publishes, touches the service once per
            # slice otherwise (vs the previous 50 polls/s).
            slice_s = self.staleness_s
            if deadline is not None:
                slice_s = min(slice_s, max(deadline - time.monotonic(),
                                           0.01))
            t0 = time.monotonic()
            try:
                res = self.agent.key_value_get(rkey, timeout_s=slice_s)
                break
            except CoordinationError:
                # Not published yet — but if the get failed FAST (service
                # error, not a timeout), back off instead of hot-spinning
                # until the heartbeat staleness window closes.
                waited = time.monotonic() - t0
                if waited < slice_s:
                    backoff.sleep(max_s=slice_s - waited)
                else:
                    backoff.reset()      # full slice elapsed: not an error
            if not self.alive():
                telemetry_events.event("dispatch.preempted",
                                       worker=self.worker_id, closure=seq,
                                       staleness_s=self.staleness_s)
                raise WorkerPreemptionError(
                    f"worker {self.worker_id} heartbeat stale "
                    f"(>{self.staleness_s}s) while closure {seq} in flight")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"closure {seq} on worker {self.worker_id} timed out")
        # Consume: advance the restart watermark BEFORE deleting the
        # task/result keys, so a restarted worker can never block on a
        # task key this consume already deleted. The lane is the single
        # writer of done/<w>, advancing it to the CONTIGUOUS consumed
        # prefix under the lane lock (two lane threads consuming
        # different seqs cannot regress it; a completed-but-unconsumed
        # seq above the watermark is simply re-run after a restart —
        # its task key still exists and re-publishing the result is
        # idempotent at-least-once, the reference's retry semantics).
        with self._seq_lock:
            self._consumed.add(seq)
            advanced = False
            while self._watermark in self._consumed:
                self._consumed.discard(self._watermark)
                self._watermark += 1
                advanced = True
            if advanced:
                try:
                    self.agent.key_value_set(
                        _done_key(self.generation, self.worker_id),
                        str(self._watermark))
                except Exception:
                    pass
        for k in (rkey, _task_key(self.generation, self.worker_id, seq)):
            try:
                self.agent.key_value_delete(k)
            except Exception:
                pass
        status, data = pickle.loads(res)
        if status == "ok":
            if telemetry_events.enabled():
                telemetry_events.event(
                    "dispatch.result", worker=self.worker_id, closure=seq,
                    span_id=closure_span_id(self.generation,
                                            self.worker_id, seq))
            return data
        telemetry_events.event("dispatch.closure_error",
                               worker=self.worker_id, closure=seq,
                               span_id=closure_span_id(
                                   self.generation, self.worker_id, seq))
        raise RemoteClosureError(
            f"closure failed on worker {self.worker_id}:\n{data}")

    def execute(self, fn: Callable, args: tuple, kwargs: dict,
                timeout_s: float | None = None) -> Any:
        """submit + wait."""
        return self.wait(self.submit(fn, args, kwargs), timeout_s)


class _ResourceHandle:
    """Worker-side resource reference (≙ per-worker resources: the object
    stays on the worker; the coordinator holds an opaque handle).

    ``builder`` (a picklable zero-arg factory) makes handles SELF-HEALING
    across worker restarts: a restarted worker whose registry lost the
    object rebuilds it on first use instead of failing the closure —
    ≙ the reference re-creating per-worker resources after worker
    recovery (cluster_coordinator.py per-worker dataset re-creation).
    Handle ids embed the worker INCARNATION (an atomic counter bumped at
    service start), so a stale handle can never alias a fresh resource
    on a restarted worker — it misses the registry and rebuilds.
    """

    def __init__(self, worker_id: int, handle: str, builder=None):
        self.worker_id = worker_id
        self.handle = handle
        self.builder = builder


def resolve_resources(args, registry: dict):
    """Worker-side: swap _ResourceHandle leaves for the live objects,
    rebuilding missing ones from their builder (worker restarted)."""
    from distributed_tensorflow_tpu_torch.utils import tree

    def resolve(v):
        if not isinstance(v, _ResourceHandle):
            return v
        if v.handle not in registry:
            if v.builder is None:
                raise KeyError(
                    f"resource handle {v.handle} unknown on this worker "
                    f"(restarted?) and carries no builder")
            registry[v.handle] = v.builder()
        return registry[v.handle]

    return tree.tree_map(
        resolve, args, is_leaf=lambda v: isinstance(v, _ResourceHandle))


class RemoteWorkerService:
    """Worker-process service loop (≙ the worker side of the grpc eager
    service): pull task keys in sequence, execute, publish results.

    Run via ``run_worker_loop()`` from a worker task's main; returns when
    the coordinator publishes the shutdown key. Follows the published
    ``current_gen``: if a new coordinator incarnation appears mid-loop,
    the service switches namespaces and resumes from the new generation's
    watermark.
    """

    def __init__(self, worker_id: int | None = None,
                 agent: CoordinationServiceAgent | None = None,
                 device=None):
        self.agent = agent or coordination_service()
        self._hb_agent = agent or private_agent()
        self.worker_id = (worker_id if worker_id is not None
                          else self.agent.process_id)
        self.device = device if device is not None else _own_device()
        self.resources: dict[str, Any] = {}
        self._incarnation = self.agent.key_value_increment(
            f"{_ROOT}/incarnation/{self.worker_id}")
        self._next_handle = 0
        self._stop = threading.Event()
        self._hb_thread: threading.Thread | None = None

    # -- heartbeat --------------------------------------------------------
    def _heartbeat(self):
        n = 0
        while not self._stop.is_set():
            n += 1
            try:
                self._hb_agent.key_value_set(_hb_key(self.worker_id),
                                             f"{self._incarnation}:{n}")
            except Exception:
                return                      # service gone: job is over
            time.sleep(_HEARTBEAT_INTERVAL)

    # -- resource registry (coordinator schedules these as closures) -----
    def create_resource(self, fn, *args, builder=None,
                        **kwargs) -> _ResourceHandle:
        """``builder``: optional picklable zero-arg re-creation factory
        stored on the handle (self-healing across worker restarts)."""
        obj = fn(*args, **kwargs)
        h = f"{self._incarnation}:{self._next_handle}"
        self._next_handle += 1
        self.resources[h] = obj
        return _ResourceHandle(self.worker_id, h, builder=builder)

    # -- main loop --------------------------------------------------------
    def _current_gen(self) -> int | None:
        raw = self.agent.key_value_try_get(f"{_ROOT}/current_gen")
        return int(raw) if raw is not None else None

    def _initial_seq(self, gen: int) -> int:
        """Restart support: resume from the completed-seq watermark (a
        restarted worker must not re-run completed closures)."""
        raw = self.agent.key_value_try_get(_done_key(gen, self.worker_id))
        return int(raw) if raw is not None else 0

    def run(self, poll_s: float = 0.5):
        """Serve closures until the coordinator's shutdown key appears.

        ``poll_s`` is the blocking-get slice for the task key — purely a
        shutdown/generation-switch responsiveness bound, not a poll rate
        (the get wakes immediately when a task is published).
        """
        self._hb_thread = threading.Thread(target=self._heartbeat,
                                           daemon=True)
        self._hb_thread.start()
        gen: int | None = None
        seq = 0
        try:
            while True:
                cur = self._current_gen()
                if cur is None:          # no coordinator incarnation yet
                    time.sleep(min(poll_s, 0.05))
                    continue
                if cur != gen:           # adopt the (new) coordinator
                    gen, seq = cur, self._initial_seq(cur)
                if self.agent.key_value_try_get(
                        _shutdown_key(gen)) is not None:
                    # ack so the coordinator (which hosts the coordination
                    # service) won't tear it down under our last RPCs
                    self._stop.set()
                    self.agent.key_value_set(
                        f"{_gen_dir(gen)}/shutdown_ack/{self.worker_id}",
                        "1")
                    return
                try:
                    payload = self.agent.key_value_get(
                        _task_key(gen, self.worker_id, seq),
                        timeout_s=poll_s)
                except CoordinationError:
                    continue             # no task yet: re-check shutdown
                fn, args, kwargs = pickle.loads(payload)
                try:
                    with telemetry_registry.timer(
                            "worker/closure_execution").time(), \
                        telemetry_events.span(
                            "worker.execute", worker=self.worker_id,
                            closure=seq,
                            span_id=closure_span_id(gen, self.worker_id,
                                                    seq)):
                        args = resolve_resources(args, self.resources)
                        kwargs = resolve_resources(kwargs, self.resources)
                        # the service instance is discoverable by closures
                        # that create worker-side resources
                        _CURRENT_SERVICE.service = self
                        with _on_lane(self.device):
                            result = fn(*args, **kwargs)
                    resp = pickle.dumps(("ok", result))
                    telemetry_registry.counter(
                        "worker/closures_executed").increment()
                except BaseException:
                    resp = pickle.dumps(("error", traceback.format_exc()))
                    telemetry_registry.counter(
                        "worker/closures_failed").increment()
                    telemetry_events.event("worker.closure_error",
                                           worker=self.worker_id, seq=seq)
                # The coordinator (sole watermark writer) advances
                # done/<w> as it consumes; the worker only publishes the
                # result and moves on.
                self.agent.key_value_set(
                    _result_key(gen, self.worker_id, seq), resp)
                seq += 1
        finally:
            self._stop.set()


def _own_device():
    """This worker process's device: its rank's, once the process group
    exists."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    return bootstrap._RUNTIME.device if bootstrap._RUNTIME is not None \
        else None


class _CurrentService(threading.local):
    service: "RemoteWorkerService | None" = None


_CURRENT_SERVICE = _CurrentService()


def current_worker_service() -> RemoteWorkerService | None:
    """Inside a remotely dispatched closure: the hosting service (for
    creating worker-side resources)."""
    return _CURRENT_SERVICE.service


def run_worker_loop(worker_id: int | None = None):
    """Entry point for a worker task: serve closures until shutdown.

    Usage (worker main, after ``bootstrap.initialize(device=)``)::

        if runtime.process_id != 0:
            remote_dispatch.run_worker_loop()
            return
    """
    RemoteWorkerService(worker_id).run()


def shutdown_workers(agent: CoordinationServiceAgent | None = None,
                     worker_ids: "list[int] | None" = None,
                     timeout_s: float = 15.0):
    """Coordinator-side: tell every worker service loop to return, then
    wait for acks — the coordinator hosts the coordination service, so it
    must not exit while workers still have RPCs in flight."""
    agent = agent or coordination_service()
    gen = _coordinator_generation(agent)
    agent.key_value_set(_shutdown_key(gen), "1")
    deadline = time.monotonic() + timeout_s
    pending = set(worker_ids or ())
    while pending and time.monotonic() < deadline:
        for wid in list(pending):
            if agent.key_value_try_get(
                    f"{_gen_dir(gen)}/shutdown_ack/{wid}") is not None:
                pending.discard(wid)
        if pending:
            time.sleep(0.05)
    # Retire this generation's namespace + the heartbeat keys (a
    # directory delete removes every key under it). The generation
    # counter itself survives: a later coordinator in the same job gets a
    # strictly newer incarnation.
    for key in (_gen_dir(gen), f"{_ROOT}/hb"):
        try:
            agent.key_value_delete(key)
        except Exception:
            pass

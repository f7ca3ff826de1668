"""ClusterCoordinator: closure queue + per-worker dispatch threads — port
of ``distributed_tensorflow_tpu/coordinator/cluster_coordinator.py`` (≙
the reference's ``coordinator/cluster_coordinator.py``).

The queue semantics are JAX's: ``schedule`` returns a
:class:`RemoteValue`; a :class:`WorkerPreemptionError` puts the
in-flight closure back at the head of the queue for another lane
(``put_back``); any other error cancels the pending closures and is
raised at the next ``schedule`` or ``join``; :class:`PerWorkerValues`
resolve to the running lane's own value.

A lane (:class:`Worker`) is a dispatch thread. A **thread lane** runs
its closures in this process on its device: lane ``i`` on card
``i % count`` (``torch.cuda.device``, and the lane's own CUDA stream,
which waits for the card's default stream before a closure and is
synchronised after it, so a closure's result is ready when its
``RemoteValue`` is), or on the CPU when the caller asks
(``device="cpu"``); tensors pass by reference. A **remote lane**
(``remote_worker_ids``) ships each closure by pickle to a worker process
over the coordination KV (:mod:`~distributed_tensorflow_tpu_torch.
coordinator.remote_dispatch`), never through a collective, so a killed
worker cannot hang the coordinator. Inside a closure
:func:`lane_device` is the device it runs on.
"""

from __future__ import annotations

import contextlib
import enum
import threading
from typing import Callable, Sequence

import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.coordinator import metric_utils
from distributed_tensorflow_tpu_torch.coordinator.watchdog import WatchDog
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.resilience.health import (
    WorkerHealthTracker)
from distributed_tensorflow_tpu_torch.resilience.retry import RetryPolicy
from distributed_tensorflow_tpu_torch.utils import tree


class WorkerPreemptionError(RuntimeError):
    """Retryable worker failure (≙ grpc UnavailableError in the
    reference): the closure is re-queued and run on another worker."""


class PSUnavailableError(RuntimeError):
    """Parameter-server state lost (≙ cluster_coordinator.py:130): not
    retryable — the user restores from a checkpoint."""


class ClosureCancelledError(RuntimeError):
    pass


_LANE = threading.local()


def lane_device() -> torch.device | None:
    """Inside a scheduled closure: the device of the lane running it (a
    thread lane's card or the CPU, a remote worker's own device); None
    elsewhere."""
    return getattr(_LANE, "device", None)


@contextlib.contextmanager
def _on_lane(device):
    prev = getattr(_LANE, "device", None)
    _LANE.device = device
    try:
        yield
    finally:
        _LANE.device = prev


class _Status(enum.Enum):
    PENDING = "pending"
    READY = "ready"
    ABORTED = "aborted"
    CANCELLED = "cancelled"


class RemoteValue:
    """Future for a scheduled closure's result (≙ remote_value.py)."""

    def __init__(self):
        self._status = _Status.PENDING
        self._value = None
        self._error: BaseException | None = None
        self._cv = threading.Condition()

    def _set_value(self, value):
        with self._cv:
            self._value = value
            self._status = _Status.READY
            self._cv.notify_all()

    def _set_error(self, err: BaseException):
        with self._cv:
            self._error = err
            self._status = _Status.ABORTED
            self._cv.notify_all()

    def _cancel(self):
        with self._cv:
            if self._status is _Status.PENDING:
                self._status = _Status.CANCELLED
                self._cv.notify_all()

    def fetch(self, timeout: float | None = None):
        """Block until ready; raises the closure's error if it failed."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._status is not _Status.PENDING, timeout)
            if self._status is _Status.PENDING:
                raise TimeoutError("RemoteValue not ready")
            if self._status is _Status.CANCELLED:
                raise ClosureCancelledError("closure cancelled")
            if self._status is _Status.ABORTED:
                raise self._error
            return self._value

    get = fetch


class PerWorkerValues:
    """One value per worker (≙ coordinator/values.py PerWorkerValues)."""

    def __init__(self, values: Sequence):
        self._values = tuple(values)

    @property
    def values(self) -> tuple:
        return self._values

    def __getitem__(self, i):
        return self._values[i]

    def __len__(self):
        return len(self._values)


def _is_pwv(v) -> bool:
    return isinstance(v, PerWorkerValues)


class Closure:
    """A schedulable unit (≙ cluster_coordinator.py:193)."""

    def __init__(self, fn: Callable, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}
        self.output = RemoteValue()

    def _resolved(self, worker: "Worker"):
        def resolve(v):
            return v.values[worker.worker_index] if _is_pwv(v) else v

        return (tree.tree_map(resolve, self.args, is_leaf=_is_pwv),
                tree.tree_map(resolve, self.kwargs, is_leaf=_is_pwv))

    def execute_on(self, worker: "Worker"):
        args, kwargs = self._resolved(worker)
        with worker.device_scope():
            result = self.fn(*args, **kwargs)
            worker.synchronize()
        self.output._set_value(result)

    def execute_remote(self, worker: "Worker"):
        """Ship to the worker's process; a ``WorkerPreemptionError``
        propagates to the caller for a transparent re-queue."""
        args, kwargs = self._resolved(worker)
        result = worker.lane.execute(self.fn, args, kwargs)
        self.output._set_value(result)

    def mark_cancelled(self):
        self.output._cancel()


class _CoordinatedClosureQueue:
    """Bounded closure queue with failure semantics
    (≙ cluster_coordinator.py:322): ``put``/``get`` with backpressure,
    ``put_back`` after a retryable worker failure (≙ :514),
    ``mark_failed`` cancels the pending closures and re-raises from
    ``wait``/``put``."""

    def __init__(self, max_pending: int = 1024):
        self._queue: list[Closure] = []
        self._inflight = 0
        self._error: BaseException | None = None
        self._cancelled = False
        self._max = max_pending
        self._cv = threading.Condition()
        self.closures_queued = metric_utils.Counter("closures_queued_total")
        self.closures_done = metric_utils.Counter("closures_done_total")
        self._gauge_queued = None
        self._gauge_inflight = None

    def attach_gauges(self, queued: "metric_utils.Gauge",
                      inflight: "metric_utils.Gauge"):
        """Wire the queued/inflight gauges to this queue's live depth."""
        with self._cv:
            self._gauge_queued = queued
            self._gauge_inflight = inflight
            self._update_gauges_locked()

    def _update_gauges_locked(self):
        if self._gauge_queued is not None:
            self._gauge_queued.set(len(self._queue))
        if self._gauge_inflight is not None:
            self._gauge_inflight.set(self._inflight)

    def _raise_if_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            self._cancelled = False
            raise err

    def put(self, closure: Closure):
        with self._cv:
            self._raise_if_error()
            self._cv.wait_for(lambda: len(self._queue) < self._max
                              or self._error is not None)
            self._raise_if_error()
            self._queue.append(closure)
            self.closures_queued.increment()
            self._update_gauges_locked()
            self._cv.notify_all()

    def get(self, timeout: float | None = None) -> Closure | None:
        with self._cv:
            self._cv.wait_for(lambda: bool(self._queue), timeout)
            if not self._queue:
                return None
            closure = self._queue.pop(0)
            self._inflight += 1
            self._update_gauges_locked()
            self._cv.notify_all()
            return closure

    def put_back(self, closure: Closure):
        with self._cv:
            self._inflight -= 1
            if self._cancelled:
                closure.mark_cancelled()
            else:
                self._queue.insert(0, closure)
            self._update_gauges_locked()
            self._cv.notify_all()

    def mark_finished(self, closure: Closure):
        with self._cv:
            self._inflight -= 1
            self.closures_done.increment()
            self._update_gauges_locked()
            self._cv.notify_all()

    def mark_failed(self, err: BaseException):
        with self._cv:
            self._error = err
            self._cancelled = True
            for c in self._queue:
                c.mark_cancelled()
            self._queue.clear()
            self._update_gauges_locked()
            self._cv.notify_all()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the queue is drained and nothing is in flight."""
        with self._cv:
            done = self._cv.wait_for(
                lambda: (not self._queue and self._inflight == 0)
                or self._error is not None, timeout)
            self._raise_if_error()
            return done

    def done(self) -> bool:
        with self._cv:
            self._raise_if_error()
            return not self._queue and self._inflight == 0

    def stop(self):
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()


class Worker:
    """One dispatch lane (≙ cluster_coordinator.py:1027): a thread pulling
    closures and running them on this lane's ``device`` — or, with a
    ``lane``, shipping them to a remote worker process."""

    def __init__(self, worker_index: int, cluster: "Cluster", device=None,
                 lane=None):
        self.worker_index = worker_index
        self.cluster = cluster
        self.device = torch.device(device) if device is not None else None
        self.lane = lane
        self.failures = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._process_queue, daemon=True,
            name=f"dtx-worker-{worker_index}")
        self.thread.start()

    @contextlib.contextmanager
    def device_scope(self):
        """The lane's card (current device and its own stream, which
        first waits for the card's default stream), or its CPU."""
        if self._stream is None:
            with _on_lane(self.device):
                yield
            return
        self._stream.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._stream), _on_lane(self.device):
            yield

    def synchronize(self):
        """Wait for the lane's stream: the closure's result is ready."""
        if self._stream is not None:
            self._stream.synchronize()

    def _process_queue(self):
        # ≙ Worker._process_queue (:1173)
        queue = self.cluster.closure_queue
        health = self.cluster.health
        while not self._stop.is_set():
            if health.is_quarantined(self.worker_index):
                # benched after repeated failures: leave the queue to
                # healthy lanes until the quarantine window expires
                self._stop.wait(0.1)
                continue
            if self.lane is not None and not self.lane.alive():
                # dead remote worker: pull nothing it cannot run; resumes
                # if the worker process heartbeats again
                self._stop.wait(0.5)
                continue
            closure = queue.get(timeout=0.2)
            if closure is None:
                continue
            self._process_closure(closure, queue)

    def _process_closure(self, closure: Closure, queue):
        try:
            with self.cluster.coordinator_metrics.closure_execution.time():
                faults.fire(
                    "closure.execute", tag=self.worker_index,
                    exc=WorkerPreemptionError,
                    msg=f"injected preemption on worker {self.worker_index}")
                if self.lane is not None:
                    closure.execute_remote(self)
                else:
                    closure.execute_on(self)
            queue.mark_finished(closure)
            self.cluster.health.record_success(self.worker_index)
        except WorkerPreemptionError as e:
            # ≙ WorkerPreemptionHandler.wait_on_failure (:879): retry on
            # another lane; this one backs off (quarantined if it keeps
            # failing)
            self.failures += 1
            self.cluster.health.record_failure(self.worker_index)
            telemetry.counter("coordinator/dispatch_retries",
                              "closures re-queued after worker "
                              "preemption").increment()
            telemetry.event("dispatch.retry", worker=self.worker_index,
                            error=str(e)[:200])
            queue.put_back(closure)
        except PSUnavailableError as e:
            closure.output._set_error(e)
            telemetry.event("dispatch.failure", worker=self.worker_index,
                            kind="ps_unavailable", error=str(e)[:200])
            queue.mark_failed(e)
        except BaseException as e:  # application error -> surface to user
            closure.output._set_error(e)
            telemetry.event("dispatch.failure", worker=self.worker_index,
                            kind=type(e).__name__, error=str(e)[:200])
            queue.mark_failed(e)

    def stop(self):
        self._stop.set()


def lane_devices(num_workers: int, device="cuda") -> list:
    """Thread lanes' devices: lane ``i`` on card ``i % count`` for
    ``"cuda"`` (raises without a card), every lane on the CPU for
    ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * num_workers
    if kind != "cuda":
        raise ValueError(f"device={device!r}; expected 'cuda' or 'cpu'")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' for CPU lanes")
    return [torch.device("cuda", i % n) for i in range(num_workers)]


class Cluster:
    """Owns the lanes and the closure queue (≙ cluster_coordinator.py:1247).
    ``remote_worker_ids``: the ranks of remote worker processes (each
    running ``remote_dispatch.run_worker_loop``); else ``num_workers``
    thread lanes on ``devices`` (default :func:`lane_devices`)."""

    def __init__(self, num_workers: int, devices=None,
                 remote_worker_ids: Sequence[int] | None = None,
                 health: WorkerHealthTracker | None = None, *,
                 device="cuda"):
        self.closure_queue = _CoordinatedClosureQueue()
        self.coordinator_metrics = metric_utils.CoordinatorMetrics()
        self.closure_queue.attach_gauges(self.coordinator_metrics.queued,
                                         self.coordinator_metrics.inflight)
        self.health = health or WorkerHealthTracker()
        n = (len(remote_worker_ids) if remote_worker_ids is not None
             else num_workers)
        for i in range(n):
            self.health.register(i)
        if remote_worker_ids is not None:
            from distributed_tensorflow_tpu_torch.coordinator \
                .remote_dispatch import RemoteLane
            self.workers = [
                Worker(i, self, lane=RemoteLane(pid))
                for i, pid in enumerate(remote_worker_ids)]
            return
        if devices is None:
            devices = lane_devices(num_workers, device)
        self.workers = [Worker(i, self, devices[i])
                        for i in range(num_workers)]

    def schedule(self, fn, args, kwargs) -> RemoteValue:
        closure = Closure(fn, args, kwargs)
        self.closure_queue.put(closure)
        return closure.output

    def join(self, timeout=None):
        self.closure_queue.wait(timeout)

    def done(self) -> bool:
        return self.closure_queue.done()

    def stop(self):
        self.closure_queue.stop()
        for w in self.workers:
            w.stop()


class _IteratorBuilder:
    """Picklable zero-arg factory rebuilding a worker-side iterator
    (attached to the handle so a restarted worker self-heals)."""

    def __init__(self, dataset_fn):
        self.dataset_fn = dataset_fn

    def __call__(self):
        return iter(self.dataset_fn())


def _create_worker_iterator(dataset_fn):
    """Runs ON the worker (remote dispatch): build the dataset there and
    register the live iterator, returning an opaque handle."""
    from distributed_tensorflow_tpu_torch.coordinator.remote_dispatch import (
        current_worker_service)
    builder = _IteratorBuilder(dataset_fn)
    return current_worker_service().create_resource(builder,
                                                    builder=builder)


def _create_worker_resource(resource_fn):
    """Runs ON the worker: build and register a per-worker resource
    (``resource_fn`` is its own rebuild factory)."""
    from distributed_tensorflow_tpu_torch.coordinator.remote_dispatch import (
        current_worker_service)
    return current_worker_service().create_resource(
        resource_fn, builder=resource_fn)


class ClusterCoordinator:
    """Async training driver (≙ cluster_coordinator.py:1399). ``device``
    places thread lanes (module docstring) when ``devices`` is not
    given; ``num_workers`` defaults to the strategy's cluster's worker
    count, else the visible cards."""

    def __init__(self, strategy=None, num_workers: int | None = None,
                 devices=None, watchdog_timeout: float = 300.0,
                 remote_worker_ids: Sequence[int] | None = None,
                 health: WorkerHealthTracker | None = None, *,
                 device="cuda"):
        self.strategy = strategy
        if num_workers is None:
            resolver = getattr(strategy, "cluster_resolver", None)
            if resolver is not None and resolver.cluster_spec():
                num_workers = resolver.cluster_spec().num_tasks("worker") or 1
            elif devices is not None:
                num_workers = len(devices)
            else:
                num_workers = (max(1, torch.cuda.device_count())
                               if torch.device(device).type == "cuda"
                               else 1)
        if remote_worker_ids is not None:
            num_workers = len(remote_worker_ids)
        self.cluster = Cluster(num_workers, devices,
                               remote_worker_ids=remote_worker_ids,
                               health=health, device=device)
        self._per_worker_resources: list = []
        self._watchdog = WatchDog(timeout=watchdog_timeout)

    @property
    def num_workers(self) -> int:
        return len(self.cluster.workers)

    def schedule(self, fn: Callable, args=(), kwargs=None) -> RemoteValue:
        self._watchdog.report_activity()
        return self.cluster.schedule(fn, args, kwargs)

    def join(self, timeout: float | None = None):
        self._watchdog.report_activity()
        self.cluster.join(timeout)

    def done(self) -> bool:
        return self.cluster.done()

    def worker_restarted(self, worker_id: int):
        """A worker's process was restarted: its quarantine and failure
        streak no longer describe it, so it goes straight back into
        rotation."""
        self.cluster.health.worker_restarted(worker_id)
        telemetry.event("dispatch.worker_restarted", worker=worker_id)

    def fetch(self, values, timeout: float | None = None):
        """Fetch RemoteValue(s), keeping the structure."""
        return tree.tree_map(
            lambda v: v.fetch(timeout) if isinstance(v, RemoteValue) else v,
            values, is_leaf=lambda v: isinstance(v, RemoteValue))

    def create_per_worker_dataset(self, dataset_fn: Callable
                                  ) -> PerWorkerValues:
        """≙ create_per_worker_dataset (:1604): one iterator a worker.
        With remote lanes each iterator is built and lives ON its worker
        process (closures get a self-healing handle); thread lanes keep
        coordinator-side iterators."""
        if any(w.lane is not None for w in self.cluster.workers):
            return PerWorkerValues(self._create_on_workers(
                _create_worker_iterator, (dataset_fn,)))
        return PerWorkerValues([iter(dataset_fn())
                                for _ in range(self.num_workers)])

    def _create_on_workers(self, fn, args, *, attempts: int = 3,
                           timeout_s: float = 120.0) -> list:
        """A pinned closure on EVERY remote lane in parallel (publish
        all, then gather), retried per worker on preemption under the
        shared RetryPolicy."""
        policy = RetryPolicy(max_attempts=attempts,
                             retryable=(WorkerPreemptionError,))
        lanes = [w.lane for w in self.cluster.workers]
        seqs = [lane.submit(fn, args, {}) for lane in lanes]
        results: list = [None] * len(lanes)
        for i, (lane, seq) in enumerate(zip(lanes, seqs)):
            pending = {"seq": seq}

            def gather(lane=lane, pending=pending):
                return lane.wait(pending["seq"], timeout_s=timeout_s)

            def resubmit(exc, attempt, lane=lane, pending=pending):
                pending["seq"] = lane.submit(fn, args, {})

            try:
                results[i] = policy.call(gather, on_retry=resubmit)
            except WorkerPreemptionError as e:
                raise WorkerPreemptionError(
                    f"worker {lane.worker_id} unavailable after "
                    f"{attempts} attempts creating a per-worker "
                    f"resource") from e
        return results

    def create_per_worker_resource(self, resource_fn: Callable
                                   ) -> PerWorkerValues:
        """One resource a worker; with remote lanes it is built and
        lives ON the worker process, like per-worker datasets."""
        if any(w.lane is not None for w in self.cluster.workers):
            vals = PerWorkerValues(self._create_on_workers(
                _create_worker_resource, (resource_fn,)))
        else:
            vals = PerWorkerValues([resource_fn()
                                    for _ in range(self.num_workers)])
        self._per_worker_resources.append(vals)
        return vals

    def shutdown(self):
        lanes = [w.lane for w in self.cluster.workers if w.lane is not None]
        if lanes:
            from distributed_tensorflow_tpu_torch.coordinator \
                .remote_dispatch import shutdown_workers
            # wait only on the live workers' acks: a killed one would
            # stall shutdown to the timeout
            shutdown_workers(
                worker_ids=[lane.worker_id for lane in lanes
                            if lane.alive()])
        self.cluster.stop()
        self._watchdog.stop()

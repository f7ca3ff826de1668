"""Port parity: the ``ClusterCoordinator`` with thread lanes
(``coordinator/cluster_coordinator.py``) on the queue semantics of the
JAX package's ``tests/test_coordinator.py`` — schedule and fetch, a
``WorkerPreemptionError`` re-run on another lane, the first application
error raised at ``fetch`` and ``join`` and the queued closures behind it
cancelled, ``PSUnavailableError`` fatal, per-worker values, datasets and
resources, FIFO on one lane, the watchdog and the metrics — and the
coordinator's dependencies against JAX's exactly: ``RetryPolicy`` /
``Backoff`` sequences from a seed and ``WorkerHealthTracker``
quarantine under the same clock. Lanes run on the CPU here
(``device="cpu"``); the default is the card, which raises without one.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.resilience import health as jhealth
from distributed_tensorflow_tpu.resilience import retry as jretry
from distributed_tensorflow_tpu_torch.coordinator import cluster_coordinator
from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator import (
    ClosureCancelledError, ClusterCoordinator, PerWorkerValues,
    PSUnavailableError, WorkerPreemptionError, lane_device)
from distributed_tensorflow_tpu_torch.coordinator.watchdog import WatchDog
from distributed_tensorflow_tpu_torch.resilience import health as thealth
from distributed_tensorflow_tpu_torch.resilience import retry as tretry


@pytest.fixture()
def coord():
    c = ClusterCoordinator(num_workers=4, device="cpu")
    yield c
    c.shutdown()


def test_schedule_and_fetch(coord):
    rv = coord.schedule(lambda x: x * 2, args=(21,))
    assert coord.fetch(rv) == 42
    assert coord.fetch({"a": [rv, 3]}) == {"a": [42, 3]}


def test_lanes_run_on_their_device(coord):
    got = {coord.schedule(lambda: lane_device()).fetch(timeout=10)
           for _ in range(8)}
    assert got == {torch.device("cpu")}
    assert lane_device() is None


def test_default_lanes_are_cards():
    if torch.cuda.is_available():
        pytest.skip("has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterCoordinator(num_workers=2)
    assert cluster_coordinator.lane_devices(3, "cpu") == \
        [torch.device("cpu")] * 3


def test_schedule_many_join(coord):
    results = [coord.schedule(lambda i=i: i * i) for i in range(32)]
    coord.join()
    assert coord.done()
    assert [r.fetch() for r in results] == [i * i for i in range(32)]


def test_parallel_dispatch_uses_multiple_workers(coord):
    seen = set()
    lock = threading.Lock()

    def fn():
        with lock:
            seen.add(threading.current_thread().name)
        time.sleep(0.05)

    for _ in range(16):
        coord.schedule(fn)
    coord.join()
    assert len(seen) > 1


def test_worker_preemption_retries(coord):
    attempts = {"n": 0}
    lock = threading.Lock()

    def flaky():
        with lock:
            attempts["n"] += 1
            if attempts["n"] <= 2:
                raise WorkerPreemptionError("worker gone")
        return "ok"

    rv = coord.schedule(flaky)
    assert rv.fetch(timeout=10) == "ok"
    assert attempts["n"] == 3
    coord.join()
    assert sum(w.failures for w in coord.cluster.workers) == 2


def test_application_error_propagates_and_cancels():
    coord = ClusterCoordinator(num_workers=1, device="cpu")
    gate = threading.Event()
    try:
        def boom():
            gate.wait(10)
            raise ValueError("bad step")

        rv = coord.schedule(boom)
        queued = [coord.schedule(lambda: 1) for _ in range(3)]
        gate.set()
        with pytest.raises(ValueError, match="bad step"):
            rv.fetch(timeout=10)
        for q in queued:
            with pytest.raises(ClosureCancelledError):
                q.fetch(timeout=10)
        with pytest.raises(ValueError):
            coord.join()
        # once the error is consumed the coordinator is usable again
        assert coord.schedule(lambda: 1).fetch(timeout=10) == 1
    finally:
        coord.shutdown()


def test_ps_unavailable_fatal(coord):
    def lose_ps():
        raise PSUnavailableError("ps0 lost")

    rv = coord.schedule(lose_ps)
    with pytest.raises(PSUnavailableError):
        rv.fetch(timeout=10)
    with pytest.raises(PSUnavailableError):
        coord.join()


def test_per_worker_values_resolve_to_the_running_lane(coord):
    pw = PerWorkerValues([f"res{i}" for i in range(4)])

    def fn(res):
        idx = int(threading.current_thread().name.rsplit("-", 1)[1])
        return idx, res

    for _ in range(12):
        idx, res = coord.schedule(fn, args=({"r": [pw]},)).fetch(timeout=10)
        assert res == {"r": [f"res{idx}"]}


def test_per_worker_dataset_and_resource(coord):
    pwds = coord.create_per_worker_dataset(
        lambda: iter([np.arange(4) + 4 * i for i in range(25)]))
    assert len(pwds) == 4
    rv = coord.schedule(lambda it: int(np.asarray(next(it)).sum()),
                        args=(pwds,))
    assert rv.fetch(timeout=10) == 0 + 1 + 2 + 3
    made = []
    res = coord.create_per_worker_resource(lambda: made.append(1) or
                                           len(made))
    assert list(res.values) == [1, 2, 3, 4]


def test_worker_restarted_unbenches_quarantined_lane(coord):
    health = coord.cluster.health
    for _ in range(health.failure_threshold):
        health.record_failure(0)
    assert health.is_quarantined(0)
    coord.worker_restarted(0)
    assert not health.is_quarantined(0)
    assert coord.schedule(lambda: 7).fetch(timeout=10) == 7


def test_per_worker_closures_run_in_fifo_order():
    order = []
    lock = threading.Lock()
    coord = ClusterCoordinator(num_workers=1, device="cpu")

    def make(i):
        def fn():
            with lock:
                order.append(i)
            return i
        return fn

    rvs = [coord.schedule(make(i)) for i in range(20)]
    coord.join()
    assert coord.fetch(rvs) == list(range(20))
    assert order == list(range(20))
    coord.shutdown()


def test_injected_preemption_is_retried(coord):
    from distributed_tensorflow_tpu_torch.resilience import faults
    schedule = faults.FaultSchedule(rules=(faults.FaultRule.from_dict(
        {"site": "closure.execute", "action": "raise", "hits": [1, 2]}),))
    with faults.inject(schedule):
        assert coord.schedule(lambda: 5).fetch(timeout=10) == 5
    assert sum(w.failures for w in coord.cluster.workers) == 2


def test_watchdog_triggers_and_stops():
    fired = threading.Event()
    w = WatchDog(timeout=0.3, on_triggered=fired.set, output=io.StringIO())
    assert fired.wait(5)
    w.stop()
    assert w.triggered_count >= 1 and not w._thread.is_alive()
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("hook error")

    with WatchDog(timeout=0.2, on_triggered=boom,
                  output=io.StringIO()) as w2:
        deadline = time.time() + 10
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.05)
    assert len(calls) >= 2 and not w2._thread.is_alive()


def test_metrics(coord):
    from distributed_tensorflow_tpu_torch.coordinator.metric_utils import (
        Counter, Timer)
    from distributed_tensorflow_tpu_torch.telemetry import registry
    c = Counter("c")
    c.increment()
    c.increment(2)
    assert c.value == 3
    t = Timer("t")
    with t.time():
        time.sleep(0.01)
    assert t.count == 1 and t.total_seconds > 0.005
    for _ in range(3):
        coord.schedule(lambda: None)
    coord.join()
    snap = registry.get_registry().snapshot()
    assert snap["coordinator/closures_done_total"]["value"] >= 3
    assert snap["coordinator/queued_closures"]["value"] == 0


POLICIES = {
    "exp": dict(initial_backoff_s=0.1, backoff_multiplier=2.0,
                max_backoff_s=1.0),
    "jitter": dict(initial_backoff_s=0.1, jitter=0.5, seed=3),
    "decorrelated": dict(initial_backoff_s=0.05, decorrelated=True,
                         max_backoff_s=2.0, seed=11),
    "zero": dict(initial_backoff_s=0.0),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_backoff_sequences_match_jax(name):
    seqs = []
    for mod in (jretry, tretry):
        b = mod.Backoff(mod.RetryPolicy(**POLICIES[name]))
        seq = [b.next_s() for _ in range(12)]
        b.reset()
        seq += [b.next_s() for _ in range(3)]
        seq += [mod.RetryPolicy(**POLICIES[name]).backoff_s(a)
                for a in range(1, 6)]
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_retry_policy_call_matches_jax(monkeypatch):
    runs = []
    for mod in (jretry, tretry):
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        events = []

        def fn(n={"i": 0}):
            n["i"] += 1
            if n["i"] < 4:
                raise KeyError(n["i"])
            return n["i"]

        pol = mod.RetryPolicy(max_attempts=5, initial_backoff_s=0.1,
                              jitter=0.3, seed=5, retryable=(KeyError,))
        out = pol.call(fn, on_retry=lambda e, a: events.append(a))
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=3).call(
                lambda: (_ for _ in ()).throw(ValueError("x")),
                retryable=(KeyError,))
        runs.append((out, events, slept))
    assert runs[0] == runs[1]


def test_health_tracker_quarantine_matches_jax():
    snaps = []
    for mod in (jhealth, thealth):
        now = {"t": 0.0}
        h = mod.WorkerHealthTracker(failure_threshold=2, quarantine_s=5.0,
                                    time_fn=lambda: now["t"])
        log = []
        for w in range(3):
            h.register(w)
        for step in [("f", 0), ("f", 0), ("f", 1), ("s", 1), ("f", 1),
                     ("f", 1), ("f", 2), ("f", 2), ("t", 6.0), ("f", 0),
                     ("r", 1), ("s", 2)]:
            kind, arg = step
            if kind == "f":
                log.append(h.record_failure(arg))
            elif kind == "s":
                h.record_success(arg)
            elif kind == "r":
                h.worker_restarted(arg)
            else:
                now["t"] += arg
            log.append((h.healthy_workers(),
                        [h.is_quarantined(w) for w in range(3)]))
        snaps.append((log, h.snapshot()))
    assert snaps[0] == snaps[1]

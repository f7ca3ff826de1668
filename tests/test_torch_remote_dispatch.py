"""Port parity: remote lanes (``coordinator/remote_dispatch.py``) — a
coordinator and 2 gloo worker processes started by the port's
``MultiProcessRunner`` from ``TF_CONFIG``: remote closures, per-worker
datasets and resources living on the workers behind handles, a remote
error, JAX's 4 MiB payload cap, and the kill-failover of JAX's
``tests/test_multi_process.py:502`` (worker 2 killed through
``MultiProcessRunner.terminate`` with closures in flight: every closure
still completes, re-run on the survivor). The KV keys of one closure's
round trip equal JAX's letter for letter (the generation number
aside)."""

import re
import threading
import time

import pytest

from distributed_tensorflow_tpu.coordinator import remote_dispatch as jrd
from distributed_tensorflow_tpu_torch.coordinator import remote_dispatch as trd
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_cluster_ranks


def _cluster(tmp_path, kill: bool):
    spec = multi_process_runner.create_cluster_spec(num_workers=3)
    runner = multi_process_runner.MultiProcessRunner(
        torch_cluster_ranks.remote_dispatch_task, spec,
        args=(str(tmp_path), kill), device="cpu", timeout=180)
    runner.start()
    if kill:
        deadline = time.monotonic() + 120
        while not (tmp_path / "kill_now").exists():
            assert time.monotonic() < deadline, "coordinator never signalled"
            time.sleep(0.05)
        time.sleep(0.2)                 # worker 2 holds a closure
        runner.terminate("worker", 2)
        assert runner.poll()[("worker", 2)] != 0
    return runner.join(timeout=180, raise_on_error=not kill)


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    result = _cluster(tmp_path_factory.mktemp("rd"), kill=False)
    return result.return_values


def test_remote_closures(basic):
    coord = [v for v in basic if v[0] == "coordinator"][0][1]
    assert coord["values"] == [i * i for i in range(10)]
    assert coord["devices"] == "cpu"
    assert sorted(v[1] for v in basic if v[0] == "worker-done") == [1, 2]


def test_per_worker_datasets_and_resources_live_on_workers(basic):
    coord = [v for v in basic if v[0] == "coordinator"][0][1]
    assert coord["handles"] == ["_ResourceHandle"] * 2
    vals = coord["dataset"]
    assert all(v in (100, 200, 300, 400) for v in vals) and vals[0] == 100
    # two counters on two workers: 6 bumps give 1..k and 1..6-k
    res = coord["resource"]
    assert len(res) == 6 and res.count(1) == 2


def test_remote_error_and_payload_cap(basic):
    coord = [v for v in basic if v[0] == "coordinator"][0][1]
    assert coord["error"] is True and coord["cap"] is True
    assert trd.MAX_PAYLOAD_BYTES == jrd.MAX_PAYLOAD_BYTES == 4 << 20


def test_kill_failover(tmp_path):
    result = _cluster(tmp_path, kill=True)
    coord = [t for t in result.tasks.values()
             if t.error is None and t.exitcode == 0 and t.value
             and t.value[0] == "coordinator"]
    assert coord, {k: (t.exitcode, t.error and t.error[-500:])
                   for k, t in result.tasks.items()}
    assert coord[0].value[1]["values"] == list(range(10))
    assert coord[0].value[1]["retries"] >= 1
    assert result.tasks[("worker", 2)].exitcode != 0
    assert result.tasks[("worker", 1)].value == ("worker-done", 1)


def _keys_of_one_round_trip(mod, coordination):
    """Every key one closure's round trip touches, in one process on the
    local service: a worker service thread and a lane."""
    agent = coordination.coordination_service()
    seen = []
    real = {}
    for name in ("key_value_set", "key_value_get", "key_value_try_get",
                 "key_value_delete", "key_value_increment"):
        fn = getattr(agent, name)
        real[name] = fn

        def wrap(key, *a, _fn=fn, **k):
            seen.append(key)
            return _fn(key, *a, **k)
        setattr(agent, name, wrap)
    try:
        mod._reset_generation_for_tests()
        svc = mod.RemoteWorkerService(worker_id=1, agent=agent)
        t = threading.Thread(target=svc.run, kwargs={"poll_s": 0.1},
                             daemon=True)
        lane = mod.RemoteLane(1, agent=agent)
        t.start()
        assert lane.execute(torch_cluster_ranks._square, (3,), {}) == 9
        mod.shutdown_workers(agent, worker_ids=[1])
        t.join(10)
    finally:
        for name, fn in real.items():
            setattr(agent, name, fn)
        mod._reset_generation_for_tests()
    return {re.sub(r"/g\d+", "/g<G>", k) for k in seen}


def test_kv_key_layout_matches_jax():
    from distributed_tensorflow_tpu.cluster import coordination as jco
    from distributed_tensorflow_tpu_torch.cluster import coordination as tco
    want = _keys_of_one_round_trip(jrd, jco)
    assert _keys_of_one_round_trip(trd, tco) == want
    for fn in ("_hb_key", "_gen_dir", "_shutdown_key"):
        assert getattr(trd, fn)(3) == getattr(jrd, fn)(3)
    for fn in ("_task_key", "_result_key"):
        assert getattr(trd, fn)(2, 1, 7) == getattr(jrd, fn)(2, 1, 7)
    assert trd._done_key(2, 1) == jrd._done_key(2, 1)
    assert trd.closure_span_id(2, 1, 7) == jrd.closure_span_id(2, 1, 7)

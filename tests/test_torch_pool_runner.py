"""The port's ``MultiProcessPoolRunner`` on JAX's pool cases
(``tests/test_multi_process.py``): consecutive runs land on the same
processes, a fresh cluster (gloo group, coordination KV and barriers)
comes up on every run, a raising task leaves the pool usable, a child
that died while idle is replaced at the next run, and a run's ``env``
does not leak into the next."""

import pytest

from distributed_tensorflow_tpu_torch.testing import multi_process_runner as mpr

import torch_pool_ranks as ranks


@pytest.fixture(scope="module")
def pool2():
    pool = mpr.MultiProcessPoolRunner(num_workers=2, device="cpu")
    yield pool
    pool.shutdown()


def test_pool_reuses_processes_across_runs(pool2):
    pids1 = sorted(pool2.run(ranks.own_pid, timeout=60).return_values)
    pids2 = sorted(pool2.run(ranks.own_pid, timeout=60).return_values)
    assert pids1 == pids2 and len(pids1) == 2
    r = pool2.run(ranks.allreduce_worker, timeout=120)
    assert sorted(r.return_values) == [(0, 2, 3.0), (1, 2, 3.0)]
    assert sorted(pool2.run(ranks.own_pid, timeout=60).return_values) == \
        pids1


def test_kv_store_barrier_increment(pool2):
    vals = pool2.run(ranks.kv_barrier_worker, timeout=120).return_values
    assert sorted(v[0] for v in vals) == ["hello-0", "hello-1"]
    assert sorted(v[1] for v in vals) == [1, 2]
    assert all(v[2] == 2 for v in vals)


def test_barrier_timeout_fails_fast(pool2):
    r = pool2.run(ranks.barrier_timeout_worker, timeout=120)
    assert sorted(r.return_values) == ["skipped", "timeout"]


def test_pool_task_error_does_not_break_pool(pool2):
    before = sorted(pool2.run(ranks.own_pid, timeout=60).return_values)
    with pytest.raises(mpr.SubprocessError, match="intentional"):
        pool2.run(ranks.raise_worker, timeout=60)
    assert sorted(pool2.run(ranks.own_pid, timeout=60).return_values) == \
        before


def test_run_env_does_not_leak(pool2):
    got = pool2.run(ranks.env_worker, args=("DTX_POOL_PROBE",),
                    env={"DTX_POOL_PROBE": "1"}, timeout=60).return_values
    assert got == ["1", "1"]
    assert pool2.run(ranks.env_worker, args=("DTX_POOL_PROBE",),
                     timeout=60).return_values == [None, None]


def test_pool_restarts_after_idle_child_death(pool2):
    pids = sorted(pool2.run(ranks.own_pid, timeout=60).return_values)
    pool2._procs[("worker", 0)].kill()
    pool2._procs[("worker", 0)].join(10)
    pids2 = sorted(pool2.run(ranks.own_pid, timeout=120).return_values)
    assert len(pids2) == 2 and pids2 != pids
    r = pool2.run(ranks.allreduce_worker, timeout=120)
    assert sorted(r.return_values) == [(0, 2, 3.0), (1, 2, 3.0)]

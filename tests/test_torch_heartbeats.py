"""The port's ``resilience/heartbeats.py`` held to the JAX package's:
the same key strings and shard layout; the same KV operations and
values from a ``ShardedHeartbeatPublisher`` and the same ``read_all``
(summary reads, and the per-member fallback when a shard's reducer is
dead or its summary stale) on one recorded agent; per-task heartbeat
files written by either package's ``elastic.heartbeat`` read the same
through either ``FileHeartbeatSource``; and the sharded transport over
the port's own coordination agent, generation namespaces included."""

import pytest

from distributed_tensorflow_tpu.cluster import elastic as jax_elastic
from distributed_tensorflow_tpu.resilience import heartbeats as jax_hb
from distributed_tensorflow_tpu_torch.cluster import elastic as pt_elastic
from distributed_tensorflow_tpu_torch.resilience import heartbeats as pt_hb


class _RecordingKV:
    """A dict agent that logs every operation."""

    def __init__(self, pid: int = 0, n: int = 1):
        self.kv: dict = {}
        self.ops: list = []
        self.process_id, self.num_processes = pid, n

    def key_value_set(self, key, value):
        value = value.encode() if isinstance(value, str) else value
        self.ops.append(("set", key, value))
        self.kv[key] = value

    def key_value_try_get(self, key):
        self.ops.append(("get", key))
        return self.kv.get(key)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_keys_and_shards():
    for pid, size, n in ((0, 32, 1), (37, 8, 100), (99, 32, 100),
                         (5, 1, 6)):
        for prefix in ("fleet", "data/job7"):
            assert pt_hb.hb_key(pt_hb.shard_of(pid, size), pid,
                                prefix=prefix) == \
                jax_hb.hb_key(jax_hb.shard_of(pid, size), pid,
                              prefix=prefix)
            assert pt_hb.sum_key(3, prefix=prefix) == \
                jax_hb.sum_key(3, prefix=prefix)
        assert pt_hb.num_shards(n, size) == jax_hb.num_shards(n, size)
        assert list(pt_hb.shard_members(1, size, n)) == \
            list(jax_hb.shard_members(1, size, n))
    assert pt_hb.hb_key(2, 70) == "fleet/hb/2/70"
    assert pt_hb.sum_key(2) == "fleet/hbsum/2"


def _sharded_run(mod, monkeypatch, dead_reducer: bool):
    clock = _Clock()
    monkeypatch.setattr(mod.time, "time", clock)
    agent = _RecordingKV()
    n, size = 10, 4
    src = mod.ShardedKVHeartbeats(agent, shard_size=size,
                                  summary_stale_s=2.0)
    pubs = [src.publisher(pid, n) for pid in range(n)]
    reads = []
    for step in range(6):
        clock.t += 0.5
        for p in pubs:
            if dead_reducer and p.pid == 4 and step >= 2:
                continue                 # shard 1's reducer died
            if p.pid == 9 and step >= 4:
                continue                 # a plain member died
            p.beat(step)
        reads.append(src.read_all(n))
    clock.t += 3.0                       # every summary goes stale
    reads.append(src.read_all(n))
    return agent.ops, reads, (src.reads_summary, src.reads_fallback)


@pytest.mark.parametrize("dead_reducer", [False, True])
def test_sharded_kv_transport(monkeypatch, dead_reducer):
    jax_run = _sharded_run(jax_hb, monkeypatch, dead_reducer)
    pt_run = _sharded_run(pt_hb, monkeypatch, dead_reducer)
    assert pt_run == jax_run
    if dead_reducer:
        assert jax_run[2][1] > 0         # fell back to member reads


def _write(elastic_mod, monkeypatch, sup_dir, task, step):
    monkeypatch.setenv("DTX_SUPERVISOR_DIR", str(sup_dir))
    monkeypatch.setenv("DTX_MPR_TASK_INDEX", str(task))
    elastic_mod.heartbeat(step)


def test_file_heartbeats_read_both_ways(tmp_path, monkeypatch):
    _write(jax_elastic, monkeypatch, tmp_path, 0, 12)
    _write(pt_elastic, monkeypatch, tmp_path, 1, 7)
    _write(pt_elastic, monkeypatch, tmp_path, 3, None)
    jsrc = jax_hb.FileHeartbeatSource(str(tmp_path))
    psrc = pt_hb.FileHeartbeatSource(str(tmp_path))
    got = psrc.read_all(4)
    assert got == jsrc.read_all(4)
    assert sorted(got) == [0, 1, 3]
    assert got[0][1] == 12 and got[1][1] == 7 and got[3][1] is None
    psrc.clear(4)
    assert jsrc.read_all(4) == {}


def test_sharded_over_port_agent():
    """The port's in-process coordination agent: beats of generation 2
    land under ``gen2/``, a reader of generation 0 sees none of them."""
    from distributed_tensorflow_tpu_torch.cluster import coordination
    agent = coordination.coordination_service()
    src = pt_hb.ShardedKVHeartbeats(agent, shard_size=2,
                                    key_prefix="hbtest")
    src.generation = 2
    with pt_elastic.generation_override(2):
        pubs = [src.publisher(pid, 3) for pid in range(3)]
        for _ in range(2):      # a reducer folds what its shard wrote
            for p in pubs:
                p.beat(5)
        assert agent.key_value_try_get("hbtest/hbsum/0") is not None
    assert agent.key_value_try_get("gen2/hbtest/hbsum/0") is not None
    got = src.read_all(3)
    assert sorted(got) == [0, 1, 2] and {v[1] for v in got.values()} == {5}
    src.generation = 0
    assert src.read_all(3) == {}

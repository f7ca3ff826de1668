"""The port's disaggregated data service (``input/split_provider.py``,
``input/data_service.py``) held to the JAX package's: the same KV keys,
split universe and seeded epoch orders, the same payload bytes for the
same split, a JAX-written epoch read by the port's client and a
port-written one by JAX's (over one in-memory KV), and under a seeded
``data.worker_step`` crash every split delivered exactly once, element
for element as JAX's ``DataServiceSim`` delivers it."""

import json
import threading

import numpy as np
import pytest

from distributed_tensorflow_tpu.input import data_service as jax_ds
from distributed_tensorflow_tpu.input.dataset import Dataset as JDataset
from distributed_tensorflow_tpu.input.split_provider import (
    SplitProvider as JProvider)
from distributed_tensorflow_tpu.testing import fleet_sim as jax_fs
from distributed_tensorflow_tpu_torch.cluster import coordination as pt_coord
from distributed_tensorflow_tpu_torch.input import data_service as pt_ds
from distributed_tensorflow_tpu_torch.input.dataset import Dataset as PDataset
from distributed_tensorflow_tpu_torch.input.split_provider import (
    SplitProvider as PProvider)
from distributed_tensorflow_tpu_torch.testing import fleet_sim as pt_fs


def _write_files(tmp_path, n=6, rows=5):
    files = []
    rng = np.random.default_rng(0)
    for i in range(n):
        path = str(tmp_path / f"shard-{i}.npy")
        np.save(path, rng.integers(0, 1000, (rows, 3)))
        files.append(path)
    return files


def _reader(path):
    yield from np.load(path)


def _providers(files):
    def pipeline(ds_cls):
        return (ds_cls.from_files(files, _reader)
                .map(lambda r: r * 2).batch(2))
    return (PProvider.from_dataset(pipeline(PDataset), seed=7),
            JProvider.from_dataset(pipeline(JDataset), seed=7))


def _eq_elements(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_keys_equal_jax():
    for job in ("default", "headline"):
        a, b = pt_ds.DataServiceConfig(job=job), jax_ds.DataServiceConfig(
            job=job)
        assert a == pt_ds.DataServiceConfig(**b.__dict__)
        assert pt_ds._spec_key(a) == jax_ds._spec_key(b)
        assert pt_ds._assign_key(a, 1, 3) == jax_ds._assign_key(b, 1, 3)
        assert pt_ds._done_key(a, 0, 5) == jax_ds._done_key(b, 0, 5)
        assert pt_ds._chunk_key(a, 2, 5, 1, 0) == \
            jax_ds._chunk_key(b, 2, 5, 1, 0)
        assert pt_ds._epoch_complete_key(a, 4) == \
            jax_ds._epoch_complete_key(b, 4)
        assert pt_ds._shutdown_key(a) == jax_ds._shutdown_key(b)


def test_split_provider_equal_jax(tmp_path):
    files = _write_files(tmp_path)
    pt, jx = _providers(files)
    assert pt.num_splits == jx.num_splits == len(files)
    for e in range(4):
        assert pt.epoch_order(e) == jx.epoch_order(e)
    for s in range(pt.num_splits):
        _eq_elements(pt.elements(s), jx.elements(s))
    with pytest.raises(ValueError, match="out of range"):
        pt.build(99)
    with pytest.raises(ValueError, match="file source"):
        PProvider.from_dataset(PDataset.from_generator(lambda: iter([1])))


def test_payload_bytes_equal_jax(tmp_path):
    """One split processed by each package's worker: the same chunk and
    done records, byte for byte, also across a chunk boundary."""
    files = _write_files(tmp_path)
    pt, jx = _providers(files)
    kvs = []
    for ds, prov, fs in ((pt_ds, pt, pt_fs), (jax_ds, jx, jax_fs)):
        cfg = ds.DataServiceConfig(job="b", chunk_bytes=100)
        (agent,) = fs.make_sim_cluster(1)
        ds.register_job(agent, cfg, prov, epochs=1, num_workers=1)
        w = ds.DataInputWorker(agent, prov, cfg, worker_id=0,
                               num_workers=1, epochs=1)
        w._process(0, 3)
        kvs.append(dict(agent._local._kv))
    assert kvs[0] == kvs[1]
    assert sum(k.startswith("data/b/e0/s3/w0/c") for k in kvs[0]) > 1


def _serve(disp_ds, worker_ds, client_ds, provider, worker_fs, n=3,
           epochs=2):
    """A dispatcher, ``n`` worker threads and a client over ONE
    in-memory KV, each side from the package given."""
    service = pt_coord._LocalService()

    def agent(fs, p):
        return fs.SimAgent(service, p, n + 2)
    cfg = disp_ds.DataServiceConfig(job="x", lease_timeout_s=0.4,
                                    poll_interval_s=0.01,
                                    fetch_timeout_s=20.0)
    disp = disp_ds.DataServiceDispatcher(
        agent(pt_fs if disp_ds is pt_ds else jax_fs, n), provider[0], cfg,
        num_workers=n, epochs=epochs)
    stop = threading.Event()
    threads = []
    wcfg = worker_ds.DataServiceConfig(**cfg.__dict__)
    for w in range(n):
        iw = worker_ds.DataInputWorker(agent(worker_fs, w), provider[1],
                                       wcfg, worker_id=w, num_workers=n,
                                       epochs=epochs)
        t = threading.Thread(target=iw.run, args=(stop,), daemon=True)
        t.start()
        threads.append(t)
    disp.start()
    ccfg = client_ds.DataServiceConfig(**cfg.__dict__)
    client = client_ds.DataServiceClient(
        agent(pt_fs if client_ds is pt_ds else jax_fs, n + 1), ccfg)
    try:
        per_epoch = [list(client.epoch(e)) for e in range(epochs)]
    finally:
        client_ds.signal_shutdown(client.agent, ccfg)
        stop.set()
        disp.stop()
        for t in threads:
            t.join(timeout=5.0)
    return per_epoch


def _sorted_bytes(elements):
    return sorted(np.asarray(x).tobytes() for x in elements)


@pytest.mark.parametrize("side", ["jax_workers_port_client",
                                  "port_workers_jax_client"])
def test_epochs_cross_both_packages(tmp_path, side):
    files = _write_files(tmp_path)
    pt, jx = _providers(files)
    direct = [x for s in range(pt.num_splits) for x in pt.elements(s)]
    if side == "jax_workers_port_client":
        got = _serve(pt_ds, jax_ds, pt_ds, (pt, jx), jax_fs)
    else:
        got = _serve(jax_ds, pt_ds, jax_ds, (jx, pt), pt_fs)
    for epoch in got:
        assert _sorted_bytes(epoch) == _sorted_bytes(direct)


def test_exactly_once_under_a_worker_crash_equals_jax():
    out = {}
    for name, fs in (("pt", pt_fs), ("jax", jax_fs)):
        sched = fs.seeded_data_kill_schedule(3, 4, kills=1)
        rep = fs.DataServiceSim(4, 12, epochs=2, elements_per_split=3,
                                fault_schedule=sched, lease_timeout_s=0.3,
                                seed=3).run()
        assert rep.completed, rep.error
        out[name] = rep
    pt, jx = out["pt"], out["jax"]
    assert pt.epoch_multisets == jx.epoch_multisets
    assert pt.duplicate_elements == pt.missing_elements == 0
    assert pt.workers_died == jx.workers_died and len(pt.workers_died) == 1
    assert pt.faults_fired == jx.faults_fired
    assert pt.splits_reassigned >= 1 and jx.splits_reassigned >= 1
    assert pt.elements_delivered == jx.elements_delivered == 72
    assert pt.rollup_workers_seen == jx.rollup_workers_seen
    assert json.dumps(sorted(pt.to_row())) == json.dumps(
        sorted(jx.to_row()))

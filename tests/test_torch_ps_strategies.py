"""Port parity: the parameter-server family — the partitioners and
``ShardedVariable`` (``parallel/sharded_variable.py``),
``AggregatingVariable`` / ``CachingVariable`` (``parallel/
ps_values.py``), ``CentralStorageStrategy``, ``ParameterServerStrategy``
V1 and V2 and ``TPUStrategy`` — against the JAX package on the same
numpy-seeded values. Shard sizes are exactly equal; every host-visible
value (reads, assigns, lookups, logical shards, aggregated writes) is
exactly JAX's, in one process and over 2 gloo ranks, but the MEAN of
two replicas' writes, within 1e-6."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.parallel import central_storage as jcs
from distributed_tensorflow_tpu.parallel import parameter_server as jps
from distributed_tensorflow_tpu.parallel import ps_values as jpv
from distributed_tensorflow_tpu.parallel import sharded_variable as jsv
from distributed_tensorflow_tpu.parallel import tpu_strategy as jtpu
from distributed_tensorflow_tpu.parallel.values import (
    PerReplica as JPerReplica, VariableSynchronization as JSync)
from distributed_tensorflow_tpu_torch.parallel import central_storage as tcs
from distributed_tensorflow_tpu_torch.parallel import parameter_server as tps
from distributed_tensorflow_tpu_torch.parallel import ps_values as tpv
from distributed_tensorflow_tpu_torch.parallel import sharded_variable as tsv
from distributed_tensorflow_tpu_torch.parallel import tpu_strategy as ttpu
from distributed_tensorflow_tpu_torch.parallel.values import (
    PerReplica, VariableSynchronization)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_cluster_ranks

RNG = np.random.default_rng(11)
TABLE = RNG.normal(size=(10, 4)).astype(np.float32)
NEW = RNG.normal(size=(10, 4)).astype(np.float32)
IDS = np.array([0, 9, 3, 3, 7, 5], np.int32)
X = RNG.normal(size=(2, 4)).astype(np.float32)

PARTITIONERS = {
    "fixed3": (jsv.FixedShardsPartitioner(3), tsv.FixedShardsPartitioner(3)),
    "fixed20": (jsv.FixedShardsPartitioner(20),
                tsv.FixedShardsPartitioner(20)),
    "min1k": (jsv.MinSizePartitioner(1024, max_shards=8),
              tsv.MinSizePartitioner(1024, max_shards=8)),
    "min_default": (jsv.MinSizePartitioner(), tsv.MinSizePartitioner()),
    "max4k": (jsv.MaxSizePartitioner(4096), tsv.MaxSizePartitioner(4096)),
    "max4k_cap3": (jsv.MaxSizePartitioner(4096, max_shards=3),
                   tsv.MaxSizePartitioner(4096, max_shards=3)),
}
SHAPES = [(10, 4), (1000, 64), (7,), (3, 5, 2), (100000, 64)]
DTYPES = [(np.float32, torch.float32), (np.float16, torch.float16),
          (np.int64, torch.int64)]


@pytest.mark.parametrize("name", sorted(PARTITIONERS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partitioners_match_jax(name, shape):
    j, t = PARTITIONERS[name]
    for jd, td in DTYPES:
        want = j(shape, jd)
        assert t(shape, td) == want and t(shape, jd) == want


def test_partitioners_refuse_what_jax_refuses():
    for mod in (jsv, tsv):
        with pytest.raises(ValueError):
            mod.MinSizePartitioner(0)
        with pytest.raises(ValueError):
            mod.MaxSizePartitioner(0)


def _jax_sharded(n_dev=4):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("ps",))
    return jsv.ShardedVariable(TABLE, mesh=mesh, shard_axis_name="ps",
                               num_shards=3)


def _check_sharded(got: dict, j):
    np.testing.assert_array_equal(got["read"], np.asarray(j.read_value()))
    np.testing.assert_array_equal(got["lookup"],
                                  np.asarray(j.embedding_lookup(IDS)))
    assert len(got["variables"]) == len(j.variables) == 3
    for g, w in zip(got["variables"], j.variables):
        np.testing.assert_array_equal(g, w)
    j.assign(NEW)
    np.testing.assert_array_equal(got["assigned"], np.asarray(j.read_value()))
    np.testing.assert_array_equal(got["lookup_after"],
                                  np.asarray(j.embedding_lookup(IDS)))


def test_sharded_variable_one_process_matches_jax():
    v = tsv.ShardedVariable(TABLE, num_shards=3)
    assert v.shape == (10, 4) and v.num_shards == 3
    got = {"read": v.read_value().numpy(),
           "lookup": v.embedding_lookup(IDS).numpy(),
           "variables": v.variables}
    v.assign(NEW)
    got["assigned"] = v.read_value().numpy()
    got["lookup_after"] = v.embedding_lookup(IDS).numpy()
    _check_sharded(got, _jax_sharded())
    with pytest.raises(ValueError, match="shape"):
        v.assign(NEW[:3])
    with pytest.raises(ValueError, match="rank"):
        tsv.ShardedVariable(np.float32(1.0))


@pytest.fixture(scope="module")
def two_ranks():
    return multi_process_runner.run(
        torch_cluster_ranks.ps_strategies_rank, 2,
        args=(TABLE, IDS, NEW, X), device="cpu", timeout=240).return_values


def test_sharded_variable_two_ranks_matches_jax(two_ranks):
    for run in two_ranks:
        assert run["sharded/local_rows"] == 5
        _check_sharded({k.split("/", 1)[1]: v for k, v in run.items()
                        if k.startswith("sharded/")}, _jax_sharded())


def test_parameter_server_v2_matches_jax(two_ranks):
    js = jps.ParameterServerStrategy(
        variable_partitioner=jsv.FixedShardsPartitioner(3))
    with js.scope():
        jbig = js.create_variable(TABLE)
        jsmall = js.create_variable(np.ones(3, np.float32))
    want = (type(jbig).__name__, type(jsmall).__name__, jbig.num_shards)
    ts = tps.ParameterServerStrategy(
        variable_partitioner=tsv.FixedShardsPartitioner(3), device="cpu")
    with ts.scope():
        tbig = ts.create_variable(TABLE)
        tsmall = ts.create_variable(np.ones(3, np.float32))
    assert (type(tbig).__name__, type(tsmall).__name__,
            tbig.num_shards) == want
    assert ts.gradient_bucketer() is None and js.gradient_bucketer() is None
    runs = [(tbig.read_value().numpy(), tbig.variables)] + [
        (r["ps/read"], r["ps/variables"]) for r in two_ranks]
    for r in two_ranks:
        assert r["ps/kinds"] == want
    for read, shards in runs:
        np.testing.assert_array_equal(read, np.asarray(jbig.read_value()))
        for g, w in zip(shards, jbig.variables):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tsmall.read_value().numpy(),
                                  np.asarray(jsmall.read_value()))
    assert tps.ParameterServerStrategyV2 is tps.ParameterServerStrategy


def test_parameter_server_v1_matches_jax():
    cpu = jax.devices("cpu")[0]
    js = jps.ParameterServerStrategyV1(
        mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
        parameter_devices=[cpu, cpu])
    ts = tps.ParameterServerStrategyV1(parameter_devices=["cpu", "/cpu:0"],
                                       device="cpu")
    got, want = [], []
    for s, out, sync in ((js, want, JSync), (ts, got,
                                             VariableSynchronization)):
        with s.scope():
            vs = [s.create_variable(TABLE[i]) for i in range(3)]
            r = s.create_variable(np.zeros(2, np.float32),
                                  synchronization=sync.ON_READ)
        out.append([type(v).__name__ for v in vs] + [type(r).__name__])
        out.append([np.asarray(v.read_value()) for v in vs])
        out.append(s._next_ps)
    assert got[0] == want[0] and got[2] == want[2] == 3
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    assert [d.type for d in ts.parameter_devices] == ["cpu", "cpu"]


def test_aggregating_and_caching_variables_match_jax():
    jv = jpv.AggregatingVariable(TABLE[0])
    tv = tpv.AggregatingVariable(TABLE[0])
    assert tv.device == torch.device("cpu")
    assert jv.device.platform == "cpu"
    assert tv.aggregation.value == jv.aggregation.value == "mean"
    jc, tc = jpv.CachingVariable(jv), tpv.CachingVariable(tv)
    for c in (jc, tc):
        c.assign(TABLE[1])
        c.assign_add(TABLE[2])
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    np.testing.assert_array_equal(tv.read_value().numpy(),
                                  np.asarray(jv.read_value()))
    tv.assign(TABLE[3])                  # a source write the cache misses
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    np.testing.assert_array_equal(tc.update_cache().numpy(), TABLE[3])
    assert (tc.name, tc.shape) == (tv.name, (4,))


@pytest.mark.parametrize("R", [1, 2])
def test_central_storage_matches_jax(two_ranks, R):
    js = jcs.CentralStorageStrategy(
        mesh=make_mesh({"dp": R}, devices=jax.devices()[:R]))
    with js.scope():
        jw = js.create_variable(np.zeros(4, np.float32))
    js.run(lambda t: jw.assign(t * 3.0),
           args=(JPerReplica([X[i] for i in range(R)]),))
    want = np.asarray(jw.read_value())
    assert isinstance(jw, jpv.AggregatingVariable)
    if R == 1:
        ts = tcs.CentralStorageStrategy(device="cpu")
        with ts.scope():
            tw = ts.create_variable(np.zeros(4, np.float32))
        ts.run(lambda t: tw.assign(t * 3.0), args=(PerReplica([X[0]]),))
        assert isinstance(tw, tpv.AggregatingVariable)
        assert ts.parameter_device == tw.device == torch.device("cpu")
        assert ts.gradient_bucketer() is None
        np.testing.assert_array_equal(tw.read_value().numpy(), want)
        return
    for run in two_ranks:
        assert run["central/device"] == "cpu"
        assert run["central/replicas"] == 2
        np.testing.assert_allclose(run["central/value"], want, rtol=0,
                                   atol=1e-6)


def test_tpu_strategy_matches_jax(two_ranks):
    js = jtpu.TPUStrategy(model_axes={"tp": 2})
    want = np.asarray(js.split_to_logical_devices(TABLE, [2, 1]))
    np.testing.assert_array_equal(
        np.asarray(js.assign_to_logical_device(TABLE, 0)), TABLE)
    with pytest.raises(ValueError, match="model axes"):
        js.split_to_logical_devices(TABLE, [2, 2])
    for run in two_ranks:
        np.testing.assert_array_equal(run["tpu/split"], want)
        assert "Not enough model axes" in run["tpu/too_many"]
    ts = ttpu.TPUStrategy(device="cpu")
    t = torch.from_numpy(TABLE)
    assert ts.assign_to_logical_device(t, 0) is t
    assert ts.split_to_logical_devices(t, [1, 1]) is t
    with pytest.raises(ValueError, match="model axes"):
        ts.split_to_logical_devices(t, [2, 1])
    topo = ttpu.initialize_tpu_system()
    assert topo.num_devices == max(1, torch.cuda.device_count())
    assert topo.platform == ("gpu" if torch.cuda.is_available() else "cpu")

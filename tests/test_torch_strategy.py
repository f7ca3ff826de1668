"""Port parity: the strategy API (``parallel/strategy.py``,
``one_device.py``, ``mirrored.py``, ``values.py``) on 1, 2 and 4 gloo
ranks against the JAX package's ``MirroredStrategy`` on as many virtual
CPU devices, on the same numpy-seeded inputs.

Every rank holds JAX's host view: ``run``'s outputs are ``PerReplica``
values of every replica; ``reduce`` (SUM, MEAN, MAX, MIN, with and
without ``axis``) and ``gather``; the replica context's ``all_reduce``,
``all_gather`` and ``merge_call``; MEAN, SUM and ONLY_FIRST_REPLICA
writes inside ``run`` and ON_READ reads (SUM, MEAN);
``experimental_distribute_values_from_function``; the distributed
dataset's batch (each rank's rows are JAX's replica shard). Outputs of
elementwise host math compare exactly, reductions within 1e-6.
``compile_step(mnist_cnn.make_train_step)`` on the distributed dataset's
batches for 3 steps matches JAX's from JAX's initial parameters: the
losses within 2e-6, the accuracies equal, the parameters within
``tests/test_torch_mnist.py``'s rule for this model and optimizer:
within 1e-4, and at most 1 element in 10^5 past 1e-5 (Adam divides a
near-zero gradient by about its own size, so f32 rounding noise moves
such an element by a share of the learning rate; measured at a global
batch of 8 rows, 0.08% of ``Dense_0`` moved up to 4.0e-4 apart on one
replica, so the test takes test_torch_mnist's 16 rows of seed 1). On
several replicas a step whose optimizer never steps raises.
"""

import jax
import numpy as np
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu.input.dataset import Dataset
from distributed_tensorflow_tpu.models import mnist_cnn
from distributed_tensorflow_tpu.parallel.values import (
    PerReplica, VariableAggregation, VariableSynchronization)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_strategy_ranks

WORLDS = (1, 2, 4)
GB, STEPS, N = 16, 3, 64


def _inputs(R):
    rng = np.random.default_rng(100 + R)
    return rng.normal(size=(R, 4)).astype(np.float32)


DATA = mnist_cnn.synthetic_data(N, seed=1)


def jax_checks(R: int) -> dict:
    s = dtx.MirroredStrategy(devices=jax.devices()[:R])
    x = _inputs(R)
    px = PerReplica([x[i] for i in range(R)])
    out = {}

    def fn(v):
        ctx = dtx.get_replica_context()
        return {"y": v * 2.0 + 1.0,
                "id": ctx.replica_id_in_sync_group,
                "sum": ctx.all_reduce("sum", v),
                "mean": ctx.all_reduce("mean", v),
                "max": ctx.all_reduce("max", v),
                "gather": ctx.all_gather(v[None], axis=0),
                "merged": ctx.merge_call(
                    lambda s_, t: s_.extended.reduce_to("sum", t) + 1.0,
                    args=(v,))}
    res = s.run(fn, args=(px,))
    for k, pr in res.items():
        out[f"run/{k}"] = [np.asarray(v) for v in pr.values]
    for op in ("sum", "mean", "max", "min"):
        out[f"reduce/{op}"] = np.asarray(s.reduce(op, res["y"], axis=None))
        out[f"reduce/{op}/axis0"] = np.asarray(s.reduce(op, res["y"], axis=0))
    out["gather"] = np.asarray(s.gather(res["y"], axis=0))
    with s.scope():
        mean_v = s.create_variable(np.zeros(4, np.float32))
        sum_v = s.create_variable(np.ones(4, np.float32),
                                  aggregation=VariableAggregation.SUM)
        first_v = s.create_variable(
            np.zeros(4, np.float32),
            aggregation=VariableAggregation.ONLY_FIRST_REPLICA)
        read_sum = s.create_variable(
            np.zeros(4, np.float32),
            synchronization=VariableSynchronization.ON_READ,
            aggregation=VariableAggregation.SUM)
        read_mean = s.create_variable(
            np.ones(4, np.float32),
            synchronization=VariableSynchronization.ON_READ,
            aggregation=VariableAggregation.MEAN)

    def write(v):
        mean_v.assign(v * 3.0)
        sum_v.assign_add(v)
        first_v.assign(v - 1.0)
        read_sum.assign_add(v)
        read_mean.assign_sub(v * 0.5)
        return read_sum.read_value()
    for _ in range(2):
        local_reads = s.run(write, args=(px,))
    out["var/local_read"] = [np.asarray(v) for v in local_reads.values]
    for name, var in (("mean", mean_v), ("sum", sum_v), ("first", first_v),
                      ("on_read_sum", read_sum), ("on_read_mean",
                                                  read_mean)):
        out[f"var/{name}"] = np.asarray(var.read_value())
    vals = s.experimental_distribute_values_from_function(
        lambda ctx: np.full(3, ctx.replica_id_in_sync_group + 0.5,
                            np.float32))
    out["values_fn"] = [np.asarray(v) for v in
                        s.run(lambda v: v * 2.0, args=(vals,)).values]
    ds = Dataset.from_tensor_slices(DATA).batch(GB)
    first = next(iter(s.experimental_distribute_dataset(ds)))
    devs = list(s.mesh.devices.flat)
    for k in ("image", "label"):
        shards = {sh.device: np.asarray(sh.data)
                  for sh in first[k].addressable_shards}
        out[f"dataset/{k}"] = [shards[d] for d in devs]
    state, model, tx = mnist_cnn.create_train_state(jax.random.PRNGKey(0))
    out["mnist/init"] = jax.tree_util.tree_map(np.asarray, state["params"])
    state = s.replicate(state)
    step = s.compile_step(mnist_cnn.make_train_step(model, tx))
    it = iter(s.experimental_distribute_dataset(ds))
    losses, accs = [], []
    for _ in range(STEPS):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    out["mnist/losses"], out["mnist/accuracy"] = losses, accs
    out["mnist/params"] = jax.tree_util.tree_map(np.asarray, state["params"])
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {R: jax_checks(R) for R in WORLDS}


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    from distributed_tensorflow_tpu_torch.parallel.mirrored import (
        MirroredStrategy)
    runs = {}
    for R in WORLDS:
        args = (_inputs(R), DATA, jax_runs[R]["mnist/init"], GB, STEPS)
        if R == 1:
            runs[R] = [torch_strategy_ranks.strategy_checks(
                MirroredStrategy(devices=["cpu"]), *args)]
        else:
            runs[R] = multi_process_runner.run(
                torch_strategy_ranks.strategy_rank, R, args=args,
                device="cpu", timeout=300).return_values
    return runs


EXACT = ("run/y", "run/id", "run/gather", "values_fn", "var/local_read",
         "var/first", "gather", "reduce/max",
         "reduce/min", "reduce/max/axis0", "reduce/min/axis0")
CLOSE = ("run/sum", "run/mean", "run/max", "run/merged", "reduce/sum",
         "reduce/mean", "reduce/sum/axis0", "reduce/mean/axis0",
         "var/mean", "var/sum", "var/on_read_sum", "var/on_read_mean")


@pytest.mark.parametrize("R", WORLDS)
@pytest.mark.parametrize("key", EXACT + CLOSE)
def test_strategy_values_match_jax(port_runs, jax_runs, R, key):
    want = jax_runs[R][key]
    for r in port_runs[R]:
        got = r[key]
        if isinstance(want, list):
            assert len(got) == len(want) == R
        for g, w in zip(got if isinstance(want, list) else [got],
                        want if isinstance(want, list) else [want]):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, key
            if key in EXACT:
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=key)


@pytest.mark.parametrize("R", WORLDS)
def test_distributed_dataset_rows_are_jax_replica_shards(port_runs,
                                                         jax_runs, R):
    for r, run in enumerate(port_runs[R]):
        for k in ("image", "label"):
            np.testing.assert_array_equal(run[f"dataset/{k}"],
                                          jax_runs[R][f"dataset/{k}"][r])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("R", WORLDS)
def test_compile_step_mnist_matches_jax(port_runs, jax_runs, R):
    want = jax_runs[R]
    wp = _flat(want["mnist/params"])
    for run in port_runs[R]:
        np.testing.assert_allclose(run["mnist/losses"], want["mnist/losses"],
                                   rtol=0, atol=2e-6)
        assert run["mnist/accuracy"] == want["mnist/accuracy"]
        gp = _flat(run["mnist/params"])
        assert gp.keys() == wp.keys()
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=1e-4,
                                       err_msg=k)
            assert (np.abs(gp[k] - wp[k]) > 1e-5).mean() <= 1e-5, k
        if R > 1:
            assert run["mnist/unsynced_raises"]


def test_replicas_agree_and_know_their_ids(port_runs):
    for R in WORLDS[1:]:
        assert sorted(r["replica_id"] for r in port_runs[R]) == list(range(R))


def test_no_cuda_no_fallback():
    """With no CUDA device the default strategies and a Keras model
    built outside a CPU strategy raise; nothing carries on on the CPU."""
    import torch
    from distributed_tensorflow_tpu_torch import keras
    from distributed_tensorflow_tpu_torch.parallel.mirrored import (
        MirroredStrategy)
    from distributed_tensorflow_tpu_torch.parallel.one_device import (
        OneDeviceStrategy)
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    for make in (OneDeviceStrategy, MirroredStrategy,
                 lambda: OneDeviceStrategy("/gpu:0"),
                 lambda: MirroredStrategy(devices=["cuda:0"]),
                 lambda: keras.Sequential([keras.Input((3,)),
                                           keras.layers.Dense(2)])):
        with pytest.raises(RuntimeError):
            make()
    assert OneDeviceStrategy("/cpu:0").device.type == "cpu"

"""Port parity: ``MultiWorkerMirroredStrategy`` (``parallel/
multi_worker.py``) over 2 gloo ranks that the port's
``MultiProcessRunner`` starts with JAX's ``TF_CONFIG``, each building the
strategy from ``TF_CONFIG`` alone, against the JAX package's strategy on
2 virtual CPU devices on the same numpy-seeded values: ``run``'s
outputs, ``reduce`` (SUM, MEAN, with and without ``axis``) and
``gather`` — elementwise results exactly, reductions within 1e-6.
``check_health`` is True with both ranks in, then False within its 2 s
timeout (bounded at 5 s) while one rank is held back, which then passes
the same round late."""

import jax
import numpy as np
import pytest

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.parallel.multi_worker import (
    MultiWorkerMirroredStrategy as JaxMWMS)
from distributed_tensorflow_tpu.parallel.strategy import get_replica_context
from distributed_tensorflow_tpu.parallel.values import PerReplica
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_cluster_ranks

R = 2
X = np.random.default_rng(7).normal(size=(R, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    s = JaxMWMS(mesh=make_mesh({"dp": R}, devices=jax.devices()[:R]))
    px = PerReplica([X[i] for i in range(R)])

    def fn(v):
        ctx = get_replica_context()
        return {"y": v * 2.0 + 1.0, "sum": ctx.all_reduce("sum", v),
                "id": ctx.replica_id_in_sync_group}
    res = s.run(fn, args=(px,))
    out = {f"run/{k}": [np.asarray(v) for v in pr.values]
           for k, pr in res.items()}
    out["gather"] = np.asarray(s.gather(res["y"], axis=0))
    for op in ("sum", "mean"):
        out[f"reduce/{op}"] = np.asarray(s.reduce(op, res["y"], axis=None))
        out[f"reduce/{op}/axis0"] = np.asarray(s.reduce(op, res["y"],
                                                        axis=0))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    spec = multi_process_runner.create_cluster_spec(num_workers=R)
    runner = multi_process_runner.MultiProcessRunner(
        torch_cluster_ranks.multi_worker_rank, spec,
        args=(X, str(tmp_path_factory.mktemp("mw"))), device="cpu",
        timeout=240)
    return runner.start().join().return_values


EXACT = ("run/y", "run/id", "gather")
CLOSE = ("run/sum", "reduce/sum", "reduce/mean", "reduce/sum/axis0",
         "reduce/mean/axis0")


@pytest.mark.parametrize("key", EXACT + CLOSE)
def test_values_match_jax(port_runs, jax_run, key):
    want = jax_run[key]
    assert len(port_runs) == R
    for run in port_runs:
        got = run[key]
        pairs = zip(got, want) if isinstance(want, list) else [(got, want)]
        for g, w in pairs:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, key
            if key in EXACT:
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=key)


def test_built_from_tf_config(port_runs):
    for r, run in enumerate(port_runs):
        assert run["rank"] == r and run["replicas"] == R
        assert run["task"] == ("worker", r) and run["resolver"] is None


def test_check_health(port_runs):
    rank0, rank1 = port_runs
    assert rank0["health/all_in"] and rank1["health/all_in"]
    assert rank0["health/held_back"] is False
    assert 2.0 <= rank0["health/seconds"] < 5.0
    assert rank1["health/late"] is True

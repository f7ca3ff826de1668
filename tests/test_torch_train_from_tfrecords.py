"""Port parity: ``tools/torch_train_from_tfrecords.py`` against the JAX
package's ``examples/train_from_tfrecords.py`` at ``tiny()`` on the CPU.
The shards it writes are the JAX example's bytes; its pipeline
(``Dataset.from_files(shards, example_reader(spec))`` → map → repeat →
shuffle → batch → prefetch, auto-sharded) gives the JAX example's
batches exactly; and its training loop (the sharded W&D step on a
one-rank gloo mesh), from JAX's flax init, gives the losses of JAX's W&D
step on the same batches at rtol 1e-5."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.input import (
    Dataset as JDataset, example_reader as jreader)
from distributed_tensorflow_tpu.input.dataset import (
    AutoShardPolicy as JPolicy, auto_shard_dataset as jshard)
from distributed_tensorflow_tpu.models import wide_deep as jw
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tfrecord_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 4, 128


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_train_from_tfrecords",
             "tools/torch_train_from_tfrecords.py")
jex = _load("jax_train_from_tfrecords", "examples/train_from_tfrecords.py")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("clicks")
    os.makedirs(d / "port")
    os.makedirs(d / "jax")
    files = tool.write_click_shards(tool.make_config("tiny"), str(d / "port"))
    jfiles = jex.write_click_shards(jw.WideDeepConfig.tiny(), str(d / "jax"))
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in jfiles]
    for f, jf in zip(files, jfiles):
        assert open(f, "rb").read() == open(jf, "rb").read()
    return files


def _jax_pipeline(files, per_process, process_id=0, num_processes=1):
    """The JAX example's chain, as its ``main`` builds it."""
    cfg = jw.WideDeepConfig.tiny()
    spec = {
        "dense": jex.FixedLenFeature((cfg.num_dense_features,), np.float32),
        "categorical": jex.FixedLenFeature((len(cfg.vocab_sizes),),
                                           np.int64),
        "label": jex.FixedLenFeature((1,), np.int64),
    }

    def to_batch(ex):
        return {"dense": ex["dense"],
                "categorical": ex["categorical"].astype(np.int32),
                "label": ex["label"][0].astype(np.int32)}

    ds = (JDataset.from_files(files, jreader(spec))
          .map(to_batch)
          .repeat()
          .shuffle(1024, seed=process_id)
          .batch(per_process, drop_remainder=True)
          .prefetch(2))
    return jshard(ds, num_processes, process_id, JPolicy.AUTO)


def _take(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_pipeline_batches_equal_the_jax_example(shards, shard):
    index, n = shard
    per = BATCH // n
    got = _take(tool.make_pipeline(shards, tool.make_config("tiny"), per,
                                   index, n), 6)
    want = _take(_jax_pipeline(shards, per, index, n), 6)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


def test_losses_match_jax_wd_step(shards):
    cfg = jw.WideDeepConfig.tiny()
    params = jw.WideDeep(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, cfg.num_dense_features)),
        jnp.zeros((BATCH, len(cfg.vocab_sizes)), jnp.int32))["params"]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tx = jw.make_optimizer(cfg)
    jstep = jax.jit(jw.make_train_step(cfg, jw.WideDeep(cfg), tx))
    state = {"params": params, "opt_state": tx.init(params), "step": 0}
    want = []
    for batch in _take(_jax_pipeline(shards, BATCH), STEPS):
        state, m = jstep(state, batch)
        want.append(float(m["loss"]))
    got = multi_process_runner.run(
        torch_tfrecord_ranks.train_rank, 1,
        args=(shards, np_params, BATCH, STEPS), device="cpu",
        timeout=240).return_values[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

"""Port parity: ``parallel/collectives.py`` against the JAX package.

- ``plan_buckets``, ``GradientBucketer.plan`` / ``plan_summary`` and
  ``ZeroPartition``'s sizes, padding and ``summary()`` equal JAX's,
  element for element, over JAX's leaf order (the port's
  ``jax_leaf_params``) for ``tiny()`` and ``transformer_big`` with
  ``scan_layers`` True and False — built from shapes (JAX's
  ``eval_shape``, the port's ``meta`` tensors), nothing allocated.
- ``simulate_overlap`` equals JAX's.
- Over 4 gloo ranks (one spawn for the module): the bucketed all-reduce
  gives the sum and the mean at world 4 and at world 2 (the ``dp`` dim
  of a 2×2 mesh), within 1e-6 (gloo sums in its own order);
  ``hierarchical_all_reduce`` with 1 and 3 chunks equals the flat
  reduction and JAX's ``hierarchical_all_reduce`` on the same 2×2 mesh,
  exactly on integer-valued data and within 1e-6 on random data; the
  overlapped backward reduction launches every bucket in plan order on
  every rank and leaves the same gradients as the bucketed all-reduce;
  a bucket whose leaf got no gradient holds back the buckets planned
  after it until the backward ends, then is reduced as zeros.
- The hooks keep neither the parameters nor the sync alive.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.cluster.topology import make_hybrid_mesh
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.parallel import collectives as jc
from distributed_tensorflow_tpu.parallel.zero import (
    ZeroPartition as JZeroPartition)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _leaf_metas, jax_leaf_params)
from distributed_tensorflow_tpu_torch.parallel import collectives as tc
from distributed_tensorflow_tpu_torch.parallel.zero import ZeroPartition
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks

SEED = 11
CONFIGS = {"tiny": "tiny", "big": "transformer_big"}


def _jax_leaves(name, scan):
    cfg = getattr(JConfig, CONFIGS[name])(scan_layers=scan)
    model = JModel(cfg)
    tree = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, cfg.max_seq_len), jnp.int32)))
    return jax.tree_util.tree_leaves(tree["params"])


def _port_leaves(name, scan):
    cfg = getattr(TransformerConfig, CONFIGS[name])(scan_layers=scan)
    return _leaf_metas(jax_leaf_params(cfg, TransformerLM(cfg,
                                                          device="meta")))


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plans_and_partitions_equal_jax(name, scan):
    jl, tl = _jax_leaves(name, scan), _port_leaves(name, scan)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    for bpp in (0, 1 << 16, jc.DEFAULT_BYTES_PER_PACK):
        jb = jc.GradientBucketer(("dp",), bytes_per_pack=bpp)
        tb = tc.GradientBucketer(None, ("dp",), bytes_per_pack=bpp)
        assert tb.plan(tl) == jb.plan(jl)
        assert tb.plan_summary(tl) == jb.plan_summary(jl)
    sizes = [int(np.prod(x.shape)) for x in jl]
    dtypes = ["bfloat16" if i % 3 == 0 else "float32"
              for i in range(len(sizes))]
    for reverse in (True, False):
        assert tc.plan_buckets(sizes, dtypes, 1 << 20, reverse=reverse) == \
            jc.plan_buckets(sizes, dtypes, 1 << 20, reverse=reverse)
    for n in (1, 2, 4, 8):
        jp, tp = JZeroPartition(jl, n), ZeroPartition(tl, n)
        for attr in ("buckets", "bucket_sizes", "padded_sizes",
                     "shard_sizes", "sizes", "shapes"):
            assert getattr(tp, attr) == getattr(jp, attr), attr
        assert tp.summary() == jp.summary()


def test_simulate_overlap_equals_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7):
        ready = np.sort(rng.uniform(0, 1, n)).tolist()
        dur = rng.uniform(0, 0.3, n).tolist()
        for end in (None, 1.2):
            assert tc.simulate_overlap(ready, dur, end) == \
                jc.simulate_overlap(ready, dur, end)
    with pytest.raises(ValueError):
        tc.simulate_overlap([0.0], [])


@pytest.fixture(scope="module")
def ranks():
    res = multi_process_runner.run(torch_dp_ranks.collectives_rank, 4,
                                   args=(SEED,), device="cpu", timeout=240)
    return res.return_values


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("world", [4, 2])
def test_bucketed_all_reduce(ranks, world, op):
    key = f"w{world}"
    jb = jc.GradientBucketer(("dp",), bytes_per_pack=64)
    for r in ranks:
        assert r[f"{key}_buckets"] == jb.plan(
            [jnp.asarray(x) for x in r["leaves"]])
        assert len(r[f"{key}_buckets"]) > 1
        group = range(4) if world == 4 else range(r["rank"] // 2 * 2,
                                                  r["rank"] // 2 * 2 + 2)
        for i, got in enumerate(r[f"{key}_{op}"]):
            want = sum(ranks[g]["leaves"][i].astype(np.float64)
                       for g in group)
            if op == "mean":
                want = want / world
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _jax_hierarchical(stacked, chunks, op="sum"):
    mesh = make_hybrid_mesh({"dcn": 2}, {"dp": 2}, devices=jax.devices()[:4])
    fn = jax.jit(jax.shard_map(
        lambda x: jc.hierarchical_all_reduce(x[0], "dp", "dcn", op,
                                             chunks=chunks)[None],
        mesh=mesh, in_specs=P(("dcn", "dp")), out_specs=P(("dcn", "dp")),
        check_vma=False))
    return np.asarray(fn(jnp.asarray(stacked)))


@pytest.mark.parametrize("data", ["ints", "vec"])
def test_hierarchical_equals_flat_and_jax(ranks, data):
    stacked = np.stack([r[data] for r in ranks])
    for chunks in (1, 3):
        want = _jax_hierarchical(stacked, chunks)
        for r in ranks:
            got = r[f"{data}_hier{chunks}"]
            np.testing.assert_array_equal(got, r[f"{data}_hier1"])
            if data == "ints":
                np.testing.assert_array_equal(got, r[f"{data}_flat"])
                np.testing.assert_array_equal(got, want[r["rank"]])
            else:
                np.testing.assert_allclose(got, r[f"{data}_flat"],
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(got, want[r["rank"]], rtol=1e-6,
                                           atol=1e-6)
    want_mean = _jax_hierarchical(stacked, 1, "mean")
    for r in ranks:
        np.testing.assert_allclose(r[f"{data}_hier_mean"],
                                   want_mean[r["rank"]], rtol=0, atol=1e-6)


def test_backward_sync_launches_in_plan_order(ranks):
    n = ranks[0]["n_buckets"]
    assert n > 3
    for r in ranks:
        assert r["launched"] == list(range(n))
        # every bucket had its gradients by the end of the backward
        assert r["launched_in_backward"] == list(range(n))
        assert r["hooked_grads_equal"]


def test_backward_sync_reduces_missing_gradients_as_zeros(ranks):
    # sum over ranks of d(a·a)/da = 2 a, a = rank + 1
    want = np.full(4, 2.0 * (1 + 2 + 3 + 4), np.float32)
    for r in ranks:
        assert r["unused_launched_in_backward"] == []
        got_a, got_b = r["unused_grads"]
        np.testing.assert_array_equal(got_a, want)
        np.testing.assert_array_equal(got_b, np.zeros(3, np.float32))


def test_backward_sync_lets_its_parameters_go():
    params = [torch.nn.Parameter(torch.ones(8)) for _ in range(3)]
    sync = tc.GradientBucketer(None, "dp", bytes_per_pack=16).backward_sync(
        [[p] for p in params])
    refs = [weakref.ref(p) for p in params] + [weakref.ref(sync)]
    del params, sync
    gc.collect()
    assert [r() for r in refs] == [None] * 4

"""Port parity: ``distributed_tensorflow_tpu_torch.embedding`` against the
JAX package's ``embedding/embedding.py`` on the CPU, in f32, on the same
tables (JAX's ``create_state`` output through ``state_from_jax``):

- Every optimizer's update (SGD, Adagrad with its ``rsqrt(acc +
  1e-12)``, Adam at ``t = step + 1`` in f32, FTRL with and without
  l1/l2) within 1e-6 relative, from the first step and from step 5,
  slots included.
- ``TableConfig`` / ``FeatureConfig`` raise JAX's errors, message for
  message.
- Every ``lookup`` mode: 1-D ids, 2-D ids with the sum, mean and sqrtn
  combiners, with and without weights, ``ids < 0`` as padding, sequence
  features, tables shared by two features, a dict-of-tuples nest, and
  ``dedup`` with and without ``unique_size``: activations within 1e-6
  and the tables' gradients within 1e-6. Past ``unique_size`` JAX's
  clamped gather reads the row of the largest kept id, and its
  transpose drops those reads' gradient; the port's rows equal JAX's
  exactly (integer row ids checked on an identity table), and so do
  its gradients.
- ``apply_gradients``: a table absent from the grads keeps its weights
  and slots bit for bit, the step still advances; the rest within 1e-6.
- ``TPUEmbedding``: lookup and ``apply_gradients`` as the functional
  core, two steps.
- With no CUDA device, ``device="cuda"`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import embedding as je
from distributed_tensorflow_tpu_torch import embedding as te
from distributed_tensorflow_tpu_torch.embedding import embedding as tem

OPTS = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1)),
    "adam": ("Adam", dict(learning_rate=0.01)),
    "ftrl": ("FTRL", dict(learning_rate=0.1)),
    "ftrl_l1l2": ("FTRL", dict(learning_rate=0.1,
                               l1_regularization_strength=0.01,
                               l2_regularization_strength=0.1)),
}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_update_matches_jax(name, step):
    cls, kw = OPTS[name]
    jopt, topt = getattr(je, cls)(**kw), getattr(te, cls)(**kw)
    rng = np.random.default_rng(7)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    grad = rng.normal(size=(16, 4)).astype(np.float32)
    jslots = jopt.init_slots(jnp.asarray(table))
    jslots = {k: np.asarray(v) + np.float32(0.05) * rng.random(v.shape,
                                                               np.float32)
              for k, v in jslots.items()}
    want, wslots = jopt.apply(jnp.asarray(table), jnp.asarray(grad),
                              jax.tree_util.tree_map(jnp.asarray, jslots),
                              jnp.asarray(step, jnp.int32))
    got, gslots = topt.apply(_t(table), _t(grad),
                             {k: _t(v) for k, v in jslots.items()},
                             torch.tensor(step, dtype=torch.int32))
    assert topt.slot_names() == jopt.slot_names()
    assert sorted(gslots) == sorted(wslots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for k, w in wslots.items():
        np.testing.assert_allclose(gslots[k].numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


BAD = [
    lambda m: m.TableConfig(0, 4),
    lambda m: m.TableConfig(8, -1, name="t"),
    lambda m: m.TableConfig(8, 4, combiner="max"),
    lambda m: m.FeatureConfig("t"),
    lambda m: m.FeatureConfig(m.TableConfig(8, 4), max_sequence_length=-2,
                              name="f"),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_config_validation_is_jaxs(i):
    with pytest.raises(ValueError) as want:
        BAD[i](je)
    with pytest.raises(ValueError) as got:
        BAD[i](te)
    assert str(got.value) == str(want.value)


def _configs(m):
    """A nest exercising every lookup mode; ``shared`` serves two
    features."""
    shared = m.TableConfig(40, 6, name="shared", combiner="sqrtn")
    t_sum = m.TableConfig(30, 6, name="t_sum", combiner="sum")
    t_mean = m.TableConfig(20, 6, combiner="mean")
    return {
        "user": (m.FeatureConfig(shared, name="user"),
                 m.FeatureConfig(shared, name="user_hist")),
        "items": m.FeatureConfig(t_sum, name="items"),
        "cat": m.FeatureConfig(t_mean, name="cat"),
        "seq": m.FeatureConfig(t_mean, max_sequence_length=5, name="seq"),
    }


def _features(rng):
    def multi(v, shape):
        ids = rng.integers(0, v, size=shape)
        ids[rng.random(shape) < 0.3] = -1
        return ids.astype(np.int32)
    return {"user": (rng.integers(0, 40, size=6).astype(np.int32),
                     multi(40, (6, 4))),
            "items": multi(30, (6, 3)),
            "cat": multi(20, (6, 5)),
            "seq": multi(20, (6, 5))}


def _weights(rng, feats):
    return {"user": (None, rng.random((6, 4)).astype(np.float32)),
            "items": rng.random((6, 3)).astype(np.float32),
            "cat": None, "seq": None}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dedup", [None, 0, 7])
def test_lookup_and_its_gradient_match_jax(dedup, weighted):
    rng = np.random.default_rng(3)
    jfc, tfc = _configs(je), _configs(te)
    jstate = je.create_state(jfc, rng=jax.random.PRNGKey(1))
    tstate = te.state_from_jax(jstate, device="cpu")
    assert list(tstate["tables"]) == list(jstate["tables"])
    feats = _features(rng)
    w = _weights(rng, feats) if weighted else None
    kw = {} if dedup is None else {"dedup": True,
                                   "unique_size": dedup or None}
    jacts = je.lookup(jstate["tables"], jfc, feats, w, **kw)
    probes = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jacts)

    def jloss(tables):
        acts = je.lookup(tables, jfc, feats, w, **kw)
        return sum(jnp.sum(a * p) for a, p in zip(
            jax.tree_util.tree_leaves(acts),
            jax.tree_util.tree_leaves(probes)))
    jgrads = jax.grad(jloss)(jstate["tables"])

    tables = {k: v.clone().requires_grad_(True)
              for k, v in tstate["tables"].items()}
    tw = None if w is None else jax.tree_util.tree_map(
        torch.from_numpy, w)
    tacts = te.lookup(tables, tfc, jax.tree_util.tree_map(
        torch.from_numpy, feats), tw, **kw)
    got_leaves = jax.tree_util.tree_leaves(
        tacts, is_leaf=lambda x: isinstance(x, torch.Tensor))
    want_leaves = jax.tree_util.tree_leaves(jacts)
    assert len(got_leaves) == len(want_leaves)
    for g, a in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6)
    sum((g * torch.from_numpy(p)).sum() for g, p in zip(
        got_leaves, jax.tree_util.tree_leaves(probes))).backward()
    for k, gw in jgrads.items():
        np.testing.assert_allclose(tables[k].grad.numpy(), np.asarray(gw),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_dedup_past_unique_size_reads_the_largest_kept_row():
    ids = np.array([5, 3, 5, 9, 7, 3, 1], np.int32)
    table = np.arange(10, dtype=np.float32)[:, None]
    fc = {"j": je.FeatureConfig(je.TableConfig(10, 1, name="t")),
          "t": te.FeatureConfig(te.TableConfig(10, 1, name="t"))}
    want = je.lookup({"t": jnp.asarray(table)}, fc["j"], ids, dedup=True,
                     unique_size=3)
    got = te.lookup({"t": torch.from_numpy(table)}, fc["t"],
                    torch.from_numpy(ids), dedup=True, unique_size=3)
    rows = np.asarray(want)[:, 0].astype(np.int64)
    assert rows.tolist() == [5, 3, 5, 5, 5, 3, 1]
    assert got[:, 0].long().tolist() == rows.tolist()


def test_weights_on_dense_or_sequence_features_raise_as_jax():
    for m, conv in ((je, np.asarray), (te, torch.from_numpy)):
        t = m.TableConfig(8, 2, name="t")
        ids = np.zeros((2, 3), np.int32)
        w = np.ones((2, 3), np.float32)
        with pytest.raises(ValueError, match="only valid"):
            m.lookup({"t": conv(np.ones((8, 2), np.float32))},
                     m.FeatureConfig(t), conv(ids[:, 0]), conv(w[:, 0]))
        with pytest.raises(ValueError, match="sequence features"):
            m.lookup({"t": conv(np.ones((8, 2), np.float32))},
                     m.FeatureConfig(t, max_sequence_length=3), conv(ids),
                     conv(w))


@pytest.mark.parametrize("opt", ["adagrad", "adam", "ftrl"])
def test_apply_gradients_matches_jax_and_skips_absent_tables(opt):
    cls, kw = OPTS[opt]
    jfc, tfc = _configs(je), _configs(te)
    jstate = je.create_state(jfc, getattr(je, cls)(**kw),
                             rng=jax.random.PRNGKey(2))
    tstate = te.state_from_jax(jstate, device="cpu")
    rng = np.random.default_rng(4)
    grads = {"shared": rng.normal(size=(40, 6)).astype(np.float32),
             "t_sum": rng.normal(size=(30, 6)).astype(np.float32)}
    for _ in range(2):
        jstate = je.apply_gradients(jstate, jax.tree_util.tree_map(
            jnp.asarray, grads), jfc, getattr(je, cls)(**kw))
        before = {k: v.clone() for k, v in tstate["tables"].items()}
        slots_before = {k: {s: a.clone() for s, a in v.items()}
                        for k, v in tstate["slots"].items()}
        tstate = te.apply_gradients(tstate, {**{k: _t(v) for k, v in
                                                grads.items()},
                                             "table_0": None},
                                    tfc, getattr(te, cls)(**kw))
        assert torch.equal(tstate["tables"]["table_0"], before["table_0"])
        for s, a in tstate["slots"]["table_0"].items():
            assert torch.equal(a, slots_before["table_0"][s])
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for k, w in jstate["tables"].items():
        np.testing.assert_allclose(tstate["tables"][k].numpy(),
                                   np.asarray(w), rtol=1e-6, atol=1e-7)
    for k, sl in jstate["slots"].items():
        for s, w in sl.items():
            np.testing.assert_allclose(tstate["slots"][k][s].numpy(),
                                       np.asarray(w), rtol=1e-6, atol=1e-7)


def test_tpu_embedding_object_matches_functional():
    tfc = _configs(te)
    emb = te.TPUEmbedding(tfc, te.Adagrad(0.1), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    feats = jax.tree_util.tree_map(torch.from_numpy, _features(rng))
    state = {"tables": dict(emb.state["tables"]),
             "slots": dict(emb.state["slots"]), "step": emb.state["step"]}
    for _ in range(2):
        tables = {k: v.clone().requires_grad_(True)
                  for k, v in emb.embedding_tables.items()}
        acts = emb.lookup_fn()(tables, feats)
        sum(a.square().sum() for a in jax.tree_util.tree_leaves(
            acts, is_leaf=lambda x: isinstance(x, torch.Tensor))).backward()
        grads = {k: t.grad for k, t in tables.items()}
        want = te.lookup(state["tables"], tfc, feats)
        got = emb(feats)
        for a, b in zip(jax.tree_util.tree_leaves(
                got, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                jax.tree_util.tree_leaves(
                    want, is_leaf=lambda x: isinstance(x, torch.Tensor))):
            assert torch.equal(a, b)
        emb.apply_gradients(grads)
        state = te.apply_gradients(state, grads, tfc, te.Adagrad(0.1))
    for k in state["tables"]:
        assert torch.equal(emb.embedding_tables[k], state["tables"][k])
    assert int(emb.state["step"]) == 2


def test_padded_rows_are_jaxs_padded_vocab():
    from distributed_tensorflow_tpu.embedding.embedding import _padded_vocab

    class Mesh:
        def __init__(self, n):
            self.shape = {"tp": n}
    for vocab in (1, 7, 8, 100000, 30522):
        for n in (1, 2, 3, 4, 8):
            assert tem.padded_rows(vocab, n) == _padded_vocab(
                vocab, Mesh(n), "tp")


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.create_state(_configs(te))

"""Port parity: tensor-parallel Wide&Deep/DLRM on four gloo ranks (one
spawn) against the JAX package's steps on the 8-device CPU mesh, three
steps each on the same global batches, from JAX's initial state.

- ``make_sharded_train_step`` (the flax model: tables and wide vectors
  row-sharded over ``tp``, padded where ``tp`` does not divide a
  vocabulary):
  - ``{"dp": 2, "tp": 2}`` with vocabularies 2 divides, held to JAX on
    the same mesh;
  - ``{"tp": 4}`` with vocabularies (66, 64, 30), which 4 does not
    divide: JAX refuses them on that mesh (its ``jit`` out-shardings
    need 4 to divide the rows), so the port is held to JAX's
    ``{"dp": 2, "tp": 2}`` run of the same model and batches;
  - ``{"dp": 2, "tp": 2}`` with (65, 64, 31), which 2 does not divide,
    held to JAX's ``{"dp": 2}`` run (tables replicated).
- ``make_embedding_train_step`` (the embedding API's tables, which JAX's
  ``create_state`` pads to the shard count itself) on ``{"tp": 4}``
  with (66, 64, 30) and on ``{"dp": 2, "tp": 2}`` with (65, 64, 31), each
  held to JAX on the same mesh: the padded tables and their Adagrad
  slots compared whole.

Every step's loss within 2e-6 and every parameter, table and slot
within 1e-5 (``tests/test_torch_train_step.py``'s tolerances), the same
on every rank; the local row blocks are ``ceil(V/tp)`` rows.
"""

import jax
import numpy as np
import pytest

from distributed_tensorflow_tpu.models import wide_deep as jw
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_wide_deep_ranks
from torch_tp_jax import jax_mesh

GB, STEPS = 16, 3
TP4, DPTP, DP2 = {"tp": 4}, {"dp": 2, "tp": 2}, {"dp": 2}
V4, V2 = (66, 64, 30), (65, 64, 31)
#: name → (kind, port mesh, config kwargs, JAX mesh)
CASES = {
    "flax_dptp": ("flax", DPTP, {"interaction": "concat"}, DPTP),
    "flax_tp4": ("flax", TP4, {"vocab_sizes": V4, "interaction": "dot"},
                 DPTP),
    "flax_dptp_odd": ("flax", DPTP, {"vocab_sizes": V2,
                                     "interaction": "dot"}, DP2),
    "emb_tp4": ("emb", TP4, {"vocab_sizes": V4, "interaction": "dot"},
                TP4),
    "emb_dptp": ("emb", DPTP, {"vocab_sizes": V2,
                               "interaction": "concat"}, DPTP),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _batches(cfg):
    return [{k: np.asarray(v) for k, v in jw.synthetic_clicks(
        cfg, GB, seed=40 + i).items()} for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (kind, _, kw, jaxes) in CASES.items():
        cfg = jw.WideDeepConfig.tiny(**kw)
        mesh = jax_mesh(jaxes)
        if kind == "flax":
            state, step = jw.make_sharded_train_step(cfg, mesh, GB)
            init = _np(state["params"])
        else:
            state, step = jw.make_embedding_train_step(cfg, mesh, GB)
            init = {"dense": {"params": _np(state["dense"]["params"])},
                    "emb": _np(state["emb"])}
        losses = []
        for b in _batches(cfg):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[name] = {"init": init, "losses": losses, "final": _np(state)}
    return out


@pytest.fixture(scope="module")
def port_ranks(jax_runs):
    cases = [(name, kind, axes, kw, jax_runs[name]["init"])
             for name, (kind, axes, kw, _) in CASES.items()]
    batches = {name: _batches(jw.WideDeepConfig.tiny(**kw))
               for name, (_, _, kw, _) in CASES.items()}
    return multi_process_runner.run(
        torch_wide_deep_ranks.wide_deep_rank, 4, args=(cases, batches),
        device="cpu", timeout=300).return_values


def _close(got, want, label):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_deep_tp_matches_jax(port_ranks, jax_runs, case):
    kind, axes, kw, _ = CASES[case]
    want = jax_runs[case]
    vocab = kw.get("vocab_sizes", (64, 64, 32))
    tp = axes["tp"]
    for r in port_ranks:
        got = r[case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=2e-6, err_msg=case)
        assert got["losses"] == port_ranks[0][case]["losses"]
        if kind == "flax":
            _close(got["params"], want["final"]["params"], case)
            assert got["local"]["table_0"] == (-(-vocab[0] // tp), 8)
            assert got["local"]["wide_2"] == (-(-vocab[2] // tp),)
        else:
            _close(got["dense"], want["final"]["dense"]["params"], case)
            _close(got["tables"], want["final"]["emb"]["tables"], case)
            _close(got["slots"], want["final"]["emb"]["slots"], case)
            assert got["local"]["table_0"] == (-(-vocab[0] // tp), 8)


def test_jax_refuses_the_tp4_sharded_model_with_that_vocab():
    cfg = jw.WideDeepConfig.tiny(vocab_sizes=V4)
    with pytest.raises(ValueError, match="divisible by 4"):
        jw.make_sharded_train_step(cfg, jax_mesh(TP4), GB)

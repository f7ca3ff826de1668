"""Port parity: the slice — data-parallel training
(``models/transformer.py make_sharded_train_step``, ``models/bert.py
make_sharded_train_step``) on 4 gloo ranks against the JAX package's on
its 8-device CPU mesh.

- JAX's ``make_sharded_train_step(tiny(), make_mesh({"dp": 4}),
  global_batch=8)`` runs 3 steps; the port runs the same from the same
  converted parameters on the same tokens, and so for ``zero=1``,
  ``zero=2``, the 2×2 ``("dcn", "dp")`` hybrid mesh (JAX's on
  ``make_hybrid_mesh``) and ``grad_sync="gspmd"``. Tolerances are
  ``tests/test_torch_train_step.py``'s: every step's loss within 2e-6,
  the parameters within 1e-5 (JAX's own ZeRO-against-replicated bitwise
  tests fail on jax 0.9.0, by 3.7e-9, so no cross-package comparison
  is bitwise).
- ``grad_sync="none"``: rank r equals the single-device port step on
  rank r's rows, within 1e-6 (the ranks' one intra-op thread against
  this process's several).
- Every refusal JAX raises, the port raises with the same type, for the
  same arguments; where JAX goes to GSPMD on a ``dp × fsdp`` mesh the
  port builds its post-sync or ZeRO step (they train in
  ``tests/test_torch_fsdp_train.py``; tensor-parallel meshes and ZeRO
  off a ``("dp",)`` mesh in ``tests/test_torch_tp_*.py``).
- BERT at world 2 equals the single-device port BERT step on the global
  batch (losses within 2e-6, parameters within 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.cluster.topology import (
    make_hybrid_mesh, make_mesh)
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded,
    synthetic_tokens)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, init_params, make_optimizer,
    make_train_step)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks

GB, STEPS = 8, 3
#: (port mesh, JAX mesh) of each variant, and its keyword arguments
VARIANTS = {"bucketed": ("dp", {}), "zero1": ("dp", {"zero": 1}),
            "zero2": ("dp", {"zero": 2}), "hybrid": ("hybrid", {}),
            "gspmd": ("dp", {"grad_sync": "gspmd"})}
#: (mesh, config kwargs, step kwargs); "dummy" stands for a step_factory
REFUSALS = [
    ("dp", {}, {"grad_sync": "bogus"}),
    ("dp", {}, {"zero": 3}),
    ("dp", {}, {"zero": 1, "step_factory": "dummy"}),
    ("dp", {"fused_optimizer": True}, {"zero": 1}),
    ("dp", {}, {"zero": 1, "grad_sync": "bucketed"}),
    ("dp_tp", {}, {"grad_sync": "bucketed"}),
    ("dp_tp", {}, {"grad_sync": "none"}),
    ("dp", {}, {"grad_sync": "none", "step_factory": "dummy"}),
]
#: where JAX goes to GSPMD on a dp×fsdp mesh: the port builds its
#: post-sync and ZeRO steps there (they train in
#: tests/test_torch_fsdp_train.py)
PORT_ONLY = [("dp_fsdp", {}, {}), ("dp_fsdp", {}, {"zero": 1}),
             ("dp_fsdp", {}, {"grad_sync": "gspmd"})]


def _jax_mesh(name):
    devs = jax.devices()
    if name == "hybrid":
        return make_hybrid_mesh({"dcn": 2}, {"dp": 2}, devices=devs[:4])
    if name == "dp_tp":
        return make_mesh({"dp": 2, "tp": 2}, devices=devs[:4])
    return make_mesh({"dp": 4}, devices=devs[:4])


def _flat(tree) -> dict:
    out = {"embed": np.asarray(tree["embed"]),
           "final_norm/scale": np.asarray(tree["final_norm"]["scale"])}
    for g, leaves in tree["layers"].items():
        for n, a in leaves.items():
            out[f"layers/{g}/{n}"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens):
    out = {}
    for name, (mesh, kw) in VARIANTS.items():
        state, step = jsharded(JConfig.tiny(), _jax_mesh(mesh), GB, 0, **kw)
        init = _flat(jax.tree_util.tree_map(np.asarray, state["params"]))
        losses = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
        out[name] = {"init": init, "losses": losses,
                     "params": _flat(jax.tree_util.tree_map(
                         np.asarray, state["params"]))}
    return out


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tokens):
    init = jax_runs["bucketed"]["init"]
    for r in jax_runs.values():
        assert all(np.array_equal(r["init"][k], init[k]) for k in init)
    return multi_process_runner.run(
        torch_dp_ranks.dp_train_rank, 4,
        args=(init, tokens.astype(np.int64), STEPS, REFUSALS + PORT_ONLY),
        device="cpu", timeout=300).return_values


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_step_matches_jax(port_ranks, jax_runs, variant):
    want = jax_runs[variant]
    for r in port_ranks:
        got = r[variant]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=2e-6)
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                       atol=1e-5, err_msg=f"{variant} {k}")
        assert all(np.array_equal(got["params"][k],
                                  port_ranks[0][variant]["params"][k])
                   for k in got["params"])


def test_zero1_bitwise_equals_bucketed_from_jax_init(port_ranks):
    for r in port_ranks:
        assert r["zero1"]["losses"] == r["bucketed"]["losses"]
        for k, v in r["bucketed"]["params"].items():
            assert np.array_equal(r["zero1"]["params"][k], v), k


def test_no_sync_rank_equals_single_device_on_its_rows(port_ranks,
                                                       jax_runs, tokens):
    cfg = TransformerConfig.tiny()
    init = jax_runs["bucketed"]["init"]
    for r in port_ranks:
        params = torch_dp_ranks._params_from_np(cfg, init)
        model = TransformerLM(cfg, params, device="cpu")
        step = make_train_step(cfg, model, make_optimizer(
            cfg, model.parameters()))
        rows = torch.from_numpy(tokens[2 * r["rank"]:2 * r["rank"] + 2]
                                .astype(np.int64))
        state = {"model": model, "step": 0}
        losses = []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": rows})
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(r["none"]["losses"], losses, rtol=0,
                                   atol=1e-6)
        want = torch_dp_ranks._np_params(model)
        for k, v in want.items():
            np.testing.assert_allclose(r["none"]["params"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)
    assert not np.array_equal(port_ranks[0]["none"]["params"]["embed"],
                              port_ranks[1]["none"]["params"]["embed"])


def _dummy_factory(*args):
    raise AssertionError("never built")


def test_refusals_match_jax(port_ranks):
    for (mesh, cfg_kw, kw), got in zip(REFUSALS, port_ranks[0]["refusals"]):
        kw = {k: (_dummy_factory if v == "dummy" else v)
              for k, v in kw.items()}
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jsharded(JConfig.tiny(**cfg_kw), _jax_mesh(mesh), GB, **kw)
        assert got is not None, (mesh, cfg_kw, kw)
        assert got[0] == type(want.value).__name__, (got, want.value)
    for got in port_ranks[0]["refusals"][len(REFUSALS):]:
        assert got is None, got


@pytest.fixture(scope="module")
def bert_case():
    cfg = tbert.tiny_bert_config()
    gen = torch.Generator().manual_seed(5)
    params = init_params(cfg, gen, "cpu")
    model = TransformerLM(cfg, params, device="cpu")
    init = torch_dp_ranks._np_params(model)
    tokens = tbert.synthetic_corpus(GB, 32, cfg.vocab_size, seed=2,
                                    device="cpu")["tokens"].numpy()
    step = tbert.make_train_step(cfg, model, make_optimizer(
        cfg, model.parameters()), seed=0)
    state, losses = {"model": model, "step": 0}, []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    return init, tokens, {"losses": losses,
                          "params": torch_dp_ranks._np_params(model)}


def test_bert_world2_equals_single_device(bert_case):
    init, tokens, want = bert_case
    ranks = multi_process_runner.run(
        torch_dp_ranks.bert_rank, 2, args=(init, tokens, STEPS),
        device="cpu", timeout=240).return_values
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=0,
                                   atol=2e-6)
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=0, atol=1e-5,
                                       err_msg=k)

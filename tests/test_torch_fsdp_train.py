"""Port parity: fully-sharded data-parallel training — the port's
``make_sharded_train_step`` on meshes with ``fsdp`` (gloo ranks, one
spawn a world) against the JAX package's on the same mesh of its
8-device CPU mesh and against the port's single-device step, from the
same converted parameters on the same tokens.

- ``tiny()`` three steps on ``{"fsdp": 2}`` (full logits, the fused CE
  kernels' plain versions, the fused AdamW on each local shard),
  ``{"dp": 2, "fsdp": 2}`` (also ``zero=1``: AdamW's moments sliced over
  ``dp`` on the fsdp-local leaves) and ``{"fsdp": 2, "tp": 2}``; MoE on
  ``{"fsdp": 2, "ep": 2}`` (the experts are not cut over ``fsdp``,
  everything else is) against JAX's single device: every step's loss
  within 2e-6 and the gathered parameters within 1e-5
  (``tests/test_torch_dp_train.py``'s tolerances), the same on every
  rank; each rank holds ``1/fsdp`` of every d_model dim.
- The gathers a step: six weights a layer, gathered again in the remat
  recompute, and the embedding once for the lookup and once more for the
  kernel loss's head; one reduce-scatter a use.
- BERT MLM on ``{"fsdp": 2}`` through ``step_factory``, JAX's masks fed
  through ``masking=``: losses within 2e-6, parameters within 2e-5, as
  ``tests/test_torch_tp_bert.py`` holds sharded BERT and for its reason.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, synthetic_tokens)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, make_optimizer, make_train_step)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_moe_ranks
from torch_dp_ranks import _np_params, _params_from_np
from torch_tp_jax import assert_close, jax_bert_run, jax_run

GB, STEPS = 8, 3
FSDP2 = {"fsdp": 2}
MOE = {"moe_experts": 4, "moe_capacity_factor": 0.5}
#: name → (axes, config kwargs, step kwargs), by world
CASES = {
    2: {"fsdp2": (FSDP2, {}, {}),
        "fsdp2_kernel": (FSDP2, {"loss_impl": "kernel"}, {}),
        "fsdp2_fused_opt": (FSDP2, {"fused_optimizer": True}, {})},
    4: {"dp2fsdp2": ({"dp": 2, "fsdp": 2}, {}, {}),
        "dp2fsdp2_zero1": ({"dp": 2, "fsdp": 2}, {}, {"zero": 1}),
        "fsdp2tp2": ({"fsdp": 2, "tp": 2}, {}, {}),
        "fsdp2ep2_moe": ({"fsdp": 2, "ep": 2}, MOE, {})},
}
ALL = [(w, n) for w in sorted(CASES) for n in CASES[w]]


def _jax_axes(name, axes):
    # JAX's dp×ep runs part from its single device on this XLA-CPU
    # runtime (tests/test_flagship_parallelism.py): MoE's reference is
    # JAX's single device
    return {"dp": 1} if name.endswith("_moe") else axes


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def bert_tokens():
    return np.asarray(jbert.synthetic_corpus(
        GB, 32, jbert.tiny_bert_config().vocab_size, seed=2)["tokens"])


@pytest.fixture(scope="module")
def jax_runs(tokens):
    return {name: jax_run(_jax_axes(name, axes), kw, step_kw, tokens, STEPS)
            for w, name in ALL for axes, kw, step_kw in [CASES[w][name]]}


@pytest.fixture(scope="module")
def jax_bert(bert_tokens):
    return jax_bert_run(FSDP2, {}, bert_tokens, STEPS)


@pytest.fixture(scope="module")
def port_ranks(jax_runs, jax_bert, tokens, bert_tokens):
    tok = tokens.astype(np.int64)
    out = {}
    for world, cases in CASES.items():
        jobs = [("train", "train_rank", (
            [(name, axes, kw, step_kw, jax_runs[name]["init"])
             for name, (axes, kw, step_kw) in cases.items()], tok, STEPS))]
        if world == 2:
            jobs.append(("bert", "bert_rank", (
                FSDP2, [("plain", {})], jax_bert["init"],
                bert_tokens.astype(np.int64), jax_bert["masks"], STEPS)))
        out[world] = multi_process_runner.run(
            torch_moe_ranks.jobs_rank, world, args=(jobs,), device="cpu",
            timeout=600).return_values
    return out


def _single(cfg_kw, init, tokens):
    cfg = TransformerConfig.tiny(**cfg_kw)
    model = TransformerLM(cfg, _params_from_np(cfg, init), device="cpu")
    step = make_train_step(cfg, model, make_optimizer(
        cfg, model.parameters()))
    state, losses = {"model": model, "step": 0}, []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(
            tokens.astype(np.int64))})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _np_params(model)}


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_fsdp_step_matches_jax_and_single_device(port_ranks, jax_runs,
                                                 tokens, world, name):
    axes, kw, _ = CASES[world][name]
    want = _single(kw, jax_runs[name]["init"], tokens)
    ranks = port_ranks[world]
    for r in ranks:
        got = r["train"][name]
        assert_close(got, jax_runs[name], f"{name} vs JAX")
        assert_close(got, want, f"{name} vs port")
        assert got["losses"] == ranks[0]["train"][name]["losses"]
    shapes = ranks[0]["train"][name]["local_shapes"]
    d = 64 // axes["fsdp"]
    assert shapes["embed"] == (256 // axes.get("tp", 1), d)
    assert shapes["layers/attn/query"][1] == d
    assert shapes["layers/attn/out"][-1] == d
    assert shapes["layers/RMSNorm_1/scale"] == (2, 64)
    if "moe" in name:
        assert shapes["layers/moe/wi"] == (2, 2, 64, 128)
    else:
        assert shapes["layers/mlp/wi"] == (2, d, 256 // axes.get("tp", 1))


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_fsdp_gathers_a_step(port_ranks, world, name):
    """Six weights a layer (four with MoE, whose experts stay whole on
    the rank), twice under remat, and the embedding once a use; one
    reduce-scatter a use."""
    _, kw, _ = CASES[world][name]
    per_layer = 4 if kw.get("moe_experts") else 6
    embeds = 2 if kw.get("loss_impl") == "kernel" else 1
    for r in port_ranks[world]:
        got = r["train"][name]
        assert got["fsdp_gathers"] == STEPS * (2 * 2 * per_layer + embeds)
        assert got["fsdp_scatters"] == STEPS * (2 * per_layer + embeds)


def test_fsdp_zero1_slices_the_local_leaves(port_ranks):
    got = port_ranks[4][0]["train"]["dp2fsdp2_zero1"]["summary"]
    assert got["n_shards"] == 2
    local = sum(int(np.prod(s)) for s in port_ranks[4][0]["train"][
        "dp2fsdp2_zero1"]["local_shapes"].values())
    assert got["elements"] >= local


def test_fsdp_bert_matches_jax(port_ranks, jax_bert):
    for r in port_ranks[2]:
        assert_close(r["bert"]["plain"], jax_bert, "bert fsdp2",
                     param_atol=2e-5)

"""Port parity: sequence-parallel training — ``make_sharded_train_step``
on meshes with ``sp`` (gloo ranks, one spawn a world) against the JAX
package's on the same mesh of its 8-device CPU mesh, from the same
converted parameters on the same tokens.

- ``tiny()`` three steps on ``{"sp": 2}`` (full logits, the fused CE
  kernels, the scan-chunked loss, the flash ring, striped and Ulysses
  through the kernels' plain versions — JAX's ``sp_attn_impl=
  "interpret"`` — and the fused AdamW), ``{"sp": 4}`` (the ring,
  striped, Ulysses), ``{"dp": 2, "sp": 2}`` (also ``zero=1``) and
  ``{"sp": 2, "tp": 2}``: every step's loss within 2e-6 and the
  gathered parameters within 1e-5 (``tests/test_torch_dp_train.py``'s
  tolerances), the same on every rank. JAX's ``tiny()`` keeps
  ``attention_impl="reference"``; on an sp mesh both packages take the
  unfused ring there.
- BERT MLM on ``{"sp": 2}`` (the non-causal ring), JAX's masks fed
  through ``masking=``: losses within 2e-6, parameters within 2e-5, as
  ``tests/test_torch_tp_bert.py`` holds dp×tp BERT and for its reason.
  Two elements are ill-conditioned under AdamW after three steps: JAX's
  own BERT step puts ``key[1, 46, 3, 11]`` 9.7e-6 apart between its
  ``{"sp": 2}`` and ``{"dp": 1}`` meshes (the port's sp2 lands 1.35e-5
  from JAX's sp2, its single-device step 2.2e-7), and ``wi[1, 22, 71]``
  is the element that test names (1.32e-5); every other element agrees
  within 4e-7.
- Remat: the flash ring under ``remat_policy="attn"`` saves the
  registered ring op's output (no forward kernel and no shift in the
  recompute) and under ``"nothing"`` sends the forward's shifts again;
  the gradients are the same bit for bit.
- Rotary at a rank's global positions equals the global rotary's
  slice, bit for bit.
- The config takes every field of JAX's ``TransformerConfig`` with its
  name, order and default, and ``tiny()``'s keyword arguments; it
  checks ``sp_impl`` and ``sp_attn_impl`` as ``make_ring_attention``
  does, and takes ``moe_experts > 0`` as JAX's does.
- The refusals: ``grad_sync="bucketed"``/``"none"`` on an sp mesh raise
  JAX's ``ValueError``; a sequence that ``sp`` does not divide raises
  ``ValueError`` (JAX's GSPMD pads). MoE on an sp mesh and an ``ep``
  mesh build their steps (they train in
  ``tests/test_torch_moe_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded,
    rotary_embedding as jrotary, synthetic_tokens)
from distributed_tensorflow_tpu.parallel import sequence_parallel as jsp
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig as TConfig, rotary_embedding)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_sp_ranks
from torch_tp_jax import assert_close, jax_bert_run, jax_mesh, jax_run

GB, STEPS = 8, 3
SP2, SP4 = {"sp": 2}, {"sp": 4}
FLASH = {"sp_attn_impl": "interpret"}
#: name → (axes, config kwargs, step kwargs), by world
CASES = {
    2: {"sp2": (SP2, {}, {}),
        "sp2_kernel": (SP2, {"loss_impl": "kernel"}, {}),
        "sp2_chunks": (SP2, {"loss_chunks": 2}, {}),
        "sp2_flash": (SP2, FLASH, {}),
        "sp2_striped": (SP2, {"sp_impl": "striped", **FLASH}, {}),
        "sp2_ulysses": (SP2, {"sp_impl": "ulysses", **FLASH}, {}),
        "sp2_fused_opt": (SP2, {"fused_optimizer": True}, {})},
    4: {"sp4": (SP4, {}, {}),
        "sp4_striped": (SP4, {"sp_impl": "striped", **FLASH}, {}),
        "sp4_ulysses": (SP4, {"sp_impl": "ulysses", **FLASH}, {}),
        "dp2sp2": ({"dp": 2, "sp": 2}, {}, {}),
        "dp2sp2_zero1": ({"dp": 2, "sp": 2}, {}, {"zero": 1}),
        "sp2tp2": ({"sp": 2, "tp": 2}, {}, {})},
}
ALL = [(w, n) for w in sorted(CASES) for n in CASES[w]]
#: (axes, config kwargs, step kwargs) refused with JAX's ValueError
JAX_REFUSALS = [(SP2, {}, {"grad_sync": "bucketed"}),
                (SP2, {}, {"grad_sync": "none"})]
#: refused by the port alone: (..., type, what the message names); type
#: None: the step builds
PORT_REFUSALS = [
    (SP2, {"moe_experts": 2}, {}, None, None),
    ({"ep": 2}, {}, {}, None, None),
    (SP2, {"max_seq_len": 127}, {}, "ValueError", "divisible by sp=2"),
]
#: remat runs of the flash ring on {"sp": 2}: name → config kwargs, and
#: the sends a rank makes in one step over tiny()'s 2 layers: a layer's
#: forward shifts K/V once, its backward once and hops dk/dv twice, and
#: "nothing" runs the forward again in the backward
REMAT = {"none": ({**FLASH, "remat": False}, 8),
         "nothing": ({**FLASH, "remat_policy": "nothing"}, 10),
         "attn": ({**FLASH, "remat_policy": "attn"}, 8),
         "dots_attn": ({**FLASH, "remat_policy": "dots_attn"}, 8)}


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
    return {(w, name): jax_run(axes, kw, step_kw, tokens, STEPS)
            for w, name in ALL for axes, kw, step_kw in [CASES[w][name]]}


@pytest.fixture(scope="module")
def jax_bert(bert_tokens):
    return jax_bert_run(SP2, {}, bert_tokens, STEPS)


@pytest.fixture(scope="module")
def port_ranks(jax_runs, jax_bert, tokens, bert_tokens):
    tok = tokens.astype(np.int64)
    init = jax_runs[(2, "sp2")]["init"]
    out = {}
    for world, cases in CASES.items():
        jobs = {"train": (
            [(name, axes, kw, step_kw, jax_runs[(world, name)]["init"])
             for name, (axes, kw, step_kw) in cases.items()], tok, STEPS,
            [r[:3] for r in JAX_REFUSALS + PORT_REFUSALS]
            if world == 2 else [])}
        if world == 2:
            jobs["bert"] = (SP2, [("plain", {})], jax_bert["init"],
                            bert_tokens.astype(np.int64), jax_bert["masks"],
                            STEPS)
            jobs["remat"] = ([(n, kw) for n, (kw, _) in REMAT.items()],
                             tok[:2], init)
        out[world] = multi_process_runner.run(
            torch_sp_ranks.train_rank, world, args=(jobs,), device="cpu",
            timeout=600).return_values
    return out


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_sp_step_matches_jax(port_ranks, jax_runs, world, name):
    ranks = port_ranks[world]
    for r in ranks:
        assert_close(r["train"][name], jax_runs[(world, name)], name)
        assert r["train"][name]["losses"] == \
            ranks[0]["train"][name]["losses"]
    if name == "sp2tp2":
        shapes = ranks[0]["train"][name]["local_shapes"]
        assert shapes["layers/attn/query"] == (2, 64, 2, 16)


def test_sp_bert_matches_jax(port_ranks, jax_bert):
    for r in port_ranks[2]:
        assert_close(r["bert"]["plain"], jax_bert, "bert sp2",
                     param_atol=2e-5)


@pytest.mark.parametrize("policy", sorted(REMAT))
def test_remat_over_the_ring(port_ranks, policy):
    """The flash ring under each remat policy: the same loss and
    gradients as without remat, bit for bit, and the sends the policy
    implies."""
    for r in port_ranks[2]:
        got, base = r["remat"][policy], r["remat"]["none"]
        assert got["loss"] == base["loss"]
        for k, g in got["grads"].items():
            np.testing.assert_array_equal(g, base["grads"][k], err_msg=k)
        assert got["sends"] == REMAT[policy][1], got["sends"]


def test_sp_refusals(port_ranks):
    got = port_ranks[2][0]["train"]["refusals"]
    for (axes, cfg_kw, kw), g in zip(JAX_REFUSALS, got):
        with pytest.raises(ValueError):
            jsharded(JConfig.tiny(**cfg_kw), jax_mesh(axes), GB, **kw)
        assert g is not None and g[0] == "ValueError", (kw, g)
    for (_, _, _, kind, names), g in zip(PORT_REFUSALS,
                                          got[len(JAX_REFUSALS):]):
        if kind is None:
            assert g is None, g
        else:
            assert g is not None and g[0] == kind and names in g[1], g


@pytest.mark.parametrize("sp,rank", [(2, 1), (4, 3), (8, 5)])
def test_rotary_at_global_positions(sp, rank):
    """A rank's rotary (``offset`` = its chunk's first position) is the
    global rotary's slice bit for bit, and both are JAX's to f32
    rounding."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 4, 128, 16)).astype(np.float32))
    n = 128 // sp
    cols = slice(rank * n, (rank + 1) * n)
    whole = rotary_embedding(x, seq_axis=-2)
    part = rotary_embedding(x[:, :, cols].contiguous(), seq_axis=-2,
                            offset=cols.start)
    assert torch.equal(part, whole[:, :, cols])
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jrotary(jnp.asarray(x.numpy()),
                                          seq_axis=-2)),
        rtol=0, atol=2e-6)


def _jax_kwargs(jcfg) -> dict:
    """A JAX config's fields as keyword arguments for the port's: the
    dtypes become torch's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dtype"] = getattr(torch, jnp.dtype(kw["dtype"]).name)
    return kw


def test_config_takes_every_jax_field():
    assert ([f.name for f in dataclasses.fields(TConfig)]
            == [f.name for f in dataclasses.fields(JConfig)])
    kw = _jax_kwargs(JConfig())
    assert kw["adam_mu_dtype"] is None and kw["mesh"] is None
    assert TConfig(**kw) == TConfig()
    assert TConfig(**_jax_kwargs(JConfig.tiny())) == TConfig.tiny()
    tiny_kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   d_ff=128, max_seq_len=128, attention_impl="reference")
    assert (TConfig(dtype=torch.float32, **tiny_kw)
            == TConfig(**_jax_kwargs(JConfig(dtype=jnp.float32,
                                             **tiny_kw))))


def test_config_checks_sp_fields_as_jax():
    mesh = jax_mesh(SP2)
    for kw in ({"impl": "zigzag"}, {"attn_impl": "bogus"}):
        with pytest.raises(ValueError):
            jsp.make_ring_attention(mesh, **kw)
    with pytest.raises(ValueError, match="impl="):
        TConfig.tiny(sp_impl="zigzag")
    with pytest.raises(ValueError, match="attn_impl="):
        TConfig.tiny(sp_attn_impl="bogus")
    assert TConfig.tiny(moe_experts=4).moe_experts == \
        JConfig.tiny(moe_experts=4).moe_experts == 4
    cfg = TConfig.tiny(moe_top_k=2, moe_capacity_factor=2.0,
                       moe_aux_weight=0.1, attn_block_q=8, loss_block_v=64,
                       loss_kernel_impl="interpret",
                       optimizer_impl="interpret", mesh=None)
    assert cfg.moe_top_k == 2 and cfg.attn_block_q == 8

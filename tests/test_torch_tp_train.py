"""Port parity: tensor-parallel training on a ``{"tp": 2}`` mesh (2 gloo
ranks, one spawn) against the JAX package's
``make_sharded_train_step`` on the same mesh of its 8-device CPU mesh,
from the same converted parameters on the same tokens.

- Three steps of ``tiny()`` with the full-logits loss, the fused CE
  kernels (``loss_impl="kernel"``; JAX's in interpret mode, the port's
  plain versions on the CPU) and ``fused_optimizer=True``: every step's
  loss within 2e-6 and the gathered parameters within 1e-5 (PR 11's
  tolerances), the same on both ranks; the local shapes are the halves
  of the tp-sharded dims.
- The refusals: ``grad_sync="bucketed"`` and ``"none"`` on a tp mesh
  raise JAX's ``ValueError``; ``n_heads`` or ``d_ff`` that tp does not
  divide raise ``ValueError`` naming the dim (JAX pads or falls back to
  replicated execution there). A ``vocab_size`` that tp does not divide
  builds its step on padded rows, as JAX's does (it trains in
  ``tests/test_torch_tp_vocab_pad.py``). An ``fsdp`` mesh and a
  dense config on an ``ep`` mesh build their steps, as JAX's do (they
  train in ``tests/test_torch_fsdp_train.py`` and
  ``tests/test_torch_moe_train.py``; ``sp`` meshes in
  ``tests/test_torch_sp_train.py``).
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded,
    synthetic_tokens)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tp_ranks
from torch_tp_jax import assert_close, jax_mesh, jax_run

GB, STEPS = 8, 3
TP2 = {"tp": 2}
VARIANTS = {"plain": {}, "kernel": {"loss_impl": "kernel"},
            "fused_opt": {"fused_optimizer": True}}
#: (axes, config kwargs, step kwargs) refused with JAX's ValueError
JAX_REFUSALS = [(TP2, {}, {"grad_sync": "bucketed"}),
                (TP2, {}, {"grad_sync": "none"})]
#: refused by the port alone: (axes, config kwargs, step kwargs, type,
#: what the message names); type None: the step builds
PORT_REFUSALS = [
    (TP2, {"n_heads": 3, "d_model": 48}, {}, "ValueError", "n_heads"),
    (TP2, {"d_ff": 129}, {}, "ValueError", "d_ff"),
    (TP2, {"vocab_size": 255}, {}, None, None),
    ({"fsdp": 2}, {}, {}, None, None),
    ({"dp": 1, "ep": 2}, {}, {}, None, None),
]


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens):
    return {name: jax_run(TP2, kw, {}, tokens, STEPS)
            for name, kw in VARIANTS.items()}


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tokens):
    cases = [(name, TP2, kw, {}, jax_runs[name]["init"])
             for name, kw in VARIANTS.items()]
    refusals = [r[:3] for r in JAX_REFUSALS + PORT_REFUSALS]
    return multi_process_runner.run(
        torch_tp_ranks.train_rank, 2,
        args=(cases, tokens.astype(np.int64), STEPS, refusals),
        device="cpu", timeout=300).return_values


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tp2_step_matches_jax(port_ranks, jax_runs, variant):
    for r in port_ranks:
        assert_close(r[variant], jax_runs[variant], f"tp2 {variant}")
        assert r[variant]["losses"] == port_ranks[0][variant]["losses"]
    shapes = port_ranks[0][variant]["local_shapes"]
    assert shapes["embed"] == (128, 64)
    assert shapes["layers/attn/query"] == (2, 64, 2, 16)
    assert shapes["layers/mlp/wi"] == (2, 64, 128)
    assert shapes["final_norm/scale"] == (64,)


def test_tp_refusals(port_ranks, tokens):
    got = port_ranks[0]["refusals"]
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

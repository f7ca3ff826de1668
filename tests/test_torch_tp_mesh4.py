"""Port parity: tensor-parallel training on four gloo ranks (one spawn)
against the JAX package's ``make_sharded_train_step`` on the same mesh
of its 8-device CPU mesh, from the same converted parameters on the
same tokens: three steps of ``tiny()``, every step's loss within 2e-6
and the gathered parameters within 1e-5 (PR 11's tolerances), the same
on every rank.

- ``{"tp": 4}``: the full-logits loss and the chunked scan loss
  (``loss_chunks=4``, vocab-parallel in each chunk).
- ``{"dp": 2, "tp": 2}``: the full-logits loss, the fused CE kernels
  (JAX's in interpret mode), ``fused_optimizer=True``, and ZeRO-1 and
  ZeRO-2 against JAX's ``_make_zero_gspmd_train_step``; both ZeRO levels
  are also bitwise the port's own non-ZeRO step, and their partition is
  over the tp-local leaves sliced over dp (``summary()``).
- ``{"dcn": 2, "dp": 1, "tp": 2}``: the gradients reduced over the two
  data axes dim by dim equal JAX's ``{"dp": 2, "tp": 2}`` run (the same
  two data shards), and bitwise the port's own dp×tp run.
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, synthetic_tokens)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tp_ranks
from torch_tp_jax import assert_close, jax_run

GB, STEPS = 8, 3
TP4, DPTP = {"tp": 4}, {"dp": 2, "tp": 2}
#: name → (mesh, config kwargs, step kwargs)
VARIANTS = {
    "tp4_plain": (TP4, {}, {}),
    "tp4_chunks": (TP4, {"loss_chunks": 4}, {}),
    "dptp_plain": (DPTP, {}, {}),
    "dptp_kernel": (DPTP, {"loss_impl": "kernel"}, {}),
    "dptp_fused_opt": (DPTP, {"fused_optimizer": True}, {}),
    "dptp_zero1": (DPTP, {}, {"zero": 1}),
    "dptp_zero2": (DPTP, {}, {"zero": 2}),
}
DCN = {"dcn": 2, "dp": 1, "tp": 2}


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens):
    return {name: jax_run(axes, cfg_kw, kw, tokens, STEPS)
            for name, (axes, cfg_kw, kw) in VARIANTS.items()}


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tokens):
    cases = [(name, axes, cfg_kw, kw, jax_runs[name]["init"])
             for name, (axes, cfg_kw, kw) in VARIANTS.items()]
    cases.append(("dcn_plain", DCN, {}, {}, jax_runs["dptp_plain"]["init"]))
    return multi_process_runner.run(
        torch_tp_ranks.train_rank, 4,
        args=(cases, tokens.astype(np.int64), STEPS, []),
        device="cpu", timeout=300).return_values


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mesh4_step_matches_jax(port_ranks, jax_runs, variant):
    for r in port_ranks:
        assert_close(r[variant], jax_runs[variant], variant)
        assert r[variant]["losses"] == port_ranks[0][variant]["losses"]
        for k, v in r[variant]["params"].items():
            assert np.array_equal(v, port_ranks[0][variant]["params"][k]), k


@pytest.mark.parametrize("level", [1, 2])
def test_dptp_zero_is_bitwise_the_plain_step(port_ranks, level):
    for r in port_ranks:
        z, plain = r[f"dptp_zero{level}"], r["dptp_plain"]
        assert z["losses"] == plain["losses"]
        for k, v in plain["params"].items():
            assert np.array_equal(z["params"][k], v), k
        local = sum(int(np.prod(s)) for s in plain["local_shapes"].values())
        summary = z["summary"]
        assert summary["n_shards"] == 2
        assert summary["elements"] == local
        assert summary["shard_elements"] * 2 == summary["padded_elements"]


def test_dcn_dp_tp_matches_jax_and_the_dp_tp_step(port_ranks, jax_runs):
    for r in port_ranks:
        assert_close(r["dcn_plain"], jax_runs["dptp_plain"], "dcn×dp×tp")
        assert r["dcn_plain"]["losses"] == r["dptp_plain"]["losses"]
        for k, v in r["dptp_plain"]["params"].items():
            assert np.array_equal(r["dcn_plain"]["params"][k], v), k

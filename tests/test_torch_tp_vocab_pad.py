"""Port parity: a vocabulary that ``tp`` does not divide (V = 258 =
4·64 + 2), padded to ``ceil(V/tp)·tp`` rows.

The JAX package (jax 0.9.0) refuses this vocabulary on a ``{"tp": 4}``
mesh (checked here): its ``make_sharded_train_step`` and its serving
engine place the ``(258, 64)`` embedding with a ``NamedSharding`` over
``tp``, and ``jit``/``device_put`` raise ``ValueError`` (4 does not
divide 258).
The port pads instead, so its tp-4 runs are held to JAX on the nearest
mesh JAX takes, ``{"tp": 2}`` (2 divides 258), which computes the same
function:

- Training, four gloo ranks (one spawn): three steps of ``tiny(V=258)``
  on ``{"tp": 4}`` with the full-logits loss, the chunked scan loss
  (``loss_chunks=4``) and ``loss_impl="kernel"`` (which falls back to
  the scan loss there, as JAX's ``_kernel_mesh_ok`` would), each held to
  JAX's same variant on ``{"tp": 2}``; and on ``{"dp": 2, "tp": 2}``
  with the full-logits loss and the fused CE kernels, held to JAX on
  the same mesh. Every step's loss within 2e-6 and the gathered
  parameters within 1e-5 (PR 11's tolerances), the same on every rank.
  ``gather_params`` returns JAX's ``(258, 64)`` embedding, and each
  tp-4 shard holds 65 rows.
- Serving, four gloo ranks (one spawn): the ``{"tp": 4}`` engine's
  greedy streams, plain and speculative, equal the single-device JAX
  engine's token for token (the pad columns are dropped before the
  argmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel, synthetic_tokens)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tp_ranks
from torch_tp_jax import assert_close, jax_mesh, jax_run

GB, STEPS, V = 8, 3, 258
TP4, TP2, DPTP = {"tp": 4}, {"tp": 2}, {"dp": 2, "tp": 2}
PAD = {"vocab_size": V}
#: name → (the port's mesh, config kwargs, JAX's mesh)
VARIANTS = {
    "tp4_plain": (TP4, PAD, TP2),
    "tp4_chunks": (TP4, {**PAD, "loss_chunks": 4}, TP2),
    "tp4_kernel": (TP4, {**PAD, "loss_impl": "kernel"}, TP2),
    "dptp_plain": (DPTP, PAD, DPTP),
    "dptp_kernel": (DPTP, {**PAD, "loss_impl": "kernel"}, DPTP),
}
PROMPTS = [[3, 14, 15, 92, 65], [257, 256, 3], [200, 100, 50, 25, 12],
           [42]]
KW = dict(num_blocks=32, block_size=8, max_slots=4, max_prompt_len=16)
SERVE = {"plain": ("engine", PROMPTS, 6, KW),
         "speculative": ("engine", PROMPTS, 6, {**KW, "speculative_k": 2})}


@pytest.fixture(scope="module")
def tokens():
    # ids up to V - 1, so the last shard's real rows are looked up
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len, V,
                                       seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens):
    return {name: jax_run(jaxes, cfg_kw, {}, tokens, STEPS)
            for name, (_, cfg_kw, jaxes) in VARIANTS.items()}


def test_jax_refuses_the_tp4_padded_vocab(tokens):
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_run(TP4, PAD, {}, tokens, 1)
    jcfg = JConfig.tiny(max_seq_len=64, vocab_size=V)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    with pytest.raises(ValueError, match="divisible by 4"):
        JEngine(jcfg, jparams, mesh=jax_mesh(TP4), **KW)


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tokens):
    cases = [(name, axes, cfg_kw, {}, jax_runs[name]["init"])
             for name, (axes, cfg_kw, _) in VARIANTS.items()]
    return multi_process_runner.run(
        torch_tp_ranks.train_rank, 4,
        args=(cases, tokens.astype(np.int64), STEPS, []),
        device="cpu", timeout=300).return_values


def test_tokens_reach_the_last_rows(tokens):
    assert tokens.max() >= 4 * 64


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_padded_vocab_step_matches_jax(port_ranks, jax_runs, variant):
    for r in port_ranks:
        assert r[variant]["params"]["embed"].shape == (V, 64)
        assert_close(r[variant], jax_runs[variant], variant)
        assert r[variant]["losses"] == port_ranks[0][variant]["losses"]
    rows = 65 if VARIANTS[variant][0] == TP4 else 129
    assert port_ranks[0][variant]["local_shapes"]["embed"] == (rows, 64)


@pytest.fixture(scope="module")
def served():
    jcfg = JConfig.tiny(max_seq_len=64, vocab_size=V)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    tparams = params_from_jax(TransformerConfig.tiny(max_seq_len=64,
                                                     vocab_size=V),
                              jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    flat = {"embed": tparams["embed"].numpy(),
            "final_norm/scale": tparams["final_norm"]["scale"].numpy()}
    for g, leaves in tparams["layers"].items():
        for n, t in leaves.items():
            flat[f"layers/{g}/{n}"] = t.numpy()
    want = {name: JEngine(jcfg, jparams, **kw).generate(
        prompts, max_new_tokens=new)
        for name, (_, prompts, new, kw) in SERVE.items()}
    cases = [(name, *spec) for name, spec in SERVE.items()]
    ranks = multi_process_runner.run(
        torch_tp_ranks.serve_rank, 4, args=(TP4, flat, cases, PAD),
        device="cpu", timeout=300).return_values
    return want, ranks


@pytest.mark.parametrize("case", sorted(SERVE))
def test_tp4_padded_vocab_streams_equal_jax_engine(served, case):
    want, ranks = served
    for r in ranks:
        assert r[case]["streams"] == want[case], (r["rank"], case)
        acct = r[case]["accounting"]
        assert acct["conserved"] and acct["leaked_refs"] == 0

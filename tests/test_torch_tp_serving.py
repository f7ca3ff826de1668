"""Port parity: tensor-parallel serving — the port's ``InferenceEngine``
and ``DisaggregatedEngine(wire=True)`` with ``mesh=`` on ``{"tp": 2}``
(2 gloo ranks) and ``{"dp": 2, "tp": 2}`` (4 ranks), one spawn each,
against the JAX engines on the same mesh of the 8-device CPU mesh, at
``tiny()`` in f32 on the same weights (flax init → ``params_from_jax``):

- the greedy streams equal the JAX engine's token for token (as JAX's
  ``test_greedy_decode_matches_recompute_dp_tp_mesh`` and
  ``test_matches_recompute_dp_tp_mesh``), plain, under preemption, with
  an int8 pool, with speculative decoding (the verify's rows split
  over dp) and after ``install_version`` re-shards the same weights (the
  JAX engine's streams without a swap), on every rank, with the block
  accounting conserved;
- an exported payload gathers the heads over tp into the single-device
  engine's layout: the same fingerprint, shapes, dtypes, bytes and wire
  length (the engines' own provenance fields — pool epoch, arrival and
  TTFT — set equal first), and K/V rows within 1e-5 of the
  single-device engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving.migrate import (
    DisaggregatedEngine as JDisagg)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tp_ranks
from torch_tp_jax import jax_mesh

PROMPTS = [[3, 14, 15, 92, 65], [1, 2, 3], [200, 100, 50, 25, 12, 6, 3, 1],
           [42]]
KW = dict(num_blocks=32, block_size=8, max_slots=4, max_prompt_len=16)
#: name → (kind, prompts, new tokens, engine kwargs)
CASES = {
    "plain": ("engine", PROMPTS, 6, KW),
    "preempted": ("engine", [[7, 7, 7], [8, 8, 8, 8], [9, 9]], 8,
                  dict(num_blocks=6, block_size=4, max_slots=4,
                       max_prompt_len=16)),
    "kv_int8": ("engine", PROMPTS, 6, {**KW, "kv_dtype": "int8"}),
    "speculative": ("engine", PROMPTS, 6, {**KW, "speculative_k": 2}),
    "disagg": ("disagg", PROMPTS, 4, {**KW, "num_decode": 1}),
    "swapped": ("swap", PROMPTS, 6, KW),
}
MESHES = {"tp2": {"tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    tparams = params_from_jax(TransformerConfig.tiny(max_seq_len=64),
                              jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    flat = {"embed": tparams["embed"].numpy(),
            "final_norm/scale": tparams["final_norm"]["scale"].numpy()}
    for g, leaves in tparams["layers"].items():
        for n, t in leaves.items():
            flat[f"layers/{g}/{n}"] = t.numpy()
    return jcfg, jparams, flat


@pytest.fixture(scope="module", params=sorted(MESHES))
def served(request, weights):
    jcfg, jparams, flat = weights
    axes = MESHES[request.param]
    mesh = jax_mesh(axes)
    want = {}
    for name, (kind, prompts, new, kw) in CASES.items():
        cls = JDisagg if kind == "disagg" else JEngine
        extra = {"wire": True} if kind == "disagg" else {}
        want[name] = cls(jcfg, jparams, mesh=mesh, **extra, **kw).generate(
            prompts, max_new_tokens=new)
    n = int(np.prod(list(axes.values())))
    cases = [(name, *spec) for name, spec in CASES.items()]
    ranks = multi_process_runner.run(
        torch_tp_ranks.serve_rank, n, args=(axes, flat, cases),
        device="cpu", timeout=300).return_values
    return request.param, want, ranks


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_streams_equal_jax_engine(served, case):
    _, want, ranks = served
    for r in ranks:
        assert r[case]["streams"] == want[case], (r["rank"], case)
        acct = r[case]["accounting"]
        assert acct["conserved"] and acct["leaked_refs"] == 0
    if case == "disagg":
        assert all(r[case]["migrations"] > 0 for r in ranks)


def test_export_payload_has_the_single_device_layout(served):
    _, _, ranks = served
    for r in ranks:
        p = r["payload"]
        assert p["fingerprint_equal"] and p["generated_equal"]
        assert p["dtypes_equal"]
        assert p["wire_bytes"][0] == p["wire_bytes"][1]
        assert p["nbytes"][0] == p["nbytes"][1]
        assert all(a == b for a, b in p["shapes"].values())
        assert p["k_err"] <= 1e-5 and p["v_err"] <= 1e-5

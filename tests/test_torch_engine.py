"""Port parity: the port's ``InferenceEngine`` against the JAX
``InferenceEngine`` on the CPU, at ``tiny()`` in f32, on the same
weights (flax init → ``params_from_jax``) and the same prompts.

Greedy token streams must be identical — plain, under preemption, with
bf16 and int8 KV pools, for BERT-style scoring requests and with an
EOS id — and the port's block accounting must be conserved at idle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    QueueOverflowError, Request)

PROMPTS = [[3, 14, 15, 92, 65], [1, 2, 3], [200, 100, 50, 25, 12, 6, 3, 1],
           [42]]


def _weights(causal=True, max_seq_len=64, seed=0):
    jcfg = JConfig.tiny(max_seq_len=max_seq_len, causal=causal)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=max_seq_len, causal=causal)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


@pytest.fixture(scope="module")
def causal_weights():
    return _weights()


def _conserved(engine):
    acct = engine.block_accounting()
    assert acct["conserved"] and acct["leaked_refs"] == 0
    assert acct["free"] == acct["usable"]


ENGINE_CASES = {
    "plain": dict(prompts=PROMPTS, new=6,
                  kw=dict(num_blocks=32, block_size=8, max_slots=4,
                          max_prompt_len=16)),
    "preempted": dict(prompts=[[7, 7, 7], [8, 8, 8, 8], [9, 9]], new=8,
                      kw=dict(num_blocks=6, block_size=4, max_slots=4,
                              max_prompt_len=16)),
    "kv_bf16": dict(prompts=PROMPTS, new=6,
                    kw=dict(num_blocks=32, block_size=8, max_slots=4,
                            max_prompt_len=16, kv_dtype="bf16")),
    "kv_int8": dict(prompts=PROMPTS, new=6,
                    kw=dict(num_blocks=32, block_size=8, max_slots=4,
                            max_prompt_len=16, kv_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_generate_matches_jax_engine(causal_weights, case):
    jcfg, jparams, cfg, tparams = causal_weights
    spec = ENGINE_CASES[case]
    want = JEngine(jcfg, jparams, **spec["kw"]).generate(
        spec["prompts"], max_new_tokens=spec["new"])
    engine = InferenceEngine(cfg, tparams, device="cpu", **spec["kw"])
    got = engine.generate(spec["prompts"], max_new_tokens=spec["new"])
    assert got == want
    assert all(len(o) == spec["new"] for o in got)
    _conserved(engine)
    stats = engine.stats()
    assert stats["requests_completed"] == len(spec["prompts"])
    if case == "preempted":
        assert stats["preemptions"] > 0
        # every re-admission re-runs prefill on the replayed prompt
        assert stats["prefills"] == len(spec["prompts"]) + \
            stats["preemptions"]
    else:
        assert stats["preemptions"] == 0


def test_tiny_streams_match_jax_without_flash(causal_weights, monkeypatch):
    """At ``tiny()`` (``attention_impl="reference"``, as in JAX) the
    engine never reaches the flash forward, and its greedy streams
    still equal the JAX engine's."""
    from distributed_tensorflow_tpu_torch.serving import decode as tdec

    def flash(*a, **kw):
        raise AssertionError("flash_attention reached at tiny()")

    monkeypatch.setattr(tdec, "flash_attention", flash)
    jcfg, jparams, cfg, tparams = causal_weights
    assert cfg.attention_impl == "reference"
    spec = ENGINE_CASES["plain"]
    want = JEngine(jcfg, jparams, **spec["kw"]).generate(
        spec["prompts"], max_new_tokens=spec["new"])
    engine = InferenceEngine(cfg, tparams, device="cpu", **spec["kw"])
    assert engine.generate(spec["prompts"],
                           max_new_tokens=spec["new"]) == want
    _conserved(engine)


def test_eos_stops_at_first_occurrence(causal_weights):
    """EOS set to a token whose FIRST occurrence in the JAX stream is at
    a known index: both engines stop right after it."""
    jcfg, jparams, cfg, tparams = causal_weights
    kw = dict(num_blocks=32, block_size=8, max_slots=2, max_prompt_len=16)
    prompt = (5, 6, 7, 9, 11)
    ref = JEngine(jcfg, jparams, **kw).generate([prompt],
                                                max_new_tokens=10)[0]
    idx = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    eos = ref[idx]
    jeng = JEngine(jcfg, jparams, **kw)
    jeng.submit(JRequest(id="e", tokens=prompt, max_new_tokens=10,
                         eos_id=eos))
    want = jeng.run_until_idle()["e"]["tokens"]
    engine = InferenceEngine(cfg, tparams, device="cpu", **kw)
    engine.submit(Request(id="e", tokens=prompt, max_new_tokens=10,
                          eos_id=eos))
    got = engine.run_until_idle()["e"]["tokens"]
    assert got == want == ref[:idx + 1]
    _conserved(engine)


def test_bert_scoring_matches_jax_engine():
    jcfg, jparams, cfg, tparams = _weights(causal=False, max_seq_len=32,
                                           seed=1)
    kw = dict(num_blocks=16, block_size=8, max_slots=2, max_prompt_len=16)
    prompts = {"s0": (3, 1, 4), "s1": (1, 5, 9, 2, 6), "s2": (2, 7, 1, 8)}
    jeng = JEngine(jcfg, jparams, **kw)
    engine = InferenceEngine(cfg, tparams, device="cpu", **kw)
    with pytest.raises(ValueError):
        engine.submit(Request(id="gen", tokens=(1, 2), max_new_tokens=4))
    for rid, p in prompts.items():
        jeng.submit(JRequest(id=rid, tokens=p, max_new_tokens=0))
        engine.submit(Request(id=rid, tokens=p, max_new_tokens=0))
    want = jeng.run_until_idle()
    got = engine.run_until_idle()
    for rid in prompts:
        assert got[rid]["tokens"] == want[rid]["tokens"]
        assert len(got[rid]["tokens"]) == 1
    _conserved(engine)


def test_admission_limits(causal_weights):
    _, _, cfg, tparams = causal_weights
    engine = InferenceEngine(cfg, tparams, device="cpu", num_blocks=8,
                             block_size=8, max_slots=2, max_prompt_len=8,
                             queue_capacity=1)
    with pytest.raises(ValueError):
        engine.submit(Request(id="long", tokens=tuple(range(9))))
    with pytest.raises(ValueError):
        engine.submit(Request(id="over", tokens=(1, 2),
                              max_new_tokens=63))
    engine.submit(Request(id="a", tokens=(1, 2), max_new_tokens=2))
    with pytest.raises(QueueOverflowError):
        engine.submit(Request(id="b", tokens=(3,), max_new_tokens=2))
    assert engine.stats()["queue_rejected"] == 1
    assert list(engine.run_until_idle()) == ["a"]


def test_telemetry_events(causal_weights, tmp_path):
    """The engine's JSONL events carry the JAX engine's names and
    fields."""
    from distributed_tensorflow_tpu_torch import telemetry
    _, _, cfg, tparams = causal_weights
    telemetry.configure(str(tmp_path))
    try:
        engine = InferenceEngine(cfg, tparams, device="cpu", num_blocks=16,
                                 block_size=8, max_slots=2,
                                 max_prompt_len=8)
        engine.generate([[1, 2, 3]], max_new_tokens=3)
    finally:
        telemetry.shutdown()
    events = telemetry.read_events(
        telemetry.event_log_path(str(tmp_path), 0))
    names = [e["ev"] for e in events]
    for name in ("serve.admit", "serve.prefill", "serve.token",
                 "serve.step", "serve.request"):
        assert name in names, name
    req = next(e for e in events if e["ev"] == "serve.request")
    for field in ("t", "wall", "pid", "dur_s", "span_id", "model_version",
                  "prompt_tokens", "new_tokens", "replayed_tokens",
                  "ttft_s", "preemptions"):
        assert field in req, field
    assert req["span_id"] == "req/g0" and req["new_tokens"] == 3
    assert sum(n == "serve.token" for n in names) == 2   # 1st from prefill


def test_default_device_raises_without_a_card(causal_weights):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    _, _, cfg, tparams = causal_weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, tparams)

"""The port's decode step and speculative verify take the JAX engine's
fixed shapes: a ``(max_slots,)`` batch, each sequence at its slot, over
the engine's whole window, whatever the number of running sequences;
so a request's bf16 stream served alone equals the same request served
among seven others, and equals the JAX engine's f32 stream where the
port runs f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, init_params, params_from_jax)
from distributed_tensorflow_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_tpu_torch.serving.scheduler import Request

SLOTS = 8
KW = dict(num_blocks=96, block_size=8, max_slots=SLOTS, max_prompt_len=16)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, int(rng.integers(3, 14))).tolist()
            for _ in range(n)]


def _record_shapes(engine):
    """Wrap the engine's decode and extend calls to log their shapes."""
    seen = {"decode": [], "extend": []}
    dec, ext = engine._decode, engine._extend

    def decode(params, pool, tokens, positions, lengths, write_rows,
               window_rows):
        seen["decode"].append((tuple(tokens.shape),
                               tuple(window_rows.shape)))
        return dec(params, pool, tokens, positions, lengths, write_rows,
                   window_rows)

    def extend(params, pool, tokens, positions, lengths, write_rows,
               window_rows):
        seen["extend"].append((tuple(tokens.shape),
                               tuple(window_rows.shape)))
        return ext(params, pool, tokens, positions, lengths, write_rows,
                   window_rows)
    engine._decode, engine._extend = decode, extend
    return seen


@pytest.fixture(scope="module")
def bf16_weights():
    cfg = TransformerConfig.tiny(max_seq_len=64, dtype=torch.bfloat16)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


@pytest.mark.parametrize("running", [1, 8])
def test_decode_sees_fixed_shapes(bf16_weights, running):
    cfg, params = bf16_weights
    engine = InferenceEngine(cfg, params, device="cpu", **KW)
    seen = _record_shapes(engine)
    engine.generate(_prompts(running), max_new_tokens=5)
    assert seen["decode"]
    assert set(seen["decode"]) == {((SLOTS,), (SLOTS, engine.window))}
    assert engine.window == 64


@pytest.mark.parametrize("running", [1, 8])
def test_verify_sees_fixed_shapes(bf16_weights, running):
    cfg, params = bf16_weights
    engine = InferenceEngine(cfg, params, device="cpu", speculative_k=3,
                             **KW)
    seen = _record_shapes(engine)
    engine.generate(_prompts(running), max_new_tokens=6)
    verify = [s for s in seen["extend"] if s[0][0] == SLOTS]
    assert verify
    assert set(verify) == {((SLOTS, 4), (SLOTS, engine.window))}


def test_bf16_stream_alone_equals_stream_among_seven(bf16_weights):
    cfg, params = bf16_weights
    prompts = _prompts(8, seed=3)
    alone = InferenceEngine(cfg, params, device="cpu", **KW).generate(
        prompts[:1], max_new_tokens=12)[0]
    engine = InferenceEngine(cfg, params, device="cpu", **KW)
    for i, p in enumerate(prompts):
        engine.submit(Request(id=f"r{i}", tokens=p, max_new_tokens=12))
    done = engine.run_until_idle()
    assert list(done["r0"]["tokens"]) == alone
    # the same request in another slot, after the others
    engine = InferenceEngine(cfg, params, device="cpu", **KW)
    for i, p in enumerate(prompts[1:] + prompts[:1]):
        engine.submit(Request(id=f"q{i}", tokens=p, max_new_tokens=12))
    done = engine.run_until_idle()
    assert list(done[f"q{len(prompts) - 1}"]["tokens"]) == alone


def test_f32_streams_equal_jax_engine_at_one_and_eight_running():
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for n in (1, 8):
        prompts = _prompts(n, seed=n)
        want = JEngine(jcfg, jparams, **KW).generate(prompts,
                                                     max_new_tokens=6)
        got = InferenceEngine(cfg, tparams, device="cpu", **KW).generate(
            prompts, max_new_tokens=6)
        assert got == want

"""Port parity: speculative decoding in the port's ``InferenceEngine``
against the JAX engine on the CPU, at ``tiny(max_seq_len=64)`` in f32,
seed 0, on the same weights (flax init → ``params_from_jax``).

Token streams must equal the JAX engine's with the same
``speculative_k``, for the default truncated draft, an adversarial
draft from other weights and a self-draft (whose proposed and accepted
counts must equal JAX's, acceptance 1.0), under preemption replay and
with an EOS inside a span. The draft's unmasked forward is held against
the lengths-masked one on the valid rows (logits within 1e-5), and
``kv_quantization_probe`` against JAX's (flip counts exact, errors
within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu.serving import decode as jdec
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    InferenceEngine, Request, kv_quantization_probe, truncated_draft)
from distributed_tensorflow_tpu_torch.serving import decode as tdec

LOGIT_TOL = 1e-5
X = [7, 3, 9, 1, 4, 4, 2, 8, 5, 5, 1, 9, 2, 6, 3, 7]
PROMPTS = [X, X[:12] + [9, 9], X[:5], [3, 1, 4, 1, 5]]
BASE = dict(num_blocks=32, block_size=8, max_slots=4, max_prompt_len=16)


def _convert(cfg, jparams):
    return params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=64)
    model = JModel(jcfg)
    jparams = model.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    other = model.init(jax.random.PRNGKey(42),
                       jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    return jcfg, jparams, other, cfg, _convert(cfg, jparams), \
        _convert(cfg, other)


def _both(weights, prompts, new, draft=None, **kw):
    """The JAX and the port's engine on the same submissions: their
    streams, stats and block accounting."""
    jcfg, jparams, jother, cfg, tparams, tother = weights
    jkw, tkw = dict(BASE, **kw), dict(BASE, **kw)
    if draft == "other":
        jkw.update(draft_params=jother, draft_cfg=jcfg)
        tkw.update(draft_params=tother, draft_cfg=cfg)
    elif draft == "self":
        jkw.update(draft_params=jparams, draft_cfg=jcfg)
        tkw.update(draft_params=tparams, draft_cfg=cfg)
    jeng = JEngine(jcfg, jparams, **jkw)
    teng = InferenceEngine(cfg, tparams, device="cpu", **tkw)
    out = []
    for eng in (jeng, teng):
        out.append((eng.generate(prompts, max_new_tokens=new), eng.stats(),
                    eng.block_accounting()))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_truncated_draft_streams_match_jax(weights, k):
    (jo, js, ja), (to, ts, ta) = _both(weights, PROMPTS, 6,
                                       speculative_k=k)
    assert to == jo
    assert ts["speculative"] == js["speculative"]
    assert ts["speculative"]["proposed"] > 0
    assert ta == ja and ta["free"] == ta["usable"]


def test_adversarial_draft_streams_match_jax(weights):
    """A draft from other weights (near-zero acceptance) changes only how
    many target forwards run, never what commits."""
    (jo, js, _), (to, ts, _) = _both(weights, PROMPTS, 6, draft="other",
                                     speculative_k=3)
    assert to == jo
    assert ts["speculative"] == js["speculative"]


def test_self_draft_accepts_everything(weights):
    (jo, js, _), (to, ts, _) = _both(weights, PROMPTS, 6, draft="self",
                                     speculative_k=3)
    assert to == jo
    sp = ts["speculative"]
    assert sp == js["speculative"]
    assert sp["proposed"] > 0 and sp["accepted"] == sp["proposed"]
    assert sp["accepted_rate"] == 1.0


def test_plain_decode_streams_equal(weights):
    """Speculation is output-invariant in the port: its streams equal
    the port's non-speculative engine's."""
    _, _, _, cfg, tparams, _ = weights
    plain = InferenceEngine(cfg, tparams, device="cpu", **BASE).generate(
        PROMPTS, max_new_tokens=6)
    spec = InferenceEngine(cfg, tparams, device="cpu", speculative_k=3,
                           **BASE).generate(PROMPTS, max_new_tokens=6)
    assert spec == plain


@pytest.mark.parametrize("prefix_caching", [False, True])
def test_preemption_replay_matches_jax(weights, prefix_caching):
    """Speculation with a starved pool: preempted sequences replay their
    generated tokens as prompt and re-enter the speculative loop (with
    the prefix cache too, the JAX zombie-table regression's case)."""
    pp = [[7, 7, 7], [8, 8, 8, 8], [9, 9]]
    (jo, js, ja), (to, ts, ta) = _both(
        weights, pp, 8, speculative_k=2, num_blocks=6, block_size=4,
        prefix_caching=prefix_caching)
    assert to == jo
    assert ts["preemptions"] == js["preemptions"] > 0
    assert ts["speculative"] == js["speculative"]
    assert ta == ja and ta["leaked_refs"] == 0


def test_int8_prefix_cache_and_speculation_match_jax(weights):
    """All three stacked: shared prefixes, speculation, an int8 pool."""
    prompts = [X, list(X), X[:12] + [9, 9]]
    (jo, js, ja), (to, ts, ta) = _both(weights, prompts, 6,
                                       speculative_k=2, kv_dtype="int8",
                                       prefix_caching=True)
    assert to == jo
    assert ts["prefix_cache"] == js["prefix_cache"]
    assert ts["speculative"] == js["speculative"]
    assert ta == ja


def test_eos_mid_speculation_matches_jax_engine(weights):
    """EOS inside an accepted span truncates the commit where sequential
    decode stops. The JAX test of this (``test_serving_speed.py``) sets
    eos to the third token of the reference stream ``[41, 210, 210,
    ...]``, whose first occurrence is the second token, so both engines
    rightly stop after two tokens; this compares against the JAX
    engine's output instead."""
    jcfg, jparams, _, cfg, tparams, _ = weights
    plain = JEngine(jcfg, jparams, **BASE).generate([[5, 6, 7]],
                                                    max_new_tokens=6)[0]
    eos = plain[2]
    first = plain.index(eos)
    outs = []
    for eng, req in ((JEngine(jcfg, jparams, speculative_k=3, **BASE),
                      JRequest),
                     (InferenceEngine(cfg, tparams, device="cpu",
                                      speculative_k=3, **BASE), Request)):
        eng.submit(req(id="e", tokens=(5, 6, 7), max_new_tokens=6,
                       eos_id=eos))
        outs.append(eng.run_until_idle()["e"]["tokens"])
    assert outs[1] == outs[0] == plain[:first + 1]


def test_truncated_draft_shapes_and_refusal(weights):
    _, _, _, cfg, tparams, _ = weights
    dcfg, dparams = truncated_draft(cfg, tparams, 1)
    assert dcfg.n_layers == 1 and dcfg.d_model == cfg.d_model
    q = dparams["layers"]["attn"]["query"]
    assert q.shape[0] == 1
    # slices of the target's tensors, not copies
    assert q.data_ptr() == tparams["layers"]["attn"]["query"].data_ptr()
    assert dparams["embed"] is tparams["embed"]
    assert truncated_draft(cfg, tparams)[0].n_layers == cfg.n_layers // 2
    for n in (0, cfg.n_layers + 1):
        with pytest.raises(ValueError):
            truncated_draft(cfg, tparams, n)


@pytest.mark.parametrize("impl", ["reference", None],
                         ids=["reference", "flash"])
def test_draft_unmasked_rows_equal_masked_forward(weights, impl):
    """The draft runs the right-padded histories without a length mask
    (flash forward off ``tiny()``): on every valid row its logits equal
    the lengths-masked forward's, and its proposals equal JAX's
    ``make_draft_fn`` (masked, padded to ``max_seq_len``)."""
    jcfg, jparams, _, cfg, tparams, _ = weights
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    params = tdec.canonical_params(cfg, tparams)
    rng = np.random.default_rng(3)
    lens = np.asarray([5, 12, 9], np.int64)
    toks = np.zeros((3, 12), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    t = torch.from_numpy(toks)
    masked = tdec.model_forward(cfg, params, t, torch.from_numpy(lens))
    unmasked = tdec.model_forward(cfg, params, t)
    for i, n in enumerate(lens):
        torch.testing.assert_close(unmasked[i, :n], masked[i, :n], rtol=0,
                                   atol=LOGIT_TOL)
    got = tdec.make_draft_fn(cfg)(params, t, torch.from_numpy(lens))
    assert got.tolist() == [int(masked[i, n - 1].argmax())
                            for i, n in enumerate(lens)]
    jt = np.zeros((3, jcfg.max_seq_len), np.int32)
    jt[:, :12] = toks
    want = jdec.make_draft_fn(jcfg)(
        jax.tree_util.tree_map(jnp.asarray,
                               dict(jdec.canonical_params(jcfg, jparams))),
        jnp.asarray(jt), jnp.asarray(lens, jnp.int32))
    assert got.tolist() == np.asarray(want).tolist()


def test_bidirectional_draft_keeps_the_mask(weights):
    """A non-causal draft would see padded keys unmasked, so its forward
    keeps the length mask, and its proposals stay JAX's."""
    jcfg, jparams, _, cfg, tparams, _ = weights
    jcfg = dataclasses.replace(jcfg, causal=False)
    cfg = dataclasses.replace(cfg, causal=False)
    lens = np.asarray([4, 10], np.int64)
    toks = np.zeros((2, 10), np.int64)
    toks[0, :4] = [9, 8, 7, 6]
    toks[1] = np.arange(10) * 7
    got = tdec.make_draft_fn(cfg)(tdec.canonical_params(cfg, tparams),
                                  torch.from_numpy(toks),
                                  torch.from_numpy(lens))
    jt = np.zeros((2, jcfg.max_seq_len), np.int32)
    jt[:, :10] = toks
    want = jdec.make_draft_fn(jcfg)(
        jax.tree_util.tree_map(jnp.asarray,
                               dict(jdec.canonical_params(jcfg, jparams))),
        jnp.asarray(jt), jnp.asarray(lens, jnp.int32))
    assert got.tolist() == np.asarray(want).tolist()


def test_engine_draft_takes_flash_off_tiny(weights, monkeypatch):
    """Off ``tiny()``'s reference attention the default draft's forward
    calls ``flash_attention`` once per draft layer per proposal, the
    verify never, and the streams are unchanged."""
    _, _, _, cfg, tparams, _ = weights
    cfg = dataclasses.replace(cfg, attention_impl=None)
    plain = InferenceEngine(cfg, tparams, device="cpu", **BASE).generate(
        [X[:5]], max_new_tokens=3)
    calls = []
    real = tdec.flash_attention

    def flash(q, k, v, **kw):
        calls.append(q.shape[2])
        return real(q, k, v, **kw)

    monkeypatch.setattr(tdec, "flash_attention", flash)
    eng = InferenceEngine(cfg, tparams, device="cpu", speculative_k=2,
                          **BASE)
    drafts = []
    real_draft = eng._draft
    eng._draft = lambda *a: drafts.append(1) or real_draft(*a)
    assert eng.generate([X[:5]], max_new_tokens=3) == plain
    # the cold prefill's layers, then one draft layer per proposal
    assert len(calls) == cfg.n_layers + len(drafts) * (cfg.n_layers // 2)
    assert len(drafts) > 0


@pytest.mark.parametrize("new", [2, 5])
def test_draft_runs_once_per_token_of_the_widest_span(weights, new):
    """The draft runs as many times a step as the widest span can commit
    (``_spec_span``), not k times: never when every span is 0 (one
    token left to generate), and the streams and stats stay JAX's."""
    jcfg, jparams, _, cfg, tparams, _ = weights
    jeng = JEngine(jcfg, jparams, speculative_k=3, **BASE)
    eng = InferenceEngine(cfg, tparams, device="cpu", speculative_k=3,
                          **BASE)
    drafts, widest = [], []
    real_draft, real_batch = eng._draft, eng._speculative_batch

    def batch(seqs):
        widest.append(max(eng._spec_span(s) for s in seqs))
        return real_batch(seqs)

    eng._draft = lambda *a: drafts.append(1) or real_draft(*a)
    eng._speculative_batch = batch
    assert eng.generate(PROMPTS, max_new_tokens=new) == \
        jeng.generate(PROMPTS, max_new_tokens=new)
    assert eng.stats()["speculative"] == jeng.stats()["speculative"]
    assert len(drafts) == sum(widest) and len(widest) > 0
    assert (sum(widest) == 0) == (new == 2)


def test_refusals_match_jax(weights):
    jcfg, jparams, jother, cfg, tparams, tother = weights
    with pytest.raises(ValueError):
        JEngine(jcfg, jparams, speculative_k=2, draft_params=jother, **BASE)
    with pytest.raises(ValueError):
        InferenceEngine(cfg, tparams, device="cpu", speculative_k=2,
                        draft_params=tother, **BASE)
    jbert = dataclasses.replace(jcfg, causal=False)
    bert = dataclasses.replace(cfg, causal=False)
    with pytest.raises(ValueError):
        JEngine(jbert, jparams, speculative_k=2, **BASE)
    with pytest.raises(ValueError):
        InferenceEngine(bert, tparams, device="cpu", speculative_k=2, **BASE)


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_kv_quantization_probe_matches_jax(weights, kv_dtype):
    jcfg, jparams, _, cfg, tparams, _ = weights
    want = jdec.kv_quantization_probe(jcfg, jparams, X, kv_dtype,
                                      n_steps=12)
    got = kv_quantization_probe(cfg, tparams, X, kv_dtype, n_steps=12,
                                device="cpu")
    assert got["kv_dtype"] == want["kv_dtype"]
    assert got["argmax_flips"] == want["argmax_flips"]
    assert got["positions_checked"] == want["positions_checked"] == 13
    assert abs(got["max_abs_logit_err"] - want["max_abs_logit_err"]) \
        <= LOGIT_TOL
    assert got["max_abs_logit_err"] > 0

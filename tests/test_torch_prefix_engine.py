"""Port parity: the port's ``InferenceEngine`` with ``prefix_caching=True``
(and a ``HostTier`` spill tier) against the JAX engine on the CPU, at
``tiny(max_seq_len=64)`` in f32, seed 0, on the same weights (flax init
→ ``params_from_jax``) and the same submissions.

Token streams, ``stats()["prefix_cache"]`` (and ``["spill_tier"]``) and
``block_accounting()`` must be equal. The multi-token ``extend`` forward
is held against JAX's ``make_extend_fn`` on the same pool and inputs:
logits within 1e-5, the pool rows it writes within 1e-5 (int8 codes
within one step: the rows are rounded after f32 math that differs in
its last bits between the packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import HostTier as JHostTier
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu.serving import decode as jdec
from distributed_tensorflow_tpu.serving import kv_cache as jkv
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    HostTier, InferenceEngine, Request)
from distributed_tensorflow_tpu_torch.serving import decode as tdec
from distributed_tensorflow_tpu_torch.serving import kv_cache as tkv

LOGIT_TOL = 1e-5
# a 16-token base prompt: two full blocks at block_size=8, so later
# requests can match one full block plus a partial tail (the CoW case)
X = [7, 3, 9, 1, 4, 4, 2, 8, 5, 5, 1, 9, 2, 6, 3, 7]
A13 = [5, 3, 1, 2, 6, 4, 2, 7, 9, 9, 1, 3, 5]


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


BASE = dict(num_blocks=32, block_size=8, max_slots=4, max_prompt_len=16)

# name: (engine kwargs, rounds of (prompt, max_new_tokens) submitted
# together and run to idle)
CASES = {
    # a full-block hit, then one full block plus a partial copy-on-write
    # tail, then the first prompt again
    "x_family": (dict(BASE), [[(X, 6)], [(X[:12] + [9, 9], 6)],
                              [(X, 6)]]),
    # the same prompt twice (all but the last token cached), then a
    # sibling that diverges mid-block and a prompt ending inside a
    # cached block
    "shared_then_diverge": (dict(BASE), [[(X, 6)], [(X, 6)],
                                         [(X[:12] + [9, 9], 6),
                                          (X[:11], 5)],
                                         [(X[:12] + [9, 9], 6)]]),
    # a pool too small for the concurrency: preemption, replay and
    # cache eviction all fire
    "preemption": (dict(BASE, num_blocks=8, block_size=4),
                   [[(X, 8), (X[:12] + [9, 9], 8), (X[:5], 8), (X, 8)]]),
    # a preempted sequence re-admits onto its warm blocks
    "warm_readmit": (dict(BASE, num_blocks=10, block_size=4),
                     [[(X, 8), (X[:9], 8), (X[:6], 8)]]),
    # the host spill tier: a long generation evicts the cached prompt's
    # three blocks to host memory, the prompt again re-adopts them
    "spill": (dict(BASE, num_blocks=12, block_size=4, spill_tier=4),
              [[(A13, 4)], [(A13[:4], 40)], [(A13, 4)]]),
    "int8": (dict(BASE, kv_dtype="int8"),
             [[(X, 6)], [(X, 6), (X[:12] + [9, 9], 6)]]),
}


def _serve(engine, request_cls, rounds):
    outs = []
    for r, batch in enumerate(rounds):
        for i, (prompt, new) in enumerate(batch):
            engine.submit(request_cls(id=f"r{r}_{i}", tokens=tuple(prompt),
                                      max_new_tokens=new))
        done = engine.run_until_idle()
        outs.append([done[f"r{r}_{i}"]["tokens"] for i in range(len(batch))])
    return outs


def _engines(weights, kw):
    jcfg, jparams, cfg, tparams = weights
    jkw, tkw = dict(kw), dict(kw)
    if "spill_tier" in kw:
        jkw["spill_tier"] = JHostTier(kw["spill_tier"])
        tkw["spill_tier"] = HostTier(kw["spill_tier"])
    return (JEngine(jcfg, jparams, prefix_caching=True, **jkw),
            InferenceEngine(cfg, tparams, device="cpu", prefix_caching=True,
                            **tkw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_caching_matches_jax_engine(weights, case):
    kw, rounds = CASES[case]
    jeng, teng = _engines(weights, kw)
    want = _serve(jeng, JRequest, rounds)
    got = _serve(teng, Request, rounds)
    assert got == want
    js, ts = jeng.stats(), teng.stats()
    assert ts["prefix_cache"] == js["prefix_cache"]
    assert ts["prefix_cache"]["hit_tokens"] > 0
    assert ts["preemptions"] == js["preemptions"]
    assert teng.block_accounting() == jeng.block_accounting()
    acct = teng.block_accounting()
    assert acct["conserved"] and acct["leaked_refs"] == 0
    assert acct["free"] + acct["cache_refs"] == acct["usable"]
    if case == "preemption":
        assert ts["preemptions"] > 0 and ts["prefix_cache"]["evictions"] > 0
    if case == "spill":
        assert ts["spill_tier"] == js["spill_tier"]
        assert ts["spill_tier"]["spilled"] == 3
        assert ts["spill_tier"]["readopted"] == 3
        assert got[2] == got[0]                  # re-adopted == cold


def test_caching_on_off_parity_under_preemption(weights):
    """The preemption workload decodes identically with caching on and
    off in the port (and equal to the JAX engine, above)."""
    _, _, cfg, tparams = weights
    kw, rounds = CASES["preemption"]
    outs = {}
    for on in (False, True):
        eng = InferenceEngine(cfg, tparams, device="cpu",
                              prefix_caching=on, **kw)
        outs[on] = _serve(eng, Request, rounds)
        assert eng.stats()["preemptions"] > 0
    assert outs[True] == outs[False]


def _block_bytes(engine, block):
    rows = engine._block_rows(block)
    return {n: a[:, rows].clone() for n, a in engine.pool.items()}


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_spill_round_trip_bit_exact(weights, kv_dtype):
    """An evicted block spills to host numpy and comes back into a fresh
    pool block bit for bit, scales included, for every pool dtype."""
    _, _, cfg, tparams = weights
    eng = InferenceEngine(cfg, tparams, device="cpu", kv_dtype=kv_dtype,
                          prefix_caching=True, spill_tier=HostTier(8),
                          num_blocks=16, block_size=4, max_slots=4,
                          max_prompt_len=16)
    first = eng.generate([A13], max_new_tokens=4)
    pc = eng.scheduler.prefix_cache
    before = {e.key: _block_bytes(eng, e.block)
              for e in pc._entries.values()}
    assert pc.evict(len(pc)) == len(before) == 3
    arrays = next(iter(eng.spill_tier._entries.values())).arrays
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    assert eng.spill_tier.nbytes == 3 * sum(
        a.nbytes for a in arrays.values())
    assert eng.generate([A13], max_new_tokens=4) == first
    assert pc.spill_hits == 3 and len(eng.spill_tier) == 0
    for key, want in before.items():
        got = _block_bytes(eng, pc._entries[key].block)
        for n in want:
            assert torch.equal(got[n], want[n]), n


def test_refusals_match_jax(weights):
    """Unsupported combinations raise, as the JAX engine's do; the port
    also refuses prefix caching on a bidirectional model (the JAX engine
    fails at the first hit there)."""
    jcfg, jparams, cfg, tparams = weights
    with pytest.raises(ValueError):
        JEngine(jcfg, jparams, spill_tier=4, **BASE)
    with pytest.raises(ValueError):
        InferenceEngine(cfg, tparams, device="cpu", spill_tier=4, **BASE)
    bert = dataclasses.replace(cfg, causal=False)
    with pytest.raises(ValueError):
        InferenceEngine(bert, tparams, device="cpu", prefix_caching=True,
                        **BASE)


# ---------------------------------------------------------------------------
# make_extend_fn against JAX's on the same pool and inputs
# ---------------------------------------------------------------------------

def _pools(jcfg, cfg, kv_dtype, nb=12, bs=4):
    kw = dict(num_blocks=nb, block_size=bs, kv_dtype=kv_dtype)
    return (jkv.CacheConfig.for_model(jcfg, **kw),
            tkv.CacheConfig.for_model(cfg, **kw))


def _jax_pool_to_torch(jpool):
    out = {}
    for n, a in jpool.items():
        if a.dtype == jnp.bfloat16:         # numpy holds it as f32, exact
            out[n] = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
                torch.bfloat16)
        else:
            out[n] = torch.from_numpy(np.array(a))
    return out


def _seeded_pool(jcc, seed=0):
    """A pool whose every row holds seeded values (codes and scales for
    int8), so cached rows the extend attends are not zeros."""
    rng = np.random.default_rng(seed)
    pool = {}
    for n, a in jkv.init_pool(jcc).items():
        if a.dtype == jnp.int8:
            vals = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif n.endswith("scale"):
            vals = rng.uniform(0.001, 0.02, a.shape).astype(np.float32)
        else:
            vals = rng.standard_normal(a.shape).astype(np.float32)
        pool[n] = jnp.asarray(vals, a.dtype)
    return pool


def _compare_rows(tpool, jpool, rows, kv_dtype):
    for name in jpool:
        got = tpool[name][:, torch.from_numpy(rows).long()].float().numpy()
        want = np.asarray(jpool[name][:, rows]).astype(np.float32)
        if kv_dtype == "int8" and name in ("k", "v"):
            assert np.abs(got - want).max() <= 1, name
        elif kv_dtype == "bf16":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=8e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0,
                                       err_msg=name)


def _jparams(jcfg, jparams):
    return jax.tree_util.tree_map(
        jnp.asarray, dict(jdec.canonical_params(jcfg, jparams)))


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_extend_suffix_prefill_matches_jax(weights, kv_dtype):
    """The prefix-hit suffix prefill: C = 6 cached positions, S = 5 new
    tokens. JAX pads the suffix to an 8-wide bucket with a length mask;
    the port runs it at its exact length, unmasked, over the window of
    the L = 11 positions."""
    jcfg, jparams, cfg, tparams = weights
    jcc, tcc = _pools(jcfg, cfg, kv_dtype)
    C, S, E = 6, 5, 8
    L = C + S
    table = tkv.BlockTable(tcc, max_blocks=tcc.blocks_for(64))
    alloc = tkv.BlockAllocator(tcc.num_blocks)
    alloc.alloc(2)
    table.ensure_room(L + 1, alloc)
    toks = np.asarray(X[C:L], np.int32)
    jpool = _seeded_pool(jcc)
    tpool = _jax_pool_to_torch(jpool)

    jt = np.zeros((1, E), np.int32)
    jt[0, :S] = toks
    jpos = np.full((1, E), table.max_blocks * tcc.block_size, np.int32)
    jpos[0, :S] = np.arange(C, L)
    jrows = np.zeros((1, E), np.int32)
    jrows[0, :S] = table.rows(np.arange(C, L))
    jlog, jpool = jax.jit(jdec.make_extend_fn(jcfg, jcc))(
        _jparams(jcfg, jparams), jpool, jnp.asarray(jt), jnp.asarray(jpos),
        jnp.asarray([L], np.int32), jnp.asarray(jrows),
        jnp.asarray(table.window_rows()[None]))

    tlog, tpool = tdec.make_extend_fn(cfg, tcc)(
        tdec.canonical_params(cfg, tparams), tpool,
        torch.from_numpy(toks.astype(np.int64))[None],
        torch.arange(C, L)[None], None,
        torch.from_numpy(table.rows(np.arange(C, L)).astype(np.int64))[None],
        torch.from_numpy(table.window_rows(L).astype(np.int64))[None])
    assert tlog.shape == (1, S, cfg.vocab_size)
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog[0, :S]),
                               atol=LOGIT_TOL, rtol=0)
    _compare_rows(tpool, jpool, table.rows(np.arange(C, L)), kv_dtype)
    untouched = table.rows(np.arange(C))             # the cached rows
    _compare_rows(tpool, jpool, untouched, "f32")


def test_extend_verify_matches_jax(weights):
    """The speculative verify: two sequences with ragged spans (3 and 1
    of E = 4), padded positions past their lengths, the masked
    ``mha_reference``."""
    jcfg, jparams, cfg, tparams = weights
    jcc, tcc = _pools(jcfg, cfg, "f32", nb=20)
    alloc = tkv.BlockAllocator(tcc.num_blocks)
    tables, lens, spans = [], [9, 5], [3, 1]
    for n, ke in zip(lens, spans):
        t = tkv.BlockTable(tcc, max_blocks=tcc.blocks_for(64))
        t.ensure_room(n + ke, alloc)
        tables.append(t)
    B, E = 2, 4
    W = max(len(t.blocks) for t in tables) * tcc.block_size
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, E))
    positions = np.full((B, E), W, np.int64)
    lengths = np.zeros(B, np.int64)
    rows = np.zeros((B, E), np.int64)
    for i, (t, n, ke) in enumerate(zip(tables, lens, spans)):
        positions[i, :ke + 1] = np.arange(n - 1, n + ke)
        lengths[i] = n + ke
        rows[i, :ke + 1] = t.rows(np.arange(n - 1, n + ke))
    jwin = np.stack([t.window_rows() for t in tables])
    twin = np.stack([t.window_rows(W) for t in tables])
    jpool = _seeded_pool(jcc, 1)
    tpool = _jax_pool_to_torch(jpool)
    jlog, jpool = jax.jit(jdec.make_extend_fn(jcfg, jcc))(
        _jparams(jcfg, jparams), jpool, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(rows, jnp.int32), jnp.asarray(jwin))
    tlog, tpool = tdec.make_extend_fn(cfg, tcc)(
        tdec.canonical_params(cfg, tparams), tpool,
        torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(lengths), torch.from_numpy(rows),
        torch.from_numpy(twin))
    for i, ke in enumerate(spans):
        np.testing.assert_allclose(tlog[i, :ke + 1].numpy(),
                                   np.asarray(jlog[i, :ke + 1]),
                                   atol=LOGIT_TOL, rtol=0)
        _compare_rows(tpool, jpool, rows[i, :ke + 1].astype(np.int32),
                      "f32")


def test_extend_suffix_takes_flash_unless_reference(weights, monkeypatch):
    """Off ``tiny()``'s ``attention_impl="reference"`` the suffix prefill
    attends through ``flash_attention`` once a layer, at Sq = S, Sk = L,
    and its logits equal the reference path's; the verify (lengths
    given) never takes it."""
    _, _, cfg, tparams = weights
    calls = []
    real = tdec.flash_attention

    def flash(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tdec, "flash_attention", flash)
    tcc = tkv.CacheConfig.for_model(cfg, num_blocks=12, block_size=4)
    table = tkv.BlockTable(tcc, max_blocks=tcc.blocks_for(64))
    alloc = tkv.BlockAllocator(tcc.num_blocks)
    table.ensure_room(12, alloc)
    params = tdec.canonical_params(cfg, tparams)
    pool0 = _jax_pool_to_torch(_seeded_pool(_pools(
        JConfig.tiny(max_seq_len=64), cfg, "f32")[0]))
    C, L = 6, 11
    args = (torch.tensor([X[C:L]]), torch.arange(C, L)[None], None,
            torch.from_numpy(table.rows(np.arange(C, L)).astype(
                np.int64))[None],
            torch.from_numpy(table.window_rows(L).astype(np.int64))[None])
    out = {}
    for impl in ("reference", None):
        c = dataclasses.replace(cfg, attention_impl=impl)
        pool = {n: a.clone() for n, a in pool0.items()}
        out[impl], _ = tdec.make_extend_fn(c, tcc)(params, pool, *args)
    assert calls == [(L - C, L, {"causal": True})] * cfg.n_layers
    torch.testing.assert_close(out[None], out["reference"], rtol=0,
                               atol=LOGIT_TOL)
    calls.clear()
    c = dataclasses.replace(cfg, attention_impl=None)
    pool = {n: a.clone() for n, a in pool0.items()}
    tdec.make_extend_fn(c, tcc)(
        params, pool, args[0], args[1], torch.tensor([L]), *args[3:])
    assert calls == []


def test_engine_hit_path_flash_launch_count(weights, monkeypatch):
    """Through the engine, off ``tiny()``'s reference attention: a cold
    prefill and a hit's suffix prefill each call ``flash_attention``
    once a layer; decode never does; the hit's shape is (S, L)."""
    _, _, cfg, tparams = weights
    cfg = dataclasses.replace(cfg, attention_impl=None)
    calls = []
    real = tdec.flash_attention

    def flash(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tdec, "flash_attention", flash)
    eng = InferenceEngine(cfg, tparams, device="cpu", prefix_caching=True,
                          **BASE)
    first = eng.generate([X], max_new_tokens=3)
    assert calls == [(16, 16)] * cfg.n_layers
    calls.clear()
    assert eng.generate([X], max_new_tokens=3) == first
    assert calls == [(1, 16)] * cfg.n_layers      # C = 15, S = 1

"""Port parity: ``distributed_tensorflow_tpu_torch.serving.decode`` against
the JAX ``serving/decode.py`` on the CPU, at ``tiny()`` in f32.

The JAX prefill runs the prompt right-padded to ``(1, max_seq_len)``
with a length mask; the port runs it at its exact length. Logits and the
pool rows of real positions must agree (JAX writes never-read values
past the prompt). Tolerances: logits and f32 rows 2e-5; bf16 rows one
bf16 rounding step (8e-3 relative); int8 codes within one step, scales
2e-5 — the rows are rounded after f32 math that differs in its last
bits between the packages. ``_quantize_rows`` on identical inputs is
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import decode as jdec
from distributed_tensorflow_tpu.serving import kv_cache as jkv
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import decode as tdec
from distributed_tensorflow_tpu_torch.serving import kv_cache as tkv

MAX_SEQ = 32
PROMPT = [5, 17, 200, 3, 3, 91, 44, 8, 120, 7, 66]


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=MAX_SEQ)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=MAX_SEQ)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jparams = jax.tree_util.tree_map(
        jnp.asarray, dict(jdec.canonical_params(jcfg, jparams)))
    return jcfg, jparams, cfg, tdec.canonical_params(cfg, tparams)


def _compare_rows(tpool, jpool, rows, kv_dtype):
    for name in jpool:
        got = tpool[name][:, torch.from_numpy(rows).long()].float().numpy()
        want = np.asarray(jpool[name][:, rows]).astype(np.float32)
        if kv_dtype == "int8" and name in ("k", "v"):
            assert np.abs(got - want).max() <= 1, name
        elif kv_dtype == "bf16":
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=8e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_prefill_and_decode_match_jax(weights, kv_dtype):
    jcfg, jparams, cfg, tparams = weights
    kw = dict(num_blocks=12, block_size=4, kv_dtype=kv_dtype)
    jcc = jkv.CacheConfig.for_model(jcfg, **kw)
    tcc = tkv.CacheConfig.for_model(cfg, **kw)
    # identical host state on both sides (test_torch_kv_cache pins it):
    # one table drives both pools
    alloc = tkv.BlockAllocator(jcc.num_blocks)
    alloc.alloc(2)                                 # non-trivial block ids
    table = tkv.BlockTable(tcc, max_blocks=tcc.blocks_for(MAX_SEQ))
    n = len(PROMPT)
    table.ensure_room(n + 4, alloc)

    jpool = jkv.init_pool(jcc)
    toks = np.zeros((1, MAX_SEQ), np.int32)
    toks[0, :n] = PROMPT
    jlast, jpool = jax.jit(jdec.make_prefill_fn(jcfg, jcc))(
        jparams, jpool, jnp.asarray(toks), jnp.asarray([n], np.int32),
        jnp.asarray(table.rows(np.arange(MAX_SEQ))[None]))
    tpool = tkv.init_pool(tcc, device="cpu")
    tlast, tpool = tdec.make_prefill_fn(cfg, tcc)(
        tparams, tpool, torch.tensor([PROMPT]),
        torch.from_numpy(table.rows(np.arange(n)).astype(np.int64)))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast[0]),
                               atol=2e-5, rtol=0)
    _compare_rows(tpool, jpool, table.rows(np.arange(n)), kv_dtype)
    table.length = n

    jdecode = jax.jit(jdec.make_decode_fn(jcfg, jcc))
    tdecode = tdec.make_decode_fn(cfg, tcc)
    token = int(np.argmax(np.asarray(jlast[0])))
    win = table.window_rows()[None]
    for _ in range(3):
        pos = table.length
        table.length += 1
        row = table.row_of(pos)
        jlog, jpool = jdecode(
            jparams, jpool, jnp.asarray([token], np.int32),
            jnp.asarray([pos], np.int32), jnp.asarray([pos + 1], np.int32),
            jnp.asarray([row], np.int32), jnp.asarray(win))
        tlog, tpool = tdecode(
            tparams, tpool, torch.tensor([token]), torch.tensor([pos]),
            torch.tensor([pos + 1]), torch.tensor([row]),
            torch.from_numpy(win.astype(np.int64)))
        atol = 2e-5 if kv_dtype == "f32" else 1e-3
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=atol, rtol=0)
        _compare_rows(tpool, jpool, np.asarray([row]), kv_dtype)
        token = int(np.argmax(np.asarray(jlog[0])))


def test_model_forward_matches_jax(weights):
    """The serving-side full forward, with and without a length mask."""
    jcfg, jparams, cfg, tparams = weights
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    lengths = np.asarray([6, 9], np.int32)
    want = np.asarray(jdec.model_forward(jcfg, jparams, jnp.asarray(toks),
                                         jnp.asarray(lengths)))
    got = tdec.model_forward(cfg, tparams, torch.from_numpy(toks).long(),
                             torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got[0, :6], want[0, :6], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)
    full = tdec.model_forward(cfg, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(full[1].numpy(), want[1], atol=2e-5, rtol=0)
    last = tdec.model_forward(cfg, tparams, torch.from_numpy(toks).long(),
                              last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["reference", None],
                         ids=["reference", "flash"])
def test_prefill_attention_follows_attention_impl(weights, monkeypatch,
                                                  impl):
    """The prefill's full forward takes ``mha_reference`` where
    ``cfg.attention_impl`` is ``"reference"`` (``tiny()``'s, as in JAX)
    and ``flash_attention`` otherwise, once a layer; both give the JAX
    prefill's last logits."""
    jcfg, jparams, cfg, tparams = weights
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    calls = []
    real = tdec.flash_attention

    def flash(*a, **kw):
        if impl == "reference":
            raise AssertionError("flash_attention called under 'reference'")
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tdec, "flash_attention", flash)
    n = len(PROMPT)
    tcc = tkv.CacheConfig.for_model(cfg, num_blocks=12, block_size=4)
    tlast, _ = tdec.make_prefill_fn(cfg, tcc)(
        tparams, tkv.init_pool(tcc, device="cpu"), torch.tensor([PROMPT]),
        torch.arange(n))
    assert len(calls) == (0 if impl == "reference" else cfg.n_layers)
    toks = np.zeros((1, MAX_SEQ), np.int32)
    toks[0, :n] = PROMPT
    want = jdec.model_forward(jcfg, jparams, jnp.asarray(toks),
                              jnp.asarray([n], np.int32))[0, n - 1]
    np.testing.assert_allclose(tlast.numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)


def test_quantize_rows_exact():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 4, 16)).astype(np.float32) * 3
    x[2, 1] = 0.0                                 # zero row -> scale 1
    x[3, 0, 5] = 127.5
    jq, js = jdec._quantize_rows(jnp.asarray(x))
    tq, ts = tdec._quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rotary_at_matches_prefill_rotary(weights):
    """A token's rotary K at an explicit position equals its row of the
    whole-sequence rotary, as in the JAX package."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        rotary_embedding)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, 10, 16)).astype(np.float32))
    whole = rotary_embedding(x, seq_axis=-2)
    for p in (0, 3, 9):
        one = tdec.rotary_at(x[:, :, p:p + 1], torch.tensor([[p]]))
        torch.testing.assert_close(one[:, :, 0], whole[:, :, p], rtol=0,
                                   atol=1e-6)
    want = np.asarray(jdec.rotary_at(jnp.asarray(x.numpy()),
                                     jnp.arange(10)[None]))
    np.testing.assert_allclose(
        tdec.rotary_at(x, torch.arange(10)[None]).numpy(), want,
        atol=1e-5, rtol=0)


def test_copy_fn_copies_every_pool_array():
    cc = tkv.CacheConfig(n_layers=2, n_heads=2, head_dim=4, num_blocks=4,
                         block_size=2, kv_dtype="int8")
    pool = tkv.init_pool(cc, device="cpu")
    for a in pool.values():
        a.copy_(torch.arange(a.numel()).reshape(a.shape).to(a.dtype))
    src, dst = torch.tensor([2, 3]), torch.tensor([6, 7])
    want = {n: a[:, src].clone() for n, a in pool.items()}
    tdec.make_copy_fn()(pool, src, dst)
    for n, a in pool.items():
        assert torch.equal(a[:, dst], want[n])

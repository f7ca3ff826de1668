"""Port parity: ``distributed_tensorflow_tpu_torch.serving.kv_cache``
host logic against the JAX ``serving/kv_cache.py`` — exact, on the same
call sequences."""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig)
from distributed_tensorflow_tpu.serving import kv_cache as jkv
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig)
from distributed_tensorflow_tpu_torch.serving import kv_cache as tkv


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8", None])
@pytest.mark.parametrize("block_size", [1, 8, 16])
def test_cache_config_arithmetic(kv_dtype, block_size):
    j = jkv.CacheConfig.for_model(JConfig.transformer_big(), num_blocks=513,
                                  block_size=block_size, kv_dtype=kv_dtype)
    t = tkv.CacheConfig.for_model(TransformerConfig.transformer_big(),
                                  num_blocks=513, block_size=block_size,
                                  kv_dtype=kv_dtype)
    for attr in ("quantized", "usable_blocks", "max_tokens",
                 "bytes_per_token"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for n in (0, 1, 15, 16, 17, 1000, 1024):
        assert t.blocks_for(n) == j.blocks_for(n)
    for budget in (0, 10_000, 400 * 2 ** 20):
        assert t.blocks_for_budget(budget) == j.blocks_for_budget(budget)


def test_cache_config_validation():
    for kw in (dict(num_blocks=1), dict(block_size=0),
               dict(kv_dtype="fp8")):
        args = dict(n_layers=2, n_heads=4, head_dim=16, num_blocks=8)
        args.update(kw)
        with pytest.raises(ValueError):
            jkv.CacheConfig(**args)
        with pytest.raises(ValueError):
            tkv.CacheConfig(**args)


def _state(a):
    return (a.num_free, a.num_allocated, a.total_refs,
            tuple(a.refcount(b) for b in range(a.num_blocks)))


def test_block_allocator_refcounts_match():
    ops = [("alloc", 3), ("alloc", 2), ("incref", 2), ("free", [2]),
           ("free", [1, 3]), ("alloc", 2), ("free", [2]), ("alloc", 4),
           ("free", [0]), ("free", [3]), ("free", [3]), ("alloc", 9),
           ("alloc", -1), ("incref", 7), ("incref", 4), ("free", [4, 4]),
           ("free", [5])]
    ja, ta = jkv.BlockAllocator(9), tkv.BlockAllocator(9)
    for op, arg in ops:
        outs = []
        for a, errs in ((ja, (jkv.OutOfBlocksError, ValueError)),
                        (ta, (tkv.OutOfBlocksError, ValueError))):
            try:
                outs.append(("ok", getattr(a, op)(arg)))
            except errs as e:
                outs.append(("raise", type(e).__name__))
        assert outs[0] == outs[1], (op, arg, outs)
        assert _state(ja) == _state(ta), (op, arg)


def test_free_past_refcount_raises_before_any_change():
    """Freeing one block twice in one call when it has one reference
    raises and changes nothing (the JAX allocator drops the reference,
    then raises KeyError with the block on neither list)."""
    a = tkv.BlockAllocator(6)
    blocks = a.alloc(2)
    before = _state(a)
    with pytest.raises(ValueError):
        a.free([blocks[0], blocks[0]])
    assert _state(a) == before
    a.free(blocks)
    assert a.num_free == 5 and a.total_refs == 0


def test_block_table_rows_match():
    jc = jkv.CacheConfig(n_layers=2, n_heads=4, head_dim=16, num_blocks=12,
                         block_size=4)
    tc = tkv.CacheConfig(n_layers=2, n_heads=4, head_dim=16, num_blocks=12,
                         block_size=4)
    ja, ta = jkv.BlockAllocator(12), tkv.BlockAllocator(12)
    ja.alloc(2)
    ta.alloc(2)                      # non-trivial physical block ids
    jt, tt = jkv.BlockTable(jc, max_blocks=5), tkv.BlockTable(tc, 5)
    for grow in (3, 1, 6, 9):
        jt.ensure_room(grow, ja)
        tt.ensure_room(grow, ta)
        jt.length += grow
        tt.length += grow
        assert tt.blocks == jt.blocks
        positions = np.arange(0, 24)
        np.testing.assert_array_equal(tt.rows(positions),
                                      jt.rows(positions))
        np.testing.assert_array_equal(tt.window_rows(), jt.window_rows())
        for p in range(tt.length):
            assert tt.row_of(p) == jt.row_of(p)
        assert tt.capacity == jt.capacity
    np.testing.assert_array_equal(tt.window_rows(8), jt.window_rows()[:8])
    with pytest.raises(tkv.OutOfBlocksError):
        tt.ensure_room(5, ta)        # past max_blocks
    with pytest.raises(jkv.OutOfBlocksError):
        jt.ensure_room(5, ja)
    jt.release(ja)
    tt.release(ta)
    assert _state(ja) == _state(ta)
    assert tt.blocks == [] and tt.length == 0


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_init_pool_shapes(kv_dtype):
    tc = tkv.CacheConfig(n_layers=2, n_heads=4, head_dim=16, num_blocks=6,
                         block_size=4, kv_dtype=kv_dtype)
    jc = jkv.CacheConfig(n_layers=2, n_heads=4, head_dim=16, num_blocks=6,
                         block_size=4, kv_dtype=kv_dtype)
    tp, jp = tkv.init_pool(tc, device="cpu"), jkv.init_pool(jc)
    assert sorted(tp) == sorted(jp)
    for name in tp:
        assert tuple(tp[name].shape) == jp[name].shape
        assert str(tp[name].dtype).replace("torch.", "") == \
            jp[name].dtype.name
        assert not tp[name].any()
    assert tp["k"].dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                             "int8": torch.int8}[kv_dtype]

"""Port parity: the prefix cache's host logic —
``distributed_tensorflow_tpu_torch.serving.kv_cache`` ``PrefixCache``,
``HostTier`` and ``BlockTable.ensure_writable`` — against the JAX
``serving/kv_cache.py``, exact, on the same scripted call sequences.

Each script drives one module's ``BlockAllocator`` + ``PrefixCache`` (+
``HostTier``) and records every return value, the allocator's refcounts
and the cache's and tier's ``stats()`` after every call; the JAX and
the port's records must be equal. The scripts cover the cases of the
JAX ``TestPrefixCacheUnit``, the spill tier, the fence, and seeded
random operation sequences.
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig)
from distributed_tensorflow_tpu.serving import kv_cache as jkv
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig)
from distributed_tensorflow_tpu_torch.serving import kv_cache as tkv


class Recorder:
    """One module's allocator, cache and (optionally) spill tier, with a
    trace of everything observable after each call."""

    def __init__(self, m, num_blocks=16, bs=4, tier_blocks=None,
                 epoch="E0"):
        self.m = m
        self.alloc = m.BlockAllocator(num_blocks)
        self.cache = m.PrefixCache(self.alloc, bs)
        self.tier = None
        self.inserted = []
        self.trace = []
        if tier_blocks is not None:
            self.tier = m.HostTier(tier_blocks)
            self.cache.attach_spill(
                self.tier,
                extract=lambda b: {"k": np.full((2, 3), b, np.float32)},
                insert=lambda b, arrays: self.inserted.append(
                    (b, float(arrays["k"][0, 0]))),
                epoch=epoch)

    def state(self):
        a = self.alloc
        return (a.num_free, a.num_allocated, a.total_refs,
                tuple(a.refcount(b) for b in range(a.num_blocks)),
                len(self.cache), self.cache.stats(),
                self.tier.stats() if self.tier is not None else None,
                tuple(self.inserted))

    def do(self, name, *args):
        obj = self.alloc if name in ("alloc", "free", "incref") \
            else self.cache
        try:
            out = ("ok", getattr(obj, name)(*args))
        except (ValueError, self.m.OutOfBlocksError) as e:
            out = ("raise", type(e).__name__)
        self.trace.append((name, out, self.state()))
        return out[1] if out[0] == "ok" else None


def script_match_walks_registered_chain(r):
    toks = list(range(10))                       # 2 full blocks + 2
    blocks = r.do("alloc", 3)
    r.do("register", toks, blocks)               # indexes blocks 0..1
    n, got = r.do("match", toks + [99])          # limit 10: 8 tokens
    r.do("free", got)                            # hand the match back
    n, got = r.do("match", list(range(4)) + [77] * 6)   # diverges
    r.do("free", got)


def script_partial_tail_match(r):
    blocks = r.do("alloc", 2)
    r.do("register", list(range(8)), blocks)
    n, got = r.do("match", list(range(7)))       # 1 full + 2 of block 2
    r.do("free", got)


def script_match_never_covers_last_token(r):
    blocks = r.do("alloc", 2)
    r.do("register", list(range(8)), blocks)
    n, got = r.do("match", list(range(8)))       # identical prompt: 7
    r.do("free", got)
    r.do("match", [3])                           # one token: nothing


def script_eviction_lru_never_refcounted(r):
    b1 = r.do("alloc", 1)
    b2 = r.do("alloc", 1)
    r.do("register", list(range(4)), b1)
    r.do("register", list(range(10, 14)), b2)
    r.do("free", b1)                             # cache is sole owner
    r.do("free", b2)
    n, shared = r.do("match", list(range(5)))    # a sequence shares b1
    r.do("evict", 5)                             # only b2 evictable
    r.do("match", list(range(10, 15)))           # b2's entry gone
    r.do("free", shared)
    r.do("evict", 5)                             # now b1 goes


def script_interior_not_evicted_before_leaf(r):
    blocks = r.do("alloc", 2)
    r.do("register", list(range(8)), blocks)
    r.do("free", blocks)
    r.do("evict", 1)                             # the leaf
    n, got = r.do("match", list(range(4)) + [9])  # parent still matches
    r.do("free", got)


def script_partial_hop_takes_most_recent(r):
    a = r.do("alloc", 2)
    b = r.do("alloc", 2)
    r.do("register", [1, 2, 3, 4, 5, 6, 7, 8], a)
    r.do("register", [1, 2, 3, 4, 5, 6, 9, 9], b)  # sibling leaves
    n, got = r.do("match", [1, 2, 3, 4, 5, 6, 0])  # both extend [5, 6]
    r.do("free", got)
    r.do("register", [1, 2, 3, 4, 5, 6, 7, 8], a)  # refresh a: no new ref
    n, got = r.do("match", [1, 2, 3, 4, 5, 6, 0])
    r.do("free", got)


def script_register_and_evict_to_empty(r):
    blocks = r.do("alloc", 3)
    r.do("register", list(range(13)), blocks)    # 3 full blocks
    r.do("free", blocks)
    r.do("evict", 10)                            # all three, leaf first
    r.do("free", [1])                            # unowned now: raises
    r.do("alloc", 16)                            # more than the pool


def script_fence(r):
    blocks = r.do("alloc", 2)
    r.do("register", list(range(8)), blocks)
    r.do("free", blocks[:1])                     # seq keeps block 2 only
    r.do("fence", "E1")                          # drops both entries
    r.do("match", list(range(9)))                # stale prefix misses
    r.do("free", blocks[1:])


def script_spill_readopt(r):
    blocks = r.do("alloc", 3)
    r.do("register", list(range(12)), blocks)
    r.do("free", blocks)
    r.do("evict", 3)                             # spill all (tier 4)
    n, got = r.do("match", list(range(13)))      # re-adopt every block
    r.do("free", got)
    r.do("evict", 3)
    r.do("alloc", 14)                            # leave one free block
    n, got = r.do("match", list(range(13)))      # re-adopts one, stops
    r.do("free", got)


def script_spill_capacity_drops_oldest(r):
    for i in range(3):
        b = r.do("alloc", 1)
        r.do("register", [10 * i + j for j in range(4)], b)
        r.do("free", b)
    r.do("evict", 3)                             # tier of 2: one dropped
    for i in range(3):
        n, got = r.do("match", [10 * i + j for j in range(5)])
        r.do("free", got)


def script_stale_epoch_rejected(r):
    r.tier.put((None, (1, 2, 3, 4)), None, (1, 2, 3, 4),
               {"k": np.zeros((2, 3), np.float32)}, epoch="gen0")
    r.trace.append(("put", ("ok", None), r.state()))
    r.do("match", (1, 2, 3, 4, 9))               # dropped, not served


def script_fence_rejects_spilled_lazily(r):
    b = r.do("alloc", 1)
    r.do("register", list(range(4)), b)
    r.do("free", b)
    r.do("evict", 1)
    r.do("fence", "E2")
    r.do("match", list(range(5)))                # spill rejected


SCRIPTS = {
    "match_walks_registered_chain": (script_match_walks_registered_chain,
                                     {}),
    "partial_tail_match": (script_partial_tail_match, {}),
    "match_never_covers_last_token": (
        script_match_never_covers_last_token, {}),
    "eviction_lru_never_refcounted": (
        script_eviction_lru_never_refcounted, dict(num_blocks=8)),
    "interior_not_evicted_before_leaf": (
        script_interior_not_evicted_before_leaf, {}),
    "partial_hop_takes_most_recent": (
        script_partial_hop_takes_most_recent, {}),
    "register_and_evict_to_empty": (script_register_and_evict_to_empty,
                                    {}),
    "fence": (script_fence, {}),
    "spill_readopt": (script_spill_readopt, dict(tier_blocks=4)),
    "spill_capacity_drops_oldest": (script_spill_capacity_drops_oldest,
                                    dict(tier_blocks=2)),
    "stale_epoch_rejected": (script_stale_epoch_rejected,
                             dict(tier_blocks=4, epoch="gen1")),
    "fence_rejects_spilled_lazily": (script_fence_rejects_spilled_lazily,
                                     dict(tier_blocks=4)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_prefix_cache_script_matches_jax(name):
    script, kw = SCRIPTS[name]
    traces = []
    for m in (jkv, tkv):
        r = Recorder(m, **kw)
        script(r)
        traces.append(r.trace)
    assert traces[0] == traces[1]
    # the scripts really exercise what they are named for
    assert any(out[0] == "ok" for _, out, _ in traces[1])


def script_random(r, seed):
    """Seeded random alloc/match/register/evict/free/fence sequence over
    a 3-token alphabet (so prefixes collide), holding references the
    way sequences do."""
    rng = np.random.default_rng(seed)
    held = []                                    # lists of owned blocks
    for _ in range(60):
        op = rng.choice(["match", "register", "evict", "free", "fence"],
                        p=[0.35, 0.3, 0.15, 0.15, 0.05])
        if op == "match":
            toks = rng.integers(0, 3, rng.integers(1, 14)).tolist()
            got = r.do("match", toks)
            if got and got[1]:
                held.append(got[1])
        elif op == "register":
            toks = rng.integers(0, 3, rng.integers(4, 14)).tolist()
            n = len(toks) // 4
            blocks = r.do("alloc", n)
            if blocks is not None:
                r.do("register", toks, blocks)
                held.append(blocks)
        elif op == "evict":
            r.do("evict", int(rng.integers(1, 4)))
        elif op == "free" and held:
            r.do("free", held.pop(int(rng.integers(0, len(held)))))
        elif op == "fence":
            r.do("fence", f"E{int(rng.integers(0, 2))}")
    for blocks in held:
        r.do("free", blocks)
    r.do("evict", 100)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tier_blocks", [None, 3])
def test_random_operation_sequences_match_jax(seed, tier_blocks):
    traces = []
    for m in (jkv, tkv):
        r = Recorder(m, num_blocks=12, tier_blocks=tier_blocks)
        script_random(r, seed)
        traces.append(r.trace)
        # every reference was handed back: only the tier holds anything
        assert r.alloc.num_free == r.alloc.num_blocks - 1
        assert len(r.cache) == 0
    assert traces[0] == traces[1]


def _tables(bs=4):
    jt = jkv.BlockTable(jkv.CacheConfig.for_model(
        JConfig.tiny(), num_blocks=12, block_size=bs), max_blocks=6)
    tt = tkv.BlockTable(tkv.CacheConfig.for_model(
        TransformerConfig.tiny(), num_blocks=12, block_size=bs),
        max_blocks=6)
    return jt, tt


@pytest.mark.parametrize("start,end", [(6, 7), (6, 12), (0, 12), (9, 9),
                                       (11, 30)])
def test_ensure_writable_copies_shared_blocks(start, end):
    """A table of three blocks whose middle and last blocks are shared
    (a prefix-cache entry or a sibling also owns them): each writes the
    same copy instructions, swaps in the same fresh blocks and leaves
    the same refcounts."""
    out = []
    for m, t in zip((jkv, tkv), _tables()):
        a = m.BlockAllocator(12)
        t.blocks = a.alloc(3)
        t.length = 11
        a.incref(t.blocks[1])
        a.incref(t.blocks[2])
        copies = t.ensure_writable(start, end, a)
        out.append((copies, list(t.blocks),
                    [a.refcount(b) for b in range(12)], a.num_free))
    assert out[0] == out[1]


def test_ensure_writable_shared_tail_block():
    """The copy-on-write case of a prefix hit: the matched tail block is
    shared with the cache; the first write into it copies the whole
    block to a private one and drops only this table's reference."""
    a = tkv.BlockAllocator(8)
    pc = tkv.PrefixCache(a, 4)
    owner = a.alloc(2)
    pc.register(list(range(8)), owner)
    a.free(owner)                                # cache sole owner
    n, got = pc.match(list(range(7)))            # partial last hop
    assert n == 6
    _, t = _tables()
    t.blocks, t.length = list(got), 6
    copies = t.ensure_writable(6, 7, a)
    assert copies == [(got[1] * 4, t.blocks[1] * 4, 4)]
    assert t.blocks[0] == got[0] and t.blocks[1] != got[1]
    assert a.refcount(got[1]) == 1               # the cache's own
    assert a.refcount(t.blocks[1]) == 1
    assert t.ensure_writable(6, 7, a) == []      # private now

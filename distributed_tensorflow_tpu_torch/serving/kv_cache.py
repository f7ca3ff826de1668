"""Block-allocated KV cache for incremental decode — port of
``distributed_tensorflow_tpu/serving/kv_cache.py``.

The cache is a pool of fixed-size blocks (PagedAttention, Kwon et al.
SOSP'23): a sequence of length ``L`` holds ``ceil(L / block_size)``
blocks and a finished sequence's blocks return to the pool at once.

- **Host side** — :class:`BlockAllocator` (refcounted free list;
  physical block 0 is the *trash block*: padded positions write there
  and reads from it are always masked), :class:`BlockTable` (a
  sequence's logical-position → physical-row map, with copy-on-write
  of shared blocks), :class:`PrefixCache` (committed prompt prefixes
  indexed by content, so a later request with the same prefix adopts
  the blocks instead of recomputing them) and :class:`HostTier` (host
  memory behind the prefix cache: evicted blocks spill there and are
  re-adopted on a later hit). Plain Python and numpy, the same
  call-for-call behaviour as the JAX package.
- **Device side** — the pool, ``(n_layers, num_blocks * block_size,
  n_heads, head_dim)`` per K and V (:func:`init_pool`); position ``p``
  of a sequence lives at row ``table[p // block_size] * block_size +
  p % block_size``. ``kv_dtype`` picks the storage: ``"f32"``,
  ``"bf16"`` or ``"int8"`` (quantize on write with one f32 scale per
  (row, head), dequantize on gather).

**Sharing.** Every owner of a block holds one reference: the sequence
that allocated it, each later sequence that matched it in the prefix
cache, and the cache itself. A shared block is never written in place:
:meth:`BlockTable.ensure_writable` swaps it for a private copy first,
so a request diverging after a shared prefix cannot corrupt its
siblings' cache.

Mesh placement belongs to a later slice.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

#: Physical block every allocator reserves: padded/inactive positions
#: scatter here and masked attention never reads it.
TRASH_BLOCK = 0

#: CacheConfig(kv_dtype=) names -> storage dtype.
KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``"float32"``, ``"bfloat16"``,
    ``"int8"``): the name the JAX package writes in ``stats()``, pool
    fingerprints and migration payloads."""
    return str(dtype).replace("torch.", "")


class OutOfBlocksError(RuntimeError):
    """The pool cannot satisfy an allocation (admission must wait or a
    running sequence must be preempted)."""


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Shape of the device-side KV pool. ``kv_dtype`` overrides
    ``dtype`` by name; ``"int8"`` adds per-(row, head) f32 scales."""

    n_layers: int
    n_heads: int
    head_dim: int
    num_blocks: int
    block_size: int = 16
    dtype: object = torch.float32
    kv_dtype: str | None = None

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.kv_dtype is not None:
            if self.kv_dtype not in KV_DTYPES:
                raise ValueError(
                    f"kv_dtype={self.kv_dtype!r}; expected one of "
                    f"{sorted(KV_DTYPES)}")
            object.__setattr__(self, "dtype", KV_DTYPES[self.kv_dtype])

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the trash block

    @property
    def max_tokens(self) -> int:
        """Cache capacity in tokens (across all sequences)."""
        return self.usable_blocks * self.block_size

    @property
    def bytes_per_token(self) -> int:
        """Pool bytes one cached token costs (K + V, scales included for
        quantized dtypes)."""
        per = 2 * self.n_heads * self.head_dim * self.dtype.itemsize
        if self.quantized:
            per += 2 * self.n_heads * 4          # f32 scale per head
        return per

    def blocks_for_budget(self, pool_bytes: int) -> int:
        """Blocks a device-memory budget affords at this dtype."""
        per_block = self.block_size * self.bytes_per_token
        return max(0, pool_bytes // per_block)

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_size))

    @classmethod
    def for_model(cls, model_cfg, *, num_blocks: int,
                  block_size: int = 16,
                  kv_dtype: str | None = None) -> "CacheConfig":
        """Pool sized for a TransformerConfig-shaped model config, stored
        in the model's compute dtype unless ``kv_dtype`` names another."""
        return cls(n_layers=model_cfg.n_layers, n_heads=model_cfg.n_heads,
                   head_dim=model_cfg.head_dim, num_blocks=num_blocks,
                   block_size=block_size, dtype=model_cfg.dtype,
                   kv_dtype=kv_dtype)


class BlockAllocator:
    """Refcounted free-list over the physical blocks of one pool.
    Lowest-id-first allocation (deterministic reuse); :meth:`free`
    decrefs and only the last owner's free returns a block."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._refs)

    @property
    def total_refs(self) -> int:
        """Sum of live references across all allocated blocks (the
        conservation quantity :meth:`InferenceEngine.block_accounting`
        audits)."""
        return sum(self._refs.values())

    def refcount(self, block: int) -> int:
        """Live references on ``block`` (0 = free)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> list[int]:
        """``n`` blocks at refcount 1, lowest ids first; raises
        :class:`OutOfBlocksError` (allocating nothing) when fewer than
        ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)} free "
                f"(of {self.num_blocks - 1} usable)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int) -> None:
        """Add an owner to an allocated block."""
        if block not in self._refs:
            raise ValueError(f"incref of unallocated block {block}")
        self._refs[block] += 1

    def free(self, blocks) -> None:
        """Drop one reference per block; freeing an unowned block, more
        references than a block has, or the trash block raises before
        anything changes."""
        blocks = list(blocks)
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("cannot free the reserved trash block")
            if blocks.count(b) > self._refs.get(b, 0):
                raise ValueError(f"double free of block {b}")
        released = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                released.append(b)
        if released:
            self._free.extend(released)
            self._free.sort(reverse=True)


class BlockTable:
    """One sequence's logical-position → physical-row mapping;
    ``max_blocks`` is the widest the table may grow."""

    def __init__(self, cache_cfg: CacheConfig, max_blocks: int):
        self.cfg = cache_cfg
        self.max_blocks = max_blocks
        self.blocks: list[int] = []
        self.length = 0                     # tokens written

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.cfg.block_size

    def ensure_room(self, n_tokens: int, allocator: BlockAllocator):
        """Grow the table so ``length + n_tokens`` fits; raises
        :class:`OutOfBlocksError` (allocating nothing) when the pool or
        the table width cannot hold it."""
        need = self.cfg.blocks_for(self.length + n_tokens)
        grow = need - len(self.blocks)
        if grow <= 0:
            return
        if need > self.max_blocks:
            raise OutOfBlocksError(
                f"sequence needs {need} blocks > max_blocks_per_seq="
                f"{self.max_blocks}")
        self.blocks.extend(allocator.alloc(grow))

    def ensure_writable(self, start: int, end: int,
                        allocator: BlockAllocator) -> list[tuple]:
        """Copy-on-write: every block covering logical positions
        ``[start, end)`` that is SHARED (refcount > 1 — a prefix-cache
        entry or a sibling sequence also owns it) is swapped for a
        private fresh block. Returns ``(src_row0, dst_row0, n_rows)``
        device copy instructions the engine must apply to the pool
        BEFORE writing — the copy preserves the shared prefix content
        that precedes the divergent write inside the block."""
        if end <= start or not self.blocks:
            return []
        bs = self.cfg.block_size
        lo = start // bs
        hi = min(len(self.blocks) - 1, (end - 1) // bs)
        copies = []
        for bi in range(lo, hi + 1):
            b = self.blocks[bi]
            if allocator.refcount(b) > 1:
                new = allocator.alloc(1)[0]
                copies.append((b * bs, new * bs, bs))
                self.blocks[bi] = new
                allocator.free([b])          # drop OUR ref; others keep it
        return copies

    def row_of(self, position: int) -> int:
        """Flat pool row of logical ``position``."""
        bs = self.cfg.block_size
        return self.blocks[position // bs] * bs + position % bs

    def rows(self, positions) -> np.ndarray:
        """Flat pool rows for an array of logical positions; positions
        at/past the written blocks map into the trash block."""
        bs = self.cfg.block_size
        table = np.full(self.max_blocks, TRASH_BLOCK, np.int32)
        table[:len(self.blocks)] = self.blocks
        positions = np.asarray(positions, np.int64)
        return (table[np.minimum(positions // bs, self.max_blocks - 1)]
                * bs + positions % bs).astype(np.int32)

    def window_rows(self, width: int | None = None) -> np.ndarray:
        """Rows of the attention window — logical positions
        ``0..width-1`` in order, trash rows past the allocated blocks.
        ``width`` defaults to the full ``max_blocks * block_size``."""
        if width is None:
            width = self.max_blocks * self.cfg.block_size
        return self.rows(np.arange(width))

    def release(self, allocator: BlockAllocator):
        if self.blocks:
            allocator.free(self.blocks)
        self.blocks = []
        self.length = 0


class _CacheEntry:
    __slots__ = ("key", "parent", "block", "tokens", "last_used")

    def __init__(self, key, parent, block, tokens, last_used):
        self.key = key
        self.parent = parent
        self.block = block
        self.tokens = tokens
        self.last_used = last_used


class _SpillEntry:
    __slots__ = ("key", "parent", "tokens", "arrays", "epoch")

    def __init__(self, key, parent, tokens, arrays, epoch):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.arrays = arrays          # host copies of the block's rows
        self.epoch = epoch            # pool epoch of the spilling engine

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


class HostTier:
    """Host-memory spill tier for cold :class:`PrefixCache` blocks.

    When the prefix cache must evict a block (pool pressure), the
    block's K/V rows — quantisation scales included — are copied to
    host RAM instead of being dropped; a later prompt that walks the
    same chain re-adopts the block into a fresh pool slot bit-exactly.
    The tier holds NO allocator references — its entries are plain host
    bytes keyed by the same chain key the cache indexes by.

    **Epoch fencing.** Every entry records the spilling engine's
    ``pool_epoch``. A restarted engine has a NEW epoch, so a stale
    spill (possibly from different weights or a different pool layout)
    is rejected at re-adoption rather than served — the cache then just
    prefill-recomputes, which is always correct.

    Capacity is bounded (``capacity_blocks``); insertion past it drops
    the least-recently-touched spilled block."""

    def __init__(self, capacity_blocks: int = 256):
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.capacity_blocks = capacity_blocks
        self._entries: "collections.OrderedDict[tuple, _SpillEntry]" = \
            collections.OrderedDict()
        self.spilled = 0
        self.readopted = 0
        self.rejected = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def put(self, key, parent, tokens, arrays, epoch):
        if key in self._entries:
            self._entries.pop(key)
        while len(self._entries) >= self.capacity_blocks:
            self._entries.popitem(last=False)
            self.dropped += 1
        self._entries[key] = _SpillEntry(key, parent, tokens, arrays,
                                         epoch)
        self.spilled += 1

    def get(self, key) -> "_SpillEntry | None":
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def drop(self, key):
        self._entries.pop(key, None)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "nbytes": self.nbytes,
                "spilled": self.spilled, "readopted": self.readopted,
                "rejected": self.rejected, "dropped": self.dropped}


class PrefixCache:
    """Content index over committed prompt-prefix blocks (cross-request
    KV reuse — the vLLM "automatic prefix caching" idea on this pool).

    **Granularity.** The index key of a block is the CHAIN
    ``(parent_key, block_tokens)``: a hit certifies the entire prefix
    up to and including that block, not just the block's own
    ``block_size`` tokens, so matching is a plain walk down the chain.
    The last hop may be a *partial* match — a cached block whose tokens
    merely START with the remaining prompt — which is what makes
    copy-on-write real: the matching sequence will later write its own
    tokens into that block's tail, and ``BlockTable.ensure_writable``
    copies the block first.

    **References.** The cache holds ONE allocator reference per entry;
    :meth:`match` bumps each returned block once more (the caller —
    the admitting sequence — owns those refs and drops them via the
    normal ``BlockTable.release``). Eviction (:meth:`evict`) is LRU
    over entries with NO references beyond the cache's own
    (refcount == 1) and only over chain LEAVES, so an entry a running
    sequence shares — or one a cached longer chain still hangs off —
    is never reclaimed out from under its users.

    At most ``len(prompt) - 1`` tokens ever match: prefill must compute
    at least the final prompt position to produce the first generated
    token's logits."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self.block_size = block_size
        self._entries: dict[tuple, _CacheEntry] = {}
        self._children: dict[object, set] = {}
        self._clock = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.hit_requests = 0
        self.lookups = 0
        self.evictions = 0
        self._spill: HostTier | None = None
        self._spill_extract = None
        self._spill_insert = None
        self._spill_epoch = None
        self.spill_hits = 0
        self.spill_rejects = 0
        self.fences = 0
        self.fence_dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    def attach_spill(self, tier: HostTier, *, extract, insert, epoch):
        """Wire a :class:`HostTier` behind this cache. ``extract(block)
        -> {name: np.ndarray}`` copies one block's pool rows (plus
        scales) to host; ``insert(block, arrays)`` writes them back
        into a freshly allocated block; ``epoch`` is the engine's
        ``pool_epoch`` fence (stale entries from a previous engine
        incarnation are rejected on re-adoption). The engine provides
        all three — the cache stays device-agnostic."""
        self._spill = tier
        self._spill_extract = extract
        self._spill_insert = insert
        self._spill_epoch = epoch

    def match(self, tokens) -> tuple[int, list[int]]:
        """``(n_cached_tokens, blocks)`` — the longest cached chain
        over ``tokens[:-1]``. Full blocks match by chain key; one final
        partial hop may match a cached block whose tokens extend the
        prompt's sub-block tail. Every returned block's refcount is
        bumped; the caller owns (and must eventually free) those refs.
        """
        tokens = tuple(int(t) for t in tokens)
        limit = len(tokens) - 1
        self._clock += 1
        self.lookups += 1
        self.lookup_tokens += max(0, limit)
        bs = self.block_size
        key = None
        blocks: list[int] = []
        n = 0
        while n + bs <= limit:
            k = (key, tokens[n:n + bs])
            e = self._entries.get(k)
            if e is None:
                # Chain miss on device — maybe the block was spilled to
                # the host tier. Re-adoption is full-block only: the
                # partial-hop heuristic below stays device-resident.
                e = self._readopt(k, key)
            if e is None:
                break
            e.last_used = self._clock
            self._alloc.incref(e.block)
            blocks.append(e.block)
            key = k
            n += bs
        if 0 < limit - n < bs:
            rest = tokens[n:limit]
            best = None
            for ck in self._children.get(key, ()):
                e = self._entries[ck]
                if e.tokens[:len(rest)] == rest and (
                        best is None or e.last_used > best.last_used):
                    best = e
            if best is not None:
                best.last_used = self._clock
                self._alloc.incref(best.block)
                blocks.append(best.block)
                n += len(rest)
        if n:
            self.hit_tokens += n
            self.hit_requests += 1
        return n, blocks

    def register(self, tokens, blocks) -> int:
        """Index every FULL block of a just-prefilled prompt
        (``blocks`` = the sequence's BlockTable blocks, which hold
        exactly these tokens' K/V — shared hits included, and
        post-copy-on-write for a partially-matched tail). Newly
        inserted entries gain one cache-owned reference. Returns the
        number of new entries."""
        tokens = tuple(int(t) for t in tokens)
        self._clock += 1
        bs = self.block_size
        key = None
        added = 0
        for i in range(len(tokens) // bs):
            btoks = tokens[i * bs:(i + 1) * bs]
            k = (key, btoks)
            e = self._entries.get(k)
            if e is None:
                self._alloc.incref(blocks[i])
                e = _CacheEntry(k, key, blocks[i], btoks, self._clock)
                self._entries[k] = e
                self._children.setdefault(key, set()).add(k)
                added += 1
            else:
                e.last_used = self._clock
            key = k
        return added

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping
        least-recently-used UNREFERENCED leaf entries (allocator
        refcount 1 — only the cache's own reference — and no cached
        children). Entries referenced by running sequences are never
        evicted. Returns how many blocks actually went back to the
        pool."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for e in self._entries.values():
                if self._children.get(e.key):
                    continue                 # interior of a cached chain
                if self._alloc.refcount(e.block) != 1:
                    continue                 # a sequence still shares it
                if victim is None or e.last_used < victim.last_used:
                    victim = e
            if victim is None:
                break
            if self._spill is not None:
                # Victim selection above already guarantees refcount 1
                # (the cache's own ref): a block any sequence shares is
                # never spilled, only truly cold cache-private blocks.
                self._spill.put(victim.key, victim.parent, victim.tokens,
                                self._spill_extract(victim.block),
                                self._spill_epoch)
            del self._entries[victim.key]
            kids = self._children.get(victim.parent)
            if kids is not None:
                kids.discard(victim.key)
                if not kids:
                    del self._children[victim.parent]
            self._alloc.free([victim.block])
            self.evictions += 1
            freed += 1
        return freed

    def fence(self, epoch) -> int:
        """Invalidate the whole cache in one step and rotate the spill
        epoch — the weights-version fence a hot-swap relies on: a block
        committed under weights N must never match a request served
        under weights N+1 (same tokens, different K/V). Device entries
        are dropped eagerly (the cache's own allocator reference per
        entry returns to the pool; blocks a running sequence still
        shares survive through the sequence's refs). Host-tier spilled
        entries are NOT scanned: the epoch rotation makes
        :meth:`_readopt` drop-and-count each one lazily on its next
        lookup, exactly like a stale entry from a dead engine
        incarnation. Returns the number of device entries dropped."""
        dropped = len(self._entries)
        for e in self._entries.values():
            self._alloc.free([e.block])
        self._entries.clear()
        self._children.clear()
        self._spill_epoch = epoch
        self.fences += 1
        self.fence_dropped += dropped
        return dropped

    def _readopt(self, key, chain_key) -> "_CacheEntry | None":
        """Try to pull a spilled block back into the pool on a chain
        miss. Needs one free block; a stale entry (pool-epoch mismatch
        — the engine restarted since the spill) is dropped and counted
        in ``spill_rejects`` instead of being served."""
        if self._spill is None:
            return None
        se = self._spill.get(key)
        if se is None:
            return None
        if se.epoch != self._spill_epoch:
            self._spill.drop(key)
            self._spill.rejected += 1
            self.spill_rejects += 1
            return None
        if self._alloc.num_free < 1:
            return None
        block = self._alloc.alloc(1)[0]       # cache-owned reference
        self._spill_insert(block, se.arrays)
        self._spill.drop(key)
        self._spill.readopted += 1
        self.spill_hits += 1
        e = _CacheEntry(key, chain_key, block, se.tokens, self._clock)
        self._entries[key] = e
        self._children.setdefault(chain_key, set()).add(key)
        return e

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "lookups": self.lookups,
            "hit_requests": self.hit_requests,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": (self.hit_tokens / self.lookup_tokens
                         if self.lookup_tokens else 0.0),
            "evictions": self.evictions,
            "spill_hits": self.spill_hits,
            "spill_rejects": self.spill_rejects,
            "fences": self.fences,
            "fence_dropped": self.fence_dropped,
        }


def pool_shardings(mesh, cache_cfg: CacheConfig | None = None) -> dict:
    """Each pool array → the mesh axis (or None) of each of its dims
    (JAX ``:676``): heads over ``tp``, as training shards them; rows
    replicated (``dp`` shards the decode batch's slots, and any slot's
    window may touch any row); int8 scales follow their pool's heads.
    ``mesh`` a ``DeviceMesh`` or a ``{name: size}`` mapping."""
    from distributed_tensorflow_tpu_torch.cluster.topology import mesh_shape
    head = "tp" if "tp" in mesh_shape(mesh) else None
    out = {"k": (None, None, head, None), "v": (None, None, head, None)}
    if cache_cfg is not None and cache_cfg.quantized:
        out["k_scale"] = out["v_scale"] = (None, None, head)
    return out


def init_pool(cache_cfg: CacheConfig, device="cuda", mesh=None) -> dict:
    """Zero-initialized ``{"k", "v"}`` pools on ``device`` (plus
    ``k_scale`` / ``v_scale`` per-(row, head) f32 scales when the config
    is int8-quantized). With ``mesh``, this rank's block of them by
    :func:`pool_shardings`: ``n_heads / tp`` heads, every row."""
    from distributed_tensorflow_tpu_torch.cluster.topology import tp_size
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)

    device = resolve_device(device)
    rows = cache_cfg.num_blocks * cache_cfg.block_size
    heads = cache_cfg.n_heads // (tp_size(mesh) if mesh is not None else 1)
    shape = (cache_cfg.n_layers, rows, heads, cache_cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=cache_cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_cfg.dtype, device=device)}
    if cache_cfg.quantized:
        sshape = shape[:3]
        pool["k_scale"] = torch.zeros(sshape, device=device)
        pool["v_scale"] = torch.zeros(sshape, device=device)
    return pool

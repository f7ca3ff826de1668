"""Block-allocated KV cache for incremental decode — port of
``distributed_tensorflow_tpu/serving/kv_cache.py``.

The cache is a pool of fixed-size blocks (PagedAttention, Kwon et al.
SOSP'23): a sequence of length ``L`` holds ``ceil(L / block_size)``
blocks and a finished sequence's blocks return to the pool at once.

- **Host side** — :class:`BlockAllocator` (refcounted free list;
  physical block 0 is the *trash block*: padded positions write there
  and reads from it are always masked) and :class:`BlockTable` (a
  sequence's logical-position → physical-row map). Plain Python, the
  same call-for-call behaviour as the JAX package.
- **Device side** — the pool, ``(n_layers, num_blocks * block_size,
  n_heads, head_dim)`` per K and V (:func:`init_pool`); position ``p``
  of a sequence lives at row ``table[p // block_size] * block_size +
  p % block_size``. ``kv_dtype`` picks the storage: ``"f32"``,
  ``"bf16"`` or ``"int8"`` (quantize on write with one f32 scale per
  (row, head), dequantize on gather).

The prefix cache, its host spill tier and mesh placement belong to
later slices.
"""

from __future__ import annotations

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


def init_pool(cache_cfg: CacheConfig, device="cuda") -> dict:
    """Zero-initialized ``{"k", "v"}`` pools on ``device`` (plus
    ``k_scale`` / ``v_scale`` per-(row, head) f32 scales when the config
    is int8-quantized)."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)

    device = resolve_device(device)
    rows = cache_cfg.num_blocks * cache_cfg.block_size
    shape = (cache_cfg.n_layers, rows, cache_cfg.n_heads,
             cache_cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=cache_cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_cfg.dtype, device=device)}
    if cache_cfg.quantized:
        sshape = shape[:3]
        pool["k_scale"] = torch.zeros(sshape, device=device)
        pool["v_scale"] = torch.zeros(sshape, device=device)
    return pool

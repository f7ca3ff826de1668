"""Serving: KV-cache decode with continuous batching, one device.

- :mod:`kv_cache`  — block-allocated KV pool (f32/bf16/int8 storage),
  refcounted allocator, per-sequence block tables with copy-on-write,
  the prefix cache (:class:`PrefixCache`: committed prompt blocks
  indexed by content, LRU eviction over unreferenced leaves) and its
  host spill tier (:class:`HostTier`).
- :mod:`decode`    — exact-length prefill through the flash forward,
  one-token incremental decode over the block windows, the multi-token
  ``extend`` forward (prefix-hit suffix prefill through the flash
  forward; speculative verify), the speculative draft
  (:func:`truncated_draft`) and :func:`kv_quantization_probe`.
- :mod:`scheduler` — Orca-style continuous batching: admission queue,
  step-boundary admission under a token budget (charged only for the
  unmatched suffix on a prefix-cache hit), prefix-cache eviction, then
  newest-first preemption with replay.
- :mod:`engine`    — :class:`InferenceEngine`, the entry point, with
  ``prefix_caching``, ``spill_tier`` and ``speculative_k``.
"""

from distributed_tensorflow_tpu_torch.serving.decode import (
    kv_quantization_probe, truncated_draft)
from distributed_tensorflow_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    BlockAllocator, BlockTable, CacheConfig, HostTier, OutOfBlocksError,
    PrefixCache)
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    AdmissionQueue, ContinuousBatchingScheduler, QueueOverflowError,
    Request)

__all__ = ["AdmissionQueue", "BlockAllocator", "BlockTable", "CacheConfig",
           "ContinuousBatchingScheduler", "HostTier", "InferenceEngine",
           "OutOfBlocksError", "PrefixCache", "QueueOverflowError",
           "Request", "kv_quantization_probe", "truncated_draft"]

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
  newest-first preemption with replay (or, through ``preempt_hook``,
  rescue by migration); ``requeue_running`` for a hot-swap, ``adopt``
  for a migrated-in sequence.
- :mod:`engine`    — :class:`InferenceEngine`, the entry point, with
  ``prefix_caching``, ``spill_tier``, ``speculative_k``,
  ``role="prefill"``, KV export/adopt, ``install_version`` (in-place
  weight hot-swap) and the ``serve.step`` fault site.
- :mod:`migrate`   — KV-block migration: :class:`MigrationPayload`, its
  wire format (:func:`pack_payload`, byte-compatible with the JAX
  package's), :class:`FileKV` publish/fetch, and
  :class:`DisaggregatedEngine` (prefill and decode replicas, rescue).
"""

from distributed_tensorflow_tpu_torch.serving.decode import (
    kv_quantization_probe, truncated_draft)
from distributed_tensorflow_tpu_torch.serving.engine import InferenceEngine
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    BlockAllocator, BlockTable, CacheConfig, HostTier, OutOfBlocksError,
    PrefixCache)
from distributed_tensorflow_tpu_torch.serving.migrate import (
    DisaggregatedEngine, FileKV, MigrationPayload, fetch_payload,
    pack_payload, payload_committed, publish_payload, unpack_payload)
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    AdmissionQueue, ContinuousBatchingScheduler, QueueOverflowError,
    Request)

__all__ = ["AdmissionQueue", "BlockAllocator", "BlockTable", "CacheConfig",
           "ContinuousBatchingScheduler", "DisaggregatedEngine", "FileKV",
           "HostTier", "InferenceEngine", "MigrationPayload",
           "OutOfBlocksError", "PrefixCache", "QueueOverflowError",
           "Request", "fetch_payload", "kv_quantization_probe",
           "pack_payload", "payload_committed", "publish_payload",
           "truncated_draft", "unpack_payload"]

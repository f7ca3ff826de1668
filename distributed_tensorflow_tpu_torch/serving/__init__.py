"""Serving: KV-cache decode with continuous batching, one device.

- :mod:`kv_cache`  — block-allocated KV pool (f32/bf16/int8 storage),
  refcounted allocator, per-sequence block tables.
- :mod:`decode`    — exact-length prefill through the flash forward and
  one-token incremental decode over the block windows.
- :mod:`scheduler` — Orca-style continuous batching: admission queue,
  step-boundary admission under a token budget, newest-first
  preemption with replay.
- :mod:`engine`    — :class:`~distributed_tensorflow_tpu_torch.serving.
  engine.InferenceEngine`, the entry point.
"""

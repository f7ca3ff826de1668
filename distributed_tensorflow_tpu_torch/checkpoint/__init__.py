"""Checkpointing — port of ``distributed_tensorflow_tpu/checkpoint``:
object save/restore in JAX's on-disk format with rotation and the
recovery tiers (:mod:`checkpoint`), the in-memory host/peer snapshot
tiers and the chunked KV blob transport (:mod:`peer_snapshot`), delta
chains of dynamic tables (:mod:`delta`), and preemption handling
(:mod:`failure_handling`, :mod:`preemption_watcher`). Import the
submodule you use."""

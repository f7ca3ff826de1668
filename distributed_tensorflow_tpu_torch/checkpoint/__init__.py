"""Checkpointing — port of ``distributed_tensorflow_tpu/checkpoint``:
object save/restore in JAX's on-disk format with rotation and the
recovery tiers (:mod:`checkpoint`), the in-memory host/peer snapshot
tiers and the chunked KV blob transport (:mod:`peer_snapshot`), delta
chains of dynamic tables (:mod:`delta`), and preemption handling
(:mod:`failure_handling`, :mod:`preemption_watcher`). JAX's
package-level names load on first use."""

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_M = "distributed_tensorflow_tpu_torch.checkpoint."

#: package-level name -> the submodule that defines it
_LAZY = {
    **{n: _M + "checkpoint" for n in (
        "Checkpoint", "CheckpointCorruptError",
        "CheckpointManager", "latest_checkpoint")},
    **{n: _M + "delta" for n in (
        "DeltaChainError", "DeltaSnapshotStore", "states_equal")},
    **{n: _M + "peer_snapshot" for n in (
        "HostSnapshot", "SnapshotStore")},
    **{n: _M + "failure_handling" for n in (
        "EXIT_PREEMPTED", "PreemptionCheckpointHandler",
        "TerminationConfig", "TrainingPreempted")},
    "PreemptionWatcher": _M + "preemption_watcher",
}

__getattr__, __dir__ = _lazy_names(globals(), _LAZY)

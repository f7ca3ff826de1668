"""Training-loop layer of the port: the Keras shim's ``Model``
(``compile`` / ``fit`` / ``evaluate`` / ``predict``), layers, the
functional API, losses, metrics, regularizers, schedules, optimizers,
callbacks, saving and the step loops — port of
``distributed_tensorflow_tpu/training/``. ``Model`` and the callbacks
load on first use, as JAX's package names (or use
``distributed_tensorflow_tpu_torch.keras``)."""

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_M = "distributed_tensorflow_tpu_torch.training."

#: package-level name -> the submodule that defines it
_LAZY = {
    "Model": _M + "model",
    **{n: _M + "callbacks" for n in (
        "BackupAndRestore", "Callback", "CSVLogger",
        "EarlyStopping", "History", "LearningRateScheduler",
        "ModelCheckpoint", "ReduceLROnPlateau", "TensorBoard",
        "TerminateOnNaN")},
}

__getattr__, __dir__ = _lazy_names(globals(), _LAZY)

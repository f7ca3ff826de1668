"""Training callbacks for Model.fit — port of
``distributed_tensorflow_tpu/training/callbacks.py`` (pure Python):
History, ProgbarLogger, ReduceLROnPlateau, CSVLogger, TerminateOnNaN,
EarlyStopping, ModelCheckpoint, LearningRateScheduler, BackupAndRestore
(an epoch-granular backup of weights, optimizer state and epoch,
deleted when fit completes) and TensorBoard (``utils/summary.py``'s
event files).
"""

from __future__ import annotations

import os
import shutil

import numpy as np


class Callback:
    """Base callback (≙ tf_keras Callback). Overridable hooks only."""

    #: How often this callback needs per-batch LOGS. Computing batch
    #: logs materializes every metric on the host (a device sync that
    #: defeats async dispatch), so Model.fit only builds them on steps
    #: where some overriding callback's interval divides the step.
    batch_log_interval = 1

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, batch, logs=None):
        pass

    def on_train_batch_end(self, batch, logs=None):
        pass

    def on_test_begin(self, logs=None):
        pass

    def on_test_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model, params):
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            cb.set_model(model)
            cb.set_params(params)

    def _call(self, hook, *args):
        for cb in self.callbacks:
            getattr(cb, hook)(*args)

    def on_train_begin(self, logs=None):
        self._call("on_train_begin", logs)

    def on_train_end(self, logs=None):
        self._call("on_train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_train_batch_begin(self, batch, logs=None):
        self._call("on_train_batch_begin", batch, logs)

    def on_train_batch_end(self, batch, logs=None):
        self._call("on_train_batch_end", batch, logs)

    def on_test_begin(self, logs=None):
        self._call("on_test_begin", logs)

    def on_test_end(self, logs=None):
        self._call("on_test_end", logs)


class History(Callback):
    """Records epoch logs; Model.fit returns it (≙ tf_keras History)."""

    def on_train_begin(self, logs=None):
        if not hasattr(self, "history"):
            self.history = {}
            self.epoch = []

    def on_epoch_end(self, epoch, logs=None):
        self.epoch.append(epoch)
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgbarLogger(Callback):
    """One line per epoch (the TPU-friendly verbose=1)."""

    def on_epoch_end(self, epoch, logs=None):
        items = "  ".join(f"{k}={v:.4f}" for k, v in (logs or {}).items()
                          if isinstance(v, (int, float, np.floating)))
        epochs = self.params.get("epochs", "?")
        print(f"epoch {epoch + 1}/{epochs}  {items}", flush=True)


def _improved(current, best, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return current < best - min_delta
    return current > best + min_delta


class ReduceLROnPlateau(Callback):
    """≙ tf_keras ReduceLROnPlateau: multiply the (mutable) learning
    rate by ``factor`` after ``patience`` epochs without monitored
    improvement; stop at ``min_lr``; ``cooldown`` epochs pause the
    patience counter after each reduction.

    Requires a FLOAT learning rate: compiling with a ``schedules.*``
    callable makes ``model.learning_rate`` schedule-driven (re-evaluated
    every update), so the learning_rate setter raises on that
    combination instead."""

    def __init__(self, monitor="val_loss", factor=0.1, patience=10,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0,
                 verbose=0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau requires factor < 1.0")
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.verbose = verbose
        self._reset()

    def _reset(self):
        self.best = np.inf if self.mode == "min" else -np.inf
        self.wait = 0
        self.cooldown_counter = 0

    def on_train_begin(self, logs=None):
        self._reset()       # reusable across fit() calls, like keras

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if _improved(current, self.best, self.mode, self.min_delta):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old = self.model.learning_rate
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    self.model.learning_rate = new
                    if self.verbose:
                        print(f"ReduceLROnPlateau: epoch {epoch + 1}: "
                              f"lr -> {new:.3e}", flush=True)
                self.cooldown_counter = self.cooldown
                self.wait = 0


class CSVLogger(Callback):
    """≙ tf_keras CSVLogger: one row of epoch logs per epoch."""

    def __init__(self, filename, separator=",", append=False):
        super().__init__()
        self.filename = str(filename)
        self.sep = separator
        self.append = append
        self._file = None
        self._keys = None

    def on_train_begin(self, logs=None):
        import os
        # append mode resumes an existing file WITHOUT a second header
        # (tf_keras checks existing content the same way)
        has_content = (self.append and os.path.exists(self.filename)
                       and os.path.getsize(self.filename) > 0)
        self._file = open(self.filename,
                          "a" if self.append else "w", buffering=1)
        self._keys = None
        self._header_written = has_content

    def on_epoch_end(self, epoch, logs=None):
        logs = dict(logs or {})
        if self._keys is None:
            self._keys = sorted(logs)
            if not self._header_written:
                self._file.write(
                    self.sep.join(["epoch"] + self._keys) + "\n")
                self._header_written = True
        row = [str(epoch)] + [f"{logs.get(k, '')}" for k in self._keys]
        self._file.write(self.sep.join(row) + "\n")

    def on_train_end(self, logs=None):
        if self._file is not None:
            self._file.close()
            self._file = None


class TerminateOnNaN(Callback):
    """≙ tf_keras TerminateOnNaN — WITH ONE DELIBERATE DEVIATION:
    the loss is checked every ``check_every`` batches (default 10), not
    every batch like tf_keras. The epoch loss metric is a running mean,
    so one NaN batch poisons it permanently and a sparse check still
    catches it within ``check_every`` steps — without forcing the
    per-batch host-device metric sync that defeats async dispatch.

    The cost of the sparse default: up to ``check_every - 1`` additional
    optimizer steps run on NaN parameters before training stops, so
    params (and any checkpoint taken in that window) may be poisoned.
    Pass ``check_every=1`` for tf_keras-exact behavior when debugging
    divergence or checkpointing every batch; see README "Training
    callbacks" for the trade-off.
    """

    def __init__(self, check_every: int = 10):
        super().__init__()
        self.batch_log_interval = max(1, int(check_every))

    def on_train_batch_end(self, batch, logs=None):
        loss = (logs or {}).get("loss")
        if loss is not None and not np.isfinite(loss):
            print(f"TerminateOnNaN: batch {batch}: invalid loss "
                  f"{loss}, terminating", flush=True)
            self.model.stop_training = True


class EarlyStopping(Callback):
    """≙ tf_keras EarlyStopping (monitor/patience/min_delta/mode +
    restore_best_weights)."""

    def __init__(self, monitor="val_loss", min_delta=0.0, patience=0,
                 mode="auto", restore_best_weights=False, baseline=None):
        super().__init__()
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.restore_best_weights = restore_best_weights
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.stopped_epoch = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))
        self.best_weights = None

    def on_epoch_end(self, epoch, logs=None):
        current = (logs or {}).get(self.monitor)
        if current is None:
            return
        if _improved(current, self.best, self.mode, self.min_delta):
            self.best = current
            self.wait = 0
            if self.restore_best_weights:
                self.best_weights = self.model.get_weights()
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True
                if self.restore_best_weights and self.best_weights is not None:
                    self.model.set_weights(self.best_weights)


class ModelCheckpoint(Callback):
    """≙ tf_keras ModelCheckpoint: save weights each epoch, optionally only
    on monitored improvement. ``filepath`` may contain ``{epoch}``."""

    def __init__(self, filepath, monitor="val_loss", save_best_only=False,
                 mode="auto", save_weights_only=False):
        # save_weights_only default matches tf_keras (False = full
        # model); plain training.Model users (no serializable
        # architecture) should pass save_weights_only=True.
        super().__init__()
        self.filepath = str(filepath)
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.save_weights_only = save_weights_only
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = np.inf if self.mode == "min" else -np.inf

    def on_train_begin(self, logs=None):
        # Fail FAST when full-model saving can't work for this model —
        # not after a full epoch of compute. Attempting the actual
        # architecture serialization catches both unsupported model
        # kinds (plain training.Model) AND unserializable layers
        # (Lambda) up front.
        if not self.save_weights_only:
            from distributed_tensorflow_tpu_torch.training.saving import (
                model_config)
            try:
                model_config(self.model)
            except (NotImplementedError, ValueError) as e:
                raise type(e)(
                    f"ModelCheckpoint(save_weights_only=False) cannot "
                    f"serialize this model ({e}); pass "
                    "save_weights_only=True") from e

    def on_epoch_end(self, epoch, logs=None):
        path = self.filepath.format(epoch=epoch + 1)
        if self.save_best_only:
            current = (logs or {}).get(self.monitor)
            if current is None or not _improved(current, self.best,
                                                self.mode, 0.0):
                return
            self.best = current
        if self.save_weights_only:
            self.model.save_weights(path)
        else:
            self.model.save(path)       # full model (arch + weights)


class LearningRateScheduler(Callback):
    """≙ tf_keras LearningRateScheduler: sets the model's (float)
    learning rate at each epoch's start."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = self.schedule(epoch, self.model.learning_rate)
        self.model.learning_rate = lr


class BackupAndRestore(Callback):
    """Epoch-granular fault-tolerance for fit().

    ≙ tf_keras BackupAndRestore + worker_training_state.py:34: at the end
    of every epoch, back up {weights, optimizer state, completed epoch} to
    ``backup_dir``; when fit() starts, restore if a backup exists and
    resume from the next epoch; delete the backup when training completes
    normally.
    """

    def __init__(self, backup_dir: str):
        super().__init__()
        self.backup_dir = str(backup_dir)

    def on_train_begin(self, logs=None):
        self.model._maybe_restore_backup(self.backup_dir)

    def on_epoch_end(self, epoch, logs=None):
        self.model._back_up(self.backup_dir, epoch)

    def on_train_end(self, logs=None):
        shutil.rmtree(self.backup_dir, ignore_errors=True)


class TensorBoard(Callback):
    """Stream epoch metrics (and optionally weight histograms) to
    TensorBoard event files (≙ tf_keras.callbacks.TensorBoard, backed by
    utils/summary.SummaryWriter — no TF dependency).

    Layout matches Keras: ``logdir/train`` for training metrics,
    ``logdir/validation`` for ``val_*`` metrics.
    """

    def __init__(self, log_dir: str = "logs",
                 histogram_freq: int = 0):
        super().__init__()
        self.log_dir = log_dir
        self.histogram_freq = histogram_freq
        self._writers = {}

    def _writer(self, name: str):
        """Lazy per-run writer: no spurious empty 'validation' run when
        fit() has no validation data (matches Keras)."""
        if name not in self._writers:
            from distributed_tensorflow_tpu_torch.utils.summary import \
                SummaryWriter
            self._writers[name] = SummaryWriter(
                os.path.join(self.log_dir, name))
        return self._writers[name]

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            if not isinstance(v, (int, float, np.floating)):
                continue
            if k.startswith("val_"):
                self._writer("validation").scalar(
                    f"epoch_{k[4:]}", float(v), epoch)
            else:
                self._writer("train").scalar(f"epoch_{k}", float(v), epoch)
        if (self.histogram_freq and self.model is not None
                and epoch % self.histogram_freq == 0):   # Keras phase
            state = getattr(self.model, "_state", None) or {}
            params = state.get("params")
            if params is not None:
                from distributed_tensorflow_tpu_torch.utils import tree
                for path, leaf in tree.tree_leaves_with_path(params):
                    name = "/".join(str(p) for p in path)
                    self._writer("train").histogram(
                        name, leaf.detach().cpu().numpy(), epoch)
        for w in self._writers.values():
            w.flush()

    def on_train_end(self, logs=None):
        for w in self._writers.values():
            w.close()
        self._writers = {}

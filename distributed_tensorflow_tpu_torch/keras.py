"""tf.keras-shaped namespace — port of
``distributed_tensorflow_tpu/keras.py``. A Keras script moves to the
port by its import lines alone::

    import distributed_tensorflow_tpu_torch as tf_distribute
    from distributed_tensorflow_tpu_torch import keras

and keeps everything else: layers under ``strategy.scope()``,
``compile(optimizer=..., loss=..., metrics=[...])``, ``fit`` /
``evaluate`` / ``predict``. Weight trees are the JAX package's, so
``port_model.set_weights(jax_model.get_weights())`` carries a model
across.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.training import callbacks
from distributed_tensorflow_tpu_torch.training import layers
from distributed_tensorflow_tpu_torch.training import losses
from distributed_tensorflow_tpu_torch.training import metrics
from distributed_tensorflow_tpu_torch.training import regularizers
from distributed_tensorflow_tpu_torch.training.functional import Input, Model
from distributed_tensorflow_tpu_torch.training.layers import Sequential
from distributed_tensorflow_tpu_torch.training.optimizers import (
    OptimizerSpec as _Spec)


class _Optimizers:
    """keras.optimizers: optax's optimizers with an injected (settable,
    or schedule-driven) learning rate (``training/optimizers.py``)."""

    from distributed_tensorflow_tpu_torch.training import schedules

    @staticmethod
    def SGD(learning_rate=0.01, momentum: float = 0.0):
        return _Spec("sgd", learning_rate, momentum=momentum)

    @staticmethod
    def Adam(learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999):
        return _Spec("adam", learning_rate, b1=b1, b2=b2)

    @staticmethod
    def AdamW(learning_rate=1e-3, weight_decay: float = 1e-4):
        return _Spec("adamw", learning_rate, weight_decay=weight_decay)

    @staticmethod
    def RMSprop(learning_rate=1e-3):
        return _Spec("rmsprop", learning_rate)


optimizers = _Optimizers()


class _Models:
    """keras.models: whole-model persistence and aliases."""

    Model = Model
    Sequential = Sequential

    @staticmethod
    def load_model(filepath: str):
        from distributed_tensorflow_tpu_torch.training.saving import (
            load_model)
        return load_model(filepath)

    @staticmethod
    def save_model(model, filepath: str):
        from distributed_tensorflow_tpu_torch.training.saving import (
            save_model)
        save_model(model, filepath)


models = _Models()


class _Utils:
    """keras.utils: the helpers scripts call."""

    @staticmethod
    def to_categorical(y, num_classes=None, dtype="float32"):
        import numpy as np
        y = np.asarray(y, dtype="int64")
        shape = y.shape
        flat = y.reshape(-1)
        n = int(num_classes) if num_classes else int(flat.max()) + 1
        out = np.zeros((flat.shape[0], n), dtype=dtype)
        out[np.arange(flat.shape[0]), flat] = 1
        return out.reshape(*shape, n)

    @staticmethod
    def set_random_seed(seed: int):
        """Seeds Python's, numpy's and torch's generators."""
        import random

        import numpy as np
        import torch
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

    @staticmethod
    def plot_model(model, *a, **kw):
        raise NotImplementedError(
            "plot_model needs graphviz; use model.summary() instead")


utils = _Utils()

__all__ = ["layers", "losses", "metrics", "callbacks", "optimizers",
           "models", "utils", "regularizers", "Model", "Sequential",
           "Input"]

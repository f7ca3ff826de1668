"""Loss functions — port of ``distributed_tensorflow_tpu/training/
losses.py``: each maps ``(y_true, y_pred)`` to one loss per example
(extra dims meaned), in f32; the Model weights them and takes the
global mean. ``from_logits=False`` clips as JAX's does, and
:func:`_align_ranks` pairs a trailing size-1 prediction dim with
rank-lower labels."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _align_ranks(y_true, y_pred):
    """keras's rank alignment (``squeeze_or_expand``): ``(B,)`` labels
    against ``(B, 1)`` predictions would otherwise broadcast to
    ``(B, B)``."""
    if y_true.ndim == y_pred.ndim - 1 and y_pred.shape[-1] == 1:
        y_true = y_true[..., None]
    elif y_pred.ndim == y_true.ndim - 1 and y_true.shape[-1] == 1:
        y_pred = y_pred[..., None]
    return y_true, y_pred


def _per_example(per: torch.Tensor) -> torch.Tensor:
    return per.reshape(per.shape[0], -1).mean(dim=-1)


class Loss:
    """Base loss: ``call`` returns per-example losses (batch leading)."""

    def __init__(self, name: str | None = None):
        self.name = name or type(self).__name__

    def call(self, y_true, y_pred):
        raise NotImplementedError

    def __call__(self, y_true, y_pred):
        return self.call(y_true, y_pred)


def _logits(y_pred, from_logits: bool):
    return y_pred if from_logits else torch.log(y_pred.clamp(1e-9, 1.0))


class SparseCategoricalCrossentropy(Loss):
    def __init__(self, from_logits: bool = True, name=None):
        super().__init__(name)
        self.from_logits = from_logits

    def call(self, y_true, y_pred):
        logits = _logits(y_pred, self.from_logits).float()
        labels = y_true.long()
        # optax.softmax_cross_entropy_with_integer_labels
        per = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, labels[..., None]).squeeze(-1))
        return _per_example(per)


class CategoricalCrossentropy(Loss):
    def __init__(self, from_logits: bool = True, name=None):
        super().__init__(name)
        self.from_logits = from_logits

    def call(self, y_true, y_pred):
        logits = _logits(y_pred, self.from_logits).float()
        per = -(y_true.float() * F.log_softmax(logits, dim=-1)).sum(-1)
        return _per_example(per)


class BinaryCrossentropy(Loss):
    def __init__(self, from_logits: bool = True, name=None):
        super().__init__(name)
        self.from_logits = from_logits

    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        y = y_true.float()
        p = y_pred.float()
        if self.from_logits:
            # optax.sigmoid_binary_cross_entropy
            per = -y * F.logsigmoid(p) - (1 - y) * F.logsigmoid(-p)
        else:
            p = p.clamp(1e-7, 1 - 1e-7)
            per = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
        return _per_example(per)


class MeanSquaredError(Loss):
    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        return _per_example((y_pred.float() - y_true.float()).square())


class MeanAbsoluteError(Loss):
    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        return _per_example((y_pred.float() - y_true.float()).abs())


class Huber(Loss):
    """Quadratic below ``delta``, linear above."""

    def __init__(self, delta: float = 1.0, name: str = "huber"):
        super().__init__(name)
        self.delta = float(delta)

    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        err = y_pred.float() - y_true.float()
        a = err.abs()
        per = torch.where(a <= self.delta, 0.5 * err.square(),
                          self.delta * (a - 0.5 * self.delta))
        return _per_example(per)


class Hinge(Loss):
    """Labels in {0, 1} are mapped to {-1, 1}."""

    def __init__(self, name: str = "hinge"):
        super().__init__(name)

    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        t = y_true.float()
        t = torch.where(t <= 0.0, -1.0, t)
        return _per_example((1.0 - t * y_pred.float()).clamp_min(0.0))


class KLDivergence(Loss):
    """Sum over classes of y·log(y/ŷ)."""

    def __init__(self, name: str = "kl_divergence"):
        super().__init__(name)

    def call(self, y_true, y_pred):
        y_true, y_pred = _align_ranks(y_true, y_pred)
        y = y_true.float().clamp(1e-7, 1.0)
        p = y_pred.float().clamp(1e-7, 1.0)
        return _per_example((y * torch.log(y / p)).sum(-1))


_ALIASES = {
    "sparse_categorical_crossentropy": SparseCategoricalCrossentropy,
    "categorical_crossentropy": CategoricalCrossentropy,
    "binary_crossentropy": BinaryCrossentropy,
    "mse": MeanSquaredError,
    "mean_squared_error": MeanSquaredError,
    "mae": MeanAbsoluteError,
    "mean_absolute_error": MeanAbsoluteError,
    "huber": Huber,
    "hinge": Hinge,
    "kld": KLDivergence,
    "kl_divergence": KLDivergence,
}


def get(identifier) -> Loss:
    if isinstance(identifier, Loss):
        return identifier
    if callable(identifier):
        loss = Loss(getattr(identifier, "__name__", "loss"))
        loss.call = identifier
        return loss
    if isinstance(identifier, str):
        key = identifier.lower()
        if key in _ALIASES:
            return _ALIASES[key]()
    raise ValueError(f"Unknown loss: {identifier!r}; "
                     f"known: {sorted(_ALIASES)}")

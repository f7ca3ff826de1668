"""Metrics with functional state — port of ``distributed_tensorflow_tpu/
training/metrics.py``. A state is a dict of f32 scalar tensors that
only ever sums (``init`` → ``update`` → ``result``); on several
replicas the Model all-reduces it over the data dims before
``result``, so every rank reports the global batch's numbers."""

from __future__ import annotations

import torch


def _zeros(device=None):
    return torch.zeros((), dtype=torch.float32, device=device)


class Metric:
    """``init() -> state``, ``update(state, y, p, w) -> state``,
    ``result(state) -> scalar``."""

    def __init__(self, name: str):
        self.name = name

    def init(self, device=None):
        return {"total": _zeros(device), "count": _zeros(device)}

    def update(self, state, y_true, y_pred, sample_weight=None):
        values = self._values(y_true, y_pred).float()
        values = values.reshape(values.shape[0], -1).mean(dim=-1)
        w = (torch.ones_like(values) if sample_weight is None
             else sample_weight.float())
        return {"total": state["total"] + (values * w).sum(),
                "count": state["count"] + w.sum()}

    def result(self, state):
        return state["total"] / state["count"].clamp_min(1e-9)

    def _values(self, y_true, y_pred):
        raise NotImplementedError


class Mean(Metric):
    """Weighted running mean of directly supplied values (the loss)."""

    def __init__(self, name: str = "mean"):
        super().__init__(name)

    def update_values(self, state, values, sample_weight=None):
        values = torch.as_tensor(values).float().reshape(-1)
        w = (torch.ones_like(values) if sample_weight is None
             else torch.as_tensor(sample_weight).float().reshape(-1))
        return {"total": state["total"] + (values * w).sum(),
                "count": state["count"] + w.sum()}

    def _values(self, y_true, y_pred):
        return torch.as_tensor(y_pred).float()


class SparseCategoricalAccuracy(Metric):
    def __init__(self, name: str = "accuracy"):
        super().__init__(name)

    def _values(self, y_true, y_pred):
        pred = y_pred.argmax(dim=-1)
        return (pred == y_true.to(pred.dtype)).float()


class CategoricalAccuracy(Metric):
    def __init__(self, name: str = "accuracy"):
        super().__init__(name)

    def _values(self, y_true, y_pred):
        return (y_pred.argmax(-1) == y_true.argmax(-1)).float()


class BinaryAccuracy(Metric):
    def __init__(self, name: str = "accuracy", threshold: float = 0.5,
                 from_logits: bool = True):
        super().__init__(name)
        self.threshold = threshold
        self.from_logits = from_logits

    def _values(self, y_true, y_pred):
        from distributed_tensorflow_tpu_torch.training.losses import (
            _align_ranks)
        y_true, y_pred = _align_ranks(y_true, y_pred)
        p = torch.sigmoid(y_pred) if self.from_logits else y_pred
        pred = (p > self.threshold).float()
        return (pred == y_true.float()).float()


class TopKCategoricalAccuracy(Metric):
    """Hit iff the true class is among the k highest predictions; sparse
    or one-hot labels. Ties rank as ``jax.lax.top_k`` ranks them (a
    lower index first), so the true class's rank is the count of scores
    above it plus the count of equal scores at lower indices."""

    def __init__(self, k: int = 5, name: str | None = None):
        super().__init__(name or f"top_{k}_accuracy")
        self.k = int(k)

    def _values(self, y_true, y_pred):
        if y_true.ndim == y_pred.ndim:
            if y_true.shape[-1] == y_pred.shape[-1]:   # one-hot
                y_true = y_true.argmax(-1)
            else:                                      # sparse (B, 1)
                y_true = y_true.squeeze(-1)
        k = min(self.k, y_pred.shape[-1])
        idx = y_true.long()[..., None]
        score = y_pred.gather(-1, idx)
        ar = torch.arange(y_pred.shape[-1], device=y_pred.device)
        rank = ((y_pred > score).sum(-1)
                + ((y_pred == score) & (ar < idx)).sum(-1))
        return (rank < k).float()


class _ConfusionMetric(Metric):
    """Threshold-based confusion counts (Precision / Recall)."""

    def __init__(self, name: str, threshold: float, from_logits: bool):
        super().__init__(name)
        self.threshold = float(threshold)
        self.from_logits = from_logits

    def init(self, device=None):
        return {"true_pos": _zeros(device), "denom": _zeros(device)}

    def _pred(self, y_pred):
        p = torch.sigmoid(y_pred) if self.from_logits else y_pred
        return (p > self.threshold).float()

    def update(self, state, y_true, y_pred, sample_weight=None):
        pred = self._pred(y_pred).reshape(y_pred.shape[0], -1)
        true = torch.as_tensor(y_true).float().reshape(pred.shape)
        if sample_weight is None:
            w = torch.ones((pred.shape[0], 1), dtype=torch.float32,
                           device=pred.device)
        else:
            w = torch.as_tensor(sample_weight).float()
            w = w.reshape(pred.shape) if w.numel() == pred.numel() \
                else w.reshape(-1, 1)
        return {"true_pos": state["true_pos"] + (pred * true * w).sum(),
                "denom": state["denom"]
                + (self._denom_mask(true, pred) * w).sum()}

    def result(self, state):
        return state["true_pos"] / state["denom"].clamp_min(1e-9)

    def _denom_mask(self, true, pred):
        raise NotImplementedError


class Precision(_ConfusionMetric):
    def __init__(self, name: str = "precision", threshold: float = 0.5,
                 from_logits: bool = False):
        super().__init__(name, threshold, from_logits)

    def _denom_mask(self, true, pred):
        return pred                                 # TP + FP


class Recall(_ConfusionMetric):
    def __init__(self, name: str = "recall", threshold: float = 0.5,
                 from_logits: bool = False):
        super().__init__(name, threshold, from_logits)

    def _denom_mask(self, true, pred):
        return true                                 # TP + FN


class MeanMetricWrapper(Metric):
    """A ``fn(y_true, y_pred) -> per-example values`` as a metric."""

    def __init__(self, fn, name: str | None = None):
        super().__init__(name or getattr(fn, "__name__", "metric"))
        self._fn = fn

    def _values(self, y_true, y_pred):
        return self._fn(y_true, y_pred)


def get(identifier, *, loss=None) -> Metric:
    """Resolve a metric identifier; "accuracy" takes the flavour of the
    compiled loss."""
    from distributed_tensorflow_tpu_torch.training import losses as losses_lib
    if isinstance(identifier, Metric):
        return identifier
    if callable(identifier) and not isinstance(identifier, str):
        return MeanMetricWrapper(identifier)
    key = str(identifier).lower()
    if key in ("accuracy", "acc"):
        if isinstance(loss, losses_lib.BinaryCrossentropy):
            return BinaryAccuracy()
        if isinstance(loss, losses_lib.CategoricalCrossentropy):
            return CategoricalAccuracy()
        return SparseCategoricalAccuracy()
    table = {
        "sparse_categorical_accuracy": SparseCategoricalAccuracy,
        "categorical_accuracy": CategoricalAccuracy,
        "binary_accuracy": BinaryAccuracy,
        "precision": Precision,
        "recall": Recall,
        "top_k_categorical_accuracy": TopKCategoricalAccuracy,
        "sparse_top_k_categorical_accuracy": TopKCategoricalAccuracy,
    }
    if key in table:
        metric = table[key]()
        metric.name = key
        return metric
    raise ValueError(f"Unknown metric: {identifier!r}")

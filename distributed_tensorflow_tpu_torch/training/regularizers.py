"""keras.regularizers-shaped weight regularizers — port of
``distributed_tensorflow_tpu/training/regularizers.py``: the same
L1/L2/L1L2 penalties, configs and factory aliases. The layers record
each penalty once a weight (``training/layers.py``); the Model adds
their sum to the objective and to the reported loss.
"""

from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, x):
        raise NotImplementedError

    def get_config(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_config(cls, config: dict):
        return cls(**config)


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, x):
        x = x.float()
        out = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.l1:
            # |x| as jnp.abs differentiates it: slope +1 at 0 (a zero
            # bias's first step), where torch's abs has 0
            out = out + self.l1 * torch.where(x >= 0, x, -x).sum()
        if self.l2:
            out = out + self.l2 * x.square().sum()
        return out

    def get_config(self):
        return {"l1": self.l1, "l2": self.l2}


class L1(L1L2):
    def __init__(self, l1: float = 0.01):
        super().__init__(l1=l1)

    def get_config(self):
        return {"l1": self.l1}


class L2(L1L2):
    def __init__(self, l2: float = 0.01):
        super().__init__(l2=l2)

    def get_config(self):
        return {"l2": self.l2}


def l1(l1: float = 0.01) -> L1:
    return L1(l1)


def l2(l2: float = 0.01) -> L2:
    return L2(l2)


def l1_l2(l1: float = 0.01, l2: float = 0.01) -> L1L2:
    return L1L2(l1=l1, l2=l2)


_CLASSES = {"L1": L1, "L2": L2, "L1L2": L1L2}


def serialize(reg) -> dict | None:
    if reg is None:
        return None
    return {"class_name": type(reg).__name__, "config": reg.get_config()}


def deserialize(config) -> Regularizer | None:
    if config is None:
        return None
    if isinstance(config, Regularizer):
        return config
    cls = _CLASSES.get(config.get("class_name"))
    if cls is None:
        raise ValueError(f"unknown regularizer {config!r}")
    return cls.from_config(config["config"])


def get(identifier):
    """Resolve a constructor argument: None | Regularizer | "l1"/"l2"
    string | serialized dict."""
    if identifier is None or isinstance(identifier, Regularizer):
        return identifier
    if isinstance(identifier, str):
        key = identifier.lower()
        if key == "l1":
            return L1()
        if key == "l2":
            return L2()
        if key in ("l1_l2", "l1l2"):
            return L1L2(0.01, 0.01)
        raise ValueError(f"unknown regularizer {identifier!r}")
    if isinstance(identifier, dict):
        return deserialize(identifier)
    raise TypeError(f"cannot interpret regularizer {identifier!r}")

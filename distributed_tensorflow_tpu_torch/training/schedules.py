"""keras.optimizers.schedules-shaped learning-rate schedules — port of
``distributed_tensorflow_tpu/training/schedules.py``: the same
constructors and configs, ``schedule(step) -> lr`` computed in f32 as
JAX's ``jnp`` arithmetic computes it. The optimizers evaluate a
schedule at their update count before each step, as
``optax.inject_hyperparams`` does."""

from __future__ import annotations

import numpy as np

_F = np.float32


class LearningRateSchedule:
    """Base class: callable on a step."""

    def __call__(self, step):
        raise NotImplementedError

    def get_config(self) -> dict:
        raise NotImplementedError


class ExponentialDecay(LearningRateSchedule):
    def __init__(self, initial_learning_rate, decay_steps, decay_rate,
                 staircase: bool = False, name: str | None = None):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)
        self.name = name

    def __call__(self, step):
        p = _F(step) / _F(self.decay_steps)
        if self.staircase:
            p = np.floor(p)
        return _F(self.initial_learning_rate) * np.power(
            _F(self.decay_rate), _F(p))

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps,
                "decay_rate": self.decay_rate,
                "staircase": self.staircase, "name": self.name}


class CosineDecay(LearningRateSchedule):
    def __init__(self, initial_learning_rate, decay_steps,
                 alpha: float = 0.0, name: str | None = None):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.alpha = float(alpha)
        self.name = name

    def __call__(self, step):
        frac = np.minimum(_F(step) / _F(self.decay_steps), _F(1.0))
        cosine = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * frac))
        return _F(self.initial_learning_rate) * (
            _F(1.0 - self.alpha) * cosine + _F(self.alpha))

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps, "alpha": self.alpha,
                "name": self.name}


class PiecewiseConstantDecay(LearningRateSchedule):
    def __init__(self, boundaries, values, name: str | None = None):
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                f"values needs len(boundaries)+1 entries; got "
                f"{len(values)} values for {len(boundaries)} boundaries")
        self.boundaries = [int(b) for b in boundaries]
        self.values = [float(v) for v in values]
        self.name = name

    def __call__(self, step):
        lr = _F(self.values[0])
        for b, v in zip(self.boundaries, self.values[1:]):
            if _F(step) > b:
                lr = _F(v)
        return lr

    def get_config(self):
        return {"boundaries": self.boundaries, "values": self.values,
                "name": self.name}


class PolynomialDecay(LearningRateSchedule):
    def __init__(self, initial_learning_rate, decay_steps,
                 end_learning_rate: float = 1e-4, power: float = 1.0,
                 cycle: bool = False, name: str | None = None):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = int(decay_steps)
        self.end_learning_rate = float(end_learning_rate)
        self.power = float(power)
        self.cycle = bool(cycle)
        self.name = name

    def __call__(self, step):
        step = _F(step)
        if self.cycle:
            mult = np.maximum(_F(1.0), np.ceil(
                step / _F(max(self.decay_steps, 1))))
            decay_steps = _F(self.decay_steps) * mult
        else:
            decay_steps = _F(self.decay_steps)
            step = np.minimum(step, decay_steps)
        frac = _F(1.0) - step / decay_steps
        return (_F(self.initial_learning_rate - self.end_learning_rate)
                * np.power(frac, _F(self.power))
                + _F(self.end_learning_rate))

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps,
                "end_learning_rate": self.end_learning_rate,
                "power": self.power, "cycle": self.cycle,
                "name": self.name}

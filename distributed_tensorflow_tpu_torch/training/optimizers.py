"""The Keras shim's optimizers: optax's, written out in torch.

JAX's string optimizers and ``keras.optimizers`` are optax transforms
wrapped in ``optax.inject_hyperparams`` (``training/model.py:150-157``,
``keras.py:35-66``). An :class:`OptimizerSpec` is that transform's
description; :meth:`OptimizerSpec.create` builds the update over a list
of parameters:

- ``"sgd"`` — ``optax.sgd``: with ``momentum``, the trace
  ``t = g + momentum·t`` (not Nesterov), then ``p -= lr·t``;
- ``"adam"`` / ``"adamw"`` — the port's
  :class:`~distributed_tensorflow_tpu_torch.models.transformer.AdamW`
  (``optax.adamw``'s arithmetic; ``eps`` outside the square root,
  ``eps_root`` 0; ``"adam"`` with no decay, ``"adamw"`` with
  ``weight_decay`` on every leaf). One difference: the JAX ``keras``
  constructors inject ``b1``/``b2`` as f32 arrays, so optax's
  ``1 - b1`` is an f32 subtraction, here a Python one (the two
  coefficients part in the last bit);
- ``"rmsprop"`` — ``optax.rmsprop`` at its defaults: ``nu = decay·nu +
  (1 − decay)·g²`` from 0, ``u = g·rsqrt(nu + eps)`` (optax's
  ``eps_in_sqrt=True``), ``decay`` 0.9, ``eps`` 1e-8.

The learning rate is injected each step: a float (f32-rounded, as the
injected array holds it, and settable) or a schedule evaluated at the
update count before the update, as ``inject_hyperparams`` evaluates it.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.transformer import AdamW


def f32(x) -> float:
    """``x`` rounded to f32, as a Python float."""
    return float(np.float32(x))


class SGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum)``, in place."""

    def __init__(self, params, *, lr: float, momentum: float | None = None):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, m = group["lr"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad.float()
                if m is not None:
                    st = self.state[p]
                    u = u + m * st["trace"]
                    st["trace"] = u
                p.add_(u * -lr)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` at its defaults, in place."""

    def __init__(self, params, *, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, d, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                nu = (1 - d) * g.square() + d * st["nu"]
                st["nu"] = nu
                p.add_(g * torch.rsqrt(nu + eps) * -lr)


class OptimizerSpec:
    """An optax optimizer under ``inject_hyperparams`` (module
    docstring): ``kind`` one of "sgd", "adam", "adamw", "rmsprop";
    ``learning_rate`` a float or a schedule."""

    KINDS = ("sgd", "adam", "adamw", "rmsprop")

    def __init__(self, kind: str, learning_rate=1e-3, **hyper):
        if kind not in self.KINDS:
            raise ValueError(f"Unknown optimizer {kind!r}; known: "
                             f"{sorted(self.KINDS)}")
        self.kind = kind
        self.learning_rate = learning_rate
        self.hyper = hyper

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return f32(lr(count) if callable(lr) else lr)

    def create(self, params) -> "InjectedOptimizer":
        return InjectedOptimizer(self, list(params))


class InjectedOptimizer:
    """One :class:`OptimizerSpec` over a parameter list: ``step()``
    applies the update from each ``p.grad`` at the injected learning
    rate; ``learning_rate`` holds the last injected value (settable
    when the rate is a float)."""

    def __init__(self, spec: OptimizerSpec, params: list):
        self.spec = spec
        self.params = params
        self.count = 0
        self.learning_rate = spec.lr_at(0)
        h = spec.hyper
        if spec.kind == "sgd":
            self.opt = SGD(params, lr=self.learning_rate,
                           momentum=h.get("momentum"))
        elif spec.kind in ("adam", "adamw"):
            self.opt = AdamW(
                params, lr=self.learning_rate,
                weight_decay=(h.get("weight_decay", 1e-4)
                              if spec.kind == "adamw" else 0.0),
                betas=(h.get("b1", 0.9), h.get("b2", 0.999)))
        else:
            self.opt = RMSprop(params, lr=self.learning_rate)
        # every slot made now (zeros, as optax's init), so a backup's
        # template holds them before the first update
        for p in params:
            if spec.kind == "sgd" and h.get("momentum") is not None:
                self.opt.state[p]["trace"] = torch.zeros_like(p)
            elif spec.kind == "rmsprop":
                self.opt.state[p]["nu"] = torch.zeros_like(p)
            elif spec.kind in ("adam", "adamw"):
                self.opt.moments(p, self.opt.param_groups[0])

    def step(self):
        if callable(self.spec.learning_rate):
            self.learning_rate = self.spec.lr_at(self.count)
        for g in self.opt.param_groups:
            g["lr"] = self.learning_rate
        self.opt.step()
        self.count += 1

    def state_tree(self) -> dict:
        """The optimizer state as a nest of tensors (a backup's
        ``opt_state``): the count, the injected rate and every
        parameter's slots by parameter index."""
        slots = {}
        for i, p in enumerate(self.params):
            st = self.opt.state.get(p, {})
            slots[str(i)] = {k: (v if isinstance(v, torch.Tensor)
                                 else torch.tensor(v))
                             for k, v in st.items()}
        return {"count": torch.tensor(self.count, dtype=torch.int64),
                "learning_rate": torch.tensor(self.learning_rate,
                                              dtype=torch.float32),
                "slots": slots}

    def load_state_tree(self, tree: dict):
        self.count = int(tree["count"])
        self.learning_rate = f32(tree["learning_rate"])
        for i, p in enumerate(self.params):
            st = {}
            for k, v in tree["slots"].get(str(i), {}).items():
                v = torch.as_tensor(v)
                st[k] = int(v) if v.ndim == 0 and not \
                    v.is_floating_point() else v.to(p.device)
            self.opt.state[p] = st

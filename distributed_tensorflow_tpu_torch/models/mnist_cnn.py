"""MNIST CNN — port of ``distributed_tensorflow_tpu/models/mnist_cnn.py``
(benchmark workload #1).

- :class:`MNISTCNN` — conv3×3(32) → conv3×3(64) → max-pool 2×2 →
  dense(128) → dense(10), flax's parameter names (``Conv_0``,
  ``Conv_1``, ``Dense_0``, ``Dense_1``). The convolutions pad
  ``"SAME"`` (1 a side), the pool is ``"VALID"`` (flax's default), and
  the features are flattened in NHWC order, as flax's reshape of an
  NHWC tensor does, so ``Dense_0``'s kernel rows are JAX's.
- :func:`create_train_state` / :func:`make_train_step` — Adam at
  ``1e-3`` with ``optax.adam``'s arithmetic (the port's
  :class:`~distributed_tensorflow_tpu_torch.models.transformer.AdamW`
  with no decay), integer-label softmax cross-entropy, accuracy.
- :func:`synthetic_data` — JAX's numpy draw, bit for bit.
- :func:`params_from_jax` — a flax param tree into a model.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.layers import (
    Conv, Dense, flax_tree, load_flax)
from distributed_tensorflow_tpu_torch.models.transformer import (
    AdamW, resolve_device, softmax_cross_entropy)


class MNISTCNN(nn.Module):
    """conv3x3(32) -> conv3x3(64) -> maxpool -> dense(128) -> dense(10),
    on NHWC images ``(B, 28, 28, 1)``; the last Dense in f32."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32, *,
                 image_shape=(28, 28, 1), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        h, w, c = image_shape
        kw = dict(bias=True, dtype=dtype, device=device, generator=generator)
        self.Conv_0 = Conv(c, 32, (3, 3), **kw)
        self.Conv_1 = Conv(32, 64, (3, 3), **kw)
        kw.pop("bias")
        self.Dense_0 = Dense((h // 2) * (w // 2) * 64, 128, **kw)
        self.Dense_1 = Dense(128, num_classes,
                             **{**kw, "dtype": torch.float32})
        self.dtype = dtype

    def forward(self, x):
        x = torch.as_tensor(x).permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = nn.functional.max_pool2d(x, 2, 2)
        # flatten in NHWC order, as flax's reshape of its NHWC tensor
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x)


def params_from_jax(tree, device="cuda", **kw) -> MNISTCNN:
    """An :class:`MNISTCNN` (``kw`` its arguments) holding the flax param
    tree ``tree`` (nested dicts of arrays, JAX's ``params``)."""
    model = MNISTCNN(device=device, **kw)
    load_flax(model, tree)
    return model


def flax_params(model: MNISTCNN, of=None) -> dict:
    """The model's parameters (or ``of(parameter)``, e.g. ``lambda p:
    p.grad``) as a flax param tree of numpy arrays."""
    of = of or (lambda p: p)
    return flax_tree((n, of(p)) for n, p in model.named_parameters())


def make_optimizer(params, learning_rate: float = 1e-3) -> AdamW:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8,
    ``eps_root`` 0, bias corrections at ``count + 1`` in f32 — the
    port's AdamW with no weight decay computes exactly that."""
    return AdamW(params, lr=learning_rate, weight_decay=0.0)


def create_train_state(seed: int = 0, learning_rate: float = 1e-3,
                       image_shape=(1, 28, 28, 1), device="cuda"):
    """``(state, model, optimizer)`` with ``state = {"model",
    "optimizer", "step"}``: a fresh model from ``seed`` (the numbers
    differ from JAX's ``init`` for the same seed)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = MNISTCNN(image_shape=tuple(image_shape[1:]), device=device,
                     generator=gen)
    opt = make_optimizer(model.parameters(), learning_rate)
    return {"model": model, "optimizer": opt, "step": 0}, model, opt


def make_train_step(model: MNISTCNN, tx: AdamW):
    """``train_step(state, batch) -> (state, {"loss", "accuracy"})`` with
    ``batch = {"image": (B, 28, 28, 1), "label": (B,)}`` (numpy or
    tensors), updating the model in place."""
    device = next(model.parameters()).device

    def train_step(state, batch):
        images = torch.as_tensor(batch["image"]).to(device)
        labels = torch.as_tensor(batch["label"]).to(device).long()
        tx.zero_grad(set_to_none=True)
        logits = model(images)
        loss = softmax_cross_entropy(logits, labels).mean()
        loss.backward()
        tx.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach(), "accuracy": acc})

    return train_step


def synthetic_data(n: int = 512, seed: int = 0) -> dict:
    """Deterministic synthetic MNIST-shaped data: JAX's numpy draw, the
    same arrays bit for bit."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 28, 28, 1)).astype("float32")
    labels = (np.abs(images.mean(axis=(1, 2, 3))) * 40).astype("int32") % 10
    return {"image": images, "label": labels}

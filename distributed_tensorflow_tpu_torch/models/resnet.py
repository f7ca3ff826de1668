"""ResNet-50 — port of ``distributed_tensorflow_tpu/models/resnet.py``
(benchmark workload #2).

- :class:`ResNetConfig` — ``resnet50()`` (stages (3, 4, 6, 3), width 64,
  1000 classes, bf16) and ``tiny()`` (stages (1, 1), width 8, 10
  classes, f32). JAX's ``sync_batch_norm``/``axis_names`` (a psum only
  inside ``shard_map``) have no counterpart: the port's data-parallel
  step always takes the global batch's statistics, as GSPMD does.
- :class:`BatchNorm` — JAX's, not ``nn.BatchNorm2d``'s: f32 statistics
  with ``var = E[x²] − E[x]²``, the biased variance into the running
  averages (``ra = 0.9·ra + 0.1·batch``), eps 1e-5,
  ``(x − mean)·rsqrt(var + eps)·scale + bias`` cast to the compute
  dtype; the running averages in eval mode. ``stats_sync`` (the
  data-parallel step's) averages ``mean`` and ``E[x²]`` over the data
  ranks with their gradient, so the statistics are the global batch's,
  as GSPMD computes them in JAX.
- :class:`BottleneckBlock` / :class:`ResNet` — flax's parameter names
  (``conv_init``, ``bn_init``, ``stage{i}_block{j}`` with ``Conv_0``..
  ``Conv_2``, ``BatchNorm_0``..``BatchNorm_2``, ``proj``, ``proj_bn``,
  ``classifier``). Convolutions pad ``"SAME"`` as flax does
  (``models/layers.py``: asymmetric at stride 2), the max pool too, with
  −inf. The input is JAX's NHWC ``batch["image"]``; inside, activations
  are NCHW in ``channels_last`` memory order (cuDNN's preferred layout
  for bf16). The head means over H, W in f32 and rounds to the compute
  dtype, as ``jnp.mean`` of a bf16 array does, and the classifier runs
  in f32 on that.
- :func:`make_optimizer` — ``chain(add_decayed_weights(1e-4, mask=ndim >
  1), sgd(cosine_decay_schedule(0.1, 10000), momentum=0.9,
  nesterov=True))`` written out (:class:`NesterovSGD`).
- :func:`make_train_step` — label smoothing 0.1, softmax CE, accuracy.
- :func:`make_sharded_train_step` — data parallelism over the mesh's
  data axes on ``torch.distributed``: parameters and statistics
  replicated, each rank on its rows, BatchNorm synchronised, gradients
  averaged after the backward.
- :func:`synthetic_images` — JAX's numpy draw, bit for bit.
- :func:`params_from_jax` / :func:`flax_variables` — the flax
  ``params`` and ``batch_stats`` in and out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.layers import (
    Conv, Dense, flax_tree, load_flax, max_pool_same)
from distributed_tensorflow_tpu_torch.models.transformer import (
    resolve_device)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)       # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    label_smoothing: float = 0.1

    @classmethod
    def resnet50(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """CI-sized: resnet-8-ish on 32x32 inputs."""
        defaults = dict(stage_sizes=(1, 1), num_classes=10, width=8,
                        dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class BatchNorm(nn.Module):
    """JAX's ``BatchNorm`` (``resnet.py:64-113``) over NCHW: ``scale`` and
    ``bias`` parameters, ``mean`` and ``var`` running buffers, all f32.
    ``stats_sync(t)`` (None: this rank's batch) maps this rank's ``(2,
    C)`` ``[mean, E[x²]]`` to the global batch's."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.train_mode = True
        self.stats_sync = None
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        x32 = x.float()
        if not self.train_mode:
            mean, var = self.mean, self.var
        else:
            stats = torch.stack([x32.mean(dim=(0, 2, 3)),
                                 x32.square().mean(dim=(0, 2, 3))])
            if self.stats_sync is not None:
                stats = self.stats_sync(stats)
            mean, mean2 = stats[0], stats[1]
            var = mean2 - mean.square()
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        shape = (1, -1, 1, 1)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape)
                                                   + self.epsilon)
        return (y * self.scale.view(shape)
                + self.bias.view(shape)).to(self.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int,
                 cfg: ResNetConfig, device=None, generator=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device, generator=generator)
        bn = dict(dtype=cfg.dtype, device=device)
        self.Conv_0 = Conv(cin, filters, (1, 1), **kw)
        self.BatchNorm_0 = BatchNorm(filters, **bn)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **bn)
        self.Conv_2 = Conv(filters, 4 * filters, (1, 1), **kw)
        self.BatchNorm_2 = BatchNorm(4 * filters, **bn)
        # flax projects when the shapes differ: channels or stride
        if cin != 4 * filters or strides != 1:
            self.proj = Conv(cin, 4 * filters, (1, 1), strides, **kw)
            self.proj_bn = BatchNorm(4 * filters, **bn)
        else:
            self.proj = None

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """The flax ``ResNet`` on NHWC images; logits f32 ``(B, classes)``.
    ``train`` (the default) normalises with the batch's statistics and
    updates the running averages; :meth:`set_train` switches."""

    def __init__(self, cfg: ResNetConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.conv_init = Conv(3, cfg.width, (7, 7), 2,
                              dtype=cfg.dtype, **kw)
        self.bn_init = BatchNorm(cfg.width, dtype=cfg.dtype, device=device)
        cin = cfg.width
        self.blocks = []
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                filters = cfg.width * 2 ** i
                block = BottleneckBlock(cin, filters,
                                        2 if i > 0 and j == 0 else 1, cfg,
                                        **kw)
                self.add_module(f"stage{i}_block{j}", block)
                self.blocks.append(block)
                cin = 4 * filters
        self.classifier = Dense(cin, cfg.num_classes, dtype=torch.float32,
                                **kw)

    def batch_norms(self) -> list:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def set_train(self, train: bool):
        for bn in self.batch_norms():
            bn.train_mode = train
        return self

    def set_stats_sync(self, fn):
        """Every BatchNorm's ``stats_sync`` (None: per-rank statistics)."""
        for bn in self.batch_norms():
            bn.stats_sync = fn
        return self

    def forward(self, images):
        cfg = self.cfg
        x = torch.as_tensor(images).permute(0, 3, 1, 2).to(cfg.dtype)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x, (3, 3), (2, 2))
        for block in self.blocks:
            x = block(x)
        # jnp.mean of cfg.dtype: accumulated in f32, rounded to the dtype
        x = x.float().mean(dim=(2, 3)).to(cfg.dtype)
        return self.classifier(x.float())


def flax_variables(model: ResNet, of=None) -> dict:
    """``{"params", "batch_stats"}`` of ``model`` as flax trees of numpy
    arrays (conv kernels ``(kh, kw, in, out)``); ``of(parameter)`` in
    place of the parameters (``lambda p: p.grad`` for the gradients)."""
    of = of or (lambda p: p)
    return {"params": flax_tree((n, of(p))
                                for n, p in model.named_parameters()),
            "batch_stats": flax_tree(model.named_buffers())}


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


def params_from_jax(cfg: ResNetConfig, params, batch_stats,
                    device="cuda") -> ResNet:
    """A :class:`ResNet` holding flax's ``params`` and ``batch_stats``
    (nested dicts of arrays), conv kernels from ``(kh, kw, in, out)`` to
    ``(out, in, kh, kw)``."""
    model = ResNet(cfg, device=device)

    def plain(t):
        return {k: plain(v) for k, v in t.items()} if hasattr(
            t, "items") else np.asarray(t)
    load_flax(model, _merge(plain(params), plain(batch_stats)))
    return model


def cosine_decay(init_value: float, decay_steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(init_value, decay_steps)(count)`` in
    f32, in optax's order of operations."""
    f32 = torch.float32
    c = torch.tensor(float(min(count, decay_steps)), dtype=f32)
    decay = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
    return float(init_value * decay)


class NesterovSGD(torch.optim.Optimizer):
    """``chain(add_decayed_weights(wd, mask=ndim > 1), sgd(cosine(lr, T),
    momentum, nesterov=True))`` (JAX ``make_optimizer``), in place:

        g' = g + wd·p           (only leaves with ndim > 1)
        t' = g' + m·t,   u = g' + m·t'
        p' = p + (−lr(count))·u,   count += 1

    with the learning rate of optax's cosine schedule at ``count``, which
    starts at 0. ``torch.optim.SGD`` with ``CosineAnnealingLR`` computes
    its rates recursively and gives other values. Plain tensor ops."""

    def __init__(self, params, *, lr: float, momentum: float,
                 weight_decay: float, total_steps: int = 10000):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      total_steps=total_steps))
        self.count = 0

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr = cosine_decay(group["lr"], group["total_steps"], self.count)
            m, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                if p.ndim > 1:
                    g = g + wd * p
                st = self.state[p]
                trace = st.get("trace")
                t = g if trace is None else g + m * trace
                u = g + m * t
                st["trace"] = t
                p.add_(u * -lr)
        self.count += 1


def make_optimizer(cfg: ResNetConfig, params, total_steps: int = 10000
                   ) -> NesterovSGD:
    return NesterovSGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay,
                       total_steps=total_steps)


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                num_classes: int, smoothing: float) -> torch.Tensor:
    """``optax.softmax_cross_entropy(logits, smooth_labels(one_hot,
    smoothing)).mean()``: targets ``one_hot·(1 − a) + a/C``."""
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    target = one_hot * (1.0 - smoothing) + smoothing / num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(target * logp).sum(-1).mean()


def _loss_and_metrics(cfg: ResNetConfig, model: ResNet, images, labels):
    logits = model(images)
    loss = smoothed_ce(logits, labels, cfg.num_classes, cfg.label_smoothing)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss, acc


def make_train_step(cfg: ResNetConfig, model: ResNet, tx):
    """``train_step(state, batch) -> (state, {"loss", "accuracy"})`` with
    ``state = {"model", "optimizer", "step"}`` and ``batch = {"image":
    NHWC, "label": int}``; the parameters, the optimizer's trace and the
    BatchNorm statistics updated in place."""
    device = next(model.parameters()).device

    def train_step(state, batch):
        images = torch.as_tensor(batch["image"]).to(device)
        labels = torch.as_tensor(batch["label"]).to(device).long()
        tx.zero_grad(set_to_none=True)
        loss, acc = _loss_and_metrics(cfg, model, images, labels)
        loss.backward()
        tx.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach(), "accuracy": acc})

    return train_step


class _MeanOverData(torch.autograd.Function):
    """The mean of a tensor over the data ranks, forward and backward:
    each rank's loss takes the global statistics, and the gradient that
    reaches a rank's own statistics is the mean of every rank's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from distributed_tensorflow_tpu_torch.parallel.collectives import (
            ReduceOp, all_reduce)
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes, ReduceOp.MEAN)

    @staticmethod
    def backward(ctx, g):
        from distributed_tensorflow_tpu_torch.parallel.collectives import (
            ReduceOp, all_reduce)
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes,
                          ReduceOp.MEAN), None, None


def make_sharded_train_step(cfg: ResNetConfig, mesh, global_batch: int,
                            image_size: int = 224, seed: int = 0, *,
                            params=None, batch_stats=None):
    """Data-parallel training over ``mesh``'s data axes (JAX
    ``:217-259``). Returns ``(state, step)``: ``state = {"model",
    "optimizer", "step"}``; ``step(state, {"image": (global_batch, H, W,
    3), "label"})`` takes every rank's copy of the global batch, trains
    on this rank's rows and returns ``(state, {"loss", "accuracy"})``
    meaned over the data axes (the global batch's). The parameters and
    statistics are replicated: ``params``/``batch_stats`` (flax trees)
    seed every replica; without them rank 0 initialises from ``seed`` and
    broadcasts. Every BatchNorm averages its ``mean`` and ``E[x²]`` over
    the data axes, and its gradient with them, so the statistics are the
    global batch's as under GSPMD; the gradients are meaned over the data
    axes after the backward (:class:`~distributed_tensorflow_tpu_torch.
    parallel.collectives.GradientBucketer`), and every replica takes the
    same update. ``image_size`` is JAX's init shape and not needed
    here."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    from distributed_tensorflow_tpu_torch.models.transformer import (
        _data_rows, _mesh_device)
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, all_reduce)
    del image_size
    device = _mesh_device(mesh)
    axes = data_axes(mesh)
    if params is not None:
        model = params_from_jax(cfg, params, batch_stats or {}, device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model = ResNet(cfg, device=device, generator=gen)
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t, src=0)
    rows = _data_rows(mesh, global_batch)
    if axes:
        model.set_stats_sync(
            lambda t: _MeanOverData.apply(t, mesh, axes))
    tx = make_optimizer(cfg, model.parameters())
    bucketer = GradientBucketer(mesh, axes) if axes else None
    params_list = list(model.parameters())

    def step(state, batch):
        images = torch.as_tensor(batch["image"])[rows].to(device)
        labels = torch.as_tensor(batch["label"])[rows].to(device).long()
        tx.zero_grad(set_to_none=True)
        loss, acc = _loss_and_metrics(cfg, model, images, labels)
        loss.backward()
        if bucketer is not None:
            grads = bucketer.all_reduce([p.grad for p in params_list],
                                        ReduceOp.MEAN)
            for p, g in zip(params_list, grads):
                p.grad = g
            loss = all_reduce(loss.detach(), mesh, axes, ReduceOp.MEAN)
            acc = all_reduce(acc, mesh, axes, ReduceOp.MEAN)
        tx.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach(), "accuracy": acc})

    return {"model": model, "optimizer": tx, "step": 0}, step


def synthetic_images(n: int, image_size: int = 224, num_classes: int = 1000,
                     seed: int = 0) -> dict:
    """Deterministic synthetic imagenet-shaped data: JAX's numpy draw,
    the same arrays bit for bit."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, image_size, image_size, 3)).astype("float32")
    labels = (np.abs(images.mean(axis=(1, 2, 3))) * 40).astype(
        "int32") % num_classes
    return {"image": images, "label": labels}

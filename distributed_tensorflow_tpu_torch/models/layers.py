"""flax ``nn.Conv`` / ``nn.max_pool`` / ``nn.Dense`` semantics in torch,
for the port's image and recommendation models (``models/resnet.py``,
``models/mnist_cnn.py``, ``models/wide_deep.py``).

- :func:`same_pads` — ``jax.lax.padtype_to_pads(..., "SAME")`` for one
  spatial dim: ``(lo, hi)`` with the odd pixel on the high side, so a
  stride-2 ``"SAME"`` window is asymmetric (``(2, 3)`` for 7×7/2 on an
  even size, ``(0, 1)`` for 3×3/2). torch's ``padding=`` is symmetric,
  so :func:`conv2d_same` and :func:`max_pool_same` pad explicitly
  where the two sides differ.
- :class:`Conv` / :class:`Dense` — a flax layer's parameters under its
  names (``kernel``, ``bias``), the kernel in torch's layout (``(out,
  in, kh, kw)``; a Dense kernel stays ``(in, out)`` as flax's), computed
  in the layer's ``dtype`` as flax's ``dtype=`` does.
- :func:`lecun_normal_` — flax's default kernel init (a truncated
  normal of variance ``1/fan_in``); the numbers differ from
  ``jax.random``'s for the same seed.

Activations are NCHW tensors; an NHWC input permuted to NCHW keeps its
memory order, which is torch's ``channels_last``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """``(lo, hi)`` padding of a ``"SAME"`` window over ``size`` pixels
    (``jax.lax.padtype_to_pads``): ``ceil(size/stride)`` outputs, the
    total pad split with the extra pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel, stride) -> tuple:
    """``((lo_h, hi_h), (lo_w, hi_w))`` of ``x`` (NCHW)."""
    return (same_pads(x.shape[2], kernel[0], stride[0]),
            same_pads(x.shape[3], kernel[1], stride[1]))


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d`` with flax's ``"SAME"`` padding: symmetric pads go to
    the convolution, asymmetric ones through ``F.pad`` first."""
    (lh, hh), (lw, hw) = _pads(x, w.shape[2:], stride)
    if lh == hh and lw == hw:
        return F.conv2d(x, w, bias, stride, (lh, lw))
    return F.conv2d(F.pad(x, (lw, hw, lh, hh)), w, bias, stride)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")``: the pad is −inf, so it never
    wins a window."""
    (lh, hh), (lw, hw) = _pads(x, kernel, stride)
    x = F.pad(x, (lw, hw, lh, hh), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``lecun_normal()``: ``variance_scaling(1, "fan_in",
    "truncated_normal")``, a normal cut at ±2σ whose σ is rescaled so the
    variance is ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding="SAME")``:
    ``kernel`` ``(out, in, kh, kw)`` f32 (flax's ``(kh, kw, in, out)``
    transposed), optional ``bias``; the input and kernel cast to
    ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: tuple, stride: int = 1,
                 *, bias: bool = False, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride = (stride, stride)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(
            (cout, cin) + tuple(kernel), device=device),
            cin * kernel[0] * kernel[1], generator))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d_same(x.to(dt), self.kernel.to(dt), self.stride, b)


class Dense(nn.Module):
    """flax ``nn.Dense(features)``: ``kernel`` ``(in, out)``, ``bias``;
    ``x @ kernel + bias`` with all three cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, *, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(cin, cout, device=device), cin, generator))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


def flax_kernel(t: torch.Tensor) -> torch.Tensor:
    """A conv kernel from torch's ``(out, in, kh, kw)`` to flax's ``(kh,
    kw, in, out)`` (other ranks as they are)."""
    return t.permute(2, 3, 1, 0) if t.ndim == 4 else t


def torch_kernel(a) -> torch.Tensor:
    """The inverse of :func:`flax_kernel`: a flax leaf (numpy or torch)
    in torch's layout, contiguous."""
    t = torch.as_tensor(np.array(a, copy=True))
    return (t.permute(3, 2, 0, 1) if t.ndim == 4 else t).contiguous()


def load_flax(module: nn.Module, tree: dict, device=None):
    """Copy a flax variable collection (nested dicts of arrays, e.g.
    ``{"params": ..., "batch_stats": ...}`` merged into one tree, keyed
    by the module's own names) into ``module``'s parameters and buffers,
    conv kernels transposed; a missing or extra name raises."""
    flat: dict = {}

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = torch_kernel(v)
    walk(tree, "")
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    if set(flat) != set(own):
        raise ValueError(f"flax tree and module differ: missing "
                         f"{sorted(set(own) - set(flat))[:4]}, extra "
                         f"{sorted(set(flat) - set(own))[:4]}")
    with torch.no_grad():
        for k, t in own.items():
            if tuple(flat[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(flat[k].shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(flat[k].to(device=t.device, dtype=t.dtype))


def flax_tree(named) -> dict:
    """``(name, tensor)`` pairs (``module.named_parameters()``, or the
    gradients under those names) as a nested dict of numpy arrays in
    flax's layout."""
    out: dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flax_kernel(t.detach().float().cpu()).numpy().copy()
    return out

"""Transformer LM, forward only — port of
``distributed_tensorflow_tpu/models/transformer.py``.

The same architecture and parameter layout as the flax model: tied
embedding → N × [RMSNorm → rotary MHA → residual → RMSNorm → SwiGLU MLP
→ residual] → final RMSNorm → logits against the embedding. Parameters
are f32 (as flax keeps them) and cast to ``cfg.dtype`` at use. The
attention projections keep the flax ``(D, H, hd)`` / ``(H, hd, D)``
layout, projecting straight into the ``(B, H, S, hd)`` kernel layout.

The port's parameter dict is the stacked layout the serving programs
index — flax's ``scan_layers=True`` tree with torch tensors::

    {"embed": (V, D),
     "layers": {"RMSNorm_0": {"scale": (L, D)},
                "attn": {"query"|"key"|"value": (L, D, H, hd),
                         "out": (L, H, hd, D)},
                "RMSNorm_1": {"scale": (L, D)},
                "mlp": {"wi": (L, D, 2F), "wo": (L, F, D)}},
     "final_norm": {"scale": (D,)}}

:func:`init_params` makes one from a ``torch.Generator`` with flax's
init distributions; :func:`params_from_jax` converts a flax tree (as
numpy arrays, either layout); :meth:`TransformerLM.load_params` loads
one into the module. Mesh, MoE, remat, scan and the loss/optimizer
fields of the JAX config belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from distributed_tensorflow_tpu_torch.ops.attention import (
    flash_attention, mha_reference)


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument; a CUDA
    device on a machine without one raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    causal: bool = True            # False -> bidirectional encoder (BERT)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Test-sized config."""
        defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        d_ff=128, max_seq_len=128, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def bert_base(cls, **kw) -> "TransformerConfig":
        defaults = dict(vocab_size=30522, d_model=768, n_layers=12,
                        n_heads=12, d_ff=3072, max_seq_len=512, causal=False)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def transformer_big(cls, **kw) -> "TransformerConfig":
        """Transformer-big (WMT) widths."""
        defaults = dict(vocab_size=32768, d_model=1024, n_layers=12,
                        n_heads=16, d_ff=4096, max_seq_len=1024)
        defaults.update(kw)
        return cls(**defaults)


def rms_norm(x, scale, dtype, eps: float = 1e-6):
    """RMSNorm math in f32 with an f32 ``scale``, cast to ``dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(dtype)


def rotary_embedding(x, *, base: float = 10000.0, seq_axis: int = -3):
    """RoPE with the sequence axis at ``seq_axis`` and head_dim last;
    angles in f32, result in ``x``'s dtype."""
    seq, d = x.shape[seq_axis], x.shape[-1]
    pos = torch.arange(seq, dtype=torch.float32, device=x.device)
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    angles = pos[:, None] * inv_freq[None, :]              # (seq, d/2)
    bshape = [1] * x.ndim
    bshape[seq_axis], bshape[-1] = seq, d // 2
    sin = torch.sin(angles).reshape(bshape)
    cos = torch.cos(angles).reshape(bshape)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def project_heads(x, w):
    """``einsum("bsd,dhk->bhsk")`` as one matmul: ``(B, S, D)`` times a
    ``(D, H, hd)`` weight → contiguous ``(B, H, S, hd)``."""
    d, h, hd = w.shape
    y = x @ w.reshape(d, h * hd)
    return y.unflatten(-1, (h, hd)).transpose(-3, -2).contiguous()


def merge_heads(o, w):
    """``einsum("bhsk,hkd->bsd")``: ``(B, H, S, hd)`` times ``(H, hd, D)``."""
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) @ w.reshape(h * hd, -1)


def swiglu(h, wi, wo):
    gate, up = (h @ wi).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ wo


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, device=None, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, self.dtype, self.eps)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        for name in ("query", "key", "value"):
            setattr(self, name, nn.Parameter(torch.empty(D, H, hd,
                                                         device=device)))
        self.out = nn.Parameter(torch.empty(H, hd, D, device=device))

    def forward(self, x, lengths=None):
        cfg, dt = self.cfg, self.cfg.dtype
        q = rotary_embedding(project_heads(x, self.query.to(dt)), seq_axis=-2)
        k = rotary_embedding(project_heads(x, self.key.to(dt)), seq_axis=-2)
        v = project_heads(x, self.value.to(dt))
        if lengths is not None:
            # right-padded mixed-length batch: the factored length mask
            # (the flash kernel takes no per-row length)
            o = mha_reference(q, k, v, causal=cfg.causal, lengths=lengths)
        else:
            o = flash_attention(q, k, v, causal=cfg.causal)
        return merge_heads(o, self.out.to(dt))


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Fd = cfg.d_model, cfg.d_ff
        self.wi = nn.Parameter(torch.empty(D, 2 * Fd, device=device))
        self.wo = nn.Parameter(torch.empty(Fd, D, device=device))

    def forward(self, x):
        dt = self.cfg.dtype
        return swiglu(x, self.wi.to(dt), self.wo.to(dt))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.RMSNorm_0 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = MultiHeadAttention(cfg, device)
        self.RMSNorm_1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, lengths=None):
        x = x + self.attn(self.RMSNorm_0(x), lengths)
        return x + self.mlp(self.RMSNorm_1(x))


class TransformerLM(nn.Module):
    """Decoder-only LM (``cfg.causal=True``) or bidirectional encoder.

    ``params`` (the port's parameter dict) is loaded when given; else
    the module is initialised by :func:`init_params` from
    ``generator``."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              device=device))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        if params is None:
            params = init_params(cfg, generator, device)
        self.load_params(params)

    @torch.no_grad()
    def load_params(self, params):
        """Copy the port's (stacked) parameter dict into the module."""
        self.embed.copy_(params["embed"])
        self.final_norm.scale.copy_(params["final_norm"]["scale"])
        for i, block in enumerate(self.layers):
            for group, leaves in params["layers"].items():
                mod = getattr(block, group)
                for name, stacked in leaves.items():
                    getattr(mod, name).copy_(stacked[i])

    def forward(self, tokens, return_hidden: bool = False, lengths=None):
        """``lengths`` (B,) marks a right-padded mixed-length batch: every
        layer's attention masks padded keys with the factored rule
        (:func:`~distributed_tensorflow_tpu_torch.ops.attention.
        length_valid_mask`); None runs the flash forward."""
        dt = self.cfg.dtype
        emb = self.embed.to(dt)
        x = emb[tokens]
        for block in self.layers:
            x = block(x, lengths)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return (x @ emb.T).float()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> dict:
    """Shapes of the port's stacked parameter dict."""
    L, V, D, H, hd, Fd = (cfg.n_layers, cfg.vocab_size, cfg.d_model,
                          cfg.n_heads, cfg.head_dim, cfg.d_ff)
    return {
        "embed": (V, D),
        "layers": {
            "RMSNorm_0": {"scale": (L, D)},
            "attn": {"query": (L, D, H, hd), "key": (L, D, H, hd),
                     "value": (L, D, H, hd), "out": (L, H, hd, D)},
            "RMSNorm_1": {"scale": (L, D)},
            "mlp": {"wi": (L, D, 2 * Fd), "wo": (L, Fd, D)},
        },
        "final_norm": {"scale": (D,)},
    }


def init_params(cfg: TransformerConfig,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Fresh f32 parameters with the flax model's init distributions:
    embed N(0, 0.02), query/key/value/out and ``wi`` N(0, D^-1/2),
    ``wo`` N(0, F^-1/2), norm scales 1. ``generator`` must live on
    ``device`` (a CPU generator for ``device="cpu"``); the numbers
    differ from ``jax.random``'s for the same seed."""
    device = resolve_device(device)
    D, Fd = cfg.d_model, cfg.d_ff
    std = {"embed": 0.02, "query": D ** -0.5, "key": D ** -0.5,
           "value": D ** -0.5, "out": D ** -0.5, "wi": D ** -0.5,
           "wo": Fd ** -0.5}

    def make(name, shape):
        if name == "scale":
            return torch.ones(shape, device=device)
        t = torch.empty(shape, device=device)
        return t.normal_(0.0, std[name], generator=generator)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return make(name, node)

    return walk(param_shapes(cfg))


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def params_from_jax(cfg: TransformerConfig, tree, device="cuda") -> dict:
    """The port's parameter dict from a flax ``TransformerLM`` param tree
    given as nested dicts of numpy arrays — stacked ``layers`` (leading
    ``L`` axis, ``scan_layers=True``) or unstacked ``layer_{i}``
    (``scan_layers=False``). Key names are the flax ones."""
    device = resolve_device(device)
    tree = _plain(tree)
    if "layers" in tree:
        layers = tree["layers"]
    else:
        names = [f"layer_{i}" for i in range(cfg.n_layers)]
        missing = [n for n in names if n not in tree]
        if missing:
            raise ValueError(f"params have neither 'layers' nor {missing}")
        layers = {g: {n: np.stack([tree[ln][g][n] for ln in names])
                      for n in tree[names[0]][g]}
                  for g in tree[names[0]]}

    def to_t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    out = {"embed": to_t(tree["embed"]),
           "layers": {g: {n: to_t(a) for n, a in leaves.items()}
                      for g, leaves in layers.items()},
           "final_norm": {"scale": to_t(tree["final_norm"]["scale"])}}
    shapes = param_shapes(cfg)
    for g, leaves in shapes["layers"].items():
        for n, shape in leaves.items():
            got = tuple(out["layers"][g][n].shape)
            if got != shape:
                raise ValueError(f"layers/{g}/{n}: shape {got}, expected "
                                 f"{shape} for this config")
    return out

"""Transformer LM and its train step — port of
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
one into the module and :meth:`TransformerLM.stacked_params` reads the
parameters (or their gradients, or optimizer moments) back in it.

Training: :func:`next_token_loss` (full logits),
:func:`fused_next_token_loss` (logits one sequence chunk at a time),
:func:`kernel_next_token_loss` (the fused CE kernels),
:func:`make_optimizer` (AdamW with optax's semantics), :func:`make_loss_fn`
and :func:`make_train_step` (the optimizer's step, or the fused AdamW
kernel with ``fused_optimizer=True``). ``remat`` recomputes each block in
the backward. Mesh and MoE belong to later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from distributed_tensorflow_tpu_torch.ops.attention import (
    flash_attention, mha_reference)
from distributed_tensorflow_tpu_torch.ops.fused_adamw import (
    fused_adamw_update)
from distributed_tensorflow_tpu_torch.ops.fused_ce import (
    fused_cross_entropy)

#: matrix products without batch dimensions: the outputs that the
#: "dots" policies save (jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: ``remat_policy`` → ``checkpoint``'s ``context_fn``
REMAT_POLICIES = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots),
}


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
    # remat: each Block under torch.utils.checkpoint while grad is
    # enabled; remat_policy "nothing" saves nothing, "dots" saves the
    # matmul outputs. scan_layers is accepted and numerically neutral:
    # the port always loops over its layers in Python.
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    # None: flash attention (the CUDA kernels on a card, their plain
    # versions on the CPU); "reference": the unfused mha_reference
    attention_impl: str | None = None
    # "kernel": the fused CE kernels (ops/fused_ce.py); "scan": full
    # (B, S, V) logits and next_token_loss with loss_chunks=0, else
    # fused_next_token_loss over loss_chunks sequence chunks, whose
    # backward recomputes ("recompute") or keeps ("save") each chunk's
    # logits
    loss_impl: str = "scan"
    loss_chunks: int = 0
    loss_chunk_policy: str = "recompute"
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    # AdamW first-moment storage dtype (None = the parameters' f32)
    adam_mu_dtype: Any = None
    # one fused_adamw_update over the AdamW state in place of its step
    fused_optimizer: bool = False

    def __post_init__(self):
        # the one place where options are checked
        if self.attention_impl not in (None, "reference"):
            raise ValueError(f"attention_impl={self.attention_impl!r}; "
                             f"expected None or 'reference'")
        if self.loss_impl not in ("scan", "kernel"):
            raise ValueError(f"loss_impl={self.loss_impl!r}; expected "
                             f"'scan' or 'kernel'")
        if self.loss_chunk_policy not in ("recompute", "save"):
            raise ValueError(f"loss_chunk_policy={self.loss_chunk_policy!r}"
                             f"; expected 'recompute' or 'save'")
        if self.remat_policy in ("attn", "dots_attn"):
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} saves the attention "
                f"output by name, which needs the flash call visible to "
                f"selective checkpointing (ROADMAP.md queue A item 2)")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}; expected "
                             f"one of {sorted(REMAT_POLICIES)}")

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
        elif cfg.attention_impl == "reference":
            o = mha_reference(q, k, v, causal=cfg.causal)
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

    def stacked_params(self, of=None) -> dict:
        """The parameters in the port's stacked dict layout (the module
        docstring's), each leaf ``of(parameter)`` stacked over layers:
        the parameters themselves by default, ``lambda p: p.grad`` for
        their gradients, ``lambda p: opt.state[p]["mu"]`` for a moment."""
        of = of or (lambda p: p)
        layers = {}
        for group, leaves in param_shapes(self.cfg)["layers"].items():
            layers[group] = {
                name: torch.stack([of(getattr(getattr(b, group), name))
                                   for b in self.layers])
                for name in leaves}
        return {"embed": of(self.embed), "layers": layers,
                "final_norm": {"scale": of(self.final_norm.scale)}}

    def forward(self, tokens, return_hidden: bool = False, lengths=None):
        """``lengths`` (B,) marks a right-padded mixed-length batch: every
        layer's attention masks padded keys with the factored rule
        (:func:`~distributed_tensorflow_tpu_torch.ops.attention.
        length_valid_mask`); None runs the flash forward."""
        cfg = self.cfg
        dt = cfg.dtype
        emb = self.embed.to(dt)
        x = emb[tokens]
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = checkpoint(block, x, lengths, use_reentrant=False,
                               context_fn=REMAT_POLICIES[cfg.remat_policy])
            else:
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


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def next_token_loss(logits, tokens):
    """Shifted next-token cross-entropy over full f32 logits (ignores the
    final position): ``optax.softmax_cross_entropy_with_integer_labels``
    averaged."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    tl = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tl).mean()


def _chunk_loss(xc, emb, tc, mc):
    """Summed masked CE of one sequence chunk: its ``(B, C, V)`` logits in
    ``emb``'s dtype (one matrix product), then f32."""
    logits = (xc.to(emb.dtype) @ emb.T).float()
    tl = logits.gather(-1, tc.long()[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - tl) * mc).sum()


def fused_next_token_loss(hidden, embed, tokens, *, num_chunks: int,
                          compute_dtype=torch.bfloat16,
                          chunk_policy: str = "recompute"):
    """Chunked next-token CE over the tied embedding (JAX
    ``:459-510``): ``next_token_loss(hidden @ embed.T, tokens)`` without
    the ``(B, S, V)`` f32 logits. Each of ``num_chunks`` sequence chunks
    computes its logits and reduces them to a partial CE sum under
    ``torch.utils.checkpoint``, added in chunk order as JAX's scan carry
    does. ``chunk_policy="recompute"`` keeps nothing of a chunk, so the
    backward recomputes its logits; ``"save"`` keeps the logits in
    ``compute_dtype`` (the output of the chunk's matrix product) and
    recomputes only what follows them."""
    B, S, D = hidden.shape
    if S % num_chunks:
        raise ValueError(f"seq len {S} not divisible by loss "
                         f"num_chunks={num_chunks}")
    if chunk_policy not in ("recompute", "save"):
        raise ValueError(f"chunk_policy={chunk_policy!r}; expected "
                         f"'recompute' or 'save'")
    C = S // num_chunks
    targets, mask = _shifted_targets_and_mask(tokens)
    emb = embed.to(compute_dtype)
    context_fn = REMAT_POLICIES["dots" if chunk_policy == "save"
                                else "nothing"]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, C):
        total = total + checkpoint(
            _chunk_loss, hidden[:, c:c + C], emb, targets[:, c:c + C],
            mask[:, c:c + C], use_reentrant=False, context_fn=context_fn)
    return total / (B * (S - 1))


def _shifted_targets_and_mask(tokens):
    """Next-token shift shared by the fused-loss paths: position t
    predicts token t+1; the final position has no target (pad target 0,
    mask 0), as in ``next_token_loss``."""
    B, S = tokens.shape
    targets = torch.cat([tokens[:, 1:],
                         tokens.new_zeros((B, 1))], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), device=tokens.device),
                      torch.zeros((B, 1), device=tokens.device)], dim=1)
    return targets, mask


def kernel_next_token_loss(hidden, embed, tokens, *,
                           compute_dtype=torch.bfloat16):
    """Shifted next-token CE through the fused CE kernels
    (:func:`~distributed_tensorflow_tpu_torch.ops.fused_ce.
    fused_cross_entropy`): the ``(B, S, V)`` logits never exist. The
    hidden state and the tied embedding are cast to ``compute_dtype``
    first."""
    B, S, D = hidden.shape
    targets, mask = _shifted_targets_and_mask(tokens)
    losses = fused_cross_entropy(
        hidden.reshape(B * S, D).to(compute_dtype),
        embed.to(compute_dtype), targets.reshape(B * S))
    return (losses * mask.reshape(B * S)).sum() / (B * (S - 1))


class AdamW(torch.optim.Optimizer):
    """AdamW with ``optax.adamw``'s semantics, updating in place:

        mu' = b1 mu + (1 − b1) g,   nu' = b2 nu + (1 − b2) g²   (f32)
        u   = (mu' / (1 − b1^t)) / (sqrt(nu' / (1 − b2^t)) + eps) + wd p
        p'  = p − lr u

    ``mu`` is stored in ``mu_dtype`` (None: the parameter's dtype) and
    updated in f32 from its stored value, as optax's ``mu_dtype`` does
    inside a jitted step. As there, the ``b1`` that multiplies the stored
    ``mu`` is rounded to ``mu_dtype`` (optax's Python-float ``b1`` is
    weakly typed and takes the array's dtype: 0.8984375 for bf16), while
    XLA keeps the product in f32. :meth:`fused_step`, which
    :func:`make_train_step` runs in place of :meth:`step` with
    ``fused_optimizer=True``, follows the JAX fused update instead and
    multiplies by an f32 ``b1`` = 0.9, so the two part after one step
    with a bf16 ``mu``; in f32 they agree.
    ``torch.optim.AdamW`` keeps its moments in the parameter's dtype and
    puts the decay in another place, hence this class. Plain tensor
    ops."""

    def __init__(self, params, *, lr: float, weight_decay: float,
                 mu_dtype=None, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      mu_dtype=mu_dtype))

    def moments(self, p, group) -> dict:
        """``p``'s state ``{"count", "mu", "nu"}``, made (count 0, zero
        moments) at first use."""
        st = self.state[p]
        if not st:
            st["count"] = 0
            st["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
            st["nu"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.moments(p, group)
                st["count"] += 1
                t = st["count"]
                g = p.grad.float()
                # optax's b1 is a weakly typed scalar: it takes mu's
                # stored dtype (bf16(0.9) = 0.8984375 for a bf16 mu)
                b1_mu = torch.tensor(b1, dtype=st["mu"].dtype).item()
                mu = (1 - b1) * g + b1_mu * st["mu"].float()
                nu = (1 - b2) * g.square() + b2 * st["nu"].float()
                # bias corrections in f32, as optax computes decay**count
                c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
                c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
                u = (mu / c1.item()) / ((nu / c2.item()).sqrt() + eps)
                p.add_((u + wd * p) * -lr)
                st["mu"] = mu.to(st["mu"].dtype)
                st["nu"] = nu

    def fused_step(self):
        """The update by :func:`~distributed_tensorflow_tpu_torch.ops.
        fused_adamw.fused_adamw_update` over this optimizer's ``mu``,
        ``nu`` and ``count``, in place: one kernel launch per parameter
        tensor on a card, the JAX fused update's numbers (an f32 ``b1``)."""
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.moments(p, group) for p in params]
            b1, b2 = group["betas"]
            *_, count = fused_adamw_update(
                params, [p.grad for p in params],
                [st["mu"] for st in states], [st["nu"] for st in states],
                states[0]["count"], lr=group["lr"], b1=b1, b2=b2,
                eps=group["eps"], weight_decay=group["weight_decay"])
            for st in states:
                st["count"] = count


def make_optimizer(cfg: TransformerConfig, params) -> AdamW:
    """AdamW over ``params`` at ``cfg.learning_rate`` /
    ``cfg.weight_decay`` with ``cfg.adam_mu_dtype`` — the counterpart of
    ``optax.adamw(lr, weight_decay=wd, mu_dtype=...)``."""
    return AdamW(params, lr=cfg.learning_rate,
                 weight_decay=cfg.weight_decay,
                 mu_dtype=cfg.adam_mu_dtype)


def make_loss_fn(cfg: TransformerConfig, model: TransformerLM):
    """``loss_fn(tokens) -> scalar`` for ``cfg``/``model`` (JAX
    ``:580-631``): the fused CE kernels for ``loss_impl="kernel"``;
    :func:`fused_next_token_loss` for ``loss_impl="scan"`` with
    ``loss_chunks > 0``; else full logits and :func:`next_token_loss`."""
    if cfg.loss_chunks > 0:
        scan_chunks = cfg.loss_chunks
    else:
        # JAX's kernel→scan default: the largest power of two that
        # divides the sequence length, capped at 8. Without a mesh the
        # kernel path never falls back, so "scan" takes it only with an
        # explicit count; the rule stays beside it for the sharded step.
        scan_chunks = 1
        while scan_chunks < 8 and cfg.max_seq_len % (scan_chunks * 2) == 0:
            scan_chunks *= 2

    def loss_fn(tokens):
        if cfg.loss_impl == "kernel":
            hidden = model(tokens, return_hidden=True)
            return kernel_next_token_loss(hidden, model.embed, tokens,
                                          compute_dtype=cfg.dtype)
        if cfg.loss_chunks > 0:
            hidden = model(tokens, return_hidden=True)
            return fused_next_token_loss(
                hidden, model.embed, tokens, num_chunks=scan_chunks,
                compute_dtype=cfg.dtype, chunk_policy=cfg.loss_chunk_policy)
        return next_token_loss(model(tokens), tokens)

    return loss_fn


def _check_fused_optimizer(cfg: TransformerConfig, model: TransformerLM,
                           optimizer):
    """Raise unless ``optimizer`` is exactly what ``make_optimizer(cfg,
    model.parameters())`` builds (the JAX step's state-structure check,
    ``:669-677``): the fused update replaces the whole optimizer, so
    anything else would be silently skipped."""
    defaults = dict(lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
                    mu_dtype=cfg.adam_mu_dtype, betas=(0.9, 0.999), eps=1e-8)
    groups = getattr(optimizer, "param_groups", [])
    ok = (type(optimizer) is AdamW and len(groups) == 1
          and all(groups[0][k] == v for k, v in defaults.items())
          and [id(p) for p in groups[0]["params"]]
          == [id(p) for p in model.parameters()])
    if not ok:
        raise ValueError(
            "fused_optimizer=True supports exactly the make_optimizer(cfg, "
            "model.parameters()) AdamW; set fused_optimizer=False or use "
            "make_optimizer(cfg, model.parameters())")


def make_train_step(cfg: TransformerConfig, model: TransformerLM,
                    optimizer: torch.optim.Optimizer):
    """``train_step(state, batch) -> (state, {"loss"})`` with
    ``state = {"model", "optimizer", "step"}`` (``model`` and
    ``optimizer`` as given here) and ``batch = {"tokens": (B, S)}`` — the
    JAX signature. Unlike JAX's pure step it updates the model's
    parameters and the optimizer's moments in place; the returned state
    holds the same objects and ``step + 1``.

    With ``cfg.fused_optimizer`` the step runs :meth:`AdamW.fused_step`
    (the fused AdamW kernel over the optimizer's own state) in place of
    ``optimizer.step()``; the optimizer must be exactly
    ``make_optimizer(cfg, model.parameters())``, else ``ValueError``."""
    loss_fn = make_loss_fn(cfg, model)
    if cfg.fused_optimizer:
        _check_fused_optimizer(cfg, model, optimizer)

    def train_step(state, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch["tokens"])
        loss.backward()
        if cfg.fused_optimizer:
            optimizer.fused_step()
        else:
            optimizer.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach()})

    return train_step

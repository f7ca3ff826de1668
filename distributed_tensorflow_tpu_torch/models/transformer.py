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
kernel with ``fused_optimizer=True``; :func:`train_step_around` builds
the same step around another objective). ``remat`` recomputes each
block in the backward, keeping what ``remat_policy`` names
(:data:`REMAT_POLICIES`).

Data parallelism: :func:`make_sharded_train_step` over a ``dp`` or
``dcn``×``dp`` mesh — the bucketed gradient all-reduce overlapped on
the backward, ``grad_sync="none"`` and ``"gspmd"``, and ZeRO-1/2.

Tensor parallelism: on a mesh with ``tp`` (``("tp",)``, ``("dp",
"tp")``, ``("dcn", "dp", "tp")``) the model holds this rank's shards
of the parameters by JAX's logical-axis rules (:data:`LOGICAL_AXIS_RULES`,
:func:`param_specs`): heads, ``d_ff`` and the vocabulary over ``tp``.
:func:`shard_params` / :func:`gather_params` carry the full dict to a
rank's shards and back. Each block enters its column-parallel weights
through ``tp_copy`` (after the RMSNorm) and leaves its row-parallel
ones through ``tp_reduce``; the embedding lookup is vocab-parallel and
the losses are the vocab-sharded cross-entropies.

Pipeline parallelism: :func:`make_pipelined_train_step` over a ``pp``
or ``dp``×``pp`` mesh — GPipe, 1F1B and interleaved 1F1B
(:mod:`~distributed_tensorflow_tpu_torch.parallel.pipeline`), with the
1F1B stash offloaded to the host on request.

Sequence parallelism: on a mesh with ``sp`` (``{"sp": n}``, with
``dp``/``dcn`` and ``tp``) the model holds a
:class:`~distributed_tensorflow_tpu_torch.parallel.sequence_parallel.
SequenceParallel`: each rank runs its chunk of the sequence, rotary at
global positions, attention the ring (or striped, or Ulysses) over
``sp``, the losses over the chunk with targets from the whole rows.

Mixture-of-experts: ``moe_experts > 0`` replaces every block's MLP with
a :class:`~distributed_tensorflow_tpu_torch.parallel.moe.MoELayer`
(``layers/moe/{router, wi, wo}``), whose aux losses the LM loss adds
(JAX's ``"losses"`` collection). On a mesh with ``ep`` a rank holds
``E/ep`` experts (and the router's ``E/ep`` columns); the tokens are
replicated over ``ep`` (no data axis), routing repeats on every ``ep``
rank and the experts' partial outputs sum over ``ep`` (and ``tp``).

Fully-sharded data parallelism: on a mesh with ``fsdp`` every leaf with
a d_model (``"embed"``) dim is stored ``1/fsdp`` on it, gathered where
it is used (:func:`~distributed_tensorflow_tpu_torch.parallel.
collectives.fsdp_gather`: the Block's projections, ``wi``/``wo``, the
embedding before the lookup and the tied head) and its gradient
reduce-scattered; ``fsdp`` is a data axis, so the batch splits over
``dcn × dp × fsdp``.
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
    FLASH_ATTENTION_OP, flash_attention, mha_reference,
    sharded_flash_attention)
from distributed_tensorflow_tpu_torch.ops.fused_adamw import (
    fused_adamw_update)
from distributed_tensorflow_tpu_torch.ops.fused_ce import (
    fused_cross_entropy, sharded_fused_cross_entropy)
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    fsdp_gather, tp_copy, tp_reduce)
from distributed_tensorflow_tpu_torch.parallel.moe import (
    PARAM_LOGICAL_AXES as _MOE_AXES, ExpertParallel, MoEConfig, MoELayer)
from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
    RING_ATTENTION_OP, SequenceParallel, check_impl, resolve_attn_impl)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel, check_divisible, padded_rows,
    vocab_parallel_cross_entropy, vocab_parallel_embed)
from distributed_tensorflow_tpu_torch.parallel.zero import (
    leaf_metas as _leaf_metas)

#: matrix products without batch dimensions: the outputs that the
#: "dots" policies save (jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _saving(ops):
    """``checkpoint``'s ``context_fn`` for selective checkpointing that
    saves the outputs of ``ops`` and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


#: the registered attention ops whose outputs JAX names ``attn_out``:
#: the flash op and the flash ring (contiguous and striped)
_ATTN = (FLASH_ATTENTION_OP, RING_ATTENTION_OP)

#: ``remat_policy`` → ``checkpoint``'s ``context_fn``. "attn" saves what
#: JAX names ``attn_out`` (``save_only_these_names("attn_out")``): the
#: outputs ``(o, lse)`` of the registered flash op or flash ring, so the
#: backward launches no forward kernel and sends no ring shift again;
#: "dots_attn" saves those and the dots. Under
#: ``attention_impl="reference"`` there is no such op: the ops of
#: ``mha_reference`` are recomputed, with the same numbers; so are the
#: unfused ring's (its shifts sent again) and Ulysses' all-to-alls
#: around the flash op.
REMAT_POLICIES = {
    "nothing": noop_context_fn,
    "dots": _saving(_DOTS),
    "attn": _saving(_ATTN),
    "dots_attn": _saving(_DOTS + _ATTN),
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
    """Every field of JAX's ``TransformerConfig`` (``:78-155``), in its
    order, with its name and default, so that a JAX config's keyword
    arguments build the port's. The port's kernels choose their own
    tiles, so ``attn_block_q``, ``attn_block_k``, ``loss_block_n``,
    ``loss_block_v``, ``loss_kernel_impl`` and ``optimizer_impl`` are
    accepted and ignored; ``mesh`` is accepted, and the port's steps
    take the mesh as an argument. ``moe_experts > 0`` replaces every
    block's MLP with the MoE layer (``moe_top_k``,
    ``moe_capacity_factor``, ``moe_aux_weight``)."""
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    causal: bool = True            # False -> bidirectional encoder (BERT)
    # remat: each Block under torch.utils.checkpoint while grad is
    # enabled; remat_policy "nothing" saves nothing, "dots" the matmul
    # outputs, "attn" the flash attention's outputs, "dots_attn" both
    # (REMAT_POLICIES). scan_layers is accepted and numerically neutral:
    # the port always loops over its layers in Python.
    remat: bool = True
    remat_policy: str = "nothing"
    scan_layers: bool = True
    # None: flash attention (the CUDA kernels on a card, their plain
    # versions on the CPU); "reference": the unfused mha_reference
    attention_impl: str | None = None
    attn_block_q: int = 512
    attn_block_k: int = 1024
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    mesh: Any = None
    # on a mesh with sp > 1 attention is the sequence-parallel ring
    # (parallel/sequence_parallel.py): "ring" | "ulysses" | "striped"
    # (causal); per-block compute "flash" | "unfused" | "interpret" (the
    # flash ring through the plain versions, CPU only), None: "flash" on
    # a CUDA mesh, "unfused" elsewhere
    sp_impl: str = "ring"
    sp_attn_impl: str | None = None
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # "kernel": the fused CE kernels (ops/fused_ce.py); "scan": full
    # (B, S, V) logits and next_token_loss with loss_chunks=0, else
    # fused_next_token_loss over loss_chunks sequence chunks, whose
    # backward recomputes ("recompute") or keeps ("save") each chunk's
    # logits
    loss_chunks: int = 0
    loss_chunk_policy: str = "recompute"
    loss_impl: str = "scan"
    loss_block_n: int = 512
    loss_block_v: int = 1024
    loss_kernel_impl: str | None = None
    # AdamW first-moment storage dtype (None = the parameters' f32)
    adam_mu_dtype: Any = None
    # one fused_adamw_update over the AdamW state in place of its step
    fused_optimizer: bool = False
    optimizer_impl: str | None = None

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
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}; expected "
                             f"one of {sorted(REMAT_POLICIES)}")
        # as make_ring_attention checks them
        check_impl(self.sp_impl)
        if self.sp_attn_impl is not None:
            resolve_attn_impl(self.sp_attn_impl, "cpu")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Test-sized config. Like JAX's ``tiny()`` it takes the unfused
        ``mha_reference``; pass ``attention_impl=None`` for the flash path
        (head dim 16, padded to 64)."""
        defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        d_ff=128, max_seq_len=128, dtype=torch.float32,
                        attention_impl="reference")
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


def rotary_embedding(x, *, base: float = 10000.0, seq_axis: int = -3,
                     offset: int = 0):
    """RoPE with the sequence axis at ``seq_axis`` and head_dim last;
    angles in f32, result in ``x``'s dtype. ``offset`` is the global
    position of ``x``'s first row (a sequence-parallel rank's chunk); the
    positions are exact integers in f32, so a chunk's angles are those
    of its rows of the whole sequence, bit for bit."""
    seq, d = x.shape[seq_axis], x.shape[-1]
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=x.device)
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


def _weight(p, dt, fsdp, dim):
    """``p`` as a layer uses it: cast to ``dt``, or on an ``fsdp`` mesh
    with ``dim`` its sharded dim, gathered whole
    (:func:`~distributed_tensorflow_tpu_torch.parallel.collectives.
    fsdp_gather`)."""
    if fsdp is None or dim is None:
        return p.to(dt)
    return fsdp_gather(p, dt, fsdp.group, dim)


def _parameters(module, shapes: dict, device):
    """One empty parameter a name of ``shapes`` on ``module``."""
    for name, shape in shapes.items():
        setattr(module, name, nn.Parameter(torch.empty(shape,
                                                       device=device)))


class MultiHeadAttention(nn.Module):
    """Rotary MHA; with ``tp`` this rank's ``n_heads / tp`` heads (the
    projections column-parallel, ``out`` row-parallel: the caller
    reduces its partial output); with ``sp`` (a
    :class:`~distributed_tensorflow_tpu_torch.parallel.sequence_parallel.
    SequenceParallel`) the input is this rank's chunk of the sequence,
    rotated at its global positions, and attention is the ring over
    ``sp``; with ``fsdp`` each projection is stored cut along its
    d_model dim and gathered at use. ``shapes``: the local parameter
    shapes, ``fsdp_dims`` each one's ``fsdp`` dim (or None)."""

    def __init__(self, cfg: TransformerConfig, shapes: dict, device=None,
                 tp: TensorParallel | None = None,
                 sp: SequenceParallel | None = None,
                 fsdp: TensorParallel | None = None, fsdp_dims=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.sp = sp
        self.fsdp, self.fsdp_dims = fsdp, fsdp_dims or {}
        _parameters(self, shapes, device)

    def _w(self, name):
        return _weight(getattr(self, name), self.cfg.dtype, self.fsdp,
                       self.fsdp_dims.get(name))

    def forward(self, x, lengths=None):
        cfg, sp = self.cfg, self.sp
        offset = sp.index * x.shape[1] if sp is not None else 0
        q = rotary_embedding(project_heads(x, self._w("query")), seq_axis=-2,
                             offset=offset)
        k = rotary_embedding(project_heads(x, self._w("key")), seq_axis=-2,
                             offset=offset)
        v = project_heads(x, self._w("value"))
        # JAX's order (:255-292): lengths, then the ring on an sp mesh
        # (under attention_impl="reference" too), then the rest
        if lengths is not None:
            # right-padded mixed-length batch: the factored length mask
            # (the flash kernel takes no per-row length)
            o = mha_reference(q, k, v, causal=cfg.causal, lengths=lengths)
        elif sp is not None:
            o = sp.attn(q, k, v)
        elif cfg.attention_impl == "reference":
            o = mha_reference(q, k, v, causal=cfg.causal)
        elif self.tp is not None:
            o = sharded_flash_attention(q, k, v, self.tp.mesh,
                                        n_heads=cfg.n_heads,
                                        causal=cfg.causal)
        else:
            o = flash_attention(q, k, v, causal=cfg.causal)
        return merge_heads(o, self._w("out"))


class MLP(nn.Module):
    """SwiGLU feed-forward; with ``tp`` this rank's ``d_ff / tp`` hidden
    units: ``wi`` holds its columns of ``gate`` and then its columns of
    ``up`` (:func:`shard_params`), so ``silu(gate) · up`` stays local;
    with ``fsdp`` ``wi``/``wo`` gathered at use."""

    def __init__(self, cfg: TransformerConfig, shapes: dict, device=None,
                 fsdp: TensorParallel | None = None, fsdp_dims=None):
        super().__init__()
        self.cfg = cfg
        self.fsdp, self.fsdp_dims = fsdp, fsdp_dims or {}
        _parameters(self, shapes, device)

    def forward(self, x):
        dt = self.cfg.dtype
        return swiglu(x, *(_weight(getattr(self, n), dt, self.fsdp,
                                   self.fsdp_dims.get(n))
                           for n in ("wi", "wo")))


def moe_config(cfg: TransformerConfig) -> MoEConfig:
    """The MoE layer's config of a transformer config (JAX ``:369``)."""
    return MoEConfig(num_experts=cfg.moe_experts, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, capacity_factor=cfg.moe_capacity_factor,
                     top_k=cfg.moe_top_k, aux_loss_weight=cfg.moe_aux_weight,
                     dtype=cfg.dtype)


class Block(nn.Module):
    """Pre-norm block. With ``tp`` each branch enters through
    ``tp_copy`` placed after its RMSNorm (so the replicated norm scales
    get the whole gradient on every rank) and leaves through
    ``tp_reduce``. With ``cfg.moe_experts > 0`` the MLP is the MoE layer
    (``moe``, an :class:`~distributed_tensorflow_tpu_torch.parallel.moe.
    ExpertParallel` on a mesh; it places its own boundaries) and the
    block returns ``(x, aux)``."""

    def __init__(self, cfg: TransformerConfig, shapes: dict, fsdp_dims: dict,
                 device=None, tp: TensorParallel | None = None,
                 sp: SequenceParallel | None = None,
                 fsdp: TensorParallel | None = None,
                 moe: ExpertParallel | None = None):
        super().__init__()
        self.tp = tp
        self.RMSNorm_0 = RMSNorm(cfg.d_model, cfg.dtype, device)
        self.attn = MultiHeadAttention(cfg, shapes["attn"], device, tp, sp,
                                       fsdp, fsdp_dims.get("attn"))
        self.RMSNorm_1 = RMSNorm(cfg.d_model, cfg.dtype, device)
        if cfg.moe_experts > 0:
            self.moe = MoELayer(moe_config(cfg), {
                n: torch.empty(s, device=device)
                for n, s in shapes["moe"].items()}, group=moe, device=device)
        else:
            self.mlp = MLP(cfg, shapes["mlp"], device, fsdp,
                           fsdp_dims.get("mlp"))

    @staticmethod
    def flax_output(out):
        """The block's output as flax's ``Block`` returns it, ``(x,
        None)`` (its scan carry; MoE sows its aux): what
        ``utils/tensor_tracer.trace_flax`` names."""
        return (out[0] if isinstance(out, tuple) else out, None)

    def forward(self, x, lengths=None):
        if self.tp is None:
            x = x + self.attn(self.RMSNorm_0(x), lengths)
        else:
            g = self.tp.group
            x = x + tp_reduce(self.attn(tp_copy(self.RMSNorm_0(x), g),
                                        lengths), g)
        if hasattr(self, "moe"):
            out, aux = self.moe(self.RMSNorm_1(x))
            return x + out, aux
        if self.tp is None:
            return x + self.mlp(self.RMSNorm_1(x))
        g = self.tp.group
        return x + tp_reduce(self.mlp(tp_copy(self.RMSNorm_1(x), g)), g)


def run_blocks(cfg: TransformerConfig, blocks, x, lengths=None):
    """``blocks`` in turn on ``x``; each under ``torch.utils.checkpoint``
    with ``cfg.remat_policy`` when ``cfg.remat`` and autograd is on
    (JAX's ``nn.remat`` of a block, and the pipeline's ``stage_fn``).
    With ``cfg.moe_experts > 0`` returns ``(x, aux)``, the blocks' aux
    losses summed (an output of each checkpoint, so every policy keeps
    it)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for block in blocks:
        if remat:
            x = checkpoint(block, x, lengths, use_reentrant=False,
                           context_fn=REMAT_POLICIES[cfg.remat_policy])
        else:
            x = block(x, lengths)
        if cfg.moe_experts > 0:
            x, a = x
            aux = a if aux is None else aux + a
    return x if cfg.moe_experts == 0 else (x, aux)


class TransformerLM(nn.Module):
    """Decoder-only LM (``cfg.causal=True``) or bidirectional encoder.

    ``params`` (the port's parameter dict) is loaded when given; else
    the module is initialised by :func:`init_params` from
    ``generator``. With ``tp``, ``fsdp`` (:class:`~distributed_
    tensorflow_tpu_torch.parallel.tensor_parallel.TensorParallel`
    handles of those dims) or ``moe`` (an :class:`~distributed_
    tensorflow_tpu_torch.parallel.moe.ExpertParallel`, with ``ep``) the
    module holds this rank's shards: ``params`` is then this rank's
    shard dict (:func:`shard_params`), and a fresh init makes the full
    parameters and keeps the shard. With ``sp`` (a :class:`~distributed_
    tensorflow_tpu_torch.parallel.sequence_parallel.SequenceParallel`)
    the module takes this rank's chunk of the sequence (the parameters
    are replicated over ``sp``)."""

    def __init__(self, cfg: TransformerConfig, params=None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 tp: TensorParallel | None = None,
                 sp: SequenceParallel | None = None,
                 fsdp: TensorParallel | None = None,
                 moe: ExpertParallel | None = None):
        super().__init__()
        device = resolve_device(device)
        coords = {a: (h.rank, h.size) for a, h in
                  (("tp", tp), ("fsdp", fsdp),
                   ("ep", moe.ep if moe is not None else None))
                  if h is not None}
        sizes = {a: n for a, (_, n) in coords.items()}
        check_shardable(cfg, sizes)
        self.cfg = cfg
        self.tp = tp
        self.sp = sp
        self.fsdp = fsdp
        shapes = local_param_shapes(cfg, sizes)
        specs = param_specs(cfg, sizes)
        dims = _fsdp_dims(specs)
        self.embed = nn.Parameter(torch.empty(shapes["embed"],
                                              device=device))
        layer_shapes = {g: {n: s[1:] for n, s in leaves.items()}
                        for g, leaves in shapes["layers"].items()}
        self.layers = nn.ModuleList(
            Block(cfg, layer_shapes, dims["layers"], device, tp, sp, fsdp,
                  moe) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, device)
        if params is None:
            params = init_params(cfg, generator, device)
            if sizes:
                params = shard_params_at(
                    cfg, params, {a: r for a, (r, _) in coords.items()},
                    sizes)
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

    def embed_weight(self) -> torch.Tensor:
        """The tied embedding as the lookup and the head use it: the
        parameter, or on an ``fsdp`` mesh its shard gathered along D in
        ``cfg.dtype`` (one gather a use: the lookup's and the loss's)."""
        if self.fsdp is None:
            return self.embed
        return fsdp_gather(self.embed, self.cfg.dtype, self.fsdp.group, 1)

    def forward(self, tokens, return_hidden: bool = False, lengths=None,
                return_aux: bool = False):
        """``lengths`` (B,) marks a right-padded mixed-length batch: every
        layer's attention masks padded keys with the factored rule
        (:func:`~distributed_tensorflow_tpu_torch.ops.attention.
        length_valid_mask`); None runs the flash forward. With ``tp`` the
        logits are this rank's vocab columns ``(B, S, V/tp)``, for the
        vocab-parallel losses. ``return_aux`` (a MoE config): ``(out,
        aux)``, the layers' aux losses summed."""
        cfg = self.cfg
        dt = cfg.dtype
        emb = self.embed_weight().to(dt)
        tp = self.tp
        x = vocab_parallel_embed(emb, tokens, tp) if tp else emb[tokens]
        x = run_blocks(cfg, self.layers, x, lengths)
        aux = None
        if cfg.moe_experts > 0:
            x, aux = x
        x = self.final_norm(x)
        if not return_hidden:
            if tp is not None:
                x = tp_copy(x, tp.group)
            x = (x @ emb.T).float()
        return (x, aux) if return_aux else x


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> dict:
    """Shapes of the port's stacked parameter dict; with
    ``cfg.moe_experts > 0`` the layers' ``mlp`` group is ``moe``:
    ``router (L, D, E)``, ``wi (L, E, D, F)``, ``wo (L, E, F, D)``."""
    L, V, D, H, hd, Fd = (cfg.n_layers, cfg.vocab_size, cfg.d_model,
                          cfg.n_heads, cfg.head_dim, cfg.d_ff)
    E = cfg.moe_experts
    layers = {
        "RMSNorm_0": {"scale": (L, D)},
        "attn": {"query": (L, D, H, hd), "key": (L, D, H, hd),
                 "value": (L, D, H, hd), "out": (L, H, hd, D)},
        "RMSNorm_1": {"scale": (L, D)},
    }
    if E > 0:
        layers["moe"] = {"router": (L, D, E), "wi": (L, E, D, Fd),
                         "wo": (L, E, Fd, D)}
    else:
        layers["mlp"] = {"wi": (L, D, 2 * Fd), "wo": (L, Fd, D)}
    return {"embed": (V, D), "layers": layers, "final_norm": {"scale": (D,)}}


#: logical axis name → mesh axes (JAX ``:62-75``); "batch" and "seq"
#: name activation dims, the rest parameter dims
LOGICAL_AXIS_RULES = (
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("layers", None),
    ("norm", None),
    ("expert", "ep"),
    ("expert_mlp", "tp"),
    ("expert_embed", None),
)

#: each leaf's logical axes, as the flax model's ``param_with_axes``
#: names them (stacked leaves lead with "layers"), for a dense config
#: (:func:`param_logical_axes` for any)
PARAM_LOGICAL_AXES = {
    "embed": ("vocab", "embed"),
    "layers": {
        "RMSNorm_0": {"scale": ("layers", "norm")},
        "attn": {"query": ("layers", "embed", "heads", "kv"),
                 "key": ("layers", "embed", "heads", "kv"),
                 "value": ("layers", "embed", "heads", "kv"),
                 "out": ("layers", "heads", "kv", "embed")},
        "RMSNorm_1": {"scale": ("layers", "norm")},
        "mlp": {"wi": ("layers", "embed", "mlp"),
                "wo": ("layers", "mlp", "embed")},
    },
    "final_norm": {"scale": ("norm",)},
}


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """:data:`PARAM_LOGICAL_AXES` of ``cfg``'s leaves: with MoE the
    ``moe`` group's axes (``parallel/moe.py``) in place of ``mlp``'s."""
    if cfg.moe_experts == 0:
        return PARAM_LOGICAL_AXES
    layers = {g: v for g, v in PARAM_LOGICAL_AXES["layers"].items()
              if g != "mlp"}
    layers["moe"] = {n: ("layers",) + axes for n, axes in _MOE_AXES.items()}
    return {**PARAM_LOGICAL_AXES, "layers": layers}


def mesh_axis_rules(mesh, rules=LOGICAL_AXIS_RULES) -> list:
    """The rules restricted to the axes ``mesh`` has (JAX ``:705``):
    ``mesh`` a ``DeviceMesh`` or a ``{name: size}`` mapping."""
    from distributed_tensorflow_tpu_torch.cluster.topology import mesh_shape
    shape = mesh_shape(mesh)
    out = []
    for logical, target in rules:
        if target is None:
            out.append((logical, None))
        elif isinstance(target, tuple):
            kept = tuple(a for a in target if a in shape)
            out.append((logical, kept if kept else None))
        else:
            out.append((logical, target if target in shape else None))
    return out


def param_specs(cfg: TransformerConfig, mesh) -> dict:
    """Each leaf of the port's stacked parameter dict → the mesh axis
    (or None) of each of its dims, a tuple like JAX's ``PartitionSpec``:
    ``tuple(ns.spec)`` of ``state_shardings_for(...)["params"]`` (JAX
    ``:735``). A mesh axis already used by an earlier dim of the leaf
    leaves a later dim unsharded."""
    rules = dict(mesh_axis_rules(mesh))

    def spec(axes):
        used, out = set(), []
        for logical in axes:
            target = rules.get(logical)
            names = (() if target is None else
                     (target,) if isinstance(target, str) else target)
            if not names or used & set(names):
                out.append(None)
                continue
            used |= set(names)
            out.append(target)
        return tuple(out)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return spec(node)

    return walk(param_logical_axes(cfg))


#: the mesh axes that cut parameters, in the order they are applied
_SHARD_AXES = ("tp", "fsdp", "ep")


def check_shardable(cfg: TransformerConfig, sizes: dict):
    """Raise ``ValueError`` naming the dim a mesh of ``sizes`` does not
    divide: ``n_heads`` or ``d_ff`` by ``tp``
    (:func:`~distributed_tensorflow_tpu_torch.parallel.tensor_parallel.
    check_divisible`), ``d_model`` by ``fsdp``, ``moe_experts`` by
    ``ep``. (The JAX package pads there; the port cuts equal blocks.)
    ``vocab_size`` is padded to a multiple of ``tp`` instead
    (:func:`local_param_shapes`)."""
    if "tp" in sizes:
        check_divisible(cfg, sizes["tp"])
    for axis, name in (("fsdp", "d_model"), ("ep", "moe_experts")):
        n = sizes.get(axis, 1)
        value = getattr(cfg, name)
        if value % n:
            raise ValueError(f"{name}={value} is not divisible by "
                             f"{axis}={n}; the port cuts it into equal "
                             f"blocks over {axis}")


def local_param_shapes(cfg: TransformerConfig, sizes: dict) -> dict:
    """The shapes of a rank's shard dict on a mesh of ``sizes``
    (``{axis: size}``): each dim :func:`param_specs` cuts, divided by its
    axis' size (JAX's ``_local_shape``); the vocabulary rounded up to a
    multiple of ``tp`` first (:func:`~distributed_tensorflow_tpu_torch.
    parallel.tensor_parallel.padded_rows`), its pad rows zero."""
    def local(shape, spec):
        return tuple(padded_rows(n, sizes[a]) // sizes[a] if a in sizes
                     else n for n, a in zip(shape, spec))
    return _map_leaves(lambda path, shape, spec: local(shape, spec),
                       param_shapes(cfg), param_specs(cfg, sizes))


def _fsdp_dims(specs: dict) -> dict:
    """Each leaf's ``fsdp`` dim of one layer's (or the embedding's)
    tensor, None where it is not cut over ``fsdp``."""
    def dim(path, spec):
        if "fsdp" not in spec:
            return None
        return spec.index("fsdp") - (path[0] == "layers")
    return _map_leaves(dim, specs)


def _map_leaves(fn, *trees, path=()):
    """``fn(path, *leaves)`` over dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees), path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def _is_wi_split(path, axis) -> bool:
    """The dense ``wi`` (D, 2F) cut over ``tp``: gate and up halves cut
    separately (:func:`shard_params_at`)."""
    return axis == "tp" and tuple(path[-2:]) == ("mlp", "wi")


def _coords(rank, size) -> tuple:
    if isinstance(size, int):
        return {"tp": rank}, {"tp": size}
    return dict(rank), dict(size)


def shard_params_at(cfg: TransformerConfig, params, rank, size) -> dict:
    """Shard ``rank`` of ``size`` of the full parameter dict: ``rank`` and
    ``size`` ints (this rank's index along ``tp`` and its size) or
    ``{axis: index}`` / ``{axis: size}`` over ``tp``, ``fsdp`` and
    ``ep`` (:func:`param_specs`). Each cut leaf takes its index's
    contiguous block of each dim an axis cuts, a contiguous tensor of
    its own. ``wi`` (D, 2F) is the exception on ``tp``: GSPMD would cut
    its 2F axis contiguously (all of ``gate`` on the first ranks), so
    rank r takes ``gate[:, rF/tp:(r+1)F/tp]`` and ``up[:,
    rF/tp:(r+1)F/tp]`` side by side, and ``silu(gate) · up`` needs no
    exchange. The numbers are JAX's; only the placement of the columns
    differs. A vocabulary that ``tp`` does not divide gets zero rows up
    to :func:`~distributed_tensorflow_tpu_torch.parallel.tensor_parallel.
    padded_rows` before it is cut (GSPMD's padding; no id looks them
    up, and the losses mask their logits)."""
    coords, sizes = _coords(rank, size)
    check_shardable(cfg, sizes)
    specs = param_specs(cfg, sizes)
    return _map_leaves(
        lambda path, full, spec: _shard_leaf(path, full, spec, coords, sizes),
        params, specs)


def _shard_leaf(path, full, spec, coords: dict, sizes: dict) -> torch.Tensor:
    """One leaf's block of :func:`shard_params_at`."""
    t = full
    for axis in _SHARD_AXES:
        if axis not in spec:
            continue
        dim, n, r = spec.index(axis), sizes[axis], coords[axis]
        if _is_wi_split(path, axis):
            gate, up = t.chunk(2, dim)
            t = torch.cat([gate.chunk(n, dim)[r], up.chunk(n, dim)[r]], dim)
        else:
            t = _pad_dim(t, dim, padded_rows(t.shape[dim], n))
            t = t.chunk(n, dim)[r]
    return t.clone(memory_format=torch.contiguous_format)


def _pad_dim(t: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """``t`` with zeros appended along ``dim`` up to ``rows``."""
    if t.shape[dim] == rows:
        return t
    shape = list(t.shape)
    shape[dim] = rows - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim)


def _trim(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` cut back to the full leaf's ``shape`` (a padded vocabulary's
    pad rows dropped)."""
    return t[tuple(slice(0, n) for n in shape)]


def unshard_params(cfg: TransformerConfig, shards: list,
                   shape: dict | None = None) -> dict:
    """The full parameter dict from every rank's shard dict — the inverse
    of :func:`shard_params_at`, bitwise. ``shape`` (``{axis: size}``,
    outermost first; default ``{"tp": len(shards)}``) orders ``shards``
    row-major over its axes, as a mesh's ranks."""
    shape = {"tp": len(shards)} if shape is None else dict(shape)
    specs = param_specs(cfg, shape)
    names = list(shape)

    def unshard(path, full, spec, *parts):
        parts = list(parts)
        for axis in reversed(names):        # innermost first
            n = shape[axis]
            parts = [_join(path, spec, axis, parts[i:i + n])
                     for i in range(0, len(parts), n)]
        return _trim(parts[0], full).clone()

    return _map_leaves(unshard, param_shapes(cfg), specs, *shards)


def _join(path, spec, axis, parts):
    """One leaf's blocks along ``axis`` made whole (the first where the
    axis does not cut it)."""
    if axis not in spec:
        return parts[0]
    dim = spec.index(axis)
    if _is_wi_split(path, axis):
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim)
    return torch.cat(parts, dim)


def _mesh_coords(mesh) -> tuple:
    """``({axis: index}, {axis: size})`` of this rank over the axes of
    ``mesh`` that cut parameters."""
    from distributed_tensorflow_tpu_torch.cluster import topology as t
    of = {"tp": (t.tp_index, t.tp_size), "fsdp": (t.fsdp_index, t.fsdp_size),
          "ep": (t.ep_index, t.ep_size)}
    axes = [a for a in _SHARD_AXES if a in _shape(mesh)]
    return ({a: of[a][0](mesh) for a in axes},
            {a: of[a][1](mesh) for a in axes})


def shard_params(cfg: TransformerConfig, params, mesh) -> dict:
    """This rank's shard dict of the full ``params`` on ``mesh``
    (:func:`shard_params_at` at its ``tp``, ``fsdp`` and ``ep`` indices;
    a copy without them)."""
    return shard_params_at(cfg, params, *_mesh_coords(mesh))


def gather_params(cfg: TransformerConfig, shards, mesh) -> dict:
    """The full parameter dict on every rank from each rank's
    ``shards`` (:func:`shard_params`): each cut dim all-gathered over
    its axis (``wi``'s halves rejoined as :func:`unshard_params` does),
    a padded vocabulary cut back to ``vocab_size`` rows: JAX's shapes."""
    _, sizes = _mesh_coords(mesh)
    specs = param_specs(cfg, mesh)
    return _map_leaves(
        lambda path, t, spec, full: _gather_leaf(path, t, spec, full, mesh,
                                                 sizes),
        shards, specs, param_shapes(cfg))


def _gather_leaf(path, t, spec, full, mesh, sizes: dict) -> torch.Tensor:
    """One leaf of :func:`gather_params` (collective over ``sizes``'
    axes)."""
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        all_gather)
    t = t.detach()
    for axis in sizes:
        if axis not in spec:
            continue
        parts = all_gather(t.contiguous(), mesh, axis, tiled=False)
        t = _join(path, spec, axis, list(parts.unbind(0)))
    return _trim(t, full).clone(memory_format=torch.contiguous_format)


def train_state_variables(cfg: TransformerConfig, state, mesh=None) -> dict:
    """The train state ``{"model", "optimizer", ...}`` of
    :func:`make_train_step` or :func:`make_sharded_train_step` as
    :class:`~distributed_tensorflow_tpu_torch.parallel.values.
    DistributedVariable` s for a :class:`~distributed_tensorflow_tpu_torch.
    checkpoint.checkpoint.Checkpoint`: ``{"params": ..., "opt_state":
    {"count", "mu": ..., "nu": ...}}``, each tree at the leaf paths of
    :func:`jax_params_layout` (a layer stack with ``scan_layers=True``,
    ``layer_<i>`` otherwise), so ``Checkpoint(**train_state_variables(
    ...))`` is a ``Checkpoint(params=...)`` the serving engine restores.
    Each leaf reads the module's parameters or AdamW moments (stacked
    over layers for a stack), and its global value is the full leaf
    (:func:`gather_params`' per leaf on a mesh that cuts parameters:
    ``mesh`` is the step's); an ``assign`` writes this rank's shard back
    (:func:`shard_params_at`'s block) in place. So a checkpoint of it
    restores onto any mesh. The moments are made (zero, count 0) where
    the optimizer has none yet."""
    from distributed_tensorflow_tpu_torch.parallel.values import (
        DistributedVariable)
    model, opt = state["model"], state["optimizer"]
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    coords, sizes = _mesh_coords(mesh) if mesh is not None else ({}, {})
    specs = param_specs(cfg, sizes) if sizes else None
    shapes = param_shapes(cfg)
    # path -> (its parameters, stacked over layers, "layer" where its spec
    # and shape are one layer of the stacked leaf's)
    leaves = {("embed",): ([model.embed], False, "leaf"),
              ("final_norm", "scale"): ([model.final_norm.scale], False,
                                        "leaf")}
    for g, names in shapes["layers"].items():
        for n in names:
            ps = [getattr(getattr(b, g), n) for b in model.layers]
            if cfg.scan_layers:
                leaves[("layers", g, n)] = (ps, True, "stack")
            else:
                for i, p in enumerate(ps):
                    leaves[(f"layer_{i}", g, n)] = ([p], False, "layer")
    for ps, _, _ in leaves.values():
        for p in ps:
            opt.moments(p, group_of[id(p)])

    def leaf_of(tree, path, kind):
        if kind == "layer":                 # one layer of the stack
            return tree["layers"][path[1]][path[2]][1:]
        node = tree
        for k in path:
            node = node[k]
        return node

    def variable(path, ps, stacked, kind, of):
        def read():
            ts = [of(p) for p in ps]
            return torch.stack(ts) if stacked else ts[0]

        @torch.no_grad()
        def write(block):
            for i, p in enumerate(ps):
                of(p).copy_(block[i] if stacked else block)

        name = "/".join(path)
        if specs is None:
            return DistributedVariable(read=read, write=write, name=name)
        spec, full = leaf_of(specs, path, kind), leaf_of(shapes, path, kind)
        return DistributedVariable(
            read=read, write=write, name=name, mesh=mesh, spec=spec,
            shape=full,
            gather=lambda t: _gather_leaf(path, t, spec, full, mesh, sizes),
            scatter=lambda t: _shard_leaf(path, t, spec, coords, sizes))

    def tree(of):
        out: dict = {}
        for path, (ps, stacked, kind) in leaves.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = variable(path, ps, stacked, kind, of)
        return out

    first = model.embed

    def read_count():
        return torch.tensor(opt.state[first]["count"], dtype=torch.int64)

    def write_count(t):
        for ps, _, _ in leaves.values():
            for p in ps:
                opt.state[p]["count"] = int(t)

    return {"params": tree(lambda p: p),
            "opt_state": {
                "count": DistributedVariable(read=read_count,
                                             write=write_count,
                                             name="count"),
                "mu": tree(lambda p: opt.state[p]["mu"]),
                "nu": tree(lambda p: opt.state[p]["nu"])}}


def init_params(cfg: TransformerConfig,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Fresh f32 parameters with the flax model's init distributions:
    embed N(0, 0.02), query/key/value/out and ``wi`` N(0, D^-1/2),
    ``wo`` N(0, F^-1/2), norm scales 1; the MoE ``router`` N(0, 0.02),
    its ``wi``/``wo`` as the MLP's. ``generator`` must live on
    ``device`` (a CPU generator for ``device="cpu"``); the numbers
    differ from ``jax.random``'s for the same seed."""
    device = resolve_device(device)
    D, Fd = cfg.d_model, cfg.d_ff
    std = {"embed": 0.02, "query": D ** -0.5, "key": D ** -0.5,
           "value": D ** -0.5, "out": D ** -0.5, "wi": D ** -0.5,
           "wo": Fd ** -0.5, "router": 0.02}

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


def jax_params_layout(cfg: TransformerConfig, params) -> dict:
    """The checkpoint name map between the two packages' parameter
    trees: the port's stacked dict (``embed``, ``layers/<group>/<leaf>``,
    ``final_norm/scale`` — the flax names) laid out as the flax
    ``TransformerLM`` tree of ``cfg``: itself with ``scan_layers=True``,
    its layers unstacked as ``layer_<i>`` otherwise. A
    ``Checkpoint(params=jax_params_layout(cfg, params))`` has JAX's leaf
    paths; :func:`params_from_jax` maps them back."""
    if cfg.scan_layers:
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    for i in range(cfg.n_layers):
        out[f"layer_{i}"] = {g: {n: t[i] for n, t in leaves.items()}
                             for g, leaves in params["layers"].items()}
    return out


def params_template(cfg: TransformerConfig) -> dict:
    """Placeholders at the leaf paths of :func:`jax_params_layout` (a
    restore template: a plain leaf's restore is name-driven)."""
    groups = param_shapes(cfg)["layers"]
    layer = {g: {n: np.zeros(0, np.float32) for n in names}
             for g, names in groups.items()}
    out = {"embed": np.zeros(0, np.float32),
           "final_norm": {"scale": np.zeros(0, np.float32)}}
    if cfg.scan_layers:
        out["layers"] = layer
    else:
        for i in range(cfg.n_layers):
            out[f"layer_{i}"] = {g: dict(v) for g, v in layer.items()}
    return out


def params_from_flat(cfg: TransformerConfig, flat: dict, prefix: str,
                     device="cuda") -> dict:
    """The port's parameter dict from a checkpoint restore's flat
    ``{"<prefix>/<path>": value}`` mapping (either package's leaves,
    numpy arrays or bf16 tensors): nested, then :func:`params_from_jax`'s
    layout, as tensors on ``device``."""
    device = resolve_device(device)
    tree: dict = {}
    pre = prefix + "/"
    for key, val in flat.items():
        if not key.startswith(pre):
            continue
        node = tree
        parts = key[len(pre):].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = torch.as_tensor(val)
    if "layers" not in tree:
        names = [f"layer_{i}" for i in range(cfg.n_layers)]
        missing = [n for n in names if n not in tree]
        if missing:
            raise ValueError(f"params have neither 'layers' nor {missing}")
        tree["layers"] = {g: {n: torch.stack([tree[ln][g][n]
                                               for ln in names])
                              for n in tree[names[0]][g]}
                          for g in tree[names[0]]}
        for ln in names:
            del tree[ln]
    out = _map_leaves(lambda path, t: t.to(device), tree)
    for g, leaves in param_shapes(cfg)["layers"].items():
        for n, shape in leaves.items():
            got = tuple(out["layers"][g][n].shape)
            if got != shape:
                raise ValueError(f"layers/{g}/{n}: shape {got}, expected "
                                 f"{shape} for this config")
    return out


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, targets, tp=None, vocab=None):
    """Per-position CE of f32 ``logits`` ``(..., V)`` against integer
    ``targets`` (``optax.softmax_cross_entropy_with_integer_labels``);
    with ``tp`` the logits are this rank's vocab columns and the CE is
    :func:`~distributed_tensorflow_tpu_torch.parallel.tensor_parallel.
    vocab_parallel_cross_entropy` (``vocab``: the true vocabulary, whose
    pad columns it masks)."""
    if tp is not None:
        return vocab_parallel_cross_entropy(logits, targets, tp, vocab)
    logits = logits.float()
    tl = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - tl


def next_token_loss(logits, tokens, tp=None, cols=None, vocab=None):
    """Shifted next-token cross-entropy over full f32 logits (ignores the
    final position), averaged; ``tp``: vocab-sharded logits
    (:func:`softmax_cross_entropy`). ``cols``: the logits are those of
    the positions ``cols`` of ``tokens``' rows (a sequence-parallel
    rank's chunk), whose targets come from the whole rows; the result is
    the chunk's share of the rows' mean (the chunks' results sum to
    it). ``vocab``: the true vocabulary of padded ``tp`` logits."""
    if cols is None:
        return softmax_cross_entropy(logits[:, :-1].float(), tokens[:, 1:],
                                     tp, vocab).mean()
    B, S = tokens.shape
    targets, mask = _shifted_targets_and_mask(tokens, cols)
    return ((softmax_cross_entropy(logits.float(), targets, tp, vocab)
             * mask).sum() / (B * (S - 1)))


def _chunk_loss(xc, emb, tc, mc, tp=None, vocab=None):
    """Summed masked CE of one sequence chunk: its ``(B, C, V)`` logits in
    ``emb``'s dtype (one matrix product), then f32; with ``tp`` this
    rank's vocab columns of them, the chunk entering through
    ``tp_copy``."""
    xc = xc.to(emb.dtype)
    if tp is not None:
        xc = tp_copy(xc, tp.group)
    return (softmax_cross_entropy((xc @ emb.T).float(), tc, tp, vocab)
            * mc).sum()


def fused_next_token_loss(hidden, embed, tokens, *, num_chunks: int,
                          compute_dtype=torch.bfloat16,
                          chunk_policy: str = "recompute", tp=None,
                          cols=None, vocab=None):
    """Chunked next-token CE over the tied embedding (JAX
    ``:459-510``): ``next_token_loss(hidden @ embed.T, tokens)`` without
    the ``(B, S, V)`` f32 logits. Each of ``num_chunks`` sequence chunks
    computes its logits and reduces them to a partial CE sum under
    ``torch.utils.checkpoint``, added in chunk order as JAX's scan carry
    does. ``chunk_policy="recompute"`` keeps nothing of a chunk, so the
    backward recomputes its logits; ``"save"`` keeps the logits in
    ``compute_dtype`` (the output of the chunk's matrix product) and
    recomputes only what follows them. ``tp``: ``embed`` is this rank's
    vocab shard (``vocab`` the true vocabulary when it is padded).
    ``cols``: ``hidden`` holds the positions ``cols`` of ``tokens``'
    rows, as in :func:`next_token_loss`; the chunks then cut those
    positions."""
    B, S = tokens.shape
    Sh = hidden.shape[1]
    if Sh % num_chunks:
        raise ValueError(f"seq len {Sh} not divisible by loss "
                         f"num_chunks={num_chunks}")
    if chunk_policy not in ("recompute", "save"):
        raise ValueError(f"chunk_policy={chunk_policy!r}; expected "
                         f"'recompute' or 'save'")
    C = Sh // num_chunks
    targets, mask = _shifted_targets_and_mask(tokens, cols)
    emb = embed.to(compute_dtype)
    context_fn = REMAT_POLICIES["dots" if chunk_policy == "save"
                                else "nothing"]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, Sh, C):
        total = total + checkpoint(
            _chunk_loss, hidden[:, c:c + C], emb, targets[:, c:c + C],
            mask[:, c:c + C], tp, vocab, use_reentrant=False,
            context_fn=context_fn)
    return total / (B * (S - 1))


def _shifted_targets_and_mask(tokens, cols=None):
    """Next-token shift shared by the fused-loss paths: position t
    predicts token t+1; the final position has no target (pad target 0,
    mask 0), as in ``next_token_loss``. ``cols`` keeps those positions
    of the whole rows' shift: a sequence-parallel rank's last position
    targets the next rank's first token, and only the sequence's last
    position is masked (JAX ``:513``, where GSPMD moves the halo)."""
    B, S = tokens.shape
    targets = torch.cat([tokens[:, 1:],
                         tokens.new_zeros((B, 1))], dim=1)
    mask = torch.cat([torch.ones((B, S - 1), device=tokens.device),
                      torch.zeros((B, 1), device=tokens.device)], dim=1)
    if cols is not None:
        targets, mask = targets[:, cols], mask[:, cols]
    return targets, mask


def fused_ce_losses(hidden, embed, targets, *, compute_dtype, tp=None):
    """Per-token CE ``(N,)`` of ``hidden`` ``(..., D)`` against the tied
    ``embed`` through the fused CE kernels, both cast to
    ``compute_dtype``: :func:`~distributed_tensorflow_tpu_torch.ops.
    fused_ce.fused_cross_entropy`, or with ``tp`` (``embed`` this rank's
    vocab shard) :func:`~distributed_tensorflow_tpu_torch.ops.fused_ce.
    sharded_fused_cross_entropy`, which reduces dh over tp itself."""
    h = hidden.reshape(-1, hidden.shape[-1]).to(compute_dtype)
    e = embed.to(compute_dtype)
    t = targets.reshape(-1)
    if tp is not None:
        return sharded_fused_cross_entropy(h, e, t, tp)
    return fused_cross_entropy(h, e, t)


def kernel_next_token_loss(hidden, embed, tokens, *,
                           compute_dtype=torch.bfloat16, tp=None,
                           cols=None):
    """Shifted next-token CE through the fused CE kernels
    (:func:`fused_ce_losses`): the ``(B, S, V)`` logits never exist. The
    hidden state and the tied embedding are cast to ``compute_dtype``
    first. ``cols`` as in :func:`next_token_loss` (the kernels then run
    over the rank's ``B · S_local`` rows)."""
    B, S = tokens.shape
    targets, mask = _shifted_targets_and_mask(tokens, cols)
    losses = fused_ce_losses(hidden, embed, targets,
                             compute_dtype=compute_dtype, tp=tp)
    return (losses * mask.reshape(-1)).sum() / (B * (S - 1))


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
    ``loss_chunks > 0``; else full logits and :func:`next_token_loss`.
    On a sequence-parallel model (``model.sp``) ``tokens`` are whole
    rows: the model runs on this rank's chunk and the loss is the
    chunk's share of the rows' mean (``loss_chunks`` must divide the
    chunk). With MoE the layers' aux losses are added (JAX
    ``:633-640``). The tied head takes ``model.embed_weight()`` (on an
    ``fsdp`` mesh the gathered embedding). On a ``tp`` model whose
    vocabulary ``tp`` does not divide, ``loss_impl="kernel"`` takes
    :func:`fused_next_token_loss` instead (JAX's ``_kernel_mesh_ok``
    fallback: the fused kernels have no pad mask), and every loss masks
    the pad columns."""
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

    tp, sp = model.tp, model.sp
    moe = cfg.moe_experts > 0
    vocab = cfg.vocab_size
    kernel = cfg.loss_impl == "kernel" and (tp is None
                                            or vocab % tp.size == 0)
    fused = cfg.loss_impl == "kernel" or cfg.loss_chunks > 0

    def objective(tokens):
        # on a sequence-parallel model the rows are whole: the model
        # takes this rank's chunk, the targets come from the whole rows
        cols = sp.chunk(tokens.shape[1]) if sp is not None else None
        x = tokens if cols is None else tokens[:, cols]
        out, aux = (model(x, return_hidden=fused, return_aux=True) if moe
                    else (model(x, return_hidden=fused), None))
        if kernel:
            loss = kernel_next_token_loss(out, model.embed_weight(), tokens,
                                          compute_dtype=cfg.dtype, tp=tp,
                                          cols=cols)
        elif fused:
            loss = fused_next_token_loss(
                out, model.embed_weight(), tokens, num_chunks=scan_chunks,
                compute_dtype=cfg.dtype, chunk_policy=cfg.loss_chunk_policy,
                tp=tp, cols=cols, vocab=vocab)
        else:
            loss = next_token_loss(out, tokens, tp, cols, vocab)
        return loss if aux is None else loss + aux

    return objective


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
    return train_step_around(cfg, model, optimizer,
                             lambda step, batch: loss_fn(batch["tokens"]))


def train_step_around(cfg: TransformerConfig, model: TransformerLM,
                      optimizer: torch.optim.Optimizer, loss_of_batch,
                      sync_grads=None):
    """The train step of :func:`make_train_step` around another objective
    ``loss_of_batch(step, batch) -> scalar`` (``step`` the state's step
    count): the gradients, ``sync_grads()`` when given (the data-parallel
    steps' gradient reduction), then ``optimizer.step()`` or, with
    ``cfg.fused_optimizer``, :meth:`AdamW.fused_step` (checked as there).
    The counterpart of the JAX step's ``step_factory`` seam; BERT's MLM
    step (``models/bert.py``) is built on it."""
    if cfg.fused_optimizer:
        _check_fused_optimizer(cfg, model, optimizer)

    def train_step(state, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of_batch(state["step"], batch)
        loss.backward()
        if sync_grads is not None:
            sync_grads()
        if cfg.fused_optimizer:
            optimizer.fused_step()
        else:
            optimizer.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach()})

    return train_step


# ---------------------------------------------------------------------------
# Data-parallel training (JAX :762-1076)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataShard:
    """What a ``step_factory`` step needs of its place in the data
    parallelism: ``rows``, this rank's slice of the global batch (in
    the order of ``P(data_axes)``); ``n_shards``, the number of data
    shards; ``sync_grads()``, the gradient reduction to run after the
    backward, before the update (summed over ``sp``, meaned over the
    data axes); ``sp``, the model's sequence parallelism (None without
    it). The step's loss is this rank's share: the data shard's mean
    over its rows and the whole sequence is its sum over ``sp``."""
    rows: slice
    n_shards: int
    sync_grads: Any
    sp: SequenceParallel | None = None

    def cols(self, seq_len: int) -> slice:
        """This rank's positions of a ``seq_len`` sequence: its ``sp``
        chunk, or all of them."""
        return self.sp.chunk(seq_len) if self.sp is not None else slice(None)


def jax_leaf_params(cfg: TransformerConfig, model: TransformerLM
                    ) -> list[list[nn.Parameter]]:
    """The model's parameters in the JAX parameter tree's flattened leaf
    order (``jax.tree_util`` sorts dict keys): one list a leaf, holding
    the parameter, or with ``scan_layers=True`` the stacked leaf's
    per-layer parameters in layer order (the flat bytes of JAX's
    stacked ravel). With ``scan_layers=False`` the layers sort as
    ``layer_0, layer_1, layer_10, layer_11, layer_2, ...``."""
    groups = param_shapes(cfg)["layers"]

    def layer_tree(blocks):
        return {g: {n: [getattr(getattr(b, g), n) for b in blocks]
                    for n in names} for g, names in groups.items()}

    tree = {"embed": [model.embed],
            "final_norm": {"scale": [model.final_norm.scale]}}
    if cfg.scan_layers:
        tree["layers"] = layer_tree(model.layers)
    else:
        for i, block in enumerate(model.layers):
            tree[f"layer_{i}"] = layer_tree([block])

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k])
        else:
            yield node

    return list(walk(tree))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _replicated_model(cfg: TransformerConfig, mesh, seed: int, params,
                      moe: ExpertParallel | None = None) -> TransformerLM:
    """The model on this rank: from ``params``, or initialised from
    ``seed`` and broadcast from rank 0 so the replicas start equal; on a
    mesh with ``sp > 1``, over this rank's sequence chunk; ``moe``: the
    MoE layers' routing over the mesh."""
    import torch.distributed as dist
    device = _mesh_device(mesh)
    sp = SequenceParallel.from_mesh(mesh, cfg)
    if params is not None:
        return TransformerLM(cfg, params, device=device, sp=sp, moe=moe)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = TransformerLM(cfg, device=device, generator=gen, sp=sp, moe=moe)
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p, src=0)
    return model


def _sharded_model(cfg: TransformerConfig, mesh, seed: int, params
                   ) -> TransformerLM:
    """The model on this rank: on a mesh that cuts no parameter (no
    ``tp``, ``fsdp``, or ``ep`` with MoE) :func:`_replicated_model`;
    else this rank's shards of the full parameters — ``params``, or
    those made from ``seed`` and broadcast from rank 0 — in a sharded
    module."""
    tp = TensorParallel.from_mesh(mesh)
    fsdp = TensorParallel.from_mesh(mesh, "fsdp")
    moe = ExpertParallel.from_mesh(mesh) if cfg.moe_experts > 0 else None
    if tp is None and fsdp is None and (moe is None or moe.ep is None):
        return _replicated_model(cfg, mesh, seed, params, moe)
    check_shardable(cfg, _mesh_coords(mesh)[1])
    params = _full_params(cfg, mesh, seed, params)
    return TransformerLM(cfg, shard_params(cfg, params, mesh),
                         device=_mesh_device(mesh), tp=tp,
                         sp=SequenceParallel.from_mesh(mesh, cfg),
                         fsdp=fsdp, moe=moe)


def _full_params(cfg: TransformerConfig, mesh, seed: int, params) -> dict:
    """The full parameter dict on this rank's device: ``params``, or
    those made from ``seed`` and broadcast from rank 0."""
    import torch.distributed as dist
    device = _mesh_device(mesh)
    if params is not None:
        return _map_leaves(lambda path, t: t.to(device), params)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device)
    with torch.no_grad():
        _map_leaves(lambda path, t: dist.broadcast(t, src=0), params)
    return params


def _data_size(mesh) -> int:
    """The number of data shards: the product of the data axes."""
    from distributed_tensorflow_tpu_torch.cluster.topology import (
        data_axes, mesh_axis_size)
    return mesh_axis_size(mesh, *data_axes(mesh))


def _data_rows(mesh, global_batch: int) -> slice:
    from distributed_tensorflow_tpu_torch.cluster.topology import (
        data_axes, data_shard_index, mesh_axis_size)
    n = mesh_axis_size(mesh, *data_axes(mesh))
    if global_batch % n:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"{n} data shards of {_shape(mesh)}")
    b = global_batch // n
    i = data_shard_index(mesh)
    return slice(i * b, (i + 1) * b)


def _shape(mesh) -> dict:
    from distributed_tensorflow_tpu_torch.cluster.topology import mesh_shape
    return mesh_shape(mesh)


def _global_tokens(batch, global_batch: int, device) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"]).to(device)
    if tokens.shape[0] != global_batch:
        raise ValueError(f"batch of {tokens.shape[0]} rows; this step "
                         f"takes the global batch of {global_batch}")
    return tokens


def _write_grads(leaves, reduced):
    """Reduced leaf gradients (1-D a leaf) back into ``.grad``."""
    for ps, flat in zip(leaves, reduced):
        off = 0
        for p in ps:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()


def _leaf_grads(leaves) -> list[torch.Tensor]:
    """Each leaf's gradient as one 1-D tensor (zeros where none came)."""
    return [torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1) for p in ps])
            for ps in leaves]


def _check_seq(mesh, seq_len: int):
    """``ValueError`` unless ``sp`` divides ``seq_len`` (JAX's GSPMD would
    pad; the port cuts equal chunks)."""
    from distributed_tensorflow_tpu_torch.cluster.topology import sp_size
    n = sp_size(mesh)
    if seq_len % n:
        raise ValueError(f"sequence length {seq_len} is not divisible by "
                         f"sp={n}; sequence parallelism splits it into "
                         f"equal chunks")


def _sp_axes(mesh) -> tuple:
    """``("sp",)`` on a mesh with the axis, else ``()``."""
    return ("sp",) if "sp" in mesh.mesh_dim_names else ()


def _reduce_grads(bucketer, grads, n_data: int, sp: bool):
    """Gradients (or a loss) meaned over the data axes and, on an ``sp``
    mesh, summed over ``sp`` (each rank's loss is its chunk's share):
    ``bucketer`` spans the data axes and ``sp``."""
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        ReduceOp)
    if not sp:
        return bucketer.all_reduce(grads, ReduceOp.MEAN)
    out = bucketer.all_reduce(grads, ReduceOp.SUM)
    return [g / n_data for g in out] if n_data > 1 else out


def _leaf_specs(cfg: TransformerConfig, mesh, model) -> dict:
    """``id(parameter)`` → its leaf's :func:`param_specs` entry."""
    specs = param_specs(cfg, mesh)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out[id(p)] = specs["layers"][parts[2]][parts[3]]
        elif parts[0] == "embed":
            out[id(p)] = specs["embed"]
        else:
            out[id(p)] = specs[parts[0]][parts[1]]
    return out


def _grad_sync(cfg: TransformerConfig, mesh, model, leaves):
    """``(sync, bucketer)``: ``sync(grads)`` reduces each leaf's 1-D
    gradient after the backward (None where nothing is reduced: no data
    axis and no ``sp``). Every leaf is meaned over the data axes and
    summed over ``sp`` (:func:`_reduce_grads`), but on an ``fsdp`` mesh a
    leaf cut over ``fsdp`` arrives summed over it by its gather's
    reduce-scatter: it is summed over the other data axes and ``sp``
    and divided by the number of data shards."""
    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp)
    axes, sp = data_axes(mesh), _sp_axes(mesh)
    n = _data_size(mesh)
    bucketer = GradientBucketer(mesh, axes + sp, bytes_per_pack=0)
    if not axes + sp:
        return None, bucketer
    specs = _leaf_specs(cfg, mesh, model)
    cut = [i for i, ps in enumerate(leaves) if "fsdp" in specs[id(ps[0])]]
    if not cut:
        return (lambda grads: _reduce_grads(bucketer, grads, n, bool(sp)),
                bucketer)
    rest = [i for i in range(len(leaves)) if i not in set(cut)]
    others = tuple(a for a in axes if a != "fsdp") + sp
    cut_bucketer = (GradientBucketer(mesh, others, bytes_per_pack=0)
                    if others else None)

    def sync(grads):
        out = list(grads)
        for i, g in zip(rest, _reduce_grads(
                bucketer, [grads[i] for i in rest], n, bool(sp))):
            out[i] = g
        part = [grads[i] for i in cut]
        if cut_bucketer is not None:
            part = cut_bucketer.all_reduce(part, ReduceOp.SUM)
        for i, g in zip(cut, part):
            out[i] = g / n
        return out

    return sync, bucketer


def _reduce_loss(loss, mesh, axes):
    """The reported loss: summed over ``sp``, meaned over ``axes``."""
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        ReduceOp, all_reduce)
    if _sp_axes(mesh):
        loss = all_reduce(loss, mesh, "sp")
    return all_reduce(loss, mesh, axes, ReduceOp.MEAN)


def _check_axes(shape: dict):
    """``NotImplementedError`` for an axis the step does not know. A
    ``pp`` axis is a replicated dim, as under JAX's GSPMD: it is no
    data axis, so every pp coordinate trains on the same rows with the
    same parameters, and no reduction runs over it."""
    if not set(shape) <= {"dcn", "dp", "fsdp", "sp", "tp", "ep", "pp"}:
        raise NotImplementedError(
            f"a {shape} mesh: the step runs meshes of dcn, dp, fsdp, sp, "
            f"tp, ep and pp")


def make_sharded_train_step(cfg: TransformerConfig, mesh, global_batch: int,
                            seed: int = 0, step_factory=None,
                            grad_sync: str = "auto", zero: int = 0, *,
                            params=None):
    """Sharded state and step over ``mesh`` (a ``DeviceMesh`` of
    :mod:`~distributed_tensorflow_tpu_torch.cluster.topology`; JAX
    ``:762``). Returns ``(state, step)`` with ``state = {"model",
    "optimizer", "step"}``; ``step(state, {"tokens": (global_batch,
    S)})`` takes every rank's copy of the global batch, trains on this
    rank's rows (``P(data_axes)`` order, dcn-major on a hybrid mesh) and
    returns ``(state, {"loss"})``, the loss meaned over the data axes
    (the same on every rank). ``params`` (the port's full parameter
    dict) seeds every replica; without it rank 0 initialises from
    ``seed`` and broadcasts. On a mesh with ``tp`` the model holds this
    rank's shards (:func:`shard_params`; :func:`gather_params` reads
    the full dict back), ``n_heads`` and ``d_ff`` must divide by ``tp``
    (else ``ValueError``) and a ``vocab_size`` it does not divide is
    padded (:func:`local_param_shapes`).

    ``grad_sync`` (JAX's values and validation):

    - ``"bucketed"`` (``"auto"`` on a pure-dp mesh of more than one
      device, no ``step_factory``): the reverse-order bucketed MEAN
      all-reduce launched from the backward
      (:meth:`~distributed_tensorflow_tpu_torch.parallel.collectives.
      GradientBucketer.backward_sync`), hierarchical on a ``("dcn",
      "dp")`` mesh, then the plain ``AdamW.step`` — as in JAX, whatever
      ``cfg.fused_optimizer`` says;
    - ``"none"``: the same step without the collectives (measurement
      only: the replicas part);
    - ``"gspmd"`` (and ``"auto"`` otherwise — every mesh with ``tp`` —
      and every ``step_factory``): one post-backward reduction over the
      data axes only, one bucket a dtype run, then the step's own update
      (``fused_optimizer`` honoured: the fused AdamW on each local
      shard).

    ``step_factory(cfg, model, optimizer, shard: DataShard) -> step``
    builds a step that takes the global batch and runs
    ``shard.sync_grads()`` after its backward (BERT's MLM step).
    ``zero=1|2`` shards AdamW's moments (and with 2 the gradients) over
    ``"dp"``: on a ``("dp",)`` mesh :func:`_make_zero_dp_train_step`,
    elsewhere :func:`_make_zero_gspmd_train_step` (moments only, both
    levels). On a mesh with ``sp`` (alone or with ``dp``/``dcn`` and
    ``tp``; the post-sync or the ZeRO step, as in JAX) each rank trains
    on its rows and its ``sp`` chunk of their positions, attention is
    the ring over ``sp`` (``cfg.sp_impl``, ``cfg.sp_attn_impl``), and
    the loss and gradients are summed over ``sp`` and meaned over the
    data axes; ``sp`` must divide ``max_seq_len`` (``ValueError``, where
    JAX's GSPMD pads).

    On a mesh with ``fsdp`` (a data axis: the batch splits over ``dcn ×
    dp × fsdp``) every leaf with a d_model dim is stored ``1/fsdp`` on
    it and gathered at use; ``d_model`` must divide by ``fsdp``
    (``ValueError``). ZeRO there slices the fsdp-local leaves over
    ``dp``. With ``cfg.moe_experts > 0`` the step is the post-sync one
    on every mesh (``ep`` alone or with ``dp``/``dcn``, ``tp``, ``sp``,
    ``fsdp``): ``grad_sync="bucketed"``/``"none"`` raise ``ValueError``
    and ``zero=`` ``NotImplementedError``, as in JAX; a rank holds
    ``E/ep`` experts and ``moe_experts`` must divide by ``ep``. A ``pp``
    axis is replicated, as JAX's GSPMD runs it (:func:`_check_axes`);
    :func:`make_pipelined_train_step` is the step that pipelines it."""
    shape = _shape(mesh)
    size = 1
    for v in shape.values():
        size *= v
    pure_dp = (set(shape) <= {"dcn", "dp"} and size > 1
               and cfg.moe_experts == 0 and step_factory is None)
    if grad_sync not in ("auto", "bucketed", "gspmd", "none"):
        raise ValueError(f"grad_sync={grad_sync!r}; expected auto/"
                         f"bucketed/gspmd/none")
    if zero not in (0, 1, 2):
        raise ValueError(f"zero={zero!r}; expected 0, 1, or 2")
    if zero:
        if step_factory is not None:
            raise ValueError("zero= is not supported with step_factory")
        if cfg.moe_experts > 0:
            raise NotImplementedError("zero= with MoE is not supported")
        if cfg.fused_optimizer:
            raise ValueError("zero= replaces the optimizer update; set "
                             "fused_optimizer=False")
        if grad_sync != "auto":
            raise ValueError("zero= owns the gradient sync schedule; "
                             "leave grad_sync='auto'")
        if tuple(mesh.mesh_dim_names) == ("dp",):
            return _make_zero_dp_train_step(cfg, mesh, global_batch, seed,
                                            level=zero, params=params)
        _check_axes(shape)
        return _make_zero_gspmd_train_step(cfg, mesh, global_batch, seed,
                                           params=params)
    if grad_sync in ("bucketed", "none") and not pure_dp:
        raise ValueError(
            f"grad_sync={grad_sync!r} needs a pure data-parallel mesh "
            f"(axes ⊆ {{dcn, dp}}, >1 device, no MoE); got {shape}")
    if pure_dp and grad_sync != "gspmd":
        return _make_bucketed_dp_train_step(cfg, mesh, global_batch, seed,
                                            sync=grad_sync != "none",
                                            params=params)
    _check_axes(shape)
    return _make_post_sync_train_step(cfg, mesh, global_batch, seed,
                                      step_factory, params)


def _hybrid_axes(mesh, axes):
    shape = _shape(mesh)
    if len(axes) == 2 and all(shape[a] > 1 for a in axes):
        return axes                     # ("dcn", "dp"): outer, inner
    return None, None


def _make_bucketed_dp_train_step(cfg: TransformerConfig, mesh,
                                 global_batch: int, seed: int = 0, *,
                                 sync: bool = True, params=None):
    """Pure data-parallel step with the gradient reduction overlapped on
    the backward (JAX ``:881``): each bucket's collective launches from
    the parameters' post-accumulate-grad hooks once it and every bucket
    planned before it are ready, over JAX's leaf order
    (:func:`jax_leaf_params`); all are waited for before the plain
    ``AdamW.step``. ``sync=False`` drops the collectives
    (``grad_sync="none"``). Callable at one rank. The step carries
    ``plan``, the bucket plan summary."""
    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, all_reduce)
    axes = data_axes(mesh)
    rows = _data_rows(mesh, global_batch)
    model = _replicated_model(cfg, mesh, seed, params)
    optimizer = make_optimizer(cfg, model.parameters())
    loss_fn = make_loss_fn(cfg, model)
    outer, inner = _hybrid_axes(mesh, axes)
    bucketer = GradientBucketer(mesh, axes, outer_axis=outer,
                                inner_axis=inner)
    leaves = jax_leaf_params(cfg, model)
    bsync = bucketer.backward_sync(leaves, ReduceOp.MEAN) if sync else None
    device = _mesh_device(mesh)

    def step(state, batch):
        tokens = _global_tokens(batch, global_batch, device)
        optimizer.zero_grad(set_to_none=True)
        if bsync is not None:
            bsync.begin()
        loss = loss_fn(tokens[rows])
        loss.backward()
        loss = loss.detach()
        if bsync is not None:
            bsync.finish()
            loss = all_reduce(loss, mesh, axes, ReduceOp.MEAN)
        optimizer.step()
        return {**state, "step": state["step"] + 1}, {"loss": loss}

    step.plan = bucketer.plan_summary(_leaf_metas(leaves))
    return {"model": model, "optimizer": optimizer, "step": 0}, step


def _make_zero_dp_train_step(cfg: TransformerConfig, mesh,
                             global_batch: int, seed: int = 0, *,
                             level: int = 1, params=None):
    """Pure data-parallel step with ZeRO-sharded AdamW state (JAX
    ``:971``): the moments exist only for this rank's 1/N of the packed
    parameter buckets (:class:`~distributed_tensorflow_tpu_torch.
    parallel.zero.ZeroPartition` over :func:`jax_leaf_params`). Level 1
    reduces the gradients with the overlapped bucketed all-reduce, then
    slices them; level 2 reduce-scatters the packed buckets after the
    backward. The port's ``AdamW`` steps the flat shards, and an
    all-gather over dp rebuilds the parameters. ``state["optimizer"]``
    is the AdamW over the shards; the step carries ``partition``."""
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, all_reduce)
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        make_zero_update)
    if tuple(mesh.mesh_dim_names) != ("dp",):
        raise ValueError(f"ZeRO explicit dp path needs a ('dp',) mesh, "
                         f"got {tuple(mesh.mesh_dim_names)}")
    rows = _data_rows(mesh, global_batch)
    model = _replicated_model(cfg, mesh, seed, params)
    loss_fn = make_loss_fn(cfg, model)
    leaves = jax_leaf_params(cfg, model)
    bsync = (GradientBucketer(mesh, ("dp",)).backward_sync(leaves)
             if level == 1 else None)
    optimizer, update = make_zero_update(
        lambda ps: make_optimizer(cfg, ps), mesh, leaves, level=level)
    partition, rank = update.partition, update.rank
    device = _mesh_device(mesh)

    def step(state, batch):
        tokens = _global_tokens(batch, global_batch, device)
        for p in model.parameters():
            p.grad = None
        if bsync is not None:
            bsync.begin()
        loss = loss_fn(tokens[rows])
        loss.backward()
        loss = all_reduce(loss.detach(), mesh, ("dp",), ReduceOp.MEAN)
        with torch.no_grad():
            if bsync is not None:
                bsync.finish()
                g_shards = [g.clone() for g in partition.shard(
                    partition.pack(_leaf_grads(leaves)), rank)]
            else:
                g_shards = partition.reduce_scatter_mean(
                    _leaf_grads(leaves), mesh, "dp")
            # the full gradients go before the update: only the shards
            # stay
            for p in model.parameters():
                p.grad = None
            update(g_shards)
        return {**state, "step": state["step"] + 1}, {"loss": loss}

    step.partition = partition
    return {"model": model, "optimizer": optimizer, "step": 0}, step


def _make_zero_gspmd_train_step(cfg: TransformerConfig, mesh,
                                global_batch: int, seed: int = 0, *,
                                params=None):
    """ZeRO on any other mesh (``("dp", "tp")``, ``("tp",)``, dcn
    hybrids, meshes with ``sp`` or ``fsdp``; JAX ``:1078`` with
    ``parallel/zero.py make_zero_update``): the gradients are those of
    the non-ZeRO step — one post-backward reduction over the data axes
    (and ``sp``, summed; :func:`_grad_sync`) — and the partition is over
    this rank's tp- and fsdp-local leaves
    (:class:`~distributed_tensorflow_tpu_torch.
    parallel.zero.ZeroPartition` of their local shapes, JAX's
    ``_local_shape``), sliced over ``dp`` only: each dp rank updates its
    1/N and an all-gather over ``dp`` rebuilds the local blocks. As in
    JAX, levels 1 and 2 are the same step here (the moments sharded,
    the gradients synced whole); the update
    (:func:`~distributed_tensorflow_tpu_torch.parallel.zero.
    make_zero_update`) is the plain ``AdamW.step`` on the flat shards,
    bitwise the non-ZeRO step's."""
    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        make_zero_update)
    axes = data_axes(mesh)
    rows = _data_rows(mesh, global_batch)
    _check_seq(mesh, cfg.max_seq_len)
    model = _sharded_model(cfg, mesh, seed, params)
    loss_fn = make_loss_fn(cfg, model)
    leaves = jax_leaf_params(cfg, model)
    sync, _ = _grad_sync(cfg, mesh, model, leaves)
    optimizer, update = make_zero_update(
        lambda ps: make_optimizer(cfg, ps), mesh, leaves)
    partition, rank = update.partition, update.rank
    device = _mesh_device(mesh)

    def step(state, batch):
        tokens = _global_tokens(batch, global_batch, device)
        for p in model.parameters():
            p.grad = None
        loss = loss_fn(tokens[rows])
        loss.backward()
        loss = _reduce_loss(loss.detach(), mesh, axes)
        with torch.no_grad():
            grads = _leaf_grads(leaves)
            if sync:
                grads = sync(grads)
            g_shards = [g.clone() for g in partition.shard(
                partition.pack(grads), rank)]
            for p in model.parameters():
                p.grad = None
            update(g_shards)
        return {**state, "step": state["step"] + 1}, {"loss": loss}

    step.partition = partition
    return {"model": model, "optimizer": optimizer, "step": 0}, step


def _lm_step_factory(cfg, model, optimizer, shard: DataShard):
    """The next-token step on this rank's rows of the global batch."""
    loss_fn = make_loss_fn(cfg, model)
    return train_step_around(
        cfg, model, optimizer,
        lambda step, batch: loss_fn(batch["tokens"][shard.rows]),
        sync_grads=shard.sync_grads)


def _make_post_sync_train_step(cfg: TransformerConfig, mesh,
                               global_batch: int, seed: int, step_factory,
                               params):
    """The ``"gspmd"`` counterpart: the factory's step with one gradient
    reduction after the backward — ``GradientBucketer(bytes_per_pack=0)``
    over every data axis (none on a ``("tp",)`` mesh) and ``sp``, one
    bucket a dtype run, no hooks: meaned over the data axes and summed
    over ``sp``, whose ranks each hold their chunk's share of the loss
    (the parameters are replicated over ``sp``, and the ring's backward
    has already brought every chunk's dk/dv home). On a mesh with ``tp``
    the model is tensor-parallel (:func:`_sharded_model`): its leaves
    are local shards, and ``tp`` takes no part in the gradient
    reduction; nor does ``ep`` (the dense leaves and the router are the
    same on every ``ep`` rank, an expert is on one). On an ``fsdp`` mesh
    the leaves cut over it arrive reduce-scattered (:func:`_grad_sync`).
    """
    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    axes = data_axes(mesh)
    rows = _data_rows(mesh, global_batch)
    _check_seq(mesh, cfg.max_seq_len)
    n = _data_size(mesh)
    model = _sharded_model(cfg, mesh, seed, params)
    optimizer = make_optimizer(cfg, model.parameters())
    leaves = jax_leaf_params(cfg, model)
    sync, bucketer = _grad_sync(cfg, mesh, model, leaves)

    def sync_grads():
        with torch.no_grad():
            _write_grads(leaves, sync(_leaf_grads(leaves)))

    inner = (step_factory or _lm_step_factory)(
        cfg, model, optimizer,
        DataShard(rows, n, sync_grads if sync else None, model.sp))
    device = _mesh_device(mesh)

    def step(state, batch):
        tokens = _global_tokens(batch, global_batch, device)
        state, metrics = inner(state, {**batch, "tokens": tokens})
        loss = _reduce_loss(metrics["loss"].detach(), mesh, axes)
        return state, {**metrics, "loss": loss}

    step.plan = bucketer.plan_summary(_leaf_metas(leaves))
    return {"model": model, "optimizer": optimizer, "step": 0}, step


# ---------------------------------------------------------------------------
# Pipeline parallelism (JAX :1153-1478)
# ---------------------------------------------------------------------------

def make_pipelined_train_step(cfg: TransformerConfig, mesh,
                              global_batch: int, num_microbatches: int,
                              seed: int = 0, schedule: str = "gpipe",
                              interleave: int = 2, zero: int = 0,
                              offload_activations=False, *, params=None):
    """Pipeline-parallel state and step over a ``pp`` or ``dp``×``pp``
    mesh (JAX ``:1153``), one process a pp rank. ``schedule`` is
    "gpipe", "1f1b" or "interleaved" (``interleave`` chunks a rank),
    run by :func:`~distributed_tensorflow_tpu_torch.parallel.pipeline.
    run_schedule` from the schedule's table; the refusals are JAX's, with
    its exception types.

    - The layer stack regroups as JAX's ``(L, ...) → (pp, L/pp, ...)``
      (interleaved: ``(pp, v, L/(pp·v), ...)``, model stage ``j·pp + k``
      on rank k's chunk j), and a rank holds only its stage's layers
      (``state["model"]``, a :class:`TransformerLM` of those layers);
      ``embed`` and ``final_norm`` are on every rank, as JAX's ``P()``.
    - Model stage 0 looks the microbatch up in the embedding; the last
      runs JAX's head, full logits through :func:`next_token_loss` a
      microbatch (no fused CE, as in JAX). Each layer of a stage is
      checkpointed by ``cfg.remat`` / ``remat_policy``
      (:func:`run_blocks`).
    - Microbatch rows split over ``dp`` (JAX's ``mb_spec``); the loss is
      the microbatches' mean, psummed over ``pp`` and meaned over
      ``dp``. The tied ``embed`` gradient (the lookup's on stage 0, the
      head's on the last stage) and ``final_norm``'s are summed over
      ``pp``, then every gradient is meaned over ``dp``.
    - The update is the plain ``AdamW.step`` whatever
      ``cfg.fused_optimizer`` says (JAX's step calls ``tx.update``), or
      with ``zero=1|2`` :func:`~distributed_tensorflow_tpu_torch.
      parallel.zero.make_zero_update` over ``dp``.
    - ``offload_activations`` (1F1B only): ``True`` spills the stash to
      pinned host memory (:class:`~distributed_tensorflow_tpu_torch.
      parallel.offload.ActivationSpillStore`), ``"device"`` runs the
      same loop with the stash on the card; one ``offload.step`` event a
      step.

    ``params`` is the port's full parameter dict (e.g. JAX's converted
    by :func:`params_from_jax`); without it rank 0 initialises from
    ``seed`` and broadcasts. Returns ``(state, step)``, ``state =
    {"model", "optimizer", "step"}``; ``step(state, {"tokens":
    (global_batch, S)})`` returns ``(state, {"loss"})``, the loss the
    same on every rank. ``step.gather_params()`` returns the whole
    parameter dict on every rank (``of=``: its gradients);
    ``step.last_stats`` holds the last step's P2P counts (``"p2p"``)
    and offload stats (``"offload"``).
    Any other axis of the mesh (``tp``, ...) is replicated, as in JAX,
    whose stage weights are ``P("pp")`` and microbatches ``P(None,
    "dp")``: each of its coordinates runs the same stages on the same
    rows, and no reduction runs over it. GPipe microbatches whose rows
    ``dp`` does not divide raise ``ValueError`` when built, where JAX's
    raises it at the first step."""
    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, all_gather, all_reduce)
    from distributed_tensorflow_tpu_torch.parallel.offload import (
        ActivationSpillStore)
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        make_zero_update)

    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"schedule={schedule!r}; expected 'gpipe', "
                         f"'1f1b', or 'interleaved'")
    if offload_activations not in (False, True, "device"):
        raise ValueError(f"offload_activations={offload_activations!r}; "
                         f"expected False, True, or 'device'")
    if offload_activations and schedule != "1f1b":
        raise ValueError(
            "offload_activations requires schedule='1f1b': GPipe keeps "
            "O(M) activations alive inside autograd and the interleaved "
            "stash is not host-realized")
    if not cfg.scan_layers:
        raise ValueError("pipeline path requires scan_layers=True")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE under pipeline parallelism is not supported (as in the "
            "JAX package): use make_sharded_train_step on a dp×ep mesh")
    shape = _shape(mesh)
    n_stages = shape.get("pp", 1)
    n_chunks = int(interleave) if schedule == "interleaved" else 1
    if n_chunks < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if cfg.n_layers % (n_stages * n_chunks):
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp*interleave={n_stages * n_chunks}")
    if global_batch % num_microbatches:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"num_microbatches={num_microbatches}")
    mb = global_batch // num_microbatches
    n_dp = shape.get("dp", 1)
    if mb % n_dp:
        # JAX raises the same for GPipe, at its first step (shard_map)
        raise ValueError(
            f"schedule={schedule!r} needs the microbatch size "
            f"(global_batch/num_microbatches = {mb}) divisible by "
            f"dp={n_dp}; raise global_batch or lower num_microbatches")
    if schedule == "interleaved" and num_microbatches % n_stages:
        raise ValueError(
            f"schedule='interleaved' needs num_microbatches "
            f"({num_microbatches}) divisible by pp={n_stages} "
            f"(microbatches flow in groups of pp per chunk)")
    if zero not in (0, 1, 2):
        raise ValueError(f"zero={zero!r}; expected 0, 1, or 2")
    telemetry.event("pipeline.schedule", schedule=schedule,
                    n_stages=int(n_stages), n_micro=int(num_microbatches),
                    interleave=int(n_chunks),
                    offload=bool(offload_activations),
                    bubble_fraction=round(pl.bubble_fraction(
                        n_stages, num_microbatches, schedule,
                        interleave=n_chunks), 6))

    # this rank's layers: chunk j holds model stage j * pp + k
    per = cfg.n_layers // (n_stages * n_chunks)
    k = topology.pp_index(mesh)
    device = _mesh_device(mesh)
    full = _full_params(cfg, mesh, seed, params)
    idx = torch.tensor([(j * n_stages + k) * per + i
                        for j in range(n_chunks) for i in range(per)],
                       device=device)
    local_cfg = dataclasses.replace(cfg, n_layers=per * n_chunks)
    model = TransformerLM(local_cfg, {
        "embed": full["embed"], "final_norm": full["final_norm"],
        "layers": _map_leaves(lambda path, t: t[idx], full["layers"])},
        device=device)
    del full
    leaves = jax_leaf_params(local_cfg, model)
    if zero:
        optimizer, zero_update = make_zero_update(
            lambda ps: make_optimizer(cfg, ps), mesh, leaves)
    else:
        optimizer = make_optimizer(cfg, model.parameters())

    # this data shard's rows of every microbatch
    n_rows = mb // n_dp
    lo = n_rows * (mesh.get_local_rank("dp") if "dp" in shape else 0)
    links = pl.StageLinks(mesh)
    dp_sync = (GradientBucketer(mesh, ("dp",), bytes_per_pack=0)
               if n_dp > 1 else None)
    dt = cfg.dtype
    box: dict = {}

    def rows(m):
        return box["tokens"][m * mb + lo:m * mb + lo + n_rows]

    def input_fn(m):
        return model.embed.to(dt)[rows(m)]

    def stage_fn(j, x):
        return run_blocks(cfg, model.layers[j * per:(j + 1) * per], x)

    def head_fn(m, y):
        logits = (model.final_norm(y) @ model.embed.to(dt).T).float()
        return next_token_loss(logits, rows(m))

    def step(state, batch):
        tokens = _global_tokens(batch, global_batch, device)
        box["tokens"] = tokens
        for p in model.parameters():
            p.grad = None
        links.reset_counts()
        store = (ActivationSpillStore(spill=offload_activations is True)
                 if offload_activations else None)
        loss_sum = pl.run_schedule(
            links, schedule, num_microbatches, stage_fn=stage_fn,
            head_fn=head_fn, input_fn=input_fn,
            act_shape=(n_rows, tokens.shape[1], cfg.d_model), act_dtype=dt,
            device=device, interleave=n_chunks, stash=store)
        box.clear()
        step.last_stats = {"p2p": dict(links.counts), "offload": None}
        if store is not None:
            step.last_stats["offload"] = store.stats(
                num_microbatches + 2 * (n_stages - 1))
            telemetry.event("offload.step", spill=store.spill,
                            **step.last_stats["offload"])
        with torch.no_grad():
            grads = _leaf_grads(leaves)
            if n_stages > 1:
                # embed and final_norm (JAX's leaves 0 and 1) and the
                # loss live on the first and last stages: psum over pp
                flat = all_reduce(torch.cat([grads[0], grads[1],
                                             loss_sum.reshape(1)]),
                                  mesh, "pp")
                n0 = grads[0].numel()
                grads[0], grads[1] = flat[:n0], flat[n0:-1]
                loss_sum = flat[-1]
            loss = loss_sum / num_microbatches
            if dp_sync is not None:
                grads = dp_sync.all_reduce(grads, ReduceOp.MEAN)
                loss = all_reduce(loss, mesh, "dp", ReduceOp.MEAN)
            if zero:
                part = zero_update.partition
                g_shards = [g.clone() for g in part.shard(
                    part.pack(grads), zero_update.rank)]
                for p in model.parameters():
                    p.grad = None
                zero_update(g_shards)
            else:
                _write_grads(leaves, grads)
                optimizer.step()
        return {**state, "step": state["step"] + 1}, {"loss": loss}

    def gather_params(of=None) -> dict:
        """The whole parameter dict (JAX's layer order) on every rank;
        ``of`` as :meth:`TransformerLM.stacked_params`'s (``lambda p:
        p.grad``: the last step's synced gradients, not under ZeRO)."""
        with torch.no_grad():
            local = model.stacked_params(of)

            def whole(path, t):
                t = t.detach()
                g = (all_gather(t, mesh, "pp", tiled=False)
                     if n_stages > 1 else t[None])
                return g.reshape(n_stages, n_chunks, per, *t.shape[1:]) \
                    .transpose(0, 1).reshape(cfg.n_layers, *t.shape[1:])
            return {"embed": local["embed"].detach().clone(),
                    "layers": _map_leaves(whole, local["layers"]),
                    "final_norm": {"scale": local["final_norm"]["scale"]
                                   .detach().clone()}}

    step.gather_params = gather_params
    step.last_stats = {}
    if zero:
        step.partition = zero_update.partition
    return {"model": model, "optimizer": optimizer, "step": 0}, step

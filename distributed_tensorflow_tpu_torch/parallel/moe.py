"""Mixture-of-experts with expert parallelism over a mesh's ``ep`` dim —
port of ``distributed_tensorflow_tpu/parallel/moe.py``.

The layer is JAX's: Switch-style top-k routing (an f32 router, softmax
over the experts, ties to the lowest index), a capacity of ``C =
max(1, int(capacity_factor · T · top_k / E))`` slots an expert over the
**global** token count ``T``, the first choices of every token placed
before any second choice, tokens past ``C`` dropped (their output row
exactly 0, the residual carries them), GELU (tanh) expert FFNs and the
load-balancing aux loss ``w · E · Σ_e (frac_e / k) · me_e``.

JAX builds ``(T, E, C)`` one-hot dispatch and combine tensors and lets
GSPMD turn its einsums into collectives. The FFN is row-wise, so the
capacity only decides *which* tokens drop; here each rank

- routes every token it holds, the router made whole where it is
  stored ``ep``-sharded on E (:func:`~distributed_tensorflow_tpu_torch.
  parallel.collectives.gather_keep_shard`: routing repeats on every
  ``ep`` rank, so each keeps its slice of the identical gradient);
- places each token by the per-expert counts of every token before it
  in the global row-major order: one all-gather of a small integer
  table (per pass, row and expert) a layer over the data axes and
  ``sp``, with no gradient (:data:`STATS`);
- copies its local experts' kept tokens into an ``(E/ep, C, D)`` buffer
  at their slots (JAX's shapes and FLOPs), runs one ``bmm`` a
  projection, and adds the gated rows back in f32;
- sums the partial outputs over ``ep`` (and ``tp``, which cuts the
  experts' ``d_ff``).

``ep`` is no data axis (``cluster/topology.py DATA_AXES``), so the
tokens are already on every ``ep`` rank and no all-to-all is needed:
the expert path enters through ``tp_copy`` over those groups (the
tokens and the gates, so the gates' gradient sums over them while the
aux loss's does not) and leaves through ``tp_reduce``.

:func:`moe_forward` is the functional form; :class:`MoELayer` holds the
parameters ``router (D, E)``, ``wi (E, D, F)``, ``wo (E, F, D)`` (f32,
JAX's names; this rank's blocks on a mesh).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.nn import functional as F

from distributed_tensorflow_tpu_torch.parallel.collectives import (
    all_gather, gather_keep_shard, tp_copy, tp_reduce)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel)

# Logical axes for MoE (JAX :29-33); the flagship's rules put
# "expert_mlp" on "tp" (models/transformer.py LOGICAL_AXIS_RULES).
MOE_AXIS_RULES = (
    ("expert", "ep"),
    ("expert_mlp", None),
    ("expert_embed", None),
)

#: each parameter's logical axes (JAX's ``param_with_axes``)
PARAM_LOGICAL_AXES = {"router": ("expert_embed", "expert"),
                      "wi": ("expert", "expert_embed", "expert_mlp"),
                      "wo": ("expert", "expert_mlp", "expert_embed")}

#: count-table all-gathers run and their bytes (a plain count)
STATS = {"count_gathers": 0, "count_gather_bytes": 0}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """JAX's ``MoEConfig`` (``:37-49``) without its ``mesh``: the port
    takes its parallelism as :class:`ExpertParallel`."""
    num_experts: int = 8
    d_model: int = 64
    d_ff: int = 128
    capacity_factor: float = 1.25
    top_k: int = 1
    aux_loss_weight: float = 0.01
    dtype: Any = torch.float32


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots an expert for ``n_tokens`` global tokens (JAX ``:62``, the
    same Python float expression)."""
    return max(1, int(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.num_experts))


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """This rank's place in the MoE layer's parallelism on a mesh:
    ``ep`` and ``tp`` (:class:`~distributed_tensorflow_tpu_torch.
    parallel.tensor_parallel.TensorParallel` handles, or None), the
    axes its tokens are cut over (``token_axes``: the data axes, then
    ``sp``), its data shard and its ``sp`` chunk."""
    mesh: Any
    ep: TensorParallel | None
    tp: TensorParallel | None
    token_axes: tuple
    token_shards: int
    data_index: int
    sp_size: int
    sp_index: int

    @classmethod
    def from_mesh(cls, mesh) -> "ExpertParallel | None":
        """The handle on ``mesh``; None without a mesh."""
        if mesh is None:
            return None
        from distributed_tensorflow_tpu_torch.cluster import topology
        shape = topology.mesh_shape(mesh)
        axes = topology.data_axes(mesh) + (
            (topology.SEQUENCE_AXIS,) if topology.SEQUENCE_AXIS in shape
            else ())
        return cls(mesh, TensorParallel.from_mesh(mesh, "ep"),
                   TensorParallel.from_mesh(mesh, "tp"), axes,
                   math.prod(shape[a] for a in axes),
                   topology.data_shard_index(mesh), topology.sp_size(mesh),
                   topology.sp_index(mesh))

    @property
    def groups(self) -> list:
        """The groups the expert path's partial outputs sum over."""
        return [h.group for h in (self.ep, self.tp) if h is not None]


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """``(k, T)`` expert indices of ``jax.lax.top_k(probs, k)``: ties to
    the lowest index (``argmax`` returns the first maximum; ``topk``
    promises no order on ties)."""
    p = probs.detach()
    out = []
    for _ in range(k):
        i = p.argmax(-1)
        out.append(i)
        p = p.scatter(-1, i[:, None], float("-inf"))
    return torch.stack(out)


def _global_offsets(counts: torch.Tensor, group: ExpertParallel | None):
    """``counts`` ``(K, B, E)``: this rank's tokens a pass, row and
    expert. Returns the count of each pass's tokens before each of its
    rows in the global row-major order ``(K, B, E)``, and each pass's
    global totals ``(K, E)``. The table is all-gathered over the token
    axes (innermost first, so the result is data-shard-major, then the
    ``sp`` chunk); a global row ``r`` of chunk ``c`` is entry ``r · sp +
    c``."""
    K, B, E = counts.shape
    if group is None or group.token_shards == 1:
        return counts.cumsum(1) - counts, counts.sum(1)
    t = counts
    for axis in reversed(group.token_axes):
        t = all_gather(t, group.mesh, axis, tiled=False)
        STATS["count_gathers"] += 1
        STATS["count_gather_bytes"] += t.numel() * t.element_size()
    n_data = group.token_shards // group.sp_size
    t = t.reshape(n_data, group.sp_size, K, B, E).permute(2, 0, 3, 1, 4) \
        .reshape(K, n_data * B * group.sp_size, E)
    rows = ((group.data_index * B
             + torch.arange(B, device=counts.device)) * group.sp_size
            + group.sp_index)
    return (t.cumsum(1) - t)[:, rows], t.sum(1)


_ROUTING_LOG: list | None = None


@contextlib.contextmanager
def routing_log():
    """Record each :func:`moe_forward` call's routing while open: a list
    of dicts, one a call — ``dropped`` (this rank's tokens kept in no
    pass, ``(B, S)`` bool), ``assigned`` (global tokens an expert over
    all passes, ``(E,)``), ``capacity`` and ``aux``."""
    global _ROUTING_LOG
    prev, _ROUTING_LOG = _ROUTING_LOG, []
    try:
        yield _ROUTING_LOG
    finally:
        _ROUTING_LOG = prev


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                group: ExpertParallel | None = None):
    """The MoE layer on ``x`` ``(B, S, D)`` in ``cfg.dtype``: ``(out (B, S,
    D), aux)``. ``params``: ``router``, ``wi``, ``wo`` (this rank's
    blocks with ``group``, an :class:`ExpertParallel`: ``x`` is then its
    rows and ``sp`` chunk, and the capacity and the aux loss's token
    fractions are the global batch's; the aux loss's mean router
    probability is the rank's own — meaned over the data shards by the
    step, its gradient is the global mean's — over ``sp``, so the
    ``sp`` ranks' shares sum to it)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    n_global = T * (group.token_shards if group is not None else 1)
    C = capacity(cfg, n_global)
    tokens = x.reshape(T, D)

    router = params["router"]
    if group is not None and group.ep is not None:
        router = gather_keep_shard(router, group.ep.group, 1)
    probs = torch.softmax(tokens.float() @ router, dim=-1)      # (T, E)
    idx = _top_k(probs, K)                                      # (K, T)
    gate_vals = probs.gather(1, idx.T)                          # (T, K)

    # position of each token in its expert's slots: pass k after every
    # token of passes < k, then in global row-major order
    onehot = F.one_hot(idx, E).reshape(K, B, S, E)
    offsets, totals = _global_offsets(onehot.sum(2), group)
    prior = totals.cumsum(0) - totals                            # (K, E)
    pos = (onehot.cumsum(2) - onehot + offsets[:, :, None, :]
           + prior[:, None, None, :]).reshape(K, T, E)
    pos = pos.gather(2, idx[..., None])[..., 0]                  # (K, T)
    keep = pos < C

    # load balancing (Switch eq. 4): frac over every token, in f32
    frac = torch.zeros(E, dtype=torch.float32, device=x.device)
    for k in range(K):
        frac = frac + totals[k].float() / n_global
    aux = cfg.aux_loss_weight * E * torch.sum(frac / K * probs.mean(0))
    if group is not None and group.sp_size > 1:
        aux = aux / group.sp_size

    out = _experts(params, tokens, gate_vals, idx, pos, keep, C, cfg, group)
    if _ROUTING_LOG is not None:
        _ROUTING_LOG.append({"dropped": ~keep.any(0).reshape(B, S),
                             "assigned": totals.sum(0), "capacity": C,
                             "aux": aux.detach()})
    return out.reshape(B, S, D), aux


def _experts(params, tokens, gate_vals, idx, pos, keep, C, cfg, group):
    """This rank's experts on their kept tokens, gated and summed over
    the groups of ``group``: ``(T, D)`` in ``cfg.dtype``, a dropped
    token's row 0."""
    T, D = tokens.shape
    dt = cfg.dtype
    wi, wo = params["wi"], params["wo"]
    n_local = wi.shape[0]
    groups = group.groups if group is not None else []
    first = (group.ep.rank * n_local
             if group is not None and group.ep is not None else 0)
    for g in groups:
        tokens = tp_copy(tokens, g)
        gate_vals = tp_copy(gate_vals, g)
    # slot of each (pass, token): kept on a local expert, else the
    # trash slot E_local · C, which nothing reads
    local = idx - first
    mine = keep & (local >= 0) & (local < n_local)
    trash = n_local * C
    slots = torch.where(mine, local * C + pos, trash)            # (K, T)
    buf = tokens.new_zeros(trash + 1, D).index_copy(
        0, slots.reshape(-1), tokens.repeat(slots.shape[0], 1))
    h = F.gelu(torch.bmm(buf[:trash].view(n_local, C, D), wi.to(dt)),
               approximate="tanh")
    eo = torch.bmm(h, wo.to(dt)).reshape(trash, D)
    eo = torch.cat([eo, eo.new_zeros(1, D)])
    # combine: each pass's gated row (the gate in cfg.dtype, as JAX's
    # combine.astype), accumulated in f32
    y = torch.zeros(T, D, dtype=torch.float32, device=tokens.device)
    for k in range(slots.shape[0]):
        w = (gate_vals[:, k] * mine[k]).to(dt).float()
        y = y + eo[slots[k]].float() * w[:, None]
    for g in groups:
        y = tp_reduce(y, g)
    return y.to(dt)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                    device="cuda") -> dict:
    """f32 ``router`` N(0, 0.02), ``wi`` N(0, D^-1/2), ``wo`` N(0,
    F^-1/2) (JAX's initialisers), drawn in that order from
    ``generator``, on ``device`` (a CUDA device with no card raises)."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)
    device = resolve_device(device)
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.d_ff
    shapes = {"router": ((D, E), 0.02), "wi": ((E, D, Fd), D ** -0.5),
              "wo": ((E, Fd, D), Fd ** -0.5)}
    return {name: torch.empty(shape, device=device).normal_(
        0.0, std, generator=generator)
        for name, (shape, std) in shapes.items()}


class MoELayer(nn.Module):
    """Switch-style MoE FFN: ``(B, S, D) -> ((B, S, D), aux)``
    (:func:`moe_forward`). ``params`` is loaded when given — with
    ``group`` (an :class:`ExpertParallel`) this rank's block: its
    ``E/ep`` experts and router columns, the experts' ``d_ff / tp``
    (``models/transformer.py shard_params`` cuts them); else the whole
    layer is initialised from ``generator`` (:func:`init_moe_params`)."""

    def __init__(self, cfg: MoEConfig, params: dict | None = None, *,
                 group: ExpertParallel | None = None, device="cuda",
                 generator: torch.Generator | None = None):
        from distributed_tensorflow_tpu_torch.models.transformer import (
            resolve_device)
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.group = cfg, group
        if params is None:
            params = init_moe_params(cfg, generator, device)
        for name, t in params.items():
            setattr(self, name, nn.Parameter(t.detach().clone().to(device)))

    def forward(self, x):
        return moe_forward({"router": self.router, "wi": self.wi,
                            "wo": self.wo}, x, self.cfg, group=self.group)

"""Tensor parallelism over a mesh's ``tp`` dim: what GSPMD derives in
the JAX package from the logical-axis rules (``models/transformer.py
LOGICAL_AXIS_RULES``), written out for one process a rank.

- :class:`TensorParallel` — this rank's place on ``tp``: the group, its
  size and this rank's index.
- :func:`check_divisible` — the dims ``tp`` must divide.
- :func:`padded_rows` — a row count rounded up to a multiple of the
  shard count: the vocabulary over ``tp`` (its pad rows are zero and no
  id looks them up) and the embedding tables over their shard axis.
- :func:`vocab_parallel_embed` — the lookup in a vocab-sharded
  embedding: each rank looks up the ids it owns, zeroes the rest, and
  one all-reduce sums the shards.
- :func:`vocab_parallel_cross_entropy` — softmax cross-entropy over
  vocab-sharded logits: the row max and sum-exp all-reduced over
  ``tp``, the target logit picked up by its owner, the pad columns of a
  padded vocabulary masked out. The ``(N, V)`` logits are never
  gathered.

The activation boundaries themselves are :func:`~distributed_tensorflow_
tpu_torch.parallel.collectives.tp_copy` and :func:`~distributed_
tensorflow_tpu_torch.parallel.collectives.tp_reduce`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel.collectives import tp_reduce


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank on one dim of a mesh, ``tp`` unless ``axis`` names
    another (the serving engine's ``dp``): ``group`` its process group,
    ``size`` and ``rank`` its size and this rank's index there."""
    mesh: object
    group: object
    size: int
    rank: int
    axis: str = "tp"

    @classmethod
    def from_mesh(cls, mesh, axis: str = "tp") -> "TensorParallel | None":
        """The handle of ``mesh``'s ``axis`` dim; None without one."""
        if mesh is None or axis not in mesh.mesh_dim_names:
            return None
        return cls(mesh, mesh.get_group(axis),
                   mesh.size(tuple(mesh.mesh_dim_names).index(axis)),
                   mesh.get_local_rank(axis), axis)


def check_divisible(cfg, tp: int):
    """Raise ``ValueError`` naming the first of ``n_heads`` and ``d_ff``
    that ``tp`` does not divide. (The JAX package pads or falls back to
    replicated execution there; the port refuses.) The vocabulary is
    padded instead (:func:`padded_rows`)."""
    for name in ("n_heads", "d_ff"):
        value = getattr(cfg, name)
        if value % tp:
            raise ValueError(f"{name}={value} is not divisible by tp={tp}; "
                             f"tensor parallelism shards it over tp")


def padded_rows(n: int, shards: int) -> int:
    """``n`` rounded up to a multiple of ``shards``: the rows of a table
    cut into ``shards`` equal blocks (JAX's ``embedding/embedding.py
    _padded_vocab``; GSPMD pads a vocab-sharded embedding the same
    way)."""
    return -(-n // shards) * shards


def local_rows(ids: torch.Tensor, rows: int, rank: int):
    """``(local ids, inside)``: global vocab ids in the local row space of
    shard ``rank`` of ``rows`` rows each, and whether this shard owns
    them."""
    local = ids.long() - rank * rows
    inside = (local >= 0) & (local < rows)
    return local, inside


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         tp: TensorParallel) -> torch.Tensor:
    """``full_embed[tokens]`` from this rank's vocab rows ``embed``
    ``(V/tp, D)``: rows this shard does not own are zero, and a
    :func:`~distributed_tensorflow_tpu_torch.parallel.collectives.
    tp_reduce` sums the shards (JAX gets this from GSPMD at
    ``models/transformer.py:410-414``)."""
    local, inside = local_rows(tokens, embed.shape[0], tp.rank)
    x = embed[local.clamp(0, embed.shape[0] - 1)]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return tp_reduce(x, tp.group)


class VocabParallelCrossEntropy(torch.autograd.Function):
    """Per-row ``logsumexp(logits) − logits[target]`` over logits whose
    vocab is sharded over ``group``: ``logits`` ``(N, V/tp)`` f32, this
    rank's columns ``[rank·V/tp, (rank+1)·V/tp)``; ``targets`` global
    ids. Three all-reduces of ``N`` floats: the max, the sum of exp, the
    target logit. ``vocab``: the true vocabulary of a padded one; the
    pad columns' logits are −inf before the max and the sum, so they add
    nothing to the loss or to any gradient. The backward is local:
    ``exp(logits − lse)·g``, less ``g`` at the target on its owner's
    columns. Each step rounds as
    ``torch.logsumexp`` and its autograd do (``log Σ exp(x − m) + m``),
    so on a group of one the loss and its gradient are the unsharded
    CE's, bit for bit."""

    @staticmethod
    def forward(ctx, logits, targets, group, rank, vocab=None):
        cols = logits.shape[1]
        if vocab is not None and (rank + 1) * cols > vocab:
            ids = torch.arange(rank * cols, (rank + 1) * cols,
                               device=logits.device)
            logits = logits.masked_fill(ids >= vocab, float("-inf"))
        local, inside = local_rows(targets, cols, rank)
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(logits - m[:, None]).sum(dim=-1)
        dist.all_reduce(s, group=group)
        tl = logits.gather(-1, local.clamp(0, logits.shape[1] - 1)[:, None])
        tl = torch.where(inside, tl[:, 0], torch.zeros_like(m))
        dist.all_reduce(tl, group=group)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        d = g[:, None] * torch.exp(logits - lse[:, None])
        rows = torch.arange(d.shape[0], device=d.device)[inside]
        d[rows, local[inside]] += -g[rows]
        return d, None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 tp: TensorParallel, vocab: int | None = None
                                 ) -> torch.Tensor:
    """:class:`VocabParallelCrossEntropy` of ``(..., V/tp)`` f32 logits
    against ``(...)`` global targets: per-position losses ``(...)``;
    ``vocab`` the true vocabulary when ``V`` is padded."""
    shape = targets.shape
    out = VocabParallelCrossEntropy.apply(
        logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1),
        tp.group, tp.rank, vocab)
    return out.reshape(shape)

"""ZeRO-1/2: optimizer-state (and gradient) sharding over data
parallelism — port of ``distributed_tensorflow_tpu/parallel/zero.py``.

- **ZeRO-1**: gradients are all-reduced as in replicated data
  parallelism, but AdamW's moments exist only for this rank's 1/N slice
  of the packed parameters; after the sliced update an all-gather
  rebuilds the parameters.
- **ZeRO-2**: each packed gradient bucket is reduce-scattered instead,
  so a rank only ever holds its gradient shard.

The parameters pack into the same dtype-pure buckets the gradient sync
plans (:func:`~distributed_tensorflow_tpu_torch.parallel.collectives.
plan_buckets`), and the port's AdamW is elementwise given the shared
step count, so the sliced update gives each element the bits the
replicated update gives it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from distributed_tensorflow_tpu_torch.parallel.collectives import (
    DEFAULT_BYTES_PER_PACK, ReduceOp, all_gather, plan_buckets,
    reduce_scatter)


def _ravel(leaf) -> torch.Tensor:
    """A leaf as one 1-D tensor: a tensor, or a sequence of tensors (a
    stacked leaf's layers) concatenated in order."""
    if isinstance(leaf, torch.Tensor):
        return leaf.reshape(-1)
    return torch.cat([t.reshape(-1) for t in leaf])


class ZeroPartition:
    """Static ZeRO partition plan over a flat list of parameter leaves
    (JAX ``:47``).

    Leaves pack into the buckets ``GradientBucketer`` plans for
    gradient sync (reverse leaf order), each bucket one 1-D vector
    zero-padded to a multiple of ``n_shards``; rank r owns the r-th
    equal slice of every bucket. Padding stays zero under AdamW. A leaf
    is anything with ``.shape`` and ``.dtype`` (a ``meta`` tensor plans
    without allocating)."""

    def __init__(self, leaves: Sequence, n_shards: int, *,
                 bytes_per_pack: int = DEFAULT_BYTES_PER_PACK,
                 reverse: bool = True):
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.shapes = [tuple(int(d) for d in x.shape) for x in leaves]
        self.sizes = [_prod(s) for s in self.shapes]
        self.dtypes = [x.dtype for x in leaves]
        self.buckets = plan_buckets(self.sizes, self.dtypes,
                                    bytes_per_pack, reverse=reverse)
        self.bucket_sizes = [sum(self.sizes[i] for i in b)
                             for b in self.buckets]
        self.padded_sizes = [s + (-s) % self.n_shards
                             for s in self.bucket_sizes]
        self.shard_sizes = [p // self.n_shards for p in self.padded_sizes]
        self.bucket_dtypes = [self.dtypes[b[0]] for b in self.buckets]

    def pack(self, leaves: Sequence) -> list[torch.Tensor]:
        """Leaves (tensors, or sequences of tensors for stacked leaves)
        → per-bucket flat padded 1-D vectors."""
        flats = []
        for b, bucket in enumerate(self.buckets):
            parts = [_ravel(leaves[i]) for i in bucket]
            pad = self.padded_sizes[b] - self.bucket_sizes[b]
            if pad:
                parts.append(parts[0].new_zeros(pad))
            flats.append(torch.cat(parts))
        return flats

    def unpack(self, flats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Per-bucket flat vectors (padded) → leaves, as views."""
        out: list = [None] * len(self.sizes)
        for b, bucket in enumerate(self.buckets):
            off = 0
            for i in bucket:
                out[i] = flats[b][off:off + self.sizes[i]].view(
                    self.shapes[i])
                off += self.sizes[i]
        return out

    def shard(self, flats: Sequence[torch.Tensor], rank: int
              ) -> list[torch.Tensor]:
        """This rank's slice of each packed bucket, as views."""
        return [f.narrow(0, rank * s, s)
                for f, s in zip(flats, self.shard_sizes)]

    def reduce_scatter_mean(self, leaves: Sequence, mesh: DeviceMesh,
                            axis_name: str) -> list[torch.Tensor]:
        """ZeRO-2 gradient sync: pack each bucket and reduce-scatter it
        over ``axis_name``; this rank gets its mean-reduced shard."""
        return [reduce_scatter(f, mesh, axis_name, axis=0, op=ReduceOp.MEAN)
                for f in self.pack(leaves)]

    def all_gather_flats(self, shards: Sequence[torch.Tensor],
                         mesh: DeviceMesh, axis_name: str
                         ) -> list[torch.Tensor]:
        return [all_gather(s, mesh, axis_name, axis=0, tiled=True)
                for s in shards]

    def summary(self) -> dict:
        return {"n_shards": self.n_shards,
                "buckets": len(self.buckets),
                "elements": sum(self.bucket_sizes),
                "padded_elements": sum(self.padded_sizes),
                "shard_elements": sum(self.shard_sizes)}


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def zero_opt_state(make_optimizer, partition: ZeroPartition,
                   param_shards: Sequence[torch.Tensor]):
    """The sharded optimizer (JAX ``:128``): ``make_optimizer(shards)``
    over one leaf tensor a bucket, copied from ``param_shards`` (this
    rank's slices of the packed parameters), with its state made now.
    Returns ``(optimizer, shards)``; each shard takes its gradient in
    ``.grad``. Raises unless the made state is all zero (AdamW's is), as
    the sharded state starts from zeros."""
    if len(param_shards) != len(partition.shard_sizes):
        raise ValueError(f"{len(param_shards)} shards for "
                         f"{len(partition.shard_sizes)} buckets")
    shards = [s.detach().clone() for s in param_shards]
    opt = make_optimizer(shards)
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.moments(p, group)
            for v in state.values():
                nonzero = (bool(v.any()) if isinstance(v, torch.Tensor)
                           else bool(v))
                if nonzero:
                    raise ValueError(
                        "ZeRO sharding supports optimizers whose initial "
                        "state is all-zero (AdamW)")
    return opt, shards


def zero_state_bytes(n_params: int, n_shards: int, level: int,
                     *, param_bytes: int = 4, slot_bytes: int = 8,
                     grad_bytes: int = 4) -> int:
    """Analytic persistent + transient training-state bytes per device
    (JAX ``:248``): replicated P·(param + grad + slot); ZeRO-1 shards
    the slots; ZeRO-2 the gradient buffer too."""
    if level not in (0, 1, 2):
        raise ValueError(f"level must be 0, 1, or 2, got {level}")
    total = n_params * param_bytes
    total += (n_params * slot_bytes // n_shards if level >= 1
              else n_params * slot_bytes)
    total += (n_params * grad_bytes // n_shards if level >= 2
              else n_params * grad_bytes)
    return total


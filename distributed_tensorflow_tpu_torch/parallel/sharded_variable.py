"""ShardedVariable and partitioners — port of
``distributed_tensorflow_tpu/parallel/sharded_variable.py`` (≙ the
reference's ``sharded_variable.py``): first-axis div-sharding of large
(embedding) variables.

The partitioners are JAX's arithmetic, exactly. A
:class:`ShardedVariable` is a :class:`~distributed_tensorflow_tpu_torch.
parallel.values.DistributedVariable` whose rows are cut over one mesh dim
(``shard_axis_name``): this rank holds its block of the rows, padded to
a multiple of the dim's size, where JAX holds one row-sharded
``jax.Array``. The logical shard count (``num_shards``, from the
partitioner) is kept for the checkpoint layout (:attr:`variables`).
``read_value`` gathers the rows (a collective over the dim: every rank
of it calls it); :meth:`~ShardedVariable.embedding_lookup` gathers the
ids each rank owns and sums the shards with one all-reduce. With no
mesh (one process) the variable is one shard.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.values import (
    DistributedVariable,
    VariableAggregation,
    VariableSynchronization,
)


class Partitioner:
    """Base partitioner (≙ sharded_variable.py:47): ``partitioner(shape,
    dtype) -> list[int]``, one entry an axis, only axis 0 above 1."""

    def __call__(self, shape, dtype) -> list[int]:
        raise NotImplementedError

    @staticmethod
    def _dtype_size(dtype) -> int:
        if isinstance(dtype, torch.dtype):
            return torch.empty((), dtype=dtype).element_size()
        return np.dtype(dtype).itemsize


class FixedShardsPartitioner(Partitioner):
    """≙ sharded_variable.py:84."""

    def __init__(self, num_shards: int):
        self.num_shards = num_shards

    def __call__(self, shape, dtype) -> list[int]:
        result = [1] * len(shape)
        result[0] = min(self.num_shards, shape[0])
        return result


class MinSizePartitioner(Partitioner):
    """≙ sharded_variable.py:115: as many shards as possible while each
    keeps at least ``min_shard_bytes``."""

    def __init__(self, min_shard_bytes: int = 256 << 10, max_shards: int = 1):
        if min_shard_bytes < 1:
            raise ValueError("min_shard_bytes must be positive")
        self.min_shard_bytes = min_shard_bytes
        self.max_shards = max_shards

    def __call__(self, shape, dtype) -> list[int]:
        total = math.prod(shape) * self._dtype_size(dtype)
        shards = min(self.max_shards, max(1, total // self.min_shard_bytes),
                     shape[0] if shape else 1)
        result = [1] * len(shape)
        result[0] = max(1, int(shards))
        return result


class MaxSizePartitioner(Partitioner):
    """≙ sharded_variable.py:176: as few shards as possible while each
    keeps at most ``max_shard_bytes``."""

    def __init__(self, max_shard_bytes: int, max_shards: int | None = None):
        if max_shard_bytes < 1:
            raise ValueError("max_shard_bytes must be positive")
        self.max_shard_bytes = max_shard_bytes
        self.max_shards = max_shards

    def __call__(self, shape, dtype) -> list[int]:
        total = math.prod(shape) * self._dtype_size(dtype)
        shards = max(1, -(-total // self.max_shard_bytes))  # ceil div
        if self.max_shards is not None:
            shards = min(shards, self.max_shards)
        shards = min(shards, shape[0] if shape else 1)
        result = [1] * len(shape)
        result[0] = int(shards)
        return result


class ShardedVariable(DistributedVariable):
    """Axis-0 sharded variable (≙ sharded_variable.py:843): this rank's
    block of the padded rows over ``mesh``'s ``shard_axis_name`` dim
    (module docstring). ``value`` is the global value, the same on
    every rank; ``device`` where the block lives (default: the value's)."""

    def __init__(self, value, *, mesh=None, shard_axis_name: str = "ps_shard",
                 num_shards: int | None = None, name=None,
                 trainable: bool = True, dtype=None, device=None):
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
        if mesh is not None and shard_axis_name not in names:
            raise ValueError(
                f"axis {shard_axis_name!r} not in mesh {names}")
        n = mesh.size(names.index(shard_axis_name)) if mesh is not None \
            else 1
        self.shard_axis_name = shard_axis_name
        self.num_shards = num_shards or n
        value = torch.as_tensor(value)
        if dtype is not None:
            value = value.to(dtype)
        if device is not None:
            value = value.to(device)
        if value.dim() < 1:
            raise ValueError("ShardedVariable requires rank >= 1")
        self._num_rows = value.shape[0]
        self._pad_rows = (-value.shape[0]) % n
        spec = (shard_axis_name,) + (None,) * (value.dim() - 1)
        padded = self._pad(value)
        block = (padded.chunk(n, 0)[mesh.get_local_rank(shard_axis_name)]
                 .clone() if n > 1 else padded.clone())
        super().__init__(
            block, name=name, mesh=mesh if n > 1 else None,
            spec=spec if n > 1 else None, shape=tuple(value.shape),
            trainable=trainable,
            synchronization=VariableSynchronization.ON_WRITE,
            aggregation=VariableAggregation.NONE)

    def _pad(self, value: torch.Tensor) -> torch.Tensor:
        if not self._pad_rows:
            return value
        return torch.cat([value, value.new_zeros(
            (self._pad_rows,) + tuple(value.shape[1:]))])

    def read_value(self) -> torch.Tensor:
        """The global value, a tensor of its own (JAX's is immutable; an
        ``assign`` does not change what an earlier read returned)."""
        v = super().read_value()
        return v.clone() if v.data_ptr() == self._local().data_ptr() else v

    @property
    def variables(self) -> list[np.ndarray]:
        """Per-logical-shard slices of the global value (≙
        ``ShardedVariable.variables``): the checkpoint layer saves them
        as slices of one logical tensor."""
        rows = self.shape[0]
        per = -(-rows // self.num_shards)
        full = self.read_value().cpu().numpy()
        return [full[i * per: min((i + 1) * per, rows)]
                for i in range(self.num_shards)]

    def embedding_lookup(self, ids) -> torch.Tensor:
        """``value[ids]`` on every rank (≙ sharded_variable.py:995): each
        rank gathers the ids its block holds, zeroes the rest, and one
        all-reduce over the shard dim sums the blocks."""
        local = self._local()
        ids = torch.as_tensor(ids, device=local.device).long()
        if self._mesh is None:
            return local[ids]
        from distributed_tensorflow_tpu_torch.parallel.tensor_parallel \
            import TensorParallel, vocab_parallel_embed
        tp = TensorParallel.from_mesh(self._mesh, self.shard_axis_name)
        return vocab_parallel_embed(local, ids, tp)

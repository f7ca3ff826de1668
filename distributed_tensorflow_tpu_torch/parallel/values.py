"""Distributed values and variables — port of what checkpointing needs of
``distributed_tensorflow_tpu/parallel/values.py``.

JAX's variable is one global ``jax.Array`` whose sharding encodes the
policy. Here a variable holds **this rank's local shard** (a tensor, or
a ``read``/``write`` pair over tensors that live elsewhere, e.g. a
model's per-layer parameters), the ``DeviceMesh`` and the spec it was
cut by: one mesh axis name (or None) a dim, as
``models/transformer.param_specs`` gives it.

- :meth:`DistributedVariable.read_value` is the global value, as JAX's:
  the shards gathered over the axes of the spec (``gather``, by default
  each cut dim all-gathered and joined in rank order, then cut back to
  the logical ``shape``); an ON_READ variable reduces its per-replica
  rows over the mesh with ``aggregation``.
- :meth:`DistributedVariable.assign` takes a global value and writes
  this rank's block of it (``scatter``, by default each cut dim padded
  to a multiple of its axis' size and chunked), in place.

So a checkpoint of variables is topology-free: it holds global values,
and a restore onto another mesh writes each rank's new block.
:class:`PerReplica`, :class:`Mirrored` and :func:`select_replica` are
JAX's containers.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Sequence

import torch

from distributed_tensorflow_tpu_torch.parallel.collectives import (
    ReduceOp, all_gather, all_reduce)


class VariableSynchronization(enum.Enum):
    AUTO = "auto"
    ON_WRITE = "on_write"   # mirrored: every replica holds the same value
    ON_READ = "on_read"     # per-replica state, reduced when read globally


class VariableAggregation(enum.Enum):
    NONE = "none"
    SUM = "sum"
    MEAN = "mean"
    ONLY_FIRST_REPLICA = "only_first_replica"


class DistributedValues:
    """Base of :class:`PerReplica` / :class:`Mirrored`."""

    def __init__(self, values: Sequence):
        if not values:
            raise ValueError("DistributedValues requires at least one value")
        self._values = tuple(values)

    @property
    def values(self) -> tuple:
        return self._values

    def __len__(self) -> int:
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __repr__(self) -> str:
        return f"{type(self).__name__}({list(self._values)!r})"


class PerReplica(DistributedValues):
    """One (possibly different) value per replica."""


class Mirrored(DistributedValues):
    """Same value on each replica."""

    @property
    def primary(self):
        return self._values[0]


def select_replica(replica_id: int, structured):
    """Each :class:`DistributedValues` leaf of a nest of dicts, lists
    and tuples replaced by its ``replica_id``'th value."""
    if isinstance(structured, DistributedValues):
        return structured.values[replica_id]
    if isinstance(structured, dict):
        return {k: select_replica(replica_id, v)
                for k, v in structured.items()}
    if isinstance(structured, (list, tuple)):
        return type(structured)(select_replica(replica_id, v)
                                for v in structured)
    return structured


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def gather_dims(local: torch.Tensor, mesh, spec: tuple, shape) -> torch.Tensor:
    """The global value of ``local`` cut by ``spec``: each cut dim
    all-gathered over its axes (outermost axis first), then cut back to
    ``shape`` (a padded dim's pad rows dropped)."""
    t = local
    names = _mesh_names(mesh)
    for dim, entry in enumerate(spec):
        for axis in reversed([a for a in _axes(entry) if a in names]):
            if mesh.size(names.index(axis)) > 1:
                t = all_gather(t.contiguous(), mesh, axis, axis=dim)
    return t[tuple(slice(0, n) for n in shape)].clone()


def scatter_dims(full: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of ``full`` cut by ``spec``: each cut dim padded
    with zeros to a multiple of its axes' size and chunked."""
    t = full
    names = _mesh_names(mesh)
    for dim, entry in enumerate(spec):
        for axis in [a for a in _axes(entry) if a in names]:
            n = mesh.size(names.index(axis))
            if n == 1:
                continue
            rows = -(-t.shape[dim] // n) * n
            if rows != t.shape[dim]:
                pad = list(t.shape)
                pad[dim] = rows - t.shape[dim]
                t = torch.cat([t, t.new_zeros(pad)], dim)
            t = t.chunk(n, dim)[mesh.get_local_rank(axis)]
    return t.contiguous()


class DistributedVariable:
    """A named, mutable, possibly sharded variable (module docstring).

    ``value`` is this rank's local shard, or None with ``read`` /
    ``write`` (``read() -> local tensor``, ``write(local)`` in place).
    ``shape`` is the global shape (default: the local shape grown by the
    size of each cut dim's axes). ``gather(local) -> global`` and
    ``scatter(global) -> local`` replace :func:`gather_dims` /
    :func:`scatter_dims` for layouts that are not contiguous blocks."""

    _NAME_LOCK = threading.Lock()
    _UID = 0

    def __init__(self, value=None, *, name: str | None = None, mesh=None,
                 spec: tuple | None = None, shape=None,
                 trainable: bool = True,
                 synchronization: VariableSynchronization =
                 VariableSynchronization.ON_WRITE,
                 aggregation: VariableAggregation = VariableAggregation.NONE,
                 dtype=None, read: Callable | None = None,
                 write: Callable | None = None,
                 gather: Callable | None = None,
                 scatter: Callable | None = None):
        if name is None:
            with DistributedVariable._NAME_LOCK:
                name = f"variable_{DistributedVariable._UID}"
                DistributedVariable._UID += 1
        if (value is None) == (read is None):
            raise ValueError("give a value or read/write, not both")
        self.name = name
        self.trainable = trainable
        self.synchronization = synchronization
        self.aggregation = aggregation
        self._mesh = mesh
        if value is not None:
            value = torch.as_tensor(value)
            if dtype is not None:
                value = value.to(dtype)
        self._value = value
        self._read = read
        self._write = write
        local = self._local()
        self._spec = tuple(spec) if spec is not None else (None,) * local.dim()
        self._gather = gather
        self._scatter = scatter
        if shape is None:
            names = _mesh_names(mesh)
            shape = list(local.shape)
            for dim, entry in enumerate(self._spec):
                for axis in _axes(entry):
                    if axis in names:
                        shape[dim] *= mesh.size(names.index(axis))
            if synchronization is VariableSynchronization.ON_READ:
                shape = shape[1:]
        self._shape = tuple(shape)

    def _local(self) -> torch.Tensor:
        return self._value if self._read is None else self._read()

    # -- reads ------------------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        """This rank's local shard."""
        return self._local()

    def read_value(self) -> torch.Tensor:
        """The global value (collective when the variable is cut or
        ON_READ: every rank of the mesh calls it)."""
        local = self._local().detach()
        if self.synchronization is VariableSynchronization.ON_READ:
            return self._reduce_on_read(local)
        if self._gather is not None:
            return self._gather(local)
        if self._mesh is None or not any(_axes(e) for e in self._spec):
            return local
        return gather_dims(local, self._mesh, self._spec, self._shape)

    def _reduce_on_read(self, local: torch.Tensor) -> torch.Tensor:
        """ON_READ: ``local`` holds this rank's per-replica rows (a
        leading axis cut by the spec's first entry); the global read
        aggregates every replica's."""
        axes = tuple(a for a in _axes(self._spec[0])
                     if a in _mesh_names(self._mesh))
        agg = self.aggregation
        if agg is VariableAggregation.ONLY_FIRST_REPLICA:
            if self._mesh is None or not axes:
                return local[0].clone()
            rows = gather_dims(local, self._mesh, self._spec[:1],
                               (local.shape[0] * self._replicas(axes),))
            return rows[0].clone()
        if agg is VariableAggregation.NONE:
            return local.clone()
        total = local.sum(0)
        if self._mesh is not None and axes:
            total = all_reduce(total, self._mesh, axes, ReduceOp.SUM)
        if agg is VariableAggregation.MEAN:
            n = local.shape[0] * (self._replicas(axes) if axes else 1)
            total = total / n
        return total

    def _replicas(self, axes) -> int:
        names = _mesh_names(self._mesh)
        n = 1
        for a in axes:
            n *= self._mesh.size(names.index(a))
        return n

    def numpy(self):
        return self.read_value().cpu().numpy()

    @property
    def shape(self) -> tuple:
        """The global shape (JAX's ``.shape``)."""
        return self._shape

    @property
    def dtype(self):
        return self._local().dtype

    @property
    def spec(self) -> tuple:
        return self._spec

    # -- writes -----------------------------------------------------------
    @torch.no_grad()
    def assign(self, value) -> "DistributedVariable":
        """Write the global ``value``: this rank keeps its block, in
        place."""
        local = self._local()
        value = torch.as_tensor(value).to(device=local.device,
                                          dtype=local.dtype)
        if tuple(value.shape) != self._shape:
            raise ValueError(f"assign shape {tuple(value.shape)} != "
                             f"variable shape {self._shape}")
        if self.synchronization is VariableSynchronization.ON_READ:
            # the global value lands on the first replica row, the
            # others zero: a SUM read gives it back
            block = torch.zeros_like(local)
            if self._replica_index() == 0:
                block[0] = value
        elif self._scatter is not None:
            block = self._scatter(value)
        elif self._mesh is None or not any(_axes(e) for e in self._spec):
            block = value
        else:
            block = scatter_dims(value, self._mesh, self._spec)
        if self._read is None:
            self._value.copy_(block)
        else:
            self._write(block)
        return self

    def _replica_index(self) -> int:
        idx = 0
        names = _mesh_names(self._mesh)
        for a in _axes(self._spec[0]):
            if a in names:
                idx = idx * self._mesh.size(names.index(a)) + \
                    self._mesh.get_local_rank(a)
        return idx

    def assign_add(self, delta) -> "DistributedVariable":
        return self.assign(self.read_value() + torch.as_tensor(delta))

    def assign_sub(self, delta) -> "DistributedVariable":
        return self.assign(self.read_value() - torch.as_tensor(delta))

    def __repr__(self) -> str:
        return (f"DistributedVariable(name={self.name!r}, "
                f"shape={self._shape}, dtype={self.dtype}, "
                f"spec={self._spec}, sync={self.synchronization.value})")


class MirroredVariable(DistributedVariable):
    """Replicated variable: every rank holds the whole value."""

    def __init__(self, value, *, mesh=None, name=None,
                 trainable: bool = True,
                 aggregation: VariableAggregation = VariableAggregation.MEAN,
                 dtype=None):
        super().__init__(
            value, name=name, mesh=mesh, trainable=trainable,
            synchronization=VariableSynchronization.ON_WRITE,
            aggregation=aggregation, dtype=dtype)


class SyncOnReadVariable(DistributedVariable):
    """Per-replica state reduced on global read: the local value is this
    rank's replica rows, a leading axis cut over ``data_axes``."""

    def __init__(self, per_replica_value, *, mesh, data_axes: tuple = ("dp",),
                 name=None,
                 aggregation: VariableAggregation = VariableAggregation.SUM,
                 dtype=None):
        value = torch.as_tensor(per_replica_value)
        spec = (tuple(data_axes),) + (None,) * (value.dim() - 1)
        super().__init__(
            value, name=name, mesh=mesh, spec=spec, trainable=False,
            synchronization=VariableSynchronization.ON_READ,
            aggregation=aggregation, dtype=dtype)

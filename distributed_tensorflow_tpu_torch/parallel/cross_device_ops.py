"""Cross-device reductions (host-level API) — port of
``distributed_tensorflow_tpu/parallel/cross_device_ops.py``.

JAX compiles one tiny SPMD program a reduction; here each replica is a
rank, and a reduction runs on the process group of the strategy's data
dims (NCCL on the card, gloo on the CPU). The inputs keep JAX's host
view: a :class:`PerReplica` holds every replica's value on every rank,
and rank r contributes value r; a plain value is every replica's. The
result is a :class:`Mirrored` of the reduced value on every rank.

- :class:`ReductionToOneDevice` — every replica's value gathered, then
  reduced (any op).
- :class:`IciAllReduce` (≙ the reference's ``NcclAllReduce``, also
  under that name) — SUM / MEAN as all-reduces over flat buckets of at
  most ``bytes_per_pack`` bytes that never mix dtypes (JAX
  ``:133-176``, ``collectives.plan_buckets``); an integer MEAN is
  computed in f32 and cast back, as JAX's is. Other ops take the
  gather path.
- :class:`HierarchicalAllReduce` — over two dims ``(outer, inner)``:
  reduce-scatter on the inner dim, all-reduce on the outer, all-gather
  on the inner (``collectives.hierarchical_all_reduce``).
- :func:`select_cross_device_ops` — JAX's choice.

With no mesh (one replica) every reduction is the value itself.
"""

from __future__ import annotations

from typing import Sequence

import torch

from distributed_tensorflow_tpu_torch.cluster import topology as topo
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    CommunicationOptions, ReduceOp)
from distributed_tensorflow_tpu_torch.parallel.values import (
    DistributedValues, Mirrored)


def _as_per_replica_list(value, num_replicas: int) -> list:
    if isinstance(value, DistributedValues):
        if len(value.values) != num_replicas:
            raise ValueError(f"{len(value.values)} values for "
                             f"{num_replicas} replicas")
        return list(value.values)
    return [value] * num_replicas


def canonical_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor with JAX's default dtypes (64-bit numpy and
    Python numbers become 32-bit, as ``jnp.asarray`` makes them)."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(x)
        if t.dtype == torch.float64:
            t = t.float()
        elif t.dtype == torch.int64:
            t = t.int()
    return t.to(device) if device is not None else t


def _reduce_stack(stacked: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """JAX's ``jnp.sum/mean/max/min(stacked, axis=0)``, dtypes kept
    (an integer mean is float32, as ``jnp.mean`` gives it)."""
    if op is ReduceOp.SUM:
        return stacked.sum(0).to(stacked.dtype)
    if op is ReduceOp.MEAN:
        if not stacked.is_floating_point():
            stacked = stacked.float()
        return stacked.mean(0)
    if op is ReduceOp.MAX:
        return stacked.amax(0)
    if op is ReduceOp.MIN:
        return stacked.amin(0)
    if op is ReduceOp.PROD:
        return stacked.prod(0).to(stacked.dtype)
    raise ValueError(f"Unsupported op {op}")


class CrossDeviceOps:
    """Reduction API (JAX ``:48``): ``reduce`` / ``batch_reduce`` take
    :class:`PerReplica` values and return :class:`Mirrored` results.
    ``mesh`` None is one replica."""

    def __init__(self, mesh=None, axis_names: Sequence[str] = ("dp",),
                 options: CommunicationOptions | None = None, *,
                 device=None):
        self.mesh = mesh
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            self.axis_names = tuple(a for a in axis_names if a in names)
            if not self.axis_names:
                raise ValueError(f"No reduction axes among {axis_names} "
                                 f"on mesh {names}")
        else:
            self.axis_names = tuple(axis_names)
        self.options = options or CommunicationOptions()
        if device is None:
            device = (torch.device("cpu") if mesh is None
                      or mesh.device_type == "cpu"
                      else torch.device("cuda", torch.cuda.current_device()))
        self.device = torch.device(device)

    @property
    def num_replicas(self) -> int:
        if self.mesh is None:
            return 1
        return topo.mesh_axis_size(self.mesh, *self.axis_names)

    @property
    def replica_index(self) -> int:
        if self.mesh is None:
            return 0
        return collectives.axis_index(self.mesh, self.axis_names)

    def _own(self, vals: list) -> torch.Tensor:
        return canonical_tensor(vals[self.replica_index], self.device)

    # -- public API -------------------------------------------------------
    def reduce(self, reduce_op, per_replica_value, options=None) -> Mirrored:
        op = ReduceOp.from_any(reduce_op)
        vals = _as_per_replica_list(per_replica_value, self.num_replicas)
        out = self._reduce_list([vals], op, self.options.merge(options))[0]
        return Mirrored([out] * self.num_replicas)

    def batch_reduce(self, reduce_op, value_list, options=None) -> list:
        """Many tensors in one call (the gradient-sync shape)."""
        op = ReduceOp.from_any(reduce_op)
        lists = [_as_per_replica_list(v, self.num_replicas)
                 for v in value_list]
        outs = self._reduce_list(lists, op, self.options.merge(options))
        return [Mirrored([o] * self.num_replicas) for o in outs]

    def broadcast(self, value, source_replica: int = 0) -> Mirrored:
        vals = _as_per_replica_list(value, self.num_replicas)
        return Mirrored([vals[source_replica]] * self.num_replicas)

    def gather(self, per_replica_value, axis: int = 0) -> torch.Tensor:
        vals = _as_per_replica_list(per_replica_value, self.num_replicas)
        return torch.cat([canonical_tensor(v, self.device) for v in vals],
                         dim=axis)

    # -- implementation ---------------------------------------------------
    def _gathered(self, vals: list) -> torch.Tensor:
        """Every replica's value, stacked in replica order, gathered from
        the replicas' own contributions."""
        own = self._own(vals)
        if self.mesh is None:
            return own[None]
        return collectives.all_gather(own.unsqueeze(0).contiguous(),
                                      self.mesh, self.axis_names)

    def _reduce_list(self, lists: list, op: ReduceOp,
                     options: CommunicationOptions) -> list:
        raise NotImplementedError


class ReductionToOneDevice(CrossDeviceOps):
    """Gather every replica's value, then reduce (JAX ``:94``)."""

    def _reduce_list(self, lists, op, options):
        return [_reduce_stack(self._gathered(vals), op) for vals in lists]


class IciAllReduce(CrossDeviceOps):
    """Bucketed all-reduce (≙ NcclAllReduce, JAX ``:113``): tensors are
    flattened and packed into single-dtype buckets of
    ``options.bytes_per_pack`` (0: one bucket a dtype run), each bucket
    one collective, then split back."""

    def _reduce_list(self, lists, op, options):
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            return ReductionToOneDevice._reduce_list(self, lists, op, options)
        own = [self._own(vals) for vals in lists]
        sizes = [t.numel() for t in own]
        outs: list = [None] * len(own)
        for bucket in self._pack_buckets(sizes, options.bytes_per_pack,
                                         [t.dtype for t in own]):
            dt = own[bucket[0]].dtype
            flat = torch.cat([own[i].reshape(-1) for i in bucket])
            integer_mean = op is ReduceOp.MEAN and not dt.is_floating_point
            if integer_mean:
                flat = flat.float()
            if self.mesh is not None:
                flat = collectives.all_reduce(flat, self.mesh,
                                              self.axis_names, ReduceOp.SUM)
            if op is ReduceOp.MEAN:
                flat = flat / self.num_replicas
            if integer_mean:
                flat = flat.to(dt)
            off = 0
            for i in bucket:
                outs[i] = flat[off:off + sizes[i]].reshape(own[i].shape)
                off += sizes[i]
        return outs

    @staticmethod
    def _pack_buckets(sizes, bytes_per_pack, dtypes):
        """JAX's dtype-aware ``group_by_size``: a dtype change closes a
        bucket; a leaf reaching ``bytes_per_pack`` closes its bucket with
        it."""
        if not isinstance(dtypes, (list, tuple)):
            dtypes = [dtypes] * len(sizes)
        return collectives.plan_buckets(sizes, dtypes, bytes_per_pack)


NcclAllReduce = IciAllReduce


class HierarchicalAllReduce(CrossDeviceOps):
    """Two-level reduce over ``axis_names = (outer, inner)`` (JAX
    ``:186``)."""

    def __init__(self, mesh, axis_names=("dcn", "dp"), options=None, *,
                 device=None):
        super().__init__(mesh, axis_names, options, device=device)
        if len(self.axis_names) != 2:
            raise ValueError("HierarchicalAllReduce needs exactly 2 axes "
                             "(outer/slow, inner/fast)")

    def _reduce_list(self, lists, op, options):
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise ValueError("HierarchicalAllReduce supports SUM and MEAN")
        outer, inner = self.axis_names
        outs = []
        for vals in lists:
            out = collectives.hierarchical_all_reduce(
                self._own(vals), self.mesh, inner_axis=inner,
                outer_axis=outer, op=ReduceOp.SUM)
            if op is ReduceOp.MEAN:
                out = out / self.num_replicas
            outs.append(out)
        return outs


def select_cross_device_ops(mesh, axis_names: Sequence[str] = ("dp",),
                            options: CommunicationOptions | None = None,
                            *, device=None) -> CrossDeviceOps:
    """JAX ``:242``: the hierarchical form on two dims both larger than
    one, :class:`ReductionToOneDevice` when every dim is 1 (or no mesh),
    else :class:`IciAllReduce`."""
    if mesh is None:
        return ReductionToOneDevice(None, axis_names, options, device=device)
    shape = topo.mesh_shape(mesh)
    names = tuple(a for a in axis_names if a in shape)
    if len(names) == 2 and all(shape[a] > 1 for a in names):
        return HierarchicalAllReduce(mesh, names, options, device=device)
    if sum(shape[a] for a in names) <= len(names):
        return ReductionToOneDevice(mesh, names, options, device=device)
    return IciAllReduce(mesh, names, options, device=device)

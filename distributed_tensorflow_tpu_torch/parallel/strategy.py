"""Strategy API: scope / run / reduce over the ranks of a mesh — port of
``distributed_tensorflow_tpu/parallel/strategy.py``.

JAX's strategy is single-controller: one process holds every replica,
``run`` traces ``fn`` once under ``shard_map`` and ``compile_step`` is
``jax.jit``, GSPMD inserting the gradient reduction. The port runs one
process per card, so:

- **Replicas are ranks.** ``num_replicas_in_sync`` is the product of
  the sizes of the strategy's data dims of its ``DeviceMesh``; with no
  process group there is one replica and no mesh.
- **``run`` keeps JAX's host view on every rank.** A
  :class:`PerReplica` argument holds R values and rank r takes value
  r; any other argument (a batch from the port's distributed dataset is
  already the rank's own rows) is passed as it is. ``fn`` runs once,
  eagerly, under a :class:`ReplicaContext` whose collectives go over
  the data dims' group. Its outputs are all-gathered into a
  :class:`PerReplica` of R values on every rank, so ``reduce`` and
  ``gather`` give every rank JAX's answer.
- **Variables.** Inside ``run`` a strategy variable reads this
  replica's value and its writes are recorded
  (``values.replica_overlay``); after ``fn`` each written ON_WRITE
  variable is aggregated over the data dims (MEAN, SUM or
  ONLY_FIRST_REPLICA, JAX ``:529-545``), an ON_READ variable keeps its
  replica's row and reduces on a read outside ``run``.
- **``compile_step``** returns a step that runs eagerly (no
  ``torch.compile``). On more than one replica it synchronises the
  gradients of the step's state: the step's ``state`` holds the model
  (an ``nn.Module``) and its optimizer (a ``torch.optim.Optimizer``);
  the strategy's gradient bucketer is hooked into the parameters'
  backward (``GradientBucketer.backward_sync``, MEAN: the mean of the
  replicas' equal-sized shards' gradients is the global batch's) and
  finished by an optimizer step pre-hook, so the optimizer steps on
  the synchronised gradients; the step's floating-point outputs are
  meaned over the replicas. A state with no model or no optimizer, or
  a step whose optimizer never stepped, raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel import values as values_lib
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    CommunicationOptions, ReduceOp)
from distributed_tensorflow_tpu_torch.parallel.cross_device_ops import (
    CrossDeviceOps, _reduce_stack, canonical_tensor,
    select_cross_device_ops)
from distributed_tensorflow_tpu_torch.parallel.values import (
    DistributedValues, DistributedVariable, MirroredVariable, PerReplica,
    SyncOnReadVariable, VariableAggregation, VariableSynchronization,
    _overlay, replica_overlay)
from distributed_tensorflow_tpu_torch.utils import tree

# ---------------------------------------------------------------------------
# Context plumbing
# ---------------------------------------------------------------------------

_CTX = threading.local()


def _strategy_stack() -> list:
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
    return _CTX.stack


def get_strategy() -> "Strategy":
    stack = _strategy_stack()
    if not stack:
        raise RuntimeError("No strategy in scope; use `with strategy.scope():`")
    return stack[-1]


def has_strategy() -> bool:
    return bool(_strategy_stack())


def get_replica_context() -> "ReplicaContext | None":
    return getattr(_CTX, "replica_context", None)


def in_cross_replica_context() -> bool:
    return has_strategy() and get_replica_context() is None


@contextlib.contextmanager
def _replica_context(ctx: "ReplicaContext | None"):
    prev = getattr(_CTX, "replica_context", None)
    _CTX.replica_context = ctx
    try:
        yield
    finally:
        _CTX.replica_context = prev


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_cuda() -> torch.device:
    """This rank's card, ``cuda:LOCAL_RANK``; raises with no CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass a CPU device "
            "(devices=['cpu'] / '/cpu:0') to run on the CPU")
    return torch.device("cuda", _local_rank())


def resolve_device(d) -> torch.device:
    """A device from JAX's strings ("/gpu:0", "/cpu:0",
    "/device:GPU:1", "cuda:1", "cpu") or a ``torch.device``; a CUDA
    device with no CUDA raises."""
    if isinstance(d, torch.device):
        dev = d
    else:
        s = str(d).lower().strip("/").replace("device:", "")
        kind, _, idx = s.rpartition(":") if ":" in s else (s, "", "")
        kind = {"gpu": "cuda"}.get(kind, kind)
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {d!r}")
        dev = (torch.device(kind, int(idx)) if idx.isdigit()
               and kind == "cuda" else torch.device(kind))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {d!r} requested but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", _local_rank())
    return dev


# ---------------------------------------------------------------------------
# ReplicaContext
# ---------------------------------------------------------------------------

class ReplicaContext:
    """Per-replica API inside ``Strategy.run`` (JAX ``:178``): the
    collectives run over the strategy's data dims; ``merge_call`` runs
    ``merge_fn(strategy, ...)`` in cross-replica context."""

    def __init__(self, strategy: "Strategy"):
        self.strategy = strategy

    @property
    def num_replicas_in_sync(self) -> int:
        return self.strategy.num_replicas_in_sync

    @property
    def replica_id_in_sync_group(self) -> int:
        return self.strategy.replica_id

    def all_reduce(self, reduce_op, value, options=None):
        op = ReduceOp.from_any(reduce_op)
        return tree.tree_map(lambda v: self.strategy._all_reduce(v, op),
                             value)

    def all_gather(self, value, axis: int = 0, options=None):
        return tree.tree_map(lambda v: self.strategy._all_gather(v, axis),
                             value)

    def reduce_scatter(self, value, axis: int = 0, reduce_op=ReduceOp.SUM):
        op = ReduceOp.from_any(reduce_op)
        s = self.strategy

        def one(v):
            v = s._tensor(v)
            if s.mesh is None:
                return v.clone()
            if len(s.data_axis_names) != 1:
                raise ValueError("reduce_scatter needs a single replica axis")
            return collectives.reduce_scatter(v, s.mesh,
                                              s.data_axis_names[0],
                                              axis=axis, op=op)
        return tree.tree_map(one, value)

    def collective_permute(self, value, perm):
        s = self.strategy
        if len(s.data_axis_names) != 1:
            raise ValueError("collective_permute needs a single replica axis")

        def one(v):
            v = s._tensor(v)
            if s.mesh is None:
                return v.clone() if (0, 0) in list(perm) else \
                    torch.zeros_like(v)
            return collectives.permute(v, s.mesh, s.data_axis_names[0], perm)
        return tree.tree_map(one, value)

    def all_to_all(self, value, split_axis: int, concat_axis: int):
        s = self.strategy

        def one(v):
            v = s._tensor(v)
            if s.mesh is None:
                return v.clone()
            group = collectives.axis_group(s.mesh, s.data_axis_names)
            return collectives._all_to_all(v, group, split_axis,
                                           concat_axis)
        return tree.tree_map(one, value)

    def merge_call(self, merge_fn: Callable, args=(), kwargs=None):
        with _replica_context(None):
            return merge_fn(self.strategy, *args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# StrategyExtended
# ---------------------------------------------------------------------------

class StrategyExtended:
    """The lower-level API (JAX ``:238``)."""

    def __init__(self, strategy: "Strategy"):
        self._strategy = strategy

    @property
    def worker_devices(self) -> tuple:
        return (self._strategy.device,)

    @property
    def parameter_devices(self) -> tuple:
        return (self._strategy.device,)

    def reduce_to(self, reduce_op, value, destinations=None, options=None):
        """Inside ``run`` (a merge call included): an all-reduce over the
        data dims of this replica's value. Outside: the cross-device
        ops' reduction of a :class:`PerReplica` (a :class:`Mirrored`)."""
        op = ReduceOp.from_any(reduce_op)
        if _overlay() is not None:
            return tree.tree_map(lambda v: self._strategy._all_reduce(v, op),
                                 value)
        return self._strategy.cross_device_ops.reduce(op, value,
                                                      options=options)

    def batch_reduce_to(self, reduce_op, value_and_destination_pairs,
                        options=None):
        return [self.reduce_to(reduce_op, v, d, options)
                for v, d in value_and_destination_pairs]

    def call_for_each_replica(self, fn, args=(), kwargs=None):
        return self._strategy.run(fn, args=args, kwargs=kwargs)

    def variable_created_in_scope(self, v) -> bool:
        return any(v is var for var in self._strategy.variables)

    def update(self, var: DistributedVariable, fn, args=(), kwargs=None):
        """``fn(var, *args)`` once, in cross-replica context."""
        with _replica_context(None):
            return fn(var, *args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# Strategy
# ---------------------------------------------------------------------------

def _is_dist(v) -> bool:
    return isinstance(v, DistributedValues)


class Strategy:
    """Base strategy over a ``DeviceMesh`` (JAX ``:287``). ``mesh`` None
    with a process group is every rank on ``{"dp": world}``; with none,
    one replica. ``device`` is this rank's device (default: the mesh's
    device type, ``cuda:LOCAL_RANK`` on the card)."""

    #: whether ``mesh=None`` under a process group spans the world
    _world_mesh = True

    def __init__(self, mesh=None,
                 data_axis_names: Sequence[str] = (topo_lib.DATA_AXIS,),
                 cross_device_ops: CrossDeviceOps | None = None,
                 communication_options: CommunicationOptions | None = None,
                 *, device=None):
        if device is not None:
            device = resolve_device(device)
        if mesh is None and dist.is_initialized() and self._world_mesh:
            mesh = topo_lib.make_mesh(
                device=device.type if device is not None else "cuda")
        if device is None:
            device = (torch.device("cpu") if mesh is not None
                      and mesh.device_type == "cpu" else local_cuda())
        self.device = device
        self.mesh = mesh
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            self.data_axis_names = (tuple(a for a in data_axis_names
                                          if a in names) or names[:1])
        else:
            self.data_axis_names = tuple(data_axis_names)[:1]
        self.communication_options = (communication_options
                                      or CommunicationOptions())
        self.cross_device_ops = cross_device_ops or select_cross_device_ops(
            mesh, self.data_axis_names, communication_options,
            device=device)
        self.extended = StrategyExtended(self)
        self._variables: list[DistributedVariable] = []

    # -- basic facts ------------------------------------------------------
    @property
    def num_replicas_in_sync(self) -> int:
        if self.mesh is None:
            return 1
        return topo_lib.mesh_axis_size(self.mesh, *self.data_axis_names)

    @property
    def replica_id(self) -> int:
        """This rank's replica index (row-major over the data dims)."""
        if self.mesh is None:
            return 0
        return collectives.axis_index(self.mesh, self.data_axis_names)

    @property
    def replica_devices(self) -> list:
        return [self.device]

    @property
    def variables(self) -> list[DistributedVariable]:
        return list(self._variables)

    # -- collectives over the data dims ---------------------------------
    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, DistributedVariable):
            v = v.value
        return canonical_tensor(v, self.device)

    def _all_reduce(self, v, op: ReduceOp) -> torch.Tensor:
        v = self._tensor(v)
        if self.mesh is None:
            return v.clone() if op is not ReduceOp.MEAN or \
                v.is_floating_point() else v.float()
        if op is ReduceOp.MEAN and not v.is_floating_point():
            v = v.float()
        return collectives.all_reduce(v, self.mesh, self.data_axis_names, op)

    def _all_gather(self, v, axis: int = 0) -> torch.Tensor:
        v = self._tensor(v)
        if self.mesh is None:
            return v.clone()
        return collectives.all_gather(v.contiguous(), self.mesh,
                                      self.data_axis_names, axis=axis)

    # -- scope ------------------------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        """Variables created inside belong to this strategy; models
        built inside take it."""
        from distributed_tensorflow_tpu_torch.utils.summary import (
            api_gauge, strategy_gauge)
        strategy_gauge.set(type(self).__name__)
        api_gauge.set("scope")
        _strategy_stack().append(self)
        try:
            yield self
        finally:
            _strategy_stack().pop()

    def create_variable(self, value, *, name=None, trainable=True,
                        synchronization=VariableSynchronization.AUTO,
                        aggregation=VariableAggregation.NONE,
                        dtype=None) -> DistributedVariable:
        """A MirroredVariable (AUTO / ON_WRITE; aggregation MEAN unless
        given) or a SyncOnReadVariable (ON_READ: this rank's replica row,
        starting from the init value), on this rank's device."""
        val = canonical_tensor(value, self.device)
        if dtype is not None:
            val = val.to(dtype)
        if synchronization in (VariableSynchronization.AUTO,
                               VariableSynchronization.ON_WRITE):
            var = MirroredVariable(
                val.clone(), mesh=self.mesh, name=name, trainable=trainable,
                aggregation=(aggregation
                             if aggregation is not VariableAggregation.NONE
                             else VariableAggregation.MEAN))
        else:
            var = SyncOnReadVariable(
                val.unsqueeze(0).clone(), mesh=self.mesh,
                data_axes=self.data_axis_names, name=name,
                aggregation=aggregation)
        self._variables.append(var)
        return var

    # -- data -------------------------------------------------------------
    def experimental_distribute_dataset(self, dataset, options=None):
        from distributed_tensorflow_tpu_torch.input.dataset import (
            DistributedDataset)
        return DistributedDataset(dataset, self, options=options)

    def distribute_datasets_from_function(self, dataset_fn, options=None):
        """``dataset_fn(InputContext)`` builds this rank's pipeline (one
        input pipeline a rank); its batches are this replica's own."""
        from distributed_tensorflow_tpu_torch.input.dataset import (
            DistributedDataset, InputContext)
        world, rank = ((dist.get_world_size(), dist.get_rank())
                       if dist.is_initialized() else (1, 0))
        ctx = InputContext(num_input_pipelines=world,
                           input_pipeline_id=rank,
                           num_replicas_in_sync=self.num_replicas_in_sync)
        return DistributedDataset(dataset_fn(ctx), self, options=options,
                                  per_replica=True)

    def experimental_distribute_values_from_function(self, value_fn):
        """``value_fn(ValueContext)`` for every replica id: a
        :class:`PerReplica` of R values on every rank."""
        R = self.num_replicas_in_sync
        return PerReplica([value_fn(ValueContext(rid, R))
                           for rid in range(R)])

    # -- run --------------------------------------------------------------
    def _local_arg(self, v):
        if _is_dist(v):
            if len(v.values) != self.num_replicas_in_sync:
                raise ValueError(
                    f"{len(v.values)} per-replica values for "
                    f"{self.num_replicas_in_sync} replicas")
            v = v.values[self.replica_id]
        if isinstance(v, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool)):
            return canonical_tensor(v, self.device)
        return v

    def run(self, fn: Callable, args=(), kwargs=None) -> Any:
        """Run ``fn`` as this rank's replica (module docstring); returns
        its outputs as :class:`PerReplica` values of every replica."""
        kwargs = kwargs or {}
        largs, lkwargs = tree.tree_map(self._local_arg, (args, kwargs),
                                       is_leaf=_is_dist)
        ctx = ReplicaContext(self)
        with self.scope(), replica_overlay(self._variables) as ov, \
                _replica_context(ctx):
            out = fn(*largs, **lkwargs)
            out = tree.tree_map(
                lambda x: x.value if isinstance(x, DistributedVariable)
                else x, out,
                is_leaf=lambda x: isinstance(x, DistributedVariable))
        self._write_back(ov)
        return self._unstack_outputs(out)

    def _write_back(self, overlay: dict):
        """The recorded writes, aggregated over the data dims in the
        order the variables were created (every rank the same)."""
        axes = self.data_axis_names
        for var in self._variables:
            _, cur, written = overlay[id(var)]
            if not written:
                continue
            if var.synchronization is VariableSynchronization.ON_READ:
                local = var._local().clone()
                local[0] = cur
                var._set_local(local)
                continue
            if self.mesh is not None:
                agg = var.aggregation
                if agg is VariableAggregation.MEAN:
                    cur = collectives.all_reduce(cur, self.mesh, axes,
                                                 ReduceOp.MEAN).to(cur.dtype)
                elif agg is VariableAggregation.SUM:
                    cur = collectives.all_reduce(cur, self.mesh, axes,
                                                 ReduceOp.SUM)
                elif agg is VariableAggregation.ONLY_FIRST_REPLICA:
                    cur = collectives.broadcast(cur, self.mesh, axes, 0)
            var._set_local(cur)

    def _unstack_outputs(self, out):
        """Every output leaf gathered into a :class:`PerReplica` of the
        R replicas' values (host-consumed, not the hot path)."""
        R = self.num_replicas_in_sync

        def unstack(x):
            if not isinstance(x, (torch.Tensor, np.ndarray, np.generic,
                                  int, float, bool)):
                return x
            t = canonical_tensor(x, self.device)
            if R == 1:
                return PerReplica([t])
            g = collectives.all_gather(t.unsqueeze(0).contiguous(),
                                       self.mesh, self.data_axis_names)
            return PerReplica(list(g.unbind(0)))
        return tree.tree_map(unstack, out)

    # -- reduce (host side) -----------------------------------------------
    def reduce(self, reduce_op, value, axis=None):
        """Reduce a :class:`PerReplica` across replicas (and within each
        over ``axis``), as JAX's host-side ``reduce``."""
        op = ReduceOp.from_any(reduce_op)
        vals = [self._tensor(v) for v in (value.values if _is_dist(value)
                                           else [value])]
        if axis is not None:
            vals = [_reduce_stack(v.movedim(axis, 0), op) for v in vals]
        return _reduce_stack(torch.stack(vals), op)

    def gather(self, value, axis: int = 0):
        """The replicas' values concatenated along ``axis``."""
        if _is_dist(value):
            return torch.cat([self._tensor(v) for v in value.values],
                             dim=axis)
        return self._tensor(value)

    # -- native path ------------------------------------------------------
    def shard_batch(self, batch):
        """This replica's contiguous rows of a host global batch, on this
        rank's device (pinned and copied ``non_blocking`` on the card)."""
        R, r = self.num_replicas_in_sync, self.replica_id

        def rows(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            n = t.shape[0]
            if n % R:
                raise ValueError(f"global batch {n} is not divisible by "
                                 f"{R} replicas")
            t = t[r * (n // R):(r + 1) * (n // R)]
            if self.device.type == "cuda" and t.device.type == "cpu":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return tree.tree_map(rows, batch)

    def replicate(self, tree_):
        """Every leaf the same on every replica, on this rank's device:
        tensors and arrays, a model's parameters and buffers and an
        optimizer's state are replica 0's."""
        def one(x):
            if isinstance(x, torch.nn.Module):
                x.to(self.device)
                self._broadcast_tensors(list(x.parameters())
                                        + list(x.buffers()))
                return x
            if isinstance(x, torch.optim.Optimizer):
                self._broadcast_tensors(
                    [v for st in x.state.values() for v in st.values()
                     if isinstance(v, torch.Tensor)])
                return x
            if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
                t = canonical_tensor(x, self.device).clone()
                self._broadcast_tensors([t])
                return t
            return x
        return tree.tree_map(one, tree_)

    def _broadcast_tensors(self, tensors):
        if self.mesh is None or self.num_replicas_in_sync == 1:
            return
        with torch.no_grad():
            for t in tensors:
                t.copy_(collectives.broadcast(t.detach(), self.mesh,
                                              self.data_axis_names, 0))

    def init_state(self, init_fn: Callable, *args, sharding_rules=None,
                   **kwargs):
        """``init_fn(*args, **kwargs)`` replicated (mirrored state), or,
        with ``sharding_rules``, placed by a tree of specs of the state's
        structure (JAX's ``PartitionSpec`` tree): a spec is a tuple with
        one entry per array dim (a mesh dim name, a tuple of names, or
        None), and a None spec replicates. A leaf whose spec cuts a
        dim becomes a :class:`DistributedVariable` holding this rank's
        block (``parallel/values.scatter_dims``: the dim chunked over
        its names, outermost first, as JAX places it); a leaf that no
        spec cuts stays a replicated tensor."""
        state = self.replicate(init_fn(*args, **kwargs))
        if sharding_rules is None:
            return state
        leaves, td = tree.tree_flatten(state)
        specs = tree.td_leaves(td, sharding_rules)
        names = (tuple(self.mesh.mesh_dim_names)
                 if self.mesh is not None else ())
        out = []
        for leaf, spec in zip(leaves, specs):
            spec = tuple(spec or ())
            cut = [a for e in spec for a in
                   ((e,) if isinstance(e, str) else (e or ()))]
            if any(a not in names for a in cut):
                raise ValueError(f"spec {spec} names a dim not in the "
                                 f"mesh {names}")
            if not isinstance(leaf, torch.Tensor) or not cut:
                out.append(leaf)
                continue
            if len(spec) > leaf.dim():
                raise ValueError(f"spec {spec} has more entries than the "
                                 f"leaf's {leaf.dim()} dims")
            spec = spec + (None,) * (leaf.dim() - len(spec))
            out.append(DistributedVariable(
                values_lib.scatter_dims(leaf, self.mesh, spec),
                mesh=self.mesh, spec=spec, shape=tuple(leaf.shape)))
        return tree.tree_unflatten(td, out)

    def gradient_bucketer(self):
        """The bucketed gradient all-reduce over the data dims (None on
        one replica); the hierarchical form on a ``dcn`` × ``dp`` mesh.
        Pack size: ``CommunicationOptions.bytes_per_pack`` (0: 4 MiB)."""
        if self.num_replicas_in_sync <= 1:
            return None
        axes = self.data_axis_names
        bpp = (self.communication_options.bytes_per_pack
               or collectives.DEFAULT_BYTES_PER_PACK)
        shape = topo_lib.mesh_shape(self.mesh)
        outer = inner = None
        if (len(axes) == 2 and axes[0] == topo_lib.DCN_AXIS
                and all(shape[a] > 1 for a in axes)):
            outer, inner = axes
        return collectives.GradientBucketer(
            self.mesh, axes, bytes_per_pack=bpp, outer_axis=outer,
            inner_axis=inner)

    def compile_step(self, step_fn: Callable, donate_state: bool = True):
        """``step_fn(state, batch) -> (state, aux)`` as an eager step
        whose gradients are synchronised over the replicas (module
        docstring). ``donate_state`` is accepted for compatibility."""
        del donate_state
        return SyncedStep(self, step_fn)


class SyncedStep:
    """:meth:`Strategy.compile_step`'s step."""

    def __init__(self, strategy: Strategy, step_fn: Callable):
        self.strategy = strategy
        self.step_fn = step_fn

    @staticmethod
    def _model_and_optimizer(state):
        leaves = tree.tree_leaves(state)
        models = [x for x in leaves if isinstance(x, torch.nn.Module)]
        opts = [x for x in leaves if isinstance(x, torch.optim.Optimizer)]
        if not opts:
            raise ValueError(
                "compile_step on more than one replica synchronises the "
                "gradients of the state's optimizer: the state must hold "
                "the model (an nn.Module) and its optimizer (a "
                "torch.optim.Optimizer)")
        return models, opts

    def __call__(self, state, batch, *rest):
        s = self.strategy
        if s.num_replicas_in_sync == 1:
            with s.scope():
                return self.step_fn(state, batch, *rest)
        _, opts = self._model_and_optimizer(state)
        params = [p for opt in opts for g in opt.param_groups
                  for p in g["params"] if p.requires_grad]
        sync = s.gradient_bucketer().backward_sync([[p] for p in params],
                                                   ReduceOp.MEAN)
        finished = []

        def pre_hook(opt, args, kwargs):
            if not finished:
                sync.finish()
                finished.append(True)
        handles = [opt.register_step_pre_hook(pre_hook) for opt in opts]
        try:
            with s.scope():
                new_state, aux = self.step_fn(state, batch, *rest)
        finally:
            for h in handles:
                h.remove()
            sync.remove()
        if not finished:
            raise RuntimeError(
                "the step's optimizer never stepped, so its gradients were "
                "never synchronised over the replicas")
        return new_state, tree.tree_map(self._mean, aux)

    def _mean(self, x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return self.strategy._all_reduce(x.detach(), ReduceOp.MEAN)
        return x


class ValueContext:
    """≙ tf.distribute.experimental.ValueContext."""

    def __init__(self, replica_id_in_sync_group: int,
                 num_replicas_in_sync: int):
        self.replica_id_in_sync_group = replica_id_in_sync_group
        self.num_replicas_in_sync = num_replicas_in_sync

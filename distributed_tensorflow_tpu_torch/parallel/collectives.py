"""Typed collectives over a mesh's process groups, and the bucketed
gradient all-reduce — port of ``distributed_tensorflow_tpu/parallel/
collectives.py``.

JAX's collectives are ``lax`` ops inside one SPMD program, named by mesh
axis. Here each call names the mesh and its axes, and runs on the
axis's process group (NCCL on the card, gloo on the CPU). Every
function returns a new tensor and leaves its input alone. ``MEAN`` is
``SUM`` followed by division by the group's size, as ``lax.pmean`` is
(``ReduceOp.AVG`` differs between gloo, NCCL and torch versions).

:func:`plan_buckets` is pure Python over sizes and dtype names, so its
plans equal JAX's element for element. :class:`GradientBucketer`
reduces a list of gradients one bucket at a time, and
:meth:`GradientBucketer.backward_sync` launches each bucket's
collective from inside the backward pass, as soon as that bucket and
every bucket planned before it have their gradients.

The tensor-parallel boundaries :func:`tp_copy` / :func:`tp_reduce`
(also the MoE layer's over ``ep``), :func:`fsdp_gather` (a weight
sharded over ``fsdp`` gathered on use, its gradient reduce-scattered)
and :func:`gather_keep_shard` (the MoE router over ``ep``).

Sequence parallelism's collectives: :class:`Ring` and
:class:`RingExchange` (JAX's ``ppermute`` round a mesh dim: one
``batch_isend_irecv`` a shift), :func:`ring_shift` (differentiable, its
gradient the reverse shift), :func:`all_to_all` (``jax.lax.all_to_all``
with ``tiled=True``, differentiable) and :class:`AllToAllV` (uneven
blocks, for the striped relayout).
"""

from __future__ import annotations

import dataclasses
import enum
import weakref
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class ReduceOp(enum.Enum):
    """≙ tf.distribute.ReduceOp plus the nccl_ops op set."""

    SUM = "sum"
    MEAN = "mean"
    PROD = "prod"
    MIN = "min"
    MAX = "max"

    @classmethod
    def from_any(cls, op) -> "ReduceOp":
        if isinstance(op, cls):
            return op
        return cls(str(op).lower())


_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MEAN: dist.ReduceOp.SUM,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}

AxisName = str | Sequence[str]


def _names(axis_names: AxisName) -> tuple:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def axis_group(mesh: DeviceMesh, axis_names: AxisName):
    """The process group of one mesh dim, or of all of them (the world
    the mesh spans). A reduction over another subset of several dims
    runs dim by dim (:func:`all_reduce`)."""
    names = _names(axis_names)
    dims = tuple(mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if sorted(names) == sorted(dims):
        return dist.group.WORLD
    raise NotImplementedError(
        f"a collective over {names} of a mesh with dims {dims}: only one "
        f"dim or all of them")


def _reduce_groups(mesh: DeviceMesh, axis_names: AxisName) -> list:
    """The groups a reduction over ``axis_names`` runs on in turn: one
    for a single dim or for all of them, else one a dim (the data axes
    ``("dcn", "dp")`` of a ``("dcn", "dp", "tp")`` mesh)."""
    names = _names(axis_names)
    if len(names) == 1 or sorted(names) == sorted(mesh.mesh_dim_names):
        return [axis_group(mesh, names)]
    return [mesh.get_group(n) for n in names]


def axis_size(mesh: DeviceMesh, axis_names: AxisName) -> int:
    n = 1
    for name in _names(axis_names):
        n *= mesh.size(tuple(mesh.mesh_dim_names).index(name))
    return n


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis_names: AxisName,
               op: ReduceOp | str = ReduceOp.SUM) -> torch.Tensor:
    """REDUCTION over ``axis_names`` (JAX ``:146``); over no axes, a
    copy."""
    op = ReduceOp.from_any(op)
    out = x.clone()
    for group in _reduce_groups(mesh, axis_names):
        dist.all_reduce(out, op=_DIST_OP[op], group=group)
    if op is ReduceOp.MEAN:
        out = out / axis_size(mesh, axis_names)
    return out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
               axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """GATHER (JAX ``:167``): ``tiled`` concatenates along ``axis``,
    else stacks a new leading axis."""
    group = axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    src = x.movedim(axis, 0).contiguous() if tiled else x.contiguous()
    # gathered into one concatenation (gloo takes no stacked output),
    # viewed as the stack when untiled
    flat = src if src.ndim else src.reshape(1)
    out = flat.new_empty((n * flat.shape[0],) + tuple(flat.shape[1:]))
    dist.all_gather_into_tensor(out, flat, group=group)
    if tiled:
        return out.movedim(0, axis)
    return out.view((n,) + tuple(src.shape))


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
                   axis: int = 0, op: ReduceOp | str = ReduceOp.SUM
                   ) -> torch.Tensor:
    """REDUCE_SCATTER along ``axis`` (JAX ``:174``), SUM or MEAN; the
    axis must divide by the group size."""
    op = ReduceOp.from_any(op)
    if op not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError("reduce_scatter supports SUM and MEAN")
    group = axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    src = x.movedim(axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {axis} of shape {tuple(x.shape)} does not "
                         f"divide by {n} ranks of {axis_name!r}")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    if op is ReduceOp.MEAN:
        out = out / n
    return out.movedim(0, axis)


# ---------------------------------------------------------------------------
# Tensor-parallel boundaries (the f / g pair of Megatron-LM)
# ---------------------------------------------------------------------------

def _count(cls, t: torch.Tensor):
    cls.calls += 1
    cls.bytes += t.numel() * t.element_size()


class CopyToGroup(torch.autograd.Function):
    """Identity forward, SUM all-reduce of the gradient over ``group``
    backward: where a replicated activation enters column-parallel
    weights, each rank's gradient of it is a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        _count(CopyToGroup, g)
        return g, None


class ReduceFromGroup(torch.autograd.Function):
    """SUM all-reduce over ``group`` forward, identity backward: where
    row-parallel weights' partial outputs become one replicated
    activation, whose gradient every rank already holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        _count(ReduceFromGroup, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`CopyToGroup` over ``group`` (the mesh's ``tp`` group)."""
    return CopyToGroup.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`ReduceFromGroup` over ``group`` (the mesh's ``tp``
    group)."""
    return ReduceFromGroup.apply(x, group)


#: all-reduces each boundary ran (the copy's in the backward, the
#: reduction's in the forward) and their bytes (a plain count, as the
#: kernels' launch counters)
CopyToGroup.calls = CopyToGroup.bytes = 0
ReduceFromGroup.calls = ReduceFromGroup.bytes = 0


# ---------------------------------------------------------------------------
# Gathered weights: fully-sharded data parallelism's gather on use, and
# the gather of a shard whose full gradient every rank holds
# ---------------------------------------------------------------------------

def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class FsdpGather(torch.autograd.Function):
    """A weight stored sharded along ``dim`` over ``group`` (the mesh's
    ``fsdp`` dim) made whole where it is used. Forward: the shard cast
    to ``dtype``, all-gathered (the cast commutes with the gather bit
    for bit, and a bf16 gather moves half the bytes). Backward: the
    whole weight's gradient in f32, reduce-scattered (SUM) back to the
    shard — each rank's shard then holds its slice of the gradient
    summed over the group's data shards. Under remat the gather runs
    again in the recompute, so a rank holds one layer's whole weights
    at a time."""

    @staticmethod
    def forward(ctx, shard, dtype, group, dim):
        ctx.group, ctx.dim = group, dim
        out = _gather_dim(shard.to(dtype), group, dim)
        _count(FsdpGather, out)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        src = g.float().movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        FsdpGather.scatters += 1
        FsdpGather.scatter_bytes += src.numel() * src.element_size()
        return out.movedim(0, ctx.dim).contiguous(), None, None, None


#: all-gathers (``calls``, ``bytes`` gathered) and reduce-scatters
#: (``scatters``, ``scatter_bytes`` of the whole gradients) run
FsdpGather.calls = FsdpGather.bytes = 0
FsdpGather.scatters = FsdpGather.scatter_bytes = 0


def fsdp_gather(shard: torch.Tensor, dtype, group, dim: int
                ) -> torch.Tensor:
    """:class:`FsdpGather`: ``shard`` cast to ``dtype`` and all-gathered
    along ``dim`` over ``group``; its gradient reduce-scattered in
    f32."""
    return FsdpGather.apply(shard, dtype, group, dim)


class GatherKeepShard(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` forward; backward keeps
    this rank's slice of the gradient. For a weight stored sharded whose
    whole gradient every rank of the group computes identically (the
    MoE router over ``ep``: routing repeats on every rank), so each
    keeps its own slice: no reduction, not a reduce-scatter."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.dim, ctx.n = dim, shard.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.n
        return _gather_dim(shard, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None


def gather_keep_shard(shard: torch.Tensor, group, dim: int
                      ) -> torch.Tensor:
    """:class:`GatherKeepShard` of ``shard`` along ``dim`` over
    ``group``."""
    return GatherKeepShard.apply(shard, group, dim)


# ---------------------------------------------------------------------------
# Sequence-parallel collectives: the ring shift (JAX's ppermute over "sp")
# and the all-to-all, each with its transpose as its gradient
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ring:
    """A mesh dim as a ring: ``ranks``, the global ranks of this rank's
    dim group in index order, and ``index``, this rank's place among
    them. Index ``i`` sends to ``i + 1`` and receives from ``i − 1``
    (mod the size), as JAX's ``ppermute`` with ``perm = [(i, (i + 1) %
    n)]``. The sends go over the default group, to global ranks."""
    ranks: tuple
    index: int

    @classmethod
    def of(cls, mesh: DeviceMesh, axis: str) -> "Ring":
        return cls(tuple(dist.get_process_group_ranks(mesh.get_group(axis))),
                   mesh.get_local_rank(axis))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` places along the ring."""
        return self.ranks[(self.index + shift) % self.size]


class RingExchange:
    """Tensors in flight around a :class:`Ring`: each sent ``shift``
    places on and its counterpart received from ``shift`` places back,
    all in one ``dist.batch_isend_irecv`` (two blocking calls would
    deadlock on NCCL at size 2, where next and previous are one rank).
    :meth:`wait` returns the received tensors. ``tag`` numbers the
    messages (gloo matches by it; NCCL by order, the same on every
    rank). At size 1 nothing is sent and the tensors come back as
    they are."""

    def __init__(self, tensors, ring: Ring, shift: int = 1, tag: int = 0):
        self.works = []
        if ring.size == 1:
            self.out = list(tensors)
            return
        self.out = [torch.empty_like(t) for t in tensors]
        ops = []
        for i, (t, r) in enumerate(zip(tensors, self.out)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  ring.peer(shift), tag=tag + i))
            ops.append(dist.P2POp(dist.irecv, r, ring.peer(-shift),
                                  tag=tag + i))
        self.works = dist.batch_isend_irecv(ops)
        RingExchange.sends += len(tensors)
        RingExchange.bytes += sum(t.numel() * t.element_size()
                                  for t in tensors)

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        self.works = []
        return self.out


#: tensors sent and their bytes, counted by every exchange that sends
#: (a plain count, as the kernels' launch counters)
RingExchange.sends = 0
RingExchange.bytes = 0


class RingShift(torch.autograd.Function):
    """:class:`RingExchange` of one tensor as an op: forward shifts by
    ``shift``, backward shifts the gradient back by ``-shift`` (JAX's
    transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, ring, shift):
        ctx.ring, ctx.shift = ring, shift
        return RingExchange([x], ring, shift).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return RingExchange([g], ctx.ring, -ctx.shift).wait()[0], None, None


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str = "sp",
               shift: int = 1) -> torch.Tensor:
    """``x`` of the rank ``shift`` places back along ``axis``'s dim group
    (this rank's goes ``shift`` places on): JAX's ``ppermute`` over the
    ring; differentiable (:class:`RingShift`)."""
    return RingShift.apply(x, Ring.of(mesh, axis), shift)


def _all_to_all(x, group, split_axis: int, concat_axis: int):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of shape "
                         f"{tuple(x.shape)} does not divide by {n} ranks")
    if n == 1:
        return x.clone()
    inp = torch.stack(x.chunk(n, dim=split_axis))
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class AllToAll(torch.autograd.Function):
    """The tiled all-to-all over ``group``; its gradient is the inverse
    all-to-all (split and concatenation axes swapped), as JAX's
    transpose."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, concat_axis, split_axis
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: ``x`` split into n blocks along ``split_axis``, block
    j sent to rank j of the dim group, and the blocks received
    concatenated along ``concat_axis`` in rank order. Differentiable
    (:class:`AllToAll`)."""
    return AllToAll.apply(x, axis_group(mesh, axis_name), split_axis,
                          concat_axis)


def _all_to_all_v(x, group, send_counts, recv_counts):
    if dist.get_world_size(group) == 1:
        return x.clone()
    out = x.new_empty((sum(recv_counts),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(recv_counts),
                           list(send_counts), group=group)
    return out


class AllToAllV(torch.autograd.Function):
    """The all-to-all of uneven blocks along dim 0: ``send_counts[j]``
    rows to rank j, ``recv_counts[i]`` rows from rank i, concatenated in
    rank order; its gradient is the same exchange with the counts
    swapped."""

    @staticmethod
    def forward(ctx, x, group, send_counts, recv_counts):
        ctx.args = group, recv_counts, send_counts
        return _all_to_all_v(x, group, send_counts, recv_counts)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_v(g, *ctx.args), None, None, None


# ---------------------------------------------------------------------------
# Hierarchical reduction (≙ HierarchicalCopyAllReduce)
# ---------------------------------------------------------------------------

def _hierarchical_flat(flat, mesh, inner_axis: str, outer_axis: str):
    """scatter(inner) -> reduce(outer) -> gather(inner) on a 1-D vector."""
    size = flat.shape[0]
    n_inner = axis_size(mesh, inner_axis)
    pad = (-size) % n_inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = reduce_scatter(flat, mesh, inner_axis)
    dist.all_reduce(shard, group=axis_group(mesh, outer_axis))
    full = all_gather(shard, mesh, inner_axis)
    return full[:size]


def hierarchical_all_reduce(x: torch.Tensor, mesh: DeviceMesh,
                            inner_axis: str, outer_axis: str,
                            op: ReduceOp | str = ReduceOp.SUM,
                            *, chunks: int = 1) -> torch.Tensor:
    """Two-level all-reduce (JAX ``:256``): reduce-scatter on the fast
    inner axis, all-reduce the shard on the slow outer axis, all-gather
    back on the inner axis, so each outer hop moves 1/|inner| of the
    bytes. ``chunks > 1`` splits the vector into that many independent
    chains; the arithmetic of each element is unchanged."""
    op = ReduceOp.from_any(op)
    if op not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError("hierarchical_all_reduce supports SUM and MEAN")
    flat = x.reshape(-1)
    n = flat.shape[0]
    chunks = max(1, min(int(chunks), n or 1))
    seg = -(-n // chunks)
    parts = [flat[i * seg:(i + 1) * seg] for i in range(chunks)]
    full = torch.cat([_hierarchical_flat(p, mesh, inner_axis, outer_axis)
                      for p in parts if p.shape[0]])
    out = full.reshape(x.shape)
    if op is ReduceOp.MEAN:
        out = out / (axis_size(mesh, inner_axis)
                     * axis_size(mesh, outer_axis))
    return out


# ---------------------------------------------------------------------------
# Reverse-order bucketed gradient collectives
# ---------------------------------------------------------------------------

#: default bucket size when packing is on but unconfigured (JAX ``:311``)
DEFAULT_BYTES_PER_PACK = 4 * 1024 * 1024

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype or of a dtype name ("float32",
    "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def plan_buckets(sizes: Sequence[int], dtypes: Sequence,
                 bytes_per_pack: int, *, reverse: bool = False
                 ) -> list[list[int]]:
    """Greedy size-bucketing of flattened-tensor indices (JAX ``:314``).

    A dtype change closes the current bucket (packing never casts). A
    bucket closes once its bytes reach ``bytes_per_pack``, the leaf that
    reaches it included; ``bytes_per_pack=0`` packs each dtype run into
    one bucket. ``reverse=True`` emits the buckets in reverse leaf
    order."""
    n = len(sizes)
    order = range(n - 1, -1, -1) if reverse else range(n)
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in order:
        dt = dtype_name(dtypes[i])
        if cur and dt != cur_dtype:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_dtype = dt
        cur_bytes += int(sizes[i]) * _ITEMSIZE[dt]
        if bytes_per_pack and cur_bytes >= bytes_per_pack:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _numel(x) -> int:
    n = 1
    for d in x.shape:
        n *= int(d)
    return n


class GradientBucketer:
    """Packs gradients into size-bounded single-dtype buckets and reduces
    each bucket as one collective over ``axis_names`` of ``mesh``, in
    reverse leaf order (JAX ``:354``). With ``outer_axis``/``inner_axis``
    (a hybrid ``("dcn", "dp")`` mesh) each bucket takes
    :func:`hierarchical_all_reduce`. Packing concatenates and never
    changes an element's reduction.

    A leaf is anything with ``.shape`` and ``.dtype`` for planning (a
    ``meta`` tensor plans without allocating)."""

    def __init__(self, mesh: DeviceMesh, axis_names: AxisName,
                 *, bytes_per_pack: int = DEFAULT_BYTES_PER_PACK,
                 reverse: bool = True,
                 outer_axis: str | None = None,
                 inner_axis: str | None = None):
        self.mesh = mesh
        self.axis_names = _names(axis_names)
        self.bytes_per_pack = int(bytes_per_pack)
        self.reverse = bool(reverse)
        if (outer_axis is None) != (inner_axis is None):
            raise ValueError("outer_axis and inner_axis must be set "
                             "together (hybrid mesh) or both omitted")
        self.outer_axis = outer_axis
        self.inner_axis = inner_axis

    def plan(self, leaves: Sequence) -> list[list[int]]:
        return plan_buckets([_numel(x) for x in leaves],
                            [x.dtype for x in leaves], self.bytes_per_pack,
                            reverse=self.reverse)

    def plan_summary(self, leaves: Sequence) -> list[dict]:
        """One ``{"leaves", "bytes", "dtype"}`` per bucket, in launch
        order (JAX's keys and values)."""
        out = []
        for bucket in self.plan(leaves):
            dt = dtype_name(leaves[bucket[0]].dtype)
            out.append({"leaves": len(bucket),
                        "bytes": sum(_numel(leaves[i]) * _ITEMSIZE[dt]
                                     for i in bucket),
                        "dtype": dt})
        return out

    def group_size(self) -> int:
        return axis_size(self.mesh, self.axis_names)

    def _reduce_flat(self, flat: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        """One bucket's reduction, out of place."""
        if self.outer_axis is not None:
            return hierarchical_all_reduce(
                flat, self.mesh, inner_axis=self.inner_axis,
                outer_axis=self.outer_axis, op=op)
        return all_reduce(flat, self.mesh, self.axis_names, op)

    def all_reduce(self, leaves: Sequence[torch.Tensor],
                   op: ReduceOp | str = ReduceOp.SUM) -> list[torch.Tensor]:
        """Bucketed all-reduce of a list of tensors (the gradient-sync
        shape); returns the reduced tensors in the input order."""
        op = ReduceOp.from_any(op)
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise ValueError("GradientBucketer supports SUM and MEAN")
        out: list = [None] * len(leaves)
        for bucket in self.plan(leaves):
            flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
            reduced = self._reduce_flat(flat, op)
            off = 0
            for i in bucket:
                n = _numel(leaves[i])
                out[i] = reduced[off:off + n].reshape(leaves[i].shape)
                off += n
        return out

    def backward_sync(self, leaf_params: Sequence[Sequence[torch.Tensor]],
                      op: ReduceOp | str = ReduceOp.MEAN
                      ) -> "BackwardSync":
        """Hook the bucketed reduction into the backward pass of
        ``leaf_params`` (leaf i of the plan is the concatenation of the
        parameters ``leaf_params[i]``, in order: one parameter, or the
        layers of a stacked leaf)."""
        return BackwardSync(self, leaf_params, ReduceOp.from_any(op))


class BackwardSync:
    """The overlapped gradient reduction of one set of parameters.

    Each parameter's ``register_post_accumulate_grad_hook`` marks it
    ready; once a bucket and every bucket planned before it are ready,
    the bucket's gradients are packed and its collective launched with
    ``async_op=True`` (every rank issues collectives in plan order,
    which NCCL needs). :meth:`finish`, after the backward, launches the
    buckets still waiting (gradients that never came count as zeros),
    waits for every collective and writes the reduced gradients to
    ``.grad``. On a hybrid mesh a bucket's three phases chain on a side
    stream on the card, so the backward's stream never waits for them.
    """

    def __init__(self, bucketer: GradientBucketer,
                 leaf_params: Sequence[Sequence[torch.Tensor]],
                 op: ReduceOp):
        if op not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise ValueError("BackwardSync supports SUM and MEAN")
        self.bucketer = bucketer
        self.op = op
        self.leaf_params = [list(ps) for ps in leaf_params]
        metas = [torch.empty((sum(p.numel() for p in ps),), dtype=ps[0].dtype,
                             device="meta") for ps in self.leaf_params]
        self.buckets = bucketer.plan(metas)
        self.bucket_params = [[p for i in b for p in self.leaf_params[i]]
                              for b in self.buckets]
        self._bucket_of = {id(p): b for b, ps in enumerate(self.bucket_params)
                           for p in ps}
        self._side = None
        # the hook holds this object weakly: a strong reference from the
        # parameters back to it would make a cycle through the tensors
        # that the garbage collector cannot see, keeping them alive
        ref = weakref.ref(self)

        def hook(p):
            sync = ref()
            if sync is not None:
                sync._hook(p)
        self._handles = [p.register_post_accumulate_grad_hook(hook)
                         for ps in self.bucket_params for p in ps]
        #: bucket indices in the order this rank launched them, last step
        self.launched: list[int] = []
        self.begin()

    def begin(self):
        """Reset for a new backward pass."""
        self._missing = [len(ps) for ps in self.bucket_params]
        self._seen: set = set()
        self._pending: list = []
        self._next = 0
        self.launched = []

    def _hook(self, p):
        if id(p) in self._seen:
            return
        self._seen.add(id(p))
        b = self._bucket_of[id(p)]
        self._missing[b] -= 1
        while (self._next < len(self.buckets)
               and self._missing[self._next] == 0):
            self._launch(self._next)

    def _launch(self, b: int):
        ps = self.bucket_params[b]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        bk = self.bucketer
        if bk.outer_axis is None:
            work = dist.all_reduce(flat, group=axis_group(bk.mesh,
                                                          bk.axis_names),
                                   async_op=True)
            self._pending.append((b, flat, flat, work, None))
        elif flat.is_cuda:
            if self._side is None:
                self._side = torch.cuda.Stream(device=flat.device)
            self._side.wait_stream(torch.cuda.current_stream(flat.device))
            with torch.cuda.stream(self._side):
                out = _hierarchical_flat(flat, bk.mesh, bk.inner_axis,
                                         bk.outer_axis)
            self._pending.append((b, flat, out, None, self._side))
        else:
            out = _hierarchical_flat(flat, bk.mesh, bk.inner_axis,
                                     bk.outer_axis)
            self._pending.append((b, flat, out, None, None))
        self.launched.append(b)
        self._next = b + 1

    def finish(self):
        """Launch what is left, wait, and write the reduced gradients."""
        while self._next < len(self.buckets):
            self._launch(self._next)
        n = self.bucketer.group_size()
        for b, _, flat, work, side in self._pending:
            if work is not None:
                work.wait()
            if side is not None:
                # made on the side stream, read from here on this one
                cur = torch.cuda.current_stream(flat.device)
                cur.wait_stream(side)
                flat.record_stream(cur)
            if self.op is ReduceOp.MEAN:
                flat = flat / n
            off = 0
            for p in self.bucket_params[b]:
                k = p.numel()
                p.grad = flat[off:off + k].view_as(p)
                off += k
        self._pending = []

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def simulate_overlap(ready_s: Sequence[float], dur_s: Sequence[float],
                     backward_end_s: float | None = None) -> dict:
    """The overlapped bucket schedule on one channel and what it hides
    (JAX ``:440``): bucket i starts at ``max(ready_s[i], previous
    finish)``. Returns ``serial_s`` (sum of durations), ``exposed_s``
    (how far the last bucket ends past ``backward_end_s``, default the
    last ready time), ``overlap_eff`` (1 − exposed/serial, None with no
    work) and ``finish_s``."""
    if len(ready_s) != len(dur_s):
        raise ValueError(f"{len(ready_s)} ready times vs "
                         f"{len(dur_s)} durations")
    finish: list[float] = []
    t = 0.0
    for ready, dur in zip(ready_s, dur_s):
        t = max(float(ready), t) + float(dur)
        finish.append(t)
    serial = float(sum(dur_s))
    bwd_end = (float(backward_end_s) if backward_end_s is not None
               else (max(ready_s) if ready_s else 0.0))
    exposed = max(0.0, (finish[-1] if finish else 0.0) - bwd_end)
    eff = None
    if serial > 0:
        eff = max(0.0, min(1.0, 1.0 - exposed / serial))
    return {"serial_s": serial, "exposed_s": exposed,
            "overlap_eff": eff, "finish_s": finish}

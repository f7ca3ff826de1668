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
"""

from __future__ import annotations

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
    the mesh spans). Other subsets of several dims belong to later
    slices."""
    names = _names(axis_names)
    dims = tuple(mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if sorted(names) == sorted(dims):
        return dist.group.WORLD
    raise NotImplementedError(
        f"a collective over {names} of a mesh with dims {dims}: only one "
        f"dim or all of them")


def axis_size(mesh: DeviceMesh, axis_names: AxisName) -> int:
    return dist.get_world_size(axis_group(mesh, axis_names))


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis_names: AxisName,
               op: ReduceOp | str = ReduceOp.SUM) -> torch.Tensor:
    """REDUCTION over ``axis_names`` (JAX ``:146``)."""
    op = ReduceOp.from_any(op)
    group = axis_group(mesh, axis_names)
    out = x.clone()
    dist.all_reduce(out, op=_DIST_OP[op], group=group)
    if op is ReduceOp.MEAN:
        out = out / dist.get_world_size(group)
    return out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis_name: str,
               axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """GATHER (JAX ``:167``): ``tiled`` concatenates along ``axis``,
    else stacks a new leading axis."""
    group = axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    src = x.movedim(axis, 0).contiguous() if tiled else x.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:])
                        if tiled else (n,) + tuple(src.shape))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, axis) if tiled else out


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

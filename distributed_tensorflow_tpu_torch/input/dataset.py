"""Datasets, auto-sharding and distributed iteration — port of
``distributed_tensorflow_tpu/input/dataset.py``.

- :class:`Dataset` — JAX's host dataset, transform for transform:
  elements stay numpy nests on the host, and every transformation's
  element stream is JAX's (``shuffle(seed)`` draws from
  ``np.random.default_rng(seed)`` as JAX's does). Nests follow
  ``jax.tree_util``'s leaf order (``utils/tree.py``).
- :class:`AutoShardPolicy`, :class:`InputOptions`,
  :class:`InputContext`, :func:`auto_shard_dataset` — JAX's.
- :class:`DistributedDataset` / :class:`DistributedIterator` — JAX's
  iterator puts each global batch on the mesh sharded over the data
  axes. Here a replica is a rank: the iterator gives this rank its
  contiguous rows of each global batch, pinned and copied
  ``non_blocking`` to the rank's device, staged on a background thread
  (``experimental_per_replica_buffer_size`` deep). A dataset from
  ``distribute_datasets_from_function`` is this rank's own pipeline,
  and its batches are placed whole. The ``input.prefetch`` fault site
  fires through ``resilience/faults.py``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import enum
import itertools
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.utils import profiler
from distributed_tensorflow_tpu_torch.utils import tree as tree_util

#: ≙ tf.data.AUTOTUNE: pass as ``num_parallel_calls`` to size the worker
#: pool from measured stage latency instead of hand-picking it.
AUTOTUNE = -1

_stage_counter = itertools.count(1)


def _stage_name(kind: str, name: str | None = None) -> str:
    return f"{kind}:{name}" if name else f"{kind}#{next(_stage_counter)}"


def _worker_cap() -> int:
    """Pool-size ceiling: cpu_count, floored at 2 so decode can overlap
    device compute even on one-core CI hosts."""
    return max(2, os.cpu_count() or 1)


def _check_parallel_calls(num_parallel_calls: int) -> None:
    if num_parallel_calls != AUTOTUNE and num_parallel_calls < 1:
        raise ValueError(
            f"num_parallel_calls must be >= 1 or AUTOTUNE, got "
            f"{num_parallel_calls}")


def _autotune_workers(src_s: float, fn_s: float) -> int:
    """AUTOTUNE's steady-state answer (≙ tf.data's autotune model,
    collapsed to its fixpoint): with upstream inter-arrival time
    ``src_s`` and per-element stage latency ``fn_s``, ``fn_s / src_s``
    concurrent calls keep the stage from being the bottleneck. Clamped
    to [1, :func:`_worker_cap`]; an instant upstream (src_s -> 0) gives
    the cap, an instant stage gives 1."""
    cap = _worker_cap()
    if fn_s <= 0:
        return 1
    return max(1, min(cap, round(fn_s / max(src_s, fn_s / cap, 1e-6))))


class AutoShardPolicy(enum.Enum):
    """≙ tf.data.experimental.AutoShardPolicy (input_ops.py:28)."""

    AUTO = "auto"
    FILE = "file"
    DATA = "data"
    OFF = "off"


@dataclasses.dataclass(frozen=True)
class InputOptions:
    """≙ tf.distribute.InputOptions (distribute_lib.py:1015)."""

    experimental_fetch_to_device: bool = True
    experimental_per_replica_buffer_size: int = 2
    experimental_replication_mode: str = "per_worker"
    auto_shard_policy: AutoShardPolicy = AutoShardPolicy.AUTO


class InputContext:
    """≙ tf.distribute.InputContext (distribute_lib.py:841)."""

    def __init__(self, num_input_pipelines: int = 1,
                 input_pipeline_id: int = 0,
                 num_replicas_in_sync: int = 1):
        self.num_input_pipelines = num_input_pipelines
        self.input_pipeline_id = input_pipeline_id
        self.num_replicas_in_sync = num_replicas_in_sync

    def get_per_replica_batch_size(self, global_batch_size: int) -> int:
        if global_batch_size % self.num_replicas_in_sync:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{self.num_replicas_in_sync} replicas")
        return global_batch_size // self.num_replicas_in_sync


# ---------------------------------------------------------------------------
# Host dataset
# ---------------------------------------------------------------------------

class Dataset:
    """A minimal functional host dataset.

    Sources: ``from_tensor_slices``, ``from_files``, ``from_generator``,
    ``range``. Transforms are lazy and compose: map, filter, shuffle, batch,
    repeat, take, skip, shard, interleave, cache, padded_batch, prefetch
    (+ Dataset.zip).
    Iteration yields numpy pytrees.
    """

    def __init__(self, gen_fn: Callable[[], Iterator], *,
                 files: Sequence[str] | None = None,
                 element_count: int | None = None):
        self._gen_fn = gen_fn
        self._files = list(files) if files else None
        self._element_count = element_count

    # -- sources ----------------------------------------------------------
    @classmethod
    def from_tensor_slices(cls, tensors) -> "Dataset":
        leaves = tree_util.tree_leaves(tensors)
        n = len(np.asarray(leaves[0]))

        def gen():
            arrs = tree_util.tree_map(np.asarray, tensors)
            for i in range(n):
                yield tree_util.tree_map(lambda a: a[i], arrs)

        return cls(gen, element_count=n)

    @classmethod
    def from_generator(cls, gen_fn: Callable[[], Iterator]) -> "Dataset":
        return cls(gen_fn)

    @classmethod
    def from_iterable(cls, it: Iterable) -> "Dataset":
        if isinstance(it, Dataset):
            return it
        # tf.data adapter: duck-typed on as_numpy_iterator
        if hasattr(it, "as_numpy_iterator"):
            return cls(lambda: iter(it.as_numpy_iterator()))
        if callable(it):
            return cls(it)
        materialized = list(it)
        return cls(lambda: iter(materialized),
                   element_count=len(materialized))

    @classmethod
    def from_files(cls, files: Sequence[str],
                   reader: Callable[[str], Iterator]) -> "Dataset":
        """File-based source; keeps the file list visible so AutoShardPolicy
        FILE can shard it (≙ input_ops.py FILE policy)."""
        files = list(files)

        def gen():
            for f in files:
                yield from reader(f)

        ds = cls(gen, files=files)
        ds._reader = reader
        return ds

    @classmethod
    def range(cls, *args) -> "Dataset":
        r = range(*args)
        return cls(lambda: iter(r), element_count=len(r))

    # -- transforms -------------------------------------------------------
    def _derive(self, gen_fn, element_count=None, op=None) -> "Dataset":
        """Derived dataset. ``op`` (Callable[[Dataset], Dataset]) replays
        this transform on a replacement source — shard_files uses the
        recorded chain to re-apply every transform on top of the SHARDED
        file source (tf.data's FILE auto-shard rewrites the source node
        the same way, input_ops.py:28)."""
        ds = Dataset(gen_fn, files=self._files, element_count=element_count)
        if hasattr(self, "_reader"):
            ds._reader = self._reader
        ds._parent = self
        ds._op = op
        return ds

    def map(self, fn: Callable,
            num_parallel_calls: int | None = None,
            name: str | None = None) -> "Dataset":
        """Apply ``fn`` per element. ``num_parallel_calls`` (int or
        :data:`AUTOTUNE`) fans the calls out over an ordered thread
        pool — element order stays BIT-IDENTICAL to the serial path at
        any worker count (≙ tf.data's deterministic ParallelMap). The
        serial default keeps today's zero-overhead generator chain."""
        src = self._gen_fn
        if num_parallel_calls is None:
            return self._derive(lambda: (fn(x) for x in src()),
                                self._element_count, op=lambda d: d.map(fn))
        stats = profiler.StageStats(_stage_name("map", name))

        def gen():
            yield from _parallel_map_iter(src, fn, num_parallel_calls,
                                          stats)

        ds = self._derive(
            gen, self._element_count,
            op=lambda d: d.map(fn, num_parallel_calls, name))
        ds._stage_stats = stats
        return ds

    def filter(self, pred: Callable) -> "Dataset":
        src = self._gen_fn
        return self._derive(lambda: (x for x in src() if pred(x)),
                            op=lambda d: d.filter(pred))

    def shuffle(self, buffer_size: int, seed: int | None = None) -> "Dataset":
        src = self._gen_fn

        def gen():
            rng = np.random.default_rng(seed)
            buf = []
            for x in src():
                buf.append(x)
                if len(buf) >= buffer_size:
                    i = rng.integers(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return self._derive(gen, self._element_count,
                            op=lambda d: d.shuffle(buffer_size, seed))

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        src = self._gen_fn

        def gen():
            it = src()
            while True:
                chunk = list(itertools.islice(it, batch_size))
                if not chunk:
                    return
                if len(chunk) < batch_size and drop_remainder:
                    return
                yield tree_util.tree_map(
                    lambda *xs: np.stack([np.asarray(x) for x in xs]), *chunk)

        count = None
        if self._element_count is not None:
            count = (self._element_count // batch_size if drop_remainder
                     else -(-self._element_count // batch_size))
        return self._derive(gen, count,
                            op=lambda d: d.batch(batch_size, drop_remainder))

    def padded_batch(self, batch_size: int, padded_shapes=None,
                     padding_values=0, drop_remainder: bool = False
                     ) -> "Dataset":
        """Batch variable-length elements, padding each component to the
        batch max (or to ``padded_shapes``) — ≙ tf.data
        Dataset.padded_batch. Elements are numpy pytrees; ragged leaves
        are padded on EVERY axis to the componentwise maximum."""
        src = self._gen_fn

        def is_shape(x):
            """A per-component shape spec: tuple/list of int, -1, or
            None (both meaning "pad to the batch max", as in tf.data).
            Being the is_leaf predicate keeps inner Nones from being
            dropped by tree flattening."""
            return (isinstance(x, (tuple, list)) and
                    all(i is None or isinstance(i, int) for i in x))

        def resolve(spec, maxshape, ndim):
            if spec is None:
                return maxshape
            spec = tuple(spec)
            if len(spec) != ndim:
                raise ValueError(
                    f"padded_shapes rank {len(spec)} != element rank "
                    f"{ndim}")
            return tuple(m if t is None or t == -1 else t
                         for t, m in zip(spec, maxshape))

        def pad_stack(leaves, target_shape, fill):
            out = []
            for a in leaves:
                pads = [(0, t - s) for s, t in zip(a.shape, target_shape)]
                if any(p[1] < 0 for p in pads):
                    raise ValueError(
                        f"element shape {a.shape} exceeds padded_shapes "
                        f"{target_shape}")
                out.append(np.pad(a, pads, constant_values=fill)
                           if pads else a)
            return np.stack(out)

        def gen():
            it = src()
            shapes_spec = fills = treedef = None    # set from first chunk
            while True:
                chunk = list(itertools.islice(it, batch_size))
                if not chunk:
                    return
                if len(chunk) < batch_size and drop_remainder:
                    return
                leaves_t = [tree_util.tree_leaves(c) for c in chunk]
                if treedef is None:                 # loop-invariant setup
                    treedef = tree_util.tree_structure(chunk[0])
                    n_leaves = len(leaves_t[0])
                    shapes_spec = (tree_util.tree_leaves(
                                       padded_shapes, is_leaf=is_shape)
                                   if padded_shapes is not None
                                   else [None] * n_leaves)
                    if len(shapes_spec) != n_leaves:
                        raise ValueError(
                            f"padded_shapes has {len(shapes_spec)} "
                            f"components; elements have {n_leaves}")
                    fills = (tree_util.tree_leaves(padding_values)
                             if isinstance(padding_values,
                                           (list, tuple, dict))
                             else [padding_values] * n_leaves)
                cols = []
                for li in range(len(leaves_t[0])):
                    col = [np.asarray(leaves_t[ei][li])
                           for ei in range(len(chunk))]
                    maxshape = tuple(
                        max(a.shape[d] for a in col)
                        for d in range(col[0].ndim))
                    target = resolve(shapes_spec[li], maxshape,
                                     col[0].ndim)
                    cols.append(pad_stack(col, target, fills[li]))
                yield tree_util.tree_unflatten(treedef, cols)

        count = None
        if self._element_count is not None:
            count = (self._element_count // batch_size if drop_remainder
                     else -(-self._element_count // batch_size))
        return self._derive(
            gen, count,
            op=lambda d: d.padded_batch(batch_size, padded_shapes,
                                        padding_values, drop_remainder))

    def repeat(self, count: int | None = None) -> "Dataset":
        src = self._gen_fn

        def gen():
            n = 0
            while count is None or n < count:
                yield from src()
                n += 1

        return self._derive(
            gen, None if count is None or self._element_count is None
            else self._element_count * count,
            op=lambda d: d.repeat(count))

    def take(self, n: int) -> "Dataset":
        src = self._gen_fn
        return self._derive(lambda: itertools.islice(src(), n),
                            op=lambda d: d.take(n))

    def skip(self, n: int) -> "Dataset":
        src = self._gen_fn
        return self._derive(lambda: itertools.islice(src(), n, None),
                            op=lambda d: d.skip(n))

    @staticmethod
    def _check_shard_args(num_shards: int, index: int):
        """Shared validation for shard/shard_files (≙ tf.data's
        Dataset.shard errors). ``islice`` would treat a bad index as a
        plain offset — a negative index raises deep inside itertools
        and an out-of-range one silently yields nothing (an empty
        worker that deadlocks its peers in the first collective)."""
        if num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {num_shards}")
        if not 0 <= index < num_shards:
            raise ValueError(
                f"shard index {index} out of range [0, {num_shards}); an "
                f"out-of-range index would silently yield no elements "
                f"(or alias another shard)")

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """DATA-policy sharding: every ``num_shards``-th element
        (≙ tf.data Dataset.shard used by auto_shard_dataset)."""
        self._check_shard_args(num_shards, index)
        src = self._gen_fn
        return self._derive(
            lambda: itertools.islice(src(), index, None, num_shards),
            op=lambda d: d.shard(num_shards, index))

    def shard_files(self, num_shards: int, index: int) -> "Dataset":
        """FILE-policy sharding (≙ input_ops.py:28 FILE branch).

        Like tf.data's FILE auto-shard — which rewrites the source node
        of the input graph — this shards the ROOT file list and replays
        every downstream transform on top of the sharded source, so
        ``from_files(...).map(parse).batch(n)`` keeps its parsing and
        batching per shard."""
        if not self._files:
            raise ValueError("Dataset has no file list; use DATA sharding")
        self._check_shard_args(num_shards, index)
        if len(self._files) < num_shards:
            # Deterministic on EVERY worker (≙ tf.data FILE auto-shard's
            # 'not enough files' error) — erroring only on the
            # empty-shard workers would leave the others deadlocked in
            # collectives waiting for crashed peers.
            raise ValueError(
                f"FILE sharding needs >= num_shards files: "
                f"{len(self._files)} file(s) cannot be sharded "
                f"{num_shards} ways. Use more files or "
                f"AutoShardPolicy.DATA.")
        files, reader, chain = self.replay_spec()
        ds = Dataset.from_files(files[index::num_shards], reader)
        for op in reversed(chain):
            ds = op(ds)
        return ds

    def replay_spec(self):
        """The recorded rebuild recipe of a file-rooted pipeline:
        ``(files, reader, chain)`` where replaying ``chain`` (outermost
        last) over ``from_files(subset, reader)`` rebuilds this
        pipeline on any file subset. This is the FILE auto-shard
        machinery (:meth:`shard_files`) exposed for the disaggregated
        data service (input/split_provider.py), which replays the same
        chain per FILE split on remote input workers."""
        chain = []
        node = self
        while getattr(node, "_parent", None) is not None:
            if node._op is None:
                raise ValueError(
                    "FILE sharding cannot replay this pipeline (a "
                    "transform without a recorded rebuild op, e.g. a "
                    "Dataset.zip branch); use AutoShardPolicy.DATA")
            chain.append(node._op)
            node = node._parent
        if not node._files or not hasattr(node, "_reader"):
            raise ValueError(
                "pipeline root has no file source (e.g. Dataset.zip or "
                "a generator root); use AutoShardPolicy.DATA")
        return list(node._files), node._reader, chain

    def interleave(self, map_fn: Callable[..., "Dataset"],
                   cycle_length: int = 4,
                   block_length: int = 1,
                   num_parallel_calls: int | None = None,
                   name: str | None = None) -> "Dataset":
        """Round-robin interleave of ``cycle_length`` sub-datasets
        (≙ tf.data Dataset.interleave): ``map_fn(element)`` yields a
        Dataset per source element; ``block_length`` consecutive items
        are pulled from each open sub-iterator before rotating. This is
        the canonical many-files reading pattern together with
        ``from_files``/``shard_files``.

        ``num_parallel_calls`` (int or :data:`AUTOTUNE`) opens
        sub-datasets and fetches their next blocks on a thread pool —
        the round-robin output order stays bit-identical to the serial
        path (≙ deterministic ParallelInterleave)."""
        if cycle_length < 1:
            raise ValueError(f"cycle_length must be >= 1, got "
                             f"{cycle_length}")
        src = self._gen_fn
        if num_parallel_calls is not None:
            stats = profiler.StageStats(_stage_name("interleave", name))

            def pgen():
                yield from _parallel_interleave_iter(
                    src, map_fn, cycle_length, block_length,
                    num_parallel_calls, stats)

            ds = self._derive(
                pgen, None,
                op=lambda d: d.interleave(map_fn, cycle_length,
                                          block_length,
                                          num_parallel_calls, name))
            ds._stage_stats = stats
            return ds

        def gen():
            elements = src()
            open_its: list = []
            exhausted_src = False
            while True:
                while not exhausted_src and len(open_its) < cycle_length:
                    try:
                        element = next(elements)
                    except StopIteration:
                        exhausted_src = True
                        break
                    # map_fn runs OUTSIDE the except: a StopIteration
                    # leaked by user code must not masquerade as source
                    # exhaustion (PEP 479 semantics).
                    open_its.append(iter(map_fn(element)))
                if not open_its:
                    return
                keep = []
                for it in open_its:
                    alive = True
                    for _ in range(block_length):
                        try:
                            yield next(it)
                        except StopIteration:
                            alive = False
                            break
                    if alive:
                        keep.append(it)
                open_its = keep

        return self._derive(
            gen, None,
            op=lambda d: d.interleave(map_fn, cycle_length, block_length))

    def flat_map(self, map_fn: Callable[..., "Dataset"]) -> "Dataset":
        """Map each element to a Dataset and concatenate them in order
        (≙ tf.data Dataset.flat_map — interleave with cycle_length=1)."""
        src = self._gen_fn

        def gen():
            for el in src():
                yield from map_fn(el)

        return self._derive(gen, None, op=lambda d: d.flat_map(map_fn))

    def unbatch(self) -> "Dataset":
        """Split each element along its leading axis back into
        individual elements (≙ tf.data Dataset.unbatch)."""
        src = self._gen_fn

        def gen():
            for el in src():
                leaves = tree_util.tree_leaves(el)
                if not leaves:
                    continue
                n = np.shape(leaves[0])[0]
                for i in range(n):
                    yield tree_util.tree_map(
                        lambda a: np.asarray(a)[i], el)

        return self._derive(gen, None, op=lambda d: d.unbatch())

    def window(self, size: int, shift: int | None = None,
               stride: int = 1, drop_remainder: bool = False
               ) -> "Dataset":
        """Sliding windows of elements, each yielded as a Dataset
        (≙ tf.data Dataset.window; combine with flat_map/batch to
        flatten)."""
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        shift = shift or size
        src = self._gen_fn
        span = (size - 1) * stride + 1

        def gen():
            # tf.data semantics: window k covers stream positions
            # [k*shift, k*shift + span) sampled every `stride`; tail
            # windows (start < n but short) are kept unless
            # drop_remainder. Track absolute positions so shift > span
            # skips elements instead of silently reusing them.
            buf = collections.deque()
            pos0 = 0                    # stream index of buf[0]
            next_start = 0
            n = 0
            for el in src():
                buf.append(el)
                n += 1
                while next_start + span <= n:
                    lo = next_start - pos0
                    yield Dataset.from_iterable(
                        list(buf)[lo:lo + span:stride])
                    next_start += shift
                    while pos0 < next_start and buf:
                        buf.popleft()
                        pos0 += 1
            while next_start < n:
                lo = next_start - pos0
                win = list(buf)[lo:lo + span:stride][:size]
                if win and not (drop_remainder and len(win) < size):
                    yield Dataset.from_iterable(win)
                next_start += shift
                while pos0 < next_start and buf:
                    buf.popleft()
                    pos0 += 1

        return self._derive(
            gen, None,
            op=lambda d: d.window(size, shift, stride, drop_remainder))

    def bucket_by_sequence_length(
            self, element_length_func: Callable[[Any], int],
            bucket_boundaries: Sequence[int],
            bucket_batch_sizes: Sequence[int], *,
            pad_to_bucket_boundary: bool = False,
            drop_remainder: bool = False) -> "Dataset":
        """Group elements into length buckets and emit padded batches
        per bucket (≙ tf.data.Dataset.bucket_by_sequence_length,
        TF/python/data/experimental/ops/grouping.py) — the BERT-style
        variable-length text batching pattern. ``bucket_batch_sizes``
        needs len(bucket_boundaries)+1 entries; variable-length leading
        axes are zero-padded to the longest element in the batch (or to
        boundary-1 with ``pad_to_bucket_boundary``)."""
        boundaries = list(bucket_boundaries)
        batch_sizes = list(bucket_batch_sizes)
        if len(batch_sizes) != len(boundaries) + 1:
            raise ValueError(
                f"bucket_batch_sizes needs {len(boundaries) + 1} "
                f"entries (len(bucket_boundaries)+1), got "
                f"{len(batch_sizes)}")
        src = self._gen_fn

        def bucket_of(length: int) -> int:
            for b, bound in enumerate(boundaries):
                if length < bound:
                    return b
            return len(boundaries)

        def pad_stack(elements, bucket_idx):
            def pad_leaf(*leaves):
                arrs = [np.asarray(a) for a in leaves]
                if arrs[0].ndim == 0:
                    return np.stack(arrs)
                ndim = arrs[0].ndim
                if any(a.ndim != ndim for a in arrs):
                    raise ValueError(
                        "bucket_by_sequence_length: elements of one "
                        "bucket differ in rank")
                if pad_to_bucket_boundary:
                    if bucket_idx >= len(boundaries):
                        raise ValueError(
                            "pad_to_bucket_boundary needs a final "
                            "boundary covering the longest element")
                    bound = boundaries[bucket_idx] - 1
                    # tf.data pads every UNKNOWN (varying) dim to
                    # boundary-1 in this mode; statically-equal dims
                    # keep their size (grouping.py padded_batch with
                    # the None dims of the element spec).
                    targets = [bound] + [
                        (arrs[0].shape[d]
                         if all(a.shape[d] == arrs[0].shape[d]
                                for a in arrs) else bound)
                        for d in range(1, ndim)]
                else:
                    # pad EVERY dim to the batch max, not just the
                    # leading axis — e.g. (T, feat) with varying feat.
                    targets = [max(a.shape[d] for a in arrs)
                               for d in range(ndim)]
                out = []
                for a in arrs:
                    pad = [(0, t - s) for t, s in zip(targets, a.shape)]
                    out.append(np.pad(a, pad))
                return np.stack(out)
            return tree_util.tree_map(pad_leaf, *elements)

        def gen():
            buckets: dict[int, list] = collections.defaultdict(list)
            for el in src():
                b = bucket_of(int(element_length_func(el)))
                buckets[b].append(el)
                if len(buckets[b]) >= batch_sizes[b]:
                    yield pad_stack(buckets.pop(b), b)
            if not drop_remainder:
                for b in sorted(buckets):
                    yield pad_stack(buckets[b], b)

        return self._derive(
            gen, None,
            op=lambda d: d.bucket_by_sequence_length(
                element_length_func, boundaries, batch_sizes,
                pad_to_bucket_boundary=pad_to_bucket_boundary,
                drop_remainder=drop_remainder))

    @classmethod
    def zip(cls, *datasets: "Dataset") -> "Dataset":
        """Elementwise tuples across datasets, stopping at the shortest
        (≙ tf.data.Dataset.zip)."""
        gens = [d._gen_fn for d in datasets]

        def gen():
            yield from zip(*(g() for g in gens))

        counts = [d._element_count for d in datasets]
        n = None if any(c is None for c in counts) else min(counts)
        return cls(gen, element_count=n)

    def cache(self) -> "Dataset":
        """Memoize elements on first full pass; later epochs replay the
        cache without re-running upstream transforms (≙ tf.data
        Dataset.cache, in-memory form)."""
        src = self._gen_fn
        store: dict = {"items": [], "complete": False}

        def gen():
            if store["complete"]:
                yield from store["items"]
                return
            items = []
            for x in src():
                items.append(x)
                yield x
            store["items"], store["complete"] = items, True

        return self._derive(gen, self._element_count,
                            op=lambda d: d.cache())

    def prefetch(self, buffer_size: int = 2,
                 name: str | None = None) -> "Dataset":
        """Decouple production from consumption: a background thread
        fills a bounded queue ``buffer_size`` deep (≙ tf.data
        Dataset.prefetch). Per-stage occupancy/wait counters register
        with :mod:`utils.profiler` (``pipeline_stats()``); the
        ``input.prefetch`` fault site fires per element so chaos tests
        can inject upstream decode failures."""
        src = self._gen_fn
        stats = profiler.StageStats(_stage_name("prefetch", name))

        def gen():
            yield from _BackgroundIterator(src(), buffer_size,
                                           stats=stats)

        ds = self._derive(gen, self._element_count,
                          op=lambda d: d.prefetch(buffer_size, name))
        ds._stage_stats = stats
        return ds

    def cardinality(self) -> int | None:
        return self._element_count

    def pipeline_stats(self) -> "list[dict]":
        """Snapshots of this pipeline's instrumented stages (parallel
        map/interleave, prefetch), root → here. Serial stages carry no
        counters (they are plain generators). For a process-wide view
        across pipelines use ``utils.profiler.pipeline_stats()``."""
        out = []
        node = self
        while node is not None:
            s = getattr(node, "_stage_stats", None)
            if s is not None:
                out.append(s.snapshot())
            node = getattr(node, "_parent", None)
        return list(reversed(out))

    def __iter__(self) -> Iterator:
        return self._gen_fn()


def _parallel_map_iter(src_fn: Callable[[], Iterator], fn: Callable,
                       num_parallel_calls: int,
                       stats: "profiler.StageStats") -> Iterator:
    """Ordered thread-pool fan-out for Dataset.map.

    A bounded window of futures keeps ``workers + 2`` elements in
    flight; results are yielded strictly in submission order, so the
    output is bit-identical to the serial path at any worker count.
    AUTOTUNE calibrates on the first elements (run serially) before the
    pool spins up. Exceptions from ``fn`` surface at the failing
    element's ordinal position; abandoning the iterator cancels the
    in-flight window.
    """
    _check_parallel_calls(num_parallel_calls)
    src = src_fn()
    calibrated: list = []
    if num_parallel_calls == AUTOTUNE:
        src_s = fn_s = 0.0
        n = 0
        for _ in range(3):
            t0 = time.monotonic()
            try:
                x = next(src)
            except StopIteration:
                break
            t1 = time.monotonic()
            y = fn(x)
            t2 = time.monotonic()
            src_s += t1 - t0
            fn_s += t2 - t1
            n += 1
            stats.record(elements=1, busy_s=t2 - t1,
                         producer_wait_s=t1 - t0)
            calibrated.append(y)
        workers = (_autotune_workers(src_s / n, fn_s / n) if n
                   else 1)
    else:
        workers = int(num_parallel_calls)
    stats.workers = workers

    def timed_fn(x):
        t0 = time.monotonic()
        y = fn(x)
        stats.record(elements=1, busy_s=time.monotonic() - t0)
        return y

    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix=f"dtx-{stats.name}")
    pending: collections.deque = collections.deque()
    in_flight = workers + 2
    try:
        yield from calibrated
        exhausted = False
        while not exhausted or pending:
            while not exhausted and len(pending) < in_flight:
                t0 = time.monotonic()
                try:
                    x = next(src)
                except StopIteration:
                    exhausted = True
                    break
                stats.record(producer_wait_s=time.monotonic() - t0)
                pending.append(ex.submit(timed_fn, x))
            if not pending:
                break
            t0 = time.monotonic()
            y = pending.popleft().result()
            stats.record(consumer_wait_s=time.monotonic() - t0,
                         queue_depth=len(pending))
            yield y
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=False)


def _parallel_interleave_iter(src_fn: Callable[[], Iterator],
                              map_fn: Callable, cycle_length: int,
                              block_length: int, num_parallel_calls: int,
                              stats: "profiler.StageStats") -> Iterator:
    """Deterministic parallel interleave: the round-robin rotation (and
    therefore the output order) is exactly the serial algorithm's, but
    each open slot's NEXT block — and the sub-dataset open itself — is
    fetched ahead on a thread pool while earlier slots drain."""
    _check_parallel_calls(num_parallel_calls)
    workers = (min(cycle_length, _worker_cap())
               if num_parallel_calls == AUTOTUNE
               else min(int(num_parallel_calls), cycle_length))
    stats.workers = workers

    def fetch_block(it):
        t0 = time.monotonic()
        out = []
        alive = True
        for _ in range(block_length):
            try:
                out.append(next(it))
            except StopIteration:
                alive = False
                break
        stats.record(elements=len(out), busy_s=time.monotonic() - t0)
        return out, alive

    def open_and_fetch(element):
        t0 = time.monotonic()
        it = iter(map_fn(element))
        stats.record(busy_s=time.monotonic() - t0)
        out, alive = fetch_block(it)
        return it, out, alive

    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix=f"dtx-{stats.name}")
    elements = src_fn()
    slots: list[dict] = []
    try:
        exhausted = False
        while True:
            while not exhausted and len(slots) < cycle_length:
                t0 = time.monotonic()
                try:
                    el = next(elements)
                except StopIteration:
                    exhausted = True
                    break
                stats.record(producer_wait_s=time.monotonic() - t0)
                slots.append({"fut": ex.submit(open_and_fetch, el),
                              "it": None})
            if not slots:
                return
            keep = []
            for slot in slots:
                t0 = time.monotonic()
                if slot["it"] is None:
                    slot["it"], items, alive = slot["fut"].result()
                else:
                    items, alive = slot["fut"].result()
                stats.record(consumer_wait_s=time.monotonic() - t0)
                yield from items
                if alive:
                    slot["fut"] = ex.submit(fetch_block, slot["it"])
                    keep.append(slot)
            slots = keep
    finally:
        for slot in slots:
            slot["fut"].cancel()
        ex.shutdown(wait=False)


class _BackgroundIterator:
    """Background-thread prefetch with a bounded queue.

    Shuts down cleanly when abandoned: the worker parks on a bounded
    ``put`` that also watches a stop flag, and a ``weakref.finalize``
    (which the interpreter runs at exit for still-alive objects) stops
    and joins the thread — a daemon thread killed mid-copy at
    teardown can abort the whole process otherwise."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, buffer_size: int,
                 stats: "profiler.StageStats | None" = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        # One-element holder, NOT an attribute: the worker closure must
        # hold no reference to self, or the finalizer's strong args
        # (registry → thread → closure → self) would keep the iterator
        # alive forever and the GC teardown path would never fire.
        self._err_box: list[BaseException] = []
        self._done = False
        self._stop = threading.Event()
        self._stats = stats
        q, stop, sentinel = self._q, self._stop, self._SENTINEL
        err_box = self._err_box
        tag = stats.name if stats is not None else None

        def worker():
            try:
                src = iter(it)
                while True:
                    t0 = time.monotonic()
                    try:
                        x = next(src)
                    except StopIteration:
                        return
                    busy = time.monotonic() - t0
                    # Chaos site: a schedule can make the prefetch
                    # worker fail like a bad decode would — the
                    # exception lands in err_box and surfaces on the
                    # consumer's next() instead of hanging the queue.
                    faults.fire("input.prefetch", tag=tag)
                    t1 = time.monotonic()
                    ok = _put_unless_stopped(q, stop, x)
                    if stats is not None:
                        stats.record(
                            elements=1, busy_s=busy,
                            blocked_put_s=time.monotonic() - t1,
                            queue_depth=q.qsize())
                    if not ok:
                        return
            except BaseException as e:  # propagate to consumer
                err_box.append(e)
            finally:
                _put_unless_stopped(q, stop, sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(
            self, _stop_background_worker, stop, q, self._thread, sentinel)

    def close(self):
        self._finalizer()

    def __iter__(self):
        return self

    def __next__(self):
        # Exhaustion is sticky: the single sentinel is consumed on first
        # hit, and the dead worker will never put again — without the
        # flag a second next()/get_next_as_optional() would block
        # forever on the empty queue.
        if self._done:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        t0 = time.monotonic()
        x = self._q.get()
        if self._stats is not None:
            self._stats.record(consumer_wait_s=time.monotonic() - t0)
        if x is self._SENTINEL:
            self._done = True
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return x


def _put_unless_stopped(q: "queue.Queue", stop: "threading.Event",
                        item) -> bool:
    """Bounded put that also watches the stop flag; False once stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _stop_background_worker(stop: "threading.Event", q: "queue.Queue",
                            thread: "threading.Thread",
                            sentinel) -> None:
    """Module-level so the finalizer holds no reference to the iterator."""
    stop.set()
    # Drain to unblock a worker parked on a full queue, then re-arm the
    # sentinel so a consumer parked in __next__'s blocking get() raises
    # StopIteration instead of hanging. Loop because a worker put
    # already in flight when stop was set can refill the slot between
    # our drain and our put (narrow race at buffer_size==1); after stop
    # is observed the worker puts nothing more, so this terminates.
    while True:
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        try:
            q.put_nowait(sentinel)
            break
        except queue.Full:
            continue
    # GC can run the finalizer on the worker thread itself (any
    # allocation there can trigger collection); joining yourself raises.
    if thread is not threading.current_thread():
        thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Auto-sharding (≙ input_ops.auto_shard_dataset, input_ops.py:28)
# ---------------------------------------------------------------------------

def auto_shard_dataset(dataset: Dataset, num_shards: int, index: int,
                       policy: AutoShardPolicy = AutoShardPolicy.AUTO
                       ) -> Dataset:
    if num_shards <= 1 or policy is AutoShardPolicy.OFF:
        return dataset
    if policy is AutoShardPolicy.FILE:
        return dataset.shard_files(num_shards, index)
    if policy is AutoShardPolicy.DATA:
        return dataset.shard(num_shards, index)
    # AUTO: FILE when a file list exists and has enough files, else DATA.
    if dataset._files and len(dataset._files) >= num_shards:
        return dataset.shard_files(num_shards, index)
    return dataset.shard(num_shards, index)


# ---------------------------------------------------------------------------
# Distributed dataset
# ---------------------------------------------------------------------------

class DistributedDataset:
    """This rank's view of a dataset of global batches, each rank taking
    its rows (module docstring). ``per_replica=True``: the dataset is
    this rank's own pipeline (``distribute_datasets_from_function``),
    and its batches are this replica's whole."""

    def __init__(self, dataset, strategy, options: InputOptions | None = None,
                 *, per_replica: bool = False):
        self._options = options or InputOptions()
        self._dataset = Dataset.from_iterable(dataset)
        self._strategy = strategy
        self._per_replica = per_replica

    @property
    def element_spec(self):
        first = next(iter(self._dataset), None)
        if first is None:
            return None
        return tree_util.tree_map(
            lambda x: (tuple(np.shape(x)), np.asarray(x).dtype), first)

    def __iter__(self) -> "DistributedIterator":
        return DistributedIterator(self._dataset, self._strategy,
                                   self._options,
                                   per_replica=self._per_replica)

    def iter_per_replica(self) -> Iterator:
        """TF-parity iteration: PerReplica values (every replica's rows,
        JAX's host view) for ``Strategy.run``."""
        from distributed_tensorflow_tpu_torch.parallel.values import (
            PerReplica)
        R = self._strategy.num_replicas_in_sync
        for batch in self._dataset:
            leaves, treedef = tree_util.tree_flatten(batch)
            n = np.shape(leaves[0])[0] if leaves else 0
            if n % R:
                raise ValueError(
                    f"Per-worker batch size {n} is not divisible by "
                    f"{R} replicas; use drop_remainder=True or a divisible "
                    f"batch size")
            split = [np.split(np.asarray(l), R, axis=0) for l in leaves]
            yield tree_util.tree_unflatten(
                treedef, [PerReplica(s) for s in split])


def _place_whole(batch, device):
    def one(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return tree_util.tree_map(one, batch)


class DistributedIterator:
    """Global batches in, this rank's rows out on its device, staged by a
    background thread (JAX ``:1106``)."""

    def __init__(self, dataset: Dataset, strategy, options: InputOptions,
                 *, per_replica: bool = False):
        self._strategy = strategy
        self._fetch = options.experimental_fetch_to_device
        src = iter(dataset)
        if self._fetch:
            # the strategy's method, not self: a bound method of this
            # iterator in the worker would keep an abandoned iterator
            # (and its thread) alive
            if per_replica:
                device = strategy.device
                place = lambda b: _place_whole(b, device)  # noqa: E731
            else:
                place = strategy.shard_batch
            buffered = _BackgroundIterator(
                map(place, src),
                options.experimental_per_replica_buffer_size,
                stats=profiler.StageStats(_stage_name("device_put")))
            self._it = iter(buffered)
        else:
            self._it = src

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def get_next(self):
        return next(self._it)

    def get_next_as_optional(self):
        """None at the end instead of raising."""
        try:
            return next(self._it)
        except StopIteration:
            return None

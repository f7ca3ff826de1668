"""Object-graph checkpointing with sharded, async-capable writes — port of
``distributed_tensorflow_tpu/checkpoint/checkpoint.py``.

**The on-disk format is JAX's, byte-compatible both ways.** A checkpoint
is a directory of per-process ``shard_<proc>.npz`` files and the JSON
index ``checkpoint.index.json`` (``format: 1``): each leaf's kind,
shape and dtype (numpy's names; ``"bfloat16"`` for bf16) and each
shard file's size and crc32. Leaf paths are :func:`_flatten`'s: sorted
dict keys, list indices, ``_checkpoint_children``. A bf16 leaf is
written as 2-byte void (``|V2``, what ``np.savez`` makes of an
``ml_dtypes`` bf16 array) from ``tensor.view(torch.int16)``, and read
back keyed on the index's dtype.

- **Leaves.** Torch tensors (any device), numpy arrays and scalars, and
  :class:`~distributed_tensorflow_tpu_torch.parallel.values.
  DistributedVariable` s. A variable is saved as its global value
  (``read_value``, gathered over the mesh) and restored in place by
  ``assign``, which keeps this rank's block under the *current* mesh:
  a checkpoint saved on one mesh restores onto any other (dp2×tp2 →
  tp4 → one card, and back). A JAX ``sharded_variable`` leaf (axis-0
  slices with their offsets) is stitched in slice order, as JAX's
  ``_apply_shards`` does.
- **Restore values.** A tensor leaf of the template comes back as a
  tensor on that leaf's device, anything else as a numpy array (a
  bf16 leaf as a bf16 CPU tensor: numpy has no bf16).
- **Capture.** The device→host copy of a save (:meth:`Checkpoint.
  _capture`) is issued before ``save``/``write`` returns: on the card
  into pinned host buffers on a side stream that waits for the
  compute stream, with an event the compute stream then waits on (so
  an in-place update after the save cannot race the copy) and the
  writer waits on before it reads the buffers. With ``async_write``
  the file IO runs on a thread behind training; ``sync()`` joins it.
- **Commit protocol** (JAX ``:309-420``): each process renames its
  shard into place, a barrier, process 0 writes the index (with every
  shard's size and crc32, gathered over the coordination KV) by atomic
  rename — the commit point — then an exit barrier. The
  ``checkpoint.commit`` fault site (``raise`` / ``corrupt``) fires as
  in JAX.
- **Tiers** (:class:`CheckpointManager`): ``local_dir`` commits first
  to a node-local directory and pipelines the durable re-commit;
  ``snapshot_store`` adds the in-memory host/peer tiers
  (``checkpoint/peer_snapshot.py``); :meth:`CheckpointManager.
  restore_latest` restores down host > peer > local > durable.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.parallel.values import (
    DistributedVariable)
from distributed_tensorflow_tpu_torch.resilience import faults

_INDEX_FILE = "checkpoint.index.json"

#: numpy's dtype names of the torch dtypes a leaf may have
_NP_NAME = {torch.float32: "float32", torch.float64: "float64",
            torch.float16: "float16", torch.bfloat16: "bfloat16",
            torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
            torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}


def checkpoint_span_id(path: str) -> str:
    """Causality id shared by every telemetry span of one logical save
    (from the tier-invariant basename ``<name>-<number>``)."""
    return f"ckpt/{os.path.basename(path)}"


class CheckpointCorruptError(RuntimeError):
    """A shard file fails its recorded checksum/size — the checkpoint is
    torn and must not be restored."""


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _flatten(tree, prefix=""):
    """Flatten a nested dict/list/variable tree into ``{path: leaf}``
    (JAX's order and names)."""
    out = {}
    if isinstance(tree, DistributedVariable):
        out[prefix or "var"] = tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}" if prefix else str(i)))
    elif hasattr(tree, "__dict__") and hasattr(tree, "_checkpoint_children"):
        for k, v in tree._checkpoint_children().items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix or "value"] = tree
    return out


def dtype_name(x) -> str:
    """numpy's name of a leaf's dtype (``"bfloat16"`` for bf16)."""
    if isinstance(x, torch.Tensor):
        return _NP_NAME[x.dtype]
    return str(np.asarray(x).dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the numpy array ``np.savez`` writes: bf16 as
    2-byte void (``|V2``), as an ``ml_dtypes`` bf16 array is written."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_numpy(arr: np.ndarray, dtype: str | None = None):
    """The leaf value of a stored array: a bf16 CPU tensor when the
    index says ``"bfloat16"`` (the stored bytes are ``|V2``), else the
    array itself."""
    if dtype == "bfloat16" or (arr.dtype.kind == "V" and arr.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return arr


class _HostCopy:
    """Device→host copies on one side stream a device into pinned
    buffers (module docstring): :meth:`issued` makes the compute stream
    wait for them, :meth:`wait` blocks until the bytes are on the host."""

    def __init__(self):
        self._streams: dict = {}
        self._events: list = []

    def tensor(self, t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.device.type != "cuda":
            return to_numpy(t.contiguous().clone())
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        side = self._streams.get(t.device)
        if side is None:
            side = self._streams[t.device] = torch.cuda.Stream(t.device)
        # each copy waits for the work that made its tensor (a leaf's
        # read_value stacks and gathers on the compute stream)
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            host.copy_(t, non_blocking=True)
            t.record_stream(side)
        return to_numpy(host)

    def issued(self):
        for device, side in self._streams.items():
            done = torch.cuda.Event()
            done.record(side)
            torch.cuda.current_stream(device).wait_event(done)
            self._events.append(done)
        self._streams = {}

    def wait(self):
        self.issued()
        for e in self._events:
            e.synchronize()
        self._events = []


def _host_value(leaf, copies: _HostCopy):
    if isinstance(leaf, torch.Tensor):
        return copies.tensor(leaf)
    return np.asarray(leaf)


def _agent():
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    return coordination_service()


class Checkpoint:
    """Object-style checkpoint of a tree of tensors, arrays and
    variables (JAX's ``Checkpoint``). ``single_writer=True``: this
    process alone owns and saves the tracked state, whatever the
    cluster (no barriers, shard 0)."""

    def __init__(self, single_writer: bool = False, **objects):
        self._single_writer = bool(single_writer)
        self._objects = objects
        self._save_counter = 0
        self._async_thread: threading.Thread | None = None
        self._async_error: BaseException | None = None
        self._pending_lock = threading.Lock()
        self._pending_paths: set[str] = set()
        #: seconds of the last write: ``blocking`` (until write
        #: returned), ``commit`` (each tier's file IO and commit)
        self.last_timings: dict = {}

    @property
    def save_counter(self) -> int:
        return self._save_counter

    # -- save -------------------------------------------------------------
    def save(self, file_prefix: str, *, async_write: bool = False) -> str:
        """Write ``<file_prefix>-<counter>/``; returns the path."""
        self._save_counter += 1
        path = f"{file_prefix}-{self._save_counter}"
        self.write(path, async_write=async_write)
        return path

    def write(self, path: str, *, async_write: bool = False,
              tier: str = "durable", pipeline_to: str | None = None,
              on_captured=None) -> str:
        """Write a checkpoint directory at ``path`` (JAX's ``write``):
        ``tier`` labels the index, ``pipeline_to`` re-commits the shards
        into a second directory (tier ``durable``), ``on_captured(
        host_arrays, index)`` runs right after the device→host capture
        (the in-memory snapshot tiers' hook)."""
        span_id = checkpoint_span_id(path)
        t0 = time.perf_counter()
        with telemetry.span("checkpoint.save", path=path,
                            async_write=async_write, span_id=span_id):
            out = self._write_impl(path, async_write=async_write, tier=tier,
                                   pipeline_to=pipeline_to,
                                   on_captured=on_captured, span_id=span_id)
        self.last_timings["blocking"] = time.perf_counter() - t0
        return out

    def _capture(self, copies: _HostCopy | None = None
                 ) -> tuple[dict[str, np.ndarray], dict]:
        """The shard arrays this process owns and the index. Each leaf is
        read once (an ON_READ or cut variable reads collectively); the
        device→host copies are issued here and complete at
        ``copies.wait()`` (at once without ``copies``)."""
        wait_now = copies is None
        copies = copies or _HostCopy()
        flat = _flatten(self._objects)
        mine = self._proc() == 0
        index: dict[str, Any] = {"leaves": {}, "format": 1}
        host_arrays: dict[str, np.ndarray] = {}
        for name, leaf in flat.items():
            if isinstance(leaf, DistributedVariable):
                val = leaf.read_value()
                kind = "variable"
            else:
                val = leaf
                kind = "array"
            index["leaves"][name] = {"kind": kind,
                                     "shape": list(val.shape if isinstance(
                                         val, torch.Tensor)
                                         else np.shape(val)),
                                     "dtype": dtype_name(val)}
            if mine:
                host_arrays[self._fname(name)] = _host_value(val, copies)
        copies.issued()
        if wait_now:
            copies.wait()
        return host_arrays, index

    def _proc(self) -> int:
        return 0 if self._single_writer else _agent().process_id

    def _write_impl(self, path: str, *, async_write: bool,
                    tier: str = "durable", pipeline_to: str | None = None,
                    on_captured=None, span_id: str | None = None) -> str:
        proc = self._proc()
        tmp = f"{path}.tmp.{proc}"
        os.makedirs(tmp, exist_ok=True)
        copies = _HostCopy()
        host_arrays, index = self._capture(copies)
        index["tier"] = tier
        if on_captured is not None:
            copies.wait()
            on_captured(host_arrays, index)

        def mark_pending():
            with self._pending_lock:
                self._pending_paths.add(path)
                if pipeline_to:
                    self._pending_paths.add(pipeline_to)

        def finish():
            try:
                copies.wait()
                t0 = time.perf_counter()
                with telemetry.span("checkpoint.commit", path=path,
                                    tier=tier, span_id=span_id):
                    shard = os.path.join(tmp, f"shard_{proc}.npz")
                    with open(shard, "wb") as f:
                        np.savez(f, **host_arrays)
                        f.flush()
                        os.fsync(f.fileno())
                    self._commit(tmp, path, index)
                timings = {tier: time.perf_counter() - t0}
                if pipeline_to:
                    t0 = time.perf_counter()
                    with telemetry.span("checkpoint.commit",
                                        path=pipeline_to, tier="durable",
                                        span_id=span_id):
                        tmp2 = f"{pipeline_to}.tmp.{proc}"
                        os.makedirs(tmp2, exist_ok=True)
                        shutil.copy2(os.path.join(path, f"shard_{proc}.npz"),
                                     os.path.join(tmp2, f"shard_{proc}.npz"))
                        index2 = dict(index)
                        index2["tier"] = "durable"
                        index2.pop("shards", None)
                        self._commit(tmp2, pipeline_to, index2)
                    timings["durable"] = time.perf_counter() - t0
                self.last_timings["commit"] = timings
            finally:
                with self._pending_lock:
                    self._pending_paths.discard(path)
                    if pipeline_to:
                        self._pending_paths.discard(pipeline_to)

        def finish_async():
            try:
                finish()
            except BaseException as e:   # surfaced on next sync/save/restore
                self._async_error = e

        if async_write:
            self._join_pending()
            mark_pending()
            self._async_thread = threading.Thread(target=finish_async,
                                                  daemon=True)
            self._async_thread.start()
        else:
            mark_pending()
            finish()
        return path

    def pending_write_paths(self) -> set[str]:
        """Checkpoint directories an in-flight write still commits into
        (rotation skips these)."""
        with self._pending_lock:
            return set(self._pending_paths)

    def _commit(self, tmp: str, path: str, index: dict):
        """The multi-process commit protocol (module docstring)."""
        agent = _agent()
        decision = faults.fire("checkpoint.commit", tag=path, exc=OSError,
                               msg=f"injected commit failure for {path}")
        sums = {f: {"crc32": _crc32_file(os.path.join(tmp, f)),
                    "size": os.path.getsize(os.path.join(tmp, f))}
                for f in os.listdir(tmp)}
        os.makedirs(path, exist_ok=True)
        for f in os.listdir(tmp):
            os.replace(os.path.join(tmp, f), os.path.join(path, f))
        os.rmdir(tmp)
        _fsync_dir(path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        token = (os.path.basename(path) + "."
                 + hashlib.sha1(os.path.abspath(path).encode())
                 .hexdigest()[:12])
        sums_prefix = f"dtx_ckpt_sums/{token}.{self._save_counter}"
        distributed = agent.is_distributed and not self._single_writer
        chief = agent.is_chief or self._single_writer
        if distributed:
            try:
                agent.key_value_set(f"{sums_prefix}/p{agent.process_id}",
                                    json.dumps(sums))
            except Exception:
                pass
            try:
                agent.barrier(f"ckpt_shards/{token}", timeout_s=600.0)
            except Exception as e:
                print(f"[dtx.checkpoint] WARNING: shard barrier failed "
                      f"({e}); committing possibly-incomplete checkpoint "
                      f"{path}", file=sys.stderr)
        if chief:
            all_sums = dict(sums)
            if distributed:
                for i in range(agent.num_processes):
                    v = agent.key_value_try_get(f"{sums_prefix}/p{i}")
                    if v is None:
                        continue
                    try:
                        all_sums.update(json.loads(v))
                    except ValueError:
                        pass
            index["shards"] = all_sums
            tmp_index = os.path.join(path, _INDEX_FILE + ".tmp")
            with open(tmp_index, "w") as f:
                json.dump(index, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp_index, os.path.join(path, _INDEX_FILE))
            _fsync_dir(path)
        if distributed:
            try:
                agent.barrier(f"ckpt_index/{token}", timeout_s=600.0)
            except Exception:
                pass
            if agent.is_chief:
                try:
                    agent.key_value_delete(sums_prefix)
                except Exception:
                    pass
        if decision is not None and decision.action == "corrupt":
            shard = os.path.join(path, f"shard_{self._proc()}.npz")
            size = os.path.getsize(shard)
            with open(shard, "rb+") as f:
                f.truncate(max(size - max(size // 4, 1), 0))

    def _join_pending(self):
        if self._async_thread is not None and self._async_thread.is_alive():
            self._async_thread.join()
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def sync(self):
        """Block until any async write completed."""
        self._join_pending()

    @staticmethod
    def _fname(name: str) -> str:
        return re.sub(r"[^A-Za-z0-9_.-]", "__", name)

    # -- restore ----------------------------------------------------------
    def restore(self, path: str) -> dict:
        """Restore from ``path``: variables assigned in place, every leaf
        returned in the flat ``{path: value}`` result."""
        with telemetry.span("checkpoint.restore", path=path,
                            span_id=checkpoint_span_id(path)):
            return self._restore_impl(path)

    def _restore_impl(self, path: str) -> dict:
        self._join_pending()
        index_path = os.path.join(path, _INDEX_FILE)
        if not os.path.exists(index_path):
            raise FileNotFoundError(f"No checkpoint index at {path}")
        with open(index_path) as f:
            index = json.load(f)
        for f_name, meta in index.get("shards", {}).items():
            fpath = os.path.join(path, f_name)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"checkpoint {path} is missing shard {f_name}")
            size = os.path.getsize(fpath)
            if size != meta.get("size"):
                raise CheckpointCorruptError(
                    f"shard {f_name} in {path} is {size} bytes, index "
                    f"records {meta.get('size')} (torn write?)")
            if "crc32" in meta and _crc32_file(fpath) != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"shard {f_name} in {path} fails its crc32 "
                    f"(corrupt data)")
        shards = {}
        shard_pat = re.compile(r"shard_(\d+)\.npz$")
        for f_name in sorted(os.listdir(path),
                             key=lambda n: (int(shard_pat.match(n).group(1))
                                            if shard_pat.match(n) else -1)):
            if shard_pat.match(f_name):
                shards[f_name] = np.load(os.path.join(path, f_name))
        try:
            return self._apply_shards(shards, index, source=path)
        finally:
            for z in shards.values():
                z.close()

    def _apply_shards(self, shards: Mapping[str, Any], index: dict,
                      source: str) -> dict:
        """Reassemble leaves from shard mappings (npz files or dicts of
        arrays) in slice order and assign/return them (JAX's)."""
        def lookup(name, want_shape=None):
            key = self._fname(name)
            parts = []
            for shard in shards.values():
                if key in shard:
                    off = (int(shard[key + "::off"][0])
                           if key + "::off" in shard else 0)
                    parts.append((off, shard[key]))
            if not parts:
                raise KeyError(f"Leaf {name!r} missing from "
                               f"checkpoint {source}")
            parts.sort(key=lambda t: t[0])
            if want_shape is not None and len(parts) > 1:
                pos = 0
                for off, arr in parts:
                    if off != pos:
                        raise CheckpointCorruptError(
                            f"leaf {name!r} in {source}: slice at axis-0 "
                            f"offset {off} does not abut previous end "
                            f"{pos} (missing shard part?)")
                    pos += np.shape(arr)[0]
                if pos != want_shape[0]:
                    raise CheckpointCorruptError(
                        f"leaf {name!r} in {source}: stitched rows {pos} "
                        f"!= logical rows {want_shape[0]}")
            return [a for _, a in parts]

        flat = _flatten(self._objects)
        restored = {}
        for name, leaf in flat.items():
            meta = index["leaves"].get(name, {})
            if meta.get("kind") == "sharded_variable":
                parts = lookup(name, want_shape=meta.get("shape"))
                full = (np.concatenate(parts, axis=0) if len(parts) > 1
                        else parts[0])
            else:
                full = lookup(name)[0]
            value = from_numpy(np.asarray(full), meta.get("dtype"))
            if isinstance(leaf, DistributedVariable):
                t = torch.as_tensor(value)
                if tuple(t.shape) != tuple(leaf.shape):
                    t = t.reshape(leaf.shape)
                leaf.assign(t)
                restored[name] = leaf
            elif isinstance(leaf, torch.Tensor):
                restored[name] = torch.as_tensor(value).to(leaf.device)
            else:
                restored[name] = value
        return restored

    def restore_from_parts(self, parts, index: dict) -> dict:
        """Restore from in-memory snapshot parts (the host/peer tiers),
        one per original shard owner (objects with an ``arrays``
        mapping)."""
        self._join_pending()
        with telemetry.span("checkpoint.restore", path="<memory>"):
            shards = {f"mem_{i}": p.arrays for i, p in enumerate(parts)}
            return self._apply_shards(shards, index,
                                      source="<memory snapshot>")

    def read(self, path: str) -> dict:
        return self.restore(path)

    def restore_into(self, path: str) -> dict:
        """Restore from ``path`` and replace the tracked plain leaves in
        place (variables are assigned); returns the flat mapping."""
        flat_restored = self.restore(path)

        def rebuild(obj, prefix):
            if isinstance(obj, DistributedVariable) or hasattr(obj, "assign"):
                return obj
            if isinstance(obj, Mapping):
                return type(obj)(
                    {k: rebuild(obj[k], f"{prefix}/{k}" if prefix else str(k))
                     for k in obj})
            if isinstance(obj, (list, tuple)):
                vals = [rebuild(v, f"{prefix}/{i}" if prefix else str(i))
                        for i, v in enumerate(obj)]
                return (type(obj)(vals) if not hasattr(obj, "_fields")
                        else type(obj)(*vals))
            if hasattr(obj, "__dict__") and hasattr(obj,
                                                    "_checkpoint_children"):
                for k, child in obj._checkpoint_children().items():
                    newc = rebuild(child, f"{prefix}/{k}" if prefix else k)
                    if newc is not child:
                        if k in vars(obj):
                            setattr(obj, k, newc)
                        else:
                            raise ValueError(
                                f"restore_into cannot write restored child "
                                f"{k!r} back into {type(obj).__name__}: "
                                f"_checkpoint_children keys must be "
                                f"attributes (or use .assign leaves)")
                return obj
            return flat_restored.get(prefix or "value", obj)

        for name in list(self._objects):
            self._objects[name] = rebuild(self._objects[name], name)
        return flat_restored

    def get(self, name: str):
        """A tracked object by its constructor keyword."""
        return self._objects[name]


class CheckpointManager:
    """Rotation, latest-tracking and the recovery tiers (JAX's
    ``CheckpointManager``): ``max_to_keep``,
    ``keep_checkpoint_every_n_hours`` pinning, ``local_dir`` (saves
    commit there first, the durable re-commit pipelined; saves default
    to ``async_write=True`` with it), ``snapshot_store`` (host-RAM
    snapshots ring-replicated to a peer; :meth:`snapshot` takes
    memory-only ones between disk saves)."""

    def __init__(self, checkpoint: Checkpoint, directory: str,
                 max_to_keep: int = 5,
                 keep_checkpoint_every_n_hours: float | None = None,
                 checkpoint_name: str = "ckpt",
                 local_dir: str | None = None,
                 snapshot_store=None,
                 exchange_timeout_s: float = 30.0):
        self.checkpoint = checkpoint
        self.directory = directory
        self.local_dir = local_dir
        self.snapshot_store = snapshot_store
        self._exchange_timeout_s = exchange_timeout_s
        self.max_to_keep = max_to_keep
        self.keep_every_s = (keep_checkpoint_every_n_hours * 3600
                             if keep_checkpoint_every_n_hours else None)
        self._name = checkpoint_name
        self._kept_pinned: list[str] = []
        self._last_pin_time = time.time()
        os.makedirs(directory, exist_ok=True)
        if local_dir:
            os.makedirs(local_dir, exist_ok=True)
        self._load_meta()

    @property
    def _prefix(self) -> str:
        return os.path.join(self.directory, self._name)

    @property
    def _local_prefix(self) -> str | None:
        return (os.path.join(self.local_dir, self._name)
                if self.local_dir else None)

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.directory, f"{self._name}.manager.json")

    def _load_meta(self):
        if not os.path.exists(self._meta_path):
            return
        try:
            with open(self._meta_path) as f:
                meta = json.load(f)
            self._last_pin_time = float(meta.get("last_pin_time",
                                                 self._last_pin_time))
            self._kept_pinned = [
                os.path.join(self.directory, os.path.basename(p))
                for p in meta.get("pinned", [])
                if os.path.isdir(os.path.join(self.directory,
                                              os.path.basename(p)))]
        except (ValueError, OSError):
            pass

    def _save_meta(self):
        if _agent().process_id != 0:
            return
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"last_pin_time": self._last_pin_time,
                       "pinned": [os.path.basename(p)
                                  for p in self._kept_pinned]}, f)
        os.replace(tmp, self._meta_path)

    @staticmethod
    def _is_complete(full: str) -> bool:
        """The index exists and every shard it records has its recorded
        size (restore checks the crc)."""
        idx = os.path.join(full, _INDEX_FILE)
        if not os.path.exists(idx):
            return False
        try:
            with open(idx) as f:
                index = json.load(f)
        except (ValueError, OSError):
            return False
        for f_name, meta in index.get("shards", {}).items():
            try:
                if os.path.getsize(os.path.join(full, f_name)) != \
                        meta.get("size"):
                    return False
            except OSError:
                return False
        return True

    def _list_checkpoints(self, directory: str | None = None
                          ) -> list[tuple[int, str]]:
        directory = directory or self.directory
        pat = re.compile(re.escape(self._name) + r"-(\d+)$")
        out = []
        try:
            entries = os.listdir(directory)
        except OSError:
            return []
        for d in entries:
            m = pat.match(d)
            full = os.path.join(directory, d)
            if m and os.path.isdir(full) and self._is_complete(full):
                out.append((int(m.group(1)), full))
        return sorted(out)

    def _disk_best(self, at_step: int | None = None
                   ) -> "tuple[int, str, str] | None":
        """(step, path, tier) of the freshest intact disk checkpoint; the
        local tier wins ties; ``at_step``: that step only."""
        cands = []
        for tier, d in (("local", self.local_dir),
                        ("durable", self.directory)):
            if not d:
                continue
            cks = self._list_checkpoints(d)
            if at_step is not None:
                cks = [(n, p) for n, p in cks if n == at_step]
            if cks:
                n, p = cks[-1]
                cands.append((n, 1 if tier == "local" else 0, p, tier))
        if not cands:
            return None
        n, _, p, tier = max(cands)
        return n, p, tier

    @property
    def latest_checkpoint(self) -> str | None:
        best = self._disk_best()
        return best[1] if best else None

    @property
    def checkpoints(self) -> list[str]:
        return [p for _, p in self._list_checkpoints()]

    def save(self, checkpoint_number: int | None = None, *,
             async_write: bool | None = None) -> str:
        """Tier-pipelined save (JAX's)."""
        if checkpoint_number is not None:
            self.checkpoint._save_counter = checkpoint_number - 1
        if async_write is None:
            async_write = self.local_dir is not None
        self.checkpoint._save_counter += 1
        number = self.checkpoint._save_counter
        on_captured = None
        if self.snapshot_store is not None:
            def on_captured(host_arrays, index):
                self._commit_snapshot(host_arrays, dict(index), number)
        if self.local_dir:
            path = self.checkpoint.write(
                f"{self._local_prefix}-{number}", async_write=async_write,
                tier="local", pipeline_to=f"{self._prefix}-{number}",
                on_captured=on_captured)
        else:
            path = self.checkpoint.write(
                f"{self._prefix}-{number}", async_write=async_write,
                on_captured=on_captured)
        self._sweep()
        return path

    def snapshot(self, step: int):
        """Memory-only host snapshot and its ring replica exchange
        (collective when distributed)."""
        if self.snapshot_store is None:
            raise ValueError("CheckpointManager has no snapshot_store")
        host_arrays, index = self.checkpoint._capture()
        return self._commit_snapshot(host_arrays, index, step)

    def _commit_snapshot(self, host_arrays, index, step: int):
        from distributed_tensorflow_tpu_torch.checkpoint import (
            peer_snapshot as _ps)
        agent = _agent()
        index = dict(index)
        index["tier"] = "host"
        with telemetry.span("checkpoint.commit", tier="host", step=step,
                            span_id=checkpoint_span_id(
                                f"{self._name}-{step}")):
            snap = _ps.HostSnapshot(
                owner=agent.process_id, step=int(step),
                world=agent.num_processes, index=index,
                arrays={k: np.array(v, copy=True)
                        for k, v in host_arrays.items()})
            self.snapshot_store.put(snap)
            _ps.exchange(self.snapshot_store, snap, agent,
                         timeout_s=self._exchange_timeout_s)
        return snap

    def _sweep(self):
        pending = self.checkpoint.pending_write_paths()
        cks = [(n, p) for n, p in self._list_checkpoints()
               if p not in self._kept_pinned and p not in pending]
        now = time.time()
        changed = False
        chief = _agent().process_id == 0
        while len(cks) > self.max_to_keep:
            num, path = cks.pop(0)
            if self.keep_every_s is not None and \
                    now - self._last_pin_time >= self.keep_every_s:
                self._kept_pinned.append(path)
                self._last_pin_time = now
                changed = True
                continue
            if chief:
                shutil.rmtree(path, ignore_errors=True)
        if changed:
            self._save_meta()
        if self.local_dir:
            locals_ = [(n, p)
                       for n, p in self._list_checkpoints(self.local_dir)
                       if p not in pending]
            while len(locals_) > self.max_to_keep:
                _, path = locals_.pop(0)
                if chief:
                    shutil.rmtree(path, ignore_errors=True)

    def restore_or_initialize(self) -> str | None:
        """Restore the latest checkpoint if one exists, else None."""
        latest = self.latest_checkpoint
        if latest is not None:
            self.checkpoint.restore(latest)
            m = re.search(r"-(\d+)$", latest)
            if m:
                self.checkpoint._save_counter = int(m.group(1))
        return latest

    #: warmth rank of each restore tier (lower = warmer)
    _TIER_RANK = {"host": 0, "peer": 0, "memory": 0, "local": 1,
                  "durable": 2, "none": 3}

    def _restore_pinned(self, step: int) -> "tuple[str, int, dict]":
        """Pin-restore the exact ``step`` from disk (the rollback
        primitive): ``CheckpointCorruptError`` when its directory is
        torn, ``FileNotFoundError`` when it is gone."""
        disk = self._disk_best(at_step=step)
        if disk is None:
            seen = []
            for d in (self.local_dir, self.directory):
                if not d:
                    continue
                full = os.path.join(d, f"{self._name}-{step}")
                if os.path.isdir(full):
                    raise CheckpointCorruptError(
                        f"pinned step {step}: {full} exists but is "
                        f"torn/incomplete — refusing to fall back to "
                        f"a different version")
                seen.append(d)
            raise FileNotFoundError(
                f"pinned step {step}: no intact {self._name}-{step} "
                f"under {seen} (pruned by rotation?)")
        got, path, tier = disk
        restored = self.checkpoint.restore(path)
        telemetry.event("recovery.restore_tier", tier=tier, step=got,
                        pinned=True)
        self.checkpoint._save_counter = int(got)
        return tier, int(got), restored

    def restore_latest(self, *, timeout_s: float = 60.0,
                       at_step: int | None = None
                       ) -> "tuple[str, int, dict] | None":
        """Restore down the ladder host > peer > local > durable (JAX's;
        collective with a ``snapshot_store`` in a distributed job: once
        per generation on every process). Emits ``recovery.
        restore_tier``; returns ``(tier, step, flat_restored)`` or None.
        ``at_step`` pins one exact step (disk tiers only)."""
        if at_step is not None:
            return self._restore_pinned(int(at_step))
        from distributed_tensorflow_tpu_torch.checkpoint import (
            peer_snapshot as _ps)
        from distributed_tensorflow_tpu_torch.cluster import elastic
        agent = _agent()
        disk = self._disk_best()
        decision = None
        if self.snapshot_store is not None:
            self.snapshot_store.load_surviving()
            try:
                decision = _ps.negotiate(self.snapshot_store, agent, disk,
                                         timeout_s=timeout_s)
            except Exception:
                decision = None
        tier, step, restored, old_world = None, None, None, None
        mem_step = None
        if decision is not None:
            mem_step = (decision.get("step")
                        if decision.get("source") == "memory"
                        else decision.get("mem_step"))
        if decision is not None and decision.get("source") == "memory":
            try:
                remote = _ps.any_fetched_remotely(self.snapshot_store,
                                                  decision)
                parts = _ps.fetch_parts(self.snapshot_store, agent,
                                        decision, timeout_s=timeout_s)
                index = parts[0].index
                restored = self.checkpoint.restore_from_parts(parts, index)
                tier = "peer" if remote else "host"
                step = int(decision["step"])
                old_world = int(decision.get("world", len(parts)))
            except Exception:
                restored = None
        if restored is None:
            if decision is not None and decision.get("source") == "disk":
                step, path, tier = (int(decision["step"]),
                                    decision["path"], decision["tier"])
            elif disk is not None:
                step, path, tier = disk
            else:
                path = None
            if path is not None:
                restored = self.checkpoint.restore(path)
                old_world = len([f for f in os.listdir(path)
                                 if re.match(r"shard_\d+\.npz$", f)])
            else:
                tier, step = None, None
        local_cks = (self._list_checkpoints(self.local_dir)
                     if self.local_dir else [])
        durable_cks = self._list_checkpoints()
        available = {
            "memory": mem_step,
            "local": local_cks[-1][0] if local_cks else None,
            "durable": durable_cks[-1][0] if durable_cks else None,
        }
        best_step = max((s for s in available.values() if s is not None),
                        default=None)
        best_available = "none" if best_step is None else min(
            (t for t, s in available.items() if s == best_step),
            key=lambda t: self._TIER_RANK[t])
        self.last_restore = {"tier": tier or "none", "step": step,
                             "available": available,
                             "best_available": best_available}
        telemetry.event(
            "recovery.restore_tier",
            tier=tier or "none", step=step,
            generation=elastic.generation(),
            world=agent.num_processes, old_world=old_world,
            resharded=(old_world is not None
                       and old_world != agent.num_processes),
            available=available, best_available=best_available)
        if restored is None:
            return None
        self.checkpoint._save_counter = int(step)
        return tier, int(step), restored


def latest_checkpoint(directory: str, name: str = "ckpt",
                      at_step: int | None = None) -> str | None:
    """The freshest intact checkpoint under ``directory``; ``at_step``:
    that exact step's path, or ``CheckpointCorruptError`` (torn) /
    ``FileNotFoundError`` (absent)."""
    mgr = CheckpointManager(Checkpoint(), directory, checkpoint_name=name)
    if at_step is None:
        return mgr.latest_checkpoint
    best = mgr._disk_best(at_step=int(at_step))
    if best is None:
        full = os.path.join(directory, f"{name}-{int(at_step)}")
        if os.path.isdir(full):
            raise CheckpointCorruptError(
                f"pinned step {at_step}: {full} exists but is "
                f"torn/incomplete")
        raise FileNotFoundError(
            f"pinned step {at_step}: no intact {name}-{at_step} under "
            f"{directory} (pruned by rotation?)")
    return best[1]

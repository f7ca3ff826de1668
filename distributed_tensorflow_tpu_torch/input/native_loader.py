"""The native C++ data-pipeline core of the port — port of
``distributed_tensorflow_tpu/input/native_loader.py``.

File IO, per-epoch shuffle, DATA-policy sharding and batch assembly run
in native threads (``native/pipeline.cc``, the port's own copy of the
JAX package's source, the same C ABI); Python gets each batch as a
numpy array. The library is built with ``g++`` at first use, never at
import, into ``build/torch_native/`` at the repository root under a
name hashed from the source and the flags (``ops/_build.py
hashed_path``), so an edited source is rebuilt and a stale library is
never loaded. A failed build raises.

    g++ -O3 -fPIC -shared -pthread -std=c++17 -o <lib> pipeline.cc -lz

On-disk formats: fixed-size binary records (one structured-dtype numpy
record each; :func:`write_records`), and TFRecord framing (length +
masked crc32c; :func:`write_tfrecords`, plain, GZIP or ZLIB).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from distributed_tensorflow_tpu_torch.ops._build import REPO_ROOT, hashed_path

_SRC_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "pipeline.cc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_native")
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    return hashed_path(BUILD_DIR, "dtx_pipeline", (_SRC_PATH,), GXX_FLAGS)


def build() -> str:
    """Compile ``native/pipeline.cc`` unless its library exists; returns
    the library path. Raises with the compiler's output on failure."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC_PATH, "-lz"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for native/pipeline.cc (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.dtx_pipeline_create.restype = ctypes.c_void_p
        lib.dtx_pipeline_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.dtx_pipeline_next.restype = ctypes.c_void_p
        lib.dtx_pipeline_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.dtx_pipeline_return.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dtx_pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib.dtx_pipeline_num_records.restype = ctypes.c_int64
        lib.dtx_pipeline_num_records.argtypes = [ctypes.c_void_p]
        lib.dtx_pipeline_batches_per_epoch.restype = ctypes.c_int64
        lib.dtx_pipeline_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.dtx_tfrecord_create.restype = ctypes.c_void_p
        lib.dtx_tfrecord_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dtx_pipeline_row_bytes.restype = ctypes.c_int64
        lib.dtx_pipeline_row_bytes.argtypes = [ctypes.c_void_p]
        lib.dtx_pipeline_failed.restype = ctypes.c_int
        lib.dtx_pipeline_failed.argtypes = [ctypes.c_void_p]
        lib.dtx_pipeline_next2.restype = ctypes.c_void_p
        lib.dtx_pipeline_next2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return lib


def write_records(path: str, array: np.ndarray) -> None:
    """Write a (N, ...) array as N fixed-size records."""
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(array).tobytes())


def write_tfrecords(path: str, payloads, compression: str | None = None
                    ) -> None:
    """Write byte payloads in TFRecord framing (length + masked crc32c),
    readable by :class:`NativeTFRecordDataset` and by TensorFlow.
    ``compression``: None | "GZIP" | "ZLIB" (≙ TFRecordOptions
    compression_type)."""
    from distributed_tensorflow_tpu_torch.utils.summary import tfrecord_frame
    if compression is None:
        with open(path, "wb") as f:          # streaming: O(one record)
            for p in payloads:
                f.write(tfrecord_frame(bytes(p)))
        return
    if compression == "GZIP":
        import gzip
        with gzip.open(path, "wb") as f:     # streaming
            for p in payloads:
                f.write(tfrecord_frame(bytes(p)))
        return
    if compression == "ZLIB":
        import zlib
        comp = zlib.compressobj()
        with open(path, "wb") as f:
            for p in payloads:
                f.write(comp.compress(tfrecord_frame(bytes(p))))
            f.write(comp.flush())
        return
    raise ValueError(f"compression={compression!r}; expected "
                     f"None, 'GZIP' or 'ZLIB'")


class _NativePipelineBase:
    """Shared lifecycle of the native pipeline handles: path
    normalisation, existence checks, counters, the iteration protocol,
    close/__del__ and failure propagation (``dtx_pipeline_failed``)."""

    def _open(self, paths, create_fn):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._paths = [os.fspath(p) for p in paths]
        missing = [p for p in self._paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"no such record file(s): {missing}")
        self._lib = _load()
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths])
        self._h = create_fn(self._lib, arr, len(self._paths))
        if not self._h:
            raise ValueError(
                f"native pipeline rejected {self._paths} (empty shard, "
                f"shard smaller than a batch, or corrupt framing)")

    @property
    def num_records(self) -> int:
        return self._lib.dtx_pipeline_num_records(self._h)

    @property
    def batches_per_epoch(self) -> int:
        return self._lib.dtx_pipeline_batches_per_epoch(self._h)

    def _check_stream_end(self):
        """nullptr from Next: tell a data failure from shutdown."""
        if self._lib.dtx_pipeline_failed(self._h):
            raise ValueError(
                f"native pipeline failed mid-stream on {self._paths} "
                f"(IO error or crc mismatch)")
        raise StopIteration

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.dtx_pipeline_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativeRecordDataset(_NativePipelineBase):
    """Iterator of ``(batch_array, epoch)`` with native prefetch.

    ``record_dtype`` / ``record_shape`` describe ONE record; batches come
    back as ``(batch, *record_shape)`` arrays. ``num_shards`` /
    ``shard_index`` select this host's partition (≙ DATA auto-sharding).
    """

    def __init__(self, paths, record_dtype, record_shape, batch_size: int,
                 *, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, queue_depth: int = 8,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_remainder: bool = True):
        self.record_dtype = np.dtype(record_dtype)
        self.record_shape = tuple(record_shape)
        self.record_bytes = (self.record_dtype.itemsize
                             * int(np.prod(self.record_shape or (1,))))
        self.batch_size = batch_size
        self._open(paths, lambda lib, arr, n: lib.dtx_pipeline_create(
            arr, n, self.record_bytes, batch_size, int(shuffle), seed,
            num_threads, queue_depth, num_shards, shard_index,
            int(drop_remainder)))

    def next_batch(self):
        """Blocking: ``(array, epoch)``. The array is a COPY (the native
        buffer is returned at once)."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        epoch = ctypes.c_int64()
        bh = self._lib.dtx_pipeline_next(
            self._h, ctypes.byref(data), ctypes.byref(n),
            ctypes.byref(epoch))
        if not bh:
            self._check_stream_end()
        try:
            nbytes = int(n.value) * self.record_bytes
            flat = np.ctypeslib.as_array(data, shape=(nbytes,))
            out = flat.view(self.record_dtype).reshape(
                (int(n.value),) + self.record_shape).copy()
        finally:
            self._lib.dtx_pipeline_return(self._h, bh)
        return out, int(epoch.value)


class NativeTFRecordDataset(_NativePipelineBase):
    """Native TFRecord reader with shuffle, shard and prefetch.

    The framing scan (seek-only, length bounds validated), per-epoch
    shuffle, DATA-policy sharding and threaded batch assembly run in
    native code; the worker threads verify each payload's crc32c as they
    read it. Batches come as a zero-padded ``(batch, max_record_bytes)``
    uint8 array and the rows' lengths; :meth:`next_records` gives the
    payloads as bytes.
    """

    def __init__(self, paths, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 4, queue_depth: int = 8,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_remainder: bool = True, verify_crc: bool = True):
        self.batch_size = batch_size
        self._open(paths, lambda lib, arr, n: lib.dtx_tfrecord_create(
            arr, n, batch_size, int(shuffle), seed, num_threads,
            queue_depth, num_shards, shard_index, int(drop_remainder),
            int(verify_crc)))
        self.row_bytes = self._lib.dtx_pipeline_row_bytes(self._h)

    def next_batch(self):
        """Blocking: ``(padded_uint8_array, lengths, epoch)``; the arrays
        are COPIES (the native buffers are returned at once)."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        lengths = ctypes.POINTER(ctypes.c_int64)()
        n = ctypes.c_int64()
        epoch = ctypes.c_int64()
        bh = self._lib.dtx_pipeline_next2(
            self._h, ctypes.byref(data), ctypes.byref(lengths),
            ctypes.byref(n), ctypes.byref(epoch))
        if not bh:
            self._check_stream_end()
        try:
            count = int(n.value)
            flat = np.ctypeslib.as_array(
                data, shape=(count * self.row_bytes,))
            rows = flat.reshape(count, self.row_bytes).copy()
            lens = np.ctypeslib.as_array(lengths, shape=(count,)).copy()
        finally:
            self._lib.dtx_pipeline_return(self._h, bh)
        return rows, lens, int(epoch.value)

    def next_records(self):
        """Blocking: the next batch as a list of payload ``bytes``."""
        rows, lens, epoch = self.next_batch()
        return [rows[i, :lens[i]].tobytes()
                for i in range(rows.shape[0])], epoch

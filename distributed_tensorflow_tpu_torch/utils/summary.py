"""Minimal TensorBoard summary writer — port of
``distributed_tensorflow_tpu/utils/summary.py`` (pure Python).

The encoders are JAX's, so an event file holds the same bytes as the
JAX package's for the same scalars, steps and wall times.

≙ the reference's metrics/observability path (SURVEY.md §5.5:
tf.summary scalar writing + monitoring gauges). Event files are written
in the exact format TensorBoard reads: TFRecord-framed Event protos.
Both the protobuf wire encoding (only the handful of fields scalar
summaries need) and the masked-crc32c record framing are hand-rolled
here — ~100 lines replacing the reference's summary-writer C++ stack
for the scalar/text cases that matter for training loops.

    writer = SummaryWriter(logdir)
    writer.scalar("loss", 0.31, step=100)
    writer.flush()

Gauges (≙ tf.monitoring.*Gauge) are process-local observability cells;
``strategy_gauge`` records which strategy class is active, matching the
reference's distribution-strategy usage gauges (distribute_lib.py:190).
"""

from __future__ import annotations

import os
import struct
import threading
import time


# ---------------------------------------------------------------------------
# protobuf wire encoding (just what Event/Summary need)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _encode_scalar_event(tag: str, value: float, step: int,
                         wall_time: float) -> bytes:
    # Summary.Value { tag=1, simple_value=2 }
    sval = _len_delim(1, tag.encode()) + _float(2, value)
    # Summary { value=1 (repeated) }
    summary = _len_delim(1, sval)
    # Event { wall_time=1 (double), step=2 (int64), summary=5 }
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _encode_file_version(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3 (string) }
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _len_delim(field, payload)


def _encode_histogram_event(tag: str, values, step: int,
                            wall_time: float, bins: int = 30) -> bytes:
    """Event carrying a HistogramProto (≙ tf.summary.histogram v1 wire
    format, which TensorBoard's histograms/distributions dashboards read).

    HistogramProto { min=1, max=2, num=3, sum=4, sum_squares=5,
                     bucket_limit=6 (packed double), bucket=7 } —
    bucket_limit[i] is the INCLUSIVE upper edge of bucket i.
    """
    import numpy as np
    arr = np.asarray(values, dtype=np.float64).ravel()
    # Log the finite subset: a diverging model (NaN/Inf weights) is
    # exactly when users turn on histograms, and np.histogram raises on
    # a non-finite range.
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        arr = np.zeros((1,))
    lo, hi = float(arr.min()), float(arr.max())
    if lo == hi:                       # single-value histogram
        edges = np.array([lo, lo + 1e-12])
        counts = np.array([float(arr.size)])
    else:
        counts, edges = np.histogram(arr, bins=bins)
        counts = counts.astype(np.float64)
    histo = (_double(1, lo) + _double(2, hi)
             + _double(3, float(arr.size)) + _double(4, float(arr.sum()))
             + _double(5, float(np.square(arr).sum()))
             + _packed_doubles(6, edges[1:]) + _packed_doubles(7, counts))
    # Summary.Value { tag=1, histo=5 }
    sval = _len_delim(1, tag.encode()) + _len_delim(5, histo)
    summary = _len_delim(1, sval)
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


# ---------------------------------------------------------------------------
# TFRecord framing with masked crc32c
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_crc_table():
    poly = 0x82F63B78          # Castagnoli, reflected
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def tfrecord_frame(payload: bytes) -> bytes:
    """Frame one payload in TFRecord format (length + masked crc32c +
    payload + masked crc32c)."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


_tfrecord = tfrecord_frame   # internal alias


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _SharedEventFile:
    """One physical event file, shared by every SummaryWriter a process
    opens on the same (logdir, suffix). Two writers created within the
    same wall second used to collide on the timestamped file name with
    independent handles — interleaved TFRecord frames through separate
    buffers tear the file. One handle per process + one lock makes
    concurrent writers safe by construction."""

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.Lock()
        self.refs = 0
        self._f = open(path, "ab")
        self.write(_encode_file_version(time.time()))

    def write(self, event: bytes):
        with self.lock:
            self._f.write(_tfrecord(event))

    def flush(self):
        with self.lock:
            self._f.flush()

    def close_handle(self):
        with self.lock:
            self._f.flush()
            self._f.close()


class SummaryWriter:
    """Append-only scalar summary writer (TensorBoard event file).

    Concurrency: all writers a process opens on the same ``logdir`` (and
    suffix) share ONE file handle with locked, whole-frame writes; use
    as a context manager or call :meth:`close` when done.
    """

    _OPEN: "dict[tuple[str, str], _SharedEventFile]" = {}
    _OPEN_LOCK = threading.Lock()

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        key = (os.path.realpath(logdir), filename_suffix)
        with SummaryWriter._OPEN_LOCK:
            shared = SummaryWriter._OPEN.get(key)
            if shared is None:
                fname = (f"events.out.tfevents.{int(time.time())}."
                         f"{os.uname().nodename}.{os.getpid()}"
                         f"{filename_suffix}")
                shared = _SharedEventFile(os.path.join(logdir, fname))
                SummaryWriter._OPEN[key] = shared
            shared.refs += 1
        self._key = key
        self._shared = shared
        self._closed = False
        self.path = shared.path

    def _write(self, event: bytes):
        if self._closed:
            raise ValueError(f"SummaryWriter for {self.path} is closed")
        self._shared.write(event)

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None):
        self._write(_encode_scalar_event(
            tag, float(value), int(step),
            time.time() if wall_time is None else wall_time))

    def scalars(self, values: dict, step: int):
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def histogram(self, tag: str, values, step: int,
                  wall_time: float | None = None, bins: int = 30):
        """Histogram summary (≙ tf.summary.histogram): weight/gradient
        distributions for TensorBoard's histograms dashboard."""
        self._write(_encode_histogram_event(
            tag, values, int(step),
            time.time() if wall_time is None else wall_time, bins=bins))

    def flush(self):
        self._shared.flush()

    def close(self):
        """Release this writer's reference; the underlying file handle
        closes when the last writer on the (logdir, suffix) closes.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        with SummaryWriter._OPEN_LOCK:
            self._shared.refs -= 1
            last = self._shared.refs == 0
            if last:
                SummaryWriter._OPEN.pop(self._key, None)
        if last:
            self._shared.close_handle()
        else:
            self._shared.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Monitoring gauges (≙ tf.monitoring — process-local observability)
# ---------------------------------------------------------------------------

class Gauge:
    """Named cell set to the latest value (≙ monitoring.StringGauge).

    Also exported through the unified telemetry MetricsRegistry (under
    ``monitoring<name>``), so tf.monitoring-style gauges appear in
    registry snapshots and cross-host fleet rollups.
    """

    kind = "gauge"

    _REGISTRY: dict = {}
    _LOCK = threading.Lock()

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = None
        with Gauge._LOCK:
            Gauge._REGISTRY[name] = self
        from distributed_tensorflow_tpu_torch.telemetry import registry as _treg
        _treg.get_registry().register(self, f"monitoring{name}"
                                      if name.startswith("/")
                                      else f"monitoring/{name}")

    def set(self, value):
        self._value = value

    def value(self):
        return self._value

    def export(self) -> dict:
        return {"type": "gauge", "value": self._value}

    @classmethod
    def all_gauges(cls) -> dict:
        with cls._LOCK:
            return {k: g.value() for k, g in cls._REGISTRY.items()}


# ---------------------------------------------------------------------------
# Reading event files back (the reverse of the writer above): scalar
# series for tests and tools/obs_report.py — no TensorBoard dependency.
# ---------------------------------------------------------------------------

def _decode_fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over one proto message.
    value is raw bytes for len-delimited fields, int for varint/fixed."""
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == 0:                     # varint
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, v
        elif wire == 1:                   # fixed64
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:                   # len-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:                   # fixed32
            yield field, wire, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def read_event_records(path: str):
    """Iterate raw TFRecord payloads from an event file, verifying the
    masked crc32c of each frame."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(header) != hcrc:
                raise ValueError(f"{path}: corrupt record header")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if len(payload) < length or _masked_crc(payload) != pcrc:
                raise ValueError(f"{path}: corrupt record payload")
            yield payload


def read_scalars(path: str) -> "list[tuple[str, int, float]]":
    """All scalar summaries in an event file as (tag, step, value)."""
    out = []
    for payload in read_event_records(path):
        step = 0
        summary = None
        for field, wire, v in _decode_fields(payload):
            if field == 2 and wire == 0:          # Event.step
                step = v
            elif field == 5 and wire == 2:        # Event.summary
                summary = v
        if summary is None:
            continue
        for field, wire, v in _decode_fields(summary):
            if field != 1 or wire != 2:
                continue                          # Summary.value entries
            tag, value = None, None
            for f2, w2, v2 in _decode_fields(v):
                if f2 == 1 and w2 == 2:
                    tag = v2.decode("utf-8", "replace")
                elif f2 == 2 and w2 == 5:
                    (value,) = struct.unpack("<f", v2)
            if tag is not None and value is not None:
                out.append((tag, step, value))
    return out


# ≙ distribute_lib.py:190 distribution_strategy_gauge: records which
# strategy the process is using (set by Strategy.scope).
strategy_gauge = Gauge("/tensorflow/api/distribution_strategy",
                       "active tf.distribute strategy class")
api_gauge = Gauge("/tensorflow/api/distribution_strategy/api",
                  "last distribution API used (scope/run/reduce)")

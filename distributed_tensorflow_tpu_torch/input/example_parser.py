"""tf.Example parsing — port of ``distributed_tensorflow_tpu/input/
example_parser.py``, line for line the same host logic (pure numpy and
the standard library; no torch is needed to parse).

≙ tf.io.parse_example / parse_single_example (reference:
tensorflow/python/ops/parsing_ops.py): the reference's input pipelines
read TFRecord files of serialized ``tf.train.Example`` protos and parse
them against a feature spec. This module decodes the proto wire format
directly (no TF dependency): Example{features=1} → Features{feature=1
map<string, Feature>} → Feature{bytes_list=1, float_list=2,
int64_list=3}. The crc and the TFRecord and varint framing come from
the port's ``utils/summary.py``.

Specs mirror the reference's:
- ``FixedLenFeature(shape, dtype, default_value=None)`` — dense output,
  per-example values reshaped to ``shape``; missing features use the
  default or raise.
- ``VarLenFeature(dtype)`` — ragged output, returned per example as a
  1-D numpy array (the reference returns a SparseTensor; the framework keeps
  host data dense/ragged and lets the embedding layer's combiners
  handle variable length).

Wire-format notes: ``float_list`` and ``int64_list`` values are packed
(one length-delimited payload) or repeated scalars — both occur in real
files and both are handled.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class FixedLenFeature:
    shape: tuple = ()
    dtype: Any = np.float32
    default_value: Any = None


@dataclasses.dataclass(frozen=True)
class VarLenFeature:
    dtype: Any = np.float32


@dataclasses.dataclass(frozen=True)
class FixedLenSequenceFeature:
    """Per-step dense feature of a SequenceExample FeatureList
    (≙ tf.io.FixedLenSequenceFeature, TF/python/ops/parsing_config.py):
    parses to (num_steps, *shape)."""
    shape: tuple = ()
    dtype: Any = np.float32
    allow_missing: bool = False


@dataclasses.dataclass(frozen=True)
class SparseFeature:
    """≙ tf.io.SparseFeature: a sparse value assembled from an
    index-carrying feature and a value-carrying feature of the SAME
    Example. Parses to a :class:`SparseValue`."""
    index_key: str
    value_key: str
    dtype: Any = np.float32
    size: int = 0
    already_sorted: bool = False


@dataclasses.dataclass(frozen=True)
class RaggedFeature:
    """≙ tf.io.RaggedFeature. The value-only form parses to a 1-D array
    per example; with ``partitions`` (outermost first, the tf.io inner
    classes below — TF/python/ops/parsing_config.py RaggedFeature) it
    parses to a :class:`RaggedValue` carrying the nested row-splits,
    matching ``tf.RaggedTensor.from_nested_row_splits`` semantics."""
    dtype: Any = np.float32
    value_key: str | None = None
    partitions: tuple = ()
    row_splits_dtype: Any = np.int64

    @dataclasses.dataclass(frozen=True)
    class RowLengths:
        key: str

    @dataclasses.dataclass(frozen=True)
    class RowSplits:
        key: str

    @dataclasses.dataclass(frozen=True)
    class RowStarts:
        key: str

    @dataclasses.dataclass(frozen=True)
    class RowLimits:
        key: str

    @dataclasses.dataclass(frozen=True)
    class ValueRowIds:
        key: str

    @dataclasses.dataclass(frozen=True)
    class UniformRowLength:
        length: int


@dataclasses.dataclass(frozen=True)
class RaggedValue:
    """Host-side ragged tensor: flat ``values`` + ``nested_row_splits``
    (outermost first) — ≙ tf.RaggedTensor.from_nested_row_splits."""
    values: np.ndarray
    nested_row_splits: tuple

    def to_list(self):
        def build(level, lo, hi):
            if level == len(self.nested_row_splits):
                return self.values[lo:hi].tolist()
            splits = self.nested_row_splits[level]
            return [build(level + 1, int(splits[i]), int(splits[i + 1]))
                    for i in range(lo, hi)]
        outer = self.nested_row_splits[0]
        return [build(1, int(outer[i]), int(outer[i + 1]))
                for i in range(len(outer) - 1)]


@dataclasses.dataclass(frozen=True)
class SparseValue:
    """Host-side sparse triplet (≙ tf.SparseTensor restricted to 1-D)."""
    indices: np.ndarray
    values: np.ndarray
    dense_shape: tuple

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.dense_shape, self.values.dtype)
        np.add.at(out, self.indices.astype(np.int64), self.values)
        return out


# ---------------------------------------------------------------------------
# Proto wire decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated message")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message payload.
    Length-delimited values are returned as memoryview slices."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            if pos + 8 > n:
                raise ValueError("truncated message")
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                # A declared length running past the buffer end means a
                # truncated/corrupt proto; silently clipping the slice
                # would yield WRONG feature values downstream.
                raise ValueError("truncated message")
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            if pos + 4 > n:
                raise ValueError("truncated message")
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _zigzag_passthrough_int64(v: int) -> int:
    """int64_list values are plain (non-zigzag) varints; reinterpret the
    unsigned decode as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_float_list(payload: bytes) -> np.ndarray:
    floats: list = []
    for field, wire, val in _fields(payload):
        if field != 1:
            continue
        if wire == 2:               # packed
            floats.extend(
                struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif wire == 5:             # repeated scalar
            floats.append(struct.unpack("<f", bytes(val))[0])
    return np.asarray(floats, np.float32)


def _decode_int64_list(payload: bytes) -> np.ndarray:
    ints: list = []
    for field, wire, val in _fields(payload):
        if field != 1:
            continue
        if wire == 2:               # packed varints
            pos, ln = 0, len(val)
            while pos < ln:
                v, pos = _read_varint(val, pos)
                ints.append(_zigzag_passthrough_int64(v))
        elif wire == 0:
            ints.append(_zigzag_passthrough_int64(val))
    return np.asarray(ints, np.int64)


def _decode_bytes_list(payload: bytes) -> list:
    return [bytes(val) for field, wire, val in _fields(payload)
            if field == 1 and wire == 2]


def _decode_feature(payload: bytes):
    """Feature { bytes_list=1, float_list=2, int64_list=3 } — each a
    wire-type-2 submessage; other wire types are malformed and skipped."""
    for field, wire, val in _fields(payload):
        if wire != 2:
            continue
        if field == 1:
            return _decode_bytes_list(bytes(val))
        if field == 2:
            return _decode_float_list(bytes(val))
        if field == 3:
            return _decode_int64_list(bytes(val))
    return np.asarray([], np.float32)      # empty Feature


def _parse_features_map(buf: bytes) -> dict:
    """Features { feature = 1 map<string, Feature> } payload → raw
    {name: decoded values}."""
    raw: dict = {}
    for f2, w2, fval in _fields(buf):
        if f2 != 1 or w2 != 2:              # Features.feature (map entry)
            continue
        name = value = None
        for f3, w3, v3 in _fields(bytes(fval)):
            if w3 != 2:
                continue
            if f3 == 1:
                name = bytes(v3).decode()
            elif f3 == 2:
                value = _decode_feature(bytes(v3))
        if name is not None:
            raw[name] = value
    return raw


def _dense_from_raw(name, spec, value):
    """Resolve one FixedLenFeature against a raw decoded value."""
    if value is None or (hasattr(value, "__len__") and len(value) == 0):
        if spec.default_value is None:
            raise ValueError(
                f"feature {name!r} missing and no default_value")
        value = np.broadcast_to(
            np.asarray(spec.default_value, spec.dtype),
            spec.shape).copy()
    n_expect = int(np.prod(spec.shape)) if spec.shape else 1
    arr = np.asarray(value)
    if arr.size != n_expect:
        raise ValueError(
            f"feature {name!r}: got {arr.size} values, spec shape "
            f"{spec.shape} needs {n_expect}")
    return arr.reshape(spec.shape).astype(spec.dtype) \
        if spec.shape else arr.reshape(()).astype(spec.dtype)


def _ragged_from_raw(spec, value):
    if value is None:
        value = np.asarray([], spec.dtype)
    return np.asarray(value).astype(spec.dtype) \
        if not isinstance(value, list) else value


def _partition_splits(name, part, raw, n_next, splits_dtype):
    """Row splits for ONE ragged partition level over ``n_next`` inner
    items (≙ each RaggedFeature partition class's semantics in
    TF/python/ops/parsing_ops.py _parse_ragged_feature)."""
    RF = RaggedFeature
    if isinstance(part, RF.UniformRowLength):
        L = int(part.length)
        if L <= 0:
            raise ValueError(
                f"RaggedFeature {name!r}: UniformRowLength must be "
                f"positive, got {L}")
        if n_next % L:
            raise ValueError(
                f"RaggedFeature {name!r}: {n_next} inner items do not "
                f"divide into uniform rows of length {L}")
        return np.arange(0, n_next + 1, L, dtype=splits_dtype)
    key = np.asarray(raw.get(part.key, []), np.int64)
    if isinstance(part, RF.RowLengths):
        splits = np.concatenate([[0], np.cumsum(key)])
    elif isinstance(part, RF.RowSplits):
        splits = key
    elif isinstance(part, RF.RowStarts):
        splits = np.concatenate([key, [n_next]])
    elif isinstance(part, RF.RowLimits):
        splits = np.concatenate([[0], key])
    elif isinstance(part, RF.ValueRowIds):
        nrows = int(key.max()) + 1 if key.size else 0
        if key.size and (np.any(np.diff(key) < 0) or key.min() < 0):
            raise ValueError(
                f"RaggedFeature {name!r}: ValueRowIds feature "
                f"{part.key!r} must be nonnegative and nondecreasing")
        splits = np.concatenate(
            [[0], np.cumsum(np.bincount(key, minlength=nrows))])
    else:
        raise TypeError(
            f"RaggedFeature {name!r}: unsupported partition "
            f"{type(part).__name__}")
    splits = np.asarray(splits, splits_dtype)
    if (splits.size == 0 or splits[0] != 0
            or np.any(np.diff(splits) < 0) or splits[-1] != n_next):
        raise ValueError(
            f"RaggedFeature {name!r}: partition "
            f"{type(part).__name__} yields invalid row_splits "
            f"{splits.tolist()} over {n_next} inner items")
    return splits


def _ragged_with_partitions(name, spec, raw):
    """RaggedValue from values + partition features, innermost level
    partitioning the flat values (≙ tf.io.RaggedFeature parsing with
    ``partitions``; output matches
    tf.RaggedTensor.from_nested_row_splits)."""
    values = _ragged_from_raw(spec, raw.get(spec.value_key or name))
    values = np.asarray(values, spec.dtype)
    nested = []
    n_next = values.size
    for part in reversed(spec.partitions):
        splits = _partition_splits(name, part, raw, n_next,
                                   spec.row_splits_dtype)
        nested.append(splits)
        n_next = splits.size - 1
    return RaggedValue(values, tuple(reversed(nested)))


def parse_single_example(serialized: bytes, features: dict) -> dict:
    """Parse ONE serialized tf.train.Example against a feature spec
    (≙ tf.io.parse_single_example). Specs: FixedLenFeature,
    VarLenFeature, SparseFeature, RaggedFeature."""
    raw: dict = {}
    # Submessages are ALWAYS wire type 2; a matching field number with a
    # different wire type is garbage input (e.g. a non-Example payload
    # whose varint would otherwise be misread as a huge bytes length).
    for field, wire, val in _fields(bytes(serialized)):
        if field != 1 or wire != 2:         # Example.features
            continue
        raw.update(_parse_features_map(bytes(val)))

    return {name: _resolve_example_spec(name, spec, raw)
            for name, spec in features.items()}


def _resolve_example_spec(name, spec, raw: dict):
    """Resolve one Example-level spec (FixedLen/VarLen/Sparse/Ragged)
    against the raw decoded feature map — shared by Example parsing and
    SequenceExample context parsing."""
    if isinstance(spec, SparseFeature):
        idx = np.asarray(raw.get(spec.index_key, []), np.int64)
        vals = np.asarray(raw.get(spec.value_key, []), spec.dtype)
        if idx.shape != vals.shape:
            raise ValueError(
                f"SparseFeature {name!r}: index feature "
                f"{spec.index_key!r} has {idx.size} entries but value "
                f"feature {spec.value_key!r} has {vals.size}")
        if not spec.already_sorted and idx.size:
            order = np.argsort(idx, kind="stable")
            idx, vals = idx[order], vals[order]
        return SparseValue(idx, vals, (spec.size,))
    if isinstance(spec, RaggedFeature):
        if spec.partitions:
            return _ragged_with_partitions(name, spec, raw)
        return _ragged_from_raw(spec, raw.get(spec.value_key or name))
    if isinstance(spec, VarLenFeature):
        return _ragged_from_raw(spec, raw.get(name))
    if isinstance(spec, FixedLenFeature):
        return _dense_from_raw(name, spec, raw.get(name))
    raise TypeError(f"feature {name!r}: unsupported spec "
                    f"{type(spec).__name__}")


def parse_single_sequence_example(serialized: bytes,
                                  context_features: dict | None = None,
                                  sequence_features: dict | None = None
                                  ) -> tuple[dict, dict]:
    """Parse ONE tf.train.SequenceExample (≙
    tf.io.parse_single_sequence_example, TF/python/ops/parsing_ops.py).

    Wire: SequenceExample { context = 1 (Features),
    feature_lists = 2 (FeatureLists { feature_list = 1
    map<string, FeatureList { feature = 1 repeated Feature }> }) }.

    context_features: FixedLen/VarLen/Sparse/Ragged specs over the
    context. sequence_features: FixedLenSequenceFeature → (T, *shape)
    dense; VarLenFeature / RaggedFeature → list of per-step 1-D arrays.
    """
    context_raw: dict = {}
    lists_raw: dict = {}
    for field, wire, val in _fields(bytes(serialized)):
        if wire != 2:
            continue
        if field == 1:                      # context Features
            context_raw.update(_parse_features_map(bytes(val)))
        elif field == 2:                    # FeatureLists
            for f2, w2, fval in _fields(bytes(val)):
                if f2 != 1 or w2 != 2:      # feature_list map entry
                    continue
                name, steps = None, []
                for f3, w3, v3 in _fields(bytes(fval)):
                    if w3 != 2:
                        continue
                    if f3 == 1:
                        name = bytes(v3).decode()
                    elif f3 == 2:           # FeatureList
                        steps = [_decode_feature(bytes(v4))
                                 for f4, w4, v4 in _fields(bytes(v3))
                                 if f4 == 1 and w4 == 2]
                if name is not None:
                    lists_raw[name] = steps

    context = {name: _resolve_example_spec(name, spec, context_raw)
               for name, spec in (context_features or {}).items()}

    sequences = {}
    for name, spec in (sequence_features or {}).items():
        steps = lists_raw.get(name)
        if isinstance(spec, FixedLenSequenceFeature):
            if steps is None:
                if not spec.allow_missing:
                    raise ValueError(
                        f"sequence feature {name!r} missing and "
                        f"allow_missing=False")
                steps = []
            n_expect = int(np.prod(spec.shape)) if spec.shape else 1
            rows = []
            for t, step in enumerate(steps):
                arr = np.asarray(step)
                if arr.size != n_expect:
                    raise ValueError(
                        f"sequence feature {name!r} step {t}: got "
                        f"{arr.size} values, spec shape {spec.shape} "
                        f"needs {n_expect}")
                rows.append(arr.reshape(spec.shape)
                            if spec.shape else arr.reshape(()))
            out_shape = (len(rows), *spec.shape)
            sequences[name] = (np.stack(rows).astype(spec.dtype)
                               if rows else
                               np.zeros(out_shape, spec.dtype))
        elif isinstance(spec, (VarLenFeature, RaggedFeature)):
            steps = steps or []
            sequences[name] = [
                np.asarray(s).astype(spec.dtype)
                if not isinstance(s, list) else s for s in steps]
        else:
            raise TypeError(f"sequence feature {name!r}: unsupported "
                            f"spec {type(spec).__name__}")
    return context, sequences


def parse_sequence_example(serialized_batch,
                           context_features: dict | None = None,
                           sequence_features: dict | None = None
                           ) -> tuple[dict, dict]:
    """Batched SequenceExample parsing (≙ tf.io.parse_sequence_example):
    context FixedLen features stack densely; everything else comes back
    as per-example lists (sequence lengths differ across examples)."""
    parsed = [parse_single_sequence_example(s, context_features,
                                            sequence_features)
              for s in serialized_batch]
    ctx_out: dict = {}
    for name, spec in (context_features or {}).items():
        vals = [p[0][name] for p in parsed]
        ctx_out[name] = np.stack(vals) \
            if isinstance(spec, FixedLenFeature) else vals
    seq_out = {name: [p[1][name] for p in parsed]
               for name in (sequence_features or {})}
    return ctx_out, seq_out


def parse_example(serialized_batch, features: dict) -> dict:
    """Parse a batch of serialized Examples into stacked dense arrays
    (FixedLenFeature) / lists of ragged arrays (VarLenFeature)
    (≙ tf.io.parse_example)."""
    parsed = [parse_single_example(s, features) for s in serialized_batch]
    out: dict = {}
    for name, spec in features.items():
        vals = [p[name] for p in parsed]
        out[name] = vals if isinstance(spec, VarLenFeature) \
            else np.stack(vals)
    return out


def example_reader(features: dict):
    """Reader for ``Dataset.from_files``: TFRecord file of tf.Examples →
    per-example parsed dicts (streaming, crc32c-verified). For raw
    fixed-size numeric records, ``input/native_loader`` has the C++
    threaded scanner; tf.Example payloads are variable-length and
    parsed here on the host."""

    def read(path: str) -> Iterator[dict]:
        for payload in iter_tfrecords(path):
            yield parse_single_example(payload, features)

    return read


class _ZlibStream:
    """Streaming decompressor with a file-like read() — keeps
    iter_tfrecords' O(one record) memory contract for ZLIB files."""

    _CHUNK = 1 << 16

    def __init__(self, f):
        import zlib
        self._f = f
        self._d = zlib.decompressobj()
        self._buf = b""

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            raw = self._f.read(self._CHUNK)
            if not raw:
                self._buf += self._d.flush()
                break
            self._buf += self._d.decompress(raw)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_maybe_compressed(path: str):
    """Open a TFRecord file, transparently decompressing GZIP/ZLIB
    streams (≙ TFRecordOptions compression_type,
    TF/python/lib/io/tf_record.py — real corpora are very often gzip
    TFRecords).

    Detection order matters: a VALID plain TFRecord header (length
    crc32c at offset 8 matches) wins over any magic-byte coincidence —
    an uncompressed file whose first record length encodes to
    0x78 0x01/0x5e/0x9c/0xda would otherwise be misread as ZLIB."""
    from distributed_tensorflow_tpu_torch.utils.summary import _masked_crc
    with open(path, "rb") as probe:
        head = probe.read(12)
    if len(head) == 12 and _masked_crc(head[:8]) == struct.unpack(
            "<I", head[8:12])[0]:
        return open(path, "rb")              # valid plain framing
    if head[:2] == b"\x1f\x8b":
        import gzip
        return gzip.open(path, "rb")
    if len(head) >= 2 and head[0] == 0x78 and head[1] in (
            0x01, 0x5e, 0x9c, 0xda):
        return _ZlibStream(open(path, "rb"))
    return open(path, "rb")


def iter_tfrecords(path: str) -> Iterator[bytes]:
    """Stream TFRecord framing (length + masked-crc + payload + crc),
    verifying the payload crc32c — a bit-flipped record raises instead
    of silently parsing into wrong feature values (same contract as the
    native scanner and TF's reader). Memory stays O(one record);
    GZIP/ZLIB files are decompressed transparently."""
    from distributed_tensorflow_tpu_torch.utils.summary import _masked_crc
    with _open_maybe_compressed(path) as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (ln,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if _masked_crc(header[:8]) != len_crc:
                raise ValueError(
                    f"TFRecord length crc mismatch in {path} (corrupt "
                    f"framing)")
            payload = f.read(ln)
            crc = f.read(4)
            if len(payload) < ln or len(crc) < 4:
                raise ValueError(f"truncated TFRecord payload in {path}")
            (expect,) = struct.unpack("<I", crc)
            if _masked_crc(payload) != expect:
                raise ValueError(
                    f"TFRecord payload crc mismatch in {path} (corrupt "
                    f"record of {ln} bytes)")
            yield payload


# ---------------------------------------------------------------------------
# Writer (tests / data prep): encode tf.train.Example — reuses the proto
# wire helpers from utils/summary (one implementation of varint framing).
# ---------------------------------------------------------------------------

from distributed_tensorflow_tpu_torch.utils.summary import (  # noqa: E402
    _len_delim, _varint)


def _encode_feature(name, value) -> bytes:
    """One Feature message body: floats → float_list (packed), ints →
    int64_list (packed), bytes/str → bytes_list."""
    if isinstance(value, (bytes, str)):
        value = [value]
    if isinstance(value, tuple):
        value = list(value)
    if isinstance(value, np.ndarray) and value.dtype.kind in "SUO":
        value = list(value.ravel())
    if isinstance(value, list) and not value:
        raise ValueError(
            f"feature {name!r}: empty list is ambiguous (bytes/"
            f"float/int64); pass a typed empty numpy array")
    if isinstance(value, list) \
            and isinstance(value[0], (bytes, str, np.bytes_, np.str_)):
        payload = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str)
                       else bytes(v))
            for v in value)
        return _len_delim(1, payload)           # bytes_list = 1
    arr = np.asarray(value).ravel()
    if arr.dtype == bool:
        # np.bool_ is not a np.integer subtype; without this a
        # bool feature lands in float_list and then fails the
        # int64 FixedLenFeature spec a migrating user writes.
        arr = arr.astype(np.int64)
    mask = (1 << 64) - 1
    if np.issubdtype(arr.dtype, np.integer):
        packed = b"".join(_varint(int(v) & mask) for v in arr)
        return _len_delim(3, _len_delim(1, packed))      # int64_list
    packed = b"".join(struct.pack("<f", float(v)) for v in arr)
    return _len_delim(2, _len_delim(1, packed))          # float_list


def _encode_features_map(feature_dict: dict) -> bytes:
    entries = b""
    for name, value in feature_dict.items():
        feat = _encode_feature(name, value)
        entry = _len_delim(1, name.encode()) + _len_delim(2, feat)
        entries += _len_delim(1, entry)
    return entries


def encode_example(feature_dict: dict) -> bytes:
    """Serialize {name: value} into a tf.train.Example wire message.
    floats → float_list (packed), ints → int64_list (packed),
    bytes/str (scalar, list/tuple, or numpy S/U/O array) → bytes_list.
    Empty values must come as a typed empty numpy array — a bare ``[]``
    is ambiguous between the three list types and raises."""
    return _len_delim(1, _encode_features_map(feature_dict))


def encode_sequence_example(context: dict, feature_lists: dict) -> bytes:
    """Serialize a tf.train.SequenceExample: ``context`` is an Example-
    style {name: value} dict; ``feature_lists`` maps name → list of
    per-step values (each encoded as one Feature)."""
    lists = b""
    for name, steps in feature_lists.items():
        flist = b"".join(_len_delim(1, _encode_feature(name, s))
                         for s in steps)
        entry = _len_delim(1, name.encode()) + _len_delim(2, flist)
        lists += _len_delim(1, entry)
    return (_len_delim(1, _encode_features_map(context))
            + _len_delim(2, lists))

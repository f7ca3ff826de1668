"""Append-only event-log stream source for online training — port of
``distributed_tensorflow_tpu/input/stream.py`` (pure numpy and bytes):
the log format is byte-identical, so either package reads a log the
other wrote, and :func:`seeded_events` draws the same events.

The streaming counterpart of the file-based ``Dataset`` sources: a
producer (the *ingestor*) appends length-prefixed records to a single
append-only log file with **monotonic offsets** (record index 0, 1,
2, ...), and a resumable :class:`StreamDataset` consumer tails the log
from any offset — the ``tf.data``-of-a-Kafka-topic shape the online
recommender scenario needs (ROADMAP item 2), built on plain files so
the whole topology runs under the existing chaos harness.

Record format (little-endian)::

    MAGIC(u16) | length(u32) | crc32(u32) | payload bytes

Crash semantics are the same contract the telemetry event logs keep
(telemetry/events.py): a **torn tail** — the unfinished last record of
a SIGKILL'd writer — is expected and invisible to readers (a record is
only yielded once its header, payload, and crc are all intact), while
mid-file damage raises :class:`StreamCorruptError` because the log can
no longer be trusted. A restarted producer opens the log with
:meth:`StreamWriter.open` which **truncates** any torn tail before
appending, so offsets stay contiguous across producer generations.

Exactly-once consumption is the CONSUMER's contract, by construction:
the trainer records its cursor (the next unapplied offset) *inside*
the same atomic checkpoint commit as the model state it fed
(``models/online_dlrm.OnlineTrainer``), so a killed-and-reformed trainer
replays exactly the records after the last commit — no lost events, no
double-applied events, regardless of where the kill landed between
apply and commit (the JAX package's tests/test_stream.py kills a
trainer there).
"""

from __future__ import annotations

import os
import pickle
import struct
import time
import zlib

import numpy as np

#: Record header: magic, payload length, payload crc32.
_MAGIC = 0x5EDA
_HEADER = struct.Struct("<HII")
HEADER_BYTES = _HEADER.size

#: Default log file name inside a stream directory.
LOG_NAME = "stream.log"


class StreamCorruptError(ValueError):
    """The log is damaged BEFORE its final record (torn tails are
    expected from crashed producers; mid-file damage is not)."""


def scan_log(path: str) -> tuple[int, int]:
    """Walk the log once: returns ``(record_count, clean_end_byte)``.

    ``clean_end_byte`` is the byte offset just past the last COMPLETE
    record — a torn tail (truncated header/payload or a crc mismatch on
    the final record) is excluded; damage before the final record
    raises :class:`StreamCorruptError`. ``(0, 0)`` for a missing file.
    """
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0, 0
    count = 0
    pos = 0
    with open(path, "rb") as f:
        while pos + HEADER_BYTES <= size:
            f.seek(pos)
            magic, length, crc = _HEADER.unpack(f.read(HEADER_BYTES))
            if magic != _MAGIC:
                raise StreamCorruptError(
                    f"{path}: bad record magic {magic:#x} at byte {pos} "
                    f"(mid-file corruption)")
            end = pos + HEADER_BYTES + length
            if end > size:
                break                     # torn tail: payload truncated
            payload = f.read(length)
            if zlib.crc32(payload) != crc:
                if end >= size:
                    break                 # torn tail: crc of last record
                raise StreamCorruptError(
                    f"{path}: record {count} at byte {pos} fails its "
                    f"crc32 (mid-file corruption)")
            count += 1
            pos = end
    return count, pos


def count_records(path: str) -> int:
    """Number of complete records in the log (cheap header walk)."""
    return scan_log(path)[0]


class StreamWriter:
    """Append-only producer handle for one log file.

    :meth:`open` is how every producer incarnation starts: it scans the
    existing log, TRUNCATES any torn tail left by a killed predecessor,
    and resumes appending at the next offset — so the log's offsets are
    contiguous and immutable across producer generations (a complete
    record is never rewritten; only a torn, never-readable tail is).
    """

    def __init__(self, path: str, *, _resume: tuple[int, int] = (0, 0)):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._next_offset, end = _resume
        self._f = open(path, "r+b" if os.path.exists(path) else "w+b")
        self._f.seek(end)
        self._f.truncate(end)

    @classmethod
    def open(cls, path: str) -> "StreamWriter":
        count, end = scan_log(path) if os.path.exists(path) else (0, 0)
        return cls(path, _resume=(count, end))

    @property
    def next_offset(self) -> int:
        return self._next_offset

    def append(self, payload: bytes) -> int:
        """Append one record; returns its offset. The write is a single
        buffered write of header+payload — call :meth:`flush` to make a
        batch of records visible to tailing consumers."""
        rec = _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) \
            + payload
        self._f.write(rec)
        off = self._next_offset
        self._next_offset += 1
        return off

    def append_event(self, event: dict) -> int:
        return self.append(pickle.dumps(event, protocol=4))

    def flush(self):
        self._f.flush()
        # no fsync: torn tails are tolerated by design; durability of
        # the MODEL rides the checkpoint commit protocol, not the log

    def close(self):
        self.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StreamReader:
    """Sequential record reader with a resumable cursor.

    ``seek(offset)`` positions before record ``offset`` (a header walk
    from the start — paid once per consumer incarnation);
    ``read_available()`` then yields every COMPLETE record currently in
    the file, advancing the cursor. An incomplete tail simply ends the
    iteration (the producer may still be writing it) — call again after
    the producer flushes more.
    """

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._pos = 0

    @property
    def offset(self) -> int:
        """Next offset this reader will yield."""
        return self._offset

    def seek(self, offset: int):
        """Position before record ``offset``; raises if the log holds
        fewer complete records (the caller asked to resume past the
        end of history)."""
        count, pos = 0, 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        with open(self.path, "rb") if size else _nullfile() as f:
            while count < offset:
                if pos + HEADER_BYTES > size:
                    raise ValueError(
                        f"{self.path}: cannot seek to offset {offset}; "
                        f"log holds only {count} complete record(s)")
                f.seek(pos)
                magic, length, _crc = _HEADER.unpack(f.read(HEADER_BYTES))
                if magic != _MAGIC:
                    raise StreamCorruptError(
                        f"{self.path}: bad magic at byte {pos}")
                end = pos + HEADER_BYTES + length
                if end > size:
                    raise ValueError(
                        f"{self.path}: cannot seek to offset {offset}; "
                        f"log holds only {count} complete record(s)")
                count += 1
                pos = end
        self._offset, self._pos = offset, pos

    def read_available(self):
        """Yield ``(offset, payload_bytes)`` for every complete record
        from the cursor to the current end of file."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size <= self._pos:
            return
        with open(self.path, "rb") as f:
            while self._pos + HEADER_BYTES <= size:
                f.seek(self._pos)
                magic, length, crc = _HEADER.unpack(f.read(HEADER_BYTES))
                if magic != _MAGIC:
                    raise StreamCorruptError(
                        f"{self.path}: bad record magic at byte "
                        f"{self._pos}")
                end = self._pos + HEADER_BYTES + length
                if end > size:
                    return                # tail still being written
                payload = f.read(length)
                if zlib.crc32(payload) != crc:
                    if end >= size:
                        return            # torn final record
                    raise StreamCorruptError(
                        f"{self.path}: record {self._offset} fails "
                        f"crc32")
                off = self._offset
                self._offset += 1
                self._pos = end
                yield off, payload


class _nullfile:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class StreamDataset:
    """Resumable tailing consumer over one event log.

    Yields ``(offset, event_dict)`` in offset order starting at
    ``start_offset``, polling the file for new records (the producer
    may still be appending). Iteration ends when ``end_offset`` records
    have been yielded, or after ``idle_timeout_s`` with no new data
    (producer gone) — whichever is configured.
    """

    def __init__(self, path: str, *, start_offset: int = 0,
                 poll_s: float = 0.05):
        self.path = path
        self.start_offset = start_offset
        self.poll_s = poll_s

    def events(self, *, end_offset: int | None = None,
               idle_timeout_s: float | None = None):
        if end_offset is not None and self.start_offset >= end_offset:
            return                      # already consumed to the end
        reader = StreamReader(self.path)
        if self.start_offset:
            # resume cursor: the log may not hold our offset yet (a
            # reformed trainer can come back before the reformed
            # producer re-appends) — wait for it
            deadline = (time.monotonic() + idle_timeout_s
                        if idle_timeout_s else None)
            while True:
                try:
                    reader.seek(self.start_offset)
                    break
                except ValueError:
                    if deadline and time.monotonic() > deadline:
                        return
                    time.sleep(self.poll_s)
        idle_since = time.monotonic()
        while True:
            got = False
            for off, payload in reader.read_available():
                got = True
                idle_since = time.monotonic()
                yield off, pickle.loads(payload)
                if end_offset is not None and off + 1 >= end_offset:
                    return
            if not got:
                if (idle_timeout_s is not None
                        and time.monotonic() - idle_since
                        > idle_timeout_s):
                    return
                time.sleep(self.poll_s)

    def __iter__(self):
        return self.events()


# ---------------------------------------------------------------------------
# Seeded synthetic recommendation events (the millions-of-users shape:
# Zipf-distributed user/item ids over a universe far larger than any
# embedding table, so admission/eviction actually have work to do).
# ---------------------------------------------------------------------------

def seeded_events(seed: int, start: int, n: int, *,
                  n_users: int = 50_000, n_items: int = 10_000,
                  n_dense: int = 4, zipf_a: float = 1.2) -> dict:
    """One deterministic chunk of ``n`` events for offsets
    ``start..start+n-1``: a dict of arrays (``user``, ``item``,
    ``dense``, ``label``). Determinism is per (seed, start): the chunk
    is a pure function of its boundaries, and the LOG is the source of
    truth once written (a restarted producer resumes at the log's end,
    so already-written records are never regenerated)."""
    rng = np.random.default_rng([seed, start])
    user = (rng.zipf(zipf_a, size=n) - 1) % n_users
    item = (rng.zipf(zipf_a, size=n) - 1) % n_items
    dense = rng.normal(size=(n, n_dense)).astype(np.float32)
    score = dense.mean(1) + 0.3 * np.cos((user + item).astype(np.float64))
    label = (score > 0).astype(np.int32)
    return {"user": user.astype(np.int64), "item": item.astype(np.int64),
            "dense": dense, "label": label}


def append_chunk(writer: StreamWriter, chunk: dict) -> int:
    """Append one :func:`seeded_events` chunk as individual records;
    returns the next offset after the chunk. Flushes once at the end so
    consumers observe whole chunks."""
    n = len(chunk["label"])
    for i in range(n):
        writer.append_event({
            "user": int(chunk["user"][i]),
            "item": int(chunk["item"][i]),
            "dense": chunk["dense"][i],
            "label": int(chunk["label"][i]),
        })
    writer.flush()
    return writer.next_offset

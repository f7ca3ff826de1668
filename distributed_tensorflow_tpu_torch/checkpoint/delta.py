"""Delta snapshots: row-sparse publish chain for dynamic tables — port of
``distributed_tensorflow_tpu/checkpoint/delta.py``. The record files are
JAX's (header line, pickled payload of numpy arrays and Python
values), so a chain written by either package reconstructs in the
other.

An online recommender's :class:`~distributed_tensorflow_tpu_torch.embedding.
dynamic.DynamicTable` at 10⁶ rows moves well under 1% of them per
snapshot interval (Zipf traffic: the hot head trains constantly, the
tail sleeps) — yet a full snapshot re-serializes every row every time.
This module publishes the table as a **chain**:

- a **full** record — the complete ``state_dict`` (base), then
- **delta** records — only the rows/sketch-cells touched since the
  previous publish (``DynamicTable.state_delta``), each carrying its
  parent's ``(seq, crc)`` so the chain is verifiable link by link,

with a fresh full every ``full_every`` publishes (bounds reconstruct
cost) and FORCED on table growth (capacity changed ⇒ every row moved ⇒
only a full is honest; ``state_delta`` returns None and the publisher
falls back).

Every record is one file, committed write-once: header JSON line
(kind, seq, step, parent link, payload size, payload crc32) + pickled
payload, fsynced then ``os.replace``d into place — a torn write is
never visible under the final name, and a post-rename tear (the
``delta.publish`` chaos site's ``corrupt`` action, mirroring
``checkpoint.commit``) is caught by the crc at read time.

:meth:`DeltaSnapshotStore.reconstruct` walks the newest intact full
forward through its crc-linked deltas and returns a table
**bit-identical** to one restored from a full snapshot taken at the
same instant (the JAX package's tests/test_rollout.py proves it). A
broken link — missing seq, crc mismatch, parent mismatch — stops the
walk: the longest intact prefix serves, honestly stale rather than
silently wrong; a corrupt newest full falls back to the prior full.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import zlib

import numpy as np

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.resilience import faults

_HEADER_MAX = 4096


class DeltaChainError(RuntimeError):
    """No intact full record exists — nothing is reconstructable."""


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _aux_equal(a, b) -> bool:
    """Deep equality over the pickled aux structure: arrays compare by
    dtype+contents, dicts by key set, scalars by ==. (The pickle BYTES
    are not comparable — dict insertion order differs between a stepped
    table and a reconstructed one.)"""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(np.array_equal(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return (set(a) == set(b)
                and all(_aux_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (len(a) == len(b)
                and all(_aux_equal(x, y) for x, y in zip(a, b)))
    return a == b


def states_equal(sd_a: dict, sd_b: dict) -> bool:
    """Bit-identity between two ``DynamicTable.state_dict`` results:
    rows byte-equal AND every aux leaf (slots, membership, sketch,
    free list, counters) exactly equal."""
    ra, rb = np.asarray(sd_a["rows"]), np.asarray(sd_b["rows"])
    if ra.dtype != rb.dtype or ra.shape != rb.shape \
            or not np.array_equal(ra, rb):
        return False
    aux_a = pickle.loads(np.asarray(sd_a["aux"],
                                    dtype=np.uint8).tobytes())
    aux_b = pickle.loads(np.asarray(sd_b["aux"],
                                    dtype=np.uint8).tobytes())
    return _aux_equal(aux_a, aux_b)


class DeltaSnapshotStore:
    """Publish/reconstruct a :class:`DynamicTable` as a full+delta
    record chain under one directory (see module docstring)."""

    def __init__(self, directory: str, name: str = "table",
                 full_every: int = 8):
        if full_every < 1:
            raise ValueError(f"full_every must be >= 1, got "
                             f"{full_every}")
        self.directory = directory
        self.name = name
        self.full_every = int(full_every)
        os.makedirs(directory, exist_ok=True)
        self.published_full = 0
        self.published_delta = 0
        # resume the chain a prior incarnation left behind: parent
        # linkage + full cadence come from the newest intact record
        self._last: "tuple[int, int] | None" = None   # (seq, crc)
        self._since_full = 0
        for seq, kind, path in self._scan():
            hdr, payload = self._read_record(path)
            if hdr is None:
                continue
            self._last = (seq, int(hdr["crc"]))
            self._since_full = (0 if kind == "full"
                                else self._since_full + 1)

    # -- record files ------------------------------------------------------
    def _path(self, kind: str, seq: int) -> str:
        return os.path.join(self.directory,
                            f"{self.name}-{kind}-{seq:06d}.rec")

    def _scan(self) -> "list[tuple[int, str, str]]":
        """[(seq, kind, path)] sorted by seq, committed records only."""
        pat = re.compile(re.escape(self.name)
                         + r"-(full|delta)-(\d+)\.rec$")
        out = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        for f in entries:
            m = pat.match(f)
            if m:
                out.append((int(m.group(2)), m.group(1),
                            os.path.join(self.directory, f)))
        return sorted(out)

    @staticmethod
    def _read_record(path: str):
        """(header, payload) with the crc verified, or (None, None)
        for any torn/corrupt/unreadable record."""
        try:
            with open(path, "rb") as f:
                line = f.readline(_HEADER_MAX)
                hdr = json.loads(line.decode())
                payload = f.read(int(hdr["payload_bytes"]) + 1)
        except (OSError, ValueError, KeyError):
            return None, None
        if len(payload) != int(hdr["payload_bytes"]):
            return None, None               # truncated or trailing junk
        if (zlib.crc32(payload) & 0xFFFFFFFF) != int(hdr["crc"]):
            return None, None
        return hdr, payload

    def _write_record(self, kind: str, seq: int, obj, *,
                      step: int, parent: "tuple[int, int] | None"):
        payload = pickle.dumps(obj, protocol=4)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        hdr = {"kind": kind, "seq": seq, "step": int(step),
               "payload_bytes": len(payload), "crc": crc}
        if parent is not None:
            hdr["parent_seq"], hdr["parent_crc"] = parent
        path = self._path(kind, seq)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write((json.dumps(hdr) + "\n").encode())
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        # chaos BEFORE the rename: ``raise`` fails the publish with no
        # committed record (retry-safe — the tmp is orphaned, never
        # visible); ``corrupt`` tears the record AFTER commit, the
        # exact failure the crc chain exists to catch
        decision = faults.fire(
            "delta.publish", tag=seq, exc=OSError,
            msg=f"injected delta-publish failure for {path}")
        os.replace(tmp, path)
        _fsync_dir(self.directory)
        if decision is not None and decision.action == "corrupt":
            size = os.path.getsize(path)
            with open(path, "rb+") as f:
                f.truncate(max(size - max(size // 4, 1), 0))
        return path, crc, len(payload)

    # -- publish -----------------------------------------------------------
    def publish(self, table, *, force_full: bool = False) -> dict:
        """Publish the table's current state as the chain's next
        record. Delta when possible (a clean parent exists, capacity
        unchanged, cadence not due), full otherwise. On success the
        table is marked clean — its next ``state_delta`` is relative
        to THIS record."""
        seq = (self._last[0] + 1) if self._last else 1
        delta = None if force_full else table.state_delta()
        full = (force_full or delta is None or self._last is None
                or self._since_full + 1 >= self.full_every)
        if full:
            kind, obj, parent = "full", table.state_dict(), None
        else:
            kind, obj, parent = "delta", delta, self._last
        dirty = getattr(table, "dirty_rows", None)
        path, crc, nbytes = self._write_record(
            kind, seq, obj, step=getattr(table, "step", 0),
            parent=parent)
        table.mark_clean()
        self._last = (seq, crc)
        self._since_full = 0 if kind == "full" else self._since_full + 1
        if kind == "full":
            self.published_full += 1
        else:
            self.published_delta += 1
        telemetry.event("delta.publish", kind=kind, seq=seq,
                        bytes=nbytes, step=getattr(table, "step", 0),
                        dirty_rows=dirty)
        return {"kind": kind, "seq": seq, "path": path,
                "bytes": nbytes, "crc": crc}

    # -- reconstruct -------------------------------------------------------
    def reconstruct(self, cfg, device="cuda") -> "tuple[object, dict]":
        """Rebuild a table from the chain: newest intact full, then
        every crc+parent-linked delta after it, in seq order. Returns
        ``(table, info)``; ``info['chain_broken']`` is True when a
        broken link truncated the walk (the longest intact prefix
        serves). Raises :class:`DeltaChainError` when no intact full
        exists anywhere."""
        from distributed_tensorflow_tpu_torch.embedding.dynamic import (
            DynamicTable)
        recs = self._scan()
        by_seq = {seq: (kind, path) for seq, kind, path in recs}
        max_seq = recs[-1][0] if recs else 0
        fulls = [seq for seq, kind, _ in recs if kind == "full"]
        for base_seq in reversed(fulls):
            hdr, payload = self._read_record(by_seq[base_seq][1])
            if hdr is None:
                continue                    # corrupt full: try older
            table = DynamicTable(cfg, device=device)
            table.load_state_dict(pickle.loads(payload))
            prev = (base_seq, int(hdr["crc"]))
            applied = 0
            for seq in range(base_seq + 1, max_seq + 1):
                nxt = by_seq.get(seq)
                if nxt is None or nxt[0] != "delta":
                    break           # gap, or a (corrupt) newer full
                dh, dp = self._read_record(nxt[1])
                if dh is None or (dh.get("parent_seq"),
                                  dh.get("parent_crc")) != prev:
                    break           # torn record / link mismatch
                table.apply_state_delta(pickle.loads(dp))
                prev = (seq, int(dh["crc"]))
                applied += 1
            return table, {"base_seq": base_seq,
                           "served_seq": prev[0],
                           "applied_deltas": applied,
                           # anything newer than what we served means a
                           # link somewhere refused to verify
                           "chain_broken": prev[0] < max_seq,
                           "records": len(recs)}
        raise DeltaChainError(
            f"{self.name}: no intact full record under "
            f"{self.directory} ({len(recs)} records on disk)")

    def record_sizes(self) -> "list[dict]":
        """[{seq, kind, bytes}] for every committed record — the bench
        reads delta-vs-full bytes off this."""
        out = []
        for seq, kind, path in self._scan():
            try:
                out.append({"seq": seq, "kind": kind,
                            "bytes": os.path.getsize(path)})
            except OSError:
                pass
        return out

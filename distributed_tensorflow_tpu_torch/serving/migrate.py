"""KV-block migration and disaggregated serving — port of
``distributed_tensorflow_tpu/serving/migrate.py``.

Disaggregated serving (DistServe, Zhong et al. OSDI'24; Splitwise,
Patel et al. ISCA'24): **prefill replicas** run admission and prompt
prefill only, **decode replicas** run the token loop, and a prompt's
computed KV blocks move between them as a :class:`MigrationPayload` —
raw pool block rows (int8 scales included), the request, and every
token generated so far, carried as live state so the adopter replays
nothing. The same primitive **rescues** a decode replica whose pool is
exhausted: the scheduler's preemption hook first migrates the victim to
a sibling with room, and only when none has room does the replay
requeue run.

**Wire format** (the JAX package's, byte for byte): :func:`pack_payload`
writes an 8-byte big-endian header length, a JSON header (the request
fields and each array's ``name``, ``shape`` and ``dtype``, in sorted
name order), then each array's raw bytes in that order. Dtypes carry
numpy's names (``"float32"``, ``"bfloat16"``, ``"int8"``); the port
holds arrays as host ``torch`` tensors, which have a bfloat16, so a
bf16 blob is the one the JAX package writes and each package unpacks
the other's. Blobs travel over the chunked write-once transport of
``checkpoint/peer_snapshot.py`` (chunks first, the count last: a torn
publish is never adoptable); :class:`FileKV` carries it through a shared
directory with the JAX package's key-to-file mapping.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time

import torch

from distributed_tensorflow_tpu_torch.checkpoint.peer_snapshot import (
    kv_blob_committed, kv_get_blob, kv_put_blob)
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.serving.kv_cache import dtype_name


class FileKV:
    """Filesystem key-value agent for the chunked blob transport
    (``key_value_set`` / ``key_value_get`` / ``key_value_try_get``):
    every key is one file, committed atomically by ``os.replace``, so a
    reader never sees a torn value. ``/`` in a key becomes ``__`` on
    disk, as in the JAX package, so each package reads the other's
    directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def key_value_set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode("utf-8")
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def key_value_try_get(self, key: str) -> "bytes | None":
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def key_value_get(self, key: str, timeout_s: float = 10.0) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            val = self.key_value_try_get(key)
            if val is not None:
                return val
            if time.monotonic() >= deadline:
                raise TimeoutError(f"FileKV: key {key!r} not published "
                                   f"within {timeout_s}s")
            time.sleep(0.005)

    def list(self, prefix: str = "") -> list[str]:
        """Committed keys under ``prefix`` (tmp files excluded)."""
        flat = prefix.replace("/", "__")
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(name.replace("__", "/") for name in names
                      if ".tmp." not in name and name.startswith(flat))


@dataclasses.dataclass
class MigrationPayload:
    """Everything a replica needs to continue another's sequence.

    ``arrays`` are the sequence's pool block rows as host tensors:
    ``k``/``v`` shaped ``(n_layers, n_blocks * block_size, n_heads,
    head_dim)`` in the pool's storage dtype, plus ``k_scale`` /
    ``v_scale`` ``(n_layers, rows, n_heads)`` f32 when quantized.
    ``generated`` is live state (the adopter appends to it);
    ``generated_prefix`` keeps the replay provenance of preemptions
    before the migration. ``fingerprint`` must equal the adopter's
    ``pool_fingerprint()``; ``pool_epoch`` names the source
    incarnation."""

    request_id: str
    tokens: tuple
    max_new_tokens: int
    eos_id: "int | None"
    generated_prefix: tuple
    generated: tuple
    length: int
    fingerprint: dict
    pool_epoch: str
    arrival_wall: "float | None"
    ttft_s: "float | None"
    preemptions: int
    arrays: dict

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in self.arrays.values())

    @property
    def n_blocks(self) -> int:
        return self.arrays["k"].shape[1] // self.fingerprint["block_size"]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"migration blob: unknown dtype {name!r}")
    return dt


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def pack_payload(payload: MigrationPayload) -> bytes:
    """One self-describing blob: ``[8B header length][JSON header]
    [array bytes...]`` — bit-exact for every ``kv_dtype``."""
    names = sorted(payload.arrays)
    header = {
        "request_id": payload.request_id,
        "tokens": list(payload.tokens),
        "max_new_tokens": payload.max_new_tokens,
        "eos_id": payload.eos_id,
        "generated_prefix": list(payload.generated_prefix),
        "generated": list(payload.generated),
        "length": payload.length,
        "fingerprint": payload.fingerprint,
        "pool_epoch": payload.pool_epoch,
        "arrival_wall": payload.arrival_wall,
        "ttft_s": payload.ttft_s,
        "preemptions": payload.preemptions,
        "arrays": [{"name": n,
                    "shape": list(payload.arrays[n].shape),
                    "dtype": dtype_name(payload.arrays[n].dtype)}
                   for n in names],
    }
    head = json.dumps(header).encode("utf-8")
    parts = [struct.pack(">Q", len(head)), head]
    parts.extend(_raw_bytes(payload.arrays[n]) for n in names)
    return b"".join(parts)


def unpack_payload(blob: bytes) -> MigrationPayload:
    """Inverse of :func:`pack_payload` (either package's blob); raises
    ``ValueError`` on trailing bytes."""
    (head_len,) = struct.unpack(">Q", blob[:8])
    header = json.loads(blob[8:8 + head_len].decode("utf-8"))
    buf = bytearray(blob)              # torch.frombuffer wants writable
    arrays = {}
    off = 8 + head_len
    for spec in header["arrays"]:
        dt = _torch_dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        count = 1
        for d in shape:
            count *= d
        n = count * dt.itemsize
        if off + n > len(buf):
            raise ValueError("migration blob: truncated array bytes")
        arrays[spec["name"]] = (torch.frombuffer(buf, dtype=dt, count=count,
                                                 offset=off).reshape(shape)
                                if count else torch.empty(shape, dtype=dt))
        off += n
    if off != len(buf):
        raise ValueError(f"migration blob: {len(buf) - off} trailing "
                         f"bytes (corrupt or mismatched header)")
    return MigrationPayload(
        request_id=header["request_id"],
        tokens=tuple(header["tokens"]),
        max_new_tokens=header["max_new_tokens"],
        eos_id=header["eos_id"],
        generated_prefix=tuple(header["generated_prefix"]),
        generated=tuple(header["generated"]),
        length=header["length"],
        fingerprint=header["fingerprint"],
        pool_epoch=header["pool_epoch"],
        arrival_wall=header["arrival_wall"],
        ttft_s=header["ttft_s"],
        preemptions=header["preemptions"],
        arrays=arrays)


def publish_payload(agent, prefix: str, payload: MigrationPayload):
    """Ship a payload over the write-once chunked transport (the count
    commits last: :func:`payload_committed` sees nothing or all)."""
    kv_put_blob(agent, prefix, pack_payload(payload))


def fetch_payload(agent, prefix: str,
                  timeout_s: float = 10.0) -> MigrationPayload:
    return unpack_payload(kv_get_blob(agent, prefix, timeout_s=timeout_s))


def payload_committed(agent, prefix: str) -> bool:
    return kv_blob_committed(agent, prefix)


class DisaggregatedEngine:
    """Prefill/decode disaggregation over in-process engine replicas on
    one device.

    One ``role="prefill"`` :class:`~distributed_tensorflow_tpu_torch.
    serving.engine.InferenceEngine` owns admission, the prefix cache and
    prompt prefill; ``num_decode`` full engines own the token loop. Each
    :meth:`step`:

    1. steps the prefill engine (admit + prefill; scoring and 1-token
       requests complete there);
    2. exports every prefilled, unfinished sequence to the first decode
       replica with room, round-robin (placement never changes greedy
       outputs); ``wire=True`` packs and unpacks every payload through
       the wire format;
    3. steps every decode engine.

    A decode replica that must preempt first offers the victim to its
    siblings through the scheduler's ``preempt_hook`` (**rescue**, no
    replay); only when every sibling is full does the replay requeue
    run on the victim's own replica.

    ``submit`` / ``step`` / ``run_until_idle`` / ``generate`` /
    ``stats`` / ``idle`` / ``block_accounting`` mirror the monolithic
    engine. ``engine_kwargs`` go to every replica (``device``, ``mesh``,
    ``kv_dtype``, pool sizes, ...); on a ``mesh`` every replica is
    placed on it, and each payload carries every head."""

    def __init__(self, cfg, params, *, num_decode: int = 1,
                 wire: bool = False, rescue: bool = True,
                 **engine_kwargs):
        from distributed_tensorflow_tpu_torch.serving.engine import (
            InferenceEngine)
        if num_decode < 1:
            raise ValueError("num_decode must be >= 1")
        pf_kwargs = dict(engine_kwargs)
        # the prefill replica never decodes: no draft model; the spill
        # tier follows the prefix cache, which lives with admission
        for k in ("speculative_k", "draft_params", "draft_cfg"):
            pf_kwargs.pop(k, None)
        self.prefill = InferenceEngine(cfg, params, role="prefill",
                                       **pf_kwargs)
        dec_kwargs = dict(engine_kwargs)
        dec_kwargs.pop("spill_tier", None)
        # adopted blocks arrive private: a cache on a decode replica
        # would only duplicate the prefill replica's
        dec_kwargs["prefix_caching"] = False
        self.decoders = [InferenceEngine(cfg, params, **dec_kwargs)
                         for _ in range(num_decode)]
        self.wire = bool(wire)
        self.rescue = bool(rescue)
        self._rr = 0                      # round-robin placement cursor
        self.migrations: list[dict] = []
        if rescue and num_decode > 1:
            for i, eng in enumerate(self.decoders):
                eng.scheduler.preempt_hook = (
                    lambda victim, _i=i: self._rescue(_i, victim))

    # -- placement ---------------------------------------------------------
    def _decoder_for(self, n_blocks: int,
                     exclude: "int | None" = None) -> "int | None":
        """First decode replica (round-robin from the cursor) with a
        free slot and ``n_blocks`` free blocks; None when all are
        full."""
        n = len(self.decoders)
        for k in range(n):
            i = (self._rr + k) % n
            if i == exclude:
                continue
            eng = self.decoders[i]
            if (eng.scheduler._free_slots
                    and eng.scheduler.allocator.num_free >= n_blocks):
                self._rr = (i + 1) % n
                return i
        return None

    def _ship(self, src_engine, seq, dst: int, *, kind: str,
              src: str) -> None:
        t0 = time.monotonic()
        payload = src_engine.export_sequence(seq, reason=kind)
        if self.wire:
            payload = unpack_payload(pack_payload(payload))
        self.decoders[dst].adopt_sequence(payload)
        self.migrations.append({
            "id": payload.request_id, "kind": kind, "src": src,
            "dst": f"decode{dst}", "blocks": payload.n_blocks,
            "bytes": payload.nbytes,
            "ms": (time.monotonic() - t0) * 1e3})

    def _rescue(self, src: int, victim) -> bool:
        """Preemption hook on decode replica ``src``: migrate the victim
        to a sibling instead of replaying it. True = taken."""
        dst = self._decoder_for(len(victim.table.blocks), exclude=src)
        if dst is None:
            return False
        self._ship(self.decoders[src], victim, dst, kind="rescue",
                   src=f"decode{src}")
        return True

    # -- engine surface ----------------------------------------------------
    def submit(self, request, *, arrival_wall: "float | None" = None):
        return self.prefill.submit(request, arrival_wall=arrival_wall)

    def step(self) -> list[dict]:
        """One disaggregated iteration; completion records of every
        replica (the prefill replica's first, then the decode replicas
        in index order)."""
        finished = list(self.prefill.step())
        sched = self.prefill.scheduler
        ready = sorted((s for s in sched.running.values()
                        if s.prefilled and not s.done),
                       key=lambda s: s.slot)
        for seq in ready:
            dst = self._decoder_for(len(seq.table.blocks))
            if dst is None:
                break       # every decoder full: park in the prefill slot
            self._ship(self.prefill, seq, dst, kind="prefill",
                       src="prefill")
        for eng in self.decoders:
            finished.extend(eng.step())
        return finished

    @property
    def idle(self) -> bool:
        return (self.prefill.scheduler.idle
                and all(e.scheduler.idle for e in self.decoders))

    def run_until_idle(self, *, max_steps: int = 100000,
                       retry_faults: bool = False) -> dict:
        """Drive :meth:`step` until every replica drains;
        ``retry_faults=True`` re-runs a step whose ``serve.step`` site
        raised (every site fires before its engine changes state, so
        re-running the composite step is safe)."""
        out: dict[str, dict] = {}
        for _ in range(max_steps):
            if self.idle:
                break
            try:
                for rec in self.step():
                    out[rec["id"]] = rec
            except faults.FaultInjected:
                if not retry_faults:
                    raise
        return out

    def generate(self, prompts, *, max_new_tokens: int = 16,
                 eos_id: int | None = None) -> list[list[int]]:
        from distributed_tensorflow_tpu_torch.serving.scheduler import (
            Request)
        for i, p in enumerate(prompts):
            self.submit(Request(id=f"g{i}", tokens=tuple(p),
                                max_new_tokens=max_new_tokens,
                                eos_id=eos_id))
        done = self.run_until_idle()
        return [done[f"g{i}"]["tokens"] for i in range(len(prompts))]

    def block_accounting(self) -> dict:
        """Each replica's conservation audit plus fleet totals."""
        per = {"prefill": self.prefill.block_accounting()}
        for i, eng in enumerate(self.decoders):
            per[f"decode{i}"] = eng.block_accounting()
        per["leaked_refs"] = sum(v["leaked_refs"] for v in per.values())
        per["conserved"] = all(v["conserved"] for v in per.values()
                               if isinstance(v, dict))
        return per

    def stats(self) -> dict:
        lat = sorted(m["ms"] for m in self.migrations)

        def pct(p):
            return (lat[min(len(lat) - 1,
                            int(round(p / 100 * (len(lat) - 1))))]
                    if lat else 0.0)

        return {
            "prefill": self.prefill.stats(),
            "decode": [e.stats() for e in self.decoders],
            "migrations": len(self.migrations),
            "migrations_rescue": sum(1 for m in self.migrations
                                     if m["kind"] == "rescue"),
            "migrated_bytes": sum(m["bytes"] for m in self.migrations),
            "migrate_p50_ms": pct(50),
            "migrate_p99_ms": pct(99),
        }

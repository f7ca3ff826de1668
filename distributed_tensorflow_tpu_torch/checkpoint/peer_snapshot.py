"""In-memory host snapshots + peer replicas (the warm checkpoint tiers) —
port of ``distributed_tensorflow_tpu/checkpoint/peer_snapshot.py``, with
JAX's wire format: :func:`pack` makes the same npz bytes (a bf16 leaf
as ``|V2``, ``checkpoint.to_numpy``) and JSON meta record, and the KV
keys are the same, so either package reads the other's snapshots.

The fast half of the recovery ladder (``host`` and ``peer`` in
host > peer > local-disk > durable-disk): every worker keeps the last K
device->host snapshots of the shards *it* owns, plus a replica of one
ring-assigned peer's shards, so a reformed cluster can usually restore
from a surviving worker's memory in seconds instead of re-reading disk
(≙ the reference's preemption-aware ``failure_handling`` saving stack
taken one tier hotter; same idea as Gemini/CheckFreq-style in-memory
checkpointing).

Pieces:

- :class:`HostSnapshot` — one worker's host copy of its shard arrays at
  a step, plus the checkpoint index needed to reassemble them.
- :class:`SnapshotStore` — bounded per-owner retention (own snapshots
  AND peer replicas), mirrored write-through to a *memdir*: a directory
  standing in for node RAM/ramdisk that survives a **process** restart
  but not a **machine** loss (the recovery supervisor wipes a dead
  worker's memdir; a straggler restarted on the same machine keeps
  its). ``load_surviving()`` re-reads the memdir after a restart.
- :func:`exchange` — the ring replication step, run at each snapshot
  boundary over the coordination KV (generation-namespaced): worker *i*
  publishes its packed snapshot and stores a replica of worker
  ``(i+1) % N``'s. One replica per worker means any *single* worker
  death leaves every shard recoverable from memory; adjacent double
  deaths fall through to the disk tiers.
- :func:`negotiate` — the cluster-consistent restore decision for a
  reformed generation: every worker publishes its surviving inventory,
  the chief picks the freshest *complete* memory step (every owner of
  that capture must be held by someone) or the freshest intact disk
  checkpoint, and publishes the decision; holders then publish the
  needed parts and everyone reassembles. All KV reads are of
  peer-written keys (a worker never re-reads what it wrote — the safe
  direction on legacy TSL clients; see cluster/coordination.py).

The KV transfer path is sized for coordination-plane state (model +
optimizer shards of test-scale jobs, tens of MB); a production
deployment would swap the transfer for a bulk channel (gloo/NCCL
broadcast) behind the same negotiation.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
from typing import Mapping

import numpy as np

from distributed_tensorflow_tpu_torch.resilience import faults

#: Reserved npz key carrying the JSON metadata record.
_META_KEY = "__dtx_snapshot_meta__"


@dataclasses.dataclass
class HostSnapshot:
    """One worker's host-RAM copy of its checkpoint shards at a step."""

    owner: int                    # process id that captured it
    step: int
    world: int                    # num_processes at capture time
    index: dict                   # checkpoint index (leaves meta)
    arrays: dict[str, np.ndarray]  # shard arrays incl. "::off" offsets

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


def pack(snap: HostSnapshot) -> bytes:
    """Serialize to self-describing npz bytes (the on-disk shard format
    plus a metadata record) — safe to ship over the coordination KV."""
    meta = json.dumps({"owner": snap.owner, "step": snap.step,
                       "world": snap.world, "index": snap.index})
    buf = io.BytesIO()
    np.savez(buf, **snap.arrays,
             **{_META_KEY: np.frombuffer(meta.encode(), dtype=np.uint8)})
    return buf.getvalue()


def unpack(data: bytes) -> HostSnapshot:
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return HostSnapshot(owner=int(meta["owner"]), step=int(meta["step"]),
                        world=int(meta["world"]), index=meta["index"],
                        arrays=arrays)


#: KV blob chunk size — comfortably under the coordination service's
#: 4 MiB grpc message cap.
CHUNK = 2 << 20


def kv_put_blob(agent, prefix: str, data: bytes):
    """Publish ``data`` under ``prefix`` as write-once chunk keys with a
    committed-last count key (readers can never observe a partial
    blob). Chunks stay under the grpc message cap.

    The transport is agent-agnostic: anything exposing
    ``key_value_set``/``key_value_get`` works — the coordination
    service's KV for ring replication here, and serving's file-backed
    :class:`~distributed_tensorflow_tpu_torch.serving.migrate.FileKV` for
    KV-block migration (serving/migrate.py reuses this exact
    chunked write-once protocol, so a writer SIGKILLed mid-publish
    never leaves an adoptable half-blob)."""
    n = max(1, (len(data) + CHUNK - 1) // CHUNK)
    for i in range(n):
        agent.key_value_set(f"{prefix}/c{i}",
                            data[i * CHUNK:(i + 1) * CHUNK])
    agent.key_value_set(f"{prefix}/n", str(n))


def kv_get_blob(agent, prefix: str, timeout_s: float) -> bytes:
    """Fetch a blob :func:`kv_put_blob` published (blocks until the
    committed-last count key lands, so a torn publish is never read)."""
    n = int(agent.key_value_get(f"{prefix}/n", timeout_s=timeout_s))
    return b"".join(
        agent.key_value_get(f"{prefix}/c{i}", timeout_s=timeout_s)
        for i in range(n))


def kv_blob_committed(agent, prefix: str) -> bool:
    """Non-blocking: has a blob under ``prefix`` fully committed? Needs
    an agent with ``key_value_try_get`` (FileKV has one)."""
    return agent.key_value_try_get(f"{prefix}/n") is not None


# backwards-compatible private spellings (pre-factoring callers)
_CHUNK = CHUNK
_kv_put_blob = kv_put_blob
_kv_get_blob = kv_get_blob


def ring_source(pid: int, world: int) -> int:
    """The peer whose snapshots ``pid`` replicates (its ring successor)."""
    return (pid + 1) % world


def ring_replicator(pid: int, world: int) -> int:
    """The peer that replicates ``pid``'s snapshots."""
    return (pid - 1) % world


def assign_replicators(world: int,
                       domains: "Mapping[int, object] | None" = None
                       ) -> "dict[int, int]":
    """{owner: replicator} — the placement policy of the replica ring.

    Without ``domains`` this is the historical blind ring
    (``replicator = (owner - 1) % world``) byte for byte. With a
    ``{pid: failure_domain}`` map, every owner's replicator is placed
    OUTSIDE the owner's failure domain whenever any other domain has a
    member — so a whole-domain loss (rack power, ToR switch) can never
    take a snapshot and its only replica together, which is exactly
    what the blind ring lets happen when adjacent pids share a rack.
    Replicas are spread by load (fewest replicas held, lowest pid to
    break ties), so one replicator may hold several owners' replicas
    when domains are unequal — deterministic for a given (world,
    domains), and every participant computes the identical assignment
    with no extra coordination.
    """
    if world < 2:
        return {}
    if not domains:
        return {o: (o - 1) % world for o in range(world)}
    dom = {p: str(domains[p]) if p in domains else f"__solo{p}"
           for p in range(world)}
    load = {p: 0 for p in range(world)}
    out: "dict[int, int]" = {}
    for owner in range(world):
        cands = [p for p in range(world)
                 if p != owner and dom[p] != dom[owner]]
        if not cands:                     # single-domain fleet: any
            cands = [p for p in range(world) if p != owner]  # peer
        pick = min(cands, key=lambda p: (load[p], p))
        out[owner] = pick
        load[pick] += 1
    return out


def replica_sources(pid: int, world: int,
                    domains: "Mapping[int, object] | None" = None
                    ) -> "tuple[int, ...]":
    """The owners whose snapshots ``pid`` must replicate under
    :func:`assign_replicators` (the inverse map; possibly several, or
    none, when domains are unequal)."""
    return tuple(sorted(o for o, r in
                        assign_replicators(world, domains).items()
                        if r == pid))


class SnapshotStore:
    """Bounded retention of host snapshots (own + peer replicas).

    ``memdir`` mirrors every snapshot to node-local storage standing in
    for host RAM: it survives a process restart (straggler respawned on
    the same machine) but is wiped by the supervisor when the machine
    is considered dead. ``None`` keeps snapshots purely in-process.
    """

    def __init__(self, memdir: str | None = None, *, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.memdir = memdir
        self.keep = keep
        # owner -> {step -> HostSnapshot}, each owner pruned to ``keep``
        self._snaps: dict[int, dict[int, HostSnapshot]] = {}
        if memdir:
            os.makedirs(memdir, exist_ok=True)

    # -- write ------------------------------------------------------------
    def put(self, snap: HostSnapshot):
        """Retain ``snap`` (own capture or a peer replica), pruning the
        owner's oldest beyond ``keep``; mirrored to the memdir."""
        per_owner = self._snaps.setdefault(snap.owner, {})
        per_owner[snap.step] = snap
        evicted = sorted(per_owner)[:-self.keep]
        for step in evicted:
            del per_owner[step]
        if self.memdir:
            self._mirror(snap)
            for step in evicted:
                shutil.rmtree(self._snap_dir(snap.owner, step),
                              ignore_errors=True)

    def _snap_dir(self, owner: int, step: int) -> str:
        return os.path.join(self.memdir, f"o{owner}", f"s{step}")

    def _mirror(self, snap: HostSnapshot):
        """Write-through with a commit marker: part first, ``meta.json``
        last — a loader only trusts directories whose meta landed."""
        d = self._snap_dir(snap.owner, snap.step)
        os.makedirs(d, exist_ok=True)
        part = os.path.join(d, "part.npz")
        with open(part + ".tmp", "wb") as f:
            np.savez(f, **snap.arrays)
        os.replace(part + ".tmp", part)
        meta = os.path.join(d, "meta.json")
        with open(meta + ".tmp", "w") as f:
            json.dump({"owner": snap.owner, "step": snap.step,
                       "world": snap.world, "index": snap.index}, f)
        os.replace(meta + ".tmp", meta)

    # -- read -------------------------------------------------------------
    def get(self, owner: int, step: int) -> HostSnapshot | None:
        return self._snaps.get(owner, {}).get(step)

    def inventory(self) -> dict[int, dict[int, int]]:
        """{owner: {step: world-at-capture}} of everything held."""
        return {o: {s: snap.world for s, snap in per.items()}
                for o, per in self._snaps.items()}

    def load_surviving(self) -> int:
        """Re-populate from the memdir after a process restart; returns
        the number of snapshots recovered. Torn mirrors (no meta.json)
        and unreadable parts are skipped."""
        if not self.memdir or not os.path.isdir(self.memdir):
            return 0
        loaded = 0
        for od in sorted(os.listdir(self.memdir)):
            if not od.startswith("o"):
                continue
            for sd in sorted(os.listdir(os.path.join(self.memdir, od))):
                d = os.path.join(self.memdir, od, sd)
                try:
                    with open(os.path.join(d, "meta.json")) as f:
                        meta = json.load(f)
                    with np.load(os.path.join(d, "part.npz")) as z:
                        arrays = {k: z[k] for k in z.files}
                except (OSError, ValueError, KeyError):
                    continue
                self.put(HostSnapshot(
                    owner=int(meta["owner"]), step=int(meta["step"]),
                    world=int(meta["world"]), index=meta["index"],
                    arrays=arrays))
                loaded += 1
        return loaded


# ---------------------------------------------------------------------------
# Ring replication (at each snapshot boundary)
# ---------------------------------------------------------------------------

def exchange(store: SnapshotStore, snap: HostSnapshot, agent, *,
             timeout_s: float = 60.0,
             domains: "Mapping[int, object] | None" = None) -> bool:
    """Collective ring replication for one snapshot step: publish this
    worker's packed snapshot under a per-(step, worker) KV key and store
    a replica of every owner :func:`assign_replicators` assigned to this
    worker (exactly the ring source without ``domains``; with a domain
    map, replicas are placed across failure domains — possibly several
    owners, possibly none). Every worker snapshots the same steps (the
    save cadence is deterministic), so the blocking fetches are a
    near-lockstep rendezvous. A missing peer (died mid-run) degrades
    to no-replica-update — the supervisor will reform shortly anyway.
    Returns True when every assigned replica was stored.
    """
    if not getattr(agent, "is_distributed", False) or agent.num_processes < 2:
        return False
    pid, world = agent.process_id, agent.num_processes
    faults.fire("peer.exchange", tag=str(pid), exc=OSError,
                msg=f"injected peer-exchange failure (worker {pid})")
    _kv_put_blob(agent, f"peer_snap/s{snap.step}/w{pid}", pack(snap))
    ok = False
    for src in replica_sources(pid, world, domains):
        try:
            data = _kv_get_blob(agent, f"peer_snap/s{snap.step}/w{src}",
                                timeout_s=timeout_s)
        except Exception:
            return False          # peer dead/slow: replica skipped
        try:
            store.put(unpack(data))
        except (ValueError, KeyError):
            return False          # torn/alien payload: replica skipped
        ok = True
    return ok


# ---------------------------------------------------------------------------
# Reform-time restore negotiation
# ---------------------------------------------------------------------------

def _complete_memory_steps(all_inv: Mapping[int, Mapping]) -> dict[int, int]:
    """{step: world-at-capture} of steps where EVERY owner of that
    capture is held by someone — the only memory states that can be
    reassembled into the full checkpoint."""
    # step -> (world, set of owners held)
    by_step: dict[int, tuple[int, set[int]]] = {}
    for inv in all_inv.values():
        for owner, steps in inv.items():
            for step, world in steps.items():
                w, owners = by_step.setdefault(int(step),
                                               (int(world), set()))
                owners.add(int(owner))
    return {step: world for step, (world, owners) in by_step.items()
            if owners >= set(range(world))}


def _decide(all_inv: Mapping[int, Mapping],
            disk_best: "tuple[int, str, str] | None") -> dict:
    """The chief's restore decision: freshest complete memory step vs
    freshest intact disk checkpoint; memory wins ties (warmer tier).

    ``all_inv``: {pid: {owner: {step: world}}} — surviving inventories.
    ``disk_best``: (step, path, tier) of the best disk candidate.
    """
    complete = _complete_memory_steps(all_inv)
    mem_step = max(complete) if complete else None
    disk_step = disk_best[0] if disk_best else None
    if mem_step is not None and (disk_step is None or mem_step >= disk_step):
        world = complete[mem_step]
        holders: dict[str, int] = {}
        for owner in range(world):
            # prefer the owner itself (its own memory — no transfer),
            # else the lowest-pid holder (deterministic)
            cands = sorted(pid for pid, inv in all_inv.items()
                           if mem_step in inv.get(owner, {}))
            holders[str(owner)] = owner if owner in cands else cands[0]
        return {"source": "memory", "step": mem_step, "world": world,
                "holders": holders,
                "disk_step": disk_step}
    if disk_best is not None:
        return {"source": "disk", "step": disk_best[0],
                "path": disk_best[1], "tier": disk_best[2],
                "mem_step": mem_step}
    return {"source": "none"}


def negotiate(store: SnapshotStore, agent,
              disk_best: "tuple[int, str, str] | None", *,
              timeout_s: float = 60.0) -> dict:
    """Agree cluster-wide on the restore source for this generation.

    Collective: EVERY process of the (reformed) cluster must call this
    exactly once per generation. Keys ride the generation-namespaced KV,
    so a dead incarnation's negotiation can never bleed in. The chief
    decides (it alone sees every inventory) and publishes; everyone else
    blocks on the decision. Single-process/non-distributed: decided
    locally from this store alone.
    """
    inv = store.inventory()
    if not getattr(agent, "is_distributed", False) or agent.num_processes < 2:
        return _decide({0: inv}, disk_best)
    pid, world = agent.process_id, agent.num_processes
    # JSON keys must be strings; keep the wire format canonical
    wire = {str(o): {str(s): w for s, w in per.items()}
            for o, per in inv.items()}
    agent.key_value_set(f"elastic_restore/inv/p{pid}", json.dumps(wire))
    agent.barrier("elastic_restore/inv", timeout_s=timeout_s)
    if agent.is_chief:
        all_inv: dict[int, dict] = {pid: inv}
        for i in range(world):
            if i == pid:
                continue          # own inventory: local copy (never
            v = agent.key_value_try_get(  # self-read the KV — legacy
                f"elastic_restore/inv/p{i}")   # client hazard)
            if v is None:
                continue          # peer died between barrier and read
            try:
                peer = json.loads(v)
            except ValueError:
                continue
            all_inv[i] = {int(o): {int(s): int(w) for s, w in per.items()}
                          for o, per in peer.items()}
        decision = _decide(all_inv, disk_best)
        agent.key_value_set("elastic_restore/decision",
                            json.dumps(decision))
        return decision
    raw = agent.key_value_get("elastic_restore/decision",
                              timeout_s=timeout_s)
    return json.loads(raw)


def fetch_parts(store: SnapshotStore, agent, decision: Mapping, *,
                timeout_s: float = 60.0) -> list[HostSnapshot]:
    """Execute a ``memory`` decision: publish the parts this process was
    designated holder of, fetch the rest from their holders over the KV
    (never re-reading a self-written key), and return every owner's
    snapshot at the agreed step."""
    step = int(decision["step"])
    holders = {int(o): int(p) for o, p in decision["holders"].items()}
    pid = agent.process_id if getattr(agent, "is_distributed", False) else 0
    for owner, holder in sorted(holders.items()):
        if holder != pid:
            continue
        snap = store.get(owner, step)
        if snap is not None and getattr(agent, "is_distributed", False):
            _kv_put_blob(agent, f"elastic_restore/part/s{step}/o{owner}",
                         pack(snap))
    parts: list[HostSnapshot] = []
    for owner, holder in sorted(holders.items()):
        local = store.get(owner, step)
        if local is not None:
            parts.append(local)   # held here (own or replica): no fetch
            continue
        data = _kv_get_blob(
            agent, f"elastic_restore/part/s{step}/o{owner}",
            timeout_s=timeout_s)
        parts.append(unpack(data))
    return parts


def wipe_memdir(memdir: str):
    """Supervisor-side: the machine behind ``memdir`` is dead — its
    in-memory snapshots (own AND replicas it held) are gone."""
    shutil.rmtree(memdir, ignore_errors=True)


def any_fetched_remotely(store: SnapshotStore, decision: Mapping) -> bool:
    """True when executing ``decision`` required at least one remote
    fetch for this process (distinguishes the ``peer`` tier from pure
    ``host`` restores)."""
    step = int(decision["step"])
    return any(store.get(int(o), step) is None
               for o in decision["holders"])

"""Heartbeat transport for the recovery supervisor, pluggable + sharded.

The port's copy of ``distributed_tensorflow_tpu/resilience/heartbeats.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The supervisor's failure detector needs one thing per watch tick: the
freshest ``(observed_at, step, worker_wall)`` triple for every worker.
Historically that was hard-wired to per-task heartbeat FILES under the
supervisor scratch dir (cluster/elastic.heartbeat) — three separate
O(N) file scans per poll tick (stall check, chaos kills, clock-sync
telemetry). This module makes the transport a :class:`HeartbeatSource`
the supervisor reads ONCE per tick:

- :class:`FileHeartbeatSource` — the existing file protocol, unchanged
  on disk (workers keep writing ``heartbeat-<task>`` files); the
  supervisor just stops re-scanning it three times.
- :class:`ShardedKVHeartbeats` — the fleet-scale transport over the
  coordination KV (≙ the reference WorkerService's grpc heartbeat
  fan-in, SURVEY §L5c/d): workers write per-worker keys
  ``fleet/hb/<shard>/<pid>``, the lowest LIVE pid of each shard folds
  its shard's keys into one summary key ``fleet/hbsum/<shard>`` as part
  of its own step loop, and the supervisor polls only the N/S summary
  keys. Steady-state supervisor cost drops from O(N) reads per tick to
  O(N/S); detection latency for an individual death is unchanged (the
  summary carries every member's own wall clock). A dead REDUCER makes
  its whole shard's summary go stale — the reader then falls back to
  enumerated per-member reads *for that shard only* (O(S)), so reducer
  death degrades one shard's read cost, never detection correctness.

KV discipline (cluster/coordination.py): heartbeat values
are strings, point reads only (``try_get`` per key — never a directory
read), keys overwritten in place. Generation-namespacing comes free
from the agent: a dead generation's heartbeats are invisible to the
new one, and the lifecycle GC (cluster/kv_gc.py) sweeps them.
"""

from __future__ import annotations

import json
import os
import time

from distributed_tensorflow_tpu_torch.cluster import elastic

#: Default key namespace. The data service
#: (input/data_service.py) rides the same transport under its own
#: prefix (``data/<job>``) so input-worker liveness and trainer-fleet
#: liveness never share keys.
_DEFAULT_PREFIX = "fleet"


def hb_key(shard: int, pid: int, *, prefix: str = _DEFAULT_PREFIX) -> str:
    """Per-worker heartbeat key (written by the worker every step)."""
    return f"{prefix}/hb/{shard}/{pid}"


def sum_key(shard: int, *, prefix: str = _DEFAULT_PREFIX) -> str:
    """Per-shard summary key (written by the shard's reducer)."""
    return f"{prefix}/hbsum/{shard}"


def shard_of(pid: int, shard_size: int) -> int:
    return pid // shard_size


def shard_members(shard: int, shard_size: int,
                  num_workers: int) -> range:
    lo = shard * shard_size
    return range(lo, min(lo + shard_size, num_workers))


def num_shards(num_workers: int, shard_size: int) -> int:
    return -(-num_workers // shard_size)


class ShardedHeartbeatPublisher:
    """Worker-side: write this worker's heartbeat key; when this worker
    anchors its shard (lowest member pid), also fold the shard into the
    summary key. One or ``1 + shard_size`` KV ops per beat."""

    def __init__(self, agent, *, pid: int | None = None,
                 num_workers: int | None = None, shard_size: int = 32,
                 summarize_every: int = 1,
                 key_prefix: str = _DEFAULT_PREFIX):
        self.agent = agent
        self.pid = pid if pid is not None else agent.process_id
        self.num_workers = (num_workers if num_workers is not None
                            else agent.num_processes)
        self.shard_size = shard_size
        self.key_prefix = key_prefix
        self.shard = shard_of(self.pid, shard_size)
        self.is_reducer = (self.pid ==
                           shard_members(self.shard, shard_size,
                                         self.num_workers)[0])
        self.summarize_every = max(1, summarize_every)
        self._beats = 0

    def beat(self, step: int):
        """Publish liveness (and maybe the shard summary) for one step."""
        self.agent.key_value_set(
            hb_key(self.shard, self.pid, prefix=self.key_prefix),
            f"{int(step)} {time.time():.6f}")
        self._beats += 1
        if self.is_reducer and self._beats % self.summarize_every == 0:
            self.summarize()

    def summarize(self):
        """Fold this shard's member keys into the summary key."""
        members = {}
        for m in shard_members(self.shard, self.shard_size,
                               self.num_workers):
            raw = self.agent.key_value_try_get(
                hb_key(self.shard, m, prefix=self.key_prefix))
            if raw is None:
                continue
            parsed = _parse_hb(raw)
            if parsed is not None:
                members[str(m)] = parsed
        if members:
            self.agent.key_value_set(
                sum_key(self.shard, prefix=self.key_prefix),
                json.dumps(members))


def _parse_hb(raw: bytes) -> "list | None":
    """``b\"<step> <wall>\"`` -> [step, wall] (None when torn)."""
    try:
        parts = raw.decode().split()
        return [int(parts[0]), float(parts[1])]
    except (ValueError, IndexError, UnicodeDecodeError):
        return None


class FileHeartbeatSource:
    """The historical per-task heartbeat files (cluster/elastic.py) as a
    batched source: one scan per supervisor tick."""

    def __init__(self, supervisor_dir: str):
        self.dir = supervisor_dir
        self.generation = 0               # files are generation-agnostic

    def clear(self, num_workers: int):
        for i in range(num_workers):
            try:
                os.unlink(elastic.heartbeat_path(self.dir, i))
            except OSError:
                pass

    def read(self, worker: int) \
            -> "tuple[float, int | None, float | None] | None":
        path = elastic.heartbeat_path(self.dir, worker)
        try:
            mtime = os.path.getmtime(path)
            with open(path) as f:
                parts = f.read().split()
            step = int(parts[0]) if parts and parts[0].isdigit() else None
            wall = (float(parts[-1])
                    if parts and "." in parts[-1] else None)
            return mtime, step, wall
        except (OSError, ValueError):
            return None

    def read_all(self, num_workers: int) \
            -> "dict[int, tuple[float, int | None, float | None]]":
        out = {}
        for i in range(num_workers):
            hb = self.read(i)
            if hb is not None:
                out[i] = hb
        return out


class ShardedKVHeartbeats:
    """Supervisor-side sharded reader (and the matching worker factory).

    ``read_all`` polls the per-shard summary keys; a shard whose
    summary is missing or wholly stale (older than
    ``summary_stale_s`` — reducer death) falls back to enumerated
    per-member reads for that shard. The returned triples use each
    worker's self-reported wall clock as the observation time (the
    KV has no mtimes; in the in-process harness worker and supervisor
    share a clock, and on a real fleet the trace assembler's clock
    alignment applies — telemetry/trace.py).
    """

    def __init__(self, agent, *, shard_size: int = 32,
                 summary_stale_s: float = 2.0,
                 key_prefix: str = _DEFAULT_PREFIX):
        self.agent = agent
        self.shard_size = shard_size
        self.summary_stale_s = summary_stale_s
        self.key_prefix = key_prefix
        self.generation = 0
        #: ops accounting for the cost curves: summary reads vs
        #: fallback member reads per read_all
        self.reads_summary = 0
        self.reads_fallback = 0

    def publisher(self, pid: int, num_workers: int,
                  summarize_every: int = 1) -> ShardedHeartbeatPublisher:
        return ShardedHeartbeatPublisher(
            self.agent, pid=pid, num_workers=num_workers,
            shard_size=self.shard_size, summarize_every=summarize_every,
            key_prefix=self.key_prefix)

    def clear(self, num_workers: int):
        # Nothing to unlink: a reform bumps the generation, and the new
        # namespace starts empty; the dead generation's keys are the
        # lifecycle GC's job (cluster/kv_gc.py).
        pass

    def _read_shard_fallback(self, shard: int, num_workers: int,
                             out: dict):
        for m in shard_members(shard, self.shard_size, num_workers):
            raw = self.agent.key_value_try_get(
                hb_key(shard, m, prefix=self.key_prefix))
            self.reads_fallback += 1
            if raw is None:
                continue
            parsed = _parse_hb(raw)
            if parsed is not None:
                out[m] = (parsed[1], parsed[0], parsed[1])

    def read_all(self, num_workers: int) \
            -> "dict[int, tuple[float, int | None, float | None]]":
        out: dict = {}
        now = time.time()
        with elastic.generation_override(self.generation):
            for shard in range(num_shards(num_workers, self.shard_size)):
                raw = self.agent.key_value_try_get(
                    sum_key(shard, prefix=self.key_prefix))
                self.reads_summary += 1
                summary = None
                if raw is not None:
                    try:
                        summary = json.loads(raw.decode())
                    except (ValueError, UnicodeDecodeError):
                        summary = None
                if summary:
                    freshest = max(v[1] for v in summary.values())
                    if now - freshest <= self.summary_stale_s:
                        for m, (step, wall) in summary.items():
                            out[int(m)] = (wall, step, wall)
                        continue
                # missing/torn/stale summary (dead or lagging reducer):
                # enumerate THIS shard's members directly
                self._read_shard_fallback(shard, num_workers, out)
        return out

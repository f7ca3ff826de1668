"""Coordination-service surface: KV store, barriers, liveness — port of
``distributed_tensorflow_tpu/cluster/coordination.py``.

The checkpoint commit barriers (``checkpoint/checkpoint.py``), the
preemption agreement (``checkpoint/failure_handling.py``) and the peer
snapshot tiers (``checkpoint/peer_snapshot.py``) build on it. The
method names, the generation namespacing (:func:`~distributed_
tensorflow_tpu_torch.cluster.elastic.namespace`), the fault sites
(``coord.kv_get``, ``coord.barrier``) and the errors are JAX's.

- **One process** (no process group, or a group of one): every
  operation is served by :class:`_LocalService`, JAX's in-process
  service with its semantics.
- **Several processes**: the operations ride the ``torch.distributed``
  store of the default process group — the ``TCPStore`` that
  ``cluster/bootstrap.initialize`` made — under the prefix
  ``dtx_kv/``. That store cannot list a prefix, cannot refuse a second
  write and raises its own errors, so :class:`_StoreService` adds:

  - a key index: a key's first write claims a slot of an append-only
    list (``add`` on a counter, then the slot's name), so
    ``key_value_dir_get`` finds every key whose write finished, also
    under concurrent writers;
  - write-once keys: ``allow_overwrite=False`` claims a guard key with
    ``add`` and raises :class:`CoordinationError` on the second claim
    (the negotiation keys of the restore ladder are write-once);
  - timeouts: a ``get`` waits with the store's ``wait`` and raises
    :class:`CoordinationError`; a barrier that times out raises
    :class:`BarrierTimeoutError` naming the missing processes.
"""

from __future__ import annotations

import collections
import threading
import time
from datetime import timedelta

from distributed_tensorflow_tpu_torch.cluster import elastic
from distributed_tensorflow_tpu_torch.resilience import faults


class CoordinationError(RuntimeError):
    """A coordination-service operation failed (timeout, peer error)."""


class BarrierTimeoutError(CoordinationError):
    """``barrier`` timed out waiting for peers — likely a hung or dead
    task."""


class _LocalService:
    """In-process KV/barrier service (JAX ``_LocalService``): blocked
    readers wait on per-key conditions; ``stats`` counts operations and
    real wakeups."""

    def __init__(self):
        self._kv: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._waiters: dict[str, list] = {}
        self._barriers: dict[str, dict] = {}
        self.stats = collections.Counter()

    def _notify_key(self, key: str):
        w = self._waiters.get(key)
        if w is not None:
            self.stats["waiters_woken"] += w[1]
            w[0].notify_all()

    def set(self, key: str, value: bytes, *, allow_overwrite: bool = True):
        with self._lock:
            if not allow_overwrite and key in self._kv:
                raise CoordinationError(f"key {key!r} already exists")
            self._kv[key] = value
            self.stats["set"] += 1
            self._notify_key(key)

    def get(self, key: str, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self.stats["get"] += 1
            v = self._kv.get(key)
            if v is not None:
                return v
            w = self._waiters.get(key)
            if w is None:
                w = self._waiters[key] = [threading.Condition(self._lock), 0]
            w[1] += 1
            try:
                while key not in self._kv:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not w[0].wait(remaining):
                        raise CoordinationError(
                            f"timed out waiting for key {key!r}")
                return self._kv[key]
            finally:
                w[1] -= 1
                if w[1] <= 0 and self._waiters.get(key) is w:
                    del self._waiters[key]

    def try_get(self, key: str) -> bytes | None:
        with self._lock:
            self.stats["try_get"] += 1
            return self._kv.get(key)

    def dir_get(self, prefix: str) -> list[tuple[str, bytes]]:
        with self._lock:
            self.stats["dir_get"] += 1
            return sorted((k, v) for k, v in self._kv.items()
                          if k.startswith(prefix))

    def delete(self, key: str):
        """Delete ``key`` and (directory-style) every key under
        ``key/``."""
        with self._lock:
            self.stats["delete"] += 1
            self._kv.pop(key, None)
            for k in [k for k in self._kv if k.startswith(key + "/")]:
                del self._kv[k]

    def increment(self, key: str, amount: int) -> int:
        with self._lock:
            self.stats["increment"] += 1
            cur = int(self._kv.get(key, b"0")) + amount
            self._kv[key] = str(cur).encode()
            self._notify_key(key)
            return cur

    def num_keys(self) -> int:
        with self._lock:
            return len(self._kv)

    def barrier(self, name: str, timeout_s: float, n: int,
                participant: int = 0):
        """Block until ``n`` distinct participants reach ``name`` (one
        shot; ``n <= 1`` passes)."""
        with self._lock:
            st = self._barriers.get(name)
            if st is None:
                st = self._barriers[name] = {
                    "cv": threading.Condition(self._lock),
                    "arrived": set(), "n": n, "done": n <= 1}
            st["arrived"].add(participant)
            if st["done"]:
                return
            if len(st["arrived"]) >= st["n"]:
                st["done"] = True
                st["cv"].notify_all()
                return
            deadline = time.monotonic() + timeout_s
            while not st["done"]:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not st["cv"].wait(remaining):
                    if st["done"]:
                        return
                    raise BarrierTimeoutError(_missing_message(
                        name, timeout_s, st["arrived"], st["n"]))


def _missing_message(name, timeout_s, arrived, n) -> str:
    missing = sorted(set(range(n)) - set(arrived))
    shown = ", ".join(map(str, missing[:8]))
    if len(missing) > 8:
        shown += f", ... ({len(missing)} total)"
    return (f"barrier {name!r} timed out after {timeout_s}s: "
            f"{len(arrived)}/{n} arrived; missing participant(s): "
            f"[{shown}]")


_LOCAL = _LocalService()

#: the store prefix of every coordination key of the port
_PREFIX = "dtx_kv/"


class _StoreService:
    """The KV and barriers over a ``torch.distributed`` store (module
    docstring). Keys live under ``dtx_kv/v/``; the key index under
    ``dtx_kv/idx/``; write-once guards under ``dtx_kv/once/``; barrier
    counters under ``dtx_kv/bar/``."""

    def __init__(self, store, rank: int, world: int):
        self._store = store
        self._rank = rank
        self._world = world

    @staticmethod
    def _v(key: str) -> str:
        return f"{_PREFIX}v/{key}"

    def _has(self, full: str) -> bool:
        return bool(self._store.check([full]))

    def _register(self, key: str):
        """Claim an index slot the first time ``key`` is written (again
        after a delete)."""
        if self._store.add(f"{_PREFIX}reg/{key}", 1) != 1:
            return
        slot = self._store.add(f"{_PREFIX}idx/n", 1)
        self._store.set(f"{_PREFIX}idx/s{slot}", key.encode())

    def _indexed(self) -> list[str]:
        n = self._store.add(f"{_PREFIX}idx/n", 0)
        names = set()
        for i in range(1, n + 1):
            slot = f"{_PREFIX}idx/s{i}"
            if self._has(slot):           # absent: its claim is mid-write
                names.add(self._store.get(slot).decode())
        return sorted(names)

    def set(self, key: str, value: bytes, *, allow_overwrite: bool = True):
        full = self._v(key)
        if not allow_overwrite:
            claims = self._store.add(f"{_PREFIX}once/{key}", 1)
            if claims != 1 or self._has(full):
                raise CoordinationError(f"key {key!r} already exists")
        self._register(key)
        self._store.set(full, value)

    def get(self, key: str, timeout_s: float) -> bytes:
        full = self._v(key)
        try:
            self._store.wait([full], timedelta(seconds=timeout_s))
        except Exception as e:            # the store's own timeout error
            raise CoordinationError(
                f"timed out waiting for key {key!r}: {e}") from e
        return bytes(self._store.get(full))

    def try_get(self, key: str) -> bytes | None:
        full = self._v(key)
        if not self._has(full):
            return None
        return bytes(self._store.get(full))

    def dir_get(self, prefix: str) -> list[tuple[str, bytes]]:
        out = []
        for k in self._indexed():
            if k.startswith(prefix):
                v = self.try_get(k)
                if v is not None:
                    out.append((k, v))
        return sorted(out)

    def delete(self, key: str):
        for k in [key] + [k for k in self._indexed()
                          if k.startswith(key + "/")]:
            self._store.delete_key(self._v(k))
            self._store.delete_key(f"{_PREFIX}once/{k}")
            self._store.delete_key(f"{_PREFIX}reg/{k}")

    def increment(self, key: str, amount: int) -> int:
        # the store keeps an ``add`` counter as its decimal ASCII: a
        # get of the key reads b"<value>", as JAX's
        self._register(key)
        return int(self._store.add(self._v(key), amount))

    def barrier(self, name: str, timeout_s: float):
        """Each process adds its arrival to the barrier's counter and
        marks its own slot; the last one sets the release key, which the
        others wait for. A timeout names the processes whose slot is
        missing."""
        base = f"{_PREFIX}bar/{name}"
        self._store.set(f"{base}/p{self._rank}", b"1")
        if self._store.add(f"{base}/n", 1) >= self._world:
            self._store.set(f"{base}/done", b"1")
            return
        try:
            self._store.wait([f"{base}/done"], timedelta(seconds=timeout_s))
        except Exception as e:
            arrived = [i for i in range(self._world)
                       if self._has(f"{base}/p{i}")]
            raise BarrierTimeoutError(_missing_message(
                name, timeout_s, arrived, self._world)) from e


class CoordinationServiceAgent:
    """Client handle to the coordination service (JAX's
    ``CoordinationServiceAgent``). Use :func:`coordination_service` for
    the process-wide instance; every method works in one process."""

    def __init__(self):
        self._local = _LOCAL
        self._service: _StoreService | None = None
        self._service_of = None
        self.op_counts = collections.Counter()

    # -- identity ---------------------------------------------------------
    @staticmethod
    def _dist():
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist
        return None

    @property
    def _client(self) -> _StoreService | None:
        """The store service of the current default group, None in one
        process (a new group — a reformed cluster — gets a new one)."""
        dist = self._dist()
        if dist is None or dist.get_world_size() < 2:
            return None
        from torch.distributed import distributed_c10d
        store = distributed_c10d._get_default_store()
        if self._service is None or self._service_of is not store:
            self._service = _StoreService(store, dist.get_rank(),
                                          dist.get_world_size())
            self._service_of = store
        return self._service

    @property
    def is_distributed(self) -> bool:
        return self._client is not None

    @property
    def process_id(self) -> int:
        dist = self._dist()
        return dist.get_rank() if dist is not None else 0

    @property
    def num_processes(self) -> int:
        dist = self._dist()
        return dist.get_world_size() if dist is not None else 1

    @property
    def is_chief(self) -> bool:
        return self.process_id == 0

    # -- KV store ---------------------------------------------------------
    def key_value_set(self, key: str, value: bytes | str, *,
                      allow_overwrite: bool = True):
        self.op_counts["set"] += 1
        key = elastic.namespace(key)
        data = value.encode() if isinstance(value, str) else bytes(value)
        c = self._client
        if c is None:
            self._local.set(key, data, allow_overwrite=allow_overwrite)
        else:
            c.set(key, data, allow_overwrite=allow_overwrite)

    def key_value_get(self, key: str, timeout_s: float = 60.0) -> bytes:
        """Blocking get: waits until some process sets ``key``; raises
        :class:`CoordinationError` after ``timeout_s``."""
        self.op_counts["get"] += 1
        faults.fire("coord.kv_get", tag=key, exc=CoordinationError,
                    msg=f"injected fault: key_value_get({key!r})")
        key = elastic.namespace(key)
        c = self._client
        if c is None:
            return self._local.get(key, timeout_s)
        return c.get(key, timeout_s)

    def key_value_try_get(self, key: str) -> bytes | None:
        self.op_counts["try_get"] += 1
        key = elastic.namespace(key)
        c = self._client
        if c is None:
            return self._local.try_get(key)
        try:
            return c.try_get(key)
        except Exception:
            return None

    def key_value_dir_get(self, prefix: str) -> list[tuple[str, bytes]]:
        self.op_counts["dir_get"] += 1
        prefix = elastic.namespace(prefix)
        c = self._client
        if c is None:
            return self._local.dir_get(prefix)
        return c.dir_get(prefix)

    def key_value_delete(self, key: str):
        self.op_counts["delete"] += 1
        key = elastic.namespace(key)
        c = self._client
        if c is None:
            self._local.delete(key)
        else:
            c.delete(key)

    def key_value_increment(self, key: str, amount: int = 1) -> int:
        """Atomic fetch-add; returns the post-increment value."""
        self.op_counts["increment"] += 1
        key = elastic.namespace(key)
        c = self._client
        if c is None:
            return self._local.increment(key, amount)
        return c.increment(key, amount)

    # -- barriers ---------------------------------------------------------
    def barrier(self, name: str, timeout_s: float = 120.0):
        """Block until every process reaches the barrier ``name``;
        :class:`BarrierTimeoutError` on timeout. One shot: use a name a
        round."""
        self.op_counts["barrier"] += 1
        faults.fire("coord.barrier", tag=name, exc=BarrierTimeoutError,
                    msg=f"injected barrier timeout at {name!r}")
        raw_name = name
        name = elastic.namespace(name)
        c = self._client
        if c is None:
            self._local.barrier(name, timeout_s, self.num_processes,
                                participant=self.process_id)
        else:
            c.barrier(name, timeout_s)
        from distributed_tensorflow_tpu_torch.telemetry import events
        if events.enabled():
            events.event("clock.sync", barrier=raw_name)

    # -- liveness ---------------------------------------------------------
    def live_processes(self) -> list[int]:
        """Process ids believed alive. The store tracks no liveness, so
        with several processes every one is reported (JAX's answer for a
        service without ``get_live_nodes``)."""
        return list(range(self.num_processes))


_AGENT: CoordinationServiceAgent | None = None
_AGENT_LOCK = threading.Lock()


def coordination_service() -> CoordinationServiceAgent:
    """The process-wide :class:`CoordinationServiceAgent`."""
    global _AGENT
    with _AGENT_LOCK:
        if _AGENT is None:
            _AGENT = CoordinationServiceAgent()
        return _AGENT

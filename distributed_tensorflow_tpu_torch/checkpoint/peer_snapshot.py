"""The chunked write-once blob transport of
``distributed_tensorflow_tpu/checkpoint/peer_snapshot.py``, the part
that KV-block migration (``serving/migrate.py``) publishes through.

A blob is written as chunk keys ``<prefix>/c<i>`` of at most
:data:`CHUNK` bytes, then the count key ``<prefix>/n``, which commits
it: a reader waits for the count, so a publisher killed mid-write never
leaves a readable half-blob. Any agent with ``key_value_set`` /
``key_value_get`` (and, for :func:`kv_blob_committed`,
``key_value_try_get``) carries it — e.g. ``serving.migrate.FileKV``.
The keys and chunking are the JAX package's, so either package reads
the other's blobs.
"""

from __future__ import annotations

#: KV blob chunk size — under a coordination service's 4 MiB message cap
CHUNK = 2 << 20


def kv_put_blob(agent, prefix: str, data: bytes):
    """Publish ``data`` under ``prefix``: the chunks first, the count
    key last."""
    n = max(1, (len(data) + CHUNK - 1) // CHUNK)
    for i in range(n):
        agent.key_value_set(f"{prefix}/c{i}",
                            data[i * CHUNK:(i + 1) * CHUNK])
    agent.key_value_set(f"{prefix}/n", str(n))


def kv_get_blob(agent, prefix: str, timeout_s: float) -> bytes:
    """Fetch a blob :func:`kv_put_blob` published (waits for the count
    key, so a torn publish is never read)."""
    n = int(agent.key_value_get(f"{prefix}/n", timeout_s=timeout_s))
    return b"".join(
        agent.key_value_get(f"{prefix}/c{i}", timeout_s=timeout_s)
        for i in range(n))


def kv_blob_committed(agent, prefix: str) -> bool:
    """Has a blob under ``prefix`` fully committed? (No wait.)"""
    return agent.key_value_try_get(f"{prefix}/n") is not None

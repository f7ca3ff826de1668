"""KV-key lifecycle: garbage-collect dead generations' coordination keys
— port of ``distributed_tensorflow_tpu/cluster/kv_gc.py``, on the port's
coordination agent (``cluster/coordination.py``); the rules, prefixes
and answers are JAX's.

Elastic recovery (cluster/elastic.py) namespaces every coordination KV
key and barrier with the cluster generation — ``gen<N>/…`` — so a
reformed cluster can never collide with a dead incarnation's state.
The flip side: every reform strands a whole namespace of keys
(heartbeat shards, telemetry snapshots, rollup partials, checkpoint
commit markers) that nothing will ever read again, and on a long
flapping run the KV grows without bound. This module is the sweeper.

Lifecycle rules (mirrored in the README "Fleet scale" section):

- A generation is **dead** once the supervisor has reformed past it
  (``generation() > N``). Generation 0 is unprefixed by design and is
  therefore never swept — its keys are the non-elastic key layout.
- A dead generation is **sweep-eligible** only after a *grace window*
  measured from its last observed heartbeat: a straggler process of
  the dead generation (SIGKILL survivor wedged in a collective, a
  thread finishing a blocking read) may still be touching its keys.
  Reads of a swept key would block/time out rather than corrupt, but a
  straggler's re-WRITE after the sweep would resurrect a half-dead
  namespace — the grace window (default :data:`DEFAULT_GRACE_S`) keeps
  the sweep strictly after the namespace has gone quiet.
- The sweep itself is one directory-style delete per dead generation
  (``key_value_delete("gen<N>")`` removes the key and everything under
  ``gen<N>/``). Live generations are untouched: the
  delete is anchored at the dead generation's prefix, issued under a
  ``generation_override(0)`` so the agent's own namespacing cannot
  re-prefix it into the current generation.

Drivers: a recovery supervisor notes each outgoing generation's last
heartbeat at reform time and polls :meth:`GenerationGC.maybe_sweep`
from its watch loop (JAX's ``resilience/supervisor.py``, not yet
ported). A chief worker can also run the
sweep itself via :func:`sweep_generations` when no supervisor owns the
KV (e.g. externally-orchestrated restarts).
"""

from __future__ import annotations

import threading
import time

from distributed_tensorflow_tpu_torch.cluster import elastic

#: Default grace window between a generation's last observed heartbeat
#: and its sweep. Sized to comfortably exceed a straggler's longest
#: plausible in-flight operation (a blocking KV get's timeout is the
#: worst case; production deployments should set it to that timeout).
DEFAULT_GRACE_S = 30.0


def generation_prefix(gen: int) -> str:
    """The raw KV prefix of generation ``gen``'s namespace (no trailing
    slash — the directory-style delete adds it)."""
    return f"gen{int(gen)}"


def sweep_generations(agent, gens, *, current_gen: int | None = None):
    """Delete every key of each dead generation in ``gens``.

    Generation 0 and any generation >= the current one are skipped
    (never sweep a live namespace). Returns the list of generations
    actually swept. Safe to call repeatedly — deleting an
    already-empty prefix is a no-op on every backend.
    """
    cur = current_gen if current_gen is not None else elastic.generation()
    swept = []
    for g in sorted(set(int(g) for g in gens)):
        if g <= 0 or g >= cur:
            continue
        # override(0): namespace() must NOT re-prefix the dead
        # generation's key into the caller's current namespace
        with elastic.generation_override(0):
            agent.key_value_delete(generation_prefix(g))
        swept.append(g)
    return swept


class GenerationGC:
    """Grace-windowed sweeper of dead generations' KV namespaces.

    The owner (supervisor or harness) reports each generation's end via
    :meth:`note_generation_end` with the last heartbeat wall clock it
    observed from that generation, then calls :meth:`maybe_sweep`
    opportunistically (every watch tick is fine — it is an in-memory
    check unless something is actually eligible).
    """

    def __init__(self, agent, *, grace_s: float = DEFAULT_GRACE_S):
        self.agent = agent
        self.grace_s = grace_s
        self._lock = threading.Lock()
        self._ended: dict[int, float] = {}    # gen -> last heartbeat wall
        self.swept: list[int] = []

    def note_generation_end(self, gen: int, last_heartbeat_wall:
                            "float | None" = None):
        """Record that ``gen`` is dead; its grace window runs from
        ``last_heartbeat_wall`` (defaults to now — the conservative
        choice when no heartbeat was ever observed)."""
        if gen <= 0:
            return                        # gen 0 is unprefixed: never GC'd
        with self._lock:
            wall = (last_heartbeat_wall if last_heartbeat_wall is not None
                    else time.time())
            # a straggler could in principle heartbeat again; keep the max
            self._ended[gen] = max(wall, self._ended.get(gen, 0.0))

    def pending(self) -> "list[int]":
        """Dead generations noted but not yet swept."""
        with self._lock:
            return sorted(self._ended)

    def maybe_sweep(self, *, current_gen: int | None = None,
                    now: "float | None" = None) -> "list[int]":
        """Sweep every noted generation whose grace window has elapsed.
        Returns the generations swept this call."""
        now = now if now is not None else time.time()
        with self._lock:
            eligible = [g for g, wall in self._ended.items()
                        if now - wall >= self.grace_s]
        if not eligible:
            return []
        swept = sweep_generations(self.agent, eligible,
                                  current_gen=current_gen)
        with self._lock:
            for g in swept:
                self._ended.pop(g, None)
            self.swept.extend(swept)
        return swept

"""Elastic cluster generations — port of
``distributed_tensorflow_tpu/cluster/elastic.py``, byte for byte in
behaviour: the same environment variables (:data:`ENV_GENERATION`,
:data:`ENV_SUPERVISOR_DIR`, ``DTX_MPR_TASK_INDEX``) and file names
(``heartbeat-<task>``, ``drain-<task>``, ``peermem/worker-<task>``), so
a supervisor of either package drives a trainer of the port.

A *generation* is one incarnation of the cluster. The recovery
supervisor increments it each time it reforms the cluster; the id
reaches every restarted process through the environment.

- **Fresh coordination namespaces.** Every KV key and barrier name the
  port's :class:`~distributed_tensorflow_tpu_torch.cluster.coordination.
  CoordinationServiceAgent` touches is prefixed with ``gen<N>/``
  (:func:`namespace`); generation 0 is unprefixed.
- **Restart awareness.** :func:`generation` and :func:`under_supervisor`
  (how ``TerminationConfig.for_platform`` picks restart-instead-of-exit).
- **Liveness.** :func:`heartbeat` writes this task's step to a per-task
  file under :data:`ENV_SUPERVISOR_DIR`; a no-op outside a supervised
  run.
"""

from __future__ import annotations

import contextlib
import os
import threading

#: Cluster generation id, injected by the recovery supervisor.
ENV_GENERATION = "DTX_CLUSTER_GENERATION"

#: Scratch directory shared with the supervisor (heartbeat files).
ENV_SUPERVISOR_DIR = "DTX_SUPERVISOR_DIR"

_GENERATION: int | None = None
_TLS = threading.local()


def generation() -> int:
    """The current cluster generation (0 for a never-reformed job).

    A thread-local :func:`generation_override` wins over everything (the
    simulated-fleet harness runs hundreds of "workers" as threads of one
    process, each possibly in a different generation — see the JAX
    package's testing/fleet_sim.py); an explicit :func:`set_generation`
    wins next;
    otherwise the value comes from the environment on every call (no
    caching — pooled test processes swap env between runs)."""
    g = getattr(_TLS, "gen", None)
    if g is not None:
        return g
    if _GENERATION is not None:
        return _GENERATION
    try:
        return int(os.environ.get(ENV_GENERATION, "0"))
    except ValueError:
        return 0


@contextlib.contextmanager
def generation_override(gen: int):
    """Pin the generation for the CURRENT THREAD only.

    The in-process fleet simulator gives every simulated worker thread
    its own generation: a straggler thread of a dead generation keeps
    namespacing its keys with the OLD id (exactly like a straggler
    process would) while reformed workers already live in the new one.
    Nestable; restores the previous override on exit."""
    prev = getattr(_TLS, "gen", None)
    _TLS.gen = int(gen)
    try:
        yield
    finally:
        _TLS.gen = prev


def set_generation(gen: int | None):
    """Pin the generation programmatically (tests, embedded supervisors);
    ``None`` reverts to the environment."""
    global _GENERATION
    _GENERATION = None if gen is None else int(gen)


def namespace(name: str) -> str:
    """Namespace a coordination key/barrier name with the generation.

    Generation 0 returns ``name`` unchanged (non-elastic jobs keep their
    historical key layout); generation N prefixes ``gen<N>/`` so the
    reformed cluster's coordination state is disjoint from every prior
    incarnation's."""
    g = generation()
    return name if g == 0 else f"gen{g}/{name}"


def under_supervisor() -> bool:
    """True when a recovery supervisor owns this process's lifecycle."""
    return bool(os.environ.get(ENV_SUPERVISOR_DIR))


def heartbeat(step: int | None = None):
    """Report liveness (and optionally the current step) to the
    supervisor. Call once per training step; outside a supervised run
    this is a single env lookup."""
    d = os.environ.get(ENV_SUPERVISOR_DIR)
    if not d:
        return
    task = os.environ.get("DTX_MPR_TASK_INDEX", "0")
    try:
        import time
        # "<step> <wall>": the wall clock is this worker's reading of
        # the write instant; the supervisor pairs it with the file's
        # mtime (its own clock domain) into a ``clock.hb`` telemetry
        # event — the heartbeat half of cross-host clock alignment
        # (the JAX package's telemetry/trace.py).
        with open(os.path.join(d, f"heartbeat-{task}"), "w") as f:
            f.write(("" if step is None else str(int(step)))
                    + f" {time.time():.6f}")
    except OSError:
        pass                      # supervisor dir raced away: non-fatal


def heartbeat_path(supervisor_dir: str, task_index: int) -> str:
    """Supervisor-side: the heartbeat file a task writes."""
    return os.path.join(supervisor_dir, f"heartbeat-{task_index}")


def drain_path(supervisor_dir: str, task_index: int | str) -> str:
    """Supervisor-side: the drain flag a task polls. The supervisor
    writes it before a SCALE reform (the JAX package's resilience/supervisor.py
    ``drain_on_scale``); a serving replica that sees it stops admitting
    new requests, finishes its running sequences, logs them and exits
    cleanly — so a replica removed by scale-down drops zero requests
    (the held/unfinished remainder re-shards onto the next
    generation)."""
    return os.path.join(supervisor_dir, f"drain-{task_index}")


def drain_requested(supervisor_dir: str | None = None,
                    task_index: int | str | None = None) -> bool:
    """Worker-side: has the supervisor asked this task to drain?
    Defaults resolve from the environment exactly like
    :func:`heartbeat`; explicit arguments serve in-process simulated
    workers (threads of one process share one environment).
    A single ``os.path.exists`` — cheap enough for every step."""
    d = supervisor_dir or os.environ.get(ENV_SUPERVISOR_DIR)
    if not d:
        return False
    if task_index is None:
        task_index = os.environ.get("DTX_MPR_TASK_INDEX", "0")
    return os.path.exists(drain_path(d, task_index))


def drain_mode(supervisor_dir: str | None = None,
               task_index: int | str | None = None) -> str | None:
    """The drain flag's mode, or None when no drain is requested:
    ``"fast"`` (finish only in-flight/running work — a scale-UP wants
    the capacity add now, queued work re-shards) or ``"full"`` (finish
    everything already admitted — a scale-DOWN happens at low load, so
    completing the queue before the reform keeps those requests off
    the respawn gap's latency tail)."""
    d = supervisor_dir or os.environ.get(ENV_SUPERVISOR_DIR)
    if not d:
        return None
    if task_index is None:
        task_index = os.environ.get("DTX_MPR_TASK_INDEX", "0")
    try:
        with open(drain_path(d, task_index)) as f:
            mode = f.read().strip()
        return mode if mode in ("fast", "full") else "fast"
    except OSError:
        return None


def peer_memdir(task_index: int | str | None = None) -> str | None:
    """This worker's *memdir* — the directory standing in for its
    machine's RAM/ramdisk in the peer-snapshot tier
    (checkpoint/peer_snapshot.py). Lives under the supervisor's scratch
    dir keyed by task index: it survives a process restart (the
    supervisor respawns onto the same "machine") but the supervisor
    wipes it when the machine is considered dead. ``None`` outside a
    supervised run."""
    d = os.environ.get(ENV_SUPERVISOR_DIR)
    if not d:
        return None
    if task_index is None:
        task_index = os.environ.get("DTX_MPR_TASK_INDEX", "0")
    return peer_memdir_path(d, task_index)


def peer_memdir_path(supervisor_dir: str, task_index: int | str) -> str:
    """Supervisor-side: the memdir of the machine behind a task slot."""
    return os.path.join(supervisor_dir, "peermem", f"worker-{task_index}")

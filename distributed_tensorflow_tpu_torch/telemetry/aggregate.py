"""Cross-host metric aggregation over the coordination KV store.

The port's copy of ``distributed_tensorflow_tpu/telemetry/aggregate.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

Workers publish periodic registry snapshots; the coordinator merges
them into fleet rollups and emits them to TensorBoard:

    worker p                         coordinator (process 0)
    --------                         -----------------------
    MetricsPublisher thread          FleetAggregator thread
    snap = registry.snapshot()       for p in worker_ids:
    kv[telemetry/snap/p] = json        read kv[telemetry/snap/p]
      (every interval_s)             rollup = merge(snapshots)
                                     SummaryWriter <- fleet/<name>/<stat>

KV discipline (JAX's, kept so that both packages read each other's
keys): snapshots are JSON **strings**, the coordinator
reads them with enumerated per-process point reads (``try_get`` per
worker id — NEVER a directory read, which hangs off-host on that
vintage), and keys are overwritten in place, never deleted-and-recreated.

Rollup semantics per instrument type:

- counter    -> ``sum`` across processes, ``max``, per-worker values
- gauge      -> per-worker values (+ ``max``/``mean`` when numeric)
- histogram/timer -> ``count``/``sum`` summed; ``max`` of maxes;
  ``p50`` = count-weighted median of per-worker p50s (approximate —
  workers export percentiles, not samples); ``p95`` = max of per-worker
  p95s (conservative: fleet tail latency is at least the worst worker's)
"""

from __future__ import annotations

import json
import threading
import time

from distributed_tensorflow_tpu_torch.telemetry import registry as _registry

_SNAP_PREFIX = "dtx_telemetry/snap"
_TREE_PREFIX = "dtx_telemetry/tree"


def _snap_key(process_id: int) -> str:
    return f"{_SNAP_PREFIX}/{process_id}"


def _tree_key(level: int, node: int) -> str:
    return f"{_TREE_PREFIX}/{level}/{node}"


def publish_snapshot(agent=None, reg=None,
                     process_id: int | None = None, seq: int = 0) -> dict:
    """Publish this process's registry snapshot to the coordination KV.
    Returns the published payload."""
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    agent = agent or coordination_service()
    reg = reg or _registry.get_registry()
    pid = process_id if process_id is not None else agent.process_id
    payload = {"pid": pid, "seq": seq, "wall": time.time(),
               "metrics": reg.snapshot()}
    agent.key_value_set(_snap_key(pid), json.dumps(payload))
    return payload


def read_snapshots(agent=None, worker_ids=None) -> dict:
    """Enumerated point reads of every process's latest snapshot:
    ``{pid: payload}`` (absent processes omitted)."""
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    agent = agent or coordination_service()
    if worker_ids is None:
        worker_ids = range(agent.num_processes)
    out: dict[int, dict] = {}
    for pid in worker_ids:
        raw = agent.key_value_try_get(_snap_key(pid))
        if raw is None:
            continue
        try:
            out[pid] = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue                    # torn publish: take the next one
    return out


def _weighted_median(pairs: "list[tuple[float, float]]") -> float | None:
    """(value, weight) pairs -> weighted median."""
    pairs = sorted(p for p in pairs if p[0] is not None)
    if not pairs:
        return None
    total = sum(w for _, w in pairs) or len(pairs)
    acc = 0.0
    for v, w in pairs:
        acc += w if w else 1.0
        if acc * 2 >= total:
            return v
    return pairs[-1][0]


def merge_rollup(snapshots: "dict[int, dict]") -> dict:
    """Merge per-process snapshot payloads into one fleet rollup:
    ``{"workers": {...}, "metrics": {name: {stat: value}}}``."""
    per_metric: dict[str, dict[int, dict]] = {}
    workers: dict[int, dict] = {}
    for pid, payload in snapshots.items():
        workers[pid] = {"seq": payload.get("seq"),
                        "wall": payload.get("wall")}
        for name, entry in (payload.get("metrics") or {}).items():
            per_metric.setdefault(name, {})[pid] = entry

    metrics: dict[str, dict] = {}
    for name, by_pid in sorted(per_metric.items()):
        kinds = {e.get("type") for e in by_pid.values()}
        kind = kinds.pop() if len(kinds) == 1 else "gauge"
        out: dict = {"type": kind}
        if kind == "counter":
            vals = {p: e.get("value", 0) for p, e in by_pid.items()}
            out["sum"] = sum(vals.values())
            out["max"] = max(vals.values())
            out["per_worker"] = vals
        elif kind in ("histogram", "timer"):
            counts = {p: e.get("count", 0) for p, e in by_pid.items()}
            out["count"] = sum(counts.values())
            out["sum"] = round(sum(e.get("sum") or 0.0
                                   for e in by_pid.values()), 9)
            maxes = [e.get("max") for e in by_pid.values()
                     if e.get("max") is not None]
            if maxes:
                out["max"] = max(maxes)
            p50 = _weighted_median(
                [(e.get("p50"), counts[p]) for p, e in by_pid.items()
                 if e.get("p50") is not None])
            if p50 is not None:
                out["p50"] = p50
            p95s = [e.get("p95") for e in by_pid.values()
                    if e.get("p95") is not None]
            if p95s:
                out["p95"] = max(p95s)
            out["per_worker_count"] = counts
        else:                            # gauge
            vals = {p: e.get("value") for p, e in by_pid.items()}
            out["per_worker"] = vals
            nums = [v for v in vals.values()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)]
            if nums:
                out["max"] = max(nums)
                out["mean"] = sum(nums) / len(nums)
        metrics[name] = out
    return {"workers": workers, "metrics": metrics}


def collect_rollup(agent=None, worker_ids=None) -> dict:
    """One-shot: read every process's snapshot and merge."""
    return merge_rollup(read_snapshots(agent, worker_ids))


# ---------------------------------------------------------------------------
# Tree-structured rollups (fleet scale)
# ---------------------------------------------------------------------------
# The flat scheme above has the coordinator point-read every worker's
# snapshot key — O(N) KV ops on ONE node per rollup tick, the
# control-plane bottleneck the fleet harness (testing/fleet_sim.py)
# exposes first. The tree scheme spreads that fan-in over reducer
# workers: leaves keep publishing their own snapshot key exactly as
# before, but designated reducers (the lowest pid of each fanout-sized
# group) union their group's snapshots into one *partial* key per tree
# node, level by level, and the coordinator reads only the ROOT key.
# No single node ever touches more than ``fanout`` keys per tick
# (the root reducer pays fanout ops per level: O(fanout·log_F N)), and
# the merged output is BIT-IDENTICAL to the flat path at every depth —
# partials carry the union of leaf payloads, so the final merge is the
# same ``merge_rollup`` over the same per-worker entries, just routed
# through fewer reads at the top. (The trade is payload size, not op
# count: a root partial aggregates every worker's snapshot. KV ops —
# RPC count — are what bound the control plane at small-snapshot
# sizes.)
#
# Freshness: a value reaches the root after every level between has
# republished — rollup latency is O(depth × publish interval), which
# testing/fleet_sim.py measures as snapshot age at collect time.
#
# KV discipline unchanged: partials are JSON strings, written in
# place, read with enumerated point reads; a dead reducer's partial
# simply goes stale (its subtree's freshness degrades until the
# supervisor reforms the cluster — the same failure surface sharded
# heartbeats have, see resilience/heartbeats.py).


class RollupTopology:
    """The fanout-F reduction tree over worker ids.

    Level 0 groups ``fanout`` consecutive leaves per node; each higher
    level groups ``fanout`` nodes of the level below, up to a single
    root. The reducer of a node is the lowest pid under it — so pid 0
    is the root reducer, and a reducer's duties nest (it reduces its
    group at every level it anchors).
    """

    def __init__(self, num_workers: int, fanout: int = 16):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if fanout < 2:
            raise ValueError("fanout must be >= 2")
        self.num_workers = num_workers
        self.fanout = fanout
        #: nodes per level, leaves upward: levels[0] = ceil(N/F), ...
        self.level_sizes: list[int] = []
        n = num_workers
        while True:
            n = -(-n // fanout)           # ceil division
            self.level_sizes.append(n)
            if n == 1:
                break

    @property
    def depth(self) -> int:
        return len(self.level_sizes)

    @property
    def root(self) -> "tuple[int, int]":
        return (self.depth - 1, 0)

    def leaf_children(self, node: int) -> range:
        """Worker pids under level-0 node ``node``."""
        lo = node * self.fanout
        return range(lo, min(lo + self.fanout, self.num_workers))

    def node_children(self, level: int, node: int) -> range:
        """Child node indices (at ``level - 1``) of a level>=1 node."""
        lo = node * self.fanout
        return range(lo, min(lo + self.fanout,
                             self.level_sizes[level - 1]))

    def reducer_of(self, level: int, node: int) -> int:
        """The pid responsible for publishing this node's partial."""
        return node * self.fanout ** (level + 1)

    def duties(self, pid: int) -> "list[tuple[int, int]]":
        """The (level, node) partials ``pid`` publishes, leaves upward
        (ascending level — a reducer folds its own lower partial into
        the next level's on the same tick)."""
        out = []
        for level, size in enumerate(self.level_sizes):
            step = self.fanout ** (level + 1)
            if pid % step != 0:
                break                     # not a reducer above this level
            node = pid // step
            if node < size:
                out.append((level, node))
        return out


def publish_tree_partial(agent, level: int, node: int,
                         snapshots: "dict[int, dict]"):
    """Publish the union-of-leaf-snapshots partial for one tree node."""
    agent.key_value_set(
        _tree_key(level, node),
        json.dumps({"wall": time.time(),
                    "snapshots": {str(p): s
                                  for p, s in snapshots.items()}}))


def read_tree_partial(agent, level: int, node: int) -> "dict[int, dict]":
    """The leaf snapshots accumulated under one tree node ({} when the
    partial is absent or torn)."""
    raw = agent.key_value_try_get(_tree_key(level, node))
    if raw is None:
        return {}
    try:
        payload = json.loads(raw.decode())
        return {int(p): s
                for p, s in (payload.get("snapshots") or {}).items()}
    except (ValueError, UnicodeDecodeError):
        return {}                         # torn publish: next tick heals


def run_duties(agent, topology: RollupTopology, pid: int):
    """Execute ``pid``'s reducer duties for one tick: for each anchored
    node (leaves upward), union the children's payloads and republish
    the partial. Missing children (dead or not-yet-published workers)
    are skipped — their last partial simply stays stale."""
    for level, node in topology.duties(pid):
        if level == 0:
            snaps = read_snapshots(agent, topology.leaf_children(node))
        else:
            snaps = {}
            for child in topology.node_children(level, node):
                snaps.update(read_tree_partial(agent, level - 1, child))
        if snaps:
            publish_tree_partial(agent, level, node, snaps)


def collect_rollup_tree(agent, topology: RollupTopology) -> dict:
    """Coordinator-side collect: ONE root read instead of N leaf reads;
    the merge itself is the exact flat-path ``merge_rollup`` over the
    union the tree accumulated (bit-identical output at any depth)."""
    level, node = topology.root
    return merge_rollup(read_tree_partial(agent, level, node))


def phase_summary(rollup: dict) -> dict:
    """Fleet-wide step-phase view of a rollup: the per-step phase
    fractions StepTelemetry publishes (``training/phase/<name>_frac``
    histograms) as count-weighted p50s, plus the worst worker's p95 and
    the mean/min overlap efficiency across workers. The fleet answer to
    "is anyone input/comm/checkpoint-bound?" without reading any
    worker's event file."""
    metrics = rollup.get("metrics", {})
    phases: dict = {}
    for name, entry in metrics.items():
        if not name.startswith("training/phase/") \
                or not name.endswith("_frac"):
            continue
        phase = name[len("training/phase/"):-len("_frac")]
        phases[phase] = {k: entry[k] for k in ("p50", "p95", "count")
                        if k in entry}
    overlap = metrics.get("training/overlap_eff", {})
    vals = [v for v in (overlap.get("per_worker") or {}).values()
            if isinstance(v, (int, float))]
    return {"phases": phases,
            "overlap_eff": {"mean": sum(vals) / len(vals),
                            "min": min(vals)} if vals else None}


def rollup_scalars(rollup: dict) -> dict:
    """Flatten a rollup into TensorBoard scalar tags:
    ``fleet/<metric>/<stat> -> float``."""
    out: dict[str, float] = {}
    for name, entry in rollup.get("metrics", {}).items():
        for stat in ("sum", "max", "mean", "p50", "p95", "count"):
            v = entry.get(stat)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"fleet/{name}/{stat}"] = float(v)
    return out


class MetricsPublisher:
    """Worker-side background thread publishing registry snapshots on a
    period. ``stop()`` publishes one final snapshot so short runs are
    never invisible to the coordinator.

    With ``tree`` set (a :class:`RollupTopology`), the publisher also
    executes this process's reducer duties each tick — the worker-side
    half of the tree-structured rollup path."""

    def __init__(self, agent=None, reg=None,
                 interval_s: float = 2.0, process_id: int | None = None,
                 tree: "RollupTopology | None" = None):
        from distributed_tensorflow_tpu_torch.cluster.coordination import (
            coordination_service)
        self.agent = agent or coordination_service()
        self.reg = reg or _registry.get_registry()
        self.interval_s = interval_s
        self.process_id = (process_id if process_id is not None
                           else self.agent.process_id)
        self.tree = tree
        self._seq = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtx-telemetry-publish")
        self._thread.start()

    def _publish(self):
        self._seq += 1
        try:
            publish_snapshot(self.agent, self.reg,
                             process_id=self.process_id, seq=self._seq)
            if self.tree is not None:
                run_duties(self.agent, self.tree, self.process_id)
        except Exception:
            pass                        # service going down mid-run

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._publish()

    def stop(self):
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._publish()             # final flush

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class FleetAggregator:
    """Coordinator-side background thread: collect per-process
    snapshots, merge into a fleet rollup, emit scalars to TensorBoard
    (utils/summary.SummaryWriter). ``last_rollup`` is the stall
    detector's source for naming the slowest worker."""

    def __init__(self, worker_ids, agent=None, interval_s: float = 2.0,
                 summary_writer=None, step_metric: str =
                 "training/steps_completed",
                 tree: "RollupTopology | None" = None):
        from distributed_tensorflow_tpu_torch.cluster.coordination import (
            coordination_service)
        self.agent = agent or coordination_service()
        self.worker_ids = list(worker_ids)
        self.tree = tree
        self.interval_s = interval_s
        self.writer = summary_writer
        self.step_metric = step_metric
        self._rollup_lock = threading.Lock()
        self._last_rollup: dict | None = None
        self._n = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dtx-telemetry-aggregate")
        self._thread.start()

    @property
    def last_rollup(self) -> dict | None:
        with self._rollup_lock:
            return self._last_rollup

    def export_live(self, **exporter_kwargs):
        """Start a :class:`telemetry.exporter.MetricsExporter` whose
        scrape merges this aggregator's latest fleet rollup (per-worker
        ``worker="<pid>"`` labels) — ONE scrape of the coordinator sees
        every worker. Caller owns ``.stop()``."""
        from distributed_tensorflow_tpu_torch.telemetry import exporter
        return exporter.MetricsExporter(
            rollup_fn=lambda: self.last_rollup, **exporter_kwargs)

    def collect_once(self) -> dict:
        rollup = (collect_rollup_tree(self.agent, self.tree)
                  if self.tree is not None
                  else collect_rollup(self.agent, self.worker_ids))
        with self._rollup_lock:
            self._last_rollup = rollup
            self._n += 1
            n = self._n
        if self.writer is not None and rollup.get("metrics"):
            # global step for the scalar series: the fleet-max completed
            # step when published, else the rollup ordinal
            step_entry = rollup["metrics"].get(self.step_metric, {})
            step = int(step_entry.get("max", n) or n)
            try:
                self.writer.scalars(rollup_scalars(rollup), step=step)
                self.writer.flush()
            except Exception:
                pass
        return rollup

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.collect_once()
            except Exception:
                pass                    # service teardown mid-run

    def stop(self):
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=5.0)
            try:
                self.collect_once()     # final rollup
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

"""Goodput/badput ledger: price every wall-clock second of a run — port
of ``distributed_tensorflow_tpu/telemetry/goodput.py``.

Every second of every worker is classified into **goodput** (productive
step time: ``train.step``, or ``serve.step`` minus its replayed share)
or a named **badput** bucket (:data:`BADPUT_BUCKETS`): ``startup``,
``infeed_wait``, ``ckpt_block``, ``recovery``, ``scale_transition``,
``preempt_replay`` (serving time spent re-generating tokens a preempted
sequence had produced), ``reroute_replay``, ``kv_migrate`` (KV-block
migration: disaggregated prefill→decode handoff and rescue,
``serving/migrate.py``), ``rollout`` (weight hot-swap,
``InferenceEngine.install_version``) and ``idle`` (the residual), with
the identity ``wall == goodput + Σ badput`` exact by construction in
both implementations:

- :func:`ledger_from_events` — post hoc, from a run's event files
  (``telemetry.read_run``), walking each worker's events in append
  order with overlap clipping;
- :class:`GoodputLedger` — the live in-process ledger a serving engine
  feeds per step (``serve_step``, ``tokens``, ``record``), clamped to
  elapsed wall and exported through a registry collector as
  ``goodput/*`` gauges.

The classification, bucket names and fields are the JAX package's, so
one event list gives one ledger in both packages.
"""

from __future__ import annotations

import threading
import time

from distributed_tensorflow_tpu_torch.telemetry import registry as _registry

#: Badput bucket names, in render order. ``idle`` is the residual that
#: makes the identity exact.
BADPUT_BUCKETS = ("startup", "infeed_wait", "ckpt_block", "recovery",
                  "scale_transition", "preempt_replay",
                  "reroute_replay", "kv_migrate", "rollout", "idle")

#: Step events whose duration is (mostly) goodput.
_STEP_EVENTS = frozenset({"train.step", "serve.step"})


# ---------------------------------------------------------------------------
# Post-hoc / supervisor-live: classify a run's event files
# ---------------------------------------------------------------------------

def _empty() -> dict:
    return {"wall_s": 0.0, "goodput_s": 0.0,
            "badput_s": {b: 0.0 for b in BADPUT_BUCKETS}}


def _worker_ledger(events: "list[dict]",
                   scale_generations: "frozenset | set" = frozenset()
                   ) -> dict:
    """Partition one worker's observed wall span.

    Walks events in FILE ORDER (append order — chronological across
    generations even though the monotonic ``t`` resets per incarnation).
    Only three things advance the classification *cursor*: **step
    events** (their clipped ``[wall - dur, wall]`` interval is goodput
    minus the blocked shares), **generation boundaries** (the gap is
    recovery/respawn time), and ``run.start``. Every other event —
    per-request lifecycle breadcrumbs nested inside a serve step,
    async checkpoint commits pipelined BEHIND training (deliberately
    not badput: that pipelining is the point of the tiered
    checkpointer), dispatch retries — contributes metadata only, so
    nested spans can never eat their enclosing step's interval. Every
    step attribution is clipped to ``[cursor, wall]``, so overlapping
    or lying durations cannot double-count: the identity is exact by
    construction.
    """
    out = _empty()
    bad = out["badput_s"]
    cursor = None          # wall time classified so far
    cur_gen = 0
    in_startup = True      # from (re)start until the first step
    first_wall = last_wall = None
    serve_s = 0.0          # serve.step seconds (split by replay below)
    fresh_tokens = 0
    replayed_tokens = 0
    rerouted_tokens = 0    # tokens served under a router re-route

    for ev in events:
        wall = ev.get("wall")
        if not isinstance(wall, (int, float)):
            continue
        name = ev.get("ev")
        dur = ev.get("dur_s")
        dur = float(dur) if isinstance(dur, (int, float)) and dur > 0 \
            else 0.0
        if cursor is None:
            # open the observed span at the first event's START (a span
            # event's duration precedes its completion wall), so a file
            # that begins mid-run still prices its first step
            first_wall = cursor = wall - dur
        wall = max(wall, cursor)        # clamp: never travel backwards
        last_wall = max(last_wall or wall, wall)
        gen = ev.get("gen", 0)
        if isinstance(gen, int) and gen != cur_gen:
            # generation boundary inside one appended file: the gap
            # from the old incarnation's last step to the new
            # incarnation's first event is death -> respawn -> rejoin —
            # priced ``recovery`` for a failure reform and
            # ``scale_transition`` for a generation the autoscaler
            # created deliberately (same interval, different bucket:
            # the identity is untouched, the attribution is honest)
            bad["scale_transition" if gen in scale_generations
                else "recovery"] += wall - cursor
            cursor = wall
            cur_gen = gen
            in_startup = True
        if name in _STEP_EVENTS:
            start = max(cursor, wall - dur)
            bad["startup" if in_startup else "idle"] += start - cursor
            in_startup = False
            span = wall - start
            if name == "train.step":
                infeed = ev.get("infeed_wait_s")
                infeed = min(float(infeed), span) if isinstance(
                    infeed, (int, float)) and infeed > 0 else 0.0
                ckpt = ev.get("ckpt_block_s")
                ckpt = min(float(ckpt), span - infeed) if isinstance(
                    ckpt, (int, float)) and ckpt > 0 else 0.0
                bad["infeed_wait"] += infeed
                bad["ckpt_block"] += ckpt
                out["goodput_s"] += span - infeed - ckpt
            else:                        # serve.step
                serve_s += span
            cursor = wall
        elif name == "kv.migrate":
            # KV handoff (export or adopt) is honest badput: the chip
            # moved cache rows instead of computing tokens. The event
            # also ADVANCES the cursor, so a migration nested inside a
            # serve.step span is clipped out of that step's serve share
            # by the standard overlap rule — never double-counted.
            start = max(cursor, wall - dur)
            bad["startup" if in_startup else "idle"] += start - cursor
            bad["kv_migrate"] += wall - start
            cursor = wall
        elif name == "serve.swap":
            # a version transition (hot-swap flip + restore share that
            # landed on this worker's wall, or a restart adoption) is
            # ``rollout`` badput; the cursor advance clips it out of
            # any enclosing/overlapping serve.step exactly like
            # kv.migrate — identity intact by the same overlap rule
            start = max(cursor, wall - dur)
            bad["startup" if in_startup else "idle"] += start - cursor
            bad["rollout"] += wall - start
            cursor = wall
        elif name == "serve.request":
            rt = ev.get("replayed_tokens")
            nt = ev.get("new_tokens")
            if isinstance(rt, (int, float)):
                replayed_tokens += int(rt)
                if isinstance(nt, (int, float)):
                    fresh_tokens += max(0, int(nt) - int(rt))
        elif name == "serve.rerouted":
            # the router re-dispatched this request after its first
            # replica died mid-flight: this replica's serve share of it
            # is duplicate/recovery work, priced reroute_replay below
            nt = ev.get("new_tokens")
            if isinstance(nt, (int, float)):
                rerouted_tokens += int(nt)
        elif name == "run.start":
            bad["startup" if in_startup else "idle"] += wall - cursor
            cursor = wall
            in_startup = True

    # the tail after the last step (drain, shutdown, or simply events
    # still being written) closes the partition
    if cursor is not None and last_wall > cursor:
        bad["startup" if in_startup else "idle"] += last_wall - cursor

    # serving: the replayed share of decode/prefill work re-generated
    # tokens a preemption (or replica death) already produced once —
    # badput, not goodput. Tokens served under a router RE-ROUTE are
    # priced separately (``reroute_replay``): the whole re-served
    # request is conservatively treated as recovery work (an upper
    # bound — the dead replica may not have finished it), so the
    # measured re-route cost can never be understated.
    total_tokens = fresh_tokens + replayed_tokens
    replay_frac = (replayed_tokens / total_tokens) if total_tokens else 0.0
    reroute_frac = (min(rerouted_tokens, fresh_tokens) / total_tokens) \
        if total_tokens else 0.0
    bad["preempt_replay"] += serve_s * replay_frac
    bad["reroute_replay"] += serve_s * reroute_frac
    out["goodput_s"] += serve_s * (1.0 - replay_frac - reroute_frac)
    out["replayed_tokens"] = replayed_tokens
    out["rerouted_tokens"] = rerouted_tokens

    if first_wall is not None:
        out["wall_s"] = last_wall - first_wall
    return out


def ledger_from_events(events_by_pid: "dict") -> dict:
    """Fleet goodput/badput ledger from per-process event lists
    (:func:`telemetry.read_run` output).

    Only numeric pids count as hardware (the supervisor watches, it
    does not burn accelerator time). Returns::

        {"wall_s": hw_seconds, "goodput_s": s, "goodput_frac": f,
         "badput_s": {bucket: s}, "identity_error_s": ~0.0,
         "per_worker": {pid: {...}}}

    ``identity_error_s`` is recomputed from the summed parts (not
    assumed): ``wall - (goodput + Σ badput)``. It is ~0 by construction
    and asserted ≤1% of wall by the chaos-sweep gate.
    """
    # generations the autoscaler created on purpose (``scale.applied``
    # is emitted by the supervisor whose log shares this run dir): their
    # reform gaps price into ``scale_transition``, failure reforms into
    # ``recovery``. Scanned across EVERY pid — the supervisor's own
    # (non-numeric) log is where the markers live.
    scale_gens = frozenset(
        ev.get("generation") for events in events_by_pid.values()
        for ev in events
        if ev.get("ev") == "scale.applied"
        and isinstance(ev.get("generation"), int))
    per_worker: dict = {}
    total = _empty()
    for pid, events in sorted(events_by_pid.items(),
                              key=lambda kv: str(kv[0])):
        if not isinstance(pid, int):
            continue
        lw = _worker_ledger(events, scale_gens)
        per_worker[pid] = lw
        total["wall_s"] += lw["wall_s"]
        total["goodput_s"] += lw["goodput_s"]
        for b in BADPUT_BUCKETS:
            total["badput_s"][b] += lw["badput_s"][b]
    wall = total["wall_s"]
    attributed = total["goodput_s"] + sum(total["badput_s"].values())
    total["goodput_frac"] = (total["goodput_s"] / wall) if wall > 0 \
        else None
    total["identity_error_s"] = wall - attributed
    total["per_worker"] = per_worker
    return total


def ledger_from_run(run_dir: str) -> dict:
    """:func:`ledger_from_events` over a telemetry run directory
    (a torn final line is dropped — safe against files still being
    written)."""
    from distributed_tensorflow_tpu_torch.telemetry import events as _events
    return ledger_from_events(_events.read_run(run_dir))


def prometheus_lines(ledger: dict, *, prefix: str = "dtx_") -> list:
    """Render a ledger as Prometheus exposition lines (the recovery
    supervisor's export tick appends these to its scrape)."""
    lines = [f"# TYPE {prefix}goodput_seconds gauge",
             f'{prefix}goodput_seconds {ledger["goodput_s"]:.6f}',
             f"# TYPE {prefix}wall_seconds gauge",
             f'{prefix}wall_seconds {ledger["wall_s"]:.6f}',
             f"# TYPE {prefix}badput_seconds gauge"]
    for b in BADPUT_BUCKETS:
        lines.append(f'{prefix}badput_seconds{{bucket="{b}"}} '
                     f'{ledger["badput_s"][b]:.6f}')
    frac = ledger.get("goodput_frac")
    if frac is not None:
        lines += [f"# TYPE {prefix}goodput_frac gauge",
                  f"{prefix}goodput_frac {frac:.6f}"]
    return lines


# ---------------------------------------------------------------------------
# In-process live ledger
# ---------------------------------------------------------------------------

class GoodputLedger:
    """Live per-process ledger a step loop feeds.

    ::

        ledger = GoodputLedger()          # registers goodput/* gauges
        goodput.activate(ledger)
        ...
        ledger.step_completed(dur_s, infeed_s=w, ckpt_s=c)   # trainer
        ledger.serve_step(dur_s); ledger.tokens(fresh, replayed)

    Attribution is clamped so the total never exceeds elapsed wall;
    :meth:`snapshot` returns the identity-exact breakdown with ``idle``
    as the residual. The snapshot is exported through a registry
    collector (``goodput/<field>`` gauges) so fleet rollups and the
    Prometheus exporter carry it with zero extra wiring.

    ``enter(bucket)`` names the bucket the CURRENT gap is accruing to —
    the stall detector stamps it on ``stall.suspected`` so a stall names
    both the blocked lane and the badput class it is becoming.
    """

    def __init__(self, reg=None, clock=time.monotonic, register=True):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._named = {b: 0.0 for b in BADPUT_BUCKETS if b != "idle"}
        self._good_train = 0.0
        self._serve_s = 0.0
        self._fresh = 0
        self._replayed = 0
        self._rerouted = 0
        self._attributed = 0.0
        self._bucket = "startup"       # current accruing bucket
        self._reg = reg or _registry.get_registry()
        if register:
            self._reg.register_collector("goodput", self._collect)

    # -- feeding -----------------------------------------------------------
    def _claim(self, seconds: float) -> float:
        """Clamp an attribution to the wall not yet attributed."""
        avail = (self._clock() - self._t0) - self._attributed
        add = max(0.0, min(float(seconds), avail))
        self._attributed += add
        return add

    def step_completed(self, dur_s: float, *, infeed_s: float = 0.0,
                       ckpt_s: float = 0.0):
        """One training step: ``dur_s`` minus the blocked shares is
        goodput; the first step also retires the ``startup`` bucket
        (everything before it was startup/compile)."""
        with self._lock:
            self._retire_startup(reserve=dur_s)
            span = self._claim(dur_s)
            infeed = min(max(0.0, infeed_s), span)
            ckpt = min(max(0.0, ckpt_s), span - infeed)
            self._named["infeed_wait"] += infeed
            self._named["ckpt_block"] += ckpt
            self._good_train += span - infeed - ckpt
            self._bucket = "idle"

    def serve_step(self, dur_s: float):
        """One serving engine iteration (split goodput/replay at
        snapshot time by the token ratio from :meth:`tokens`)."""
        with self._lock:
            self._retire_startup(reserve=dur_s)
            self._serve_s += self._claim(dur_s)
            self._bucket = "idle"

    def tokens(self, fresh: int, replayed: int = 0,
               rerouted: int = 0):
        """``rerouted`` marks fresh tokens that re-served a request a
        dead replica already had in flight (router re-route) — their
        serve share prices ``reroute_replay`` at snapshot time."""
        with self._lock:
            self._fresh += max(0, int(fresh))
            self._replayed += max(0, int(replayed))
            self._rerouted += max(0, int(rerouted))

    def record(self, bucket: str, seconds: float):
        """Explicit badput (e.g. the supervisor pricing a recovery)."""
        if bucket not in self._named:
            raise ValueError(f"unknown badput bucket {bucket!r}; "
                             f"expected one of {BADPUT_BUCKETS}")
        with self._lock:
            self._named[bucket] += self._claim(seconds)

    def _retire_startup(self, reserve: float = 0.0):
        """First step of an incarnation: everything before it (minus
        the step itself, ``reserve``) was startup/compile."""
        if self._bucket == "startup":
            avail = ((self._clock() - self._t0) - self._attributed
                     - max(0.0, reserve))
            if avail > 0:
                self._named["startup"] += avail
                self._attributed += avail

    def enter(self, bucket: str):
        """Name the bucket un-attributed time is CURRENTLY accruing to
        (``idle`` default after the first step; ``startup`` before)."""
        if bucket != "idle" and bucket not in self._named:
            raise ValueError(f"unknown badput bucket {bucket!r}")
        self._bucket = bucket

    @property
    def current_bucket(self) -> str:
        return self._bucket

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            wall = self._clock() - self._t0
            total_tok = self._fresh + self._replayed
            rf = (self._replayed / total_tok) if total_tok else 0.0
            xf = (min(self._rerouted, self._fresh) / total_tok) \
                if total_tok else 0.0
            bad = {b: self._named.get(b, 0.0) for b in BADPUT_BUCKETS
                   if b != "idle"}
            bad["preempt_replay"] += self._serve_s * rf
            bad["reroute_replay"] += self._serve_s * xf
            good = self._good_train + self._serve_s * (1.0 - rf - xf)
            bad["idle"] = max(0.0, wall - good
                              - sum(bad.values()))
        return {"wall_s": wall, "goodput_s": good,
                "goodput_frac": (good / wall) if wall > 0 else None,
                "badput_s": bad}

    def _collect(self) -> dict:
        snap = self.snapshot()
        out = {"wall_s": round(snap["wall_s"], 6),
               "goodput_s": round(snap["goodput_s"], 6)}
        if snap["goodput_frac"] is not None:
            out["goodput_frac"] = round(snap["goodput_frac"], 6)
        for b, v in snap["badput_s"].items():
            out[f"badput/{b}_s"] = round(v, 6)
        return out

    def close(self):
        self._reg.unregister_collector("goodput")


# ---------------------------------------------------------------------------
# Process-wide active ledger (the events._LOG activation pattern)
# ---------------------------------------------------------------------------

_ACTIVE: "GoodputLedger | None" = None


def activate(ledger: "GoodputLedger | None") -> "GoodputLedger | None":
    """Install (or, with None, clear) the process-wide live ledger that
    StepTelemetry / the serving engine / the stall detector feed and
    read. Returns the previous ledger."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ledger
    return prev


def active_ledger() -> "GoodputLedger | None":
    return _ACTIVE


def accruing_bucket() -> str:
    """The badput bucket un-attributed time is accruing to right now —
    ``idle`` when no live ledger is active (unattributed is the honest
    default)."""
    led = _ACTIVE
    return led.current_bucket if led is not None else "idle"

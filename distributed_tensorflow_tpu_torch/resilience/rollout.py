"""SLO-gated canary rollout with auto-rollback.

The port's copy of ``distributed_tensorflow_tpu/resilience/rollout.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The last leg of the live-rollout loop (README "Live rollout"): the
engine can hot-swap weights in place (serving/engine.py
``load_version``) and every completion record carries its
``model_version`` — this module decides *when* each replica moves.

:class:`RolloutController` is a pure policy state machine in the mold
of :class:`~distributed_tensorflow_tpu_torch.resilience.autoscaler.
Autoscaler` (injectable clock, no side effects in :meth:`decide`,
ticked from the supervisor watch loop via the same ``autoscaler=``
hook). It ramps a static traffic split replica-by-replica:

- the FIRST replica moves to the target version immediately — that is
  the canary;
- every subsequent move is gated: the canary's per-version SLO burn
  (telemetry/slo.burn_windows over records filtered by
  ``model_version``) must stay clear for ``clear_hold_s`` with at
  least ``min_evidence`` completions in the short window — no
  evidence is no promotion (a canary serving nothing proves nothing);
- the canary firing while the BASELINE version is *not* firing, for
  ``fire_consecutive`` consecutive ticks, is the version's fault →
  **rollback**: every replica is reassigned to the base version
  (replicas pin-restore it — ``InferenceEngine.load_version(base)``
  via ``restore_latest(at_step=)``). Both versions burning together
  reads as an infrastructure problem, not the candidate's — the
  controller holds.

The actuation surface is deliberately dumb: an atomically-rewritten
JSON assignment file (replica name → snapshot step) that serving
replicas poll between steps, so the controller works unchanged across
process boundaries and survives replica restarts (a respawned replica
reads the file and adopts the current assignment — the restart-
adoption path tests/test_rollout.py covers). Decisions are
``rollout.decision`` events; the target version's availability is one
``rollout.publish`` event, which telemetry/slo.py's servable-freshness
accounting closes per replica at that replica's ``serve.swap`` —
freshness ends when the weights *serve*, not when the file lands.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo


def _default_slo() -> tv_slo.SLO:
    # short-run burn windows (8s/2s @ 2x), same scale as the
    # autoscaler's: canary verdicts in a tens-of-seconds harness run;
    # production passes its own SLO with the SRE presets
    return tv_slo.SLO("rollout_p99_latency", "latency", objective=0.99,
                      threshold_s=0.5, windows=((8.0, 2.0, 2.0),))


def version_step(version) -> "int | None":
    """Snapshot step out of a ``model_version`` string
    (``"<step>@<digest>"``); None for anything unparseable."""
    if not isinstance(version, str):
        return None
    head = version.split("@", 1)[0]
    try:
        return int(head)
    except ValueError:
        return None


def read_assignment(path: str) -> "dict | None":
    """The replica side: current assignment file, or None while the
    controller hasn't written one yet (serve the base version)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@dataclasses.dataclass(frozen=True)
class RolloutPolicy:
    """The canary's knobs (the README "Live rollout" table).

    ``slo`` supplies the burn thresholds applied PER VERSION;
    ``fire_consecutive`` debounces rollback, ``clear_hold_s`` +
    ``clear_burn`` gate each advance, ``min_evidence`` is the
    low-traffic rule (burn over fewer completions than this is
    neither an alarm nor an all-clear), ``cooldown_s`` paces actions
    so a fresh swap's warmup can't trip the next verdict."""

    fire_consecutive: int = 2
    clear_hold_s: float = 3.0
    clear_burn: float = 1.0
    cooldown_s: float = 2.0
    interval_s: float = 0.25
    min_evidence: int = 3
    slo: tv_slo.SLO = dataclasses.field(default_factory=_default_slo)


@dataclasses.dataclass(frozen=True)
class RolloutDecision:
    """One verdict (also the payload of ``rollout.decision``)."""

    action: str                  # "advance" | "promote" | "rollback"
    replica: "str | None"        # the replica moved (advance only)
    step: int                    # the step the action assigns
    reason: str
    wall: float
    canary_burn_short: "float | None" = None
    canary_burn_long: "float | None" = None
    base_burn_short: "float | None" = None
    evidence: int = 0

    def to_fields(self) -> dict:
        f = {"action": self.action, "replica": self.replica,
             "step": self.step, "reason": self.reason,
             "evidence": self.evidence}
        for k in ("canary_burn_short", "canary_burn_long",
                  "base_burn_short"):
            v = getattr(self, k)
            f[k] = round(v, 4) if v is not None else None
        return f


class RolloutController:
    """Replica-by-replica ramp from ``base_step`` to ``target_step``
    with SLO-gated advances and burn-triggered rollback (module
    docstring has the rules).

    Pure core: :meth:`decide` takes ``(now, records)`` and mutates
    only controller state — fully unit-testable with a fake clock and
    synthetic records. :meth:`tick` is the supervisor adapter
    (``RecoverySupervisor(autoscaler=ctrl)``): it pulls live records,
    runs one decision, rewrites the assignment file atomically and
    emits the events."""

    def __init__(self, replicas, *, base_step: int, target_step: int,
                 policy: "RolloutPolicy | None" = None,
                 records_fn=None, clock=time.time,
                 assignment_path: "str | None" = None,
                 published_wall: "float | None" = None):
        if not replicas:
            raise ValueError("rollout needs at least one replica")
        self.replicas = [str(r) for r in replicas]
        self.base_step = int(base_step)
        self.target_step = int(target_step)
        self.policy = policy or RolloutPolicy()
        self.published_wall = published_wall
        self._records_fn = records_fn
        self._clock = clock
        self.assignment_path = assignment_path
        #: replica -> snapshot step it should serve
        self.assignment = {r: self.base_step for r in self.replicas}
        #: "baseline" -> "ramping" -> "promoted" | "rolled_back"
        self.state = "baseline"
        self.moved: "list[str]" = []
        self.decisions: "list[RolloutDecision]" = []
        self.last_eval: "dict | None" = None
        self._last_decide: "float | None" = None
        self._fire_streak = 0
        self._clear_since: "float | None" = None
        self._cooldown_until: "float | None" = None
        self._published = False
        self._seq = 0

    # -- pure policy -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.state in ("promoted", "rolled_back")

    def _records_for(self, records, step: int) -> list:
        return [r for r in records
                if version_step(r.get("model_version")) == step]

    def _evidence(self, records, window, now: float) -> int:
        lo = now - window["short_s"]
        return sum(1 for r in records
                   if isinstance(r.get("wall"), (int, float))
                   and lo < r["wall"] <= now)

    def _acted(self, d: RolloutDecision, now: float):
        self.decisions.append(d)
        self._fire_streak = 0
        self._clear_since = None
        self._cooldown_until = now + self.policy.cooldown_s

    def decide(self, *, now: "float | None" = None,
               records: "list | None" = None) -> "RolloutDecision | None":
        """One policy tick; None when nothing should change."""
        p = self.policy
        now = now if now is not None else self._clock()
        if self.done:
            return None
        if (self._last_decide is not None
                and now - self._last_decide < p.interval_s):
            return None
        self._last_decide = now
        if records is None:
            records = self._records_fn() if self._records_fn else []
        if self.state == "baseline":
            # the canary itself moves ungated — there is no evidence
            # about a version nothing serves — but only once the fleet
            # IS serving: before the first completions land, a "canary"
            # would just be a replica adopting the target at startup,
            # proving nothing about a live swap
            if len(records) < self.policy.min_evidence:
                return None
            rep = self.replicas[0]
            self.assignment[rep] = self.target_step
            self.moved.append(rep)
            self.state = "ramping"
            d = RolloutDecision("advance", rep, self.target_step,
                                "canary_start", now)
            self._acted(d, now)
            return d
        canary = self._records_for(records, self.target_step)
        base = self._records_for(records, self.base_step)
        cw = tv_slo.burn_windows(canary, p.slo, now=now)
        bw = tv_slo.burn_windows(base, p.slo, now=now)
        ev = max((self._evidence(canary, w, now) for w in cw), default=0)
        canary_firing = any(
            w["firing"] and self._evidence(canary, w, now) >= p.min_evidence
            for w in cw)
        base_firing = any(
            w["firing"] and self._evidence(base, w, now) >= p.min_evidence
            for w in bw)
        cbl = cw[0]["burn_long"] if cw else None
        cbs = cw[0]["burn_short"] if cw else None
        bbs = bw[0]["burn_short"] if bw else None
        self.last_eval = {"wall": now, "canary_burn_long": cbl,
                          "canary_burn_short": cbs,
                          "base_burn_short": bbs, "evidence": ev,
                          "canary_firing": canary_firing,
                          "base_firing": base_firing}
        if canary_firing and not base_firing:
            # the candidate's fault: baseline traffic is healthy under
            # the same SLO at the same instant
            self._fire_streak += 1
            self._clear_since = None
        elif canary_firing:
            # both versions burning: infrastructure, not the version —
            # hold (neither rollback progress nor promotion credit)
            self._clear_since = None
        else:
            self._fire_streak = 0
            clear = ev >= p.min_evidence and all(
                (w["burn_short"] is None or w["burn_short"] < p.clear_burn)
                and (w["burn_long"] is None or w["burn_long"] < p.clear_burn)
                for w in cw)
            if clear:
                if self._clear_since is None:
                    self._clear_since = now
            else:
                self._clear_since = None
        if self._cooldown_until is not None and now < self._cooldown_until:
            return None
        if self._fire_streak >= p.fire_consecutive:
            self.assignment = {r: self.base_step for r in self.replicas}
            self.state = "rolled_back"
            d = RolloutDecision("rollback", None, self.base_step,
                                "slo_burn", now, cbs, cbl, bbs, ev)
            self._acted(d, now)
            return d
        if (self._clear_since is not None
                and now - self._clear_since >= p.clear_hold_s):
            remaining = [r for r in self.replicas if r not in self.moved]
            if remaining:
                rep = remaining[0]
                self.assignment[rep] = self.target_step
                self.moved.append(rep)
                d = RolloutDecision("advance", rep, self.target_step,
                                    "burn_clear", now, cbs, cbl, bbs, ev)
            else:
                # every replica already serves the target and the burn
                # held clear once more: the rollout is complete
                self.state = "promoted"
                d = RolloutDecision("promote", None, self.target_step,
                                    "burn_clear", now, cbs, cbl, bbs, ev)
            self._acted(d, now)
            return d
        return None

    # -- actuation ---------------------------------------------------------
    def write_assignment(self, path: "str | None" = None):
        """Atomically rewrite the assignment file replicas poll."""
        path = path or self.assignment_path
        if path is None:
            return
        self._seq += 1
        data = {"assignment": dict(self.assignment),
                "base_step": self.base_step,
                "target_step": self.target_step,
                "published_wall": self.published_wall,
                "state": self.state, "seq": self._seq}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def tick(self, sup=None):
        """One supervisor watch tick (the ``autoscaler=`` hook): emit
        the one-time publish, run the policy, actuate + record any
        decision."""
        now = self._clock()
        if not self._published:
            self._published = True
            if self.published_wall is None:
                self.published_wall = now
            fresh = max(0.0, now - self.published_wall)
            fields = dict(step=self.target_step,
                          base_step=self.base_step,
                          freshness_s=round(fresh, 6))
            if sup is not None and hasattr(sup, "_event"):
                sup._event("rollout.publish", **fields)
            else:
                telemetry.event("rollout.publish", **fields)
            self.write_assignment()
        d = self.decide(now=now)
        if d is None:
            return
        self.write_assignment()
        fields = dict(state=self.state,
                      moved=len(self.moved), total=len(self.replicas),
                      **d.to_fields())
        if sup is not None and hasattr(sup, "_event"):
            sup._event("rollout.decision", **fields)
        else:
            telemetry.event("rollout.decision", **fields)

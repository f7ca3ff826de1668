"""SLO-driven autoscaling and goodput-aware capacity arbitration.

The port's copy of ``distributed_tensorflow_tpu/resilience/autoscaler.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The closed loop: the SLO module made the fleet *measurable*
(multi-window SLO burn rates, the goodput/badput ledger) — this module
makes it *act*. Three layers, bottom up:

- :class:`Autoscaler` — the pure policy engine. Every tick it turns the
  live ``serve.request`` completion stream into burn rates
  (telemetry/slo.burn_windows) and emits a :class:`ScaleDecision`:
  **up** when both burn windows fire ``fire_consecutive`` ticks in a
  row, **down** when every window has stayed under ``clear_burn`` for
  ``clear_hold_s`` (the hysteresis), never more often than
  ``cooldown_s``. No side effects — fully unit-testable with a fake
  clock.
- :class:`CapacityArbiter` — arbitration over a FIXED worker budget
  shared by one training job and one serving job. Ticked from the
  serving supervisor's watch loop (``RecoverySupervisor(autoscaler=)``),
  it actuates decisions as a small state machine: a scale-up first asks
  the *training* supervisor to donate a worker
  (``request_scale(n-1, reason="donate_to_serving")`` — the
  topology-elastic shrink path, so the trainer resumes N-1-sharded from
  warm tiers, no cold restart), waits for the donation to land, then
  grows serving; a scale-down drains the serving replica
  (drain-before-stop: zero dropped requests) and hands the capacity
  back (``reason="reclaim"``). Decisions and outcomes are
  ``scale.decision`` events; applied reforms are ``scale.applied``;
  the live split is exported as ``fleet/capacity/*`` gauges.
- :class:`SharedFleetSupervisor` — the runnable composition: two
  :class:`~distributed_tensorflow_tpu_torch.resilience.supervisor.
  RecoverySupervisor` instances over disjoint telemetry subdirs
  (``<dir>/train`` + ``<dir>/serve``, each a self-contained run dir),
  the arbiter wired as the serving supervisor's autoscaler, and a root
  metrics exporter whose scrape carries both jobs' goodput ledgers and
  the capacity gauges. Every transition is priced: scale generations'
  reform gaps land in the ``scale_transition`` badput bucket
  (telemetry/goodput.py), so ``wall == goodput + Σ badput`` holds
  through the whole maneuver and the decision's cost is auditable.

On the card, ``chip_smoke.py``'s ``autoscale4`` phase drives a seeded
traffic spike through supervised replicas under the SLO-burn engine
and gates zero dropped requests across the scale reforms.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time

from distributed_tensorflow_tpu_torch.resilience.supervisor import (
    RecoverySupervisor,
)
from distributed_tensorflow_tpu_torch.telemetry import events as tv_events
from distributed_tensorflow_tpu_torch.telemetry import registry as tv_registry
from distributed_tensorflow_tpu_torch.telemetry import slo as tv_slo


def _default_slo() -> tv_slo.SLO:
    # short-run burn windows (8s/2s @ 2x): bench/chaos runs last tens
    # of seconds, not 30 days; production deployments pass their own
    # SLO with the SRE presets (slo.DEFAULT_BURN_WINDOWS)
    return tv_slo.SLO("p99_latency", "latency", objective=0.99,
                      threshold_s=0.5, windows=((8.0, 2.0, 2.0),))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The closed loop's knobs (the README "Autoscaling" table).

    ``slo`` supplies the burn thresholds (its window triples are the
    ``(long_s, short_s, max_burn)`` pairs that must BOTH fire);
    ``fire_consecutive`` debounces scale-ups, ``clear_hold_s`` +
    ``clear_burn`` are the scale-down hysteresis, ``cooldown_s`` paces
    actions, ``min/max_replicas`` bound serving and ``train_floor``
    bounds how far training can be drained."""

    min_replicas: int = 1
    max_replicas: int = 8
    train_floor: int = 1
    fire_consecutive: int = 2
    clear_burn: float = 1.0
    clear_hold_s: float = 5.0
    cooldown_s: float = 8.0
    scale_step: int = 1
    interval_s: float = 0.5
    #: minimum completions inside the SHORT window for a burn reading
    #: to count as firing — with two data points, one contention blip
    #: reads as burn 50x; no evidence is no alarm (the SRE
    #: low-traffic rule), and sizing this just under the spike's
    #: completion rate makes startup jitter physically unable to fire
    min_evidence: int = 3
    slo: tv_slo.SLO = dataclasses.field(default_factory=_default_slo)


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One policy verdict (also the payload of ``scale.decision``)."""

    direction: str                       # "up" | "down"
    target: int
    reason: str                          # "slo_burn" | "burn_clear"
    wall: float
    burn_long: "float | None" = None
    burn_short: "float | None" = None
    firing: bool = False
    #: decision provenance (multi-tenant serving): the tenant whose
    #: per-tenant burn fired — None for fleet-level verdicts or
    #: single-tenant deployments
    tenant: "str | None" = None

    def to_fields(self) -> dict:
        return {"direction": self.direction, "target": self.target,
                "reason": self.reason,
                "burn_long": (round(self.burn_long, 4)
                              if self.burn_long is not None else None),
                "burn_short": (round(self.burn_short, 4)
                               if self.burn_short is not None else None),
                "firing": self.firing, "tenant": self.tenant}


def serving_records_fn(run_dir: str):
    """Live completion-record feed from a telemetry run directory: the
    replicas' event files are line-buffered and the reader tolerates
    torn tails, so this is safe to poll mid-run every tick."""
    def _read() -> list:
        try:
            return tv_slo.records_from_events(tv_events.read_run(run_dir))
        except Exception:                # noqa: BLE001 — mid-write race
            return []
    return _read


class Autoscaler:
    """The pure policy engine: burn windows in, :class:`ScaleDecision`
    out. Stateful only in the ways the policy needs (fire streak,
    clear timer, cooldown); all clocks injectable."""

    def __init__(self, policy: "AutoscalePolicy | None" = None, *,
                 records_fn=None, tenants=None, clock=time.time):
        self.policy = policy or AutoscalePolicy()
        self._records_fn = records_fn
        #: TenantConfig set (serving/tenancy.py): when given, each
        #: decision also evaluates PER-TENANT burn (each tenant's own
        #: threshold/objective over the policy's windows) and names the
        #: worst-burning firing tenant — decision provenance for the
        #: multi-tenant router
        self._tenants = tuple(tenants) if tenants else ()
        self._clock = clock
        self._last_decide: "float | None" = None
        self._fire_streak = 0
        self._clear_since: "float | None" = None
        self._cooldown_until: "float | None" = None
        #: last evaluation (burns, firing, record count) — the live
        #: surface capacity gauges and health lines render
        self.last_eval: "dict | None" = None

    def action_applied(self, now: "float | None" = None):
        """Note an applied scale action: starts the cooldown and resets
        the debounce/hysteresis timers (the world just changed — old
        evidence is stale)."""
        now = now if now is not None else self._clock()
        self._cooldown_until = now + self.policy.cooldown_s
        self._fire_streak = 0
        self._clear_since = None

    def decide(self, n_replicas: int, *, records: "list | None" = None,
               now: "float | None" = None) -> "ScaleDecision | None":
        """One policy tick. Throttled to ``interval_s``; returns None
        when nothing should change."""
        p = self.policy
        now = now if now is not None else self._clock()
        if (self._last_decide is not None
                and now - self._last_decide < p.interval_s):
            return None
        self._last_decide = now
        if records is None:
            records = self._records_fn() if self._records_fn else []
        windows = tv_slo.burn_windows(records, p.slo, now=now)

        def _evidence(w) -> int:
            lo = now - w["short_s"]
            return sum(1 for r in records
                       if isinstance(r.get("wall"), (int, float))
                       and lo < r["wall"] <= now)

        firing = any(w["firing"] and _evidence(w) >= p.min_evidence
                     for w in windows)
        bl = windows[0]["burn_long"] if windows else None
        bs = windows[0]["burn_short"] if windows else None
        tenant, tenant_evals = self._tenant_burns(records, now)
        self.last_eval = {"wall": now, "burn_long": bl, "burn_short": bs,
                          "firing": firing, "records": len(records),
                          "tenant": tenant, "tenants": tenant_evals}
        if firing:
            self._fire_streak += 1
            self._clear_since = None
        else:
            self._fire_streak = 0
            # "clear" = every window's burns under clear_burn; a window
            # with NO traffic is clear too (idle capacity must flow
            # back — that is the whole point of the reclaim path)
            clear = all(
                (w["burn_short"] is None
                 or w["burn_short"] < p.clear_burn)
                and (w["burn_long"] is None
                     or w["burn_long"] < p.clear_burn)
                for w in windows)
            if clear:
                if self._clear_since is None:
                    self._clear_since = now
            else:
                self._clear_since = None
        if self._cooldown_until is not None and now < self._cooldown_until:
            return None
        if (self._fire_streak >= p.fire_consecutive
                and n_replicas < p.max_replicas):
            return ScaleDecision(
                "up", min(p.max_replicas, n_replicas + p.scale_step),
                "slo_burn", now, bl, bs, firing, tenant=tenant)
        if (self._clear_since is not None
                and now - self._clear_since >= p.clear_hold_s
                and n_replicas > p.min_replicas):
            return ScaleDecision(
                "down", max(p.min_replicas, n_replicas - p.scale_step),
                "burn_clear", now, bl, bs, firing)
        return None

    def _tenant_burns(self, records: list, now: float):
        """Per-tenant burn attribution: each tenant's records evaluated
        against ITS OWN threshold/objective over the policy's windows.
        Returns ``(worst_firing_tenant_or_None, {name: eval})``."""
        if not self._tenants:
            return None, None
        p = self.policy
        by_t: dict = {}
        for r in records:
            t = r.get("tenant")
            if t:
                by_t.setdefault(t, []).append(r)
        evals: dict = {}
        worst = None
        for cfg in self._tenants:
            recs = by_t.get(cfg.name)
            if not recs:
                continue
            t_slo = tv_slo.SLO(f"{cfg.name}/p99_latency", "latency",
                               objective=cfg.slo_objective,
                               threshold_s=cfg.slo_latency_s,
                               windows=p.slo.windows)
            wins = tv_slo.burn_windows(recs, t_slo, now=now)

            def _ev(w, recs=recs) -> int:
                lo = now - w["short_s"]
                return sum(1 for r in recs
                           if isinstance(r.get("wall"), (int, float))
                           and lo < r["wall"] <= now)

            t_firing = any(w["firing"] and _ev(w) >= p.min_evidence
                           for w in wins)
            t_bs = wins[0]["burn_short"] if wins else None
            evals[cfg.name] = {
                "burn_short": (round(t_bs, 4) if t_bs is not None
                               else None),
                "firing": t_firing, "records": len(recs),
                "share": round(len(recs) / len(records), 4)
                if records else None}
            if t_firing and t_bs is not None and (
                    worst is None
                    or t_bs > evals[worst]["burn_short"]):
                worst = cfg.name
        return worst, evals


class CapacityArbiter:
    """Fixed-budget arbitration between one training job and one
    serving job, actuated through their recovery supervisors.

    Wire it as the SERVING supervisor's ``autoscaler=`` — every watch
    tick calls :meth:`tick`, which runs the policy engine and drives a
    small state machine:

    ======================  =============================================
    ``idle``                ask the engine; on **up**: grow directly if
                            the budget has slack (training finished /
                            never started), else ask training to donate
                            (``awaiting_donation``); on **down**: shrink
                            serving (``applying_down``)
    ``awaiting_donation``   training shrink landed → grow serving
                            (``applying_up``)
    ``applying_up/down``    serving reform landed and every replica of
                            it has heartbeated (the port waits for that;
                            JAX's arbiter does not) → (down only) hand
                            the freed capacity back to training
                            (``reason="reclaim"``), start the cooldown
    ======================  =============================================

    A state stuck longer than ``state_timeout_s`` (e.g. training wedged
    in its own recovery) reverts to ``idle`` with a ``scale.decision``
    outcome ``timeout`` — the loop re-evaluates rather than deadlocks.
    An **up** decision with training already at ``train_floor`` is
    outcome ``blocked`` (and starts a cooldown so it is re-examined,
    not spammed). The live split exports as ``fleet/capacity/*``
    gauges.
    """

    def __init__(self, engine: Autoscaler, *, budget: int,
                 train_sup: "RecoverySupervisor | None" = None,
                 train_floor: "int | None" = None,
                 state_timeout_s: float = 60.0, reg=None):
        self.engine = engine
        self.budget = budget
        self.train_sup = train_sup
        self.train_floor = (train_floor if train_floor is not None
                            else engine.policy.train_floor)
        self.state_timeout_s = state_timeout_s
        #: set by the shared-fleet supervisor when the training job
        #: exits (its workers stop counting against the budget)
        self.train_done = train_sup is None
        self._state = "idle"
        self._state_since: "float | None" = None
        self._pending: "ScaleDecision | None" = None
        self._expect_train: "int | None" = None
        self._train_baseline = (train_sup.num_workers
                                if train_sup is not None else 0)
        self.decisions = 0
        reg = reg or tv_registry.get_registry()
        self._g_budget = reg.gauge("fleet/capacity/budget")
        self._g_train = reg.gauge("fleet/capacity/train_workers")
        self._g_serve = reg.gauge("fleet/capacity/serve_replicas")
        self._g_burn = reg.gauge("fleet/capacity/burn_short")
        self._g_budget.set(budget)
        self._reg = reg
        self._g_tenant: dict = {}

    # -- helpers -----------------------------------------------------------
    def _train_n(self) -> int:
        if self.train_sup is None or self.train_done:
            return 0
        return self.train_sup.num_workers

    def _emit(self, serve_sup, decision: ScaleDecision, outcome: str):
        serve_sup._event("scale.decision", outcome=outcome,
                         state=self._state,
                         train_workers=self._train_n(),
                         serve_replicas=serve_sup.num_workers,
                         budget=self.budget, **decision.to_fields())

    def _enter(self, state: str, now: float):
        self._state = state
        self._state_since = now

    # -- the tick ----------------------------------------------------------
    def tick(self, serve_sup):
        now = self.engine._clock()
        self._g_train.set(self._train_n())
        self._g_serve.set(serve_sup.num_workers)
        ev = self.engine.last_eval
        if ev and ev.get("burn_short") is not None:
            self._g_burn.set(round(ev["burn_short"], 4))
        if ev and ev.get("tenants"):
            # per-tenant capacity view: burn + share of recent
            # completions, exported as fleet/tenant/<name>/* gauges
            for name, te in ev["tenants"].items():
                for field in ("burn_short", "share"):
                    if te.get(field) is None:
                        continue
                    key = f"fleet/tenant/{name}/{field}"
                    g = self._g_tenant.get(key)
                    if g is None:
                        g = self._g_tenant[key] = self._reg.gauge(key)
                    g.set(te[field])
        if self._state != "idle" and self._state_since is not None \
                and now - self._state_since > self.state_timeout_s:
            if self._pending is not None:
                self._emit(serve_sup, self._pending, "timeout")
            self.engine.action_applied(now)
            self._pending = None
            self._enter("idle", now)
        if self._state == "idle":
            d = self.engine.decide(serve_sup.num_workers, now=now)
            if d is None:
                return
            self.decisions += 1
            if d.direction == "up":
                self._begin_up(serve_sup, d, now)
            else:
                self._begin_down(serve_sup, d, now)
        elif self._state == "awaiting_donation":
            if (self.train_done
                    or self.train_sup.num_workers <= self._expect_train):
                serve_sup.request_scale(self._pending.target,
                                        reason="slo_burn")
                self._enter("applying_up", now)
        elif self._state == "applying_up":
            if (serve_sup.num_workers >= self._pending.target
                    and serve_sup.replicas_ready()):
                self.engine.action_applied(now)
                self._emit(serve_sup, self._pending, "applied")
                self._pending = None
                self._enter("idle", now)
        elif self._state == "applying_down":
            if (serve_sup.num_workers <= self._pending.target
                    and serve_sup.replicas_ready()):
                # capacity released: hand it back to training (never
                # past its baseline size or the budget)
                if not self.train_done and self.train_sup is not None:
                    reclaim = min(self._train_baseline,
                                  self.budget - serve_sup.num_workers)
                    if reclaim > self.train_sup.num_workers:
                        self.train_sup.request_scale(reclaim,
                                                     reason="reclaim")
                self.engine.action_applied(now)
                self._emit(serve_sup, self._pending, "applied")
                self._pending = None
                self._enter("idle", now)

    def _begin_up(self, serve_sup, d: ScaleDecision, now: float):
        serve_n = serve_sup.num_workers
        train_n = self._train_n()
        need = d.target - serve_n
        free = self.budget - serve_n - train_n
        if free >= need:
            # budget slack (training finished or was never this big):
            # grow directly, no donation needed
            self._emit(serve_sup, d, "requested")
            serve_sup.request_scale(d.target, reason="slo_burn")
            self._pending = d
            self._enter("applying_up", now)
            return
        donate_to = train_n - (need - free)
        if donate_to >= self.train_floor and self.train_sup is not None:
            self._emit(serve_sup, d, "donate")
            self.train_sup.request_scale(donate_to,
                                         reason="donate_to_serving")
            self._expect_train = donate_to
            self._pending = d
            self._enter("awaiting_donation", now)
            return
        # training is at its floor: the fleet is genuinely out of
        # capacity — record the blocked decision and cool down so the
        # loop re-examines instead of spamming
        self._emit(serve_sup, d, "blocked")
        self.engine.action_applied(now)

    def _begin_down(self, serve_sup, d: ScaleDecision, now: float):
        self._emit(serve_sup, d, "requested")
        serve_sup.request_scale(d.target, reason="burn_clear")
        self._pending = d
        self._enter("applying_down", now)


@dataclasses.dataclass
class FleetRunResult:
    """What one :meth:`SharedFleetSupervisor.run` produced."""

    serve_result: object = None
    train_result: object = None
    train_error: "BaseException | None" = None
    train_stopped: bool = False
    serve_scales: int = 0
    train_scales: int = 0
    final_serve_replicas: int = 0
    final_train_workers: int = 0


class SharedFleetSupervisor:
    """One fixed worker budget, two supervised jobs, one closed loop.

    ``telemetry_dir`` grows two self-contained run dirs —
    ``train/`` and ``serve/`` (each with its own supervisor event log,
    so generation numbering and the goodput ledger stay per-job) — and
    a root ``metrics-live.prom`` carrying both ledgers, the SLO burn
    and the ``fleet/capacity/*`` gauges. ``train_fn``/``serve_fn`` are
    ordinary supervisor worker fns (module-level, restartable); extra
    per-supervisor knobs pass through ``train_sup_kwargs`` /
    ``serve_sup_kwargs`` (the simulated fleet injects thread runners
    here — testing/fleet_sim.py).

    The serving job defines the run's span: when it completes,
    ``stop_training_when_served`` (default) winds the training job down
    via ``request_stop`` — on a real fleet the trainer would simply
    keep running; on this harness the demo must end."""

    def __init__(self, *, budget: int,
                 train_fn, serve_fn,
                 train_workers: int, serve_replicas: int,
                 train_args: tuple = (), train_kwargs: "dict | None" = None,
                 serve_args: tuple = (), serve_kwargs: "dict | None" = None,
                 policy: "AutoscalePolicy | None" = None,
                 telemetry_dir: "str | None" = None,
                 records_fn=None, clock=time.time,
                 stop_training_when_served: bool = True,
                 train_join_timeout_s: float = 120.0,
                 train_sup_kwargs: "dict | None" = None,
                 serve_sup_kwargs: "dict | None" = None):
        if train_workers + serve_replicas > budget:
            raise ValueError(
                f"initial split {train_workers}+{serve_replicas} "
                f"exceeds the budget {budget}")
        self.budget = budget
        self.policy = policy or AutoscalePolicy()
        self.telemetry_dir = telemetry_dir or tempfile.mkdtemp(
            prefix="dtx_fleet_")
        self.train_dir = os.path.join(self.telemetry_dir, "train")
        self.serve_dir = os.path.join(self.telemetry_dir, "serve")
        os.makedirs(self.train_dir, exist_ok=True)
        os.makedirs(self.serve_dir, exist_ok=True)
        self._stop_training_when_served = stop_training_when_served
        self._train_join_timeout_s = train_join_timeout_s
        self.train_sup = RecoverySupervisor(
            train_fn, num_workers=train_workers,
            args=train_args, kwargs=train_kwargs,
            telemetry_dir=self.train_dir,
            min_workers=self.policy.train_floor,
            max_workers=train_workers,
            **(train_sup_kwargs or {}))
        self.engine = Autoscaler(
            self.policy,
            records_fn=records_fn or serving_records_fn(self.serve_dir),
            clock=clock)
        self.arbiter = CapacityArbiter(
            self.engine, budget=budget, train_sup=self.train_sup,
            train_floor=self.policy.train_floor)
        self.serve_sup = RecoverySupervisor(
            serve_fn, num_workers=serve_replicas,
            args=serve_args, kwargs=serve_kwargs,
            telemetry_dir=self.serve_dir,
            min_workers=self.policy.min_replicas,
            max_workers=self.policy.max_replicas,
            autoscaler=self.arbiter,
            drain_on_scale=True,
            # scale-downs hand live KV to the successor generation
            # instead of replaying decode from the prompt — the
            # preempt_replay badput of a shrink drops to ~0
            # (serving/migrate.py; override via serve_sup_kwargs)
            **{"drain_scale_down_mode": "migrate",
               **(serve_sup_kwargs or {})})

    def _health_lines(self) -> "list[str]":
        """Root-exporter extra lines: both jobs' goodput ledgers (the
        scale_transition bucket included) plus the live burn."""
        from distributed_tensorflow_tpu_torch.telemetry import goodput
        lines: "list[str]" = []
        for role, d in (("train", self.train_dir),
                        ("serve", self.serve_dir)):
            try:
                ledger = goodput.ledger_from_run(d)
                if ledger["wall_s"] > 0:
                    lines += goodput.prometheus_lines(
                        ledger, prefix=f"dtx_{role}_")
            except Exception:            # noqa: BLE001 — mid-run races
                pass
        ev = self.engine.last_eval
        if ev:
            for k in ("burn_long", "burn_short"):
                if ev.get(k) is not None:
                    lines.append(f"# TYPE dtx_fleet_slo_{k} gauge")
                    lines.append(f"dtx_fleet_slo_{k} {ev[k]:.6f}")
        return lines

    def run(self) -> FleetRunResult:
        from distributed_tensorflow_tpu_torch.telemetry import exporter
        root_exp = None
        try:
            root_exp = exporter.MetricsExporter(
                dir=self.telemetry_dir, interval_s=1.0,
                extra_fn=self._health_lines, labels={"job": "fleet"})
        except OSError:
            pass
        out = FleetRunResult()
        train_box: dict = {}

        def _train():
            try:
                train_box["result"] = self.train_sup.run()
            except BaseException as e:   # noqa: BLE001
                train_box["error"] = e
            finally:
                self.arbiter.train_done = True

        t = threading.Thread(target=_train, daemon=True,
                             name="fleet-train")
        t.start()
        try:
            out.serve_result = self.serve_sup.run()
        finally:
            if t.is_alive() and self._stop_training_when_served:
                self.train_sup.request_stop()
                out.train_stopped = True
            t.join(self._train_join_timeout_s)
            if root_exp is not None:
                root_exp.stop()
        out.train_result = train_box.get("result")
        out.train_error = train_box.get("error")
        out.serve_scales = self.serve_sup.scales_applied
        out.train_scales = self.train_sup.scales_applied
        out.final_serve_replicas = self.serve_sup.num_workers
        out.final_train_workers = self.train_sup.num_workers
        if out.train_error is not None and not out.train_stopped:
            raise out.train_error
        return out

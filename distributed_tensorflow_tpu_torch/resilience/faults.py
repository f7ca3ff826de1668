"""Deterministic, seed-driven fault injection (the chaos layer) — port
of ``distributed_tensorflow_tpu/resilience/faults.py``.

Production code is instrumented with named **injection sites**::

    faults.fire("serve.step", tag=step_idx)

A site consults the installed :class:`FaultSchedule`; a matching
:class:`FaultRule` makes the site raise (``exc``, default
:class:`FaultInjected`), sleep (``delay``), or hand a
:class:`FaultDecision` back to the caller (``corrupt`` / ``signal``).
With no schedule installed — the default — ``fire`` is one module-global
``None`` check.

The port's instrumented sites:

- ``serve.step`` (``serving/engine.InferenceEngine.step``, tag = the
  step index): it fires before any scheduler or cache state changes,
  so a ``raise`` models a transient serving-step failure that
  ``run_until_idle(retry_faults=True)`` retries without losing or
  double-serving a request;
- ``offload.spill`` (``parallel/offload.ActivationSpillStore.put``,
  once per spilled 1F1B stage input, tag ``c<cycle>``): a ``raise``
  fails the device→host copy; the store retries once, and a double
  failure surfaces as ``OffloadSpillError`` at the backward that needs
  the lost input;
- ``fleet.step`` (``testing/fleet_sim.py``'s simulated-worker step,
  tag = the worker pid; the per-tag hit counter is the worker's step
  number): ``raise`` crashes the worker, ``delay`` stalls it past the
  supervisor's staleness budget, ``signal`` partitions it (KV ops and
  heartbeats suppressed for a window);
- ``data.dispatch`` (``input/data_service.DataServiceDispatcher.tick``,
  tag = the job): a ``raise`` fails one dispatch round; the background
  loop absorbs it and the next tick re-derives the assignment;
- ``data.fetch`` (``input/data_service.DataServiceClient``'s split
  fetch, tag = the split id): a ``raise`` models a transient payload
  read failure that the trainer retries under its decorrelated
  ``RetryPolicy``; a ``delay`` stalls the trainer's fetch;
- ``data.worker_step`` (``input/data_service.DataInputWorker``, once
  per split-processing attempt, tag = the worker id): ``raise``
  crashes the input worker mid-epoch, ``delay`` stalls it past the
  lease budget; either ends in the dispatcher re-issuing the lease and
  an exactly-once epoch.

Determinism: hit counters are kept per ``(site, tag)`` and per site; a
rule with ``tag`` set counts per tag, one without per site.
Probabilistic rules draw from ``random.Random(f"{seed}:{rule index}:
{site}:{tag}")``, a string seed that is stable across processes, and
the same one the JAX package uses: one schedule fires at the same hits
in both packages. Every firing is logged (:func:`events`), counted in
``resilience/faults_fired`` and emitted as a ``fault.fired`` event.

Activation: ``install`` / ``inject``, or the ``DTX_FAULT_SCHEDULE``
environment variable (the JSON schedule, or ``@/path/to/file.json``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import json
import os
import random
import threading
import time

from distributed_tensorflow_tpu_torch import telemetry


class FaultInjected(RuntimeError):
    """Default exception for a ``raise`` fault at a site that did not
    supply its own exception class."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule.

    ``site`` is an ``fnmatch`` pattern over site names (``"coord.*"``).
    Trigger selection (all optional, combined with AND):

    - ``hits``: fire only on these 1-based hit indices;
    - ``every``: fire on every Nth hit;
    - ``probability``: fire with this per-hit probability (seeded,
      deterministic);
    - ``max_fires``: stop firing after this many firings;
    - ``tag``: only fire for this tag value (e.g. one worker id), and
      count hits per tag instead of per site.

    ``action``: ``raise`` | ``delay`` | ``corrupt`` | ``signal``.
    ``delay_s`` applies to ``delay``.
    """

    site: str
    action: str = "raise"
    hits: tuple[int, ...] | None = None
    every: int | None = None
    probability: float | None = None
    max_fires: int | None = None
    delay_s: float = 0.0
    tag: str | None = None

    _ACTIONS = ("raise", "delay", "corrupt", "signal")

    def __post_init__(self):
        if self.action not in self._ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(expected one of {self._ACTIONS})")
        if self.hits is not None:
            object.__setattr__(self, "hits", tuple(int(h) for h in self.hits))
        if self.tag is not None:
            object.__setattr__(self, "tag", str(self.tag))

    def to_dict(self) -> dict:
        out = {"site": self.site, "action": self.action}
        for k in ("hits", "every", "probability", "max_fires", "tag"):
            v = getattr(self, k)
            if v is not None:
                out[k] = list(v) if isinstance(v, tuple) else v
        if self.delay_s:
            out["delay_s"] = self.delay_s
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        d = dict(d)
        if "p" in d:                      # short alias in hand-written JSON
            d["probability"] = d.pop("p")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault rule keys {sorted(unknown)}")
        if "hits" in d and d["hits"] is not None:
            d["hits"] = tuple(d["hits"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered rule list plus the seed all probabilistic draws derive
    from. The first matching rule per hit wins."""

    rules: tuple[FaultRule, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_dict() for r in self.rules]})

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        d = json.loads(text)
        return cls(seed=int(d.get("seed", 0)),
                   rules=tuple(FaultRule.from_dict(r)
                               for r in d.get("rules", ())))


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What a site was told to do (returned for corrupt/signal; raise and
    delay are consumed inside :func:`fire`)."""

    site: str
    tag: str | None
    hit: int
    rule_index: int
    action: str
    delay_s: float = 0.0


class FaultRegistry:
    """Live injection state for one installed schedule: hit counters,
    per-rule fire counts, seeded RNG streams, and the event log."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._lock = threading.Lock()
        self._hits: dict[tuple[str, str | None], int] = {}
        self._fires: dict[int, int] = {}
        self._rngs: dict[tuple[int, str, str | None], random.Random] = {}
        self._events: list[tuple] = []

    def _rng(self, rule_index: int, site: str,
             tag: str | None) -> random.Random:
        key = (rule_index, site, tag)
        rng = self._rngs.get(key)
        if rng is None:
            # str seeds hash via sha512 (stable across processes/runs)
            rng = random.Random(
                f"{self.schedule.seed}:{rule_index}:{site}:{tag}")
            self._rngs[key] = rng
        return rng

    def fire(self, site: str, tag=None, exc=None,
             msg: str | None = None) -> FaultDecision | None:
        tag = None if tag is None else str(tag)
        with self._lock:
            gh = self._hits.get((site, None), 0) + 1
            self._hits[(site, None)] = gh
            th = gh
            if tag is not None:
                th = self._hits.get((site, tag), 0) + 1
                self._hits[(site, tag)] = th
            decision = None
            for idx, rule in enumerate(self.schedule.rules):
                if not fnmatch.fnmatchcase(site, rule.site):
                    continue
                if rule.tag is not None and rule.tag != tag:
                    continue
                h = th if rule.tag is not None else gh
                if rule.max_fires is not None and \
                        self._fires.get(idx, 0) >= rule.max_fires:
                    continue
                if rule.hits is not None and h not in rule.hits:
                    continue
                if rule.every is not None and h % rule.every != 0:
                    continue
                if rule.probability is not None and \
                        self._rng(idx, site, tag).random() >= rule.probability:
                    continue
                self._fires[idx] = self._fires.get(idx, 0) + 1
                decision = FaultDecision(site=site, tag=tag, hit=h,
                                         rule_index=idx, action=rule.action,
                                         delay_s=rule.delay_s)
                self._events.append((site, tag, h, rule.action, idx))
                break
        if decision is None:
            return None
        # Telemetry: every firing is visible in the run's structured
        # event log + fleet metric rollups (chaos runs are exactly the
        # runs an operator later reconstructs from telemetry).
        telemetry.get_registry().counter(
            "resilience/faults_fired",
            "chaos-layer fault firings").increment()
        telemetry.event("fault.fired", site=site, tag=tag,
                        hit=decision.hit, action=decision.action)
        if decision.action == "delay":
            time.sleep(decision.delay_s)
            return decision
        if decision.action == "raise":
            cls = exc or FaultInjected
            raise cls(msg or f"injected fault at {site!r} "
                             f"(hit {decision.hit})")
        return decision                   # corrupt / signal: caller's job

    def events(self) -> list[tuple]:
        """(site, tag, hit, action, rule_index) per firing, in order."""
        with self._lock:
            return list(self._events)


_REGISTRY: FaultRegistry | None = None
_INSTALL_LOCK = threading.Lock()


def active() -> bool:
    """True when a schedule is installed (the chaos layer is live)."""
    return _REGISTRY is not None


def install(schedule: FaultSchedule) -> FaultRegistry:
    """Install ``schedule`` process-wide; returns the live registry."""
    global _REGISTRY
    with _INSTALL_LOCK:
        _REGISTRY = FaultRegistry(schedule)
        return _REGISTRY


def clear():
    """Remove any installed schedule (back to the zero-overhead path)."""
    global _REGISTRY
    with _INSTALL_LOCK:
        _REGISTRY = None


@contextlib.contextmanager
def inject(schedule: FaultSchedule):
    """Scoped installation: ``with faults.inject(schedule) as registry:``.
    Restores whatever was installed before on exit."""
    global _REGISTRY
    with _INSTALL_LOCK:
        prev = _REGISTRY
        registry = FaultRegistry(schedule)
        _REGISTRY = registry
    try:
        yield registry
    finally:
        with _INSTALL_LOCK:
            _REGISTRY = prev


def fire(site: str, *, tag=None, exc=None,
         msg: str | None = None) -> FaultDecision | None:
    """Injection-site entry point. No schedule installed -> ``None``
    immediately (the hot-path guarantee); otherwise consult the registry
    and raise / sleep / return a decision per the matching rule."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.fire(site, tag=tag, exc=exc, msg=msg)


def events() -> list[tuple]:
    """Firing log of the installed registry ([] when none installed)."""
    reg = _REGISTRY
    return reg.events() if reg is not None else []


# Env activation: a schedule in DTX_FAULT_SCHEDULE (JSON, or @/path) is
# live from import — the route by which spawned multi-process children
# inherit the chaos configuration.
_env = os.environ.get("DTX_FAULT_SCHEDULE")
if _env:
    install(FaultSchedule.from_json(_env))
del _env

"""Multi-tenant serving policy: priority classes, quotas, fair shares.

The port's copy of ``distributed_tensorflow_tpu/serving/tenancy.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The policy layer under ``serving/router.py`` — everything here is a
pure, clock-explicit unit (no wall reads, no I/O) so the admission math
is testable by hand and deterministic across router incarnations:

- :class:`TenantConfig` declares one tenant: its **priority class**
  (``interactive`` or ``batch``), its **weight** (relative share under
  contention), its **token-bucket quota** (rate + burst — the per-tenant
  isolation boundary) and its **SLO thresholds** (which ride the
  declarative ``telemetry/slo.py`` burn-window machinery per tenant).
- :class:`TokenBucket` is the quota meter: ``take(cost, now)`` either
  charges or refuses, with refill purely a function of the two
  timestamps.
- :func:`fair_shares` is weighted max-min fairness (progressive
  filling): under a token budget each contending tenant gets its
  weight-proportional share, and a tenant demanding LESS than its share
  donates the surplus back to the still-hungry ones. The router calls
  it twice per admission tick — once for the interactive class, once
  for batch over whatever budget remains — which is exactly the
  "batch sheds first" pressure ordering.
- :class:`TenancyController` composes the two: ``charge`` answers
  quota, ``plan_tick`` answers weighted-fair admission with batch
  subordinated to interactive EXCEPT for batch tenants the caller has
  aged past their starvation deadline (``aged``) — the anti-starvation
  promotion that keeps batch inside its own (longer) SLO.

Rejections and sheds are *observable by cause*: the controller only
returns decisions; the router stamps them onto ``serve.reject`` /
``router.shed`` events with ``tenant`` + ``cause``, which is what
``obs_report``/``health_report`` itemize and the tenant-aware
autoscaler (resilience/autoscaler.py) attributes scale decisions to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

#: The two priority classes, strongest first. Interactive admits ahead
#: of batch whenever the token budget cannot cover both.
PRIORITY_CLASSES = ("interactive", "batch")

#: ``serve.reject`` / shed causes the router stamps.
REJECT_CAUSES = ("quota", "overload", "shed")


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's declarative serving contract."""

    name: str
    #: priority class: ``interactive`` (latency-sensitive, admitted
    #: first) or ``batch`` (throughput work, shed first under pressure)
    pclass: str = "interactive"
    #: relative share under contention WITHIN its class (weighted
    #: max-min — see :func:`fair_shares`)
    weight: float = 1.0
    #: token-bucket refill rate (prompt+generation tokens per second);
    #: ``inf`` = unmetered
    quota_tokens_per_s: float = math.inf
    #: bucket capacity (burst); default 4s of refill
    quota_burst: "float | None" = None
    #: per-tenant p99 latency SLO threshold (seconds)
    slo_latency_s: float = 0.5
    #: availability objective for the latency SLO
    slo_objective: float = 0.99
    #: a queued BATCH request older than this fraction of
    #: ``slo_latency_s`` is promoted into the interactive admission
    #: round — batch defers first, but never starves past its own SLO
    starvation_frac: float = 0.5

    def __post_init__(self):
        if self.pclass not in PRIORITY_CLASSES:
            raise ValueError(f"tenant {self.name}: pclass="
                             f"{self.pclass!r}; expected one of "
                             f"{PRIORITY_CLASSES}")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.quota_burst is None:
            burst = (self.quota_tokens_per_s * 4.0
                     if math.isfinite(self.quota_tokens_per_s)
                     else math.inf)
            object.__setattr__(self, "quota_burst", burst)

    @property
    def starvation_deadline_s(self) -> float:
        return self.slo_latency_s * self.starvation_frac


def default_tenants() -> "tuple[TenantConfig, ...]":
    """The two-tenant shape the examples/benches drive: one
    latency-sensitive interactive tenant, one throughput batch tenant
    with a longer SLO and half the weight."""
    return (
        TenantConfig("acme", pclass="interactive", weight=2.0,
                     slo_latency_s=0.5),
        TenantConfig("batchco", pclass="batch", weight=1.0,
                     slo_latency_s=4.0),
    )


class TokenBucket:
    """Deterministic token-bucket quota meter (explicit clock)."""

    def __init__(self, rate: float, burst: float, *, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        self._stamp = float(now)

    def _refill(self, now: float):
        if now > self._stamp and math.isfinite(self.burst):
            self._level = min(self.burst,
                              self._level + (now - self._stamp)
                              * self.rate)
        self._stamp = max(self._stamp, now)

    def level(self, now: float) -> float:
        self._refill(now)
        return self._level

    def take(self, cost: float, now: float) -> bool:
        """Charge ``cost`` tokens; False (and no charge) if the bucket
        cannot cover it."""
        if not math.isfinite(self.burst):
            return True
        self._refill(now)
        if cost > self._level:
            return False
        self._level -= cost
        return True


def fair_shares(demands: "dict[str, float]",
                weights: "dict[str, float]",
                budget: float) -> "dict[str, float]":
    """Weighted max-min fair allocation (progressive filling).

    Repeatedly splits the remaining budget among still-unsatisfied
    tenants in proportion to their weights; a tenant whose demand fits
    inside its share is granted exactly its demand and its surplus
    returns to the pool. Hand-computable — the unit tests work examples
    by hand — and order-independent (a pure function of the three
    inputs).
    """
    alloc = {t: 0.0 for t in demands}
    remaining = {t: d for t, d in demands.items() if d > 0}
    budget = max(0.0, float(budget))
    while remaining and budget > 1e-12:
        wsum = sum(weights.get(t, 1.0) for t in remaining)
        share = {t: budget * weights.get(t, 1.0) / wsum
                 for t in remaining}
        satisfied = [t for t in remaining if remaining[t] <= share[t]]
        if not satisfied:
            # everyone is budget-bound: grant the proportional share
            for t in remaining:
                alloc[t] += share[t]
            return alloc
        for t in satisfied:
            alloc[t] += remaining[t]
            budget -= remaining[t]
            del remaining[t]
    return alloc


class TenancyController:
    """Quota + weighted-fair admission state for one router.

    All methods take explicit ``now`` timestamps (seconds, any
    monotonic origin) — determinism is what makes the chaos seeds
    replayable and the unit math checkable.
    """

    def __init__(self, tenants: Iterable[TenantConfig], *,
                 now: float = 0.0):
        self.tenants: "dict[str, TenantConfig]" = {}
        self._buckets: "dict[str, TokenBucket]" = {}
        self.counters: "dict[str, dict]" = {}
        for t in tenants:
            if t.name in self.tenants:
                raise ValueError(f"duplicate tenant {t.name!r}")
            self.tenants[t.name] = t
            self._buckets[t.name] = TokenBucket(
                t.quota_tokens_per_s, t.quota_burst, now=now)
            self.counters[t.name] = {
                "admitted": 0, "rejected": {}, "sheds": 0,
                "tokens_admitted": 0}

    def tenant(self, name: str) -> TenantConfig:
        return self.tenants[name]

    @staticmethod
    def cost_of(request) -> int:
        """Admission cost of one request: prompt plus the generation
        budget it reserves."""
        return len(request.tokens) + int(request.max_new_tokens)

    # -- quota ------------------------------------------------------------
    def charge(self, tenant: str, cost: float, now: float) -> bool:
        """Try to charge ``cost`` tokens against the tenant's quota
        bucket. A refusal is a ``cause="quota"`` rejection — the caller
        stamps and surfaces it."""
        ok = self._buckets[tenant].take(cost, now)
        c = self.counters[tenant]
        if ok:
            c["admitted"] += 1
            c["tokens_admitted"] += int(cost)
        else:
            c["rejected"]["quota"] = c["rejected"].get("quota", 0) + 1
        return ok

    def note_reject(self, tenant: str, cause: str):
        c = self.counters[tenant]["rejected"]
        c[cause] = c.get(cause, 0) + 1

    def note_shed(self, tenant: str):
        self.counters[tenant]["sheds"] += 1

    def quota_level(self, tenant: str, now: float) -> float:
        return self._buckets[tenant].level(now)

    def quota_utilization(self, tenant: str, now: float) -> "float | None":
        """1 - level/burst: how much of the burst allowance is
        currently spent (None for unmetered tenants)."""
        t = self.tenants[tenant]
        if not math.isfinite(t.quota_burst) or t.quota_burst <= 0:
            return None
        return round(1.0 - self._buckets[tenant].level(now)
                     / t.quota_burst, 4)

    # -- weighted-fair admission ------------------------------------------
    def plan_tick(self, demands: "dict[str, float]", *, budget: float,
                  aged: "set | frozenset" = frozenset()
                  ) -> "dict[str, float]":
        """Token allocation for one admission tick.

        ``demands`` maps tenant -> queued token demand. Interactive
        tenants (plus any batch tenant in ``aged`` — queued past its
        starvation deadline) split the budget weighted-fair first;
        batch divides whatever remains. Under pressure batch therefore
        sheds (defers) first, by construction.
        """
        weights = {n: t.weight for n, t in self.tenants.items()}
        first = {n: d for n, d in demands.items()
                 if self.tenants[n].pclass == "interactive"
                 or n in aged}
        second = {n: d for n, d in demands.items() if n not in first}
        alloc = fair_shares(first, weights, budget)
        left = budget - sum(alloc.values())
        alloc.update(fair_shares(second, weights, left))
        return {n: alloc.get(n, 0.0) for n in demands}

    # -- reporting --------------------------------------------------------
    def summary(self, now: float) -> "dict[str, dict]":
        out = {}
        for name, t in self.tenants.items():
            c = self.counters[name]
            out[name] = {
                "pclass": t.pclass, "weight": t.weight,
                "admitted": c["admitted"],
                "rejected": dict(c["rejected"]),
                "sheds": c["sheds"],
                "tokens_admitted": c["tokens_admitted"],
                "quota_utilization": self.quota_utilization(name, now),
            }
        return out


# -- per-tenant SLOs --------------------------------------------------------

def tenant_slos(cfg: TenantConfig, *, windows=None) -> list:
    """The tenant's declarative SLO set (telemetry/slo.py objects),
    named ``<tenant>/p99_latency`` so verdicts never collide across
    tenants."""
    from distributed_tensorflow_tpu_torch.telemetry import slo as slo_lib
    return [slo_lib.SLO(name=f"{cfg.name}/p99_latency",
                        metric="latency",
                        objective=cfg.slo_objective,
                        threshold_s=cfg.slo_latency_s,
                        windows=windows
                        or slo_lib.DEFAULT_BURN_WINDOWS)]


def partition_records(records: "list[dict]") -> "dict[str, list]":
    """Split SLO completion records by their ``tenant`` stamp (records
    without one group under ``"-"``)."""
    out: "dict[str, list]" = {}
    for r in records:
        out.setdefault(r.get("tenant") or "-", []).append(r)
    return out


def evaluate_tenants(records: "list[dict]",
                     tenants: Iterable[TenantConfig], *,
                     windows=None, now=None) -> "dict[str, dict]":
    """Per-tenant SLO verdicts over a mixed completion stream: each
    tenant's records are evaluated against ITS OWN burn windows and
    threshold — one tenant's overrun cannot fire another's SLO."""
    from distributed_tensorflow_tpu_torch.telemetry import slo as slo_lib
    by_tenant = partition_records(records)
    out: "dict[str, dict]" = {}
    for cfg in tenants:
        recs = by_tenant.get(cfg.name, [])
        if not recs:
            continue
        w = windows
        if w is None:
            span = ((recs[-1]["wall"] - recs[0]["wall"])
                    if len(recs) > 1 else 1.0)
            w = slo_lib.windows_for_span(max(span, 1e-3))
        out[cfg.name] = slo_lib.evaluate_records(
            recs, tenant_slos(cfg, windows=w), now=now)
    return out

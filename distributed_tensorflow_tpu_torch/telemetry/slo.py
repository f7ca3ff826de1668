"""Declarative serving SLOs with multi-window burn-rate evaluation.

The port's copy of ``distributed_tensorflow_tpu/telemetry/slo.py``: the same
decisions, keys, record fields and seeded streams, held exactly
to the JAX package's by the CPU tests (``tests/test_torch_*``).

The serving engine measures per-request latency/TTFT; this
module turns those measurements into *objectives* an operator can gate
on — the SRE-workbook formulation:

- an :class:`SLO` declares an **objective** (e.g. 99% of requests) over
  a **condition** (latency under ``threshold_s``, TTFT under
  ``threshold_s``, or plain availability), leaving an **error budget**
  of ``1 - objective``;
- the **burn rate** over a window is ``error_rate / error_budget`` — 1.0
  means the budget is being consumed exactly as fast as it accrues, 14.4
  means a 30-day budget dies in 2 days;
- an SLO **fires** when the burn rate exceeds a window's threshold in
  BOTH the long window and its short confirmation window (the
  multi-window multi-burn-rate rule: the long window gives significance,
  the short one makes the alert reset fast once the problem stops).

Two consumption modes share the math:

- :class:`SLOMonitor` — live: the serving replica feeds each completion
  record; :meth:`SLOMonitor.evaluate` is exported on the health scrape.
- :func:`evaluate_records` / :func:`records_from_events` — post-hoc over
  a run's ``serve.request`` events; ``tools/health_report.py --check``
  gates ``--slo-budget`` on it and ``bench.py --serving`` stamps the
  verdict into its row.

Production window presets live in :data:`DEFAULT_BURN_WINDOWS`; bench
and test runs last seconds, not hours, so :func:`windows_for_span`
scales the preset shape down to the observed span (keeping the 12:1
long:short ratio and the burn thresholds).
"""

from __future__ import annotations

import dataclasses

#: (long_window_s, short_window_s, max_burn_rate) — the SRE-workbook
#: page/ticket pair for a 30-day budget: 1h/5m at 14.4x (2% of budget
#: in 1h) and 6h/30m at 6x (5% of budget in 6h).
DEFAULT_BURN_WINDOWS = ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))


def default_serving_slos(*, latency_s: float = 0.5,
                         ttft_s: float = 0.25,
                         windows: tuple = DEFAULT_BURN_WINDOWS) -> list:
    """The stock serving objective set (mirrored by the README's SLO
    threshold table): 99% of requests complete under ``latency_s``,
    95% reach their first token under ``ttft_s``, 99.9% complete at
    all."""
    return [
        SLO("p99_latency", "latency", objective=0.99,
            threshold_s=latency_s, windows=windows),
        SLO("p95_ttft", "ttft", objective=0.95,
            threshold_s=ttft_s, windows=windows),
        SLO("availability", "availability", objective=0.999,
            windows=windows),
    ]


def default_online_slos(*, freshness_s: float = 5.0,
                        windows: tuple = DEFAULT_BURN_WINDOWS) -> list:
    """The online-training objective set (mirrored by
    the README's online SLO table): 90% of published snapshots must be
    servable within ``freshness_s`` of their checkpoint commit
    (update→servable latency — the online counterpart of request
    latency), and 99.9% of snapshot publications succeed. The feed is
    ``stream.snapshot_published`` events
    (:func:`freshness_records_from_events`); the burn math is shared
    with the serving SLOs unchanged."""
    return [
        SLO("freshness_p90", "freshness", objective=0.90,
            threshold_s=freshness_s, windows=windows),
        SLO("snapshot_availability", "availability", objective=0.999,
            windows=windows),
    ]


def windows_for_span(span_s: float) -> tuple:
    """Scale :data:`DEFAULT_BURN_WINDOWS` to a short run: the longest
    window becomes the observed span, every window keeps its shape
    (12:1 long:short) and burn threshold. Windows never collapse below
    1ms so rates stay finite."""
    if span_s <= 0:
        return DEFAULT_BURN_WINDOWS
    scale = span_s / DEFAULT_BURN_WINDOWS[-1][0]
    return tuple((max(1e-3, lw * scale), max(1e-3, sw * scale), burn)
                 for lw, sw, burn in DEFAULT_BURN_WINDOWS)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective.

    ``metric``: ``"latency"`` (request dur vs ``threshold_s``),
    ``"ttft"`` (time-to-first-token vs ``threshold_s``),
    ``"freshness"`` (online training's update→servable seconds vs
    ``threshold_s``), or ``"availability"`` (request completed ok).
    ``objective`` is the target good fraction (0.99 → 1% error budget).
    """

    name: str
    metric: str = "latency"
    objective: float = 0.99
    threshold_s: float | None = None
    windows: tuple = DEFAULT_BURN_WINDOWS

    _METRICS = ("latency", "ttft", "availability", "freshness")
    _METRIC_KEYS = {"latency": "latency_s", "ttft": "ttft_s",
                    "freshness": "freshness_s"}

    def __post_init__(self):
        if self.metric not in self._METRICS:
            raise ValueError(f"SLO {self.name}: metric {self.metric!r} "
                             f"not in {self._METRICS}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name}: objective must be in "
                             f"(0, 1), got {self.objective}")
        if self.metric != "availability" and self.threshold_s is None:
            raise ValueError(f"SLO {self.name}: {self.metric} needs "
                             f"threshold_s")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def is_bad(self, record: dict) -> bool:
        """Does one completion record violate the condition?"""
        if self.metric == "availability":
            return not record.get("ok", True)
        v = record.get(self._METRIC_KEYS[self.metric])
        if not isinstance(v, (int, float)):
            # a generation request with no TTFT measurement etc. —
            # treat missing data as bad only for availability
            return False
        return v > self.threshold_s

    @classmethod
    def from_dict(cls, d: dict) -> "SLO":
        windows = d.get("windows")
        return cls(name=d["name"], metric=d.get("metric", "latency"),
                   objective=float(d.get("objective", 0.99)),
                   threshold_s=d.get("threshold_s"),
                   windows=tuple(tuple(w) for w in windows)
                   if windows else DEFAULT_BURN_WINDOWS)


def burn_rate(records: "list[dict]", slo: SLO, *, window_s: float,
              now: float) -> "float | None":
    """Burn rate over ``(now - window_s, now]``: in-window error rate
    divided by the error budget. None with no in-window traffic (no
    evidence — distinct from burn 0.0)."""
    lo = now - window_s
    n = bad = 0
    for r in records:
        w = r.get("wall")
        if not isinstance(w, (int, float)) or not lo < w <= now:
            continue
        n += 1
        bad += bool(slo.is_bad(r))
    if n == 0:
        return None
    return (bad / n) / slo.error_budget


def burn_windows(records: "list[dict]", slo: SLO, *,
                 now: "float | None" = None) -> "list[dict]":
    """Per-window burn snapshot for ONE SLO — the live feed the
    autoscaler (resilience/autoscaler.py) consumes every watch tick.
    Returns the same window dicts :func:`evaluate_records` emits under
    ``windows``: long/short burns plus ``firing`` (BOTH over the
    threshold). ``now`` defaults to the newest record wall."""
    if now is None:
        walls = [r["wall"] for r in records
                 if isinstance(r.get("wall"), (int, float))]
        now = max(walls) if walls else 0.0
    windows = []
    for lw, sw, max_burn in slo.windows:
        bl = burn_rate(records, slo, window_s=lw, now=now)
        bs = burn_rate(records, slo, window_s=sw, now=now)
        windows.append({"long_s": round(lw, 6),
                        "short_s": round(sw, 6),
                        "max_burn": max_burn,
                        "burn_long": bl, "burn_short": bs,
                        "firing": (bl is not None and bs is not None
                                   and bl > max_burn and bs > max_burn)})
    return windows


def evaluate_records(records: "list[dict]", slos: "list[SLO]", *,
                     now: "float | None" = None) -> dict:
    """Evaluate every SLO over completion records.

    Records: ``{"wall": t, "latency_s": s, "ttft_s": s|None, "ok":
    bool}``. Returns per SLO: overall error rate, budget consumed
    (error_rate / budget over the whole record set), per-window burn
    rates, and ``firing`` (any window pair with BOTH burns over its
    threshold). ``now`` defaults to the newest record wall.
    """
    walls = [r["wall"] for r in records
             if isinstance(r.get("wall"), (int, float))]
    if now is None:
        now = max(walls) if walls else 0.0
    out: dict = {}
    for slo in slos:
        n = len(records)
        bad = sum(bool(slo.is_bad(r)) for r in records)
        error_rate = (bad / n) if n else 0.0
        windows = burn_windows(records, slo, now=now)
        firing = any(w["firing"] for w in windows)
        out[slo.name] = {
            "metric": slo.metric,
            "objective": slo.objective,
            "threshold_s": slo.threshold_s,
            "requests": n,
            "bad": bad,
            "error_rate": round(error_rate, 6),
            "budget_consumed": round(error_rate / slo.error_budget, 6),
            "windows": windows,
            "firing": firing,
        }
    return out


def records_from_events(events_by_pid: "dict") -> "list[dict]":
    """Completion records from ``serve.request`` events across every
    process (the post-hoc feed health_report evaluates)."""
    records = []
    for events in events_by_pid.values():
        for ev in events:
            if ev.get("ev") != "serve.request":
                continue
            records.append({
                "wall": ev.get("wall"),
                "latency_s": ev.get("dur_s"),
                "ttft_s": ev.get("ttft_s"),
                "model_version": ev.get("model_version"),
                "tenant": ev.get("tenant"),
                "pclass": ev.get("pclass"),
                "ok": not ev.get("error"),
            })
    records.sort(key=lambda r: r.get("wall") or 0.0)
    return records


def freshness_records_from_events(events_by_pid: "dict") -> "list[dict]":
    """Freshness records measuring true update→**servable** lag.

    A publish event (``stream.snapshot_published`` from the online
    evaluator, or ``rollout.publish`` from the rollout controller)
    opens a freshness interval; it CLOSES only at a serving replica's
    swap-complete event (``serve.swap`` — in-place hot-swap or
    restart adoption, matched by snapshot ``step``), and the record's
    ``freshness_s`` is the publish stamp's own lag plus the
    publish→swap gap. A replica that adopts by restart therefore
    honestly reports the respawn-sized gap the hot-swap path removes;
    a snapshot no replica ever adopts produces NO record (it never
    became servable). One record per adopting replica per publish.

    Back-compat: a run with no ``serve.swap`` events at all (an older run's
    online topology — the evaluator scores snapshots in-process) keeps
    the original close-at-publish semantics, so existing feeds and the
    ``chaos_sweep --online`` gate read unchanged."""
    pubs, swaps = [], []
    for pid, events in events_by_pid.items():
        for ev in events:
            name = ev.get("ev")
            if name in ("stream.snapshot_published", "rollout.publish"):
                pubs.append(ev)
            elif name == "serve.swap":
                swaps.append((pid, ev))
    records = []
    if not swaps:
        for ev in pubs:
            records.append({
                "wall": ev.get("wall"),
                "freshness_s": ev.get("freshness_s"),
                "lag_events": ev.get("lag_events"),
                "offset": ev.get("offset"),
                "ok": not ev.get("error"),
            })
        records.sort(key=lambda r: r.get("wall") or 0.0)
        return records
    for pub in pubs:
        pwall = pub.get("wall")
        if not isinstance(pwall, (int, float)):
            continue
        step = pub.get("step")
        base = pub.get("freshness_s")
        base = float(base) if isinstance(base, (int, float)) else 0.0
        # each replica's FIRST matching swap at/after the publish
        first: dict = {}
        for pid, sw in swaps:
            if step is not None and sw.get("step") != step:
                continue
            swall = sw.get("wall")
            if not isinstance(swall, (int, float)) or swall < pwall:
                continue
            if pid not in first or swall < first[pid][0]:
                first[pid] = (swall, sw)
        for pid, (swall, sw) in first.items():
            records.append({
                "wall": swall,
                "freshness_s": round(base + (swall - pwall), 6),
                "lag_events": pub.get("lag_events"),
                "offset": pub.get("offset"),
                "step": step,
                "mode": sw.get("mode"),
                "ok": not sw.get("error"),
            })
    records.sort(key=lambda r: r.get("wall") or 0.0)
    return records


class SLOMonitor:
    """Live SLO evaluation over a bounded record window.

    The serving replica calls :meth:`observe` per completion; the
    exporter tick calls :meth:`evaluate` and renders the result on the
    scrape. Keeps the newest ``max_records`` completions — enough to
    cover the longest configured window at serving rates, bounded so a
    week-long replica doesn't grow without limit.
    """

    def __init__(self, slos: "list[SLO]", max_records: int = 8192):
        import collections
        self.slos = list(slos)
        self._records: "collections.deque" = collections.deque(
            maxlen=max_records)

    def observe(self, record: dict):
        self._records.append(dict(record))

    def evaluate(self, now: "float | None" = None) -> dict:
        return evaluate_records(list(self._records), self.slos, now=now)

    def prometheus_lines(self, *, prefix: str = "dtx_",
                         now: "float | None" = None) -> list:
        lines = [f"# TYPE {prefix}slo_burn_rate gauge",
                 f"# TYPE {prefix}slo_budget_consumed gauge",
                 f"# TYPE {prefix}slo_firing gauge"]
        for name, res in self.evaluate(now=now).items():
            lines.append(f'{prefix}slo_budget_consumed{{slo="{name}"}} '
                         f'{res["budget_consumed"]:.6f}')
            lines.append(f'{prefix}slo_firing{{slo="{name}"}} '
                         f'{int(res["firing"])}')
            for w in res["windows"]:
                if w["burn_long"] is not None:
                    lines.append(
                        f'{prefix}slo_burn_rate{{slo="{name}",'
                        f'window="{w["long_s"]:g}s"}} '
                        f'{w["burn_long"]:.6f}')
        return lines

"""The port's ``telemetry/slo.py`` and ``serving/tenancy.py`` held
exactly to the JAX package's on seeded record streams: burn rates and
windows, record evaluation, the event feeds, ``SLOMonitor`` (its
verdicts and its Prometheus lines), the token bucket, weighted max-min
fair shares and the ``TenancyController``'s quota and admission plans.
Host logic only, so every comparison is exact."""

import numpy as np
import pytest

from distributed_tensorflow_tpu.serving import tenancy as jax_tenancy
from distributed_tensorflow_tpu.telemetry import slo as jax_slo
from distributed_tensorflow_tpu_torch.serving import tenancy as pt_tenancy
from distributed_tensorflow_tpu_torch.telemetry import slo as pt_slo

TENANTS = ("acme", "batchco", "burst")


def _records(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    wall = 1000.0 + np.cumsum(rng.exponential(0.05, n))
    lat = rng.lognormal(-1.5, 0.9, n)
    ttft = lat * rng.uniform(0.1, 0.6, n)
    return [{"wall": float(w), "latency_s": float(la),
             "ttft_s": (float(t) if i % 7 else None),
             "ok": bool(i % 23), "tenant": TENANTS[i % 3],
             "pclass": "batch" if i % 3 == 1 else "interactive",
             "model_version": f"step-{i // 100}"}
            for i, (w, la, t) in enumerate(zip(wall, lat, ttft))]


def _slos(mod, windows):
    return [mod.SLO("p99_latency", "latency", objective=0.99,
                    threshold_s=0.4, windows=windows),
            mod.SLO("p95_ttft", "ttft", objective=0.95, threshold_s=0.1,
                    windows=windows),
            mod.SLO("availability", "availability", objective=0.999,
                    windows=windows)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rates_windows_and_evaluation(seed):
    recs = _records(seed)
    now = recs[-1]["wall"]
    windows = ((8.0, 2.0, 2.0), (4.0, 1.0, 6.0))
    for js, ps in zip(_slos(jax_slo, windows), _slos(pt_slo, windows)):
        for w in (1.0, 2.5, 8.0, 30.0):
            assert pt_slo.burn_rate(recs, ps, window_s=w, now=now) == \
                jax_slo.burn_rate(recs, js, window_s=w, now=now)
        assert pt_slo.burn_windows(recs, ps, now=now) == \
            jax_slo.burn_windows(recs, js, now=now)
    assert pt_slo.evaluate_records(recs, _slos(pt_slo, windows)) == \
        jax_slo.evaluate_records(recs, _slos(jax_slo, windows))
    span = recs[-1]["wall"] - recs[0]["wall"]
    assert pt_slo.windows_for_span(span) == jax_slo.windows_for_span(span)
    assert [s.__dict__ for s in pt_slo.default_serving_slos()] == \
        [s.__dict__ for s in jax_slo.default_serving_slos()]


def test_event_feeds():
    recs = _records(3, 60)
    events = {0: [], 1: []}
    for i, r in enumerate(recs):
        events[i % 2].append({"ev": "serve.request", "wall": r["wall"],
                              "dur_s": r["latency_s"],
                              "ttft_s": r["ttft_s"],
                              "tenant": r["tenant"], "pclass": r["pclass"],
                              "model_version": r["model_version"],
                              **({} if r["ok"] else {"error": "boom"})})
        if i % 10 == 0:
            events[0].append({"ev": "rollout.publish", "step": i,
                              "wall": r["wall"], "freshness_s": 0.25})
        if i % 10 == 3:
            events[1].append({"ev": "serve.swap", "step": i - 3,
                              "wall": r["wall"], "mode": "hot"})
    assert pt_slo.records_from_events(events) == \
        jax_slo.records_from_events(events)
    assert pt_slo.freshness_records_from_events(events) == \
        jax_slo.freshness_records_from_events(events)
    no_swap = {0: [e for e in events[0] if e["ev"] != "serve.swap"]}
    assert pt_slo.freshness_records_from_events(no_swap) == \
        jax_slo.freshness_records_from_events(no_swap)


def test_slo_monitor():
    recs = _records(4)
    windows = jax_slo.windows_for_span(recs[-1]["wall"] - recs[0]["wall"])
    jm = jax_slo.SLOMonitor(_slos(jax_slo, windows), max_records=256)
    pm = pt_slo.SLOMonitor(_slos(pt_slo, windows), max_records=256)
    for r in recs:
        jm.observe(r)
        pm.observe(r)
    now = recs[-1]["wall"] + 0.5
    assert pm.evaluate(now=now) == jm.evaluate(now=now)
    assert pm.prometheus_lines() == jm.prometheus_lines()


def test_token_bucket_and_fair_shares():
    rng = np.random.default_rng(5)
    jb = jax_tenancy.TokenBucket(40.0, 80.0, now=0.0)
    pb = pt_tenancy.TokenBucket(40.0, 80.0, now=0.0)
    t = 0.0
    for cost in rng.integers(1, 60, 300):
        t += float(rng.exponential(0.3))
        assert pb.take(float(cost), t) == jb.take(float(cost), t)
        assert pb.level(t) == jb.level(t)
    for _ in range(50):
        demands = {n: float(d) for n, d in zip(
            TENANTS, rng.integers(0, 200, 3)) if d}
        weights = {n: float(w) for n, w in zip(
            TENANTS, rng.uniform(0.5, 3.0, 3))}
        budget = float(rng.integers(10, 400))
        assert pt_tenancy.fair_shares(demands, weights, budget) == \
            jax_tenancy.fair_shares(demands, weights, budget)


def _tenants(mod):
    return (mod.TenantConfig("acme", pclass="interactive", weight=2.0,
                             slo_latency_s=2.0),
            mod.TenantConfig("batchco", pclass="batch", weight=1.0,
                             slo_latency_s=15.0, starvation_frac=0.15),
            mod.TenantConfig("burst", pclass="interactive", weight=1.0,
                             quota_tokens_per_s=40.0, quota_burst=80.0,
                             slo_latency_s=2.0))


def test_tenancy_controller():
    rng = np.random.default_rng(6)
    jc = jax_tenancy.TenancyController(_tenants(jax_tenancy), now=0.0)
    pc = pt_tenancy.TenancyController(_tenants(pt_tenancy), now=0.0)
    t = 0.0
    for i in range(400):
        t += float(rng.exponential(0.05))
        name = TENANTS[int(rng.integers(3))]
        cost = float(rng.integers(5, 60))
        assert pc.charge(name, cost, t) == jc.charge(name, cost, t)
        if i % 5 == 0:
            demands = {n: float(d) for n, d in zip(
                TENANTS, rng.integers(0, 150, 3)) if d}
            aged = {"batchco"} if i % 10 == 0 else set()
            budget = float(rng.integers(16, 200))
            assert pc.plan_tick(demands, budget=budget, aged=aged) == \
                jc.plan_tick(demands, budget=budget, aged=aged)
        if i % 17 == 0:
            pc.note_shed("batchco")
            jc.note_shed("batchco")
            pc.note_reject("burst", "overload")
            jc.note_reject("burst", "overload")
        assert pc.quota_utilization("burst", t) == \
            jc.quota_utilization("burst", t)
    assert pc.summary(t) == jc.summary(t)
    assert pt_tenancy.default_tenants() == tuple(
        pt_tenancy.TenantConfig(**c.__dict__)
        for c in jax_tenancy.default_tenants())


def test_tenant_evaluation():
    recs = _records(7)
    assert pt_tenancy.partition_records(recs) == \
        jax_tenancy.partition_records(recs)
    for windows in (None, ((8.0, 2.0, 2.0),)):
        assert pt_tenancy.evaluate_tenants(
            recs, _tenants(pt_tenancy), windows=windows) == \
            jax_tenancy.evaluate_tenants(recs, _tenants(jax_tenancy),
                                         windows=windows)
    for jt, pt in zip(_tenants(jax_tenancy), _tenants(pt_tenancy)):
        assert [s.__dict__ for s in pt_tenancy.tenant_slos(pt)] == \
            [s.__dict__ for s in jax_tenancy.tenant_slos(jt)]

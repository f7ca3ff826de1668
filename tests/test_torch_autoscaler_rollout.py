"""The port's ``resilience/autoscaler.py`` and ``resilience/rollout.py``
held exactly to the JAX package's on seeded completion records and a
fake clock: the ``Autoscaler``'s scale decisions (tenant attribution
included), the ``CapacityArbiter``'s state machine against fake
serving and training supervisors (donation, reclaim, blocked and
timeout outcomes, and the events it emits), and the
``RolloutController``'s advance / promote / rollback verdicts with the
assignment file it writes."""

import json

import numpy as np
import pytest

from distributed_tensorflow_tpu.resilience import autoscaler as jax_as
from distributed_tensorflow_tpu.resilience import rollout as jax_ro
from distributed_tensorflow_tpu.serving import tenancy as jax_ten
from distributed_tensorflow_tpu.telemetry import registry as jax_reg
from distributed_tensorflow_tpu.telemetry import slo as jax_slo
from distributed_tensorflow_tpu_torch.resilience import autoscaler as pt_as
from distributed_tensorflow_tpu_torch.resilience import rollout as pt_ro
from distributed_tensorflow_tpu_torch.serving import tenancy as pt_ten
from distributed_tensorflow_tpu_torch.telemetry import registry as pt_reg
from distributed_tensorflow_tpu_torch.telemetry import slo as pt_slo

PKGS = {"jax": (jax_as, jax_ro, jax_ten, jax_reg, jax_slo),
        "torch": (pt_as, pt_ro, pt_ten, pt_reg, pt_slo)}


def _spiky_records(seed: int, t_end: float = 120.0) -> list:
    """Completions at ~6/s whose latency jumps inside [30, 50) and
    [80, 85) seconds; tenants alternate."""
    rng = np.random.default_rng(seed)
    out, t, i = [], 0.0, 0
    while t < t_end:
        t += float(rng.exponential(1 / 6))
        hot = 30.0 <= t < 50.0 or 80.0 <= t < 85.0
        lat = float(rng.lognormal(0.5 if hot else -2.5, 0.4))
        out.append({"wall": round(t, 6), "latency_s": lat,
                    "ttft_s": lat / 4, "ok": True,
                    "tenant": ("acme", "batchco")[i % 2],
                    "model_version": f"{(1, 2)[i % 3 == 0]}@abc"})
        i += 1
    return out


def _policy(as_mod, slo_mod):
    return as_mod.AutoscalePolicy(
        min_replicas=1, max_replicas=4, fire_consecutive=2,
        clear_burn=1.0, clear_hold_s=5.0, cooldown_s=8.0, min_evidence=4,
        interval_s=0.5, slo=slo_mod.SLO(
            "p99_latency", "latency", objective=0.99, threshold_s=0.5,
            windows=((6.0, 2.0, 2.0),)))


def _visible(records, now):
    return [r for r in records if r["wall"] <= now]


def _autoscaler_run(pkg: str, seed: int) -> list:
    as_mod, _, ten, _, slo_mod = PKGS[pkg]
    tenants = (ten.TenantConfig("acme", slo_latency_s=0.5),
               ten.TenantConfig("batchco", pclass="batch",
                                slo_latency_s=2.0))
    eng = as_mod.Autoscaler(_policy(as_mod, slo_mod), tenants=tenants,
                            clock=lambda: 0.0)
    recs = _spiky_records(seed)
    n, out = 1, []
    for k in range(1, 1200):
        now = k * 0.1
        d = eng.decide(n, records=_visible(recs, now), now=now)
        if d is not None:
            out.append((now, d.to_fields(), eng.last_eval))
            n = d.target
            eng.action_applied(now)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_autoscaler_decisions(seed):
    got, want = _autoscaler_run("torch", seed), _autoscaler_run("jax", seed)
    assert got == want
    assert {d[1]["direction"] for d in want} == {"up", "down"}


class _FakeSup:
    """The supervisor surface the arbiter drives: a scale request lands
    ``lag`` ticks later."""

    def __init__(self, n: int, lag: int = 2):
        self.num_workers, self.lag = n, lag
        self.events, self.requests, self._due = [], [], None

    def request_scale(self, n, *, reason="scale"):
        self.requests.append((n, reason))
        self._due = (self.lag, n)
        return n

    def _event(self, name, **fields):
        self.events.append((name, fields))

    def replicas_ready(self) -> bool:
        return True

    def advance(self):
        if self._due is not None:
            left, n = self._due
            if left <= 1:
                self.num_workers, self._due = n, None
            else:
                self._due = (left - 1, n)


def _arbiter_run(pkg: str, seed: int, train_n: int) -> tuple:
    as_mod, _, _, reg_mod, slo_mod = PKGS[pkg]
    clock = {"t": 0.0}
    recs = _spiky_records(seed)
    eng = as_mod.Autoscaler(
        _policy(as_mod, slo_mod), clock=lambda: clock["t"],
        records_fn=lambda: _visible(recs, clock["t"]))
    serve = _FakeSup(1)
    train = _FakeSup(train_n, lag=3) if train_n else None
    arb = as_mod.CapacityArbiter(eng, budget=4, train_sup=train,
                                 state_timeout_s=20.0,
                                 reg=reg_mod.MetricsRegistry())
    snap = []
    for k in range(1, 1200):
        clock["t"] = k * 0.1
        arb.tick(serve)
        serve.advance()
        if train is not None:
            train.advance()
        snap.append((arb._state, serve.num_workers,
                     train.num_workers if train else None))
    return (serve.events, serve.requests,
            train.requests if train else None, snap, arb.decisions)


@pytest.mark.parametrize("train_n", [0, 3])
def test_capacity_arbiter(train_n):
    got, want = _arbiter_run("torch", 0, train_n), \
        _arbiter_run("jax", 0, train_n)
    assert got == want
    outcomes = {f["outcome"] for _, f in want[0]}
    assert "applied" in outcomes
    if train_n:
        assert "donate" in outcomes


def _rollout_run(pkg: str, tmp_path, bad_canary: bool) -> tuple:
    _, ro, _, _, slo_mod = PKGS[pkg]
    rng = np.random.default_rng(3)
    recs, t = [], 0.0
    ctrl = ro.RolloutController(
        ["r0", "r1", "r2"], base_step=1, target_step=2,
        policy=ro.RolloutPolicy(), clock=lambda: 0.0,
        assignment_path=str(tmp_path / f"assign-{pkg}.json"),
        published_wall=0.0)
    files = []
    for k in range(1, 800):
        now = k * 0.1
        while t < now:
            t += float(rng.exponential(1 / 8))
            rep = ctrl.replicas[int(rng.integers(3))]
            step = ctrl.assignment[rep]
            lat = float(rng.lognormal(
                0.3 if (bad_canary and step == 2) else -2.5, 0.3))
            recs.append({"wall": round(t, 6), "latency_s": lat,
                         "ok": True, "model_version": f"{step}@d"})
        d = ctrl.decide(now=now, records=list(recs))
        if d is not None:
            ctrl.write_assignment()
            with open(ctrl.assignment_path) as f:
                files.append(json.load(f))
        if ctrl.done:
            break
    return ([d.to_fields() for d in ctrl.decisions], ctrl.state,
            ctrl.last_eval, files)


@pytest.mark.parametrize("bad_canary", [False, True])
def test_rollout_controller(tmp_path, bad_canary):
    got = _rollout_run("torch", tmp_path, bad_canary)
    want = _rollout_run("jax", tmp_path, bad_canary)
    assert got == want
    assert want[1] == ("rolled_back" if bad_canary else "promoted")
    for v in ("3@x", "12@abc", "x@1", None, 5):
        assert pt_ro.version_step(v) == jax_ro.version_step(v)
    assert pt_ro.read_assignment(str(tmp_path / "assign-jax.json")) == \
        jax_ro.read_assignment(str(tmp_path / "assign-torch.json"))

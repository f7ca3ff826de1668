"""The port's ``CapacityArbiter`` counts a scale action as applied only
once every replica of the reformed serving gang has heartbeated
(``RecoverySupervisor.replicas_ready``), on a fake clock and fake
supervisors:

- replicas that stay silent (importing, initialising the card, warming
  up) for longer than the cooldown plus the clear hold after a
  scale-up: the port makes no ``down`` decision until they have
  heartbeated and the hold has passed since, where JAX's arbiter, which
  counts the action applied at the spawn, scales back down during the
  silence (the flap of a fleet at JAX's default policy);
- replicas that heartbeat at once: the port's decisions (direction,
  target, reason, order) and every event it emits equal JAX's
  ``CapacityArbiter`` on the same record stream.
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.resilience import autoscaler as jax_as
from distributed_tensorflow_tpu.telemetry import registry as jax_reg
from distributed_tensorflow_tpu.telemetry import slo as jax_slo
from distributed_tensorflow_tpu_torch.resilience import autoscaler as pt_as
from distributed_tensorflow_tpu_torch.telemetry import registry as pt_reg
from distributed_tensorflow_tpu_torch.telemetry import slo as pt_slo

PKGS = {"jax": (jax_as, jax_reg, jax_slo), "torch": (pt_as, pt_reg, pt_slo)}
COOLDOWN_S, CLEAR_HOLD_S = 8.0, 5.0
TICK_S = 0.1


def _policy(as_mod, slo_mod):
    return as_mod.AutoscalePolicy(
        min_replicas=1, max_replicas=4, fire_consecutive=2,
        clear_burn=1.0, clear_hold_s=CLEAR_HOLD_S, cooldown_s=COOLDOWN_S,
        min_evidence=4, interval_s=0.5, slo=slo_mod.SLO(
            "p99_latency", "latency", objective=0.99, threshold_s=0.5,
            windows=((6.0, 2.0, 2.0),)))


def _records(seed: int, gaps=(), t_end: float = 120.0) -> list:
    """Completions at ~6/s whose latency jumps inside [30, 50) and
    [80, 85) seconds, none inside the ``gaps`` (start, end) spans."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while t < t_end:
        t += float(rng.exponential(1 / 6))
        hot = 30.0 <= t < 50.0 or 80.0 <= t < 85.0
        lat = float(rng.lognormal(0.5 if hot else -2.5, 0.4))
        if not any(lo <= t < hi for lo, hi in gaps):
            out.append({"wall": round(t, 6), "latency_s": lat,
                        "ttft_s": lat / 4, "ok": True})
    return out


class _FakeServe:
    """The serving supervisor's surface: a scale request reforms the gang
    ``lag`` ticks later, and the new gang's replicas heartbeat
    ``silent_s`` after that (JAX's arbiter never asks)."""

    def __init__(self, n: int, *, lag: int = 2, silent_s: float = 0.0):
        self.num_workers, self.lag, self.silent_s = n, lag, silent_s
        self.events, self.requests, self._due = [], [], None
        self.ready_at, self.now = 0.0, 0.0

    def replicas_ready(self) -> bool:
        return self.now >= self.ready_at

    def request_scale(self, n, *, reason="scale"):
        self.requests.append((n, reason, round(self.now, 6)))
        self._due = (self.lag, n)
        return n

    def _event(self, name, **fields):
        self.events.append((name, fields, round(self.now, 6)))

    def advance(self, now: float):
        self.now = now
        if self._due is not None:
            left, n = self._due
            if left <= 1:
                self.num_workers, self._due = n, None
                self.ready_at = now + self.silent_s
            else:
                self._due = (left - 1, n)


def _run(pkg: str, recs: list, serve: _FakeServe, t_end: float = 110.0):
    as_mod, reg_mod, slo_mod = PKGS[pkg]
    clock = {"t": 0.0}
    eng = as_mod.Autoscaler(
        _policy(as_mod, slo_mod), clock=lambda: clock["t"],
        records_fn=lambda: [r for r in recs if r["wall"] <= clock["t"]])
    arb = as_mod.CapacityArbiter(eng, budget=4, state_timeout_s=60.0,
                                 reg=reg_mod.MetricsRegistry())
    for k in range(1, int(t_end / TICK_S)):
        clock["t"] = k * TICK_S
        serve.advance(clock["t"])
        arb.tick(serve)
    # (direction, target, reason, outcome, time) of each scale.decision
    return [(f["direction"], f["target"], f["reason"], f["outcome"], t)
            for name, f, t in serve.events if name == "scale.decision"]


def _first_up(decisions):
    return next(d for d in decisions if d[0] == "up" and d[3] == "applied")


@pytest.mark.parametrize("silent_s", [20.0, 30.0])
def test_silent_replicas_hold_the_scale_down(silent_s):
    """After the first scale-up the new gang is silent for ``silent_s``
    (more than cooldown + clear hold) and no request completes: the port
    holds the action open, and its first ``down`` comes at least the
    clear hold after the replicas' first heartbeat; JAX's counts the
    action applied at the spawn and scales down inside the silence."""
    probe = _FakeServe(1)
    _run("jax", _records(0), probe)
    t_up = probe.requests[0][2]          # the first scale-up's request
    recs = _records(0, gaps=[(t_up, t_up + silent_s)])

    jax_serve = _FakeServe(1, silent_s=silent_s)
    _run("jax", recs, jax_serve)
    port_serve = _FakeServe(1, silent_s=silent_s)
    port_dec = _run("torch", recs, port_serve)

    assert port_serve.requests[0][:2] == (2, "slo_burn")
    assert port_serve.requests[0][2] == t_up
    # applied at the first tick at which the new gang has heartbeated
    ready = _first_up(port_dec)[4]
    assert ready >= t_up + silent_s
    downs = [r for r in port_serve.requests if r[0] < 2]
    assert downs, port_serve.requests
    assert downs[0][2] >= ready + CLEAR_HOLD_S
    # JAX's arbiter flaps: a scale-down while the new gang is still silent
    assert any(r[0] < 2 and t_up < r[2] < t_up + silent_s
               for r in jax_serve.requests), jax_serve.requests


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ready_replicas_decide_as_jax(seed):
    """Replicas that heartbeat at once (``silent_s`` 0): the port's
    decisions and events are JAX's on the same records."""
    recs = _records(seed)
    port, jax = _FakeServe(1, silent_s=0.0), _FakeServe(1)
    got, want = _run("torch", recs, port), _run("jax", recs, jax)
    assert got == want
    assert port.requests == jax.requests
    assert {d[0] for d in want} == {"up", "down"}

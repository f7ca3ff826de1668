"""The port's ``telemetry/audit.py`` held exactly to the JAX package's:
the phase timeline, the cause windows, per-record attribution, the SLO
budget itemization and the whole day audit on a hand-built day and on
the event files of a compressed ``DaySim`` day (the JAX package's run),
and ``check_audit``'s gates on every failure they name."""

import copy
import json

import pytest

from distributed_tensorflow_tpu.telemetry import audit as jax_audit
from distributed_tensorflow_tpu.telemetry import events as jax_events
from distributed_tensorflow_tpu.telemetry import slo as jax_slo
from distributed_tensorflow_tpu.testing import day_sim as jax_day
from distributed_tensorflow_tpu_torch.telemetry import audit as pt_audit
from distributed_tensorflow_tpu_torch.telemetry import slo as pt_slo


def _ev(name, wall, **fields):
    return dict(fields, ev=name, wall=wall)


def _day_events():
    """A day with one bad record per attribution bucket."""
    driver = [
        _ev("day.phase", 0.0, phase="night", rate_rps=40.0),
        _ev("day.phase", 1.0, phase="spike", rate_rps=1400.0),
        _ev("day.phase", 2.0, phase="peak_2", rate_rps=250.0),
        _ev("day.rack_kill", 2.2, domain="rack2", victims=[4, 5]),
        _ev("day.load", 2.9, generated=11),
        _ev("day.end", 3.0),
    ]
    trainer = [
        _ev("train.step", 0.5, dur_s=0.1, gen=0),
        _ev("recovery.worker_death", 2.21, task_id=4),
        _ev("scale.applied", 1.2, generation=1),
        _ev("recovery.generation_start", 2.35, generation=2),
        _ev("recovery.restore_tier", 2.4, tier="peer", step=8),
        _ev("train.step", 2.6, dur_s=0.1, gen=2),
    ]
    records = [
        _ev("serve.request", 0.5, dur_s=0.3),
        _ev("serve.request", 1.5, dur_s=0.3, ttft_s=0.2),
        _ev("serve.request", 2.5, dur_s=0.3),
        _ev("serve.request", 2.5, dur_s=0.3, replayed_tokens=5),
        _ev("serve.request", 1.25, dur_s=0.3),
    ] + [_ev("serve.request", 0.1 + 0.05 * i, dur_s=0.01)
         for i in range(6)]
    return {"driver": driver, 4: trainer, 0: records}


def _slos(slo_mod):
    return [slo_mod.SLO("lat", "latency", objective=0.9, threshold_s=0.1),
            slo_mod.SLO("ttft", "ttft", objective=0.8, threshold_s=0.1)]


def test_timeline_windows_and_attribution_equal_jax():
    ev = _day_events()
    assert pt_audit.day_records(ev) == jax_audit.day_records(ev)
    assert pt_audit.phase_spans(ev) == jax_audit.phase_spans(ev)
    for opts in ({}, {"recovery_backdate_s": 0.5, "recovery_drain_s": 0.2,
                      "scale_lead_s": 0.1, "scale_drain_s": 0.3}):
        assert pt_audit.cause_windows(ev, **opts) == \
            jax_audit.cause_windows(ev, **opts)
    ws = pt_audit.cause_windows(ev)
    for rec in pt_audit.day_records(ev):
        assert pt_audit.attribute(rec, ws) == jax_audit.attribute(rec, ws)


def test_itemize_equal_jax():
    ev = _day_events()
    out = {}
    for name, audit, slo in (("pt", pt_audit, pt_slo),
                             ("jax", jax_audit, jax_slo)):
        records = audit.day_records(ev)
        windows = audit.cause_windows(ev)
        slos = _slos(slo)
        evaluated = slo.evaluate_records(records, slos)
        out[name] = (audit.itemize_slos(records, slos, evaluated, windows),
                     evaluated)
    assert out["pt"] == out["jax"]


def test_audit_day_equal_jax_on_a_hand_built_day():
    ev = _day_events()
    got = pt_audit.audit_day(ev, slos=_slos(pt_slo))
    want = jax_audit.audit_day(ev, slos=_slos(jax_slo))
    assert got == want
    assert got["rack_loss"]["warm"]
    assert pt_audit.audit_day(ev) == jax_audit.audit_day(ev)


@pytest.fixture(scope="module")
def jax_day_logs(tmp_path_factory):
    """The JAX package's compressed day (seed 1)."""
    logdir = str(tmp_path_factory.mktemp("jday"))
    rep = jax_day.DaySim(seed=1, logdir=logdir,
                         phases=jax_day.default_phases(compress=0.5)).run()
    assert rep["completed_run"], rep["error"]
    return jax_events.read_run(logdir)


def test_audit_day_equal_jax_on_a_simulated_day(jax_day_logs):
    got = pt_audit.audit_day(jax_day_logs)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        jax_audit.audit_day(jax_day_logs), sort_keys=True, default=str)
    assert got["requests"]["dropped"] == 0


def _fixture(**over):
    base = {"ledger": {"identity_error_frac": 0.0, "identity_error_s": 0.0,
                       "wall_s": 10.0, "goodput_frac": 0.96},
            "slos": {"lat": {"requests": 100, "bad": 10,
                             "unattributed": {"frac_of_bad": 0.0,
                                              "bad": 0}}},
            "rack_loss": {"restore_tiers": ["host", "peer"], "warm": True,
                          "mttr_s": 0.04},
            "requests": {"generated": 100, "completed": 100, "dropped": 0}}
    out = copy.deepcopy(base)
    for path, value in over.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
    return out


@pytest.mark.parametrize("over,gate", [
    ({}, {"goodput_floor": 0.5, "require_warm_restore": True,
          "max_rack_mttr_s": 1.0}),
    ({"ledger.identity_error_frac": 0.05}, {}),
    ({"ledger.goodput_frac": 0.3}, {"goodput_floor": 0.5}),
    ({"slos.lat.unattributed.frac_of_bad": 0.5}, {}),
    ({"rack_loss.warm": False, "rack_loss.restore_tiers": ["durable"]},
     {"require_warm_restore": True}),
    ({"rack_loss": None}, {"require_warm_restore": True}),
    ({"rack_loss.restore_tiers": []}, {"require_warm_restore": True}),
    ({"rack_loss.mttr_s": 9.0}, {"max_rack_mttr_s": 1.0}),
    ({"requests.dropped": 3}, {}),
])
def test_check_audit_equal_jax(over, gate):
    fx = _fixture(**over)
    got = pt_audit.check_audit(fx, **gate)
    assert got == jax_audit.check_audit(fx, **gate)
    assert bool(got) == bool(over)

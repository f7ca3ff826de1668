"""The port's ``testing/day_sim.py`` held to the JAX package's: the same
diurnal phases, and a compressed day under the same seed gives JAX's
report on what the seed fixes (phases, the rack killed and its victims,
the scale reform, every admitted request completed) and an audit that
passes the same gates; with the blind replica ring the rack kill falls
through to the durable tier, as in JAX."""

import dataclasses

import pytest

from distributed_tensorflow_tpu.telemetry import audit as jax_audit
from distributed_tensorflow_tpu.telemetry import events as jax_events
from distributed_tensorflow_tpu.testing import day_sim as jax_day
from distributed_tensorflow_tpu_torch.telemetry import audit as pt_audit
from distributed_tensorflow_tpu_torch.telemetry import events as pt_events
from distributed_tensorflow_tpu_torch.testing import day_sim as pt_day


@pytest.mark.parametrize("compress", [1.0, 0.5, 2.0])
def test_default_phases_equal_jax(compress):
    got = [dataclasses.asdict(p) for p in pt_day.default_phases(
        compress=compress)]
    assert got == [dataclasses.asdict(p) for p in jax_day.default_phases(
        compress=compress)]


def _day(day_mod, events_mod, audit_mod, logdir, **kw):
    rep = day_mod.DaySim(seed=1, logdir=logdir,
                         phases=day_mod.default_phases(compress=0.5),
                         **kw).run()
    out = audit_mod.audit_day(events_mod.read_run(logdir))
    return rep, out


@pytest.fixture(scope="module")
def days(tmp_path_factory):
    return {name: _day(dm, em, am, str(tmp_path_factory.mktemp(name)))
            for name, dm, em, am in (
                ("pt", pt_day, pt_events, pt_audit),
                ("jax", jax_day, jax_events, jax_audit))}


def test_report_equals_jax_on_the_seeded_fields(days):
    (got, _), (want, _) = days["pt"], days["jax"]
    for k in ("seed", "domain_spread", "phases", "rack_kill",
              "scales_applied", "generations", "final_workers",
              "completed_run", "error", "two_tenant"):
        assert got[k] == want[k], k
    assert got["completed_run"] and got["rack_kill"]["victims"]
    assert got["generated"] == got["completed"] > 0


def test_audit_passes_the_same_gates(days):
    for _, out in days.values():
        assert pt_audit.check_audit(out, require_warm_restore=True,
                                    goodput_floor=0.5) == []
        assert jax_audit.check_audit(out, require_warm_restore=True,
                                     goodput_floor=0.5) == []
    (_, got), (_, want) = days["pt"], days["jax"]
    assert got["rack_loss"]["domain"] == want["rack_loss"]["domain"]
    assert got["rack_loss"]["victims"] == want["rack_loss"]["victims"]
    assert got["rack_loss"]["warm"] and want["rack_loss"]["warm"]
    assert [p["phase"] for p in got["phases"]] == \
        [p["phase"] for p in want["phases"]]
    assert got["requests"]["dropped"] == want["requests"]["dropped"] == 0


def test_blind_ring_fails_the_warm_restore_gate(tmp_path):
    _, out = _day(pt_day, pt_events, pt_audit, str(tmp_path),
                  domain_spread=False)
    assert out["rack_loss"]["restore_tiers"] == ["durable"]
    fails = pt_audit.check_audit(out, require_warm_restore=True)
    assert fails == jax_audit.check_audit(out, require_warm_restore=True)
    assert any("warm tiers" in f for f in fails)

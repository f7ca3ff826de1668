"""The port's event log stamps the cluster generation as the JAX
package's does: records of a generation above 0 carry ``"gen"`` right
after ``"pid"``, generation 0 stays unstamped; and the port's goodput
ledger over a file a reformed process appended to prices the gap as
``recovery``, as JAX's does over the same events."""

import json
import os
import time

import pytest

from distributed_tensorflow_tpu.cluster import elastic as jax_elastic
from distributed_tensorflow_tpu.telemetry import events as jax_events
from distributed_tensorflow_tpu.telemetry import goodput as jax_goodput
from distributed_tensorflow_tpu_torch.cluster import elastic as pt_elastic
from distributed_tensorflow_tpu_torch.telemetry import events as pt_events
from distributed_tensorflow_tpu_torch.telemetry import goodput as pt_goodput


def _write(events_mod, path, gen, monkeypatch):
    monkeypatch.setenv(pt_elastic.ENV_GENERATION, str(gen))
    assert jax_elastic.ENV_GENERATION == pt_elastic.ENV_GENERATION
    log = events_mod.EventLog(path, process_id=0, run_id="r")
    log.event("train.step", step=1, dur_s=0.01)
    with log.span("checkpoint.commit", step=1):
        pass
    log.close()
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("gen", [0, 2])
def test_records_equal_jax_field_for_field(tmp_path, monkeypatch, gen):
    got = _write(pt_events, str(tmp_path / "pt.jsonl"), gen, monkeypatch)
    want = _write(jax_events, str(tmp_path / "jax.jsonl"), gen, monkeypatch)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)                # same fields, same order
        assert {k: v for k, v in g.items() if k not in ("t", "wall", "dur_s")} \
            == {k: v for k, v in w.items() if k not in ("t", "wall", "dur_s")}
        if gen:
            assert g["gen"] == gen and list(g)[:5] == ["ev", "t", "wall",
                                                       "pid", "gen"]
        else:
            assert "gen" not in g


def test_thread_override_stamps_the_writer_generation(tmp_path):
    """A log opened under a thread's generation override stamps it."""
    path = str(tmp_path / "events-3.jsonl")
    with pt_elastic.generation_override(5):
        log = pt_events.EventLog(path, process_id=3)
    log.event("serve.step", dur_s=0.001)
    log.close()
    assert pt_events.read_events(path)[0]["gen"] == 5


def test_goodput_prices_the_reform_gap_as_recovery(tmp_path, monkeypatch):
    """Generation 0 steps, a gap, then the reformed process (generation
    2) appends to the same events-0.jsonl: both ledgers price the gap
    ``recovery`` and agree on every bucket."""
    tdir = str(tmp_path / "tel")
    path = pt_events.event_log_path(tdir, 0)
    monkeypatch.setenv(pt_elastic.ENV_GENERATION, "0")
    log = pt_events.EventLog(path, process_id=0)
    for i in range(3):
        time.sleep(0.01)
        log.event("train.step", step=i, dur_s=0.01)
    log.close()
    time.sleep(0.15)                       # death -> respawn
    monkeypatch.setenv(pt_elastic.ENV_GENERATION, "2")
    log = pt_events.EventLog(path, process_id=0)
    for i in range(3):
        time.sleep(0.01)
        log.event("train.step", step=i, dur_s=0.01)
    log.close()
    events = pt_events.read_run(tdir)
    assert [e.get("gen", 0) for e in events[0]] == [0, 0, 0, 2, 2, 2]
    got = pt_goodput.ledger_from_events(events)
    want = jax_goodput.ledger_from_events(events)
    assert got["badput_s"]["recovery"] >= 0.15
    assert got["badput_s"] == pytest.approx(want["badput_s"], abs=1e-9)
    assert got["goodput_s"] == pytest.approx(want["goodput_s"], abs=1e-9)
    assert got["wall_s"] == pytest.approx(want["wall_s"], abs=1e-9)
    assert os.path.basename(path) == "events-0.jsonl"

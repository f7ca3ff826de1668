"""The port's ``telemetry/trace.py`` held exactly to the JAX package's on
the same event files: clock offsets from barrier and heartbeat sync
points, the assembled Chrome trace (slices, instants, flow arrows,
metadata), ``assemble_run`` / ``write_trace`` over a run directory
with a torn tail, ``trace_completeness`` over generations, and
``classify_run`` on every threshold."""

import json
import os
import random

import pytest

from distributed_tensorflow_tpu.telemetry import trace as jax_trace
from distributed_tensorflow_tpu_torch.telemetry import events as pt_events
from distributed_tensorflow_tpu_torch.telemetry import trace as pt_trace

NAMES = ("train.step", "checkpoint.commit", "dispatch.closure",
         "worker.execute", "input.fetch", "serve.step", "fault.fired")


def _run_events(seed: int, *, skew=(0.0, 0.031, -0.012), gens=(0, 1),
                drop_gen=None) -> dict:
    """Seeded events of three workers and the supervisor: barrier
    crossings read by skewed clocks, heartbeat observations, spans with
    ``span_id`` chains, generation stamps."""
    rng = random.Random(f"trace-test:{seed}")
    out = {p: [] for p in range(len(skew))}
    out["supervisor"] = []
    t = 1000.0
    for g in gens:
        out["supervisor"].append({"ev": "recovery.generation_start",
                                  "wall": t, "pid": "supervisor",
                                  "generation": g})
        for b in range(3):
            t += rng.uniform(0.05, 0.2)
            for p, off in enumerate(skew):
                if g == drop_gen and p:
                    continue
                rec = {"ev": "clock.sync", "t": t - 1000.0,
                       "wall": round(t + off + rng.uniform(0, 1e-4), 6),
                       "pid": p, "barrier": f"b{b}"}
                if g:
                    rec["gen"] = g
                out[p].append(rec)
        for i in range(12):
            t += rng.uniform(0.01, 0.05)
            p = rng.randrange(len(skew))
            if g == drop_gen and p:
                continue
            rec = {"ev": rng.choice(NAMES), "t": t - 1000.0,
                   "wall": round(t + skew[p], 6), "pid": p}
            if g:
                rec["gen"] = g
            if rng.random() < 0.6:
                rec["dur_s"] = round(rng.uniform(0.001, 0.05), 6)
            if rng.random() < 0.4:
                rec["span_id"] = f"c{rng.randrange(4)}"
            rec["step"] = i
            out[p].append(rec)
        for p, off in enumerate(skew):
            mtime = t + rng.uniform(0, 1e-3)
            out["supervisor"].append({
                "ev": "clock.hb", "wall": mtime, "pid": "supervisor",
                "worker": p, "worker_wall": round(mtime + off, 6),
                "mtime": mtime, "generation": g})
    return out


def _write_run(tmp_path, events: dict, torn: bool = True) -> str:
    d = str(tmp_path / "run7")
    os.makedirs(d)
    for pid, evs in events.items():
        with open(pt_events.event_log_path(d, pid), "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
            if torn and pid == 1:
                f.write('{"ev": "train.step", "wall": 10')   # SIGKILL
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offsets_and_trace_equal_jax(seed):
    events = _run_events(seed)
    for ref in (None, 1, "supervisor"):
        got = pt_trace.estimate_clock_offsets(events, reference=ref)
        assert got == jax_trace.estimate_clock_offsets(events,
                                                       reference=ref)
    off = pt_trace.estimate_clock_offsets(events)
    assert abs(off[1] - 0.031) < 1e-3 and abs(off[2] + 0.012) < 1e-3
    assert pt_trace.assemble_trace(events, run_id="x") == \
        jax_trace.assemble_trace(events, run_id="x")
    assert pt_trace._pairwise_offsets(events) == \
        jax_trace._pairwise_offsets(events)


def test_unsynced_process_is_flagged_not_guessed():
    events = _run_events(3)
    events[5] = [{"ev": "train.step", "wall": 1000.5, "pid": 5,
                  "dur_s": 0.01}]
    got = pt_trace.assemble_trace(events)
    assert got == jax_trace.assemble_trace(events)
    assert got["otherData"]["clock_unaligned"] == ["5"]


def test_assemble_and_write_run_over_files(tmp_path):
    d = _write_run(tmp_path, _run_events(4))
    assert pt_trace.assemble_run(d) == jax_trace.assemble_run(d)
    pt_path = pt_trace.write_trace(d, str(tmp_path / "pt.json"))
    jax_path = jax_trace.write_trace(d, str(tmp_path / "jax.json"))
    assert open(pt_path).read() == open(jax_path).read()
    assert pt_trace.write_trace(d) == os.path.join(d, "trace.json")


@pytest.mark.parametrize("drop_gen", [None, 1])
def test_completeness_equal_jax(drop_gen):
    events = _run_events(5, gens=(0, 1, 2), drop_gen=drop_gen)
    if drop_gen is not None:
        for p in (0,):
            events[p] = [e for e in events[p] if e.get("gen", 0) != drop_gen]
    got = pt_trace.trace_completeness(events)
    assert got == jax_trace.trace_completeness(events)
    assert got["complete"] == (drop_gen is None)
    # without the supervisor's timeline, the stamps enumerate
    bare = {p: e for p, e in events.items() if p != "supervisor"}
    assert pt_trace.trace_completeness(bare) == \
        jax_trace.trace_completeness(bare)


@pytest.mark.parametrize("fractions", [
    {}, {"infeed": 0.3}, {"collective": 0.5, "infeed": 0.16},
    {"recovery": 0.25, "checkpoint": 0.11}, {"checkpoint": 0.09},
    {"recovery": None, "collective": 0.25}])
def test_classify_equal_jax(fractions):
    assert pt_trace.classify_run(fractions) == \
        jax_trace.classify_run(fractions)
    assert pt_trace.BOTTLENECK_THRESHOLDS == jax_trace.BOTTLENECK_THRESHOLDS


@pytest.mark.parametrize("total,exposed", [(0.0, 0.0), (1.0, 0.25),
                                           (2.0, 3.0), (1.0, -1.0)])
def test_overlap_efficiency_equal_jax(total, exposed):
    assert pt_trace.overlap_efficiency(total, exposed) == \
        jax_trace.overlap_efficiency(total, exposed)

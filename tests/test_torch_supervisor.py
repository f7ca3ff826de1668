"""The port's ``resilience/supervisor.py`` (over the port's spawn
runner, extended with ``restart``, ``reform`` and ``alive_tasks``): the
seeded kill and shrink plans equal the JAX package's, and a restartable
two-rank gloo worker under the supervisor survives one step-targeted
SIGKILL — one failure recorded (``killed``, exit -9), one reform into
generation 1 under a fresh cluster spec, the survivors' work resumed,
and the supervisor's events readable by the JAX package's reader."""

import json
import os

import pytest

from distributed_tensorflow_tpu.resilience import supervisor as jax_sup
from distributed_tensorflow_tpu.telemetry import events as jax_events
from distributed_tensorflow_tpu_torch.resilience import supervisor as pt_sup
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_fleet_ranks


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_seeded_plans(seed):
    for n in (1, 2, 4, 9):
        for kills, rng in ((1, (3, 12)), (3, (40, 120))):
            assert pt_sup.seeded_kill_plan(
                seed, n, kills=kills, step_range=rng) == [
                pt_sup.KillSpec(**k.__dict__) for k in
                jax_sup.seeded_kill_plan(seed, n, kills=kills,
                                         step_range=rng)]
        assert pt_sup.seeded_shrink_plan(seed, n) == [
            pt_sup.KillSpec(**k.__dict__)
            for k in jax_sup.seeded_shrink_plan(seed, n)]


def test_kill_reform_resume(tmp_path):
    tdir = tmp_path / "tel"
    sup = pt_sup.RecoverySupervisor(
        torch_fleet_ranks.restartable_worker, num_workers=2,
        args=(str(tmp_path), 12), device="cpu", max_restarts=2,
        kill_plan=[pt_sup.KillSpec(worker=1, after_step=4)],
        generation_timeout_s=120.0, telemetry_dir=str(tdir))
    result = sup.run()
    assert sup.generation == 1 and sup.restarts_used == 1
    assert [(f.task, f.kind, f.exitcode) for f in sup.history] == \
        [(("worker", 1), "killed", -9)]
    vals = sorted(result.return_values, key=lambda v: v["rank"])
    assert [v["rank"] for v in vals] == [0, 1]
    assert all(v["gen"] == 1 and v["world"] == 2 and v["steps"] == 12
               for v in vals)
    # generation 1 resumed where generation 0 stopped
    assert vals[0]["start"] >= 4 and vals[0]["sum"] == \
        2.0 * (12 - vals[0]["start"])
    specs = {}
    for g in (0, 1):
        with open(tmp_path / f"spec-g{g}-r0.json") as f:
            specs[g] = json.load(f)
    assert len(specs[0]["worker"]) == len(specs[1]["worker"]) == 2
    assert set(specs[0]["worker"]).isdisjoint(specs[1]["worker"])
    evs = [e["ev"] for e in jax_events.read_events(
        os.path.join(tdir, "events-supervisor.jsonl"))]
    for name in ("recovery.run_start", "recovery.chaos_kill",
                 "recovery.worker_death", "recovery.restart",
                 "recovery.recover", "recovery.run_complete"):
        assert name in evs
    assert evs.count("recovery.generation_start") == 2


def test_runner_restart_keeps_history(tmp_path):
    """``restart`` respawns one task under an overridden environment;
    the dead incarnation's result stays in ``history``."""
    spec = multi_process_runner.create_cluster_spec(num_workers=1)
    runner = multi_process_runner.MultiProcessRunner(
        torch_fleet_ranks.env_echo, spec, args=("DTX_PROBE",),
        device="cpu", env={"DTX_PROBE": "a"}, timeout=60)
    runner.start()
    try:
        first = runner.join(timeout=60)
        runner.restart("worker", 0, env={"DTX_PROBE": "b"})
        assert runner.alive_tasks() in ([("worker", 0)], [])
        second = runner.join(timeout=60)
    finally:
        runner.terminate_all()
    assert first.return_values == ["a"] and second.return_values == ["b"]
    assert [t.value for t in runner.history] == ["a"]

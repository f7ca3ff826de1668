"""The port's ``testing/fleet_sim.py`` held to the JAX package's: the
seeded fault schedules and correlated kill plans equal JAX's for every
seed tried; the domain topology and the thread runner's whole-domain
kill; and small simulated fleets (16-32 workers under the real recovery
supervisor) give JAX's report on everything the seed fixes: which
faults fired, which worker failed and how, the generations, restarts,
scale reforms and the rollup's coverage. Wall times are not compared."""

import pytest

from distributed_tensorflow_tpu.testing import fleet_sim as jax_fs
from distributed_tensorflow_tpu_torch.cluster import elastic as pt_elastic
from distributed_tensorflow_tpu_torch.resilience import faults as pt_faults
from distributed_tensorflow_tpu_torch.testing import fleet_sim as pt_fs


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_seeded_schedules_equal_jax(seed):
    for n in (8, 64, 1000):
        for kinds in (("crash", "stall", "partition"), ("crash",)):
            assert pt_fs.seeded_fleet_schedule(
                seed, n, kinds=kinds, step_range=(2, 7),
                stall_s=1.5).to_json() == jax_fs.seeded_fleet_schedule(
                seed, n, kinds=kinds, step_range=(2, 7),
                stall_s=1.5).to_json()
        assert pt_fs.seeded_data_kill_schedule(
            seed, n, kills=3).to_json() == \
            jax_fs.seeded_data_kill_schedule(seed, n, kills=3).to_json()
    with pytest.raises(ValueError, match="unknown fleet fault kind"):
        pt_fs.seeded_fleet_schedule(seed, 4, kinds=("meteor",))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_domain_kill_plans_equal_jax(seed):
    for n, per in ((8, 2), (13, 4), (64, 8)):
        a = pt_fs.DomainTopology(n, workers_per_domain=per)
        b = jax_fs.DomainTopology(n, workers_per_domain=per)
        assert a.as_map() == b.as_map() and a.domains == b.domains
        assert a.shrink(n - 1).as_map() == b.shrink(n - 1).as_map()
        for kw in ({}, {"kills": 2, "after_range": (0.1, 0.4)},
                   {"eligible": a.domains[1:]}):
            got = pt_fs.seeded_domain_kill_plan(seed, a, **kw)
            want = jax_fs.seeded_domain_kill_plan(seed, b, **kw)
            assert [(k.domain, k.victims, k.after_s) for k in got] == \
                [(k.domain, k.victims, k.after_s) for k in want]
    assert pt_fs.sim_cluster_spec(3) == jax_fs.sim_cluster_spec(3)


def test_runner_kills_a_whole_domain():
    topo = pt_fs.DomainTopology(6, workers_per_domain=2)

    def fn(ctx):
        while True:
            ctx.sleep(0.01)
    r = pt_fs.SimRunner(fn, pt_fs.sim_cluster_spec(6), topology=topo,
                        device="cpu").start()
    try:
        assert r._task_env[("worker", 3)][pt_fs.ENV_FAILURE_DOMAIN] == \
            "rack1"
        assert r.terminate_domain("rack1") == [2, 3]
        assert r.poll() == {("worker", 2): -9, ("worker", 3): -9}
        assert ("worker", 4) in r.alive_tasks()
    finally:
        r.shutdown()
    with pytest.raises(ValueError, match="needs a topology"):
        pt_fs.SimRunner(fn, pt_fs.sim_cluster_spec(2)).terminate_domain("x")


def _seeded_fields(rep):
    return {"completed": rep.completed, "generations": rep.generations,
            "restarts": rep.restarts, "faults_fired": rep.faults_fired,
            # a stall's detail carries its measured staleness
            "failures": [f.split(" (")[0] for f in rep.failures],
            "final_workers": rep.final_workers,
            "scales_applied": rep.scales_applied,
            "rollup_workers_seen": rep.rollup_workers_seen,
            "detections": [(d["kind"], d["task_id"], d["generation"])
                           for d in rep.detections],
            "error": rep.error}


RUNS = {
    "crash24": dict(n=24, kw=dict(steps=10, step_s=0.01,
                                  stall_timeout_s=0.7),
                    schedule=lambda fs: fs.seeded_fleet_schedule(
                        0, 24, kinds=("crash",))),
    "stall16": dict(n=16, kw=dict(steps=10, step_s=0.02,
                                  stall_timeout_s=0.5, hb_shard_size=4),
                    schedule=lambda fs: fs.FaultSchedule(rules=(
                        fs.FaultRule(site="fleet.step", action="delay",
                                     delay_s=2.0, tag="9", hits=(3,)),),
                        seed=7)),
    "partition8": dict(n=8, kw=dict(steps=10, step_s=0.02,
                                    partition_steps=2, stall_timeout_s=5.0),
                       schedule=lambda fs: fs.FaultSchedule(rules=(
                           fs.FaultRule(site="fleet.step",
                                        action="signal", tag="4",
                                        hits=(3,)),))),
    "clean32": dict(n=32, kw=dict(steps=6, step_s=0.01, fanout=4),
                    schedule=None),
    "scale16": dict(n=16, kw=dict(steps=40, step_s=0.01,
                                  scale_plan=[(0.15, 12)]),
                    schedule=None),
}


class _Faults:
    """The fault classes of one package, for the schedules above."""

    def __init__(self, fs, faults):
        self.FaultSchedule, self.FaultRule = (faults.FaultSchedule,
                                              faults.FaultRule)
        self.seeded_fleet_schedule = fs.seeded_fleet_schedule


@pytest.mark.parametrize("run", sorted(RUNS))
def test_small_fleet_report_equals_jax(run):
    from distributed_tensorflow_tpu.resilience import faults as jax_faults
    spec = RUNS[run]
    reps = {}
    for name, fs, faults in (("pt", pt_fs, pt_faults),
                             ("jax", jax_fs, jax_faults)):
        sched = (spec["schedule"](_Faults(fs, faults))
                 if spec["schedule"] else None)
        reps[name] = fs.FleetSim(spec["n"], fault_schedule=sched,
                                 **spec["kw"]).run()
    got, want = _seeded_fields(reps["pt"]), _seeded_fields(reps["jax"])
    assert got == want
    assert got["completed"], got["error"]
    assert sorted(reps["pt"].to_row()) == sorted(reps["jax"].to_row())
    assert pt_elastic.generation() == 0


def test_agent_partition_and_barrier():
    agents = pt_fs.make_sim_cluster(3)
    agents[1].partition()
    with pytest.raises(Exception, match="simulated network partition"):
        agents[1].key_value_set("k", "v")
    agents[1].heal()
    agents[1].key_value_set("k", "v")
    assert agents[2].key_value_get("k", timeout_s=1.0) == b"v"
    assert agents[0].op_counts["set"] == 0 and \
        agents[1].op_counts["set"] == 1

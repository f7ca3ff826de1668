"""The port's ``telemetry/aggregate.py`` and ``telemetry/stall.py`` held
to the JAX package's: the registry snapshots workers publish, the
merged rollups (flat and through the reducer tree, every depth), the
topology's duties, the phase summary and scalar tags, the publisher and
aggregator threads; and the stall detector's suspect, trigger count,
event fields and badput bucket."""

import io
import json
import random
import time

import pytest

from distributed_tensorflow_tpu.telemetry import aggregate as jax_agg
from distributed_tensorflow_tpu.telemetry import events as jax_events
from distributed_tensorflow_tpu.telemetry import goodput as jax_goodput
from distributed_tensorflow_tpu.telemetry import registry as jax_reg
from distributed_tensorflow_tpu.telemetry import stall as jax_stall
from distributed_tensorflow_tpu.testing import fleet_sim as jax_fs
from distributed_tensorflow_tpu_torch.telemetry import aggregate as pt_agg
from distributed_tensorflow_tpu_torch.telemetry import events as pt_events
from distributed_tensorflow_tpu_torch.telemetry import goodput as pt_goodput
from distributed_tensorflow_tpu_torch.telemetry import registry as pt_reg
from distributed_tensorflow_tpu_torch.telemetry import stall as pt_stall
from distributed_tensorflow_tpu_torch.testing import fleet_sim as pt_fs


def _fill(reg_mod, pid: int, seed: int):
    """A worker's registry with every instrument kind, seeded."""
    rng = random.Random(f"agg:{seed}:{pid}")
    reg = reg_mod.MetricsRegistry()
    reg.counter("training/steps_completed").increment(rng.randrange(5, 50))
    reg.gauge("training/last_loss").set(round(rng.uniform(1, 3), 4))
    reg.gauge("worker/host").set(f"h{pid % 3}")
    h = reg.histogram("training/phase/compute_frac")
    t = reg.timer("training/step_time")
    for _ in range(rng.randrange(3, 20)):
        h.record(round(rng.uniform(0.5, 1.0), 4))
        t.record(round(rng.uniform(0.01, 0.2), 5))
    reg.gauge("training/overlap_eff").set(round(rng.uniform(0, 1), 4))
    if pid % 2:
        reg.counter("input/elements").increment(pid)
    return reg


def _strip_walls(x):
    if isinstance(x, dict):
        return {k: _strip_walls(v) for k, v in x.items() if k != "wall"}
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_merge_equal_jax(seed):
    n = 7
    pt_snaps, jax_snaps = {}, {}
    for p in range(n):
        a, b = _fill(pt_reg, p, seed), _fill(jax_reg, p, seed)
        assert a.snapshot() == b.snapshot()
        pt_snaps[p] = {"pid": p, "seq": 3, "wall": 10.0 + p,
                       "metrics": a.snapshot()}
        jax_snaps[p] = {"pid": p, "seq": 3, "wall": 10.0 + p,
                        "metrics": b.snapshot()}
    got = pt_agg.merge_rollup(pt_snaps)
    assert got == jax_agg.merge_rollup(jax_snaps)
    assert pt_agg.phase_summary(got) == jax_agg.phase_summary(got)
    assert pt_agg.rollup_scalars(got) == jax_agg.rollup_scalars(got)
    assert got["metrics"]["training/steps_completed"]["type"] == "counter"


@pytest.mark.parametrize("n,fanout", [(1, 16), (5, 2), (40, 4), (64, 16)])
def test_topology_equal_jax(n, fanout):
    a = pt_agg.RollupTopology(n, fanout=fanout)
    b = jax_agg.RollupTopology(n, fanout=fanout)
    assert (a.depth, a.root) == (b.depth, b.root)
    assert [a.duties(p) for p in range(n)] == [b.duties(p) for p in range(n)]
    for lvl in range(a.depth):
        for node in range(-(-n // fanout ** (lvl + 1))):
            assert a.reducer_of(lvl, node) == b.reducer_of(lvl, node)


@pytest.mark.parametrize("n,fanout", [(9, 2), (40, 4)])
def test_tree_rollup_equal_jax_and_flat(n, fanout):
    """Every worker publishes and runs its duties (twice: depth ticks)
    through each package's own sim agents; the root rollups, the flat
    rollups and the KV contents agree but for wall stamps."""
    out = {}
    for name, agg, reg_mod, fs in (("pt", pt_agg, pt_reg, pt_fs),
                                   ("jax", jax_agg, jax_reg, jax_fs)):
        agents = fs.make_sim_cluster(n)
        topo = agg.RollupTopology(n, fanout=fanout)
        for p in range(n):
            agg.publish_snapshot(agents[p], _fill(reg_mod, p, 5),
                                 process_id=p, seq=p)
        for _ in range(topo.depth):
            for p in range(n):
                agg.run_duties(agents[p], topo, p)
        tree = agg.collect_rollup_tree(agents[0], topo)
        flat = agg.collect_rollup(agents[0], range(n))
        kv = {k: _strip_walls(json.loads(v))
              for k, v in agents[0]._local._kv.items()}
        ops = [dict(a.op_counts) for a in agents]
        out[name] = (_strip_walls(tree), _strip_walls(flat), kv, ops)
    assert out["pt"] == out["jax"]
    tree, flat = out["pt"][:2]
    assert tree == flat and len(tree["workers"]) == n


def test_publisher_and_aggregator_threads():
    for agg, reg_mod, fs in ((pt_agg, pt_reg, pt_fs),
                             (jax_agg, jax_reg, jax_fs)):
        agents = fs.make_sim_cluster(3)
        pubs = [agg.MetricsPublisher(agents[p], _fill(reg_mod, p, 2),
                                     interval_s=0.02, process_id=p)
                for p in range(3)]
        fa = agg.FleetAggregator(range(3), agent=agents[0],
                                 interval_s=0.02)
        time.sleep(0.1)
        for pub in pubs:
            pub.stop()
        fa.stop()
        roll = fa.last_rollup
        assert sorted(roll["workers"]) == [0, 1, 2]
        assert roll["metrics"]["training/steps_completed"]["sum"] == sum(
            _fill(reg_mod, p, 2).snapshot()["training/steps_completed"][
                "value"] for p in range(3))


def _rollup(steps: dict, walls: dict) -> dict:
    return {"workers": {p: {"seq": 1, "wall": w} for p, w in walls.items()},
            "metrics": {"training/steps_completed": {
                "type": "counter", "per_worker": steps}}}


def test_suspect_worker_equal_jax():
    now = time.time()
    cases = [None, _rollup({0: 9, 1: 4, 2: 9}, {0: now, 1: now, 2: now}),
             _rollup({0: 5, 1: 5}, {0: now - 1, 1: now - 7}),
             _rollup({}, {})]
    for r in cases:
        got = pt_stall.suspect_worker(r, pt_reg.MetricsRegistry())
        want = jax_stall.suspect_worker(r, jax_reg.MetricsRegistry())
        assert got[0] == want[0]
        assert got[1].split(" last published")[0] == \
            want[1].split(" last published")[0]
    # a blocked dispatch lane wins over the rollup
    a, b = pt_reg.MetricsRegistry(), jax_reg.MetricsRegistry()
    for reg, pre in ((a, pt_stall), (b, jax_stall)):
        reg.gauge(pre.WAITING_GAUGE_PREFIX + "3").set(time.monotonic() - 5)
        reg.gauge(pre.WAITING_GAUGE_PREFIX + "1").set(time.monotonic() - 2)
    got = pt_stall.suspect_worker(cases[1], a)
    want = jax_stall.suspect_worker(cases[1], b)
    assert got[0] == want[0] == "3"


def _stall_run(stall_mod, events_mod, goodput_mod, reg_mod, path):
    """Six steps, then a silence past the budget, under a live ledger
    accruing ``infeed_wait``: the detector's events and counters."""
    events_mod.configure(path, process_id=0)
    ledger = goodput_mod.GoodputLedger(register=False)
    goodput_mod.activate(ledger)
    seen = []
    reg = reg_mod.MetricsRegistry()
    det = stall_mod.StallDetector(factor=4.0, min_steps=5,
                                  min_timeout_s=0.5,
                                  rollup_fn=lambda: _rollup(
                                      {0: 6, 1: 2}, {0: 1.0, 1: 1.0}),
                                  on_stall=seen.append, reg=reg,
                                  output=io.StringIO())
    try:
        for i in range(6):
            det.step_completed(step=i, dur_s=0.01)
        median = det.median_step_s()
        ledger.enter("infeed_wait")
        # the watchdog re-reads its budget after its first 1 s wait slice,
        # then triggers; a second trigger would need another 0.5 s
        time.sleep(1.25)
        count = det.triggered_count
    finally:
        det.stop()
        goodput_mod.activate(None)
        events_mod.shutdown()
    evs = [e for e in events_mod.read_run(path)[0]
           if e["ev"] == "stall.suspected"]
    return {"median": median, "count": count, "seen": len(seen),
            "counter": reg.snapshot()["coordinator/stalls_suspected"],
            "events": [{k: v for k, v in e.items()
                        if k not in ("t", "wall", "stalled_s")}
                       for e in evs]}


def test_stall_detector_equal_jax(tmp_path):
    got = _stall_run(pt_stall, pt_events, pt_goodput, pt_reg,
                     str(tmp_path / "pt"))
    want = _stall_run(jax_stall, jax_events, jax_goodput, jax_reg,
                      str(tmp_path / "jax"))
    assert got == want
    assert got["count"] == 1 and got["median"] == 0.01
    ev = got["events"][0]
    assert ev["suspect_worker"] == 1 and ev["badput_bucket"] == "infeed_wait"

"""Port parity: the goodput/badput ledger (``telemetry/goodput.py``) and
the registry collectors it exports through, against the JAX package on
the CPU.

``ledger_from_events`` (and ``prometheus_lines``) give the same ledger
on the same event list; ``ledger_from_run`` reads the port's event
files; the live :class:`GoodputLedger` fed by the port's engines counts
the tokens the JAX engines' ledger counts (fresh and replayed, under
preemption), prices migrations as ``kv_migrate`` and keeps the identity
``wall == goodput + Σ badput``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import DisaggregatedEngine as JDis
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu.telemetry import goodput as jgoodput
from distributed_tensorflow_tpu.telemetry import registry as jregistry
from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    DisaggregatedEngine, Request)
from distributed_tensorflow_tpu_torch.telemetry import goodput
from distributed_tensorflow_tpu_torch.telemetry.registry import (
    MetricsRegistry)


def _events(seed: int) -> dict:
    """A seeded two-worker event log with every classified kind: train
    and serve steps (overlapping spans included), migrations, swaps,
    request completions with replays and re-routes, a generation
    boundary, a scale-applied marker and breadcrumbs."""
    rng = np.random.default_rng(seed)
    out = {}
    for pid in (0, 1):
        wall, evs = 1000.0 + pid, []
        for i in range(60):
            wall += float(rng.uniform(0.001, 0.05))
            kind = rng.choice(["train.step", "serve.step", "kv.migrate",
                               "serve.swap", "serve.request",
                               "serve.rerouted", "serve.token",
                               "run.start"],
                              p=[.2, .3, .1, .05, .15, .05, .1, .05])
            ev = {"ev": str(kind), "wall": round(wall, 6),
                  "gen": 0 if i < 30 else 1 + (i >= 45)}
            if kind in ("train.step", "serve.step", "kv.migrate",
                        "serve.swap"):
                ev["dur_s"] = float(rng.uniform(0, 0.08))
            if kind == "train.step":
                ev["infeed_wait_s"] = float(rng.uniform(0, 0.01))
                ev["ckpt_block_s"] = float(rng.uniform(0, 0.01))
            if kind in ("serve.request", "serve.rerouted"):
                ev["new_tokens"] = int(rng.integers(1, 40))
                ev["replayed_tokens"] = int(rng.integers(0, 5))
            evs.append(ev)
        out[pid] = evs
    out["supervisor"] = [{"ev": "scale.applied", "wall": 1001.0,
                          "generation": 2}]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_from_events_matches_jax(seed):
    events = _events(seed)
    got = goodput.ledger_from_events(events)
    want = jgoodput.ledger_from_events(events)
    assert got == want
    assert got["badput_s"]["kv_migrate"] > 0 and got["badput_s"]["rollout"] > 0
    assert abs(got["identity_error_s"]) < 1e-9
    assert goodput.prometheus_lines(got) == jgoodput.prometheus_lines(want)
    assert goodput.BADPUT_BUCKETS == jgoodput.BADPUT_BUCKETS


def test_ledger_from_run_reads_port_event_files(tmp_path):
    events = _events(3)
    telemetry.configure(str(tmp_path), process_id=0)
    try:
        for ev in events[0]:
            telemetry.event(ev["ev"], **{k: v for k, v in ev.items()
                                         if k != "ev"})
    finally:
        telemetry.shutdown()
    run = telemetry.read_run(str(tmp_path))
    assert list(run) == [0] and len(run[0]) == len(events[0])
    assert goodput.ledger_from_run(str(tmp_path)) == \
        jgoodput.ledger_from_events(run)


def test_live_ledger_counts_and_collector():
    """The live ledger's bookkeeping against the JAX one on a fake
    clock, and its ``goodput/*`` gauges through the port registry's
    collector, removed again by ``close``."""
    t = [0.0]
    reg = MetricsRegistry()
    led = goodput.GoodputLedger(reg=reg, clock=lambda: t[0])
    jled = jgoodput.GoodputLedger(reg=jregistry.MetricsRegistry(),
                                  clock=lambda: t[0])
    for x in (led, jled):
        t[0] = 0.0
        x._t0 = 0.0
    for step in range(5):
        t[0] += 0.5
        for x in (led, jled):
            x.serve_step(0.2)
            x.tokens(fresh=3, replayed=step % 2)
            x.record("kv_migrate", 0.05)
    t[0] += 0.1
    for x in (led, jled):
        x.record("rollout", 0.02)
        x.enter("recovery")
    assert led.snapshot() == jled.snapshot()
    assert led.current_bucket == "recovery"
    snap = reg.snapshot()
    # the first step's migration finds no unattributed wall left (the
    # startup and the step claimed it): clamped, as in JAX
    assert snap["goodput/badput/kv_migrate_s"]["value"] == round(
        jled.snapshot()["badput_s"]["kv_migrate"], 6) == 0.2
    assert snap["goodput/wall_s"]["type"] == "gauge"
    with pytest.raises(ValueError, match="unknown badput bucket"):
        led.record("nope", 1.0)
    led.close()
    assert not any(k.startswith("goodput/") for k in reg.snapshot())
    prev = goodput.activate(led)
    assert goodput.active_ledger() is led
    assert goodput.accruing_bucket() == "recovery"
    goodput.activate(prev)
    assert goodput.accruing_bucket() == "idle"


def test_engine_feeds_live_ledger_like_jax():
    """The port's ``DisaggregatedEngine`` under pool pressure (replay
    preemptions, no rescue) feeds the live ledger the JAX engine's
    token counts: fresh equals the tokens generated, replayed the tokens
    re-generated after preemption, and ``kv_migrate`` is above 0."""
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    kw = dict(num_blocks=6, block_size=4, max_slots=4, max_prompt_len=16,
              num_decode=2, rescue=False, wire=True)
    prompts = [[7, 7, 7], [8, 8, 8, 8], [9, 9], [1, 2, 3]]
    counts = {}
    for name, mod, eng, req in (
            ("jax", jgoodput, JDis(jcfg, jparams, **kw), JRequest),
            ("port", goodput,
             DisaggregatedEngine(cfg, tparams, device="cpu", **kw),
             Request)):
        led = mod.GoodputLedger(register=False)
        prev = mod.activate(led)
        try:
            for i, p in enumerate(prompts):
                eng.submit(req(id=f"g{i}", tokens=tuple(p),
                               max_new_tokens=8))
            done = eng.run_until_idle()
        finally:
            mod.activate(prev)
        snap = led.snapshot()
        counts[name] = (led._fresh, led._replayed,
                        sum(r["replayed_tokens"] for r in done.values()))
        assert snap["badput_s"]["kv_migrate"] > 0
        ident = snap["goodput_s"] + sum(snap["badput_s"].values())
        assert ident == pytest.approx(snap["wall_s"])
    assert counts["port"] == counts["jax"]
    fresh, replayed, _ = counts["port"]
    assert fresh == 8 * len(prompts) - replayed and replayed > 0

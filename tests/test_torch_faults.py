"""Port parity: the fault-injection layer (``resilience/faults.py``) and
the engine's ``serve.step`` site against the JAX package on the CPU.

The same schedule over the same hit sequence fires at the same hits in
both packages (``events()`` equal: each rule draws from
``random.Random(f"{seed}:{idx}:{site}:{tag}")``); schedules round-trip
through JSON identically; and ``run_until_idle(retry_faults=True)`` on
the port's engine (and ``DisaggregatedEngine``) gives the JAX engine's
completions under the same ``serve.step`` schedule, at
``tiny(max_seq_len=64)`` in f32 on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.resilience import faults as jfaults
from distributed_tensorflow_tpu.serving import DisaggregatedEngine as JDis
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.serving import (
    DisaggregatedEngine, InferenceEngine)

ENGINE_KW = dict(num_blocks=32, block_size=8, max_slots=4,
                 max_prompt_len=16)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8], [3, 1, 4, 1, 5]]

# (site, tag) hits: two sites, per-tag and site-wide rules
HITS = ([("serve.step", i % 5) for i in range(40)]
        + [("coord.barrier", "b0")] * 10
        + [("serve.step", None)] * 10)
SCHEDULES = {
    "probability": dict(seed=3, rules=[dict(site="serve.step",
                                            probability=0.3)]),
    "tagged_hits": dict(seed=0, rules=[
        dict(site="serve.step", tag="2", hits=[1, 3, 5]),
        dict(site="serve.*", every=7, action="signal")]),
    "max_fires": dict(seed=11, rules=[
        dict(site="*", probability=0.5, max_fires=6, action="corrupt"),
        dict(site="coord.barrier", every=2)]),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig.tiny(max_seq_len=64)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig.tiny(max_seq_len=64)
    tparams = params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


def _drive(mod, schedule_dict):
    """Fire every hit of :data:`HITS` under the schedule; the firing log
    and the actions seen at the call sites."""
    schedule = mod.FaultSchedule(
        seed=schedule_dict["seed"],
        rules=tuple(mod.FaultRule.from_dict(r)
                    for r in schedule_dict["rules"]))
    seen = []
    with mod.inject(schedule):
        for site, tag in HITS:
            try:
                d = mod.fire(site, tag=tag)
                seen.append(None if d is None else d.action)
            except mod.FaultInjected:
                seen.append("raised")
        return mod.events(), seen, schedule.to_json()


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_same_schedule_same_events(name):
    fired0 = telemetry.get_registry().counter(
        "resilience/faults_fired").value
    events, seen, text = _drive(faults, SCHEDULES[name])
    jevents, jseen, jtext = _drive(jfaults, SCHEDULES[name])
    assert events == jevents and events
    assert seen == jseen
    assert text == jtext
    assert faults.FaultSchedule.from_json(jtext) == \
        faults.FaultSchedule.from_json(text)
    assert telemetry.get_registry().counter(
        "resilience/faults_fired").value - fired0 == len(events)
    assert not faults.active()


def test_rule_validation_matches():
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.FaultRule(site="x", action="explode")
    with pytest.raises(ValueError, match="unknown fault rule keys"):
        faults.FaultRule.from_dict({"site": "x", "bogus": 1})
    rule = faults.FaultRule.from_dict({"site": "serve.*", "p": 0.25,
                                       "hits": [1, 2], "tag": 3})
    assert rule.to_dict() == jfaults.FaultRule.from_dict(
        {"site": "serve.*", "p": 0.25, "hits": [1, 2], "tag": 3}).to_dict()
    assert faults.fire("serve.step", tag=0) is None     # nothing installed


def _submit_all(engine, request_cls, new=6):
    for i, p in enumerate(PROMPTS):
        engine.submit(request_cls(id=f"g{i}", tokens=tuple(p),
                                  max_new_tokens=new))


SERVE_CHAOS = faults.FaultSchedule(
    seed=7, rules=(faults.FaultRule(site="serve.step", probability=0.2),))


@pytest.mark.parametrize("kind", ["engine", "disaggregated"])
def test_retry_faults_gives_jax_completions(weights, kind):
    """``run_until_idle(retry_faults=True)`` under a seeded
    ``serve.step`` schedule: the same firings and the same completions
    as the JAX engine, equal to the fault-free streams, no request lost;
    without ``retry_faults`` the injected fault propagates."""
    from distributed_tensorflow_tpu.serving import Request as JRequest
    from distributed_tensorflow_tpu_torch.serving import Request
    jcfg, jparams, cfg, tparams = weights
    if kind == "engine":
        jeng = JEngine(jcfg, jparams, **ENGINE_KW)
        teng = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
        clean = InferenceEngine(cfg, tparams, device="cpu", **ENGINE_KW)
    else:
        jeng = JDis(jcfg, jparams, num_decode=2, wire=True, **ENGINE_KW)
        teng = DisaggregatedEngine(cfg, tparams, num_decode=2, wire=True,
                                   device="cpu", **ENGINE_KW)
        clean = DisaggregatedEngine(cfg, tparams, num_decode=2,
                                    device="cpu", **ENGINE_KW)
    _submit_all(clean, Request)
    want = {k: r["tokens"] for k, r in clean.run_until_idle().items()}
    jschedule = jfaults.FaultSchedule.from_json(SERVE_CHAOS.to_json())
    _submit_all(jeng, JRequest)
    with jfaults.inject(jschedule):
        jdone = jeng.run_until_idle(retry_faults=True)
        jevents = jfaults.events()
    _submit_all(teng, Request)
    with faults.inject(SERVE_CHAOS):
        done = teng.run_until_idle(retry_faults=True)
        events = faults.events()
    assert events == jevents and len(events) > 0
    assert {k: r["tokens"] for k, r in done.items()} == \
        {k: r["tokens"] for k, r in jdone.items()} == want
    assert sorted(done) == [f"g{i}" for i in range(len(PROMPTS))]
    acct = teng.block_accounting()
    assert acct["leaked_refs"] == 0 and acct["conserved"]

    _submit_all(teng, Request)
    always = faults.FaultSchedule(rules=(faults.FaultRule(
        site="serve.step"),))
    with faults.inject(always):
        with pytest.raises(faults.FaultInjected):
            teng.run_until_idle()
    assert teng.run_until_idle().keys() == want.keys()   # nothing lost

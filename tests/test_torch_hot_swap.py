"""Port parity: the in-place weight hot-swap
(``InferenceEngine.install_version``) and the scheduler's
``requeue_running`` against the JAX package on the CPU, at
``tiny(max_seq_len=64)`` in f32 with ``tests/test_rollout.py``'s
``ENGINE_KW``, on the same weights A (seed 0) and B (seed 7).

Flipped mid-flight, the port's engine gives the JAX engine's
completions: streams, the ``model_version`` step of each, ``requeued``
and ``cache_dropped``; every completion is wholly one version's (equal
to a fresh engine's on those weights); the prefix cache is fenced, so no
later hit adopts a block computed under A. A queued preemption replay is
made pristine, and a parameter tree of another shape raises
(JAX ``tests/test_rollout.py:200-230``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    InferenceEngine, Request)
from distributed_tensorflow_tpu_torch.telemetry import goodput

ENGINE_KW = dict(num_blocks=48, block_size=8, max_slots=4,
                 max_prompt_len=16, queue_capacity=64)
# eight requests sharing a 4-token prefix, so the cache holds entries
PROMPTS = [tuple(range(2, 2 + 4 + i % 3)) + (9, 9, 9, 9, 9 + i)
           for i in range(8)]


def _params(seed: int):
    jcfg = JConfig.tiny(max_seq_len=64)
    jp = JModel(jcfg).init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    jp = jp.unfreeze() if hasattr(jp, "unfreeze") else dict(jp)
    cfg = TransformerConfig.tiny(max_seq_len=64)
    return jp, params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


@pytest.fixture(scope="module")
def weights():
    return (JConfig.tiny(max_seq_len=64), TransformerConfig.tiny(
        max_seq_len=64), _params(0), _params(7))


def _requests(request_cls, new=5):
    return [request_cls(id=f"q{i}", tokens=p, max_new_tokens=new)
            for i, p in enumerate(PROMPTS)]


def _serve_with_swap(engine, request_cls, params_b):
    for r in _requests(request_cls):
        engine.submit(r)
    out, info = {}, None
    while not engine.scheduler.idle:
        for rec in engine.step():
            out[rec["id"]] = (tuple(rec["tokens"]),
                              int(rec["model_version"].split("@")[0]))
        # swap once some A completions landed, mid-flight for the rest
        if info is None and len(out) >= 2:
            running = len(engine.scheduler.running)
            info = engine.install_version(params_b, step=2)
            assert info["requeued"] == running > 0
    return out, info


def _fresh(engine_cls, cfg, params, request_cls, **kw):
    eng = engine_cls(cfg, params, **kw)
    for r in _requests(request_cls):
        eng.submit(r)
    return {k: tuple(r["tokens"]) for k, r in eng.run_until_idle().items()}


@pytest.mark.parametrize("spec", [0, 2])
def test_install_version_matches_jax(weights, spec):
    """Mid-flight swap A -> B with prefix caching (and with speculation,
    whose default draft is re-derived from B): the port's completions
    equal the JAX engine's, each wholly A's or B's."""
    jcfg, cfg, (ja, ta), (jb, tb) = weights
    kw = dict(ENGINE_KW, prefix_caching=True, speculative_k=spec)
    jeng = JEngine(jcfg, ja, snapshot_step=1, **kw)
    teng = InferenceEngine(cfg, ta, device="cpu", snapshot_step=1, **kw)
    swaps0 = telemetry.get_registry().counter("serving/weight_swaps").value
    led = goodput.GoodputLedger(register=False)
    prev = goodput.activate(led)
    try:
        got, tinfo = _serve_with_swap(teng, Request, tb)
    finally:
        goodput.activate(prev)
    want, jinfo = _serve_with_swap(jeng, JRequest, jb)
    assert got == want
    for k in ("step", "requeued", "cache_dropped"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["cache_dropped"] > 0
    assert teng.weights_step == 2 and teng.stats()["swaps"] == 1
    assert telemetry.get_registry().counter(
        "serving/weight_swaps").value == swaps0 + 1
    assert led.snapshot()["badput_s"]["rollout"] > 0
    ts, js = (teng.stats()["prefix_cache"], jeng.stats()["prefix_cache"])
    assert ts == js and ts["fences"] == 1
    refs = {1: _fresh(InferenceEngine, cfg, ta, Request, device="cpu",
                      **ENGINE_KW),
            2: _fresh(InferenceEngine, cfg, tb, Request, device="cpu",
                      **ENGINE_KW)}
    assert refs[1] != refs[2]
    for rid, (tokens, step) in got.items():
        assert tokens == refs[step][rid], f"{rid} mixed versions"
    assert {step for _, step in got.values()} == {1, 2}
    assert sorted(got) == sorted(f"q{i}" for i in range(len(PROMPTS)))
    acct = teng.block_accounting()
    assert acct["leaked_refs"] == 0 and acct["conserved"]


def test_requeue_sanitizes_preemption_replay(weights):
    _, cfg, (_, ta), _ = weights
    eng = InferenceEngine(cfg, ta, device="cpu", **ENGINE_KW)
    replay = Request(id="replay", tokens=(2, 3, 4, 5, 9, 9),
                     max_new_tokens=3, generated_prefix=(9, 9))
    eng.submit(_requests(Request)[0])
    eng.step()                        # something running mid-decode
    eng.scheduler.queue.submit(replay)
    assert eng.scheduler.requeue_running() == 1
    assert not eng.scheduler.running
    rep = {r.id: r for r in eng.scheduler.queue._q}["replay"]
    assert rep.generated_prefix == ()
    assert rep.tokens == (2, 3, 4, 5)
    assert rep.max_new_tokens == 5
    assert eng.scheduler.queue._q[0].id == "q0"   # back at the front
    acct = eng.block_accounting()
    assert acct["free"] == acct["usable"] and acct["leaked_refs"] == 0


def test_swap_rejects_mismatched_tree(weights):
    _, cfg, (_, ta), _ = weights
    eng = InferenceEngine(cfg, ta, device="cpu", **ENGINE_KW)
    bad_cfg = JConfig.tiny(max_seq_len=64, d_model=96)
    bad = JModel(bad_cfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]
    bad = params_from_jax(
        TransformerConfig.tiny(max_seq_len=64, d_model=96),
        jax.tree_util.tree_map(np.asarray, bad), device="cpu")
    before = eng.weights_version
    with pytest.raises(ValueError, match="swap"):
        eng.install_version(bad, step=2)
    assert eng.weights_version == before and eng.swaps == 0

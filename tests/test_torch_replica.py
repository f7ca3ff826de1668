"""The port's supervised serving replica against the JAX engine: two
``serving_replica``s of the port under the port's
``RecoverySupervisor`` on the CPU serve JAX's seeded workload from a
checkpoint the JAX package wrote of its own ``PRNGKey(0)`` tiny
weights, and one replica is SIGKILLed mid-load. The union of the
completion logs covers every request, and every completed stream —
duplicates of the killed generation included — equals the JAX
``InferenceEngine``'s greedy tokens for the same request, run
in-process (exact). The wire helpers and the seeded generators equal
JAX's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.checkpoint.checkpoint import (
    Checkpoint as JCheckpoint, CheckpointManager as JManager)
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import replica as jax_replica
from distributed_tensorflow_tpu_torch.resilience import (
    RecoverySupervisor, seeded_kill_plan)
from distributed_tensorflow_tpu_torch.serving import replica as pt_replica
from distributed_tensorflow_tpu_torch.serving import Request

N_REQUESTS, SEED = 16, 3


def _fields(r):
    return (r.id, r.tokens, r.max_new_tokens, r.eos_id, r.arrival_s,
            r.tenant, r.pclass)


def test_generators_and_wire():
    for seed in (0, 5):
        assert [_fields(r) for r in pt_replica.seeded_requests(
            seed, 20, 256, prompt_range=(128, 512),
            new_tokens_range=(16, 64))] == [
            _fields(r) for r in jax_replica.seeded_requests(
                seed, 20, 256, prompt_range=(128, 512),
                new_tokens_range=(16, 64))]
        assert [_fields(r) for r in pt_replica.seeded_spike_schedule(
            seed, vocab_size=32768)] == [
            _fields(r) for r in jax_replica.seeded_spike_schedule(
                seed, vocab_size=32768)]
    r = Request(id="acme-0003", tokens=(5, 6, 7), max_new_tokens=4,
                arrival_s=1.25, tenant="acme", pclass="batch")
    meta = {"tenant": "acme", "pclass": "batch", "reroute": True}
    wire = pt_replica.request_to_wire(r, meta)
    assert wire == jax_replica.request_to_wire(r, meta)
    assert _fields(pt_replica.request_from_wire(wire)) == \
        _fields(jax_replica.request_from_wire(wire))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX-written checkpoint of JAX's own tiny weights, and the JAX
    engine's greedy streams for the seeded workload."""
    cfg = JConfig.tiny(max_seq_len=64)
    params = JModel(cfg).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    JManager(JCheckpoint(params=jax.tree_util.tree_map(
        np.asarray, dict(params))), d).save(1)
    eng = JEngine(cfg, params, num_blocks=48, block_size=8, max_slots=4,
                  max_prompt_len=16, queue_capacity=N_REQUESTS + 1)
    for r in jax_replica.seeded_requests(SEED, N_REQUESTS, 256):
        eng.submit(r)
    want = {rid: list(rec["tokens"])
            for rid, rec in eng.run_until_idle().items()}
    assert len(want) == N_REQUESTS
    return d, want


def test_supervised_replicas_match_jax_engine(tmp_path, jax_ckpt):
    ckpt, want = jax_ckpt
    run_dir = str(tmp_path)
    plan = seeded_kill_plan(1, 2, kills=1, step_range=(4, 8))
    sup = RecoverySupervisor(
        pt_replica.serving_replica, num_workers=2,
        args=(run_dir, N_REQUESTS, SEED),
        kwargs={"engine_kwargs": {"device": "cpu"}, "ckpt_dir": ckpt,
                "step_delay_s": 0.05},
        device="cpu", kill_plan=plan, max_restarts=2,
        generation_timeout_s=120.0,
        telemetry_dir=os.path.join(run_dir, "telemetry"))
    result = sup.run()
    assert sup.generation == 1
    assert [f.kind for f in sup.history] == ["killed"]
    assert sorted(v[0] for v in result.return_values) == [0, 1]
    union = pt_replica.completed_ids_all(run_dir)
    assert union == want
    # every line, the killed generation's duplicates too, is JAX's
    lines = 0
    for task in (0, 1):
        with open(os.path.join(run_dir, f"served-{task}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                assert rec["tokens"] == want[rec["id"]], rec["id"]
                lines += 1
    assert lines >= N_REQUESTS
    # every replica that served published its launch counters (all 0
    # here: tiny takes the reference attention on the CPU): the killed
    # one in generation 0 (its survivor may have been killed before it
    # served), both in generation 1
    for task, g in ((plan[0].worker, 0), (0, 1), (1, 1)):
        assert os.path.exists(pt_replica.launches_path(run_dir, task, g))

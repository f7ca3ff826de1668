"""Port parity: the scenarios of ``tests/test_torch_chaos.py`` against
the JAX package's ``tests/test_chaos.py`` on the same seeds.

- The fault firing sequence of the determinism scenario (seeded
  probabilistic KV faults and periodic barrier delays over 48 round
  trips) is exactly JAX's, outcome for outcome and event for event, and
  so is the barrier scenario's (a timeout on the first hit, retried).
- The torn checkpoint and the bit-rotted one are refused at the same
  steps as JAX refuses them: the same save names, the same listing and
  latest checkpoint, a ``CheckpointCorruptError`` naming the same cause
  (size or crc32), the same ``checkpoint.commit`` firing.
- The MNIST preemption scenario from JAX's ``PRNGKey(0)`` weights
  (``params_from_jax``): the preemption fires at the same run call, the
  same step is saved and resumed, and the stitched losses are JAX's
  stitched losses: the first within ``tests/test_torch_mnist.py``'s
  2e-6, every one within the tolerance JAX's scenario holds its own
  stitched run to, ``rtol=1e-4, atol=1e-6`` (Adam at lr 1e-2 drives the
  loss up to ~100 in the first steps and carries the packages' f32
  rounding into the later losses: measured 6.2e-4 at a loss of 31.1,
  2e-5 relative).
"""

import os

import jax
import numpy as np
import pytest

import test_chaos as jax_chaos
import test_torch_chaos as port_chaos
from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.cluster import coordination as jcoord
from distributed_tensorflow_tpu.models import mnist_cnn as jmnist
from distributed_tensorflow_tpu.resilience import (
    FaultRule, FaultSchedule, RetryPolicy, faults as jfaults)
from distributed_tensorflow_tpu_torch.cluster import coordination as pcoord
from distributed_tensorflow_tpu_torch.models import mnist_cnn as pmnist

SEEDS = [0, 1, 7, 42]


@pytest.fixture()
def agents():
    """A fresh in-process coordination service in each package."""
    old = (jcoord._LOCAL, pcoord._LOCAL)
    jcoord._LOCAL = jcoord._LocalService()
    pcoord._LOCAL = pcoord._LocalService()
    ja, pa = jcoord.CoordinationServiceAgent(), pcoord.CoordinationServiceAgent()
    ja._local, pa._local = jcoord._LOCAL, pcoord._LOCAL
    yield ja, pa
    jcoord._LOCAL, pcoord._LOCAL = old


def _jax_fault_sequence(agent, seed):
    """JAX's determinism scenario (``test_fault_sequence_reproduces_
    bit_identically``) on its own modules."""
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="coord.kv_get", probability=0.3),
        FaultRule(site="coord.barrier", every=3, action="delay",
                  delay_s=0.0)])
    outcomes = []
    with jfaults.inject(sched) as reg:
        for i in range(48):
            agent.key_value_set(f"k/{i}", b"v")
            try:
                agent.key_value_get(f"k/{i}", timeout_s=1)
                outcomes.append("get-ok")
            except jcoord.CoordinationError:
                outcomes.append("get-fault")
            agent.barrier(f"b/{i}", timeout_s=1)
        return outcomes, reg.events()


def _jax_barrier_events(agent, seed):
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="coord.barrier", tag="epoch", hits=(1,))])
    policy = RetryPolicy(max_attempts=3, initial_backoff_s=0.01,
                         retryable=(jcoord.BarrierTimeoutError,))
    attempts = []
    with jfaults.inject(sched) as reg:
        policy.call(lambda: (attempts.append(1),
                             agent.barrier("epoch", timeout_s=5)))
        return len(attempts), reg.events()


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_sequence_is_jaxs(agents, seed):
    ja, pa = agents
    want = _jax_fault_sequence(ja, seed)
    got = port_chaos.fault_sequence(pa, seed)
    assert got == want
    assert "get-fault" in got[0] and "get-ok" in got[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_barrier_retry_is_jaxs(agents, seed):
    ja, pa = agents
    assert port_chaos.barrier_events(pa, seed) == _jax_barrier_events(
        ja, seed) == (2, [("coord.barrier", "epoch", 1, "raise", 0)])


def _jax_torn(tmp_path, seed):
    state = {"w": np.arange(64.0).reshape(8, 8)}
    mgr = jckpt.CheckpointManager(jckpt.Checkpoint(state=state),
                                  str(tmp_path), checkpoint_name="t")
    good = mgr.save()
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="checkpoint.commit", action="corrupt", hits=(1,))])
    with jfaults.inject(sched) as reg:
        torn = mgr.save()
        fired = reg.events()
    try:
        jckpt.Checkpoint(state=state).restore(torn)
        refused = None
    except jckpt.CheckpointCorruptError as e:
        refused = str(e)
    return {"good": os.path.basename(good), "torn": os.path.basename(torn),
            "latest": os.path.basename(mgr.latest_checkpoint),
            "listed": [os.path.basename(p) for p in mgr.checkpoints],
            "refused": refused, "fired": fired}


def _cause(message):
    return [c for c in ("torn", "bytes", "crc32") if c in (message or "")]


@pytest.mark.parametrize("seed", SEEDS)
def test_torn_checkpoint_refused_as_jax(tmp_path, seed):
    want = _jax_torn(tmp_path / "jax", seed)
    got = port_chaos.torn_checkpoint(tmp_path / "port", seed)
    for key in ("good", "torn", "latest", "listed"):
        assert got[key] == want[key], key
    # the site's tag is the save's path: the same save in each directory
    assert [(site, os.path.basename(tag), *rest)
            for site, tag, *rest in got["fired"]] == [
        (site, os.path.basename(tag), *rest)
        for site, tag, *rest in want["fired"]] == [
        ("checkpoint.commit", "t-2", 1, "corrupt", 0)]
    assert want["refused"] and got["refused"]
    assert _cause(got["refused"]) == _cause(want["refused"])
    assert got["restored"]


def test_crc_checkpoint_refused_as_jax(tmp_path):
    state = {"w": np.ones(32)}
    mgr = jckpt.CheckpointManager(jckpt.Checkpoint(state=state),
                                  str(tmp_path / "jax"), checkpoint_name="c")
    path = mgr.save()
    shard = os.path.join(path, "shard_0.npz")
    data = bytearray(open(shard, "rb").read())
    data[-8] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(data)
    with pytest.raises(jckpt.CheckpointCorruptError) as e:
        jckpt.Checkpoint(state=state).restore(path)
    got = port_chaos.crc_checkpoint(tmp_path / "port")
    assert got["path"] == os.path.basename(path)
    assert got["latest"] == os.path.basename(mgr.latest_checkpoint)
    assert _cause(got["refused"]) == _cause(str(e.value)) == ["crc32"]


def test_mnist_preemption_matches_jax(tmp_path):
    seed = 42
    total, preempt_hit = 12, 5
    data = jmnist.synthetic_data(n=256, seed=0)
    base, _, _ = jax_chaos._mnist_run(tmp_path / "jax_base", total, data)
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="preemption.signal", action="signal",
                  hits=(preempt_hit,))])
    with jfaults.inject(sched) as reg:
        l1, r1, h1 = jax_chaos._mnist_run(tmp_path / "jax_job", total, data)
        jax_fired = [e[0] for e in reg.events()]
    l2, r2, _ = jax_chaos._mnist_run(tmp_path / "jax_job", total, data)
    jax_stitched = l1 + l2

    init = jax.tree_util.tree_map(
        np.asarray, jmnist.create_train_state(jax.random.PRNGKey(0))[0][
            "params"])
    r = port_chaos.mnist_preemption(
        tmp_path / "port", seed,
        lambda: pmnist.params_from_jax(init, device="cpu"))
    assert r["fired"] == jax_fired == ["preemption.signal"]
    assert (r["resumed1"], r["resumed2"]) == (r1, r2) == (0, preempt_hit)
    assert r["latest"] == f"mnist-{preempt_hit}"
    assert r["exited1"] and h1._exited
    stitched = r["losses1"] + r["losses2"]
    assert len(stitched) == len(jax_stitched) == total
    assert abs(stitched[0] - jax_stitched[0]) <= 2e-6
    np.testing.assert_allclose(stitched, jax_stitched, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r["base"], base, rtol=1e-4, atol=1e-6)

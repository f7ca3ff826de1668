"""Chaos suite on the port: the failure paths, actually fired.

The port's counterpart of ``tests/test_chaos.py``: its eight scenarios on
the port's modules, under the port's deterministic fault-injection layer
(``resilience/faults.py``). It imports torch and the port only, so
``tools/torch_chaos_sweep.py`` runs it with ``python -m pytest
--noconftest`` where JAX is not installed (``tests/conftest.py`` imports
it); the ``chaos``, ``slow`` and ``multiprocess`` markers that conftest
registers then go unregistered, which pytest only warns about:

- a closure whose worker "dies" is retried off it and completes (and the
  health tracker quarantines the dying lane);
- a barrier that times out once succeeds under the shared RetryPolicy;
- a torn checkpoint (shard truncated after commit) is detected and
  skipped by ``CheckpointManager.latest_checkpoint``, and ``restore``
  refuses it with ``CheckpointCorruptError``; bit rot at the same size
  fails the crc32;
- an MNIST run survives an injected mid-run preemption, resumes from the
  agreed save step, and matches the uninterrupted run;
- the same seed reproduces the same fault firing sequence bit-for-bit,
  and with no schedule installed every site is a no-op;
- (slow) a preemption notice on one of two processes: both agree and
  commit one checkpoint at the same step.

``DTX_CHAOS_SEED`` selects the schedule seed (default 42) and
``DTX_CHAOS_DEVICE`` the MNIST run's device (default ``cpu``; the sweep
passes its ``--device``).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    Checkpoint,
    CheckpointCorruptError,
    CheckpointManager,
)
from distributed_tensorflow_tpu_torch.checkpoint.failure_handling import (
    PreemptionCheckpointHandler,
    TerminationConfig,
)
from distributed_tensorflow_tpu_torch.cluster import coordination
from distributed_tensorflow_tpu_torch.cluster.coordination import (
    BarrierTimeoutError,
    CoordinationError,
    CoordinationServiceAgent,
)
from distributed_tensorflow_tpu_torch.models import mnist_cnn
from distributed_tensorflow_tpu_torch.resilience import (
    FaultRule,
    FaultSchedule,
    RetryPolicy,
    WorkerHealthTracker,
    faults,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_train_mnist  # noqa: E402

pytestmark = pytest.mark.chaos

SEED = int(os.environ.get("DTX_CHAOS_SEED", "42"))
DEVICE = os.environ.get("DTX_CHAOS_DEVICE", "cpu")


@pytest.fixture()
def agent():
    old = coordination._LOCAL
    coordination._LOCAL = coordination._LocalService()
    a = CoordinationServiceAgent()
    a._local = coordination._LOCAL
    yield a
    coordination._LOCAL = old


# ---------------------------------------------------------------------------
# closure failover + quarantine
# ---------------------------------------------------------------------------

def test_closure_retried_off_killed_worker_completes():
    """Worker lane 0 'dies' (every execution raises the retryable
    preemption error): each of its closures is transparently re-run on a
    surviving lane, all results land, and the health tracker benches the
    dying lane after the failure threshold."""
    from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator \
        import Cluster

    def work(x):
        time.sleep(0.03)           # long enough for lane 0 to keep
        return x * x               # grabbing (and failing) work

    sched = FaultSchedule(seed=SEED, rules=[
        FaultRule(site="closure.execute", tag="0", action="raise")])
    health = WorkerHealthTracker(failure_threshold=2, quarantine_s=60.0)
    with faults.inject(sched) as reg:
        cluster = Cluster(num_workers=2, health=health, device="cpu")
        try:
            rvs = [cluster.schedule(work, (i,), {}) for i in range(8)]
            cluster.join(timeout=60)
            values = sorted(rv.fetch(timeout=10) for rv in rvs)
        finally:
            cluster.stop()
        assert values == sorted(i * i for i in range(8))
        # the dying lane really fired and got benched
        fired = [e for e in reg.events() if e[0] == "closure.execute"]
        assert len(fired) >= 2
        assert cluster.workers[0].failures >= 2
        assert health.is_quarantined(0)
        assert health.healthy_workers() == [1]


# ---------------------------------------------------------------------------
# barrier timeout, retried
# ---------------------------------------------------------------------------

def barrier_events(agent, seed: int) -> tuple:
    """JAX's barrier scenario: a barrier that times out once under the
    seeded rule, retried; the attempts and the firing log."""
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="coord.barrier", tag="epoch", hits=(1,))])
    policy = RetryPolicy(max_attempts=3, initial_backoff_s=0.01,
                         retryable=(BarrierTimeoutError,))
    attempts = []
    with faults.inject(sched) as reg:
        policy.call(lambda: (attempts.append(1),
                             agent.barrier("epoch", timeout_s=5)))
        return len(attempts), reg.events()


def test_barrier_times_out_once_then_succeeds(agent):
    attempts, events = barrier_events(agent, SEED)
    assert attempts == 2                   # timed out once, then passed
    assert events == [("coord.barrier", "epoch", 1, "raise", 0)]


# ---------------------------------------------------------------------------
# torn checkpoint
# ---------------------------------------------------------------------------

def torn_checkpoint(tmp_path, seed: int) -> dict:
    """JAX's torn-checkpoint scenario: an intact save, then one whose
    shard is torn after commit under the seeded rule; what the manager
    lists and what a restore of each does."""
    state = {"w": np.arange(64.0).reshape(8, 8)}
    mgr = CheckpointManager(Checkpoint(state=state), str(tmp_path),
                            checkpoint_name="t")
    good = mgr.save()                      # t-1: intact
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="checkpoint.commit", action="corrupt", hits=(1,))])
    with faults.inject(sched) as reg:
        torn = mgr.save()                  # t-2: shard torn post-commit
        fired = reg.events()
    try:
        Checkpoint(state=state).restore(torn)
        refused = None
    except CheckpointCorruptError as e:
        refused = str(e)
    got = Checkpoint(state={"w": np.zeros((8, 8))}).restore(good)
    return {"good": os.path.basename(good), "torn": os.path.basename(torn),
            "torn_index": os.path.exists(
                os.path.join(torn, "checkpoint.index.json")),
            "latest": os.path.basename(mgr.latest_checkpoint),
            "listed": [os.path.basename(p) for p in mgr.checkpoints],
            "refused": refused, "fired": fired,
            "restored": np.array_equal(got["state/w"], state["w"])}


def test_torn_checkpoint_detected_and_skipped(tmp_path):
    r = torn_checkpoint(tmp_path, SEED)
    # the torn save LOOKS committed (index on disk) but fails its size
    # record, so latest/rotation skip it...
    assert r["torn_index"]
    assert r["latest"] == r["good"] and r["listed"] == [r["good"]]
    # ...and a direct restore refuses it loudly
    assert r["refused"] is not None
    assert "torn" in r["refused"] or "bytes" in r["refused"]
    # the intact one restores fine
    assert r["restored"]


def crc_checkpoint(tmp_path) -> dict:
    """JAX's bit-rot scenario: a committed shard's bytes flipped at the
    same size; what the manager lists and what a restore does."""
    state = {"w": np.ones(32)}
    mgr = CheckpointManager(Checkpoint(state=state), str(tmp_path),
                            checkpoint_name="c")
    path = mgr.save()
    shard = os.path.join(path, "shard_0.npz")
    data = bytearray(open(shard, "rb").read())
    data[-8] ^= 0xFF                       # flip bits near the end
    with open(shard, "wb") as f:
        f.write(data)
    try:
        Checkpoint(state=state).restore(path)
        refused = None
    except CheckpointCorruptError as e:
        refused = str(e)
    return {"path": os.path.basename(path),
            "latest": os.path.basename(mgr.latest_checkpoint),
            "refused": refused}


def test_corrupt_shard_fails_crc_even_at_same_size(tmp_path):
    """Bit rot (not truncation): same size, different bytes — caught by
    the crc32 the index records per shard."""
    r = crc_checkpoint(tmp_path)
    assert r["latest"] == r["path"]       # size matches: listing keeps it
    assert r["refused"] is not None and "crc32" in r["refused"]


# ---------------------------------------------------------------------------
# MNIST survives preemption
# ---------------------------------------------------------------------------

def _mnist_batch(data, t, batch=64):
    n = data["image"].shape[0] // batch
    i = t % n
    return {k: v[i * batch:(i + 1) * batch] for k, v in data.items()}


def mnist_run(path, total_steps, data, make_model, device=DEVICE):
    """One incarnation of a preemptible MNIST job (JAX's ``_mnist_run``):
    restore if a checkpoint exists, train under the preemption handler
    until done or preempted. ``make_model()`` gives the fresh model.
    Returns (losses_this_incarnation, resumed_from, handler)."""
    model = make_model()
    opt = mnist_cnn.make_optimizer(model.parameters(), 1e-2)
    step_fn = mnist_cnn.make_train_step(model, opt)
    state = {"model": model, "optimizer": opt, "step": 0}
    ckpt = Checkpoint(t=np.asarray(0),
                      **torch_train_mnist._state_tree(model, opt))
    mgr = CheckpointManager(ckpt, str(path), checkpoint_name="mnist")
    handler = PreemptionCheckpointHandler(
        mgr, TerminationConfig(exit_fn=lambda: None))
    t = 0
    if mgr.latest_checkpoint:
        flat = ckpt.restore(mgr.latest_checkpoint)
        torch_train_mnist._load_state(model, opt, flat)
        t = int(np.asarray(flat["t"]))

    losses = []
    resumed_from = t

    def step():
        nonlocal state, t
        state, metrics = step_fn(state, _mnist_batch(data, t))
        t += 1
        losses.append(float(metrics["loss"]))
        # keep the tracked objects at the just-completed step so a save
        # triggered right after this fn returns snapshots exactly here
        ckpt._objects.update(torch_train_mnist._state_tree(model, opt))
        ckpt._objects["t"] = np.asarray(t)

    while t < total_steps and not handler._exited:
        handler.run(step)
    return losses, resumed_from, handler


def mnist_preemption(tmp_path, seed: int, make_model) -> dict:
    """JAX's MNIST scenario: an uninterrupted run, then one preempted on
    the handler's 5th run call and resumed by a fresh incarnation."""
    total, preempt_hit = 12, 5
    data = mnist_cnn.synthetic_data(n=256, seed=0)
    base_losses, _, _ = mnist_run(tmp_path / "base", total, data,
                                  make_model)
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="preemption.signal", action="signal",
                  hits=(preempt_hit,))])
    with faults.inject(sched) as reg:
        losses1, resumed1, h1 = mnist_run(tmp_path / "job", total, data,
                                          make_model)
        fired = [e[0] for e in reg.events()]
    latest = CheckpointManager(Checkpoint(), str(tmp_path / "job"),
                               checkpoint_name="mnist").latest_checkpoint
    losses2, resumed2, h2 = mnist_run(tmp_path / "job", total, data,
                                      make_model)
    return {"base": base_losses, "losses1": losses1, "losses2": losses2,
            "resumed1": resumed1, "resumed2": resumed2,
            "exited1": h1._exited, "exited2": h2._exited,
            "fired": fired, "latest": os.path.basename(latest),
            "total": total, "preempt_hit": preempt_hit}


def test_mnist_e2e_survives_injected_preemption(tmp_path):
    """The acceptance scenario: a mid-run preemption notice lands via the
    chaos layer, the handler checkpoints at the agreed step and 'exits';
    a fresh incarnation restores from that exact step and the stitched
    run matches an uninterrupted one step-for-step."""
    r = mnist_preemption(tmp_path, SEED, lambda: mnist_cnn.create_train_state(
        0, 1e-2, device=DEVICE)[1])
    assert len(r["base"]) == r["total"]
    assert r["fired"] == ["preemption.signal"]
    assert r["exited1"] and r["resumed1"] == 0
    assert len(r["losses1"]) == r["preempt_hit"]  # stopped at agreement
    # the committed checkpoint is AT the agreed save step
    assert r["latest"] == f"mnist-{r['preempt_hit']}"
    assert r["resumed2"] == r["preempt_hit"]     # resumed from that step
    assert not r["exited2"]
    assert len(r["losses2"]) == r["total"] - r["preempt_hit"]
    np.testing.assert_allclose(r["losses1"] + r["losses2"], r["base"],
                               rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def fault_sequence(agent, seed: int) -> tuple:
    """JAX's determinism scenario: seeded probabilistic and periodic
    rules over 48 KV round trips and barriers; the outcomes and the
    firing log."""
    sched = FaultSchedule(seed=seed, rules=[
        FaultRule(site="coord.kv_get", probability=0.3),
        FaultRule(site="coord.barrier", every=3, action="delay",
                  delay_s=0.0)])
    outcomes = []
    with faults.inject(sched) as reg:
        for i in range(48):
            agent.key_value_set(f"k/{i}", b"v")
            try:
                agent.key_value_get(f"k/{i}", timeout_s=1)
                outcomes.append("get-ok")
            except CoordinationError:
                outcomes.append("get-fault")
            agent.barrier(f"b/{i}", timeout_s=1)
        return outcomes, reg.events()


def test_fault_sequence_reproduces_bit_identically(agent):
    """Same seed, same scenario => the same hits fire the same actions in
    the same order — a chaos failure is replayable from its seed."""
    out_a, ev_a = fault_sequence(agent, SEED)
    out_b, ev_b = fault_sequence(agent, SEED)
    assert out_a == out_b
    assert ev_a == ev_b
    assert any(o == "get-fault" for o in out_a)
    assert any(e[0] == "coord.barrier" for e in ev_a)


def test_disabled_injection_leaves_dispatch_paths_untouched():
    """No schedule installed: every instrumented site is a no-op None
    check — the hot paths run exactly as before the chaos layer."""
    assert not faults.active()
    for site in ("coord.kv_get", "coord.barrier", "dispatch.wait",
                 "closure.execute", "checkpoint.commit",
                 "preemption.signal"):
        assert faults.fire(site, tag="x") is None
    assert faults.events() == []


# ---------------------------------------------------------------------------
# multi-process chaos (heavy: spawns real processes — out of tier-1)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.multiprocess
def test_chaos_preemption_agreement_across_processes(tmp_path):
    import torch_chaos_ranks
    from distributed_tensorflow_tpu_torch.testing import (
        multi_process_runner as mpr)
    result = mpr.run(torch_chaos_ranks.chaos_preemption_worker,
                     num_workers=2, args=(str(tmp_path), SEED),
                     device="cpu", timeout=240)
    by_proc = {v[0]: v[1:] for v in result.return_values}
    assert by_proc[0][0] is not None and by_proc[0][0] == by_proc[1][0], \
        by_proc
    cks = [d for d in os.listdir(tmp_path) if d.startswith("chaos-")
           and os.path.isdir(tmp_path / d)]
    assert len(cks) == 1
    files = os.listdir(tmp_path / cks[0])
    assert "checkpoint.index.json" in files
    assert "shard_0.npz" in files and "shard_1.npz" in files

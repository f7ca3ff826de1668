"""Port parity: ``train_and_evaluate`` with an evaluator task
(``coordinator/evaluator.py``), as JAX's ``tests/test_multi_process.py
:662-735`` drives it, on the port's checkpoints: two trainers in a gloo
process group save checkpoints 1..3 under rotation; the evaluator task,
outside the group (no process group of its own, world 2), evaluates
them as they rotate, stops at the final one with each metric equal to
its step, writes TensorBoard summaries, and reads the chief's KV key
through its store client. ``SidecarEvaluator`` alone walks every
unseen checkpoint in order, skips one that is mid-write, and stops when
idle — as JAX's does on the same directory."""

import os

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import checkpoint as jck
from distributed_tensorflow_tpu.coordinator import evaluator as jev
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tck
from distributed_tensorflow_tpu_torch.coordinator import evaluator as tev
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_cluster_ranks


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tne")
    result = multi_process_runner.run(
        torch_cluster_ranks.train_and_evaluate_task, 2, has_evaluator=True,
        args=(str(tmp),), device="cpu", timeout=240)
    return tmp, result.return_values


def test_trainers_and_evaluator(cluster):
    tmp, values = cluster
    trainers = [v for v in values if v[0] == "trainer"]
    evals = [v for v in values if v[0] == "evaluator"]
    assert sorted(v[1] for v in trainers) == [0, 1]
    assert all(v[2] == 2 for v in trainers)        # the evaluator is out
    assert len(evals) == 1
    _, evaluated, seen, in_group, grouped = evals[0]
    assert seen == "hello" and in_group is False and grouped is False
    steps = [s for s, _ in evaluated]
    assert steps[-1] == 3 and steps == sorted(set(steps))
    for s, m in evaluated:
        assert m["w"] == float(s)
    logs = os.listdir(tmp / "eval_logs")
    assert any("events.out.tfevents" in f for f in logs), logs


def _write(mod, root, steps, value):
    ckpt = mod.Checkpoint(w=value(0.0))
    mgr = mod.CheckpointManager(ckpt, str(root), checkpoint_name="ev",
                                max_to_keep=10)
    for s in steps:
        ckpt._objects["w"] = value(float(s))
        mgr.save(checkpoint_number=s)


def test_sidecar_evaluator_walks_like_jax(tmp_path):
    _write(tck, tmp_path, (1, 2, 5), lambda v: torch.tensor(v))
    (tmp_path / "ev-7").mkdir()            # mid-write: no index yet
    got = {}
    for name, mod, ck, zero in (
            ("jax", jev, jck, np.zeros(())),
            ("port", tev, tck, torch.zeros(()))):
        for every in (True, False):
            ev = mod.SidecarEvaluator(
                ck.Checkpoint(w=zero), str(tmp_path),
                lambda c, step: {"w": float(np.asarray(c._objects["w"]))},
                checkpoint_name="ev", poll_interval_s=0.05,
                idle_timeout_s=0.3, evaluate_every_checkpoint=every)
            got[(name, every)] = ev.run()
    assert got[("port", True)] == got[("jax", True)] == [
        (1, {"w": 1.0}), (2, {"w": 2.0}), (5, {"w": 5.0})]
    assert got[("port", False)] == got[("jax", False)] == [(5, {"w": 5.0})]
    with pytest.raises(ValueError, match="-<number>"):
        tev.SidecarEvaluator._step_of("no_number")

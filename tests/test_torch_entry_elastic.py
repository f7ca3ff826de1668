"""The port's supervised MNIST run on the CPU against itself and JAX's.

Both runs below start from JAX's ``PRNGKey(0)`` parameters, converted
(``torch_train_mnist.run(args, params=)``).

- ``tools/torch_train_mnist.py --elastic --workers 2`` with one seeded
  kill (``--kill-seed 0``) recovers: one restart, the workers resumed
  from a snapshot or checkpoint tier at a step of the killed
  generation. Every worker's final loss equals the uninterrupted run's
  bit for bit (two gloo ranks of one intra-op thread each: the resumed
  steps compute on the restored state the same sums in the same order).
- The uninterrupted run's losses against JAX's ``elastic_worker``
  (``examples/train_mnist.py``) run alone, a subprocess of one process
  at the whole global batch: each step's loss is the mean of the two
  ranks' half-batch losses (the meaned gradient is the whole batch's).
  The first step, before any update, is within 2e-6, the loss
  tolerance of ``tests/test_torch_mnist.py``. All sixteen are within
  1e-4, that test's parameter tolerance: Adam divides each gradient by
  about its own size, so the packages' f32 rounding grows step by step
  (measured 4.8e-7 at step 2 and 5.39e-5 at step 3, where the loss
  jumps from 14.5 to 13.3).
"""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from distributed_tensorflow_tpu.models import mnist_cnn as jm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_train_mnist  # noqa: E402

STEPS, SAVE_EVERY, GLOBAL_BATCH, LR = 16, 4, 64, 1e-3
FIRST_TOL, TOL = 2e-6, 1e-4


def step_losses(run_dir) -> list:
    """Each step's loss: the mean over the ranks' ``train.step`` events
    of the last generation that ran the step."""
    by_step = {}
    for path in glob.glob(os.path.join(run_dir, "events-[0-9]*.jsonl")):
        with open(path) as f:
            for line in f:
                ev = json.loads(line)
                if ev["ev"] == "train.step":
                    key = (ev["step"], ev.get("gen", 0))
                    by_step.setdefault(key, []).append(ev["loss"])
    last = {}
    for (step, gen), losses in sorted(by_step.items()):
        last[step] = float(np.mean(losses))
    return [last[s] for s in sorted(last)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    state, _, _ = jm.create_train_state(jax.random.PRNGKey(0),
                                        learning_rate=LR)
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    # JAX's worker alone, in a subprocess, while the port runs
    code = ("import sys; sys.path.insert(0, 'examples'); "
            "import train_mnist; print(train_mnist.elastic_worker("
            f"{str(tmp / 'jax_ckpt')!r}, {STEPS}, {SAVE_EVERY}, "
            f"{GLOBAL_BATCH}, {LR}, snapshot_every=0))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DTX_TELEMETRY_DIR=str(tmp / "jax_t"))
    env.pop("TF_CONFIG", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def port(name, *extra):
        args = torch_train_mnist.build_parser().parse_args(
            ["--device", "cpu", "--elastic", "--workers", "2", "--steps",
             str(STEPS), "--save-every", str(SAVE_EVERY), "--ckpt-dir",
             str(tmp / name), "--telemetry-dir", str(tmp / f"{name}_t"),
             *extra])
        return torch_train_mnist.run(args, params=params)

    out = {"killed": port("killed", "--kill-seed", "0"),
           "clean": port("clean"), "clean_dir": tmp / "clean_t"}
    _stdout, stderr = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, stderr[-2000:]
    out["jax"] = step_losses(tmp / "jax_t")
    return out


def test_elastic_kill_recovers_to_the_uninterrupted_loss(runs):
    killed, clean = runs["killed"], runs["clean"]
    plan = killed["kill_plan"]
    assert len(plan) == 1 and killed["restarts"] == 1
    assert killed["generation"] == 1 and killed["workers"] == 2
    resumed = {start for _pid, start, _loss in killed["final"]}
    assert len(resumed) == 1
    (start,) = resumed
    assert 0 < start <= plan[0]["after_step"] + 1
    assert clean["restarts"] == 0
    assert [loss for *_, loss in killed["final"]] == \
        [loss for *_, loss in clean["final"]]


def test_elastic_losses_match_jax_elastic_worker(runs):
    want, got = runs["jax"], step_losses(runs["clean_dir"])
    assert len(want) == len(got) == STEPS
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err[0] <= FIRST_TOL, err
    assert err.max() <= TOL, err
    # the run's last loss, as each worker returns it, is its own half
    finals = [loss for *_, loss in runs["clean"]["final"]]
    assert abs(np.mean(finals) - want[-1]) <= TOL

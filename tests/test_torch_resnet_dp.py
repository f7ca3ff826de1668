"""Port parity: ``resnet.make_sharded_train_step`` on a ``{"dp": 4}``
mesh (four gloo ranks, one spawn) against the JAX package's on the same
mesh of its 8-device CPU mesh, from JAX's initial ``params`` and
``batch_stats``, on a global batch of 8 ``tiny()`` images whose rows
differ in mean from one data rank to the next (+0.5 a rank).

Under GSPMD JAX's BatchNorm statistics are the global batch's; the
port's are averaged over the data ranks, gradient included. Three
steps: every step's loss within 2e-6 and accuracy equal, the parameters
and ``batch_stats`` within 1e-5 after the three steps
(``tests/test_torch_train_step.py``'s tolerances), the same on every
rank. The control: the same step with per-replica statistics (the sync
removed) parts from JAX by more than 1e-2 in the loss or 1e-3 in the
running means.
"""

import jax
import numpy as np
import pytest

from distributed_tensorflow_tpu.models import resnet as jr
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_resnet_ranks
from torch_tp_jax import jax_mesh

GB, S, STEPS, DP = 8, 32, 3, {"dp": 4}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def batch():
    b = jr.synthetic_images(GB, S, 10, seed=5)
    image = b["image"].copy()
    for r in range(4):       # each data rank's rows a shifted mean
        image[2 * r:2 * r + 2] += np.float32(0.5 * r)
    return {"image": image, "label": b["label"]}


@pytest.fixture(scope="module")
def jax_run(batch):
    state, step = jr.make_sharded_train_step(jr.ResNetConfig.tiny(),
                                             jax_mesh(DP), GB, S)
    init = {k: jax.tree_util.tree_map(np.asarray, state[k])
            for k in ("params", "batch_stats")}
    losses, accs = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return {"init": init, "losses": losses, "accuracy": accs,
            "params": state["params"], "batch_stats": state["batch_stats"]}


@pytest.fixture(scope="module")
def port_ranks(jax_run, batch):
    init = jax_run["init"]
    return multi_process_runner.run(
        torch_resnet_ranks.resnet_dp_rank, 4,
        args=(DP, init["params"], init["batch_stats"], batch, STEPS),
        device="cpu", timeout=300).return_values


def test_dp4_step_matches_jax(port_ranks, jax_run):
    for r in port_ranks:
        got = r["synced"]
        np.testing.assert_allclose(got["losses"], jax_run["losses"],
                                   rtol=0, atol=2e-6)
        assert got["accuracy"] == jax_run["accuracy"]
        for coll in ("params", "batch_stats"):
            want, have = _leaves(jax_run[coll]), _leaves(got[coll])
            assert want.keys() == have.keys()
            for k, w in want.items():
                np.testing.assert_allclose(have[k], w, rtol=0, atol=1e-5,
                                           err_msg=f"{coll} {k}")
                assert np.array_equal(
                    have[k], _leaves(port_ranks[0]["synced"][coll])[k])


def test_per_replica_statistics_part_from_jax(port_ranks, jax_run):
    got = port_ranks[0]["per_replica"]
    loss_gap = np.abs(np.subtract(got["losses"], jax_run["losses"])).max()
    want = _leaves(jax_run["batch_stats"])
    have = _leaves(got["batch_stats"])
    mean_gap = max(np.abs(have[k] - w).max() for k, w in want.items()
                   if k.endswith("['mean']"))
    assert loss_gap > 1e-2 or mean_gap > 1e-3, (loss_gap, mean_gap)

"""Port parity: ``distributed_tensorflow_tpu_torch.models.mnist_cnn``
against the JAX package's ``models/mnist_cnn.py`` on the CPU, in f32,
from the same flax init (``params_from_jax``):

- ``synthetic_data`` equals JAX's arrays bit for bit.
- The forward's logits within 1e-5 (convolutions summed in another
  order), and their argmax equal.
- Three steps of ``make_train_step`` with ``optax.adam(1e-3)`` on JAX's
  side and the port's written-out Adam: every step's loss within 2e-6
  and accuracy equal, every gradient of the first step within 1e-4 of
  its leaf's largest magnitude (``tests/test_torch_train_step.py``'s
  tolerances), and the parameters after the three steps within 1e-4.
  That is ten times the train-step test's 1e-5, measured: Adam divides
  each gradient by about its own size, so where a gradient is near eps
  its f32 rounding noise moves the update by a good share of the
  learning rate. ``Dense_0`` has 1.6M elements; 3 of them end up to
  8.73e-5 apart (one step is 1e-3), every other within 1e-5, and no
  more than 1 in 10^5 may be past 1e-5.
- The pool is flax's ``"VALID"`` and the flatten NHWC: the Dense rows
  a channel-major flatten would give fail the logits check (a control).
- With no CUDA device, ``device="cuda"`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import mnist_cnn as jm
from distributed_tensorflow_tpu_torch.models import mnist_cnn as tm

B, STEPS = 16, 3


@pytest.fixture(scope="module")
def data():
    return {k: v[:B] for k, v in jm.synthetic_data(64, seed=1).items()}


@pytest.fixture(scope="module")
def jax_init():
    state, _, _ = jm.create_train_state(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state["params"])


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def test_synthetic_data_is_bitwise_jax():
    a, b = jm.synthetic_data(32, seed=3), tm.synthetic_data(32, seed=3)
    for k in ("image", "label"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_forward_matches_jax(data, jax_init):
    want = np.asarray(jm.MNISTCNN().apply({"params": jax_init},
                                          data["image"]))
    model = tm.params_from_jax(jax_init, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(data["image"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    # control: a channel-major flatten puts Dense_0's rows out of order
    k = jax_init["Dense_0"]["kernel"].reshape(14, 14, 64, 128)
    wrong = dict(jax_init, Dense_0={
        "kernel": k.transpose(2, 0, 1, 3).reshape(-1, 128),
        "bias": jax_init["Dense_0"]["bias"]})
    with torch.no_grad():
        bad = tm.params_from_jax(wrong, device="cpu")(
            torch.from_numpy(data["image"])).numpy()
    assert np.abs(bad - want).max() > 1e-3


def test_train_steps_match_jax(data, jax_init):
    jmodel = jm.MNISTCNN()
    tx = optax.adam(1e-3)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, jax_init),
              "opt_state": tx.init(jax_init), "step": 0}
    jstep = jax.jit(jm.make_train_step(jmodel, tx))
    jgrads = jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jmodel.apply({"params": p}, data["image"]), data["label"]).mean())(
        jstate["params"])

    model = tm.params_from_jax(jax_init, device="cpu")
    opt = tm.make_optimizer(model.parameters())
    step = tm.make_train_step(model, opt)
    state = {"model": model, "optimizer": opt, "step": 0}
    for i in range(STEPS):
        jstate, jm_ = jstep(jstate, data)
        state, m = step(state, data)
        assert abs(float(m["loss"]) - float(jm_["loss"])) <= 2e-6, i
        assert float(m["accuracy"]) == float(jm_["accuracy"]), i
        if i == 0:
            got = tm.flax_params(model, lambda p: p.grad)
            for path, w in jax.tree_util.tree_leaves_with_path(_np(jgrads)):
                g = got[path[0].key][path[1].key]
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                    err_msg=str(path))
    assert state["step"] == STEPS
    got = tm.flax_params(model)
    for path, w in jax.tree_util.tree_leaves_with_path(
            _np(jstate["params"])):
        g = got[path[0].key][path[1].key]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=str(path))
        assert (np.abs(g - w) > 1e-5).mean() <= 1e-5, path


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.create_train_state(0)

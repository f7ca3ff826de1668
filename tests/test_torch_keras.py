"""Port parity: the Keras shim (``keras.py``, ``training/layers.py``,
``functional.py``, ``model.py``, ``losses.py``, ``metrics.py``,
``schedules.py``, ``optimizers.py``) against the JAX package's on one
replica, on the CPU.

Each model (the MNIST script's Sequential; a functional ResNet stack
with BatchNorm; the encoder with dropout 0; an LSTM/GRU/Bidirectional
stack, all tiny) is built in both packages and the port takes JAX's
initial weights (``port.set_weights(jax.get_weights())``, so the
parameter trees have the same keys and shapes), then ``compile`` and
``fit`` for 2 epochs at batch 8 on 37 rows (a final partial batch),
``evaluate`` and ``predict``, for each string optimizer and for
``keras.optimizers`` with a schedule. The history's losses within 2e-6
and accuracies equal, the weights within 1e-5, ``evaluate`` within 2e-6,
``predict`` within 1e-5, BatchNorm's running statistics within 1e-5
(``tests/test_torch_train_step.py``'s tolerances).

Adam on a parameter whose gradient is zero by construction (a conv bias
before BatchNorm, the attention's key bias) turns f32 round-off into
±lr steps in either package (measured: ResNet-stack weights 0.089
apart under Adam), so those two stacks are held under SGD, momentum
SGD and RMSprop, and Adam on the MNIST and recurrent models.
"""

import jax
import numpy as np
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu import keras as jk
import distributed_tensorflow_tpu_torch as tdx
from distributed_tensorflow_tpu_torch import keras as tk

import torch_keras_ranks as kr

CASES = {
    "mnist": ["sgd", "adam", "adamw", "rmsprop",
              ("keras", "Adam", {}, ("ExponentialDecay", dict(
                  initial_learning_rate=0.01, decay_steps=3,
                  decay_rate=0.5))),
              ("keras", "SGD", {"momentum": 0.9}, ("PiecewiseConstantDecay",
               dict(boundaries=[4], values=[0.02, 0.005])))],
    "rnn": ["adam", "rmsprop"],
}

IDS = [(kind, i) for kind in CASES for i in range(len(CASES[kind]))]


def _check(got, want, state=True):
    for k, w in want["history"].items():
        g = got["history"][k]
        if k.endswith("accuracy"):
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=k)
    assert got["weights"].keys() == want["weights"].keys()
    for k, w in want["weights"].items():
        np.testing.assert_allclose(got["weights"][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["evaluate"], want["evaluate"], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(got["predict"], want["predict"], rtol=0,
                               atol=1e-5)
    if state:
        assert got["model_state"].keys() == want["model_state"].keys()
        for k, w in want["model_state"].items():
            np.testing.assert_allclose(got["model_state"][k], w, rtol=0,
                                       atol=1e-5, err_msg=k)


def run_pair(kind, opt):
    js = dtx.MirroredStrategy(devices=jax.devices()[:1])
    with js.scope():
        init = kr.build(jk, kind).get_weights()
    want = kr.fit_case(jk, js, kind, opt, init)
    got = kr.fit_case(tk, tdx.MirroredStrategy(devices=["cpu"]), kind, opt,
                      init)
    return got, want


@pytest.mark.parametrize("kind,i", IDS)
def test_fit_evaluate_predict_match_jax(kind, i):
    got, want = run_pair(kind, CASES[kind][i])
    _check(got, want)


def test_learning_rate_schedule_and_setter():
    """The injected rate: a float is f32-rounded and settable; a rate
    compiled as a schedule refuses the setter, as JAX's."""
    s = tdx.MirroredStrategy(devices=["cpu"])
    with s.scope():
        m = kr.build(tk, "mnist")
        m.compile("sgd", loss="mse", learning_rate=0.1)
    assert m.learning_rate == float(np.float32(0.1))
    m.learning_rate = 0.3
    assert m.learning_rate == float(np.float32(0.3))
    with s.scope():
        m.compile("adam", loss="mse", learning_rate=tk.optimizers.schedules
                  .CosineDecay(0.1, 10))
    with pytest.raises(AttributeError):
        m.learning_rate = 0.2


@pytest.mark.parametrize("name", ["ExponentialDecay", "CosineDecay",
                                  "PiecewiseConstantDecay",
                                  "PolynomialDecay"])
def test_schedules_match_jax(name):
    kw = {"ExponentialDecay": dict(initial_learning_rate=0.1,
                                   decay_steps=7, decay_rate=0.3,
                                   staircase=True),
          "CosineDecay": dict(initial_learning_rate=0.1, decay_steps=9,
                              alpha=0.1),
          "PiecewiseConstantDecay": dict(boundaries=[2, 5],
                                         values=[0.3, 0.2, 0.1]),
          "PolynomialDecay": dict(initial_learning_rate=0.1,
                                  decay_steps=6, power=2.0, cycle=True)}[name]
    js = getattr(jk.optimizers.schedules, name)(**kw)
    ts = getattr(tk.optimizers.schedules, name)(**kw)
    for step in range(15):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=2e-7, atol=0)
    assert ts.get_config() == js.get_config()


LOSSES = ["sparse_categorical_crossentropy", "categorical_crossentropy",
          "binary_crossentropy", "mse", "mae", "huber", "hinge", "kld"]


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("from_logits", [True, False])
def test_losses_match_jax(name, from_logits):
    import jax.numpy as jnp
    import torch
    from distributed_tensorflow_tpu.training import losses as jl
    from distributed_tensorflow_tpu_torch.training import losses as tl
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    if name.startswith("sparse"):
        y = rng.integers(0, 4, 6).astype(np.int32)
    elif name in ("binary_crossentropy", "hinge"):
        y = rng.integers(0, 2, (6, 1)).astype(np.float32)
        logits = logits[:, :1].reshape(6)   # (B,) vs (B, 1): rank alignment
    else:
        y = np.abs(rng.normal(size=(6, 4))).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
    pred = logits if from_logits else 1 / (1 + np.exp(-logits))
    kw = {"from_logits": from_logits} if "crossentropy" in name else {}
    if kw:
        jf = type(jl.get(name))(**kw)
        tf_ = type(tl.get(name))(**kw)
    else:
        jf, tf_ = jl.get(name), tl.get(name)
    want = np.asarray(jf(jnp.asarray(y), jnp.asarray(pred)))
    got = tf_(torch.from_numpy(y), torch.from_numpy(pred)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


METRICS = ["accuracy", "binary_accuracy", "categorical_accuracy",
           "precision", "recall", "top_k_categorical_accuracy"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(name):
    import jax.numpy as jnp
    import torch
    from distributed_tensorflow_tpu.training import metrics as jmet
    from distributed_tensorflow_tpu_torch.training import metrics as tmet
    rng = np.random.default_rng(9)
    pred = np.round(rng.normal(size=(12, 6)), 1).astype(np.float32)
    pred[3, :] = 0.5                          # a row of ties (top-k)
    w = rng.uniform(0.2, 1.0, 12).astype(np.float32)
    if name in ("binary_accuracy", "precision", "recall"):
        y = rng.integers(0, 2, (12, 6)).astype(np.float32)
        if name != "binary_accuracy":
            pred = 1 / (1 + np.exp(-pred))
    elif name == "categorical_accuracy":
        y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 12)]
    else:
        y = rng.integers(0, 6, 12).astype(np.int32)
        y[3] = 4                              # the tie row's label
    jm_, tm_ = jmet.get(name), tmet.get(name)
    js = jm_.update(jm_.init(), jnp.asarray(y), jnp.asarray(pred),
                    jnp.asarray(w))
    ts = tm_.update(tm_.init(), torch.from_numpy(y), torch.from_numpy(pred),
                    torch.from_numpy(w))
    assert float(tm_.result(ts)) == pytest.approx(float(jm_.result(js)),
                                                  abs=1e-7)
    assert tm_.name == jm_.name


def test_regularized_dense_matches_jax():
    """A kernel/bias regularizer's penalty joins the loss and the
    gradient (and a reused layer's counts once)."""
    def mk(k):
        inp = k.Input(shape=(4,))
        d = k.layers.Dense(4, kernel_regularizer="l2",
                           bias_regularizer=k.regularizers.l1(0.02))
        out = k.layers.Dense(3)(d(d(inp)))
        return k.Model(inputs=inp, outputs=out)
    x, y = np.random.default_rng(2).normal(size=(10, 4)).astype(
        np.float32), np.arange(10, dtype=np.int32) % 3
    res = []
    for k, s in ((jk, dtx.MirroredStrategy(devices=jax.devices()[:1])),
                 (tk, tdx.MirroredStrategy(devices=["cpu"]))):
        with s.scope():
            m = mk(k)
            m.compile("sgd", learning_rate=0.1,
                      loss="sparse_categorical_crossentropy")
        if res:
            m.set_weights(res[0][2])
        # a copy: JAX's fit donates the parameter buffers
        w0 = jax.tree_util.tree_map(np.array, m.get_weights())
        h = m.fit(x, y, batch_size=4, epochs=2, verbose=0).history
        res.append((h["loss"], kr.flat(m.get_weights()), w0))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=0, atol=2e-6)
    for k_, w in res[0][1].items():
        np.testing.assert_allclose(res[1][1][k_], w, rtol=0, atol=1e-5)


def test_to_categorical_and_plot_model_match_jax():
    y = np.array([[0, 2], [1, 1]])
    np.testing.assert_array_equal(tk.utils.to_categorical(y, 3),
                                  jk.utils.to_categorical(y, 3))
    with pytest.raises(NotImplementedError):
        tk.utils.plot_model(None)

"""Port parity: the Keras shim's functional graphs on one replica — the
ResNet stack with BatchNorm (its running statistics held too) and the
encoder (MultiHeadAttention, LayerNormalization, Embedding, Dropout 0)
— as ``tests/test_torch_keras.py`` holds the Sequential and recurrent
models: JAX's initial weights through ``set_weights``, 2 epochs at
batch 8 on 37 rows, ``evaluate`` and ``predict``, the history's losses
within 2e-6 and accuracies equal, weights, predictions and statistics
within 1e-5. The ResNet stack is held under SGD and momentum SGD with a
cosine schedule, the encoder under SGD and RMSprop: Adam and RMSprop
divide a gradient by about its own size, which turns the f32 noise of
a gradient that is zero by construction (a conv bias before BatchNorm,
measured 5.1e-5 apart under RMSprop; the attention's key bias) into
real steps (see ``test_torch_keras.py``). Also: the functional graph's keras-style names
and parameter tree equal JAX's, a reused layer shares its weights, and
a disconnected graph raises.
"""

import jax
import numpy as np
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu import keras as jk
import distributed_tensorflow_tpu_torch as tdx
from distributed_tensorflow_tpu_torch import keras as tk

import torch_keras_ranks as kr
from test_torch_keras import _check, run_pair

CASES = [("resnet", "sgd"),
         ("resnet", ("keras", "SGD", {"momentum": 0.9}, ("CosineDecay", dict(
             initial_learning_rate=0.05, decay_steps=10)))),
         ("encoder", "sgd"), ("encoder", "rmsprop")]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_functional_fit_matches_jax(case):
    got, want = run_pair(*CASES[case])
    _check(got, want)


def _shapes(tree):
    return {k: v.shape for k, v in kr.flat(tree).items()}


@pytest.mark.parametrize("kind", ["mnist", "resnet", "encoder", "rnn"])
def test_parameter_trees_match_jax(kind):
    with dtx.MirroredStrategy(devices=jax.devices()[:1]).scope():
        want = kr.build(jk, kind)
    with tdx.MirroredStrategy(devices=["cpu"]).scope():
        got = kr.build(tk, kind)
    assert _shapes(got.get_weights()) == _shapes(want.get_weights())
    assert [type(lyr).__name__ for lyr in got.layers] == \
        [type(lyr).__name__ for lyr in want.layers]


def test_reused_layer_shares_weights_and_disconnected_graph_raises():
    for k, s in ((jk, dtx.MirroredStrategy(devices=jax.devices()[:1])),
                 (tk, tdx.MirroredStrategy(devices=["cpu"]))):
        with s.scope():
            a, b = k.Input(shape=(3,)), k.Input(shape=(3,))
            shared = k.layers.Dense(2)
            m = k.Model(inputs=[a, b], outputs=k.layers.Add()(
                [shared(a), shared(b)]))
            assert sorted(m.get_weights()) == ["dense"]
            with pytest.raises(ValueError):
                k.Model(inputs=a, outputs=shared(b))

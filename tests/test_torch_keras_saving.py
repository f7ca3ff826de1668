"""Port parity: ``training/saving.py`` and the Model's ``save_weights``
/ ``load_weights`` across the two packages, one replica, CPU.

For the MNIST Sequential, the functional ResNet stack (BatchNorm state
included) and the encoder (a two-argument MHA call), a model saved by
one package (``save_model``) loads in the other (``load_model``): the
JSON configs are equal, the weights and BatchNorm statistics bitwise
equal, and the loaded model predicts what the saved one did (within
1e-5). ``save_weights`` of either loads with the other's
``load_weights``, bitwise. ``model_config`` of a model holding a
``Lambda`` raises, as JAX's.
"""

import json
import os

import jax
import numpy as np
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu import keras as jk
from distributed_tensorflow_tpu.training import saving as jsave
import distributed_tensorflow_tpu_torch as tdx
from distributed_tensorflow_tpu_torch import keras as tk
from distributed_tensorflow_tpu_torch.training import saving as tsave

import torch_keras_ranks as kr

KINDS = ("mnist", "resnet", "encoder")
PKG = {"jax": (jk, lambda: dtx.MirroredStrategy(devices=jax.devices()[:1])),
       "port": (tk, lambda: tdx.MirroredStrategy(devices=["cpu"]))}


def _state(m):
    ms = m._state.get("model_state") or {}
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in kr.flat_any(ms).items()}


def _trained(name, kind):
    k, strat = PKG[name]
    with strat().scope():
        m = kr.build(k, kind)
        m.compile("sgd", learning_rate=0.05,
                  loss="sparse_categorical_crossentropy")
    x, y = kr.data(kind)
    m.fit(x, y, batch_size=8, epochs=1, verbose=0)
    return m, x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_save_model_loads_across_packages(tmp_path, kind, src, dst):
    m, x = _trained(src, kind)
    path = str(tmp_path / "saved")
    m.save(path)
    k_dst, strat = PKG[dst]
    with strat().scope():
        loaded = k_dst.models.load_model(path)
    a, b = kr.flat(m.get_weights()), kr.flat(loaded.get_weights())
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    sa, sb = _state(m), _state(loaded)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert np.array_equal(sa[key], sb[key]), key
    other = (tsave if dst == "port" else jsave).model_config(loaded)
    with open(os.path.join(path, "model_config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(other))
    np.testing.assert_allclose(np.asarray(loaded.predict(x, batch_size=8)),
                               np.asarray(m.predict(x, batch_size=8)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_configs_equal_jax(kind):
    with PKG["jax"][1]().scope():
        want = jsave.model_config(kr.build(jk, kind))
    with PKG["port"][1]().scope():
        got = tsave.model_config(kr.build(tk, kind))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_weights_files_load_across_packages(tmp_path, src, dst):
    m, _ = _trained(src, "resnet")
    path = str(tmp_path / "w")
    m.save_weights(path)
    k_dst, strat = PKG[dst]
    with strat().scope():
        other = kr.build(k_dst, "resnet")
    other.load_weights(path)
    a, b = kr.flat(m.get_weights()), kr.flat(other.get_weights())
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    sa, sb = _state(m), _state(other)
    for key in sa:
        assert np.array_equal(sa[key], sb[key]), key


def test_lambda_is_not_serializable():
    with PKG["port"][1]().scope():
        m = tk.Sequential([tk.Input((3,)), tk.layers.Lambda(lambda t: t * 2),
                           tk.layers.Dense(2)])
    with pytest.raises(ValueError):
        tsave.model_config(m)

"""Models, data and rank functions for the Keras-shim parity tests.

Torch only (no jax): the builders take the ``keras`` namespace they
build with (the JAX package's in the test process, the port's in the
ranks), and ``testing.multi_process_runner`` spawns fresh interpreters
that import this module by name (gloo on the CPU).
"""

import numpy as np


def build(k, kind: str):
    """A tiny model of each kind the tests hold: the MNIST script's
    Sequential, a functional ResNet stack with BatchNorm, the encoder
    with dropout 0, an LSTM/GRU/Bidirectional stack."""
    L = k.layers
    if kind == "mnist":
        return k.Sequential([
            k.Input((8, 8, 1)),
            L.Conv2D(4, 3, padding="same", activation="relu"),
            L.Conv2D(6, 3, padding="same", activation="relu"),
            L.MaxPooling2D(2), L.Flatten(), L.Dropout(0.0),
            L.Dense(16, activation="relu"), L.Dense(3)])
    if kind == "resnet":
        inp = k.Input(shape=(8, 8, 3))
        x = L.ZeroPadding2D(1)(inp)
        x = L.Conv2D(4, 3, strides=2)(x)
        x = L.BatchNormalization()(x)
        x = L.Activation("relu")(x)
        s = L.BatchNormalization()(L.Conv2D(8, 1, strides=2)(x))
        y = L.BatchNormalization()(L.Conv2D(8, 3, strides=2,
                                            padding="same")(x))
        x = L.Activation("relu")(L.Add()([y, s]))
        x = L.MaxPooling2D(3, strides=2, padding="same")(x)
        x = L.GlobalAveragePooling2D()(x)
        return k.Model(inputs=inp, outputs=L.Dense(3)(x))
    if kind == "encoder":
        inp = k.Input(shape=(6,), dtype="int32")
        x = L.Embedding(20, 8)(inp)
        a = L.MultiHeadAttention(2, 4, dropout=0.0)(x, x)
        a = L.Dropout(0.0)(a)
        x = L.LayerNormalization(epsilon=1e-6)(L.Add()([x, a]))
        f = L.Dense(8)(L.Dense(16, activation="gelu")(x))
        x = L.LayerNormalization(epsilon=1e-6)(L.Add()([x, f]))
        x = L.GlobalAveragePooling1D()(x)
        x = L.Dense(8, activation="tanh")(x)
        return k.Model(inputs=inp, outputs=L.Dense(3)(x))
    if kind == "rnn":
        inp = k.Input(shape=(5, 4))
        x = L.LSTM(6, return_sequences=True)(inp)
        x = L.Bidirectional(L.GRU(3, return_sequences=True))(x)
        x = L.SimpleRNN(4)(x)
        return k.Model(inputs=inp, outputs=L.Dense(3)(x))
    raise ValueError(kind)


def data(kind: str, n: int = 37, seed: int = 1):
    """``(x, y)``: 37 rows, so batch 8 ends on a partial batch of 5."""
    rng = np.random.default_rng(seed)
    shape = {"mnist": (8, 8, 1), "resnet": (8, 8, 3), "rnn": (5, 4)}
    if kind == "encoder":
        x = rng.integers(0, 20, size=(n, 6)).astype("int32")
    else:
        x = rng.normal(size=(n, *shape[kind])).astype("float32")
    return x, rng.integers(0, 3, n).astype("int32")


def optimizer(k, spec):
    """A compile optimizer from a test case's spec: a name, or
    ``("keras", ctor, kwargs, schedule)``."""
    if isinstance(spec, str):
        return spec
    _, ctor, kw, sched = spec
    kw = dict(kw)
    if sched is not None:
        cls, skw = sched
        kw["learning_rate"] = getattr(k.optimizers.schedules, cls)(**skw)
    return getattr(k.optimizers, ctor)(**kw)


def flat(tree, prefix="") -> dict:
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(v)
    return out


def fit_case(k, strategy, kind, opt, weights, epochs=2, batch=8,
             model_state=None):
    """Build, take ``weights``, compile, fit, evaluate, predict: the
    history, the weights after, the evaluation, the predictions and the
    model state (BatchNorm statistics)."""
    with strategy.scope():
        model = build(k, kind)
        model.compile(optimizer=optimizer(k, opt), learning_rate=(
            0.01 if isinstance(opt, str) else None),
            loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    model.set_weights(weights)
    x, y = data(kind)
    hist = model.fit(x, y, batch_size=batch, epochs=epochs, verbose=0)
    ev = model.evaluate(x, y, batch_size=batch)
    pred = model.predict(x, batch_size=batch)
    ms = model._state.get("model_state") or {}
    return {"history": {kk: [float(v) for v in vv]
                        for kk, vv in hist.history.items()},
            "weights": flat(model.get_weights()),
            "evaluate": [float(v) for v in ev],
            "predict": np.asarray(pred),
            "model_state": {kk: (v.detach().cpu().numpy()
                                 if hasattr(v, "detach") else np.asarray(v))
                            for kk, v in flat_any(ms).items()}}


def flat_any(tree, prefix="") -> dict:
    out = {}
    for key, v in dict(tree).items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat_any(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = v
    return out


def keras_dp_rank(cases: list, weights: dict) -> list:
    """Each ``(kind, optimizer)`` case on a ``MirroredStrategy`` over
    this rank's gloo group."""
    import torch
    import distributed_tensorflow_tpu_torch as tfd
    from distributed_tensorflow_tpu_torch import keras
    from torch_dp_ranks import _init
    torch.set_num_threads(1)
    _init()
    strategy = tfd.MirroredStrategy(devices=["cpu"])
    return [fit_case(keras, strategy, kind, opt, weights[kind])
            for kind, opt in cases]

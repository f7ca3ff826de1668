"""Port parity: ``training/callbacks.py``, ``utils/summary.py`` and the
Model's backup hooks against the JAX package's, on the MNIST
Sequential from JAX's initial weights (one replica, CPU).

- ``ReduceLROnPlateau``: the learning rate every epoch equals JAX's
  (f32 values, exactly); ``EarlyStopping``: the same stop epoch and
  history length; ``CSVLogger``: the same header and rows, the values
  within 2e-6; ``TensorBoard``: the same event records (tags, steps,
  framing) with the scalars within 2e-6.
- ``utils/summary.py``: for the same scalars, histogram and wall times
  the event file's records are JAX's byte for byte (the file-version
  record apart, which carries the open time); ``read_scalars`` reads
  JAX's files.
- ``BackupAndRestore``: a fit interrupted inside epoch 3 resumes from
  the epoch-2 backup; its history and weights equal an uninterrupted
  fit's (within 1e-6: CPU sums are not bitwise repeatable across model
  instances), and the backup is deleted at the end.
"""

import csv
import glob
import os

import jax
import numpy as np
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu import keras as jk
from distributed_tensorflow_tpu.utils import summary as jsum
import distributed_tensorflow_tpu_torch as tdx
from distributed_tensorflow_tpu_torch import keras as tk
from distributed_tensorflow_tpu_torch.utils import summary as tsum

import torch_keras_ranks as kr

EPOCHS = 4


class LRLog:
    """A callback recording the learning rate at each epoch's end (made
    from either package's Callback)."""

    @staticmethod
    def make(k):
        class _LR(k.callbacks.Callback):
            def on_train_begin(self, logs=None):
                self.lrs = []

            def on_epoch_end(self, epoch, logs=None):
                self.lrs.append(self.model.learning_rate)
        return _LR()


def _fit(k, strategy, init, callbacks, epochs=EPOCHS):
    with strategy.scope():
        m = kr.build(k, "mnist")
        m.compile("sgd", learning_rate=0.05,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    m.set_weights(init)
    x, y = kr.data("mnist")
    h = m.fit(x, y, batch_size=8, epochs=epochs, verbose=0,
              callbacks=callbacks)
    return m, h.history


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("cb")
    js = dtx.MirroredStrategy(devices=jax.devices()[:1])
    with js.scope():
        init = kr.build(jk, "mnist").get_weights()
    out = {}
    for name, k, s in (("jax", jk, js),
                       ("port", tk, tdx.MirroredStrategy(devices=["cpu"]))):
        d = root / name
        lr = LRLog.make(k)
        cbs = [k.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                             patience=1, min_delta=10.0),
               k.callbacks.CSVLogger(str(d) + "_log.csv"),
               k.callbacks.TensorBoard(str(d / "tb")), lr]
        m, hist = _fit(k, s, init, cbs)
        es = k.callbacks.EarlyStopping(monitor="loss", patience=1,
                                       min_delta=10.0)
        _, es_hist = _fit(k, s, init, [es])
        out[name] = {"hist": hist, "lrs": lr.lrs, "csv": str(d) + "_log.csv",
                     "tb": str(d / "tb"), "stopped": es.stopped_epoch,
                     "es_len": len(es_hist["loss"])}
    out["init"] = init
    return out


def test_reduce_lr_on_plateau_rates_equal_jax(pair):
    assert pair["port"]["lrs"] == pair["jax"]["lrs"]
    assert len(set(pair["port"]["lrs"])) == EPOCHS


def test_early_stopping_epoch_equals_jax(pair):
    assert pair["port"]["stopped"] == pair["jax"]["stopped"] > 0
    assert pair["port"]["es_len"] == pair["jax"]["es_len"] < EPOCHS


def test_csv_logger_file_matches_jax(pair):
    rows = [list(csv.reader(open(pair[n]["csv"]))) for n in ("port", "jax")]
    assert rows[0][0] == rows[1][0]
    assert len(rows[0]) == len(rows[1]) == EPOCHS + 1
    for got, want in zip(rows[0][1:], rows[1][1:]):
        assert got[0] == want[0]
        np.testing.assert_allclose([float(v) for v in got[1:]],
                                   [float(v) for v in want[1:]], atol=2e-6)


def test_tensorboard_events_match_jax(pair):
    for run in ("train",):
        f = {n: glob.glob(os.path.join(pair[n]["tb"], run, "events.*"))
             for n in ("port", "jax")}
        assert len(f["port"]) == len(f["jax"]) == 1
        got = tsum.read_scalars(f["port"][0])
        want = jsum.read_scalars(f["jax"][0])
        assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
        np.testing.assert_allclose([v for _, _, v in got],
                                   [v for _, _, v in want], atol=2e-6)
        assert len(list(tsum.read_event_records(f["port"][0]))) == \
            len(list(jsum.read_event_records(f["jax"][0])))


def test_summary_writer_bytes_equal_jax(tmp_path):
    vals = np.random.default_rng(3).normal(size=200)
    files = {}
    for name, mod in (("port", tsum), ("jax", jsum)):
        d = tmp_path / name
        with mod.SummaryWriter(str(d)) as w:
            for step in range(5):
                w.scalar("loss", 1.0 / (step + 1), step, wall_time=1e9 + step)
            w.histogram("w", vals, 7, wall_time=1.5e9)
        files[name] = glob.glob(str(d / "events.*"))[0]
    port = list(tsum.read_event_records(files["port"]))
    jax_ = list(jsum.read_event_records(files["jax"]))
    assert port[1:] == jax_[1:]
    with open(files["port"], "rb") as a, open(files["jax"], "rb") as b:
        assert a.read()[-600:] == b.read()[-600:]
    assert tsum.read_scalars(files["jax"]) == jsum.read_scalars(files["jax"])


class _Stop(Exception):
    pass


def test_backup_and_restore_resumes_after_an_interrupted_epoch(tmp_path,
                                                               pair):
    init = pair["init"]
    s = tdx.MirroredStrategy(devices=["cpu"])

    class Interrupt(tk.callbacks.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            if self.epoch == 2 and batch == 2:
                raise _Stop

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

    backup = str(tmp_path / "backup")
    with pytest.raises(_Stop):
        _fit(tk, s, init, [tk.callbacks.BackupAndRestore(backup),
                           Interrupt()])
    assert os.path.exists(os.path.join(backup, "backup",
                                       "checkpoint.index.json"))
    with s.scope():
        m = kr.build(tk, "mnist")
        m.compile("sgd", learning_rate=0.05,
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    m.set_weights(init)
    x, y = kr.data("mnist")
    hist = m.fit(x, y, batch_size=8, epochs=EPOCHS, verbose=0,
                 callbacks=[tk.callbacks.BackupAndRestore(backup)]).history
    assert not os.path.exists(backup)
    ref, ref_hist = _fit(tk, s, init, [])
    assert len(hist["loss"]) == EPOCHS - 2
    np.testing.assert_allclose(hist["loss"], ref_hist["loss"][2:], atol=1e-6)
    want = kr.flat(ref.get_weights())
    for k_, g in kr.flat(m.get_weights()).items():
        np.testing.assert_allclose(g, want[k_], rtol=0, atol=1e-6)

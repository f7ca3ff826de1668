"""Port parity: the training entry points (``tools/torch_train_
transformer.py``, ``torch_train_bert.py``, ``torch_train_resnet.py`` and
the Keras checkpoint script) against the JAX package's steps on the CPU.

- ``torch_train_transformer.run`` at ``tiny()`` on ``--axes dp=1`` (in
  this process) and ``dp=2`` (two gloo ranks the script spawns), fed
  JAX's ``synthetic_tokens`` and JAX's initial parameters (converted),
  against JAX's ``make_sharded_train_step`` on the same mesh of its
  8-device CPU mesh: every step's loss within 2e-6
  (``tests/test_torch_train_step.py``'s tolerance), and the printed
  ``loss=`` lines JAX's losses at the script's 4 decimals.
- ``torch_train_bert.run`` likewise, with JAX's masks fed through
  ``masking=`` (JAX's step draws them with ``jax.random``): the
  ``mlm_loss=`` values within 2e-6.
- ``torch_train_resnet.run`` at ``tiny()`` (image 32) on its synthetic
  batch (JAX's numpy draw) from JAX's initial ``params`` and
  ``batch_stats``: at the global batch of ``tests/test_torch_resnet_dp.py``
  (8) every step's loss within its 2e-6; at the script's default 32 the
  first step's within 2e-6 and the later ones within 1e-5 (the
  parameters' tolerance of those tests): the recipe's first update (lr
  0.1 from step 0) amplifies the packages' f32 summation orders, and
  the third loss was measured 7.9e-6 apart at 32.
- ``examples/train_mnist_checkpoint_schedule_script.py`` exec'd on the
  port with only its two import lines replaced (as ``chip_smoke.py
  keras_scripts`` runs it), its strategies put on the CPU: it writes
  JAX's layout (``ckpt-<epoch>`` for each improving epoch, then
  ``final_model``) and its restored model evaluates to the last
  epoch's ``val_loss``.
"""

import functools
import glob
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded,
    synthetic_tokens)
from distributed_tensorflow_tpu_torch.models import transformer as ttf

from torch_tp_jax import jax_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_train_bert  # noqa: E402
import torch_train_resnet  # noqa: E402
import torch_train_transformer  # noqa: E402

GB, STEPS = 8, 3
LOSS_TOL = 2e-6


def _jax_params(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, state["params"])


def _printed(lines, key: str) -> list:
    return [float(m.group(1)) for line in lines
            for m in [re.search(key + r"=(-?[0-9.]+)", line)] if m]


@pytest.mark.parametrize("dp", [1, 2])
def test_train_transformer_matches_jax(dp):
    cfg = JConfig.tiny()
    state, step = jsharded(cfg, jax_mesh({"dp": dp}), GB)
    init = _jax_params(state)
    tokens = synthetic_tokens(GB, cfg.max_seq_len, cfg.vocab_size)
    want = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": tokens})
        want.append(float(m["loss"]))
    args = torch_train_transformer.build_parser().parse_args(
        ["--device", "cpu", "--axes", f"dp={dp}", "--steps", str(STEPS)])
    got = torch_train_transformer.run(
        args, tokens=np.asarray(tokens),
        params=ttf.params_from_jax(ttf.TransformerConfig.tiny(), init,
                                   device="cpu"))
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=LOSS_TOL)
    assert got["lines"][0] == f"mesh: {{'dp': {dp}}} on cpu"
    # the printed steps (0 and the last) carry JAX's losses
    np.testing.assert_allclose(_printed(got["lines"], "loss"),
                               [round(want[0], 4), round(want[-1], 4)],
                               rtol=0, atol=1.5e-4)
    assert got["lines"][-1].endswith(f"tokens/s over {STEPS} steps")


def test_train_bert_matches_jax():
    seq = 32
    cfg = jbert.tiny_bert_config(max_seq_len=seq)
    state, step = jbert.make_sharded_train_step(cfg, jax_mesh({"dp": 1}),
                                                GB)
    init = _jax_params(state)
    batch = jbert.synthetic_corpus(GB, seq, cfg.vocab_size)
    masks = [tuple(np.asarray(a) for a in jbert.apply_mlm_masking(
        jax.random.fold_in(jax.random.PRNGKey(0), t), batch["tokens"],
        vocab_size=cfg.vocab_size)) for t in range(STEPS)]
    want = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        want.append(float(m["loss"]))

    def masking(t, tokens):
        np.testing.assert_array_equal(tokens.numpy(),
                                      np.asarray(batch["tokens"]))
        return tuple(torch.tensor(a, dtype=torch.long)
                     for a in masks[t])

    args = torch_train_bert.build_parser().parse_args(
        ["--device", "cpu", "--axes", "dp=1", "--steps", str(STEPS),
         "--seq", str(seq)])
    got = torch_train_bert.run(
        args, params=ttf.params_from_jax(
            ttf.TransformerConfig.tiny(causal=False, max_seq_len=seq),
            init, device="cpu"), masking=masking)
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(_printed(got["lines"], "mlm_loss"),
                               [round(want[0], 4), round(want[-1], 4)],
                               rtol=0, atol=1.5e-4)
    assert got["lines"][-1].startswith("throughput: ")


@pytest.mark.parametrize("gb", [8, 32])
def test_train_resnet_matches_jax(capsys, gb):
    size = 32                  # the JAX script's default: tiny()
    state, step = jresnet.make_sharded_train_step(
        jresnet.ResNetConfig.tiny(), jax_mesh({"dp": 1}), gb, size)
    init = {k: jax.tree_util.tree_map(np.asarray, state[k])
            for k in ("params", "batch_stats")}
    batch = jresnet.synthetic_images(gb, size, 10, seed=0)
    want = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    args = torch_train_resnet.build_parser().parse_args(
        ["--device", "cpu", "--steps", str(STEPS), "--global-batch",
         str(gb)])
    got = torch_train_resnet.run(args, params=init["params"],
                                 batch_stats=init["batch_stats"])
    np.testing.assert_allclose(got["losses"][0], want[0], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(got["losses"], want, rtol=0,
                               atol=LOSS_TOL if gb == 8 else 1e-5)
    out = capsys.readouterr().out
    assert f"[p0] step {STEPS - 1}: loss={want[-1]:.4f}" in out
    assert "throughput: " in out


def test_keras_checkpoint_script(tmp_path, monkeypatch):
    import tempfile

    import distributed_tensorflow_tpu_torch as port
    from distributed_tensorflow_tpu_torch.parallel.mirrored import (
        MirroredStrategy)
    from distributed_tensorflow_tpu_torch.parallel.one_device import (
        OneDeviceStrategy)
    from distributed_tensorflow_tpu_torch.training import model as tmodel

    path = os.path.join(REPO, "examples",
                        "train_mnist_checkpoint_schedule_script.py")
    with open(path) as f:
        lines = f.read().split("\n")
    for old, new in (
            ("import distributed_tensorflow_tpu as tf_distribute",
             "import distributed_tensorflow_tpu_torch as tf_distribute"),
            ("from distributed_tensorflow_tpu import keras",
             "from distributed_tensorflow_tpu_torch import keras")):
        hits = [i for i, line in enumerate(lines) if line == old]
        assert len(hits) == 1
        lines[hits[0]] = new
    src = "\n".join(lines)
    monkeypatch.setattr(port, "MirroredStrategy",
                        functools.partial(MirroredStrategy,
                                          devices=["cpu"]))
    monkeypatch.setattr(tmodel, "_default_strategy",
                        lambda: OneDeviceStrategy("cpu"))
    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path))
    from distributed_tensorflow_tpu_torch.training.model import Model
    history, evals = [], []
    fit, evaluate = Model.fit, Model.evaluate

    def fit_(m, *a, **kw):
        h = fit(m, *a, **kw)
        history.append(h.history)
        return h

    def evaluate_(m, *a, **kw):
        r = evaluate(m, *a, **kw)
        evals.append(r)
        return r
    monkeypatch.setattr(Model, "fit", fit_)
    monkeypatch.setattr(Model, "evaluate", evaluate_)
    exec(compile(src, path, "exec"), {"__name__": "__main__"})

    val = history[0]["val_loss"]
    improving = [e + 1 for e in range(len(val))
                 if val[e] == min(val[:e + 1])]
    ckpts = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "ckpt-*")))
    assert ckpts == [f"ckpt-{e}" for e in improving]
    for d in ckpts + ["final_model"]:
        assert os.path.exists(tmp_path / d / "model_config.json")
        assert os.path.exists(tmp_path / d / "weights" /
                              "checkpoint.index.json")
    loss, _acc = evals[-1]
    np.testing.assert_allclose(loss, val[-1], rtol=0, atol=1e-6)

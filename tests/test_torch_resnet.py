"""Port parity: ``distributed_tensorflow_tpu_torch.models.resnet``
against the JAX package's ``models/resnet.py`` on the CPU, from the same
flax init (``params_from_jax`` carries ``params`` and ``batch_stats``):

- ``same_pads`` equals ``jax.lax.padtype_to_pads(..., "SAME")`` exactly
  over a grid of sizes, kernels and strides, including the asymmetric
  stride-2 pads: (2, 3) for the 7×7/2 stem at 224 and 32, (0, 1) for
  3×3/2 at 112, 56 and 8, (0, 0) for the 1×1/2 projection.
- ``conv2d_same`` and ``max_pool_same`` equal flax's ``nn.Conv`` and
  ``nn.max_pool(..., padding="SAME")`` within 1e-5 at stride 2 on even
  and odd sizes; torch's symmetric ``padding=`` does not (a control).
- ``synthetic_images`` equals JAX's arrays bit for bit.
- ``tiny()`` in f32: the train-mode forward's logits within 1e-5 and
  the updated ``batch_stats`` within 1e-6; the eval-mode forward (the
  running averages) within 1e-5; BatchNorm's statistics are JAX's
  ``E[x²] − E[x]²`` with the biased variance, which ``nn.BatchNorm2d``
  does not store (a control).
- ``tiny(dtype=bf16)``: the train-mode logits within 1e-2 of JAX's and
  their argmax equal: one bf16 step at the logits' largest magnitude
  (1.41) is 7.8e-3; measured 1.55e-3 (bf16 convolutions summed in
  another order).
- Three steps of ``make_train_step`` (label smoothing, masked decay,
  Nesterov SGD on the cosine schedule): every step's loss within 2e-6
  and accuracy equal, the gradients of the first step within 1e-4 of
  each leaf's largest magnitude, the parameters within 1e-5 and the
  ``batch_stats`` within 1e-5 after the three steps
  (``tests/test_torch_train_step.py``'s tolerances); the schedule's
  rates equal optax's bit for bit.
- With no CUDA device, ``device="cuda"`` raises.
"""

import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu.models import resnet as jr
from distributed_tensorflow_tpu_torch.models import layers as tl
from distributed_tensorflow_tpu_torch.models import resnet as tr

B, S, STEPS = 4, 32, 3


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, atol, rel=False, label=""):
    got, want = _leaves(got), _leaves(_np(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        tol = atol * np.abs(w).max() if rel else atol
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol,
                                   err_msg=f"{label} {k}")


def test_same_pads_equal_padtype_to_pads():
    for size, k, s in itertools.product(range(1, 40), (1, 2, 3, 5, 7),
                                        (1, 2, 3)):
        want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
        assert tl.same_pads(size, k, s) == tuple(want), (size, k, s)
    assert tl.same_pads(224, 7, 2) == (2, 3) == tl.same_pads(32, 7, 2)
    for size in (112, 56, 8):
        assert tl.same_pads(size, 3, 2) == (0, 1)
    assert tl.same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [8, 9])
def test_conv_and_pool_pad_as_flax(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(fnn.Conv(5, (3, 3), strides=(2, 2), use_bias=False)
                      .apply({"params": {"kernel": k}}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = tl.torch_kernel(k)
    got = tl.conv2d_same(xt, w, (2, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if size % 2 == 0:       # symmetric padding shifts the windows
        sym = F.conv2d(xt, w, None, 2, 1).permute(0, 2, 3, 1).numpy()
        assert np.abs(sym - want).max() > 1e-2
    want = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = tl.max_pool_same(xt, (3, 3), (2, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_synthetic_images_are_bitwise_jax():
    a = jr.synthetic_images(6, 32, 10, seed=4)
    b = tr.synthetic_images(6, 32, 10, seed=4)
    for k in ("image", "label"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _init(cfg):
    v = jr.ResNet(cfg).init(jax.random.PRNGKey(0),
                            jnp.zeros((B, S, S, 3), jnp.float32))
    return _np(v["params"]), _np(v["batch_stats"])


@pytest.fixture(scope="module")
def data():
    return jr.synthetic_images(B, S, 10, seed=1)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(data, train):
    cfg = jr.ResNetConfig.tiny()
    params, stats = _init(cfg)
    # move the running averages off their init so eval mode reads them
    stats = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.25) * np.arange(a.size, dtype=np.float32)
        / a.size, stats)
    out = jr.ResNet(cfg, train=train).apply(
        {"params": params, "batch_stats": stats}, data["image"],
        mutable=["batch_stats"] if train else False)
    want, new = out if train else (out, None)
    model = tr.params_from_jax(tr.ResNetConfig.tiny(), params, stats,
                               device="cpu").set_train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(data["image"])).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    if train:
        _close(tr.flax_variables(model)["batch_stats"], new["batch_stats"],
               1e-6, label="batch_stats")
        # control: torch's BatchNorm2d stores the unbiased variance
        x = torch.from_numpy(data["image"]).permute(0, 3, 1, 2)[:1, :, :2,
                                                                :2]
        bn = torch.nn.BatchNorm2d(3, momentum=0.1)
        bn(x)
        ours = tr.BatchNorm(3, dtype=torch.float32)
        ours(x)
        assert (bn.running_var - ours.var).abs().max() > 1e-4


def test_bf16_forward_matches_jax(data):
    cfg = jr.ResNetConfig.tiny(dtype=jnp.bfloat16)
    params, stats = _init(cfg)
    want, _ = jr.ResNet(cfg).apply({"params": params, "batch_stats": stats},
                                   data["image"], mutable=["batch_stats"])
    model = tr.params_from_jax(tr.ResNetConfig.tiny(dtype=torch.bfloat16),
                               params, stats, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(data["image"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-2)
    assert np.array_equal(got.numpy().argmax(-1),
                          np.asarray(want).argmax(-1))


def test_schedule_is_optax():
    sched = optax.cosine_decay_schedule(0.1, 10000)
    for count in (0, 1, 2, 17, 5000, 9999, 10000, 12000):
        assert tr.cosine_decay(0.1, 10000, count) == float(
            np.float32(sched(count))), count


def test_train_steps_match_jax(data):
    cfg = jr.ResNetConfig.tiny()
    params, stats = _init(cfg)
    jmodel, tx = jr.ResNet(cfg), jr.make_optimizer(cfg)
    jstate = {"params": params, "batch_stats": stats,
              "opt_state": tx.init(params), "step": 0}
    jstep = jax.jit(jr.make_train_step(cfg, jmodel, tx))

    def jloss(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                 data["image"], mutable=["batch_stats"])
        one_hot = optax.smooth_labels(jax.nn.one_hot(data["label"], 10), 0.1)
        return optax.softmax_cross_entropy(logits, one_hot).mean()
    jgrads = jax.grad(jloss)(params)

    tcfg = tr.ResNetConfig.tiny()
    model = tr.params_from_jax(tcfg, params, stats, device="cpu")
    opt = tr.make_optimizer(tcfg, model.parameters())
    step = tr.make_train_step(tcfg, model, opt)
    state = {"model": model, "optimizer": opt, "step": 0}
    for i in range(STEPS):
        jstate, jm = jstep(jstate, data)
        state, m = step(state, data)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-6, i
        assert float(m["accuracy"]) == float(jm["accuracy"]), i
        if i == 0:
            _close(tr.flax_variables(model, lambda p: p.grad)["params"],
                   jgrads, 1e-4, rel=True, label="grads")
    got = tr.flax_variables(model)
    _close(got["params"], jstate["params"], 1e-5, label="params")
    _close(got["batch_stats"], jstate["batch_stats"], 1e-5,
           label="batch_stats")


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.ResNet(tr.ResNetConfig.tiny())

"""Port parity: the train step of
``distributed_tensorflow_tpu_torch.models.transformer`` against the JAX
``make_train_step`` on the CPU, at ``tiny()`` in f32.

Both start from the same flax init (through ``params_from_jax``) and
take 5 AdamW steps on the same numpy token batch. The JAX side runs its
Pallas kernels in interpret mode (``attention_impl="interpret"``, and
for ``loss_impl="kernel"`` ``loss_kernel_impl="interpret"``); the port
runs the plain versions of its kernels, which is what its wrappers take
for CPU tensors. Compared: the loss of every step, every gradient leaf
of the first step, and the parameters and both AdamW moments after the
5 steps. Tolerances, each for its reason:

- loss: 2e-6 absolute (f32 sums over 30 tokens in another order).
- gradients: 1e-4 of each leaf's largest magnitude (f32 backward through
  two layers; blockwise vs whole-row reductions).
- nu: 1e-3 relative to the leaf's largest value, as nu ~ g².
- mu in f32: 1e-4 of the leaf's largest magnitude, as the gradients.
- mu in bf16: one bf16 rounding step (2**-8 relative) plus 1e-3 of the
  leaf's largest magnitude: a gradient that differs in the last f32
  bits can round mu to the neighbouring bf16 value, and the parameters
  that this moves apart give the later steps' gradients, summed into
  mu, a larger spread than the first step's.
- parameters: 1e-5 absolute. Adam's first step divides g by about |g|,
  so where a gradient is near eps its f32 noise moves the update by up
  to the learning rate (3e-4); no element of this run is that close,
  and 1e-5 is 3 % of one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as jtf
from distributed_tensorflow_tpu_torch.models import transformer as ttf

B, S, STEPS = 2, 16, 5


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_run(variant):
    mu = jnp.bfloat16 if variant == "kernel_mu_bf16" else None
    loss_kw = (dict(loss_impl="scan", loss_chunks=0) if variant == "scan"
               else dict(loss_impl="kernel", loss_kernel_impl="interpret"))
    cfg = jtf.TransformerConfig.tiny(max_seq_len=S, remat=False,
                                     attention_impl="interpret",
                                     adam_mu_dtype=mu, **loss_kw)
    model = jtf.TransformerLM(cfg)
    tokens = jnp.asarray(_tokens())
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    tx = jtf.make_optimizer(cfg)
    grads = jax.grad(jtf.make_loss_fn(cfg, model))(params, tokens)
    step = jax.jit(jtf.make_train_step(cfg, model, tx))
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    adam = state["opt_state"][0]
    return {"init": _np(params), "grads": _np(grads), "losses": losses,
            "params": _np(state["params"]), "mu": _np(adam.mu),
            "nu": _np(adam.nu)}


def _port_run(variant, init):
    mu = torch.bfloat16 if variant == "kernel_mu_bf16" else None
    loss_impl = "scan" if variant == "scan" else "kernel"
    cfg = ttf.TransformerConfig.tiny(max_seq_len=S, loss_impl=loss_impl,
                                     adam_mu_dtype=mu)
    model = ttf.TransformerLM(cfg, ttf.params_from_jax(cfg, init,
                                                       device="cpu"),
                              device="cpu")
    opt = ttf.make_optimizer(cfg, model.parameters())
    step = ttf.make_train_step(cfg, model, opt)
    state = {"model": model, "optimizer": opt, "step": 0}
    batch = {"tokens": torch.from_numpy(_tokens()).long()}
    losses, grads = [], None
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        if grads is None:   # the first step's gradients, at the init
            grads = model.stacked_params(lambda p: p.grad.clone())
    assert state["step"] == STEPS
    moment = lambda name: model.stacked_params(  # noqa: E731
        lambda p: opt.state[p][name].float())
    return cfg, {"grads": grads, "losses": losses,
                 "params": model.stacked_params(lambda p: p.detach()),
                 "mu": moment("mu"), "nu": moment("nu")}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _compare(cfg, got, want_np, check):
    want = dict(_leaves(ttf.params_from_jax(cfg, want_np, device="cpu")))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want) and len(got) == 10
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        check(name, g.float().numpy(), want[name].numpy())


def _rel_to_max(frac, extra_rtol=0.0):
    def check(name, g, w):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=extra_rtol,
                                   atol=frac * scale, err_msg=name)
    return check


@pytest.fixture(scope="module", params=["kernel", "kernel_mu_bf16", "scan"])
def runs(request):
    want = _jax_run(request.param)
    cfg, got = _port_run(request.param, want["init"])
    return request.param, cfg, got, want


def test_losses_match(runs):
    _, _, got, want = runs
    np.testing.assert_allclose(got["losses"], want["losses"], atol=2e-6,
                               rtol=0)
    assert got["losses"][-1] < got["losses"][0]


def test_gradients_match(runs):
    _, cfg, got, want = runs
    _compare(cfg, got["grads"], want["grads"], _rel_to_max(1e-4))


def test_params_and_moments_after_adamw_steps(runs):
    variant, cfg, got, want = runs

    def params(name, g, w):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)

    _compare(cfg, got["params"], want["params"], params)
    _compare(cfg, got["nu"], want["nu"], _rel_to_max(1e-3))
    mu_check = (_rel_to_max(1e-3, extra_rtol=2.0 ** -8)
                if variant == "kernel_mu_bf16" else _rel_to_max(1e-4))
    _compare(cfg, got["mu"], want["mu"], mu_check)


def test_unported_options_raise():
    """Options whose kernels come in slice 3 are refused where the
    config is made, so no entry point can run without them."""
    with pytest.raises(NotImplementedError, match="slice 3"):
        ttf.TransformerConfig.tiny(fused_optimizer=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        ttf.TransformerConfig.tiny(loss_chunks=4)
    ttf.TransformerConfig.tiny(loss_impl="kernel", loss_chunks=4)
    with pytest.raises(ValueError, match="loss_impl"):
        ttf.TransformerConfig.tiny(loss_impl="chunked")
    with pytest.raises(ValueError, match="attention_impl"):
        ttf.TransformerConfig.tiny(attention_impl="interpret")

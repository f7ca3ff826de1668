"""Port parity: the train step of
``distributed_tensorflow_tpu_torch.models.transformer`` against the JAX
``make_train_step`` on the CPU, at ``tiny()`` in f32.

Both start from the same flax init (through ``params_from_jax``) and
take 5 AdamW steps on the same numpy token batch, in each variant of
``VARIANTS``: the kernel loss, full logits, the fused optimizer
(``fused_optimizer=True``), the scan-chunked loss with both chunk
policies, and ``remat`` with the "nothing", "dots", "attn" and
"dots_attn" policies; f32 or bf16 ``mu``. The JAX side runs its Pallas kernels in interpret mode
(``attention_impl="interpret"``, ``loss_kernel_impl="interpret"`` for
the kernel loss, ``optimizer_impl="interpret"`` for the fused
optimizer); the port runs the plain versions of its kernels, which is
what its wrappers take for CPU tensors. Compared: the loss of every
step, every gradient leaf of the first step, and the parameters and
both AdamW moments after the 5 steps. Tolerances, each for its reason:

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


KERNEL_LOSS = dict(loss_impl="kernel")
FULL_LOGITS = dict(loss_impl="scan", loss_chunks=0)
# variant: config options given to both packages (the JAX side adds its
# interpret-mode kernels); "mu_bf16" in the name stores AdamW's mu in bf16
VARIANTS = {
    "kernel": KERNEL_LOSS,
    "kernel_mu_bf16": KERNEL_LOSS,
    "scan": FULL_LOGITS,
    "fused_opt": dict(KERNEL_LOSS, fused_optimizer=True),
    "fused_opt_mu_bf16": dict(KERNEL_LOSS, fused_optimizer=True),
    "chunks_recompute": dict(loss_impl="scan", loss_chunks=4,
                             loss_chunk_policy="recompute"),
    "chunks_save": dict(loss_impl="scan", loss_chunks=4,
                        loss_chunk_policy="save"),
    "remat_nothing": dict(FULL_LOGITS, remat=True, remat_policy="nothing"),
    "remat_dots": dict(KERNEL_LOSS, remat=True, remat_policy="dots"),
    "remat_attn": dict(KERNEL_LOSS, remat=True, remat_policy="attn"),
    "remat_dots_attn": dict(FULL_LOGITS, remat=True,
                            remat_policy="dots_attn"),
}


def _options(variant):
    return dict({"remat": False}, **VARIANTS[variant])


def _jax_run(variant):
    mu = jnp.bfloat16 if variant.endswith("mu_bf16") else None
    kw = _options(variant)
    if kw["loss_impl"] == "kernel":
        kw["loss_kernel_impl"] = "interpret"
    if kw.get("fused_optimizer"):
        kw["optimizer_impl"] = "interpret"
    cfg = jtf.TransformerConfig.tiny(max_seq_len=S,
                                     attention_impl="interpret",
                                     adam_mu_dtype=mu, **kw)
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
    mu = torch.bfloat16 if variant.endswith("mu_bf16") else None
    # the flash path, as the JAX side's attention_impl="interpret"
    cfg = ttf.TransformerConfig.tiny(max_seq_len=S, adam_mu_dtype=mu,
                                     attention_impl=None,
                                     **_options(variant))
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
    assert all(opt.state[p]["count"] == STEPS for p in model.parameters())
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


@pytest.fixture(scope="module", params=list(VARIANTS))
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
                if variant.endswith("mu_bf16") else _rel_to_max(1e-4))
    _compare(cfg, got["mu"], want["mu"], mu_check)


def test_unported_options_raise():
    """Every option of the single-device step is accepted, the "attn"
    remat policies too; bad values are refused where the config is
    made."""
    ttf.TransformerConfig.tiny(fused_optimizer=True)
    ttf.TransformerConfig.tiny(loss_chunks=4, loss_chunk_policy="save")
    ttf.TransformerConfig.tiny(loss_impl="kernel", loss_chunks=4)
    ttf.TransformerConfig.tiny(remat=True, remat_policy="dots",
                               scan_layers=False)
    for policy in ("attn", "dots_attn"):
        cfg = ttf.TransformerConfig.tiny(remat=True, remat_policy=policy)
        assert cfg.remat_policy in ttf.REMAT_POLICIES
    with pytest.raises(ValueError, match="remat_policy"):
        ttf.TransformerConfig.tiny(remat_policy="everything")
    with pytest.raises(ValueError, match="loss_chunk_policy"):
        ttf.TransformerConfig.tiny(loss_chunk_policy="keep")
    with pytest.raises(ValueError, match="loss_impl"):
        ttf.TransformerConfig.tiny(loss_impl="chunked")
    with pytest.raises(ValueError, match="attention_impl"):
        ttf.TransformerConfig.tiny(attention_impl="interpret")


def test_fused_optimizer_refuses_another_optimizer():
    """``fused_optimizer=True`` replaces the whole optimizer, so anything
    but ``make_optimizer(cfg, model.parameters())`` raises (the JAX
    step's state-structure check)."""
    cfg = ttf.TransformerConfig.tiny(fused_optimizer=True)
    model = ttf.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    ttf.make_train_step(cfg, model, ttf.make_optimizer(cfg,
                                                       model.parameters()))
    others = [
        torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate),
        ttf.AdamW(model.parameters(), lr=1e-3,
                  weight_decay=cfg.weight_decay),
        ttf.AdamW(model.parameters(), lr=cfg.learning_rate,
                  weight_decay=cfg.weight_decay, betas=(0.8, 0.999)),
        ttf.AdamW(model.parameters(), lr=cfg.learning_rate,
                  weight_decay=cfg.weight_decay, mu_dtype=torch.bfloat16),
        ttf.AdamW(list(model.parameters())[1:], lr=cfg.learning_rate,
                  weight_decay=cfg.weight_decay),
    ]
    for opt in others:
        with pytest.raises(ValueError, match="make_optimizer"):
            ttf.make_train_step(cfg, model, opt)


def test_fused_next_token_loss_matches_full_logits():
    """The chunked loss equals ``next_token_loss`` over full logits, in
    value and gradient, for both chunk policies; a chunk count that does
    not divide the sequence raises."""
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.normal(size=(2, 12, 16)).astype(
        np.float32))
    embed = torch.from_numpy(0.1 * rng.normal(size=(50, 16)).astype(
        np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50, (2, 12)))

    def value_and_grads(fn):
        h, e = (x.clone().requires_grad_() for x in (hidden, embed))
        loss = fn(h, e)
        loss.backward()
        return loss.item(), h.grad, e.grad

    want = value_and_grads(
        lambda h, e: ttf.next_token_loss(h @ e.T, tokens))
    for policy in ("recompute", "save"):
        got = value_and_grads(lambda h, e: ttf.fused_next_token_loss(
            h, e, tokens, num_chunks=3, compute_dtype=torch.float32,
            chunk_policy=policy))
        assert got[0] == pytest.approx(want[0], rel=1e-6)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        ttf.fused_next_token_loss(hidden, embed, tokens, num_chunks=5)


def test_remat_only_while_grad_is_enabled(monkeypatch):
    """``remat=True`` checkpoints each block in a differentiable forward
    and leaves a no-grad forward (the serving paths) as it was."""
    calls = []
    real = ttf.checkpoint

    def counting(*a, **kw):
        calls.append(kw["context_fn"])
        return real(*a, **kw)

    monkeypatch.setattr(ttf, "checkpoint", counting)
    cfg = ttf.TransformerConfig.tiny(remat=True, remat_policy="dots")
    model = ttf.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    tokens = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        plain = model(tokens)
    assert calls == []
    out = model(tokens)
    assert calls == [ttf.REMAT_POLICIES["dots"]] * cfg.n_layers
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("remat, policy, per_layer", [
    (False, "nothing", 1), (True, "nothing", 2), (True, "dots", 2),
    (True, "attn", 1), (True, "dots_attn", 1)])
def test_flash_forward_runs_per_policy(monkeypatch, remat, policy,
                                       per_layer):
    """One train step on the flash path runs the flash forward once a
    layer, and again in the backward's recompute unless the policy saves
    the registered op's outputs ("attn", "dots_attn"): the plain forward
    (what a CPU tensor takes) counted by a wrapper."""
    from distributed_tensorflow_tpu_torch.ops import attention as tattn
    calls = []
    real = tattn.flash_attention_plain

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_plain", counting)
    cfg = ttf.TransformerConfig.tiny(max_seq_len=S, attention_impl=None,
                                     remat=remat, remat_policy=policy)
    model = ttf.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    opt = ttf.make_optimizer(cfg, model.parameters())
    step = ttf.make_train_step(cfg, model, opt)
    step({"model": model, "optimizer": opt, "step": 0},
         {"tokens": torch.from_numpy(_tokens()).long()})
    assert len(calls) == per_layer * cfg.n_layers

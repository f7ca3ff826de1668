"""Port parity: ``distributed_tensorflow_tpu_torch.models.bert`` against
the JAX ``models/bert.py`` on the CPU, at ``tiny_bert_config`` size.

- ``synthetic_corpus``: the same numpy draw, token for token.
- ``mlm_loss``: random logits with ignored labels, and a batch with no
  masked position (loss 0 in both), within 1e-6 absolute (f32 sums in
  another order).
- ``apply_mlm_masking``: its invariants (labels ignored exactly where
  unselected, inputs unchanged there; the 0.15 selected share and its
  0.8 / 0.1 / 0.1 split within 4 binomial sigma on a 64 x 512 draw; a
  seed gives the same masks). Torch's generator cannot give
  ``jax.random``'s bits, so the rule is compared, not the draw.
- The train step: 5 AdamW steps from the same flax init on the same
  corpus, with JAX's own masks (``apply_mlm_masking(fold_in(PRNGKey(
  seed), step), ...)``) fed to the port through ``masking=``, in each of
  ``VARIANTS``: full logits, the kernel loss (JAX's fused CE and flash
  kernels in interpret mode; the port's plain versions on the flash
  path) and ``fused_optimizer=True`` (JAX's BERT step always runs
  ``tx.update``; with an f32 ``mu`` the fused update gives optax's
  numbers). Compared: every step's loss, every gradient leaf of the
  first step (against ``jax.grad`` of the JAX loss at the init), and
  the parameters and both AdamW moments after 5 steps, with the
  tolerances of ``tests/test_torch_train_step.py`` and their reasons
  (and, for the parameters, the exemption stated in the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import transformer as jtf
from distributed_tensorflow_tpu.ops.fused_ce import (
    fused_cross_entropy as jax_fused_ce)
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import transformer as ttf

B, S, STEPS, SEED = 4, 16, 5, 3


def test_synthetic_corpus_equals_jax():
    for shape in ((4, 16, 256), (3, 40, 30522)):
        want = np.asarray(jbert.synthetic_corpus(*shape, seed=7)["tokens"])
        got = tbert.synthetic_corpus(*shape, seed=7, device="cpu")["tokens"]
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", ["some", "none"])
def test_mlm_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 10, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 10)).astype(np.int32)
    ignore = rng.random((3, 10)) < 0.7
    if masked == "none":
        ignore[:] = True
    labels[ignore] = jbert.IGNORE_LABEL
    want = float(jbert.mlm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = tbert.mlm_loss(torch.from_numpy(logits),
                         torch.from_numpy(labels).long()).item()
    assert abs(got - want) <= 1e-6
    if masked == "none":
        assert got == 0.0


def test_masking_invariants():
    """On 64 x 512 uniform tokens in [2, V) (so no original token is the
    MASK id, and a random replacement equals the original with
    probability 1/V): labels and inputs outside the selection, the shares
    of the selection, and the same masks from the same seed."""
    V = 30522
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        2, V, (64, 512)))
    draw = lambda seed: tbert.apply_mlm_masking(  # noqa: E731
        torch.Generator().manual_seed(seed), tokens, vocab_size=V)
    inputs, labels = draw(5)
    sel = labels != tbert.IGNORE_LABEL
    assert inputs.dtype == tokens.dtype and labels.dtype == tokens.dtype
    assert torch.equal(labels[sel], tokens[sel])
    assert torch.equal(inputs[~sel], tokens[~sel])
    n, k = tokens.numel(), int(sel.sum())

    def within_4_sigma(share, p, count):
        assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / count), \
            (share, p, count)

    within_4_sigma(k / n, 0.15, n)
    masked = int((inputs[sel] == tbert.MASK_TOKEN).sum())
    kept = int((inputs[sel] == tokens[sel]).sum())
    within_4_sigma(masked / k, 0.8, k)
    within_4_sigma(kept / k, 0.1, k)
    within_4_sigma((k - masked - kept) / k, 0.1, k)
    again = draw(5)
    assert torch.equal(again[0], inputs) and torch.equal(again[1], labels)
    assert not torch.equal(draw(6)[1], labels)


def test_default_masking_draws_from_seed_and_step():
    """Without ``masking=``, step ``t`` masks with ``apply_mlm_masking``
    from a generator seeded by ``mask_seed(seed, t)``: the same losses as
    a step fed those masks, and other masks at every step."""
    cfg = tbert.tiny_bert_config(max_seq_len=S)
    batch = tbert.synthetic_corpus(B, S, cfg.vocab_size, device="cpu")
    losses = {}
    for mode in ("default", "explicit"):
        model = ttf.TransformerLM(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        opt = ttf.make_optimizer(cfg, model.parameters())

        def explicit(step, tokens):
            gen = torch.Generator().manual_seed(tbert.mask_seed(SEED, step))
            return tbert.apply_mlm_masking(gen, tokens,
                                           vocab_size=cfg.vocab_size)

        step = tbert.make_train_step(
            cfg, model, opt, seed=SEED,
            masking=explicit if mode == "explicit" else None)
        state = {"model": model, "optimizer": opt, "step": 0}
        losses[mode] = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses[mode].append(metrics["loss"].item())
    assert losses["default"] == losses["explicit"]
    assert len({tbert.mask_seed(SEED, t) for t in range(3)}) == 3


FULL_LOGITS = dict(loss_impl="scan", loss_chunks=0)
KERNEL_LOSS = dict(loss_impl="kernel")
# variant: config options given to both packages; "kernel" runs the
# flash path on both sides (JAX in interpret mode), the others the
# unfused attention of tiny_bert_config
VARIANTS = {
    "full_logits": FULL_LOGITS,
    "kernel": KERNEL_LOSS,
    "fused_opt": dict(FULL_LOGITS, fused_optimizer=True),
}


def _jax_masks(tokens, vocab_size):
    return [jbert.apply_mlm_masking(
        jax.random.fold_in(jax.random.PRNGKey(SEED), t), tokens,
        vocab_size=vocab_size) for t in range(STEPS)]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_run(variant):
    kw = dict(VARIANTS[variant])
    if kw["loss_impl"] == "kernel":
        kw.update(loss_kernel_impl="interpret", attention_impl="interpret")
    cfg = jbert.tiny_bert_config(max_seq_len=S, **kw)
    model = jtf.TransformerLM(cfg)
    tokens = jbert.synthetic_corpus(B, S, cfg.vocab_size, seed=SEED)[
        "tokens"]
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    masks = _jax_masks(tokens, cfg.vocab_size)

    def loss(p, inputs, labels):
        if cfg.loss_impl != "kernel":
            return jbert.mlm_loss(model.apply({"params": p}, inputs), labels)
        # JAX's kernel_loss_fn (models/bert.py:76-97) on one device
        hidden = model.apply({"params": p}, inputs, return_hidden=True)
        mask = labels != jbert.IGNORE_LABEL
        losses = jax_fused_ce(
            hidden.reshape(B * S, -1), p["embed"].astype(cfg.dtype),
            jnp.where(mask, labels, 0).reshape(B * S),
            implementation="interpret").reshape(B, S)
        return (losses * mask).sum() / jnp.maximum(mask.sum(), 1)

    grads = jax.grad(loss)(params, *masks[0])
    tx = jtf.make_optimizer(cfg)
    step = jax.jit(jbert.make_train_step(cfg, model, tx, seed=SEED))
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    adam = state["opt_state"][0]
    return {"init": _np(params), "grads": _np(grads), "losses": losses,
            "params": _np(state["params"]), "mu": _np(adam.mu),
            "nu": _np(adam.nu), "tokens": np.asarray(tokens),
            "masks": [tuple(np.asarray(a) for a in m) for m in masks]}


def _port_run(variant, want):
    kw = dict(VARIANTS[variant])
    if kw["loss_impl"] == "kernel":
        kw["attention_impl"] = None    # the flash path, as JAX's interpret
    cfg = tbert.tiny_bert_config(max_seq_len=S, **kw)
    model = ttf.TransformerLM(cfg, ttf.params_from_jax(cfg, want["init"],
                                                       device="cpu"),
                              device="cpu")
    opt = ttf.make_optimizer(cfg, model.parameters())
    masks = [tuple(torch.tensor(a, dtype=torch.long) for a in m)
             for m in want["masks"]]
    seen = []

    def masking(step, tokens):
        seen.append(step)
        return masks[step]

    step = tbert.make_train_step(cfg, model, opt, seed=SEED, masking=masking)
    state = {"model": model, "optimizer": opt, "step": 0}
    batch = {"tokens": torch.tensor(want["tokens"], dtype=torch.long)}
    losses, grads = [], None
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        if grads is None:
            grads = model.stacked_params(lambda p: p.grad.clone())
    assert seen == list(range(STEPS)) and state["step"] == STEPS
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


def _compare(cfg, got, want_np, frac=None, atol=None):
    want = dict(_leaves(ttf.params_from_jax(cfg, want_np, device="cpu")))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want) and len(got) == 10
    for name, g in got.items():
        w = want[name].numpy()
        tol = atol if atol is not None else frac * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request):
    want = _jax_run(request.param)
    cfg, got = _port_run(request.param, want)
    return cfg, got, want


def test_bert_losses_match(runs):
    _, got, want = runs
    np.testing.assert_allclose(got["losses"], want["losses"], atol=2e-6,
                               rtol=0)


def test_bert_gradients_match(runs):
    cfg, got, want = runs
    _compare(cfg, got["grads"], want["grads"], frac=1e-4)


def test_bert_params_and_moments_after_adamw_steps(runs):
    """Parameters within 1e-5 absolute, except where the first step's
    reference gradient lies within the gradient tolerance (1e-4 of the
    leaf's largest) of zero: there both runs' gradients are f32 noise,
    which Adam's first step divides by its own size (plus eps 1e-8), so
    the two updates part by up to the learning rate. Those elements are
    held to the most 5 steps can move an element, 5 lr times a margin of
    2 for Adam's bias-corrected ratio."""
    cfg, got, want = runs
    ref_grads = dict(_leaves(ttf.params_from_jax(cfg, want["grads"],
                                                 device="cpu")))
    ref_params = dict(_leaves(ttf.params_from_jax(cfg, want["params"],
                                                  device="cpu")))
    for name, p in _leaves(got["params"]):
        g = ref_grads[name].abs()
        noise = g <= 1e-4 * g.max()
        diff = (p - ref_params[name]).abs()
        assert diff[~noise].max() <= 1e-5, name
        assert diff.max() <= 2 * STEPS * cfg.learning_rate, name
    _compare(cfg, got["nu"], want["nu"], frac=1e-3)
    _compare(cfg, got["mu"], want["mu"], frac=1e-4)


def test_kernel_mlm_loss_equals_full_logits_loss():
    """The fused-CE MLM loss equals ``mlm_loss`` over full logits, in
    value and gradient, also with no masked position (0, zero
    gradients)."""
    rng = np.random.default_rng(4)
    hidden = torch.from_numpy(rng.normal(size=(2, 12, 16)).astype(
        np.float32))
    embed = torch.from_numpy(0.1 * rng.normal(size=(50, 16)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 50, (2, 12)))
    labels[torch.from_numpy(rng.random((2, 12)) < 0.6)] = \
        tbert.IGNORE_LABEL
    for lab in (labels, torch.full_like(labels, tbert.IGNORE_LABEL)):
        def value_and_grads(fn):
            h, e = (x.clone().requires_grad_() for x in (hidden, embed))
            loss = fn(h, e)
            loss.backward()
            return loss.item(), h.grad, e.grad

        want = value_and_grads(lambda h, e: tbert.mlm_loss(h @ e.T, lab))
        got = value_and_grads(lambda h, e: tbert.kernel_mlm_loss(
            h, e, lab, compute_dtype=torch.float32))
        assert got[0] == pytest.approx(want[0], rel=1e-6, abs=1e-7)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)

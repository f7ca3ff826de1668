"""BERT-style MLM pretraining — port of
``distributed_tensorflow_tpu/models/bert.py`` (benchmark workload #3).

The port's transformer in bidirectional-encoder mode (``causal=False``)
with the masked-language-model machinery: the synthetic corpus, dynamic
80/10/10 masking, the masked-position cross-entropy and the train step.

- :func:`bert_config` / :func:`tiny_bert_config` — ``bert_base`` and
  the test size (``tiny(causal=False)``, which keeps
  ``attention_impl="reference"`` as JAX's does).
- :func:`synthetic_corpus` — JAX's numpy draw, token for token.
- :func:`apply_mlm_masking` — the 80/10/10 rule from a
  ``torch.Generator`` (the numbers differ from ``jax.random``'s; the
  rule is the same).
- :func:`mlm_loss` — CE over the masked positions of full logits.
- :func:`kernel_mlm_loss` — the same through the fused CE kernels
  against the tied embedding, without the ``(B, S, V)`` logits.
- :func:`make_loss_fn` / :func:`make_train_step` — the step, fresh masks
  each step from a generator seeded by ``(seed, step)``.

The sharded step (JAX ``make_sharded_train_step``) belongs to the
multi-GPU slice.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, resolve_device, train_step_around)
from distributed_tensorflow_tpu_torch.ops.fused_ce import (
    fused_cross_entropy)

MASK_TOKEN = 1           # convention: [MASK] id
IGNORE_LABEL = -100


def bert_config(**kw) -> TransformerConfig:
    return TransformerConfig.bert_base(**kw)


def tiny_bert_config(**kw) -> TransformerConfig:
    return TransformerConfig.tiny(causal=False, **kw)


def synthetic_corpus(global_batch: int, seq_len: int, vocab_size: int,
                     seed: int = 0, device="cuda") -> dict:
    """``{"tokens": (global_batch, seq_len)}`` int64 on ``device``: JAX's
    Zipf-like draw from ``np.random.default_rng(seed)``, so the tokens
    equal the JAX package's exactly."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(2, vocab_size + 2)
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=(global_batch, seq_len), p=probs)
    return {"tokens": torch.from_numpy(toks).to(device=device,
                                                dtype=torch.int64)}


def apply_mlm_masking(generator: torch.Generator, tokens, *,
                      mask_rate: float = 0.15,
                      mask_token: int = MASK_TOKEN, vocab_size: int = 256):
    """BERT 80/10/10 dynamic masking: each position is selected with
    probability ``mask_rate``; a selected position becomes
    ``mask_token`` (80 %), a uniform random token (10 %) or stays (10 %).
    Returns ``(inputs, labels)``, ``labels`` ``IGNORE_LABEL`` where not
    selected. ``generator`` lives on ``tokens``' device."""
    dev = tokens.device
    selected = torch.rand(tokens.shape, generator=generator,
                          device=dev) < mask_rate
    kind = torch.rand(tokens.shape, generator=generator, device=dev)
    random_tokens = torch.randint(0, vocab_size, tokens.shape,
                                  generator=generator, device=dev,
                                  dtype=tokens.dtype)
    inputs = torch.where(selected & (kind < 0.8), mask_token, tokens)
    inputs = torch.where(selected & (kind >= 0.8) & (kind < 0.9),
                         random_tokens, inputs)
    labels = torch.where(selected, tokens, IGNORE_LABEL)
    return inputs, labels


def _masked_mean(losses, labels, count=None):
    """``sum(losses · mask) / max(mask.sum(), 1)`` over the positions
    whose label is not ``IGNORE_LABEL``, in f32; ``count`` replaces the
    denominator (a data shard's share of the global batch's mean)."""
    mask = labels != IGNORE_LABEL
    if count is None:
        count = mask.sum().clamp_min(1)
    return (losses * mask).sum() / count


def mlm_loss(logits, labels, count=None):
    """Cross-entropy over masked positions only (JAX ``:54-61``): f32 CE
    of ``logits`` against the labels (0 where ignored), averaged over the
    masked positions (or divided by ``count``); 0 for a batch with
    none."""
    safe = torch.where(labels != IGNORE_LABEL, labels, 0)
    logits = logits.float()
    tl = logits.gather(-1, safe[..., None])[..., 0]
    return _masked_mean(torch.logsumexp(logits, dim=-1) - tl, labels, count)


def kernel_mlm_loss(hidden, embed, labels, *, compute_dtype, count=None):
    """:func:`mlm_loss` of ``hidden @ embed.T`` through the fused CE
    kernels (:func:`~distributed_tensorflow_tpu_torch.ops.fused_ce.
    fused_cross_entropy`), hidden and the tied embedding cast to
    ``compute_dtype``: the ``(B, S, V)`` logits never exist (JAX
    ``:76-97``)."""
    B, S, D = hidden.shape
    safe = torch.where(labels != IGNORE_LABEL, labels, 0)
    losses = fused_cross_entropy(
        hidden.reshape(B * S, D).to(compute_dtype),
        embed.to(compute_dtype), safe.reshape(B * S))
    return _masked_mean(losses.reshape(B, S), labels, count)


def make_loss_fn(cfg: TransformerConfig, model: TransformerLM):
    """``loss_fn(inputs, labels, count=None) -> scalar``:
    :func:`kernel_mlm_loss` on the model's hidden states for
    ``loss_impl="kernel"``, else :func:`mlm_loss` on its full logits."""
    def loss_fn(inputs, labels, count=None):
        if cfg.loss_impl == "kernel":
            hidden = model(inputs, return_hidden=True)
            return kernel_mlm_loss(hidden, model.embed, labels,
                                   compute_dtype=cfg.dtype, count=count)
        return mlm_loss(model(inputs), labels, count)

    return loss_fn


def mask_seed(seed: int, step: int) -> int:
    """The generator seed of ``step``'s masks: ``(seed, step)`` through
    numpy's ``SeedSequence`` — the counterpart of ``fold_in(PRNGKey(seed),
    step)``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def make_train_step(cfg: TransformerConfig, model: TransformerLM,
                    optimizer: torch.optim.Optimizer, seed: int = 0,
                    masking=None):
    """``train_step(state, batch{"tokens"}) -> (state, {"loss"})``, the
    port transformer's step (:func:`~distributed_tensorflow_tpu_torch.
    models.transformer.train_step_around`: in place, the fused AdamW
    with ``cfg.fused_optimizer``) on the MLM objective of
    :func:`make_loss_fn`.

    Masks are drawn afresh every step (dynamic masking) by
    ``masking(step, tokens) -> (inputs, labels)``; by default
    :func:`apply_mlm_masking` from a generator on the model's device
    seeded by :func:`mask_seed` ``(seed, step)``. Pass ``masking`` to
    feed masks from elsewhere (a test feeds JAX's own, which no torch
    generator can reproduce)."""
    device = model.embed.device
    if masking is None:
        def masking(step, tokens):
            gen = torch.Generator(device=device)
            gen.manual_seed(mask_seed(seed, step))
            return apply_mlm_masking(gen, tokens,
                                     vocab_size=cfg.vocab_size)

    loss_fn = make_loss_fn(cfg, model)

    def loss_of_batch(step, batch):
        return loss_fn(*masking(step, batch["tokens"]))

    return train_step_around(cfg, model, optimizer, loss_of_batch)


def make_sharded_train_step(cfg: TransformerConfig, mesh, global_batch: int,
                            seed: int = 0, *, params=None):
    """Data-parallel BERT MLM (JAX ``:121``): the transformer's
    :func:`~distributed_tensorflow_tpu_torch.models.transformer.
    make_sharded_train_step` with the MLM step through ``step_factory``.
    Every rank draws the masks of the **global** batch from the ``(seed,
    step)`` generator and takes its own rows; its loss is its masked
    sum over the global batch's masked count, times the shard count, so
    the meaned gradients and loss are the single-device step's on the
    global batch."""
    if cfg.causal:
        raise ValueError("BERT requires causal=False (encoder mode)")
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_sharded_train_step as _transformer_sharded_step)

    def factory(cfg, model, optimizer, shard):
        device = model.embed.device
        loss_fn = make_loss_fn(cfg, model)

        def loss_of_batch(step, batch):
            gen = torch.Generator(device=device)
            gen.manual_seed(mask_seed(seed, step))
            inputs, labels = apply_mlm_masking(gen, batch["tokens"],
                                               vocab_size=cfg.vocab_size)
            count = (labels != IGNORE_LABEL).sum().clamp_min(1)
            return loss_fn(inputs[shard.rows], labels[shard.rows],
                           count) * shard.n_shards

        return train_step_around(cfg, model, optimizer, loss_of_batch,
                                 sync_grads=shard.sync_grads)

    return _transformer_sharded_step(cfg, mesh, global_batch, seed=seed,
                                     step_factory=factory, params=params)

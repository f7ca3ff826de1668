"""Incremental decode for the transformer/BERT family — port of
``distributed_tensorflow_tpu/serving/decode.py``.

Functions over the port's stacked parameter dict
(:func:`canonical_params`) and the block-allocated KV pool
(serving/kv_cache.py):

- :func:`make_prefill_fn` — one prompt through the full forward at its
  exact length, writing every position's rotary-embedded K and V into
  the sequence's cache rows and returning the last position's logits.
  The JAX program pads prompts to a fixed ``(1, max_seq_len)`` shape so
  it compiles once, and then needs the length mask; eager PyTorch has
  no such reason, so the port's prefill attention is the unmasked
  causal flash forward (a flash-forward CUDA kernel on the card) —
  the same function on every row that is ever read — or, where
  ``cfg.attention_impl`` is ``"reference"`` (``tiny()``), the unfused
  ``mha_reference``.
- :func:`make_decode_fn` — one token per running sequence: project
  q/k/v, write k/v into the sequence's current row, gather its block
  window and attend the single query against it. This attention stays
  plain PyTorch (:func:`~distributed_tensorflow_tpu_torch.ops.attention.
  mha_reference` with the factored length mask), as it is plain jnp in
  the JAX package.

The pool is one dict (``{"k", "v"}`` plus ``{"k_scale", "v_scale"}``
for int8) updated IN PLACE (index assignment), where the JAX programs
return a new pool: writes quantize on the way in, gathers dequantize on
the way out (:func:`_pool_write` / :func:`_pool_window`).
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, merge_heads, project_heads, rms_norm,
    rotary_embedding, swiglu)
from distributed_tensorflow_tpu_torch.ops.attention import (
    flash_attention, mha_reference)


def canonical_params(cfg: TransformerConfig, params) -> dict:
    """Parameter dict in the stacked-layers layout the decode functions
    index (``params["layers"]`` leaves shaped ``(L, ...)``): unstacked
    ``layer_<i>`` dicts are stacked."""
    params = {k: v for k, v in params.items()}
    if "layers" in params:
        return params
    names = [f"layer_{i}" for i in range(cfg.n_layers)]
    missing = [n for n in names if n not in params]
    if missing:
        raise ValueError(f"params have neither 'layers' nor {missing}")
    layers = [params.pop(n) for n in names]
    params["layers"] = {g: {n: torch.stack([lay[g][n] for lay in layers])
                            for n in layers[0][g]}
                        for g in layers[0]}
    return params


def _layer(params, l: int) -> dict:
    return {g: {n: a[l] for n, a in leaves.items()}
            for g, leaves in params["layers"].items()}


def _rms_norm(x, scale, dtype, eps: float = 1e-6):
    """models/transformer RMSNorm math, parameter passed explicitly."""
    return rms_norm(x, scale, dtype, eps)


def rotary_at(x, positions, *, base: float = 10000.0):
    """RoPE at explicit absolute positions: ``x`` is ``(B, H, Q, hd)``,
    ``positions`` ``(B, Q)``. The same angle formula as
    ``rotary_embedding``, so a token's K is the same whether computed in
    prefill or one at a time in decode."""
    d = x.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    ang = positions.float()[..., None] * inv_freq          # (B, Q, d/2)
    sin = torch.sin(ang)[:, None]                           # (B,1,Q,d/2)
    cos = torch.cos(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# pool write / gather (the quantisation seam)
# ---------------------------------------------------------------------------

def _quantize_rows(x):
    """``(..., H, hd)`` float → int8 codes + per-(row, head) f32 scale:
    symmetric absmax over one head's ``hd``-vector of one pool row."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _pool_write(pool: dict, l: int, rows, k, v, quantized: bool) -> dict:
    """Scatter new K/V rows (``(N, H, hd)`` compute dtype) into layer
    ``l`` of the pool at flat ``rows``, in place; int8 pools quantize on
    write and store the scales alongside."""
    if quantized:
        qk, sk = _quantize_rows(k)
        qv, sv = _quantize_rows(v)
        pool["k"][l, rows] = qk
        pool["v"][l, rows] = qv
        pool["k_scale"][l, rows] = sk
        pool["v_scale"][l, rows] = sv
    else:
        pool["k"][l, rows] = k.to(pool["k"].dtype)
        pool["v"][l, rows] = v.to(pool["v"].dtype)
    return pool


def _pool_window(pool: dict, l: int, window_rows, dt, quantized: bool):
    """Gather each sequence's block window from layer ``l``:
    ``(B, W, H, hd)`` → ``(B, H, W, hd)`` in ``dt``, dequantized for
    int8 pools."""
    kw = pool["k"][l][window_rows]
    vw = pool["v"][l][window_rows]
    if quantized:
        kw = kw.float() * pool["k_scale"][l][window_rows][..., None]
        vw = vw.float() * pool["v_scale"][l][window_rows][..., None]
    return kw.transpose(1, 2).to(dt), vw.transpose(1, 2).to(dt)


def make_copy_fn():
    """``copy(pool, src_rows, dst_rows)``: rows ``src_rows`` duplicated
    into ``dst_rows`` across every layer and every pool array (values
    and scales), in place — the device side of copy-on-write."""

    def copy(pool, src_rows, dst_rows):
        for a in pool.values():
            a[:, dst_rows] = a[:, src_rows]
        return pool

    return copy


def model_forward(cfg: TransformerConfig, params, tokens, lengths=None, *,
                  return_kv: bool = False, last_only: bool = False):
    """Full-sequence forward over the canonical parameter dict — the
    serving-side twin of ``TransformerLM.forward``. ``lengths`` masks a
    right-padded batch with the factored rule; without it attention is
    the flash forward, or ``mha_reference`` where ``cfg.attention_impl``
    is ``"reference"`` (as in ``TransformerLM.forward``). ``return_kv``
    also returns the per-layer post-RoPE K and V ``(L, B, H, S, hd)`` —
    what prefill writes into the cache.
    ``last_only`` projects only the final position onto the vocabulary
    (``(B, 1, V)`` logits)."""
    dt = cfg.dtype
    embed = params["embed"].to(dt)
    x = embed[tokens]                                    # (B, S, D)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = _rms_norm(x, p["RMSNorm_0"]["scale"], dt)
        att = p["attn"]
        q = rotary_embedding(project_heads(h, att["query"].to(dt)),
                             seq_axis=-2)
        k = rotary_embedding(project_heads(h, att["key"].to(dt)),
                             seq_axis=-2)
        v = project_heads(h, att["value"].to(dt))
        if lengths is not None:
            o = mha_reference(q, k, v, causal=cfg.causal, lengths=lengths)
        elif cfg.attention_impl == "reference":
            o = mha_reference(q, k, v, causal=cfg.causal)
        else:
            o = flash_attention(q, k, v, causal=cfg.causal)
        x = x + merge_heads(o, att["out"].to(dt))
        h = _rms_norm(x, p["RMSNorm_1"]["scale"], dt)
        x = x + _mlp(h, p["mlp"], dt)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if last_only:
        x = x[:, -1:]
    x = _rms_norm(x, params["final_norm"]["scale"], dt)
    logits = (x @ embed.T).float()
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def _mlp(h, mlp, dt):
    return swiglu(h, mlp["wi"].to(dt), mlp["wo"].to(dt))


def make_prefill_fn(cfg: TransformerConfig, cache_cfg=None):
    """``prefill(params, pool, tokens, write_rows)`` → ``(last_logits,
    pool)``.

    ``tokens`` (1, n) one prompt at its exact length, ``write_rows``
    (n,) the flat pool row of each position. ``last_logits`` (vocab,)
    are the logits at the prompt's final position — the first generated
    token's distribution. Writes K/V into ``pool`` in place."""
    quantized = cache_cfg.quantized if cache_cfg is not None else False

    @torch.no_grad()
    def prefill(params, pool, tokens, write_rows):
        logits, (ks, vs) = model_forward(cfg, params, tokens,
                                         return_kv=True, last_only=True)
        for l in range(cfg.n_layers):
            # (1, H, n, hd) -> (n, H, hd)
            _pool_write(pool, l, write_rows, ks[l, 0].transpose(0, 1),
                        vs[l, 0].transpose(0, 1), quantized)
        return logits[0, -1], pool

    return prefill


def make_decode_fn(cfg: TransformerConfig, cache_cfg=None):
    """``decode(params, pool, tokens, positions, lengths, write_rows,
    window_rows)`` → ``(logits, pool)``.

    One incremental step for a batch of running sequences: ``tokens``
    (B,) the token being fed, ``positions`` (B,) its absolute position,
    ``lengths`` (B,) the post-append visible length, ``write_rows`` (B,)
    the flat pool row this token's K/V lands in, ``window_rows`` (B, W)
    each sequence's block-window gather index."""
    if not cfg.causal:
        raise ValueError("incremental decode requires a causal model; "
                         "serve bidirectional (BERT) configs through the "
                         "prefill/scoring path")
    quantized = cache_cfg.quantized if cache_cfg is not None else False

    @torch.no_grad()
    def decode(params, pool, tokens, positions, lengths, write_rows,
               window_rows):
        dt = cfg.dtype
        embed = params["embed"].to(dt)
        x = embed[tokens]                                # (B, D)
        pos_q = positions[:, None]                       # (B, 1)
        for l in range(cfg.n_layers):
            p = _layer(params, l)
            h = _rms_norm(x, p["RMSNorm_0"]["scale"], dt)[:, None]
            att = p["attn"]
            q = rotary_at(project_heads(h, att["query"].to(dt)), pos_q)
            k = rotary_at(project_heads(h, att["key"].to(dt)), pos_q)
            v = project_heads(h, att["value"].to(dt))    # (B, H, 1, hd)
            # write THEN gather: the query must see its own position
            _pool_write(pool, l, write_rows, k[:, :, 0], v[:, :, 0],
                        quantized)
            kw, vw = _pool_window(pool, l, window_rows, dt, quantized)
            o = mha_reference(q, kw, vw, causal=True, lengths=lengths,
                              q_positions=positions)     # (B, H, 1, hd)
            x = x + merge_heads(o, att["out"].to(dt))[:, 0]
            h = _rms_norm(x, p["RMSNorm_1"]["scale"], dt)
            x = x + _mlp(h, p["mlp"], dt)
        x = _rms_norm(x, params["final_norm"]["scale"], dt)
        return (x @ embed.T).float(), pool

    return decode

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
- :func:`make_extend_fn` — E new tokens per sequence at explicit
  absolute positions, written into the pool and then attended against
  the sequence's block window. Two callers: the prefix-cache *suffix
  prefill* (a prompt whose first C tokens matched cached blocks runs
  only its last S tokens; no length mask, so its attention is the
  causal flash forward at ``Sq = S``, ``Sk = C + S``, offset C — the
  flash-forward kernel on the card) and the speculative *verify* (the
  target scores the banked token plus k draft proposals; ragged spans,
  so the masked ``mha_reference``, as in JAX).
- :func:`make_draft_fn` — the speculative proposal: greedy next token
  at each sequence's end by full recompute of a small draft model
  (default :func:`truncated_draft`, the target's first half of
  layers), at the width of the longest sequence; causal, so it needs
  no length mask and its attention is the flash forward too.
- :func:`kv_quantization_probe` — the logit error of a quantized pool
  against an f32 one along one greedy trajectory.

The pool is one dict (``{"k", "v"}`` plus ``{"k_scale", "v_scale"}``
for int8) updated IN PLACE (index assignment), where the JAX programs
return a new pool: writes quantize on the way in, gathers dequantize on
the way out (:func:`_pool_write` / :func:`_pool_window`).

On a serving mesh (JAX's placement, :func:`param_shardings` and
``kv_cache.pool_shardings``) each function takes ``tp``, this rank's
place on the ``tp`` dim (:class:`~distributed_tensorflow_tpu_torch.
parallel.tensor_parallel.TensorParallel`): the parameters and the pool
hold ``n_heads / tp`` heads, ``d_ff / tp`` hidden units and ``V / tp``
vocab rows; the embedding lookup is vocab-parallel, each block's
outputs are all-reduced over ``tp`` and the logits all-gathered. The
decode and speculative-verify functions also take ``dp``: each data
rank runs its contiguous share of the batch's rows and the new K/V rows
are all-gathered over ``dp`` before the write, so every rank's pool
holds every row (rows replicated, as in JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, merge_heads, param_specs, project_heads, rms_norm,
    rotary_embedding, swiglu)
from distributed_tensorflow_tpu_torch.ops.attention import (
    flash_attention, mha_reference)
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    all_gather, tp_reduce)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_embed)


def param_shardings(cfg: TransformerConfig, mesh) -> dict:
    """Each leaf of the canonical serving parameter dict → its sharded
    mesh axes (JAX ``:465``): the training rules
    (:func:`~distributed_tensorflow_tpu_torch.models.transformer.
    param_specs`), heads, ``d_ff`` and the vocabulary over ``tp``."""
    return param_specs(cfg, mesh)


def _embed(params, tokens, dt, tp):
    """The token embeddings: a lookup, vocab-parallel with ``tp``."""
    emb = params["embed"].to(dt)
    return emb[tokens] if tp is None else vocab_parallel_embed(emb, tokens,
                                                               tp)


def _reduce(x, tp):
    """A row-parallel output summed over ``tp`` (as is without)."""
    return x if tp is None else tp_reduce(x, tp.group)


def _gather(x, axis_handle, dim: int):
    """``x`` all-gathered over the handle's mesh dim along ``dim``."""
    if axis_handle is None:
        return x
    return all_gather(x.contiguous(), axis_handle.mesh, axis_handle.axis,
                      axis=dim)


def _dp_rows(dp, n: int) -> slice:
    """This data rank's contiguous share of ``n`` rows (all without
    ``dp``; ``n`` a multiple of its size)."""
    if dp is None:
        return slice(0, n)
    per = n // dp.size
    return slice(dp.rank * per, (dp.rank + 1) * per)


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


def to_compute(params, dtype, device) -> dict:
    """The parameter dict on ``device`` as the serving math reads it:
    matrices in the compute ``dtype``, norm scales f32."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        dt = torch.float32 if name == "scale" else dtype
        return node.to(device=device, dtype=dt)
    return walk(params, None)


def truncated_draft(cfg: TransformerConfig, params, n_layers=None):
    """Self-speculation draft: the target's FIRST ``n_layers`` layers
    (default half, at least one) plus the shared embedding and final
    norm — a draft model that costs nothing to obtain, and the engine's
    default when ``speculative_k > 0`` with no explicit draft. Returns
    ``(draft_cfg, draft_params)`` in the canonical layout; the layer
    tensors are slices of the target's, not copies. Raises outside
    ``[1, cfg.n_layers]``."""
    n = n_layers if n_layers is not None else max(1, cfg.n_layers // 2)
    if not 1 <= n <= cfg.n_layers:
        raise ValueError(f"truncated_draft: n_layers={n} outside "
                         f"[1, {cfg.n_layers}]")
    p = canonical_params(cfg, params)
    p["layers"] = {g: {name: a[:n] for name, a in leaves.items()}
                   for g, leaves in p["layers"].items()}
    return dataclasses.replace(cfg, n_layers=n), p


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
                  return_kv: bool = False, last_only: bool = False,
                  tp=None):
    """Full-sequence forward over the canonical parameter dict — the
    serving-side twin of ``TransformerLM.forward``. ``lengths`` masks a
    right-padded batch with the factored rule; without it attention is
    the flash forward, or ``mha_reference`` where ``cfg.attention_impl``
    is ``"reference"`` (as in ``TransformerLM.forward``). ``return_kv``
    also returns the per-layer post-RoPE K and V ``(L, B, H, S, hd)`` —
    what prefill writes into the cache.
    ``last_only`` projects only the final position onto the vocabulary
    (``(B, 1, V)`` logits). ``tp``: this rank's shards (the module
    docstring); K and V are its heads, the logits whole."""
    x, kv = _hidden(cfg, params, tokens, lengths, return_kv, tp)
    if last_only:
        x = x[:, -1:]
    logits = _logits(params, x, cfg, tp)
    if return_kv:
        return logits, kv
    return logits


def _hidden(cfg: TransformerConfig, params, tokens, lengths=None,
            return_kv: bool = False, tp=None):
    """The full forward up to the final norm: ``(x (B, S, D), kv)``,
    ``kv`` the per-layer K and V stacks when ``return_kv`` (else None).
    Attention as :func:`model_forward` says."""
    dt = cfg.dtype
    x = _embed(params, tokens, dt, tp)                   # (B, S, D)
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
        x = x + _reduce(merge_heads(o, att["out"].to(dt)), tp)
        h = _rms_norm(x, p["RMSNorm_1"]["scale"], dt)
        x = x + _reduce(_mlp(h, p["mlp"], dt), tp)
        if return_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def _logits(params, x, cfg: TransformerConfig, tp=None):
    """Final norm and the tied-embedding projection, in f32; with ``tp``
    each rank's vocab columns all-gathered into the whole row, the pad
    columns of a padded vocabulary dropped."""
    dt = cfg.dtype
    x = _rms_norm(x, params["final_norm"]["scale"], dt)
    logits = _gather((x @ params["embed"].to(dt).T).float(), tp, -1)
    return logits if tp is None else logits[..., :cfg.vocab_size]


def _mlp(h, mlp, dt):
    return swiglu(h, mlp["wi"].to(dt), mlp["wo"].to(dt))


def make_prefill_fn(cfg: TransformerConfig, cache_cfg=None, tp=None):
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
                                         return_kv=True, last_only=True,
                                         tp=tp)
        for l in range(cfg.n_layers):
            # (1, H, n, hd) -> (n, H, hd)
            _pool_write(pool, l, write_rows, ks[l, 0].transpose(0, 1),
                        vs[l, 0].transpose(0, 1), quantized)
        return logits[0, -1], pool

    return prefill


def make_decode_fn(cfg: TransformerConfig, cache_cfg=None, tp=None,
                   dp=None):
    """``decode(params, pool, tokens, positions, lengths, write_rows,
    window_rows)`` → ``(logits, pool)``.

    One incremental step for a batch of running sequences: ``tokens``
    (B,) the token being fed, ``positions`` (B,) its absolute position,
    ``lengths`` (B,) the post-append visible length, ``write_rows`` (B,)
    the flat pool row this token's K/V lands in, ``window_rows`` (B, W)
    each sequence's block-window gather index. With ``dp`` (B a multiple
    of its size) the logits are this data rank's rows only."""
    if not cfg.causal:
        raise ValueError("incremental decode requires a causal model; "
                         "serve bidirectional (BERT) configs through the "
                         "prefill/scoring path")
    quantized = cache_cfg.quantized if cache_cfg is not None else False

    @torch.no_grad()
    def decode(params, pool, tokens, positions, lengths, write_rows,
               window_rows):
        dt = cfg.dtype
        mine = _dp_rows(dp, tokens.shape[0])
        tokens, positions, lengths, window_rows = (
            a[mine] for a in (tokens, positions, lengths, window_rows))
        x = _embed(params, tokens, dt, tp)               # (B, D)
        pos_q = positions[:, None]                       # (B, 1)
        for l in range(cfg.n_layers):
            p = _layer(params, l)
            h = _rms_norm(x, p["RMSNorm_0"]["scale"], dt)[:, None]
            att = p["attn"]
            q = rotary_at(project_heads(h, att["query"].to(dt)), pos_q)
            k = rotary_at(project_heads(h, att["key"].to(dt)), pos_q)
            v = project_heads(h, att["value"].to(dt))    # (B, H, 1, hd)
            # write THEN gather: the query must see its own position;
            # every data rank writes every row
            _pool_write(pool, l, write_rows, _gather(k[:, :, 0], dp, 0),
                        _gather(v[:, :, 0], dp, 0), quantized)
            kw, vw = _pool_window(pool, l, window_rows, dt, quantized)
            o = mha_reference(q, kw, vw, causal=True, lengths=lengths,
                              q_positions=positions)     # (B, H, 1, hd)
            x = x + _reduce(merge_heads(o, att["out"].to(dt))[:, 0], tp)
            h = _rms_norm(x, p["RMSNorm_1"]["scale"], dt)
            x = x + _reduce(_mlp(h, p["mlp"], dt), tp)
        return _logits(params, x, cfg, tp), pool

    return decode


def make_extend_fn(cfg: TransformerConfig, cache_cfg=None, tp=None,
                   dp=None):
    """``extend(params, pool, tokens, positions, lengths, write_rows,
    window_rows)`` → ``(logits, pool)`` — E tokens per sequence in one
    cache-aware forward.

    ``tokens`` (B, E) the new tokens, ``positions`` (B, E) their
    absolute cache positions, ``write_rows`` (B, E) the flat pool rows
    their K/V land in (padded entries at the trash block),
    ``window_rows`` (B, W) the block-window gather index. Every layer
    writes the new K/V, then gathers the window, so query ``i`` sees
    the keys of the span before it. Returns f32 logits ``(B, E, V)`` for
    all E positions: row ``i`` is the next-token distribution after the
    token at ``positions[:, i]``.

    ``lengths`` picks the attention:

    - ``None`` — the prefix-cache suffix prefill: each row's E tokens
      are the last E positions of its window (``window_rows`` covers
      exactly positions ``0..W-1``), with no padding, so the rule is
      plain bottom-right causal, offset ``W - E``. It runs the flash
      forward (the kernel on the card), or ``mha_reference`` where
      ``cfg.attention_impl`` is ``"reference"``, as the prefill does.
    - ``(B,)`` visible lengths — the speculative verify (ragged spans;
      padded entries have positions at or past ``lengths`` so the
      factored mask zeroes them): ``mha_reference(lengths=,
      q_positions=)``, as :func:`make_decode_fn`; with ``dp`` each data
      rank runs its share of the rows, as there, and gets their logits.

    The pool is updated in place."""
    if not cfg.causal:
        raise ValueError("extend requires a causal model; serve "
                         "bidirectional (BERT) configs through the "
                         "prefill/scoring path")
    quantized = cache_cfg.quantized if cache_cfg is not None else False

    @torch.no_grad()
    def extend(params, pool, tokens, positions, lengths, write_rows,
               window_rows):
        dt = cfg.dtype
        split = dp if lengths is not None else None
        mine = _dp_rows(split, tokens.shape[0])
        tokens, positions, window_rows = (
            a[mine] for a in (tokens, positions, window_rows))
        if lengths is not None:
            lengths = lengths[mine]
        x = _embed(params, tokens, dt, tp)               # (B, E, D)
        rows = write_rows.reshape(-1)                    # (B*E,)
        for l in range(cfg.n_layers):
            p = _layer(params, l)
            h = _rms_norm(x, p["RMSNorm_0"]["scale"], dt)
            att = p["attn"]
            q = rotary_at(project_heads(h, att["query"].to(dt)), positions)
            k = rotary_at(project_heads(h, att["key"].to(dt)), positions)
            v = project_heads(h, att["value"].to(dt))    # (B, H, E, hd)
            # write THEN gather: query i must see keys 0..i of the span
            _pool_write(pool, l, rows,
                        _gather(k.transpose(1, 2).flatten(0, 1), split, 0),
                        _gather(v.transpose(1, 2).flatten(0, 1), split, 0),
                        quantized)
            kw, vw = _pool_window(pool, l, window_rows, dt, quantized)
            if lengths is not None:
                o = mha_reference(q, kw, vw, causal=True, lengths=lengths,
                                  q_positions=positions)
            elif cfg.attention_impl == "reference":
                o = mha_reference(q, kw, vw, causal=True)
            else:
                o = flash_attention(q, kw.contiguous(), vw.contiguous(),
                                    causal=True)
            x = x + _reduce(merge_heads(o, att["out"].to(dt)), tp)
            h = _rms_norm(x, p["RMSNorm_1"]["scale"], dt)
            x = x + _reduce(_mlp(h, p["mlp"], dt), tp)
        return _logits(params, x, cfg, tp), pool

    return extend


def make_draft_fn(cfg: TransformerConfig, tp=None):
    """``draft(params, tokens, lengths)`` → (B,) int64 greedy next token
    at each sequence's end — the speculative proposal step, batched over
    the decode batch, by full recompute (the draft keeps no cache state
    to invalidate on preemption).

    ``tokens`` (B, W) right-padded histories, ``lengths`` (B,) their
    lengths; the caller makes W the longest length, not
    ``max_seq_len``. A causal draft's forward has no length mask: a
    padded key lies after every valid query, so a valid row's logits
    are those of the masked forward (JAX's), and the attention can be
    the flash forward (the kernel on the card). A bidirectional draft
    keeps the mask."""
    mask = not cfg.causal

    @torch.no_grad()
    def draft(params, tokens, lengths):
        x, _ = _hidden(cfg, params, tokens, lengths if mask else None,
                       tp=tp)
        last = x[torch.arange(tokens.shape[0], device=x.device),
                 lengths.clamp_min(1) - 1]                  # (B, D)
        return torch.argmax(_logits(params, last, cfg, tp), dim=-1)

    return draft


def kv_quantization_probe(cfg: TransformerConfig, params, prompt,
                          kv_dtype: str = "int8", *, n_steps: int = 8,
                          num_blocks: int = 16, block_size: int = 8,
                          device="cuda") -> dict:
    """Measured logit error of a quantized KV pool against the f32
    reference: the same prompt and greedy continuation through two
    pools (f32 and ``kv_dtype``), the f32 path's tokens fed to both so
    the trajectories stay aligned; returns the worst absolute logit
    difference and how many argmaxes flipped, over the prefill and
    ``n_steps`` decode positions. ``params`` is the port's parameter
    dict."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)
    from distributed_tensorflow_tpu_torch.serving.kv_cache import (
        BlockAllocator, BlockTable, CacheConfig, init_pool)

    device = resolve_device(device)
    prompt = [int(t) for t in prompt]
    params = to_compute(canonical_params(cfg, params), cfg.dtype, device)
    state = {}
    for name, dtype in (("ref", "f32"), ("q", kv_dtype)):
        cc = CacheConfig.for_model(cfg, num_blocks=num_blocks,
                                   block_size=block_size, kv_dtype=dtype)
        table = BlockTable(cc, max_blocks=cc.usable_blocks)
        table.ensure_room(len(prompt) + n_steps + 1,
                          BlockAllocator(cc.num_blocks))
        rows = torch.from_numpy(
            table.rows(np.arange(len(prompt))).astype(np.int64)).to(device)
        pool = init_pool(cc, device)
        last, pool = make_prefill_fn(cfg, cc)(
            params, pool, torch.tensor([prompt], device=device), rows)
        table.length = len(prompt)
        state[name] = [table, pool, make_decode_fn(cfg, cc), last]
    ref, q = state["ref"][3], state["q"][3]
    max_err = (ref - q).abs().max().item()
    argmax_flips = int(ref.argmax() != q.argmax())
    token = int(ref.argmax())                 # the f32 path drives both
    for _ in range(n_steps):
        outs = {}
        for name, st in state.items():
            table, pool, decode, _ = st
            pos = table.length
            table.length += 1
            win = torch.from_numpy(
                table.window_rows()[None].astype(np.int64)).to(device)
            logits, st[1] = decode(
                params, pool, torch.tensor([token], device=device),
                torch.tensor([pos], device=device),
                torch.tensor([pos + 1], device=device),
                torch.tensor([table.row_of(pos)], device=device), win)
            outs[name] = logits[0]
        max_err = max(max_err, (outs["ref"] - outs["q"]).abs().max().item())
        argmax_flips += int(outs["ref"].argmax() != outs["q"].argmax())
        token = int(outs["ref"].argmax())
    return {"kv_dtype": kv_dtype, "max_abs_logit_err": max_err,
            "argmax_flips": argmax_flips,
            "positions_checked": n_steps + 1}

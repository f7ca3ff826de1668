#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``distributed_tensorflow_tpu_torch``) on the card, its
serving path and its train step, and checks them in phases, each
printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — builds every CUDA kernel source with ``nvcc`` into
   ``build/torch_kernels/``, one ``nvcc`` per source, all started
   together; reports each one's time, registers and spills, and fails
   if a tensor-core kernel spills.
3. ``kernels`` — each kernel's wrapper against its plain PyTorch
   version on the card, in bf16 and f32, at the main paths' shapes and
   at the edges (ragged tails, causal offsets, fully-masked rows, vocab
   tails, targets on tile edges, two row chunks), with the tolerances
   below; the flash-attention forward, dq and dk/dv backward take the
   tensor-core kernels in bf16 (also at their tiling's edges: Sq < 64,
   Sk one past a multiple of 64, a causal offset no multiple of the
   tile, both tails ragged at hd 128, rows that see no key) and the
   CUDA-core kernels in f32, also at BH = 65552 (past grid y's limit)
   and at head dims 32 and 80, which the wrappers zero-pad to 64 and
   128; the cross-entropy forward and every backward variant take the
   tensor-core kernels in bf16 (also at their tiling's edges: N and V
   one off a multiple of 128, a vocab split whose last slice is the
   ragged tail alone, targets on the slice boundaries, and d_model 12
   and 1020, which the wrappers zero-pad to a multiple of 8) and the
   CUDA-core kernels in f32; the backward variants "a" and "split"
   through the public op ``fused_cross_entropy`` and autograd, each
   against its plain versions and against variant "b", their launches
   counted over that run; the fused AdamW on ``transformer_big``'s leaf
   shapes, f32 and bf16 ``mu``, steps 1 and 1000. Then each kernel, its
   plain version and a PyTorch library yardstick (for attention
   ``scaled_dot_product_attention``, for the cross-entropy
   ``F.linear_cross_entropy``, plain and chunked) timed at the train
   step's shapes with CUDA events, in turns plain, kernel, kernel,
   plain; the flash forward also at the serve shape, and the f32
   CUDA-core attention and cross-entropy "a" and "split" kernels at the
   train step's shapes in f32; bf16 "a" also against "b", in turns.
   Last, BERT's shapes: #1, #2, #3 not causal at (32, 12, 512, 64)
   bf16 against their plain versions and SDPA, and #4, #7 at a 4096-row
   chunk of BERT's MLM loss (V 30522, D 768, 85 % of the rows unmasked
   with a zero gradient, plus an all-unmasked chunk) against their plain
   versions and the unfused ``F.cross_entropy(F.linear)``.
4. ``serve``   — ``InferenceEngine.generate`` at the full width of
   ``transformer_big`` in bf16 (random weights from seed 0), 8 requests
   × 32 new tokens. The launch counters are set to 0 just before and
   read just after: ``flash_fwd_tc`` must run exactly once per layer per
   prefill, and no other kernel.
5. ``parity``  — the serving path in f32: decode logits at every
   generated position against ``TransformerLM`` full-sequence
   recompute, and greedy tokens wherever the top-2 gap is clear.
5a. ``prefix_serve`` — prefix caching at ``transformer_big`` in bf16,
   the serve phase's pool: 8 prompts sharing one seeded 512-token
   prefix (suffixes of 16-256 tokens), the first alone (cold), then the
   other seven (hits), a prompt whose match ends 9 tokens into a block
   (copy-on-write), then the 8 again; the same prompts through an
   engine without the cache. Prefill ms cold against hit, cached
   tokens, 12 ``flash_fwd_tc`` launches a prefill (counted per prefill
   and over the run), #1 at the hit shapes (Sq = the suffix, Sk = the
   prompt, bottom-right offset = the cached tokens) against its plain
   version, the largest timed with SDPA under a lower-right causal
   mask; streams against the cold engine's: where they part, the cold
   logits' top-2 margin there must not exceed twice the hit path's
   measured logit error.
5b. ``prefix_parity`` — f32, TF32 off, full depth: every suffix logit
   of a hit against ``TransformerLM`` recompute (1e-3), streams equal to
   the cold engine's, 12 ``flash_fwd`` a prefill.
5c. ``spill`` — f32, a 24-block pool with a ``HostTier``: a long
   generation evicts the first prompt's cached blocks to host memory,
   the first prompt again re-adopts them; blocks and bytes each way,
   the re-adopted rows bit-equal to the spilled ones, streams equal to
   the run without a spill tier.
5d. ``spec_serve`` — speculative decoding in bf16, k = 4 with the
   default 6-layer truncated draft, on the serve phase's prompts,
   against the same engine without it: acceptance, tokens/s, decode ms
   per committed token, 6 ``flash_fwd_tc`` launches per draft call, and
   the streams under ``prefix_serve``'s rule.
5e. ``spec_parity`` — f32: streams equal to non-speculative decode,
   every verify row's logits against recompute of its context (1e-3).
5f. ``disagg_serve`` — ``DisaggregatedEngine`` at ``transformer_big`` in
   bf16: 1 prefill and 2 decode replicas, each with the serve pool,
   every payload through the wire format, on the serve phase's prompts
   against the monolithic engine: migrations, bytes (blocks × 786,432),
   migration ms p50/p99, tokens/s of both; 12 ``flash_fwd_tc`` launches
   a prefill, all on the prefill replica, none on the decode replicas;
   block accounting conserved; a live ``GoodputLedger`` whose fresh
   tokens equal the tokens generated, with ``kv_migrate`` above 0; the
   streams under ``prefix_serve``'s rule.
5g. ``disagg_parity`` — f32, TF32 off, full depth: the serve prompts
   through ``DisaggregatedEngine`` with streams equal to the monolithic
   engine's, again with decode pools of 94 blocks (at least one rescue
   and one replay preemption), and once with ``kv_dtype="int8"``; every
   payload survives ``pack``/``unpack`` and a ``FileKV`` publish/fetch
   bit for bit; 12 ``flash_fwd`` a prefill on whichever replica runs it.
5h. ``swap_chaos`` — f32, TF32 off: an engine with ``prefix_caching``
   serves under weights A and, after 3 steps, ``install_version`` flips
   it to weights B (seed 1): every completion on B's version,
   ``requeued`` equal to the sequences running at the flip, streams
   equal to a fresh B engine's, ``cache_dropped`` above 0 and no later
   hit on a block registered before the flip; then a seeded
   ``FaultSchedule`` raising at ``serve.step`` with probability 0.2 on
   the ``DisaggregatedEngine`` under ``run_until_idle(retry_faults=
   True)``: streams equal to the fault-free run's, no request lost,
   firings counted equal to ``faults.events()`` and above 0, accounting
   conserved.
6. ``train``   — the train step (``make_train_step``) of ``bench.py``'s
   headline row at the full width and depth of ``transformer_big`` in
   bf16: batch 8 × 1024, no remat, unrolled layers, kernel
   cross-entropy, bf16 AdamW first moment; one warm-up step, then 5
   steps timed with CUDA events on one seeded token batch. The counters
   are set to 0 before the timed steps and read after: per step 12
   ``flash_fwd_tc``, 12 ``flash_bwd_dq_tc``, 12 ``flash_bwd_dkv_tc``, 2
   ``fused_ce_fwd_tc`` and 2 ``fused_ce_bwd_tc`` launches (the
   tensor-core attention and cross-entropy kernels). The first loss must
   lie within 1.0 of ln V and the loss must fall. A smoke run, not a
   benchmark.
7. ``train_fused`` — the same with ``fused_optimizer=True``: per step
   also 98 ``fused_adamw`` launches (one per parameter tensor), and the
   plain ``AdamW.step`` is never reached.
8. ``train_parity`` — f32 with TF32 off: the kernel path (the f32
   attention and cross-entropy on the CUDA-core kernels, whose launches
   it counts)
   against the reference configuration (``mha_reference``, full-logits
   loss) from the same weights at full width, 2 layers, batch 2 × 256:
   loss, every gradient leaf, and the parameters after 3 AdamW steps.
9. ``train_options`` — the same size, one step: ``remat=True`` with the
   "nothing", "dots", "attn" and "dots_attn" policies against
   ``remat=False`` (the flash forward twice a layer under the first two,
   once under the "attn" ones, which save the registered flash op's
   outputs), and the scan-chunked loss (8 chunks, both chunk policies)
   against full logits: loss and every gradient leaf; then in bf16 the
   kernel loss (the tensor-core kernels) against full logits from the
   same weights; then ``TransformerConfig.tiny()`` (head dim 16,
   ``mha_reference`` as in JAX) trains a step and serves two requests
   on the card, with no attention kernel launched; then the headline
   step under remat "nothing", "attn" and "dots_attn": step time, peak
   memory and the forward's launches a step (24, 12, 12).
10. ``bert_train`` — ``bench.py``'s ``run_bert`` recipe through
    ``models/bert.py``'s train step: ``bert_base`` in bf16, batch
    32 x 512, no remat, unrolled layers, full-logits MLM loss, f32 AdamW
    moments, ``synthetic_corpus`` and random weights from seed 0; one
    warm-up step and 5 timed (seqs/s, MFU, peak memory). Per step 12
    non-causal ``flash_fwd_tc``, ``flash_bwd_dq_tc`` and
    ``flash_bwd_dkv_tc`` launches and no CE kernel; the first loss within
    1.0 of ln V, and falling.
11. ``bert_train_kernel`` — the same with ``loss_impl="kernel"``: also 4
    ``fused_ce_fwd_tc`` and 4 ``fused_ce_bwd_tc`` a step (one per
    4096-row chunk); its first step against ``bert_train``'s (same
    weights, corpus and masks): loss within 1e-2, gradients within the
    bf16 rule of ``train_options``.
12. ``bert_parity`` — f32, TF32 off, 2 layers at ``bert_base`` width,
    batch 2 x 512: the kernel path (f32 CUDA-core kernels) against the
    unfused reference from the same weights and masks, one step.
13. ``bert_score`` — ``InferenceEngine`` at ``bert_base`` in bf16 scoring
    8 prompts of seeded lengths 16-512 (``max_new_tokens=0``): 12
    non-causal ``flash_fwd_tc`` a prompt, prefill ms per prompt; in f32
    at 2 layers, each prompt's last-position logits against
    ``TransformerLM.forward`` within 1e-3.

14. ``dp_train`` — data-parallel training of the headline step (phase
    6's config, 8 × 1024 tokens a rank) on one rank per visible card,
    spawned through ``testing/multi_process_runner`` on NCCL: the
    bucketed step (``_make_bucketed_dp_train_step``; ``make_sharded_
    train_step`` above one card), ``grad_sync="none"``, ``zero=1`` and
    ``zero=2``, 1 warm-up and 3 timed steps each. Each rank reports step
    ms (CUDA events), tokens/s, the bucket plan, collectives issued a
    step (counted at ``torch.distributed``), every kernel's launches (12
    ``flash_fwd_tc``, ``flash_bwd_dq_tc``, ``flash_bwd_dkv_tc``, 2
    ``fused_ce_fwd_tc``, ``fused_ce_bwd_tc`` a step, no ``fused_adamw``:
    the data-parallel steps run the plain ``AdamW.step`` as JAX's run
    optax's), the persistent state (parameters and AdamW moments)
    against ``zero_state_bytes`` and the peak memory; the loss falls,
    and after each synced run the ranks' parameter checksums agree
    (all-gathered). A failed rank fails the phase.
15. ``dp_parity`` — f32, TF32 off, deterministic algorithms, 2 layers at
    ``transformer_big`` width, 2 rows × 256 tokens a rank, full-logits
    loss (the f32 cross-entropy kernel's dE atomics add in a varying
    order, which no bitwise check survives): the bucketed, ZeRO-1 and
    ZeRO-2 steps against single-device ``make_train_step`` on the
    global batch, 2 steps; ``torch.equal`` at one card; above it the
    rule beside ``DP_PARITY_TOL``.

Then a ``{"kernels": [...]}`` line (per kernel: launches on the path
that runs it and on each BERT path, error, measured times and the
bound, at the main path's shape and, where BERT runs it, at BERT's;
the flash forward's rows also the launches of phases 5a-5h and, in
bf16, its times at the largest suffix shape),
the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero without that last line, as does a machine with no CUDA
device or a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances of kernel vs plain version, same inputs, on the card
TOL = {"float32": {"o": 1e-4, "lse": 1e-4},     # f32 accumulation order
       "bfloat16": {"o": 2e-2, "lse": 1e-2}}    # bf16 output rounding
# gradients (dq, dk, dv, dh, dE): largest error over the plain version's
# largest magnitude. f32: accumulation order (and, for dE, atomics whose
# order varies by run); bf16: outputs rounded to bf16 (2^-8) and rounded
# intermediates (ds, p, p_adj) that an f32 difference in the last bits
# can send to the neighbouring bf16 value.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# CE lse and target logit, absolute: f32 sums of up to 1024 products in
# another order, on values near ln V
CE_ROW_TOL = 1e-3
# losses of fused_cross_entropy over two row chunks, relative
CE_LOSS_TOL = 1e-5
PARITY_LOGIT_TOL = 1e-3      # f32 decode logits vs full recompute
PARITY_GAP = 1e-2            # greedy tokens compared where top-2 gap > this
# prefix_serve / spec_serve (bf16): a path's logit error against an f32
# recompute (the same bf16-rounded weights, TF32 off), at the positions it
# shares with its reference path (the cold engine, plain decode) in one
# context, at most this multiple of the reference path's own error there.
# Both compute the same function in other shapes and orders, so their
# errors are alike; it caps the parting rule (a margin above twice the
# paths' difference is a fault) at (1 + this) times the reference's error.
BF16_PATH_ERR_RATIO = 2.0
# train_parity (f32, TF32 off): loss absolute; gradients as GRAD_TOL f32.
# Parameters after 3 steps: Adam moves an element by lr times a function
# of the ratios of its own gradients, so where the two runs' gradients of
# an element agree to GRAD_AGREE (relative) at every step, they move it
# alike to about 3 lr GRAD_AGREE = 9e-7. An element's noise floor is
# 1/GRAD_AGREE times the runs' disagreement on its gradient: below it lie
# gradients within f32 noise of 0 (|g| near Adam's eps, or a flipped
# sign), which Adam divides by their own size and moves by up to lr a
# step, and those that an earlier step's differences perturbed. Every
# element whose reference |g| stays above its floor is held to
# TRAIN_PARAM_TOL; of all elements at most TRAIN_PARAM_FRAC may lie
# beyond it (3.3e-5 measured on an H100).
TRAIN_LOSS_TOL = 1e-5
TRAIN_PARAM_TOL = 1e-6
TRAIN_PARAM_FRAC = 1e-4
GRAD_AGREE = 1e-3
# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores,
# HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SOURCES = ("flash_fwd", "flash_bwd", "flash_tc", "fused_ce", "fused_ce_tc",
           "fused_adamw")
SERVE_SLOTS, SERVE_BLOCK, SERVE_REQUESTS, SERVE_NEW = 8, 16, 8, 32
PARITY_REQUESTS, PARITY_NEW = 4, 16
# prefix_serve: 8 prompts sharing one seeded 512-token prefix, seeded
# suffixes of 16-256 tokens; prefix_parity (f32) a 256-token prefix
PREFIX_LEN, PREFIX_SUFFIX = 512, (16, 256)
PREFIX_PARITY_LEN, PREFIX_PARITY_SUFFIX = 256, (16, 128)
# spill: f32, a 24-block pool; a 300-token prompt, a short prompt whose
# 200-token generation evicts (spills) half of the first prompt's cached
# blocks, then the first prompt again, which re-adopts them
SPILL_BLOCKS, SPILL_PROMPT, SPILL_LONG_NEW = 25, 300, 200
# spec_serve / spec_parity: draft k tokens with the default truncated
# draft (the first half of the layers)
SPEC_K = 4
# disagg_*: one prefill and two decode replicas; disagg_parity's
# pressure run gives each replica 94 blocks, which on the serve prompts
# forces a rescue and a replay preemption
DISAGG_DECODE, DISAGG_PRESSURE_BLOCKS = 2, 94
SWAP_AFTER_STEPS, CHAOS_P = 3, 0.2
TRAIN_BATCH, TRAIN_STEPS = 8, 5
# kernels launched per train step of transformer_big at batch 8 x 1024:
# one flash forward, dq and dkv a layer; one CE forward and backward per
# 4096-row chunk of the 8192 tokens; bf16, so on the tensor-core kernels
TRAIN_LAUNCHES = {"flash_fwd_tc": 12, "flash_bwd_dq_tc": 12,
                  "flash_bwd_dkv_tc": 12, "fused_ce_fwd_tc": 2,
                  "fused_ce_bwd_tc": 2}
# with fused_optimizer=True also one AdamW launch per parameter tensor:
# 12 layers x 8 tensors, the embedding and the final norm's scale
FUSED_LAUNCHES = {**TRAIN_LAUNCHES, "fused_adamw": 98}
# train_parity's f32 kernel step, 2 layers, 512 tokens (one row chunk):
# the attention and CE kernels on the CUDA cores
PARITY_LAUNCHES = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                   "fused_ce_fwd": 1, "fused_ce_bwd": 1}
TRAIN_PARITY_STEPS = 3
# BERT (bench.py run_bert): bert_base, batch 32 x 512; per step one
# non-causal flash forward, dq and dk/dv a layer, on the tensor cores
BERT_BATCH = 32
BERT_LAUNCHES = {"flash_fwd_tc": 12, "flash_bwd_dq_tc": 12,
                 "flash_bwd_dkv_tc": 12}
# with loss_impl="kernel" also the CE kernels once per 4096-row chunk of
# fused_cross_entropy (ops/fused_ce.py ROW_CHUNK): 16384 tokens, 4 chunks
BERT_KERNEL_LAUNCHES = {**BERT_LAUNCHES, "fused_ce_fwd_tc": 4,
                        "fused_ce_bwd_tc": 4}
# bert_parity's f32 kernel step, 2 layers, 1024 tokens (one row chunk)
BERT_PARITY_LAUNCHES = {"flash_fwd": 2, "flash_bwd_dq": 2,
                        "flash_bwd_dkv": 2, "fused_ce_fwd": 1,
                        "fused_ce_bwd": 1}
BERT_SCORE_REQUESTS = 8
# remat policies timed at the headline shape in train_options
REMAT_TIMED = ("nothing", "attn", "dots_attn")
REMAT_TIMED_STEPS = 3
# train_options' bf16 step, kernel loss against full logits from the same
# weights. Loss, absolute: the full-logits path rounds every logit to bf16
# (2^-9 relative, about 2e-3 at the init's |logit| <= 1) before its f32
# logsumexp, the kernels keep them in f32; over 510 tokens of random-sign
# differences that moves the mean loss far less than 1e-2, 1e-3 of ln V.
# Gradients, each leaf's largest error over its largest magnitude: both
# paths round p_adj (the kernels) or the logits' gradient (the reference)
# to bf16 and carry that through two bf16 layers; held to the kernels'
# bf16 gradient tolerance plus twice the leaf's bf16 noise, the distance
# of the full-logits bf16 step from the f32 step of the same weights.
BF16_TRAIN_LOSS_TOL = 1e-2
BF16_TRAIN_GRAD_TOL = 2e-2
# fused AdamW against its plain version: p, nu and an f32 mu within
# ADAMW_ULP f32 units in the last place (the kernel rounds each operation
# as the plain version does); a bf16 mu the same value or its neighbour
ADAMW_ULP = 2
ADAMW_MU_BF16_ULP = 1
# dp_train: per rank, the headline batch (bench.py's scaling row, 8 a
# device); one warm-up and DP_STEPS timed steps a variant
DP_STEPS = 3
DP_VARIANTS = ("bucketed", "none", "zero1", "zero2")
# dp_parity: f32 at transformer_big width, 2 layers, 2 rows x 256 tokens a
# rank, 2 steps. One rank: bitwise. Above one rank the reductions add in
# another order: the loss and every gradient of the bucketed step within
# 1e-5 (tests/test_torch_train_step.py's tolerance), its parameters by
# train_parity's rule (the flat 1e-5 read 1.5e-4 at world 4 on elements
# whose |g| is f32 noise, which Adam moves by up to lr a step); ZeRO-1
# bitwise equal to the bucketed run of the same world, ZeRO-2 by the
# share of elements beyond TRAIN_PARAM_TOL of it
DP_PARITY_ROWS, DP_PARITY_SEQ, DP_PARITY_STEPS, DP_PARITY_TOL = 2, 256, 2, 1e-5

KERNELS = {   # name: (source, TPU kernel it replaces), in the TPU's order
    "flash_fwd_tc": ("flash_tc.cu", "ops/attention.py:135"),
    "flash_fwd": ("flash_fwd.cu", "ops/attention.py:135"),
    "flash_bwd_dq_tc": ("flash_tc.cu", "ops/attention.py:260"),
    "flash_bwd_dq": ("flash_bwd.cu", "ops/attention.py:260"),
    "flash_bwd_dkv_tc": ("flash_tc.cu", "ops/attention.py:309"),
    "flash_bwd_dkv": ("flash_bwd.cu", "ops/attention.py:309"),
    "fused_ce_fwd_tc": ("fused_ce_tc.cu", "ops/fused_ce.py:75"),
    "fused_ce_fwd": ("fused_ce.cu", "ops/fused_ce.py:75"),
    "fused_ce_dh_tc": ("fused_ce_tc.cu", "ops/fused_ce.py:137"),
    "fused_ce_dh": ("fused_ce.cu", "ops/fused_ce.py:137"),
    "fused_ce_bwd_a_tc": ("fused_ce_tc.cu", "ops/fused_ce.py:159"),
    "fused_ce_bwd_a": ("fused_ce.cu", "ops/fused_ce.py:159"),
    "fused_ce_bwd_tc": ("fused_ce_tc.cu", "ops/fused_ce.py:201"),
    "fused_ce_bwd": ("fused_ce.cu", "ops/fused_ce.py:201"),
    "fused_ce_de_tc": ("fused_ce_tc.cu", "ops/fused_ce.py:242"),
    "fused_ce_de": ("fused_ce.cu", "ops/fused_ce.py:242"),
    "fused_adamw": ("fused_adamw.cu", "ops/fused_adamw.py:53"),
}
# the path each kernel's "launches" are read on: the train step, the
# public op fused_cross_entropy with bwd_variant "a" and "split" (the
# kernels phase), the train step with fused_optimizer=True, or the f32
# train step of train_parity (the CUDA-core attention and CE kernels take
# f32)
KERNEL_PATH = {"fused_ce_dh": "ce_variants", "fused_ce_bwd_a": "ce_variants",
               "fused_ce_bwd_a_tc": "ce_variants",
               "fused_ce_de": "ce_variants", "fused_ce_dh_tc": "ce_variants",
               "fused_ce_de_tc": "ce_variants", "fused_adamw": "train_fused",
               "flash_fwd": "train_parity", "flash_bwd_dq": "train_parity",
               "flash_bwd_dkv": "train_parity",
               "fused_ce_fwd": "train_parity", "fused_ce_bwd": "train_parity"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters: int = 5) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, summed, from ``torch.profiler`` over ``iters`` calls. Unlike
    :func:`time_ms` it leaves out the gaps in which the card waits for
    the host to launch, which dominate a call of many small launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / iters


def in_turns(kernel, plain, iters: int, timer=time_ms) -> dict:
    """Kernel and plain version timed in turns plain, kernel, kernel,
    plain within this call."""
    p1 = timer(plain, iters)
    k1 = timer(kernel, iters)
    k2 = timer(kernel, iters)
    p2 = timer(plain, iters)
    return {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """Least time for the work: the larger of bytes over HBM bandwidth and
    operations over the dtype's peak rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def unmasked_pairs(sq: int, sk: int, causal: bool, causal_offset: int):
    if not causal:
        return sq * sk
    return sum(max(0, min(i + causal_offset, sk - 1) + 1)
               for i in range(sq))


def attention_work(q, k, causal: bool, causal_offset: int, which: str):
    """FLOPs and bytes one call must do on these inputs. ``fwd``: 4 hd a
    unmasked pair, q, k, v read, o, lse written. ``dq``: 6 hd (s, dp,
    dq), q, k, v, do, lse, delta read, dq written. ``dkv``: 8 hd (s, dp,
    dk, dv), the same reads, dk, dv written. ``bwd``: the backward as a
    whole, 10 hd, q, k, v, o, do, lse, delta read, dq, dk, dv written."""
    b, h, sq, hd = q.shape
    el = q.element_size()
    qb, kb, rows = q.numel() * el, k.numel() * el, b * h * sq * 4
    bwd_reads = 2 * qb + 2 * kb + 2 * rows
    mult, nbytes = {
        "fwd": (4, 2 * qb + 2 * kb + rows),
        "dq": (6, bwd_reads + qb),
        "dkv": (8, bwd_reads + 2 * kb),
        "bwd": (10, bwd_reads + qb + qb + 2 * kb),
    }[which]
    pairs = unmasked_pairs(sq, k.shape[2], causal, causal_offset)
    return mult * hd * pairs * b * h, nbytes


def ce_work(n: int, v: int, d: int, el: int, which: str):
    """FLOPs and bytes of one CE call: ``fwd`` 2 N V D, h and E read,
    targets read, lse and tl written; ``bwd`` (either merged variant)
    6 N V D (logits, dh, dE), h, E, targets, lse, g read, dh and dE
    written; ``dh`` and ``de`` 4 N V D (logits and one product), the same
    reads and their one gradient written."""
    io = (n * d + v * d) * el
    return {"fwd": (2 * n * v * d, io + n * 4 * 3),
            "bwd": (6 * n * v * d, 2 * io + n * 4 * 3),
            "dh": (4 * n * v * d, io + n * d * el + n * 4 * 3),
            "de": (4 * n * v * d, io + v * d * el + n * 4 * 3)}[which]


def rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def launch_counts() -> dict:
    from distributed_tensorflow_tpu_torch.ops import (
        attention, fused_adamw, fused_ce)
    return {"flash_fwd_tc": attention.flash_attention_fwd.launches_tc,
            "flash_fwd": attention.flash_attention_fwd.launches,
            "flash_bwd_dq_tc": attention.flash_attention_bwd.launches_dq_tc,
            "flash_bwd_dq": attention.flash_attention_bwd.launches_dq,
            "flash_bwd_dkv_tc":
                attention.flash_attention_bwd.launches_dkv_tc,
            "flash_bwd_dkv": attention.flash_attention_bwd.launches_dkv,
            "fused_ce_fwd_tc": fused_ce.fused_ce_fwd.launches_tc,
            "fused_ce_fwd": fused_ce.fused_ce_fwd.launches,
            "fused_ce_dh_tc": fused_ce.fused_ce_bwd.launches_dh_tc,
            "fused_ce_dh": fused_ce.fused_ce_bwd.launches_dh,
            "fused_ce_bwd_a_tc": fused_ce.fused_ce_bwd.launches_a_tc,
            "fused_ce_bwd_a": fused_ce.fused_ce_bwd.launches_a,
            "fused_ce_bwd_tc": fused_ce.fused_ce_bwd.launches_tc,
            "fused_ce_bwd": fused_ce.fused_ce_bwd.launches,
            "fused_ce_de_tc": fused_ce.fused_ce_bwd.launches_de_tc,
            "fused_ce_de": fused_ce.fused_ce_bwd.launches_de,
            "fused_adamw": fused_adamw.fused_adamw_update.launches}


def zero_launch_counts():
    from distributed_tensorflow_tpu_torch.ops import (
        attention, fused_adamw, fused_ce)
    attention.flash_attention_fwd.launches = 0
    attention.flash_attention_fwd.launches_tc = 0
    for name in ("launches_dq", "launches_dq_tc", "launches_dkv",
                 "launches_dkv_tc"):
        setattr(attention.flash_attention_bwd, name, 0)
    fused_ce.fused_ce_fwd.launches = 0
    fused_ce.fused_ce_fwd.launches_tc = 0
    for name in ("launches", "launches_tc", "launches_a", "launches_a_tc",
                 "launches_dh", "launches_de", "launches_dh_tc",
                 "launches_de_tc"):
        setattr(fused_ce.fused_ce_bwd, name, 0)
    fused_adamw.fused_adamw_update.launches = 0


def expected_counts(per_step: dict, steps: int) -> dict:
    """Every kernel's count after ``steps`` steps that each launch
    ``per_step`` (the kernels not named there: 0)."""
    return {k: per_step.get(k, 0) * steps for k in KERNELS}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(state):
    import torch
    smi = nvidia_smi()
    state["smi"] = smi
    state["kind"] = torch.cuda.get_device_name(0)
    return {"nvidia_smi": smi, "torch_device": state["kind"],
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def phase_build(state):
    from concurrent.futures import ThreadPoolExecutor
    from distributed_tensorflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    wall = time.perf_counter() - t0
    out = {"wall_s": round(wall, 3), "sources": {}}
    for name in SOURCES:
        info = _build.build_info[name]
        out["sources"][name] = {"nvcc_s": round(info["seconds"], 3),
                                "kernels": ptxas_report(info["log"])}
    # the tensor-core kernels keep their tiles in registers: none may spill
    spills = {f"{src}:{k}": r.get("spill_store_bytes")
              for src in ("flash_tc", "fused_ce_tc")
              for k, r in out["sources"][src]["kernels"].items()
              if r.get("spill_store_bytes")}
    if spills:
        raise AssertionError(f"tensor-core kernels spill registers: {spills}")
    return out


def ptxas_report(log: str) -> dict:
    """Registers and spill-store bytes of each kernel in an ``nvcc -Xptxas
    -v`` log, keyed by the kernel's name and its mangled template
    arguments (``flash_fwd_tc_kernelILi64EE``: ``HD = 64``)."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            k = re.search(r"\d([a-z_]+_kernel)(I\w*?EE)?", entry.group(1))
            name = k.group(1) + (k.group(2) or "") if k else entry.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[name]["spill_store_bytes"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def _rand(shape, dtype, gen, scale=1.0):
    import torch
    return (scale * torch.randn(shape, device="cuda", generator=gen)
            ).to(dtype)


def _fwd_errors(q, k, v, o, lse, causal: bool) -> dict:
    """``flash_fwd``'s ``(o, lse)`` against ``flash_attention_plain`` on
    the same inputs: errors, fully-masked rows (``lse = +inf`` and
    ``o = 0`` where the plain version has them) and the verdict."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_plain)
    po, plse = flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5)
    inf_k, inf_p = torch.isinf(lse), torch.isinf(plse)
    fin = ~inf_p
    o_err = abs_err(o, po)
    lse_err = abs_err(lse[fin], plse[fin]) if fin.any() else 0.0
    empty_zero = bool((o[inf_p] == 0).all().item()) if inf_p.any() \
        else True
    tol = TOL[str(q.dtype).replace("torch.", "")]
    ok = (o_err <= tol["o"] and lse_err <= tol["lse"]
          and torch.equal(inf_k, inf_p) and empty_zero
          and bool(torch.isfinite(o).all().item()))
    return {"o_err": o_err, "lse_err": lse_err,
            "masked_rows": int(inf_p.sum().item()), "tol": tol, "ok": ok}


def _flash_row(t: dict, flops: float, nbytes: float, dtype, err: float,
               lib_ms: float, shape) -> dict:
    """A kernel line's numbers for an attention kernel timed in turns."""
    bound, bound_by = bound_ms(flops, nbytes, dtype)
    return {"max_abs_err": err, "ms": t["ms"], "ms_runs": t["ms_runs"],
            "plain_ms": t["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms, "flops": flops,
            "bytes": nbytes,
            "achieved_tflops": flops / (t["ms"] * 1e-3) / 1e12,
            "bound_share": bound / t["ms"], "shape": list(shape),
            "dtype": str(dtype).replace("torch.", "")}


def _time_flash_fwd(q, k, v, o_err: float) -> dict:
    """The flash forward (the kernel ``attention_route`` names) causal on
    ``q, k, v`` against its plain version (in turns) and SDPA, with the
    bound of the work; also the kernel's and SDPA's device time by
    :func:`device_ms`, which leaves out the host's time between launches
    (at the serve shape the wrapper's host time a call can exceed the
    kernel's, and CUDA events then time the host)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_plain)
    sm = q.shape[-1] ** -0.5

    def kernel():
        flash_attention_fwd(q, k, v, causal=True)

    def library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=sm)

    t = in_turns(kernel, lambda: flash_attention_plain(
        q, k, v, causal=True, sm_scale=sm), 20)
    lib = time_ms(library)
    flops, nbytes = attention_work(q, k, True, 0, "fwd")
    return {**_flash_row(t, flops, nbytes, q.dtype, o_err, lib, q.shape),
            "plain_ms_runs": t["plain_ms_runs"],
            "device_ms": device_ms(kernel, 20),
            "library_device_ms": device_ms(library, 20),
            "library": "scaled_dot_product_attention"}


def _route_name(dtype, hd: int, op: str) -> str:
    """The counter of the kernel ``attention_route`` sends ``op`` to."""
    from distributed_tensorflow_tpu_torch.ops.attention import (
        attention_route)
    base = {"fwd": "flash_fwd", "dq": "flash_bwd_dq",
            "dkv": "flash_bwd_dkv"}[op]
    return base + ("_tc" if attention_route(dtype, hd, op) == "tc" else "")


def _check_flash_fwd(state, gen):
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd)

    bf, f32 = torch.bfloat16, torch.float32
    # (name, dtype, B, H, Sq, Sk, hd, causal)
    cases = [(f"bf16_causal_S{s}", bf, 1, 16, s, s, 64, True)
             for s in (1, 17, 512, 1000, 1024)]
    cases += [("bf16_causal_train_step_8x16x1024", bf, 8, 16, 1024, 1024,
               64, True),
              ("bf16_noncausal_S384", bf, 1, 16, 384, 384, 64, False),
              ("bf16_causal_q64_k1024", bf, 1, 16, 64, 1024, 64, True),
              ("bf16_causal_q100_k40_masked_rows", bf, 1, 16, 100, 40, 64,
               True),
              ("bf16_causal_hd128_q200_k130", bf, 1, 4, 200, 130, 128,
               True),
              # the tensor-core kernel's 64-row tiles: Sk one past a
              # multiple of 64, Sq below one tile, a causal offset (24) no
              # multiple of the tile, both tails ragged at hd 128
              ("bf16_causal_q100_k129", bf, 1, 16, 100, 129, 64, True),
              ("bf16_causal_q40_k300", bf, 1, 16, 40, 300, 64, True),
              ("bf16_causal_q1000_k1024", bf, 1, 16, 1000, 1024, 64, True),
              ("bf16_noncausal_hd128_q130_k200", bf, 1, 4, 130, 200, 128,
               False),
              # head dims zero-padded for the kernels: 32 to 64, 80 to 128
              ("bf16_causal_hd32_S200", bf, 1, 4, 200, 200, 32, True),
              ("bf16_noncausal_hd80_q130_k90", bf, 1, 4, 130, 90, 80,
               False),
              ("f32_causal_hd32_S200", f32, 1, 4, 200, 200, 32, True),
              ("f32_noncausal_hd80_q130_k90", f32, 1, 4, 130, 90, 80,
               False),
              ("f32_causal_S300", f32, 1, 16, 300, 300, 64, True),
              ("f32_noncausal_hd128_q200_k130", f32, 1, 4, 200, 130, 128,
               False),
              ("f32_causal_train_step_8x16x1024", f32, 8, 16, 1024, 1024,
               64, True)]
    results, failures, timed = [], [], {}
    for name, dt, b, h, sq, sk, hd, causal in cases:
        q = _rand((b, h, sq, hd), dt, gen)
        k = _rand((b, h, sk, hd), dt, gen)
        v = _rand((b, h, sk, hd), dt, gen)
        before = launch_counts()
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        after = launch_counts()
        calls = {c: after[c] - before[c] for c in after
                 if after[c] != before[c]}
        res = {"case": name, **_fwd_errors(q, k, v, o, lse, causal),
               "launches": calls}
        res["ok"] = res["ok"] and calls == {_route_name(dt, hd, "fwd"): 1}
        results.append(res)
        if not res["ok"]:
            failures.append(name)
        if name in ("bf16_causal_S1024", "bf16_causal_train_step_8x16x1024",
                    "f32_causal_train_step_8x16x1024"):
            timed[name] = (q, k, v, res["o_err"])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{failures}: {results}")

    # bf16 (tensor cores) at the train step's shape (12 launches a step)
    # and the longest prefill of the serve path (12 a prefill); f32 (CUDA
    # cores, the train_parity path) at the train step's shape
    train = _time_flash_fwd(*timed["bf16_causal_train_step_8x16x1024"])
    serve = _time_flash_fwd(*timed["bf16_causal_S1024"])
    f32_train = _time_flash_fwd(*timed["f32_causal_train_step_8x16x1024"])
    state["flash_fwd_tc"] = {**train, "serve": serve}
    state["flash_fwd"] = f32_train
    return {"cases": results, "causal": True, "train_shape": train,
            "serve_shape": serve, "f32_train_shape": f32_train}


def _check_flash_bwd(state, gen):
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        launch_bwd_dkv, launch_bwd_dq)

    bf, f32 = torch.bfloat16, torch.float32
    # (name, B, H, Sq, Sk, hd, causal); each in bf16 and f32
    cases = [("causal_S200", 1, 4, 200, 200, 64, True),
             ("causal_q100_k300", 1, 4, 100, 300, 64, True),
             ("causal_q100_k40_masked_rows", 1, 4, 100, 40, 64, True),
             ("causal_hd128_S130", 1, 4, 130, 130, 128, True),
             ("noncausal_q150_k90", 1, 4, 150, 90, 64, False),
             ("noncausal_hd128_q70_k200", 1, 2, 70, 200, 128, False),
             # head dims zero-padded for the kernels: 32 to 64, 80 to 128
             ("causal_hd32_S200", 1, 4, 200, 200, 32, True),
             ("noncausal_hd80_q150_k90", 1, 4, 150, 90, 80, False)]
    runs = [(f"{tag}_{name}", dt, *shape)
            for tag, dt in (("bf16", bf), ("f32", f32))
            for name, *shape in cases]
    # the dk/dv tensor-core kernel's 64-row tiles: Sk one past a multiple
    # of 64, Sq below one tile, a causal offset (24) no multiple of the
    # tile, both tails ragged at hd 128
    runs += [("bf16_causal_q100_k129", bf, 1, 4, 100, 129, 64, True),
             ("bf16_causal_q40_k40", bf, 1, 4, 40, 40, 64, True),
             ("bf16_causal_q1000_k1024", bf, 1, 4, 1000, 1024, 64, True),
             ("bf16_noncausal_hd128_q130_k200", bf, 1, 2, 130, 200, 128,
              False)]
    # the train step's shape, which the timings below use: bf16 (the train
    # step's route) and f32 (the CUDA-core dk/dv of train_parity)
    runs += [(f"{tag}_train_step_8x16x1024_hd64", dt, 8, 16, 1024, 1024,
              64, True) for tag, dt in (("bf16", bf), ("f32", f32))]
    # BH = 4097 x 16 = 65552 heads, past grid y's limit of 65535: every
    # kernel puts BH on grid x. Not causal: under the causal mask rows 1-3
    # of a head average 2-4 rows of v, so |o| reaches 4-5 on some of its
    # 67 M outputs, where one bf16 step of o (2^-6 up to 8) exceeds
    # TOL["bfloat16"]["o"]; over all 16 keys |o| stays below 4, as in the
    # other cases
    runs += [(f"{tag}_noncausal_BH65552_S16", dt, 4097, 16, 16, 16, 64,
              False) for tag, dt in (("bf16", bf), ("f32", f32))]
    results, failures, main = [], [], {}
    for name, dt, b, h, sq, sk, hd, causal in runs:
        q, k, v, do = (_rand((b, h, s, hd), dt, gen)
                       for s in (sq, sk, sk, sq))
        before = launch_counts()
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        after = launch_counts()
        calls = {c: after[c] - before[c] for c in after
                 if after[c] != before[c]}
        # the forward these gradients start from, against its plain version
        fwd = _fwd_errors(q, k, v, o, lse, causal)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=hd ** -0.5)
        errs = {f"d{n}": rel_err(g, w) for n, g, w in zip("qkv", got, want)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        masked = torch.isposinf(lse)
        ok = (fwd["ok"] and max(errs.values()) <= tol
              and all(bool(torch.isfinite(g).all().item()) for g in got)
              and bool((got[0][masked] == 0).all().item())
              and calls == {_route_name(dt, hd, op): 1
                            for op in ("fwd", "dq", "dkv")})
        results.append({"case": name, "rel_err": errs, "tol": tol,
                        "fwd_o_err": fwd["o_err"],
                        "fwd_lse_err": fwd["lse_err"],
                        "masked_rows": int(masked.sum().item()),
                        "launches": calls, "ok": ok})
        if not ok:
            failures.append(name)
        if "_train_step" in name:
            main[dt] = (q, k, v, o, lse, do,
                        abs_err(got[0], want[0]),
                        max(abs_err(got[1], want[1]),
                            abs_err(got[2], want[2])))
    if failures:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{failures}: {results}")

    out = {"cases": results, "causal": True,
           "library": "scaled_dot_product_attention backward (dq, dk, dv)",
           "plain_note": "the plain backward computes dq, dk and dv"}
    # bf16: dq and dk/dv (tensor cores), the train step's kernels; f32: dq
    # and dk/dv (CUDA cores), train_parity's
    for dt in (bf, f32):
        q, k, v, o, lse, do, dq_err, dkv_err = main.pop(dt)
        sm = q.shape[-1] ** -0.5
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(sm_scale=sm, causal=True, causal_offset=0)

        def plain():
            flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                      sm_scale=sm)

        # library yardstick: scaled_dot_product_attention's backward alone,
        # through autograd; it computes dq, dk and dv together
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, scale=sm)

        def library():
            torch.autograd.grad(sdpa, leaves, do, retain_graph=True)

        # by CUDA events, and its device time: the profiler's kernel
        # durations, which leave out the host's gaps (the event time of
        # this call has moved between calls)
        lib, lib_dev = time_ms(library), device_ms(library, 10)
        del sdpa, leaves
        tag = str(dt).replace("torch.", "")
        out[f"library_ms_{tag}"] = lib
        out[f"library_device_ms_{tag}"] = lib_dev
        for op in ("dq", "dkv"):
            fn = launch_bwd_dq if op == "dq" else launch_bwd_dkv

            def kernel():
                fn(q, k, v, do, lse, delta, **kw)

            t = in_turns(kernel, plain, 10)
            flops, nbytes = attention_work(q, k, True, 0, op)
            kname = _route_name(dt, q.shape[-1], op)
            state[kname] = {**_flash_row(t, flops, nbytes, dt,
                                         dq_err if op == "dq" else dkv_err,
                                         lib, q.shape),
                            "device_ms": device_ms(kernel, 10),
                            "library_device_ms": lib_dev}
            out[kname] = {**state[kname],
                          "plain_ms_runs": t["plain_ms_runs"]}
        flops, nbytes = attention_work(q, k, True, 0, "bwd")
        out[f"backward_bound_ms_{tag}"] = bound_ms(flops, nbytes, dt)
    torch.cuda.empty_cache()
    return out


def _ce_targets(n, v, gen):
    """Seeded targets in ``[0, V)`` whose first rows sit on the edges of the
    backward's 64-row vocab tiles, the forward's 128-row vocab tiles, the
    ragged tail, and both sides of every boundary of the forward's vocab
    slices (:func:`fwd_vocab_split` on this card)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        TC_FWD_TILE, fwd_vocab_split)
    per, slices = fwd_vocab_split(n, v, torch.cuda.get_device_properties(
        0).multi_processor_count)
    cols = {0, 63, 64, 127, 128, v - 40, v - 41, v - 1}
    for sl in range(1, slices):
        cols |= {sl * per * TC_FWD_TILE - 1, sl * per * TC_FWD_TILE}
    edges = sorted(c for c in cols if 0 <= c < v)[:n]
    t = torch.randint(0, v, (n,), device="cuda", generator=gen)
    t[:len(edges)] = torch.tensor(edges, device="cuda")
    return t, (per, slices)


def _ce_library(h, e, t, g):
    """``F.linear_cross_entropy(h, e, t, reduction="none")`` timed with
    CUDA events, forward and its backward alone (the gradients of ``h``
    and ``e`` against ``g``), with ``options=None`` (the reference path)
    and, where ``torch.nn.LinearCrossEntropyOptions`` exists, with its
    chunked path; and the unfused ``F.cross_entropy(F.linear(h, e))``
    pair. None where this torch lacks the call."""
    import warnings

    import torch
    import torch.nn.functional as F
    hl, el = (x.detach().clone().requires_grad_() for x in (h, e))
    out = {}

    def timed(tag, fwd):
        loss = fwd()
        out[f"{tag}_fwd_ms"] = time_ms(fwd, 5)
        out[f"{tag}_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            loss, (hl, el), g.to(loss.dtype), retain_graph=True), 5)

    timed("unfused", lambda: F.cross_entropy(F.linear(hl, el), t,
                                             reduction="none"))
    lce = getattr(F, "linear_cross_entropy", None)
    options = getattr(torch.nn, "LinearCrossEntropyOptions", None)
    out["linear_cross_entropy"] = lce is not None
    out["linear_cross_entropy_options"] = options is not None
    if lce is not None:
        timed("lce", lambda: lce(hl, el, t, reduction="none"))
    if lce is not None and options is not None:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            timed("lce_chunked", lambda: lce(hl, el, t, reduction="none",
                                             options=options()))
        out["lce_chunked_warnings"] = [str(w.message)[:200] for w in caught]
    for which in ("fwd", "bwd"):
        got = [out[k] for k in (f"lce_{which}_ms", f"lce_chunked_{which}_ms")
               if k in out]
        out[f"library_{which}_ms"] = min(got) if got else None
    return out


def _ce_row(n, v, d, dtype, which, tm, err, lib, **extra):
    """A kernel line's numbers for one CE kernel timed at (N, V, D)."""
    el = 2 if str(dtype).endswith("bfloat16") else 4
    flops, nbytes = ce_work(n, v, d, el, which)
    bound, bound_by = bound_ms(flops, nbytes, dtype)
    return {"max_abs_err": err, "ms": tm["ms"], "ms_runs": tm["ms_runs"],
            "plain_ms": tm["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib[f"library_{which}_ms"],
            "library": "F.linear_cross_entropy(h, E, t, reduction='none')"
                       + ("" if which == "fwd" else ", backward alone")
                       + ", the faster of options=None and the chunked path",
            "unfused_ms": lib[f"unfused_{which}_ms"], "flops": flops,
            "bytes": nbytes,
            "achieved_tflops": flops / (tm["ms"] * 1e-3) / 1e12,
            "bound_share": bound / tm["ms"], "shape": [n, v, d],
            "dtype": str(dtype).replace("torch.", ""), **extra}


def _check_fused_ce(state, gen):
    import torch
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        ce_reference, fused_ce_bwd, fused_ce_bwd_plain, fused_ce_fwd,
        fused_ce_fwd_plain, fused_cross_entropy)

    # (name, N, V, D): a ragged vocab tail (V = 1000, 15 tiles + 40), N
    # no multiple of the 32-row tile, the widest D; targets on tile edges
    cases = [("N300_V1000_D256", 300, 1000, 256),
             ("N100_V1000_D1024", 100, 1000, 1024),
             ("N4133_V1000_D64", 4133, 1000, 64)]
    runs = [(f"{tag}_{name}", dt, *shape)
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for name, *shape in cases]
    # the tensor-core kernels' tiling edges (128-row forward tiles and
    # vocab slices, 32 x 64 backward tiles, 128-wide d chunks): N and V
    # one below and one above a multiple of 128; a split whose last slice
    # holds only the ragged tail (V = 1025 in 9 slices of one tile: the
    # last holds column 1024 alone); a D no multiple of the d chunk
    runs += [("bf16_N127_V1023_D128", torch.bfloat16, 127, 1023, 128),
             ("bf16_N129_V1025_D64", torch.bfloat16, 129, 1025, 64),
             ("bf16_N255_V2049_D1000", torch.bfloat16, 255, 2049, 1000),
             ("bf16_N4095_V32767_D1024", torch.bfloat16, 4095, 32767, 1024),
             ("bf16_N4097_V32769_D1024", torch.bfloat16, 4097, 32769, 1024)]
    # a d_model no multiple of 8, which bf16 zero-pads for the tensor
    # cores, with V no multiple of 32 (the variant "a" kernel's vocab
    # rows a block) and of 128
    runs += [("bf16_N300_V1001_D12", torch.bfloat16, 300, 1001, 12),
             ("bf16_N129_V1025_D1020", torch.bfloat16, 129, 1025, 1020)]
    runs.append(("bf16_train_chunk_N4096_V32768_D1024", torch.bfloat16,
                 4096, 32768, 1024))
    results, failures, main = [], [], None
    for name, dt, n, v, d in runs:
        h = _rand((n, d), dt, gen)
        e = _rand((v, d), dt, gen, 0.1)
        t, split = _ce_targets(n, v, gen)
        g = torch.rand(n, device="cuda", generator=gen) / n
        before = launch_counts()
        lse, tl = fused_ce_fwd(h, e, t)
        dh, de = fused_ce_bwd(h, e, t, lse, g)
        torch.cuda.synchronize()
        after = launch_counts()
        plse, ptl = fused_ce_fwd_plain(h, e, t)
        pdh, pde = fused_ce_bwd_plain(h, e, t, plse, g)
        errs = {"lse": abs_err(lse, plse), "tl": abs_err(tl, ptl),
                "dh_rel": rel_err(dh, pdh), "de_rel": rel_err(de, pde)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        route = "_tc" if dt == torch.bfloat16 else ""
        calls = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        ok = (errs["lse"] <= CE_ROW_TOL and errs["tl"] <= CE_ROW_TOL
              and errs["dh_rel"] <= tol and errs["de_rel"] <= tol
              and calls == {f"fused_ce_fwd{route}": 1,
                            f"fused_ce_bwd{route}": 1}
              and all(bool(torch.isfinite(x).all().item())
                      for x in (lse, tl, dh, de)))
        results.append({"case": name, "err": errs, "launches": calls,
                        "vocab_split": split,
                        "tol": {"lse": CE_ROW_TOL, "grad_rel": tol},
                        "ok": ok})
        if not ok:
            failures.append(name)
        if name.startswith("bf16_train_chunk"):
            main = (h, e, t, g, max(errs["lse"], errs["tl"]),
                    max(abs_err(dh, pdh), abs_err(de, pde)))
        del h, e, dh, de, pdh, pde

    # two 4096-row chunks through the differentiable op, against autograd
    # through ce_reference in f32: one forward and one backward launch a
    # chunk
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        n, v, d = 8192, 1000, 128
        h = _rand((n, d), dt, gen).requires_grad_()
        e = _rand((v, d), dt, gen, 0.1).requires_grad_()
        t = torch.randint(0, v, (n,), device="cuda", generator=gen)
        w = torch.rand(n, device="cuda", generator=gen)
        before = launch_counts()
        loss = (fused_cross_entropy(h, e, t) * w).sum()
        gh, ge = torch.autograd.grad(loss, (h, e))
        torch.cuda.synchronize()
        after = launch_counts()
        h32, e32 = (x.detach().float().requires_grad_() for x in (h, e))
        ref = (ce_reference(h32, e32, t) * w).sum()
        rh, re_ = torch.autograd.grad(ref, (h32, e32))
        route = "_tc" if dt == torch.bfloat16 else ""
        calls = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        errs = {"loss_rel": abs(loss.item() - ref.item()) / abs(ref.item()),
                "dh_rel": rel_err(gh, rh), "de_rel": rel_err(ge, re_)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        ok = (errs["loss_rel"] <= CE_LOSS_TOL and errs["dh_rel"] <= tol
              and errs["de_rel"] <= tol
              and calls == {f"fused_ce_fwd{route}": 2,
                            f"fused_ce_bwd{route}": 2})
        results.append({"case": f"{tag}_two_chunks_N8192_V1000_D128",
                        "err": errs, "launches": calls,
                        "tol": {"loss_rel": CE_LOSS_TOL, "grad_rel": tol},
                        "ok": ok})
        if not ok:
            failures.append(f"{tag}_two_chunks")
    if failures:
        raise AssertionError(f"fused_ce disagrees with its plain version: "
                             f"{failures}: {results}")

    # timing at the train step's chunk: bf16 on the tensor cores; f32 on
    # the CUDA cores (the route f32 takes), TF32 off for its library calls
    torch.backends.cuda.matmul.allow_tf32 = False
    h, e, t, g, fwd_err, bwd_err = main
    n, d = h.shape
    v = e.shape[0]
    lse, _ = fused_ce_fwd(h, e, t)
    t_fwd = in_turns(lambda: fused_ce_fwd(h, e, t),
                     lambda: fused_ce_fwd_plain(h, e, t), 5)
    t_bwd = in_turns(lambda: fused_ce_bwd(h, e, t, lse, g),
                     lambda: fused_ce_bwd_plain(h, e, t, lse, g), 3)
    lib = _ce_library(h, e, t, g)
    state["ce_library_bf16"] = lib
    state["fused_ce_fwd_tc"] = _ce_row(n, v, d, h.dtype, "fwd", t_fwd,
                                       fwd_err, lib)
    # the two-pass design's own work: 8 N V D (logits twice)
    design = bound_ms(8 * n * v * d, 0, h.dtype)[0]
    state["fused_ce_bwd_tc"] = _ce_row(n, v, d, h.dtype, "bwd", t_bwd,
                                       bwd_err, lib, design_bound_ms=design)
    del h, e, lse, main
    torch.cuda.empty_cache()

    h32 = _rand((n, d), torch.float32, gen)
    e32 = _rand((v, d), torch.float32, gen, 0.1)
    lse, tl = fused_ce_fwd(h32, e32, t)
    dh, de = fused_ce_bwd(h32, e32, t, lse, g)
    plse, ptl = fused_ce_fwd_plain(h32, e32, t)
    pdh, pde = fused_ce_bwd_plain(h32, e32, t, plse, g)
    f32_err = {"fwd": max(abs_err(lse, plse), abs_err(tl, ptl)),
               "bwd": max(abs_err(dh, pdh), abs_err(de, pde)),
               "dh_rel": rel_err(dh, pdh), "de_rel": rel_err(de, pde)}
    del dh, de, pdh, pde
    if (f32_err["fwd"] > CE_ROW_TOL or f32_err["dh_rel"] > GRAD_TOL["float32"]
            or f32_err["de_rel"] > GRAD_TOL["float32"]):
        raise AssertionError(f"fused_ce f32 at the train chunk: {f32_err}")
    t32_fwd = in_turns(lambda: fused_ce_fwd(h32, e32, t),
                       lambda: fused_ce_fwd_plain(h32, e32, t), 3)
    t32_bwd = in_turns(lambda: fused_ce_bwd(h32, e32, t, lse, g),
                       lambda: fused_ce_bwd_plain(h32, e32, t, lse, g), 2)
    lib32 = _ce_library(h32, e32, t, g)
    state["ce_library_f32"] = lib32
    state["fused_ce_fwd"] = _ce_row(n, v, d, h32.dtype, "fwd", t32_fwd,
                                    f32_err["fwd"], lib32)
    state["fused_ce_bwd"] = _ce_row(n, v, d, h32.dtype, "bwd", t32_bwd,
                                    f32_err["bwd"], lib32)
    del h32, e32
    torch.cuda.empty_cache()
    return {"cases": results, "shape": [n, v, d],
            **{k: state[k] for k in ("fused_ce_fwd_tc", "fused_ce_bwd_tc",
                                     "fused_ce_fwd", "fused_ce_bwd")},
            "library_bf16": lib, "library_f32": lib32}


# (name, N, V, D): a ragged vocab tail (V = 1000, 15 tiles + 40), N no
# multiple of the 32-row tile, the widest D, the train step's chunk, and
# two 4096-row chunks of the public op; d_model no multiple of 8 (bf16
# zero-pads it for the tensor cores) with a V no multiple of the 32
# vocab rows of a block of "a"'s kernel
CE_VARIANT_CASES = [("N300_V1000_D256", 300, 1000, 256),
                    ("N100_V1000_D1024", 100, 1000, 1024),
                    ("N4133_V1000_D64", 4133, 1000, 64),
                    ("train_chunk_N4096_V32768_D1024", 4096, 32768, 1024),
                    ("two_chunks_N8192_V1000_D128", 8192, 1000, 128),
                    ("padded_N300_V1001_D12", 300, 1001, 12),
                    ("padded_N129_V1025_D1020", 129, 1025, 1020)]


def _ce_variant_grads(h, e, t, w, variant):
    """``(dh, dE)`` of ``sum(fused_cross_entropy(h, e, t) * w)`` through
    the public op with ``bwd_variant=variant`` and autograd."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        fused_cross_entropy)
    hl, el = (x.detach().requires_grad_() for x in (h, e))
    loss = (fused_cross_entropy(hl, el, t, bwd_variant=variant) * w).sum()
    return torch.autograd.grad(loss, (hl, el))


def _check_ce_variants(state, gen):
    """The backward variants "a" (#6) and "split" (#5, #8) through the
    public op, each against its plain versions and against variant "b"
    (#7) on the same inputs, in bf16 and f32; the variant kernels'
    launches are counted over this run (bf16 "a" and "split" on the
    tensor cores, f32 on the CUDA cores). Then #5, #6 and #8 timed at the
    train step's chunk against their plain versions, in turns: bf16 "a",
    each bf16 "split" pass, and the f32 "a" and "split" kernels in f32;
    and bf16 "a" against "b", in turns."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_ce as ce

    runs = [(f"{tag}_{name}", dt, *shape)
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for name, *shape in CE_VARIANT_CASES
            if not (tag == "f32" and shape[1] == 32768)]
    results, failures, main = [], [], None
    chunks = {torch.bfloat16: 0, torch.float32: 0}
    torch.cuda.synchronize()
    zero_launch_counts()
    for name, dt, n, v, d in runs:
        h = _rand((n, d), dt, gen)
        e = _rand((v, d), dt, gen, 0.1)
        t = torch.randint(0, v, (n,), device="cuda", generator=gen)
        edges = torch.tensor([0, 63, 64, 127, 128, v - 40, v - 41, v - 1],
                             device="cuda")
        t[:len(edges)] = edges
        w = torch.rand(n, device="cuda", generator=gen) / n
        got = {var: _ce_variant_grads(h, e, t, w, var)
               for var in ce.BWD_VARIANTS}
        torch.cuda.synchronize()
        chunks[dt] += n // ce.ROW_CHUNK if n > ce.ROW_CHUNK \
            and n % ce.ROW_CHUNK == 0 else 1
        plse, _ = ce.fused_ce_fwd_plain(h, e, t)
        pdh, pde = ce.fused_ce_bwd_plain(h, e, t, plse, w)
        want = {"a": (pdh, pde),
                "split": (ce.fused_ce_dh_plain(h, e, t, plse, w),
                          ce.fused_ce_de_plain(h, e, t, plse, w))}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        errs = {}
        for var, (wdh, wde) in want.items():
            gdh, gde = got[var]
            errs[var] = {"dh_rel": rel_err(gdh, wdh), "de_rel": rel_err(gde, wde),
                         "dh_rel_vs_b": rel_err(gdh, got["b"][0]),
                         "de_rel_vs_b": rel_err(gde, got["b"][1])}
        ok = (all(x <= tol for er in errs.values() for x in er.values())
              and all(bool(torch.isfinite(x).all().item())
                      for pair in got.values() for x in pair))
        results.append({"case": name, "err": errs, "tol": tol, "ok": ok})
        if not ok:
            failures.append(name)
        if "train_chunk" in name:
            main = (h, e, t, w, {
                "fused_ce_bwd_a_tc": max(abs_err(got["a"][0], pdh),
                                         abs_err(got["a"][1], pde)),
                "fused_ce_dh_tc": abs_err(got["split"][0], want["split"][0]),
                "fused_ce_de_tc": abs_err(got["split"][1],
                                          want["split"][1])})
        del got, want, pdh, pde
    counts = launch_counts()
    state["ce_variants_launches"] = counts
    # one launch of each variant kernel per row chunk; "b" ran beside them,
    # on the tensor cores in bf16, and so did every forward and "split"
    bf, f32 = chunks[torch.bfloat16], chunks[torch.float32]
    expected = {"fused_ce_fwd_tc": 3 * bf, "fused_ce_fwd": 3 * f32,
                "fused_ce_bwd_tc": bf, "fused_ce_bwd": f32,
                "fused_ce_bwd_a_tc": bf, "fused_ce_bwd_a": f32,
                "fused_ce_dh_tc": bf,
                "fused_ce_de_tc": bf, "fused_ce_dh": f32, "fused_ce_de": f32}
    if failures or counts != expected_counts(expected, 1):
        raise AssertionError(f"fused_ce variants: failures {failures}, "
                             f"launches {counts} (expected {expected}): "
                             f"{results}")

    h, e, t, g, errs = main
    del main
    n, d = h.shape
    v = e.shape[0]
    rows = {}   # kernel: (dtype, its timing in turns, ce_work's name)
    for dt in (torch.bfloat16, torch.float32):
        if dt == torch.float32:   # the f32 "split" kernels at the chunk
            h, e = h.float(), e.float()
        tc = dt == torch.bfloat16
        lse, _ = ce.fused_ce_fwd(h, e, t)
        t32 = t.to(torch.int32)
        ptrs = (h.data_ptr(), e.data_ptr(), t32.data_ptr(), lse.data_ptr(),
                g.data_ptr())
        source, dims = (("fused_ce_tc", (n, v, d)) if tc else
                        ("fused_ce", (n, v, d, ce.KERNEL_DTYPES[dt])))

        def kernel_a():
            return ce.fused_ce_bwd(h, e, t, lse, g, variant="a")

        if tc:
            rows["fused_ce_bwd_a_tc"] = (dt, in_turns(
                kernel_a, lambda: ce.fused_ce_bwd_plain(h, e, t, lse, g), 3),
                "bwd")
            a_b = in_turns(kernel_a, lambda: ce.fused_ce_bwd(h, e, t, lse, g),
                           3)
            a_against_b = {"a_ms": a_b["ms"], "a_ms_runs": a_b["ms_runs"],
                           "b_ms": a_b["plain_ms"],
                           "b_ms_runs": a_b["plain_ms_runs"]}
        else:   # f32 "a" (CUDA cores) at the chunk against its plain version
            gdh, gde = kernel_a()
            wdh, wde = ce.fused_ce_bwd_plain(h, e, t, lse, g)
            errs["fused_ce_bwd_a"] = max(abs_err(gdh, wdh), abs_err(gde, wde))
            rel = max(rel_err(gdh, wdh), rel_err(gde, wde))
            del gdh, gde, wdh, wde
            if rel > GRAD_TOL["float32"]:
                raise AssertionError(f"fused_ce_bwd_a f32 at the train "
                                     f"chunk: rel err {rel}")
            rows["fused_ce_bwd_a"] = (dt, in_turns(
                kernel_a, lambda: ce.fused_ce_bwd_plain(h, e, t, lse, g), 2),
                "bwd")
        for which, like in (("dh", h), ("de", e)):
            entry = f"fused_ce_{which}" + ("_tc" if tc else "")
            plain = getattr(ce, f"fused_ce_{which}_plain")
            out = torch.empty_like(like)

            def kernel():
                ce._launch(entry, h.device, *ptrs, out.data_ptr(), *dims,
                           source=source)

            if not tc:   # the bf16 passes were held to it in the cases
                kernel()
                want = plain(h, e, t, lse, g)
                errs[entry] = abs_err(out, want)
                if rel_err(out, want) > GRAD_TOL["float32"]:
                    raise AssertionError(
                        f"{entry} f32 at the train chunk: rel err "
                        f"{rel_err(out, want)}")
                del want
            rows[entry] = (dt, in_turns(kernel, lambda: plain(
                h, e, t, lse, g), 3), which)
            del out
    torch.cuda.empty_cache()
    shape_out = {}
    for kname, (dt, tm, which) in rows.items():
        flops, nbytes = ce_work(n, v, d, 2 if dt == torch.bfloat16 else 4,
                                which)
        bound, bound_by = bound_ms(flops, nbytes, dt)
        # the library backward computes dh and dE: the function of #6;
        # #5 and #8 compute one of the two. bf16 yardsticks for the bf16
        # rows, f32 for the f32 split kernels
        lib = state["ce_library_bf16" if dt == torch.bfloat16
                    else "ce_library_f32"]
        tflops = flops / (tm["ms"] * 1e-3) / 1e12
        state[kname] = {"max_abs_err": errs[kname], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": bound,
                        "bound_by": bound_by,
                        "library_ms": lib["library_bwd_ms"],
                        "library": "F.linear_cross_entropy backward alone "
                                   "(dh and dE)",
                        "unfused_ms": lib["unfused_bwd_ms"],
                        "achieved_tflops": tflops,
                        "bound_share": bound / tm["ms"],
                        "dtype": str(dt)[6:], "shape": [n, v, d]}
        shape_out[kname] = {**tm, "bound_ms": bound, "bound_by": bound_by,
                            "flops": flops, "bytes": nbytes,
                            "dtype": str(dt)[6:], "achieved_tflops": tflops}
    return {"cases": results, "launches": counts, "shape": [n, v, d],
            **shape_out, "a_against_b_bf16": a_against_b,
            "split_ms": shape_out["fused_ce_dh_tc"]["ms"]
            + shape_out["fused_ce_de_tc"]["ms"],
            "split_ms_f32": shape_out["fused_ce_dh"]["ms"]
            + shape_out["fused_ce_de"]["ms"]}


def ulps(got, want) -> int:
    """Largest distance of ``got`` from ``want`` in units in the last
    place of their dtype (f32 or bf16), from their bit patterns ordered
    as the values are."""
    import torch
    bits, mask = ((torch.int32, 0x7FFFFFFF) if want.dtype == torch.float32
                  else (torch.int16, 0x7FFF))

    def key(x):
        i = x.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mask), i)

    return int((key(got) - key(want)).abs().max().item())


ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def _adamw_inputs(shapes, mu_dtype, gen):
    """p, g, mu, nu for tensors of ``shapes``: f32 but mu; nu > 0."""
    import torch
    p = [_rand(s, torch.float32, gen) for s in shapes]
    g = [_rand(s, torch.float32, gen, 1e-2) for s in shapes]
    mu = [_rand(s, mu_dtype, gen, 1e-2) for s in shapes]
    nu = [1e-4 * torch.rand(s, device="cuda", generator=gen) for s in shapes]
    return p, g, mu, nu


def _check_fused_adamw(state, gen):
    """#9 against ``adamw_reference`` on the leaf shapes of
    ``transformer_big`` and a 1000-element tail, with an f32 and a bf16
    mu, at step 1 and step 1000; one leaf misaligned for the vector loads.
    Then the update of the whole model (98 tensors) timed against its
    plain version, in turns, and against one ``torch.optim.AdamW(
    fused=True)`` step over the same tensors with f32 moments: device
    time (the kernels' durations, :func:`device_ms`), and CUDA events
    over the whole update, which add the host's launch gaps."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, param_shapes)
    from distributed_tensorflow_tpu_torch.ops.fused_adamw import (
        adamw_reference, bias_corrections, fused_adamw_update)

    leaves = [("embed", (32768, 1024)), ("mlp.wi", (1024, 8192)),
              ("scale", (1024,)), ("tail", (1000,)),
              ("unaligned_1001", (1001,))]
    hp = dict(ADAMW_HYPER)
    wd = hp.pop("weight_decay")
    results, failures, worst = [], [], 0.0
    for mu_dt in (torch.float32, torch.bfloat16):
        for count in (0, 999):      # bias corrections of steps 1 and 1000
            c1, c2 = bias_corrections(count, hp["b1"], hp["b2"])
            for name, shape in leaves:
                p, g, mu, nu = (x[0] for x in _adamw_inputs([shape], mu_dt,
                                                            gen))
                if name.startswith("unaligned"):
                    # a view 4 bytes into its storage: the scalar path
                    p, g, nu = (torch.cat([x.new_zeros(1), x])[1:]
                                for x in (p, g, nu))
                want = adamw_reference(p, g, mu, nu, c1, c2, wd=wd, **hp)
                kp, km, kv = p.clone(), mu.clone(), nu.clone()
                if name.startswith("unaligned"):
                    kp, kv = (torch.cat([x.new_zeros(1), x])[1:]
                              for x in (kp, kv))
                fused_adamw_update([kp], [g], [km], [kv], count,
                                   weight_decay=wd, **hp)
                torch.cuda.synchronize()
                err = {"p_ulp": ulps(kp, want[0]), "mu_ulp": ulps(km, want[1]),
                       "nu_ulp": ulps(kv, want[2]),
                       "p_abs": abs_err(kp, want[0])}
                mu_tol = ADAMW_ULP if mu_dt == torch.float32 \
                    else ADAMW_MU_BF16_ULP
                ok = (err["p_ulp"] <= ADAMW_ULP and err["nu_ulp"] <= ADAMW_ULP
                      and err["mu_ulp"] <= mu_tol
                      and bool(torch.isfinite(kp).all().item()))
                case = f"{str(mu_dt)[6:]}_mu_step{count + 1}_{name}"
                results.append({"case": case, "err": err, "ok": ok})
                worst = max(worst, err["p_abs"])
                if not ok:
                    failures.append(case)
    if failures:
        raise AssertionError(f"fused_adamw disagrees with its plain "
                             f"version: {failures}: {results}")

    # the whole model's update, as the fused train step runs it
    cfg = TransformerConfig.transformer_big()
    tree = param_shapes(cfg)
    shapes = [tree["embed"], tree["final_norm"]["scale"]] + [
        s[1:] for leaves_ in tree["layers"].values() for s in leaves_.values()
        for _ in range(s[0])]
    n_params = sum(math.prod(s) for s in shapes)
    timings = {}
    for tag, mu_dt in (("bf16_mu", torch.bfloat16), ("f32_mu", torch.float32)):
        p, g, mu, nu = _adamw_inputs(shapes, mu_dt, gen)
        c1, c2 = bias_corrections(0, hp["b1"], hp["b2"])

        def plain():
            for x in zip(p, g, mu, nu):
                adamw_reference(*x, c1, c2, wd=wd, **hp)

        def kernel():
            fused_adamw_update(p, g, mu, nu, 0, weight_decay=wd, **hp)

        timings[tag] = in_turns(kernel, plain, 5, timer=device_ms)
        events = in_turns(kernel, plain, 10)
        timings[tag].update({f"{k}_events": events[k]
                             for k in ("ms", "plain_ms")})
        if tag == "f32_mu":
            leaves_ = [x.clone().requires_grad_() for x in p]
            for x, gx in zip(leaves_, g):
                x.grad = gx
            lib = torch.optim.AdamW(leaves_, lr=hp["lr"],
                                    betas=(hp["b1"], hp["b2"]),
                                    eps=hp["eps"], weight_decay=wd,
                                    fused=True)
            library = device_ms(lib.step)
            library_events = time_ms(lib.step, 10)
            del lib, leaves_
        del p, g, mu, nu
        torch.cuda.empty_cache()
    out = {}
    for tag, el_mu in (("bf16_mu", 2), ("f32_mu", 4)):
        nbytes = n_params * (4 + 4 + 4 + 2 * el_mu + 4 + 4)
        bound, bound_by = bound_ms(13 * n_params, nbytes, torch.float32)
        out[tag] = {**timings[tag], "bound_ms": bound, "bound_by": bound_by,
                    "bytes": nbytes,
                    "achieved_gb_s": nbytes / (timings[tag]["ms"] * 1e-3)
                    / 1e9}
    # the row: the fused train step's bf16 mu; the library (f32 moments)
    # beside the f32-mu run
    state["fused_adamw"] = {
        "max_abs_err": worst, "ms": out["bf16_mu"]["ms"],
        "plain_ms": out["bf16_mu"]["plain_ms"],
        "bound_ms": out["bf16_mu"]["bound_ms"],
        "bound_by": out["bf16_mu"]["bound_by"], "library_ms": library,
        "ms_events": out["bf16_mu"]["ms_events"],
        "f32_mu": {k: out["f32_mu"][k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "ms_events")},
        "library_ms_events": library_events,
        "shape": f"{len(shapes)} tensors, {n_params} parameters"}
    return {"cases": results, "tol_ulp": {"p": ADAMW_ULP, "nu": ADAMW_ULP,
                                          "mu_f32": ADAMW_ULP,
                                          "mu_bf16": ADAMW_MU_BF16_ULP},
            "tensors": len(shapes), "n_params": n_params, **out,
            "library": "torch.optim.AdamW(fused=True).step, f32 moments",
            "library_ms": library, "library_ms_events": library_events}


def _check_bert_attention(state, gen):
    """#1, #2 and #3 at BERT's train shape, (32, 12, 512, 64) bf16 not
    causal (every k-tile visited, no tail masked): the forward and the
    backward against their plain versions, one launch each; then each
    kernel timed against its plain version in turns, and SDPA
    (``is_causal=False``) by CUDA events and by device time."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain, launch_bwd_dkv, launch_bwd_dq)
    b, h, s_, hd = BERT_BATCH, 12, 512, 64
    q, k, v, do = (_rand((b, h, s_, hd), torch.bfloat16, gen)
                   for _ in range(4))
    sm = hd ** -0.5
    before = launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal=False)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    after = launch_counts()
    calls = {c: after[c] - before[c] for c in after if after[c] != before[c]}
    fwd = _fwd_errors(q, k, v, o, lse, False)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                                     sm_scale=sm)
    errs = {f"d{n}": rel_err(g, w) for n, g, w in zip("qkv", got, want)}
    ok = (fwd["ok"] and max(errs.values()) <= GRAD_TOL["bfloat16"]
          and all(bool(torch.isfinite(g).all().item()) for g in got)
          and calls == {"flash_fwd_tc": 1, "flash_bwd_dq_tc": 1,
                        "flash_bwd_dkv_tc": 1})
    check = {"shape": [b, h, s_, hd], "causal": False, "fwd": fwd,
             "bwd_rel_err": errs, "launches": calls, "ok": ok}
    if not ok:
        raise AssertionError(f"attention at BERT's shape: {check}")
    max_err = {"flash_fwd_tc": fwd["o_err"],
               "flash_bwd_dq_tc": abs_err(got[0], want[0]),
               "flash_bwd_dkv_tc": max(abs_err(got[1], want[1]),
                                       abs_err(got[2], want[2]))}
    del got, want

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=False, scale=sm)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_sdpa = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=False, scale=sm)

    def sdpa_bwd():
        torch.autograd.grad(out_sdpa, leaves, do, retain_graph=True)

    lib = {"fwd": (time_ms(sdpa), device_ms(sdpa, 10)),
           "bwd": (time_ms(sdpa_bwd), device_ms(sdpa_bwd, 10))}
    del out_sdpa, leaves
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(sm_scale=sm, causal=False, causal_offset=0)
    def plain_fwd():
        flash_attention_plain(q, k, v, causal=False, sm_scale=sm)

    def plain_bwd():   # computes dq, dk and dv
        flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                                  sm_scale=sm)

    kernels = {
        "flash_fwd_tc": ("fwd", lambda: flash_attention_fwd(q, k, v),
                         plain_fwd),
        "flash_bwd_dq_tc": ("dq", lambda: launch_bwd_dq(
            q, k, v, do, lse, delta, **kw), plain_bwd),
        "flash_bwd_dkv_tc": ("dkv", lambda: launch_bwd_dkv(
            q, k, v, do, lse, delta, **kw), plain_bwd)}
    rows = {}
    for name, (op, kernel, plain) in kernels.items():
        t = in_turns(kernel, plain, 10)
        flops, nbytes = attention_work(q, k, False, 0, op)
        lib_ms, lib_dev = lib["fwd" if op == "fwd" else "bwd"]
        rows[name] = {**_flash_row(t, flops, nbytes, q.dtype, max_err[name],
                                   lib_ms, q.shape),
                      "plain_ms_runs": t["plain_ms_runs"],
                      "device_ms": device_ms(kernel, 10),
                      "library_device_ms": lib_dev,
                      "library": "scaled_dot_product_attention(is_causal="
                                 "False)" + ("" if op == "fwd" else
                                             " backward (dq, dk, dv)")}
    state.setdefault("bert_rows", {}).update(rows)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return {"check": check, **rows}


def _check_bert_ce(state, gen):
    """#4 and #7 at the shape BERT's kernel loss gives each launch: a
    4096-row chunk of its 16384 tokens (``ROW_CHUNK``), V 30522 (238
    tiles of 128 and a 58-row tail; 476 of 64 and the same tail), D 768
    (six 128-wide chunks), bf16. As in the MLM loss, 85 % of the rows
    are unmasked (target 0, upstream gradient exactly 0) and add nothing
    to dh or dE; an all-unmasked chunk (denominator 1, every gradient 0)
    gives exact zeros. Against the plain versions, then timed in turns
    and against the unfused ``F.cross_entropy(F.linear)``."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        ROW_CHUNK, fused_ce_bwd, fused_ce_bwd_plain, fused_ce_fwd,
        fused_ce_fwd_plain)
    n, v, d = ROW_CHUNK, 30522, 768
    h = _rand((n, d), torch.bfloat16, gen)
    e = _rand((v, d), torch.bfloat16, gen, 0.1)
    masked = torch.rand(n, device="cuda", generator=gen) < 0.15
    t = torch.randint(0, v, (n,), device="cuda", generator=gen)
    rows_m = masked.nonzero()[:, 0]
    edges = torch.tensor([v - 1, v - 58, v - 59, 128 * 238 - 1, 64 * 476],
                         device="cuda")
    t[rows_m[:len(edges)]] = edges
    t = torch.where(masked, t, 0)
    g = masked.float() / masked.sum().clamp_min(1)
    before = launch_counts()
    lse, tl = fused_ce_fwd(h, e, t)
    dh, de = fused_ce_bwd(h, e, t, lse, g)
    zdh, zde = fused_ce_bwd(h, e, t, lse, torch.zeros_like(g))
    torch.cuda.synchronize()
    after = launch_counts()
    calls = {c: after[c] - before[c] for c in after if after[c] != before[c]}
    plse, ptl = fused_ce_fwd_plain(h, e, t)
    pdh, pde = fused_ce_bwd_plain(h, e, t, plse, g)
    errs = {"lse": abs_err(lse, plse), "tl": abs_err(tl, ptl),
            "dh_rel": rel_err(dh, pdh), "de_rel": rel_err(de, pde)}
    tol = GRAD_TOL["bfloat16"]
    zero_rows = bool((dh[~masked] == 0).all().item())
    all_zero = bool((zdh == 0).all().item() and (zde == 0).all().item())
    ok = (errs["lse"] <= CE_ROW_TOL and errs["tl"] <= CE_ROW_TOL
          and errs["dh_rel"] <= tol and errs["de_rel"] <= tol
          and zero_rows and all_zero
          and calls == {"fused_ce_fwd_tc": 1, "fused_ce_bwd_tc": 2}
          and all(bool(torch.isfinite(x).all().item())
                  for x in (lse, tl, dh, de)))
    check = {"shape": [n, v, d], "masked_rows": int(masked.sum().item()),
             "err": errs, "tol": {"row": CE_ROW_TOL, "grad_rel": tol},
             "unmasked_dh_rows_zero": zero_rows,
             "all_unmasked_grads_zero": all_zero, "launches": calls,
             "ok": ok}
    if not ok:
        raise AssertionError(f"fused CE at BERT's shape: {check}")
    fwd_err = max(errs["lse"], errs["tl"])
    bwd_err = max(abs_err(dh, pdh), abs_err(de, pde))
    del dh, de, zdh, zde, pdh, pde
    t_fwd = in_turns(lambda: fused_ce_fwd(h, e, t),
                     lambda: fused_ce_fwd_plain(h, e, t), 5)
    t_bwd = in_turns(lambda: fused_ce_bwd(h, e, t, lse, g),
                     lambda: fused_ce_bwd_plain(h, e, t, lse, g), 3)
    lib = _ce_library(h, e, t, g)
    rows = {}
    for name, which, tm, err in (("fused_ce_fwd_tc", "fwd", t_fwd, fwd_err),
                                 ("fused_ce_bwd_tc", "bwd", t_bwd, bwd_err)):
        rows[name] = _ce_row(n, v, d, h.dtype, which, tm, err, lib)
    state.setdefault("bert_rows", {}).update(rows)
    del h, e, lse
    torch.cuda.empty_cache()
    return {"check": check, **rows, "library": lib}


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"flash_fwd": _check_flash_fwd(state, gen),
           "flash_bwd": _check_flash_bwd(state, gen),
           "fused_ce": _check_fused_ce(state, gen)}
    torch.cuda.empty_cache()
    out["fused_ce_variants"] = _check_ce_variants(state, gen)
    torch.cuda.empty_cache()
    out["fused_adamw"] = _check_fused_adamw(state, gen)
    torch.cuda.empty_cache()
    out["bert_attention"] = _check_bert_attention(state, gen)
    out["bert_ce"] = _check_bert_ce(state, gen)
    return out


def _instrument(engine, prefill_ms, decode_ms):
    """Time each prefill and decode step of ``engine`` on the host clock
    (both end in a device-to-host read of the argmax, so the work is
    done when they return)."""
    pre, dec = engine._prefill_one, engine._decode_batch

    def timed_prefill(seq):
        t0 = time.perf_counter()
        pre(seq)
        prefill_ms.append((seq.prompt_len,
                           (time.perf_counter() - t0) * 1e3))

    def timed_decode(batch):
        t0 = time.perf_counter()
        dec(batch)
        decode_ms.append((len(batch), (time.perf_counter() - t0) * 1e3))

    engine._prefill_one = timed_prefill
    engine._decode_batch = timed_decode


def phase_serve(state):
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    cfg = TransformerConfig.transformer_big()           # bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    num_blocks = SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1
    engine = InferenceEngine(cfg, params, device="cuda",
                             num_blocks=num_blocks, block_size=SERVE_BLOCK,
                             max_slots=SERVE_SLOTS)
    del params
    rng = np.random.default_rng(0)
    max_prompt = cfg.max_seq_len - SERVE_NEW
    lens = rng.integers(16, max_prompt + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    # warm-up (allocator, cuBLAS handles, the kernel library): two short
    # requests, not counted
    engine.generate([prompts[0][:16], prompts[1][:40]], max_new_tokens=2)
    prefills0, steps0 = engine.prefills, engine.decode_steps
    prefill_ms, decode_ms = [], []
    _instrument(engine, prefill_ms, decode_ms)

    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["flash_fwd_tc"]

    prefills = engine.prefills - prefills0
    acct = engine.block_accounting()
    n_tokens = sum(len(o) for o in outs)
    problems = []
    if len(outs) != SERVE_REQUESTS or any(len(o) != SERVE_NEW for o in outs):
        problems.append(f"incomplete outputs: {[len(o) for o in outs]}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        problems.append("token id out of range")
    if launches == 0:
        problems.append("flash_fwd_tc never launched on the serving path")
    if launches != cfg.n_layers * prefills:
        problems.append(f"flash_fwd_tc launches {launches} != "
                        f"{cfg.n_layers} x {prefills} prefills")
    if any(n for k, n in counts.items() if k != "flash_fwd_tc"):
        problems.append(f"another kernel ran while serving: {counts}")
    if not acct["conserved"] or acct["leaked_refs"] != 0 \
            or acct["free"] != acct["usable"]:
        problems.append(f"block accounting at idle: {acct}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["serve_launches"] = launches
    dec = [ms for _, ms in decode_ms]
    pool_bytes = sum(a.numel() * a.element_size()
                     for a in engine.pool.values())
    return {"config": "transformer_big", "dtype": "bfloat16",
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "prompt_lens": [int(n) for n in lens],
            "num_blocks": num_blocks, "pool_bytes": pool_bytes,
            "wall_s": wall, "tokens": n_tokens,
            "tokens_per_s": n_tokens / wall,
            "prefills": prefills,
            "decode_steps": engine.decode_steps - steps0,
            "preemptions": engine.stats()["preemptions"],
            "prefill_ms": [[n, ms] for n, ms in prefill_ms],
            "prefill_ms_mean": float(np.mean([ms for _, ms in prefill_ms])),
            "decode_step_ms_mean": float(np.mean(dec)),
            "decode_step_ms_p50": float(np.median(dec)),
            "decode_batch_sizes": sorted({b for b, _ in decode_ms}),
            "flash_fwd_tc_launches": launches,
            "expected_launches": cfg.n_layers * prefills,
            "block_accounting": acct,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_parity(state):
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig.transformer_big(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    engine = InferenceEngine(cfg, params, device="cuda", num_blocks=129,
                             block_size=SERVE_BLOCK, max_slots=4)
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 201, PARITY_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    # record the logits the engine computes, keyed (request, position)
    recorded: dict[tuple, torch.Tensor] = {}
    current = {}
    pre_one, dec_batch = engine._prefill_one, engine._decode_batch
    prefill_fn, decode_fn = engine._prefill, engine._decode

    def prefill_one(seq):
        current["seq"] = seq
        pre_one(seq)

    def prefill(params_, pool, toks, rows):
        last, pool = prefill_fn(params_, pool, toks, rows)
        seq = current["seq"]
        recorded[(seq.request.id, toks.shape[1] - 1)] = last.clone()
        return last, pool

    def decode_batch(batch):
        current["batch"] = batch
        dec_batch(batch)

    def decode(params_, pool, tokens, positions, *rest):
        logits, pool = decode_fn(params_, pool, tokens, positions, *rest)
        for i, seq in enumerate(current["batch"]):
            recorded[(seq.request.id, int(positions[i]))] = logits[i].clone()
        return logits, pool

    engine._prefill_one, engine._decode_batch = prefill_one, decode_batch
    engine._prefill, engine._decode = prefill, decode
    outs = engine.generate(prompts, max_new_tokens=PARITY_NEW)

    model = TransformerLM(cfg, params, device="cuda")
    del params
    worst, checked, compared, mismatched = 0.0, 0, 0, []
    with torch.no_grad():
        for i, (prompt, gen) in enumerate(zip(prompts, outs)):
            seq = prompt + gen
            ref = model(torch.tensor([seq[:-1]], device="cuda"))[0]
            for j, tok in enumerate(gen):
                pos = len(prompt) - 1 + j
                got = recorded[(f"g{i}", pos)]
                worst = max(worst, (got - ref[pos]).abs().max().item())
                checked += 1
                top2 = torch.topk(ref[pos], 2).values
                if (top2[0] - top2[1]).item() > PARITY_GAP:
                    compared += 1
                    if tok != int(ref[pos].argmax()):
                        mismatched.append((i, j))
    if worst > PARITY_LOGIT_TOL or mismatched or not all(
            len(o) == PARITY_NEW for o in outs):
        raise AssertionError(f"parity: max logit err {worst} (tol "
                             f"{PARITY_LOGIT_TOL}), token mismatches "
                             f"{mismatched}")
    return {"config": "transformer_big", "dtype": "float32",
            "requests": PARITY_REQUESTS, "new_tokens": PARITY_NEW,
            "prompt_lens": [int(n) for n in lens],
            "positions_checked": checked, "max_abs_logit_err": worst,
            "tol": PARITY_LOGIT_TOL, "tokens_compared": compared,
            "token_mismatches": 0}


# ---------------------------------------------------------------------------
# prefix caching and speculative decoding
# ---------------------------------------------------------------------------

def _record(engine, prefills: list, logits: dict):
    """Wrap ``engine``'s step functions to record, on the card and in
    this run: per prefill its request, length, cached tokens, host ms and
    kernel launches (``prefills``); and the logits the engine computes,
    keyed by request id and position (``logits``): a cold prefill's last
    position, every suffix position of a prefix hit, every decode row,
    and verify row 0 of a speculative step (whose context is the
    committed stream). ``logits["verify"]`` lists every verify row group
    with its full context, for recompute."""
    cur = {}
    logits.setdefault("verify", [])
    pre_one, dec_batch = engine._prefill_one, engine._decode_batch
    spec_batch = engine._speculative_batch
    prefill_fn, decode_fn, extend_fn = (engine._prefill, engine._decode,
                                        engine._extend)

    def prefill_one(seq):
        cur["seq"] = seq
        before = launch_counts()
        t0 = time.perf_counter()
        pre_one(seq)
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        prefills.append({"id": seq.request.id, "len": seq.prompt_len,
                         "cached": seq.cached_tokens, "ms": ms,
                         "launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}})

    def prefill(params_, pool, toks, rows):
        last, pool = prefill_fn(params_, pool, toks, rows)
        logits[(cur["seq"].request.id, toks.shape[1] - 1)] = last.clone()
        return last, pool

    def decode_batch(batch):
        cur["batch"] = batch
        dec_batch(batch)

    def speculative_batch(batch):
        cur["batch"] = batch
        cur["hist"] = [list(q.request.tokens) + q.generated for q in batch]
        return spec_batch(batch)

    # one copy and at most a few host reads a call: the recording runs
    # inside the timed steps, alike in the engines compared
    def decode(params_, pool, tokens, positions, *rest):
        out, pool = decode_fn(params_, pool, tokens, positions, *rest)
        kept = out.clone()
        for i, (seq, pos) in enumerate(zip(cur["batch"],
                                           positions.tolist())):
            logits[(seq.request.id, pos)] = kept[i]
        return out, pool

    def extend(params_, pool, tokens, positions, lengths, *rest):
        out, pool = extend_fn(params_, pool, tokens, positions, lengths,
                              *rest)
        kept = out.clone()
        if lengths is None:                    # a prefix hit's suffix
            seq = cur["seq"]
            for j in range(tokens.shape[1]):
                logits[(seq.request.id, seq.cached_tokens + j)] = kept[0, j]
        else:                                  # a speculative verify
            toks = tokens.tolist()
            for i, (seq, first, n) in enumerate(zip(
                    cur["batch"], positions[:, 0].tolist(),
                    lengths.tolist())):
                logits[(seq.request.id, first)] = kept[i, 0]
                logits["verify"].append((
                    cur["hist"][i][:first] + toks[i][:n - first], first,
                    kept[i, :n - first]))
        return out, pool

    engine._prefill_one, engine._decode_batch = prefill_one, decode_batch
    engine._speculative_batch = speculative_batch
    # a prefill-only replica has no decode function, and keeps none
    engine._prefill, engine._extend = prefill, extend
    engine._decode = decode if decode_fn is not None else None


def _serve_rounds(engine, rounds) -> dict:
    """Submit each round's ``{id: (prompt, new)}`` and run to idle;
    ``{id: stream}``."""
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    out = {}
    for batch in rounds:
        for rid, (prompt, new) in batch.items():
            engine.submit(Request(id=rid, tokens=tuple(prompt),
                                  max_new_tokens=new))
        out.update({rid: rec["tokens"]
                    for rid, rec in engine.run_until_idle().items()})
    return out


def _part(got: list, want: list):
    """The first index where two streams differ (None: they are equal)."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None if len(got) == len(want) else min(len(got), len(want)))


def _path_err(got_logits: dict, want_logits: dict, got: dict, want: dict,
              prompts: dict) -> float:
    """A path's measured logit error against its reference path: the
    largest difference of the logits both computed at one position in
    the same context, that is, at every position of each stream before
    it parts from its reference stream."""
    err = 0.0
    for rid, w in want.items():
        j = _part(got[rid], w)
        first = len(prompts[rid]) - 1
        for pos in range(first, first + (len(w) if j is None else j)):
            if (rid, pos) in got_logits and (rid, pos) in want_logits:
                err = max(err, abs_err(got_logits[(rid, pos)],
                                       want_logits[(rid, pos)]))
    return err


def _first_divergences(got: dict, want: dict, prompts: dict,
                       want_logits: dict, err: float) -> list:
    """Where a stream parts from its reference stream: the index, both
    tokens, and the top-2 margin of the reference's logits there. A
    margin above twice the path's measured logit error ``err``
    (:func:`_path_err`) is a fault, not rounding; it is flagged
    ``"fault": True``."""
    import torch
    out = []
    for rid, w in want.items():
        g = got[rid]
        j = _part(g, w)
        if j is None:
            continue
        pos = len(prompts[rid]) - 1 + j
        top2 = torch.topk(want_logits[(rid, pos)].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        out.append({"id": rid, "index": j, "position": pos,
                    "want": w[j] if j < len(w) else None,
                    "got": g[j] if j < len(g) else None,
                    "margin": margin, "fault": margin > 2 * err})
    return out


def _f32_recompute_errs(cfg, params, prompts: dict, want: dict,
                        paths: dict) -> dict:
    """Each bf16 path's logit error against an f32 recompute of the
    model (``params`` rounded to bf16, TF32 off): the largest difference
    at the positions that every path of ``paths`` (``{name: (streams,
    logits)}``, the logits as :func:`_record` keeps them) computed in the
    context of the reference streams ``want``, before any of its streams
    parts from them. ``{name: err, ..., "positions": n}``."""
    import dataclasses
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def rounded(node):
        if isinstance(node, dict):
            return {k: rounded(v) for k, v in node.items()}
        return node.to(torch.bfloat16).float()

    model = TransformerLM(dataclasses.replace(cfg, dtype=torch.float32),
                          rounded(params), device="cuda")
    errs, n = {name: 0.0 for name in paths}, 0
    with torch.no_grad():
        for rid, w in want.items():
            first = len(prompts[rid]) - 1
            end = first + min((len(w) if j is None else j) for j in (
                _part(got[rid], w) for got, _ in paths.values()))
            pos = [p for p in range(first, end)
                   if all((rid, p) in lg for _, lg in paths.values())]
            if not pos:
                continue
            ctx = list(prompts[rid]) + w[:pos[-1] - first]
            ref = model(torch.tensor([ctx], device="cuda"))[0]
            for name, (_, lg) in paths.items():
                errs[name] = max(errs[name], max(
                    abs_err(lg[(rid, p)], ref[p]) for p in pos))
            n += len(pos)
    del model
    torch.cuda.empty_cache()
    return {**errs, "positions": n}


def _hold_path_err(errs: dict, path: str, ref: str) -> list:
    """The problems of :data:`BF16_PATH_ERR_RATIO`'s rule."""
    if not errs["positions"] or not errs[path] <= \
            BF16_PATH_ERR_RATIO * errs[ref]:
        return [f"the {path} path's logit error from an f32 recompute "
                f"exceeds {BF16_PATH_ERR_RATIO} x the {ref} path's: {errs}"]
    return []


def _check_suffix_flash(shapes, dtype, gen) -> dict:
    """#1 at the prefix-hit path's shapes (Sq = the suffix, Sk = the
    prompt, bottom-right offset Sk - Sq = the cached tokens) against its
    plain version; the first shape also timed in turns, with SDPA under a
    lower-right causal mask and the bound of the work."""
    import torch
    from torch.nn.attention.bias import causal_lower_right
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_plain)
    cases, timed = [], None
    for sq, sk in shapes:
        q = _rand((1, 16, sq, 64), dtype, gen)
        k = _rand((1, 16, sk, 64), dtype, gen)
        v = _rand((1, 16, sk, 64), dtype, gen)
        before = launch_counts()
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        after = launch_counts()
        calls = {c: after[c] - before[c] for c in after
                 if after[c] != before[c]}
        res = {"sq": sq, "sk": sk, "offset": sk - sq,
               **_fwd_errors(q, k, v, o, lse, True), "launches": calls}
        res["ok"] = res["ok"] and calls == {_route_name(dtype, 64, "fwd"): 1}
        cases.append(res)
        if timed is None:
            timed = (q, k, v, res["o_err"])
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd at the suffix shapes disagrees "
                             f"with its plain version: {bad}")
    q, k, v, err = timed
    sq, sk = q.shape[2], k.shape[2]
    sm = q.shape[-1] ** -0.5
    mask = causal_lower_right(sq, sk)

    def kernel():
        flash_attention_fwd(q, k, v, causal=True)

    def library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm)

    t = in_turns(kernel, lambda: flash_attention_plain(
        q, k, v, causal=True, sm_scale=sm), 20)
    flops, nbytes = attention_work(q, k, True, sk - sq, "fwd")
    row = {**_flash_row(t, flops, nbytes, dtype, err, time_ms(library),
                        q.shape),
           "sk": sk, "causal_offset": sk - sq,
           "device_ms": device_ms(kernel, 20),
           "library_device_ms": device_ms(library, 20),
           "library": "scaled_dot_product_attention(causal_lower_right)"}
    return {"cases": cases, "timed": row}


def _prefix_prompts(cfg, rng, prefix_len, suffix, n):
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).tolist()
    lens = rng.integers(suffix[0], suffix[1] + 1, n)
    return [prefix + rng.integers(0, cfg.vocab_size, m).tolist()
            for m in lens]


def phase_prefix_serve(state):
    """Prefix caching at ``transformer_big`` in bf16: the cold engine and
    the caching engine on the same prompts; the hit path's prefill time,
    its flash-forward launches (12 per prefill, at Sq = the suffix, Sk =
    the prompt), and its streams against the cold engine's."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    cfg = TransformerConfig.transformer_big()           # bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    kw = dict(device="cuda", block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS,
              num_blocks=SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1)
    cold = InferenceEngine(cfg, params, **kw)
    hit = InferenceEngine(cfg, params, prefix_caching=True, **kw)
    rng = np.random.default_rng(2)
    prompts = _prefix_prompts(cfg, rng, PREFIX_LEN, PREFIX_SUFFIX,
                              SERVE_REQUESTS)
    # copy-on-write: a prompt whose match ends 9 tokens into prompt 0's
    # 33rd block, so its one suffix token is written into a copy of it
    cow = prompts[0][:PREFIX_LEN + 9] + [int(rng.integers(cfg.vocab_size))]
    # the first prompt alone (cold), the other seven (hits on it), the
    # copy-on-write prompt, then all eight again
    rounds = [{"p0": (prompts[0], SERVE_NEW)},
              {f"p{i}": (p, SERVE_NEW) for i, p in enumerate(prompts)
               if i},
              {"cow": (cow, SERVE_NEW)},
              {f"q{i}": (p, SERVE_NEW) for i, p in enumerate(prompts)}]
    by_id = {rid: p for r in rounds for rid, (p, _) in r.items()}
    # warm-up, not counted: a cold prompt and a hit on it, per engine
    warm = rng.integers(0, cfg.vocab_size, 80).tolist()
    for eng in (cold, hit):
        eng.generate([warm, warm[:64] + warm[:10]], max_new_tokens=2)
        eng.generate([warm[:70]], max_new_tokens=2)
    cold_pre, cold_logits = [], {}
    _record(cold, cold_pre, cold_logits)
    want = _serve_rounds(cold, [{rid: (p, SERVE_NEW)
                                 for rid, p in by_id.items()}])
    del cold
    torch.cuda.empty_cache()

    hit_pre, hit_logits = [], {}
    _record(hit, hit_pre, hit_logits)
    torch.cuda.synchronize()
    zero_launch_counts()
    got = _serve_rounds(hit, rounds)
    torch.cuda.synchronize()
    counts = launch_counts()
    stats = hit.stats()["prefix_cache"]
    acct = hit.block_accounting()

    hits = [p for p in hit_pre if p["cached"]]
    colds = [p for p in hit_pre if not p["cached"]]
    problems = []
    if len(hits) != 2 * SERVE_REQUESTS or len(colds) != 1:
        problems.append(f"{len(hits)} hit and {len(colds)} cold prefills")
    per = cfg.n_layers
    if counts != expected_counts({"flash_fwd_tc": per}, len(hit_pre)):
        problems.append(f"launches {counts}, expected {per} a prefill")
    if any(p["launches"] != {"flash_fwd_tc": per} for p in hit_pre):
        problems.append(f"a prefill launched other than {per} "
                        f"flash_fwd_tc: {hit_pre}")
    cow_pre = next(p for p in hit_pre if p["id"] == "cow")
    if cow_pre["cached"] != PREFIX_LEN + 9:
        problems.append(f"copy-on-write prompt matched {cow_pre['cached']}")
    if not acct["conserved"] or acct["leaked_refs"] != 0 or \
            acct["free"] + acct["cache_refs"] != acct["usable"]:
        problems.append(f"block accounting at idle: {acct}")
    want = {rid: want[rid] for rid in got}
    err = _path_err(hit_logits, cold_logits, got, want, by_id)
    div = _first_divergences(got, want, by_id, cold_logits, err)
    if any(d["fault"] for d in div):
        problems.append(f"streams part where the margin exceeds twice the "
                        f"logit error {err}: {div}")
    if any(len(s) != SERVE_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in s) for s in got.values()):
        problems.append("incomplete or out-of-range streams")
    shapes = sorted({(p["len"] - p["cached"], p["len"]) for p in hits},
                    key=lambda s: -s[0] * s[1])
    del hit
    torch.cuda.empty_cache()
    f32_errs = _f32_recompute_errs(cfg, params, by_id, want, {
        "cold": (want, cold_logits), "hit": (got, hit_logits)})
    problems += _hold_path_err(f32_errs, "hit", "cold")
    del params
    gen = torch.Generator(device="cuda").manual_seed(3)
    kernel = _check_suffix_flash([shapes[0], (1, cow_pre["len"])]
                                 + shapes[1:4], torch.bfloat16, gen)
    if problems:
        raise AssertionError("; ".join(problems))
    state["prefix_launches"] = counts
    state["flash_fwd_tc"]["prefix"] = {
        "launches": counts["flash_fwd_tc"],
        "hit_launches": sum(p["launches"]["flash_fwd_tc"] for p in hits),
        "hit_prefills": len(hits), **kernel["timed"]}
    cold_ms = [p["ms"] for p in cold_pre if p["id"].startswith("p")]
    return {"config": "transformer_big", "dtype": "bfloat16",
            "prefix_len": PREFIX_LEN,
            "suffix_lens": [len(p) - PREFIX_LEN for p in prompts],
            "cow_prompt": {"len": cow_pre["len"],
                           "cached": cow_pre["cached"]},
            "prefill_ms_cold": [[p["len"], p["ms"]] for p in cold_pre
                                if p["id"].startswith("p")],
            "prefill_ms_hit": [[p["len"], p["cached"], p["ms"]]
                               for p in hits],
            "prefill_ms_cold_mean": float(np.mean(cold_ms)),
            "prefill_ms_hit_mean": float(np.mean([p["ms"] for p in hits])),
            "prefill_ms_hit_round1_mean": float(np.mean(
                [p["ms"] for p in hits if p["id"].startswith("p")])),
            "prefill_ms_hit_round2_mean": float(np.mean(
                [p["ms"] for p in hits if p["id"].startswith("q")])),
            "cached_tokens": sum(p["cached"] for p in hits),
            "prompt_tokens": sum(p["len"] for p in hit_pre),
            "prefix_cache": stats, "launches": counts,
            "hit_shapes_sq_sk": [[p["len"] - p["cached"], p["len"]]
                                 for p in hits],
            "suffix_kernel": kernel, "hit_logit_err": err,
            "f32_recompute_err": f32_errs,
            "err_ratio_max": BF16_PATH_ERR_RATIO,
            "streams_equal": sum(got[r] == want[r] for r in got),
            "streams": len(got), "divergences": div,
            "block_accounting": acct}


def _f32_big(seed):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig.transformer_big(dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")


def phase_prefix_parity(state):
    """f32, TF32 off, full ``transformer_big``: every suffix logit of a
    prefix hit against ``TransformerLM`` recompute of the whole prompt
    (the CUDA-core flash forward, 12 a prefill), and the caching
    engine's streams equal to the cold engine's."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    cfg, params = _f32_big(4)
    kw = dict(device="cuda", num_blocks=129, block_size=SERVE_BLOCK,
              max_slots=4)
    rng = np.random.default_rng(4)
    prompts = _prefix_prompts(cfg, rng, PREFIX_PARITY_LEN,
                              PREFIX_PARITY_SUFFIX, PARITY_REQUESTS)
    cow = prompts[0][:PREFIX_PARITY_LEN + 5] + [7]
    rounds = [{"p0": (prompts[0], PARITY_NEW)},
              {f"p{i}": (p, PARITY_NEW) for i, p in enumerate(prompts)
               if i},
              {"cow": (cow, PARITY_NEW)}]
    by_id = {rid: p for r in rounds for rid, (p, _) in r.items()}
    want = _serve_rounds(InferenceEngine(cfg, params, **kw), rounds)
    hit = InferenceEngine(cfg, params, prefix_caching=True, **kw)
    pre, logits = [], {}
    _record(hit, pre, logits)
    torch.cuda.synchronize()
    zero_launch_counts()
    got = _serve_rounds(hit, rounds)
    torch.cuda.synchronize()
    counts = launch_counts()
    del hit
    model = TransformerLM(cfg, params, device="cuda")
    del params
    worst, checked = 0.0, 0
    hits = [p for p in pre if p["cached"]]
    with torch.no_grad():
        for p in hits:
            toks = by_id[p["id"]]
            ref = model(torch.tensor([toks], device="cuda"))[0]
            for pos in range(p["cached"], p["len"]):
                worst = max(worst, abs_err(logits[(p["id"], pos)], ref[pos]))
                checked += 1
    problems = []
    if counts != expected_counts({"flash_fwd": cfg.n_layers}, len(pre)):
        problems.append(f"launches {counts}")
    if len(hits) != PARITY_REQUESTS:
        problems.append(f"{len(hits)} hit prefills: {pre}")
    if worst > PARITY_LOGIT_TOL:
        problems.append(f"suffix logits {worst} from recompute (tol "
                        f"{PARITY_LOGIT_TOL})")
    if got != want:
        problems.append(f"streams differ from the cold engine's: "
                        f"{[r for r in want if got[r] != want[r]]}")
    if problems:
        raise AssertionError("; ".join(problems))
    del model
    torch.cuda.empty_cache()
    state["prefix_parity_launches"] = counts
    return {"config": "transformer_big", "dtype": "float32",
            "prefix_len": PREFIX_PARITY_LEN,
            "prompt_lens": [len(p) for p in by_id.values()],
            "hits": [[p["len"], p["cached"]] for p in hits],
            "suffix_positions_checked": checked,
            "max_abs_logit_err": worst, "tol": PARITY_LOGIT_TOL,
            "streams_equal_cold": True, "launches": counts}


def phase_spill(state):
    """The host spill tier, f32 (TF32 off) at ``transformer_big``: a
    24-block pool, so a long generation evicts the first prompt's cached
    blocks to host memory, and the first prompt again re-adopts them.
    Blocks spilled and re-adopted, bytes moved each way and their host
    time; the re-adopted rows equal the spilled bytes; the streams equal
    the same run's without a spill tier."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.kv_cache import HostTier

    cfg, params = _f32_big(5)
    rng = np.random.default_rng(5)
    a = rng.integers(0, cfg.vocab_size, SPILL_PROMPT).tolist()
    b = rng.integers(0, cfg.vocab_size, 2 * SERVE_BLOCK).tolist()
    rounds = [{"a": (a, 8)}, {"b": (b, SPILL_LONG_NEW)}, {"a2": (a, 8)}]
    kw = dict(device="cuda", num_blocks=SPILL_BLOCKS,
              block_size=SERVE_BLOCK, max_slots=2, prefix_caching=True)
    want = _serve_rounds(InferenceEngine(cfg, params, **kw), rounds)
    tier = HostTier(64)
    eng = InferenceEngine(cfg, params, spill_tier=tier, **kw)
    del params
    pc = eng.scheduler.prefix_cache
    moved = {"out": [0, 0.0], "in": [0, 0.0]}
    spilled = {}
    extract, insert = pc._spill_extract, pc._spill_insert

    def timed_extract(block):
        t0 = time.perf_counter()
        arrays = extract(block)
        moved["out"][0] += sum(x.nbytes for x in arrays.values())
        moved["out"][1] += (time.perf_counter() - t0) * 1e3
        return arrays

    def timed_insert(block, arrays):
        t0 = time.perf_counter()
        insert(block, arrays)
        torch.cuda.synchronize()
        moved["in"][0] += sum(x.nbytes for x in arrays.values())
        moved["in"][1] += (time.perf_counter() - t0) * 1e3

    put = tier.put

    def recording_put(key, parent, tokens, arrays, epoch):
        spilled[key] = arrays
        put(key, parent, tokens, arrays, epoch)

    pc._spill_extract, pc._spill_insert = timed_extract, timed_insert
    tier.put = recording_put
    pre = []
    _record(eng, pre, {})
    torch.cuda.synchronize()
    zero_launch_counts()
    got = _serve_rounds(eng, rounds)
    torch.cuda.synchronize()
    counts = launch_counts()
    st = tier.stats()
    exact = all(np.array_equal(eng._extract_block(pc._entries[k].block)[n],
                               arrays[n])
                for k, arrays in spilled.items() if k in pc._entries
                for n in arrays)
    readopted_now = sum(k in pc._entries for k in spilled)
    acct = eng.block_accounting()
    problems = []
    if st["spilled"] == 0 or st["readopted"] == 0:
        problems.append(f"nothing spilled or re-adopted: {st}")
    if not exact or readopted_now != st["readopted"]:
        problems.append("re-adopted rows differ from the spilled bytes")
    if got != want:
        problems.append(f"streams differ from the run without a spill "
                        f"tier: {got} vs {want}")
    if got["a2"] != got["a"]:
        problems.append("the re-adopted prompt's stream differs from its "
                        "cold stream")
    if counts != expected_counts({"flash_fwd": cfg.n_layers}, len(pre)):
        problems.append(f"launches {counts}")
    if not acct["conserved"] or acct["leaked_refs"] != 0:
        problems.append(f"block accounting at idle: {acct}")
    if problems:
        raise AssertionError("; ".join(problems))
    block_bytes = moved["out"][0] // max(1, st["spilled"])
    del eng
    torch.cuda.empty_cache()
    state["spill_launches"] = counts
    return {"config": "transformer_big", "dtype": "float32",
            "usable_blocks": SPILL_BLOCKS - 1, "prompt_len": SPILL_PROMPT,
            "spill_tier": st, "prefix_cache": pc.stats(),
            "block_bytes": block_bytes,
            "bytes_out": moved["out"][0], "bytes_in": moved["in"][0],
            "host_ms_out": moved["out"][1], "host_ms_in": moved["in"][1],
            "prefills": [[p["len"], p["cached"]] for p in pre],
            "readopted_bit_exact": exact, "streams_equal_no_spill": True,
            "launches": counts}


def _time_batches(engine, log: list):
    """Host ms and tokens committed of each decode or speculative step
    (both end in a device-to-host read of the argmax)."""
    dec, spec = engine._decode_batch, engine._speculative_batch

    def timed_decode(batch):
        t0 = time.perf_counter()
        dec(batch)
        log.append(((time.perf_counter() - t0) * 1e3, len(batch)))

    def timed_spec(batch):
        t0 = time.perf_counter()
        n = spec(batch)
        log.append(((time.perf_counter() - t0) * 1e3, n))
        return n

    engine._decode_batch, engine._speculative_batch = timed_decode, \
        timed_spec


def _count_draft(engine, per_call: list, keep: bool = False):
    """Record each draft call of ``engine``: its kernel launches and the
    width of the histories it was given; with ``keep`` also its inputs
    and proposals (for :func:`_draft_agreement`)."""
    draft = engine._draft

    def counted(params_, tokens, lengths):
        before = launch_counts()
        out = draft(params_, tokens, lengths)
        after = launch_counts()
        rec = {"launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]},
               "width": int(tokens.shape[1])}
        if keep:
            rec.update(tokens=tokens.clone(), lengths=lengths.clone(),
                       out=out.clone())
        per_call.append(rec)
        return out

    engine._draft = counted


def _draft_agreement(cfg, params, calls: list) -> dict:
    """The draft's proposals on the card against the argmax of the
    lengths-masked ``model_forward`` of the same draft (``mha_reference``,
    no kernel) on the same histories, at each history's end; compared
    where that forward's top-2 margin exceeds :data:`PARITY_GAP`."""
    import torch
    from distributed_tensorflow_tpu_torch.serving.decode import (
        model_forward)
    rows, compared, mismatched = 0, 0, []
    with torch.no_grad():
        for i, c in enumerate(calls):
            lens = c["lengths"]
            ref = model_forward(cfg, params, c["tokens"], lens)
            last = ref[torch.arange(len(lens), device=ref.device),
                       lens - 1]
            top2 = torch.topk(last, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > PARITY_GAP
            if bool((sure & (last.argmax(-1) != c["out"])).any()):
                mismatched.append(i)
            rows += len(lens)
            compared += int(sure.sum())
    return {"calls": len(calls), "rows": rows, "compared": compared,
            "mismatched_calls": mismatched}


def phase_spec_serve(state):
    """Speculative decoding at ``transformer_big`` in bf16, k = 4 with
    the default 6-layer truncated draft, against the same engine without
    speculation on the serve phase's 8 prompts × 32 new tokens:
    acceptance, tokens/s, decode ms per committed token, the draft's
    flash-forward launches (6 a proposal), and the streams."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    cfg = TransformerConfig.transformer_big()           # bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    kw = dict(device="cuda", block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS,
              num_blocks=SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, cfg.max_seq_len - SERVE_NEW + 1, SERVE_REQUESTS)
    prompts = {f"s{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(lens)}
    rounds = [{rid: (p, SERVE_NEW) for rid, p in prompts.items()}]
    runs = {}
    for name, extra in (("plain", {}), ("spec", {"speculative_k": SPEC_K})):
        eng = InferenceEngine(cfg, params, **kw, **extra)
        eng.generate([prompts["s0"][:16], prompts["s1"][:40]],
                     max_new_tokens=6)                     # warm-up
        pre, logits, steps, drafts = [], {}, [], []
        _record(eng, pre, logits)
        _time_batches(eng, steps)
        if extra:
            _count_draft(eng, drafts)
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        out = _serve_rounds(eng, rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"out": out, "wall": wall, "pre": pre,
                      "logits": logits, "steps": steps, "drafts": drafts,
                      "counts": launch_counts(), "stats": eng.stats(),
                      "acct": eng.block_accounting()}
        del eng
        torch.cuda.empty_cache()
    plain, spec = runs["plain"], runs["spec"]
    draft_layers = cfg.n_layers // 2
    n_draft = len(spec["drafts"])
    draft_tc = sum(d["launches"].get("flash_fwd_tc", 0)
                   for d in spec["drafts"])
    problems = []
    if any(d["launches"] != {"flash_fwd_tc": draft_layers}
           for d in spec["drafts"]):
        problems.append(f"a draft call launched other than "
                        f"{draft_layers} flash_fwd_tc")
    want_counts = expected_counts({"flash_fwd_tc": cfg.n_layers},
                                  len(spec["pre"]))
    want_counts["flash_fwd_tc"] += draft_tc
    if spec["counts"] != want_counts or n_draft == 0:
        problems.append(f"launches {spec['counts']}, expected {want_counts}")
    # verify row 0 (context = the committed stream) against plain decode
    err = _path_err(spec["logits"], plain["logits"], spec["out"],
                    plain["out"], prompts)
    div = _first_divergences(spec["out"], plain["out"], prompts,
                             plain["logits"], err)
    if any(d["fault"] for d in div):
        problems.append(f"streams part where the margin exceeds twice the "
                        f"logit error {err}: {div}")
    f32_errs = _f32_recompute_errs(cfg, params, prompts, plain["out"], {
        "plain": (plain["out"], plain["logits"]),
        "spec": (spec["out"], spec["logits"])})
    del params
    problems += _hold_path_err(f32_errs, "spec", "plain")
    for name, r in runs.items():
        a = r["acct"]
        if not a["conserved"] or a["free"] != a["usable"]:
            problems.append(f"{name} block accounting at idle: {a}")
    if problems:
        raise AssertionError("; ".join(problems))

    def summary(r):
        toks = sum(len(s) for s in r["out"].values())
        ms = sum(m for m, _ in r["steps"])
        committed = sum(n for _, n in r["steps"])
        return {"wall_s": r["wall"], "tokens": toks,
                "tokens_per_s": toks / r["wall"], "decode_steps":
                len(r["steps"]), "decode_ms": ms,
                "decode_committed": committed,
                "ms_per_committed_token": ms / committed,
                "prefill_ms_mean": float(np.mean([p["ms"]
                                                  for p in r["pre"]]))}

    state["spec_launches"] = spec["counts"]
    state["flash_fwd_tc"]["spec"] = {
        "launches": spec["counts"]["flash_fwd_tc"],
        "draft_launches": draft_tc, "draft_calls": n_draft,
        "draft_width_max": max(d["width"] for d in spec["drafts"])}
    return {"config": "transformer_big", "dtype": "bfloat16", "k": SPEC_K,
            "draft_layers": draft_layers,
            "prompt_lens": [int(n) for n in lens],
            "speculative": spec["stats"]["speculative"],
            "plain": summary(plain), "spec": summary(spec),
            "draft_calls": n_draft, "draft_flash_launches": draft_tc,
            "launches": spec["counts"], "verify_logit_err": err,
            "f32_recompute_err": f32_errs,
            "err_ratio_max": BF16_PATH_ERR_RATIO,
            "streams_equal": sum(spec["out"][r] == plain["out"][r]
                                 for r in prompts),
            "streams": len(prompts), "divergences": div}


def phase_spec_parity(state):
    """f32, TF32 off, full ``transformer_big``, k = 4, with the default
    draft and with the target as its own draft: the streams exactly
    those of non-speculative decode, every verify row's logits against
    ``TransformerLM`` recompute of its context (the committed stream
    plus the drafted tokens), every draft proposal against the argmax of
    the masked forward (:func:`_draft_agreement`); the self-draft
    accepts every proposal, so its steps commit several tokens and reuse
    the K/V that their verify wrote."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)

    cfg, params = _f32_big(1)
    kw = dict(device="cuda", num_blocks=129, block_size=SERVE_BLOCK,
              max_slots=4)
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 201, PARITY_REQUESTS)
    rounds = [{f"g{i}": (rng.integers(0, cfg.vocab_size, n).tolist(),
                         PARITY_NEW) for i, n in enumerate(lens)}]
    want = _serve_rounds(InferenceEngine(cfg, params, **kw), rounds)
    runs, problems = {}, []
    for name, extra in (("truncated", {}),
                        ("self", {"draft_params": params, "draft_cfg": cfg})):
        eng = InferenceEngine(cfg, params, speculative_k=SPEC_K, **kw,
                              **extra)
        pre, logits, drafts = [], {}, []
        _record(eng, pre, logits)
        _count_draft(eng, drafts, keep=True)
        torch.cuda.synchronize()
        zero_launch_counts()
        got = _serve_rounds(eng, rounds)
        torch.cuda.synchronize()
        counts = launch_counts()
        stats = eng.stats()["speculative"]
        agree = _draft_agreement(eng.draft_cfg, eng._draft_params, drafts)
        per = eng.draft_cfg.n_layers
        del eng
        want_counts = expected_counts({"flash_fwd": cfg.n_layers}, len(pre))
        want_counts["flash_fwd"] += per * len(drafts)
        if got != want:
            problems.append(f"{name}: streams differ from non-speculative "
                            f"decode: {[r for r in want if got[r] != want[r]]}")
        if counts != want_counts or not drafts or any(
                d["launches"] != {"flash_fwd": per} for d in drafts):
            problems.append(f"{name}: launches {counts}, expected "
                            f"{want_counts}")
        if agree["mismatched_calls"] or not agree["compared"]:
            problems.append(f"{name}: draft proposals differ from the "
                            f"masked forward's argmax: {agree}")
        if name == "self" and not 0 < stats["accepted"] == stats["proposed"]:
            problems.append(f"self-draft acceptance below 1: {stats}")
        runs[name] = {"counts": counts, "stats": stats, "agree": agree,
                      "verify": logits["verify"],
                      "draft_calls": len(drafts)}
    model = TransformerLM(cfg, params, device="cuda")
    del params
    with torch.no_grad():
        for name, r in runs.items():
            worst, rows = 0.0, 0
            for ctx, first, out in r["verify"]:
                ref = model(torch.tensor([ctx], device="cuda"))[0]
                worst = max(worst, abs_err(out, ref[first:first + len(out)]))
                rows += len(out)
            r.update(worst=worst, rows=rows)
            if worst > PARITY_LOGIT_TOL or rows == 0:
                problems.append(f"{name}: verify logits {worst} from "
                                f"recompute over {rows} rows (tol "
                                f"{PARITY_LOGIT_TOL})")
    del model
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    state["spec_parity_launches"] = runs["truncated"]["counts"]
    state["spec_parity_self_launches"] = runs["self"]["counts"]
    return {"config": "transformer_big", "dtype": "float32", "k": SPEC_K,
            "prompt_lens": [int(n) for n in lens],
            "tol": PARITY_LOGIT_TOL, "streams_equal_plain": True,
            **{name: {"speculative": r["stats"],
                      "verify_rows_checked": r["rows"],
                      "verify_calls": len(r["verify"]),
                      "max_abs_logit_err": r["worst"],
                      "draft_calls": r["draft_calls"],
                      "draft_agreement": r["agree"],
                      "launches": r["counts"]}
               for name, r in runs.items()}}


# ---------------------------------------------------------------------------
# disaggregated serving, hot-swap, chaos
# ---------------------------------------------------------------------------

def _serve_prompts(cfg, n_new):
    """The serve phase's prompts, by id, and one round of them."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(16, cfg.max_seq_len - SERVE_NEW + 1, SERVE_REQUESTS)
    prompts = {f"s{i}": rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(lens)}
    return prompts, [{rid: (p, n_new) for rid, p in prompts.items()}]


def _block_bytes(cfg, kv_bytes: int) -> int:
    """Pool bytes of one block: K and V, every layer, 16 rows."""
    hd = cfg.d_model // cfg.n_heads
    return 2 * cfg.n_layers * SERVE_BLOCK * cfg.n_heads * hd * kv_bytes


def _replicas(dis) -> list:
    return [dis.prefill] + list(dis.decoders)


def _acct_problems(name, acct) -> list:
    """The problems of an engine's (or each replica's) block accounting
    at idle: every block free, none leaked, conserved."""
    per = [v for v in acct.values() if isinstance(v, dict)] or [acct]
    if not acct["conserved"] or acct["leaked_refs"] or any(
            v["free"] != v["usable"] or v["leaked_refs"] for v in per):
        return [f"{name}: block accounting at idle: {acct}"]
    return []


def phase_disagg_serve(state):
    """``DisaggregatedEngine`` (1 prefill, 2 decode replicas, the serve
    pool each, ``wire=True``) at ``transformer_big`` in bf16 against the
    monolithic engine on the serve phase's prompts: migrations, bytes,
    migration ms, tokens/s; the flash forward only on the prefill
    replica, 12 a prefill; the live goodput ledger; the streams under
    ``prefix_serve``'s rule."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.migrate import (
        DisaggregatedEngine)
    from distributed_tensorflow_tpu_torch.telemetry import goodput

    cfg = TransformerConfig.transformer_big()           # bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    kw = dict(device="cuda", block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS,
              num_blocks=SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1)
    prompts, rounds = _serve_prompts(cfg, SERVE_NEW)
    warm = [prompts["s0"][:16], prompts["s1"][:40]]
    runs = {}
    for name in ("mono", "disagg"):
        eng = (InferenceEngine(cfg, params, **kw) if name == "mono" else
               DisaggregatedEngine(cfg, params, num_decode=DISAGG_DECODE,
                                   wire=True, **kw))
        eng.generate(warm, max_new_tokens=2)               # warm-up
        engines = [eng] if name == "mono" else _replicas(eng)
        pre, logits, decode_launches = [], {}, {}
        parts = {"export": [], "adopt": []}
        for e in engines:
            _record(e, pre, logits)
        if name == "disagg":
            eng.migrations.clear()
            # each migration's export (gather, device to host) and adopt
            # (host to device, scatter, synchronised) on the host clock;
            # the rest of its time is the wire format's pack and unpack
            for e in engines:
                def timed_export(seq, reason="migrate",
                                 export=e.export_sequence):
                    t0 = time.perf_counter()
                    payload = export(seq, reason=reason)
                    parts["export"].append((time.perf_counter() - t0) * 1e3)
                    return payload

                def timed_adopt(payload, adopt=e.adopt_sequence, **kw):
                    t0 = time.perf_counter()
                    seq = adopt(payload, **kw)
                    torch.cuda.synchronize()
                    parts["adopt"].append((time.perf_counter() - t0) * 1e3)
                    return seq
                e.export_sequence, e.adopt_sequence = timed_export, \
                    timed_adopt
            for d in eng.decoders:
                step = d.step

                def counted(step=step):
                    before = launch_counts()
                    out = step()
                    after = launch_counts()
                    for k in after:
                        decode_launches[k] = (decode_launches.get(k, 0)
                                              + after[k] - before[k])
                    return out
                d.step = counted
        prefills0 = [e.prefills for e in engines]
        ledger = goodput.GoodputLedger(register=False)
        prev = goodput.activate(ledger)
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        out = _serve_rounds(eng, rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        goodput.activate(prev)
        runs[name] = {"out": out, "wall": wall, "pre": pre,
                      "logits": logits, "counts": launch_counts(),
                      "prefills": [e.prefills - p0 for e, p0 in
                                   zip(engines, prefills0)],
                      "decode_launches": decode_launches,
                      "ledger": ledger, "acct": eng.block_accounting(),
                      "parts": parts,
                      "stats": eng.stats(),
                      "migrations": list(getattr(eng, "migrations", []))}
        del eng, engines
        torch.cuda.empty_cache()
    mono, dis = runs["mono"], runs["disagg"]
    per = cfg.n_layers
    block_bytes = _block_bytes(cfg, 2)
    migs = dis["migrations"]
    tokens = sum(len(s) for s in dis["out"].values())
    snap = dis["ledger"].snapshot()
    problems = []
    if dis["prefills"] != [SERVE_REQUESTS] + [0] * DISAGG_DECODE:
        problems.append(f"prefills by replica {dis['prefills']}")
    if dis["counts"] != expected_counts({"flash_fwd_tc": per},
                                        SERVE_REQUESTS) or any(
            p["launches"] != {"flash_fwd_tc": per} for p in dis["pre"]):
        problems.append(f"launches {dis['counts']}, expected {per} "
                        f"flash_fwd_tc a prefill")
    if any(dis["decode_launches"].values()):
        problems.append(f"a kernel ran on a decode replica: "
                        f"{dis['decode_launches']}")
    if len(migs) != SERVE_REQUESTS or any(
            m["kind"] != "prefill" or m["bytes"] != m["blocks"] * block_bytes
            for m in migs):
        problems.append(f"migrations {migs}")
    problems += _acct_problems("disagg", dis["acct"])
    problems += _acct_problems("mono", mono["acct"])
    if dis["ledger"]._fresh != tokens or dis["ledger"]._replayed or \
            not snap["badput_s"]["kv_migrate"] > 0:
        problems.append(f"goodput ledger: fresh {dis['ledger']._fresh} "
                        f"of {tokens} tokens, {snap}")
    if any(len(s) != SERVE_NEW or not all(0 <= t < cfg.vocab_size
                                          for t in s)
           for s in dis["out"].values()) or len(dis["out"]) != \
            SERVE_REQUESTS:
        problems.append("incomplete or out-of-range streams")
    err = _path_err(dis["logits"], mono["logits"], dis["out"], mono["out"],
                    prompts)
    div = _first_divergences(dis["out"], mono["out"], prompts,
                             mono["logits"], err)
    if any(d["fault"] for d in div):
        problems.append(f"streams part where the margin exceeds twice the "
                        f"logit error {err}: {div}")
    f32_errs = _f32_recompute_errs(cfg, params, prompts, mono["out"], {
        "mono": (mono["out"], mono["logits"]),
        "disagg": (dis["out"], dis["logits"])})
    del params
    problems += _hold_path_err(f32_errs, "disagg", "mono")
    if problems:
        raise AssertionError("; ".join(problems))
    ms = sorted(m["ms"] for m in migs)
    state["disagg_launches"] = dis["counts"]
    state["flash_fwd_tc"]["disagg"] = {
        "launches": dis["counts"]["flash_fwd_tc"],
        "prefills": SERVE_REQUESTS,
        "decode_replica_launches": sum(dis["decode_launches"].values())}
    blocks = sum(m["blocks"] for m in migs)
    return {"config": "transformer_big", "dtype": "bfloat16",
            "replicas": {"prefill": 1, "decode": DISAGG_DECODE},
            "num_blocks_each": kw["num_blocks"],
            "prompt_lens": [len(p) for p in prompts.values()],
            "new_tokens": SERVE_NEW,
            "migrations": len(migs), "migrated_blocks": blocks,
            "migrated_bytes": sum(m["bytes"] for m in migs),
            "block_bytes": block_bytes,
            "migrate_ms": [[m["blocks"], m["ms"]] for m in migs],
            "migrate_parts_ms": {
                "export": dis["parts"]["export"],
                "adopt": dis["parts"]["adopt"],
                "pack_unpack": [m["ms"] - x - a for m, x, a in zip(
                    migs, dis["parts"]["export"], dis["parts"]["adopt"])]},
            "migrate_ms_p50": dis["stats"]["migrate_p50_ms"],
            "migrate_ms_p99": dis["stats"]["migrate_p99_ms"],
            "migrate_ms_max": ms[-1],
            "migrate_gb_per_s": (sum(m["bytes"] for m in migs) / 1e6
                                 / sum(ms)),
            "tokens": tokens,
            "tokens_per_s": tokens / dis["wall"], "wall_s": dis["wall"],
            "mono_tokens_per_s": sum(len(s) for s in mono["out"].values())
            / mono["wall"], "mono_wall_s": mono["wall"],
            "prefill_ms": [[p["len"], p["ms"]] for p in dis["pre"]],
            "mono_prefill_ms": [[p["len"], p["ms"]] for p in mono["pre"]],
            "prefill_ms_mean": float(np.mean([p["ms"] for p in dis["pre"]])),
            "mono_prefill_ms_mean": float(np.mean(
                [p["ms"] for p in mono["pre"]])),
            "launches": dis["counts"],
            "decode_replica_launches": dis["decode_launches"],
            "goodput": {"fresh_tokens": dis["ledger"]._fresh,
                        "replayed_tokens": dis["ledger"]._replayed,
                        "serve_s": dis["ledger"]._serve_s, **snap},
            "logit_err": err, "f32_recompute_err": f32_errs,
            "err_ratio_max": BF16_PATH_ERR_RATIO,
            "streams_equal": sum(dis["out"][r] == mono["out"][r]
                                 for r in prompts),
            "streams": len(prompts), "divergences": div,
            "block_accounting": dis["acct"]}


def _check_wire(payload) -> int:
    """``payload`` through ``pack``/``unpack`` and a ``FileKV``
    publish/fetch (in a temporary directory): both must give back the
    blob bit for bit. Returns the blob's length."""
    import tempfile
    import torch
    from distributed_tensorflow_tpu_torch.serving.migrate import (
        FileKV, fetch_payload, pack_payload, publish_payload,
        unpack_payload)
    blob = pack_payload(payload)
    back = unpack_payload(blob)
    with tempfile.TemporaryDirectory() as tmp:
        agent = FileKV(tmp)
        publish_payload(agent, "mig", payload)
        fetched = fetch_payload(agent, "mig", timeout_s=10.0)
    for got in (back, fetched):
        same = pack_payload(got) == blob and all(
            torch.equal(got.arrays[n].view(torch.uint8).reshape(-1),
                        a.contiguous().view(torch.uint8).reshape(-1))
            for n, a in payload.arrays.items())
        if not same:
            raise AssertionError(f"payload {payload.request_id} changed on "
                                 f"the wire")
    return len(blob)


def phase_disagg_parity(state):
    """f32, TF32 off, full ``transformer_big``: ``DisaggregatedEngine``
    streams equal to the monolithic engine's on the serve prompts —
    plainly, under decode pools small enough to force a rescue and a
    replay preemption, and with ``kv_dtype="int8"`` — every payload
    bit-exact through ``pack``/``unpack`` and a ``FileKV`` directory."""
    import torch
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.migrate import (
        DisaggregatedEngine)

    cfg, params = _f32_big(0)
    prompts, rounds = _serve_prompts(cfg, SERVE_NEW)
    full = SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1
    base = dict(device="cuda", block_size=SERVE_BLOCK,
                max_slots=SERVE_SLOTS)
    cases = {"plain": ({}, full), "pressure": ({}, DISAGG_PRESSURE_BLOCKS),
             "int8": ({"kv_dtype": "int8"}, full)}
    out, problems, want, launches = {}, [], {}, {}
    for name, (extra, blocks) in cases.items():
        key = extra.get("kv_dtype", "f32")
        if key not in want:
            want[key] = _serve_rounds(InferenceEngine(
                cfg, params, num_blocks=full, **base, **extra), rounds)
            torch.cuda.empty_cache()
        dis = DisaggregatedEngine(cfg, params, num_decode=DISAGG_DECODE,
                                  wire=True, num_blocks=blocks, **base,
                                  **extra)
        wire = []
        for e in _replicas(dis):
            export = e.export_sequence

            def checked(seq, reason="migrate", export=export):
                p = export(seq, reason=reason)
                wire.append(_check_wire(p))
                return p
            e.export_sequence = checked
        torch.cuda.synchronize()
        zero_launch_counts()
        got = _serve_rounds(dis, rounds)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: launches.get(k, 0) + n for k, n in counts.items()}
        st = dis.stats()
        prefills = sum(e.prefills for e in _replicas(dis))
        preempted = sum(r["preemptions"] for r in st["decode"])
        acct = dis.block_accounting()
        del dis
        torch.cuda.empty_cache()
        if got != want[key]:
            problems.append(f"{name}: streams differ from the "
                            f"monolithic engine's: "
                            f"{[r for r in got if got[r] != want[key][r]]}")
        if counts != expected_counts({"flash_fwd": cfg.n_layers},
                                     prefills):
            problems.append(f"{name}: launches {counts}")
        if len(wire) != st["migrations"] or not wire:
            problems.append(f"{name}: {len(wire)} payloads checked of "
                            f"{st['migrations']}")
        if name == "pressure" and not (st["migrations_rescue"] >= 1
                                       and preempted >= 1):
            problems.append(f"pressure: {st['migrations_rescue']} "
                            f"rescues, {preempted} replay preemptions")
        problems += _acct_problems(name, acct)
        out[name] = {"num_blocks_each": blocks,
                     "kv_dtype": st["prefill"]["kv_dtype"],
                     "migrations": st["migrations"],
                     "rescues": st["migrations_rescue"],
                     "replay_preemptions": preempted,
                     "migrated_bytes": st["migrated_bytes"],
                     "payloads_checked": len(wire),
                     "blob_bytes": sum(wire), "prefills": prefills,
                     "launches": counts["flash_fwd"],
                     "streams_equal_mono": got == want[key]}
    del params
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    state["disagg_parity_launches"] = launches
    return {"config": "transformer_big", "dtype": "float32",
            "layers": cfg.n_layers, "depth_cut": False,
            "prompt_lens": [len(p) for p in prompts.values()],
            "new_tokens": SERVE_NEW, **out}


def phase_swap_chaos(state):
    """f32, TF32 off, full ``transformer_big``. **swap**: a prefix-caching
    engine flipped from weights A to B by ``install_version`` after
    :data:`SWAP_AFTER_STEPS` steps; every completion on B's version and
    equal to a fresh B engine's, ``requeued`` the sequences running at
    the flip, the cache fenced. **chaos**: ``serve.step`` raising with
    probability :data:`CHAOS_P` on the ``DisaggregatedEngine`` under
    ``run_until_idle(retry_faults=True)``: streams equal to the
    fault-free run's, no request lost, firings counted."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.models.transformer import (
        init_params)
    from distributed_tensorflow_tpu_torch.resilience import faults
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.migrate import (
        DisaggregatedEngine)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request

    cfg, pa = _f32_big(0)
    pb = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                     device="cuda")
    rng = np.random.default_rng(7)
    shared = _prefix_prompts(cfg, rng, PREFIX_PARITY_LEN,
                             PREFIX_PARITY_SUFFIX, PARITY_REQUESTS)
    # the prompts twice: the second copies hit the first's cached blocks
    swap_rounds = [{f"{c}{i}": (p, PARITY_NEW) for c in "pq"
                    for i, p in enumerate(shared)}]
    kw = dict(device="cuda", num_blocks=129, block_size=SERVE_BLOCK,
              max_slots=PARITY_REQUESTS, prefix_caching=True)
    want = _serve_rounds(InferenceEngine(cfg, pb, **kw), swap_rounds)
    torch.cuda.empty_cache()
    eng = InferenceEngine(cfg, pa, snapshot_step=1, **kw)
    pc = eng.scheduler.prefix_cache
    log = {"swapped": False, "post_registered": set(), "post_hits": [],
           "pre_registered": 0}
    register, match = pc.register, pc.match

    def logged_register(tokens, blocks):
        register(tokens, blocks)
        if log["swapped"]:
            log["post_registered"].update(int(b) for b in blocks)
        else:
            log["pre_registered"] += 1

    def logged_match(tokens):
        n, blocks = match(tokens)
        if log["swapped"] and n:
            log["post_hits"].append((n, [int(b) for b in blocks]))
        return n, blocks

    pc.register, pc.match = logged_register, logged_match
    for rid, (p, new) in swap_rounds[0].items():
        eng.submit(Request(id=rid, tokens=tuple(p), max_new_tokens=new))
    torch.cuda.synchronize()
    zero_launch_counts()
    got, info, steps, running = {}, None, 0, None
    while not eng.scheduler.idle:
        for rec in eng.step():
            got[rec["id"]] = rec
        steps += 1
        if steps == SWAP_AFTER_STEPS:
            running = len(eng.scheduler.running)
            info = eng.install_version(pb, step=2)
            log["swapped"] = True
    torch.cuda.synchronize()
    swap_counts = launch_counts()
    swap_prefills = eng.prefills
    cache = pc.stats()
    acct = eng.block_accounting()
    del eng, pa
    torch.cuda.empty_cache()
    problems = []
    if {r["model_version"].split("@")[0] for r in got.values()} != {"2"}:
        problems.append(f"completions off B's version: "
                        f"{[r['model_version'] for r in got.values()]}")
    if info is None or not info["requeued"] == running > 0 or \
            not info["cache_dropped"] > 0:
        problems.append(f"swap {info}, {running} running at the flip")
    streams = {rid: r["tokens"] for rid, r in got.items()}
    if streams != want:
        problems.append(f"streams differ from a fresh B engine's: "
                        f"{[r for r in want if streams.get(r) != want[r]]}")
    stale = [h for h in log["post_hits"]
             if not set(h[1]) <= log["post_registered"]]
    if stale or not log["post_hits"] or cache["fences"] != 1:
        problems.append(f"post-swap hits {log['post_hits']} on blocks not "
                        f"registered after the flip; cache {cache}")
    if swap_counts != expected_counts({"flash_fwd": cfg.n_layers},
                                      swap_prefills):
        problems.append(f"swap launches {swap_counts}")
    if not acct["conserved"] or acct["leaked_refs"]:
        problems.append(f"swap block accounting {acct}")

    # chaos: the serve prompts on the disaggregated engine
    prompts, rounds = _serve_prompts(cfg, PARITY_NEW)
    dkw = dict(device="cuda", block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS,
               num_blocks=SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1,
               num_decode=DISAGG_DECODE, wire=True)
    clean = _serve_rounds(DisaggregatedEngine(cfg, pb, **dkw), rounds)
    torch.cuda.empty_cache()
    dis = DisaggregatedEngine(cfg, pb, **dkw)
    del pb
    schedule = faults.FaultSchedule(seed=0, rules=(faults.FaultRule(
        site="serve.step", probability=CHAOS_P),))
    fired = telemetry.get_registry().counter("resilience/faults_fired")
    fired0 = fired.value
    for rid, (p, new) in rounds[0].items():
        dis.submit(Request(id=rid, tokens=tuple(p), max_new_tokens=new))
    torch.cuda.synchronize()
    zero_launch_counts()
    with faults.inject(schedule):
        done = dis.run_until_idle(retry_faults=True)
        events = faults.events()
    torch.cuda.synchronize()
    chaos_counts = launch_counts()
    chaos_prefills = sum(e.prefills for e in _replicas(dis))
    n_fired = fired.value - fired0
    dacct = dis.block_accounting()
    del dis
    torch.cuda.empty_cache()
    chaos_streams = {rid: r["tokens"] for rid, r in done.items()}
    if chaos_streams != clean:
        problems.append(f"chaos streams differ from the fault-free run's "
                        f"or lost a request: {sorted(chaos_streams)}")
    if not n_fired > 0 or n_fired != len(events):
        problems.append(f"{n_fired} firings counted, {len(events)} logged")
    if chaos_counts != expected_counts({"flash_fwd": cfg.n_layers},
                                       chaos_prefills):
        problems.append(f"chaos launches {chaos_counts}")
    problems += _acct_problems("chaos", dacct)
    if problems:
        raise AssertionError("; ".join(problems))
    state["swap_launches"] = swap_counts
    state["chaos_launches"] = chaos_counts
    return {"config": "transformer_big", "dtype": "float32",
            "swap": {"prompts": len(swap_rounds[0]),
                     "prefix_len": PREFIX_PARITY_LEN,
                     "after_steps": SWAP_AFTER_STEPS,
                     "running_at_flip": running, **info,
                     "completions_on_b": len(got),
                     "streams_equal_fresh_b": True,
                     "pre_swap_registrations": log["pre_registered"],
                     "post_swap_hits": len(log["post_hits"]),
                     "prefix_cache": cache, "prefills": swap_prefills,
                     "launches": swap_counts["flash_fwd"]},
            "chaos": {"p": CHAOS_P, "seed": 0, "requests": len(done),
                      "fired": n_fired, "events": len(events),
                      "fired_tags": [e[1] for e in events],
                      "streams_equal_fault_free": True,
                      "prefills": chaos_prefills,
                      "launches": chaos_counts["flash_fwd"]}}


def step_flops(cfg, batch: int, n_params: int) -> float:
    """Model FLOPs per train step, the formula of the repository's
    headline benchmark (``bench.py`` ``step_flops``): 6 N per token plus
    the attention term, halved under causal masking."""
    tokens_per_step = batch * cfg.max_seq_len
    causal_factor = 0.5 if cfg.causal else 1.0
    attn = (cfg.n_layers * 12 * batch * cfg.max_seq_len ** 2
            * cfg.d_model * causal_factor)
    return 6 * n_params * tokens_per_step + attn


def _train_setup(cfg, seed, batch):
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM, init_params, make_optimizer, make_train_step)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    model = TransformerLM(cfg, params, device="cuda")
    del params
    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(cfg, model, opt)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, cfg.max_seq_len))).to("cuda")
    return model, opt, step, {"tokens": tokens}


def _headline_config(**kw):
    """The ``bench.py`` headline row (``bench.py:2657-2668``) in the port:
    batch 8 x 1024, no remat, unrolled layers, kernel cross-entropy, bf16
    AdamW first moment."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.transformer_big(**{
        "max_seq_len": 1024, "remat": False, "scan_layers": False,
        "loss_impl": "kernel", "adam_mu_dtype": torch.bfloat16, **kw})


def _timed_train(cfg, per_step: dict, forbid_plain_step: bool,
                 bert: bool = False):
    """One warm-up step of ``cfg``'s train step, then TRAIN_STEPS timed
    with CUDA events with the launch counters set to 0 before and read
    after; checks the launches, the first loss and that the loss falls.
    With ``forbid_plain_step`` the optimizer's own ``step`` raises if it
    is ever reached. ``bert``: BERT's MLM step (:func:`_bert_setup`,
    batch BERT_BATCH) in place of ``transformer_big``'s; the warm-up
    step's gradients (at the seeded init, on step 0's masks) are
    returned too, else None."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    batch_size = BERT_BATCH if bert else TRAIN_BATCH
    model, opt, step, batch = (_bert_setup if bert else _train_setup)(
        cfg, 0, batch_size)
    if forbid_plain_step:
        def plain_step(*_a, **_k):
            raise AssertionError("the plain AdamW.step was reached")
        opt.step = plain_step
    n_params = sum(p.numel() for p in model.parameters())
    st = {"model": model, "optimizer": opt, "step": 0}
    t0 = time.perf_counter()
    st, metrics = step(st, batch)                       # warm-up
    first_loss = metrics["loss"].item()
    warmup_s = time.perf_counter() - t0
    first_grads = (dict(_leaves(model.stacked_params(
        lambda p: p.grad.clone()))) if bert else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    step_ms, host_ms, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        st, metrics = step(st, batch)
        e1.record()
        e1.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(e0.elapsed_time(e1))
        losses.append(metrics["loss"].item())
    counts = launch_counts()

    expected = expected_counts(per_step, TRAIN_STEPS)
    problems = []
    if counts != expected:
        problems.append(f"launches {counts} != {expected}")
    if any(counts[k] == 0 for k in per_step):
        problems.append(f"a kernel of the path never launched: {counts}")
    if not math.isfinite(first_loss) or abs(
            first_loss - math.log(cfg.vocab_size)) > 1.0:
        problems.append(f"first loss {first_loss} not within 1.0 of "
                        f"ln {cfg.vocab_size}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        problems.append(f"losses do not fall: {losses}")
    if st["step"] != TRAIN_STEPS + 1:
        problems.append(f"step count {st['step']}")
    if problems:
        raise AssertionError("; ".join(problems))
    mean_s = float(np.mean(step_ms)) / 1e3
    median_s = float(np.median(step_ms)) / 1e3
    tokens = batch_size * cfg.max_seq_len
    flops = step_flops(cfg, batch_size, n_params)
    out = {
        "note": "smoke run, not a benchmark",
        "config": "bert_base" if bert else "transformer_big",
        "dtype": "bfloat16", "batch": batch_size,
        "seq_len": cfg.max_seq_len, "loss_impl": cfg.loss_impl,
        "adam_mu_dtype": str(cfg.adam_mu_dtype or torch.float32
                             ).replace("torch.", ""),
        "fused_optimizer": cfg.fused_optimizer,
        "n_params": n_params, "warmup_step_s": warmup_s,
        "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
        "step_ms_median": median_s * 1e3,
        "host_step_ms": host_ms, "tokens_per_s": tokens / mean_s,
        "tokens_per_s_median": tokens / median_s,
        "seqs_per_s": batch_size / mean_s,
        "seqs_per_s_median": batch_size / median_s,
        "step_flops": flops,
        "mfu": flops / mean_s / PEAK_FLOPS["bfloat16"],
        "mfu_median": flops / median_s / PEAK_FLOPS["bfloat16"],
        "mfu_peak": "989 TFLOP/s bf16 dense",
        "first_loss": first_loss, "ln_vocab": math.log(cfg.vocab_size),
        "losses": losses, "launches": counts,
        "launches_per_step": per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return counts, out, first_grads


def phase_train(state):
    counts, out, _ = _timed_train(_headline_config(), TRAIN_LAUNCHES,
                                  False)
    state["train_launches"] = counts
    state["train_step_ms_median"] = out["step_ms_median"]
    return out


def phase_train_fused(state):
    import torch
    torch.cuda.empty_cache()
    counts, out, _ = _timed_train(_headline_config(fused_optimizer=True),
                                  FUSED_LAUNCHES, True)
    state["train_fused_launches"] = counts
    out["train_step_ms_median"] = state["train_step_ms_median"]
    return out


def _grads_of_one_step(cfg, seed: int, batch: int):
    """Loss and every gradient leaf of one step of ``cfg`` from the seeded
    weights and tokens of ``_train_setup``, and the launches it made."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_loss_fn)
    model, _, _, data = _train_setup(cfg, seed, batch)
    zero_launch_counts()
    loss = make_loss_fn(cfg, model)(data["tokens"])
    loss.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    grads = dict(_leaves(model.stacked_params(lambda p: p.grad.clone())))
    return loss.item(), grads, counts


def phase_train_options(state):
    """f32, TF32 off, full width, 2 layers, batch 2 x 256, one step from
    the same weights: ``remat=True`` with each policy against
    ``remat=False`` (flash_fwd launched twice a layer under "nothing" and
    "dots", once under "attn" and "dots_attn"), and the scan-chunked loss
    (8 chunks, both chunk policies) against full logits: loss and every
    gradient. Then the bf16 kernel loss, ``tiny()`` and the remat
    policies timed at the headline shape."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(n_layers=2, max_seq_len=256, dtype=torch.float32,
                remat=False, scan_layers=False)
    pairs = {
        "remat_nothing": (dict(loss_impl="kernel", remat=True,
                               remat_policy="nothing"),
                          dict(loss_impl="kernel")),
        "remat_dots": (dict(loss_impl="kernel", remat=True,
                            remat_policy="dots"), dict(loss_impl="kernel")),
        "remat_attn": (dict(loss_impl="kernel", remat=True,
                            remat_policy="attn"), dict(loss_impl="kernel")),
        "remat_dots_attn": (dict(loss_impl="kernel", remat=True,
                                 remat_policy="dots_attn"),
                            dict(loss_impl="kernel")),
        "loss_chunks8_recompute": (dict(loss_chunks=8), dict()),
        "loss_chunks8_save": (dict(loss_chunks=8,
                                   loss_chunk_policy="save"), dict()),
    }
    runs, results, failures = {}, {}, []
    for name, (kw, ref_kw) in pairs.items():
        for key in (tuple(sorted(kw.items())), tuple(sorted(ref_kw.items()))):
            if key not in runs:
                cfg = TransformerConfig.transformer_big(**{**base,
                                                           **dict(key)})
                runs[key] = _grads_of_one_step(cfg, 3, 2)
                torch.cuda.empty_cache()
        (gl, gg, gc), (rl, rg, rc) = (runs[tuple(sorted(kw.items()))],
                                      runs[tuple(sorted(ref_kw.items()))])
        grad_err = max(rel_err(g, rg[n]) for n, g in gg.items())
        fwd = {"got": gc["flash_fwd"], "reference": rc["flash_fwd"]}
        # the forward kernel runs again in the recompute unless the
        # policy saves the registered flash op's outputs
        want_fwd = (2 if name in ("remat_nothing", "remat_dots") else 1
                    ) * base["n_layers"]
        ok = (abs(gl - rl) <= TRAIN_LOSS_TOL
              and grad_err <= GRAD_TOL["float32"] and len(gg) == 10
              and fwd["got"] == want_fwd
              and fwd["reference"] == base["n_layers"])
        results[name] = {"loss": gl, "loss_reference": rl,
                         "abs_loss_err": abs(gl - rl),
                         "max_grad_rel_err": grad_err,
                         "flash_fwd_launches": fwd, "ok": ok}
        if not ok:
            failures.append(name)

    # bf16: the kernel loss (the tensor-core CE kernels inside autograd, on
    # real hidden states) against full logits from the same weights; the
    # f32 full-logits step above is the yardstick of bf16's own noise
    bf16 = dict(base, dtype=torch.bfloat16)
    kl, kg, kc = _grads_of_one_step(TransformerConfig.transformer_big(
        **bf16, loss_impl="kernel"), 3, 2)
    rl, rg, _ = _grads_of_one_step(TransformerConfig.transformer_big(**bf16),
                                   3, 2)
    fl, fg, _ = runs[()]
    leaves = {}
    for name, g in kg.items():
        noise = rel_err(rg[name], fg[name])
        leaves[name] = {"err": rel_err(g, rg[name]), "noise": noise,
                        "tol": BF16_TRAIN_GRAD_TOL + 2 * noise}
    ce_calls = {k: kc[k] for k in ("fused_ce_fwd_tc", "fused_ce_bwd_tc",
                                   "fused_ce_fwd", "fused_ce_bwd")}
    ok = (abs(kl - rl) <= BF16_TRAIN_LOSS_TOL and len(kg) == 10
          and all(x["err"] <= x["tol"] for x in leaves.values())
          and ce_calls == {"fused_ce_fwd_tc": 1, "fused_ce_bwd_tc": 1,
                           "fused_ce_fwd": 0, "fused_ce_bwd": 0})
    results["bf16_kernel_loss"] = {
        "loss": kl, "loss_reference": rl, "loss_f32": fl,
        "abs_loss_err": abs(kl - rl), "loss_tol": BF16_TRAIN_LOSS_TOL,
        "max_grad_rel_err": max(x["err"] for x in leaves.values()),
        "leaves": leaves, "ce_launches": ce_calls, "ok": ok}
    if not ok:
        failures.append("bf16_kernel_loss")
    results["tiny_reference"] = tiny = _check_tiny()
    if not tiny["ok"]:
        failures.append("tiny_reference")
    results["remat_headline"] = remat = _time_remat_policies()
    if not remat["ok"]:
        failures.append("remat_headline")
    out = {"config": "transformer_big, 2 layers", "dtype": "float32",
           "batch": 2, "seq_len": 256, "loss_tol": TRAIN_LOSS_TOL,
           "grad_tol": GRAD_TOL["float32"], **results}
    if failures:
        raise AssertionError(f"train options: {failures}: {json.dumps(out)}")
    return out


def _time_remat_policies() -> dict:
    """The headline step (``_headline_config``) with ``remat=True`` under
    each of REMAT_TIMED: one warm-up step, then REMAT_TIMED_STEPS timed
    with CUDA events; the peak memory over them and the flash forward's
    launches a step (twice a layer under "nothing", once under "attn"
    and "dots_attn")."""
    import numpy as np
    import torch
    out, ok = {}, True
    for policy in REMAT_TIMED:
        torch.cuda.empty_cache()
        cfg = _headline_config(remat=True, remat_policy=policy)
        model, opt, step, batch = _train_setup(cfg, 0, TRAIN_BATCH)
        st = {"model": model, "optimizer": opt, "step": 0}
        st, _ = step(st, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        ms = []
        for _ in range(REMAT_TIMED_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, metrics = step(st, batch)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        fwd = launch_counts()["flash_fwd_tc"] / REMAT_TIMED_STEPS
        want = (2 if policy == "nothing" else 1) * cfg.n_layers
        ok = ok and fwd == want and math.isfinite(metrics["loss"].item())
        out[policy] = {"step_ms": ms, "step_ms_median": float(np.median(ms)),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "flash_fwd_tc_per_step": fwd,
                       "flash_fwd_tc_per_step_expected": want}
        del model, opt, step, st
    torch.cuda.empty_cache()
    return {"config": "transformer_big, batch 8 x 1024, bf16, kernel CE",
            **out, "ok": ok}


def _check_tiny() -> dict:
    """``TransformerConfig.tiny()`` on the card: head dim 16, which no
    attention kernel takes, so it runs ``mha_reference`` as JAX's
    ``tiny()`` does. One train step (the kernel loss: the f32 CE kernels)
    and two greedy requests through ``InferenceEngine``; no attention
    kernel may launch, the loss must be finite and the streams
    complete."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    cfg = TransformerConfig.tiny(loss_impl="kernel")
    model, opt, step, batch = _train_setup(cfg, 4, 2)
    torch.cuda.synchronize()
    zero_launch_counts()
    _, metrics = step({"model": model, "optimizer": opt, "step": 0}, batch)
    loss = metrics["loss"].item()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         device="cuda")
    engine = InferenceEngine(cfg, params, device="cuda", num_blocks=32,
                             block_size=SERVE_BLOCK, max_slots=2)
    outs = engine.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10]],
                           max_new_tokens=4)
    torch.cuda.synchronize()
    counts = {k: n for k, n in launch_counts().items() if n}
    ok = (cfg.attention_impl == "reference" and math.isfinite(loss)
          and counts == {"fused_ce_fwd": 1, "fused_ce_bwd": 1}
          and [len(o) for o in outs] == [4, 4]
          and all(0 <= x < cfg.vocab_size for o in outs for x in o))
    return {"head_dim": cfg.head_dim, "attention_impl": cfg.attention_impl,
            "loss": loss, "streams": outs, "launches": counts, "ok": ok}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _log10_hist(x, first: int, last: int) -> dict:
    """Counts of ``x`` (>= 0) by decade, ``"<1e{first}"`` up to
    ``">=1e{last}"``."""
    import torch
    edges = [10.0 ** e for e in range(first, last + 1)]
    out, lo = {}, None
    for hi in edges + [None]:
        sel = torch.ones_like(x, dtype=torch.bool)
        if lo is not None:
            sel &= x >= lo
        if hi is not None:
            sel &= x < hi
        key = f"<{hi:.0e}" if lo is None else (
            f">={lo:.0e}" if hi is None else f"{lo:.0e}-{hi:.0e}")
        out[key] = int(sel.sum().item())
        lo = hi
    return out


def phase_train_parity(state):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(n_layers=2, max_seq_len=256, dtype=torch.float32,
                remat=False, scan_layers=False)
    runs = {}
    for name, kw in (("kernel", dict(loss_impl="kernel")),
                     ("reference", dict(attention_impl="reference",
                                        loss_impl="scan", loss_chunks=0))):
        cfg = TransformerConfig.transformer_big(**base, **kw)
        model, opt, step, batch = _train_setup(cfg, 2, 2)
        st = {"model": model, "optimizer": opt, "step": 0}
        losses, grads = [], []
        torch.cuda.synchronize()
        zero_launch_counts()
        for _ in range(TRAIN_PARITY_STEPS):
            st, metrics = step(st, batch)
            losses.append(metrics["loss"].item())
            grads.append(dict(_leaves(model.stacked_params(
                lambda p: p.grad.clone()))))
        if name == "kernel":   # f32: the CUDA-core CE kernels
            state["train_parity_launches"] = launch_counts()
        runs[name] = (losses, grads, dict(_leaves(model.stacked_params(
            lambda p: p.detach().clone()))))
        del model, opt, step, st
        torch.cuda.empty_cache()

    (kl, kg, kp), (rl, rg, rp) = runs["kernel"], runs["reference"]
    loss_err = max(abs(a - b) for a, b in zip(kl, rl))
    grad_err = {n: rel_err(g, rg[0][n]) for n, g in kg[0].items()}
    worst_grad = max(grad_err.values())
    n_params = over = exempt = 0
    held_err, beyond_gap, flips, grad_noise = 0.0, [], 0, {}
    for n, p in kp.items():
        diff = (p - rp[n]).abs()
        # each element's largest disagreement between the runs' gradients
        # over the steps, relative to its reference |g|; above GRAD_AGREE
        # the reference |g| lies below the element's noise floor
        gap = torch.stack([(kg[i][n] - rg[i][n]).abs() / rg[i][n].abs()
                           for i in range(TRAIN_PARITY_STEPS)]
                          ).nan_to_num(0.0).amax(0)
        free = gap > GRAD_AGREE
        beyond = diff > TRAIN_PARAM_TOL
        n_params += p.numel()
        over += int(beyond.sum().item())
        exempt += int(free.sum().item())
        if (~free).any():
            held_err = max(held_err, diff[~free].max().item())
        beyond_gap.append(gap[beyond])
        flips += int((torch.sign(kg[0][n][beyond])
                      != torch.sign(rg[0][n][beyond])).sum().item())
        grad_noise[n] = max(rel_err(kg[i][n], rg[i][n])
                            for i in range(TRAIN_PARITY_STEPS))
    beyond_gap = torch.cat(beyond_gap).clamp_max(1e30)
    param_err = {n: abs_err(p, rp[n]) for n, p in kp.items()}
    worst_param = max(param_err.values())
    out = {"config": "transformer_big, 2 layers", "dtype": "float32",
           "batch": 2, "seq_len": 256, "steps": TRAIN_PARITY_STEPS,
           "losses_kernel": kl, "losses_reference": rl,
           "max_abs_loss_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
           "grad_rel_err": grad_err, "max_grad_rel_err": worst_grad,
           "grad_tol": GRAD_TOL["float32"],
           "grad_rel_err_any_step": grad_noise,
           "param_err": param_err, "max_abs_param_err": worst_param,
           "param_tol": TRAIN_PARAM_TOL, "n_params": n_params,
           "grad_agree": GRAD_AGREE,
           "params_below_noise_floor": exempt,
           "max_abs_param_err_held": held_err,
           "params_off_by_more_than_tol": over,
           "param_frac_allowed": TRAIN_PARAM_FRAC,
           # the elements beyond TRAIN_PARAM_TOL: their largest relative
           # gradient disagreement over the steps, by decade, and how many
           # of their step-1 gradients differ in sign between the runs
           "beyond_tol_grad_gap": _log10_hist(beyond_gap, -7, 2),
           "beyond_tol_grad_gap_min": (beyond_gap.min().item()
                                       if beyond_gap.numel() else None),
           "beyond_tol_step1_sign_flips": flips}
    counts = state["train_parity_launches"]
    want = expected_counts(PARITY_LAUNCHES, TRAIN_PARITY_STEPS)
    out["launches"] = counts
    if (loss_err > TRAIN_LOSS_TOL or worst_grad > GRAD_TOL["float32"]
            or counts != want or held_err > TRAIN_PARAM_TOL
            or over > TRAIN_PARAM_FRAC * n_params or len(grad_err) != 10):
        raise AssertionError(f"train parity: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# data parallelism (models/transformer.py make_sharded_train_step)
# ---------------------------------------------------------------------------

def _count_collectives() -> dict:
    """Count every collective this process issues from here on, by name
    (wrapping the ``torch.distributed`` functions the port calls)."""
    import torch.distributed as dist
    counts: dict = {}
    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor", "broadcast"):
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)
        setattr(dist, name, counted)
    return counts


def _dp_step(cfg, variant: str, global_batch: int, world: int, **kw):
    """``(state, step)`` of one data-parallel variant over all ranks."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import transformer as tf
    mesh = topology.make_mesh({"dp": world}, device="cuda")
    if variant in ("bucketed", "none") and world == 1:
        # make_sharded_train_step takes the bucketed path above 1 device
        return tf._make_bucketed_dp_train_step(
            cfg, mesh, global_batch, sync=variant == "bucketed", **kw)
    extra = {"bucketed": {}, "none": {"grad_sync": "none"},
             "zero1": {"zero": 1}, "zero2": {"zero": 2}}[variant]
    return tf.make_sharded_train_step(cfg, mesh, global_batch, **extra, **kw)


def _checksum_agree(model) -> tuple:
    """This rank's parameter checksum (a float64 sum) and whether every
    rank's equals it (all-gathered)."""
    import torch
    import torch.distributed as dist
    total = torch.stack([p.detach().double().sum()
                         for p in model.parameters()]).sum()
    every = [torch.zeros_like(total) for _ in range(dist.get_world_size())]
    dist.all_gather(every, total)
    return total.item(), all(torch.equal(t, total) for t in every)


def _dp_train_rank(variants) -> dict:
    """One rank of ``dp_train``: each variant's warm-up and timed steps
    on this rank's card."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        zero_state_bytes)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    coll = _count_collectives()

    def state_bytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)
    cfg = _headline_config()
    global_batch = TRAIN_BATCH * world
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
    out = {"rank": rank, "world": world,
           "device": torch.cuda.get_device_name(), "variants": {}}
    for variant in variants:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what earlier variants left allocated (0 unless one leaked)
        mem_before = torch.cuda.memory_allocated() - tokens.numel() * 8
        state, step = _dp_step(cfg, variant, global_batch, world, seed=0)
        model, opt = state["model"], state["optimizer"]
        grad_bytes = []
        real_step = opt.step

        def measured_step(_real=real_step, _opt=opt, _model=model):
            # the gradients held when the update runs, by unique storage
            grads = {g.untyped_storage().data_ptr(): g.untyped_storage()
                     .nbytes() for g in
                     [p.grad for p in _model.parameters()]
                     + [p.grad for grp in _opt.param_groups
                        for p in grp["params"]] if g is not None}
            grad_bytes.append(sum(grads.values()))
            return _real()
        opt.step = measured_step
        state, m = step(state, {"tokens": tokens})          # warm-up
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        zero_launch_counts()
        coll.clear()
        step_ms = []
        for _ in range(DP_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, {"tokens": tokens})
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            losses.append(m["loss"].item())
        counts = launch_counts()
        issued = {k: v / DP_STEPS for k, v in coll.items()}
        n_params = sum(p.numel() for p in model.parameters())
        level = {"zero1": 1, "zero2": 2}.get(variant, 0)
        moments = [t for st in opt.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)]
        # parameters, ZeRO's parameter shards and the AdamW moments
        held = {t.untyped_storage().data_ptr(): t for t in
                [*model.parameters(),
                 *(p for grp in opt.param_groups for p in grp["params"]),
                 *moments]}
        plan = getattr(step, "plan", None)
        if plan is None:       # ZeRO: the partition's buckets
            part = step.partition
            plan = [{"leaves": len(b), "bytes": part.bucket_sizes[i] * 4,
                     "dtype": "float32"} for i, b in enumerate(part.buckets)]
        checksum, agree = _checksum_agree(model)
        mean_s = float(np.mean(step_ms)) / 1e3
        out["variants"][variant] = {
            "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
            "tokens_per_s": global_batch * cfg.max_seq_len / mean_s,
            "losses": losses, "n_buckets": len(plan),
            "bucket_bytes": [b["bytes"] for b in plan],
            "collectives_per_step": issued,
            "collectives_per_step_total": sum(issued.values()),
            "launches": counts,
            "param_bytes": state_bytes(model.parameters()),
            "moment_bytes": state_bytes(moments),
            "persistent_state_bytes": state_bytes(held.values()),
            "zero_state_bytes_no_grads": zero_state_bytes(
                n_params, world, level, slot_bytes=6, grad_bytes=0),
            "grad_bytes_at_update": grad_bytes[-1],
            "zero_state_bytes": zero_state_bytes(n_params, world, level,
                                                 slot_bytes=6),
            "n_params": n_params,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "mem_before_bytes": mem_before,
            "param_checksum": checksum, "ranks_agree": agree}
        if getattr(step, "partition", None) is not None:
            out["variants"][variant]["partition"] = (
                step.partition.summary())
        # every name that holds the variant's model or optimizer goes
        # before the next variant measures what is left allocated
        del state, step, model, opt, moments, held, m, measured_step, \
            real_step
        gc.collect()
    bootstrap.shutdown()
    return out


def phase_dp_train(state):
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(
        _dp_train_rank, world, args=(DP_VARIANTS,), device="cuda",
        timeout=900).return_values
    per_step = TRAIN_LAUNCHES
    problems = []
    for r in ranks:
        for variant, v in r["variants"].items():
            want = expected_counts(per_step, DP_STEPS)
            if v["launches"] != want:
                problems.append(f"rank {r['rank']} {variant}: launches "
                                f"{v['launches']} != {want}")
            if not all(math.isfinite(x) for x in v["losses"]) or \
                    not v["losses"][-1] < v["losses"][0]:
                problems.append(f"rank {r['rank']} {variant}: losses do "
                                f"not fall: {v['losses']}")
            if variant != "none" and not v["ranks_agree"]:
                problems.append(f"rank {r['rank']} {variant}: parameters "
                                f"differ between ranks")
    if problems:
        raise AssertionError("; ".join(problems))
    r0 = ranks[0]["variants"]
    state["dp_launches"] = {v: r0[v]["launches"] for v in r0}
    out = {"world": world, "config": "transformer_big (bench.py headline)",
           "batch_per_rank": TRAIN_BATCH, "seq_len": 1024,
           "steps": DP_STEPS, "launches_per_step": per_step,
           "ranks": ranks}
    if "none" in r0 and "bucketed" in r0:
        out["exposed_sync_ms"] = (r0["bucketed"]["step_ms_mean"]
                                  - r0["none"]["step_ms_mean"])
    return out


def _dp_parity_rank() -> dict:
    """One rank of ``dp_parity``: the bucketed, ZeRO-1 and ZeRO-2 steps
    against single-device ``make_train_step`` on the global batch."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = TransformerConfig.transformer_big(
        n_layers=2, max_seq_len=DP_PARITY_SEQ, dtype=torch.float32,
        remat=False, scan_layers=False, loss_impl="scan")
    global_batch = DP_PARITY_ROWS * world
    model, opt, step, _ = _train_setup(cfg, 0, global_batch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
    st = {"model": model, "optimizer": opt, "step": 0}
    want_losses, want_grads = [], []
    for _ in range(DP_PARITY_STEPS):
        st, m = step(st, {"tokens": tokens})
        want_losses.append(m["loss"].item())
        want_grads.append([p.grad.clone() for p in model.parameters()])
    want = [p.detach().clone() for p in model.parameters()]
    del model, opt, step, st
    out = {"rank": rank, "world": world, "variants": {}}
    runs = {}
    for variant in ("bucketed", "zero1", "zero2"):
        state, dstep = _dp_step(cfg, variant, global_batch, world, seed=0)
        model = state["model"]
        losses, grads = [], []
        for _ in range(DP_PARITY_STEPS):
            state, m = dstep(state, {"tokens": tokens})
            losses.append(m["loss"].item())
            if variant == "bucketed":      # ZeRO frees its gradients
                grads.append([p.grad.clone() for p in model.parameters()])
        got = [p.detach().clone() for p in model.parameters()]
        runs[variant] = (losses, got)
        res = {"losses": losses,
               "max_abs_loss_err": max(abs(a - b) for a, b in
                                       zip(losses, want_losses)),
               "max_abs_param_err": max((g - w).abs().max().item()
                                        for g, w in zip(got, want)),
               "params_equal": all(torch.equal(g, w)
                                   for g, w in zip(got, want)),
               "losses_equal": losses == want_losses}
        if grads:
            res["max_abs_grad_err"] = max(
                (g - w).abs().max().item() for gs, ws in zip(grads,
                                                             want_grads)
                for g, w in zip(gs, ws))
            res["grads_equal"] = all(
                torch.equal(g, w) for gs, ws in zip(grads, want_grads)
                for g, w in zip(gs, ws))
            res.update(_adam_param_rule(got, want, grads, want_grads))
        else:
            # against the bucketed run of this world (same plan, sums)
            b_losses, b_params = runs["bucketed"]
            res["params_equal_bucketed"] = all(
                torch.equal(g, w) for g, w in zip(got, b_params))
            res["losses_equal_bucketed"] = losses == b_losses
            res["beyond_tol_vs_bucketed"] = sum(
                int(((g - w).abs() > TRAIN_PARAM_TOL).sum().item())
                for g, w in zip(got, b_params))
        out["variants"][variant] = res
        del state, dstep, model
        torch.cuda.empty_cache()
    out["n_params"] = sum(w.numel() for w in want)
    bootstrap.shutdown()
    return out


def _adam_param_rule(got, want, got_grads, want_grads) -> dict:
    """``train_parity``'s rule for parameters after AdamW steps: an
    element whose two runs' gradients agree to GRAD_AGREE (relative) at
    every step is held to TRAIN_PARAM_TOL; elements below that noise
    floor (|g| within f32 noise of 0, which Adam divides by its own
    size) are counted, and at most TRAIN_PARAM_FRAC of all elements may
    lie beyond TRAIN_PARAM_TOL."""
    import torch
    held, over, exempt = 0.0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        gap = torch.stack([(gs[i] - ws[i]).abs() / ws[i].abs()
                           for gs, ws in zip(got_grads, want_grads)]
                          ).nan_to_num(0.0).amax(0)
        free = gap > GRAD_AGREE
        exempt += int(free.sum().item())
        over += int((diff > TRAIN_PARAM_TOL).sum().item())
        if (~free).any():
            held = max(held, diff[~free].max().item())
    return {"max_abs_param_err_held": held, "params_below_noise_floor":
            exempt, "params_off_by_more_than_tol": over}


def phase_dp_parity(state):
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(
        _dp_parity_rank, world, device="cuda", timeout=600,
        env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}).return_values
    problems = []
    for r in ranks:
        allowed = TRAIN_PARAM_FRAC * r["n_params"]
        for variant, v in r["variants"].items():
            if world == 1:
                ok = v["params_equal"] and v["losses_equal"] and v.get(
                    "grads_equal", True)
            elif variant == "bucketed":
                ok = (v["max_abs_loss_err"] <= DP_PARITY_TOL
                      and v["max_abs_grad_err"] <= DP_PARITY_TOL
                      and v["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                      and v["params_off_by_more_than_tol"] <= allowed)
            elif variant == "zero1":
                ok = v["params_equal_bucketed"] and v["losses_equal_bucketed"]
            else:
                ok = (v["max_abs_loss_err"] <= DP_PARITY_TOL
                      and v["beyond_tol_vs_bucketed"] <= allowed)
            if not ok:
                problems.append(f"rank {r['rank']} {variant}: {v}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"world": world, "rule": ("torch.equal" if world == 1 else
                                     "train_parity's"),
            "config": "transformer_big width, 2 layers, f32, full logits",
            "rows_per_rank": DP_PARITY_ROWS, "seq_len": DP_PARITY_SEQ,
            "steps": DP_PARITY_STEPS, "ranks": ranks}


# ---------------------------------------------------------------------------
# BERT (models/bert.py)
# ---------------------------------------------------------------------------

def _bert_config(**kw):
    """``bench.py``'s ``run_bert`` recipe (``bench.py:264-310``) in the
    port: ``bert_base`` in bf16, no remat, unrolled layers, full-logits
    MLM cross-entropy, AdamW with f32 moments. ``bench.py``'s
    ``attn_block_q/k=512`` are Pallas tile sizes; the port's kernels fix
    their own tiles, so its config has no such knob."""
    from distributed_tensorflow_tpu_torch.models.bert import bert_config
    return bert_config(**{"remat": False, "scan_layers": False, **kw})


def _bert_setup(cfg, seed, batch):
    """Model from the seeded init, ``make_optimizer`` AdamW, BERT's MLM
    train step (masks from ``(seed, step)``) and ``synthetic_corpus``."""
    import torch
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM, init_params, make_optimizer)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    model = TransformerLM(cfg, params, device="cuda")
    del params
    opt = make_optimizer(cfg, model.parameters())
    step = bert.make_train_step(cfg, model, opt, seed=seed)
    data = bert.synthetic_corpus(batch, cfg.max_seq_len, cfg.vocab_size,
                                 seed=seed, device="cuda")
    return model, opt, step, data


def _bert_grads_of_one_step(cfg, seed: int, batch: int):
    """Loss and every gradient leaf of step 0 of BERT's MLM objective
    from the seeded weights, corpus and masks of :func:`_bert_setup`
    (the train step's own masks), and the launches it made."""
    import torch
    from distributed_tensorflow_tpu_torch.models import bert
    model, _, _, data = _bert_setup(cfg, seed, batch)
    gen = torch.Generator(device="cuda").manual_seed(bert.mask_seed(seed, 0))
    inputs, labels = bert.apply_mlm_masking(gen, data["tokens"],
                                            vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    zero_launch_counts()
    loss = bert.make_loss_fn(cfg, model)(inputs, labels)
    loss.backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    grads = dict(_leaves(model.stacked_params(lambda p: p.grad.clone())))
    return loss.item(), grads, counts


def phase_bert_train(state):
    import torch
    torch.cuda.empty_cache()
    counts, out, grads = _timed_train(_bert_config(), BERT_LAUNCHES, False,
                                      bert=True)
    state["bert_train_launches"] = counts
    state["bert_first"] = (out["first_loss"], grads)
    return out


def phase_bert_train_kernel(state):
    """``bert_train`` with ``loss_impl="kernel"``; its first step (same
    weights, corpus and masks) against ``bert_train``'s: loss within
    BF16_TRAIN_LOSS_TOL, every gradient leaf within BF16_TRAIN_GRAD_TOL
    plus twice its bf16 noise (the full-logits bf16 step's distance from
    the f32 step of the same weights and masks)."""
    import torch
    torch.cuda.empty_cache()
    counts, out, kg = _timed_train(_bert_config(loss_impl="kernel"),
                                   BERT_KERNEL_LAUNCHES, False, bert=True)
    state["bert_train_kernel_launches"] = counts
    rl, rg = state.pop("bert_first")
    torch.cuda.empty_cache()
    fl, fg, _ = _bert_grads_of_one_step(_bert_config(dtype=torch.float32),
                                        0, BERT_BATCH)
    torch.cuda.empty_cache()
    leaves = {}
    for name, g in kg.items():
        noise = rel_err(rg[name], fg[name])
        leaves[name] = {"err": rel_err(g, rg[name]), "noise": noise,
                        "tol": BF16_TRAIN_GRAD_TOL + 2 * noise}
    kl = out["first_loss"]
    ok = (abs(kl - rl) <= BF16_TRAIN_LOSS_TOL and len(kg) == 10
          and all(x["err"] <= x["tol"] for x in leaves.values()))
    out["against_full_logits"] = {
        "loss": kl, "loss_full_logits": rl, "loss_f32": fl,
        "abs_loss_err": abs(kl - rl), "loss_tol": BF16_TRAIN_LOSS_TOL,
        "max_grad_rel_err": max(x["err"] for x in leaves.values()),
        "leaves": leaves, "ok": ok}
    if not ok:
        raise AssertionError(f"bert kernel loss against full logits: "
                             f"{json.dumps(out['against_full_logits'])}")
    return out


def phase_bert_parity(state):
    """f32, TF32 off, 2 layers at ``bert_base`` width, batch 2 x 512, one
    step from the same weights and masks: the kernel path (the f32
    CUDA-core attention and CE kernels, whose launches it counts)
    against the unfused reference (``mha_reference``, full logits):
    loss and every gradient leaf."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(n_layers=2, dtype=torch.float32)
    kl, kg, kc = _bert_grads_of_one_step(
        _bert_config(**base, loss_impl="kernel"), 5, 2)
    rl, rg, _ = _bert_grads_of_one_step(
        _bert_config(**base, attention_impl="reference"), 5, 2)
    grad_err = {n: rel_err(g, rg[n]) for n, g in kg.items()}
    out = {"config": "bert_base, 2 layers", "dtype": "float32",
           "batch": 2, "seq_len": _bert_config().max_seq_len,
           "loss_kernel": kl,
           "loss_reference": rl, "abs_loss_err": abs(kl - rl),
           "loss_tol": TRAIN_LOSS_TOL, "grad_rel_err": grad_err,
           "max_grad_rel_err": max(grad_err.values()),
           "grad_tol": GRAD_TOL["float32"], "launches": kc}
    state["bert_parity_launches"] = kc
    if (abs(kl - rl) > TRAIN_LOSS_TOL or len(grad_err) != 10
            or max(grad_err.values()) > GRAD_TOL["float32"]
            or kc != expected_counts(BERT_PARITY_LAUNCHES, 1)):
        raise AssertionError(f"bert parity: {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


def _bert_engine(cfg, seed):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    slots = BERT_SCORE_REQUESTS
    engine = InferenceEngine(
        cfg, params, device="cuda", block_size=SERVE_BLOCK, max_slots=slots,
        num_blocks=slots * cfg.max_seq_len // SERVE_BLOCK + 1)
    return engine, params


def phase_bert_score(state):
    """Scoring requests (``max_new_tokens=0``: one prefill each) through
    ``InferenceEngine`` at ``bert_base``: in bf16 at full depth, the
    non-causal tensor-core forward 12 times a prompt and no other kernel;
    in f32 at 2 layers, each prompt's last-position prefill logits
    against ``TransformerLM.forward`` on the prompt alone."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)

    cfg = _bert_config()
    engine, params = _bert_engine(cfg, 0)
    del params
    rng = np.random.default_rng(0)
    lens = rng.integers(16, cfg.max_seq_len + 1, BERT_SCORE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    engine.generate([prompts[0][:16]], max_new_tokens=0)      # warm-up
    prefills0 = engine.prefills
    prefill_ms, decode_ms = [], []
    _instrument(engine, prefill_ms, decode_ms)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    prefills = engine.prefills - prefills0
    acct = engine.block_accounting()
    problems = []
    if [len(o) for o in outs] != [1] * BERT_SCORE_REQUESTS or any(
            not 0 <= o[0] < cfg.vocab_size for o in outs):
        problems.append(f"scores {outs}")
    if prefills != BERT_SCORE_REQUESTS or decode_ms:
        problems.append(f"{prefills} prefills, {len(decode_ms)} decodes")
    if counts != expected_counts({"flash_fwd_tc": cfg.n_layers}, prefills):
        problems.append(f"launches {counts}")
    if not acct["conserved"] or acct["free"] != acct["usable"]:
        problems.append(f"block accounting at idle: {acct}")
    state["bert_score_launches"] = counts
    del engine
    torch.cuda.empty_cache()

    # f32, 2 layers: the engine's last-position prefill logits against
    # the model's forward on each prompt alone
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = _bert_config(n_layers=2, dtype=torch.float32)
    engine, params = _bert_engine(cfg32, 1)
    model = TransformerLM(cfg32, params, device="cuda")
    del params
    recorded, prefill_fn = [], engine._prefill

    def prefill(params_, pool, toks, rows):
        last, pool = prefill_fn(params_, pool, toks, rows)
        recorded.append((toks[0].tolist(), last.clone()))
        return last, pool

    engine._prefill = prefill
    scores = engine.generate(prompts, max_new_tokens=0)
    worst, mismatched = 0.0, []
    with torch.no_grad():
        for i, (toks, last) in enumerate(recorded):
            ref = model(torch.tensor([toks], device="cuda"))[0, -1]
            worst = max(worst, abs_err(last, ref))
            top2 = torch.topk(ref, 2).values
            if (top2[0] - top2[1]).item() > PARITY_GAP and \
                    scores[prompts.index(toks)][0] != int(ref.argmax()):
                mismatched.append(i)
    if len(recorded) != BERT_SCORE_REQUESTS or worst > PARITY_LOGIT_TOL \
            or mismatched:
        problems.append(f"f32 prefill logits: max err {worst} (tol "
                        f"{PARITY_LOGIT_TOL}), {len(recorded)} recorded, "
                        f"score mismatches {mismatched}")
    if problems:
        raise AssertionError("; ".join(problems))
    del engine, model
    torch.cuda.empty_cache()
    return {"config": "bert_base", "dtype": "bfloat16",
            "requests": BERT_SCORE_REQUESTS,
            "prompt_lens": [int(n) for n in lens], "wall_s": wall,
            "prefill_ms": [[n, ms] for n, ms in prefill_ms],
            "prefill_ms_mean": float(np.mean([ms for _, ms in prefill_ms])),
            "prompts_per_s": BERT_SCORE_REQUESTS / wall,
            "launches": counts, "block_accounting": acct,
            "f32_parity": {"layers": 2, "max_abs_logit_err": worst,
                           "tol": PARITY_LOGIT_TOL}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import distributed_tensorflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    state: dict = {}
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", phase_kernels), ("serve", phase_serve),
                     ("parity", phase_parity),
                     ("prefix_serve", phase_prefix_serve),
                     ("prefix_parity", phase_prefix_parity),
                     ("spill", phase_spill),
                     ("spec_serve", phase_spec_serve),
                     ("spec_parity", phase_spec_parity),
                     ("disagg_serve", phase_disagg_serve),
                     ("disagg_parity", phase_disagg_parity),
                     ("swap_chaos", phase_swap_chaos),
                     ("train", phase_train),
                     ("train_fused", phase_train_fused),
                     ("train_parity", phase_train_parity),
                     ("train_options", phase_train_options),
                     ("bert_train", phase_bert_train),
                     ("bert_train_kernel", phase_bert_train_kernel),
                     ("bert_parity", phase_bert_parity),
                     ("bert_score", phase_bert_score),
                     ("dp_train", phase_dp_train),
                     ("dp_parity", phase_dp_parity)):
        t0 = time.perf_counter()
        try:
            out = fn(state)
        except Exception as e:
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"[:4000]})
            return 1
        emit({"phase": name, "ok": True,
              "seconds": round(time.perf_counter() - t0, 3), **out})
    summary = []
    for name, (source, replaces) in KERNELS.items():
        k = state[name]
        path = KERNEL_PATH.get(name, "train")
        row = {"name": name, "route": "cuda",
               "source": f"distributed_tensorflow_tpu_torch/ops/csrc/"
                         f"{source}",
               "replaces": f"distributed_tensorflow_tpu/{replaces}",
               "launches": state[f"{path}_launches"][name],
               "launches_path": path,
               "train_launches": state["train_launches"][name]}
        row.update({key: k[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")})
        for key in ("unfused_ms", "f32_mu", "ms_events", "library_ms_events",
                    "library", "design_bound_ms", "achieved_tflops",
                    "bound_share", "dtype", "device_ms",
                    "library_device_ms"):
            if key in k:
                row[key] = k[key]
        if name == "flash_fwd_tc":
            # the same kernel on the serve path, at its longest prefill;
            # on the prefix-hit path (the suffix shape) and the
            # speculative path (prefills and the draft)
            row["serve"] = {"launches": state["serve_launches"],
                            **k["serve"]}
            row["prefix"] = k["prefix"]
            row["spec"] = k["spec"]
            # the disaggregated run: on the prefill replica only
            row["disagg"] = k["disagg"]
        if name == "flash_fwd":
            # f32: the prefix-hit, spill and speculative parity paths
            row["prefix"] = {"launches": state["prefix_parity_launches"][
                name], "spill_launches": state["spill_launches"][name]}
            row["spec"] = {"launches": state["spec_parity_launches"][name],
                           "self_draft_launches": state[
                               "spec_parity_self_launches"][name]}
            # f32: the disaggregated parity runs, the hot-swap and chaos
            row["disagg"] = {
                "launches": state["disagg_parity_launches"][name],
                "swap_launches": state["swap_launches"][name],
                "chaos_launches": state["chaos_launches"][name]}
        # BERT's paths, each counted from 0 over its own run, and the
        # kernel's numbers at the shape BERT gives it
        row["bert_launches"] = {
            path: state[f"{path}_launches"][name]
            for path in ("bert_train", "bert_train_kernel", "bert_parity",
                         "bert_score")}
        if name in state["bert_rows"]:
            row["bert"] = state["bert_rows"][name]
        # the data-parallel runs of dp_train (rank 0), each from 0
        row["dp_launches"] = {v: c[name]
                              for v, c in state["dp_launches"].items()}
        summary.append(row)
    emit({"kernels": summary})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

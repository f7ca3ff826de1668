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
16. ``tp_shards``, ``tp_train``, ``tp_parity``, ``tp_serve`` — tensor
    parallelism (the constants beside ``TP_STEPS`` say what each runs).
17. ``pp_kernels`` — #1-#3 at the pipelined step's microbatch, ``(1,
    16, 1024, 64)`` bf16 causal, against their plain versions, with
    their bounds and SDPA (the kernels line's ``pp`` rows).
18. ``pp_train`` — ``make_pipelined_train_step`` at ``bench.py``'s
    ``transformer-pp`` row (``transformer_big``, 12 layers, 1024 tokens,
    bf16, remat, full-logits head; 8 rows a data shard in 8
    microbatches) on one rank a card through ``multi_process_runner``
    on NCCL: at one card pp 1 with GPipe, 1F1B and interleaved v=3 (the
    measured bubble's base); at four cards pp4 with GPipe, 1F1B,
    interleaved v=3 and 1F1B with the stash offloaded (``True``,
    ``"device"``), and dp2×pp2 with 1F1B, interleaved v=2 and ZeRO-2.
    One warm-up and 3 timed steps a run: step ms, tokens/s, the analytic
    and the measured bubble (``1 − T(pp1) / (pp · T(pp))``), P2P sends
    and receives a step with their bytes, peak memory and spilled bytes
    a rank; #1-#3 launched a step exactly as ``pp_expected_launches``
    derives, no plain version, no other kernel; the loss falls, equal on
    every rank, and the gathered parameters agree.
19. ``pp_parity`` — f32, TF32 off, deterministic, 8 layers at
    ``transformer_big`` width, 4 rows × 256 tokens a data shard in 4
    microbatches, 2 steps: each schedule against single-device
    ``make_train_step`` on the global batch and against the same step
    with each data shard's gradients accumulated over its rows of the 4
    microbatches, meaned over the shards (losses and
    gradients within ``PP_PARITY_TOL`` of both, parameters by the rule
    beside ``PP_PARITY_TOL``); offload on against ``"device"`` and
    interleaved v=1 against 1F1B ``torch.equal``. At one card pp 1; at
    four pp4 and dp2×pp2.

20. ``sp_kernels`` — the sequence-parallel ring's own block calls at
    full width, in one process over 4 virtual ranks: ``transformer_big``'s
    attention of a 32,768-token sequence at sp 4, blocks ``(1, 16, 8192,
    64)`` bf16. For each ``(me, src)`` the port's step-block functions
    (``parallel/sequence_parallel.py``) of the contiguous causal ring, the
    non-causal ring and the striped ring (causal offsets 0 and −1), each
    block's ``(o, lse)`` and, against the merged ring's global ``(o,
    lse)``, its ``(dq, dk, dv)`` held against the plain versions; rows
    that see no key ``o = 0``, ``lse = +inf``; no launch for a skipped
    future block; the merged rings against whole-sequence flash (#1-#3
    over the 32,768 tokens), and at f32 and ``(1, 4, 256, 64)`` blocks
    against ``mha_reference``. Each virtual rank's kernel time for its
    blocks (the imbalance of contiguous against striped), and #1-#3 at
    each kind of block (diagonal, full, strict) timed against their
    plain versions and SDPA (the kernels line's ``sp`` rows).
21. ``sp_train`` — ``make_sharded_train_step`` at ``transformer_big``,
    bf16, remat, kernel CE, bf16 mu, every rank holding 8,192 tokens: at
    one card ``{"sp": 1}`` (the plain flash path, as JAX's at sp 1); at
    four cards sp4 at 32,768 tokens under each ``sp_impl``, dp2×sp2 and
    sp2×tp2 at 16,384. One warm-up and 3 timed steps a run: step ms,
    tokens/s, peak memory, the ring's sends and bytes a step, each
    rank's #1-#3 and CE launches exactly as ``sp_expected_launches``
    derives, no plain version; the loss falls, equal on every rank, and
    the gathered parameters agree.
22. ``sp_parity`` — ``pp_parity``'s f32 config (8 layers, 4 rows × 256 a
    data shard, 2 steps) against single-device ``make_train_step``: sp 1
    bitwise at one card; at four cards sp4 under each ``sp_impl``,
    dp2×sp2 and sp2×tp2 by ``dp_parity``'s rule.
23. ``moe_train`` — the headline step with 8 experts a layer (the MoE
    layer replaces the MLP; about 889 M parameters): at one card the
    single-device step top-1 (capacity 1.25), top-2 (capacity 2.0) and
    top-1 under remat "nothing", and top-1 on ``{"ep": 1}`` with
    ``fused_optimizer=True``; at four cards ``make_sharded_train_step``
    on ep4 (also fused), dp2×ep2 and ep2×tp2. Step ms, tokens/s, MFU (the dense FLOPs
    plus 12 D F a kept routed token a layer), dropped share, expert load
    max/mean, aux, the state a rank holds and peak memory, the boundary
    all-reduces and routing count gathers a step with bytes; #1-#4 and
    #7 launch exactly the headline's a step (#9 once a local parameter
    tensor in the fused runs), no plain version; the loss falls, equal
    on every rank.
24. ``moe_parity`` — ``pp_parity``'s f32 config with 8 experts: ``{"ep":
    1}`` bitwise against the single-device step; the single-device step
    (top-1 and top-2) against the same model whose MoE layers are JAX's
    unfused formulation in plain PyTorch (loss, gradients, parameters,
    and each layer's dropped rows on the same input exactly the
    reference's zero rows); at four cards ep4, dp2×ep2, ep2×tp2 by
    ``sp_parity``'s rule, each rank's dropped rows the single device's.
25. ``fsdp_train`` — the headline step, 8 × 1024 a data shard, on
    ``{"fsdp": 1}`` and at four cards fsdp4, dp2×fsdp2, fsdp2×tp2, and
    ``{"fsdp": 1}`` and fsdp4 with ``fused_optimizer=True``: step ms,
    tokens/s, the state a rank holds, the all-gathers and
    reduce-scatters a step with bytes; the headline's kernels, and #9
    once a local shard a step in the fused runs.
26. ``fsdp_parity`` — as ``sp_parity`` on ``{"fsdp": 1}`` (bitwise) and
    fsdp4, dp2×fsdp2, fsdp2×tp2.

``tp_train`` also runs ``bert_train``'s config on ``{"tp": world}`` (at
four cards bert_base's V 30522, which 4 does not divide, padded to 7,631
rows a rank), and ``tp_parity`` its 2-layer f32 step there against the
single-device BERT step by ``dp_parity``'s rule.

27. ``resnet_train`` — ``bench.py run_resnet50``'s configuration through
    ``models/resnet.py``: ResNet-50 in bf16, batch 128 at 224², two
    warm-up and 8 timed steps: step ms, images/s, MFU (the FLOPs counted
    from the conv and dense shapes, ×3), peak memory, the device time by
    kernel group and the idle share, a falling loss; none of #1-#9 runs.
28. ``resnet_parity`` — f32, TF32 off, ResNet-50 at batch 8 of 128²: one
    step on the card against the port on the CPU from the same converted
    variables: eval and train logits, loss, every gradient, the
    BatchNorm statistics and the parameters' update (``RESNET_PARITY_
    TOL``).
29. ``resnet_dp`` — ``resnet.make_sharded_train_step`` on ``{"dp":
    world}``, one rank a card: bf16 at 128 a card (images/s), then f32
    at 8 a card of 128² (each rank's rows a different mean) against one
    card on the global batch (BatchNorm's statistics the global batch's).
30. ``mnist_train`` — the MNIST CNN at batch 128: step ms, images/s.
31. ``wide_deep_train`` — DLRM (``dlrm_like``: 26 × 100,000 × 64 f32,
    "dot") at batch 4096 through ``make_train_step`` and
    ``make_embedding_train_step``: step ms, examples/s, the state held,
    peak memory, the device time by kernel group, a falling loss.
32. ``wide_deep_parity`` — f32 at 1,000 rows a table, both paths, two
    steps on the card against the CPU (``WD_PARITY_TOL``).
33. ``wide_deep_tp`` — both paths on ``{"tp": world}`` and at four
    cards ``{"dp": 2, "tp": 2}`` with a first vocabulary of 100,001 (no
    tp divides it): timed at 4096 a data shard, then f32 at 1,000 rows a
    table against the single card on the global batch.
34. ``ckpt_train`` — the headline step trained 6 steps, its train state
    (``train_state_variables``) saved at step 3 through a
    ``CheckpointManager`` with a local tier, ``async_write=True``;
    restored into a fresh model by ``restore_latest`` (bitwise the saved
    state) and resumed twice: the losses and state against the
    uninterrupted run and the two resumes against each other; the
    checkpoint's bytes, the save's blocking and commit times, a local
    and a durable restore, GB/s of each; plain and fused AdamW (#9).
35. ``ckpt_serve`` — ``InferenceEngine.from_checkpoint`` at the headline
    config from ``ckpt_train``'s directories (step 3) against an engine
    built from the saved parameters (equal streams), then
    ``begin_load_version`` to step 6 mid-stream against
    ``install_version`` at the same step boundary; #1 at the longest
    prefill against its plain version.
36. ``online_train`` — ``OnlineTrainer`` at ``OnlineConfig()`` over 4096
    seeded events, crashed after an uncommitted batch, restored, against
    an uncrashed run: offsets, membership, state; events/s.
37. ``ckpt_mesh`` (four cards) — a dp2×tp2 save restored onto tp 4 and
    one card, and down the host > peer > local > durable ladder after
    one rank's memory is wiped, bitwise.
38. ``mesh_repair`` (four cards) — ``make_sharded_train_step`` on dp2×pp2
    and pp2×tp2, ``make_pipelined_train_step`` GPipe and 1F1B on
    pp2×tp2, f32 against the single-device step.

``python3 chip_smoke.py --phases pp_train,pp_parity`` runs only the
named phases after ``device`` and ``build`` (the four-card runs: also
``--phases sp_train,sp_parity``, ``--phases moe_train,moe_parity,
fsdp_train,fsdp_parity``, ``--phases resnet_dp,wide_deep_tp,tp_train,
tp_parity``, ``--phases ckpt_mesh,mesh_repair``), and prints no kernels
line. ``ckpt_mesh`` and ``mesh_repair`` run in the whole run only when
four cards are visible.

Then a ``{"kernels": [...]}`` line (per kernel: launches on the path
that runs it and on each BERT path, error, measured times and the
bound, at the main path's shape and, where BERT runs it, at BERT's;
the flash forward's rows also the launches of phases 5a-5h and, in
bf16, its times at the largest suffix shape; every row's
``sp_launches`` each ``sp_train`` run's, and #1-#3's ``sp`` their times
at the ring's block shape, each kind of block; ``moe_launches`` and
``fsdp_launches`` each ``moe_train`` and ``fsdp_train`` run's;
``other_workload_launches`` phases 27-33's, all 0; ``ckpt_launches``
phases 34-36's),
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
# ckpt_train: the headline step trained CKPT_STEPS steps, saved at
# CKPT_AT (async, local tier first) and resumed from it; the resumed
# losses may part from the uninterrupted ones by the kernels' own
# run-to-run spread (the CE backward's float atomics), and at most by
# CKPT_LOSS_TOL beyond twice that spread
CKPT_STEPS, CKPT_AT, CKPT_LOSS_TOL = 6, 3, 1e-3
# ckpt_serve: requests of CKPT_SERVE_NEW new tokens each
CKPT_SERVE_REQUESTS, CKPT_SERVE_NEW = 6, 16
# ckpt_mesh (four cards): the headline config's width at this depth
CKPT_MESH_LAYERS = 2
# online_train: OnlineConfig() over ONLINE_EVENTS events, crashed after
# ONLINE_CRASH_AFTER applied batches (2 past the last commit of 5)
ONLINE_EVENTS, ONLINE_CRASH_AFTER, ONLINE_TOL = 4096, 37, 1e-5
# mesh_repair (four cards): C-4(c) sharded steps and C-4(d) pipelined
# steps on meshes with a replicated axis, pp_parity's f32 config
MESH_REPAIR_SHARDED = {"dp2pp2": ({"dp": 2, "pp": 2}, {}),
                       "pp2tp2": ({"pp": 2, "tp": 2}, {})}
MESH_REPAIR_PIPELINED = {"pp2tp2": ({"pp": 2, "tp": 2},
                                    (("gpipe", {}), ("1f1b", {})))}
# phases that need four cards: run by --phases, or in the whole run
# when four are visible
FOUR_CARD_PHASES = ("ckpt_mesh", "mesh_repair")
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
# tp_shards: the headline's 16 heads and 32768 vocab rows at tp 2 and 4
TP_SIZES, TP_SHARD_HEADS = (2, 4), (8, 4)
# tp_train: per data shard the headline batch; one warm-up and TP_STEPS
# timed steps a mesh and variant: (config kwargs, step kwargs). Per rank
# the path launches TRAIN_LAUNCHES a step (the attention at H/tp heads,
# the CE on V/tp vocab rows), and FUSED_LAUNCHES with the fused AdamW
TP_STEPS = 3
TP_VARIANTS = {"plain": ({}, {}), "fused": ({"fused_optimizer": True}, {}),
               "zero1": ({}, {"zero": 1})}
# tp_parity: dp_parity's f32 config, 2 rows x 256 tokens a data shard
TP_PARITY_ROWS, TP_PARITY_SEQ, TP_PARITY_STEPS = 2, 256, 2
# pp_train: bench.py's transformer-pp row (:635-665) — 8 rows a data
# shard in 8 microbatches, one warm-up and PP_STEPS timed steps a run; a
# mesh name → (axes, runs of (schedule, step kwargs)). At one card pp 1
# with each schedule (the bubble's base); at four pp4 and dp2×pp2
PP_ROWS, PP_MICRO, PP_STEPS = 8, 8, 3
PP_RUNS = {
    1: {"pp1": ({"pp": 1}, (("gpipe", {}), ("1f1b", {}),
                            ("interleaved", {"interleave": 3})))},
    4: {"pp4": ({"pp": 4}, (("gpipe", {}), ("1f1b", {}),
                            ("interleaved", {"interleave": 3}),
                            ("1f1b", {"offload_activations": True}),
                            ("1f1b", {"offload_activations": "device"}))),
        "dp2pp2": ({"dp": 2, "pp": 2}, (("1f1b", {}),
                                        ("interleaved", {"interleave": 2}),
                                        ("1f1b", {"zero": 2})))}}
# pp_parity: f32, 8 layers at transformer_big width (pp4 x v2 divides),
# 4 rows x 256 tokens a data shard in 4 microbatches, 2 steps, against
# single-device make_train_step on the global batch and against the same
# single-device step with each data shard's gradients accumulated over
# its rows of the 4 microbatches, then meaned over the shards (what the
# pipelined step sums): losses and gradients within PP_PARITY_TOL of both,
# parameters by dp_parity's rule against the accumulation; against the
# whole-batch step the elements beyond TRAIN_PARAM_TOL may number what
# the accumulation itself shows against it (on an H100, microbatching
# alone moves ~22.6k of 134M f32 elements whose |g| is noise) plus that
# rule's share. The offload arms, and interleaved v=1 against 1F1B,
# bitwise
PP_PARITY_LAYERS, PP_PARITY_SEQ, PP_PARITY_ROWS = 8, 256, 4
PP_PARITY_MICRO, PP_PARITY_STEPS, PP_PARITY_TOL = 4, 2, 1e-5
_PP_PARITY_SCHEDULES = (("gpipe", {}), ("1f1b", {}),
                        ("interleaved", {"interleave": 2}),
                        ("interleaved", {"interleave": 1}),
                        ("1f1b", {"offload_activations": True}),
                        ("1f1b", {"offload_activations": "device"}))
PP_PARITY_RUNS = {
    1: {"pp1": ({"pp": 1}, _PP_PARITY_SCHEDULES)},
    4: {"pp4": ({"pp": 4}, _PP_PARITY_SCHEDULES),
        "dp2pp2": ({"dp": 2, "pp": 2}, _PP_PARITY_SCHEDULES[:3])}}
PP_PARITY_BITWISE = (("offload", "offload_device"),
                     ("interleaved_v1", "1f1b"))
# sp_kernels: transformer_big's attention of a 32,768-token sequence at
# sp 4 (tools/sp_bench.py's default chunk): blocks (1, 16, 8192, 64)
# bf16 over SP_N virtual ranks in one process; the kinds of block the
# rings launch, (causal, causal_offset): the diagonal, a past chunk
# (contiguous) and striped's strict block; the f32 check's block
# against mha_reference
SP_N, SP_BLOCK, SP_F32_BLOCK = 4, (1, 16, 8192, 64), (1, 4, 256, 64)
SP_BLOCK_KINDS = {"diagonal": (True, 0), "full": (False, 0),
                  "strict": (True, -1)}
# sp_train: name → (axes, sequence, global batch, config kwargs) by
# world; every rank holds 8,192 tokens, as a rank of dp4's headline step
# (8 x 1024). One warm-up and SP_STEPS timed steps a run
SP_STEPS = 3
SP_RUNS = {
    1: {"sp1": ({"sp": 1}, 8192, 1, {})},
    4: {"sp4_ring": ({"sp": 4}, 32768, 1, {"sp_impl": "ring"}),
        "sp4_striped": ({"sp": 4}, 32768, 1, {"sp_impl": "striped"}),
        "sp4_ulysses": ({"sp": 4}, 32768, 1, {"sp_impl": "ulysses"}),
        "dp2sp2": ({"dp": 2, "sp": 2}, 16384, 2, {}),
        "sp2tp2": ({"sp": 2, "tp": 2}, 16384, 1, {})}}
# sp_parity: pp_parity's f32 config (8 layers, 4 rows x 256 tokens a data
# shard, 2 steps); name → (axes, config kwargs) by world. Held to the
# single-device step: bitwise at one card; at four, dp_parity's rule
# with pp_parity's allowance (phase_sp_parity says why)
SP_PARITY_RUNS = {
    1: {"sp1": ({"sp": 1}, {})},
    4: {"sp4_ring": ({"sp": 4}, {"sp_impl": "ring"}),
        "sp4_striped": ({"sp": 4}, {"sp_impl": "striped"}),
        "sp4_ulysses": ({"sp": 4}, {"sp_impl": "ulysses"}),
        "dp2sp2": ({"dp": 2, "sp": 2}, {}),
        "sp2tp2": ({"sp": 2, "tp": 2}, {})}}

# moe_train: the headline row with 8 experts a layer (about 889 M
# parameters, 805 M of them in experts); name → (axes, global batch,
# config kwargs) by world. One card: the single-device step (axes None)
# top-1 at JAX's defaults (capacity 1.25), top-2 at capacity 2.0 (JAX's
# flagship MoE test) and top-1 under remat "nothing"; four cards: ep4
# (ep is no data axis: one data shard, the dense part on every rank),
# dp2×ep2 and ep2×tp2 at 8 × 1024 a data shard. The MoE layer launches
# no kernel: a step launches the headline's #1-#3 and CE kernels (#1
# twice a layer under remat "nothing"). The "_fused" runs take
# fused_optimizer=True on the sharded (post-sync) step: #9 once a local
# parameter tensor a step, router, wi and wo among them (E/ep experts a
# rank at ep4). One warm-up and MOE_STEPS timed steps a run
MOE_STEPS = 3
MOE_TOP1 = {"moe_experts": 8}
MOE_TOP2 = {"moe_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 2.0}
FUSED = {"fused_optimizer": True}
MOE_RUNS = {
    1: {"top1": (None, 8, MOE_TOP1), "top2": (None, 8, MOE_TOP2),
        "top1_remat": (None, 8, {**MOE_TOP1, "remat": True,
                                 "remat_policy": "nothing"}),
        "ep1_fused": ({"ep": 1}, 8, {**MOE_TOP1, **FUSED})},
    4: {"ep4": ({"ep": 4}, 8, MOE_TOP1),
        "ep4_fused": ({"ep": 4}, 8, {**MOE_TOP1, **FUSED}),
        "dp2ep2": ({"dp": 2, "ep": 2}, 16, MOE_TOP1),
        "ep2tp2": ({"ep": 2, "tp": 2}, 8, MOE_TOP1)}}
# moe_parity: pp_parity's f32 config (8 layers, 4 rows x 256 tokens a
# data shard, 2 steps) with 8 experts; name → (axes, config kwargs) by
# world. One card: {"ep": 1} bitwise against single-device
# make_train_step, and the single-device step against the same model
# whose MoE layers are JAX's unfused formulation ((T, E, C) one-hot
# dispatch and combine, four einsums, in plain PyTorch): loss within
# TRAIN_LOSS_TOL, the first step's gradients within GRAD_TOL f32 of each
# leaf's largest magnitude, parameters by train_parity's rule, and each
# layer's dropped rows on the same input exactly the reference's zero
# rows (top-1, and top-2 at capacity 2.0). Four cards: ep4, dp2×ep2,
# ep2×tp2 by sp_parity's rule
MOE_PARITY_RUNS = {
    1: {"ep1": ({"ep": 1}, MOE_TOP1)},
    4: {"ep4": ({"ep": 4}, MOE_TOP1),
        "dp2ep2": ({"dp": 2, "ep": 2}, MOE_TOP1),
        "ep2tp2": ({"ep": 2, "tp": 2}, MOE_TOP1)}}
# fsdp_train: the headline row at 8 x 1024 a data shard; name → (axes,
# global batch, config kwargs) by world: {"fsdp": 1} at one card; fsdp4, dp2×fsdp2 and
# fsdp2×tp2 at four. Per step a rank gathers the six weights of each
# layer and the embedding twice (the lookup, the kernel loss's head):
# 74 all-gathers and 74 reduce-scatters; the kernels as the headline's,
# and in the "_fused" runs #9 once a local shard a step
FSDP_STEPS = 3
FSDP_RUNS = {
    1: {"fsdp1": ({"fsdp": 1}, 8, {}),
        "fsdp1_fused": ({"fsdp": 1}, 8, FUSED)},
    4: {"fsdp4": ({"fsdp": 4}, 32, {}),
        "fsdp4_fused": ({"fsdp": 4}, 32, FUSED),
        "dp2fsdp2": ({"dp": 2, "fsdp": 2}, 32, {}),
        "fsdp2tp2": ({"fsdp": 2, "tp": 2}, 16, {})}}
# fsdp_parity: pp_parity's f32 config; {"fsdp": 1} bitwise at one card,
# fsdp4, dp2×fsdp2, fsdp2×tp2 by sp_parity's rule at four
FSDP_PARITY_RUNS = {
    1: {"fsdp1": ({"fsdp": 1}, {})},
    4: {"fsdp4": ({"fsdp": 4}, {}), "dp2fsdp2": ({"dp": 2, "fsdp": 2}, {}),
        "fsdp2tp2": ({"fsdp": 2, "tp": 2}, {})}}
# resnet_train: bench.py run_resnet50 (:224-262), ResNet-50 at batch 128
# of 224², bf16; two warm-up and RESNET_STEPS timed steps. JAX's recipe
# (lr 0.1 from step 0, no warm-up) sends the loss from 8.6 up to ~55 in
# the first steps before it falls (below the first by step 7 on the
# card), so the phase runs 10 steps and holds the last below the first
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 128, 224, 8
# resnet_parity / resnet_dp's parity: f32, TF32 off, ResNet-50 at batch 8
# of 128² (a card); card against CPU (resnet_parity) or dp against one
# card on the global batch (resnet_dp). The logits are O(1); "grads_rel"
# is the gradients' error over their norm and "update_rel" the step's
# update error over the update, both as vectors over every parameter
# (``_vec_rel``). The recipe's first step is violent (lr 0.1 at step 0
# on a fresh init), and the BatchNorms between the loss and the stem
# amplify reordered f32 sums into the gradients, more so the fewer
# values a channel's statistics see (hence 128², not 64²): these phases
# measured the update 2.2-2.3 % apart (card against CPU, and dp4 against
# one card) with the losses within 3.8e-6 and the statistics within
# 7.4e-6 (NVIDIA H100 80GB HBM3, 700.00 W). The tolerances leave room
# above that spread
RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE = 8, 128
RESNET_PARITY_TOL = {"logits": 1e-3, "loss": 2e-4, "grads_rel": 0.1,
                     "stats": 1e-4, "update_rel": 0.1}
# one parity step: the recipe's first update (lr 0.1, no warm-up) sends
# the loss from 8.6 to ~37 (resnet_train), where a second step's values
# part far more between two orders of f32 sums
RESNET_DP_STEPS, RESNET_DP_PARITY_STEPS = 8, 1
# mnist_train: batch 128, MNIST_STEPS timed steps
MNIST_BATCH, MNIST_STEPS = 128, 20
# wide_deep_train: dlrm_like (26 tables x 100,000 x 64, "dot") at batch
# 4096, WD_STEPS timed steps a path; wide_deep_tp: the same with a first
# vocabulary no tp divides
WD_BATCH, WD_STEPS = 4096, 5
WD_TP_VOCABS = (100_001,) + (100_000,) * 25
# wide_deep_parity: f32, TF32 off, WD_PARITY_VOCAB rows a table, batch
# 512, 2 steps of each path: card against CPU (and in wide_deep_tp the
# mesh against one card)
WD_PARITY_VOCAB, WD_PARITY_BATCH, WD_PARITY_STEPS = 1000, 512, 2
WD_PARITY_TOL = 1e-5

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


def _fwd_errors(q, k, v, o, lse, causal: bool,
                causal_offset: int | None = None) -> dict:
    """``flash_fwd``'s ``(o, lse)`` against ``flash_attention_plain`` on
    the same inputs (``causal_offset`` None: bottom-right): errors,
    fully-masked rows (``lse = +inf`` and ``o = 0`` where the plain
    version has them) and the verdict."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_plain)
    po, plse = flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5,
                                     causal_offset=causal_offset)
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


# ---------------------------------------------------------------------------
# tensor parallelism (models/transformer.py on a mesh with "tp")
# ---------------------------------------------------------------------------

def _plain_calls() -> dict:
    """Count every call of a kernel's plain version from here on (the
    wrappers reach them through their modules' globals)."""
    from distributed_tensorflow_tpu_torch.ops import (
        attention, fused_adamw, fused_ce)
    counts: dict = {}
    for mod, name in ((attention, "flash_attention_plain"),
                      (attention, "flash_attention_bwd_plain"),
                      (fused_ce, "fused_ce_fwd_plain"),
                      (fused_ce, "fused_ce_bwd_plain"),
                      (fused_ce, "fused_ce_dh_plain"),
                      (fused_ce, "fused_ce_de_plain"),
                      (fused_adamw, "adamw_reference")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)
        setattr(mod, name, counted)
    return counts


def _attention_rows(b: int, h: int, gen) -> dict:
    """#1-#3 at ``(b, h, 1024, 64)`` bf16 causal (a tp shard of the
    headline's attention, or a pipeline microbatch): each against its
    plain version, timed in turns, with its bound and SDPA (forward;
    backward alone) at the same shape."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        launch_bwd_dkv, launch_bwd_dq)
    bf = torch.bfloat16
    q, k, v, do = (_rand((b, h, 1024, 64), bf, gen) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    fwd = _fwd_errors(q, k, v, o, lse, True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                     sm_scale=0.125)
    errs = {f"d{n}": rel_err(g, w) for n, g, w in zip("qkv", got, want)}
    if not fwd["ok"] or max(errs.values()) > GRAD_TOL["bfloat16"]:
        raise AssertionError(f"attention at B{b} H{h}: {fwd} {errs}")
    rows = {"flash_fwd_tc": _time_flash_fwd(q, k, v, fwd["o_err"])}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=0.125)
    lib = time_ms(lambda: torch.autograd.grad(sdpa, leaves, do,
                                              retain_graph=True))
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(sm_scale=0.125, causal=True, causal_offset=0)

    def plain():
        flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                  sm_scale=0.125)
    for op, fn, err in (("dq", launch_bwd_dq, abs_err(got[0], want[0])),
                        ("dkv", launch_bwd_dkv,
                         max(abs_err(got[1], want[1]),
                             abs_err(got[2], want[2])))):
        t = in_turns(lambda: fn(q, k, v, do, lse, delta, **kw), plain, 10)
        flops, nbytes = attention_work(q, k, True, 0, op)
        rows[f"flash_bwd_{op}_tc"] = {
            **_flash_row(t, flops, nbytes, bf, err, lib, q.shape),
            "library": "scaled_dot_product_attention backward (dq, dk, dv)",
            "rel_err": errs}
    del sdpa, leaves
    torch.cuda.empty_cache()
    return rows


def _ce_shard_library(h, e, t, g) -> dict:
    """The unfused pair ``F.cross_entropy(F.linear(h, e), t)`` on one
    vocab shard (targets another shard owns are −1, ignored), forward
    and its backward alone: the same work as the shard's kernels. No
    single library call computes a shard's ``(lse, tl)``."""
    import torch
    import torch.nn.functional as F
    hl, el = (x.detach().clone().requires_grad_() for x in (h, e))

    def fwd():
        return F.cross_entropy(F.linear(hl, el), t, reduction="none",
                               ignore_index=-1)
    loss = fwd()
    return {"unfused_fwd_ms": time_ms(fwd, 5),
            "unfused_bwd_ms": time_ms(lambda: torch.autograd.grad(
                loss, (hl, el), g.to(loss.dtype), retain_graph=True), 5),
            "library_fwd_ms": None, "library_bwd_ms": None}


def _tp_ce_rows(gen) -> tuple:
    """#4 and #7 on each vocab slice of the headline embedding (N 4096,
    V 32768, D 1024, bf16) at tp 2 and 4, targets another shard owns
    set to −1: each shard against its plain version; the merged lse
    (:func:`merge_vocab_shards`) and the summed dh / stacked dE against
    whole-vocab #4/#7 and the plain versions; shard 0 timed in turns
    with its bound and the unfused pair."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        fused_ce_bwd, fused_ce_bwd_plain, fused_ce_fwd, fused_ce_fwd_plain,
        local_targets, merge_vocab_shards)
    bf = torch.bfloat16
    n, vocab, d = 4096, 32768, 1024
    h = _rand((n, d), bf, gen)
    e = _rand((vocab, d), bf, gen, 0.1)
    t, _ = _ce_targets(n, vocab, gen)
    g = torch.rand(n, device="cuda", generator=gen) / n
    wlse, wtl = fused_ce_fwd(h, e, t)
    wdh, wde = fused_ce_bwd(h, e, t, wlse, g)
    plse, ptl = fused_ce_fwd_plain(h, e, t)
    pdh, pde = fused_ce_bwd_plain(h, e, t, plse, g)
    checks, rows = {}, {}
    for tp in (2, 4):
        per = vocab // tp
        shards = [(e[r * per:(r + 1) * per], local_targets(t, per, r))
                  for r in range(tp)]
        shard_err, parts = 0.0, []
        for er, tr in shards:
            lse_r, tl_r = fused_ce_fwd(h, er, tr)
            ql, qt = fused_ce_fwd_plain(h, er, tr)
            shard_err = max(shard_err, abs_err(lse_r, ql), abs_err(tl_r, qt))
            parts.append((lse_r, tl_r))
        lse, tl = merge_vocab_shards(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]))
        dh, des, bwd_err = None, [], 0.0
        for er, tr in shards:
            dh_r, de_r = fused_ce_bwd(h, er, tr, lse, g)
            qdh, qde = fused_ce_bwd_plain(h, er, tr, lse, g)
            bwd_err = max(bwd_err, rel_err(dh_r, qdh), rel_err(de_r, qde))
            dh = dh_r.float() if dh is None else dh + dh_r.float()
            des.append(de_r)
        de = torch.cat(des)
        c = {"shard_fwd_err": shard_err, "shard_bwd_rel_err": bwd_err,
             "merged_lse_err_kernel": abs_err(lse, wlse),
             "merged_tl_err_kernel": abs_err(tl, wtl),
             "merged_lse_err_plain": abs_err(lse, plse),
             "merged_tl_err_plain": abs_err(tl, ptl),
             "dh_rel_err_kernel": rel_err(dh, wdh),
             "de_rel_err_kernel": rel_err(de, wde),
             "dh_rel_err_plain": rel_err(dh, pdh),
             "de_rel_err_plain": rel_err(de, pde)}
        checks[f"tp{tp}"] = c
        if (max(v for k, v in c.items() if "rel" not in k) > CE_ROW_TOL
                or max(v for k, v in c.items() if "rel" in k)
                > GRAD_TOL["bfloat16"]):
            raise AssertionError(f"CE over tp {tp} vocab shards: {c}")
        er, tr = shards[0]
        t_fwd = in_turns(lambda: fused_ce_fwd(h, er, tr),
                         lambda: fused_ce_fwd_plain(h, er, tr), 5)
        t_bwd = in_turns(lambda: fused_ce_bwd(h, er, tr, lse, g),
                         lambda: fused_ce_bwd_plain(h, er, tr, lse, g), 3)
        lib = _ce_shard_library(h, er, tr, g)
        rows[f"tp{tp}"] = {
            "fused_ce_fwd_tc": _ce_row(n, per, d, bf, "fwd", t_fwd,
                                       c["shard_fwd_err"], lib),
            "fused_ce_bwd_tc": _ce_row(n, per, d, bf, "bwd", t_bwd,
                                       c["shard_bwd_rel_err"], lib)}
        for r in rows[f"tp{tp}"].values():
            r["library"] = ("none computes a shard's (lse, tl); unfused_ms: "
                            "F.cross_entropy(F.linear(h, E_r), t_r, "
                            "ignore_index=-1)")
    del h, e, wdh, wde, pdh, pde
    torch.cuda.empty_cache()
    return checks, rows


def phase_tp_shards(state):
    """One process: the tp kernels' call pattern on one card — #1-#3 at
    the per-shard head counts of the headline (H 8 at tp 2, H 4 at tp 4)
    and #4/#7 on each vocab shard at tp 2 and 4 with the merge."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(12)
    attn = {f"H{h}": _attention_rows(8, h, gen) for h in TP_SHARD_HEADS}
    ce_checks, ce_rows = _tp_ce_rows(gen)
    tp_rows: dict = {}
    for tp, h in zip(TP_SIZES, TP_SHARD_HEADS):
        for name, row in attn[f"H{h}"].items():
            tp_rows.setdefault(name, {})[f"tp{tp}"] = row
        for name, row in ce_rows[f"tp{tp}"].items():
            tp_rows.setdefault(name, {})[f"tp{tp}"] = row
    state["tp_rows"] = tp_rows
    return {"attention": attn, "ce_checks": ce_checks, "ce": ce_rows}


def _tp_meshes(world: int) -> list:
    meshes = [{"tp": world}]
    if world == 4:
        meshes.append({"dp": 2, "tp": 2})
    return meshes


def _gathered_checksum(cfg, model, mesh) -> tuple:
    """The checksum (float64 sum) of the gathered full parameters on this
    rank, and whether every rank's equals it."""
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.models.transformer import (
        gather_params)
    full = gather_params(cfg, model.stacked_params(), mesh)
    total = torch.stack([t.double().sum() for t in
                         torch.utils._pytree.tree_leaves(full)]).sum()
    every = [torch.zeros_like(total) for _ in range(dist.get_world_size())]
    dist.all_gather(every, total)
    del full
    return total.item(), all(torch.equal(t, total) for t in every)


def _group_collectives(groups: dict) -> dict:
    """Count every collective this process issues from here on, by the
    group it runs on (``groups``: name → process group; "world"
    otherwise) and by op, with the bytes of the tensor it carries."""
    import torch.distributed as dist
    counts: dict = {}
    names = {tuple(dist.get_process_group_ranks(g)): n
             for n, g in groups.items()}
    for op in ("all_reduce", "reduce_scatter_tensor",
               "all_gather_into_tensor", "broadcast", "all_gather"):
        real = getattr(dist, op)

        def counted(*a, _real=real, _op=op, **k):
            group = k.get("group")
            t = a[1] if _op in ("reduce_scatter_tensor",
                                "all_gather_into_tensor") else a[0]
            nbytes = (t.numel() * t.element_size()
                      if hasattr(t, "numel") else 0)
            name = ("world" if group is None else names.get(
                tuple(dist.get_process_group_ranks(group)), "world"))
            c = counts.setdefault(name, {}) \
                .setdefault(_op, {"calls": 0, "bytes": 0})
            c["calls"] += 1
            c["bytes"] += nbytes
            return _real(*a, **k)
        setattr(dist, op, counted)
    return counts


def _tp_train_rank(variants) -> dict:
    """One rank of ``tp_train``: each mesh and variant's warm-up and
    TP_STEPS timed steps at the headline config on this rank's card."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_sharded_train_step)
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        zero_state_bytes)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    plain = _plain_calls()
    cfg_base = _headline_config()
    out = {"rank": rank, "world": world,
           "device": torch.cuda.get_device_name(), "meshes": {}}
    for axes in _tp_meshes(world):
        mesh = topology.make_mesh(axes, device="cuda")
        coll = _group_collectives({n: mesh.get_group(n) for n in axes})
        n_dp = axes.get("dp", 1)
        global_batch = TRAIN_BATCH * n_dp
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg_base.vocab_size, (global_batch, cfg_base.max_seq_len))
        ).to("cuda")
        res = {}
        for variant in variants:
            cfg_kw, kw = TP_VARIANTS[variant]
            cfg = _headline_config(**cfg_kw)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, step = make_sharded_train_step(cfg, mesh, global_batch,
                                                  seed=0, **kw)
            model, opt = state["model"], state["optimizer"]
            state, m = step(state, {"tokens": tokens})          # warm-up
            losses = [m["loss"].item()]
            torch.cuda.synchronize()
            zero_launch_counts()
            coll.clear()
            plain.clear()
            step_ms = []
            for _ in range(TP_STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, m = step(state, {"tokens": tokens})
                e1.record()
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
                losses.append(m["loss"].item())
            counts = launch_counts()
            issued = {grp: {op: {k: v / TP_STEPS for k, v in c.items()}
                            for op, c in ops.items()}
                      for grp, ops in coll.items()}
            plain_calls = dict(plain)
            n_local = sum(p.numel() for p in model.parameters())
            level = kw.get("zero", 0)
            moments = [t for st in opt.state.values() for t in st.values()
                       if isinstance(t, torch.Tensor)]
            held = {t.untyped_storage().data_ptr(): t for t in
                    [*model.parameters(),
                     *(p for grp in opt.param_groups for p in grp["params"]),
                     *moments]}
            checksum, agree = _gathered_checksum(cfg, model, mesh)
            mean_s = float(np.mean(step_ms)) / 1e3
            res[variant] = {
                "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
                "tokens_per_s": global_batch * cfg.max_seq_len / mean_s,
                "losses": losses, "collectives_per_step": issued,
                "launches": counts, "plain_calls": plain_calls,
                "local_params": n_local,
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters()),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for t in moments),
                "persistent_state_bytes": sum(
                    t.numel() * t.element_size() for t in held.values()),
                "analytic_state_bytes_no_grads": zero_state_bytes(
                    n_local, n_dp, level, slot_bytes=6, grad_bytes=0),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "param_checksum": checksum, "ranks_agree": agree}
            if hasattr(step, "partition"):
                res[variant]["partition"] = step.partition.summary()
            del state, step, model, opt, moments, held, m
            gc.collect()
        out["meshes"]["x".join(f"{k}{v}" for k, v in axes.items())] = res
        del tokens
    out["meshes"][f"tp{world}_bert"] = {"bert": _tp_bert_timed(world,
                                                                plain)}
    bootstrap.shutdown()
    return out


def _tp_bert_timed(world: int, plain: dict) -> dict:
    """``bert_train``'s config (``bench.py run_bert``, full-logits MLM) on
    ``{"tp": world}``: bert_base's V 30522, which 4 does not divide,
    padded to a multiple of tp (7,631 rows a rank at tp 4). One warm-up
    and TP_STEPS timed steps."""
    import gc
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import bert
    mesh = topology.make_mesh({"tp": world}, device="cuda")
    cfg = _bert_config()
    tokens = bert.synthetic_corpus(BERT_BATCH, cfg.max_seq_len,
                                   cfg.vocab_size, seed=0,
                                   device="cuda")["tokens"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = bert.make_sharded_train_step(cfg, mesh, BERT_BATCH, seed=0)
    state, m = step(state, {"tokens": tokens})
    losses = [m["loss"].item()]
    torch.cuda.synchronize()
    zero_launch_counts()
    plain.clear()
    state, step_ms, timed = _step_events(step, state, {"tokens": tokens},
                                         TP_STEPS)
    losses += timed
    counts = launch_counts()
    model = state["model"]
    checksum, agree = _gathered_checksum(cfg, model, mesh)
    mean_s = float(np.mean(step_ms)) / 1e3
    out = {"step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
           "tokens_per_s": BERT_BATCH * cfg.max_seq_len / mean_s,
           "losses": losses, "launches": counts,
           "plain_calls": dict(plain),
           "local_embed_rows": model.embed.shape[0],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "param_checksum": checksum, "ranks_agree": agree}
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp_train(state):
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(
        _tp_train_rank, world, args=(tuple(TP_VARIANTS),), device="cuda",
        timeout=900).return_values
    problems = []
    for r in ranks:
        for mesh, res in r["meshes"].items():
            for variant, v in res.items():
                per_step = (FUSED_LAUNCHES if variant == "fused"
                            else BERT_LAUNCHES if variant == "bert"
                            else TRAIN_LAUNCHES)
                want = expected_counts(per_step, TP_STEPS)
                tag = f"rank {r['rank']} {mesh} {variant}"
                if v["launches"] != want:
                    problems.append(f"{tag}: launches {v['launches']} != "
                                    f"{want}")
                if v["plain_calls"]:
                    problems.append(f"{tag}: plain versions ran: "
                                    f"{v['plain_calls']}")
                if not all(math.isfinite(x) for x in v["losses"]) or \
                        not v["losses"][-1] < v["losses"][0]:
                    problems.append(f"{tag}: losses do not fall: "
                                    f"{v['losses']}")
                if not v["ranks_agree"]:
                    problems.append(f"{tag}: gathered parameters differ "
                                    f"between ranks")
                if v["losses"] != ranks[0]["meshes"][mesh][variant][
                        "losses"]:
                    problems.append(f"{tag}: loss differs from rank 0's")
    if problems:
        raise AssertionError("; ".join(problems))
    r0 = ranks[0]["meshes"]
    state["tp_launches"] = {f"{mesh}_{variant}": v["launches"]
                            for mesh, res in r0.items()
                            for variant, v in res.items()}
    return {"world": world, "config": "transformer_big (bench.py headline); "
                                      "bert_base (run_bert) on tp = world",
            "batch_per_data_shard": TRAIN_BATCH, "seq_len": 1024,
            "steps": TP_STEPS, "launches_per_step": TRAIN_LAUNCHES,
            "fused_launches_per_step": FUSED_LAUNCHES, "ranks": ranks}


def _tp_parity_rank() -> dict:
    """One rank of ``tp_parity``: the tp (and at world 4 the dp×tp and
    its ZeRO-1) steps against single-device ``make_train_step`` on the
    global batch, after ``gather_params``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, gather_params, init_params,
        make_sharded_train_step)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = TransformerConfig.transformer_big(
        n_layers=2, max_seq_len=TP_PARITY_SEQ, dtype=torch.float32,
        remat=False, scan_layers=False, loss_impl="scan")
    out = {"rank": rank, "world": world, "runs": {}}
    runs = [("tp", {"tp": world}, {})]
    if world == 4:
        runs += [("dp_tp", {"dp": 2, "tp": 2}, {}),
                 ("dp_tp_zero1", {"dp": 2, "tp": 2}, {"zero": 1})]
    refs: dict = {}
    for name, axes, kw in runs:
        n_dp = axes.get("dp", 1)
        global_batch = TP_PARITY_ROWS * n_dp
        if global_batch not in refs:
            model, opt, step, _ = _train_setup(cfg, 0, global_batch)
            tokens = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (global_batch, cfg.max_seq_len))
            ).to("cuda")
            st = {"model": model, "optimizer": opt, "step": 0}
            losses, grads = [], []
            for _ in range(TP_PARITY_STEPS):
                st, m = step(st, {"tokens": tokens})
                losses.append(m["loss"].item())
                grads.append(dict(_leaves(model.stacked_params(
                    lambda p: p.grad.clone()))))
            refs[global_batch] = (tokens, losses, dict(_leaves(
                model.stacked_params(lambda p: p.detach().clone()))), grads)
            del model, opt, step, st
        tokens, want_losses, want, want_grads = refs[global_batch]
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        mesh = topology.make_mesh(axes, device="cuda")
        state, step = make_sharded_train_step(cfg, mesh, global_batch,
                                              params=params, **kw)
        del params
        model = state["model"]
        losses, grads = [], []
        for _ in range(TP_PARITY_STEPS):
            state, m = step(state, {"tokens": tokens})
            losses.append(m["loss"].item())
            if not kw:      # ZeRO frees its gradients
                grads.append(dict(_leaves(gather_params(
                    cfg, model.stacked_params(lambda p: p.grad), mesh))))
        got = dict(_leaves(gather_params(cfg, model.stacked_params(),
                                         mesh)))
        res = {"losses": losses, "want_losses": want_losses,
               "max_abs_loss_err": max(abs(a - b) for a, b in
                                       zip(losses, want_losses)),
               "max_abs_param_err": max((got[k] - w).abs().max().item()
                                        for k, w in want.items()),
               "params_equal": all(torch.equal(got[k], w)
                                   for k, w in want.items()),
               "losses_equal": losses == want_losses}
        if grads:
            res["max_abs_grad_err"] = max(
                (g[k] - w).abs().max().item()
                for g, ws in zip(grads, want_grads) for k, w in ws.items())
            res["grads_equal"] = all(
                torch.equal(g[k], w)
                for g, ws in zip(grads, want_grads) for k, w in ws.items())
            keys = sorted(want)
            res.update(_adam_param_rule(
                [got[k] for k in keys], [want[k] for k in keys],
                [[g[k] for k in keys] for g in grads],
                [[w[k] for k in keys] for w in want_grads]))
        out["runs"][name] = res
        if name == "dp_tp":
            out["dp_tp_params"] = got
        elif name == "dp_tp_zero1":
            base = out.pop("dp_tp_params")
            res["params_equal_dp_tp"] = all(torch.equal(got[k], v)
                                            for k, v in base.items())
            res["losses_equal_dp_tp"] = losses == out["runs"]["dp_tp"][
                "losses"]
        del state, step, model, got
        torch.cuda.empty_cache()
    out.pop("dp_tp_params", None)
    out["n_params"] = sum(w.numel() for w in refs[TP_PARITY_ROWS][2].values())
    out["runs"]["bert_tp"] = _tp_bert_parity(world)
    bootstrap.shutdown()
    return out


def _tp_bert_parity(world: int) -> dict:
    """BERT MLM (full logits) at ``bert_base`` width, 2 layers, f32, on
    ``{"tp": world}`` (V 30522 padded at tp 4) against single-device
    ``bert.make_train_step`` from the same weights, corpus and masks
    (both draw them from the ``(seed, step)`` generator on the card)."""
    import torch
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM, gather_params, init_params, make_optimizer)
    cfg = _bert_config(n_layers=2, max_seq_len=TP_PARITY_SEQ,
                       dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = bert.synthetic_corpus(TP_PARITY_ROWS, TP_PARITY_SEQ,
                                   cfg.vocab_size, seed=0,
                                   device="cuda")["tokens"]
    ref = TransformerLM(cfg, params, device="cuda")
    ropt = make_optimizer(cfg, ref.parameters())
    rstep = bert.make_train_step(cfg, ref, ropt, seed=0)
    mesh = topology.make_mesh({"tp": world}, device="cuda")
    state, step = bert.make_sharded_train_step(cfg, mesh, TP_PARITY_ROWS,
                                               seed=0, params=params)
    del params
    rst = {"model": ref, "optimizer": ropt, "step": 0}
    losses, want_losses, grads, want_grads = [], [], [], []
    for _ in range(TP_PARITY_STEPS):
        rst, m = rstep(rst, {"tokens": tokens})
        want_losses.append(m["loss"].item())
        want_grads.append(dict(_leaves(ref.stacked_params(
            lambda p: p.grad.clone()))))
        state, m = step(state, {"tokens": tokens})
        losses.append(m["loss"].item())
        grads.append(dict(_leaves(gather_params(
            cfg, state["model"].stacked_params(lambda p: p.grad), mesh))))
    want = dict(_leaves(ref.stacked_params(lambda p: p.detach().clone())))
    got = dict(_leaves(gather_params(cfg, state["model"].stacked_params(),
                                     mesh)))
    keys = sorted(want)
    res = {"losses": losses, "want_losses": want_losses,
           "local_embed_rows": state["model"].embed.shape[0],
           "gathered_embed_shape": list(got["embed"].shape),
           "max_abs_loss_err": max(abs(a - b) for a, b in
                                   zip(losses, want_losses)),
           "max_abs_grad_err": max(
               (g[k] - w).abs().max().item()
               for g, ws in zip(grads, want_grads) for k, w in ws.items()),
           "max_abs_param_err": max((got[k] - want[k]).abs().max().item()
                                    for k in keys),
           "params_equal": all(torch.equal(got[k], want[k]) for k in keys),
           "losses_equal": losses == want_losses,
           "n_params": sum(want[k].numel() for k in keys)}
    res.update(_adam_param_rule(
        [got[k] for k in keys], [want[k] for k in keys],
        [[g[k] for k in keys] for g in grads],
        [[w[k] for k in keys] for w in want_grads]))
    del state, step, ref, rst
    torch.cuda.empty_cache()
    return res


def phase_tp_parity(state):
    """f32, TF32 off, 2 layers at ``transformer_big`` width: the tp step
    (and at four cards the dp×tp step and its ZeRO-1) against
    single-device ``make_train_step`` on the global batch. One card:
    ``torch.equal`` (the tp model at tp 1 rounds as the single-device
    one). Above one: ``dp_parity``'s rule — the loss and every step's
    gradients within DP_PARITY_TOL, the parameters by ``train_parity``'s
    rule; ZeRO-1 bitwise the dp×tp step of the same world."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(
        _tp_parity_rank, world, device="cuda", timeout=600,
        env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}).return_values
    problems = []
    for r in ranks:
        allowed = TRAIN_PARAM_FRAC * r["n_params"]
        for name, v in r["runs"].items():
            if name == "bert_tp":
                # dp_parity's rule at every world
                ok = (v["max_abs_loss_err"] <= DP_PARITY_TOL
                      and v["max_abs_grad_err"] <= DP_PARITY_TOL
                      and v["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                      and v["params_off_by_more_than_tol"]
                      <= TRAIN_PARAM_FRAC * v["n_params"])
            elif world == 1:
                ok = (v["params_equal"] and v["losses_equal"]
                      and v.get("grads_equal", True))
            elif name == "dp_tp_zero1":
                ok = v["params_equal_dp_tp"] and v["losses_equal_dp_tp"]
            else:
                ok = (v["max_abs_loss_err"] <= DP_PARITY_TOL
                      and v["max_abs_grad_err"] <= DP_PARITY_TOL
                      and v["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                      and v["params_off_by_more_than_tol"] <= allowed)
            if not ok:
                problems.append(f"rank {r['rank']} {name}: {v}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"world": world, "rule": ("torch.equal" if world == 1 else
                                     "dp_parity's"),
            "config": "transformer_big width, 2 layers, f32, full logits",
            "rows_per_data_shard": TP_PARITY_ROWS, "seq_len": TP_PARITY_SEQ,
            "steps": TP_PARITY_STEPS, "ranks": ranks}


def _tp_serve_rank() -> dict:
    """One rank of ``tp_serve``: ``InferenceEngine(mesh={"tp": world})``
    at ``transformer_big`` bf16 on the serve phase's prompts (tokens/s,
    #1's launches); in f32 at 2 layers, TF32 off, the greedy streams and
    one export's payload against the single-device engine on this
    rank's card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = topology.make_mesh({"tp": world}, device="cuda")
    plain = _plain_calls()
    cfg = TransformerConfig.transformer_big()           # bf16
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    num_blocks = SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1
    engine = InferenceEngine(cfg, params, mesh=mesh, num_blocks=num_blocks,
                             block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS)
    del params
    prompts, _ = _serve_prompts(cfg, SERVE_NEW)
    prompts = list(prompts.values())
    engine.generate([prompts[0][:16], prompts[1][:40]], max_new_tokens=2)
    prefills0 = engine.prefills
    torch.cuda.synchronize()
    zero_launch_counts()
    plain.clear()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    prefills = engine.prefills - prefills0
    acct = engine.block_accounting()
    pool_bytes = sum(a.numel() * a.element_size()
                     for a in engine.pool.values())
    out = {"rank": rank, "world": world, "launches": counts,
           "n_layers": cfg.n_layers,
           "plain_calls": dict(plain), "prefills": prefills,
           "wall_s": wall, "tokens": sum(len(o) for o in outs),
           "tokens_per_s": sum(len(o) for o in outs) / wall,
           "outputs": outs, "block_accounting": acct,
           "local_pool_bytes": pool_bytes,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del engine
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = TransformerConfig.transformer_big(n_layers=2,
                                              dtype=torch.float32)
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        1), device="cuda")
    kw = dict(num_blocks=num_blocks, block_size=SERVE_BLOCK,
              max_slots=SERVE_SLOTS)
    streams, payloads = {}, {}
    for tag, m in (("mesh", mesh), ("single", None)):
        eng = InferenceEngine(cfg32, params, mesh=m, device="cuda", **kw)
        streams[tag] = eng.generate(prompts[:PARITY_REQUESTS],
                                    max_new_tokens=PARITY_NEW)
        eng.submit(Request(id="m", tokens=tuple(prompts[0]),
                           max_new_tokens=PARITY_NEW))
        for _ in range(3):
            eng.step()
        seq = next(iter(eng.scheduler.running.values()))
        payloads[tag] = eng.export_sequence(seq)
        del eng
    a, b = payloads["mesh"], payloads["single"]
    n = a.length - 1            # the rows written so far
    out["f32"] = {
        "streams_equal": streams["mesh"] == streams["single"],
        "payload_bytes": [a.nbytes, b.nbytes],
        "payload_shapes_equal": all(
            a.arrays[k].shape == b.arrays[k].shape for k in b.arrays),
        "fingerprint_equal": a.fingerprint == b.fingerprint,
        "payload_kv_max_abs_err": max(
            (a.arrays[k][:, :n] - b.arrays[k][:, :n]).abs().max().item()
            for k in ("k", "v"))}
    bootstrap.shutdown()
    return out


def phase_tp_serve(state):
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(
        _tp_serve_rank, world, device="cuda", timeout=600).return_values
    problems = []
    for r in ranks:
        tag = f"rank {r['rank']}"
        want = expected_counts({"flash_fwd_tc": r["n_layers"]},
                               r["prefills"])
        if r["launches"] != want or not r["prefills"]:
            problems.append(f"{tag}: launches {r['launches']} != {want}")
        if r["plain_calls"]:
            problems.append(f"{tag}: plain versions ran: {r['plain_calls']}")
        if r["outputs"] != ranks[0]["outputs"] or any(
                len(o) != SERVE_NEW for o in r["outputs"]):
            problems.append(f"{tag}: streams differ from rank 0's")
        acct = r["block_accounting"]
        if not acct["conserved"] or acct["free"] != acct["usable"]:
            problems.append(f"{tag}: block accounting at idle: {acct}")
        f = r["f32"]
        if not (f["streams_equal"] and f["payload_shapes_equal"]
                and f["fingerprint_equal"]
                and f["payload_bytes"][0] == f["payload_bytes"][1]
                and f["payload_kv_max_abs_err"] <= PARITY_LOGIT_TOL):
            problems.append(f"{tag}: f32 against the single-device "
                            f"engine: {f}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["tp_serve_launches"] = ranks[0]["launches"]
    for r in ranks:
        r.pop("outputs")
    return {"world": world, "mesh": {"tp": world},
            "config": "transformer_big", "dtype": "bfloat16",
            "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
            "f32_layers": 2, "ranks": ranks}


# ---------------------------------------------------------------------------
# Pipeline parallelism (models/transformer.py make_pipelined_train_step)
# ---------------------------------------------------------------------------

def _pp_config(**kw):
    """``bench.py``'s ``transformer-pp`` row (``:635-665``) in the port:
    ``transformer_big`` at 1024 tokens in bf16 with the config's defaults
    (every layer checkpointed, the stacked layer tree the pipelined step
    requires), the full-logits head of JAX's pipelined step."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.transformer_big(**{"max_seq_len": 1024, **kw})


def pp_expected_launches(cfg, pp: int, schedule: str, n_micro: int) -> dict:
    """#1-#3 launched a step by one rank of a pp-``pp`` step: each of its
    ``n_layers / pp`` layers runs per microbatch one dq and one dk/dv
    and the flash forward once under autograd, again in the backward
    when remat recomputes it, and for 1F1B once more in the forward unit
    without autograd (JAX's body runs the stage forward, then
    ``jax.vjp`` of it)."""
    per_rank = cfg.n_layers // pp * n_micro
    fwd = (1 + cfg.remat) + (schedule != "gpipe")
    return {"flash_fwd_tc": fwd * per_rank, "flash_bwd_dq_tc": per_rank,
            "flash_bwd_dkv_tc": per_rank}


def _pp_run_name(mesh: str, schedule: str, kw: dict) -> str:
    tail = {"offload_activations": {True: "offload",
                                    "device": "offload_device"},
            "zero": {1: "zero1", 2: "zero2"}}
    for key, names in tail.items():
        if kw.get(key):
            return f"{mesh}_{names[kw[key]]}"
    return f"{mesh}_{schedule}"


def _pp_gathered_checksum(step) -> tuple:
    """The checksum (float64 sum) of the gathered parameters on this
    rank, and whether every rank's equals it."""
    import torch
    import torch.distributed as dist
    full = step.gather_params()
    total = torch.stack([t.double().sum() for t in
                         torch.utils._pytree.tree_leaves(full)]).sum()
    every = [torch.zeros_like(total) for _ in range(dist.get_world_size())]
    dist.all_gather(every, total)
    return total.item(), all(torch.equal(t, total) for t in every)


def _pp_train_rank(runs: dict) -> dict:
    """One rank of ``pp_train``: each mesh's runs (schedule, step kwargs)
    at the pp config, one warm-up and PP_STEPS timed steps each."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_pipelined_train_step)
    from distributed_tensorflow_tpu_torch.parallel.pipeline import (
        bubble_fraction)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    plain = _plain_calls()
    cfg = _pp_config()
    out = {"rank": rank, "world": world,
           "device": torch.cuda.get_device_name(), "runs": {}}
    for mesh_name, (axes, variants) in runs.items():
        mesh = topology.make_mesh(axes, device="cuda")
        pp, n_dp = axes.get("pp", 1), axes.get("dp", 1)
        global_batch = PP_ROWS * n_dp
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
        for schedule, kw in variants:
            name = _pp_run_name(mesh_name, schedule, kw)
            torch.cuda.empty_cache()
            state, step = make_pipelined_train_step(
                cfg, mesh, global_batch, PP_MICRO, seed=0,
                schedule=schedule, **kw)
            # the steps' peak, not the build's (the full parameters are
            # made on every rank before each keeps its stage's)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, {"tokens": tokens})          # warm-up
            losses = [m["loss"].item()]
            torch.cuda.synchronize()
            zero_launch_counts()
            plain.clear()
            step_ms = []
            for _ in range(PP_STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                state, m = step(state, {"tokens": tokens})
                e1.record()
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
                losses.append(m["loss"].item())
            counts = launch_counts()
            plain_calls = dict(plain)
            peak = torch.cuda.max_memory_allocated()
            checksum, agree = _pp_gathered_checksum(step)
            v = kw.get("interleave", 1) if schedule == "interleaved" else 1
            mean_s = float(np.mean(step_ms)) / 1e3
            out["runs"][name] = {
                "mesh": axes, "schedule": schedule,
                "kwargs": {k: str(x) for k, x in kw.items()},
                "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
                "tokens_per_s": global_batch * cfg.max_seq_len / mean_s,
                "bubble_analytic": bubble_fraction(pp, PP_MICRO, schedule,
                                                   interleave=v),
                "losses": losses, "launches": counts,
                "launches_per_step": {k: c / PP_STEPS for k, c in
                                      counts.items() if c},
                "expected_per_step": pp_expected_launches(
                    cfg, pp, schedule, PP_MICRO),
                "plain_calls": plain_calls, "p2p": step.last_stats["p2p"],
                "offload": step.last_stats["offload"],
                "local_params": sum(p.numel() for p in
                                    state["model"].parameters()),
                "peak_mem_bytes": peak,
                "param_checksum": checksum, "ranks_agree": agree}
            del state, step, m
            gc.collect()
        del tokens
    bootstrap.shutdown()
    return out


def _pp_base(name: str, base: dict) -> dict:
    """The pp-1 run a pipelined run's bubble is measured against: the same
    schedule at one card, 1F1B for the offload and ZeRO variants."""
    schedule = name.split("_", 1)[1]
    return base.get(f"pp1_{schedule}", base["pp1_1f1b"])


def phase_pp_train(state):
    """``pp_train``: the pp config's runs at one card (pp 1: each
    schedule, the bubble's base), then at four cards (pp4 and dp2×pp2)
    when four are visible; each run's launches, P2P, memory and the
    measured bubble ``1 − T(pp1) / (pp · T(pp))``: with one card a
    stage the ideal step is the pp-1 step over pp."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    worlds = [1] + ([world] if world in PP_RUNS and world > 1 else [])
    spawns = [multi_process_runner.run(
        _pp_train_rank, n, args=(PP_RUNS[n],), device="cuda",
        timeout=900).return_values for n in worlds]
    problems = []
    for ranks in spawns:
        for r in ranks:
            for name, v in r["runs"].items():
                tag = f"rank {r['rank']} of {r['world']} {name}"
                want = expected_counts(v["expected_per_step"], PP_STEPS)
                if v["launches"] != want:
                    problems.append(f"{tag}: launches {v['launches']} != "
                                    f"{want}")
                if v["plain_calls"]:
                    problems.append(f"{tag}: plain versions ran: "
                                    f"{v['plain_calls']}")
                if not all(math.isfinite(x) for x in v["losses"]) or \
                        not v["losses"][-1] < v["losses"][0]:
                    problems.append(f"{tag}: losses do not fall: "
                                    f"{v['losses']}")
                if v["losses"] != ranks[0]["runs"][name]["losses"]:
                    problems.append(f"{tag}: loss differs from rank 0's")
                if not v["ranks_agree"]:
                    problems.append(f"{tag}: gathered parameters differ")
    if problems:
        raise AssertionError("; ".join(problems))
    base = spawns[0][0]["runs"]
    summary = {}
    for ranks in spawns:
        for name, v in ranks[0]["runs"].items():
            pp = v["mesh"].get("pp", 1)
            t1 = _pp_base(name, base)["step_ms_mean"]
            summary[name] = {
                "step_ms_mean": v["step_ms_mean"],
                "step_ms_ranks": [r["runs"][name]["step_ms_mean"]
                                  for r in ranks],
                "tokens_per_s": v["tokens_per_s"],
                "bubble_analytic": v["bubble_analytic"],
                "bubble_measured": (1 - t1 / (pp * v["step_ms_mean"])
                                    if pp > 1 else 0.0),
                "p2p_per_step_ranks": [r["runs"][name]["p2p"]
                                       for r in ranks],
                "peak_mem_bytes_ranks": [r["runs"][name]["peak_mem_bytes"]
                                         for r in ranks],
                "spilled_bytes_ranks": [
                    (r["runs"][name]["offload"] or {}).get("spilled_bytes")
                    for r in ranks],
                "launches_per_step": v["launches_per_step"],
                "losses": v["losses"]}
    # rank 0's launches over each run's timed steps
    state["pp_launches"] = {name: v["launches"] for ranks in spawns
                            for name, v in ranks[0]["runs"].items()}
    return {"world": world, "config": "transformer_big, 1024 tokens, "
            "bf16, remat, full-logits head (bench.py transformer-pp)",
            "rows_per_data_shard": PP_ROWS, "microbatches": PP_MICRO,
            "steps": PP_STEPS, "summary": summary,
            "ranks": [r for ranks in spawns for r in ranks]}


def _flat_leaves(tree) -> list:
    """A parameter (or gradient) dict's leaves in one fixed order."""
    import torch
    return torch.utils._pytree.tree_leaves(tree)


def _pp_parity_reference(cfg, params, tokens, n_micro: int = 1,
                         n_shards: int = 1) -> tuple:
    """Single-device AdamW steps on ``tokens`` from ``params``:
    ``make_train_step`` on the whole batch (the defaults), or each of
    ``n_shards`` data shards' gradients accumulated over its rows of
    ``n_micro`` microbatches (each loss over ``n_micro``), then the
    shards' sum over ``n_shards`` (the pipelined step's dp mean) before
    ``AdamW.step``. Each step's loss and gradients, and the parameters
    after the last."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM, make_loss_fn, make_optimizer, make_train_step)
    model = TransformerLM(cfg, params, device="cuda")
    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(cfg, model, opt)
    loss_fn = make_loss_fn(cfg, model)
    mb = tokens.shape[0] // n_micro
    rows = mb // n_shards
    st = {"model": model, "step": 0}
    losses, grads = [], []
    for _ in range(PP_PARITY_STEPS):
        if n_micro == n_shards == 1:
            st, m = step(st, {"tokens": tokens})
            losses.append(m["loss"].item())
        else:
            shard_grads, total = [], 0.0
            for d in range(n_shards):
                opt.zero_grad(set_to_none=True)
                for i in range(n_micro):
                    lo = i * mb + d * rows
                    loss = loss_fn(tokens[lo:lo + rows]) / n_micro
                    loss.backward()
                    total += loss.item() / n_shards
                shard_grads.append([p.grad for p in model.parameters()])
            for p, *gs in zip(model.parameters(), *shard_grads):
                p.grad = sum(gs[1:], gs[0]) / n_shards
            opt.step()
            losses.append(total)
        grads.append([g.clone() for g in _flat_leaves(
            model.stacked_params(lambda p: p.grad))])
    return losses, grads, [p.detach().clone() for p in _flat_leaves(
        model.stacked_params())]


def _pp_parity_rank(runs: dict) -> dict:
    """One rank of ``pp_parity``: each mesh's runs against single-device
    ``make_train_step`` on the same global batch from the same weights
    (f32, TF32 off, deterministic), PP_PARITY_STEPS steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, init_params,
        make_optimizer, make_pipelined_train_step, make_train_step)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = TransformerConfig.transformer_big(
        n_layers=PP_PARITY_LAYERS, max_seq_len=PP_PARITY_SEQ,
        dtype=torch.float32, loss_impl="scan")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    for t in _flat_leaves(params):
        dist.broadcast(t, src=0)
    out = {"rank": rank, "world": world, "runs": {}}
    finals = {}
    for mesh_name, (axes, variants) in runs.items():
        mesh = topology.make_mesh(axes, device="cuda")
        global_batch = PP_PARITY_ROWS * axes.get("dp", 1)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
        want_losses, want_grads, want = _pp_parity_reference(
            cfg, params, tokens)
        acc_losses, acc_grads, acc = _pp_parity_reference(
            cfg, params, tokens, PP_PARITY_MICRO, axes.get("dp", 1))
        # the microbatching's own spread: accumulation against the step
        acc_rule = _adam_param_rule(acc, want, acc_grads, want_grads)
        out.setdefault("accum_vs_step", {})[mesh_name] = acc_rule
        for schedule, kw in variants:
            name = _pp_run_name(mesh_name, schedule, kw)
            if schedule == "interleaved":
                name += f"_v{kw['interleave']}"
            state, step = make_pipelined_train_step(
                cfg, mesh, global_batch, PP_PARITY_MICRO,
                schedule=schedule, params=params, **kw)
            losses, grads = [], []
            for _ in range(PP_PARITY_STEPS):
                state, m = step(state, {"tokens": tokens})
                losses.append(m["loss"].item())
                grads.append(_flat_leaves(step.gather_params(
                    lambda p: p.grad)))
            got = _flat_leaves(step.gather_params())
            finals[name] = (losses, got)
            res = {"losses": losses}
            for ref, (r_losses, r_grads, r_params) in (
                    ("step", (want_losses, want_grads, want)),
                    ("accum", (acc_losses, acc_grads, acc))):
                res[ref] = {
                    "max_abs_loss_err": max(abs(a - b) for a, b in
                                            zip(losses, r_losses)),
                    "max_abs_grad_err": max(
                        (g - w).abs().max().item() for gs, ws in
                        zip(grads, r_grads) for g, w in zip(gs, ws)),
                    "max_abs_param_err": max(
                        (g - w).abs().max().item()
                        for g, w in zip(got, r_params)),
                    **_adam_param_rule(got, r_params, grads, r_grads)}
            res["step"]["allowed_beyond_tol"] = (
                acc_rule["params_off_by_more_than_tol"])
            out["runs"][name] = res
            del state, step
            torch.cuda.empty_cache()
    out["n_params"] = sum(t.numel() for t in _flat_leaves(params))
    out["bitwise"] = {}
    for a, b in PP_PARITY_BITWISE:
        for mesh_name in runs:
            ka, kb = f"{mesh_name}_{a}", f"{mesh_name}_{b}"
            if ka in finals and kb in finals:
                (la, pa), (lb, pb) = finals[ka], finals[kb]
                out["bitwise"][f"{ka}=={kb}"] = la == lb and all(
                    torch.equal(x, y) for x, y in zip(pa, pb))
    bootstrap.shutdown()
    return out


def phase_pp_parity(state):
    """``pp_parity``: at one card the pp-1 runs, then at four cards pp4
    and dp2×pp2 when four are visible; losses and gradients within
    PP_PARITY_TOL of the single-device step, parameters by
    ``train_parity``'s rule, the offload arms and interleaved v=1
    against 1F1B bitwise."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    ranks = multi_process_runner.run(
        _pp_parity_rank, 1, args=(PP_PARITY_RUNS[1],), device="cuda",
        timeout=600, env=env).return_values
    if world in PP_PARITY_RUNS and world > 1:
        ranks += multi_process_runner.run(
            _pp_parity_rank, world, args=(PP_PARITY_RUNS[world],),
            device="cuda", timeout=600, env=env).return_values
    problems = _pp_parity_problems(ranks)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"world": world, "config": "transformer_big width, "
            f"{PP_PARITY_LAYERS} layers, f32, full logits",
            "rows_per_data_shard": PP_PARITY_ROWS, "seq_len": PP_PARITY_SEQ,
            "microbatches": PP_PARITY_MICRO, "steps": PP_PARITY_STEPS,
            "ranks": ranks}


def _pp_parity_problems(ranks) -> list:
    """:func:`_pp_parity_rank` results against pp_parity's rule."""
    problems = []
    for r in ranks:
        allowed = TRAIN_PARAM_FRAC * r["n_params"]
        for name, v in r["runs"].items():
            ok = all(v[ref]["max_abs_loss_err"] <= PP_PARITY_TOL
                     and v[ref]["max_abs_grad_err"] <= PP_PARITY_TOL
                     and v[ref]["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                     for ref in ("step", "accum"))
            # dp_parity's rule against the same microbatches; against
            # the whole-batch step the microbatching's own spread more
            ok = ok and v["accum"]["params_off_by_more_than_tol"] <= allowed
            ok = ok and v["step"]["params_off_by_more_than_tol"] <= (
                v["step"]["allowed_beyond_tol"] + allowed)
            if not ok:
                problems.append(f"rank {r['rank']} of {r['world']} {name}: "
                                f"{v}")
        for pair, ok in r["bitwise"].items():
            if not ok:
                problems.append(f"rank {r['rank']} of {r['world']} {pair}: "
                                f"not bitwise")
    return problems


def phase_pp_kernels(state):
    """#1-#3 at the pipelined step's microbatch, ``(1, 16, 1024, 64)``
    bf16 causal (one row a microbatch), against their plain versions,
    with their bounds and SDPA (the "at pp" rows)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(13)
    state["pp_rows"] = _attention_rows(PP_ROWS // PP_MICRO, 16, gen)
    return {"attention": state["pp_rows"]}


# ---------------------------------------------------------------------------
# Sequence parallelism (parallel/sequence_parallel.py)
# ---------------------------------------------------------------------------

def _sp_layout(t, n: int, schedule: str) -> list:
    """``t``'s ``n`` sequence chunks as the ranks of ``schedule`` hold
    them: contiguous, or (striped) rank r's positions r, r + n, ..."""
    from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
        stripe_layout)
    if schedule == "striped":
        t = stripe_layout(t, n)
    return [c.contiguous() for c in t.chunk(n, dim=2)]


def _sp_whole(chunks: list, n: int, schedule: str):
    """The inverse of :func:`_sp_layout`: the whole sequence."""
    import torch
    from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
        unstripe_layout)
    t = torch.cat(chunks, dim=2)
    return unstripe_layout(t, n) if schedule == "striped" else t


def _sp_block_mask(schedule: str, causal: bool, src: int, me: int):
    """The block's masking ``(launched, causal, causal_offset)``: the
    contiguous ring skips a future chunk under ``causal``; striped is
    causal at offset −1 where ``src > me``, else 0."""
    if schedule == "striped":
        return True, True, -1 if src > me else 0
    if causal and src > me:
        return False, True, 0
    return True, causal and src == me, 0


def _virtual_ring(q, k, v, do, n: int, schedule: str, causal: bool,
                  check: bool) -> dict:
    """A whole ring's blocks in this process, over ``n`` virtual ranks:
    the port's step-block functions for each ``(me, src)``, merged by
    its ``_combine_stats``, then each rank's backward blocks against
    the merged (global) ``(o, lse)`` with ``delta`` computed once, dk/dv
    summed at their owners. With ``check`` each launched block's ``(o,
    lse)`` and ``(dq, dk, dv)`` are held against the plain versions on
    the same inputs, and the rows that see no key must come out ``o =
    0``, ``lse = +inf``. Returns the whole-sequence ``o``, ``lse``,
    ``(dq, dk, dv)``, the launches of each pass and the block errors."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd_plain)
    from distributed_tensorflow_tpu_torch.parallel import (
        sequence_parallel as sp)
    sm = q.shape[-1] ** -0.5
    fwd, bwd = sp.block_functions(
        "striped" if schedule == "striped" else "contiguous", causal, sm)
    qs, ks, vs, dos = (_sp_layout(t, n, schedule) for t in (q, k, v, do))
    kvs = [torch.stack((ks[s], vs[s])) for s in range(n)]
    dt = str(q.dtype).replace("torch.", "")
    errs = {"fwd": [], "bwd": []}
    problems = []
    before = launch_counts()
    outs = []
    for me in range(n):
        o_acc = lse_acc = None
        for step in range(n):
            src = (me - step) % n
            launched, blk_causal, off = _sp_block_mask(schedule, causal,
                                                       src, me)
            o_b, lse_b = fwd(qs[me], kvs[src], src, me)
            if check and launched:
                e = _fwd_errors(qs[me], ks[src], vs[src], o_b, lse_b,
                                blk_causal, off)
                errs["fwd"].append({"me": me, "src": src, "offset": off,
                                    "causal": blk_causal, **e})
                if not e["ok"]:
                    problems.append(f"fwd block ({me}, {src}): {e}")
                if off == -1 and not (bool(torch.isposinf(
                        lse_b[..., 0]).all()) and bool(
                        (o_b[..., 0, :] == 0).all())):
                    problems.append(f"block ({me}, {src}) at offset -1: "
                                    f"row 0 not o = 0, lse = +inf")
            if not launched and not (bool(torch.isneginf(lse_b).all())
                                     and bool((o_b == 0).all())):
                problems.append(f"skipped block ({me}, {src}) not "
                                f"o = 0, lse = -inf")
            if step == 0:
                o_acc = o_b.float()
                lse_acc = torch.where(torch.isposinf(lse_b),
                                      float("-inf"), lse_b)
            else:
                o_acc, lse_acc = sp._combine_stats(o_acc, lse_acc, o_b,
                                                   lse_b)
        outs.append((o_acc.to(q.dtype), lse_acc))
    mid = launch_counts()
    dq = [torch.zeros(t.shape, device=t.device) for t in qs]
    dk = [torch.zeros(t.shape, device=t.device) for t in ks]
    dv = [torch.zeros(t.shape, device=t.device) for t in vs]
    for me in range(n):
        o, lse = outs[me]
        delta = (o.float() * dos[me].float()).sum(-1)
        for step in range(n):
            src = (me - step) % n
            launched, blk_causal, off = _sp_block_mask(schedule, causal,
                                                       src, me)
            g = bwd(qs[me], kvs[src], src, me, o, lse, dos[me], delta)
            if (g is None) == launched:
                problems.append(f"bwd block ({me}, {src}): launched "
                                f"{g is not None}, expected {launched}")
            if g is None:
                continue
            if check:
                want = flash_attention_bwd_plain(
                    qs[me], ks[src], vs[src], o, lse, dos[me],
                    causal=blk_causal, sm_scale=sm, causal_offset=off,
                    delta=delta)
                e = {f"d{x}": rel_err(a, b) for x, a, b in
                     zip("qkv", g, want)}
                errs["bwd"].append({"me": me, "src": src, "offset": off,
                                    "causal": blk_causal, **e})
                if max(e.values()) > GRAD_TOL[dt]:
                    problems.append(f"bwd block ({me}, {src}): {e}")
                del want
            dq[me] += g[0].float()
            dk[src] += g[1].float()
            dv[src] += g[2].float()
    after = launch_counts()
    return {"o": _sp_whole([o for o, _ in outs], n, schedule),
            "lse": _sp_whole([lse[..., None] for _, lse in outs], n,
                             schedule)[..., 0],
            "grads": [_sp_whole([t.to(q.dtype) for t in g], n, schedule)
                      for g in (dq, dk, dv)],
            "fwd_launches": {x: mid[x] - before[x] for x in mid
                             if mid[x] != before[x]},
            "bwd_launches": {x: after[x] - mid[x] for x in after
                             if after[x] != mid[x]},
            "errors": errs, "problems": problems}


def _sp_rank_times(q, k, v, do, n: int, schedule: str) -> dict:
    """Each virtual rank's kernel time for its blocks of one attention
    call (the forward's, then the backward's), timed with CUDA events
    at the block shape, and the load imbalance: the slowest rank's time
    over the ranks' mean (the ring waits for its slowest rank)."""
    import torch
    from distributed_tensorflow_tpu_torch.parallel import (
        sequence_parallel as sp)
    fwd, bwd = sp.block_functions(
        "striped" if schedule == "striped" else "contiguous", True,
        q.shape[-1] ** -0.5)
    qs, ks, vs, dos = (_sp_layout(t, n, schedule) for t in (q, k, v, do))
    kvs = [torch.stack((ks[s], vs[s])) for s in range(n)]
    lse = torch.zeros(qs[0].shape[:3], device=q.device)
    delta = torch.zeros_like(lse)
    out = {"fwd_ms": [], "bwd_ms": []}
    for me in range(n):
        srcs = [(me - step) % n for step in range(n)]
        out["fwd_ms"].append(time_ms(lambda: [fwd(qs[me], kvs[s], s, me)
                                              for s in srcs], 10))
        out["bwd_ms"].append(time_ms(lambda: [
            bwd(qs[me], kvs[s], s, me, qs[me], lse, dos[me], delta)
            for s in srcs], 10))
    for key in ("fwd_ms", "bwd_ms"):
        t = out[key]
        out[key.replace("_ms", "_imbalance")] = max(t) / (sum(t) / n)
    return out


def _sp_block_rows(gen) -> dict:
    """#1-#3 at the ring's block shape ``SP_BLOCK`` bf16, for each kind
    of block the ring launches: the diagonal (causal, offset 0), a past
    chunk (full) and striped's strict block (causal, offset −1): each
    against its plain version in turns, with its bound and SDPA on the
    same block (forward; backward alone; the strict block through a
    boolean mask)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain, launch_bwd_dkv, launch_bwd_dq)
    F = torch.nn.functional
    bf = torch.bfloat16
    q, k, v, do = (_rand(SP_BLOCK, bf, gen) for _ in range(4))
    sm = q.shape[-1] ** -0.5
    s = q.shape[2]
    rows = {"flash_fwd_tc": {}, "flash_bwd_dq_tc": {},
            "flash_bwd_dkv_tc": {}}
    for kind, (causal, off) in SP_BLOCK_KINDS.items():
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm,
                                     causal_offset=off)
        fwd = _fwd_errors(q, k, v, o, lse, causal, off)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm, causal_offset=off)
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(sm_scale=sm, causal=causal, causal_offset=off)
        got = (launch_bwd_dq(q, k, v, do, lse, delta, **kw),
               *launch_bwd_dkv(q, k, v, do, lse, delta, **kw))
        errs = {f"d{x}": rel_err(a, b) for x, a, b in zip("qkv", got, want)}
        if not fwd["ok"] or max(errs.values()) > GRAD_TOL["bfloat16"]:
            raise AssertionError(f"sp block {kind}: {fwd} {errs}")
        mask = (None if causal is False or off == 0 else
                torch.ones(s, s, dtype=torch.bool,
                           device="cuda").tril(off))
        sdpa_kw = (dict(is_causal=causal) if mask is None
                   else dict(attn_mask=mask))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=sm, **sdpa_kw), 10)
        t = in_turns(lambda: flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=sm, causal_offset=off),
            lambda: flash_attention_plain(q, k, v, causal=causal,
                                          sm_scale=sm, causal_offset=off),
            5)
        flops, nbytes = attention_work(q, k, causal, off, "fwd")
        rows["flash_fwd_tc"][kind] = {
            **_flash_row(t, flops, nbytes, bf, fwd["o_err"], lib, q.shape),
            "causal": causal, "causal_offset": off,
            "masked_rows": fwd["masked_rows"],
            "library": "scaled_dot_product_attention" + (
                "" if mask is None else " (boolean mask)")}
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ref = F.scaled_dot_product_attention(*leaves, scale=sm, **sdpa_kw)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            ref, leaves, do, retain_graph=True), 5)
        del ref, leaves

        def plain():
            flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                      sm_scale=sm, causal_offset=off)
        for op, fn, err in (
                ("dq", launch_bwd_dq, abs_err(got[0], want[0])),
                ("dkv", launch_bwd_dkv, max(abs_err(got[1], want[1]),
                                            abs_err(got[2], want[2])))):
            t = in_turns(lambda: fn(q, k, v, do, lse, delta, **kw), plain,
                         5)
            flops, nbytes = attention_work(q, k, causal, off, op)
            rows[f"flash_bwd_{op}_tc"][kind] = {
                **_flash_row(t, flops, nbytes, bf, err, lib_bwd, q.shape),
                "causal": causal, "causal_offset": off, "rel_err": errs,
                "library": "scaled_dot_product_attention backward "
                           "(dq, dk, dv)"}
        del want, got
        torch.cuda.empty_cache()
    return rows


def phase_sp_kernels(state):
    """``sp_kernels``: the ring's own block calls at full width, in one
    process over SP_N virtual ranks — ``transformer_big``'s attention of
    a 32,768-token sequence at sp 4 (blocks ``SP_BLOCK``, bf16): every
    block of the contiguous causal ring, the non-causal ring and the
    striped ring (offsets 0 and −1) against the plain versions, the
    merged rings against whole-sequence flash (#1-#3 over 32,768
    tokens), the same at f32 and ``SP_F32_BLOCK`` against
    ``mha_reference``; each rank's block time (the imbalance of
    contiguous against striped), and #1-#3 timed at each block kind
    against SDPA (the "at sp" rows)."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd, mha_reference)
    from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
        attention_blocks)
    gen = torch.Generator(device="cuda").manual_seed(14)
    n = SP_N
    b, h, s, d = SP_BLOCK
    out = {"block": list(SP_BLOCK), "n": n, "rings": {}}
    problems = []
    whole = (b, h, s * n, d)
    for dtype, shape in ((torch.bfloat16, whole),
                         (torch.float32, (SP_F32_BLOCK[0], SP_F32_BLOCK[1],
                                          SP_F32_BLOCK[2] * n,
                                          SP_F32_BLOCK[3]))):
        dt = str(dtype).replace("torch.", "")
        q, k, v, do = (_rand(shape, dtype, gen) for _ in range(4))
        refs = {}
        for causal in (True, False):
            if dtype == torch.bfloat16:
                o, lse = flash_attention_fwd(q, k, v, causal=causal)
                refs[causal] = (o, lse, flash_attention_bwd(
                    q, k, v, o, lse, do, causal=causal))
            else:
                leaves = [x.detach().clone().requires_grad_()
                          for x in (q, k, v)]
                o = mha_reference(*leaves, causal=causal)
                refs[causal] = (o.detach(), None, torch.autograd.grad(
                    o, leaves, do))
        for schedule, causal in (("ring", True), ("ring", False),
                                 ("striped", True)):
            name = f"{dt}_{schedule}_{'causal' if causal else 'full'}"
            r = _virtual_ring(q, k, v, do, n, schedule, causal,
                              check=dtype == torch.bfloat16)
            problems += [f"{name}: {p}" for p in r["problems"]]
            want_o, want_lse, want_g = refs[causal]
            res = {"o_err": abs_err(r["o"], want_o),
                   "grad_rel_err": {f"d{x}": rel_err(a, w) for x, a, w in
                                    zip("qkv", r["grads"], want_g)},
                   "fwd_launches": r["fwd_launches"],
                   "bwd_launches": r["bwd_launches"]}
            if want_lse is not None:
                res["lse_err"] = abs_err(r["lse"], want_lse)
            want_blocks = sum(attention_blocks(
                "striped" if schedule == "striped" else "ring", n, me,
                causal) for me in range(n))
            fwd_name = _route_name(dtype, d, "fwd")
            if r["fwd_launches"] != {fwd_name: want_blocks} or \
                    r["bwd_launches"] != {_route_name(dtype, d, "dq"):
                                          want_blocks,
                                          _route_name(dtype, d, "dkv"):
                                          want_blocks}:
                problems.append(f"{name}: launches {r['fwd_launches']} "
                                f"{r['bwd_launches']}, expected "
                                f"{want_blocks} blocks each")
            tol = TOL[dt]
            if res["o_err"] > tol["o"] or res.get("lse_err", 0) > \
                    tol["lse"] or max(res["grad_rel_err"].values()) > \
                    GRAD_TOL[dt] or not bool(torch.isfinite(r["o"]).all()):
                problems.append(f"{name}: merged ring against the whole "
                                f"sequence: {res}")
            if r["errors"]["fwd"]:
                res["block_o_err_max"] = max(e["o_err"] for e in
                                             r["errors"]["fwd"])
                res["block_grad_rel_err_max"] = max(
                    max(e["dq"], e["dk"], e["dv"])
                    for e in r["errors"]["bwd"])
                res["blocks_checked"] = [len(r["errors"]["fwd"]),
                                         len(r["errors"]["bwd"])]
                res["rows_without_key"] = sum(
                    e["masked_rows"] for e in r["errors"]["fwd"])
            out["rings"][name] = res
            del r
        del q, k, v, do, refs
        torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    q, k, v, do = (_rand(whole, torch.bfloat16, gen) for _ in range(4))
    out["rank_times"] = {sch: _sp_rank_times(q, k, v, do, n, sch)
                         for sch in ("ring", "striped")}
    del q, k, v, do
    torch.cuda.empty_cache()
    state["sp_rows"] = _sp_block_rows(gen)
    out["attention"] = state["sp_rows"]
    return out


def _sp_config(seq: int, **kw):
    """``transformer_big`` at ``seq`` tokens in bf16, remat (the config's
    "nothing"), kernel cross-entropy, bf16 first moment."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.transformer_big(
        max_seq_len=seq, loss_impl="kernel", adam_mu_dtype=torch.bfloat16,
        **kw)


def sp_expected_launches(cfg, axes: dict, sp_index: int, rows: int
                         ) -> dict:
    """A rank's kernels a step: per layer and attention pass its ring's
    #1 blocks (``attention_blocks``: contiguous causal ``index + 1``,
    striped ``n``, Ulysses 1; one flash call at sp 1), the forward twice
    under remat "nothing" (the recompute), #2 and #3 once a block; the
    CE kernels once a 4096-row chunk of its ``rows · S/sp`` tokens."""
    from distributed_tensorflow_tpu_torch.ops.fused_ce import ROW_CHUNK
    from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
        attention_blocks)
    n = axes.get("sp", 1)
    blocks = (attention_blocks(cfg.sp_impl, n, sp_index, cfg.causal)
              if n > 1 else 1) * cfg.n_layers
    tokens = rows * cfg.max_seq_len // n
    chunks = (tokens // ROW_CHUNK if tokens > ROW_CHUNK
              and tokens % ROW_CHUNK == 0 else 1)
    return {"flash_fwd_tc": blocks * (1 + cfg.remat),
            "flash_bwd_dq_tc": blocks, "flash_bwd_dkv_tc": blocks,
            "fused_ce_fwd_tc": chunks, "fused_ce_bwd_tc": chunks}


def _sp_train_rank(runs: dict) -> dict:
    """One rank of ``sp_train``: each run (mesh, sequence, global batch,
    config kwargs) at the sp config, one warm-up and SP_STEPS timed
    steps."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_sharded_train_step)
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        RingExchange)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    plain = _plain_calls()
    out = {"rank": rank, "world": world,
           "device": torch.cuda.get_device_name(), "runs": {}}
    for name, (axes, seq, global_batch, kw) in runs.items():
        mesh = topology.make_mesh(axes, device="cuda")
        cfg = _sp_config(seq, **kw)
        seq = cfg.max_seq_len
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (global_batch, seq))).to("cuda")
        torch.cuda.empty_cache()
        state, step = make_sharded_train_step(cfg, mesh, global_batch,
                                              seed=0)
        # the steps' peak, not the build's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, {"tokens": tokens})              # warm-up
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        zero_launch_counts()
        plain.clear()
        sends = (RingExchange.sends, RingExchange.bytes)
        step_ms = []
        for _ in range(SP_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, {"tokens": tokens})
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            losses.append(m["loss"].item())
        counts = launch_counts()
        plain_calls = dict(plain)
        peak = torch.cuda.max_memory_allocated()
        index = topology.sp_index(mesh)
        rows = global_batch // topology.mesh_axis_size(
            mesh, *topology.data_axes(mesh))
        checksum, agree = _gathered_checksum(cfg, state["model"], mesh)
        mean_s = float(np.mean(step_ms)) / 1e3
        out["runs"][name] = {
            "mesh": axes, "seq_len": seq, "global_batch": global_batch,
            "sp_impl": cfg.sp_impl, "sp_index": index,
            "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
            "tokens_per_s": global_batch * seq / mean_s,
            "losses": losses, "launches": counts,
            "launches_per_step": {x: c / SP_STEPS for x, c in
                                  counts.items() if c},
            "expected_per_step": sp_expected_launches(cfg, axes, index,
                                                      rows),
            "ring_sends_per_step": (RingExchange.sends - sends[0])
            / SP_STEPS,
            "ring_bytes_per_step": (RingExchange.bytes - sends[1])
            / SP_STEPS,
            "plain_calls": plain_calls, "peak_mem_bytes": peak,
            "param_checksum": checksum, "ranks_agree": agree}
        del state, step, m, tokens
        gc.collect()
    bootstrap.shutdown()
    return out


def phase_sp_train(state):
    """``sp_train``: the sp config at one card (``{"sp": 1}``, 8,192
    tokens: the plain flash path, as JAX takes at sp 1), then at four
    cards sp4 under each ``sp_impl``, dp2×sp2 and sp2×tp2 when four are
    visible (every rank holds 8,192 tokens); each rank's launches
    against ``sp_expected_launches``, no plain version, the ring's sends
    and bytes, step ms, tokens/s and peak memory; the loss falls, equal
    on every rank, and the gathered parameters agree. The imbalance of
    contiguous against striped: each rank's #1 blocks a layer a pass,
    and the two sp4 steps' times."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    worlds = [1] + ([world] if world in SP_RUNS and world > 1 else [])
    spawns = [multi_process_runner.run(
        _sp_train_rank, w, args=(SP_RUNS[w],), device="cuda",
        timeout=900).return_values for w in worlds]
    problems = []
    for ranks in spawns:
        for r in ranks:
            for name, v in r["runs"].items():
                tag = f"rank {r['rank']} of {r['world']} {name}"
                want = expected_counts(v["expected_per_step"], SP_STEPS)
                if v["launches"] != want:
                    problems.append(f"{tag}: launches {v['launches']} != "
                                    f"{want}")
                if v["plain_calls"]:
                    problems.append(f"{tag}: plain versions ran: "
                                    f"{v['plain_calls']}")
                if not all(math.isfinite(x) for x in v["losses"]) or \
                        not v["losses"][-1] < v["losses"][0]:
                    problems.append(f"{tag}: losses do not fall: "
                                    f"{v['losses']}")
                if v["losses"] != ranks[0]["runs"][name]["losses"]:
                    problems.append(f"{tag}: loss differs from rank 0's")
                if not v["ranks_agree"]:
                    problems.append(f"{tag}: gathered parameters differ")
    if problems:
        raise AssertionError("; ".join(problems))
    summary = {}
    for ranks in spawns:
        for name, v in ranks[0]["runs"].items():
            blocks = [r["runs"][name]["expected_per_step"]["flash_bwd_dq_tc"]
                      for r in ranks]
            summary[name] = {
                "mesh": v["mesh"], "seq_len": v["seq_len"],
                "step_ms_mean": v["step_ms_mean"],
                "tokens_per_s": v["tokens_per_s"],
                "tokens_per_s_per_card": v["tokens_per_s"] / len(ranks),
                "launches_per_step_ranks": [r["runs"][name][
                    "launches_per_step"] for r in ranks],
                "ring_sends_per_step_ranks": [r["runs"][name][
                    "ring_sends_per_step"] for r in ranks],
                "ring_bytes_per_step_ranks": [r["runs"][name][
                    "ring_bytes_per_step"] for r in ranks],
                "attention_blocks_imbalance": max(blocks) / (
                    sum(blocks) / len(blocks)),
                "peak_mem_bytes_ranks": [r["runs"][name]["peak_mem_bytes"]
                                         for r in ranks],
                "losses": v["losses"]}
    if "sp4_ring" in summary and "sp4_striped" in summary:
        summary["contiguous_over_striped_step"] = (
            summary["sp4_ring"]["step_ms_mean"]
            / summary["sp4_striped"]["step_ms_mean"])
    # rank 0's launches over each run's timed steps
    state["sp_launches"] = {name: v["launches"] for ranks in spawns
                            for name, v in ranks[0]["runs"].items()}
    return {"world": world, "config": "transformer_big, bf16, remat, "
            "kernel CE, bf16 mu; 8,192 tokens a rank", "steps": SP_STEPS,
            "summary": summary,
            "ranks": [r for ranks in spawns for r in ranks]}


def _sp_parity_rank(runs: dict) -> dict:
    """One rank of ``sp_parity``: each run against single-device
    ``make_train_step`` on the same global batch from the same weights
    (f32, TF32 off, deterministic), PP_PARITY_STEPS steps: losses, the
    gathered gradients and parameters."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, gather_params, init_params,
        make_sharded_train_step)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = TransformerConfig.transformer_big(
        n_layers=PP_PARITY_LAYERS, max_seq_len=PP_PARITY_SEQ,
        dtype=torch.float32, loss_impl="scan")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    for t in _flat_leaves(params):
        dist.broadcast(t, src=0)
    out = {"rank": rank, "world": world, "runs": {}}
    refs = {}
    for name, (axes, kw) in runs.items():
        mesh = topology.make_mesh(axes, device="cuda")
        global_batch = PP_PARITY_ROWS * axes.get("dp", 1)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
        if global_batch not in refs:
            want_ref = _pp_parity_reference(cfg, params, tokens)
            # the step's own spread: the same step with its sums in
            # another order (each data shard's gradients accumulated
            # over PP_PARITY_MICRO microbatches)
            acc_losses, acc_grads, acc = _pp_parity_reference(
                cfg, params, tokens, PP_PARITY_MICRO, axes.get("dp", 1))
            refs[global_batch] = (*want_ref, _adam_param_rule(
                acc, want_ref[2], acc_grads, want_ref[1]))
            out.setdefault("accum_vs_step", {})[global_batch] = \
                refs[global_batch][3]
        want_losses, want_grads, want, spread = refs[global_batch]
        run_cfg = dataclasses.replace(cfg, **kw)
        state, step = make_sharded_train_step(run_cfg, mesh, global_batch,
                                              params=params)
        model = state["model"]
        losses, grads = [], []
        for _ in range(PP_PARITY_STEPS):
            state, m = step(state, {"tokens": tokens})
            losses.append(m["loss"].item())
            grads.append(_flat_leaves(gather_params(
                cfg, model.stacked_params(lambda p: p.grad), mesh)))
        got = _flat_leaves(gather_params(cfg, model.stacked_params(), mesh))
        out["runs"][name] = {
            "losses": losses,
            "max_abs_loss_err": max(abs(a - b) for a, b in
                                    zip(losses, want_losses)),
            "max_abs_grad_err": max((g - w).abs().max().item()
                                    for gs, ws in zip(grads, want_grads)
                                    for g, w in zip(gs, ws)),
            "max_abs_param_err": max((g - w).abs().max().item()
                                     for g, w in zip(got, want)),
            "bitwise": (losses == want_losses and all(
                torch.equal(g, w) for gs, ws in zip(grads, want_grads)
                for g, w in zip(gs, ws)) and all(
                torch.equal(g, w) for g, w in zip(got, want))),
            **_adam_param_rule(got, want, grads, want_grads),
            "allowed_beyond_tol": spread["params_off_by_more_than_tol"]}
        del state, step, model
        torch.cuda.empty_cache()
    out["n_params"] = sum(t.numel() for t in _flat_leaves(params))
    bootstrap.shutdown()
    return out


def phase_sp_parity(state):
    """``sp_parity``: at one card sp 1 against single-device
    ``make_train_step`` bitwise, then at four cards (when visible) sp4
    under each ``sp_impl``, dp2×sp2 and sp2×tp2: losses and gradients
    within DP_PARITY_TOL, parameters by ``train_parity``'s rule, and the
    elements beyond TRAIN_PARAM_TOL at most the step's own spread (the
    same step with its sums reordered by microbatch accumulation, as
    ``pp_parity`` allows) plus that rule's share. At this size any
    reordering of the f32 sums moves ~22.6k of 167.8M elements whose
    |g| is noise (Adam divides it by itself), and the sequence split
    reorders every weight gradient's sum."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    ranks = multi_process_runner.run(
        _sp_parity_rank, 1, args=(SP_PARITY_RUNS[1],), device="cuda",
        timeout=600, env=env).return_values
    if world in SP_PARITY_RUNS and world > 1:
        ranks += multi_process_runner.run(
            _sp_parity_rank, world, args=(SP_PARITY_RUNS[world],),
            device="cuda", timeout=600, env=env).return_values
    problems = []
    for r in ranks:
        allowed = TRAIN_PARAM_FRAC * r["n_params"]
        for name, v in r["runs"].items():
            # dp_parity's rule, with pp_parity's allowance: the elements
            # the step's own reordering moves beyond TRAIN_PARAM_TOL
            ok = v["bitwise"] if r["world"] == 1 else (
                v["max_abs_loss_err"] <= DP_PARITY_TOL
                and v["max_abs_grad_err"] <= DP_PARITY_TOL
                and v["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                and v["params_off_by_more_than_tol"]
                <= v["allowed_beyond_tol"] + allowed)
            if not ok:
                problems.append(f"rank {r['rank']} of {r['world']} {name}: "
                                f"{v}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"world": world, "config": "transformer_big width, "
            f"{PP_PARITY_LAYERS} layers, f32, full logits",
            "rows_per_data_shard": PP_PARITY_ROWS,
            "seq_len": PP_PARITY_SEQ, "steps": PP_PARITY_STEPS,
            "rule": "torch.equal at one card; at four dp_parity's with "
                    "pp_parity's allowance",
            "ranks": ranks}


def _routing_stats(model, tokens) -> dict:
    """The MoE layers' routing of one forward without gradients on
    ``tokens`` (this rank's rows; every rank of a mesh runs it): kept
    routed tokens (global, summed over layers), each layer's dropped
    share of its ``T · k`` assignments and its expert load max over
    mean, and this rank's aux losses summed."""
    import torch
    from distributed_tensorflow_tpu_torch.parallel import moe
    with torch.no_grad(), moe.routing_log() as log:
        model(tokens)
    per = []
    for e in log:
        a = e["assigned"].double()
        kept = a.clamp(max=e["capacity"]).sum().item()
        per.append({"kept": kept, "dropped_share": 1 - kept / a.sum().item(),
                    "load_max_over_mean": (a.max() / a.mean()).item(),
                    "aux": e["aux"].item()})
    return {"layers": len(per), "capacity": log[0]["capacity"],
            "kept_routed_tokens": sum(p["kept"] for p in per),
            "dropped_share_mean": sum(p["dropped_share"] for p in per)
            / len(per),
            "dropped_share_max": max(p["dropped_share"] for p in per),
            "load_max_over_mean_mean": sum(p["load_max_over_mean"]
                                           for p in per) / len(per),
            "load_max_over_mean_max": max(p["load_max_over_mean"]
                                          for p in per),
            "aux_sum_rank": sum(p["aux"] for p in per)}


def moe_step_flops(cfg, batch: int, kept: int) -> float:
    """Model FLOPs of one MoE step: :func:`step_flops` of the dense
    parameters (every leaf but the experts' ``wi``/``wo``) plus 12 D F a
    kept routed token a layer (``kept`` summed over layers: 4 D F
    forward, twice that backward)."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        param_shapes)
    dense = sum(math.prod(s) for k, s in _leaves(param_shapes(cfg))
                if k not in ("layers/moe/wi", "layers/moe/wo"))
    return (step_flops(cfg, batch, dense)
            + 12 * cfg.d_model * cfg.d_ff * kept)


def _boundary_counts() -> tuple:
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    from distributed_tensorflow_tpu_torch.parallel import moe
    return (C.CopyToGroup.calls + C.ReduceFromGroup.calls,
            C.CopyToGroup.bytes + C.ReduceFromGroup.bytes,
            moe.STATS["count_gathers"], moe.STATS["count_gather_bytes"],
            C.FsdpGather.calls, C.FsdpGather.bytes, C.FsdpGather.scatters,
            C.FsdpGather.scatter_bytes)


_BOUNDARY_KEYS = ("boundary_all_reduces", "boundary_all_reduce_bytes",
                  "moe_count_gathers", "moe_count_gather_bytes",
                  "fsdp_all_gathers", "fsdp_all_gather_bytes",
                  "fsdp_reduce_scatters", "fsdp_reduce_scatter_bytes")


def _shard_train_rank(runs: dict, steps: int) -> dict:
    """One rank of ``moe_train`` / ``fsdp_train``: each run (axes or None
    for the single-device step, global batch, config kwargs) at the
    headline config, one warm-up and ``steps`` timed steps: step ms,
    launches, the tp/ep boundary all-reduces, MoE count gathers and
    fsdp gathers and reduce-scatters a step with bytes, the state a rank
    holds and peak memory, and with MoE the routing of the batch after
    the steps."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        _data_rows, make_sharded_train_step, param_shapes)
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        held_state_bytes)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    plain = _plain_calls()
    out = {"rank": rank, "world": world,
           "device": torch.cuda.get_device_name(), "runs": {}}
    for name, (axes, gb, kw) in runs.items():
        cfg = _headline_config(**kw)
        torch.cuda.empty_cache()
        if axes is None:
            model, opt, step, batch = _train_setup(cfg, 0, gb)
            state, mesh, rows = ({"model": model, "optimizer": opt,
                                  "step": 0}, None, slice(None))
        else:
            mesh = topology.make_mesh(axes, device="cuda")
            state, step = make_sharded_train_step(cfg, mesh, gb, seed=0)
            batch = {"tokens": torch.from_numpy(np.random.default_rng(
                0).integers(0, cfg.vocab_size, (gb, cfg.max_seq_len))
            ).to("cuda")}
            rows = _data_rows(mesh, gb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batch)                       # warm-up
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        zero_launch_counts()
        plain.clear()
        before = _boundary_counts()
        step_ms = []
        for _ in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, batch)
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            losses.append(m["loss"].item())
        counts = launch_counts()
        plain_calls = dict(plain)
        per_step = {k: (a - b) / steps for k, a, b in
                    zip(_BOUNDARY_KEYS, _boundary_counts(), before)}
        peak = torch.cuda.max_memory_allocated()
        model = state["model"]
        expected = {**TRAIN_LAUNCHES, "flash_fwd_tc": 12 * (1 + cfg.remat)}
        if cfg.fused_optimizer:
            # one launch a local parameter tensor (a shard on a mesh)
            expected["fused_adamw"] = sum(1 for _ in model.parameters())
        run = {"mesh": axes, "global_batch": gb, "config": kw,
               "step_ms": step_ms,
               "step_ms_mean": float(np.mean(step_ms)),
               "step_ms_median": float(np.median(step_ms)),
               "losses": losses, "launches": counts,
               "expected_per_step": expected,
               "plain_calls": plain_calls, "peak_mem_bytes": peak,
               "collectives_per_step": per_step,
               "n_params_rank": sum(p.numel() for p in model.parameters()),
               **held_state_bytes(model, state["optimizer"])}
        mean_s = run["step_ms_mean"] / 1e3
        run["tokens_per_s"] = gb * cfg.max_seq_len / mean_s
        run["tokens_per_s_median"] = (gb * cfg.max_seq_len
                                      / run["step_ms_median"] * 1e3)
        if cfg.moe_experts:
            run["routing"] = _routing_stats(model, batch["tokens"][rows])
            flops = moe_step_flops(cfg, gb, run["routing"][
                "kept_routed_tokens"])
        else:
            flops = step_flops(cfg, gb, sum(
                math.prod(s) for _, s in _leaves(param_shapes(cfg))))
        run["step_flops"] = flops
        run["mfu"] = flops / mean_s / (PEAK_FLOPS["bfloat16"] * world)
        run["param_checksum"], run["ranks_agree"] = (
            _gathered_checksum(cfg, model, mesh) if mesh is not None
            else (None, True))
        out["runs"][name] = run
        del state, step, model, m, batch
        gc.collect()
    bootstrap.shutdown()
    return out


def _shard_train(runs_by_world: dict, steps: int) -> tuple:
    """Spawn :func:`_shard_train_rank` at one card, then at every visible
    card when ``runs_by_world`` has that world; check every rank's
    launches (exactly the path's, no plain version), the falling loss,
    equal on every rank, and the gathered parameters' agreement."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    worlds = [1] + ([world] if world in runs_by_world and world > 1
                    else [])
    spawns = [multi_process_runner.run(
        _shard_train_rank, w, args=(runs_by_world[w], steps),
        device="cuda", timeout=900).return_values for w in worlds]
    problems = []
    for ranks in spawns:
        for r in ranks:
            for name, v in r["runs"].items():
                tag = f"rank {r['rank']} of {r['world']} {name}"
                want = expected_counts(v["expected_per_step"], steps)
                if v["launches"] != want:
                    problems.append(f"{tag}: launches {v['launches']} != "
                                    f"{want}")
                if v["plain_calls"]:
                    problems.append(f"{tag}: plain versions ran: "
                                    f"{v['plain_calls']}")
                if not all(math.isfinite(x) for x in v["losses"]) or \
                        not v["losses"][-1] < v["losses"][0]:
                    problems.append(f"{tag}: losses do not fall: "
                                    f"{v['losses']}")
                if v["losses"] != ranks[0]["runs"][name]["losses"]:
                    problems.append(f"{tag}: loss differs from rank 0's")
                if not v["ranks_agree"]:
                    problems.append(f"{tag}: gathered parameters differ")
    if problems:
        raise AssertionError("; ".join(problems))
    summary = {}
    for ranks in spawns:
        for name, v in ranks[0]["runs"].items():
            summary[name] = {
                k: v[k] for k in ("mesh", "global_batch", "config",
                                  "step_ms", "step_ms_mean",
                                  "step_ms_median", "tokens_per_s",
                                  "tokens_per_s_median", "mfu", "losses",
                                  "routing") if k in v}
            summary[name].update({
                "tokens_per_s_per_card": v["tokens_per_s"] / len(ranks),
                "launches_per_step": {k: c / steps for k, c in
                                      v["launches"].items() if c},
                "collectives_per_step_ranks": [
                    r["runs"][name]["collectives_per_step"] for r in ranks],
                "state_bytes_ranks": [r["runs"][name]["state_bytes"]
                                      for r in ranks],
                "n_params_ranks": [r["runs"][name]["n_params_rank"]
                                   for r in ranks],
                "peak_mem_bytes_ranks": [r["runs"][name]["peak_mem_bytes"]
                                         for r in ranks]})
    launches = {name: v["launches"] for ranks in spawns
                for name, v in ranks[0]["runs"].items()}
    return world, summary, launches, [r for ranks in spawns for r in ranks]


def phase_moe_train(state):
    """``moe_train``: the headline step with 8 experts a layer — at one
    card the single-device step top-1 (capacity 1.25), top-2 (capacity
    2.0) and top-1 under remat "nothing" (the aux loss leaves the
    checkpoint), and ``{"ep": 1}`` with the fused AdamW; at four cards
    ep4 (also fused), dp2×ep2 and ep2×tp2. Step ms, tokens/s, MFU (the
    dense FLOPs plus 12 D F a kept routed token a layer), dropped share,
    expert load max/mean, aux, state a rank and peak memory, the
    boundary all-reduces and count gathers a step with bytes; #1-#4 and
    #7 launches exactly the headline's a step, #9 one a local parameter
    tensor in the fused runs."""
    world, summary, launches, ranks = _shard_train(MOE_RUNS, MOE_STEPS)
    single = summary["top1"]["state_bytes_ranks"][0]
    for name, v in summary.items():
        v["state_over_single_card"] = [b / single
                                       for b in v["state_bytes_ranks"]]
    state["moe_launches"] = launches
    return {"world": world, "config": "transformer_big, bf16, no remat "
            "unless named, kernel CE, bf16 mu, 8 experts a layer",
            "steps": MOE_STEPS, "summary": summary, "ranks": ranks}


def phase_fsdp_train(state):
    """``fsdp_train``: the headline step, 8 × 1024 a data shard, on
    ``{"fsdp": 1}`` at one card and fsdp4, dp2×fsdp2 and fsdp2×tp2 at
    four, ``{"fsdp": 1}`` and fsdp4 also with the fused AdamW: step ms,
    tokens/s, the state a rank holds (against dp4's whole replica, the
    one-card run's), the fsdp all-gathers and reduce-scatters a step
    with bytes; the headline's kernels a step, #9 one a local shard in
    the fused runs."""
    world, summary, launches, ranks = _shard_train(FSDP_RUNS, FSDP_STEPS)
    whole = summary["fsdp1"]["state_bytes_ranks"][0]
    for name, v in summary.items():
        v["state_over_replica"] = [b / whole for b in v["state_bytes_ranks"]]
    state["fsdp_launches"] = launches
    return {"world": world, "config": "transformer_big, bf16, no remat, "
            "kernel CE, bf16 mu; 8 x 1024 a data shard",
            "steps": FSDP_STEPS, "summary": summary, "ranks": ranks}


def _moe_unfused(params, x, cfg):
    """JAX's ``MoELayer`` formulation in plain PyTorch: ``(T, E, C)``
    one-hot combine and dispatch tensors, ``torch.topk`` routing, four
    einsums — an implementation of the layer independent of the port's.
    Returns ``(out, aux)``."""
    import torch
    from torch.nn import functional as F
    B, S, D = x.shape
    E, K, T = cfg.num_experts, cfg.top_k, B * S
    C = max(1, int(cfg.capacity_factor * T * K / E))
    tokens = x.reshape(T, D)
    probs = torch.softmax(tokens.float() @ params["router"], dim=-1)
    gate_vals, idx = torch.topk(probs, K)
    combine = torch.zeros(T, E, C, device=x.device)
    frac = torch.zeros(E, device=x.device)
    prior = torch.zeros(E, device=x.device)
    slots = torch.arange(C, device=x.device)
    for k in range(K):
        onehot = F.one_hot(idx[:, k], E).float()
        pos = ((torch.cumsum(onehot, 0) - 1.0 + prior[None]) * onehot).sum(-1)
        prior = prior + onehot.sum(0)
        gate = gate_vals[:, k] * (pos < C)
        pos_oh = (pos.long()[:, None] == slots[None]).float()
        combine = combine + (gate[:, None, None] * onehot[:, :, None]
                             * pos_oh[:, None, :])
        frac = frac + onehot.mean(0)
    dispatch = (combine > 0).to(x.dtype)
    aux = (cfg.aux_loss_weight * E
           * torch.sum(frac / K * probs.mean(0)))
    dt = cfg.dtype
    h = F.gelu(torch.einsum("ecd,edf->ecf", torch.einsum(
        "td,tec->ecd", tokens, dispatch), params["wi"].to(dt)),
        approximate="tanh")
    out = torch.einsum("ecd,tec->td", torch.einsum(
        "ecf,efd->ecd", h, params["wo"].to(dt)), combine.to(dt))
    return out.reshape(B, S, D), aux


def _unfused_model(cfg, params):
    """``TransformerLM`` of ``params`` whose MoE layers run
    :func:`_moe_unfused`."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)
    model = TransformerLM(cfg, params, device="cuda")
    for block in model.layers:
        layer = block.moe
        layer.forward = (lambda x, m=layer: _moe_unfused(
            {"router": m.router, "wi": m.wi, "wo": m.wo}, x, m.cfg))
    return model


def _steps_of(cfg, model, tokens) -> tuple:
    """PP_PARITY_STEPS of ``make_train_step`` on ``model``: each step's
    loss and gradients, and the parameters after the last."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_optimizer, make_train_step)
    step = make_train_step(cfg, model, make_optimizer(
        cfg, model.parameters()))
    st, losses, grads = {"model": model, "step": 0}, [], []
    for _ in range(PP_PARITY_STEPS):
        st, m = step(st, {"tokens": tokens})
        losses.append(m["loss"].item())
        grads.append([g.clone() for g in _flat_leaves(
            model.stacked_params(lambda p: p.grad))])
    return losses, grads, [p.detach().clone() for p in _flat_leaves(
        model.stacked_params())]


def _moe_reference_check(cfg, params, tokens) -> dict:
    """The single-device MoE step against :func:`_unfused_model` from the
    same weights: losses, the first step's gradients (each leaf's
    largest error over its largest magnitude: both at the same weights,
    as train_parity holds them; later steps start from weights Adam has
    moved apart by up to lr where |g| is noise, so they are held by the
    parameters), parameters by train_parity's rule; and each layer's
    dropped rows against the unfused layer's zero rows on the same
    input."""
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerLM)
    from distributed_tensorflow_tpu_torch.parallel import moe
    model = TransformerLM(cfg, params, device="cuda")
    inputs = []
    hooks = [b.moe.register_forward_pre_hook(
        lambda m, a: inputs.append((m, a[0]))) for b in model.layers]
    with torch.no_grad(), moe.routing_log() as log:
        model(tokens)
    for h in hooks:
        h.remove()
    dropped, equal = 0, True
    with torch.no_grad():
        for (m, x), entry in zip(inputs, log):
            out, _ = _moe_unfused({"router": m.router, "wi": m.wi,
                                   "wo": m.wo}, x, m.cfg)
            zero = out.abs().sum(-1) == 0
            equal &= torch.equal(zero, entry["dropped"])
            dropped += int(entry["dropped"].sum())
    got = _steps_of(cfg, model, tokens)
    want = _steps_of(cfg, _unfused_model(cfg, params), tokens)
    grad_err = [max(rel_err(g, w) for g, w in zip(gs, ws))
                for gs, ws in zip(got[1], want[1])]
    return {"losses": got[0], "losses_unfused": want[0],
            "max_abs_loss_err": max(abs(a - b) for a, b in
                                    zip(got[0], want[0])),
            "max_grad_rel_err": grad_err[0],
            "max_grad_rel_err_by_step": grad_err,
            "dropped_rows_equal": bool(equal), "dropped_rows": dropped,
            "layers": len(log), "tokens": tokens.numel(),
            **_adam_param_rule(got[2], want[2], got[1], want[1]),
            "_run": (got, want)}


def _shard_parity_rank(runs: dict, base_kw: dict) -> dict:
    """One rank of ``moe_parity`` / ``fsdp_parity``: pp_parity's f32
    config with ``base_kw``, each run against single-device
    ``make_train_step`` on the same global batch from the same weights
    (TF32 off, deterministic), PP_PARITY_STEPS steps: losses, gathered
    gradients and parameters. The step's own spread: dense, the same
    step with each data shard's gradients accumulated over microbatches
    (pp_parity's); MoE, whose routing is the whole batch's, the same
    model with JAX's unfused MoE layers (:func:`_moe_reference_check`,
    also reported). With MoE each rank's dropped rows at the init equal
    the single-device model's on its rows."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, _data_rows, gather_params,
        init_params, make_sharded_train_step)
    from distributed_tensorflow_tpu_torch.parallel import moe
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = TransformerConfig.transformer_big(
        n_layers=PP_PARITY_LAYERS, max_seq_len=PP_PARITY_SEQ,
        dtype=torch.float32, loss_impl="scan", **base_kw)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    for t in _flat_leaves(params):
        dist.broadcast(t, src=0)
    out = {"rank": rank, "world": world, "runs": {}}
    refs = {}
    for name, (axes, kw) in runs.items():
        mesh = topology.make_mesh(axes, device="cuda")
        n_data = topology.mesh_axis_size(mesh, *topology.data_axes(mesh))
        global_batch = PP_PARITY_ROWS * n_data
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (global_batch, cfg.max_seq_len))).to("cuda")
        if global_batch not in refs:
            if cfg.moe_experts:
                check = _moe_reference_check(cfg, params, tokens)
                want_ref, (_, acc_grads, acc) = check.pop("_run")
                out.setdefault("unfused_check", {})[global_batch] = check
                single = TransformerLM(cfg, params, device="cuda")
                with torch.no_grad(), moe.routing_log() as log:
                    single(tokens)
                dropped = torch.stack([e["dropped"] for e in log])
                del single
            else:
                want_ref = _pp_parity_reference(cfg, params, tokens)
                _, acc_grads, acc = _pp_parity_reference(
                    cfg, params, tokens, PP_PARITY_MICRO, n_data)
                dropped = None
            refs[global_batch] = (*want_ref, _adam_param_rule(
                acc, want_ref[2], acc_grads, want_ref[1]), dropped)
            out.setdefault("spread_vs_step", {})[global_batch] = \
                refs[global_batch][3]
        want_losses, want_grads, want, spread, dropped = refs[global_batch]
        run_cfg = dataclasses.replace(cfg, **kw)
        state, step = make_sharded_train_step(run_cfg, mesh, global_batch,
                                              params=params)
        model = state["model"]
        run = {}
        if dropped is not None:
            rows = _data_rows(mesh, global_batch)
            with torch.no_grad(), moe.routing_log() as log:
                model(tokens[rows])
            run["dropped_rows_equal_single"] = torch.equal(
                torch.stack([e["dropped"] for e in log]), dropped[:, rows])
        losses, grads = [], []
        for _ in range(PP_PARITY_STEPS):
            state, m = step(state, {"tokens": tokens})
            losses.append(m["loss"].item())
            grads.append(_flat_leaves(gather_params(
                cfg, model.stacked_params(lambda p: p.grad), mesh)))
        got = _flat_leaves(gather_params(cfg, model.stacked_params(), mesh))
        out["runs"][name] = {
            **run, "losses": losses,
            "max_abs_loss_err": max(abs(a - b) for a, b in
                                    zip(losses, want_losses)),
            "max_abs_grad_err": max((g - w).abs().max().item()
                                    for gs, ws in zip(grads, want_grads)
                                    for g, w in zip(gs, ws)),
            "max_abs_param_err": max((g - w).abs().max().item()
                                     for g, w in zip(got, want)),
            "bitwise": (losses == want_losses and all(
                torch.equal(g, w) for gs, ws in zip(grads, want_grads)
                for g, w in zip(gs, ws)) and all(
                torch.equal(g, w) for g, w in zip(got, want))),
            **_adam_param_rule(got, want, grads, want_grads),
            "allowed_beyond_tol": spread["params_off_by_more_than_tol"]}
        del state, step, model
        torch.cuda.empty_cache()
    out["n_params"] = sum(t.numel() for t in _flat_leaves(params))
    bootstrap.shutdown()
    return out


def _shard_parity(runs_by_world: dict, base_kw: dict) -> tuple:
    """:func:`_shard_parity_rank` at one card (bitwise against the
    single-device step), then at every visible card when
    ``runs_by_world`` has that world (sp_parity's rule); with MoE also
    the unfused reference and the dropped rows."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    ranks = multi_process_runner.run(
        _shard_parity_rank, 1, args=(runs_by_world[1], base_kw),
        device="cuda", timeout=600, env=env).return_values
    if world in runs_by_world and world > 1:
        ranks += multi_process_runner.run(
            _shard_parity_rank, world, args=(runs_by_world[world], base_kw),
            device="cuda", timeout=600, env=env).return_values
    problems = _shard_parity_problems(ranks)
    if problems:
        raise AssertionError("; ".join(problems))
    return world, ranks


def _shard_parity_problems(ranks) -> list:
    """:func:`_shard_parity_rank` results against the rule of
    :func:`_shard_parity`."""
    problems = []
    for r in ranks:
        allowed = TRAIN_PARAM_FRAC * r["n_params"]
        for name, v in r["runs"].items():
            ok = v["bitwise"] if r["world"] == 1 else (
                v["max_abs_loss_err"] <= DP_PARITY_TOL
                and v["max_abs_grad_err"] <= DP_PARITY_TOL
                and v["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                and v["params_off_by_more_than_tol"]
                <= v["allowed_beyond_tol"] + allowed)
            if not v.get("dropped_rows_equal_single", True):
                ok = False
            if not ok:
                problems.append(f"rank {r['rank']} of {r['world']} {name}: "
                                f"{v}")
        for gb, c in r.get("unfused_check", {}).items():
            if not (c["dropped_rows_equal"] and c["dropped_rows"] > 0
                    and c["max_abs_loss_err"] <= TRAIN_LOSS_TOL
                    and c["max_grad_rel_err"] <= GRAD_TOL["float32"]
                    and c["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
                    and c["params_off_by_more_than_tol"] <= allowed):
                problems.append(f"rank {r['rank']} of {r['world']}: the "
                                f"MoE step against the unfused layers "
                                f"at batch {gb}: {c}")
    return problems


def phase_moe_parity(state):
    """``moe_parity``: pp_parity's f32 config with 8 experts a layer
    (top-1, capacity 1.25). At one card ``{"ep": 1}`` bitwise against
    the single-device step, and the single-device step against the
    unfused MoE layers (JAX's formulation): losses, gradients,
    parameters and every layer's dropped rows exact; at four cards ep4,
    dp2×ep2 and ep2×tp2 by sp_parity's rule, the step's own spread
    being the unfused reference's, and each rank's dropped rows the
    single-device model's."""
    world, ranks = _shard_parity(MOE_PARITY_RUNS, MOE_TOP1)
    top2 = _moe_top2_reference()
    return {"world": world, "config": "transformer_big width, "
            f"{PP_PARITY_LAYERS} layers, f32, full logits, 8 experts",
            "rows_per_data_shard": PP_PARITY_ROWS,
            "seq_len": PP_PARITY_SEQ, "steps": PP_PARITY_STEPS,
            "top2_unfused_check": top2,
            "rule": "torch.equal at one card; at four dp_parity's with "
                    "the unfused reference's spread", "ranks": ranks}


def _moe_top2_reference() -> dict:
    """The single-device top-2 (capacity 2.0) step against the unfused
    layers, in this process (f32, TF32 off)."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig.transformer_big(
        n_layers=PP_PARITY_LAYERS, max_seq_len=PP_PARITY_SEQ,
        dtype=torch.float32, loss_impl="scan", **MOE_TOP2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PP_PARITY_ROWS, cfg.max_seq_len))).to("cuda")
    check = _moe_reference_check(cfg, params, tokens)
    check.pop("_run")
    n = sum(t.numel() for t in _flat_leaves(params))
    ok = (check["dropped_rows_equal"]
          and check["max_abs_loss_err"] <= TRAIN_LOSS_TOL
          and check["max_grad_rel_err"] <= GRAD_TOL["float32"]
          and check["max_abs_param_err_held"] <= TRAIN_PARAM_TOL
          and check["params_off_by_more_than_tol"] <= TRAIN_PARAM_FRAC * n)
    del params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"top-2 MoE step against the unfused layers: "
                             f"{check}")
    return check


def phase_fsdp_parity(state):
    """``fsdp_parity``: pp_parity's f32 config; ``{"fsdp": 1}`` bitwise
    against the single-device step at one card, fsdp4, dp2×fsdp2 and
    fsdp2×tp2 by sp_parity's rule at four."""
    world, ranks = _shard_parity(FSDP_PARITY_RUNS, {})
    return {"world": world, "config": "transformer_big width, "
            f"{PP_PARITY_LAYERS} layers, f32, full logits",
            "rows_per_data_shard": PP_PARITY_ROWS,
            "seq_len": PP_PARITY_SEQ, "steps": PP_PARITY_STEPS,
            "rule": "torch.equal at one card; at four dp_parity's with "
                    "pp_parity's allowance", "ranks": ranks}


# ---------------------------------------------------------------------------
# the other workloads: ResNet-50, the MNIST CNN, Wide&Deep/DLRM
# ---------------------------------------------------------------------------

def _step_events(step, st, batch, n: int):
    """``n`` steps of ``step`` timed each with CUDA events: ``(state,
    step ms list, losses)``."""
    import torch
    step_ms, losses = [], []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, m = step(st, batch)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(m["loss"].item())
    return st, step_ms, losses


def _no_kernel_launched(tag: str, counts: dict):
    """The other workloads' paths run none of #1-#9."""
    if any(counts.values()):
        raise AssertionError(f"{tag}: a kernel of #1-#9 ran: {counts}")


def _falls(tag: str, losses: list):
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses do not fall: {losses}")


def resnet_step_flops(model, images) -> float:
    """Training FLOPs of one ResNet step, counted from the shapes: 2 MACs
    an output element of every convolution (``out · in · kh · kw``) and
    of the classifier, in one eval-mode forward (no statistic changes),
    times 3 (forward, and the backward's two products)."""
    import torch
    from distributed_tensorflow_tpu_torch.models.layers import Conv, Dense
    total = [0.0]

    def conv(mod, inp, out):
        k = mod.kernel
        total[0] += 2.0 * out.numel() * k.shape[1] * k.shape[2] * k.shape[3]

    def dense(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.kernel.shape[0]
    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in model.modules() if isinstance(m, (Conv, Dense))]
    model.set_train(False)
    with torch.no_grad():
        model(images)
    model.set_train(True)
    for h in hooks:
        h.remove()
    return 3 * total[0]


def _kernel_groups(fn, iters: int = 2) -> dict:
    """Device ms of one call of ``fn`` by kernel group (from
    ``torch.profiler``: convolution, GEMM, reduction/normalisation,
    elementwise and copies, other), the ten kernels that take the most,
    and the call's host wall under the profiler (which slows the host:
    the idle share is taken against the CUDA-event step time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    groups: dict = {}
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        n = e.name.lower()
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / iters
        g = ("conv" if any(s in n for s in ("conv", "xmma", "implicit",
                                            "dgrad", "wgrad", "cudnn"))
             else "gemm" if any(s in n for s in ("gemm", "cutlass",
                                                 "cublas"))
             else "reduce_norm" if any(s in n for s in ("reduce", "norm",
                                                        "batch"))
             else "elementwise_copy" if any(s in n for s in (
                 "elementwise", "vectorized", "copy", "fill", "index",
                 "scatter", "gather", "cat"))
             else "other")
        groups[g] = groups.get(g, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
    busy = sum(groups.values()) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms_by_group": {k: v / iters for k, v in groups.items()},
            "device_busy_ms": busy, "profiled_wall_ms": wall,
            "top_kernels_ms": dict(top)}


def phase_resnet_train(state):
    """``bench.py run_resnet50``'s configuration (``:224-262``) through
    ``models/resnet.py``: ResNet-50 (stages (3, 4, 6, 3), width 64, 1000
    classes) in bf16, batch 128 at 224², random weights and
    ``synthetic_images`` from seed 0; two warm-up steps (cuDNN picks its
    algorithms), then RESNET_STEPS timed with CUDA events: step ms,
    images/s, MFU against 989 TFLOP/s with the FLOPs counted from the
    conv and dense shapes, peak memory, a falling loss; the device time
    by kernel group over one more step. No kernel of #1-#9 runs."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import resnet
    torch.cuda.empty_cache()
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    cfg = resnet.ResNetConfig.resnet50()
    model = resnet.ResNet(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = resnet.make_optimizer(cfg, model.parameters())
    step = resnet.make_train_step(cfg, model, opt)
    data = resnet.synthetic_images(RESNET_BATCH, RESNET_IMAGE,
                                   cfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}
    flops = resnet_step_flops(model, batch["image"])
    n_params = sum(p.numel() for p in model.parameters())
    st = {"model": model, "optimizer": opt, "step": 0}
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):                                      # warm-up
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    zero_launch_counts()
    st, step_ms, timed = _step_events(step, st, batch, RESNET_STEPS)
    counts = launch_counts()
    losses += timed
    _no_kernel_launched("resnet_train", counts)
    _falls("resnet_train", losses)
    peak = torch.cuda.max_memory_allocated()
    box = {"st": st}

    def one():
        box["st"], _ = step(box["st"], batch)
    groups = _kernel_groups(one, 1)
    torch.backends.cudnn.benchmark = benchmark
    state["resnet_train_launches"] = counts
    mean_s = float(np.mean(step_ms)) / 1e3
    groups["idle_share"] = max(0.0, 1.0 - groups["device_busy_ms"]
                               / (mean_s * 1e3))
    return {"config": "ResNet-50 (bench.py run_resnet50), bf16",
            "batch": RESNET_BATCH, "image": RESNET_IMAGE,
            "params": n_params, "step_ms": step_ms,
            "step_ms_mean": mean_s * 1e3,
            "images_per_s": RESNET_BATCH / mean_s,
            "flops_per_step": flops,
            "mfu": flops / mean_s / PEAK_FLOPS["bfloat16"],
            "peak_mem_bytes": peak, "losses": losses,
            "launches": counts, **groups}


def _flat_variables(model, of=None) -> dict:
    from distributed_tensorflow_tpu_torch.models import resnet
    v = resnet.flax_variables(model, of)
    return {**{f"params/{k}": a for k, a in _leaves(v["params"])},
            **{f"stats/{k}": a for k, a in _leaves(v["batch_stats"])}}


def _tree_errs(got: dict, want: dict, prefix: str) -> tuple:
    """``(max abs error, max error over its leaf's largest magnitude, the
    leaf of the first)`` over the keys of ``want`` starting with
    ``prefix``."""
    import numpy as np
    ab, rel, worst = 0.0, 0.0, None
    for k, w in want.items():
        if not k.startswith(prefix):
            continue
        d = float(np.abs(got[k] - w).max())
        if d >= ab:
            ab, worst = d, k
        rel = max(rel, d / max(float(np.abs(w).max()), 1e-30))
    return ab, rel, worst


def _vec_rel(got: dict, want: dict, base: dict | None = None) -> tuple:
    """The parameter leaves as one vector: ``(‖got − want‖₂ / ‖want −
    base‖₂, the leaf whose error is largest against its own norm)``, base
    0 (gradients) or the parameters before the step (the update). Per
    leaf the ratio is no rule: a conv that feeds a BatchNorm gets a
    gradient the normalisation nearly cancels (the loss does not change
    with the weights' scale), so its small update is mostly rounding."""
    import numpy as np
    err2 = norm2 = 0.0
    worst, leaf = 0.0, None
    for k, w in want.items():
        if not k.startswith("params/"):
            continue
        e2 = float(np.square(got[k] - w).sum())
        n2 = float(np.square(w if base is None else w - base[k]).sum())
        err2, norm2 = err2 + e2, norm2 + n2
        if e2 / max(n2, 1e-30) >= worst:
            worst, leaf = e2 / max(n2, 1e-30), k
    return math.sqrt(err2 / max(norm2, 1e-30)), leaf


def _resnet_step_capture(cfg, model, images, labels, device):
    """One ``make_train_step`` step; ``(loss, train-mode logits,
    gradients, variables after the step)``."""
    import torch
    from distributed_tensorflow_tpu_torch.models import resnet
    opt = resnet.make_optimizer(cfg, model.parameters())
    step = resnet.make_train_step(cfg, model, opt)
    seen = {}

    def keep(mod, inp, out):        # returns None: the output stands
        seen["logits"] = out.detach()
    h = model.register_forward_hook(keep)
    st, m = step({"model": model, "optimizer": opt, "step": 0},
                 {"image": images.to(device), "label": labels.to(device)})
    h.remove()
    return (m["loss"].item(), seen["logits"].float().cpu().numpy(),
            _flat_variables(model, lambda p: p.grad),
            _flat_variables(model))


def phase_resnet_parity(state):
    """f32, TF32 off: full ResNet-50 at batch RESNET_PARITY_BATCH and
    RESNET_PARITY_IMAGE², one ``make_train_step`` step on the card
    against the port on the CPU from the same converted variables
    (``flax_variables`` → ``params_from_jax``) and inputs: the eval-mode
    logits, and of the step the train-mode logits, the loss, every
    gradient, the BatchNorm running statistics and the parameters'
    update, each within RESNET_PARITY_TOL."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import resnet
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.ResNetConfig.resnet50(dtype=torch.float32)
    src = resnet.ResNet(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    v = resnet.flax_variables(src)
    del src
    data = resnet.synthetic_images(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                                   cfg.num_classes, seed=1)
    images = torch.from_numpy(data["image"])
    labels = torch.from_numpy(data["label"]).long()
    out = {}
    for dev in ("cpu", "cuda"):
        model = resnet.params_from_jax(cfg, v["params"], v["batch_stats"],
                                       device=dev)
        model.set_train(False)
        with torch.no_grad():
            eval_logits = model(images.to(dev)).cpu().numpy()
        model.set_train(True)
        if dev == "cuda":
            torch.cuda.synchronize()
            zero_launch_counts()
        out[dev] = (eval_logits,) + _resnet_step_capture(
            cfg, model, images, labels, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
        del model
    (e_c, l_c, lg_c, g_c, v_c), (e_g, l_g, lg_g, g_g, v_g) = \
        out["cpu"], out["cuda"]
    tol = RESNET_PARITY_TOL
    init = {f"params/{k}": a for k, a in _leaves(v["params"])}
    upd, upd_leaf = _vec_rel(v_g, v_c, init)
    errs = {"eval_logits": float(np.abs(e_g - e_c).max()),
            "logits": float(np.abs(lg_g - lg_c).max()),
            "loss": abs(l_g - l_c),
            "grads_rel": _vec_rel(g_g, g_c)[0],
            "stats": _tree_errs(v_g, v_c, "stats/")[0],
            "update_rel": upd}
    limits = {"eval_logits": tol["logits"], "logits": tol["logits"],
              "loss": tol["loss"], "grads_rel": tol["grads_rel"],
              "stats": tol["stats"], "update_rel": tol["update_rel"]}
    bad = {k: (errs[k], limits[k]) for k in errs if not errs[k] <= limits[k]}
    _no_kernel_launched("resnet_parity", counts)
    state["resnet_parity_launches"] = counts
    if bad:
        raise AssertionError(f"resnet_parity beyond tolerance: {bad}")
    return {"config": "ResNet-50, f32, TF32 off",
            "batch": RESNET_PARITY_BATCH, "image": RESNET_PARITY_IMAGE,
            "errors": errs, "tolerances": limits,
            "worst_update_leaf": upd_leaf,
            "params_max_abs_err": _tree_errs(v_g, v_c, "params/")[0],
            "logit_scale": float(np.abs(lg_c).max()), "losses": [l_c, l_g],
            "launches": counts}


def phase_mnist_train(state):
    """The MNIST CNN (``models/mnist_cnn.py``) in f32 at batch
    MNIST_BATCH, ``synthetic_data`` and weights from seed 0, Adam 1e-3:
    two warm-up steps, then MNIST_STEPS timed with CUDA events: step ms,
    images/s, a falling loss; no kernel of #1-#9."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import mnist_cnn
    torch.cuda.empty_cache()
    st, model, opt = mnist_cnn.create_train_state(0, device="cuda")
    step = mnist_cnn.make_train_step(model, opt)
    data = mnist_cnn.synthetic_data(MNIST_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}
    losses = []
    for _ in range(2):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    zero_launch_counts()
    st, step_ms, timed = _step_events(step, st, batch, MNIST_STEPS)
    counts = launch_counts()
    losses += timed
    _no_kernel_launched("mnist_train", counts)
    _falls("mnist_train", losses)
    state["mnist_train_launches"] = counts
    mean_s = float(np.mean(step_ms)) / 1e3
    box = {"st": st}

    def one():
        box["st"], _ = step(box["st"], batch)
    groups = _kernel_groups(one, 2)
    groups["idle_share"] = max(0.0, 1.0 - groups["device_busy_ms"]
                               / (mean_s * 1e3))
    return {"config": "MNISTCNN f32",
            "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                     "matmul": torch.backends.cuda.matmul.allow_tf32},
            "cudnn_benchmark": torch.backends.cudnn.benchmark, **groups,
            "batch": MNIST_BATCH, "step_ms": step_ms,
            "step_ms_mean": mean_s * 1e3,
            "step_ms_median": float(np.median(step_ms)),
            "images_per_s": MNIST_BATCH / mean_s, "losses": losses,
            "launches": counts}


def _wd_batch(cfg, n: int, seed: int, device="cuda") -> dict:
    import torch
    from distributed_tensorflow_tpu_torch.models import wide_deep
    return {k: torch.from_numpy(v).to(device) for k, v in
            wide_deep.synthetic_clicks(cfg, n, seed=seed).items()}


def _wd_state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_wide_deep_train(state):
    """DLRM (``WideDeepConfig.dlrm_like()``: 26 tables × 100,000 × 64 f32,
    the "dot" interaction, MLP (512, 256, 128)) at batch WD_BATCH,
    ``synthetic_clicks`` and weights from seed 0, through both training
    paths: ``make_train_step`` (the flax-layout model, optax Adagrad over
    every parameter) and ``make_embedding_train_step`` (the embedding
    API's tables and their per-table Adagrad, the dense tower's own
    optimizer). One warm-up and WD_STEPS timed steps each: step ms,
    examples/s, the state held, peak memory, a falling loss; no kernel
    of #1-#9."""
    import gc
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models import wide_deep
    torch.cuda.empty_cache()
    cfg = wide_deep.WideDeepConfig.dlrm_like()
    batch = _wd_batch(cfg, WD_BATCH, 0)
    runs, launches = {}, {}
    for path in ("dense", "embedding"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if path == "dense":
            model = wide_deep.WideDeep(cfg, device="cuda",
                                       generator=torch.Generator(
                                           device="cuda").manual_seed(0))
            opt = wide_deep.make_optimizer(cfg, model.parameters())
            step = wide_deep.make_train_step(cfg, model, opt)
            st = {"model": model, "optimizer": opt, "step": 0}
        else:
            st, step = wide_deep.make_embedding_train_step(
                cfg, device="cuda", seed=0)
        st, m = step(st, batch)                               # warm-up
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        zero_launch_counts()
        st, step_ms, timed = _step_events(step, st, batch, WD_STEPS)
        counts = launch_counts()
        losses += timed
        _no_kernel_launched(f"wide_deep_train {path}", counts)
        _falls(f"wide_deep_train {path}", losses)
        if path == "dense":
            held = _wd_state_bytes(
                [*model.parameters(),
                 *(s for d in opt.state.values() for s in d.values())])
        else:
            emb = st["emb"]
            dm = st["dense"]["model"]
            held = _wd_state_bytes(
                [*emb["tables"].values(),
                 *(a for sl in emb["slots"].values() for a in sl.values()),
                 *dm.parameters(),
                 *(s for d in st["dense"]["optimizer"].state.values()
                   for s in d.values())])
        mean_s = float(np.mean(step_ms)) / 1e3
        runs[path] = {"step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
                      "examples_per_s": WD_BATCH / mean_s,
                      "state_bytes": held,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "losses": losses, "launches": counts}
        box = {"st": st}

        def one():
            box["st"], _ = step(box["st"], batch)
        runs[path].update(_kernel_groups(one, 1))
        runs[path]["idle_share"] = max(
            0.0, 1.0 - runs[path]["device_busy_ms"] / (mean_s * 1e3))
        launches[path] = counts
        del st, step, box
        gc.collect()
    state["wide_deep_train_launches"] = launches["embedding"]
    return {"config": "dlrm_like (26 x 100000 x 64 f32, dot)",
            "batch": WD_BATCH, "runs": runs}


def _wd_flat(model) -> dict:
    from distributed_tensorflow_tpu_torch.models import wide_deep
    return dict(_leaves(wide_deep.flax_params(model)))


def _wd_parity_runs(cfg, device, batches, dense0, emb0):
    """Both W&D steps over ``batches`` on ``device`` from the flax
    parameters ``dense0`` (the WideDeep tree) and the embedding state
    ``emb0``: ``{path: (losses, flat final state)}``."""
    import torch
    from distributed_tensorflow_tpu_torch.models import wide_deep
    model = wide_deep.params_from_jax(cfg, dense0["wide_deep"], device)
    opt = wide_deep.make_optimizer(cfg, model.parameters())
    step = wide_deep.make_train_step(cfg, model, opt)
    st = {"model": model, "optimizer": opt, "step": 0}
    dl = []
    for b in batches:
        st, m = step(st, {k: v.to(device) for k, v in b.items()})
        dl.append(m["loss"].item())
    st2, step2 = wide_deep.make_embedding_train_step(
        cfg, device=device, dense_params=dense0["tower"], emb_state=emb0)
    el = []
    for b in batches:
        st2, m = step2(st2, {k: v.to(device) for k, v in b.items()})
        el.append(m["loss"].item())
    emb = st2["emb"]
    flat = {**{f"tower/{k}": a for k, a in _wd_flat(
        st2["dense"]["model"]).items()},
        **{f"tables/{k}": v.cpu().numpy() for k, v in emb["tables"].items()},
        **{f"slots/{k}/{s}": a.cpu().numpy() for k, sl in emb["slots"]
           .items() for s, a in sl.items()}}
    return {"dense": (dl, _wd_flat(model)), "embedding": (el, flat)}


def phase_wide_deep_parity(state):
    """f32, TF32 off, ``dlrm_like`` at WD_PARITY_VOCAB rows a table:
    WD_PARITY_STEPS steps of both W&D paths on the card against the port
    on the CPU from the same parameters and batches: every loss and
    every parameter, table and slot within WD_PARITY_TOL."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch import embedding as emb_lib
    from distributed_tensorflow_tpu_torch.models import wide_deep
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = wide_deep.WideDeepConfig.dlrm_like(
        vocab_sizes=(WD_PARITY_VOCAB,) * 26)
    gen = torch.Generator().manual_seed(0)
    src = wide_deep.WideDeep(cfg, device="cpu", generator=gen)
    tower = wide_deep.WideDeepDense(cfg, device="cpu", generator=gen)
    emb0 = emb_lib.create_state(wide_deep.build_feature_config(cfg),
                                generator=gen, device="cpu")
    emb0 = {"tables": {k: v.numpy() for k, v in emb0["tables"].items()},
            "slots": {k: {s: a.numpy() for s, a in v.items()}
                      for k, v in emb0["slots"].items()}, "step": 0}
    dense0 = {"wide_deep": {n: p.detach().numpy()
                            for n, p in src.named_parameters()},
              "tower": wide_deep.flax_params(tower)}
    batches = [_wd_batch(cfg, WD_PARITY_BATCH, 50 + i, "cpu")
               for i in range(WD_PARITY_STEPS)]
    want = _wd_parity_runs(cfg, "cpu", batches, dense0, emb0)
    torch.cuda.synchronize()
    zero_launch_counts()
    got = _wd_parity_runs(cfg, "cuda", batches, dense0, emb0)
    torch.cuda.synchronize()
    counts = launch_counts()
    _no_kernel_launched("wide_deep_parity", counts)
    state["wide_deep_parity_launches"] = counts
    errs = {}
    for path, (wl, wp) in want.items():
        gl, gp = got[path]
        errs[path] = {
            "loss": max(abs(a - b) for a, b in zip(gl, wl)),
            "state": max(float(np.abs(gp[k] - w).max())
                         for k, w in wp.items())}
    bad = {p: e for p, e in errs.items()
           if not (e["loss"] <= WD_PARITY_TOL
                   and e["state"] <= WD_PARITY_TOL)}
    if bad:
        raise AssertionError(f"wide_deep_parity beyond {WD_PARITY_TOL}: "
                             f"{bad}")
    return {"config": f"dlrm_like at {WD_PARITY_VOCAB} rows a table, f32",
            "batch": WD_PARITY_BATCH, "steps": WD_PARITY_STEPS,
            "errors": errs, "tolerance": WD_PARITY_TOL,
            "losses": {p: (want[p][0], got[p][0]) for p in want},
            "launches": counts}


def _rank_checksum(tensors) -> tuple:
    """The float64 checksum of ``tensors`` on this rank, and whether every
    rank's equals it."""
    import torch
    import torch.distributed as dist
    total = torch.stack([t.detach().double().sum() for t in tensors]).sum()
    every = [torch.zeros_like(total) for _ in range(dist.get_world_size())]
    dist.all_gather(every, total)
    return total.item(), all(torch.equal(t, total) for t in every)


def _resnet_dp_rank() -> dict:
    """One rank of ``resnet_dp``: ResNet-50 bf16 on ``{"dp": world}`` at
    RESNET_BATCH images a card (timed), then the f32 parity run against
    single-device ``make_train_step`` on the global batch."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import resnet
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = topology.make_mesh({"dp": world}, device="cuda")
    out = {"rank": rank, "world": world}
    torch.backends.cudnn.benchmark = True
    cfg = resnet.ResNetConfig.resnet50()
    gb = RESNET_BATCH * world
    data = resnet.synthetic_images(gb, RESNET_IMAGE, cfg.num_classes, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}
    torch.cuda.reset_peak_memory_stats()
    st, step = resnet.make_sharded_train_step(cfg, mesh, gb, seed=0)
    losses = []
    for _ in range(2):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    torch.cuda.synchronize()
    zero_launch_counts()
    st, step_ms, timed = _step_events(step, st, batch, RESNET_DP_STEPS)
    counts = launch_counts()
    model = st["model"]
    checksum, agree = _rank_checksum(list(model.parameters())
                                     + list(model.buffers()))
    mean_s = float(np.mean(step_ms)) / 1e3
    out["timed"] = {"step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
                    "images_per_s": gb / mean_s,
                    "losses": losses + timed, "launches": counts,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "param_checksum": checksum, "ranks_agree": agree}
    del st, step, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # parity: f32, TF32 off, RESNET_PARITY_BATCH images a card at
    # RESNET_PARITY_IMAGE², against one card on the global batch
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.ResNetConfig.resnet50(dtype=torch.float32)
    src = resnet.ResNet(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    v = resnet.flax_variables(src)
    del src
    gb = RESNET_PARITY_BATCH * world
    data = resnet.synthetic_images(gb, RESNET_PARITY_IMAGE, cfg.num_classes,
                                   seed=1)
    data["image"] = data["image"] + np.repeat(      # a mean a data rank
        0.25 * np.arange(world, dtype=np.float32), RESNET_PARITY_BATCH
    )[:, None, None, None]
    batch = {k: torch.from_numpy(v_).to("cuda") for k, v_ in data.items()}
    ref = resnet.params_from_jax(cfg, v["params"], v["batch_stats"], "cuda")
    ropt = resnet.make_optimizer(cfg, ref.parameters())
    rstep = resnet.make_train_step(cfg, ref, ropt)
    rst = {"model": ref, "optimizer": ropt, "step": 0}
    st, step = resnet.make_sharded_train_step(
        cfg, mesh, gb, params=v["params"], batch_stats=v["batch_stats"])
    got_l, want_l = [], []
    for _ in range(RESNET_DP_PARITY_STEPS):
        rst, m = rstep(rst, batch)
        want_l.append(m["loss"].item())
        st, m = step(st, batch)
        got_l.append(m["loss"].item())
    want, got = _flat_variables(ref), _flat_variables(st["model"])
    upd, upd_leaf = _vec_rel(got, want, {
        f"params/{k}": a for k, a in _leaves(v["params"])})
    out["parity"] = {
        "losses": got_l, "want_losses": want_l,
        "loss": max(abs(a - b) for a, b in zip(got_l, want_l)),
        "params_max_abs_err": _tree_errs(got, want, "params/")[0],
        "update_rel": upd, "worst_update_leaf": upd_leaf,
        "stats": _tree_errs(got, want, "stats/")[0],
        "equal": got_l == want_l and all(
            np.array_equal(got[k], w) for k, w in want.items())}
    bootstrap.shutdown()
    return out


def phase_resnet_dp(state):
    """Data-parallel ResNet-50 (``resnet.make_sharded_train_step``, the
    BatchNorm statistics averaged over the data ranks) on one rank a
    visible card: bf16 at RESNET_BATCH images a card, two warm-up and
    RESNET_DP_STEPS timed steps (images/s against ``resnet_train``'s one
    card); then f32 with TF32 off at RESNET_PARITY_BATCH a card of
    RESNET_PARITY_IMAGE² (each rank's rows a different mean) against
    single-device ``make_train_step`` on the global batch,
    RESNET_DP_PARITY_STEPS step: the loss, the statistics and the
    parameters' update within RESNET_PARITY_TOL. No kernel of #1-#9; the ranks' variables
    agree."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(_resnet_dp_rank, world, device="cuda",
                                     timeout=900).return_values
    tol = RESNET_PARITY_TOL
    problems = []
    for r in ranks:
        t, p = r["timed"], r["parity"]
        tag = f"rank {r['rank']}"
        if any(t["launches"].values()):
            problems.append(f"{tag}: kernels ran {t['launches']}")
        if not t["losses"][-1] < t["losses"][0] or not t["ranks_agree"]:
            problems.append(f"{tag}: {t['losses']} agree={t['ranks_agree']}")
        if not (p["loss"] <= tol["loss"]
                and p["update_rel"] <= tol["update_rel"]
                and p["stats"] <= tol["stats"]):
            problems.append(f"{tag}: parity {p}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["resnet_dp_launches"] = ranks[0]["timed"]["launches"]
    return {"world": world, "batch_per_card": RESNET_BATCH,
            "image": RESNET_IMAGE, "steps": RESNET_DP_STEPS,
            "parity_batch_per_card": RESNET_PARITY_BATCH,
            "parity_image": RESNET_PARITY_IMAGE, "tolerances": tol,
            "ranks": ranks}


def _wd_tp_meshes(world: int) -> list:
    meshes = [{"tp": world}]
    if world == 4:
        meshes.append({"dp": 2, "tp": 2})
    return meshes


def _wide_deep_tp_rank() -> dict:
    """One rank of ``wide_deep_tp``: for each mesh, both W&D steps at
    ``dlrm_like`` (f32) with a first vocabulary tp does not divide, timed
    at WD_BATCH a data shard; then at WD_PARITY_VOCAB (+1) rows a table
    with TF32 off, against the single-device steps on the global batch
    from the same parameters and embedding state."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch import embedding as emb_lib
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import wide_deep
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        all_gather)
    bootstrap.initialize(device="cuda")
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"rank": rank, "world": world, "meshes": {}}
    for axes in _wd_tp_meshes(world):
        mesh = topology.make_mesh(axes, device="cuda")
        n_dp = axes.get("dp", 1)
        name = "x".join(f"{k}{v}" for k, v in axes.items())
        res = {}
        cfg = wide_deep.WideDeepConfig.dlrm_like(
            vocab_sizes=WD_TP_VOCABS)
        gb = WD_BATCH * n_dp
        batch = _wd_batch(cfg, gb, 0)
        for path in ("dense", "embedding"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if path == "dense":
                st, step = wide_deep.make_sharded_train_step(cfg, mesh, gb)
            else:
                st, step = wide_deep.make_embedding_train_step(cfg, mesh, gb)
            st, m = step(st, batch)
            losses = [m["loss"].item()]
            torch.cuda.synchronize()
            zero_launch_counts()
            st, step_ms, timed = _step_events(step, st, batch, WD_STEPS)
            counts = launch_counts()
            if path == "dense":
                local = {n: tuple(p.shape)
                         for n, p in st["model"].named_parameters()
                         if n in ("table_0", "wide_0")}
                held = _wd_state_bytes(
                    [*st["model"].parameters(),
                     *(s for d in st["optimizer"].state.values()
                       for s in d.values())])
            else:
                local = {"table_0": tuple(st["emb"]["tables"]["table_0"]
                                          .shape)}
                held = _wd_state_bytes(
                    [*st["emb"]["tables"].values(),
                     *(a for sl in st["emb"]["slots"].values()
                       for a in sl.values())])
            mean_s = float(np.mean(step_ms)) / 1e3
            res[path] = {"step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
                         "examples_per_s": gb / mean_s,
                         "losses": losses + timed, "launches": counts,
                         "local_shapes": local, "state_bytes": held,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            del st, step
            gc.collect()

        # parity at WD_PARITY_VOCAB rows a table, f32, TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        pcfg = wide_deep.WideDeepConfig.dlrm_like(
            vocab_sizes=(WD_PARITY_VOCAB + 1,) + (WD_PARITY_VOCAB,) * 25)
        pgb = WD_PARITY_BATCH * n_dp
        batches = [_wd_batch(pcfg, pgb, 60 + i)
                   for i in range(WD_PARITY_STEPS)]
        gen = torch.Generator().manual_seed(0)
        full = wide_deep.WideDeep(pcfg, device="cpu", generator=gen)
        params = {n: p.detach().numpy() for n, p in full.named_parameters()}
        ref = wide_deep.params_from_jax(pcfg, params, "cuda")
        ropt = wide_deep.make_optimizer(pcfg, ref.parameters())
        rstep = wide_deep.make_train_step(pcfg, ref, ropt)
        rst = {"model": ref, "optimizer": ropt, "step": 0}
        st, step = wide_deep.make_sharded_train_step(pcfg, mesh, pgb,
                                                     params=params)
        tower = wide_deep.flax_params(wide_deep.WideDeepDense(
            pcfg, device="cpu", generator=gen))
        emb0 = emb_lib.create_state(wide_deep.build_feature_config(pcfg),
                                    generator=gen, device="cpu")
        emb0 = {"tables": {k: v.numpy() for k, v in emb0["tables"].items()},
                "slots": {k: {s: a.numpy() for s, a in v.items()}
                          for k, v in emb0["slots"].items()}, "step": 0}
        est, estep = wide_deep.make_embedding_train_step(
            pcfg, mesh, pgb, dense_params=tower, emb_state=emb0)
        gst, gstep = wide_deep.make_embedding_train_step(
            pcfg, device="cuda", dense_params=tower, emb_state=emb0)
        par = {"loss": 0.0, "emb_loss": 0.0}
        for b in batches:
            rst, m0 = rstep(rst, b)
            st, m1 = step(st, b)
            par["loss"] = max(par["loss"], abs(m1["loss"].item()
                                               - m0["loss"].item()))
            gst, e0 = gstep(gst, b)
            est, e1 = estep(est, b)
            par["emb_loss"] = max(par["emb_loss"], abs(
                e1["loss"].item() - e0["loss"].item()))
        got = wide_deep.gather_params(st["model"], mesh)
        want = {n: p.detach().cpu().numpy()
                for n, p in ref.named_parameters()}
        par["params"] = max(float(np.abs(got[k] - w).max())
                            for k, w in want.items())
        tab_err = 0.0
        for k, t in est["emb"]["tables"].items():
            g = (all_gather(t.contiguous(), mesh, "tp") if "tp" in axes
                 else t)
            w = gst["emb"]["tables"][k]
            tab_err = max(tab_err, (g[:w.shape[0]] - w).abs().max().item())
        par["tables"] = tab_err
        res["parity"] = par
        torch.backends.cuda.matmul.allow_tf32 = True
        out["meshes"][name] = res
        del st, step, est, estep, gst, gstep, rst, rstep, ref
        gc.collect()
        torch.cuda.empty_cache()
    bootstrap.shutdown()
    return out


def phase_wide_deep_tp(state):
    """Tensor-parallel DLRM on one rank a visible card: ``{"tp": world}``
    and at four cards ``{"dp": 2, "tp": 2}``, with a first vocabulary of
    100,001 rows (no tp divides it: padded, its pad rows zero). Both
    steps (``make_sharded_train_step``, ``make_embedding_train_step``)
    timed at WD_BATCH a data shard: step ms, examples/s, the local row
    blocks, the state a rank holds, peak memory, a falling loss equal on
    every rank. Then f32 at WD_PARITY_VOCAB (+1) rows a table, both steps
    against the single-device ones on the global batch: losses and the
    gathered parameters and tables within WD_PARITY_TOL. No kernel of
    #1-#9."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    torch.cuda.empty_cache()
    world = torch.cuda.device_count()
    ranks = multi_process_runner.run(_wide_deep_tp_rank, world,
                                     device="cuda",
                                     timeout=900).return_values
    problems = []
    for r in ranks:
        for mesh, res in r["meshes"].items():
            for path in ("dense", "embedding"):
                v = res[path]
                tag = f"rank {r['rank']} {mesh} {path}"
                if any(v["launches"].values()):
                    problems.append(f"{tag}: kernels ran {v['launches']}")
                if not v["losses"][-1] < v["losses"][0]:
                    problems.append(f"{tag}: losses {v['losses']}")
                if v["losses"] != ranks[0]["meshes"][mesh][path]["losses"]:
                    problems.append(f"{tag}: loss differs from rank 0's")
            p = res["parity"]
            if not all(x <= WD_PARITY_TOL for x in p.values()):
                problems.append(f"rank {r['rank']} {mesh} parity {p}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["wide_deep_tp_launches"] = {
        f"{m}_{p}": res[p]["launches"]
        for m, res in ranks[0]["meshes"].items()
        for p in ("dense", "embedding")}
    return {"world": world, "vocab_sizes": "100001, then 25 x 100000",
            "batch_per_data_shard": WD_BATCH, "steps": WD_STEPS,
            "parity_tolerance": WD_PARITY_TOL, "ranks": ranks}


# ---------------------------------------------------------------------------
# checkpointing, the engine's restore entry points, the online DLRM
# ---------------------------------------------------------------------------

def _ckpt_root() -> str:
    """Where the checkpoint phases write (``build/`` is git-ignored)."""
    return os.path.join(ROOT, "build", "ckpt_smoke")


def _ckpt_nbytes(path: str) -> int:
    """The shard bytes a committed checkpoint directory's index records."""
    with open(os.path.join(path, "checkpoint.index.json")) as f:
        return sum(m["size"] for m in json.load(f)["shards"].values())


def _variable_values(variables) -> dict:
    """Each variable's global value, cloned on its device."""
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        _flatten)
    return {k: v.read_value().clone()
            for k, v in _flatten(variables).items()}


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def _ckpt_train_run(fused: bool) -> tuple:
    """The headline step (``_headline_config``, batch TRAIN_BATCH, bf16
    ``mu``; ``fused``: the fused AdamW) trained CKPT_STEPS steps; at step
    CKPT_AT the train state (``models/transformer.train_state_variables``)
    is saved through a ``CheckpointManager`` with a ``local_dir`` tier,
    ``async_write=True`` (the durable re-commit pipelined behind steps
    CKPT_AT+1..). A fresh model (another seed) restores it with
    ``restore_latest`` and trains the remaining steps: the restored
    state must equal the saved one bitwise; the resumed losses and final
    state are held to the uninterrupted run's, and a second resume from
    the same checkpoint gives the kernels' own run-to-run spread. Also
    times a restore from the durable tier. Launch counters from 0 before
    the first step to after the last resumed one."""
    import numpy as np
    import torch
    import shutil
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        train_state_variables)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _headline_config(fused_optimizer=fused)
    per_step = FUSED_LAUNCHES if fused else TRAIN_LAUNCHES
    root = os.path.join(_ckpt_root(), "fused" if fused else "plain")
    shutil.rmtree(root, ignore_errors=True)
    durable, local = os.path.join(root, "durable"), os.path.join(root,
                                                                 "local")

    def build(seed):
        model, opt, step, batch = _train_setup(cfg, seed, TRAIN_BATCH)
        st = {"model": model, "optimizer": opt, "step": 0}
        variables = train_state_variables(cfg, st)
        ckpt = Checkpoint(**variables, step=np.int64(0))
        return st, step, batch, variables, ckpt, CheckpointManager(
            ckpt, durable, local_dir=local, max_to_keep=2)

    st, step, batch, variables, ckpt, mgr = build(0)
    torch.cuda.synchronize()
    zero_launch_counts()
    losses, saved = [], None
    for _ in range(CKPT_STEPS):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
        if st["step"] == CKPT_AT:
            saved = _variable_values(variables)
            ckpt._objects["step"] = np.int64(st["step"])
            torch.cuda.synchronize()
            mgr.save(CKPT_AT, async_write=True)
            blocking_ms = ckpt.last_timings["blocking"] * 1e3
    t0 = time.perf_counter()
    ckpt.sync()
    sync_wait_ms = (time.perf_counter() - t0) * 1e3
    commit_s = ckpt.last_timings["commit"]
    final = _variable_values(variables)
    saved_params = {k: v.cpu() for k, v in saved.items()
                    if k.startswith("params/")}
    del st, step, variables, ckpt, mgr
    torch.cuda.empty_cache()
    nbytes = _ckpt_nbytes(os.path.join(local, f"ckpt-{CKPT_AT}"))

    st, step, _batch, variables, ckpt, mgr = build(1)   # the run's batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore(os.path.join(durable, f"ckpt-{CKPT_AT}"))
    torch.cuda.synchronize()
    durable_restore_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        tier, number, flat = mgr.restore_latest()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        st["step"] = int(flat["step"])
        restored = _variable_values(variables)
        equal = all(restored[k].dtype == saved[k].dtype
                    and torch.equal(restored[k], saved[k]) for k in saved)
        del restored
        resumed = []
        for _ in range(CKPT_STEPS - CKPT_AT):
            st, m = step(st, batch)
            resumed.append(m["loss"].item())
        runs.append({"tier": tier, "step": number, "restore_s": restore_s,
                     "restored_equals_saved": equal, "losses": resumed,
                     "state": _variable_values(variables)})
    torch.cuda.synchronize()
    counts = launch_counts()
    if not fused:
        ckpt._objects["step"] = np.int64(st["step"])
        mgr.save(CKPT_STEPS, async_write=False)
    final_params = {k: v.cpu() for k, v in runs[0]["state"].items()
                    if k.startswith("params/")}
    a, b = runs
    expected = expected_counts(per_step,
                               CKPT_STEPS + 2 * (CKPT_STEPS - CKPT_AT))
    out = {
        "config": "transformer_big", "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq_len": cfg.max_seq_len,
        "fused_optimizer": fused, "steps": CKPT_STEPS, "saved_at": CKPT_AT,
        "tensors": len(saved), "checkpoint_bytes": nbytes,
        "save_blocking_ms": blocking_ms, "sync_wait_ms": sync_wait_ms,
        "commit_s": commit_s,
        "local_commit_gb_s": nbytes / commit_s["local"] / 1e9,
        "durable_commit_gb_s": nbytes / commit_s["durable"] / 1e9,
        "restore": {"tier": a["tier"], "step": a["step"],
                    "seconds": a["restore_s"],
                    "gb_s": nbytes / a["restore_s"] / 1e9},
        "durable_restore": {"seconds": durable_restore_s,
                            "gb_s": nbytes / durable_restore_s / 1e9},
        "losses": losses, "resumed_losses": [r["losses"] for r in runs],
        "restored_equals_saved": [r["restored_equals_saved"] for r in runs],
        "resumed_bitwise": (a["losses"] == losses[CKPT_AT:] and all(
            torch.equal(a["state"][k], final[k]) for k in final)),
        "resumed_max_abs_loss_diff": max(
            abs(x - y) for x, y in zip(a["losses"], losses[CKPT_AT:])),
        "resumed_max_abs_state_diff": _max_diff(a["state"], final),
        "repeat_max_abs_loss_diff": max(
            abs(x - y) for x, y in zip(a["losses"], b["losses"])),
        "repeat_max_abs_state_diff": _max_diff(a["state"], b["state"]),
        "launches": counts, "expected_launches": expected,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    problems = []
    if counts != expected:
        problems.append(f"launches {counts} != {expected}")
    if any(counts[k] == 0 for k in per_step):
        problems.append(f"a kernel of the path never launched: {counts}")
    if not all(out["restored_equals_saved"]):
        problems.append("the restored state differs from the saved one")
    if (a["tier"], a["step"]) != ("local", CKPT_AT):
        problems.append(f"restored tier/step {a['tier']}/{a['step']}")
    if not all(math.isfinite(x) for x in losses + a["losses"]):
        problems.append(f"losses {losses} {a['losses']}")
    # the kernels' own spread bounds the resume's: the same checkpoint
    # resumed twice differs as much as resume and uninterrupted do
    if out["resumed_max_abs_loss_diff"] > max(
            CKPT_LOSS_TOL, 2 * out["repeat_max_abs_loss_diff"]):
        problems.append(f"resumed losses {a['losses']} against "
                        f"{losses[CKPT_AT:]}")
    del runs, final, saved
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("; ".join(problems))
    return out, counts, saved_params, final_params, (durable, local)


def phase_ckpt_train(state):
    """``ckpt_train``: :func:`_ckpt_train_run` with the plain AdamW, then
    with ``fused_optimizer=True`` (#9). The plain run leaves steps
    CKPT_AT and CKPT_STEPS in its directories for ``ckpt_serve``."""
    import torch
    torch.cuda.empty_cache()
    plain, counts, params3, params6, dirs = _ckpt_train_run(False)
    state["ckpt_train_launches"] = counts
    state["ckpt_dirs"] = dirs
    state["ckpt_params"] = {CKPT_AT: params3, CKPT_STEPS: params6}
    fused, counts, *_ = _ckpt_train_run(True)
    state["ckpt_train_fused_launches"] = counts
    return {"plain": plain, "fused": fused}


def _serve_stream(engine, prompts, swap_at=None, swap=None) -> tuple:
    """Serve ``prompts`` (CKPT_SERVE_NEW new tokens each) step by step;
    once ``swap_at`` completions have landed, ``swap(engine)`` runs once
    between two steps. Returns ``({id: (tokens, version step)}, the
    step index of the swap's call, each step's weights step)``."""
    from distributed_tensorflow_tpu_torch.serving.engine import Request
    for i, p in enumerate(prompts):
        engine.submit(Request(id=f"c{i}", tokens=p,
                              max_new_tokens=CKPT_SERVE_NEW))
    out, called, versions, n = {}, None, [], 0
    while not engine.scheduler.idle:
        for rec in engine.step():
            out[rec["id"]] = (tuple(int(t) for t in rec["tokens"]),
                              int(rec["model_version"].split("@")[0]))
        versions.append(engine.weights_step)
        n += 1
        if swap is not None and called is None and len(out) >= swap_at:
            swap(engine)
            called = n
    return out, called, versions


def phase_ckpt_serve(state):
    """``ckpt_serve``: ``InferenceEngine.from_checkpoint`` at the headline
    config (bf16, ``transformer_big``) from ``ckpt_train``'s directories,
    pinned at step CKPT_AT, serves CKPT_SERVE_REQUESTS requests; its
    greedy streams must equal an engine built directly from the saved
    parameters. Then the same requests with ``begin_load_version(
    CKPT_STEPS)`` once two completions landed (the restore on its thread;
    joined, so the flip lands at the next step boundary), against the
    direct engine given ``install_version`` at the same boundary: equal
    streams and versions, requests in flight requeued. Launches of
    #1 (``flash_fwd_tc``): 12 a prefill. Then #1 at the longest prompt's
    prefill shape against its plain version."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        params_from_flat)
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    torch.cuda.empty_cache()
    cfg = _headline_config()
    durable, local = state["ckpt_dirs"]
    kw = dict(device="cuda", block_size=SERVE_BLOCK, max_slots=SERVE_SLOTS,
              num_blocks=SERVE_SLOTS * cfg.max_seq_len // SERVE_BLOCK + 1)
    rng = np.random.default_rng(3)
    lens = rng.integers(16, cfg.max_seq_len - CKPT_SERVE_NEW,
                        CKPT_SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    def direct(step):
        return params_from_flat(cfg, state["ckpt_params"][step], "params",
                                "cuda")

    t0 = time.perf_counter()
    eng = InferenceEngine.from_checkpoint(cfg, durable, local_dir=local,
                                          at_step=CKPT_AT, **kw)
    from_checkpoint_s = time.perf_counter() - t0
    ref = InferenceEngine(cfg, direct(CKPT_AT), snapshot_step=CKPT_AT,
                          **kw)
    torch.cuda.synchronize()
    zero_launch_counts()
    p0 = eng.prefills
    got, _, _ = _serve_stream(eng, prompts)
    torch.cuda.synchronize()
    counts = launch_counts()
    prefills = eng.prefills - p0
    want, _, _ = _serve_stream(ref, prompts)

    params6 = direct(CKPT_STEPS)
    zero_launch_counts()
    p0 = eng.prefills
    load = {}

    def begin(engine):
        t = time.perf_counter()
        assert engine.begin_load_version(CKPT_STEPS)
        engine._swap_thread.join()
        load["restore_s"] = time.perf_counter() - t
        load["requeue_pending"] = len(engine.scheduler.running)

    swapped, called, versions = _serve_stream(eng, prompts, 2, begin)
    torch.cuda.synchronize()
    swap_counts = launch_counts()
    swap_prefills = eng.prefills - p0
    ref = InferenceEngine(cfg, direct(CKPT_AT), snapshot_step=CKPT_AT,
                          **kw)
    info = {}
    ref_swapped, ref_called, ref_versions = _serve_stream(
        ref, prompts, 2, lambda e: info.update(e.install_version(
            params6, step=CKPT_STEPS)))
    del ref, params6
    # #1 at the longest prompt's prefill against its plain version
    gen = torch.Generator(device="cuda").manual_seed(3)
    s = int(max(lens))
    q, k, v = (_rand((1, cfg.n_heads, s, cfg.head_dim), torch.bfloat16,
                     gen) for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    check = _fwd_errors(q, k, v, o, lse, True)
    problems = []
    if got != want:
        problems.append("from_checkpoint's streams differ from the engine "
                        "built from the saved parameters")
    if {v for _, v in got.values()} != {CKPT_AT}:
        problems.append(f"versions {set(v for _, v in got.values())}")
    if counts["flash_fwd_tc"] != cfg.n_layers * prefills or any(
            n for name, n in counts.items() if name != "flash_fwd_tc"):
        problems.append(f"launches {counts} for {prefills} prefills")
    if swapped != ref_swapped or versions != ref_versions:
        problems.append("the background-loaded swap differs from "
                        "install_version at the same boundary")
    flips = [i for i in range(1, len(versions))
             if versions[i] != versions[i - 1]]
    if flips != [called] or versions[-1] != CKPT_STEPS:
        problems.append(f"weights by step {versions}, swap called after "
                        f"step {called}")
    if not load.get("requeue_pending") or info.get("requeued") != \
            load["requeue_pending"]:
        problems.append(f"no request in flight at the swap: {load} {info}")
    if {v for _, v in swapped.values()} != {CKPT_AT, CKPT_STEPS}:
        problems.append(f"versions {set(v for _, v in swapped.values())}")
    if swap_counts["flash_fwd_tc"] != cfg.n_layers * swap_prefills:
        problems.append(f"launches {swap_counts} for {swap_prefills} "
                        f"prefills")
    if not check["ok"]:
        problems.append(f"flash_fwd_tc at ({s}) disagrees: {check}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["ckpt_serve_launches"] = {
        n: counts[n] + swap_counts[n] for n in counts}
    del eng
    torch.cuda.empty_cache()
    return {"config": "transformer_big (the headline config)",
            "dtype": "bfloat16", "requests": CKPT_SERVE_REQUESTS,
            "new_tokens": CKPT_SERVE_NEW,
            "prompt_lens": [int(n) for n in lens],
            "from_checkpoint_s": from_checkpoint_s,
            "streams_equal_direct": True, "prefills": prefills,
            "swap_prefills": swap_prefills, "load": load,
            "swap_called_after_step": called, "weights_by_step": versions,
            "requeued": info.get("requeued"),
            "launches": counts, "swap_launches": swap_counts,
            "flash_fwd_tc_prefill_check": {"shape": [1, cfg.n_heads, s,
                                                     cfg.head_dim],
                                           **check}}


def phase_online_train(state):
    """``online_train``: ``OnlineConfig()`` (the JAX online job's shape)
    on the card: ONLINE_EVENTS seeded events written to a stream log,
    ``OnlineTrainer`` with ``commit_every=5`` crashed after
    ONLINE_CRASH_AFTER applied batches (an uncommitted one), a restore
    and the rest; against an uncrashed run of the same log: the committed
    offset, no committed event replayed, table membership equal and the
    parameters and tables within ONLINE_TOL. Events/s of both; no kernel
    of #1-#9."""
    import pickle
    import shutil
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.input import stream
    from distributed_tensorflow_tpu_torch.models import online_dlrm as od
    cfg = od.OnlineConfig()
    root = os.path.join(_ckpt_root(), "online")
    shutil.rmtree(root, ignore_errors=True)
    log = os.path.join(root, "events.log")
    with stream.StreamWriter.open(log) as w:
        stream.append_chunk(w, stream.seeded_events(
            cfg.seed, 0, ONLINE_EVENTS, n_users=cfg.n_users,
            n_items=cfg.n_items, zipf_a=cfg.zipf_a))

    def trainer(ck):
        return od.OnlineTrainer(cfg, log, os.path.join(root, ck),
                                commit_every=5, device="cuda")

    zero_launch_counts()
    t1 = trainer("ck")
    try:
        t1.run(ONLINE_EVENTS, idle_timeout_s=5.0,
               crash_after_batches=ONLINE_CRASH_AFTER)
        crashed = False
    except RuntimeError:
        crashed = True
    t2 = trainer("ck")
    resumed = t2.restore()
    out2 = t2.run(ONLINE_EVENTS, idle_timeout_s=5.0)
    ref = trainer("ck_ref")
    ref_out = ref.run(ONLINE_EVENTS, idle_timeout_s=5.0)
    torch.cuda.synchronize()
    counts = launch_counts()
    a, b = t2._state_nested(), ref._state_nested()

    def aux(sd):
        return pickle.loads(np.asarray(sd["aux"], np.uint8).tobytes())

    membership = all(aux(a[t])["id_to_row"] == aux(b[t])["id_to_row"]
                     for t in ("user", "item"))
    diffs = {f"{t}/rows": float(np.abs(a[t]["rows"] - b[t]["rows"]).max())
             for t in ("user", "item")}
    diffs.update({f"dense/{k}": float(np.abs(v - b["dense"]["params"][k])
                                      .max())
                  for k, v in a["dense"]["params"].items()})
    bs = cfg.batch_size
    committed = (ONLINE_CRASH_AFTER // 5) * 5 * bs
    problems = []
    if not crashed or resumed != committed:
        problems.append(f"crashed {crashed}, resumed at {resumed} "
                        f"(committed {committed})")
    if out2["events_applied"] != ONLINE_EVENTS - committed:
        problems.append(f"the restored trainer applied "
                        f"{out2['events_applied']} events")
    if out2["offset"] != ref_out["offset"] != ONLINE_EVENTS:
        problems.append(f"offsets {out2['offset']} {ref_out['offset']}")
    if not membership or out2["tables"] != ref_out["tables"]:
        problems.append(f"membership {out2['tables']} {ref_out['tables']}")
    if max(diffs.values()) > ONLINE_TOL:
        problems.append(f"state differs from the uncrashed run: {diffs}")
    if any(counts.values()):
        problems.append(f"a kernel of #1-#9 ran: {counts}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["online_train_launches"] = counts
    return {"config": "OnlineConfig()", "events": ONLINE_EVENTS,
            "batch": bs, "commit_every": 5,
            "crash_after_batches": ONLINE_CRASH_AFTER,
            "resumed_offset": resumed, "commits": out2["commits"],
            "events_per_s_restored": out2["events_per_sec"],
            "events_per_s_uncrashed": ref_out["events_per_sec"],
            "tables": ref_out["tables"], "loss_last": ref_out["loss_last"],
            "max_abs_diff_vs_uncrashed": diffs, "launches": counts}


def _digest(values: dict) -> dict:
    """Each leaf's dtype, shape and crc32 of its bytes (bitwise identity
    without shipping the tensors between processes)."""
    import zlib
    import torch
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        to_numpy)
    out = {}
    for k, t in values.items():
        t = t.detach().contiguous().cpu()
        out[k] = (str(t.dtype), tuple(t.shape),
                  zlib.crc32(to_numpy(t).tobytes()))
    return out


def _ckpt_mesh_rank(workdir: str) -> dict:
    """One rank of ``ckpt_mesh`` (four ranks): CKPT_MESH_LAYERS layers of
    the headline config trained 2 steps on ``{"dp": 2, "tp": 2}`` and
    saved (``local_dir`` tier, a ``SnapshotStore`` a rank ring-replicated
    over the coordination KV, then one more memory-only snapshot);
    restored onto ``{"tp": 4}``; then rank 1's memory is wiped and
    ``restore_latest`` walks the ladder on a fresh ``{"tp": 4}`` model.
    Returns digests of the global values."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.checkpoint import (
        peer_snapshot as ps)
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_sharded_train_step, train_state_variables)
    bootstrap.initialize(device="cuda")
    rank = dist.get_rank()
    agent = coordination_service()
    cfg = _headline_config(n_layers=CKPT_MESH_LAYERS)
    gb = 2 * TRAIN_BATCH
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (gb, cfg.max_seq_len))).to("cuda")
    mem = os.path.join(workdir, "mem", f"w{rank}")

    def build(axes, seed, store=None):
        mesh = topology.make_mesh(axes, device="cuda")
        st, step = make_sharded_train_step(cfg, mesh, gb, seed=seed)
        variables = train_state_variables(cfg, st, mesh)
        ckpt = Checkpoint(**variables, step=np.int64(0))
        mgr = CheckpointManager(ckpt, os.path.join(workdir, "durable"),
                                local_dir=os.path.join(workdir, "local"),
                                snapshot_store=store)
        return st, step, variables, ckpt, mgr

    out = {"rank": rank}
    st, step, variables, ckpt, mgr = build({"dp": 2, "tp": 2}, 0,
                                           ps.SnapshotStore(mem))
    for _ in range(2):
        st, m = step(st, {"tokens": tokens})
    ckpt._objects["step"] = np.int64(st["step"])
    t0 = time.perf_counter()
    mgr.save(2, async_write=False)
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.snapshot(3)
    out["snapshot_s"] = time.perf_counter() - t0
    out["saved"] = _digest(_variable_values(variables))
    del st, step, variables, ckpt, mgr
    torch.cuda.empty_cache()

    st, step, variables, ckpt, mgr = build({"tp": 4}, 1)
    t0 = time.perf_counter()
    tier, n, _flat = mgr.restore_latest()
    out["tp4"] = {"tier": tier, "step": n,
                  "seconds": time.perf_counter() - t0,
                  "digest": _digest(_variable_values(variables))}
    st, m = step(st, {"tokens": tokens})
    out["tp4_loss"] = m["loss"].item()
    del st, step, variables, ckpt, mgr
    torch.cuda.empty_cache()

    agent.barrier("ckpt_mesh/before_wipe", timeout_s=300)
    if rank == 1:
        ps.wipe_memdir(mem)
    agent.barrier("ckpt_mesh/wiped", timeout_s=300)
    store = ps.SnapshotStore(mem)
    st, step, variables, ckpt, mgr = build({"tp": 4}, 2, store)
    t0 = time.perf_counter()
    tier, n, _flat = mgr.restore_latest()
    out["ladder"] = {"tier": tier, "step": n,
                     "seconds": time.perf_counter() - t0,
                     **{k: mgr.last_restore[k]
                        for k in ("available", "best_available")},
                     "inventory": store.inventory(),
                     "digest": _digest(_variable_values(variables))}
    agent.barrier("ckpt_mesh/done", timeout_s=300)
    bootstrap.shutdown()
    return out


def _ckpt_one_card_rank(workdir: str) -> dict:
    """One card restores ``ckpt_mesh``'s dp2×tp2 save (disk tiers only):
    the single-device model's state digests."""
    import numpy as np
    import torch
    from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
        Checkpoint, CheckpointManager)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.models.transformer import (
        train_state_variables)
    bootstrap.initialize(device="cuda")
    cfg = _headline_config(n_layers=CKPT_MESH_LAYERS)
    model, opt, _step, _batch = _train_setup(cfg, 3, 1)
    variables = train_state_variables(cfg, {"model": model,
                                            "optimizer": opt, "step": 0})
    mgr = CheckpointManager(Checkpoint(**variables, step=np.int64(0)),
                            os.path.join(workdir, "durable"),
                            local_dir=os.path.join(workdir, "local"))
    tier, n, _flat = mgr.restore_latest()
    out = {"tier": tier, "step": n,
           "digest": _digest(_variable_values(variables))}
    bootstrap.shutdown()
    return out


def phase_ckpt_mesh(state):
    """``ckpt_mesh`` (four cards): :func:`_ckpt_mesh_rank` — a dp2×tp2
    save restores onto tp 4 and (:func:`_ckpt_one_card_rank`) onto one
    card bitwise; after rank 1's memory is wiped every rank restores the
    freshest state from memory (tier ``peer``, parts fetched over the
    KV), the best tier available, bitwise."""
    import shutil
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    world = torch.cuda.device_count()
    if world < 4:
        raise AssertionError(f"ckpt_mesh needs four cards, {world} visible")
    workdir = os.path.join(_ckpt_root(), "mesh")
    shutil.rmtree(workdir, ignore_errors=True)
    ranks = multi_process_runner.run(_ckpt_mesh_rank, 4, args=(workdir,),
                                     device="cuda", timeout=900).return_values
    one = multi_process_runner.run(_ckpt_one_card_rank, 1, args=(workdir,),
                                   device="cuda", timeout=600).return_values[0]
    saved = ranks[0]["saved"]

    def differ(digest) -> str:
        bad = [k for k in saved if digest.get(k) != saved[k]]
        return f"{len(bad)} of {len(saved)} leaves differ ({bad[:3]})"

    problems = []
    for r in ranks:
        tag = f"rank {r['rank']}"
        if r["saved"] != saved:
            problems.append(f"{tag}: saved digests differ")
        if (r["tp4"]["tier"], r["tp4"]["step"]) != ("local", 2):
            problems.append(f"{tag}: tp4 restored {r['tp4']['tier']} "
                            f"{r['tp4']['step']}")
        if r["tp4"]["digest"] != saved:
            problems.append(f"{tag}: the tp4 restore: "
                            f"{differ(r['tp4']['digest'])}")
        lad = r["ladder"]
        if (lad["tier"], lad["step"]) != ("peer", 3) \
                or lad["best_available"] != "memory" \
                or lad["digest"] != saved:
            problems.append(f"{tag}: ladder {lad['tier']} {lad['step']} "
                            f"{lad['best_available']}: "
                            f"{differ(lad['digest'])}")
    if one["digest"] != saved or (one["tier"], one["step"]) != ("local", 2):
        problems.append(f"one card restored {one['tier']} {one['step']}: "
                        f"{differ(one['digest'])}")
    if problems:
        raise AssertionError("; ".join(problems))
    for r in ranks:
        for key in ("saved",):
            r.pop(key)
        r["tp4"].pop("digest")
        r["ladder"].pop("digest")
    return {"world": world, "config": f"transformer_big width, "
            f"{CKPT_MESH_LAYERS} layers, bf16", "ranks": ranks,
            "one_card": {"tier": one["tier"], "step": one["step"]}}


def phase_mesh_repair(state):
    """``mesh_repair`` (four cards): C-4(c) ``make_sharded_train_step``
    on ``{"dp": 2, "pp": 2}`` and ``{"pp": 2, "tp": 2}``
    (:func:`_shard_parity_rank`, fsdp_parity's rule), C-4(d)
    ``make_pipelined_train_step`` GPipe and 1F1B on ``{"pp": 2, "tp":
    2}`` (:func:`_pp_parity_rank`, pp_parity's rule): pp_parity's f32
    config against the single-device step on the same global batch."""
    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    world = torch.cuda.device_count()
    if world < 4:
        raise AssertionError(f"mesh_repair needs four cards, {world} "
                             f"visible")
    torch.cuda.empty_cache()
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    sharded = multi_process_runner.run(
        _shard_parity_rank, 4, args=(MESH_REPAIR_SHARDED, {}),
        device="cuda", timeout=900, env=env).return_values
    piped = multi_process_runner.run(
        _pp_parity_rank, 4, args=(MESH_REPAIR_PIPELINED,), device="cuda",
        timeout=900, env=env).return_values
    problems = _shard_parity_problems(sharded) + _pp_parity_problems(piped)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"world": world, "config": "transformer_big width, "
            f"{PP_PARITY_LAYERS} layers, f32, full logits",
            "sharded": sharded, "pipelined": piped}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="run only these phases (comma-separated) after "
                         "device and build, and no kernels line")
    args = ap.parse_args(argv)
    only = (None if args.phases is None
            else {"device", "build", *args.phases.split(",")})
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
                     ("dp_parity", phase_dp_parity),
                     ("tp_shards", phase_tp_shards),
                     ("tp_train", phase_tp_train),
                     ("tp_parity", phase_tp_parity),
                     ("tp_serve", phase_tp_serve),
                     ("pp_kernels", phase_pp_kernels),
                     ("pp_train", phase_pp_train),
                     ("pp_parity", phase_pp_parity),
                     ("sp_kernels", phase_sp_kernels),
                     ("sp_train", phase_sp_train),
                     ("sp_parity", phase_sp_parity),
                     ("moe_train", phase_moe_train),
                     ("moe_parity", phase_moe_parity),
                     ("fsdp_train", phase_fsdp_train),
                     ("fsdp_parity", phase_fsdp_parity),
                     ("resnet_train", phase_resnet_train),
                     ("resnet_parity", phase_resnet_parity),
                     ("resnet_dp", phase_resnet_dp),
                     ("mnist_train", phase_mnist_train),
                     ("wide_deep_train", phase_wide_deep_train),
                     ("wide_deep_parity", phase_wide_deep_parity),
                     ("wide_deep_tp", phase_wide_deep_tp),
                     ("ckpt_train", phase_ckpt_train),
                     ("ckpt_serve", phase_ckpt_serve),
                     ("online_train", phase_online_train),
                     ("ckpt_mesh", phase_ckpt_mesh),
                     ("mesh_repair", phase_mesh_repair)):
        if only and name not in only:
            continue
        if name in FOUR_CARD_PHASES and not only \
                and torch.cuda.device_count() < 4:
            continue
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
    if only:
        print(state["smi"], flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": state["kind"],
            "count": torch.cuda.device_count()}})
        return 0
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
        # the tensor-parallel runs of tp_train (rank 0), each from 0, and
        # the kernel at the tp shard shapes of tp_shards
        row["tp_launches"] = {v: c[name]
                              for v, c in state["tp_launches"].items()}
        if name in state["tp_rows"]:
            row["tp"] = state["tp_rows"][name]
        if name == "flash_fwd_tc":
            row["tp_serve_launches"] = state["tp_serve_launches"][name]
        # the pipelined runs of pp_train (rank 0, over each run's timed
        # steps), and the kernel at the pipeline's microbatch shape
        row["pp_launches"] = {run: c[name]
                              for run, c in state["pp_launches"].items()}
        if name in state["pp_rows"]:
            row["pp"] = state["pp_rows"][name]
        # the sequence-parallel runs of sp_train (rank 0, over each run's
        # timed steps), and the kernel at the ring's block shape, each
        # kind of block it launches
        row["sp_launches"] = {run: c[name]
                              for run, c in state["sp_launches"].items()}
        if name in state["sp_rows"]:
            row["sp"] = state["sp_rows"][name]
        # the MoE and fully-sharded runs of moe_train and fsdp_train
        # (rank 0, over each run's timed steps)
        for path in ("moe", "fsdp"):
            row[f"{path}_launches"] = {
                run: c[name] for run, c in state[f"{path}_launches"].items()}
        # the other workloads' runs, each from 0: none of #1-#9 is on
        # their paths (convolutions, BatchNorm, gathers, scatter-adds)
        row["other_workload_launches"] = {
            path: state[f"{path}_launches"][name]
            for path in ("resnet_train", "resnet_parity", "mnist_train",
                         "wide_deep_train", "wide_deep_parity")}
        row["other_workload_launches"]["resnet_dp"] = state[
            "resnet_dp_launches"][name]
        row["other_workload_launches"]["wide_deep_tp"] = {
            run: c[name] for run, c in state["wide_deep_tp_launches"].items()}
        # the checkpoint phases, each from 0: ckpt_train (CKPT_STEPS steps
        # and two resumes, plain and fused AdamW) at the train step's
        # shapes, ckpt_serve's prefills at the serve path's, the online
        # DLRM none
        row["ckpt_launches"] = {
            path: state[f"{path}_launches"][name]
            for path in ("ckpt_train", "ckpt_train_fused", "ckpt_serve",
                         "online_train")}
        summary.append(row)
    emit({"kernels": summary})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

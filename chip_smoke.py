#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``distributed_tensorflow_tpu_torch``) on the card, its
serving path and its train step, and checks them in phases, each
printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — builds every CUDA kernel source with ``nvcc`` into
   ``build/torch_kernels/``, one ``nvcc`` per source, all started
   together; reports each one's time, registers and spills.
3. ``kernels`` — each kernel's wrapper against its plain PyTorch
   version on the card, in bf16 and f32, at the main paths' shapes and
   at the edges (ragged tails, causal offsets, fully-masked rows, vocab
   tails, targets on tile edges, two row chunks), with the tolerances
   below; the cross-entropy backward variants "a" and "split" through
   the public op ``fused_cross_entropy`` and autograd, each against its
   plain versions and against variant "b", their launches counted over
   that run; the fused AdamW on ``transformer_big``'s leaf shapes, f32
   and bf16 ``mu``, steps 1 and 1000. Then each kernel, its plain
   version and a PyTorch library yardstick timed at the train step's
   shapes with CUDA events, in turns plain, kernel, kernel, plain.
4. ``serve``   — ``InferenceEngine.generate`` at the full width of
   ``transformer_big`` in bf16 (random weights from seed 0), 8 requests
   × 32 new tokens. The launch counters are set to 0 just before and
   read just after: ``flash_fwd`` must run exactly once per layer per
   prefill.
5. ``parity``  — the serving path in f32: decode logits at every
   generated position against ``TransformerLM`` full-sequence
   recompute, and greedy tokens wherever the top-2 gap is clear.
6. ``train``   — the train step (``make_train_step``) of ``bench.py``'s
   headline row at the full width and depth of ``transformer_big`` in
   bf16: batch 8 × 1024, no remat, unrolled layers, kernel
   cross-entropy, bf16 AdamW first moment; one warm-up step, then 5
   steps timed with CUDA events on one seeded token batch. The counters
   are set to 0 before the timed steps and read after: per step 12
   ``flash_fwd``, 12 ``flash_bwd_dq``, 12 ``flash_bwd_dkv``, 2
   ``fused_ce_fwd`` and 2 ``fused_ce_bwd`` launches. The first loss must
   lie within 1.0 of ln V and the loss must fall. A smoke run, not a
   benchmark.
7. ``train_fused`` — the same with ``fused_optimizer=True``: per step
   also 98 ``fused_adamw`` launches (one per parameter tensor), and the
   plain ``AdamW.step`` is never reached.
8. ``train_parity`` — f32 with TF32 off: the kernel path against the
   reference configuration (``mha_reference``, full-logits loss) from
   the same weights at full width, 2 layers, batch 2 × 256: loss,
   every gradient leaf, and the parameters after 3 AdamW steps.
9. ``train_options`` — the same size, one step: ``remat=True`` with the
   "nothing" and "dots" policies against ``remat=False``, and the
   scan-chunked loss (8 chunks, both chunk policies) against full
   logits: loss and every gradient leaf.

Then a ``{"kernels": [...]}`` line (per kernel: launches on the path
that runs it, error, measured times and the bound), the ``nvidia-smi``
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

SOURCES = ("flash_fwd", "flash_bwd", "fused_ce", "fused_adamw")
SERVE_SLOTS, SERVE_BLOCK, SERVE_REQUESTS, SERVE_NEW = 8, 16, 8, 32
PARITY_REQUESTS, PARITY_NEW = 4, 16
TRAIN_BATCH, TRAIN_STEPS = 8, 5
# kernels launched per train step of transformer_big at batch 8 x 1024:
# one flash forward, dq and dkv a layer; one CE forward and backward per
# 4096-row chunk of the 8192 tokens
TRAIN_LAUNCHES = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                  "fused_ce_fwd": 2, "fused_ce_bwd": 2}
# with fused_optimizer=True also one AdamW launch per parameter tensor:
# 12 layers x 8 tensors, the embedding and the final norm's scale
FUSED_LAUNCHES = {**TRAIN_LAUNCHES, "fused_adamw": 98}
TRAIN_PARITY_STEPS = 3
# fused AdamW against its plain version: p, nu and an f32 mu within
# ADAMW_ULP f32 units in the last place (the kernel rounds each operation
# as the plain version does); a bf16 mu the same value or its neighbour
ADAMW_ULP = 2
ADAMW_MU_BF16_ULP = 1

KERNELS = {   # name: (source, TPU kernel it replaces), in the TPU's order
    "flash_fwd": ("flash_fwd.cu", "ops/attention.py:135"),
    "flash_bwd_dq": ("flash_bwd.cu", "ops/attention.py:260"),
    "flash_bwd_dkv": ("flash_bwd.cu", "ops/attention.py:309"),
    "fused_ce_fwd": ("fused_ce.cu", "ops/fused_ce.py:75"),
    "fused_ce_dh": ("fused_ce.cu", "ops/fused_ce.py:137"),
    "fused_ce_bwd_a": ("fused_ce.cu", "ops/fused_ce.py:159"),
    "fused_ce_bwd": ("fused_ce.cu", "ops/fused_ce.py:201"),
    "fused_ce_de": ("fused_ce.cu", "ops/fused_ce.py:242"),
    "fused_adamw": ("fused_adamw.cu", "ops/fused_adamw.py:53"),
}
# the path each kernel's "launches" are read on: the train step, the
# public op fused_cross_entropy with bwd_variant "a" and "split" (the
# kernels phase), or the train step with fused_optimizer=True
KERNEL_PATH = {"fused_ce_dh": "ce_variants", "fused_ce_bwd_a": "ce_variants",
               "fused_ce_de": "ce_variants", "fused_adamw": "train_fused"}


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
    return {"flash_fwd": attention.flash_attention_fwd.launches,
            "flash_bwd_dq": attention.flash_attention_bwd.launches_dq,
            "flash_bwd_dkv": attention.flash_attention_bwd.launches_dkv,
            "fused_ce_fwd": fused_ce.fused_ce_fwd.launches,
            "fused_ce_dh": fused_ce.fused_ce_bwd.launches_dh,
            "fused_ce_bwd_a": fused_ce.fused_ce_bwd.launches_a,
            "fused_ce_bwd": fused_ce.fused_ce_bwd.launches,
            "fused_ce_de": fused_ce.fused_ce_bwd.launches_de,
            "fused_adamw": fused_adamw.fused_adamw_update.launches}


def zero_launch_counts():
    from distributed_tensorflow_tpu_torch.ops import (
        attention, fused_adamw, fused_ce)
    attention.flash_attention_fwd.launches = 0
    attention.flash_attention_bwd.launches_dq = 0
    attention.flash_attention_bwd.launches_dkv = 0
    fused_ce.fused_ce_fwd.launches = 0
    for name in ("launches", "launches_a", "launches_dh", "launches_de"):
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
        regs = re.findall(r"Used (\d+) registers", info["log"])
        spills = re.findall(r"(\d+) bytes spill stores", info["log"])
        out["sources"][name] = {
            "nvcc_s": round(info["seconds"], 3),
            "registers": [int(r) for r in regs],
            "spill_store_bytes": [int(s) for s in spills]}
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


def _time_flash_fwd(q, k, v, o_err: float) -> dict:
    """``flash_fwd`` causal on ``q, k, v`` against its plain version (in
    turns) and SDPA, with the bound of the work."""
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_plain)
    sm = q.shape[-1] ** -0.5
    t = in_turns(lambda: flash_attention_fwd(q, k, v, causal=True),
                 lambda: flash_attention_plain(q, k, v, causal=True,
                                               sm_scale=sm), 20)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sm))
    flops, nbytes = attention_work(q, k, True, 0, "fwd")
    bound, bound_by = bound_ms(flops, nbytes, q.dtype)
    return {"shape": list(q.shape), "max_abs_err": o_err, **t,
            "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / (t["ms"] * 1e-3) / 1e12}


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
              ("f32_causal_S300", f32, 1, 16, 300, 300, 64, True),
              ("f32_noncausal_hd128_q200_k130", f32, 1, 4, 200, 130, 128,
               False)]
    results, failures, timed = [], [], {}
    for name, dt, b, h, sq, sk, hd, causal in cases:
        q = _rand((b, h, sq, hd), dt, gen)
        k = _rand((b, h, sk, hd), dt, gen)
        v = _rand((b, h, sk, hd), dt, gen)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        res = {"case": name, **_fwd_errors(q, k, v, o, lse, causal)}
        results.append(res)
        if not res["ok"]:
            failures.append(name)
        if name in ("bf16_causal_S1024", "bf16_causal_train_step_8x16x1024"):
            timed[name] = (q, k, v, res["o_err"])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{failures}: {results}")

    # the train step's shape (12 launches a step) and the longest prefill
    # of the serve path (12 a prefill)
    train = _time_flash_fwd(*timed["bf16_causal_train_step_8x16x1024"])
    serve = _time_flash_fwd(*timed["bf16_causal_S1024"])
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    state["flash_fwd"] = {**{key: train[key] for key in keys},
                          "serve": {key: serve[key] for key in keys}}
    return {"cases": results, "dtype": "bfloat16", "causal": True,
            "library": "scaled_dot_product_attention",
            "train_shape": train, "serve_shape": serve}


def _check_flash_bwd(state, gen):
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        launch_bwd_dkv, launch_bwd_dq)

    # (name, B, H, Sq, Sk, hd, causal); each in bf16 and f32
    cases = [("causal_S200", 1, 4, 200, 200, 64, True),
             ("causal_q100_k300", 1, 4, 100, 300, 64, True),
             ("causal_q100_k40_masked_rows", 1, 4, 100, 40, 64, True),
             ("causal_hd128_S130", 1, 4, 130, 130, 128, True),
             ("noncausal_q150_k90", 1, 4, 150, 90, 64, False),
             ("noncausal_hd128_q70_k200", 1, 2, 70, 200, 128, False)]
    runs = [(f"{tag}_{name}", dt, *shape)
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for name, *shape in cases]
    # the train step's shape, which the timings below use
    runs.append(("bf16_train_step_8x16x1024_hd64", torch.bfloat16, 8, 16,
                 1024, 1024, 64, True))
    results, failures, main = [], [], None
    for name, dt, b, h, sq, sk, hd, causal in runs:
        q, k, v, do = (_rand((b, h, s, hd), dt, gen)
                       for s in (sq, sk, sk, sq))
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        # the forward these gradients start from, against its plain version
        fwd = _fwd_errors(q, k, v, o, lse, causal)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=hd ** -0.5)
        errs = {f"d{n}": rel_err(g, w) for n, g, w in zip("qkv", got, want)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        masked = torch.isposinf(lse)
        ok = (fwd["ok"] and max(errs.values()) <= tol
              and all(bool(torch.isfinite(g).all().item()) for g in got)
              and bool((got[0][masked] == 0).all().item()))
        results.append({"case": name, "rel_err": errs, "tol": tol,
                        "fwd_o_err": fwd["o_err"],
                        "fwd_lse_err": fwd["lse_err"],
                        "masked_rows": int(masked.sum().item()), "ok": ok})
        if not ok:
            failures.append(name)
        if name.startswith("bf16_train_step"):
            main = (q, k, v, o, lse, do,
                    abs_err(got[0], want[0]),
                    max(abs_err(got[1], want[1]), abs_err(got[2], want[2])))
    if failures:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{failures}: {results}")

    q, k, v, o, lse, do, dq_err, dkv_err = main
    sm = q.shape[-1] ** -0.5
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(sm_scale=sm, causal=True, causal_offset=0)

    def plain():
        flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                  sm_scale=sm)

    t_dq = in_turns(lambda: launch_bwd_dq(q, k, v, do, lse, delta, **kw),
                    plain, 10)
    t_dkv = in_turns(lambda: launch_bwd_dkv(q, k, v, do, lse, delta, **kw),
                     plain, 10)
    # library yardstick: scaled_dot_product_attention's backward alone,
    # through autograd; it computes dq, dk and dv together
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, scale=sm)
    lib = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True))
    shape_out = {}
    for kname, t, err, which in (("flash_bwd_dq", t_dq, dq_err, "dq"),
                                 ("flash_bwd_dkv", t_dkv, dkv_err, "dkv")):
        flops, nbytes = attention_work(q, k, True, 0, which)
        bound, bound_by = bound_ms(flops, nbytes, q.dtype)
        state[kname] = {"max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib,
                        "shape": list(q.shape)}
        shape_out[kname] = {**t, "bound_ms": bound, "bound_by": bound_by,
                            "flops": flops, "bytes": nbytes,
                            "achieved_tflops":
                                flops / (t["ms"] * 1e-3) / 1e12}
    flops, nbytes = attention_work(q, k, True, 0, "bwd")
    bound, bound_by = bound_ms(flops, nbytes, q.dtype)
    return {"cases": results, "shape": list(q.shape), "dtype": "bfloat16",
            "causal": True, **shape_out,
            "backward_bound_ms": bound, "backward_bound_by": bound_by,
            "library_ms": lib,
            "library": "scaled_dot_product_attention backward (dq, dk, dv)",
            "plain_note": "the plain backward computes dq, dk and dv"}


def _check_fused_ce(state, gen):
    import torch
    import torch.nn.functional as F
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
    runs.append(("bf16_train_chunk_N4096_V32768_D1024", torch.bfloat16,
                 4096, 32768, 1024))
    results, failures, main = [], [], None
    for name, dt, n, v, d in runs:
        h = _rand((n, d), dt, gen)
        e = _rand((v, d), dt, gen, 0.1)
        t = torch.randint(0, v, (n,), device="cuda", generator=gen)
        edges = torch.tensor([0, 63, 64, 127, 128, v - 40, v - 41, v - 1],
                             device="cuda")
        t[:len(edges)] = edges
        g = torch.rand(n, device="cuda", generator=gen) / n
        lse, tl = fused_ce_fwd(h, e, t)
        dh, de = fused_ce_bwd(h, e, t, lse, g)
        torch.cuda.synchronize()
        plse, ptl = fused_ce_fwd_plain(h, e, t)
        pdh, pde = fused_ce_bwd_plain(h, e, t, plse, g)
        errs = {"lse": abs_err(lse, plse), "tl": abs_err(tl, ptl),
                "dh_rel": rel_err(dh, pdh), "de_rel": rel_err(de, pde)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        ok = (errs["lse"] <= CE_ROW_TOL and errs["tl"] <= CE_ROW_TOL
              and errs["dh_rel"] <= tol and errs["de_rel"] <= tol
              and all(bool(torch.isfinite(x).all().item())
                      for x in (lse, tl, dh, de)))
        results.append({"case": name, "err": errs,
                        "tol": {"lse": CE_ROW_TOL, "grad_rel": tol},
                        "ok": ok})
        if not ok:
            failures.append(name)
        if name.startswith("bf16_train_chunk"):
            main = (h, e, t, g, max(errs["lse"], errs["tl"]),
                    max(abs_err(dh, pdh), abs_err(de, pde)))

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
        calls = {k: after[k] - before[k] for k in ("fused_ce_fwd",
                                                   "fused_ce_bwd")}
        errs = {"loss_rel": abs(loss.item() - ref.item()) / abs(ref.item()),
                "dh_rel": rel_err(gh, rh), "de_rel": rel_err(ge, re_)}
        tol = GRAD_TOL[str(dt).replace("torch.", "")]
        ok = (errs["loss_rel"] <= CE_LOSS_TOL and errs["dh_rel"] <= tol
              and errs["de_rel"] <= tol
              and calls == {"fused_ce_fwd": 2, "fused_ce_bwd": 2})
        results.append({"case": f"{tag}_two_chunks_N8192_V1000_D128",
                        "err": errs, "launches": calls,
                        "tol": {"loss_rel": CE_LOSS_TOL, "grad_rel": tol},
                        "ok": ok})
        if not ok:
            failures.append(f"{tag}_two_chunks")
    if failures:
        raise AssertionError(f"fused_ce disagrees with its plain version: "
                             f"{failures}: {results}")

    h, e, t, g, fwd_err, bwd_err = main
    n, d = h.shape
    v = e.shape[0]
    lse, _ = fused_ce_fwd(h, e, t)
    t_fwd = in_turns(lambda: fused_ce_fwd(h, e, t),
                     lambda: fused_ce_fwd_plain(h, e, t), 5)
    t_bwd = in_turns(lambda: fused_ce_bwd(h, e, t, lse, g),
                     lambda: fused_ce_bwd_plain(h, e, t, lse, g), 3)
    # no single PyTorch call computes either: the unfused
    # F.cross_entropy(F.linear(h, E)) forward, and its backward alone
    hl, el_ = (x.detach().clone().requires_grad_() for x in (h, e))
    unfused_fwd = time_ms(lambda: F.cross_entropy(
        F.linear(hl, el_), t, reduction="none"), 5)
    ul = F.cross_entropy(F.linear(hl, el_), t, reduction="none")
    unfused_bwd = time_ms(lambda: torch.autograd.grad(
        ul, (hl, el_), g.to(ul.dtype), retain_graph=True), 5)
    del ul
    state["ce_unfused_bwd_ms"] = unfused_bwd
    shape_out = {}
    for kname, tm, err, which in (("fused_ce_fwd", t_fwd, fwd_err, "fwd"),
                                  ("fused_ce_bwd", t_bwd, bwd_err, "bwd")):
        flops, nbytes = ce_work(n, v, d, h.element_size(), which)
        bound, bound_by = bound_ms(flops, nbytes, h.dtype)
        state[kname] = {"max_abs_err": err, "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": None,
                        "shape": [n, v, d]}
        if which == "bwd":
            state[kname]["unfused_bwd_ms"] = unfused_bwd
        shape_out[kname] = {**tm, "bound_ms": bound, "bound_by": bound_by,
                            "flops": flops, "bytes": nbytes,
                            "achieved_tflops":
                                flops / (tm["ms"] * 1e-3) / 1e12}
    return {"cases": results, "shape": [n, v, d], "dtype": "bfloat16",
            **shape_out, "library_ms": None,
            "unfused_cross_entropy_linear_fwd_ms": unfused_fwd,
            "unfused_cross_entropy_linear_bwd_ms": unfused_bwd}


# (name, N, V, D): a ragged vocab tail (V = 1000, 15 tiles + 40), N no
# multiple of the 32-row tile, the widest D, the train step's chunk, and
# two 4096-row chunks of the public op
CE_VARIANT_CASES = [("N300_V1000_D256", 300, 1000, 256),
                    ("N100_V1000_D1024", 100, 1000, 1024),
                    ("N4133_V1000_D64", 4133, 1000, 64),
                    ("train_chunk_N4096_V32768_D1024", 4096, 32768, 1024),
                    ("two_chunks_N8192_V1000_D128", 8192, 1000, 128)]


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
    launches are counted over this run. Then #5, #6 and #8 timed at the
    train step's chunk against their plain versions, in turns."""
    import torch
    from distributed_tensorflow_tpu_torch.ops import fused_ce as ce

    runs = [(f"{tag}_{name}", dt, *shape)
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))
            for name, *shape in CE_VARIANT_CASES
            if not (tag == "f32" and shape[1] == 32768)]
    results, failures, main = [], [], None
    chunks = 0
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
        chunks += n // ce.ROW_CHUNK if n > ce.ROW_CHUNK \
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
                "fused_ce_bwd_a": max(abs_err(got["a"][0], pdh),
                                      abs_err(got["a"][1], pde)),
                "fused_ce_dh": abs_err(got["split"][0], pdh),
                "fused_ce_de": abs_err(got["split"][1], pde)})
        del got, want, pdh, pde
    counts = launch_counts()
    state["ce_variants_launches"] = counts
    # one launch of each variant kernel per row chunk; "b" ran beside them
    expected = {"fused_ce_fwd": 3 * chunks, "fused_ce_bwd": chunks,
                "fused_ce_bwd_a": chunks, "fused_ce_dh": chunks,
                "fused_ce_de": chunks}
    if failures or counts != expected_counts(expected, 1):
        raise AssertionError(f"fused_ce variants: failures {failures}, "
                             f"launches {counts} (expected {expected}): "
                             f"{results}")

    h, e, t, g, errs = main
    n, d = h.shape
    v = e.shape[0]
    lse, _ = ce.fused_ce_fwd(h, e, t)
    t32 = t.to(torch.int32)
    dh, de = torch.empty_like(h), torch.empty_like(e)
    ptrs = (h.data_ptr(), e.data_ptr(), t32.data_ptr(), lse.data_ptr(),
            g.data_ptr())
    dims = (n, v, d, ce.KERNEL_DTYPES[h.dtype])
    timed = {
        "fused_ce_bwd_a": (
            in_turns(lambda: ce.fused_ce_bwd(h, e, t, lse, g, variant="a"),
                     lambda: ce.fused_ce_bwd_plain(h, e, t, lse, g), 3),
            "bwd"),
        "fused_ce_dh": (
            in_turns(lambda: ce._launch("fused_ce_dh", h.device, *ptrs,
                                        dh.data_ptr(), *dims),
                     lambda: ce.fused_ce_dh_plain(h, e, t, lse, g), 3),
            "dh"),
        "fused_ce_de": (
            in_turns(lambda: ce._launch("fused_ce_de", h.device, *ptrs,
                                        de.data_ptr(), *dims),
                     lambda: ce.fused_ce_de_plain(h, e, t, lse, g), 3),
            "de"),
    }
    shape_out = {}
    for kname, (tm, which) in timed.items():
        flops, nbytes = ce_work(n, v, d, h.element_size(), which)
        bound, bound_by = bound_ms(flops, nbytes, h.dtype)
        state[kname] = {"max_abs_err": errs[kname], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": None,
                        "unfused_bwd_ms": state["ce_unfused_bwd_ms"],
                        "shape": [n, v, d]}
        shape_out[kname] = {**tm, "bound_ms": bound, "bound_by": bound_by,
                            "flops": flops, "bytes": nbytes,
                            "achieved_tflops":
                                flops / (tm["ms"] * 1e-3) / 1e12}
    return {"cases": results, "launches": counts, "shape": [n, v, d],
            "dtype": "bfloat16", **shape_out,
            "split_ms": timed["fused_ce_dh"][0]["ms"]
            + timed["fused_ce_de"][0]["ms"]}


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
    launches = counts["flash_fwd"]

    prefills = engine.prefills - prefills0
    acct = engine.block_accounting()
    n_tokens = sum(len(o) for o in outs)
    problems = []
    if len(outs) != SERVE_REQUESTS or any(len(o) != SERVE_NEW for o in outs):
        problems.append(f"incomplete outputs: {[len(o) for o in outs]}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        problems.append("token id out of range")
    if launches == 0:
        problems.append("flash_fwd never launched on the serving path")
    if launches != cfg.n_layers * prefills:
        problems.append(f"flash_fwd launches {launches} != "
                        f"{cfg.n_layers} x {prefills} prefills")
    if any(n for k, n in counts.items() if k != "flash_fwd"):
        problems.append(f"a training kernel ran while serving: {counts}")
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
            "flash_fwd_launches": launches,
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
    return TransformerConfig.transformer_big(
        max_seq_len=1024, remat=False, scan_layers=False, loss_impl="kernel",
        adam_mu_dtype=torch.bfloat16, **kw)


def _timed_train(cfg, per_step: dict, forbid_plain_step: bool):
    """One warm-up step of ``cfg``'s train step, then TRAIN_STEPS timed
    with CUDA events with the launch counters set to 0 before and read
    after; checks the launches, the first loss and that the loss falls.
    With ``forbid_plain_step`` the optimizer's own ``step`` raises if it
    is ever reached."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    model, opt, step, batch = _train_setup(cfg, 0, TRAIN_BATCH)
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
    tokens = TRAIN_BATCH * cfg.max_seq_len
    flops = step_flops(cfg, TRAIN_BATCH, n_params)
    return counts, {
        "note": "smoke run, not a benchmark",
        "config": "transformer_big", "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq_len": cfg.max_seq_len,
        "loss_impl": "kernel", "adam_mu_dtype": "bfloat16",
        "fused_optimizer": cfg.fused_optimizer,
        "n_params": n_params, "warmup_step_s": warmup_s,
        "step_ms": step_ms, "step_ms_mean": mean_s * 1e3,
        "step_ms_median": median_s * 1e3,
        "host_step_ms": host_ms, "tokens_per_s": tokens / mean_s,
        "tokens_per_s_median": tokens / median_s,
        "step_flops": flops,
        "mfu": flops / mean_s / PEAK_FLOPS["bfloat16"],
        "mfu_median": flops / median_s / PEAK_FLOPS["bfloat16"],
        "mfu_peak": "989 TFLOP/s bf16 dense",
        "first_loss": first_loss, "ln_vocab": math.log(cfg.vocab_size),
        "losses": losses, "launches": counts,
        "launches_per_step": per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_train(state):
    counts, out = _timed_train(_headline_config(), TRAIN_LAUNCHES, False)
    state["train_launches"] = counts
    state["train_step_ms_median"] = out["step_ms_median"]
    return out


def phase_train_fused(state):
    import torch
    torch.cuda.empty_cache()
    counts, out = _timed_train(_headline_config(fused_optimizer=True),
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
    the same weights: ``remat=True`` with the "nothing" and "dots" policies
    against ``remat=False`` (flash_fwd launched twice a layer under
    recompute), and the scan-chunked loss (8 chunks, both chunk
    policies) against full logits: loss and every gradient."""
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
        want_fwd = (2 if name.startswith("remat") else 1) * base["n_layers"]
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
    out = {"config": "transformer_big, 2 layers", "dtype": "float32",
           "batch": 2, "seq_len": 256, "loss_tol": TRAIN_LOSS_TOL,
           "grad_tol": GRAD_TOL["float32"], **results}
    if failures:
        raise AssertionError(f"train options: {failures}: {json.dumps(out)}")
    return out


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
        for _ in range(TRAIN_PARITY_STEPS):
            st, metrics = step(st, batch)
            losses.append(metrics["loss"].item())
            grads.append(dict(_leaves(model.stacked_params(
                lambda p: p.grad.clone()))))
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
    if (loss_err > TRAIN_LOSS_TOL or worst_grad > GRAD_TOL["float32"]
            or held_err > TRAIN_PARAM_TOL
            or over > TRAIN_PARAM_FRAC * n_params or len(grad_err) != 10):
        raise AssertionError(f"train parity: {json.dumps(out)}")
    return out


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
                     ("parity", phase_parity), ("train", phase_train),
                     ("train_fused", phase_train_fused),
                     ("train_parity", phase_train_parity),
                     ("train_options", phase_train_options)):
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
        for key in ("unfused_bwd_ms", "f32_mu", "ms_events",
                    "library_ms_events"):
            if key in k:
                row[key] = k[key]
        if name == "flash_fwd":
            # the same kernel on the serve path, at its longest prefill
            row["serve"] = {"launches": state["serve_launches"],
                            **k["serve"]}
        summary.append(row)
    emit({"kernels": summary})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

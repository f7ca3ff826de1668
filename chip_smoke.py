#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``distributed_tensorflow_tpu_torch``)
on the card and checks it, in phases, each printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — builds the CUDA kernel source with ``nvcc`` into
   ``build/torch_kernels/``.
3. ``kernels`` — each kernel's wrapper against its plain PyTorch
   version on the card, at the serving path's shapes and at the edges
   (ragged tails, causal offsets, fully-masked rows), with the
   tolerances below; then the kernel, the plain version and one
   PyTorch library call timed at the main shape with CUDA events.
4. ``serve``   — the main path: ``InferenceEngine.generate`` at the full
   width of ``transformer_big`` in bf16 (random weights from seed 0),
   8 requests × 32 new tokens. Every kernel launch counter is set to 0
   just before and read just after; each kernel must have run, and
   ``flash_fwd`` exactly once per layer per prefill.
5. ``parity``  — the same path in f32: the engine's decode logits at
   every generated position against ``TransformerLM`` full-sequence
   recompute, and its greedy tokens wherever the top-2 gap is clear.

Then a ``{"kernels": [...]}`` line (per kernel: launches on the main
path, error, measured times and the bound), the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that last line, as does a machine with no CUDA device
or a directory without the package. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
PARITY_LOGIT_TOL = 1e-3      # f32 decode logits vs full recompute
PARITY_GAP = 1e-2            # greedy tokens compared where top-2 gap > this
# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores,
# HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SERVE_SLOTS, SERVE_BLOCK, SERVE_REQUESTS, SERVE_NEW = 8, 16, 8, 32
PARITY_REQUESTS, PARITY_NEW = 4, 16


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


def attention_bound_ms(q, k, causal: bool, causal_offset: int) -> tuple:
    """Least time for one flash forward on these inputs: bytes (q, k, v
    read once, o and lse written once) over HBM bandwidth vs the
    multiply-adds the unmasked (i, j) pairs need over the dtype's peak."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el + b * h * sq * 4
    if causal:
        pairs = sum(max(0, min(i + causal_offset, sk - 1) + 1)
                    for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * hd * pairs * b * h
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops, nbytes


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
    from distributed_tensorflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build("flash_fwd")
    wall = time.perf_counter() - t0
    out = {"wall_s": round(wall, 3), "sources": {}}
    for name in ("flash_fwd",):
        info = _build.build_info[name]
        regs = re.findall(r"Used (\d+) registers", info["log"])
        spills = re.findall(r"(\d+) bytes spill stores", info["log"])
        out["sources"][name] = {
            "nvcc_s": round(info["seconds"], 3),
            "registers": [int(r) for r in regs],
            "spill_store_bytes": [int(s) for s in spills]}
    return out


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def phase_kernels(state):
    import torch
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # (name, dtype, B, H, Sq, Sk, hd, causal)
    cases = [(f"bf16_causal_S{s}", bf, 1, 16, s, s, 64, True)
             for s in (1, 17, 512, 1000, 1024)]
    cases += [("bf16_noncausal_S384", bf, 1, 16, 384, 384, 64, False),
              ("bf16_causal_q64_k1024", bf, 1, 16, 64, 1024, 64, True),
              ("bf16_causal_q100_k40_masked_rows", bf, 1, 16, 100, 40, 64,
               True),
              ("bf16_causal_hd128_q200_k130", bf, 1, 4, 200, 130, 128,
               True),
              ("f32_causal_S300", f32, 1, 16, 300, 300, 64, True),
              ("f32_noncausal_hd128_q200_k130", f32, 1, 4, 200, 130, 128,
               False)]
    results, failures = [], []
    main = None
    for name, dt, b, h, sq, sk, hd, causal in cases:
        q = _rand((b, h, sq, hd), dt, gen)
        k = _rand((b, h, sk, hd), dt, gen)
        v = _rand((b, h, sk, hd), dt, gen)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=hd ** -0.5)
        inf_k, inf_p = torch.isinf(lse), torch.isinf(plse)
        fin = ~inf_p
        o_err = (o.float() - po.float()).abs().max().item()
        lse_err = ((lse[fin] - plse[fin]).abs().max().item()
                   if fin.any() else 0.0)
        empty_zero = bool((o[inf_p] == 0).all().item()) if inf_p.any() \
            else True
        tol = TOL[str(dt).replace("torch.", "")]
        ok = (o_err <= tol["o"] and lse_err <= tol["lse"]
              and torch.equal(inf_k, inf_p) and empty_zero
              and bool(torch.isfinite(o).all().item()))
        results.append({"case": name, "o_err": o_err, "lse_err": lse_err,
                        "masked_rows": int(inf_p.sum().item()),
                        "tol": tol, "ok": ok})
        if not ok:
            failures.append(name)
        if name == "bf16_causal_S1024":
            main = (q, k, v, o_err)
    if failures:
        raise AssertionError(f"kernel disagrees with plain version: "
                             f"{failures}: {results}")

    q, k, v, o_err = main
    sm = q.shape[-1] ** -0.5

    def kern():
        flash_attention_fwd(q, k, v, causal=True)

    def plain():
        flash_attention_plain(q, k, v, causal=True, sm_scale=sm)

    def library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=sm)

    # turns within one call: plain, kernel, kernel, plain
    p1 = time_ms(plain)
    k1 = time_ms(kern)
    k2 = time_ms(kern)
    p2 = time_ms(plain)
    lib = time_ms(library)
    bound, bound_by, flops, nbytes = attention_bound_ms(
        q, k, True, k.shape[2] - q.shape[2])
    kernel_ms = (k1 + k2) / 2
    state["flash_fwd"] = {
        "max_abs_err": o_err, "ms": kernel_ms, "plain_ms": (p1 + p2) / 2,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
    return {"cases": results, "kernels": ["flash_fwd"],
            "shape": list(q.shape), "dtype": "bfloat16", "causal": True,
            "kernel_ms": kernel_ms, "kernel_ms_runs": [k1, k2],
            "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
            "library_ms": lib, "library": "scaled_dot_product_attention",
            "bound_ms": bound, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes,
            "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12}


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
    from distributed_tensorflow_tpu_torch.ops.attention import (
        flash_attention_fwd)
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
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches

    prefills = engine.prefills - prefills0
    acct = engine.block_accounting()
    n_tokens = sum(len(o) for o in outs)
    problems = []
    if len(outs) != SERVE_REQUESTS or any(len(o) != SERVE_NEW for o in outs):
        problems.append(f"incomplete outputs: {[len(o) for o in outs]}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        problems.append("token id out of range")
    if launches == 0:
        problems.append("flash_fwd never launched on the main path")
    if launches != cfg.n_layers * prefills:
        problems.append(f"flash_fwd launches {launches} != "
                        f"{cfg.n_layers} x {prefills} prefills")
    if not acct["conserved"] or acct["leaked_refs"] != 0 \
            or acct["free"] != acct["usable"]:
        problems.append(f"block accounting at idle: {acct}")
    if problems:
        raise AssertionError("; ".join(problems))
    state["launches"] = {"flash_fwd": launches}
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
                     ("parity", phase_parity)):
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
    k = state["flash_fwd"]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "distributed_tensorflow_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "distributed_tensorflow_tpu/ops/attention.py:135",
        "launches": state["launches"]["flash_fwd"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

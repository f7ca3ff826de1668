"""The inference engine: model + KV cache + continuous batching — port
of ``distributed_tensorflow_tpu/serving/engine.py``.

One :class:`InferenceEngine` is one serving replica's model runtime on
one device:

- **Weights** — the port's parameter dict (``models.transformer.
  init_params`` / ``params_from_jax``), cast once to the compute dtype
  (norm scales stay f32, as the math reads them).
- **Stepping** — :meth:`step` is one continuous-batching iteration:
  retire finished sequences (free their blocks), admit from the queue
  under the token budget, prefill the newly admitted, decode one token
  for every running sequence. Greedy (argmax) sampling, so the output
  is exactly comparable to full-sequence recompute.
- **Prefill** runs each prompt at its exact length through the flash
  forward (the ``flash_fwd`` CUDA kernel on the card, one launch per
  layer); **decode** attends one query per sequence against its block
  window in plain PyTorch. The decode batch holds only the running
  sequences, and the window only as many blocks as the longest of them
  has — the JAX engine pads both to fixed shapes so it compiles once.
- **Telemetry** — ``serve.admit`` / ``serve.prefill`` / ``serve.token``
  / ``serve.step`` / ``serve.request`` events with the JAX engine's
  fields, and the same ``inference/`` and ``serving/`` instruments.

Mesh placement, checkpoint restore and hot-swap, prefix caching,
speculative decoding, prefill-only roles, KV migration, the host spill
tier, the ``serve.step`` fault site and the goodput ledger belong to
later slices.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, resolve_device)
from distributed_tensorflow_tpu_torch.serving import decode as decode_lib
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    CacheConfig, init_pool)
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    AdmissionQueue, ContinuousBatchingScheduler, Request, Sequence)

def request_span_id(request_id: str) -> str:
    """Deterministic per-request trace span id (the same across
    preemption replays)."""
    return f"req/{request_id}"


def params_digest(params) -> str:
    """crc32 over every parameter's raw bytes, in key order — the
    content half of the ``weights_version`` stamped on serving events."""
    crc = 0

    def walk(node, prefix):
        nonlocal crc
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
            return
        crc = zlib.crc32(prefix.encode(), crc)
        t = node.detach().contiguous().cpu()
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)

    walk(params, "")
    return f"{crc & 0xFFFFFFFF:08x}"


def _to_compute(params, dtype, device):
    """Matrices in the compute dtype on ``device``; norm scales f32."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        dt = torch.float32 if name == "scale" else dtype
        return node.to(device=device, dtype=dt)
    return walk(params, None)


class InferenceEngine:
    """Continuous-batching greedy inference over a transformer.

    ``max_slots`` caps the decode batch, ``max_prompt_len`` the prompt
    length, ``num_blocks``/``block_size`` size the KV pool, and
    ``token_budget`` caps prefill+decode tokens per step (Orca-style
    iteration-level fairness). ``max_seq_len`` bounds prompt+generation
    per sequence (default: the model's). ``kv_dtype`` in
    {"f32", "bf16", "int8"} picks the pool's storage dtype (default the
    model's compute dtype)."""

    def __init__(self, cfg: TransformerConfig, params, *, device="cuda",
                 num_blocks: int = 64, block_size: int = 16,
                 max_slots: int = 8, max_prompt_len: int | None = None,
                 token_budget: int | None = None,
                 max_seq_len: int | None = None,
                 queue_capacity: int = 256,
                 queue_policy: str = "reject",
                 kv_dtype: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.max_prompt_len = min(max_prompt_len or self.max_seq_len,
                                  self.max_seq_len)
        self.token_budget = token_budget or (max_slots
                                             + self.max_prompt_len)
        cache_cfg = CacheConfig.for_model(cfg, num_blocks=num_blocks,
                                          block_size=block_size,
                                          kv_dtype=kv_dtype)
        max_blocks_per_seq = cache_cfg.blocks_for(self.max_seq_len)
        self.cache_cfg = cache_cfg
        self.window = max_blocks_per_seq * block_size
        self.scheduler = ContinuousBatchingScheduler(
            cache_cfg, max_slots=max_slots,
            max_blocks_per_seq=max_blocks_per_seq,
            token_budget=self.token_budget,
            queue=AdmissionQueue(queue_capacity, queue_policy))

        self.params = _to_compute(decode_lib.canonical_params(cfg, params),
                                  cfg.dtype, self.device)
        #: model-version identity stamped on serve.prefill/serve.request:
        #: snapshot step (0 = weights passed in directly) @ digest
        self.weights_step = 0
        self.weights_digest = params_digest(self.params)
        self.pool = init_pool(cache_cfg, self.device)
        self._prefill = decode_lib.make_prefill_fn(cfg, cache_cfg)
        self._decode = (decode_lib.make_decode_fn(cfg, cache_cfg)
                        if cfg.causal else None)

        # shared inference namespace (process-wide instruments)
        reg = telemetry.get_registry()
        self._m_req_latency = reg.histogram(
            "inference/request_latency",
            "admission -> completion seconds per serving request")
        self._m_ttft = reg.histogram(
            "inference/time_to_first_token",
            "admission -> first generated token seconds")
        self._m_completed = reg.counter("inference/requests_completed")
        self._m_tokens = reg.counter("inference/tokens_generated")
        self._m_replayed = reg.counter(
            "inference/tokens_replayed",
            "tokens re-generated after preemption (badput)")
        self._m_step = reg.histogram("serving/step_time",
                                     "one continuous-batching iteration")
        self._m_running = reg.gauge("serving/sequences_running")
        self._m_queued = reg.gauge("serving/requests_queued")
        self._m_blocks_free = reg.gauge("serving/blocks_free")
        self._m_preempt = reg.counter("serving/preemptions")
        self._m_prompt_tokens = reg.counter(
            "serving/prefix_prompt_tokens",
            "prompt tokens submitted to prefill")

        self._step_idx = 0
        self._submitted: dict[str, float] = {}      # id -> wall arrival
        self._submit_mono: dict[str, float] = {}    # id -> mono arrival
        # instance-local tallies (the registry instruments are shared by
        # every engine in the process)
        self.prefills = 0
        self.decode_steps = 0
        self.completed = 0
        self.tokens_generated = 0
        self._preempt_seen = 0

    @property
    def weights_version(self) -> str:
        """``<step>@<digest>`` — the identity stamped on serving events."""
        return f"{self.weights_step}@{self.weights_digest}"

    # -- request lifecycle -------------------------------------------------
    def submit(self, request: Request, *,
               arrival_wall: "float | None" = None) -> "Request | None":
        """Queue a request; returns the request the queue evicted to
        make room (policy ``evict_oldest``), if any. Raises
        ``QueueOverflowError`` under the ``reject`` policy.
        ``arrival_wall`` backdates the latency clock to the request's
        true arrival."""
        if len(request.tokens) > self.max_prompt_len:
            raise ValueError(
                f"request {request.id}: prompt {len(request.tokens)} > "
                f"max_prompt_len {self.max_prompt_len}")
        if not self.cfg.causal and request.max_new_tokens > 0:
            raise ValueError(
                f"request {request.id}: bidirectional (non-causal) "
                f"configs serve scoring requests only "
                f"(max_new_tokens=0)")
        if (len(request.tokens) + request.max_new_tokens
                > self.max_seq_len):
            raise ValueError(
                f"request {request.id}: prompt + max_new_tokens "
                f"exceeds max_seq_len {self.max_seq_len}")
        evicted = self.scheduler.queue.submit(request)
        self._submitted[request.id] = (arrival_wall
                                       if arrival_wall is not None
                                       else time.time())
        self._submit_mono[request.id] = time.monotonic()
        if evicted is not None:
            self._submitted.pop(evicted.id, None)
            self._submit_mono.pop(evicted.id, None)
        self._m_queued.set(len(self.scheduler.queue))
        telemetry.event("serve.admit", id=request.id,
                        span_id=request_span_id(request.id),
                        tenant=request.tenant, pclass=request.pclass,
                        prompt_tokens=len(request.tokens),
                        queued=len(self.scheduler.queue))
        return evicted

    def _prefill_one(self, seq: Sequence):
        """Run one admitted sequence's prompt (a preempted sequence's
        replayed prompt includes its generated tokens) through prefill
        at its exact length and bank its first greedy token."""
        rid = seq.request.id
        submit_mono = self._submit_mono.get(rid)
        queue_wait = (seq.admitted_s - submit_mono
                      if submit_mono is not None else None)
        with telemetry.span(
                "serve.prefill", id=rid, span_id=request_span_id(rid),
                model_version=self.weights_version,
                prompt_tokens=seq.prompt_len, cached_tokens=None,
                queue_wait_s=(round(queue_wait, 6)
                              if queue_wait is not None else None),
                replayed=len(seq.request.generated_prefix) or None):
            n = seq.prompt_len
            toks = torch.tensor([seq.request.tokens], dtype=torch.long,
                                device=self.device)
            rows = torch.from_numpy(
                seq.table.rows(np.arange(n)).astype(np.int64)
            ).to(self.device)
            last, self.pool = self._prefill(self.params, self.pool, toks,
                                            rows)
            self.scheduler.commit_prefill(seq)
            first = int(torch.argmax(last))
        self.prefills += 1
        self._m_prompt_tokens.increment(seq.prompt_len)
        if seq.request.max_new_tokens > 0:
            self.scheduler.append_token(seq, first)
        else:
            seq.first_token_s = time.monotonic()
            seq.score_token = first                    # scoring request

    def _emit_token(self, seq: Sequence):
        # index counts generated tokens across preemptions (the replayed
        # prefix included)
        rid = seq.request.id
        telemetry.event(
            "serve.token", id=rid, span_id=request_span_id(rid),
            index=(len(seq.request.generated_prefix)
                   + len(seq.generated)),
            step=self._step_idx)

    def _decode_batch(self, batch: list[Sequence]):
        """One incremental token for every running sequence. The batch
        is exactly the running sequences and the window as wide as the
        longest one's blocks; positions past a sequence's length are
        masked, so neither choice changes any row's result."""
        bs = self.cache_cfg.block_size
        W = max(len(s.table.blocks) for s in batch) * bs
        B = len(batch)
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        lengths = np.zeros(B, np.int64)
        write_rows = np.zeros(B, np.int64)
        window_rows = np.zeros((B, W), np.int64)
        for i, seq in enumerate(batch):
            # feed the last banked token at position length-1 (appended
            # by the previous prefill/decode step)
            tokens[i] = seq.last_token
            positions[i] = seq.length - 1
            lengths[i] = seq.length
            write_rows[i] = seq.table.row_of(seq.length - 1)
            window_rows[i] = seq.table.window_rows(W)
        dev = self.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        logits, self.pool = self._decode(
            self.params, self.pool, t(tokens), t(positions), t(lengths),
            t(write_rows), t(window_rows))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_steps += 1
        emit = telemetry.enabled()
        for i, seq in enumerate(batch):
            self.scheduler.append_token(seq, int(nxt[i]))
            if emit:
                self._emit_token(seq)

    def step(self) -> list[dict]:
        """One continuous-batching iteration; returns completion records
        for every request finished this step."""
        t0 = time.monotonic()
        sched = self.scheduler
        finished: list[dict] = []
        with telemetry.span("serve.step", step=self._step_idx) as sp:
            # 1. retire finished sequences -> blocks free immediately
            for seq in list(sched.finished()):
                finished.append(self._complete(seq))
            defer_p0 = sched.deferred_prefill
            defer_b0 = sched.deferred_blocks
            admitted = sched.admit()
            for seq in admitted:
                self._prefill_one(seq)
            # scoring requests (max_new_tokens=0) finish at prefill
            for seq in list(sched.finished()):
                finished.append(self._complete(seq))
            batch = []
            if self._decode is not None:
                batch = sched.grow_for_decode()
                if batch:
                    self._decode_batch(batch)
            sp["admitted"] = len(admitted)
            sp["decoded"] = len(batch)
            sp["finished"] = len(finished)
            sp["queued"] = len(sched.queue)
            sp["blocks_free"] = sched.allocator.num_free
            if sched.deferred_prefill > defer_p0:
                sp["deferred_prefill"] = sched.deferred_prefill - defer_p0
            if sched.deferred_blocks > defer_b0:
                sp["deferred_blocks"] = sched.deferred_blocks - defer_b0
        self._step_idx += 1
        self._m_step.record(time.monotonic() - t0)
        self._m_running.set(len(sched.running))
        self._m_queued.set(len(sched.queue))
        self._m_blocks_free.set(sched.allocator.num_free)
        if sched.preemptions > self._preempt_seen:
            self._m_preempt.increment(sched.preemptions - self._preempt_seen)
            self._preempt_seen = sched.preemptions
        return finished

    def _complete(self, seq: Sequence) -> dict:
        self.scheduler.finish(seq)
        req = seq.request
        now = time.time()
        arrival = self._submitted.pop(req.id, now)
        self._submit_mono.pop(req.id, None)
        latency = max(0.0, now - arrival)
        ttft = ((seq.first_token_s - seq.admitted_s)
                if seq.first_token_s is not None else None)
        generated = list(req.generated_prefix) + list(seq.generated)
        tokens = (generated if (req.max_new_tokens > 0
                                or req.generated_prefix)
                  else [getattr(seq, "score_token", -1)])
        prompt_tokens = len(req.tokens) - len(req.generated_prefix)
        replayed = len(req.generated_prefix)
        self._m_req_latency.record(latency)
        if ttft is not None:
            self._m_ttft.record(ttft)
        self._m_completed.increment()
        self._m_tokens.increment(len(seq.generated))
        self.completed += 1
        self.tokens_generated += len(seq.generated)
        if replayed:
            self._m_replayed.increment(replayed)
        telemetry.event(
            "serve.request", id=req.id, dur_s=round(latency, 6),
            span_id=request_span_id(req.id),
            model_version=self.weights_version,
            tenant=req.tenant, pclass=req.pclass,
            prompt_tokens=prompt_tokens, new_tokens=len(generated),
            replayed_tokens=replayed,
            ttft_s=round(ttft, 6) if ttft is not None else None,
            preemptions=seq.preemptions)
        return {"id": req.id, "tokens": tokens,
                "prompt_tokens": prompt_tokens,
                "model_version": self.weights_version,
                "tenant": req.tenant, "pclass": req.pclass,
                "latency_s": latency, "ttft_s": ttft,
                "replayed_tokens": replayed,
                "preemptions": seq.preemptions}

    def block_accounting(self) -> dict:
        """Allocator conservation audit: every live reference is owned by
        a running sequence's table, and free + allocated equals the
        usable pool."""
        sched = self.scheduler
        alloc = sched.allocator
        seq_refs = sum(len(s.table.blocks)
                       for s in sched.running.values())
        return {
            "free": alloc.num_free,
            "allocated": alloc.num_allocated,
            "usable": self.cache_cfg.usable_blocks,
            "total_refs": alloc.total_refs,
            "seq_refs": seq_refs,
            "cache_refs": 0,
            "leaked_refs": alloc.total_refs - seq_refs,
            "conserved": (alloc.num_free + alloc.num_allocated
                          == self.cache_cfg.usable_blocks),
        }

    # -- convenience -------------------------------------------------------
    def run_until_idle(self, *, max_steps: int = 100000) -> dict:
        """Drive :meth:`step` until queue and slots drain; returns
        ``{request_id: completion record}``."""
        out: dict[str, dict] = {}
        for _ in range(max_steps):
            if self.scheduler.idle:
                break
            for rec in self.step():
                out[rec["id"]] = rec
        return out

    def generate(self, prompts, *, max_new_tokens: int = 16,
                 eos_id: int | None = None) -> list[list[int]]:
        """Greedy-decode ``prompts`` (lists of token ids) through the
        continuous-batching path; returns the generated token lists in
        prompt order."""
        for i, p in enumerate(prompts):
            self.submit(Request(id=f"g{i}", tokens=tuple(p),
                                max_new_tokens=max_new_tokens,
                                eos_id=eos_id))
        done = self.run_until_idle()
        return [done[f"g{i}"]["tokens"] for i in range(len(prompts))]

    def stats(self) -> dict:
        sched = self.scheduler
        return {
            "steps": self._step_idx,
            "running": len(sched.running),
            "queued": len(sched.queue),
            "blocks_free": sched.allocator.num_free,
            "blocks_total": self.cache_cfg.usable_blocks,
            "preemptions": sched.preemptions,
            "deferred_prefill": sched.deferred_prefill,
            "deferred_blocks": sched.deferred_blocks,
            "queue_rejected": sched.queue.rejected,
            "queue_evicted": sched.queue.evicted,
            "requests_completed": self.completed,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "serve_time_s": self._m_step.export().get("sum", 0.0),
            "kv_dtype": str(self.cache_cfg.dtype).replace("torch.", ""),
            "weights_step": self.weights_step,
            "weights_version": self.weights_version,
        }

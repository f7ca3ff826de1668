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
  window in plain PyTorch. Decode and the speculative verify take the
  JAX engine's fixed shapes: ``max_slots`` rows (rounded up to a
  multiple of ``dp``), each sequence at its slot, idle rows feeding
  token 0 into the trash row, and the engine's whole ``window``. So a
  sequence's logits never depend on what shares its batch (at bf16 a
  batch of another size meets GEMMs of another shape, and a near-tie
  in the argmax could flip).
- **Telemetry** — ``serve.admit`` / ``serve.prefill`` / ``serve.token``
  / ``serve.step`` / ``serve.request`` events with the JAX engine's
  fields, and the same ``inference/`` and ``serving/`` instruments.
  Steps, tokens, migrations and swaps also feed the live goodput ledger
  (``telemetry/goodput.py``) when one is active, replayed tokens priced
  as ``preempt_replay`` badput.
- **Chaos** — each step fires the ``serve.step`` injection site
  (``resilience/faults.py``) before it changes any scheduler state, so
  an injected failure is retryable (``run_until_idle(retry_faults=
  True)``) and no request is lost.
- **Roles and KV migration** — ``role="prefill"`` builds no decode
  function: :meth:`step` admits and prefills only, and the
  disaggregated runtime (``serving/migrate.py``) moves each prefilled
  sequence to a decode replica: :meth:`export_sequence` gathers its
  block rows to host memory and releases it, :meth:`adopt_sequence`
  scatters them into another engine's pool, and decode continues there
  with nothing replayed.
- **Hot-swap** — :meth:`install_version` flips the weights in place at
  a step boundary: running requests are re-queued pristine, the prefix
  cache is fenced by the new weights version, and no completion mixes
  two versions. :meth:`from_checkpoint` builds an engine from a
  checkpoint of either package (``Checkpoint(params=...)``) and keeps
  its provenance; :meth:`load_version` restores another step and
  installs it, :meth:`begin_load_version` restores on a thread and
  :meth:`step` installs it at the next step boundary.

Two serving-speed features stack on the same step loop, each off by
default and each OUTPUT-INVARIANT (greedy tokens are identical with the
feature on or off), as in the JAX engine:

- **Prefix caching** (``prefix_caching=True``) — committed prompt
  prefixes are content-indexed in the scheduler's
  :class:`~distributed_tensorflow_tpu_torch.serving.kv_cache.PrefixCache`;
  a later request whose prompt matches adopts the cached blocks
  (refcounted) and prefill runs only over the unmatched suffix, through
  the multi-token ``extend`` forward (the flash forward at ``Sq`` = the
  suffix, ``Sk`` = the whole prompt). Shared blocks are copied on write
  before any divergent append; eviction is LRU over cached blocks no
  sequence references. ``spill_tier`` (a
  :class:`~distributed_tensorflow_tpu_torch.serving.kv_cache.HostTier`,
  or its capacity in blocks) keeps evicted blocks in host memory and
  re-adopts them on a later hit.
- **Speculative decoding** (``speculative_k=k`` with a draft model,
  default the target's own first half of layers —
  ``decode.truncated_draft``) — the draft proposes up to k greedy tokens per
  sequence, the target verifies all k+1 positions in ONE cache-aware
  ``extend`` forward, the longest agreeing prefix commits (plus the
  target's own next token), and the first rejection truncates.

Mesh placement (JAX ``:10-14``): ``mesh=`` a ``("tp",)``, ``("dp",)``
or ``("dp", "tp")`` ``DeviceMesh`` over every rank, one engine a rank.
Heads, ``d_ff`` and the vocabulary shard over ``tp`` by the training
rules (``decode.param_shardings``), the pool's heads follow
(``kv_cache.pool_shardings``), and the decode batch's rows split over
``dp``. Every rank steps the same scheduler over the same requests
(host logic, deterministic), so every rank's scheduler sees every
stream: the chosen tokens are all-gathered over ``dp``. A migration
payload gathers the heads over ``tp`` (the single-device engine's
layout, byte for byte) and adoption scatters them.

The checkpoint-restore entry points (``from_checkpoint``,
``load_version``, ``begin_load_version``) belong to a later slice.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, _mesh_device, resolve_device, shard_params_at)
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    all_gather)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel, check_divisible)
from distributed_tensorflow_tpu_torch.resilience import faults
from distributed_tensorflow_tpu_torch.serving import decode as decode_lib
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    CacheConfig, HostTier, dtype_name, init_pool)
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    AdmissionQueue, ContinuousBatchingScheduler, Request, Sequence)
from distributed_tensorflow_tpu_torch.telemetry import goodput as _goodput

_pool_epochs = itertools.count()


def request_span_id(request_id: str) -> str:
    """Deterministic per-request trace span id (the same across
    preemption replays)."""
    return f"req/{request_id}"


def migrate_span_id(request_id: str) -> str:
    """Span id shared by both halves of one KV migration (the source's
    export and the destination's adopt)."""
    return f"kvmig/{request_id}"


def _leaves(node, prefix=""):
    """``{path: tensor}`` of a parameter dict, in key order."""
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            out.update(_leaves(node[k], f"{prefix}/{k}"))
        return out
    return {prefix: node}


def params_digest(params) -> str:
    """crc32 over every parameter's raw bytes, in key order — the
    content half of the ``weights_version`` stamped on serving events."""
    crc = 0
    for path, t in _leaves(params).items():
        crc = zlib.crc32(path.encode(), crc)
        t = t.detach().contiguous().cpu()
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


class InferenceEngine:
    """Continuous-batching greedy inference over a transformer.

    ``max_slots`` caps the decode batch, ``max_prompt_len`` the prompt
    length, ``num_blocks``/``block_size`` size the KV pool, and
    ``token_budget`` caps prefill+decode tokens per step (Orca-style
    iteration-level fairness). ``max_seq_len`` bounds prompt+generation
    per sequence (default: the model's). ``kv_dtype`` in
    {"f32", "bf16", "int8"} picks the pool's storage dtype (default the
    model's compute dtype).

    Serving-speed knobs (the module docstring has the semantics; both
    output-invariant): ``prefix_caching=True`` shares committed prompt
    prefixes across requests, and ``spill_tier`` backs its evictions
    with host memory; ``speculative_k=k`` drafts k tokens per sequence
    and verifies them in one forward (``draft_params`` — the port's
    parameter dict, e.g. from ``params_from_jax`` — with ``draft_cfg``
    override the default truncated-target draft).

    ``role="prefill"`` makes a prefill-only replica (no decode
    function; ``serving/migrate.py`` moves its sequences on);
    ``snapshot_step`` is the weights' step in ``weights_version``
    (default 0: weights passed in directly).

    ``mesh`` (a ``DeviceMesh`` of dims ``dp`` and/or ``tp``; the module
    docstring) places this rank's shard of the full ``params`` on its
    device, which replaces ``device``; ``n_heads`` and ``d_ff`` must
    divide by ``tp`` (else ``ValueError``), and a ``vocab_size`` it does
    not divide is padded (the logits' pad columns are dropped before
    sampling)."""

    def __init__(self, cfg: TransformerConfig, params, *, device="cuda",
                 mesh=None,
                 num_blocks: int = 64, block_size: int = 16,
                 max_slots: int = 8, max_prompt_len: int | None = None,
                 token_budget: int | None = None,
                 max_seq_len: int | None = None,
                 queue_capacity: int = 256,
                 queue_policy: str = "reject",
                 kv_dtype: str | None = None,
                 prefix_caching: bool = False,
                 speculative_k: int = 0,
                 draft_params=None, draft_cfg=None,
                 role: str = "both",
                 spill_tier: "HostTier | int | None" = None,
                 snapshot_step: int | None = None):
        if role not in ("both", "prefill"):
            raise ValueError(f"role={role!r}; expected 'both' or "
                             f"'prefill'")
        if mesh is not None:
            extra = set(mesh.mesh_dim_names) - {"dp", "tp"}
            if extra:
                raise ValueError(f"a serving mesh has dims dp and tp; got "
                                 f"{tuple(mesh.mesh_dim_names)}")
            self.device = _mesh_device(mesh)
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        #: this rank on the mesh's tp and dp dims (None without them)
        self.tp = TensorParallel.from_mesh(mesh)
        self.dp = TensorParallel.from_mesh(mesh, "dp")
        if self.tp is not None:
            check_divisible(cfg, self.tp.size)
        if speculative_k and not cfg.causal:
            raise ValueError("speculative decoding requires a causal "
                             "model")
        if prefix_caching and not cfg.causal:
            raise ValueError("prefix caching requires a causal model (a "
                             "bidirectional prompt's K/V depend on the "
                             "tokens after them)")
        if speculative_k and draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        if spill_tier is not None and spill_tier is not False \
                and not prefix_caching:
            raise ValueError("spill_tier requires prefix_caching=True "
                             "(the tier backs prefix-cache eviction)")
        self.cfg = cfg
        #: "prefill" builds no decode function: step() admits and
        #: prefills only, and the disaggregated runtime exports each
        #: prefilled sequence to a decode replica (migrate.py)
        self.role = role
        #: fences host-tier spills: unique per engine incarnation, never
        #: equal across restarts
        self.pool_epoch = f"{os.getpid()}-{next(_pool_epochs)}"
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
        self.prefix_caching = bool(prefix_caching)
        self.scheduler = ContinuousBatchingScheduler(
            cache_cfg, max_slots=max_slots,
            max_blocks_per_seq=max_blocks_per_seq,
            token_budget=self.token_budget,
            queue=AdmissionQueue(queue_capacity, queue_policy),
            prefix_caching=self.prefix_caching)

        #: model-version identity stamped on serve.prefill/serve.request:
        #: snapshot step (0 = weights passed in directly) @ digest of the
        #: full weights; rotated by install_version
        self.params, self.weights_digest = self._place(cfg, params)
        self.weights_step = (int(snapshot_step)
                             if snapshot_step is not None else 0)
        self.swaps = 0
        self.swap_error: BaseException | None = None
        # checkpoint provenance (from_checkpoint sets it; load_version
        # rebuilds a pinned CheckpointManager from it)
        self._version_source: dict | None = None
        self._swap_thread: threading.Thread | None = None
        self._pending_swap = None
        self.pool = init_pool(cache_cfg, self.device, mesh=mesh)
        tp, dp = self.tp, self.dp
        self._prefill = decode_lib.make_prefill_fn(cfg, cache_cfg, tp)
        self._decode = (decode_lib.make_decode_fn(cfg, cache_cfg, tp, dp)
                        if cfg.causal and role != "prefill" else None)
        self._extend = (decode_lib.make_extend_fn(cfg, cache_cfg, tp, dp)
                        if cfg.causal else None)
        self._copy = decode_lib.make_copy_fn()

        self.spec_k = int(speculative_k)
        #: the draft is the default truncated target, re-derived from
        #: the new weights on every hot-swap
        self._draft_default = bool(self.spec_k) and draft_params is None
        if self.spec_k:
            if draft_params is None:
                # default draft: the target's own first half of layers,
                # slices of the target's weights
                draft_cfg, self._draft_params = decode_lib.truncated_draft(
                    cfg, self.params)
            else:
                if self.tp is not None:
                    check_divisible(draft_cfg, self.tp.size)
                self._draft_params, _ = self._place(draft_cfg, draft_params)
            self.draft_cfg = draft_cfg
            self._draft = decode_lib.make_draft_fn(draft_cfg, tp)

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
            "prompt tokens submitted to prefix-cache lookup")
        self._m_cached_tokens = reg.counter(
            "serving/prefix_cached_tokens",
            "prompt tokens served from the prefix cache (prefill "
            "skipped)")
        self._m_cache_blocks = reg.gauge("serving/prefix_cache_blocks")
        self._m_spec_proposed = reg.counter(
            "serving/draft_tokens_proposed")
        self._m_spec_accepted = reg.counter(
            "serving/draft_tokens_accepted")
        self._m_model_version = reg.gauge(
            "serving/model_version",
            "snapshot step of the weights currently serving")
        self._m_model_version.set(self.weights_step)
        self._m_swaps = reg.counter(
            "serving/weight_swaps", "in-place weight hot-swaps completed")

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
        self._spec_proposed_n = 0
        self._spec_accepted_n = 0
        self.migrations_out = 0
        self.migrations_in = 0
        self.migrated_bytes = 0

        self.spill_tier: HostTier | None = None
        if spill_tier is not None and spill_tier is not False:
            tier = (spill_tier if isinstance(spill_tier, HostTier)
                    else HostTier(int(spill_tier)))
            self.scheduler.prefix_cache.attach_spill(
                tier, extract=self._extract_block,
                insert=self._insert_block, epoch=self._cache_epoch())
            self.spill_tier = tier

    def _place(self, cfg, params) -> tuple:
        """``(this rank's compute-dtype parameters on its device, digest
        of the full ones)``: the canonical dict cast as at construction,
        and on a ``tp`` mesh its shard (``shard_params_at``)."""
        full = decode_lib.to_compute(decode_lib.canonical_params(
            cfg, params), cfg.dtype, self.device)
        digest = params_digest(full)
        if self.tp is not None:
            full = shard_params_at(cfg, full, self.tp.rank, self.tp.size)
        return full, digest

    def _pick(self, logits) -> np.ndarray:
        """The greedy tokens of every row of the batch, on the host: the
        argmax of this rank's rows, all-gathered over ``dp``."""
        nxt = torch.argmax(logits, dim=-1)
        if self.dp is not None:
            nxt = all_gather(nxt, self.mesh, "dp")
        return nxt.cpu().numpy()

    def _padded(self, n: int) -> int:
        """``n`` rows rounded up to a multiple of the ``dp`` size (the
        extra rows feed token 0 and write the trash block)."""
        k = self.dp.size if self.dp is not None else 1
        return -(-n // k) * k

    def _heads(self, a, gather: bool):
        """A pool array's rows ``(L, R, H_local, ...)`` → all heads over
        ``tp`` (``gather``), or all heads → this rank's (else); as is
        without ``tp``."""
        if self.tp is None:
            return a
        if gather:
            return all_gather(a, self.mesh, "tp", axis=2)
        h = a.shape[2] // self.tp.size
        return a[:, :, self.tp.rank * h:(self.tp.rank + 1) * h]

    @property
    def weights_version(self) -> str:
        """``<step>@<digest>`` — the identity stamped on serving events."""
        return f"{self.weights_step}@{self.weights_digest}"

    def _cache_epoch(self) -> str:
        """Spill epoch = incarnation × weights version: a host-tier
        block is re-adopted only while both match."""
        return f"{self.pool_epoch}/{self.weights_version}"

    @classmethod
    def from_checkpoint(cls, cfg: TransformerConfig, directory: str, *,
                        checkpoint_name: str = "ckpt",
                        local_dir: str | None = None,
                        snapshot_store=None, seed: int = 0,
                        at_step: int | None = None,
                        **engine_kwargs) -> "InferenceEngine":
        """An engine serving the weights restored down the recovery
        ladder (JAX ``:429``): a checkpoint written as
        ``Checkpoint(params=...)`` by either package (the flax leaf
        paths of ``cfg``: ``models/transformer.jax_params_layout``),
        restored by :meth:`~distributed_tensorflow_tpu_torch.checkpoint.
        checkpoint.CheckpointManager.restore_latest` (host > peer >
        local > durable; ``at_step`` pins one exact step and raises when
        it is torn or gone). With nothing restorable it serves fresh
        weights from ``seed`` (:func:`init_params`; the numbers differ
        from JAX's init). The engine keeps the checkpoint's provenance,
        so :meth:`load_version` can later swap to another step. A
        restore emits ``serve.swap`` with ``mode="restart"``."""
        from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
            Checkpoint, CheckpointManager)
        from distributed_tensorflow_tpu_torch.models.transformer import (
            init_params, params_from_flat, params_template)
        t0 = time.monotonic()
        mesh = engine_kwargs.get("mesh")
        device = (_mesh_device(mesh) if mesh is not None
                  else resolve_device(engine_kwargs.get("device", "cuda")))
        mgr = CheckpointManager(Checkpoint(params=params_template(cfg)),
                                directory, checkpoint_name=checkpoint_name,
                                local_dir=local_dir,
                                snapshot_store=snapshot_store)
        res = mgr.restore_latest(at_step=at_step)
        step = None
        if res is not None:
            _tier, step, flat = res
            params = params_from_flat(cfg, flat, "params", device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = init_params(cfg, gen, device)
        eng = cls(cfg, params, snapshot_step=step, **engine_kwargs)
        eng._version_source = dict(directory=directory,
                                   checkpoint_name=checkpoint_name,
                                   local_dir=local_dir,
                                   snapshot_store=snapshot_store)
        if step is not None:
            telemetry.event(
                "serve.swap", step=step, version=eng.weights_version,
                previous=None, mode="restart", requeued=0,
                dur_s=round(time.monotonic() - t0, 6))
        return eng

    def _restore_pinned(self, step: int) -> dict:
        """Snapshot ``step``'s flat state, pinned (a torn or pruned step
        raises, never a different version)."""
        if self._version_source is None:
            raise RuntimeError(
                "load_version: engine has no checkpoint provenance — "
                "build it with InferenceEngine.from_checkpoint")
        from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
            Checkpoint, CheckpointManager)
        from distributed_tensorflow_tpu_torch.models.transformer import (
            params_template)
        src = self._version_source
        mgr = CheckpointManager(
            Checkpoint(params=params_template(self.cfg)), src["directory"],
            checkpoint_name=src["checkpoint_name"],
            local_dir=src["local_dir"],
            snapshot_store=src["snapshot_store"])
        res = mgr.restore_latest(at_step=int(step))
        if res is None:
            raise FileNotFoundError(
                f"load_version: pinned step {step} not restorable")
        return res[2]

    def _params_of(self, flat: dict) -> dict:
        from distributed_tensorflow_tpu_torch.models.transformer import (
            params_from_flat)
        return params_from_flat(self.cfg, flat, "params", self.device)

    def load_version(self, step: int, *,
                     published_wall: "float | None" = None) -> dict:
        """Synchronous hot-swap to snapshot ``step``: pinned restore,
        then :meth:`install_version` (the restore is part of the priced
        transition). :meth:`begin_load_version` keeps the restore off
        the serving thread."""
        t0 = time.monotonic()
        flat = self._restore_pinned(step)
        return self.install_version(self._params_of(flat), step=step,
                                    published_wall=published_wall,
                                    started_mono=t0)

    def begin_load_version(self, step: int, *,
                           published_wall: "float | None" = None) -> bool:
        """Restore snapshot ``step`` on a background thread; :meth:`step`
        installs it at the next step boundary once it has landed (the
        flip stays on the serving thread). False when a load is already
        in flight. A failed restore surfaces as a ``serve.swap_error``
        event and :attr:`swap_error`; the current version keeps
        serving."""
        if self._swap_thread is not None and self._swap_thread.is_alive():
            return False

        def _work():
            t0 = time.monotonic()
            try:
                flat = self._restore_pinned(step)
            except BaseException as e:       # surfaced at the boundary
                self._pending_swap = ("error", int(step), e)
                return
            self._pending_swap = ("ready", int(step), flat,
                                  published_wall, t0)

        self._pending_swap = None
        self._swap_thread = threading.Thread(
            target=_work, name=f"swap-load-{step}", daemon=True)
        self._swap_thread.start()
        return True

    def _poll_pending_swap(self):
        """Install a background-loaded version at the step boundary."""
        if self._swap_thread is None or self._swap_thread.is_alive():
            return
        self._swap_thread = None
        pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return
        if pending[0] == "error":
            _kind, step, err = pending
            self.swap_error = err
            telemetry.event("serve.swap_error", step=step, error=repr(err))
            return
        _kind, step, flat, published_wall, t0 = pending
        self.install_version(self._params_of(flat), step=step,
                             published_wall=published_wall,
                             started_mono=t0)

    def install_version(self, params, *, step: int | None = None,
                        published_wall: "float | None" = None,
                        mode: str = "swap",
                        started_mono: "float | None" = None) -> dict:
        """Flip the serving weights in place at a step boundary. The new
        parameter dict must have the current one's names and shapes
        (else ``ValueError``); it is cast to the compute dtype as at
        construction.

        In order: (1) every running sequence is released and its
        pristine request re-queued at the front — tokens generated
        under the old weights are discarded, and queued preemption
        replays are made pristine too, so no completion mixes versions;
        (2) the weights flip (the default truncated draft is re-derived
        from them); (3) the prefix cache is fenced by the new
        ``weights_version`` (device entries dropped, host-tier spills
        epoch-fenced); (4) a ``serve.swap`` event is emitted, and the
        transition is priced as ``rollout`` badput. No request is
        dropped: the latency clock keys on the request id."""
        t0 = started_mono if started_mono is not None \
            else time.monotonic()
        new, digest = self._place(self.cfg, params)
        old_l, new_l = _leaves(self.params), _leaves(new)
        if old_l.keys() != new_l.keys() or any(
                old_l[k].shape != new_l[k].shape for k in old_l):
            raise ValueError(
                "install_version: parameter tree mismatch — hot-swap "
                "requires the same TransformerConfig (identical names "
                "and shapes); rebuild the engine for an architecture "
                "change")
        previous = self.weights_version
        requeued = self.scheduler.requeue_running()
        self.params = new
        if self._draft_default:
            self.draft_cfg, self._draft_params = decode_lib.truncated_draft(
                self.cfg, self.params)
        self.weights_step = (int(step) if step is not None
                             else self.weights_step + 1)
        self.weights_digest = digest
        dropped = 0
        if self.scheduler.prefix_cache is not None:
            dropped = self.scheduler.prefix_cache.fence(self._cache_epoch())
        self.swaps += 1
        self._m_swaps.increment()
        self._m_model_version.set(self.weights_step)
        dur = time.monotonic() - t0
        freshness = (max(0.0, time.time() - published_wall)
                     if published_wall is not None else None)
        telemetry.event(
            "serve.swap", step=self.weights_step,
            version=self.weights_version, previous=previous,
            mode=mode, requeued=requeued, cache_dropped=dropped,
            dur_s=round(dur, 6),
            freshness_s=(round(freshness, 6)
                         if freshness is not None else None))
        ledger = _goodput.active_ledger()
        if ledger is not None:
            ledger.record("rollout", dur)
        return {"step": self.weights_step,
                "version": self.weights_version,
                "previous": previous, "requeued": requeued,
                "cache_dropped": dropped, "dur_s": dur}

    # -- host spill tier ---------------------------------------------------
    def _rows_of(self, blocks) -> torch.Tensor:
        """The pool rows of ``blocks``, in order."""
        bs = self.cache_cfg.block_size
        b = torch.as_tensor(list(blocks), dtype=torch.int64)
        rows = (b[:, None] * bs + torch.arange(bs)).reshape(-1)
        return rows.to(self.device)

    def _block_rows(self, block: int) -> torch.Tensor:
        return self._rows_of([block])

    def _extract_block(self, block: int) -> dict:
        """One block's rows of every pool array (scales included) as host
        numpy; bf16 rows travel as their int16 bit patterns, which numpy
        can hold."""
        rows = self._block_rows(block)
        out = {}
        for name, a in self.pool.items():
            t = a[:, rows].cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            out[name] = t.numpy()
        return out

    def _insert_block(self, block: int, arrays: dict):
        """Write :meth:`_extract_block`'s arrays back into ``block``."""
        rows = self._block_rows(block)
        for name, a in self.pool.items():
            a[:, rows] = torch.from_numpy(arrays[name]).to(
                self.device).view(a.dtype)

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

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def _apply_copies(self, copies):
        """Execute ``BlockTable.ensure_writable``'s copy-on-write
        instructions on the pool (values and quantisation scales) before
        the divergent write they protect."""
        if not copies:
            return
        src = np.concatenate([np.arange(s, s + n) for s, _, n in copies])
        dst = np.concatenate([np.arange(d, d + n) for _, d, n in copies])
        self.pool = self._copy(self.pool, self._tensor(src),
                               self._tensor(dst))

    def _prefill_one(self, seq: Sequence):
        """Run one admitted sequence's prompt (a preempted sequence's
        replayed prompt includes its generated tokens) through prefill
        and bank its first greedy token.

        Cold: the whole prompt at its exact length through the full
        forward. Prefix-cache hit (``seq.cached_tokens`` = C > 0): only
        the suffix of S = L - C tokens, through ``extend`` against the
        window of the prompt's L positions, whose first C rows are the
        adopted blocks."""
        rid = seq.request.id
        submit_mono = self._submit_mono.get(rid)
        queue_wait = (seq.admitted_s - submit_mono
                      if submit_mono is not None else None)
        C, n = seq.cached_tokens, seq.prompt_len
        with telemetry.span(
                "serve.prefill", id=rid, span_id=request_span_id(rid),
                model_version=self.weights_version,
                prompt_tokens=n, cached_tokens=C or None,
                queue_wait_s=(round(queue_wait, 6)
                              if queue_wait is not None else None),
                replayed=len(seq.request.generated_prefix) or None):
            if C:
                # a partially-matched tail block is SHARED: copy it
                # before the suffix writes into it (and before the row
                # indices below are read from the table)
                self._apply_copies(seq.table.ensure_writable(
                    C, n, self.scheduler.allocator))
                suffix = np.arange(C, n)
                logits, self.pool = self._extend(
                    self.params, self.pool,
                    self._tensor([seq.request.tokens[C:]]),
                    self._tensor(suffix[None]), None,
                    self._tensor(seq.table.rows(suffix)[None]),
                    self._tensor(seq.table.window_rows(n)[None]))
                last = logits[0, -1]
            else:
                last, self.pool = self._prefill(
                    self.params, self.pool,
                    self._tensor([seq.request.tokens]),
                    self._tensor(seq.table.rows(np.arange(n))))
            self.scheduler.commit_prefill(seq)
            first = int(torch.argmax(last))
        self.prefills += 1
        self._m_prompt_tokens.increment(n)
        if C:
            self._m_cached_tokens.increment(C)
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
        """One incremental token for every running sequence, in JAX's
        fixed shapes: a ``(max_slots,)`` batch (a multiple of ``dp``)
        with each sequence at its slot, over the whole window; idle rows
        feed token 0 at length 0 into the trash row and their logits are
        never read."""
        B, W = self._padded(self.max_slots), self.window
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        lengths = np.zeros(B, np.int64)
        write_rows = np.zeros(B, np.int64)
        window_rows = np.zeros((B, W), np.int64)
        for seq in batch:
            i = seq.slot
            if self.prefix_caching:
                # the write at position length-1 must not land in a
                # block a prefix-cache sibling shares: copy-on-write
                # first (without a cache no block is ever shared)
                self._apply_copies(seq.table.ensure_writable(
                    seq.length - 1, seq.length, self.scheduler.allocator))
            # feed the last banked token at position length-1 (appended
            # by the previous prefill/decode step)
            tokens[i] = seq.last_token
            positions[i] = seq.length - 1
            lengths[i] = seq.length
            write_rows[i] = seq.table.row_of(seq.length - 1)
            window_rows[i] = seq.table.window_rows(W)
        t = self._tensor
        logits, self.pool = self._decode(
            self.params, self.pool, t(tokens), t(positions), t(lengths),
            t(write_rows), t(window_rows))
        nxt = self._pick(logits)
        self.decode_steps += 1
        emit = telemetry.enabled()
        for seq in batch:
            self.scheduler.append_token(seq, int(nxt[seq.slot]))
            if emit:
                self._emit_token(seq)

    # -- speculative decoding ---------------------------------------------
    def _spec_span(self, seq: Sequence) -> int:
        """How many draft tokens speculating on ``seq`` can possibly
        commit this step: capped by k, by the request's remaining output
        budget (committing j drafts + 1 target token needs remaining >=
        j + 1), and by the sequence-length ceiling."""
        remaining = seq.request.max_new_tokens - len(seq.generated)
        return max(0, min(self.spec_k, remaining - 1,
                          self.max_seq_len - seq.length))

    def _speculative_batch(self, batch: list[Sequence]) -> int:
        """Draft-then-verify for the whole decode batch (Leviathan et
        al.): the draft proposes up to k greedy tokens per sequence, the
        target scores all k+1 positions in ONE cache-aware extend
        forward, and each sequence commits the longest prefix on which
        the draft agreed with the target — plus the target's own next
        token (the bonus on full acceptance, the correction on the first
        rejection). Every committed token is the target's argmax in its
        true greedy context, so outputs are exactly the
        non-speculative ones. Returns tokens committed."""
        k, B, S = self.spec_k, len(batch), self.max_seq_len
        spans = [self._spec_span(seq) for seq in batch]
        t = self._tensor

        # 1. draft proposals: one batched greedy step by full recompute
        #    per token the widest span can commit (none when every span
        #    is 0; proposals past a span are never read), each at the
        #    width of the longest history
        lens = np.asarray([seq.length for seq in batch], np.int64)
        toks = np.zeros((B, int(lens.max()) + k), np.int64)
        for i, seq in enumerate(batch):
            toks[i, :lens[i]] = list(seq.request.tokens) + seq.generated
        proposals = np.zeros((B, k), np.int64)
        for j in range(max(spans)):
            nxt = self._draft(self._draft_params,
                              t(toks[:, :int(lens.max())]),
                              t(lens)).cpu().numpy()
            proposals[:, j] = nxt
            can = lens < S
            toks[np.arange(B)[can], lens[can]] = nxt[can]
            lens[can] += 1

        # 2. verify all k+1 positions in one extend forward
        for i, seq in enumerate(batch):
            if self.prefix_caching:
                self._apply_copies(seq.table.ensure_writable(
                    seq.length - 1, seq.length + spans[i],
                    self.scheduler.allocator))
        # the verify takes the decode step's fixed shapes: every slot,
        # the whole window
        W, E = self.window, k + 1
        rows_b = self._padded(self.max_slots)
        tokens = np.zeros((rows_b, E), np.int64)
        positions = np.full((rows_b, E), W, np.int64)  # pad -> masked
        lengths = np.zeros(rows_b, np.int64)
        write_rows = np.zeros((rows_b, E), np.int64)   # pad -> trash row
        window_rows = np.zeros((rows_b, W), np.int64)
        for i, seq in enumerate(batch):
            s, L, ke = seq.slot, seq.length, spans[i]
            tokens[s, 0] = seq.last_token
            tokens[s, 1:ke + 1] = proposals[i, :ke]
            positions[s, :ke + 1] = np.arange(L - 1, L + ke)
            lengths[s] = L + ke
            write_rows[s, :ke + 1] = seq.table.rows(np.arange(L - 1,
                                                              L + ke))
            window_rows[s] = seq.table.window_rows(W)
        logits, self.pool = self._extend(
            self.params, self.pool, t(tokens), t(positions), t(lengths),
            t(write_rows), t(window_rows))
        target_next = self._pick(logits)                     # (B, E)
        self.decode_steps += 1

        # 3. commit the agreeing prefix + the target's next token
        emit = telemetry.enabled()
        committed_total = 0
        for i, seq in enumerate(batch):
            ke = spans[i]
            j = 0
            while j < ke and proposals[i, j] == target_next[seq.slot, j]:
                j += 1
            self._m_spec_proposed.increment(ke)
            self._m_spec_accepted.increment(j)
            self._spec_proposed_n += ke
            self._spec_accepted_n += j
            for tok in target_next[seq.slot, :j + 1]:
                self.scheduler.append_token(seq, int(tok))
                committed_total += 1
                if emit:
                    self._emit_token(seq)
                if seq.done:
                    break
        return committed_total

    def step(self) -> list[dict]:
        """One continuous-batching iteration; returns completion records
        for every request finished this step."""
        t0 = time.monotonic()
        # chaos site first: an injected raise leaves scheduler and cache
        # state untouched, so the caller can simply retry the step
        faults.fire("serve.step", tag=self._step_idx)
        # a background-loaded version installs here, at the step
        # boundary: after the fault site, before any admission or
        # decode touches the old weights
        self._poll_pending_swap()
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
            if self._decode is None:
                pass
            elif self.spec_k:
                proposed0 = self._spec_proposed_n
                accepted0 = self._spec_accepted_n
                batch = sched.grow_for_decode(
                    lambda s: self._spec_span(s) + 1)
                if batch:
                    self._speculative_batch(batch)
                sp["proposed_drafts"] = self._spec_proposed_n - proposed0
                sp["accepted_drafts"] = self._spec_accepted_n - accepted0
            else:
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
            cached = sum(s.cached_tokens for s in admitted)
            if cached:
                sp["cached_tokens"] = cached
            if sched.prefix_cache is not None:
                self._m_cache_blocks.set(len(sched.prefix_cache))
        self._step_idx += 1
        step_s = time.monotonic() - t0
        self._m_step.record(step_s)
        ledger = _goodput.active_ledger()
        if ledger is not None:
            ledger.serve_step(step_s)
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
        ledger = _goodput.active_ledger()
        if ledger is not None:
            ledger.tokens(fresh=len(seq.generated), replayed=replayed)
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

    # -- KV-block migration ------------------------------------------------
    def pool_fingerprint(self) -> dict:
        """What a migration payload must match to be adopted here: the
        pool's storage dtype (the JAX package's names: ``"float32"``,
        ``"bfloat16"``, ``"int8"``, so payloads move between the
        packages), block size and per-row shape."""
        c = self.cache_cfg
        return {"kv_dtype": dtype_name(c.dtype),
                "block_size": c.block_size, "n_layers": c.n_layers,
                "n_heads": c.n_heads, "head_dim": c.head_dim}

    def export_sequence(self, seq: Sequence, *, reason: str = "migrate"):
        """Gather a prefilled sequence's KV block rows to host memory
        (one indexed read per pool array, int8 scales included) and
        return a :class:`~distributed_tensorflow_tpu_torch.serving.
        migrate.MigrationPayload` with everything another replica needs
        to continue it: the rows, the request, the tokens generated so
        far (live state, so the adopter replays nothing) and the latency
        provenance. The sequence's slot (unless the scheduler's
        preemption already freed it) and blocks are released here.

        The rows include position ``length-1``'s not yet written row:
        the next decode step writes it before any read, as in the
        monolithic step."""
        rid = seq.request.id
        sched = self.scheduler
        if not seq.prefilled:
            raise ValueError(f"export {rid}: sequence not prefilled "
                             f"(nothing in the cache to migrate)")
        from distributed_tensorflow_tpu_torch.serving import (
            migrate as _migrate)
        blocks = list(seq.table.blocks)
        t0 = time.monotonic()
        with telemetry.span("kv.migrate", id=rid,
                            span_id=migrate_span_id(rid),
                            direction="export", reason=reason,
                            blocks=len(blocks)) as sp:
            rows = self._rows_of(blocks)
            arrays = {n: self._heads(a[:, rows], True).cpu()
                      for n, a in self.pool.items()}
            ttft = ((seq.first_token_s - seq.admitted_s)
                    if seq.first_token_s is not None else None)
            payload = _migrate.MigrationPayload(
                request_id=rid, tokens=tuple(seq.request.tokens),
                max_new_tokens=seq.request.max_new_tokens,
                eos_id=seq.request.eos_id,
                generated_prefix=tuple(seq.request.generated_prefix),
                generated=tuple(seq.generated), length=seq.length,
                fingerprint=self.pool_fingerprint(),
                pool_epoch=self.pool_epoch,
                arrival_wall=self._submitted.get(rid),
                ttft_s=ttft, preemptions=seq.preemptions,
                arrays=arrays)
            sp["bytes"] = payload.nbytes
            if sched.running.get(seq.slot) is seq:
                del sched.running[seq.slot]
                sched._free_slots.append(seq.slot)
                sched._free_slots.sort(reverse=True)
            seq.table.release(sched.allocator)
            self._submitted.pop(rid, None)
            self._submit_mono.pop(rid, None)
        ledger = _goodput.active_ledger()
        if ledger is not None:
            ledger.record("kv_migrate", time.monotonic() - t0)
        self.migrations_out += 1
        self.migrated_bytes += payload.nbytes
        return payload

    def can_adopt(self, payload) -> bool:
        """A free slot and enough free blocks for ``payload`` (adoption
        never preempts to make room)."""
        n_blocks = payload.arrays["k"].shape[1] \
            // self.cache_cfg.block_size
        return (bool(self.scheduler._free_slots)
                and self.scheduler.allocator.num_free >= n_blocks)

    def adopt_sequence(self, payload, *,
                       arrival_wall: "float | None" = None) -> Sequence:
        """Install a migrated-in sequence: allocate blocks, scatter the
        payload's rows into this pool (one indexed write per array) and
        register it as prefilled and running, keeping the source's TTFT.
        Decode continues where the source stopped, with nothing
        replayed. Raises ``ValueError`` on a pool-fingerprint mismatch
        and ``OutOfBlocksError`` when capacity is short (see
        :meth:`can_adopt`); either way nothing leaks."""
        rid = payload.request_id
        fp = self.pool_fingerprint()
        if payload.fingerprint != fp:
            raise ValueError(
                f"adopt {rid}: pool fingerprint mismatch "
                f"(payload {payload.fingerprint} vs engine {fp})")
        sched = self.scheduler
        n_blocks = payload.arrays["k"].shape[1] // self.cache_cfg.block_size
        t0 = time.monotonic()
        with telemetry.span("kv.migrate", id=rid,
                            span_id=migrate_span_id(rid),
                            direction="adopt", blocks=n_blocks,
                            bytes=payload.nbytes):
            blocks = sched.allocator.alloc(n_blocks)
            try:
                req = Request(id=rid, tokens=payload.tokens,
                              max_new_tokens=payload.max_new_tokens,
                              eos_id=payload.eos_id,
                              generated_prefix=tuple(
                                  payload.generated_prefix))
                seq = sched.adopt(req, blocks, payload.length,
                                  payload.generated)
            except Exception:
                sched.allocator.free(blocks)
                raise
            rows = self._rows_of(blocks)
            for n, a in self.pool.items():
                a[:, rows] = self._heads(payload.arrays[n], False).to(
                    self.device)
            seq.preemptions = payload.preemptions
            if payload.ttft_s is not None:
                # keep the source-measured time to first token
                seq.first_token_s = seq.admitted_s + payload.ttft_s
            self._submitted[rid] = (
                arrival_wall if arrival_wall is not None
                else payload.arrival_wall
                if payload.arrival_wall is not None else time.time())
            self._submit_mono[rid] = time.monotonic()
        ledger = _goodput.active_ledger()
        if ledger is not None:
            ledger.record("kv_migrate", time.monotonic() - t0)
        self.migrations_in += 1
        self.migrated_bytes += payload.nbytes
        return seq

    def block_accounting(self) -> dict:
        """Allocator conservation audit: every live reference is owned by
        a running sequence's table or a prefix-cache entry, and free +
        allocated equals the usable pool."""
        sched = self.scheduler
        alloc = sched.allocator
        seq_refs = sum(len(s.table.blocks)
                       for s in sched.running.values())
        cache_refs = (len(sched.prefix_cache)
                      if sched.prefix_cache is not None else 0)
        return {
            "free": alloc.num_free,
            "allocated": alloc.num_allocated,
            "usable": self.cache_cfg.usable_blocks,
            "total_refs": alloc.total_refs,
            "seq_refs": seq_refs,
            "cache_refs": cache_refs,
            "leaked_refs": alloc.total_refs - seq_refs - cache_refs,
            "conserved": (alloc.num_free + alloc.num_allocated
                          == self.cache_cfg.usable_blocks),
        }

    # -- convenience -------------------------------------------------------
    def run_until_idle(self, *, max_steps: int = 100000,
                       retry_faults: bool = False) -> dict:
        """Drive :meth:`step` until queue and slots drain; returns
        ``{request_id: completion record}``. ``retry_faults=True``
        re-runs a step whose ``serve.step`` chaos site raised."""
        out: dict[str, dict] = {}
        for _ in range(max_steps):
            if self.scheduler.idle:
                break
            try:
                for rec in self.step():
                    out[rec["id"]] = rec
            except faults.FaultInjected:
                if not retry_faults:
                    raise
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
        out = {
            "steps": self._step_idx,
            "running": len(sched.running),
            "queued": len(sched.queue),
            "blocks_free": sched.allocator.num_free,
            "blocks_total": self.cache_cfg.usable_blocks,
            "preemptions": sched.preemptions,
            "deferred_prefill": sched.deferred_prefill,
            "deferred_blocks": sched.deferred_blocks,
            "migrated_out": sched.migrated_out,
            "migrations_out": self.migrations_out,
            "migrations_in": self.migrations_in,
            "migrated_bytes": self.migrated_bytes,
            "queue_rejected": sched.queue.rejected,
            "queue_evicted": sched.queue.evicted,
            "requests_completed": self.completed,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "serve_time_s": self._m_step.export().get("sum", 0.0),
            "kv_dtype": dtype_name(self.cache_cfg.dtype),
            "weights_step": self.weights_step,
            "weights_version": self.weights_version,
            "swaps": self.swaps,
        }
        if sched.prefix_cache is not None:
            out["prefix_cache"] = sched.prefix_cache.stats()
        if self.spill_tier is not None:
            out["spill_tier"] = self.spill_tier.stats()
        if self.spec_k:
            prop = self._spec_proposed_n
            out["speculative"] = {
                "k": self.spec_k,
                "proposed": prop,
                "accepted": self._spec_accepted_n,
                "accepted_rate": (self._spec_accepted_n / prop
                                  if prop else 0.0),
            }
        return out

"""Continuous (in-flight) batching: admission queue + iteration-level
scheduling — port of ``distributed_tensorflow_tpu/serving/scheduler.py``.

The Orca model (Yu et al., OSDI'22): scheduling decisions happen at
step boundaries. Each engine step the scheduler

1. retires finished sequences — their cache blocks return to the pool
   immediately;
2. admits queued requests into free slots while the *token budget*
   holds (a decode step costs 1 token per running sequence, a prefill
   the whole prompt);
3. hands the engine the prefill list and the decode batch.

Cache pressure is handled in two stages: first the prefix cache (when
one is attached) evicts unreferenced cached blocks LRU-first, then the
most recently admitted sequence is preempted, newest first: pushed back
to the FRONT of the admission queue with its blocks freed; its
generated tokens are kept and replayed as part of the prompt on
re-admission, so greedy outputs are unchanged and the oldest requests
always finish first.

**Prefix caching** (``prefix_caching=True``): at admission each
request's prompt is matched against the
:class:`~distributed_tensorflow_tpu_torch.serving.kv_cache.PrefixCache`;
matched blocks are adopted (refcounted — the engine then prefills only
the unmatched suffix, and the token budget is charged only for it), and
at prefill commit the prompt's full blocks are registered for later
requests. A preempted sequence's cached prompt blocks survive its
release (the cache keeps its reference), so replay usually re-admits
onto warm blocks.

**Migration and hot-swap hooks**: ``preempt_hook`` lets the
disaggregated engine (``serving/migrate.py``) take a preemption victim
— migrating its live KV to a sibling replica — instead of the replay
requeue; :meth:`ContinuousBatchingScheduler.adopt` installs a sequence
whose KV migrated in; :meth:`ContinuousBatchingScheduler.requeue_running`
re-queues every running request pristine for a weight hot-swap.

Pure host logic, call-for-call the JAX scheduler's.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    BlockAllocator, BlockTable, CacheConfig, OutOfBlocksError,
    PrefixCache)


class QueueOverflowError(RuntimeError):
    """The admission queue is full and the policy is ``reject``."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``max_new_tokens=0`` is a scoring request
    (prefill only — the BERT-family path): it completes with the
    prompt's last-position argmax as its single token.
    ``generated_prefix`` is internal: tokens a preempted sequence had
    already generated, replayed as prompt suffix on re-admission."""

    id: str
    tokens: tuple
    max_new_tokens: int = 16
    eos_id: int | None = None
    arrival_s: float = 0.0
    generated_prefix: tuple = ()
    tenant: str | None = None
    pclass: str = "interactive"

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t)
                                                 for t in self.tokens))
        if not self.tokens:
            raise ValueError(f"request {self.id}: empty prompt")


class Sequence:
    """Runtime state of one admitted request."""

    def __init__(self, request: Request, slot: int, table: BlockTable,
                 cached_tokens: int = 0):
        self.request = request
        self.slot = slot
        self.table = table
        #: leading prompt tokens adopted from the prefix cache — the
        #: engine prefills only positions cached_tokens..prompt_len-1
        self.cached_tokens = cached_tokens
        self.generated: list[int] = []
        self.prefilled = False
        self.admitted_s = time.monotonic()
        self.first_token_s: float | None = None
        self.preemptions = 0

    @property
    def prompt_len(self) -> int:
        return len(self.request.tokens)

    @property
    def length(self) -> int:
        """Tokens currently in the cache (prompt + generated so far)."""
        return self.table.length

    @property
    def last_token(self) -> int:
        return (self.generated[-1] if self.generated
                else self.request.tokens[-1])

    @property
    def done(self) -> bool:
        if not self.prefilled:
            return False
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        return (self.request.eos_id is not None and bool(self.generated)
                and self.generated[-1] == self.request.eos_id)


class AdmissionQueue:
    """Bounded FIFO of waiting requests. On overflow either reject the
    new request (``policy="reject"``) or evict the oldest waiting one
    (``policy="evict_oldest"``); both are counted and logged as
    ``serve.reject``."""

    def __init__(self, capacity: int = 256, policy: str = "reject"):
        if policy not in ("reject", "evict_oldest"):
            raise ValueError(f"policy={policy!r}; expected 'reject' or "
                             f"'evict_oldest'")
        self.capacity = capacity
        self.policy = policy
        self._q: collections.deque[Request] = collections.deque()
        self.rejected = 0
        self.evicted = 0
        reg = telemetry.get_registry()
        self._m_rejected = reg.counter(
            "serving/rejected_total",
            "admission-queue overflow rejections (overload shed)")
        self._m_evicted = reg.counter(
            "serving/evicted_total",
            "oldest-waiting requests evicted on overflow")

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, request: Request) -> "Request | None":
        """Enqueue; on overflow either raise (``reject``) or drop and
        return the oldest waiting request (``evict_oldest``)."""
        evicted = None
        if len(self._q) >= self.capacity:
            if self.policy == "reject":
                self.rejected += 1
                self._m_rejected.increment()
                telemetry.event("serve.reject", id=request.id,
                                tenant=request.tenant,
                                pclass=request.pclass, cause="overload",
                                queued=len(self._q),
                                capacity=self.capacity, policy=self.policy)
                raise QueueOverflowError(
                    f"admission queue full ({self.capacity})")
            evicted = self._q.popleft()
            self.evicted += 1
            self._m_evicted.increment()
            telemetry.event("serve.reject", id=evicted.id,
                            tenant=evicted.tenant, pclass=evicted.pclass,
                            cause="overload", queued=len(self._q),
                            capacity=self.capacity, policy=self.policy,
                            evicted_for=request.id)
        self._q.append(request)
        return evicted

    def push_front(self, request: Request):
        """Re-queue a preempted sequence's request at the FRONT
        (capacity is not enforced: preemption never loses a request)."""
        self._q.appendleft(request)

    def pop(self) -> "Request | None":
        return self._q.popleft() if self._q else None

    def peek(self) -> "Request | None":
        return self._q[0] if self._q else None


class ContinuousBatchingScheduler:
    """Slot + block + budget bookkeeping for one engine."""

    def __init__(self, cache_cfg: CacheConfig, *, max_slots: int,
                 max_blocks_per_seq: int, token_budget: int,
                 queue: AdmissionQueue | None = None,
                 prefix_caching: bool = False):
        self.cache_cfg = cache_cfg
        self.allocator = BlockAllocator(cache_cfg.num_blocks)
        self.queue = queue if queue is not None else AdmissionQueue()
        self.max_slots = max_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.token_budget = token_budget
        self.running: dict[int, Sequence] = {}      # slot -> sequence
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.preemptions = 0
        #: admission deferrals by cause: the prefill token budget vs
        #: pool exhaustion
        self.deferred_prefill = 0
        self.deferred_blocks = 0
        reg = telemetry.get_registry()
        self._m_deferred_prefill = reg.counter(
            "serving/deferred_prefill_total",
            "admissions deferred by the prefill token budget")
        self._m_deferred_blocks = reg.counter(
            "serving/deferred_blocks_total",
            "admissions deferred by pool exhaustion")
        #: optional callable(victim: Sequence) -> bool installed by the
        #: disaggregated engine: True takes ownership of a preemption
        #: victim (its live KV migrated to another replica) instead of
        #: the replay requeue. See _preempt_newest.
        self.preempt_hook = None
        self.migrated_out = 0
        self.prefix_cache = (PrefixCache(self.allocator,
                                         cache_cfg.block_size)
                             if prefix_caching else None)

    # -- admission --------------------------------------------------------
    def admit(self) -> list[Sequence]:
        """Admit queued requests for this step under the token budget
        (``token_budget`` minus one decode token per running sequence);
        each admission consumes the prompt tokens prefill will actually
        compute — the unmatched suffix when the prefix cache hits.
        Stops at the first request that does not fit, preserving FIFO
        order; a deferred request hands its match references back."""
        budget = self.token_budget - len(self.running)
        admitted: list[Sequence] = []
        while self._free_slots and self.queue.peek() is not None:
            req = self.queue.peek()
            cached, cblocks = (self.prefix_cache.match(req.tokens)
                               if self.prefix_cache is not None
                               else (0, []))
            need = len(req.tokens) - cached     # prefill computes this
            if need > budget and (admitted or self.running):
                if cblocks:                 # hand the match refs back
                    self.allocator.free(cblocks)
                self.deferred_prefill += 1
                self._m_deferred_prefill.increment()
                break                       # never starves: alone it runs
            blocks_needed = self.cache_cfg.blocks_for(len(req.tokens) + 1)
            if blocks_needed > self.max_blocks_per_seq:
                # can never fit: fail the request rather than wedge FIFO
                if cblocks:
                    self.allocator.free(cblocks)
                self.queue.pop()
                raise OutOfBlocksError(
                    f"request {req.id}: prompt of {len(req.tokens)} "
                    f"tokens needs {blocks_needed} blocks > "
                    f"max_blocks_per_seq={self.max_blocks_per_seq}")
            grow = blocks_needed - len(cblocks)
            if grow > self.allocator.num_free:
                if self.prefix_cache is not None:
                    self.prefix_cache.evict(grow - self.allocator.num_free)
                if grow > self.allocator.num_free:
                    if cblocks:
                        self.allocator.free(cblocks)
                    self.deferred_blocks += 1
                    self._m_deferred_blocks.increment()
                    break                   # wait for blocks to free up
            self.queue.pop()
            slot = self._free_slots.pop()
            table = BlockTable(self.cache_cfg, self.max_blocks_per_seq)
            table.blocks = list(cblocks)    # match()'s refs transfer here
            table.ensure_room(len(req.tokens) + 1, self.allocator)
            seq = Sequence(req, slot, table, cached_tokens=cached)
            self.running[slot] = seq
            admitted.append(seq)
            budget -= need
        return admitted

    # -- per-step transitions ---------------------------------------------
    def commit_prefill(self, seq: Sequence):
        seq.table.length = seq.prompt_len
        seq.prefilled = True
        if self.prefix_cache is not None:
            # index the prompt's full blocks for later requests; the
            # table holds post-copy-on-write private blocks, so every
            # registered block really contains these tokens' K/V
            self.prefix_cache.register(seq.request.tokens,
                                       seq.table.blocks)

    def _ensure_room(self, table: BlockTable, n_tokens: int):
        """``table.ensure_room`` with prefix-cache pressure relief:
        when the pool is short, evict unreferenced cached blocks before
        giving up (the caller then falls back to preemption)."""
        need = self.cache_cfg.blocks_for(table.length + n_tokens)
        while True:
            try:
                table.ensure_room(n_tokens, self.allocator)
                return
            except OutOfBlocksError:
                grow = need - len(table.blocks)
                if (need <= table.max_blocks
                        and self.prefix_cache is not None
                        and grow > self.allocator.num_free
                        and self.prefix_cache.evict(
                            grow - self.allocator.num_free) > 0):
                    continue
                raise

    def grow_for_decode(self, n_tokens=1) -> list[Sequence]:
        """Make room for ``n_tokens`` more tokens (an int, or a
        callable(seq) -> int — speculative decode reserves its span + 1
        per sequence) in every running prefilled sequence; a sequence
        that cannot grow evicts unreferenced cached blocks first, then
        triggers newest-first preemption until the growth fits. Returns
        the decode batch, in slot order."""
        batch = [s for s in self.running.values() if s.prefilled
                 and not s.done]
        batch.sort(key=lambda s: s.slot)
        for seq in list(batch):
            if seq not in batch:
                # preempted by an earlier grower this very step: its
                # table is released — growing it would leak blocks
                continue
            n = n_tokens(seq) if callable(n_tokens) else n_tokens
            while True:
                try:
                    self._ensure_room(seq.table, n)
                    break
                except OutOfBlocksError:
                    victim = self._preempt_newest(exclude=seq)
                    if victim is None:
                        raise       # nothing left to preempt: misconfig
                    if victim in batch:
                        batch.remove(victim)
        return batch

    def _preempt_newest(self, exclude: Sequence) -> "Sequence | None":
        cands = [s for s in self.running.values() if s is not exclude]
        if not cands:
            return None
        victim = max(cands, key=lambda s: s.admitted_s)
        del self.running[victim.slot]
        self._free_slots.append(victim.slot)
        self._free_slots.sort(reverse=True)
        if self.preempt_hook is not None and victim.prefilled \
                and self.preempt_hook(victim):
            # the hook took ownership: the victim's live KV migrated to
            # another replica (its blocks were released by the export),
            # so nothing is requeued and this is no replay preemption
            self.migrated_out += 1
            return victim
        victim.table.release(self.allocator)
        # generated tokens become prompt suffix: greedy decode replays
        # them identically on re-admission, and generated_prefix
        # re-attaches them to the completion record
        req = victim.request
        new_req = dataclasses.replace(
            req, tokens=req.tokens + tuple(victim.generated),
            max_new_tokens=req.max_new_tokens - len(victim.generated),
            generated_prefix=(req.generated_prefix
                              + tuple(victim.generated)))
        self.queue.push_front(new_req)
        victim.preemptions += 1
        self.preemptions += 1
        return victim

    @staticmethod
    def _pristine(req: Request) -> Request:
        """Undo the preemption-replay rewriting: the original request,
        its generated tokens stripped from the prompt and its budget
        restored."""
        n = len(req.generated_prefix)
        if n == 0:
            return req
        return dataclasses.replace(
            req, tokens=req.tokens[:len(req.tokens) - n],
            max_new_tokens=req.max_new_tokens + n,
            generated_prefix=())

    def requeue_running(self) -> int:
        """Release every running sequence and re-queue its pristine
        request at the front of the queue, oldest first — the hot-swap
        primitive: tokens generated under the old weights are discarded,
        not replayed, so no completion mixes two versions. Queued replay
        requests (a non-empty ``generated_prefix``) are made pristine
        too. Returns the number of running sequences re-queued."""
        seqs = sorted(self.running.values(),
                      key=lambda s: s.admitted_s, reverse=True)
        for seq in seqs:
            del self.running[seq.slot]
            self._free_slots.append(seq.slot)
            seq.table.release(self.allocator)
            self.queue.push_front(self._pristine(seq.request))
        self._free_slots.sort(reverse=True)
        for i, req in enumerate(self.queue._q):
            if req.generated_prefix:
                self.queue._q[i] = self._pristine(req)
        return len(seqs)

    def adopt(self, request: Request, blocks: list[int], length: int,
              generated) -> Sequence:
        """Install an already-prefilled sequence whose KV migrated in:
        ``blocks`` (allocated on this scheduler's allocator; the caller's
        references transfer to the table) hold its first ``length``
        cache rows, and ``generated`` stays live generation state, so
        nothing is replayed. Raises :class:`OutOfBlocksError` with no
        free slot or more blocks than a sequence may hold."""
        if not self._free_slots:
            raise OutOfBlocksError(
                f"adopt({request.id}): no free slot "
                f"(max_slots={self.max_slots})")
        if len(blocks) > self.max_blocks_per_seq:
            raise OutOfBlocksError(
                f"adopt({request.id}): {len(blocks)} blocks > "
                f"max_blocks_per_seq={self.max_blocks_per_seq}")
        slot = self._free_slots.pop()
        table = BlockTable(self.cache_cfg, self.max_blocks_per_seq)
        table.blocks = list(blocks)
        table.length = length
        seq = Sequence(request, slot, table)
        seq.generated = [int(t) for t in generated]
        seq.prefilled = True
        self.running[slot] = seq
        return seq

    def append_token(self, seq: Sequence, token: int):
        seq.table.length += 1
        seq.generated.append(int(token))
        if seq.first_token_s is None:
            seq.first_token_s = time.monotonic()

    def finish(self, seq: Sequence):
        """Retire a finished sequence: blocks back to the pool, slot
        freed — both available to the next admission immediately."""
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)
        self._free_slots.sort(reverse=True)
        seq.table.release(self.allocator)

    def finished(self) -> Iterable[Sequence]:
        return [s for s in self.running.values() if s.done]

    @property
    def idle(self) -> bool:
        return not self.running and len(self.queue) == 0

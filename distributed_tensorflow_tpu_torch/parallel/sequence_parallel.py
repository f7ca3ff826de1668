"""Sequence (context) parallelism: ring, striped and Ulysses attention —
port of ``distributed_tensorflow_tpu/parallel/sequence_parallel.py``.

Each rank of a mesh's ``sp`` dim holds one chunk of the sequence of
``q``, ``k`` and ``v`` ``(b, h, s_local, d)``; every function here takes
those local chunks and returns this rank's chunk of the attention over
the whole sequence. JAX runs them inside ``shard_map``; here each rank
runs its own program, and each ``ppermute`` over ``sp`` is a ring shift
(:class:`~distributed_tensorflow_tpu_torch.parallel.collectives.
RingExchange`: a send to the next rank of the dim group and a receive
from the previous one), each ``all_to_all`` a ``dist.all_to_all_single``
over the dim group.

- :func:`ring_attention` — the unfused ring: K/V rotate around the ring
  and each rank accumulates the online softmax of its queries over every
  chunk, the causal mask from global positions. Its gradient flows
  through the differentiable ring shift.
- :func:`ring_flash_attention` — the same ring with the flash kernels
  (#1-#3) as the per-block compute: the diagonal block causal, past
  chunks full, future chunks skipped outright (no launch). The backward
  runs each block's dq and dk/dv against the **global** ``(o, lse)`` of
  the merged ring (``p = exp(s − lse_global)`` is exact), with
  ``delta = rowsum(o · do)`` computed once; the dk/dv accumulators
  rotate with their chunks and make one last hop home. One registered
  op, ``dtt_torch::ring_flash_attention`` (:data:`RING_ATTENTION_OP`),
  so that the "attn" remat policies save its output as JAX's
  ``checkpoint_name(o, "attn_out")`` does.
- :func:`striped_flash_attention` — the load-balanced causal ring on
  chunks in stripe layout (rank r holds global positions r, r + n, ...):
  every block is causal at offset 0 (``src <= me``) or −1 (``src >
  me``, strict), so every rank does n near-triangular blocks.
- :func:`ulysses_attention` — all-to-all from sequence to heads, full
  sequence attention on ``h/n`` heads, all-to-all back.
- :func:`make_ring_attention` — the dispatcher (JAX's refusals), with
  the relayout of contiguous chunks to stripes and back for
  ``impl="striped"``.
- :class:`SequenceParallel` — this rank on the ``sp`` dim, as the model
  holds it.

The step-block functions (:func:`ring_block_fwd`, :func:`ring_block_bwd`,
:func:`striped_block_fwd`, :func:`striped_block_bwd`) are module-level
functions of ``(q, kv, src, me, ...)``, so that one process can run a
whole ring's blocks (``chip_smoke.py``'s ``sp_kernels``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from distributed_tensorflow_tpu_torch.ops.attention import (
    DEFAULT_MASK_VALUE, flash_attention, flash_attention_bwd,
    flash_attention_fwd, mha_reference)
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    AllToAllV, Ring, RingExchange, RingShift, all_to_all, axis_group,
    axis_size)

SP_IMPLS = ("ring", "ulysses", "striped")
_ATTN_IMPLS = ("flash", "unfused", "interpret")


def _local_attn_stats(q, k, v, *, sm_scale, mask=None):
    """One local block for the online-softmax merge: ``(o_unnormalized,
    m, l)`` in f32 (JAX ``:46``). ``mask`` broadcasts to ``(sq, sk)``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    # fully-masked rows: exp would overflow at MASK - MASK
    m_safe = torch.clamp_min(m, -1e30)
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m_safe, l


def _merge_weight(x, ref):
    """``exp(x − ref)``: 0 where ``x = −inf``, and ``ref`` taken as 0
    where it is infinite (JAX's guards around both merges)."""
    return torch.where(torch.isneginf(x), 0.0,
                       torch.exp(x - torch.where(torch.isinf(ref), 0.0,
                                                 ref)))


def _ring_mask(me: int, src: int, s_local: int, device):
    """The causal mask of my query chunk against chunk ``src``'s keys,
    from global positions."""
    ids = torch.arange(s_local, device=device)
    return (me * s_local + ids)[:, None] >= (src * s_local + ids)[None, :]


def ring_attention(q, k, v, ring: Ring, *, causal: bool = False,
                   sm_scale: float | None = None):
    """The unfused ring over ``ring`` (JAX ``:67``): local chunks ``(b, h,
    s_local, d)`` in, this rank's chunk of full attention out, in ``q``'s
    dtype. K and V travel stacked, one shift a step; the shift is
    differentiable, so autograd carries the gradient back round the
    ring."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n, me = ring.size, ring.index
    s_local = q.shape[2]
    o_acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                        device=q.device)
    m_acc = torch.full(q.shape[:3] + (1,), float("-inf"), device=q.device)
    l_acc = torch.zeros(q.shape[:3] + (1,), device=q.device)
    kv = torch.stack((k, v))
    for step in range(n):
        src = (me - step) % n
        # future chunks (src > me under causal) get an all-False mask:
        # o_b = 0, l_b = 0 and m_b = -1e30, which add exactly nothing
        o_b, m_b, l_b = _local_attn_stats(
            q, kv[0], kv[1], sm_scale=sm_scale,
            mask=_ring_mask(me, src, s_local, q.device) if causal else None)
        m_new = torch.maximum(m_acc, m_b)
        alpha = _merge_weight(m_acc, m_new)
        beta = _merge_weight(m_b, m_new)
        o_acc = o_acc * alpha + o_b * beta
        l_acc = l_acc * alpha + l_b * beta
        m_acc = m_new
        if step != n - 1:
            kv = RingShift.apply(kv, ring, 1)
    l_safe = torch.where(l_acc == 0.0, 1.0, l_acc)
    return (o_acc / l_safe).to(q.dtype)


# ---------------------------------------------------------------------------
# The flash ring: the kernels as the per-block compute
# ---------------------------------------------------------------------------

def _combine_stats(o_acc, lse_acc, o_b, lse_b):
    """Merge one block's normalized ``(o_b, lse_b)`` into the f32
    accumulators (JAX ``:138``): ``o = Σ o_b · exp(lse_b − lse_tot)``.
    The kernels store ``lse = +inf`` on a row that saw no key; such a
    row adds nothing, which is ``lse = −inf`` here."""
    lse_acc = torch.where(torch.isposinf(lse_acc), float("-inf"), lse_acc)
    lse_b = torch.where(torch.isposinf(lse_b), float("-inf"), lse_b)
    lse_new = torch.logaddexp(lse_acc, lse_b)
    alpha = _merge_weight(lse_acc, lse_new)
    beta = _merge_weight(lse_b, lse_new)
    o_new = o_acc * alpha[..., None] + o_b.float() * beta[..., None]
    return o_new, lse_new


def _skipped_block(q):
    """A future chunk's block: no launch, ``o = 0``, ``lse = −inf``."""
    return (torch.zeros_like(q),
            torch.full(q.shape[:3], float("-inf"), device=q.device))


def ring_block_fwd(q, kv, src: int, me: int, *, causal: bool,
                   sm_scale: float):
    """The contiguous schedule's forward block of chunk ``src`` at rank
    ``me`` (JAX ``_ring_step_fwd`` ``:224``), ``kv`` the stacked ``(2,
    b, h, s, d)`` K and V: #1 causal on the diagonal, full for a past
    chunk (or any chunk without ``causal``), no launch for a future
    one. Returns ``(o, lse)``."""
    if causal and src > me:
        return _skipped_block(q)
    return flash_attention_fwd(q, kv[0], kv[1], causal=causal and src == me,
                               sm_scale=sm_scale, causal_offset=0)


def ring_block_bwd(q, kv, src: int, me: int, o, lse, do, delta, *,
                   causal: bool, sm_scale: float):
    """The contiguous schedule's backward block (JAX ``_ring_flash_bwd``
    ``:264``): #2 and #3 of chunk ``src`` against the global ``(o,
    lse)`` and ``delta``; None (no launch) for a future chunk."""
    if causal and src > me:
        return None
    return flash_attention_bwd(q, kv[0], kv[1], o, lse, do,
                               causal=causal and src == me,
                               sm_scale=sm_scale, causal_offset=0,
                               delta=delta)


def striped_block_fwd(q, kv, src: int, me: int, *, sm_scale: float):
    """The striped schedule's forward block (JAX ``:357``): local row j
    is global position ``j·n + me`` and a visiting row i is ``i·n +
    src``, so ``q >= k`` iff ``j >= i + (src > me)``: #1 causal at
    offset 0, or −1 (strict) when ``src > me``, where row 0 sees no key
    (``o = 0``, ``lse = +inf``)."""
    return flash_attention_fwd(q, kv[0], kv[1], causal=True,
                               sm_scale=sm_scale,
                               causal_offset=-1 if src > me else 0)


def striped_block_bwd(q, kv, src: int, me: int, o, lse, do, delta, *,
                      sm_scale: float):
    """The striped backward block (JAX ``:380``): #2 and #3 at the
    forward's offset, against the global ``(o, lse)``."""
    return flash_attention_bwd(q, kv[0], kv[1], o, lse, do, causal=True,
                               sm_scale=sm_scale,
                               causal_offset=-1 if src > me else 0,
                               delta=delta)


def _ring_fwd_loop(q, k, v, ring: Ring, step_block):
    """The ring's forward (JAX ``_ring_fwd_loop`` ``:166``):
    ``step_block(q, kv, src, me) -> (o, lse)`` a step, merged; the next
    chunk's K/V in flight while the block computes. Returns ``(o, lse)``,
    ``o`` in ``q``'s dtype, ``lse`` f32 with ``−inf`` on rows that saw
    no key."""
    n, me = ring.size, ring.index
    kv = torch.stack((k, v))
    o_acc = lse_acc = None
    for step in range(n):
        src = (me - step) % n
        nxt = RingExchange([kv], ring) if step != n - 1 else None
        o_b, lse_b = step_block(q, kv, src, me)
        if step == 0:
            o_acc = o_b.float()
            lse_acc = torch.where(torch.isposinf(lse_b), float("-inf"),
                                  lse_b)
        else:
            o_acc, lse_acc = _combine_stats(o_acc, lse_acc, o_b, lse_b)
        if nxt is not None:
            kv = nxt.wait()[0]
    return o_acc.to(q.dtype), lse_acc


def _ring_bwd_loop(q, k, v, o, lse, do, ring: Ring, step_block_bwd):
    """The ring's backward (JAX ``_ring_bwd_loop`` ``:187``):
    ``step_block_bwd(q, kv, src, me, o, lse, do, delta) -> (dq, dk, dv)``
    or None a step. The dk/dv accumulator (f32, stacked) rotates with
    its chunk, one hop after every step (the last one home); each hop
    overlaps the next block's kernels."""
    n, me = ring.size, ring.index
    delta = (o.float() * do.float()).sum(-1)
    kv = torch.stack((k, v))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    hop = None
    for step in range(n):
        src = (me - step) % n
        nxt = RingExchange([kv], ring) if step != n - 1 else None
        grads = step_block_bwd(q, kv, src, me, o, lse, do, delta)
        if hop is not None:
            dkv = hop.wait()[0]
        if grads is not None:
            dq += grads[0].float()
            dkv[0] += grads[1].float()
            dkv[1] += grads[2].float()
        hop = RingExchange([dkv], ring, tag=1)
        if nxt is not None:
            kv = nxt.wait()[0]
    dkv = hop.wait()[0]
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


_SCHEDULES = {
    "contiguous": (ring_block_fwd, ring_block_bwd),
    "striped": (striped_block_fwd, striped_block_bwd),
}


def block_functions(schedule: str, causal: bool, sm_scale: float):
    """``(fwd, bwd)``: the step-block functions of ``schedule``
    ("contiguous" or "striped") with ``causal`` and ``sm_scale`` bound,
    each a function of ``(q, kv, src, me, ...)``."""
    fwd, bwd = _SCHEDULES[schedule]
    kw = {"sm_scale": sm_scale}
    if schedule == "contiguous":
        kw["causal"] = causal
    return functools.partial(fwd, **kw), functools.partial(bwd, **kw)


@torch.library.custom_op("dtt_torch::ring_flash_attention", mutates_args=())
def ring_flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, ranks: list[int], index: int,
                            schedule: str, causal: bool, sm_scale: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash ring as one registered op: ``(o, lse)`` over the ring of
    global ``ranks`` at ``index``, ``schedule`` "contiguous" or
    "striped" (causal); the backward the ring backward against the
    saved global ``(o, lse)``. ``lse`` takes no gradient."""
    fwd, _ = block_functions(schedule, causal, sm_scale)
    return _ring_fwd_loop(q, k, v, Ring(tuple(ranks), index), fwd)


@ring_flash_attention_op.register_fake
def _ring_flash_fake(q, k, v, ranks, index, schedule, causal, sm_scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


def _ring_flash_setup(ctx, inputs, output):
    q, k, v, ranks, index, schedule, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.ring = Ring(tuple(ranks), index)
    ctx.blocks = block_functions(schedule, causal, sm_scale)
    ctx.mark_non_differentiable(lse)


def _ring_flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _ring_bwd_loop(q, k, v, o, lse, do.contiguous(), ctx.ring,
                                ctx.blocks[1])
    return dq, dk, dv, None, None, None, None, None


ring_flash_attention_op.register_autograd(_ring_flash_backward,
                                          setup_context=_ring_flash_setup)

#: the op as selective checkpointing's policy functions see it
RING_ATTENTION_OP = torch.ops.dtt_torch.ring_flash_attention.default


def ring_flash_attention(q, k, v, ring: Ring, *, causal: bool = False,
                         sm_scale: float | None = None):
    """The flash ring (JAX ``:293``) on local chunks: this rank's chunk
    of attention over the whole sequence, differentiable through
    :func:`ring_flash_attention_op`. On a CUDA tensor every block runs
    the kernels (counted by their launch counters); on a CPU tensor
    their plain versions."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return ring_flash_attention_op(q, k, v, list(ring.ranks), ring.index,
                                   "contiguous", causal, float(sm_scale))[0]


def striped_flash_attention(q, k, v, ring: Ring, *,
                            sm_scale: float | None = None):
    """Striped causal ring attention (JAX ``:402``) on chunks in stripe
    layout (:func:`stripe_layout`: rank r holds global positions r, r +
    n, r + 2n, ...): every block is near-triangular on every rank."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return ring_flash_attention_op(q, k, v, list(ring.ranks), ring.index,
                                   "striped", True, float(sm_scale))[0]


# ---------------------------------------------------------------------------
# Striped layout
# ---------------------------------------------------------------------------

def stripe_layout(x, n: int, axis: int = 2):
    """Contiguous layout → striped, on a whole tensor (JAX ``:320``): row
    ``j·n + r`` moves to stripe r, slot j."""
    s = x.shape[axis]
    if s % n:
        raise ValueError(f"seq {s} not divisible by stripes {n}")
    shape = x.shape[:axis] + (s // n, n) + x.shape[axis + 1:]
    return x.reshape(shape).transpose(axis, axis + 1).reshape(x.shape)


def unstripe_layout(x, n: int, axis: int = 2):
    """Inverse of :func:`stripe_layout` (JAX ``:333``)."""
    s = x.shape[axis]
    shape = x.shape[:axis] + (n, s // n) + x.shape[axis + 1:]
    return x.reshape(shape).transpose(axis, axis + 1).reshape(x.shape)


@functools.lru_cache(maxsize=64)
def stripe_plan(n: int, t: int, s_local: int) -> tuple:
    """Rank ``t``'s part of the relayout of contiguous chunks (rank t
    holds positions ``[t·s_local, (t+1)·s_local)``) to stripes (rank r
    holds the positions ``≡ r (mod n)``, in order): the local indices to
    send, grouped by destination, and the counts sent to and received
    from each rank, as tuples. Rank r receives from each rank its
    positions ``≡ r`` in increasing order, so the blocks in rank order
    are r's stripe. Cached: every layer's attention asks for the same
    plan, and at 8,192 positions it costs milliseconds of Python."""
    order = sorted(range(s_local), key=lambda i: ((t * s_local + i) % n, i))
    send = [0] * n
    for i in range(s_local):
        send[(t * s_local + i) % n] += 1
    recv = [sum(1 for i in range(s_local) if (u * s_local + i) % n == t)
            for u in range(n)]
    return tuple(order), tuple(send), tuple(recv)


@functools.lru_cache(maxsize=64)
def _stripe_index(n: int, t: int, s_local: int, device) -> tuple:
    """:func:`stripe_plan`'s order and its inverse as index tensors on
    ``device``, made once: built from Python each call they cost
    milliseconds of host time and a synchronous copy to the card."""
    order = torch.tensor(stripe_plan(n, t, s_local)[0])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(s_local)
    return order.to(device), inv.to(device)


class _Permute(torch.autograd.Function):
    """``x.index_select(dim, perm)`` whose gradient gathers by the
    inverse permutation (``index_select``'s own backward scatter-adds)."""

    @staticmethod
    def forward(ctx, x, dim, perm, inv):
        ctx.dim, ctx.inv = dim, inv
        return x.index_select(dim, perm)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(ctx.dim, ctx.inv), None, None, None


def to_stripes(x, ring: Ring, group, seq_axis: int):
    """This rank's stripe of the sequence whose contiguous chunk ``x``
    holds: one all-to-all over ``group`` (differentiable), the port's
    form of JAX's ``stripe_layout`` under a sequence-sharded jit."""
    s_local = x.shape[seq_axis]
    _, send, recv = stripe_plan(ring.size, ring.index, s_local)
    perm, inv = _stripe_index(ring.size, ring.index, s_local, x.device)
    y = _Permute.apply(x, seq_axis, perm, inv).movedim(seq_axis, 0)
    return AllToAllV.apply(y, group, list(send), list(recv)).movedim(
        0, seq_axis).contiguous()


def from_stripes(y, ring: Ring, group, seq_axis: int):
    """Inverse of :func:`to_stripes`: this rank's contiguous chunk back
    from the stripes, one all-to-all."""
    s_local = y.shape[seq_axis]
    _, send, recv = stripe_plan(ring.size, ring.index, s_local)
    perm, inv = _stripe_index(ring.size, ring.index, s_local, y.device)
    x = AllToAllV.apply(y.movedim(seq_axis, 0), group, list(recv),
                        list(send)).movedim(0, seq_axis)
    return _Permute.apply(x, seq_axis, inv, perm)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp",
                      causal: bool = False, sm_scale: float | None = None,
                      attn_fn=None):
    """Ulysses sequence parallelism (JAX ``:417``): one all-to-all from
    sequence-sharded ``(b, h, s/n, d)`` to head-sharded ``(b, h/n, S,
    d)`` (q, k and v stacked), ``attn_fn`` (default
    :func:`~distributed_tensorflow_tpu_torch.ops.attention.
    flash_attention`) over the whole sequence on the local heads, one
    all-to-all back. ``h % n`` must be 0 (``ValueError``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n = axis_size(mesh, axis_name)
    h = q.shape[1]
    if h % n:
        raise ValueError(f"heads {h} not divisible by {axis_name}={n}")
    qkv = all_to_all(torch.stack((q, k, v)), mesh, axis_name,
                     split_axis=2, concat_axis=3)
    out = (attn_fn or flash_attention)(qkv[0], qkv[1], qkv[2],
                                       causal=causal, sm_scale=sm_scale)
    return all_to_all(out, mesh, axis_name, split_axis=2, concat_axis=1)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def resolve_attn_impl(attn_impl: str | None, device_type: str) -> str:
    """The per-block compute (JAX ``_resolve_attn_impl`` ``:456``):
    ``attn_impl`` as given, or None → "flash" on a CUDA mesh, "unfused"
    elsewhere (JAX: "flash" only on its accelerator). "interpret" (JAX's
    CPU-CI name) is the flash ring through the kernels' plain versions,
    taken on the CPU only; on a card it raises."""
    if attn_impl is not None:
        if attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{_ATTN_IMPLS} (or None = auto)")
        if attn_impl == "interpret" and device_type == "cuda":
            raise ValueError("attn_impl='interpret' runs the kernels' plain "
                             "versions on the CPU; on a CUDA mesh use "
                             "'flash' (the kernels) or 'unfused'")
        return attn_impl
    return "flash" if device_type == "cuda" else "unfused"


def check_impl(impl: str):
    """Raise JAX's ``ValueError`` for an unknown ``impl``."""
    if impl not in SP_IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {SP_IMPLS}")


def make_ring_attention(mesh, *, axis_name: str = "sp", causal: bool = False,
                        impl: str = "ring", attn_impl: str | None = None,
                        block_q: int = 512, block_k: int = 1024):
    """``fn(q, k, v)`` over this rank's chunks ``(b, h, s_local, d)`` of a
    sequence sharded contiguously over ``axis_name`` (JAX ``:465``; no
    ``shard_map``, so no ``spec``: under ``tp`` the heads are already
    this rank's). ``impl``: "ring", "striped" (causal; the chunks are
    relaid out to stripes and back, one all-to-all each way) or
    "ulysses". ``attn_impl``: "flash" (the kernels, future blocks
    skipped), "unfused" or "interpret" (:func:`resolve_attn_impl`).
    ``block_q`` / ``block_k`` are accepted and ignored: the port's
    kernels choose their own tiles. JAX's refusals, with its exception
    types."""
    check_impl(impl)
    attn_impl = resolve_attn_impl(attn_impl, mesh.device_type)
    del block_q, block_k
    ring = Ring.of(mesh, axis_name)
    flash = attn_impl in ("flash", "interpret")
    if impl == "striped":
        if not causal:
            raise ValueError("striped attention is a causal schedule; "
                             "use impl='ring' for bidirectional")
        if not flash:
            raise ValueError(
                "striped attention is built on the flash kernel; pass "
                "attn_impl='flash' (GPU) or 'interpret' (CPU CI), or use "
                "impl='ring' for the unfused path")
        group = axis_group(mesh, axis_name)

        def striped(q, k, v):
            qkv = to_stripes(torch.stack((q, k, v)), ring, group, 3)
            o = striped_flash_attention(qkv[0], qkv[1], qkv[2], ring)
            return from_stripes(o, ring, group, 2)
        return striped
    if impl == "ring":
        if flash:
            return functools.partial(ring_flash_attention, ring=ring,
                                     causal=causal)
        return functools.partial(ring_attention, ring=ring, causal=causal)
    return functools.partial(ulysses_attention, mesh=mesh,
                             axis_name=axis_name, causal=causal,
                             attn_fn=flash_attention if flash
                             else mha_reference)


def attention_blocks(impl: str, n: int, index: int, causal: bool) -> int:
    """Flash launches of one attention call at ring ``index`` of ``n``
    (each of #1, #2 and #3: a forward's, a backward's): the contiguous
    ring launches ``index + 1`` causal (future chunks skipped), ``n``
    otherwise; striped ``n`` on every rank; Ulysses 1, at ``h/n``
    heads."""
    if impl == "ulysses":
        return 1
    if impl == "ring" and causal:
        return index + 1
    return n


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """This rank on a mesh's ``sp`` dim, as the model holds it: ``size``
    and ``index`` (its chunk of the sequence) and ``attn``, the
    attention over the whole sequence from local chunks
    (:func:`make_ring_attention` with the config's ``sp_impl`` and
    ``sp_attn_impl``)."""
    size: int
    index: int
    attn: object

    @classmethod
    def from_mesh(cls, mesh, cfg) -> "SequenceParallel | None":
        """The handle of ``mesh``'s ``sp`` dim; None without one or at
        size 1 (JAX takes the ring only when ``sp > 1``)."""
        if mesh is None or "sp" not in (mesh.mesh_dim_names or ()):
            return None
        size = mesh.size(tuple(mesh.mesh_dim_names).index("sp"))
        if size == 1:
            return None
        return cls(size, mesh.get_local_rank("sp"),
                   make_ring_attention(mesh, causal=cfg.causal,
                                       impl=cfg.sp_impl,
                                       attn_impl=cfg.sp_attn_impl))

    def chunk(self, seq_len: int) -> slice:
        """This rank's positions of a ``seq_len`` sequence; ``ValueError``
        unless ``sp`` divides it (JAX's GSPMD would pad)."""
        if seq_len % self.size:
            raise ValueError(f"sequence length {seq_len} is not divisible "
                             f"by sp={self.size}; sequence parallelism "
                             f"splits it into equal chunks")
        n = seq_len // self.size
        return slice(self.index * n, (self.index + 1) * n)

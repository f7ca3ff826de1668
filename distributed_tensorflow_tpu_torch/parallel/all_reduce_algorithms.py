"""Explicit all-reduce algorithms: ring, recursive halving-doubling,
shuffle — port of ``distributed_tensorflow_tpu/parallel/
all_reduce_algorithms.py`` (≙ the reference's ``v1/all_reduce.py``
``build_ring_all_reduce`` :250, ``build_recursive_hd_all_reduce`` :422,
``build_shuffle_all_reduce`` :554).

JAX's are region functions inside ``shard_map`` over a mesh axis, each
exchange a ``ppermute`` or an ``all_to_all``. Here each function runs on
one rank's tensor over a process group (``group`` None: the default
group; a mesh dim's: ``mesh.get_group(name)``), with JAX's chunk
schedule, padding and refusals:

- **ring** and **recursive halving-doubling** exchange with
  point-to-point sends (one ``batch_isend_irecv`` a step), and add the
  received partial sum to this rank's chunk in JAX's order, so in f32
  their result equals JAX's bit for bit;
- **shuffle** is one ``all_to_all_single`` and one
  ``all_gather_into_tensor``; its sum over the ``n`` received chunks may
  differ from JAX's in the last bit;
- ``"xla"`` (JAX: let the compiler choose, ``psum``) is the group's own
  ``all_reduce`` — NCCL's on the card. The name is kept so that a caller
  written against JAX runs unchanged.

The default training paths keep the bucketed all-reduce of
``parallel/collectives.py``; this library is the explicit-control
option, for measuring schedules against the library's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _peer(group, i: int) -> int:
    return i if group is None else dist.get_global_rank(group, i)


def _exchange(send: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """``ppermute`` for one rank: send ``send`` to group rank ``to`` and
    return what group rank ``frm`` sent."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), _peer(group, to),
                      group),
           dist.P2POp(dist.irecv, recv, _peer(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bandwidth-optimal ring (JAX ``:46``): reduce-scatter in n-1 steps,
    each forwarding the partial sum received and adding this rank's own
    chunk of it; then an all-gather of the reduced chunks in n-1 steps."""
    n, me = _size_rank(group)
    if n == 1:
        return x.clone()
    chunks = _padded(x, n).reshape(n, -1)
    nxt, prv = (me + 1) % n, (me - 1) % n
    buf = chunks[me]
    for s in range(n - 1):
        buf = _exchange(buf, nxt, prv, group)
        buf = buf + chunks[(me - s - 1) % n]
    out = chunks.clone()
    out[(me + 1) % n] = buf
    for s in range(n - 1):
        buf = _exchange(buf, nxt, prv, group)
        out[(me - s) % n] = buf
    return out.reshape(-1)[:x.numel()].reshape(x.shape)


def recursive_hd_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Recursive halving-doubling (JAX ``:84``): log2(n) pairwise rounds
    at distance n/2, n/4, ..., 1 that keep and sum half the segment,
    then the rounds in reverse doubling it back. Refuses a world size
    that is not a power of two."""
    n, me = _size_rank(group)
    if n == 1:
        return x.clone()
    if n & (n - 1):
        raise ValueError(f"recursive halving-doubling needs a power-of-2 "
                         f"world size, got {n}")
    work = _padded(x, n)
    dists = []
    d = n // 2
    while d >= 1:
        peer = me ^ d
        bit = (me // d) % 2
        half = work.numel() // 2
        halves = (work[:half], work[half:])
        received = _exchange(halves[1 - bit], peer, peer, group)
        work = halves[bit] + received
        dists.append(d)
        d //= 2
    for d in reversed(dists):
        peer = me ^ d
        received = _exchange(work, peer, peer, group)
        bit = (me // d) % 2
        work = (torch.cat([work, received]) if bit == 0
                else torch.cat([received, work]))
    return work[:x.numel()].reshape(x.shape)


def shuffle_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Shuffle (JAX ``:129``): one all-to-all hands chunk c of every rank
    to rank c, which sums it; one all-gather returns the sums."""
    n, _ = _size_rank(group)
    if n == 1:
        return x.clone()
    chunks = _padded(x, n).reshape(n, -1).contiguous()
    gathered = torch.empty_like(chunks)
    dist.all_to_all_single(gathered, chunks, group=group)
    reduced = gathered.sum(dim=0)
    full = reduced.new_empty(n * reduced.numel())
    dist.all_gather_into_tensor(full, reduced, group=group)
    return full[:x.numel()].reshape(x.shape)


def library_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's own all-reduce (NCCL's on the card): JAX's ``"xla"``."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


ALGORITHMS = {
    "ring": ring_all_reduce,
    "recursive_hd": recursive_hd_all_reduce,
    "shuffle": shuffle_all_reduce,
    "xla": library_all_reduce,
}


def all_reduce(x: torch.Tensor, group=None,
               algorithm: str = "xla") -> torch.Tensor:
    """The sum of every rank's ``x`` by the named algorithm (JAX's names;
    ``"xla"``, the default, is the library's all-reduce)."""
    try:
        fn = ALGORITHMS[algorithm]
    except KeyError:
        raise ValueError(f"algorithm={algorithm!r}; expected one of "
                         f"{sorted(ALGORITHMS)}") from None
    return fn(x, group)

"""Pipeline parallelism over the ``"pp"`` mesh dim (GPipe, 1F1B and
interleaved 1F1B) — port of ``distributed_tensorflow_tpu/parallel/
pipeline.py``.

JAX runs a schedule as one ``lax.scan`` over lockstep cycles inside
``shard_map``, and moves activations between stages with
``lax.ppermute``. Here every pp rank is a process of its own: it runs
its own entries of :func:`schedule_table` in cycle order, and each
``ppermute`` becomes a point-to-point send to the neighbouring rank of
the pp dim (:class:`StageLinks`: NCCL on the card, gloo on the CPU). So
the table that :func:`validate_schedule` checks is the program that
runs (:func:`run_schedule`).

- **GPipe**: every forward of the step, then every backward in reverse
  order. Each microbatch's autograd graph is kept until its backward,
  so activations are O(M).
- **1F1B**: forward units run without autograd; only the stage *input*
  is stashed (at most min(M, 2S-1) of them, as JAX's ring), and the
  backward unit recomputes the stage forward under autograd before its
  backward, as JAX's ``jax.vjp`` in the cycle body does. With
  ``offload_activations`` the stash goes through
  :class:`~distributed_tensorflow_tpu_torch.parallel.offload.
  ActivationSpillStore`.
- **Interleaved 1F1B**: worker k holds model stages k, W+k, …
  (``chunk * W + worker``); a microbatch crosses every worker v times.

The schedule math (:func:`bubble_fraction`, :func:`schedule_table`,
:func:`validate_schedule`, :func:`schedule_spans`,
:func:`schedule_idle_fraction`) is a copy of JAX's, held to it exactly.
``bubble_fraction`` stays JAX's lockstep formula; the processes here
are not in lockstep (a rank waits only for the tensors it needs), so
the bubble measured on the card can sit below it, down to the classic
(S-1)/(M+S-1).
"""

from __future__ import annotations

import collections
from typing import Callable

import torch
import torch.distributed as dist

#: the two lanes of a schedule: activations flow forward, their
#: gradients backward
FWD, BWD = 0, 1


# ---------------------------------------------------------------------------
# Schedule math (JAX :107-366, pure Python, copied)
# ---------------------------------------------------------------------------

def bubble_fraction(n_stages: int, n_micro: int,
                    schedule: str = "gpipe", *,
                    interleave: int = 1) -> float:
    """Idle fraction of the pipeline schedule (JAX ``:107``).

    ``n_stages`` counts WORKERS (pp ranks). For ``schedule=
    "interleaved"`` each worker holds ``interleave`` virtual chunks, so
    the model has ``n_stages * interleave`` stages total and the bubble
    is (vW + W - 2)/(Mv + vW + W - 2) — strictly below plain 1F1B's for
    v >= 2, equal at v=1.
    """
    s, m = int(n_stages), int(n_micro)
    v = int(interleave)
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {v}")
    if schedule == "gpipe":
        return (s - 1) / (m + s - 1)
    if schedule == "1f1b":
        return 2 * (s - 1) / (m + 2 * (s - 1))
    if schedule == "interleaved":
        return (v * s + s - 2) / (m * v + v * s + s - 2)
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_table(n_stages: int, n_micro: int, schedule: str = "gpipe",
                   *, interleave: int = 1) -> "list[dict]":
    """Flat unit-of-work table of one pipeline step (JAX ``:131``).

    Each entry is ``{"worker", "cycle", "lane", "mb", "stage"}`` — one
    microbatch's forward or backward of one MODEL stage on one worker at
    one lockstep cycle. ``lane`` is ``"fwd"``, ``"bwd"``, or
    ``"fwd+bwd"`` (GPipe's fused sweep, where the reverse schedule is
    implicit under autodiff); ``stage`` is the model-stage index, which
    equals the worker for non-interleaved schedules and ``chunk *
    n_workers + worker`` for interleaved.
    """
    s, m = int(n_stages), int(n_micro)
    v = int(interleave)
    if s < 1 or m < 1 or v < 1:
        raise ValueError(
            f"need n_stages>=1, n_micro>=1, interleave>=1, got {s}/{m}/{v}")
    table: list[dict] = []
    if schedule == "gpipe":
        for k in range(s):
            for j in range(m):
                table.append({"worker": k, "cycle": j + k,
                              "lane": "fwd+bwd", "mb": j, "stage": k})
    elif schedule == "1f1b":
        for k in range(s):
            for j in range(m):
                table.append({"worker": k, "cycle": j + k,
                              "lane": "fwd", "mb": j, "stage": k})
                table.append({"worker": k, "cycle": j + 2 * s - 2 - k,
                              "lane": "bwd", "mb": j, "stage": k})
    elif schedule == "interleaved":
        if m % s != 0:
            raise ValueError(
                f"interleaved needs n_micro % n_workers == 0, got {m}/{s}")
        w = s
        for k in range(w):
            for j in range(v):
                for g in range(m // w):
                    for r in range(w):
                        mb = g * w + r
                        table.append({
                            "worker": k,
                            "cycle": g * v * w + j * w + r + k,
                            "lane": "fwd", "mb": mb, "stage": j * w + k})
                        table.append({
                            "worker": k,
                            "cycle": (v * w - 1) + g * v * w
                            + (v - 1 - j) * w + r + (w - 1 - k),
                            "lane": "bwd", "mb": mb, "stage": j * w + k})
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return table


def validate_schedule(table: "list[dict]") -> "list[str]":
    """Physical-validity check of a :func:`schedule_table` (JAX ``:187``):
    no worker runs two units in the same (cycle, lane) — a ``fwd+bwd``
    entry books both lanes; every (microbatch, model stage) runs exactly
    one forward, and one backward when the schedule has backward
    entries; a forward of stage s+1 strictly after that of stage s, a
    backward of stage s strictly after that of stage s+1, and the last
    stage's backward no earlier than its own forward. Returns the
    violations; an empty list means valid."""
    problems: list[str] = []
    if not table:
        return ["empty schedule"]
    booked: set = set()
    for e in table:
        lanes = ("fwd", "bwd") if e["lane"] == "fwd+bwd" else (e["lane"],)
        for lane in lanes:
            key = (e["worker"], e["cycle"], lane)
            if key in booked:
                problems.append(
                    f"worker {e['worker']} double-booked: cycle "
                    f"{e['cycle']} lane {lane}")
            booked.add(key)
    occ: dict = {}
    for e in table:
        lane = "fwd" if e["lane"] == "fwd+bwd" else e["lane"]
        occ.setdefault((e["mb"], e["stage"], lane), []).append(e["cycle"])
    n_stage = max(e["stage"] for e in table) + 1
    mbs = sorted({e["mb"] for e in table})
    has_bwd = any(e["lane"] == "bwd" for e in table)
    for mb in mbs:
        for st in range(n_stage):
            fwd = occ.get((mb, st, "fwd"), [])
            if len(fwd) != 1:
                problems.append(
                    f"mb {mb} stage {st}: {len(fwd)} fwd units (want 1)")
                continue
            if st > 0:
                prev = occ.get((mb, st - 1, "fwd"), [])
                if prev and fwd[0] < prev[0] + 1:
                    problems.append(
                        f"mb {mb}: fwd stage {st} at cycle {fwd[0]} not "
                        f"after stage {st - 1} at {prev[0]}")
            if not has_bwd:
                continue
            bwd = occ.get((mb, st, "bwd"), [])
            if len(bwd) != 1:
                problems.append(
                    f"mb {mb} stage {st}: {len(bwd)} bwd units (want 1)")
                continue
            if st == n_stage - 1 and bwd[0] < fwd[0]:
                problems.append(
                    f"mb {mb}: last-stage bwd at cycle {bwd[0]} before "
                    f"its fwd at {fwd[0]}")
            nxt = occ.get((mb, st + 1, "bwd"), [])
            if nxt and bwd[0] < nxt[0] + 1:
                problems.append(
                    f"mb {mb}: bwd stage {st} at cycle {bwd[0]} not "
                    f"after stage {st + 1} at {nxt[0]}")
    return problems


def schedule_spans(n_stages: int, n_micro: int, schedule: str = "gpipe",
                   *, t_cycle_s: float = 1.0,
                   interleave: int = 1) -> "list[list[dict]]":
    """Analytic per-stage busy spans of one pipeline step (JAX ``:254``):
    per stage, the busy intervals ``{"t0", "t1", "kind"}`` in units of
    ``t_cycle_s``; their idle share equals :func:`bubble_fraction`."""
    s, m = int(n_stages), int(n_micro)
    if s < 1 or m < 1:
        raise ValueError(f"need n_stages>=1 and n_micro>=1, got {s}/{m}")
    spans: list[list[dict]] = [[] for _ in range(s)]

    def busy(stage: int, tick: int, kind: str):
        spans[stage].append({"t0": tick * t_cycle_s,
                             "t1": (tick + 1) * t_cycle_s, "kind": kind})

    if schedule == "gpipe":
        for k in range(s):
            for j in range(m):
                busy(k, j + k, "fwd+bwd")
    elif schedule == "1f1b":
        for k in range(s):
            for c in range(m + 2 * (s - 1)):
                f, b = c - k, c - (2 * s - 2 - k)
                fwd, bwd = 0 <= f < m, 0 <= b < m
                if fwd or bwd:
                    busy(k, c, "fwd+bwd" if fwd and bwd
                         else "fwd" if fwd else "bwd")
    elif schedule == "interleaved":
        cells: dict = {}
        for e in schedule_table(s, m, "interleaved", interleave=interleave):
            cells.setdefault((e["worker"], e["cycle"]), set()).add(e["lane"])
        for (k, c), lanes in sorted(cells.items()):
            busy(k, c, "fwd+bwd" if len(lanes) == 2 else next(iter(lanes)))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return spans


def schedule_idle_fraction(spans: "list[list[dict]]") -> float:
    """Idle share of a :func:`schedule_spans` timeline (JAX ``:313``):
    1 - busy time / (stages x makespan), a cycle running one of its two
    lanes counting half-busy."""
    if not spans:
        return 0.0
    end = max((sp["t1"] for row in spans for sp in row), default=0.0)
    if end <= 0:
        return 0.0
    busy = sum((sp["t1"] - sp["t0"])
               * (1.0 if sp["kind"] == "fwd+bwd" else 0.5)
               for row in spans for sp in row)
    return 1.0 - busy / (len(spans) * end)


def stack_stage_params(per_stage_params: list):
    """``[stage0_tree, stage1_tree, ...]`` → one tree (nested dicts of
    tensors, as the port's parameter dict) with a leading stage axis
    (JAX ``:721``)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in per_stage_params])
                for k in first}
    return torch.stack(list(per_stage_params))


# ---------------------------------------------------------------------------
# Point-to-point links between the stages
# ---------------------------------------------------------------------------

class StageLinks:
    """This rank's place on the ``pp`` dim of ``mesh`` (its worker index
    ``index`` of ``size``, :func:`~distributed_tensorflow_tpu_torch.
    cluster.topology.pp_index`) and the sends and receives to the other
    workers of its pp group, each ``ppermute`` of JAX's body.

    A send is asynchronous (``isend``; :meth:`finish` waits for all), a
    receive returns its tensor once it is there. NCCL orders the sends
    and receives between two ranks on one stream per communicator, and
    two ranks that both send first would wait on each other; so on NCCL
    every directed edge of a lane (``k → k±1``) gets a two-rank group of
    its own, which carries one direction only, in the order both sides
    issue it. Gloo sends progress by themselves, so on gloo the lanes
    are tags on the pp group. A transfer to this rank itself (one
    worker, or the interleaved wrap at one worker) is a queue. Without
    the dim (or ``mesh`` None) the rank is the only worker."""

    def __init__(self, mesh=None):
        from distributed_tensorflow_tpu_torch.cluster import topology
        self._local = {FWD: collections.deque(), BWD: collections.deque()}
        self._pending: list = []
        self._edges: dict = {}
        self.reset_counts()
        self.index = 0 if mesh is None else topology.pp_index(mesh)
        self._ranks = ([0] if mesh is None
                       else topology.pp_group_ranks(mesh))
        self.size = len(self._ranks)
        self._group = (None if self.size == 1
                       else mesh.get_group(topology.PIPELINE_AXIS))
        if self._group is not None and \
                dist.get_backend(self._group) == "nccl":
            # every rank creates every edge group, in one order
            me = dist.get_rank()
            for row in topology.pp_rows(mesh):
                for lane, step in ((FWD, 1), (BWD, -1)):
                    for k in range(self.size):
                        pair = [row[k], row[(k + step) % self.size]]
                        group = dist.new_group(pair)
                        if me in pair:
                            self._edges[(lane, pair[0], pair[1])] = group

    def reset_counts(self):
        self.counts = {"sends": 0, "recvs": 0, "send_bytes": 0,
                       "recv_bytes": 0}

    def _group_for(self, lane: int, src: int, dst: int):
        if self._edges:
            return self._edges[(lane, src, dst)]
        return self._group

    def send(self, t: torch.Tensor, to: int, lane: int):
        """Send ``t`` to worker ``to`` on ``lane`` (asynchronously)."""
        if to == self.index:
            self._local[lane].append(t)
            return
        t = t.detach().contiguous()
        dst = self._ranks[to]
        # the tensor stays referenced until its send is waited for
        self._pending.append((t, dist.isend(
            t, dst=dst, group=self._group_for(lane, dist.get_rank(), dst),
            tag=lane)))
        self.counts["sends"] += 1
        self.counts["send_bytes"] += t.numel() * t.element_size()

    def recv(self, shape, dtype, device, frm: int, lane: int
             ) -> torch.Tensor:
        """The next tensor worker ``frm`` sent this rank on ``lane``."""
        if frm == self.index:
            return self._local[lane].popleft()
        t = torch.empty(shape, dtype=dtype, device=device)
        src = self._ranks[frm]
        dist.irecv(t, src=src, group=self._group_for(lane, src,
                                                      dist.get_rank()),
                   tag=lane).wait()
        self.counts["recvs"] += 1
        self.counts["recv_bytes"] += t.numel() * t.element_size()
        return t

    def finish(self):
        """Wait for every send issued so far."""
        for _, work in self._pending:
            work.wait()
        self._pending.clear()


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

class _DeviceStash(dict):
    """The default 1F1B stash: stage inputs on the device by forward
    cycle."""
    put = dict.__setitem__


def rank_units(n_workers: int, worker: int, n_micro: int, schedule: str,
               interleave: int = 1) -> list:
    """``worker``'s entries of the validated :func:`schedule_table`, in
    the order :func:`run_schedule` runs them: by cycle, a cycle's forward
    before its backward; GPipe's ``"fwd+bwd"`` entries as forwards, then
    again as backwards in reverse."""
    v = int(interleave) if schedule == "interleaved" else 1
    table = schedule_table(n_workers, n_micro, schedule, interleave=v)
    problems = validate_schedule(table)
    if problems:
        raise ValueError(f"invalid {schedule} schedule: {problems[:3]}")
    mine = sorted((e for e in table if e["worker"] == worker),
                  key=lambda e: (e["cycle"], e["lane"] == "bwd"))
    if schedule == "gpipe":
        return ([dict(e, lane="fwd") for e in mine]
                + [dict(e, lane="bwd") for e in reversed(mine)])
    return mine


def run_schedule(links: StageLinks, schedule: str, n_micro: int, *,
                 stage_fn: Callable, head_fn: Callable, input_fn: Callable,
                 act_shape, act_dtype, device, interleave: int = 1,
                 stash=None) -> torch.Tensor:
    """Run this rank's units (:func:`rank_units`) and return the sum of
    the microbatch losses it computed (f32; zero off the last model
    stage). Gradients accumulate into whatever the callables' autograd
    graphs reach, microbatch by microbatch in the order of JAX's body:

    - ``input_fn(m)``: model stage 0's input for microbatch ``m`` (the
      embedding lookup); its graph takes the input's gradient;
    - ``stage_fn(j, x)``: this rank's chunk ``j`` (model stage ``j *
      size + index``) on ``x``, same shape out;
    - ``head_fn(m, y)``: the loss of microbatch ``m`` on the last model
      stage's output, whose backward starts from ``1 / n_micro`` (JAX's
      cotangent);
    - ``act_shape`` / ``act_dtype``: a stage input's shape and dtype,
      what travels between the stages;
    - ``stash``: where 1F1B keeps a stage input between its forward and
      its backward (``put`` / ``pop`` by forward cycle; an
      :class:`~distributed_tensorflow_tpu_torch.parallel.offload.
      ActivationSpillStore`), a dict on the device by default.
      The last model stage runs a microbatch's backward in the cycle of
      its forward and keeps that input itself, as JAX's offloaded body
      reads it in-body.
    """
    W = links.size
    last = W * (int(interleave) if schedule == "interleaved" else 1) - 1
    scale = torch.tensor(1.0 / n_micro, dtype=torch.float32, device=device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)

    def recv(frm, lane):
        return links.recv(act_shape, act_dtype, device, frm, lane)

    units = rank_units(W, links.index, n_micro, schedule, interleave)
    if schedule == "gpipe":
        graphs = {}
        for e in units:
            m, s = e["mb"], e["stage"]
            if e["lane"] == "fwd":
                x = input_fn(m) if s == 0 else recv((s - 1) % W,
                                                    FWD).requires_grad_()
                y = stage_fn(s // W, x)
                if s == last:
                    y = head_fn(m, y)
                    loss_sum = loss_sum + y.detach().float()
                else:
                    links.send(y, (s + 1) % W, FWD)
                graphs[(m, s)] = (x, y)
                continue
            x, out = graphs.pop((m, s))
            if s == last:
                torch.autograd.backward(out, scale.to(out.dtype))
            else:
                torch.autograd.backward(out, recv((s + 1) % W, BWD))
            if s > 0:
                links.send(x.grad, (s - 1) % W, BWD)
            del x, out
        links.finish()
        return loss_sum

    stash = _DeviceStash() if stash is None else stash
    fwd_cycle, kept = {}, {}
    for e in units:
        m, s, c = e["mb"], e["stage"], e["cycle"]
        if e["lane"] == "fwd":
            if s == 0:
                with torch.no_grad():
                    x = input_fn(m)
            else:
                x = recv((s - 1) % W, FWD)
            if s == last:
                kept[m] = x
            else:
                stash.put(c, x)
                fwd_cycle[(m, s)] = c
            with torch.no_grad():
                y = stage_fn(s // W, x)
            if s != last:
                links.send(y, (s + 1) % W, FWD)
            del x, y
            continue
        if s == last:
            x = kept.pop(m)
        else:
            x = stash.pop(fwd_cycle.pop((m, s)))
        x = x.detach().requires_grad_()
        y = stage_fn(s // W, x)
        if s == last:
            loss = head_fn(m, y)
            torch.autograd.backward(loss, scale.to(loss.dtype))
            loss_sum = loss_sum + loss.detach().float()
        else:
            torch.autograd.backward(y, recv((s + 1) % W, BWD))
        if s > 0:
            links.send(x.grad, (s - 1) % W, BWD)
        else:
            torch.autograd.backward(input_fn(m), x.grad)
        del x, y
    links.finish()
    return loss_sum

#!/usr/bin/env python3
"""Data-, tensor-, pipeline-, sequence-, expert- and fully-sharded
parallel training of the PyTorch port across GPUs, with the phase breakdown of ``bench.py``'s
``transformer_phase_breakdown``.

    python3 tools/torch_dp_run.py --world 4
        [--mesh dp|dcn2xdp2|tp4|dp2xtp2|pp4|dp2xpp2|sp4|dp2xsp2|sp2xtp2
                |ep4|dp2xep2|ep2xtp2|fsdp4|dp2xfsdp2|fsdp2xtp2]
        [--moe-experts E] [--moe-top-k k]
        [--zero 0|1|2] [--grad-sync auto|none|gspmd]
        [--schedule gpipe|1f1b|interleaved] [--interleave v] [--offload]
        [--sp-impl ring|striped|ulysses]
        [--workload transformer|bert|resnet|wide_deep] [--device cuda|cpu]
        [--tiny]

Spawns one rank a device through the port's ``testing/
multi_process_runner`` (NCCL on ``cuda``, gloo on ``cpu``) and builds
``make_sharded_train_step`` (BERT: ``models/bert.py``'s) over the mesh:
``transformer`` is ``bench.py``'s headline row (``transformer_big``,
max_seq_len 1024, no remat, unrolled layers, kernel cross-entropy, bf16
AdamW first moment) at 8 × 1024 tokens a rank, ``bert`` its ``run_bert``
(``bert_base``, full-logits MLM loss) at 32 × 512 a rank; random
weights from seed 0, one seeded batch. Each rank times, with CUDA
events, the best of ``--reps`` means over ``--iters`` steps after a
warm-up step of:

- the full step;
- the same compute without the gradient sync (``grad_sync="none"``;
  for BERT, and at one rank, the step on the rank's rows alone; on a
  mesh with ``tp``, ``sp``, ``ep`` or ``fsdp``, the post-sync step with
  its post-backward reduction left out, none for BERT: the ep
  boundary all-reduces and the fsdp gathers and reduce-scatters stay
  in it, so there the exposed time is the post-backward sync's alone);
- the bucketed all-reduce alone on a gradient-shaped list of tensors
  (serial: nothing to hide behind), chained;
- on a mesh with ``tp`` (``tp4``: ``{"tp": world}``; ``dp2xtp2``:
  ``{"dp": 2, "tp": world / 2}``, 8 × 1024 tokens a data shard): the
  step's tp collectives alone, chained on tensors of their shapes —
  per layer two forward and two backward all-reduces of the ``(rows,
  S, D)`` activation in the compute dtype, the embedding's one, and per
  4096-row CE chunk the f32 dh all-reduce and the two all-gathers of
  its ``(lse, tl)`` (``tp_serial_ms``, with their count and bytes).

``--workload resnet`` (``--mesh dp``) is ``bench.py``'s ``run_scaling``
ResNet row: ``resnet.make_sharded_train_step`` at ResNet-50, bf16, 128
images of 224² a rank (``--tiny``: ``ResNetConfig.tiny()``, 8 of 32²),
the BatchNorm statistics averaged over the data ranks.
``--workload wide_deep`` (``--mesh dp``, ``tp4`` or ``dp2xtp2``) is the
DLRM step (``wide_deep.make_sharded_train_step`` at ``dlrm_like``, tables
row-sharded over ``tp``, 4096 examples a data shard; ``--tiny``:
``WideDeepConfig.tiny()``, 64) and, timed beside it, the same through
the embedding API (``make_embedding_train_step``, ``emb_step_ms``). For
both, the no-sync time is the single-device step on the rank's rows
(for DLRM on a tp mesh none: the tables need the mesh) and the serial
collective time the bucketed all-reduce of the gradients over the data
axes; the rate is images/s or examples/s.

On a sequence-parallel mesh (``sp4``: ``{"sp": world}`` at 32,768
tokens, one row; ``dp2xsp2``: ``{"dp": 2, "sp": 2}`` at 16,384 tokens,
one row a data shard; ``sp2xtp2``: ``{"sp": 2, "tp": 2}`` at 16,384
tokens, one row) the step is ``make_sharded_train_step`` at
``transformer_big`` with remat, kernel cross-entropy and a bf16 first
moment, attention the ring over ``sp`` by ``--sp-impl``: each rank holds
8,192 tokens, as a rank of the headline dp step. Besides what the other
meshes report, each rank reports the ring's sends and bytes a step
(``RingExchange``), the all-to-alls' bytes, ``sp_serial_ms`` (the
step's sequence-parallel sends and all-to-alls alone, replayed chained
in the step's order on tensors of their shapes), and its #1-#3
launches a step against the schedule's count
(``sequence_parallel.attention_blocks`` a layer a pass: the forward
twice under remat).

On an expert-parallel mesh (``ep4``: ``{"ep": world}``; ``dp2xep2``;
``ep2xtp2``) the config takes ``--moe-experts`` (required there)
and ``--moe-top-k``, at JAX's default capacity factor 1.25; ``ep``
is no data axis, so ``ep4`` runs one data shard of 8 × 1024 (the dense
part repeats on every rank, as in JAX's layout: a memory row, not a
throughput one). On a fully-sharded mesh (``fsdp4``, ``dp2xfsdp2``,
``fsdp2xtp2``) every d_model dim is cut over ``fsdp``, 8 × 1024 tokens a
data shard. Both report every collective of one step by mesh axis and
kind (all-reduces, all-gathers, reduce-scatters: count and bytes),
replayed alone and chained on tensors of their shapes
(``ep_serial_ms``, ``fsdp_serial_ms``), the MoE count tables'
all-gathers, and the state a rank holds (parameters, gradients, AdamW
moments).

On a pipeline mesh (``pp4``: ``{"pp": world}``; ``dp2xpp2``: ``{"dp":
2, "pp": world / 2}``) the step is ``make_pipelined_train_step`` at
``bench.py``'s ``transformer-pp`` row (``transformer_big``, 1024
tokens, remat, the full-logits head; 8 rows a data shard in
``--microbatches`` 8) with ``--schedule``, ``--interleave``,
``--offload`` (the 1F1B stash spilled to the host) and ``--zero``;
first one rank alone runs the same schedule at pp 1 (the base of the
measured bubble, ``1 − T(pp1) / (pp · T)``), then every rank times the
full step and the step's point-to-point sends and receives alone,
replayed in its schedule's order on tensors of their shape
(``p2p_serial_ms``), and reports the analytic bubble, the P2P counts
and bytes a step, the peak memory and the kernels' launches.

Rank 0 prints one JSON line with ``bench.py``'s fields: ``compute_frac``
(no-sync over full), ``collective_frac`` (exposed over full, exposed =
full − no-sync), ``overlap_eff`` (1 − exposed / serial),
``nosync_step_ms``, ``collective_serial_ms``, ``n_buckets``; and the
step ms, tokens/s, the kernels' launches a step and every rank's times,
with the card's name and power limit. ``--out`` writes the same line to
a file. ``--tiny`` swaps in ``TransformerConfig.tiny()`` (for a CPU
rehearsal; its numbers are no device's). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: rows a rank, as bench.py's scaling rows (transformer, resnet) and
#: run_bert; DLRM's batch a data shard
BATCH = {"transformer": 8, "bert": 32, "resnet": 128, "wide_deep": 4096}
TINY_BATCH = {"resnet": 8, "wide_deep": 64}


def _config(workload: str, tiny: bool):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    if tiny:
        return TransformerConfig.tiny(causal=workload == "transformer",
                                      max_seq_len=64, remat=False)
    if workload == "bert":
        return TransformerConfig.bert_base(remat=False, scan_layers=False)
    return TransformerConfig.transformer_big(
        max_seq_len=1024, remat=False, scan_layers=False,
        loss_impl="kernel", adam_mu_dtype=torch.bfloat16)


def _timer(device):
    import time
    import torch
    if device.type == "cuda":
        def timed(fn, iters):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                fn()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3 / iters
    else:
        def timed(fn, iters):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters
    return timed


def _best(timed, fn, iters, reps):
    fn()                                         # warm-up
    return min(timed(fn, iters) for _ in range(reps))


def _launches() -> dict:
    from distributed_tensorflow_tpu_torch.ops import attention, fused_ce
    return {"flash_fwd_tc": attention.flash_attention_fwd.launches_tc,
            "flash_bwd_dq_tc": attention.flash_attention_bwd.launches_dq_tc,
            "flash_bwd_dkv_tc":
                attention.flash_attention_bwd.launches_dkv_tc,
            "fused_ce_fwd_tc": fused_ce.fused_ce_fwd.launches_tc,
            "fused_ce_bwd_tc": fused_ce.fused_ce_bwd.launches_tc}


def _tp_serial(mesh, cfg, rows, device, timed, args) -> dict:
    """The train step's tp collectives alone, on tensors of their shapes,
    chained (one after another on the tp group): per layer 4 all-reduces
    of the ``(rows, S, D)`` activation in the compute dtype (two forward,
    two backward), one for the embedding lookup, and per 4096-row chunk
    of the CE one f32 dh all-reduce and two all-gathers of ``N`` f32."""
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    group = mesh.get_group("tp")
    n = dist.get_world_size(group)
    seq = cfg.max_seq_len // topology.sp_size(mesh)   # this rank's chunk
    tokens = rows * seq
    act = torch.zeros((rows, seq, cfg.d_model), dtype=cfg.dtype,
                      device=device)
    chunk = 4096 if tokens > 4096 and tokens % 4096 == 0 else tokens
    dh = torch.zeros((chunk, cfg.d_model), dtype=torch.float32,
                     device=device)
    row = torch.zeros(chunk, dtype=torch.float32, device=device)
    gathered = torch.zeros(chunk * n, dtype=torch.float32, device=device)
    n_act = 4 * cfg.n_layers + 1
    n_chunks = tokens // chunk if cfg.loss_impl == "kernel" else 0

    def chain():
        for _ in range(n_act):
            dist.all_reduce(act, group=group)
        for _ in range(n_chunks):
            dist.all_reduce(dh, group=group)
            dist.all_gather_into_tensor(gathered, row, group=group)
            dist.all_gather_into_tensor(gathered, row, group=group)
    return {"tp": n, "tp_serial_ms": _best(timed, chain, args.iters,
                                            args.reps) * 1e3,
            "tp_collectives_per_step": n_act + 3 * n_chunks,
            "tp_bytes_per_step": (n_act * act.numel() * act.element_size()
                                  + n_chunks * (dh.numel() * 4
                                                + 2 * row.numel() * 4))}


#: sequence-parallel meshes: name → (axes, sequence length) at four
#: ranks; one row a data shard, 8,192 tokens a rank
SP_MESHES = {"sp4": ({"sp": 4}, 32768), "dp2xsp2": ({"dp": 2, "sp": 2},
                                                     16384),
             "sp2xtp2": ({"sp": 2, "tp": 2}, 16384)}


def _sp_config(args):
    import torch
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    seq = SP_MESHES[args.mesh][1]
    if args.tiny:
        # the flash ring through the plain versions on the CPU
        return TransformerConfig.tiny(
            max_seq_len=seq // 512, sp_impl=args.sp_impl,
            sp_attn_impl="interpret" if args.device == "cpu" else None)
    return TransformerConfig.transformer_big(
        max_seq_len=seq, loss_impl="kernel", adam_mu_dtype=torch.bfloat16,
        sp_impl=args.sp_impl)


class _SpRecorder:
    """The sequence-parallel sends of one step, as issued: each
    ``batch_isend_irecv`` (its ops' kinds, shapes, dtypes, peers and
    tags) and each ``all_to_all_single`` (shapes, dtype, splits,
    group), recorded while :meth:`recording` is on; :meth:`chain` replays
    them in order on zero tensors of their shapes."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.calls: list = []

    def recording(self):
        import contextlib
        dist = self.dist
        real_p2p, real_a2a = dist.batch_isend_irecv, dist.all_to_all_single

        def p2p(ops):
            self.calls.append(("p2p", [(o.op, tuple(o.tensor.shape),
                                        o.tensor.dtype, o.peer, o.tag)
                                       for o in ops]))
            return real_p2p(ops)

        def a2a(out, inp, out_splits=None, in_splits=None, group=None,
                **kw):
            self.calls.append(("a2a", (tuple(out.shape), tuple(inp.shape),
                                       inp.dtype, out_splits, in_splits,
                                       group)))
            return real_a2a(out, inp, out_splits, in_splits, group=group,
                            **kw)

        @contextlib.contextmanager
        def ctx():
            dist.batch_isend_irecv, dist.all_to_all_single = p2p, a2a
            try:
                yield self
            finally:
                dist.batch_isend_irecv = real_p2p
                dist.all_to_all_single = real_a2a
        return ctx()

    def bytes(self) -> dict:
        import torch
        out = {"p2p_sends": 0, "p2p_bytes": 0, "a2a_calls": 0,
               "a2a_bytes": 0}
        for kind, rec in self.calls:
            if kind == "p2p":
                for op, shape, dtype, _, _ in rec:
                    if op is self.dist.isend:
                        out["p2p_sends"] += 1
                        out["p2p_bytes"] += (torch.Size(shape).numel()
                                             * dtype.itemsize)
            else:
                out["a2a_calls"] += 1
                out["a2a_bytes"] += (torch.Size(rec[1]).numel()
                                     * rec[2].itemsize)
        return out

    def chain(self, device):
        import torch
        dist = self.dist
        calls = []
        for kind, rec in self.calls:
            if kind == "p2p":
                calls.append(("p2p", [
                    dist.P2POp(op, torch.zeros(shape, dtype=dtype,
                                               device=device), peer, tag=tag)
                    for op, shape, dtype, peer, tag in rec]))
            else:
                oshape, ishape, dtype, osp, isp, group = rec
                calls.append(("a2a", (
                    torch.empty(oshape, dtype=dtype, device=device),
                    torch.zeros(ishape, dtype=dtype, device=device), osp,
                    isp, group)))

        def run():
            for kind, rec in calls:
                if kind == "p2p":
                    for w in dist.batch_isend_irecv(rec):
                        w.wait()
                else:
                    out, inp, osp, isp, group = rec
                    dist.all_to_all_single(out, inp, osp, isp, group=group)
        return run


def _sp_report(args, cfg, mesh, full, timed, device, sends, n_steps
               ) -> dict:
    """A sequence-parallel rank's extras: its #1-#3 launches a step by
    the schedule's rule, the ring's sends and bytes a step, the step's
    sends and all-to-alls recorded over one more step and replayed
    alone (``sp_serial_ms``)."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        RingExchange)
    from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
        attention_blocks)
    n, me = topology.sp_size(mesh), topology.sp_index(mesh)
    blocks = attention_blocks(cfg.sp_impl, n, me, cfg.causal) * cfg.n_layers
    out = {"sp": n, "sp_index": me, "sp_impl": cfg.sp_impl,
           "ring_sends_per_step": (RingExchange.sends - sends[0]) / n_steps,
           "ring_bytes_per_step": (RingExchange.bytes - sends[1]) / n_steps}
    rec = _SpRecorder()
    with rec.recording():
        full()
    return {**out, "sp_recorded_per_step": rec.bytes(),
            "expected_launches_per_step": {
                "flash_fwd_tc": blocks * (1 + cfg.remat),
                "flash_bwd_dq_tc": blocks, "flash_bwd_dkv_tc": blocks},
            "sp_serial_ms": _best(timed, rec.chain(device), args.iters,
                                  args.reps) * 1e3}


#: expert-parallel and fully-sharded meshes at four ranks
SHARD_MESHES = {"ep4": {"ep": 4}, "dp2xep2": {"dp": 2, "ep": 2},
                "ep2xtp2": {"ep": 2, "tp": 2}, "fsdp4": {"fsdp": 4},
                "dp2xfsdp2": {"dp": 2, "fsdp": 2},
                "fsdp2xtp2": {"fsdp": 2, "tp": 2}}


class _CollectiveRecorder:
    """Every all-reduce, all-gather and reduce-scatter one step issues on
    a mesh dim's group, recorded while :meth:`recording` is on (kind,
    shapes, dtype, axis); :meth:`chain` replays an axis' calls in order
    on zero tensors of their shapes."""

    KINDS = {"all_reduce": 1, "all_gather_into_tensor": 2,
             "reduce_scatter_tensor": 2}

    def __init__(self, mesh):
        import torch.distributed as dist
        self.dist = dist
        self.groups = {mesh.get_group(a): a for a in mesh.mesh_dim_names}
        # a reduction over every dim of a mesh of several runs on the
        # world (a one-dim mesh's dim group is the world itself)
        self.groups.setdefault(dist.group.WORLD, "world")
        self.calls: list = []

    def recording(self):
        import contextlib
        dist = self.dist
        real = {k: getattr(dist, k) for k in self.KINDS}

        def wrap(kind):
            def call(*args, group=None, **kw):
                axis = self.groups.get(group)
                if axis is not None:
                    self.calls.append((kind, axis, [
                        (tuple(a.shape), a.dtype)
                        for a in args[:self.KINDS[kind]]]))
                return real[kind](*args, group=group, **kw)
            return call

        @contextlib.contextmanager
        def ctx():
            for k in self.KINDS:
                setattr(dist, k, wrap(k))
            try:
                yield self
            finally:
                for k, f in real.items():
                    setattr(dist, k, f)
        return ctx()

    def summary(self) -> dict:
        """``{"axis/kind": {"calls", "bytes"}}``, the bytes of the whole
        tensor (a gather's output, a reduce-scatter's input)."""
        import math
        out: dict = {}
        for kind, axis, tensors in self.calls:
            row = out.setdefault(f"{axis}/{kind}", {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] += max(math.prod(shape) * dtype.itemsize
                                for shape, dtype in tensors)
        return out

    def chain(self, axes, device, mesh, kinds=KINDS):
        import torch
        dist = self.dist
        calls = [(kind, (dist.group.WORLD if axis == "world"
                         else mesh.get_group(axis)),
                  [torch.zeros(shape, dtype=dtype, device=device)
                   for shape, dtype in tensors])
                 for kind, axis, tensors in self.calls
                 if axis in axes and kind in kinds]

        def run():
            for kind, group, tensors in calls:
                getattr(dist, kind)(*tensors, group=group)
        return run, len(calls)


def _shard_report(args, mesh, full, box, timed, device) -> dict:
    """An ep or fsdp rank's extras: the state it holds, one step's
    collectives by axis and kind, the MoE count gathers a step, and the
    ep and fsdp collectives replayed alone (``ep_serial_ms``,
    ``fsdp_serial_ms``)."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import moe
    from distributed_tensorflow_tpu_torch.parallel.zero import (
        held_state_bytes)
    out = held_state_bytes(box["state"]["model"],
                           box["state"]["optimizer"])
    rec = _CollectiveRecorder(mesh)
    stats = dict(moe.STATS)
    with rec.recording():
        full()
    out["collectives_per_step"] = rec.summary()
    out["moe_count_gathers_per_step"] = (moe.STATS["count_gathers"]
                                         - stats["count_gathers"])
    out["moe_count_gather_bytes_per_step"] = (
        moe.STATS["count_gather_bytes"] - stats["count_gather_bytes"])
    for axis in ("ep", "fsdp"):
        if axis in mesh.mesh_dim_names:
            run, n = rec.chain((axis,), device, mesh)
            out[f"{axis}_collectives_per_step"] = n
            out[f"{axis}_serial_ms"] = _best(timed, run, args.iters,
                                             args.reps) * 1e3
    # the step's post-backward gradient reduction: its all-reduces over
    # the data axes (on fsdp the cut leaves' reduce-scatters are above)
    run, n = rec.chain(topology.data_axes(mesh) + ("world",), device, mesh,
                       ("all_reduce",))
    out["data_sync_serial_ms"] = (_best(timed, run, args.iters, args.reps)
                                  * 1e3 if n else 0.0)
    return out


def _pp_config(tiny: bool):
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    if tiny:
        return TransformerConfig.tiny(n_layers=12, max_seq_len=64)
    return TransformerConfig.transformer_big(max_seq_len=1024)


def _p2p_chain(links, schedule: str, n_micro: int, v: int, shape, dtype,
               device):
    """The step's sends and receives alone, in the order
    ``run_schedule`` issues them, on tensors of their shape."""
    import torch
    from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
    W = links.size
    mine = pl.rank_units(W, links.index, n_micro, schedule, v)
    last = W * v - 1
    buf = torch.zeros(shape, dtype=dtype, device=device)

    def chain():
        for e in mine:
            s = e["stage"]
            if e["lane"] == "bwd":
                if s < last:
                    links.recv(shape, dtype, device, (s + 1) % W, pl.BWD)
                if s > 0:
                    links.send(buf, (s - 1) % W, pl.BWD)
                continue
            if s > 0:
                links.recv(shape, dtype, device, (s - 1) % W, pl.FWD)
            if s < last:
                links.send(buf, (s + 1) % W, pl.FWD)
        links.finish()
    return chain


def _pp_rank(args, axes: dict) -> dict:
    """One rank of a pipelined run on ``axes``: the full step, then (on
    more than one stage) its P2P alone."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import transformer as tf
    from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
    rt = bootstrap.initialize(device=args.device)
    rank, device = dist.get_rank(), rt.device
    axes = {k: (dist.get_world_size() // 2 if v == -1 else v)
            for k, v in axes.items()}
    mesh = topology.make_mesh(axes, device=args.device)
    cfg = _pp_config(args.tiny)
    n_dp, pp = axes.get("dp", 1), axes.get("pp", 1)
    gb = BATCH["transformer"] * n_dp
    v = args.interleave if args.schedule == "interleaved" else 1
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (gb, cfg.max_seq_len))).to(device)
    timed = _timer(device)
    kw = {"offload_activations": True} if args.offload else {}
    state, step = tf.make_pipelined_train_step(
        cfg, mesh, gb, args.microbatches, schedule=args.schedule,
        interleave=v, zero=args.zero, **kw)
    if device.type == "cuda":
        # the steps' peak, not the build's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    box = {"state": state}

    def full():
        box["state"], m = step(box["state"], {"tokens": tokens})
        box["loss"] = m["loss"]
    full()
    before = _launches()
    dt_full = _best(timed, full, args.iters, args.reps)
    after = _launches()
    n_steps = 1 + args.iters * args.reps
    out = {"rank": rank, "mesh_shape": axes, "schedule": args.schedule,
           "interleave": v, "offload": bool(args.offload),
           "device": (torch.cuda.get_device_name()
                      if device.type == "cuda" else "cpu"),
           "step_ms": dt_full * 1e3,
           "tokens_per_s": gb * cfg.max_seq_len / dt_full,
           "bubble_analytic": pl.bubble_fraction(
               pp, args.microbatches, args.schedule, interleave=v),
           "launches_per_step": {k: (after[k] - before[k]) / n_steps
                                 for k in after},
           "loss": float(box["loss"]), "p2p_per_step": step.last_stats[
               "p2p"], "offload_stats": step.last_stats["offload"],
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if device.type == "cuda" else None)}
    del box, state, step
    if pp > 1:
        links = pl.StageLinks(mesh)
        shape = (BATCH["transformer"] // args.microbatches,
                 cfg.max_seq_len, cfg.d_model)
        out["p2p_serial_ms"] = _best(timed, _p2p_chain(
            links, args.schedule, args.microbatches, v, shape, cfg.dtype,
            device), args.iters, args.reps) * 1e3
    bootstrap.shutdown()
    return out


def _pp_main(args, world: int) -> dict:
    """The pp-1 base on one rank, then the run on ``world`` ranks; rank
    0's line with the measured bubble and every rank's times."""
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    axes = ({"pp": world} if args.mesh == "pp4"
            else {"dp": 2, "pp": -1})
    base = multi_process_runner.run(_pp_rank, 1, args=(args, {"pp": 1}),
                                    device=args.device,
                                    timeout=1800).return_values[0]
    ranks = multi_process_runner.run(_pp_rank, world, args=(args, axes),
                                     device=args.device,
                                     timeout=1800).return_values
    r0 = ranks[0]
    pp = r0["mesh_shape"]["pp"]
    return {**{k: v for k, v in r0.items() if k != "rank"},
            "pp1_step_ms": base["step_ms"],
            "bubble_measured": 1 - base["step_ms"] / (pp * r0["step_ms"]),
            "ranks": [{k: r.get(k) for k in ("rank", "step_ms",
                                             "p2p_serial_ms", "loss",
                                             "p2p_per_step",
                                             "peak_mem_bytes")}
                      for r in ranks]}


def _rank(args) -> dict:
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import bert as tbert
    from distributed_tensorflow_tpu_torch.models import transformer as tf
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, RingExchange)
    rt = bootstrap.initialize(device=args.device)
    world, rank, device = dist.get_world_size(), dist.get_rank(), rt.device
    if args.mesh == "dcn2xdp2":
        mesh = topology.make_hybrid_mesh({"dcn": 2}, {"dp": -1},
                                         device=args.device)
    elif args.mesh == "tp4":
        mesh = topology.make_mesh({"tp": world}, device=args.device)
    elif args.mesh == "dp2xtp2":
        mesh = topology.make_mesh({"dp": 2, "tp": -1}, device=args.device)
    elif args.mesh in SP_MESHES:
        mesh = topology.make_mesh(SP_MESHES[args.mesh][0],
                                  device=args.device)
    elif args.mesh in SHARD_MESHES:
        mesh = topology.make_mesh(SHARD_MESHES[args.mesh],
                                  device=args.device)
    else:
        mesh = topology.make_mesh({"dp": world}, device=args.device)
    tp = topology.tp_size(mesh)
    sp = args.mesh in SP_MESHES
    cfg = _sp_config(args) if sp else _config(args.workload, args.tiny)
    if args.moe_experts:
        cfg = dataclasses.replace(
            cfg, moe_experts=args.moe_experts, moe_top_k=args.moe_top_k)
    rows = 1 if sp else BATCH[args.workload]
    n_data = topology.mesh_axis_size(mesh, *topology.data_axes(mesh))
    gb = rows * n_data
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (gb, cfg.max_seq_len))).to(device)
    batch = {"tokens": tokens}
    timed = _timer(device)
    out = {"rank": rank, "device": (torch.cuda.get_device_name()
                                    if device.type == "cuda" else "cpu")}

    # the full step
    if args.workload == "bert":
        state, step = tbert.make_sharded_train_step(cfg, mesh, gb)
    else:
        state, step = tf.make_sharded_train_step(
            cfg, mesh, gb, zero=args.zero, grad_sync=args.grad_sync)
    box = {"state": state}

    def full():
        box["state"], m = step(box["state"], batch)
        box["loss"] = m["loss"]
    full()
    if device.type == "cuda":
        # the steps' peak, not the build's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = _launches()
    sends = (RingExchange.sends, RingExchange.bytes)
    dt_full = _best(timed, full, args.iters, args.reps)
    after = _launches()
    n_steps = 1 + args.iters * args.reps
    out["launches_per_step"] = {k: (after[k] - before[k]) / n_steps
                                for k in after}
    out["loss"] = float(box["loss"])
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if sp:
        out.update(_sp_report(args, cfg, mesh, full, timed, device,
                              sends, n_steps))
    if args.mesh in SHARD_MESHES:
        out.update(_shard_report(args, mesh, full, box, timed, device))
    model = box["state"]["model"]
    leaves = tf.jax_leaf_params(cfg, model)
    grads = [torch.cat([p.detach().reshape(-1) for p in ps])
             for ps in leaves]
    del box, state, step, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the same compute without the sync
    if (tp > 1 or "tp" in mesh.mesh_dim_names or sp
            or args.mesh in SHARD_MESHES or cfg.moe_experts):
        nstep = None
        if args.workload == "transformer":
            def no_sync(cfg_, model_, opt_, shard):
                return tf._lm_step_factory(cfg_, model_, opt_, tf.DataShard(
                    shard.rows, shard.n_shards, None, shard.sp))
            nstate, nstep = tf._make_post_sync_train_step(
                cfg, mesh, gb, 0, no_sync, None)
            local = batch
    elif args.workload == "transformer" and world > 1 and \
            args.mesh in ("dp", "dcn2xdp2"):
        nstate, nstep = tf.make_sharded_train_step(cfg, mesh, gb,
                                                   grad_sync="none")
        local = batch
    else:
        model = tf.TransformerLM(cfg, device=device,
                                 generator=torch.Generator(
                                     device=device).manual_seed(0))
        opt = tf.make_optimizer(cfg, model.parameters())
        nstep = (tbert.make_train_step(cfg, model, opt)
                 if args.workload == "bert"
                 else tf.make_train_step(cfg, model, opt))
        nstate = {"model": model, "optimizer": opt, "step": 0}
        local = {"tokens": tokens[rank * rows:(rank + 1) * rows]}
    dt_nosync = None
    if nstep is not None:
        nbox = {"state": nstate}

        def nosync():
            nbox["state"], _ = nstep(nbox["state"], local)
        dt_nosync = _best(timed, nosync, args.iters, args.reps)
        del nbox, nstate, nstep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the bucketed all-reduce alone, chained on a gradient-shaped list
    axes = topology.data_axes(mesh)
    dt_coll, plan = 0.0, []
    if args.mesh in SHARD_MESHES:
        # the step's own data-axis all-reduces (fsdp-cut leaves take
        # none), replayed by _shard_report
        dt_coll = out["data_sync_serial_ms"] / 1e3
    elif axes:
        outer, inner = tf._hybrid_axes(mesh, axes)
        bucketer = GradientBucketer(mesh, axes, outer_axis=outer,
                                    inner_axis=inner)
        gbox = {"g": grads}

        def collective():
            gbox["g"] = bucketer.all_reduce(gbox["g"], ReduceOp.MEAN)
        dt_coll = _best(timed, collective, args.iters, args.reps)
        plan = bucketer.plan_summary(grads)
    if "tp" in mesh.mesh_dim_names:
        out.update(_tp_serial(mesh, cfg, rows, device, timed, args))
    bootstrap.shutdown()

    if dt_nosync is None:
        dt_nosync = dt_full
        out["nosync_note"] = "no step without the data sync was timed"
    exposed = max(0.0, dt_full - dt_nosync)
    eff = (None if dt_coll <= 0 else
           max(0.0, min(1.0, 1.0 - exposed / dt_coll)))
    out.update({
        "step_ms": dt_full * 1e3,
        "tokens_per_s": gb * cfg.max_seq_len / dt_full,
        "mesh_shape": topology.mesh_shape(mesh),
        "compute_frac": min(1.0, dt_nosync / dt_full),
        "collective_frac": exposed / dt_full,
        "infeed_wait_frac": 0.0,
        "overlap_eff": eff,
        "nosync_step_ms": dt_nosync * 1e3,
        "exposed_collective_ms": exposed * 1e3,
        "collective_serial_ms": dt_coll * 1e3,
        "n_buckets": len(plan),
        "bucket_bytes": sum(b["bytes"] for b in plan)})
    return out


def _other_rank(args) -> dict:
    """One rank of ``--workload resnet`` or ``wide_deep``."""
    import gc
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.models import resnet, wide_deep
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp)
    rt = bootstrap.initialize(device=args.device)
    world, rank, device = dist.get_world_size(), dist.get_rank(), rt.device
    axes = {"tp4": {"tp": world}, "dp2xtp2": {"dp": 2, "tp": -1}}.get(
        args.mesh, {"dp": world})
    mesh = topology.make_mesh(axes, device=args.device)
    n_data = topology.mesh_axis_size(mesh, *topology.data_axes(mesh))
    rows = (TINY_BATCH if args.tiny else BATCH)[args.workload]
    gb = rows * n_data
    mine = slice(topology.data_shard_index(mesh) * rows,
                 (topology.data_shard_index(mesh) + 1) * rows)
    timed = _timer(device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    if args.workload == "resnet":
        cfg = (resnet.ResNetConfig.tiny() if args.tiny
               else resnet.ResNetConfig.resnet50())
        size = 32 if args.tiny else 224
        data = resnet.synthetic_images(gb, size, cfg.num_classes, seed=0)
        state, step = resnet.make_sharded_train_step(cfg, mesh, gb, size)
    else:
        cfg = (wide_deep.WideDeepConfig.tiny() if args.tiny
               else wide_deep.WideDeepConfig.dlrm_like())
        data = wide_deep.synthetic_clicks(cfg, gb, seed=0)
        state, step = wide_deep.make_sharded_train_step(cfg, mesh, gb)
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    box = {"state": state}

    def full():
        box["state"], m = step(box["state"], batch)
        box["loss"] = m["loss"]
    full()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = _launches()
    dt_full = _best(timed, full, args.iters, args.reps)
    after = _launches()
    out = {"rank": rank, "device": (torch.cuda.get_device_name()
                                    if device.type == "cuda" else "cpu"),
           "loss": float(box["loss"]),
           "launches": {k: after[k] - before[k] for k in after}}
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    model = box["state"]["model"]
    grads = [p.detach().reshape(-1).clone() for p in model.parameters()]
    del box, state, step, model
    gc.collect()
    if args.workload == "wide_deep":
        estate, estep = wide_deep.make_embedding_train_step(cfg, mesh, gb)
        ebox = {"state": estate}

        def emb():
            ebox["state"], _ = estep(ebox["state"], batch)
        out["emb_step_ms"] = _best(timed, emb, args.iters, args.reps) * 1e3
        del ebox, estate, estep
        gc.collect()
    dt_nosync = None
    if args.workload == "resnet":
        model = resnet.ResNet(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
        opt = resnet.make_optimizer(cfg, model.parameters())
        nstep = resnet.make_train_step(cfg, model, opt)
    elif "tp" not in axes:
        model = wide_deep.WideDeep(cfg, device=device,
                                   generator=torch.Generator(
                                       device=device).manual_seed(0))
        opt = wide_deep.make_optimizer(cfg, model.parameters())
        nstep = wide_deep.make_train_step(cfg, model, opt)
    else:
        nstep = None
    if nstep is not None:
        local = {k: v[mine] for k, v in batch.items()}
        nbox = {"state": {"model": model, "optimizer": opt, "step": 0}}

        def nosync():
            nbox["state"], _ = nstep(nbox["state"], local)
        dt_nosync = _best(timed, nosync, args.iters, args.reps)
        del nbox, model, opt, nstep
    data_axes = topology.data_axes(mesh)
    dt_coll = 0.0
    if data_axes:
        bucketer = GradientBucketer(mesh, data_axes)
        gbox = {"g": grads}

        def collective():
            gbox["g"] = bucketer.all_reduce(gbox["g"], ReduceOp.MEAN)
        dt_coll = _best(timed, collective, args.iters, args.reps)
    bootstrap.shutdown()
    if dt_nosync is None:
        dt_nosync = dt_full
        out["nosync_note"] = "no step without the data sync was timed"
    exposed = max(0.0, dt_full - dt_nosync)
    unit = "images_per_s" if args.workload == "resnet" else "examples_per_s"
    out.update({
        "step_ms": dt_full * 1e3, unit: gb / dt_full,
        "mesh_shape": topology.mesh_shape(mesh),
        "compute_frac": min(1.0, dt_nosync / dt_full),
        "collective_frac": exposed / dt_full,
        "overlap_eff": (None if dt_coll <= 0 else
                        max(0.0, min(1.0, 1.0 - exposed / dt_coll))),
        "nosync_step_ms": dt_nosync * 1e3,
        "exposed_collective_ms": exposed * 1e3,
        "collective_serial_ms": dt_coll * 1e3})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every visible card)")
    ap.add_argument("--mesh", choices=("dp", "dcn2xdp2", "tp4", "dp2xtp2",
                                       "pp4", "dp2xpp2", *SP_MESHES,
                                       *SHARD_MESHES),
                    default="dp")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="mixture-of-experts layers (required on the ep "
                         "meshes)")
    ap.add_argument("--moe-top-k", type=int, default=1)
    ap.add_argument("--sp-impl", choices=("ring", "striped", "ulysses"),
                    default="ring", help="sequence-parallel meshes")
    ap.add_argument("--schedule", choices=("gpipe", "1f1b", "interleaved"),
                    default="1f1b", help="pipeline meshes")
    ap.add_argument("--interleave", type=int, default=2)
    ap.add_argument("--offload", action="store_true",
                    help="1F1B's stash spilled to the host")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--zero", type=int, choices=(0, 1, 2), default=0)
    ap.add_argument("--grad-sync", default="auto",
                    choices=("auto", "none", "gspmd", "bucketed"))
    ap.add_argument("--workload", choices=("transformer", "bert", "resnet",
                                           "wide_deep"),
                    default="transformer")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.mesh in SP_MESHES and args.workload != "transformer":
        ap.error("the sequence-parallel meshes run --workload transformer")
    other = args.workload in ("resnet", "wide_deep")
    if other and args.mesh not in (("dp",) if args.workload == "resnet"
                                   else ("dp", "tp4", "dp2xtp2")):
        ap.error(f"--workload {args.workload} runs --mesh dp"
                 + (", tp4 or dp2xtp2" if args.workload == "wide_deep"
                    else ""))
    if args.mesh.startswith(("ep", "dp2xep")) and not args.moe_experts:
        ap.error(f"--mesh {args.mesh} needs --moe-experts")

    import torch
    from distributed_tensorflow_tpu_torch.testing import multi_process_runner
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_dp_run: no CUDA device", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    pipelined = args.mesh in ("pp4", "dp2xpp2")
    if not pipelined:
        ranks = multi_process_runner.run(_other_rank if other else _rank,
                                         world, args=(args,),
                                         device=args.device,
                                         timeout=1800).return_values
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    if pipelined:
        line = {"workload": "transformer-pp", "world": world,
                "mesh": args.mesh, "zero": args.zero, "device": args.device,
                "tiny": args.tiny, "microbatches": args.microbatches,
                "rows_per_data_shard": BATCH["transformer"],
                "iters": args.iters, "reps": args.reps, "nvidia_smi": smi,
                **_pp_main(args, world)}
        return _print(line, args.out)
    r0 = ranks[0]
    if other:
        line = {"workload": args.workload, "world": world,
                "mesh": args.mesh, "device": args.device, "tiny": args.tiny,
                "rows_per_data_shard": (TINY_BATCH if args.tiny
                                        else BATCH)[args.workload],
                "iters": args.iters, "reps": args.reps, "nvidia_smi": smi,
                **{k: v for k, v in r0.items() if k != "rank"},
                "ranks": [{k: r.get(k) for k in (
                    "rank", "step_ms", "emb_step_ms", "nosync_step_ms",
                    "collective_serial_ms", "loss", "launches",
                    "peak_mem_bytes")} for r in ranks]}
        return _print(line, args.out)
    line = {"workload": args.workload, "world": world, "mesh": args.mesh,
            "zero": args.zero, "grad_sync": args.grad_sync,
            "moe_experts": args.moe_experts, "moe_top_k": args.moe_top_k,
            "device": args.device, "tiny": args.tiny,
            "rows_per_data_shard": (1 if args.mesh in SP_MESHES
                                    else BATCH[args.workload]),
            "iters": args.iters, "reps": args.reps, "nvidia_smi": smi,
            **{k: v for k, v in r0.items() if k != "rank"},
            "ranks": [{k: r.get(k) for k in (
                "rank", "step_ms", "nosync_step_ms", "collective_serial_ms",
                "loss", "sp_index", "sp_serial_ms", "ring_sends_per_step",
                "ring_bytes_per_step", "launches_per_step",
                "expected_launches_per_step", "peak_mem_bytes",
                "state_bytes", "ep_serial_ms", "fsdp_serial_ms")}
                      for r in ranks]}
    return _print(line, args.out)


def _print(line: dict, path) -> int:
    text = json.dumps(line)
    print(text, flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

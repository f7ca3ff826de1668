"""Rank functions for the port's tensor-parallel tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Every function initialises the process group, runs a
batch of cases (one interpreter start costs seconds) and returns numpy
arrays, which the test files hold against the JAX package or against
the single-rank computation.
"""

import dataclasses

import numpy as np
import torch

from torch_dp_ranks import _init, _params_from_np


def _flat_full(params) -> dict:
    """A full parameter dict as ``"group/name"`` numpy arrays."""
    out = {"embed": params["embed"],
           "final_norm/scale": params["final_norm"]["scale"]}
    for g, leaves in params["layers"].items():
        for n, t in leaves.items():
            out[f"layers/{g}/{n}"] = t
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _run(step, state, tokens, steps):
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return state, losses


def train_rank(cases: list, tokens: np.ndarray, steps: int,
               refusals: list) -> dict:
    """``cases``: ``(name, axes, config kwargs, step kwargs, init)``,
    each run ``steps`` steps from the full parameters ``init`` on
    ``tokens``; returns every case's losses, gathered parameters and
    the local shapes, and each refusal's exception (type, message) or
    None."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, gather_params, make_sharded_train_step)
    _init()
    tok = torch.from_numpy(tokens)
    out = {"rank": dist.get_rank()}
    meshes = {}
    for name, axes, cfg_kw, kw, init in cases:
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = topology.make_mesh(axes, device="cpu")
        mesh = meshes[key]
        cfg = TransformerConfig.tiny(**cfg_kw)
        state, step = make_sharded_train_step(
            cfg, mesh, tokens.shape[0], params=_params_from_np(cfg, init),
            **kw)
        state, losses = _run(step, state, tok, steps)
        model = state["model"]
        out[name] = {
            "losses": losses,
            "params": _flat_full(gather_params(cfg, model.stacked_params(),
                                               mesh)),
            "local_shapes": {k: tuple(v.shape) for k, v in _flat_full(
                model.stacked_params()).items()},
            "summary": (step.partition.summary()
                        if hasattr(step, "partition") else None)}
    out["refusals"] = []
    for axes, cfg_kw, kw in refusals:
        try:
            make_sharded_train_step(TransformerConfig.tiny(**cfg_kw),
                                    topology.make_mesh(axes, device="cpu"),
                                    tokens.shape[0], **kw)
            out["refusals"].append(None)
        except (ValueError, NotImplementedError) as e:
            out["refusals"].append((type(e).__name__, str(e)))
    return out


def bert_rank(axes: dict, cases: list, init: dict, tokens: np.ndarray,
              masks: list, steps: int) -> dict:
    """Sharded BERT MLM on ``axes`` for each ``(name, config kwargs)``,
    JAX's masks fed through ``masking=``."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.models.transformer import (
        gather_params)
    _init()
    mesh = topology.make_mesh(axes, device="cpu")

    def masking(step, _tokens):
        inputs, labels = masks[step]
        return torch.from_numpy(inputs), torch.from_numpy(labels)

    out = {}
    for name, cfg_kw in cases:
        cfg = bert.tiny_bert_config(**cfg_kw)
        state, step = bert.make_sharded_train_step(
            cfg, mesh, tokens.shape[0], params=_params_from_np(cfg, init),
            masking=masking)
        state, losses = _run(step, state, torch.from_numpy(tokens), steps)
        out[name] = {"losses": losses, "params": _flat_full(gather_params(
            cfg, state["model"].stacked_params(), mesh))}
    return out


def ops_rank(case: dict) -> dict:
    """The tp boundaries, the vocab-parallel embedding and CE and the
    vocab-sharded fused CE on this world's ``case["axes"]`` mesh: each
    value and gradient (summed over the data shards where a rank saw
    only its rows), and the full-parameter round trip."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, gather_params, init_params, shard_params)
    from distributed_tensorflow_tpu_torch.ops.fused_ce import (
        sharded_fused_cross_entropy)
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
        TensorParallel, vocab_parallel_cross_entropy, vocab_parallel_embed)
    _init()
    mesh = topology.make_mesh(case["axes"], device="cpu")
    tp = TensorParallel.from_mesh(mesh)
    r = tp.rank
    out = {"rank": dist.get_rank(), "tp_rank": r, "tp": tp.size,
           "dp_index": topology.data_shard_index(mesh)}

    # the boundaries: y = reduce(copy(x) @ W_r), a column-parallel then
    # row-parallel product, against x @ W on one rank
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    w1 = torch.from_numpy(case["w1"]).chunk(tp.size, 1)[r].contiguous()
    w2 = torch.from_numpy(case["w2"]).chunk(tp.size, 0)[r].contiguous()
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    y = C.tp_reduce(torch.tanh(C.tp_copy(x, tp.group) @ w1) @ w2, tp.group)
    (y * torch.from_numpy(case["gy"])).sum().backward()
    out["mlp"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                  "dw1": w1.grad.numpy(), "dw2": w2.grad.numpy()}

    # the vocab-parallel embedding
    emb_full = torch.from_numpy(case["embed"])
    rows = emb_full.shape[0] // tp.size
    emb = emb_full[r * rows:(r + 1) * rows].clone().requires_grad_(True)
    ids = torch.from_numpy(case["ids"])
    e = vocab_parallel_embed(emb, ids, tp)
    (e * torch.from_numpy(case["ge"])).sum().backward()
    out["embed"] = {"y": e.detach().numpy(), "de": emb.grad.numpy()}

    # the vocab-parallel CE of full logits: x_r over this rank's vocab
    h = torch.from_numpy(case["h"]).requires_grad_(True)
    emb = emb_full[r * rows:(r + 1) * rows].clone().requires_grad_(True)
    logits = C.tp_copy(h, tp.group) @ emb.T
    losses = vocab_parallel_cross_entropy(logits, ids, tp)
    (losses * torch.from_numpy(case["gl"])).sum().backward()
    out["ce"] = {"losses": losses.detach().numpy(), "dh": h.grad.numpy(),
                 "de": emb.grad.numpy()}

    # the vocab-sharded fused CE on this rank's data shard of tokens
    n_data = topology.mesh_axis_size(mesh, *topology.data_axes(mesh))
    per = case["h"].shape[0] // n_data
    i = out["dp_index"]
    h = torch.from_numpy(case["h"][i * per:(i + 1) * per]).requires_grad_(
        True)
    emb = emb_full[r * rows:(r + 1) * rows].clone().requires_grad_(True)
    fl = {}
    for variant in ("b", "a", "split"):
        h.grad, emb.grad = None, None
        losses = sharded_fused_cross_entropy(
            h, emb, ids[i * per:(i + 1) * per], tp, bwd_variant=variant)
        losses.sum().backward()
        de = emb.grad.clone()
        if n_data > 1:
            de = C.all_reduce(de, mesh, topology.data_axes(mesh))
        fl[variant] = {"losses": losses.detach().numpy(),
                       "dh": h.grad.numpy().copy(), "de": de.numpy()}
    out["fused"] = fl

    # the full parameters to this rank's shards and back
    cfg = TransformerConfig.tiny()
    full = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    shards = shard_params(cfg, full, mesh)
    back = gather_params(cfg, shards, mesh)
    out["round_trip"] = all(
        np.array_equal(a, b) for a, b in zip(_flat_full(full).values(),
                                             _flat_full(back).values()))
    out["wi"] = shards["layers"]["mlp"]["wi"].numpy()
    out["contiguous"] = all(t.is_contiguous() for t in
                            torch.utils._pytree.tree_leaves(shards))
    return out


def serve_rank(axes: dict, params: dict, cases: list,
               cfg_kw: dict | None = None) -> dict:
    """The serving engine on this world's ``axes`` mesh from the full
    parameters ``params`` of ``tiny(max_seq_len=64, **cfg_kw)``: each
    ``(name, kind, prompts, new, kwargs)``
    case's greedy streams (``kind`` "engine", "swap" — the engine after
    ``install_version`` of the same weights — or "disagg", with
    ``wire=True``), and one export's payload against the single-device
    engine's on the same prompt."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_tensorflow_tpu_torch.serving.migrate import (
        DisaggregatedEngine, pack_payload)
    from distributed_tensorflow_tpu_torch.serving.scheduler import Request
    _init()
    mesh = topology.make_mesh(axes, device="cpu")
    cfg = TransformerConfig.tiny(max_seq_len=64, **(cfg_kw or {}))
    full = _params_from_np(cfg, params)
    out = {"rank": dist.get_rank()}
    for name, kind, prompts, new, kw in cases:
        if kind in ("engine", "swap"):
            eng = InferenceEngine(cfg, full, mesh=mesh, **kw)
            if kind == "swap":
                eng.install_version(full, step=1)
        else:
            eng = DisaggregatedEngine(cfg, full, mesh=mesh, wire=True, **kw)
        out[name] = {"streams": eng.generate(prompts, max_new_tokens=new),
                     "accounting": eng.block_accounting()}
        if kind == "disagg":
            out[name]["migrations"] = eng.stats()["migrations"]

    # one export: the tp engine's payload against the single-device one's
    payloads = {}
    for tag, m in (("mesh", mesh), ("single", None)):
        eng = InferenceEngine(cfg, full, mesh=m, num_blocks=16,
                              block_size=8, max_slots=4, max_prompt_len=16,
                              **({} if m is not None else
                                 {"device": "cpu"}))
        eng.submit(Request(id="x", tokens=(3, 14, 15, 92, 65, 35),
                           max_new_tokens=8))
        for _ in range(3):
            eng.step()
        seq = next(iter(eng.scheduler.running.values()))
        payloads[tag] = eng.export_sequence(seq)
    a, b = payloads["mesh"], payloads["single"]
    # the provenance fields differ between any two engines
    same = dataclasses.replace(a, pool_epoch=b.pool_epoch,
                               arrival_wall=b.arrival_wall, ttft_s=b.ttft_s)
    out["payload"] = {
        "fingerprint_equal": a.fingerprint == b.fingerprint,
        "generated_equal": a.generated == b.generated,
        "wire_bytes": (len(pack_payload(same)), len(pack_payload(b))),
        "nbytes": (a.nbytes, b.nbytes),
        "shapes": {n: (tuple(a.arrays[n].shape), tuple(b.arrays[n].shape))
                   for n in b.arrays},
        "dtypes_equal": all(a.arrays[n].dtype == b.arrays[n].dtype
                            for n in b.arrays),
        # the rows written so far (the last one is written by the next
        # decode step)
        "k_err": float((a.arrays["k"][:, :a.length - 1]
                        - b.arrays["k"][:, :b.length - 1]).abs().max()),
        "v_err": float((a.arrays["v"][:, :a.length - 1]
                        - b.arrays["v"][:, :b.length - 1]).abs().max())}
    return out

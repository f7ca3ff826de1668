"""Rank functions for the port's data-parallel tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Every function initialises the process group, runs
its cases and returns numpy arrays, which the test files hold against
the JAX package.
"""

import numpy as np
import torch


def _init(timeout_s: float = 300.0):
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    return bootstrap.initialize(device="cpu", timeout_s=timeout_s)


def _np_params(model) -> dict:
    """The model's parameters as the port's stacked dict of numpy arrays,
    flattened to ``"group/name"`` keys."""
    sp = model.stacked_params()
    out = {"embed": sp["embed"], "final_norm/scale": sp["final_norm"]["scale"]}
    for g, leaves in sp["layers"].items():
        for n, t in leaves.items():
            out[f"layers/{g}/{n}"] = t
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _params_from_np(cfg, flat: dict) -> dict:
    layers: dict = {}
    for k, v in flat.items():
        if k.startswith("layers/"):
            _, g, n = k.split("/")
            layers.setdefault(g, {})[n] = torch.from_numpy(v.copy())
    return {"embed": torch.from_numpy(flat["embed"].copy()),
            "layers": layers,
            "final_norm": {"scale": torch.from_numpy(
                flat["final_norm/scale"].copy())}}


def events_rank(logdir: str) -> dict:
    """Under an initialised group, the env-less default process id is the
    rank: each rank writes ``events-<rank>.jsonl``."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.telemetry import events
    _init()
    log = events.configure(logdir, run_id="dp")
    events.event("rank.hello", rank=dist.get_rank())
    events.shutdown()
    return {"rank": dist.get_rank(), "path": log.path}


def collectives_rank(seed: int) -> dict:
    """Bucketed sums and means at worlds 4 (``dp``) and 2 (the ``dp`` dim
    of a 2×2 mesh), the hierarchical reduction with 1 and 3 chunks, and
    the launch order of the overlapped backward reduction."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM, jax_leaf_params, make_loss_fn)
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    _init()
    rank = dist.get_rank()
    flat4 = topology.make_mesh({"dp": 4}, device="cpu")
    mesh2 = topology.make_hybrid_mesh({"dcn": 2}, {"dp": 2}, device="cpu")
    rng = np.random.default_rng(seed + rank)
    shapes = [(3, 5), (17,), (4, 4, 4), (1,), (33, 2)]
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in shapes]
    out = {"rank": rank, "leaves": [t.numpy() for t in leaves]}
    for world, mesh in (("w4", flat4), ("w2", mesh2)):
        bk = C.GradientBucketer(mesh, "dp", bytes_per_pack=64)
        out[f"{world}_buckets"] = bk.plan(leaves)
        for op in ("sum", "mean"):
            out[f"{world}_{op}"] = [t.numpy() for t in bk.all_reduce(leaves,
                                                                     op)]
    vec = rng.normal(size=1001).astype(np.float32)
    ints = rng.integers(-50, 50, size=1001).astype(np.float32)
    out["vec"], out["ints"] = vec, ints
    for name, x in (("vec", vec), ("ints", ints)):
        t = torch.from_numpy(x)
        out[f"{name}_flat"] = C.all_reduce(t, mesh2, ("dcn", "dp")).numpy()
        for chunks in (1, 3):
            out[f"{name}_hier{chunks}"] = C.hierarchical_all_reduce(
                t, mesh2, "dp", "dcn", chunks=chunks).numpy()
        out[f"{name}_hier_mean"] = C.hierarchical_all_reduce(
            t, mesh2, "dp", "dcn", op="mean").numpy()

    # the overlapped reduction: many buckets, launched in plan order
    cfg = TransformerConfig.tiny(n_layers=3, scan_layers=False)
    gen = torch.Generator().manual_seed(0)
    model = TransformerLM(cfg, device="cpu", generator=gen)
    ref = TransformerLM(cfg, model.stacked_params(), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed + 10 + rank)
                              .integers(0, cfg.vocab_size, (2, 16)))
    leaves_m = jax_leaf_params(cfg, model)
    bk = C.GradientBucketer(flat4, "dp", bytes_per_pack=32 * 1024)
    sync = bk.backward_sync(leaves_m)
    sync.begin()
    make_loss_fn(cfg, model)(tokens).backward()
    out["launched_in_backward"] = list(sync.launched)
    sync.finish()
    out["launched"] = list(sync.launched)
    out["n_buckets"] = len(sync.buckets)
    make_loss_fn(cfg, ref)(tokens).backward()
    ref_leaves = jax_leaf_params(cfg, ref)
    want = bk.all_reduce([torch.cat([p.grad.reshape(-1) for p in ps])
                          for ps in ref_leaves], "mean")
    got = [torch.cat([p.grad.reshape(-1) for p in ps]) for ps in leaves_m]
    out["hooked_grads_equal"] = all(torch.equal(a, b)
                                    for a, b in zip(got, want))

    # a leaf that gets no gradient: its bucket (planned first) is
    # reduced as zeros after the backward, and nothing hangs
    a = torch.full((4,), float(rank + 1), requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    sync = C.GradientBucketer(flat4, "dp", bytes_per_pack=4).backward_sync(
        [[a], [b]], "sum")
    sync.begin()
    (a * a).sum().backward()
    out["unused_launched_in_backward"] = list(sync.launched)
    sync.finish()
    out["unused_grads"] = (a.grad.numpy().copy(), b.grad.numpy().copy())
    return out


def _run_steps(step, state, tokens, n):
    losses = []
    for _ in range(n):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return state, losses


def zero_rank(steps: int) -> dict:
    """Replicated bucketed DP, ZeRO-1 and ZeRO-2 from the same seed, over
    this world's ``("dp",)`` mesh: final parameters, losses, and the
    elements of AdamW's moments each rank holds."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_sharded_train_step)
    _init()
    mesh = topology.make_mesh({"dp": -1}, device="cpu")
    cfg = TransformerConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len)))
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    for name, kw in (("rep", {}), ("zero1", {"zero": 1}),
                     ("zero2", {"zero": 2})):
        state, step = make_sharded_train_step(cfg, mesh, 8, seed=0, **kw)
        state, losses = _run_steps(step, state, tokens, steps)
        opt = state["optimizer"]
        out[name] = {"params": _np_params(state["model"]), "losses": losses,
                     "slot_elements": sum(
                         st[k].numel() for st in opt.state.values()
                         for k in ("mu", "nu")),
                     "n_params": sum(p.numel() for p in
                                     state["model"].parameters())}
        if kw:
            out[name]["summary"] = step.partition.summary()
    return out


def dp_train_rank(params: dict, tokens: np.ndarray, steps: int,
                  refusals: list) -> dict:
    """The slice's parity run at world 4: every sync mode from the same
    parameters, and the refusals (exception type and message)."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_sharded_train_step)
    _init()
    cfg = TransformerConfig.tiny()
    tok = torch.from_numpy(tokens)
    dp = topology.make_mesh({"dp": 4}, device="cpu")
    hybrid = topology.make_hybrid_mesh({"dcn": 2}, {"dp": 2}, device="cpu")
    out = {"rank": dist.get_rank()}
    for name, mesh, kw in (("bucketed", dp, {}), ("zero1", dp, {"zero": 1}),
                           ("zero2", dp, {"zero": 2}),
                           ("hybrid", hybrid, {}),
                           ("gspmd", dp, {"grad_sync": "gspmd"}),
                           ("none", dp, {"grad_sync": "none"})):
        state, step = make_sharded_train_step(
            cfg, mesh, tokens.shape[0], params=_params_from_np(cfg, params),
            **kw)
        state, losses = _run_steps(step, state, tok, steps)
        out[name] = {"losses": losses, "params": _np_params(state["model"])}
    meshes = {"dp": dp, "hybrid": hybrid,
              "dp_tp": topology.make_mesh({"dp": 2, "tp": 2}, device="cpu"),
              "dp_fsdp": topology.make_mesh({"dp": 2, "fsdp": 2},
                                            device="cpu")}
    out["refusals"] = []
    for mesh_name, cfg_kw, kw in refusals:
        kw = {k: (_never_built if v == "dummy" else v) for k, v in kw.items()}
        try:
            make_sharded_train_step(TransformerConfig.tiny(**cfg_kw),
                                    meshes[mesh_name], 8, **kw)
            out["refusals"].append(None)
        except (ValueError, NotImplementedError) as e:
            out["refusals"].append((type(e).__name__, str(e)))
    return out


def _never_built(*args):
    raise AssertionError("a refused step builds no step")


def bert_rank(params: dict, tokens: np.ndarray, steps: int) -> dict:
    """BERT MLM through ``step_factory`` at this world."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.bert import (
        make_sharded_train_step, tiny_bert_config)
    _init()
    cfg = tiny_bert_config()
    mesh = topology.make_mesh({"dp": -1}, device="cpu")
    state, step = make_sharded_train_step(
        cfg, mesh, tokens.shape[0], seed=0, params=_params_from_np(cfg,
                                                                   params))
    state, losses = _run_steps(step, state, torch.from_numpy(tokens), steps)
    return {"losses": losses, "params": _np_params(state["model"])}


def late_group_rank(delay: float) -> dict:
    """Rank 0 finishes first while ranks 2 and 3, ``delay`` seconds
    behind, still build a group of their own through the rendezvous
    store that rank 0 hosts (as a mesh dim rank 0 is no member of)."""
    import time
    import torch.distributed as dist
    _init()
    rank = dist.get_rank()
    dist.new_group([0, 1])
    if rank >= 2:
        time.sleep(delay)
    group = dist.new_group([2, 3])
    out = {"rank": rank}
    if rank >= 2:
        t = torch.ones(1)
        dist.all_reduce(t, group=group)
        out["sum"] = float(t)
    return out


def failing_rank() -> int:
    """Rank 1 raises after the group is up; rank 0 waits on it in a
    collective, which the failed rank's exit ends."""
    import torch.distributed as dist
    _init()
    if dist.get_rank() == 1:
        return 1 // 0
    dist.all_reduce(torch.ones(1))
    return 0

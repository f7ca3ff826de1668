"""Rank functions for the port's pipeline tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Every function initialises the process group, runs its
cases and returns numpy arrays (or exception names and messages), which
the test files hold against the JAX package.
"""

import numpy as np
import torch

from torch_dp_ranks import _init, _params_from_np

#: the pipelined step of the tests: tiny(n_layers=4), 8 rows in 4
#: microbatches
GB, N_MICRO, N_LAYERS = 8, 4, 4


def _flat(full: dict) -> dict:
    out = {"embed": full["embed"].numpy(),
           "final_norm/scale": full["final_norm"]["scale"].numpy()}
    for g, leaves in full["layers"].items():
        for n, t in leaves.items():
            out[f"layers/{g}/{n}"] = t.numpy()
    return out


def _cfg(**kw):
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig)
    return TransformerConfig.tiny(**{"n_layers": N_LAYERS, **kw})


def _train(mesh, init, tokens, steps, schedule, kw, gb=GB,
           n_micro=N_MICRO) -> dict:
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_pipelined_train_step)
    cfg = _cfg()
    state, step = make_pipelined_train_step(
        cfg, mesh, gb, n_micro, schedule=schedule,
        params=_params_from_np(cfg, init), **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(tokens[:gb])})
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _flat(step.gather_params()),
            "stats": step.last_stats}


def _refused(fn) -> tuple | None:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def pp_train_rank(meshes: dict, init: dict, tokens: np.ndarray, steps: int,
                  variants: dict, refusals: list, logdir: str) -> dict:
    """Every ``(mesh name, variant)`` of ``variants`` (schedule, step
    kwargs, global batch, microbatches; the batch the first rows of
    ``tokens``) on its mesh of ``meshes`` from the same parameters, with
    the
    ``pipeline.schedule`` event each build wrote to this rank's log
    under ``logdir``; then the refusals ``(mesh name, config kwargs, step
    kwargs, global batch, microbatches)`` of
    ``make_pipelined_train_step`` and, on the first mesh,
    ``make_sharded_train_step``'s."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        make_pipelined_train_step, make_sharded_train_step)
    _init()
    built = {name: topology.make_mesh(axes, device="cpu")
             for name, axes in meshes.items()}
    out = {"rank": dist.get_rank(), "runs": {}}
    log = telemetry.configure(logdir)
    for (mesh, name), (schedule, kw, gb, m) in variants.items():
        out["runs"][(mesh, name)] = _train(built[mesh], init, tokens, steps,
                                           schedule, kw, gb, m)
    telemetry.shutdown()
    out["events"] = [e for e in telemetry.read_events(log.path)
                     if e["ev"] == "pipeline.schedule"]
    out["refusals"] = [
        _refused(lambda: make_pipelined_train_step(
            _cfg(**cfg_kw), built[mesh], gb, m, **kw))
        for mesh, cfg_kw, kw, gb, m in refusals]
    first = next(iter(built.values()))
    out["sharded_refusal"] = _refused(
        lambda: make_sharded_train_step(_cfg(), first, GB))
    return out


# ---------------------------------------------------------------------------
# The executor on tests/test_pipeline.py's toy stage
# ---------------------------------------------------------------------------

def _toy_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def toy_rank(cases: list, per_stage: list, hp: dict, x: np.ndarray,
             tgt: np.ndarray) -> dict:
    """Each case ``(schedule, interleave)`` of ``run_schedule`` over the
    pp dim of this world on the toy stage (model stage s's ``{"w",
    "b"}`` of ``per_stage``) and MSE head: the loss, this rank's stage
    gradients by model stage, the head's gradient and the input's."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import pipeline as pl
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        all_reduce)
    _init()
    world = dist.get_world_size()
    mesh = topology.make_mesh({"pp": world}, device="cpu")
    links = pl.StageLinks(mesh)
    out = {"rank": dist.get_rank(), "cases": {}}
    for schedule, v in cases:
        stages = [j * world + links.index for j in range(v)]
        params = {s: {k: torch.tensor(a, requires_grad=True)
                      for k, a in per_stage[s].items()} for s in stages}
        wo = torch.tensor(hp["wo"], requires_grad=True)
        xs = torch.tensor(x, requires_grad=True)
        t = torch.from_numpy(tgt)
        loss_sum = pl.run_schedule(
            links, schedule, x.shape[0], interleave=v,
            stage_fn=lambda j, a: _toy_stage(params[stages[j]], a),
            head_fn=lambda m, y: ((y @ wo - t[m]) ** 2).mean(),
            input_fn=lambda m: xs[m], act_shape=x.shape[1:],
            act_dtype=torch.float32, device="cpu")
        loss = all_reduce(loss_sum, mesh, "pp") / x.shape[0]

        def grad(t_):
            return None if t_.grad is None else t_.grad.numpy()
        out["cases"][(schedule, v)] = {
            "loss": float(loss),
            "stages": {s: {k: grad(p) for k, p in params[s].items()}
                       for s in stages},
            "wo": grad(wo), "x": grad(xs), "p2p": dict(links.counts)}
        links.reset_counts()
    return out


# ---------------------------------------------------------------------------
# The offloaded 1F1B stash (parallel/offload.py)
# ---------------------------------------------------------------------------

def _spill_rule(hits):
    from distributed_tensorflow_tpu_torch.resilience import faults
    return faults.FaultSchedule(seed=7, rules=(faults.FaultRule(
        site="offload.spill", tag="c3", hits=hits,
        max_fires=len(hits)),))


def offload_rank(init: dict, tokens: np.ndarray, steps: int,
                 logdir: str) -> dict:
    """1F1B on ``{"pp": 2}`` with the stash on the card (no store),
    spilled to the host, kept on the card through the store
    (``"device"``), and spilled with one ``offload.spill`` fault at
    cycle 3 of the last step (retried); each run's losses, parameters,
    last step's stats and the ``offload.step`` events it wrote."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch import telemetry
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.resilience import faults
    _init()
    mesh = topology.make_mesh({"pp": 2}, device="cpu")
    out = {"rank": dist.get_rank(), "runs": {}}
    log = telemetry.configure(logdir)
    for name, offload in (("plain", False), ("spill", True),
                          ("device", "device"), ("retry", True)):
        if name == "retry":
            with faults.inject(_spill_rule((steps,))) as reg:
                run = _train(mesh, init, tokens, steps, "1f1b",
                             {"offload_activations": offload})
            run["fired"] = reg.events()
        else:
            run = _train(mesh, init, tokens, steps, "1f1b",
                         {"offload_activations": offload})
        out["runs"][name] = run
    telemetry.shutdown()
    out["events"] = [e for e in telemetry.read_events(log.path)
                     if e["ev"] == "offload.step"]
    return out


def double_fault_rank(init: dict, tokens: np.ndarray) -> int:
    """One spilled 1F1B step on ``{"pp": 2}`` whose cycle-3 spill fails
    twice: the rank whose backward needs that input raises."""
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.resilience import faults
    _init(timeout_s=60)
    mesh = topology.make_mesh({"pp": 2}, device="cpu")
    with faults.inject(_spill_rule((1, 2))):
        _train(mesh, init, tokens, 1, "1f1b", {"offload_activations": True})
    return 0

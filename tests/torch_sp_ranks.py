"""Rank functions for the port's sequence-parallel tests.

Torch only (no jax): ``testing.multi_process_runner`` spawns fresh
interpreters that import this module by name, and each rank runs on
gloo on the CPU. Each function runs a whole batch of cases in one spawn
(an interpreter start costs seconds) and returns numpy arrays, which
the test files hold against the JAX package.
"""

import numpy as np
import torch

from torch_dp_ranks import _init


def _chunk(x: np.ndarray, n: int, i: int) -> torch.Tensor:
    s = x.shape[2] // n
    return torch.from_numpy(x[:, :, i * s:(i + 1) * s].copy())


def attention_rank(cases: list, qkv: dict, refusals: list) -> dict:
    """Each case ``(name, key, impl, attn_impl, causal)`` on a ``{"sp":
    world}`` mesh: ``make_ring_attention`` on this rank's chunks of
    ``qkv[key]`` (``(3, b, h, S, d)``), the output and the gradients
    ``(dq, dk, dv)`` of ``sum(out²)`` over the whole sequence (each
    rank's loss its chunk's). Then the collectives on their own:
    ``ring_shift`` and its gradient, ``all_to_all`` (split 1, concat
    2). Each refusal ``(kwargs)`` to ``make_ring_attention`` comes back
    as its exception ``(type, message)`` or None."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.parallel import collectives as C
    from distributed_tensorflow_tpu_torch.parallel import (
        sequence_parallel as sp)
    _init()
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = topology.make_mesh({"sp": world}, device="cpu")
    out = {"rank": rank}
    for name, key, impl, attn_impl, causal in cases:
        leaves = [_chunk(t, world, rank).requires_grad_()
                  for t in qkv[key]]
        fn = sp.make_ring_attention(mesh, causal=causal, impl=impl,
                                    attn_impl=attn_impl)
        o = fn(*leaves)
        (o.float() ** 2).sum().backward()
        out[name] = {"o": o.detach().numpy(),
                     "grads": [t.grad.numpy() for t in leaves]}
    x = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) + 100 * rank
    x.requires_grad_()
    shifted = C.ring_shift(x, mesh, "sp")
    (shifted * (rank + 1)).sum().backward()
    out["ring_shift"] = {"y": shifted.detach().numpy(),
                         "grad": x.grad.numpy()}
    y = torch.arange(2 * 4 * world * 3, dtype=torch.float32).reshape(
        2, 4 * world, 3) + 1000 * rank
    out["all_to_all"] = C.all_to_all(y, mesh, "sp", split_axis=1,
                                     concat_axis=2).numpy()
    out["refusals"] = []
    for kw in refusals:
        try:
            fn = sp.make_ring_attention(mesh, **kw)
            q = _chunk(qkv["qkv4"][0], world, rank)
            fn(q, q, q)
            out["refusals"].append(None)
        except (ValueError, NotImplementedError) as e:
            out["refusals"].append((type(e).__name__, str(e)))
    return out


def remat_rank(cases: list, tokens: np.ndarray, init: dict) -> dict:
    """One step of ``make_sharded_train_step`` on ``{"sp": world}`` for
    each ``(name, config kwargs)``: the loss, the attention leaves'
    gradients (synced over ``sp``) and the ring's sends
    (``RingExchange.sends``) over the step."""
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import topology
    from distributed_tensorflow_tpu_torch.models.transformer import (
        TransformerConfig, make_sharded_train_step)
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        RingExchange)
    from torch_dp_ranks import _params_from_np
    _init()
    mesh = topology.make_mesh({"sp": dist.get_world_size()}, device="cpu")
    tok = torch.from_numpy(tokens)
    out = {}
    for name, cfg_kw in cases:
        cfg = TransformerConfig.tiny(**cfg_kw)
        state, step = make_sharded_train_step(
            cfg, mesh, tokens.shape[0], params=_params_from_np(cfg, init))
        sends = RingExchange.sends
        state, m = step(state, {"tokens": tok})
        model = state["model"]
        out[name] = {"loss": float(m["loss"]),
                     "sends": RingExchange.sends - sends,
                     "grads": {k: v.detach().numpy().copy() for k, v in
                               model.stacked_params(
                                   lambda p: p.grad)["layers"]["attn"]
                               .items()}}
    return out


def train_rank(jobs: dict) -> dict:
    """Every job of one spawn under one process group: ``jobs["train"]``
    the arguments of ``torch_tp_ranks.train_rank``, ``jobs["bert"]``
    those of its ``bert_rank``, ``jobs["remat"]`` those of
    :func:`remat_rank` (each optional)."""
    import torch_tp_ranks
    out = {}
    if "train" in jobs:
        out["train"] = torch_tp_ranks.train_rank(*jobs["train"])
    if "bert" in jobs:
        out["bert"] = torch_tp_ranks.bert_rank(*jobs["bert"])
    if "remat" in jobs:
        out["remat"] = remat_rank(*jobs["remat"])
    return out

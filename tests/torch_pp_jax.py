"""The JAX side of the port's pipeline tests: ``make_pipelined_train_step``
runs on the 8-virtual-device CPU mesh, their parameters in the port's
layer order (the ``(pp, L/pp, ...)`` / ``(pp, v, L/(pp·v), ...)``
regrouping undone) as ``"group/name"`` numpy arrays."""

import jax
import numpy as np

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_pipelined_train_step as jpipelined)

from torch_tp_jax import flat, jax_mesh


def whole_layers(tree, schedule: str) -> dict:
    """JAX's pipelined parameter tree with its layer stack back in the
    ``(L, ...)`` order of ``scan_layers=True``."""
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def undo(a):
        if schedule == "interleaved":
            a = np.swapaxes(a, 0, 1)
        return a.reshape((-1,) + a.shape[3 if schedule == "interleaved"
                                         else 2:])
    return {**tree, "layers": jax.tree_util.tree_map(undo, tree["layers"])}


def jax_pp_run(axes, schedule: str, kw: dict, tokens, steps: int, *,
               n_layers: int, global_batch: int, n_micro: int) -> dict:
    """``steps`` steps of JAX's pipelined step on ``axes``: the initial
    and final parameters (flattened, whole) and every step's loss."""
    cfg = JConfig.tiny(n_layers=n_layers)
    state, step = jpipelined(cfg, jax_mesh(axes), global_batch, n_micro,
                             schedule=schedule, **kw)
    init = flat(whole_layers(state["params"], schedule))
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return {"init": init, "losses": losses,
            "params": flat(whole_layers(state["params"], schedule))}

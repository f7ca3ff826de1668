"""The JAX side of the port's tensor-parallel training tests: a
``make_sharded_train_step`` run on the 8-virtual-device CPU mesh, its
initial and final parameters flattened to ``"group/name"`` numpy
arrays (the keys of ``torch_tp_ranks``)."""

import jax
import numpy as np

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded)

#: JAX's config knobs that take the Pallas kernels in interpret mode
KERNEL_KNOBS = {"loss_impl": {"loss_kernel_impl": "interpret"},
                "fused_optimizer": {"optimizer_impl": "interpret"}}


def jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=jax.devices()[:n])


def flat(tree) -> dict:
    tree = jax.tree_util.tree_map(np.asarray, tree)
    out = {"embed": tree["embed"],
           "final_norm/scale": tree["final_norm"]["scale"]}
    for g, leaves in tree["layers"].items():
        for n, a in leaves.items():
            out[f"layers/{g}/{n}"] = a
    return out


def jax_config(cfg_kw, bert=False):
    kw = dict(cfg_kw)
    for knob, extra in KERNEL_KNOBS.items():
        if knob in kw:
            kw.update(extra)
    return (jbert.tiny_bert_config(**kw) if bert else JConfig.tiny(**kw))


def jax_run(axes, cfg_kw, kw, tokens, steps) -> dict:
    """``{"init", "losses", "params"}`` of ``steps`` JAX steps."""
    state, step = jsharded(jax_config(cfg_kw), jax_mesh(axes),
                           tokens.shape[0], 0, **kw)
    init = flat(state["params"])
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return {"init": init, "losses": losses, "params": flat(state["params"])}


def jax_bert_run(axes, cfg_kw, tokens, steps) -> dict:
    """The same for BERT's sharded step, with the masks it drew
    (``apply_mlm_masking(fold_in(PRNGKey(0), step), tokens)``)."""
    cfg = jax_config(cfg_kw, bert=True)
    state, step = jbert.make_sharded_train_step(cfg, jax_mesh(axes),
                                                tokens.shape[0], 0)
    init = flat(state["params"])
    masks = [tuple(np.asarray(a).astype(np.int64) for a in
                   jbert.apply_mlm_masking(
                       jax.random.fold_in(jax.random.PRNGKey(0), t), tokens,
                       vocab_size=cfg.vocab_size))
             for t in range(steps)]
    losses = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    return {"init": init, "masks": masks, "losses": losses,
            "params": flat(state["params"])}


def assert_close(got, want, label, loss_atol=2e-6, param_atol=1e-5):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=loss_atol, err_msg=label)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=param_atol, err_msg=f"{label} {k}")

"""Port parity: ``distributed_tensorflow_tpu_torch.models.wide_deep``
against the JAX package's ``models/wide_deep.py`` on the CPU, in f32,
from the same flax init:

- ``synthetic_clicks`` equals JAX's arrays bit for bit; the "dot"
  interaction's ``triu_indices(k=1)`` pairs equal JAX's exactly.
- ``WideDeep`` ("concat" and "dot") logits within 1e-6.
- Three steps of ``make_train_step`` (``optax.adagrad`` on JAX's side,
  the port's written-out Adagrad): every step's loss within 2e-6 and
  the parameters within 1e-5 (``tests/test_torch_train_step.py``'s
  tolerances), for both interactions.
- Three steps of ``make_embedding_train_step`` on one device (JAX's on a
  ``{"dp": 1}`` mesh), from JAX's dense parameters and embedding state:
  losses within 2e-6, the dense parameters, the tables and their
  Adagrad slots within 1e-5, the step count equal.
- The pure parameter-server helpers: ``ps_worker_grads`` at JAX's state
  gives JAX's loss within 2e-6 and gradients within 1e-6, and
  ``ps_apply_grads`` of those gradients JAX's new state within 1e-6.
- With no CUDA device, ``device="cuda"`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import wide_deep as jw
from distributed_tensorflow_tpu_torch import embedding as te
from distributed_tensorflow_tpu_torch.models import wide_deep as tw

from torch_tp_jax import jax_mesh

GB, STEPS = 16, 3


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, atol, label):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol,
                                   err_msg=f"{label} {k}")


def _jcfg(inter):
    return jw.WideDeepConfig.tiny(interaction=inter)


def _tcfg(inter):
    return tw.WideDeepConfig.tiny(interaction=inter)


def test_synthetic_clicks_are_bitwise_jax():
    want = jw.synthetic_clicks(_jcfg("dot"), 40, seed=6)
    got = tw.synthetic_clicks(_tcfg("dot"), 40, seed=6)
    for k in ("dense", "categorical", "label"):
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("t", [2, 3, 26])
def test_triu_pairs_are_jaxs(t):
    want = np.stack(np.asarray(jnp.triu_indices(t, k=1)))
    got = torch.triu_indices(t, t, offset=1).numpy()
    assert np.array_equal(got, want)


def _jax_init(cfg, n=GB):
    params = jw.WideDeep(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((n, cfg.num_dense_features)),
        jnp.zeros((n, len(cfg.vocab_sizes)), jnp.int32))["params"]
    params = _np(params)
    # the wide vectors start at zero: move them so the lookups show
    rng = np.random.default_rng(1)
    return {k: (v + np.float32(0.01) * rng.normal(size=v.shape).astype(
        np.float32) if k.startswith("wide_") else v)
        for k, v in params.items()}


@pytest.mark.parametrize("inter", ["concat", "dot"])
def test_forward_matches_jax(inter):
    cfg = _jcfg(inter)
    params = _jax_init(cfg)
    batch = jw.synthetic_clicks(cfg, GB, seed=2)
    want = np.asarray(jw.WideDeep(cfg).apply(
        {"params": params}, batch["dense"], batch["categorical"]))
    model = tw.params_from_jax(_tcfg(inter), params, device="cpu")
    with torch.no_grad():
        got = model(np.asarray(batch["dense"]),
                    np.asarray(batch["categorical"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("inter", ["concat", "dot"])
def test_train_steps_match_jax(inter):
    cfg = _jcfg(inter)
    params = _jax_init(cfg)
    model_j, tx = jw.WideDeep(cfg), jw.make_optimizer(cfg)
    jstate = {"params": params, "opt_state": tx.init(params), "step": 0}
    jstep = jax.jit(jw.make_train_step(cfg, model_j, tx))
    model = tw.params_from_jax(_tcfg(inter), params, device="cpu")
    opt = tw.make_optimizer(_tcfg(inter), model.parameters())
    step = tw.make_train_step(_tcfg(inter), model, opt)
    state = {"model": model, "optimizer": opt, "step": 0}
    for i in range(STEPS):
        batch = jw.synthetic_clicks(cfg, GB, seed=10 + i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: np.asarray(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-6, i
    _close(tw.flax_params(model), _np(jstate["params"]), 1e-5, inter)


@pytest.fixture(scope="module")
def emb_run():
    cfg = _jcfg("dot")
    jstate, jstep = jw.make_embedding_train_step(cfg, jax_mesh({"dp": 1}),
                                                 GB, seed=0)
    init = _np(jstate)
    losses = []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jw.synthetic_clicks(cfg, GB, seed=20 + i))
        losses.append(float(jm["loss"]))
    return init, losses, _np(jstate)


def test_embedding_train_steps_match_jax(emb_run):
    init, losses, want = emb_run
    cfg = _tcfg("dot")
    state, step = tw.make_embedding_train_step(
        cfg, device="cpu", dense_params=init["dense"]["params"],
        emb_state=init["emb"])
    for i in range(STEPS):
        batch = tw.synthetic_clicks(cfg, GB, seed=20 + i)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - losses[i]) <= 2e-6, i
    _close(tw.flax_params(state["dense"]["model"]),
           want["dense"]["params"], 1e-5, "dense")
    emb = state["emb"]
    _close({k: v.numpy() for k, v in emb["tables"].items()},
           want["emb"]["tables"], 1e-5, "tables")
    _close({k: {s: a.numpy() for s, a in v.items()}
            for k, v in emb["slots"].items()}, want["emb"]["slots"], 1e-5,
           "slots")
    assert int(emb["step"]) == int(want["emb"]["step"]) == STEPS


def test_ps_helpers_match_jax(emb_run):
    init, _, _ = emb_run
    cfg_j, cfg_t = _jcfg("dot"), _tcfg("dot")
    batch = jw.synthetic_clicks(cfg_j, GB, seed=30)
    jloss, jd, jt = jw.ps_worker_grads(
        cfg_j, init["dense"]["params"], init["emb"]["tables"],
        iter([batch]))
    jnew = jw.ps_apply_grads(cfg_j, init, jd, jt)

    tstate = te.state_from_jax(init["emb"], device="cpu")
    dense = {f"{m}.{n}": torch.from_numpy(np.array(v[n]))
             for m, v in init["dense"]["params"].items() for n in v}
    state = {"dense": {"params": dense,
                       "opt_state": {f"{m}.{n}": torch.from_numpy(np.array(
                           v[n])) for m, v in
                           init["dense"]["opt_state"][0].sum_of_squares
                           .items() for n in v}},
             "emb": tstate}
    loss, dg, tg = tw.ps_worker_grads(
        cfg_t, dense, tstate["tables"],
        iter([{k: np.asarray(v) for k, v in batch.items()}]))
    assert abs(loss - float(jloss)) <= 2e-6
    for m, v in jd.items():
        for n, w in v.items():
            np.testing.assert_allclose(dg[f"{m}.{n}"], w, rtol=0, atol=1e-6)
    for k, w in jt.items():
        np.testing.assert_allclose(tg[k], w, rtol=0, atol=1e-6)
    new = tw.ps_apply_grads(cfg_t, state, dg, tg)
    for m, v in _np(jnew["dense"]["params"]).items():
        for n, w in v.items():
            np.testing.assert_allclose(new["dense"]["params"][f"{m}.{n}"],
                                       w, rtol=0, atol=1e-6)
    for k, w in _np(jnew["emb"]["tables"]).items():
        np.testing.assert_allclose(new["emb"]["tables"][k].numpy(), w,
                                   rtol=0, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
@pytest.mark.parametrize("entry", ["model", "embedding_step", "ps"])
def test_cuda_without_a_card_raises(entry):
    cfg = _tcfg("dot")
    call = {"model": lambda: tw.WideDeep(cfg),
            "embedding_step": lambda: tw.make_embedding_train_step(cfg),
            "ps": lambda: tw.ps_init_state(cfg)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()

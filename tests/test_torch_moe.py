"""Port parity: the mixture-of-experts layer and the MoE transformer on
one device against the JAX package, on the CPU in f32.

- ``MoELayer`` / ``moe_forward`` against JAX's ``MoELayer`` with the same
  weights on the same input, top-1 and top-2, capacity 2.0 and 0.5 (so
  tokens drop): output, aux and ``jax.grad`` of router, wi, wo and x
  within 1e-5; the set of exactly-zero output rows equal (JAX's own
  observable of a dropped token, ``tests/test_moe.py``), non-empty at
  capacity 0.5. The capacity formula is JAX's, and the top-k tie rule
  is ``jax.lax.top_k``'s (the lowest index first).
- ``TransformerConfig.tiny(moe_experts=4)`` (top-1 and top-2, capacity
  0.5): the loss of ``make_loss_fn`` (aux included) within 2e-6 and
  every gradient within 1e-4 of its leaf's largest magnitude (the train
  step test's tolerances), then 3 steps of ``make_train_step`` against
  JAX's: losses 2e-6, parameters 1e-5. The converted tree holds
  ``layers/moe/{router, wi, wo}`` in JAX's layout, stacked and
  unstacked.
- The aux loss leaves every remat policy's checkpoint: the loss and
  gradients under each of ``REMAT_POLICIES`` equal those without remat,
  bit for bit.
- ``param_specs`` on MoE meshes equals JAX's ``state_shardings_for``
  exactly (``{"dp": 2, "ep": 4}``, ``{"ep": 2, "tp": 2, "fsdp": 2}``).
- The refusals are JAX's, with its exception types: ``zero=`` with MoE
  (``NotImplementedError``), the pipelined step with MoE
  (``NotImplementedError``), ``grad_sync="bucketed"``/``"none"`` with
  MoE (``ValueError``); ``moe_experts`` that ``ep`` does not divide
  raises ``ValueError`` naming it (JAX pads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.models import transformer as jtf
from distributed_tensorflow_tpu.parallel import moe as jmoe
from distributed_tensorflow_tpu_torch.models import transformer as ttf
from distributed_tensorflow_tpu_torch.parallel import moe as tmoe

D, F, E = 16, 32, 4
LAYER_CASES = [(k, cf) for k in (1, 2) for cf in (2.0, 0.5)]
B, S, STEPS = 4, 16, 3
MODEL_CASES = {"top1": {"moe_top_k": 1}, "top2": {"moe_top_k": 2}}


def _x():
    return np.random.default_rng(0).normal(size=(4, 8, D)).astype(np.float32)


def _layer_objective(out, aux, n):
    # a fixed, non-uniform weighting of every output element
    return (out * (torch.arange(n).reshape(out.shape) / n)).sum() + aux


@pytest.fixture(scope="module", params=LAYER_CASES,
                ids=[f"top{k}_cf{cf}" for k, cf in LAYER_CASES])
def layer_case(request):
    k, cf = request.param
    jcfg = jmoe.MoEConfig(num_experts=E, d_model=D, d_ff=F,
                          capacity_factor=cf, top_k=k)
    layer = jmoe.MoELayer(jcfg)
    x = _x()
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    out, aux = layer.apply({"params": params}, jnp.asarray(x))

    def objective(p, x):
        o, a = layer.apply({"params": p}, x)
        w = jnp.arange(o.size).reshape(o.shape) / o.size
        return jnp.sum(o * w) + a
    gp, gx = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    want = {"out": np.asarray(out), "aux": float(aux),
            "grads": {n: np.asarray(g) for n, g in gp.items()},
            "dx": np.asarray(gx)}
    tparams = {n: torch.from_numpy(np.array(v)).requires_grad_(True)
               for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tcfg = tmoe.MoEConfig(num_experts=E, d_model=D, d_ff=F,
                          capacity_factor=cf, top_k=k)
    with tmoe.routing_log() as log:
        o, a = tmoe.moe_forward(tparams, tx, tcfg)
    _layer_objective(o, a, o.numel()).backward()
    got = {"out": o.detach().numpy(), "aux": float(a),
           "grads": {n: t.grad.numpy() for n, t in tparams.items()},
           "dx": tx.grad.numpy(), "dropped": log[0]["dropped"].numpy()}
    return request.param, got, want


def test_layer_output_and_aux_match_jax(layer_case):
    _, got, want = layer_case
    np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=1e-5)
    assert abs(got["aux"] - want["aux"]) <= 1e-5


def test_layer_gradients_match_jax(layer_case):
    _, got, want = layer_case
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=0, atol=1e-5)


def test_layer_zero_rows_are_jaxs(layer_case):
    (k, cf), got, want = layer_case
    zero_jax = (np.abs(want["out"]).sum(-1) == 0)
    zero_port = (np.abs(got["out"]).sum(-1) == 0)
    np.testing.assert_array_equal(zero_port, zero_jax)
    # the routing log's dropped tokens are exactly those rows
    np.testing.assert_array_equal(got["dropped"], zero_jax)
    if cf < 1:
        assert zero_jax.any()


def test_capacity_and_top_k_ties_are_jaxs():
    for cf, t, k, e in ((1.25, 8192, 1, 8), (2.0, 8192, 2, 8),
                        (0.5, 64, 1, 4), (0.01, 10, 1, 4)):
        cfg = tmoe.MoEConfig(num_experts=e, capacity_factor=cf, top_k=k)
        assert tmoe.capacity(cfg, t) == max(1, int(cf * t * k / e))
    probs = np.array([[.3, .3, .4, 0.], [.25, .25, .25, .25],
                      [0., .5, 0., .5]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    got = tmoe._top_k(torch.from_numpy(probs), 2).T.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[0], [2, 0])


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _jax_model_run(kw):
    cfg = jtf.TransformerConfig.tiny(max_seq_len=S, moe_experts=E,
                                     moe_capacity_factor=0.5, **kw)
    model = jtf.TransformerLM(cfg)
    tokens = jnp.asarray(_tokens())
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    loss_fn = jtf.make_loss_fn(cfg, model)
    loss, grads = jax.value_and_grad(loss_fn)(params, tokens)
    tx = jtf.make_optimizer(cfg)
    step = jax.jit(jtf.make_train_step(cfg, model, tx))
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"init": np_(params), "loss": float(loss), "grads": np_(grads),
            "losses": losses, "params": np_(state["params"])}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model_case(request):
    kw = MODEL_CASES[request.param]
    want = _jax_model_run(kw)
    cfg = ttf.TransformerConfig.tiny(max_seq_len=S, moe_experts=E,
                                     moe_capacity_factor=0.5, **kw)
    params = ttf.params_from_jax(cfg, want["init"], device="cpu")
    model = ttf.TransformerLM(cfg, params, device="cpu")
    tokens = torch.from_numpy(_tokens()).long()
    loss = ttf.make_loss_fn(cfg, model)(tokens)
    loss.backward()
    grads = model.stacked_params(lambda p: p.grad.clone())
    opt = ttf.make_optimizer(cfg, model.parameters())
    step = ttf.make_train_step(cfg, model, opt)
    state, losses = {"model": model, "optimizer": opt, "step": 0}, []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": tokens})
        losses.append(m["loss"].item())
    got = {"loss": loss.item(), "grads": grads, "losses": losses,
           "params": model.stacked_params(lambda p: p.detach())}
    return cfg, got, want


def test_model_loss_and_gradients_match_jax(model_case):
    cfg, got, want = model_case
    assert abs(got["loss"] - want["loss"]) <= 2e-6
    wgrads = dict(_leaves(ttf.params_from_jax(cfg, want["grads"],
                                              device="cpu")))
    ggrads = dict(_leaves(got["grads"]))
    assert sorted(ggrads) == sorted(wgrads)
    assert {"layers/moe/router", "layers/moe/wi", "layers/moe/wo"} \
        <= set(ggrads)
    for name, w in wgrads.items():
        np.testing.assert_allclose(ggrads[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * w.abs().max().item(),
                                   err_msg=name)


def test_model_steps_match_jax(model_case):
    cfg, got, want = model_case
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=2e-6)
    assert got["losses"][-1] < got["losses"][0]
    wparams = dict(_leaves(ttf.params_from_jax(cfg, want["params"],
                                               device="cpu")))
    for name, g in _leaves(got["params"]):
        np.testing.assert_allclose(g.numpy(), wparams[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_moe_tree_converts_stacked_and_unstacked():
    cfg = ttf.TransformerConfig.tiny(moe_experts=E)
    full = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = ttf.param_shapes(cfg)["layers"]
    assert "mlp" not in shapes
    assert shapes["moe"] == {"router": (2, 64, E), "wi": (2, E, 64, 128),
                             "wo": (2, E, 128, 64)}
    stacked = {"embed": full["embed"].numpy(),
               "final_norm": {"scale": full["final_norm"]["scale"].numpy()},
               "layers": {g: {n: t.numpy() for n, t in v.items()}
                          for g, v in full["layers"].items()}}
    unstacked = {k: v for k, v in stacked.items() if k != "layers"}
    for i in range(cfg.n_layers):
        unstacked[f"layer_{i}"] = {g: {n: a[i] for n, a in v.items()}
                                   for g, v in stacked["layers"].items()}
    for tree in (stacked, unstacked):
        back = ttf.params_from_jax(cfg, tree, device="cpu")
        for (k, a), (_, b) in zip(_leaves(back), _leaves(full)):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("policy", sorted(ttf.REMAT_POLICIES))
def test_aux_survives_every_remat_policy(policy):
    kw = dict(max_seq_len=S, moe_experts=E, moe_capacity_factor=0.5,
              moe_top_k=2, attention_impl=None)
    results = []
    for remat in (False, True):
        cfg = ttf.TransformerConfig.tiny(remat=remat, remat_policy=policy,
                                         **kw)
        model = ttf.TransformerLM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        loss = ttf.make_loss_fn(cfg, model)(
            torch.from_numpy(_tokens()).long())
        loss.backward()
        results.append((loss.item(), [p.grad.clone()
                                      for p in model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # the router takes its gradient through the aux loss as well
    assert g1[0].abs().sum() > 0


def _jax_specs(axes, cfg):
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    sh = jtf.state_shardings_for(jtf.TransformerLM(cfg),
                                 jtf.make_optimizer(cfg), mesh,
                                 jnp.zeros((8, cfg.max_seq_len), jnp.int32))
    return jax.tree_util.tree_map(lambda s: tuple(s.spec), sh["params"],
                                  is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 4},
                                  {"ep": 2, "tp": 2, "fsdp": 2}],
                         ids=["dp2_ep4", "ep2_tp2_fsdp2"])
def test_moe_param_specs_equal_jax(axes):
    want = dict(_leaves(_jax_specs(axes, jtf.TransformerConfig.tiny(
        moe_experts=E))))
    got = dict(_leaves(ttf.param_specs(ttf.TransformerConfig.tiny(
        moe_experts=E), axes)))
    assert got == want
    if "fsdp" in axes:
        assert got["layers/moe/wi"] == (None, "ep", None, "tp")
        assert got["layers/moe/wo"] == (None, "ep", "tp", None)
        assert got["embed"] == ("tp", "fsdp")
        assert got["layers/attn/query"] == (None, "fsdp", "tp", None)
    else:
        assert got["layers/moe/router"] == (None, None, "ep")
        assert got["layers/moe/wi"] == (None, "ep", None, None)


#: (what, config kwargs, call) refused by both packages
REFUSALS = {
    "zero": ("NotImplementedError", lambda pkg, cfg: pkg.make_sharded_train_step(
        cfg, _mesh(pkg, {"dp": 2, "ep": 2}), 8, zero=1)),
    "pipeline": ("NotImplementedError",
                 lambda pkg, cfg: pkg.make_pipelined_train_step(
                     cfg, _mesh(pkg, {"pp": 2}), 8, 2)),
    "bucketed": ("ValueError", lambda pkg, cfg: pkg.make_sharded_train_step(
        cfg, _mesh(pkg, {"dp": 4}), 8, grad_sync="bucketed")),
    "none": ("ValueError", lambda pkg, cfg: pkg.make_sharded_train_step(
        cfg, _mesh(pkg, {"dp": 4}), 8, grad_sync="none")),
}


def _mesh(pkg, axes):
    # the port's refusals come before the mesh's groups are touched:
    # its mesh may be the {name: size} mapping
    if pkg is ttf:
        return axes
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=jax.devices()[:n])


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_moe_refusals_are_jaxs(what):
    kind, call = REFUSALS[what]
    for pkg in (jtf, ttf):
        with pytest.raises((ValueError, NotImplementedError)) as e:
            call(pkg, pkg.TransformerConfig.tiny(moe_experts=E))
        assert type(e.value).__name__ == kind, (pkg.__name__, e.value)


def test_experts_that_ep_does_not_divide_raise():
    cfg = ttf.TransformerConfig.tiny(moe_experts=3)
    full = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="moe_experts"):
        ttf.shard_params_at(cfg, full, {"ep": 0}, {"ep": 2})


def test_layer_initialises_with_jaxs_distributions():
    """``MoELayer`` from a generator: JAX's names, shapes and f32
    initialisers (router N(0, 0.02), wi N(0, D^-1/2), wo N(0, F^-1/2)),
    and ``moe_forward`` through the module."""
    cfg = tmoe.MoEConfig(num_experts=8, d_model=64, d_ff=256)
    layer = tmoe.MoELayer(cfg, generator=torch.Generator().manual_seed(0))
    want = {"router": ((64, 8), 0.02), "wi": ((8, 64, 256), 64 ** -0.5),
            "wo": ((8, 256, 64), 256 ** -0.5)}
    for name, (shape, std) in want.items():
        p = getattr(layer, name)
        assert tuple(p.shape) == shape and p.dtype == torch.float32
        assert abs(p.std().item() / std - 1) < 0.05, name
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 8, 64)).astype(np.float32))
    out, aux = layer(x)
    want_out, want_aux = tmoe.moe_forward(
        {n: getattr(layer, n) for n in want}, x, cfg)
    assert torch.equal(out, want_out) and torch.equal(aux, want_aux)

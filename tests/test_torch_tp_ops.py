"""Port parity: the pieces of tensor parallelism against the JAX package
and against the single-rank computation.

- The logical-axis rules: ``param_specs(tiny(), mesh)`` equals
  ``tuple(ns.spec)`` of JAX's ``state_shardings_for(...)["params"]``
  leaf for leaf on ``{"tp": 2}``, ``{"dp": 2, "tp": 2}`` and
  ``{"tp": 4}`` (host logic: exact). The shards' shapes are JAX's
  ``_local_shape``, so ``ZeroPartition``'s summary over them is JAX's.
- ``shard_params_at`` / ``unshard_params``: the round trip is bitwise,
  every shard is contiguous, and ``wi``'s shard r holds ``gate``'s and
  ``up``'s r-th column blocks side by side.
- ``merge_vocab_shards`` of per-shard ``fused_ce_fwd`` equals the
  whole-vocab forward within a relative 1e-6 (f32 rounding of an
  lse near 15); ``local_targets`` maps an id another
  shard owns to −1.
- ``n_heads`` or ``d_ff`` that ``tp`` does not divide raise
  ``ValueError`` naming the dim; a ``vocab_size`` it does not divide is
  padded instead: each shard holds ``ceil(V/tp)`` rows, the pad rows
  zero, and ``unshard_params`` gives back the ``(V, D)`` embedding
  bitwise.
- Spawned gloo ranks on ``{"tp": 2}`` (world 2) and ``{"dp": 2, "tp":
  2}`` (world 4), one spawn each: ``tp_copy`` / ``tp_reduce`` around a
  column- then row-parallel product, ``vocab_parallel_embed`` and the
  vocab-parallel CE of full logits give the one-rank values and
  gradients within 1e-5; ``sharded_fused_cross_entropy`` (variants
  "b", "a", "split") gives JAX's ``sharded_fused_cross_entropy(...,
  implementation="interpret")`` losses, dh and dE on the same mesh
  within 1e-5; ``shard_params`` → ``gather_params`` is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel, make_optimizer,
    state_shardings_for)
from distributed_tensorflow_tpu.ops.fused_ce import (
    sharded_fused_cross_entropy as jsharded_ce)
from distributed_tensorflow_tpu.parallel.zero import (
    ZeroPartition as JZeroPartition, _local_shape)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, _leaf_metas, init_params,
    jax_leaf_params, param_specs, shard_params_at, unshard_params)
from distributed_tensorflow_tpu_torch.ops.fused_ce import (
    fused_ce_fwd, local_targets, merge_vocab_shards)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel)
from distributed_tensorflow_tpu_torch.parallel.zero import ZeroPartition
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_tp_ranks

MESHES = {"tp2": {"tp": 2}, "dp2_tp2": {"dp": 2, "tp": 2},
          "tp4": {"tp": 4}}


def _jax_specs(axes):
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    cfg = JConfig.tiny()
    sh = state_shardings_for(JModel(cfg), make_optimizer(cfg), mesh,
                             jnp.zeros((8, cfg.max_seq_len), jnp.int32))
    return mesh, jax.tree_util.tree_map(
        lambda s: tuple(s.spec), sh["params"],
        is_leaf=lambda x: hasattr(x, "spec"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_jax(mesh):
    _, want = _jax_specs(MESHES[mesh])
    assert _flat(param_specs(TransformerConfig.tiny(), MESHES[mesh])) \
        == _flat(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_shapes_and_zero_summary_equal_jax(mesh):
    axes = MESHES[mesh]
    jmesh, specs = _jax_specs(axes)
    cfg = TransformerConfig.tiny()
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shard = shard_params_at(cfg, full, 0, axes["tp"])
    fshapes = {k: tuple(v.shape) for k, v in _flat(full).items()}
    flat_specs = _flat(specs)
    for k, t in _flat(shard).items():
        assert tuple(t.shape) == _local_shape(
            fshapes[k], jax.sharding.PartitionSpec(*flat_specs[k]), jmesh), k
    tp = TensorParallel(None, None, axes["tp"], 0)
    model = TransformerLM(cfg, shard, device="cpu", tp=tp)
    metas = _leaf_metas(jax_leaf_params(cfg, model))
    n_dp = axes.get("dp", 1)
    want = JZeroPartition([jax.ShapeDtypeStruct(tuple(m.shape), jnp.float32)
                           for m in metas], n_dp).summary()
    assert ZeroPartition(metas, n_dp).summary() == want


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_round_trip_is_bitwise_with_the_wi_split(tp):
    cfg = TransformerConfig.tiny()
    full = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    shards = [shard_params_at(cfg, full, r, tp) for r in range(tp)]
    back = unshard_params(cfg, shards)
    for k, v in _flat(full).items():
        assert torch.equal(_flat(back)[k], v), k
    f = cfg.d_ff // tp
    gate, up = full["layers"]["mlp"]["wi"].chunk(2, dim=-1)
    for r, s in enumerate(shards):
        assert all(t.is_contiguous() for t in _flat(s).values())
        wi = s["layers"]["mlp"]["wi"]
        assert torch.equal(wi[..., :f], gate[..., r * f:(r + 1) * f])
        assert torch.equal(wi[..., f:], up[..., r * f:(r + 1) * f])
        assert wi.untyped_storage().data_ptr() != \
            full["layers"]["mlp"]["wi"].untyped_storage().data_ptr()


@pytest.mark.parametrize("tp", [2, 4])
def test_merge_of_vocab_shards_equals_whole_vocab(tp):
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(24, 32)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 64, size=24))
    rows = 64 // tp
    parts = [fused_ce_fwd(h, e[r * rows:(r + 1) * rows],
                          local_targets(t, rows, r)) for r in range(tp)]
    lse, tl = merge_vocab_shards(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]))
    want_lse, want_tl = fused_ce_fwd(h, e, t)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(tl.numpy(), want_tl.numpy(), rtol=1e-6,
                               atol=0)
    lt = local_targets(t, rows, 1)
    inside = (t >= rows) & (t < 2 * rows)
    assert torch.equal(lt[inside], t[inside] - rows)
    assert bool((lt[~inside] == -1).all())


@pytest.mark.parametrize("dim", ["n_heads", "d_ff", "vocab_size"])
def test_non_dividing_dim_raises_naming_it(dim):
    odd = {"n_heads": 6, "d_ff": 130, "vocab_size": 258}
    kw = {dim: odd[dim]}
    if dim == "n_heads":
        kw["d_model"] = 96
    cfg = TransformerConfig.tiny(**kw)
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if dim == "vocab_size":
        # padded to 260 rows, 65 a shard; the last shard's last 2 are 0
        shards = [shard_params_at(cfg, full, r, 4) for r in range(4)]
        assert [tuple(s["embed"].shape) for s in shards] == [(65, 64)] * 4
        assert torch.equal(shards[3]["embed"][63:], torch.zeros(2, 64))
        assert torch.equal(unshard_params(cfg, shards)["embed"],
                           full["embed"])
        model = TransformerLM(cfg, device="cpu",
                              tp=TensorParallel(None, None, 4, 3))
        assert tuple(model.embed.shape) == (65, 64)
        return
    with pytest.raises(ValueError, match=dim):
        TransformerLM(cfg, device="cpu",
                      tp=TensorParallel(None, None, 4, 0))
    with pytest.raises(ValueError, match=dim):
        shard_params_at(cfg, full, 0, 4)


B, S, D, V = 4, 8, 32, 64


def _case(axes):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"axes": axes, "x": f(6, 16), "w1": f(16, 8), "w2": f(8, 16),
            "gy": f(6, 16), "embed": f(V, D),
            "ids": rng.integers(0, V, size=B * S), "ge": f(B * S, D),
            "h": f(B * S, D) * 0.5, "gl": f(B * S)}


@pytest.fixture(scope="module", params=["tp2", "dp2_tp2"])
def ops(request):
    axes = MESHES[request.param]
    case = _case(axes)
    n = int(np.prod(list(axes.values())))
    ranks = multi_process_runner.run(torch_tp_ranks.ops_rank, n,
                                     args=(case,), device="cpu",
                                     timeout=240).return_values
    return request.param, case, ranks


def _grads(fn, *args):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = fn(*ts)
    return y, ts


def test_boundaries_and_vocab_parallel_pieces_equal_one_rank(ops):
    _, c, ranks = ops
    x, w1, w2 = (torch.from_numpy(c[k]).requires_grad_(True)
                 for k in ("x", "w1", "w2"))
    y = torch.tanh(x @ w1) @ w2
    (y * torch.from_numpy(c["gy"])).sum().backward()
    emb = torch.from_numpy(c["embed"]).requires_grad_(True)
    ids = torch.from_numpy(c["ids"])
    e = emb[ids]
    (e * torch.from_numpy(c["ge"])).sum().backward()
    de_embed = emb.grad.clone()
    h = torch.from_numpy(c["h"]).requires_grad_(True)
    emb.grad = None
    logits = h @ emb.T
    losses = torch.logsumexp(logits, -1) - logits.gather(
        -1, ids[:, None])[:, 0]
    (losses * torch.from_numpy(c["gl"])).sum().backward()
    tol = dict(rtol=0, atol=1e-5)
    for r in ranks:
        tp, i = r["tp"], r["tp_rank"]
        cols, rows = 8 // tp, V // tp
        np.testing.assert_allclose(r["mlp"]["y"], y.detach().numpy(), **tol)
        np.testing.assert_allclose(r["mlp"]["dx"], x.grad.numpy(), **tol)
        np.testing.assert_allclose(
            r["mlp"]["dw1"], w1.grad.numpy()[:, i * cols:(i + 1) * cols],
            **tol)
        np.testing.assert_allclose(
            r["mlp"]["dw2"], w2.grad.numpy()[i * cols:(i + 1) * cols], **tol)
        np.testing.assert_allclose(r["embed"]["y"], e.detach().numpy(),
                                   **tol)
        np.testing.assert_allclose(
            r["embed"]["de"], de_embed.numpy()[i * rows:(i + 1) * rows],
            **tol)
        np.testing.assert_allclose(r["ce"]["losses"],
                                   losses.detach().numpy(), **tol)
        np.testing.assert_allclose(r["ce"]["dh"], h.grad.numpy(), **tol)
        np.testing.assert_allclose(
            r["ce"]["de"], emb.grad.numpy()[i * rows:(i + 1) * rows], **tol)


def test_sharded_fused_ce_matches_jax_interpret(ops):
    name, c, ranks = ops
    axes = MESHES[name]
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    h = jnp.asarray(c["h"].reshape(B, S, D))
    e = jnp.asarray(c["embed"])
    t = jnp.asarray(c["ids"].reshape(B, S).astype(np.int32))
    n_data = axes.get("dp", 1)
    per = B * S // n_data
    for variant in ("b", "a", "split"):
        def total(h, e):
            return jsharded_ce(h, e, t, mesh, implementation="interpret",
                               bwd_variant=variant).sum()
        losses = np.asarray(jsharded_ce(h, e, t, mesh,
                                        implementation="interpret",
                                        bwd_variant=variant)).reshape(-1)
        dh, de = (np.asarray(g) for g in jax.grad(total, (0, 1))(h, e))
        dh = dh.reshape(B * S, D)
        for r in ranks:
            got = r["fused"][variant]
            i, j, rows = r["dp_index"], r["tp_rank"], V // r["tp"]
            sl = slice(i * per, (i + 1) * per)
            tol = dict(rtol=0, atol=1e-5, err_msg=f"{name} {variant}")
            np.testing.assert_allclose(got["losses"], losses[sl], **tol)
            np.testing.assert_allclose(got["dh"], dh[sl], **tol)
            np.testing.assert_allclose(got["de"],
                                       de[j * rows:(j + 1) * rows], **tol)


def test_shard_and_gather_round_trip_on_ranks(ops):
    _, _, ranks = ops
    cfg = TransformerConfig.tiny()
    full = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    for r in ranks:
        assert r["round_trip"] and r["contiguous"]
        want = shard_params_at(cfg, full, r["tp_rank"], r["tp"])
        np.testing.assert_array_equal(r["wi"],
                                      want["layers"]["mlp"]["wi"].numpy())

"""Port parity: the pieces of fully-sharded data parallelism against the
JAX package and the single-rank computation.

- ``param_specs`` equals JAX's ``state_shardings_for`` leaf for leaf on
  ``{"dp": 2, "fsdp": 2, "tp": 2}`` and ``{"fsdp": 4, "tp": 2}`` (host
  logic: exact): every leaf but the norm scales cut on its d_model dim
  over ``fsdp``; a shard's shape is JAX's ``_local_shape``.
- ``shard_params_at`` / ``unshard_params`` over ``fsdp`` and ``fsdp ×
  tp`` (and MoE's ``ep × tp``): the round trip is bitwise, every shard
  contiguous, ``wi``'s gate and up halves cut separately over ``tp``
  and contiguously over ``fsdp``.
- ``d_model`` that ``fsdp`` does not divide raises ``ValueError`` naming
  it (JAX's GSPMD pads).
- Spawned gloo ranks (world 4): ``shard_params`` → ``gather_params`` is
  bitwise on ``{"fsdp": 4}``, ``{"fsdp": 2, "tp": 2}``, ``{"dp": 2,
  "fsdp": 2}`` and MoE's ``{"ep": 2, "tp": 2}``; ``fsdp_gather`` gives
  the whole weight forward and the group's summed gradient slice
  backward.
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
from distributed_tensorflow_tpu.parallel.zero import _local_shape
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, init_params, local_param_shapes,
    param_specs, shard_params_at, unshard_params)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_moe_ranks

MESHES = {"dp2_fsdp2_tp2": {"dp": 2, "fsdp": 2, "tp": 2},
          "fsdp4_tp2": {"fsdp": 4, "tp": 2}}
#: (axes, config kwargs) cut to shards and joined again, in one process
ROUND_TRIPS = {"fsdp2": ({"fsdp": 2}, {}), "fsdp4": ({"fsdp": 4}, {}),
               "fsdp2_tp2": ({"fsdp": 2, "tp": 2}, {}),
               "tp2_fsdp2": ({"tp": 2, "fsdp": 2}, {}),
               "ep2_tp2_fsdp2": ({"ep": 2, "tp": 2, "fsdp": 2},
                                 {"moe_experts": 4})}
#: (axes, config kwargs) of the spawned round trips at world 4
GLOO = [("fsdp4", {"fsdp": 4}, {}), ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, {}),
        ("dp2_fsdp2", {"dp": 2, "fsdp": 2}, {}),
        ("ep2_tp2_moe", {"ep": 2, "tp": 2}, {"moe_experts": 4})]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_specs(axes):
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    cfg = JConfig.tiny()
    sh = state_shardings_for(JModel(cfg), make_optimizer(cfg), mesh,
                             jnp.zeros((8, cfg.max_seq_len), jnp.int32))
    return mesh, jax.tree_util.tree_map(
        lambda s: tuple(s.spec), sh["params"],
        is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_param_specs_and_shapes_equal_jax(mesh):
    axes = MESHES[mesh]
    jmesh, want = _jax_specs(axes)
    cfg = TransformerConfig.tiny()
    got = _flat(param_specs(cfg, axes))
    assert got == _flat(want)
    assert got["embed"] == ("tp", "fsdp")
    assert got["layers/attn/query"] == (None, "fsdp", "tp", None)
    assert got["layers/attn/out"] == (None, "tp", None, "fsdp")
    assert got["layers/RMSNorm_0/scale"] == (None, None)
    full = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    local = _flat(local_param_shapes(cfg, axes))
    for k, spec in got.items():
        assert local[k] == _local_shape(tuple(full[k].shape),
                                        jax.sharding.PartitionSpec(*spec),
                                        jmesh), k


def _rows(shape):
    """Every coordinate over ``shape``'s axes in row-major order."""
    out = [{}]
    for axis, n in shape.items():
        out = [{**c, axis: i} for c in out for i in range(n)]
    return out


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_shard_round_trip_is_bitwise(name):
    axes, kw = ROUND_TRIPS[name]
    cfg = TransformerConfig.tiny(**kw)
    full = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    shards = [shard_params_at(cfg, full, c, axes) for c in _rows(axes)]
    back = unshard_params(cfg, shards, axes)
    for k, v in _flat(full).items():
        assert torch.equal(_flat(back)[k], v), k
    local = _flat(local_param_shapes(cfg, axes))
    for s in shards:
        for k, t in _flat(s).items():
            assert t.is_contiguous() and tuple(t.shape) == local[k], k
    if "mlp" in full["layers"] and "tp" in axes:
        # rank (fsdp f, tp r): gate's and up's r-th column blocks, of
        # the f-th row block
        n_f, n_t = axes["fsdp"], axes["tp"]
        gate, up = full["layers"]["mlp"]["wi"].chunk(2, dim=-1)
        d, fl = cfg.d_model // n_f, cfg.d_ff // n_t
        for c, s in zip(_rows(axes), shards):
            f, r = c["fsdp"], c["tp"]
            wi = s["layers"]["mlp"]["wi"]
            rows = slice(f * d, (f + 1) * d)
            assert torch.equal(wi[:, :, :fl],
                               gate[:, rows, r * fl:(r + 1) * fl])
            assert torch.equal(wi[:, :, fl:],
                               up[:, rows, r * fl:(r + 1) * fl])


def test_d_model_that_fsdp_does_not_divide_raises():
    cfg = TransformerConfig.tiny(d_model=66, n_heads=6)
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="d_model"):
        shard_params_at(cfg, full, {"fsdp": 0}, {"fsdp": 4})
    with pytest.raises(ValueError, match="d_model"):
        TransformerLM(cfg, device="cpu",
                      fsdp=TensorParallel(None, None, 4, 0, "fsdp"))


@pytest.fixture(scope="module")
def gloo_ranks():
    return multi_process_runner.run(
        torch_moe_ranks.jobs_rank, 4,
        args=([("shards", "shards_rank", (GLOO,)),
               ("gather", "fsdp_gather_rank", ())],),
        device="cpu", timeout=300).return_values


@pytest.mark.parametrize("name", [g[0] for g in GLOO])
def test_gather_params_round_trip_on_gloo(gloo_ranks, name):
    axes, kw = dict((g[0], g[1:]) for g in GLOO)[name]
    local = _flat(local_param_shapes(TransformerConfig.tiny(**kw), axes))
    for r in gloo_ranks:
        got = r["shards"][name]
        assert got["round_trip"] and got["contiguous"]
        assert {k: tuple(v) for k, v in got["shapes"].items()} == local


def test_fsdp_gather_forward_and_backward(gloo_ranks):
    """Rank r holds rows [2r, 2r+2) of a (8, 3) weight and weights the
    gathered whole by (r + 1): the forward is the whole weight on every
    rank, the backward this rank's rows of Σ_r (r + 1) = 10."""
    whole = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r in gloo_ranks:
        got = r["gather"]
        np.testing.assert_array_equal(got["y"], whole)
        np.testing.assert_array_equal(got["grad"], np.full((2, 3), 10.0))
        assert got["calls"] == 1 and got["scatters"] == 1

"""``Strategy.init_state(sharding_rules=)`` in the port against the JAX
package's: JAX places each leaf on the 8-device CPU mesh's first 2 or 4
devices by its ``PartitionSpec``; the port, on 2 and 4 gloo ranks,
holds each cut leaf as this rank's block of a ``DistributedVariable``.
Every rank's block equals JAX's addressable shard at the same mesh
coordinate, bit for bit, and its global read equals the whole value."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.cluster import topology as jax_topo
from distributed_tensorflow_tpu.parallel.strategy import Strategy as JStrategy
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_init_state_ranks as ranks

MESHES = {"dp2": ({"dp": 2}, "dp"), "dp4": ({"dp": 4}, "dp"),
          "dp2xtp2": ({"dp": 2, "tp": 2}, "dp_tp")}


def _jax_spec(spec):
    return P() if spec is None else P(*spec)


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for name, (shape, rules) in MESHES.items():
        n = int(np.prod(list(shape.values())))
        out[name] = multi_process_runner.run(
            ranks.init_state_rank, n, args=(shape, rules), device="cpu",
            timeout=300).return_values
    return out


def _jax_shards(shape: dict, rules: str) -> dict:
    """``{leaf: {coords: shard}}`` of JAX's ``init_state`` on a mesh of
    the first devices."""
    n = int(np.prod(list(shape.values())))
    mesh = jax_topo.make_mesh(shape, devices=jax.devices()[:n])
    strategy = JStrategy(mesh=mesh, data_axis_names=("dp",))
    arrays = ranks.state_arrays()
    state = strategy.init_state(
        lambda: {k: jax.numpy.asarray(v) for k, v in arrays.items()},
        sharding_rules={k: _jax_spec(s)
                        for k, s in ranks.RULES[rules].items()})
    names = list(shape)
    ids = np.asarray(mesh.devices)
    coord_of = {d.id: tuple(int(c) for c in np.argwhere(ids == d)[0])
                for d in mesh.devices.flat}
    out = {}
    for k, arr in state.items():
        out[k] = {tuple(zip(names, coord_of[s.device.id])):
                  np.asarray(s.data) for s in arr.addressable_shards}
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_rank_holds_jax_shard_at_its_coordinate(port_runs, mesh):
    shape, rules = MESHES[mesh]
    want = _jax_shards(shape, rules)
    arrays = ranks.state_arrays()
    for r in port_runs[mesh]:
        coords = tuple((n, r["coords"][n]) for n in shape)
        for k, spec in ranks.RULES[rules].items():
            np.testing.assert_array_equal(r["local"][k], want[k][coords])
            np.testing.assert_array_equal(r["global"][k], arrays[k])
            cut = spec is not None and any(e is not None for e in spec)
            assert r["cut"][k] == cut


def test_no_rules_replicates_every_leaf(port_runs):
    """The replicated leaves (spec None) are the whole value everywhere,
    as ``sharding_rules=None`` gives."""
    for runs in port_runs.values():
        for r in runs:
            np.testing.assert_array_equal(r["local"]["b"],
                                          ranks.state_arrays()["b"])

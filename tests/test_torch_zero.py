"""Port parity: ``parallel/zero.py`` — the partition against the JAX
package's, and ZeRO-1/2 against the port's own replicated data
parallelism.

- ``pack`` / ``unpack`` round-trip exactly and the shards tile the
  padded buckets; ``zero_state_bytes`` equals JAX's; ``zero_opt_state``
  refuses an optimizer whose initial state is not zero.
- Over gloo at worlds 2 and 4 (one spawn each for the module), 3 steps
  of ``tiny()`` from one seed: ZeRO-1 is bitwise equal to the replicated
  bucketed step (the update is elementwise on the same gradients); ZeRO-2
  is bitwise at world 2 (a sum of two does not depend on its order) and
  within 1e-6 at world 4; the ranks agree; each rank holds 1/N of the
  moments' elements (plus padding). JAX's own bitwise ZeRO tests fail on
  jax 0.9.0, so the port is held to itself here and to JAX within a
  tolerance in ``test_torch_dp_train.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel.zero import (
    ZeroPartition as JZeroPartition, zero_state_bytes as jzero_state_bytes)
from distributed_tensorflow_tpu_torch.models.transformer import (
    AdamW, TransformerConfig, TransformerLM, make_optimizer)
from distributed_tensorflow_tpu_torch.parallel.zero import (
    ZeroPartition, held_state_bytes, zero_opt_state, zero_state_bytes)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks

STEPS = 3


def test_pack_unpack_roundtrip_and_shards_tile():
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (13,), (2, 2, 2)]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    leaves = [torch.from_numpy(a) for a in arrays]
    part = ZeroPartition(leaves, 4)
    jpart = JZeroPartition([jnp.asarray(a) for a in arrays], 4)
    flats = part.pack(leaves)
    for f, jf in zip(flats, jpart.pack([jnp.asarray(a) for a in arrays])):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert all(f.shape[0] % 4 == 0 for f in flats)
    for a, b in zip(leaves, part.unpack(flats)):
        assert torch.equal(a, b)
    for b_i, flat in enumerate(flats):
        tiles = [part.shard(flats, r)[b_i] for r in range(4)]
        assert torch.equal(torch.cat(tiles), flat)
    assert part.summary() == jpart.summary()
    # a stacked leaf packs as its layers' concatenation
    stacked = ZeroPartition([torch.empty((2, 3), device="meta")], 1)
    flat, = stacked.pack([[torch.ones(3), torch.zeros(3)]])
    assert flat.tolist() == [1, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_zero_state_bytes_equals_jax(n, level):
    for kw in ({}, {"slot_bytes": 6}, {"param_bytes": 2, "grad_bytes": 2}):
        assert zero_state_bytes(234906624, n, level, **kw) == \
            jzero_state_bytes(234906624, n, level, **kw)
    with pytest.raises(ValueError):
        zero_state_bytes(10, n, 3)


@pytest.mark.parametrize("mu_dtype,slot_bytes",
                         [(None, 8), (torch.bfloat16, 6)])
def test_held_state_bytes_matches_analytic(mu_dtype, slot_bytes):
    cfg = TransformerConfig.tiny(adam_mu_dtype=mu_dtype)
    model = TransformerLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(cfg, model.parameters())
    n = sum(p.numel() for p in model.parameters())
    before = held_state_bytes(model, opt)
    assert before == {"param_bytes": 4 * n, "grad_bytes": 0,
                      "moment_bytes": 0, "state_bytes": 4 * n}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, cfg.max_seq_len)))
    model(tokens).float().mean().backward()
    opt.step()
    held = held_state_bytes(model, opt)
    assert held["state_bytes"] == zero_state_bytes(
        n, 1, 0, slot_bytes=slot_bytes)
    assert held["grad_bytes"] == 4 * n


def test_zero_opt_state_refuses_nonzero_init():
    part = ZeroPartition([torch.zeros(8)], 2)

    class Warm(AdamW):
        def moments(self, p, group):
            st = super().moments(p, group)
            st["nu"].fill_(1.0)
            return st

    with pytest.raises(ValueError, match="all-zero"):
        zero_opt_state(lambda ps: Warm(ps, lr=1e-3, weight_decay=0.0),
                       part, part.shard(part.pack([torch.zeros(8)]), 0))
    opt, shards = zero_opt_state(
        lambda ps: AdamW(ps, lr=1e-3, weight_decay=0.0), part,
        part.shard(part.pack([torch.arange(8.0)]), 1))
    assert [s.tolist() for s in shards] == [[4.0, 5.0, 6.0, 7.0]]


@pytest.fixture(scope="module")
def worlds():
    return {n: multi_process_runner.run(
        torch_dp_ranks.zero_rank, n, args=(STEPS,), device="cpu",
        timeout=240).return_values for n in (2, 4)}


def _equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_bitwise_equals_replicated(worlds, world):
    for r in worlds[world]:
        assert r["zero1"]["losses"] == r["rep"]["losses"]
        assert _equal(r["zero1"]["params"], r["rep"]["params"])
        assert _equal(r["zero1"]["params"], worlds[world][0]["zero1"][
            "params"])


@pytest.mark.parametrize("world", [2, 4])
def test_zero2_against_zero1(worlds, world):
    for r in worlds[world]:
        z1, z2 = r["zero1"]["params"], r["zero2"]["params"]
        if world == 2:
            assert _equal(z2, z1)
            assert r["zero2"]["losses"] == r["zero1"]["losses"]
        else:
            for k in z1:
                np.testing.assert_allclose(z2[k], z1[k], rtol=0, atol=1e-6,
                                           err_msg=k)
        assert _equal(z2, worlds[world][0]["zero2"]["params"])


@pytest.mark.parametrize("world", [2, 4])
def test_slots_are_split_n_ways(worlds, world):
    for r in worlds[world]:
        n_params = r["rep"]["n_params"]
        assert r["rep"]["slot_elements"] == 2 * n_params
        for level in ("zero1", "zero2"):
            s = r[level]["summary"]
            assert s["n_shards"] == world
            assert s["elements"] == n_params
            assert r[level]["slot_elements"] == 2 * s["shard_elements"]
            assert s["shard_elements"] * world == s["padded_elements"]
            assert s["padded_elements"] - n_params < world * s["buckets"]

"""Port parity: ``parallel/sequence_parallel.py`` and the sequence-parallel
collectives against the JAX package's on its 8-device CPU mesh.

- The pure parts, exactly: ``stripe_layout`` / ``unstripe_layout``, and
  ``_combine_stats`` on rows with finite, ``+inf`` (a kernel's empty
  row) and ``−inf`` (a skipped block) lse; ``resolve_attn_impl``'s
  choices.
- Worlds 2 and 4 (gloo), one spawn a world that runs every case:
  ``make_ring_attention`` on each rank's chunks of JAX's ``qkv4``
  operands ``(2, 4, 32, 16)`` — the unfused ring and the flash ring
  ("interpret": the kernels' plain versions) causal and not, striped
  (causal) and Ulysses unfused and flash, causal and not — forward and
  ``(dq, dk, dv)`` of ``sum(out²)`` against JAX's ``make_ring_attention``
  with the same ``attn_impl`` at JAX's own tolerances (2e-5 forward,
  1e-4 gradients); striped with one token per rank gives no NaN and
  JAX's output; ``ring_shift`` and its gradient against ``ppermute``,
  ``all_to_all`` against ``jax.lax.all_to_all(tiled=True)``, exactly.
- The refusals: an unknown ``impl``, striped without ``causal``,
  striped with ``"unfused"`` and an unknown ``attn_impl`` raise JAX's
  ``ValueError``; Ulysses with heads that ``sp`` does not divide raises
  ``ValueError`` (JAX asserts); ``"interpret"`` on a CUDA mesh raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel import sequence_parallel as jsp
from distributed_tensorflow_tpu_torch.parallel import (
    sequence_parallel as tsp)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_sp_ranks
from torch_tp_jax import jax_mesh

WORLDS = (2, 4)
#: (impl, attn_impl, causal), as JAX's make_ring_attention takes them
CASES = [("ring", "unfused", True), ("ring", "unfused", False),
         ("ring", "interpret", True), ("ring", "interpret", False),
         ("striped", "interpret", True),
         ("ulysses", "unfused", True), ("ulysses", "unfused", False),
         ("ulysses", "interpret", True), ("ulysses", "interpret", False)]
#: make_ring_attention kwargs refused with JAX's ValueError
REFUSALS = [{"impl": "zigzag"},
            {"impl": "striped", "causal": False, "attn_impl": "interpret"},
            {"impl": "striped", "causal": True, "attn_impl": "unfused"},
            {"attn_impl": "bogus"}]


def _name(impl, attn_impl, causal):
    return f"{impl}-{attn_impl}-{'causal' if causal else 'full'}"


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(11)
    return {"qkv4": rng.normal(size=(3, 2, 4, 32, 16)).astype(np.float32),
            # one token per rank at sp 4 (JAX's test at sp 8, :174)
            "one": rng.normal(size=(3, 2, 4, 4, 16)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_fn(world, impl, attn_impl, causal):
    """JAX's output and the gradients of ``sum(out²)``, one program."""
    fn = jsp.make_ring_attention(jax_mesh({"sp": world}), causal=causal,
                                 impl=impl, attn_impl=attn_impl,
                                 block_q=8, block_k=8)

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2 * out)
    return out_and_grads


def _jax_out_and_grads(world, impl, attn_impl, causal, q, k, v):
    out, grads = _jax_fn(world, impl, attn_impl, causal)(
        *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def port_ranks(qkv):
    runs = {}
    for world in WORLDS:
        cases = [(_name(*c), "qkv4", *c) for c in CASES]
        if world == 4:
            cases.append(("one_token", "one", "striped", "interpret", True))
        runs[world] = multi_process_runner.run(
            torch_sp_ranks.attention_rank, world,
            args=(cases, qkv, REFUSALS), device="cpu",
            timeout=600).return_values
    return runs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: _name(*c))
def test_attention_matches_jax(port_ranks, qkv, world, case):
    ranks = port_ranks[world]
    name = _name(*case)
    want_o, want_g = _jax_out_and_grads(world, *case, *qkv["qkv4"])
    got_o = np.concatenate([r[name]["o"] for r in ranks], axis=2)
    np.testing.assert_allclose(got_o, want_o, rtol=2e-5, atol=2e-5,
                               err_msg=f"sp{world} {name} forward")
    for i, label in enumerate("qkv"):
        got = np.concatenate([r[name]["grads"][i] for r in ranks], axis=2)
        np.testing.assert_allclose(got, want_g[i], rtol=1e-4, atol=1e-4,
                                   err_msg=f"sp{world} {name} d{label}")


def test_striped_one_token_per_rank_no_nan(port_ranks, qkv):
    """Sequence 4 on sp 4: every block with ``src > me`` is strict and
    empty (the kernels' ``+inf`` lse); the merge reads it as no
    contribution, not NaN."""
    ranks = port_ranks[4]
    got = np.concatenate([r["one_token"]["o"] for r in ranks], axis=2)
    assert np.isfinite(got).all()
    want, want_g = _jax_out_and_grads(4, "striped", "interpret", True,
                                      *qkv["one"])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for i in range(3):
        g = np.concatenate([r["one_token"]["grads"][i] for r in ranks], 2)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, want_g[i], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_match_jax(port_ranks, world):
    """``ring_shift`` is ``ppermute`` over ``perm = [(i, i+1 mod n)]``, its
    gradient the reverse shift; ``all_to_all`` is JAX's tiled one."""
    ranks = port_ranks[world]
    mesh = jax_mesh({"sp": world})
    perm = [(i, (i + 1) % world) for i in range(world)]
    shift = shard_map(lambda x: jax.lax.ppermute(x, "sp", perm), mesh=mesh,
                      in_specs=P("sp"), out_specs=P("sp"))
    x = np.concatenate([np.arange(24, dtype=np.float32).reshape(2, 4, 3)
                        + 100 * r for r in range(world)])
    w = np.repeat(np.arange(1, world + 1, dtype=np.float32), 2)[:, None,
                                                                 None]
    want_y = np.asarray(shift(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda a: (shift(a) * w).sum())(jnp.asarray(x)))
    np.testing.assert_array_equal(
        np.concatenate([r["ring_shift"]["y"] for r in ranks]), want_y)
    np.testing.assert_array_equal(
        np.concatenate([r["ring_shift"]["grad"] for r in ranks]), want_g)
    a2a = shard_map(lambda y: jax.lax.all_to_all(y, "sp", 1, 2, tiled=True),
                    mesh=mesh, in_specs=P("sp"), out_specs=P("sp"))
    y = np.concatenate([np.arange(2 * 4 * world * 3, dtype=np.float32)
                        .reshape(2, 4 * world, 3) + 1000 * r
                        for r in range(world)])
    np.testing.assert_array_equal(
        np.concatenate([r["all_to_all"] for r in ranks]),
        np.asarray(a2a(jnp.asarray(y))))


def test_refusals_match_jax(port_ranks):
    for world in WORLDS:
        got = port_ranks[world][0]["refusals"]
        for kw, g in zip(REFUSALS, got):
            with pytest.raises(ValueError):
                jsp.make_ring_attention(jax_mesh({"sp": world}), **kw)
            assert g is not None and g[0] == "ValueError", (kw, g)
        assert "impl=" in got[0][1] and "flash kernel" in got[2][1]


def test_ulysses_and_interpret_refusals():
    """Ulysses with heads that ``sp`` does not divide: JAX asserts, the
    port raises ``ValueError``; ``"interpret"`` (the plain versions) is
    refused on a CUDA mesh; auto is "flash" there, "unfused" on the
    CPU."""
    class _Mesh:
        mesh_dim_names = ("sp",)

        def size(self, i):
            return 4
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError, match="heads 3"):
        tsp.ulysses_attention(q, q, q, _Mesh())
    with pytest.raises(ValueError, match="interpret"):
        tsp.resolve_attn_impl("interpret", "cuda")
    assert tsp.resolve_attn_impl(None, "cuda") == "flash"
    assert tsp.resolve_attn_impl(None, "cpu") == "unfused"
    assert tsp.resolve_attn_impl("interpret", "cpu") == "interpret"


@pytest.mark.parametrize("n", [1, 4, 8])
def test_stripe_layout_matches_jax(n):
    x = np.arange(2 * 3 * 16 * 4, dtype=np.float32).reshape(2, 3, 16, 4)
    s = tsp.stripe_layout(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jsp.stripe_layout(jnp.asarray(x), n)))
    np.testing.assert_array_equal(tsp.unstripe_layout(s, n).numpy(), x)
    np.testing.assert_array_equal(
        tsp.unstripe_layout(torch.from_numpy(x), n).numpy(),
        np.asarray(jsp.unstripe_layout(jnp.asarray(x), n)))


def test_stripe_plan_is_the_global_layout():
    """The relayout of contiguous chunks: each rank's stripe, assembled
    from every rank's sends, is ``stripe_layout``'s block of it — also
    when ``n`` does not divide the chunk."""
    for n, s_local in ((4, 8), (4, 1), (3, 5), (2, 16)):
        seq = np.arange(n * s_local)
        want = jsp.stripe_layout(jnp.asarray(seq)[None, None, :, None], n)
        want = np.asarray(want)[0, 0, :, 0].reshape(n, s_local)
        plans = [tsp.stripe_plan(n, t, s_local) for t in range(n)]
        for r in range(n):
            got = []
            for t, (order, send, recv) in enumerate(plans):
                start = sum(send[:r])
                got += [t * s_local + i for i in order[start:start
                                                          + send[r]]]
                assert plans[r][2][t] == send[r]
            assert got == list(want[r])


def test_combine_stats_matches_jax():
    rng = np.random.default_rng(5)
    o_acc = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    o_b = rng.normal(size=(2, 3, 6, 8)).astype(np.float32)
    lse_acc = rng.normal(size=(2, 3, 6)).astype(np.float32)
    lse_b = rng.normal(size=(2, 3, 6)).astype(np.float32)
    # rows: a kernel's empty row (+inf) on either side, a skipped block
    # (-inf) on either side, both empty, both skipped
    lse_acc[:, :, 0], lse_b[:, :, 1] = np.inf, np.inf
    lse_acc[:, :, 2], lse_b[:, :, 3] = -np.inf, -np.inf
    lse_acc[:, :, 4] = lse_b[:, :, 4] = np.inf
    lse_acc[:, :, 5] = lse_b[:, :, 5] = -np.inf
    o_b[:, :, 1] = 0.0
    got = tsp._combine_stats(*(torch.from_numpy(a) for a in
                               (o_acc, lse_acc, o_b, lse_b)))
    want = jsp._combine_stats(*(jnp.asarray(a) for a in
                                (o_acc, lse_acc, o_b, lse_b)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(w))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    assert np.isneginf(got[1].numpy()[:, :, 4:]).all()
    assert (got[0].numpy()[:, :, 4:] == 0).all()

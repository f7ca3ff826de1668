"""The tensor-core cross-entropy route of
``distributed_tensorflow_tpu_torch.ops.fused_ce`` on the CPU.

The kernels of ``csrc/fused_ce_tc.cu`` run only on the card; what
surrounds them is plain Python and is tested here: the rule that sends a
call to the tensor-core or the CUDA-core kernels (:func:`kernel_route`),
the forward's split of the vocabulary across blocks
(:func:`fwd_vocab_split`), and the merge of the per-slice ``(m, l)``
partials into ``lse`` (:func:`merge_partials_plain`, the plain version of
``fused_ce_lse_merge_kernel``), held against the JAX ``ce_reference`` on
seeded inputs. Tolerance (f32, another summation order): 1e-5 relative
plus 1e-5 absolute on losses near ln V. Also the zero-padding of a bf16
d_model that is no multiple of 8 (:func:`with_padded_d`: pad, plain
version, slice), held against the JAX op in interpret mode and
``jax.grad`` of its ``ce_reference``, and the fragment order of the
variant "a" kernel's dh accumulator (:func:`dh_from_fragment_order`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import fused_ce as jce
from distributed_tensorflow_tpu_torch.ops import fused_ce as tce

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,op,route", [
    (BF16, 1024, "fwd", "tensor_core"),
    (BF16, 1024, "b", "tensor_core"),
    (BF16, 8, "fwd", "tensor_core"),
    (BF16, 1000, "b", "tensor_core"),
    (BF16, 4096, "fwd", "tensor_core"),     # the forward keeps no D on chip
    (BF16, 1024, "a", "tensor_core"),
    (BF16, 1024, "split", "tensor_core"),
    (BF16, 1000, "split", "tensor_core"),
    (F32, 1024, "split", "cuda_core"),
    (F32, 1024, "a", "cuda_core"),
    # d_model no multiple of 8: zero-padded for the tensor cores
    (BF16, 12, "a", "tensor_core"),
    (BF16, 12, "fwd", "tensor_core"),
    (BF16, 1020, "b", "tensor_core"),
    (BF16, 1020, "split", "tensor_core"),
    (BF16, 1020, "fwd", "tensor_core"),
    (BF16, 1020, "a", "tensor_core"),
    (F32, 1024, "fwd", "cuda_core"),
    (F32, 1024, "b", "cuda_core"),
    (F32, 12, "fwd", "cuda_core"),
    (F32, 12, "b", "cuda_core"),
])
def test_kernel_route(dtype, d, op, route):
    assert tce.kernel_route(dtype, d, op) == route


@pytest.mark.parametrize("dtype,d,op,match", [
    (torch.float64, 1032, "b", "dtype"),    # any d: windows above 1024
    (torch.float64, 2048, "b", "dtype"),
    (torch.int32, 2048, "split", "dtype"),
    (torch.float64, 1032, "split", "dtype"),
    (torch.int8, 1032, "a", "dtype"),
    (torch.float64, 1024, "fwd", "dtype"),
    (torch.float64, 1024, "a", "dtype"),
    (BF16, 1024, "c", "op="),
])
def test_kernel_route_refuses(dtype, d, op, match):
    with pytest.raises(ValueError, match=match):
        tce.kernel_route(dtype, d, op)


@pytest.mark.parametrize("n,v,sm,want", [
    (4096, 32768, 132, (32, 8)),    # the train chunk: 32 x 8 = 256 blocks
    (4133, 1000, 132, (1, 8)),      # 33 row tiles, 8 vocab tiles
    (129, 1025, 132, (1, 9)),       # last slice: the tail column alone
    (100, 32768, 132, (1, 256)),    # one row tile: a slice per tile
    (8192, 32768, 132, (64, 4)),
    (50000, 1000, 132, (8, 1)),     # more row tiles than fit: one slice
])
def test_fwd_vocab_split(n, v, sm, want):
    per, slices = tce.fwd_vocab_split(n, v, sm)
    assert (per, slices) == want
    tiles = math.ceil(v / tce.TC_FWD_TILE)
    assert (slices - 1) * per < tiles <= slices * per   # none empty
    rows = math.ceil(n / tce.TC_FWD_TILE)
    assert slices == 1 or rows * slices <= tce.TC_FWD_BLOCKS_PER_SM * sm


def _inputs(n, v, d, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    e = (rng.normal(size=(v, d)) * 0.3).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    return h, e, t


@pytest.mark.parametrize("n,v,d,bounds", [
    # one slice: the plain logsumexp
    (37, 300, 16, [0, 300]),
    # slices of two 128-row tiles, the last the ragged tail alone
    (37, 300, 16, [0, 128, 256, 384]),
    # a slice past V (all -inf, l = 0), as a warp's columns past the
    # vocab tail give in the kernel
    (37, 300, 16, [0, 256, 384, 512]),
    # uneven slices, one of a single column
    (64, 1025, 32, [0, 512, 1024, 1025]),
])
def test_merged_partials_match_jax_reference(n, v, d, bounds):
    h, e, t = _inputs(n, v, d, seed=len(bounds) + v)
    t[:4] = [0, v - 1, min(127, v - 1), min(128, v - 1)]
    want = np.asarray(jce.ce_reference(jnp.asarray(h), jnp.asarray(e),
                                       jnp.asarray(t)))
    th, te, tt = (torch.from_numpy(x) for x in (h, e, t))
    m, l, tl = tce.fwd_partials_plain(th, te, tt, bounds)
    assert m.shape == l.shape == (len(bounds) - 1, n)
    lse = tce.merge_partials_plain(m, l)
    assert torch.isfinite(lse).all()
    np.testing.assert_allclose((lse - tl).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_partials_of_an_empty_slice_add_nothing():
    """A slice with no column has ``(m, l) = (-inf, 0)``, and the merge
    gives the same lse with or without it, wherever it stands."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(20, 200, 8, seed=5))
    m, l, _ = tce.fwd_partials_plain(h, e, t, [0, 128, 200, 256])
    assert torch.isneginf(m[2]).all() and (l[2] == 0).all()
    base = tce.merge_partials_plain(m[:2], l[:2])
    for order in ([2, 0, 1], [0, 2, 1], [0, 1, 2]):
        assert torch.equal(tce.merge_partials_plain(m[order], l[order]),
                           base)
    np.testing.assert_allclose(
        base.numpy(), tce.fused_ce_fwd_plain(h, e, t)[0].numpy(),
        rtol=1e-6, atol=1e-6)


def test_target_outside_vocab_picks_up_zero():
    h, e, t = (torch.from_numpy(x) for x in _inputs(10, 300, 8, seed=6))
    t[0], t[1] = -1, 300
    _, _, tl = tce.fwd_partials_plain(h, e, t, [0, 128, 256, 384])
    assert tl[0].item() == 0.0 and tl[1].item() == 0.0


def test_cpu_bf16_takes_plain_versions_and_counts_nothing():
    """bf16 CPU tensors take the plain versions, whatever route a CUDA
    tensor of that shape would take; no launch is counted."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(20, 300, 16, seed=7))
    h, e = h.to(BF16), e.to(BF16)
    before = (tce.fused_ce_fwd.launches_tc, tce.fused_ce_bwd.launches_tc,
              tce.fused_ce_fwd.launches, tce.fused_ce_bwd.launches)
    lse, tl = tce.fused_ce_fwd(h, e, t)
    plse, ptl = tce.fused_ce_fwd_plain(h, e, t)
    assert torch.equal(lse, plse) and torch.equal(tl, ptl)
    g = torch.full((20,), 0.05)
    dh, de = tce.fused_ce_bwd(h, e, t, lse, g)
    pdh, pde = tce.fused_ce_bwd_plain(h, e, t, lse, g)
    assert dh.dtype == de.dtype == BF16
    assert torch.equal(dh, pdh) and torch.equal(de, pde)
    assert (tce.fused_ce_fwd.launches_tc, tce.fused_ce_bwd.launches_tc,
            tce.fused_ce_fwd.launches, tce.fused_ce_bwd.launches) == before


def test_cpu_bf16_split_takes_plain_versions_and_counts_nothing():
    """bf16 ``"split"``, which a CUDA tensor takes to ``fused_ce_dh_tc``
    and ``fused_ce_de_tc``, runs the plain dh and dE versions on the CPU
    and moves no split counter."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(20, 300, 16, seed=8))
    h, e = h.to(BF16), e.to(BF16)
    assert tce.kernel_route(BF16, 16, "split") == "tensor_core"
    names = ("launches_dh", "launches_de", "launches_dh_tc",
             "launches_de_tc", "launches_tc")
    before = [getattr(tce.fused_ce_bwd, n) for n in names]
    lse, _ = tce.fused_ce_fwd(h, e, t)
    g = torch.full((20,), 0.05)
    dh, de = tce.fused_ce_bwd(h, e, t, lse, g, variant="split")
    assert dh.dtype == de.dtype == BF16
    assert torch.equal(dh, tce.fused_ce_dh_plain(h, e, t, lse, g))
    assert torch.equal(de, tce.fused_ce_de_plain(h, e, t, lse, g))
    assert [getattr(tce.fused_ce_bwd, n) for n in names] == before


def test_cpu_bf16_a_takes_plain_version_and_counts_nothing():
    """bf16 ``"a"``, which a CUDA tensor takes to ``fused_ce_bwd_a_tc``,
    runs the plain version on the CPU and leaves ``launches_a_tc`` (and
    the f32 ``launches_a``) where they were."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(20, 300, 16, seed=9))
    h, e = h.to(BF16), e.to(BF16)
    assert tce.kernel_route(BF16, 16, "a") == "tensor_core"
    before = (tce.fused_ce_bwd.launches_a_tc, tce.fused_ce_bwd.launches_a)
    lse, _ = tce.fused_ce_fwd(h, e, t)
    g = torch.full((20,), 0.05)
    dh, de = tce.fused_ce_bwd(h, e, t, lse, g, variant="a")
    pdh, pde = tce.fused_ce_bwd_plain(h, e, t, lse, g)
    assert dh.dtype == de.dtype == BF16
    assert torch.equal(dh, pdh) and torch.equal(de, pde)
    assert (tce.fused_ce_bwd.launches_a_tc,
            tce.fused_ce_bwd.launches_a) == before


def _padded_port(h, e, t, mask, dtype):
    """Loss and (dh, dE) of ``sum(losses mask) / sum(mask)`` through the
    port's padded path: :func:`with_padded_d` around the plain forward and
    backward, as the wrappers run it around the tensor-core kernels."""
    th, te = (torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
              for x in (h, e))
    tt = torch.from_numpy(t)
    lse, tl = tce.with_padded_d(tce.fused_ce_fwd_plain, th, te, tt)
    g = torch.from_numpy(mask / mask.sum())
    dh, de = tce.with_padded_d(tce.fused_ce_bwd_plain, th, te, tt, lse, g)
    assert dh.shape == th.shape and de.shape == te.shape
    assert dh.dtype == de.dtype == dtype
    return (float(((lse - tl) * g).sum()), dh.float().numpy(),
            de.float().numpy())


def _jax_loss_grads(h, e, t, mask, **kw):
    def f(h, e):
        losses = jce.fused_cross_entropy(h, e, jnp.asarray(t), **kw)
        return (losses * mask).sum() / mask.sum()
    loss, (gh, ge) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e))
    return (float(loss), np.asarray(gh, np.float32),
            np.asarray(ge, np.float32))


def _jax_reference_grads(h, e, t, mask):
    """``jax.grad`` of the JAX ``ce_reference`` (f32, from the inputs'
    values)."""
    def f(h, e):
        losses = jce.ce_reference(h, e, jnp.asarray(t))
        return (losses * mask).sum() / mask.sum()
    loss, (gh, ge) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h, jnp.float32), jnp.asarray(e, jnp.float32))
    return float(loss), np.asarray(gh), np.asarray(ge)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [12, 20])
def test_padded_d_matches_jax(d, dtype):
    """The padded path at a d_model that is no multiple of 8 against the
    JAX op in interpret mode and ``jax.grad`` of ``ce_reference`` on the
    same seeded inputs, at the tolerances of
    ``test_backward_variants_match_jax_interpret``: f32 loss 1e-6
    relative, gradients 1e-5 relative plus 1e-6 absolute; bf16 (the same
    bf16 inputs on both sides, p_adj and the gradients rounded to bf16)
    gradients 2**-7 relative plus one bf16 step of the largest."""
    rng = np.random.default_rng(d)
    n, v = 70, 130
    h = rng.normal(size=(n, d)).astype(np.float32)
    e = (rng.normal(size=(v, d)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    mask = (rng.random(n) > 0.1).astype(np.float32)
    tdt = F32
    if dtype == "bf16":
        h, e = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (h, e))
        tdt = BF16
    got = _padded_port(h, e, t, mask, tdt)
    for want in (_jax_loss_grads(h, e, t, mask, block_n=32, block_v=64,
                                 implementation="interpret"),
                 _jax_reference_grads(h, e, t, mask)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            if dtype == "f32":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                           atol=2.0 ** -8 * np.abs(w).max())


def test_padded_d_adds_nothing_at_a_multiple_of_8():
    """At d_model 16 :func:`with_padded_d` calls the function on the
    inputs themselves; at 12 on zero-padded copies of width 16."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(10, 40, 16, seed=10))
    seen = []

    def fn(hh, ee):
        seen.append((hh, ee))
        return hh * 2, ee * 3

    dh, de = tce.with_padded_d(fn, h, e)
    assert seen[-1][0] is h and seen[-1][1] is e
    dh, de = tce.with_padded_d(fn, h[:, :12].contiguous(),
                               e[:, :12].contiguous())
    ph, pe = seen[-1]
    assert ph.shape == (10, 16) and pe.shape == (40, 16)
    assert (ph[:, 12:] == 0).all() and (pe[:, 12:] == 0).all()
    assert torch.equal(dh, h[:, :12] * 2) and torch.equal(de, e[:, :12] * 3)


@pytest.mark.parametrize("n,d", [(64, 8), (100, 24), (130, 1024)])
def test_dh_fragment_order_round_trip(n, d):
    """:func:`dh_from_fragment_order` reads the accumulator layout that
    ``fused_ce_bwd_a_tc`` writes (its C header states it): an (n, d)
    matrix scattered into that order by the stated formula, rows padded
    to a multiple of 64, comes back exactly, cast to the given dtype."""
    rows = -(-n // tce.TC_A_TOKEN_TILE) * tce.TC_A_TOKEN_TILE
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    r, c = np.meshgrid(np.arange(rows), np.arange(d), indexing="ij")
    lane = 4 * (r % 8) + 2 * ((c % 8) // 4) + (r % 16) // 8
    pos = ((r // 16 * (d // 8) + c // 8) * 32 + lane) * 4 + c % 4
    acc = np.zeros(rows * d, np.float32)
    acc[pos.ravel()] = x.ravel()
    assert len(np.unique(pos)) == rows * d
    got = tce.dh_from_fragment_order(torch.from_numpy(acc), n, d, F32)
    assert got.shape == (n, d) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x[:n])
    got16 = tce.dh_from_fragment_order(torch.from_numpy(acc), n, d, BF16)
    assert torch.equal(got16, torch.from_numpy(x[:n]).to(BF16))

"""Port parity: ``distributed_tensorflow_tpu_torch.ops.fused_ce`` against
the JAX ``ops/fused_ce.py`` on the CPU.

The same numpy inputs go through both packages: the JAX
``fused_cross_entropy`` with its Pallas kernels in interpret mode (as
tests/test_fused_ce.py runs them), the port's through its plain
versions, which is what its wrappers take for a CPU tensor. In interpret
mode the JAX dispatch runs the split backward kernels ``_dh_kernel`` and
``_de_kernel`` (``_bwd_dispatch``: the interpreter does not emulate the
aliased buffer of the merged kernels); they compute the same function as
the merged kernel "b" that the port ports. Tolerances (f32, different
reduction orders): loss 1e-6 relative; dh, dE 1e-5 relative plus 1e-6
absolute, those of tests/test_fused_ce.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import fused_ce as jce
from distributed_tensorflow_tpu_torch.ops import fused_ce as tce


def _inputs(n, v, d, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    e = rng.normal(size=(v, d)).astype(np.float32) * 0.1
    t = rng.integers(0, v, n).astype(np.int32)
    mask = (rng.random(n) > 0.1).astype(np.float32)
    return h, e, t, mask


def _jax(h, e, t, mask, **kw):
    def f(h, e):
        losses = jce.fused_cross_entropy(h, e, jnp.asarray(t), **kw)
        return (losses * mask).sum() / mask.sum()
    loss, (gh, ge) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e))
    return float(loss), np.asarray(gh), np.asarray(ge)


def _port(h, e, t, mask, variant="b"):
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    losses = tce.fused_cross_entropy(th, te, torch.from_numpy(t),
                                     bwd_variant=variant)
    m = torch.from_numpy(mask)
    loss = (losses * m).sum() / m.sum()
    loss.backward()
    return loss.item(), th.grad.numpy(), te.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,v,d,bn,bv", [
    (64, 200, 32, 16, 64),      # unaligned vocab tail
    (128, 256, 64, 64, 128),    # aligned
    (100, 130, 48, 32, 64),     # unaligned rows AND vocab
], ids=["vocab_tail", "aligned", "ragged_rows_and_vocab"])
def test_value_and_grads_match_jax_interpret(n, v, d, bn, bv):
    h, e, t, mask = _inputs(n, v, d)
    want = _jax(h, e, t, mask, block_n=bn, block_v=bv,
                implementation="interpret")
    _close(_port(h, e, t, mask), want)


def test_two_row_chunks_match_jax(monkeypatch):
    """N = 8192 is cut into two 4096-row chunks, each one forward and one
    backward call; the function is unchanged (JAX side: the reference,
    as interpret mode at this N is slow and chunking is no change of
    function)."""
    h, e, t, mask = _inputs(8192, 200, 16, seed=1)
    want = _jax(h, e, t, mask, implementation="reference")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tce.fused_ce_fwd, tce.fused_ce_bwd

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tce, "fused_ce_fwd", counting("fwd", fwd))
    monkeypatch.setattr(tce, "fused_ce_bwd", counting("bwd", bwd))
    _close(_port(h, e, t, mask), want)
    assert calls == {"fwd": 2, "bwd": 2}


def test_plain_versions_match_jax_reference():
    """``fused_ce_fwd_plain`` and ``ce_reference`` against JAX's
    ``ce_reference``; a target outside the vocab picks up 0."""
    h, e, t, _ = _inputs(50, 70, 24, seed=2)
    want = np.asarray(jce.ce_reference(jnp.asarray(h), jnp.asarray(e),
                                       jnp.asarray(t)))
    th, te, tt = torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(t)
    np.testing.assert_allclose(tce.ce_reference(th, te, tt).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    lse, tl = tce.fused_ce_fwd_plain(th, te, tt)
    np.testing.assert_allclose((lse - tl).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    tt[0] = -1
    assert tce.fused_ce_fwd_plain(th, te, tt)[1][0].item() == 0.0


def test_wrapper_dispatch_and_unported_variants():
    """CPU tensors take the plain versions and count no launch, for every
    backward variant; another device raises, and so does an unknown
    variant."""
    h, e, t, _ = (torch.from_numpy(a) for a in _inputs(20, 40, 8, seed=3))
    counters = ("launches", "launches_a", "launches_dh", "launches_de")
    before = (tce.fused_ce_fwd.launches,
              *(getattr(tce.fused_ce_bwd, c) for c in counters))
    lse, tl = tce.fused_ce_fwd(h, e, t)
    g = torch.ones(20)
    want = tce.fused_ce_bwd_plain(h, e, t, lse, g)
    for variant in tce.BWD_VARIANTS:
        dh, de = tce.fused_ce_bwd(h, e, t, lse, g, variant=variant)
        assert torch.equal(dh, want[0]) and torch.equal(de, want[1])
        tce.fused_cross_entropy(h, e, t, bwd_variant=variant)
    assert torch.equal(tce.fused_ce_dh_plain(h, e, t, lse, g), want[0])
    assert torch.equal(tce.fused_ce_de_plain(h, e, t, lse, g), want[1])
    assert (tce.fused_ce_fwd.launches,
            *(getattr(tce.fused_ce_bwd, c) for c in counters)) == before
    with pytest.raises(ValueError):
        tce.fused_ce_fwd(h.to("meta"), e.to("meta"), t.to("meta"))
    for variant in tce.BWD_VARIANTS:
        with pytest.raises(ValueError, match="no kernel"):
            tce.fused_ce_bwd(h.to("meta"), e.to("meta"), t.to("meta"),
                             lse.to("meta"), g.to("meta"), variant=variant)
    with pytest.raises(ValueError, match="bwd_variant"):
        tce.fused_cross_entropy(h, e, t, bwd_variant="c")


def _inputs_dtype(n, v, d, dtype, seed):
    h, e, t, mask = _inputs(n, v, d, seed)
    if dtype == "bf16":    # the same bf16 values in both packages
        h, e = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (h, e))
    return h, e, t, mask


def _port_dtype(h, e, t, mask, variant, dtype):
    th = torch.from_numpy(np.asarray(h, np.float32))
    te = torch.from_numpy(np.asarray(e, np.float32))
    if dtype == "bf16":
        th, te = th.to(torch.bfloat16), te.to(torch.bfloat16)
    th.requires_grad_()
    te.requires_grad_()
    losses = tce.fused_cross_entropy(th, te, torch.from_numpy(t),
                                     bwd_variant=variant)
    m = torch.from_numpy(mask)
    loss = (losses * m).sum() / m.sum()
    loss.backward()
    return (loss.item(), th.grad.float().numpy(), te.grad.float().numpy())


def _jax_dtype(h, e, t, mask, **kw):
    def f(h, e):
        losses = jce.fused_cross_entropy(h, e, jnp.asarray(t), **kw)
        return (losses * mask).sum() / mask.sum()
    loss, (gh, ge) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e))
    return (float(loss), np.asarray(gh, np.float32),
            np.asarray(ge, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["a", "split"])
def test_backward_variants_match_jax_interpret(variant, dtype):
    """dh and dE of ``bwd_variant`` "a" and "split" against the JAX op in
    interpret mode with the same variant (the interpreter runs the split
    kernels #5 and #8 for every variant, ``_bwd_dispatch:472-477``), on a
    ragged row count and vocab tail. bf16: both take the same bf16
    inputs and round ``p_adj`` and the gradients to bf16, so a gradient
    may land one bf16 step (2**-8 relative) from the other's."""
    h, e, t, mask = _inputs_dtype(100, 130, 48, dtype, seed=4)
    want = _jax_dtype(h, e, t, mask, block_n=32, block_v=64,
                      implementation="interpret", bwd_variant=variant)
    got = _port_dtype(h, e, t, mask, variant, dtype)
    if dtype == "f32":
        _close(got, want)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * np.abs(w).max())


@pytest.mark.parametrize("variant", ["b", "a", "split"])
def test_backward_variants_match_grad_of_reference(variant):
    """Each variant's gradients against ``jax.grad`` of JAX's
    ``ce_reference`` in f32, with a padded target (-1, outside the vocab,
    masked out) in the batch, at the tolerances of the interpret
    comparison."""
    h, e, t, mask = _inputs(64, 200, 32, seed=5)
    t[3], mask[3] = -1, 0.0
    want = _jax(h, e, t, mask, implementation="reference")
    _close(_port(h, e, t, mask, variant), want)

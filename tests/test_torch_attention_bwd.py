"""Port parity: the gradient of ``flash_attention`` in
``distributed_tensorflow_tpu_torch.ops.attention`` against the JAX
``custom_vjp`` on the CPU.

The same numpy inputs and output cotangent go through both packages.
The JAX flash kernels (forward and the dq/dkv backward) run in Pallas
interpret mode with 32-row blocks, so the sequence tails are ragged
there too; the port's ``FlashAttention`` function runs the plain
versions, which is what its wrappers take for a CPU tensor. Tolerance
1e-5 absolute (f32; blockwise vs whole-row reduction orders). The plain
backward is also held to autograd through ``mha_reference`` at 1e-5,
including causal rows that see no key (gradient 0 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch.ops import attention as tattn

TOL = 1e-5


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                           (b, h, sq, d)))


def _port_grads(q, k, v, do, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.flash_attention(q, k, v, causal=causal)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


# (Sq, Sk, head_dim, heads, causal): Sq = Sk and Sq < Sk (a causal
# offset), lengths that are no multiple of 64 (nor of the 32-row JAX
# blocks), head_dim 64 and 128
CASES = [(72, 72, 64, 2, True), (72, 72, 64, 2, False),
         (40, 100, 64, 2, True), (100, 100, 128, 3, True),
         (24, 56, 128, 2, False)]


@pytest.mark.parametrize("sq,sk,hd,heads,causal", CASES,
                         ids=[f"q{c[0]}_k{c[1]}_hd{c[2]}_"
                              f"{'causal' if c[4] else 'full'}"
                              for c in CASES])
def test_flash_grads_match_jax_interpret(sq, sk, hd, heads, causal):
    q, k, v, do = _inputs(sq + sk + hd, 1, heads, sq, sk, hd)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, block_q=32,
                                     block_k=32, implementation="interpret")

    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got_o, got = _port_grads(q, k, v, do, causal)
    np.testing.assert_allclose(got_o, np.asarray(want_o), atol=TOL, rtol=0)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,causal", [(40, 40, True), (24, 40, True),
                                          (40, 24, False), (48, 16, True)],
                         ids=["square", "q<k", "full_q>k",
                              "causal_q>k_masked_rows"])
def test_bwd_plain_matches_autograd_through_reference(sq, sk, causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7, 2, 2, sq, sk, 16))
    o, lse = tattn.flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=0.25)
    got = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                          causal=causal, sm_scale=0.25)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.mha_reference(*leaves, causal=causal, sm_scale=0.25).backward(do)
    for name, g, leaf in zip("qkv", got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=TOL,
                                   rtol=0, err_msg=f"d{name}")
    if sq > sk and causal:
        # rows that see no key: lse = +inf, p = 0, so dq = 0 there
        assert torch.isposinf(lse[:, :, :sq - sk]).all()
        assert (got[0][:, :, :sq - sk] == 0).all()


def test_bwd_wrapper_dispatch_on_cpu():
    """A CPU tensor takes the plain backward and counts no launch; any
    other device raises."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 20, 20, 16))
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    before = (tattn.flash_attention_bwd.launches_dq,
              tattn.flash_attention_bwd.launches_dkv)
    got = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                           sm_scale=0.25)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tattn.flash_attention_bwd.launches_dq,
            tattn.flash_attention_bwd.launches_dkv) == before
    with pytest.raises(ValueError):
        tattn.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, lse,
                                                           do)))


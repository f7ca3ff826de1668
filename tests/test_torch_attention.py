"""Port parity: ``distributed_tensorflow_tpu_torch.ops.attention`` against
the JAX ``ops/attention.py`` on the CPU.

The same numpy inputs go through both packages. The JAX flash kernel
runs in Pallas interpret mode (as tests/test_attention.py runs it); the
port runs its plain version, which is what its wrapper takes for a CPU
tensor. Tolerances: masks exact; ``mha_reference`` 1e-6 (f32, same
einsum order); flash ``o``/``lse`` 1e-5 (the Pallas kernel's blockwise
online softmax vs one full softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch.ops import attention as tattn


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


@pytest.mark.parametrize("kw", [
    dict(lengths=[3, 7], q_len=8, kv_len=8, causal=False),
    dict(lengths=[3, 7], q_len=8, kv_len=8, causal=True),
    dict(lengths=[5, 2], q_len=4, kv_len=8, causal=True),
    dict(lengths=[5, 2], q_len=4, kv_len=8, causal=True, causal_offset=1),
    dict(lengths=[5, 8], q_len=1, kv_len=8, causal=True,
         q_positions=[4, 7]),
], ids=["plain", "causal", "q_short", "offset", "q_positions"])
def test_length_valid_mask_exact(kw):
    kw = dict(kw)
    lengths = kw.pop("lengths")
    q_len, kv_len = kw.pop("q_len"), kw.pop("kv_len")
    want = np.asarray(jattn.length_valid_mask(
        jnp.asarray(lengths), q_len, kv_len, **kw))
    if "q_positions" in kw:
        kw["q_positions"] = torch.tensor(kw["q_positions"])
    got = tattn.length_valid_mask(torch.tensor(lengths), q_len, kv_len,
                                  **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    dict(sq=6, sk=10, causal=True),
    dict(sq=10, sk=6, causal=True),                 # fully-masked rows
    dict(sq=8, sk=8, causal=False, lengths=[5, 8]),
    dict(sq=8, sk=8, causal=True, lengths=[3, 8]),
    dict(sq=1, sk=8, causal=True, lengths=[5, 8], q_positions=[4, 7]),
], ids=["causal_q<k", "causal_q>k", "lengths", "causal_lengths",
        "decode_q_positions"])
def test_mha_reference_matches_jax(case):
    q, k, v = _qkv(1, 2, 2, case["sq"], case["sk"], 16)
    jkw, tkw = {}, {}
    for name in ("lengths", "q_positions"):
        if name in case:
            jkw[name] = jnp.asarray(case[name])
            tkw[name] = torch.tensor(case[name])
    want = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=case["causal"], **jkw))
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=case["causal"],
                              **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# Shapes with q/k lengths that are not block multiples (block 16), and
# q_len > k_len causal cases whose fully-masked rows fill whole q-blocks:
# the Pallas kernel zeroes a fully-masked row only when its whole q-block
# sees no key (a masked row sharing a q-block with visible rows gets the
# mean of v there), while the port zeroes every such row.
FLASH_CASES = [
    dict(sq=40, sk=40, causal=True),
    dict(sq=24, sk=40, causal=False),
    dict(sq=16, sk=40, causal=True),
    dict(sq=48, sk=16, causal=True),      # rows 0..31 see no key
    dict(sq=40, sk=24, causal=True),      # rows 0..15 see no key
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"q{c['sq']}_k{c['sk']}_"
                              f"{'causal' if c['causal'] else 'full'}"
                              for c in FLASH_CASES])
def test_flash_plain_matches_jax_interpret(case):
    q, k, v = _qkv(2, 2, 2, case["sq"], case["sk"], 16)
    sm_scale = 16 ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_o = np.asarray(jattn.flash_attention(
        jq, jk, jv, causal=case["causal"], block_q=16, block_k=16,
        implementation="interpret"))
    _, want_lse = jattn._flash_forward(jq, jk, jv, sm_scale, case["causal"],
                                       16, 16, True)
    want_lse = np.asarray(want_lse)
    o, lse = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=case["causal"], sm_scale=sm_scale)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[fin], want_lse[fin], atol=1e-5,
                               rtol=0)
    masked = ~fin
    assert (masked.sum() > 0) == (case["sq"] > case["sk"] and case["causal"])
    assert np.all(o.numpy()[masked] == 0)
    assert np.all(np.isposinf(lse.numpy()[masked]))


def test_plain_zeroes_every_fully_masked_row():
    """q_len > k_len causal with masked rows sharing a block with visible
    ones: the port's rows match mha_reference (o = 0 where no key is
    visible), whatever the tiling."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 40, 16, 16))
    o, lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                         sm_scale=0.25)
    want = jattn.mha_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), causal=True,
                               sm_scale=0.25)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.isposinf(lse[:, :, :24]).all()
    assert torch.isfinite(lse[:, :, 24:]).all()


def test_wrapper_dispatch_on_cpu():
    """A CPU tensor takes the plain version and counts no launch; the
    public op returns its ``o`` and, where a gradient is needed, records
    one through its backward (``flash_attention_fwd`` itself records
    none); an unknown device raises."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 20, 20, 16))
    before = tattn.flash_attention_fwd.launches
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    po, plse = tattn.flash_attention_plain(q, k, v, causal=True,
                                           sm_scale=0.25)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert torch.equal(tattn.flash_attention(q, k, v, causal=True), po)
    assert tattn.flash_attention_fwd.launches == before
    qg = q.clone().requires_grad_()
    assert tattn.flash_attention_fwd(qg, k, v)[0].grad_fn is None
    assert tattn.flash_attention(qg, k, v).grad_fn is not None
    with torch.no_grad():
        assert tattn.flash_attention(qg, k, v).grad_fn is None
    with pytest.raises(ValueError):
        tattn.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


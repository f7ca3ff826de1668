"""The tensor-core attention route of
``distributed_tensorflow_tpu_torch.ops.attention`` on the CPU.

The kernels of ``csrc/flash_tc.cu`` run only on the card; what surrounds
them is tested here: the rule that sends a CUDA call to the tensor-core
or the CUDA-core kernels (:func:`attention_route`, exact), the CPU
dispatch of bf16 tensors (plain versions, no launch counted), and the
rounding point the bf16 kernels share with Pallas. The JAX kernels round
``p`` to bf16 before ``p v`` (and before ``p^T do``); the port's plain
versions, which ``chip_smoke.py`` holds the kernels against on the card,
keep ``p`` in f32 for ``p v``. On the same bf16 inputs the two agree
within ``chip_smoke.py``'s bf16 tolerances, read from there:
``TOL["bfloat16"]["o"]`` (absolute, on ``o``) and ``GRAD_TOL["bfloat16"]``
(largest error over the largest magnitude, on ``dq``, ``dk``, ``dv``).
The JAX side runs its Pallas kernels in interpret mode with 32-row
blocks, as ``tests/test_torch_attention_bwd.py`` does. A head dim below
128 other than 64 is zero-padded for the kernels
(:func:`with_padded_head`); the padded path (pad, plain version, slice)
is held to the JAX flash attention and to its ``mha_reference`` at
those tolerances, in bf16 and f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, TOL, rel_err
from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch.ops import attention as tattn

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,op,route", [
    (BF16, 64, "fwd", "tc"),
    (BF16, 64, "dq", "tc"),
    (BF16, 64, "dkv", "tc"),
    (BF16, 128, "fwd", "tc"),
    (BF16, 128, "dq", "tc"),
    (BF16, 128, "dkv", "tc"),
    (F32, 64, "fwd", "cuda_cores"),
    (F32, 64, "dq", "cuda_cores"),
    (F32, 64, "dkv", "cuda_cores"),
    (F32, 128, "fwd", "cuda_cores"),
    (F32, 128, "dq", "cuda_cores"),
    (F32, 128, "dkv", "cuda_cores"),
    # zero-padded to 64 or 128 for the kernels
    (BF16, 32, "fwd", "tc"),
    (BF16, 96, "dkv", "tc"),
    (F32, 96, "dq", "cuda_cores"),
    (BF16, 80, "dq", "tc"),
    (F32, 32, "fwd", "cuda_cores"),
])
def test_attention_route(dtype, hd, op, route):
    assert tattn.attention_route(dtype, hd, op) == route


@pytest.mark.parametrize("hd,kd", [(1, 64), (16, 64), (32, 64), (64, 64),
                                   (65, 128), (80, 128), (96, 128),
                                   (128, 128), (129, 256), (160, 256),
                                   (256, 256)])
def test_kernel_head_dim(hd, kd):
    assert tattn.kernel_head_dim(hd) == kd


@pytest.mark.parametrize("dtype,hd,op,match", [
    (torch.float64, 64, "fwd", "dtype"),
    (torch.int8, 64, "dkv", "dtype"),
    (BF16, 257, "fwd", "head_dim"),         # above 256: no kernel
    (torch.float16, 512, "dkv", "head_dim"),
    (F32, 320, "dq", "head_dim"),
    (BF16, 64, "bwd", "op="),
])
def test_attention_route_refuses(dtype, hd, op, match):
    with pytest.raises(ValueError, match=match):
        tattn.attention_route(dtype, hd, op)


def _counters():
    return (tattn.flash_attention_fwd.launches,
            tattn.flash_attention_fwd.launches_tc,
            tattn.flash_attention_bwd.launches_dq,
            tattn.flash_attention_bwd.launches_dq_tc,
            tattn.flash_attention_bwd.launches_dkv,
            tattn.flash_attention_bwd.launches_dkv_tc)


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                           (b, h, sq, d)))


def test_cpu_bf16_takes_the_plain_versions():
    """A CPU bf16 tensor, whose CUDA calls would take the tensor cores,
    goes through the plain versions and moves no flash counter."""
    q, k, v, do = (torch.from_numpy(a).to(BF16)
                   for a in _inputs(3, 1, 2, 40, 70, 64))
    before = _counters()
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    po, plse = tattn.flash_attention_plain(q, k, v, causal=True,
                                           sm_scale=0.125)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    got = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                           sm_scale=0.125)
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.flash_attention(*leaves, causal=True).backward(do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert _counters() == before


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cpu_bf16_dq_counts_no_tc_launch(causal):
    """bf16 dq, which a CUDA tensor takes to ``flash_bwd_dq_tc``, runs the
    plain version on the CPU and moves neither dq counter; the kernel
    wrapper itself refuses a CPU tensor rather than fall back."""
    q, k, v, do = (torch.from_numpy(a).to(BF16)
                   for a in _inputs(5, 1, 2, 70, 40, 64))
    assert tattn.attention_route(BF16, 64, "dq") == "tc"
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=causal)
    delta = (o.float() * do.float()).sum(-1)
    before = _counters()
    dq, _, _ = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want, _, _ = tattn.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, sm_scale=0.125)
    assert dq.dtype == BF16 and torch.equal(dq, want)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.launch_bwd_dq(q, k, v, do, lse, delta, sm_scale=0.125,
                            causal=causal, causal_offset=40 - 70)
    assert _counters() == before


# (Sq, Sk, head_dim, heads, causal): ragged tails against the 32-row JAX
# blocks, a causal offset, hd 128, and rows that see no key (Sq > Sk,
# causal: rows 0-63, two whole JAX q-blocks, since the Pallas kernel
# gives o = 0 only where a whole q-block sees no key)
CASES = [(72, 72, 64, 2, True), (40, 100, 64, 2, True),
         (96, 32, 64, 2, True), (65, 65, 128, 1, True),
         (24, 56, 128, 2, False)]
IDS = [f"q{c[0]}_k{c[1]}_hd{c[2]}_{'causal' if c[4] else 'full'}"
       for c in CASES]


def _jax_flash(causal):
    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, block_q=32,
                                     block_k=32, implementation="interpret")
    return f


def _t(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.mark.parametrize("sq,sk,hd,heads,causal", CASES, ids=IDS)
def test_bf16_rounding_point_forward(sq, sk, hd, heads, causal):
    q, k, v, _ = _inputs(sq * sk + hd, 1, heads, sq, sk, hd)
    want = _jax_flash(causal)(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)))
    got, _ = tattn.flash_attention_plain(
        *(torch.from_numpy(a).to(BF16) for a in (q, k, v)), causal=causal,
        sm_scale=hd ** -0.5)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    err = (got.float() - _t(want)).abs().max().item()
    assert err <= TOL["bfloat16"]["o"], err


@pytest.mark.parametrize("sq,sk,hd,heads,causal", CASES, ids=IDS)
def test_bf16_rounding_point_backward(sq, sk, hd, heads, causal):
    q, k, v, do = _inputs(sq + 3 * sk + hd, 1, heads, sq, sk, hd)
    _, vjp = jax.vjp(_jax_flash(causal),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    leaves = [torch.from_numpy(a).to(BF16).requires_grad_()
              for a in (q, k, v)]
    tattn.flash_attention(*leaves, causal=causal).backward(
        torch.from_numpy(do).to(BF16))
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == BF16
        err = rel_err(leaf.grad, _t(w))
        assert err <= GRAD_TOL["bfloat16"], (f"d{name}", err)
    if causal and sq > sk:
        # rows that see no key: dq = 0 on both sides
        assert (leaves[0].grad[:, :, :sq - sk] == 0).all()
        assert (_t(want[0])[:, :, :sq - sk] == 0).all()


# (Sq, Sk, head_dim, causal): head dims the kernels take only zero-padded
PAD_CASES = [(40, 72, 32, True), (40, 72, 32, False), (72, 40, 80, True),
             (56, 56, 80, False)]
PAD_IDS = [f"q{c[0]}_k{c[1]}_hd{c[2]}_{'causal' if c[3] else 'full'}"
           for c in PAD_CASES]


def _padded_fwd(q, k, v, causal):
    """The port's padded forward: pad, plain version, slice."""
    return tattn.with_padded_head(
        tattn.flash_attention_plain, (q, k, v), causal=causal,
        sm_scale=q.shape[-1] ** -0.5)


def _padded_bwd(q, k, v, o, lse, do, causal):
    """The port's padded backward (o and do padded with q, k, v)."""
    def plain(q, k, v, o, do):
        return tattn.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                               causal=causal, sm_scale=scale)
    scale = q.shape[-1] ** -0.5
    return tattn.with_padded_head(plain, (q, k, v, o, do))


def _jax_inputs(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return [jnp.asarray(a, jdt) for a in arrays]


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("sq,sk,hd,causal", PAD_CASES, ids=PAD_IDS)
def test_padded_head_forward(sq, sk, hd, causal, dtype):
    """The padded forward at hd 32 (to 64) and 80 (to 128) against the
    JAX flash attention (interpret) and ``mha_reference``: ``o`` within
    ``TOL[dtype]["o"]``, of the true head dim, and ``lse`` that of the
    unpadded plain version within f32 rounding (+inf on rows that see no
    key)."""
    q, k, v, _ = _inputs(sq * hd + sk, 1, 2, sq, sk, hd)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    o, lse = _padded_fwd(tq, tk, tv, causal)
    assert o.shape == tq.shape and o.dtype == dtype
    _, plain_lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal,
                                               sm_scale=hd ** -0.5)
    torch.testing.assert_close(lse, plain_lse, rtol=1e-5, atol=1e-5)
    tol = TOL["bfloat16" if dtype == BF16 else "float32"]["o"]
    jq, jk, jv = _jax_inputs((q, k, v), dtype)
    for want in (_jax_flash(causal)(jq, jk, jv),
                 jattn.mha_reference(jq, jk, jv, causal=causal)):
        err = (o.float() - _t(want)).abs().max().item()
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("sq,sk,hd,causal", PAD_CASES, ids=PAD_IDS)
def test_padded_head_backward(sq, sk, hd, causal, dtype):
    """The padded backward against ``jax.vjp`` of the JAX flash attention
    (interpret) and of ``mha_reference``: dq, dk, dv within
    ``GRAD_TOL[dtype]`` of the largest, of the true head dim."""
    q, k, v, do = _inputs(sq + sk * hd, 1, 2, sq, sk, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, lse = _padded_fwd(tq, tk, tv, causal)
    got = _padded_bwd(tq, tk, tv, o, lse, tdo, causal)
    tol = GRAD_TOL["bfloat16" if dtype == BF16 else "float32"]
    jq, jk, jv, jdo = _jax_inputs((q, k, v, do), dtype)
    for f in (_jax_flash(causal),
              lambda q, k, v: jattn.mha_reference(q, k, v, causal=causal)):
        _, vjp = jax.vjp(f, jq, jk, jv)
        for name, g, w in zip("qkv", got, vjp(jdo)):
            assert g.shape == tq.shape[:2] + g.shape[2:3] + (hd,)
            assert g.dtype == dtype
            err = rel_err(g, _t(w))
            assert err <= tol, (f"d{name}", err)


def test_padded_head_passes_kernel_dims_through():
    """At head dim 64 :func:`with_padded_head` calls the function on the
    tensors themselves; at 48 on zero-padded copies, whose 4-D outputs it
    slices back and whose 3-D ``lse`` it passes as it is."""
    seen = []

    def fn(q, k):
        seen.append((q, k))
        return q * 2, q.sum(-1)

    q, k = torch.ones(1, 2, 5, 64), torch.ones(1, 2, 7, 64)
    tattn.with_padded_head(fn, (q, k))
    assert seen[-1][0] is q and seen[-1][1] is k
    o, lse = tattn.with_padded_head(fn, (q[..., :48].contiguous(),
                                         k[..., :48].contiguous()))
    assert seen[-1][0].shape == (1, 2, 5, 64)
    assert (seen[-1][0][..., 48:] == 0).all()
    assert o.shape == (1, 2, 5, 48) and lse.shape == (1, 2, 5)
    assert (lse == 48).all()

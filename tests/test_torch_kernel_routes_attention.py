"""Port parity for the attention routes of ROADMAP C-2: the plain
versions the new kernels are held to on the card, against JAX's flash
attention (its Pallas kernels in interpret mode) on the same numpy
inputs.

- f16 attention: ``o``, ``lse``, ``dq``, ``dk``, ``dv`` of the port's
  plain versions (``p`` rounded to f16 before ``p v``, as the Pallas
  kernel rounds it to the input dtype). Tolerances ``chip_smoke.py``'s
  ``TOL["float16"]`` (absolute, on ``o`` and ``lse``) and
  ``GRAD_TOL["float16"]`` (largest error over the largest magnitude, on
  the gradients).
- head dims 160 and 256 through :func:`with_padded_head` (160 padded to
  256, 256 as it is) in f32, bf16 and f16, forward and backward, at the
  ``TOL``/``GRAD_TOL`` of each dtype.

The cross-entropy and AdamW routes are in
``tests/test_torch_kernel_routes_parity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, TOL, rel_err
from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu_torch.ops import attention as tattn

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
NAME = {F32: "float32", BF16: "bfloat16", F16: "float16"}


def _t(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _attn_inputs(seed, sq, sk, hd, heads=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, heads, sq, hd), (1, heads, sk, hd),
                           (1, heads, sk, hd), (1, heads, sq, hd)))


def _jax_flash(causal):
    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, block_q=32,
                                     block_k=32, implementation="interpret")
    return f


def _port_attention(arrays, dtype, causal):
    """The port's padded forward and backward: pad the head dim, plain
    versions, slice back (the kernels' wrapper path on the CPU)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    sm = q.shape[-1] ** -0.5
    o, lse = tattn.with_padded_head(tattn.flash_attention_plain, (q, k, v),
                                    causal=causal, sm_scale=sm)

    def bwd(q, k, v, o, do):
        return tattn.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                               causal=causal, sm_scale=sm)
    return o, lse, tattn.with_padded_head(bwd, (q, k, v, o, do))


def _check_attention(arrays, dtype, causal):
    name = NAME[dtype]
    o, lse, grads = _port_attention(arrays, dtype, causal)
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    hd = jq.shape[-1]
    want_o, vjp = jax.vjp(_jax_flash(causal), jq, jk, jv)
    assert o.dtype == dtype and o.shape == jq.shape
    err = (o.float() - _t(want_o)).abs().max().item()
    assert err <= TOL[name]["o"], ("o", err)
    _, want_lse = jattn._flash_forward(jq, jk, jv, hd ** -0.5, causal, 32,
                                       32, True)
    want_lse = _t(want_lse).reshape(lse.shape)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    err = (lse[fin] - want_lse[fin]).abs().max().item()
    assert err <= TOL[name]["lse"], ("lse", err)
    for n, g, w in zip("qkv", grads, vjp(jdo)):
        assert g.dtype == dtype and g.shape[-1] == hd
        err = rel_err(g, _t(w))
        assert err <= GRAD_TOL[name], (f"d{n}", err)


@pytest.mark.parametrize("sq,sk,hd,causal", [
    (72, 72, 64, True), (40, 100, 64, True), (96, 32, 64, True),
    (65, 65, 128, True), (24, 56, 128, False), (40, 72, 32, False)],
    ids=["q72_k72_hd64_causal", "q40_k100_hd64_causal",
         "q96_k32_hd64_causal", "q65_k65_hd128_causal",
         "q24_k56_hd128_full", "q40_k72_hd32_full"])
def test_f16_attention_matches_jax_interpret(sq, sk, hd, causal):
    _check_attention(_attn_inputs(sq * 7 + sk + hd, sq, sk, hd), F16,
                     causal)


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["f32", "bf16",
                                                          "f16"])
@pytest.mark.parametrize("sq,sk,hd,causal", [
    (40, 72, 160, True), (48, 48, 256, True), (40, 64, 256, False)],
    ids=["q40_k72_hd160_causal", "q48_k48_hd256_causal",
         "q40_k64_hd256_full"])
def test_wide_head_matches_jax_interpret(sq, sk, hd, causal, dtype):
    assert tattn.kernel_head_dim(hd) == 256
    _check_attention(_attn_inputs(sq + sk * 3 + hd, sq, sk, hd, heads=1),
                     dtype, causal)

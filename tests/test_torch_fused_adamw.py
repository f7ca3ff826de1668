"""Port parity: ``distributed_tensorflow_tpu_torch.ops.fused_adamw``
against the JAX ``ops/fused_adamw.py`` on the CPU.

The same numpy parameters, moments and gradients go through the JAX
``fused_adamw_update`` with its Pallas kernel in interpret mode and
through the port's, which takes its plain version for CPU tensors.
Tolerances: parameters and f32 moments 1e-6 absolute (values of order 1,
f32 arithmetic in the same order); a bf16 ``mu`` within one bf16 step
(2**-8 relative) of the JAX one, as an f32 difference in the last bit
can round it to the neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import fused_adamw as jfa
from distributed_tensorflow_tpu_torch.models import transformer as ttf
from distributed_tensorflow_tpu_torch.ops import fused_adamw as tfa

SHAPES = {"embed": (40, 128), "scale": (130,), "odd": (3, 7, 5)}
HYPER = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(mu_dtype, steps):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(steps)]
    jd, td = ((jnp.bfloat16, torch.bfloat16) if mu_dtype == "bf16"
              else (jnp.float32, torch.float32))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {k: jnp.zeros(s, jd) for k, s in SHAPES.items()}
    jv = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    jc = jnp.zeros((), jnp.int32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tm = {k: torch.zeros(s, dtype=td) for k, s in SHAPES.items()}
    tv = {k: torch.zeros(s) for k, s in SHAPES.items()}
    tc = 0
    for g in grads:
        jp, jm, jv, jc = jfa.fused_adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jm, jv, jc,
            implementation="interpret", **HYPER)
        out = tfa.fused_adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tm, tv, tc,
            **HYPER)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        tc = out[3]
    assert tc == int(jc) == steps
    f = lambda t: {k: np.asarray(jnp.asarray(v, jnp.float32))  # noqa: E731
                   for k, v in t.items()}
    g = lambda t: {k: v.float().numpy() for k, v in t.items()}  # noqa: E731
    return (g(tp), g(tm), g(tv)), (f(jp), f(jm), f(jv))


@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_four_steps_match_jax_interpret(mu_dtype):
    (tp, tm, tv), (jp, jm, jv) = _run_both(mu_dtype, 4)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(tv[k], jv[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        if mu_dtype == "f32":
            np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(tm[k], jm[k], rtol=2.0 ** -8,
                                       atol=0, err_msg=k)


@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_reference_matches_jax_reference(mu_dtype):
    rng = np.random.default_rng(1)
    p, g, m, v = (rng.normal(size=(64, 33)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if mu_dtype == "bf16"
              else (jnp.float32, torch.float32))
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    c1, c2 = tfa.bias_corrections(6, 0.9, 0.999)
    want = jfa.adamw_reference(jnp.asarray(p), jnp.asarray(g),
                               jnp.asarray(m, jd), jnp.asarray(v),
                               jnp.float32(c1), jnp.float32(c2), **kw)
    got = tfa.adamw_reference(torch.from_numpy(p), torch.from_numpy(g),
                              torch.from_numpy(m).to(td),
                              torch.from_numpy(v), c1, c2, **kw)
    for x, w in zip(got, want):
        assert str(x.dtype) == f"torch.{w.dtype}"
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2.0 ** -8
                                   if x.dtype == torch.bfloat16 else 0,
                                   atol=1e-6)


def test_bias_corrections_are_f32_of_the_next_count():
    c1, c2 = tfa.bias_corrections(0, 0.9, 0.999)
    assert c1 == pytest.approx(10.0, rel=1e-6)
    assert c2 == pytest.approx(1000.0, rel=1e-4)
    assert np.float32(c1) == c1 and np.float32(c2) == c2
    t = jnp.float32(1000)
    want = 1.0 / (1.0 - jnp.power(0.9, t))
    assert tfa.bias_corrections(999, 0.9, 0.999)[0] == pytest.approx(
        float(want), rel=1e-7)


def test_b1_stays_f32_for_a_bf16_mu():
    """``mu = 1`` (bf16) and ``g = -8.984375``: 0.9 - 0.1 · 8.984375 in
    f32 is 0.00156402587890625 in both packages' fused update; the port's
    ``AdamW`` (optax's semantics) multiplies by bf16(0.9) = 0.8984375
    and lands near 0 instead."""
    want = 0.00156402587890625
    g = -8.984375
    _, jm, _, _ = jfa.fused_adamw_update(
        {"w": jnp.zeros((8,))}, {"w": jnp.full((8,), g)},
        {"w": jnp.ones((8,), jnp.bfloat16)}, {"w": jnp.zeros((8,))},
        jnp.zeros((), jnp.int32), lr=1e-3, implementation="interpret")
    assert np.all(np.asarray(jm["w"], np.float32) == want)
    tm = {"w": torch.ones(8, dtype=torch.bfloat16)}
    tfa.fused_adamw_update({"w": torch.zeros(8)}, {"w": torch.full((8,), g)},
                           tm, {"w": torch.zeros(8)}, 0, lr=1e-3)
    assert torch.all(tm["w"].float() == want)

    p = torch.nn.Parameter(torch.zeros(8))
    opt = ttf.AdamW([p], lr=1e-3, weight_decay=0.0, mu_dtype=torch.bfloat16)
    opt.state[p].update(count=0, mu=torch.ones(8, dtype=torch.bfloat16),
                        nu=torch.zeros(8))
    p.grad = torch.full((8,), g)
    opt.step()
    assert abs(opt.state[p]["mu"][0].item()) < 1e-7


def test_wrapper_dispatch_on_cpu():
    """Lists as well as dicts; CPU tensors count no launch; another
    device, a mismatched structure and a bad dtype raise."""
    before = tfa.fused_adamw_update.launches
    p, g = [torch.ones(5)], [torch.full((5,), 0.5)]
    m, v = [torch.zeros(5)], [torch.zeros(5)]
    _, _, _, count = tfa.fused_adamw_update(p, g, m, v, 3, lr=0.1)
    assert count == 4 and tfa.fused_adamw_update.launches == before
    c1, c2 = tfa.bias_corrections(3, 0.9, 0.999)
    want = tfa.adamw_reference(torch.ones(5), g[0], torch.zeros(5),
                               torch.zeros(5), c1, c2, lr=0.1, b1=0.9,
                               b2=0.999, eps=1e-8, wd=0.0)
    assert torch.equal(p[0], want[0]) and torch.equal(m[0], want[1])
    with pytest.raises(ValueError, match="number of tensors"):
        tfa.fused_adamw_update(p, g + g, m, v, 0, lr=0.1)
    meta = [torch.ones(5, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        tfa.fused_adamw_update(meta, meta, meta, meta, 0, lr=0.1)
    with pytest.raises(ValueError, match="float32"):
        tfa._check_leaf(torch.ones(5, dtype=torch.bfloat16), g[0], m[0],
                        v[0])

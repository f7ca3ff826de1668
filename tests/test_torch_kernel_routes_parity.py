"""Port parity for the cross-entropy and AdamW routes of ROADMAP C-2:
the plain versions the new kernels are held to on the card, against the
JAX ops on the same numpy inputs (the Pallas kernels in interpret mode).

- the cross-entropy backward at d_model 1536 and 2304 through the
  kernels' column-window loop (:func:`_over_windows` over
  :func:`kernel_windows`) on the plain versions, each variant, against
  ``jax.vjp`` of ``fused_cross_entropy(implementation="interpret")``:
  f32 at ``rtol=1e-5`` and ``atol`` 1e-5 of the largest (f32 logits
  summed over up to 2304 products in another order than the Pallas
  kernel's 64-column blocks); bf16 within one bf16 step
  (``rtol=2**-7``, ``atol=2**-8`` of the largest), as
  ``tests/test_torch_fused_ce.py`` holds bf16.
- f16 cross-entropy, the public op in each backward variant: the loss
  within ``rtol=1e-6`` (f32 sums of the same f16 products), ``dh`` and
  ``dE`` within one f16 step (``rtol=2**-10``, ``atol=2**-11`` of the
  largest).
- #9's plain update with bf16 and f16 ``p`` and ``g`` (f32 and 16-bit
  moments) over four steps against JAX's ``fused_adamw_update`` in
  interpret mode: f32 outputs within ``1e-6`` absolute; 16-bit ones
  within one unit in the last place of their dtype (``2**-7`` relative
  in bf16, ``2**-10`` in f16), of the value or of the tensor's largest
  (a last-bit f32 difference that rounds a parameter to the neighbouring
  16-bit value at one step carries that step into the next).

The attention routes are in ``tests/test_torch_kernel_routes_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import fused_adamw as jfa
from distributed_tensorflow_tpu.ops import fused_ce as jce
from distributed_tensorflow_tpu_torch.ops import fused_adamw as tfa
from distributed_tensorflow_tpu_torch.ops import fused_ce as tce

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}


def _ce_inputs(n, v, d, dtype, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    e = (rng.normal(size=(v, d)) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    g = rng.random(n).astype(np.float32)
    # the same 16-bit values on both sides
    h, e = (np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))
            for x in (h, e))
    return h, e, t, g


def _jax_ce(h, e, t, g, dtype, **kw):
    jh, je = (jnp.asarray(x, JDT[dtype]) for x in (h, e))
    losses, vjp = jax.vjp(lambda h, e: jce.fused_cross_entropy(
        h, e, jnp.asarray(t), block_n=32, block_v=64,
        implementation="interpret", **kw), jh, je)
    dh, de = vjp(jnp.asarray(g))
    return (np.asarray(losses), np.asarray(dh.astype(jnp.float32)),
            np.asarray(de.astype(jnp.float32)))


def _close_grads(got, want, dtype):
    for a, w in zip(got, want):
        if dtype == F32:
            np.testing.assert_allclose(a, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
        else:
            np.testing.assert_allclose(a, w, rtol=2.0 ** -7,
                                       atol=2.0 ** -8 * np.abs(w).max())


def _over_windows(bwd, windows):
    """The gradients of ``bwd(window)`` (a tuple of 2-D tensors of the
    window's columns) over ``windows`` in order, concatenated along
    d_model: the kernels' wrapper's loop, run on the plain versions."""
    parts = [bwd(w) for w in windows]
    return tuple(torch.cat(cols, dim=1) for cols in zip(*parts))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", tce.BWD_VARIANTS)
@pytest.mark.parametrize("d", [1536, 2304])
def test_windowed_ce_backward_matches_jax_interpret(d, variant, dtype):
    """The kernels' loop over column windows, run on the plain versions:
    each window's launch recomputes the logits over all of d_model and
    gives its own columns of dh and dE."""
    h, e, t, g = _ce_inputs(40, 70, d, dtype, seed=d)
    windows = tce.kernel_windows(dtype, d)
    assert len(windows) > 1 and all(w <= tce.KERNEL_MAX_D
                                    for _, w in windows)
    th, te = (torch.from_numpy(x.copy()).to(dtype) for x in (h, e))
    tt, tg = torch.from_numpy(t).long(), torch.from_numpy(g)
    lse, _ = tce.fused_ce_fwd_plain(th, te, tt)
    if variant == "split":
        got = (_over_windows(lambda w: (tce.fused_ce_dh_plain(
                   th, te, tt, lse, tg, window=w),), windows)[0],
               _over_windows(lambda w: (tce.fused_ce_de_plain(
                   th, te, tt, lse, tg, window=w),), windows)[0])
    else:
        got = _over_windows(lambda w: tce.fused_ce_bwd_plain(
            th, te, tt, lse, tg, window=w), windows)
    assert got[0].dtype == dtype and got[0].shape == th.shape
    assert got[1].dtype == dtype and got[1].shape == te.shape
    # the windows put together are the unwindowed plain backward
    whole = tce.fused_ce_bwd_plain(th, te, tt, lse, tg)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    _, *want = _jax_ce(h, e, t, g, dtype, bwd_variant=variant)
    _close_grads([x.float().numpy() for x in got], want, dtype)


@pytest.mark.parametrize("variant", tce.BWD_VARIANTS)
@pytest.mark.parametrize("d", [48, 100])
def test_f16_ce_matches_jax_interpret(d, variant):
    """The public op in f16 (d 100: the tensor-core route's zero-pad to a
    multiple of 8, on the CPU the plain versions as they are)."""
    h, e, t, g = _ce_inputs(100, 130, d, F16, seed=d + 1)
    th, te = (torch.from_numpy(x.copy()).to(F16).requires_grad_()
              for x in (h, e))
    losses = tce.fused_cross_entropy(th, te, torch.from_numpy(t).long(),
                                     bwd_variant=variant)
    losses.backward(torch.from_numpy(g))
    want_loss, want_dh, want_de = _jax_ce(h, e, t, g, F16,
                                          bwd_variant=variant)
    assert losses.dtype == F32 and th.grad.dtype == F16
    np.testing.assert_allclose(losses.detach().numpy(), want_loss,
                               rtol=1e-6, atol=1e-6)
    for a, w in ((th.grad, want_dh), (te.grad, want_de)):
        np.testing.assert_allclose(a.float().numpy(), w, rtol=2.0 ** -10,
                                   atol=2.0 ** -11 * np.abs(w).max())


ADAMW_SHAPES = {"embed": (40, 128), "scale": (130,), "odd": (3, 7, 5)}
ADAMW_HYPER = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
ULP = {F32: None, BF16: 2.0 ** -7, F16: 2.0 ** -10}


@pytest.mark.parametrize("p_dt,m_dt", [(BF16, F32), (BF16, BF16),
                                       (F16, F32), (F16, F16)],
                         ids=["p_bf16", "p_bf16_m_bf16", "p_f16",
                              "p_f16_m_f16"])
def test_fused_adamw_16bit_p_matches_jax_interpret(p_dt, m_dt):
    rng = np.random.default_rng(7)

    def tree(scale, dt):
        return {k: np.asarray(jnp.asarray(
                    scale * rng.normal(size=s), JDT[dt]).astype(jnp.float32))
                for k, s in ADAMW_SHAPES.items()}

    params = tree(1.0, p_dt)
    grads = [tree(0.1, p_dt) for _ in range(4)]
    jp = {k: jnp.asarray(x, JDT[p_dt]) for k, x in params.items()}
    jm, jv = ({k: jnp.zeros(s, JDT[m_dt]) for k, s in ADAMW_SHAPES.items()}
              for _ in range(2))
    jc = jnp.zeros((), jnp.int32)
    tp = {k: torch.tensor(x).to(p_dt) for k, x in params.items()}
    tm, tv = ({k: torch.zeros(s, dtype=m_dt) for k, s in ADAMW_SHAPES.items()}
              for _ in range(2))
    tc = 0
    for g in grads:
        jp, jm, jv, jc = jfa.fused_adamw_update(
            jp, {k: jnp.asarray(x, JDT[p_dt]) for k, x in g.items()}, jm,
            jv, jc, implementation="interpret", **ADAMW_HYPER)
        tc = tfa.fused_adamw_update(
            tp, {k: torch.tensor(x).to(p_dt) for k, x in g.items()},
            tm, tv, tc, **ADAMW_HYPER)[3]
    assert tc == int(jc) == 4
    for got, want, dt in ((tp, jp, p_dt), (tm, jm, m_dt), (tv, jv, m_dt)):
        for k in ADAMW_SHAPES:
            assert got[k].dtype == dt and want[k].dtype == JDT[dt]
            a, w = got[k].float().numpy(), np.asarray(
                want[k].astype(jnp.float32))
            if ULP[dt] is None:
                np.testing.assert_allclose(a, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(
                    a, w, rtol=ULP[dt], atol=ULP[dt] * np.abs(w).max(),
                    err_msg=k)

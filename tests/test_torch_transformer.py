"""Port parity: ``distributed_tensorflow_tpu_torch.models.transformer``
against the flax ``TransformerLM`` on the CPU, at ``tiny()`` in f32.

The flax parameters (from ``init``) go through ``params_from_jax`` as
numpy arrays; logits must agree to 2e-5 (f32, different matmul and
reduction orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, init_params, param_shapes,
    params_from_jax, resolve_device)


def jax_params(scan_layers=True, causal=True, seed=0):
    cfg = JConfig.tiny(max_seq_len=32, scan_layers=scan_layers,
                       causal=causal)
    params = JModel(cfg).init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked_layers", "layer_i"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_logits_match_flax(scan_layers, causal):
    jcfg, jparams, np_params = jax_params(scan_layers, causal)
    cfg = TransformerConfig.tiny(max_seq_len=32, causal=causal)
    params = params_from_jax(cfg, np_params, device="cpu")
    model = TransformerLM(cfg, params, device="cpu")
    toks = _tokens()
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
        got_len = model(torch.from_numpy(toks).long(),
                        lengths=torch.tensor([7, 12])).numpy()
        hidden = model(torch.from_numpy(toks).long(),
                       return_hidden=True).numpy()
    jm = JModel(jcfg)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(toks)))
    want_len = np.asarray(jm.apply({"params": jparams}, jnp.asarray(toks),
                                   False, jnp.asarray([7, 12])))
    want_hidden = np.asarray(jm.apply({"params": jparams},
                                      jnp.asarray(toks), True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # rows past a sequence's length are padding in both; compare the rest
    np.testing.assert_allclose(got_len[0, :7], want_len[0, :7], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got_len[1], want_len[1], atol=2e-5, rtol=0)
    np.testing.assert_allclose(hidden, want_hidden, atol=2e-5, rtol=0)


def test_tiny_attention_impl_follows_jax():
    """``tiny()`` takes JAX's ``attention_impl`` (the unfused reference:
    head dim 16, which no attention kernel takes); ``None`` still asks
    for the flash path."""
    assert TransformerConfig.tiny().attention_impl == \
        JConfig.tiny().attention_impl == "reference"
    assert TransformerConfig.tiny(attention_impl=None).attention_impl is None


def test_params_from_jax_layouts_agree():
    """The unstacked ``layer_{i}`` tree converts to the same stacked dict
    as the equivalent ``layers`` tree."""
    cfg = TransformerConfig.tiny(max_seq_len=32)
    _, _, stacked = jax_params(scan_layers=True)
    unstacked = {k: v for k, v in stacked.items() if k != "layers"}
    for i in range(cfg.n_layers):
        unstacked[f"layer_{i}"] = jax.tree_util.tree_map(
            lambda a: a[i], stacked["layers"])
    a = params_from_jax(cfg, stacked, device="cpu")
    b = params_from_jax(cfg, unstacked, device="cpu")
    for g, leaves in a["layers"].items():
        for n, t in leaves.items():
            assert torch.equal(t, b["layers"][g][n]), (g, n)
    assert torch.equal(a["embed"], b["embed"])
    with pytest.raises(ValueError):
        params_from_jax(TransformerConfig.tiny(d_ff=64), stacked,
                        device="cpu")


def test_init_params_shapes_and_scales():
    """Shapes of the flax tree; flax's init distributions."""
    cfg = TransformerConfig.tiny(max_seq_len=32, vocab_size=1024,
                                 d_model=128, d_ff=512)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, flax = jax_params()
    for g, leaves in param_shapes(TransformerConfig.tiny()).items():
        if g == "layers":
            for grp, names in leaves.items():
                for n, shape in names.items():
                    assert flax["layers"][grp][n].shape == shape
    D, Fd = cfg.d_model, cfg.d_ff
    for t, std in ((p["embed"], 0.02), (p["layers"]["attn"]["query"],
                                        D ** -0.5),
                   (p["layers"]["mlp"]["wi"], D ** -0.5),
                   (p["layers"]["mlp"]["wo"], Fd ** -0.5)):
        assert t.dtype == torch.float32
        assert abs(t.std().item() / std - 1) < 0.05
    assert torch.equal(p["layers"]["RMSNorm_0"]["scale"],
                       torch.ones(cfg.n_layers, D))
    again = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert torch.equal(again["embed"], p["embed"])


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    cfg = TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)

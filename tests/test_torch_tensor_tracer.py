"""Port parity: the tensor tracer (``utils/tensor_tracer.py``) against
the JAX package on the CPU.

- ``trace_point`` statistics equal JAX's at rtol 1e-6 in f32, NaN and
  Inf counts exactly, and collection is gated by the tracer as JAX's.
- ``trace_flax`` over ``tiny()`` at 12 unscanned layers, the weights
  from ``params_from_jax``, names the same entries in the same order as
  JAX's (flax's paths, SORTED: ``layer_10`` before ``layer_2``, the
  root's ``__call__`` first), statistics within 1e-4 (two f32 models),
  and for a NaN written into one layer's weight the same NaN entries
  and the same ``first_nan`` — the root's ``__call__``, as JAX reports
  it, not the layer the NaN entered.
- ``instrument`` finds the first NaN-producing op and reports no entry
  for a factory op (``empty_like``'s memory is uninitialised).
- ``TraceReport.write`` writes JAX's bytes for the same entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import transformer as jtf
from distributed_tensorflow_tpu.utils import tensor_tracer as jtt
from distributed_tensorflow_tpu_torch.models import transformer as ttf
from distributed_tensorflow_tpu_torch.utils import tensor_tracer as ttt

RNG = np.random.default_rng(9)
X = RNG.normal(size=(6, 7)).astype(np.float32)
X_BAD = X.copy()
X_BAD[1, 2], X_BAD[4, 0], X_BAD[0, 0] = np.nan, np.inf, -np.inf


def _jax_points(arrays):
    @jax.jit
    def f(*xs):
        return [jtt.trace_point(f"p{i}", x) for i, x in enumerate(xs)]
    with jtt.TensorTracer() as t:
        f(*[jnp.asarray(a) for a in arrays])
    return t.report().entries


def _torch_points(arrays):
    with ttt.TensorTracer() as t:
        for i, a in enumerate(arrays):
            ttt.trace_point(f"p{i}", torch.from_numpy(a))
    return t.report().entries


def _close_entries(got, want, rtol):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w), name
        for k in ("nan_count", "inf_count", "iteration"):
            if k in w:
                assert int(g[k]) == int(w[k]), (name, k)
        for k in ("norm", "max", "min", "mean"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=rtol,
                                       err_msg=f"{name} {k}")


def test_trace_point_stats_match_jax():
    arrays = [X, X_BAD, (X * 1e3).astype(np.float32),
              np.arange(12, dtype=np.int32).reshape(3, 4),
              np.zeros((0, 3), np.float32)]
    got = _torch_points(arrays)
    assert [n for n, _ in got] == [f"p{i}" for i in range(len(arrays))]
    # a jitted program's independent callbacks arrive in no set order
    _close_entries(got, sorted(_jax_points(arrays)), 1e-6)
    # outside a tracer nothing is collected, and the value passes through
    x = torch.from_numpy(X)
    assert ttt.trace_point("off", x) is x
    with ttt.TensorTracer() as t:
        pass
    assert t.report().entries == []


def test_iteration_and_first_nan_name_like_jax():
    with ttt.TensorTracer() as t:
        ttt.trace_point("ok", torch.from_numpy(X), iteration=0)
        ttt.trace_point("body", torch.from_numpy(X_BAD), iteration=3)
    rep = t.report()
    want = jtt.TraceReport([(n, dict(s)) for n, s in rep.entries])
    assert rep.first_nan() == want.first_nan() == "body [iteration 3]"
    assert rep.entries[1][1]["iteration"] == 3


N_LAYERS, BAD_LAYER = 12, 2


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig.tiny(n_layers=N_LAYERS, scan_layers=False,
                                      max_seq_len=32)
    jm = jtf.TransformerLM(jcfg)
    toks = RNG.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    np_params = jax.tree_util.tree_map(np.asarray, variables["params"])
    cfg = ttf.TransformerConfig.tiny(n_layers=N_LAYERS, scan_layers=False,
                                     max_seq_len=32)
    return jm, np_params, cfg, toks


def _bad_params(np_params):
    bad = jax.tree_util.tree_map(np.array, np_params)
    bad[f"layer_{BAD_LAYER}"]["attn"]["query"][0, 0, 0] = np.nan
    return bad


def _both(models, params):
    jm, _, cfg, toks = models
    _, want = jtt.trace_flax(jm, {"params": params}, jnp.asarray(toks))
    model = ttf.TransformerLM(cfg, ttf.params_from_jax(cfg, params,
                                                       device="cpu"),
                              device="cpu")
    _, got = ttt.trace_flax(model, torch.from_numpy(toks).long())
    return got, want


def test_trace_flax_names_and_orders_like_jax(models):
    got, want = _both(models, models[1])
    names = [n for n, _ in want.entries]
    assert names[0] == "__call__" and len(names) == 2 + 5 * N_LAYERS
    assert names.index("layer_10/__call__[0]") < \
        names.index("layer_2/__call__[0]")
    _close_entries(got.entries, want.entries, 1e-4)
    assert got.first_nan() is None and want.first_nan() is None


def test_find_first_nan_matches_jax_sorted_order(models):
    got, want = _both(models, _bad_params(models[1]))
    gbad = [n for n, _ in got.nan_entries()]
    assert gbad == [n for n, _ in want.nan_entries()]
    assert got.first_nan() == want.first_nan() == "__call__"
    layers = [n.split("/")[0] for n in gbad if n.startswith("layer_")]
    # the NaN enters at layer 2's attention, yet layer_10 and layer_11
    # (sorted before layer_2) are reported ahead of it, as in JAX
    assert layers[0] == "layer_10" and "layer_2" in layers
    assert f"layer_{BAD_LAYER}/RMSNorm_0/__call__" not in gbad
    assert f"layer_{BAD_LAYER}/attn/__call__" in gbad
    jm, _, cfg, toks = models
    model = ttf.TransformerLM(cfg, ttf.params_from_jax(
        cfg, _bad_params(models[1]), device="cpu"), device="cpu")
    assert ttt.find_first_nan(model, torch.from_numpy(toks).long()) == \
        jtt.find_first_nan(jm, {"params": _bad_params(models[1])},
                           jnp.asarray(toks))


def _program(x, w):
    y = torch.matmul(x, w)
    scratch = torch.empty_like(y)           # uninitialised: not traced
    z = torch.zeros(3)
    r = torch.relu(y) - 1.0
    return torch.log(r).sum() + z.sum() + scratch.shape[0]


def test_instrument_finds_first_nan_op_and_skips_factories():
    w = torch.from_numpy(X[:, :4].T.copy())
    out, rep = ttt.trace_fn(_program, w.T.contiguous(), w)
    ops = [n.split()[1] for n, _ in rep.entries]
    assert "empty_like" not in ops and "zeros" not in ops
    assert ops[:3] == ["mm", "relu", "sub"]
    first = rep.first_nan()
    assert first is not None and first.split()[1] == "log"
    assert "test_torch_tensor_tracer.py" in first and "(_program)" in first
    assert torch.isnan(out)
    # the index counts every numeric output; op_regex keeps its own
    _, only = ttt.trace_fn(_program, w.T.contiguous(), w, op_regex="^log$")
    assert [n.split()[:2] for n, _ in only.entries] == [["0003", "log"]]
    _, capped = ttt.trace_fn(_program, w.T.contiguous(), w, max_traced=2)
    assert len(capped.entries) == 2
    _, named = ttt.trace_fn(_program, w.T.contiguous(), w,
                            name_regex="relu")
    assert [n.split()[1] for n, _ in named.entries] == ["relu"]


def test_report_write_matches_jax_bytes(tmp_path):
    entries = _torch_points([X, X_BAD, X * -2.0])
    for first_nan in (True, False):
        ents = entries if first_nan else entries[:1]
        a = ttt.TraceReport(ents).write(str(tmp_path / "t" / "r.txt"))
        b = jtt.TraceReport(ents).write(str(tmp_path / "j" / "r.txt"))
        assert open(a, "rb").read() == open(b, "rb").read()
        assert str(ttt.TraceReport(ents)) == str(jtt.TraceReport(ents))

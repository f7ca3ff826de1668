"""Port parity: MoE training on meshes with ``ep`` — the port's
``make_sharded_train_step`` (gloo ranks, one spawn a world) against its
own single-device step and the JAX package's single-device step, from
the same converted parameters on the same tokens.

``tiny(moe_experts=4)`` at capacity 0.5 (so tokens drop), three steps on
``{"ep": 2}``, ``{"dp": 2}``, ``{"sp": 2}`` (top-1; ``ep2`` top-2 as
well), ``{"dp": 2, "ep": 2}`` and ``{"ep": 2, "tp": 2}``: every step's
loss within 2e-6 and the gathered parameters within 1e-5 of both
references (``tests/test_torch_dp_train.py``'s tolerances), the same on
every rank; the dropped-row set at the init, assembled from every
rank's rows and chunk, equal to the single-device step's (routing is
global: a rank places its tokens by the counts of every token before
them). A rank's experts are ``E/ep`` (and the router's columns), the
experts' ``d_ff`` ``F/tp``. JAX's own dp×ep run parts from its single
device on this XLA-CPU runtime (``tests/test_flagship_parallelism.py``),
so the single device is the JAX reference.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, synthetic_tokens)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, make_optimizer, make_train_step)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_moe_ranks
from torch_dp_ranks import _np_params, _params_from_np
from torch_tp_jax import assert_close, jax_run

GB, STEPS = 8, 3
MOE = {"moe_experts": 4, "moe_capacity_factor": 0.5}
TOP2 = {**MOE, "moe_top_k": 2}
#: name → (axes, config kwargs), by world
CASES = {
    2: {"ep2": ({"ep": 2}, MOE), "ep2_top2": ({"ep": 2}, TOP2),
        "dp2": ({"dp": 2}, MOE), "sp2": ({"sp": 2}, MOE)},
    4: {"dp2ep2": ({"dp": 2, "ep": 2}, MOE),
        "ep2tp2": ({"ep": 2, "tp": 2}, MOE)},
}
ALL = [(w, n) for w in sorted(CASES) for n in CASES[w]]


def _key(kw):
    return "top2" if kw.get("moe_top_k", 1) == 2 else "top1"


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens):
    return {_key(kw): jax_run({"dp": 1}, kw, {}, tokens, STEPS)
            for kw in (MOE, TOP2)}


@pytest.fixture(scope="module")
def single(jax_runs, tokens):
    """The port's single-device step and its dropped rows at the init."""
    out = {}
    tok = torch.from_numpy(tokens.astype(np.int64))
    for kw in (MOE, TOP2):
        cfg = TransformerConfig.tiny(**kw)
        model = TransformerLM(cfg, _params_from_np(
            cfg, jax_runs[_key(kw)]["init"]), device="cpu")
        dropped = torch_moe_ranks.dropped_rows(model, tok)
        step = make_train_step(cfg, model, make_optimizer(
            cfg, model.parameters()))
        state, losses = {"model": model, "step": 0}, []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": tok})
            losses.append(float(m["loss"]))
        out[_key(kw)] = {"losses": losses, "params": _np_params(model),
                         "dropped": dropped}
    return out


@pytest.fixture(scope="module")
def port_ranks(jax_runs, tokens):
    tok = tokens.astype(np.int64)
    return {world: multi_process_runner.run(
        torch_moe_ranks.train_rank, world,
        args=([(name, axes, kw, {}, jax_runs[_key(kw)]["init"])
               for name, (axes, kw) in cases.items()], tok, STEPS),
        device="cpu", timeout=600).return_values
        for world, cases in CASES.items()}


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_moe_step_matches_single_device_and_jax(port_ranks, jax_runs,
                                                single, world, name):
    kw = CASES[world][name][1]
    for r in port_ranks[world]:
        got = r[name]
        assert_close(got, single[_key(kw)], f"{name} vs port")
        assert_close(got, jax_runs[_key(kw)], f"{name} vs JAX")
        assert got["losses"] == port_ranks[world][0][name]["losses"]
        assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_moe_dropped_rows_equal_single_device(port_ranks, single, world,
                                              name):
    axes, kw = CASES[world][name]
    want = single[_key(kw)]["dropped"]              # (L, GB, S)
    assert want.any() and not want.all()
    got = np.zeros_like(want)
    seen = np.zeros_like(want)
    for r in port_ranks[world]:
        d = r[name]["dropped"]
        rows, cols = d.shape[1], d.shape[2]
        i, c = r[name]["data_index"], r[name]["sp_index"]
        block = (slice(None), slice(i * rows, (i + 1) * rows),
                 slice(c * cols, (c + 1) * cols))
        if seen[block].any():   # a replica over ep/tp: the same rows
            np.testing.assert_array_equal(got[block], d)
        got[block], seen[block] = d, True
    assert seen.all()
    np.testing.assert_array_equal(got, want)


def test_moe_local_shapes(port_ranks):
    """A rank's MoE leaves: E/ep experts and router columns, F/tp."""
    shapes = {name: port_ranks[w][0][name]["local_shapes"] for w, name in ALL}
    assert shapes["ep2"]["layers/moe/router"] == (2, 64, 2)
    assert shapes["ep2"]["layers/moe/wi"] == (2, 2, 64, 128)
    assert shapes["ep2tp2"]["layers/moe/wi"] == (2, 2, 64, 64)
    assert shapes["ep2tp2"]["layers/moe/wo"] == (2, 2, 64, 64)
    assert shapes["ep2tp2"]["layers/attn/query"] == (2, 64, 2, 16)
    assert shapes["dp2"]["layers/moe/wi"] == (2, 4, 64, 128)

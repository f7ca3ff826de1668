"""Port parity: the mesh repairs of ``ROADMAP.md`` C-4(b)-(d), on 4 gloo
ranks (one spawn) against the JAX package on its 8-device CPU mesh,
from the same converted parameters on the same tokens.

- C-4(c): ``make_sharded_train_step`` on ``{"dp": 2, "pp": 2}`` and
  ``{"pp": 2, "tp": 2}`` — GSPMD replicates over ``pp`` (no data axis),
  as the port now does; ``tiny()``, 8 rows, 3 steps.
- C-4(d): ``make_pipelined_train_step`` on ``{"pp": 2, "tp": 2}``,
  GPipe and 1F1B — JAX's stage weights are ``P("pp")`` and its
  microbatches ``P(None, "dp")``, so each ``tp`` coordinate runs the
  same stages on the same rows; ``tiny(n_layers=4)``, 8 rows in 4
  microbatches, 3 steps.
- Every step's loss within 2e-6 and the gathered parameters within
  1e-5 (``tests/test_torch_train_step.py``'s tolerances), the same on
  every rank.
- C-4(b): each configuration JAX 0.9.0 refuses, the port refuses too:
  ``sp`` with a sequence it does not divide, ``fsdp`` 4 with
  ``d_model=60`` and 8 with 68, ``ep`` 4 with 6 experts, and ``tp`` 4
  with ``n_heads=6`` or ``d_ff=66`` (4k + 2). The port's ``fsdp`` 8
  refusal is its build check (``check_shardable``), the 4-rank world
  having no 8-rank mesh.
"""

import concurrent.futures

import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_sharded_train_step as jsharded,
    synthetic_tokens)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, check_shardable)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_ckpt_ranks
from torch_pp_jax import jax_pp_run
from torch_tp_jax import assert_close, jax_mesh, jax_run

STEPS, GB = 3, 8
SHARDED = {"dp2pp2": {"dp": 2, "pp": 2}, "pp2tp2": {"pp": 2, "tp": 2}}
PIPELINED = {"pipe_gpipe": ({"pp": 2, "tp": 2}, "gpipe"),
             "pipe_1f1b": ({"pp": 2, "tp": 2}, "1f1b")}
#: (id, axes, config kwargs, sequence length): refused by JAX 0.9.0;
#: the port builds and steps each on 4 ranks (axes of 4 devices)
REFUSALS = [
    ("sp_seq33", {"dp": 2, "sp": 2}, {}, 33),
    ("fsdp4_d60", {"fsdp": 4}, {"d_model": 60}, 128),
    ("ep4_e6", {"ep": 4}, {"moe_experts": 6}, 128),
    ("tp4_heads6", {"tp": 4}, {"n_heads": 6, "d_model": 48}, 128),
    ("tp4_dff66", {"tp": 4}, {"d_ff": 66}, 128),
]


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(GB, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def runs(tokens):
    """``(jax runs, port ranks)``: the 4-rank spawn runs in a thread
    while the JAX steps compile, from the JAX package's initial
    parameters (its builds without steps)."""
    init = jax_run(SHARDED["dp2pp2"], {}, {}, tokens, 0)["init"]
    pp_init = jax_pp_run(PIPELINED["pipe_gpipe"][0], "gpipe", {}, tokens, 0,
                         n_layers=4, global_batch=GB, n_micro=4)["init"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(
            multi_process_runner.run, torch_ckpt_ranks.mesh_repair_rank, 4,
            args=([(n, axes, init) for n, axes in SHARDED.items()],
                  tokens.astype(np.int64), STEPS,
                  [(n, axes, s) for n, (axes, s) in PIPELINED.items()],
                  pp_init, [r[1:] for r in REFUSALS]),
            device="cpu", timeout=300)
        jax_runs = {name: jax_run(axes, {}, {}, tokens, STEPS)
                    for name, axes in SHARDED.items()}
        for name, (axes, schedule) in PIPELINED.items():
            jax_runs[name] = jax_pp_run(axes, schedule, {}, tokens, STEPS,
                                        n_layers=4, global_batch=GB,
                                        n_micro=4)
        port_ranks = port.result().return_values
    for name, r in jax_runs.items():
        src = pp_init if name in PIPELINED else init
        assert all(np.array_equal(r["init"][k], src[k]) for k in src)
    return jax_runs, port_ranks


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_ranks(runs):
    return runs[1]


@pytest.mark.parametrize("name", list(SHARDED) + list(PIPELINED))
def test_replicated_axis_matches_jax(jax_runs, port_ranks, name):
    for r in port_ranks:
        assert_close(r[name], jax_runs[name], name)
        assert r[name]["losses"] == port_ranks[0][name]["losses"]


def _jax_build_and_step(axes, cfg_kw, seq, tokens):
    cfg = JConfig.tiny(**cfg_kw)
    state, step = jsharded(cfg, jax_mesh(axes), 4, 0)
    _, m = step(state, {"tokens": tokens[:4, :seq]})
    float(m["loss"])


@pytest.mark.parametrize("case", REFUSALS + [
    ("fsdp8_d68", {"fsdp": 8}, {"d_model": 68}, 128)], ids=lambda c: c[0])
def test_jax_refusals_are_port_refusals(tokens, port_ranks, case):
    name, axes, cfg_kw, seq = case
    with pytest.raises((ValueError, TypeError)):
        _jax_build_and_step(axes, cfg_kw, seq, tokens)
    if name == "fsdp8_d68":
        with pytest.raises(ValueError):
            check_shardable(TransformerConfig.tiny(**cfg_kw), axes)
        return
    got = port_ranks[0]["refusals"][[r[0] for r in REFUSALS].index(name)]
    assert got is not None, name
    assert all(r["refusals"] == port_ranks[0]["refusals"]
               for r in port_ranks)

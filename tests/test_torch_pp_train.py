"""Port parity: the slice — ``make_pipelined_train_step`` on gloo ranks
against the JAX package's on its 8-device CPU mesh, from the same
converted parameters on the same tokens.

- ``tiny(n_layers=4)``, 8 rows in 4 microbatches, 3 steps, on
  ``{"pp": 2}`` (2 ranks, one spawn), ``{"pp": 4}`` and ``{"dp": 2,
  "pp": 2}`` (4 ranks, one spawn): GPipe, 1F1B, 1F1B with ``zero=1``,
  and interleaved v=2 where ``n_layers % (pp·2)`` allows it (pp 2 and
  dp2×pp2). Every step's loss within 2e-6 and the gathered parameters
  within 1e-5 (``tests/test_torch_dp_train.py``'s tolerances), the same
  on every rank. Interleaved v=1 is bitwise the 1F1B run.
- Each build's ``pipeline.schedule`` event carries JAX's fields and
  values; the P2P counts are the schedule's.
- Every refusal of JAX's raises the port's with the same type for the
  same arguments; GPipe microbatches whose rows ``dp`` does not divide,
  which JAX's step refuses at its first call, the port refuses when
  built (``ValueError`` both). A mesh with another axis (``{"pp": 2,
  "tp": 2}``) builds, as JAX's does (it replicates over the axis; the
  training parity is ``tests/test_torch_mesh_repair.py``'s), and so
  does ``make_sharded_train_step`` on a ``pp`` mesh.
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu import telemetry as jtelemetry
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, make_pipelined_train_step as jpipelined,
    synthetic_tokens)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_pp_ranks
from torch_pp_jax import jax_pp_run
from torch_tp_jax import jax_mesh

STEPS = 3
GB, M = torch_pp_ranks.GB, torch_pp_ranks.N_MICRO
MESHES = {"pp2": {"pp": 2}, "pp4": {"pp": 4}, "dp2pp2": {"dp": 2, "pp": 2}}
#: variant → (schedule, step kwargs, global batch, microbatches)
SCHEDULES = {"gpipe": ("gpipe", {}, GB, M), "1f1b": ("1f1b", {}, GB, M),
             "zero1": ("1f1b", {"zero": 1}, GB, M),
             "interleaved": ("interleaved", {"interleave": 2}, GB, M)}
CASES = [(mesh, v) for mesh in MESHES for v in SCHEDULES
         if not (mesh == "pp4" and v == "interleaved")]
#: (mesh, config kwargs, step kwargs, global batch, microbatches), each
#: refused by JAX
REFUSALS = [
    ("pp2", {}, {"schedule": "bogus"}, GB, M),
    ("pp2", {}, {"schedule": "gpipe", "offload_activations": True}, GB, M),
    ("pp2", {}, {"schedule": "interleaved", "offload_activations": True},
     GB, M),
    ("pp2", {}, {"schedule": "1f1b", "offload_activations": "bogus"}, GB,
     M),
    ("pp2", {"scan_layers": False}, {}, GB, M),
    ("pp2", {"n_layers": 3}, {}, GB, M),
    ("pp2", {}, {"schedule": "interleaved", "interleave": 3}, GB, M),
    ("pp2", {}, {"schedule": "interleaved", "interleave": 0}, GB, M),
    ("pp2", {}, {}, GB, 3),
    ("dp2pp2", {}, {"schedule": "1f1b"}, 12, 4),
    ("dp2pp2", {}, {"schedule": "interleaved"}, 12, 4),
    ("pp2", {}, {"schedule": "interleaved"}, 6, 3),
    ("pp2", {}, {"zero": 3}, GB, M),
]
#: built by the port as by JAX: a mesh with another axis (JAX
#: replicates over it); refused by the port when built: GPipe
#: microbatches of 3 rows over dp 2 (ValueError; JAX's shard_map raises
#: it at the first step, test_gpipe_uneven_microbatch_refused_as_jax)
PORT_REFUSALS = [("pp2tp2", {}, {}, GB, M),
                 ("dp2pp2", {}, {"schedule": "gpipe"}, 12, 4)]


@pytest.fixture(scope="module")
def tokens():
    return np.asarray(synthetic_tokens(12, JConfig.tiny().max_seq_len,
                                       JConfig.tiny().vocab_size, seed=3))


@pytest.fixture(scope="module")
def jax_runs(tokens, tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("jax_pp_events"))
    jtelemetry.configure(logdir, process_id=0)
    try:
        runs = {}
        for mesh, v in CASES:
            schedule, kw, gb, m = SCHEDULES[v]
            runs[(mesh, v)] = jax_pp_run(
                MESHES[mesh], schedule, kw, tokens[:gb], STEPS,
                n_layers=torch_pp_ranks.N_LAYERS, global_batch=gb,
                n_micro=m)
    finally:
        jtelemetry.shutdown()
    events = [e for e in jtelemetry.read_events(
        jtelemetry.event_log_path(logdir, 0))
        if e["ev"] == "pipeline.schedule"]
    init = runs[CASES[0]]["init"]
    for r in runs.values():
        assert all(np.array_equal(r["init"][k], init[k]) for k in init)
    return runs, events


def _refusals(meshes):
    return [r for r in REFUSALS if r[0] in meshes]


def _variants(meshes):
    return {(mesh, v): SCHEDULES[v] for mesh, v in CASES if mesh in meshes}


@pytest.fixture(scope="module")
def port_world2(jax_runs, tokens, tmp_path_factory):
    runs, _ = jax_runs
    variants = {**_variants(("pp2",)),
                ("pp2", "interleaved_v1"): ("interleaved",
                                            {"interleave": 1}, GB, M)}
    return multi_process_runner.run(
        torch_pp_ranks.pp_train_rank, 2,
        args=({"pp2": MESHES["pp2"]}, runs[CASES[0]]["init"],
              tokens.astype(np.int64), STEPS, variants, _refusals(("pp2",)),
              str(tmp_path_factory.mktemp("port_pp2_events"))),
        device="cpu", timeout=300).return_values


@pytest.fixture(scope="module")
def port_world4(jax_runs, tokens, tmp_path_factory):
    runs, _ = jax_runs
    meshes = {"pp4": MESHES["pp4"], "dp2pp2": MESHES["dp2pp2"],
              "pp2tp2": {"pp": 2, "tp": 2}}
    return multi_process_runner.run(
        torch_pp_ranks.pp_train_rank, 4,
        args=(meshes, runs[CASES[0]]["init"], tokens.astype(np.int64),
              STEPS, _variants(("pp4", "dp2pp2")),
              _refusals(("dp2pp2",)) + PORT_REFUSALS,
              str(tmp_path_factory.mktemp("port_pp4_events"))),
        device="cpu", timeout=300).return_values


def _ranks(case, port_world2, port_world4):
    return port_world2 if case[0] == "pp2" else port_world4


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_port_step_matches_jax(jax_runs, port_world2, port_world4, case):
    want = jax_runs[0][case]
    ranks = _ranks(case, port_world2, port_world4)
    for r in ranks:
        got = r["runs"][case]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=2e-6)
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                       atol=1e-5, err_msg=f"{case} {k}")
        assert got["losses"] == ranks[0]["runs"][case]["losses"]
        assert all(np.array_equal(v, ranks[0]["runs"][case]["params"][k])
                   for k, v in got["params"].items())


def test_interleaved_v1_bitwise_equals_1f1b(port_world2):
    for r in port_world2:
        a, b = r["runs"][("pp2", "interleaved_v1")], r["runs"][("pp2",
                                                                 "1f1b")]
        assert a["losses"] == b["losses"]
        for k, v in b["params"].items():
            assert np.array_equal(a["params"][k], v), k
        assert a["stats"]["p2p"] == b["stats"]["p2p"]


def test_schedule_events_and_p2p_counts(jax_runs, port_world2,
                                        port_world4):
    _, jax_events = jax_runs
    fields = ("schedule", "n_stages", "n_micro", "interleave", "offload",
              "bubble_fraction")
    want = {case: {f: e[f] for f in fields}
            for case, e in zip(CASES, jax_events)}
    for ranks in (port_world2, port_world4):
        for r in ranks:
            cases = list(r["runs"])
            assert len(r["events"]) == len(cases)
            for case, e in zip(cases, r["events"]):
                if case in want:
                    assert {f: e[f] for f in fields} == want[case], case
    # per rank and step, each microbatch crosses each of the rank's
    # links once each way (v times with v chunks)
    for ranks in (port_world2, port_world4):
        for r in ranks:
            for (mesh, v), run in r["runs"].items():
                pp = MESHES[mesh]["pp"]
                chunks = (2 if v == "interleaved" else 1)
                k = r["rank"] % pp
                hops = (2 * chunks if v == "interleaved" else
                        (k < pp - 1) + (k > 0))
                if v == "interleaved":
                    hops -= (k == 0) + (k == pp - 1)
                p2p = run["stats"]["p2p"]
                assert p2p["sends"] == p2p["recvs"] == M * hops, (
                    mesh, v, r["rank"], p2p)


def test_refusals_match_jax(port_world2, port_world4):
    got = port_world2[0]["refusals"] + port_world4[0]["refusals"]
    want = _refusals(("pp2",)) + _refusals(("dp2pp2",))
    assert len(want) == len(REFUSALS)
    for (mesh, cfg_kw, kw, gb, m), g in zip(want, got):
        with pytest.raises((ValueError, NotImplementedError)) as err:
            jpipelined(JConfig.tiny(**{"n_layers": torch_pp_ranks.N_LAYERS,
                                       **cfg_kw}),
                       jax_mesh(MESHES[mesh]), gb, m, **kw)
        assert g is not None, (mesh, cfg_kw, kw)
        assert g[0] == type(err.value).__name__, (g, err.value)


def test_gpipe_uneven_microbatch_refused_as_jax(tokens, port_world4):
    mesh, cfg_kw, kw, gb, m = PORT_REFUSALS[1]
    state, step = jpipelined(JConfig.tiny(n_layers=torch_pp_ranks.N_LAYERS),
                             jax_mesh(MESHES[mesh]), gb, m, **kw)
    with pytest.raises(ValueError):
        step(state, {"tokens": tokens[:gb]})
    got = port_world4[0]["refusals"][-1]
    assert got is not None and got[0] == "ValueError", got


def test_port_only_refusals(port_world2, port_world4):
    """No refusal is the port's alone any more: the pipelined step
    builds on ``{"pp": 2, "tp": 2}`` and the sharded step on a ``pp``
    mesh, as JAX's do (C-4(c), (d))."""
    n = len(_refusals(("dp2pp2",)))
    assert port_world4[0]["refusals"][n] is None
    for ranks in (port_world2, port_world4):
        assert ranks[0]["sharded_refusal"] is None

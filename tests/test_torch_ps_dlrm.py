"""Port parity: the asynchronous parameter-server DLRM driver
(``models/wide_deep.py train_dlrm_async_ps``, ``_ps_dataset``) and
``OnlineTrainer(coordinator=)`` (``models/online_dlrm.py``) on thread
lanes on the CPU, at ``WideDeepConfig.tiny()`` / ``OnlineConfig.tiny()``,
against the JAX package's on the same schedule: the JAX
``ps_init_state`` carried over as numpy, the per-worker dataset
counters started at the same value.

- ``_ps_dataset``'s batches equal JAX's exactly, for thread lanes and
  for a remote worker's id.
- One lane, one closure in flight: the losses within 1e-5 and the final
  server copy (dense parameters, Adagrad sums, tables, slots) within
  1e-5 of JAX's (``tests/test_torch_train_step.py``'s parameter
  tolerance) after 8 steps.
- ``OnlineTrainer`` with one lane and a window of 1 over 160 events:
  offsets, steps and commits exact, membership exact, dense parameters
  and tables within 1e-5.
- Three lanes, four in flight: every one of 60 scheduled steps
  completes and the loss falls.
"""

import itertools
import pickle

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.coordinator.cluster_coordinator import (
    ClusterCoordinator as JCoordinator)
from distributed_tensorflow_tpu.input import stream as jstream
from distributed_tensorflow_tpu.models import online_dlrm as jod
from distributed_tensorflow_tpu.models import wide_deep as jw
from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator import (
    ClusterCoordinator)
from distributed_tensorflow_tpu_torch.embedding import embedding as te
from distributed_tensorflow_tpu_torch.models import online_dlrm as tod
from distributed_tensorflow_tpu_torch.models import wide_deep as tw

ATOL = 1e-5
STEPS, BATCH = 8, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _restart_counters(start: int):
    jw._LOCAL_DS_COUNTER = itertools.count(start)
    tw._LOCAL_DS_COUNTER = itertools.count(start)


def test_ps_dataset_batches_equal_jax(monkeypatch):
    cfg_j, cfg_t = jw.WideDeepConfig.tiny(), tw.WideDeepConfig.tiny()
    _restart_counters(5)
    for _ in range(2):                    # two thread lanes' streams
        jit_, tit = jw._ps_dataset(cfg_j, 24, 3), tw._ps_dataset(cfg_t, 24, 3)
        for _ in range(4):
            jb, tb = next(jit_), next(tit)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert tb[k].dtype == np.asarray(jb[k]).dtype
                np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))

    class _Svc:                           # a remote worker's id
        worker_id = 2
    from distributed_tensorflow_tpu.coordinator import remote_dispatch as jrd
    from distributed_tensorflow_tpu_torch.coordinator import (
        remote_dispatch as trd)
    monkeypatch.setattr(jrd, "current_worker_service", lambda: _Svc)
    monkeypatch.setattr(trd, "current_worker_service", lambda: _Svc)
    jb, tb = next(jw._ps_dataset(cfg_j, 8, 0)), next(tw._ps_dataset(cfg_t,
                                                                    8, 0))
    for k in jb:
        np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))


def _port_state(init: dict) -> dict:
    dense = init["dense"]
    return {"dense": {
        "params": {f"{m}.{n}": torch.from_numpy(np.array(v[n]))
                   for m, v in dense["params"].items() for n in v},
        "opt_state": {f"{m}.{n}": torch.from_numpy(np.array(v[n]))
                      for m, v in dense["opt_state"][0].sum_of_squares
                      .items() for n in v}},
        "emb": te.state_from_jax(init["emb"], device="cpu")}


@pytest.fixture(scope="module")
def one_lane():
    cfg_j, cfg_t = jw.WideDeepConfig.tiny(), tw.WideDeepConfig.tiny()
    init = _np(jw.ps_init_state(cfg_j))
    _restart_counters(0)
    jc = JCoordinator(num_workers=1)
    try:
        jstate, jlosses = jw.train_dlrm_async_ps(
            cfg_j, jc, steps=STEPS, batch_size=BATCH, max_in_flight=1)
    finally:
        jc.shutdown()
    tc = ClusterCoordinator(num_workers=1, device="cpu")
    try:
        tstate, tlosses = tw.train_dlrm_async_ps(
            cfg_t, tc, steps=STEPS, batch_size=BATCH, max_in_flight=1,
            state=_port_state(init))
    finally:
        tc.shutdown()
    return _np(jstate), jlosses, tstate, tlosses


def test_one_lane_losses_match_jax(one_lane):
    _, jlosses, _, tlosses = one_lane
    assert len(tlosses) == len(jlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=ATOL)


def test_one_lane_server_copy_matches_jax(one_lane):
    jstate, _, tstate, _ = one_lane
    for m, v in jstate["dense"]["params"].items():
        for n, w in v.items():
            np.testing.assert_allclose(
                tstate["dense"]["params"][f"{m}.{n}"].numpy(), w, rtol=0,
                atol=ATOL, err_msg=f"{m}.{n}")
    sums = jstate["dense"]["opt_state"][0].sum_of_squares
    for m, v in sums.items():
        for n, w in v.items():
            np.testing.assert_allclose(
                tstate["dense"]["opt_state"][f"{m}.{n}"].numpy(), w, rtol=0,
                atol=ATOL)
    for k, w in jstate["emb"]["tables"].items():
        got = tstate["emb"]["tables"][k]
        assert got.device.type == "cpu"           # the host server copy
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=ATOL)
    for k, slots in jstate["emb"]["slots"].items():
        for s, w in slots.items():
            np.testing.assert_allclose(tstate["emb"]["slots"][k][s].numpy(),
                                       w, rtol=0, atol=ATOL)


def test_three_lanes_every_step_completes_and_loss_falls():
    cfg = tw.WideDeepConfig.tiny(learning_rate=0.05)
    coord = ClusterCoordinator(num_workers=3, device="cpu")
    done = []
    try:
        _, losses = tw.train_dlrm_async_ps(cfg, coord, steps=60,
                                           batch_size=32, max_in_flight=4,
                                           on_step=done.append)
    finally:
        coord.shutdown()
    assert len(losses) == 60 and done == list(range(1, 61))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert {w.worker_index for w in coord.cluster.workers} == {0, 1, 2}


def _aux(sd):
    return pickle.loads(np.asarray(sd["aux"], np.uint8).tobytes())


TOTAL = 160


@pytest.fixture(scope="module")
def online(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("online_coord")
    log = str(tmp / "events.log")
    with jstream.StreamWriter.open(log) as w:
        jstream.append_chunk(w, jstream.seeded_events(
            13, 0, TOTAL, n_users=500, n_items=200))
    runs = {}
    for name, mod, coord, kw in (
            ("jax", jod, JCoordinator(num_workers=1), {}),
            ("port", tod, ClusterCoordinator(num_workers=1, device="cpu"),
             {"device": "cpu"})):
        try:
            t = mod.OnlineTrainer(mod.OnlineConfig.tiny(), log,
                                  str(tmp / name), commit_every=3,
                                  coordinator=coord, max_in_flight=1, **kw)
            runs[name] = (t.run(TOTAL, idle_timeout_s=2.0),
                          t._state_nested())
        finally:
            coord.shutdown()
    return runs


def test_online_trainer_coordinator_matches_jax(online):
    (jout, js), (tout, ts) = online["jax"], online["port"]
    for k in ("offset", "steps", "events_applied", "commits", "tables"):
        assert tout[k] == jout[k], k
    assert tout["offset"] == TOTAL
    np.testing.assert_allclose(tout["loss_last"], jout["loss_last"],
                               rtol=0, atol=ATOL)
    for name in ("user", "item"):
        assert _aux(ts[name])["id_to_row"] == _aux(js[name])["id_to_row"]
        np.testing.assert_allclose(ts[name]["rows"], js[name]["rows"],
                                   rtol=0, atol=ATOL)
    for k, v in js["dense"]["params"].items():
        np.testing.assert_allclose(ts["dense"]["params"][k], v, rtol=0,
                                   atol=ATOL, err_msg=k)

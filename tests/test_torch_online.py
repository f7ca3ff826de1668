"""Port parity: the online half of the slice — ``input/stream.py``,
``embedding/dynamic.py``, ``checkpoint/delta.py`` and
``models/online_dlrm.py`` against the JAX package's on the same seeded
inputs, on the CPU.

- Stream logs: byte-identical for the same events; each package reads
  the other's; a corrupt mid-file record raises ``StreamCorruptError``
  in both.
- Dynamic tables: sketch slots and estimates, ``translate`` row ids
  through admission, eviction, TTL and growth, and every integer of
  ``state_dict`` exact; rows and slots after ``apply_row_grads``
  within rtol 1e-6, atol 1e-6 (``tests/test_torch_embedding.py``'s
  tolerance: the Adagrad accumulators reach ~100 and part by an ulp).
- Delta chains written by either package reconstruct in the other to
  the same state.
- ``worker_grads`` within 1e-6 of JAX's; ``OnlineTrainer`` over 200
  tiny events with a crash after an uncommitted batch and a restore:
  committed offsets, commit counts and table membership exact, dense
  parameters and tables within 1e-5 (``tests/test_torch_train_step.py``'s
  parameter tolerance), and no committed event replayed.
"""

import pickle

import numpy as np
import pytest

from distributed_tensorflow_tpu.checkpoint import delta as jdelta
from distributed_tensorflow_tpu.embedding import dynamic as jdyn
from distributed_tensorflow_tpu.embedding import embedding as jemb
from distributed_tensorflow_tpu.input import stream as jstream
from distributed_tensorflow_tpu.models import online_dlrm as jod

from distributed_tensorflow_tpu_torch.checkpoint import delta as tdelta
from distributed_tensorflow_tpu_torch.embedding import dynamic as tdyn
from distributed_tensorflow_tpu_torch.embedding import embedding as temb
from distributed_tensorflow_tpu_torch.input import stream as tstream
from distributed_tensorflow_tpu_torch.models import online_dlrm as tod

TABLE_ATOL = 1e-6
PARAM_ATOL = 1e-5


def _write(mod, path, n, seed=0):
    with mod.StreamWriter.open(path) as w:
        mod.append_chunk(w, mod.seeded_events(seed, w.next_offset, n,
                                              n_users=500, n_items=200))


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def test_stream_logs_are_byte_identical_and_cross_readable(tmp_path):
    a, b = str(tmp_path / "jax.log"), str(tmp_path / "port.log")
    _write(jstream, a, 48)
    _write(tstream, b, 48)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for reader, path in ((tstream, a), (jstream, b)):
        got = list(reader.StreamDataset(path).events(end_offset=48))
        assert [o for o, _ in got] == list(range(48))
    ref = jstream.seeded_events(3, 16, 32)
    for k, v in tstream.seeded_events(3, 16, 32).items():
        assert np.array_equal(v, ref[k]) and v.dtype == ref[k].dtype
    assert tstream.scan_log(a) == jstream.scan_log(b)


@pytest.mark.parametrize("mod", [jstream, tstream], ids=["jax", "port"])
def test_stream_midfile_corruption_raises(tmp_path, mod):
    path = str(tmp_path / "s.log")
    _write(tstream, path, 8)
    with open(path, "r+b") as f:
        f.seek(tstream.HEADER_BYTES + 3)
        f.write(b"\xff\xff\xff")
    with pytest.raises(mod.StreamCorruptError):
        mod.scan_log(path)
    with pytest.raises(mod.StreamCorruptError):
        list(mod.StreamReader(path).read_available())


# ---------------------------------------------------------------------------
# dynamic tables
# ---------------------------------------------------------------------------

def _table_cfgs(**kw):
    base = dict(dim=4, initial_capacity=8, max_capacity=32,
                admission_threshold=2, ttl_steps=3, seed=5)
    base.update(kw)
    return (jdyn.DynamicTableConfig(optimizer=jemb.Adagrad(0.1), **base),
            tdyn.DynamicTableConfig(optimizer=temb.Adagrad(0.1), **base))


def _ids(n_steps, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.zipf(1.3, size=12) - 1) % 60 for _ in range(n_steps)]


def _aux(sd):
    return pickle.loads(np.asarray(sd["aux"], np.uint8).tobytes())


def _drive(jt, tt, steps, rng_seed=2):
    """The same translate + apply sequence on both tables; every row id
    compared on the way."""
    rng = np.random.default_rng(rng_seed)
    for ids in steps:
        rj, rt = jt.translate(ids), tt.translate(ids)
        assert np.array_equal(rj, rt)
        g = rng.normal(size=(len(ids), jt.cfg.dim)).astype(np.float32)
        jt.apply_row_grads(rj, g, pad_to=16)
        tt.apply_row_grads(rt, g, pad_to=16)


def _assert_same_state(sj, st_):
    aj, at = _aux(sj), _aux(st_)
    for k in ("capacity", "id_to_row", "free", "step", "counters"):
        assert aj[k] == at[k], k
    for k in ("row_id", "row_freq", "row_last", "sketch_counts"):
        assert np.array_equal(aj[k], at[k]) and aj[k].dtype == at[k].dtype
    np.testing.assert_allclose(st_["rows"], sj["rows"], rtol=1e-6,
                               atol=TABLE_ATOL)
    for k, v in aj["slots"].items():
        np.testing.assert_allclose(at["slots"][k], v, rtol=1e-6,
                                   atol=TABLE_ATOL)


def test_sketch_slots_and_estimates_exact():
    js, ts = jdyn.CountMinSketch(64, 4, seed=9), tdyn.CountMinSketch(
        64, 4, seed=9)
    ids = np.random.default_rng(0).integers(0, 10**9, size=300)
    assert np.array_equal(js._slots(ids), ts._slots(ids))
    js.add(ids[:200])
    ts.add(ids[:200])
    assert np.array_equal(js.estimate(ids), ts.estimate(ids))
    assert np.array_equal(js.counts, ts.counts)
    for a, b in zip(js.delta(), ts.delta()):
        assert np.array_equal(a, b)


def test_translate_admission_eviction_ttl_growth_exact():
    """Membership through every path: 40 zipf batches into an 8-row table
    growing to 32 with a 3-step TTL; the rows, slots and state after."""
    cj, ct = _table_cfgs()
    jt, tt = jdyn.DynamicTable(cj), tdyn.DynamicTable(ct, device="cpu")
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    _drive(jt, tt, _ids(40))
    assert jt.grows > 0 and jt.evictions > 0 and jt.declined >= 0
    assert (tt.admissions, tt.evictions, tt.grows, tt.declined) == (
        jt.admissions, jt.evictions, jt.grows, jt.declined)
    _assert_same_state(jt.state_dict(), tt.state_dict())
    uj = np.asarray(jt.translate(np.arange(60), train=False))
    assert np.array_equal(uj, tt.translate(np.arange(60), train=False))


def test_state_dict_crosses_packages():
    cj, ct = _table_cfgs()
    jt = jdyn.DynamicTable(cj)
    jt2 = jdyn.DynamicTable(cj)
    tt = tdyn.DynamicTable(ct, device="cpu")
    _drive(jt, tdyn.DynamicTable(ct, device="cpu"), _ids(12))
    tt.load_state_dict(jt.state_dict())
    assert tdelta.states_equal(tt.state_dict(), jt.state_dict())
    jt2.load_state_dict(tt.state_dict())
    assert jdelta.states_equal(jt2.state_dict(), jt.state_dict())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_delta_chain_reconstructs_in_the_other_package(tmp_path, writer):
    cj, ct = _table_cfgs(max_capacity=8, ttl_steps=100)
    jt, tt = jdyn.DynamicTable(cj), tdyn.DynamicTable(ct, device="cpu")
    store = (jdelta if writer == "jax" else tdelta).DeltaSnapshotStore(
        str(tmp_path), full_every=4)
    src = jt if writer == "jax" else tt
    for i, ids in enumerate(_ids(10, seed=4)):
        _drive(jt, tt, [ids], rng_seed=10 + i)
        store.publish(src)
    kinds = [r["kind"] for r in store.record_sizes()]
    assert "delta" in kinds and "full" in kinds
    if writer == "jax":
        got, info = tdelta.DeltaSnapshotStore(str(tmp_path)).reconstruct(
            ct, device="cpu")
        assert tdelta.states_equal(got.state_dict(), jt.state_dict())
    else:
        got, info = jdelta.DeltaSnapshotStore(str(tmp_path)).reconstruct(cj)
        assert jdelta.states_equal(got.state_dict(), tt.state_dict())
    assert not info["chain_broken"]


# ---------------------------------------------------------------------------
# online DLRM
# ---------------------------------------------------------------------------

def test_worker_grads_match_jax():
    cfg_j, cfg_t = jod.OnlineConfig.tiny(), tod.OnlineConfig.tiny()
    rng = np.random.default_rng(0)
    dense_p = jod.init_dense(cfg_j)
    for k, v in tod.init_dense(cfg_t).items():
        assert np.array_equal(v, dense_p[k])
    b = cfg_j.batch_size
    ur = rng.normal(size=(b, cfg_j.embed_dim)).astype(np.float32)
    ir = rng.normal(size=(b, cfg_j.embed_dim)).astype(np.float32)
    dense = rng.normal(size=(b, cfg_j.n_dense)).astype(np.float32)
    labels = rng.integers(0, 2, size=b).astype(np.int32)
    want = jod.worker_grads(cfg_j, dense_p, ur, ir, dense, labels)
    got = tod.worker_grads(cfg_t, dense_p, ur, ir, dense, labels)
    np.testing.assert_allclose(float(got[0]), float(want[0]), atol=1e-6)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), v, rtol=0, atol=1e-6)
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                   atol=1e-6)


TOTAL, COMMIT_EVERY, CRASH_AFTER = 200, 5, 7


def _trainer_runs(mod, cfg, stream, tmp, **kw):
    """A crash after 7 applied batches (5 committed), a restore, the
    rest; and an uncrashed run of the same stream."""
    ck = str(tmp / "ck")
    t1 = mod.OnlineTrainer(cfg, stream, ck, commit_every=COMMIT_EVERY, **kw)
    with pytest.raises(RuntimeError):
        t1.run(TOTAL, idle_timeout_s=2.0, crash_after_batches=CRASH_AFTER)
    t2 = mod.OnlineTrainer(cfg, stream, ck, commit_every=COMMIT_EVERY, **kw)
    resumed = t2.restore()
    out = t2.run(TOTAL, idle_timeout_s=2.0)
    ref = mod.OnlineTrainer(cfg, stream, str(tmp / "ck_ref"),
                            commit_every=COMMIT_EVERY, **kw)
    ref_out = ref.run(TOTAL, idle_timeout_s=2.0)
    return {"resumed": resumed, "out": out, "t": t2, "ref": ref,
            "ref_out": ref_out}


def _host(x):
    return x.detach().numpy() if hasattr(x, "detach") else np.asarray(x)


@pytest.fixture(scope="module")
def online_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("online")
    stream = str(tmp / "events.log")
    _write(tstream, stream, TOTAL, seed=11)
    (tmp / "j").mkdir()
    (tmp / "t").mkdir()
    j = _trainer_runs(jod, jod.OnlineConfig.tiny(), stream, tmp / "j")
    t = _trainer_runs(tod, tod.OnlineConfig.tiny(), stream, tmp / "t",
                      device="cpu")
    return j, t


def test_online_trainer_crash_restore_matches_jax(online_runs):
    j, t = online_runs
    bs = tod.OnlineConfig.tiny().batch_size
    # committed cursor = contiguous applied prefix: 5 of 7 batches
    assert t["resumed"] == j["resumed"] == \
        (CRASH_AFTER // COMMIT_EVERY) * COMMIT_EVERY * bs
    for k in ("offset", "steps", "events_applied", "commits"):
        assert t["out"][k] == j["out"][k], k
    assert t["out"]["tables"] == j["out"]["tables"]
    for run in ("t", "ref"):
        sj, st_ = j[run]._state_nested(), t[run]._state_nested()
        for name in ("user", "item"):
            aj, at = _aux(sj[name]), _aux(st_[name])
            assert aj["id_to_row"] == at["id_to_row"]
            assert np.array_equal(aj["row_id"], at["row_id"])
            np.testing.assert_allclose(st_[name]["rows"], sj[name]["rows"],
                                       rtol=0, atol=PARAM_ATOL)
        for k, v in sj["dense"]["params"].items():
            np.testing.assert_allclose(st_["dense"]["params"][k], v, rtol=0,
                                       atol=PARAM_ATOL)


def test_crash_restore_equals_uncrashed_run_and_replays_nothing(online_runs):
    _, t = online_runs
    assert t["out"]["offset"] == t["ref_out"]["offset"] == TOTAL
    # the restored incarnation applied only events after the cursor
    assert t["out"]["events_applied"] == TOTAL - t["resumed"]
    a, b = t["t"]._state_nested(), t["ref"]._state_nested()
    for name in ("user", "item"):
        assert _aux(a[name])["id_to_row"] == _aux(b[name])["id_to_row"]
        np.testing.assert_allclose(a[name]["rows"], b[name]["rows"], rtol=0,
                                   atol=PARAM_ATOL)
    for k, v in b["dense"]["params"].items():
        np.testing.assert_allclose(a["dense"]["params"][k], v, rtol=0,
                                   atol=PARAM_ATOL)


def test_online_checkpoints_cross_packages(online_runs, tmp_path):
    """The port restores JAX's last online checkpoint and the JAX
    package the port's: cursor, step and membership exact."""
    j, t = online_runs
    for src, mod, cfg in ((j["t"], tod, tod.OnlineConfig.tiny()),
                          (t["t"], jod, jod.OnlineConfig.tiny())):
        kw = {"device": "cpu"} if mod is tod else {}
        other = mod.OnlineTrainer(cfg, src.stream_path,
                                  src._mgr.directory, **kw)
        assert other.restore() == TOTAL
        assert other.step == src.step
        assert _aux(other.user_table.state_dict())["id_to_row"] == \
            src.user_table.id_to_row
        np.testing.assert_array_equal(
            _host(other.dense_params["w0"]), _host(src.dense_params["w0"]))


def test_coordinator_path_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        tod.OnlineTrainer(tod.OnlineConfig.tiny(), str(tmp_path / "s"),
                          str(tmp_path / "ck"), coordinator=object(),
                          device="cpu")


def test_eval_snapshot_matches_jax(online_runs):
    j, t = online_runs
    state = j["t"]._state_nested()
    want = jod.eval_snapshot(jod.OnlineConfig.tiny(), state)
    got = tod.eval_snapshot(tod.OnlineConfig.tiny(), state, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)

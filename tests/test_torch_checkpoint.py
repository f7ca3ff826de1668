"""Port parity: ``checkpoint/checkpoint.py``, ``checkpoint/peer_snapshot.py``,
``checkpoint/failure_handling.py``, ``checkpoint/preemption_watcher.py``,
``cluster/elastic.py`` and ``cluster/coordination.py`` (one process)
against the JAX package's, on the CPU.

- Checkpoints cross packages both ways with leaves equal bitwise: f32,
  bf16 (``|V2`` on disk; JAX restores the raw void, read here through
  ``ml_dtypes``), int and scalar leaves; a flax ``TransformerLM`` tiny
  parameter tree through the name map of ``models/transformer.py``
  (``jax_params_layout`` / ``params_from_flat``); rotated and pinned
  checkpoints. A torn shard raises ``CheckpointCorruptError`` in both.
- ``restore_latest`` picks the same tier and step as JAX's on the same
  directories and snapshot stores; ``peer_snapshot._decide`` decides as
  JAX's on random inventories, and ``pack`` writes JAX's npz members.
- A train-save-restore-resume run equals the uninterrupted run: a
  fresh model restores the saved state (parameters, f32 or bf16 ``mu``,
  ``nu``, count) bitwise; its resumed losses are within 2e-6 and its
  parameters and moments within 1e-5 of the uninterrupted run's
  (``tests/test_torch_train_step.py``'s tolerances), a bf16 ``mu``
  within one bf16 ulp (rtol 2^-7). CPU training is not bitwise
  repeatable: two runs from the same weights part by up to 5e-8
  (oneDNN's sums depend on buffer alignment, the embedding backward's
  on threads), which flips the rounding of a few bf16 moments (measured
  1.5e-5, and 1.4e-6 in a parameter after it).
- The preemption handler, the watcher, the elastic helpers and the
  local coordination service give JAX's results for the same calls.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
from distributed_tensorflow_tpu.checkpoint import checkpoint as jck
from distributed_tensorflow_tpu.checkpoint import failure_handling as jfh
from distributed_tensorflow_tpu.checkpoint import peer_snapshot as jps
from distributed_tensorflow_tpu.cluster import coordination as jco
from distributed_tensorflow_tpu.cluster import elastic as jel
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JLM)
from distributed_tensorflow_tpu.training.model import _unflatten_like

from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tck
from distributed_tensorflow_tpu_torch.checkpoint import failure_handling as tfh
from distributed_tensorflow_tpu_torch.checkpoint import peer_snapshot as tps
from distributed_tensorflow_tpu_torch.checkpoint import (
    preemption_watcher as tpw)
from distributed_tensorflow_tpu_torch.cluster import coordination as tco
from distributed_tensorflow_tpu_torch.cluster import elastic as tel
from distributed_tensorflow_tpu_torch.models import transformer as T


def _leaves():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf = rng.normal(size=(4, 2)).astype(ml_dtypes.bfloat16)
    i64 = rng.integers(-9, 9, size=(6,)).astype(np.int64)
    i32 = rng.integers(0, 9, size=(2, 2)).astype(np.int32)
    return f32, bf, i64, i32


def _jax_state():
    f32, bf, i64, i32 = _leaves()
    return {"w": f32, "b": jax.numpy.asarray(bf), "ids": i64,
            "nested": [i32, np.float64(2.5)], "step": np.int64(7)}


def _port_state():
    f32, bf, i64, i32 = _leaves()
    return {"w": torch.from_numpy(f32.copy()),
            "b": torch.from_numpy(bf.view(np.int16).copy()).view(
                torch.bfloat16),
            "ids": torch.from_numpy(i64.copy()),
            "nested": [torch.from_numpy(i32.copy()), np.float64(2.5)],
            "step": np.int64(7)}


def _bits(x):
    """A leaf's bytes and numpy dtype name, whatever package made it."""
    if isinstance(x, torch.Tensor):
        return tck.to_numpy(x.contiguous()).tobytes(), tck.dtype_name(x)
    a = np.asarray(x)
    if a.dtype.kind == "V":        # JAX's restore of bf16: raw |V2
        a = a.view(ml_dtypes.bfloat16)
    return a.tobytes(), str(a.dtype)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_leaves_cross_packages_bitwise(tmp_path, writer):
    if writer == "jax":
        path = jck.Checkpoint(state=_jax_state()).save(str(tmp_path / "c"))
        got = tck.Checkpoint(state=_port_state()).restore(path)
        assert got["state/b"].dtype == torch.bfloat16
    else:
        path = tck.Checkpoint(state=_port_state()).save(str(tmp_path / "c"))
        got = jck.Checkpoint(state=_jax_state()).restore(path)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert z["state__b"].dtype == np.dtype("V2")
    with open(os.path.join(path, "checkpoint.index.json")) as f:
        index = json.load(f)
    assert index["format"] == 1
    assert index["leaves"]["state/b"]["dtype"] == "bfloat16"
    want = jck._flatten(_jax_state())
    for name, w in want.items():
        assert _bits(got[f"state/{name}"]) == _bits(w), name


def _npz_members(path):
    """Each npz member's name, dtype, shape and bytes, in file order (a
    zip member's header carries its write time, so files of two writes
    differ only there)."""
    with np.load(path) as z:
        return [(k, z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files]


def test_index_and_shard_members_equal_jax(tmp_path):
    """The same state written by each package: the same index leaves, the
    same shard size and the same npz members in the same order."""
    pj = jck.Checkpoint(state=_jax_state()).save(str(tmp_path / "j"))
    pt = tck.Checkpoint(state=_port_state()).save(str(tmp_path / "t"))
    ij, it = (json.load(open(os.path.join(p, "checkpoint.index.json")))
              for p in (pj, pt))
    assert ij["leaves"] == it["leaves"]
    assert ij["shards"]["shard_0.npz"]["size"] == \
        it["shards"]["shard_0.npz"]["size"]
    assert _npz_members(os.path.join(pj, "shard_0.npz")) == \
        _npz_members(os.path.join(pt, "shard_0.npz"))


@pytest.fixture(scope="module")
def flax_params():
    cfg = JConfig.tiny()
    tokens = jax.numpy.zeros((1, 8), jax.numpy.int32)
    p = JLM(cfg).init(jax.random.PRNGKey(3), tokens)["params"]
    return jax.tree_util.tree_map(np.asarray, dict(p))


@pytest.mark.parametrize("scan_layers", [True, False])
def test_flax_params_cross_through_the_name_map(tmp_path, flax_params,
                                                scan_layers):
    """JAX writes ``Checkpoint(params=flax tree)``, the port restores its
    parameter dict; the port writes ``jax_params_layout`` and JAX
    restores the flax tree: bitwise both ways (``scan_layers=False``
    exercises the ``layer_<i>`` names)."""
    cfg_t = T.TransformerConfig.tiny(scan_layers=scan_layers)
    tree = flax_params
    if not scan_layers:
        tree = T._map_leaves(lambda p, t: t.numpy(), T.jax_params_layout(
            cfg_t, T.params_from_jax(cfg_t, flax_params, "cpu")))
    path = jck.Checkpoint(params=tree).save(str(tmp_path / "j"))
    got = T.params_from_flat(
        cfg_t, tck.Checkpoint(params=T.params_template(cfg_t)).restore(path),
        "params", "cpu")
    want = T.params_from_jax(cfg_t, flax_params, "cpu")
    T._map_leaves(lambda p, a, b: np.testing.assert_array_equal(
        a.numpy(), b.numpy(), err_msg=str(p)), got, want)
    path2 = tck.Checkpoint(params=T.jax_params_layout(cfg_t, got)).save(
        str(tmp_path / "t"))
    back = _unflatten_like(tree, jck.Checkpoint(params=tree).restore(path2),
                           "params")
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_rotation_pinning_and_at_step_cross(tmp_path, monkeypatch):
    """JAX rotates (max_to_keep 2, a pin at most every 3 s of a clock
    that moves 2 s a save) and the port lists
    and pin-restores the same directory; then the port rotates on and
    JAX sees what the port left."""
    d = str(tmp_path / "d")
    clock = [1000.0]
    monkeypatch.setattr(jck.time, "time", lambda: clock[0])
    monkeypatch.setattr(tck.time, "time", lambda: clock[0])
    jm = jck.CheckpointManager(jck.Checkpoint(s={"x": np.zeros(2)}), d,
                               max_to_keep=2,
                               keep_checkpoint_every_n_hours=3 / 3600)
    for n in range(1, 5):
        clock[0] += 2
        jm.checkpoint._objects["s"] = {"x": np.full(2, float(n))}
        jm.save(n)
    tm = tck.CheckpointManager(tck.Checkpoint(s={"x": np.zeros(2)}), d,
                               max_to_keep=2,
                               keep_checkpoint_every_n_hours=3 / 3600)
    assert tm.checkpoints == jm.checkpoints
    assert tm.latest_checkpoint == jm.latest_checkpoint
    assert tm._kept_pinned == jm._kept_pinned and tm._kept_pinned
    pinned = int(tm._kept_pinned[0].rsplit("-", 1)[1])
    tier, step, flat = tm.restore_latest(at_step=pinned)
    assert (tier, step) == ("durable", pinned)
    np.testing.assert_array_equal(flat["s/x"], np.full(2, float(pinned)))
    for n in range(5, 7):
        clock[0] += 2
        tm.checkpoint._objects["s"] = {"x": np.full(2, float(n))}
        tm.save(n)
    jm2 = jck.CheckpointManager(jck.Checkpoint(s={"x": np.zeros(2)}), d,
                                max_to_keep=2,
                                keep_checkpoint_every_n_hours=3 / 3600)
    assert jm2.checkpoints == tm.checkpoints
    assert jm2._kept_pinned == tm._kept_pinned
    assert [os.path.basename(p) for p in tm.checkpoints] == [
        "ckpt-1", "ckpt-3", "ckpt-5", "ckpt-6"]
    for mod in (jck, tck):
        for gone in (2, 4):
            with pytest.raises(FileNotFoundError):
                mod.latest_checkpoint(d, at_step=gone)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_shard_raises_in_both(tmp_path, writer):
    mod = jck if writer == "jax" else tck
    state = _jax_state() if writer == "jax" else _port_state()
    path = mod.Checkpoint(state=state).save(str(tmp_path / "c"))
    shard = os.path.join(path, "shard_0.npz")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 7)
    with pytest.raises(jck.CheckpointCorruptError):
        jck.Checkpoint(state=_jax_state()).restore(path)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.Checkpoint(state=_port_state()).restore(path)
    for mod in (jck, tck):
        with pytest.raises(mod.CheckpointCorruptError):
            mod.latest_checkpoint(str(tmp_path), name="c", at_step=1)


TIER_CASES = [(2, 1, None), (1, 2, None), (2, 2, None), (2, 2, 3),
              (3, 1, 2), (None, None, 4), (None, None, None)]


@pytest.mark.parametrize("case", TIER_CASES, ids=str)
def test_restore_latest_picks_jax_tier(tmp_path, case):
    local, durable, mem = case
    got = {}
    for name, ck, ps in (("jax", jck, jps), ("port", tck, tps)):
        root = tmp_path / name
        store = ps.SnapshotStore()
        mgr = ck.CheckpointManager(
            ck.Checkpoint(s={"x": np.zeros(3)}), str(root / "durable"),
            local_dir=str(root / "local"), snapshot_store=store)
        for tier, step in (("local", local), ("durable", durable)):
            if step is None:
                continue
            c = ck.Checkpoint(s={"x": np.full(3, float(step))})
            c._save_counter = step - 1
            c.save(str(root / tier / "ckpt"))
        if mem is not None:
            mgr.checkpoint._objects["s"] = {"x": np.full(3, float(mem))}
            mgr.snapshot(mem)
        res = mgr.restore_latest()
        got[name] = None if res is None else (
            res[0], res[1], float(np.asarray(res[2]["s/x"])[0]))
    assert got["port"] == got["jax"]


def test_decide_matches_jax_on_random_inventories():
    rng = np.random.default_rng(5)
    for _ in range(200):
        world = int(rng.integers(1, 5))
        inv = {}
        for pid in range(world):
            per = {}
            for owner in range(world):
                steps = rng.integers(1, 6, size=int(rng.integers(0, 3)))
                if len(steps):
                    per[owner] = {int(s): world for s in steps}
            inv[pid] = per
        disk = (None if rng.random() < 0.3 else
                (int(rng.integers(1, 6)), "/d/ckpt", "durable"))
        assert tps._decide(inv, disk) == jps._decide(inv, disk)
        assert tps._complete_memory_steps(inv) == \
            jps._complete_memory_steps(inv)
    for world in range(1, 6):
        doms = {p: p % 2 for p in range(world)}
        assert tps.assign_replicators(world, doms) == \
            jps.assign_replicators(world, doms)


def test_pack_members_equal_jax_and_unpack_cross():
    f32, bf, i64, _ = _leaves()
    arrays_j = {"a": f32, "b": bf, "c::off": np.asarray([4], np.int64)}
    arrays_t = {"a": f32, "b": bf.view(np.int16).view(np.dtype("V2")),
                "c::off": np.asarray([4], np.int64)}
    meta = dict(owner=1, step=9, world=2, index={"leaves": {}, "format": 1})
    bj = jps.pack(jps.HostSnapshot(arrays=arrays_j, **meta))
    bt = tps.pack(tps.HostSnapshot(arrays=arrays_t, **meta))
    assert len(bj) == len(bt)
    import io
    assert _npz_members(io.BytesIO(bj)) == _npz_members(io.BytesIO(bt))
    snap = tps.unpack(bj)
    assert (snap.owner, snap.step, snap.world) == (1, 9, 2)
    assert snap.arrays["b"].tobytes() == bf.tobytes()
    back = jps.unpack(bt)
    assert back.index == meta["index"]
    assert back.arrays["a"].tobytes() == f32.tobytes()


def test_memdir_snapshots_cross_packages(tmp_path):
    f32 = _leaves()[0]
    js = jps.SnapshotStore(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        js.put(jps.HostSnapshot(owner=0, step=step, world=1,
                                index={"leaves": {}}, arrays={"a": f32}))
    ts = tps.SnapshotStore(str(tmp_path), keep=2)
    assert ts.load_surviving() == 2
    assert ts.inventory() == js.inventory()


# ---------------------------------------------------------------------------
# train, save, restore, resume
# ---------------------------------------------------------------------------

def _fresh(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    m = T.TransformerLM(cfg, device="cpu", generator=g)
    o = T.make_optimizer(cfg, m.parameters())
    return {"model": m, "optimizer": o, "step": 0}, T.make_train_step(cfg,
                                                                      m, o)


def _snapshot(cfg, state):
    flat = tck._flatten(T.train_state_variables(cfg, state))
    return {k: v.read_value().clone() for k, v in flat.items()}


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16mu"])
def test_train_save_restore_resume_equals_uninterrupted(tmp_path, mu_dtype):
    """Save at step 3 of 6 (async, local tier first); a fresh model
    restores the saved state bitwise and its steps 4-6 match the
    uninterrupted run's (module docstring's tolerances)."""
    cfg = T.TransformerConfig.tiny(adam_mu_dtype=mu_dtype)
    tok = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq_len),
                        generator=torch.Generator().manual_seed(1))
    state, step = _fresh(cfg, 0)
    losses = []
    for i in range(6):
        state, m = step(state, {"tokens": tok})
        losses.append(float(m["loss"]))
        if i == 2:
            ckpt = tck.Checkpoint(**T.train_state_variables(cfg, state),
                                  step=np.int64(state["step"]))
            tck.CheckpointManager(ckpt, str(tmp_path / "d"),
                                  local_dir=str(tmp_path / "l")).save(3)
            saved = _snapshot(cfg, state)
    ckpt.sync()
    state2, step2 = _fresh(cfg, 9)
    mgr = tck.CheckpointManager(
        tck.Checkpoint(**T.train_state_variables(cfg, state2),
                       step=np.int64(0)),
        str(tmp_path / "d"), local_dir=str(tmp_path / "l"))
    tier, n, flat = mgr.restore_latest()
    assert (tier, n, int(flat["step"])) == ("local", 3, 3)
    state2["step"] = int(flat["step"])
    for k, v in _snapshot(cfg, state2).items():
        assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k
    resumed = []
    for _ in range(3):
        state2, m = step2(state2, {"tokens": tok})
        resumed.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, losses[3:], rtol=0, atol=2e-6)
    a, b = _snapshot(cfg, state), _snapshot(cfg, state2)
    for k in a:
        bf16 = a[k].dtype == torch.bfloat16
        np.testing.assert_allclose(b[k].float().numpy(),
                                   a[k].float().numpy(),
                                   rtol=2 ** -7 if bf16 else 0, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# preemption, elastic, local coordination
# ---------------------------------------------------------------------------

def _preempt_run(fh, ck, root, exit_mode, preempt_at, steps=6):
    mgr = ck.CheckpointManager(ck.Checkpoint(s={"x": np.zeros(2)}),
                               str(root))
    h = fh.PreemptionCheckpointHandler(
        mgr, fh.TerminationConfig(exit_mode=exit_mode))
    seen = None
    try:
        for i in range(steps):
            if i == preempt_at:
                h.watch_preemption()
            h.run(lambda: None)
    except (SystemExit, fh.TrainingPreempted) as e:
        seen = (type(e).__name__, getattr(e, "code", None))
    finally:
        h._restore_signal_handler()
    return seen, [os.path.basename(p) for p in mgr.checkpoints], \
        h.total_run_calls


@pytest.mark.parametrize("exit_mode", ["exit", "restart"])
def test_preemption_handler_matches_jax(tmp_path, exit_mode):
    j = _preempt_run(jfh, jck, tmp_path / "j", exit_mode, 2)
    t = _preempt_run(tfh, tck, tmp_path / "t", exit_mode, 2)
    assert t == j and t[0] is not None
    assert tfh.EXIT_PREEMPTED == jfh.EXIT_PREEMPTED == 42


def test_preemption_watcher_sees_sigterm_and_restores_handler():
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    with tpw.PreemptionWatcher() as w:
        os.kill(os.getpid(), signal.SIGTERM)
        w.block_until_worker_exit(timeout=5)
        assert w.preemption_message == f"signal {int(signal.SIGTERM)}"
    assert signal.getsignal(signal.SIGTERM) == prev


def test_elastic_helpers_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(jel.ENV_SUPERVISOR_DIR, str(tmp_path))
    monkeypatch.setenv("DTX_MPR_TASK_INDEX", "3")
    monkeypatch.setenv(jel.ENV_GENERATION, "2")
    assert tel.ENV_GENERATION == jel.ENV_GENERATION
    for f in ("generation", "under_supervisor", "peer_memdir"):
        assert getattr(tel, f)() == getattr(jel, f)(), f
    assert tel.namespace("k") == jel.namespace("k") == "gen2/k"
    with tel.generation_override(5):
        assert tel.namespace("k") == "gen5/k"
    tel.heartbeat(17)
    step, wall = open(jel.heartbeat_path(str(tmp_path), 3)).read().split()
    assert step == "17" and float(wall) > 0
    with open(jel.drain_path(str(tmp_path), 3), "w") as f:
        f.write("full")
    assert tel.drain_mode() == jel.drain_mode() == "full"
    assert tel.drain_requested() and jel.drain_requested()
    assert tel.peer_memdir_path("s", 1) == jel.peer_memdir_path("s", 1)


def test_local_coordination_service_matches_jax():
    """One op sequence on a fresh local service of each package: the
    same values, errors and listings."""
    out = {}
    for name, mod in (("jax", jco), ("port", tco)):
        s = mod._LocalService()
        log = []
        s.set("a/1", b"x")
        s.set("a/2", b"y")
        s.set("b", b"z")
        try:
            s.set("b", b"w", allow_overwrite=False)
        except mod.CoordinationError:
            log.append("once")
        log.append(s.increment("n", 3))
        log.append(s.increment("n", 2))
        log.append(s.get("n", 1.0))
        log.append(s.dir_get("a/"))
        s.delete("a")
        log.append(s.dir_get("a/"))
        log.append(s.try_get("missing"))
        try:
            s.get("missing", 0.05)
        except mod.CoordinationError:
            log.append("timeout")
        try:
            s.barrier("bar", 0.05, 2, participant=0)
        except mod.BarrierTimeoutError as e:
            log.append(str(e).split(":", 1)[1])
        s.barrier("solo", 0.05, 1)
        out[name] = log
    assert out["port"] == out["jax"]
    agent = tco.coordination_service()
    assert not agent.is_distributed and agent.process_id == 0
    assert agent.live_processes() == [0]

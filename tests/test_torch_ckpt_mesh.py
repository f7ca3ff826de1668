"""Port: checkpoints across meshes and the multi-process coordination
service, on 4 gloo ranks (one spawn), ``tiny()``.

- ``cluster/coordination.py`` over the process group's store: a
  write-once key is won by exactly one rank and the others get JAX's
  ``CoordinationError``; ``key_value_dir_get`` lists every rank's key
  (overwrites listed once); ``key_value_increment`` is atomic; a barrier
  one rank misses raises ``BarrierTimeoutError`` naming it; a blocking
  get times out with ``CoordinationError``; a directory delete removes
  the keys under it.
- ``parallel/values.py``: ON_READ reads (SUM, MEAN, ONLY_FIRST_REPLICA)
  equal JAX's ``SyncOnReadVariable`` on the same rows; a row-cut
  variable gathers, assigns in place and restores onto another mesh.
- A ``{"dp": 2, "tp": 2}`` train state (parameters and AdamW moments,
  ``models/transformer.train_state_variables``) saved after 2 steps
  restores onto ``{"tp": 4}`` and onto one process bitwise; the next
  step's loss on tp 4 is within 2e-6 of dp2×tp2's
  (``tests/test_torch_dp_train.py``'s loss tolerance); a tp 4 save
  restores back onto dp2×tp2 bitwise.
- The restore ladder with ring-replicated host snapshots over the KV:
  after rank 1's memory is wiped, every rank restores the freshest
  state from memory (tier ``peer``: parts fetched from their holders),
  which is the best tier available, and the decision equals JAX's
  ``peer_snapshot._decide`` on the gathered inventories.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import peer_snapshot as jps
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, synthetic_tokens)
from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    Checkpoint, CheckpointManager, _flatten)
from distributed_tensorflow_tpu_torch.models import transformer as T
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_ckpt_ranks
from torch_tp_jax import jax_run

GB = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = JConfig.tiny()
    tokens = np.asarray(synthetic_tokens(GB, cfg.max_seq_len, cfg.vocab_size,
                                         seed=3)).astype(np.int64)
    init = jax_run({"tp": 1}, {}, {}, tokens, 0)["init"]
    workdir = str(tmp_path_factory.mktemp("ckpt_mesh"))
    out = multi_process_runner.run(
        torch_ckpt_ranks.ckpt_mesh_rank, 4, args=(init, tokens, workdir),
        device="cpu", timeout=300).return_values
    return out, workdir


def test_coordination_agent_over_the_store(ranks):
    out, _ = ranks
    coord = [r["coord"] for r in out]
    assert all(c["distributed"] for c in coord)
    assert [c["ids"] for c in coord] == [(i, 4) for i in range(4)]
    assert sum(c["once"] for c in coord) == 1
    winner = [i for i, c in enumerate(coord) if c["once"]][0]
    assert {c["once_value"] for c in coord} == {f"r{winner}"}
    want = [(f"dir/r{i}", str(i * 10)) for i in range(4)]
    assert all(c["dir"] == want for c in coord)
    assert sorted(c["inc"] for c in coord)[-1] == 10
    assert all(c["ctr"] == 10 for c in coord)
    assert all(c["get_timeout"] == "CoordinationError" for c in coord)
    assert all(c["missing"] is None for c in coord)
    for c in coord[:3]:
        assert "3/4 arrived" in c["partial"] and "[3]" in c["partial"]
    assert all(c["dir_after_delete"] == [] for c in coord)


def test_distributed_variables_read_assign_and_reshard(ranks):
    """``parallel/values.py`` against JAX's variables on its 4-device
    mesh: ON_READ reads of the same per-replica rows (SUM, MEAN,
    ONLY_FIRST_REPLICA) equal; a row-cut variable reads its global
    value, assigns in place, and restores onto another mesh."""
    from distributed_tensorflow_tpu.parallel import values as jvalues
    from torch_tp_jax import jax_mesh
    out, _ = ranks
    rows = np.arange(12.0, dtype=np.float32).reshape(4, 3) - 5.0
    for agg in ("sum", "mean", "only_first_replica"):
        want = np.asarray(jvalues.SyncOnReadVariable(
            rows, mesh=jax_mesh({"dp": 4}),
            aggregation=jvalues.VariableAggregation(agg)).read_value())
        for r in out:
            np.testing.assert_allclose(r["values"][agg], want, rtol=0,
                                       atol=1e-6)
    full = np.arange(40.0, dtype=np.float32).reshape(5, 8)
    for r in out:
        v = r["values"]
        assert v["local_shape"] == (3, 8)
        assert np.array_equal(v["gathered"], full)
        assert np.array_equal(v["assigned"], full * 2)
        assert np.array_equal(v["restored"]["cut"], full * 2)
        assert np.array_equal(v["restored"]["on_read"], rows.sum(0))
        assert np.array_equal(v["restored"]["mirrored"], np.full(3, 7.0))


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dp2tp2_save_restores_onto_tp4_and_back(ranks):
    out, _ = ranks
    saved = out[0]["saved"]
    for r in out:
        _equal(r["saved"], saved)
        tier, n, got = r["restored_b"]
        assert (tier, n) == ("durable", 2)
        _equal(got, saved)
        _equal(r["restored_c"], out[0]["saved_b"])
        np.testing.assert_allclose(r["loss_b"], r["loss_a"], rtol=0,
                                   atol=2e-6)


def test_dp2tp2_save_restores_onto_one_process(ranks):
    out, workdir = ranks
    cfg = T.TransformerConfig.tiny()
    model = T.TransformerLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    state = {"model": model, "optimizer": T.make_optimizer(
        cfg, model.parameters()), "step": 0}
    variables = T.train_state_variables(cfg, state)
    mgr = CheckpointManager(Checkpoint(**variables, step=np.int64(0)),
                            f"{workdir}/a")
    tier, n, flat = mgr.restore_latest()
    assert (tier, n, int(flat["step"])) == ("durable", 2, 2)
    got = {k: v.read_value().float().numpy()
           for k, v in _flatten(variables).items()}
    _equal(got, out[0]["saved"])


def test_restore_ladder_after_a_wiped_memory(ranks):
    out, _ = ranks
    all_inv = {r["rank"]: r["inventory"] for r in out}
    assert all_inv[1] == {}
    want = jps._decide(all_inv, (4, "<disk>", "local"))
    assert want["source"] == "memory" and want["step"] == 5
    for r in out:
        lad = r["ladder"]
        assert (lad["tier"], lad["step"]) == ("peer", 5)
        assert lad["best_available"] == "memory"
        assert lad["available"] == {"memory": 5, "local": 4, "durable": 4}
        _equal(r["ladder_state"], out[0]["saved_b"])

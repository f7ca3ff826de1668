"""Port parity: ``parallel/pipeline.py`` — the schedule math exactly
JAX's, and the executor (``run_schedule`` over ``StageLinks``) on 2 and
4 gloo ranks against JAX's pipelines on ``tests/test_pipeline.py``'s toy
stage.

- ``bubble_fraction``, ``schedule_table``, ``validate_schedule`` (also
  on damaged tables), ``schedule_spans`` and ``schedule_idle_fraction``
  equal JAX's for every ``(S, M, schedule, v)`` of a grid, and raise the
  same exception with the same message where JAX's raise.
- The toy pipeline (4 model stages of ``tanh(x @ w + b)``, an MSE head,
  8 microbatches of 4 × 16): GPipe and 1F1B at 4 ranks against JAX's
  ``make_pipelined_fn`` (under ``jax.value_and_grad``) and
  ``make_1f1b_fn`` on a ``{"pp": 4}`` mesh; at 2 ranks interleaved v=2
  over the same 4 stages against ``make_interleaved_1f1b_fn``, and
  GPipe and 1F1B over the first two stages. Loss, every stage's
  gradient, the head's and the input's within JAX's own test tolerance
  (rtol 1e-5, atol 1e-6); interleaved v=1 bitwise equal to 1F1B; the
  P2P counts those of the schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.cluster.topology import make_mesh
from distributed_tensorflow_tpu.parallel import pipeline as jpl
from distributed_tensorflow_tpu_torch.parallel import pipeline as tpl
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_pp_ranks

GRID = [(s, m, v) for s in (1, 2, 3, 4) for m in (1, 2, 4, 6, 8)
        for v in (1, 2, 3)]
SCHEDULES = ("gpipe", "1f1b", "interleaved")
N_STAGES, N_MICRO, MB, DIM = 4, 8, 4, 16


def _both(fn_name, *args, **kw):
    """(result or (exception type, message)) of JAX's and the port's."""
    out = []
    for mod in (jpl, tpl):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kw)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_bubble_fraction_equals_jax():
    for s, m, v in GRID:
        for sched in SCHEDULES + ("pipedream-2bw",):
            got_j, got_t = _both("bubble_fraction", s, m, sched,
                                 interleave=v)
            assert got_t == got_j, (s, m, v, sched)
    for v in (0, -1):
        got_j, got_t = _both("bubble_fraction", 4, 8, "interleaved",
                             interleave=v)
        assert got_t == got_j and got_t[0] == "ValueError"


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_table_and_validity_equal_jax(sched):
    for s, m, v in GRID + [(0, 4, 1), (2, 0, 1), (2, 4, 0)]:
        got_j, got_t = _both("schedule_table", s, m, sched, interleave=v)
        assert got_t == got_j, (s, m, v)
        if got_j[0] != "ok":
            continue
        table = got_j[1]
        assert tpl.validate_schedule(table) == jpl.validate_schedule(table)
        assert tpl.validate_schedule(table) == [], (s, m, v)
        # damaged tables: a unit dropped, a cell double-booked, a unit
        # moved before its dependency
        damaged = [table[1:], table + [dict(table[0])]]
        if len(table) > 1:
            moved = [dict(e) for e in table]
            moved[-1]["cycle"] = -1
            damaged.append(moved)
        for bad in damaged:
            assert tpl.validate_schedule(bad) == jpl.validate_schedule(bad)
    assert tpl.validate_schedule([]) == jpl.validate_schedule([])
    for bad in ("bogus", "interleaved-2x"):
        got_j, got_t = _both("schedule_table", 2, 4, bad)
        assert got_t == got_j and got_t[0] == "ValueError"


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_spans_and_idle_equal_jax(sched):
    for s, m, v in GRID:
        for t_cycle in (1.0, 0.25):
            got_j, got_t = _both("schedule_spans", s, m, sched,
                                 t_cycle_s=t_cycle, interleave=v)
            assert got_t == got_j, (s, m, v)
            if got_j[0] == "ok":
                assert tpl.schedule_idle_fraction(got_t[1]) == \
                    jpl.schedule_idle_fraction(got_j[1])
    assert tpl.schedule_idle_fraction([]) == jpl.schedule_idle_fraction([])
    for args in ((0, 4), (2, 0)):
        got_j, got_t = _both("schedule_spans", *args, sched)
        assert got_t == got_j and got_t[0] == "ValueError"
    got_j, got_t = _both("schedule_spans", 2, 4, "pipedream-2bw")
    assert got_t == got_j


def test_stack_stage_params_equals_jax():
    rng = np.random.default_rng(0)
    per_stage = [{"w": rng.normal(size=(3, 3)).astype(np.float32),
                  "inner": {"b": rng.normal(size=3).astype(np.float32)}}
                 for _ in range(4)]
    want = jpl.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                   for p in per_stage])
    got = tpl.stack_stage_params([{"w": torch.from_numpy(p["w"]),
                                   "inner": {"b": torch.from_numpy(
                                       p["inner"]["b"])}}
                                  for p in per_stage])
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(got["inner"]["b"].numpy(),
                          np.asarray(want["inner"]["b"]))


# ---------------------------------------------------------------------------
# The executor on the toy stage
# ---------------------------------------------------------------------------

def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _head_fn(hp, y, t):
    return jnp.mean((y @ hp["wo"] - t) ** 2)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    per_stage = [{"w": rng.normal(0, 0.5, (DIM, DIM)).astype(np.float32),
                  "b": rng.normal(0, 0.1, DIM).astype(np.float32)}
                 for _ in range(N_STAGES)]
    x = rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32)
    rng = np.random.default_rng(1)
    hp = {"wo": rng.normal(0, 0.3, (DIM, DIM)).astype(np.float32)}
    tgt = rng.normal(size=(N_MICRO, MB, DIM)).astype(np.float32)
    return per_stage, hp, x, tgt


def _jax_case(toy, schedule, n_stages, v):
    """JAX's loss, per-model-stage gradients, head and input gradients
    over the first ``n_stages * v`` toy stages on ``n_stages`` devices."""
    per_stage, hp, x, tgt = toy
    stages = [jax.tree_util.tree_map(jnp.asarray, p)
              for p in per_stage[:n_stages * v]]
    hp = jax.tree_util.tree_map(jnp.asarray, hp)
    mesh = make_mesh({"pp": n_stages}, devices=jax.devices()[:n_stages])
    if schedule == "gpipe":
        stacked = jpl.place_stacked_params(jpl.stack_stage_params(stages),
                                           mesh)
        pipe = jpl.make_pipelined_fn(mesh, _stage_fn)

        def loss_fn(stacked, hp, x_):
            out = pipe(stacked, x_)
            return jax.vmap(lambda y, t: _head_fn(hp, y, t))(
                out, tgt).mean()
        loss, (gp, gh, gx) = jax.value_and_grad(
            loss_fn, argnums=(0, 1, 2))(stacked, hp, jnp.asarray(x))
        g_stages = [jax.tree_util.tree_map(lambda a: a[s], gp)
                    for s in range(n_stages)]
    elif schedule == "1f1b":
        stacked = jpl.place_stacked_params(jpl.stack_stage_params(stages),
                                           mesh)
        loss, gp, gh, gx = jpl.make_1f1b_fn(mesh, _stage_fn, _head_fn)(
            stacked, hp, jnp.asarray(x), jnp.asarray(tgt))
        g_stages = [jax.tree_util.tree_map(lambda a: a[s], gp)
                    for s in range(n_stages)]
    else:
        chunks = jax.tree_util.tree_map(
            lambda a: jnp.swapaxes(a.reshape((v, n_stages) + a.shape[1:]),
                                   0, 1), jpl.stack_stage_params(stages))
        chunks = jpl.place_stacked_params(chunks, mesh)
        loss, gp, gh, gx = jpl.make_interleaved_1f1b_fn(
            mesh, _stage_fn, _head_fn, n_chunks=v)(
            chunks, hp, jnp.asarray(x), jnp.asarray(tgt))
        g_stages = [jax.tree_util.tree_map(
            lambda a: a[s % n_stages, s // n_stages], gp)
            for s in range(n_stages * v)]
    return {"loss": float(loss),
            "stages": [jax.tree_util.tree_map(np.asarray, g)
                       for g in g_stages],
            "wo": np.asarray(gh["wo"]), "x": np.asarray(gx)}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _hold(ranks, case, want, n_workers, v):
    """Every rank's share of a port case against JAX's: the loss on
    every rank, each model stage's gradients on its owner, the head's on
    the last stage's rank, the input's on rank 0."""
    for r in ranks:
        got = r["cases"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                                   atol=1e-7)
        for s, g in got["stages"].items():
            assert s % n_workers == r["rank"]
            for key in ("w", "b"):
                _close(g[key], want["stages"][s][key])
    _close(ranks[n_workers - 1]["cases"][case]["wo"], want["wo"])
    _close(ranks[0]["cases"][case]["x"], want["x"])


@pytest.fixture(scope="module")
def toy_world4(toy):
    return multi_process_runner.run(
        torch_pp_ranks.toy_rank, 4,
        args=([("gpipe", 1), ("1f1b", 1)], *toy), device="cpu",
        timeout=240).return_values


@pytest.fixture(scope="module")
def toy_world2(toy):
    return multi_process_runner.run(
        torch_pp_ranks.toy_rank, 2,
        args=([("gpipe", 1), ("1f1b", 1), ("interleaved", 2),
               ("interleaved", 1)], *toy), device="cpu",
        timeout=240).return_values


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_executor_4_ranks_matches_jax(toy, toy_world4, schedule):
    want = _jax_case(toy, schedule, 4, 1)
    _hold(toy_world4, (schedule, 1), want, 4, 1)
    # every microbatch crosses each of the 3 links once each way
    for r in toy_world4:
        p2p = r["cases"][(schedule, 1)]["p2p"]
        n_links = (r["rank"] < 3) + (r["rank"] > 0)
        assert p2p["sends"] == p2p["recvs"] == N_MICRO * n_links


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1),
                                        ("interleaved", 2)])
def test_executor_2_ranks_matches_jax(toy, toy_world2, schedule, v):
    want = _jax_case(toy, schedule, 2, v)
    _hold(toy_world2, (schedule, v), want, 2, v)


def test_interleaved_v1_bitwise_equals_1f1b(toy_world2):
    for r in toy_world2:
        a, b = r["cases"][("interleaved", 1)], r["cases"][("1f1b", 1)]
        assert a["loss"] == b["loss"]
        for s in a["stages"]:
            for key in ("w", "b"):
                assert np.array_equal(a["stages"][s][key],
                                      b["stages"][s][key])
        for key in ("wo", "x"):
            assert (a[key] is None) == (b[key] is None)
            assert a[key] is None or np.array_equal(a[key], b[key])
        assert a["p2p"] == b["p2p"]

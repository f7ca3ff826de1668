"""Port parity: the engine's restore entry points —
``InferenceEngine.from_checkpoint``, ``load_version`` and
``begin_load_version`` (installed by ``step`` at the next step boundary)
— against the JAX engine's on the CPU, at ``tiny(max_seq_len=64)`` in
f32 with ``tests/test_torch_hot_swap.py``'s engine knobs.

Weights A (seed 0) and B (seed 7) are saved as ``Checkpoint(params=...)``
at steps 1 and 2, once by the JAX package and once by the port
(``jax_params_layout``); each engine serves from each directory. The
greedy streams, the ``model_version`` step of every completion and the
swap's ``requeued`` count equal the JAX engine's exactly. A pinned step
that is gone raises in both, and ``begin_load_version`` of a gone step
leaves the engine serving with ``swap_error`` set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.checkpoint.checkpoint import (
    Checkpoint as JCheckpoint, CheckpointManager as JManager)
from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JModel)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving import Request as JRequest
from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    Checkpoint, CheckpointManager)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, jax_params_layout, params_from_jax)
from distributed_tensorflow_tpu_torch.serving import (
    InferenceEngine, Request)

ENGINE_KW = dict(num_blocks=48, block_size=8, max_slots=4,
                 max_prompt_len=16, queue_capacity=64)
PROMPTS = [tuple(range(2, 2 + 4 + i % 3)) + (9, 9, 9, 9, 9 + i)
           for i in range(8)]


def _params(seed: int):
    jp = JModel(JConfig.tiny(max_seq_len=64)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    jp = jax.tree_util.tree_map(np.asarray, dict(jp))
    return jp, params_from_jax(TransformerConfig.tiny(max_seq_len=64), jp,
                               device="cpu")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``{"jax": dir, "port": dir}``, each with steps 1 (A) and 2 (B)."""
    (ja, ta), (jb, tb) = _params(0), _params(7)
    cfg = TransformerConfig.tiny(max_seq_len=64)
    out = {}
    for writer in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(f"serve_{writer}"))
        for step, (jp, tp) in ((1, (ja, ta)), (2, (jb, tb))):
            if writer == "jax":
                JManager(JCheckpoint(params=jp), d).save(step)
            else:
                CheckpointManager(Checkpoint(
                    params=jax_params_layout(cfg, tp)), d).save(step)
        out[writer] = d
    return out


def _engine(kind, directory, **kw):
    if kind == "jax":
        return JEngine.from_checkpoint(JConfig.tiny(max_seq_len=64),
                                       directory, **ENGINE_KW, **kw)
    return InferenceEngine.from_checkpoint(
        TransformerConfig.tiny(max_seq_len=64), directory, device="cpu",
        **ENGINE_KW, **kw)


def _serve(kind, eng, swap=None):
    """Serve the prompts; ``swap``: ``("sync"|"async", step)`` once two
    completions landed. Returns ``{id: (tokens, version step)}`` and the
    swap's requeued count."""
    req = JRequest if kind == "jax" else Request
    for i, p in enumerate(PROMPTS):
        eng.submit(req(id=f"q{i}", tokens=p, max_new_tokens=5))
    out, requeued = {}, None
    while not eng.scheduler.idle:
        for rec in eng.step():
            out[rec["id"]] = (tuple(int(t) for t in rec["tokens"]),
                              int(rec["model_version"].split("@")[0]))
        if swap is not None and requeued is None and len(out) >= 2:
            mode, step = swap
            running = len(eng.scheduler.running)
            if mode == "sync":
                requeued = eng.load_version(step)["requeued"]
            else:
                assert eng.begin_load_version(step)
                eng._swap_thread.join()   # land it before the next step
                requeued = running
    return out, requeued


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_checkpoint_serves_latest_as_jax(dirs, writer):
    got = {k: _serve(k, _engine(k, dirs[writer]))[0]
           for k in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert {v for _, v in got["port"].values()} == {2}


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_version_swaps_at_a_step_boundary_as_jax(dirs, writer, mode):
    got = {k: _serve(k, _engine(k, dirs[writer], at_step=1), (mode, 2))
           for k in ("jax", "port")}
    assert got["port"] == got["jax"]
    streams, requeued = got["port"]
    assert requeued > 0
    assert {v for _, v in streams.values()} == {1, 2}


def test_pinned_restore_of_a_gone_step_raises_as_jax(dirs):
    for kind, exc in (("jax", FileNotFoundError),
                      ("port", FileNotFoundError)):
        with pytest.raises(exc):
            _engine(kind, dirs["jax"], at_step=5)
        eng = _engine(kind, dirs["jax"])
        with pytest.raises(exc):
            eng.load_version(5)
        assert eng.begin_load_version(5)
        eng._swap_thread.join()
        eng.step()
        assert isinstance(eng.swap_error, exc)
        assert eng.weights_step == 2

"""Port parity: ``tools/torch_serve_transformer.py`` against the JAX
package's ``examples/serve_transformer.py`` on the CPU, exactly.

- ``run_local`` (JAX's ``tiny(max_seq_len=64)``, the script's engine,
  ``seeded_requests(0, 8)``) serving JAX's initial weights (converted)
  gives greedy streams equal, token for token, to the JAX engine's on
  the same requests and weights; so does it after a ``--write-ckpt`` /
  ``--ckpt-dir`` round trip through the port's checkpoint, and from the
  checkpoint JAX's own ``write_checkpoint`` writes.
- ``--elastic --workers 2 --kill-seed 0`` (two supervised replicas, one
  SIGKILLed mid-load): no request lost, and every stream equals the
  in-process engine's on the same seeded weights.
- ``disagg_kill_plan`` and the elastic run's kill plan equal JAX's, for
  several seeds, fleet sizes and kill counts.
"""

import glob
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JLM)
from distributed_tensorflow_tpu.resilience import (
    seeded_kill_plan as jseeded_kill_plan)
from distributed_tensorflow_tpu.serving import InferenceEngine as JEngine
from distributed_tensorflow_tpu.serving.replica import (
    seeded_requests as jseeded_requests)
from distributed_tensorflow_tpu_torch.models import transformer as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_serve_transformer as tst  # noqa: E402

N_REQ = 8


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(*argv):
    return tst.build_parser().parse_args(["--device", "cpu",
                                          "--requests", str(N_REQ), *argv])


@pytest.fixture(scope="module")
def jax_side():
    cfg = JConfig.tiny(max_seq_len=64)
    params = JLM(cfg).init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    engine = JEngine(cfg, params, num_blocks=64, block_size=8,
                     max_slots=4, max_prompt_len=16,
                     queue_capacity=N_REQ + 1)
    for r in jseeded_requests(0, N_REQ, cfg.vocab_size):
        engine.submit(r)
    done = engine.run_until_idle()
    streams = {rid: list(r["tokens"]) for rid, r in done.items()}
    port_params = ttf.params_from_jax(
        ttf.TransformerConfig.tiny(max_seq_len=64),
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return {"streams": streams, "port_params": port_params}


def test_run_local_streams_equal_jax(jax_side, capsys):
    got = tst.run_local(_args(), params=jax_side["port_params"])
    assert got["served"] == N_REQ
    assert got["streams"] == jax_side["streams"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"served {N_REQ}/{N_REQ} requests in ")
    assert out[1].startswith("engine stats: ")


def test_checkpoint_round_trip_streams_equal_jax(jax_side, tmp_path):
    port_dir = str(tmp_path / "port")
    tst.write_checkpoint(port_dir, "cpu", params=jax_side["port_params"])
    got = tst.run_local(_args("--ckpt-dir", port_dir))
    assert got["streams"] == jax_side["streams"]
    # the checkpoint the JAX script writes, served by the port
    jax_dir = str(tmp_path / "jax")
    _jax_example("serve_transformer").write_checkpoint(jax_dir)
    got = tst.run_local(_args("--ckpt-dir", jax_dir))
    assert got["streams"] == jax_side["streams"]


def test_elastic_kill_serves_every_request(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    args = _args("--elastic", "--workers", "2", "--kill-seed", "0",
                 "--run-dir", run_dir, "--requests", "24")
    out = tst.run_elastic(args)
    assert out["restarts"] == 1 and out["generation"] == 1
    served = {}
    for path in glob.glob(os.path.join(run_dir, "served-*.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                assert served.setdefault(rec["id"], rec["tokens"]) == \
                    rec["tokens"]
    ref = tst.run_local(_args("--requests", "24"))["streams"]
    assert served == ref
    text = capsys.readouterr().out
    assert "chaos kill plan (seed 0): " in text
    assert "done: 1 restart(s)" in text


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("workers,kills", [(2, 1), (3, 3), (4, 2)])
def test_kill_plans_equal_jax(seed, workers, kills):
    jst = _jax_example("serve_transformer")
    for step_range in ((3, 6), (3, 12)):
        got = tst.disagg_kill_plan(seed, workers, kills, step_range)
        want = jst.disagg_kill_plan(seed, workers, kills, step_range)
        assert [(k.worker, k.after_step, k.permanent) for k in got] == \
            [(k.worker, k.after_step, k.permanent) for k in want]
    for requests in (8, 24, 100):
        for disagg in (False, True):
            argv = ["--elastic", "--workers", str(workers), "--kill-seed",
                    str(seed), "--kills", str(kills), "--requests",
                    str(requests)] + (["--disagg"] if disagg else [])
            got = tst.kill_plan_for(tst.build_parser().parse_args(argv))
            step_range = (3, max(6, max(1, requests // workers)))
            want = (jst.disagg_kill_plan(seed, workers, kills, step_range)
                    if disagg else jseeded_kill_plan(
                        seed, workers, kills=kills, step_range=step_range))
            assert [(k.worker, k.after_step) for k in got] == \
                [(k.worker, k.after_step) for k in want]

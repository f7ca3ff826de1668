"""The port stands alone: ``distributed_tensorflow_tpu_torch``,
``chip_smoke.py`` and ``tools/torch_*.py`` import neither JAX (nor
flax/optax/ml_dtypes) nor anything of the JAX package
``distributed_tensorflow_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "distributed_tensorflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
             "distributed_tensorflow_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    tools = os.path.join(ROOT, "tools")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(tools, f) for f in os.listdir(tools)
            if f.startswith("torch_") and f.endswith(".py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_submodule_loads_no_jax():
    code = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import distributed_tensorflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names,
                  "new": sorted(set(sys.modules) - before)}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for sub in ("ops.attention", "ops.fused_ce", "ops.fused_adamw",
                "ops._build",
                "models.transformer", "models.bert",
                "serving.engine", "serving.decode", "serving.kv_cache",
                "serving.scheduler", "serving.migrate",
                "telemetry.events", "telemetry.goodput",
                "resilience.faults", "checkpoint.peer_snapshot",
                "cluster.bootstrap", "cluster.topology",
                "parallel.collectives", "parallel.zero",
                "parallel.tensor_parallel", "parallel.pipeline",
                "parallel.sequence_parallel",
                "parallel.offload", "telemetry.trace",
                "testing.multi_process_runner", "cluster.coordination",
                "cluster.elastic", "parallel.values",
                "checkpoint.checkpoint", "checkpoint.delta",
                "checkpoint.failure_handling",
                "checkpoint.preemption_watcher", "embedding.dynamic",
                "input.stream", "models.online_dlrm"):
        assert f"distributed_tensorflow_tpu_torch.{sub}" in res["imported"]
    assert [m for m in res["new"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_names_jax_in_an_import(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert bad == []


def test_chip_smoke_refuses_without_a_card():
    """With no CUDA device the smoke script exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


#: the port's checkpoint modules: their files are JAX's on-disk format,
#: bf16 included, without ml_dtypes (absent on the card's machine)
CHECKPOINT_MODULES = ("checkpoint.checkpoint", "checkpoint.peer_snapshot",
                      "checkpoint.delta", "checkpoint.failure_handling",
                      "embedding.dynamic", "models.online_dlrm")


@pytest.mark.parametrize("module", CHECKPOINT_MODULES)
def test_checkpoint_modules_load_no_ml_dtypes(module):
    code = f"""
import json, sys
import distributed_tensorflow_tpu_torch.{module}
print(json.dumps(sorted(m for m in sys.modules
                        if m == "ml_dtypes" or m.startswith("ml_dtypes."))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

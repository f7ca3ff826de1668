"""Every name the JAX package's ``__init__.py`` files bind resolves on
the port's package of the same path where its module is ported, and is
the port module's own object; the subpackages that bind them lazily
load no submodule when imported."""

import ast
import importlib
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PT = "distributed_tensorflow_tpu", "distributed_tensorflow_tpu_torch"
SUBPACKAGES = ("", "checkpoint", "cluster", "coordinator", "embedding",
               "input", "models", "ops", "parallel", "resilience",
               "serving", "telemetry", "testing", "training", "utils")
#: subpackages whose names load on first use (PEP 562)
LAZY = ("", "checkpoint", "cluster", "input", "models", "ops", "parallel",
        "testing", "training", "utils")


def _bound(sub: str) -> dict:
    """``{name: (module, attr or None)}`` the JAX ``__init__`` binds
    from the JAX package (a module import has attr None)."""
    path = os.path.join(ROOT, JAX, sub, "__init__.py")
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith(JAX):
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(JAX):
                    out[a.asname or a.name.split(".")[-1]] = (a.name, None)
    return {n: v for n, v in out.items() if not n.startswith("_")}


def _ported(module: str) -> bool:
    rel = module.replace(JAX, PT, 1).replace(".", os.sep)
    return (os.path.exists(os.path.join(ROOT, rel + ".py"))
            or os.path.exists(os.path.join(ROOT, rel, "__init__.py")))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_jax_names_resolve_on_the_port(sub):
    pkg = importlib.import_module(f"{PT}.{sub}" if sub else PT)
    checked = 0
    for name, (module, attr) in sorted(_bound(sub).items()):
        target = module if attr is None else f"{module}.{attr}"
        if attr is not None and _ported(target):
            want = importlib.import_module(target.replace(JAX, PT, 1))
        elif _ported(module):
            m = importlib.import_module(module.replace(JAX, PT, 1))
            if attr is None:
                want = m
            elif hasattr(m, attr):
                want = getattr(m, attr)
            else:
                continue                # a name the port has not ported
        else:
            continue                    # its module is not ported yet
        assert getattr(pkg, name) is want, (sub, name)
        checked += 1
    assert checked or not _bound(sub)


def test_the_named_repairs_resolve():
    """The names a script with its import lines changed needs."""
    import distributed_tensorflow_tpu_torch as pkg
    from distributed_tensorflow_tpu_torch.checkpoint import (  # noqa: F401
        Checkpoint, CheckpointManager, DeltaSnapshotStore, states_equal)
    from distributed_tensorflow_tpu_torch.input import (  # noqa: F401
        DataServiceClient, Dataset, SplitProvider, StreamReader)
    from distributed_tensorflow_tpu_torch.telemetry import (  # noqa: F401
        GoodputLedger, StallDetector, assemble_run, merge_rollup)
    from distributed_tensorflow_tpu_torch.training import (  # noqa: F401
        EarlyStopping, Model)
    assert callable(pkg.initialize) and pkg.bootstrap.initialize is \
        pkg.initialize
    assert pkg.summary.__name__ == f"{PT}.utils.summary"
    assert "Checkpoint" in dir(importlib.import_module(f"{PT}.checkpoint"))


@pytest.fixture(scope="module")
def loaded_on_import():
    code = f"""
import importlib, json, sys
out = {{}}
for sub in {LAZY!r}:
    name = "{PT}." + sub if sub else "{PT}"
    importlib.import_module(name)
    out[sub] = sorted(m for m in sys.modules if m.startswith(name + "."))
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", LAZY, ids=lambda s: s or "top")
def test_importing_a_lazy_package_loads_no_submodule(loaded_on_import, sub):
    assert loaded_on_import[sub] == []

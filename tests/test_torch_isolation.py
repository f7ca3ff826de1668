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
                "input.stream", "models.online_dlrm",
                "parallel.strategy", "parallel.one_device",
                "parallel.mirrored", "parallel.cross_device_ops",
                "input.dataset", "utils.summary", "utils.profiler",
                "utils.tree", "training.model", "training.layers",
                "training.functional", "training.losses",
                "training.metrics", "training.regularizers",
                "training.schedules", "training.optimizers",
                "training.callbacks", "training.saving", "training.loops",
                "keras", "cluster.resolver", "cluster.platform_resolvers",
                "cluster.kv_gc", "parallel.all_reduce_algorithms",
                "parallel.multi_worker", "parallel.sharded_variable",
                "parallel.ps_values", "parallel.central_storage",
                "parallel.parameter_server", "parallel.tpu_strategy",
                "resilience.retry", "resilience.health",
                "coordinator.cluster_coordinator",
                "coordinator.remote_dispatch", "coordinator.watchdog",
                "coordinator.metric_utils",
                "coordinator.distribute_coordinator",
                "coordinator.evaluator",
                "resilience.heartbeats", "resilience.supervisor",
                "resilience.autoscaler", "resilience.rollout",
                "telemetry.slo", "telemetry.exporter",
                "serving.tenancy", "serving.router", "serving.replica",
                "telemetry.aggregate", "telemetry.stall", "telemetry.audit",
                "input.split_provider", "input.data_service",
                "testing.fleet_sim", "testing.day_sim",
                "input.native_loader", "input.example_parser",
                "input.image_ops", "utils.bfloat16", "utils.tensor_tracer",
                "testing.strategy_conformance"):
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


#: the package's lazy top-level names, by the submodule that defines them
LAZY_GROUPS = {
    "strategy": ("Strategy", "OneDeviceStrategy", "MirroredStrategy",
                 "ReplicaContext", "get_strategy", "has_strategy",
                 "get_replica_context", "in_cross_replica_context"),
    "collectives": ("ReduceOp", "CollectiveType",
                    "CommunicationImplementation", "CommunicationOptions"),
    "values": ("DistributedValues", "PerReplica", "Mirrored",
               "DistributedVariable", "MirroredVariable",
               "SyncOnReadVariable", "VariableSynchronization",
               "VariableAggregation"),
    "cross_device_ops": ("CrossDeviceOps", "ReductionToOneDevice",
                         "IciAllReduce", "HierarchicalAllReduce",
                         "select_cross_device_ops"),
    "dataset": ("Dataset", "DistributedDataset", "InputOptions",
                "AutoShardPolicy"),
    "keras": ("keras",),
    "cluster_strategies": ("MultiWorkerMirroredStrategy",
                           "CollectiveAllReduceStrategy",
                           "ParameterServerStrategy",
                           "ParameterServerStrategyV1",
                           "ParameterServerStrategyV2",
                           "CentralStorageStrategy", "TPUStrategy",
                           "ShardedVariable", "FixedShardsPartitioner",
                           "AggregatingVariable", "CachingVariable"),
    "coordinator": ("ClusterCoordinator", "RemoteValue", "PerWorkerValues",
                    "RetryPolicy", "coordination_service"),
    "cluster_names": ("initialize", "bootstrap", "Topology",
                      "DeviceAssignment", "make_mesh", "summary"),
    "resolvers": ("ClusterSpec", "ClusterResolver", "SimpleClusterResolver",
                  "TFConfigClusterResolver", "TPUClusterResolver",
                  "SlurmClusterResolver", "SageMakerClusterResolver",
                  "GCEClusterResolver", "KubernetesClusterResolver"),
    "utils_modules": ("bfloat16", "tensor_tracer"),
}


@pytest.mark.parametrize("group", sorted(LAZY_GROUPS))
def test_lazy_top_level_names_resolve(group):
    """``import distributed_tensorflow_tpu_torch`` alone loads no
    submodule; each lazy name then resolves with nothing imported first,
    and no JAX module comes with it."""
    code = f"""
import json, sys
import distributed_tensorflow_tpu_torch as pkg
bare = sorted(m for m in sys.modules
              if m.startswith("distributed_tensorflow_tpu_torch."))
got = {{n: type(getattr(pkg, n)).__name__ for n in {LAZY_GROUPS[group]!r}}}
print(json.dumps({{"bare": bare, "got": got,
                  "new": sorted(sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bare"] == []
    assert set(res["got"]) == set(LAZY_GROUPS[group])
    assert [m for m in res["new"] if _forbidden(m)] == []

"""PyTorch/CUDA port of ``distributed_tensorflow_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module layout (``ops/``,
``models/``, ``serving/``, ``telemetry/``, ``resilience/``,
``checkpoint/``, ``cluster/``, ``coordinator/``, ``parallel/``,
``testing/``, ``embedding/``, ``input/``, ``training/``, ``utils/``) so each
ported module sits at the same relative path as the module it is held
against. It imports
torch, numpy and the standard library only — never jax, flax, optax or
anything of the JAX package.

Entry points take an explicit ``device=`` (default ``"cuda"``) and raise
on a machine with no CUDA device unless the caller asks for the CPU.
Every TPU kernel on a ported path is a hand-written Hopper kernel under
``ops/csrc/``, built with ``nvcc`` at first use (``ops/_build.py``);
on a CPU tensor its wrapper runs the plain PyTorch version instead.

Importing this package imports no submodule: import what you use, e.g.
``from distributed_tensorflow_tpu_torch.serving.engine import
InferenceEngine``. The strategy API (the multi-worker, parameter-server,
central-storage and TPU strategies included), the cluster resolvers, the
``ClusterCoordinator``, the topology and ``initialize``, and the Keras
shim are also lazy top-level names (``_LAZY``), as the JAX package
exports them, and so is every name a subpackage's ``__init__.py`` binds
(each through :func:`lazy_names`), so a script runs on the
port with its import lines changed::

    import distributed_tensorflow_tpu_torch as tf_distribute
    from distributed_tensorflow_tpu_torch import keras
    strategy = tf_distribute.MirroredStrategy()
"""

import importlib

__all__ = ["ops", "models", "serving", "telemetry", "resilience",
           "checkpoint", "cluster", "coordinator", "parallel", "testing",
           "embedding", "input", "training", "utils"]

_P = "distributed_tensorflow_tpu_torch."

#: top-level name -> the submodule that defines it (loaded on first use)
_LAZY = {
    **{n: _P + "parallel.strategy" for n in (
        "Strategy", "ReplicaContext", "StrategyExtended", "ValueContext",
        "get_replica_context", "get_strategy", "has_strategy",
        "in_cross_replica_context")},
    "OneDeviceStrategy": _P + "parallel.one_device",
    "MirroredStrategy": _P + "parallel.mirrored",
    **{n: _P + "parallel.collectives" for n in (
        "ReduceOp", "CollectiveType", "CommunicationImplementation",
        "CommunicationOptions")},
    **{n: _P + "parallel.values" for n in (
        "DistributedValues", "PerReplica", "Mirrored",
        "DistributedVariable", "MirroredVariable", "SyncOnReadVariable",
        "VariableSynchronization", "VariableAggregation")},
    **{n: _P + "parallel.cross_device_ops" for n in (
        "CrossDeviceOps", "ReductionToOneDevice", "IciAllReduce",
        "NcclAllReduce", "HierarchicalAllReduce",
        "select_cross_device_ops")},
    **{n: _P + "parallel.multi_worker" for n in (
        "MultiWorkerMirroredStrategy", "CollectiveAllReduceStrategy")},
    **{n: _P + "parallel.parameter_server" for n in (
        "ParameterServerStrategy", "ParameterServerStrategyV1",
        "ParameterServerStrategyV2")},
    "CentralStorageStrategy": _P + "parallel.central_storage",
    "TPUStrategy": _P + "parallel.tpu_strategy",
    **{n: _P + "parallel.sharded_variable" for n in (
        "Partitioner", "FixedShardsPartitioner", "MinSizePartitioner",
        "MaxSizePartitioner", "ShardedVariable")},
    **{n: _P + "parallel.ps_values" for n in (
        "AggregatingVariable", "CachingVariable")},
    **{n: _P + "cluster.resolver" for n in (
        "ClusterSpec", "ClusterResolver", "SimpleClusterResolver",
        "TFConfigClusterResolver", "TPUClusterResolver")},
    **{n: _P + "cluster.platform_resolvers" for n in (
        "GCEClusterResolver", "KubernetesClusterResolver",
        "SageMakerClusterResolver", "SlurmClusterResolver")},
    **{n: _P + "coordinator.cluster_coordinator" for n in (
        "ClusterCoordinator", "RemoteValue", "PerWorkerValues")},
    "RetryPolicy": _P + "resilience.retry",
    "coordination_service": _P + "cluster.coordination",
    **{n: _P + "input.dataset" for n in (
        "Dataset", "DistributedDataset", "InputOptions", "AutoShardPolicy",
        "InputContext")},
    **{n: _P + "cluster.topology" for n in (
        "Topology", "DeviceAssignment", "make_mesh")},
    "initialize": _P + "cluster.bootstrap",
}

#: top-level submodules loaded on first use (``tf_distribute.keras``)
_LAZY_MODULES = {"keras": _P + "keras", "collectives":
                 _P + "parallel.collectives",
                 "bootstrap": _P + "cluster.bootstrap",
                 "summary": _P + "utils.summary",
                 "bfloat16": _P + "utils.bfloat16",
                 "tensor_tracer": _P + "utils.tensor_tracer",
                 **{n: _P + n for n in __all__}}


def lazy_names(namespace: dict, names: dict, modules: dict | None = None):
    """PEP 562 ``__getattr__`` and ``__dir__`` for a package whose
    ``names`` (name -> defining module) and ``modules`` (name ->
    module) load on first use; a resolved name is cached in
    ``namespace``, the package's globals."""
    modules = modules or {}

    def __getattr__(name):
        if name in names:
            value = getattr(importlib.import_module(names[name]), name)
        elif name in modules:
            value = importlib.import_module(modules[name])
        else:
            raise AttributeError(
                f"module {namespace['__name__']!r} has no attribute {name!r}")
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(names) | set(modules))
    return __getattr__, __dir__


__getattr__, __dir__ = lazy_names(globals(), _LAZY, _LAZY_MODULES)

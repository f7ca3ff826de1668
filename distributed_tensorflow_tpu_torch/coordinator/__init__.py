"""Chief-side async dispatch for parameter-server training — port of
``distributed_tensorflow_tpu/coordinator/`` (≙ the reference's
``tensorflow/python/distribute/coordinator/``)."""

from distributed_tensorflow_tpu_torch.coordinator.cluster_coordinator import (
    ClusterCoordinator,
    Closure,
    PerWorkerValues,
    PSUnavailableError,
    RemoteValue,
    WorkerPreemptionError,
)
from distributed_tensorflow_tpu_torch.coordinator.watchdog import WatchDog
from distributed_tensorflow_tpu_torch.coordinator import remote_dispatch
from distributed_tensorflow_tpu_torch.coordinator.distribute_coordinator import (
    CoordinatorMode,
    WorkerContext,
    run_distribute_coordinator,
)
from distributed_tensorflow_tpu_torch.coordinator.evaluator import (
    SidecarEvaluator,
    train_and_evaluate,
)

"""Resilience — port of ``distributed_tensorflow_tpu/resilience``:

- :mod:`.faults` — the seed-driven fault-injection layer (the
  ``serve.step`` site of the serving engine);
- :mod:`.retry` — :class:`RetryPolicy` and its :class:`Backoff`;
- :mod:`.health` — per-worker failure tracking and quarantine;
- :mod:`.heartbeats` — the supervisor's liveness transport: per-task
  files (default) or sharded summaries over the coordination KV;
- :mod:`.supervisor` — the recovery supervisor: restart, reform under a
  fresh generation, shrink, drain-before-stop, step-targeted chaos;
- :mod:`.autoscaler` — the SLO-burn policy engine, the fixed-budget
  capacity arbiter and the shared-fleet supervisor;
- :mod:`.rollout` — the canary rollout policy's state machine.
"""

from distributed_tensorflow_tpu_torch.resilience import faults, heartbeats
from distributed_tensorflow_tpu_torch.resilience.heartbeats import (
    FileHeartbeatSource,
    ShardedHeartbeatPublisher,
    ShardedKVHeartbeats,
)
from distributed_tensorflow_tpu_torch.resilience.faults import (
    FaultDecision,
    FaultInjected,
    FaultRegistry,
    FaultRule,
    FaultSchedule,
)
from distributed_tensorflow_tpu_torch.resilience.retry import (
    Backoff, RetryPolicy)
from distributed_tensorflow_tpu_torch.resilience.health import (
    WorkerHealthTracker)
from distributed_tensorflow_tpu_torch.resilience.supervisor import (
    KillSpec,
    RecoveryFailedError,
    RecoverySupervisor,
    WorkerFailure,
    seeded_kill_plan,
    seeded_shrink_plan,
)
from distributed_tensorflow_tpu_torch.resilience.autoscaler import (
    Autoscaler,
    AutoscalePolicy,
    CapacityArbiter,
    ScaleDecision,
    SharedFleetSupervisor,
)
from distributed_tensorflow_tpu_torch.resilience.rollout import (
    RolloutController,
    RolloutDecision,
    RolloutPolicy,
)

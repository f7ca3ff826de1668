"""Cluster discovery: ClusterSpec and resolvers — port of
``distributed_tensorflow_tpu/cluster/resolver.py``.

The resolvers keep the JAX package's names, contracts and answers:
``TF_CONFIG`` is parsed as it is there (and as the reference's
``tfconfig_cluster_resolver.py:48`` parses it), the TPU-VM variables
(``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``,
``MEGASCALE_COORDINATOR_ADDRESS``) likewise, and ``master``,
``num_processes``, ``process_id`` and ``is_chief`` give the same values
on the same environment. :func:`~distributed_tensorflow_tpu_torch.
cluster.bootstrap.initialize` turns them into the process group:
``master()`` is the address of the group's ``TCPStore``,
``process_id()`` the rank and ``num_processes()`` the world size, which
counts the chief and worker tasks only (a ``ps`` or ``evaluator`` task
is outside the group).

One answer differs on purpose: :meth:`ClusterResolver.num_accelerators`
counts the visible CUDA cards (``torch.cuda.device_count()``), so it is
0 on a machine without one, where JAX's counts ``jax.local_devices()``
(the CPU devices there).
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

CHIEF = "chief"
WORKER = "worker"
PS = "ps"
EVALUATOR = "evaluator"


class ClusterSpec:
    """A static description of job-name -> task addresses.

    Same shape as ``tf.train.ClusterSpec``: ``{"worker": ["h0:port", ...],
    "ps": [...]}``.
    """

    def __init__(self, cluster: Mapping[str, Sequence[str] | Mapping[int, str]]):
        self._cluster: dict[str, list[str]] = {}
        for job, tasks in dict(cluster).items():
            if isinstance(tasks, Mapping):
                size = max(tasks.keys()) + 1 if tasks else 0
                lst = [""] * size
                for i, addr in tasks.items():
                    lst[int(i)] = addr
                self._cluster[job] = lst
            else:
                self._cluster[job] = list(tasks)

    def as_dict(self) -> dict[str, list[str]]:
        return {k: list(v) for k, v in self._cluster.items()}

    @property
    def jobs(self) -> list[str]:
        return sorted(self._cluster)

    def num_tasks(self, job: str) -> int:
        return len(self._cluster.get(job, ()))

    def task_addresses(self, job: str) -> list[str]:
        if job not in self._cluster:
            raise ValueError(f"No such job: {job!r}")
        return list(self._cluster[job])

    def task_address(self, job: str, task: int) -> str:
        return self.task_addresses(job)[task]

    @property
    def num_total_tasks(self) -> int:
        return sum(len(v) for v in self._cluster.values())

    def __bool__(self) -> bool:
        return bool(self._cluster)

    def __eq__(self, other) -> bool:
        return isinstance(other, ClusterSpec) and self.as_dict() == other.as_dict()

    def __repr__(self) -> str:
        return f"ClusterSpec({self._cluster!r})"


def validate_cluster_spec(spec: ClusterSpec, task_type: str, task_id: int):
    """≙ multi_worker_util._validate_cluster_spec (multi_worker_util.py:52)."""
    if task_type and task_type not in (*spec.jobs, EVALUATOR):
        raise ValueError(f"task_type {task_type!r} not in cluster spec {spec!r}")
    if spec.num_tasks(CHIEF) > 1:
        raise ValueError("There must be at most one 'chief' job.")
    if task_type in spec.jobs and task_id >= spec.num_tasks(task_type):
        raise ValueError(
            f"task_id {task_id} out of range for job {task_type!r} "
            f"({spec.num_tasks(task_type)} tasks)")


class ClusterResolver:
    """Abstract cluster resolver (≙ cluster_resolver.py base, SURVEY §2.4)."""

    task_type: str | None = None
    task_id: int | None = None
    rpc_layer: str | None = None

    def cluster_spec(self) -> ClusterSpec:
        raise NotImplementedError

    def master(self, task_type: str | None = None, task_id: int | None = None
               ) -> str:
        """Address of the coordination-service leader ("master" kept for API
        parity). Empty string means local/single-process."""
        spec = self.cluster_spec()
        if task_type is not None and task_id is not None:
            return spec.task_address(task_type, task_id)
        if not spec:
            return ""
        return coordinator_address(spec)

    def num_accelerators(self) -> int:
        """The visible CUDA cards (0 without one)."""
        import torch
        return torch.cuda.device_count()

    @property
    def environment(self) -> str:
        return ""

    # -- derived facts ----------------------------------------------------
    def is_chief(self) -> bool:
        spec = self.cluster_spec()
        if not spec:
            return True
        if not self.task_type:
            # part of a cluster but with no declared task: this process
            # cannot claim chief-only duties (checkpoint writes etc.)
            return False
        return is_chief(spec, self.task_type,
                        self.task_id if self.task_id is not None else 0)

    def num_processes(self) -> int:
        spec = self.cluster_spec()
        if not spec:
            return 1
        return (spec.num_tasks(CHIEF) + spec.num_tasks(WORKER)) or 1

    def process_id(self) -> int:
        spec = self.cluster_spec()
        if not spec:
            return 0
        return id_in_cluster(spec, self.task_type or WORKER,
                             self.task_id if self.task_id is not None else 0)


class SimpleClusterResolver(ClusterResolver):
    """Wraps a static ClusterSpec."""

    def __init__(self, cluster_spec: ClusterSpec, task_type: str = "",
                 task_id: int = 0, rpc_layer: str | None = None,
                 environment: str = ""):
        self._cluster_spec = cluster_spec
        self.task_type = task_type
        self.task_id = task_id
        self.rpc_layer = rpc_layer
        self._environment = environment
        if cluster_spec and task_type:
            validate_cluster_spec(cluster_spec, task_type, task_id)

    def cluster_spec(self) -> ClusterSpec:
        return self._cluster_spec

    @property
    def environment(self) -> str:
        return self._environment


class TFConfigClusterResolver(ClusterResolver):
    """Parses the ``TF_CONFIG`` environment JSON.

    Contract (kept bit-for-bit from the reference,
    tfconfig_cluster_resolver.py:38-45):

        TF_CONFIG='{"cluster": {"worker": ["h0:2222", "h1:2222"]},
                    "task": {"type": "worker", "index": 1}}'
    """

    def __init__(self, task_type: str | None = None, task_id: int | None = None,
                 rpc_layer: str | None = None):
        self._override_task_type = task_type
        self._override_task_id = task_id
        self.rpc_layer = rpc_layer
        tf_config = self._load()
        task = tf_config.get("task", {})
        self.task_type = (task_type if task_type is not None
                          else task.get("type"))
        self.task_id = (task_id if task_id is not None
                        else int(task.get("index", 0)))

    @staticmethod
    def _load() -> dict:
        raw = os.environ.get("TF_CONFIG", "")
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"Malformed TF_CONFIG: {e}") from e

    def cluster_spec(self) -> ClusterSpec:
        return ClusterSpec(self._load().get("cluster", {}))

    @property
    def environment(self) -> str:
        return self._load().get("environment", "")


class TPUClusterResolver(ClusterResolver):
    """The cluster from the TPU-VM environment variables, as JAX's reads
    them (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``,
    ``MEGASCALE_COORDINATOR_ADDRESS``), kept under its name so that a
    launch script written for those variables resolves the same hosts.
    :meth:`connect` resolves and creates the process group."""

    COORD_PORT = 8476  # the JAX package's coordination port

    def __init__(self, tpu: str | None = None, task_type: str | None = None,
                 task_id: int | None = None):
        self._tpu = tpu
        hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
        self._hosts = [h for h in hostnames.split(",") if h]
        self.task_type = task_type if task_type is not None else WORKER
        self.task_id = (task_id if task_id is not None
                        else int(os.environ.get("TPU_WORKER_ID", 0)))

    def cluster_spec(self) -> ClusterSpec:
        if not self._hosts:
            return ClusterSpec({})
        return ClusterSpec({
            WORKER: [f"{h}:{self.COORD_PORT}" for h in self._hosts]})

    def master(self, task_type=None, task_id=None) -> str:
        ms = os.environ.get("MEGASCALE_COORDINATOR_ADDRESS")
        if ms:
            return ms if ":" in ms else f"{ms}:{self.COORD_PORT}"
        return super().master(task_type, task_id)

    def get_tpu_system_metadata(self):
        """Summary of the system (JAX's keys): the visible cards."""
        from distributed_tensorflow_tpu_torch.cluster.topology import (
            Topology)
        topo = Topology.detect()
        return {
            "num_cores": topo.num_devices,
            "num_hosts": topo.num_processes,
            "devices": topo.devices,
            "topology": topo.mesh_shape,
        }

    @classmethod
    def connect(cls, tpu: str | None = None, *, device="cuda"):
        """Resolve, create the process group on ``device`` and return the
        resolver."""
        from distributed_tensorflow_tpu_torch.cluster import bootstrap
        resolver = cls(tpu=tpu)
        bootstrap.initialize(resolver, device=device)
        return resolver


# ---------------------------------------------------------------------------
# multi_worker_util equivalents (≙ multi_worker_util.py, SURVEY §2.4)
# ---------------------------------------------------------------------------

def is_chief(spec: ClusterSpec, task_type: str, task_id: int) -> bool:
    """≙ multi_worker_util.is_chief (multi_worker_util.py:108)."""
    if not spec:
        return True
    if spec.num_tasks(CHIEF):
        return task_type == CHIEF
    return task_type == WORKER and task_id == 0


def coordinator_address(spec: ClusterSpec) -> str:
    """Leader for the coordination service
    (≙ multi_worker_util.collective_leader/coordination_leader,
    multi_worker_util.py:148/:182): chief:0 if present, else worker:0."""
    if spec.num_tasks(CHIEF):
        return spec.task_address(CHIEF, 0)
    if spec.num_tasks(WORKER):
        return spec.task_address(WORKER, 0)
    return ""


def id_in_cluster(spec: ClusterSpec, task_type: str, task_id: int) -> int:
    """Dense process index (≙ multi_worker_util.id_in_cluster,
    multi_worker_util.py:232): chief=0, workers follow."""
    if task_type == CHIEF:
        return 0
    if task_type == WORKER:
        return task_id + spec.num_tasks(CHIEF)
    if task_type == EVALUATOR:
        return 0  # evaluator is its own single-task world
    raise ValueError(f"Unsupported task_type {task_type!r}")


def worker_count(spec: ClusterSpec, task_type: str = WORKER) -> int:
    """≙ multi_worker_util.worker_count."""
    if task_type == EVALUATOR:
        return spec.num_tasks(EVALUATOR)
    return spec.num_tasks(CHIEF) + spec.num_tasks(WORKER)

"""Multi-process bootstrap on ``torch.distributed`` — port of
``distributed_tensorflow_tpu/cluster/bootstrap.py``.

JAX connects every process to its coordination service with
``jax.distributed.initialize``; here :func:`initialize` creates the
default process group. The cluster is resolved as JAX's resolves it: an
explicit resolver first, else ``TF_CONFIG``
(:class:`~distributed_tensorflow_tpu_torch.cluster.resolver.
TFConfigClusterResolver`), then the TPU-VM environment, and then the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` and
:mod:`~distributed_tensorflow_tpu_torch.testing.multi_process_runner`
set them). From a resolver, ``master()`` is the address of the group's
``TCPStore`` (hosted by rank 0: the chief, else worker 0),
``process_id()`` the rank and ``num_processes()`` the world size — the
chief and worker tasks only.

A ``ps`` or ``evaluator`` task is outside the group: it makes no process
group (the trainers' collectives never wait on it) and gets a client of
the group's store instead, so the coordination agent
(:mod:`~distributed_tensorflow_tpu_torch.cluster.coordination`) still
reaches the KV.

The backend follows from the device and nothing else: ``cuda`` → NCCL
on ``cuda:LOCAL_RANK``, ``cpu`` → gloo. With no cluster at all it makes
a group of one.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster import elastic
from distributed_tensorflow_tpu_torch.cluster.resolver import (
    CHIEF, EVALUATOR, PS, WORKER, ClusterResolver, TFConfigClusterResolver)

_LOCK = threading.Lock()
_RUNTIME: "DistributedRuntime | None" = None


@dataclasses.dataclass(frozen=True)
class DistributedRuntime:
    """Facts about the initialised process group. ``in_group`` is False
    for a ``ps`` or ``evaluator`` task, which has a store client and no
    group (``backend`` None)."""

    coordinator_address: str | None
    num_processes: int
    process_id: int
    local_rank: int
    backend: str | None
    device: torch.device
    task_type: str | None = None
    task_id: int | None = None
    in_group: bool = True
    #: elastic cluster generation (``cluster/elastic.py``)
    generation: int = 0

    @property
    def is_chief(self) -> bool:
        return self.in_group and self.process_id == 0


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def _default_resolver() -> ClusterResolver | None:
    if os.environ.get("TF_CONFIG"):
        return TFConfigClusterResolver()
    if os.environ.get("TPU_WORKER_HOSTNAMES"):
        from distributed_tensorflow_tpu_torch.cluster.resolver import (
            TPUClusterResolver)
        return TPUClusterResolver()
    return None


def _split(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


def initialize(resolver: ClusterResolver | None = None,
               coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               timeout_s: float = 300.0) -> DistributedRuntime:
    """Create the default process group (idempotent), from ``resolver``
    or the explicit facts, else as the module docstring says.
    ``device`` is ``"cuda"`` (NCCL; the rank's card ``cuda:LOCAL_RANK``
    becomes the current device) or ``"cpu"`` (gloo). A CUDA request on a
    machine without a card raises."""
    global _RUNTIME
    with _LOCK:
        if _RUNTIME is not None:
            return _RUNTIME
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device={device!r}; expected 'cuda' or 'cpu'")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA "
                               "device is available")
        if coordinator_address is None and resolver is None:
            resolver = _default_resolver()
        task_type = task_id = None
        if resolver is not None:
            spec = resolver.cluster_spec()
            task_type, task_id = resolver.task_type, resolver.task_id
            if spec and task_type in (PS, EVALUATOR):
                _RUNTIME = _outside_group(resolver, kind, timeout_s)
                return _RUNTIME
            if coordinator_address is None:
                coordinator_address = resolver.master() or None
            if num_processes is None:
                num_processes = resolver.num_processes()
            if process_id is None:
                process_id = resolver.process_id() if spec else 0
        elif coordinator_address is None and (
                _env_int("WORLD_SIZE", 1) > 1 or "MASTER_PORT" in os.environ):
            coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                                   f":{os.environ['MASTER_PORT']}")
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE", 1)
        if process_id is None:
            process_id = _env_int("RANK", 0)
        world, rank = num_processes or 1, process_id or 0
        local_rank = _env_int("LOCAL_RANK", rank)
        kwargs = {"timeout": timedelta(seconds=timeout_s)}
        if kind == "cuda":
            local_rank %= torch.cuda.device_count()
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)
            backend = "nccl"
            kwargs["device_id"] = dev
        else:
            dev = torch.device("cpu")
            backend = "gloo"
        if coordinator_address and (world > 1 or resolver is None):
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=world, rank=rank, **kwargs)
        else:
            coordinator_address = None
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, **kwargs)
        _RUNTIME = DistributedRuntime(
            coordinator_address=coordinator_address, num_processes=world,
            process_id=rank, local_rank=local_rank, backend=backend,
            device=dev, task_type=task_type or (WORKER if world > 1
                                                else None),
            task_id=task_id, generation=elastic.generation())
        return _RUNTIME


def _outside_group(resolver: ClusterResolver, kind: str,
                   timeout_s: float) -> DistributedRuntime:
    """A ``ps`` or ``evaluator`` task: a client of the group's store,
    attached to the coordination agent, and no process group."""
    from distributed_tensorflow_tpu_torch.cluster import coordination
    spec = resolver.cluster_spec()
    address = resolver.master() or None
    if address:
        coordination.attach_store(lambda: store_client(address, timeout_s),
                                  world=spec.num_tasks(CHIEF)
                                  + spec.num_tasks(WORKER))
    dev = torch.device("cpu")
    if kind == "cuda":
        dev = torch.device("cuda", _env_int("LOCAL_RANK", 0)
                           % torch.cuda.device_count())
    return DistributedRuntime(
        coordinator_address=address, num_processes=1, process_id=0,
        local_rank=dev.index or 0, backend=None, device=dev,
        task_type=resolver.task_type, task_id=resolver.task_id,
        in_group=False, generation=elastic.generation())


def store_client(address: str, timeout_s: float = 300.0):
    """A connection of its own to the ``TCPStore`` that rank 0 hosts at
    ``address`` (the process group's rendezvous store), without joining
    the group; waits up to ``timeout_s`` for the store to come up. The
    coordination KV keeps its keys there under ``dtx_kv/``."""
    host, port = _split(address)
    return dist.TCPStore(host, port, is_master=False,
                         timeout=timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def runtime() -> DistributedRuntime:
    """The current runtime; raises before :func:`initialize`."""
    if _RUNTIME is None:
        raise RuntimeError("call bootstrap.initialize(device=) first")
    return _RUNTIME


def shutdown():
    """Destroy the default process group (a task outside the group
    drops its store client). No barrier: a dead rank cannot hold it."""
    global _RUNTIME
    with _LOCK:
        if _RUNTIME is not None and not _RUNTIME.in_group:
            from distributed_tensorflow_tpu_torch.cluster import coordination
            coordination.attach_store(None)
        elif _RUNTIME is not None and dist.is_initialized():
            dist.destroy_process_group()
        _RUNTIME = None

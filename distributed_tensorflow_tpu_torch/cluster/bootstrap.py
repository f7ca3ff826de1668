"""Multi-process bootstrap on ``torch.distributed`` — port of what data
parallelism needs of ``distributed_tensorflow_tpu/cluster/bootstrap.py``.

JAX connects every process to its coordination service with
``jax.distributed.initialize``; here :func:`initialize` creates the
default process group from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` and :mod:`~distributed_tensorflow_tpu_torch.testing.
multi_process_runner` set them). The backend follows from the device
and nothing else: ``cuda`` → NCCL on ``cuda:LOCAL_RANK``, ``cpu`` →
gloo. With no ``WORLD_SIZE`` in the environment it makes a group of
one. The cluster resolvers and ``TF_CONFIG`` belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

_LOCK = threading.Lock()
_RUNTIME: "DistributedRuntime | None" = None


@dataclasses.dataclass(frozen=True)
class DistributedRuntime:
    """Facts about the initialised process group."""

    coordinator_address: str | None
    num_processes: int
    process_id: int
    local_rank: int
    backend: str
    device: torch.device

    @property
    def is_chief(self) -> bool:
        return self.process_id == 0


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize(device="cuda", *, timeout_s: float = 300.0
               ) -> DistributedRuntime:
    """Create the default process group (idempotent). ``device`` is
    ``"cuda"`` (NCCL; the rank's card ``cuda:LOCAL_RANK`` becomes the
    current device) or ``"cpu"`` (gloo). A CUDA request on a machine
    without a card raises."""
    global _RUNTIME
    with _LOCK:
        if _RUNTIME is not None:
            return _RUNTIME
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device={device!r}; expected 'cuda' or 'cpu'")
        world = _env_int("WORLD_SIZE", 1)
        rank = _env_int("RANK", 0)
        local_rank = _env_int("LOCAL_RANK", rank)
        kwargs = {"timeout": timedelta(seconds=timeout_s)}
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' requested but no CUDA "
                                   "device is available")
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)
            backend = "nccl"
            kwargs["device_id"] = dev
        else:
            dev = torch.device("cpu")
            backend = "gloo"
        address = None
        if world > 1 or "MASTER_PORT" in os.environ:
            address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{os.environ['MASTER_PORT']}")
            dist.init_process_group(backend, init_method=f"tcp://{address}",
                                    world_size=world, rank=rank, **kwargs)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, **kwargs)
        _RUNTIME = DistributedRuntime(
            coordinator_address=address, num_processes=world,
            process_id=rank, local_rank=local_rank, backend=backend,
            device=dev)
        return _RUNTIME


def runtime() -> DistributedRuntime:
    """The current runtime; raises before :func:`initialize`."""
    if _RUNTIME is None:
        raise RuntimeError("call bootstrap.initialize(device=) first")
    return _RUNTIME


def shutdown():
    """Destroy the default process group."""
    global _RUNTIME
    with _LOCK:
        if _RUNTIME is not None and dist.is_initialized():
            dist.destroy_process_group()
        _RUNTIME = None

"""MirroredStrategy — synchronous data parallelism, one replica a rank —
port of ``distributed_tensorflow_tpu/parallel/mirrored.py``.

JAX's spans every local device of one process. Here a replica is a
rank of the initialised process group, on its own card (the mesh
``{"dp": world}``); with no group, the one card of this process.
``devices`` takes JAX's strings: on R ranks exactly R devices, rank r
taking the r'th, which must be its own card (``cuda:LOCAL_RANK``), or
one CPU device for every rank (``["cpu"]`` / ``["/cpu:0"]``); with no
group, one device. One process never drives several cards.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.parallel.collectives import (
    CommunicationOptions)
from distributed_tensorflow_tpu_torch.parallel.cross_device_ops import (
    CrossDeviceOps)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy, _local_rank, local_cuda, resolve_device)


class MirroredStrategy(Strategy):
    """Sync data-parallel over the ranks of the process group (module
    docstring); the gradient sync of ``compile_step`` and of the Keras
    ``fit`` is the strategy's bucketed all-reduce
    (``communication_options.bytes_per_pack``; 0 = 4 MiB)."""

    def __init__(self, devices: Sequence | None = None,
                 cross_device_ops: CrossDeviceOps | None = None,
                 communication_options: CommunicationOptions | None = None):
        grouped = dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        rank = dist.get_rank() if grouped else 0
        if devices is None:
            device = local_cuda()
        else:
            devs = [resolve_device(d) for d in devices]
            if len(devs) == 1 and (devs[0].type == "cpu" or world == 1):
                device = devs[0]
            elif len(devs) != world:
                raise ValueError(
                    f"{len(devs)} devices for {world} rank(s): each rank "
                    "drives its own card, so pass one device a rank (or "
                    "start one process a card with a process group)")
            else:
                device = devs[rank]
            if device.type == "cuda" and device.index != _local_rank():
                raise ValueError(
                    f"rank {rank} was given {device}; its own card is "
                    f"cuda:{_local_rank()}")
        mesh = (topo_lib.make_mesh({topo_lib.DATA_AXIS: world},
                                   device=device.type) if grouped else None)
        super().__init__(mesh=mesh, data_axis_names=(topo_lib.DATA_AXIS,),
                         cross_device_ops=cross_device_ops,
                         communication_options=communication_options,
                         device=device)
        if device.type == "cuda":
            torch.cuda.set_device(device)

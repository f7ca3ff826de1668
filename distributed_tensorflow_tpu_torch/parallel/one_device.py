"""OneDeviceStrategy — port of
``distributed_tensorflow_tpu/parallel/one_device.py``: every variable
and computation on one device, one replica, no collectives."""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy, local_cuda, resolve_device)


class OneDeviceStrategy(Strategy):
    """On ``device`` (JAX's strings: "/gpu:0", "/cpu:0", "cuda:1",
    "cpu"); default this rank's card, ``cuda:LOCAL_RANK``, which raises
    with no CUDA device."""

    _world_mesh = False

    def __init__(self, device=None):
        device = local_cuda() if device is None else resolve_device(device)
        super().__init__(mesh=None, device=device)

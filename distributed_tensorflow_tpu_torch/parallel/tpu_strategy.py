"""TPUStrategy — sync data parallelism with optional model axes — port of
``distributed_tensorflow_tpu/parallel/tpu_strategy.py`` (≙ the
reference's ``tpu_strategy.py:243`` ``TPUStrategyV2``).

Kept under its name, with :func:`initialize_tpu_system`, so that a script
written for the JAX package keeps working when only its import line
changes. On the port it is the mesh strategy over the cards: one rank a
card, the mesh ``{"dp": -1, **model_axes}`` over the process group (one
replica with no group). The logical-device hints keep JAX's
host-visible results: :meth:`~TPUStrategy.assign_to_logical_device`
and :meth:`~TPUStrategy.split_to_logical_devices` return the tensor's
value unchanged (JAX annotates a sharding of the same global value) and
refuse what JAX refuses.
"""

from __future__ import annotations

import torch.distributed as dist

from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.cluster.resolver import (
    TPUClusterResolver)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy, resolve_device)


class TPUStrategy(Strategy):
    """Synchronous training over the mesh; ``model_axes`` (e.g.
    ``{"tp": 2}``) reserves mesh dims for model parallelism."""

    _world_mesh = False

    def __init__(self, tpu_cluster_resolver: TPUClusterResolver | None = None,
                 mesh=None, model_axes: dict | None = None, *, device=None):
        self._cluster_resolver = tpu_cluster_resolver
        if mesh is None and dist.is_initialized():
            axes = {topo_lib.DATA_AXIS: -1, **(model_axes or {})}
            kind = (resolve_device(device).type if device is not None
                    else "cuda")
            mesh = topo_lib.make_mesh(axes, device=kind)
        super().__init__(mesh=mesh, data_axis_names=(topo_lib.DATA_AXIS,),
                         device=device)

    @property
    def cluster_resolver(self) -> TPUClusterResolver | None:
        return self._cluster_resolver

    def _model_axes(self) -> list:
        if self.mesh is None:
            return []
        names = tuple(self.mesh.mesh_dim_names)
        return [a for a in names if a not in self.data_axis_names
                and self.mesh.size(names.index(a)) > 1]

    def assign_to_logical_device(self, tensor, logical_device_id: int):
        """≙ tpu_strategy.py:453: replicated placement; the value is
        unchanged."""
        return tensor

    def split_to_logical_devices(self, tensor, partition_dimensions):
        """≙ tpu_strategy.py:516: dim i split ``partition_dimensions[i]``
        ways over the mesh's model dims; raises ``ValueError`` when there
        are too few of them. The value is unchanged."""
        needed = sum(1 for n in partition_dimensions if n != 1)
        if needed > len(self._model_axes()):
            shape = (topo_lib.mesh_shape(self.mesh) if self.mesh is not None
                     else {})
            raise ValueError(
                f"Not enough model axes on mesh {tuple(shape.items())} for "
                f"partition_dimensions={partition_dimensions}")
        return tensor

    def replicate_to_logical_devices(self, tensor):
        return self.assign_to_logical_device(tensor, 0)


def initialize_tpu_system(resolver: TPUClusterResolver | None = None):
    """≙ tpu_strategy_util.initialize_tpu_system: the detected topology
    (the visible cards)."""
    return topo_lib.Topology.detect()

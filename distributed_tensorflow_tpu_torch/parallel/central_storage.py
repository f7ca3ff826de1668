"""CentralStorageStrategy: variables on the host, compute on the ranks —
port of ``distributed_tensorflow_tpu/parallel/central_storage.py`` (≙
the reference's ``central_storage_strategy.py``).

One copy of every variable on the parameter device (the host CPU), an
:class:`~distributed_tensorflow_tpu_torch.parallel.ps_values.
AggregatingVariable`; each replica reads it on its own device inside
``run`` and the write-back aggregates the replicas' writes into the one
copy. The replicas are PR 18's: the ranks of the process group, or one
with no group.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.cluster import topology as topo_lib
from distributed_tensorflow_tpu_torch.parallel.ps_values import (
    AggregatingVariable,
    _default_parameter_device,
)
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    Strategy, resolve_device)
from distributed_tensorflow_tpu_torch.parallel.values import (
    VariableAggregation,
    VariableSynchronization,
)


class CentralStorageStrategy(Strategy):
    """Variables on one parameter device; replicas on the mesh.
    ``device`` is this rank's compute device (default its card)."""

    def __init__(self, mesh=None, parameter_device=None, *, device=None):
        super().__init__(mesh=mesh, data_axis_names=(topo_lib.DATA_AXIS,),
                         device=device)
        self._parameter_device = (resolve_device(parameter_device)
                                  if parameter_device is not None
                                  else _default_parameter_device())

    @property
    def parameter_device(self):
        return self._parameter_device

    def gradient_bucketer(self):
        # the variables are not replicated on the mesh: the replicas'
        # writes aggregate on write-back, not in a bucketed all-reduce
        return None

    def create_variable(self, value, *, name=None, trainable=True,
                        synchronization=VariableSynchronization.AUTO,
                        aggregation=VariableAggregation.NONE, dtype=None):
        if synchronization is VariableSynchronization.ON_READ:
            return super().create_variable(
                value, name=name, trainable=trainable,
                synchronization=synchronization, aggregation=aggregation,
                dtype=dtype)
        var = AggregatingVariable(
            value, device=self._parameter_device, name=name,
            trainable=trainable, aggregation=aggregation, dtype=dtype)
        self._variables.append(var)
        return var

"""PS-placed values: AggregatingVariable and per-worker caching — port
of ``distributed_tensorflow_tpu/parallel/ps_values.py`` (≙ the
reference's ``ps_values.py``).

The parameter device is the host CPU, as in the reference and JAX
(``:29-34``): an :class:`AggregatingVariable` keeps its one copy there.
Inside ``Strategy.run`` a replica reads it on the strategy's device (one
host-to-device copy a step: the PS read), and the write-back
aggregates the replicas' writes (MEAN by default, over the data dims)
and copies the result home. :class:`CachingVariable` is a read-mostly
cache of a source variable.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.values import (
    DistributedVariable,
    VariableAggregation,
    VariableSynchronization,
    _overlay,
)


def _default_parameter_device() -> torch.device:
    """The host CPU: the reference's central-storage parameter device."""
    return torch.device("cpu")


class AggregatingVariable(DistributedVariable):
    """One copy on a parameter device with aggregated writes (≙
    ``ps_values.AggregatingVariable``)."""

    def __init__(self, value, *, device=None, name=None, trainable=True,
                 aggregation: VariableAggregation = VariableAggregation.MEAN,
                 dtype=None):
        from distributed_tensorflow_tpu_torch.parallel.strategy import (
            resolve_device)
        self._home_device = (resolve_device(device) if device is not None
                             else _default_parameter_device())
        value = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        if dtype is not None:
            value = value.to(dtype)
        super().__init__(
            value.to(self._home_device).clone(), name=name,
            trainable=trainable,
            synchronization=VariableSynchronization.ON_WRITE,
            aggregation=(aggregation
                         if aggregation is not VariableAggregation.NONE
                         else VariableAggregation.MEAN))

    @property
    def device(self) -> torch.device:
        return self._home_device

    def _replica_value(self):
        """Inside ``Strategy.run``: the value on the strategy's device."""
        rv = super()._replica_value()
        if rv is None:
            return None
        from distributed_tensorflow_tpu_torch.parallel.strategy import (
            get_strategy, has_strategy)
        if has_strategy() and rv.device != get_strategy().device:
            rv = rv.to(get_strategy().device)
            _overlay()[id(self)][1] = rv
        return rv


class CachingVariable:
    """Read-mostly cache of a PS variable (≙ ``ps_values.CachingVariable``):
    reads serve the cached copy, ``update_cache`` re-reads the source,
    writes pass through to the source and refresh the cache."""

    def __init__(self, source: DistributedVariable):
        self._source = source
        self._cache = self._read()

    def _read(self) -> torch.Tensor:
        # a copy: the source's read may share its storage, which a write
        # to the source changes in place
        return self._source.read_value().detach().clone()

    @property
    def name(self):
        return self._source.name

    @property
    def shape(self):
        return self._source.shape

    @property
    def dtype(self):
        return self._source.dtype

    def read_value(self):
        return self._cache

    @property
    def value(self):
        return self._cache

    def update_cache(self):
        self._cache = self._read()
        return self._cache

    def assign(self, value):
        self._source.assign(value)
        return self.update_cache()

    def assign_add(self, delta):
        self._source.assign_add(delta)
        return self.update_cache()

    def __array__(self, dtype=None):
        arr = self._cache.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

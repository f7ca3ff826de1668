"""Data parallelism on ``torch.distributed``: :mod:`collectives` (typed
collectives over a mesh dim's process group, the bucket planner and
:class:`~distributed_tensorflow_tpu_torch.parallel.collectives.
GradientBucketer`, the hierarchical dcn×dp reduction) and :mod:`zero`
(ZeRO-1/2 partitions). Import the submodule you use."""

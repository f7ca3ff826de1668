"""Parallelism on ``torch.distributed``: :mod:`collectives` (typed
collectives over a mesh dim's process group, the bucket planner and
:class:`~distributed_tensorflow_tpu_torch.parallel.collectives.
GradientBucketer`, the hierarchical dcn×dp reduction), :mod:`zero`
(ZeRO-1/2 partitions), :mod:`tensor_parallel` (the vocab-parallel
embedding and CE), :mod:`pipeline` (the schedules and their executor
over point-to-point sends) and :mod:`offload` (the 1F1B stash in host
memory). Import the submodule you use."""

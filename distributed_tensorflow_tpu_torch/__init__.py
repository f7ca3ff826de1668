"""PyTorch/CUDA port of ``distributed_tensorflow_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module layout (``ops/``,
``models/``, ``serving/``, ``telemetry/``, ``resilience/``,
``checkpoint/``, ``cluster/``, ``parallel/``, ``testing/``) so each
ported module sits at the same relative path as the module it is held
against. It imports
torch, numpy and the standard library only — never jax, flax, optax or
anything of the JAX package.

Entry points take an explicit ``device=`` (default ``"cuda"``) and raise
on a machine with no CUDA device unless the caller asks for the CPU.
Every TPU kernel on a ported path is a hand-written Hopper kernel under
``ops/csrc/``, built with ``nvcc`` at first use (``ops/_build.py``);
on a CPU tensor its wrapper runs the plain PyTorch version instead.

Importing this package imports no submodule: import what you use, e.g.
``from distributed_tensorflow_tpu_torch.serving.engine import
InferenceEngine``.
"""

__all__ = ["ops", "models", "serving", "telemetry", "resilience",
           "checkpoint", "cluster", "parallel", "testing"]

"""Kernels and their plain PyTorch versions.

- :mod:`attention` — flash-attention forward (CUDA kernel
  ``csrc/flash_fwd.cu``) plus the unfused ``mha_reference`` contract.
- :mod:`_build` — builds a ``csrc/*.cu`` source with ``nvcc`` into
  ``build/torch_kernels/`` at first use and loads it with ``ctypes``.
"""

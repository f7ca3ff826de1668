"""Kernels and their plain PyTorch versions.

- :mod:`attention` — flash attention with its gradient (CUDA kernels
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``) plus the unfused
  ``mha_reference`` contract.
- :mod:`fused_ce` — vocab-tiled cross-entropy against the tied
  embedding, forward and merged backward (``csrc/fused_ce.cu``), plus
  the unfused ``ce_reference``.
- :mod:`_build` — builds a ``csrc/*.cu`` source with ``nvcc`` into
  ``build/torch_kernels/`` at first use and loads it with ``ctypes``.
"""

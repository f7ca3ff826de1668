"""Kernels and their plain PyTorch versions.

- :mod:`attention` — flash attention with its gradient (CUDA kernels
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``) plus the unfused
  ``mha_reference`` contract.
- :mod:`fused_ce` — vocab-tiled cross-entropy against the tied
  embedding, forward and merged backward (``csrc/fused_ce.cu``), plus
  the unfused ``ce_reference``.
- :mod:`_build` — builds a ``csrc/*.cu`` source with ``nvcc`` into
  ``build/torch_kernels/`` at first use and loads it with ``ctypes``.

Each kernel wrapper adds one to its counter where it launches its
kernel; :func:`launch_counts` reads them all. ``flash_attention``,
``mha_reference`` and ``collective_ops`` (``parallel.collectives``) load
on first use, as JAX's package names.
"""

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_LAZY = {n: "distributed_tensorflow_tpu_torch.ops.attention"
         for n in ("flash_attention", "mha_reference")}
__getattr__, __dir__ = _lazy_names(
    globals(), _LAZY,
    {"collective_ops": "distributed_tensorflow_tpu_torch.parallel.collectives"})


def launch_counts() -> dict:
    """This process's kernel launch counters, by kernel name."""
    from distributed_tensorflow_tpu_torch.ops import (
        attention, fused_adamw, fused_ce)
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd
    cf, cb = fused_ce.fused_ce_fwd, fused_ce.fused_ce_bwd
    return {"flash_fwd_tc": fwd.launches_tc, "flash_fwd": fwd.launches,
            "flash_bwd_dq_tc": bwd.launches_dq_tc,
            "flash_bwd_dq": bwd.launches_dq,
            "flash_bwd_dkv_tc": bwd.launches_dkv_tc,
            "flash_bwd_dkv": bwd.launches_dkv,
            "fused_ce_fwd_tc": cf.launches_tc, "fused_ce_fwd": cf.launches,
            "fused_ce_dh_tc": cb.launches_dh_tc,
            "fused_ce_dh": cb.launches_dh,
            "fused_ce_bwd_a_tc": cb.launches_a_tc,
            "fused_ce_bwd_a": cb.launches_a,
            "fused_ce_bwd_tc": cb.launches_tc, "fused_ce_bwd": cb.launches,
            "fused_ce_de_tc": cb.launches_de_tc,
            "fused_ce_de": cb.launches_de,
            "fused_adamw": fused_adamw.fused_adamw_update.launches,
            # f16 on the tensor-core kernels
            "flash_fwd_tc_f16": fwd.launches_f16,
            "flash_bwd_dq_tc_f16": bwd.launches_dq_f16,
            "flash_bwd_dkv_tc_f16": bwd.launches_dkv_f16,
            "fused_ce_fwd_tc_f16": cf.launches_f16,
            "fused_ce_dh_tc_f16": cb.launches_dh_f16,
            "fused_ce_bwd_a_tc_f16": cb.launches_a_f16,
            "fused_ce_bwd_tc_f16": cb.launches_f16,
            "fused_ce_de_tc_f16": cb.launches_de_f16}

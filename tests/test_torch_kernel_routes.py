"""The inputs the port's kernels take (ROADMAP C-2), on the CPU.

The JAX package's Pallas kernels take any float dtype, any head dim and
any d_model; the port's CUDA kernels take f32, bf16 and f16 at head
dims up to 256 and at any d_model (the cross-entropy backward one launch
a column window of at most ``KERNEL_MAX_D``). Here, exactly:

- :func:`attention_route` names a kernel for f32, bf16 and f16 at every
  head dim 1..256 and every op (f32 the CUDA cores, 16-bit the tensor
  cores), and :func:`kernel_head_dim` pads each to 64, 128 or 256;
- :func:`kernel_route` names a kernel for the three dtypes at every
  d_model 8..8192, forward and every backward variant, and
  :func:`kernel_windows` covers ``[0, d)`` in order with windows no
  wider than ``KERNEL_MAX_D``;
- ``fused_adamw``'s leaf checks take f32, bf16 and f16 ``p`` (with ``g``
  in its dtype), ``mu`` and ``nu``, and refuse the rest.

The plain versions of the new routes against the JAX ops on the same
inputs are in ``tests/test_torch_kernel_routes_attention.py`` and
``tests/test_torch_kernel_routes_parity.py``.
"""

import itertools

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops import fused_adamw as tfa
from distributed_tensorflow_tpu_torch.ops import fused_ce as tce

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
DTYPES = [F32, BF16, F16]
DTYPE_IDS = ["f32", "bf16", "f16"]


@pytest.mark.parametrize("op", tattn.ATTENTION_OPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_attention_route_takes_every_head_dim_to_256(dtype, op):
    want = "cuda_cores" if dtype == F32 else "tc"
    for hd in range(1, 257):
        assert tattn.attention_route(dtype, hd, op) == want, hd
        kd = tattn.kernel_head_dim(hd)
        assert kd in (64, 128, 256) and hd <= kd
        assert kd == min(d for d in (64, 128, 256) if d >= hd)


@pytest.mark.parametrize("op", ["fwd", *tce.BWD_VARIANTS])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernel_route_takes_every_d_to_8192(dtype, op):
    want = "cuda_core" if dtype == F32 else "tensor_core"
    for d in range(8, 8193):
        assert tce.kernel_route(dtype, d, op) == want, d


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernel_windows_cover_d_in_order(dtype):
    """One launch a window: the windows tile ``[0, d)`` left to right,
    none wider than ``KERNEL_MAX_D``; up to it, one window of all of
    ``d``."""
    for d in list(range(8, 2100, 7)) + [4096, 4100, 8192]:
        windows = tce.kernel_windows(dtype, d)
        assert windows[0][0] == 0
        for (o, w), (o2, _) in zip(windows, windows[1:]):
            assert o + w == o2
        assert windows[-1][0] + windows[-1][1] == d
        assert all(0 < w <= tce.KERNEL_MAX_D for _, w in windows)
        if d <= tce.KERNEL_MAX_D:
            assert windows == [(0, d)]


@pytest.mark.parametrize("p_dt,mu_dt,nu_dt", list(itertools.product(
    DTYPES, DTYPES, DTYPES)), ids=[
        "-".join(x) for x in itertools.product(DTYPE_IDS, repeat=3)])
def test_fused_adamw_checks_take_jax_dtypes(p_dt, mu_dt, nu_dt):
    p = torch.zeros(12, dtype=p_dt)
    tfa._check_leaf(p, torch.zeros(12, dtype=p_dt),
                    torch.zeros(12, dtype=mu_dt), torch.zeros(12, dtype=nu_dt))


@pytest.mark.parametrize("p_dt,g_dt,mu_dt,nu_dt,match", [
    (F32, BF16, F32, F32, "share a dtype"),
    (F16, BF16, F32, F32, "share a dtype"),
    (torch.float64, torch.float64, F32, F32, "share a dtype"),
    (BF16, BF16, torch.float64, F32, "mu"),
    (F16, F16, F32, torch.int32, "nu"),
])
def test_fused_adamw_checks_refuse(p_dt, g_dt, mu_dt, nu_dt, match):
    with pytest.raises(ValueError, match=match):
        tfa._check_leaf(torch.zeros(4, dtype=p_dt), torch.zeros(4, dtype=g_dt),
                        torch.zeros(4, dtype=mu_dt),
                        torch.zeros(4, dtype=nu_dt))

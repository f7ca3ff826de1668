"""Fused one-pass AdamW update, in place.

Port of ``distributed_tensorflow_tpu/ops/fused_adamw.py`` (the
single-device update; the per-shard path belongs to the multi-GPU
slice). The semantics are those of the JAX fused update:

    mu'  = b1·mu + (1-b1)·g
    nu'  = b2·nu + (1-b2)·g²
    u    = (mu'·c1) / (sqrt(nu'·c2) + eps) + wd·p
    p'   = p - lr·u

with ``c1 = 1/(1-b1^t)``, ``c2 = 1/(1-b2^t)`` computed in f32 from the
post-increment count ``t``, and all arithmetic in f32. ``b1`` is an f32
scalar even when ``mu`` is stored in bf16: the JAX update casts ``mu``
to f32 before it multiplies by the Python-float ``b1``. optax's
``adamw`` (and the port's plain-op ``AdamW`` class, which follows it)
multiplies a bf16 ``mu`` by bf16(0.9) = 0.8984375 instead, so the two
part after one step with a bf16 ``mu``. As the JAX kernel does, every
tensor is read in its own dtype (f32, bf16 or f16; ``p`` and ``g`` in
one dtype) and each output is rounded back to its input's dtype.

- :func:`adamw_reference` — the plain PyTorch version of one tensor's
  update.
- :func:`fused_adamw_update` — one step over nested dicts or lists of
  tensors. On a CUDA tensor it launches the ``fused_adamw`` kernel of
  ``csrc/fused_adamw.cu``, one launch per parameter tensor; on a CPU
  tensor it runs :func:`adamw_reference`; any other device raises, as
  does a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

#: dtypes the kernel takes for each of p (with g), mu and nu (code
#: passed to the C entry point)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: mu dtypes the kernel takes (every one of KERNEL_DTYPES)
MU_DTYPES = KERNEL_DTYPES
#: C signature of ``csrc/fused_adamw.cu``: p, g, mu, nu, n, the dtypes of
#: p (and g), mu and nu, lr, b1, 1 - b1, b2, 1 - b2, eps, wd, c1, c2,
#: stream
ADAMW_ARGTYPES = {"fused_adamw": [ctypes.c_void_p] * 4
                  + [ctypes.c_longlong] + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 9 + [ctypes.c_void_p]}


def bias_corrections(count: int, b1: float, b2: float):
    """``(c1, c2) = (1/(1-b1^t), 1/(1-b2^t))`` as f32 scalars, with ``t``
    the post-increment count in f32 (JAX ``:152-155``)."""
    t = torch.tensor(float(count + 1), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    c1 = one / (one - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
    c2 = one / (one - torch.pow(torch.tensor(b2, dtype=torch.float32), t))
    return c1.item(), c2.item()


def adamw_reference(p, g, mu, nu, c1, c2, *, lr, b1, b2, eps, wd):
    """Plain PyTorch version of one tensor's update: ``(p', mu', nu')`` in
    the dtypes of ``p``, ``mu`` and ``nu``, every operation in f32 in the
    order of the module docstring's formula."""
    p32, g32 = p.float(), g.float()
    mu2 = b1 * mu.float() + (1.0 - b1) * g32
    nu2 = b2 * nu.float() + (1.0 - b2) * (g32 * g32)
    u = (mu2 * c1) / (torch.sqrt(nu2 * c2) + eps) + wd * p32
    return ((p32 - lr * u).to(p.dtype), mu2.to(mu.dtype),
            nu2.to(nu.dtype))


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _check_leaf(p, g, mu, nu):
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_adamw: {name} {tuple(t.shape)} on "
                             f"{t.device}, p {tuple(p.shape)} on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw: {name} is not contiguous")
    if not p.is_contiguous():
        raise ValueError("fused_adamw: p is not contiguous")
    names = sorted(map(str, KERNEL_DTYPES))
    if p.dtype != g.dtype or p.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_adamw: p {p.dtype} and g {g.dtype} must "
                         f"share a dtype in {names}")
    for name, t in (("mu", mu), ("nu", nu)):
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"fused_adamw: {name} {t.dtype} must be one "
                             f"of {names}")


def _launch(leaves, hyper):
    """One kernel launch per ``(p, g, mu, nu)`` of ``leaves`` (CUDA
    tensors on one device), on its current stream; raise if a launch
    failed. The library, the device and the stream are looked up once
    for all launches: the per-launch host time bounds a step's update."""
    from distributed_tensorflow_tpu_torch.ops import _build
    device = leaves[0][0].device
    for p, g, mu, nu in leaves:
        _check_leaf(p, g, mu, nu)
        if p.device != device:
            raise ValueError(f"fused_adamw: tensors on {p.device} and "
                             f"{device}")
    lib = _build.load("fused_adamw", ADAMW_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for p, g, mu, nu in leaves:
            if p.numel() == 0:
                continue
            err = lib.fused_adamw(p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                                  nu.data_ptr(), p.numel(),
                                  KERNEL_DTYPES[p.dtype],
                                  KERNEL_DTYPES[mu.dtype],
                                  KERNEL_DTYPES[nu.dtype], *hyper, stream)
            if err != 0:
                raise RuntimeError(f"fused_adamw kernel launch failed: CUDA "
                                   f"error {err} "
                                   f"({_build.error_string(lib, err)})")
            fused_adamw_update.launches += 1


def fused_adamw_update(params, grads, mu, nu, count, *, lr: float,
                       b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, weight_decay: float = 0.0):
    """One AdamW step over ``params`` (nested dicts or lists of tensors,
    with ``grads``, ``mu`` and ``nu`` of the same structure).

    ``count`` is the pre-increment step count (optax's convention: the
    bias corrections use ``count + 1``). Returns ``(params, mu, nu,
    count + 1)``: ``params``, ``mu`` and ``nu`` are the objects given,
    updated **in place** — the counterpart of the JAX kernel's
    input→output aliasing (``ops/fused_adamw.py:122``).

    A CUDA tensor goes through the ``fused_adamw`` kernel, one launch per
    parameter tensor (counted in ``fused_adamw_update.launches``), as
    JAX launches one per leaf; a CPU tensor through
    :func:`adamw_reference`; any other device raises."""
    count = int(count)
    c1, c2 = bias_corrections(count, b1, b2)
    trees = [list(_leaves(t)) for t in (params, grads, mu, nu)]
    if len({len(t) for t in trees}) != 1:
        raise ValueError("fused_adamw: params, grads, mu and nu differ in "
                         "their number of tensors")
    hyper = (lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, c1, c2)
    leaves = list(zip(*trees))
    for p, *_ in leaves:
        if p.device.type not in ("cuda", "cpu"):
            raise ValueError(f"fused_adamw: no kernel for device "
                             f"{p.device}")
    with torch.no_grad():
        on_card = [x for x in leaves if x[0].device.type == "cuda"]
        if on_card:
            _launch(on_card, hyper)
        for p, g, m, v in leaves:
            if p.device.type == "cpu":
                new = adamw_reference(p, g, m, v, c1, c2, lr=lr, b1=b1,
                                      b2=b2, eps=eps, wd=weight_decay)
                for dst, src in zip((p, m, v), new):
                    dst.copy_(src)
    return params, mu, nu, count + 1


fused_adamw_update.launches = 0

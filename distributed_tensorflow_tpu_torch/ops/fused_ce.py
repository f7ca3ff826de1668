"""Fused vocab-tiled cross-entropy against a tied embedding.

Port of ``distributed_tensorflow_tpu/ops/fused_ce.py`` (the single-device
op; the sharded op belongs to the multi-GPU slice). Per-token losses of
``hidden @ embed.T`` against ``targets`` without the ``(N, V)`` logits in
device memory:

- :func:`ce_reference` — the unfused semantics contract.
- :func:`fused_ce_fwd` — ``(lse, tl)``, the row logsumexp and the target
  logit. On a CUDA tensor it launches ``fused_ce_fwd`` of
  ``csrc/fused_ce.cu`` (the port of the Pallas ``_fwd_kernel``); on a
  CPU tensor it runs :func:`fused_ce_fwd_plain`.
- :func:`fused_ce_bwd` — ``(dh, dE)`` from the saved ``lse`` and the
  per-row cotangent ``g``, by one of three variants. On a CUDA tensor it
  launches, in ``csrc/fused_ce.cu``: for ``"b"`` ``fused_ce_bwd`` (the
  port of the merged backward ``_bwd_merged_b_kernel``), for ``"a"``
  ``fused_ce_bwd_a`` (``_bwd_merged_kernel``), for ``"split"``
  ``fused_ce_dh`` then ``fused_ce_de`` (``_dh_kernel``, ``_de_kernel``).
  On a CPU tensor it runs :func:`fused_ce_bwd_plain`, or for ``"split"``
  :func:`fused_ce_dh_plain` and :func:`fused_ce_de_plain`.
- :func:`fused_cross_entropy` — the public op, differentiable in
  ``hidden`` and ``embed`` through :class:`FusedCrossEntropy`.

Any device other than CUDA and CPU raises, and so does a failed build or
launch: nothing falls back to the plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

#: input dtypes the CUDA kernels take (code passed to the C entry points)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest d_model the backward kernels take (each keeps a 32 x D f32
#: gradient accumulator in shared memory)
KERNEL_MAX_D = 1024
#: rows per chunk of :func:`fused_cross_entropy`, as in the JAX op
ROW_CHUNK = 4096
#: backward variants of :func:`fused_ce_bwd`
BWD_VARIANTS = ("b", "a", "split")
#: C signatures of ``csrc/fused_ce.cu``: pointers, then N, V, D, dtype,
#: stream
CE_ARGTYPES = {
    name: [ctypes.c_void_p] * n + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for name, n in (("fused_ce_fwd", 5), ("fused_ce_bwd", 7),
                    ("fused_ce_bwd_a", 7), ("fused_ce_dh", 6),
                    ("fused_ce_de", 6))}


# ---------------------------------------------------------------------------
# Reference and plain versions
# ---------------------------------------------------------------------------

def _logits(hidden, embed):
    """``hidden @ embed.T`` from the inputs' values, accumulated in f32
    (``preferred_element_type=f32`` in the JAX kernels)."""
    return hidden.float() @ embed.float().T


def ce_reference(hidden, embed, targets):
    """Per-token CE losses, unfused: ``logsumexp(h Eᵀ) − h·E_t``, f32."""
    logits = _logits(hidden, embed)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets.long()[:, None])[:, 0]
    return lse - tl


def fused_ce_fwd_plain(hidden, embed, targets):
    """Plain PyTorch version of the forward kernel: ``(lse, tl)``, both
    ``(N,)`` f32. A target outside ``[0, V)`` picks up ``tl = 0``."""
    logits = _logits(hidden, embed)
    lse = torch.logsumexp(logits, dim=-1)
    t = targets.long()
    inside = (t >= 0) & (t < embed.shape[0])
    tl = logits.gather(-1, t.clamp(0, embed.shape[0] - 1)[:, None])[:, 0]
    return lse, torch.where(inside, tl, torch.zeros_like(tl))


def _p_adj_plain(hidden, embed, targets, lse, g):
    """``p_adj = (exp(h Eᵀ − lse) − onehot(t)) · g``, ``(N, V)``, rounded
    to ``embed``'s dtype and returned in f32 (JAX ``_p_adj`` and
    ``:220``)."""
    p = torch.exp(_logits(hidden, embed) - lse[:, None])
    t = targets.long()
    cols = torch.arange(embed.shape[0], device=hidden.device)
    p = p - (cols[None, :] == t[:, None]).float()
    return (p * g.float()[:, None]).to(embed.dtype).float()


def fused_ce_dh_plain(hidden, embed, targets, lse, g):
    """Plain PyTorch version of the dh kernel (#5): ``dh = p_adj E`` in
    ``hidden``'s dtype, accumulated in f32."""
    p = _p_adj_plain(hidden, embed, targets, lse, g)
    return (p @ embed.float()).to(hidden.dtype)


def fused_ce_de_plain(hidden, embed, targets, lse, g):
    """Plain PyTorch version of the dE kernel (#8): ``dE = p_adjᵀ h`` in
    ``embed``'s dtype, accumulated in f32."""
    p = _p_adj_plain(hidden, embed, targets, lse, g)
    return (p.T @ hidden.float()).to(embed.dtype)


def fused_ce_bwd_plain(hidden, embed, targets, lse, g):
    """Plain PyTorch version of the merged backwards (#7, #6): ``(dh,
    dE)`` from one ``p_adj``; ``dh = p_adj E`` in ``hidden``'s dtype and
    ``dE = p_adjᵀ h`` in ``embed``'s, both accumulated in f32."""
    p = _p_adj_plain(hidden, embed, targets, lse, g)
    dh = p @ embed.float()
    de = p.T @ hidden.float()
    return dh.to(hidden.dtype), de.to(embed.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_inputs(hidden, embed, targets):
    if hidden.ndim != 2 or embed.ndim != 2 \
            or hidden.shape[1] != embed.shape[1]:
        raise ValueError(f"fused_ce: hidden {tuple(hidden.shape)} and "
                         f"embed {tuple(embed.shape)} must be (N, D), "
                         f"(V, D)")
    if targets.shape != (hidden.shape[0],):
        raise ValueError(f"fused_ce: targets {tuple(targets.shape)}, "
                         f"expected ({hidden.shape[0]},)")
    for name, t in (("embed", embed), ("targets", targets)):
        if t.device != hidden.device:
            raise ValueError(f"fused_ce: {name} on {t.device}, hidden on "
                             f"{hidden.device}")
    if embed.dtype != hidden.dtype or hidden.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_ce: hidden {hidden.dtype} and embed "
                         f"{embed.dtype} must share a dtype in "
                         f"{sorted(map(str, KERNEL_DTYPES))}")
    for name, t in (("hidden", hidden), ("embed", embed)):
        if not t.is_contiguous():
            raise ValueError(f"fused_ce: {name} is not contiguous")


def _launch(entry, device, *args):
    """Run C entry point ``entry`` of ``csrc/fused_ce.cu`` on ``device``'s
    current stream; raise if the launch failed."""
    from distributed_tensorflow_tpu_torch.ops import _build
    lib = _build.load("fused_ce", CE_ARGTYPES)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(lib, err)})")


def _row_vector(x, n, name, device):
    if x.shape != (n,) or x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"fused_ce: {name} must be ({n},) float32 on "
                         f"{device}")
    return x.contiguous()


def fused_ce_fwd(hidden, embed, targets):
    """``(lse, tl)`` of ``hidden @ embed.T``, both ``(N,)`` f32.

    A CUDA tensor goes through the ``fused_ce_fwd`` kernel (one launch
    counted in ``fused_ce_fwd.launches``), a CPU tensor through
    :func:`fused_ce_fwd_plain`; any other device raises."""
    with torch.no_grad():
        if hidden.device.type == "cpu":
            return fused_ce_fwd_plain(hidden, embed, targets)
        if hidden.device.type != "cuda":
            raise ValueError(f"fused_ce: no kernel for device "
                             f"{hidden.device}")
        _check_kernel_inputs(hidden, embed, targets)
        n, d = hidden.shape
        v = embed.shape[0]
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        tl = torch.empty_like(lse)
        if n == 0:
            return lse, tl
        t = targets.to(torch.int32).contiguous()
        _launch("fused_ce_fwd", hidden.device, hidden.data_ptr(),
                embed.data_ptr(), t.data_ptr(), lse.data_ptr(),
                tl.data_ptr(), n, v, d, KERNEL_DTYPES[hidden.dtype])
        fused_ce_fwd.launches += 1
        return lse, tl


fused_ce_fwd.launches = 0


def fused_ce_bwd(hidden, embed, targets, lse, g, *, variant: str = "b"):
    """``(dh, dE)`` of the per-token losses against the cotangent ``g``
    (``(N,)`` f32), from the forward's ``lse``.

    A CUDA tensor goes through the kernels of ``variant``, each launch
    counted on this function:

    - ``"b"``: ``fused_ce_bwd`` (``.launches``) adds dE into an f32
      ``(V, D)`` accumulator with atomics and keeps dh on chip;
    - ``"a"``: ``fused_ce_bwd_a`` (``.launches_a``) adds dh into an f32
      ``(N, D)`` accumulator with atomics and keeps dE on chip;
    - ``"split"``: ``fused_ce_dh`` (``.launches_dh``) then
      ``fused_ce_de`` (``.launches_de``), each gradient on chip, no
      atomics: the same dE on every run.

    With atomics the summation order of that gradient varies from run to
    run; the accumulator is cast to the input dtype afterwards. A CPU
    tensor goes through the plain versions; any other device raises."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"fused_ce_bwd: variant={variant!r}; expected one "
                         f"of {BWD_VARIANTS}")
    with torch.no_grad():
        if hidden.device.type == "cpu":
            if variant == "split":
                return (fused_ce_dh_plain(hidden, embed, targets, lse, g),
                        fused_ce_de_plain(hidden, embed, targets, lse, g))
            return fused_ce_bwd_plain(hidden, embed, targets, lse, g)
        if hidden.device.type != "cuda":
            raise ValueError(f"fused_ce: no kernel for device "
                             f"{hidden.device}")
        _check_kernel_inputs(hidden, embed, targets)
        n, d = hidden.shape
        v = embed.shape[0]
        if d > KERNEL_MAX_D:
            raise ValueError(f"fused_ce_bwd: d_model {d} > "
                             f"{KERNEL_MAX_D}, the widest the kernel "
                             f"takes")
        if n == 0:
            return torch.empty_like(hidden), torch.zeros_like(embed)
        lse = _row_vector(lse, n, "lse", hidden.device)
        g = _row_vector(g, n, "g", hidden.device)
        t = targets.to(torch.int32).contiguous()
        args = (hidden.data_ptr(), embed.data_ptr(), t.data_ptr(),
                lse.data_ptr(), g.data_ptr())
        shape = (n, v, d, KERNEL_DTYPES[hidden.dtype])
        f32 = dict(dtype=torch.float32, device=hidden.device)
        if variant == "b":
            dh = torch.empty_like(hidden)
            de_acc = torch.zeros((v, d), **f32)
            _launch("fused_ce_bwd", hidden.device, *args, dh.data_ptr(),
                    de_acc.data_ptr(), *shape)
            fused_ce_bwd.launches += 1
            return dh, de_acc.to(embed.dtype)
        if variant == "a":
            dh_acc = torch.zeros((n, d), **f32)
            de = torch.empty_like(embed)
            _launch("fused_ce_bwd_a", hidden.device, *args,
                    dh_acc.data_ptr(), de.data_ptr(), *shape)
            fused_ce_bwd.launches_a += 1
            return dh_acc.to(hidden.dtype), de
        dh, de = torch.empty_like(hidden), torch.empty_like(embed)
        _launch("fused_ce_dh", hidden.device, *args, dh.data_ptr(), *shape)
        fused_ce_bwd.launches_dh += 1
        _launch("fused_ce_de", hidden.device, *args, de.data_ptr(), *shape)
        fused_ce_bwd.launches_de += 1
        return dh, de


fused_ce_bwd.launches = 0       # "b", #7
fused_ce_bwd.launches_a = 0     # "a", #6
fused_ce_bwd.launches_dh = 0    # "split", #5
fused_ce_bwd.launches_de = 0    # "split", #8


class FusedCrossEntropy(torch.autograd.Function):
    """Per-token losses ``lse − tl``; the forward saves
    ``(hidden, embed, targets, lse)`` and the backward runs
    :func:`fused_ce_bwd` of the given variant — the counterpart of
    ``_fused_ce``'s ``custom_vjp`` (JAX ``ops/fused_ce.py:500-527``)."""

    @staticmethod
    def forward(ctx, hidden, embed, targets, variant):
        lse, tl = fused_ce_fwd(hidden, embed, targets)
        ctx.save_for_backward(hidden, embed, targets, lse)
        ctx.variant = variant
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        hidden, embed, targets, lse = ctx.saved_tensors
        dh, de = fused_ce_bwd(hidden, embed, targets, lse,
                              g.float().contiguous(), variant=ctx.variant)
        return dh, de, None, None


def fused_cross_entropy(hidden, embed, targets, *, bwd_variant: str = "b"):
    """Per-token CE losses ``(N,)`` f32 of ``hidden @ embed.T`` against
    ``targets`` without the ``(N, V)`` logits in device memory.

    ``hidden`` (N, D) and ``embed`` (V, D) share a dtype (cast outside);
    differentiable in both. Rows are cut into chunks of 4096 when N is a
    larger multiple of it, as the JAX op does, so each chunk runs one
    forward and one backward; autograd sums the chunks' dE.

    ``bwd_variant`` picks the backward kernels (:func:`fused_ce_bwd`):
    ``"b"``, the default, for every shape; ``"a"``; ``"split"``. The JAX
    dispatch falls back to the split kernels when a chunk has fewer than
    4 token (``"a"``) or vocab (``"b"``) tiles, to avoid a TPU write-back
    race on its aliased buffer; the port adds with atomics and has no
    such race, so each variant runs as asked."""
    if bwd_variant not in BWD_VARIANTS:
        raise ValueError(f"fused_cross_entropy: bwd_variant={bwd_variant!r}"
                         f"; expected one of {BWD_VARIANTS}")
    n = hidden.shape[0]
    if n <= ROW_CHUNK or n % ROW_CHUNK:
        return FusedCrossEntropy.apply(hidden, embed, targets, bwd_variant)
    return torch.cat([
        FusedCrossEntropy.apply(hidden[i:i + ROW_CHUNK], embed,
                                targets[i:i + ROW_CHUNK], bwd_variant)
        for i in range(0, n, ROW_CHUNK)])

"""Multi-head attention: the unfused contract and flash attention with
its gradient.

Port of ``distributed_tensorflow_tpu/ops/attention.py``. Layout is
``(batch, num_heads, seq, head_dim)`` throughout, as in the JAX package.

- :func:`length_valid_mask` / :func:`mha_reference` — the unfused
  semantics contract (right-padded batches via ``lengths``, explicit
  cache positions via ``q_positions``, bottom-right causal alignment,
  fully-masked rows output 0).
- :func:`flash_attention_fwd` — the flash-attention forward, returning
  ``(o, lse)``. On a CUDA tensor it launches the hand-written Hopper
  kernel ``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``);
  on a CPU tensor it runs :func:`flash_attention_plain`, the plain
  PyTorch version of the same function. Any other device raises. It
  records no autograd graph.
- :func:`flash_attention_bwd` — the backward ``(dq, dk, dv)`` from the
  forward's ``(o, lse)``: on a CUDA tensor the kernels
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` of ``csrc/flash_bwd.cu`` (the
  ports of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), on a CPU tensor
  :func:`flash_attention_bwd_plain`.
- :func:`flash_attention` — the public op, ``o`` only, differentiable
  through :class:`FlashAttention` (the counterpart of the JAX
  ``custom_vjp``).
"""

from __future__ import annotations

import ctypes

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)
#: input dtypes the CUDA kernel takes (code passed to the C entry point)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: C signature of ``flash_fwd`` in ``csrc/flash_fwd.cu``: q, k, v, o, lse
#: pointers; bh, sq, sk, hd, dtype; sm_scale; causal, causal_offset; stream
FLASH_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p])
#: C signatures of ``csrc/flash_bwd.cu``: q, k, v, do, lse, delta and the
#: outputs (dq; dk, dv) as pointers, then as ``flash_fwd``
FLASH_BWD_ARGTYPES = {
    name: ([ctypes.c_void_p] * n + [ctypes.c_int] * 5
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for name, n in (("flash_bwd_dq", 7), ("flash_bwd_dkv", 8))}


# ---------------------------------------------------------------------------
# Reference implementation (the semantics contract)
# ---------------------------------------------------------------------------

def length_valid_mask(lengths, q_len: int, kv_len: int, *,
                      causal: bool = False, causal_offset: int | None = None,
                      q_positions=None):
    """Validity mask for right-padded mixed-length batches — the one
    masking rule shared by full-sequence recompute (:func:`mha_reference`)
    and the serving engine's incremental KV-cache decode.

    Query ``i`` of sequence ``b`` may see key ``j`` iff both lie inside
    the sequence (``i < lengths[b]``, via ``q_positions`` when the
    queries are a window into a longer cache, and ``j < lengths[b]``)
    and, under ``causal``, ``j <= i + causal_offset`` (offset defaults
    to ``kv_len - q_len``, bottom-right; explicit ``q_positions`` are
    absolute cache positions, offset 0).

    Returns ``(B, 1, q_len, kv_len)`` bool.
    """
    if causal_offset is None:
        causal_offset = 0 if q_positions is not None else kv_len - q_len
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    device = lengths.device
    if q_positions is None:
        q_ids = torch.arange(q_len, dtype=torch.int32,
                             device=device)[None, :]          # (1, q)
    else:
        q_ids = torch.as_tensor(q_positions, dtype=torch.int32,
                                device=device)
        if q_ids.ndim == 1:
            q_ids = q_ids[:, None]                            # (B, q=1)
    k_ids = torch.arange(kv_len, dtype=torch.int32, device=device)
    valid = ((q_ids[:, :, None] < lengths[:, None, None])
             & (k_ids[None, None, :] < lengths[:, None, None]))
    if causal:
        valid = valid & (k_ids[None, None, :]
                         <= q_ids[:, :, None] + causal_offset)
    return valid[:, None]                                     # (B,1,q,k)


def mha_reference(q, k, v, *, causal: bool = False,
                  sm_scale: float | None = None, lengths=None,
                  q_positions=None):
    """Unfused attention in f32, output in ``q``'s dtype.

    ``lengths`` (B,) masks a right-padded batch via
    :func:`length_valid_mask`: padded keys are invisible to every query
    and fully-padded query rows output 0. ``q_positions`` places the
    queries at explicit cache positions (incremental decode)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    valid = None
    if causal and lengths is None:
        qs, ks = q.shape[2], k.shape[2]
        valid = torch.ones(qs, ks, dtype=torch.bool, device=q.device
                           ).tril(ks - qs)[None, None]
    if lengths is not None:
        valid = length_valid_mask(
            torch.as_tensor(lengths, device=q.device), q.shape[2],
            k.shape[2], causal=causal, q_positions=q_positions)
    if valid is not None:
        logits = torch.where(valid, logits,
                             torch.tensor(DEFAULT_MASK_VALUE,
                                          device=q.device))
    probs = torch.softmax(logits, dim=-1)
    if valid is not None:
        # fully-masked query rows output 0, not the uniform average
        probs = probs * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-attention forward: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, *, causal: bool, sm_scale: float,
                          causal_offset: int | None = None):
    """Plain PyTorch version of the flash forward: ``(o, lse)``.

    ``o`` in ``q``'s dtype, ``lse`` ``(B, H, Sq)`` f32 — the per-row
    logsumexp of the scaled, masked logits. Causal masking is
    bottom-right aligned: query ``i`` sees key ``j`` iff
    ``j <= i + causal_offset`` (default ``Sk - Sq``). A row that sees no
    key at all gets ``o = 0`` and ``lse = +inf``, as the Pallas kernel
    stores so that a backward recomputes ``p = 0`` there."""
    sq, sk = q.shape[2], k.shape[2]
    if causal_offset is None:
        causal_offset = sk - sq
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        q_ids = torch.arange(sq, device=q.device)[:, None]
        k_ids = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(k_ids > q_ids + causal_offset, float("-inf"))
    m = s.amax(dim=-1, keepdim=True) if sk else torch.full(
        s.shape[:-1] + (1,), float("-inf"), device=q.device)
    empty = torch.isneginf(m)
    p = torch.exp(s - torch.where(empty, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.where(
        empty, 1.0, l)
    lse = torch.where(empty, float("inf"), m + torch.log(l))
    return o.to(q.dtype), lse[..., 0]


def _check_kernel_inputs(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{sorted(map(str, KERNEL_DTYPES))}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, hd)")
    b, h, _, hd = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")


def _launch_kernel(q, k, v, sm_scale, causal, causal_offset):
    from distributed_tensorflow_tpu_torch.ops import _build

    _check_kernel_inputs(q, k, v)
    lib = _build.load("flash_fwd", {"flash_fwd": FLASH_FWD_ARGTYPES})
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h == 0 or sq == 0:
        return o, lse
    # the launch (and its cudaFuncSetAttribute) must run in q's context
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, hd, KERNEL_DTYPES[q.dtype],
            ctypes.c_float(sm_scale), int(bool(causal)),
            int(causal_offset), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        sm_scale: float | None = None,
                        causal_offset: int | None = None):
    """Flash-attention forward ``(o, lse)``, recording no autograd graph.

    A CUDA tensor goes through the ``flash_fwd`` kernel (and counts one
    launch in ``flash_attention_fwd.launches``); a CPU tensor through
    :func:`flash_attention_plain`. Any other device raises. Gradients go
    through :func:`flash_attention`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal_offset is None:
        causal_offset = k.shape[2] - q.shape[2]
    with torch.no_grad():
        if q.device.type == "cuda":
            return _launch_kernel(q, k, v, float(sm_scale), causal,
                                  causal_offset)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale,
                                         causal_offset=causal_offset)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Flash-attention backward: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool,
                              sm_scale: float,
                              causal_offset: int | None = None):
    """Plain PyTorch version of the flash backward: ``(dq, dk, dv)`` in
    the inputs' dtypes.

    ``p = exp(q kᵀ · sm_scale − lse)`` is recomputed from the forward's
    row logsumexp (``p = 0`` on masked pairs and on rows with
    ``lse = +inf``), ``delta = rowsum(o · do)`` in f32 and
    ``ds = p ⊙ (do vᵀ − delta) · sm_scale``. As in the Pallas kernels,
    ``ds`` is rounded to the input dtype before ``dq = ds k`` and
    ``dk = dsᵀ q``, and ``p`` before ``dv = pᵀ do``; products accumulate
    in f32."""
    sq, sk = q.shape[2], k.shape[2]
    if causal_offset is None:
        causal_offset = sk - sq
    dt = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (o.float() * do32).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        q_ids = torch.arange(sq, device=q.device)[:, None]
        k_ids = torch.arange(sk, device=q.device)[None, :]
        p = p.masked_fill(k_ids > q_ids + causal_offset, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    ds = (p * (dp - delta) * sm_scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do32)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_inputs(q, k, v, do, lse, delta):
    _check_kernel_inputs(q, k, v)
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype \
            or do.device != q.device or not do.is_contiguous():
        raise ValueError(f"flash_attention_bwd: do must be a contiguous "
                         f"{q.dtype} tensor of q's shape {tuple(q.shape)} "
                         f"on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous float32 tensor of shape "
                             f"{(b, h, sq)} on {q.device}")


def _launch_bwd(entry, outs, q, k, v, do, lse, delta, sm_scale, causal,
                causal_offset) -> bool:
    """Run C entry point ``entry`` of ``csrc/flash_bwd.cu`` into ``outs``;
    True if it launched, False if the work was empty (``outs`` zeroed)."""
    from distributed_tensorflow_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"{entry}: the kernel takes CUDA tensors, q is "
                         f"on {q.device}")
    _check_bwd_inputs(q, k, v, do, lse, delta)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    if b * h == 0 or sq == 0 or sk == 0:
        for t in outs:
            t.zero_()
        return False
    lib = _build.load("flash_bwd", FLASH_BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b * h, sq, sk, hd, KERNEL_DTYPES[q.dtype],
            ctypes.c_float(sm_scale), int(bool(causal)), int(causal_offset),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    return True


def launch_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                  causal: bool, causal_offset: int):
    """``dq`` from one launch of the ``flash_bwd_dq`` kernel (CUDA
    tensors; ``delta = rowsum(o · do)`` f32), counted in
    ``flash_attention_bwd.launches_dq``; empty work launches nothing and
    counts nothing."""
    dq = torch.empty_like(q)
    if _launch_bwd("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, sm_scale,
                   causal, causal_offset):
        flash_attention_bwd.launches_dq += 1
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                   causal: bool, causal_offset: int):
    """``(dk, dv)`` from one launch of the ``flash_bwd_dkv`` kernel,
    counted in ``flash_attention_bwd.launches_dkv``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta,
                   sm_scale, causal, causal_offset):
        flash_attention_bwd.launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        sm_scale: float | None = None,
                        causal_offset: int | None = None):
    """Flash-attention backward ``(dq, dk, dv)`` from the forward's
    ``(o, lse)`` and the output cotangent ``do``.

    A CUDA tensor goes through the ``flash_bwd_dq`` and ``flash_bwd_dkv``
    kernels (counting one launch each in ``flash_attention_bwd.
    launches_dq`` / ``.launches_dkv``); a CPU tensor through
    :func:`flash_attention_bwd_plain`. Any other device raises."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal_offset is None:
        causal_offset = k.shape[2] - q.shape[2]
    with torch.no_grad():
        if q.device.type == "cuda":
            if o.shape != q.shape or o.device != q.device:
                raise ValueError(f"flash_attention_bwd: o must have q's "
                                 f"shape {tuple(q.shape)} on {q.device}")
            # delta = rowsum(o · do) in f32 before the kernels, as in
            # JAX (:371)
            delta = (o.float() * do.float()).sum(-1)
            kw = dict(sm_scale=float(sm_scale), causal=causal,
                      causal_offset=causal_offset)
            dq = launch_bwd_dq(q, k, v, do, lse, delta, **kw)
            return (dq, *launch_bwd_dkv(q, k, v, do, lse, delta, **kw))
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
                causal_offset=causal_offset)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward saves
    ``(q, k, v, o, lse)`` and the backward recomputes ``p`` from them —
    the counterpart of ``_flash_mha``'s ``custom_vjp`` (JAX
    ``ops/attention.py:433-452``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None):
    """Fused attention. ``(b, h, s, d)`` in, ``(b, h, s, d)`` out;
    differentiable in ``q``, ``k`` and ``v``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, float(sm_scale))

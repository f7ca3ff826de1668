"""Multi-head attention: the unfused contract and flash attention with
its gradient.

Port of ``distributed_tensorflow_tpu/ops/attention.py``. Layout is
``(batch, num_heads, seq, head_dim)`` throughout, as in the JAX package.

- :func:`length_valid_mask` / :func:`mha_reference` — the unfused
  semantics contract (right-padded batches via ``lengths``, explicit
  cache positions via ``q_positions``, bottom-right causal alignment,
  fully-masked rows output 0).
- :func:`flash_attention_fwd` — the flash-attention forward, returning
  ``(o, lse)``. On a CUDA tensor it launches a hand-written Hopper
  kernel, the port of the Pallas ``_fwd_kernel``: in bf16 and f16
  ``flash_fwd_tc`` (``csrc/flash_tc.cu``, tensor cores), in f32
  ``flash_fwd`` (``csrc/flash_fwd.cu``, CUDA cores); on a CPU tensor it
  runs :func:`flash_attention_plain`, the plain PyTorch version of the
  same function. Any other device raises. It records no autograd graph.
- :func:`flash_attention_bwd` — the backward ``(dq, dk, dv)`` from the
  forward's ``(o, lse)``: on a CUDA tensor the kernels of the ports of
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, in bf16 and f16
  ``flash_bwd_dq_tc`` and ``flash_bwd_dkv_tc`` (``csrc/flash_tc.cu``,
  tensor cores), in f32 ``flash_bwd_dq`` and ``flash_bwd_dkv``
  (``csrc/flash_bwd.cu``, CUDA cores); on a CPU tensor
  :func:`flash_attention_bwd_plain`.
  :func:`attention_route` states which kernel a CUDA call takes; a head
  dim up to 256 other than 64, 128 and 256 is zero-padded to the next of
  the three the kernels are built for (:func:`kernel_head_dim`).
- :func:`flash_attention_op` — the forward and its gradient as one
  registered op, ``dtt_torch::flash_attention(q, k, v, causal,
  sm_scale) -> (o, lse)`` (:data:`FLASH_ATTENTION_OP`), the counterpart
  of the JAX ``custom_vjp``: selective activation checkpointing sees it
  as one op, so the "attn" remat policies can save its outputs.
- :func:`flash_attention` — the public function, ``o`` only.
- :func:`sharded_flash_attention` — the same on this rank's block of
  operands sharded over the batch and head (``tp``) axes.
"""

from __future__ import annotations

import ctypes

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: head dims the CUDA kernels are instantiated for; flash_attention_fwd
#: and flash_attention_bwd zero-pad any smaller one to the next of them
KERNEL_HEAD_DIMS = (64, 128, 256)
#: input dtypes the CUDA kernels take (code passed to the C entry points)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernels of the forward and of the backward's two halves
ATTENTION_OPS = ("fwd", "dq", "dkv")
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
#: C signatures of ``csrc/flash_tc.cu``: those of the CUDA-core entry
#: points they stand in for in bf16 and f16
FLASH_TC_ARGTYPES = {"flash_fwd_tc": FLASH_FWD_ARGTYPES,
                     "flash_bwd_dq_tc": FLASH_BWD_ARGTYPES["flash_bwd_dq"],
                     "flash_bwd_dkv_tc": FLASH_BWD_ARGTYPES["flash_bwd_dkv"]}


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
    stores so that a backward recomputes ``p = 0`` there. In f16, ``p``
    is rounded to f16 before ``p v`` as the Pallas kernel rounds it to
    the input dtype (JAX ``:184``); ``l`` sums the unrounded ``p``."""
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
    pv = p.to(v.dtype).float() if v.dtype == torch.float16 else p
    o = torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / torch.where(
        empty, 1.0, l)
    lse = torch.where(empty, float("inf"), m + torch.log(l))
    return o.to(q.dtype), lse[..., 0]


def attention_route(dtype, hd: int, op: str) -> str:
    """Which kernel a CUDA call takes: ``"tc"`` (``csrc/flash_tc.cu``,
    tensor cores) or ``"cuda_cores"`` (``csrc/flash_fwd.cu``,
    ``csrc/flash_bwd.cu``), for inputs of ``dtype`` and head dim ``hd``
    and ``op`` — ``"fwd"``, ``"dq"`` or ``"dkv"``.

    - bf16 and f16 go to the tensor cores, every op;
    - f32 stays on the CUDA cores, whose f32 products keep f32 parity
      (on tensor cores f32 would be TF32);
    - a head dim up to 256 is taken: :func:`flash_attention_fwd` and
      :func:`flash_attention_bwd` zero-pad it to :func:`kernel_head_dim`;
    - any other dtype, a head dim above 256 (the kernels' tiles at 256
      take most of a block's shared memory) or an unknown ``op`` raises
      ValueError."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention: dtype {dtype} not in "
                         f"{sorted(map(str, KERNEL_DTYPES))}")
    kernel_head_dim(hd)
    if op not in ATTENTION_OPS:
        raise ValueError(f"flash_attention: op={op!r}; expected one of "
                         f"{ATTENTION_OPS}")
    return "cuda_cores" if dtype == torch.float32 else "tc"


def kernel_head_dim(hd: int) -> int:
    """The head dim of :data:`KERNEL_HEAD_DIMS` that a head dim ``hd`` is
    zero-padded to: the smallest that holds it. Exact: zero columns of q
    and k add nothing to the scores, zero columns of v give zero columns
    of o (so ``delta = rowsum(o · do)`` is unchanged), and the padded
    columns of dq, dk and dv are dropped. ValueError above 256."""
    for kd in KERNEL_HEAD_DIMS:
        if 0 < hd <= kd:
            return kd
    raise ValueError(f"flash_attention: head_dim {hd} is not in 1.."
                     f"{KERNEL_HEAD_DIMS[-1]}, the widest the kernels take")


def with_padded_head(fn, tensors, *args, **kw):
    """``fn(*tensors, *args, **kw)`` with the head dim (last dim) of each
    of ``tensors`` zero-padded to :func:`kernel_head_dim`, and the
    head-dim axis of its 4-D outputs (o, dq, dk, dv) sliced back; ``lse``
    and ``delta`` have no head dim and pass as they are. Without padding
    to do, ``fn`` runs on the tensors as they are."""
    hd = tensors[0].shape[-1]
    kd = kernel_head_dim(hd)
    if kd == hd:
        return fn(*tensors, *args, **kw)
    out = fn(*(torch.nn.functional.pad(x, (0, kd - hd)) for x in tensors),
             *args, **kw)
    return tuple(x[..., :hd].contiguous() if x.ndim == 4 else x
                 for x in out)


def _check_kernel_inputs(q, k, v, op: str) -> str:
    """Raise on inputs no kernel takes; return the route of ``op``."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, hd)")
    b, h, _, hd = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    route = attention_route(q.dtype, hd, op)
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernels take head_dim "
                         f"{KERNEL_HEAD_DIMS}, not {hd} (flash_attention_fwd"
                         f" and flash_attention_bwd pad it)")
    return route


def _launch_kernel(q, k, v, sm_scale, causal, causal_offset):
    from distributed_tensorflow_tpu_torch.ops import _build

    tc = _check_kernel_inputs(q, k, v, "fwd") == "tc"
    lib = (_build.load("flash_tc", FLASH_TC_ARGTYPES) if tc else
           _build.load("flash_fwd", {"flash_fwd": FLASH_FWD_ARGTYPES}))
    entry = "flash_fwd_tc" if tc else "flash_fwd"
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h == 0 or sq == 0:
        return o, lse
    # the launch (and its cudaFuncSetAttribute) must run in q's context
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, hd, KERNEL_DTYPES[q.dtype],
            ctypes.c_float(sm_scale), int(bool(causal)),
            int(causal_offset), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    if not tc:
        flash_attention_fwd.launches += 1
    elif q.dtype == torch.float16:
        flash_attention_fwd.launches_f16 += 1
    else:
        flash_attention_fwd.launches_tc += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        sm_scale: float | None = None,
                        causal_offset: int | None = None):
    """Flash-attention forward ``(o, lse)``, recording no autograd graph.

    A CUDA tensor goes through the kernel :func:`attention_route` names:
    in bf16 ``flash_fwd_tc`` (tensor cores; one launch counted in
    ``flash_attention_fwd.launches_tc``; in f16 in ``.launches_f16``),
    in f32 ``flash_fwd`` (CUDA cores; ``flash_attention_fwd.launches``).
    A CPU tensor goes through :func:`flash_attention_plain`. Any other
    device raises. A head dim other than 64, 128 and 256 (at most 256)
    is zero-padded to
    :func:`kernel_head_dim` for the kernel and ``o`` sliced back
    (:func:`with_padded_head`); ``sm_scale`` defaults to the true head
    dim's. Gradients go through :func:`flash_attention`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal_offset is None:
        causal_offset = k.shape[2] - q.shape[2]
    with torch.no_grad():
        if q.device.type == "cuda":
            return with_padded_head(_launch_kernel, (q, k, v),
                                    float(sm_scale), causal, causal_offset)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale,
                                         causal_offset=causal_offset)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_fwd.launches = 0       # f32, CUDA cores
flash_attention_fwd.launches_tc = 0    # bf16, tensor cores
flash_attention_fwd.launches_f16 = 0   # f16, tensor cores


# ---------------------------------------------------------------------------
# Flash-attention backward: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool,
                              sm_scale: float,
                              causal_offset: int | None = None,
                              delta=None):
    """Plain PyTorch version of the flash backward: ``(dq, dk, dv)`` in
    the inputs' dtypes.

    ``p = exp(q kᵀ · sm_scale − lse)`` is recomputed from the forward's
    row logsumexp (``p = 0`` on masked pairs and on rows with
    ``lse = +inf``), ``delta = rowsum(o · do)`` in f32 (or the ``(B, H,
    Sq)`` ``delta`` given) and
    ``ds = p ⊙ (do vᵀ − delta) · sm_scale``. As in the Pallas kernels,
    ``ds`` is rounded to the input dtype before ``dq = ds k`` and
    ``dk = dsᵀ q``, and ``p`` before ``dv = pᵀ do``; products accumulate
    in f32."""
    sq, sk = q.shape[2], k.shape[2]
    if causal_offset is None:
        causal_offset = sk - sq
    dt = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = ((o.float() * do32).sum(-1, keepdim=True) if delta is None
             else delta[..., None])
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


def _check_bwd_inputs(q, k, v, do, lse, delta, op: str) -> str:
    route = _check_kernel_inputs(q, k, v, op)
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
    return route


def _launch_bwd(op, outs, q, k, v, do, lse, delta, sm_scale, causal,
                causal_offset):
    """Run the ``op`` (``"dq"`` or ``"dkv"``) kernel that
    :func:`attention_route` names into ``outs`` and count the launch in
    ``flash_attention_bwd.launches_<op>_tc`` (tensor cores) or
    ``.launches_<op>`` (CUDA cores); empty work launches nothing, counts
    nothing and zeroes ``outs``."""
    from distributed_tensorflow_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_{op}: the kernel takes CUDA tensors, "
                         f"q is on {q.device}")
    route = _check_bwd_inputs(q, k, v, do, lse, delta, op)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    if b * h == 0 or sq == 0 or sk == 0:
        for t in outs:
            t.zero_()
        return
    if route == "tc":
        entry, lib = f"flash_bwd_{op}_tc", _build.load("flash_tc",
                                                        FLASH_TC_ARGTYPES)
    else:
        entry, lib = f"flash_bwd_{op}", _build.load("flash_bwd",
                                                     FLASH_BWD_ARGTYPES)
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
    counter = (f"launches_{op}" if route != "tc" else
               f"launches_{op}_f16" if q.dtype == torch.float16 else
               f"launches_{op}_tc")
    setattr(flash_attention_bwd, counter,
            getattr(flash_attention_bwd, counter) + 1)


def launch_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                  causal: bool, causal_offset: int):
    """``dq`` from one launch of the kernel :func:`attention_route` names
    (CUDA tensors; ``delta = rowsum(o · do)`` f32): in bf16
    ``flash_bwd_dq_tc`` (tensor cores, counted in
    ``flash_attention_bwd.launches_dq_tc``), in f32 ``flash_bwd_dq``
    (CUDA cores, ``flash_attention_bwd.launches_dq``); empty work
    launches nothing and counts nothing."""
    dq = torch.empty_like(q)
    _launch_bwd("dq", (dq,), q, k, v, do, lse, delta, sm_scale, causal,
                causal_offset)
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                   causal: bool, causal_offset: int):
    """``(dk, dv)`` from one launch of the kernel :func:`attention_route`
    names: in bf16 ``flash_bwd_dkv_tc`` (tensor cores, counted in
    ``flash_attention_bwd.launches_dkv_tc``), in f32 ``flash_bwd_dkv``
    (CUDA cores, ``flash_attention_bwd.launches_dkv``)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", (dk, dv), q, k, v, do, lse, delta, sm_scale, causal,
                causal_offset)
    return dk, dv


def _launch_bwd_pair(q, k, v, do, lse, delta, **kw):
    """``(dq, dk, dv)`` from the dq and the dk/dv kernel."""
    return (launch_bwd_dq(q, k, v, do, lse, delta, **kw),
            *launch_bwd_dkv(q, k, v, do, lse, delta, **kw))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        sm_scale: float | None = None,
                        causal_offset: int | None = None, delta=None):
    """Flash-attention backward ``(dq, dk, dv)`` from the forward's
    ``(o, lse)`` and the output cotangent ``do``. ``delta`` (f32 ``(B,
    H, Sq)``) is ``rowsum(o · do)`` computed once by a caller that runs
    many blocks against one ``(o, lse)`` (the ring's backward); without
    it, it is computed here.

    A CUDA tensor goes through the dq and the dk/dv kernels
    :func:`attention_route` names (counting one launch each in
    ``flash_attention_bwd.launches_dq_tc`` and ``.launches_dkv_tc`` in
    bf16, ``.launches_dq_f16`` and ``.launches_dkv_f16`` in f16,
    ``.launches_dq`` and ``.launches_dkv`` in f32); a CPU tensor
    through :func:`flash_attention_bwd_plain`. Any other device
    raises."""
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
            if delta is None:
                delta = (o.float() * do.float()).sum(-1)
            return with_padded_head(
                _launch_bwd_pair, (q, k, v, do), lse, delta,
                sm_scale=float(sm_scale), causal=causal,
                causal_offset=causal_offset)
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
                causal_offset=causal_offset, delta=delta)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


flash_attention_bwd.launches_dq = 0        # f32, CUDA cores
flash_attention_bwd.launches_dq_tc = 0     # bf16, tensor cores
flash_attention_bwd.launches_dkv = 0       # f32, CUDA cores
flash_attention_bwd.launches_dkv_tc = 0    # bf16, tensor cores
flash_attention_bwd.launches_dq_f16 = 0    # f16, tensor cores
flash_attention_bwd.launches_dkv_f16 = 0   # f16, tensor cores


@torch.library.custom_op("dtt_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, sm_scale: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention ``(o, lse)`` as one registered op: the body is
    :func:`flash_attention_fwd` (the kernels on a CUDA tensor, counted
    there; the plain version on a CPU tensor), the backward
    :func:`flash_attention_bwd` from the saved ``(q, k, v, o, lse)``, as
    ``_flash_mha``'s ``custom_vjp`` keeps ``lse`` among its residuals
    (JAX ``ops/attention.py:433-452``). ``lse`` takes no gradient.

    Selective activation checkpointing sees the call as the single op
    :data:`FLASH_ATTENTION_OP`: a policy that saves it keeps ``(o, lse)``
    and the recompute launches no forward kernel; the "attn" remat
    policies of ``models/transformer.py`` do so."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, sm_scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


def _flash_attention_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _flash_attention_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     causal=ctx.causal,
                                     sm_scale=ctx.sm_scale)
    return dq, dk, dv, None, None


flash_attention_op.register_autograd(_flash_attention_backward,
                                     setup_context=_flash_attention_setup)

#: the op as selective checkpointing's policy functions see it
FLASH_ATTENTION_OP = torch.ops.dtt_torch.flash_attention.default


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None):
    """Fused attention. ``(b, h, s, d)`` in, ``(b, h, s, d)`` out;
    differentiable in ``q``, ``k`` and ``v`` through
    :func:`flash_attention_op`. A tensor on another device than a CUDA
    device or the CPU raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return flash_attention_op(q, k, v, causal, float(sm_scale))[0]


def sharded_flash_attention(q, k, v, mesh, *, n_heads: int,
                            causal: bool = False,
                            sm_scale: float | None = None):
    """:func:`flash_attention` on this rank's block of ``(B, H, S, hd)``
    operands sharded as :func:`~distributed_tensorflow_tpu_torch.
    cluster.topology.attention_shard_spec` says: batch over the data
    axes, heads over ``tp`` (JAX ``:475``). Attention is independent
    over batch and heads, so the registered op runs on the local block
    with no collective (#1 forward, #2/#3 backward, on the card). Raises
    unless ``q``, ``k`` and ``v`` are each such a block: ``n_heads / tp``
    heads."""
    from distributed_tensorflow_tpu_torch.cluster.topology import (
        attention_shard_spec, mesh_shape)
    head_axis = attention_shard_spec(mesh)[1]
    tp = mesh_shape(mesh)[head_axis] if head_axis else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4 or t.shape[1] * tp != n_heads:
            raise ValueError(
                f"sharded_flash_attention: {name} {tuple(t.shape)} is not "
                f"a (B, {n_heads}/{tp}, S, hd) block of {n_heads} heads "
                f"over tp={tp}")
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)

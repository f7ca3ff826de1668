"""Fused vocab-tiled cross-entropy against a tied embedding.

Port of ``distributed_tensorflow_tpu/ops/fused_ce.py``. Per-token losses of
``hidden @ embed.T`` against ``targets`` without the ``(N, V)`` logits in
device memory:

- :func:`ce_reference` — the unfused semantics contract.
- :func:`fused_ce_fwd` — ``(lse, tl)``, the row logsumexp and the target
  logit. On a CUDA tensor it launches the port of the Pallas
  ``_fwd_kernel``: in bf16 ``fused_ce_fwd_tc`` of ``csrc/fused_ce_tc.cu``
  (tensor cores), in f32 ``fused_ce_fwd`` of ``csrc/fused_ce.cu`` (CUDA
  cores); on a CPU tensor it runs :func:`fused_ce_fwd_plain`.
- :func:`fused_ce_bwd` — ``(dh, dE)`` from the saved ``lse`` and the
  per-row cotangent ``g``, by one of three variants. On a CUDA tensor it
  launches: for ``"b"`` (the port of the merged backward
  ``_bwd_merged_b_kernel``) in bf16 ``fused_ce_bwd_tc`` of
  ``csrc/fused_ce_tc.cu`` (tensor cores), in f32 ``fused_ce_bwd`` of
  ``csrc/fused_ce.cu``; for ``"split"`` (``_dh_kernel``, ``_de_kernel``)
  in bf16 ``fused_ce_dh_tc`` then ``fused_ce_de_tc`` of
  ``csrc/fused_ce_tc.cu``, in f32 ``fused_ce_dh`` then ``fused_ce_de`` of
  ``csrc/fused_ce.cu``; for ``"a"`` (``_bwd_merged_kernel``) in bf16
  ``fused_ce_bwd_a_tc`` of ``csrc/fused_ce_tc.cu``, in f32
  ``fused_ce_bwd_a`` of ``csrc/fused_ce.cu``. :func:`kernel_route`
  states the rule; bf16 inputs whose d_model is no multiple of 8 are
  zero-padded for the tensor-core kernels (:func:`with_padded_d`). On a
  CPU tensor it runs :func:`fused_ce_bwd_plain`, or for ``"split"``
  :func:`fused_ce_dh_plain` and :func:`fused_ce_de_plain`.
- :func:`fused_cross_entropy` — the public op, differentiable in
  ``hidden`` and ``embed`` through :class:`FusedCrossEntropy`.
- :func:`sharded_fused_cross_entropy` — the op on a vocab sharded over
  a tensor-parallel group (:class:`ShardedFusedCrossEntropy`): the same
  kernels on each rank's vocab rows, targets another shard owns mapped
  to −1 (:func:`local_targets`), the per-shard ``(lse, tl)`` merged
  exactly (:func:`merge_vocab_shards`), and dh all-reduced over the
  group in the backward.

Any device other than CUDA and CPU raises, and so does a failed build or
launch: nothing falls back to the plain version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

#: input dtypes the CUDA kernels take (code passed to the C entry points)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest d_model the backward kernels take (each keeps a 32 x D f32
#: gradient accumulator on chip)
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
#: C signatures of ``csrc/fused_ce_tc.cu`` (bf16 only): pointers, then
#: N, V, D (and for the forward tiles per slice, slices), stream
CE_TC_ARGTYPES = {
    "fused_ce_fwd_tc": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    **{name: [ctypes.c_void_p] * n + [ctypes.c_int] * 3 + [ctypes.c_void_p]
       for name, n in (("fused_ce_bwd_tc", 7), ("fused_ce_dh_tc", 6),
                       ("fused_ce_de_tc", 6), ("fused_ce_bwd_a_tc", 7))}}
#: the tensor-core kernels stage 16-byte rows: bf16 d_model is zero-padded
#: to a multiple of this many columns
TC_D_MULTIPLE = 8
#: token rows of a tile of ``fused_ce_bwd_a_tc``, which adds all of a
#: tile's rows into its dh accumulator (zeros past N)
TC_A_TOKEN_TILE = 64
#: token rows and vocab rows of a tile of ``fused_ce_fwd_tc``
TC_FWD_TILE = 128
#: (m, l) partials a row gets from each vocab slice of the forward
TC_FWD_PARTS = 2
#: blocks of the forward that fit an SM at once
TC_FWD_BLOCKS_PER_SM = 2


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


def fwd_vocab_split(n: int, v: int, sm_count: int) -> tuple[int, int]:
    """``(tiles_per_slice, slices)`` of ``fused_ce_fwd_tc`` for N rows and
    V vocab rows: the 128-row vocab tiles go to as many slices as let
    ``ceil(N / 128)`` row tiles times the slices fill the card's
    ``sm_count`` SMs at two blocks each, in one wave; every slice holds at
    least one tile."""
    row_tiles = math.ceil(n / TC_FWD_TILE)
    vocab_tiles = math.ceil(v / TC_FWD_TILE)
    slices = min(vocab_tiles, max(
        1, TC_FWD_BLOCKS_PER_SM * sm_count // row_tiles))
    per = math.ceil(vocab_tiles / slices)
    return per, math.ceil(vocab_tiles / per)


def fwd_partials_plain(hidden, embed, targets, bounds):
    """Plain version of the forward's per-slice partials: for vocab slices
    ``[bounds[s], bounds[s + 1])`` (columns at or past V masked), each
    row's ``(m, l)`` = (max, sum of exp(logit − max)) over the slice,
    ``(S, N)`` f32 — ``(-inf, 0)`` for a slice that holds no column —
    and the target logit ``tl`` ``(N,)``, 0 for a target outside
    ``[0, V)``."""
    logits = _logits(hidden, embed)
    v = embed.shape[0]
    ms, ls = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = logits[:, min(lo, v):min(hi, v)]
        if part.shape[1] == 0:
            ms.append(torch.full((logits.shape[0],), -math.inf))
            ls.append(torch.zeros(logits.shape[0]))
            continue
        m = part.max(dim=1).values
        ms.append(m)
        ls.append(torch.exp(part - m[:, None]).sum(dim=1))
    return (torch.stack(ms), torch.stack(ls),
            fused_ce_fwd_plain(hidden, embed, targets)[1])


def merge_partials_plain(m, l):
    """Plain version of ``fused_ce_lse_merge_kernel``: each row's lse from
    its ``(P, N)`` partials ``(m, l)``, folded in partial order; a partial
    with ``l = 0`` (it saw no column) adds nothing."""
    mx = m.max(dim=0).values
    w = torch.where(l > 0, l * torch.exp(m - mx), torch.zeros_like(l))
    return mx + torch.log(w.sum(dim=0))


def dh_from_fragment_order(acc, n: int, d: int, dtype):
    """The ``(n, d)`` dh, cast to ``dtype``, from the flat f32 accumulator
    of ``fused_ce_bwd_a_tc``, which keeps it in the order of its
    ``mma.sync`` fragments so that a warp's float4 adds cover 512
    contiguous bytes: the 16 x 8 tile of rows ``16 s`` and columns ``8 c``
    lies at ``((s d / 8 + c) 32 + l) 4``, lane ``l = 4 (r % 8) + 2 qh +
    (r % 16) // 8`` holding row ``r``, columns ``8 c + 4 qh`` to ``+ 3``
    (``acc`` holds a multiple of 16 rows, those past ``n`` dropped). One
    copy reads it through a permuted view and casts it."""
    rows = acc.numel() // d
    out = torch.empty((rows, d), dtype=dtype, device=acc.device)
    out.view(rows // 16, 2, 8, d // 8, 2, 4).copy_(
        acc.view(rows // 16, d // 8, 8, 2, 2, 4).permute(0, 4, 2, 1, 3, 5))
    return out[:n]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def kernel_route(dtype, d: int, op: str) -> str:
    """Which kernel a CUDA call takes: ``"tensor_core"`` (``csrc/
    fused_ce_tc.cu``) or ``"cuda_core"`` (``csrc/fused_ce.cu``), for
    inputs of ``dtype`` and d_model ``d`` and ``op`` — ``"fwd"`` or a
    backward variant (``"b"``, ``"a"``, ``"split"``).

    - bf16 goes to the tensor cores, every op. Their kernels stage
      16-byte rows, so :func:`fused_ce_fwd` and :func:`fused_ce_bwd`
      zero-pad a ``d`` that is no multiple of 8 to the next one
      (:func:`with_padded_d`), which is exact;
    - f32 stays on the CUDA cores, whose f32 products keep f32 parity
      (on tensor cores f32 would be TF32), and takes any ``d``;
    - every backward keeps a ``32 x d`` f32 gradient on chip: ``d`` at
      most :data:`KERNEL_MAX_D`, else ValueError; any other dtype raises
      ValueError too."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_ce: no kernel for dtype {dtype}")
    if op not in ("fwd", *BWD_VARIANTS):
        raise ValueError(f"fused_ce: op={op!r}; expected 'fwd' or one of "
                         f"{BWD_VARIANTS}")
    if op != "fwd" and d > KERNEL_MAX_D:
        raise ValueError(f"fused_ce_bwd: d_model {d} > {KERNEL_MAX_D}, the "
                         f"widest the kernel takes")
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def with_padded_d(fn, hidden, embed, *args):
    """``fn(hidden, embed, *args)`` with d_model zero-padded to the next
    multiple of :data:`TC_D_MULTIPLE`, its 2-D outputs (dh, dE) sliced
    back to D. Exact: the zero columns add exact zeros to every logit,
    and their gradient columns are dropped. Without padding to do, ``fn``
    runs on the inputs as they are."""
    d = hidden.shape[1]
    pad = -d % TC_D_MULTIPLE
    if not pad:
        return fn(hidden, embed, *args)
    out = fn(torch.nn.functional.pad(hidden, (0, pad)),
             torch.nn.functional.pad(embed, (0, pad)), *args)
    return tuple(x[:, :d].contiguous() if x.ndim == 2 else x for x in out)


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


def _launch(entry, device, *args, source="fused_ce"):
    """Run C entry point ``entry`` of ``csrc/<source>.cu`` on ``device``'s
    current stream; raise if the launch failed."""
    from distributed_tensorflow_tpu_torch.ops import _build
    lib = _build.load(source, CE_TC_ARGTYPES if source == "fused_ce_tc"
                      else CE_ARGTYPES)
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

    A CUDA tensor goes through the kernel :func:`kernel_route` names: in
    bf16 ``fused_ce_fwd_tc`` (tensor cores, d_model zero-padded to a
    multiple of 8; its forward and the merge of its vocab slices counted
    as one launch in ``fused_ce_fwd.launches_tc``), in f32
    ``fused_ce_fwd`` (CUDA cores; ``fused_ce_fwd.launches``). A CPU
    tensor goes through :func:`fused_ce_fwd_plain`; any other device
    raises."""
    with torch.no_grad():
        if hidden.device.type == "cpu":
            return fused_ce_fwd_plain(hidden, embed, targets)
        if hidden.device.type != "cuda":
            raise ValueError(f"fused_ce: no kernel for device "
                             f"{hidden.device}")
        _check_kernel_inputs(hidden, embed, targets)
        n, d = hidden.shape
        v = embed.shape[0]
        route = kernel_route(hidden.dtype, d, "fwd")
        lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
        if n == 0:
            return lse, torch.empty_like(lse)
        t = targets.to(torch.int32).contiguous()
        if route == "cuda_core":
            tl = torch.empty_like(lse)
            _launch("fused_ce_fwd", hidden.device, hidden.data_ptr(),
                    embed.data_ptr(), t.data_ptr(), lse.data_ptr(),
                    tl.data_ptr(), n, v, d, KERNEL_DTYPES[hidden.dtype])
            fused_ce_fwd.launches += 1
            return lse, tl
        return with_padded_d(_fwd_tc, hidden, embed, t, lse)


def _fwd_tc(hidden, embed, t, lse):
    """``fused_ce_fwd_tc`` into ``lse``; D a multiple of 8."""
    n, d = hidden.shape
    v = embed.shape[0]
    per, slices = fwd_vocab_split(n, v, torch.cuda.get_device_properties(
        hidden.device).multi_processor_count)
    tl = torch.zeros_like(lse)   # written only where a target lies
    part = torch.empty((2, TC_FWD_PARTS * slices, n), dtype=torch.float32,
                       device=hidden.device)
    _launch("fused_ce_fwd_tc", hidden.device, hidden.data_ptr(),
            embed.data_ptr(), t.data_ptr(), lse.data_ptr(), tl.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), n, v, d, per, slices,
            source="fused_ce_tc")
    fused_ce_fwd.launches_tc += 1
    return lse, tl


fused_ce_fwd.launches = 0       # f32, CUDA cores
fused_ce_fwd.launches_tc = 0    # bf16, tensor cores


def fused_ce_bwd(hidden, embed, targets, lse, g, *, variant: str = "b"):
    """``(dh, dE)`` of the per-token losses against the cotangent ``g``
    (``(N,)`` f32), from the forward's ``lse``.

    A CUDA tensor goes through the kernels of ``variant`` (the rule:
    :func:`kernel_route`; bf16 d_model zero-padded to a multiple of 8),
    each launch counted on this function:

    - ``"b"`` in bf16: ``fused_ce_bwd_tc`` (``.launches_tc``, one for its
      two passes), on tensor cores: a dh pass over token tiles, then a
      dE pass over vocab tiles, each gradient on chip and written once,
      no atomics;
    - ``"b"`` in f32: ``fused_ce_bwd`` (``.launches``) adds dE into an
      f32 ``(V, D)`` accumulator with atomics and keeps dh on chip;
    - ``"a"`` in bf16: ``fused_ce_bwd_a_tc`` (``.launches_a_tc``), on
      tensor cores, one pass: dE on chip and written once, dh added into
      an f32 ``(N, D)`` accumulator with atomics;
    - ``"a"`` in f32: ``fused_ce_bwd_a`` (``.launches_a``), the same
      split of the gradients on the CUDA cores;
    - ``"split"`` in bf16: ``fused_ce_dh_tc`` (``.launches_dh_tc``) then
      ``fused_ce_de_tc`` (``.launches_de_tc``), on tensor cores: the two
      passes of ``fused_ce_bwd_tc``, launched one at a time;
    - ``"split"`` in f32: ``fused_ce_dh`` (``.launches_dh``) then
      ``fused_ce_de`` (``.launches_de``); each split pass keeps its
      gradient on chip, no atomics: the same dE on every run.

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
        route = kernel_route(hidden.dtype, d, variant)
        if n == 0:
            return torch.empty_like(hidden), torch.zeros_like(embed)
        lse = _row_vector(lse, n, "lse", hidden.device)
        g = _row_vector(g, n, "g", hidden.device)
        t = targets.to(torch.int32).contiguous()
        if route == "tensor_core":
            return with_padded_d(_bwd_tc, hidden, embed, t, lse, g, variant)
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


def _bwd_tc(hidden, embed, t, lse, g, variant):
    """The bf16 tensor-core kernels of ``variant``; D a multiple of 8."""
    n, d = hidden.shape
    v = embed.shape[0]
    args = (hidden.data_ptr(), embed.data_ptr(), t.data_ptr(),
            lse.data_ptr(), g.data_ptr())
    dev = hidden.device
    if variant == "a":
        rows = -(-n // TC_A_TOKEN_TILE) * TC_A_TOKEN_TILE
        dh_acc = torch.zeros(rows * d, dtype=torch.float32, device=dev)
        de = torch.empty_like(embed)
        _launch("fused_ce_bwd_a_tc", dev, *args, dh_acc.data_ptr(),
                de.data_ptr(), n, v, d, source="fused_ce_tc")
        fused_ce_bwd.launches_a_tc += 1
        return dh_from_fragment_order(dh_acc, n, d, hidden.dtype), de
    dh, de = torch.empty_like(hidden), torch.empty_like(embed)
    if variant == "b":
        _launch("fused_ce_bwd_tc", dev, *args, dh.data_ptr(), de.data_ptr(),
                n, v, d, source="fused_ce_tc")
        fused_ce_bwd.launches_tc += 1
        return dh, de
    _launch("fused_ce_dh_tc", dev, *args, dh.data_ptr(), n, v, d,
            source="fused_ce_tc")
    fused_ce_bwd.launches_dh_tc += 1
    _launch("fused_ce_de_tc", dev, *args, de.data_ptr(), n, v, d,
            source="fused_ce_tc")
    fused_ce_bwd.launches_de_tc += 1
    return dh, de


fused_ce_bwd.launches = 0       # "b", #7, f32 (CUDA cores)
fused_ce_bwd.launches_tc = 0    # "b", #7, bf16 (tensor cores)
fused_ce_bwd.launches_a = 0     # "a", #6, f32 (CUDA cores)
fused_ce_bwd.launches_a_tc = 0  # "a", #6, bf16 (tensor cores)
fused_ce_bwd.launches_dh = 0    # "split", #5, f32 (CUDA cores)
fused_ce_bwd.launches_de = 0    # "split", #8, f32 (CUDA cores)
fused_ce_bwd.launches_dh_tc = 0    # "split", #5, bf16 (tensor cores)
fused_ce_bwd.launches_de_tc = 0    # "split", #8, bf16 (tensor cores)


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


# ---------------------------------------------------------------------------
# Vocab sharded over a tensor-parallel group (JAX :578-739)
# ---------------------------------------------------------------------------

def local_targets(targets, rows: int, rank: int):
    """Global target ids in the row space of vocab shard ``rank`` of
    ``rows`` rows (JAX ``_local_targets``, ``:578``): ids another shard
    owns become −1, which matches no column, so they add 0 to this
    shard's target logit and its one-hot correction."""
    t = targets.long() - rank * rows
    return torch.where((t >= 0) & (t < rows), t, torch.full_like(t, -1))


def merge_vocab_shards(lse, tl):
    """The row ``(lse, tl)`` of the whole vocabulary from per-shard
    ``(lse, tl)`` stacked ``(tp, N)``, in shard order (JAX ``:623-625``):
    ``m = max lse``, ``lse = m + log Σ exp(lse − m)``, ``tl = Σ tl`` (one
    shard owns each target, the others hold 0). Pure: the distributed op
    runs it on the gathered stacks, so every rank gets the same bits."""
    m = lse.max(dim=0).values
    return m + torch.log(torch.exp(lse - m).sum(dim=0)), tl.sum(dim=0)


def _gather_rows(x, group):
    """``(N,)`` from every rank of ``group`` → ``(size, N)``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(n, x.shape[0])


class ShardedFusedCrossEntropy(torch.autograd.Function):
    """Per-token losses over a vocab sharded on a tensor-parallel group
    (JAX ``_sharded_ce``, ``:588-680``). ``embed`` is this rank's
    ``(V/tp, D)`` rows, ``hidden`` and ``targets`` every rank's same
    tokens. Forward: :func:`fused_ce_fwd` on the local rows against
    :func:`local_targets`, the per-shard ``(lse, tl)`` all-gathered and
    merged by :func:`merge_vocab_shards`. Backward: :func:`fused_ce_bwd`
    on the local rows with the merged lse, dh summed over the group in
    f32 (JAX ``:663-665``); dE stays this shard's. That all-reduce is
    the only tp reduction of the loss's input, so no copy op may stand
    on ``hidden`` before this op."""

    @staticmethod
    def forward(ctx, hidden, embed, targets, group, rank, variant):
        t = local_targets(targets, embed.shape[0], rank)
        lse, tl = fused_ce_fwd(hidden, embed, t)
        lse, tl = merge_vocab_shards(_gather_rows(lse, group),
                                     _gather_rows(tl, group))
        ctx.save_for_backward(hidden, embed, t, lse)
        ctx.group, ctx.variant = group, variant
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        hidden, embed, t, lse = ctx.saved_tensors
        dh, de = fused_ce_bwd(hidden, embed, t, lse, g.float().contiguous(),
                              variant=ctx.variant)
        dh = dh.float()
        dist.all_reduce(dh, group=ctx.group)
        return dh.to(hidden.dtype), de, None, None, None, None


def sharded_fused_cross_entropy(hidden, embed, targets, tp, *,
                                bwd_variant: str = "b"):
    """:func:`fused_cross_entropy` with ``embed`` this rank's vocab shard
    on ``tp`` (a :class:`~distributed_tensorflow_tpu_torch.parallel.
    tensor_parallel.TensorParallel`: ``group``, ``rank``): per-token
    losses ``(N,)`` f32 of the whole vocabulary, the same on every rank
    of the group (JAX ``sharded_fused_cross_entropy``, ``:683``). Rows
    are cut into chunks of 4096 as there; each chunk merges its own
    forward."""
    if bwd_variant not in BWD_VARIANTS:
        raise ValueError(f"sharded_fused_cross_entropy: bwd_variant="
                         f"{bwd_variant!r}; expected one of {BWD_VARIANTS}")
    n = hidden.shape[0]
    step = n if (n <= ROW_CHUNK or n % ROW_CHUNK) else ROW_CHUNK
    return torch.cat([
        ShardedFusedCrossEntropy.apply(hidden[i:i + step], embed,
                                       targets[i:i + step], tp.group,
                                       tp.rank, bwd_variant)
        for i in range(0, n, step)])

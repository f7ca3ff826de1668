"""Tensor Tracer: numerics inspection of a program's tensors — port of
``distributed_tensorflow_tpu/utils/tensor_tracer.py``.

≙ tensorflow/python/tpu/tensor_tracer.py (+ flags + report): the
reference instruments every op of a TPU graph and streams per-tensor
statistics (norm / max / min / NaN counts) to a trace report, to find
silent numerical corruption on the device.

Three instruments, as in the JAX package:

- :func:`trace_point` — an explicit marker. Its statistics are computed
  ON THE TENSOR'S DEVICE (a few reductions, queued behind the op that
  made the tensor) and nothing synchronises per point: the host reads
  every pending point at once when the :class:`TensorTracer` closes or
  reports (JAX's ``effects_barrier``).
- :func:`trace_flax` — zero-annotation capture of an ``nn.Module``:
  forward hooks on every submodule reduce each call's output to the same
  statistics, named by flax's module paths where the port's modules
  mirror flax's (``layer_{i}`` for the transformer's blocks,
  ``RMSNorm_0``, ``attn``, ...) and ordered as JAX orders them: by
  SORTED path, so ``layer_10`` comes before ``layer_2`` and the root's
  own output (``__call__``) before every submodule's.
- :func:`instrument` / :func:`trace_fn` — WHOLE-PROGRAM instrumentation
  of any function (≙ the reference's per-op graph rewrite): a
  ``TorchDispatchMode`` attaches the statistics to every op's numeric
  outputs, each entry named by op and source line, filterable by
  ``op_regex`` / ``name_regex`` (≙ --included_ops). Factory ops
  (``empty``, ``zeros``, ``arange``, ...: no tensor input, or
  ``empty_like``) are not traced: an ``empty`` allocation's memory is
  uninitialised and would read as NaN. The port's CUDA kernels are
  bound with ctypes, so a dispatch mode does not see their launches:
  a kernel is traced at its registered op (``dtt_torch::
  flash_attention``: its ``(o, lse)``) or at the ops that read its
  wrapper's output.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
import threading
from typing import Any, Callable

import torch

_FLOAT_STATS = ("norm", "max", "min", "mean")
_COUNT_STATS = ("nan_count", "inf_count")


def _stats(x: torch.Tensor) -> tuple:
    """The per-tensor statistic bundle (≙ trace_mode=summary), on the
    tensor's device and unread: ``(floats (4,) f32, counts (2,)
    int64)``."""
    xf = x.detach().to(torch.float32)
    if xf.numel():
        floats = torch.stack([torch.linalg.vector_norm(xf.reshape(-1)),
                              xf.max(), xf.min(), xf.mean()])
    else:
        floats = torch.zeros(4, dtype=torch.float32, device=xf.device)
    counts = torch.stack([torch.isnan(xf).sum(), torch.isinf(xf).sum()])
    return floats, counts


def _bulk(pending: list, i: int) -> list:
    """Item ``i`` of every pending point as a host list: one
    ``torch.stack`` and one copy a device, not one sync a point."""
    by_dev: dict = {}
    for k, p in enumerate(pending):
        by_dev.setdefault(p[i].device, []).append(k)
    out = [None] * len(pending)
    for ks in by_dev.values():
        host = torch.stack([pending[k][i] for k in ks]).cpu().tolist()
        for k, row in zip(ks, host):
            out[k] = row
    return out


def _read(pending: list) -> list:
    """``[(name, floats, counts, iteration)]`` on the device → ``[(name,
    {stat: number})]`` on the host."""
    if not pending:
        return []
    out = []
    for (name, _, _, iteration), f, c in zip(pending, _bulk(pending, 1),
                                             _bulk(pending, 2)):
        stats = dict(zip(_FLOAT_STATS, f))
        stats.update(zip(_COUNT_STATS, c))
        if iteration is not None:
            stats["iteration"] = int(iteration)
        out.append((name, stats))
    return out


class _Collector:
    """Process-global (NOT thread-local: points may be recorded on
    worker threads, not the thread that entered the tracer)."""

    def __init__(self):
        self.events: list[tuple[str, dict]] = []
        self.pending: list = []
        self.active = False
        self.lock = threading.Lock()

    def drain(self):
        """Read every pending point to the host (under ``lock``)."""
        self.events.extend(_read(self.pending))
        self.pending = []


_COLLECTOR = _Collector()


def trace_point(name: str, x, *, enabled: bool | None = None,
                iteration=None):
    """Record numerics stats for ``x`` under ``name``; returns ``x``
    unchanged. No-op unless inside a :class:`TensorTracer` context (or
    ``enabled=True`` — then collected only inside a tracer, as JAX
    bakes the point in and gates collection at call time).

    ``iteration``: an optional loop counter, carried as an
    ``iteration`` stat so one traced loop body reports every trip."""
    if enabled is None:
        enabled = _COLLECTOR.active
    if not enabled or not _COLLECTOR.active:
        return x
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    floats, counts = _stats(t)
    with _COLLECTOR.lock:
        if _COLLECTOR.active:
            _COLLECTOR.pending.append((name, floats, counts, iteration))
    return x


@dataclasses.dataclass
class TraceReport:
    """Per-tensor statistics table (≙ tensor_tracer_report.py)."""
    entries: list  # [(name, {stat: float})]

    def nan_entries(self) -> list:
        return [(n, s) for n, s in self.entries
                if s.get("nan_count", 0) > 0 or s.get("inf_count", 0) > 0]

    def first_nan(self) -> "str | None":
        bad = self.nan_entries()
        if not bad:
            return None
        name, stats = bad[0]
        if "iteration" in stats:
            return f"{name} [iteration {int(stats['iteration'])}]"
        return name

    def __str__(self):
        lines = [f"{'tensor':50s} {'norm':>12s} {'max':>12s} "
                 f"{'nan':>6s} {'inf':>6s}"]
        for name, s in self.entries:
            lines.append(
                f"{name[:50]:50s} {s['norm']:12.4e} {s['max']:12.4e} "
                f"{int(s['nan_count']):6d} {int(s['inf_count']):6d}")
        return "\n".join(lines)

    def write(self, path: str) -> str:
        """Write the per-tensor table to ``path`` (≙ the reference's
        trace report file, tensor_tracer_report.py ``create_report``)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(str(self) + "\n")
            bad = self.first_nan()
            f.write(f"\nfirst_nan: {bad}\n" if bad
                    else "\nfirst_nan: none\n")
        return path


class TensorTracer:
    """Collects :func:`trace_point` events (≙ the tensor_tracer session).

        tt = TensorTracer()
        with tt:
            step(state, batch)     # code containing trace_point
        print(tt.report())
    """

    def __enter__(self):
        with _COLLECTOR.lock:
            _COLLECTOR.events = []
            _COLLECTOR.pending = []
            _COLLECTOR.active = True
        return self

    def __exit__(self, *exc):
        # the points' stats are queued on the device: read them BEFORE
        # deactivating or they would be dropped
        with _COLLECTOR.lock:
            _COLLECTOR.drain()
            _COLLECTOR.active = False
        return False

    def report(self) -> TraceReport:
        with _COLLECTOR.lock:
            _COLLECTOR.drain()
            return TraceReport(list(_COLLECTOR.events))


# ---------------------------------------------------------------------------
# Module capture (≙ trace_flax over flax's capture_intermediates)
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"(^|\.)layers\.(\d+)(?=\.|$)")
_LIST_RE = re.compile(r"(\w+)\.(\d+)(?=\.|$)")


def flax_path(name: str) -> str:
    """A ``named_modules`` path as flax names the module: the
    transformer's ``layers.<i>`` is its ``layer_<i>``
    (``models/transformer.py:436`` of the JAX package), any other list
    item ``<list>.<i>`` flax's auto-name ``<list>_<i>``, and ``.``
    becomes ``/``."""
    name = _LAYER_RE.sub(r"\1layer_\2", name)
    name = _LIST_RE.sub(r"\1_\2", name)
    return name.replace(".", "/")


def trace_flax(module: torch.nn.Module, *args,
               **kwargs) -> tuple[Any, TraceReport]:
    """Run ``module(*args, **kwargs)`` capturing EVERY submodule call's
    output numerics (≙ full-graph tracing, trace_mode=summary). Returns
    ``(outputs, TraceReport)``, one entry per module call site, named and
    ordered as the JAX package's ``trace_flax`` names and orders flax's
    intermediates: ``<path>/__call__``, sorted by path, a tuple output's
    items as ``[i]``. A module whose flax counterpart returns another
    structure than its forward (the transformer ``Block``'s ``(x,
    None)``) gives it by a ``flax_output(out)`` static method. The
    module holds its weights, so there is no ``variables`` argument."""
    captured: dict = {}
    hooks = []
    for name, mod in module.named_modules():
        def hook(m, inp, out, _path=flax_path(name)):
            conv = getattr(type(m), "flax_output", None)
            captured.setdefault(_path, []).append(
                conv(out) if conv is not None else out)
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            out = module(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    inter: dict = {}
    for path, outs in captured.items():
        node = inter
        for part in (path.split("/") if path else []):
            node = node.setdefault(part, {})
        node["__call__"] = tuple(outs)

    pending = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}[{i}]" if len(tree) > 1 else prefix)
        elif isinstance(tree, torch.Tensor):
            pending.append((prefix, *_stats(tree), None))

    walk(inter, "")
    entries = [(n, {k: float(v) for k, v in s.items()})
               for n, s in _read(pending)]
    return out, TraceReport(entries)


def find_first_nan(module: torch.nn.Module, *args, **kwargs
                   ) -> "str | None":
    """The first module call site producing NaN/Inf, in
    :func:`trace_flax`'s order (the reference's headline debugging
    use)."""
    _, report = trace_flax(module, *args, **kwargs)
    return report.first_nan()


# ---------------------------------------------------------------------------
# Whole-program instrumentation (≙ tensor_tracer.py's per-op rewrite)
# ---------------------------------------------------------------------------

#: factory ops whose output is uninitialised memory even with a tensor
#: input (the ops with no tensor input are recognised by their schema)
_UNINITIALISED = {"empty_like", "new_empty", "new_empty_strided",
                  "empty_permuted", "empty_strided", "empty"}
_HERE = os.path.abspath(__file__)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _is_factory(func) -> bool:
    return (func.overloadpacket.__name__ in _UNINITIALISED
            or not any("Tensor" in str(a.type)
                       for a in func._schema.arguments))


def _numeric(t) -> bool:
    """A tensor of a number type (≙ JAX's ``np.number`` avals: not
    bool)."""
    return isinstance(t, torch.Tensor) and t.dtype != torch.bool


def _source() -> str:
    """``file:line (function)`` of the innermost frame outside torch and
    this module: the line of the program that issued the op."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if not (path.startswith(_TORCH_DIR) or path == _HERE
                or path.startswith("<")):
            return (f"{os.path.basename(path)}:{f.f_lineno} "
                    f"({f.f_code.co_name})")
        f = f.f_back
    return "?"


def instrument(fn: Callable, *, op_regex: "str | None" = None,
               name_regex: "str | None" = None,
               max_traced: "int | None" = None) -> Callable:
    """Wrap ``fn`` so EVERY intermediate tensor is traced — no model
    annotations needed (≙ the reference instrumenting every op of the
    compiled program, tensor_tracer.py:1431).

    The wrapper runs ``fn`` under a ``TorchDispatchMode`` that attaches
    the on-device statistics (:func:`trace_point`) to each numeric
    output of each op, named ``"<index> <op>[.<output>] <file>:<line>
    (<function>)"``; the index counts every numeric output, filtered or
    not, as JAX's counts every equation's. Run the result under a
    :class:`TensorTracer` context to collect. ``op_regex`` filters by op
    name (``mm``, ``add``, ``flash_attention``; ≙ --included_ops),
    ``name_regex`` by the whole entry name, ``max_traced`` caps the
    number of traced outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    op_re = re.compile(op_regex) if op_regex else None
    name_re = re.compile(name_regex) if name_regex else None

    class _Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0
            self.traced = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if _is_factory(func):
                return out
            outs = out if isinstance(out, (tuple, list)) else (out,)
            op = func.overloadpacket.__name__
            src = None
            for j, t in enumerate(outs):
                if not _numeric(t):
                    continue
                idx = self.n
                self.n += 1
                tag = "" if len(outs) == 1 else f".{j}"
                if src is None:
                    src = _source()
                name = f"{idx:04d} {op}{tag} {src}"
                if op_re and not op_re.search(op):
                    continue
                if name_re and not name_re.search(name):
                    continue
                if max_traced is not None and self.traced >= max_traced:
                    continue
                self.traced += 1
                trace_point(name, t, enabled=True)
            return out

    def wrapped(*args, **kwargs):
        with _Mode():
            return fn(*args, **kwargs)

    return wrapped


def trace_fn(fn: Callable, *args, report_path: "str | None" = None,
             op_regex: "str | None" = None,
             name_regex: "str | None" = None,
             max_traced: "int | None" = None, **kwargs):
    """One-shot whole-program trace: run ``fn(*args, **kwargs)`` fully
    instrumented, return ``(outputs, TraceReport)`` and optionally write
    the report file (≙ tensor_tracer_report.py's on-disk report).

        out, report = trace_fn(loss_fn, model, batch,
                               report_path="/tmp/tt/report.txt")
        report.first_nan()   # "0042 mm model.py:<line> (forward)" or None
    """
    inst = instrument(fn, op_regex=op_regex, name_regex=name_regex,
                      max_traced=max_traced)
    tt = TensorTracer()
    with tt:
        out = inst(*args, **kwargs)
    report = tt.report()
    if report_path is not None:
        report.write(report_path)
    return out, report

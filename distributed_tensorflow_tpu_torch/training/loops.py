"""Step loops and infeed-style data staging — port of
``distributed_tensorflow_tpu/training/loops.py``.

JAX keeps N steps inside one compiled program (``lax.fori_loop``,
``lax.while_loop``, ``lax.scan``). The port's steps run eagerly, so
:func:`repeat`, :func:`while_loop` and :func:`run_steps` are host loops
with the same signatures and results (``run_steps`` stacks the per-step
metrics as ``lax.scan`` does), and :func:`stack_batches` stacks same-
shaped batches. :class:`StepTelemetry` (with :data:`STEP_PHASES`) feeds
the same instruments and ``train.step`` events as JAX's;
:class:`InfeedLoop` stages batches on a background thread and times
the step loop's waits (``training/infeed_wait``). The ``stall_detector``
argument is duck-typed (anything with ``step_completed(step=,
dur_s=)``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Iterable, Iterator

import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.utils import profiler
from distributed_tensorflow_tpu_torch.utils import tree


def repeat(n: int, body_fn: Callable, inputs):
    """``body_fn(state) -> state`` ``n`` times."""
    state = inputs
    for _ in range(n):
        state = body_fn(state)
    return state


def while_loop(condition_fn: Callable, body_fn: Callable, inputs):
    """``body_fn`` while ``condition_fn(state)`` holds."""
    state = inputs
    while bool(condition_fn(state)):
        state = body_fn(state)
    return state


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return torch.stack([torch.as_tensor(x) for x in xs])


def run_steps(step_fn: Callable, state, batches):
    """``step_fn(state, batch) -> (state, metrics)`` over the leading
    axis of ``batches`` (a nest of stacked batches); returns ``(state,
    stacked metrics)``, as ``lax.scan``."""
    leaves, td = tree.tree_flatten(batches)
    n = leaves[0].shape[0] if leaves else 0
    outs = []
    for i in range(n):
        state, metrics = step_fn(
            state, tree.tree_unflatten(td, [x[i] for x in leaves]))
        outs.append(metrics)
    if not outs:
        return state, None
    return state, tree.tree_map(_stack, outs[0], *outs[1:])


def stack_batches(batches: Iterable):
    """Same-shaped batches stacked into one nest (for
    :func:`run_steps`)."""
    batches = list(batches)
    if not batches:
        raise ValueError("no batches to stack")
    return tree.tree_map(_stack, batches[0], *batches[1:])


#: Step-phase names StepTelemetry accepts (seconds within one step):
#: host compute proper is whatever remains after the others.
#: - ``compute``    time in the compiled step's compute (measured or
#:   calibrated — see bench.py's phase breakdown)
#: - ``collective`` EXPOSED gradient-collective time (host-timed sync
#:   like the elastic worker's allgather, or calibrated residual)
#: - ``host``       host-side callback/bookkeeping time (Model.fit
#:   times its callback list here)
#: - ``ckpt_block`` step-loop time blocked on checkpoint capture/commit
STEP_PHASES = ("compute", "collective", "host", "ckpt_block")


class StepTelemetry:
    """Per-step telemetry for a host-driven step loop.

    One object per training run; call :meth:`step_completed` after each
    step. Feeds the unified instruments every export path reads —
    ``training/step_time`` (histogram percentiles), ``training/
    steps_completed`` (the counter fleet rollups and the stall detector
    key on), ``training/last_loss`` — emits a ``train.step`` event per
    step into the structured log (step time, infeed wait, loss), and
    re-arms an attached :class:`telemetry.StallDetector`.

        steps = StepTelemetry(infeed=loop, stall_detector=detector)
        for i in range(n):
            state, metrics = step_fn(state, loop.next())
            steps.step_completed(i, loss=metrics["loss"])

    **Phase attribution:** pass ``phases={"compute": s, "collective": s,
    ...}`` (keys from :data:`STEP_PHASES`) and optionally
    ``overlap_eff`` (fraction of collective time hidden behind the
    backward pass). Phases land as ``<name>_s`` fields on the
    ``train.step`` event — ``tools/obs_report.py`` renders the per-step
    phase table and names the bottleneck from them — and as
    ``training/phase/<name>_frac`` histograms plus a
    ``training/overlap_eff`` gauge in the registry, so fleet rollups
    (telemetry/aggregate.py) carry p50/p95 phase fractions and the
    mean/max overlap efficiency across workers.

    With telemetry off (no event log configured) the per-step cost is
    a few instrument updates; the event write is skipped.

    **Inference sharing:** ``event_name``/``metric_prefix`` re-point the
    same instrument set at another step loop — ``Model.predict`` uses
    ``StepTelemetry(event_name="predict.step",
    metric_prefix="inference")`` so batch prediction and the serving
    engine report into ONE ``inference/`` metric namespace
    (``inference/step_time`` is the batch-latency histogram; the
    serving engine's request instruments live alongside it).
    """

    def __init__(self, infeed: "InfeedLoop | None" = None,
                 stall_detector=None, reg=None,
                 event_name: str = "train.step",
                 metric_prefix: str = "training"):
        reg = reg or telemetry.get_registry()
        self._event_name = event_name
        self._timer = reg.histogram(f"{metric_prefix}/step_time",
                                    "host-observed step seconds")
        self._steps = reg.counter(f"{metric_prefix}/steps_completed")
        self._loss = reg.gauge(f"{metric_prefix}/last_loss")
        self._phase_hists = {
            name: reg.histogram(f"{metric_prefix}/phase/{name}_frac",
                                f"per-step {name} share of step time")
            for name in STEP_PHASES}
        self._overlap = reg.gauge(
            f"{metric_prefix}/overlap_eff",
            "fraction of collective time hidden behind backward")
        self._infeed = infeed
        self._stall = stall_detector
        self._last_t = time.monotonic()
        self._last_wait = 0.0

    def step_completed(self, step=None, loss=None,
                       dur_s: float | None = None,
                       phases: "dict[str, float] | None" = None,
                       overlap_eff: float | None = None,
                       **extra_fields):
        """``extra_fields`` land verbatim on the emitted event (e.g.
        ``batch_size`` on ``predict.step``)."""
        now = time.monotonic()
        if dur_s is None:
            dur_s = now - self._last_t
        self._last_t = now
        self._timer.record(dur_s)
        self._steps.increment()
        wait_s = None
        if self._infeed is not None:
            total = self._infeed.total_wait_s
            wait_s = total - self._last_wait
            self._last_wait = total
        if phases:
            for name, seconds in phases.items():
                hist = self._phase_hists.get(name)
                if hist is not None and dur_s > 0:
                    hist.record(seconds / dur_s)
        if overlap_eff is not None:
            self._overlap.set(round(float(overlap_eff), 4))
        if loss is not None:
            try:
                loss = float(loss)
            except (TypeError, ValueError):
                loss = None
        if loss is not None:
            self._loss.set(loss)
        if self._event_name == "train.step":
            # feed the live goodput ledger (if one is active): step time
            # minus the blocked shares is goodput, the blocked shares
            # are named badput
            from distributed_tensorflow_tpu_torch.telemetry import goodput
            ledger = goodput.active_ledger()
            if ledger is not None:
                ledger.step_completed(
                    dur_s, infeed_s=wait_s or 0.0,
                    ckpt_s=(phases or {}).get("ckpt_block", 0.0))
        if telemetry.enabled():
            fields = {"dur_s": round(dur_s, 6)}
            if step is not None:
                fields["step"] = int(step)
            if loss is not None:
                fields["loss"] = loss
            if wait_s is not None:
                fields["infeed_wait_s"] = round(wait_s, 6)
            if phases:
                for name, seconds in phases.items():
                    fields[f"{name}_s"] = round(float(seconds), 6)
            if overlap_eff is not None:
                fields["overlap_eff"] = round(float(overlap_eff), 4)
            for k, v in extra_fields.items():
                if v is not None:
                    fields[k] = v
            telemetry.event(self._event_name, **fields)
        if self._stall is not None:
            self._stall.step_completed(step=step, dur_s=dur_s)


class InfeedLoop:
    """Host-streamed stepping with background device staging: a daemon
    thread places upcoming batches (``buffer_size`` deep, ``place_fn``,
    e.g. ``strategy.shard_batch``) while the steps consume them, so the
    host-to-device copies overlap compute.

        loop = InfeedLoop(iter(dataset), place_fn=strategy.shard_batch)
        for _ in range(steps):
            state, metrics = step_fn(state, loop.next())

    Host-boundedness is a measured number, not a guess: ``next()``
    accumulates the time the step loop spent BLOCKED on the infeed
    (``total_wait_s`` over ``batches`` delivered), and
    ``wait_fraction(elapsed_s)`` gives the per-run infeed-wait share of
    wall time — the bench's "input pipeline is not the bottleneck"
    criterion. The counters also register as an ``infeed`` stage in
    ``utils.profiler.pipeline_stats()``.
    """

    def __init__(self, iterator: Iterator, place_fn: Callable | None = None,
                 buffer_size: int = 2, name: str | None = None):
        self._it = iterator
        self._place = place_fn or (lambda b: tree.tree_map(
            torch.as_tensor, b))
        self._buf: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._size = buffer_size
        self._done = False
        self._err: BaseException | None = None
        self.total_wait_s = 0.0
        self.batches = 0
        self._stats = profiler.StageStats(name or "infeed")
        self._wait_timer = telemetry.timer(
            "training/infeed_wait",
            "per-step time the step loop blocked on the infeed")
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            src = iter(self._it)
            while True:
                t0 = time.monotonic()
                try:
                    batch = next(src)
                except StopIteration:
                    return
                t1 = time.monotonic()
                staged = self._place(batch)
                t2 = time.monotonic()
                with self._cv:
                    while len(self._buf) >= self._size and not self._done:
                        self._cv.wait(0.1)
                    if self._done:
                        return
                    self._buf.append(staged)
                    depth = len(self._buf)
                    self._cv.notify_all()
                self._stats.record(
                    elements=1, busy_s=t2 - t1,       # placement time
                    producer_wait_s=t1 - t0,          # host pipeline time
                    blocked_put_s=time.monotonic() - t2,
                    queue_depth=depth)
        except BaseException as e:      # surfaced on next()
            self._err = e
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def next(self, timeout: float = 60.0):
        t0 = time.monotonic()
        with self._cv:
            ready = self._cv.wait_for(
                lambda: self._buf or self._done or self._err, timeout)
            waited = time.monotonic() - t0
            if self._err is not None:
                raise self._err
            if not self._buf:
                if not ready:
                    # producer still alive but slow: NOT end-of-data
                    raise TimeoutError(
                        f"infeed produced nothing in {timeout}s "
                        f"(source iterator or device staging stalled)")
                raise StopIteration
            batch = self._buf.popleft()
            self._cv.notify_all()
        self.total_wait_s += waited
        self.batches += 1
        self._stats.record(consumer_wait_s=waited)
        self._wait_timer.record(waited)
        return batch

    @property
    def mean_wait_s(self) -> float:
        """Mean per-step time the consumer blocked on the infeed."""
        return self.total_wait_s / self.batches if self.batches else 0.0

    def wait_fraction(self, elapsed_s: float) -> float:
        """Share of ``elapsed_s`` the step loop spent infeed-blocked —
        < 0.05 means the host input pipeline is not the bottleneck."""
        return self.total_wait_s / elapsed_s if elapsed_s > 0 else 0.0

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def stop(self):
        with self._cv:
            self._done = True
            self._cv.notify_all()

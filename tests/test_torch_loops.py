"""Port parity: ``training/loops.py`` and the telemetry it feeds
(``telemetry/registry.py``'s ``Timer`` and ``percentile``,
``utils/profiler.py``'s stage counters) against the JAX package's, on
the CPU.

``repeat``, ``while_loop`` and ``run_steps`` give JAX's results (the
stacked per-step metrics of ``lax.scan``); ``stack_batches`` stacks as
JAX's. ``StepTelemetry`` registers the same instruments and records the
same counts; ``InfeedLoop`` delivers every batch in order, times its
waits into ``training/infeed_wait`` and registers an infeed stage, and
a duck-typed stall detector sees every step. ``Timer`` and
``Histogram.percentile`` export as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.telemetry import registry as jreg
from distributed_tensorflow_tpu.training import loops as jl
from distributed_tensorflow_tpu_torch.telemetry import registry as treg
from distributed_tensorflow_tpu_torch.training import loops as tl
from distributed_tensorflow_tpu_torch.utils import profiler


def test_repeat_and_while_loop_match_jax():
    assert float(tl.repeat(5, lambda s: s * 2 + 1, torch.tensor(1.0))) == \
        float(jl.repeat(5, lambda s: s * 2 + 1, jnp.float32(1.0)))
    got = tl.while_loop(lambda s: s < 100, lambda s: s * 3, torch.tensor(2))
    want = jl.while_loop(lambda s: s < 100, lambda s: s * 3, jnp.int32(2))
    assert int(got) == int(want)


def test_run_steps_and_stack_batches_match_jax():
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(3,)).astype(np.float32)}
               for _ in range(4)]

    def step(s, b):
        s = s + b["x"].sum()
        return s, {"s": s, "m": b["x"].max()}
    jst, jm = jl.run_steps(step, jnp.float32(0), jl.stack_batches(batches))
    tb = tl.stack_batches([{"x": torch.from_numpy(b["x"])} for b in batches])
    np.testing.assert_array_equal(tb["x"].numpy(),
                                  np.asarray(jl.stack_batches(batches)["x"]))
    tst, tm = tl.run_steps(step, torch.tensor(0.0), tb)
    np.testing.assert_allclose(float(tst), float(jst), atol=1e-6)
    for k in ("s", "m"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-6)


class _Stall:
    def __init__(self):
        self.steps = []

    def step_completed(self, step=None, dur_s=None):
        self.steps.append(step)


def test_step_telemetry_and_infeed_match_jax():
    out = {}
    for name, mod, reg_mod, to in (
            ("jax", jl, jreg, jnp.asarray),
            ("port", tl, treg, torch.as_tensor)):
        reg = reg_mod.MetricsRegistry()
        loop = mod.InfeedLoop(iter([np.float32(i) for i in range(6)]),
                              place_fn=to, buffer_size=2, name=f"feed_{name}")
        stall = _Stall()
        tel = mod.StepTelemetry(infeed=loop, stall_detector=stall, reg=reg)
        got = []
        for i in range(6):
            got.append(float(loop.next()))
            tel.step_completed(i, loss=float(i) / 2,
                               phases={"compute": 0.001, "host": 0.0005})
        with pytest.raises(StopIteration):
            loop.next()
        snap = reg.snapshot()
        out[name] = {"got": got, "stall": stall.steps,
                     "names": sorted(snap),
                     "steps": snap["training/steps_completed"]["value"],
                     "loss": snap["training/last_loss"]["value"],
                     "count": snap["training/step_time"]["count"],
                     "batches": loop.batches}
    assert out["port"] == out["jax"]
    assert out["port"]["got"] == [float(i) for i in range(6)]
    names = [s["name"] for s in profiler.pipeline_stats("feed_port")]
    assert names == ["feed_port"]
    assert treg.get_registry().get("training/infeed_wait").count >= 6


def test_timer_and_percentile_export_as_jax():
    exports = []
    for mod in (jreg, treg):
        t = mod.Timer("t")
        for v in (0.5, 0.25, 1.0, 2.0):
            t.record(v)
        h = mod.Histogram("h")
        for v in range(11):
            h.record(v)
        exports.append((t.export(), t.total_seconds, t.average_seconds,
                        [h.percentile(q) for q in (0, 50, 95, 100)]))
    assert exports[0] == exports[1]

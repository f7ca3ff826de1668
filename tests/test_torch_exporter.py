"""The port's ``telemetry/exporter.py`` held to the JAX package's: the
Prometheus text of one registry snapshot and of one fleet rollup is
byte-identical, ``SeriesHistory`` keeps the same points and rates, one
HTTP scrape of a port exporter returns its rendered registry, and the
router's ``parse_queue_depth`` reads either package's
``metrics-live.prom``."""

import urllib.request

import numpy as np
import pytest

from distributed_tensorflow_tpu.serving import router as jax_router
from distributed_tensorflow_tpu.telemetry import exporter as jax_exp
from distributed_tensorflow_tpu.telemetry import registry as jax_reg
from distributed_tensorflow_tpu_torch.serving import router as pt_router
from distributed_tensorflow_tpu_torch.telemetry import exporter as pt_exp
from distributed_tensorflow_tpu_torch.telemetry import registry as pt_reg


def _fill(reg_mod, seed: int = 0):
    reg = reg_mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("serving/tokens_generated").increment(1234)
    reg.counter("router/reroutes_total").increment(3)
    reg.gauge("serving/requests_queued").set(7)
    reg.gauge("fleet/capacity/burn_short").set(1.25)
    h = reg.histogram("serving/latency_s")
    t = reg.timer("training/step_time")
    for v in rng.lognormal(-2.0, 0.5, 300):
        h.record(float(v))
        t.record(float(v) / 3)
    return reg


def test_render_prometheus_byte_identical():
    jsnap, psnap = _fill(jax_reg).snapshot(), _fill(pt_reg).snapshot()
    assert psnap == jsnap
    for labels in (None, {"job": "supervisor", "worker": "3"}):
        assert pt_exp.render_prometheus(psnap, labels=labels) == \
            jax_exp.render_prometheus(jsnap, labels=labels)


def test_render_rollup_byte_identical():
    rollup = {"workers": {0: {"wall": 100.0}, 1: {"wall": 60.0},
                          "2": {"wall": 99.5}},
              "metrics": {"training/step_time": {
                  "sum": 3.5, "max": 1.5, "mean": 1.1667, "p50": 1.0,
                  "p95": 1.4, "count": 3,
                  "per_worker": {0: 1.0, 1: 1.5, "2": 1.0}},
                  "serving/requests_queued": {
                      "sum": 9, "max": 5, "count": 3,
                      "per_worker_count": {0: 5, 1: 4}}}}
    for kw in ({}, {"stale_after_s": 10.0}, {"stale_after_s": 10.0,
                                              "now": 101.0},
               {"retired": {0: 100.5, "2": 50.0}}):
        assert pt_exp.render_rollup(rollup, **kw) == \
            jax_exp.render_rollup(rollup, **kw)


def test_series_history_rates():
    jh, ph = jax_exp.SeriesHistory(points=16), pt_exp.SeriesHistory(
        points=16)
    jr, pr = jax_reg.MetricsRegistry(), pt_reg.MetricsRegistry()
    for i in range(40):
        for reg in (jr, pr):
            reg.counter("serving/tokens").increment(5 * i)
            if i % 3 == 0:
                reg.gauge("serving/requests_queued").set(i % 7)
        jh.record(jr.snapshot(), wall=float(i))
        ph.record(pr.snapshot(), wall=float(i))
    assert ph.names() == jh.names()
    for name in jh.names():
        assert ph.series(name) == jh.series(name)
        assert ph.rate(name, 10.0) == jh.rate(name, 10.0)


@pytest.fixture
def exporters(tmp_path):
    made = []

    def make(mod, reg, **kw):
        e = mod.MetricsExporter(reg, interval_s=60.0, **kw)
        made.append(e)
        return e
    yield make
    for e in made:
        e.stop()


def test_http_scrape_and_file_export(tmp_path, exporters):
    reg = _fill(pt_reg)
    exp = exporters(pt_exp, reg, port=0, dir=str(tmp_path / "pt"),
                    labels={"job": "replica"})
    # a tick of its own: the thread's first tick may not have run yet
    exp.tick()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/metrics", timeout=10) as resp:
        body = resp.read().decode()
    assert resp.status == 200
    lines = body.splitlines()
    assert lines[0].startswith("# dtx metrics  wall=")
    assert lines[1:] == pt_exp.render_prometheus(reg.snapshot(),
                                                 labels={"job": "replica"})
    exporters(jax_exp, _fill(jax_reg), dir=str(tmp_path / "jax")).tick()
    for sub in ("pt", "jax"):
        path = str(tmp_path / sub / pt_exp.LIVE_METRICS_FILE)
        assert pt_router.parse_queue_depth(path) == 7
        assert jax_router.parse_queue_depth(path) == 7

"""Port parity: the profiler half of ``utils/profiler.py`` on
``torch.profiler`` against the JAX package's on ``jax.profiler``.

``profile`` writes a trace under ``<logdir>/plugins/profile/<run>/``
(the port's a Chrome trace, JAX's an XSpace) and ``op_profile`` reads
the port's back into per-op rows (CPU-op rows here; kernel rows on the
card). ``step_marker`` emits the same ``profiler.step_marker`` telemetry
events as JAX's, with the same steps; ``Trace`` names a range as JAX's
annotation; ``trace("local")`` collects in this process; both refuse an
address target; the port's ``start_server`` raises (no
``torch.profiler`` counterpart). Every public name of JAX's module
exists in the port's."""

import glob
import os
import time

import pytest
import torch

from distributed_tensorflow_tpu import telemetry as jtel
from distributed_tensorflow_tpu.utils import profiler as jprof
from distributed_tensorflow_tpu_torch.telemetry import events as tev
from distributed_tensorflow_tpu_torch.utils import profiler as tprof


def test_public_names_match_jax():
    names = {n for n in vars(jprof) if not n.startswith("_")
             and callable(getattr(jprof, n))
             and getattr(getattr(jprof, n), "__module__", "")
             == jprof.__name__}
    missing = sorted(n for n in names if not hasattr(tprof, n))
    assert missing == []
    assert tprof.ProfilerOptions(host_tracer_level=3).host_tracer_level == 3


def test_profile_then_op_profile_rows_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "prof")

    @tprof.annotate_function(name="work")
    def work(x):
        return torch.relu(x @ x + 1.0)

    with tprof.profile(logdir):
        x = torch.ones(128, 128)
        for i in range(3):
            with tprof.step_marker(i):
                x = work(x) / 128.0
    paths = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                   "*.pt.trace.json"))
    assert len(paths) == 1
    rows = tprof.op_profile(logdir, top=5, device_substr="CPU")
    assert rows and all(r.total_ms >= 0 and r.count >= 1 for r in rows)
    assert rows == sorted(rows, key=lambda r: -r.total_ms)
    every = tprof.op_profile(logdir, top=10_000, device_substr="CPU")
    assert abs(sum(r.fraction for r in every) - 1) < 1e-6
    names = {r.name for r in every}
    assert {"aten::mm", "aten::relu"} <= names
    text = open(paths[0]).read()
    assert '"train step_num=2"' in text and '"work"' in text
    with pytest.raises(ValueError):
        tprof.op_profile(logdir, device_substr="TPU")
    with pytest.raises(FileNotFoundError):
        tprof.op_profile(str(tmp_path / "empty"))


def test_one_session_at_a_time(tmp_path):
    tprof.start(str(tmp_path / "a"))
    try:
        with pytest.raises(RuntimeError):
            tprof.start(str(tmp_path / "b"))
    finally:
        tprof.stop()
    with pytest.raises(RuntimeError):
        tprof.stop()


def _markers(tel, prof, logdir, steps):
    tel.configure(logdir, process_id=0)
    try:
        for s in steps:
            with prof.step_marker(s):
                time.sleep(0.001)
    finally:
        tel.shutdown()
    return [{k: e[k] for k in ("ev", "step", "pid")}
            for e in tel.read_events(tel.event_log_path(logdir, 0))
            if e["ev"] == "profiler.step_marker"]


def test_step_marker_events_equal_jax(tmp_path):
    steps = [0, 1, 5, 7]
    got = _markers(tev, tprof, str(tmp_path / "t"), steps)
    want = _markers(jtel, jprof, str(tmp_path / "j"), steps)
    assert got == want and [e["step"] for e in got] == steps


def test_trace_names_like_jax():
    assert tprof.Trace("step", step_num=3, b="x").name == "step b=x step_num=3"
    assert tprof._trace_name("s", {}) == "s"


def test_local_trace_and_address_targets(tmp_path):
    out = tprof.trace("local", str(tmp_path / "t"), duration_ms=30)
    assert out == str(tmp_path / "t")
    assert glob.glob(os.path.join(out, "**", "*.pt.trace.json"),
                     recursive=True)
    for m in (tprof, jprof):
        with pytest.raises(TypeError, match="grpc ProfilerService"):
            m.trace("host:6009", str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="run_worker_loop"):
        tprof.start_server(6009)

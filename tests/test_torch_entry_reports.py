"""Port parity: ``tools/torch_obs_report.py`` and
``tools/torch_trace_report.py`` against the JAX package's
``tools/obs_report.py`` and ``tools/trace_report.py``, byte for byte.

Two run directories: one a tiny port run wrote
(``tools/torch_train_mnist.py --device cpu --telemetry-dir``: the
native path's ``train.step`` events and its live metrics file), and one
the JAX package's event log wrote (two workers' ``train.step`` events
with phases, checkpoint spans, served requests, a stall, a fault and a
dispatch retry, and the supervisor's recovery timeline with a chaos
kill; a torn final line in one worker's log). On each, every mode —
the text report, ``--json``, ``--check`` (with ``--require``,
``--mttr-budget``, ``--expect-bottleneck`` and ``--forbid-bottleneck``,
passing and failing) — gives the same standard output, standard error
and return code from both tools, and the trace tool the same summary
(text, ``--json``, ``--check``) and the same ``trace.json`` bytes.
"""

import importlib.util
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_obs_report  # noqa: E402
import torch_trace_report  # noqa: E402
import torch_train_mnist  # noqa: E402


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {"obs": (_jax_tool("obs_report"), torch_obs_report),
            "trace": (_jax_tool("trace_report"), torch_trace_report)}


def _jax_run(d: str):
    """A run directory written through the JAX package's event log."""
    from distributed_tensorflow_tpu.telemetry.events import (
        EventLog, event_log_path)
    sup = EventLog(event_log_path(d, "supervisor"), process_id="supervisor")
    sup.event("recovery.run_start", num_workers=2)
    sup.event("recovery.generation_start", generation=0)
    workers = [EventLog(event_log_path(d, p), process_id=p)
               for p in (0, 1)]
    for step in range(12):
        for p, log in enumerate(workers):
            log.event("train.step", step=step, loss=2.0 - 0.1 * step,
                      dur_s=0.05 + 0.001 * p, compute_s=0.03,
                      collective_s=0.01, infeed_wait_s=0.004 * (step % 3),
                      ckpt_block_s=0.002)
            sup.event("clock.hb", generation=0, worker=p, step=step,
                      worker_wall=time.time())
        if step == 5:
            with workers[0].span("checkpoint.save", path=f"{d}/ck-6",
                                 span_id="ckpt/6"):
                time.sleep(0.002)
            workers[1].event("stall.suspected", step=step, stalled_s=1.5)
            workers[0].event("fault.fired", site="data.fetch", kind="raise")
            workers[1].event("dispatch.retry", worker=1, attempt=1)
    for i in range(6):
        workers[0].event("serve.request", id=f"r{i:04d}",
                         latency_s=0.02 * (i + 1), prompt_tokens=8,
                         new_tokens=4, model_version="0@abc")
    sup.event("recovery.chaos_kill", generation=0, worker=1, at_step=7)
    sup.event("recovery.worker_death", generation=0, worker=1,
              exitcode=-9, reason="killed")
    sup.event("recovery.restart", generation=1, restarts_used=1)
    sup.event("recovery.generation_start", generation=1)
    for p, log in enumerate(workers):
        log.event("recovery.restore_tier", generation=1, tier="host",
                  step=10)
        log.event("train.step", step=12, loss=0.8, dur_s=0.05,
                  compute_s=0.04, collective_s=0.01)
        sup.event("clock.hb", generation=1, worker=p, step=12,
                  worker_wall=time.time())
    sup.event("recovery.run_complete", generation=1)
    for log in [sup] + workers:
        log.close()
    with open(event_log_path(d, 1), "a") as f:
        f.write('{"ev": "train.step", "step": 13, "lo')     # torn tail


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    port = str(tmp_path_factory.mktemp("port_run"))
    args = torch_train_mnist.build_parser().parse_args(
        ["--device", "cpu", "--steps", "25", "--telemetry-dir", port])
    torch_train_mnist.run(args)
    jax_dir = str(tmp_path_factory.mktemp("jax_run"))
    _jax_run(jax_dir)
    return {"port": port, "jax": jax_dir}


def _call(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


OBS_MODES = [
    [], ["--json"], ["--check"],
    ["--check", "--require", "recovery.chaos_kill"],
    ["--check", "--require", "train.step", "--require", "serve"],
    ["--check", "--mttr-budget", "1e-6"],
    ["--check", "--mttr-budget", "600"],
    ["--check", "--expect-bottleneck", "compute-bound"],
    ["--check", "--forbid-bottleneck", "input-bound",
     "--forbid-bottleneck", "compute-bound"],
]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_obs_report_byte_identical(tools, run_dirs, which, capsys):
    jax_tool, port_tool = tools["obs"]
    d = run_dirs[which]
    for mode in OBS_MODES:
        want = _call(jax_tool.main, [d, *mode], capsys)
        got = _call(port_tool.main, [d, *mode, "--device", "cpu"], capsys)
        assert got == want, mode
    # the modes above reach both outcomes of the gates
    rcs = {_call(port_tool.main, [d, *m, "--device", "cpu"], capsys)[0]
           for m in OBS_MODES}
    assert rcs == {0, 1}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_trace_report_byte_identical(tools, run_dirs, which, capsys):
    jax_tool, port_tool = tools["trace"]
    d = run_dirs[which]
    trace = os.path.join(d, "trace.json")
    for mode in ([], ["--json"], ["--check"], ["--check", "--pipeline"]):
        want = _call(jax_tool.main, [d, *mode], capsys)
        shutil.move(trace, trace + ".jax")
        got = _call(port_tool.main, [d, *mode, "--device", "cpu"], capsys)
        assert got == want, mode
        with open(trace, "rb") as a, open(trace + ".jax", "rb") as b:
            assert a.read() == b.read(), mode

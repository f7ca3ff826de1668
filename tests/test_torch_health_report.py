"""Port parity: ``tools/torch_health_report.py`` against the JAX
package's ``tools/health_report.py``, byte for byte.

Three run directories: a production day the port's
``testing/day_sim.DaySim`` wrote (half-length, serving with SLO records,
training, a rack loss and its recovery), a tiny port MNIST run
(``tools/torch_train_mnist.py --device cpu --telemetry-dir``), and one
the JAX package's event log wrote (two workers' steps, served requests,
a stall, a fault, a recovery with a chaos kill, a torn final line). On
each, every mode (the report, ``--json``, ``--check`` with its gates
passing and failing, explicit burn windows) gives the same standard
output, standard error and return code from both tools (on one clock:
the report gives the live scrape's age); so does a directory that does
not exist.
"""

import importlib.util
import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import test_torch_entry_reports as entry_reports  # noqa: E402
import torch_health_report  # noqa: E402
import torch_train_mnist  # noqa: E402


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    from distributed_tensorflow_tpu_torch.testing import day_sim
    day = str(tmp_path_factory.mktemp("port_day"))
    rep = day_sim.DaySim(seed=2, logdir=day,
                         phases=day_sim.default_phases(compress=0.5)).run()
    assert rep["error"] is None
    mnist = str(tmp_path_factory.mktemp("port_mnist"))
    torch_train_mnist.run(torch_train_mnist.build_parser().parse_args(
        ["--device", "cpu", "--steps", "25", "--telemetry-dir", mnist]))
    jax_dir = str(tmp_path_factory.mktemp("jax_run"))
    entry_reports._jax_run(jax_dir)
    return {"day": day, "mnist": mnist, "jax": jax_dir}


def _call(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


MODES = [
    [], ["--json"], ["--check"],
    ["--check", "--goodput-floor", "0.999"],
    ["--check", "--goodput-floor", "0.01"],
    ["--check", "--slo-budget", "0.01"],
    ["--check", "--slo-budget", "1000"],
    ["--check", "--identity-tol", "0"],
    ["--slo-window", "60,5,14.4", "--slo-window", "10,1,2"],
    ["--check", "--slo-latency-ms", "1", "--slo-ttft-ms", "1"],
    ["--json", "--slo-freshness-s", "0.5"],
]


@pytest.mark.parametrize("which", ["day", "mnist", "jax"])
def test_health_report_byte_identical(run_dirs, which, capsys,
                                      monkeypatch):
    jax_tool = _jax_tool("health_report")
    # one clock for both tools: the live scrape's age is read from it
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    d = run_dirs[which]
    rcs = set()
    for mode in MODES:
        want = _call(jax_tool.main, [d, *mode], capsys)
        got = _call(torch_health_report.main,
                    [d, *mode, "--device", "cpu"], capsys)
        assert got == want, mode
        rcs.add(got[0])
    if which == "day":
        assert rcs == {0, 1}


def test_missing_run_dir(tmp_path, capsys):
    d = str(tmp_path / "nothing")
    want = _call(_jax_tool("health_report").main, [d], capsys)
    assert _call(torch_health_report.main, [d, "--device", "cpu"],
                 capsys) == want
    assert want[0] == 2

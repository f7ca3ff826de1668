"""Port parity: ``tools/torch_day_report.py`` against the JAX package's
``tools/day_report.py``, byte for byte.

Two production-day run directories from the same seed and a
half-length day (``default_phases(compress=0.5)``): one the port's
``testing/day_sim.DaySim`` wrote, one the JAX package's. On each, every
mode (the scorecard, ``--json``, ``--check`` with its gates passing and
failing) gives the same standard output, standard error and return code
from both tools; so does a directory that does not exist.
"""

import importlib.util
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_day_report  # noqa: E402


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    from distributed_tensorflow_tpu.testing import day_sim as jax_day
    from distributed_tensorflow_tpu_torch.testing import day_sim as pt_day
    out = {}
    for name, mod in (("port", pt_day), ("jax", jax_day)):
        d = str(tmp_path_factory.mktemp(f"{name}_day"))
        rep = mod.DaySim(seed=1, logdir=d,
                         phases=mod.default_phases(compress=0.5)).run()
        assert rep["error"] is None
        out[name] = d
    return out


def _call(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


MODES = [
    [], ["--json"], ["--check"],
    ["--check", "--goodput-floor", "0.999"],
    ["--check", "--goodput-floor", "0.1"],
    ["--check", "--max-mttr-s", "1e-6"],
    ["--check", "--allow-cold"],
    ["--check", "--max-unattributed", "0", "--identity-tol", "0"],
    ["--slo-latency-ms", "20", "--slo-ttft-ms", "5"],
    ["--check", "--slo-latency-ms", "20"],
]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_day_report_byte_identical(run_dirs, which, capsys):
    jax_tool = _jax_tool("day_report")
    d = run_dirs[which]
    rcs = set()
    for mode in MODES:
        want = _call(jax_tool.main, [d, *mode], capsys)
        got = _call(torch_day_report.main, [d, *mode, "--device", "cpu"],
                    capsys)
        assert got == want, mode
        rcs.add(got[0])
    assert rcs == {0, 1}


def test_missing_run_dir(tmp_path, capsys):
    d = str(tmp_path / "nothing")
    want = _call(_jax_tool("day_report").main, [d], capsys)
    assert _call(torch_day_report.main, [d, "--device", "cpu"],
                 capsys) == want
    assert want[0] == 2

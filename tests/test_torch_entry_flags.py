"""The port's entry-point scripts against their JAX counterparts' command
lines and seeded plans, exactly.

- Flags: every ``tools/torch_<name>.py`` takes its JAX script's options
  (option strings, destinations, defaults, types, choices, nargs and
  actions) and adds only ``--device {cuda,cpu}``, default ``cuda``.
- No fallback: without ``--device cpu`` each script exits with a
  non-zero status and a message that names CUDA on a machine without
  one (in this process for all ten, and once as a subprocess).
- Seeded plans: ``seeded_input_kill_plan``, ``seeded_online_kill_plan``,
  the elastic MNIST run's kill and shrink plans, the axes parser, the
  rollout workload and the data-service split files equal JAX's.
"""

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_tensorflow_tpu.resilience import (
    seeded_kill_plan as jseeded_kill_plan,
    seeded_shrink_plan as jseeded_shrink_plan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_entry  # noqa: E402

#: port script -> its JAX counterpart (path under the repo)
SCRIPTS = {
    "torch_train_transformer": "examples/train_transformer.py",
    "torch_train_bert": "examples/train_bert.py",
    "torch_serve_transformer": "examples/serve_transformer.py",
    "torch_train_resnet": "examples/train_resnet.py",
    "torch_train_mnist": "examples/train_mnist.py",
    "torch_train_online": "examples/train_online.py",
    "torch_live_rollout": "examples/live_rollout.py",
    "torch_shared_fleet": "examples/shared_fleet.py",
    "torch_obs_report": "tools/obs_report.py",
    "torch_trace_report": "tools/trace_report.py",
}
#: what each port script needs on its command line to reach the device
#: check
ARGV = {"torch_obs_report": [REPO], "torch_trace_report": [REPO]}


def _jax(rel: str):
    name = "jax_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return importlib.import_module(name)


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(main, monkeypatch, argv):
    def capture(self, *a, **kw):
        raise _Captured(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as e:
        main(*argv)
    monkeypatch.undo()
    return e.value.parser


def _flags(parser) -> dict:
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or (a.dest,)
        out[key] = (a.dest, a.default, getattr(a.type, "__name__", a.type),
                    None if a.choices is None else list(a.choices),
                    a.nargs, a.const, type(a).__name__)
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_flags_equal_jax_plus_device(name, monkeypatch):
    jax_main = _jax(SCRIPTS[name]).main
    want = _flags(_parser_of(
        jax_main, monkeypatch,
        [[]] if "argv" in jax_main.__code__.co_varnames else []))
    got = _flags(_parser_of(_port(name).main, monkeypatch, [[]]))
    device = got.pop(("--device",))
    assert device == ("device", "cuda", None, ["cuda", "cpu"], None, None,
                      "_StoreAction")
    assert got == want


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_no_cuda_exits_naming_cuda(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _port(name).main(ARGV.get(name, []))
    assert e.value.code not in (0, None)
    assert "CUDA" in str(e.value.code) and "--device cpu" in str(
        e.value.code)


def test_no_cuda_subprocess_exit_status():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "torch_train_transformer.py"),
         "--steps", "1"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout == ""


def _plan(plan) -> list:
    return [(k.worker, k.after_step, k.permanent) for k in plan]


@pytest.mark.parametrize("seed", range(5))
def test_seeded_plans_equal_jax(seed):
    jm = _jax("examples/train_mnist.py")
    jo = _jax("examples/train_online.py")
    pm = _port("torch_train_mnist")
    po = _port("torch_train_online")
    for workers in (1, 2, 3, 5):
        for kills in (1, 2, 4):
            assert _plan(pm.seeded_input_kill_plan(
                seed, workers, kills=kills)) == _plan(
                jm.seeded_input_kill_plan(seed, workers, kills=kills))
            for grad in (0, 1, 3):
                assert _plan(po.seeded_online_kill_plan(
                    seed, grad, kills=kills)) == _plan(
                    jo.seeded_online_kill_plan(seed, grad, kills=kills))
            for steps in (6, 30, 100):
                for permanent in (False, True):
                    args = pm.build_parser().parse_args(
                        ["--elastic", "--workers", str(workers),
                         "--kill-seed", str(seed), "--kills", str(kills),
                         "--steps", str(steps)]
                        + (["--permanent-kill"] if permanent else []))
                    rng = (2, max(3, steps - 4))
                    want = (jseeded_shrink_plan(seed, workers,
                                                step_range=rng)
                            if permanent else jseeded_kill_plan(
                                seed, workers, kills=kills,
                                step_range=rng))
                    assert _plan(pm.elastic_kill_plan(args)) == _plan(want)


def test_axes_parser_equals_jax():
    jt = _jax("examples/train_transformer.py")
    jb = _jax("examples/train_bert.py")
    for spec in ("dp=-1", "dp=2,tp=2", "dp=2,fsdp=2,tp=2", "pp=4",
                 "dp=1,sp=2,ep=2"):
        got = torch_entry.parse_axes(spec)
        assert list(got.items()) == list(jt.parse_axes(spec).items())
        assert list(got.items()) == list(jb.parse_axes(spec).items())


@pytest.mark.parametrize("seed", range(3))
def test_rollout_workload_equals_jax(seed):
    jr = _jax("examples/live_rollout.py")
    pr = _port("torch_live_rollout")
    for duration, qps in ((24.0, 5.0), (8.0, 3.0)):
        got = pr.rollout_workload(seed, duration_s=duration, qps=qps)
        want = jr.rollout_workload(seed, duration_s=duration, qps=qps)
        assert [(r.id, tuple(r.tokens), r.max_new_tokens, r.arrival_s)
                for r in got] == [(r.id, tuple(r.tokens), r.max_new_tokens,
                                   r.arrival_s) for r in want]


def test_split_files_equal_jax(tmp_path):
    jm = _jax("examples/train_mnist.py")
    pm = _port("torch_train_mnist")
    got = pm.write_mnist_split_files(str(tmp_path / "p"), 8)
    want = jm.write_mnist_split_files(str(tmp_path / "j"), 8)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with np.load(a) as za, np.load(b) as zb:
            for k in ("image", "label"):
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k])

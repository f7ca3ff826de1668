"""Port parity: the port's event log (``telemetry/events.py``) against
the JAX package's on rotated, torn and env-activated logs.

- Rotation: 21 events written with ``max_bytes`` (the argument, or
  ``DTX_TELEMETRY_ROTATE_BYTES``) land in ``events-0.jsonl`` and its
  ``.N`` segments; both packages' ``read_events`` / ``read_run`` read
  all 21, oldest first, whichever package wrote them, and
  ``goodput.ledger_from_run`` agrees.
- A torn final line is dropped by both; a malformed line before the
  last, a torn line inside a rotated segment, and a line that is not a
  JSON object raise ``EventLogCorruptError`` in both.
- ``DTX_TELEMETRY_DIR`` opens a log at import in both (run in a fresh
  interpreter), and ``configure(run_id=)`` writes ``run.start``.
- Under an initialised gloo group of 2 each rank writes
  ``events-<rank>.jsonl``, even where the launcher's task index says
  otherwise.
"""

import json
import os
import subprocess
import sys

import pytest

from distributed_tensorflow_tpu.telemetry import events as jevents
from distributed_tensorflow_tpu.telemetry import goodput as jgoodput
from distributed_tensorflow_tpu_torch.telemetry import events
from distributed_tensorflow_tpu_torch.telemetry import goodput
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": events, "jax": jevents}


def _write_rotated(pkg, logdir, n=21, max_bytes=400):
    log = pkg.EventLog(pkg.event_log_path(str(logdir), 0), process_id=0,
                       max_bytes=max_bytes)
    for i in range(n):
        log.event("train.step", step=i, dur_s=0.001)
    log.close()


def _strip(evs):
    return [{k: v for k, v in e.items() if k not in ("t", "wall")}
            for e in evs]


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_rotated_log_reads_21_events_in_both(tmp_path, writer):
    _write_rotated(PACKAGES[writer], tmp_path)
    path = str(tmp_path / "events-0.jsonl")
    segs = events.rotated_segments(path)
    assert segs == jevents.rotated_segments(path)
    assert len(segs) == 4
    got = events.read_run(str(tmp_path))
    want = jevents.read_run(str(tmp_path))
    assert list(got) == list(want) == [0]
    assert len(got[0]) == len(want[0]) == 21
    assert got == want
    assert [e["step"] for e in got[0]] == list(range(21))
    assert goodput.ledger_from_run(str(tmp_path)) == \
        jgoodput.ledger_from_run(str(tmp_path))


class _FixedClock:
    """Both writers' clock at one instant: a line's length (where a log
    rotates) then depends on its fields alone, not on how many digits
    the timestamps happen to print."""

    @staticmethod
    def monotonic():
        return 100.0

    @staticmethod
    def time():
        return 1750000000.5

    @staticmethod
    def perf_counter():
        return 100.0


def test_writers_rotate_alike(tmp_path, monkeypatch):
    for name, pkg in PACKAGES.items():
        monkeypatch.setattr(pkg, "time", _FixedClock)
        _write_rotated(pkg, tmp_path / name)
    names = {n: sorted(os.listdir(tmp_path / n)) for n in PACKAGES}
    assert names["port"] == names["jax"]
    for f in names["port"]:
        got = [json.loads(x) for x in open(tmp_path / "port" / f)]
        want = [json.loads(x) for x in open(tmp_path / "jax" / f)]
        assert _strip(got) == _strip(want), f


def test_rotate_bytes_env(tmp_path, monkeypatch):
    monkeypatch.setenv("DTX_TELEMETRY_ROTATE_BYTES", "400")
    for name, pkg in PACKAGES.items():
        log = pkg.EventLog(str(tmp_path / name / "events-0.jsonl"))
        assert log.max_bytes == 400
        log.close()
    monkeypatch.setenv("DTX_TELEMETRY_ROTATE_BYTES", "junk")
    assert events.EventLog(str(tmp_path / "x.jsonl")).max_bytes == 0


def test_torn_tail_dropped_in_both(tmp_path):
    _write_rotated(events, tmp_path)
    with open(tmp_path / "events-0.jsonl", "a") as f:
        f.write('{"ev": "train.st')
    for pkg in PACKAGES.values():
        assert len(pkg.read_events(str(tmp_path / "events-0.jsonl"))) == 21
        with pytest.raises(pkg.EventLogCorruptError):
            pkg.read_events(str(tmp_path / "events-0.jsonl"),
                            tolerate_torn_tail=False)


@pytest.mark.parametrize("damage", ["mid_file", "not_object",
                                    "torn_segment"])
def test_corruption_raises_where_jax_raises(tmp_path, damage):
    _write_rotated(events, tmp_path)
    live = tmp_path / "events-0.jsonl"
    if damage == "torn_segment":
        target = tmp_path / "events-0.jsonl.1"
        lines = open(target).read().splitlines()
        lines[-1] = lines[-1][:10]
    else:
        target = live
        lines = open(target).read().splitlines()
        lines.insert(0, "[1, 2]" if damage == "not_object" else "{bad")
    open(target, "w").write("\n".join(lines) + "\n")
    with pytest.raises(jevents.EventLogCorruptError):
        jevents.read_run(str(tmp_path))
    with pytest.raises(events.EventLogCorruptError):
        events.read_run(str(tmp_path))
    assert issubclass(events.EventLogCorruptError, ValueError)


def test_run_id_writes_run_start(tmp_path):
    for name, pkg in PACKAGES.items():
        log = pkg.configure(str(tmp_path / name), process_id=3,
                            run_id="r1")
        pkg.event("x")
        pkg.shutdown()
        evs = pkg.read_events(log.path)
        assert [(e["ev"], e.get("run_id"), e["pid"]) for e in evs] == \
            [("run.start", "r1", 3), ("x", None, 3)]


_ENV_CODE = """
import sys
mod = sys.argv[1]
import importlib
ev = importlib.import_module(mod)
assert ev.enabled()
ev.event("env.hello")
ev.shutdown()
"""


@pytest.mark.parametrize("module", [
    "distributed_tensorflow_tpu_torch.telemetry.events",
    "distributed_tensorflow_tpu.telemetry.events"])
def test_env_dir_opens_a_log_at_import(tmp_path, module):
    env = dict(os.environ, DTX_TELEMETRY_DIR=str(tmp_path),
               DTX_MPR_TASK_INDEX="5", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _ENV_CODE, module],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for pkg in PACKAGES.values():
        run = pkg.read_run(str(tmp_path))
        assert list(run) == [5]
        assert [e["ev"] for e in run[5]] == ["env.hello"]


def test_each_rank_writes_its_own_file(tmp_path):
    res = multi_process_runner.run(
        torch_dp_ranks.events_rank, 2, args=(str(tmp_path),), device="cpu",
        env={"DTX_MPR_TASK_INDEX": "9"}, timeout=120)
    assert [v["rank"] for v in res.return_values] == [0, 1]
    assert sorted(os.listdir(tmp_path)) == ["events-0.jsonl",
                                            "events-1.jsonl"]
    for pkg in PACKAGES.values():
        run = pkg.read_run(str(tmp_path))
        assert {pid: [(e["ev"], e["pid"]) for e in evs]
                for pid, evs in run.items()} == {
            r: [("run.start", r), ("rank.hello", r)] for r in (0, 1)}

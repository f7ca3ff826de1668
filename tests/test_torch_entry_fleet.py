"""The port's supervised fleet demos on the CPU, end to end; each is
marked ``slow`` (excluded from tier-1): their runs last 15-60 s by
design (paced streams, open-loop traffic, reforms).

- ``tools/torch_train_online.py --supervised --kill-seed 0``: the four
  roles under the supervisor, one SIGKILLed and restarted; every event
  applied once (the trainer's offset is the stream's end, the ingestor
  produced exactly ``--events``), and the run directory passes
  ``torch_obs_report.py --check --require recovery.chaos_kill``.
- ``tools/torch_live_rollout.py --kills 1`` at a shortened
  ``--duration``: no request dropped, no completion's tokens other than
  the pure output of the version it is stamped with, a hot swap landed,
  the ledger identity holds, and the final state is coherent
  (``final_state_problems``). It need not be promoted: the respawn
  burns the SLO, and JAX's ``examples/live_rollout.py`` rolls back
  under the same flags on the CPU too.
- ``tools/torch_live_rollout.py`` with no kill at JAX's default
  duration: promoted, by JAX's decisions (the canary, the second
  replica, the promotion).
- ``tools/torch_shared_fleet.py`` at a shortened spike: serving scaled
  up once and back down at most once, no request dropped, training got
  its capacity back.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_live_rollout  # noqa: E402
import torch_obs_report  # noqa: E402
import torch_shared_fleet  # noqa: E402
import torch_train_online  # noqa: E402

pytestmark = pytest.mark.slow


def test_online_supervised_kill(tmp_path):
    tdir = str(tmp_path / "t")
    args = torch_train_online.build_parser().parse_args(
        ["--device", "cpu", "--supervised", "--kill-seed", "0",
         "--events", "240", "--stream-dir", str(tmp_path / "s"),
         "--telemetry-dir", tdir])
    out = torch_train_online.run(args)
    assert out["restarts"] == 1
    results = {r[0]: r for r in out["results"]
               if isinstance(r, list) and isinstance(r[0], str)}
    assert results["trainer"][1] == 240
    assert results["ingestor"][1] == 240
    assert torch_obs_report.main(
        [tdir, "--check", "--require", "recovery.chaos_kill",
         "--device", "cpu"]) == 0


def test_live_rollout_kill(tmp_path):
    args = torch_live_rollout.build_parser().parse_args(
        ["--device", "cpu", "--duration", "8", "--kills", "1",
         "--kill-steps", "5", "30", "--telemetry-dir",
         str(tmp_path / "t")])
    summary = torch_live_rollout.run(args)
    assert summary["requests"]["dropped"] == 0
    assert summary["versions"]["mixed_or_wrong"] == 0
    assert summary["swaps"]["hot"] + summary["swaps"]["restart"] >= 1
    assert summary["ledger"]["identity_error_frac"] < 0.01
    assert torch_live_rollout.final_state_problems(
        summary["rollout"]) == []


def test_live_rollout_promotes_without_kills(tmp_path):
    args = torch_live_rollout.build_parser().parse_args(
        ["--device", "cpu", "--telemetry-dir", str(tmp_path / "t")])
    summary = torch_live_rollout.run(args)
    assert summary["requests"]["dropped"] == 0
    assert summary["versions"]["mixed_or_wrong"] == 0
    rollout = summary["rollout"]
    assert rollout["promoted"]
    assert [(d["action"], d["reason"]) for d in rollout["decisions"]] == [
        ("advance", "canary_start"), ("advance", "burn_clear"),
        ("promote", "burn_clear")]
    assert torch_live_rollout.final_state_problems(rollout) == []


def test_shared_fleet_spike(tmp_path):
    args = torch_shared_fleet.build_parser().parse_args(
        ["--device", "cpu", "--duration", "30", "--spike-start", "6",
         "--spike-end", "18", "--linger", "12", "--telemetry-dir",
         str(tmp_path / "t")])
    summary = torch_shared_fleet.run(args)
    assert summary["requests"]["dropped"] == 0
    assert summary["scale_up"]["applied_up"] >= 1
    assert summary["result"]["serve_scales"] <= 2
    assert summary["capacity_returned"]

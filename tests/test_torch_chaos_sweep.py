"""Port parity: ``tools/torch_chaos_sweep.py`` against the JAX package's
``tools/chaos_sweep.py``.

- Every gate function returns JAX's list of failures on the same run
  directories and summaries: clean ones written through the port's
  event log at tiny scale (a killed training run, a data-service run, an
  online stream, a disaggregated serving run, a rollout summary, a
  router and a spike summary), and tampered copies of them (a dropped
  request, a leaked block, a split consumed twice, a cold restore, a
  missing ``scale.applied``, and more). The delta-publish fault leg,
  which runs in process, gives JAX's (empty) list on the same seeds.
- The parser is JAX's, plus only ``--device``.
- Each mode's command lines are JAX's with the port's script in place
  of JAX's example (``tools/torch_<name>.py --device <device>``): the
  run script's and the telemetry gate's that follows it.
- ``--day --seeds 1`` runs end to end (the port's ``DaySim`` in
  process) and survives.
"""

import argparse
import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_chaos_sweep as port  # noqa: E402

from distributed_tensorflow_tpu_torch.serving.replica import (  # noqa: E402
    seeded_requests)
from distributed_tensorflow_tpu_torch.telemetry.events import (  # noqa: E402
    EventLog, event_log_path)


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sweep():
    return _jax_tool("chaos_sweep")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(port, "DEVICE", "cpu")


W0 = 1_700_000_000.0
SERVE_SEED, N_REQUESTS = 3, 12


def _log(d, pid):
    return EventLog(event_log_path(d, pid), process_id=pid)


def _train_run(d, *, tier="host", best="host"):
    """Two workers killed once: generation 0's steps, the supervisor's
    kill and restart, generation 1's restore and steps."""
    sup = _log(d, "supervisor")
    sup.event("recovery.run_start", wall=W0, num_workers=2)
    workers = [_log(d, p) for p in (0, 1)]
    for p, log in enumerate(workers):
        for s in range(10):
            log.event("train.step", wall=W0 + 0.1 * (s + 1), dur_s=0.08,
                      step=s, loss=2.0 - 0.1 * s, infeed_wait_s=0.004,
                      ckpt_block_s=0.002)
    sup.event("recovery.chaos_kill", wall=W0 + 1.0, generation=0,
              worker=1, at_step=9)
    sup.event("recovery.worker_death", wall=W0 + 1.05, generation=0,
              worker=1, exitcode=-9, reason="killed")
    sup.event("recovery.restart", wall=W0 + 1.2, generation=1,
              restarts_used=1)
    for p, log in enumerate(workers):
        log.event("recovery.restore_tier", wall=W0 + 1.5, gen=1,
                  generation=1, tier=tier, best_available=best,
                  available=["host", "durable"], step=10)
        for s in range(10, 20):
            log.event("train.step", wall=W0 + 1.5 + 0.1 * (s - 9), gen=1,
                      dur_s=0.08, step=s, loss=1.0)
    sup.event("recovery.run_complete", wall=W0 + 2.6, generation=1)
    for log in [sup] + workers:
        log.close()


def _data_run(d, *, dup=None, lose=None):
    """Two epochs of eight splits consumed once each; one input-worker
    kill and its death."""
    sup = _log(d, "supervisor")
    sup.event("recovery.chaos_kill", wall=W0 + 0.5, generation=0,
              worker=2)
    sup.event("recovery.worker_death", wall=W0 + 0.6, generation=0,
              worker=2, exitcode=-9, reason="killed")
    log = _log(d, 0)
    t = W0
    for epoch in range(2):
        for split in range(8):
            t += 0.05
            if (epoch, split) != lose:
                log.event("data.split_consumed", wall=t, epoch=epoch,
                          split=split)
            if (epoch, split) == dup:
                log.event("data.split_consumed", wall=t, epoch=epoch,
                          split=split)
        log.event("data.epoch_consumed", wall=t, epoch=epoch)
    for x in (sup, log):
        x.close()


ONLINE_EVENTS = 32


def _online_run(d, *, final_commit=True, final_lag=0):
    """An online stream killed after committing 16 of 32 events: the
    next generation resumes at 16 and commits the rest; a snapshot
    before the kill and one covering the whole stream after it."""
    sup = _log(d, "supervisor")
    sup.event("recovery.restart", wall=W0 + 1.0, generation=1)
    trainer = _log(d, 0)
    trainer.event("stream.resume", wall=W0 + 0.01, offset=0)
    for lo in (0, 8):
        trainer.event("stream.batch_applied", wall=W0 + 0.1 + lo / 100,
                      lo=lo, hi=lo + 8)
    trainer.event("stream.commit", wall=W0 + 0.3, offset=16)
    trainer.event("stream.batch_applied", wall=W0 + 0.4, lo=16, hi=24)
    trainer.event("stream.resume", wall=W0 + 1.2, gen=1, offset=16)
    for lo in (16, 24):
        trainer.event("stream.batch_applied", wall=W0 + 1.3 + lo / 100,
                      gen=1, lo=lo, hi=lo + 8)
    trainer.event("stream.commit", wall=W0 + 1.6, gen=1, offset=24)
    if final_commit:
        trainer.event("stream.commit", wall=W0 + 1.7, gen=1, offset=32)
    ev = _log(d, 1)
    ev.event("stream.snapshot_published", wall=W0 + 0.5, offset=16,
             lag_events=16, freshness_s=1.0, step=1)
    ev.event("stream.snapshot_published", wall=W0 + 2.0, gen=1,
             offset=32 - final_lag, lag_events=final_lag,
             freshness_s=0.5, step=2)
    for x in (sup, trainer, ev):
        x.close()


def _serve_run(d, *, drop=None, disagree=None, leaked=0, migrate=True):
    """Two serving replicas over the seeded requests (a request served by
    both, byte-identical), their exit allocator checks, one KV
    migration priced inside a serve step."""
    reqs = seeded_requests(SERVE_SEED, N_REQUESTS, 256)
    for task in (0, 1):
        mine = [r for i, r in enumerate(reqs) if i % 2 == task]
        if task == 1:
            mine.append(reqs[0])              # re-served after a kill
        with open(os.path.join(d, f"served-{task}.jsonl"), "w") as f:
            for r in mine:
                if r.id == drop:
                    continue
                toks = [len(r.id), 7, 1]
                if task == 1 and r.id == disagree:
                    toks = [0]
                f.write(json.dumps({"id": r.id, "tokens": toks}) + "\n")
        log = _log(d, task)
        log.event("run.start", wall=W0)
        for s in range(6):
            if migrate and task == 0 and s == 3:
                log.event("kv.migrate", wall=W0 + 0.1 * s + 0.05,
                          dur_s=0.03, blocks=4)
            log.event("serve.step", wall=W0 + 0.1 * (s + 1), dur_s=0.09)
        log.event("serve.alloc_check", wall=W0 + 0.7, task=task, gen=0,
                  conserved=not (leaked and task == 1),
                  leaked_refs=leaked if task == 1 else 0, free=60,
                  allocated=4)
        log.close()


ROLLOUT = {"requests": {"dropped": 0, "missing_ids": []},
           "versions": {"mixed_or_wrong": 0, "unversioned": 0,
                        "examples": []},
           "ledger": {"identity_error_frac": 0.001},
           "rollout": {"rolled_back": False, "state": "promoted"},
           "swaps": {"hot": 2, "restart": 1}}
ROUTER = {"dropped": 0, "duplicates_mismatched": 0, "double_routes": 0,
          "affinity_hit_rate": 0.72, "random_hit_rate": 0.63,
          "interactive_recovered": True, "interactive_recovery_p99_s": 0.17,
          "recovery_samples": 40, "batch_starved_past_slo": False,
          "batch_recovery_p99_s": 0.4, "sheds": 3,
          "rejects_by_tenant_cause": {"t2/quota": 4},
          "identity_error_frac": 0.002, "reroutes": 6,
          "badput_reroute_replay_s": 0.3, "badput_recovery_s": 1.1}
SPIKE = {"scale_up": {"applied_up": 1, "donations": 1,
                      "scale_up_latency_s": 5.9},
         "slo_recovered": True, "capacity_returned": True,
         "requests": {"dropped": 0, "missing_ids": []},
         "train_warm_resume": True, "train_restore_tiers": ["host"],
         "ledger": {"serve": {"identity_error_frac": 0.003,
                              "goodput_frac": 0.8,
                              "badput_s": {"scale_transition": 2.0}},
                    "train": {"identity_error_frac": 0.001,
                              "goodput_frac": 0.7,
                              "badput_s": {"scale_transition": 1.0}}}}


def _tampered(base, path, value):
    out = copy.deepcopy(base)
    node = out
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return out


def _rollout_dir(d, summary):
    with open(os.path.join(d, "rollout-summary.json"), "w") as f:
        json.dump(summary, f)


# (case id, writer of the run directory or None, gate name, gate args
# after the run directory, whether the clean gate passes)
DIR_CASES = [
    ("kill_clean", _train_run, "_restore_tier_gate", (), True),
    ("kill_cold_restore",
     lambda d: _train_run(d, tier="durable", best="host"),
     "_restore_tier_gate", (), False),
    ("kill_goodput", _train_run, "_goodput_gate", (None,), True),
    ("kill_goodput_floor", _train_run, "_goodput_gate", (0.999,), False),
    ("data_goodput_no_recovery", _data_run, "_goodput_gate", (None,),
     False),
    ("data_clean", _data_run, "_split_accounting_gate", (8, 2, 1), True),
    ("data_split_twice", lambda d: _data_run(d, dup=(1, 3)),
     "_split_accounting_gate", (8, 2, 1), False),
    ("data_split_lost", lambda d: _data_run(d, lose=(0, 5)),
     "_split_accounting_gate", (8, 2, 1), False),
    ("data_missing_epoch_and_kill", _data_run, "_split_accounting_gate",
     (8, 3, 2), False),
    ("online_clean", _online_run, "_stream_accounting_gate",
     (ONLINE_EVENTS,), True),
    ("online_uncommitted_tail", lambda d: _online_run(d, final_commit=False),
     "_stream_accounting_gate", (ONLINE_EVENTS,), False),
    ("online_fresh", _online_run, "_freshness_gate",
     (ONLINE_EVENTS, 10.0), True),
    ("online_stale", lambda d: _online_run(d, final_lag=4),
     "_freshness_gate", (ONLINE_EVENTS, 0.25), False),
    ("serve_clean", _serve_run, "_served_requests_gate",
     (N_REQUESTS, SERVE_SEED), True),
    ("serve_dropped_request",
     lambda d: _serve_run(d, drop=seeded_requests(
         SERVE_SEED, N_REQUESTS, 256)[5].id),
     "_served_requests_gate", (N_REQUESTS, SERVE_SEED), False),
    ("serve_duplicate_disagrees",
     lambda d: _serve_run(d, disagree=seeded_requests(
         SERVE_SEED, N_REQUESTS, 256)[0].id),
     "_served_requests_gate", (N_REQUESTS, SERVE_SEED), False),
    ("serve_conserved", _serve_run, "_alloc_conservation_gate", (), True),
    ("serve_leaked_block", lambda d: _serve_run(d, leaked=2),
     "_alloc_conservation_gate", (), False),
    ("serve_no_alloc_check", _data_run, "_alloc_conservation_gate", (),
     False),
    ("serve_migrate_priced", _serve_run, "_migrate_ledger_gate", (), True),
    ("serve_migrate_unpriced", lambda d: _serve_run(d, migrate=False),
     "_migrate_ledger_gate", (), False),
    ("rollout_clean", lambda d: _rollout_dir(d, ROLLOUT),
     "_rollout_summary_gate", (), True),
    ("rollout_dropped",
     lambda d: _rollout_dir(d, _tampered(ROLLOUT, ("requests", "dropped"),
                                         1)),
     "_rollout_summary_gate", (), False),
    ("rollout_no_summary", lambda d: None, "_rollout_summary_gate", (),
     False),
]


@pytest.mark.parametrize("case", DIR_CASES, ids=[c[0] for c in DIR_CASES])
def test_run_dir_gates_equal_jax(jax_sweep, tmp_path, case):
    _, write, gate, args, clean = case
    d = str(tmp_path)
    write(d)
    want = getattr(jax_sweep, gate)(d, *args, **(
        {"expect_recovery": True} if gate == "_goodput_gate" else {}))
    got = getattr(port, gate)(d, *args, **(
        {"expect_recovery": True} if gate == "_goodput_gate" else {}))
    assert got == want
    assert (got == []) == clean, got


def test_rollout_gate_expect_rollback_equals_jax(jax_sweep, tmp_path):
    d = str(tmp_path)
    _rollout_dir(d, ROLLOUT)
    for expect in (True, False):
        want = jax_sweep._rollout_summary_gate(d, expect_rollback=expect)
        assert port._rollout_summary_gate(d, expect_rollback=expect) == want
        assert bool(want) == expect


SUMMARY_CASES = [
    ("router_clean", "_router_summary_gates", ROUTER, (), True),
    ("router_dropped", "_router_summary_gates",
     _tampered(ROUTER, ("dropped",), 2), (), False),
    ("router_unpriced_reroute", "_router_summary_gates",
     _tampered(ROUTER, ("badput_reroute_replay_s",), 0.0), (), False),
    ("router_empty", "_router_summary_gates", {}, (), False),
    ("spike_clean", "_spike_gates", SPIKE, (None,), True),
    ("spike_missing_scale_applied", "_spike_gates",
     _tampered(SPIKE, ("scale_up", "applied_up"), 0), (None,), False),
    ("spike_dropped", "_spike_gates",
     _tampered(SPIKE, ("requests", "dropped"), 1), (None,), False),
    ("spike_goodput_floor", "_spike_gates", SPIKE, (0.9,), False),
    ("spike_empty", "_spike_gates", {}, (None,), False),
]


@pytest.mark.parametrize("case", SUMMARY_CASES,
                         ids=[c[0] for c in SUMMARY_CASES])
def test_summary_gates_equal_jax(jax_sweep, case):
    _, gate, summary, args, clean = case
    want = getattr(jax_sweep, gate)(copy.deepcopy(summary), *args)
    got = getattr(port, gate)(copy.deepcopy(summary), *args)
    assert got == want
    assert (got == []) == clean, got


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_fault_gate_equals_jax(jax_sweep, seed):
    """The in-process delta-publish leg (the port's ``DynamicTable`` on
    the CPU): JAX's empty list on the same seed."""
    assert port._delta_fault_gate(seed) == jax_sweep._delta_fault_gate(
        seed) == []


def test_table_state_is_a_snapshot():
    """The delta leg's premise: a ``DynamicTable.state_dict()`` taken
    before an update keeps its values on the CPU (a CPU tensor's
    ``numpy()`` would share the live rows), as JAX's arrays do."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.embedding.dynamic import (
        DynamicTable, DynamicTableConfig)
    table = DynamicTable(DynamicTableConfig(dim=4, initial_capacity=16,
                                            max_capacity=32), device="cpu")
    rows = table.translate(np.arange(6))
    before = table.state_dict()
    kept = before["rows"].copy()
    table.apply_row_grads(rows, np.ones((6, 4), np.float32))
    assert np.array_equal(before["rows"], kept)
    assert not np.array_equal(table.state_dict()["rows"], kept)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen["ap"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main([])
    return seen["ap"]


def _actions(ap):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const,
                     a.type, a.choices, a.required, a.metavar,
                     type(a).__name__) for a in ap._actions}


def test_parser_is_jaxs_plus_device(jax_sweep, monkeypatch):
    want = _actions(_parser_of(jax_sweep.main, monkeypatch))
    got = _actions(_parser_of(port.main, monkeypatch))
    device = got.pop("device")
    assert got == want
    assert device[0] == ("--device",) and device[1] == "cuda"
    assert tuple(device[5]) == ("cuda", "cpu")


def _fake_run(calls):
    """``subprocess.run`` that records each command: the run script
    exits 0, the gate after it 1 (the mode stops there)."""
    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0 if len(calls) == 1 else 1,
                                           stdout=b"", stderr=b"")
    return run


def _commands(mod, fn, kwargs, monkeypatch, tmp_path):
    calls = []
    n = {"dirs": 0}

    def mkdtemp(prefix="tmp", **kw):
        n["dirs"] += 1
        d = tmp_path / f"{n['dirs']}_{prefix}"
        d.mkdir(exist_ok=True)
        return str(d)

    with monkeypatch.context() as m:
        m.setattr(subprocess, "run", _fake_run(calls))
        m.setattr(tempfile, "mkdtemp", mkdtemp)
        ok, _ = getattr(mod, fn)(0, **kwargs)
    assert not ok
    return calls


def _port_form(cmd):
    """JAX's command with the port's script in place of JAX's example or
    tool, given the port's ``--device``."""
    out = []
    for x in cmd:
        name = os.path.basename(x)[:-3] if x.endswith(".py") else None
        if name and os.path.dirname(x) in (os.path.join(REPO, "examples"),
                                           os.path.join(REPO, "tools")):
            out += [os.path.join(REPO, "tools", f"torch_{name}.py"),
                    "--device", "cpu"]
        else:
            out.append(x)
    return out


MODES = [
    ("kill", "run_kill_seed",
     dict(workers=2, steps=20, save_every=5, budget=3, keep_dirs=False)),
    ("shrink", "run_kill_seed",
     dict(workers=3, steps=20, save_every=5, budget=3, keep_dirs=False,
          shrink=True, mttr_budget=30.0, goodput_floor=0.2)),
    ("data", "run_data_seed",
     dict(input_workers=2, epochs=2, split_files=8, budget=3, kills=1,
          keep_dirs=False)),
    ("online", "run_online_seed",
     dict(events=480, budget=3, keep_dirs=False, freshness_budget=10.0)),
    ("serve", "run_serve_seed",
     dict(workers=2, requests=24, budget=3, keep_dirs=False)),
    ("disagg", "run_serve_seed",
     dict(workers=3, requests=24, budget=3, keep_dirs=False,
          disagg=True)),
    ("router", "run_router_seed", dict(workers=2, keep_dirs=False)),
    ("spike", "run_spike_seed",
     dict(budget=3, train_workers=2, keep_dirs=False)),
    ("rollout", "run_rollout_seed",
     dict(replicas=2, duration=18.0, keep_dirs=False)),
]


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_mode_commands_are_jaxs_with_port_scripts(jax_sweep, mode,
                                                  monkeypatch, tmp_path):
    _, fn, kwargs = mode
    want = _commands(jax_sweep, fn, kwargs, monkeypatch, tmp_path)
    got = _commands(port, fn, kwargs, monkeypatch, tmp_path)
    assert want and len(got) == len(want)
    jax_scripts = {os.path.basename(c[1]) for c in want}
    assert jax_scripts & {"train_mnist.py", "serve_transformer.py",
                          "serve_router.py", "shared_fleet.py",
                          "train_online.py", "live_rollout.py"}
    assert got == [_port_form(c) for c in want]


@pytest.mark.parametrize("device,chaos", [("cpu", False), ("cpu", True),
                                          ("cuda", False), ("cuda", True)])
def test_router_workload_is_jaxs(device, chaos):
    """The --router mode's workload (tools/torch_serve_router.py) is the
    JAX example's; on the card under chaos only its arrivals last
    ``CARD_CHAOS_DURATION_S``, so that the recovery window opens before
    the last arrival after the card's longer respawn."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_router", os.path.join(REPO, "examples", "serve_router.py"))
    jax_router = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_router)
    spec = importlib.util.spec_from_file_location(
        "torch_serve_router", os.path.join(REPO, "tools",
                                           "torch_serve_router.py"))
    router = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(router)
    want = dict(jax_router.workload_params(chaos))
    if chaos and device == "cuda":
        assert router.CARD_CHAOS_DURATION_S > want["duration_s"]
        want["duration_s"] = router.CARD_CHAOS_DURATION_S
    assert router.workload_params(chaos, "tiny", device) == want
    # the transformer_big preset (the four-card router phase) keeps
    # JAX's duration on the card
    big = router.workload_params(chaos, "transformer_big", device)
    assert big["duration_s"] == jax_router.workload_params(chaos)[
        "duration_s"]


def test_default_mode_runs_the_port_suite(monkeypatch):
    """The default mode runs ``tests/test_torch_chaos.py`` (JAX's runs
    ``tests/test_chaos.py``) without the repo's conftest, with JAX's
    markers, the seed and the device in its environment."""
    calls = []

    def run(cmd, *a, **kw):
        calls.append((list(cmd), kw["env"]))
        return subprocess.CompletedProcess(cmd, 0, stdout=b"", stderr=b"")

    monkeypatch.setattr(subprocess, "run", run)
    assert port.run_seed(7, False, ["-x"])[0]
    assert port.run_seed(8, True, [])[0]
    (fast, env7), (slow, env8) = calls
    assert fast[1:] == ["-m", "pytest", "--noconftest",
                        "tests/test_torch_chaos.py", "-q", "-m",
                        "chaos and not slow", "-p", "no:cacheprovider",
                        "-x"]
    assert slow[slow.index("-m", 3) + 1] == "chaos"
    assert env7["DTX_CHAOS_SEED"] == "7" and env8["DTX_CHAOS_SEED"] == "8"
    assert env7[port.ENV_CHAOS_DEVICE] == "cpu"


def test_day_mode_survives_end_to_end(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    rc = port.main(["--day", "--seeds", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "seed    0: PASS" in out
    assert "survival: 1/1 seeds (100%)" in out
    assert "0 dropped" in out
    shutil.rmtree(tmp_path, ignore_errors=True)

#!/usr/bin/env python3
"""Fleet-sim seed sweep + scaling-curve gate (the chaos-gate family).

On the port: the counterpart of ``tools/fleet_sweep.py``, over the
port's ``testing/fleet_sim.py`` and its real ``RecoverySupervisor``,
with the same flags, gates, printed lines and exit codes; it adds only
``--device`` (default ``cuda``, as every port script; the simulated
fleet runs on host threads, so ``--device cpu`` runs the same sweep).
``--check`` gates the checked-in ``FLEET_r*.json`` / ``DATA_r*.json``:
those are the JAX package's records (``bench.py --fleet``,
``--data-service``); the port's own curves come with its benchmark.

Companion to tools/chaos_sweep.py on the CONTROL-PLANE axis: where
chaos_sweep kills real worker processes, this sweeps seed-derived
crash/stall/partition schedules through the simulated-fleet harness
(testing/fleet_sim.py — N in-process workers driving the real
coordination / tree-rollup / sharded-heartbeat / supervisor code), so
fleet-scale recovery behavior is a deterministic test on a 1-core box.

Per seed (run mode and ``--check``): build
``fleet_sim.seeded_fleet_schedule(seed, N)`` (one crash, one stall,
one partition — victims and steps a pure function of the seed), run
the fleet under the real RecoverySupervisor, and gate:

- the run completes within the restart budget;
- every scheduled fault actually fired (crash + stall + partition);
- the crash forced >= 1 recovery and the supervisor's event log names
  the dead worker (detections non-empty);
- whenever >= 3 generations ran, the KV lifecycle GC swept the dead
  middle generations (bounded KV size).

``--check`` additionally gates the checked-in FLEET_r*.json scaling
curve (the bench.py --fleet output, latest round) AND the
DATA_r*.json input-worker fleet curve (bench.py --data-service):
steady + churn phases complete, exactly-once accounting
clean under the seeded kill, the largest-N service row at or above
the in-process pipeline with the trainer's infeed-wait fraction
reduced, and every churn row showing >= 1 re-issued lease.

FLEET_r*.json gates:

- per-worker KV ops per step stay ~flat in N (sub-linearity: the
  max/min ratio across the N sweep is bounded);
- the busiest single agent's ops per step grow SUB-LINEARLY in N
  (tree fan-in O(fanout·log N) — the flat scheme's coordinator would
  be O(N));
- every row carries detect latency and MTTR (the detect curve exists).

Usage::

    python tools/torch_fleet_sweep.py --seeds 3                # sweep only
    python tools/torch_fleet_sweep.py --seeds 3 --workers 500  # big fleet
    python tools/torch_fleet_sweep.py --check                  # curve gate +
                                                               # 3-seed sweep

Exit code is non-zero if any seed or gate fails (CI-friendly).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_entry  # noqa: E402


def run_fleet_seed(seed: int, *, workers: int, steps: int,
                   verbose: bool = True) -> "tuple[bool, float]":
    """One seeded crash/stall/partition schedule through the harness;
    returns (survived, wall_s)."""
    from distributed_tensorflow_tpu_torch.testing import fleet_sim

    schedule = fleet_sim.seeded_fleet_schedule(seed, workers,
                                               stall_s=3.0)
    t0 = time.monotonic()
    sim = fleet_sim.FleetSim(workers, steps=steps, step_s=0.02,
                             fault_schedule=schedule,
                             stall_timeout_s=0.6, gc_grace_s=0.2,
                             seed=seed)
    rep = sim.run()
    dt = time.monotonic() - t0
    bad = []
    if not rep.completed:
        bad.append(f"run failed: {rep.error}")
    fired = {(f["tag"], f["action"]) for f in rep.faults_fired}
    for rule in schedule.rules:
        if (rule.tag, rule.action) not in fired:
            bad.append(f"scheduled fault never fired: "
                       f"worker {rule.tag} {rule.action}")
    if rep.generations < 2:
        bad.append("the crash fault forced no recovery "
                   f"(generations={rep.generations})")
    if not rep.detections:
        bad.append("supervisor event log recorded no worker_death")
    if rep.generations >= 3:
        expected = list(range(1, rep.generations - 1))
        missing = [g for g in expected
                   if g not in rep.swept_generations]
        if missing:
            bad.append(f"KV GC left dead generation(s) {missing} "
                       f"unswept (swept={rep.swept_generations})")
    if bad and verbose:
        print(f"--- seed {seed} FAILED ---")
        for b in bad:
            print(f"    {b}")
        print(f"    faults_fired={rep.faults_fired}")
        print(f"    failures={rep.failures}")
    return not bad, dt


# ---------------------------------------------------------------------------
# FLEET_r*.json curve gates
# ---------------------------------------------------------------------------

def _latest_round(repo: str, pattern: str) -> "tuple[int, list] | None":
    best = None
    for path in sorted(glob.glob(os.path.join(repo, pattern))):
        m = re.search(r"_r(\d+)\.json$", os.path.basename(path))
        rnd = int(m.group(1)) if m else -1
        try:
            with open(path) as f:
                rows = json.load(f).get("rows", [])
        except (OSError, ValueError):
            continue
        if rows and (best is None or rnd > best[0]):
            best = (rnd, rows)
    return best


def latest_fleet_round(repo: str = REPO) -> "tuple[int, list] | None":
    return _latest_round(repo, "FLEET_r*.json")


def latest_data_round(repo: str = REPO) -> "tuple[int, list] | None":
    return _latest_round(repo, "DATA_r*.json")


def check_data_curve(rows: list) -> "list[str]":
    """Gate the input-worker fleet curve of DATA_r*.json.

    - every steady phase completed; every churn phase (N >= 2)
      completed with ZERO lost and ZERO duplicated elements — the
      exactly-once contract is part of the throughput claim;
    - the largest-N service row beats the in-process pipeline
      (vs_baseline >= 1.0) AND cuts the trainer's infeed-wait
      fraction below the in-process run's — the host-boundedness win
      the service exists for;
    - churn rows carry splits_reassigned_per_kill >= 1 (the lease
      re-issue actually ran).
    Returns violations (empty = ok)."""
    bad = []
    by_n = {}
    for row in rows:
        extra = row.get("extra") or {}
        n = extra.get("n_input_workers")
        if isinstance(n, int):
            by_n[n] = (row, extra)
    if not by_n:
        return ["no data-service rows with n_input_workers found"]
    for n in sorted(by_n):
        row, extra = by_n[n]
        if extra.get("steady_completed") is not True:
            bad.append(f"row N={n}: steady phase did not complete")
        if n >= 2:
            if extra.get("churn_completed") is not True:
                bad.append(f"row N={n}: churn phase did not complete")
            for field in ("churn_duplicates", "churn_missing"):
                if extra.get(field) not in (0,):
                    bad.append(f"row N={n}: {field} = "
                               f"{extra.get(field)!r} (exactly-once "
                               f"violated under churn)")
            r = extra.get("splits_reassigned_per_kill")
            if not isinstance(r, int) or r < 1:
                bad.append(f"row N={n}: splits_reassigned_per_kill = "
                           f"{r!r} (the kill forced no lease re-issue)")
    n_hi = max(by_n)
    row, extra = by_n[n_hi]
    vsb = row.get("vs_baseline")
    if not isinstance(vsb, (int, float)) or vsb < 1.0:
        bad.append(f"row N={n_hi}: service throughput is not >= the "
                   f"in-process pipeline (vs_baseline={vsb!r})")
    wf, base_wf = (extra.get("infeed_wait_frac"),
                   extra.get("inproc_infeed_wait_frac"))
    if not (isinstance(wf, (int, float))
            and isinstance(base_wf, (int, float)) and wf < base_wf):
        bad.append(f"row N={n_hi}: infeed_wait_frac {wf!r} not below "
                   f"the in-process pipeline's {base_wf!r}")
    return bad


def check_curve(rows: list, *, flatness_max: float = 3.0,
                fan_in_frac_of_linear: float = 0.5) -> "list[str]":
    """Gate the scaling curve's SHAPE. Returns violations (empty=ok)."""
    bad = []
    by_n = {}
    for row in rows:
        extra = row.get("extra") or {}
        n = extra.get("n_workers")
        if isinstance(n, int):
            by_n[n] = extra
    if len(by_n) < 2:
        return [f"need >= 2 worker counts to gate a curve, "
                f"got {sorted(by_n)}"]
    ns = sorted(by_n)
    n_lo, n_hi = ns[0], ns[-1]

    # sub-linear per-worker cost: ops/worker/step must stay ~flat
    pw = {n: by_n[n].get("ops_per_worker_per_step") for n in ns}
    if any(not isinstance(v, (int, float)) for v in pw.values()):
        bad.append(f"ops_per_worker_per_step missing in rows: {pw}")
    else:
        ratio = max(pw.values()) / max(min(pw.values()), 1e-9)
        if ratio > flatness_max:
            bad.append(
                f"per-worker KV ops NOT flat in N: "
                f"max/min = {ratio:.2f} > {flatness_max} ({pw})")

    # tree fan-in: busiest agent grows sub-linearly vs N
    fi = {n: by_n[n].get("max_agent_ops_per_step") for n in ns}
    if any(not isinstance(v, (int, float)) for v in fi.values()):
        bad.append(f"max_agent_ops_per_step missing in rows: {fi}")
    else:
        growth = fi[n_hi] / max(fi[n_lo], 1e-9)
        linear = n_hi / n_lo
        if growth > fan_in_frac_of_linear * linear:
            bad.append(
                f"fan-in grows ~linearly: busiest agent "
                f"x{growth:.1f} from N={n_lo} to N={n_hi} "
                f"(linear would be x{linear:.0f}; allowed "
                f"{fan_in_frac_of_linear:.0%} of linear)")

    for n in ns:
        for field in ("detect_ms", "mttr_ms"):
            if not isinstance(by_n[n].get(field), (int, float)):
                bad.append(f"row N={n} has no {field} "
                           f"(detect/MTTR curve incomplete)")
        for flag in ("steady_completed", "fault_completed"):
            if by_n[n].get(flag) is not True:
                bad.append(f"row N={n}: {flag} is "
                           f"{by_n[n].get(flag)!r}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3,
                    help="number of fault-schedule seeds (default 3)")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=64,
                    help="fleet size per seeded run (default 64; the "
                         "harness handles 500+ — slower, same gates)")
    ap.add_argument("--steps", type=int, default=12,
                    help="worker steps per generation (default 12)")
    ap.add_argument("--check", action="store_true",
                    help="also gate the latest FLEET_r*.json curve "
                         "shape (sub-linear per-worker ops, bounded "
                         "fan-in, detect/MTTR present) and DATA_r*.json "
                         "(the JAX package's records, as "
                         "tools/fleet_sweep.py gates them)")
    ap.add_argument("--repo", default=REPO)
    torch_entry.add_device_flag(ap)
    args = ap.parse_args(argv)
    torch_entry.check_device(args.device, "torch_fleet_sweep")

    rc = 0

    if args.check:
        latest = latest_fleet_round(args.repo)
        if latest is None:
            print("fleet_sweep: no FLEET_r*.json found to gate",
                  file=sys.stderr)
            rc = 1
        else:
            rnd, rows = latest
            violations = check_curve(rows)
            if violations:
                rc = 1
                for v in violations:
                    print(f"fleet_sweep: CURVE GATE r{rnd:02d} — {v}",
                          file=sys.stderr)
            else:
                ns = sorted((r.get("extra") or {}).get("n_workers")
                            for r in rows)
                print(f"fleet_sweep: curve gate OK on FLEET_r{rnd:02d} "
                      f"(N={ns})")
        latest_data = latest_data_round(args.repo)
        if latest_data is None:
            print("fleet_sweep: no DATA_r*.json found to gate "
                  "(input-worker fleet curve)", file=sys.stderr)
            rc = 1
        else:
            rnd, rows = latest_data
            violations = check_data_curve(rows)
            if violations:
                rc = 1
                for v in violations:
                    print(f"fleet_sweep: DATA GATE r{rnd:02d} — {v}",
                          file=sys.stderr)
            else:
                ns = sorted((r.get("extra") or {}).get("n_input_workers")
                            for r in rows)
                print(f"fleet_sweep: data-service curve gate OK on "
                      f"DATA_r{rnd:02d} (N={ns})")

    results = []
    for s in range(args.base_seed, args.base_seed + args.seeds):
        ok, dt = run_fleet_seed(s, workers=args.workers,
                                steps=args.steps)
        results.append((s, ok))
        print(f"seed {s:>4}: {'PASS' if ok else 'FAIL'}  ({dt:.1f}s)",
              flush=True)
    survived = sum(1 for _, ok in results if ok)
    print(f"\nsurvival: {survived}/{len(results)} seeds "
          f"({100 * survived / max(len(results), 1):.0f}%) "
          f"at N={args.workers}")
    if survived != len(results):
        print("failing seeds:", [s for s, ok in results if not ok])
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

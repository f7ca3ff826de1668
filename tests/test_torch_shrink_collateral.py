"""The port's shrink policy counts a machine loss, not its collateral.

A SIGKILLed worker (a lost machine) breaks the process group: on the
port its peers' gloo or NCCL calls raise at once and they exit as
crashes in the same round, where JAX's survivors hang until the
supervisor kills them as stragglers, so JAX never sees those crashes.
``RecoverySupervisor._record_failures`` therefore counts no shrink
streak for a crash in a round that lost a machine; with no machine lost
a crash counts as JAX counts it. On the same failure rounds the port
then shrinks the slot JAX's supervisor would shrink, the killed one:
``--kill --shrink --workers 3`` of ``tools/torch_chaos_sweep.py``.
"""

import pytest

from distributed_tensorflow_tpu.resilience import supervisor as jax_sup
from distributed_tensorflow_tpu_torch.resilience import supervisor as pt_sup


def _sup(mod, tmp_path):
    kw = {"device": "cpu"} if mod is pt_sup else {}
    return mod.RecoverySupervisor(lambda: None, num_workers=3,
                                  shrink_after=2, min_workers=2,
                                  work_dir=str(tmp_path), **kw)


def _round(mod, gen, *failures):
    return [mod.WorkerFailure(generation=gen, task=("worker", w), kind=k,
                              exitcode=-9 if k == "killed" else 1)
            for w, k in failures]


def test_crash_beside_a_killed_machine_counts_no_streak(tmp_path):
    sup = _sup(pt_sup, tmp_path)
    for gen in (0, 1):
        sup._record_failures(_round(pt_sup, gen, (2, "killed"),
                                    (0, "crash"), (1, "crash")))
    assert sup._fail_streak == {2: 2}
    assert sup._maybe_shrink() == 2 and sup._num_workers == 2
    # every failure is still recorded and priced
    assert [f.kind for f in sup.history].count("crash") == 4
    assert sup.failures_total == 6


@pytest.mark.parametrize("kind", ["crash", "stall"])
def test_failures_without_a_lost_machine_count_as_jax(tmp_path, kind):
    """No machine lost: the port's streaks are JAX's."""
    got, want = _sup(pt_sup, tmp_path / "p"), _sup(jax_sup, tmp_path / "j")
    for gen, worker in ((0, 1), (1, 1), (2, 0)):
        got._record_failures(_round(pt_sup, gen, (worker, kind)))
        want._record_failures(_round(jax_sup, gen, (worker, kind)))
        assert got._fail_streak == want._fail_streak


def test_killed_machine_streaks_equal_jax_stragglers(tmp_path):
    """JAX's round: the killed machine and its peers killed as stalled
    stragglers later, each in a round of its own; the port's round: the
    killed machine and its peers' immediate crashes. The slot either
    shrinks is the killed one."""
    got, want = _sup(pt_sup, tmp_path / "p"), _sup(jax_sup, tmp_path / "j")
    for gen in (0, 1):
        got._record_failures(_round(pt_sup, gen, (2, "killed"),
                                    (0, "crash")))
        want._record_failures(_round(jax_sup, gen, (2, "killed")))
    assert got._fail_streak == want._fail_streak == {2: 2}
    assert got._maybe_shrink() == want._maybe_shrink() == 2

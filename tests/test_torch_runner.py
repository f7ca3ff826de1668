"""The port's process runner (``testing/multi_process_runner.py``): a
rank that has reported stays up until every rank has, because rank 0
hosts the rendezvous store that a slower peer may still need. Before
this held, rank 0 left as soon as it returned, and a peer still
building a process group failed with ``DistNetworkError: Connection
reset by peer`` (seen under six test workers at once)."""

import time

import pytest

from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks


def test_peers_build_groups_after_rank0_returns():
    res = multi_process_runner.run(torch_dp_ranks.late_group_rank, 4,
                                   args=(1.0,), device="cpu", timeout=120)
    vals = res.return_values
    assert [v["rank"] for v in vals] == [0, 1, 2, 3]
    assert [v.get("sum") for v in vals] == [None, None, 2.0, 2.0]


def test_a_failing_rank_still_ends_the_run():
    """The failed rank is released at once: its exit ends rank 0's wait
    in the collective, long before the timeout."""
    t0 = time.monotonic()
    with pytest.raises(multi_process_runner.SubprocessError) as err:
        multi_process_runner.run(torch_dp_ranks.failing_rank, 2,
                                 device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60
    tasks = err.value.mpr_result.tasks
    assert "ZeroDivisionError" in tasks[("worker", 1)].error

"""Task functions for the port's pool-runner tests (JAX's
``tests/test_multi_process.py`` cases). Torch only (no jax): the pooled
processes import this module by name and run each task on gloo."""

import os
import time


def own_pid():
    return os.getpid()


def raise_worker():
    raise ValueError("intentional")


def allreduce_worker():
    """Each task contributes ``process_id + 1``; the sum is N(N+1)/2."""
    import torch
    import torch.distributed as dist
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    rt = bootstrap.initialize(device="cpu")
    x = torch.ones(4) * (rt.process_id + 1)
    dist.all_reduce(x)
    total = float(x.sum() / 4)
    bootstrap.shutdown()
    return rt.process_id, rt.num_processes, total


def kv_barrier_worker():
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        coordination_service)
    rt = bootstrap.initialize(device="cpu")
    agent = coordination_service()
    agent.key_value_set(f"greeting/{rt.process_id}",
                        f"hello-{rt.process_id}")
    agent.barrier("all-wrote", timeout_s=60)
    peer = (rt.process_id + 1) % rt.num_processes
    got = agent.key_value_get(f"greeting/{peer}", timeout_s=30).decode()
    n = agent.key_value_increment("counter", 1)
    agent.barrier("all-read", timeout_s=60)
    final = int(agent.key_value_get("counter", timeout_s=30))
    bootstrap.shutdown()
    return got, n, final


def barrier_timeout_worker():
    """Task 1 never reaches the barrier; task 0 fails fast."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.cluster.coordination import (
        BarrierTimeoutError, coordination_service)
    rt = bootstrap.initialize(device="cpu")
    agent = coordination_service()
    if rt.process_id == 0:
        try:
            agent.barrier("never-met", timeout_s=2)
            outcome = "passed"
        except BarrierTimeoutError:
            outcome = "timeout"
    else:
        time.sleep(4)
        outcome = "skipped"
    bootstrap.shutdown()
    return outcome


def env_worker(key):
    return os.environ.get(key)

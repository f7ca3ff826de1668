"""Worker functions for the port's supervisor tests: a restartable
gloo trainer stand-in that heartbeats every step and resumes from a
progress file.

Torch only (no jax): the recovery supervisor spawns fresh interpreters
that import this module by name; each task runs on gloo on the CPU.
"""

import json
import os
import time


def restartable_worker(work_dir: str, total_steps: int,
                       step_s: float = 0.15) -> dict:
    """One generation of one task: join the group from ``TF_CONFIG``,
    resume at the step rank 0 last recorded, all-reduce once a step
    (a dead peer ends its survivors' generation), heartbeat, and record
    this generation's cluster spec. Returns the task's facts."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.cluster import bootstrap, elastic
    rt = bootstrap.initialize(device="cpu", timeout_s=60.0)
    rank, gen = dist.get_rank(), elastic.generation()
    spec = json.loads(os.environ["TF_CONFIG"])["cluster"]
    with open(os.path.join(work_dir, f"spec-g{gen}-r{rank}.json"),
              "w") as f:
        json.dump(spec, f)
    prog = os.path.join(work_dir, "progress.json")
    step = 0
    if os.path.exists(prog):
        with open(prog) as f:
            step = json.load(f)["step"]
    start = step
    total = torch.zeros(1)
    while step < total_steps:
        elastic.heartbeat(step)
        x = torch.ones(1)
        dist.all_reduce(x)
        total += x
        step += 1
        if rank == 0:
            with open(prog + ".tmp", "w") as f:
                json.dump({"step": step}, f)
            os.replace(prog + ".tmp", prog)
        time.sleep(step_s)
    elastic.heartbeat(step)
    out = {"rank": rank, "gen": gen, "start": start, "steps": step,
           "world": rt.num_processes, "sum": float(total.item()),
           "spec": spec}
    bootstrap.shutdown()
    return out


def env_echo(name: str):
    """The task's value of the environment variable ``name``."""
    return os.environ.get(name)

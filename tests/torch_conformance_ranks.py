"""Rank function of the port's strategy conformance test. Torch only (no
jax): ``testing.multi_process_runner`` spawns fresh interpreters that
import this module by name; each rank runs on gloo on the CPU."""

import torch.distributed as dist


def conformance_rank(kinds) -> dict:
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    from distributed_tensorflow_tpu_torch.testing.strategy_conformance \
        import check_builtin
    bootstrap.initialize(device="cpu")
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "results": check_builtin(kinds, device="cpu")}
    dist.barrier()
    bootstrap.shutdown()
    return out

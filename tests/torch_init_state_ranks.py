"""Rank functions for the port's ``Strategy.init_state(sharding_rules=)``
parity test. Torch only (no jax): ``testing.multi_process_runner``
spawns fresh interpreters that import this module by name; each rank
runs on gloo on the CPU."""

import numpy as np
import torch

#: mesh -> the state's specs, in the port's tuple form (per array dim a
#: mesh dim name, a tuple of names, or None); None replicates
RULES = {
    "dp": {"w": ("dp", None), "k": (None, "dp"), "b": None,
           "s": (None,)},
    "dp_tp": {"w": ("dp", "tp"), "k": (("dp", "tp"), None), "b": None,
              "s": ("tp",)},
}


def state_arrays() -> dict:
    """The state ``init_fn`` returns (the JAX side builds the same)."""
    return {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
            "k": np.arange(64, dtype=np.float32).reshape(8, 8) * 0.5,
            "b": np.arange(4, dtype=np.float32),
            "s": np.arange(4, dtype=np.float32) - 2}


def init_state_rank(mesh_shape: dict, rules: str) -> dict:
    """This rank's leaves after ``init_state``: each cut leaf's local
    block (and its global read), each replicated leaf as is."""
    from distributed_tensorflow_tpu_torch.cluster import bootstrap, topology
    from distributed_tensorflow_tpu_torch.parallel.strategy import Strategy
    from distributed_tensorflow_tpu_torch.parallel.values import (
        DistributedVariable)
    rt = bootstrap.initialize(device="cpu")
    mesh = topology.make_mesh(mesh_shape, device="cpu")
    strategy = Strategy(mesh=mesh, device="cpu")

    def init():
        return {k: torch.from_numpy(v) for k, v in state_arrays().items()}
    state = strategy.init_state(init, sharding_rules=RULES[rules])
    out = {"rank": rt.process_id,
           "coords": {n: mesh.get_local_rank(n)
                      for n in mesh.mesh_dim_names},
           "local": {}, "global": {}, "cut": {}}
    for k, v in state.items():
        cut = isinstance(v, DistributedVariable)
        out["cut"][k] = cut
        out["local"][k] = (v.value if cut else v).numpy()
        out["global"][k] = (v.read_value() if cut else v).numpy()
    bootstrap.shutdown()
    return out

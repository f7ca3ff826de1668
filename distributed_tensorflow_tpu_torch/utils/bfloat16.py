"""bfloat16 mixed-precision policy and scope — port of
``distributed_tensorflow_tpu/utils/bfloat16.py`` with torch dtypes.

≙ tensorflow/python/tpu/bfloat16.py (:71 ``bfloat16_scope``: a variable
scope whose custom getter stores variables in fp32 and serves bf16 casts
to compute). Here a POLICY (compute dtype / variable dtype): a global
default visible to every thread, and a thread-local scope stack for
``with`` blocks; storage stays fp32 (master weights), compute reads cast
to bf16 — the split the port's models implement through their ``dtype``
configs, exposed as the reference-shaped API.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    """≙ keras mixed_precision.Policy / the bfloat16_scope contract."""
    name: str
    compute_dtype: Any
    variable_dtype: Any


POLICIES = {
    "float32": Policy("float32", torch.float32, torch.float32),
    "mixed_bfloat16": Policy("mixed_bfloat16", torch.bfloat16,
                             torch.float32),
    "bfloat16": Policy("bfloat16", torch.bfloat16, torch.bfloat16),
}

# Global default (set_global_policy: visible to ALL threads — worker
# lanes, infeed threads) + a thread-local scope stack for `with` blocks.
_GLOBAL = {"policy": POLICIES["float32"]}
_SCOPES = threading.local()


def _scope_stack() -> list:
    if not hasattr(_SCOPES, "stack"):
        _SCOPES.stack = []
    return _SCOPES.stack


def get_policy() -> Policy:
    stack = _scope_stack()
    return stack[-1] if stack else _GLOBAL["policy"]


def set_global_policy(policy: "Policy | str"):
    _GLOBAL["policy"] = (POLICIES[policy] if isinstance(policy, str)
                         else policy)


@contextlib.contextmanager
def policy_scope(policy: "Policy | str"):
    p = POLICIES[policy] if isinstance(policy, str) else policy
    _scope_stack().append(p)
    try:
        yield p
    finally:
        _scope_stack().pop()


@contextlib.contextmanager
def bfloat16_scope():
    """≙ tpu.bfloat16_scope (bfloat16.py:71): compute in bf16, variables
    stored fp32. Usage::

        with bfloat16_scope():
            y = model_fn(cast_to_compute(x), params)
    """
    with policy_scope("mixed_bfloat16") as p:
        yield p


def compute_dtype():
    return get_policy().compute_dtype


def variable_dtype():
    return get_policy().variable_dtype


def _cast_floating(tree, dt):
    """Every leaf as a tensor (``torch.as_tensor``: numpy arrays and
    Python scalars too, as ``jnp.asarray`` takes them), its floating
    leaves cast to ``dt``."""
    def cast(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(dt) if x.is_floating_point() else x

    return tree_map(cast, tree)


def cast_to_compute(tree):
    """Cast floating leaves to the active compute dtype (≙ the scope's
    custom-getter cast on variable reads)."""
    return _cast_floating(tree, compute_dtype())


def cast_to_variable(tree):
    """Cast floating leaves to the storage dtype (master copy)."""
    return _cast_floating(tree, variable_dtype())

"""Port parity: the bfloat16 policy (``utils/bfloat16.py``) against the
JAX package: the same policies, scopes that nest and restore (thread-
local, over a global default visible to every thread), and casts that
give JAX's dtype leaf by leaf, with floating leaves cast and the rest
left alone."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.utils import bfloat16 as jbf
from distributed_tensorflow_tpu_torch.utils import bfloat16 as tbf

DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _name(dt) -> str:
    return str(dt).replace("torch.", "")


def _same(t, j) -> bool:
    return _name(t) == np.dtype(j).name


def test_policies_match_jax():
    assert sorted(tbf.POLICIES) == sorted(jbf.POLICIES)
    for name, jp in jbf.POLICIES.items():
        tp = tbf.POLICIES[name]
        assert tp.name == jp.name
        assert DT[jp.compute_dtype] is tp.compute_dtype
        assert DT[jp.variable_dtype] is tp.variable_dtype


def _trace(m):
    """The (compute, variable) dtype names through nested scopes."""
    seen = [(m.compute_dtype(), m.variable_dtype())]
    with m.bfloat16_scope() as p:
        seen.append((p.name, m.compute_dtype(), m.variable_dtype()))
        with m.policy_scope("bfloat16"):
            seen.append((m.compute_dtype(), m.variable_dtype()))
            with m.policy_scope("float32"):
                seen.append((m.compute_dtype(), m.variable_dtype()))
            seen.append((m.compute_dtype(),))
        seen.append((m.compute_dtype(),))
    seen.append((m.get_policy().name,))
    try:
        with m.policy_scope("bfloat16"):
            raise KeyError("inside")
    except KeyError:
        pass
    seen.append((m.get_policy().name,))
    return [tuple(x if isinstance(x, str) else
                  (np.dtype(x).name if not isinstance(x, torch.dtype)
                   else _name(x)) for x in s) for s in seen]


def test_scopes_nest_and_restore_like_jax():
    assert _trace(tbf) == _trace(jbf)


def test_global_policy_is_seen_by_every_thread_scopes_are_not():
    for m in (tbf, jbf):
        m.set_global_policy("mixed_bfloat16")
        try:
            got = {}
            with m.policy_scope("float32"):
                t = threading.Thread(
                    target=lambda: got.update(name=m.get_policy().name))
                t.start()
                t.join()
                assert m.get_policy().name == "float32"
            assert got["name"] == "mixed_bfloat16"
        finally:
            m.set_global_policy("float32")


LEAVES = {"f32": np.ones((2, 3), np.float32),
          "f16": np.full((2,), 0.5, np.float16),
          "f64": np.asarray([1.25, -3.0]),
          "i32": np.arange(3, dtype=np.int32),
          "u8": np.arange(4, dtype=np.uint8),
          "bool": np.asarray([True, False])}


@pytest.mark.parametrize("policy", sorted(jbf.POLICIES))
@pytest.mark.parametrize("which", ["compute", "variable"])
def test_casts_give_jax_dtype_leaf_by_leaf(policy, which):
    tree = {"a": dict(LEAVES), "b": [LEAVES["f32"], (LEAVES["i32"],)]}
    jcast = getattr(jbf, f"cast_to_{which}")
    tcast = getattr(tbf, f"cast_to_{which}")
    with jbf.policy_scope(policy):
        want = jcast(tree)
    with tbf.policy_scope(policy):
        got = tcast(tree)
        got_t = tcast({k: torch.from_numpy(v) for k, v in LEAVES.items()
                       if k != "f64"})
    for k in LEAVES:
        assert _same(got["a"][k].dtype, want["a"][k].dtype), (k, policy)
        np.testing.assert_array_equal(
            got["a"][k].float().numpy() if got["a"][k].dtype ==
            torch.bfloat16 else got["a"][k].numpy(),
            np.asarray(want["a"][k]).astype(np.float32)
            if want["a"][k].dtype == jnp.bfloat16 else np.asarray(
                want["a"][k]))
        if k != "f64":
            assert got_t[k].dtype == got["a"][k].dtype, k
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    assert _same(got["b"][1][0].dtype, want["b"][1][0].dtype)

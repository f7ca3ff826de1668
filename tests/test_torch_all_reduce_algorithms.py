"""Port parity: the explicit all-reduce algorithms
(``parallel/all_reduce_algorithms.py``) on 2, 3 and 4 gloo ranks
against the JAX package's on a ``shard_map`` over as many virtual CPU
devices, one contribution a rank, made with numpy from a seed. Sizes
that need padding included (7, 37, 1001 and a (5, 3) matrix). The f32
ring and recursive halving-doubling equal JAX's bit for bit (the same
schedule adds in the same order); shuffle within 1e-6 relative; the
library's all-reduce ("xla": gloo's here, XLA's ``psum`` there, each
summing in its own order) within 2e-6 absolute, as is every result
against the f64 sum (contributions of unit scale). Halving-doubling
refuses 3 ranks, as JAX does."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from distributed_tensorflow_tpu.parallel import all_reduce_algorithms as jar
from distributed_tensorflow_tpu_torch.parallel import (
    all_reduce_algorithms as tar)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_cluster_ranks

WORLDS = (2, 3, 4)
ALGORITHMS = ("ring", "recursive_hd", "shuffle", "xla")
SHAPES = {"n7": (7,), "n37": (37,), "n1001": (1001,), "m5x3": (5, 3)}
BITWISE = ("ring", "recursive_hd")


def _contribs(n: int) -> dict:
    rng = np.random.default_rng(40 + n)
    return {name: rng.normal(size=(n,) + shape).astype(np.float32)
            for name, shape in SHAPES.items()}


def _jax(alg: str, c: np.ndarray):
    n = c.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    fn = jax.jit(jax.shard_map(
        lambda x: jar.all_reduce(x[0], "dp", algorithm=alg)[None],
        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False))
    try:
        return np.asarray(fn(c))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.fixture(scope="module")
def runs():
    out = {}
    for n in WORLDS:
        contribs = _contribs(n)
        port = multi_process_runner.run(
            torch_cluster_ranks.all_reduce_rank, n,
            args=(contribs, ALGORITHMS), device="cpu",
            timeout=240).return_values
        out[n] = (contribs, port)
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("alg", ALGORITHMS)
def test_algorithm_matches_jax(runs, n, alg):
    contribs, port = runs[n]
    for name, c in contribs.items():
        want = _jax(alg, c)
        for r, got in enumerate(port):
            g = got[(alg, name)]
            if isinstance(want, str):
                assert isinstance(g, str) and "power-of-2" in g \
                    and "power-of-2" in want, (name, g, want)
                continue
            assert g.shape == want[r].shape and g.dtype == np.float32
            if alg in BITWISE:
                np.testing.assert_array_equal(g, want[r],
                                              err_msg=f"{name} rank {r}")
            elif alg == "xla":
                np.testing.assert_allclose(g, want[r], rtol=0, atol=2e-6,
                                           err_msg=f"{name} rank {r}")
            else:
                np.testing.assert_allclose(g, want[r], rtol=1e-6, atol=0,
                                           err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_gets_the_sum(runs, n):
    contribs, port = runs[n]
    for name, c in contribs.items():
        exact = c.astype(np.float64).sum(0)
        for got in port:
            for alg in ALGORITHMS:
                g = got[(alg, name)]
                if isinstance(g, str):
                    assert alg == "recursive_hd" and n == 3
                    continue
                np.testing.assert_allclose(g, exact, rtol=0, atol=2e-6)


def test_unknown_algorithm_raises():
    import torch
    with pytest.raises(ValueError, match="algorithm"):
        tar.all_reduce(torch.ones(4), algorithm="nope")
    assert sorted(tar.ALGORITHMS) == sorted(jar.ALGORITHMS)

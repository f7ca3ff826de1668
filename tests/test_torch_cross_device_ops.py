"""Port parity: ``parallel/cross_device_ops.py`` on 4 gloo ranks against
the JAX package's on 4 virtual CPU devices (``{"dp": 4}``) and on the
hybrid ``{"dcn": 2, "dp": 2}``.

``IciAllReduce.batch_reduce`` SUM and MEAN over a mixed list (f32, bf16,
int32, another f32) with ``bytes_per_pack`` 0 (one bucket a dtype run)
and 24 (small buckets): every result keeps its dtype (bf16 is never
upcast), an integer MEAN is JAX's f32 mean cast back. ``reduce``;
``ReductionToOneDevice`` SUM, MEAN, MAX and MIN; on the hybrid mesh
``HierarchicalAllReduce`` SUM and MEAN and ``select_cross_device_ops``'
choice. Integer results and MAX/MIN compare exactly, f32 sums within
1e-6 (another reduction order); bf16 results stay bf16 and agree within
two bf16 ulps (rtol 2^-6): XLA adds the bf16 rows in f32 and rounds
once, gloo adds in bf16 (measured: 3 of 5 sums 1-2 ulps apart). Every
rank holds the result.
"""

import jax
import ml_dtypes
import numpy as np
import pytest

from distributed_tensorflow_tpu.cluster import topology
from distributed_tensorflow_tpu.parallel import cross_device_ops as jcdo
from distributed_tensorflow_tpu.parallel.collectives import (
    CommunicationOptions)
from distributed_tensorflow_tpu.parallel.values import PerReplica
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_strategy_ranks

R = 4
MESHES = ({"dp": 4}, {"dcn": 2, "dp": 2})


def _values():
    rng = np.random.default_rng(7)
    bf = rng.normal(size=(R, 5)).astype(ml_dtypes.bfloat16)
    return {"f32": rng.normal(size=(R, 3, 4)).astype(np.float32),
            "f32b": rng.normal(size=(R, 7)).astype(np.float32),
            "i32": rng.integers(-50, 50, size=(R, 6)).astype(np.int32),
            "zbf16": bf}


VALUES = _values()


def _wire(values):
    return {k: (v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v)
            for k, v in values.items()}


def _res(m):
    v = np.asarray(m.values[0])
    return {"bf16": v.view(np.int16)} if v.dtype == ml_dtypes.bfloat16 else v


def jax_checks(axes: dict) -> dict:
    mesh = topology.make_mesh(axes, devices=jax.devices()[:R])
    names = tuple(axes)
    out = {}

    def pr(a):
        return PerReplica([a[i] for i in range(R)])
    for bpp in (0, 24):
        ops = jcdo.IciAllReduce(mesh, names,
                                CommunicationOptions(bytes_per_pack=bpp))
        for op in ("sum", "mean"):
            got = ops.batch_reduce(op, [pr(VALUES[k])
                                        for k in sorted(VALUES)])
            for k, m in zip(sorted(VALUES), got):
                out[f"ici/{bpp}/{op}/{k}"] = _res(m)
        out[f"ici/{bpp}/reduce_sum"] = _res(ops.reduce("sum",
                                                       pr(VALUES["f32"])))
    one = jcdo.ReductionToOneDevice(mesh, names)
    for op in ("sum", "mean", "max", "min"):
        out[f"one/{op}"] = _res(one.reduce(op, pr(VALUES["f32"])))
    if len(names) == 2:
        h = jcdo.HierarchicalAllReduce(mesh, names)
        for op in ("sum", "mean"):
            out[f"hier/{op}"] = _res(h.reduce(op, pr(VALUES["f32"])))
        out["selected"] = type(jcdo.select_cross_device_ops(
            mesh, names)).__name__
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {str(a): jax_checks(a) for a in MESHES}


@pytest.fixture(scope="module")
def port_ranks():
    return multi_process_runner.run(
        torch_strategy_ranks.cross_device_rank, R,
        args=(_wire(VALUES), list(MESHES)), device="cpu",
        timeout=300).return_values


def _keys():
    out = []
    for a in MESHES:
        for bpp in (0, 24):
            for op in ("sum", "mean"):
                out += [(str(a), f"ici/{bpp}/{op}/{k}") for k in sorted(VALUES)]
            out.append((str(a), f"ici/{bpp}/reduce_sum"))
        out += [(str(a), f"one/{op}") for op in ("sum", "mean", "max", "min")]
    out += [(str(MESHES[1]), k) for k in ("hier/sum", "hier/mean",
                                          "selected")]
    return out


@pytest.mark.parametrize("mesh,key", _keys())
def test_cross_device_ops_match_jax(port_ranks, jax_runs, mesh, key):
    want = jax_runs[mesh][key]
    for r in port_ranks:
        got = r[mesh][key]
        if isinstance(want, str):
            assert got == want
            continue
        if isinstance(want, dict):
            assert r[mesh][f"{key}/dtype"] == "torch.bfloat16"
            g, w = (np.asarray(d["bf16"]).view(ml_dtypes.bfloat16)
                    .astype(np.float32) for d in (got, want))
            np.testing.assert_allclose(g, w, rtol=2 ** -6, atol=0,
                                       err_msg=key)
            continue
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if got.dtype.kind in "iu" or key.endswith(("max", "min")):
            np.testing.assert_array_equal(got, want, key)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=key)

"""The port's strategy conformance suite (``testing/
strategy_conformance.py``): its checks are JAX's 26 by name, and every
one passes for ``OneDeviceStrategy`` and ``MirroredStrategy`` on the
CPU in this process, for the built-in strategies that make a process
group (MultiWorker, CentralStorage, the parameter-server strategies V1
and V2) in one spawned gloo rank, and for all those and Mirrored inside
each of 2 gloo ranks (a replica is a rank). A check a strategy does not
implement would be listed, not swallowed: none is."""

import pytest

from distributed_tensorflow_tpu.testing.strategy_conformance import (
    StrategyConformance as JaxConformance)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner
from distributed_tensorflow_tpu_torch.testing.strategy_conformance import (
    BUILTIN, StrategyConformance, check_builtin)

import torch_conformance_ranks

RANKED = ("Mirrored", "MultiWorker", "CentralStorage", "ParameterServerV1",
          "ParameterServerV2")
#: kinds that need no process group, run in this process
IN_PROCESS = ("OneDevice", "Mirrored")


def test_check_names_equal_jax():
    want = sorted(m for m in dir(JaxConformance) if m.startswith("check_"))
    assert StrategyConformance.contract_checks() == want and len(want) == 26


def _all_pass(res):
    assert res["failures"] == [] and res["not_implemented"] == []
    assert res["passed"] == StrategyConformance.contract_checks()


@pytest.mark.parametrize("kind", IN_PROCESS)
def test_every_check_passes_in_this_process(kind):
    import torch.distributed as dist
    _all_pass(check_builtin([kind], device="cpu")[kind])
    assert not dist.is_initialized()


def _ranks(n, kinds):
    return multi_process_runner.run(
        torch_conformance_ranks.conformance_rank, n, args=(kinds,),
        device="cpu", timeout=240).return_values


@pytest.fixture(scope="module")
def one_rank():
    return _ranks(1, [k for k in BUILTIN if k not in IN_PROCESS])[0]


@pytest.fixture(scope="module")
def two_ranks():
    return _ranks(2, RANKED)


@pytest.mark.parametrize("kind", [k for k in BUILTIN if k not in IN_PROCESS])
def test_every_check_passes_on_one_gloo_rank(one_rank, kind):
    assert one_rank["world"] == 1
    _all_pass(one_rank["results"][kind])


@pytest.mark.parametrize("kind", RANKED)
def test_every_check_passes_on_two_gloo_ranks(two_ranks, kind):
    assert [r["rank"] for r in two_ranks] == [0, 1]
    for r in two_ranks:
        _all_pass(r["results"][kind])


class TestOneDeviceConformance(StrategyConformance):
    """The suite as a pytest class, as JAX's tests use it."""

    def make_strategy(self):
        from distributed_tensorflow_tpu_torch.parallel.one_device import (
            OneDeviceStrategy)
        return OneDeviceStrategy("cpu")

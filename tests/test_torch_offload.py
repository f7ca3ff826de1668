"""Port: the host-offloaded 1F1B stash (``parallel/offload.py``), as
``tests/test_offload.py`` holds JAX's, on ``{"pp": 2}`` (2 gloo ranks).

- Spilling the stash to the host (``offload_activations=True``) and
  keeping it on the card through the same loop (``"device"``) are
  bitwise equal after 2 steps, and both bitwise equal to plain 1F1B;
  the stage-0 rank spills its 4 inputs a step (the last stage reads
  its own), one ``offload.step`` event a step.
- One injected ``offload.spill`` failure at cycle 3 of the last step
  is absorbed by the retry: bitwise the fault-free run.
- Both attempts failing surfaces ``OffloadSpillError`` naming cycle 3 on
  the rank whose backward needs the input, and the run ends at once
  (its peer's wait ends with it), never at the timeout.
- The store alone: put / get / drop_through, a missing entry.
- The stash's parity with JAX's step is ``tests/test_torch_pp_train.py``'s
  1F1B cases (the same loop without the store).
"""

import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.transformer import (
    TransformerConfig as JConfig, synthetic_tokens)
from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerConfig, TransformerLM, init_params)
from distributed_tensorflow_tpu_torch.parallel.offload import (
    ActivationSpillStore, OffloadSpillError)
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_dp_ranks
import torch_pp_ranks

STEPS = 2


@pytest.fixture(scope="module")
def case():
    cfg = TransformerConfig.tiny(n_layers=torch_pp_ranks.N_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    init = torch_dp_ranks._np_params(TransformerLM(cfg, params,
                                                   device="cpu"))
    tokens = np.asarray(synthetic_tokens(
        torch_pp_ranks.GB, JConfig.tiny().max_seq_len,
        JConfig.tiny().vocab_size, seed=3)).astype(np.int64)
    return init, tokens


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    init, tokens = case
    return multi_process_runner.run(
        torch_pp_ranks.offload_rank, 2,
        args=(init, tokens, STEPS,
              str(tmp_path_factory.mktemp("offload_events"))),
        device="cpu", timeout=300).return_values


def _equal(a, b):
    return a["losses"] == b["losses"] and all(
        np.array_equal(v, b["params"][k]) for k, v in a["params"].items())


def test_offload_on_off_bitwise(ranks):
    for r in ranks:
        runs = r["runs"]
        assert _equal(runs["spill"], runs["device"])
        assert _equal(runs["spill"], runs["plain"])
        assert runs["plain"]["stats"]["offload"] is None
        spill = runs["spill"]["stats"]["offload"]
        device = runs["device"]["stats"]["offload"]
        n_in = torch_pp_ranks.N_MICRO if r["rank"] == 0 else 0
        mb_bytes = (torch_pp_ranks.GB // torch_pp_ranks.N_MICRO
                    * JConfig.tiny().max_seq_len * JConfig.tiny().d_model
                    * 4)
        assert spill == {"cycles": torch_pp_ranks.N_MICRO + 2, "puts": n_in,
                         "retries": 0, "failures": 0,
                         "spilled_bytes": n_in * mb_bytes,
                         "resident_entries": 0}
        assert device == {**spill, "spilled_bytes": 0}
        # one offload.step event a step of each offloaded run
        assert [e["spill"] for e in r["events"]] == \
            [True] * STEPS + [False] * STEPS + [True] * STEPS
        assert r["events"][0]["puts"] == n_in


def test_offload_spill_fault_retries_bitwise(ranks):
    for r in ranks:
        runs = r["runs"]
        assert _equal(runs["retry"], runs["spill"])
        if r["rank"] == 0:
            assert [e[:2] for e in runs["retry"]["fired"]] == [
                ("offload.spill", "c3")]
            assert runs["retry"]["stats"]["offload"]["retries"] == 1
        else:
            # the last stage spills nothing, so nothing fires there
            assert runs["retry"]["fired"] == []


def test_offload_double_spill_failure_raises_cleanly(case):
    init, tokens = case
    t0 = time.monotonic()
    with pytest.raises(multi_process_runner.SubprocessError) as err:
        multi_process_runner.run(torch_pp_ranks.double_fault_rank, 2,
                                 args=(init, tokens), device="cpu",
                                 timeout=240)
    assert time.monotonic() - t0 < 120
    rank0 = err.value.mpr_result.tasks[("worker", 0)].error
    assert "OffloadSpillError" in rank0 and "cycle 3" in rank0, rank0


def test_spill_store_unit():
    store = ActivationSpillStore(spill=True)
    value = torch.tensor([1.0, 2.0])
    store.put(0, value)
    got = store.get(0)
    assert torch.equal(got, value) and got.data_ptr() != value.data_ptr()
    assert store.spilled_bytes == 8 and len(store) == 1
    store.drop_through(0)
    with pytest.raises(OffloadSpillError, match="missing"):
        store.get(0)
    kept = ActivationSpillStore(spill=False)
    kept.put(5, value)
    assert kept.get(5) is value and kept.spilled_bytes == 0
    assert kept.stats(6) == {"cycles": 6, "puts": 1, "retries": 0,
                             "failures": 0, "spilled_bytes": 0,
                             "resident_entries": 1}

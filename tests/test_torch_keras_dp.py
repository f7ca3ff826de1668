"""Port parity: the Keras shim on 2 gloo ranks (``MirroredStrategy``
over the group, one replica a rank) against the JAX package's
``MirroredStrategy`` over 2 virtual CPU devices.

The MNIST Sequential under Adam (the bucketed gradient all-reduce
launched from the backward) and the functional ResNet stack with
BatchNorm under SGD (statistics of the global batch, all-reduced inside
the layer), from JAX's initial weights, 2 epochs at global batch 8 on
37 rows: the final batch has 5 real rows, so rank 0 holds 4 and rank 1
one real and three padded — the loss must be the global weighted mean
(never a mean of the ranks' means) and the padded batch must leave the
running statistics alone. Every rank's history (losses within 2e-6,
accuracies equal), weights, ``evaluate`` and ``predict`` (every row, on
every rank) and BatchNorm statistics match JAX's within
``tests/test_torch_keras.py``'s tolerances.
"""

import jax
import pytest

import distributed_tensorflow_tpu as dtx
from distributed_tensorflow_tpu import keras as jk
from distributed_tensorflow_tpu_torch.testing import multi_process_runner

import torch_keras_ranks as kr
from test_torch_keras import _check

CASES = [("mnist", "adam"), ("resnet", "sgd")]


@pytest.fixture(scope="module")
def runs():
    js = dtx.MirroredStrategy(devices=jax.devices()[:2])
    weights, want = {}, []
    for kind, opt in CASES:
        with js.scope():
            weights[kind] = kr.build(jk, kind).get_weights()
        want.append(kr.fit_case(jk, js, kind, opt, weights[kind]))
    got = multi_process_runner.run(kr.keras_dp_rank, 2,
                                   args=(CASES, weights), device="cpu",
                                   timeout=300).return_values
    return got, want


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("rank", range(2))
def test_two_replicas_match_jax(runs, case, rank):
    got, want = runs
    _check(got[rank][case], want[case])

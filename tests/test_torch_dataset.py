"""Port parity: ``input/dataset.py``'s ``Dataset`` against the JAX
package's, transformation by transformation, on the same numpy-seeded
elements. Every element stream must equal JAX's exactly (the same
nesting, dtypes, shapes and values): sources, ``map`` (serial, a pool
of 3, AUTOTUNE), ``filter``, ``shuffle(seed)``, ``batch``,
``padded_batch``, ``repeat``, ``take``, ``skip``, ``shard``,
``shard_files`` / ``replay_spec``, ``interleave`` (serial and
parallel), ``flat_map``, ``unbatch``, ``window``,
``bucket_by_sequence_length``, ``zip``, ``cache``, ``prefetch``,
``cardinality`` and ``auto_shard_dataset`` under every policy. The
``input.prefetch`` fault site fires through the port's
``resilience/faults.py``. (Each rank's distributed batch is held to
JAX's replica shard in ``test_torch_strategy.py``.)
"""

import numpy as np
import pytest

from distributed_tensorflow_tpu.input import dataset as jd
from distributed_tensorflow_tpu_torch.input import dataset as td

RNG = np.random.default_rng(11)
IMAGES = RNG.normal(size=(23, 3, 2)).astype(np.float32)
LABELS = RNG.integers(0, 5, size=23).astype(np.int32)
LENGTHS = RNG.integers(1, 9, size=19)
SEQS = [np.arange(n, dtype=np.int32) + i for i, n in enumerate(LENGTHS)]


def _reader(path):
    base = int(path.split("_")[-1])
    for i in range(3):
        yield {"v": np.int32(base * 10 + i), "x": np.float32(base + i / 4)}


FILES = [f"file_{i}" for i in range(5)]


def _pipelines(m):
    """name -> Dataset of module ``m`` (the JAX or the port's)."""
    D = m.Dataset
    sl = lambda: D.from_tensor_slices({"image": IMAGES,  # noqa: E731
                                       "label": LABELS})
    seqs = lambda: D.from_generator(lambda: iter(SEQS))  # noqa: E731
    ds = {
        "slices": sl(),
        "tuple_slices": D.from_tensor_slices((IMAGES, LABELS)),
        "range": D.range(3, 17, 2),
        "generator": seqs(),
        "map": sl().map(lambda e: {"s": e["image"].sum(), "l": e["label"]}),
        "map_parallel": sl().map(lambda e: e["image"] * 2,
                                 num_parallel_calls=3),
        "map_autotune": D.range(20).map(lambda i: np.int64(i * i),
                                        num_parallel_calls=m.AUTOTUNE),
        "filter": D.range(30).filter(lambda i: i % 3 == 1),
        "shuffle": D.range(40).shuffle(7, seed=5),
        "shuffle_big": sl().shuffle(100, seed=2),
        "batch": sl().batch(5),
        "batch_drop": sl().batch(5, drop_remainder=True),
        "padded_batch": seqs().padded_batch(4),
        "padded_batch_shapes": seqs().map(lambda s: (s, s[:1])).padded_batch(
            3, padded_shapes=([10], [None]), padding_values=(-1, 7)),
        "repeat": D.range(4).repeat(3),
        "take_skip": D.range(30).skip(4).take(9),
        "shard": D.range(25).shard(4, 1),
        "shard_files": D.from_files(FILES, _reader).map(
            lambda e: e["v"] + 1).batch(2).shard_files(2, 1),
        "interleave": D.range(5).interleave(
            lambda i: D.range(i * 10, i * 10 + (i % 3) + 1),
            cycle_length=3, block_length=2),
        "interleave_parallel": D.range(6).interleave(
            lambda i: D.range(i * 10, i * 10 + 4), cycle_length=4,
            block_length=1, num_parallel_calls=2),
        "flat_map": D.range(4).flat_map(lambda i: D.range(i)),
        "unbatch": sl().batch(4).unbatch(),
        "window": D.range(11).window(4, shift=3, stride=2).flat_map(
            lambda w: w.batch(4)),
        "window_drop": D.range(11).window(3, drop_remainder=True).flat_map(
            lambda w: w.batch(3)),
        "bucket": seqs().bucket_by_sequence_length(
            len, [3, 6], [2, 3, 2]),
        "bucket_pad": seqs().bucket_by_sequence_length(
            len, [4, 10], [3, 2, 2], pad_to_bucket_boundary=True),
        "zip": D.zip(D.range(6), sl()),
        "cache": sl().map(lambda e: e["label"]).cache().repeat(2),
        "prefetch": sl().batch(3).prefetch(2),
        "auto_file": m.auto_shard_dataset(
            D.from_files(FILES, _reader), 2, 0, m.AutoShardPolicy.FILE),
        "auto_data": m.auto_shard_dataset(D.range(13), 3, 2,
                                          m.AutoShardPolicy.DATA),
        "auto_auto": m.auto_shard_dataset(
            D.from_files(FILES, _reader).map(lambda e: e["x"]), 4, 3),
        "auto_off": m.auto_shard_dataset(D.range(5), 3, 1,
                                         m.AutoShardPolicy.OFF),
    }
    return ds


def _norm(x):
    """An element as plain nests of numpy arrays, for equality."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, (int, np.integer, float, np.floating, np.ndarray)):
        a = np.asarray(x)
        return (a.dtype.str, a.shape, a.tobytes())
    return x


NAMES = sorted(_pipelines(jd))


@pytest.mark.parametrize("name", NAMES)
def test_element_stream_matches_jax(name):
    want = [_norm(e) for e in _pipelines(jd)[name]]
    got = [_norm(e) for e in _pipelines(td)[name]]
    assert got == want
    assert len(got) > 0


@pytest.mark.parametrize("name", ["slices", "batch", "batch_drop", "repeat",
                                  "map", "shuffle", "zip", "cache"])
def test_cardinality_matches_jax(name):
    assert (_pipelines(td)[name].cardinality()
            == _pipelines(jd)[name].cardinality())


def test_replay_spec_and_input_context_match_jax():
    for m in (jd, td):
        files, _, chain = m.Dataset.from_files(FILES, _reader).map(
            lambda e: e).batch(2).replay_spec()
        assert files == FILES and len(chain) == 2
    a, b = jd.InputContext(2, 1, 4), td.InputContext(2, 1, 4)
    assert (a.get_per_replica_batch_size(16)
            == b.get_per_replica_batch_size(16) == 4)
    with pytest.raises(ValueError):
        b.get_per_replica_batch_size(10)
    with pytest.raises(ValueError):
        td.Dataset.range(4).shard(2, 2)


def test_prefetch_fault_site_fires_through_the_ports_faults():
    from distributed_tensorflow_tpu_torch.resilience import faults
    ds = td.Dataset.range(10).prefetch(2, name="chaos")
    with faults.inject(faults.FaultSchedule(rules=(faults.FaultRule(
            "input.prefetch", action="raise", hits=(4,)),))):
        with pytest.raises(faults.FaultInjected):
            list(ds)
    assert [int(x) for x in ds] == list(range(10))
    stats = ds.pipeline_stats()
    assert stats and stats[-1]["name"] == "prefetch:chaos"

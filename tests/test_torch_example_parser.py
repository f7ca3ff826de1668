"""Port parity: tf.Example parsing and encoding
(``input/example_parser.py``) against the JAX package on the same
numpy-seeded features. Encodings are byte-equal; every feature kind
(FixedLen, VarLen, FixedLenSequence, Sparse, Ragged with each partition)
parses to equal values and dtypes, each package's bytes through the
other's parser; sequence examples likewise; ``iter_tfrecords`` and
``example_reader`` read plain, GZIP and ZLIB files alike and refuse the
same corrupt input."""

import numpy as np
import pytest

from distributed_tensorflow_tpu.input import example_parser as jep
from distributed_tensorflow_tpu.input import native_loader as jnl
from distributed_tensorflow_tpu_torch.input import example_parser as tep
from distributed_tensorflow_tpu_torch.input import native_loader as tnl

RNG = np.random.default_rng(22)


def _features(i: int) -> dict:
    n = int(RNG.integers(0, 6))
    return {
        "dense": RNG.normal(size=(2, 3)).astype(np.float32),
        "ids": RNG.integers(-2**40, 2**40, size=(4,)),
        "flag": np.asarray([i % 2 == 0]),
        "name": f"item-{i}".encode(),
        "tags": [b"a", "bé", np.bytes_(b"c")][: 1 + i % 3],
        "var": RNG.normal(size=(n,)).astype(np.float32),
        "sp_idx": RNG.permutation(10)[:n].astype(np.int64),
        "sp_val": RNG.normal(size=(n,)).astype(np.float32),
        "lens": np.asarray([n, 0], np.int64),
        "splits": np.asarray([0, n], np.int64),
        "starts": np.asarray([0, 0], np.int64),
        "limits": np.asarray([0, n], np.int64),
        "rowids": np.zeros(n, np.int64),
        "uniform": RNG.normal(size=(4,)).astype(np.float32),
        "empty_f": np.zeros((0,), np.float32),
    }


def _spec(m):
    RF = m.RaggedFeature
    return {
        "dense": m.FixedLenFeature((2, 3), np.float32),
        "ids": m.FixedLenFeature((4,), np.int64),
        "flag": m.FixedLenFeature((), np.int64),
        "name": m.FixedLenFeature((), object),
        "missing": m.FixedLenFeature((2,), np.float32, default_value=1.5),
        "tags": m.VarLenFeature(object),
        "var": m.VarLenFeature(np.float32),
        "sparse": m.SparseFeature("sp_idx", "sp_val", np.float32, 10),
        "ragged": RF(np.float32, value_key="var"),
        "r_lens": RF(np.float32, value_key="var",
                     partitions=(RF.RowLengths("lens"),)),
        "r_splits": RF(np.float32, value_key="var",
                       partitions=(RF.RowSplits("splits"),)),
        "r_starts": RF(np.float32, value_key="var",
                       partitions=(RF.RowStarts("starts"),)),
        "r_limits": RF(np.float32, value_key="var",
                       partitions=(RF.RowLimits("limits"),)),
        "r_rowids": RF(np.float32, value_key="var",
                       partitions=(RF.ValueRowIds("rowids"),)),
        "r_uniform": RF(np.float32, value_key="uniform",
                        partitions=(RF.UniformRowLength(2),)),
        "empty_f": m.VarLenFeature(np.float32),
    }


EXAMPLES = [_features(i) for i in range(6)]


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got).__name__ == type(want).__name__ and \
            len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif hasattr(want, "nested_row_splits"):          # RaggedValue
        _assert_same(got.values, want.values, where)
        _assert_same(list(got.nested_row_splits),
                     list(want.nested_row_splits), where)
    elif hasattr(want, "dense_shape"):                # SparseValue
        _assert_same(got.indices, want.indices, where)
        _assert_same(got.values, want.values, where)
        assert got.dense_shape == want.dense_shape, where
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("i", range(len(EXAMPLES)))
def test_encode_is_byte_equal_and_parses_both_ways(i):
    feats = EXAMPLES[i]
    blob = tep.encode_example(feats)
    assert blob == jep.encode_example(feats)
    want = jep.parse_single_example(blob, _spec(jep))
    _assert_same(tep.parse_single_example(blob, _spec(tep)), want)
    # the port's values as the port's dataclasses, JAX's as JAX's
    got = tep.parse_single_example(blob, _spec(tep))
    assert type(got["sparse"]).__module__ == tep.__name__
    assert got["r_lens"].to_list() == want["r_lens"].to_list()
    np.testing.assert_array_equal(got["sparse"].to_dense(),
                                  want["sparse"].to_dense())


def test_parse_example_batches_like_jax():
    blobs = [jep.encode_example(f) for f in EXAMPLES]
    spec = {k: v for k, v in _spec(jep).items()
            if k in ("dense", "ids", "var", "missing")}
    tspec = {k: v for k, v in _spec(tep).items() if k in spec}
    _assert_same(tep.parse_example(blobs, tspec),
                 jep.parse_example(blobs, spec))


def test_sequence_examples_match_jax():
    ctx = {"user": np.asarray([7], np.int64),
           "score": np.asarray([0.5], np.float32)}
    lists = {"clicks": [RNG.integers(0, 9, size=(3,)) for _ in range(4)],
             "dwell": [RNG.normal(size=(int(n),)).astype(np.float32)
                       for n in RNG.integers(0, 4, size=5)],
             "words": [[b"x", b"yy"], [b"z"]]}
    blob = tep.encode_sequence_example(ctx, lists)
    assert blob == jep.encode_sequence_example(ctx, lists)

    def specs(m):
        return ({"user": m.FixedLenFeature((), np.int64),
                 "score": m.VarLenFeature(np.float32),
                 "absent": m.FixedLenFeature((), np.int64,
                                             default_value=-1)},
                {"clicks": m.FixedLenSequenceFeature((3,), np.int64),
                 "dwell": m.VarLenFeature(np.float32),
                 "words": m.RaggedFeature(object),
                 "none": m.FixedLenSequenceFeature(
                     (2,), np.float32, allow_missing=True)})
    _assert_same(tep.parse_single_sequence_example(blob, *specs(tep)),
                 jep.parse_single_sequence_example(blob, *specs(jep)))
    _assert_same(tep.parse_sequence_example([blob, blob], *specs(tep)),
                 jep.parse_sequence_example([blob, blob], *specs(jep)))


def test_refusals_match_jax():
    blob = jep.encode_example(EXAMPLES[0])
    cases = [
        (lambda m: m.parse_single_example(
            blob, {"x": m.FixedLenFeature((), np.float32)}), ValueError),
        (lambda m: m.parse_single_example(
            blob, {"dense": m.FixedLenFeature((5,), np.float32)}),
         ValueError),
        (lambda m: m.parse_single_example(blob[:-3], {}), ValueError),
        (lambda m: m.encode_example({"e": []}), ValueError),
        (lambda m: m.parse_single_example(
            blob, {"bad": m.SparseFeature("ids", "dense", np.float32, 3)}),
         ValueError),
        (lambda m: m.parse_single_example(
            blob, {"r": m.RaggedFeature(
                np.float32, value_key="var",
                partitions=(m.RaggedFeature.UniformRowLength(0),))}),
         ValueError),
    ]
    for fn, err in cases:
        msgs = []
        for m in (jep, tep):
            with pytest.raises(err) as e:
                fn(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("comp", [None, "GZIP", "ZLIB"])
def test_iter_tfrecords_and_example_reader_match_jax(tmp_path, comp):
    blobs = [jep.encode_example(f) for f in EXAMPLES]
    path = str(tmp_path / "ex.tfrecord")
    tnl.write_tfrecords(path, blobs, compression=comp)
    assert list(tep.iter_tfrecords(path)) == list(jep.iter_tfrecords(path))
    assert list(tep.iter_tfrecords(path)) == blobs
    spec = {"dense": (2, 3), "ids": (4,)}
    tspec = {k: tep.FixedLenFeature(s, np.float32 if k == "dense"
                                    else np.int64) for k, s in spec.items()}
    jspec = {k: jep.FixedLenFeature(s, np.float32 if k == "dense"
                                    else np.int64) for k, s in spec.items()}
    _assert_same(list(tep.example_reader(tspec)(path)),
                 list(jep.example_reader(jspec)(path)))


def test_plain_file_with_compression_magic_and_corruption(tmp_path):
    """A plain TFRecord whose first length bytes look like a zlib header
    is read as plain by both; a flipped payload byte raises in both."""
    blob = b"\x00" * 0x178          # length 0x178: bytes 0x78 0x01 ...
    path = str(tmp_path / "magic.tfrecord")
    jnl.write_tfrecords(path, [blob])
    assert open(path, "rb").read(2) == b"\x78\x01"
    assert list(tep.iter_tfrecords(path)) == list(jep.iter_tfrecords(path))
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    msgs = []
    for m in (jep, tep):
        with pytest.raises(ValueError, match="crc") as e:
            list(m.iter_tfrecords(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

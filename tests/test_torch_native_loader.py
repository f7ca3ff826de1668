"""Port parity: the native record and TFRecord loaders
(``input/native_loader.py`` over the port's own ``native/pipeline.cc``)
against the JAX package's on the same files. Batches, row lengths,
epochs, batch counts and shard partitions are exactly JAX's across
shuffle seeds, shards, thread counts, ``drop_remainder``, and GZIP and
ZLIB files; a corrupt record raises in both. The port builds its own
library under ``build/torch_native/`` and never builds, loads or writes
the JAX package's."""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_tensorflow_tpu.input import native_loader as jnl
from distributed_tensorflow_tpu.utils.summary import tfrecord_frame
from distributed_tensorflow_tpu_torch.input import native_loader as tnl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM = 70, 3
REC = np.dtype([("x", "<f4", (DIM,)), ("label", "<i4")])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    arr = np.zeros(N, REC)
    arr["x"] = rng.normal(size=(N, DIM)).astype(np.float32)
    arr["label"] = np.arange(N, dtype=np.int32)
    out = {"records": [], "tfrecords": {}}
    for i, part in enumerate(np.array_split(arr, 2)):
        p = str(d / f"rec-{i}.bin")
        tnl.write_records(p, part)
        out["records"].append(p)
    payloads = [rng.bytes(int(n)) for n in rng.integers(1, 90, size=N)]
    for comp in (None, "GZIP", "ZLIB"):
        paths = []
        for i, part in enumerate((payloads[:37], payloads[37:])):
            p = str(d / f"tf-{comp}-{i}.tfrecord")
            tnl.write_tfrecords(p, part, compression=comp)
            jp = p + ".jax"
            jnl.write_tfrecords(jp, part, compression=comp)
            if comp != "GZIP":      # gzip stamps a time into its header
                assert open(p, "rb").read() == open(jp, "rb").read()
            paths.append(p)
        out["tfrecords"][comp] = paths
    out["payloads"] = payloads
    return out


def _drain(ds, n_batches):
    return [ds.next_batch() for _ in range(n_batches)]


RECORD_CASES = [
    dict(shuffle=False, seed=0, num_threads=1, num_shards=1, shard_index=0,
         drop_remainder=True),
    dict(shuffle=True, seed=7, num_threads=4, num_shards=1, shard_index=0,
         drop_remainder=True),
    dict(shuffle=True, seed=123, num_threads=2, num_shards=3,
         shard_index=1, drop_remainder=False),
    dict(shuffle=True, seed=5, num_threads=3, num_shards=2, shard_index=0,
         drop_remainder=False),
]


@pytest.mark.parametrize("case", range(len(RECORD_CASES)))
def test_record_batches_equal_jax(files, case):
    kw = RECORD_CASES[case]
    j = jnl.NativeRecordDataset(files["records"], REC, (), 8, **kw)
    t = tnl.NativeRecordDataset(files["records"], REC, (), 8, **kw)
    assert (t.num_records, t.batches_per_epoch) == (j.num_records,
                                                    j.batches_per_epoch)
    n = 2 * j.batches_per_epoch + 1
    for (ja, je), (ta, te) in zip(_drain(j, n), _drain(t, n)):
        assert je == te and ta.dtype == ja.dtype
        np.testing.assert_array_equal(ta, ja)
    j.close()
    t.close()


def test_record_shards_partition_like_jax(files):
    for shards in (2, 3):
        got, want = [], []
        for s in range(shards):
            for mod, out in ((jnl, want), (tnl, got)):
                ds = mod.NativeRecordDataset(
                    files["records"], REC, (), 4, shuffle=True, seed=3,
                    num_shards=shards, shard_index=s, drop_remainder=False)
                out.append(np.concatenate(
                    [b for b, _ in _drain(ds, ds.batches_per_epoch)]))
                ds.close()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        labels = np.sort(np.concatenate([g["label"] for g in got]))
        np.testing.assert_array_equal(labels, np.arange(N))


TFRECORD_CASES = [
    (comp, kw) for comp in (None, "GZIP", "ZLIB") for kw in (
        dict(shuffle=False, seed=0, num_threads=1, drop_remainder=False),
        dict(shuffle=True, seed=11, num_threads=4, num_shards=2,
             shard_index=1, drop_remainder=True))]


@pytest.mark.parametrize("case", range(len(TFRECORD_CASES)),
                         ids=lambda i: f"{TFRECORD_CASES[i][0]}-{i % 2}")
def test_tfrecord_batches_equal_jax(files, case):
    comp, kw = TFRECORD_CASES[case]
    paths = files["tfrecords"][comp]
    j = jnl.NativeTFRecordDataset(paths, 6, **kw)
    t = tnl.NativeTFRecordDataset(paths, 6, **kw)
    assert (t.num_records, t.batches_per_epoch, t.row_bytes) == (
        j.num_records, j.batches_per_epoch, j.row_bytes)
    n = 2 * j.batches_per_epoch
    for (jr, jl, je), (tr, tl, te) in zip(_drain(j, n), _drain(t, n)):
        assert je == te
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
    recs, _ = t.next_records()
    assert all(r in files["payloads"] for r in recs)
    j.close()
    t.close()


def test_corruption_raises_in_both(tmp_path):
    payloads = [bytes([i]) * 16 for i in range(8)]
    framed = bytearray(b"".join(tfrecord_frame(p) for p in payloads))
    framed[20] ^= 0xFF                           # one payload byte
    plain, gz = str(tmp_path / "bad.tfrecord"), str(tmp_path / "bad.gz")
    open(plain, "wb").write(bytes(framed))
    open(gz, "wb").write(gzip.compress(bytes(framed)))
    for path in (plain, gz):
        for mod in (jnl, tnl):
            ds = mod.NativeTFRecordDataset([path], batch_size=4,
                                           shuffle=False, verify_crc=True)
            with pytest.raises(ValueError, match="crc|IO error"):
                for _ in range(3):
                    ds.next_records()
            ds.close()
    framed2 = bytearray(b"".join(tfrecord_frame(p) for p in payloads))
    framed2[0:8] = (10 ** 12).to_bytes(8, "little")   # length field
    bad2 = str(tmp_path / "bad2.tfrecord")
    open(bad2, "wb").write(bytes(framed2))
    for mod in (jnl, tnl):
        with pytest.raises(ValueError, match="corrupt|framing"):
            mod.NativeTFRecordDataset([bad2], batch_size=2,
                                      verify_crc=False)
        with pytest.raises(FileNotFoundError):
            mod.NativeRecordDataset([str(tmp_path / "nope")], REC, (), 2)


def _native_state():
    so = jnl._SO_PATH
    status = subprocess.run(
        ["git", "status", "--porcelain", "--",
         "distributed_tensorflow_tpu/native"], cwd=ROOT,
        capture_output=True, text=True).stdout
    return (os.path.getmtime(so), open(so, "rb").read(), status)


def test_port_builds_its_own_library_and_never_the_jax_one(tmp_path):
    """In a fresh interpreter the port builds (or finds) its library
    under build/torch_native/, reads a file with it, and neither maps
    nor touches the JAX package's ``libdtx_pipeline.so``."""
    code = f"""
import json, sys
import numpy as np
from distributed_tensorflow_tpu_torch.input import native_loader as nl
path = {str(tmp_path / "r.bin")!r}
nl.write_records(path, np.arange(12, dtype=np.float32))
ds = nl.NativeRecordDataset(path, np.float32, (), 4, shuffle=False)
batch, _ = ds.next_batch()
maps = open("/proc/self/maps").read()
print(json.dumps({{"lib": nl.library_path(), "batch": batch.tolist(),
                  "mapped": [l.split()[-1] for l in maps.splitlines()
                             if "dtx_pipeline" in l],
                  "jax": [m for m in sys.modules
                          if m.split(".")[0] in ("jax",
                                                 "distributed_tensorflow_tpu")]}}))
"""
    before = _native_state()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["batch"] == [0.0, 1.0, 2.0, 3.0]
    build = os.path.join(ROOT, "build", "torch_native")
    assert os.path.dirname(res["lib"]) == build
    assert set(res["mapped"]) == {res["lib"]}
    assert res["jax"] == []
    assert _native_state() == before

"""Port parity: the host image ops (``input/image_ops.py``) against the
JAX package on the same seeded images. The codec, flips, crops,
``resize_bilinear``, ``Rescaling`` and the stateless ``RandomFlip`` /
``RandomCrop`` are bit-equal; ``generate_jpeg_directory`` writes the same
bytes; ``jpeg_pipeline`` and the native-loader ``jpeg_tfrecord_pipeline``
give batches equal to JAX's at 1 and 4 map workers."""

import os

import numpy as np
import pytest

from distributed_tensorflow_tpu.input import image_ops as jio
from distributed_tensorflow_tpu.input.dataset import AUTOTUNE
from distributed_tensorflow_tpu_torch.input import image_ops as tio

RNG = np.random.default_rng(5)
IMG = RNG.integers(0, 256, size=(37, 45, 3), dtype=np.uint8)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_codec_matches_jax():
    for q in (75, 95):
        blob = tio.encode_jpeg(IMG, quality=q)
        assert blob == jio.encode_jpeg(IMG, quality=q)
        for ch in (1, 3):
            _eq(tio.decode_jpeg(blob, ch), jio.decode_jpeg(blob, ch))
    gray = IMG[:, :, :1]
    assert tio.encode_jpeg(gray) == jio.encode_jpeg(gray)
    for m in (tio, jio):
        with pytest.raises(ValueError):
            m.encode_jpeg(IMG.astype(np.float32))
        with pytest.raises(ValueError):
            m.decode_jpeg(jio.encode_jpeg(IMG), channels=2)


@pytest.mark.parametrize("size", [(37, 45), (16, 20), (64, 30), (37, 45)])
def test_geometry_and_resize_bit_equal(size):
    _eq(tio.flip_left_right(IMG), jio.flip_left_right(IMG))
    _eq(tio.crop_to_bounding_box(IMG, 3, 5, 20, 30),
        jio.crop_to_bounding_box(IMG, 3, 5, 20, 30))
    for frac in (0.5, 0.875, 1.0):
        _eq(tio.central_crop(IMG, frac), jio.central_crop(IMG, frac))
    _eq(tio.resize_bilinear(IMG, *size), jio.resize_bilinear(IMG, *size))
    _eq(tio.Rescaling(1 / 255, -0.5)(IMG), jio.Rescaling(1 / 255, -0.5)(IMG))
    for m in (tio, jio):
        with pytest.raises(ValueError):
            m.crop_to_bounding_box(IMG, 30, 0, 10, 10)


def test_stateless_random_ops_bit_equal():
    for seed in (0, 3, 2**31 + 5):
        for es in (0, 17, 2**33 + 1):
            _eq(tio.RandomFlip(seed=seed)(IMG, seed=es),
                jio.RandomFlip(seed=seed)(IMG, seed=es))
            _eq(tio.RandomCrop(24, 24, seed=seed)(IMG, seed=es),
                jio.RandomCrop(24, 24, seed=seed)(IMG, seed=es))
            # smaller than the target: upsized first
            _eq(tio.RandomCrop(50, 50, seed=seed)(IMG, seed=es),
                jio.RandomCrop(50, 50, seed=seed)(IMG, seed=es))
    assert tio.element_seed("/a/img_1.jpg") == jio.element_seed("/b/img_1.jpg")
    for m in (tio, jio):
        with pytest.raises(ValueError):
            m.RandomFlip("vertical")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    files = tio.generate_jpeg_directory(str(d / "port"), 24, image_size=40,
                                        num_classes=5, seed=3)
    jfiles = jio.generate_jpeg_directory(str(d / "jax"), 24, image_size=40,
                                         num_classes=5, seed=3)
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in jfiles]
    for f, jf in zip(files, jfiles):
        assert open(f, "rb").read() == open(jf, "rb").read()
    rec = str(d / "images.tfrecord")
    assert tio.write_jpeg_tfrecords(rec, files) == 24
    jrec = str(d / "images_jax.tfrecord")
    jio.write_jpeg_tfrecords(jrec, files)
    assert open(rec, "rb").read() == open(jrec, "rb").read()
    return files, rec


def _batches(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


def _eq_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            _eq(g[k], w[k])


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("crop", ["random", "central"])
def test_jpeg_pipeline_batches_equal_jax(jpegs, workers, crop):
    files, _ = jpegs
    kw = dict(batch_size=8, image_size=32, num_parallel_calls=workers,
              prefetch_depth=2, crop=crop, seed=1)
    _eq_batches(_batches(tio.jpeg_pipeline(files, **kw), 5),
                _batches(jio.jpeg_pipeline(files, **kw), 5))
    # FILE auto-shard: each shard's batches equal JAX's shard's
    kw.update(num_shards=2, shard_index=1, repeat=False)
    _eq_batches(list(tio.jpeg_pipeline(files, **kw)),
                list(jio.jpeg_pipeline(files, **kw)))


def test_decode_fn_matches_jax(jpegs):
    files, _ = jpegs
    for kw in (dict(), dict(crop="central", random_flip=False),
               dict(rescale=False, seed=9)):
        t, j = tio.make_decode_fn(32, **kw), jio.make_decode_fn(32, **kw)
        for f in files[:4]:
            g, w = t(f), j(f)
            _eq(g["image"], w["image"])
            _eq(g["label"], w["label"])
    assert tio.label_from_path(files[0]) == jio.label_from_path(files[0])


@pytest.mark.parametrize("workers", [1, 4])
def test_jpeg_tfrecord_pipeline_batches_equal_jax(jpegs, workers):
    _, rec = jpegs
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=4,
                                         num_threads=3)):
        kw.update(batch_size=6, image_size=32, num_parallel_calls=workers,
                  prefetch_depth=2)
        _eq_batches(_batches(tio.jpeg_tfrecord_pipeline(rec, **kw), 6),
                    _batches(jio.jpeg_tfrecord_pipeline(rec, **kw), 6))
    kw = dict(batch_size=6, image_size=32, repeat=False, num_shards=2,
              shard_index=0, num_parallel_calls=AUTOTUNE)
    _eq_batches(list(tio.jpeg_tfrecord_pipeline(rec, **kw)),
                list(jio.jpeg_tfrecord_pipeline(rec, **kw)))

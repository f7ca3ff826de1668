"""Host-side image ops — port of ``distributed_tensorflow_tpu/input/
image_ops.py``: the JPEG codec and the preprocessing of the real-data
ResNet path, line for line the same numpy.

≙ the reference's image input stack (`TF/python/ops/image_ops_impl.py`
`decode_jpeg` / `flip_left_right` / `crop_to_bounding_box` /
`central_crop` / `resize`, and `TFK/src/layers/preprocessing/`
`Rescaling` / `RandomFlip` / `RandomCrop`): everything runs on the HOST
as numpy. These feed ``Dataset.map(..., num_parallel_calls=...)``
workers, so they release the GIL where they can (PIL's decoder does)
and never touch the card; the batches go to the card through the
trainer's infeed (``training/loops.py InfeedLoop``).

- ``flip_left_right`` / ``crop_to_bounding_box`` / ``central_crop``
  are bit-exact against tf.image;
- ``resize_bilinear`` is TF2's half-pixel-centers bilinear kernel
  (``ResizeBilinear`` with ``half_pixel_centers=True``, no antialias);
- ``decode_jpeg`` uses PIL's libjpeg (imported at first use).

Random ops are STATELESS (≙ ``tf.image.stateless_random_*``): every
call takes an explicit per-element seed, so parallel map workers
produce bit-identical augmentation at any worker count and any thread
interleaving.
"""

from __future__ import annotations

import io
import os
import re
import zlib
from typing import Sequence

import numpy as np


def _require_pil():
    try:
        from PIL import Image
    except ImportError as e:                     # pragma: no cover
        raise ImportError(
            "image_ops needs Pillow for the JPEG host path "
            "(pip package 'Pillow')") from e
    return Image


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

def decode_jpeg(data: bytes, channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (H, W, channels) uint8 (≙ tf.io.decode_jpeg)."""
    Image = _require_pil()
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if channels == 3 else "L")
    arr = np.asarray(img, dtype=np.uint8)
    if channels == 1 and arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 1|3) uint8 -> JPEG bytes (≙ tf.io.encode_jpeg)."""
    Image = _require_pil()
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_jpeg expects uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[:, :, 0]
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def read_image(path: str, channels: int = 3) -> np.ndarray:
    """Read + decode one JPEG file from disk."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), channels)


# ---------------------------------------------------------------------------
# Deterministic geometry ops (bit-exact vs tf.image)
# ---------------------------------------------------------------------------

def flip_left_right(image: np.ndarray) -> np.ndarray:
    """≙ tf.image.flip_left_right (width axis reversal)."""
    return np.ascontiguousarray(np.asarray(image)[:, ::-1])


def crop_to_bounding_box(image: np.ndarray, offset_height: int,
                         offset_width: int, target_height: int,
                         target_width: int) -> np.ndarray:
    """≙ tf.image.crop_to_bounding_box, with its bounds validation."""
    image = np.asarray(image)
    h, w = image.shape[0], image.shape[1]
    if offset_height < 0 or offset_width < 0:
        raise ValueError("crop offsets must be non-negative")
    if offset_height + target_height > h or offset_width + target_width > w:
        raise ValueError(
            f"crop [{offset_height}:{offset_height + target_height}, "
            f"{offset_width}:{offset_width + target_width}] exceeds image "
            f"shape {(h, w)}")
    return image[offset_height:offset_height + target_height,
                 offset_width:offset_width + target_width]


def central_crop(image: np.ndarray, central_fraction: float) -> np.ndarray:
    """≙ tf.image.central_crop: crop the central ``fraction`` of each
    spatial dim (TF's exact offset arithmetic, so shapes match)."""
    if not 0.0 < central_fraction <= 1.0:
        raise ValueError("central_fraction must be in (0, 1]")
    image = np.asarray(image)
    if central_fraction == 1.0:
        return image
    h, w = image.shape[0], image.shape[1]
    start_h = int((h - h * central_fraction) / 2)
    start_w = int((w - w * central_fraction) / 2)
    return image[start_h:h - start_h, start_w:w - start_w]


def resize_bilinear(image: np.ndarray, target_height: int,
                    target_width: int) -> np.ndarray:
    """TF2 bilinear resize (half-pixel centers, no antialias) -> float32.

    ≙ tf.image.resize(method="bilinear"): source coordinate for output
    pixel i is ``(i + 0.5) * in/out - 0.5``, clamped; corners blend the
    two nearest source pixels with the fractional weight.
    """
    image = np.asarray(image)
    in_h, in_w = image.shape[0], image.shape[1]
    out = image.astype(np.float32)

    def axis_coords(n_in, n_out):
        src = (np.arange(n_out, dtype=np.float32) + 0.5) \
            * (n_in / n_out) - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    if in_h != target_height:
        lo, hi, frac = axis_coords(in_h, target_height)
        frac = frac.reshape(-1, *([1] * (out.ndim - 1)))
        out = out[lo] * (1.0 - frac) + out[hi] * frac
    if in_w != target_width:
        lo, hi, frac = axis_coords(in_w, target_width)
        frac = frac.reshape(1, -1, *([1] * (out.ndim - 2)))
        out = out[:, lo] * (1.0 - frac) + out[:, hi] * frac
    return out


# ---------------------------------------------------------------------------
# Preprocessing (≙ TFK/src/layers/preprocessing/*, stateless-seeded)
# ---------------------------------------------------------------------------

class Rescaling:
    """≙ keras.layers.Rescaling: ``x * scale + offset`` as float32."""

    def __init__(self, scale: float, offset: float = 0.0):
        self.scale = float(scale)
        self.offset = float(offset)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return np.asarray(image).astype(np.float32) * self.scale \
            + self.offset


class RandomFlip:
    """≙ keras.layers.RandomFlip("horizontal"), stateless per-element:
    ``flip(image, seed)`` draws the coin from ``(base_seed, seed)`` only
    — identical at any map worker count."""

    def __init__(self, mode: str = "horizontal", seed: int = 0):
        if mode != "horizontal":
            raise ValueError(
                f"RandomFlip supports mode='horizontal', got {mode!r} "
                f"(vertical flips are not part of the ResNet recipe)")
        self.mode = mode
        self.seed = int(seed)

    def __call__(self, image: np.ndarray, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed, int(seed) & 0xFFFFFFFF))
        if rng.random() < 0.5:
            return flip_left_right(image)
        return np.asarray(image)


class RandomCrop:
    """≙ keras.layers.RandomCrop(h, w), stateless per-element; images
    smaller than the target are bilinearly upsized first (keras's own
    fallback behavior)."""

    def __init__(self, height: int, width: int, seed: int = 0):
        self.height = int(height)
        self.width = int(width)
        self.seed = int(seed)

    def __call__(self, image: np.ndarray, seed: int = 0) -> np.ndarray:
        image = np.asarray(image)
        h, w = image.shape[0], image.shape[1]
        if h < self.height or w < self.width:
            image = resize_bilinear(image, max(h, self.height),
                                    max(w, self.width))
            h, w = image.shape[0], image.shape[1]
        rng = np.random.default_rng((self.seed, int(seed) & 0xFFFFFFFF))
        oy = int(rng.integers(0, h - self.height + 1))
        ox = int(rng.integers(0, w - self.width + 1))
        return crop_to_bounding_box(image, oy, ox, self.height, self.width)


def element_seed(path: str) -> int:
    """Stable per-element augmentation seed from the file path — shard-
    and worker-count-independent (a counter would not be)."""
    return zlib.crc32(os.path.basename(path).encode())


# ---------------------------------------------------------------------------
# On-disk dataset helpers (example / bench / tests)
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r"_cls(\d+)\.")


def label_from_path(path: str) -> int:
    """Parse the label a :func:`generate_jpeg_directory` filename
    carries (``..._cls<label>.jpg``)."""
    m = _LABEL_RE.search(os.path.basename(path))
    if not m:
        raise ValueError(
            f"cannot parse label from {path!r}; expected a "
            f"'..._cls<label>.jpg' filename "
            f"(generate_jpeg_directory layout)")
    return int(m.group(1))


def generate_jpeg_directory(path: str, num_images: int,
                            image_size: int = 96, num_classes: int = 10,
                            seed: int = 0, quality: int = 90
                            ) -> "list[str]":
    """Write ``num_images`` real JPEG files (labels in the filename)
    and return the sorted file list. Content is structured (per-class
    gradient + noise), so decode cost and compressibility are
    realistic, not flat-color degenerate."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    files = []
    for i in range(num_images):
        label = int(rng.integers(num_classes))
        phase = 2 * np.pi * label / num_classes
        base = (np.sin(xx / image_size * 4 + phase)
                + np.cos(yy / image_size * 3 - phase))
        img = np.stack([base * (c + 1) for c in range(3)], axis=-1)
        img = img + rng.normal(0, 0.35, img.shape)
        img = ((img - img.min()) / (np.ptp(img) + 1e-6) * 255).astype(
            np.uint8)
        fname = os.path.join(path, f"img_{i:06d}_cls{label:04d}.jpg")
        with open(fname, "wb") as f:
            f.write(encode_jpeg(img, quality=quality))
        files.append(fname)
    return sorted(files)


def make_decode_fn(image_size: int, *, rescale: bool = True,
                   random_flip: bool = True, crop: str = "random",
                   seed: int = 0):
    """One path -> {"image": (S, S, 3) float32, "label": int32} element
    fn for ``Dataset.map`` — the standard ResNet train recipe (decode,
    crop to S×S, horizontal flip, rescale to [0, 1])."""
    if crop not in ("random", "central"):
        raise ValueError(f"crop must be 'random' or 'central', got {crop!r}")
    cropper = RandomCrop(image_size, image_size, seed=seed)
    flipper = RandomFlip(seed=seed + 1)
    rescaler = Rescaling(1.0 / 255) if rescale else None

    def decode_one(path: str) -> dict:
        path = os.fspath(path)
        img = read_image(path)
        es = element_seed(path)
        if crop == "random":
            img = cropper(img, seed=es)
        else:
            h, w = img.shape[0], img.shape[1]
            side = min(h, w)
            img = crop_to_bounding_box(img, (h - side) // 2,
                                       (w - side) // 2, side, side)
            if side != image_size:
                img = resize_bilinear(img, image_size, image_size)
        if random_flip:
            img = flipper(img, seed=es)
        img = rescaler(img) if rescaler else img.astype(np.float32)
        return {"image": img,
                "label": np.int32(label_from_path(path))}

    return decode_one


def jpeg_pipeline(files: Sequence[str], *, batch_size: int,
                  image_size: int, num_parallel_calls: int | None = None,
                  prefetch_depth: int = 4, repeat: bool = True,
                  drop_remainder: bool = True, rescale: bool = True,
                  random_flip: bool = True, crop: str = "random",
                  seed: int = 0, num_shards: int = 1,
                  shard_index: int = 0):
    """The full real-JPEG host pipeline for ResNet training.

    files -> FILE auto-shard -> repeat -> parallel decode+augment ->
    batch -> prefetch. With ``num_parallel_calls=None`` and
    ``prefetch_depth=0`` this is the serial reference configuration the
    bench compares against.
    """
    from distributed_tensorflow_tpu_torch.input.dataset import (
        AutoShardPolicy, Dataset, auto_shard_dataset)

    ds = Dataset.from_files(list(files), reader=lambda f: iter([f]))
    if num_shards > 1:
        ds = auto_shard_dataset(ds, num_shards, shard_index,
                                AutoShardPolicy.FILE)
    if repeat:
        ds = ds.repeat()
    ds = ds.map(make_decode_fn(image_size, rescale=rescale,
                               random_flip=random_flip, crop=crop,
                               seed=seed),
                num_parallel_calls=num_parallel_calls, name="jpeg_decode")
    ds = ds.batch(batch_size, drop_remainder=drop_remainder)
    if prefetch_depth > 0:
        ds = ds.prefetch(prefetch_depth, name="jpeg_batches")
    return ds


# ---------------------------------------------------------------------------
# Native-loader route: JPEG bytes inside TFRecords, framing/crc/shuffle/
# shard in C++ threads (native/pipeline.cc), decode in the parallel map
# ---------------------------------------------------------------------------

def write_jpeg_tfrecords(path: str, jpeg_files: Sequence[str],
                         labels: Sequence[int] | None = None) -> int:
    """Pack JPEG files into ONE TFRecord shard of tf.train.Examples
    ({"image": jpeg bytes, "label": int64}) — readable by the native
    C++ reader (:class:`input.native_loader.NativeTFRecordDataset`) and
    by TensorFlow. Labels default to the filename encoding. Returns the
    record count."""
    from distributed_tensorflow_tpu_torch.input.example_parser import (
        encode_example)
    from distributed_tensorflow_tpu_torch.input.native_loader import (
        write_tfrecords)

    jpeg_files = list(jpeg_files)
    if labels is None:
        labels = [label_from_path(f) for f in jpeg_files]
    if len(labels) != len(jpeg_files):
        raise ValueError(f"{len(labels)} labels for "
                         f"{len(jpeg_files)} files")

    def payloads():
        for f, lab in zip(jpeg_files, labels):
            with open(f, "rb") as fh:
                yield encode_example({"image": fh.read(),
                                      "label": np.int64(lab)})

    write_tfrecords(path, payloads())
    return len(jpeg_files)


def jpeg_tfrecord_pipeline(paths, *, batch_size: int, image_size: int,
                           num_parallel_calls: int | None = None,
                           prefetch_depth: int = 4, repeat: bool = True,
                           shuffle: bool = False, seed: int = 0,
                           num_threads: int = 2,
                           num_shards: int = 1, shard_index: int = 0,
                           rescale: bool = True, random_flip: bool = True,
                           crop: str = "random"):
    """The native-loader variant of :func:`jpeg_pipeline`: the TFRecord
    framing scan, crc verification, per-epoch shuffle, DATA-policy
    sharding and record-batch assembly run in C++ worker threads; the
    Example payloads stream into the SAME parallel decode+augment map.
    Augmentation seeds derive from the JPEG bytes (records carry no
    filename), so elements stay deterministic at any worker count."""
    from distributed_tensorflow_tpu_torch.input.dataset import Dataset
    from distributed_tensorflow_tpu_torch.input.example_parser import (
        FixedLenFeature, parse_single_example)
    from distributed_tensorflow_tpu_torch.input.native_loader import (
        NativeTFRecordDataset)

    spec = {"image": FixedLenFeature((), object),
            "label": FixedLenFeature((), np.int64)}
    cropper = RandomCrop(image_size, image_size, seed=seed)
    flipper = RandomFlip(seed=seed + 1)
    rescaler = Rescaling(1.0 / 255) if rescale else None

    def records():
        native = NativeTFRecordDataset(
            paths, batch_size=batch_size, shuffle=shuffle, seed=seed,
            num_threads=num_threads, num_shards=num_shards,
            shard_index=shard_index, drop_remainder=True)
        try:
            while True:
                recs, epoch = native.next_records()
                if not repeat and epoch > 0:
                    return
                yield from recs
        except StopIteration:
            return
        finally:
            native.close()

    def decode_one(payload: bytes) -> dict:
        ex = parse_single_example(payload, spec)
        data = ex["image"] if isinstance(ex["image"], bytes) \
            else bytes(np.asarray(ex["image"]).item())
        img = decode_jpeg(data)
        es = zlib.crc32(data[:512])
        if crop == "random":
            img = cropper(img, seed=es)
        else:
            h, w = img.shape[0], img.shape[1]
            side = min(h, w)
            img = crop_to_bounding_box(img, (h - side) // 2,
                                       (w - side) // 2, side, side)
            if side != image_size:
                img = resize_bilinear(img, image_size, image_size)
        if random_flip:
            img = flipper(img, seed=es)
        img = rescaler(img) if rescaler else img.astype(np.float32)
        return {"image": img,
                "label": np.asarray(ex["label"], np.int32).reshape(())}

    ds = Dataset.from_generator(records)
    ds = ds.map(decode_one, num_parallel_calls=num_parallel_calls,
                name="tfrecord_jpeg_decode")
    ds = ds.batch(batch_size, drop_remainder=True)
    if prefetch_depth > 0:
        ds = ds.prefetch(prefetch_depth, name="tfrecord_jpeg_batches")
    return ds

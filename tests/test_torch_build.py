"""``distributed_tensorflow_tpu_torch.ops._build`` on a machine without
``nvcc``: loading a kernel source raises instead of falling back,
``load`` binds every entry point it is given, and a library's name
follows its source and every shared header. Nothing is compiled."""

import ctypes
import os

import pytest

from distributed_tensorflow_tpu_torch.ops import _build
from distributed_tensorflow_tpu_torch.ops.attention import (
    FLASH_BWD_ARGTYPES, FLASH_FWD_ARGTYPES, FLASH_TC_ARGTYPES)
from distributed_tensorflow_tpu_torch.ops.fused_adamw import ADAMW_ARGTYPES
from distributed_tensorflow_tpu_torch.ops.fused_ce import (
    CE_ARGTYPES, CE_TC_ARGTYPES)

SOURCES = {"flash_fwd": {"flash_fwd": FLASH_FWD_ARGTYPES},
           "flash_bwd": FLASH_BWD_ARGTYPES,
           "flash_tc": FLASH_TC_ARGTYPES,
           "fused_ce": CE_ARGTYPES,
           "fused_ce_tc": CE_TC_ARGTYPES,
           "fused_adamw": ADAMW_ARGTYPES}


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    real_exists = os.path.exists
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc")
                        else real_exists(p))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_load_without_nvcc_raises(no_nvcc, name):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(name, SOURCES[name])
    assert name not in _build._libs


def test_every_source_has_its_entry_points():
    """Each source defines the C entry points its wrapper binds, plus
    ``kernel_error_string``."""
    for name, entries in SOURCES.items():
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for entry in (*entries, "kernel_error_string"):
            assert f" {entry}(" in src, (name, entry)


def test_load_binds_every_entry(monkeypatch, tmp_path):
    """``load`` sets argtypes and an int restype on each entry point it
    is given, and caches the library for the process."""
    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.flash_bwd_dq, self.flash_bwd_dkv = FakeFn(), FakeFn()
            self.kernel_error_string = FakeFn()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda name: str(tmp_path / name))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    lib = _build.load("flash_bwd", FLASH_BWD_ARGTYPES)
    for entry, argtypes in FLASH_BWD_ARGTYPES.items():
        assert getattr(lib, entry).argtypes == argtypes
        assert getattr(lib, entry).restype is ctypes.c_int
    assert lib.kernel_error_string.restype is ctypes.c_char_p
    assert _build.load("flash_bwd", FLASH_BWD_ARGTYPES) is lib


def test_library_path_follows_sources_and_headers(monkeypatch, tmp_path):
    """An edit to a source or to any ``csrc/*.cuh`` header (which a source
    may include) names another library, so a stale build is never
    loaded; an edit elsewhere does not."""
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "notes.txt").write_text("b\n")
    assert _build.library_path("k") == first
    (tmp_path / "helpers.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _build.library_path("k")
    assert third != second
    (tmp_path / "k.cu").write_text('#include "helpers.cuh"\n// edit\n')
    assert _build.library_path("k") not in (first, second, third)
    assert os.path.basename(first).startswith("k-")


def test_ce_tensor_core_entry_points():
    """``fused_ce_tc.cu`` binds the bf16 forward, the "b" backward, the two
    "split" passes and the one-pass "a" backward (h, E, t, lse, g, the
    f32 dh accumulator, dE; N, V, D; stream), and ``fused_ce.cu`` keeps
    only f32 kernels."""
    assert sorted(CE_TC_ARGTYPES) == sorted(
        ["fused_ce_fwd_tc", "fused_ce_bwd_tc", "fused_ce_dh_tc",
         "fused_ce_de_tc", "fused_ce_bwd_a_tc"])
    assert CE_TC_ARGTYPES["fused_ce_bwd_a_tc"] == (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with open(os.path.join(_build.CSRC, "fused_ce.cu")) as f:
        assert "__nv_bfloat16" not in f.read()

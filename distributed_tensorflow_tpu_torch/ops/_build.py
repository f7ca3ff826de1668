"""Build a ``csrc/*.cu`` kernel source with ``nvcc`` and load it.

Each source has plain C entry points (no PyTorch headers), so one
``nvcc`` call takes seconds. The shared library goes into
``build/torch_kernels/`` at the repository root, named after the
source and a hash of its contents and of every header in ``csrc/``
(``*.cuh``, which a source may include), so an edited source or header
is always rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: :func:`load` builds at first use and
caches the loaded library for the process. A failed build raises.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": nvcc wall time (0.0 when the library was
#: already built), "log": nvcc's output (ptxas register/smem report)}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def hashed_path(build_dir: str, name: str, sources, flags) -> str:
    """``<build_dir>/<name>-<hash>.so``, the hash of every file in
    ``sources`` and of the compiler ``flags``: an edited source, header
    or flag names another library."""
    h = hashlib.sha1()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(build_dir, f"{name}-{h.hexdigest()[:12]}.so")


def library_path(name: str) -> str:
    return hashed_path(BUILD_DIR, name, (
        os.path.join(CSRC, f"{name}.cu"),
        *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))), NVCC_FLAGS)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path. Raises with nvcc's output on failure."""
    lib = library_path(name)
    if os.path.exists(lib):
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    build_info[name] = {"seconds": seconds, "log": log}
    return lib


def load(name: str, entries: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.
    ``entries`` maps each C entry point of the source to its argtypes;
    every entry point returns ``cudaGetLastError()`` as an int."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.kernel_error_string(int(err)).decode()

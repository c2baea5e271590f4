"""Builds the CUDA kernels from `aesmc_tpu_torch/csrc/` and loads them.

Each kernel source is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). Libraries go to `aesmc_tpu_torch/_build/` when that
directory can be created and written, and otherwise (a read-only install)
to `aesmc_tpu_torch/` in the user's cache directory (`$XDG_CACHE_HOME`,
else `~/.cache`); they are named by a hash of the source and the flags,
built at first use, and reused by a later call, or a later process, with
the same source.

Nothing here runs at import: the CPU-only test machines import every
module of the package.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

# Round-to-nearest arithmetic is part of the kernels' contract (bit-exact
# positions): never add --use_fast_math here.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_source_locks: dict = {}
_loaded: dict = {}


def nvcc_path() -> str:
    """The `nvcc` to build with: `$CUDA_HOME/bin`, then PATH, then
    `/usr/local/cuda/bin`."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels are built at first use")


def _writable(directory: pathlib.Path) -> bool:
    """Whether ``directory`` can be created and a file written in it."""
    try:
        directory.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=directory):
            return True
    except OSError:
        return False


def build_dir() -> pathlib.Path:
    """Where the libraries go: `BUILD_DIR` beside the sources when it can be
    written, else `aesmc_tpu_torch/` in the user's cache directory."""
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / "aesmc_tpu_torch"


def library_path(source: str) -> pathlib.Path:
    """Where the library built from ``csrc/<source>`` lives. Its name
    hashes the source, the headers of `csrc/` and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = pathlib.Path(source).stem
    return build_dir() / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def load(source: str) -> ctypes.CDLL:
    """Builds ``csrc/<source>`` if its library is missing, and loads it
    (once per process). Different sources build concurrently."""
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        if source in _loaded:
            return _loaded[source]
        lib_path = library_path(source)
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            # Build into a temporary name and rename, so that a build that
            # is cut off never leaves a library that looks finished.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
            os.close(fd)
            try:
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                       str(CSRC / source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {source}:"
                        f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = lib
        return lib


def load_all(sources) -> list:
    """`load` for several sources, one nvcc each, all started together."""
    sources = list(sources)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(load, sources))

"""Where the port builds its CUDA kernels: beside the sources in
`aesmc_tpu_torch/_build/` when that directory can be created and written,
else (a read-only install) in the user's cache directory. No nvcc is
needed: only the choice of directory is tested."""

import pathlib

import pytest

from aesmc_tpu_torch.ops import _build
import torch_threads  # noqa: F401  (caps PyTorch's threads)


@pytest.fixture
def read_only_package(tmp_path, monkeypatch):
    """A package directory whose `_build/` cannot be created: its parent
    is a file, which refuses a directory even to root."""
    parent = tmp_path / "package"
    parent.write_text("not a directory")
    monkeypatch.setattr(_build, "BUILD_DIR", parent / "_build")
    return parent / "_build"


def test_builds_beside_the_sources_when_writable(tmp_path, monkeypatch):
    build = tmp_path / "package" / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == build and build.is_dir()
    assert _build.library_path("gather_sorted.cu").parent == build
    assert not (tmp_path / "cache").exists()


def test_read_only_package_builds_in_xdg_cache(tmp_path, monkeypatch,
                                               read_only_package):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    want = tmp_path / "cache" / "aesmc_tpu_torch"
    assert _build.build_dir() == want
    path = _build.library_path("searchsorted_cdf.cu")
    assert path.parent == want and path.name.startswith(
        "libsearchsorted_cdf-")
    assert not read_only_package.exists()


def test_read_only_package_builds_in_home_cache(tmp_path, monkeypatch,
                                                read_only_package):
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir() == pathlib.Path(
        tmp_path / "home" / ".cache" / "aesmc_tpu_torch")

"""No JAX in a run, no result without a card, none without the program."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench.harness import env
from portbench.tests.conftest import ROOT


@pytest.mark.parametrize("loaded,banned", [
    (["aesmc_tpu_torch", "aesmc_tpu_torch.ops"], []),
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["aesmc_tpu", "aesmc_tpu.ops", "aesmc_tpu_torch"],
     ["aesmc_tpu", "aesmc_tpu.ops"]),
    (["jaxtyping", "aesmc_tpu_torchx"], []),
])
def test_banned_by_whole_top_level_name(loaded, banned):
    modules = {name: types.ModuleType(name) for name in loaded}
    assert env.banned_modules(modules) == banned


def _run(cwd, extra_env=None):
    environment = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                       **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lgssm-filter",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=environment, capture_output=True, text=True,
        timeout=300)


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "no CUDA device" in out.stderr
    assert "memory_peak_bytes" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert _last_json(out.stdout) is None


def test_caches_inside_the_checkout(monkeypatch):
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                 "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    env.prepare(ROOT)
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                 "TORCHINDUCTOR_CACHE_DIR"):
        assert os.environ[name].startswith(str(ROOT / "portbench" /
                                               ".cache"))


def test_bytecode_cached_inside_the_checkout(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    _run(tmp_path, {"PYTHONPATH": "", "PYTHONDONTWRITEBYTECODE": "1"})
    cached = list((tmp_path / "portbench" / ".cache" / "pycache").rglob(
        "runner*.pyc"))
    assert cached, "the harness's bytecode is not cached in the checkout"
    assert not list((tmp_path / "portbench").rglob("__pycache__"))

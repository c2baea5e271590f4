"""The run's surroundings: caches, precision, the card, banned modules.

`prepare(root)` runs before torch is imported: it points the compile
caches at fixed folders inside the checkout, so that only the first run
of a cell in a checkout compiles. The nvcc libraries of the program
already go to `aesmc_tpu_torch/_build/` beside its sources.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

# Top-level module names that no run may hold once its window has closed:
# JAX, its libraries, and the JAX package the port was made from.
BANNED = ("jax", "jaxlib", "flax", "aesmc_tpu")
PROGRAM = "aesmc_tpu_torch"


def cache_root(root) -> pathlib.Path:
    return pathlib.Path(root) / "portbench" / ".cache"


def prepare(root) -> None:
    """Fixed cache folders inside the checkout, and no JAX through
    libraries that would load it by themselves."""
    cache = cache_root(root)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def program_present(root) -> bool:
    return (pathlib.Path(root) / PROGRAM / "__init__.py").is_file()


def float32_means_float32() -> None:
    """Float32 products in float32, not TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def banned_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of `BANNED`, compared whole: `aesmc_tpu_torch` is not
    `aesmc_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules)
                  if name.split(".", 1)[0] in BANNED)


def power_limit_w():
    """The card's power limit in watts from `nvidia-smi`, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class NoCard(RuntimeError):
    """The run needs more NVIDIA cards than this machine shows."""


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is False; "
                     "the benchmark measures the port on an NVIDIA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, this machine "
                     f"has {torch.cuda.device_count()}")

"""aesmc_tpu_torch: auto-encoding sequential Monte Carlo in PyTorch, for
one NVIDIA H100.

The port of `aesmc_tpu` (JAX, TPU), which stays beside it as the
reference. Module names mirror the JAX package. Ported so far: the SMC
filtering path (`inference.infer` with systematic resampling) and the
LGSSM, with the fused resample+gather as a hand-written CUDA kernel
(`ops.resample_cuda`). This package never imports JAX.
"""

__version__ = "0.1.0"

from . import distributions
from . import inference
from . import math
from . import models
from . import noise
from . import ops
from . import resampling
from . import state
from . import statistics

__all__ = [
    "distributions", "inference", "math", "models", "noise", "ops",
    "resampling", "state", "statistics", "__version__",
]

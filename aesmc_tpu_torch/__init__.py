"""aesmc_tpu_torch: auto-encoding sequential Monte Carlo in PyTorch, for
one NVIDIA H100.

The port of `aesmc_tpu` (JAX, TPU), which stays beside it as the
reference. Module names mirror the JAX package. Ported so far: the SMC
filtering path (`inference.infer` with systematic, stratified and
multinomial resampling, at every step or ESS-adaptive, with an optional
NaN guard and rematerialization) and the AESMC/IWAE training path
(`losses`, `train` with `checkpoint`, and `train.train_on_device`, one
train step captured in a CUDA graph), on the LGSSM, the
conjugate-Gaussian model and the discrete-latent HMM (int32 particles),
with every resampling kernel of the JAX package, and the backward, as
hand-written CUDA (`ops`).
Entry points put their tensors on the card unless the caller asks for
the CPU (`device`). This package never imports JAX.
"""

__version__ = "0.3.0"

from . import checkpoint
from . import device
from . import distributions
from . import inference
from . import losses
from . import math
from . import models
from . import noise
from . import ops
from . import resampling
from . import state
from . import statistics
from . import train

__all__ = [
    "checkpoint", "device", "distributions", "inference", "losses", "math",
    "models", "noise", "ops", "resampling", "state", "statistics", "train",
    "__version__",
]

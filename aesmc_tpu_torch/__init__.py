"""aesmc_tpu_torch: auto-encoding sequential Monte Carlo in PyTorch, for
one NVIDIA H100.

The port of `aesmc_tpu` (JAX, TPU), which stays beside it as the
reference. Module names mirror the JAX package. Ported so far: the SMC
filtering path (`inference.infer` with systematic, stratified,
multinomial, residual and soft resampling, at every step or
ESS-adaptive, the auxiliary particle filter, history windows, an
optional NaN guard and rematerialization) and the AESMC/IWAE training
path (`losses`, `train` with `checkpoint`, and `train.train_on_device`,
one train step captured in a CUDA graph), on the LGSSM, the
D-dimensional LGSSM, stochastic volatility, the conjugate-Gaussian model,
the discrete-latent HMM (int32 particles), the VRNN and Lorenz-96, with
every distribution of the JAX package, and every resampling kernel of the
JAX package, and the backward, as hand-written CUDA (`ops`); beside it
OT resampling (`ot`), the EKF/UKF proposals (`proposals`), the streaming
(serving) filter (`online`), TMC, the score gradient, smoothing,
genealogy variance and forecasting; sequential quasi-Monte Carlo (`sqmc`,
whose resampling runs K3), conditional SMC, particle Gibbs and PMMH
(`csmc`), the Rao-Blackwellised filter (`rbpf`) and the bouncing-ball
deep SSM; the resample-move filter (`resample_move`), the block particle
filter (`blockpf`), the annealed and waste-free SMC samplers
(`samplers`), SMC^2 (`smc2`) and IF2 iterated filtering (`if2`).
Entry points put their tensors on the card unless the caller asks for
the CPU (`device`). This package never imports JAX.
"""

__version__ = "0.3.0"

from . import blockpf
from . import checkpoint
from . import csmc
from . import device
from . import distributions
from . import forecast
from . import gradients
from . import if2
from . import inference
from . import losses
from . import math
from . import models
from . import noise
from . import online
from . import ops
from . import ot
from . import profiling
from . import proposals
from . import rbpf
from . import resample_move
from . import resampling
from . import samplers
from . import smc2
from . import smoothing
from . import sqmc
from . import state
from . import statistics
from . import tmc
from . import train
from . import utils
from . import variance

__all__ = [
    "blockpf", "checkpoint", "csmc", "device", "distributions", "forecast",
    "gradients", "if2", "inference", "losses", "math", "models", "noise",
    "online", "ops", "ot", "profiling", "proposals", "rbpf",
    "resample_move", "resampling", "samplers", "smc2", "smoothing", "sqmc",
    "state", "statistics", "tmc", "train", "utils", "variance",
    "__version__",
]

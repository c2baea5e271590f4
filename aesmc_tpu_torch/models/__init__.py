"""Model families of the PyTorch port: the scalar LGSSM and its exact
Kalman oracle, the D-dimensional LGSSM and its exact oracle, stochastic
volatility, the conjugate-Gaussian test model, the discrete-latent
HMM with its exact forward-backward oracles, the VRNN (a GRU over the
observations and MLP transition, emission and proposal), Lorenz-96 and
the bouncing ball (a deep SSM with an MLP emission residual and an
amortized MLP proposal, and its twisted-SMC view `gaussian_spec`)."""

from . import bouncing_ball
from . import gaussian
from . import hmm
from . import kalman
from . import kalman_nd
from . import lgssm
from . import lgssm_nd
from . import lorenz
from . import stochastic_volatility
from . import vrnn

__all__ = ["bouncing_ball", "gaussian", "hmm", "kalman", "kalman_nd",
           "lgssm", "lgssm_nd", "lorenz", "stochastic_volatility", "vrnn"]

"""Model families of the PyTorch port: the scalar LGSSM and its exact
Kalman oracle, the conjugate-Gaussian test model, and the discrete-latent
HMM with its exact forward-backward oracles."""

from . import gaussian
from . import hmm
from . import kalman
from . import lgssm

__all__ = ["gaussian", "hmm", "kalman", "lgssm"]

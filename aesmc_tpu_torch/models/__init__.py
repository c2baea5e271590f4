"""Model families of the PyTorch port: the scalar LGSSM and its exact
Kalman oracle, and the conjugate-Gaussian test model."""

from . import gaussian
from . import kalman
from . import lgssm

__all__ = ["gaussian", "kalman", "lgssm"]

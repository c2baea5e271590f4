"""Model families of the PyTorch port: the scalar LGSSM and its exact
Kalman oracle."""

from . import kalman
from . import lgssm

__all__ = ["kalman", "lgssm"]

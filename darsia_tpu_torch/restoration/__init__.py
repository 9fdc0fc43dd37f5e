"""Restoration."""

from .h1_regularization import H1_regularization
from .resize import Resize, resize

__all__ = ["H1_regularization", "Resize", "resize"]

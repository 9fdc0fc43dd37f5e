"""Restoration."""

from .h1_regularization import H1_regularization

__all__ = ["H1_regularization"]

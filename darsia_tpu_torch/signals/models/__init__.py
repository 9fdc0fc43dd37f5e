"""Signal models."""

from .linearmodel import LinearModel, Model

__all__ = ["LinearModel", "Model"]

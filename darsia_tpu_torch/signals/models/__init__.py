"""Signal models."""

from .basemodel import Model
from .combinedmodel import CombinedModel
from .linearmodel import LinearModel

__all__ = ["CombinedModel", "LinearModel", "Model"]

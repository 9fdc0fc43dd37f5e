"""Signal models."""

from .basemodel import HeterogeneousModel, Model
from .clipmodel import ClipModel
from .color_path_interpolation import (
    ColorPathFunction,
    ColorPathInterpolation,
    LabelColorPathInterpolation,
)
from .combinedmodel import CombinedModel
from .linearmodel import LinearModel
from .pwtransformation import PWTransformation

__all__ = [
    "ClipModel",
    "ColorPathFunction",
    "ColorPathInterpolation",
    "CombinedModel",
    "HeterogeneousModel",
    "LabelColorPathInterpolation",
    "LinearModel",
    "Model",
    "PWTransformation",
]

"""Colour paths and colour utilities."""

from .color_embedding import (
    ColorEmbeddingBasis,
    calibration_basis_folder,
    parse_color_embedding_basis,
)
from .color_mode import ColorMode
from .color_path import ColorPath, define_color_path
from .utils import get_mean_color

__all__ = [
    "ColorEmbeddingBasis",
    "ColorMode",
    "ColorPath",
    "calibration_basis_folder",
    "define_color_path",
    "get_mean_color",
    "parse_color_embedding_basis",
]

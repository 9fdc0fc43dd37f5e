"""Physical images."""

from .arithmetics import ones_like, stack, superpose, weight, zeros_like
from .coordinatesystem import CoordinateSystem
from .image import Image, OpticalImage, ScalarImage
from .imread import imread, imread_from_npz, imread_from_numpy
from .indexing import (
    cartesianToMatrixIndexing,
    interpret_indexing,
    matrixToCartesianIndexing,
    to_cartesian_indexing,
    to_matrix_indexing,
)
from .patches import Patches

__all__ = [
    "CoordinateSystem",
    "Image",
    "OpticalImage",
    "Patches",
    "ScalarImage",
    "cartesianToMatrixIndexing",
    "imread",
    "imread_from_npz",
    "imread_from_numpy",
    "interpret_indexing",
    "matrixToCartesianIndexing",
    "ones_like",
    "stack",
    "superpose",
    "to_cartesian_indexing",
    "to_matrix_indexing",
    "weight",
    "zeros_like",
]

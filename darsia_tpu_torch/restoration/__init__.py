"""Restoration."""

from .averaging import (
    REV,
    VolumeAveraging,
    porosity_based_averaging,
    uniform_filter,
    volume_average,
)
from .binaryinpaint import BinaryFillHoles, BinaryLocalConvexCover, BinaryRemoveSmallObjects
from .h1_regularization import H1_regularization
from .median import Median, median_filter
from .resize import Resize, equalize_voxel_size, resize, uniform_refinement
from .split_bregman_tvd import split_bregman_tvd
from .tvd import TVD, tvd

__all__ = [
    "REV",
    "TVD",
    "BinaryFillHoles",
    "BinaryLocalConvexCover",
    "BinaryRemoveSmallObjects",
    "H1_regularization",
    "Median",
    "Resize",
    "VolumeAveraging",
    "equalize_voxel_size",
    "median_filter",
    "porosity_based_averaging",
    "resize",
    "split_bregman_tvd",
    "tvd",
    "uniform_filter",
    "uniform_refinement",
    "volume_average",
]

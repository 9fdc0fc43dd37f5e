"""Physical images."""

from .arithmetics import ones_like, stack, superpose, weight, zeros_like
from .coordinatesystem import (
    CoordinateSystem,
    check_equal_coordinatesystems,
    coordinates_to_voxels,
    voxels_to_coordinates,
)
from .image import ExtensiveImage, Image, OpticalImage, ScalarImage
from .imread import (
    imread,
    imread_from_bytes,
    imread_from_dicom,
    imread_from_npz,
    imread_from_numpy,
    imread_from_optical,
    imread_from_vtu,
)
from .indexing import (
    cartesianToMatrixIndexing,
    interpret_indexing,
    matrixToCartesianIndexing,
    to_cartesian_indexing,
    to_matrix_indexing,
)
from .patches import Patches
from .roi import ROI

# Last: it builds on the corrections, which import the names above.
from .coordinatetransformation import CoordinateTransformation  # noqa: E402, I001
from .subregions import extract_quadrilateral_ROI  # noqa: E402

__all__ = [
    "ROI",
    "CoordinateSystem",
    "CoordinateTransformation",
    "ExtensiveImage",
    "Image",
    "OpticalImage",
    "Patches",
    "ScalarImage",
    "cartesianToMatrixIndexing",
    "check_equal_coordinatesystems",
    "coordinates_to_voxels",
    "extract_quadrilateral_ROI",
    "imread",
    "imread_from_bytes",
    "imread_from_dicom",
    "imread_from_npz",
    "imread_from_numpy",
    "imread_from_optical",
    "imread_from_vtu",
    "interpret_indexing",
    "matrixToCartesianIndexing",
    "ones_like",
    "stack",
    "superpose",
    "to_cartesian_indexing",
    "to_matrix_indexing",
    "voxels_to_coordinates",
    "weight",
    "zeros_like",
]

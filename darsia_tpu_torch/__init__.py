"""darsia_tpu_torch: the PyTorch/CUDA port of darsia_tpu.

The JAX package ``darsia_tpu`` is the reference; this package keeps its file
layout and public names, so each module has a counterpart there.  Ported so
far: the per-frame production path (correction chain -> registration ->
concentration) for single frames and series, the flexible and multiscale
registration lanes, the whole correction registry, patches, npz image I/O
and the image core around them, with the two-pass warp as a hand-written
CUDA kernel (``ops/warp2pass.py``, ``csrc/``).  Tensors stay
on the device they are given; nothing here imports JAX.
"""

import torch

# Full f32 matmuls: the registration's TPS evaluation (E @ (Ainv @ v)) and
# later colour-balance matmuls cancel large terms, and TF32's 10-bit mantissa
# would move the displacement field by far more than the parity tolerances.
# PyTorch defaults matmul TF32 off but cuDNN TF32 on; both are set here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .analysis import (  # noqa: E402
    ConcentrationAnalysis,
    DiffeomorphicImageRegistration,
    FusedAnalysisPipeline,
    ImageRegistration,
    MultiscaleDiffeomorphicImageRegistration,
    TranslationAnalysis,
)
from .corrections import (  # noqa: E402
    CORRECTION_REGISTRY,
    EOTF,
    AdaptiveBalance,
    AffineBalance,
    AffineCorrection,
    AffineTransformation,
    AnyCorrection,
    BaseCorrection,
    BaseTransformation,
    ColorBalance,
    ColorChecker,
    ColorCheckerAfter2014,
    ColorCorrection,
    CurvatureCorrection,
    CustomColorChecker,
    DeformationCorrection,
    DriftCorrection,
    DynamicIlluminationCorrection,
    ExperimentalColorCorrection,
    GeneralizedPerspectiveCorrection,
    GeneralizedPerspectiveTransformation,
    IlluminationCorrection,
    PatchwiseIlluminationCorrection,
    PiecewisePerspectiveTransform,
    RelativeColorCorrection,
    RotationCorrection,
    TransformationCorrection,
    TranslationCorrection,
    TranslationEstimator,
    TypeCorrection,
    WhiteBalance,
    find_colorchecker,
    read_correction,
)
from .image import (  # noqa: E402
    CoordinateSystem,
    Image,
    OpticalImage,
    Patches,
    ScalarImage,
    cartesianToMatrixIndexing,
    imread,
    imread_from_npz,
    imread_from_numpy,
    interpret_indexing,
    matrixToCartesianIndexing,
    ones_like,
    stack,
    superpose,
    to_cartesian_indexing,
    to_matrix_indexing,
    weight,
    zeros_like,
)
from .ops.resize import resize_array  # noqa: E402
from .restoration import H1_regularization, Resize, resize  # noqa: E402
from .signals.models import LinearModel  # noqa: E402
from .signals.reduction import MonochromaticReduction  # noqa: E402
from .utils.approximations import (  # noqa: E402
    ApproximationSpace,
    LinearApproximation,
    PolynomialApproximationSpace,
    RadialPolynomialApproximationSpace,
)
from .utils.linear_solvers import Jacobi  # noqa: E402
from .utils.point import (  # noqa: E402
    BasePoint,
    Coordinate,
    CoordinateArray,
    Voxel,
    VoxelArray,
    VoxelCenter,
    VoxelCenterArray,
    make_coordinate,
    make_voxel,
    make_voxel_center,
    to_coordinate,
    to_voxel,
    to_voxel_center,
)

__all__ = [
    "AdaptiveBalance",
    "AffineBalance",
    "AffineCorrection",
    "AffineTransformation",
    "AnyCorrection",
    "ApproximationSpace",
    "BaseCorrection",
    "BasePoint",
    "BaseTransformation",
    "CORRECTION_REGISTRY",
    "ColorBalance",
    "ColorChecker",
    "ColorCheckerAfter2014",
    "ColorCorrection",
    "ConcentrationAnalysis",
    "Coordinate",
    "CoordinateArray",
    "CoordinateSystem",
    "CurvatureCorrection",
    "CustomColorChecker",
    "DeformationCorrection",
    "DiffeomorphicImageRegistration",
    "DriftCorrection",
    "DynamicIlluminationCorrection",
    "EOTF",
    "ExperimentalColorCorrection",
    "FusedAnalysisPipeline",
    "GeneralizedPerspectiveCorrection",
    "GeneralizedPerspectiveTransformation",
    "H1_regularization",
    "IlluminationCorrection",
    "Image",
    "ImageRegistration",
    "Jacobi",
    "LinearApproximation",
    "LinearModel",
    "MonochromaticReduction",
    "MultiscaleDiffeomorphicImageRegistration",
    "OpticalImage",
    "Patches",
    "PatchwiseIlluminationCorrection",
    "PiecewisePerspectiveTransform",
    "PolynomialApproximationSpace",
    "RadialPolynomialApproximationSpace",
    "RelativeColorCorrection",
    "Resize",
    "RotationCorrection",
    "ScalarImage",
    "TransformationCorrection",
    "TranslationAnalysis",
    "TranslationCorrection",
    "TranslationEstimator",
    "TypeCorrection",
    "Voxel",
    "VoxelArray",
    "VoxelCenter",
    "VoxelCenterArray",
    "WhiteBalance",
    "cartesianToMatrixIndexing",
    "find_colorchecker",
    "imread",
    "imread_from_npz",
    "imread_from_numpy",
    "interpret_indexing",
    "make_coordinate",
    "make_voxel",
    "make_voxel_center",
    "matrixToCartesianIndexing",
    "ones_like",
    "read_correction",
    "resize",
    "resize_array",
    "stack",
    "superpose",
    "to_cartesian_indexing",
    "to_coordinate",
    "to_matrix_indexing",
    "to_voxel",
    "to_voxel_center",
    "weight",
    "zeros_like",
]

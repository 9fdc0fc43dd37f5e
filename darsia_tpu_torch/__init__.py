"""darsia_tpu_torch: the PyTorch/CUDA port of darsia_tpu.

The JAX package ``darsia_tpu`` is the reference; this package keeps its file
layout and public names, so each module has a counterpart there.  Ported so
far: the per-frame production path (correction chain -> registration ->
concentration) for single frames and series, the flexible and multiscale
registration lanes, and the image core around them, with the two-pass warp
as a hand-written CUDA kernel (``ops/warp2pass.py``, ``csrc/``).  Tensors stay
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
    AdaptiveBalance,
    AffineBalance,
    ColorBalance,
    ColorChecker,
    ColorCheckerAfter2014,
    ColorCorrection,
    CurvatureCorrection,
    CustomColorChecker,
    DriftCorrection,
    DynamicIlluminationCorrection,
    IlluminationCorrection,
    PatchwiseIlluminationCorrection,
    TranslationCorrection,
    TranslationEstimator,
    TypeCorrection,
    WhiteBalance,
    find_colorchecker,
    read_correction,
)
from .image import CoordinateSystem, Image, OpticalImage, ScalarImage  # noqa: E402
from .ops.resize import resize_array  # noqa: E402
from .restoration import H1_regularization, Resize, resize  # noqa: E402
from .signals.models import LinearModel  # noqa: E402
from .signals.reduction import MonochromaticReduction  # noqa: E402
from .utils.linear_solvers import Jacobi  # noqa: E402
from .utils.point import (  # noqa: E402
    Coordinate,
    CoordinateArray,
    Voxel,
    VoxelArray,
    make_coordinate,
    make_voxel,
)

__all__ = [
    "AdaptiveBalance",
    "AffineBalance",
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
    "DiffeomorphicImageRegistration",
    "DriftCorrection",
    "DynamicIlluminationCorrection",
    "FusedAnalysisPipeline",
    "H1_regularization",
    "IlluminationCorrection",
    "Image",
    "ImageRegistration",
    "Jacobi",
    "LinearModel",
    "MonochromaticReduction",
    "MultiscaleDiffeomorphicImageRegistration",
    "OpticalImage",
    "PatchwiseIlluminationCorrection",
    "Resize",
    "ScalarImage",
    "TranslationAnalysis",
    "TranslationCorrection",
    "TranslationEstimator",
    "TypeCorrection",
    "Voxel",
    "VoxelArray",
    "WhiteBalance",
    "find_colorchecker",
    "make_coordinate",
    "make_voxel",
    "read_correction",
    "resize",
    "resize_array",
]

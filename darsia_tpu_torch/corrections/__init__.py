"""Corrections: geometric and color corrections, and fused geometric chains."""

from .base import BaseCorrection, TypeCorrection, read_correction
from .color.colorbalance import (
    AdaptiveBalance,
    AffineBalance,
    BaseBalance,
    ColorBalance,
    WhiteBalance,
    affine_balance,
    color_balance,
    white_balance,
)
from .color.colorcheckerfinder import find_colorchecker
from .color.colorcorrection import (
    ClassicColorChecker,
    ColorChecker,
    ColorCheckerAfter2014,
    ColorCorrection,
    CustomColorChecker,
)
from .color.dynamicilluminationcorrection import DynamicIlluminationCorrection
from .color.experimentalcolorcorrection import EOTF, ExperimentalColorCorrection
from .color.illuminationcorrection import IlluminationCorrection
from .color.patchwiseilluminationcorrection import PatchwiseIlluminationCorrection
from .color.relativecolorcorrection import RelativeColorCorrection
from .fuse import FusedCorrectionChain, apply_transformation_chain, fused_chain
from .shape.affine import AffineCorrection, AffineTransformation
from .shape.curvature import CurvatureCorrection
from .shape.deformation import DeformationCorrection
from .shape.drift import DriftCorrection
from .shape.generalizedperspective import (
    GeneralizedPerspectiveCorrection,
    GeneralizedPerspectiveTransformation,
)
from .shape.piecewiseperspective import PiecewisePerspectiveTransform
from .shape.quad import extract_quadrilateral_ROI, homography_from_points, quad_coordinate_grid
from .shape.rotation import RotationCorrection
from .shape.transformation import BaseTransformation, TransformationCorrection
from .shape.translation import TranslationCorrection, TranslationEstimator

__all__ = [
    "AdaptiveBalance",
    "AffineBalance",
    "AffineCorrection",
    "AffineTransformation",
    "AnyCorrection",
    "BaseBalance",
    "BaseCorrection",
    "BaseTransformation",
    "CORRECTION_REGISTRY",
    "ClassicColorChecker",
    "ColorBalance",
    "ColorChecker",
    "ColorCheckerAfter2014",
    "ColorCorrection",
    "CurvatureCorrection",
    "CustomColorChecker",
    "DeformationCorrection",
    "DriftCorrection",
    "DynamicIlluminationCorrection",
    "EOTF",
    "ExperimentalColorCorrection",
    "FusedCorrectionChain",
    "GeneralizedPerspectiveCorrection",
    "GeneralizedPerspectiveTransformation",
    "IlluminationCorrection",
    "PatchwiseIlluminationCorrection",
    "PiecewisePerspectiveTransform",
    "RelativeColorCorrection",
    "RotationCorrection",
    "TransformationCorrection",
    "TranslationCorrection",
    "TranslationEstimator",
    "TypeCorrection",
    "WhiteBalance",
    "affine_balance",
    "apply_transformation_chain",
    "color_balance",
    "extract_quadrilateral_ROI",
    "find_colorchecker",
    "fused_chain",
    "homography_from_points",
    "quad_coordinate_grid",
    "read_correction",
    "white_balance",
]

#: Class-name dispatch for :func:`read_correction`: the JAX package's
#: registry (``Resize`` joins below).
CORRECTION_REGISTRY = {
    "ColorCorrection": ColorCorrection,
    "IlluminationCorrection": IlluminationCorrection,
    "PatchwiseIlluminationCorrection": PatchwiseIlluminationCorrection,
    "DynamicIlluminationCorrection": DynamicIlluminationCorrection,
    "RelativeColorCorrection": RelativeColorCorrection,
    "ExperimentalColorCorrection": ExperimentalColorCorrection,
    "TypeCorrection": TypeCorrection,
    "CurvatureCorrection": CurvatureCorrection,
    "AffineCorrection": AffineCorrection,
    "RotationCorrection": RotationCorrection,
    "TranslationCorrection": TranslationCorrection,
    "DriftCorrection": DriftCorrection,
    "GeneralizedPerspectiveCorrection": GeneralizedPerspectiveCorrection,
}


def _register_resize():
    # Resize lives in restoration but takes part in correction chains; a late
    # import avoids a circular one.
    from ..restoration.resize import Resize

    CORRECTION_REGISTRY["Resize"] = Resize
    return (
        TypeCorrection
        | DriftCorrection
        | CurvatureCorrection
        | IlluminationCorrection
        | PatchwiseIlluminationCorrection
        | ColorCorrection
        | Resize
    )


#: Union of the corrections a rig's transformation chain accepts.
AnyCorrection = _register_resize()

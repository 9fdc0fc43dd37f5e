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
from .color.illuminationcorrection import IlluminationCorrection
from .color.patchwiseilluminationcorrection import PatchwiseIlluminationCorrection
from .fuse import FusedCorrectionChain, apply_transformation_chain, fused_chain
from .shape.curvature import CurvatureCorrection
from .shape.drift import DriftCorrection
from .shape.translation import TranslationCorrection, TranslationEstimator

__all__ = [
    "AdaptiveBalance",
    "AffineBalance",
    "BaseBalance",
    "BaseCorrection",
    "ClassicColorChecker",
    "ColorBalance",
    "ColorChecker",
    "ColorCheckerAfter2014",
    "ColorCorrection",
    "CORRECTION_REGISTRY",
    "CurvatureCorrection",
    "CustomColorChecker",
    "DriftCorrection",
    "DynamicIlluminationCorrection",
    "FusedCorrectionChain",
    "IlluminationCorrection",
    "PatchwiseIlluminationCorrection",
    "TranslationCorrection",
    "TranslationEstimator",
    "TypeCorrection",
    "WhiteBalance",
    "affine_balance",
    "apply_transformation_chain",
    "color_balance",
    "find_colorchecker",
    "fused_chain",
    "read_correction",
    "white_balance",
]

#: Class-name dispatch for :func:`read_correction` (the JAX package's
#: registry, for the classes ported so far).
CORRECTION_REGISTRY = {
    "ColorCorrection": ColorCorrection,
    "IlluminationCorrection": IlluminationCorrection,
    "PatchwiseIlluminationCorrection": PatchwiseIlluminationCorrection,
    "DynamicIlluminationCorrection": DynamicIlluminationCorrection,
    "TypeCorrection": TypeCorrection,
    "CurvatureCorrection": CurvatureCorrection,
    "TranslationCorrection": TranslationCorrection,
    "DriftCorrection": DriftCorrection,
}


def _register_resize() -> None:
    # Resize lives in restoration but takes part in correction chains; a late
    # import avoids a circular one.
    from ..restoration.resize import Resize

    CORRECTION_REGISTRY["Resize"] = Resize


_register_resize()

"""Corrections: geometric corrections and their fused chains."""

from .base import BaseCorrection
from .fuse import FusedCorrectionChain, apply_transformation_chain, fused_chain
from .shape.curvature import CurvatureCorrection
from .shape.translation import TranslationCorrection

__all__ = [
    "BaseCorrection",
    "CurvatureCorrection",
    "FusedCorrectionChain",
    "TranslationCorrection",
    "apply_transformation_chain",
    "fused_chain",
]

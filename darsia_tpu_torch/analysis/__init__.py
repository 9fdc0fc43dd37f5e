"""Analysis: registration, concentration and the fused per-frame pipeline."""

from .concentrationanalysis import ConcentrationAnalysis
from .fusedpipeline import FusedAnalysisPipeline
from .imageregistration import DiffeomorphicImageRegistration, ImageRegistration
from .translationanalysis import TranslationAnalysis

__all__ = [
    "ConcentrationAnalysis",
    "DiffeomorphicImageRegistration",
    "FusedAnalysisPipeline",
    "ImageRegistration",
    "TranslationAnalysis",
]

"""Analysis: registration, concentration and the fused per-frame pipeline."""

from .concentrationanalysis import (
    ConcentrationAnalysis,
    PriorPosteriorConcentrationAnalysis,
)
from .fusedpipeline import FusedAnalysisPipeline
from .imageregistration import (
    DiffeomorphicImageRegistration,
    ImageRegistration,
    MultiscaleDiffeomorphicImageRegistration,
)
from .translationanalysis import TranslationAnalysis

__all__ = [
    "ConcentrationAnalysis",
    "DiffeomorphicImageRegistration",
    "FusedAnalysisPipeline",
    "ImageRegistration",
    "MultiscaleDiffeomorphicImageRegistration",
    "PriorPosteriorConcentrationAnalysis",
    "TranslationAnalysis",
]

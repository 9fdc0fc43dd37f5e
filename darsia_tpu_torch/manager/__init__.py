"""JSON-config-driven analysis managers."""

from .analysisbase import AnalysisBase
from .co2analysis import CO2Analysis
from .concentrationanalysisbase import ConcentrationAnalysisBase
from .traceranalysis import TracerAnalysis

__all__ = ["AnalysisBase", "CO2Analysis", "ConcentrationAnalysisBase", "TracerAnalysis"]

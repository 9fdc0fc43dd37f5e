"""FluidFlower workflow layer: the heterogeneous colour-to-mass analysis."""

from .analysis.expert_knowledge import ExpertKnowledgeAdapter
from .heterogeneous_color_analysis import HeterogeneousColorAnalysis
from .heterogeneous_color_to_mass_analysis import (
    HeterogeneousCalibrationSession,
    HeterogeneousColorToMassAnalysis,
)
from .mass_computation import MassComputation
from .simple_run_analysis import SimpleMultiphaseTimeSeriesData, SimpleRunAnalysis

__all__ = [
    "ExpertKnowledgeAdapter",
    "HeterogeneousCalibrationSession",
    "HeterogeneousColorAnalysis",
    "HeterogeneousColorToMassAnalysis",
    "MassComputation",
    "SimpleMultiphaseTimeSeriesData",
    "SimpleRunAnalysis",
]

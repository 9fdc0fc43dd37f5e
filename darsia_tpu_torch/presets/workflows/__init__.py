"""FluidFlower workflow layer: the rig, its TOML config and set-up steps,
the heterogeneous colour-to-mass analysis and the cross-run comparison."""

from . import comparison, config, setup
from .analysis.expert_knowledge import ExpertKnowledgeAdapter
from .facies_props import FaciesProps
from .heterogeneous_color_analysis import HeterogeneousColorAnalysis
from .heterogeneous_color_to_mass_analysis import (
    HeterogeneousCalibrationSession,
    HeterogeneousColorToMassAnalysis,
)
from .mass_computation import MassComputation
from .mode_resolution import (
    LEGACY_COLOR_TO_MASS_MODES,
    SCALAR_PRODUCT_MODES,
    ColorEmbeddingMode,
    mode_requires_color_to_mass,
    parse_color_mode,
    resolve_mode_image,
    validate_mode_syntax,
)
from .rig import Rig
from .simple_run_analysis import SimpleMultiphaseTimeSeriesData, SimpleRunAnalysis

__all__ = [
    "ColorEmbeddingMode",
    "ExpertKnowledgeAdapter",
    "FaciesProps",
    "HeterogeneousCalibrationSession",
    "HeterogeneousColorAnalysis",
    "HeterogeneousColorToMassAnalysis",
    "LEGACY_COLOR_TO_MASS_MODES",
    "MassComputation",
    "Rig",
    "SCALAR_PRODUCT_MODES",
    "SimpleMultiphaseTimeSeriesData",
    "SimpleRunAnalysis",
    "comparison",
    "config",
    "mode_requires_color_to_mass",
    "parse_color_mode",
    "resolve_mode_image",
    "setup",
    "validate_mode_syntax",
]

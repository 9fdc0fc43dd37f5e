"""FluidFlower workflow layer: the rig, its TOML config and set-up steps,
the heterogeneous colour-to-mass analysis, the config-driven analysis steps
and the cross-run comparison."""

from . import analysis, comparison, config, setup
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
from .restoration import RestorationMaskFactory, build_restoration
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
    "RestorationMaskFactory",
    "Rig",
    "SCALAR_PRODUCT_MODES",
    "SimpleMultiphaseTimeSeriesData",
    "SimpleRunAnalysis",
    "analysis",
    "build_restoration",
    "comparison",
    "config",
    "mode_requires_color_to_mass",
    "parse_color_mode",
    "resolve_mode_image",
    "setup",
    "validate_mode_syntax",
]

"""FluidFlower workflow layer: the rig, its TOML config and set-up steps,
the heterogeneous colour-to-mass analysis, the config-driven analysis and
calibration steps, the helpers and utilities, and the cross-run
comparison."""

from . import analysis, calibration, comparison, config, helper, setup, utils
from .analysis.expert_knowledge import ExpertKnowledgeAdapter
from .basis import label_ids_from_image
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
from .utils.roi_visualization import (
    ActiveRegionRenderData,
    build_active_mask_from_rois,
    draw_active_region,
    render_active_region,
)

__all__ = [
    "ActiveRegionRenderData",
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
    "build_active_mask_from_rois",
    "build_restoration",
    "calibration",
    "comparison",
    "config",
    "draw_active_region",
    "helper",
    "label_ids_from_image",
    "mode_requires_color_to_mass",
    "parse_color_mode",
    "render_active_region",
    "resolve_mode_image",
    "setup",
    "utils",
    "validate_mode_syntax",
]
